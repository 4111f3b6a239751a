"""The one interface the owner-sharded engine's collectives go through.

Counterpart of the reference's ``jax.sharding.Mesh`` and the ``lax``
collectives its ``shard_map`` programs call (``all_to_all``, ``psum``,
``pmax``, ``pmin``, ``all_gather``).  ``tpu/sharded.py`` never indexes
its shard dimension to move data between shards: every movement and
every reduction over shards is a call on an exchange object, so that a
process-group form can take the place of :class:`LocalExchange` without
a change to the engine.

* :class:`ShardMesh` ``(width, device)`` stands for the reference's
  one-axis ``Mesh``: ``width`` shards, all on ``device``.
* :class:`LocalExchange` holds the D shards as the leading dimension of
  every carry tensor on that one device, and each operation is plain
  torch on that dimension:

  - ``all_to_all(x)``: ``[D_src, D_dst, ...] -> [D_dst, D_src, ...]``, a
    transpose, which keeps the reference's receive order (source d's
    bucket at position d of every destination's batch);
  - ``psum`` / ``pmax`` / ``pmin``: ``[D, ...] -> [...]``, the value every
    shard would hold after the reduction (replicated, so held once);
  - ``all_gather(x)``: ``[D, ...] -> [D, ...]``, every shard's piece as
    each shard would see them after the gather (the stacked tensor
    already is that).

* :func:`as_mesh` turns the ``mesh`` argument of the port's callers
  (``SearchSupervisor``, ``SwarmSearch``) into a :class:`ShardMesh`.

Deliberate difference from the reference: the shards share one card, so
the exchange moves no bytes between devices; an ``all_to_all`` costs
the copy of a transpose.  A mesh over several distinct devices needs
the process-group form of this interface, which is not ported yet.
"""

from __future__ import annotations

import torch

from dslabs_tpu_torch.tpu._build import resolve_device

__all__ = ["ShardMesh", "LocalExchange", "as_mesh", "card_count"]


class ShardMesh:
    """A one-axis mesh of ``width`` shards on ``device`` (the card unless
    the caller names another)."""

    def __init__(self, width: int, device=None, axis: str = "search"):
        if int(width) < 1:
            raise ValueError(f"mesh width must be >= 1, got {width}")
        self.width = int(width)
        self.device = resolve_device(device)
        self.axis_names = (axis,)

    def __repr__(self) -> str:
        return f"ShardMesh(width={self.width}, device={self.device})"


def card_count(device=None) -> int:
    """The width a mesh of ``None`` shards means on ``device``: the number
    of cards when it is a card, 1 on the CPU."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def as_mesh(mesh, device=None) -> ShardMesh:
    """A caller's ``mesh`` argument as a :class:`ShardMesh`: None (one
    shard), a shard count, a :class:`ShardMesh`, or a sequence of devices
    that all name one device (one shard each).  A sequence naming two
    distinct devices raises: a mesh over several cards needs the
    process-group exchange."""
    if isinstance(mesh, ShardMesh):
        return mesh
    if mesh is None:
        return ShardMesh(1, device)
    if isinstance(mesh, int):
        return ShardMesh(mesh, device)
    devs = [torch.device(d) for d in mesh]
    if len(set(devs)) > 1:
        raise NotImplementedError(
            f"a mesh over the distinct devices {sorted(map(str, set(devs)))}"
            " is not ported yet; it comes with the process-group form of "
            "mesh_exchange (torch.distributed), the process-group slice of "
            "the PyTorch port (see ROADMAP.md)")
    return ShardMesh(len(devs), devs[0] if devs else device)


class LocalExchange:
    """The D shards of a :class:`ShardMesh` stacked on its one device
    (module docstring)."""

    def __init__(self, mesh: ShardMesh):
        self.mesh = mesh
        self.width = mesh.width

    def _check(self, x: torch.Tensor, dims: int = 1) -> None:
        if tuple(x.shape[:dims]) != (self.width,) * dims:
            raise ValueError(
                f"exchange over {self.width} shards: leading dims "
                f"{tuple(x.shape[:dims])}, want {(self.width,) * dims}")

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``[D_src, D_dst, ...] -> [D_dst, D_src, ...]`` (contiguous)."""
        self._check(x, 2)
        return x.transpose(0, 1).contiguous()

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x.sum(0)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x.amax(0)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x.amin(0)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x
