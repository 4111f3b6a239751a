"""The one interface the owner-sharded engine's collectives go through.

Counterpart of the reference's ``jax.sharding.Mesh`` and the ``lax``
collectives its ``shard_map`` programs call (``all_to_all``, ``psum``,
``pmax``, ``pmin``, ``all_gather``).  ``tpu/sharded.py`` never indexes
its shard dimension to move data between shards: every movement and
every reduction over shards is a call on an exchange object, and the
mesh picks the exchange (``mesh.exchange()``).

* :class:`ShardMesh` ``(width, device)`` stands for the reference's
  one-axis ``Mesh`` on one device: ``width`` shards, all on ``device``.
  Its exchange, :class:`LocalExchange`, holds the D shards as the
  leading dimension of every carry tensor on that one device, and each
  operation is plain torch on that dimension:

  - ``all_to_all(x)``: ``[D_src, D_dst, ...] -> [D_dst, D_src, ...]``, a
    transpose, which keeps the reference's receive order (source d's
    bucket at position d of every destination's batch);
  - ``psum`` / ``pmax`` / ``pmin``: ``[D, ...] -> [...]``, the value every
    shard would hold after the reduction (replicated, so held once);
  - ``all_gather(x)``: ``[D, ...] -> [D, ...]``, every shard's piece as
    each shard would see them after the gather (the stacked tensor
    already is that).

* :class:`RankMesh` ``(devices, backend)`` stands for the reference's
  mesh over distinct devices: one rank per device, one shard per rank.
  Its exchange, :class:`ProcessGroupExchange`, exists only inside a rank
  (a process that joined a ``torch.distributed`` group of the mesh's
  width; ``tpu/ranks.py`` starts them).  On a rank the leading
  dimension of every carry tensor is this rank's one shard, and each
  operation returns exactly the slice :class:`LocalExchange` returns for
  that shard:

  - ``all_to_all(x)``: ``[1, D_dst, ...] -> [1, D_src, ...]`` through
    ``all_to_all_single``, in the same receive order;
  - ``psum`` / ``pmax`` / ``pmin``: ``[1, ...] -> [...]`` through
    ``all_reduce`` with SUM, MAX and MIN, the replicated value;
  - ``all_gather(x)``: ``[1, ...] -> [D, ...]`` through
    ``all_gather_into_tensor`` (``all_gather_single`` where torch has
    that name).

  ``"nccl"`` (the default over distinct cards) runs every op on the
  rank's card.  ``"gloo"`` (the CPU, and ranks that share a card) runs
  on host memory: where the rank's device is a card, the exchange
  stages every op explicitly, ``x.cpu()`` before it and ``.to(card)``
  after it (one host sync each), for all five operations alike; gloo is
  never handed a card tensor.  Bool tensors travel as ``uint8``.

Both exchanges have ``width`` (D), ``local_width`` (the shards this
process holds: D locally, 1 on a rank), ``rank`` (0 locally), a
host-side gather of variable-length numpy arrays (:meth:`gather_np`:
the counts first, then the rows padded to the largest, then trimmed)
and :meth:`agree`, rank 0's decision of a host branch for every rank
(every rank must issue the same collectives in the same order, so a
branch on a rank's own clock would deadlock the group).

:func:`as_mesh` turns the ``mesh`` argument of the port's callers
(``SearchSupervisor``, ``SwarmSearch``) into a mesh: distinct devices
give a :class:`RankMesh`.

Deliberate differences from the reference: a single controller over
``jax.devices()`` becomes one process per device; a :class:`ShardMesh`'s
shards share one card, where an ``all_to_all`` costs the copy of a
transpose.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from dslabs_tpu_torch.tpu._build import resolve_device

__all__ = ["ShardMesh", "RankMesh", "LocalExchange", "ProcessGroupExchange",
           "as_mesh", "card_count"]


class ShardMesh:
    """A one-axis mesh of ``width`` shards on ``device`` (the card unless
    the caller names another)."""

    def __init__(self, width: int, device=None, axis: str = "search"):
        if int(width) < 1:
            raise ValueError(f"mesh width must be >= 1, got {width}")
        self.width = int(width)
        self.device = resolve_device(device)
        self.axis_names = (axis,)

    def exchange(self) -> "LocalExchange":
        return LocalExchange(self)

    def __repr__(self) -> str:
        return f"ShardMesh(width={self.width}, device={self.device})"


def _norm_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


class RankMesh:
    """A one-axis mesh of one rank per entry of ``devices``, each rank
    holding one shard on its device.  ``backend`` is ``"nccl"`` (the
    default when the devices are distinct cards) or ``"gloo"`` (the CPU,
    and ranks that share a card); devices may repeat only under gloo.
    ``device`` is rank 0's."""

    def __init__(self, devices: Sequence, backend=None,
                 axis: str = "search"):
        devs = [_norm_device(d) for d in devices]
        if not devs:
            raise ValueError("a RankMesh needs at least one device")
        distinct = len(set(devs)) == len(devs)
        if backend is None:
            backend = ("nccl" if distinct and all(d.type == "cuda"
                                                  for d in devs)
                       else "gloo")
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"RankMesh backend must be 'gloo' or 'nccl', "
                             f"got {backend!r}")
        if backend == "nccl":
            if any(d.type != "cuda" for d in devs):
                raise ValueError(
                    f"NCCL ranks run on cards, got {[str(d) for d in devs]}")
            if not distinct:
                raise ValueError(
                    f"two NCCL ranks cannot share a card: "
                    f"{[str(d) for d in devs]}; use backend='gloo'")
        self.devices = devs
        self.backend = backend
        self.width = len(devs)
        self.device = devs[0]
        self.axis_names = (axis,)

    def narrowed(self, width: int) -> "RankMesh":
        """The mesh over this one's first ``width`` devices."""
        return RankMesh(self.devices[:width], self.backend,
                        self.axis_names[0])

    def spec(self) -> dict:
        return {"devices": [str(d) for d in self.devices],
                "backend": self.backend}

    def exchange(self) -> "ProcessGroupExchange":
        """This rank's exchange; only inside a rank of a joined group of
        the mesh's width (``tpu/ranks.py`` starts them)."""
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "a RankMesh's engine runs inside its ranks: start them "
                "with dslabs_tpu_torch.tpu.ranks (run_sharded, "
                "run_swarm)")
        if dist.get_world_size() != self.width:
            raise RuntimeError(
                f"process group of {dist.get_world_size()} ranks for a "
                f"RankMesh of width {self.width}")
        return ProcessGroupExchange(self)

    def __repr__(self) -> str:
        return (f"RankMesh({[str(d) for d in self.devices]}, "
                f"backend={self.backend!r})")


def card_count(device=None) -> int:
    """The width a mesh of ``None`` shards means on ``device``: the number
    of cards when it is a card, 1 on the CPU."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def as_mesh(mesh, device=None):
    """A caller's ``mesh`` argument as a mesh: None (one shard), a shard
    count, a :class:`ShardMesh` or :class:`RankMesh`, or a sequence of
    devices: one device named throughout gives a :class:`ShardMesh` of
    one shard each, distinct devices a :class:`RankMesh` (one rank
    each)."""
    if isinstance(mesh, (ShardMesh, RankMesh)):
        return mesh
    if mesh is None:
        return ShardMesh(1, device)
    if isinstance(mesh, int):
        return ShardMesh(mesh, device)
    devs = [_norm_device(d) for d in mesh]
    if len(set(devs)) > 1:
        return RankMesh(devs)
    return ShardMesh(len(devs), devs[0] if devs else device)


def _np_rows(arr: np.ndarray) -> np.ndarray:
    """``arr`` as ``[n, row bytes]`` uint8 (its leading dimension kept)."""
    a = np.ascontiguousarray(arr)
    width = a.itemsize * int(np.prod(a.shape[1:], dtype=np.int64))
    return a.reshape(-1).view(np.uint8).reshape(len(a), width)


class LocalExchange:
    """The D shards of a :class:`ShardMesh` stacked on its one device
    (module docstring)."""

    rank = 0
    staged = False
    host_gather_syncs = 0

    def __init__(self, mesh: ShardMesh):
        self.mesh = mesh
        self.width = mesh.width
        self.local_width = mesh.width
        self.device = mesh.device

    def _check(self, x: torch.Tensor, dims: int = 1) -> None:
        if tuple(x.shape[:dims]) != (self.width,) * dims:
            raise ValueError(
                f"exchange over {self.width} shards: leading dims "
                f"{tuple(x.shape[:dims])}, want {(self.width,) * dims}")

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``[D_src, D_dst, ...] -> [D_dst, D_src, ...]`` (contiguous)."""
        self._check(x, 2)
        return x.transpose(0, 1).contiguous()

    def all_to_all_many(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """:meth:`all_to_all` of each tensor."""
        return [self.all_to_all(x) for x in xs]

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

    def gather_np(self, parts: List[np.ndarray]) -> List[np.ndarray]:
        """The D shards' host arrays (one per local shard) in shard
        order: here they all are."""
        if len(parts) != self.width:
            raise ValueError(f"{len(parts)} parts for {self.width} shards")
        return list(parts)

    def agree(self, flag: bool) -> bool:
        return bool(flag)


class ProcessGroupExchange:
    """One rank's shard of a :class:`RankMesh` (module docstring).
    ``calls`` and ``bytes_sent`` count this rank's collectives and the
    bytes it handed them (its own share included)."""

    local_width = 1

    def __init__(self, mesh: RankMesh):
        import torch.distributed as dist

        self._dist = dist
        self.mesh = mesh
        self.width = mesh.width
        self.rank = dist.get_rank()
        self.device = mesh.devices[self.rank]
        self.backend = mesh.backend
        # gloo runs on host memory: a card tensor is staged through it.
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self._wire = torch.device("cpu") if self.backend == "gloo" \
            else self.device
        # Host syncs of one gather_np: none where the wire is the host;
        # over NCCL its two gathers each go up to the card and back.
        self.host_gather_syncs = 4 * int(self._wire.type == "cuda")
        self.calls = 0
        self.bytes_sent = 0

    def _check(self, x: torch.Tensor, lead) -> None:
        if tuple(x.shape[:len(lead)]) != tuple(lead):
            raise ValueError(
                f"rank exchange over {self.width} shards: leading dims "
                f"{tuple(x.shape[:len(lead)])}, want {tuple(lead)}")

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor this rank hands a collective: on the wire's device,
        contiguous, bool as uint8."""
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        if x.device != self._wire:
            x = x.to(self._wire)
        self.calls += 1
        self.bytes_sent += x.numel() * x.element_size()
        return x.contiguous()

    def _back(self, y: torch.Tensor, dtype) -> torch.Tensor:
        if y.device != self.device:
            y = y.to(self.device)
        return y.to(dtype) if y.dtype != dtype else y

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``[1, D_dst, ...] -> [1, D_src, ...]``."""
        self._check(x, (1, self.width))
        send = self._out(x[0])
        recv = torch.empty_like(send)
        self._dist.all_to_all_single(recv, send)
        return self._back(recv, x.dtype)[None]

    def all_to_all_many(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """:meth:`all_to_all` of each tensor (int32 or bool, each
        ``[1, D, n, ...]`` with one ``n``) in one collective: they travel
        side by side as int32 columns."""
        D = self.width
        for x in xs:
            self._check(x, (1, D))
            if x.dtype not in (torch.int32, torch.bool):
                raise ValueError(f"all_to_all_many carries int32 and bool, "
                                 f"got {x.dtype}")
        n = xs[0].shape[2]
        cols = [x[0].reshape(D, n, -1).to(torch.int32) for x in xs]
        widths = [c.shape[2] for c in cols]
        send = self._out(torch.cat(cols, dim=2))
        recv = torch.empty_like(send)
        self._dist.all_to_all_single(recv, send)
        recv = self._back(recv, torch.int32)
        out, at = [], 0
        for x, w in zip(xs, widths):
            part = recv[:, :, at:at + w].reshape(x.shape[1:])
            out.append((part != 0 if x.dtype == torch.bool
                        else part.contiguous())[None])
            at += w
        return out

    def _reduce(self, x: torch.Tensor, op, dtype=None) -> torch.Tensor:
        self._check(x, (1,))
        v = x[0]
        if dtype is not None:
            v = v.to(dtype)
        buf = self._out(v).clone()
        self._dist.all_reduce(buf, op=op)
        return self._back(buf, v.dtype)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, self._dist.ReduceOp.SUM,
                            torch.int64 if x.dtype == torch.bool else None)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, self._dist.ReduceOp.MAX)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, self._dist.ReduceOp.MIN)

    def _gather(self, send: torch.Tensor) -> torch.Tensor:
        out = send.new_empty((self.width * send.numel(),))
        # all_gather_single is all_gather_into_tensor's newer name.
        gather = getattr(self._dist, "all_gather_single", None) or \
            self._dist.all_gather_into_tensor
        gather(out, send.reshape(-1))
        return out.reshape((self.width,) + tuple(send.shape))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[1, ...] -> [D, ...]``."""
        self._check(x, (1,))
        return self._back(self._gather(self._out(x[0])), x.dtype)

    def _host_all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor's all-gather ``[...] -> [D, ...]`` on the host."""
        return self._gather(self._out(t)).cpu()

    def gather_np(self, parts: List[np.ndarray]) -> List[np.ndarray]:
        """Every rank's host array (this rank's one part), in rank order,
        on every rank: the counts first, then the rows padded to the
        largest count, then trimmed."""
        if len(parts) != 1:
            raise ValueError(f"{len(parts)} parts on a rank holding one "
                             f"shard")
        arr = np.ascontiguousarray(parts[0])
        rows = _np_rows(arr)
        n = torch.tensor([rows.shape[0]], dtype=torch.int64)
        counts = self._host_all_gather(n).reshape(-1).tolist()
        top = max(counts)
        pad = np.zeros((top, rows.shape[1]), np.uint8)
        pad[:len(rows)] = rows
        got = self._host_all_gather(torch.from_numpy(pad)).numpy()
        tail = arr.shape[1:]
        return [np.ascontiguousarray(got[r, :c]).view(arr.dtype).reshape(
            (c,) + tail) for r, c in enumerate(counts)]

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        t = torch.tensor([int(bool(flag)) if self.rank == 0 else 0],
                         dtype=torch.int64)
        return bool(self._host_all_gather(t)[0, 0])
