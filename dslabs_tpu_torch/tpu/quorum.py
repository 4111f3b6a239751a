"""Quorum aggregation combinators for the protocol spec layer: the
counterpart of ``dslabs_tpu/tpu/quorum.py``, batched.

:class:`QuorumCount` declares a quorum on a spec (the node kind counted
over and the threshold rule); handlers reach the resolved
:class:`Quorum` through ``ctx.quorum(name)``.  The reducers work on the
port's batched values: a vote bitmap lane is ``[P]``, a per-member array
field is ``[P, members]``, and every reduction runs over the last
dimension.  Where the reference takes a member count from
``v.shape[0]`` of one state's vector, the port takes ``shape[-1]``.

``popcount`` is the reference's int32 SWAR ladder; its products stay
below 2^31 for the group sizes it is given (the low ``n`` bits only).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

__all__ = ["QuorumCount", "Quorum", "popcount", "count_true",
           "majority", "all_of", "any_of", "resolve_quorums"]


@dataclasses.dataclass(frozen=True)
class QuorumCount:
    """A declared quorum: count votes ``over`` the instances of one
    node kind and compare against ``threshold``: an int, or one of
    ``"majority"`` (n//2 + 1), ``"all"`` (n), ``"any"`` (1)."""

    name: str
    over: str
    threshold: Union[int, str] = "majority"


@dataclasses.dataclass(frozen=True)
class Quorum:
    """A :class:`QuorumCount` resolved against its spec: ``n`` members,
    ``need`` votes.  The methods reduce batched lanes (``[P]`` bitmaps,
    ``[P, n]`` member arrays) to ``[P]`` counts and flags."""

    name: str
    over: str
    n: int
    need: int

    def count_bits(self, bits):
        """Popcount of a vote bitmap lane (bit i = member i voted)."""
        return popcount(bits, self.n)

    def met_bits(self, bits):
        return self.count_bits(bits) >= self.need

    def count(self, vec):
        """Count of non-zero votes in a per-member array field."""
        return count_true(vec)

    def met(self, vec):
        return self.count(vec) >= self.need


def popcount(bits, n: int):
    """Bit-population count of the low ``n`` bits of each value of
    ``bits`` (int32, any shape): the SWAR ladder."""
    v = torch.as_tensor(bits)
    if v.dtype != torch.int32:
        v = v.to(torch.int32)
    v = v & ((1 << n) - 1)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (v * 0x01010101) >> 24


def count_true(vec):
    """Number of non-zero lanes over the last dimension of a batched
    per-member array ``[..., members]``."""
    v = torch.as_tensor(vec)
    return (v != 0).sum(-1, dtype=torch.int32)


def _members(v: torch.Tensor, n: Optional[int]) -> int:
    return n if n is not None else v.shape[-1]


def majority(vec, n: Optional[int] = None):
    """True where a strict majority of the ``n`` members voted (``n``
    defaults to the last dimension)."""
    v = torch.as_tensor(vec)
    return 2 * count_true(v) > _members(v, n)


def all_of(vec, n: Optional[int] = None):
    v = torch.as_tensor(vec)
    return count_true(v) >= _members(v, n)


def any_of(vec):
    return count_true(vec) >= 1


def resolve_quorums(spec) -> dict:
    """Validate and resolve a spec's declared quorums against its node
    kinds.  A quorum over an unknown or empty group is a SpecError."""
    from dslabs_tpu_torch.tpu.compiler import SpecError

    counts = {k.name: k.count for k in spec.nodes}
    out = {}
    for q in getattr(spec, "quorums", ()) or ():
        if q.name in out:
            raise SpecError(
                f"duplicate quorum declaration {q.name!r}",
                spec=spec.name, field=q.name, code="C4")
        n = counts.get(q.over)
        if n is None:
            raise SpecError(
                f"quorum {q.name!r} counts over unknown node kind "
                f"{q.over!r} (declared: {sorted(counts)})",
                spec=spec.name, kind=q.over, field=q.name, code="C4")
        if n <= 0:
            raise SpecError(
                f"quorum {q.name!r} counts over EMPTY group {q.over!r} "
                f"(0 instances) — every threshold is vacuous; declare "
                f"the group with instances or drop the quorum",
                spec=spec.name, kind=q.over, field=q.name, code="C4")
        if isinstance(q.threshold, str):
            need = {"majority": n // 2 + 1, "all": n, "any": 1}.get(
                q.threshold)
            if need is None:
                raise SpecError(
                    f"quorum {q.name!r} has unknown threshold rule "
                    f"{q.threshold!r} (use an int, 'majority', 'all' "
                    f"or 'any')", spec=spec.name, field=q.name,
                    code="C4")
        else:
            need = int(q.threshold)
            if not 1 <= need <= n:
                raise SpecError(
                    f"quorum {q.name!r} threshold {need} outside "
                    f"[1, {n}] for group {q.over!r}",
                    spec=spec.name, field=q.name, code="C4")
        out[q.name] = Quorum(q.name, q.over, n, need)
    return out
