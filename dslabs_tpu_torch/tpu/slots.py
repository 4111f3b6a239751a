"""Multi-instance slot arrays for the protocol spec layer: the
counterpart of ``dslabs_tpu/tpu/slots.py``, pure data, copied.

Replicated protocols are arrays of near-identical state machines: lab3
multi-Paxos keeps per-slot log entries and vote bitmaps.  A
:class:`Slots` declaration is a named block of ``n`` logical instances,
each carrying the same small record of bounded int fields, lowered to one
``{block}.{field}`` array Field per record field (struct-of-arrays, so
each record field keeps its own packing domain).

Handlers reach slots through the Ctx slot ops (``ctx.slot_get`` /
``slot_put`` / ``slot_clear_upto`` in ``tpu/compiler.py``): a static
index outside the declared range is a compile-gate ``SpecError``; a
per-pair index lowers to a one-hot select.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["SlotField", "Slots", "expand_slots", "slot_lane"]


@dataclasses.dataclass(frozen=True)
class SlotField:
    """One field of a slot record.  ``init`` is an int or a callable
    ``(instance_index, slot_index) -> int`` (slot_index is LOGICAL,
    i.e. already offset by the block's ``base``).  ``clear`` is the
    value :func:`Slots.clear_upto` resets the field to — the garbage-
    collected representation, which must itself sit inside the
    declared domain."""

    name: str
    init: object = 0
    lo: int = 0
    hi: Optional[int] = None
    delta: Optional[int] = None
    clear: int = 0


@dataclasses.dataclass(frozen=True)
class Slots:
    """``n`` logical instances of a record of :class:`SlotField`s,
    indexed ``base .. base + n - 1`` (lab3 slot numbers are 1-based;
    declaring ``base=1`` keeps handler arithmetic in protocol terms).
    Appears inside ``NodeKind.fields``; the spec expands it at
    construction via :func:`expand_slots` and remembers the block for
    Ctx slot ops, fingerprinting, and conformance."""

    name: str
    n: int
    fields: Tuple[SlotField, ...]
    base: int = 0

    def field(self, name: str) -> SlotField:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def lane(self, field: str) -> str:
        return slot_lane(self.name, field)


def slot_lane(block: str, field: str) -> str:
    """The lowered Field name one slot-record field occupies."""
    return f"{block}.{field}"


def _field_init(sf: SlotField, n: int):
    """Lower a SlotField init to the compiler Field init form (int, or
    per-instance callable returning the full [n] list)."""
    if callable(sf.init):
        def init(i, _sf=sf, _n=n):
            return [int(_sf.init(i, s)) for s in range(_n)]
        return init
    return sf.init


def expand_slots(block: "Slots", compiler_field_cls) -> list:
    """Lower one Slots block to its struct-of-arrays compiler Fields
    (one array Field per record field, size ``n``, the record field's
    own domain).  ``compiler_field_cls`` is ``compiler.Field`` — passed
    in to keep this module import-light (the compiler imports us)."""
    from dslabs_tpu_torch.tpu.compiler import SpecError

    if block.n <= 0:
        raise SpecError(
            f"Slots block {block.name!r} declares {block.n} instances "
            f"— an empty slot array has no lanes to lower",
            field=block.name, code="C4")
    if not block.fields:
        raise SpecError(
            f"Slots block {block.name!r} declares no fields",
            field=block.name, code="C4")
    out = []
    for sf in block.fields:
        if sf.hi is not None and not (sf.lo <= sf.clear <= sf.hi):
            raise SpecError(
                f"Slots block {block.name!r} field {sf.name!r}: clear "
                f"value {sf.clear} outside declared domain "
                f"[{sf.lo}, {sf.hi}]", field=sf.name, code="C4")
        out.append(compiler_field_cls(
            name=slot_lane(block.name, sf.name), size=block.n,
            init=_field_init(sf, block.n), lo=sf.lo, hi=sf.hi,
            delta=sf.delta))
    return out
