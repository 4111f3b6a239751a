"""Fault-model declarations: the data half of ``dslabs_tpu/tpu/faults.py``.

A spec may declare a :class:`FaultModel` (partitions, crash-recovery,
bounded message drops and duplicates).  The port carries the declaration
and the hidden controller node kind it adds to the spec's layout; the
lowering of fault events into the search comes with the symmetry and
faults slice of the port, and until then ``ProtocolSpec.compile()``
raises ``NotImplementedError`` for a spec with a fault model.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["Partition", "Crash", "FaultModel", "FAULT_KIND",
           "controller_kind"]

# Reserved hidden node kind that carries the fault lanes.
FAULT_KIND = "$fault"

@dataclasses.dataclass(frozen=True)
class Partition:
    """A partition schedule over node groups: ``blocks`` of node kind
    names or ``(kind, idx)`` entries, cut at most ``max_eras`` times;
    ``initial_cut`` starts the search already cut."""

    blocks: Tuple[tuple, ...]
    max_eras: int = 1
    initial_cut: bool = False


@dataclasses.dataclass(frozen=True)
class Crash:
    """Crash/restart for the kinds named in ``durable`` (kind name ->
    durable field names); ``max_crashes`` budgets crash events."""

    durable: Dict[str, Tuple[str, ...]]
    max_crashes: int = 1


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """The declarative fault plane of a spec."""

    partition: Optional[Partition] = None
    crash: Optional[Crash] = None
    max_drops: int = 0
    max_dups: int = 0


def controller_kind(model: FaultModel, nodes) -> object:
    """The hidden ``$fault`` NodeKind for ``model`` given the user node
    kinds: every lane a bounded Field."""
    from dslabs_tpu_torch.tpu.compiler import Field, NodeKind

    fields = []
    if model.partition is not None:
        cut0 = 1 if model.partition.initial_cut else 0
        fields.append(Field("pcut", init=cut0, hi=1))
        fields.append(Field("eras", init=cut0,
                            hi=max(model.partition.max_eras, cut0)))
    if model.crash is not None:
        for k in nodes:
            if k.name in model.crash.durable:
                fields.append(Field(f"down_{k.name}", size=k.count,
                                    hi=1, index_group=k.name))
        fields.append(Field("crashes", hi=model.crash.max_crashes))
    if model.max_drops > 0:
        fields.append(Field("drops", hi=model.max_drops))
    if model.max_dups > 0:
        fields.append(Field("dups", hi=model.max_dups))
    return NodeKind(FAULT_KIND, 1, tuple(fields))
