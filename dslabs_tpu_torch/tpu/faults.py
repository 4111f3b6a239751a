"""Checkable fault scenarios: declarative fault models compiled into the
tensor event space.  The counterpart of ``dslabs_tpu/tpu/faults.py``.

A :class:`FaultModel` on a :class:`~dslabs_tpu_torch.tpu.compiler.ProtocolSpec`
declares faults of the checked system, explored exhaustively like any
other model event:

* a network **partition** schedule over node groups: cut and heal are
  model events, budgeted by ``max_eras``;
* **crash/restart** of declared node kinds with a durable-vs-volatile
  field split: a crash wipes every non-durable field back to its init
  value and marks the node down (no handler or timer runs, no message is
  deliverable to it) until a restart event;
* bounded message **drop** (removes an in-flight message from the network
  set) and **dup** (a bounded, named re-delivery: set semantics already
  deliver without consuming, so the event only spends the budget and
  names the slot in witness traces).

Compilation appends one hidden controller node kind (``$fault``) whose
bounded :class:`~dslabs_tpu_torch.tpu.compiler.Field` lanes carry the
partition flag, the era/crash/drop/dup counters and per-node down flags.
Fault state is therefore ordinary declared-domain node lanes: packing and
symmetry canonicalization carry it unchanged.  The engine adds a third
event segment to the enumeration grid and a deliverability mask
(cross-cut and down-destination messages, down nodes' timers), both only
when ``protocol.fault`` is set.

Flat event grid numbering (what traces record): ``[0, net_cap)`` message
deliveries, ``[net_cap, net_cap + NN*T_CAP)`` timer fires, then the fault
segment::

    CUT, HEAL,                      # iff partition declared
    CRASH(n) for n in crashable,    # iff crash declared
    RESTART(n) for n in crashable,
    DROP(slot) for slot in net,     # iff max_drops > 0
    DUP(slot) for slot in net,      # iff max_dups > 0

A message blocked by a cut or a down node stays in the network set and is
deliverable again after HEAL/RESTART; only DROP, itself a recorded model
event, removes one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["Partition", "Crash", "FaultModel", "FaultLanes",
           "FAULT_KIND", "FAULT_FIELDS", "controller_kind",
           "compile_fault_lanes", "validate_fault"]

# Reserved hidden node kind that carries the fault lanes.  User specs may
# not declare it; handlers may not read it.
FAULT_KIND = "$fault"

# Reserved controller field names.
FAULT_FIELDS = ("pcut", "eras", "crashes", "drops", "dups")


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


@dataclasses.dataclass(frozen=True)
class FaultLanes:
    """The compiled static descriptor the engine consumes
    (``TensorProtocol.fault``): lane offsets of the controller fields,
    per-node block ids / down-flag offsets / volatile wipe masks, the
    fault event-segment layout, and the budgets.  Everything here is
    host-side numpy/int; the engine turns the tables into tensors on the
    search's device.  Nothing here is protocol state."""

    model: FaultModel
    n_nodes: int                  # INCLUDING the controller
    node_width: int
    net_cap: int
    # Scalar controller lane offsets (-1 = family absent).
    pcut_off: int
    eras_off: int
    crashes_off: int
    drops_off: int
    dups_off: int
    block_id: np.ndarray          # [n_nodes] int32, -1 = unpartitioned
    down_off: np.ndarray          # [n_nodes] int32, -1 = not crashable
    crash_nodes: np.ndarray       # [nc] int32 node indices
    crash_labels: Tuple[str, ...]  # aligned with crash_nodes
    wipe: np.ndarray              # [nc, node_width] bool (volatile)
    init_vec: np.ndarray          # [node_width] int32

    # ------------------------------------------------ event segment

    @property
    def has_partition(self) -> bool:
        return self.model.partition is not None

    @property
    def n_crashable(self) -> int:
        return int(len(self.crash_nodes))

    @property
    def seg_cut(self) -> int:
        return 0

    @property
    def seg_heal(self) -> int:
        return 1

    @property
    def seg_crash(self) -> int:
        return 2 if self.has_partition else 0

    @property
    def seg_restart(self) -> int:
        return self.seg_crash + self.n_crashable

    @property
    def seg_drop(self) -> int:
        return self.seg_restart + self.n_crashable

    @property
    def seg_dup(self) -> int:
        return self.seg_drop + (self.net_cap
                                if self.model.max_drops > 0 else 0)

    @property
    def n_events(self) -> int:
        return self.seg_dup + (self.net_cap
                               if self.model.max_dups > 0 else 0)

    def event_label(self, f_idx: int) -> str:
        """Human name of fault event ``f_idx`` (trace decoding)."""
        f = int(f_idx)
        if self.has_partition and f == self.seg_cut:
            return "CUT"
        if self.has_partition and f == self.seg_heal:
            return "HEAL"
        nc = self.n_crashable
        if self.seg_crash <= f < self.seg_crash + nc:
            return f"CRASH({self.crash_labels[f - self.seg_crash]})"
        if self.seg_restart <= f < self.seg_restart + nc:
            return f"RESTART({self.crash_labels[f - self.seg_restart]})"
        if (self.model.max_drops > 0
                and self.seg_drop <= f < self.seg_drop + self.net_cap):
            return f"DROP({f - self.seg_drop})"
        if (self.model.max_dups > 0
                and self.seg_dup <= f < self.seg_dup + self.net_cap):
            return f"DUP({f - self.seg_dup})"
        raise IndexError(f"fault event {f} out of range "
                         f"[0, {self.n_events})")

    def signature(self) -> str:
        """Stable identity string of the fault model, the one the
        reference joins into its checkpoint fingerprints: two searches
        whose fault models differ get different strings."""
        m = self.model
        part = None
        if m.partition is not None:
            part = (tuple(tuple(b) for b in m.partition.blocks),
                    m.partition.max_eras, m.partition.initial_cut)
        crash = None
        if m.crash is not None:
            crash = (tuple(sorted(
                (k, tuple(v)) for k, v in m.crash.durable.items())),
                m.crash.max_crashes)
        return repr(("fault-v1", part, crash, m.max_drops, m.max_dups,
                     self.n_nodes, self.net_cap))


def compile_fault_lanes(spec, table, node_width: int,
                        init_vec: np.ndarray) -> FaultLanes:
    """Build the :class:`FaultLanes` descriptor for ``spec`` (whose
    node list ALREADY includes the appended ``$fault`` controller).
    ``table`` is the spec's ``_layout()`` table; ``init_vec`` the full
    node-lane init vector.  Structural validation lives in
    ``ProtocolSpec.validate`` — this assumes a validated spec."""
    model = spec.fault
    n_nodes = sum(k.count for k in spec.nodes)
    user_nodes = [k for k in spec.nodes if k.name != FAULT_KIND]

    def _scalar_off(fname: str) -> int:
        key = (FAULT_KIND, 0, fname)
        return table[key][0] if key in table else -1

    block_id = np.full((n_nodes,), -1, np.int32)
    if model.partition is not None:
        for b, block in enumerate(model.partition.blocks):
            for entry in block:
                if isinstance(entry, str):
                    kind = next(k for k in user_nodes
                                if k.name == entry)
                    for i in range(kind.count):
                        block_id[spec._node_index(entry, i)] = b
                else:
                    kind_name, idx = entry
                    block_id[spec._node_index(kind_name, idx)] = b

    down_off = np.full((n_nodes,), -1, np.int32)
    crash_nodes = []
    crash_labels = []
    wipe_rows = []
    if model.crash is not None:
        for kind in user_nodes:
            if kind.name not in model.crash.durable:
                continue
            durable = set(model.crash.durable[kind.name])
            base_off = table[(FAULT_KIND, 0, f"down_{kind.name}")][0]
            for i in range(kind.count):
                n = spec._node_index(kind.name, i)
                down_off[n] = base_off + i
                crash_nodes.append(n)
                crash_labels.append(f"{kind.name}[{i}]")
                w = np.zeros((node_width,), bool)
                for f in kind.fields:
                    if f.name in durable:
                        continue
                    off, size = table[(kind.name, i, f.name)]
                    w[off:off + size] = True
                wipe_rows.append(w)

    return FaultLanes(
        model=model,
        n_nodes=n_nodes,
        node_width=node_width,
        net_cap=spec.net_cap,
        pcut_off=_scalar_off("pcut"),
        eras_off=_scalar_off("eras"),
        crashes_off=_scalar_off("crashes"),
        drops_off=_scalar_off("drops"),
        dups_off=_scalar_off("dups"),
        block_id=block_id,
        down_off=down_off,
        crash_nodes=np.asarray(crash_nodes, np.int32),
        crash_labels=tuple(crash_labels),
        wipe=(np.stack(wipe_rows) if wipe_rows
              else np.zeros((0, node_width), bool)),
        init_vec=np.asarray(init_vec, np.int32),
    )


def validate_fault(spec) -> None:
    """Fault-model structural hygiene, raised as structured SpecError
    at the compile gate (the C4/C5 discipline extended to the fault
    plane).  ``spec.nodes`` already includes the controller kind."""
    from dslabs_tpu_torch.tpu.compiler import SpecError

    model = spec.fault
    user_nodes = [k for k in spec.nodes if k.name != FAULT_KIND]
    kind_by_name = {k.name: k for k in user_nodes}

    if model.max_drops < 0 or model.max_dups < 0:
        raise SpecError(
            f"fault budgets must be >= 0 (max_drops={model.max_drops}, "
            f"max_dups={model.max_dups})", spec=spec.name)

    part = model.partition
    if part is not None:
        if len(part.blocks) < 2:
            raise SpecError(
                "partition needs >= 2 blocks (a single block cuts "
                "nothing)", spec=spec.name)
        if part.max_eras < 0:
            raise SpecError(
                f"partition max_eras must be >= 0 (got "
                f"{part.max_eras})", spec=spec.name)
        if part.initial_cut and part.max_eras < 1:
            raise SpecError(
                "initial_cut consumes partition era 1 — max_eras must "
                "be >= 1", spec=spec.name)
        seen = {}
        for b, block in enumerate(part.blocks):
            for entry in block:
                if isinstance(entry, str):
                    kind_name, idxs = entry, None
                else:
                    try:
                        kind_name, idx = entry
                        idxs = (idx,)
                    except (TypeError, ValueError):
                        raise SpecError(
                            f"partition block entry {entry!r} is "
                            "neither a kind name nor (kind, idx)",
                            spec=spec.name)
                kind = kind_by_name.get(kind_name)
                if kind is None:
                    raise SpecError(
                        f"partition block names unknown node kind "
                        f"{kind_name!r} (declared: "
                        f"{sorted(kind_by_name)})",
                        spec=spec.name, kind=kind_name)
                if idxs is None:
                    idxs = range(kind.count)
                for i in idxs:
                    if not (0 <= i < kind.count):
                        raise SpecError(
                            f"partition block entry ({kind_name!r}, "
                            f"{i}) out of range (kind has "
                            f"{kind.count} instances)",
                            spec=spec.name, kind=kind_name)
                    key = (kind_name, i)
                    if key in seen and seen[key] != b:
                        raise SpecError(
                            f"node ({kind_name!r}, {i}) appears in "
                            f"partition blocks {seen[key]} and {b}",
                            spec=spec.name, kind=kind_name)
                    seen[key] = b
        # Symmetry soundness: a declared-interchangeable kind must not
        # be SPLIT across blocks (canonical relabeling would move a
        # node across the cut).  Whole-kind membership is fine.
        for g in spec.symmetry:
            kind = kind_by_name.get(g)
            if kind is None:
                continue
            ids = {seen.get((g, i), -1) for i in range(kind.count)}
            if len(ids) > 1:
                raise SpecError(
                    f"partition blocks split symmetry group {g!r} "
                    f"across blocks {sorted(ids)} — interchangeable "
                    "instances must share one block (or none)",
                    spec=spec.name, kind=g, code="C5")

    crash = model.crash
    if crash is not None:
        if crash.max_crashes < 0:
            raise SpecError(
                f"crash max_crashes must be >= 0 (got "
                f"{crash.max_crashes})", spec=spec.name)
        for kind_name, durable in crash.durable.items():
            kind = kind_by_name.get(kind_name)
            if kind is None:
                raise SpecError(
                    f"crash durable names unknown node kind "
                    f"{kind_name!r} (declared: "
                    f"{sorted(kind_by_name)})",
                    spec=spec.name, kind=kind_name)
            declared = {f.name for f in kind.fields}
            for fname in durable:
                if fname not in declared:
                    raise SpecError(
                        f"crash durable field {fname!r} not declared "
                        f"on kind {kind_name!r} (declared: "
                        f"{sorted(declared)})",
                        spec=spec.name, kind=kind_name, field=fname)
