"""Protocol schema compiler: declarative bounded-state specs -> batched
tensor twins.  The counterpart of ``dslabs_tpu/tpu/compiler.py``.

A :class:`ProtocolSpec` declares node kinds with bounded integer fields,
message and timer types with payload fields, and handlers written against
the :class:`Ctx` combinator API (reads, conditional writes, sends, timer
sets, integer arithmetic).  ``compile()`` derives the port's
:class:`~dslabs_tpu_torch.tpu.engine.TensorProtocol`:

- fields -> node lanes (layout, offsets, init vector),
- message/timer enums -> tags + fixed-width records,
- handlers -> ``step_message`` / ``step_timer`` with per-(kind, instance,
  type) guards, ``torch.where`` field merges, and send/set row budgets
  counted from the handlers' ``ctx.send`` / ``ctx.set_timer`` calls.

Batched values.  The compiled steps take a leading batch dimension P
(``step_message(nodes [P, NW], msg [P, MW])``), so inside a handler a
scalar field is a ``[P]`` tensor and an array field of size ``n`` is
``[P, n]``; guards are ``[P]`` bool.  Whether a field is a scalar or an
array is decided from the layout's size, never from ``ndim``.  A value
written to an array field may be a Python int, a per-pair ``[P]`` tensor
(broadcast over the array) or ``[P, n]``.

Dynamic indices (``get_at`` / ``put_at`` / slot ops with a per-pair
index) are one-hot selects, as in the reference: an index outside the
range reads 0 and drops the write.  A static int index outside the
declared range is a compile-gate :class:`SpecError`; an in-range static
index reads a column directly.

Each compiled step runs every handler of every (instance, type) pair
under its guard, as eager PyTorch ops, so the Ctx ops are kept lean:
int32 values stay int32 without conversions, a ``when`` of Python
``True`` adds no op, and constants are cached per device.

A spec with a ``fault`` model (``tpu/faults.py``) compiles with its
hidden controller kind and carries the compiled
:class:`~dslabs_tpu_torch.tpu.faults.FaultLanes` as
``TensorProtocol.fault``; a spec with symmetry groups carries its
permutation tables as ``TensorProtocol.symmetry`` (``tpu/symmetry.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Field", "MessageType", "TimerType", "NodeKind",
           "ProtocolSpec", "Ctx", "SpecError", "Fragment"]

class SpecError(Exception):
    """A structured spec-conformance failure raised at
    :meth:`ProtocolSpec.compile` time, naming the offending handler and
    field.  ``code`` is the conformance rule that owns the failure (C4
    unless stated otherwise); the message text is the reference's."""

    def __init__(self, message: str, *, spec: Optional[str] = None,
                 handler: Optional[str] = None,
                 kind: Optional[str] = None,
                 field: Optional[str] = None,
                 line: Optional[int] = None,
                 code: str = "C4"):
        self.spec = spec
        self.handler = handler
        self.kind = kind
        self.field = field
        self.line = line
        self.code = code
        loc = ""
        if handler:
            loc = f" [handler {handler}" + (
                f" @ line {line}]" if line else "]")
        super().__init__(f"{code}: {message}{loc}")


@dataclasses.dataclass(frozen=True)
class Field:
    """A bounded int field of a node: scalar (size 1) or a small int
    array (size > 1).  ``init`` is an int or a per-instance callable
    ``(instance_index) -> int | list``.  ``lo``/``hi`` declare the value
    domain (the input to the bit-packed frontier encoding,
    ``tpu/packing.py``); ``delta`` marks an unbounded counter for the
    delta-from-base encoding; ``index_group`` names the node kind whose
    instances index this array."""

    name: str
    size: int = 1
    init: object = 0
    lo: int = 0
    hi: Optional[int] = None
    index_group: Optional[str] = None
    delta: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class MessageType:
    """``bounds`` maps payload field name -> (lo, hi) domain for the
    packed encoding; undeclared fields keep full int32 lanes."""

    name: str
    fields: Tuple[str, ...] = ()
    bounds: Optional[Dict[str, Tuple[int, int]]] = None


@dataclasses.dataclass(frozen=True)
class TimerType:
    name: str
    fields: Tuple[str, ...] = ()
    min_ms: int = 10
    max_ms: int = 10
    bounds: Optional[Dict[str, Tuple[int, int]]] = None


@dataclasses.dataclass(frozen=True)
class NodeKind:
    """``count`` instances of a node kind, each with the same fields.
    Node indices are assigned kind by kind in declaration order.
    ``fields`` may mix :class:`Field`s with
    :class:`~dslabs_tpu_torch.tpu.slots.Slots` blocks."""

    name: str
    count: int
    fields: Tuple[Field, ...]


class Fragment:
    """A composable sub-state-machine: a named bundle of fields, message
    and timer types, and handlers, attached to a node kind with
    :meth:`ProtocolSpec.include`."""

    def __init__(self, name: str, fields: Sequence[object] = (),
                 messages: Sequence[MessageType] = (),
                 timers: Sequence[TimerType] = ()):
        self.name = name
        self.fields = tuple(fields)
        self.messages = tuple(messages)
        self.timers = tuple(timers)
        self.handlers: Dict[str, Callable] = {}
        self.timer_handlers: Dict[str, Callable] = {}

    def on(self, msg: str):
        def reg(fn):
            self.handlers[msg] = fn
            return fn
        return reg

    def on_timer(self, timer: str):
        def reg(fn):
            self.timer_handlers[timer] = fn
            return fn
        return reg


# ------------------------------------------------------------- constants

_CONSTS: Dict[tuple, torch.Tensor] = {}


def _const(key: tuple, device, make: Callable[[], torch.Tensor]
           ) -> torch.Tensor:
    """A constant tensor built once per (key, device) and never written:
    handlers read it, so no op re-creates it per step."""
    k = key + (str(device),)
    t = _CONSTS.get(k)
    if t is None:
        t = make().to(device)
        _CONSTS[k] = t
    return t


def _scalar(v: int, device) -> torch.Tensor:
    return _const(("s", int(v)), device,
                  lambda: torch.tensor(int(v), dtype=torch.int32))


def _arange(n: int, device, base: int = 0) -> torch.Tensor:
    return _const(("a", n, base), device,
                  lambda: torch.arange(base, base + n, dtype=torch.int32))


def _onehot(n: int, i: int, device) -> torch.Tensor:
    return _const(("o", n, i), device,
                  lambda: torch.arange(n) == i)


class _Step:
    """What one compiled-step call shares among its Ctx objects: the
    batch size and device (P = 1 on the CPU in ``_count_budgets``)."""

    def __init__(self, p: int, device):
        self.p = p
        self.device = device

    def lane(self, v) -> torch.Tensor:
        """A value of one record lane -> [P] int32."""
        if isinstance(v, torch.Tensor):
            if v.dtype != torch.int32:
                v = v.to(torch.int32)
            return v.expand(self.p) if v.dim() == 0 else v
        return _scalar(int(v), self.device).expand(self.p)


def _is_static(i) -> bool:
    return isinstance(i, (int, np.integer)) and not isinstance(i, bool)


class Ctx:
    """Handler combinator context for ONE (kind, instance) under ONE
    guard condition ``[P]`` bool.  All mutation is conditional on the
    guard (and any ``when`` refinement) and merged with ``torch.where``;
    a write replaces the field's tensor, so a value read earlier stays a
    snapshot, as in the functional reference."""

    def __init__(self, spec, st, kind, idx, cond, sends, sets,
                 handler=None, excs=None, step=None):
        self._spec = spec
        self._st = st
        self._kind = kind
        self._idx = idx
        self._cond = cond
        self._sends = sends
        self._sets = sets
        self._excs = excs if excs is not None else []
        self._handler = handler        # (name, firstlineno) or None
        self._step = step

    def _err(self, message: str, field: Optional[str] = None):
        name, line = self._handler or (None, None)
        return SpecError(message, spec=self._spec.name, handler=name,
                         kind=self._kind, field=field, line=line)

    def _key(self, field: str, op: str):
        key = (self._kind, self._idx, field)
        if key not in self._st:
            declared = sorted({f for k, _, f in self._st
                               if k == self._kind})
            raise self._err(
                f"{op} of undeclared field {field!r} on kind "
                f"{self._kind!r} (declared: {declared})", field=field)
        return key

    def _size(self, key) -> int:
        return self._spec._sizes[key[2], key[0]]

    def _guard(self, when):
        """guard & when -> [P] bool (no op for a Python ``True``)."""
        if when is True:
            return self._cond
        return self._cond & when

    @staticmethod
    def _i32(t: torch.Tensor) -> torch.Tensor:
        return t if t.dtype == torch.int32 else t.to(torch.int32)

    # ---------------------------------------------------------- accessors

    def get(self, field: str):
        """Current value of ``field``: [P], or [P, size] for an array."""
        return self._st[self._key(field, "get")]

    def put(self, field: str, value, when=True):
        """Conditionally set ``field`` (guard & when).  On an array field
        a Python int or a [P] value is written to every element."""
        key = self._key(field, "put")
        cur = self._st[key]
        c = self._guard(when)
        if self._size(key) > 1:
            c = c[:, None]
            if isinstance(value, torch.Tensor) and value.dim() == 1:
                value = value[:, None]
        self._st[key] = self._i32(torch.where(c, value, cur))

    def _check_static_index(self, field: str, i, size: int, op: str):
        """A static index outside the declared range is a compile-gate
        error: the one-hot mux would otherwise return a silent 0 or drop
        the write.  Per-pair indices pass through (the mux masks them)."""
        if _is_static(i) and not 0 <= int(i) < size:
            raise self._err(
                f"{op} of field {field!r}: static index {int(i)} "
                f"outside declared range [0, {size})", field=field)

    def get_at(self, field: str, i):
        """Element ``i`` of an array field: a column for a static index,
        a one-hot select for a per-pair index ([P]; out of range reads
        0).  A size-1 field is a one-element vector."""
        key = self._key(field, "get_at")
        cur = self._st[key]
        size = self._size(key)
        self._check_static_index(field, i, size, "get_at")
        if _is_static(i):
            return cur if size == 1 else cur[:, int(i)]
        if size == 1:
            return torch.where(i == 0, cur, 0)
        oh = _arange(size, cur.device) == i[:, None]
        return torch.where(oh, cur, 0).sum(1, dtype=torch.int32)

    def put_at(self, field: str, i, value, when=True):
        key = self._key(field, "put_at")
        cur = self._st[key]
        size = self._size(key)
        self._check_static_index(field, i, size, "put_at")
        c = self._guard(when)
        if size == 1:
            if not _is_static(i):
                c = c & (i == 0)
            self._st[key] = self._i32(torch.where(c, value, cur))
            return
        if _is_static(i):
            oh = _onehot(size, int(i), cur.device) & c[:, None]
        else:
            oh = (_arange(size, cur.device) == i[:, None]) & c[:, None]
        if isinstance(value, torch.Tensor) and value.dim() == 1:
            value = value[:, None]
        self._st[key] = self._i32(torch.where(oh, value, cur))

    def cond(self, extra):
        """A refined child context (guard & extra) for nested logic."""
        return Ctx(self._spec, self._st, self._kind, self._idx,
                   self._cond & extra, self._sends, self._sets,
                   handler=self._handler, excs=self._excs,
                   step=self._step)

    # ------------------------------------------------------------- slots

    def _slot_block(self, block: str, op: str):
        decl = self._spec.slot_blocks.get((self._kind, block))
        if decl is None:
            declared = sorted(b for k, b in self._spec.slot_blocks
                              if k == self._kind)
            raise self._err(
                f"{op} of undeclared Slots block {block!r} on kind "
                f"{self._kind!r} (declared: {declared})", field=block)
        touched = getattr(self._spec, "_touched_slots", None)
        if touched is not None:
            touched.add((self._kind, block))
        return decl

    def _check_slot(self, decl, block: str, field: str, i, op: str):
        if _is_static(i) and not (decl.base <= int(i)
                                  < decl.base + decl.n):
            raise self._err(
                f"{op} of block {block!r}: static slot index "
                f"{int(i)} outside declared range "
                f"[{decl.base}, {decl.base + decl.n})", field=field)

    def slot_get(self, block: str, field: str, i):
        """Read one record field of LOGICAL slot ``i`` (the block's
        ``base`` offset is spec data, not handler arithmetic)."""
        decl = self._slot_block(block, "slot_get")
        self._check_slot(decl, block, field, i, "slot_get")
        return self.get_at(decl.lane(field), i - decl.base)

    def slot_put(self, block: str, field: str, i, value, when=True):
        decl = self._slot_block(block, "slot_put")
        self._check_slot(decl, block, field, i, "slot_put")
        self.put_at(decl.lane(field), i - decl.base, value, when=when)

    def slot_clear_upto(self, block: str, upto, when=True):
        """Every slot with logical index strictly below ``upto`` ([P] or
        an int) resets to its declared ``clear`` value, all record
        fields: the lab3 log-GC pattern as one lowering."""
        decl = self._slot_block(block, "slot_clear_upto")
        c = self._guard(when)
        if isinstance(upto, torch.Tensor) and upto.dim() == 1:
            upto = upto[:, None]
        win = (_arange(decl.n, c.device, decl.base) < upto) & c[:, None]
        for sf in decl.fields:
            key = self._key(decl.lane(sf.name), "slot_clear_upto")
            cur = self._st[key]
            if decl.n == 1:
                self._st[key] = self._i32(
                    torch.where(win[:, 0], sf.clear, cur))
            else:
                self._st[key] = self._i32(torch.where(win, sf.clear, cur))

    # ------------------------------------------------------------ quorum

    def quorum(self, name: str):
        """The spec-declared quorum ``name`` in resolved form
        (``tpu/quorum.py`` Quorum: group size, vote threshold,
        reducers)."""
        q = self._spec.resolved_quorums().get(name)
        if q is None:
            raise self._err(
                f"read of undeclared quorum {name!r} (declared: "
                f"{sorted(self._spec.resolved_quorums())})", field=name)
        touched = getattr(self._spec, "_touched_quorums", None)
        if touched is not None:
            touched.add(name)
        return q

    def fail(self, code: int, when=True):
        """The tensor analog of a handler exception: the step's ``exc``
        lane becomes ``code`` where the guard (and ``when``) holds.
        ``code`` must be a static positive int."""
        if not _is_static(code) or int(code) <= 0:
            raise self._err(
                f"fail() code must be a static positive int, got "
                f"{code!r}")
        self._excs.append((int(code), self._guard(when)))

    # ------------------------------------------------------------ effects

    def send(self, msg: str, to, when=True, **fields):
        m = self._spec._mspec.get(msg)
        if m is None:
            raise self._err(
                f"send of undeclared message {msg!r} (declared: "
                f"{sorted(self._spec._mspec)})", field=msg)
        sent = getattr(self._spec, "_touched_sends", None)
        if sent is not None:
            sent.add(msg)
        unknown = sorted(set(fields) - set(m.fields))
        missing = sorted(set(m.fields) - set(fields))
        if unknown or missing:
            raise self._err(
                f"send({msg!r}): "
                + (f"unknown fields {unknown}" if unknown else "")
                + (" and " if unknown and missing else "")
                + (f"missing fields {missing}" if missing else ""),
                field=(unknown or missing)[0])
        self._sends.append(
            (self._spec._msg_row(self._step, msg, self.node_index(), to,
                                 fields),
             self._guard(when)))

    def set_timer(self, timer: str, when=True, **fields):
        t = self._spec._tspec.get(timer)
        if t is None:
            raise self._err(
                f"set_timer of undeclared timer {timer!r} (declared: "
                f"{sorted(self._spec._tspec)})", field=timer)
        unknown = sorted(set(fields) - set(t.fields))
        missing = sorted(set(t.fields) - set(fields))
        if unknown or missing:
            raise self._err(
                f"set_timer({timer!r}): "
                + (f"unknown fields {unknown}" if unknown else "")
                + (" and " if unknown and missing else "")
                + (f"missing fields {missing}" if missing else ""),
                field=(unknown or missing)[0])
        self._sets.append(
            (self._spec._timer_row(self._step, timer, self.node_index(),
                                   fields),
             self._guard(when)))

    def node_index(self) -> int:
        return self._spec._node_index(self._kind, self._idx)


class ProtocolSpec:

    def __init__(self, name: str,
                 nodes: Sequence[NodeKind],
                 messages: Sequence[MessageType],
                 timers: Sequence[TimerType],
                 net_cap: int = 16,
                 timer_cap: int = 4,
                 symmetry: Sequence[str] = (),
                 fault: Optional[object] = None,
                 quorums: Sequence[object] = (),
                 max_live_sends: Optional[int] = None):
        self.name = name
        # Slots declarations inside NodeKind.fields expand to their
        # struct-of-arrays lanes here; the declaration is kept for the
        # Ctx slot ops.
        self.slot_blocks: Dict[Tuple[str, str], object] = {}
        self.nodes = [self._expand_kind(k) for k in nodes]
        self.quorums = tuple(quorums)
        self._quorums_resolved: Optional[Dict[str, object]] = None
        self.fragments: List[Tuple[str, str]] = []
        self.max_live_sends = max_live_sends
        # A fault model appends the hidden controller kind last, so the
        # user kinds keep their node indices.
        self.fault = fault
        if fault is not None:
            from dslabs_tpu_torch.tpu.faults import controller_kind
            self.nodes.append(controller_kind(fault, self.nodes))
        self.messages = list(messages)
        self.timers = list(timers)
        self.net_cap = net_cap
        self.timer_cap = timer_cap
        self.symmetry = tuple(symmetry)
        # (kind, message/timer name) -> handler(ctx, payload dict)
        self.handlers: Dict[Tuple[str, str], Callable] = {}
        self.timer_handlers: Dict[Tuple[str, str], Callable] = {}
        self.initial_messages: List[tuple] = []   # (msg, frm, to, fields)
        self.initial_timers: List[tuple] = []     # (timer, node, fields)
        self.goals: Dict[str, Callable] = {}      # name -> fn(view)
        self.invariants: Dict[str, Callable] = {}
        self.decode_message: Optional[Callable] = None
        self.decode_timer: Optional[Callable] = None
        self._reindex_types()

    def _reindex_types(self) -> None:
        """(Re)build the tag/spec/width tables: at construction and after
        an :meth:`include` merges fragment types in."""
        self._mtag = {m.name: i for i, m in enumerate(self.messages)}
        self._mspec = {m.name: m for m in self.messages}
        # Timer tag 0 is reserved ("no tag").
        self._ttag = {t.name: 1 + i for i, t in enumerate(self.timers)}
        self._tspec = {t.name: t for t in self.timers}
        self._mw = 3 + max((len(m.fields) for m in self.messages),
                           default=0)
        self._tw = 3 + max((len(t.fields) for t in self.timers),
                           default=0)       # [tag, min, max, fields...]

    def _expand_kind(self, kind: NodeKind) -> NodeKind:
        """Expand Slots blocks inside a kind's fields to their lowered
        array Fields, recording each declaration."""
        from dslabs_tpu_torch.tpu.slots import Slots, expand_slots

        if not any(isinstance(f, Slots) for f in kind.fields):
            return kind
        out: List[Field] = []
        for f in kind.fields:
            if isinstance(f, Slots):
                if (kind.name, f.name) in self.slot_blocks:
                    raise SpecError(
                        f"duplicate Slots block {f.name!r} on kind "
                        f"{kind.name!r}", spec=self.name,
                        kind=kind.name, field=f.name)
                self.slot_blocks[(kind.name, f.name)] = f
                out.extend(expand_slots(f, Field))
            else:
                out.append(f)
        return dataclasses.replace(kind, fields=tuple(out))

    def include(self, kind: str, fragment: "Fragment") -> None:
        """Compose a :class:`Fragment` onto a declared node kind: fields
        append to the kind's layout, message/timer types merge into the
        spec's enums (an identical re-declaration is tolerated, a
        different one refused), handlers register under the kind."""
        for pos, k in enumerate(self.nodes):
            if k.name == kind:
                break
        else:
            raise SpecError(
                f"include of fragment {fragment.name!r} on unknown "
                f"node kind {kind!r} (declared: "
                f"{sorted(x.name for x in self.nodes)})",
                spec=self.name, kind=kind, field=fragment.name)
        if (kind, fragment.name) in self.fragments:
            raise SpecError(
                f"fragment {fragment.name!r} included twice on kind "
                f"{kind!r}", spec=self.name, kind=kind,
                field=fragment.name)
        self.nodes[pos] = self._expand_kind(dataclasses.replace(
            self.nodes[pos],
            fields=self.nodes[pos].fields + tuple(fragment.fields)))
        for decls, mine, what in ((fragment.messages, self.messages,
                                   "message"),
                                  (fragment.timers, self.timers, "timer")):
            for d in decls:
                cur = next((x for x in mine if x.name == d.name), None)
                if cur is None:
                    mine.append(d)
                elif cur != d:
                    raise SpecError(
                        f"fragment {fragment.name!r} redeclares {what} "
                        f"{d.name!r} with a different shape",
                        spec=self.name, kind=kind, field=d.name)
        for table, handlers, what in (
                (self.handlers, fragment.handlers, "handler"),
                (self.timer_handlers, fragment.timer_handlers,
                 "timer handler")):
            for name, fn in handlers.items():
                if (kind, name) in table:
                    raise SpecError(
                        f"fragment {fragment.name!r} {what} for "
                        f"{name!r} collides with an existing handler on "
                        f"kind {kind!r}", spec=self.name, kind=kind,
                        field=name)
                table[(kind, name)] = fn
        self.fragments.append((kind, fragment.name))
        self._reindex_types()

    def resolved_quorums(self) -> Dict[str, object]:
        """Declared quorums resolved against the node kinds (cached)."""
        if self._quorums_resolved is None:
            from dslabs_tpu_torch.tpu.quorum import resolve_quorums
            self._quorums_resolved = resolve_quorums(self)
        return self._quorums_resolved

    # ------------------------------------------------------------- layout

    def on(self, kind: str, msg: str):
        def reg(fn):
            self.handlers[(kind, msg)] = fn
            return fn
        return reg

    def on_timer(self, kind: str, timer: str):
        def reg(fn):
            self.timer_handlers[(kind, timer)] = fn
            return fn
        return reg

    def _instances(self):
        for kind in self.nodes:
            for i in range(kind.count):
                yield kind, i

    def _node_index(self, kind_name: str, idx: int) -> int:
        base = 0
        for kind in self.nodes:
            if kind.name == kind_name:
                return base + idx
            base += kind.count
        raise KeyError(kind_name)

    def _layout(self):
        """(kind, idx, field) -> (offset, size); total width."""
        off = 0
        table = {}
        for kind, i in self._instances():
            for f in kind.fields:
                table[(kind.name, i, f.name)] = (off, f.size)
                off += f.size
        return table, off

    def _msg_row(self, step: _Step, name, frm, to, fields) -> torch.Tensor:
        """[tag, frm, to, payload..., zero padding] -> [P, MW] int32."""
        m = self._mspec[name]
        vals = [self._mtag[name], frm, to] + [fields[f] for f in m.fields]
        vals += [0] * (self._mw - len(vals))
        return torch.stack([step.lane(v) for v in vals], 1)

    def _timer_row(self, step: _Step, name, node, fields) -> torch.Tensor:
        """[node, tag, min, max, payload..., padding] -> [P, 1 + TW]."""
        t = self._tspec[name]
        vals = [node, self._ttag[name], t.min_ms, t.max_ms] + [
            fields[f] for f in t.fields]
        vals += [0] * (1 + self._tw - len(vals))
        return torch.stack([step.lane(v) for v in vals], 1)

    # ----------------------------------------------------------- validate

    def _handler_id(self, fn):
        try:
            return (fn.__name__, fn.__code__.co_firstlineno)
        except AttributeError:
            return (getattr(fn, "__name__", repr(fn)), None)

    def validate(self) -> None:
        """The spec-hygiene compile gate: handler registrations must name
        declared node kinds and message/timer types, initial messages and
        timers must name declared types, quorums must resolve, and field
        domains, index groups and init values must be consistent.  Raises
        :class:`SpecError` with the reference's text."""
        from dslabs_tpu_torch.tpu.faults import FAULT_KIND, validate_fault
        n_ctrl = sum(1 for k in self.nodes if k.name == FAULT_KIND)
        if n_ctrl != (1 if self.fault is not None else 0):
            raise SpecError(
                f"node kind name {FAULT_KIND!r} is reserved for the "
                "fault controller (declare faults via fault=FaultModel"
                "(...), not as a node kind)",
                spec=self.name, kind=FAULT_KIND, code="C6")
        if self.fault is not None:
            for (kind, _msg) in list(self.handlers) + \
                    list(self.timer_handlers):
                if kind == FAULT_KIND:
                    raise SpecError(
                        "handlers may not be registered on the fault "
                        "controller kind — protocols observe faults "
                        "only through message loss and timer silence",
                        spec=self.name, kind=FAULT_KIND, code="C6")
            validate_fault(self)
        self._quorums_resolved = None
        self.resolved_quorums()
        kinds = {k.name for k in self.nodes}
        for registry, types, what in (
                (self.handlers, self._mtag, "message"),
                (self.timer_handlers, self._ttag, "timer")):
            prefix = "handler" if what == "message" else "timer handler"
            for (kind, typ), fn in registry.items():
                name, line = self._handler_id(fn)
                if kind not in kinds:
                    raise SpecError(
                        f"{prefix} registered for unknown node kind "
                        f"{kind!r} (declared: {sorted(kinds)})",
                        spec=self.name, handler=name, kind=kind,
                        line=line)
                if typ not in types:
                    raise SpecError(
                        f"{prefix} registered for unknown {what} "
                        f"{typ!r} (declared: {sorted(types)})",
                        spec=self.name, handler=name, kind=kind,
                        field=typ, line=line)
        for name, *_ in self.initial_messages:
            if name not in self._mspec:
                raise SpecError(
                    f"initial message of undeclared type {name!r}",
                    spec=self.name, field=name)
        for name, *_ in self.initial_timers:
            if name not in self._tspec:
                raise SpecError(
                    f"initial timer of undeclared type {name!r}",
                    spec=self.name, field=name)
        kind_counts = {k.name: k.count for k in self.nodes}
        for g in self.symmetry:
            if g not in kinds:
                raise SpecError(
                    f"symmetry group names unknown node kind {g!r} "
                    f"(declared: {sorted(kinds)})",
                    spec=self.name, kind=g, code="C5")
        for kind in self.nodes:
            for f in kind.fields:
                self._validate_field(kind, f, kind_counts)

    def _validate_field(self, kind, f, kind_counts) -> None:
        if f.hi is not None and f.hi < f.lo:
            raise SpecError(
                f"field {f.name!r} on kind {kind.name!r} has "
                f"empty domain [{f.lo}, {f.hi}]",
                spec=self.name, kind=kind.name, field=f.name)
        if f.index_group is not None:
            if f.index_group not in kind_counts:
                raise SpecError(
                    f"field {f.name!r} on kind {kind.name!r} "
                    f"declares index_group for unknown kind "
                    f"{f.index_group!r}",
                    spec=self.name, kind=kind.name,
                    field=f.name, code="C5")
            if f.size != kind_counts[f.index_group]:
                raise SpecError(
                    f"field {f.name!r} on kind {kind.name!r} "
                    f"has size {f.size} but index_group "
                    f"{f.index_group!r} has "
                    f"{kind_counts[f.index_group]} instances",
                    spec=self.name, kind=kind.name,
                    field=f.name, code="C5")
        if f.delta is not None and f.hi is not None:
            raise SpecError(
                f"field {f.name!r} on kind {kind.name!r} "
                "declares both hi= and delta= — a bounded "
                "domain and the delta-from-base lane are "
                "mutually exclusive", spec=self.name,
                kind=kind.name, field=f.name, code="C5")
        # Init values must sit inside the declared domain: the packed
        # encoding would otherwise corrupt the root state.
        if f.hi is not None:
            for i in range(kind.count):
                v = f.init(i) if callable(f.init) else f.init
                for x in np.atleast_1d(np.asarray(v)).tolist():
                    if not (f.lo <= int(x) <= f.hi):
                        raise SpecError(
                            f"init value {x} of field "
                            f"{f.name!r} on kind {kind.name!r} "
                            f"outside declared domain "
                            f"[{f.lo}, {f.hi}]",
                            spec=self.name, kind=kind.name,
                            field=f.name)

    # -------------------------------------------- packing / symmetry

    def _lane_domains(self) -> dict:
        """Per-lane value domains for the bit-packed frontier encoding:
        structural lanes (tags, node indices, timer min/max) from the
        spec itself, field and payload lanes from the declared bounds,
        ``None`` (full int32) where undeclared."""
        n_nodes = sum(k.count for k in self.nodes)
        nodes = []
        for kind, _i in self._instances():
            for f in kind.fields:
                if f.hi is not None:
                    dom = (f.lo, f.hi)
                elif f.delta is not None:
                    dom = ("delta", int(f.delta))
                else:
                    dom = None
                nodes += [dom] * f.size
        node_dom = (0, max(n_nodes - 1, 0))

        def _merge(entries):
            """Union of (lo, hi) domains; None poisons."""
            lo = hi = None
            for e in entries:
                if e is None:
                    return None
                lo = e[0] if lo is None else min(lo, e[0])
                hi = e[1] if hi is None else max(hi, e[1])
            return (0, 0) if lo is None else (lo, hi)

        def _payload(types, width):
            out = []
            for j in range(width):
                out.append(_merge([
                    (t.bounds or {}).get(t.fields[j])
                    if j < len(t.fields) else (0, 0)   # zero-padded lane
                    for t in types]))
            return out

        msg = [(0, max(len(self.messages) - 1, 0)), node_dom, node_dom]
        msg += _payload(self.messages, self._mw - 3)
        tmr = [(0, len(self.timers)),
               _merge([(t.min_ms, t.min_ms) for t in self.timers]),
               _merge([(t.max_ms, t.max_ms) for t in self.timers])]
        tmr += _payload(self.timers, self._tw - 3)
        # The exc lane spans the declared ctx.fail codes; without any the
        # compiled steps never set it and the lane is a constant.
        return {"nodes": nodes, "msg": msg, "timer": tmr,
                "exc": (0, getattr(self, "_exc_hi", 0))}

    def _symmetry_spec(self, table):
        """The canonical-relabeling permutation tables of the declared
        symmetry groups (``tpu/symmetry.py`` SymmetrySpec), or None."""
        if not self.symmetry:
            return None
        import itertools

        from dslabs_tpu_torch.tpu.symmetry import SymmetrySpec

        n_nodes = sum(k.count for k in self.nodes)
        _, nw = self._layout()
        bases = {}
        off = 0
        for kind in self.nodes:
            bases[kind.name] = off
            off += kind.count
        groups = []
        total = 1
        for g in self.symmetry:
            count = next(k.count for k in self.nodes if k.name == g)
            groups.append((g, bases[g], count))
            for i in range(2, count + 1):
                total *= i
        if total > 720:
            raise SpecError(
                f"symmetry groups expand to {total} permutations "
                "(> 720) — the fused canonicalize pass enumerates "
                "them; shrink the groups", spec=self.name, code="C5")
        per_group = [list(itertools.permutations(range(c)))
                     for _g, _b, c in groups]
        relabs, lane_srcs = [], []
        for combo in itertools.product(*per_group):
            relab = np.arange(n_nodes, dtype=np.int64)
            lane_src = np.arange(nw, dtype=np.int64)
            for (g, base, count), sigma in zip(groups, combo):
                # new position j holds old member sigma[j]
                for j in range(count):
                    relab[base + sigma[j]] = base + j
                kind = next(k for k in self.nodes if k.name == g)
                for j in range(count):
                    for f in kind.fields:
                        dst, size = table[(g, j, f.name)]
                        src, _ = table[(g, sigma[j], f.name)]
                        lane_src[dst:dst + size] = np.arange(
                            src, src + size)
                # Group-indexed array fields permute their elements with
                # the group; only on kinds outside the group itself.
                for kind2, i2 in self._instances():
                    for f in kind2.fields:
                        if f.index_group != g:
                            continue
                        if kind2.name == g:
                            raise SpecError(
                                f"field {f.name!r}: index_group on a "
                                f"kind inside its own symmetry group "
                                f"{g!r} is unsupported",
                                spec=self.name, kind=kind2.name,
                                field=f.name, code="C5")
                        o2, _ = table[(kind2.name, i2, f.name)]
                        for j in range(count):
                            lane_src[o2 + j] = o2 + sigma[j]
            relabs.append(relab)
            lane_srcs.append(lane_src)
        # Identity permutation first.
        order = sorted(range(len(relabs)),
                       key=lambda i: 0 if (relabs[i]
                                           == np.arange(n_nodes)).all()
                       else 1)
        return SymmetrySpec(
            relab=np.stack([relabs[i] for i in order]),
            lane_src=np.stack([lane_srcs[i] for i in order]),
            groups=tuple((g, b, c) for g, b, c in groups))

    # ------------------------------------------------------------ compile

    def compile(self):
        """-> the port's TensorProtocol with batched steps
        (``tpu/engine.py``)."""
        from dslabs_tpu_torch.tpu.engine import SENTINEL, TensorProtocol

        self.validate()
        table, nw = self._layout()
        n_nodes = sum(k.count for k in self.nodes)
        spec = self
        keys = list(table)

        def unpack(nodes):
            return {key: (nodes[:, off] if size == 1
                          else nodes[:, off:off + size])
                    for key, (off, size) in table.items()}

        def repack(st):
            return torch.cat([st[k][:, None] if table[k][1] == 1 else st[k]
                              for k in keys], 1)

        # Static send/set budgets, counted by running each handler once.
        max_sends, max_sets = self._count_budgets()
        uses_exc = self._exc_hi > 0

        def _finalize(step, groups, budget, width):
            """Merge per-invocation row groups into one [P, budget, width]
            block.  Invocations are pairwise mutually exclusive, so row j
            is the minimum over every group's SENTINEL-blanked row j: at
            most one group contributes a live row and SENTINEL loses every
            minimum, as in the reference."""
            merged: List[Optional[torch.Tensor]] = [None] * budget
            for rows in groups:
                assert len(rows) <= budget, (len(rows), budget)
                for j, (rec, cond) in enumerate(rows):
                    blanked = torch.where(cond[:, None], rec, SENTINEL)
                    merged[j] = (blanked if merged[j] is None
                                 else torch.minimum(merged[j], blanked))
            blank = None
            for j in range(budget):
                if merged[j] is None:
                    if blank is None:
                        blank = _scalar(SENTINEL, step.device).expand(
                            step.p, width)
                    merged[j] = blank
            if not merged:
                return torch.zeros((step.p, 0, width), dtype=torch.int32,
                                   device=step.device)
            return torch.stack(merged, 1)

        def _exc_lane(step, excs):
            out = _scalar(0, step.device).expand(step.p)
            for code, cond in excs:
                out = torch.maximum(
                    out, torch.where(cond, _scalar(code, step.device), 0))
            return out

        def run_step(nodes, node_of, tag, payload_of, types, ttag,
                     registry):
            step = _Step(nodes.shape[0], nodes.device)
            st = unpack(nodes)
            send_groups, set_groups, excs = [], [], []
            is_tag = {}
            for kind, i in spec._instances():
                here = None
                for t in types:
                    fn = registry.get((kind.name, t.name))
                    if fn is None:
                        continue
                    if here is None:
                        here = node_of == spec._node_index(kind.name, i)
                    if t.name not in is_tag:
                        is_tag[t.name] = tag == ttag[t.name]
                    sends, sets = [], []
                    ctx = Ctx(spec, st, kind.name, i, here & is_tag[t.name],
                              sends, sets, handler=spec._handler_id(fn),
                              excs=excs, step=step)
                    spec._invoke(fn, ctx, payload_of(t), t.name)
                    send_groups.append(sends)
                    set_groups.append(sets)
            out = (repack(st),
                   _finalize(step, send_groups, max_sends, spec._mw),
                   _finalize(step, set_groups, max_sets, 1 + spec._tw))
            return out + ((_exc_lane(step, excs),) if uses_exc else ())

        def step_message(nodes, msg):
            def payload_of(m):
                payload = {f: msg[:, 3 + j] for j, f in enumerate(m.fields)}
                payload["_from"] = msg[:, 1]
                return payload
            return run_step(nodes, msg[:, 2], msg[:, 0], payload_of,
                            spec.messages, spec._mtag, spec.handlers)

        def step_timer(nodes, node_idx, timer):
            def payload_of(t):
                return {f: timer[:, 3 + j] for j, f in enumerate(t.fields)}
            return run_step(nodes, node_idx, timer[:, 0], payload_of,
                            spec.timers, spec._ttag, spec.timer_handlers)

        def init_nodes():
            out = np.zeros((nw,), np.int32)
            for (kind_name, i, fname), (off, size) in table.items():
                kind = next(k for k in self.nodes if k.name == kind_name)
                f = next(x for x in kind.fields if x.name == fname)
                v = f.init(i) if callable(f.init) else f.init
                out[off:off + size] = v
            return out

        def init_messages():
            rows = []
            for name, frm, to, fields in self.initial_messages:
                m = self._mspec[name]
                rec = np.zeros((self._mw,), np.int32)
                rec[0:3] = [self._mtag[name], frm, to]
                for j, f in enumerate(m.fields):
                    rec[3 + j] = fields[f]
                rows.append(rec)
            return (np.stack(rows) if rows
                    else np.zeros((0, self._mw), np.int32))

        def init_timers():
            rows = []
            for name, node, fields in self.initial_timers:
                t = self._tspec[name]
                rec = np.zeros((1 + self._tw,), np.int32)
                rec[0:4] = [node, self._ttag[name], t.min_ms, t.max_ms]
                for j, f in enumerate(t.fields):
                    rec[4 + j] = fields[f]
                rows.append(rec)
            return (np.stack(rows) if rows
                    else np.zeros((0, 1 + self._tw), np.int32))

        def _pred(fn):
            def wrapped(state):
                nodes = state["nodes"]
                out = torch.as_tensor(fn(_View(spec, table, nodes)),
                                      device=nodes.device)
                return out.to(torch.bool).expand(nodes.shape[0])
            return wrapped

        fault_lanes = None
        if self.fault is not None:
            from dslabs_tpu_torch.tpu.faults import compile_fault_lanes
            fault_lanes = compile_fault_lanes(self, table, nw,
                                              init_nodes())

        return TensorProtocol(
            name=self.name,
            n_nodes=n_nodes,
            node_width=nw,
            lane_domains=self._lane_domains(),
            symmetry=self._symmetry_spec(table),
            fault=fault_lanes,
            msg_width=self._mw,
            timer_width=self._tw,
            net_cap=self.net_cap,
            timer_cap=self.timer_cap,
            max_sends=max(max_sends, 1),
            max_sets=max(max_sets, 1),
            max_live_sends=self.max_live_sends,
            init_nodes=init_nodes,
            init_messages=init_messages,
            init_timers=init_timers,
            step_message=step_message,
            step_timer=step_timer,
            msg_dest=lambda msg: msg[..., 2],
            goals={k: _pred(v) for k, v in self.goals.items()},
            invariants={k: _pred(v) for k, v in self.invariants.items()},
            decode_message=self.decode_message,
            decode_timer=self.decode_timer,
        )

    def _invoke(self, fn, ctx: "Ctx", payload: dict, typ: str):
        """Run one handler under the compile gate: a KeyError on the
        payload dict (a field the type does not declare) surfaces as a
        SpecError naming the handler."""
        try:
            return fn(ctx, payload)
        except KeyError as e:
            name, line = self._handler_id(fn)
            missing = e.args[0] if e.args else "?"
            raise SpecError(
                f"read of field {missing!r} not declared by "
                f"{typ!r} (payload fields: "
                f"{sorted(k for k in payload if k != '_from')})",
                spec=self.name, handler=name, field=str(missing),
                line=line) from e

    def _count_budgets(self) -> Tuple[int, int]:
        """Count worst-case send/set rows by running every handler once
        with a counting context on P = 1 CPU tensors (handlers are
        straight-line over the combinators, so one run gives the static
        row count; nothing runs on the card).

        Handler invocations within one step are mutually exclusive, so
        the compiled step merges their row groups and the budget is the
        largest single invocation's count, not the sum.  Also records
        ``self._exc_hi``, the largest static ``ctx.fail`` code (0 when no
        handler fails)."""
        table, _ = self._layout()
        # (field, kind) -> size, read by the Ctx ops.
        self._sizes = {(f, k): size for (k, _i, f), (_o, size)
                       in table.items()}
        cpu = torch.device("cpu")
        step = _Step(1, cpu)

        def dummy_state():
            return {key: torch.zeros((1,) if size == 1 else (1, size),
                                     dtype=torch.int32)
                    for key, (_, size) in table.items()}

        def zero():
            return torch.zeros((1,), dtype=torch.int32)

        false = torch.zeros((1,), dtype=torch.bool)
        max_sends = max_sets = 0
        self._exc_hi = 0
        # Coverage record for the conformance linter's soft C4 half: the
        # Slots blocks, quorums and messages the dry-run touched.
        self._touched_slots = set()
        self._touched_quorums = set()
        self._touched_sends = set()
        for kind, i in self._instances():
            for types, registry, with_from in (
                    (self.messages, self.handlers, True),
                    (self.timers, self.timer_handlers, False)):
                for t in types:
                    fn = registry.get((kind.name, t.name))
                    if fn is None:
                        continue
                    sends, sets, excs = [], [], []
                    ctx = Ctx(self, dummy_state(), kind.name, i, false,
                              sends, sets, handler=self._handler_id(fn),
                              excs=excs, step=step)
                    payload = {f: zero() for f in t.fields}
                    if with_from:
                        payload["_from"] = zero()
                    self._invoke(fn, ctx, payload, t.name)
                    max_sends = max(max_sends, len(sends))
                    max_sets = max(max_sets, len(sets))
                    for code, _c in excs:
                        self._exc_hi = max(self._exc_hi, code)
        return (max_sends, max_sets)


class _View:
    """Read-only predicate view over the node lanes of a batch of states
    (``nodes`` [N, NW]): a scalar field is [N], an array field [N, size]."""

    def __init__(self, spec, table, nodes):
        self._table = table
        self._nodes = nodes

    def get(self, kind: str, idx: int, field: str):
        off, size = self._table[(kind, idx, field)]
        return (self._nodes[:, off] if size == 1
                else self._nodes[:, off:off + size])
