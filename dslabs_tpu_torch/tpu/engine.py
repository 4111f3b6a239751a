"""Tensor-search engine in PyTorch: batched BFS over a frontier of flat
state rows, with the visited table and the frontier resident on the card.

The counterpart of ``dslabs_tpu/tpu/engine.py``.  One wave of the search
runs this cycle on the device:

  frontier chunk [C, lanes] --(enumerate events x batched transition)-->
  successors [C*B, lanes] --(128-bit fingerprint, kernels.py)-->
  visited-table probe/insert (visited.py) --> fresh rows appended to the
  next frontier (``index_copy_``)

Checker semantics are those of the reference engine: the network is a set
of fixed-width message records kept in canonical sorted order, delivery
never removes a message, timer queues keep insertion order under the
TimerQueue partial order, dedup happens on successor generation, and an
exception lane makes a state terminal.

Storage.  Every uint32 quantity (fingerprints, table lines) is stored as
``torch.int32`` with the same bits: the CPU build of torch has no ``+``,
``<<``, ``>>``, ``sum`` or ``index_put`` for ``torch.uint32``.  The plain
hash arithmetic below therefore runs in int64 masked with ``0xFFFFFFFF``
(an int32 ``>>`` is arithmetic and would smear the sign bit), and the
CUDA kernels read the same buffers as ``uint32_t*``.

Layouts.  The reference's one-hot and transposed layouts exist to fill the
TPU's 128 vector lanes; here the natural layout (pairs on the leading
axis) and plain ``gather``/``scatter`` are used, and the rows they produce
are identical lane for lane.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from dslabs_tpu_torch.tpu import kernels, visited as visited_mod
from dslabs_tpu_torch.tpu._build import resolve_device
# The plain fingerprint lives beside its kernel; re-exported here where the
# reference engine defines it.
from dslabs_tpu_torch.tpu.kernels import row_fingerprints

__all__ = ["TensorProtocol", "TensorState", "TensorSearch", "SearchOutcome",
           "CapacityOverflow", "SENTINEL", "row_fingerprints",
           "flatten_state", "host_keys", "resolve_device"]

# Empty slots in the network / timer arrays hold SENTINEL in every lane, so
# they sort after every real record and hash consistently.
SENTINEL = 2 ** 31 - 1


class CapacityOverflow(RuntimeError):
    """A fixed-capacity structure (network set, timer queue, visited
    table, live-send budget) overflowed.  Overflow would silently corrupt
    verdicts and state counts, so the engine counts drops on the device
    and raises."""


# --------------------------------------------------------------------- state

class TensorState(Dict[str, torch.Tensor]):
    """A batch of search states (dict of int32 tensors):

    nodes  [N, NW]            all nodes' protocol lanes
    net    [N, NET_CAP, MW]   canonical-sorted message set
    timers [N, NN, T_CAP, TW] per-node timer queues, insertion order
                              (lane 0 = tag, 1 = min, 2 = max, rest payload)
    exc    [N]                terminal exception code (0 = none)
    """


@dataclasses.dataclass(frozen=True)
class TensorProtocol:
    """Contract a protocol twin fulfils.  The transition functions take a
    leading batch dimension ``P`` written out:

    ``step_message(nodes [P, NW], msg [P, MW])
        -> (nodes' [P, NW], sends [P, MAX_SENDS, MW],
            new_timers [P, MAX_SETS, 1 + TW][, exc [P]])``
    ``step_timer(nodes [P, NW], node_idx [P], timer [P, TW]) -> same``

    Invalid send / timer rows are all-SENTINEL; lane 0 of a new timer row
    is its target node.  ``msg_dest(msg [P, MW]) -> [P]``; predicates take
    a batched state dict and return ``[N]`` bool.

    A protocol that sets a field this slice does not port (runtime masks
    ``deliver_*_rt``, packing ``lane_domains``, a ``fault`` model) makes
    :class:`TensorSearch` raise."""

    name: str
    n_nodes: int
    node_width: int
    msg_width: int
    timer_width: int
    net_cap: int
    timer_cap: int
    max_sends: int
    max_sets: int
    init_nodes: Callable[[], np.ndarray]
    init_messages: Callable[[], np.ndarray]   # [k, MW] initial network
    init_timers: Callable[[], np.ndarray]     # [k, 1 + TW] initial timers
    step_message: Callable
    step_timer: Callable
    msg_dest: Callable
    invariants: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    goals: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    prunes: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    # optional masks: deliver_message(msg [..., MW]) -> bool [...],
    # deliver_timer(node_idx [...]) -> bool [...]
    deliver_message: Optional[Callable] = None
    deliver_timer: Optional[Callable] = None
    deliver_message_rt: Optional[Callable] = None
    deliver_timer_rt: Optional[Callable] = None
    # Max simultaneous valid send rows of one transition; sends are
    # compacted to this width before the set-insert merge.  Too small is a
    # CapacityOverflow, never a silent truncation.
    max_live_sends: Optional[int] = None
    lane_domains: Optional[dict] = None
    fault: Optional[object] = None


@dataclasses.dataclass
class SearchOutcome:
    end_condition: str               # GOAL_FOUND / INVARIANT_VIOLATED /
                                     # EXCEPTION_THROWN / SPACE_EXHAUSTED /
                                     # CAPACITY_EXHAUSTED / DEPTH_EXHAUSTED /
                                     # TIME_EXHAUSTED
    states_explored: int
    unique_states: int
    depth: int
    elapsed_secs: float
    violating_state: Optional[dict] = None
    goal_state: Optional[dict] = None
    predicate_name: Optional[str] = None
    exception_code: int = 0
    # Keys whose probe exhausted (table effectively full), treated as
    # fresh.  Strict searches raise instead.
    visited_overflow: int = 0


# ----------------------------------------------------------------- hashing

def flatten_state(state: dict) -> torch.Tensor:
    """[N]-batch state dict -> [N, L] int32 rows (the hash preimage).  The
    exception lane participates: exception states are distinct."""
    n = state["nodes"].shape[0]
    return torch.cat([
        state["nodes"].reshape(n, -1),
        state["net"].reshape(n, -1),
        state["timers"].reshape(n, -1),
        state["exc"].reshape(n, 1),
    ], dim=1).to(torch.int32)


def host_keys(fp: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[N, 4] uint32 fingerprints (or their int32 bits) -> host (h1, h2)
    uint64 arrays."""
    fp = np.asarray(fp).view(np.uint32).astype(np.uint64)
    h1 = (fp[:, 0] << np.uint64(32)) | fp[:, 1]
    h2 = (fp[:, 2] << np.uint64(32)) | fp[:, 3]
    return h1, h2


def _keys_to_rows(visited: Tuple[np.ndarray, np.ndarray]) -> np.ndarray:
    """Inverse of :func:`host_keys`: (h1, h2) uint64 -> [K, 4] uint32."""
    h1, h2 = visited
    rows = np.empty((len(h1), 4), np.uint32)
    rows[:, 0] = (h1 >> np.uint64(32)).astype(np.uint32)
    rows[:, 1] = (h1 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    rows[:, 2] = (h2 >> np.uint64(32)).astype(np.uint32)
    rows[:, 3] = (h2 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return rows


# ------------------------------------------------------------ net/timer ops

def _row_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic ``a < b`` over the trailing lane axis (broadcasts)."""
    a, b = torch.broadcast_tensors(a, b)
    eq = a == b
    prefix_eq = torch.cumprod(eq.to(torch.int32), dim=-1).bool()
    prefix_excl = torch.cat([torch.ones_like(prefix_eq[..., :1]),
                             prefix_eq[..., :-1]], dim=-1)
    return torch.any(~eq & prefix_excl & (a < b), dim=-1)


def _lex_order(cols) -> torch.Tensor:
    """Stable lexicographic order of rows keyed by ``cols`` (primary key
    first): torch has no ``lexsort``, so chain stable sorts from the last
    key to the first."""
    order = torch.arange(cols[0].shape[0], device=cols[0].device)
    for key in reversed(cols):
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def canonicalize_net(net: torch.Tensor) -> torch.Tensor:
    """Sort one message set [CAP, MW] into canonical (raw-lane
    lexicographic) order and collapse duplicates; empty rows are
    all-SENTINEL and sort last.  Cold path: initial states only."""
    cap, mw = net.shape
    empty = net[:, 0] == SENTINEL
    order = _lex_order([empty.to(torch.int32)]
                       + [net[:, lane] for lane in range(mw)])
    net_s = net[order]
    empty_s = empty[order]
    dup = torch.zeros(cap, dtype=torch.bool, device=net.device)
    dup[1:] = torch.all(net_s[1:] == net_s[:-1], dim=1) & ~empty_s[1:]
    keep = ~dup & ~empty_s
    pos = torch.cumsum(keep.to(torch.int64), 0) - 1
    out = torch.full((cap + 1, mw), SENTINEL, dtype=net.dtype,
                     device=net.device)
    out[torch.where(keep, pos, cap)] = net_s
    return out[:cap]


def compact_rows_batched(rows: torch.Tensor, budget: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact the occupied rows (lane 0 != SENTINEL) of each [R, W] block
    of ``rows`` [P, R, W] into the first ``budget`` slots, keeping order.
    Returns ``(out [P, budget, W], overflow [P])``: overflow counts the
    occupied rows past the budget (callers treat nonzero as fatal)."""
    p, r, w = rows.shape
    occ = rows[:, :, 0] != SENTINEL
    pos = torch.cumsum(occ.to(torch.int64), 1) - 1
    dest = torch.where(occ & (pos < budget), pos, budget)
    out = torch.full((p, budget + 1, w), SENTINEL, dtype=rows.dtype,
                     device=rows.device)
    out.scatter_(1, dest[:, :, None].expand(p, r, w), rows)
    overflow = (occ & (pos >= budget)).sum(1).to(torch.int32)
    return out[:, :budget], overflow


def compact_rows(rows: torch.Tensor, budget: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One [R, W] block: see :func:`compact_rows_batched`."""
    out, over = compact_rows_batched(rows[None], budget)
    return out[0], over[0]


def _lex_cmp(a: torch.Tensor, b: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a < b, a == b) lexicographic over the trailing lane axis of two
    broadcastable tensors, one lane at a time (no [..., MW] temporary)."""
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    lt = torch.zeros(shape, dtype=torch.bool, device=a.device)
    eq = torch.ones(shape, dtype=torch.bool, device=a.device)
    for lane in range(a.shape[-1]):
        av, bv = a[..., lane], b[..., lane]
        lt |= eq & (av < bv)
        eq &= av == bv
    return lt, eq


def insert_messages_batched(net: torch.Tensor, sends: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Set-insert ``sends`` [P, S, MW] into canonical networks ``net``
    [P, CAP, MW] -> (merged [P, CAP, MW], overflow [P]).

    Sort-free merge: each valid send's merged rank is the occupied net
    rows below it plus the valid sends below it; net row j moves right by
    the valid sends below it.  Destinations are distinct, so one scatter
    places everything.  ``overflow`` counts distinct records that did not
    fit (the caller raises on nonzero)."""
    p, cap, mw = net.shape
    s = sends.shape[1]
    dev = net.device
    net_occ = net[:, :, 0] != SENTINEL                        # [P, CAP]
    send_occ = sends[:, :, 0] != SENTINEL                     # [P, S]
    sn_less, sn_eq = _lex_cmp(sends[:, :, None, :], net[:, None, :, :])
    dup_net = torch.any(sn_eq & net_occ[:, None, :], dim=2)   # [P, S]
    ss_less, ss_eq = _lex_cmp(sends[:, :, None, :], sends[:, None, :, :])
    earlier = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev),
                         diagonal=-1)                          # j < i
    earlier_dup = torch.any(ss_eq & earlier & send_occ[:, None, :], dim=2)
    valid = send_occ & ~dup_net & ~earlier_dup                # [P, S]

    net_below = (~sn_less & ~sn_eq & net_occ[:, None, :]).sum(2)
    sends_below = ((ss_less.transpose(1, 2) | (ss_eq & earlier))
                   & valid[:, None, :]).sum(2)
    dst_send = net_below + sends_below                        # [P, S]
    shift = (sn_less & valid[:, :, None]).sum(1)              # [P, CAP]

    width = cap + s + 1                    # last column = dump for misses
    dump = cap + s
    dst_net = torch.where(
        net_occ, torch.arange(cap, device=dev)[None, :] + shift, dump)
    dst_send = torch.where(valid, dst_send, dump)
    out = torch.full((p, width, mw), SENTINEL, dtype=net.dtype, device=dev)
    out.scatter_(1, dst_net[:, :, None].expand(p, cap, mw), net)
    out.scatter_(1, dst_send[:, :, None].expand(p, s, mw), sends)
    total = net_occ.sum(1) + valid.sum(1)
    overflow = torch.clamp(total - cap, min=0).to(torch.int32)
    return out[:, :cap], overflow


def insert_messages(net: torch.Tensor, sends: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One network [CAP, MW] and its sends [S, MW]: see
    :func:`insert_messages_batched`."""
    out, over = insert_messages_batched(net[None], sends[None])
    return out[0], over[0]


def timer_deliverable_mask(queue: torch.Tensor) -> torch.Tensor:
    """[..., T_CAP, TW] -> [..., T_CAP] bool: the TimerQueue partial order.
    deliverable[i] = occupied[i] and min[i] < min(max[j] for occupied
    j < i)."""
    occupied = queue[..., 0] != SENTINEL
    maxes = torch.where(occupied, queue[..., 2], SENTINEL)
    cm = torch.cummin(maxes, dim=-1).values
    prefix_min = torch.cat([torch.full_like(cm[..., :1], SENTINEL),
                            cm[..., :-1]], dim=-1)
    return occupied & (queue[..., 1] < prefix_min)


def remove_timer(queue: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Remove the timer at position ``idx`` [P] from each queue
    [P, T_CAP, TW], shifting later entries left (insertion order is
    semantic)."""
    p, cap, tw = queue.shape
    shifted = torch.cat([queue[:, 1:],
                         torch.full((p, 1, tw), SENTINEL, dtype=queue.dtype,
                                    device=queue.device)], dim=1)
    pos = torch.arange(cap, device=queue.device)
    return torch.where((pos[None, :] >= idx[:, None])[:, :, None],
                       shifted, queue)


def append_timers(timers: torch.Tensor, new_timers: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append ``new_timers`` [P, S, 1+TW] (lane 0 = node index, SENTINEL
    rows invalid) to the per-node queues ``timers`` [P, NN, T_CAP, TW],
    keeping insertion order.  Returns ``(timers', dropped [P])``: a full
    queue drops the append and the engine raises on the count."""
    p, nn, cap, tw = timers.shape
    s = new_timers.shape[1]
    dev = timers.device
    node = new_timers[:, :, 0]
    valid = node != SENTINEL
    node_c = torch.where(valid, node, 0).clamp(0, nn - 1).to(torch.int64)
    counts = (timers[:, :, :, 0] != SENTINEL).sum(2)           # [P, NN]
    earlier = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev),
                         diagonal=-1)
    earlier_same = (earlier & (node[:, None, :] == node[:, :, None])
                    & valid[:, None, :])
    offset = earlier_same.sum(2)
    slot = counts.gather(1, node_c) + offset                   # [P, S]
    ok = valid & (slot < cap)
    dropped = (valid & ~ok).sum(1).to(torch.int32)
    flat = timers.reshape(p, nn * cap, tw).clone()
    dest = torch.where(ok, node_c * cap + slot, nn * cap)
    buf = torch.cat([flat, torch.zeros((p, 1, tw), dtype=flat.dtype,
                                       device=dev)], dim=1)
    buf.scatter_(1, dest[:, :, None].expand(p, s, tw),
                 new_timers[:, :, 1:].to(flat.dtype))
    return buf[:, :nn * cap].reshape(p, nn, cap, tw), dropped


def _normalize_step(out, p: int, device) -> tuple:
    """Protocol step fns return a 3-tuple (no exception lane) or a 4-tuple
    with a trailing int32 exception code per pair."""
    if len(out) == 3:
        nodes2, sends, new_t = out
        return nodes2, sends, new_t, torch.zeros((p,), dtype=torch.int32,
                                                 device=device)
    nodes2, sends, new_t, exc = out
    return nodes2, sends, new_t, exc.to(torch.int32)


# ------------------------------------------------------------------- engine

# Load factor (of the strict 75% limit) past which the visited-table
# early warning fires, as in the reference.
VISITED_WARN = 0.85


def _later(option: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"TensorSearch: {option} is not ported yet; it comes with the "
        f"{slice_name} slice of the PyTorch port (see ROADMAP.md)")


class TensorSearch:
    """Single-device BFS with the visited table and the frontier resident
    on ``device`` (the card unless the caller asks for another).

    Ports the device-resident wave loop of the reference
    (``run`` -> ``_run_device``).  Options of the reference engine that
    this slice does not port raise ``NotImplementedError`` naming the
    slice that brings them: ``record_trace`` / ``use_host_visited``
    (run_host and traces), ``checkpoint_path`` / ``checkpoint_every`` /
    ``spill`` (spill and checkpoint), ``telemetry`` (supervisor and
    telemetry), ``packed=True`` or a protocol with ``lane_domains``
    (spec compiler and packing), ``symmetry=True`` or a protocol with a
    ``fault`` model (symmetry and faults), runtime masks."""

    def __init__(self, protocol: TensorProtocol,
                 frontier_cap: int = 1 << 16,
                 chunk: int = 1 << 12,
                 max_depth: Optional[int] = None,
                 max_secs: Optional[float] = None,
                 record_trace: bool = False,
                 in_chunk_dedup: bool = True,
                 ev_budget=None,
                 visited_cap: int = 1 << 20,
                 strict: bool = True,
                 use_host_visited: bool = False,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0,
                 spill=None,
                 telemetry=None,
                 packed: Optional[bool] = None,
                 symmetry: Optional[bool] = None,
                 device=None):
        if record_trace:
            raise _later("record_trace", "run_host + traces")
        if use_host_visited:
            raise _later("use_host_visited (run_host)", "run_host + traces")
        if not in_chunk_dedup:
            raise _later("in_chunk_dedup=False (the prefilter only feeds "
                         "run_host)", "run_host + traces")
        if checkpoint_path is not None or checkpoint_every:
            raise _later("checkpoint_path / checkpoint_every",
                         "spill + checkpoint")
        if spill:
            raise _later("spill", "spill + checkpoint")
        if telemetry is not None:
            raise _later("telemetry", "supervisor + telemetry")
        if packed or protocol.lane_domains is not None:
            raise _later("bit-packed frontier rows (lane_domains)",
                         "spec compiler + packing")
        if symmetry:
            raise _later("symmetry=True", "symmetry + faults")
        if protocol.fault is not None:
            raise _later("fault models", "symmetry + faults")
        if (protocol.deliver_message_rt is not None
                or protocol.deliver_timer_rt is not None):
            raise _later("runtime delivery masks (deliver_*_rt)",
                         "harness binding")
        self.p = protocol
        self.device = resolve_device(device)
        self.frontier_cap = frontier_cap
        self.chunk = chunk
        self.max_depth = max_depth
        self.max_secs = max_secs
        visited_mod.check_cap(visited_cap)
        self.visited_cap = visited_cap
        self.strict = strict
        # Occupancy-compacted event enumeration: each state's valid events
        # packed into per-kind pair slots.  ev_budget None = full grid per
        # kind; int b caps message slots; (bm, bt) caps both.  A state
        # with more valid events than a window re-steps the same chunk at
        # the next window, so a budget never truncates coverage.
        tgrid = protocol.n_nodes * protocol.timer_cap
        if ev_budget is None:
            bm, bt = protocol.net_cap, tgrid
        elif isinstance(ev_budget, tuple):
            bm, bt = ev_budget
        else:
            bm, bt = ev_budget, tgrid
        self._ev_msg = min(bm, protocol.net_cap)
        self._ev_tmr = min(bt, tgrid)
        self._ev_slots = self._ev_msg + self._ev_tmr
        p = protocol
        self._off = (p.node_width,
                     p.node_width + p.net_cap * p.msg_width,
                     p.node_width + p.net_cap * p.msg_width
                     + p.n_nodes * p.timer_cap * p.timer_width)
        self.lanes = self._off[2] + 1
        # Terminal-flag order = checkState order: exception strictly
        # first, then invariants, then goals.
        self._flag_names = (["exc"]
                            + [f"inv:{n}" for n in protocol.invariants]
                            + [f"goal:{n}" for n in protocol.goals])

    def set_runtime_masks(self, marr, tarr) -> None:
        raise _later("runtime delivery masks (deliver_*_rt)",
                     "harness binding")

    # -------------------------------------------------------------- states

    def initial_state(self) -> dict:
        p = self.p
        dev = self.device
        nodes = torch.as_tensor(np.asarray(p.init_nodes(), np.int32),
                                device=dev)[None]
        net = torch.full((1, p.net_cap, p.msg_width), SENTINEL,
                         dtype=torch.int32, device=dev)
        init_msgs = np.asarray(p.init_messages(), np.int32).reshape(
            -1, p.msg_width)
        if init_msgs.shape[0]:
            net[0, :init_msgs.shape[0]] = torch.as_tensor(init_msgs,
                                                          device=dev)
            net[0] = canonicalize_net(net[0])
        timers = torch.full((1, p.n_nodes, p.timer_cap, p.timer_width),
                            SENTINEL, dtype=torch.int32, device=dev)
        init_tmrs = np.asarray(p.init_timers(), np.int32)
        if init_tmrs.size:
            timers, dropped = append_timers(
                timers, torch.as_tensor(init_tmrs, device=dev)[None])
            if int(dropped.sum()):
                raise CapacityOverflow(
                    f"{p.name}: initial timers overflow timer_cap="
                    f"{p.timer_cap}")
        return {"nodes": nodes, "net": net, "timers": timers,
                "exc": torch.zeros((1,), dtype=torch.int32, device=dev)}

    def unflatten_rows(self, rows) -> dict:
        """[N, lanes] rows -> batched state dict (views, no copies); the
        inverse of :func:`flatten_state`.  Works on tensors and arrays."""
        p = self.p
        o0, o1, o2 = self._off
        n = rows.shape[0]
        return {
            "nodes": rows[:, :o0],
            "net": rows[:, o0:o1].reshape(n, p.net_cap, p.msg_width),
            "timers": rows[:, o1:o2].reshape(
                n, p.n_nodes, p.timer_cap, p.timer_width),
            "exc": rows[:, o2],
        }

    def _num_events(self) -> int:
        """Pair slots per state (the successor-row stride)."""
        return self._ev_slots

    # -------------------------------------------------------------- expand

    def _msg_step_raw(self, chunk: dict, par: torch.Tensor,
                      net_slot: torch.Tensor):
        """Handler half of a message step for pairs (parent ``par`` [P],
        net slot [P]) of the chunk state dict -> (nodes', sends, timers',
        exc, ok, t_over).  Pair inputs are gathered from the chunk by
        parent index instead of repeating whole rows per event."""
        p = self.p
        nodes = chunk["nodes"][par]
        msg = chunk["net"][par, net_slot.clamp(0, p.net_cap - 1)]
        ok = msg[:, 0] != SENTINEL
        if p.deliver_message is not None:
            ok = ok & p.deliver_message(msg)
        nodes2, sends, new_t, exc = _normalize_step(
            p.step_message(nodes, msg), par.shape[0], par.device)
        timers2, t_over = append_timers(chunk["timers"][par], new_t)
        return nodes2, sends, timers2, exc, ok, t_over

    def _tmr_step_raw(self, chunk: dict, par: torch.Tensor,
                      t_idx: torch.Tensor):
        """Handler half of a timer step: timer grid index t_idx = node *
        timer_cap + queue slot."""
        p = self.p
        t_node = torch.div(t_idx, p.timer_cap, rounding_mode="floor")
        t_slot = t_idx % p.timer_cap
        ar = torch.arange(par.shape[0], device=par.device)
        timers = chunk["timers"][par]                       # [P, NN, T, TW]
        queue = timers[ar, t_node]                          # [P, T, TW]
        ok = timer_deliverable_mask(queue)[ar, t_slot]
        if p.deliver_timer is not None:
            ok = ok & p.deliver_timer(t_node)
        timer = queue[ar, t_slot]
        nodes2, sends, new_t, exc = _normalize_step(
            p.step_timer(chunk["nodes"][par], t_node.to(torch.int32), timer),
            par.shape[0], par.device)
        # Firing consumes the timer.  ``timers`` is a fresh gather, so the
        # write below touches no chunk state.
        timers[ar, t_node] = remove_timer(queue, t_slot)
        timers2, t_over = append_timers(timers, new_t)
        return nodes2, sends, timers2, exc, ok, t_over

    def _batched_tail(self, chunk: dict, par: torch.Tensor, nodes2, sends,
                      timers2, exc, ok, t_over):
        """Merge tail of a batch of pairs: compact the sends to the live
        budget, set-insert them into the parent's network, and lay out
        the successor rows -> (rows [P, lanes], over [P])."""
        p = self.p
        n_pairs = par.shape[0]
        send_over = torch.zeros((n_pairs,), dtype=torch.int32,
                                device=par.device)
        if p.max_live_sends is not None and p.max_live_sends < p.max_sends:
            sends, send_over = compact_rows_batched(sends, p.max_live_sends)
        net2, net_over = insert_messages_batched(chunk["net"][par], sends)
        rows = torch.cat([nodes2.to(torch.int32),
                          net2.reshape(n_pairs, -1),
                          timers2.reshape(n_pairs, -1),
                          exc.to(torch.int32).reshape(n_pairs, 1)], dim=1)
        over = (net_over + send_over + t_over) * ok.to(torch.int32)
        return rows, over

    @staticmethod
    def _compact_ids(valid_ev: torch.Tensor, budget: int, offset: int = 0):
        """[C, G] validity grid -> ([C, budget] indices into G, -1 = empty
        slot; remaining count).  ``offset`` selects the window of valid
        events by rank [offset, offset + budget); ``remaining`` counts
        valid events past it."""
        c, g = valid_ev.shape
        dev = valid_ev.device
        if budget >= g:
            ids = torch.arange(g, dtype=torch.int64, device=dev).expand(c, g)
            keep = valid_ev if offset == 0 else torch.zeros_like(valid_ev)
            return (torch.where(keep, ids, -1),
                    torch.zeros((), dtype=torch.int64, device=dev))
        pos = torch.cumsum(valid_ev.to(torch.int64), 1) - 1
        inwin = valid_ev & (pos >= offset) & (pos < offset + budget)
        dest = torch.where(inwin, pos - offset, budget)
        ids = torch.full((c, budget + 1), -1, dtype=torch.int64, device=dev)
        ids.scatter_(1, dest, torch.arange(g, device=dev).expand(c, g))
        remaining = (valid_ev & (pos >= budget + offset)).sum()
        return ids[:, :budget], remaining

    def _event_tables(self, chunk_rows: torch.Tensor,
                      chunk_valid: torch.Tensor, ev_pass: int = 0):
        """[C, lanes] chunk -> (msg_ids [C, Bm] net-slot indices, tmr_ids
        [C, Bt] timer grid indices, ev_remaining): each state's valid
        events (occupied network rows + deliverable timers, masked by the
        protocol's deliver_* settings) packed into per-kind pair slots."""
        p = self.p
        c = chunk_valid.shape[0]
        cs = self.unflatten_rows(chunk_rows)
        msg_ok = cs["net"][:, :, 0] != SENTINEL             # [C, net_cap]
        if p.deliver_message is not None:
            msg_ok = msg_ok & p.deliver_message(
                cs["net"].reshape(-1, p.msg_width)).reshape(c, p.net_cap)
        tmask = timer_deliverable_mask(cs["timers"])         # [C, NN, T]
        if p.deliver_timer is not None:
            dt = p.deliver_timer(torch.arange(p.n_nodes,
                                              device=chunk_rows.device))
            tmask = tmask & dt[None, :, None]
        msg_ids, m_rem = self._compact_ids(
            msg_ok & chunk_valid[:, None], self._ev_msg,
            ev_pass * self._ev_msg)
        tmr_ids, t_rem = self._compact_ids(
            tmask.reshape(c, -1) & chunk_valid[:, None], self._ev_tmr,
            ev_pass * self._ev_tmr)
        return msg_ids, tmr_ids, m_rem + t_rem

    def _expand_kind(self, cs: dict, ids: torch.Tensor, raw):
        """Run one event kind's handlers + merge tail over the chunk's
        pair table ``ids`` [C, B] -> (rows, valids, overs), pair-major."""
        c, b = ids.shape
        dev = ids.device
        if b == 0:
            return (torch.zeros((0, self.lanes), dtype=torch.int32,
                                device=dev),
                    torch.zeros((0,), dtype=torch.bool, device=dev),
                    torch.zeros((0,), dtype=torch.int32, device=dev))
        par = torch.arange(c, device=dev).repeat_interleave(b)
        nodes2, sends, timers2, exc, ok, t_over = raw(
            cs, par, ids.clamp(min=0).reshape(-1))
        rows, over = self._batched_tail(cs, par, nodes2, sends, timers2,
                                        exc, ok, t_over)
        return rows, ok & (ids >= 0).reshape(-1), over

    def _expand_chunk(self, chunk_rows: torch.Tensor,
                      chunk_valid: torch.Tensor, ev_pass: int = 0,
                      dedup: bool = False):
        """[C, lanes] chunk rows -> (rows [C*B, lanes], valids [C*B],
        fp [C*B, 4] int32 keys, unique [C*B], overflow scalar,
        ev_remaining scalar, event_ids [C, B], flags dict), all on the
        chunk's device with no host sync.  B = Bm + Bt, message slots
        first per state (successor row = chunk_row * B + slot)."""
        if dedup:
            raise _later("the in-chunk sort-unique prefilter (dedup=True)",
                         "run_host + traces")
        p = self.p
        c = chunk_valid.shape[0]
        bm, bt = self._ev_msg, self._ev_tmr
        msg_ids, tmr_ids, ev_rem = self._event_tables(chunk_rows,
                                                      chunk_valid, ev_pass)
        cs = self.unflatten_rows(chunk_rows)
        rows_m, val_m, over_m = self._expand_kind(cs, msg_ids,
                                                  self._msg_step_raw)
        rows_t, val_t, over_t = self._expand_kind(cs, tmr_ids,
                                                  self._tmr_step_raw)

        def inter(a, b):
            return torch.cat([a.reshape((c, bm) + a.shape[1:]),
                              b.reshape((c, bt) + b.shape[1:])],
                             dim=1).reshape((c * (bm + bt),) + a.shape[1:])

        rows = inter(rows_m, rows_t)
        valids = inter(val_m, val_t)
        overs = inter(over_m, over_t)
        # Grid event ids: timer entries are net_cap + t_idx.
        event_ids = torch.cat(
            [msg_ids, torch.where(tmr_ids >= 0, p.net_cap + tmr_ids, -1)],
            dim=1)
        overflow = (overs * valids.to(torch.int32)).sum()
        # Kernel 1 on CUDA rows, its plain version on CPU rows.
        fp = kernels.fingerprint_rows(rows)
        # The visited table is the dedup authority: it resolves in-batch
        # duplicates itself, so every valid successor goes to it.
        unique = valids
        flags = {}
        succ = self.unflatten_rows(rows)
        for kind, preds in (("inv", p.invariants), ("goal", p.goals),
                            ("prune", p.prunes)):
            for name, fn in preds.items():
                flags[f"{kind}:{name}"] = fn(succ) & valids
        return (rows, valids, fp, unique, overflow, ev_rem, event_ids,
                flags)

    # ----------------------------------------------------------------- run

    def _host_state(self, rows: np.ndarray) -> dict:
        """A host (numpy) state dict of [1, lanes] rows, the form outcomes
        carry (``goal_state`` / ``violating_state``)."""
        return {k: np.array(v) for k, v in
                self.unflatten_rows(np.asarray(rows)).items()}

    def _check_initial(self, state, t0) -> Optional[SearchOutcome]:
        p = self.p
        host = self._host_state(flatten_state(state).cpu().numpy())
        for kind, preds in (("inv", p.invariants), ("goal", p.goals)):
            for name, fn in preds.items():
                hit = bool(fn(state)[0])
                if kind == "inv" and not hit:
                    return SearchOutcome("INVARIANT_VIOLATED", 1, 1, 0,
                                         time.time() - t0,
                                         violating_state=host,
                                         predicate_name=name)
                if kind == "goal" and hit:
                    return SearchOutcome("GOAL_FOUND", 1, 1, 0,
                                         time.time() - t0, goal_state=host,
                                         predicate_name=name)
        return None

    def run(self, check_initial: bool = True,
            initial: Optional[dict] = None,
            resume: bool = False) -> SearchOutcome:
        """Run the BFS.  ``initial`` (a batch-1 state dict, for example
        ``interop.state_from_numpy`` of a prior outcome's ``goal_state``)
        starts the search from that state instead of the protocol's
        initial state."""
        if resume:
            raise _later("resume (checkpoints)", "spill + checkpoint")
        return self._run_device(check_initial, initial)

    def _build_dev_step(self, cap: int):
        """One wave step over frontier chunk ``j``: expand -> visited-table
        insert -> frontier-compact append, all on the device with no host
        sync.  The carry is updated IN PLACE where the reference donates
        it to a jitted program: kernel 2 writes the table, ``index_copy_``
        writes the next frontier, and the counters are added to."""
        p = self.p
        C = self.chunk
        dev = self.device

        def step(carry, j: int, ev_pass: int):
            start = j * C
            rows_chunk = carry["cur"][start:start + C]
            valid = (start + torch.arange(C, device=dev)) < carry["cur_n"]
            (rows, valids, fp, unique, overflow, ev_rem, _event_ids,
             flags) = self._expand_chunk(rows_chunk, valid, ev_pass,
                                         dedup=False)
            # ---- terminal flags, checkState order (exception first);
            # the first-hit successor row is kept per flag.
            hit_list = [valids & (rows[:, -1] != 0)]
            for n in p.invariants:
                hit_list.append(valids & ~flags[f"inv:{n}"])
            for n in p.goals:
                hit_list.append(flags[f"goal:{n}"])
            hits = torch.stack(hit_list)                    # [nf, C*B]
            cnts = hits.sum(1)
            idxs = torch.argmax(hits.to(torch.int32), dim=1)  # first hit
            fresh_flag = (carry["flag_cnt"] == 0) & (cnts > 0)
            carry["flag_rows"].copy_(torch.where(
                fresh_flag[:, None], rows[idxs], carry["flag_rows"]))

            pruned = rows[:, -1] != 0        # exception states terminal
            for n in p.prunes:
                pruned = pruned | flags[f"prune:{n}"]

            # ---- device-table dedup (the authority); unresolved keys are
            # treated as fresh and counted into vis_over.
            _, inserted, unresolved = visited_mod.insert(
                carry["visited"], fp, unique)
            fresh = inserted | unresolved

            # ---- frontier-compact append of fresh, un-pruned successors
            sel = fresh & ~pruned
            spos = torch.cumsum(sel.to(torch.int64), 0) - 1
            nxt_n = carry["nxt_n"]
            dst = nxt_n + spos
            sdst = torch.where(sel & (dst < cap), dst, cap)  # cap = dump row
            carry["nxt"].index_copy_(0, sdst, rows)
            n_sel = sel.sum()
            f_drop = torch.clamp(nxt_n + n_sel - cap, min=0)
            carry["nxt_n"] += n_sel - f_drop
            carry["vis_n"] += inserted.sum()
            carry["explored"] += valids.sum()
            carry["overflow"] += overflow
            carry["vis_over"] += unresolved.sum()
            carry["f_drop"] += f_drop
            carry["flag_cnt"] += cnts
            # The per-wave stats vector, the only recurring device->host
            # transfer: [explored, overflow, vis_over, f_drop, vis_n,
            # nxt_n, ev_remaining] ++ flag counts.  (The reference keeps
            # the chunk index j at slot 6; here the host drives j.)
            return torch.cat([carry["explored"], carry["overflow"],
                              carry["vis_over"], carry["f_drop"],
                              carry["vis_n"], carry["nxt_n"],
                              ev_rem.reshape(1), carry["flag_cnt"]])

        return step

    @staticmethod
    def _build_dev_promote(cap: int):
        """Between-wave promotion nxt -> cur: the two frontier buffers
        swap in place of the reference's donated re-allocation.  Rows past
        ``cur_n`` are never read as valid, so the new ``nxt`` is not
        cleared."""

        def promote(carry):
            carry["cur"], carry["nxt"] = carry["nxt"], carry["cur"]
            carry["cur_n"].copy_(carry["nxt_n"])
            carry["nxt_n"].zero_()
            return carry

        return promote

    def _build_dev_init(self, cap: int):
        """The carry, built on the device: only the root row crosses from
        the host; the root key goes through the same table insert as the
        waves."""
        lanes = self.lanes
        V = self.visited_cap
        nf = len(self._flag_names)
        dev = self.device

        def build(row0):
            fp0 = kernels.fingerprint_rows(row0)              # [1, 4]
            table = visited_mod.empty_table(V, dev)
            visited_mod.insert(table, fp0,
                               torch.ones((1,), dtype=torch.bool,
                                          device=dev))
            cur = torch.zeros((cap + 1, lanes), dtype=torch.int32, device=dev)
            cur[0] = row0[0]

            def z():
                return torch.zeros((1,), dtype=torch.int64, device=dev)

            return {
                "cur": cur, "cur_n": z() + 1,
                "nxt": torch.zeros((cap + 1, lanes), dtype=torch.int32,
                                   device=dev),
                "nxt_n": z(), "visited": table, "vis_n": z() + 1,
                "explored": z(), "overflow": z(), "vis_over": z(),
                "f_drop": z(),
                "flag_cnt": torch.zeros((nf,), dtype=torch.int64,
                                        device=dev),
                "flag_rows": torch.zeros((nf, lanes), dtype=torch.int32,
                                         device=dev),
            }

        return build

    def _dev_terminal(self, carry, flag_counts, explored, vis_n, depth,
                      t0, vis_over) -> SearchOutcome:
        """Resolve the first terminal flag (checkState order).  The flag
        rows are the one non-scalar readback, paid once per run."""
        rows = carry["flag_rows"].cpu().numpy()
        for fi, fname in enumerate(self._flag_names):
            if flag_counts[fi] <= 0:
                continue
            st = self._host_state(rows[fi][None])
            elapsed = time.time() - t0
            if fname == "exc":
                return SearchOutcome(
                    "EXCEPTION_THROWN", explored, vis_n, depth, elapsed,
                    violating_state=st, exception_code=int(st["exc"][0]),
                    visited_overflow=vis_over)
            kind, pname = fname.split(":", 1)
            if kind == "inv":
                return SearchOutcome(
                    "INVARIANT_VIOLATED", explored, vis_n, depth, elapsed,
                    violating_state=st, predicate_name=pname,
                    visited_overflow=vis_over)
            return SearchOutcome(
                "GOAL_FOUND", explored, vis_n, depth, elapsed,
                goal_state=st, predicate_name=pname,
                visited_overflow=vis_over)
        raise AssertionError("flag counts fired without a flag name")

    def _run_device(self, check_initial: bool = True,
                    initial: Optional[dict] = None) -> SearchOutcome:
        """The device-resident BFS.  The frontier buffer starts small and
        grows x8 on overflow (a deterministic restart: same verdict) up
        to ``frontier_cap``; overflowing at the cap is
        CAPACITY_EXHAUSTED."""
        t0 = time.time()
        if initial is not None:
            state = {k: torch.as_tensor(v).to(device=self.device,
                                              dtype=torch.int32)
                     for k, v in initial.items()}
        else:
            state = self.initial_state()
        if check_initial:
            out = self._check_initial(state, t0)
            if out is not None:
                return out
        C = self.chunk
        user_cap = -(-self.frontier_cap // C) * C
        cap = min(user_cap, -(-max(C, 1 << 11) // C) * C)
        while True:
            out = self._device_attempt(state, cap, user_cap, t0)
            if out is not None:
                return out
            cap = min(cap * 8, user_cap)

    def _device_attempt(self, state, cap: int, user_cap: int,
                        t0) -> Optional[SearchOutcome]:
        """One run at a fixed frontier-buffer capacity; None = the
        frontier overflowed below the user cap (the caller grows it and
        restarts)."""
        p = self.p
        C = self.chunk
        step = self._build_dev_step(cap)
        promote = self._build_dev_promote(cap)
        carry = self._build_dev_init(cap)(flatten_state(state))
        # A finite ev_budget can need extra window passes over a chunk;
        # the host then reads each step's stats to decide (the reference
        # syncs the same way in that mode).
        windowed = (self._ev_msg < p.net_cap
                    or self._ev_tmr < p.n_nodes * p.timer_cap)
        nf = len(self._flag_names)
        depth = 0
        n_chunks = 1
        last = (0, 1, 0)   # (explored, unique, vis_over) at the last sync
        while True:
            if self.max_secs is not None and time.time() - t0 > self.max_secs:
                return SearchOutcome(
                    "TIME_EXHAUSTED", last[0], last[1], depth,
                    time.time() - t0, visited_overflow=last[2])
            if self.max_depth is not None and depth >= self.max_depth:
                return SearchOutcome(
                    "DEPTH_EXHAUSTED", last[0], last[1], depth,
                    time.time() - t0, visited_overflow=last[2])
            depth += 1
            j = ev_pass = 0
            sdev = None
            while j < n_chunks:
                sdev = step(carry, j, ev_pass)
                if windowed and int(sdev[6]) > 0:
                    ev_pass += 1
                    continue
                j += 1
                ev_pass = 0
            s = sdev.cpu().numpy()
            promote(carry)
            (explored, overflow, vis_over, f_drop, vis_n,
             nxt_n) = (int(x) for x in s[:6])
            flag_counts = s[7:7 + nf]
            if overflow:
                raise CapacityOverflow(
                    f"{p.name}: net_cap={p.net_cap}, timer_cap="
                    f"{p.timer_cap}, or max_live_sends={p.max_live_sends} "
                    f"overflowed at depth {depth} ({overflow} drops); "
                    "raise the caps")
            limit = (3 * self.visited_cap // 4 if self.strict
                     else self.visited_cap)
            if (not getattr(self, "_warned_visited", False)
                    and vis_n >= int(VISITED_WARN * limit)):
                self._warned_visited = True
                warnings.warn(
                    f"{p.name}: visited table at {vis_n}/"
                    f"{self.visited_cap} at depth {depth}: capacity "
                    "pressure; raise visited_cap",
                    RuntimeWarning, stacklevel=2)
            if vis_over and self.strict:
                raise CapacityOverflow(
                    f"{p.name}: visited table full at depth {depth} "
                    f"({vis_over} unresolved keys, cap "
                    f"{self.visited_cap}); raise visited_cap or run "
                    "strict=False for sound treat-as-fresh degradation")
            if self.strict and vis_n > 3 * self.visited_cap // 4:
                raise CapacityOverflow(
                    f"{p.name}: visited table > 75% full "
                    f"({vis_n}/{self.visited_cap}) at depth {depth}; "
                    "raise visited_cap")
            last = (explored, vis_n, vis_over)
            self._last_dev_carry = carry
            if flag_counts.any():
                return self._dev_terminal(carry, flag_counts, explored,
                                          vis_n, depth, t0, vis_over)
            if f_drop:
                if cap < user_cap:
                    return None            # grow the buffer and restart
                return SearchOutcome(
                    "CAPACITY_EXHAUSTED", explored, vis_n, depth,
                    time.time() - t0, visited_overflow=vis_over)
            if nxt_n == 0:
                return SearchOutcome(
                    "SPACE_EXHAUSTED", explored, vis_n, depth,
                    time.time() - t0, visited_overflow=vis_over)
            n_chunks = -(-nxt_n // C)
