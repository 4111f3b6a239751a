"""Tensor-search engine in PyTorch: batched BFS over a frontier of flat
state rows, with the visited table and the frontier resident on the card.

The counterpart of ``dslabs_tpu/tpu/engine.py``.  One wave of the search
runs this cycle on the device:

  frontier chunk [C, lanes] --(enumerate events x batched transition)-->
  successors [C*B, lanes] --(128-bit fingerprint, kernels.py)-->
  visited-table probe/insert (visited.py) --> fresh rows appended to the
  next frontier (``index_copy_``)

The frontier buffers hold bit-packed rows (``tpu/packing.py``) when the
protocol declares lane domains: each chunk is unpacked where it is read
and the appended successors are packed, so handlers, predicates and
fingerprints always see the int32 rows.

The trace-recording loop (``run_host``) expands on the device the same
way, prefilters each chunk by an in-chunk sort-unique, and keeps the
visited set, the level-wide dedup and the per-level (parent, event)
record on the host, from which ``SearchOutcome.trace`` is rebuilt.

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
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dslabs_tpu_torch.tpu import kernels, packing as packing_mod
from dslabs_tpu_torch.tpu import visited as visited_mod
from dslabs_tpu_torch.tpu._build import resolve_device
# The plain fingerprint lives beside its kernel; re-exported here where the
# reference engine defines it.
from dslabs_tpu_torch.tpu.kernels import row_fingerprints

__all__ = ["TensorProtocol", "TensorState", "TensorSearch", "SearchOutcome",
           "CapacityOverflow", "SENTINEL", "row_fingerprints",
           "flatten_state", "host_keys", "resolve_device",
           "drop_pending_messages", "sorted_member"]

# Empty slots in the network / timer arrays hold SENTINEL in every lane, so
# they sort after every real record and hash consistently.
SENTINEL = 2 ** 31 - 1


def drop_pending_messages(state: dict) -> dict:
    """The staged-search ``dropPendingMessages`` analog: a copy of the
    state with an empty network (timers survive, so retry timers re-drive
    the protocol).  Takes tensors or numpy arrays."""
    return {**state, "net": torch.full_like(torch.as_tensor(state["net"]),
                                            SENTINEL)}


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

    Runtime delivery masks take the same leading batch dimension and the
    arrays installed by :meth:`TensorSearch.set_runtime_masks`, which are
    tensors on the search's device: ``deliver_message_rt(msg [..., MW],
    marr) -> bool [...]`` and ``deliver_timer_rt(node [...], tarr) ->
    bool [...]``.  Like the reference, they gate the event tables only.

    ``lane_domains`` (per-lane value domains, emitted by
    ``ProtocolSpec.compile()``) drive the bit-packed frontier rows
    (``tpu/packing.py``); None (hand twins) packs to the identity.
    ``symmetry`` (the compiled permutation tables) is carried as data,
    and a ``fault`` model makes :class:`TensorSearch` raise, until the
    symmetry and faults slice.  ``decode_message`` / ``decode_timer``
    are the optional object-twin decoders of trace reconstruction."""

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
    # runtime variants, fed the arrays of set_runtime_masks (see above)
    deliver_message_rt: Optional[Callable] = None
    deliver_timer_rt: Optional[Callable] = None
    # Max simultaneous valid send rows of one transition; sends are
    # compacted to this width before the set-insert merge.  Too small is a
    # CapacityOverflow, never a silent truncation.
    max_live_sends: Optional[int] = None
    decode_message: Optional[Callable] = None
    decode_timer: Optional[Callable] = None
    lane_domains: Optional[dict] = None
    symmetry: Optional[object] = None
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
    # Root-first grid event ids leading to the terminal state
    # (record_trace runs; decoded by tpu/trace.py).
    trace: Optional[list] = None
    # Root-first event-id lists of a few states of the deepest level that
    # kept rows (run_host with record_trace): the harness replays them on
    # the object twin to re-check value-level invariants before it
    # trusts an exhaust verdict.
    samples: Optional[list] = None
    # Keys whose probe exhausted (table effectively full), treated as
    # fresh.  Strict searches raise instead.
    visited_overflow: int = 0
    # Frontier bytes per stored state, packed and unpacked, and their
    # ratio (stamped by TensorSearch.run).
    bytes_per_state: Optional[int] = None
    bytes_per_state_unpacked: Optional[int] = None
    pack_ratio: Optional[float] = None


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


def sorted_member(vh1: np.ndarray, vh2: np.ndarray,
                  h1: np.ndarray, h2: np.ndarray) -> np.ndarray:
    """Membership of query keys (h1, h2) in a visited set sorted by
    (h1, h2).  Scans forward over the whole run of equal h1, so three or
    more keys sharing an h1 cannot cause re-exploration."""
    seen = np.zeros(len(h1), dtype=bool)
    if not len(vh1):
        return seen
    pos = np.searchsorted(vh1, h1, side="left")
    off = 0
    while True:
        q = pos + off
        inb = q < len(vh1)
        qc = np.where(inb, q, 0)
        eq1 = inb & (vh1[qc] == h1)
        if not eq1.any():
            return seen
        seen |= eq1 & (vh2[qc] == h2)
        off += 1


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


def _first_of_each_key(fp: torch.Tensor, valids: torch.Tensor
                       ) -> torch.Tensor:
    """The in-chunk sort-unique prefilter: True at the first (lowest-index)
    occurrence of each 128-bit key ``fp`` [N, 4] among the valid rows.
    Invalid rows sort last and are never unique.  The int32 lanes sort in
    signed order where the reference sorts uint32, which changes the order
    of the runs but not which rows share one; the sorts are stable, so a
    run starts at its lowest row index as in ``jnp.lexsort``."""
    inv = (~valids).to(torch.int32)
    order = _lex_order([inv, fp[:, 0], fp[:, 1], fp[:, 2], fp[:, 3]])
    fps = fp[order]
    first = torch.ones_like(valids)
    first[1:] = torch.any(fps[1:] != fps[:-1], dim=1)
    unique = torch.zeros_like(valids)
    unique[order] = first & valids[order]
    return unique


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

    Ports both loops of the reference: the device-resident wave loop
    (``_run_device``) and the trace-recording host-dedup loop
    (``run_host``, taken when ``record_trace`` or ``use_host_visited`` is
    set), with runtime delivery masks in both.  Options of the reference
    engine that the port does not have yet raise ``NotImplementedError``
    naming the slice that brings them: ``checkpoint_path`` /
    ``checkpoint_every`` / ``spill`` / ``run(resume=True)`` (spill and
    checkpoint), ``telemetry`` (supervisor and telemetry),
    ``symmetry=True`` or a protocol with a ``fault`` model (symmetry and
    faults).

    ``packed`` (default on) stores the device loop's frontier buffers at
    ``plane`` words per row, derived from the protocol's
    ``lane_domains``; a protocol without them (a hand twin) derives the
    identity and stores ``lanes`` words, as does ``packed=False``.  The
    host loop stores no frontier buffers and stays unpacked, as in the
    reference.  Deliberate differences: the reference's
    ``DSLABS_PACKED`` environment variable is not ported (only the
    argument decides), and the device loop packs only the successor rows
    it appends, where the reference packs every successor row and then
    selects; the out-of-domain count is the same, since the reference
    masks it by the selection too."""

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
        if checkpoint_path is not None or checkpoint_every:
            raise _later("checkpoint_path / checkpoint_every",
                         "spill + checkpoint")
        if spill:
            raise _later("spill", "spill + checkpoint")
        if telemetry is not None:
            raise _later("telemetry", "supervisor + telemetry")
        if symmetry:
            raise _later("symmetry=True", "symmetry + faults")
        if protocol.fault is not None:
            raise _later("fault models", "symmetry + faults")
        self.p = protocol
        self.device = resolve_device(device)
        self.frontier_cap = frontier_cap
        self.chunk = chunk
        self.max_depth = max_depth
        self.max_secs = max_secs
        self.record_trace = record_trace
        visited_mod.check_cap(visited_cap)
        self.visited_cap = visited_cap
        self.strict = strict
        # use_host_visited forces the host loop (run_host) without traces.
        self.use_host_visited = use_host_visited
        # When False, _expand_chunk marks every valid successor unique and
        # the caller dedups everything (the level-wide host dedup does).
        self._in_chunk_dedup = in_chunk_dedup
        # Per-run delivery masks (set_runtime_masks): None = not applied.
        self._rt_masks = None
        # Per-level (parent rows, event ids) record of run_host with
        # record_trace, read by _reconstruct.
        self._levels: List[dict] = []
        # Chunk steps the device loop has run, over every run of this
        # search (restarts included).
        self.chunk_steps = 0
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
        # Bit-packed frontier rows: identity (no packing) for a protocol
        # without declared lane domains.
        pk = (packing_mod.derive_packing(protocol, self.lanes)
              if packed is None or packed else None)
        self._pk = None if (pk is None or pk.identity) else pk
        self.plane = self._pk.words if self._pk is not None else self.lanes
        # Terminal-flag order = checkState order: exception strictly
        # first, then invariants, then goals.
        self._flag_names = (["exc"]
                            + [f"inv:{n}" for n in protocol.invariants]
                            + [f"goal:{n}" for n in protocol.goals])

    def set_runtime_masks(self, marr, tarr) -> None:
        """Install per-run delivery masks: ``marr`` / ``tarr`` (arrays or
        tensors) are moved to the search's device and handed to the
        protocol's ``deliver_message_rt`` / ``deliver_timer_rt`` by both
        loops, so staged phases with different masks share one protocol."""
        self._rt_masks = (torch.as_tensor(marr, device=self.device),
                          torch.as_tensor(tarr, device=self.device))

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

    def _slice_state(self, row) -> dict:
        """[lanes] row -> ONE unbatched state dict (views)."""
        return {k: v[0] for k, v in self.unflatten_rows(row[None]).items()}

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

    def _step_one(self, row: torch.Tensor, event_idx):
        """Expand ONE state row [lanes] by ONE grid event id (message slot
        ``< net_cap``, else ``net_cap`` + timer grid index) -> (successor
        row [lanes], valid, over): the batched handler halves and merge
        tail at P = 1.  Trace replay (tpu/trace.py) steps with it."""
        p = self.p
        ev = int(event_idx)
        tgrid = p.n_nodes * p.timer_cap
        if not 0 <= ev < p.net_cap + tgrid:
            raise ValueError(f"{p.name}: event id {ev} outside the "
                             f"message + timer grid ({p.net_cap + tgrid})")
        cs = self.unflatten_rows(row[None])
        par = torch.zeros((1,), dtype=torch.int64, device=row.device)
        if ev < p.net_cap:
            raw = self._msg_step_raw(cs, par, par + ev)
        else:
            raw = self._tmr_step_raw(cs, par, par + (ev - p.net_cap))
        rows, over = self._batched_tail(cs, par, *raw)
        return rows[0], raw[4][0], over[0]

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
                      chunk_valid: torch.Tensor, ev_pass: int = 0,
                      masks=None):
        """[C, lanes] chunk -> (msg_ids [C, Bm] net-slot indices, tmr_ids
        [C, Bt] timer grid indices, ev_remaining): each state's valid
        events (occupied network rows + deliverable timers, masked by the
        protocol's deliver_* settings and, when ``masks`` = (marr, tarr)
        is given, its deliver_*_rt masks) packed into per-kind pair
        slots."""
        p = self.p
        c = chunk_valid.shape[0]
        cs = self.unflatten_rows(chunk_rows)
        msg_ok = cs["net"][:, :, 0] != SENTINEL             # [C, net_cap]
        if p.deliver_message is not None:
            msg_ok = msg_ok & p.deliver_message(
                cs["net"].reshape(-1, p.msg_width)).reshape(c, p.net_cap)
        if p.deliver_message_rt is not None and masks is not None:
            msg_ok = msg_ok & p.deliver_message_rt(
                cs["net"].reshape(-1, p.msg_width),
                masks[0]).reshape(c, p.net_cap)
        tmask = timer_deliverable_mask(cs["timers"])         # [C, NN, T]
        if p.deliver_timer is not None:
            dt = p.deliver_timer(torch.arange(p.n_nodes,
                                              device=chunk_rows.device))
            tmask = tmask & dt[None, :, None]
        if p.deliver_timer_rt is not None and masks is not None:
            dt = p.deliver_timer_rt(torch.arange(
                p.n_nodes, device=chunk_rows.device), masks[1])
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
                      masks=None, dedup: Optional[bool] = None):
        """[C, lanes] chunk rows -> (rows [C*B, lanes], valids [C*B],
        fp [C*B, 4] int32 keys, unique [C*B], overflow scalar,
        ev_remaining scalar, event_ids [C, B], flags dict), all on the
        chunk's device with no host sync.  B = Bm + Bt, message slots
        first per state (successor row = chunk_row * B + slot).

        ``masks`` are the runtime delivery masks (see
        :meth:`set_runtime_masks`).  ``dedup`` (default: the
        constructor's ``in_chunk_dedup``) marks only the first occurrence
        of each key among the valid rows unique; without it every valid
        row is."""
        p = self.p
        c = chunk_valid.shape[0]
        bm, bt = self._ev_msg, self._ev_tmr
        msg_ids, tmr_ids, ev_rem = self._event_tables(
            chunk_rows, chunk_valid, ev_pass, masks)
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
        if self._in_chunk_dedup if dedup is None else dedup:
            unique = _first_of_each_key(fp, valids)
        else:
            # The caller dedups every valid successor (the device table
            # resolves in-batch duplicates itself).
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
        initial state.

        Dispatch: the device-resident wave loop (:meth:`_run_device`)
        unless ``record_trace`` or ``use_host_visited`` ask for the host
        loop (:meth:`run_host`)."""
        if resume:
            raise _later("resume (checkpoints)", "spill + checkpoint")
        if self.record_trace or self.use_host_visited:
            out = self.run_host(check_initial, initial)
        else:
            out = self._run_device(check_initial, initial)
        return self._stamp_capacity(out)

    def _stamp_capacity(self, out: SearchOutcome) -> SearchOutcome:
        """Attach the frontier bytes per state that every verdict
        carries."""
        out.bytes_per_state = (self._pk.bytes_per_state
                               if self._pk is not None else self.lanes * 4)
        out.bytes_per_state_unpacked = self.lanes * 4
        out.pack_ratio = round(
            out.bytes_per_state_unpacked / max(out.bytes_per_state, 1), 3)
        return out

    def _initial_or(self, initial: Optional[dict]) -> dict:
        """The batch-1 start state on the search's device: ``initial``
        (tensors or arrays) or the protocol's initial state."""
        if initial is None:
            return self.initial_state()
        return {k: torch.as_tensor(v).to(device=self.device,
                                          dtype=torch.int32)
                for k, v in initial.items()}

    # ------------------------------------------------------------ host loop

    def _terminal_outcome(self, rows: torch.Tensor, np_valids: np.ndarray,
                          np_exc: np.ndarray, flags: dict, explored: int,
                          visited_n: int, depth: int, t0: float,
                          level_base_row: int = 0
                          ) -> Optional[SearchOutcome]:
        """checkState order over one chunk's successors: exception, then
        invariants, then goals.  Returns a SearchOutcome (with the trace
        when recording) or None."""

        def found(idx, end, **kw):
            return SearchOutcome(
                end, explored, visited_n, depth, time.time() - t0,
                trace=self._reconstruct(level_base_row + idx), **kw)

        def state(idx):
            return self._host_state(rows[idx:idx + 1].cpu().numpy())

        exc_hit = np_valids & (np_exc != 0)
        if exc_hit.any():
            idx = int(np.nonzero(exc_hit)[0][0])
            return found(idx, "EXCEPTION_THROWN", violating_state=state(idx),
                         exception_code=int(np_exc[idx]))
        for kind in ("inv", "goal"):
            for name, f in flags.items():
                if not name.startswith(kind + ":"):
                    continue
                fa = f.cpu().numpy()
                pname = name.split(":", 1)[1]
                if kind == "inv" and not fa[np_valids].all():
                    idx = int(np.nonzero(np_valids & ~fa)[0][0])
                    return found(idx, "INVARIANT_VIOLATED",
                                 violating_state=state(idx),
                                 predicate_name=pname)
                if kind == "goal" and fa[np_valids].any():
                    idx = int(np.nonzero(np_valids & fa)[0][0])
                    return found(idx, "GOAL_FOUND", goal_state=state(idx),
                                 predicate_name=pname)
        return None

    def _reconstruct(self, row: int) -> Optional[list]:
        """Walk the per-level (parent, event) record back from a successor
        row of the current level to the root -> [grid event ids], root
        first."""
        if not self.record_trace or not self._levels:
            return None
        ne = self._num_events()
        events = []
        for lvl in reversed(self._levels):
            parent_chunk_row = row // ne
            if isinstance(lvl["event_ids"], list):
                lvl["event_ids"] = np.concatenate(lvl["event_ids"], axis=0)
            # The pair slot is a compacted rank; the level's event table
            # maps it back to the grid event id.
            events.append(int(lvl["event_ids"][parent_chunk_row, row % ne]))
            # Back through the previous level's kept-state compaction.
            row = int(lvl["parent_rows"][parent_chunk_row])
        events.reverse()
        return events

    def _samples(self, parent_rows: np.ndarray) -> list:
        """Root-first traces of the first, middle and last state kept at
        the level just completed (``parent_rows`` indexes its successor
        rows), as the reference's sharded engine samples each level."""
        n = len(parent_rows)
        return [self._reconstruct(int(parent_rows[i]))
                for i in sorted({0, n // 2, n - 1})]

    def run_host(self, check_initial: bool = True,
                 initial: Optional[dict] = None) -> SearchOutcome:
        """The host-dedup BFS: device expand with the in-chunk sort-unique
        prefilter, then one level-wide dedup against a sorted host visited
        set (``sorted_member``).  The trace-recording path: per-level
        (parent row, event id) records stay on the host, and exhaust
        outcomes carry ``samples`` (see :meth:`_samples`).  Same contract
        as :meth:`run`.

        One deliberate difference from the reference, which copies every
        successor row of a chunk to the host and then indexes it: here
        the rows the prefilter keeps are gathered on the device and only
        they are copied (the same rows, a fraction of the bytes)."""
        t0 = time.time()
        dev = self.device
        state = self._initial_or(initial)
        # The root this run's trace event ids are relative to (a staged
        # search starts from an arbitrary state; tpu/trace.py replays
        # from here).
        self._trace_root = {k: v.cpu().numpy() for k, v in state.items()}
        self._levels = []
        frontier = flatten_state(state)                  # [1, lanes] rows
        visited = host_keys(kernels.fingerprint_rows(frontier).cpu().numpy())
        # The exact visited set, sorted by (h1, h2); tests compare it.
        self._host_visited = visited
        explored = 0
        depth = 0
        if check_initial:
            out = self._check_initial(state, t0)
            if out is not None:
                return out
        # parent_rows[i] = the successor row (in the previous level's
        # enumeration) that produced frontier state i; -1 at the root.
        parent_rows = np.array([-1], dtype=np.int64)
        frontier_n = 1
        samples = None

        def exhausted(end):
            return SearchOutcome(end, explored, len(visited[0]), depth,
                                 time.time() - t0, samples=samples)

        ne = self._num_events()
        C = self.chunk
        # Every level either returns or leaves a non-empty frontier.
        while True:
            if self.max_depth is not None and depth >= self.max_depth:
                return exhausted("DEPTH_EXHAUSTED")
            if (self.max_secs is not None
                    and time.time() - t0 > self.max_secs):
                return exhausted("TIME_EXHAUSTED")
            depth += 1
            if self.record_trace:
                self._levels.append({"parent_rows": parent_rows,
                                     "event_ids": []})
            # ---- expand every chunk (device), gather the kept rows
            lvl_states: List[np.ndarray] = []
            lvl_keys: List[Tuple[np.ndarray, np.ndarray]] = []
            lvl_pruned: List[np.ndarray] = []
            lvl_rows: List[np.ndarray] = []
            for start in range(0, frontier_n, C):
                c = min(start + C, frontier_n) - start
                pad = C - c
                chunk_rows = frontier[start:start + c]
                if pad:
                    chunk_rows = torch.cat(
                        [chunk_rows, frontier[:1].expand(pad, -1)])
                chunk_valid = torch.arange(C, device=dev) < c
                (rows, valids, fp, unique, overflow, ev_rem, event_ids,
                 flags) = self._expand_chunk(chunk_rows, chunk_valid, 0,
                                             self._rt_masks)
                n_over, n_rem = (int(x) for x in
                                 torch.stack([overflow, ev_rem]).cpu())
                if n_over:
                    raise CapacityOverflow(
                        f"{self.p.name}: net_cap={self.p.net_cap}, "
                        f"timer_cap={self.p.timer_cap}, or max_live_sends="
                        f"{self.p.max_live_sends} overflowed at depth "
                        f"{depth} ({n_over} drops); raise the caps")
                if n_rem:
                    raise CapacityOverflow(
                        f"{self.p.name}: ev_budget={self._ev_slots} < "
                        f"valid events of some state at depth {depth} "
                        f"({n_rem} skipped); raise the budget")
                if self.record_trace:
                    self._levels[-1]["event_ids"].append(
                        event_ids.cpu().numpy())
                np_valids = valids.cpu().numpy()
                explored += int(np_valids.sum())
                out = self._terminal_outcome(
                    rows, np_valids, rows[:, -1].cpu().numpy(), flags,
                    explored, len(visited[0]), depth, t0,
                    level_base_row=start * ne)
                if out is not None:
                    return out
                pruned = torch.zeros_like(valids)
                for name, f in flags.items():
                    if name.startswith("prune:"):
                        pruned = pruned | f
                idx_dev = torch.nonzero(unique).squeeze(1)
                if idx_dev.numel():
                    h1, h2 = host_keys(fp[idx_dev].cpu().numpy())
                    lvl_keys.append((h1, h2))
                    lvl_pruned.append(pruned[idx_dev].cpu().numpy())
                    lvl_rows.append(idx_dev.cpu().numpy() + start * ne)
                    lvl_states.append(rows[idx_dev].cpu().numpy())
            if not lvl_keys:
                return exhausted("SPACE_EXHAUSTED")

            # ---- one level-wide dedup (sort-unique + visited membership)
            h1 = np.concatenate([k[0] for k in lvl_keys])
            h2 = np.concatenate([k[1] for k in lvl_keys])
            pruned = np.concatenate(lvl_pruned)
            rows_np = np.concatenate(lvl_rows)
            order = np.lexsort((h2, h1))
            h1s, h2s = h1[order], h2[order]
            first = np.ones(len(order), dtype=bool)
            first[1:] = (h1s[1:] != h1s[:-1]) | (h2s[1:] != h2s[:-1])
            unique_mask = np.zeros(len(order), dtype=bool)
            unique_mask[order] = first
            fresh = unique_mask & ~sorted_member(visited[0], visited[1],
                                                 h1, h2)
            # ---- merge visited (stays sorted by (h1, h2))
            if fresh.any():
                nk = np.nonzero(fresh)[0]
                no = np.lexsort((h2[nk], h1[nk]))
                mh1 = np.concatenate([visited[0], h1[nk][no]])
                mh2 = np.concatenate([visited[1], h2[nk][no]])
                mo = np.lexsort((mh2, mh1))
                visited = (mh1[mo], mh2[mo])
                self._host_visited = visited
            expand = fresh & ~pruned
            if not expand.any():
                return exhausted("SPACE_EXHAUSTED")
            keep_idx = np.nonzero(expand)[0]
            parent_rows = rows_np[keep_idx]
            frontier_n = len(keep_idx)
            if self.record_trace:
                samples = self._samples(parent_rows)
            if frontier_n > self.frontier_cap:
                return exhausted("CAPACITY_EXHAUSTED")
            # The next frontier: each chunk's selected rows, in order
            # (keep_idx is ascending over the chunks' concatenation).
            ends = np.cumsum([len(s) for s in lvl_states])
            parts = np.split(keep_idx, np.searchsorted(keep_idx, ends[:-1]))
            frontier = torch.cat([
                torch.from_numpy(s[k - (e - len(s))]).to(dev)
                for s, k, e in zip(lvl_states, parts, ends) if len(k)])

    def _build_dev_step(self, cap: int):
        """One wave step over frontier chunk ``j``: expand -> visited-table
        insert -> frontier-compact append, all on the device.  The carry
        is updated IN PLACE where the reference donates it to a jitted
        program: kernel 2 writes the table, ``index_copy_`` writes the
        next frontier, and the counters are added to.  With packing, the
        frontier buffers hold packed rows (``plane`` words): the chunk is
        unpacked here and the selected successors are packed before the
        append, which takes the step's one host sync (their count);
        unpacked, the step has none."""
        p = self.p
        C = self.chunk
        dev = self.device
        pk = self._pk

        def step(carry, j: int, ev_pass: int):
            self.chunk_steps += 1
            start = j * C
            rows_chunk = carry["cur"][start:start + C]
            if pk is not None:
                rows_chunk = pk.unpack(rows_chunk)
            valid = (start + torch.arange(C, device=dev)) < carry["cur_n"]
            (rows, valids, fp, unique, overflow, ev_rem, _event_ids,
             flags) = self._expand_chunk(rows_chunk, valid, ev_pass,
                                         self._rt_masks, dedup=False)
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
            if pk is None:
                carry["nxt"].index_copy_(0, sdst, rows)
            else:
                # Only the selected rows are packed and appended: one
                # host sync per chunk step for their count, in place of
                # packing every successor row as the reference does.  A
                # live value outside its declared domain counts into the
                # overflow: a wrong spec bound is a CapacityOverflow,
                # never a corrupted stored state.
                idx = torch.nonzero(sel).squeeze(1)
                packed, pack_bad = pk.pack(rows.index_select(0, idx),
                                           count_bad=True)
                overflow = overflow + pack_bad.sum()
                carry["nxt"].index_copy_(0, sdst.index_select(0, idx),
                                         packed)
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
        the host (unpacked; it is packed here for storage); the root key
        goes through the same table insert as the waves."""
        lanes = self.lanes
        plane = self.plane
        V = self.visited_cap
        nf = len(self._flag_names)
        dev = self.device

        def build(row0):
            fp0 = kernels.fingerprint_rows(row0)              # [1, 4]
            table = visited_mod.empty_table(V, dev)
            visited_mod.insert(table, fp0,
                               torch.ones((1,), dtype=torch.bool,
                                          device=dev))
            cur = torch.zeros((cap + 1, plane), dtype=torch.int32, device=dev)
            cur[0] = (row0 if self._pk is None else self._pk.pack(row0))[0]

            def z():
                return torch.zeros((1,), dtype=torch.int64, device=dev)

            return {
                "cur": cur, "cur_n": z() + 1,
                "nxt": torch.zeros((cap + 1, plane), dtype=torch.int32,
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
        state = self._initial_or(initial)
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
