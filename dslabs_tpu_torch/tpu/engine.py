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

from dslabs_tpu_torch.tpu import checkpoint as ckpt_mod
from dslabs_tpu_torch.tpu import kernels, packing as packing_mod
from dslabs_tpu_torch.tpu import spill as spill_mod
from dslabs_tpu_torch.tpu import visited as visited_mod
from dslabs_tpu_torch.tpu._build import resolve_device
from dslabs_tpu_torch.tpu.telemetry import skew_metrics
# The plain fingerprint lives beside its kernel; re-exported here where the
# reference engine defines it.
from dslabs_tpu_torch.tpu.kernels import row_fingerprints

__all__ = ["TensorProtocol", "TensorState", "TensorSearch", "SearchOutcome",
           "CapacityOverflow", "SENTINEL", "row_fingerprints",
           "flatten_state", "host_keys", "resolve_device",
           "drop_pending_messages", "sorted_member", "host_copy"]

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
    ``symmetry`` (a ``tpu/symmetry.py`` SymmetrySpec) is the permutation
    table set that ``TensorSearch(symmetry=True)`` canonicalizes with;
    ``fault`` (a ``tpu/faults.py`` FaultLanes) adds the fault event
    segment and deliverability masks.  ``decode_message`` /
    ``decode_timer`` are the optional object-twin decoders of trace
    reconstruction."""

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
    # Seconds of warm-up (kernel build, first round) kept out of
    # elapsed_secs and the wall budget.
    compile_secs: float = 0.0
    # Swarm accounting (tpu/swarm.py): walker restarts of every cause,
    # the capacity-truncated steps among them, the fleet's statistics, and
    # the minimized, replay-verified witness of a swarm verdict.
    walker_restarts: int = 0
    swarm_overflow: int = 0
    swarm: Optional[dict] = None
    witness: Optional[object] = None
    # The symmetry pass's permutation count (0 = reduction off; with it
    # on, unique_states counts canonical orbits, at most the raw count).
    symmetry_perms: int = 0
    # Valid fault events explored (counted over successor states, like
    # states_explored), by family and in total; all zero when the
    # protocol declares no fault model (tpu/faults.py).
    fault_events: int = 0
    partition_events: int = 0
    crash_events: int = 0
    drop_events: int = 0
    dup_events: int = 0
    # Beam-truncation drops (strict=False); the port's engines are exact
    # and leave it 0, the spill tier included.
    dropped: int = 0
    # The checkpoint depth (swarm: round) a run resumed from, 0 = root.
    resumed_from_depth: int = 0
    # Host-RAM spill tier (tpu/spill.py): keys evicted from the device
    # table to the host tier, re-discoveries the refilter removed, rows
    # that took the host spool, and the drain's host ms (inside drain
    # jobs / blocked waiting for them).  All zero when the tier never
    # engaged.
    spilled_keys: int = 0
    host_tier_hits: int = 0
    respilled_frontier: int = 0
    spill_drain_ms: int = 0
    spill_wait_ms: int = 0
    # Recovery accounting (tpu/supervisor.py, tpu/warden.py): transient
    # dispatches retried in place, ladder rungs abandoned before this
    # one, the rung that produced the verdict, warden children spawned
    # past the first, dispatches SIGKILLed mid-flight, watchdog-abandoned
    # threads still blocked, in-place knob-shrink re-levels, the mesh
    # width of the rung (1 on one device) and its halvings.  Zero / None
    # outside the supervisor.
    retries: int = 0
    failovers: int = 0
    engine: Optional[str] = None
    child_restarts: int = 0
    killed_dispatches: int = 0
    abandoned_threads: int = 0
    knob_retries: int = 0
    mesh_width: Optional[int] = None
    mesh_shrinks: int = 0
    # Portfolio cancellation: the run stopped at a level boundary because
    # the other lane landed a terminal verdict first (TIME_EXHAUSTED
    # shaped; never a standalone verdict).
    cancelled: bool = False
    # The device type the verdict's search ran on ("cuda" or "cpu"): a
    # warden child forced off the card shows "cpu" here.  None outside
    # the supervisor.
    platform: Optional[str] = None
    # The causal trace this verdict belongs to (tpu/tracing.py), stamped
    # from the attached telemetry recorder.  None outside any trace.
    trace_id: Optional[str] = None
    # Batched job lanes (tpu/lanes.py): the lane this verdict ran in, the
    # batch width, and this lane's share of the batch's shared device
    # seconds (the shares of a batch sum to 1, so the cost meter bills a
    # shared dispatch once).  None outside a lane batch.
    lane: Optional[int] = None
    lane_width: Optional[int] = None
    lane_share: Optional[float] = None

    @property
    def dropped_states(self) -> int:
        """``dropped`` under its roadmap name."""
        return self.dropped


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


def _lex_order_batched(cols) -> torch.Tensor:
    """Per-row stable lexicographic order of the [N, R] keys ``cols``
    (primary key first) along dim 1: :func:`_lex_order` for a batch."""
    order = torch.arange(cols[0].shape[1], device=cols[0].device).expand(
        cols[0].shape).contiguous()
    for key in reversed(cols):
        idx = torch.sort(key.gather(1, order), dim=1, stable=True).indices
        order = order.gather(1, idx)
    return order


def canonicalize_net_batched(net: torch.Tensor) -> torch.Tensor:
    """Sort each message set of ``net`` [N, CAP, MW] into canonical
    (raw-lane lexicographic) order and collapse duplicates; empty rows are
    all-SENTINEL and sort last.  ``jax.vmap`` of the reference's
    ``canonicalize_net``: the symmetry pass re-sorts relabelled networks
    with it."""
    n, cap, mw = net.shape
    empty = net[:, :, 0] == SENTINEL
    order = _lex_order_batched([empty.to(torch.int32)]
                               + [net[:, :, lane] for lane in range(mw)])
    net_s = net.gather(1, order[:, :, None].expand(n, cap, mw))
    empty_s = empty.gather(1, order)
    dup = torch.zeros((n, cap), dtype=torch.bool, device=net.device)
    dup[:, 1:] = (torch.all(net_s[:, 1:] == net_s[:, :-1], dim=2)
                  & ~empty_s[:, 1:])
    keep = ~dup & ~empty_s
    pos = torch.cumsum(keep.to(torch.int64), 1) - 1
    out = torch.full((n, cap + 1, mw), SENTINEL, dtype=net.dtype,
                     device=net.device)
    out.scatter_(1, torch.where(keep, pos, cap)[:, :, None].expand(
        n, cap, mw), net_s)
    return out[:, :cap]


def canonicalize_net(net: torch.Tensor) -> torch.Tensor:
    """One message set [CAP, MW]: see :func:`canonicalize_net_batched`."""
    return canonicalize_net_batched(net[None])[0]


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


def host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` that shares no memory with it (``.cpu()`` of
    a CPU tensor is the tensor itself): what a background writer or the
    spill drain worker reads while the carry changes under it."""
    return t.to("cpu", copy=True).numpy()


def read_only(fn):
    """Mark a dispatch function that writes no state outliving the call
    (a readback, or an expand that returns new tensors): the supervisor's
    boundary may rerun it after it raised partway.  Unmarked functions
    (a chunk step, a promote, an init) write the carry in place, and a
    failure raised inside one is answered from the last checkpoint."""
    fn.read_only = True
    return fn


@read_only
def to_host(t: torch.Tensor) -> np.ndarray:
    """A blocking readback, as the ``device.sync`` / ``device.flags``
    dispatch sites run it."""
    return t.cpu().numpy()


@read_only
def _fetch_occupied(table: torch.Tensor) -> np.ndarray:
    """The spill eviction's fetch: the table's occupied lines, on the
    host."""
    return visited_mod.host_occupied(table)


def _reset_nxt(carry: dict) -> None:
    """The spill drain's reset: nxt restarts empty, the abort code
    clears."""
    carry["nxt_n"].zero_()
    carry["f_drop"].zero_()


def _reset_table(carry: dict) -> None:
    """The spill eviction's reset: the table and ``vis_n`` restart empty
    (a fresh epoch), the abort code clears."""
    carry["visited"].fill_(visited_mod.EMPTY)
    carry["vis_n"].zero_()
    carry["f_drop"].zero_()


def _pick(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[..., idx]`` where ``0 <= idx < NN`` and 0 elsewhere: the
    reference's one-hot select ``sum((idx == arange(NN)) * table)``.
    ``table`` is [NN] (shared) or [C, NN] (per row of ``idx`` [C, ...])."""
    nn = table.shape[-1]
    ic = idx.clamp(0, nn - 1).to(torch.int64)
    if table.dim() == 1:
        got = table[ic]
    else:
        got = table.gather(1, ic.reshape(ic.shape[0], -1)).reshape(ic.shape)
    return torch.where((idx >= 0) & (idx < nn), got, 0)


# ------------------------------------------------------------------- engine

# Load factor (of the strict 75% limit) past which the visited-table
# early warning fires, as in the reference.
VISITED_WARN = 0.85


# ``sanitize=`` values: off, the hot-path audit at the first run, and the
# audit with its retrace check.
SANITIZE_MODES = (None, "on", "full")


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
    set), with runtime delivery masks in both.

    ``telemetry`` (a ``tpu/telemetry.py`` recorder, or attach one with
    ``Telemetry.attach``): every ``_dispatch`` becomes a flight-recorder
    span, and each loop hands the recorder one level record per level
    (depth, wall, explored, unique, next frontier, table load, one-lane
    per-device block and skew; the fault block with a fault model, the
    drain wall split in spill mode) and the verdict, all built from the
    scalars the loop has read already: no added dispatch, sync or
    readback.  A verdict carries the recorder's ``trace_id``.

    The dispatch seam (:meth:`_dispatch`): every device dispatch and
    blocking readback of both loops goes through one boundary, a plain
    call until the search supervisor (``tpu/supervisor.py``) installs
    its retry / watchdog / fault-injection hook.  Tags, as in the
    reference: ``device.init`` (from the root, or the table rebuilt from
    a dump), ``device.step``, ``device.sync`` (the stats readback),
    ``device.promote``, ``device.flags`` (the terminal flag rows),
    ``host.expand`` (``run_host``), and in spill mode
    ``device.spill_drain``, ``device.spill_evict`` (each a read-only
    fetch, then the reset) and ``device.spill_reinject``.  The carry is
    updated in place, so a dispatch function that writes state outliving
    the call cannot be rerun after it raised halfway: functions that
    write nothing carry the :func:`read_only` mark, which the boundary
    reads before it retries a failure raised inside one.  Each loop
    publishes ``_current_depth`` as a level starts and checks
    :meth:`_cancelled` at every level boundary (portfolio mode).

    Checkpoints (``tpu/checkpoint.py``): with ``checkpoint_path`` and
    ``checkpoint_every`` = k, every k-th level boundary writes the
    unified dump (the device loop through a skip-if-busy background
    writer, ``run_host`` synchronously), and ``run(resume=True)``
    continues from it with the straight run's counts; without a dump it
    starts from the root.  Dumps are shared with the reference: the same
    fingerprint string, the same arrays, packed frontier rows under the
    same ``frontier_encoding`` marker.

    ``spill`` (True or a ``tpu/spill.py`` SpillConfig; default off)
    turns a full visited table or frontier buffer into host-RAM spill:
    the device loop runs :meth:`_device_attempt_spill`, which evicts the
    table to an exact host tier at the high-water mark and drains
    overflowing frontier rows to a host spool, with the reference's
    abort points, so every count, ``spilled_keys``, ``host_tier_hits``
    and ``respilled_frontier`` included, equals the reference's.  The
    port's spill deliberately has no environment default
    (``DSLABS_SPILL``).

    ``symmetry=True`` (default off) hashes each state's canonical orbit
    representative under the protocol's symmetry groups
    (``tpu/symmetry.py``) at every fingerprint site, so ``unique_states``
    counts orbits; stored rows stay the real states.  A protocol with a
    ``fault`` model (``tpu/faults.py``) gets a third, never-windowed event
    segment after the message and timer ones, its deliverability masks,
    and per-family fault-event counts on the outcome.  Deliberate
    differences: the reference's ``DSLABS_SYMMETRY`` environment default
    is not ported (only the argument decides), and the fault steps run
    batched over pairs where the reference vmaps a one-row step.

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
    masks it by the selection too.

    ``sanitize`` ("on" or "full"; default None, off) runs the hot-path
    audit (``analysis/hotpath_audit.py``) over :meth:`dispatch_site_programs`
    once, when the first :meth:`run` starts (the engine, a subclass's
    included, is built by then): each site once on a throwaway carry, its
    host syncs against its budget, its dtypes, its in-place writes and,
    with "full", its rebuild.  Findings become ``sanitizer_finding``
    events on an attached recorder and one ``RuntimeWarning``; the audit
    never raises.  It replaces the reference's ``DSLABS_SANITIZE``
    environment variable; off, nothing of the audit is imported."""

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
                 device=None,
                 sanitize: Optional[str] = None):
        if sanitize not in SANITIZE_MODES:
            raise ValueError(f"sanitize must be one of {SANITIZE_MODES}, "
                             f"got {sanitize!r}")
        self._sanitize = sanitize
        # The telemetry recorder (None = no spans, no level records), and
        # the explored count of spill mode's last level record (kept over
        # runs, as the reference keeps it).
        self._telemetry = telemetry
        self._spill_prev_explored = 0
        if isinstance(spill, spill_mod.SpillConfig):
            self._spill = spill_mod.SpillManager(spill)
        elif spill:
            self._spill = spill_mod.SpillManager()
        else:
            self._spill = None
        if self._spill is not None and record_trace:
            raise ValueError(
                "spill + record_trace is unsupported (trace spills are "
                "host-side already; run the trace pass uncapped)")
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self._resumed_from_depth = 0
        # The dispatch seam's state: the supervisor's hook (None = plain
        # calls), the portfolio lane's cancel event, and the depth of the
        # level being expanded (read by heartbeats).
        self._dispatch_hook = None
        self._cancel_event = None
        self._current_depth = 0
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
        # The fault segment is always the full fault grid, never windowed:
        # a window pass past the first sees an empty fault table
        # (_compact_ids with an offset).
        self._ev_flt = (protocol.fault.n_events
                        if protocol.fault is not None else 0)
        self._ev_slots = self._ev_msg + self._ev_tmr + self._ev_flt
        p = protocol
        self._off = (p.node_width,
                     p.node_width + p.net_cap * p.msg_width,
                     p.node_width + p.net_cap * p.msg_width
                     + p.n_nodes * p.timer_cap * p.timer_width)
        self.lanes = self._off[2] + 1
        if symmetry:
            if protocol.symmetry is None:
                raise ValueError(
                    f"{protocol.name}: symmetry=True but the protocol "
                    "declares no symmetry groups (ProtocolSpec("
                    "symmetry=...))")
            from dslabs_tpu_torch.tpu.symmetry import build_canonicalizer

            self._canon = build_canonicalizer(protocol, self._off)
        else:
            self._canon = None
        # Valid fault events of the current run by family: partition,
        # crash + restart, drop, dup (zeros without a fault model).
        self._fault_counts = np.zeros((4,), np.int64)
        # Device tensors of the fault tables, built on first use.
        self._flt_t = None
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

    def _maybe_sanitize(self) -> None:
        """The hot-path audit of ``sanitize="on"`` or ``"full"`` (which
        adds the retrace check), once per engine, first thing in
        :meth:`run` (and ``SwarmSearch.run``): findings become
        ``sanitizer_finding`` events on an attached recorder and one
        warning.  Off (None) is off: no import, no dispatch, no sync."""
        if self._sanitize is None:
            return
        deep = self._sanitize == "full"
        self._sanitize = None              # audited: later runs skip it
        from dslabs_tpu_torch.analysis.hotpath_audit import sanitize_engine

        sanitize_engine(self, deep=deep)

    def dispatch_site_programs(self) -> Dict[str, object]:
        """Every function this engine dispatches through :meth:`_dispatch`,
        keyed by its tag (``tpu/telemetry.py DISPATCH_SITES``), for the
        hot-path audit (``analysis/hotpath_audit.py``).  An entry is
        ``dict(fn, args, builder)``; the site's contract (``in_place``,
        ``multi``, ``syncs``) is its registry entry's, and an entry sets
        one only where it must: ``device.step``'s ``syncs``, the budget in
        this engine's configuration (packed, spill), and the resets'.  A
        tag the loop dispatches with two functions (the spill drain's and
        the eviction's fetch, then reset) lists both, each with its
        ``name``.  ``args`` are real tensors on the engine's device around
        a throwaway carry built from the root row at the engine's caps
        (the audit runs the sites, and must never touch a carry a search
        holds); ``builder`` rebuilds the function for the retrace check.
        Audit-only tags: ``visited.insert`` (kernel 2 over one chunk
        step's keys), and with packing ``packing.pack`` /
        ``packing.unpack``, with ``symmetry=True``
        ``symmetry.canonicalize``."""
        C = self.chunk
        dev = self.device
        cap = -(-self.frontier_cap // C) * C       # run()'s user_cap
        row0 = flatten_state(self.initial_state())
        carry = self._build_dev_init(cap)(row0)
        rows = row0.expand(C, -1).contiguous()
        valid = torch.arange(C, device=dev) < 1
        n_stats = 7 + len(self._flag_names) + (4 if self._ev_flt else 0)
        n_keys = C * self._num_events()
        keys = (torch.arange(4 * n_keys, dtype=torch.int64, device=dev)
                * 2654435761 % (1 << 31)).to(torch.int32).reshape(-1, 4)
        sites: Dict[str, object] = {
            "device.init": dict(
                fn=self._build_dev_init(cap), args=(row0,),
                builder=lambda: self._build_dev_init(cap)),
            "device.step": dict(
                fn=self._build_dev_step(cap), args=(carry, 0, 0),
                syncs=int(self._pk is not None)
                + int(self._spill is not None),
                builder=lambda: self._build_dev_step(cap)),
            "device.sync": dict(
                fn=to_host,
                args=(torch.zeros((n_stats,), dtype=torch.int64,
                                  device=dev),)),
            "device.promote": dict(
                fn=self._build_dev_promote(cap), args=(carry,),
                builder=lambda: self._build_dev_promote(cap)),
            "device.flags": dict(fn=to_host, args=(carry["flag_rows"],)),
            "host.expand": dict(
                fn=self._expand_chunk,
                args=(rows, valid, 0, self._rt_masks),
                builder=lambda: self._expand_chunk),
            "visited.insert": dict(
                fn=visited_mod.insert,
                args=(carry["visited"], keys,
                      torch.ones((n_keys,), dtype=torch.bool, device=dev)),
                builder=lambda: visited_mod.insert),
        }
        if self._spill is not None:
            segment = host_copy(carry["cur"][:1])
            sites["device.spill_drain"] = [
                dict(name="fetch", fn=self._spill_fetch,
                     args=(carry, 1, cap)),
                dict(name="reset", fn=_reset_nxt, args=(carry,), syncs=0)]
            sites["device.spill_evict"] = [
                dict(name="fetch", fn=_fetch_occupied,
                     args=(carry["visited"],)),
                dict(name="reset", fn=_reset_table, args=(carry,),
                     syncs=0)]
            sites["device.spill_reinject"] = dict(
                fn=self._inject_rows, args=(carry, segment))
        if self._pk is not None:
            pk = self._pk
            sites["packing.pack"] = dict(fn=pk.pack, args=(rows,),
                                         builder=lambda: pk.pack)
            sites["packing.unpack"] = dict(fn=pk.unpack,
                                           args=(pk.pack(rows),),
                                           builder=lambda: pk.unpack)
        if self._canon is not None:
            from dslabs_tpu_torch.tpu.symmetry import build_canonicalizer

            sites["symmetry.canonicalize"] = dict(
                fn=self._canon, args=(rows,),
                builder=lambda: build_canonicalizer(self.p, self._off))
        return sites

    def _dispatch(self, tag: str, fn, *args):
        """The device-dispatch boundary: every hot-loop dispatch and
        blocking readback of this engine goes through here.  With no hook
        installed it is a plain call; the search supervisor installs its
        retry / watchdog / fault-injection boundary as
        ``_dispatch_hook``.  Tags are ``"<engine>.<site>"``: the engine
        half keys the supervisor's fault plan and per-rung counters.  An
        attached telemetry recorder wraps the whole chain, hook included,
        so each dispatch is one span."""
        hook = self._dispatch_hook
        tel = self._telemetry
        if tel is not None:
            return tel.record_dispatch(self, tag, hook, fn, *args)
        if hook is None:
            return fn(*args)
        return hook(tag, fn, *args)

    def _cancelled(self) -> bool:
        """Portfolio-lane cancellation: when the other lane lands a
        terminal verdict first, the supervisor sets this event and every
        run loop returns a TIME_EXHAUSTED outcome marked ``cancelled`` at
        its next level boundary."""
        ev = self._cancel_event
        return ev is not None and ev.is_set()

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
        if p.fault is not None:
            ok = ok & self._fault_msg_ok(nodes, msg)
        nodes2, sends, new_t, exc = _normalize_step(
            p.step_message(nodes, msg), par.shape[0], par.device)
        timers2, t_over = append_timers(chunk["timers"][par], new_t)
        return nodes2, sends, timers2, exc, ok, t_over

    def _tmr_step_raw(self, chunk: dict, par: torch.Tensor,
                      t_idx: torch.Tensor):
        """Handler half of a timer step: timer grid index t_idx = node *
        timer_cap + queue slot.  An index past the grid (node >= n_nodes)
        reads an all-zero queue and writes no queue back, as the
        reference's one-hot selects do."""
        p = self.p
        t_node = torch.div(t_idx, p.timer_cap, rounding_mode="floor")
        t_slot = t_idx % p.timer_cap
        ar = torch.arange(par.shape[0], device=par.device)
        timers = chunk["timers"][par]                       # [P, NN, T, TW]
        inside = (t_node < p.n_nodes)[:, None, None]
        t_row = t_node.clamp(max=p.n_nodes - 1)
        queue = torch.where(inside, timers[ar, t_row], 0)   # [P, T, TW]
        ok = timer_deliverable_mask(queue)[ar, t_slot]
        if p.deliver_timer is not None:
            ok = ok & p.deliver_timer(t_node)
        if p.fault is not None and p.fault.n_crashable:
            # A down node's timers are masked, not cleared: they fire
            # only after its restart.
            down = self._fault_down(chunk["nodes"][par])[ar, t_row]
            ok = ok & (torch.where(inside[:, 0, 0], down, 0) == 0)
        timer = queue[ar, t_slot]
        nodes2, sends, new_t, exc = _normalize_step(
            p.step_timer(chunk["nodes"][par], t_node.to(torch.int32), timer),
            par.shape[0], par.device)
        # Firing consumes the timer.  ``timers`` is a fresh gather, so the
        # write below touches no chunk state.
        timers[ar, t_row] = torch.where(inside, remove_timer(queue, t_slot),
                                        timers[ar, t_row])
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
        ``< net_cap``, then ``net_cap`` + timer grid index, then the fault
        segment) -> (successor row [lanes], valid, over): the batched
        halves at P = 1.  Trace replay (tpu/trace.py) steps with it."""
        p = self.p
        ev = int(event_idx)
        tgrid = p.n_nodes * p.timer_cap
        grid = p.net_cap + tgrid + self._ev_flt
        if not 0 <= ev < grid:
            raise ValueError(f"{p.name}: event id {ev} outside the "
                             f"event grid ({grid})")
        par = torch.zeros((1,), dtype=torch.int64, device=row.device)
        if ev >= p.net_cap + tgrid:
            rows, ok, over = self._flt_step(row[None],
                                            par + (ev - p.net_cap - tgrid))
            return rows[0], ok[0], over[0]
        cs = self.unflatten_rows(row[None])
        if ev < p.net_cap:
            raw = self._msg_step_raw(cs, par, par + ev)
        else:
            raw = self._tmr_step_raw(cs, par, par + (ev - p.net_cap))
        rows, over = self._batched_tail(cs, par, *raw)
        return rows[0], raw[4][0], over[0]

    def _step_batch(self, rows: torch.Tensor, ev: torch.Tensor):
        """Expand each row of ``rows`` [K, lanes] by its own grid event id
        ``ev`` [K] -> (successor rows [K, lanes], valid [K], over [K]), on
        the rows' device with no host sync: ``jax.vmap`` of the
        reference's ``_step_one``.  Both handler halves run over every row
        and the selected half goes through one merge tail; with a fault
        model a third, fault half (no handlers, no merge tail) replaces
        the rows whose id lies past the timer grid.  Ids outside the grid
        read as the reference reads them, never raise: a negative id is
        message slot 0, and an id past the timer grid (past the fault
        segment, with a fault model) selects nothing (an all-zero queue
        whose slot 0 the partial order admits, or an out-of-range fault
        index)."""
        p = self.p
        n = rows.shape[0]
        cs = self.unflatten_rows(rows)
        par = torch.arange(n, device=rows.device)
        ev = ev.to(torch.int64)
        is_msg = ev < p.net_cap
        m = self._msg_step_raw(cs, par, ev)
        t = self._tmr_step_raw(cs, par, (ev - p.net_cap).clamp(min=0))
        raw = [torch.where(is_msg.reshape((n,) + (1,) * (a.dim() - 1)),
                           a, b) for a, b in zip(m, t)]
        succ, over = self._batched_tail(cs, par, *raw)
        ok = raw[4]
        if self._ev_flt:
            base = p.net_cap + p.n_nodes * p.timer_cap
            is_flt = ev >= base
            f_rows, f_ok, f_over = self._flt_step(
                rows, (ev - base).clamp(min=0))
            succ = torch.where(is_flt[:, None], f_rows, succ)
            ok = torch.where(is_flt, f_ok, ok)
            over = torch.where(is_flt, f_over, over)
        return succ, ok, over

    @staticmethod
    def _compact_ids(valid_ev: torch.Tensor, budget: int, offset: int = 0,
                     per_row: bool = False):
        """[C, G] validity grid -> ([C, budget] indices into G, -1 = empty
        slot; remaining count).  ``offset`` selects the window of valid
        events by rank [offset, offset + budget); ``remaining`` counts
        valid events past it, summed over the chunk, or per row ([C])
        with ``per_row`` (the lane step's, ``tpu/lanes.py``)."""
        c, g = valid_ev.shape
        dev = valid_ev.device
        if budget >= g:
            ids = torch.arange(g, dtype=torch.int64, device=dev).expand(c, g)
            keep = valid_ev if offset == 0 else torch.zeros_like(valid_ev)
            return (torch.where(keep, ids, -1),
                    torch.zeros((c,) if per_row else (), dtype=torch.int64,
                                device=dev))
        pos = torch.cumsum(valid_ev.to(torch.int64), 1) - 1
        inwin = valid_ev & (pos >= offset) & (pos < offset + budget)
        dest = torch.where(inwin, pos - offset, budget)
        ids = torch.full((c, budget + 1), -1, dtype=torch.int64, device=dev)
        ids.scatter_(1, dest, torch.arange(g, device=dev).expand(c, g))
        past = valid_ev & (pos >= budget + offset)
        remaining = past.sum(1) if per_row else past.sum()
        return ids[:, :budget], remaining

    def _event_tables(self, chunk_rows: torch.Tensor,
                      chunk_valid: torch.Tensor, ev_pass: int = 0,
                      masks=None, per_row: bool = False):
        """[C, lanes] chunk -> (msg_ids [C, Bm] net-slot indices, tmr_ids
        [C, Bt] timer grid indices, flt_ids [C, Bf] fault-segment indices
        or None without a fault model, ev_remaining): each state's valid
        events (occupied network rows + deliverable timers, masked by the
        protocol's deliver_* settings, when ``masks`` = (marr, tarr) is
        given its deliver_*_rt masks, and the fault deliverability mask;
        plus the enabled fault events) packed into per-kind pair slots.
        ``ev_remaining`` counts the message and timer events past the
        window; the fault segment is never windowed, so only pass 0 has
        fault slots; ``per_row`` counts it per chunk row ([C])."""
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
        flt_ids = None
        if p.fault is not None:
            fl = p.fault
            nodes = cs["nodes"]
            net = cs["net"]
            if fl.has_partition:
                # Messages between blocks are blocked while the cut is up
                # (block -1 = unpartitioned node, never blocked).
                blk = self._fault_tables(nodes.device)["block"]
                bf = _pick(blk, net[:, :, 1])
                bt = _pick(blk, net[:, :, 2])
                cross = (bf >= 0) & (bt >= 0) & (bf != bt)
                pcut = nodes[:, fl.pcut_off] > 0
                msg_ok = msg_ok & ~(pcut[:, None] & cross)
            if fl.n_crashable:
                down = self._fault_down(nodes)                  # [C, NN]
                msg_ok = msg_ok & (_pick(down, net[:, :, 2]) == 0)
                tmask = tmask & (down == 0)[:, :, None]
            flt_ids, _f_rem = self._compact_ids(
                self._fault_event_grid(nodes, net) & chunk_valid[:, None],
                self._ev_flt, ev_pass * self._ev_flt)
        msg_ids, m_rem = self._compact_ids(
            msg_ok & chunk_valid[:, None], self._ev_msg,
            ev_pass * self._ev_msg, per_row)
        tmr_ids, t_rem = self._compact_ids(
            tmask.reshape(c, -1) & chunk_valid[:, None], self._ev_tmr,
            ev_pass * self._ev_tmr, per_row)
        return msg_ids, tmr_ids, flt_ids, m_rem + t_rem

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

    @read_only
    def _expand_chunk(self, chunk_rows: torch.Tensor,
                      chunk_valid: torch.Tensor, ev_pass: int = 0,
                      masks=None, dedup: Optional[bool] = None,
                      per_row: bool = False):
        """[C, lanes] chunk rows -> (rows [C*B, lanes], valids [C*B],
        fp [C*B, 4] int32 keys, unique [C*B], overflow scalar,
        ev_remaining scalar, event_ids [C, B], flags dict), all on the
        chunk's device with no host sync.  B = Bm + Bt (+ Bf with a fault
        model): message slots, then timer slots, then fault slots per
        state (successor row = chunk_row * B + slot).  Fingerprints hash
        the canonical rows under ``symmetry=True``; the rows stay the real
        states.

        ``masks`` are the runtime delivery masks (see
        :meth:`set_runtime_masks`).  ``dedup`` (default: the
        constructor's ``in_chunk_dedup``) marks only the first occurrence
        of each key among the valid rows unique; without it every valid
        row is.

        ``per_row`` (the lane step's, ``tpu/lanes.py``, which reduces per
        lane) returns the overflow as each successor row's masked count
        ([C*B] int32) and ``ev_remaining`` per chunk row ([C]) in place of
        the chunk's sums."""
        p = self.p
        c = chunk_valid.shape[0]
        msg_ids, tmr_ids, flt_ids, ev_rem = self._event_tables(
            chunk_rows, chunk_valid, ev_pass, masks, per_row)
        cs = self.unflatten_rows(chunk_rows)
        parts = [self._expand_kind(cs, msg_ids, self._msg_step_raw),
                 self._expand_kind(cs, tmr_ids, self._tmr_step_raw)]
        widths = [self._ev_msg, self._ev_tmr]
        # Grid event ids: timer entries are net_cap + t_idx, fault
        # entries net_cap + NN*T_CAP + f_idx.
        ev_segs = [msg_ids,
                   torch.where(tmr_ids >= 0, p.net_cap + tmr_ids, -1)]
        if self._ev_flt:
            # Fault steps run no handlers and send nothing: the pairs
            # skip the merge tail.
            par = torch.arange(c, device=chunk_rows.device
                               ).repeat_interleave(self._ev_flt)
            rows_f, ok_f, over_f = self._flt_step(
                chunk_rows[par], flt_ids.clamp(min=0).reshape(-1))
            parts.append((rows_f, ok_f & (flt_ids >= 0).reshape(-1),
                          over_f))
            widths.append(self._ev_flt)
            base = p.net_cap + p.n_nodes * p.timer_cap
            ev_segs.append(torch.where(flt_ids >= 0, base + flt_ids, -1))

        def inter(i):
            xs = [part[i] for part in parts]
            return torch.cat([x.reshape((c, w) + x.shape[1:])
                              for x, w in zip(xs, widths)], dim=1
                             ).reshape((c * sum(widths),) + xs[0].shape[1:])

        rows, valids, overs = inter(0), inter(1), inter(2)
        event_ids = torch.cat(ev_segs, dim=1)
        overflow = overs * valids.to(torch.int32)
        if not per_row:
            overflow = overflow.sum()
        # Kernel 1 on CUDA rows, its plain version on CPU rows; under
        # symmetry it hashes the canonical rows.
        fp = kernels.fingerprint_rows(self._canon_rows(rows))
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
        loop (:meth:`run_host`).  ``resume=True`` continues from
        ``checkpoint_path`` when a dump of this configuration exists
        there (``CheckpointMismatch`` when the dump is another's)."""
        self._maybe_sanitize()
        self._resumed_from_depth = 0
        tel = self._telemetry
        if self._spill is not None:
            # Spill evictions, spools and reinjections become events.
            self._spill.telemetry = tel
        if self.record_trace or self.use_host_visited:
            out = self.run_host(check_initial, initial, resume=resume)
            eng = "host"
        else:
            out = self._run_device(check_initial, initial, resume=resume)
            eng = "device"
        out.resumed_from_depth = self._resumed_from_depth
        self._stamp_capacity(out)
        self._stamp_faults(out)
        if tel is not None:
            if out.trace_id is None:
                out.trace_id = tel.trace_id
            tel.on_outcome(out, engine=eng)
        return out

    def random_rollouts(self, n_walkers: int = 256, n_steps: int = 64,
                        seed: int = 0, initial: Optional[dict] = None,
                        max_secs: Optional[float] = None) -> SearchOutcome:
        """RandomDFS-style deep probes: ``n_walkers`` random walks of up to
        ``n_steps`` events each, as a thin client of
        :class:`~dslabs_tpu_torch.tpu.swarm.SwarmSearch` on this search's
        device (its table dedup, overflow-restart accounting and witness
        pipeline).  INVARIANT_VIOLATED / EXCEPTION_THROWN carry a
        minimized, replay-verified root-first trace; otherwise
        TIME_EXHAUSTED."""
        from dslabs_tpu_torch.tpu.swarm import SwarmSearch

        sw = SwarmSearch(
            self.p, walkers_per_device=n_walkers, max_steps=n_steps,
            seed=seed, max_secs=max_secs,
            visited_cap=min(self.visited_cap, 1 << 18),
            ev_budget=(self._ev_msg, self._ev_tmr), device=self.device)
        if self._rt_masks is not None:
            sw.set_runtime_masks(*self._rt_masks)
        # The probe's dispatches and rounds go to this engine's recorder.
        sw._telemetry = self._telemetry
        out = sw.run(initial=initial, check_initial=False)
        # decode_trace reads the walk root off whichever search the caller
        # holds.
        self._trace_root = sw._trace_root
        return out

    def _stamp_capacity(self, out: SearchOutcome) -> SearchOutcome:
        """Attach the frontier bytes per state and the symmetry pass's
        permutation count that every verdict carries."""
        out.bytes_per_state = (self._pk.bytes_per_state
                               if self._pk is not None else self.lanes * 4)
        out.bytes_per_state_unpacked = self.lanes * 4
        out.pack_ratio = round(
            out.bytes_per_state_unpacked / max(out.bytes_per_state, 1), 3)
        out.symmetry_perms = (self.p.symmetry.n_perms
                              if self._canon is not None else 0)
        return out

    def _fault_block(self) -> dict:
        """The ``faults`` block of level records and STATUS.json: this
        run's fault-event counts by family."""
        fc = self._fault_counts
        return {"partition_events": int(fc[0]),
                "crash_events": int(fc[1]),
                "drop_events": int(fc[2]),
                "dup_events": int(fc[3]),
                "fault_events": int(fc.sum())}

    def _feed_level(self, engine: str, depth: int, t_lvl: float,
                    explored: int, prev_explored: int, unique: int,
                    nxt_n: int, vis_n: Optional[int] = None,
                    spill: Optional[dict] = None) -> None:
        """Hand the recorder one level record, the reference's keys and
        values, from host scalars the loop already holds.  ``vis_n`` is
        the device table's occupancy (None on the host loop, which keeps
        no table: no ``load_factor``); ``spill`` the drain wall split."""
        delta = [explored - prev_explored]
        rec = {"depth": depth, "wall": round(time.time() - t_lvl, 4),
               "explored": explored, "unique": unique,
               "next_frontier": int(nxt_n)}
        lf = 0.0
        if vis_n is not None:
            lf = rec["load_factor"] = round(vis_n / self.visited_cap, 4)
        if spill is not None:
            rec["spill"] = spill
        rec["per_device"] = {"explored": delta, "frontier": [int(nxt_n)],
                             "load_factor": [lf], "drops": [0]}
        rec["skew"] = {"explored": skew_metrics(delta)}
        if self.p.fault is not None:
            rec["faults"] = self._fault_block()
        self._telemetry.on_level(engine, rec)

    def _stamp_faults(self, out: SearchOutcome) -> SearchOutcome:
        """Attach the run's fault-event counts by family (zeros without a
        fault model)."""
        fc = self._fault_counts
        out.partition_events = int(fc[0])
        out.crash_events = int(fc[1])
        out.drop_events = int(fc[2])
        out.dup_events = int(fc[3])
        out.fault_events = int(fc.sum())
        return out

    # --------------------------------------------------------- checkpoints

    def _ckpt_fingerprint(self) -> str:
        """The config identity a dump must share to resume here; the
        symmetry pass's permutation count takes part (a reduced dump
        counts orbits)."""
        return ckpt_mod.config_fingerprint(
            self.p, self.strict, self.record_trace,
            symmetry=(self.p.symmetry.n_perms
                      if self._canon is not None else 0))

    def has_resumable_checkpoint(self) -> bool:
        """A dump of this configuration exists (no arrays loaded)."""
        if not self.checkpoint_path:
            return False
        fp = ckpt_mod.peek_fingerprint(self.checkpoint_path)
        return fp is not None and fp == self._ckpt_fingerprint()

    def _load_ckpt(self):
        """Load and verify the dump: None without a file,
        ``CheckpointMismatch`` for another configuration's.  The
        frontier comes back as raw (unpacked) rows."""
        if not self.checkpoint_path:
            return None
        ck = ckpt_mod.load(self.checkpoint_path, self._ckpt_fingerprint())
        if ck is not None:
            self._resumed_from_depth = ck.depth
            self._normalize_ckpt_frontier(ck)
        return ck

    def _normalize_ckpt_frontier(self, ck) -> None:
        """Decode a dump's frontier rows to raw int32 lanes by its
        ``frontier_encoding`` marker.  A packed dump on an unpacked
        engine converts with a warning; an encoding this protocol's
        derived descriptor does not reproduce is refused.  A marker
        written by the JAX package decodes through the port's own
        descriptor: equal signatures mean byte-identical packed rows."""
        enc = "raw"
        if ck.extra and "frontier_encoding" in ck.extra:
            enc = np.asarray(ck.extra["frontier_encoding"]).item()
            if isinstance(enc, bytes):
                enc = enc.decode()
            ck.extra = {k: v for k, v in ck.extra.items()
                        if k != "frontier_encoding"} or None
        if enc == "raw":
            if len(ck.frontier) and ck.frontier.shape[1] != self.lanes:
                raise ckpt_mod.CheckpointMismatch(
                    f"checkpoint frontier rows are "
                    f"{ck.frontier.shape[1]} lanes wide, this "
                    f"protocol's are {self.lanes}: foreign dump")
            return
        pk = self._pk or packing_mod.derive_packing(self.p, self.lanes)
        if pk.identity or pk.signature() != enc:
            raise ckpt_mod.CheckpointMismatch(
                f"refusing to resume packed checkpoint: frontier "
                f"encoding {enc!r} does not match this protocol's "
                f"derived descriptor "
                f"{pk.signature() if not pk.identity else 'raw'!r} "
                "(domain declarations changed, or the dump belongs to "
                "a different spec)")
        if self._pk is None:
            warnings.warn(
                f"{self.p.name}: resuming a PACKED checkpoint ({enc}) on "
                "an unpacked engine: converting the frontier rows",
                RuntimeWarning, stacklevel=3)
        base = None
        if ck.extra and "pack_base" in ck.extra:
            base = np.asarray(ck.extra["pack_base"], np.int32).reshape(-1)
            ck.extra = {k: v for k, v in ck.extra.items()
                        if k != "pack_base"} or None
        if pk.has_delta and base is None:
            raise ckpt_mod.CheckpointMismatch(
                f"packed checkpoint {enc!r} uses delta lanes but carries "
                "no pack_base vector: corrupt or foreign dump")
        ck.frontier = (pk.unpack_np(ck.frontier, base) if len(ck.frontier)
                       else np.zeros((0, self.lanes), np.int32))

    @property
    def _ckpt_writer(self):
        w = getattr(self, "_ckpt_writer_obj", None)
        if w is None:
            w = self._ckpt_writer_obj = ckpt_mod.AsyncCheckpointWriter()
        return w

    def _join_ckpt_writer(self) -> None:
        """A dump still being written lands before an outcome returns."""
        w = getattr(self, "_ckpt_writer_obj", None)
        if w is not None:
            w.join()

    def _frontier_encoding(self) -> str:
        """The marker written with every dump's frontier rows."""
        return "raw" if self._pk is None else self._pk.signature()

    def _ckpt_due(self, depth: int) -> bool:
        return bool(self.checkpoint_path and self.checkpoint_every
                    and depth % self.checkpoint_every == 0)

    def _make_ckpt(self, frontier: np.ndarray, visited_keys: np.ndarray,
                   depth: int, explored: int, elapsed: float,
                   vis_over: int = 0, extra: Optional[dict] = None):
        """A SearchCheckpoint of host arrays; ``frontier`` in the
        engine's native encoding, marked when packed."""
        extra = dict(extra or {})
        if self._pk is not None:
            extra["frontier_encoding"] = np.bytes_(
                self._frontier_encoding().encode())
        return ckpt_mod.SearchCheckpoint(
            fingerprint=self._ckpt_fingerprint(), depth=depth,
            explored=explored, elapsed=elapsed, frontier=frontier,
            visited_keys=visited_keys, vis_over=vis_over,
            extra=extra or None)

    def _kick_ckpt(self, frontier: np.ndarray, visited_keys: np.ndarray,
                   depth: int, explored: int, elapsed: float,
                   vis_over: int = 0) -> None:
        """Queue one background atomic dump of host copies (skipped if
        the previous one is still being written)."""
        ck = self._make_ckpt(frontier, visited_keys, depth, explored,
                             elapsed, vis_over)
        self._ckpt_writer.kick(
            lambda: ckpt_mod.save(self.checkpoint_path, ck))

    # ------------------------------------------------------------ symmetry

    def _canon_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """The canonical orbit representative of each row under
        ``symmetry=True``, the rows themselves otherwise.  Only
        fingerprints see it: stored rows stay the real states."""
        return rows if self._canon is None else self._canon(rows)

    def _canonical_root_fp(self, state: dict) -> torch.Tensor:
        """[1, 4] key of a batch-1 state through the same
        canonicalize-then-hash step as the expand."""
        return kernels.fingerprint_rows(self._canon_rows(
            flatten_state(state)))

    # --------------------------------------------------------- fault plane
    #
    # Reached only when ``p.fault`` is set.  Each method is batched over
    # pairs [P] or chunk states [C], where the reference vmaps a one-row
    # function; the one-hot selects become gathers with the same
    # out-of-range reads (``_pick``).

    def _fault_tables(self, dev) -> dict:
        """The fault descriptor's arrays as tensors on ``dev``."""
        t = self._flt_t
        if t is None or t["dev"] != dev:
            fl = self.p.fault
            t = self._flt_t = {
                "dev": dev,
                "block": torch.as_tensor(fl.block_id, device=dev),
                "wipe": torch.as_tensor(fl.wipe, device=dev),
                "init": torch.as_tensor(fl.init_vec, device=dev)}
        return t

    def _fault_down(self, nodes: torch.Tensor) -> torch.Tensor:
        """[P, NW] node lanes -> [P, NN] down flags (0 for nodes that
        cannot crash), read from the controller's ``down_*`` lanes."""
        z = torch.zeros_like(nodes[:, 0])
        return torch.stack([nodes[:, int(off)] if int(off) >= 0 else z
                            for off in self.p.fault.down_off], dim=1)

    def _fault_msg_ok(self, nodes: torch.Tensor,
                      msg: torch.Tensor) -> torch.Tensor:
        """Deliverability of each message row [P, MW] under its state's
        fault lanes [P, NW] -> [P] bool: blocked while a cut separates the
        blocks of ``frm`` and ``to``, or while the destination is down.
        A blocked message stays in the network, deliverable again after
        HEAL or RESTART."""
        fl = self.p.fault
        ok = torch.ones(msg.shape[:1], dtype=torch.bool, device=msg.device)
        if fl.has_partition:
            blk = self._fault_tables(msg.device)["block"]
            bf, bt = _pick(blk, msg[:, 1]), _pick(blk, msg[:, 2])
            cross = (bf >= 0) & (bt >= 0) & (bf != bt)
            ok = ok & ~((nodes[:, fl.pcut_off] > 0) & cross)
        if fl.n_crashable:
            ok = ok & (_pick(self._fault_down(nodes), msg[:, 2]) == 0)
        return ok

    def _flt_step(self, rows: torch.Tensor, f_idx: torch.Tensor):
        """Expand each state row [P, lanes] by its fault event ``f_idx``
        [P] (an index into the fault segment) -> (successor rows, valid
        [P], over [P]).  Fault steps run no handlers and send nothing:
        they flip controller lanes, wipe volatile fields (CRASH) or
        remove one network row (DROP); ``over`` is always 0."""
        p = self.p
        fl = p.fault
        n = rows.shape[0]
        dev = rows.device
        s = self.unflatten_rows(rows)
        nodes, net = s["nodes"], s["net"]
        ar = torch.arange(n, device=dev)
        ok = torch.zeros((n,), dtype=torch.bool, device=dev)
        nodes2 = nodes.clone()
        net2 = net
        if fl.has_partition:
            is_cut = f_idx == fl.seg_cut
            is_heal = f_idx == fl.seg_heal
            pcut, eras = nodes[:, fl.pcut_off], nodes[:, fl.eras_off]
            ok = ok | (is_cut & (pcut == 0)
                       & (eras < fl.model.partition.max_eras)) \
                | (is_heal & (pcut > 0))
            nodes2[:, fl.pcut_off] = torch.where(
                is_cut, 1, torch.where(is_heal, 0, nodes2[:, fl.pcut_off]))
            nodes2[:, fl.eras_off] += is_cut.to(torch.int32)
        if fl.n_crashable:
            tabs = self._fault_tables(dev)
        for k in range(fl.n_crashable):
            off = int(fl.down_off[int(fl.crash_nodes[k])])
            is_c = f_idx == fl.seg_crash + k
            is_r = f_idx == fl.seg_restart + k
            down_n = nodes[:, off]
            ok = ok | (is_c & (down_n == 0)
                       & (nodes[:, fl.crashes_off]
                          < fl.model.crash.max_crashes)) \
                | (is_r & (down_n > 0))
            # Volatile lanes back to their declared inits; durable lanes
            # and every other node's lanes keep their values.
            nodes2 = torch.where(is_c[:, None] & tabs["wipe"][k][None, :],
                                 tabs["init"][None, :], nodes2)
            nodes2[:, off] = torch.where(
                is_c, 1, torch.where(is_r, 0, nodes2[:, off]))
            nodes2[:, fl.crashes_off] += is_c.to(torch.int32)
        if fl.model.max_drops > 0:
            in_drop = (f_idx >= fl.seg_drop) \
                & (f_idx < fl.seg_drop + p.net_cap)
            slot = (f_idx - fl.seg_drop).clamp(0, p.net_cap - 1)
            occ = net[ar, slot, 0] != SENTINEL
            ok = ok | (in_drop & occ
                       & (nodes[:, fl.drops_off] < fl.model.max_drops))
            # Shift-left removal keeps the set's canonical sorted prefix.
            net2 = torch.where(in_drop[:, None, None],
                               remove_timer(net, slot), net2)
            nodes2[:, fl.drops_off] += in_drop.to(torch.int32)
        if fl.model.max_dups > 0:
            in_dup = f_idx >= fl.seg_dup
            slot = (f_idx - fl.seg_dup).clamp(0, p.net_cap - 1)
            occ = net[ar, slot, 0] != SENTINEL
            # Delivery never consumes, so a duplicate changes nothing but
            # the budget; the event names the slot in witness traces.
            ok = ok | (in_dup & occ
                       & (nodes[:, fl.dups_off] < fl.model.max_dups))
            nodes2[:, fl.dups_off] += in_dup.to(torch.int32)
        out = torch.cat([nodes2.to(torch.int32), net2.reshape(n, -1),
                         s["timers"].reshape(n, -1),
                         torch.zeros((n, 1), dtype=torch.int32, device=dev)],
                        dim=1)
        return out, ok, torch.zeros((n,), dtype=torch.int32, device=dev)

    def _fault_event_grid(self, nodes: torch.Tensor,
                          net: torch.Tensor) -> torch.Tensor:
        """[C, n_fault_events] validity of the fault segment over chunk
        states (node lanes [C, NW], networks [C, CAP, MW]): the same
        conditions as :meth:`_flt_step`'s ``ok``."""
        fl = self.p.fault
        c = nodes.shape[0]
        cols = []
        if fl.has_partition:
            pcut = nodes[:, fl.pcut_off]
            eras = nodes[:, fl.eras_off]
            cols.append(((pcut == 0)
                         & (eras < fl.model.partition.max_eras))[:, None])
            cols.append((pcut > 0)[:, None])
        if fl.n_crashable:
            downs = torch.stack([nodes[:, int(fl.down_off[int(n)])] > 0
                                 for n in fl.crash_nodes], dim=1)  # [C, nc]
            budget = (nodes[:, fl.crashes_off]
                      < fl.model.crash.max_crashes)[:, None]
            cols.append(~downs & budget)
            cols.append(downs)
        occ = net[:, :, 0] != SENTINEL                          # [C, CAP]
        if fl.model.max_drops > 0:
            cols.append(occ & (nodes[:, fl.drops_off]
                               < fl.model.max_drops)[:, None])
        if fl.model.max_dups > 0:
            cols.append(occ & (nodes[:, fl.dups_off]
                               < fl.model.max_dups)[:, None])
        return (torch.cat(cols, dim=1) if cols
                else torch.zeros((c, 0), dtype=torch.bool,
                                 device=nodes.device))

    def _fault_chunk_counts(self, event_ids: torch.Tensor,
                            valids: torch.Tensor) -> torch.Tensor:
        """[4] int64 partition / crash + restart / drop / dup valid
        successor events of one expanded chunk (``event_ids`` [C, B] grid
        ids, ``valids`` [C*B]), on the device.  Both loops count with it:
        the device loop into its carry, ``run_host`` into
        ``_fault_counts`` (the reference keeps a numpy twin for the
        latter)."""
        fl = self.p.fault
        base = self.p.net_cap + self.p.n_nodes * self.p.timer_cap
        ev = event_ids.reshape(-1)
        ok = valids & (ev >= base)
        f = ev - base
        return torch.stack([
            (ok & (f < fl.seg_crash)).sum(),
            (ok & (f >= fl.seg_crash) & (f < fl.seg_drop)).sum(),
            (ok & (f >= fl.seg_drop) & (f < fl.seg_dup)).sum(),
            (ok & (f >= fl.seg_dup)).sum()])

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
                 initial: Optional[dict] = None,
                 resume: bool = False) -> SearchOutcome:
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
        ck = self._load_ckpt() if resume else None
        if ck is not None and self.record_trace:
            raise ValueError(
                "resume + record_trace is unsupported on the host loop "
                "(per-level trace spills cannot be rebuilt from a "
                "checkpoint); rerun without record_trace")
        self._levels = []
        self._host_prev_explored = 0
        self._fault_counts[:] = 0
        samples = None
        if ck is not None:
            # Resume at the dumped level boundary: the visited set from
            # the dumped keys, the frontier from the dumped rows, the
            # clock from the dump's elapsed seconds.
            t0 = time.time() - ck.elapsed
            h1, h2 = host_keys(ck.visited_keys)
            order = np.lexsort((h2, h1))
            visited = (h1[order], h2[order])
            self._host_visited = visited
            explored = ck.explored
            depth = ck.depth
            frontier_n = len(ck.frontier)
            if not frontier_n:
                # A dump written after the final level: the search ended.
                return SearchOutcome("SPACE_EXHAUSTED", explored,
                                     len(visited[0]), depth,
                                     time.time() - t0)
            frontier = torch.as_tensor(ck.frontier, device=dev)
            parent_rows = np.full(frontier_n, -1, dtype=np.int64)
        else:
            frontier = flatten_state(state)              # [1, lanes] rows
            visited = host_keys(
                self._canonical_root_fp(state).cpu().numpy())
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
                    and time.time() - t0 > self.max_secs) \
                    or self._cancelled():
                out = exhausted("TIME_EXHAUSTED")
                out.cancelled = self._cancelled()
                return out
            depth += 1
            self._current_depth = depth
            t_lvl = time.time()
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
                 flags) = self._dispatch("host.expand", self._expand_chunk,
                                         chunk_rows, chunk_valid, 0,
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
                if self._ev_flt:
                    self._fault_counts += self._fault_chunk_counts(
                        event_ids, valids).cpu().numpy()
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
            if self._telemetry is not None:
                self._feed_level("host", depth, t_lvl, explored,
                                 self._host_prev_explored, len(visited[0]),
                                 len(keep_idx))
                self._host_prev_explored = explored
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
            nf = [s[k - (e - len(s))]
                  for s, k, e in zip(lvl_states, parts, ends) if len(k)]
            frontier = torch.cat([torch.from_numpy(s).to(dev) for s in nf])
            if self._ckpt_due(depth) and not self.record_trace:
                # Everything is on the host already: a synchronous
                # atomic dump of raw rows (the host loop stores none
                # packed).
                ckpt_mod.save(self.checkpoint_path, ckpt_mod.SearchCheckpoint(
                    fingerprint=self._ckpt_fingerprint(), depth=depth,
                    explored=explored, elapsed=time.time() - t0,
                    frontier=np.concatenate(nf),
                    visited_keys=_keys_to_rows(visited)))

    def _build_dev_step(self, cap: int):
        """One wave step over frontier chunk ``j``: expand -> visited-table
        insert -> frontier-compact append, all on the device.  The carry
        is updated IN PLACE where the reference donates it to a jitted
        program: kernel 2 writes the table, ``index_copy_`` writes the
        next frontier, and the counters are added to.  With packing, the
        frontier buffers hold packed rows (``plane`` words): the chunk is
        unpacked here and the selected successors are packed before the
        append, which takes the step's one host sync (their count);
        unpacked, the step has none.

        Spill mode: a step that would overflow the frontier buffer or
        leave table keys unresolved aborts and changes nothing, with an
        abort code in the stats' ``f_drop`` slot (bit 0 frontier full,
        bit 1 table full).  Where the reference reverts its functional
        carry with ``where(abort, old, new)``, the port snapshots the
        table into ``vis_snap`` before kernel 2 writes it, reads the code
        (one host sync) and, on an abort, swaps the snapshot back in
        before anything else of the carry is written.  Fresh pruned rows
        are appended too, so that they reach the drain's refilter."""
        p = self.p
        C = self.chunk
        dev = self.device
        pk = self._pk
        spill_on = self._spill is not None

        def stats(carry, ev_rem):
            # The per-wave stats vector, the only recurring device->host
            # transfer: [explored, overflow, vis_over, f_drop, vis_n,
            # nxt_n, ev_remaining] ++ flag counts ++ (fault model only)
            # the fault-family counts.  (The reference keeps the chunk
            # index j at slot 6; here the host drives j.)
            return torch.cat([carry["explored"], carry["overflow"],
                              carry["vis_over"], carry["f_drop"],
                              carry["vis_n"], carry["nxt_n"],
                              ev_rem.reshape(1), carry["flag_cnt"]]
                             + ([carry["fault_cnt"]]
                                if "fault_cnt" in carry else []))

        def step(carry, j: int, ev_pass: int):
            self.chunk_steps += 1
            start = j * C
            rows_chunk = carry["cur"][start:start + C]
            if pk is not None:
                rows_chunk = pk.unpack(rows_chunk)
            valid = (start + torch.arange(C, device=dev)) < carry["cur_n"]
            (rows, valids, fp, unique, overflow, ev_rem, event_ids,
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

            pruned = rows[:, -1] != 0        # exception states terminal
            for n in p.prunes:
                pruned = pruned | flags[f"prune:{n}"]

            # ---- device-table dedup (the authority); unresolved keys are
            # treated as fresh and counted into vis_over.
            if spill_on:
                carry["vis_snap"].copy_(carry["visited"])
            _, inserted, unresolved = visited_mod.insert(
                carry["visited"], fp, unique)
            fresh = inserted | unresolved

            # ---- frontier-compact append of fresh (un-pruned, outside
            # spill mode) successors
            sel = fresh if spill_on else fresh & ~pruned
            n_sel = sel.sum()
            nxt_n = carry["nxt_n"]
            if spill_on:
                code = int(((nxt_n + n_sel) > cap).to(torch.int64)
                           + 2 * unresolved.any().to(torch.int64))
                if code:
                    carry["visited"], carry["vis_snap"] = (
                        carry["vis_snap"], carry["visited"])
                    carry["f_drop"].fill_(code)
                    return stats(carry, ev_rem)
            carry["flag_rows"].copy_(torch.where(
                fresh_flag[:, None], rows[idxs], carry["flag_rows"]))
            spos = torch.cumsum(sel.to(torch.int64), 0) - 1
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
            f_drop = torch.clamp(nxt_n + n_sel - cap, min=0)
            carry["nxt_n"] += n_sel - f_drop
            carry["vis_n"] += inserted.sum()
            carry["explored"] += valids.sum()
            carry["overflow"] += overflow
            carry["vis_over"] += unresolved.sum()
            carry["f_drop"] += f_drop
            carry["flag_cnt"] += cnts
            if "fault_cnt" in carry:
                carry["fault_cnt"] += self._fault_chunk_counts(event_ids,
                                                               valids)
            return stats(carry, ev_rem)

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

    def _empty_carry(self, cap: int, table: torch.Tensor, vis_n: int = 0,
                     explored: int = 0, vis_over: int = 0) -> dict:
        """A carry with empty frontier buffers of ``cap`` (+1 dump) rows
        around ``table``, the counters at the given values, the flag and
        fault accumulators zero (a resumed run counts fault events from
        its resume point, as the reference's does), and in spill mode the
        table's snapshot buffer."""
        dev = self.device
        nf = len(self._flag_names)

        def z(v=0):
            return torch.full((1,), v, dtype=torch.int64, device=dev)

        carry = {
            "cur": torch.zeros((cap + 1, self.plane), dtype=torch.int32,
                               device=dev),
            "cur_n": z(),
            "nxt": torch.zeros((cap + 1, self.plane), dtype=torch.int32,
                               device=dev),
            "nxt_n": z(), "visited": table, "vis_n": z(vis_n),
            "explored": z(explored), "overflow": z(),
            "vis_over": z(vis_over), "f_drop": z(),
            "flag_cnt": torch.zeros((nf,), dtype=torch.int64, device=dev),
            "flag_rows": torch.zeros((nf, self.lanes), dtype=torch.int32,
                                     device=dev),
        }
        if self._ev_flt:
            carry["fault_cnt"] = torch.zeros((4,), dtype=torch.int64,
                                             device=dev)
        if self._spill is not None:
            # Written before every read; filled so that a carry's
            # contents are a function of its inputs.
            carry["vis_snap"] = torch.full_like(table, visited_mod.EMPTY)
        return carry

    def _build_dev_init(self, cap: int):
        """The carry, built on the device: only the root row crosses from
        the host (unpacked; it is packed here for storage); the root key
        goes through the same table insert as the waves."""
        V = self.visited_cap
        dev = self.device

        def build(row0):
            fp0 = kernels.fingerprint_rows(self._canon_rows(row0))  # [1, 4]
            table = visited_mod.empty_table(V, dev)
            visited_mod.insert(table, fp0,
                               torch.ones((1,), dtype=torch.bool,
                                          device=dev))
            carry = self._empty_carry(cap, table, vis_n=1)
            carry["cur"][0] = (row0 if self._pk is None
                               else self._pk.pack(row0))[0]
            carry["cur_n"].fill_(1)
            return carry

        return build

    def _carry_from_ckpt(self, ck, cap: int) -> dict:
        """The carry of a dump: its frontier rows (re-encoded to the
        engine's storage) in ``cur``, and the table rebuilt by inserting
        the dumped keys with kernel 2 (``visited.build_table``): the key
        set is the dump's content, the layout is the engine's own."""
        V = self.visited_cap
        n = len(ck.frontier)
        table, n_ins, n_unres = visited_mod.build_table(
            V, torch.from_numpy(
                np.ascontiguousarray(ck.visited_keys).view(np.int32)),
            self.device)
        if n_unres:
            raise CapacityOverflow(
                f"{self.p.name}: visited_cap={V} too small to rebuild "
                f"the checkpoint's visited set ({n_unres} of "
                f"{len(ck.visited_keys)} keys unresolved); raise "
                "visited_cap")
        carry = self._empty_carry(cap, table, vis_n=n_ins,
                                  explored=ck.explored,
                                  vis_over=ck.vis_over)
        if n:
            rows = (self._pk.pack_np(ck.frontier) if self._pk is not None
                    else ck.frontier)
            carry["cur"][:n] = torch.from_numpy(rows).to(self.device)
        carry["cur_n"].fill_(n)
        return carry

    def _write_dev_ckpt(self, carry, depth: int, explored: int,
                        vis_over: int, nxt_n: int, elapsed: float) -> None:
        """Dump the wave-boundary carry (after the promote, ``cur`` holds
        the next level): its occupied frontier prefix and occupied table
        lines, copied to the host here, written in the background."""
        self._kick_ckpt(host_copy(carry["cur"][:nxt_n]),
                        visited_mod.host_occupied(carry["visited"]),
                        depth, explored, elapsed, vis_over)

    def _dev_terminal(self, carry, flag_counts, explored, vis_n, depth,
                      t0, vis_over) -> SearchOutcome:
        """Resolve the first terminal flag (checkState order).  The flag
        rows are the one non-scalar readback, paid once per run."""
        rows = self._dispatch("device.flags", to_host, carry["flag_rows"])
        return self._terminal_from_rows(rows, flag_counts, explored, vis_n,
                                        depth, time.time() - t0, vis_over)

    def _terminal_from_rows(self, rows, flag_counts, explored, vis_n,
                            depth, elapsed, vis_over) -> SearchOutcome:
        """The verdict of the first fired flag in checkState order
        (exception, invariants, goals), from the host copy of its flag
        rows; the lane loop calls this on one lane's rows."""
        for fi, fname in enumerate(self._flag_names):
            if flag_counts[fi] <= 0:
                continue
            st = self._host_state(rows[fi][None])
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
                    initial: Optional[dict] = None,
                    resume: bool = False) -> SearchOutcome:
        """The device-resident BFS.  The frontier buffer starts small and
        grows x8 on overflow (a deterministic restart: same verdict, from
        the dump when one was loaded) up to ``frontier_cap``; overflowing
        at the cap is CAPACITY_EXHAUSTED.  A resumed frontier sets the
        buffer's floor.  Spill mode skips the growth and runs
        :meth:`_device_attempt_spill` at the full capacity."""
        t0 = time.time()
        state = self._initial_or(initial)
        self._fault_counts[:] = 0
        ck = self._load_ckpt() if resume else None
        if ck is not None:
            t0 = time.time() - ck.elapsed
        elif check_initial:
            out = self._check_initial(state, t0)
            if out is not None:
                return out
        C = self.chunk
        user_cap = -(-self.frontier_cap // C) * C
        try:
            if self._spill is not None:
                return self._device_attempt_spill(state, user_cap, t0, ck)
            cap = min(user_cap, -(-max(C, 1 << 11) // C) * C)
            if ck is not None:
                cap = min(user_cap,
                          max(cap, -(-max(len(ck.frontier), 1) // C) * C))
            while True:
                out = self._device_attempt(state, cap, user_cap, t0, ck)
                if out is not None:
                    return out
                cap = min(cap * 8, user_cap)
        finally:
            self._join_ckpt_writer()

    def _device_attempt(self, state, cap: int, user_cap: int,
                        t0, ck=None) -> Optional[SearchOutcome]:
        """One run at a fixed frontier-buffer capacity; None = the
        frontier overflowed below the user cap (the caller grows it and
        restarts).  ``ck`` (a loaded dump) seeds the carry instead of the
        root."""
        p = self.p
        C = self.chunk
        step = self._build_dev_step(cap)
        promote = self._build_dev_promote(cap)
        if ck is not None:
            if not len(ck.frontier):
                # A dump written after the final wave: the search ended.
                return SearchOutcome(
                    "SPACE_EXHAUSTED", ck.explored, len(ck.visited_keys),
                    ck.depth, time.time() - t0, visited_overflow=ck.vis_over)
            carry = self._dispatch("device.init", self._carry_from_ckpt,
                                   ck, cap)
            depth = ck.depth
            n_chunks = -(-len(ck.frontier) // C)
            last = (ck.explored, len(ck.visited_keys), ck.vis_over)
        else:
            carry = self._dispatch("device.init", self._build_dev_init(cap),
                                   flatten_state(state))
            depth = 0
            n_chunks = 1
            last = (0, 1, 0)   # (explored, unique, vis_over) at the last sync
        # A finite ev_budget can need extra window passes over a chunk;
        # the host then reads each step's stats to decide (the reference
        # syncs the same way in that mode).
        windowed = (self._ev_msg < p.net_cap
                    or self._ev_tmr < p.n_nodes * p.timer_cap)
        nf = len(self._flag_names)
        while True:
            if (self.max_secs is not None
                    and time.time() - t0 > self.max_secs) \
                    or self._cancelled():
                return SearchOutcome(
                    "TIME_EXHAUSTED", last[0], last[1], depth,
                    time.time() - t0, visited_overflow=last[2],
                    cancelled=self._cancelled())
            if self.max_depth is not None and depth >= self.max_depth:
                return SearchOutcome(
                    "DEPTH_EXHAUSTED", last[0], last[1], depth,
                    time.time() - t0, visited_overflow=last[2])
            depth += 1
            self._current_depth = depth
            t_wave = time.time()
            j = ev_pass = 0
            sdev = s = None
            while j < n_chunks:
                sdev = self._dispatch("device.step", step, carry, j, ev_pass)
                if windowed:
                    # The window remainder decides the next step: the
                    # wave syncs per step (its last readback is the
                    # wave's stats).
                    s = self._dispatch("device.sync", to_host, sdev)
                    if int(s[6]) > 0:
                        ev_pass += 1
                        continue
                j += 1
                ev_pass = 0
            if not windowed:
                s = self._dispatch("device.sync", to_host, sdev)
            self._dispatch("device.promote", promote, carry)
            (explored, overflow, vis_over, f_drop, vis_n,
             nxt_n) = (int(x) for x in s[:6])
            flag_counts = s[7:7 + nf]
            if self._ev_flt:
                # Cumulative in the carry: overwrite, never add.
                self._fault_counts[:] = s[7 + nf:7 + nf + 4]
            self._check_overflow(overflow, depth)
            limit = (3 * self.visited_cap // 4 if self.strict
                     else self.visited_cap)
            if (not getattr(self, "_warned_visited", False)
                    and vis_n >= int(VISITED_WARN * limit)):
                self._warned_visited = True
                warnings.warn(
                    f"{p.name}: visited table at {vis_n}/"
                    f"{self.visited_cap} at depth {depth}: capacity "
                    "pressure; raise visited_cap or enable the spill "
                    "tier (spill=True)",
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
            if self._telemetry is not None:
                self._feed_level("device", depth, t_wave, explored, last[0],
                                 vis_n, nxt_n, vis_n=vis_n)
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
            if self._ckpt_due(depth):
                self._write_dev_ckpt(carry, depth, explored, vis_over,
                                     nxt_n, time.time() - t0)
            if nxt_n == 0:
                return SearchOutcome(
                    "SPACE_EXHAUSTED", explored, vis_n, depth,
                    time.time() - t0, visited_overflow=vis_over)
            n_chunks = -(-nxt_n // C)

    def _check_overflow(self, overflow: int, depth: int) -> None:
        p = self.p
        if overflow:
            raise CapacityOverflow(
                f"{p.name}: net_cap={p.net_cap}, timer_cap="
                f"{p.timer_cap}, or max_live_sends={p.max_live_sends} "
                f"overflowed at depth {depth} ({overflow} drops); "
                "raise the caps")

    # ----------------------------------------- host-RAM spill tier mode
    #
    # The spill variant of the device loop (tpu/spill.py).  The same wave
    # cycle with three changes: a chunk step aborts (changes nothing and
    # returns a code) instead of dropping frontier rows or leaving table
    # keys unresolved; the host answers an abort by draining nxt to the
    # frontier spool and, for a full table, evicting the table to the
    # host tier; and once the tier is live, each level boundary
    # refilters the would-be frontier against it.  The wave syncs once
    # per chunk step (no speculation).  Each host round trip goes through
    # the ``_dispatch`` seam as in the reference: the drain and the
    # eviction are a read-only fetch and then the reset, each dispatched
    # under the site's tag.

    @staticmethod
    def _pow2_bucket(n: int, cap: int) -> int:
        m = 1
        while m < max(n, 1):
            m <<= 1
        return min(m, cap)

    def _spill_keys_of(self, rows: torch.Tensor, cap: int) -> torch.Tensor:
        """Keys of unpacked device rows [n, lanes] through the same
        canonicalize-then-hash step as the expand (kernel 1 on the card),
        over a zero-padded power-of-two row bucket as the reference's
        per-bucket programs hash, so tier keys equal expand keys bit for
        bit."""
        n = rows.shape[0]
        m = self._pow2_bucket(n, max(cap, n))
        pad = torch.zeros((m, rows.shape[1]), dtype=torch.int32,
                          device=rows.device)
        pad[:n] = rows
        return kernels.fingerprint_rows(self._canon_rows(pad))[:n]

    def _spill_keep_mask(self, rows: torch.Tensor) -> torch.Tensor:
        """Drained rows that may be expanded: no exception and no prune
        predicate (spill mode appends fresh pruned rows so that they
        reach the refilter; they are never expanded)."""
        keep = rows[:, -1] == 0
        if self.p.prunes and rows.shape[0]:
            st = self.unflatten_rows(rows)
            for fn in self.p.prunes.values():
                keep = keep & ~fn(st)
        return keep

    def _spill_drain(self, carry, nxt_n: int, cap: int) -> None:
        """Drain nxt's occupied prefix: its keys (kernel 1) and keep mask
        are computed on the device and copied to the host with the
        packed rows (a synchronising ``.cpu()``) before the host half is
        queued, so the refilter sees numpy only, and ordered before any
        later eviction; then nxt is reset on the device."""
        sp = self._spill
        if nxt_n:
            rows, keys, keep = self._dispatch(
                "device.spill_drain", self._spill_fetch, carry, nxt_n, cap)

            def host_half():
                idx = sp.refilter(
                    np.arange(len(rows), dtype=np.int32)[:, None],
                    keys)[:, 0]
                sp.spool(rows[idx[keep[idx]]])

            sp.submit_drain(host_half)
        self._dispatch("device.spill_drain", _reset_nxt, carry)

    @read_only
    def _spill_fetch(self, carry, nxt_n: int, cap: int):
        """The drain's fetch: nxt's first ``nxt_n`` rows (as stored),
        their keys and keep mask, on the host (three copies)."""
        rows_d = carry["nxt"][:nxt_n]
        rows_u = self._pk.unpack(rows_d) if self._pk is not None \
            else rows_d
        return (host_copy(rows_d),
                self._spill_keys_of(rows_u, cap).cpu().numpy(),
                self._spill_keep_mask(rows_u).cpu().numpy())

    def _spill_evict_dev(self, carry) -> None:
        """Bulk eviction: the occupied table lines go to the host tier on
        the same ordered drain queue as the refilters, and the table and
        ``vis_n`` restart empty (a fresh epoch)."""
        sp = self._spill
        occ = self._dispatch("device.spill_evict", _fetch_occupied,
                             carry["visited"])
        sp.submit_drain(lambda: sp.evict(occ))
        self._dispatch("device.spill_evict", _reset_table, carry)

    def _spill_inject(self, carry, rows: np.ndarray) -> int:
        """A host segment of native (packed) rows becomes the live cur:
        a further wave at the same BFS depth."""
        self._dispatch("device.spill_reinject", self._inject_rows, carry,
                       rows)
        return len(rows)

    def _inject_rows(self, carry, rows: np.ndarray) -> None:
        """The reinjection: host rows (native storage) uploaded into
        ``cur``, which then holds them alone."""
        n = len(rows)
        carry["cur"][:n] = torch.from_numpy(rows).to(self.device)
        carry["cur_n"].fill_(n)

    def _spill_wave(self, carry, step, cap: int, n_cur: int) -> np.ndarray:
        """Expand the injected frontier completely, one sync per chunk
        step, answering abort codes (bit 0 frontier full -> drain; bit 1
        table full -> drain, then evict) by re-running the same chunk on
        the recovered capacity.  Returns the last step's stats."""
        p = self.p
        C = self.chunk
        sp = self._spill
        n_chunks = max(1, -(-n_cur // C))
        windowed = (self._ev_msg < p.net_cap
                    or self._ev_tmr < p.n_nodes * p.timer_cap)
        j = ev_pass = 0
        while True:
            s = self._dispatch("device.sync", to_host,
                               self._dispatch("device.step", step, carry,
                                              j, ev_pass))
            code = int(s[3])
            vis_n, nxt_n = int(s[4]), int(s[5])
            if code:
                if (code & 1) and nxt_n == 0:
                    raise CapacityOverflow(
                        f"{p.name}: one chunk's fresh successors exceed "
                        f"frontier_cap={cap} even with spill; lower chunk "
                        f"({C}) or raise frontier_cap")
                if (code & 2) and vis_n == 0:
                    raise CapacityOverflow(
                        f"{p.name}: one chunk's unique successors exceed "
                        f"visited_cap={self.visited_cap} even from an "
                        f"empty table; lower chunk ({C}) or raise "
                        "visited_cap")
                self._spill_drain(carry, nxt_n, cap)
                if code & 2:
                    self._spill_evict_dev(carry)
                continue
            if windowed and int(s[6]) > 0:
                ev_pass += 1
            else:
                j += 1
                ev_pass = 0
            if j >= n_chunks:
                # The wave's last stats stay exact (the caller derives
                # unique from their vis_n): evicting at the end of a
                # wave is the level boundary's job.
                return s
            # Proactive high-water eviction keeps aborts rare: drain what
            # nxt holds (refiltered before the eviction), then evict.
            if sp.should_evict(vis_n, self.visited_cap):
                self._spill_drain(carry, nxt_n, cap)
                self._spill_evict_dev(carry)

    def _spill_ckpt(self, carry, depth: int, explored: int,
                    elapsed: float) -> None:
        """Synchronous dump at a spill-mode level boundary:
        ``visited_keys`` = device table union host tier, ``frontier`` =
        every spooled segment of the level about to run, the spill
        counters in ``extra__spill_stats``."""
        sp = self._spill
        occ = visited_mod.host_occupied(carry["visited"])
        ckpt_mod.save(self.checkpoint_path, self._make_ckpt(
            sp.spool_cur.concat(self.plane), sp.checkpoint_keys(occ),
            depth, explored, elapsed, extra=sp.checkpoint_extra()))

    def _spill_carry_from_ckpt(self, ck, cap: int):
        """Spill-mode resume: every dumped key goes into the host tier,
        the device table starts empty (a fresh epoch, made exact by the
        refilter), the dumped frontier spools in ``cap``-row segments and
        the first is injected.  Returns (carry, rows injected)."""
        sp = self._spill
        sp.restore(ck.visited_keys, ck.extra)
        rows = (self._pk.pack_np(ck.frontier) if self._pk is not None
                else np.asarray(ck.frontier, np.int32))
        for i in range(0, len(rows), cap):
            sp.spool_cur.push(rows[i:i + cap])
        carry = self._empty_carry(
            cap, visited_mod.empty_table(self.visited_cap, self.device),
            explored=ck.explored)
        return carry, self._spill_inject(carry, sp.spool_cur.pop())

    def _device_attempt_spill(self, state, cap: int, t0,
                              ck=None) -> SearchOutcome:
        """The spill-mode device BFS (the section comment above)."""
        p = self.p
        sp = self._spill
        V = self.visited_cap
        step = self._build_dev_step(cap)
        promote = self._build_dev_promote(cap)
        nf = len(self._flag_names)

        def done(end, explored, unique, depth):
            out = SearchOutcome(end, explored, unique, depth,
                                time.time() - t0)
            sp.attach(out)
            return out

        if ck is not None:
            if not len(ck.frontier):
                return done("SPACE_EXHAUSTED", ck.explored,
                            len(ck.visited_keys), ck.depth)
            carry, n_cur = self._dispatch("device.init",
                                          self._spill_carry_from_ckpt, ck,
                                          cap)
            depth = ck.depth
            explored = ck.explored
            unique = sp.unique(0)
        else:
            # A fresh run must not see an earlier run's tier or spool.
            sp.reset_run()
            carry = self._dispatch("device.init", self._build_dev_init(cap),
                                   flatten_state(state))
            depth = 0
            n_cur = 1
            explored, unique = 0, 1
        while True:
            if (self.max_secs is not None
                    and time.time() - t0 > self.max_secs) \
                    or self._cancelled():
                out = done("TIME_EXHAUSTED", explored, unique, depth)
                out.cancelled = self._cancelled()
                return out
            if self.max_depth is not None and depth >= self.max_depth:
                return done("DEPTH_EXHAUSTED", explored, unique, depth)
            depth += 1
            self._current_depth = depth
            t_lvl = time.time()
            # ---- expand the level: cur, then every spooled segment of
            # the same level as a further wave.
            while True:
                s = self._spill_wave(carry, step, cap, n_cur)
                explored = int(s[0])
                vis_over, vis_n, nxt_n = int(s[2]), int(s[4]), int(s[5])
                flag_counts = s[7:7 + nf]
                if self._ev_flt:
                    self._fault_counts[:] = s[7 + nf:7 + nf + 4]
                self._check_overflow(int(s[1]), depth)
                if vis_over:
                    raise AssertionError(
                        "spill mode committed unresolved keys (abort "
                        "contract violated)")
                unique = sp.unique(vis_n)
                if flag_counts.any():
                    out = self._dev_terminal(carry, flag_counts, explored,
                                             unique, depth, t0, 0)
                    sp.attach(out)
                    return out
                if vis_n >= VISITED_WARN * V and not getattr(
                        self, "_warned_visited", False):
                    self._warned_visited = True
                    warnings.warn(
                        f"{p.name}: visited table at "
                        f"{vis_n / V:.0%} of visited_cap={V} at depth "
                        f"{depth}: capacity pressure; the spill tier "
                        f"evicts at {sp.config.high_water:.0%}",
                        RuntimeWarning, stacklevel=2)
                seg = sp.pop_current()
                if seg is None:
                    break
                n_cur = self._spill_inject(carry, seg)
            if self._telemetry is not None:
                # With the drain's wall split since the last level: host
                # seconds inside drain jobs beside those blocked on them.
                self._feed_level("device", depth, t_lvl, explored,
                                 self._spill_prev_explored, unique, nxt_n,
                                 vis_n=vis_n, spill=sp.level_walls())
                self._spill_prev_explored = explored
            # ---- level boundary: the plain promote until the tier or
            # the spool is live.
            if not (sp.active or sp.should_evict(vis_n, V)):
                if nxt_n == 0:
                    return done("SPACE_EXHAUSTED", explored, unique, depth)
                self._dispatch("device.promote", promote, carry)
                n_cur = nxt_n
                if self._ckpt_due(depth):
                    self._write_dev_ckpt(carry, depth, explored, 0, nxt_n,
                                         time.time() - t0)
                continue
            # The exact path: drain nxt through the refilter, evict at
            # high water (after the drain: the refilter runs against the
            # pre-eviction tier), swap the spools, inject.
            self._spill_drain(carry, nxt_n, cap)
            if sp.should_evict(vis_n, V):
                self._spill_evict_dev(carry)
                vis_n = 0
            unique = sp.unique(vis_n)
            sp.advance_level()
            if not sp.spool_cur.segments:
                return done("SPACE_EXHAUSTED", explored, unique, depth)
            if self._ckpt_due(depth):
                self._spill_ckpt(carry, depth, explored, time.time() - t0)
            n_cur = self._spill_inject(carry, sp.spool_cur.pop())
