"""The owner-sharded BFS engine: D shards of the search, on one device or
one per rank.

Counterpart of ``dslabs_tpu/tpu/sharded.py``.  The search is split into D
shards, each with its own frontier shard, next-frontier accumulator and
visited table; a successor's key decides its **owner** (key lane 0 mod
D), and only the owner deduplicates it against its table.  The shards'
collectives go through one interface (``tpu/mesh_exchange.py``), and the
mesh picks it: a ``ShardMesh``'s
:class:`~dslabs_tpu_torch.tpu.mesh_exchange.LocalExchange` holds the D
shards as the leading dimension of every carry tensor on one device; a
``RankMesh``'s ``ProcessGroupExchange`` runs in each of D ranks
(``tpu/ranks.py``), where the leading dimension is the rank's one shard.
The mesh's width D sets every capacity (the frontier quantum, the
bucket, the ``D * bucket`` received keys, the owner hash), so a rank
overflows and aborts where the same shard of ``LocalExchange`` does;
the shards a process holds (``n_local``, from ``shard0``) set the carry's
leading dimension and every host loop over shards.

* **Carry.**  ``cur`` / ``nxt`` ``[L, F + 1, plane]`` (frontier shards and
  accumulators of the L = ``n_local`` shards held here, ``F`` rows per
  shard plus a dump row), ``visited`` ``[L, V + 1, 4]`` (one table per
  shard), the per-shard counters ``[L]``, ``flag_cnt`` ``[L, nf]`` and
  ``flag_rows`` ``[L, nf, lanes]``;
  with ``record_trace`` the per-row trace meta ``tmeta`` and
  ``flag_meta``; in spill mode the abort code ``f_full`` and the table
  snapshot ``vis_snap``; with delta lanes the level bases ``pb_cur`` /
  ``pb_nxt``.  The chunk index ``j``, the window pass ``evp`` and the
  final-level switch ``noapp`` are host integers: the host drives every
  shard's chunk loop in step.  :data:`CARRY_PARTITION_RULES` says which
  leaves carry the shard dimension.
* **Chunk step** (:meth:`ShardedTensorSearch._make_local_step`), over all
  shards held here at once: chunk ``j`` of every shard is unpacked with
  its level base and expanded by ``_expand_chunk`` over the flat
  ``[L * C]`` batch (one launch of kernel 1); terminal flags per shard;
  each shard routes its unique successors by owner with a stable sort
  into ``[D, bucket]`` buckets (``C * ne`` rows when D = 1, else
  ``(C * ne // D + 1) * 2``, overflow counted as route drops); the
  exchange delivers every destination's buckets in source order (one
  ``all_to_all_many`` of the valid flags, keys and rows: one collective
  on a rank); kernel 2 runs once per shard on its own table with the
  ``D * bucket`` received keys; fresh rows are
  appended to the owner's ``nxt``.  Under the fused row exchange (the
  default) the rows ride with their keys; the legacy exchange returns
  each key's fresh flag to its producer, which appends locally.
* **Drivers.**  ``sharded.superstep`` is one dispatch per level: the host
  issues the level's chunk steps (window passes included) and the
  dispatch returns the fused stats vector (one all-gather of every
  shard's lanes, reduced on the device).  The legacy driver
  (``superstep=False``) dispatches one ``sharded.step`` per chunk, reads
  ``sharded.sync`` once per level and rebalances the frontier at the
  promote (``sharded.promote``): the width-parity oracle.
* **Packing.**  Frontier shards and the exchanged rows hold packed words
  (``derive_packing(..., delta=True)``): delta lanes pack against a level
  base that every shard holds, the minimum over the level's successors
  folded with ``pmin``, and the promote re-encodes against the next one.
* **Steal** (``steal_threshold`` > 0): at a level boundary overfull shards
  give whole chunks of their frontier tail to underfull ones
  (``sharded.steal``); visited tables never move, so counts are unchanged.
* **Checkpoints** in the unified format (``tpu/checkpoint.py``): the
  frontier of every shard and the occupied lines of every table.  A dump
  resumes at any width, on the solo engine, and in either package.  On
  ranks, rank 0 gathers every shard's part (``gather_np``) and writes the
  one dump; every rank reads a dump and keeps its own shard's share.
* **Ranks.**  Every host branch reads replicated values only (the
  all-gathered stats, the psum'd or pmax'd counts, the flag rank 0
  decides with ``agree``: the clock, the cancel event, the dump
  writer's skip), so that every rank issues the same collectives in the
  same order; the steal plan is computed on every rank from the
  all-gathered occupancy; terminal flags and trace meta are gathered.
  Each level record gains ``exchange``: the rank's collectives and the
  bytes it handed them.
* **Spill** (``spill=``): the chunk step aborts globally on a full
  frontier or table (on ranks the abort code is pmax'd), and the host
  drains, evicts and reinjects through ``tpu/spill.py``, as the solo
  engine does.  On ranks the host tier is replicated: each drain's rows,
  keys and keep mask and each eviction's lines are gathered from every
  rank, so every rank's tier, spool and decisions equal the one-process
  engine's, and each rank injects its own share of a segment.

Dispatch tags: ``sharded.init`` (from the root, or a dump),
``sharded.superstep``, ``sharded.step`` and ``sharded.sync`` (legacy
driver), ``sharded.promote``, ``sharded.steal``, ``sharded.spill_drain``,
``sharded.spill_evict``, ``sharded.spill_reinject``.  Before each level's
superstep dispatches the engine publishes ``_dispatch_deadline_scales =
{"superstep": max(1, min(budget, 2 * chunks))}``, which the supervisor's
watchdog and the telemetry spans read.

Deliberate differences from the reference: on a ``ShardMesh`` the D
shards share one device and the exchange is a transpose; a mesh over
distinct devices runs one process per device (``tpu/ranks.py``), not one
program, and there every rank keeps the whole host spill tier; kernel 2
runs once per shard; the superstep's chunk loop is issued from the host,
one chunk index for every shard, so a shard that is done with its chunks
or its window passes steps through empty ones; the reference's
``DSLABS_*`` environment knobs are constructor arguments; packed
successors are the valid rows, packed after one host sync
(``torch.nonzero``), where the reference packs every row; the root's key
goes into its owner's table through kernel 2.
"""

from __future__ import annotations

import math
import re
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from dslabs_tpu_torch.tpu import checkpoint as ckpt_mod
from dslabs_tpu_torch.tpu import kernels
from dslabs_tpu_torch.tpu import packing as packing_mod
from dslabs_tpu_torch.tpu import telemetry as tel_mod
from dslabs_tpu_torch.tpu import visited as visited_mod
from dslabs_tpu_torch.tpu.engine import (VISITED_WARN, CapacityOverflow,
                                         SearchOutcome, TensorProtocol,
                                         TensorSearch, _lex_order,
                                         flatten_state, host_copy,
                                         read_only, to_host)
from dslabs_tpu_torch.tpu.mesh_exchange import (RankMesh, ShardMesh,
                                                card_count)

__all__ = ["ShardedTensorSearch", "make_mesh", "CARRY_PARTITION_RULES",
           "match_partition_rules", "OVERFLOW_FACTOR"]

# Routing-bucket headroom over the mean share when D > 1.
OVERFLOW_FACTOR = 2
# Beam drops past which a run warns (the reference's DSLABS_DROPPED_WARN
# default).
DROPPED_WARN = 1_000_000
EMPTY = visited_mod.EMPTY
# An empty delta base lane (no successor seen yet).
PB_EMPTY = 2 ** 31 - 1


def _shard(axis):
    return axis


# Which carry leaves hold the shard dimension (leading, dim ``axis``) and
# which are host values, one for every shard.  The first matching rule
# wins; a leaf no rule matches is an error, so a new carry entry must
# declare its placement.
CARRY_PARTITION_RULES = (
    (r"^(cur|nxt|tmeta)$", _shard),
    (r"^(visited|vis_snap)$", _shard),
    (r"^(flag_rows|flag_meta|flag_cnt)$", _shard),
    (r"^(pb_cur|pb_nxt)$", _shard),
    (r"^(cur_n|nxt_n|vis_n|explored|overflow|vis_over|drops|f_full"
     r"|fault_cnt)$", _shard),
    (r"^(j|evp|noapp)$", None),
)


def match_partition_rules(rules, names, axis=0) -> dict:
    """Carry leaf names -> their placement: the shard axis for a sharded
    leaf, None for a host value.  The first matching rule wins; an
    unmatched leaf raises."""
    out = {}
    for name in names:
        for pat, spec in rules:
            if re.search(pat, name):
                out[name] = spec(axis) if callable(spec) else spec
                break
        else:
            raise ValueError(
                f"no partition rule for carry leaf {name!r}: add it to "
                "CARRY_PARTITION_RULES")
    return out


def make_mesh(n_devices: Optional[int] = None, device=None) -> ShardMesh:
    """A mesh of ``n_devices`` shards on the card, or on the device the
    caller names; ``None`` means the number of cards (1 on the CPU)."""
    return ShardMesh(card_count(device) if n_devices is None
                     else n_devices, device)


def _first_of_each_key_seg(fp: torch.Tensor, valids: torch.Tensor,
                           seg: torch.Tensor) -> torch.Tensor:
    """The in-chunk sort-unique prefilter within each shard's segment
    (``seg`` [N] shard ids): True at the first occurrence of each key
    among the shard's valid rows, as the reference computes it on each
    device's own chunk."""
    inv = (~valids).to(torch.int32)
    order = _lex_order([seg, inv, fp[:, 0], fp[:, 1], fp[:, 2], fp[:, 3]])
    keys = torch.cat([seg[:, None].to(torch.int32), fp], dim=1)[order]
    first = torch.ones_like(valids)
    first[1:] = torch.any(keys[1:] != keys[:-1], dim=1)
    unique = torch.zeros_like(valids)
    unique[order] = first & valids[order]
    return unique


class ShardedTensorSearch(TensorSearch):
    """BFS over D owner-sharded shards (module docstring); ``run()``
    drives the levels with one superstep dispatch and one stats readback
    per level.

    ``mesh`` is a :class:`ShardMesh` (:func:`make_mesh`); the engine runs
    on its device.  ``chunk_per_device``, ``frontier_cap`` and
    ``visited_cap`` are per shard; ``frontier_cap`` rounds up to a
    multiple of ``lcm(chunk_per_device, D)``.  ``strict`` makes every
    capacity drop fatal; beam runs (``strict=False``) count routing,
    frontier and window drops on ``dropped``.  ``ev_spill`` (default:
    ``strict``) re-steps a chunk at the next event window where the
    window left events.  ``superstep`` (default on) picks the driver,
    ``row_exchange`` (default on, superstep only) the exchange,
    ``mesh_pack`` (default on) the packed wire, ``steal_threshold`` (0 =
    off) the boundary steal's imbalance gate, ``superstep_chunks`` the
    chunk steps per superstep dispatch under a time budget;
    ``aot_warmup`` loads the kernels at construction and reports the
    seconds on ``compile_secs``."""

    def __init__(self, protocol: TensorProtocol, mesh: ShardMesh,
                 chunk_per_device: int = 1 << 10,
                 frontier_cap: int = 1 << 14,
                 visited_cap: int = 1 << 20,
                 max_depth: Optional[int] = None,
                 max_secs: Optional[float] = None,
                 strict: bool = True,
                 ev_budget=None,
                 ev_spill: Optional[bool] = None,
                 record_trace: bool = False,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0,
                 superstep: bool = True,
                 superstep_chunks: int = 16,
                 row_exchange: bool = True,
                 aot_warmup: bool = False,
                 spill=None,
                 telemetry=None,
                 symmetry: Optional[bool] = None,
                 mesh_pack: bool = True,
                 steal_threshold: float = 0.0,
                 sanitize: Optional[str] = None,
                 levels_dir: Optional[str] = None):
        if not isinstance(mesh, (ShardMesh, RankMesh)):
            raise TypeError(f"mesh must be a ShardMesh (make_mesh) or a "
                            f"RankMesh, got {type(mesh).__name__}")
        self.mesh = mesh
        self.n_devices = mesh.width
        self.exchange = mesh.exchange()
        # The shards this process holds: global ids shard0 .. shard0 +
        # n_local - 1 (all D on a ShardMesh, its own one on a rank).
        self.n_local = self.exchange.local_width
        self.shard0 = self.exchange.rank * self.n_local
        quantum = math.lcm(chunk_per_device, self.n_devices)
        if frontier_cap % quantum:
            frontier_cap += quantum - frontier_cap % quantum
        visited_mod.check_cap(visited_cap)
        self.f_cap = frontier_cap
        self.v_cap = visited_cap
        self.cpd = chunk_per_device
        self.ev_spill = strict if ev_spill is None else bool(ev_spill)
        super().__init__(protocol, frontier_cap=frontier_cap,
                         chunk=chunk_per_device, max_depth=max_depth,
                         max_secs=max_secs,
                         in_chunk_dedup=strict and self.n_devices > 1,
                         ev_budget=ev_budget, record_trace=record_trace,
                         visited_cap=visited_cap, strict=strict,
                         checkpoint_path=checkpoint_path,
                         checkpoint_every=checkpoint_every, spill=spill,
                         telemetry=telemetry, packed=False,
                         symmetry=symmetry, device=self.exchange.device,
                         sanitize=sanitize, levels_dir=levels_dir)
        self.mesh_pack = bool(mesh_pack)
        pk = (packing_mod.derive_packing(protocol, self.lanes, delta=True)
              if self.mesh_pack else None)
        self._pk = None if (pk is None or pk.identity) else pk
        self.plane = self._pk.words if self._pk is not None else self.lanes
        if self._pk is not None:
            # The codec's tables go to the device here, not inside the
            # first chunk step (an upload there is a host sync).
            self._pk._consts(self.device)
        self._mesh_delta = self._pk is not None and self._pk.has_delta
        if self._mesh_delta:
            self._delta_lanes = np.asarray(self._pk.delta_lanes, np.int64)
            self._delta_idx = torch.as_tensor(self._delta_lanes,
                                              device=self.device)
        self._steal_threshold = float(steal_threshold)
        self._spill_on = self._spill is not None
        # child fp -> (parent fp, grid event id), uint32 tuples.
        self._fp_map: Dict[tuple, tuple] = {}
        # Spill mode's abort protocol rides the superstep driver.
        self.use_superstep = bool(superstep) or self._spill_on
        # The legacy per-chunk driver is the promote-boundary exchange.
        self.row_exchange = bool(row_exchange) and self.use_superstep
        self._steal_on = (self._steal_threshold > 0.0
                          and self.n_devices > 1 and self.row_exchange)
        self._superstep_chunks = int(superstep_chunks)
        p = protocol
        self._windowed = (self._ev_msg < p.net_cap
                          or self._ev_tmr < p.n_nodes * p.timer_cap)
        ne = self._num_events()
        self._bucket = (self.cpd * ne if self.n_devices == 1
                        else (self.cpd * ne // self.n_devices + 1)
                        * OVERFLOW_FACTOR)
        self._level_records: List[dict] = []
        self._last_per_device: Optional[dict] = None
        self.compile_secs = 0.0
        if aot_warmup:
            self.aot_warmup()

    # ------------------------------------------------- placement helpers

    def _carry_names(self) -> list:
        keys = ["cur", "cur_n", "j", "evp", "noapp", "nxt", "nxt_n",
                "visited", "vis_n", "explored", "overflow", "vis_over",
                "drops", "flag_cnt", "flag_rows"]
        if self.record_trace:
            keys += ["tmeta", "flag_meta"]
        if self._spill_on:
            keys += ["f_full", "vis_snap"]
        if self._mesh_delta:
            keys += ["pb_cur", "pb_nxt"]
        if self._ev_flt:
            keys += ["fault_cnt"]
        return keys

    def _carry_specs(self) -> dict:
        return match_partition_rules(CARRY_PARTITION_RULES,
                                     self._carry_names(), 0)

    def _base_vec(self, pb: torch.Tensor) -> torch.Tensor:
        """``[n_delta]`` level base -> the codec's ``[lanes]`` base vector
        (non-delta lanes read their static ``lo``; their value here is
        ignored)."""
        base = torch.zeros((self.lanes,), dtype=torch.int32,
                           device=pb.device)
        return base.index_copy_(0, self._delta_idx, pb.to(torch.int32))

    def _np_base(self, pb: np.ndarray) -> np.ndarray:
        base = np.zeros((self.lanes,), np.int32)
        base[self._delta_lanes] = np.asarray(pb, np.int32)
        return base

    def _rebalance_slack(self) -> int:
        """Rows a shard may hold past the pre-rebalance maximum after the
        legacy promote's ceil split (none on one shard, none under the
        fused exchange, which has no rebalance)."""
        if self.n_devices == 1 or self.row_exchange:
            return 0
        return self.n_devices - 1

    def _stat_idx(self) -> dict:
        """Slots of the fused stats vector: core 8 (overflow, drops,
        vis_over, explored, vis_max, vis_total, nxt_max, j), the flag
        counts, the tail (shards with chunks left, chunk steps taken, the
        last step's shards with window events left), the spill abort code
        in spill mode, the fault-family counts with a fault model, and
        last the per-shard lanes (explored, vis_n, nxt_n, drops; D
        each)."""
        nf = len(self._flag_names)
        sp = int(self._spill_on)
        return {"flags": 8, "remaining": 8 + nf, "steps": 9 + nf,
                "window": 10 + nf, "f_full": 11 + nf, "faults": 11 + nf + sp}

    # ----------------------------------------------------------- carry

    def _empty_carry_sh(self) -> dict:
        """The carry with every shard this process holds empty."""
        D, F, V = self.n_local, self.f_cap, self.v_cap
        dev = self.device
        nf = len(self._flag_names)

        def z():
            return torch.zeros((D,), dtype=torch.int64, device=dev)

        carry = {
            "cur": torch.zeros((D, F + 1, self.plane), dtype=torch.int32,
                               device=dev),
            "cur_n": z(), "j": 0, "evp": 0, "noapp": 0,
            "nxt": torch.zeros((D, F + 1, self.plane), dtype=torch.int32,
                               device=dev),
            "nxt_n": z(),
            "visited": torch.full((D, V + 1, 4), EMPTY, dtype=torch.int32,
                                  device=dev),
            "vis_n": z(), "explored": z(), "overflow": z(),
            "vis_over": z(), "drops": z(),
            "flag_cnt": torch.zeros((D, nf), dtype=torch.int64, device=dev),
            "flag_rows": torch.zeros((D, nf, self.lanes), dtype=torch.int32,
                                     device=dev),
        }
        if self.record_trace:
            carry["tmeta"] = torch.zeros((D, F + 1, 9), dtype=torch.int32,
                                         device=dev)
            carry["flag_meta"] = torch.zeros((D, nf, 9), dtype=torch.int32,
                                             device=dev)
        if self._spill_on:
            carry["f_full"] = z()
            carry["vis_snap"] = torch.full_like(carry["visited"], EMPTY)
        if self._mesh_delta:
            nd = len(self._delta_lanes)
            carry["pb_cur"] = torch.zeros((D, nd), dtype=torch.int32,
                                          device=dev)
            carry["pb_nxt"] = torch.full((D, nd), PB_EMPTY,
                                         dtype=torch.int32, device=dev)
        if self._ev_flt:
            carry["fault_cnt"] = torch.zeros((D, 4), dtype=torch.int64,
                                             device=dev)
        missing = set(self._carry_names()) ^ set(carry)
        assert not missing, missing
        return carry

    def _build_init(self):
        """``sharded.init`` from the root row: its key (kernel 1, through
        the canonicalize pass) goes into its owner's table through kernel
        2, its row (packed, against its own delta values as the level-0
        base) into its owner's frontier; no host sync."""
        D, L, g0 = self.n_devices, self.n_local, self.shard0
        dev = self.device
        pk, delta = self._pk, self._mesh_delta

        def init(row0):
            carry = self._empty_carry_sh()
            fp0 = kernels.fingerprint_rows(self._canon_rows(row0))
            owner = (fp0[0, 0].to(torch.int64) & 0xFFFFFFFF) % D
            mine = torch.arange(g0, g0 + L, device=dev) == owner
            for d in range(L):
                visited_mod.insert(carry["visited"][d], fp0, mine[d:d + 1])
            if delta:
                pb0 = row0[0].index_select(0, self._delta_idx)
                carry["pb_cur"].copy_(pb0.expand(L, -1))
                row0s = pk.pack(row0, self._base_vec(pb0))
            elif pk is not None:
                row0s = pk.pack(row0)
            else:
                row0s = row0
            carry["cur"][:, 0].copy_(torch.where(mine[:, None], row0s, 0))
            carry["cur_n"].copy_(mine)
            carry["vis_n"].copy_(mine)
            return carry

        return init

    # ----------------------------------------------------- chunk step

    def _make_local_step(self, route_rows: bool = False):
        """The chunk step over every shard's chunk ``j`` at window pass
        ``ev_pass`` (module docstring), updating the carry in place.
        Returns ``(rem, code)``: each shard's events past this pass's
        window ``[D]``, and in spill mode the abort code (bit 0 a shard's
        frontier full, bit 1 a table full; the step then changed
        nothing), else 0.  Host syncs: the count of valid rows before the
        pack when packed; the abort code in spill mode."""
        p = self.p
        D, C, F = self.n_devices, self.cpd, self.f_cap
        L = self.n_local
        ne = self._num_events()
        N = C * ne
        bucket = self._bucket
        rb = D * bucket
        plane = self.plane
        pk, delta = self._pk, self._mesh_delta
        dev = self.device
        ex = self.exchange
        rec = self.record_trace
        spill_on = self._spill_on
        nf = len(self._flag_names)
        # Local shard indices (rows of the carry), and every destination.
        shard_ids = torch.arange(L, device=dev)
        seg = shard_ids.repeat_interleave(N)
        col = torch.arange(C, device=dev)
        slots = torch.arange(bucket, device=dev)
        dest = torch.arange(D, device=dev).expand(L, D).contiguous()

        def step(carry, j: int, ev_pass: int):
            self.chunk_steps += 1
            start = j * C
            rows_chunk = carry["cur"][:, start:start + C].reshape(
                L * C, plane)
            base_cur = (self._base_vec(carry["pb_cur"][0]) if delta
                        else None)
            if pk is not None:
                rows_chunk = pk.unpack(rows_chunk, base_cur)
            valid = ((start + col)[None, :]
                     < carry["cur_n"][:, None]).reshape(L * C)
            (rows, valids, fp, unique, overs, ev_rem, event_ids,
             flags) = self._expand_chunk(rows_chunk, valid, ev_pass,
                                         self._rt_masks, dedup=False,
                                         per_row=True)
            if self._in_chunk_dedup:
                unique = _first_of_each_key_seg(fp, valids, seg)
            rem = ev_rem.reshape(L, C).sum(1)
            if rec:
                # Child key, parent key (the parent row's own fingerprint)
                # and grid event id of every successor row.
                fp_par = kernels.fingerprint_rows(rows_chunk)
                meta = torch.cat([fp, fp_par.repeat_interleave(ne, 0),
                                  event_ids.reshape(-1, 1).to(torch.int32)],
                                 dim=1)

            # ---- terminal flags per shard, checkState order.
            hit_list = [valids & (rows[:, -1] != 0)]
            for n in p.invariants:
                hit_list.append(valids & ~flags[f"inv:{n}"])
            for n in p.goals:
                hit_list.append(flags[f"goal:{n}"])
            hits = torch.stack(hit_list).reshape(nf, L, N)
            cnts = hits.sum(2).t()                              # [L, nf]
            first = (torch.argmax(hits.to(torch.int32), dim=2).t()
                     + shard_ids[:, None] * N)
            fresh_flag = (carry["flag_cnt"] == 0) & (cnts > 0)
            pruned = rows[:, -1] != 0
            for n in p.prunes:
                pruned = pruned | flags[f"prune:{n}"]

            # ---- encode the valid successors once: the same packed rows
            # ride the exchange and the nxt store; out-of-domain values
            # count into the overflow.
            pack_bad = torch.zeros((L,), dtype=torch.int64, device=dev)
            if pk is not None:
                idx = torch.nonzero(valids).squeeze(1)
                packed, bad = pk.pack(rows.index_select(0, idx), base_cur,
                                      count_bad=True)
                rows_store = torch.zeros((L * N, plane), dtype=torch.int32,
                                         device=dev).index_copy_(0, idx,
                                                                 packed)
                pack_bad.index_add_(0, torch.div(idx, N,
                                                 rounding_mode="floor"),
                                    bad.to(torch.int64))
            else:
                rows_store = rows
            if delta:
                dv = rows.index_select(1, self._delta_idx).reshape(L, N, -1)
                dv = torch.where(valids.reshape(L, N, 1), dv, PB_EMPTY)
                pb_nxt = ex.pmin(torch.minimum(carry["pb_nxt"],
                                               dv.amin(1)))

            # ---- route each shard's unique successors by owner.
            owner = torch.where(
                unique, (fp[:, 0].to(torch.int64) & 0xFFFFFFFF) % D,
                D).reshape(L, N)
            owner_s, order = torch.sort(owner, dim=1, stable=True)
            starts = torch.searchsorted(owner_s, dest, side="left")
            ends = torch.searchsorted(owner_s, dest, side="right")
            src = starts[:, :, None] + slots                # [L, D, bkt]
            send_valid = src < ends[:, :, None]
            gidx = (order.gather(1, src.clamp(max=N - 1).reshape(L, -1))
                    .reshape(L, D, bucket) + (shard_ids * N)[:, None, None])
            send = [send_valid, fp[gidx]]                 # [L, D, bkt, 4]
            route_drop = (ends - starts - bucket).clamp(min=0).sum(1)
            if route_rows:
                parts = [rows_store, pruned[:, None].to(torch.int32)]
                if rec:
                    parts.append(meta)
                send.append(torch.cat(parts, dim=1)[gidx])

            # ---- the exchange: each owner receives its buckets from
            # every shard, source order.
            recv = ex.all_to_all_many(send)
            recv_valid = recv[0].reshape(L, rb)
            recv_keys = torch.where(recv_valid[:, :, None],
                                    recv[1].reshape(L, rb, 4), EMPTY)
            if route_rows:
                recv_rows = recv[2].reshape(L, rb, -1)

            # ---- owner-side dedup: kernel 2 once per shard, on its own
            # table; unresolved keys are treated as fresh.
            if spill_on:
                carry["vis_snap"].copy_(carry["visited"])
            ins, unres = [], []
            for d in range(L):
                _, a, b = visited_mod.insert(carry["visited"][d],
                                             recv_keys[d], recv_valid[d])
                ins.append(a)
                unres.append(b)
            ins_s = torch.stack(ins)
            unres_s = torch.stack(unres)
            fresh_s = ins_s | unres_s

            if route_rows:
                app_rows = recv_rows[:, :, :plane]
                app_pruned = recv_rows[:, :, plane] != 0
                app_fresh = fresh_s
                if rec:
                    app_meta = recv_rows[:, :, plane + 1:]
            else:
                # Each key's fresh flag back to its producer, mapped onto
                # the producer's rows (max, so a clipped slot's write
                # never clears a true flag).
                back = ex.all_to_all(fresh_s.reshape(L, D, bucket))
                fresh_rows = torch.zeros((L * N,), dtype=torch.int32,
                                         device=dev).scatter_reduce_(
                    0, gidx.reshape(-1),
                    (back & send_valid).reshape(-1).to(torch.int32),
                    reduce="amax")
                app_rows = rows_store.reshape(L, N, plane)
                app_pruned = pruned.reshape(L, N)
                app_fresh = fresh_rows.reshape(L, N) > 0
                if rec:
                    app_meta = meta.reshape(L, N, 9)

            # ---- append fresh successors to the owner's (fused) or the
            # producer's (legacy) next frontier; none on the final
            # depth-limited level (noapp), which only counts them.
            noapp = bool(carry["noapp"])
            sel_would = app_fresh & ~app_pruned
            sel = app_fresh if spill_on else sel_would
            n_sel = sel.sum(1)
            nxt_n = carry["nxt_n"]
            if spill_on:
                # Any shard's full frontier (bit 0) or table (bit 1)
                # aborts every shard: one readback of the agreed bits.
                c = ex.pmax(torch.stack([
                    (nxt_n + n_sel > F).to(torch.int64),
                    unres_s.any(1).to(torch.int64)], 1))
                code = int(c[0] + 2 * c[1])
                if code:
                    carry["visited"], carry["vis_snap"] = (
                        carry["vis_snap"], carry["visited"])
                    carry["f_full"].fill_(code)
                    return rem, code
            if noapp:
                f_drop = torch.zeros_like(nxt_n)
                carry["nxt_n"] += sel_would.sum(1)
            else:
                spos = torch.cumsum(sel.to(torch.int64), 1) - 1
                dst = nxt_n[:, None] + spos
                sdst = (torch.where(sel & (dst < F), dst, F)
                        + shard_ids[:, None] * (F + 1)).reshape(-1)
                carry["nxt"].view(L * (F + 1), plane).index_copy_(
                    0, sdst, app_rows.reshape(-1, plane))
                if rec:
                    carry["tmeta"].view(L * (F + 1), 9).index_copy_(
                        0, sdst, app_meta.reshape(-1, 9))
                f_drop = (nxt_n + n_sel - F).clamp(min=0)
                carry["nxt_n"] += n_sel - f_drop
            carry["flag_rows"].copy_(torch.where(
                fresh_flag[:, :, None], rows[first], carry["flag_rows"]))
            if rec:
                carry["flag_meta"].copy_(torch.where(
                    fresh_flag[:, :, None], meta[first],
                    carry["flag_meta"]))
            carry["flag_cnt"] += cnts
            carry["vis_n"] += ins_s.sum(1)
            carry["explored"] += valids.reshape(L, N).sum(1)
            carry["overflow"] += overs.reshape(L, N).sum(1) + pack_bad
            carry["vis_over"] += unres_s.sum(1)
            carry["drops"] += route_drop + f_drop + (
                0 if self.ev_spill else rem)
            if self._ev_flt:
                carry["fault_cnt"] += torch.stack([
                    self._fault_chunk_counts(
                        event_ids[d * C:(d + 1) * C],
                        valids[d * N:(d + 1) * N]) for d in range(L)])
            if delta:
                carry["pb_nxt"].copy_(pb_nxt.expand(L, -1))
            return rem, 0

        return step

    def _stats_vec(self, carry, rem: Optional[torch.Tensor], j: int):
        """The fused stats vector on the device (layout:
        :meth:`_stat_idx`); the host fills the ``j`` and ``steps`` slots
        after the readback."""
        # Every shard's lanes in one all-gather; the sums and maxima over
        # shards are taken from the gathered [D, k] block.
        zero = torch.zeros_like(carry["cur_n"])
        lanes = [carry["overflow"], carry["drops"], carry["vis_over"],
                 carry["explored"], carry["vis_n"], carry["nxt_n"],
                 (carry["cur_n"] > j * self.cpd).to(torch.int64),
                 zero if rem is None else (rem > 0).to(torch.int64)]
        if self._spill_on:
            lanes.append(carry["f_full"])
        cols = [torch.stack(lanes, 1), carry["flag_cnt"]]
        if self._ev_flt:
            cols.append(carry["fault_cnt"])
        g = self.exchange.all_gather(torch.cat(cols, 1))
        nf = len(self._flag_names)
        zero = g.new_zeros(())
        core = torch.stack([g[:, 0].sum(), g[:, 1].sum(), g[:, 2].sum(),
                            g[:, 3].sum(), g[:, 4].amax(), g[:, 4].sum(),
                            g[:, 5].amax(), zero])
        k = len(lanes)
        tail = torch.stack([g[:, 6].sum(), zero, g[:, 7].sum()])
        parts = [core, g[:, k:k + nf].sum(0), tail]
        if self._spill_on:
            parts.append(g[:, 8].amax().reshape(1))
        if self._ev_flt:
            parts.append(g[:, k + nf:].sum(0))
        # The per-shard lanes: explored, vis_n, nxt_n, drops; D each.
        parts.append(torch.stack([g[:, 3], g[:, 4], g[:, 5], g[:, 1]])
                     .reshape(-1))
        return torch.cat(parts)

    def _build_superstep(self):
        """``sharded.superstep``: one level's chunk steps (up to
        ``budget``, over chunk indices below ``n_chunks``, the host's
        bound from the largest shard), window passes included, then the
        stats readback.  Returns the host stats vector.  A spill abort
        stops the loop with ``j`` held."""
        step = self._make_local_step(route_rows=self.row_exchange)
        idx = self._stat_idx()
        passes = self._windowed and self.ev_spill

        def superstep(carry, budget: int, n_chunks: int):
            rem = None
            steps = 0
            while carry["j"] < n_chunks and steps < budget:
                rem, code = step(carry, carry["j"], carry["evp"])
                steps += 1
                if code:
                    break
                if passes and bool(self.exchange.pmax(
                        (rem > 0).to(torch.int64)) > 0):
                    carry["evp"] += 1
                else:
                    carry["j"] += 1
                    carry["evp"] = 0
            s = to_host(self._stats_vec(carry, rem, carry["j"]))
            s[7] = carry["j"]
            s[idx["steps"]] = steps
            return s

        return superstep

    def _build_chunk_step(self):
        """``sharded.step`` (legacy driver): one chunk step with the
        legacy exchange; returns the stats vector on the device, read by
        ``sharded.sync``."""
        step = self._make_local_step(route_rows=False)

        def chunk_step(carry, j: int, ev_pass: int):
            rem, _ = step(carry, j, ev_pass)
            return self._stats_vec(carry, rem, j)

        return chunk_step

    # --------------------------------------------------------- promote

    def _build_finish(self):
        """``sharded.promote``: ``nxt`` -> ``cur``.  Under the fused
        exchange (and on one shard) the buffers swap; the legacy exchange
        rebalances: each shard splits its occupied prefix into D
        contiguous shares, one exchange moves them, and each receiver
        compacts what it got.  With delta lanes the first ``n_rows``
        rows of every shard re-encode against the next level's base.
        ``n_rows`` is the host's bound on a shard's promoted rows."""
        D, F = self.n_devices, self.f_cap
        L = self.n_local
        plane = self.plane
        pk, delta = self._pk, self._mesh_delta
        ex = self.exchange
        dev = self.device
        share = F // D
        rebalance = not (D == 1 or self.row_exchange)

        def finish(carry, n_rows: int):
            if not rebalance:
                carry["cur"], carry["nxt"] = carry["nxt"], carry["cur"]
                carry["cur_n"].copy_(carry["nxt_n"])
            else:
                ids = torch.arange(D, device=dev)
                lids = torch.arange(L, device=dev)
                r = torch.arange(share, device=dev)
                nxt_n = carry["nxt_n"]
                per = torch.div(nxt_n + D - 1, D, rounding_mode="floor")
                src = per[:, None, None] * ids[None, :, None] + r
                sv = (r < per[:, None, None]) & (src < nxt_n[:, None, None])
                flat = src.clamp(max=F) + (lids * (F + 1))[:, None, None]
                send = carry["nxt"].view(L * (F + 1), plane)[flat]
                recv, rv = ex.all_to_all_many([send, sv])
                recv = recv.reshape(L, D * share, plane)
                rv = rv.reshape(L, D * share)
                pos = torch.cumsum(rv.to(torch.int64), 1) - 1
                dst = (torch.where(rv, pos, F)
                       + lids[:, None] * (F + 1)).reshape(-1)
                carry["cur"].view(L * (F + 1), plane).index_copy_(
                    0, dst, recv.reshape(-1, plane))
                carry["cur_n"].copy_(rv.sum(1))
            if delta:
                pb_old = carry["pb_cur"][0]
                pb_nxt = carry["pb_nxt"][0]
                pb_new = torch.where(pb_nxt == PB_EMPTY, pb_old, pb_nxt)
                n = min(int(n_rows), F)
                if n:
                    blk = carry["cur"][:, :n].reshape(L * n, plane)
                    raw = pk.unpack(blk, self._base_vec(pb_old))
                    rep, bad = pk.pack(raw, self._base_vec(pb_new),
                                       count_bad=True)
                    occ = (torch.arange(n, device=dev)[None, :]
                           < carry["cur_n"][:, None])
                    carry["cur"][:, :n] = torch.where(
                        occ[:, :, None], rep.reshape(L, n, plane), 0)
                    carry["overflow"] += torch.where(
                        occ, bad.reshape(L, n).to(torch.int64), 0).sum(1)
                carry["pb_cur"].copy_(pb_new.expand(L, -1))
                carry["pb_nxt"].fill_(PB_EMPTY)
            carry["nxt_n"].zero_()
            carry["j"] = 0
            carry["evp"] = 0
            return carry

        return finish

    # ------------------------------------------- boundary work stealing

    def _build_steal(self):
        """``sharded.steal``: one exchange at a level boundary moves
        frontier rows from overfull shards to underfull ones by a host
        plan (``plan[s, r]`` rows shard s gives shard r, each at most one
        chunk).  Donors give their frontier tail, so the kept prefix
        needs no compaction; visited tables never move.  A receiver past
        ``frontier_cap`` drops the excess, counted (the plan never builds
        one)."""
        D, F, K = self.n_devices, self.f_cap, self.cpd
        L, g0 = self.n_local, self.shard0
        plane = self.plane
        ex = self.exchange
        dev = self.device

        def steal(carry, plan):
            # This process's donor rows of the [D, D] plan.
            give = torch.as_tensor(np.asarray(plan)[g0:g0 + L],
                                   device=dev).to(torch.int64)
            ids = torch.arange(L, device=dev)
            offs = torch.arange(K, device=dev)
            cur_n = carry["cur_n"]
            cum = torch.cumsum(give, 1)
            starts = (cur_n[:, None] - cum).clamp(min=0)
            flat = ((starts[:, :, None] + offs).clamp(0, F - 1)
                    + (ids * (F + 1))[:, None, None])
            cur = carry["cur"].view(L * (F + 1), plane)
            send = cur[flat]                              # [L, D, K, plane]
            sv = offs[None, None, :] < give[:, :, None]
            recv, rv = ex.all_to_all_many([send, sv])
            recv = recv.reshape(L, D * K, plane)
            rv = rv.reshape(L, D * K)
            keep_n = cur_n - cum[:, -1]
            pos = torch.cumsum(rv.to(torch.int64), 1) - 1
            dst = torch.where(rv, keep_n[:, None] + pos, F)
            lost = (rv & (dst >= F)).sum(1)
            got = rv.sum(1)
            cur.index_copy_(0, (dst.clamp(max=F)
                                + ids[:, None] * (F + 1)).reshape(-1),
                            recv.reshape(-1, plane))
            cur_n.copy_(keep_n + got - lost)
            carry["drops"] += lost
            return carry

        return steal

    def _steal_plan(self, occ, depth: int) -> Optional[np.ndarray]:
        """The donation plan ``[D, D]`` over the per-shard frontier
        occupancies (from the level's stats readback), or None.  At depth
        1 the lone root's successors split evenly whatever the threshold;
        deeper, a plan needs the imbalance (max / mean) past
        ``steal_threshold`` and moves whole chunks."""
        D, K = self.n_devices, self.cpd
        occ = [int(x) for x in occ]
        total = sum(occ)
        if D == 1 or total < 2:
            return None
        mean = total / D
        fanout = depth == 1
        if not fanout and max(occ) / mean <= self._steal_threshold:
            return None
        target = total // D
        if fanout:
            target = max(1, target)
        donors = [[d, occ[d] - target] for d in range(D) if occ[d] > target]
        recvs = [[d, target - occ[d]] for d in range(D) if occ[d] < target]
        donors.sort(key=lambda x: -x[1])
        recvs.sort(key=lambda x: -x[1])
        plan = np.zeros((D, D), np.int32)
        for d, ex in donors:
            for r_ent in recvs:
                if ex <= 0:
                    break
                r, need = r_ent
                if need <= 0:
                    continue
                amt = min(ex, need, K)
                if not fanout:
                    amt = (amt // K) * K
                if amt <= 0:
                    continue
                plan[d, r] = amt
                ex -= amt
                r_ent[1] -= amt
        return plan if plan.any() else None

    def _maybe_steal(self, carry, depth: int):
        """The boundary steal, after the promote, from the per-shard
        frontier lanes of the level's readback; the level record gets its
        ``steal`` block and the recorder a ``steal`` event."""
        if not self._steal_on:
            return carry
        pdev = self._last_per_device
        if not pdev or pdev.get("frontier") is None:
            return carry
        occ = pdev["frontier"]
        plan = self._steal_plan(occ, depth)
        if plan is None:
            return carry
        carry = self._dispatch("sharded.steal", self._build_steal(), carry,
                               plan)
        moved = int(plan.sum())
        after = [int(o) - int(plan[d].sum()) + int(plan[:, d].sum())
                 for d, o in enumerate(occ)]
        before_m = tel_mod.skew_metrics(occ)
        after_m = tel_mod.skew_metrics(after)
        if self._level_records:
            rec = self._level_records[-1]
            rec["steal"] = {"moved": moved,
                            "imbalance_before": before_m["imbalance"],
                            "imbalance_after": after_m["imbalance"]}
            rec.setdefault("skew", {})["frontier_post_steal"] = after_m
        pdev["frontier"] = after
        tel = self._telemetry
        if tel is not None:
            tel.event("steal", engine="sharded", depth=depth, moved=moved,
                      imbalance_before=round(before_m["imbalance"], 3),
                      imbalance_after=round(after_m["imbalance"], 3))
        return carry

    # ------------------------------------------------------ warm-up etc.

    def aot_warmup(self) -> float:
        """Load the kernel library before the first run (on the card),
        and report the seconds on ``compile_secs`` and as a ``compile``
        event.  The port has no programs to compile ahead of time."""
        from dslabs_tpu_torch.tpu import _build

        t0 = time.time()
        if self.device.type == "cuda":
            _build.lib()
        secs = time.time() - t0
        self.compile_secs += secs
        if self._telemetry is not None:
            self._telemetry.event("compile", engine="sharded",
                                  secs=round(secs, 4), aot=True)
        return secs

    def lane_signature(self):
        """Sharded searches are not lane-packable (``tpu/lanes.py``): None
        tells the service's lane packer to run the job solo."""
        return None

    def dispatch_site_programs(self) -> Dict[str, object]:
        """Every function the level loop dispatches, keyed by its tag,
        for the hot-path audit, around a throwaway carry built from the
        root: the active driver's (``sharded.superstep``, or
        ``sharded.step`` and ``sharded.sync``), ``sharded.promote``,
        ``sharded.init``, with the steal ``sharded.steal``, in spill mode
        the drain, eviction and reinjection; audit-only:
        ``visited.insert`` over one shard's ``D * bucket`` received keys,
        and the codec and canonicalize pass where the engine packs or
        reduces.  The superstep's budget is this engine's: the stats
        readback, and per chunk step the count before the pack (packed),
        the window check (finite window with ``ev_spill``) and the abort
        code (spill); the audited call runs one chunk step.  On a rank
        whose gloo exchange stages card tensors through the host, each
        collective of a site adds its staging's syncs (the copy out and
        the copy back)."""
        C, D, dev = self.cpd, self.n_devices, self.device
        stage = 2 * int(self.exchange.staged)
        window = int(self._windowed and self.ev_spill)
        delta = int(self._mesh_delta)
        row0 = flatten_state(self.initial_state())
        init = self._build_init()
        carry = init(row0)
        n_keys = D * self._bucket
        keys = (torch.arange(4 * n_keys, dtype=torch.int64, device=dev)
                * 2654435761 % (1 << 31)).to(torch.int32).reshape(-1, 4)
        step_syncs = (int(self._pk is not None) + int(self._spill_on))
        sites: Dict[str, object] = {
            "sharded.init": dict(fn=init, args=(row0,),
                                 builder=self._build_init),
            "sharded.promote": dict(fn=self._build_finish(),
                                    args=(carry, 1),
                                    builder=self._build_finish),
            "visited.insert": dict(
                fn=visited_mod.insert,
                args=(carry["visited"][0], keys,
                      torch.ones((n_keys,), dtype=torch.bool, device=dev)),
                builder=lambda: visited_mod.insert),
        }
        if self.use_superstep:
            # Collectives: the level base's pmin (delta lanes), the
            # exchange, the abort code's pmax (spill), the window check's
            # pmax, the stats all-gather.
            sites["sharded.superstep"] = dict(
                fn=self._build_superstep(), args=(carry, 1 << 30, 1),
                syncs=1 + step_syncs + window
                + stage * (delta + 2 + window + int(self._spill_on)),
                builder=self._build_superstep)
        else:
            # Collectives: the pmin, the exchange of keys, the fresh
            # flags' way back, the stats all-gather.
            sites["sharded.step"] = dict(
                fn=self._build_chunk_step(), args=(carry, 0, 0),
                syncs=step_syncs + stage * (delta + 3),
                builder=self._build_chunk_step)
            sites["sharded.sync"] = dict(
                fn=to_host, args=(self._stats_vec(carry, None, 0),))
        if self._steal_on:
            plan = np.zeros((D, D), np.int32)
            plan[0, 1 % D] = min(1, C)
            sites["sharded.steal"] = dict(fn=self._build_steal(),
                                          args=(carry, plan),
                                          builder=self._build_steal)
        if self._spill_on:
            # One row to drain from every shard (so that each rank's
            # fetch copies rows).
            counts = [1] * D
            seg = host_copy(carry["cur"][0, :1])
            if self._mesh_delta:
                seg = self._pk.unpack_np(seg, self._np_base(
                    host_copy(carry["pb_cur"][0])))
            sites["sharded.spill_drain"] = [
                dict(name="fetch", fn=self._sh_spill_fetch,
                     args=(carry, counts)),
                dict(name="reset", fn=_sh_reset_nxt, args=(carry,),
                     syncs=0)]
            sites["sharded.spill_evict"] = [
                dict(name="fetch", fn=self._sh_fetch_occupied,
                     args=(carry,)),
                dict(name="reset", fn=_sh_reset_tables, args=(carry,),
                     syncs=0)]
            sites["sharded.spill_reinject"] = dict(
                fn=self._sh_inject_rows, args=(carry, seg),
                syncs=1 + int(self._mesh_delta))
            hg = self.exchange.host_gather_syncs
            if hg:
                # An NCCL rank's host gathers pass through its card.
                sites["sharded.spill_drain"][0]["syncs"] = 3 + 3 * hg
                sites["sharded.spill_evict"][0]["syncs"] = 1 + hg
        if self._pk is not None:
            pk = self._pk
            rows = row0.expand(C, -1).contiguous()
            if self._mesh_delta:
                base = self._base_vec(carry["pb_cur"][0])
                sites["packing.pack"] = dict(
                    fn=pk.pack, args=(rows, base), builder=lambda: pk.pack)
                sites["packing.unpack"] = dict(
                    fn=pk.unpack, args=(pk.pack(rows, base), base),
                    builder=lambda: pk.unpack)
            else:
                sites["packing.pack"] = dict(fn=pk.pack, args=(rows,),
                                             builder=lambda: pk.pack)
                sites["packing.unpack"] = dict(
                    fn=pk.unpack, args=(pk.pack(rows),),
                    builder=lambda: pk.unpack)
        if self._canon is not None:
            from dslabs_tpu_torch.tpu.symmetry import build_canonicalizer

            rows = row0.expand(C, -1).contiguous()
            sites["symmetry.canonicalize"] = dict(
                fn=self._canon, args=(rows,),
                builder=lambda: build_canonicalizer(self.p, self._off))
        if stage:
            # A staging rank's sites over the registry's budgets: the
            # legacy promote's exchange, the steal's exchange.
            sites["sharded.promote"]["syncs"] = stage * int(
                D > 1 and not self.row_exchange)
            if "sharded.steal" in sites:
                sites["sharded.steal"]["syncs"] = 1 + stage
        return sites

    # ------------------------------------------------------ verdicts

    def _terminal_from_flags(self, carry, explored: int, vis_total: int,
                             depth: int, t0: float
                             ) -> Optional[SearchOutcome]:
        """The first fired flag in checkState order, from the first shard
        that fired it (one readback of the flag counts, rows and, when
        recording, meta); with ``record_trace`` its trace is walked back
        through the fingerprint map."""
        nf = len(self._flag_names)
        ex = self.exchange
        cnts = to_host(ex.all_gather(carry["flag_cnt"])).reshape(
            self.n_devices, nf)
        if not cnts.any():
            return None
        rows = to_host(ex.all_gather(carry["flag_rows"]))
        metas = (to_host(ex.all_gather(carry["flag_meta"])).view(np.uint32)
                 if self.record_trace else None)
        for fi, fname in enumerate(self._flag_names):
            devs = np.nonzero(cnts[:, fi])[0]
            if not len(devs):
                continue
            st = self._host_state(rows[devs[0], fi][None])
            trace = None
            if metas is not None:
                m = metas[devs[0], fi]
                trace = self._walk_fp_chain(
                    tuple(int(x) for x in m[4:8]), int(m[8]))
            elapsed = time.time() - t0
            if fname == "exc":
                return SearchOutcome(
                    "EXCEPTION_THROWN", explored, vis_total, depth, elapsed,
                    violating_state=st, exception_code=int(st["exc"][0]),
                    trace=trace)
            kind, pname = fname.split(":", 1)
            if kind == "inv":
                return SearchOutcome(
                    "INVARIANT_VIOLATED", explored, vis_total, depth,
                    elapsed, violating_state=st, predicate_name=pname,
                    trace=trace)
            return SearchOutcome(
                "GOAL_FOUND", explored, vis_total, depth, elapsed,
                goal_state=st, predicate_name=pname, trace=trace)
        return None

    def _sync_checks(self, carry, s: np.ndarray, depth: int, t0: float):
        """The checks of one stats readback ``s``: semantic overflow
        (raise), strict drops (raise), terminal flags, the table guards.
        Returns ``(outcome or None, explored, vis_total, drops,
        nxt_max)``; keeps the per-shard lanes for the level record."""
        nf = len(self._flag_names)
        (overflow, drops, vis_over, explored, vis_max, vis_total,
         nxt_max) = (int(x) for x in s[:7])
        flag_counts = s[8:8 + nf]
        D = self.n_devices
        pd = [int(x) for x in s[len(s) - 4 * D:]]
        self._last_per_device = {
            "explored": pd[:D], "vis_n": pd[D:2 * D],
            "frontier": pd[2 * D:3 * D], "drops": pd[3 * D:]}
        self._vis_over = vis_over
        if self._ev_flt:
            # Cumulative in the carry: overwrite, never add.
            f0 = self._stat_idx()["faults"]
            self._fault_counts[:] = s[f0:f0 + 4]
        limit = (3 * self.v_cap // 4
                 if self.strict and not self._spill_on else self.v_cap)
        self._last_load = vis_max / self.v_cap
        self._last_vis_max = vis_max
        if (vis_max >= int(VISITED_WARN * limit)
                and not getattr(self, "_warned_visited", False)):
            self._warned_visited = True
            warnings.warn(
                f"{self.p.name}: visited table at {vis_max}/{self.v_cap} "
                f"per shard (load {self._last_load:.0%}) at depth {depth}: "
                "capacity pressure; "
                + ("the spill tier will evict to host RAM"
                   if self._spill_on else
                   "raise visited_cap or enable the spill tier "
                   "(spill=True) before this becomes CapacityOverflow"),
                RuntimeWarning, stacklevel=3)
        if self._spill_on:
            vis_total = self._spill.unique(vis_total)
        if overflow:
            raise CapacityOverflow(
                f"{self.p.name}: net_cap={self.p.net_cap}, timer_cap="
                f"{self.p.timer_cap}, or max_live_sends="
                f"{self.p.max_live_sends} overflowed at depth {depth} "
                f"({overflow} semantic drops); raise the caps")
        if drops and self.strict:
            raise CapacityOverflow(
                f"{self.p.name}: {drops} capacity drops at depth {depth} "
                f"(routing bucket or frontier cap {self.f_cap}/shard; "
                "raise caps or run strict=False for beam-style "
                "truncation)")
        if flag_counts.any():
            out = self._terminal_from_flags(carry, explored, vis_total,
                                            depth, t0)
            if out is not None:
                out.dropped = drops
                out.visited_overflow = vis_over
                return out, explored, vis_total, drops, nxt_max
        if self._spill_on:
            if vis_over:
                raise AssertionError(
                    "spill mode committed unresolved keys (abort "
                    "contract violated)")
            return None, explored, vis_total, drops, nxt_max
        if vis_over and self.strict:
            raise CapacityOverflow(
                f"{self.p.name}: visited hash table full at depth {depth} "
                f"({vis_over} unresolved keys, cap {self.v_cap}/shard); "
                "raise visited_cap or run strict=False for sound "
                "treat-as-fresh degradation")
        if self.strict and vis_max > 3 * self.v_cap // 4:
            raise CapacityOverflow(
                f"{self.p.name}: visited hash table > 75% full "
                f"({vis_max}/{self.v_cap} per shard) at depth {depth}; "
                "raise visited_cap")
        return None, explored, vis_total, drops, nxt_max

    def _limit_outcome(self, cond: str, carry, depth: int,
                       t0: float) -> SearchOutcome:
        """A TIME / DEPTH outcome from the carry's counters (one
        readback)."""
        c = to_host(torch.stack([self.exchange.psum(carry[k]) for k in (
            "explored", "vis_n", "drops", "vis_over")]))
        unique = int(c[1])
        if self._spill_on:
            unique = self._spill.unique(unique)
        return SearchOutcome(
            cond, int(c[0]), unique, depth, time.time() - t0,
            dropped=int(c[2]), samples=self._deep_samples,
            visited_overflow=int(c[3]))

    # ------------------------------------------------------- traces

    def _spill_tmeta(self, carry) -> None:
        """Fold this level's appended (child fp, parent fp, event) rows
        into the host fingerprint map, first occurrence winning, and
        sample a few of their traces (``samples``)."""
        counts = self._last_per_device["frontier"]
        meta = to_host(carry["tmeta"]).view(np.uint32)
        g0 = self.shard0
        rows = np.concatenate(self.exchange.gather_np(
            [meta[d, :counts[g0 + d]] for d in range(self.n_local)]))
        if not len(rows):
            return
        children = list(map(tuple, rows[:, :4].tolist()))
        parents = list(map(tuple, rows[:, 4:8].tolist()))
        events = rows[:, 8].tolist()
        # In place, in row order: an entry already in the map, or an
        # earlier row of this level, wins (the map is not copied).
        fp_map = self._fp_map
        for child, parent, event in zip(children, parents, events):
            if child not in fp_map:
                fp_map[child] = (parent, event)
        samples = []
        for i in sorted({0, len(rows) // 2, len(rows) - 1}):
            tr = self._walk_fp_chain(parents[i], int(events[i]))
            if tr is not None:
                samples.append(tr)
        if samples:
            self._deep_samples = samples

    def _walk_fp_chain(self, parent_fp, event_id) -> Optional[list]:
        """(parent fp, event) -> grid event ids root-first, walking the
        fingerprint map back to the run's root."""
        events = [event_id]
        fp = parent_fp
        seen = 0
        while fp != self._root_fp:
            ent = self._fp_map.get(fp)
            if ent is None:
                return None
            fp, ev = ent
            events.append(ev)
            seen += 1
            if seen > 10 ** 6:
                return None
        events.reverse()
        return events

    # ------------------------------------------------------ checkpoints

    def _save_checkpoint(self, carry, depth: int, elapsed: float) -> None:
        """Copy the live search state to the host (every shard's occupied
        frontier prefix, in its native encoding, and every table's
        occupied lines, shard order) and write the unified dump in the
        background; skipped while the previous dump is still being
        written.  On ranks, rank 0 gathers every shard's part and writes
        the one dump (and decides the skip)."""
        ex = self.exchange
        if ex.agree(self._ckpt_writer.busy()):
            return
        L = self.n_local
        cur_n = to_host(carry["cur_n"])
        frontier = np.concatenate(ex.gather_np(
            [host_copy(carry["cur"][d, :int(cur_n[d])]) for d in range(L)]))
        table = to_host(carry["visited"])
        keys = np.concatenate(ex.gather_np(
            [visited_mod.host_occupied(table[d]) for d in range(L)]))
        c = to_host(torch.stack([ex.psum(carry[k]) for k in (
            "explored", "vis_over", "drops")]))
        extra = None
        if self._pk is not None:
            extra = {"frontier_encoding": np.bytes_(
                self._pk.signature().encode())}
            if self._mesh_delta:
                extra["pack_base"] = self._np_base(
                    host_copy(carry["pb_cur"][0]))
        fp_map = None
        if self.record_trace and self._fp_map:
            fp_map = np.asarray([k + v[0] + (v[1],)
                                 for k, v in self._fp_map.items()],
                                dtype=np.int64)
        ck = ckpt_mod.SearchCheckpoint(
            fingerprint=self._ckpt_fingerprint(), depth=depth,
            explored=int(c[0]), elapsed=elapsed, frontier=frontier,
            visited_keys=keys, vis_over=int(c[1]), dropped=int(c[2]),
            fp_map=fp_map, extra=extra)
        if ex.rank != 0:
            return
        self._ckpt_writer.kick(
            lambda: ckpt_mod.save(self.checkpoint_path, ck,
                                  levels_dir=self.levels_dir))

    def _load_checkpoint(self):
        """-> (carry, depth, elapsed), or None without a dump.  A dump of
        another configuration raises ``CheckpointMismatch``.  Spill mode:
        the dump's keys go into the host tier, the frontier past the
        first ``D * frontier_cap`` rows into the spool."""
        ck = self._load_ckpt()
        if ck is None:
            return None
        if ck.fp_map is not None:
            self._fp_map = {tuple(r[:4]): (tuple(r[4:8]), int(r[8]))
                            for r in ck.fp_map.tolist()}
        if self._spill_on:
            import dataclasses

            sp = self._spill
            sp.restore(ck.visited_keys, ck.extra)
            rows = np.asarray(ck.frontier, np.int32)
            spool_rows = rows
            if self._pk is not None and not self._mesh_delta:
                spool_rows = self._pk.pack_np(rows)
            segcap = self.n_devices * self.f_cap
            for i in range(segcap, len(rows), segcap):
                sp.spool_cur.push(spool_rows[i:i + segcap])
            ck = dataclasses.replace(
                ck, frontier=rows[:segcap],
                visited_keys=np.zeros((0, 4), np.uint32))
        carry = self._dispatch("sharded.init", self._resume_carry, ck)
        return carry, ck.depth, ck.elapsed

    def _resume_carry(self, ck) -> dict:
        """The carry of a dump at this width: the frontier rows (raw,
        re-encoded here, with a fresh delta base: the minimum over the
        rows) split into contiguous per-shard shares, each key inserted
        into its owner's table by kernel 2, the counters on shard 0.  A
        rank keeps its own shard's share."""
        D, F, lanes = self.n_devices, self.f_cap, self.lanes
        L, g0 = self.n_local, self.shard0
        n = len(ck.frontier)
        if -(-n // D) > F:
            raise CapacityOverflow(
                f"{self.p.name}: frontier_cap {F}/shard too small to "
                f"resume {n} checkpointed frontier rows on {D} shards")
        frontier = np.asarray(ck.frontier, np.int32).reshape(-1, lanes)
        pb0 = None
        if self._mesh_delta:
            didx = self._delta_lanes
            pb0 = (frontier[:, didx].min(axis=0).astype(np.int32) if n
                   else np.zeros((len(didx),), np.int32))
            spans = frontier[:, didx].astype(np.int64) - pb0
            win = ((1 << self._pk.width[didx].astype(np.int64)) - 1
                   - self._pk.sent[didx].astype(np.int64))
            if n and (spans > win[None, :]).any():
                raise CapacityOverflow(
                    f"{self.p.name}: resumed frontier spans a delta "
                    "window wider than the declared Field(delta=) bits; "
                    "raise the delta bits on the offending field")
            frontier = self._pk.pack_np(frontier, self._np_base(pb0))
        elif self._pk is not None:
            frontier = self._pk.pack_np(frontier)
        carry = self._empty_carry_sh()
        dev = self.device
        per = max(1, -(-n // D))
        buf = np.zeros((L, per, self.plane), np.int32)
        for d in range(L):
            part = frontier[(g0 + d) * per:(g0 + d + 1) * per]
            buf[d, :len(part)] = part
        carry["cur"][:, :per] = torch.from_numpy(buf).to(dev)
        carry["cur_n"].copy_(torch.clamp(
            n - torch.arange(g0, g0 + L, device=dev) * per, 0, per))
        keys = np.ascontiguousarray(ck.visited_keys, dtype=np.uint32)
        owner = (keys[:, 0].astype(np.uint64) % np.uint64(D)).astype(
            np.int64)
        counts = []
        for d in range(L):
            g = keys[owner == g0 + d]
            if not len(g):
                counts.append(torch.zeros((2,), dtype=torch.int64,
                                          device=dev))
                continue
            gk = torch.from_numpy(g.view(np.int32)).to(dev)
            _, ins, unres = visited_mod.insert(
                carry["visited"][d], gk,
                torch.ones((len(g),), dtype=torch.bool, device=dev))
            counts.append(torch.stack([ins.sum(), unres.sum()]))
        c = torch.stack(counts)
        n_unres = int(self.exchange.psum(c[:, 1]))
        if n_unres:
            raise CapacityOverflow(
                f"{self.p.name}: visited_cap={self.v_cap}/shard too small "
                f"to rebuild the checkpoint's visited set ({n_unres} keys "
                "unresolved); raise visited_cap")
        carry["vis_n"].copy_(c[:, 0])
        if g0 == 0:
            carry["explored"][0] = ck.explored
            carry["vis_over"][0] = ck.vis_over
            carry["drops"][0] = ck.dropped
        if self._mesh_delta:
            carry["pb_cur"].copy_(torch.from_numpy(pb0).to(dev).expand(
                L, -1))
        return carry

    # ------------------------------------------- host-RAM spill tier
    #
    # The sharded half of tpu/spill.py: the solo engine's drain / evict /
    # refilter / reinject protocol over every shard at once.  Each round
    # trip is dispatched under its ``sharded.spill_*`` tag: a read-only
    # fetch, then the in-place reset.

    @read_only
    def _sh_spill_fetch(self, carry, counts):
        """Every shard's first ``counts[d]`` nxt rows (one batch), their
        keys (kernel 1) and keep mask, on the host (three copies), in
        shard order; on ranks each rank's part is gathered, so that every
        rank's host tier sees the whole batch.  The rows come back in the
        spool's encoding: packed where the descriptor has no delta lanes,
        raw otherwise."""
        g0 = self.shard0
        mine = [int(counts[g0 + d]) for d in range(self.n_local)]
        rows_d = torch.cat([carry["nxt"][d, :mine[d]]
                            for d in range(self.n_local)])
        pk = self._pk
        if pk is None:
            raw = rows_d
        elif self._mesh_delta:
            raw = pk.unpack(rows_d, self._base_vec(carry["pb_cur"][0]))
        else:
            raw = pk.unpack(rows_d)
        spool = rows_d if (pk is not None and not self._mesh_delta) \
            else raw
        out = (host_copy(spool),
               self._spill_keys_of(raw, self.n_devices * self.f_cap)
               .cpu().numpy(),
               self._spill_keep_mask(raw).cpu().numpy())
        cuts = np.cumsum(mine)[:-1]
        return tuple(np.concatenate(self.exchange.gather_np(
            np.split(a, cuts))) for a in out)

    @read_only
    def _sh_fetch_occupied(self, carry) -> np.ndarray:
        """The eviction's fetch: every shard's occupied table lines (one
        readback of the tables), shard order; gathered from every rank on
        ranks."""
        table = to_host(carry["visited"])
        return np.concatenate(self.exchange.gather_np(
            [visited_mod.host_occupied(table[d])
             for d in range(self.n_local)]))

    def _sh_spill_drain(self, carry) -> None:
        """Drain every shard's nxt through the host tier's refilter into
        the spool (the host half on the ordered drain worker), then reset
        nxt."""
        sp = self._spill
        counts = self._last_per_device["frontier"]
        if sum(counts):
            rows, keys, keep = self._dispatch(
                "sharded.spill_drain", self._sh_spill_fetch, carry, counts)

            def host_half():
                idx = sp.refilter(
                    np.arange(len(rows), dtype=np.int32)[:, None],
                    keys)[:, 0]
                sp.spool(rows[idx[keep[idx]]])

            sp.submit_drain(host_half)
        self._dispatch("sharded.spill_drain", _sh_reset_nxt, carry)
        self._last_per_device["frontier"] = [0] * self.n_devices

    def _sh_spill_evict(self, carry) -> None:
        """Every shard's occupied table lines to the host tier; every
        table restarts empty."""
        sp = self._spill
        occ = self._dispatch("sharded.spill_evict", self._sh_fetch_occupied,
                             carry)
        sp.submit_drain(lambda: sp.evict(occ))
        self._last_vis_max = 0
        self._dispatch("sharded.spill_evict", _sh_reset_tables, carry)

    def _sh_inject_rows(self, carry, rows: np.ndarray) -> int:
        """A host segment (the spool's encoding) becomes the live cur, in
        contiguous per-shard shares (a rank takes its own shard's);
        returns the largest share.  A delta segment re-encodes against
        the current level base (a value outside its window raises)."""
        D, F, lanes = self.n_devices, self.f_cap, self.lanes
        L, g0 = self.n_local, self.shard0
        dev = self.device
        n = len(rows)
        per = max(1, -(-n // D))
        if per > F:
            raise CapacityOverflow(
                f"{self.p.name}: spool segment of {n} rows exceeds "
                f"frontier_cap {F}/shard on {D} shards")
        if self._mesh_delta and n:
            rows = np.asarray(rows, np.int32).reshape(-1, lanes)
            pb = host_copy(carry["pb_cur"][0])
            spans = (rows[:, self._delta_lanes].astype(np.int64)
                     - pb.astype(np.int64))
            win = ((1 << self._pk.width[self._delta_lanes].astype(
                np.int64)) - 1
                - self._pk.sent[self._delta_lanes].astype(np.int64))
            if (spans < 0).any() or (spans > win[None, :]).any():
                raise CapacityOverflow(
                    f"{self.p.name}: spill re-inject found delta-lane "
                    "values outside the window from the current level "
                    "base; raise the Field(delta=) bits (spill defers "
                    "re-basing, so deep spilled runs need wider windows)")
            rows = self._pk.pack_np(rows, self._np_base(pb))
        buf = np.zeros((L, per, self.plane), np.int32)
        for d in range(L):
            part = rows[(g0 + d) * per:(g0 + d + 1) * per]
            buf[d, :len(part)] = part
        carry["cur"][:, :per] = torch.from_numpy(buf).to(dev)
        carry["cur_n"].copy_(torch.clamp(
            n - torch.arange(g0, g0 + L, device=dev) * per, 0, per))
        carry["j"] = 0
        carry["evp"] = 0
        carry["f_full"].zero_()
        return min(per, n)

    def _sh_spill_inject(self, carry, rows: np.ndarray) -> int:
        return self._dispatch("sharded.spill_reinject",
                              self._sh_inject_rows, carry, rows)

    def _sh_spill_ckpt(self, carry, depth: int, explored: int,
                       elapsed: float) -> None:
        """Synchronous spill-mode dump: visited keys = every shard's
        table with the host tier, frontier = the spooled next level (the
        encoding marker when the spool is packed)."""
        sp = self._spill
        occ = self._sh_fetch_occupied(carry)
        if self.exchange.rank != 0:
            return
        spool_packed = self._pk is not None and not self._mesh_delta
        extra = dict(sp.checkpoint_extra() or {})
        if spool_packed:
            extra["frontier_encoding"] = np.bytes_(
                self._pk.signature().encode())
        ckpt_mod.save(self.checkpoint_path, ckpt_mod.SearchCheckpoint(
            fingerprint=self._ckpt_fingerprint(), depth=depth,
            explored=explored, elapsed=elapsed,
            frontier=sp.spool_cur.concat(
                self.plane if spool_packed else self.lanes),
            visited_keys=sp.checkpoint_keys(occ), extra=extra or None),
            levels_dir=self.levels_dir)

    # ----------------------------------------------------------------- run

    def run(self, check_initial: bool = True,
            initial: Optional[dict] = None,
            resume: bool = False) -> SearchOutcome:
        """Run the sharded BFS.  ``initial`` (a batch-1 state dict) starts
        from that state instead of the protocol's initial state (staged
        searches); ``resume=True`` continues from ``checkpoint_path``
        when a dump of this configuration is there, whatever width wrote
        it."""
        self._maybe_sanitize()
        t0 = time.time()
        self._resumed_from_depth = 0
        state = self._initial_or(initial)
        self._trace_root = {k: v.cpu().numpy() for k, v in state.items()}
        self._fp_map = {}
        self._deep_samples = None
        self._level_records = []
        self._last_per_device = None
        self._vis_over = 0
        self._fault_counts[:] = 0
        self._pd_prev_explored = [0] * self.n_devices
        self._root_fp = tuple(to_host(self._canonical_root_fp(state))
                              .view(np.uint32)[0].tolist())
        if check_initial:
            out = self._check_initial(state, t0)
            if out is not None:
                return out
        tel = self._telemetry
        if tel is not None and self._spill is not None:
            self._spill.telemetry = tel
        try:
            out = self._run_levels(t0, state, resume)
            out.levels = self._level_records or None
            out.compile_secs = round(self.compile_secs, 3)
            out.resumed_from_depth = self._resumed_from_depth
            self._stamp_capacity(out)
            self._stamp_faults(out)
            if self._spill_on:
                self._spill.attach(out)
            if tel is not None:
                if out.trace_id is None:
                    out.trace_id = tel.trace_id
                tel.on_outcome(out, engine="sharded")
                if self.n_devices > 1 and self._pk is None:
                    tel.event("mesh_unpacked", engine="sharded",
                              protocol=self.p.name,
                              mesh_width=self.n_devices,
                              reason=("knob" if not self.mesh_pack
                                      else "identity descriptor"),
                              wire_lanes=self.lanes)
            if out.dropped and out.dropped >= DROPPED_WARN:
                warnings.warn(
                    f"{self.p.name}: beam truncation dropped "
                    f"{out.dropped} states (>= {DROPPED_WARN}); the "
                    "verdict covers a narrowed space: raise frontier_cap "
                    "or enable the spill tier for zero-drop coverage",
                    RuntimeWarning, stacklevel=2)
        finally:
            self._join_ckpt_writer()
        # No rank leaves before rank 0's last dump is on disk (a next job
        # or rung of the same ranks may read it).
        self.exchange.agree(True)
        return out

    def _run_levels(self, t0: float, state, resume: bool) -> SearchOutcome:
        resumed = self._load_checkpoint() if resume else None
        if resumed is not None:
            carry, depth, prev_elapsed = resumed
            t0 = time.time() - prev_elapsed
            ex = self.exchange
            c = to_host(torch.stack([
                ex.pmax(carry["cur_n"]), ex.psum(carry["explored"]),
                ex.psum(carry["vis_n"]), ex.psum(carry["drops"])]))
            max_n, explored, vis_total, drops = (int(x) for x in c)
            if self._spill_on:
                vis_total = self._spill.unique(vis_total)
            self._last_per_device = {"frontier": to_host(
                ex.all_gather(carry["cur_n"])).tolist()}
            self._pd_prev_explored = [explored] + [0] * (self.n_devices - 1)
        else:
            if self._spill_on:
                self._spill.reset_run()
            carry = self._dispatch("sharded.init", self._build_init(),
                                   flatten_state(state))
            depth = 0
            max_n = 1
            explored, vis_total, drops = 0, 1, 0
        superstep = self._build_superstep() if self.use_superstep else None
        chunk_step = None if self.use_superstep else \
            self._build_chunk_step()
        finish = self._build_finish()
        while max_n > 0:
            if self.max_depth is not None and depth >= self.max_depth:
                return self._limit_outcome("DEPTH_EXHAUSTED", carry, depth,
                                           t0)
            if self._time_up(t0):
                out = self._limit_outcome("TIME_EXHAUSTED", carry, depth,
                                          t0)
                out.cancelled = self._cancelled()
                return out
            depth += 1
            self._current_depth = depth
            t_lvl = time.time()
            noapp_level = (self.max_depth is not None
                           and depth >= self.max_depth)
            if noapp_level and not self._spill_on:
                carry["noapp"] = 1
            if self.use_superstep:
                (out, explored, vis_total, drops, max_n,
                 chunks) = self._level_superstep(superstep, carry, depth,
                                                 t0, max_n)
            else:
                (out, explored, vis_total, drops, max_n,
                 chunks) = self._level_chunks(chunk_step, carry, depth, t0,
                                              max_n)
            if out is not None:
                return out
            if self._spill_on:
                while True:
                    seg = self._spill.pop_current()
                    if seg is None:
                        break
                    per = self._sh_spill_inject(carry, seg)
                    (out, explored, vis_total, drops, max_n,
                     ch2) = self._level_superstep(superstep, carry, depth,
                                                  t0, per)
                    chunks += ch2
                    if out is not None:
                        return out
            self._record_level(depth, chunks, t_lvl, explored, vis_total,
                               max_n)
            if noapp_level and self._spill_on:
                self._sh_spill_drain(carry)
                vis_total = self._spill.unique(int(to_host(
                    self.exchange.psum(carry["vis_n"]))))
                self._spill.barrier()
                remained = sum(len(r) for r in
                               self._spill.spool_next.segments)
                return SearchOutcome(
                    "DEPTH_EXHAUSTED" if remained > 0 else
                    "SPACE_EXHAUSTED", explored, vis_total, depth,
                    time.time() - t0, dropped=drops,
                    samples=self._deep_samples)
            if noapp_level:
                return SearchOutcome(
                    "DEPTH_EXHAUSTED" if max_n > 0 else "SPACE_EXHAUSTED",
                    explored, vis_total, depth, time.time() - t0,
                    dropped=drops, samples=self._deep_samples,
                    visited_overflow=self._vis_over)
            if self.record_trace:
                self._spill_tmeta(carry)
            sp = self._spill
            if self._spill_on and (sp.active or sp.should_evict(
                    self._last_vis_max, self.v_cap)):
                self._sh_spill_drain(carry)
                if sp.should_evict(self._last_vis_max, self.v_cap):
                    self._sh_spill_evict(carry)
                vis_total = sp.unique(int(to_host(
                    self.exchange.psum(carry["vis_n"]))))
                sp.advance_level()
                if not sp.spool_cur.segments:
                    return SearchOutcome(
                        "SPACE_EXHAUSTED", explored, vis_total, depth,
                        time.time() - t0, dropped=drops,
                        samples=self._deep_samples)
                if self._ckpt_due(depth):
                    self._sh_spill_ckpt(carry, depth, explored,
                                        time.time() - t0)
                max_n = self._sh_spill_inject(carry, sp.spool_cur.pop())
                continue
            self._dispatch("sharded.promote", finish, carry,
                           max_n + self._rebalance_slack())
            carry = self._maybe_steal(carry, depth)
            if self._ckpt_due(depth):
                self._save_checkpoint(carry, depth, time.time() - t0)
        return SearchOutcome(
            "SPACE_EXHAUSTED", explored, vis_total, depth,
            time.time() - t0, dropped=drops, samples=self._deep_samples,
            visited_overflow=self._vis_over)

    def _record_level(self, depth: int, chunks: int, t_lvl: float,
                      explored: int, vis_total: int, max_n: int) -> None:
        """The level record (kept on the outcome's ``levels``, handed to
        an attached recorder), from the scalars of the level's readback:
        ``per_device`` has one entry per shard."""
        rec = {"depth": depth, "chunks": int(chunks),
               "wall": round(time.time() - t_lvl, 4),
               "explored": int(explored), "unique": int(vis_total),
               "next_frontier": int(max_n),
               "load_factor": round(getattr(self, "_last_load", 0.0), 4),
               "pack_ratio": (round(self._pk.pack_ratio, 3)
                              if self._pk is not None else 1.0)}
        pdev = self._last_per_device
        if pdev is not None and "explored" in pdev:
            prev = self._pd_prev_explored
            delta = [e - q for e, q in zip(pdev["explored"], prev)]
            self._pd_prev_explored = list(pdev["explored"])
            rec["per_device"] = {
                "explored": delta, "frontier": list(pdev["frontier"]),
                "load_factor": [round(v / self.v_cap, 4)
                                for v in pdev["vis_n"]],
                "drops": list(pdev["drops"])}
            rec["skew"] = {"explored": tel_mod.skew_metrics(delta),
                           "frontier": tel_mod.skew_metrics(
                               pdev["frontier"])}
        if self.p.fault is not None:
            rec["faults"] = self._fault_block()
        ex = self.exchange
        if self.n_local != self.n_devices:
            # A rank's collectives over the level and the bytes it handed
            # them (its own share included).
            prev = getattr(self, "_ex_prev", (0, 0))
            self._ex_prev = (ex.calls, ex.bytes_sent)
            rec["exchange"] = {"calls": ex.calls - prev[0],
                               "bytes_sent": ex.bytes_sent - prev[1]}
        tel = self._telemetry
        if tel is not None:
            hbm = tel_mod.device_memory_stats([self.device])
            if hbm is not None:
                rec["hbm_peak"] = hbm
        self._level_records.append(rec)
        if tel is not None:
            tel.on_level("sharded", rec)

    def _time_up(self, t0: float, cancel: bool = True) -> bool:
        """The clock's (and, with ``cancel``, the portfolio's) cut: past
        ``max_secs``, or cancelled.  On ranks, rank 0's clock decides for
        every rank; a run with neither a budget nor a cancel event issues
        no collective."""
        if self.max_secs is None and (not cancel
                                      or self._cancel_event is None):
            return False
        up = ((self.max_secs is not None
               and time.time() - t0 > self.max_secs)
              or (cancel and self._cancelled()))
        return self.exchange.agree(up)

    def _n_chunks(self, max_n: int) -> int:
        return -(-(max_n + self._rebalance_slack()) // self.cpd)

    def _level_superstep(self, superstep, carry, depth: int, t0: float,
                         max_n: int):
        """One level through ``sharded.superstep`` dispatches: the whole
        level in one without a time budget, ``superstep_chunks`` chunk
        steps per dispatch with one.  The checks run before any time
        return, so a verdict in completed chunks is never hidden.
        Returns ``(outcome or None, explored, vis_total, drops, nxt_max,
        chunk steps)``."""
        budget = ((1 << 30) if self.max_secs is None
                  else max(1, self._superstep_chunks))
        n_chunks = self._n_chunks(max_n)
        # The watchdog (tpu/supervisor.py) stretches a superstep's
        # deadline by the chunk steps it is expected to run (2x for the
        # event window's re-passes); every other site keeps the
        # one-dispatch deadline.
        self._dispatch_deadline_scales = {
            "superstep": float(max(1, min(budget, 2 * n_chunks)))}
        idx = self._stat_idx()
        chunks = 0
        while True:
            s = self._dispatch("sharded.superstep", superstep, carry,
                               budget, n_chunks)
            chunks += int(s[idx["steps"]])
            out, explored, vis_total, drops, nxt_max = self._sync_checks(
                carry, s, depth, t0)
            if out is not None:
                return out, explored, vis_total, drops, nxt_max, chunks
            code = int(s[idx["f_full"]]) if self._spill_on else 0
            if code:
                if (code & 1) and nxt_max == 0:
                    raise CapacityOverflow(
                        f"{self.p.name}: one chunk's fresh successors "
                        f"exceed frontier_cap={self.f_cap}/shard even "
                        f"with spill; lower chunk_per_device ({self.cpd}) "
                        "or raise frontier_cap")
                if (code & 2) and int(s[4]) == 0:
                    raise CapacityOverflow(
                        f"{self.p.name}: one chunk's unique successors "
                        f"exceed visited_cap={self.v_cap}/shard even from "
                        f"empty tables; lower chunk_per_device "
                        f"({self.cpd}) or raise visited_cap")
                self._sh_spill_drain(carry)
                if code & 2:
                    self._sh_spill_evict(carry)
                continue
            if int(s[idx["remaining"]]) == 0:
                return None, explored, vis_total, drops, nxt_max, chunks
            if self._time_up(t0):
                out = self._limit_outcome("TIME_EXHAUSTED", carry, depth,
                                          t0)
                out.cancelled = self._cancelled()
                return out, explored, vis_total, drops, nxt_max, chunks

    def _level_chunks(self, chunk_step, carry, depth: int, t0: float,
                      max_n: int):
        """The legacy per-chunk driver: one ``sharded.step`` per chunk (and
        window pass), one ``sharded.sync`` per level (per step with a
        finite window and ``ev_spill``).  Same return contract as
        :meth:`_level_superstep`."""
        n_chunks = self._n_chunks(max_n)
        passes = self._windowed and self.ev_spill
        widx = self._stat_idx()["window"]
        chunks = 0
        j = ev_pass = 0
        sdev = s = None
        while j < n_chunks:
            sdev = self._dispatch("sharded.step", chunk_step, carry, j,
                                  ev_pass)
            chunks += 1
            s = None
            if passes:
                s = self._dispatch("sharded.sync", to_host, sdev)
                if int(s[widx]) > 0:
                    ev_pass += 1
                    continue
            j += 1
            ev_pass = 0
            if (self.max_secs is not None and j < n_chunks
                    and self._time_up(t0, cancel=False)):
                if s is None:
                    s = self._dispatch("sharded.sync", to_host, sdev)
                res = self._sync_checks(carry, s, depth, t0)
                out = res[0]
                if out is None:
                    out = self._limit_outcome("TIME_EXHAUSTED", carry,
                                              depth, t0)
                return (out,) + res[1:] + (chunks,)
        if s is None:
            s = self._dispatch("sharded.sync", to_host, sdev)
        return self._sync_checks(carry, s, depth, t0) + (chunks,)


# ------------------------------------------------- spill round trips

def _sh_reset_nxt(carry) -> None:
    """The drain's reset: every nxt restarts empty, the abort code
    clears."""
    carry["nxt_n"].zero_()
    carry["f_full"].zero_()


def _sh_reset_tables(carry) -> None:
    """The eviction's reset: every table and ``vis_n`` restart empty, the
    abort code clears."""
    carry["visited"].fill_(EMPTY)
    carry["vis_n"].zero_()
    carry["f_full"].zero_()
