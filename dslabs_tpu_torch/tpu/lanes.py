"""Batched job lanes: L tenant searches advanced by one stream of launches.

Counterpart of ``dslabs_tpu/tpu/lanes.py``.  A small search is dominated
by its dispatch stream, not by its states: a chunk step of the flagship
issues about 10,600 aten ops whatever the number of valid rows it holds.
This module stacks L compatible jobs along a leading lane axis so that
one stream of launches advances all of them.

* **Lane-stacked carry.**  :class:`LaneSearch` holds L jobs' device
  carries with a leading ``[L, ...]`` axis: the frontier buffers ``cur``
  / ``nxt`` ``[L, cap + 1, plane]``, one visited table per lane
  ``[L, V + 1, 4]``, the counters ``[L]``, ``flag_cnt`` ``[L, nf]`` and
  ``flag_rows`` ``[L, nf, lanes]``.
* **Lane step.**  Where the reference runs the solo step body under
  ``jax.vmap`` inside a ``lax.while_loop``, the port's step is driven by
  the host one chunk index at a time and updates its carry in place.  So
  the lane step reads chunk ``j`` of every lane as one flat ``[L * C]``
  batch and runs the solo step's own unpack, ``_expand_chunk``, kernel 1
  and pack over it: one stream of launches for all L lanes.  The parts
  that are per search in the solo step run segmented by lane: the window
  remainder, the overflow, the first terminal hit per flag, the frontier
  append positions and every counter.  Kernel 2 runs once per lane, on
  that lane's table view ``visited[l]`` and its keys (both contiguous,
  no copies): the same batch size as the solo insert, hence the same
  reservation and tail sizes and the same tie-breaks, so each lane's
  table is bit-identical to its solo run's.  The packed append keeps the
  solo step's one host sync (``torch.nonzero``) for all L lanes.
* **One superstep per level.**  ``lanes.superstep`` is one dispatch per
  level: the host loops over the chunk index while any lane has an
  unstepped chunk.  A lane past its own chunk count, or finished
  (``cur_n == 0``), has every row invalid, so its step is a no-op.  With
  a finite ``ev_budget`` the host repeats window pass ``ev_pass + 1``
  over a chunk while any lane has window events left; a lane with none
  selects no pairs at that pass, so its counters do not move.
* **Full capacity from the start.**  Lanes run at the user's
  ``frontier_cap`` (no growth restarts); a drop there is the same
  CAPACITY_EXHAUSTED the solo run's last growth step lands.
* **Continuous batching.**  At a level boundary a drained lane is
  refilled from the pending list (``lanes.inject``): one lane's slice is
  rebuilt in place from a root row through the solo ``_build_dev_init``
  body, or from its checkpoint through ``_carry_from_ckpt``
  (``lanes.restore``), and copied into that lane's slice.
* **Per-lane fault domain.**  Each lane dumps to its own run dir in the
  shared checkpoint format, so a lane's dump resumes solo in either
  package and a SIGKILLed batch resumes every lane from its own dump.  A
  poisoned lane (net or timer cap overflow, strict table pressure) is
  evicted with an error its caller retries solo; its lane-mates never
  see it.
* **Cost splitting.**  Each shared dispatch's wall is divided evenly over
  the lanes resident at that level; a verdict's ``lane_share`` (the
  shares of a batch sum to 1) scales its ``COSTS.jsonl`` charge.

:class:`LaneBatchWarden` runs one batch in a supervised child
(``python -m dslabs_tpu_torch.tpu.lanes``), as ``tpu/warden.py`` runs a
rung: heartbeats from the dispatch seam, SIGKILL at the announced grace,
per-lane results streamed as lanes retire, respawn with ``resume=True``.

Deliberate differences from the reference: the host-driven lane step in
place of ``vmap``; kernel 2 once per lane in place of the jnp oracle
(``pallas_call`` has no batching rule, the port's kernel needs none);
outcomes carry their lane's fault-event counts and capacity stamps; the
reference's ``DSLABS_LANE_RESTARTS`` is the constant
:data:`LANE_RESTARTS` (``DSLABS_LANES`` and ``DSLABS_LANE_SWAP`` are the
service's ``service/server.py`` constants and arguments).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dslabs_tpu_torch.tpu import checkpoint as ckpt_mod
from dslabs_tpu_torch.tpu import visited as visited_mod
from dslabs_tpu_torch.tpu.engine import (SearchOutcome, TensorSearch,
                                         flatten_state, host_copy,
                                         to_host)

__all__ = ["LaneSearch", "LaneJob", "LaneBatchResult", "LaneBatchWarden",
           "job_signature", "LANE_RESTARTS"]

# The reference's environment default, as a constant: the batch child's
# respawns before its unfinished jobs are evicted to solo retries.
LANE_RESTARTS = 2


def job_signature(job) -> Optional[str]:
    """The lane packing key of a service :class:`~dslabs_tpu_torch.service
    .queue.Job`: two jobs may share a lane batch iff their signatures
    match (same factory spec, hence the same twin; same engine knobs,
    hence the same shapes).  None = not lane-eligible: a job with an
    injected fault, a job already evicted to solo, and a job whose ladder
    does not lead with the device rung run alone."""
    if getattr(job, "fault", None) or getattr(job, "solo", False):
        return None
    ladder = tuple(getattr(job, "ladder", ()) or ())
    if ladder and ladder[0] != "device":
        return None
    return json.dumps(
        [job.factory, job.factory_kwargs or {}, job.transform,
         bool(job.strict), int(job.chunk), int(job.frontier_cap),
         int(job.visited_cap)], sort_keys=True)


@dataclasses.dataclass
class LaneJob:
    """One job of a lane batch: its identity, its own limits and its own
    durable run dir.  The protocol is shared: lane compatibility is the
    caller's contract (:func:`job_signature`)."""

    job_id: str
    max_depth: Optional[int] = None
    max_secs: Optional[float] = None
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0
    trace_id: Optional[str] = None
    # Optional batch-1 start state (tensors or host arrays); never crosses
    # a spawn boundary.
    initial: Optional[dict] = None


@dataclasses.dataclass
class LaneBatchResult:
    """What one batch produced: per-job verdicts, per-job eviction errors
    (lanes the caller retries solo), and the shared-dispatch accounting
    the cost meter splits."""

    outcomes: Dict[str, SearchOutcome]
    errors: Dict[str, str]
    swaps: int = 0
    levels: int = 0
    dispatches: float = 0.0
    device_secs: float = 0.0
    occupancy: float = 0.0          # mean resident lanes per level
    child_restarts: int = 0
    killed_dispatches: int = 0


class _Lane:
    """Host-side state of one resident lane."""

    __slots__ = ("idx", "job", "t0", "depth", "last", "active",
                 "device_secs", "dispatches", "prev_explored", "cur_n",
                 "faults", "resumed_from")

    def __init__(self, idx: int, job: LaneJob, t0: float,
                 depth: int = 0, last=(0, 1, 0), cur_n: int = 1):
        self.idx = idx
        self.job = job
        self.t0 = t0
        self.depth = depth
        self.resumed_from = depth   # the dump's depth (0 for a fresh root)
        self.last = last            # (explored, unique, vis_over)
        self.active = True
        self.device_secs = 0.0
        self.dispatches = 0.0
        self.prev_explored = last[0]
        self.cur_n = cur_n          # rows of the frontier the next level reads
        self.faults = np.zeros((4,), np.int64)


class LaneSearch(TensorSearch):
    """The lane-stacked engine.  Construction mirrors
    :class:`TensorSearch` (one shared protocol and knob set, the lane
    signature); :meth:`run_lanes` drives a batch to per-lane verdicts.
    ``spill`` and ``record_trace`` are solo-only, as in the reference (the
    constructor takes neither): a job that needs them is not
    lane-eligible.  Dispatch tags:
    ``lanes.init``, ``lanes.superstep``, ``lanes.sync``,
    ``lanes.promote``, ``lanes.inject``, ``lanes.restore``,
    ``lanes.flags``."""

    def __init__(self, protocol, n_lanes: int,
                 frontier_cap: int = 1 << 14,
                 chunk: int = 1 << 10,
                 max_secs: Optional[float] = None,
                 ev_budget=None,
                 visited_cap: int = 1 << 20,
                 strict: bool = True,
                 telemetry=None,
                 packed: Optional[bool] = None,
                 symmetry: Optional[bool] = None,
                 device=None,
                 sanitize: Optional[str] = None):
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        super().__init__(protocol, frontier_cap=frontier_cap, chunk=chunk,
                         max_secs=max_secs, ev_budget=ev_budget,
                         visited_cap=visited_cap, strict=strict,
                         telemetry=telemetry, packed=packed,
                         symmetry=symmetry, device=device,
                         sanitize=sanitize)
        self.L = int(n_lanes)
        # Lanes run at the full user cap from the start (no growth
        # restarts): the counters do not depend on the buffer size below
        # the overflow point, and a drop at the user cap is the verdict
        # the solo run's last growth step lands.
        self._cap = -(-frontier_cap // chunk) * chunk
        p = protocol
        self._windowed = (self._ev_msg < p.net_cap
                          or self._ev_tmr < p.n_nodes * p.timer_cap)

    # ---------------------------------------------------------- programs

    def _lane_step(self):
        """The lane step over chunk index ``j`` at window pass ``ev_pass``
        (module docstring).  Returns each lane's window remainder ``[L]``
        (events past this pass's window)."""
        p = self.p
        L, C, cap = self.L, self.chunk, self._cap
        dev = self.device
        pk = self._pk
        B = self._ev_slots
        N = C * B                                  # successor rows per lane
        lane_ids = torch.arange(L, device=dev)
        col = torch.arange(C, device=dev)

        def step(carry, j: int, ev_pass: int):
            self.chunk_steps += 1
            start = j * C
            rows_chunk = carry["cur"][:, start:start + C].reshape(
                L * C, -1)
            if pk is not None:
                rows_chunk = pk.unpack(rows_chunk)
            valid = ((start + col)[None, :]
                     < carry["cur_n"][:, None]).reshape(L * C)
            (rows, valids, fp, unique, overs, ev_rem, event_ids,
             flags) = self._expand_chunk(rows_chunk, valid, ev_pass,
                                         self._rt_masks, dedup=False,
                                         per_row=True)
            # ---- terminal flags, checkState order, per lane: the first
            # hit of each flag in each lane's segment.
            hit_list = [valids & (rows[:, -1] != 0)]
            for n in p.invariants:
                hit_list.append(valids & ~flags[f"inv:{n}"])
            for n in p.goals:
                hit_list.append(flags[f"goal:{n}"])
            hits = torch.stack(hit_list).reshape(-1, L, N)  # [nf, L, N]
            cnts = hits.sum(2).t()                          # [L, nf]
            idxs = torch.argmax(hits.to(torch.int32), dim=2).t()
            fresh_flag = (carry["flag_cnt"] == 0) & (cnts > 0)

            pruned = rows[:, -1] != 0
            for n in p.prunes:
                pruned = pruned | flags[f"prune:{n}"]

            # ---- kernel 2 once per lane, on the lane's own table view
            # and keys: the solo insert's batch, bit for bit.
            ins, unres = [], []
            for lane in range(L):
                seg = slice(lane * N, (lane + 1) * N)
                _, a, b = visited_mod.insert(carry["visited"][lane],
                                             fp[seg], unique[seg])
                ins.append(a)
                unres.append(b)
            inserted = torch.cat(ins)
            unresolved = torch.cat(unres)
            fresh = inserted | unresolved

            # ---- per-lane frontier-compact append into each lane's nxt.
            sel = fresh & ~pruned
            sel2 = sel.reshape(L, N)
            n_sel = sel2.sum(1)
            nxt_n = carry["nxt_n"]
            carry["flag_rows"].copy_(torch.where(
                fresh_flag[:, :, None],
                rows[lane_ids[:, None] * N + idxs], carry["flag_rows"]))
            spos = torch.cumsum(sel2.to(torch.int64), 1) - 1
            dst = nxt_n[:, None] + spos
            sdst = (torch.where(sel2 & (dst < cap), dst, cap)
                    + lane_ids[:, None] * (cap + 1)).reshape(-1)
            nxt_flat = carry["nxt"].view(L * (cap + 1), -1)
            overflow = overs.reshape(L, N).sum(1)
            if pk is None:
                nxt_flat.index_copy_(0, sdst, rows)
            else:
                # The solo step's one host sync, for all L lanes.
                idx = torch.nonzero(sel).squeeze(1)
                packed, pack_bad = pk.pack(rows.index_select(0, idx),
                                           count_bad=True)
                overflow = overflow.index_add(
                    0, torch.div(idx, N, rounding_mode="floor"),
                    pack_bad.to(overflow.dtype))
                nxt_flat.index_copy_(0, sdst.index_select(0, idx), packed)
            f_drop = torch.clamp(nxt_n + n_sel - cap, min=0)
            carry["nxt_n"] += n_sel - f_drop
            carry["vis_n"] += inserted.reshape(L, N).sum(1)
            carry["explored"] += valids.reshape(L, N).sum(1)
            carry["overflow"] += overflow
            carry["vis_over"] += unresolved.reshape(L, N).sum(1)
            carry["f_drop"] += f_drop
            carry["flag_cnt"] += cnts
            if "fault_cnt" in carry:
                carry["fault_cnt"] += torch.stack([
                    self._fault_chunk_counts(
                        event_ids[lane * C:(lane + 1) * C],
                        valids[lane * N:(lane + 1) * N])
                    for lane in range(L)])
            return ev_rem.reshape(L, C).sum(1)

        return step

    def _build_superstep(self):
        """``lanes.superstep``: one whole level for every lane, one
        dispatch.  ``n_chunks`` is the most chunks any resident lane's
        frontier holds (the host knows each lane's frontier size from the
        last level's stats).  Returns the per-lane stats ``[L, 7 + nf]``
        (+ the fault-family counts with a fault model): explored,
        overflow, vis_over, f_drop, vis_n, nxt_n, the last window
        remainder, the flag counts."""
        step = self._lane_step()
        windowed = self._windowed

        def superstep(carry, n_chunks: int):
            rem = None
            for j in range(n_chunks):
                ev_pass = 0
                while True:
                    rem = step(carry, j, ev_pass)
                    # A finite window: another pass over chunk j while any
                    # lane has events past it (one sync per pass).
                    if not windowed or not bool((rem > 0).any()):
                        break
                    ev_pass += 1
            if rem is None:
                rem = torch.zeros_like(carry["explored"])
            cols = [carry["explored"], carry["overflow"], carry["vis_over"],
                    carry["f_drop"], carry["vis_n"], carry["nxt_n"], rem]
            return torch.cat([torch.stack(cols, 1), carry["flag_cnt"]]
                             + ([carry["fault_cnt"]]
                                if "fault_cnt" in carry else []), 1)

        return superstep

    def _empty_lanes(self) -> dict:
        """The stacked carry with every lane empty (``cur_n`` 0, tables
        all EMPTY)."""
        L, cap, dev = self.L, self._cap, self.device
        nf = len(self._flag_names)

        def z():
            return torch.zeros((L,), dtype=torch.int64, device=dev)

        carry = {
            "cur": torch.zeros((L, cap + 1, self.plane), dtype=torch.int32,
                               device=dev),
            "cur_n": z(),
            "nxt": torch.zeros((L, cap + 1, self.plane), dtype=torch.int32,
                               device=dev),
            "nxt_n": z(),
            "visited": torch.full((L, self.visited_cap + 1, 4),
                                  visited_mod.EMPTY, dtype=torch.int32,
                                  device=dev),
            "vis_n": z(), "explored": z(), "overflow": z(),
            "vis_over": z(), "f_drop": z(),
            "flag_cnt": torch.zeros((L, nf), dtype=torch.int64, device=dev),
            "flag_rows": torch.zeros((L, nf, self.lanes),
                                     dtype=torch.int32, device=dev),
        }
        if self._ev_flt:
            carry["fault_cnt"] = torch.zeros((L, 4), dtype=torch.int64,
                                             device=dev)
        return carry

    @staticmethod
    def _splice(carry: dict, i: int, solo: dict, n: int) -> None:
        """Copy a solo carry holding ``n`` frontier rows into lane ``i``'s
        slice (its table, frontier prefix, counters and flags)."""
        carry["visited"][i].copy_(solo["visited"])
        if n:
            carry["cur"][i, :n].copy_(solo["cur"][:n])
        for k in ("cur_n", "nxt_n", "vis_n", "explored", "overflow",
                  "vis_over", "f_drop"):
            carry[k][i:i + 1].copy_(solo[k])
        for k in ("flag_cnt", "flag_rows", "fault_cnt"):
            if k in carry:
                carry[k][i].copy_(solo[k])

    def _build_inject(self):
        """``lanes.inject``: rebuild lane ``i`` from a root row through
        the solo ``_build_dev_init`` body (kernel 1, the table insert, the
        pack), at a one-row buffer, and copy it into the lane's slice."""
        build = self._build_dev_init(1)

        def inject(carry, i: int, row0):
            self._splice(carry, i, build(row0), 1)
            return carry

        return inject

    def _build_restore(self):
        """``lanes.restore``: rebuild lane ``i`` from its checkpoint
        through ``_carry_from_ckpt`` (kernel 2 rebuilds the table) and
        copy it into the lane's slice."""

        def restore(carry, i: int, ck):
            n = len(ck.frontier)
            self._splice(carry, i, self._carry_from_ckpt(ck, max(n, 1)), n)
            return carry

        return restore

    def _build_init(self):
        """``lanes.init``: the stacked carry, each seated lane built from
        its root row as ``lanes.inject`` builds one (``rows`` holds a
        ``[1, lanes]`` row per lane, or None for a lane left empty or
        restored next)."""
        inject = self._build_inject()

        def init(rows):
            carry = self._empty_lanes()
            for i, row0 in enumerate(rows):
                if row0 is not None:
                    inject(carry, i, row0)
            return carry

        return init

    @staticmethod
    def _build_promote():
        """``lanes.promote``: ``nxt`` -> ``cur`` for every lane (the two
        stacked buffers swap), and each retired lane (``dead``, host lane
        indices) presents an empty frontier from here on."""

        def promote(carry, dead):
            carry["cur"], carry["nxt"] = carry["nxt"], carry["cur"]
            carry["cur_n"].copy_(carry["nxt_n"])
            for i in dead:
                carry["cur_n"][i:i + 1].zero_()
            carry["nxt_n"].zero_()
            return carry

        return promote

    def dispatch_site_programs(self) -> Dict[str, object]:
        """Every function the batch loop dispatches, keyed by its tag
        (``tpu/telemetry.py DISPATCH_SITES``), for the hot-path audit.
        ``args`` are real tensors around a throwaway carry with every lane
        seated at the root.  ``lanes.superstep``'s budget is this
        engine's: one sync per chunk step packed (``torch.nonzero``), one
        more per window pass with a finite ``ev_budget``; the audited
        call runs one chunk step.  Audit-only: ``visited.insert`` (kernel
        2 over one lane's keys of one lane step), ``packing.pack`` /
        ``packing.unpack`` and ``symmetry.canonicalize`` where the
        engine packs or reduces."""
        C, L, dev = self.chunk, self.L, self.device
        row0 = flatten_state(self.initial_state())
        init = self._build_init()
        carry = init([row0] * L)
        n_stats = 7 + len(self._flag_names) + (4 if self._ev_flt else 0)
        ck = ckpt_mod.SearchCheckpoint(
            fingerprint=self._ckpt_fingerprint(), depth=0, explored=0,
            elapsed=0.0, frontier=host_copy(row0),
            visited_keys=visited_mod.host_occupied(carry["visited"][0]),
            vis_over=0)
        rows = row0.expand(C, -1).contiguous()
        n_keys = C * self._num_events()
        keys = (torch.arange(4 * n_keys, dtype=torch.int64, device=dev)
                * 2654435761 % (1 << 31)).to(torch.int32).reshape(-1, 4)
        sites: Dict[str, object] = {
            "lanes.init": dict(fn=init, args=([row0] * L,),
                               builder=self._build_init),
            "lanes.superstep": dict(
                fn=self._build_superstep(), args=(carry, 1),
                syncs=int(self._pk is not None) + int(self._windowed),
                builder=self._build_superstep),
            "lanes.sync": dict(
                fn=to_host, args=(torch.zeros((L, n_stats),
                                              dtype=torch.int64,
                                              device=dev),)),
            "lanes.promote": dict(fn=self._build_promote(),
                                  args=(carry, (L - 1,)),
                                  builder=self._build_promote),
            "lanes.inject": dict(fn=self._build_inject(),
                                 args=(carry, 0, row0),
                                 builder=self._build_inject),
            "lanes.restore": dict(fn=self._build_restore(),
                                  args=(carry, 0, ck),
                                  builder=self._build_restore),
            "lanes.flags": dict(fn=to_host, args=(carry["flag_rows"][0],)),
            "visited.insert": dict(
                fn=visited_mod.insert,
                args=(carry["visited"][0], keys,
                      torch.ones((n_keys,), dtype=torch.bool, device=dev)),
                builder=lambda: visited_mod.insert),
        }
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

    # ------------------------------------------------------------ helpers

    def _lane_seed(self, job: LaneJob, resume: bool):
        """How a lane starts: ``("done", outcome)`` (a verdict on the
        initial state, depth 0, or a finished dump), ``("ckpt", ck)`` or
        ``("fresh", row0)``."""
        t0 = time.time()
        if resume and job.checkpoint_path:
            fp = ckpt_mod.peek_fingerprint(job.checkpoint_path)
            if fp is not None and fp == self._ckpt_fingerprint():
                ck = ckpt_mod.load(job.checkpoint_path,
                                   self._ckpt_fingerprint())
                if ck is not None:
                    # Raw rows whatever the dump's encoding; the restore
                    # re-packs them to this engine's storage.
                    self._normalize_ckpt_frontier(ck)
                    if not len(ck.frontier):
                        return ("done", SearchOutcome(
                            "SPACE_EXHAUSTED", ck.explored,
                            len(ck.visited_keys), ck.depth, ck.elapsed,
                            visited_overflow=ck.vis_over,
                            resumed_from_depth=ck.depth))
                    return ("ckpt", ck)
        state = self._initial_or(job.initial)
        out = self._check_initial(state, t0)
        if out is not None:
            return ("done", out)
        if job.max_depth is not None and job.max_depth <= 0:
            return ("done", SearchOutcome(
                "DEPTH_EXHAUSTED", 0, 1, 0, time.time() - t0))
        return ("fresh", flatten_state(state))

    def _lane_ckpt(self, carry, ln: _Lane, nxt_n: int) -> None:
        """One lane's durable dump after the promote (``cur`` holds the
        next level), in the shared format: a poisoned lane's solo retry,
        in either package, resumes this exact dump."""
        i = ln.idx
        ckpt_mod.save(ln.job.checkpoint_path, self._make_ckpt(
            host_copy(carry["cur"][i, :nxt_n]),
            visited_mod.host_occupied(carry["visited"][i]), ln.depth,
            ln.last[0], time.time() - ln.t0, ln.last[2]),
            levels_dir=self.levels_dir)

    # ----------------------------------------------------------------- run

    def run_lanes(self, jobs: List[LaneJob], resume: bool = False,
                  swap: bool = True,
                  on_lane: Optional[Callable] = None) -> LaneBatchResult:
        """Drive every job to a verdict or an eviction error.  The first L
        jobs seat at once; the rest refill drained lanes at level
        boundaries when ``swap`` (continuous batching) is on, and run in
        follow-on seatings otherwise.  ``on_lane(job_id, outcome or None,
        error or None, lane_secs)`` streams results as lanes retire."""
        self._maybe_sanitize()
        if not jobs:
            return LaneBatchResult({}, {})
        L = self.L
        C = self.chunk
        nf = len(self._flag_names)
        res = LaneBatchResult({}, {})
        pending = list(jobs)
        t_run = time.time()
        lane_secs: Dict[str, float] = {}
        tel = self._telemetry
        init = self._build_init()
        superstep = self._build_superstep()
        promote = self._build_promote()
        inject = self._build_inject()
        restore = self._build_restore()

        def _finish(ln: Optional[_Lane], job: LaneJob,
                    out: Optional[SearchOutcome],
                    error: Optional[str]) -> None:
            if out is not None:
                self._stamp_capacity(out)
                if ln is not None:
                    fc = ln.faults
                    out.partition_events = int(fc[0])
                    out.crash_events = int(fc[1])
                    out.drop_events = int(fc[2])
                    out.dup_events = int(fc[3])
                    out.fault_events = int(fc.sum())
                out.engine = "lanes"
                if ln is not None:
                    out.resumed_from_depth = ln.resumed_from
                out.lane = ln.idx if ln is not None else None
                out.lane_width = L
                if out.trace_id is None:
                    out.trace_id = job.trace_id
                lane_secs[job.job_id] = (ln.device_secs if ln is not None
                                         else 0.0)
                res.outcomes[job.job_id] = out
                if tel is not None:
                    tel.on_outcome(out, engine="lanes")
            else:
                res.errors[job.job_id] = error or "lane error"
                if tel is not None:
                    tel.event("lane_evicted", job_id=job.job_id,
                              error=(error or "")[:200])
            if on_lane is not None:
                on_lane(job.job_id, out, error,
                        lane_secs.get(job.job_id, 0.0))

        def _seat(idx: int, job: LaneJob, kind: str, arg) -> _Lane:
            if kind == "ckpt":
                return _Lane(idx, job, time.time() - arg.elapsed,
                             depth=arg.depth,
                             last=(arg.explored, len(arg.visited_keys),
                                   arg.vis_over),
                             cur_n=len(arg.frontier))
            return _Lane(idx, job, time.time())

        # ---- seat the first lanes: one init dispatch, then each resumed
        # lane restored from its own dump.
        lanes: List[Optional[_Lane]] = [None] * L
        roots: List[Optional[torch.Tensor]] = [None] * L
        restores = []
        i = 0
        while i < L and pending:
            job = pending.pop(0)
            kind, arg = self._lane_seed(job, resume)
            if kind == "done":
                _finish(None, job, arg, None)
                continue
            lanes[i] = _seat(i, job, kind, arg)
            if kind == "ckpt":
                restores.append((i, arg))
            else:
                roots[i] = arg
            i += 1
        if not any(ln is not None for ln in lanes):
            return res
        carry = self._dispatch("lanes.init", init, roots)
        res.dispatches += 1.0
        for idx, ck in restores:
            carry = self._dispatch("lanes.restore", restore, carry, idx, ck)
            res.dispatches += 1.0
            lanes[idx].dispatches += 1.0

        def _swap_in(idx: int) -> bool:
            """Refill lane ``idx`` from the pending list; True when a job
            was seated."""
            nonlocal carry
            while pending:
                job = pending.pop(0)
                kind, arg = self._lane_seed(job, resume)
                if kind == "done":
                    _finish(None, job, arg, None)
                    continue
                ln = _seat(idx, job, kind, arg)
                if kind == "ckpt":
                    carry = self._dispatch("lanes.restore", restore, carry,
                                           idx, arg)
                else:
                    carry = self._dispatch("lanes.inject", inject, carry,
                                           idx, arg)
                res.dispatches += 1.0
                ln.dispatches += 1.0
                lanes[idx] = ln
                res.swaps += 1
                if tel is not None:
                    tel.event("lane_swap_in", lane=idx, job_id=job.job_id,
                              depth_neighbors=[
                                  m.depth for m in lanes
                                  if m is not None and m.active])
                return True
            return False

        # ---- the level loop: superstep -> sync -> per-lane verdicts ->
        # promote -> per-lane dumps -> swap-ins.  One superstep, one sync
        # and one promote per level for the whole batch.
        while True:
            active = [ln for ln in lanes if ln is not None and ln.active]
            if not active:
                break
            self._current_depth = max(ln.depth for ln in active) + 1
            n_chunks = max(-(-ln.cur_n // C) for ln in active)
            t_level = time.time()
            sdev = self._dispatch("lanes.superstep", superstep, carry,
                                  n_chunks)
            s = self._dispatch("lanes.sync", to_host, sdev)
            wall = time.time() - t_level
            share = wall / len(active)
            res.dispatches += 2.0
            res.device_secs += wall
            res.levels += 1
            res.occupancy += len(active)
            retiring: List[_Lane] = []
            lane_records = []
            for ln in active:
                ln.depth += 1
                ln.device_secs += share
                ln.dispatches += 2.0 / len(active)
                row = s[ln.idx]
                explored, overflow, vis_over, f_drop, vis_n, nxt_n = (
                    int(x) for x in row[:6])
                flag_counts = np.asarray(row[7:7 + nf])
                if self._ev_flt:
                    ln.faults[:] = row[7 + nf:7 + nf + 4]
                elapsed = time.time() - ln.t0
                job = ln.job
                p = self.p
                # The level record covers every lane resident during the
                # level, retiring lanes included.
                lane_records.append(
                    (ln, explored - ln.prev_explored, vis_n, nxt_n))
                ln.prev_explored = explored
                ln.last = (explored, vis_n, vis_over)
                ln.cur_n = nxt_n
                if overflow:
                    # The solo contract raises CapacityOverflow; in a batch
                    # the lane is poisoned and evicted to a solo retry.
                    _finish(ln, job, None,
                            f"CapacityOverflow: {p.name}: net_cap="
                            f"{p.net_cap}, timer_cap={p.timer_cap}, or "
                            f"max_live_sends={p.max_live_sends} "
                            f"overflowed at depth {ln.depth} "
                            f"({overflow} drops)")
                    retiring.append(ln)
                    continue
                if self.strict and (vis_over
                                    or vis_n > 3 * self.visited_cap // 4):
                    _finish(ln, job, None,
                            f"CapacityOverflow: {p.name}: visited "
                            f"table pressure at depth {ln.depth} "
                            f"({vis_n}/{self.visited_cap} occupied, "
                            f"{vis_over} unresolved); raise "
                            "visited_cap or retry solo with spill")
                    retiring.append(ln)
                    continue
                if flag_counts.any():
                    rows = self._dispatch("lanes.flags", to_host,
                                          carry["flag_rows"][ln.idx])
                    res.dispatches += 1.0
                    ln.dispatches += 1.0
                    _finish(ln, job, self._terminal_from_rows(
                        rows, flag_counts, explored, vis_n, ln.depth,
                        elapsed, vis_over), None)
                    retiring.append(ln)
                    continue
                end = None
                if f_drop:
                    end = "CAPACITY_EXHAUSTED"
                elif nxt_n == 0:
                    end = "SPACE_EXHAUSTED"
                elif (job.max_depth is not None
                      and ln.depth >= job.max_depth):
                    # The solo loop's order: the completed depth is
                    # checked before another level runs.
                    end = "DEPTH_EXHAUSTED"
                elif ((job.max_secs is not None and elapsed > job.max_secs)
                      or (self.max_secs is not None
                          and time.time() - t_run > self.max_secs)
                      or self._cancelled()):
                    end = "TIME_EXHAUSTED"
                if end is not None:
                    _finish(ln, job, SearchOutcome(
                        end, explored, vis_n, ln.depth, elapsed,
                        visited_overflow=vis_over,
                        cancelled=(end == "TIME_EXHAUSTED"
                                   and self._cancelled())), None)
                    retiring.append(ln)
            if tel is not None:
                self._feed_lanes(active, lane_records, wall)
            for ln in retiring:
                ln.active = False
            dead = tuple(i for i, ln in enumerate(lanes)
                         if ln is None or not ln.active)
            carry = self._dispatch("lanes.promote", promote, carry, dead)
            res.dispatches += 1.0
            still = [ln for ln in lanes if ln is not None and ln.active]
            for ln in still:
                ln.dispatches += 1.0 / len(still)
            # After the promote ``cur`` is the next level's frontier: the
            # boundary the solo device loop dumps at.
            for ln in still:
                if (ln.job.checkpoint_path and ln.job.checkpoint_every
                        and ln.depth % ln.job.checkpoint_every == 0):
                    self._lane_ckpt(carry, ln, ln.cur_n)
            if swap and pending:
                for idx in range(L):
                    if lanes[idx] is None or not lanes[idx].active:
                        if not _swap_in(idx):
                            break
        del carry
        # Follow-on seatings when continuous batching is off: the
        # remaining jobs queue behind the batch.
        if pending:
            tail = self.run_lanes(pending, resume=resume, swap=swap,
                                  on_lane=on_lane)
            res.outcomes.update(tail.outcomes)
            res.errors.update(tail.errors)
            res.swaps += tail.swaps
            res.levels += tail.levels
            res.dispatches += tail.dispatches
            res.device_secs += tail.device_secs
            res.occupancy += tail.occupancy * max(tail.levels, 1)
            for jid in tail.outcomes:
                lane_secs[jid] = ((tail.outcomes[jid].lane_share or 0.0)
                                  * max(tail.device_secs, 0.0))
        if res.levels:
            res.occupancy = round(res.occupancy / res.levels, 3)
        # Each lane's share of the batch's shared device seconds: the
        # shares sum to 1, so the cost meter never bills a dispatch twice.
        for jid, out in res.outcomes.items():
            out.lane_share = (
                round(lane_secs.get(jid, 0.0) / res.device_secs, 6)
                if res.device_secs > 0 else 0.0)
        return res

    def _feed_lanes(self, active, lane_records, wall: float) -> None:
        """The batch's level record: the resident lanes' sums, a
        per-device block with one entry per resident lane, and the
        ``lanes`` block (per-lane job, depth and counts) that STATUS.json
        and ``telemetry watch`` show."""
        from dslabs_tpu_torch.tpu.telemetry import skew_metrics

        deltas = [d for _, d, _, _ in lane_records] or [0]
        self._telemetry.on_level("lanes", {
            "depth": max(ln.depth for ln in active),
            "wall": round(wall, 4),
            "explored": sum(ln.last[0] for ln in active),
            "unique": sum(ln.last[1] for ln in active),
            "next_frontier": sum(n for _, _, _, n in lane_records),
            "load_factor": round(max(ln.last[1] for ln in active)
                                 / self.visited_cap, 4),
            "per_device": {
                "explored": deltas,
                "frontier": [n for _, _, _, n in lane_records] or [0],
                "load_factor": [round(v / self.visited_cap, 4)
                                for _, _, v, _ in lane_records] or [0.0],
                "drops": [0] * max(len(lane_records), 1)},
            "skew": {"explored": skew_metrics(deltas)},
            "lanes": [{"lane": ln.idx, "job_id": ln.job.job_id,
                       "depth": ln.depth, "explored": ln.last[0],
                       "unique": ln.last[1], "frontier": n}
                      for ln, _, _, n in lane_records],
        })


# ------------------------------------------------------------ batch warden

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class LaneBatchWarden:
    """Parent half of the lane-batch fault domain (``tpu/warden.py``'s
    pattern, one child per batch): spawn ``python -m
    dslabs_tpu_torch.tpu.lanes``, enforce the announced heartbeat grace
    with SIGKILL, collect per-lane results as they stream, and respawn
    with ``resume=True`` so every unfinished lane continues from its own
    dump.  After ``max_restarts`` deaths the unfinished jobs come back as
    per-job errors, which the service evicts to solo retries.  ``device``
    (the card unless the caller names another) is where the child runs;
    a CPU child runs with ``CUDA_VISIBLE_DEVICES=``, off the card.
    ``fault`` injects a child-side fault as ``Warden``'s does (``kind``
    die / exit / hang / raise at dispatch index ``at``, first spawn
    unless ``spawns`` lists others)."""

    def __init__(self, factory: str, jobs: List[dict],
                 n_lanes: int,
                 factory_kwargs: Optional[dict] = None,
                 transform: Optional[str] = None,
                 strict: bool = True,
                 chunk: int = 1 << 10,
                 frontier_cap: int = 1 << 14,
                 visited_cap: int = 1 << 20,
                 ev_budget=None,
                 max_secs: Optional[float] = None,
                 run_dir: Optional[str] = None,
                 swap: bool = True,
                 env: Optional[dict] = None,
                 extra_sys_path: Optional[List[str]] = None,
                 boot_grace: float = 240.0,
                 first_grace: Optional[float] = None,
                 steady_grace: float = 120.0,
                 idle_grace: float = 300.0,
                 grace_slack: float = 5.0,
                 fault: Optional[dict] = None,
                 max_restarts: int = LANE_RESTARTS,
                 telemetry=None,
                 device=None):
        from dslabs_tpu_torch.tpu._build import resolve_device

        self.factory = factory
        self.factory_kwargs = factory_kwargs or {}
        self.transform = transform
        self.jobs = list(jobs)
        self.n_lanes = int(n_lanes)
        self.strict = strict
        self.chunk = chunk
        self.frontier_cap = frontier_cap
        self.visited_cap = visited_cap
        self.ev_budget = ev_budget
        self.max_secs = max_secs
        self.run_dir = run_dir
        self.swap = bool(swap)
        self.env = dict(env or {})
        self.extra_sys_path = list(extra_sys_path or [])
        self.boot_grace = boot_grace
        self.first_grace = (boot_grace if first_grace is None
                            else first_grace)
        self.steady_grace = steady_grace
        self.idle_grace = idle_grace
        self.grace_slack = grace_slack
        self.fault = fault
        self.max_restarts = int(max_restarts)
        self.device = str(resolve_device(device))
        self.telemetry = telemetry
        self.deaths: List[dict] = []
        self.killed_dispatches = 0
        # The platform the last child ran on ("cuda" or "cpu").
        self.last_platform: Optional[str] = None

    def _spec(self, jobs: List[dict], resume: bool,
              spawn_index: int) -> dict:
        return {
            "factory": self.factory,
            "factory_kwargs": self.factory_kwargs,
            "transform": self.transform,
            "jobs": jobs,
            "n_lanes": min(self.n_lanes, max(len(jobs), 1)),
            "strict": self.strict,
            "chunk": self.chunk,
            "frontier_cap": self.frontier_cap,
            "visited_cap": self.visited_cap,
            "ev_budget": (list(self.ev_budget)
                          if isinstance(self.ev_budget, tuple)
                          else self.ev_budget),
            "max_secs": self.max_secs,
            "run_dir": self.run_dir,
            "swap": self.swap,
            "resume": resume,
            "device": self.device,
            "grace": {"boot": self.boot_grace,
                      "first": self.first_grace,
                      "steady": self.steady_grace,
                      "idle": self.idle_grace},
            "fault": self.fault,
            "spawn_index": spawn_index,
        }

    def _child_env(self) -> dict:
        env = dict(os.environ)
        paths = [_REPO_ROOT] + self.extra_sys_path
        if env.get("PYTHONPATH"):
            paths.append(env["PYTHONPATH"])
        env["PYTHONPATH"] = os.pathsep.join(paths)
        env["DSLABS_LANE_CHILD"] = "1"
        if self.device == "cpu":
            env["CUDA_VISIBLE_DEVICES"] = ""
        env.update(self.env)
        return env

    def run(self, resume: bool = False) -> LaneBatchResult:
        import queue as queue_mod

        from dslabs_tpu_torch.tpu.supervisor import classify_child_death
        from dslabs_tpu_torch.tpu.warden import LineWatch, outcome_from_dict

        res = LaneBatchResult({}, {})
        lane_secs: Dict[str, float] = {}
        remaining = {j["job_id"]: j for j in self.jobs}
        spawn = 0
        while remaining:
            spec = self._spec(list(remaining.values()),
                              resume or spawn > 0, spawn)
            proc = subprocess.Popen(
                [sys.executable, "-m", "dslabs_tpu_torch.tpu.lanes"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                env=self._child_env())

            def _tee(line):
                sys.stderr.write(line)
                sys.stderr.flush()

            err_watch = LineWatch(proc, proc.stderr, on_line=_tee)
            try:
                proc.stdin.write(json.dumps(spec))
                proc.stdin.close()
            except BrokenPipeError:
                pass
            msgs: "queue_mod.Queue[dict]" = queue_mod.Queue()

            def _read(stdout=proc.stdout):
                for line in stdout:
                    try:
                        msgs.put(json.loads(line))
                    except ValueError:
                        continue
                msgs.put({"t": "eof"})

            threading.Thread(target=_read, daemon=True).start()
            grace = self.boot_grace
            last_hb: Optional[dict] = None
            death: Optional[dict] = None
            finished = False
            while True:
                try:
                    msg = msgs.get(timeout=grace + self.grace_slack)
                except queue_mod.Empty:
                    try:
                        proc.kill()
                    except OSError:
                        pass
                    proc.wait()
                    if last_hb is not None and last_hb.get("phase") == \
                            "start":
                        self.killed_dispatches += 1
                    death = {"kind": "wedge",
                             "detail": (f"lane child silent > "
                                        f"{grace:.1f}s; SIGKILLed"),
                             "exitcode": proc.returncode,
                             "last_hb": last_hb}
                    break
                t = msg.get("t")
                if t == "hb":
                    last_hb = msg
                    grace = float(msg.get("grace", self.steady_grace))
                    if self.telemetry is not None:
                        self.telemetry.event(
                            "heartbeat", rung="lanes",
                            phase=msg.get("phase"), tag=msg.get("tag"),
                            n=msg.get("n"), depth=msg.get("depth"),
                            grace=msg.get("grace"))
                    continue
                if t == "lane_result":
                    jid = msg.get("job_id")
                    res.outcomes[jid] = outcome_from_dict(msg["outcome"])
                    lane_secs[jid] = float(msg.get("lane_secs", 0.0)
                                           or 0.0)
                    remaining.pop(jid, None)
                    continue
                if t == "lane_error":
                    jid = msg.get("job_id")
                    res.errors[jid] = msg.get("error", "lane error")
                    remaining.pop(jid, None)
                    continue
                if t == "result":
                    proc.wait()
                    res.swaps += int(msg.get("swaps", 0) or 0)
                    res.levels += int(msg.get("levels", 0) or 0)
                    res.dispatches += float(msg.get("dispatches", 0.0)
                                            or 0.0)
                    res.device_secs += float(msg.get("device_secs", 0.0)
                                             or 0.0)
                    res.occupancy = float(msg.get("occupancy", 0.0)
                                          or 0.0) or res.occupancy
                    self.last_platform = msg.get("platform")
                    finished = True
                    break
                if t == "err":
                    try:
                        rc = proc.wait(timeout=30.0)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        rc = proc.wait()
                    death = {"kind": classify_child_death(
                                 rc, False, err_watch.tail),
                             "detail": msg.get("error", "lane child "
                                               "failure"),
                             "exitcode": rc, "last_hb": last_hb}
                    break
                if t == "eof":
                    rc = proc.wait()
                    kind = classify_child_death(rc, False, err_watch.tail)
                    death = {"kind": kind, "exitcode": rc,
                             "last_hb": last_hb,
                             "detail": (f"lane child exited rc={rc} "
                                        f"without a result "
                                        f"(classified {kind})")}
                    break
            if finished:
                break
            self.deaths.append(death)
            res.child_restarts += 1
            if self.telemetry is not None:
                self.telemetry.event(
                    "lane_child_death", failure=death["kind"],
                    exitcode=death.get("exitcode"),
                    detail=death["detail"][:200])
            # A reported deterministic failure buys nothing on retry;
            # deaths past the restart budget stop the batch either way.
            if death["kind"] == "failed" or spawn >= self.max_restarts:
                for jid in list(remaining):
                    res.errors[jid] = (f"batch:{death['kind']}: "
                                       f"{death['detail'][:160]}")
                    remaining.pop(jid, None)
                break
            spawn += 1
        # The cost split over the whole batch, restart children included:
        # the shares sum to 1 of the accumulated shared device seconds.
        for jid, out in res.outcomes.items():
            out.lane_share = (
                round(lane_secs.get(jid, 0.0) / res.device_secs, 6)
                if res.device_secs > 0 else 0.0)
            out.child_restarts = res.child_restarts
            out.killed_dispatches = self.killed_dispatches
            out.platform = self.last_platform
        res.killed_dispatches = self.killed_dispatches
        return res


# ------------------------------------------------------------- child half

def _send(obj: dict) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def _child_main() -> int:
    from dslabs_tpu_torch.tpu.supervisor import CHILD_RC_FAILED
    from dslabs_tpu_torch.tpu.warden import _resolve, outcome_to_dict

    spec = json.load(sys.stdin)
    g = spec.get("grace") or {}
    boot_g = float(g.get("boot", 240.0))
    first_g = float(g.get("first", boot_g))
    steady_g = float(g.get("steady", 120.0))
    idle_g = float(g.get("idle", 300.0))
    _send({"t": "hb", "phase": "boot", "stage": "spawned",
           "grace": boot_g})
    proto = _resolve(spec["factory"])(**(spec.get("factory_kwargs")
                                         or {}))
    if spec.get("transform"):
        proto = _resolve(spec["transform"])(proto)
    _send({"t": "hb", "phase": "boot", "stage": "protocol",
           "grace": boot_g})
    ev = spec.get("ev_budget")
    if isinstance(ev, list):
        ev = tuple(ev)
    fault = spec.get("fault")
    if fault is not None:
        if fault.get("spawns") is not None:
            if int(spec.get("spawn_index", 0)) not in fault["spawns"]:
                fault = None
        elif int(spec.get("spawn_index", 0)) > 0:
            fault = None

    # The batch run dir: one flight log and STATUS.json for the whole
    # batch (per-lane progress rides the level records' ``lanes`` block);
    # each lane keeps its checkpoint in its own job dir.
    child_tel = None
    run_dir = spec.get("run_dir")
    if run_dir:
        try:
            from dslabs_tpu_torch.tpu.telemetry import Telemetry

            os.makedirs(run_dir, exist_ok=True)
            child_tel = Telemetry.for_checkpoint(
                os.path.join(run_dir, "ckpt.npz"),
                engine_hint="lane-batch")
        except Exception:  # noqa: BLE001 - observability is optional
            child_tel = None
    jobs = [LaneJob(job_id=j["job_id"], max_depth=j.get("max_depth"),
                    max_secs=j.get("max_secs"),
                    checkpoint_path=j.get("checkpoint_path"),
                    checkpoint_every=int(j.get("checkpoint_every", 0) or 0),
                    trace_id=j.get("trace_id"))
            for j in spec.get("jobs", [])]
    if child_tel is not None:
        # The batch flight log names every resident job and trace up
        # front, so the trace assembler attributes each shared span to
        # every lane's tree from disk alone.
        child_tel.event("lane_batch", jobs=[
            {"job_id": j.job_id, "trace_id": j.trace_id} for j in jobs],
            n_lanes=spec.get("n_lanes"))
    try:
        search = LaneSearch(
            proto, n_lanes=int(spec.get("n_lanes", 1) or 1),
            frontier_cap=int(spec.get("frontier_cap", 1 << 14)),
            chunk=int(spec.get("chunk", 1 << 10)),
            max_secs=spec.get("max_secs"), ev_budget=ev,
            visited_cap=int(spec.get("visited_cap", 1 << 20)),
            strict=bool(spec.get("strict", True)), telemetry=child_tel,
            device=spec.get("device"))
    except BaseException as e:  # noqa: BLE001 - reported over the pipe
        _send({"t": "err", "error": f"{type(e).__name__}: {e}"[:500]})
        return CHILD_RC_FAILED

    seen_tags = set()
    n_seen = {"n": 0}

    def hook(tag, fn, *args):
        idx = n_seen["n"]
        n_seen["n"] += 1
        first = tag not in seen_tags
        seen_tags.add(tag)
        depth = search._current_depth
        _send({"t": "hb", "phase": "start", "tag": tag, "n": idx,
               "depth": depth, "grace": first_g if first else steady_g})
        if fault is not None:
            kind = fault.get("kind")
            at = int(fault.get("at", 0))
            due = (idx >= at if kind in ("die", "exit", "hang")
                   else idx == at)
            if due:
                if kind == "die":
                    os.kill(os.getpid(), signal.SIGKILL)
                elif kind == "exit":
                    os._exit(int(fault.get("rc", 86)))
                elif kind == "hang":
                    time.sleep(float(fault.get("secs", 3600.0)))
                elif kind == "raise":
                    raise RuntimeError(f"injected lane child fault [{tag} "
                                       f"dispatch {idx}]")
        out = fn(*args)
        _send({"t": "hb", "phase": "done", "tag": tag, "n": idx,
               "depth": depth, "grace": idle_g})
        return out

    search._dispatch_hook = hook

    def on_lane(job_id, out, error, secs):
        if out is not None:
            _send({"t": "lane_result", "job_id": job_id,
                   "lane_secs": round(secs, 6),
                   "outcome": outcome_to_dict(out)})
        else:
            _send({"t": "lane_error", "job_id": job_id, "error": error})

    try:
        res = search.run_lanes(jobs, resume=bool(spec.get("resume")),
                               swap=bool(spec.get("swap", True)),
                               on_lane=on_lane)
    except BaseException as e:  # noqa: BLE001 - reported over the pipe
        _send({"t": "err", "error": f"{type(e).__name__}: {e}"[:500]})
        return CHILD_RC_FAILED
    finally:
        if child_tel is not None:
            child_tel.close()
    _send({"t": "result", "swaps": res.swaps, "levels": res.levels,
           "dispatches": res.dispatches,
           "device_secs": round(res.device_secs, 6),
           "occupancy": res.occupancy, "platform": search.device.type})
    return 0


if __name__ == "__main__":
    sys.exit(_child_main())
