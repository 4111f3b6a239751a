"""Swarm explorer on one device: diversified random-walk fleets with shared
dedup and minimized, replay-verified witnesses.

Counterpart of ``dslabs_tpu/tpu/swarm.py`` on one card.  The checker's
power comes from a BFS + random-DFS portfolio: the BFS proves shallow
exhaustiveness, and random deep probes reach the deep, narrow violations
a BFS cannot reach inside a budget.  This module is the second half.

* **Walk steps.**  A fleet of ``walkers_per_device`` walkers keeps state
  rows, depths and per-walker event histories on the device.  One walk
  step builds each walker's event table, picks one event per walker,
  steps every walker at once (``TensorSearch._step_batch``), raises the
  terminal flags in checkState order (exception, invariants, goals),
  fingerprints and inserts the advanced rows into the visited table
  (both kernels), captures the first hit of each flag and restarts the
  walkers that ended.  A round is up to ``steps_per_round`` steps; it
  stops after the step in which a flag first fires.

* **Diversification.**  Each walker has its own depth bound (a schedule
  over ``[min_steps, max_steps]``), its own pick temperature and a
  message/timer affinity of alternating sign, so the fleet covers
  timer-heavy and message-heavy schedules.  The pick is a Gumbel-max
  draw over float32 logits ``affinity * kind / temperature`` of the
  valid events, from a ``torch.Generator`` on the search's device seeded
  by ``seed``; a walker with no valid event steps on id 0 and does not
  advance.

* **Shared dedup.**  Advanced successors insert their 128-bit keys into
  one table (``tpu/visited.py``): ``unique`` counts fresh inserts, and
  ``revisit_patience`` restarts a walker whose last N steps all landed
  on visited states.  A full table degrades as in the BFS engines
  (unresolved keys count as fresh and are surfaced; strict swarms
  raise).  A capacity-truncated step restarts its walker and is counted
  (``swarm_overflow``), and warned about; strict swarms raise.

* **Witness pipeline.**  A hit's root-first event trace is the walker's
  recorded history.  :func:`minimize_event_trace` shrinks it by the
  reference's greedy deletion loop, and :func:`replay_events`
  re-applies the result from the walk root, which must reproduce the
  predicate result.  A verdict ships only with a verified
  :class:`Witness` (``SearchOutcome.witness``).

* **Frontier seeding.**  ``frontier_seed`` names a BFS checkpoint
  (``tpu/checkpoint.py``): the walkers restart from its frontier rows
  (a random pool row per restart) instead of the root, and its visited
  keys pre-seed the table through kernel 2, so the fleet probes past the
  region the BFS covered.  A witness replays from its walker's seed row.

* **Round checkpoints.**  With ``checkpoint_path`` and
  ``checkpoint_every`` = k, every k-th round dumps the fleet (walker
  rows, depths, histories, seed pool, the generator's state, the
  table's keys, the counters) in the unified format, and
  ``run(resume=True)`` continues it identically to the uncut run.

Deliberate differences from the reference: the walks draw from torch's
generator, not ``jax.random``, so they differ from the JAX walks (the
same seed on the same device gives the same walks), and a swarm dump
stores the generator's state and carries a ``:torch`` fingerprint
marker, so that neither package resumes the other's swarm dump (BFS
dumps, frontier seeds included, are shared); the clock is checked
between walk steps as well as between rounds; the warm-up builds the
kernels and runs a zero-step round before the clock starts; sizes come
from arguments only (no ``DSLABS_SWARM_*`` environment knobs); and the
fleet runs on one device, so a dump resumes only at its own walker
count.  A mesh of more than one device comes with the multi-device
swarm and raises ``NotImplementedError`` until then.

Telemetry (``telemetry=``, ``tpu/telemetry.py``): the warm-up is a
``compile`` event (the kernel library's load and the zero-step round),
each round a level record of engine ``swarm`` (explored, unique,
restarts, deepest, a one-lane ``per_device`` block and its skew, the
card's peak allocated bytes) built from the round's stats readback, and
the verdict an outcome record; the dispatches are spans.

Dispatch seam (``TensorSearch._dispatch``, installed by the search
supervisor): the fleet's init (from the root or a round dump) is
``swarm.init``; each walk step, with its one-scalar first-hit read, is
``swarm.step`` (the reference's ``swarm.round`` is one fused program of
a round's steps; here a round is a host loop of walk steps, so no site
needs a stretched watchdog deadline); the round's stats readback is
``swarm.sync``; the first-hit capture readback is ``swarm.flags``.  The
readbacks are read-only; init and the walk step write the fleet carry.
A cancelled swarm (portfolio mode) stops at its next round boundary.

Minimization replays batches of candidate traces with
``_step_batch``; see :func:`minimize_event_trace` for how a batch
decides several of the greedy loop's deletions at once with the same
result as the one-at-a-time loop.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dslabs_tpu_torch.tpu import _build, kernels
from dslabs_tpu_torch.tpu import checkpoint as ckpt_mod
from dslabs_tpu_torch.tpu import visited as visited_mod
from dslabs_tpu_torch.tpu import telemetry as tel_mod
from dslabs_tpu_torch.tpu.engine import (VISITED_WARN, CapacityOverflow,
                                         SearchOutcome, TensorProtocol,
                                         TensorSearch, _later,
                                         flatten_state, host_copy,
                                         read_only)

__all__ = ["SwarmSearch", "Witness", "minimize_event_trace",
           "replay_events", "build_witness"]

# Warn thresholds of the loud-degradation counters: any overflow restart
# is worth a warning; ordinary restarts are the walkers' job.
RESTART_WARN = 1 << 20
OVERFLOW_WARN = 0

# Candidate traces replayed side by side per minimization batch, by
# device type: one walk step costs about the same on the card for 1 or
# 1024 rows (launches set its pace), while on the CPU it grows with the
# rows.
MINIMIZE_WIDTH = {"cuda": 1024, "cpu": 16}


# ------------------------------------------------------------- witnesses

@dataclasses.dataclass
class Witness:
    """A minimized, replay-verified counterexample (or goal trace).

    ``trace`` is the minimized root-first grid-event-id list (the
    tpu/trace.py contract, relative to the walk's seed state);
    ``raw_trace`` is the walker's original history.  ``replay_verified``
    is True iff re-applying ``trace`` from the seed state applied every
    event and reproduced the predicate result."""

    end_condition: str
    predicate_name: Optional[str]
    exception_code: int
    raw_trace: List[int]
    trace: List[int]
    minimized: bool
    replay_verified: bool
    minimize_passes: int = 0
    # Set by the search backend when the object-level pipeline
    # (search/minimize.py + search/replay.py) also confirmed the witness
    # on the replayed object twin.
    object_verified: Optional[bool] = None

    def __len__(self) -> int:
        return len(self.trace)


def _replay(search: TensorSearch, row0: torch.Tensor, alive0: bool,
            lists: Sequence[Sequence[int]], snap_at=None):
    """Replay each event list of ``lists`` from the row ``row0``
    [lanes] side by side, one ``_step_batch`` per position.  ``ev < 0``
    is inert padding; the first inapplicable or overflowed event freezes
    its row (``alive`` turns False and later events are not applied),
    the reference's ``applyEvents`` semantics.  ``alive0`` False starts
    frozen.  Returns ``(rows [W, lanes], applied [W, L] bool numpy,
    snaps)``: with ``snap_at`` [W], ``snaps`` = (rows, alive) of each row
    just before its event ``snap_at[w]`` (after its last event when
    ``snap_at[w]`` is its length)."""
    dev = search.device
    w = len(lists)
    length = max([len(x) for x in lists] + [0])
    evs = np.full((w, length), -1, np.int64)
    for r, x in enumerate(lists):
        evs[r, :len(x)] = x
    evs_d = torch.as_tensor(evs, device=dev)
    rows = row0.reshape(1, -1).expand(w, -1).clone()
    alive = torch.full((w,), bool(alive0), dtype=torch.bool, device=dev)
    applied = torch.zeros((w, length), dtype=torch.bool, device=dev)
    snaps = None
    if snap_at is not None:
        snap_at = torch.as_tensor(np.asarray(snap_at, np.int64), device=dev)
        snaps = [rows.clone(), alive.clone()]
    for t in range(length + 1):
        if snaps is not None:
            here = snap_at == t
            snaps[0] = torch.where(here[:, None], rows, snaps[0])
            snaps[1] = torch.where(here, alive, snaps[1])
        if t == length:
            break
        ev = evs_d[:, t]
        real = ev >= 0
        succ, ok, over = search._step_batch(rows, ev.clamp(min=0))
        good = alive & real & ok & (over == 0)
        rows = torch.where(good[:, None], succ, rows)
        alive = torch.where(real, good, alive)
        applied[:, t] = good
    return rows, applied.cpu().numpy(), snaps


def _as_row(search: TensorSearch, row) -> torch.Tensor:
    return torch.as_tensor(np.array(row, np.int32), device=search.device)


def replay_events(search: TensorSearch, root_row,
                  events: List[int]) -> Tuple[np.ndarray, int]:
    """Replay ``events`` (grid event ids, root-first) from ``root_row``
    ([lanes] int32).  Returns ``(final_row, n_applied)`` where
    ``n_applied`` counts the applied prefix: application stops at the
    first undeliverable or overflowed event, like the reference
    minimizer's ``applyEvents``.  Replay is unmasked by design: runtime
    masks gate validity, never the transition."""
    rows, applied, _ = _replay(search, _as_row(search, root_row), True,
                               [list(events)])
    applied = applied[0]
    n_applied = (int(applied.sum()) if applied.all()
                 else int(np.argmin(applied)))
    return rows[0].cpu().numpy(), n_applied


def _verdict_check(search: TensorSearch, end_condition: str,
                   predicate_name: Optional[str], exception_code: int):
    """-> fn(rows) -> does each state reproduce the verdict (the
    same-truth-value / same-exception-code discipline of
    search/minimize.py)?  ``rows`` [W, lanes] gives a [W] bool array, a
    single row [lanes] a bool."""
    p = search.p

    def check(rows):
        rows = torch.as_tensor(rows, device=search.device)
        single = rows.dim() == 1
        st = search.unflatten_rows(rows.reshape(-1, search.lanes))
        if end_condition == "EXCEPTION_THROWN":
            res = st["exc"] == exception_code
        else:
            preds = (p.invariants if end_condition == "INVARIANT_VIOLATED"
                     else p.goals)
            holds = preds[predicate_name](st)
            res = ~holds if end_condition == "INVARIANT_VIOLATED" else holds
        res = res.cpu().numpy().astype(bool)
        return bool(res[0]) if single else res

    return check


def _decision_tree(depth: int, width: int, p_delete: float):
    """The decision prefixes a minimization batch evaluates: up to
    ``width`` tuples of decisions (True = delete), shorter than
    ``depth``, taken most likely first under independent deletions of
    probability ``p_delete``.  Taking them by a heap from the empty
    prefix keeps the set closed under prefixes."""
    lp = (math.log(p_delete), math.log(1.0 - p_delete))
    heap = [(0.0, 0, ())]
    tree = []
    n = 1
    while heap and len(tree) < width:
        cost, _, path = heapq.heappop(heap)
        tree.append(path)
        if len(path) + 1 < depth:
            for d, l in ((True, lp[0]), (False, lp[1])):
                heapq.heappush(heap, (cost - l, n, path + (d,)))
                n += 1
    return tree


def minimize_event_trace(search: TensorSearch, root_row, events: List[int],
                         check, max_passes: int = 6
                         ) -> Tuple[List[int], int]:
    """Shrink an event trace to a (bounded) fixpoint, with the result of
    the reference's greedy loop: in each pass, for each position ``i``
    in turn, replay the trace without event ``i`` and keep the deletion
    when the end state still reproduces the verdict (``check``), else
    move on; passes repeat while one deletes something, at most
    ``max_passes``.  Returns ``(minimized, passes_run)``.

    Batched: one batch replays, side by side, the candidates of several
    upcoming decisions.  For a decision prefix ``pi`` (the fates of the
    events at ``i .. i + len(pi) - 1``), its candidate is the current
    trace with the events ``pi`` deletes and the next event removed;
    every candidate shares the first ``i`` events, so the batch starts
    from their replayed state.  The prefixes are the ``width`` most
    likely under the deletion rate seen so far in the pass, closed under
    prefixes, so walking the tree from the empty prefix along the checked
    outcomes reproduces the one-at-a-time loop's decisions until the
    walk leaves the tree.  One batch costs as many ``_step_batch`` calls
    as the longest candidate has events, whatever its width; the width
    (:data:`MINIMIZE_WIDTH`, by device type) changes the cost, never the
    result."""
    events = [int(e) for e in events]
    width = MINIMIZE_WIDTH[search.device.type]
    root = _as_row(search, root_row)
    passes = 0
    changed = True
    while changed and passes < max_passes:
        changed = False
        passes += 1
        i = 0
        pre_row, pre_alive = root, True
        kept = deleted = 0
        while i < len(events):
            n = len(events)
            rate = min(max((deleted + 1) / (kept + deleted + 2), 0.05), 0.95)
            tree = _decision_tree(n - i, width, rate)
            lists, n_keep = [], []
            for path in tree:
                keep = [events[i + t] for t, d in enumerate(path) if not d]
                lists.append(keep + events[i + len(path) + 1:])
                n_keep.append(len(keep))
            rows, _, snaps = _replay(search, pre_row, pre_alive, lists,
                                     snap_at=n_keep)
            ok = check(rows)
            index = {path: r for r, path in enumerate(tree)}
            node = ()
            while True:
                d = bool(ok[index[node]])
                child = node + (d,)
                if child not in index:
                    break
                node = child
            parent_row = index[node]
            decided = node + (d,)
            fates = zip(events[i:i + len(decided)], decided)
            new = (events[:i] + [e for e, gone in fates if not gone]
                   + events[i + len(decided):])
            n_del = sum(decided)
            changed = changed or n_del > 0
            deleted += n_del
            kept += len(decided) - n_del
            i_new = i + len(decided) - n_del
            if i_new < len(new):
                # The replayed state of the new list's first i_new events:
                # the parent candidate's state before its own deletion,
                # then that event when the last decision kept it.
                pre_row = snaps[0][parent_row]
                pre_alive = bool(snaps[1][parent_row])
                if not d:
                    (pre_row,), applied, _ = _replay(
                        search, pre_row, pre_alive, [[events[i + len(node)]]])
                    pre_alive = bool(applied[0, 0])
            events, i = new, i_new
    return events, passes


def build_witness(search: TensorSearch, root_row, raw_trace: List[int],
                  end_condition: str, predicate_name: Optional[str],
                  exception_code: int, minimize: bool = True,
                  verify: bool = True) -> Witness:
    """The witness pipeline: minimize (optional), then replay-verify.  A
    failed verification is a loud RuntimeError: a swarm verdict never
    ships a trace that does not reproduce its predicate result."""
    check = _verdict_check(search, end_condition, predicate_name,
                           exception_code)
    trace, passes = (minimize_event_trace(search, root_row, raw_trace,
                                          check)
                     if minimize else (list(raw_trace), 0))
    verified = False
    if verify:
        row, n_applied = replay_events(search, root_row, trace)
        if n_applied < len(trace):
            # check() accepted a prefix mid-minimization; the dangling
            # suffix is dead weight: trim and re-verify.
            trace = trace[:n_applied]
            row, n_applied = replay_events(search, root_row, trace)
        verified = n_applied == len(trace) and check(row)
        if not verified:
            raise RuntimeError(
                f"swarm witness failed replay verification "
                f"({end_condition}, predicate={predicate_name!r}, "
                f"{n_applied}/{len(trace)} events applied): walker "
                "history or transition replay is corrupt (engine bug)")
    return Witness(end_condition=end_condition,
                   predicate_name=predicate_name,
                   exception_code=exception_code,
                   raw_trace=[int(e) for e in raw_trace], trace=trace,
                   minimized=minimize, replay_verified=verified,
                   minimize_passes=passes)


# ------------------------------------------------------------ the swarm

@read_only
def _hit_captures(carry: dict) -> tuple:
    """The first-hit capture arrays on the host: counts, rows, histories,
    depths, seed indices and the seed pool."""
    return tuple(host_copy(carry[k]) for k in (
        "hit_cnt", "hit_rows", "hit_hist", "hit_depth", "hit_seed",
        "seeds"))


def _mesh_size(mesh) -> int:
    """Devices of a ``mesh`` argument: None, a device count, a sequence
    of devices, or an object with a ``devices`` array."""
    if mesh is None:
        return 1
    if isinstance(mesh, int):
        return mesh
    devices = getattr(mesh, "devices", mesh)
    return int(np.asarray(devices, dtype=object).size)


class SwarmSearch(TensorSearch):
    """Diversified random-walk fleet on one device (module docstring).
    ``run()`` returns the standard :class:`SearchOutcome`:
    INVARIANT_VIOLATED / EXCEPTION_THROWN / GOAL_FOUND with a verified
    :class:`Witness`, else TIME_EXHAUSTED with the fleet statistics on
    ``outcome.swarm``; exhaustive verdicts stay BFS-only.  ``sanitize``
    is ``TensorSearch``'s: the hot-path audit of the swarm's four sites
    when the first run starts."""

    def __init__(self, protocol: TensorProtocol, mesh=None,
                 walkers_per_device: Optional[int] = None,
                 max_steps: Optional[int] = None,
                 min_steps: Optional[int] = None,
                 steps_per_round: Optional[int] = None,
                 max_rounds: Optional[int] = None,
                 max_secs: Optional[float] = None,
                 seed: int = 0,
                 temperature: Tuple[float, float] = (0.25, 4.0),
                 kind_affinity: float = 2.0,
                 revisit_patience: Optional[int] = None,
                 visited_cap: int = 1 << 18,
                 strict: bool = False,
                 ev_budget=None,
                 frontier_seed: Optional[str] = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0,
                 minimize: bool = True,
                 replay_verify: bool = True,
                 telemetry=None,
                 device=None,
                 sanitize: Optional[str] = None):
        if _mesh_size(mesh) > 1:
            raise _later("a mesh of more than one device",
                         "multi-device swarm")
        self.n_devices = 1
        self.walkers = int(walkers_per_device or 128)
        self.max_steps = int(max_steps or 96)
        self.min_steps = int(min_steps if min_steps is not None
                             else max(4, self.max_steps // 4))
        self.steps_per_round = int(steps_per_round or 64)
        self.max_rounds = max_rounds
        self.seed = int(seed)
        self.temperature = (float(temperature[0]), float(temperature[1]))
        self.kind_affinity = float(kind_affinity)
        # Restart steering: a walker whose last ``patience`` steps all
        # landed on visited states restarts.  <= 0 disables (the safe
        # default from a root inside a covered region).
        self.revisit_patience = int(revisit_patience or 0)
        self.frontier_seed = frontier_seed
        self.minimize = minimize
        self.replay_verify = replay_verify
        super().__init__(protocol, frontier_cap=max(self.walkers, 2),
                         chunk=self.walkers, max_secs=max_secs,
                         ev_budget=ev_budget, visited_cap=visited_cap,
                         strict=strict, checkpoint_path=checkpoint_path,
                         checkpoint_every=checkpoint_every,
                         telemetry=telemetry, device=device,
                         sanitize=sanitize)
        self.compile_secs = 0.0
        # Walk steps, and the host seconds of the rounds that ran them,
        # over every run of this search.
        self.walk_steps = 0
        self.walk_secs = 0.0

    def dispatch_site_programs(self) -> Dict[str, object]:
        """The swarm's dispatch sites for the hot-path audit (the base
        class's docstring): ``swarm.init``, the walk step, the round's
        stats and the first-hit captures, around a throwaway fleet carry
        built from the root by ``swarm.init`` itself."""
        state = self.initial_state()
        carry = self._init_carry(state)
        return {
            "swarm.init": dict(fn=self._init_carry, args=(state,)),
            "swarm.step": dict(fn=self._walk_and_check, args=(carry,),
                               builder=lambda: self._walk_and_check),
            "swarm.sync": dict(fn=self._round_stats, args=(carry, 1)),
            "swarm.flags": dict(fn=_hit_captures, args=(carry,)),
        }

    # --------------------------------------------------- diversification

    def _schedules(self):
        """Per-walker diversification arrays over the whole fleet: depth
        bounds, temperatures, kind affinities.  Deterministic functions of
        the configuration."""
        n = self.n_devices * self.walkers
        bounds = np.linspace(self.min_steps, self.max_steps, n)
        bounds = np.ceil(bounds).astype(np.int32).clip(1, self.max_steps)
        t_lo, t_hi = self.temperature
        temps = np.geomspace(max(t_lo, 1e-3), max(t_hi, 1e-3),
                             n).astype(np.float32)
        # Affinity alternates sign across the fleet, so half the walkers
        # chase timer-heavy schedules and half message-heavy ones, at
        # every temperature rung.
        affin = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
        affin = (affin * self.kind_affinity).astype(np.float32)
        return bounds, temps, affin

    def _seed_pool(self, state) -> Tuple[torch.Tensor, np.ndarray]:
        """-> (seeds [P, lanes] restart rows, preseed keys [M, 4] uint32).

        Root mode: the pool is the one root row and no key is
        pre-seeded.  Frontier mode (``frontier_seed`` = a BFS
        checkpoint): the dumped frontier rows (decoded when packed) are
        the pool, and the dump's visited keys pre-seed the table, so the
        walkers probe past the region the BFS covered."""
        root = flatten_state(state)
        if not self.frontier_seed:
            return root, np.zeros((0, 4), np.uint32)
        ck = self._load_bfs_seed(self.frontier_seed)
        rows = (torch.as_tensor(ck.frontier, device=self.device)
                if len(ck.frontier) else root)
        return rows, np.asarray(ck.visited_keys, np.uint32)

    def _load_bfs_seed(self, path: str):
        """A BFS dump for frontier seeding: any strict or beam,
        trace-recording or plain search of this protocol is a sound seed
        (only its frontier rows and visited keys are read)."""
        last = None
        for strict in (True, False):
            for rt in (False, True):
                fp = ckpt_mod.config_fingerprint(self.p, strict, rt)
                try:
                    ck = ckpt_mod.load(path, fp)
                except ckpt_mod.CheckpointMismatch as e:
                    last = e
                    continue
                if ck is not None:
                    self._normalize_ckpt_frontier(ck)
                    return ck
        if last is not None:
            raise last
        raise FileNotFoundError(
            f"frontier_seed: no BFS checkpoint at {path}")

    # ------------------------------------------------------------- carry

    _COUNTERS = ("explored", "fresh", "revisit", "restarts", "over",
                 "vis_over", "deepest")

    def _fleet_carry(self, rows, depths, hists, streak, seed_idx, seeds,
                     keys: np.ndarray, counters) -> dict:
        """The fleet carry on the device around the given walker arrays,
        with the table built from ``keys`` [M, 4] by kernel 2 (the
        pre-seeded BFS keys, or a swarm dump's table) and the hit
        captures empty."""
        S, V = self.max_steps, self.visited_cap
        dev = self.device
        nf = len(self._flag_names)
        bounds, temps, affin = self._schedules()
        table, n_ins, n_unres = visited_mod.build_table(
            V, torch.from_numpy(np.ascontiguousarray(keys).view(np.int32)),
            dev)
        if n_unres:
            raise CapacityOverflow(
                f"{self.p.name}: visited_cap={V} too small to seed the "
                f"swarm table with {len(keys)} keys ({n_unres} "
                "unresolved); raise visited_cap")
        # Keys the table held before the first walk step.
        self.preseeded_keys = n_ins
        # The host-made arrays go up in two uploads: the depth bounds with
        # the counters (int64), the temperatures with the affinities
        # (float32); the counters are views of the first.
        k = len(bounds)
        ints = torch.as_tensor(np.concatenate(
            [bounds.astype(np.int64), np.asarray(counters, np.int64)]),
            device=dev)
        flts = torch.as_tensor(np.stack([temps, affin]), device=dev)
        carry = {
            "rows": rows, "depths": depths, "hists": hists,
            "streak": streak, "seed_idx": seed_idx, "seeds": seeds,
            "bounds": ints[:k], "temps": flts[0], "affin": flts[1],
            "visited": table,
            "hit_cnt": torch.zeros((nf,), dtype=torch.int64, device=dev),
            "hit_rows": torch.zeros((nf, self.lanes), dtype=torch.int32,
                                    device=dev),
            "hit_hist": torch.full((nf, S), -1, dtype=torch.int32,
                                   device=dev),
            "hit_depth": torch.zeros((nf,), dtype=torch.int64, device=dev),
            "hit_seed": torch.zeros((nf,), dtype=torch.int64, device=dev),
        }
        for i, name in enumerate(self._COUNTERS):
            carry[name] = ints[k + i]
        return carry

    def _init_carry(self, state) -> dict:
        """The fleet carry on the device: the walkers placed round-robin
        over the seed pool, empty histories, the table pre-seeded with
        the BFS keys in frontier mode (empty in root mode), and zero
        counters."""
        K, S = self.walkers, self.max_steps
        dev = self.device
        seeds, keys = self._seed_pool(state)
        idx0 = torch.arange(K, device=dev) % seeds.shape[0]
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(self.seed)
        return self._fleet_carry(
            seeds[idx0].clone(),
            torch.zeros((K,), dtype=torch.int64, device=dev),
            torch.full((K, S), -1, dtype=torch.int32, device=dev),
            torch.zeros((K,), dtype=torch.int64, device=dev),
            idx0, seeds, keys, [0] * len(self._COUNTERS))

    # --------------------------------------------------------- walk step

    def _walk(self, c: dict) -> None:
        """One walk step of every walker, updating the carry ``c`` in
        place on the device with no host sync."""
        p = self.p
        K, S = self.walkers, self.max_steps
        dev = self.device
        rows, depths, hists = c["rows"], c["depths"], c["hists"]
        msg_ids, tmr_ids, flt_ids, _rem = self._event_tables(
            rows, torch.ones((K,), dtype=torch.bool, device=dev),
            masks=self._rt_masks)
        segs = [msg_ids, torch.where(tmr_ids >= 0, tmr_ids + p.net_cap, -1)]
        if flt_ids is not None:
            base = p.net_cap + p.n_nodes * p.timer_cap
            segs.append(torch.where(flt_ids >= 0, flt_ids + base, -1))
        ids = torch.cat(segs, dim=1)                            # [K, B]
        ok = ids >= 0
        # Diversified pick: kind-affinity bias over the valid events,
        # scaled by each walker's temperature (cold = committed to its
        # bias, hot = uniform); Gumbel-max draws one event per walker.
        is_tmr = torch.arange(ids.shape[1], device=dev) >= self._ev_msg
        kind = torch.where(is_tmr, 1.0, -1.0)[None, :]
        bias = c["affin"][:, None] * kind / c["temps"][:, None]
        logits = torch.where(ok, bias, -math.inf)
        u = torch.rand(ids.shape, generator=self._gen, device=dev)
        gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
        pick = torch.argmax(logits + gumbel, dim=1)
        any_ok = ok.any(dim=1)
        ev = torch.where(any_ok, ids.gather(1, pick[:, None])[:, 0], 0)
        succ, s_ok, s_over = self._step_batch(rows, ev)
        # A capacity-overflowed successor is truncated, and checking
        # predicates on it would be unsound: the walker restarts, and the
        # truncation is counted.
        over = any_ok & s_ok & (s_over != 0)
        advance = any_ok & s_ok & ~over
        sstate = self.unflatten_rows(succ)

        # Terminal flags, checkState order (exception -> invariants ->
        # goals; the _flag_names layout of the BFS loops).
        hit_list = [advance & (sstate["exc"] != 0)]
        for fn in p.invariants.values():
            hit_list.append(advance & ~fn(sstate))
        for fn in p.goals.values():
            hit_list.append(advance & fn(sstate))
        hits = torch.stack(hit_list)                            # [nf, K]
        pruned = torch.zeros((K,), dtype=torch.bool, device=dev)
        for fn in p.prunes.values():
            pruned = pruned | fn(sstate)

        # The history records the event before restart resolution: a
        # violating successor's trace must include its final edge.
        at = (torch.arange(S, device=dev)[None, :] == depths[:, None]) \
            & advance[:, None]
        hists2 = torch.where(at, ev.to(torch.int32)[:, None], hists)
        depths2 = depths + advance.to(torch.int64)

        # Shared dedup: advanced successors' keys into the table
        # (unresolved = table full = treated as fresh, counted).
        fp = kernels.fingerprint_rows(succ)
        _, ins, unres = visited_mod.insert(c["visited"], fp, advance)
        revisit = advance & ~ins & ~unres
        streak2 = torch.where(revisit, c["streak"] + 1, 0)
        if self.revisit_patience > 0:
            rv_restart = streak2 >= self.revisit_patience
        else:
            rv_restart = torch.zeros((K,), dtype=torch.bool, device=dev)

        # First hit of each flag (one walker's full history), from the
        # pre-restart arrays.
        cnts = hits.sum(dim=1)
        idxs = torch.argmax(hits.to(torch.int32), dim=1)
        freshf = (c["hit_cnt"] == 0) & (cnts > 0)
        c["hit_rows"] = torch.where(freshf[:, None], succ[idxs],
                                    c["hit_rows"])
        c["hit_hist"] = torch.where(freshf[:, None], hists2[idxs],
                                    c["hit_hist"])
        c["hit_depth"] = torch.where(freshf, depths2[idxs], c["hit_depth"])
        c["hit_seed"] = torch.where(freshf, c["seed_idx"][idxs],
                                    c["hit_seed"])

        # Restarts: dead end / truncated step / prune / depth bound /
        # revisit patience -> a seed row from the pool (drawn at random
        # in frontier mode; root mode's one-row pool draws nothing, so
        # its walks do not change with the pool).
        restart = ~advance | pruned | (depths2 >= c["bounds"]) | rv_restart
        n_seeds = c["seeds"].shape[0]
        if n_seeds > 1:
            ridx = torch.randint(0, n_seeds, (K,), generator=self._gen,
                                 device=dev)
            c["seed_idx"] = torch.where(restart, ridx, c["seed_idx"])
        c["rows"] = torch.where(restart[:, None], c["seeds"][c["seed_idx"]],
                                succ)
        c["depths"] = torch.where(restart, 0, depths2)
        c["hists"] = torch.where(restart[:, None], -1, hists2)
        c["streak"] = torch.where(restart, 0, streak2)
        c["explored"] += advance.sum()
        c["fresh"] += ins.sum()
        c["revisit"] += revisit.sum()
        c["restarts"] += restart.sum()
        c["over"] += over.sum()
        c["vis_over"] += unres.sum()
        c["deepest"] = torch.maximum(c["deepest"], depths2.max())
        c["hit_cnt"] += cnts
        self.walk_steps += 1

    def _round(self, carry: dict, budget: int,
               deadline: Optional[float] = None) -> np.ndarray:
        """Up to ``budget`` walk steps; stops after the step in which a
        flag first fires (one scalar read per step), or when the host
        clock passes ``deadline``.  Returns the stats vector
        [explored, fresh, revisit, restarts, over, vis_over, deepest,
        steps] ++ flag counts."""
        k = 0
        t0 = time.time()
        while k < budget:
            if deadline is not None and time.time() > deadline:
                break
            k += 1
            if self._dispatch("swarm.step", self._walk_and_check, carry):
                break
        self.walk_secs += time.time() - t0
        return self._dispatch("swarm.sync", self._round_stats, carry, k)

    def _walk_and_check(self, carry: dict) -> bool:
        """One walk step, then whether any flag has fired (the step's one
        scalar read)."""
        self._walk(carry)
        return bool((carry["hit_cnt"] > 0).any())

    @read_only
    def _round_stats(self, carry: dict, k: int) -> np.ndarray:
        """The round's stats vector: the counters, ``k``, the flag
        counts (one readback)."""
        s = torch.cat([torch.stack([carry[n] for n in self._COUNTERS]),
                       carry["hit_cnt"]]).cpu().numpy()
        n = len(self._COUNTERS)
        return np.concatenate([s[:n], np.asarray([k], np.int64), s[n:]])

    # --------------------------------------------------------------- run

    def run(self, check_initial: bool = True,
            initial: Optional[dict] = None,
            resume: bool = False) -> SearchOutcome:
        """Run the swarm to a verdict.  ``initial`` (a batch-1 state dict)
        roots the walk at an arbitrary state (the staged-search contract).
        Warm-up (the kernels' build and a zero-step round) is kept out of
        the wall budget and reported on ``outcome.compile_secs``."""
        self._maybe_sanitize()
        self._resumed_from_depth = 0
        state = self._initial_or(initial)
        self._trace_root = {k: v.cpu().numpy() for k, v in state.items()}
        t0 = time.time()
        if check_initial:
            out = self._check_initial(state, t0)
            if out is not None:
                return out
        try:
            out = self._run_rounds(state, resume)
        finally:
            self._join_ckpt_writer()
        tel = self._telemetry
        if tel is not None:
            if out.trace_id is None:
                out.trace_id = tel.trace_id
            tel.on_outcome(out, engine="swarm")
        return out

    def _run_rounds(self, state, resume: bool = False) -> SearchOutcome:
        t_c = time.time()
        if self.device.type == "cuda":
            _build.lib()
        resumed = (self._dispatch("swarm.init", self._load_swarm_ckpt)
                   if resume else None)
        if resumed is not None:
            carry, rounds, prev_elapsed = resumed
        else:
            carry = self._dispatch("swarm.init", self._init_carry, state)
            rounds, prev_elapsed = 0, 0.0
        self._round(carry, 0)
        self.compile_secs += time.time() - t_c
        tel = self._telemetry
        if tel is not None:
            # The warm-up as an event, not a span: spans stay equal to
            # dispatches.
            tel.event("compile", engine="swarm",
                      secs=round(time.time() - t_c, 4), aot=True)
        prev_explored = 0
        t0 = time.time() - prev_elapsed
        deadline = None if self.max_secs is None else t0 + self.max_secs
        stats = None
        nf = len(self._flag_names)
        while True:
            timed_out = deadline is not None and time.time() > deadline
            round_cap = (self.max_rounds is not None
                         and rounds >= self.max_rounds)
            if timed_out or round_cap or self._cancelled():
                out = self._exhaust_outcome(stats, rounds, t0)
                out.cancelled = self._cancelled()
                return out
            rounds += 1
            self._current_depth = rounds
            t_round = time.time()
            stats = self._round(carry, self.steps_per_round, deadline)
            if tel is not None:
                prev_explored = self._feed_round(tel, stats, rounds,
                                                 t_round, prev_explored)
            vis_over, over = int(stats[5]), int(stats[4])
            fill = int(stats[1]) / (self.n_devices * self.visited_cap)
            if (fill >= VISITED_WARN
                    and not getattr(self, "_warned_visited", False)):
                self._warned_visited = True
                warnings.warn(
                    f"{self.p.name}: swarm visited table ~{fill:.0%} full "
                    f"({int(stats[1])} fresh inserts vs {self.visited_cap} "
                    f"slots) at round {rounds}: capacity pressure; raise "
                    "visited_cap before overflow degrades dedup",
                    RuntimeWarning, stacklevel=2)
            # Terminal flags before the strict capacity guards: a
            # violation found this round is a valid verdict even if the
            # table filled alongside it.
            if stats[8:8 + nf].any():
                return self._resolve_hit(carry, stats, rounds, t0)
            if self.strict and vis_over:
                raise CapacityOverflow(
                    f"{self.p.name}: swarm visited table full ({vis_over} "
                    f"unresolved keys, cap {self.visited_cap}); raise "
                    "visited_cap or run strict=False")
            if self.strict and over:
                raise CapacityOverflow(
                    f"{self.p.name}: {over} walker steps truncated by "
                    "net/timer caps (strict swarm); raise the caps")
            if self._ckpt_due(rounds):
                self._save_swarm_ckpt(carry, rounds, time.time() - t0)

    def _feed_round(self, tel, stats, rounds: int, t_round: float,
                    prev_explored: int) -> int:
        """One round's level record from its stats readback (one lane:
        the fleet runs on one device).  Returns the round's explored
        count, the next round's baseline."""
        explored, fresh = int(stats[0]), int(stats[1])
        restarts, deepest = int(stats[3]), int(stats[6])
        delta = [explored - prev_explored]
        rec = {"depth": rounds, "wall": round(time.time() - t_round, 4),
               "explored": explored, "unique": fresh, "next_frontier": 0,
               "deepest": deepest, "restarts": restarts,
               "per_device": {"explored": delta, "unique": [fresh],
                              "restarts": [restarts],
                              "deepest": [deepest]},
               "skew": {"explored": tel_mod.skew_metrics(delta),
                        "unique": tel_mod.skew_metrics([fresh])}}
        hbm = tel_mod.device_memory_stats([self.device])
        if hbm is not None:
            rec["hbm_peak"] = hbm
        tel.on_level("swarm", rec)
        return explored

    # ------------------------------------------------------- checkpoints

    def _ckpt_fingerprint(self) -> str:
        """Swarm dumps are their own config family, which a BFS search
        refuses (and the reverse): the BFS fingerprint plus the history
        length and the seed, and a ``:torch`` marker, since the dump
        holds a ``torch.Generator`` state where the reference's holds
        ``jax.random`` keys; a JAX swarm dump is refused, never
        half-resumed.  The walker count is excluded, as in the
        reference."""
        base = ckpt_mod.config_fingerprint(self.p, self.strict, False)
        return f"swarm:{base}:S{self.max_steps}:seed{self.seed}:torch"

    def _save_swarm_ckpt(self, carry, rounds: int, elapsed: float) -> None:
        """Host copies of the fleet at a round boundary (walker rows,
        depths, histories, streaks, seed indices, the seed pool, the
        generator state, the table's occupied lines and the counters),
        written in the background."""
        keys = visited_mod.host_occupied(carry["visited"])
        extra = {k: host_copy(carry[k]) for k in (
            "depths", "hists", "streak", "seed_idx", "seeds")}
        extra.update({
            "seeds_n": np.asarray([carry["seeds"].shape[0]], np.int64),
            "gen_state": self._gen.get_state().numpy(),
            "vdev": np.asarray([len(keys)], np.int64),
            "counters": np.asarray([int(carry[k]) for k in
                                    self._COUNTERS], np.int64)[:, None],
        })
        ck = ckpt_mod.SearchCheckpoint(
            fingerprint=self._ckpt_fingerprint(), depth=rounds,
            explored=int(carry["explored"]), elapsed=elapsed,
            frontier=host_copy(carry["rows"]), visited_keys=keys,
            vis_over=int(carry["vis_over"]), extra=extra)
        self._ckpt_writer.kick(
            lambda: ckpt_mod.save(self.checkpoint_path, ck))

    def _load_swarm_ckpt(self):
        """-> (carry, rounds, elapsed), or None without a dump: the whole
        fleet carry rebuilt from the dump, the table re-inserted from its
        keys by kernel 2 and the generator restored, so the continuation
        is identical to the uncut run's.  One device, one walker count:
        a dump of another fleet width is refused."""
        ck = self._load_ckpt()
        if ck is None:
            return None
        x = ck.extra
        if x is None or "gen_state" not in x:
            raise ckpt_mod.CheckpointCorrupt(
                f"{self.checkpoint_path}: swarm checkpoint has no "
                "extra__ walker arrays")
        if len(ck.frontier) != self.walkers:
            raise ckpt_mod.CheckpointMismatch(
                f"{self.checkpoint_path}: swarm checkpoint of "
                f"{len(ck.frontier)} walkers, this fleet has "
                f"{self.walkers}; redistributing walkers comes with the "
                "multi-device swarm slice")
        dev = self.device

        def t(name, dtype):
            return torch.as_tensor(np.asarray(x[name]), device=dev
                                   ).to(dtype)

        self._gen = torch.Generator(device=dev)
        self._gen.set_state(torch.as_tensor(
            np.asarray(x["gen_state"], np.uint8)))
        carry = self._fleet_carry(
            torch.as_tensor(ck.frontier, device=dev),
            t("depths", torch.int64), t("hists", torch.int32),
            t("streak", torch.int64), t("seed_idx", torch.int64),
            t("seeds", torch.int32), ck.visited_keys,
            np.asarray(x["counters"], np.int64).reshape(-1))
        return carry, ck.depth, ck.elapsed

    def _stats_dict(self, stats, rounds: int, elapsed: float) -> dict:
        (explored, fresh, revisit, restarts, over, vis_over,
         deepest, _steps) = (int(x) for x in stats[:8])
        el = max(elapsed, 1e-9)
        return {
            "walkers": self.n_devices * self.walkers,
            "rounds": rounds, "explored": explored, "unique": fresh,
            "revisits": revisit, "restarts": restarts,
            "overflow_restarts": over, "vis_over": vis_over,
            "deepest": deepest,
            "walkers_per_sec": round(explored / el, 1),
            "unique_per_min": round(fresh / el * 60.0, 1),
        }

    def _finish_outcome(self, out: SearchOutcome, sd: dict) -> SearchOutcome:
        out.swarm = sd
        out.walker_restarts = sd["restarts"]
        out.swarm_overflow = sd["overflow_restarts"]
        out.visited_overflow = sd["vis_over"]
        out.compile_secs = round(self.compile_secs, 3)
        out.resumed_from_depth = self._resumed_from_depth
        if out.swarm_overflow > OVERFLOW_WARN:
            warnings.warn(
                f"{self.p.name}: {out.swarm_overflow} walker steps were "
                "capacity-truncated and restarted (net/timer caps too "
                "small for the walked region): deep coverage is degraded; "
                "raise the caps or run a strict swarm",
                RuntimeWarning, stacklevel=3)
        if out.walker_restarts > RESTART_WARN:
            warnings.warn(
                f"{self.p.name}: {out.walker_restarts} walker restarts: "
                "walkers are churning; raise max_steps",
                RuntimeWarning, stacklevel=3)
        return out

    def _exhaust_outcome(self, stats, rounds: int, t0) -> SearchOutcome:
        elapsed = time.time() - t0
        if stats is None:
            stats = np.zeros((8 + len(self._flag_names),), np.int64)
        sd = self._stats_dict(stats, rounds, elapsed)
        out = SearchOutcome("TIME_EXHAUSTED", sd["explored"], sd["unique"],
                            sd["deepest"], elapsed)
        return self._finish_outcome(out, sd)

    def _resolve_hit(self, carry, stats, rounds: int, t0) -> SearchOutcome:
        """First-hit resolution: one readback of the capture arrays,
        checkState flag order, then the witness pipeline (minimize +
        replay-verify) before the verdict is returned."""
        cnts, rows, hist, depth, seed_i, pool = self._dispatch(
            "swarm.flags", _hit_captures, carry)
        elapsed = time.time() - t0
        sd = self._stats_dict(stats, rounds, elapsed)
        for fi, fname in enumerate(self._flag_names):
            if not cnts[fi]:
                continue
            raw = [int(e) for e in hist[fi][:int(depth[fi])]]
            # The root the witness replays from (tpu/trace.py contract):
            # the walker's seed state, a frontier row under seeding.
            seed_row = pool[int(seed_i[fi])]
            self._trace_root = self._host_state(seed_row[None])
            st = self._host_state(rows[fi][None])
            if fname == "exc":
                end, pname = "EXCEPTION_THROWN", None
                code = int(st["exc"][0])
            else:
                kind, pname = fname.split(":", 1)
                end = ("INVARIANT_VIOLATED" if kind == "inv"
                       else "GOAL_FOUND")
                code = 0
            wit = build_witness(self, seed_row, raw, end, pname, code,
                                minimize=self.minimize,
                                verify=self.replay_verify)
            out = SearchOutcome(
                end, sd["explored"], sd["unique"], int(depth[fi]), elapsed,
                violating_state=(st if end != "GOAL_FOUND" else None),
                goal_state=(st if end == "GOAL_FOUND" else None),
                predicate_name=pname, exception_code=code,
                trace=wit.trace, witness=wit)
            return self._finish_outcome(out, sd)
        raise AssertionError("swarm hit counts fired without a flag")
