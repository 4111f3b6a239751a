"""Checking-as-a-service: the resident multi-tenant search server.

Counterpart of ``dslabs_tpu/service/server.py``.  The module wires the
port's layers together:

* **Admission gate** (``analysis/conformance.py``): an untrusted (factory
  spec, predicate) submission is linted in a subprocess that runs off the
  card (``CUDA_VISIBLE_DEVICES=``: the spec's own code runs there, never
  in the server, and never near the card) before any twin is compiled.
  Unsound protocols are rejected with structured findings (rule code,
  location, message); a hung or crashing admission child is itself a
  rejection, never a server stall.
* **One fault domain per job** (``tpu/warden.py``): accepted jobs run as
  warden children with their own run dir (``<root>/jobs/<job_id>/``:
  checkpoint, flight.jsonl, STATUS.json), heartbeat-reaped, so one
  tenant's OOM, hang or crash is a SIGKILL and a classified death in its
  own domain, and a neighbour's verdict stays exact.
* **Fairness-preserving degradation** (``service/scheduler.py``): deaths
  classify through the shared taxonomy and buy strictly lighter retries
  (oom -> knob-shrink re-level, wedge -> rung step), resumed from the
  job's durable checkpoint; a reported deterministic failure lands a
  structured failure verdict, never a silent partial one and never an
  unbounded retry loop.
* **Batched job lanes** (``tpu/lanes.py``): with ``lanes`` >= 2 the
  scheduler packs queued jobs with the same lane signature into one
  lane-batch child (:class:`~dslabs_tpu_torch.tpu.lanes.LaneBatchWarden`);
  a poisoned lane is evicted to a solo retry, and each lane job is billed
  its ``lane_share`` of the batch's shared dispatches.
* **Bounded backpressure** (``service/queue.py``): a full queue answers
  with a structured retry-after rejection instead of blocking.

``SERVER_STATUS.json`` (atomic tmp + replace) aggregates queue depth and
cap, backpressure, per-tenant pending / running / completed / failed /
rejected with their cost ledger, the fairness index and the ``lanes``
block.  Jobs run on the card unless the server is built with
``device="cpu"``.

CLI: ``python -m dslabs_tpu_torch.service {submit,status,drain}``
(``service/__main__.py``).  Running this module as ``__main__`` is the
admission child.

Deliberate differences from the reference: cross-job memoization
(``service/memo.py``) is not ported yet, so ``memo`` defaults to off and
``memo=True`` / ``memo_path=`` raise ``NotImplementedError``; the
``DSLABS_SERVICE_*`` environment knobs and ``DSLABS_LANES`` /
``DSLABS_LANE_SWAP`` are the module constants below and constructor
arguments; the admission child leaves the card with
``CUDA_VISIBLE_DEVICES=`` where the reference sets ``JAX_PLATFORMS=cpu``;
``elastic`` is accepted and has no effect until the sharded rung is
ported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from dslabs_tpu_torch.service.queue import Job, ServiceQueue
from dslabs_tpu_torch.service.scheduler import (AttemptPlan,
                                                DeficitRoundRobin,
                                                RetrySpec, degrade,
                                                fairness_index)
from dslabs_tpu_torch.tpu import tracing

__all__ = ["CheckServer", "SERVER_STATUS_NAME", "admission_check",
           "ADMIT_SECS", "KEEP", "WORKERS", "ADMISSION", "QUOTA", "LANES",
           "LANE_SWAP"]

SERVER_STATUS_NAME = "SERVER_STATUS.json"

# The reference's environment defaults, as constants: the admission
# child's time limit, the finished run dirs kept, the worker threads, the
# admission gate, each tenant's concurrency quota, the lane batch width
# (<= 1 is off) and continuous batching.  The front end (submit, status)
# imports no torch: the admission child and the job children do.
ADMIT_SECS = 120.0
KEEP = 64
WORKERS = 2
ADMISSION = True
QUOTA = 1
LANES = 0
LANE_SWAP = True

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _zero_stats() -> dict:
    return {"submitted": 0, "completed": 0, "failed": 0, "rejected": 0,
            "verdicts": 0, "budget_spent": 0.0}


def _memo_later() -> NotImplementedError:
    return NotImplementedError(
        "CheckServer: memo is not ported yet; it comes with the memo "
        "slice of the PyTorch port (service/memo.py, see ROADMAP.md)")


# -------------------------------------------------------------- admission

def admission_check(factory: str, factory_kwargs: Optional[dict],
                    transform: Optional[str],
                    extra_sys_path: Optional[List[str]] = None,
                    env: Optional[dict] = None,
                    timeout: float = ADMIT_SECS) -> List[dict]:
    """Run the conformance gate over one factory spec in a subprocess off
    the card.  Returns the finding dicts (``analysis.core.Finding`` shape,
    waivers applied); an empty list means admissible.  A child that hangs
    past ``timeout`` or dies abruptly is a finding: a hostile spec must
    not wedge or crash its way past the gate."""
    child_env = dict(os.environ)
    child_env["CUDA_VISIBLE_DEVICES"] = ""
    paths = [_REPO_ROOT] + list(extra_sys_path or [])
    if child_env.get("PYTHONPATH"):
        paths.append(child_env["PYTHONPATH"])
    child_env["PYTHONPATH"] = os.pathsep.join(paths)
    child_env.update(env or {})
    spec = {"factory": factory, "factory_kwargs": factory_kwargs or {},
            "transform": transform}

    def _gate_error(message: str) -> List[dict]:
        return [{"code": "C4", "leg": "conformance", "path": factory,
                 "obj": "<admission>", "line": 0, "waived": False,
                 "waiver": "", "message": message}]

    try:
        proc = subprocess.run(
            [sys.executable, "-m", "dslabs_tpu_torch.service.server"],
            input=json.dumps(spec), capture_output=True, text=True,
            env=child_env, timeout=timeout)
    except subprocess.TimeoutExpired:
        return _gate_error(
            f"admission child exceeded {timeout:.0f}s (hung import or "
            "hostile spec); rejected")
    except OSError as e:
        return _gate_error(f"admission child failed to spawn: {e}")
    if proc.returncode != 0 or not proc.stdout.strip():
        tail = (proc.stderr or "").strip().splitlines()[-1:][:1]
        return _gate_error(
            f"admission child died rc={proc.returncode} "
            f"(stderr tail: {tail}); rejected")
    try:
        return json.loads(
            proc.stdout.strip().splitlines()[-1]).get("findings", [])
    except ValueError:
        return _gate_error("admission child produced unparsable output")


# ------------------------------------------------------------------ server

class CheckServer:
    """The resident server: bounded persistent queue, admission gate, DRR
    scheduler and per-job warden fault domains.  Thread-safe; ``drain``
    runs the backlog on ``workers`` threads (each job is its own child
    process tree, so workers only coordinate).  ``device`` is where the
    jobs' children run (the card unless the caller names another)."""

    def __init__(self, root: str,
                 queue_cap: Optional[int] = None,
                 quota: int = QUOTA,
                 quotas: Optional[Dict[str, int]] = None,
                 workers: int = WORKERS,
                 admission: bool = ADMISSION,
                 retry: Optional[RetrySpec] = None,
                 warden_kwargs: Optional[dict] = None,
                 env: Optional[dict] = None,
                 extra_sys_path: Optional[List[str]] = None,
                 elastic: bool = True,
                 keep: int = KEEP,
                 lanes: int = LANES,
                 lane_swap: bool = LANE_SWAP,
                 telemetry=None,
                 memo: Optional[bool] = False,
                 memo_path: Optional[str] = None,
                 device=None):
        if memo or memo_path is not None:
            raise _memo_later()
        # Resolved when a job runs: submitting and reading status need no
        # card.
        self._device = device
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.queue = ServiceQueue(self.root, cap=queue_cap)
        # Per-tenant cost ledger (tpu/tracing.py): every finished job
        # appends one COSTS.jsonl record built from its verdict counters
        # and its run dir's flight log; a restarted server replays it.
        self.costs = tracing.CostMeter(
            os.path.join(self.root, tracing.COSTS_NAME))
        # Run-dir retention: at scheduler idle the oldest finished jobs'
        # run dirs are pruned down to ``keep``; running and queued jobs
        # are never touched.
        self.keep = keep
        # Optional parent-side recorder: retention prunes and lane-batch
        # heartbeats become flight-log events when one is attached.
        self.telemetry = telemetry
        self.workers = workers
        self.admission = bool(admission)
        self.retry = retry or RetrySpec()
        self.warden_kwargs = dict(warden_kwargs or {})
        self.env = dict(env or {})
        self.extra_sys_path = list(extra_sys_path or [])
        self.elastic = bool(elastic)
        self.sched = DeficitRoundRobin(quota=quota, quotas=quotas)
        # Batched job lanes: with lanes >= 2 the scheduler packs
        # compatible queued jobs (same lane signature, quotas kept) into
        # one lane-batch child.  Off by default: the solo path is
        # unchanged for existing callers.
        self.lanes = int(lanes)
        self.lane_swap = bool(lane_swap)
        self.lane_stats = {
            "batches": 0, "jobs": 0, "swaps": 0, "evicted": 0,
            "occupancy_sum": 0.0, "by_signature": {}}
        self._lane_seq = 0
        self.status_path = os.path.join(self.root, SERVER_STATUS_NAME)
        self._lock = threading.Lock()
        self._running: Dict[str, int] = {}
        self._active = 0
        self.stats: Dict[str, dict] = {}
        self._admission_cache: Dict[tuple, List[dict]] = {}
        self.results: List[dict] = []
        # Crash recovery: the queue replays its journal on open; every
        # still-pending job re-enters the scheduler (and resumes its own
        # run-dir checkpoint when it runs).
        for job in list(self.queue.pending):
            self.sched.push(job)
            self.stats.setdefault(job.tenant, _zero_stats())
        self._write_status()

    # ------------------------------------------------------------- submit

    def submit(self, factory: str, tenant: str = "default",
               factory_kwargs: Optional[dict] = None,
               transform: Optional[str] = None,
               strict: bool = True,
               max_depth: Optional[int] = None,
               max_secs: Optional[float] = None,
               budget_units: float = 1.0,
               chunk: int = 1 << 10,
               frontier_cap: int = 1 << 14,
               visited_cap: int = 1 << 20,
               ladder: Tuple[str, ...] = ("device", "host"),
               fault: Optional[dict] = None) -> dict:
        """The submission protocol.  Returns one of three structured
        results, never raises, never blocks:

        * ``{"accepted": True, "job_id", "queue_depth", "trace_id"}``
        * ``{"accepted": False, "reason": "unsound_spec",
          "findings": [...]}`` (the admission gate, before any compile)
        * ``{"accepted": False, "reason": "queue_full",
          "retry_after_secs", "queue_depth", "queue_cap"}``
        """
        with self._lock:
            st = self.stats.setdefault(tenant, _zero_stats())
        # One trace id per submission: the journal persists it on the job
        # record, every phase of the job's life is stamped with it, and
        # ``telemetry trace`` reassembles the causal tree from disk.
        trace_id = tracing.mint_trace_id()
        if self.admission:
            t_adm = time.time()
            findings, cached = self._admit(factory, factory_kwargs,
                                           transform)
            unwaived = [f for f in findings if not f.get("waived")]
            self.queue.log_event(
                "admission", tenant=tenant, factory=factory,
                trace_id=trace_id, secs=round(time.time() - t_adm, 3),
                cached=cached, findings=len(unwaived))
            if unwaived:
                self.queue.mark_rejected(
                    tenant, "unsound_spec",
                    {"factory": factory, "trace_id": trace_id,
                     "findings": unwaived[:8]})
                with self._lock:
                    st["rejected"] += 1
                self._write_status()
                return {"accepted": False, "rejected": True,
                        "reason": "unsound_spec", "factory": factory,
                        "trace_id": trace_id, "findings": unwaived}
        else:
            # The gate-off path still lands an admission event, so the
            # causal chain submit -> queue -> admission is unbroken.
            self.queue.log_event("admission", tenant=tenant,
                                 factory=factory, trace_id=trace_id,
                                 secs=0.0, skipped=True, findings=0)
        job = Job(job_id=self.queue.next_id(tenant), tenant=tenant,
                  factory=factory, factory_kwargs=factory_kwargs,
                  transform=transform, strict=strict,
                  max_depth=max_depth, max_secs=max_secs,
                  budget_units=budget_units, chunk=chunk,
                  frontier_cap=frontier_cap, visited_cap=visited_cap,
                  ladder=tuple(ladder), fault=fault, trace_id=trace_id)
        res = self.queue.submit(job)
        if res.get("accepted"):
            res["trace_id"] = trace_id
            with self._lock:
                self.sched.push(job)
                st["submitted"] += 1
        else:
            self.queue.mark_rejected(tenant, "queue_full",
                                     {"trace_id": trace_id})
            with self._lock:
                st["rejected"] += 1
        self._write_status()
        return res

    def _admit(self, factory, factory_kwargs,
               transform) -> Tuple[List[dict], bool]:
        """The cached admission check: ``(findings, cached)``, so the
        journal's admission event tells a paid subprocess check from a
        cache hit."""
        key = (factory, json.dumps(factory_kwargs or {}, sort_keys=True),
               transform or "")
        with self._lock:
            cached = self._admission_cache.get(key)
        if cached is not None:
            return cached, True
        findings = admission_check(factory, factory_kwargs, transform,
                                   extra_sys_path=self.extra_sys_path,
                                   env=self.env)
        with self._lock:
            self._admission_cache[key] = findings
        return findings, False

    # ------------------------------------------------------------ run job

    @property
    def device(self) -> str:
        """Where the jobs' children run: the card unless the server was
        built with another ``device`` (no card and none named raises)."""
        from dslabs_tpu_torch.tpu._build import resolve_device

        return str(resolve_device(self._device))

    def job_dir(self, job_id: str) -> str:
        return os.path.join(self.root, "jobs", job_id)

    def _failure(self, job: Job, rd: str, t0: float, kind: str,
                 attempts: int, deaths: List[dict], **extra) -> dict:
        return {"job_id": job.job_id, "tenant": job.tenant,
                "trace_id": job.trace_id, "status": "failed",
                "kind": kind, "attempts": attempts, **extra,
                "deaths": deaths, "budget_units": job.budget_units,
                "run_dir": rd, "elapsed_secs": round(time.time() - t0, 2)}

    def _warden_env(self) -> dict:
        """The server's child env, with ``extra_sys_path`` (where tenant
        factories live) on the child's PYTHONPATH beside the checkout."""
        env = dict(self.env)
        if self.extra_sys_path:
            env["PYTHONPATH"] = os.pathsep.join(
                [_REPO_ROOT] + self.extra_sys_path
                + [p for p in (env.get("PYTHONPATH")
                               or os.environ.get("PYTHONPATH", ""),) if p])
        return env

    def run_job(self, job: Job) -> dict:
        """Run one job to a verdict or a structured failure, applying the
        bounded degrade-and-retry policy (``scheduler.degrade``) across
        warden launches.  Every attempt resumes the job's own durable
        checkpoint; the fault domain is the warden child tree."""
        from dslabs_tpu_torch.tpu.supervisor import SupervisorExhausted
        from dslabs_tpu_torch.tpu.warden import Warden

        rd = self.job_dir(job.job_id)
        os.makedirs(rd, exist_ok=True)
        ckpt = os.path.join(rd, "ckpt.npz")
        plan = AttemptPlan(attempt=1, chunk=job.chunk,
                           ladder=tuple(job.ladder))
        deaths: List[dict] = []
        t0 = time.time()
        while True:
            self.queue.mark_started(job.job_id, plan.attempt)
            w = Warden(
                factory=job.factory, factory_kwargs=job.factory_kwargs,
                transform=job.transform, ladder=plan.ladder,
                checkpoint_path=ckpt, checkpoint_every=1,
                strict=job.strict, max_depth=job.max_depth,
                max_secs=job.max_secs, chunk=plan.chunk,
                frontier_cap=job.frontier_cap,
                visited_cap=job.visited_cap,
                # An injected fault models an environment condition of
                # the first attempt; a scheduler-level retry runs clean.
                fault=(job.fault if plan.attempt == 1 else None),
                env=self._warden_env(),
                # The warden forwards both over DSLABS_TRACE_ID /
                # DSLABS_PARENT_SPAN; the attempt span id is derived from
                # the journal's start record, so the child's flight-log
                # meta links back to this attempt.
                trace_id=job.trace_id,
                parent_span=plan.span_id(job.job_id),
                device=self.device, **self.warden_kwargs)
            try:
                out = w.run(resume=plan.attempt > 1)
            except SupervisorExhausted:
                deaths += [{"rung": d.rung, "kind": d.kind,
                            "detail": d.detail[:200]} for d in w.deaths]
                kind = w.deaths[-1].kind if w.deaths else "failed"
                nxt = degrade(plan, kind, self.retry)
                if nxt is None:
                    failure = self._failure(
                        job, rd, t0, kind, plan.attempt, deaths,
                        knob_shrinks=plan.knob_shrinks,
                        rung_steps=plan.rung_steps)
                    self.queue.mark_failed(job.job_id, {
                        "kind": kind, "attempts": plan.attempt,
                        "deaths": len(deaths)})
                    self._charge(failure, rd)
                    return failure
                time.sleep(self.retry.backoff(plan.attempt - 1))
                plan = nxt
                continue
            except BaseException as e:  # noqa: BLE001 - structured, never silent
                failure = self._failure(
                    job, rd, t0, "error", plan.attempt, deaths,
                    error=f"{type(e).__name__}: {e}"[:300])
                self.queue.mark_failed(job.job_id, {
                    "kind": "error", "error": failure["error"][:200]})
                self._charge(failure, rd)
                return failure
            deaths += [{"rung": d.rung, "kind": d.kind,
                        "detail": d.detail[:200]} for d in w.deaths]
            verdict = {
                "job_id": job.job_id, "tenant": job.tenant,
                "trace_id": job.trace_id,
                "budget_units": job.budget_units,
                "status": "done",
                "end": out.end_condition,
                "unique": out.unique_states,
                "explored": out.states_explored,
                "depth": out.depth,
                "engine": out.engine,
                "platform": out.platform,
                "predicate": out.predicate_name,
                "attempts": plan.attempt,
                "failovers": out.failovers,
                "child_restarts": out.child_restarts,
                "knob_shrinks": plan.knob_shrinks,
                "rung_steps": plan.rung_steps,
                "resumed_from_depth": out.resumed_from_depth,
                "degraded": bool(deaths or plan.knob_shrinks
                                 or plan.rung_steps),
                "deaths": deaths,
                "run_dir": rd,
                "elapsed_secs": round(time.time() - t0, 2),
            }
            self.queue.mark_done(job.job_id, {
                "end": out.end_condition, "unique": out.unique_states,
                "explored": out.states_explored, "depth": out.depth,
                "attempts": plan.attempt,
                "degraded": verdict["degraded"]})
            self._charge(verdict, rd)
            return verdict

    def run_job_batch(self, jobs: List[Job]) -> List[dict]:
        """Run a lane-compatible job group as one lane-batch warden child
        (``tpu/lanes.py``): every job keeps its own run dir and
        checkpoint (a SIGKILL mid-batch resumes each lane from its own
        dump), continuous batching refills drained lanes from the group,
        and a poisoned lane is evicted to a solo retry (re-queued with
        ``solo=True``), never burning a lane-mate's verdict.  Returns the
        verdicts that landed; evicted jobs return to the scheduler."""
        from dslabs_tpu_torch.tpu.lanes import (LaneBatchResult,
                                                LaneBatchWarden,
                                                job_signature)

        with self._lock:
            self._lane_seq += 1
            batch_id = f"batch-{self._lane_seq:05d}"
        bdir = os.path.join(self.root, "lanes", batch_id)
        os.makedirs(bdir, exist_ok=True)
        first = jobs[0]
        lane_jobs = []
        for job in jobs:
            rd = self.job_dir(job.job_id)
            os.makedirs(rd, exist_ok=True)
            lane_jobs.append({
                "job_id": job.job_id, "max_depth": job.max_depth,
                "max_secs": job.max_secs,
                "checkpoint_path": os.path.join(rd, "ckpt.npz"),
                "checkpoint_every": 1, "trace_id": job.trace_id})
            self.queue.mark_started(job.job_id, 1)
        n_lanes = min(self.lanes, len(jobs))
        # The journal join the trace assembler and the packing stats
        # read: which jobs shared which batch, and where its flight log is.
        self.queue.log_event(
            "lane_batch", batch=batch_id,
            jobs=[j.job_id for j in jobs], lanes=n_lanes, run_dir=bdir)
        t0 = time.time()
        w = LaneBatchWarden(
            factory=first.factory, factory_kwargs=first.factory_kwargs,
            transform=first.transform, jobs=lane_jobs, n_lanes=n_lanes,
            strict=first.strict, chunk=first.chunk,
            frontier_cap=first.frontier_cap,
            visited_cap=first.visited_cap, run_dir=bdir,
            swap=self.lane_swap, env=dict(self.env),
            extra_sys_path=self.extra_sys_path,
            telemetry=self.telemetry, device=self.device)
        try:
            res = w.run()
        except BaseException as e:  # noqa: BLE001 - structured, never silent
            res = LaneBatchResult(
                {}, {j.job_id: f"batch:error: {type(e).__name__}: "
                     f"{e}"[:300] for j in jobs})
        by_id = {j.job_id: j for j in jobs}
        elapsed = round(time.time() - t0, 2)
        bflight = os.path.join(bdir, "flight.jsonl")
        results: List[dict] = []
        for jid, out in res.outcomes.items():
            job = by_id[jid]
            verdict = {
                "job_id": jid, "tenant": job.tenant,
                "trace_id": job.trace_id,
                "budget_units": job.budget_units,
                "status": "done",
                "end": out.end_condition,
                "unique": out.unique_states,
                "explored": out.states_explored,
                "depth": out.depth,
                "engine": "lanes",
                "platform": out.platform,
                "predicate": out.predicate_name,
                "attempts": 1,
                "failovers": 0,
                "child_restarts": out.child_restarts,
                "knob_shrinks": 0, "rung_steps": 0,
                "resumed_from_depth": out.resumed_from_depth,
                "degraded": out.child_restarts > 0,
                "deaths": [{"rung": "lanes", "kind": d["kind"],
                            "detail": d["detail"][:200]}
                           for d in w.deaths],
                "run_dir": self.job_dir(jid),
                "lane_batch": batch_id,
                "lane": out.lane,
                "lanes": out.lane_width,
                "lane_share": out.lane_share,
                "elapsed_secs": elapsed,
            }
            self.queue.mark_done(jid, {
                "end": out.end_condition, "unique": out.unique_states,
                "explored": out.states_explored, "depth": out.depth,
                "attempts": 1, "degraded": verdict["degraded"],
                "lane_batch": batch_id})
            # The charge reads the batch's flight log scaled by the lane's
            # share: the shares sum to 1, so the shared stream is billed
            # once.
            self._charge(verdict, bdir)
            results.append(verdict)
        requeued = []
        for jid, err in res.errors.items():
            self.queue.log_event("lane_evicted", job_id=jid,
                                 batch=batch_id, error=err[:200])
            requeued.append(dataclasses.replace(by_id[jid], solo=True))
        with self._lock:
            for j in requeued:
                self.sched.push(j)
            ls = self.lane_stats
            ls["batches"] += 1
            ls["jobs"] += len(jobs)
            ls["swaps"] += res.swaps
            ls["evicted"] += len(res.errors)
            ls["occupancy_sum"] += res.occupancy
            per = ls["by_signature"].setdefault(
                job_signature(first) or "?", {"batches": 0, "jobs": 0})
            per["batches"] += 1
            per["jobs"] += len(jobs)
        return results

    def _charge(self, verdict: dict, run_dir: str) -> None:
        """Feed the cost meter (never fatal: accounting must not take a
        verdict down): the verdict's exact counters and the run dir's
        flight log become one COSTS.jsonl record."""
        try:
            self.costs.charge(verdict,
                              os.path.join(run_dir, "flight.jsonl"))
        except Exception:  # noqa: BLE001 - accounting is best-effort
            pass

    # ---------------------------------------------------------- retention

    def retention_sweep(self) -> List[str]:
        """Prune the oldest finished jobs' run dirs, and the oldest lane
        batches' run dirs, down to ``self.keep``.  Called at scheduler
        idle (drain end), never while that job could still run: running
        and queued jobs are excluded, and a pruned job keeps its journal
        and ledger records (only the run dir goes).  Each prune is
        journaled and, with a recorder attached, an event."""
        with self._lock:
            busy = {j.job_id
                    for q in self.sched._queues.values() for j in q}
            running = {t for t, n in self._running.items() if n > 0}

        def _seq(jid: str) -> int:
            try:
                return int(jid.rsplit("-", 1)[-1])
            except ValueError:
                return 0

        finished = []
        for jid, rec in sorted(self.queue.records.items(),
                               key=lambda kv: _seq(kv[0])):
            if rec.get("status") not in ("done", "failed"):
                continue
            if jid in busy or rec.get("tenant") in running:
                continue
            if os.path.isdir(self.job_dir(jid)):
                finished.append(jid)
        pruned: List[str] = []
        if self.keep >= 0 and len(finished) > self.keep:
            for jid in finished[:len(finished) - self.keep]:
                try:
                    shutil.rmtree(self.job_dir(jid))
                except OSError:
                    continue
                pruned.append(jid)
                self.queue.log_event("prune", job_id=jid, keep=self.keep)
                if self.telemetry is not None:
                    self.telemetry.event("prune", job_id=jid,
                                         keep=self.keep)
        # Lane-batch run dirs age out under the same bound; the journal's
        # lane_batch events (the trace join) survive.
        lanes_root = os.path.join(self.root, "lanes")
        if self.keep >= 0 and os.path.isdir(lanes_root):
            try:
                batches = sorted(os.listdir(lanes_root))
            except OSError:
                batches = []
            for b in batches[:max(0, len(batches) - self.keep)]:
                try:
                    shutil.rmtree(os.path.join(lanes_root, b))
                except OSError:
                    continue
                pruned.append(b)
                self.queue.log_event("prune", batch=b, keep=self.keep)
        return pruned

    # -------------------------------------------------------------- drain

    def drain(self, max_secs: Optional[float] = None,
              workers: Optional[int] = None) -> dict:
        """Run the backlog to completion (or the deadline) and return the
        summary: per-tenant throughput, fairness index, the ``lanes``
        block, dispatches per job, the cost ledger and the queue's
        state."""
        from dslabs_tpu_torch.tpu.lanes import job_signature

        n_workers = max(1, workers if workers is not None
                        else self.workers)
        deadline = (time.time() + max_secs) if max_secs else None
        t0 = time.time()

        def worker():
            while True:
                if deadline is not None and time.time() > deadline:
                    return
                with self._lock:
                    if self.lanes > 1:
                        # The lane packer: lane-compatible queued jobs
                        # under the same quota and deficit semantics;
                        # picking up to 2L feeds continuous batching.
                        picked = self.sched.pick_batch(
                            self._running, job_signature,
                            self.lanes * (2 if self.lane_swap else 1))
                    else:
                        job = self.sched.pick(self._running)
                        picked = [job] if job is not None else []
                    if not picked:
                        if self.sched.pending() == 0 and self._active == 0:
                            return
                    for job in picked:
                        self.queue.pop(job.job_id)
                        self._running[job.tenant] = \
                            self._running.get(job.tenant, 0) + 1
                        self._active += 1
                        st = self.stats.setdefault(job.tenant,
                                                   _zero_stats())
                        st["budget_spent"] += job.budget_units
                if not picked:
                    time.sleep(0.05)
                    continue
                try:
                    if len(picked) == 1:
                        res_list = [self.run_job(picked[0])]
                    else:
                        res_list = self.run_job_batch(picked)
                finally:
                    with self._lock:
                        for job in picked:
                            self._running[job.tenant] -= 1
                            self._active -= 1
                with self._lock:
                    for res in res_list:
                        st = self.stats.setdefault(res["tenant"],
                                                   _zero_stats())
                        if res.get("status") == "done":
                            st["completed"] += 1
                            st["verdicts"] += 1
                        else:
                            st["failed"] += 1
                        self.results.append(res)
                self._write_status()

        threads = [threading.Thread(target=worker, daemon=True,
                                    name=f"dslabs-service-worker-{i}")
                   for i in range(n_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # The scheduler is idle here: the retention sweep runs now, never
        # beside live jobs.
        self.retention_sweep()
        self._write_status()
        with self._lock:
            results = list(self.results)
            per_tenant = {t: dict(s) for t, s in self.stats.items()}
        done = [r for r in results if r.get("status") == "done"]
        wall = max(time.time() - t0, 1e-9)
        for stats in per_tenant.values():
            stats["verdicts_per_min"] = round(
                stats["verdicts"] / wall * 60.0, 2)
        totals = self.costs.totals()
        return {
            "jobs": len(results),
            "completed": len(done),
            "failed": len(results) - len(done),
            "verdicts_per_min": round(len(done) / wall * 60.0, 2),
            "fairness_index": fairness_index(per_tenant),
            # Lane amortisation: packing decisions and the mean
            # dispatches billed per job (share-scaled across batches).
            "lanes": self._lane_block(),
            "memo": {"enabled": False},
            "dispatches_per_job": totals.get("dispatches_per_job"),
            "per_tenant": per_tenant,
            "costs": self.costs.tenant_summary(),
            "cost_per_unique": totals.get("cost_per_unique"),
            "device_secs": totals.get("device_secs"),
            "queue": self.queue.summary(),
            "wall_secs": round(wall, 2),
            "results": results,
        }

    # ------------------------------------------------------------- status

    def _lane_block(self) -> dict:
        """The ``lanes`` block of SERVER_STATUS.json, the drain summary
        and ``service status``: batch width and swap, batches, jobs in
        lanes, swaps, evictions, mean occupancy, per-signature sizes."""
        with self._lock:
            ls = self.lane_stats
            return {
                "width": self.lanes,
                "swap": self.lane_swap,
                "batches": ls["batches"],
                "jobs_in_lanes": ls["jobs"],
                "swaps": ls["swaps"],
                "evicted": ls["evicted"],
                "mean_occupancy": (
                    round(ls["occupancy_sum"] / ls["batches"], 3)
                    if ls["batches"] else None),
                "by_signature": {s: dict(v) for s, v
                                 in ls["by_signature"].items()},
            }

    def server_status(self) -> dict:
        qs = self.queue.summary()
        cost_ledger = self.costs.tenant_summary()
        lane_block = self._lane_block()
        with self._lock:
            pending = self.sched.pending_by_tenant()
            tenants = {}
            for t in set(list(self.stats) + list(pending)
                         + list(self._running)):
                s = self.stats.get(t, _zero_stats())
                tenants[t] = {
                    "pending": pending.get(t, 0),
                    "running": self._running.get(t, 0),
                    "completed": s["completed"],
                    "failed": s["failed"],
                    "rejected": s["rejected"],
                    "budget_spent": round(s["budget_spent"], 3),
                    # What the tenant's budget bought, from COSTS.jsonl.
                    "costs": cost_ledger.get(t),
                }
            return {
                "t": "server_status",
                "updated": round(time.time(), 3),
                "pid": os.getpid(),
                "workers": self.workers,
                "queue_depth": qs["queue_depth"],
                "queue_cap": qs["queue_cap"],
                "backpressure": qs["backpressure"],
                "journal_error": qs["journal_error"],
                "tenants": tenants,
                "fairness_index": fairness_index(self.stats),
                "lanes": lane_block,
                "memo": {"enabled": False},
            }

    def _write_status(self) -> None:
        """Atomic SERVER_STATUS.json rewrite (tmp + ``os.replace``): a
        reader or a SIGKILL never sees a torn file; an unwritable root
        disables the monitor, never the service."""
        if self.status_path is None:
            return
        st = self.server_status()
        tmp = self.status_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                f.write(json.dumps(st))
            os.replace(tmp, self.status_path)
        except OSError:
            self.status_path = None

    def close(self) -> None:
        self.queue.close()
        self.costs.close()


# ------------------------------------------------------- admission child

def _admission_main() -> int:
    """The admission child, off the card: read one factory spec from
    stdin, lint its module with the port's conformance linter, build the
    spec object (never a twin or an engine: no search is constructed),
    run the live C4 introspection when it is a ProtocolSpec, and print the
    waiver-applied findings as one JSON line.  Any escape is the parent's
    "child died" rejection: a hostile spec cannot crash its way past."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    spec = json.load(sys.stdin)
    factory = spec["factory"]
    mod_name = factory.partition(":")[0]

    from dslabs_tpu_torch.analysis import conformance
    from dslabs_tpu_torch.analysis.core import (Finding, apply_waivers,
                                                load_waivers, repo_root)
    from dslabs_tpu_torch.tpu.warden import _resolve

    findings: List[Finding] = []

    def _gate(message: str, code: str = "C4", line: int = 0) -> None:
        findings.append(Finding(
            code=code, leg="conformance", path=factory,
            obj="<admission>", line=line, message=message))

    mod = None
    try:
        import importlib

        mod = importlib.import_module(mod_name)
    except BaseException as e:  # noqa: BLE001 - import errors are findings
        _gate(f"factory import failed: {type(e).__name__}: {e}")
    if mod is not None and getattr(mod, "__file__", None):
        rel = factory
        try:
            with open(mod.__file__) as f:
                src = f.read()
            rel = os.path.relpath(mod.__file__, repo_root())
            if rel.startswith(".."):
                rel = mod.__file__
            findings += conformance.lint_source(src, rel)
        except OSError as e:
            _gate(f"factory module unreadable: {e}")
        from dslabs_tpu_torch.tpu.compiler import ProtocolSpec, SpecError

        try:
            proto = _resolve(factory)(**(spec.get("factory_kwargs") or {}))
            if spec.get("transform"):
                proto = _resolve(spec["transform"])(proto)
            if isinstance(proto, ProtocolSpec):
                findings += conformance.check_spec(proto, origin=rel)
        except SpecError as e:
            _gate(str(e), code=e.code, line=e.line or 0)
        except BaseException as e:  # noqa: BLE001 - a raising factory is unsound
            _gate(f"factory raised {type(e).__name__}: {e}")
    try:
        apply_waivers(findings, load_waivers())
    except ValueError as e:
        _gate(f"waiver file malformed: {e}")
    sys.stdout.write(json.dumps(
        {"findings": [f.as_dict() for f in findings]}) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(_admission_main())
