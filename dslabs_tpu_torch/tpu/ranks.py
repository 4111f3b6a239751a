"""The rank launcher: the owner-sharded engine over a :class:`RankMesh`,
one process per rank.

Counterpart of the reference's single controller over ``jax.devices()``
(``dslabs_tpu/tpu/sharded.py make_mesh``), which a torch process does
not have: a mesh over distinct devices runs one process per device, each
holding one shard of ``ShardedTensorSearch`` on its own device, and the
shards' collectives go through ``torch.distributed``
(``tpu/mesh_exchange.py ProcessGroupExchange``: NCCL across distinct
cards, gloo on the CPU and for ranks that share a card).

* **One process per rank.**  :func:`launch` starts ``python -m
  dslabs_tpu_torch.tpu.ranks`` once per device of the mesh.  Each rank
  reads its spec on stdin (the warden's form: a ``"module:callable"``
  protocol factory with ``factory_kwargs`` and an optional transform,
  the engine's arguments, the devices, the backend, a ``file://``
  rendezvous under a fresh temporary directory, the process group's
  timeout), joins the group, runs its jobs in order and prints one JSON
  line: each job's result, its kernel launches, its peak device memory
  and its seconds.  A job is a search (``ShardedTensorSearch`` over the
  rank's exchange: its outcome, level records and launches), a swarm
  (``SwarmSearch``: one walker group per rank, each with its own
  generator; its witness minimized and replay-verified on rank 0), an
  audit of the engine's (or, with ``"swarm": True``, the swarm's)
  dispatch sites (``analysis/hotpath_audit.py``), or a call of a
  ``"module:callable"`` with the rank's exchange.
* **Kernels.**  A card rank loads the kernel library before it joins the
  group; the launcher builds it first, and ``tpu/_build.py`` serializes
  concurrent builds with a file lock, so two ranks on one card never
  write the build directory at once.  A rank whose card is missing, or
  whose library does not load, fails the run: it never falls back to
  the plain versions.
* **A dead rank kills the group.**  A rank that exits non-zero, reports
  an error, or gives no result by the launch's deadline (or that gloo
  or NCCL reports as a dead peer to the others) fails the launch: the
  launcher SIGKILLs every rank, reaps them, and raises
  ``EngineFailure(kind="fatal")`` naming the first rank that failed.  A
  configuration or semantic error (``CapacityOverflow``,
  ``CheckpointMismatch``, ``ValueError``, ``TypeError``,
  ``NotImplementedError``) raised in a rank is raised again as itself.
  No child outlives the launcher.
* :func:`run_sharded` is one search: rank 0's outcome (every rank
  computes the same one from replicated values; the launcher checks
  that they agree), with ``levels`` (their ``per_device`` lanes list
  every rank's shard) and ``ranks``, one record per rank;
  :func:`run_swarm` is one swarm.  :class:`RankSearch` and
  :class:`RankSwarm` are the supervisor's sharded rung and portfolio
  swarm lane over a ``RankMesh``; the portfolio's cancel event kills a
  launch (:class:`Cancelled`), which the lane reports as a cancelled
  TIME_EXHAUSTED outcome.
* **Faults and heartbeats.**  A supervisor's ``FaultPlan`` crosses to
  the ranks rule by rule (a rule's ``rank`` picks the rank it fires
  in), with its ``RetryPolicy``; ``observer`` receives rank 0's
  dispatch heartbeats, ``observer(phase, tag, index, depth)``, as a
  warden child's boundary observer does.

Children run with ``OMP_NUM_THREADS=1`` and the checkout on
``PYTHONPATH``.  ``tensor_bfs`` (``tpu/backend.py``) and the chaos soak
(``tpu/chaos.py``) stay in one process on ``LocalExchange``.
"""

from __future__ import annotations

import dataclasses
import datetime
import inspect
import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Optional

__all__ = ["launch", "run_sharded", "run_swarm", "search_job", "swarm_job",
           "outcome_of", "RankSearch", "RankSwarm", "Cancelled",
           "fault_rules", "DEADLINE", "PG_TIMEOUT"]

# Seconds a launch may take before its ranks are killed, and the process
# group's own timeout (a collective waiting on a dead peer gives up).
DEADLINE = 900.0
PG_TIMEOUT = 120.0

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# Errors a rank reports that the launcher raises again as themselves.
_REPLAYED = ("CapacityOverflow", "CheckpointMismatch", "ValueError",
             "TypeError", "NotImplementedError")


def _ref(obj) -> str:
    return f"{obj.__module__}:{obj.__qualname__}"


def fault_rules(plan) -> list:
    """A ``FaultPlan``'s rules as JSON-ready dicts (the error as a
    ``"module:qualname"`` reference)."""
    if plan is None:
        return []
    out = []
    for r in plan.rules:
        d = dataclasses.asdict(r)
        d["error"] = _ref(r.error)
        out.append(d)
    return out


def _plan_for(rules: list, rank: int):
    from dslabs_tpu_torch.tpu.supervisor import FaultPlan, FaultRule
    from dslabs_tpu_torch.tpu.warden import _resolve

    if not rules:
        return None
    plan = FaultPlan()
    plan.rank = rank
    for d in rules:
        plan.rules.append(FaultRule(**{**d, "error": _resolve(d["error"])}))
    return plan


def _launch_counts() -> dict:
    from dslabs_tpu_torch.tpu import kernels, visited

    return {"fingerprint_rows": kernels.LAUNCHES["fingerprint_rows"],
            "insert": visited.LAUNCHES["insert"]}


# ----------------------------------------------------------------- launcher

def _kill_all(procs) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                p.kill()
            except OSError:
                pass
    for p in procs:
        p.wait()


class Cancelled(Exception):
    """A launch whose ``cancel`` event was set: its ranks were killed."""


def launch(mesh, jobs: List[dict], deadline: float = DEADLINE,
           pg_timeout: Optional[float] = None, env: Optional[dict] = None,
           observer=None, cancel=None) -> List[dict]:
    """Run ``jobs`` on one rank per device of ``mesh`` (module
    docstring); returns each rank's result line, rank order.  Raises
    ``EngineFailure`` (kind ``fatal``) naming the first rank that died,
    or the rank's own configuration error; :class:`Cancelled` once
    ``cancel`` (a ``threading.Event``) is set, after killing the
    ranks."""
    from dslabs_tpu_torch.tpu.supervisor import EngineFailure

    if any(d.type == "cuda" for d in mesh.devices):
        from dslabs_tpu_torch.tpu import _build

        _build.build()
    tmp = tempfile.mkdtemp(prefix="dslabs-ranks-")
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = os.pathsep.join(
        [_REPO_ROOT] + ([child_env["PYTHONPATH"]]
                        if child_env.get("PYTHONPATH") else []))
    child_env["OMP_NUM_THREADS"] = "1"
    child_env.update(env or {})
    timeout = float(pg_timeout if pg_timeout is not None
                    else min(PG_TIMEOUT, deadline))
    msgs: "queue.Queue[tuple]" = queue.Queue()
    procs: List[subprocess.Popen] = []
    tails: List[List[str]] = []
    t_end = time.time() + float(deadline)

    def read_out(rank, stream):
        for line in stream:
            try:
                msgs.put((rank, json.loads(line)))
            except ValueError:
                continue          # stray output, not protocol
        msgs.put((rank, {"t": "eof"}))

    def read_err(rank, stream):
        for line in stream:
            tails[rank].append(line.rstrip()[:300])
            del tails[rank][:-8]
            sys.stderr.write(line)
        sys.stderr.flush()

    try:
        for rank in range(mesh.width):
            spec = {"rank": rank, **mesh.spec(), "jobs": jobs,
                    "rendezvous": "file://" + os.path.join(tmp, "rdv"),
                    "pg_timeout": timeout, "parent": os.getpid(),
                    "heartbeat": observer is not None and rank == 0}
            p = subprocess.Popen(
                [sys.executable, "-m", "dslabs_tpu_torch.tpu.ranks"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=child_env)
            procs.append(p)
            tails.append([])
            threading.Thread(target=read_out, args=(rank, p.stdout),
                             daemon=True).start()
            threading.Thread(target=read_err, args=(rank, p.stderr),
                             daemon=True).start()
            try:
                p.stdin.write(json.dumps(spec))
                p.stdin.close()
            except BrokenPipeError:
                pass
        results: dict = {}
        failed = None
        while failed is None and len(results) < mesh.width:
            if cancel is not None and cancel.is_set():
                _kill_all(procs)
                raise Cancelled(f"launch over {mesh} cancelled")
            if time.time() > t_end:
                late = [r for r in range(mesh.width) if r not in results]
                failed = (late[0], None,
                          f"no result by the launch's deadline "
                          f"({deadline:.0f} s); ranks {late} unfinished")
                break
            try:
                rank, msg = msgs.get(timeout=0.1)
            except queue.Empty:
                continue
            t = msg.get("t")
            if t == "hb":
                if observer is not None:
                    observer(msg.get("phase"), msg.get("tag"),
                             msg.get("n"), msg.get("depth"))
            elif t == "result":
                results[rank] = msg
            elif t == "err":
                failed = (rank, msg, msg.get("error", "rank failure"))
            elif t == "eof":
                if rank not in results:
                    rc = procs[rank].wait()
                    failed = (rank, None,
                              f"exited rc={rc} without a result (stderr "
                              f"tail: {tails[rank][-3:]})")
        if failed is not None:
            _kill_all(procs)
            rank, msg, detail = failed
            if msg is not None and msg.get("type") in _REPLAYED:
                raise _replayed(msg["type"], f"rank {rank}: {detail}")
            raise EngineFailure("sharded", "fatal", RuntimeError(
                f"rank {rank} of {mesh.width} ({mesh.devices[rank]}, "
                f"{mesh.backend}) died: {detail}"))
        for p in procs:
            try:
                p.wait(timeout=max(1.0, t_end - time.time()))
            except subprocess.TimeoutExpired:
                pass
        return [results[r] for r in range(mesh.width)]
    finally:
        _kill_all(procs)
        shutil.rmtree(tmp, ignore_errors=True)


def _replayed(name: str, message: str) -> BaseException:
    from dslabs_tpu_torch.tpu import checkpoint as ckpt_mod
    from dslabs_tpu_torch.tpu.engine import CapacityOverflow

    cls = {"CapacityOverflow": CapacityOverflow,
           "CheckpointMismatch": ckpt_mod.CheckpointMismatch,
           "ValueError": ValueError, "TypeError": TypeError,
           "NotImplementedError": NotImplementedError}[name]
    return cls(message)


def search_job(factory: str, factory_kwargs: Optional[dict] = None,
               transform: Optional[str] = None, resume: bool = False,
               check_initial: bool = True, fault_plan=None, policy=None,
               **engine_kw) -> dict:
    """A search job of :func:`launch`: ``ShardedTensorSearch(protocol,
    mesh, **engine_kw).run(resume=...)`` on every rank."""
    ev = engine_kw.get("ev_budget")
    if isinstance(ev, tuple):
        engine_kw["ev_budget"] = list(ev)
    if dataclasses.is_dataclass(engine_kw.get("spill")):
        # A SpillConfig crosses as its fields.
        engine_kw["spill"] = {"config": dataclasses.asdict(
            engine_kw["spill"])}
    return {"kind": "search", "factory": factory,
            "factory_kwargs": factory_kwargs or {}, "transform": transform,
            "resume": bool(resume), "check_initial": bool(check_initial),
            "fault_rules": fault_rules(fault_plan),
            "policy": dataclasses.asdict(policy) if policy else None,
            "engine": engine_kw}


def swarm_job(factory: str, factory_kwargs: Optional[dict] = None,
              transform: Optional[str] = None, check_initial: bool = True,
              resume: bool = False, **swarm_kw) -> dict:
    """A swarm job of :func:`launch`: ``SwarmSearch(protocol, mesh,
    **swarm_kw).run(resume=...)`` on every rank, one walker group per
    rank."""
    for k in ("temperature", "ev_budget"):
        if isinstance(swarm_kw.get(k), tuple):
            swarm_kw[k] = list(swarm_kw[k])
    return {"kind": "swarm", "factory": factory,
            "factory_kwargs": factory_kwargs or {}, "transform": transform,
            "check_initial": bool(check_initial), "resume": bool(resume),
            "engine": swarm_kw}


def run_swarm(factory: str, mesh, factory_kwargs: Optional[dict] = None,
              transform: Optional[str] = None, check_initial: bool = True,
              resume: bool = False, deadline: float = DEADLINE,
              pg_timeout: Optional[float] = None, env: Optional[dict] = None,
              cancel=None, **swarm_kw):
    """One ``SwarmSearch`` over ``mesh`` (a :class:`RankMesh`) in its
    ranks; returns rank 0's ``SearchOutcome`` (its witness minimized and
    replay-verified on rank 0)."""
    res = launch(mesh, [swarm_job(factory, factory_kwargs, transform,
                                  check_initial, resume, **swarm_kw)],
                 deadline=deadline, pg_timeout=pg_timeout, env=env,
                 cancel=cancel)
    return outcome_of(res, 0)


def run_sharded(factory: str, mesh, factory_kwargs: Optional[dict] = None,
                transform: Optional[str] = None, resume: bool = False,
                check_initial: bool = True, deadline: float = DEADLINE,
                pg_timeout: Optional[float] = None,
                env: Optional[dict] = None, observer=None, fault_plan=None,
                policy=None, cancel=None, **engine_kw):
    """One ``ShardedTensorSearch`` over ``mesh`` (a :class:`RankMesh`) in
    its ranks; returns rank 0's ``SearchOutcome`` with ``levels`` and
    ``ranks`` (module docstring)."""
    job = search_job(factory, factory_kwargs, transform, resume,
                     check_initial, fault_plan, policy, **engine_kw)
    res = launch(mesh, [job], deadline=deadline, pg_timeout=pg_timeout,
                 env=env, observer=observer, cancel=cancel)
    return outcome_of(res, 0)


def outcome_of(results: List[dict], i: int):
    """Job ``i``'s outcome from :func:`launch`'s results: rank 0's, with
    its level records and one record per rank; raises when the ranks'
    verdicts disagree."""
    from dslabs_tpu_torch.tpu.warden import outcome_from_dict

    jobs = [r["results"][i] for r in results]
    keys = {tuple(j["outcome"][k] for k in (
        "end_condition", "unique_states", "states_explored", "depth"))
        for j in jobs}
    if len(keys) != 1:
        raise RuntimeError(f"ranks disagree on the verdict: {sorted(keys)}")
    out = outcome_from_dict(jobs[0]["outcome"])
    out.levels = jobs[0].get("levels")
    out.swarm = jobs[0].get("swarm")
    if jobs[0].get("witness") is not None:
        from dslabs_tpu_torch.tpu.swarm import Witness

        out.witness = Witness(**jobs[0]["witness"])
    out.ranks = [{"rank": r["rank"], "device": r["device"],
                  "launches": j["launches"], "peak_bytes": j["peak_bytes"],
                  "secs": j["secs"], "retries": j["retries"],
                  "chunk_steps": j.get("chunk_steps"),
                  "exchange_calls": j["exchange_calls"],
                  "exchange_bytes": j["exchange_bytes"]}
                 for r, j in zip(results, jobs)]
    return out


class RankSearch:
    """The supervisor's sharded rung over a :class:`RankMesh`: each
    ``run`` is one :func:`run_sharded` launch of the protocol factory,
    carrying the installed boundary's fault plan, retry policy and
    heartbeat observer to the ranks.  It holds no carry: a failed rung
    releases nothing in this process."""

    def __init__(self, protocol, mesh, factory: str,
                 factory_kwargs: Optional[dict] = None,
                 transform: Optional[str] = None, **engine_kw):
        self.protocol = protocol
        self.mesh = mesh
        self.device = mesh.device
        self.factory = factory
        self.factory_kwargs = factory_kwargs
        self.transform = transform
        self.engine_kw = engine_kw
        self.max_depth = engine_kw.pop("max_depth", None)
        self.max_secs = engine_kw.pop("max_secs", None)
        self.checkpoint_path = engine_kw.get("checkpoint_path")
        self._dispatch_boundary = None
        self._dispatch_hook = None
        self._cancel_event = None
        self._telemetry = None
        self._last_dev_carry = None
        self._resumed_from_depth = 0

    def _ckpt_fingerprint(self) -> str:
        from dslabs_tpu_torch.tpu import checkpoint as ckpt_mod

        return ckpt_mod.config_fingerprint(
            self.protocol, self.engine_kw.get("strict", True),
            self.engine_kw.get("record_trace", False))

    def has_resumable_checkpoint(self) -> bool:
        from dslabs_tpu_torch.tpu import checkpoint as ckpt_mod

        if not self.checkpoint_path:
            return False
        fp = ckpt_mod.peek_fingerprint(self.checkpoint_path)
        return fp is not None and fp == self._ckpt_fingerprint()

    def run(self, check_initial: bool = True, initial=None,
            resume: bool = False):
        if initial is not None:
            raise ValueError(
                "a RankMesh search cannot ship an in-memory initial state "
                "to its ranks; encode it in the protocol factory")
        b = self._dispatch_boundary
        t0 = time.time()
        try:
            out = run_sharded(
                self.factory, self.mesh, factory_kwargs=self.factory_kwargs,
                transform=self.transform, resume=resume,
                check_initial=check_initial,
                observer=b.observer if b is not None else None,
                fault_plan=b.plan if b is not None else None,
                policy=b.policy if b is not None else None,
                cancel=self._cancel_event, max_depth=self.max_depth,
                max_secs=self.max_secs, **self.engine_kw)
        except Cancelled:
            out = _cancelled_outcome(t0)
        self._resumed_from_depth = out.resumed_from_depth
        return out


def _cancelled_outcome(t0: float):
    """The outcome of a rank run the portfolio's other lane cut short (a
    TIME_EXHAUSTED shape marked ``cancelled``, as the in-process engines
    give at their next boundary)."""
    from dslabs_tpu_torch.tpu.engine import SearchOutcome

    out = SearchOutcome("TIME_EXHAUSTED", 0, 0, 0, time.time() - t0)
    out.cancelled = True
    return out


class RankSwarm:
    """The supervisor's swarm lane over a :class:`RankMesh`: each ``run``
    is one :func:`run_swarm` launch of the protocol factory (one walker
    group per rank); the portfolio's cancel event kills the launch."""

    def __init__(self, protocol, mesh, factory: str,
                 factory_kwargs: Optional[dict] = None,
                 transform: Optional[str] = None, **swarm_kw):
        self.protocol = protocol
        self.mesh = mesh
        self.device = mesh.device
        self.factory = factory
        self.factory_kwargs = factory_kwargs
        self.transform = transform
        self.swarm_kw = swarm_kw
        self._dispatch_boundary = None
        self._dispatch_hook = None
        self._cancel_event = None
        self._telemetry = None

    def run(self, resume: bool = False, initial=None,
            check_initial: bool = True):
        if initial is not None:
            raise ValueError(
                "a RankMesh swarm cannot ship an in-memory initial state "
                "to its ranks; encode it in the protocol factory")
        t0 = time.time()
        try:
            return run_swarm(self.factory, self.mesh,
                             factory_kwargs=self.factory_kwargs,
                             transform=self.transform,
                             check_initial=check_initial, resume=resume,
                             cancel=self._cancel_event, **self.swarm_kw)
        except Cancelled:
            return _cancelled_outcome(t0)


# ------------------------------------------------------------- rank half

def _send(obj: dict) -> None:
    def plain(x):
        if hasattr(x, "tolist"):
            return x.tolist()
        if hasattr(x, "item"):
            return x.item()
        raise TypeError(f"not JSON-ready: {type(x).__name__}")

    sys.stdout.write(json.dumps(obj, default=plain) + "\n")
    sys.stdout.flush()


def _protocol(job: dict):
    from dslabs_tpu_torch.tpu.warden import _resolve

    proto = _resolve(job["factory"])(**(job.get("factory_kwargs") or {}))
    if job.get("transform"):
        proto = _resolve(job["transform"])(proto)
    return proto


def _engine(job: dict, mesh):
    from dslabs_tpu_torch.tpu.sharded import ShardedTensorSearch

    kw = dict(job.get("engine") or {})
    if isinstance(kw.get("ev_budget"), list):
        kw["ev_budget"] = tuple(kw["ev_budget"])
    if isinstance(kw.get("spill"), dict):
        from dslabs_tpu_torch.tpu.spill import SpillConfig

        kw["spill"] = SpillConfig(**kw["spill"]["config"])
    return ShardedTensorSearch(_protocol(job), mesh, **kw)


def _swarm(job: dict, mesh):
    from dslabs_tpu_torch.tpu.swarm import SwarmSearch

    kw = dict(job.get("engine") or {})
    for k in ("temperature", "ev_budget"):
        if isinstance(kw.get(k), list):
            kw[k] = tuple(kw[k])
    return SwarmSearch(_protocol(job), mesh, **kw)


def _run_job(job: dict, mesh, rank: int, heartbeat: bool) -> dict:
    import torch

    from dslabs_tpu_torch.tpu.supervisor import DispatchBoundary, RetryPolicy
    from dslabs_tpu_torch.tpu.warden import _resolve, outcome_to_dict

    dev = mesh.devices[rank]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    l0 = _launch_counts()
    t0 = time.time()
    res: dict = {}
    kind = job.get("kind", "search")
    ex = None
    if kind == "search":
        s = _engine(job, mesh)
        ex = s.exchange
        observer = None
        if heartbeat:
            def observer(phase, tag, idx, depth):
                _send({"t": "hb", "phase": phase, "tag": tag, "n": idx,
                       "depth": depth})
        boundary = DispatchBoundary(
            RetryPolicy(**(job.get("policy") or {})),
            _plan_for(job.get("fault_rules"), rank), observer=observer)
        boundary.install(s, engine="sharded")
        out = s.run(check_initial=job.get("check_initial", True),
                    resume=bool(job.get("resume")))
        res = {"outcome": outcome_to_dict(out), "levels": out.levels,
               "retries": boundary.retries, "chunk_steps": s.chunk_steps}
    elif kind == "swarm":
        s = _swarm(job, mesh)
        ex = s.exchange
        out = s.run(check_initial=job.get("check_initial", True),
                    resume=bool(job.get("resume")))
        res = {"outcome": outcome_to_dict(out), "swarm": out.swarm,
               "witness": (dataclasses.asdict(out.witness)
                           if out.witness is not None else None),
               "chunk_steps": s.walk_steps}
    elif kind == "audit":
        from dslabs_tpu_torch.analysis import hotpath_audit

        s = _swarm(job, mesh) if job.get("swarm") else _engine(job, mesh)
        ex = s.exchange
        report: dict = {}
        found = hotpath_audit.audit_search(s, report=report)
        res = {"findings": [f.as_dict() for f in found], "report": report,
               "staged": bool(ex.staged)}
    elif kind == "call":
        ex = mesh.exchange()
        res = {"value": _resolve(job["fn"])(
            exchange=ex, **(job.get("kwargs") or {}))}
    else:
        raise ValueError(f"unknown rank job kind {kind!r}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    l1 = _launch_counts()
    res.update(
        launches={k: l1[k] - l0[k] for k in l0}, secs=time.time() - t0,
        peak_bytes=(torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else None),
        retries=res.get("retries", 0),
        exchange_calls=ex.calls if ex is not None else 0,
        exchange_bytes=ex.bytes_sent if ex is not None else 0)
    return res


def _die_with_parent(parent: int) -> None:
    """SIGKILL this rank when its launcher dies (Linux), so that no rank
    outlives a launcher that was itself killed."""
    import ctypes
    import signal

    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, int(signal.SIGKILL), 0, 0, 0)   # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def _rank_main() -> int:
    from dslabs_tpu_torch.tpu.mesh_exchange import RankMesh
    from dslabs_tpu_torch.tpu.supervisor import CHILD_RC_FAILED

    spec = json.load(sys.stdin)
    _die_with_parent(int(spec["parent"]))
    rank = int(spec["rank"])
    try:
        import torch
        import torch.distributed as dist

        mesh = RankMesh(spec["devices"], spec["backend"])
        dev = mesh.devices[rank]
        if dev.type == "cuda":
            if not torch.cuda.is_available() or \
                    dev.index >= torch.cuda.device_count():
                raise RuntimeError(f"rank {rank}: device {dev} is missing "
                                   f"({torch.cuda.device_count()} cards)")
            torch.cuda.set_device(dev)
            from dslabs_tpu_torch.tpu import _build

            _build.lib()
        kw = {}
        if mesh.backend == "nccl" and "device_id" in inspect.signature(
                dist.init_process_group).parameters:
            kw["device_id"] = dev
        dist.init_process_group(
            mesh.backend, init_method=spec["rendezvous"], rank=rank,
            world_size=mesh.width,
            timeout=datetime.timedelta(seconds=float(spec["pg_timeout"])),
            **kw)
        results = [_run_job(job, mesh, rank, bool(spec.get("heartbeat")))
                   for job in spec["jobs"]]
        dist.barrier()
    except BaseException as e:  # noqa: BLE001 - reported on the pipe
        _send({"t": "err", "rank": rank, "type": type(e).__name__,
               "kind": getattr(e, "kind", "fatal"),
               "error": f"{type(e).__name__}: {e}"[:2000]})
        sys.stderr.flush()
        # Not a clean shutdown: peers may sit in a collective with us.
        os._exit(CHILD_RC_FAILED)
    _send({"t": "result", "rank": rank, "device": str(dev),
           "results": results})
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    _rank_main()
