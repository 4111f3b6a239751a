"""Process-isolated dispatch warden: hang-proof failover supervision.

Counterpart of ``dslabs_tpu/tpu/warden.py``.  The in-process supervisor
(``tpu/supervisor.py``) retries, watchdogs and fails over, but a wedged
CUDA call cannot be interrupted from Python: the watchdog can only
abandon the dispatch, leaking a blocked thread that keeps holding the
context, and a sticky CUDA error poisons the whole process.  This module
runs each rung in a process of its own instead:

* **Spawned child per rung.**  :class:`Warden` runs the search loop in a
  child process (``python -m dslabs_tpu_torch.tpu.warden``) supervised
  over a pipe.  The child rebuilds the protocol from a
  ``"module:callable"`` factory of the port (live protocol objects hold
  closures that cannot cross a spawn boundary), for example
  ``dslabs_tpu_torch.tpu.protocols.pingpong:make_pingpong_protocol``,
  and runs a single-rung :class:`SearchSupervisor` on the spec's
  ``device``.
* **Heartbeats from the dispatch seam.**  The child installs a dispatch
  observer at ``TensorSearch._dispatch`` and writes one JSON line per
  dispatch attempt: tag, dispatch index, live BFS depth and the last
  durable checkpoint depth (``checkpoint.peek_depth``).  Every heartbeat
  announces its own silence budget (``grace``): the first dispatch at a
  tag (which pays the kernels' build) gets ``first_grace``, a steady
  dispatch ``steady_grace``, the host work between dispatches
  ``idle_grace``.
* **SIGKILL, not abandonment.**  A child silent past its announced grace
  (+ ``grace_slack``) is SIGKILLed and reaped: no leaked thread, no
  zombie, no context left behind.  The death is classified from the exit
  code and the stderr tail (:func:`classify_death`).
* **Failover and durable resume.**  After a death the warden spawns the
  next rung's child, which resumes from the unified checkpoint
  (``tpu/checkpoint.py``, checksummed with ``.prev`` rotation, so a
  SIGKILL mid-dump costs one checkpoint interval).  A child that replaces
  a dead one on the last rung runs with ``device="cpu"`` in its spec and
  ``CUDA_VISIBLE_DEVICES=`` in its environment, so a verdict lands even
  when the card itself is the broken part; the move is visible on
  ``Warden.last_platform`` and on the outcome's ``platform`` and
  ``engine``.  A first child keeps the caller's device.  A ladder that wants its resume on the card lists
  the ``device`` rung twice: ``("device", "device", "host")``.
* **Same verdicts.**  ``SearchSupervisor(process_isolation=True)`` rides
  this class; outcomes keep the recovery accounting plus
  ``child_restarts`` and ``killed_dispatches``.

* **Telemetry.**  ``Warden(telemetry=...)`` re-emits each child
  heartbeat as a ``heartbeat`` event and each reaped child as a
  ``child_death`` event, parent-side.  A checkpointed child records its
  own run into the run dir (``Telemetry.for_checkpoint``: the flight log
  and STATUS.json beside the dump); a resumed child appends a segment to
  the same flight log, so ``telemetry watch|report|trace <run-dir>``
  show the whole ladder, the dead child's in-flight dispatch included.
  The trace identity (``DSLABS_TRACE_ID`` / ``DSLABS_PARENT_SPAN``,
  ``tpu/tracing.py``) is forwarded to each child.

:class:`LineWatch` is the shared child-stream monitor.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional, Tuple

from dslabs_tpu_torch.tpu import checkpoint as ckpt_mod
from dslabs_tpu_torch.tpu import tracing as tracing_mod
from dslabs_tpu_torch.tpu.supervisor import (CHILD_RC_FAILED, EngineFailure,
                                             RetryPolicy,
                                             SupervisorExhausted,
                                             classify_child_death)

__all__ = ["Warden", "LineWatch", "classify_death", "outcome_to_dict",
           "outcome_from_dict", "CHILD_RC_FAILED"]

# The checkout root (three levels above this file): children get it on
# PYTHONPATH so ``-m dslabs_tpu_torch.tpu.warden`` resolves from any cwd.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def classify_death(exitcode: Optional[int],
                   killed_by_warden: bool,
                   stderr_markers=()) -> str:
    """The exit-code taxonomy, an alias of the shared
    :func:`~dslabs_tpu_torch.tpu.supervisor.classify_child_death`:
    ``wedge`` (the warden SIGKILLed the child after heartbeat silence),
    ``oom`` (an unprompted SIGKILL, or an abrupt death whose stderr tail
    carries an OOM marker), ``failed`` (the child exited
    :data:`CHILD_RC_FAILED` after reporting a classified failure over the
    pipe), ``crash`` (anything else)."""
    return classify_child_death(exitcode, killed_by_warden,
                                stderr_markers)


# ---------------------------------------------------------- serialization

_SCALAR_FIELDS = (
    "end_condition", "states_explored", "unique_states", "depth",
    "elapsed_secs", "predicate_name", "exception_code", "trace",
    "dropped", "samples", "visited_overflow", "retries", "failovers",
    "resumed_from_depth", "engine", "compile_secs", "child_restarts",
    "killed_dispatches", "abandoned_threads", "mesh_width", "mesh_shrinks",
    "knob_retries", "cancelled", "fault_events", "partition_events",
    "crash_events", "drop_events", "dup_events", "spilled_keys",
    "host_tier_hits", "respilled_frontier", "platform", "trace_id",
    "lane", "lane_width", "lane_share")


def outcome_to_dict(out) -> dict:
    """``SearchOutcome`` -> a JSON-serialisable dict (the pipe format).
    Batch-1 terminal states become nested int lists."""
    import numpy as np

    def _state(s):
        if s is None:
            return None
        return {k: np.asarray(v).tolist() for k, v in s.items()}

    d = {f: getattr(out, f) for f in _SCALAR_FIELDS}
    d["violating_state"] = _state(out.violating_state)
    d["goal_state"] = _state(out.goal_state)
    return d


def outcome_from_dict(d: dict):
    """Inverse of :func:`outcome_to_dict` (the parent side of the pipe)."""
    import numpy as np

    from dslabs_tpu_torch.tpu.engine import SearchOutcome

    def _state(s):
        if s is None:
            return None
        return {k: np.asarray(v, np.int32) for k, v in s.items()}

    out = SearchOutcome(
        end_condition=d["end_condition"],
        states_explored=d["states_explored"],
        unique_states=d["unique_states"],
        depth=d["depth"], elapsed_secs=d["elapsed_secs"])
    for f in _SCALAR_FIELDS:
        setattr(out, f, d.get(f, getattr(out, f)))
    out.violating_state = _state(d.get("violating_state"))
    out.goal_state = _state(d.get("goal_state"))
    return out


# ------------------------------------------------------------- line watch

class LineWatch:
    """Watch a child process's text stream line by line, tracking the
    last activity, so a caller can enforce both a total budget and a
    silence budget.  The reader thread forwards each line to
    ``on_line`` and keeps a short tail for attributable errors."""

    def __init__(self, proc: subprocess.Popen, stream, on_line=None):
        self.proc = proc
        self.last_activity = time.time()
        self.tail: List[str] = []
        self._on_line = on_line
        self._thread = threading.Thread(target=self._drain,
                                        args=(stream,), daemon=True)
        self._thread.start()

    def _drain(self, stream) -> None:
        for line in stream:
            self.last_activity = time.time()
            self.tail.append(line.rstrip()[:300])
            del self.tail[:-5]
            if self._on_line is not None:
                self._on_line(line)

    def silence(self) -> float:
        return time.time() - self.last_activity

    def kill(self) -> None:
        try:
            self.proc.kill()
        except OSError:
            pass
        self.proc.wait()

    def wait(self, timeout: float,
             silence: Optional[float] = None) -> Tuple[str, Optional[int]]:
        """Wait for exit within ``timeout`` total seconds, killing the
        child if its stream goes quiet for ``silence`` seconds.  Returns
        ``("ok", returncode)``, ``("silence", None)`` or ``("total",
        None)``; the child is dead in every case."""
        deadline = time.time() + timeout
        while True:
            try:
                rc = self.proc.wait(timeout=0.25)
                self._thread.join(timeout=5.0)
                return "ok", rc
            except subprocess.TimeoutExpired:
                pass
            if time.time() >= deadline:
                self.kill()
                return "total", None
            if silence is not None and self.silence() > silence:
                self.kill()
                return "silence", None


# ----------------------------------------------------------------- warden

@dataclasses.dataclass
class ChildDeath:
    """One reaped child: which rung died, how, and what it last said."""

    rung: str
    kind: str                   # classify_death vocabulary
    exitcode: Optional[int]
    detail: str
    last_hb: Optional[dict] = None
    # Seconds from the child's last message to its reaping (a wedge:
    # the announced grace plus at most the slack).
    silent_secs: Optional[float] = None


class Warden:
    """Parent half of the process-isolation layer: spawn one child per
    failover rung, enforce heartbeat deadlines with SIGKILL, classify
    deaths, and resume the next rung from the durable checkpoint.

    ``device`` (the card unless the caller names another) is where every
    rung but the last runs; the last runs on the CPU.  ``fault`` injects
    a deterministic child-side fault: ``{"kind": "hang"|"die"|"exit"|
    "raise", "at": k}`` fires at dispatch index ``k`` of the first rung
    it matches (optional ``"engine"`` restricts the rung, ``"spawns":
    [0, 1]`` targets spawn indices; ``"after_ckpt": True`` also waits for
    a durable dump).  A hang blocks the dispatch (the warden must kill),
    ``die`` is a SIGKILL of itself (an external or OOM kill), ``exit`` an
    abrupt ``os._exit``, ``raise`` a fatal in-child error reported over
    the pipe."""

    def __init__(self, factory: str,
                 factory_kwargs: Optional[dict] = None,
                 transform: Optional[str] = None,
                 ladder: Tuple[str, ...] = ("device", "host"),
                 policy: Optional[RetryPolicy] = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0,
                 strict: bool = True,
                 max_depth: Optional[int] = None,
                 max_secs: Optional[float] = None,
                 chunk: int = 1 << 10,
                 frontier_cap: int = 1 << 14,
                 visited_cap: int = 1 << 20,
                 ev_budget=None,
                 aot_warmup: bool = False,
                 boot_grace: float = 240.0,
                 first_grace: Optional[float] = None,
                 steady_grace: float = 120.0,
                 idle_grace: float = 300.0,
                 grace_slack: float = 5.0,
                 fault: Optional[dict] = None,
                 env: Optional[dict] = None,
                 telemetry=None,
                 trace_id: Optional[str] = None,
                 parent_span: Optional[str] = None,
                 device=None):
        from dslabs_tpu_torch.tpu._build import resolve_device
        from dslabs_tpu_torch.tpu.supervisor import _later

        for rung in ladder:
            if rung == "sharded":
                raise _later("the sharded rung",
                             "sharded, multi-device swarm and chaos")
            if rung not in ("device", "host"):
                raise ValueError(f"unknown ladder rung {rung!r}")
        self.factory = factory
        self.factory_kwargs = factory_kwargs or {}
        self.transform = transform
        self.ladder = tuple(ladder)
        self.device = str(resolve_device(device))
        self.policy = policy or RetryPolicy()
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.strict = strict
        self.max_depth = max_depth
        self.max_secs = max_secs
        self.chunk = chunk
        self.frontier_cap = frontier_cap
        self.visited_cap = visited_cap
        self.ev_budget = ev_budget
        self.aot_warmup = aot_warmup
        # Grace ladder: boot (spawn + imports), first dispatch per tag,
        # steady dispatch, idle (host work between dispatches).  The
        # child announces the grace that applies on every heartbeat; the
        # parent enforces it plus the slack.
        self.boot_grace = boot_grace
        self.first_grace = (boot_grace if first_grace is None
                            else first_grace)
        self.steady_grace = steady_grace
        self.idle_grace = idle_grace
        self.grace_slack = grace_slack
        self.fault = fault
        self.env = env or {}
        # Parent-side recorder of the children's heartbeats and deaths.
        self.telemetry = telemetry
        env_trace, env_parent = tracing_mod.current_trace()
        self.trace_id = trace_id or env_trace
        self.parent_span = parent_span or env_parent
        self.failures: List[EngineFailure] = []
        self.deaths: List[ChildDeath] = []
        self.killed_dispatches = 0
        # The platform the winning child ran on ("cuda" or "cpu").
        self.last_platform: Optional[str] = None

    # ------------------------------------------------------------- child io

    def _spec(self, rung: str, resume: bool) -> dict:
        # A child that replaces a dead one on the last rung runs off the
        # card: when the card itself is the broken part, the final rung
        # must not touch it.  A first child keeps the caller's device,
        # whatever the ladder's length.
        force_cpu = (bool(self.deaths)
                     and len(self.deaths) == len(self.ladder) - 1)
        return {
            "factory": self.factory,
            "factory_kwargs": self.factory_kwargs,
            "transform": self.transform,
            "rung": rung,
            "resume": resume,
            "strict": self.strict,
            "max_depth": self.max_depth,
            "max_secs": self.max_secs,
            "chunk": self.chunk,
            "frontier_cap": self.frontier_cap,
            "visited_cap": self.visited_cap,
            "ev_budget": (list(self.ev_budget)
                          if isinstance(self.ev_budget, tuple)
                          else self.ev_budget),
            "aot_warmup": self.aot_warmup,
            "checkpoint_path": self.checkpoint_path,
            "checkpoint_every": self.checkpoint_every,
            "policy": dataclasses.asdict(self.policy),
            "grace": {"boot": self.boot_grace, "first": self.first_grace,
                      "steady": self.steady_grace,
                      "idle": self.idle_grace},
            "force_cpu": force_cpu,
            "device": "cpu" if force_cpu else self.device,
            "fault": self.fault,
            "spawn_index": len(self.deaths),
        }

    def _child_env(self, spec: dict) -> dict:
        env = dict(os.environ)
        paths = [_REPO_ROOT]
        if env.get("PYTHONPATH"):
            paths.append(env["PYTHONPATH"])
        env["PYTHONPATH"] = os.pathsep.join(paths)
        env["DSLABS_WARDEN_CHILD"] = "1"
        if spec["force_cpu"]:
            env["CUDA_VISIBLE_DEVICES"] = ""
        env.update(self.env)
        # Trace identity after self.env: an explicit warden-level trace
        # wins over whatever the caller's env carried.
        env.update(tracing_mod.child_trace_env(self.trace_id,
                                               self.parent_span))
        return env

    def _run_child(self, rung: str, resume: bool) -> dict:
        """Spawn and supervise one rung child.  Returns the child's
        ``result`` message, or a death dict ``{"t": "death", "kind",
        "detail", "exitcode", "last_hb"}``."""
        spec = self._spec(rung, resume)
        proc = subprocess.Popen(
            [sys.executable, "-m", "dslabs_tpu_torch.tpu.warden"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=self._child_env(spec))

        def _tee(line):
            # stderr passes straight through while LineWatch keeps the
            # last lines for the death taxonomy (an abrupt exit with an
            # OutOfMemoryError traceback classifies "oom").
            sys.stderr.write(line)
            sys.stderr.flush()

        err_watch = LineWatch(proc, proc.stderr, on_line=_tee)
        try:
            proc.stdin.write(json.dumps(spec))
            proc.stdin.close()
        except BrokenPipeError:
            pass

        msgs: "queue.Queue[dict]" = queue.Queue()

        def _read():
            for line in proc.stdout:
                try:
                    msgs.put(json.loads(line))
                except ValueError:
                    continue          # stray child output, not protocol
            msgs.put({"t": "eof"})

        threading.Thread(target=_read, daemon=True).start()

        grace = self.boot_grace
        last_hb: Optional[dict] = None
        t_msg = time.time()
        while True:
            try:
                msg = msgs.get(timeout=grace + self.grace_slack)
            except queue.Empty:
                # Heartbeat silence past the announced grace: the child is
                # wedged.  SIGKILL, which a hung CUDA call cannot ignore,
                # and reap.
                try:
                    proc.kill()
                except OSError:
                    pass
                proc.wait()
                in_dispatch = (last_hb is not None
                               and last_hb.get("phase") == "start")
                if in_dispatch:
                    self.killed_dispatches += 1
                where = (f"dispatch {last_hb.get('tag')!r} "
                         f"(index {last_hb.get('n')}, depth "
                         f"{last_hb.get('depth')})" if in_dispatch
                         else "boot/idle")
                return {"t": "death", "kind": "wedge",
                        "exitcode": proc.returncode, "last_hb": last_hb,
                        "silent_secs": time.time() - t_msg,
                        "detail": (f"child silent > {grace:.1f}s in "
                                   f"{where}; SIGKILLed and reaped")}
            t_msg = time.time()
            t = msg.get("t")
            if t == "hb":
                last_hb = msg
                grace = float(msg.get("grace", self.steady_grace))
                if self.telemetry is not None:
                    self.telemetry.event(
                        "heartbeat", rung=rung, phase=msg.get("phase"),
                        tag=msg.get("tag"), n=msg.get("n"),
                        depth=msg.get("depth"),
                        ckpt_depth=msg.get("ckpt_depth"),
                        grace=msg.get("grace"))
                continue
            if t == "result":
                proc.wait()
                return msg
            if t == "err":
                # A classified failure; the child exits CHILD_RC_FAILED.
                try:
                    rc = proc.wait(timeout=30.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    rc = proc.wait()
                return {"t": "death",
                        "kind": classify_death(rc, False, err_watch.tail),
                        "exitcode": rc, "last_hb": last_hb,
                        "detail": msg.get("error", "child failure")}
            if t == "eof":
                rc = proc.wait()
                kind = classify_death(rc, False, err_watch.tail)
                return {"t": "death", "kind": kind, "exitcode": rc,
                        "last_hb": last_hb,
                        "detail": (f"child exited rc={rc} without a "
                                   f"result (classified {kind}; last "
                                   f"heartbeat: {last_hb}; stderr "
                                   f"tail: {err_watch.tail[-2:]})")}

    # ----------------------------------------------------------------- run

    def run(self, resume: bool = False):
        """Run the ladder to a verdict, one supervised child per rung.
        Later rungs always resume from the durable checkpoint when a
        matching dump exists (the child's supervisor checks the
        fingerprint).  Raises :class:`SupervisorExhausted` with the
        per-rung failure chain when every rung's child dies."""
        self.failures = []
        self.deaths = []
        self.killed_dispatches = 0
        for i, rung in enumerate(self.ladder):
            res = self._run_child(rung, resume=(resume or i > 0))
            if res.get("t") == "result":
                out = outcome_from_dict(res["outcome"])
                self.last_platform = res.get("platform")
                out.platform = self.last_platform
                out.engine = rung
                out.failovers = len(self.failures)
                out.child_restarts = i
                out.killed_dispatches = self.killed_dispatches
                return out
            death = ChildDeath(rung=rung, kind=res["kind"],
                               exitcode=res.get("exitcode"),
                               detail=res["detail"],
                               last_hb=res.get("last_hb"),
                               silent_secs=res.get("silent_secs"))
            self.deaths.append(death)
            if self.telemetry is not None:
                # The death's class rides as ``failure``: ``kind`` is the
                # event's own name (the supervisor's failover events use
                # the same field).
                self.telemetry.event(
                    "child_death", rung=rung, failure=death.kind,
                    exitcode=death.exitcode, detail=death.detail[:200])
            self.failures.append(EngineFailure(
                rung, death.kind, RuntimeError(death.detail)))
        raise SupervisorExhausted(self.failures)


# ------------------------------------------------------------ child half

def _resolve(ref: str):
    """``"module:callable"`` -> the callable (child-side import)."""
    import importlib

    mod, _, name = ref.partition(":")
    obj = importlib.import_module(mod)
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _send(obj: dict) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def _child_main() -> int:
    spec = json.load(sys.stdin)
    g = spec.get("grace") or {}
    boot_g = float(g.get("boot", 240.0))
    first_g = float(g.get("first", boot_g))
    steady_g = float(g.get("steady", 120.0))
    idle_g = float(g.get("idle", 300.0))
    _send({"t": "hb", "phase": "boot", "stage": "spawned",
           "grace": boot_g})
    if spec.get("force_cpu"):
        # The parent set it in the env already; set it again before torch
        # touches CUDA in case a caller's env overrode it.
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
    from dslabs_tpu_torch.tpu.supervisor import (RetryPolicy,
                                                 SearchSupervisor,
                                                 SupervisorExhausted)

    proto = _resolve(spec["factory"])(**(spec.get("factory_kwargs")
                                         or {}))
    if spec.get("transform"):
        proto = _resolve(spec["transform"])(proto)
    _send({"t": "hb", "phase": "boot", "stage": "protocol",
           "grace": boot_g})

    policy = RetryPolicy(**(spec.get("policy") or {}))
    ev = spec.get("ev_budget")
    if isinstance(ev, list):
        ev = tuple(ev)
    ckpt_path = spec.get("checkpoint_path")
    fault = spec.get("fault")
    rung = spec["rung"]
    if fault is not None:
        if fault.get("spawns") is not None:
            if int(spec.get("spawn_index", 0)) not in fault["spawns"]:
                fault = None
        elif fault.get("engine") is not None:
            if fault["engine"] != rung:
                fault = None
        elif int(spec.get("spawn_index", 0)) > 0:
            # Un-scoped faults fire on the first child only, or the same
            # injected death would chase the run down every rung.
            fault = None
    seen_tags = set()
    st = {"ckpt_depth": None}

    def observer(phase, tag, idx, depth):
        if phase == "start":
            first = tag not in seen_tags
            seen_tags.add(tag)
            grace = first_g if first else steady_g
            _send({"t": "hb", "phase": "start", "tag": tag, "n": idx,
                   "depth": depth, "ckpt_depth": st["ckpt_depth"],
                   "grace": grace})
            if fault is not None:
                kind = fault.get("kind")
                at = int(fault.get("at", 0))
                # Process-death kinds arm at index ``at`` and fire on the
                # first armed dispatch; with ``after_ckpt`` they also wait
                # for a durable dump on disk, so resume tests do not race
                # the background writer.  ``raise`` fires at exactly
                # ``at``.
                due = (idx >= at if kind in ("die", "exit", "hang")
                       else idx == at)
                if due and fault.get("after_ckpt") and (
                        st["ckpt_depth"] is None):
                    due = False
                if due:
                    if kind == "die":
                        os.kill(os.getpid(), signal.SIGKILL)
                    elif kind == "exit":
                        os._exit(int(fault.get("rc", 86)))
                    elif kind == "hang":
                        # An uninterruptible block, as a wedged runtime
                        # would be: only the parent's SIGKILL ends it.
                        time.sleep(float(fault.get("secs", 3600.0)))
                    elif kind == "raise":
                        raise RuntimeError(
                            f"injected warden child fault [{tag} "
                            f"dispatch {idx}]")
        else:
            if ckpt_path and tag.rsplit(".", 1)[-1] in ("promote",
                                                        "expand"):
                d = ckpt_mod.peek_depth(ckpt_path)
                if d is not None:
                    st["ckpt_depth"] = d
            _send({"t": "hb", "phase": "done", "tag": tag, "n": idx,
                   "depth": depth, "ckpt_depth": st["ckpt_depth"],
                   "grace": idle_g})

    # A checkpointed child records its run into the run dir (flight log
    # and STATUS.json beside the dump); a resumed child appends to the
    # same flight log.  Never fatal: an unwritable dir runs unrecorded.
    child_tel = None
    if ckpt_path:
        try:
            from dslabs_tpu_torch.tpu.telemetry import Telemetry

            child_tel = Telemetry.for_checkpoint(
                ckpt_path, engine_hint=f"warden-child:{rung}")
        except Exception:  # noqa: BLE001 - observability is optional
            child_tel = None
    try:
        sup = SearchSupervisor(
            proto, ladder=(rung,), policy=policy,
            checkpoint_path=ckpt_path,
            checkpoint_every=spec.get("checkpoint_every", 0),
            strict=spec.get("strict", True),
            max_depth=spec.get("max_depth"),
            max_secs=spec.get("max_secs"),
            chunk=spec.get("chunk", 1 << 10),
            frontier_cap=spec.get("frontier_cap", 1 << 14),
            visited_cap=spec.get("visited_cap", 1 << 20),
            ev_budget=ev, aot_warmup=spec.get("aot_warmup", False),
            dispatch_observer=observer, telemetry=child_tel,
            device=spec.get("device"))
        out = sup.run(resume=bool(spec.get("resume")))
    except BaseException as e:  # noqa: BLE001 - reported over the pipe
        kind = "failed"
        if isinstance(e, SupervisorExhausted) and e.failures:
            kind = e.failures[-1].kind
        _send({"t": "err", "kind": kind,
               "error": f"{type(e).__name__}: {e}"[:500]})
        return CHILD_RC_FAILED
    finally:
        if child_tel is not None:
            child_tel.close()
    _send({"t": "result", "outcome": outcome_to_dict(out),
           "platform": sup.last_search.device.type})
    return 0


if __name__ == "__main__":
    sys.exit(_child_main())
