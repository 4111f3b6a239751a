"""Fault-tolerant search supervisor: retry, watchdog, engine failover.

Counterpart of ``dslabs_tpu/tpu/supervisor.py`` on one card.  A long
search on an accelerator must outlive a transient device error, an
out-of-memory spike or a wedged dispatch; this module gives the port the
reference's spine:

* **One dispatch boundary.**  Every device dispatch and blocking
  readback of the port's loops (the wave step, promote, stats sync and
  flag readback of the device loop, ``run_host``'s expand, the spill
  round trips, the swarm's init, walk step and readbacks) goes through
  ``TensorSearch._dispatch(tag, fn, *args)``: a plain call until a
  :class:`DispatchBoundary` is installed there.
* **Failure classification and bounded retry.**  Transient runtime
  errors (a runtime error whose message carries a transient status,
  :class:`TransientDeviceError` from the fault harness) retry with
  exponential backoff and seeded jitter up to ``RetryPolicy.max_retries``
  per rung.  Fatal errors and exhausted budgets raise
  :class:`EngineFailure`.
* **No retry of a half-applied write.**  The port's carry is updated in
  place (kernel 2 writes the table, the step appends rows and adds to
  the counters), where the reference's is a value.  A failure is retried
  in place only if it fired before ``fn`` ran (every injected
  :class:`FaultPlan` raise) or ``fn`` is marked read-only
  (``engine.read_only``: the readbacks, the spill fetches, the host
  loop's expand).  A transient raised inside a mutating site is an
  :class:`EngineFailure` of kind ``torn``, which the ladder answers from
  the last checkpoint: a knob-shrink re-level when it is OOM-shaped, the
  next rung otherwise.
* **Wall-clock watchdog.**  With ``RetryPolicy.deadline_secs`` set, each
  dispatch runs on a watchdog thread, on the caller's current CUDA
  stream; a dispatch past its deadline is abandoned
  (:class:`DispatchTimeout`, kind ``wedged``, never retried) and the
  ladder moves on.  A CUDA hang surfaces at the next synchronising
  readback, so the ``sync`` / ``flags`` sites are where it trips.  The
  abandoned thread cannot be interrupted: one blocked inside a real CUDA
  call keeps holding the context, so the in-process ladder cannot
  outlast a real wedge.  The warden (``tpu/warden.py``) can: it SIGKILLs
  the child process.
* **Engine failover ladder.**  :class:`SearchSupervisor` runs the search
  on the first healthy rung of ``sharded -> device -> host`` (the
  owner-sharded engine of ``tpu/sharded.py`` over a ``ShardMesh``, the
  solo device loop, and the host loop that is the parity oracle; every
  rung gives the same verdicts), each rung resuming from the shared
  checkpoint (``tpu/checkpoint.py``) when one exists.
  Before a failover or a re-level the failed rung's carry is released
  and the CUDA cache emptied, so the next rung does not run out of memory
  for the wrong reason.  Semantic errors (``CapacityOverflow``,
  ``CheckpointMismatch``) propagate unchanged unless ``spill="ladder"``
  asks for the capacity ladder.
* **Elastic width ladder.**  With ``elastic`` set, a ``sharded`` rung
  over D shards expands into ``sharded(D) -> sharded(D/2) -> ... ->
  sharded(2)`` (:func:`expand_ladder`): a burned mesh rung costs half
  its shards, not all of them, and the narrower rung resumes the
  checkpoint re-sharded to its owner map (``mesh_shrunk`` events,
  ``mesh_shrinks`` and ``mesh_width`` on the outcome).
* **Deadline scales.**  An engine may publish
  ``_dispatch_deadline_scales`` (``{site: factor}``); the watchdog reads
  it live and stretches its steady-state deadline at that site by the
  factor (the sharded engine's superstep runs a whole level's chunk
  steps in one dispatch).
* **Deterministic fault injection.**  A :class:`FaultPlan` installed at
  the same boundary makes every recovery path exercisable on the CPU.
* **Portfolio mode** runs the swarm explorer (``tpu/swarm.py``) as a
  concurrent lane beside the BFS ladder; the first terminal verdict
  wins and the other lane stops at its next level or round boundary.
  On one card the two lanes are two host threads issuing onto one
  device, each slower than alone.
* **Process isolation** (``process_isolation=True``) runs the ladder
  through the warden: one spawned child per rung.

Torch's errors are not XLA's.  Runtime errors are matched by type name
(``AcceleratorError``, ``OutOfMemoryError``, and the reference's
``XlaRuntimeError`` / ``JaxRuntimeError``) and message markers, so no
torch version is a hard dependency.  A ``torch.cuda.OutOfMemoryError`` is
OOM-shaped (:func:`classify_oom`) and not transient: a retry at the same
size would fail again, so the ladder re-levels with a halved chunk.
Sticky CUDA errors (an illegal memory access, a device-side assert, an
unspecified launch failure) poison the process's context and classify
``fatal``; only a warden child recovers from one.

Telemetry (``tpu/telemetry.py``): ``telemetry=`` on the boundary makes
every injected fault, in-place retry and abandoned dispatch an event
(``fault_inject``, ``retry``, ``wedged``), and a span's ``retries`` counts
the retries its dispatch absorbed; on the supervisor it is attached to
every rung's engine (and the portfolio's swarm lane) and adds the
ladder's events (``rung``, ``failover``, ``capacity_retry``,
``knobs_shrunk``, ``lane``, ``lane_winner``); the verdict carries the
recorder's ``trace_id``.

The sharded rung's full width is its mesh's, or the number of cards (1
on one H100, 1 on the CPU) when no mesh is given.  Over a ``ShardMesh``
its D shards share one card (``tpu/mesh_exchange.py``); over a
``RankMesh`` (distinct devices, or gloo ranks that share one) the rung
runs one process per rank through ``tpu/ranks.py run_sharded``, which
rebuilds the protocol from ``protocol_factory`` (a live protocol cannot
cross a process boundary), and the elastic ladder's narrower rungs run
on the mesh's first devices.
``aot_warmup=True`` loads the built kernels before the run and reports
that time on ``compile_secs``.  The reference's environment knobs
(``DSLABS_ABANDONED_WARN``, ``DSLABS_ELASTIC``, ``DSLABS_KNOB_SHRINKS``,
``DSLABS_SUPERSTEP_CHUNKS``) are constants or arguments here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import random
import signal
import threading
import time
import traceback
import warnings
import weakref
from typing import Dict, List, Optional, Tuple

import torch

from dslabs_tpu_torch.tpu import checkpoint as ckpt_mod
from dslabs_tpu_torch.tpu._build import resolve_device
from dslabs_tpu_torch.tpu.mesh_exchange import RankMesh, ShardMesh, as_mesh

__all__ = ["TransientDeviceError", "DispatchTimeout", "EngineFailure",
           "SupervisorExhausted", "RetryPolicy", "FaultRule", "FaultPlan",
           "DispatchBoundary", "SearchSupervisor", "classify_failure",
           "classify_oom", "classify_child_death", "CHILD_RC_FAILED",
           "expand_ladder", "install_retry", "probe_device"]

# Watchdog-abandoned threads still blocked past which the boundary warns
# that the in-process ladder is degrading.
ABANDONED_WARN_THRESHOLD = 2
# In-place knob-shrink re-levels an OOM-shaped failure gets per rung.
MAX_KNOB_SHRINKS = 2
# Chunk steps per superstep dispatch of the sharded rung under a time
# budget; each knob-shrink re-level halves it with the chunk.
SUPERSTEP_CHUNKS = 16


class TransientDeviceError(RuntimeError):
    """A retryable device/runtime failure (the injectable stand-in for a
    transient runtime status on real hardware)."""


class DispatchTimeout(RuntimeError):
    """A dispatch exceeded its wall-clock deadline (wedged device).
    Never retried in place: the dispatch was abandoned, so the rung's
    device state is unknown; recovery is failover from the checkpoint."""


class EngineFailure(RuntimeError):
    """A rung of the ladder failed past recovery in place.  ``kind`` is
    ``"fatal"`` / ``"retries_exhausted"`` / ``"wedged"`` / ``"capacity"``
    (a CapacityOverflow the capacity ladder answered) / ``"torn"`` (a
    transient raised inside a dispatch that writes the carry, which a
    rerun would apply twice); ``cause`` is the underlying exception."""

    def __init__(self, engine: str, kind: str, cause: BaseException):
        super().__init__(f"{engine} engine failed ({kind}): "
                         f"{type(cause).__name__}: {cause}")
        self.engine = engine
        self.kind = kind
        self.cause = cause


class SupervisorExhausted(RuntimeError):
    """Every rung of the failover ladder failed.  ``failures`` holds the
    per-rung :class:`EngineFailure` chain."""

    def __init__(self, failures: List[EngineFailure]):
        super().__init__(
            "all failover rungs failed: "
            + "; ".join(str(f) for f in failures))
        self.failures = failures


# Status markers that make a runtime error retryable (the reference's
# set; a CUDA "busy or unavailable" device matches "unavailable").
_TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "UNAVAILABLE", "ABORTED",
                      "DEADLINE_EXCEEDED", "preempt", "slice restart",
                      "connection reset")
# Exception type names treated as runtime-layer errors, matched by name
# so that no runtime's concrete classes are a hard import dependency
# (torch.AcceleratorError exists only in newer torch).
_RUNTIME_ERROR_NAMES = ("XlaRuntimeError", "JaxRuntimeError",
                        "AcceleratorError", "OutOfMemoryError")
# CUDA errors that poison the process's context: no later call in the
# process can use the card.
_STICKY_MARKERS = ("illegal memory access", "device-side assert",
                   "unspecified launch failure", "illegal instruction",
                   "misaligned address")


def _passthrough_types() -> tuple:
    """Errors the boundary never absorbs: semantic / config failures,
    where retry or failover would mask a wrong answer, and interrupts."""
    from dslabs_tpu_torch.tpu.engine import CapacityOverflow

    return (CapacityOverflow, ckpt_mod.CheckpointMismatch,
            KeyboardInterrupt, SystemExit)


def is_sticky(exc: BaseException) -> bool:
    """True for a CUDA error that poisons the process's context."""
    msg = str(exc).lower()
    return any(m in msg for m in _STICKY_MARKERS)


def classify_failure(exc: BaseException) -> str:
    """``"transient"`` (retry in place), ``"wedged"`` (abandon, fail
    over), or ``"fatal"`` (fail over)."""
    if isinstance(exc, DispatchTimeout):
        return "wedged"
    if isinstance(exc, TransientDeviceError):
        return "transient"
    if is_sticky(exc):
        return "fatal"
    if type(exc).__name__ in _RUNTIME_ERROR_NAMES or isinstance(
            exc, MemoryError):
        msg = str(exc)
        if any(m.lower() in msg.lower() for m in _TRANSIENT_MARKERS):
            return "transient"
    return "fatal"


# Markers of a memory/capacity-shaped failure: what the knob-shrink
# ladder answers with an in-place re-level (halved chunk, resume from the
# checkpoint) before burning a rung.
_OOM_MARKERS = ("resource_exhausted", "out of memory", "hbm oom",
                "allocation failure", "oom-kill")


def classify_oom(exc: Optional[BaseException]) -> bool:
    """True when a failure looks like memory exhaustion: a MemoryError, a
    ``torch.cuda.OutOfMemoryError`` (matched by name), or an error whose
    message carries an OOM marker."""
    if exc is None:
        return False
    if isinstance(exc, MemoryError) or \
            type(exc).__name__ == "OutOfMemoryError":
        return True
    msg = str(exc).lower()
    return any(m in msg for m in _OOM_MARKERS)


# Exit code a warden child uses after reporting a classified failure over
# its pipe: a clean "failed", as opposed to an abrupt crash or kill.
CHILD_RC_FAILED = 3

# Stderr-tail markers of the child-death taxonomy: the classify_oom
# message markers plus the exception names a dying child's traceback
# shows (a reaped child leaves only text).
_OOM_STDERR_MARKERS = _OOM_MARKERS + ("memoryerror", "outofmemoryerror")


def classify_child_death(exitcode: Optional[int],
                         killed_by_warden: bool,
                         stderr_markers=()) -> str:
    """The child-death taxonomy, shared by the warden's failover and
    :func:`classify_oom`:

    * ``wedge``  - the supervising parent SIGKILLed the child after
      heartbeat silence;
    * ``oom``    - an unprompted SIGKILL (the kernel's OOM killer or an
      external ``kill -9``), or another abrupt death whose
      ``stderr_markers`` carry an OOM marker;
    * ``failed`` - the child exited :data:`CHILD_RC_FAILED` after
      reporting a classified failure over its pipe;
    * ``crash``  - anything else: another signal or an abrupt exit with
      no report and no OOM marker.

    ``stderr_markers`` (a stderr tail) refines only the abrupt-death
    kinds."""
    if killed_by_warden:
        return "wedge"
    if exitcode == CHILD_RC_FAILED:
        return "failed"
    if exitcode is not None and exitcode < 0:
        if -exitcode == signal.SIGKILL:
            return "oom"
    elif exitcode == 0:
        return "crash"     # rc 0 with no result: still an abrupt death
    text = " ".join(str(s) for s in stderr_markers).lower()
    if text and any(m in text for m in _OOM_STDERR_MARKERS):
        return "oom"
    return "crash"


def expand_ladder(ladder, full_width: Optional[int] = None,
                  elastic: bool = False):
    """Expand a rung-name ladder into ``(rung, width)`` specs.  With
    ``elastic`` set, every ``"sharded"`` entry becomes the width ladder
    ``sharded(D) -> sharded(D/2) -> ... -> sharded(2)`` (width None = the
    full mesh), so a failing mesh degrades by halves.  The engine name
    stays ``"sharded"`` at every width: fault plans, retry budgets and
    dispatch tags keep one vocabulary."""
    specs = []
    for rung in ladder:
        specs.append((rung, None))
        if rung == "sharded" and elastic and (full_width or 0) > 2:
            w = int(full_width)
            while w > 2:
                w = max(2, w // 2)
                specs.append(("sharded", w))
    return specs


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded-retry and watchdog knobs."""

    max_retries: int = 3          # per engine rung, across its dispatches
    backoff_base: float = 0.05    # first-retry sleep, seconds
    backoff_factor: float = 2.0
    backoff_max: float = 2.0
    jitter: float = 0.25          # +/- fraction of the backoff, seeded
    deadline_secs: Optional[float] = None   # per-dispatch watchdog; None = off
    # Deadline of the first dispatch at each (engine, site) tag, which
    # pays the kernels' build and first launches.  None = 10 x
    # deadline_secs.
    deadline_first_secs: Optional[float] = None
    seed: int = 0

    def first_deadline(self) -> Optional[float]:
        if self.deadline_secs is None:
            return None
        if self.deadline_first_secs is not None:
            return self.deadline_first_secs
        return 10.0 * self.deadline_secs


@dataclasses.dataclass
class FaultRule:
    """One deterministic fault: dispatches ``at .. at+count-1`` of
    ``engine`` (None = any rung) either raise ``error()`` or hang for
    ``hang_secs`` (interruptibly: the watchdog's abandon releases the
    thread).  ``count=None`` fires forever.  ``site`` (the tag suffix,
    e.g. ``"spill_drain"``) narrows the rule to one dispatch site and
    windows ``at`` / ``count`` on that site's own dispatch index.
    ``rank`` (None = every process) narrows it to one rank of a
    ``RankMesh`` run (``tpu/ranks.py``); outside ranks a process is rank
    0."""

    kind: str                      # "raise" | "hang"
    at: int = 0
    count: Optional[int] = 1
    engine: Optional[str] = None
    error: type = TransientDeviceError
    message: str = "injected fault"
    hang_secs: float = 3600.0
    site: Optional[str] = None
    rank: Optional[int] = None


class FaultPlan:
    """A deterministic schedule of dispatch-boundary faults.

    Indexing is per engine: each rung counts its own dispatches from 0,
    and retries advance the index (a retry is a new dispatch), so
    ``raise_at(k, count=2)`` means "the dispatch reaching index k fails,
    its first retry fails too, the second retry succeeds"."""

    def __init__(self):
        self.rules: List[FaultRule] = []
        # The rank this plan fires in (0 outside a RankMesh run).
        self.rank = 0
        self.fired: int = 0
        # Every firing: (engine, site, kind, index).
        self.fired_log: List[tuple] = []

    def raise_at(self, at: int, error: type = TransientDeviceError,
                 engine: Optional[str] = None, count: Optional[int] = 1,
                 message: str = "injected fault",
                 site: Optional[str] = None,
                 rank: Optional[int] = None) -> "FaultPlan":
        self.rules.append(FaultRule("raise", at=at, count=count,
                                    engine=engine, error=error,
                                    message=message, site=site, rank=rank))
        return self

    def raise_always(self, error: type = TransientDeviceError,
                     engine: Optional[str] = None,
                     message: str = "injected fault") -> "FaultPlan":
        return self.raise_at(0, error=error, engine=engine, count=None,
                             message=message)

    def hang_at(self, at: int, engine: Optional[str] = None,
                secs: float = 3600.0, count: Optional[int] = 1,
                site: Optional[str] = None) -> "FaultPlan":
        self.rules.append(FaultRule("hang", at=at, count=count,
                                    engine=engine, hang_secs=secs,
                                    site=site))
        return self

    def match(self, engine: str, index: int, site: Optional[str] = None,
              site_index: Optional[int] = None) -> Optional[FaultRule]:
        for r in self.rules:
            if r.engine is not None and r.engine != engine:
                continue
            if r.rank is not None and r.rank != self.rank:
                continue
            if r.site is not None:
                if r.site != site or site_index is None:
                    continue
                idx = site_index
            else:
                idx = index
            if idx < r.at:
                continue
            if r.count is not None and idx >= r.at + r.count:
                continue
            self.fired += 1
            self.fired_log.append((engine, site, r.kind, idx))
            return r
        return None


def _caller_stream():
    """The calling thread's current CUDA stream, or None when CUDA is not
    in use in this process."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.current_stream()
    return None


class DispatchBoundary:
    """The retry / watchdog / fault-injection wrapper every hot-loop
    dispatch goes through (``TensorSearch._dispatch``).

    Install on a search with :meth:`install`; tags are
    ``"<engine>.<site>"`` and the engine half keys both the fault plan
    and the per-rung dispatch and retry counters."""

    def __init__(self, policy: Optional[RetryPolicy] = None,
                 plan: Optional[FaultPlan] = None,
                 observer=None, telemetry=None):
        self.policy = policy or RetryPolicy()
        # The telemetry recorder of fault, retry and wedge events.
        self.telemetry = telemetry
        self.plan = plan
        self.retries = 0
        self.timeouts = 0
        self.counts: Dict[str, int] = {}
        self.site_counts: Dict[tuple, int] = {}
        self._engine_retries: Dict[str, int] = {}
        self._rng = random.Random(self.policy.seed)
        # Optional per-dispatch observer, ``observer(phase, tag, index,
        # depth)`` with phase "start" before the wrapped call and "done"
        # after it returns (the warden child's heartbeats).  An exception
        # it raises is classified like a dispatch failure.
        self.observer = observer
        # Watchdog-abandoned daemon threads (the in-process mode's
        # unavoidable leak), counted so the degradation is visible.
        self.abandoned: List[threading.Thread] = []
        self._depth_src = None
        self._scales_src = None
        self._seen_tags: set = set()

    def abandoned_alive(self) -> int:
        """Watchdog-abandoned threads still blocked right now."""
        return sum(1 for t in self.abandoned if t.is_alive())

    def reset_budget(self, engine: str) -> None:
        """Grant ``engine`` a fresh retry budget (every rung and every
        knob-shrink re-level starts with the whole budget)."""
        self._engine_retries.pop(engine, None)

    def install(self, search, engine: Optional[str] = None) -> None:
        """Route ``search``'s dispatches through this boundary.  The
        optional ``engine`` renames the tag prefix (the supervisor uses
        the rung name, so plans written against the ladder vocabulary
        match)."""
        # Weak: the search holds this boundary through its hook, and a
        # cycle would keep a finished rung's carry on the card until the
        # next garbage collection.
        ref = weakref.ref(search)
        self._depth_src = (
            lambda: int(getattr(ref(), "_current_depth", 0)))
        # Per-site deadline scales, read live: the sharded engine
        # publishes its superstep's expected chunk steps before each
        # level.
        self._scales_src = (
            lambda: getattr(ref(), "_dispatch_deadline_scales", None))
        search._dispatch_boundary = self
        # A (re)installed search may be a fresh engine (a re-level's
        # smaller chunk): its first dispatch at each tag earns the first
        # deadline again.
        self._seen_tags = set()
        if engine is None:
            search._dispatch_hook = self.dispatch
        else:
            def hook(tag, fn, *args, _e=engine):
                return self.dispatch(
                    _e + "." + tag.split(".", 1)[-1], fn, *args)
            search._dispatch_hook = hook

    # ------------------------------------------------------------ dispatch

    def _depth(self) -> int:
        return self._depth_src() if self._depth_src is not None else 0

    def dispatch(self, tag: str, fn, *args):
        engine = tag.split(".", 1)[0]
        site = tag.split(".", 1)[-1]
        passthrough = _passthrough_types()
        while True:
            idx = self.counts.get(engine, 0)
            self.counts[engine] = idx + 1
            sidx = self.site_counts.get((engine, site), 0)
            self.site_counts[(engine, site)] = sidx + 1
            rule = (self.plan.match(engine, idx, site, sidx)
                    if self.plan else None)
            if rule is not None and self.telemetry is not None:
                # A chaos plan (tpu/chaos.py) marks its injections.
                self.telemetry.event(
                    "chaos_inject" if getattr(self.plan, "chaos", False)
                    else "fault_inject",
                    engine=engine, site=site, index=idx, fault=rule.kind)
            ran = False
            try:
                if self.observer is not None:
                    self.observer("start", tag, idx, self._depth())
                if rule is not None and rule.kind == "raise":
                    # Raised before fn runs: nothing was written, so a
                    # retry of the same call is well defined.
                    raise rule.error(f"{rule.message} "
                                     f"[{engine} dispatch {idx}]")
                ran = True
                if self.policy.deadline_secs is not None:
                    out = self._watchdog_call(tag, fn, args, rule)
                else:
                    out = fn(*args)
                if self.observer is not None:
                    self.observer("done", tag, idx, self._depth())
                return out
            except passthrough:
                raise
            except DispatchTimeout as e:
                self.timeouts += 1
                if self.telemetry is not None:
                    self.telemetry.event("wedged", engine=engine, site=site,
                                         index=idx)
                raise EngineFailure(engine, "wedged", e)
            except Exception as e:  # noqa: BLE001 - classified below
                if classify_failure(e) != "transient":
                    raise EngineFailure(engine, "fatal", e)
                if ran and not getattr(fn, "read_only", False):
                    # fn may have written part of the carry: a rerun
                    # would apply it twice.  The ladder answers from the
                    # last checkpoint instead.
                    raise EngineFailure(engine, "torn", e)
                used = self._engine_retries.get(engine, 0)
                if used >= self.policy.max_retries:
                    raise EngineFailure(engine, "retries_exhausted", e)
                self._engine_retries[engine] = used + 1
                self.retries += 1
                if self.telemetry is not None:
                    self.telemetry.event("retry", engine=engine, site=site,
                                         index=idx, attempt=used + 1,
                                         error=type(e).__name__)
                time.sleep(self._backoff(used))

    def _backoff(self, attempt: int) -> float:
        p = self.policy
        base = min(p.backoff_base * (p.backoff_factor ** attempt),
                   p.backoff_max)
        # Seeded jitter: desynchronises retry storms, reproducibly.
        return base * (1.0 + p.jitter * (2.0 * self._rng.random() - 1.0))

    def _deadline_scale(self, tag: str) -> float:
        """The installed search's published deadline scale of ``tag``'s
        site (1.0 when it publishes none)."""
        scales = self._scales_src() if self._scales_src is not None \
            else None
        if not scales:
            return 1.0
        return float(scales.get(tag.split(".", 1)[-1], 1.0))

    def _watchdog_call(self, tag: str, fn, args, rule):
        """Run one dispatch on a watchdog thread, on the caller's current
        CUDA stream (streams are chosen per thread), and abandon it at
        the deadline.  The first dispatch at each tag gets
        ``RetryPolicy.first_deadline``; a site with a published deadline
        scale stretches the steady-state deadline by it.  An injected
        hang waits interruptibly and checks for abandonment before
        touching the real dispatch, so an abandoned fault thread exits
        cleanly."""
        release = threading.Event()
        box: List[Tuple[str, object]] = []
        steady = self.policy.deadline_secs * self._deadline_scale(tag)
        deadline = (steady if tag in self._seen_tags
                    else max(self.policy.first_deadline(), steady))
        self._seen_tags.add(tag)
        stream = _caller_stream()

        def work():
            try:
                if rule is not None and rule.kind == "hang":
                    release.wait(rule.hang_secs)
                    if release.is_set():
                        return          # abandoned: never run the dispatch
                ctx = (torch.cuda.stream(stream) if stream is not None
                       else contextlib.nullcontext())
                with ctx:
                    box.append(("ok", fn(*args)))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                box.append(("err", e))

        th = threading.Thread(target=work, daemon=True,
                              name=f"dslabs-dispatch-{tag}")
        th.start()
        th.join(deadline)
        if th.is_alive():
            release.set()
            self.abandoned = [t for t in self.abandoned if t.is_alive()]
            self.abandoned.append(th)
            n_alive = len(self.abandoned)
            if n_alive >= ABANDONED_WARN_THRESHOLD:
                warnings.warn(
                    f"{n_alive} watchdog-abandoned dispatch threads are "
                    "still blocked in this process (a wedged CUDA call "
                    "cannot be interrupted from Python); the in-process "
                    "ladder is degrading: use process isolation "
                    "(tpu/warden.py, SearchSupervisor("
                    "process_isolation=True)) for hang-proof recovery",
                    RuntimeWarning, stacklevel=2)
            raise DispatchTimeout(
                f"dispatch {tag!r} exceeded its {deadline}s deadline "
                "(wedged device); abandoned")
        kind, val = box[0]
        if kind == "err":
            raise val
        return val


def install_retry(search, policy: Optional[RetryPolicy] = None,
                  plan: Optional[FaultPlan] = None) -> DispatchBoundary:
    """Wrap one engine's dispatches with retry and backoff (no ladder):
    the light-touch entry point the search backend uses so lab searches
    survive transient device errors without changing verdict flow."""
    boundary = DispatchBoundary(policy, plan)
    boundary.install(search)
    return boundary


def probe_device(deadline_secs: float = 60.0, device=None) -> dict:
    """Watchdog-bounded liveness probe of ``device`` (the card unless the
    caller names another): a 256 x 256 float32 matmul through the same
    dispatch boundary the search loops use.  Returns ``{platform,
    n_devices, secs}``; a wedged runtime surfaces as
    :class:`EngineFailure` (kind ``wedged``) instead of a hang."""
    from dslabs_tpu_torch.tpu.engine import read_only

    dev = resolve_device(device)
    t0 = time.time()
    boundary = DispatchBoundary(
        RetryPolicy(max_retries=0, deadline_secs=deadline_secs))

    @read_only
    def _mm():
        x = torch.ones((256, 256), dtype=torch.float32, device=dev)
        return float((x @ x)[0, 0])

    if boundary.dispatch("probe.matmul", _mm) != 256.0:
        raise RuntimeError("probe matmul returned a wrong result")
    return {"platform": dev.type,
            "n_devices": (torch.cuda.device_count() if dev.type == "cuda"
                          else 1),
            "secs": time.time() - t0}


# ------------------------------------------------------------- supervisor

class SearchSupervisor:
    """Run a tensor search with retry, watchdog, checkpointing and the
    engine failover ladder.

    ``ladder`` names the rungs to try in order (default ``("sharded",
    "device", "host")``); each rung is built from the shared protocol and
    limits on ``device`` (the card unless the caller names another; the
    mesh's device when only ``mesh`` is given), has the boundary
    installed, and resumes from the last checkpoint when a
    ``checkpoint_path`` holds a dump of its configuration.  The sharded
    rung runs ``ShardedTensorSearch`` over ``mesh`` (a ``ShardMesh``;
    default: one shard per card; a ``RankMesh`` runs it in one process
    per rank, built from ``protocol_factory``) with ``chunk`` rows per
    shard, and with
    ``elastic`` it degrades by halves (:func:`expand_ladder`).  A rung
    that fails past recovery (fatal error, exhausted retries, wedged or
    torn dispatch) is released and the next rung takes over; an
    OOM-shaped failure first re-levels the rung in place with a halved
    chunk (and, on the sharded rung, a halved superstep budget), up to
    :data:`MAX_KNOB_SHRINKS` times.  The returned ``SearchOutcome``
    carries ``retries`` / ``failovers`` / ``engine`` / ``mesh_width`` /
    ``mesh_shrinks`` / ``knob_retries`` / ``resumed_from_depth``, so no
    degradation is silent.  ``telemetry``
    (a ``tpu/telemetry.py`` recorder) is attached to every rung and
    receives the ladder's events."""

    def __init__(self, protocol,
                 ladder: Tuple[str, ...] = ("sharded", "device", "host"),
                 mesh=None,
                 policy: Optional[RetryPolicy] = None,
                 fault_plan: Optional[FaultPlan] = None,
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
                 dispatch_observer=None,
                 process_isolation: bool = False,
                 protocol_factory: Optional[str] = None,
                 factory_kwargs: Optional[dict] = None,
                 protocol_transform: Optional[str] = None,
                 warden_kwargs: Optional[dict] = None,
                 portfolio: bool = False,
                 swarm_kwargs: Optional[dict] = None,
                 spill=False,
                 telemetry=None,
                 elastic: bool = False,
                 device=None,
                 levels_dir: Optional[str] = None):
        for rung in ladder:
            if rung not in ("sharded", "device", "host"):
                raise ValueError(f"unknown ladder rung {rung!r}")
        self.telemetry = telemetry
        self.protocol = protocol
        self.ladder = tuple(ladder)
        if mesh is not None:
            mesh = as_mesh(mesh, device)
        if isinstance(mesh, RankMesh) and ("sharded" in ladder
                                           or portfolio) \
                and not protocol_factory:
            raise ValueError(
                "a sharded rung (or a portfolio's swarm lane) over a "
                "RankMesh runs in one process per rank, and a live "
                "protocol object cannot cross a process boundary: pass "
                "protocol_factory='module:callable' (+ factory_kwargs)")
        self.mesh = mesh
        self.device = (mesh.device if device is None and mesh is not None
                       else resolve_device(device))
        self.policy = policy or RetryPolicy()
        self.fault_plan = fault_plan
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        # Where each rung's dumps are also archived per level (the
        # memo's incremental re-checks; None = not archived).
        self.levels_dir = levels_dir
        self.strict = strict
        self.max_depth = max_depth
        self.max_secs = max_secs
        self.chunk = chunk
        self.frontier_cap = frontier_cap
        self.visited_cap = visited_cap
        self.ev_budget = ev_budget
        self.aot_warmup = aot_warmup
        self.dispatch_observer = dispatch_observer
        # Process isolation (tpu/warden.py): each rung runs in a spawned
        # child that rebuilds the protocol from ``protocol_factory``
        # ("module:callable" + ``factory_kwargs``, optionally piped
        # through ``protocol_transform``): a live protocol holds closures
        # a process boundary cannot carry.
        self.process_isolation = process_isolation
        self.protocol_factory = protocol_factory
        self.factory_kwargs = factory_kwargs
        self.protocol_transform = protocol_transform
        self.warden_kwargs = warden_kwargs
        self.portfolio = portfolio
        self.swarm_kwargs = swarm_kwargs
        # The capacity ladder: False passes CapacityOverflow through
        # unwrapped; "ladder" rebuilds the overflowed rung with the spill
        # tier and resumes (a second overflow escalates to an 8x host
        # tier); True or a SpillConfig runs every rung spill-enabled.
        if spill not in (False, True, "ladder"):
            from dslabs_tpu_torch.tpu import spill as spill_mod

            if not isinstance(spill, spill_mod.SpillConfig):
                raise ValueError(
                    "spill must be False, True, 'ladder', or a "
                    f"spill.SpillConfig, got {spill!r}")
        self.spill = spill
        if portfolio and process_isolation:
            raise ValueError(
                "portfolio=True and process_isolation=True are "
                "mutually exclusive (the swarm lane runs in-process)")
        self.elastic = bool(elastic)
        self.knob_retries = 0
        self.mesh_shrinks = 0
        self.boundary: Optional[DispatchBoundary] = None
        self.failures: List[EngineFailure] = []
        # The search that produced the last verdict (its device is the
        # platform a warden child reports).
        self.last_search = None
        # The device type of the last verdict's run ("cuda" or "cpu"),
        # copied from the warden under process isolation.
        self.last_platform: Optional[str] = None
        self._last_capacity_search = None
        # Engines are cached per rung, so repeated run() calls reuse
        # them; limits are refreshed from the supervisor per run.
        self._engines: Dict[object, object] = {}

    def _engine_spill(self):
        """The spill argument engines are built with (None = off)."""
        if self.spill in (False, "ladder"):
            return None
        return self.spill

    def _full_width(self) -> int:
        """The undegraded mesh width: the configured mesh's, else the
        number of cards (1 on the CPU)."""
        if self.mesh is not None:
            return self.mesh.width
        from dslabs_tpu_torch.tpu.mesh_exchange import card_count

        return card_count(self.device)

    def _mesh_for(self, width: Optional[int]):
        """The mesh a sharded rung runs on: the configured (or full) mesh
        for ``width=None``, else a narrower one on the same device, the
        elastic ladder's step down (its engine is cached by width)."""
        if width is None and self.mesh is not None:
            return self.mesh
        if isinstance(self.mesh, RankMesh):
            return self.mesh.narrowed(width)
        return ShardMesh(width or self._full_width(), self.device)

    def _build(self, rung: str, spill=None, width: Optional[int] = None,
               shrink: int = 0):
        # The plain full-width rungs key by name (callers index
        # ``_engines["sharded"]``); spill variants by host tier size,
        # narrower or knob-shrunk variants by (width, shrink).
        if spill is None and width is None and shrink == 0:
            key = rung
        elif width is None and shrink == 0:
            key = (rung, getattr(spill, "host_cap", True))
        else:
            key = (rung, getattr(spill, "host_cap", None), width, shrink)
        cached = self._engines.get(key)
        if cached is not None:
            cached.max_depth = self.max_depth
            cached.max_secs = self.max_secs
            return cached
        self._engines[key] = s = self._build_fresh(rung, spill, width,
                                                   shrink)
        return s

    def _build_fresh(self, rung: str, spill=None,
                     width: Optional[int] = None, shrink: int = 0):
        from dslabs_tpu_torch.tpu.engine import TensorSearch

        # Each knob-shrink re-level halves the chunk (the live device
        # memory per chunk step) and the superstep budget, so an OOM
        # retry runs strictly lighter.
        chunk = max(1, self.chunk >> shrink)
        if rung == "sharded":
            from dslabs_tpu_torch.tpu.sharded import ShardedTensorSearch

            mesh = self._mesh_for(width)
            cls = ShardedTensorSearch
            if isinstance(mesh, RankMesh):
                from dslabs_tpu_torch.tpu import ranks

                cls = functools.partial(
                    ranks.RankSearch, factory=self.protocol_factory,
                    factory_kwargs=self.factory_kwargs,
                    transform=self.protocol_transform)
            return cls(
                self.protocol, mesh,
                chunk_per_device=chunk,
                superstep_chunks=max(1, SUPERSTEP_CHUNKS >> shrink),
                frontier_cap=self.frontier_cap,
                visited_cap=self.visited_cap, max_depth=self.max_depth,
                max_secs=self.max_secs, strict=self.strict,
                ev_budget=self.ev_budget,
                checkpoint_path=self.checkpoint_path,
                checkpoint_every=self.checkpoint_every, spill=spill,
                levels_dir=self.levels_dir)
        return TensorSearch(
            self.protocol, frontier_cap=self.frontier_cap,
            chunk=chunk, max_depth=self.max_depth,
            max_secs=self.max_secs, ev_budget=self.ev_budget,
            visited_cap=self.visited_cap, strict=self.strict,
            use_host_visited=(rung == "host"),
            checkpoint_path=self.checkpoint_path,
            checkpoint_every=self.checkpoint_every, spill=spill,
            device=self.device, levels_dir=self.levels_dir)

    def _release(self, search, exc: BaseException) -> None:
        """Free what a failed rung holds on the card before the next one
        builds: its kept carry, and the carry that the failure's
        traceback frames still reference (and any cycle through them);
        then return the cached blocks to CUDA."""
        if search is not None:
            search._last_dev_carry = None
        seen = set()
        stack = [exc]
        while stack:
            e = stack.pop()
            if e is None or id(e) in seen:
                continue
            seen.add(id(e))
            if e.__traceback__ is not None:
                traceback.clear_frames(e.__traceback__)
            stack += [getattr(e, "cause", None), e.__cause__, e.__context__]
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _warm_up(self) -> float:
        """``aot_warmup``: load (and, on first use, build) the kernel
        library before the run; returns its seconds."""
        if not self.aot_warmup or self.device.type != "cuda":
            return 0.0
        from dslabs_tpu_torch.tpu import _build

        t0 = time.perf_counter()
        _build.lib()
        return time.perf_counter() - t0

    def run(self, resume: bool = False, initial=None,
            check_initial: bool = True):
        """Run the search to a verdict across the ladder.  ``resume``
        opts in to resuming the first rung from an existing checkpoint;
        later rungs always resume when a matching dump exists.  With
        ``process_isolation`` the ladder runs in warden-supervised child
        processes instead (same verdicts; see tpu/warden.py)."""
        if self.process_isolation:
            return self._run_isolated(resume=resume, initial=initial)
        if self.portfolio:
            return self._run_portfolio(resume, initial, check_initial)
        return self._run_ladder(resume, initial, check_initial)

    def _run_ladder(self, resume, initial, check_initial, cancel=None):
        """The in-process failover ladder.  ``cancel`` (a
        threading.Event) is the portfolio lane's first-verdict-wins cut,
        installed on every rung."""
        from dslabs_tpu_torch.tpu.engine import CapacityOverflow

        tel = self.telemetry
        self.boundary = DispatchBoundary(self.policy, self.fault_plan,
                                         observer=self.dispatch_observer,
                                         telemetry=tel)
        self.failures = []
        self.knob_retries = 0
        self.mesh_shrinks = 0
        warm = self._warm_up()
        specs = expand_ladder(
            self.ladder, self._full_width() if self.elastic else None,
            self.elastic)
        prev_width = None
        for i, (rung, width) in enumerate(specs):
            eff_width = 1
            if rung == "sharded":
                eff_width = width or self._full_width()
                if prev_width is not None and eff_width < prev_width:
                    # A burned mesh rung degrades by halves, resuming the
                    # checkpoint re-sharded to the smaller owner map.
                    self.mesh_shrinks += 1
                    if tel is not None:
                        tel.event("mesh_shrunk", from_width=prev_width,
                                  to_width=eff_width)
                prev_width = eff_width
            shrink = 0
            out = None
            search = None
            while True:
                search = self._build(rung, self._engine_spill(),
                                     width=width, shrink=shrink)
                self.boundary.install(search, engine=rung)
                self.boundary.reset_budget(rung)
                search._cancel_event = cancel
                search._telemetry = tel
                do_resume = ((resume or i > 0 or shrink > 0)
                             and search.has_resumable_checkpoint())
                if tel is not None:
                    tel.event("rung", engine=rung, index=i,
                              resume=bool(do_resume), width=eff_width,
                              shrink=shrink)
                try:
                    out = search.run(check_initial=check_initial,
                                     initial=initial, resume=do_resume)
                except EngineFailure as e:
                    self._release(search, e)
                    if (classify_oom(e.cause)
                            and shrink < MAX_KNOB_SHRINKS):
                        # An OOM-shaped failure re-levels in place from
                        # the checkpoint with a halved chunk: a memory
                        # spike costs a re-level, not a rung.
                        shrink += 1
                        self.knob_retries += 1
                        if tel is not None:
                            tel.event("knobs_shrunk", engine=rung,
                                      shrink=shrink,
                                      chunk=max(1, self.chunk >> shrink),
                                      width=eff_width,
                                      error=str(e.cause)[:200])
                        continue
                    self.failures.append(e)
                    if tel is not None:
                        tel.event("failover", engine=rung, failure=e.kind,
                                  width=eff_width, error=str(e.cause)[:200])
                except CapacityOverflow as e:
                    if self.spill != "ladder":
                        raise
                    self._release(search, e)
                    self.failures.append(EngineFailure(rung, "capacity", e))
                    out = self._capacity_retry(rung, width, shrink, initial,
                                               check_initial, cancel)
                    search = self._last_capacity_search or search
                break
            if out is None:
                continue
            out.engine = rung
            out.mesh_width = eff_width
            out.mesh_shrinks = self.mesh_shrinks
            out.knob_retries = self.knob_retries
            out.retries = self.boundary.retries
            out.failovers = len(self.failures)
            out.resumed_from_depth = search._resumed_from_depth
            out.abandoned_threads = self.boundary.abandoned_alive()
            out.compile_secs += warm
            out.platform = search.device.type
            if out.trace_id is None and tel is not None:
                out.trace_id = tel.trace_id
            self.last_platform = out.platform
            self.last_search = search
            return out
        raise SupervisorExhausted(self.failures)

    def _capacity_retry(self, rung, width, shrink, initial, check_initial,
                        cancel):
        """The capacity ladder's recovery arm: the overflowed rung is
        rebuilt with the host-RAM spill tier and resumes from the
        checkpoint; a second overflow escalates to an 8x host tier.
        Failures land on ``self.failures`` with kind ``"capacity"``;
        returns the outcome or None (fall through to the next rung)."""
        from dslabs_tpu_torch.tpu import spill as spill_mod
        from dslabs_tpu_torch.tpu.engine import CapacityOverflow

        self._last_capacity_search = None
        base = (self.spill if isinstance(self.spill, spill_mod.SpillConfig)
                else spill_mod.SpillConfig())
        for cfg in (base, dataclasses.replace(
                base, host_cap=base.host_cap * 8)):
            search = self._build(rung, cfg, width=width, shrink=shrink)
            self.boundary.install(search, engine=rung)
            search._cancel_event = cancel
            search._telemetry = self.telemetry
            if self.telemetry is not None:
                self.telemetry.event("capacity_retry", engine=rung,
                                     host_cap=cfg.host_cap)
            self._last_capacity_search = search
            try:
                return search.run(check_initial=check_initial,
                                  initial=initial,
                                  resume=search.has_resumable_checkpoint())
            except CapacityOverflow as e:
                self._release(search, e)
                self.failures.append(EngineFailure(rung, "capacity", e))
            except EngineFailure as e:
                self._release(search, e)
                self.failures.append(e)
                return None
        return None

    # ------------------------------------------------------ portfolio

    def _build_swarm(self):
        from dslabs_tpu_torch.tpu.swarm import SwarmSearch

        kw = dict(self.swarm_kwargs or {})
        kw.setdefault("visited_cap", self.visited_cap)
        kw.setdefault("strict", False)
        kw.setdefault("max_secs", self.max_secs)
        kw.setdefault("ev_budget", self.ev_budget)
        kw.setdefault("device", self.device)
        kw.setdefault("mesh", self.mesh)
        if self.checkpoint_path:
            # Swarm rounds checkpoint beside the BFS dump (their
            # fingerprints differ: neither resumes the other's).
            kw.setdefault("checkpoint_path",
                          self.checkpoint_path + ".swarm")
            kw.setdefault("checkpoint_every", self.checkpoint_every)
        if isinstance(kw["mesh"], RankMesh):
            # One walker group per rank, rebuilt from the factory.
            from dslabs_tpu_torch.tpu import ranks

            kw.pop("device", None)
            return ranks.RankSwarm(
                self.protocol, kw.pop("mesh"), self.protocol_factory,
                factory_kwargs=self.factory_kwargs,
                transform=self.protocol_transform, **kw)
        return SwarmSearch(self.protocol, **kw)

    def _run_portfolio(self, resume, initial, check_initial):
        """BFS ladder and swarm fleet as concurrent lanes; the first
        terminal verdict wins, the loser stops at its next boundary.
        Lane outcomes and errors land on ``self.lanes``; the lanes'
        seconds on each outcome's ``elapsed_secs``."""
        terminal = ("INVARIANT_VIOLATED", "EXCEPTION_THROWN", "GOAL_FOUND")
        cancel = threading.Event()
        lanes: Dict[str, object] = {}
        self.lanes = lanes

        def record(name, out):
            lanes[name] = out
            if out.end_condition in terminal:
                lanes.setdefault("winner", name)
                if self.telemetry is not None:
                    self.telemetry.event("lane_winner", lane=name,
                                         end=out.end_condition)
                cancel.set()

        def bfs_lane():
            try:
                out = self._run_ladder(resume, initial, check_initial,
                                       cancel=cancel)
                record("bfs", out)
                # Exhaustive BFS verdicts are authoritative: nothing the
                # swarm could still find changes them.  (TIME_EXHAUSTED
                # is not: the swarm keeps its budget.)
                if out.end_condition in ("SPACE_EXHAUSTED",
                                         "DEPTH_EXHAUSTED"):
                    lanes.setdefault("winner", "bfs")
                    cancel.set()
            except BaseException as e:  # noqa: BLE001 - re-raised below
                lanes["bfs_err"] = e

        def swarm_lane():
            try:
                sw = self._build_swarm()
                boundary = DispatchBoundary(self.policy, self.fault_plan,
                                            telemetry=self.telemetry)
                boundary.install(sw, engine="swarm")
                sw._cancel_event = cancel
                sw._telemetry = self.telemetry
                out = sw.run(resume=resume, initial=initial,
                             check_initial=False)
                out.engine = "swarm"
                out.platform = sw.device.type
                out.retries = boundary.retries
                record("swarm", out)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                lanes["swarm_err"] = e

        if self.telemetry is not None:
            self.telemetry.event("lane", lanes="bfs+swarm")
        threads = [threading.Thread(target=bfs_lane, daemon=True,
                                    name="dslabs-portfolio-bfs"),
                   threading.Thread(target=swarm_lane, daemon=True,
                                    name="dslabs-portfolio-swarm")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        winner = lanes.get("winner")
        if winner is not None:
            return lanes[winner]
        # No terminal verdict: BFS's exhaust outcome is the richer
        # report; a crashed BFS lane falls back to the swarm's.
        if "bfs" in lanes:
            return lanes["bfs"]
        if "swarm" in lanes:
            return lanes["swarm"]
        raise lanes.get("bfs_err") or lanes.get("swarm_err")

    def _run_isolated(self, resume: bool, initial=None):
        """Process isolation: delegate the ladder to a
        :class:`~dslabs_tpu_torch.tpu.warden.Warden` (one spawned child
        per rung, heartbeat-supervised, SIGKILL on silence, resume from
        the checkpoint).  The warden's failure chain lands on
        ``self.failures``."""
        from dslabs_tpu_torch.tpu.warden import Warden

        if initial is not None:
            raise ValueError(
                "process_isolation cannot ship an in-memory initial "
                "state across the process boundary; encode it in the "
                "protocol_factory instead")
        if not self.protocol_factory:
            raise ValueError(
                "process_isolation=True requires protocol_factory="
                "'module:callable' (+ factory_kwargs): a live protocol "
                "object cannot cross the spawn boundary")
        wkw = dict(self.warden_kwargs or {})
        wkw.setdefault("elastic", self.elastic)
        wkw.setdefault("mesh_width", self._full_width())
        if isinstance(self.mesh, RankMesh):
            wkw.setdefault("rank_mesh", self.mesh.spec())
        warden = Warden(
            factory=self.protocol_factory,
            factory_kwargs=self.factory_kwargs,
            transform=self.protocol_transform,
            ladder=self.ladder, policy=self.policy,
            checkpoint_path=self.checkpoint_path,
            checkpoint_every=self.checkpoint_every,
            strict=self.strict, max_depth=self.max_depth,
            max_secs=self.max_secs, chunk=self.chunk,
            frontier_cap=self.frontier_cap,
            visited_cap=self.visited_cap, ev_budget=self.ev_budget,
            aot_warmup=self.aot_warmup, telemetry=self.telemetry,
            device=self.device, levels_dir=self.levels_dir, **wkw)
        try:
            return warden.run(resume=resume)
        finally:
            self.failures = warden.failures
            self.last_platform = warden.last_platform
