"""Telemetry: the dispatch-span flight recorder, metrics and run reports.

The port's own copy of ``dslabs_tpu/tpu/telemetry.py``.  Its contract is
the reference's: **every signal comes from host scalars the loops already
read.**  The recorder adds no device dispatch, no host sync and no
readback: no ``torch.cuda.synchronize()``, no ``.item()``, no ``.cpu()``
(``tests/test_torch_telemetry.py`` counts them).

* **Dispatch spans.**  :meth:`Telemetry.attach` (or ``telemetry=`` on an
  engine) routes the search's ``_dispatch`` seam, which every device
  dispatch and blocking readback of the loops goes through, into
  :meth:`Telemetry.record_dispatch`.  Each dispatch becomes a span
  (engine, site, per-engine index, live BFS depth, wall seconds, the
  retries the supervisor's boundary absorbed, outcome) in a bounded ring
  and, with a ``flight_log``, one JSONL line of the **flight recorder**
  (``checkpoint.default_flight_log``: ``flight.jsonl`` beside the dump).
  The file is line-buffered and append-only, and a begin marker is
  written before each call, so a SIGKILLed or wedged run leaves a
  readable trail whose torn tail names the dispatch in flight.

  A span's wall is the host's clock around the call.  On the card the
  port's launches are asynchronous, so ``device.step``'s wall is the
  host's time to launch the chunk step (its ~7,400 eager kernels, and
  whatever the step itself waits for), and ``device.sync``'s wall is the
  wait for the device at the stats readback: together the host / device
  split of every chunk step, at zero added syncs.  A span never
  synchronises to make its wall a device time.

* **Metrics.**  Counters, gauges and histograms fed from per-level
  records (both BFS loops, spill mode, the swarm's rounds), outcomes,
  spill events, the supervisor's recovery events and the warden's
  re-emitted heartbeats.  :meth:`Telemetry.summary` is the compact JSON
  block a caller attaches to its output.

* **Profiler window.**  ``Telemetry(profile_dir=..., profile_steps=4)``
  runs ``torch.profiler`` around the first ``profile_steps`` hot
  dispatches after the first at each hot site (that one pays the
  kernels' load and first launches), CPU and CUDA activities on the
  card, CPU only on the CPU, and exports a Chrome trace into
  ``profile_dir``.  Opt-in: stopping the profiler flushes CUPTI, a sync
  the zero-overhead contract does not cover.

* **Run reports.**  ``python -m dslabs_tpu_torch.tpu.telemetry report
  <run-dir-or-flight-log> [--json]`` renders the flight log alone:
  per-site latency percentiles, per-level throughput, the recovery
  timeline, spill and overflow counts, the compile / steady wall split
  and the in-flight dispatch of a torn tail.  ``sites`` prints the
  dispatch-site registry, ``trace`` assembles the causal trace
  (``tpu/tracing.py``), ``compare <ledger.jsonl>`` diffs the latest run
  of a bench ledger against the best prior run per phase.

* **Live monitor.**  A recorder with a flight log rewrites
  ``STATUS.json`` beside it atomically at level and event boundaries
  (depth, rates, skew, spill, rung, lane, the dispatch in flight);
  ``watch <run-dir>`` renders any run, a warden child included, from the
  directory alone, and survives the run being SIGKILLed.

Thread-safe: the portfolio's two lanes share one recorder, and the spill
drain worker, the checkpoint writer and a watchdog-abandoned dispatch
thread may emit; every write goes through one lock, and a record that
arrives after :meth:`Telemetry.close` is dropped, never raised.

Deliberate differences from the reference: the ``DSLABS_PROFILE*``,
``DSLABS_TELEMETRY_RING``, ``DSLABS_STATUS_SECS``, ``DSLABS_RATE_WINDOW``,
``DSLABS_SKEW_WARN``, ``DSLABS_BENCH_REGRESS_PCT`` and
``DSLABS_COMPILE_REGRESS_FLOOR`` environment knobs are arguments or
module constants here; the profiler window is ``torch.profiler``, not
``jax.profiler``; :data:`DISPATCH_SITES` lists the port's own tags with
the audit fields (``in_place`` for the reference's ``donated``, and
``syncs``; the sharded engine's nine ``sharded.*`` sites are those of
``tpu/sharded.py``, multi-device whether its shards share one card or
run as ranks, where a gloo rank on a card adds its staging's syncs to a
site's budget); a span's ``scale`` is
its site's published deadline scale, as in the reference (the sharded
superstep's; the swarm's walk step is one step and publishes none, so
its spans read 1.0); per-device lanes have one entry per shard of the
sharded engine, one per walker group of the swarm, and one elsewhere
(one card).  The module imports the stdlib only; torch is imported where
the profiler window and the memory poll need it.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
import warnings
from collections import deque
from typing import Dict, List, Optional

__all__ = ["Telemetry", "MetricsRegistry", "Counter", "Gauge",
           "Histogram", "read_flight", "tail_records", "build_report",
           "render_report", "render_sites", "skew_metrics",
           "device_memory_stats", "default_status_path", "load_status",
           "render_watch", "watch_frame", "append_ledger",
           "read_ledger", "compare_ledger", "render_compare",
           "DISPATCH_SITES", "main"]

# Every tag the port's loops route through ``TensorSearch._dispatch``,
# and the audit-only tags of the hot-path auditor
# (``analysis/hotpath_audit.py``), with the contract each site is
# audited against:
#
#   hot       a steady-state dispatch worth a profiler capture
#   in_place  the site updates its carry in place (the reference's
#             ``donated``): its carry tensors of >= 64 KiB keep their
#             storage over a call (J3)
#   multi     collectives are expected (False: any is a J4 finding)
#   program   the site runs device work (False: a readback or a host
#             helper)
#   syncs     host syncs one call may take by design (J1); None where
#             it depends on the engine's configuration, and then the
#             engine's site entry (``dispatch_site_programs``) carries
#             the value for its own
#
# This is the one copy of each site's contract: an engine's entry holds
# its function and arguments, and overrides the contract only where it
# must (``device.step``'s budget, and each function of a two-function
# tag).
DISPATCH_SITES = {
    "device.init": dict(hot=False, in_place=False, multi=False,
                        program=True, syncs=0),
    # Unpacked and outside spill mode, none.  Packed, one: the count of
    # the selected rows (torch.nonzero, engine.py _build_dev_step) before
    # they are packed; spill mode, one: the abort code read before the
    # step writes the carry.  Both: two.
    "device.step": dict(hot=True, in_place=True, multi=False,
                        program=True, syncs=None),
    "device.sync": dict(hot=False, in_place=False, multi=False,
                        program=False, syncs=1),       # the stats readback
    "device.promote": dict(hot=False, in_place=True, multi=False,
                           program=True, syncs=0),
    "device.flags": dict(hot=False, in_place=False, multi=False,
                         program=False, syncs=1),      # the flag rows
    # Two functions each: a read-only fetch (the drain's rows, keys and
    # keep mask, three copies; the eviction's occupied lines, one), then
    # an in-place reset; the budget is the fetch's, and the reset's entry
    # sets its own, none.
    "device.spill_drain": dict(hot=False, in_place=True, multi=False,
                               program=True, syncs=3),
    "device.spill_evict": dict(hot=False, in_place=True, multi=False,
                               program=True, syncs=1),
    "device.spill_reinject": dict(hot=False, in_place=True, multi=False,
                                  program=False, syncs=1),  # the upload
    "host.expand": dict(hot=True, in_place=False, multi=False,
                        program=True, syncs=0),
    # The fleet's schedules and counters uploaded (two) and the table's
    # insert counts read (one).
    "swarm.init": dict(hot=False, in_place=False, multi=False,
                       program=True, syncs=3),
    # The walk step rebinds its per-walker arrays (where-selects) and
    # writes only the table in place; one sync, the first-hit scalar.
    "swarm.step": dict(hot=True, in_place=False, multi=False,
                       program=True, syncs=1),
    "swarm.sync": dict(hot=False, in_place=False, multi=False,
                       program=False, syncs=1),        # the round stats
    "swarm.flags": dict(hot=False, in_place=False, multi=False,
                        program=False, syncs=6),       # six capture arrays
    # Batched job lanes (tpu/lanes.py): one superstep per level advances
    # every resident lane (its budget depends on the configuration, like
    # device.step's: one sync per chunk step packed, the torch.nonzero
    # before the pack, and one per window pass with a finite ev_budget);
    # the promote swaps the stacked buffers; the init, inject and restore
    # rebuild lanes in place (the restore: the dump's keys and rows
    # uploaded and the rebuilt table's counts read, three).
    "lanes.init": dict(hot=False, in_place=False, multi=False,
                       program=True, syncs=0),
    "lanes.superstep": dict(hot=True, in_place=True, multi=False,
                            program=True, syncs=None),
    "lanes.sync": dict(hot=False, in_place=False, multi=False,
                       program=False, syncs=1),        # the lane stats
    "lanes.promote": dict(hot=False, in_place=True, multi=False,
                          program=True, syncs=0),
    "lanes.inject": dict(hot=False, in_place=True, multi=False,
                         program=True, syncs=0),
    "lanes.restore": dict(hot=False, in_place=True, multi=False,
                          program=True, syncs=3),
    "lanes.flags": dict(hot=False, in_place=False, multi=False,
                        program=False, syncs=1),       # one lane's rows
    # The owner-sharded engine (tpu/sharded.py; multi: its exchange is the
    # collective of the reference's shard_map programs, a torch.distributed
    # op on the ranks of a RankMesh).  The superstep is
    # one level: its stats readback, and per chunk step the count before
    # the pack (packed), the window check (finite ev_budget with ev_spill)
    # and the abort code (spill mode), so its budget, like the legacy
    # chunk step's (the count before the pack, the abort code), is the
    # engine's.  The init from the root, the promote (a buffer swap or the
    # legacy rebalance, with the delta re-encode) take none; the steal one
    # (its plan's upload); the spill round trips are the solo engine's
    # (the reinjection: the segment's upload, and the level base's read
    # with delta lanes).
    "sharded.superstep": dict(hot=True, in_place=True, multi=True,
                              program=True, syncs=None),
    "sharded.step": dict(hot=True, in_place=True, multi=True,
                         program=True, syncs=None),
    "sharded.sync": dict(hot=False, in_place=False, multi=False,
                         program=False, syncs=1),      # the stats readback
    "sharded.promote": dict(hot=False, in_place=True, multi=True,
                            program=True, syncs=0),
    "sharded.init": dict(hot=False, in_place=False, multi=True,
                         program=True, syncs=0),
    "sharded.steal": dict(hot=False, in_place=True, multi=True,
                          program=True, syncs=1),
    "sharded.spill_drain": dict(hot=False, in_place=True, multi=True,
                                program=True, syncs=3),
    "sharded.spill_evict": dict(hot=False, in_place=True, multi=True,
                                program=True, syncs=1),
    "sharded.spill_reinject": dict(hot=False, in_place=True, multi=True,
                                   program=False, syncs=None),
    # Audit-only: kernel 2 alone, over one chunk step's keys; the pack
    # and unpack of frontier rows and the symmetry canonicalize pass,
    # which run inside the step (registered by engines that pack or
    # reduce).
    "visited.insert": dict(hot=True, in_place=True, multi=False,
                           program=True, syncs=0),
    "packing.pack": dict(hot=False, in_place=False, multi=False,
                         program=True, syncs=0),
    "packing.unpack": dict(hot=False, in_place=False, multi=False,
                           program=True, syncs=0),
    "symmetry.canonicalize": dict(hot=False, in_place=False,
                                  multi=False, program=True, syncs=0),
}

# The hot sites' suffixes (the profiler window's selection), derived from
# the registry so the two cannot drift.
_PROFILE_SITES = tuple(sorted({t.split(".", 1)[1]
                               for t, m in DISPATCH_SITES.items()
                               if m["hot"]}))

# The reference's environment defaults, as constants.
RING = 512                   # spans kept in memory
STATUS_SECS = 1.0            # least seconds between throttled STATUS writes
RATE_WINDOW = 8              # level records in the sliding rate window
SKEW_WARN = 3.0              # per-level imbalance that warns (mesh scope)
BENCH_REGRESS_PCT = 0.25     # tolerated fractional slowdown in a compare
COMPILE_REGRESS_FLOOR = 1.0  # compile seconds below which creep is noise


def skew_metrics(values) -> dict:
    """Skew summary of one per-device lane: ``imbalance`` = max / mean
    (1.0 is balanced) and the coefficient of variation.  Host math over
    scalars the level readback already holds."""
    vals = [float(v) for v in values]
    n = len(vals)
    if not n:
        return {"max": 0, "mean": 0.0, "imbalance": 1.0, "cv": 0.0}
    mean = sum(vals) / n
    mx = max(vals)
    if mean <= 0:
        return {"max": mx, "mean": round(mean, 3),
                "imbalance": 1.0, "cv": 0.0}
    var = sum((v - mean) ** 2 for v in vals) / n
    return {"max": mx, "mean": round(mean, 3),
            "imbalance": round(mx / mean, 4),
            "cv": round(math.sqrt(var) / mean, 4)}


def device_memory_stats(devices) -> Optional[List[int]]:
    """Per-device peak allocated bytes (``torch.cuda.max_memory_allocated``,
    the caching allocator's host-side counter: no dispatch, no sync).
    None when a device is not a CUDA device (the CPU keeps no such
    statistic) or nothing was allocated."""
    out = []
    for d in devices:
        dev_type = getattr(d, "type", str(d).split(":")[0])
        if dev_type != "cuda":
            return None
        import torch

        out.append(int(torch.cuda.max_memory_allocated(d)))
    return out if any(out) else None


def default_status_path(flight_log: Optional[str]) -> Optional[str]:
    """The STATUS.json that pairs with a flight log: ``STATUS.json``
    beside ``flight.jsonl`` (the run-dir layout); a named log
    ``<name>.flight.jsonl`` gets ``<name>.STATUS.json``, so recorders
    sharing a directory never overwrite each other's."""
    if not flight_log:
        return None
    d = os.path.dirname(os.path.abspath(flight_log))
    base = os.path.basename(flight_log)
    if base == "flight.jsonl":
        return os.path.join(d, "STATUS.json")
    for suffix in (".flight.jsonl", ".jsonl"):
        if base.endswith(suffix):
            return os.path.join(d, base[:-len(suffix)] + ".STATUS.json")
    return os.path.join(d, base + ".STATUS.json")


# ------------------------------------------------------------- registry

class Counter:
    """Monotonic count (events, dispatches, retries)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, v: int = 1) -> None:
        self.value += v


class Gauge:
    """Last-written scalar (depth, table load, outcome counters)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Bounded sample store with percentile readout: the most recent
    ``cap`` observations, plus the total count and sum."""

    __slots__ = ("values", "count", "total", "cap")

    def __init__(self, cap: int = 4096):
        self.values: deque = deque(maxlen=cap)
        self.count = 0
        self.total = 0.0
        self.cap = cap

    def observe(self, v: float) -> None:
        self.values.append(float(v))
        self.count += 1
        self.total += float(v)

    def percentile(self, q: float) -> float:
        if not self.values:
            return 0.0
        vs = sorted(self.values)
        i = min(len(vs) - 1, max(0, int(round(q * (len(vs) - 1)))))
        return vs[i]

    def snapshot(self) -> dict:
        return {"count": self.count,
                "total": round(self.total, 6),
                "p50": round(self.percentile(0.50), 6),
                "p90": round(self.percentile(0.90), 6),
                "p99": round(self.percentile(0.99), 6),
                "max": round(max(self.values, default=0.0), 6)}


class MetricsRegistry:
    """Create-on-touch named metrics; ``snapshot()`` is plain JSON."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        return h

    def snapshot(self) -> dict:
        return {
            "counters": {k: c.value for k, c in self.counters.items()},
            "gauges": {k: g.value for k, g in self.gauges.items()},
            "histograms": {k: h.snapshot()
                           for k, h in self.histograms.items()},
        }


# ------------------------------------------------------ profiler window

class _ProfileWindow:
    """``torch.profiler`` around the first ``steps`` hot dispatches after
    the first at each hot site, exported as a Chrome trace into
    ``directory`` (``trace_path`` names the file).  Off when
    ``directory`` is None.  A failure turns the window off, never the
    search."""

    def __init__(self, directory: Optional[str] = None, steps: int = 4):
        self.dir = directory
        self.steps = max(1, int(steps))
        self.active = False
        self.done = directory is None
        self.trace_path: Optional[str] = None
        self.error: Optional[str] = None
        self._left = 0
        self._seen: Dict[str, int] = {}
        self._prof = None

    def on_start(self, site: str, device_type: str) -> None:
        if self.done or self.active or site not in _PROFILE_SITES:
            return
        n = self._seen.get(site, 0)
        self._seen[site] = n + 1
        if n == 0:
            return                    # the site's first dispatch: warm-up
        try:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if device_type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(self.dir, exist_ok=True)
            prof = profile(activities=acts)
            prof.start()
            self._prof = prof
            self.active = True
            self._left = self.steps
        except Exception as e:  # noqa: BLE001 - the window degrades to off
            self.error = f"{type(e).__name__}: {e}"
            self.done = True

    def on_done(self, site: str) -> None:
        if not self.active or site not in _PROFILE_SITES:
            return
        self._left -= 1
        if self._left <= 0:
            self.stop()

    def stop(self) -> None:
        """Close the window: stop the profiler (CUPTI flushes here) and
        export its Chrome trace."""
        if not self.active:
            return
        self.active = False
        self.done = True
        try:
            self._prof.stop()
            path = os.path.join(
                self.dir, f"torch-profile-{os.getpid()}-"
                          f"{int(time.time() * 1000)}.json")
            self._prof.export_chrome_trace(path)
            self.trace_path = path
        except Exception as e:  # noqa: BLE001 - the window degrades to off
            self.error = f"{type(e).__name__}: {e}"


# ------------------------------------------------------------- recorder

class Telemetry:
    """The per-run recorder.  ``attach(search)`` routes the search's
    ``_dispatch`` seam through :meth:`record_dispatch`; the loops feed
    per-level records through :meth:`on_level` and verdicts through
    :meth:`on_outcome`; the supervisor, warden and spill tier feed events
    through :meth:`event`.  Everything lands in the ring, the metrics
    registry and, with a ``flight_log``, the flight recorder.

    The trace id and parent span come from the environment
    (``tpu/tracing.py``), so a warden child's recorder joins its parent's
    trace.  The ring keeps the last :data:`RING` spans; STATUS.json lies
    beside the flight log; ``profile_dir`` / ``profile_steps`` open the
    profiler window."""

    def __init__(self, flight_log: Optional[str] = None,
                 engine_hint: Optional[str] = None,
                 profile_dir: Optional[str] = None,
                 profile_steps: int = 4):
        from dslabs_tpu_torch.tpu import tracing as tracing_mod

        self.trace_id, self.parent_span = tracing_mod.current_trace()
        self.span_id = tracing_mod.new_span_id()
        self.ring: deque = deque(maxlen=RING)
        self.registry = MetricsRegistry()
        self.levels: List[dict] = []
        self.events: deque = deque(maxlen=512)
        self.flight_log = flight_log
        self.engine_hint = engine_hint
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._profile = _ProfileWindow(profile_dir, profile_steps)
        self._t0 = time.time()
        self._fh = None
        self._closed = False
        self.flight_error: Optional[str] = None
        # Live-monitor state: the last level / event / outcome scalars,
        # rewritten atomically into STATUS.json.
        self.status_path = default_status_path(flight_log)
        self._status_last = 0.0
        self._status: Dict[str, object] = {}
        self._prev_explored: Dict[str, int] = {}
        # Rates per engine: explored over the summed level walls of the
        # whole run, and over the last RATE_WINDOW levels.
        self._level_wall: Dict[str, float] = {}
        self._rate_window: Dict[str, deque] = {}
        self._open_dispatch: Optional[dict] = None
        self._warned_skew = False
        if flight_log:
            # Line-buffered append: every record reaches the OS in its own
            # write, so a SIGKILL leaves whole lines but for a torn tail.
            # An unwritable location records in RAM only.
            try:
                d = os.path.dirname(os.path.abspath(flight_log))
                os.makedirs(d, exist_ok=True)
                self._fh = open(flight_log, "a", buffering=1)
            except OSError as e:
                self.flight_error = f"{type(e).__name__}: {e}"
                self.flight_log = None
                self.status_path = None
        self._write({"t": "meta", "started": round(self._t0, 3),
                     "pid": os.getpid(), "hint": engine_hint,
                     "trace_id": self.trace_id,
                     "parent_span": self.parent_span,
                     "span_id": self.span_id})

    @classmethod
    def for_checkpoint(cls, checkpoint_path: str, **kw) -> "Telemetry":
        """The run-dir recorder: its flight log beside the dump
        (``checkpoint.default_flight_log``), STATUS.json beside that."""
        from dslabs_tpu_torch.tpu import checkpoint as ckpt_mod

        kw.setdefault("flight_log",
                      ckpt_mod.default_flight_log(checkpoint_path))
        return cls(**kw)

    @property
    def profile(self) -> _ProfileWindow:
        """The profiler window (``active``, ``trace_path``, ``error``)."""
        return self._profile

    # ----------------------------------------------------------- plumbing

    def _ts(self) -> float:
        return round(time.time() - self._t0, 4)

    def _write(self, rec: dict) -> None:
        if self._fh is None:
            return
        try:
            self._fh.write(json.dumps(rec) + "\n")
        except (OSError, ValueError):
            self._fh = None           # disk gone or closed: RAM only

    def _write_status(self, force: bool = False) -> None:
        """Atomically rewrite STATUS.json (a tmp file and ``os.replace``:
        a reader, or a SIGKILL, never sees a torn file).  Called with the
        lock held at level boundaries, events and outcomes, and, at most
        every STATUS_SECS, at dispatch begin markers.  Host file IO only;
        a failure turns the monitor off, never the run."""
        if self.status_path is None or self._closed:
            return
        now = time.time()
        if not force and now - self._status_last < STATUS_SECS:
            return
        self._status_last = now
        st = {
            "t": "status", "pid": os.getpid(),
            "hint": self.engine_hint,
            "updated": round(now, 3),
            "uptime": round(now - self._t0, 1),
            "spans": sum(self._counts.values()),
            "levels": len(self.levels),
            "last_span": self.ring[-1] if self.ring else None,
            "in_flight": self._open_dispatch,
            "flight_log": self.flight_log,
            # Always present (the schema is pinned); None until fed.
            "mesh_width": None,
            "skew_agg": None,
            "trace_id": self.trace_id,
            "parent_span": self.parent_span,
            "span_id": self.span_id,
            **self._status,
        }
        tmp = self.status_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                f.write(json.dumps(st))
            os.replace(tmp, self.status_path)
        except OSError:
            self.status_path = None

    def close(self) -> None:
        """Final STATUS.json, close the flight log and an open profiler
        window.  Records that arrive later are dropped."""
        with self._lock:
            self._profile.stop()
            self._write_status(force=True)
            self._closed = True
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    def attach(self, search):
        """Route ``search``'s dispatches through this recorder.  Returns
        the search."""
        search._telemetry = self
        return search

    # ----------------------------------------------------------- dispatch

    def record_dispatch(self, search, tag: str, hook, fn, *args):
        """The span source, called by ``TensorSearch._dispatch`` for every
        dispatch: a begin marker, the hook chain (the supervisor's
        boundary included) or the plain call, then the span.  Only host
        scalars are recorded; the call's result is returned untouched."""
        engine, _, site = tag.partition(".")
        depth = int(getattr(search, "_current_depth", 0) or 0)
        boundary = getattr(search, "_dispatch_boundary", None)
        r0 = boundary.retries if boundary is not None else 0
        scales = getattr(search, "_dispatch_deadline_scales", None) or {}
        scale = float(scales.get(site, 1.0))
        dev = getattr(getattr(search, "device", None), "type", "cpu")
        with self._lock:
            idx = self._counts.get(engine, 0)
            self._counts[engine] = idx + 1
            start = {"t": "dispatch", "ts": self._ts(), "tag": tag,
                     "i": idx, "depth": depth}
            if self.trace_id:
                start["trace"] = self.trace_id
            self._write(start)
            self._open_dispatch = start
            self._write_status()
            self._profile.on_start(site, dev)
        t0 = time.time()
        outcome = "ok"
        try:
            if hook is None:
                return fn(*args)
            return hook(tag, fn, *args)
        except BaseException as e:  # noqa: BLE001 - recorded, re-raised
            outcome = type(e).__name__
            raise
        finally:
            wall = time.time() - t0
            retries = ((boundary.retries - r0)
                       if boundary is not None else 0)
            span = {"t": "span", "ts": self._ts(), "tag": tag,
                    "engine": engine, "site": site, "i": idx,
                    "depth": depth, "wall": round(wall, 6),
                    "retries": retries, "scale": scale,
                    "outcome": outcome}
            if self.trace_id:
                span["trace"] = self.trace_id
            with self._lock:
                self._profile.on_done(site)
                self.ring.append(span)
                self._write(span)
                self._open_dispatch = None
                self.registry.counter(f"dispatches.{engine}").inc()
                self.registry.histogram(f"dispatch_secs.{tag}").observe(
                    wall)
                if retries:
                    self.registry.counter("retries").inc(retries)
                if outcome != "ok":
                    self.registry.counter(
                        f"dispatch_errors.{outcome}").inc()

    @contextlib.contextmanager
    def span(self, tag: str, **fields):
        """A span around host work that is not a dispatch (a timed block
        of a tool); same record shape and registry feeds."""
        engine, _, site = tag.partition(".")
        with self._lock:
            idx = self._counts.get(engine, 0)
            self._counts[engine] = idx + 1
            start = {"t": "dispatch", "ts": self._ts(), "tag": tag,
                     "i": idx, "depth": 0}
            self._write(start)
            self._open_dispatch = start
            self._write_status()
        t0 = time.time()
        outcome = "ok"
        try:
            yield self
        except BaseException as e:  # noqa: BLE001 - recorded, re-raised
            outcome = type(e).__name__
            raise
        finally:
            wall = time.time() - t0
            span = {"t": "span", "ts": self._ts(), "tag": tag,
                    "engine": engine, "site": site, "i": idx,
                    "depth": 0, "wall": round(wall, 6), "retries": 0,
                    "scale": 1.0, "outcome": outcome, **fields}
            if self.trace_id:
                span["trace"] = self.trace_id
            with self._lock:
                self.ring.append(span)
                self._write(span)
                self._open_dispatch = None
                self.registry.counter(f"dispatches.{engine}").inc()
                self.registry.histogram(f"dispatch_secs.{tag}").observe(
                    wall)

    # -------------------------------------------------------- other feeds

    def event(self, kind: str, **fields) -> None:
        """An operational event (supervisor retry / failover / rung, warden
        heartbeat / child_death, spill evict / spool / reinject, a
        warm-up's compile, ...)."""
        rec = {"t": "event", "ts": self._ts(), "kind": kind, **fields}
        if self.trace_id:
            rec.setdefault("trace", self.trace_id)
        with self._lock:
            self.events.append(rec)
            self._write(rec)
            self.registry.counter(f"events.{kind}").inc()
            # Where the run is, for the live monitor: the ladder rung, the
            # last degradation, the portfolio lane, the spill tier.
            if kind in ("rung", "capacity_retry"):
                self._status["rung"] = {k: v for k, v in rec.items()
                                        if k not in ("t", "ts")}
                if fields.get("width"):
                    self._status["mesh_width"] = fields["width"]
                self._write_status(force=True)
            elif kind in ("mesh_shrunk", "knobs_shrunk"):
                self._status["resilience"] = {
                    k: v for k, v in rec.items() if k not in ("t", "ts")}
                if fields.get("to_width"):
                    self._status["mesh_width"] = fields["to_width"]
                self._write_status(force=True)
            elif kind in ("lane", "lane_winner", "failover",
                          "child_death"):
                self._status["lane"] = {k: v for k, v in rec.items()
                                        if k not in ("t", "ts")}
                self._write_status(force=True)
            elif kind.startswith("spill"):
                self._status["spill"] = {k: v for k, v in rec.items()
                                         if k not in ("t", "ts")}
                self._write_status()
            else:
                self._write_status()

    def on_level(self, engine: str, record: dict) -> None:
        """One completed BFS level (or swarm round), described by the
        host scalars of the readback the loop already made (depth, wall,
        explored, unique, next_frontier, ...)."""
        rec = {"t": "level", "ts": self._ts(), "engine": engine, **record}
        skew = rec.get("skew")
        with self._lock:
            self.levels.append(rec)
            self._write(rec)
            self.registry.counter(f"levels.{engine}").inc()
            self.registry.gauge(f"depth.{engine}").set(
                record.get("depth", 0))
            self.registry.gauge(f"explored.{engine}").set(
                record.get("explored", 0))
            self.registry.gauge(f"unique.{engine}").set(
                record.get("unique", 0))
            if record.get("wall") is not None:
                self.registry.histogram(f"level_secs.{engine}").observe(
                    float(record["wall"]))
            if record.get("load_factor") is not None:
                self.registry.gauge(f"load_factor.{engine}").set(
                    record["load_factor"])
            if skew:
                work = skew.get("explored") or next(iter(skew.values()))
                self.registry.gauge(f"skew.{engine}").set(
                    work.get("imbalance", 1.0))
                self.registry.gauge(f"skew_cv.{engine}").set(
                    work.get("cv", 0.0))
                self.registry.histogram(
                    f"skew_imbalance.{engine}").observe(
                    float(work.get("imbalance", 1.0)))
                # The running skew aggregate of STATUS.json: worst and
                # mean per-level imbalance and the worst cv.
                agg = self._status.get("skew_agg") or {
                    "imbalance_max": 1.0, "imbalance_mean": 0.0,
                    "cv_max": 0.0, "levels": 0}
                n = agg["levels"]
                imb = float(work.get("imbalance", 1.0))
                agg["imbalance_max"] = max(agg["imbalance_max"], imb)
                agg["imbalance_mean"] = round(
                    (agg["imbalance_mean"] * n + imb) / (n + 1), 3)
                agg["cv_max"] = max(
                    agg["cv_max"], round(float(work.get("cv", 0.0)), 3))
                agg["imbalance_max"] = round(agg["imbalance_max"], 3)
                agg["levels"] = n + 1
                self._status["skew_agg"] = agg
            explored = int(record.get("explored", 0) or 0)
            delta = explored - self._prev_explored.get(engine, 0)
            self._prev_explored[engine] = explored
            wall = float(record.get("wall", 0.0) or 0.0)
            wall_total = self._level_wall.get(engine, 0.0) + wall
            self._level_wall[engine] = wall_total
            win = self._rate_window.get(engine)
            if win is None:
                win = self._rate_window[engine] = deque(maxlen=RATE_WINDOW)
            win.append((delta, wall))
            win_d = sum(d for d, _ in win)
            win_w = sum(w for _, w in win)
            pd = record.get("per_device") or {}
            if pd.get("explored"):
                self._status["mesh_width"] = len(pd["explored"])
            if record.get("lanes") is not None:
                self._status["lanes"] = record["lanes"]
            if record.get("spill") is not None:
                # Spill mode's per-level drain wall split.
                self._status["drain"] = record["spill"]
            if record.get("faults") is not None:
                self._status["faults"] = record["faults"]
                for k, v in record["faults"].items():
                    self.registry.gauge(f"faults.{k}").set(int(v))
            self._status.update({
                "engine": engine,
                "depth": record.get("depth", 0),
                "explored": explored,
                "unique": record.get("unique", 0),
                "rate_per_min": round(explored / wall_total * 60.0, 1)
                if wall_total > 0 else None,
                "rate_per_min_window": round(win_d / win_w * 60.0, 1)
                if win_w > 0 else None,
                "level_wall": wall,
                "load_factor": record.get("load_factor"),
                "skew": skew,
                "per_device": record.get("per_device"),
            })
            self._write_status(force=True)
        if skew:
            work = skew.get("explored") or next(iter(skew.values()))
            if (not self._warned_skew
                    and len(record.get("per_device", {})
                            .get("explored", ())) > 1
                    and work.get("mean", 0.0) >= 64
                    and work.get("imbalance", 1.0) >= SKEW_WARN):
                self._warned_skew = True
                warnings.warn(
                    f"shard skew: slowest-device imbalance "
                    f"{work['imbalance']:.2f}x (cv {work['cv']:.2f}) at "
                    f"depth {record.get('depth')} on engine {engine} "
                    f"(>= {SKEW_WARN})", RuntimeWarning, stacklevel=3)

    # Outcome scalars given a gauge and the outcome record (host ints the
    # verdict carries).
    _OUTCOME_FIELDS = (
        "states_explored", "unique_states", "depth", "retries",
        "failovers", "resumed_from_depth", "visited_overflow",
        "dropped", "spilled_keys", "host_tier_hits",
        "respilled_frontier", "walker_restarts", "swarm_overflow",
        "child_restarts", "killed_dispatches", "abandoned_threads",
        "mesh_width", "mesh_shrinks", "knob_retries",
        "fault_events", "partition_events", "crash_events",
        "drop_events", "dup_events")

    def on_outcome(self, out, engine: Optional[str] = None) -> None:
        """One verdict: an ``outcome`` record, a gauge per nonzero
        counter, and the capacity (bytes per state, pack ratio, symmetry
        permutations) and fault blocks."""
        eng = engine or getattr(out, "engine", None) or "search"
        rec = {"t": "outcome", "ts": self._ts(), "engine": eng,
               "end_condition": out.end_condition,
               "elapsed_secs": round(float(out.elapsed_secs), 4),
               "compile_secs": round(float(out.compile_secs), 4)}
        trace = getattr(out, "trace_id", None) or self.trace_id
        if trace:
            rec["trace"] = trace
        with self._lock:
            for f in self._OUTCOME_FIELDS:
                v = int(getattr(out, f, 0) or 0)
                rec[f] = v
                if v:
                    self.registry.gauge(f"outcome.{f}").set(v)
            self.registry.gauge("outcome.compile_secs").set(
                rec["compile_secs"])
            bps = getattr(out, "bytes_per_state", None)
            if bps:
                cap_block = {
                    "bytes_per_state": int(bps),
                    "bytes_per_state_unpacked": int(
                        getattr(out, "bytes_per_state_unpacked", 0) or 0),
                    "pack_ratio": float(
                        getattr(out, "pack_ratio", 1.0) or 1.0),
                    "symmetry_perms": int(
                        getattr(out, "symmetry_perms", 0) or 0)}
                rec["capacity"] = cap_block
                self._status["capacity"] = cap_block
                self.registry.gauge("capacity.bytes_per_state").set(
                    cap_block["bytes_per_state"])
                self.registry.gauge("capacity.pack_ratio").set(
                    cap_block["pack_ratio"])
                if cap_block["symmetry_perms"]:
                    self.registry.gauge("capacity.symmetry_perms").set(
                        cap_block["symmetry_perms"])
            if int(getattr(out, "fault_events", 0) or 0):
                flt_block = {
                    k: int(getattr(out, k, 0) or 0)
                    for k in ("partition_events", "crash_events",
                              "drop_events", "dup_events",
                              "fault_events")}
                rec["faults"] = flt_block
                self._status["faults"] = flt_block
                for k, v in flt_block.items():
                    self.registry.gauge(f"faults.{k}").set(v)
            self._write(rec)
            self.events.append(rec)
            self._status["end_condition"] = out.end_condition
            self._write_status(force=True)

    # ------------------------------------------------------------ summary

    def summary(self) -> dict:
        """The compact JSON block a caller attaches to its output: span
        totals, per-site latency snapshots, event counts, the levels and
        the flight log's path."""
        with self._lock:
            sites = {name[len("dispatch_secs."):]: h.snapshot()
                     for name, h in self.registry.histograms.items()
                     if name.startswith("dispatch_secs.")}
            events = {name[len("events."):]: c.value
                      for name, c in self.registry.counters.items()
                      if name.startswith("events.")}
            out = {
                "spans": sum(self._counts.values()),
                "dispatches": dict(self._counts),
                "sites": sites,
                "events": events,
                "levels": len(self.levels),
                "flight_log": self.flight_log,
            }
            if self.status_path:
                out["status"] = self.status_path
            if self.flight_error:
                out["flight_error"] = self.flight_error
            sk = self._status.get("skew")
            if sk:
                out["skew"] = sk
            return out


# ------------------------------------------------------- flight reading

def read_flight(path: str) -> List[dict]:
    """Parse a flight log, tolerating one torn tail line (a SIGKILL
    mid-write).  A torn line anywhere else raises: the file is corrupt,
    not truncated."""
    records: List[dict] = []
    with open(path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except ValueError:
            if i == len(lines) - 1:
                break
            raise
    return records


def tail_records(path: Optional[str], n: int = 6,
                 kinds=("dispatch", "span", "event")) -> List[dict]:
    """The last ``n`` dispatch / span / event records of a flight log.
    Never raises: diagnostics must not mask the error they describe."""
    if not path:
        return []
    try:
        recs = [r for r in read_flight(path) if r.get("t") in kinds]
    except Exception:  # noqa: BLE001 - diagnostics never raise
        return []
    return recs[-n:]


# --------------------------------------------------------------- report

def _resolve_flight(path: str) -> str:
    """A flight log, or a run dir: its ``flight.jsonl``, else the newest
    ``*.jsonl`` inside it."""
    if os.path.isdir(path):
        cand = os.path.join(path, "flight.jsonl")
        if os.path.exists(cand):
            return cand
        logs = sorted(
            (os.path.join(path, f) for f in os.listdir(path)
             if f.endswith(".flight.jsonl") or f.endswith(".jsonl")),
            key=lambda p: os.path.getmtime(p))
        if logs:
            return logs[-1]
        raise FileNotFoundError(f"no flight log (*.jsonl) in {path}")
    return path


def build_report(records: List[dict]) -> dict:
    """A flight log's records -> the run-report structure (everything
    the renderer draws, from the log alone)."""
    spans = [r for r in records if r.get("t") == "span"]
    levels = [r for r in records if r.get("t") == "level"]
    events = [r for r in records if r.get("t") == "event"]
    outcomes = [r for r in records if r.get("t") == "outcome"]
    meta = next((r for r in records if r.get("t") == "meta"), None)

    sites: Dict[str, Histogram] = {}
    first_wall: Dict[str, float] = {}
    for s in spans:
        h = sites.setdefault(s["tag"], Histogram())
        h.observe(s.get("wall", 0.0))
        first_wall.setdefault(s["tag"], float(s.get("wall", 0.0)))
    total_wall = sum(float(s.get("wall", 0.0)) for s in spans)
    compile_wall = sum(first_wall.values())

    # Per-level throughput: explored is cumulative, so a level's rate is
    # its delta against the engine's previous record.
    series: Dict[str, List[dict]] = {}
    prev: Dict[str, int] = {}
    for lv in levels:
        eng = lv.get("engine", "?")
        d = int(lv.get("explored", 0)) - prev.get(eng, 0)
        prev[eng] = int(lv.get("explored", 0))
        wall = float(lv.get("wall", 0.0)) or 1e-9
        series.setdefault(eng, []).append(dict(lv, delta_explored=d,
                                               rate=round(d / wall, 1)))

    timeline = sorted(
        (events
         + [s for s in spans if s.get("retries")]
         + [s for s in spans if s.get("outcome") not in (None, "ok")]),
        key=lambda r: r.get("ts", 0.0))

    # A begin marker with no span: the process died or is wedged inside
    # that call.
    open_dispatch = None
    done = {(s["tag"], s["i"]) for s in spans}
    for r in records:
        if r.get("t") == "dispatch" and (r["tag"], r["i"]) not in done:
            open_dispatch = r
    counts = {}
    for o in outcomes:
        for k in ("spilled_keys", "host_tier_hits", "respilled_frontier",
                  "visited_overflow", "dropped", "retries", "failovers",
                  "walker_restarts", "swarm_overflow", "mesh_shrinks",
                  "knob_retries"):
            if o.get(k):
                counts[k] = counts.get(k, 0) + int(o[k])
    capacity = next((o["capacity"] for o in reversed(outcomes)
                     if o.get("capacity")), None)
    faults = next((o["faults"] for o in reversed(outcomes)
                   if o.get("faults")), None)
    drain = {}
    for lv in levels:
        sp = lv.get("spill")
        if isinstance(sp, dict):
            for k, v in sp.items():
                try:
                    drain[k] = round(drain.get(k, 0.0) + float(v), 4)
                except (TypeError, ValueError):
                    pass
    return {"meta": meta, "n_spans": len(spans),
            "sites": {t: h.snapshot() for t, h in sites.items()},
            "series": series, "timeline": timeline,
            "outcomes": outcomes, "counts": counts,
            "capacity": capacity, "faults": faults,
            "drain": drain or None,
            "total_wall": round(total_wall, 3),
            "compile_wall": round(compile_wall, 3),
            "in_flight": open_dispatch}


def render_report(report: dict, source: str = "") -> str:
    """The human-readable run report (its section headers are pinned by
    the tests)."""
    out: List[str] = []
    out.append(f"== dslabs run report: {source or 'flight log'} ==")
    meta = report.get("meta") or {}
    if meta:
        out.append(f"meta: pid {meta.get('pid')} hint={meta.get('hint')}")
    out.append(
        f"spans: {report['n_spans']} dispatches across "
        f"{len(report['sites'])} sites; dispatch wall "
        f"{report['total_wall']:.3f}s "
        f"(first-dispatch {report['compile_wall']:.3f}s, "
        f"steady {report['total_wall'] - report['compile_wall']:.3f}s)")

    out.append("")
    out.append("-- dispatch latency by site --")
    out.append(f"{'site':34s} {'n':>6s} {'p50ms':>9s} {'p90ms':>9s} "
               f"{'p99ms':>9s} {'maxms':>9s} {'total_s':>9s}")
    for tag in sorted(report["sites"]):
        s = report["sites"][tag]
        out.append(f"{tag:34s} {s['count']:6d} {s['p50']*1e3:9.2f} "
                   f"{s['p90']*1e3:9.2f} {s['p99']*1e3:9.2f} "
                   f"{s['max']*1e3:9.2f} {s['total']:9.3f}")

    out.append("")
    out.append("-- per-level throughput --")
    if not report["series"]:
        out.append("(no level records)")
    for eng in sorted(report["series"]):
        out.append(f"[engine {eng}]")
        out.append(f"{'depth':>6s} {'wall_s':>8s} {'explored':>10s} "
                   f"{'unique':>10s} {'next':>10s} {'states/s':>10s}")
        for lv in report["series"][eng]:
            out.append(
                f"{lv.get('depth', 0):6d} {lv.get('wall', 0.0):8.3f} "
                f"{lv.get('explored', 0):10d} "
                f"{lv.get('unique', 0):10d} "
                f"{lv.get('next_frontier', 0):10d} "
                f"{lv.get('rate', 0.0):10.1f}")

    # Per-device x per-level heatmap, for level records with per-device
    # lanes (one cell per device; rows start with 'd').
    heat_engines = [e for e in sorted(report["series"])
                    if any(lv.get("per_device")
                           for lv in report["series"][e])]
    if heat_engines:
        ramp = " .:-=+*#%@"
        out.append("")
        out.append("-- per-device skew (explored share per level) --")
        for eng in heat_engines:
            lvs = [lv for lv in report["series"][eng]
                   if lv.get("per_device")]
            n_dev = max(len(lv["per_device"].get("explored", ()))
                        for lv in lvs)
            out.append(f"[engine {eng}] devices 0..{n_dev - 1}; each cell "
                       "= device share of the level's expanded states")
            for lv in lvs:
                lane = lv["per_device"].get("explored", [])
                mx = max(max(lane, default=0), 1)
                cells = "".join(
                    ramp[min(len(ramp) - 1,
                             int(round(v / mx * (len(ramp) - 1))))]
                    for v in lane)
                sk = (lv.get("skew") or {}).get("explored", {})
                out.append(
                    f"d{lv.get('depth', 0):4d} |{cells}| "
                    f"imb={sk.get('imbalance', 1.0):5.2f} "
                    f"cv={sk.get('cv', 0.0):5.2f}")
            hbms = [lv for lv in lvs if lv.get("hbm_peak")]
            if hbms:
                peak = hbms[-1]["hbm_peak"]
                out.append("peak device bytes/device: "
                           + " ".join(f"{b:.2e}" for b in peak))

    out.append("")
    out.append("-- recovery timeline --")
    if not report["timeline"]:
        out.append("(no retries, failovers, or events)")
    for r in report["timeline"][-40:]:
        if r.get("t") == "event":
            extra = {k: v for k, v in r.items()
                     if k not in ("t", "ts", "kind")}
            out.append(f"+{r.get('ts', 0.0):8.2f}s event "
                       f"{r['kind']} {extra}")
        else:
            out.append(f"+{r.get('ts', 0.0):8.2f}s span {r['tag']} "
                       f"i={r['i']} retries={r.get('retries', 0)} "
                       f"outcome={r.get('outcome')}")

    out.append("")
    out.append("-- spill / overflow / recovery counts --")
    if report["counts"]:
        out.append(" ".join(f"{k}={v}"
                            for k, v in sorted(report["counts"].items())))
    else:
        out.append("(all zero)")
    if report.get("capacity"):
        out.append("capacity: " + " ".join(
            f"{k}={v}" for k, v in sorted(report["capacity"].items())))
    if report.get("faults"):
        out.append("faults: " + " ".join(
            f"{k}={v}" for k, v in sorted(report["faults"].items())))
    if report.get("drain"):
        out.append("drain overlap: " + " ".join(
            f"{k}={v}" for k, v in sorted(report["drain"].items())))
    for o in report["outcomes"]:
        out.append(
            f"outcome: {o.get('end_condition')} engine={o.get('engine')} "
            f"depth={o.get('depth')} unique={o.get('unique_states')} "
            f"explored={o.get('states_explored')} "
            f"elapsed={o.get('elapsed_secs')}s "
            f"compile={o.get('compile_secs')}s")

    if report["in_flight"] is not None:
        r = report["in_flight"]
        out.append("")
        out.append(f"!! in-flight at EOF: {r['tag']} i={r['i']} "
                   f"depth={r.get('depth')}: the run died or wedged "
                   "inside this dispatch")
    return "\n".join(out)


def render_sites(summary: dict) -> str:
    """The per-site latency table of a :meth:`Telemetry.summary` (the
    report's columns)."""
    out = [f"{'site':40s} {'n':>6s} {'p50ms':>9s} {'p90ms':>9s} "
           f"{'maxms':>9s} {'total_s':>9s}"]
    for tag in sorted(summary.get("sites", {})):
        s = summary["sites"][tag]
        out.append(f"{tag:40s} {s['count']:6d} {s['p50']*1e3:9.2f} "
                   f"{s['p90']*1e3:9.2f} {s['max']*1e3:9.2f} "
                   f"{s['total']:9.3f}")
    return "\n".join(out)


def _render_registry() -> str:
    """The dispatch-site registry (the ``sites`` command)."""
    cols = ("hot", "in_place", "multi", "program")
    out = [f"{'site':28s} " + " ".join(f"{c:>8s}" for c in cols)
           + f" {'syncs':>5s}"]
    for tag in sorted(DISPATCH_SITES):
        m = DISPATCH_SITES[tag]
        syncs = "cfg" if m["syncs"] is None else str(m["syncs"])
        out.append(f"{tag:28s} "
                   + " ".join(f"{'yes' if m[c] else 'no':>8s}"
                              for c in cols)
                   + f" {syncs:>5s}")
    out.append("(syncs cfg: by the engine's configuration, packed and "
               "spill; see DISPATCH_SITES)")
    return "\n".join(out)


# ----------------------------------------------------- live run monitor

def _resolve_status(path: str) -> Optional[str]:
    """STATUS.json of a run dir (``STATUS.json``, else the newest
    ``*STATUS.json``) or of a direct path."""
    if os.path.isdir(path):
        cand = os.path.join(path, "STATUS.json")
        if os.path.exists(cand):
            return cand
        stats = sorted(
            (os.path.join(path, f) for f in os.listdir(path)
             if f.endswith("STATUS.json")),
            key=lambda p: os.path.getmtime(p))
        return stats[-1] if stats else None
    return path if path.endswith(".json") else None


def load_status(path: Optional[str]) -> Optional[dict]:
    """Read a STATUS.json; never raises."""
    if not path:
        return None
    try:
        with open(path) as f:
            return json.loads(f.read())
    except (OSError, ValueError):
        return None


def watch_frame(path: str, now: Optional[float] = None) -> dict:
    """One machine-readable monitor frame (``watch --json``): the STATUS
    snapshot, its staleness (over 15 s), and the dispatch in flight from
    the flight log's last child segment.  Absent or torn files degrade
    each field to None."""
    from dslabs_tpu_torch.tpu import tracing as tracing_mod

    now = time.time() if now is None else now
    st = load_status(_resolve_status(path))
    age = (now - float(st.get("updated", now))) if st else None
    open_d = None
    try:
        recs, _ = tracing_mod.read_flight_lax(_resolve_flight(path))
    except (OSError, ValueError):
        recs = []
    segs = tracing_mod.segment_flight(recs)
    if segs:
        open_d = segs[-1]["in_flight"]
    return {
        "t": "watch", "source": path,
        "status": st,
        "age_secs": round(age, 1) if age is not None else None,
        "stale": bool(st) and age is not None and age > 15,
        "finished": bool(st and st.get("end_condition")),
        "in_flight": open_d,
        "trace_id": (st or {}).get("trace_id"),
    }


def render_watch(path: str, now: Optional[float] = None) -> str:
    """One frame of the live monitor, from the run dir alone: STATUS.json
    (depth, rates, skew, spill, rung) and the flight log's tail (the
    dispatch in flight, which names where a killed run died)."""
    now = time.time() if now is None else now
    out: List[str] = [f"== dslabs live monitor: {path} =="]
    st = load_status(_resolve_status(path))
    if st is None:
        out.append("(no STATUS.json yet: the run has no monitor, or died "
                   "before its first level)")
    else:
        age = now - float(st.get("updated", now))
        stale = " !! STALE (run dead or wedged?)" if age > 15 else ""
        out.append(f"status: pid {st.get('pid')} hint={st.get('hint')} "
                   f"updated {age:.1f}s ago{stale}")
        rate = st.get("rate_per_min")
        win = st.get("rate_per_min_window")
        out.append(
            f"engine {st.get('engine', '?')}  "
            f"depth {st.get('depth', 0)}  "
            f"unique {st.get('unique', 0)}  "
            f"explored {st.get('explored', 0)}  "
            f"rate {rate if rate is not None else '?'} states/min "
            f"(window {win if win is not None else '?'})")
        if st.get("trace_id"):
            out.append(f"trace: {st['trace_id']} "
                       f"(parent span {st.get('parent_span') or '-'})")
        if st.get("mesh_width"):
            out.append(f"mesh width: {st['mesh_width']} device(s)")
        if st.get("resilience"):
            out.append("resilience: " + " ".join(
                f"{k}={v}" for k, v in sorted(st["resilience"].items())))
        sk = st.get("skew") or {}
        if sk:
            parts = [f"{lane} imb={m.get('imbalance', 1.0):.2f} "
                     f"cv={m.get('cv', 0.0):.2f}"
                     for lane, m in sorted(sk.items())]
            out.append("skew: " + " | ".join(parts))
        if st.get("skew_agg"):
            out.append("skew agg: " + " ".join(
                f"{k}={v}" for k, v in sorted(st["skew_agg"].items())))
        pd = st.get("per_device") or {}
        if pd.get("frontier") is not None:
            out.append("per-device frontier: "
                       + " ".join(str(v) for v in pd["frontier"]))
        if st.get("load_factor") is not None:
            out.append(f"visited load factor: {st['load_factor']}")
        for block in ("spill", "drain", "capacity", "faults", "rung",
                      "lane"):
            if st.get(block):
                out.append(f"{block}: " + " ".join(
                    f"{k}={v}" for k, v in sorted(st[block].items())))
        # A lane-batch child (tpu/lanes.py): one line per resident lane.
        for lrec in st.get("lanes") or ():
            out.append(f"job lane {lrec.get('lane')}: "
                       f"{lrec.get('job_id')} depth {lrec.get('depth')} "
                       f"unique {lrec.get('unique')} "
                       f"explored {lrec.get('explored')} "
                       f"frontier {lrec.get('frontier')}")
        ls = st.get("last_span")
        if ls:
            out.append(f"last span: {ls.get('tag')} i={ls.get('i')} "
                       f"depth={ls.get('depth')} "
                       f"{ls.get('outcome')} {ls.get('wall', 0.0)}s")
        if st.get("end_condition"):
            out.append(f"end: {st['end_condition']}")
    # The flight log is the authority on an unclosed dispatch: STATUS may
    # predate a wedge, the begin marker cannot (it is written before the
    # call).  Each child of a warden run appends its own segment: the
    # last segment's open dispatch is live, an earlier one names where
    # that child died.
    from dslabs_tpu_torch.tpu import tracing as tracing_mod

    try:
        recs, _ = tracing_mod.read_flight_lax(_resolve_flight(path))
    except (OSError, ValueError):
        recs = []
    segs = tracing_mod.segment_flight(recs)
    for k, seg in enumerate(segs):
        d = seg["in_flight"]
        if d is None:
            continue
        where = f"{d['tag']} i={d['i']} depth={d.get('depth')}"
        if k == len(segs) - 1:
            out.append(f"!! in-flight: {where}: the run is inside (or "
                       "died inside) this dispatch")
        else:
            out.append(f"!! in-flight at a child's death: {where} "
                       f"(child {k + 1} of {len(segs)}; a later child "
                       "took over)")
    return "\n".join(out)


# ---------------------------------------------------- cross-run ledger

def append_ledger(path: str, record: dict) -> Optional[str]:
    """Append one run's record to a JSONL ledger.  Never raises; returns
    the path, or None on failure."""
    try:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(record) + "\n")
        return path
    except (OSError, ValueError, TypeError):
        return None


def read_ledger(path: str) -> List[dict]:
    """A ledger, with the flight log's torn-tail tolerance."""
    return read_flight(path)


# The phases a ledger compare diffs ("headline" is the record's top-level
# ``value``).
_LEDGER_PHASES = ("headline", "mesh", "strict", "beam", "swarm",
                  "spill", "capacity2", "service", "lanes", "memo",
                  "scenarios", "labs", "cpu_fallback")
# Degradations a run needed to land its number: more than any prior run
# is a regression at any rate.
_RESILIENCE_COUNTERS = ("mesh_shrinks", "knob_retries", "failovers")
# Static-check findings of the ``sanitizer`` block: any rise regresses.
_SANITIZER_COUNTERS = ("findings", "conformance", "jaxpr")


def _num(v, lo: Optional[float] = None,
         strict_lo: Optional[float] = None) -> Optional[float]:
    """``float(v)`` if it is a number within the bound, else None."""
    try:
        v = float(v)
    except (TypeError, ValueError):
        return None
    if lo is not None and v < lo:
        return None
    if strict_lo is not None and v <= strict_lo:
        return None
    return v


def _block(rec: dict, name: str) -> dict:
    b = rec.get(name)
    return b if isinstance(b, dict) else {}


def _phase_value(rec: dict, phase: str) -> Optional[float]:
    v = rec.get("value") if phase == "headline" else \
        _block(rec, phase).get("value")
    return _num(v, strict_lo=0)


def _counter_value(rec: dict, counter: str) -> Optional[int]:
    v = rec.get(counter)
    if v is None:
        return None
    try:
        return int(v)
    except (TypeError, ValueError):
        return None


def _sanitizer_value(rec: dict, counter: str) -> Optional[int]:
    s = _block(rec, "sanitizer")
    if counter not in s:
        return None
    try:
        return int(s[counter])
    except (TypeError, ValueError):
        return None


def _pct(lv: float, best: float) -> float:
    return round((lv - best) / best * 100, 1) if best > 0 else 0.0


def compare_ledger(records: List[dict],
                   threshold: Optional[float] = None) -> dict:
    """Diff the latest run of a ledger against the best prior run per
    phase.  ``threshold`` is the tolerated fractional slowdown (default
    :data:`BENCH_REGRESS_PCT`).  Beside the rates: the headline's mesh
    width, resilience and sanitizer counters, the service's fairness and
    cost per unique state, per-phase compile seconds, lane amortisation,
    bytes per state, memo hit rate, the mesh's wire bytes and imbalance,
    scenario verdict parity and the generated labs' bytes per state."""
    if threshold is None:
        threshold = BENCH_REGRESS_PCT
    runs = [r for r in records if isinstance(r, dict)
            and ("value" in r or r.get("t") == "bench")]
    cmp = {"runs": len(runs), "threshold_pct": round(threshold * 100, 1),
           "phases": {}, "regressions": [], "improvements": []}
    if len(runs) < 2:
        cmp["note"] = "need >= 2 runs to compare"
        return cmp
    latest, prior = runs[-1], runs[:-1]
    for phase in _LEDGER_PHASES:
        lv = _phase_value(latest, phase)
        priors = [v for v in (_phase_value(r, phase) for r in prior)
                  if v is not None]
        if lv is None or not priors:
            continue
        best = max(priors)
        delta = (lv - best) / best
        entry = {"phase": phase, "latest": round(lv, 1),
                 "best_prior": round(best, 1),
                 "delta_pct": round(delta * 100, 1)}
        cmp["phases"][phase] = entry
        if delta < -threshold:
            cmp["regressions"].append(entry)
        elif delta > threshold:
            cmp["improvements"].append(entry)

    # The headline compares only at equal or greater mesh width.
    cmp["mesh_width"] = {}

    def _width(rec) -> Optional[int]:
        try:
            w = int(rec.get("mesh_width"))
        except (TypeError, ValueError):
            return None
        return w if w > 0 else None

    lw = _width(latest)
    priors_w = [w for w in (_width(r) for r in prior) if w is not None]
    if lw is not None and priors_w:
        best_w = max(priors_w)
        entry = {"phase": "headline:mesh_width", "latest": lw,
                 "best_prior": best_w,
                 "delta_pct": round((lw - best_w) / best_w * 100, 1)}
        cmp["mesh_width"]["mesh_width"] = entry
        if lw < best_w:
            cmp["regressions"].append(entry)

    cmp["resilience"] = {}
    for counter in _RESILIENCE_COUNTERS:
        lv = _counter_value(latest, counter)
        if lv is None:
            continue
        priors = [v for v in (_counter_value(r, counter) for r in prior)
                  if v is not None]
        worst = max(priors) if priors else 0
        entry = {"phase": f"resilience:{counter}", "latest": lv,
                 "best_prior": worst, "delta_pct": 0.0}
        cmp["resilience"][counter] = entry
        if lv > worst:
            cmp["regressions"].append(entry)

    cmp["sanitizer"] = {}
    for counter in _SANITIZER_COUNTERS:
        lv = _sanitizer_value(latest, counter)
        if lv is None:
            continue
        priors = [v for v in (_sanitizer_value(r, counter)
                              for r in prior) if v is not None]
        if not priors:
            continue
        best = min(priors)
        entry = {"phase": f"sanitizer:{counter}", "latest": lv,
                 "best_prior": best, "delta_pct": 0.0}
        cmp["sanitizer"][counter] = entry
        if lv > best:
            cmp["regressions"].append(entry)

    def guard(section, name, phase, get, lower_is_better, digits,
              floor_check=None):
        """One scalar guard: latest against the best prior (lowest or
        highest); a move past the threshold the wrong way regresses."""
        lv = get(latest)
        priors = [v for v in (get(r) for r in prior) if v is not None]
        if lv is None or not priors:
            return
        best = min(priors) if lower_is_better else max(priors)
        entry = {"phase": phase,
                 "latest": lv if digits is None else round(lv, digits),
                 "best_prior": best if digits is None
                 else round(best, digits),
                 "delta_pct": _pct(lv, best)}
        cmp[section][name] = entry
        bad = (floor_check(lv, best) if floor_check is not None
               else (lv > best * (1.0 + threshold) if lower_is_better
                     else lv < best * (1.0 - threshold)))
        if bad:
            cmp["regressions"].append(entry)

    cmp["fairness"] = {}
    guard("fairness", "fairness_index", "service:fairness_index",
          lambda r: _num(_block(r, "service").get("fairness_index"),
                         strict_lo=0), True, 4)

    # Compile-time creep per phase; sub-floor moves are noise.
    cmp["compile"] = {}
    for phase in _LEDGER_PHASES:
        guard("compile", phase, f"compile:{phase}",
              lambda r, p=phase: _num(_block(r, p).get("compile_secs"),
                                      lo=0), True, 1,
              floor_check=lambda lv, best: (
                  lv > max(best, COMPILE_REGRESS_FLOOR) * (1.0 + threshold)
                  and lv - best > COMPILE_REGRESS_FLOOR))

    cmp["cost"] = {}
    guard("cost", "cost_per_unique", "service:cost_per_unique",
          lambda r: _num(_block(r, "service").get("cost_per_unique"),
                         strict_lo=0), True, None)

    def _dpj(rec):
        for block in ("lanes", "service"):
            v = _num(_block(rec, block).get("dispatches_per_job"),
                     strict_lo=0)
            if v is not None:
                return v
        return None

    cmp["lanes"] = {}
    guard("lanes", "dispatches_per_job", "service:dispatches_per_job",
          _dpj, True, 2)
    guard("lanes", "occupancy", "lanes:occupancy",
          lambda r: _num(_block(r, "lanes").get("occupancy"),
                         strict_lo=0), False, 3)

    cmp["capacity"] = {}
    guard("capacity", "bytes_per_state", "capacity:bytes_per_state",
          lambda r: _num(_block(r, "capacity2").get("bytes_per_state"),
                         strict_lo=0), True, 1)

    cmp["memo"] = {}
    guard("memo", "hit_rate", "memo:hit_rate",
          lambda r: _num(_block(r, "memo").get("hit_rate"), lo=0),
          False, 3)

    def _saved(rec):
        for block in ("memo", "service"):
            v = _num(_block(rec, block).get("device_secs_saved"), lo=0)
            if v is not None:
                return v
        return None

    lv = _saved(latest)
    priors_s = [v for v in (_saved(r) for r in prior) if v is not None]
    if lv is not None and priors_s:
        best = max(priors_s)
        cmp["memo"]["device_secs_saved"] = {
            "phase": "service:device_secs_saved",
            "latest": round(lv, 3), "best_prior": round(best, 3),
            "delta_pct": _pct(lv, best)}

    cmp["mesh"] = {}
    guard("mesh", "wire_bytes_per_state", "mesh:wire_bytes_per_state",
          lambda r: _num(_block(_block(r, "mesh"), "wire")
                         .get("wire_bytes_per_state"), strict_lo=0),
          True, 1)
    guard("mesh", "imbalance_max", "mesh:imbalance_max",
          lambda r: _num(_block(r, "mesh").get("imbalance_max"), lo=1.0),
          True, 2)

    # Scenario verdict parity is binary: 0 is a soundness break.
    cmp["scenarios"] = {}

    def _parity(rec):
        s = _block(rec, "scenarios")
        if "verdict_parity" not in s:
            return None
        try:
            return int(s["verdict_parity"])
        except (TypeError, ValueError):
            return None

    lv = _parity(latest)
    priors_p = [v for v in (_parity(r) for r in prior) if v is not None]
    if lv is not None:
        best = max(priors_p) if priors_p else 1
        entry = {"phase": "scenarios:verdict_parity", "latest": lv,
                 "best_prior": best, "delta_pct": 0.0}
        cmp["scenarios"]["verdict_parity"] = entry
        if lv < 1:
            cmp["regressions"].append(entry)

    cmp["labs"] = {}
    guard("labs", "bytes_per_state", "labs:bytes_per_state",
          lambda r: _num(_block(r, "labs").get("bytes_per_state"),
                         strict_lo=0), True, 1)
    return cmp


def render_compare(cmp: dict, source: str = "") -> str:
    out = [f"== bench ledger compare: {source or 'ledger'} "
           f"({cmp['runs']} runs, threshold "
           f"{cmp['threshold_pct']:.0f}%) =="]
    if cmp.get("note"):
        out.append(cmp["note"])
        return "\n".join(out)
    out.append(f"{'phase':14s} {'latest':>12s} {'best_prior':>12s} "
               f"{'delta':>8s}")
    for phase in _LEDGER_PHASES:
        e = cmp["phases"].get(phase)
        if e is None:
            continue
        out.append(f"{phase:14s} {e['latest']:12.1f} "
                   f"{e['best_prior']:12.1f} {e['delta_pct']:+7.1f}%")
    for c, e in sorted(cmp.get("mesh_width", {}).items()):
        out.append(f"headline {c:16s} latest={e['latest']} "
                   f"prior_widest={e['best_prior']}")
    for c, e in sorted(cmp.get("resilience", {}).items()):
        out.append(f"resilience {c:14s} latest={e['latest']} "
                   f"prior_worst={e['best_prior']}")
    for c, e in sorted(cmp.get("sanitizer", {}).items()):
        out.append(f"sanitizer {c:15s} latest={e['latest']} "
                   f"prior_best={e['best_prior']}")
    for section in ("fairness", "compile", "cost", "lanes", "capacity",
                    "memo", "mesh"):
        for c, e in sorted(cmp.get(section, {}).items()):
            unit = "s" if section == "compile" else ""
            out.append(f"{section} {c:{max(1, 24 - len(section))}s} "
                       f"latest={e['latest']}{unit} "
                       f"prior_best={e['best_prior']}{unit} "
                       f"({e['delta_pct']:+.1f}%)")
    for c, e in sorted(cmp.get("scenarios", {}).items()):
        out.append(f"scenarios {c:15s} latest={e['latest']} "
                   f"prior_best={e['best_prior']}")
    for c, e in sorted(cmp.get("labs", {}).items()):
        out.append(f"labs {c:20s} latest={e['latest']} "
                   f"prior_best={e['best_prior']} "
                   f"({e['delta_pct']:+.1f}%)")
    for e in cmp["regressions"]:
        out.append(f"REGRESSION: phase={e['phase']} "
                   f"latest={e['latest']} vs best={e['best_prior']} "
                   f"({e['delta_pct']:+.1f}%)")
    for e in cmp["improvements"]:
        out.append(f"improvement: phase={e['phase']} "
                   f"({e['delta_pct']:+.1f}%)")
    if not cmp["regressions"]:
        out.append("parity: no phase regressed past the threshold")
    return "\n".join(out)


# ------------------------------------------------------------------ CLI

_USAGE = """usage: python -m dslabs_tpu_torch.tpu.telemetry <command> ...

  report  <run-dir-or-flight-log> [--json]   render a run report
  watch   <run-dir> [--interval S] [--once] [--json]
                                             live monitor of any run
  sites                                      the dispatch-site registry
  trace   <run-dir> [--json] [--perfetto F]  assemble the causal trace
  compare <ledger.jsonl> [--threshold F]     diff latest vs best prior
"""


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["sites"]:
        print(_render_registry())
        return 0
    if len(argv) < 2 or argv[0] not in ("report", "watch", "compare",
                                        "trace"):
        print(_USAGE, file=sys.stderr)
        return 2
    cmd, path = argv[0], argv[1]
    flags = argv[2:]

    if cmd == "trace":
        from dslabs_tpu_torch.tpu import tracing as tracing_mod

        return tracing_mod.main([path] + flags)

    if cmd == "report":
        flight = _resolve_flight(path)
        report = build_report(read_flight(flight))
        if "--json" in flags:
            print(json.dumps(dict(report, source=flight)))
        else:
            print(render_report(report, source=flight))
        return 0

    if cmd == "compare":
        threshold = None
        if "--threshold" in flags:
            threshold = float(flags[flags.index("--threshold") + 1])
        cmp = compare_ledger(read_ledger(path), threshold)
        print(render_compare(cmp, source=path))
        return 1 if cmp["regressions"] else 0

    # watch: redraw until interrupted; --once draws one frame, --json
    # prints one machine-readable frame.
    if "--json" in flags:
        print(json.dumps(watch_frame(path)))
        return 0
    interval = 2.0
    if "--interval" in flags:
        interval = float(flags[flags.index("--interval") + 1])
    once = "--once" in flags
    try:
        while True:
            frame = render_watch(path)
            if not once:
                print("\x1b[2J\x1b[H", end="")
            print(frame, flush=True)
            if once:
                return 0
            time.sleep(interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
