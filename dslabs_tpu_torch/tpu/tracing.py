"""Causal tracing and cost accounting, from the artifacts a run leaves.

The port's own copy of ``dslabs_tpu/tpu/tracing.py`` (stdlib only; the
telemetry module is imported lazily, as the lower layer).  Two halves:

* **Trace and span ids.**  :func:`mint_trace_id` names a trace,
  :func:`new_span_id` one recorder (one process's run).  The trace
  crosses process boundaries through one environment pair,
  ``DSLABS_TRACE_ID`` / ``DSLABS_PARENT_SPAN`` (:data:`TRACE_ENV`,
  :data:`PARENT_ENV`): the warden (``tpu/warden.py``) sets it on every
  child it spawns, and the telemetry recorder (``tpu/telemetry.py``)
  reads it at construction, so every flight-recorder record and
  STATUS.json of a child carries the trace.  A begin marker is written
  before each dispatch, so the chain survives a SIGKILL: a child killed
  mid-level leaves its in-flight dispatch attributable from disk alone.

* **The assembler** (:func:`assemble`, CLI ``python -m
  dslabs_tpu_torch.tpu.telemetry trace <run-dir>``): stitches a run
  dir's flight log, one segment per child that appended to it, into one
  causal tree (run -> compile / levels / recovery events / outcome, and
  the in-flight dispatch of a torn tail), rendered as a timeline
  (:func:`render_trace`) or exported as Chrome/Perfetto trace-event JSON
  (:func:`to_perfetto`).  :class:`CostMeter` turns a finished job's
  verdict and flight log into an append-only ``COSTS.jsonl`` record:
  device seconds by site, dispatch counts, the compile / search split,
  retries, all read from files that already exist.

A service root (a directory with ``journal.jsonl``, ``service/``) is
assembled through the service's journal replay: one tree per job, and a
lane job's tree carries its batch's shared spans, marked ``shared``; a
job the memo answered or seeded carries a ``memo`` node.
"""

from __future__ import annotations

import binascii
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["TRACE_ENV", "PARENT_ENV", "COSTS_NAME", "mint_trace_id",
           "new_span_id", "current_trace", "child_trace_env",
           "attempt_span_id", "read_flight_lax", "segment_flight",
           "load_json_tolerant", "CostMeter", "aggregate_costs",
           "assemble", "render_trace", "to_perfetto", "main"]

# The propagation contract, shared with the reference: the warden sets
# both on every child, and a Telemetry reads them at construction.
TRACE_ENV = "DSLABS_TRACE_ID"
PARENT_ENV = "DSLABS_PARENT_SPAN"

# The append-only cost ledger's file name (also the run-dir layout's
# ``costs`` entry, tpu/checkpoint.py).
COSTS_NAME = "COSTS.jsonl"


def mint_trace_id() -> str:
    """A fresh 16-hex-digit trace id (random, host-side)."""
    return binascii.hexlify(os.urandom(8)).decode()


def new_span_id() -> str:
    """A fresh 8-hex-digit span id (one per recorder)."""
    return binascii.hexlify(os.urandom(4)).decode()


def current_trace(env: Optional[dict] = None) -> Tuple[Optional[str],
                                                       Optional[str]]:
    """The (trace_id, parent_span) this process inherited through its
    environment, or (None, None) outside any trace."""
    e = os.environ if env is None else env
    return (e.get(TRACE_ENV) or None, e.get(PARENT_ENV) or None)


def child_trace_env(trace_id: Optional[str],
                    parent_span: Optional[str]) -> dict:
    """The environment additions that thread a trace into a child."""
    env = {}
    if trace_id:
        env[TRACE_ENV] = trace_id
    if parent_span:
        env[PARENT_ENV] = parent_span
    return env


def attempt_span_id(job_id: str, attempt: int) -> str:
    """The deterministic span id of one scheduler attempt of a job,
    derivable from the job id alone."""
    return f"{job_id}:a{int(attempt)}"


# ------------------------------------------------------ tolerant readers

def read_flight_lax(path: str) -> Tuple[List[dict], int]:
    """Parse a JSONL artifact, skipping unparsable lines instead of
    raising on a torn line mid-file.  A run dir's flight log is appended
    to by every child of a warden run, so a SIGKILLed child can leave a
    torn line with its successor's records after it.  Returns
    ``(records, n_torn)``; a missing file is ``([], 0)``."""
    records: List[dict] = []
    torn = 0
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return [], 0
    for line in lines:
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except ValueError:
            torn += 1
    return records, torn


def load_json_tolerant(path: Optional[str]) -> Optional[dict]:
    """Read one JSON object file, tolerating a half-written snapshot.
    Never raises: None means no usable snapshot."""
    if not path:
        return None
    try:
        with open(path) as f:
            data = f.read()
    except OSError:
        return None
    try:
        out = json.loads(data)
    except ValueError:
        return None
    return out if isinstance(out, dict) else None


def segment_flight(records: List[dict]) -> List[dict]:
    """Split a flight log into child segments at its ``meta`` records
    (each recorder writes one when it is built).  Dispatch indices
    restart in every child, so a begin marker is matched to its span
    within its segment only; each segment carries its own in-flight
    dispatch (a begin marker with no span: the child died or is wedged
    inside that call)."""
    segments: List[dict] = []
    cur: Optional[dict] = None
    for rec in records:
        if rec.get("t") == "meta":
            cur = {"meta": rec, "records": []}
            segments.append(cur)
            continue
        if cur is None:
            cur = {"meta": {}, "records": []}
            segments.append(cur)
        cur["records"].append(rec)
    for seg in segments:
        spans = [r for r in seg["records"] if r.get("t") == "span"]
        done = {(s.get("tag"), s.get("i")) for s in spans}
        open_d = None
        for r in seg["records"]:
            if (r.get("t") == "dispatch"
                    and (r.get("tag"), r.get("i")) not in done):
                open_d = r
        seg["spans"] = spans
        seg["in_flight"] = open_d
    return segments


# ------------------------------------------------------------ cost meter

def _blank_tenant() -> dict:
    return {"jobs": 0, "completed": 0, "failed": 0, "explored": 0,
            "unique": 0, "device_secs": 0.0, "dispatches": 0,
            "compile_secs": 0.0, "search_secs": 0.0, "retries": 0,
            "failovers": 0, "budget_spent": 0.0,
            "cost_per_unique": None, "dispatches_per_job": None}


class CostMeter:
    """A per-tenant cost ledger.  :meth:`charge` turns one finished job
    (its verdict dict and its run dir's flight log) into an append-only
    ``COSTS.jsonl`` record and the in-memory aggregate, reading only what
    exists already.  A meter built on an existing ledger replays it, so
    totals survive a restart.  Thread-safe; the append is line-buffered,
    so a SIGKILL leaves at most one torn tail line, which the reader
    skips."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._fh = None
        self.error: Optional[str] = None
        self.records: List[dict] = []
        if path and os.path.exists(path):
            recs, _ = read_flight_lax(path)
            self.records = [r for r in recs if r.get("t") == "cost"]
        if path:
            try:
                d = os.path.dirname(os.path.abspath(path))
                os.makedirs(d, exist_ok=True)
                self._fh = open(path, "a", buffering=1)
            except OSError as e:
                # An unwritable root: RAM-only accounting, the reason kept.
                self.error = f"{type(e).__name__}: {e}"
                self._fh = None

    @staticmethod
    def flight_costs(flight_log: Optional[str]) -> dict:
        """Device-time accounting of one flight log: span seconds by
        site, dispatches, absorbed retries, and the compile / search
        split (the outcome records' ``compile_secs`` plus the first span
        at each site in each child segment, which pays the kernels'
        first launches)."""
        out = {"device_secs": 0.0, "device_secs_by_site": {},
               "dispatches": 0, "retries": 0, "aot_compile_secs": 0.0,
               "first_dispatch_secs": 0.0, "compile_secs": 0.0,
               "search_secs": 0.0, "levels": 0, "torn_lines": 0}
        if not flight_log:
            return out
        records, torn = read_flight_lax(flight_log)
        out["torn_lines"] = torn
        for seg in segment_flight(records):
            first_seen = set()
            for r in seg["records"]:
                t = r.get("t")
                if t == "span":
                    wall = float(r.get("wall", 0.0) or 0.0)
                    tag = r.get("tag", "?")
                    out["device_secs"] += wall
                    out["device_secs_by_site"][tag] = round(
                        out["device_secs_by_site"].get(tag, 0.0) + wall, 6)
                    out["dispatches"] += 1
                    out["retries"] += int(r.get("retries", 0) or 0)
                    if tag not in first_seen:
                        first_seen.add(tag)
                        out["first_dispatch_secs"] += wall
                elif t == "level":
                    out["levels"] += 1
                elif t == "outcome":
                    out["aot_compile_secs"] += float(
                        r.get("compile_secs", 0.0) or 0.0)
        out["device_secs"] = round(out["device_secs"], 6)
        out["first_dispatch_secs"] = round(out["first_dispatch_secs"], 6)
        out["aot_compile_secs"] = round(out["aot_compile_secs"], 6)
        out["compile_secs"] = round(
            out["aot_compile_secs"] + out["first_dispatch_secs"], 6)
        out["search_secs"] = round(
            max(0.0, out["device_secs"] - out["first_dispatch_secs"]), 6)
        return out

    def charge(self, verdict: dict,
               flight_log: Optional[str] = None) -> dict:
        """Account one finished job: ``verdict`` is the job's result dict
        (done or failed); explored / unique / depth are copied from it
        exactly.  A ``lane_share`` in the verdict scales the device-time
        numbers, so a dispatch shared by several jobs is billed once."""
        fc = self.flight_costs(flight_log)
        share = verdict.get("lane_share")
        if share is not None:
            share = max(0.0, min(1.0, float(share)))
            for k in ("device_secs", "compile_secs", "search_secs",
                      "first_dispatch_secs", "aot_compile_secs"):
                fc[k] = round(fc[k] * share, 6)
            fc["dispatches"] = round(fc["dispatches"] * share, 3)
            fc["device_secs_by_site"] = {
                t: round(v * share, 6)
                for t, v in fc["device_secs_by_site"].items()}
        rec = {
            "t": "cost", "ts": round(time.time(), 3),
            "job_id": verdict.get("job_id"),
            "tenant": verdict.get("tenant"),
            "trace_id": verdict.get("trace_id"),
            "status": verdict.get("status"),
            "end": verdict.get("end"),
            "explored": int(verdict.get("explored", 0) or 0),
            "unique": int(verdict.get("unique", 0) or 0),
            "depth": int(verdict.get("depth", 0) or 0),
            "attempts": int(verdict.get("attempts", 1) or 1),
            "failovers": len(verdict.get("deaths") or ()),
            "budget_units": float(verdict.get("budget_units", 0.0) or 0.0),
            "elapsed_secs": float(verdict.get("elapsed_secs", 0.0) or 0.0),
            **{k: fc[k] for k in (
                "device_secs", "device_secs_by_site", "dispatches",
                "retries", "compile_secs", "search_secs", "levels")},
        }
        if share is not None:
            rec["lane_share"] = share
            rec["lanes"] = verdict.get("lanes")
        rec["cost_per_unique"] = (
            round(rec["device_secs"] / rec["unique"], 9)
            if rec["unique"] > 0 else None)
        with self._lock:
            self.records.append(rec)
            if self._fh is not None:
                try:
                    self._fh.write(json.dumps(rec) + "\n")
                except (OSError, ValueError) as e:
                    self.error = f"{type(e).__name__}: {e}"
                    self._fh = None
        return rec

    def tenant_summary(self) -> Dict[str, dict]:
        """Per-tenant totals of the ledger (:func:`aggregate_costs`)."""
        with self._lock:
            records = list(self.records)
        return aggregate_costs(records)

    def totals(self) -> dict:
        """Cross-tenant totals and the headline ``cost_per_unique``."""
        per = self.tenant_summary()
        out = _blank_tenant()
        for s in per.values():
            for k in out:
                if k in ("cost_per_unique", "dispatches_per_job"):
                    continue
                out[k] = out[k] + s[k]
        out["cost_per_unique"] = (
            round(out["device_secs"] / out["unique"], 9)
            if out["unique"] > 0 else None)
        out["dispatches_per_job"] = (
            round(out["dispatches"] / out["jobs"], 3)
            if out["jobs"] > 0 else None)
        for k in ("device_secs", "compile_secs", "search_secs",
                  "budget_spent"):
            out[k] = round(out[k], 6)
        return out

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


def aggregate_costs(records: List[dict]) -> Dict[str, dict]:
    """Fold cost records (a ``COSTS.jsonl`` read back with
    :func:`read_flight_lax`) into per-tenant totals."""
    out: Dict[str, dict] = {}
    for r in records:
        if r.get("t") != "cost":
            continue
        s = out.setdefault(str(r.get("tenant")), _blank_tenant())
        s["jobs"] += 1
        s["completed"] += 1 if r.get("status") == "done" else 0
        s["failed"] += 1 if r.get("status") != "done" else 0
        s["explored"] += int(r.get("explored", 0) or 0)
        s["unique"] += int(r.get("unique", 0) or 0)
        s["device_secs"] = round(
            s["device_secs"] + float(r.get("device_secs", 0.0) or 0.0), 6)
        s["dispatches"] = round(
            s["dispatches"] + float(r.get("dispatches", 0) or 0), 3)
        s["compile_secs"] = round(
            s["compile_secs"] + float(r.get("compile_secs", 0.0) or 0.0), 6)
        s["search_secs"] = round(
            s["search_secs"] + float(r.get("search_secs", 0.0) or 0.0), 6)
        s["retries"] += int(r.get("retries", 0) or 0)
        s["failovers"] += int(r.get("failovers", 0) or 0)
        s["budget_spent"] = round(
            s["budget_spent"] + float(r.get("budget_units", 0.0) or 0.0), 6)
    for s in out.values():
        s["cost_per_unique"] = (
            round(s["device_secs"] / s["unique"], 9)
            if s["unique"] > 0 else None)
        s["dispatches_per_job"] = (
            round(s["dispatches"] / s["jobs"], 3)
            if s["jobs"] > 0 else None)
    return out


# ------------------------------------------------------------- assembler

def _is_server_dir(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, "journal.jsonl"))


def _abs_ts(meta: dict, rel: float) -> Optional[float]:
    started = meta.get("started")
    if started is None:
        return None
    return float(started) + float(rel or 0.0)


def _segment_nodes(seg: dict, parent: str, prefix: str, nodes: List[dict],
                   known: Optional[set] = None) -> dict:
    """One child segment -> trace nodes (the run, its compile, levels,
    recovery events, outcome, and the in-flight dispatch).  Returns the
    segment's {compile_secs, search_secs}.  The child's announced
    ``parent_span`` is used only when it names a node of this tree
    (``known``); otherwise the run hangs off ``parent``, so no chain
    dangles."""
    meta = seg["meta"]
    run_id = meta.get("span_id") or f"{prefix}:run"
    run_parent = meta.get("parent_span")
    if not run_parent or (known is not None and run_parent not in known):
        run_parent = parent
    recs = seg["records"]
    t1 = None
    if recs:
        t1 = _abs_ts(meta, max(float(r.get("ts", 0.0) or 0.0)
                               for r in recs))
    nodes.append({"span_id": run_id, "parent": run_parent, "kind": "run",
                  "name": meta.get("hint") or "run", "pid": meta.get("pid"),
                  "t0": meta.get("started"), "t1": t1,
                  "trace_id": meta.get("trace_id")})
    compile_secs = 0.0
    search_secs = 0.0
    first_seen = set()
    n_level = 0
    for r in recs:
        t = r.get("t")
        ts = _abs_ts(meta, r.get("ts", 0.0))
        if t == "span":
            tag = r.get("tag", "?")
            if tag not in first_seen:
                # The first dispatch at a tag pays the kernels' first
                # launches: the report's compile attribution rule.
                first_seen.add(tag)
                compile_secs += float(r.get("wall", 0.0) or 0.0)
        elif t == "level":
            n_level += 1
            wall = float(r.get("wall", 0.0) or 0.0)
            search_secs += wall
            nodes.append({
                "span_id": f"{run_id}:d{r.get('depth', n_level)}:{n_level}",
                "parent": run_id, "kind": "level",
                "name": f"level d{r.get('depth', '?')}",
                "t0": (ts - wall) if ts is not None else None,
                "t1": ts, "wall": wall, "engine": r.get("engine"),
                "explored": r.get("explored"), "unique": r.get("unique")})
        elif t == "event":
            kind = r.get("kind")
            if kind == "compile":
                secs = float(r.get("secs", 0.0) or 0.0)
                compile_secs += secs
                nodes.append({
                    "span_id": f"{run_id}:compile:{len(nodes)}",
                    "parent": run_id, "kind": "compile",
                    "name": "warm-up",
                    "t0": (ts - secs) if ts is not None else None,
                    "t1": ts, "wall": r.get("secs"),
                    "engine": r.get("engine")})
            elif kind in ("rung", "knobs_shrunk", "capacity_retry",
                          "failover", "retry", "wedged"):
                nodes.append({
                    "span_id": f"{run_id}:{kind}:{len(nodes)}",
                    "parent": run_id, "kind": "event", "name": kind,
                    "t0": ts, "t1": ts,
                    "detail": {k: v for k, v in r.items()
                               if k not in ("t", "ts", "kind", "trace")}})
        elif t == "outcome":
            nodes.append({
                "span_id": f"{run_id}:outcome:{len(nodes)}",
                "parent": run_id, "kind": "outcome",
                "name": r.get("end_condition"), "t0": ts, "t1": ts,
                "engine": r.get("engine"),
                "explored": r.get("states_explored"),
                "unique": r.get("unique_states"),
                "compile_secs": r.get("compile_secs")})
    if seg["in_flight"] is not None:
        r = seg["in_flight"]
        ts = _abs_ts(meta, r.get("ts", 0.0))
        nodes.append({
            "span_id": f"{run_id}:inflight", "parent": run_id,
            "kind": "in_flight", "name": f"{r.get('tag')} i={r.get('i')}",
            "t0": ts, "t1": None, "tag": r.get("tag"), "i": r.get("i"),
            "depth": r.get("depth")})
    return {"compile_secs": compile_secs, "search_secs": search_secs}


def _assemble_job(root: str, rec: dict, journal: List[dict]) -> dict:
    """One journal job record + its run dir -> the causal tree."""
    job = rec["job"]
    job_id = job.get("job_id")
    trace_id = job.get("trace_id")
    submitted = float(job.get("submitted_at") or 0.0) or None
    starts = [r for r in journal
              if r.get("t") == "start" and r.get("job_id") == job_id]
    finish = next((r for r in journal
                   if r.get("t") in ("done", "failed")
                   and r.get("job_id") == job_id), None)
    admission = next((r for r in journal
                      if r.get("t") == "admission"
                      and trace_id
                      and r.get("trace_id") == trace_id), None)
    nodes: List[dict] = [{
        "span_id": trace_id or job_id, "parent": None,
        "kind": "submit", "name": f"submit {job_id}",
        "tenant": job.get("tenant"), "t0": submitted,
        "t1": submitted}]
    root_id = nodes[0]["span_id"]
    first_start = (float(starts[0]["ts"])
                   if starts and starts[0].get("ts") is not None
                   else None)
    queue_wait = (first_start - submitted
                  if first_start is not None and submitted is not None
                  else None)
    nodes.append({"span_id": f"{job_id}:queue", "parent": root_id,
                  "kind": "queue", "name": "queue-wait",
                  "t0": submitted, "t1": first_start,
                  "wall": queue_wait})
    adm_secs = 0.0
    if admission is not None:
        adm_secs = float(admission.get("secs", 0.0) or 0.0)
        adm_ts = admission.get("ts")
        nodes.append({
            "span_id": f"{job_id}:admission", "parent": root_id,
            "kind": "admission", "name": "admission",
            "t0": (float(adm_ts) - adm_secs)
            if adm_ts is not None else None,
            "t1": float(adm_ts) if adm_ts is not None else None,
            "wall": adm_secs,
            "skipped": bool(admission.get("skipped")),
            "cached": bool(admission.get("cached")),
            "findings": admission.get("findings", 0)})
    # Cross-job memoization (service/memo.py): a memo_hit ends the tree
    # here (no attempts, no flight log); a warm or incremental seed is a
    # zero-width note of why attempt 1 starts deep.
    memo = next(
        (r for r in journal if r.get("t") in ("memo_hit", "memo")
         and r.get("mode") != "introspect_failed"
         and (r.get("job_id") == job_id
              or (trace_id and r.get("trace_id") == trace_id))), None)
    if memo is not None:
        m_ts = memo.get("ts")
        hit = memo.get("t") == "memo_hit"
        nodes.append({
            "span_id": f"{job_id}:memo", "parent": root_id,
            "kind": "memo",
            "name": "memo-hit" if hit else f"memo-{memo.get('mode')}",
            "t0": float(m_ts) if m_ts is not None else None,
            "t1": float(m_ts) if m_ts is not None else None,
            "mode": "hit" if hit else memo.get("mode"),
            "sig": memo.get("sig"),
            "seed_depth": memo.get("seed_depth"),
            "levels_skipped": memo.get("levels_skipped"),
            "device_secs_saved": memo.get("device_secs_saved")})
    # Attempt spans: one per journal `start`; its id is DERIVED
    # (attempt_span_id) so the child meta's parent_span links back.
    attempt_ids = {}
    for k, s in enumerate(starts):
        att = int(s.get("attempt", k + 1) or (k + 1))
        aid = attempt_span_id(job_id, att)
        attempt_ids[aid] = True
        t0 = float(s["ts"]) if s.get("ts") is not None else None
        if k + 1 < len(starts):
            t1 = (float(starts[k + 1]["ts"])
                  if starts[k + 1].get("ts") is not None else None)
        else:
            t1 = (float(finish["ts"])
                  if finish is not None and finish.get("ts") is not None
                  else None)
        nodes.append({"span_id": aid, "parent": root_id,
                      "kind": "attempt", "name": f"attempt {att}",
                      "attempt": att, "t0": t0, "t1": t1})
    # The run dir's flight log, segmented per child.
    flight = os.path.join(root, "jobs", job_id or "", "flight.jsonl")
    records, torn = read_flight_lax(flight)
    compile_secs = 0.0
    search_secs = 0.0
    in_flight = None
    known = set(attempt_ids) | {root_id}
    for si, seg in enumerate(segment_flight(records)):
        parent = next(iter(attempt_ids), root_id)
        ph = _segment_nodes(seg, parent, f"{job_id}:s{si}", nodes,
                            known=known)
        compile_secs += ph["compile_secs"]
        search_secs += ph["search_secs"]
        if seg["in_flight"] is not None:
            in_flight = dict(seg["in_flight"],
                             segment=si,
                             hint=seg["meta"].get("hint"))
    # Lane-batch attribution (tpu/lanes.py): a job that ran
    # in a batched lane has no flight log of its own — the journal's
    # ``lane_batch`` events name the resident jobs and the batch run
    # dir, and the batch's SHARED flight log is attributed to every
    # resident job's causal tree (marked shared, so a reader knows the
    # spans were amortised across lanes, not exclusive).
    for ev in journal:
        if ev.get("t") != "lane_batch" or not ev.get("run_dir"):
            continue
        if job_id not in (ev.get("jobs") or []):
            continue
        bid = ev.get("batch") or os.path.basename(ev["run_dir"])
        brecords, btorn = read_flight_lax(
            os.path.join(ev["run_dir"], "flight.jsonl"))
        torn += btorn
        parent = next(iter(attempt_ids), root_id)
        lane_root = f"{job_id}:lane:{bid}"
        nodes.append({"span_id": lane_root, "parent": parent,
                      "kind": "lane_batch",
                      "name": f"lane batch {bid} (shared)",
                      "shared": True,
                      "lanes": len(ev.get("jobs") or ()),
                      "t0": ev.get("ts"), "t1": None})
        known.add(lane_root)
        for si, seg in enumerate(segment_flight(brecords)):
            ph = _segment_nodes(seg, lane_root, f"{job_id}:lb{si}",
                                nodes, known=known)
            compile_secs += ph["compile_secs"]
            search_secs += ph["search_secs"]
            if seg["in_flight"] is not None and in_flight is None:
                in_flight = dict(seg["in_flight"], segment=si,
                                 hint=seg["meta"].get("hint"),
                                 shared=True)
    status = rec.get("status")
    verdict = rec.get("verdict") or rec.get("failure")
    total = None
    if finish is not None and finish.get("ts") is not None \
            and submitted is not None:
        total = float(finish["ts"]) - submitted
    return {
        "job_id": job_id, "tenant": job.get("tenant"),
        "trace_id": trace_id, "status": status,
        "submitted_at": submitted,
        "attempts": len(starts),
        "phases": {
            "queue_wait_secs": round(queue_wait, 3)
            if queue_wait is not None else None,
            "admission_secs": round(adm_secs, 3),
            "compile_secs": round(compile_secs, 3),
            "search_secs": round(search_secs, 3),
            "total_secs": round(total, 3) if total is not None else None,
        },
        "nodes": nodes, "in_flight": in_flight, "verdict": verdict,
        "torn_lines": torn, "flight_log": flight
        if os.path.exists(flight) else None,
    }


def assemble(path: str, job: Optional[str] = None) -> dict:
    """Stitch the causal trace from disk alone.  ``path`` is a service
    root (a directory holding ``journal.jsonl``: every job becomes one
    tree, submit -> queue-wait -> admission -> attempts -> the child runs
    of its run dir and the shared spans of its lane batch; ``job`` keeps
    one) or a plain run dir or flight log (one tree rooted at the trace
    id, one ``run`` node per child segment of the flight log, with its
    levels, recovery events, outcome and in-flight dispatch).  Every
    reader is torn-tolerant: a mid-write SERVER_STATUS, a torn COSTS or
    journal tail and torn flight lines are expected crash shapes."""
    from dslabs_tpu_torch.tpu import telemetry as tel_mod

    if _is_server_dir(path):
        from dslabs_tpu_torch.service.queue import replay_journal

        journal, _ = read_flight_lax(os.path.join(path, "journal.jsonl"))
        submits = [r for r in journal
                   if r.get("t") == "submit"
                   and isinstance(r.get("job"), dict)]
        try:
            _, records, _ = replay_journal(
                os.path.join(path, "journal.jsonl"))
        except ValueError:
            records = {}
        jobs = []
        for rec in submits:
            jid = rec["job"].get("job_id")
            if job is not None and jid != job:
                continue
            merged = dict(records.get(jid, {}), job=rec["job"])
            jobs.append(_assemble_job(path, merged, journal))
        server = load_json_tolerant(
            os.path.join(path, "SERVER_STATUS.json"))
        costs_recs, _ = read_flight_lax(os.path.join(path, COSTS_NAME))
        return {"source": path, "mode": "service", "jobs": jobs,
                "server": server, "costs": aggregate_costs(costs_recs)}
    flight = tel_mod._resolve_flight(path)
    records, torn = read_flight_lax(flight)
    nodes: List[dict] = []
    meta0 = next((r for r in records if r.get("t") == "meta"), {})
    trace_id = meta0.get("trace_id")
    root_id = trace_id or meta0.get("span_id") or "run"
    nodes.append({"span_id": root_id, "parent": None, "kind": "submit",
                  "name": os.path.basename(flight),
                  "t0": meta0.get("started"), "t1": None})
    compile_secs = search_secs = 0.0
    in_flight = None
    for si, seg in enumerate(segment_flight(records)):
        ph = _segment_nodes(seg, root_id, f"run:s{si}", nodes,
                            known={root_id})
        compile_secs += ph["compile_secs"]
        search_secs += ph["search_secs"]
        if seg["in_flight"] is not None:
            in_flight = dict(seg["in_flight"], segment=si,
                             hint=seg["meta"].get("hint"))
    jobd = {"job_id": os.path.basename(os.path.dirname(flight)) or flight,
            "tenant": None, "trace_id": trace_id, "status": None,
            "submitted_at": meta0.get("started"), "attempts": 1,
            "phases": {"queue_wait_secs": None, "admission_secs": 0.0,
                       "compile_secs": round(compile_secs, 3),
                       "search_secs": round(search_secs, 3),
                       "total_secs": None},
            "nodes": nodes, "in_flight": in_flight, "verdict": None,
            "torn_lines": torn, "flight_log": flight}
    return {"source": path, "mode": "run", "jobs": [jobd],
            "server": None, "costs": {}}


# -------------------------------------------------------------- renderer

def _fmt_t(t0, base) -> str:
    if t0 is None or base is None:
        return "      ? "
    return f"+{t0 - base:7.3f}s"


def render_trace(tr: dict) -> str:
    """The human timeline: per job, the phase split, then the causal
    tree (runs indented under their parent, levels summarised on the run
    line, recovery events, outcomes, the in-flight dispatch of a torn
    tail)."""
    out: List[str] = [f"== dslabs causal trace: {tr.get('source')} =="]
    if not tr.get("jobs"):
        out.append("(no jobs found)")
        return "\n".join(out)
    for j in tr["jobs"]:
        base = j.get("submitted_at")
        out.append("")
        out.append(f"trace {j.get('trace_id') or '?'} "
                   f"job {j.get('job_id')} "
                   f"tenant {j.get('tenant') or '-'} "
                   f"status {j.get('status') or '?'}")
        ph = j["phases"]

        def _p(v):
            return "?" if v is None else f"{v:.3f}s"

        out.append(f"  phases: queue {_p(ph['queue_wait_secs'])} | "
                   f"admission {_p(ph['admission_secs'])} | "
                   f"compile {_p(ph['compile_secs'])} | "
                   f"search {_p(ph['search_secs'])} | "
                   f"total {_p(ph['total_secs'])}")
        if j.get("torn_lines"):
            out.append(f"  (flight log: {j['torn_lines']} torn line(s) "
                       "skipped: a SIGKILLed writer)")
        by_parent: Dict[Optional[str], List[dict]] = {}
        for n in j["nodes"]:
            by_parent.setdefault(n.get("parent"), []).append(n)

        def walk(span_id: str, indent: int) -> None:
            for n in by_parent.get(span_id, ()):
                pad = "  " * indent
                kind = n["kind"]
                if kind == "level":
                    continue
                line = (f"  {_fmt_t(n.get('t0'), base)} {pad}"
                        f"{kind}: {n.get('name')}")
                if kind == "run":
                    levels = [c for c in by_parent.get(n["span_id"], ())
                              if c["kind"] == "level"]
                    if levels:
                        walls = sum(float(c.get("wall", 0.0) or 0.0)
                                    for c in levels)
                        line += (f" [{len(levels)} level(s), "
                                 f"{walls:.3f}s search]")
                if kind == "in_flight":
                    line = (f"  {_fmt_t(n.get('t0'), base)} {pad}"
                            f"!! in-flight: {n.get('name')} "
                            f"depth={n.get('depth')}: the child died or "
                            "wedged inside this dispatch")
                if kind == "outcome":
                    line += (f" unique={n.get('unique')} "
                             f"explored={n.get('explored')}")
                if kind == "event" and n.get("detail"):
                    line += f" {n['detail']}"
                if kind == "admission":
                    if n.get("skipped"):
                        line += " (skipped)"
                    elif n.get("cached"):
                        line += " (cached)"
                if kind == "memo":
                    if n.get("mode") == "hit":
                        saved = n.get("device_secs_saved")
                        line += (f" sig={n.get('sig')} "
                                 f"saved~{saved}s" if saved is not None
                                 else f" sig={n.get('sig')}")
                    else:
                        line += (f" seed_depth={n.get('seed_depth')} "
                                 f"levels_skipped="
                                 f"{n.get('levels_skipped')}")
                out.append(line)
                walk(n["span_id"], indent + 1)

        for r in (n for n in j["nodes"] if n.get("parent") is None):
            out.append(f"  {_fmt_t(r.get('t0'), base)} "
                       f"{r['kind']}: {r.get('name')}")
            walk(r["span_id"], 1)
        if j.get("verdict"):
            v = j["verdict"]
            out.append("  verdict: " + " ".join(
                f"{k}={v[k]}" for k in ("end", "unique", "explored",
                                        "depth", "kind") if k in v))
    costs = tr.get("costs") or {}
    if costs:
        out.append("")
        out.append("-- per-tenant cost ledger --")
        out.append(f"{'tenant':12s} {'jobs':>5s} {'unique':>9s} "
                   f"{'explored':>9s} {'dev_s':>8s} {'disp':>6s} "
                   f"{'compile_s':>9s} {'retries':>7s} "
                   f"{'cost/unique':>12s}")
        for t in sorted(costs):
            c = costs[t]
            cpu = c.get("cost_per_unique")
            out.append(
                f"{t:12s} {c['jobs']:5d} {c['unique']:9d} "
                f"{c['explored']:9d} {c['device_secs']:8.3f} "
                f"{c['dispatches']:6.1f} {c['compile_secs']:9.3f} "
                f"{c['retries']:7d} "
                f"{cpu if cpu is not None else '-':>12}")
    return "\n".join(out)


# ------------------------------------------------------- perfetto export

def to_perfetto(tr: dict) -> dict:
    """Chrome/Perfetto trace-event JSON: every node becomes a complete
    ``X`` event on its job's track (``pid`` = job index, ``tid`` = tree
    depth, microseconds of wall-clock time); an in-flight dispatch
    becomes an instant ``i`` event at the kill point."""
    events: List[dict] = []
    for pi, j in enumerate(tr.get("jobs", ())):
        events.append({"ph": "M", "pid": pi, "name": "process_name",
                       "args": {"name": f"{j.get('tenant') or 'run'}/"
                                        f"{j.get('job_id')}"}})
        depth_of: Dict[str, int] = {}
        for n in j["nodes"]:
            parent = n.get("parent")
            depth_of[n["span_id"]] = (depth_of.get(parent, -1) + 1
                                      if parent else 0)
            t0, t1 = n.get("t0"), n.get("t1")
            if t0 is None:
                continue
            args = {k: v for k, v in n.items()
                    if k not in ("span_id", "parent", "t0", "t1")
                    and v is not None}
            if n["kind"] == "in_flight":
                events.append({"ph": "i", "s": "p", "pid": pi,
                               "tid": depth_of[n["span_id"]],
                               "name": f"in-flight {n.get('name')}",
                               "ts": int(t0 * 1e6), "cat": "trace",
                               "args": args})
                continue
            dur = max(0.0, (t1 - t0)) if t1 is not None else 0.0
            events.append({"ph": "X", "pid": pi,
                           "tid": depth_of[n["span_id"]],
                           "name": f"{n['kind']}:{n.get('name')}",
                           "ts": int(t0 * 1e6),
                           "dur": max(1, int(dur * 1e6)),
                           "cat": "trace", "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ------------------------------------------------------------------- CLI

_USAGE = """usage: python -m dslabs_tpu_torch.tpu.telemetry trace \
<run-dir> [--json] [--perfetto out.json]
"""


def main(argv: List[str]) -> int:
    """The ``telemetry trace`` subcommand (telemetry.main delegates
    here)."""
    import sys

    if not argv:
        print(_USAGE, file=sys.stderr)
        return 2
    path = argv[0]
    flags = argv[1:]
    job = None
    if "--job" in flags:
        job = flags[flags.index("--job") + 1]
    tr = assemble(path, job=job)
    if "--perfetto" in flags:
        out_path = flags[flags.index("--perfetto") + 1]
        with open(out_path, "w") as f:
            json.dump(to_perfetto(tr), f)
        print(f"perfetto trace written: {out_path}", file=sys.stderr)
    if "--json" in flags:
        print(json.dumps(tr))
    else:
        print(render_trace(tr))
    return 0
