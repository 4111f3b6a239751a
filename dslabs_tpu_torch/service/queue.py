"""Bounded persistent job queue for the checking service.

Counterpart of ``dslabs_tpu/service/queue.py``.  The service's front door: jobs are (protocol factory spec, budget,
tenant id) records in a **JSONL journal** beside the service run dir —
the same crash-safety discipline as the rest of the repo's durable
artifacts:

* **Appends are line-buffered** (one ``write`` per record, like the
  telemetry flight recorder), so a SIGKILL mid-append leaves at most
  ONE torn tail line;
* **Replay tolerates the torn tail** exactly the way the
  flight-recorder reader does (the port's ``telemetry.read_flight``): the final
  unparsable line is the expected crash shape, a torn line anywhere
  else is corruption and raises;
* **Compaction is tmp + ``os.replace``** (the checkpoint-style atomic
  rewrite, tpu/checkpoint.py): a kill mid-compact leaves the previous
  complete journal.

Backpressure is **structured, never exceptional**: ``submit`` on a full
queue returns ``{"accepted": False, "rejected": True,
"retry_after_secs": …, "queue_depth": …}`` — it never raises and never
blocks (the caller is a tenant-facing front end; an exception or a
stall there IS the outage).  Replay re-queues jobs that were marked
``start``\\ ed but never finished, so a crashed server resumes its
backlog — each such job also resumes its own run-dir checkpoint, the
per-job fault domain the server builds (service/server.py).

Deliberate difference from the reference: its ``DSLABS_SERVICE_QUEUE_CAP``
and ``DSLABS_SERVICE_RETRY_AFTER`` are the constants :data:`QUEUE_CAP`
and :data:`RETRY_AFTER` and the constructor's arguments.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

__all__ = ["Job", "ServiceQueue", "JOURNAL_NAME", "QUEUE_CAP",
           "RETRY_AFTER", "replay_journal"]

JOURNAL_NAME = "journal.jsonl"

# The reference's environment defaults, as constants: the queue's bound
# and the retry-after hint's scale (seconds per queued job ahead).
QUEUE_CAP = 64
RETRY_AFTER = 2.0


@dataclasses.dataclass
class Job:
    """One tenant submission: everything a warden child needs to
    rebuild and run the search, plus the scheduler's accounting.  The
    protocol crosses the process boundary as a ``"module:callable"``
    factory spec of the port (tpu/warden.py), for example
    ``dslabs_tpu_torch.tpu.protocols.pingpong:make_exhaustive_pingpong``;
    live objects never enter the journal."""

    job_id: str
    tenant: str
    factory: str
    factory_kwargs: Optional[dict] = None
    transform: Optional[str] = None
    strict: bool = True
    max_depth: Optional[int] = None
    max_secs: Optional[float] = None
    # DRR cost / billing unit: the fairness ledger charges this many
    # quanta when the job is picked (scheduler.py).
    budget_units: float = 1.0
    chunk: int = 1 << 10
    frontier_cap: int = 1 << 14
    visited_cap: int = 1 << 20
    ladder: Tuple[str, ...] = ("device", "host")
    # Deterministic warden-side fault injection (tests/chaos only) —
    # applied on the FIRST scheduler attempt, so a retry models the
    # environment condition clearing.
    fault: Optional[dict] = None
    # Batched-lane opt-out (tpu/lanes.py): set when a
    # poisoned lane evicts the job to a solo retry — the lane packer
    # (lanes.job_signature) reads it as "never batch this again".
    solo: bool = False
    submitted_at: float = 0.0
    # Causal-trace identity (tpu/tracing.py): minted at
    # submit, persisted by the journal, stamped on every journal event
    # and warden child env — the one key the trace assembler joins the
    # journal, SERVER_STATUS, and the per-job flight logs on.
    trace_id: Optional[str] = None

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ladder"] = list(self.ladder)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Job":
        kw = {f.name: d[f.name] for f in dataclasses.fields(cls)
              if f.name in d}
        kw["ladder"] = tuple(kw.get("ladder") or ("device", "host"))
        return cls(**kw)


def replay_journal(path: str) -> Tuple[List[Job], Dict[str, dict], int]:
    """Rebuild queue state from the journal, tolerating one torn tail
    line (the flight-recorder contract — telemetry.read_flight does
    the parsing).  Returns ``(pending_jobs, records, max_seq)``:
    jobs submitted but never finished (``start``\\ ed-but-unfinished
    ones re-queue — the crash-recovery path), the per-job record map,
    and the highest job sequence number seen (so new ids never
    collide)."""
    from dslabs_tpu_torch.tpu.telemetry import read_flight

    records: Dict[str, dict] = {}
    max_seq = 0
    if not os.path.exists(path):
        return [], {}, 0
    for rec in read_flight(path):
        t = rec.get("t")
        jid = rec.get("job_id")
        if t == "submit" and isinstance(rec.get("job"), dict):
            job = rec["job"]
            jid = job.get("job_id")
            records[jid] = {"job": job, "status": "pending",
                            "tenant": job.get("tenant")}
            try:
                max_seq = max(max_seq, int(jid.rsplit("-", 1)[-1]))
            except (ValueError, AttributeError):
                pass
        elif jid in records:
            if t == "start":
                records[jid]["status"] = "running"
                records[jid]["attempt"] = rec.get("attempt")
            elif t == "done":
                records[jid]["status"] = "done"
                records[jid]["verdict"] = rec.get("verdict")
            elif t == "failed":
                records[jid]["status"] = "failed"
                records[jid]["failure"] = rec.get("failure")
    pending = [Job.from_dict(r["job"]) for r in records.values()
               if r["status"] in ("pending", "running")]
    for r in records.values():
        if r["status"] == "running":       # crash-interrupted: re-queue
            r["status"] = "pending"
    pending.sort(key=lambda j: (j.submitted_at, j.job_id))
    return pending, records, max_seq


class ServiceQueue:
    """The bounded persistent queue.  All mutation goes through the
    journal first (write-ahead), then memory; every public method is
    thread-safe and non-blocking."""

    def __init__(self, root: str, cap: Optional[int] = None,
                 retry_after_base: Optional[float] = None):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.cap = cap if cap is not None else QUEUE_CAP
        # Backpressure hint scale: retry_after_secs grows linearly with
        # the depth of the queue the rejected tenant is waiting behind.
        self.retry_after_base = (retry_after_base
                                 if retry_after_base is not None
                                 else RETRY_AFTER)
        self.journal_path = os.path.join(self.root, JOURNAL_NAME)
        self._lock = threading.Lock()
        pending, self.records, self._seq = replay_journal(
            self.journal_path)
        self.pending: "deque[Job]" = deque(pending)
        self.journal_error: Optional[str] = None
        self._fh = None
        self._open_journal()

    # ------------------------------------------------------------ journal

    def _open_journal(self) -> None:
        try:
            self._fh = open(self.journal_path, "a", buffering=1)
        except OSError as e:
            # A read-only root degrades to RAM-only queueing (the
            # telemetry convention): the service keeps serving, the
            # durability loss is attributable on journal_error.
            self.journal_error = f"{type(e).__name__}: {e}"
            self._fh = None

    def _append(self, rec: dict) -> None:
        if self._fh is None:
            return
        # Every journal event is timestamped: the trace
        # assembler derives queue-wait / attempt / verdict boundaries
        # from these, so the causal timeline exists on disk alone.
        rec.setdefault("ts", round(time.time(), 3))
        try:
            self._fh.write(json.dumps(rec) + "\n")
        except (OSError, ValueError) as e:
            self.journal_error = f"{type(e).__name__}: {e}"
            self._fh = None

    def log_event(self, kind: str, **fields) -> None:
        """Append one free-form operational event to the journal (the
        admission gate's timing, retention prunes, …) — replay ignores
        unknown kinds, the trace assembler reads them."""
        with self._lock:
            self._append({"t": kind, **fields})

    def compact(self) -> None:
        """Rewrite the journal to the live state only (dropping the
        event history of finished jobs) via tmp + ``os.replace`` — the
        checkpoint-style atomic rewrite; a kill mid-compact leaves the
        previous complete journal."""
        with self._lock:
            lines = []
            for jid in sorted(self.records):
                r = self.records[jid]
                lines.append(json.dumps({"t": "submit", "job": r["job"]}))
                if r["status"] == "done":
                    lines.append(json.dumps(
                        {"t": "done", "job_id": jid,
                         "verdict": r.get("verdict")}))
                elif r["status"] == "failed":
                    lines.append(json.dumps(
                        {"t": "failed", "job_id": jid,
                         "failure": r.get("failure")}))
            tmp = self.journal_path + ".tmp"
            try:
                if self._fh is not None:
                    self._fh.close()
                with open(tmp, "w") as f:
                    f.write("".join(line + "\n" for line in lines))
                os.replace(tmp, self.journal_path)
            except OSError as e:
                self.journal_error = f"{type(e).__name__}: {e}"
            finally:
                self._open_journal()

    # ------------------------------------------------------------- submit

    def depth(self) -> int:
        with self._lock:
            return len(self.pending)

    def next_id(self, tenant: str) -> str:
        with self._lock:
            self._seq += 1
            return f"{tenant}-{self._seq:06d}"

    def submit(self, job: Job) -> dict:
        """Enqueue one job.  On a FULL queue this returns the
        structured retry-after rejection — it never raises and never
        blocks."""
        with self._lock:
            depth = len(self.pending)
            if depth >= self.cap:
                return {
                    "accepted": False,
                    "rejected": True,
                    "reason": "queue_full",
                    "retry_after_secs": round(
                        self.retry_after_base * max(1, depth), 1),
                    "queue_depth": depth,
                    "queue_cap": self.cap,
                }
            if not job.submitted_at:
                job.submitted_at = round(time.time(), 3)
            self._append({"t": "submit", "job": job.as_dict()})
            self.records[job.job_id] = {"job": job.as_dict(),
                                        "status": "pending",
                                        "tenant": job.tenant}
            self.pending.append(job)
            return {"accepted": True, "job_id": job.job_id,
                    "queue_depth": len(self.pending)}

    def _drop_pending(self, job_id: str) -> None:
        for j in list(self.pending):
            if j.job_id == job_id:
                self.pending.remove(j)
                break

    def pop(self, job_id: str) -> None:
        """Remove a job from the pending deque (the scheduler owns WHICH
        job runs next; the queue only owns durability)."""
        with self._lock:
            self._drop_pending(job_id)

    # ------------------------------------------------------- state marks
    # Every mark also dequeues (idempotent with pop): a started or
    # finished job is by definition no longer queued, so depth() stays
    # honest for callers that drive the queue without a scheduler.

    def mark_started(self, job_id: str, attempt: int) -> None:
        with self._lock:
            self._drop_pending(job_id)
            self._append({"t": "start", "job_id": job_id,
                          "attempt": attempt})
            if job_id in self.records:
                self.records[job_id]["status"] = "running"
                self.records[job_id]["attempt"] = attempt

    def mark_done(self, job_id: str, verdict: dict) -> None:
        with self._lock:
            self._drop_pending(job_id)
            self._append({"t": "done", "job_id": job_id,
                          "verdict": verdict})
            if job_id in self.records:
                self.records[job_id]["status"] = "done"
                self.records[job_id]["verdict"] = verdict

    def mark_failed(self, job_id: str, failure: dict) -> None:
        with self._lock:
            self._drop_pending(job_id)
            self._append({"t": "failed", "job_id": job_id,
                          "failure": failure})
            if job_id in self.records:
                self.records[job_id]["status"] = "failed"
                self.records[job_id]["failure"] = failure

    def mark_rejected(self, tenant: str, reason: str,
                      detail: Optional[dict] = None) -> None:
        """Admission / backpressure rejections are journal events too —
        SERVER_STATUS.json's per-tenant ``rejected`` counter survives a
        restart."""
        with self._lock:
            self._append({"t": "rejected", "tenant": tenant,
                          "reason": reason, "detail": detail})

    # ------------------------------------------------------------ summary

    def summary(self) -> dict:
        with self._lock:
            by_status: Dict[str, int] = {}
            for r in self.records.values():
                by_status[r["status"]] = by_status.get(r["status"], 0) + 1
            return {
                "queue_depth": len(self.pending),
                "queue_cap": self.cap,
                "backpressure": len(self.pending) >= self.cap,
                "jobs": by_status,
                "journal": self.journal_path,
                "journal_error": self.journal_error,
            }

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
