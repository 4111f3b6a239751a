"""Fairness-preserving job scheduler for the checking service.

Counterpart of ``dslabs_tpu/service/scheduler.py``.  Three policies compose here, and all three are DETERMINISTIC given the
submission order (the soak's isolation proof depends on that):

* **Per-tenant concurrency quotas.**  A tenant never holds more than
  ``quota`` workers at once, no matter how deep its backlog — one
  tenant's thousand submissions cannot monopolise the mesh.
* **Deficit round-robin (DRR).**  Each eligible tenant accrues
  ``quantum`` credit per rotation; a job runs when its tenant's
  deficit covers its ``budget_units`` cost.  Tenants submitting many
  small jobs and tenants submitting few large ones converge to the
  same budget share — the classic fair-queueing argument, applied to
  search budgets instead of packet bytes.
* **Bounded retry-with-backoff, degraded by failure kind.**  Attempt
  outcomes are classified by the UNIFIED child-death taxonomy
  (supervisor.classify_child_death — the same vocabulary the warden
  and the in-process ladder use), and each kind buys a different, always
  strictly-lighter next attempt:

  - ``oom``    -> a knob-shrink re-level: halve the chunk (the
    supervisor's ``classify_oom`` answer, applied at job granularity);
  - ``wedge``  -> a kill + rung-step: drop the burned first rung and
    resume the remaining ladder from the job's checkpoint;
  - ``crash``  -> a plain backoff retry (the environment is suspect,
    the config is not);
  - ``failed`` -> NO retry: the child reported a classified in-child
    failure — retrying a deterministic failure buys nothing, the job
    lands a structured failure verdict instead.

``fairness_index`` is the ledger metric: max over tenants of
verdicts-per-budget divided by the mean (1.0 = perfectly fair; the
ledger compare flags a rise past the threshold — telemetry.py).

Deliberate difference from the reference: its
``DSLABS_SERVICE_MAX_ATTEMPTS`` is :class:`RetrySpec`'s
``max_attempts`` default, and ``RetrySpec.from_env`` is not ported.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

from dslabs_tpu_torch.service.queue import Job

__all__ = ["RetrySpec", "AttemptPlan", "DeficitRoundRobin",
           "degrade", "fairness_index"]


@dataclasses.dataclass(frozen=True)
class RetrySpec:
    """Per-job retry budget + backoff."""

    max_attempts: int = 3
    backoff_base: float = 0.05
    backoff_factor: float = 2.0
    backoff_max: float = 2.0

    def backoff(self, attempt: int) -> float:
        return min(self.backoff_base * (self.backoff_factor ** attempt),
                   self.backoff_max)


@dataclasses.dataclass
class AttemptPlan:
    """What the NEXT warden launch for a job looks like after the
    degradation policy has been applied."""

    attempt: int
    chunk: int
    ladder: Tuple[str, ...]
    knob_shrinks: int = 0
    rung_steps: int = 0

    def span_id(self, job_id: str) -> str:
        """This attempt's causal-trace span id — the
        DETERMINISTIC derivation shared with the trace assembler
        (tpu/tracing.py ``attempt_span_id``): the warden passes it to
        children as ``DSLABS_PARENT_SPAN`` and the assembler rebuilds
        it from the journal's ``start`` record alone, so the two link
        without any extra journal field."""
        from dslabs_tpu_torch.tpu.tracing import attempt_span_id

        return attempt_span_id(job_id, self.attempt)


def degrade(plan: AttemptPlan, kind: str,
            retry: RetrySpec) -> Optional[AttemptPlan]:
    """Map a classified death kind to the next attempt plan, or None
    when the job must land a structured failure instead (retry budget
    exhausted, or a reported deterministic failure).  Every retry is
    strictly lighter than the attempt it replaces — the service never
    re-runs a failing config unchanged."""
    if kind == "failed" or plan.attempt >= retry.max_attempts:
        return None
    if kind == "oom":
        return AttemptPlan(plan.attempt + 1, max(1, plan.chunk // 2),
                           plan.ladder, plan.knob_shrinks + 1,
                           plan.rung_steps)
    if kind == "wedge":
        ladder = plan.ladder[1:] if len(plan.ladder) > 1 else ("host",)
        return AttemptPlan(plan.attempt + 1, plan.chunk, ladder,
                           plan.knob_shrinks, plan.rung_steps + 1)
    # crash (and anything unrecognised): plain bounded retry.
    return AttemptPlan(plan.attempt + 1, plan.chunk, plan.ladder,
                       plan.knob_shrinks, plan.rung_steps)


class DeficitRoundRobin:
    """The DRR pick loop.  ``push`` keeps per-tenant FIFOs in tenant
    arrival order; ``pick`` returns the next runnable job honoring the
    concurrency quotas, or None when nothing is eligible right now
    (quota-blocked or empty)."""

    def __init__(self, quantum: float = 1.0, quota: int = 1,
                 quotas: Optional[Dict[str, int]] = None):
        self.quantum = float(quantum)
        self.default_quota = max(1, int(quota))
        self.quotas = dict(quotas or {})
        self._queues: Dict[str, "deque[Job]"] = {}
        self._deficit: Dict[str, float] = {}
        self._order: List[str] = []      # tenant rotation, arrival order
        self._rr = 0

    def quota_for(self, tenant: str) -> int:
        return int(self.quotas.get(tenant, self.default_quota))

    def push(self, job: Job) -> None:
        q = self._queues.get(job.tenant)
        if q is None:
            q = self._queues[job.tenant] = deque()
            self._deficit.setdefault(job.tenant, 0.0)
            self._order.append(job.tenant)
        q.append(job)

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def pending_by_tenant(self) -> Dict[str, int]:
        return {t: len(q) for t, q in self._queues.items() if q}

    def pick(self, running: Dict[str, int]) -> Optional[Job]:
        """One DRR rotation: among tenants with pending work AND free
        quota, serve the first (in rotating order) whose deficit covers
        its head job's cost; if none can afford theirs yet, top every
        eligible tenant up by ``quantum`` and try again.  Bounded: the
        costliest head job caps the number of top-ups."""
        eligible = [t for t in self._order
                    if self._queues.get(t)
                    and running.get(t, 0) < self.quota_for(t)]
        if not eligible:
            return None
        max_cost = max(max(j.budget_units for j in self._queues[t])
                       for t in eligible)
        rounds = int(max_cost / self.quantum) + 2
        for _ in range(max(rounds, 2)):
            n = len(self._order)
            for k in range(n):
                t = self._order[(self._rr + k) % n]
                if t not in eligible:
                    continue
                job = self._queues[t][0]
                if self._deficit[t] >= job.budget_units:
                    self._queues[t].popleft()
                    self._deficit[t] -= job.budget_units
                    if not self._queues[t]:
                        # An idle tenant must not bank credit — that is
                        # DRR's no-free-lunch rule (deficit carries only
                        # while backlogged).
                        self._deficit[t] = 0.0
                    self._rr = (self._rr + k + 1) % n
                    return job
            for t in eligible:
                self._deficit[t] += self.quantum
        return None

    def pick_batch(self, running: Dict[str, int], signature_of,
                   max_jobs: int) -> List[Job]:
        """One LANE-BATCH pick (tpu/lanes.py): the normal
        DRR pick seeds the batch, then further picks join only when
        ``signature_of`` matches the seed's lane signature — quota and
        deficit semantics are EXACTLY the solo pick's (each joining
        job is a real DRR pick against the tentative running counts,
        so a tenant's lane count obeys its quota and its deficit is
        charged per job).  Non-matching picks are restored to the
        FRONT of their tenant queues with their deficit refunded —
        the batch fill never reorders or starves a neighbor."""
        job = self.pick(running)
        if job is None:
            return []
        batch = [job]
        sig = signature_of(job)
        if sig is None or max_jobs <= 1:
            return batch
        run2 = dict(running)
        run2[job.tenant] = run2.get(job.tenant, 0) + 1
        skipped: List[Job] = []
        while len(batch) < max_jobs and len(skipped) < 2 * max_jobs:
            nxt = self.pick(run2)
            if nxt is None:
                break
            if signature_of(nxt) == sig:
                batch.append(nxt)
                run2[nxt.tenant] = run2.get(nxt.tenant, 0) + 1
            else:
                skipped.append(nxt)
        for j in reversed(skipped):
            q = self._queues.get(j.tenant)
            if q is None:
                q = self._queues[j.tenant] = deque()
                self._deficit.setdefault(j.tenant, 0.0)
                self._order.append(j.tenant)
            q.appendleft(j)
            self._deficit[j.tenant] = (self._deficit.get(j.tenant, 0.0)
                                       + j.budget_units)
        return batch


def fairness_index(per_tenant: Dict[str, dict]) -> float:
    """max/mean of per-tenant verdicts-per-budget — the metric the
    drain summary reports and ``telemetry compare`` tracks.
    1.0 = perfectly fair; a rising index means some tenant converts
    budget into verdicts disproportionately (a starved neighbor).
    Tenants that spent no budget are excluded; no data = 1.0."""
    rates = []
    for stats in per_tenant.values():
        budget = float(stats.get("budget_spent", 0.0) or 0.0)
        if budget <= 0:
            continue
        rates.append(float(stats.get("verdicts", 0)) / budget)
    if not rates or max(rates) <= 0:
        return 1.0
    mean = sum(rates) / len(rates)
    return round(max(rates) / mean, 4) if mean > 0 else 1.0
