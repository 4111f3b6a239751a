"""Checking as a service: the resident multi-tenant search server of the
port, counterpart of ``dslabs_tpu/service/``.  A bounded persistent queue
(``queue.py``), the conformance admission gate and per-job warden fault
domains with batched job lanes (``server.py``), and the fairness-keeping
DRR scheduler with taxonomy-driven degradation (``scheduler.py``).  CLI:
``python -m dslabs_tpu_torch.service``."""

from dslabs_tpu_torch.service.queue import Job, ServiceQueue, replay_journal
from dslabs_tpu_torch.service.scheduler import (AttemptPlan,
                                                DeficitRoundRobin,
                                                RetrySpec, degrade,
                                                fairness_index)
from dslabs_tpu_torch.service.server import (CheckServer,
                                             SERVER_STATUS_NAME,
                                             admission_check)

__all__ = ["Job", "ServiceQueue", "replay_journal", "AttemptPlan",
           "DeficitRoundRobin", "RetrySpec", "degrade",
           "fairness_index", "CheckServer", "SERVER_STATUS_NAME",
           "admission_check"]
