"""Search results carrier.

Re-design of framework/tst/.../search/SearchResults.java:34-88: first-writer-
wins result slots for invariant violation / goal match / exception, plus the
resolved end condition.
"""

from __future__ import annotations

import enum
import threading
from typing import List, Optional

from dslabs_tpu_torch.testing.predicates import PredicateResult, StatePredicate

__all__ = ["EndCondition", "SearchResults"]


class EndCondition(enum.Enum):
    SPACE_EXHAUSTED = "SPACE_EXHAUSTED"
    TIME_EXHAUSTED = "TIME_EXHAUSTED"
    INVARIANT_VIOLATED = "INVARIANT_VIOLATED"
    GOAL_FOUND = "GOAL_FOUND"
    EXCEPTION_THROWN = "EXCEPTION_THROWN"


class SearchResults:

    discovered_count: int = 0
    # Tensor-backend exploration stats (0 on the object checker): beam-
    # style coverage truncations and visited-table treat-as-fresh
    # overflows (see dslabs_tpu/tpu/visited.py's overflow contract) are
    # surfaced here so callers can tell an exact exhaustion from a
    # degraded one.
    dropped: int = 0
    visited_overflow: int = 0

    def __init__(self, invariants: List[StatePredicate],
                 goals: List[StatePredicate]):
        self.invariants = list(invariants)
        self.goals = list(goals)
        self.end_condition: Optional[EndCondition] = None
        self._lock = threading.Lock()
        self._invariant_violating_state = None
        self._invariant_violated: Optional[PredicateResult] = None
        self._goal_matching_state = None
        self._goal_matched: Optional[PredicateResult] = None
        self._exceptional_state = None
        self._exception_signalled = False

    # First-writer-wins setters (SearchResults.java:48-80).  A None state is a
    # "signal" write used to stop other workers before minimization finishes;
    # the real state overwrites it.

    def invariant_violated(self, state, result: PredicateResult) -> None:
        with self._lock:
            if self._invariant_violating_state is None:
                self._invariant_violating_state = state
                self._invariant_violated = result

    def goal_found(self, state, result: PredicateResult) -> None:
        with self._lock:
            if self._goal_matching_state is None:
                self._goal_matching_state = state
                self._goal_matched = result

    def exception_thrown(self, state) -> None:
        with self._lock:
            self._exception_signalled = True
            if self._exceptional_state is None:
                self._exceptional_state = state

    @property
    def invariant_violating_state(self):
        return self._invariant_violating_state

    @property
    def invariant_violated_result(self) -> Optional[PredicateResult]:
        return self._invariant_violated

    @property
    def goal_matching_state(self):
        return self._goal_matching_state

    @property
    def goal_matched_result(self) -> Optional[PredicateResult]:
        return self._goal_matched

    @property
    def exceptional_state(self):
        return self._exceptional_state

    @property
    def exception_signalled(self) -> bool:
        return self._exception_signalled

    def terminal_found(self) -> bool:
        return (self._exception_signalled
                or self._invariant_violating_state is not None
                or self._goal_matching_state is not None)

    def __repr__(self) -> str:
        return f"SearchResults(end={self.end_condition})"
