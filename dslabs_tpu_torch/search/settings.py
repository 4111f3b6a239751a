"""Search settings: prunes, goals, depth limit, status output.

Re-design of framework/tst/.../search/SearchSettings.java:43-199.

Exception policy (SURVEY §7.9): prune predicates that throw are treated as
pruned (the safe direction); goal predicates that throw are logged and
ignored; invariant exceptions (handled in TestSettings.invariants_hold via the
search layer) count as violations.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

from dslabs_tpu_torch.testing.predicates import PredicateResult, StatePredicate
from dslabs_tpu_torch.testing.settings import TestSettings

LOG = logging.getLogger("dslabs.search")

__all__ = ["SearchSettings"]


class SearchSettings(TestSettings):

    def __init__(self):
        super().__init__()
        self.prunes: List[StatePredicate] = []
        self.goals: List[StatePredicate] = []
        self.max_depth: int = -1
        self.num_threads: int = os.cpu_count() or 1
        self.output_freq_secs: float = -1

    # fluent helpers -------------------------------------------------------

    def clear(self) -> "SearchSettings":
        """Full reset (SearchSettings.java's clear(): invariants, goals,
        prunes, network matrix, timer gating, depth) keeping only the time
        budget defaults — used between staged-search phases
        (PaxosTest.java:1063)."""
        self.__init__()
        return self

    def add_prune(self, predicate: StatePredicate) -> "SearchSettings":
        self.prunes.append(predicate)
        return self

    def clear_prunes(self) -> "SearchSettings":
        self.prunes.clear()
        return self

    def add_goal(self, predicate: StatePredicate) -> "SearchSettings":
        self.goals.append(predicate)
        return self

    def clear_goals(self) -> "SearchSettings":
        self.goals.clear()
        return self

    def set_max_depth(self, depth: int) -> "SearchSettings":
        self.max_depth = depth
        return self

    def depth_limited(self) -> bool:
        return self.max_depth >= 0

    def should_output_status(self) -> bool:
        return self.output_freq_secs > 0

    # evaluation -----------------------------------------------------------

    def should_prune(self, state) -> bool:
        """Any prune matches => pruned; a throwing prune is logged and treated
        as pruned (SearchSettings.java:77-102)."""
        for p in self.prunes:
            r = p.test(state, expected=False)
            if r is None:
                continue
            if r.exception_thrown:
                LOG.error(r.error_message())
            return True
        return False

    def goal_matched(self, state) -> Optional[PredicateResult]:
        """First matching goal's result; throwing goals logged and skipped
        (SearchSettings.java:104-135)."""
        for p in self.goals:
            r = p.test(state, expected=False)
            if r is None:
                continue
            if r.exception_thrown:
                LOG.error(r.error_message())
                continue
            return r
        return None
