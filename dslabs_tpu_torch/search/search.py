"""The search drivers: BFS and random DFS over the system state graph.

Re-design of framework/tst/.../search/Search.java:63-583.  The per-state
pipeline (``check_state``) runs, in order: thrown exception -> invariant
violation -> goal match -> optional determinism/idempotence re-execution
checks -> prunes -> depth limit (Search.java:162-231; SURVEY §7.5).  Terminal
states stop the whole search; pruned states are not expanded.  The initial
state is checked too.

BFS explores one depth level at a time from an insertion-ordered frontier and
dedups successors at generation time against the search-equivalence relation
(Search.java:405-505).  BFS does NOT run the trace minimizer (its traces are
shortest by construction); RandomDFS minimizes its random deep probes
(checkState call sites Search.java:473, 492 vs 570).

This object-graph implementation is the semantic oracle; the TPU backend
(dslabs_tpu_torch.tpu) vectorizes the same level-step and is diffed against this
one for verdict parity.
"""

from __future__ import annotations

import enum
import random
import time
from collections import deque
from typing import List, Optional

from dslabs_tpu_torch.search.minimize import (minimize_exception_causing_trace,
                                        minimize_trace)
from dslabs_tpu_torch.search.results import EndCondition, SearchResults
from dslabs_tpu_torch.search.search_state import SearchState
from dslabs_tpu_torch.search.settings import SearchSettings
from dslabs_tpu_torch.utils.check_logger import CheckLogger
from dslabs_tpu_torch.utils.flags import GlobalSettings

__all__ = ["Search", "BFS", "RandomDFS", "bfs", "dfs"]


class StateStatus(enum.Enum):
    VALID = "VALID"
    TERMINAL = "TERMINAL"
    PRUNED = "PRUNED"


class Search:
    """Common driver: settings, results, time budget, status output."""

    def __init__(self, settings: Optional[SearchSettings]):
        self.settings = settings if settings is not None else SearchSettings()
        self.results = SearchResults(self.settings.invariants,
                                     self.settings.goals)
        self._start_time = 0.0
        self._last_status = 0.0

    # -------------------------------------------------------------- template

    def search_type(self) -> str:
        raise NotImplementedError

    def init_search(self, initial_state: SearchState) -> None:
        raise NotImplementedError

    def space_exhausted(self) -> bool:
        raise NotImplementedError

    def run_one_worker(self) -> None:
        """Explore one unit of work."""
        raise NotImplementedError

    def status(self, elapsed_secs: float) -> str:
        raise NotImplementedError

    # ---------------------------------------------------------------- engine

    def check_state(self, s: SearchState, should_minimize: bool) -> StateStatus:
        if s.thrown_exception is not None:
            if should_minimize:
                self.results.exception_thrown(None)
                s = minimize_exception_causing_trace(s)
            self.results.exception_thrown(s)
            return StateStatus.TERMINAL

        r = self.settings.invariant_violated(s)
        if r is not None:
            if should_minimize:
                self.results.invariant_violated(None, r)
                s = minimize_trace(s, r)
            self.results.invariant_violated(s, r)
            return StateStatus.TERMINAL

        r = self.settings.goal_matched(s)
        if r is not None:
            if should_minimize:
                self.results.goal_found(None, r)
                s = minimize_trace(s, r)
            self.results.goal_found(s, r)
            return StateStatus.TERMINAL

        if GlobalSettings.do_error_checks():
            previous = s.previous
            e = s.previous_event
            if previous is not None:
                # Determinism: re-execute the event and compare.
                if s != previous.step_event(e, self.settings, skip_checks=True):
                    CheckLogger.not_deterministic(e, previous)
                if GlobalSettings.do_all_error_checks():
                    from dslabs_tpu_torch.testing.events import MessageEnvelope
                    if (isinstance(e, MessageEnvelope)
                            and s != s.step_event(e, self.settings, skip_checks=True)):
                        CheckLogger.not_idempotent(e, previous)

        if self.settings.should_prune(s):
            return StateStatus.PRUNED

        if (self.settings.depth_limited()
                and s.depth >= self.settings.max_depth):
            return StateStatus.PRUNED

        return StateStatus.VALID

    def _time_exhausted(self) -> bool:
        from dslabs_tpu_torch.utils.flags import GlobalSettings

        return (self.settings.max_time_secs is not None
                and time.monotonic() - self._start_time
                >= self.settings.max_time_secs
                * GlobalSettings.time_scale)

    def _maybe_print_status(self) -> None:
        if not self.settings.should_output_status():
            return
        now = time.monotonic()
        if now - self._last_status >= self.settings.output_freq_secs:
            self._last_status = now
            print(self.status(now - self._start_time))

    def run(self, initial_state: SearchState) -> SearchResults:
        self._start_time = time.monotonic()
        self._last_status = self._start_time
        self.init_search(initial_state)

        # Sequential worker loop.  The Java engine runs a one-depth-at-a-time
        # thread pool (Search.java:240-347); under CPython the object oracle
        # is sequential — the *parallel* engine is the TPU backend, where one
        # BFS level is one vmapped XLA program (dslabs_tpu/tpu/engine.py).
        while (not self.results.terminal_found()
               and not self.space_exhausted()
               and not self._time_exhausted()):
            self.run_one_worker()
            self._maybe_print_status()

        if self.settings.should_output_status():
            print(self.status(max(time.monotonic() - self._start_time, 1e-9)))
            print("Search finished.")

        # End-condition resolution (Search.java:368-383).
        if self.results.exceptional_state is not None or \
                self.results.exception_signalled:
            self.results.end_condition = EndCondition.EXCEPTION_THROWN
        elif self.results.invariant_violating_state is not None:
            self.results.end_condition = EndCondition.INVARIANT_VIOLATED
        elif self.results.goal_matching_state is not None:
            self.results.end_condition = EndCondition.GOAL_FOUND
        elif self.space_exhausted():
            self.results.end_condition = EndCondition.SPACE_EXHAUSTED
        else:
            self.results.end_condition = EndCondition.TIME_EXHAUSTED
        if hasattr(self, "_discovered"):
            self.results.discovered_count = len(self._discovered)
        return self.results


class BFS(Search):

    def __init__(self, settings: Optional[SearchSettings]):
        super().__init__(settings)
        self._queue: deque = deque()
        self._discovered: set = set()
        self.states_explored = 0
        self.max_depth_seen = 0
        self._initial_depth = 0

    def search_type(self) -> str:
        return "breadth-first"

    def status(self, elapsed_secs: float) -> str:
        return (f"Explored: {self.states_explored}, "
                f"Depth: {self.max_depth_seen} "
                f"({elapsed_secs:.2f}s, "
                f"{self.states_explored / elapsed_secs / 1000.0:.2f}K states/s)")

    def init_search(self, initial_state: SearchState) -> None:
        self._queue.append(initial_state)
        self._discovered.add(initial_state.search_equivalence_key())
        self.states_explored = 0
        self.max_depth_seen = initial_state.depth
        self._initial_depth = initial_state.depth

    def space_exhausted(self) -> bool:
        return not self._queue

    def run_one_worker(self) -> None:
        node = self._queue.popleft()
        self._explore(node)

    def _explore(self, node: SearchState) -> None:
        if node.depth == self._initial_depth:
            self.states_explored += 1
            if self.check_state(node, False) is StateStatus.TERMINAL:
                return

        for event in node.events(self.settings):
            successor = node.step_event(event, self.settings, skip_checks=True)
            if successor is None:
                continue
            key = successor.search_equivalence_key()
            if key in self._discovered:
                continue
            self._discovered.add(key)

            if successor.depth > self.max_depth_seen:
                self.max_depth_seen = successor.depth
            self.states_explored += 1

            status = self.check_state(successor, False)
            if status is StateStatus.TERMINAL:
                return
            if status is StateStatus.PRUNED:
                continue
            self._queue.append(successor)

            # Bail promptly on time exhaustion inside huge levels.
            if self.states_explored % 1024 == 0 and self._time_exhausted():
                return


class RandomDFS(Search):

    def __init__(self, settings: Optional[SearchSettings]):
        super().__init__(settings)
        self._initial: Optional[SearchState] = None
        self.states_explored = 0
        self.probes = 0

    def search_type(self) -> str:
        return "random depth-first"

    def status(self, elapsed_secs: float) -> str:
        return (f"Explored: {self.states_explored}, "
                f"Num Probes: {self.probes} "
                f"({elapsed_secs:.2f}s, "
                f"{self.states_explored / elapsed_secs / 1000.0:.2f}K explored/s)")

    def init_search(self, initial_state: SearchState) -> None:
        self._initial = initial_state
        self.probes = 0
        self.states_explored = 0

    def space_exhausted(self) -> bool:
        return False  # random probes never exhaust the space

    def run_one_worker(self) -> None:
        """One random probe from the initial state (Search.java:557-581)."""
        self.probes += 1
        self.states_explored += 1
        current = self._initial
        while current is not None:
            nxt = None
            events = current.events(self.settings)
            random.shuffle(events)
            for event in events:
                s = current.step_event(event, self.settings, skip_checks=True)
                if s is None:
                    continue
                self.states_explored += 1
                status = self.check_state(s, True)
                if status is StateStatus.TERMINAL:
                    return
                if status is StateStatus.PRUNED:
                    continue
                nxt = s
                break
            current = nxt
            if self._time_exhausted():
                return


def bfs(initial_state: SearchState,
        settings: Optional[SearchSettings] = None) -> SearchResults:
    """BFS entry point (Search.bfs, Search.java:390-402).  The search
    STRATEGY is selectable via ``GlobalSettings.search_backend``
    (``run_tests.py --search-backend tensor``): the tensor strategy runs
    the same state + settings on the TPU engine through the lab's
    protocol twin (tpu/backend.py) and fails loudly when no twin
    exists — it never silently falls back to the object checker."""
    if GlobalSettings.search_backend == "tensor":
        from dslabs_tpu_torch.tpu.backend import tensor_bfs

        return tensor_bfs(initial_state, settings)
    return BFS(settings).run(initial_state)


def dfs(initial_state: SearchState,
        settings: Optional[SearchSettings] = None) -> SearchResults:
    if GlobalSettings.search_backend == "tensor":
        from dslabs_tpu_torch.tpu.backend import tensor_dfs

        return tensor_dfs(initial_state, settings)
    return RandomDFS(settings).run(initial_state)
