"""Trace replay as a search: step a fixed event list, checking each state.

Re-design of framework/tst/.../junit/TraceReplaySearch.java:35-107.  Used by
the saved-trace regression suite; pruning is not allowed during replay.
"""

from __future__ import annotations

from typing import List, Optional

from dslabs_tpu_torch.search.search import Search, StateStatus
from dslabs_tpu_torch.search.search_state import SearchState
from dslabs_tpu_torch.search.settings import SearchSettings
from dslabs_tpu_torch.testing.events import Event

__all__ = ["TraceReplaySearch", "replay_trace"]


class TraceReplaySearch(Search):

    def __init__(self, settings: Optional[SearchSettings], history: List[Event]):
        super().__init__(settings)
        if self.settings.prunes:
            raise ValueError("Trace replay does not allow prune predicates")
        self._history = history
        self._initial: Optional[SearchState] = None
        self._done = False

    def search_type(self) -> str:
        return "trace replay"

    def status(self, elapsed_secs: float) -> str:
        return f"Replayed {len(self._history)} events ({elapsed_secs:.2f}s)"

    def init_search(self, initial_state: SearchState) -> None:
        self._initial = initial_state

    def space_exhausted(self) -> bool:
        return self._done

    def run_one_worker(self) -> None:
        state = self._initial
        if self.check_state(state, False) is StateStatus.TERMINAL:
            self._done = True
            return
        for event in self._history:
            nxt = state.step_event(event, self.settings, skip_checks=True)
            if nxt is None:
                break
            state = nxt
            if self.check_state(state, False) is StateStatus.TERMINAL:
                self._done = True
                return
        self._done = True


def replay_trace(initial_state: SearchState, history: List[Event],
                 settings: Optional[SearchSettings] = None):
    return TraceReplaySearch(settings, history).run(initial_state)
