"""Trace minimization: shrink a violating trace to a short witness.

Re-design of framework/tst/.../search/TraceMinimizer.java:32-109.  Walk the
parent chain from the end state; for each event, try re-playing the remaining
suffix without it — keep the drop if the end state still produces the same
predicate result (same truth value, or for exception traces, an exception of
the same class).  Iterate to fixpoint.

Replay uses default settings (all delivery permitted) with per-event validity
checks enabled, stopping at the first inapplicable event — matching
``applyEvents`` (TraceMinimizer.java:95-108).
"""

from __future__ import annotations

from typing import List, Optional

from dslabs_tpu_torch.testing.predicates import PredicateResult, StatePredicate

__all__ = ["minimize_trace", "minimize_exception_causing_trace"]


def _apply_events(initial_state, events: List):
    s = initial_state
    for e in events:
        nxt = s.step_event(e, None, skip_checks=False)
        if nxt is None:
            break
        s = nxt
    return s


def _state_matches(s, r: PredicateResult) -> bool:
    if s is None:
        return False
    if r.exception_thrown:
        return r.predicate.check(s).exception_thrown
    r2 = r.predicate.test(s, expected=not r.value)
    return r2 is not None and not r2.exception_thrown


def minimize_trace(state, expected_result: PredicateResult):
    shortened = True
    while shortened:
        shortened = False
        events: List = []
        s = state
        while s.previous is not None:
            test = _apply_events(s.previous, events)
            if _state_matches(test, expected_result):
                shortened = True
                state = test
            else:
                events.insert(0, s.previous_event)
            s = s.previous
    return state


def minimize_exception_causing_trace(state):
    """Minimize preserving 'an exception of the same class was thrown'
    (TraceMinimizer.java:69-93)."""
    exception = state.thrown_exception
    assert exception is not None
    exc_cls = type(exception)

    def same_class(s) -> bool:
        e = getattr(s, "thrown_exception", None)
        return e is not None and type(e) is exc_cls

    pred = StatePredicate(f"{exc_cls.__name__} thrown", same_class)
    r = pred.check(state)
    assert r.value
    return minimize_trace(state, r)
