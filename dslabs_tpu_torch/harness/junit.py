"""BaseJUnitTest-analog assertion helpers (junit/BaseJUnitTest.java:70-492).

These are plain functions usable from pytest tests and from the CLI
driver alike:

* :func:`assert_end_condition_valid` — the workhorse: on an invariant
  violation / unexpected exception it prints the human-readable minimized
  trace (BaseJUnitTest.java:286-330), saves it to ``traces/`` when trace
  saving is enabled (GlobalSettings.save_traces, `-s` in run-tests.py),
  then fails.
* goal/space assertions (BaseJUnitTest.java:361-444).
* :class:`FailureAccumulator` — fail-and-continue with a final
  MultipleFailureException analog (DSLabsJUnitTest.java:118-143).
"""

from __future__ import annotations

from typing import List, Optional

from dslabs_tpu_torch.search.results import EndCondition, SearchResults
from dslabs_tpu_torch.search.trace import save_trace
from dslabs_tpu_torch.utils.flags import GlobalSettings

__all__ = ["assert_end_condition_valid", "assert_goal_found",
           "assert_space_exhausted", "goal_matching_state",
           "FailureAccumulator", "TestFailure"]


class TestFailure(AssertionError):
    """A lab-test failure (assertion with harness context attached)."""


def _report_violation(state, header: str, lab: Optional[str] = None,
                      part: Optional[int] = None,
                      test_name: Optional[str] = None,
                      invariants=()) -> None:
    print(f"\n{header}")
    if state is not None:
        state.print_trace()
        if GlobalSettings.save_traces:
            path = save_trace(state, list(invariants), lab_id=lab or "?",
                              lab_part=part, test_class_name="",
                              test_method_name=test_name or "")
            print(f"Saved trace to {path}")
        if GlobalSettings.start_viz:
            # -z: launch the branch-exploring debugger on the violating
            # trace and halt the run there — the BaseJUnitTest startViz /
            # VizStarted behavior (BaseJUnitTest.java:286-355).
            from dslabs_tpu_torch.viz.debugger import serve_debugger

            events = [e.previous_event for e in state.trace()
                      if e.previous_event is not None]
            root = state.trace()[0]
            serve_debugger(root, preload_events=events)


def assert_end_condition_valid(results: SearchResults,
                               lab: Optional[str] = None,
                               part: Optional[int] = None,
                               test_name: Optional[str] = None) -> None:
    """Fail (with trace printing/saving) unless the search ended without
    finding a violation or exception — BaseJUnitTest.assertEndConditionValid
    (junit/BaseJUnitTest.java:286-355)."""
    if results.end_condition == EndCondition.INVARIANT_VIOLATED:
        r = results.invariant_violated_result
        _report_violation(results.invariant_violating_state,
                          "Invariant violated; trace:", lab, part, test_name,
                          results.invariants)
        raise TestFailure(
            f"Invariant violated: "
            f"{r.error_message() if r is not None else 'unknown'}")
    if results.end_condition == EndCondition.EXCEPTION_THROWN:
        state = results.exceptional_state
        _report_violation(state, "Exception thrown by a handler; trace:",
                          lab, part, test_name, results.invariants)
        exc = getattr(state, "thrown_exception", None)
        raise TestFailure(f"Exception thrown by a node handler: {exc!r}")


def assert_goal_found(results: SearchResults, **ctx) -> None:
    """assertEndConditionValid + the goal must have matched
    (BaseJUnitTest.java:361-384)."""
    assert_end_condition_valid(results, **ctx)
    if results.end_condition != EndCondition.GOAL_FOUND:
        raise TestFailure(
            f"Goal not found (end condition: {results.end_condition}; "
            f"goals: {[str(g) for g in results.goals]})")


def goal_matching_state(results: SearchResults, **ctx):
    """The state matching the goal, for staged searches
    (BaseJUnitTest.java:398-409; PaxosTest.java:898-902)."""
    assert_goal_found(results, **ctx)
    return results.goal_matching_state


def assert_space_exhausted(results: SearchResults, **ctx) -> None:
    """assertEndConditionValid + full exploration (BaseJUnitTest.java:
    411-444) — the pruned subspace must have been exhausted, not timed out."""
    assert_end_condition_valid(results, **ctx)
    if results.end_condition != EndCondition.SPACE_EXHAUSTED:
        raise TestFailure(
            f"Search space not exhausted ({results.end_condition}); "
            "increase the time limit or narrow the search")


class FailureAccumulator:
    """failAndContinue + MultipleFailureException analog
    (DSLabsJUnitTest.java:118-143)."""

    def __init__(self):
        self.failures: List[str] = []

    def fail_and_continue(self, message: str) -> None:
        self.failures.append(message)
        print(f"FAILURE (continuing): {message}")

    def check(self, condition: bool, message: str) -> None:
        if not condition:
            self.fail_and_continue(message)

    def assert_no_failures(self) -> None:
        if self.failures:
            raise TestFailure(
                f"{len(self.failures)} accumulated failure(s):\n  " +
                "\n  ".join(self.failures))
