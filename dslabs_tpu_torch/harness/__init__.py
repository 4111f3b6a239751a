"""Test harness: registry/annotations, assertion helpers, runner, capture.

Re-design of the reference's `junit/` layer (BaseJUnitTest.java:70,
DSLabsTestCore.java:49, TestResultsPrinter.java:39) for plain-Python lab
tests driven either by pytest or by the `run_tests.py` CLI."""

from dslabs_tpu_torch.harness.annotations import (RUN_TESTS, SEARCH_TESTS,
                                            UNRELIABLE_TESTS, TestEntry,
                                            clear_registry, lab_test,
                                            registry)
from dslabs_tpu_torch.harness.junit import (FailureAccumulator, TestFailure,
                                      assert_end_condition_valid,
                                      assert_goal_found,
                                      assert_space_exhausted,
                                      goal_matching_state)
from dslabs_tpu_torch.harness.runner import (RunReport, TestResult, run_tests,
                                       select_tests)
from dslabs_tpu_torch.harness.tee import TeeStdOutErr

__all__ = [
    "RUN_TESTS", "SEARCH_TESTS", "UNRELIABLE_TESTS", "TestEntry",
    "lab_test", "registry", "clear_registry",
    "FailureAccumulator", "TestFailure", "assert_end_condition_valid",
    "assert_goal_found", "assert_space_exhausted", "goal_matching_state",
    "RunReport", "TestResult", "run_tests", "select_tests", "TeeStdOutErr",
]
