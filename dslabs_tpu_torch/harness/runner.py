"""Test selection, execution, and reporting — DSLabsTestCore +
TestResultsPrinter + TestResultsLogger re-designed
(junit/DSLabsTestCore.java:49-289, TestResultsPrinter.java:39-170,
TestResults.java:49-98).

Output mirrors the reference's console shape:

    --------------------------------------------------
    TEST 2.1: Startup view (5pts)
      START [2026-07-30 12:00:00.00]...

    ...PASS [2026-07-30 12:00:01.10] (1.1s)
    ==================================================

    Tests passed: 11/12
    Points: 55/60
    Total time: 12.3s

    ALL PASS / FAIL
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
import traceback
from typing import List, Optional, Sequence

LOG = logging.getLogger("dslabs.harness")

from dslabs_tpu_torch.harness.annotations import TestEntry
from dslabs_tpu_torch.harness.tee import TeeStdOutErr
from dslabs_tpu_torch.utils.flags import GlobalSettings

__all__ = ["select_tests", "run_tests", "TestResult", "RunReport"]

SMALL_SEP = "-" * 50
LARGE_SEP = "=" * 50


def _now() -> str:
    ms = int((time.time() % 1) * 100)
    return time.strftime("%Y-%m-%d %H:%M:%S") + f".{ms:02d}"


@dataclasses.dataclass
class TestResult:
    entry: TestEntry
    passed: bool
    elapsed_secs: float
    error: Optional[str] = None
    timed_out: bool = False
    stdout: str = ""
    stderr: str = ""
    stdout_truncated: bool = False
    stderr_truncated: bool = False
    start_time: float = 0.0
    end_time: float = 0.0


@dataclasses.dataclass
class RunReport:
    results: List[TestResult]
    total_secs: float

    @property
    def num_passed(self) -> int:
        return sum(r.passed for r in self.results)

    @property
    def points_earned(self) -> int:
        return sum(r.entry.points for r in self.results if r.passed)

    @property
    def points_available(self) -> int:
        return sum(r.entry.points for r in self.results)

    @property
    def all_passed(self) -> bool:
        return self.num_passed == len(self.results)


def select_tests(entries: Sequence[TestEntry],
                 lab: Optional[str] = None,
                 part: Optional[int] = None,
                 nums: Optional[Sequence[int]] = None,
                 exclude_run: bool = False,
                 exclude_search: bool = False,
                 exclude_unreliable: bool = False) -> List[TestEntry]:
    """Lab/part/test-number/category selection
    (DSLabsTestCore.java:56-70, 186-232)."""
    from dslabs_tpu_torch.harness.annotations import (RUN_TESTS, SEARCH_TESTS,
                                                UNRELIABLE_TESTS)
    out = []
    for e in sorted(entries, key=TestEntry.sort_key):
        if lab is not None and e.lab != str(lab):
            continue
        if part is not None and e.part != part:
            continue
        if nums and e.num not in nums:
            continue
        cats = set(e.categories)
        is_search = SEARCH_TESTS in cats
        is_run = RUN_TESTS in cats or not is_search
        if exclude_run and is_run and not is_search:
            continue
        if exclude_search and is_search and not is_run:
            continue
        if exclude_unreliable and UNRELIABLE_TESTS in cats:
            continue
        out.append(e)
    return out


def _run_one(entry: TestEntry, routers=None) -> TestResult:
    from dslabs_tpu_torch.harness.tee import _TeeWriter

    start = time.time()
    err_box: List[Optional[BaseException]] = [None]
    out_router, err_router = routers
    out_w = _TeeWriter(out_router.real, 1 << 20)
    err_w = _TeeWriter(err_router.real, 1 << 20)

    def target():
        ident = threading.get_ident()
        out_router.route(ident, out_w)
        err_router.route(ident, err_w)
        try:
            entry.fn()
        except BaseException as e:  # noqa: BLE001 — reported, not swallowed
            err_box[0] = e
        finally:
            # A thread that outlives its timeout stays routed to its own
            # abandoned buffer until the function finally returns — its
            # late output can never land in a later test's capture.
            out_router.unroute(ident)
            err_router.unroute(ident)

    timeout = entry.timeout_secs
    if GlobalSettings.test_timeouts_disabled:
        timeout = None
    if timeout is None:
        target()
        timed_out = False
    else:
        th = threading.Thread(target=target, daemon=True)
        th.start()
        th.join(timeout)
        timed_out = th.is_alive()
        if timed_out:
            # Cooperative stop of everything the abandoned test thread
            # started: node threads exit, single-threaded run loops
            # break, and a brief grace join keeps late output out of the
            # next test (the reference interrupts + joins,
            # RunState.java:340-383).
            from dslabs_tpu_torch.runner.run_state import stop_active_run_states
            stopped, stuck = stop_active_run_states()
            if stopped:
                LOG.warning(
                    "timeout: stopped %d leaked RunState(s)%s", stopped,
                    (f", {stuck} node thread(s) stuck past their join "
                     "timeout (wedged handlers — names/addresses logged "
                     "above)") if stuck else "")
            th.join(2.0)
    end = time.time()
    err = err_box[0]
    error_text = None
    if timed_out:
        error_text = f"TIMEOUT after {timeout}s"
    elif err is not None:
        error_text = "".join(traceback.format_exception(
            type(err), err, err.__traceback__))
    return TestResult(
        entry=entry, passed=error_text is None,
        elapsed_secs=end - start, error=error_text, timed_out=timed_out,
        stdout=out_w.captured(), stderr=err_w.captured(),
        stdout_truncated=out_w.truncated,
        stderr_truncated=err_w.truncated,
        start_time=start, end_time=end)


def _run_all(entries, out_router, err_router):
    import gc

    results = []
    for e in entries:
        # Inter-test isolation (BaseJUnitTest.java:111-191: GC + settle
        # between tests): a collector pause or the previous test's
        # late-stopping threads must not land inside the next test's
        # wall-clock window (the lab run tests assert sub-second client
        # wait bounds).
        gc.collect()
        time.sleep(0.05)
        print(SMALL_SEP)
        print(f"TEST {e.full_number}: {e.description} ({e.points}pts)")
        print(f"  START [{_now()}]...\n")
        r = _run_one(e, routers=(out_router, err_router))
        results.append(r)
        if r.error is not None:
            print(r.error)
        verdict = "...PASS" if r.passed else "...FAIL"
        print(f"{verdict} [{_now()}] ({r.elapsed_secs:.2f}s)")
    return results


def run_tests(entries: Sequence[TestEntry],
              results_output_file: Optional[str] = None) -> RunReport:
    import sys

    from dslabs_tpu_torch.harness.tee import ThreadRouter

    t0 = time.time()
    results: List[TestResult] = []
    out_router = ThreadRouter(sys.stdout)
    err_router = ThreadRouter(sys.stderr)
    saved = (sys.stdout, sys.stderr)
    sys.stdout, sys.stderr = out_router, err_router
    try:
        results.extend(_run_all(entries, out_router, err_router))
    finally:
        sys.stdout, sys.stderr = saved
    report = RunReport(results=results, total_secs=time.time() - t0)

    print(LARGE_SEP)
    print()
    print(f"Tests passed: {report.num_passed}/{len(results)}")
    print(f"Points: {report.points_earned}/{report.points_available}")
    print(f"Total time: {report.total_secs:.3f}s")
    print("\nALL PASS" if report.all_passed else "\nFAIL")
    print(LARGE_SEP)

    out_file = results_output_file or GlobalSettings.results_output_file
    if out_file:
        _write_json(report, out_file)
    return report


def _write_json(report: RunReport, path: str) -> None:
    """JSON results log (TestResultsLogger.java:41, TestResults.java:49-98)."""
    payload = {
        "num_passed": report.num_passed,
        "num_tests": len(report.results),
        "points_earned": report.points_earned,
        "points_available": report.points_available,
        "total_secs": report.total_secs,
        "tests": [{
            "lab": r.entry.lab,
            "part": r.entry.part,
            "number": r.entry.num,
            "name": r.entry.name,
            "description": r.entry.description,
            "categories": list(r.entry.categories),
            "points_earned": r.entry.points if r.passed else 0,
            "points_available": r.entry.points,
            "passed": r.passed,
            "timed_out": r.timed_out,
            "error": r.error,
            "stdout": r.stdout,
            "stdout_truncated": r.stdout_truncated,
            "stderr": r.stderr,
            "stderr_truncated": r.stderr_truncated,
            "start_time": r.start_time,
            "end_time": r.end_time,
        } for r in report.results],
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"Wrote JSON results to {path}")
