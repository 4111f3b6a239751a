"""Global flag system.

Re-design of framework/tst/.../utils/GlobalSettings.java:37-143.  Flags come
from environment variables (``DSLABS_<NAME>``) or are set programmatically;
the test harness maps CLI options onto them the way run-tests.py maps flags to
JVM properties.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["GlobalSettings"]


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() in ("1", "true", "yes", "on")


class _GlobalSettings:
    def __init__(self):
        self.verbose: bool = _env_bool("DSLABS_VERBOSE", True)
        self.single_threaded: bool = _env_bool("DSLABS_SINGLE_THREADED")
        self.start_viz: bool = _env_bool("DSLABS_START_VIZ")
        self.save_traces: bool = _env_bool("DSLABS_SAVE_TRACES")
        self.do_checks: bool = _env_bool("DSLABS_DO_CHECKS")
        self.do_all_checks: bool = _env_bool("DSLABS_DO_ALL_CHECKS")
        self.test_timeouts_disabled: bool = _env_bool("DSLABS_NO_TIMEOUTS")
        self.results_output_file: Optional[str] = os.environ.get(
            "DSLABS_RESULTS_OUTPUT_FILE")
        self.log_level: str = os.environ.get("DSLABS_LOG_LEVEL", "WARNING")
        # Search strategy: "object" (the Python graph checker) or
        # "tensor" (the TPU engine via protocol twins, tpu/backend.py).
        self.search_backend: str = os.environ.get(
            "DSLABS_SEARCH_BACKEND", "object")
        # Multiplier on every search max-time budget (the reference
        # grader's timeout-multiplier analog): batch runs under compile
        # or CPU contention can set e.g. 2.0 so a directed staged phase
        # that needs 10s solo doesn't TIME_EXHAUST at a nominal 60s
        # budget that contention stretched past (the round-4 "test23
        # passes standalone, fails in batch" margin).
        self.time_scale: float = float(
            os.environ.get("DSLABS_TIME_SCALE", "1.0"))
        # Temporarily-enabled error checks (@ChecksEnabled rule analog)
        self.error_checks_temporarily_enabled: bool = False

    def do_error_checks(self) -> bool:
        return self.do_checks or self.error_checks_temporarily_enabled

    def do_all_error_checks(self) -> bool:
        return self.do_all_checks


GlobalSettings = _GlobalSettings()
