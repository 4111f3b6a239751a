"""Conformance-violation aggregator.

Re-design of framework/tst/.../utils/CheckLogger.java:40-185: collects
witnesses of non-deterministic handlers, non-idempotent message handlers, and
clone/equality inconsistencies; printed once at interpreter exit.  These
checks are what make student-style state machines safe to hash and vectorize
(SURVEY §4.2).
"""

from __future__ import annotations

import atexit
import sys
import threading
from typing import Dict, Tuple

__all__ = ["CheckLogger"]


class _CheckLogger:
    def __init__(self):
        self._lock = threading.Lock()
        # kind -> witness description (first witness wins per kind+location)
        self._findings: Dict[Tuple[str, str], str] = {}
        self._registered = False

    def _record(self, kind: str, location: str, detail: str) -> None:
        with self._lock:
            key = (kind, location)
            if key not in self._findings:
                self._findings[key] = detail
            if not self._registered:
                atexit.register(self.print_report)
                self._registered = True

    def not_deterministic(self, event, state) -> None:
        self._record("NON_DETERMINISTIC_HANDLER", repr(event),
                     f"Re-executing {event!r} on {state!r} gave a different state")

    def not_idempotent(self, event, state) -> None:
        self._record("NON_IDEMPOTENT_HANDLER", repr(event),
                     f"Re-delivering {event!r} changed the state again")

    def clone_not_equal(self, obj) -> None:
        self._record("CLONE_NOT_EQUAL", type(obj).__qualname__,
                     f"Object not equal to its clone: {obj!r}")

    def hash_inconsistent(self, obj) -> None:
        self._record("HASHCODE_INCONSISTENT", type(obj).__qualname__,
                     f"Clone hash differs: {obj!r}")

    @property
    def findings(self):
        return dict(self._findings)

    def clear(self) -> None:
        with self._lock:
            self._findings.clear()

    def print_report(self, out=None) -> None:
        out = out or sys.stderr
        if not self._findings:
            return
        print("\n=== dslabs conformance check findings ===", file=out)
        for (kind, loc), detail in self._findings.items():
            print(f"[{kind}] at {loc}: {detail}", file=out)


CheckLogger = _CheckLogger()
