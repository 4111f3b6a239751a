"""Per-test stdout/stderr capture with size caps — TeeStdOutErr
(utils/TeeStdOutErr.java:34-134) re-designed as a context manager.

Output still flows to the real streams (the console reporter interleaves
with test output, as in the reference); the captured copy (truncated at
``max_bytes`` with a flag) feeds the JSON results log
(TestResults.java:86-97)."""

from __future__ import annotations

import io
import sys

__all__ = ["TeeStdOutErr"]


class _TeeWriter(io.TextIOBase):
    def __init__(self, real, cap: int):
        self.real = real
        self.cap = cap
        self.buf = io.StringIO()
        self.truncated = False

    def write(self, s):
        self.real.write(s)
        room = self.cap - self.buf.tell()
        if room > 0:
            self.buf.write(s[:room])
        if s and len(s) > max(room, 0):
            self.truncated = True
        return len(s)

    def flush(self):
        self.real.flush()

    def captured(self) -> str:
        return self.buf.getvalue()


class ThreadRouter(io.TextIOBase):
    """Routes writes by thread: threads registered via :meth:`route` write
    to their own `_TeeWriter`; everything else goes to the real stream.

    The CLI runner installs one router per stream for the whole run so a
    timed-out test's orphaned thread keeps writing to ITS OWN (abandoned)
    capture buffer instead of contaminating the next test's capture."""

    def __init__(self, real):
        self.real = real
        self.routes = {}

    def route(self, thread_ident, writer) -> None:
        self.routes[thread_ident] = writer

    def unroute(self, thread_ident) -> None:
        self.routes.pop(thread_ident, None)

    def write(self, s):
        import threading

        w = self.routes.get(threading.get_ident())
        if w is not None:
            return w.write(s)
        return self.real.write(s)

    def flush(self):
        self.real.flush()


class TeeStdOutErr:
    """``with TeeStdOutErr() as tee: ...`` then ``tee.stdout``/``tee.stderr``
    hold the captured (possibly truncated) copies."""

    def __init__(self, max_bytes: int = 1 << 20):
        self.max_bytes = max_bytes
        self.stdout = ""
        self.stderr = ""
        self.stdout_truncated = False
        self.stderr_truncated = False

    def __enter__(self):
        self._out = _TeeWriter(sys.stdout, self.max_bytes)
        self._err = _TeeWriter(sys.stderr, self.max_bytes)
        self._saved = (sys.stdout, sys.stderr)
        sys.stdout, sys.stderr = self._out, self._err
        return self

    def __exit__(self, *exc):
        sys.stdout, sys.stderr = self._saved
        self.stdout = self._out.captured()
        self.stderr = self._err.captured()
        self.stdout_truncated = self._out.truncated
        self.stderr_truncated = self._err.truncated
        return False
