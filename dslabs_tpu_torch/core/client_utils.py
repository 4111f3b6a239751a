"""Helper mixin giving client nodes a blocking ``get_result``.

The reference Client contract (Client.java:41-71) requires ``getResult`` to
block until the most recent command's result arrives (releasing monitors while
waiting).  Protocol client nodes mix this in and call ``_notify_result()``
from the handler that records a result; the search engines only ever use the
non-blocking half (``has_result`` + immediate ``get_result``).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

__all__ = ["SyncClientMixin"]

# Guards lazy Condition creation: a waiter and a notifier racing through
# _result_cond must agree on a single Condition object.
_COND_CREATE_LOCK = threading.Lock()


class SyncClientMixin:

    # The condition is runtime wiring: excluded from equality (underscore) and
    # from cloning/pickling (it is not copyable and a clone gets a fresh one).
    __deepcopy_skip__ = ("_config", "_client_sync")

    def _result_cond(self) -> threading.Condition:
        cond = getattr(self, "_client_sync", None)
        if cond is None:
            with _COND_CREATE_LOCK:
                cond = getattr(self, "_client_sync", None)
                if cond is None:
                    cond = threading.Condition()
                    self._client_sync = cond
        return cond

    def _notify_result(self) -> None:
        cond = self._result_cond()
        with cond:
            cond.notify_all()

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_client_sync", None)
        d["_config"] = None
        return d

    def __setstate__(self, state):
        self.__dict__.update(state)

    def get_result(self, timeout: Optional[float] = None):
        """Block until ``has_result()``; subclasses implement
        ``_take_result()`` to consume and return the pending result."""
        cond = self._result_cond()
        deadline = None if timeout is None else time.monotonic() + timeout
        with cond:
            while not self.has_result():
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("Timed out waiting for result")
                cond.wait(remaining)
            return self._take_result()
