"""Events: message and timer envelopes.

Re-design of framework/tst/dslabs/framework/testing/{Event,MessageEnvelope,
TimerEnvelope}.java.

Key semantics (SURVEY §7):
  * ``MessageEnvelope`` has value equality over (from, to, message) — the
    search network is a *set*, so identical sends collapse
    (MessageEnvelope.java:29-41).
  * ``TimerEnvelope`` equality EXCLUDES the concretely sampled duration and
    wall-clock bookkeeping (TimerEnvelope.java:39-40) so search states hash
    identically regardless of real-time sampling.
"""

from __future__ import annotations

import random
import time
from typing import Optional, Union

from dslabs_tpu_torch.core.address import Address
from dslabs_tpu_torch.core.types import Message, Timer
from dslabs_tpu_torch.utils.structural import StructEq

__all__ = ["Event", "MessageEnvelope", "TimerEnvelope"]


class MessageEnvelope(StructEq):
    """(from, to, message) with structural value equality."""

    def __init__(self, frm: Address, to: Address, message: Message):
        self.frm = frm
        self.to = to
        self.message = message

    def location_root_address(self) -> Address:
        """The root node this event applies to (Event.java:34-49)."""
        return self.to.root_address()

    def __repr__(self) -> str:
        return f"Message({self.frm} -> {self.to}, {self.message!r})"


class TimerEnvelope(StructEq):
    """A set timer: (to, timer, min_ms, max_ms).

    The real-time runner draws a concrete ``length_ms`` uniformly from
    [min, max] and tracks wall-clock deadlines (TimerEnvelope.java:50-99);
    those fields are underscore-private and therefore excluded from structural
    equality/hash.
    """

    def __init__(self, to: Address, timer: Timer, min_ms: int, max_ms: int):
        self.to = to
        self.timer = timer
        self.min_ms = min_ms
        self.max_ms = max_ms
        self._length_ms: Optional[int] = None
        self._start_ns: Optional[int] = None

    # --- real-time half (runner only) ---

    @property
    def length_ms(self) -> int:
        if self._length_ms is None:
            self._length_ms = (self.min_ms if self.min_ms == self.max_ms
                               else random.randint(self.min_ms, self.max_ms))
        return self._length_ms

    def start(self) -> None:
        self._start_ns = time.monotonic_ns()

    @property
    def end_ns(self) -> int:
        assert self._start_ns is not None, "timer not started"
        return self._start_ns + self.length_ms * 1_000_000

    def is_due(self) -> bool:
        return time.monotonic_ns() >= self.end_ns

    def location_root_address(self) -> Address:
        return self.to.root_address()

    def __repr__(self) -> str:
        return f"Timer(-> {self.to}, {self.timer!r})"


Event = Union[MessageEnvelope, TimerEnvelope]
