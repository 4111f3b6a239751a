"""Logical-time timer queue for one node — the model's only ordering rule.

Re-design of framework/tst/.../search/TimerQueue.java:34-134.  In an
asynchronous system the sole restriction on timer delivery is: if a node set
timers t1 then t2 and ``t2.min >= t1.max``, t1 must fire before t2.  So a
timer t at position i is deliverable iff ``t.min < min(max of all earlier
timers in the queue)``; the first timer is always deliverable.

Firing removes exactly one matching timer (equality ignores sampled lengths,
TimerEnvelope equality semantics).
"""

from __future__ import annotations

from typing import Iterator, List

from dslabs_tpu_torch.testing.events import TimerEnvelope
from dslabs_tpu_torch.utils.structural import StructEq

__all__ = ["TimerQueue"]


class TimerQueue(StructEq):

    def __init__(self, other: "TimerQueue" = None):
        self.timers: List[TimerEnvelope] = list(other.timers) if other else []

    def add(self, envelope: TimerEnvelope) -> None:
        self.timers.append(envelope)

    def deliverable(self) -> Iterator[TimerEnvelope]:
        """Yield deliverable timers in queue order.

        Matches the reference iterator (TimerQueue.java:66-105): tracks the
        running minimum of preceding ``max`` bounds; a timer whose ``min`` is
        >= that bound cannot overtake and is skipped (and everything behind a
        skipped timer still compares against the same bound)."""
        min_max = None
        for te in self.timers:
            if min_max is not None and te.min_ms >= min_max:
                continue
            yield te
            if min_max is None or te.max_ms < min_max:
                min_max = te.max_ms

    def is_deliverable(self, envelope: TimerEnvelope) -> bool:
        """Membership + the overtaking constraint (TimerQueue.java:107-118):
        walk the queue; if we meet an equal timer first it is deliverable; if
        we first meet an earlier timer te with ``envelope.min >= te.max``, it
        is not."""
        for te in self.timers:
            if te == envelope:
                return True
            if envelope.min_ms >= te.max_ms:
                return False
        return False

    def remove(self, envelope: TimerEnvelope) -> None:
        self.timers.remove(envelope)

    def __iter__(self) -> Iterator[TimerEnvelope]:
        return iter(self.timers)

    def __len__(self) -> int:
        return len(self.timers)

    def __repr__(self) -> str:
        return repr(self.timers)
