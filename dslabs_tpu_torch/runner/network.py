"""The emulated real-time network: per-address inboxes.

Re-design of framework/tst/.../runner/Network.java:44-199.  Each node has an
Inbox = a FIFO message queue + a priority queue of timers ordered by wall-clock
deadline; blocking ``take()`` returns the next message immediately or waits
until the earliest timer is due, waking early when a sooner timer arrives.
Per-inbox received-message counters back the lab3 message-budget test.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from typing import Dict, Iterable, Optional

from dslabs_tpu_torch.core.address import Address
from dslabs_tpu_torch.testing.events import Event, MessageEnvelope, TimerEnvelope

__all__ = ["Network", "Inbox"]


class Inbox:

    def __init__(self):
        self._cond = threading.Condition()
        self._messages: deque = deque()
        self._timers: list = []  # heap of (end_ns, seq, TimerEnvelope)
        self._seq = itertools.count()
        self._interrupted = False
        self.num_messages_received = 0

    def send(self, envelope: MessageEnvelope) -> None:
        with self._cond:
            self._messages.append(envelope)
            self.num_messages_received += 1
            self._cond.notify()

    def set_timer(self, envelope: TimerEnvelope) -> None:
        envelope.start()
        with self._cond:
            heapq.heappush(self._timers, (envelope.end_ns, next(self._seq), envelope))
            self._cond.notify()  # may be earlier than the current wait target

    def take(self) -> Optional[Event]:
        """Block until a message is available or the earliest timer is due
        (Network.java:100-149).  Returns None when interrupted (the runner's
        shutdown path; the Java engine interrupts the node thread)."""
        with self._cond:
            while True:
                if self._interrupted:
                    return None
                if self._messages:
                    return self._messages.popleft()
                if self._timers:
                    end_ns, _, te = self._timers[0]
                    now = time.monotonic_ns()
                    if now >= end_ns:
                        heapq.heappop(self._timers)
                        return te
                    self._cond.wait(timeout=(end_ns - now) / 1e9)
                else:
                    self._cond.wait()

    def poll_message(self) -> Optional[MessageEnvelope]:
        with self._cond:
            return self._messages.popleft() if self._messages else None

    def poll_due_timer(self) -> Optional[TimerEnvelope]:
        with self._cond:
            if self._timers and time.monotonic_ns() >= self._timers[0][0]:
                return heapq.heappop(self._timers)[2]
            return None

    def interrupt(self) -> None:
        with self._cond:
            self._interrupted = True
            self._cond.notify_all()

    def clear_interrupt(self) -> None:
        with self._cond:
            self._interrupted = False

    def __len__(self) -> int:
        with self._cond:
            return len(self._messages) + len(self._timers)


class Network:

    def __init__(self):
        self._inboxes: Dict[Address, Inbox] = {}
        self._lock = threading.Lock()

    def add_inbox(self, address: Address) -> Inbox:
        with self._lock:
            return self._inboxes.setdefault(address.root_address(), Inbox())

    def remove_inbox(self, address: Address) -> None:
        with self._lock:
            self._inboxes.pop(address.root_address(), None)

    def inbox(self, address: Address) -> Optional[Inbox]:
        with self._lock:
            return self._inboxes.get(address.root_address())

    def send(self, envelope: MessageEnvelope) -> None:
        """Deliver to the destination inbox; silently dropped if the node does
        not exist (Network.java:178-180)."""
        inbox = self.inbox(envelope.to.root_address())
        if inbox is not None:
            inbox.send(envelope)

    def set_timer(self, envelope: TimerEnvelope) -> None:
        inbox = self.inbox(envelope.to.root_address())
        if inbox is not None:
            inbox.set_timer(envelope)

    def num_messages_received(self, address: Address) -> int:
        inbox = self.inbox(address)
        return inbox.num_messages_received if inbox else 0

    def total_messages_received(self) -> int:
        with self._lock:
            return sum(i.num_messages_received for i in self._inboxes.values())

    def addresses(self) -> Iterable[Address]:
        with self._lock:
            return list(self._inboxes.keys())
