"""Lab 2, part 1: the ViewServer.

Behavioural re-design of labs/lab2-primarybackup/src/dslabs/primarybackup/
(ViewServer.java:12-54, View.java:8, Messages.java:10-23, Timers.java:7-14),
with the view-change rules reverse-engineered from ViewServerTest.java:40-303:

  * A view is ``(view_num, primary, backup)``.  STARTUP_VIEWNUM=0 (no
    primary), INITIAL_VIEWNUM=1.
  * Servers ping every PING_MILLIS with the number of the latest view they
    have adopted; a ping from the current primary carrying the current view
    number *acks* the view.  A server missing DEAD_TICKS consecutive
    PingCheckTimer intervals is dead.
  * The view may only change once the current view has been acked
    (ViewServerTest test08/test10), and changes at most one step at a time
    (test12: consecutive views differ).  Change rules, evaluated after every
    ping and ping-check tick:
      - startup: the first alive server becomes primary of view 1 (test02);
      - primary dead and backup alive: backup promoted, first alive idle
        server (if any) becomes backup (test05/test07);
      - backup dead and primary alive: backup replaced by first alive idle
        server or dropped (test09);
      - no backup and an alive idle server exists: it becomes backup, even if
        the primary is currently dead (test12);
      - otherwise: no change — in particular a dead primary with no live
        backup freezes the view forever (crash-stop; test07 of
        PrimaryBackupTest).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from dslabs_tpu_torch.core.address import Address
from dslabs_tpu_torch.core.node import Node
from dslabs_tpu_torch.core.types import Message, Timer

__all__ = ["View", "Ping", "GetView", "ViewReply", "PingCheckTimer",
           "ViewServer", "STARTUP_VIEWNUM", "INITIAL_VIEWNUM",
           "PING_CHECK_MILLIS", "DEAD_TICKS"]

STARTUP_VIEWNUM = 0
INITIAL_VIEWNUM = 1
PING_CHECK_MILLIS = 100  # Timers.java:8
DEAD_TICKS = 2


@dataclass(frozen=True)
class View:
    view_num: int
    primary: Optional[Address]
    backup: Optional[Address]


@dataclass(frozen=True)
class Ping(Message):
    view_num: int


@dataclass(frozen=True)
class GetView(Message):
    pass


@dataclass(frozen=True)
class ViewReply(Message):
    view: View


@dataclass(frozen=True)
class PingCheckTimer(Timer):
    pass


class ViewServer(Node):

    def __init__(self, address: Address):
        super().__init__(address)
        self.view = View(STARTUP_VIEWNUM, None, None)
        self.acked = False
        # Ticks since each known server's last ping, in first-ping order
        # (the order breaks ties when choosing an idle server — must be
        # deterministic for the model checker).
        self.ticks: Dict[Address, int] = {}

    def init(self) -> None:
        self.set_timer(PingCheckTimer(), PING_CHECK_MILLIS)

    # -------------------------------------------------------------- handlers

    def handle_Ping(self, m: Ping, sender: Address) -> None:
        self.ticks[sender] = 0
        if sender == self.view.primary and m.view_num == self.view.view_num:
            self.acked = True
        self._evaluate()
        self.send(ViewReply(self.view), sender)

    def handle_GetView(self, m: GetView, sender: Address) -> None:
        self.send(ViewReply(self.view), sender)

    def on_PingCheckTimer(self, t: PingCheckTimer) -> None:
        for a in self.ticks:
            self.ticks[a] += 1
        self._evaluate()
        self.set_timer(PingCheckTimer(), PING_CHECK_MILLIS)

    # ------------------------------------------------------------ view logic

    def _alive(self, a: Optional[Address]) -> bool:
        return a is not None and a in self.ticks and self.ticks[a] < DEAD_TICKS

    def _idle(self) -> Optional[Address]:
        for a, t in self.ticks.items():
            if t < DEAD_TICKS and a != self.view.primary and a != self.view.backup:
                return a
        return None

    def _evaluate(self) -> None:
        v = self.view
        if v.primary is None:
            first = self._idle()
            if first is not None:
                self._new_view(first, None)
            return
        if not self.acked:
            return
        if not self._alive(v.primary):
            if self._alive(v.backup):
                self._new_view(v.backup, self._idle())
            elif v.backup is None:
                idle = self._idle()
                if idle is not None:
                    self._new_view(v.primary, idle)
        elif v.backup is not None and not self._alive(v.backup):
            self._new_view(v.primary, self._idle())
        elif v.backup is None:
            idle = self._idle()
            if idle is not None:
                self._new_view(v.primary, idle)

    def _new_view(self, primary: Address, backup: Optional[Address]) -> None:
        self.view = View(self.view.view_num + 1, primary, backup)
        self.acked = False
