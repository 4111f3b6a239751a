"""Lab 2, part 2: primary-backup replication on top of the ViewServer.

The reference ships this as a skeleton (labs/lab2-primarybackup/src/dslabs/
primarybackup/PBServer.java, PBClient.java — "Your code here"); the protocol
below is designed to the acceptance spec in PrimaryBackupTest.java:75-905:

  * Servers ping the ViewServer every PING_MILLIS with the number of the view
    they have adopted *and are ready to serve* — a primary with an unsynced
    backup keeps pinging the previous view number so the ViewServer cannot
    move past a view whose backup lacks the application state
    (test19MultipleFailuresSearch depends on this).
  * The primary wraps the application in AMOApplication (at-most-once,
    test08).  With a synced backup, each client request is forwarded and
    acked before the primary executes and replies, so an acknowledged write
    is always visible after failover (test06/test09/test18).  The primary
    admits one outstanding operation at a time, which fixes the order the
    backup applies operations without any sequencing protocol; concurrent
    requests are dropped and covered by client retries.
  * On adopting a view with a fresh backup the primary sends a full state
    transfer (the whole AMOApplication) and refuses client requests until it
    is acked.  Retries of forwards/transfers ride the ping timer.
  * The client polls the ViewServer for the current primary, retries its
    pending command on a 100ms timer, and re-polls the view on every retry so
    it finds the new primary after failover.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from dslabs_tpu_torch.core.address import Address
from dslabs_tpu_torch.core.client_utils import SyncClientMixin
from dslabs_tpu_torch.core.node import Node
from dslabs_tpu_torch.core.types import Application, Client, Command, Message, Result, Timer
from dslabs_tpu_torch.labs.clientserver.amo import AMOApplication, AMOCommand, AMOResult
from dslabs_tpu_torch.labs.primarybackup.viewserver import (GetView, Ping, View,
                                                      ViewReply)
from dslabs_tpu_torch.utils.structural import clone

__all__ = ["Request", "Reply", "ForwardRequest", "ForwardAck", "StateTransfer",
           "StateTransferAck", "PingTimer", "ClientTimer", "PBServer",
           "PBClient", "PING_MILLIS", "CLIENT_RETRY_MILLIS"]

PING_MILLIS = 25  # Timers.java:13
CLIENT_RETRY_MILLIS = 100  # Timers.java:17


@dataclass(frozen=True)
class Request(Message):
    command: AMOCommand


@dataclass(frozen=True)
class Reply(Message):
    result: AMOResult


@dataclass(frozen=True)
class ForwardRequest(Message):
    view_num: int
    command: AMOCommand


@dataclass(frozen=True)
class ForwardAck(Message):
    view_num: int
    command: AMOCommand


@dataclass(frozen=True)
class StateTransfer(Message):
    view: View
    app: AMOApplication


@dataclass(frozen=True)
class StateTransferAck(Message):
    view_num: int


@dataclass(frozen=True)
class PingTimer(Timer):
    pass


@dataclass(frozen=True)
class ClientTimer(Timer):
    command: AMOCommand


class PBServer(Node):

    def __init__(self, address: Address, vsa: Address, app: Application):
        super().__init__(address)
        self.vsa = vsa
        self.app = AMOApplication(app)
        self.view: Optional[View] = None
        self.synced = True  # backup (if any) has our state / we have state
        self.pending: Optional[Tuple[Address, AMOCommand]] = None

    def init(self) -> None:
        self.send(Ping(0), self.vsa)
        self.set_timer(PingTimer(), PING_MILLIS)

    # ------------------------------------------------------------ view state

    def _is_primary(self) -> bool:
        return self.view is not None and self.view.primary == self.address

    def _is_backup(self) -> bool:
        return self.view is not None and self.view.backup == self.address

    def _acked_view_num(self) -> int:
        if self.view is None:
            return 0
        if self._is_primary() and self.view.backup is not None and not self.synced:
            # Not ready to serve this view: never acknowledge it (the
            # previous view of the same primary had number view_num - 1).
            return self.view.view_num - 1
        return self.view.view_num

    def _adopt(self, view: View) -> None:
        if self.view is not None and view.view_num <= self.view.view_num:
            return
        self.view = view
        self.pending = None
        if self._is_primary():
            if view.backup is not None:
                self.synced = False
                self.send(StateTransfer(view, clone(self.app)), view.backup)
            else:
                self.synced = True
        elif self._is_backup():
            self.synced = False  # wait for the state transfer
        else:
            self.synced = True

    # -------------------------------------------------------------- handlers

    def handle_ViewReply(self, m: ViewReply, sender: Address) -> None:
        self._adopt(m.view)

    def on_PingTimer(self, t: PingTimer) -> None:
        self.send(Ping(self._acked_view_num()), self.vsa)
        if self._is_primary() and self.view.backup is not None:
            if not self.synced:
                self.send(StateTransfer(self.view, clone(self.app)),
                          self.view.backup)
            elif self.pending is not None:
                self.send(ForwardRequest(self.view.view_num, self.pending[1]),
                          self.view.backup)
        self.set_timer(PingTimer(), PING_MILLIS)

    def handle_Request(self, m: Request, sender: Address) -> None:
        if not self._is_primary() or not self.synced:
            return  # not serving; the client retries
        if self.app.already_executed(m.command):
            result = self.app.execute(m.command)
            if result is not None:
                self.send(Reply(result), sender)
            return
        if self.view.backup is None:
            result = self.app.execute(m.command)
            if result is not None:
                self.send(Reply(result), sender)
            return
        if self.pending is not None:
            return  # one outstanding op at a time; client retries
        self.pending = (sender, m.command)
        self.send(ForwardRequest(self.view.view_num, m.command), self.view.backup)

    def handle_ForwardRequest(self, m: ForwardRequest, sender: Address) -> None:
        if (not self._is_backup() or m.view_num != self.view.view_num
                or not self.synced):
            return
        self.app.execute(m.command)  # AMO layer absorbs duplicates
        self.send(ForwardAck(m.view_num, m.command), sender)

    def handle_ForwardAck(self, m: ForwardAck, sender: Address) -> None:
        if (not self._is_primary() or self.view.view_num != m.view_num
                or self.pending is None or self.pending[1] != m.command):
            return
        client, command = self.pending
        self.pending = None
        result = self.app.execute(command)
        if result is not None:
            self.send(Reply(result), client)

    def handle_StateTransfer(self, m: StateTransfer, sender: Address) -> None:
        if m.view.backup != self.address:
            return
        self._adopt(m.view)  # the transfer may teach us the view itself
        if self.view.view_num != m.view.view_num:
            return  # we have adopted a newer view; stale transfer
        if not self.synced:
            self.app = clone(m.app)
            self.synced = True
        self.send(StateTransferAck(m.view.view_num), sender)

    def handle_StateTransferAck(self, m: StateTransferAck, sender: Address) -> None:
        if self._is_primary() and self.view.view_num == m.view_num:
            self.synced = True


class PBClient(SyncClientMixin, Node, Client):

    def __init__(self, address: Address, vsa: Address):
        super().__init__(address)
        self.vsa = vsa
        self.view: Optional[View] = None
        self.seq_num = 0
        self.pending: Optional[AMOCommand] = None
        self.result: Optional[Result] = None

    def init(self) -> None:
        self.send(GetView(), self.vsa)

    # ------------------------------------------------------ client interface

    def send_command(self, command: Command) -> None:
        self.seq_num += 1
        amo = AMOCommand(command, self.address, self.seq_num)
        self.pending = amo
        self.result = None
        self._send_pending()
        self.set_timer(ClientTimer(amo), CLIENT_RETRY_MILLIS)

    def has_result(self) -> bool:
        return self.result is not None

    def _take_result(self) -> Result:
        return self.result

    def _send_pending(self) -> None:
        if self.view is not None and self.view.primary is not None:
            self.send(Request(self.pending), self.view.primary)
        else:
            self.send(GetView(), self.vsa)

    # -------------------------------------------------------------- handlers

    def handle_ViewReply(self, m: ViewReply, sender: Address) -> None:
        if self.view is None or m.view.view_num > self.view.view_num:
            self.view = m.view
            if self.pending is not None:
                self._send_pending()

    def handle_Reply(self, m: Reply, sender: Address) -> None:
        if (self.pending is not None
                and m.result.sequence_num == self.pending.sequence_num):
            self.result = m.result.result
            self.pending = None
            self._notify_result()

    def on_ClientTimer(self, t: ClientTimer) -> None:
        if self.pending is not None and t.command == self.pending:
            self.send(GetView(), self.vsa)
            self._send_pending()
            self.set_timer(ClientTimer(self.pending), CLIENT_RETRY_MILLIS)
