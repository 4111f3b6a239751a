"""Lab 1: exactly-once client/server on an unreliable network.

Reference semantics: labs/lab1-clientserver/src/dslabs/clientserver/
(SimpleClient.java:18, SimpleServer.java:16, Request/Reply messages,
ClientTimer 100ms — Timers.java).  The server wraps its application in
AMOApplication; the client stamps each command with a monotonically
increasing sequence number and retries on a 100ms timer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from dslabs_tpu_torch.core.address import Address
from dslabs_tpu_torch.core.client_utils import SyncClientMixin
from dslabs_tpu_torch.core.node import Node
from dslabs_tpu_torch.core.types import Application, Client, Command, Message, Result, Timer
from dslabs_tpu_torch.labs.clientserver.amo import AMOApplication, AMOCommand, AMOResult

__all__ = ["Request", "Reply", "ClientTimer", "SimpleClient", "SimpleServer",
           "CLIENT_RETRY_MS"]

CLIENT_RETRY_MS = 100  # lab1 Timers.java


@dataclass(frozen=True)
class Request(Message):
    command: AMOCommand


@dataclass(frozen=True)
class Reply(Message):
    result: AMOResult


@dataclass(frozen=True)
class ClientTimer(Timer):
    command: AMOCommand


class SimpleServer(Node):

    def __init__(self, address: Address, app: Application):
        super().__init__(address)
        self.app = AMOApplication(app)

    def init(self) -> None:
        pass

    def handle_Request(self, m: Request, sender: Address) -> None:
        result = self.app.execute(m.command)
        if result is not None:
            self.send(Reply(result), sender)


class SimpleClient(SyncClientMixin, Node, Client):

    def __init__(self, address: Address, server_address: Address):
        super().__init__(address)
        self.server_address = server_address
        self.seq_num = 0
        self.pending: Optional[AMOCommand] = None
        self.result: Optional[Result] = None

    def init(self) -> None:
        pass

    # ------------------------------------------------------ client interface

    def send_command(self, command: Command) -> None:
        self.seq_num += 1
        amo = AMOCommand(command, self.address, self.seq_num)
        self.pending = amo
        self.result = None
        self.send(Request(amo), self.server_address)
        self.set_timer(ClientTimer(amo), CLIENT_RETRY_MS)

    def has_result(self) -> bool:
        return self.result is not None

    def _take_result(self) -> Result:
        return self.result

    # -------------------------------------------------------------- handlers

    def handle_Reply(self, m: Reply, sender: Address) -> None:
        if (self.pending is not None
                and m.result.sequence_num == self.pending.sequence_num):
            self.result = m.result.result
            self.pending = None
            self._notify_result()

    def on_ClientTimer(self, t: ClientTimer) -> None:
        if self.pending is not None and t.command == self.pending:
            self.send(Request(self.pending), self.server_address)
            self.set_timer(ClientTimer(self.pending), CLIENT_RETRY_MS)
