"""Lab 0: ping-pong — the canonical minimal node pair.

Reference implementation mirroring labs/lab0-pingpong/src/dslabs/pingpong/
(PingApplication.java:13-34, PingServer.java:11-33, PingClient.java:18-88,
Messages.java:9-16, Timers.java:8).  The reference ships this lab complete;
it is the example every other lab builds on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from dslabs_tpu_torch.core.address import Address
from dslabs_tpu_torch.core.client_utils import SyncClientMixin
from dslabs_tpu_torch.core.node import Node
from dslabs_tpu_torch.core.types import (Application, Client, Command, Message,
                                   Result, Timer)

__all__ = ["Ping", "Pong", "PingApplication", "PingRequest", "PongReply",
           "PingTimer", "PingServer", "PingClient", "PING_TIMER_MS"]

PING_TIMER_MS = 10  # Timers.java:8


@dataclass(frozen=True)
class Ping(Command):
    value: str


@dataclass(frozen=True)
class Pong(Result):
    value: str


class PingApplication(Application):
    """Ping -> Pong echo (PingApplication.java:13-34)."""

    def execute(self, command: Command) -> Result:
        assert isinstance(command, Ping)
        return Pong(command.value)

    def __eq__(self, other):
        return type(other) is PingApplication

    def __hash__(self):
        return hash("PingApplication")


@dataclass(frozen=True)
class PingRequest(Message):
    ping: Ping


@dataclass(frozen=True)
class PongReply(Message):
    pong: Pong


@dataclass(frozen=True)
class PingTimer(Timer):
    ping: Ping


class PingServer(Node):
    """Stateless executor of the PingApplication (PingServer.java:11-33)."""

    def __init__(self, address: Address):
        super().__init__(address)
        self.app = PingApplication()

    def init(self) -> None:
        pass

    def handle_PingRequest(self, m: PingRequest, sender: Address) -> None:
        pong = self.app.execute(m.ping)
        self.send(PongReply(pong), sender)


class PingClient(SyncClientMixin, Node, Client):
    """Sends pings, retries on a 10ms timer (PingClient.java:18-88)."""

    def __init__(self, address: Address, server_address: Address):
        super().__init__(address)
        self.server_address = server_address
        self.ping: Optional[Ping] = None
        self.pong: Optional[Pong] = None

    def init(self) -> None:
        pass

    # -------------------------------------------------------- client interface

    def send_command(self, command: Command) -> None:
        assert isinstance(command, Ping)
        self.ping = command
        self.pong = None
        self.send(PingRequest(command), self.server_address)
        self.set_timer(PingTimer(command), PING_TIMER_MS)

    def has_result(self) -> bool:
        return self.pong is not None

    def _take_result(self) -> Result:
        return self.pong

    # --------------------------------------------------------------- handlers

    def handle_PongReply(self, m: PongReply, sender: Address) -> None:
        if self.ping is not None and m.pong.value == self.ping.value:
            self.pong = m.pong
            self.ping = None
            self._notify_result()

    def on_PingTimer(self, t: PingTimer) -> None:
        if self.ping is not None and t.ping == self.ping:
            self.send(PingRequest(self.ping), self.server_address)
            self.set_timer(PingTimer(self.ping), PING_TIMER_MS)
