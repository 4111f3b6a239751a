"""Marker types of the public protocol API.

Mirrors framework/src/dslabs/framework/{Message,Timer,Command,Result,
Application,Client}.java.  Messages/timers/commands/results are plain data;
protocol code typically declares them as frozen dataclasses.
"""

from __future__ import annotations

import abc
from typing import Optional

__all__ = ["Message", "Timer", "Command", "Result", "Application", "Client"]


class Message:
    """Marker base for protocol messages (Message.java:34)."""
    __slots__ = ()


class Timer:
    """Marker base for protocol timers (Timer.java:37)."""
    __slots__ = ()


class Command:
    """Marker base for application commands (Command.java:28-35)."""
    __slots__ = ()

    def read_only(self) -> bool:
        """Commands default to read-write; read-only commands may skip
        replication (used by lab3/lab4)."""
        return False


class Result:
    """Marker base for application results (Result.java:28)."""
    __slots__ = ()


class Application(abc.ABC):
    """A deterministic state machine (Application.java:33-42).

    ``execute`` must be a pure function of (state, command): same command on
    equal states yields equal results and equal successor states.
    """

    @abc.abstractmethod
    def execute(self, command: Command) -> Result:
        ...


class Client(abc.ABC):
    """Interface implemented by client *nodes* (Client.java:41-71).

    Contract: ``send_command`` and ``has_result`` are non-blocking;
    ``get_result`` blocks until the result of the most recently sent command is
    available (real-time runner only — the model checker drives clients through
    the non-blocking half).
    """

    @abc.abstractmethod
    def send_command(self, command: Command) -> None:
        ...

    @abc.abstractmethod
    def has_result(self) -> bool:
        ...

    @abc.abstractmethod
    def get_result(self, timeout: Optional[float] = None) -> Result:
        ...
