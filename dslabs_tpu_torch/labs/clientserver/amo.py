"""At-most-once application wrapper.

Reference semantics: labs/lab1-clientserver/src/dslabs/atmostonce/
(AMOApplication.java:15-48, AMOCommand.java, AMOResult.java).  Wraps any
Application; deduplicates by (client address, sequence number), caching the
last result per client.  Reused by labs 2-4 (SURVEY §2.8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from dslabs_tpu_torch.core.address import Address
from dslabs_tpu_torch.core.types import Application, Command, Result
from dslabs_tpu_torch.utils.structural import StructEq

__all__ = ["AMOCommand", "AMOResult", "AMOApplication"]


@dataclass(frozen=True)
class AMOCommand(Command):
    command: Command
    client_address: Address
    sequence_num: int


@dataclass(frozen=True)
class AMOResult(Result):
    result: Result
    sequence_num: int


class AMOApplication(Application, StructEq):
    """Deterministic at-most-once wrapper around an inner application."""

    def __init__(self, application: Application):
        self.application = application
        # client address -> (last executed seq num, its AMOResult)
        self.last: Dict[Address, Tuple[int, AMOResult]] = {}

    def execute(self, command: Command) -> AMOResult:
        assert isinstance(command, AMOCommand)
        if self.already_executed(command):
            stored = self.last[command.client_address]
            if stored[0] == command.sequence_num:
                return stored[1]
            # An older command: its result is gone; the reference returns null.
            return None
        result = AMOResult(self.application.execute(command.command),
                           command.sequence_num)
        self.last[command.client_address] = (command.sequence_num, result)
        return result

    def already_executed(self, command: AMOCommand) -> bool:
        stored = self.last.get(command.client_address)
        return stored is not None and command.sequence_num <= stored[0]

    def execute_read_only(self, command: Command) -> Result:
        """Execute a read-only command without AMO bookkeeping (used by
        protocols that bypass replication for reads)."""
        assert command.read_only()
        return self.application.execute(command)
