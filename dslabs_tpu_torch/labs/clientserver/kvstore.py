"""The key-value store application.

Reference semantics: labs/lab1-clientserver/src/dslabs/kvstore/KVStore.java:13-80.
Commands: Get / Put / Append; results: GetResult / KeyNotFound / PutOk /
AppendResult (Append returns the post-append value).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from dslabs_tpu_torch.core.types import Application, Command, Result
from dslabs_tpu_torch.utils.structural import StructEq

__all__ = ["Get", "Put", "Append", "GetResult", "KeyNotFound", "PutOk",
           "AppendResult", "KVStore", "KVStoreCommand"]


class KVStoreCommand(Command):
    """Marker base for KVStore commands."""
    __slots__ = ()


@dataclass(frozen=True)
class Get(KVStoreCommand):
    key: str

    def read_only(self) -> bool:
        return True


@dataclass(frozen=True)
class Put(KVStoreCommand):
    key: str
    value: str


@dataclass(frozen=True)
class Append(KVStoreCommand):
    key: str
    value: str


@dataclass(frozen=True)
class GetResult(Result):
    value: str


@dataclass(frozen=True)
class KeyNotFound(Result):
    pass


@dataclass(frozen=True)
class PutOk(Result):
    pass


@dataclass(frozen=True)
class AppendResult(Result):
    value: str


class KVStore(Application, StructEq):

    def __init__(self, initial: Dict[str, str] = None):
        self.store: Dict[str, str] = dict(initial) if initial else {}

    def execute(self, command: Command) -> Result:
        if isinstance(command, Get):
            if command.key in self.store:
                return GetResult(self.store[command.key])
            return KeyNotFound()
        if isinstance(command, Put):
            self.store[command.key] = command.value
            return PutOk()
        if isinstance(command, Append):
            new_value = self.store.get(command.key, "") + command.value
            self.store[command.key] = new_value
            return AppendResult(new_value)
        raise ValueError(f"Unknown KVStore command: {command!r}")
