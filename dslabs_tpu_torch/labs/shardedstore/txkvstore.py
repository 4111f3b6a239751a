"""Lab 4, part 2a: the transactional key-value store application.

Behavioural port of labs/lab4-shardedstore/src/dslabs/kvstore/
TransactionalKVStore.java:16-152.  A Transaction is a single-round command
with a-priori read/write sets and a pure ``run(db)`` over the values of its
key set; MultiGet / MultiPut / Swap are the concrete transactions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Tuple

from dslabs_tpu_torch.core.types import Command, Result
from dslabs_tpu_torch.labs.clientserver.kvstore import KVStore, KVStoreCommand

__all__ = ["Transaction", "MultiGet", "MultiPut", "Swap", "MultiGetResult",
           "MultiPutOk", "SwapOk", "TransactionalKVStore", "KEY_NOT_FOUND"]

KEY_NOT_FOUND = "KeyNotFound"


class Transaction(KVStoreCommand):
    """Single-round transaction: read/write sets known a priori."""

    def read_set(self) -> FrozenSet[str]:
        raise NotImplementedError

    def write_set(self) -> FrozenSet[str]:
        raise NotImplementedError

    def key_set(self) -> FrozenSet[str]:
        return self.read_set() | self.write_set()

    def run(self, db: Dict[str, str]) -> Result:
        """Mutate ``db`` (the current values of key_set) in place; return
        the transaction's result."""
        raise NotImplementedError

    def read_only(self) -> bool:
        return not self.write_set()


@dataclass(frozen=True)
class MultiGet(Transaction):
    keys: FrozenSet[str]

    def __init__(self, keys):
        object.__setattr__(self, "keys", frozenset(keys))

    def read_set(self) -> FrozenSet[str]:
        return self.keys

    def write_set(self) -> FrozenSet[str]:
        return frozenset()

    def run(self, db: Dict[str, str]) -> Result:
        return MultiGetResult(
            {k: db.get(k, KEY_NOT_FOUND) for k in self.keys})


@dataclass(frozen=True)
class MultiPut(Transaction):
    values: Tuple[Tuple[str, str], ...]

    def __init__(self, values):
        if isinstance(values, dict):
            values = tuple(sorted(values.items()))
        object.__setattr__(self, "values", values)

    def read_set(self) -> FrozenSet[str]:
        return frozenset()

    def write_set(self) -> FrozenSet[str]:
        return frozenset(k for k, _ in self.values)

    def run(self, db: Dict[str, str]) -> Result:
        db.update(dict(self.values))
        return MultiPutOk()


@dataclass(frozen=True)
class Swap(Transaction):
    key1: str
    key2: str

    def read_set(self) -> FrozenSet[str]:
        return frozenset((self.key1, self.key2))

    def write_set(self) -> FrozenSet[str]:
        return self.read_set()

    def run(self, db: Dict[str, str]) -> Result:
        v1, v2 = db.get(self.key1), db.get(self.key2)
        if v2 is None:
            db.pop(self.key1, None)
        else:
            db[self.key1] = v2
        if v1 is None:
            db.pop(self.key2, None)
        else:
            db[self.key2] = v1
        return SwapOk()


@dataclass(frozen=True)
class MultiGetResult(Result):
    values: Tuple[Tuple[str, str], ...]

    def __init__(self, values):
        if isinstance(values, dict):
            values = tuple(sorted(values.items()))
        object.__setattr__(self, "values", values)

    def as_dict(self) -> Dict[str, str]:
        return dict(self.values)


@dataclass(frozen=True)
class MultiPutOk(Result):
    pass


@dataclass(frozen=True)
class SwapOk(Result):
    pass


class TransactionalKVStore(KVStore):

    def execute(self, command: Command) -> Result:
        if isinstance(command, Transaction):
            # Materialise the key-set view, run, and write back the writes.
            db = {k: self.store[k] for k in command.key_set()
                  if k in self.store}
            result = command.run(db)
            for k in command.write_set():
                if k in db:
                    self.store[k] = db[k]
                else:
                    self.store.pop(k, None)
            return result
        return super().execute(command)
