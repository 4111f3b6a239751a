"""KVStore workload helpers and predicates.

Behavioural port of labs/lab1-clientserver/tst/dslabs/kvstore/
KVStoreWorkload.java:37-341 — the string command format, builders, the
different-keys infinite workload, and the APPENDS_LINEARIZABLE predicate.

String command format (shared with the reference's viz configs):
  ``GET:key`` / ``PUT:key:value`` / ``APPEND:key:value``
Result strings: ``KeyNotFound`` / ``PutOk`` / anything else is the expected
value (GetResult for GET, AppendResult for APPEND).
"""

from __future__ import annotations

import random
import string as _string
from typing import Dict, List, Optional, Tuple

from dslabs_tpu_torch.core.address import Address
from dslabs_tpu_torch.core.types import Command, Result
from dslabs_tpu_torch.labs.clientserver.kvstore import (Append, AppendResult, Get,
                                                  GetResult, KeyNotFound, Put,
                                                  PutOk)
from dslabs_tpu_torch.testing.predicates import StatePredicate
from dslabs_tpu_torch.testing.workload import Workload

__all__ = ["kv_parser", "kv_workload", "put", "get", "append", "put_ok",
           "get_result", "key_not_found", "append_result",
           "APPENDS_LINEARIZABLE", "appends_linearizable",
           "different_keys_infinite_workload", "put_get_workload",
           "append_different_key_workload", "append_same_key_workload",
           "simple_workload"]


# ------------------------------------------------------- command constructors

def put(key, value) -> Put:
    return Put(str(key), str(value))


def get(key) -> Get:
    return Get(str(key))


def append(key, value) -> Append:
    return Append(str(key), str(value))


def put_ok() -> PutOk:
    return PutOk()


def get_result(value) -> GetResult:
    return GetResult(str(value))


def key_not_found() -> KeyNotFound:
    return KeyNotFound()


def append_result(value) -> AppendResult:
    return AppendResult(str(value))


# ------------------------------------------------------------------- parsing

def parse_command(s: str) -> Command:
    parts = s.split(":", 2)
    op = parts[0].upper()
    if op == "GET":
        return Get(parts[1])
    if op == "PUT":
        return Put(parts[1], parts[2])
    if op == "APPEND":
        return Append(parts[1], parts[2])
    raise ValueError(f"Unknown KVStore command string: {s}")


def parse_result(command: Command, s: Optional[str]) -> Optional[Result]:
    if s is None:
        return None
    if s == "KeyNotFound":
        return KeyNotFound()
    if s == "PutOk" or isinstance(command, Put):
        return PutOk()
    if isinstance(command, Get):
        return GetResult(s)
    if isinstance(command, Append):
        return AppendResult(s)
    raise ValueError(f"Cannot parse result {s!r} for {command!r}")


def kv_parser(cmd: str, res: Optional[str]) -> Tuple[Command, Optional[Result]]:
    command = parse_command(cmd)
    return command, parse_result(command, res)


def kv_workload(commands: List[str], results: Optional[List[str]] = None,
                **kwargs) -> Workload:
    return Workload(command_strings=commands, result_strings=results,
                    parser=kv_parser, **kwargs)


# -------------------------------------------------------- standard workloads

def simple_workload() -> Workload:
    """The reference's simpleWorkload: a fixed hit-every-op sequence."""
    return kv_workload(
        ["PUT:key1:v1", "APPEND:key1:v2", "GET:key1", "GET:key2",
         "PUT:key2:v3", "APPEND:key2:v4", "GET:key2"],
        ["PutOk", "v1v2", "v1v2", "KeyNotFound", "PutOk", "v3v4", "v3v4"])


def put_get_workload() -> Workload:
    return kv_workload(["PUT:foo:bar", "GET:foo"], ["PutOk", "bar"])


def append_different_key_workload(size: int) -> Workload:
    """Each client appends to its own key (%a): results grow per client."""
    return kv_workload(
        ["APPEND:key-%a:x" for _ in range(size)],
        ["x" * (i + 1) for i in range(size)])


def append_same_key_workload(size: int) -> Workload:
    """All clients append distinct markers to one shared key; checked with
    APPENDS_LINEARIZABLE rather than exact expected results."""
    return kv_workload([f"APPEND:the-key:%a." for _ in range(size)])


class DifferentKeysInfiniteWorkload(Workload):
    """Alternating put/get on per-client keys, endlessly
    (KVStoreWorkload.java:222-271)."""

    def __init__(self, millis_between_requests: int = 0):
        super().__init__(commands=[Put("init", "x")], results=[PutOk()],
                         finite=False,
                         millis_between_requests=millis_between_requests)
        self._data: Dict[str, str] = {}
        self._last_was_get = True
        self._last_put_key: Optional[str] = None

    def _next_pair(self, a: Address):
        from dslabs_tpu_torch.testing.workload import derandomized, stream_rng

        if derandomized():
            # Counter-mode stream: the pair at index i is a pure
            # function of (a, i) — evens Put a fresh (key, value), odds
            # Get back the preceding Put's — so twin adapters can
            # re-derive any command for decode/staged replay
            # (testing/workload.py stream_rng).
            i = self._i
            self._i += 1
            rng = stream_rng(a, i - (i % 2))
            key = f"{a}-{rng.randint(1, 5)}"
            v = "".join(rng.choices(
                _string.ascii_letters + _string.digits, k=8))
            if i % 2 == 0:
                return Put(key, v), PutOk()
            return Get(key), GetResult(v)
        if self._last_was_get:
            self._last_put_key = f"{a}-{random.randint(1, 5)}"
            v = "".join(random.choices(_string.ascii_letters + _string.digits, k=8))
            self._data[self._last_put_key] = v
            self._last_was_get = False
            return Put(self._last_put_key, v), PutOk()
        self._last_was_get = True
        return (Get(self._last_put_key),
                GetResult(self._data[self._last_put_key]))

    def has_results(self) -> bool:
        return True

    def reset(self) -> None:
        super().reset()
        self._data.clear()
        self._last_was_get = True
        self._last_put_key = None


def different_keys_infinite_workload(millis_between_requests: int = 0) -> Workload:
    return DifferentKeysInfiniteWorkload(millis_between_requests)


# ------------------------------------------------------------------ predicate

def _appends_linearizable(addresses):
    def check(state):
        all_results: List[str] = []
        workers = state.client_workers()
        targets = addresses if addresses is not None else list(workers.keys())
        for a in targets:
            cw = workers[a]
            for c, r in zip(cw.sent_commands, cw.results):
                if not isinstance(c, Append):
                    raise RuntimeError("Client workers have non-Append commands")
                if not isinstance(r, AppendResult):
                    return False, f"{a} got {r!r} as result for {c!r}"
                if not r.value.endswith(c.value):
                    return False, f"{a} got {r!r} as result for {c!r}"
                all_results.append(r.value)
        all_results.sort(key=len)
        for x, y in zip(all_results, all_results[1:]):
            if not y.startswith(x) or x == y:
                return False, f"{x!r} is inconsistent with {y!r}"
        return True, None

    return StatePredicate(
        "Sequence of appends to the same key is linearizable", check,
        tkey=("RESULTS_LINEARIZABLE",))


APPENDS_LINEARIZABLE = _appends_linearizable(None)


def appends_linearizable(*addresses) -> StatePredicate:
    return _appends_linearizable(list(addresses))
