"""State predicates: named checks over a system state.

Re-design of framework/tst/.../StatePredicate.java:46-438.  A predicate maps a
state to (truth value, detail string); exceptions during evaluation are
captured in the PredicateResult (StatePredicate.java:257-340) and interpreted
by the search layer (invariant exception => violation; prune exception =>
pruned; goal exception => ignored — SearchSettings.java:77-135).

The standard library (RESULTS_OK, NONE_DECIDED, CLIENTS_DONE, ...) is ported
behaviourally from StatePredicate.java:52-156.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional, Tuple

__all__ = ["PredicateResult", "StatePredicate", "RESULTS_OK", "NONE_DECIDED",
           "CLIENTS_DONE", "ALL_RESULTS_SAME", "client_done",
           "client_has_results", "all_results_match", "any_results_match",
           "contains_message_matching", "results_have_type"]


class PredicateResult:
    """Outcome of evaluating a predicate on a state."""

    __slots__ = ("predicate", "value", "detail", "exception")

    def __init__(self, predicate: "StatePredicate", value: bool,
                 detail: Optional[str] = None,
                 exception: Optional[BaseException] = None):
        self.predicate = predicate
        self.value = value
        self.detail = detail
        self.exception = exception

    @property
    def exception_thrown(self) -> bool:
        return self.exception is not None

    def error_message(self) -> str:
        if self.exception is not None:
            return (f"Exception thrown while evaluating \"{self.predicate.name}\""
                    f": {self.exception!r}")
        verb = "holds" if self.value else "violated"
        msg = f"Predicate \"{self.predicate.name}\" {verb}"
        if self.detail:
            msg += f" ({self.detail})"
        return msg

    def __repr__(self) -> str:
        return f"PredicateResult({self.predicate.name!r}, {self.value}, {self.detail!r})"


class StatePredicate:
    """Named predicate over a state.

    ``fn(state)`` may return a bool or a (bool, detail) tuple.  Combinators
    negate/and/or/implies mirror StatePredicate.java:382-432.
    """

    def __init__(self, name: str, fn: Callable[[Any], Any],
                 tkey: Any = None):
        self.name = name
        self._fn = fn
        # Tensor-translation metadata (SURVEY §8.1 "the TPU backend is a
        # new Search strategy selectable by settings"): ``tkey`` names a
        # primitive predicate for the tensor backend's twin adapters
        # (e.g. ("PAXOS_HAS_STATUS", addr, slot, status)); ``structure``
        # records combinator shape so compound predicates translate
        # structurally.  Both are inert on the object path.
        self.tkey = tkey
        self.structure = None

    def check(self, state: Any) -> PredicateResult:
        """Full evaluation, capturing exceptions."""
        try:
            out = self._fn(state)
        except Exception as e:  # noqa: BLE001 — predicate sandbox
            return PredicateResult(self, False, None, e)
        if isinstance(out, tuple):
            value, detail = out
        else:
            value, detail = bool(out), None
        return PredicateResult(self, bool(value), detail)

    def test(self, state: Any, expected: bool = True) -> Optional[PredicateResult]:
        """Fast path: return None when the predicate evaluates to ``expected``
        with no exception; otherwise the full result
        (StatePredicate.java:368-380)."""
        r = self.check(state)
        if r.exception is None and r.value == expected:
            return None
        return r

    # ----------------------------------------------------------- combinators

    def negate(self) -> "StatePredicate":
        p = StatePredicate(f"not ({self.name})",
                           lambda s: not self.check_raises(s))
        p.structure = ("not", self)
        return p

    def check_raises(self, state: Any) -> bool:
        r = self.check(state)
        if r.exception is not None:
            raise r.exception
        return r.value

    def and_(self, other: "StatePredicate") -> "StatePredicate":
        p = StatePredicate(f"({self.name}) and ({other.name})",
                           lambda s: self.check_raises(s) and other.check_raises(s))
        p.structure = ("and", self, other)
        return p

    def or_(self, other: "StatePredicate") -> "StatePredicate":
        p = StatePredicate(f"({self.name}) or ({other.name})",
                           lambda s: self.check_raises(s) or other.check_raises(s))
        p.structure = ("or", self, other)
        return p

    def implies(self, other: "StatePredicate") -> "StatePredicate":
        p = StatePredicate(f"({self.name}) implies ({other.name})",
                           lambda s: (not self.check_raises(s)) or other.check_raises(s))
        p.structure = ("implies", self, other)
        return p

    def __repr__(self) -> str:
        return f"StatePredicate({self.name!r})"


# --------------------------------------------------------------- the library
# Behavioural ports of StatePredicate.java:52-156.  These operate on any state
# exposing .client_workers() -> dict addr->ClientWorker and .network() (for the
# message predicate).

def _results_ok(state) -> Tuple[bool, Optional[str]]:
    for addr, worker in state.client_workers().items():
        ok, detail = worker.results_ok()
        if not ok:
            return False, f"client {addr}: {detail}"
    return True, None


RESULTS_OK = StatePredicate("Clients got expected results", _results_ok,
                            tkey=("RESULTS_OK",))

NONE_DECIDED = StatePredicate(
    "No results returned",
    lambda state: all(len(w.results) == 0 for w in state.client_workers().values()),
    tkey=("NONE_DECIDED",))

CLIENTS_DONE = StatePredicate(
    "All clients done",
    lambda state: all(w.done() for w in state.client_workers().values()),
    tkey=("CLIENTS_DONE",))


def client_done(address) -> StatePredicate:
    return StatePredicate(
        f"Client {address} done",
        lambda state: state.client_workers()[address].done(),
        tkey=("CLIENT_DONE", address))


def client_has_results(address, num_results: int) -> StatePredicate:
    return StatePredicate(
        f"Client {address} has {num_results} result(s)",
        lambda state: len(state.client_workers()[address].results) >= num_results,
        tkey=("CLIENT_HAS_RESULTS", address, num_results))


def _all_results_same(state) -> Tuple[bool, Optional[str]]:
    seen = None
    for addr, w in state.client_workers().items():
        r = tuple(w.results)
        if seen is None:
            seen = (addr, r)
        elif seen[1] != r:
            return False, f"{seen[0]} saw {seen[1]}, {addr} saw {r}"
    return True, None


ALL_RESULTS_SAME = StatePredicate("All clients' results same",
                                  _all_results_same,
                                  tkey=("ALL_RESULTS_SAME",))


def all_results_match(predicate: Callable[[Any], bool],
                      name: str = "All results match") -> StatePredicate:
    return StatePredicate(name, lambda state: all(
        predicate(r) for w in state.client_workers().values() for r in w.results))


def any_results_match(predicate: Callable[[Any], bool],
                      name: str = "Some result matches") -> StatePredicate:
    return StatePredicate(name, lambda state: any(
        predicate(r) for w in state.client_workers().values() for r in w.results))


def contains_message_matching(name: str,
                              predicate: Callable[[Any], bool]) -> StatePredicate:
    return StatePredicate(
        f"Contains message matching: {name}",
        lambda state: any(predicate(me.message) for me in state.network()))


def results_have_type(result_type: type) -> StatePredicate:
    return all_results_match(
        lambda r: isinstance(r, result_type),
        name=f"All results are {result_type.__name__}")
