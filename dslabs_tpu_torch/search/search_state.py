"""SearchState: one vertex of the global system state graph.

Re-design of framework/tst/.../search/SearchState.java:69-631.  The semantics
the TPU backend must reproduce bit-for-bit (SURVEY §7):

  * The network is a **set** of (from, to, message) envelopes: duplicate sends
    collapse; delivering a message does NOT remove it (drop/dup/reorder are
    modeled implicitly by which events a path chooses to deliver).
  * ``dropped_network`` holds temporarily ignored messages that are not
    enumerable as events but still count toward state equality.
  * Successor construction clones only the stepped node and its timer queue
    (copy-on-write); message/timer payloads are cloned on send and again on
    delivery.
  * Search equivalence = state equality (nodes + network∪dropped + timers)
    + thrown-exception equality + (when drops are present) live-network
    equality — the wrapper at SearchState.java:576-619.

Implementation notes: the network uses an insertion-ordered dict-as-set so
event enumeration is deterministic; Java's HashSet order is hash-dependent,
which only affects tie-breaking among equally valid verdicts.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple, Union

from dslabs_tpu_torch.core.address import Address
from dslabs_tpu_torch.core.node import Node, NodeConfig
from dslabs_tpu_torch.testing.client_worker import ClientWorker
from dslabs_tpu_torch.testing.events import Event, MessageEnvelope, TimerEnvelope
from dslabs_tpu_torch.testing.generator import NodeGenerator
from dslabs_tpu_torch.testing.state import AbstractState
from dslabs_tpu_torch.utils.structural import clone, sfreeze

__all__ = ["SearchState"]


def _exc_key(e: Optional[BaseException]):
    if e is None:
        return None
    return (type(e).__qualname__, tuple(repr(a) for a in e.args))


class SearchState(AbstractState):

    def __init__(self, generator: NodeGenerator):
        super().__init__(generator)
        self._network: Dict[MessageEnvelope, None] = {}
        self._dropped: Dict[MessageEnvelope, None] = {}
        self._timers: Dict[Address, "TimerQueue"] = {}
        self._previous: Optional["SearchState"] = None
        self._previous_event: Optional[Event] = None
        self._depth = 0
        self._thrown_exception: Optional[BaseException] = None
        self._new_messages: List[MessageEnvelope] = []
        self._new_timers: List[TimerEnvelope] = []

    # ----------------------------------------------------------- construction

    @classmethod
    def _successor(cls, previous: "SearchState", address_to_clone: Address,
                   event: Event) -> "SearchState":
        """COW successor: share all nodes but ``address_to_clone``; copy the
        network sets shallowly and that node's timer queue
        (SearchState.java:104-122)."""
        from dslabs_tpu_torch.search.timer_queue import TimerQueue
        ns: SearchState = cls._cow_copy(previous, address_to_clone)
        ns._network = dict(previous._network)
        ns._dropped = dict(previous._dropped)
        ns._timers = dict(previous._timers)
        ns._previous = previous
        ns._previous_event = event
        ns._depth = previous._depth + 1
        ns._thrown_exception = None
        ns._new_messages = []
        ns._new_timers = []
        ns._timers[address_to_clone] = TimerQueue(ns._timers.get(address_to_clone))
        ns._config_node(address_to_clone)
        return ns

    def shallow_clone(self) -> "SearchState":
        """Shallow COW clone sharing nodes and the parent pointer
        (SearchState.java:126-151); used by staged searches to tweak
        network/drop sets without disturbing the original."""
        ns: SearchState = type(self)._cow_copy(self, _NO_ADDRESS)
        ns._network = dict(self._network)
        ns._dropped = dict(self._dropped)
        ns._timers = dict(self._timers)
        ns._previous = self._previous
        ns._previous_event = self._previous_event
        ns._depth = self._depth
        ns._thrown_exception = self._thrown_exception
        ns._new_messages = list(self._new_messages)
        ns._new_timers = list(self._new_timers)
        return ns

    # -------------------------------------------------------------- equality

    def _eq_fields(self):
        f = super()._eq_fields()
        f["network"] = set(self._network) | set(self._dropped)
        f["timers"] = self._timers
        return f

    def search_equivalence_key(self):
        """Hashable key implementing search equivalence
        (SearchState.java:576-619): base equality + exception + live network
        when drops are in play."""
        base = (
            sfreeze(self.servers),
            sfreeze(self.client_workers_map),
            sfreeze(self.clients),
            frozenset(sfreeze(m) for m in self._network) | frozenset(
                sfreeze(m) for m in self._dropped),
            sfreeze(self._timers),
            _exc_key(self._thrown_exception),
        )
        if self._dropped:
            return base + (frozenset(sfreeze(m) for m in self._network),)
        return base

    # ------------------------------------------------------------- accessors

    @property
    def previous(self) -> Optional["SearchState"]:
        return self._previous

    @property
    def previous_event(self) -> Optional[Event]:
        return self._previous_event

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def thrown_exception(self) -> Optional[BaseException]:
        return self._thrown_exception

    @property
    def new_messages(self) -> List[MessageEnvelope]:
        return self._new_messages

    @property
    def new_timers(self) -> List[TimerEnvelope]:
        return self._new_timers

    def network(self) -> Iterable[MessageEnvelope]:
        """Union of live and dropped messages (state-equality view)."""
        yield from self._network
        yield from self._dropped

    def live_network(self) -> Iterable[MessageEnvelope]:
        return iter(self._network)

    def timers(self, address: Address):
        return self._timers[address.root_address()]

    # -------------------------------------------------------- engine contract

    def _setup_node(self, address: Address) -> None:
        from dslabs_tpu_torch.search.timer_queue import TimerQueue
        node = self.node(address)
        if isinstance(node, ClientWorker) and not node.record_commands_and_results:
            raise RuntimeError(
                "Cannot add a ClientWorker that does not store results to SearchState.")
        self._timers[address] = TimerQueue()
        self._config_node(address)
        node.init()

    def _ensure_node_config(self, address: Address) -> None:
        self._config_node(address)

    def _cleanup_node(self, address: Address) -> None:
        raise RuntimeError("Cannot remove nodes from search state.")

    def _config_node(self, address: Address) -> None:
        """Wire send/set/throw hooks into the node (SearchState.java:189-224):
        messages are cloned on send and inserted set-wise; timers appended to
        the owner's queue; exceptions recorded on this state."""
        state = self

        def message_adder(frm: Address, to: Address, message) -> None:
            env = MessageEnvelope(frm, to, clone(message))
            state._network[env] = None
            state._new_messages.append(env)

        def batch_message_adder(frm: Address, tos: Tuple[Address, ...], message) -> None:
            m = clone(message)
            for to in tos:
                env = MessageEnvelope(frm, to, m)
                state._network[env] = None
                state._new_messages.append(env)

        def timer_adder(frm: Address, timer, min_ms: int, max_ms: int) -> None:
            env = TimerEnvelope(frm, clone(timer), min_ms, max_ms)
            state._timers[env.to.root_address()].add(env)
            state._new_timers.append(env)

        def throwable_catcher(t: BaseException) -> None:
            assert state._thrown_exception is None
            state._thrown_exception = t

        self.node(address).config(NodeConfig(
            message_adder=message_adder,
            batch_message_adder=batch_message_adder,
            timer_adder=timer_adder,
            throwable_catcher=throwable_catcher,
            log_exceptions=False))

    # ---------------------------------------------------------------- events

    def events(self, settings=None) -> List[Event]:
        """Enumerate deliverable events (SearchState.java:226-252): live
        messages whose destination exists and passes ``should_deliver``, then
        deliverable timers per node, gated by timer delivery settings."""
        from dslabs_tpu_torch.search.settings import SearchSettings
        if settings is None:
            settings = SearchSettings()
        events: List[Event] = []
        for message in self._network:
            if (self.has_node(message.to.root_address())
                    and settings.should_deliver(message)):
                events.append(message)
        for address in self.addresses():
            if settings.should_deliver_timer(address):
                events.extend(self._timers[address].deliverable())
        return events

    def step(self, settings=None) -> List["SearchState"]:
        return [self.step_event(e, settings, skip_checks=True)
                for e in self.events(settings)]

    def step_event(self, event: Event, settings=None,
                   skip_checks: bool = False) -> Optional["SearchState"]:
        if isinstance(event, MessageEnvelope):
            return self.step_message(event, settings, skip_checks)
        return self.step_timer(event, settings, skip_checks)

    def step_message(self, message: MessageEnvelope, settings=None,
                     skip_checks: bool = False) -> Optional["SearchState"]:
        from dslabs_tpu_torch.search.settings import SearchSettings
        if settings is None:
            settings = SearchSettings()
        to = message.to.root_address()
        if not self.has_node(to):
            return None
        if not skip_checks and not (message in self._network
                                    and settings.should_deliver(message)):
            return None
        ns = SearchState._successor(self, to, message)
        # Deliver a *clone* of the payload; the message stays in the network
        # ("Just handle, don't remove" — SearchState.java:300).
        nm = clone(message.message)
        ns.node(to).deliver_message(nm, message.frm, message.to)
        return ns

    def can_step_timer(self, timer: TimerEnvelope, settings=None) -> bool:
        from dslabs_tpu_torch.search.settings import SearchSettings
        if settings is None:
            settings = SearchSettings()
        to = timer.to.root_address()
        return (self.has_node(to) and settings.should_deliver_timer(to)
                and self._timers[to].is_deliverable(timer))

    def step_timer(self, timer: TimerEnvelope, settings=None,
                   skip_checks: bool = False) -> Optional["SearchState"]:
        to = timer.to.root_address()
        if not self.has_node(to):
            return None
        if not skip_checks and not self.can_step_timer(timer, settings):
            return None
        ns = SearchState._successor(self, to, timer)
        nt = clone(timer.timer)
        ns.node(to).deliver_timer(nt, timer.to)
        ns._timers[to].remove(timer)  # firing consumes the timer
        return ns

    # ----------------------------------------------------------------- drops

    def _record_staged_op(self, op: tuple) -> None:
        """Mirror a staged network mutation into this state's tensor
        provenance (tpu/backend.py), so the next tensor-backend phase can
        re-derive its twin root by replaying the same op.  Ops on a state
        with no provenance yet (e.g. drop_pending_messages on the pristine
        initial state) accumulate in ``_staged_ops`` and are picked up by
        the backend's depth-0 path."""
        tp = getattr(self, "_tensor_provenance", None)
        if tp is not None:
            tp.history.append(op)
        else:
            if not hasattr(self, "_staged_ops"):
                self._staged_ops = []
            self._staged_ops.append(op)

    def drop_pending_messages(self) -> None:
        """Temporarily ignore all pending messages (used by staged searches,
        SearchState.java:534-541)."""
        self._dropped.update(self._network)
        self._network.clear()
        self._record_staged_op(("drop",))

    def undrop_messages(self) -> None:
        self._network.update(self._dropped)
        self._record_staged_op(("undrop_all",))

    def undrop_messages_from(self, address: Address) -> None:
        for m in self._dropped:
            if m.frm == address:
                self._network[m] = None
        self._record_staged_op(("undrop_from", str(address.root_address())))

    def undrop_messages_to(self, address: Address) -> None:
        for m in self._dropped:
            if m.to == address:
                self._network[m] = None
        self._record_staged_op(("undrop_to", str(address.root_address())))

    # ---------------------------------------------------------------- traces

    def trace(self) -> List["SearchState"]:
        out: List[SearchState] = []
        cur: Optional[SearchState] = self
        while cur is not None:
            out.append(cur)
            cur = cur._previous
        out.reverse()
        return out

    def print_trace(self, out=None) -> None:
        import sys
        out = out or sys.stderr
        for state in self.trace():
            if state._previous_event is not None:
                print(f"\t{state._previous_event}", file=out)
            print(state, file=out)

    def __repr__(self) -> str:
        nodes = ", ".join(f"{a}={self.node(a)!r}" for a in self.addresses())
        return (f"State(nodes={{{nodes}}}, network={list(self.network())}, "
                f"timers={self._timers})")


class _NoAddress:
    def root_address(self):
        return self


_NO_ADDRESS = _NoAddress()
