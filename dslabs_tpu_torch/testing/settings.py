"""Base test settings: invariants, time limits, network connectivity matrix.

Re-design of framework/tst/.../TestSettings.java:46-269.  Settings *gate
events*, never mutate state (SURVEY §7.7): the same state can be re-searched
under different settings (staged search).

``should_deliver`` resolution priority (TestSettings.java:224-245):
  per-link override  >  sender override  >  receiver override  >  global flag.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from dslabs_tpu_torch.core.address import Address
from dslabs_tpu_torch.testing.predicates import PredicateResult, StatePredicate

__all__ = ["TestSettings"]


class TestSettings:
    """Fluent, self-typed settings base shared by run and search settings."""

    def __init__(self):
        self.invariants: List[StatePredicate] = []
        self.max_time_secs: Optional[float] = None
        self.single_threaded: bool = False
        self.deliver_timers_default: bool = True
        self._timer_delivery: Dict[Address, bool] = {}
        # Connectivity: None = unset at that level
        self._link_active: Dict[Tuple[Address, Address], bool] = {}
        self._sender_active: Dict[Address, bool] = {}
        self._receiver_active: Dict[Address, bool] = {}
        self._network_active: bool = True

    # ------------------------------------------------------------- invariants

    def add_invariant(self, predicate: StatePredicate) -> "TestSettings":
        self.invariants.append(predicate)
        return self

    def clear_invariants(self) -> "TestSettings":
        self.invariants.clear()
        return self

    def invariants_hold(self, state) -> Optional[PredicateResult]:
        """Return None if all invariants hold, else the first failure.
        Invariant exceptions count as violations (TestSettings.java:130-138)."""
        for inv in self.invariants:
            r = inv.test(state, expected=True)
            if r is not None:
                return r
        return None

    def invariant_violated(self, state) -> Optional[PredicateResult]:
        return self.invariants_hold(state)

    # ------------------------------------------------------------------- time

    def max_time(self, secs: float) -> "TestSettings":
        self.max_time_secs = secs
        return self

    def set_single_threaded(self, value: bool = True) -> "TestSettings":
        self.single_threaded = value
        return self

    # ------------------------------------------------------------------ timers

    def deliver_timers(self, address_or_flag, value: Optional[bool] = None) -> "TestSettings":
        """``deliver_timers(False)`` gates all timers; ``deliver_timers(addr,
        False)`` gates one node's timers (TestSettings.java:76-94)."""
        if isinstance(address_or_flag, bool):
            self.deliver_timers_default = address_or_flag
            self._timer_delivery.clear()
        else:
            assert value is not None
            self._timer_delivery[address_or_flag] = value
        return self

    def clear_deliver_timers(self) -> "TestSettings":
        """Reset all per-address timer gating (TestSettings.java:94)."""
        self.deliver_timers_default = True
        self._timer_delivery.clear()
        return self

    def should_deliver_timer(self, to: Address) -> bool:
        return self._timer_delivery.get(to.root_address(),
                                        self.deliver_timers_default)

    # ---------------------------------------------------------------- network

    def network_active(self, active: bool = True) -> "TestSettings":
        self._network_active = active
        return self

    def link_active(self, frm: Address, to: Address, active: bool) -> "TestSettings":
        self._link_active[(frm.root_address(), to.root_address())] = active
        return self

    def sender_active(self, frm: Address, active: bool) -> "TestSettings":
        self._sender_active[frm.root_address()] = active
        return self

    def receiver_active(self, to: Address, active: bool) -> "TestSettings":
        self._receiver_active[to.root_address()] = active
        return self

    def node_active(self, address: Address, active: bool) -> "TestSettings":
        """Convenience: gate a node both as sender and receiver."""
        return self.sender_active(address, active).receiver_active(address, active)

    def partition(self, *addresses) -> "TestSettings":
        """Keep only links internal to the given partition: every node is
        deactivated as sender+receiver, then intra-partition links are
        re-activated (TestSettings.java:181-198)."""
        if len(addresses) == 1 and isinstance(addresses[0], (list, tuple, set)):
            addresses = tuple(addresses[0])
        part = [a.root_address() for a in addresses]
        self._network_active = False
        self._link_active.clear()
        self._sender_active.clear()
        self._receiver_active.clear()
        for a in part:
            for b in part:
                if a != b:
                    self._link_active[(a, b)] = True
        return self

    def reconnect(self) -> "TestSettings":
        """Clear all connectivity overrides (TestSettings.java:204-210)."""
        self._network_active = True
        self._link_active.clear()
        self._sender_active.clear()
        self._receiver_active.clear()
        return self

    def should_deliver(self, envelope) -> bool:
        """Connectivity check for a message envelope (TestSettings.java:224-245)."""
        frm = envelope.frm.root_address()
        to = envelope.to.root_address()
        link = self._link_active.get((frm, to))
        if link is not None:
            return link
        sender = self._sender_active.get(frm)
        if sender is not None:
            return sender
        receiver = self._receiver_active.get(to)
        if receiver is not None:
            return receiver
        return self._network_active
