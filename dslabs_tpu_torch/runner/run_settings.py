"""Run settings: probabilistic message delivery on top of connectivity.

Re-design of framework/tst/.../runner/RunSettings.java:41-200.
``should_deliver`` = connectivity (TestSettings) then a Bernoulli draw with
rate resolved by priority: link > sender > receiver > global.  Self-addressed
messages always deliver.  ``network_unreliable(True)`` sets the global rate
to 0.5.  A rate > 1.0 is the reference's "explicitly reliable" placeholder.
"""

from __future__ import annotations

import random
from typing import Dict, Optional, Tuple

from dslabs_tpu_torch.core.address import Address
from dslabs_tpu_torch.testing.settings import TestSettings

__all__ = ["RunSettings"]

DEFAULT_UNRELIABLE_RATE = 0.5


class RunSettings(TestSettings):

    def __init__(self):
        super().__init__()
        self.wait_for_clients: bool = True
        self._link_rate: Dict[Tuple[Address, Address], float] = {}
        self._sender_rate: Dict[Address, float] = {}
        self._receiver_rate: Dict[Address, float] = {}
        self._network_rate: Optional[float] = None

    # ----------------------------------------------------------------- rates

    @staticmethod
    def _check_rate(rate: float) -> float:
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"Deliver rate must be in [0, 1]: {rate}")
        return rate

    def network_deliver_rate(self, rate: float) -> "RunSettings":
        self._network_rate = self._check_rate(rate)
        return self

    def network_unreliable(self, unreliable: bool) -> "RunSettings":
        if unreliable and self._network_rate is None:
            self._network_rate = DEFAULT_UNRELIABLE_RATE
        elif not unreliable:
            self._network_rate = None
        return self

    def link_deliver_rate(self, frm: Address, to: Address, rate: float) -> "RunSettings":
        self._link_rate[(frm.root_address(), to.root_address())] = self._check_rate(rate)
        return self

    def sender_deliver_rate(self, frm: Address, rate: float) -> "RunSettings":
        self._sender_rate[frm.root_address()] = self._check_rate(rate)
        return self

    def receiver_deliver_rate(self, to: Address, rate: float) -> "RunSettings":
        self._receiver_rate[to.root_address()] = self._check_rate(rate)
        return self

    def node_deliver_rate(self, node: Address, rate: float) -> "RunSettings":
        return (self.sender_deliver_rate(node, rate)
                .receiver_deliver_rate(node, rate))

    def _map_unreliable(self, mapping, key, unreliable: bool) -> "RunSettings":
        if unreliable:
            cur = mapping.get(key)
            if cur is None or cur > 1.0:
                mapping[key] = DEFAULT_UNRELIABLE_RATE
        else:
            mapping[key] = 2.0  # reliable placeholder (RunSettings.java:126)
        return self

    def link_unreliable(self, frm: Address, to: Address, unreliable: bool) -> "RunSettings":
        return self._map_unreliable(
            self._link_rate, (frm.root_address(), to.root_address()), unreliable)

    def sender_unreliable(self, frm: Address, unreliable: bool) -> "RunSettings":
        return self._map_unreliable(self._sender_rate, frm.root_address(), unreliable)

    def receiver_unreliable(self, to: Address, unreliable: bool) -> "RunSettings":
        return self._map_unreliable(self._receiver_rate, to.root_address(), unreliable)

    def node_unreliable(self, node: Address, unreliable: bool) -> "RunSettings":
        return (self.sender_unreliable(node, unreliable)
                .receiver_unreliable(node, unreliable))

    def reset_network(self) -> "RunSettings":
        self.reconnect()
        self._link_rate.clear()
        self._sender_rate.clear()
        self._receiver_rate.clear()
        self._network_rate = None
        return self

    # -------------------------------------------------------------- delivery

    def should_deliver(self, envelope) -> bool:
        frm = envelope.frm.root_address()
        to = envelope.to.root_address()
        if frm == to:
            return True
        if not super().should_deliver(envelope):
            return False
        link = (frm, to)
        if link in self._link_rate:
            rate = self._link_rate[link]
        elif frm in self._sender_rate:
            rate = self._sender_rate[frm]
        elif to in self._receiver_rate:
            rate = self._receiver_rate[to]
        else:
            rate = self._network_rate
        return rate is None or rate > 1.0 or random.random() < rate
