"""The record a reference twin returns (the fields its BFS reads)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

# Empty network, timer and send rows hold this value in every lane.
SENTINEL = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class TwinSpec:
    """A batched protocol twin: ``step_message(nodes [P, NW], msg [P, MW])``
    and ``step_timer(nodes, node_idx [P], timer [P, TW])`` both return
    ``(nodes' [P, NW], sends [P, max_sends, MW], sets [P, max_sets,
    1 + TW], exc [P])``; a set row's lane 0 is its node, and unused send
    and set rows are all SENTINEL."""

    name: str
    n_nodes: int
    node_width: int
    msg_width: int
    timer_width: int
    net_cap: int
    timer_cap: int
    max_sends: int
    max_sets: int
    init_nodes: Callable
    init_messages: Callable
    init_timers: Callable
    step_message: Callable
    step_timer: Callable
    msg_dest: Callable
    invariants: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    goals: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    max_live_sends: Optional[int] = None
