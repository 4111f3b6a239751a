"""Log-consistency predicates for lab 3.

Behavioural port of the invariant machinery inside PaxosTest.java:113-346
(MARKERS_VALID, slotValid, LOGS_CONSISTENT, LOGS_CONSISTENT_ALL_SLOTS,
hasStatus/hasCommand helpers).  These drive both the object-graph checker and
(via host fallback) the TPU search backend.
"""

from __future__ import annotations

from typing import Optional, Tuple

from dslabs_tpu_torch.labs.clientserver.amo import AMOCommand
from dslabs_tpu_torch.labs.paxos.paxos import PaxosLogSlotStatus as S
from dslabs_tpu_torch.testing.predicates import StatePredicate

__all__ = ["MARKERS_VALID", "LOGS_CONSISTENT", "LOGS_CONSISTENT_ALL_SLOTS",
           "slot_valid", "has_status", "has_command"]


def _check_markers(st) -> Tuple[bool, Optional[str]]:
    for a, p in st.servers.items():
        nc = p.first_non_cleared()
        ne = p.last_non_empty()
        if nc < 1:
            return False, f"{a} returned {nc} as first non-cleared slot"
        if ne < 0:
            return False, f"{a} returned {ne} as last non-empty slot"
        if p.status(nc) == S.CLEARED:
            return False, (f"{a} first non-cleared {nc} has status CLEARED")
        if ne > 0 and p.status(ne) == S.EMPTY:
            return False, f"{a} last non-empty {ne} has status EMPTY"
        if nc > 1 and p.status(nc - 1) != S.CLEARED:
            return False, f"{a} slot before first non-cleared {nc} isn't CLEARED"
        if p.status(ne + 1) != S.EMPTY:
            return False, f"{a} slot after last non-empty {ne} isn't EMPTY"
        if nc > ne + 1:
            return False, (f"{a} first non-cleared {nc} > last non-empty {ne} + 1")
    return True, None


MARKERS_VALID = StatePredicate(
    "First non-cleared and last non-empty valid", _check_markers,
    tkey=("PAXOS_MARKERS_VALID",))


def _slot_valid(st, i: int) -> Tuple[bool, Optional[str]]:
    chosen_cmd = None
    is_chosen = False
    is_cleared = False
    for a, p in st.servers.items():
        nc, ne = p.first_non_cleared(), p.last_non_empty()
        s, c = p.status(i), p.command(i)
        if i < nc and s != S.CLEARED:
            return False, f"{a} slot {i} status {s} but firstNonCleared {nc}"
        if i > ne and s != S.EMPTY:
            return False, f"{a} slot {i} status {s} but lastNonEmpty {ne}"
        if s in (S.EMPTY, S.CLEARED) and c is not None:
            return False, f"{a} slot {i} status {s} but returned command {c}"
        if isinstance(c, AMOCommand):
            return False, f"{a} returned an AMOCommand for slot {i}"
        if s == S.CLEARED:
            is_cleared = True
        if s == S.CHOSEN:
            if is_chosen and chosen_cmd != c:
                return False, (f"Two different commands ({chosen_cmd} and {c}) "
                               f"chosen for slot {i}")
            chosen_cmd = c
            is_chosen = True
    if not is_chosen and not is_cleared:
        return True, None
    count = 0
    for p in st.servers.values():
        s, c = p.status(i), p.command(i)
        if s != S.EMPTY and (s != S.ACCEPTED or not is_chosen or chosen_cmd == c):
            count += 1
    if 2 * count <= len(st.servers):
        if is_chosen:
            return False, (f"{chosen_cmd} chosen for slot {i} without a "
                           f"majority accepting")
        return False, f"Slot {i} cleared without a majority accepting"
    return True, None


def slot_valid(i: int) -> StatePredicate:
    return StatePredicate(f"Logs consistent for slot {i}",
                          lambda st: _slot_valid(st, i),
                          tkey=("PAXOS_SLOT_VALID", i))


def _logs_consistent(st, all_slots: bool) -> Tuple[bool, Optional[str]]:
    ok, msg = _check_markers(st)
    if not ok:
        return ok, msg
    min_nc = min((p.first_non_cleared() for p in st.servers.values()), default=1)
    max_ne = max((p.last_non_empty() for p in st.servers.values()), default=0)
    start = 1 if all_slots else min_nc
    for i in range(start, max_ne + 1):
        ok, msg = _slot_valid(st, i)
        if not ok:
            return ok, msg
    return True, None


LOGS_CONSISTENT = StatePredicate(
    "Active log slots consistent", lambda st: _logs_consistent(st, False),
    tkey=("PAXOS_LOGS_CONSISTENT", False))

LOGS_CONSISTENT_ALL_SLOTS = StatePredicate(
    "Non-empty log slots consistent", lambda st: _logs_consistent(st, True),
    tkey=("PAXOS_LOGS_CONSISTENT", True))


def has_status(a, i: int, status: str) -> StatePredicate:
    return StatePredicate(f"{a} has status {status} in slot {i}",
                          lambda st: st.servers[a].status(i) == status,
                          tkey=("PAXOS_HAS_STATUS", a, i, status))


def has_command(a, i: int, c) -> StatePredicate:
    return StatePredicate(f"{a} has command {c} in slot {i}",
                          lambda st: st.servers[a].command(i) == c,
                          tkey=("PAXOS_HAS_COMMAND", a, i, c))
