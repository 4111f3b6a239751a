"""Lab 3: multi-instance Paxos (the north-star workload).

The reference ships PaxosServer/PaxosClient as skeletons with a fixed probe
interface (labs/lab3-paxos/src/dslabs/paxos/PaxosServer.java:37-110:
``status``/``command``/``firstNonCleared``/``lastNonEmpty``;
PaxosLogSlotStatus.java:3-12) and fixed client message names
(PaxosRequest/PaxosReply).  The protocol below is a self-designed
multi-Paxos built to the acceptance spec in PaxosTest.java:67-1160:

  * **Stable leader.** Ballots are ``(round, server_index)``.  A server that
    misses leader heartbeats for one ElectionTimer period starts phase 1
    (P1a/P1b) with a higher round; followers suppress their own elections
    while a leader with ballot >= theirs is heartbeating.  In the steady
    state each agreement costs P2a(n) + P2b(n) + heartbeat-amortised commit
    distribution, within the <= 15 n messages/agreement budget
    (PaxosTest.java:571-593).
  * **Log replication.**  The leader assigns consecutive slots, replicates
    with P2a/P2b, marks slots CHOSEN on majority, executes chosen slots in
    order against an AMOApplication, and every server replies to the
    requesting client on execution (any replica can answer; the AMO layer
    dedups).  New leaders adopt the highest-ballot accepted value per slot
    from a P1b majority and fill holes with no-ops.
  * **Catch-up + garbage collection.**  Heartbeats carry the leader's
    contiguous-chosen watermark and the cluster-wide executed minimum;
    followers request missing chosen entries (CatchupRequest/Reply), and all
    servers clear log entries every server has executed
    (test11ClearsMemory, PaxosTest.java:599-644).  ``first_non_cleared``
    is the GC frontier + 1.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from dslabs_tpu_torch.core.address import Address
from dslabs_tpu_torch.core.client_utils import SyncClientMixin
from dslabs_tpu_torch.core.node import Node
from dslabs_tpu_torch.core.types import (Application, Client, Command, Message,
                                   Result, Timer)
from dslabs_tpu_torch.labs.clientserver.amo import AMOApplication, AMOCommand, AMOResult

__all__ = ["PaxosServer", "PaxosClient", "PaxosRequest", "PaxosReply",
           "PaxosDecision",
           "PaxosLogSlotStatus", "Ballot",
           "HEARTBEAT_MILLIS", "CLIENT_RETRY_MILLIS"]

ELECTION_MILLIS_MIN = 150
ELECTION_MILLIS_MAX = 300
HEARTBEAT_MILLIS = 50
CLIENT_RETRY_MILLIS = 100


class PaxosLogSlotStatus:
    EMPTY = "EMPTY"
    ACCEPTED = "ACCEPTED"
    CHOSEN = "CHOSEN"
    CLEARED = "CLEARED"


# Ballot = (round, proposer_index); compares lexicographically.
Ballot = Tuple[int, int]


@dataclass(frozen=True)
class PaxosRequest(Message):
    command: Command  # AMOCommand from clients; raw commands in relay mode


@dataclass(frozen=True)
class PaxosDecision(Message):
    """Relay-mode output: delivered locally to the parent node for each
    chosen slot, in slot order (the sub-node replication pattern of lab 4,
    ShardStoreServer.java — Paxos as a group-replicated log)."""
    slot: int
    command: Optional[Command]


@dataclass(frozen=True)
class PaxosReply(Message):
    result: AMOResult


@dataclass(frozen=True)
class P1a(Message):
    ballot: Ballot


@dataclass(frozen=True)
class P1b(Message):
    ballot: Ballot
    # slot -> (accepted ballot, command-or-None, chosen flag)
    log: Tuple[Tuple[int, Tuple[Ballot, Optional[Command], bool]], ...]


@dataclass(frozen=True)
class P2a(Message):
    ballot: Ballot
    slot: int
    command: Optional[Command]  # None = no-op hole filler


@dataclass(frozen=True)
class P2b(Message):
    ballot: Ballot
    slot: int


@dataclass(frozen=True)
class Heartbeat(Message):
    ballot: Ballot
    commit: int       # leader's contiguous-chosen watermark
    gc_through: int   # every server has executed through this slot


@dataclass(frozen=True)
class HeartbeatReply(Message):
    ballot: Ballot
    executed_through: int


@dataclass(frozen=True)
class CatchupRequest(Message):
    from_slot: int


@dataclass(frozen=True)
class CatchupReply(Message):
    # slot -> command for chosen slots
    entries: Tuple[Tuple[int, Optional[Command]], ...]


@dataclass(frozen=True)
class ElectionTimer(Timer):
    pass


@dataclass(frozen=True)
class HeartbeatTimer(Timer):
    ballot: Ballot


@dataclass(frozen=True)
class ClientTimer(Timer):
    sequence_num: int


class _LogEntry:
    """Mutable per-slot record; equality/hash via fields (search state)."""

    __slots__ = ("ballot", "command", "chosen")

    def __init__(self, ballot: Ballot, command: Optional[Command],
                 chosen: bool = False):
        self.ballot = ballot
        self.command = command
        self.chosen = chosen

    def __eq__(self, other):
        return (type(other) is _LogEntry and self.ballot == other.ballot
                and self.command == other.command and self.chosen == other.chosen)

    def __hash__(self):
        return hash((self.ballot, self.command, self.chosen))

    def __repr__(self):
        return (f"LogEntry(ballot={self.ballot}, chosen={self.chosen}, "
                f"command={self.command})")


class PaxosServer(Node):

    def __init__(self, address: Address, servers: Tuple[Address, ...],
                 app: Optional[Application]):
        """With an application, executes chosen commands against it and
        replies to clients (lab 3).  With ``app=None`` (relay mode), instead
        delivers each chosen command to the parent node as a local
        ``PaxosDecision`` — Paxos as a replicated log for sub-node
        composition (lab 4)."""
        super().__init__(address)
        self.servers = tuple(servers)
        self.index = self.servers.index(address)
        self.majority = len(self.servers) // 2 + 1
        self.app = AMOApplication(app) if app is not None else None

        self.log: Dict[int, _LogEntry] = {}
        self.ballot: Ballot = (0, 0)          # highest ballot seen/promised
        self.leader = False                    # won phase 1 for self.ballot
        self.slot_in = 1                       # next slot the leader assigns
        self.executed_through = 0              # contiguous executed prefix
        self.cleared_through = 0               # GC frontier (slots <= cleared)
        self.heard_from_leader = False         # reset by ElectionTimer

        # Leader bookkeeping (meaningful only while leader).
        self.p1b_votes: Dict[Address, P1b] = {}
        self.p2b_votes: Dict[int, Tuple[Address, ...]] = {}
        self.proposed_seq: Dict[Address, int] = {}  # client -> highest seq proposed
        self.peer_executed: Dict[Address, int] = {}
        self.gc_through = 0

    def init(self) -> None:
        # A lone server must be able to elect itself immediately.
        self.set_timer(ElectionTimer(), ELECTION_MILLIS_MIN, ELECTION_MILLIS_MAX)
        if len(self.servers) == 1:
            self._start_election()

    # ------------------------------------------------------- probe interface
    # (PaxosServer.java:37-110 — the tests' log-inspection API)

    def status(self, slot: int) -> str:
        if slot <= self.cleared_through:
            return PaxosLogSlotStatus.CLEARED
        e = self.log.get(slot)
        if e is None:
            return PaxosLogSlotStatus.EMPTY
        return (PaxosLogSlotStatus.CHOSEN if e.chosen
                else PaxosLogSlotStatus.ACCEPTED)

    def command(self, slot: int) -> Optional[Command]:
        if slot <= self.cleared_through:
            return None
        e = self.log.get(slot)
        if e is None or e.command is None:
            return None
        if isinstance(e.command, AMOCommand):
            return e.command.command  # unwrap
        return e.command  # relay mode carries raw commands

    def first_non_cleared(self) -> int:
        return self.cleared_through + 1

    def last_non_empty(self) -> int:
        return max(self.log.keys(), default=self.cleared_through)

    # ------------------------------------------------------------- elections

    def _send_to_all(self, msg: Message) -> None:
        """Broadcast to peers and deliver to ourselves synchronously (our
        own vote/acceptance never rides the network)."""
        self.broadcast(msg, [s for s in self.servers if s != self.address])
        self.deliver_message(msg, self.address)

    def _reply(self, msg: Message, to: Address) -> None:
        if to == self.address:
            self.deliver_message(msg, self.address)
        else:
            self.send(msg, to)

    def _is_leader_ballot(self) -> bool:
        return self.leader and self.ballot[1] == self.index

    def is_leader(self) -> bool:
        return self._is_leader_ballot()

    def _start_election(self) -> None:
        self.ballot = (self.ballot[0] + 1, self.index)
        self.leader = False
        self.p1b_votes = {}
        self._send_to_all(P1a(self.ballot))

    def on_ElectionTimer(self, t: ElectionTimer) -> None:
        if not self._is_leader_ballot() and not self.heard_from_leader:
            self._start_election()
        self.heard_from_leader = False
        self.set_timer(ElectionTimer(), ELECTION_MILLIS_MIN, ELECTION_MILLIS_MAX)

    def handle_P1a(self, m: P1a, sender: Address) -> None:
        if m.ballot > self.ballot:
            self.ballot = m.ballot
            self.leader = False
        if m.ballot == self.ballot:
            # Promise: report our accepted entries above the GC frontier.
            entries = tuple(sorted(
                (s, (e.ballot, e.command, e.chosen)) for s, e in self.log.items()))
            self._reply(P1b(self.ballot, entries), sender)

    def handle_P1b(self, m: P1b, sender: Address) -> None:
        if m.ballot != self.ballot or self.ballot[1] != self.index or self.leader:
            return
        self.p1b_votes[sender] = m
        if len(self.p1b_votes) < self.majority:
            return
        # Won phase 1: adopt the highest-ballot value per slot, fill holes.
        self.leader = True
        self.p2b_votes = {}
        self.proposed_seq = {}
        self.peer_executed = {self.address: self.executed_through}
        adopted: Dict[int, _LogEntry] = {}
        for vote in self.p1b_votes.values():
            for slot, (ballot, command, chosen) in vote.log:
                cur = adopted.get(slot)
                if chosen:
                    adopted[slot] = _LogEntry(ballot, command, True)
                elif cur is None or (not cur.chosen and ballot > cur.ballot):
                    adopted[slot] = _LogEntry(ballot, command, False)
        for slot, e in adopted.items():
            if slot <= self.cleared_through:
                continue
            mine = self.log.get(slot)
            if mine is None or not mine.chosen:
                self.log[slot] = _LogEntry(self.ballot, e.command, e.chosen)
        top = self.last_non_empty()
        # Repropose adopted non-chosen values and fill holes with no-ops.
        for slot in range(self.executed_through + 1, top + 1):
            e = self.log.get(slot)
            if e is None:
                self.log[slot] = _LogEntry(self.ballot, None, False)
            if e is None or not e.chosen:
                self._send_p2a(slot)
        self.slot_in = top + 1
        for slot, e in self.log.items():
            if isinstance(e.command, AMOCommand):
                c = e.command
                self.proposed_seq[c.client_address] = max(
                    self.proposed_seq.get(c.client_address, -1), c.sequence_num)
        self._execute_chosen()
        self.set_timer(HeartbeatTimer(self.ballot), HEARTBEAT_MILLIS)
        self._send_heartbeats()

    # ----------------------------------------------------------- replication

    def _send_p2a(self, slot: int) -> None:
        e = self.log[slot]
        self._send_to_all(P2a(self.ballot, slot, e.command))

    def handle_PaxosRequest(self, m: PaxosRequest, sender: Address) -> None:
        c = m.command
        if self.app is not None and self.app.already_executed(c):
            result = self.app.execute(c)
            if result is not None:
                # Reply to the originating client, not the sender: the
                # request may have been forwarded by a peer server.
                self.send(PaxosReply(result), c.client_address)
            return
        if not self._is_leader_ballot():
            # Forward externally-originated (client / parent-injected)
            # requests to the believed leader once; never re-forward a
            # peer's forward (a stale view could bounce a request around
            # forever in run mode).  A parent-injected request arrives with
            # sender == our own address.
            believed = self.servers[self.ballot[1]]
            if ((sender == self.address or sender not in self.servers)
                    and believed != self.address):
                self.send(m, believed)
            return
        if self.app is not None and isinstance(c, AMOCommand):
            if self.proposed_seq.get(c.client_address, -1) >= c.sequence_num:
                return  # already in flight; client retries are absorbed
            self.proposed_seq[c.client_address] = c.sequence_num
        elif any(e.command == c and not e.chosen for e in self.log.values()):
            # Relay mode: dedup only against in-flight (unchosen) entries.
            # A decided command the parent executor chose to skip (e.g. a
            # client op logged before the group adopted its first config)
            # must stay re-proposable; the parent's AMO layer absorbs
            # duplicate executions.
            return
        slot = self.slot_in
        self.slot_in += 1
        self.log[slot] = _LogEntry(self.ballot, c, False)
        self._send_p2a(slot)

    def handle_P2a(self, m: P2a, sender: Address) -> None:
        if m.ballot >= self.ballot:
            if m.ballot > self.ballot:
                self.leader = False
            self.ballot = m.ballot
            self.heard_from_leader = True
            e = self.log.get(m.slot)
            if m.slot > self.cleared_through and (e is None or not e.chosen):
                self.log[m.slot] = _LogEntry(m.ballot, m.command, False)
            self._reply(P2b(m.ballot, m.slot), sender)

    def handle_P2b(self, m: P2b, sender: Address) -> None:
        if m.ballot != self.ballot or not self._is_leader_ballot():
            return
        e = self.log.get(m.slot)
        if e is None or e.chosen or e.ballot != m.ballot:
            return
        votes = self.p2b_votes.get(m.slot, ())
        if sender in votes:
            return
        # Canonical order: vote arrival order must not distinguish states.
        votes = tuple(sorted(votes + (sender,), key=str))
        self.p2b_votes[m.slot] = votes
        if len(votes) >= self.majority:
            e.chosen = True
            self.p2b_votes.pop(m.slot, None)
            self._execute_chosen()

    # ------------------------------------------------------------- execution

    def _execute_chosen(self) -> None:
        while True:
            e = self.log.get(self.executed_through + 1)
            if e is None or not e.chosen:
                break
            self.executed_through += 1
            if self.app is None:
                if self._parent is not None:
                    self._parent.handle_message_local(
                        PaxosDecision(self.executed_through, e.command))
            elif e.command is not None:
                result = self.app.execute(e.command)
                if result is not None:
                    self.send(PaxosReply(result), e.command.client_address)
        if self._is_leader_ballot():
            self.peer_executed[self.address] = self.executed_through
            self._maybe_gc()

    # -------------------------------------------------- heartbeats / catchup

    def _send_heartbeats(self) -> None:
        hb = Heartbeat(self.ballot, self.executed_through, self.gc_through)
        self.broadcast(hb, [s for s in self.servers if s != self.address])

    def on_HeartbeatTimer(self, t: HeartbeatTimer) -> None:
        if t.ballot != self.ballot or not self._is_leader_ballot():
            return  # stale chain or deposed: stop heartbeating
        self._send_heartbeats()
        # Retransmit P2as for in-flight slots (a lost P2a/P2b would otherwise
        # stall the slot forever: client retries are absorbed by proposed_seq
        # and heartbeats suppress elections).
        for slot in range(self.executed_through + 1, self.slot_in):
            e = self.log.get(slot)
            if e is not None and not e.chosen:
                self._send_p2a(slot)
        self.set_timer(HeartbeatTimer(self.ballot), HEARTBEAT_MILLIS)

    def handle_Heartbeat(self, m: Heartbeat, sender: Address) -> None:
        if m.ballot < self.ballot:
            return
        if m.ballot > self.ballot:
            self.ballot = m.ballot
            self.leader = False
        self.heard_from_leader = True
        self._gc_to(m.gc_through)
        if self.executed_through < m.commit:
            self.send(CatchupRequest(self.executed_through + 1), sender)
        self.send(HeartbeatReply(self.ballot, self.executed_through), sender)

    def handle_HeartbeatReply(self, m: HeartbeatReply, sender: Address) -> None:
        if m.ballot != self.ballot or not self._is_leader_ballot():
            return
        self.peer_executed[sender] = max(
            self.peer_executed.get(sender, 0), m.executed_through)
        self._maybe_gc()

    def _maybe_gc(self) -> None:
        # GC requires EVERY server to have executed the slot (a lagging
        # server still needs the entries to catch up).
        if len(self.peer_executed) < len(self.servers):
            return
        floor = min(self.peer_executed.values())
        if floor > self.gc_through:
            self.gc_through = floor
            self._gc_to(floor)

    def _gc_to(self, through: int) -> None:
        through = min(through, self.executed_through)
        if through <= self.cleared_through:
            return
        for slot in range(self.cleared_through + 1, through + 1):
            self.log.pop(slot, None)
        self.cleared_through = through

    def handle_CatchupRequest(self, m: CatchupRequest, sender: Address) -> None:
        entries = []
        slot = max(m.from_slot, self.cleared_through + 1)
        # Cap the reply so repeated requests from a lagging follower don't
        # flood the network with full-backlog copies.
        while slot <= self.executed_through and len(entries) < 100:
            e = self.log.get(slot)
            if e is None or not e.chosen:
                break
            entries.append((slot, e.command))
            slot += 1
        if entries:
            self.send(CatchupReply(tuple(entries)), sender)

    def handle_CatchupReply(self, m: CatchupReply, sender: Address) -> None:
        for slot, command in m.entries:
            if slot <= self.cleared_through:
                continue
            e = self.log.get(slot)
            if e is None or not e.chosen:
                self.log[slot] = _LogEntry(self.ballot, command, True)
        self._execute_chosen()


class PaxosClient(SyncClientMixin, Node, Client):
    """Any-server retry client (PaxosClient.java:13-64): broadcast the
    pending command to every server; whichever executes it replies; retry on
    a 100ms timer."""

    def __init__(self, address: Address, servers: Tuple[Address, ...]):
        super().__init__(address)
        self.servers = tuple(servers)
        self.seq_num = 0
        self.pending: Optional[AMOCommand] = None
        self.result: Optional[Result] = None

    def init(self) -> None:
        pass

    def send_command(self, command: Command) -> None:
        self.seq_num += 1
        amo = AMOCommand(command, self.address, self.seq_num)
        self.pending = amo
        self.result = None
        self.broadcast(PaxosRequest(amo), self.servers)
        self.set_timer(ClientTimer(self.seq_num), CLIENT_RETRY_MILLIS)

    def has_result(self) -> bool:
        return self.result is not None

    def _take_result(self) -> Result:
        return self.result

    def handle_PaxosReply(self, m: PaxosReply, sender: Address) -> None:
        if (self.pending is not None
                and m.result.sequence_num == self.pending.sequence_num):
            self.result = m.result.result
            self.pending = None
            self._notify_result()

    def on_ClientTimer(self, t: ClientTimer) -> None:
        if self.pending is not None and t.sequence_num == self.pending.sequence_num:
            self.broadcast(PaxosRequest(self.pending), self.servers)
            self.set_timer(ClientTimer(self.pending.sequence_num),
                           CLIENT_RETRY_MILLIS)
