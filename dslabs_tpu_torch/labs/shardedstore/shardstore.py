"""Lab 4, parts 1b/2b: the sharded, reconfigurable KV store.

The reference ships these as skeletons (labs/lab4-shardedstore/src/dslabs/
shardkv/ShardStoreServer.java, ShardStoreClient.java, ShardStoreNode.java:40-66
fixes ``keyToShard``); the protocol below is designed to the acceptance spec
in ShardStoreBaseTest/ShardStorePart1Test/ShardStorePart2Test:

  * Each replica group runs a **Paxos sub-node** (the add_sub_node pattern,
    Node.java:149-171) in relay mode: every state change — client commands,
    config changes, shard installs, handoff completions, 2PC votes — is a
    command in the group's replicated log, and the executor that consumes
    ``PaxosDecision``s is a deterministic function of that log, so all
    replicas converge.
  * **Reconfiguration** is processed one config at a time: the group leader
    polls the shard masters (Query(next)); a NewConfig decision diffs shard
    ownership, snapshots outgoing shards (KV pairs + AMO dedup state, which
    must travel with the shard), and marks incoming shards unservable until
    a ShardMove arrives and its InstallShards decision executes.  Handoff
    completion (MoveDone) frees the snapshot; the next config is only
    adopted once the current handoff has fully drained.
  * **Routing**: clients learn the config from the shard masters, broadcast
    to the owning group, and re-query on WrongGroup.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Optional, Tuple

from dslabs_tpu_torch.core.address import Address, SubAddress
from dslabs_tpu_torch.core.client_utils import SyncClientMixin
from dslabs_tpu_torch.core.node import Node
from dslabs_tpu_torch.core.types import Client, Command, Message, Result, Timer
from dslabs_tpu_torch.labs.clientserver.amo import AMOApplication, AMOCommand, AMOResult
from dslabs_tpu_torch.labs.paxos.paxos import (PaxosDecision, PaxosRequest,
                                         PaxosReply, PaxosServer)
from dslabs_tpu_torch.labs.shardedstore.shardmaster import Query, ShardConfig
from dslabs_tpu_torch.labs.shardedstore.txkvstore import (Transaction,
                                                    TransactionalKVStore)

__all__ = ["ShardStoreNode", "ShardStoreServer", "ShardStoreClient",
           "ShardStoreRequest", "ShardStoreReply", "WrongGroup",
           "key_to_shard", "CLIENT_RETRY_MILLIS", "QUERY_MILLIS"]

CLIENT_RETRY_MILLIS = 100
QUERY_MILLIS = 50
PAXOS_ID = "paxos"


def _java_string_hash(s: str) -> int:
    h = 0
    for ch in s:
        h = (31 * h + ord(ch)) & 0xFFFFFFFF
    if h >= 2 ** 31:
        h -= 2 ** 32
    return h


def key_to_shard(key: str, num_shards: int) -> int:
    """Shard of ``key`` in 1..num_shards: trailing digits (mod num_shards)
    when present, else a deterministic string hash
    (ShardStoreNode.java:40-66; Python's salted hash() is unusable here).
    The digit accumulation wraps at 32 bits like Java int arithmetic, so
    keys with 10+ trailing digits map exactly as the reference does."""
    i = len(key)
    while i > 0 and key[i - 1].isdigit():
        i -= 1
    digits = key[i:]
    if digits:
        h = 0
        for d in digits:
            h = (h * 10 + int(d)) & 0xFFFFFFFF
        if h >= 2 ** 31:
            h -= 2 ** 32
    else:
        h = _java_string_hash(key)
    mod = h % num_shards
    if mod <= 0:
        mod += num_shards
    return mod


# ----------------------------------------------------------------- messages

@dataclass(frozen=True)
class ShardStoreRequest(Message):
    command: AMOCommand


@dataclass(frozen=True)
class ShardStoreReply(Message):
    result: AMOResult


@dataclass(frozen=True)
class WrongGroup(Message):
    sequence_num: int


@dataclass(frozen=True)
class ShardMove(Message):
    config_num: int
    from_group: int
    shards: FrozenSet[int]
    kv: Tuple[Tuple[str, str], ...]
    amo: Tuple[Tuple[Address, Tuple[int, AMOResult]], ...]


@dataclass(frozen=True)
class ShardMoveAck(Message):
    config_num: int
    shards: FrozenSet[int]


# ------------------------------------------------- replicated log commands

@dataclass(frozen=True)
class NewConfig(Command):
    config: ShardConfig


@dataclass(frozen=True)
class InstallShards(Command):
    config_num: int
    from_group: int
    shards: FrozenSet[int]
    kv: Tuple[Tuple[str, str], ...]
    amo: Tuple[Tuple[Address, Tuple[int, AMOResult]], ...]


@dataclass(frozen=True)
class MoveDone(Command):
    config_num: int
    to_group: int
    shards: FrozenSet[int]


# ------------------------------------------------------------- 2PC protocol
# Cross-group transactions run two-phase commit with shard-level locking:
# the coordinator (group owning the smallest shard of the key set) drives
# prepares/votes/decisions; conflicts vote abort (no waiting => no
# deadlock) and the client's retry restarts the transaction.  Each type is
# both a Message (between groups) and a Command (proposed verbatim into the
# receiving group's replicated log so all replicas process it).

TxId = Tuple[Address, int]  # (client address, sequence number)


@dataclass(frozen=True)
class TxPrepare(Message, Command):
    tx: AMOCommand
    round: int  # retry round; stale-round votes/decisions are ignored
    coordinator_group: int
    # The coordinator's config when it computed the participant set.  A
    # participant on a DIFFERENT config votes abort: a config-lagging
    # group can believe it owns none of the tx's shards, in which case
    # "my_shards <= owned" is vacuously true and it would vote yes with
    # no values and no locks — committing a transaction whose writes it
    # then silently drops (observed as a lost MultiPut write under
    # unreliable delivery in test06).
    config_num: int
    # The coordinator group's members, so the abort vote can be routed
    # even when the voter's config no longer lists the coordinator group
    # (e.g. it was removed by a Leave the voter already installed).
    coordinator_members: Tuple[Address, ...]


@dataclass(frozen=True)
class TxVote(Message, Command):
    tx_id: TxId
    round: int
    group_id: int
    ok: bool
    # current values of the tx's keys owned by the voter (missing = absent)
    values: Tuple[Tuple[str, str], ...]


@dataclass(frozen=True)
class TxDecision(Message, Command):
    tx_id: TxId
    round: int
    coordinator_group: int
    commit: bool
    # key -> new value (None = delete); each group applies its owned keys
    writes: Tuple[Tuple[str, Optional[str]], ...]


@dataclass(frozen=True)
class TxAck(Message, Command):
    tx_id: TxId
    round: int
    group_id: int


# -------------------------------------------------------------------- timers

@dataclass(frozen=True)
class ClientTimer(Timer):
    sequence_num: int


@dataclass(frozen=True)
class QueryTimer(Timer):
    pass


# --------------------------------------------------------------------- nodes

class ShardStoreNode(Node):

    def __init__(self, address: Address, shard_masters: Tuple[Address, ...],
                 num_shards: int):
        super().__init__(address)
        self.shard_masters = tuple(shard_masters)
        self.num_shards = num_shards

    def key_to_shard(self, key: str) -> int:
        return key_to_shard(key, self.num_shards)

    def command_shards(self, command: Command) -> FrozenSet[int]:
        if isinstance(command, Transaction):
            return frozenset(self.key_to_shard(k) for k in command.key_set())
        return frozenset((self.key_to_shard(command.key),))

    def broadcast_to_shard_masters(self, message: Message) -> None:
        self.broadcast(message, self.shard_masters)


class ShardStoreServer(ShardStoreNode):

    def __init__(self, address: Address, shard_masters: Tuple[Address, ...],
                 num_shards: int, group: Tuple[Address, ...], group_id: int):
        super().__init__(address, shard_masters, num_shards)
        self.group = tuple(group)
        self.group_id = group_id
        self.app = AMOApplication(TransactionalKVStore())
        self.current_config: Optional[ShardConfig] = None
        self.owned: FrozenSet[int] = frozenset()
        self.incoming: FrozenSet[int] = frozenset()
        # (config_num, dest group) -> (shards, kv snapshot, amo snapshot)
        self.outgoing: Dict[Tuple[int, int], Tuple[FrozenSet[int],
                                                   Tuple, Tuple]] = {}
        self.qseq = 0
        # --- 2PC state (deterministic function of the group log) ---
        self.locks: Dict[int, "TxId"] = {}  # shard -> holding tx
        # participant side: tx_id -> (tx, coordinator_group, ok, values)
        self.prepared: Dict["TxId", Tuple[AMOCommand, int, bool, Tuple]] = {}
        # coordinator side: tx_id -> [tx, votes{group: (ok, values)},
        #                             decision(None/bool), writes, acked set]
        self.coord: Dict["TxId", list] = {}
        self.tx_round: Dict["TxId", int] = {}  # latest 2PC round per tx
        self.tx_done: Dict["TxId", bool] = {}  # finished txs (True = committed)

    def init(self) -> None:
        paxos_addr = SubAddress(self.address, PAXOS_ID)
        group_paxos = tuple(SubAddress(a, PAXOS_ID) for a in self.group)
        paxos = PaxosServer(paxos_addr, group_paxos, None)  # relay mode
        self.add_sub_node(paxos)
        paxos.init()
        self.set_timer(QueryTimer(), QUERY_MILLIS)

    # ------------------------------------------------------------- utilities

    @property
    def paxos(self) -> PaxosServer:
        return self.sub_nodes[PAXOS_ID]

    def _propose(self, command: Command) -> None:
        """Feed a command into the group's replicated log via the local
        Paxos sub-node (it forwards to the group leader if necessary)."""
        self.paxos.handle_message_local(PaxosRequest(command))

    def _next_config_num(self) -> int:
        return self.current_config.config_num + 1 if self.current_config is not None else 0

    def _my_shards(self, config: ShardConfig) -> FrozenSet[int]:
        info = config.groups().get(self.group_id)
        return info[1] if info is not None else frozenset()

    def _reconfig_done(self) -> bool:
        # Handoff fully drained AND no 2PC state outstanding: moving a shard
        # mid-transaction would strand its prepared locks and lose the
        # transaction's committed writes on the departed shard.
        return (not self.incoming and not self.outgoing and not self.locks
                and not self.prepared and not self.coord)

    def _snapshot_for(self, shards: FrozenSet[int]):
        kv = tuple(sorted(
            (k, v) for k, v in self.app.application.store.items()
            if self.key_to_shard(k) in shards))
        amo = tuple(sorted(
            ((c, (seq, res)) for c, (seq, res) in self.app.last.items()),
            key=lambda e: str(e[0])))
        return kv, amo

    def _merge_amo(self, amo) -> None:
        for client, (seq, res) in amo:
            cur = self.app.last.get(client)
            if cur is None or seq > cur[0]:
                self.app.last[client] = (seq, res)

    # --------------------------------------------------- network handlers

    def handle_ShardStoreRequest(self, m: ShardStoreRequest, sender: Address) -> None:
        self._propose(m.command)

    def handle_PaxosReply(self, m: PaxosReply, sender: Address) -> None:
        """Reply from the shard-master Paxos group to our config query."""
        cfg = m.result.result
        if (isinstance(cfg, ShardConfig)
                and cfg.config_num == self._next_config_num()
                and self._reconfig_done()):
            self._propose(NewConfig(cfg))

    def handle_ShardMove(self, m: ShardMove, sender: Address) -> None:
        if self.current_config is None or m.config_num > self.current_config.config_num:
            return  # we haven't reached this config yet; sender retries
        if m.config_num < self.current_config.config_num or m.shards <= self.owned:
            # Already installed (possibly long ago): re-ack so the sender
            # can complete its handoff even if earlier acks were lost.
            self.send(ShardMoveAck(m.config_num, m.shards), sender)
            return
        self._propose(InstallShards(m.config_num, m.from_group, m.shards,
                                    m.kv, m.amo))

    def handle_TxPrepare(self, m: TxPrepare, sender: Address) -> None:
        self._propose(m)

    def handle_TxVote(self, m: TxVote, sender: Address) -> None:
        self._propose(m)

    def handle_TxDecision(self, m: TxDecision, sender: Address) -> None:
        self._propose(m)

    def handle_TxAck(self, m: TxAck, sender: Address) -> None:
        self._propose(m)

    def handle_ShardMoveAck(self, m: ShardMoveAck, sender: Address) -> None:
        for (config_num, to_group), (shards, _, _) in self.outgoing.items():
            if config_num == m.config_num and shards == m.shards:
                self._propose(MoveDone(config_num, to_group, shards))
                return

    # ------------------------------------------------------------- decisions

    def handle_PaxosDecision(self, m: PaxosDecision, sender: Address) -> None:
        c = m.command
        if isinstance(c, AMOCommand):
            self._execute_client_command(c)
        elif isinstance(c, NewConfig):
            self._apply_new_config(c.config)
        elif isinstance(c, InstallShards):
            self._apply_install(c)
        elif isinstance(c, MoveDone):
            self.outgoing.pop((c.config_num, c.to_group), None)
        elif isinstance(c, TxPrepare):
            self._apply_tx_prepare(c)
        elif isinstance(c, TxVote):
            self._apply_tx_vote(c)
        elif isinstance(c, TxDecision):
            self._apply_tx_decision(c)
        elif isinstance(c, TxAck):
            entry = self.coord.get(c.tx_id)
            if entry is not None and entry[5] == c.round:
                entry[4] = entry[4] | {c.group_id}
                if entry[4] >= self._participant_groups(entry[0].command):
                    del self.coord[c.tx_id]

    def _execute_client_command(self, c: AMOCommand) -> None:
        shards = self.command_shards(c.command)
        if self.current_config is None:
            return
        mine = self._my_shards(self.current_config)
        if not shards <= mine:
            if (isinstance(c.command, Transaction)
                    and min(shards) in mine):
                self._coordinate_tx(c)
                return
            self.send(WrongGroup(c.sequence_num), c.client_address)
            return
        if not shards <= self.owned:
            return  # shards still in flight; the client retries
        if any(s in self.locks for s in shards):
            return  # a cross-group tx holds these shards; client retries
        result = self.app.execute(c)
        if result is not None:
            self.send(ShardStoreReply(result), c.client_address)

    # ------------------------------------------------------------------ 2PC

    def _tx_id(self, c: AMOCommand):
        return (c.client_address, c.sequence_num)

    def _participant_groups(self, tx: Command) -> FrozenSet[int]:
        cfg = self.current_config
        shards = self.command_shards(tx)
        return frozenset(g for g, (_, g_shards) in cfg.group_info
                         if shards & g_shards)

    def _coordinate_tx(self, c: AMOCommand) -> None:
        """Coordinator executor path for a multi-group transaction."""
        tx_id = self._tx_id(c)
        if self.app.already_executed(c):
            result = self.app.execute(c)
            if result is not None:
                self.send(ShardStoreReply(result), c.client_address)
            return
        if tx_id in self.coord:
            return  # already in progress; retries are absorbed
        rnd = self.tx_round.get(tx_id, 0) + 1
        self.tx_round[tx_id] = rnd
        self.coord[tx_id] = [c, {}, None, (), frozenset(), rnd]
        if self.paxos.is_leader():
            self._send_prepares(tx_id)

    def _send_prepares(self, tx_id) -> None:
        entry = self.coord[tx_id]
        prepare = TxPrepare(entry[0], entry[5], self.group_id,
                            self.current_config.config_num, self.group)
        groups = self.current_config.groups()
        for g in self._participant_groups(entry[0].command):
            if g not in entry[1]:
                self.broadcast(prepare, groups[g][0])

    def _apply_tx_prepare(self, c: TxPrepare) -> None:
        tx_id = self._tx_id(c.tx)
        if self.current_config is None:
            return
        done = self.tx_done.get(tx_id)
        if done is not None:
            self._send_vote_to(c.coordinator_group,
                               TxVote(tx_id, c.round, self.group_id, True, ()))
            return
        if self.current_config.config_num != c.config_num:
            # Config mismatch: our shard view disagrees with the
            # coordinator's participant computation — vote abort so the
            # client retries after the configs converge (see TxPrepare).
            # Routed via the prepare's own member list: the coordinator
            # group may be absent from OUR config (a Leave we already
            # installed), and a dropped vote would wedge it forever.
            if self.paxos.is_leader():
                self.broadcast(TxVote(tx_id, c.round, self.group_id,
                                      False, ()), c.coordinator_members)
            return
        cur = self.prepared.get(tx_id)
        if cur is not None and cur[4] != c.round:
            if cur[4] < c.round:
                # A newer round supersedes our stale prepare: release it and
                # re-prepare below (its votes can no longer be accepted).
                for sh in [sh for sh, t in self.locks.items() if t == tx_id]:
                    del self.locks[sh]
                del self.prepared[tx_id]
            else:
                return  # stale prepare from an older round: ignore
        if tx_id not in self.prepared:
            my_shards = (self.command_shards(c.tx.command)
                         & self._my_shards(self.current_config))
            conflict = any(self.locks.get(s, tx_id) != tx_id
                           for s in my_shards)
            ok = not conflict and my_shards <= self.owned
            values = ()
            if ok:
                for s in my_shards:
                    self.locks[s] = tx_id
                store = self.app.application.store
                values = tuple(sorted(
                    (k, store[k]) for k in self._tx_keys(c.tx.command)
                    if self.key_to_shard(k) in my_shards and k in store))
            self.prepared[tx_id] = (c.tx, c.coordinator_group, ok, values,
                                    c.round)
        _, coord_group, ok, values, rnd = self.prepared[tx_id]
        self._send_vote_to(coord_group,
                           TxVote(tx_id, rnd, self.group_id, ok, values))

    @staticmethod
    def _tx_keys(tx: Command):
        return tx.key_set() if isinstance(tx, Transaction) else (tx.key,)

    def _send_vote_to(self, group_id: int, vote: TxVote) -> None:
        if not self.paxos.is_leader():
            return
        members = self.current_config.groups().get(group_id)
        if members is not None:
            self.broadcast(vote, members[0])

    def _apply_tx_vote(self, c: TxVote) -> None:
        entry = self.coord.get(c.tx_id)
        # The `entry[2] is not None` guard is load-bearing beyond plain
        # idempotence: a participant that voted YES for round r can later
        # emit ABORT for the SAME round (duplicate TxPrepare delivered
        # after it installed a newer config — the config-mismatch abort
        # path in _apply_tx_prepare).  Once the round's decision is
        # fixed, every late vote must be ignored or that interleaving
        # would flip a committed transaction to aborted after the
        # client already got its reply (pinned by
        # test_yes_then_abort_same_round_duplicate).
        if entry is None or entry[2] is not None or c.round != entry[5]:
            return
        entry[1][c.group_id] = (c.ok, c.values)
        participants = self._participant_groups(entry[0].command)
        votes = entry[1]
        if any(not ok for ok, _ in votes.values()):
            entry[2] = False
            entry[3] = ()
        elif set(votes) >= participants:
            # All yes: run the transaction over the gathered values.
            db = {}
            for ok, values in votes.values():
                db.update(dict(values))
            tx = entry[0].command
            result = tx.run(db)
            writes = tuple(sorted(
                (k, db.get(k)) for k in tx.write_set()))
            entry[2] = True
            entry[3] = writes
            # Record in the AMO cache so client retries get the result.
            amo_result = AMOResult(result, entry[0].sequence_num)
            cur = self.app.last.get(entry[0].client_address)
            if cur is None or entry[0].sequence_num > cur[0]:
                self.app.last[entry[0].client_address] = (
                    entry[0].sequence_num, amo_result)
            self.send(ShardStoreReply(amo_result), entry[0].client_address)
        else:
            return
        if self.paxos.is_leader():
            self._send_decision(c.tx_id)

    def _send_decision(self, tx_id) -> None:
        entry = self.coord[tx_id]
        decision = TxDecision(tx_id, entry[5], self.group_id, entry[2],
                              entry[3])
        groups = self.current_config.groups()
        for g in self._participant_groups(entry[0].command):
            if g not in entry[4]:
                self.broadcast(decision, groups[g][0])

    def _apply_tx_decision(self, c: TxDecision) -> None:
        p = self.prepared.get(c.tx_id)
        if p is not None and p[4] != c.round:
            p = None  # decision from another round: leave our prepare alone
        else:
            self.prepared.pop(c.tx_id, None)
        if p is not None:
            _, _, ok, _, _ = p
            if c.commit and ok:
                store = self.app.application.store
                my = self._my_shards(self.current_config)
                for k, v in c.writes:
                    if self.key_to_shard(k) in my:
                        if v is None:
                            store.pop(k, None)
                        else:
                            store[k] = v
                self.tx_done[c.tx_id] = True
            for s in [s for s, t in self.locks.items() if t == c.tx_id]:
                del self.locks[s]
        # Aborted coordinator entries are cleared so a client retry can
        # restart the transaction from scratch (stale-round decisions must
        # not clear a newer round's entry).
        entry = self.coord.get(c.tx_id)
        if entry is not None and entry[2] is False and entry[5] == c.round:
            del self.coord[c.tx_id]
        # Always ack (even duplicate decisions: an earlier ack may be lost).
        if self.paxos.is_leader() and self.current_config is not None:
            members = self.current_config.groups().get(c.coordinator_group)
            if members is not None:
                self.broadcast(TxAck(c.tx_id, c.round, self.group_id),
                               members[0])

    def _apply_new_config(self, cfg: ShardConfig) -> None:
        if cfg.config_num != self._next_config_num() or not self._reconfig_done():
            return
        mine_new = self._my_shards(cfg)
        if self.current_config is None:
            # The system's first config: shards start empty, no handoff.
            self.owned = mine_new
            self.current_config = cfg
            return
        lost = self.owned - mine_new
        gained = mine_new - self.owned
        for group_id, (_, g_shards) in cfg.group_info:
            to_g = lost & g_shards
            if to_g:
                kv, amo = self._snapshot_for(to_g)
                self.outgoing[(cfg.config_num, group_id)] = (to_g, kv, amo)
        for k in [k for k in self.app.application.store
                  if self.key_to_shard(k) in lost]:
            del self.app.application.store[k]
        self.owned = self.owned - lost
        self.incoming = gained
        self.current_config = cfg
        if self.paxos.is_leader():
            self._send_moves()

    def _apply_install(self, c: InstallShards) -> None:
        if (self.current_config is None or c.config_num != self.current_config.config_num
                or not c.shards <= self.incoming):
            return
        self.app.application.store.update(dict(c.kv))
        self._merge_amo(c.amo)
        self.owned = self.owned | c.shards
        self.incoming = self.incoming - c.shards
        if self.paxos.is_leader():
            self._send_ack(c)

    # -------------------------------------------------- leader side effects

    def _send_moves(self) -> None:
        if self.current_config is None:
            return
        groups = self.current_config.groups()
        for (config_num, to_group), (shards, kv, amo) in self.outgoing.items():
            if config_num != self.current_config.config_num:
                continue
            members = groups.get(to_group)
            if members is not None:
                self.broadcast(
                    ShardMove(config_num, self.group_id, shards, kv, amo),
                    members[0])

    def _send_ack(self, c: InstallShards) -> None:
        members = self.current_config.groups().get(c.from_group)
        if members is not None:
            self.broadcast(ShardMoveAck(c.config_num, c.shards), members[0])

    def on_QueryTimer(self, t: QueryTimer) -> None:
        if self.paxos.is_leader():
            if self._reconfig_done() or self.current_config is None:
                self.qseq += 1
                self.broadcast_to_shard_masters(PaxosRequest(AMOCommand(
                    Query(self._next_config_num()), self.address, self.qseq)))
            self._send_moves()
            for tx_id, entry in self.coord.items():
                if entry[2] is None:
                    self._send_prepares(tx_id)
                else:
                    self._send_decision(tx_id)
            for tx_id, (tx, coord_group, ok, values, rnd) in \
                    self.prepared.items():
                self._send_vote_to(coord_group,
                                   TxVote(tx_id, rnd, self.group_id, ok,
                                          values))
        self.set_timer(QueryTimer(), QUERY_MILLIS)


class ShardStoreClient(SyncClientMixin, ShardStoreNode, Client):

    def __init__(self, address: Address, shard_masters: Tuple[Address, ...],
                 num_shards: int):
        super().__init__(address, shard_masters, num_shards)
        self.current_config: Optional[ShardConfig] = None
        self.seq_num = 0
        self.qseq = 0
        self.pending: Optional[AMOCommand] = None
        self.result: Optional[Result] = None

    def init(self) -> None:
        self._query_config()

    def _query_config(self) -> None:
        self.qseq += 1
        self.broadcast_to_shard_masters(PaxosRequest(AMOCommand(
            Query(-1), self.address, self.qseq)))

    def _target_group(self) -> Optional[Tuple[Address, ...]]:
        if self.current_config is None or self.pending is None:
            return None
        shards = self.command_shards(self.pending.command)
        groups = self.current_config.groups()
        # Multi-group transactions go to the coordinator: the group owning
        # the smallest shard in the key set.
        for shard in sorted(shards):
            for _, (members, g_shards) in self.current_config.group_info:
                if shard in g_shards:
                    return tuple(members)
        return None

    def _send_pending(self) -> None:
        target = self._target_group()
        if target is not None:
            self.broadcast(ShardStoreRequest(self.pending), target)
        else:
            self._query_config()

    # ------------------------------------------------------ client interface

    def send_command(self, command: Command) -> None:
        self.seq_num += 1
        amo = AMOCommand(command, self.address, self.seq_num)
        self.pending = amo
        self.result = None
        self._send_pending()
        self.set_timer(ClientTimer(self.seq_num), CLIENT_RETRY_MILLIS)

    def has_result(self) -> bool:
        return self.result is not None

    def _take_result(self) -> Result:
        return self.result

    # -------------------------------------------------------------- handlers

    def handle_ShardStoreReply(self, m: ShardStoreReply, sender: Address) -> None:
        if (self.pending is not None
                and m.result.sequence_num == self.pending.sequence_num):
            self.result = m.result.result
            self.pending = None
            self._notify_result()

    def handle_WrongGroup(self, m: WrongGroup, sender: Address) -> None:
        if self.pending is not None and m.sequence_num == self.pending.sequence_num:
            self._query_config()

    def handle_PaxosReply(self, m: PaxosReply, sender: Address) -> None:
        cfg = m.result.result
        if isinstance(cfg, ShardConfig):
            if self.current_config is None or cfg.config_num > self.current_config.config_num:
                self.current_config = cfg
                if self.pending is not None:
                    self._send_pending()

    def on_ClientTimer(self, t: ClientTimer) -> None:
        if self.pending is not None and t.sequence_num == self.pending.sequence_num:
            self._query_config()
            self._send_pending()
            self.set_timer(ClientTimer(self.seq_num), CLIENT_RETRY_MILLIS)
