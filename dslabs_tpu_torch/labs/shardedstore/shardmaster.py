"""Lab 4, part 1a: the ShardMaster application.

Behavioural port of labs/lab4-shardedstore/src/dslabs/shardmaster/
ShardMaster.java:1-100 with semantics fixed by ShardMasterTest.java:43-372:

  * Configs are numbered from INITIAL_CONFIG_NUM=0 (created by the first
    Join, which maps every shard to that group).
  * Join/Leave rebalance deterministically, moving as few shards as
    possible, to |max - min| <= 1 (test05/test08): joins drain one shard at
    a time from the largest group into the newcomer until it holds
    numShards // numGroups, then keep draining largest->smallest until
    balanced; leaves feed the departed group's shards to the smallest
    groups one at a time.  Ties break on the lowest group id.
  * Move relocates exactly one shard, no rebalance (test07).
  * Query(n): n < 0 means latest; n >= latest returns latest; historical
    configs are retained verbatim (test06).  Errors: re-Join, unknown
    Leave/group Move, out-of-range shard, no-op Move, Query before any
    config, Leave of the last group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Tuple

from dslabs_tpu_torch.core.address import Address
from dslabs_tpu_torch.core.types import Application, Command, Result
from dslabs_tpu_torch.utils.structural import StructEq

__all__ = ["ShardMaster", "Join", "Leave", "Move", "Query", "Ok", "Error",
           "ShardConfig", "INITIAL_CONFIG_NUM"]

INITIAL_CONFIG_NUM = 0


class ShardMasterCommand(Command):
    pass


@dataclass(frozen=True)
class Join(ShardMasterCommand):
    group_id: int
    servers: FrozenSet[Address]

    def __init__(self, group_id: int, servers):
        object.__setattr__(self, "group_id", group_id)
        object.__setattr__(self, "servers", frozenset(servers))


@dataclass(frozen=True)
class Leave(ShardMasterCommand):
    group_id: int


@dataclass(frozen=True)
class Move(ShardMasterCommand):
    group_id: int
    shard_num: int


@dataclass(frozen=True)
class Query(ShardMasterCommand):
    config_num: int

    def read_only(self) -> bool:
        return True


class ShardMasterResult(Result):
    pass


@dataclass(frozen=True)
class Ok(ShardMasterResult):
    pass


@dataclass(frozen=True)
class Error(ShardMasterResult):
    pass


@dataclass(frozen=True)
class ShardConfig(ShardMasterResult):
    config_num: int
    # group id -> (members, shard numbers)
    group_info: Tuple[Tuple[int, Tuple[FrozenSet[Address], FrozenSet[int]]], ...]

    def __init__(self, config_num: int, group_info):
        object.__setattr__(self, "config_num", config_num)
        if isinstance(group_info, dict):
            group_info = tuple(sorted(
                (g, (frozenset(members), frozenset(shards)))
                for g, (members, shards) in group_info.items()))
        object.__setattr__(self, "group_info", group_info)

    def groups(self) -> Dict[int, Tuple[FrozenSet[Address], FrozenSet[int]]]:
        return dict(self.group_info)

    def shards_for(self, group_id: int) -> FrozenSet[int]:
        return self.groups()[group_id][1]

    def group_of(self, shard: int) -> int:
        for g, (_, shards) in self.group_info:
            if shard in shards:
                return g
        raise KeyError(shard)


class ShardMaster(Application, StructEq):

    def __init__(self, num_shards: int):
        self.num_shards = num_shards
        self.configs: List[ShardConfig] = []
        # group id -> members (live view used to build the next config)
        self.groups: Dict[int, FrozenSet[Address]] = {}
        self.shards: Dict[int, List[int]] = {}  # group id -> sorted shards

    # ----------------------------------------------------------- rebalancing

    def _largest(self) -> int:
        return max(self.shards, key=lambda g: (len(self.shards[g]), -g))

    def _smallest(self) -> int:
        return min(self.shards, key=lambda g: (len(self.shards[g]), g))

    def _snapshot(self) -> None:
        num = (self.configs[-1].config_num + 1 if self.configs
               else INITIAL_CONFIG_NUM)
        self.configs.append(ShardConfig(num, {
            g: (self.groups[g], frozenset(s)) for g, s in self.shards.items()}))

    def _balanced(self) -> bool:
        sizes = [len(s) for s in self.shards.values()]
        return max(sizes) - min(sizes) <= 1

    def _move_one(self, frm: int, to: int) -> None:
        shard = self.shards[frm].pop()  # highest-numbered shard: deterministic
        self.shards[to].append(shard)
        self.shards[to].sort()

    # -------------------------------------------------------------- commands

    def execute(self, command: Command) -> Result:
        if isinstance(command, Join):
            if command.group_id in self.groups:
                return Error()
            self.groups[command.group_id] = command.servers
            if not self.shards:
                self.shards[command.group_id] = list(
                    range(1, self.num_shards + 1))
            else:
                self.shards[command.group_id] = []
                target = self.num_shards // len(self.shards)
                while len(self.shards[command.group_id]) < target:
                    self._move_one(self._largest(), command.group_id)
                while not self._balanced():
                    self._move_one(self._largest(), self._smallest())
            self._snapshot()
            return Ok()

        if isinstance(command, Leave):
            if command.group_id not in self.groups or len(self.groups) == 1:
                return Error()
            del self.groups[command.group_id]
            orphaned = self.shards.pop(command.group_id)
            for shard in sorted(orphaned):
                g = self._smallest()
                self.shards[g].append(shard)
                self.shards[g].sort()
            self._snapshot()
            return Ok()

        if isinstance(command, Move):
            g, shard = command.group_id, command.shard_num
            if (g not in self.groups or shard < 1 or shard > self.num_shards
                    or shard in self.shards[g]):
                return Error()
            for other in self.shards.values():
                if shard in other:
                    other.remove(shard)
            self.shards[g].append(shard)
            self.shards[g].sort()
            self._snapshot()
            return Ok()

        if isinstance(command, Query):
            if not self.configs:
                return Error()
            n = command.config_num
            if n < 0 or n >= len(self.configs):
                return self.configs[-1]
            return self.configs[n]

        raise ValueError(f"Unknown ShardMaster command: {command!r}")
