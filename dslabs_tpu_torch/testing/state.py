"""AbstractState: common base of the run state and the search state.

Re-design of framework/tst/.../AbstractState.java:50-324.  Holds three node
maps (servers, client workers, bare clients) plus the NodeGenerator; the
copy constructor used for successor states clones **only one designated node**
(copy-on-write stepping, AbstractState.java:96-115).  Equality covers exactly
the node maps.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, Optional

from dslabs_tpu_torch.core.address import Address
from dslabs_tpu_torch.core.node import Node
from dslabs_tpu_torch.testing.client_worker import ClientWorker
from dslabs_tpu_torch.testing.generator import NodeGenerator
from dslabs_tpu_torch.testing.workload import Workload
from dslabs_tpu_torch.utils.structural import StructEq, clone

__all__ = ["AbstractState"]


class AbstractState(StructEq):

    def __init__(self, generator: NodeGenerator):
        self.servers: Dict[Address, Node] = {}
        self.client_workers_map: Dict[Address, ClientWorker] = {}
        self.clients: Dict[Address, Node] = {}
        self._gen = generator

    @classmethod
    def _cow_copy(cls, src: "AbstractState", node_to_clone: Address) -> "AbstractState":
        """Copy-on-write successor: share every node except ``node_to_clone``,
        which is deep-cloned (AbstractState.java:96-115).  Subclasses must
        finish their own bookkeeping after calling this."""
        new = cls.__new__(cls)
        new.servers = dict(src.servers)
        new.client_workers_map = dict(src.client_workers_map)
        new.clients = dict(src.clients)
        new._gen = src._gen
        root = node_to_clone.root_address()
        for m in (new.servers, new.client_workers_map, new.clients):
            if root in m:
                m[root] = clone(m[root])
                break
        return new

    # -------------------------------------------------------------- equality

    def _eq_fields(self):
        return {"servers": self.servers,
                "client_workers": self.client_workers_map,
                "clients": self.clients}

    # ------------------------------------------------------------- accessors

    @property
    def generator(self) -> NodeGenerator:
        return self._gen

    def client_workers(self) -> Dict[Address, ClientWorker]:
        return self.client_workers_map

    def node(self, address: Address) -> Optional[Node]:
        root = address.root_address()
        return (self.servers.get(root) or self.client_workers_map.get(root)
                or self.clients.get(root))

    def has_node(self, address: Address) -> bool:
        return self.node(address) is not None

    def addresses(self) -> Iterable[Address]:
        yield from self.servers
        yield from self.client_workers_map
        yield from self.clients

    def nodes(self) -> Iterable[Node]:
        yield from self.servers.values()
        yield from self.client_workers_map.values()
        yield from self.clients.values()

    def num_nodes(self) -> int:
        return (len(self.servers) + len(self.client_workers_map)
                + len(self.clients))

    # ----------------------------------------------------------- add / remove

    def add_server(self, address: Address) -> Node:
        node = self._gen.server(address)
        self.servers[address] = node
        self._setup_node(address)
        return node

    def add_client_worker(self, address: Address,
                          workload: Optional[Workload] = None,
                          record_commands_and_results: bool = True) -> ClientWorker:
        client = self._gen.client(address)
        if workload is None:
            workload = self._gen.workload(address)
        worker = ClientWorker(client, workload, record_commands_and_results)
        self.client_workers_map[address] = worker
        self._setup_node(address)
        return worker

    def add_client(self, address: Address) -> Node:
        node = self._gen.client(address)
        self.clients[address] = node
        self._setup_node(address)
        return node

    def remove_node(self, address: Address) -> None:
        root = address.root_address()
        for m in (self.servers, self.client_workers_map, self.clients):
            if root in m:
                del m[root]
                self._cleanup_node(root)
                return
        raise KeyError(f"No node at {address}")

    def add_command(self, command, result=None) -> None:
        """Fan a command out to every client worker (AbstractState.java:265-323)."""
        for worker in self.client_workers_map.values():
            self._ensure_node_config(worker.address)
            worker.add_command(command, result)

    # ------------------------------------------------------- engine contract

    def network(self):
        raise NotImplementedError

    def timers(self, address: Address):
        raise NotImplementedError

    def _setup_node(self, address: Address) -> None:
        raise NotImplementedError

    def _ensure_node_config(self, address: Address) -> None:
        raise NotImplementedError

    def _cleanup_node(self, address: Address) -> None:
        raise NotImplementedError
