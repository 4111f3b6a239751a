"""Per-lab debugger configurations — VizConfig re-design
(visualization/VizConfig.java:46-131): each lab registers a builder that
parses ``numServers numClients workload...`` CLI-style arguments into an
initial SearchState, so `run_tests.py --debugger -l LAB args...` (and the
trace viewer's synthetic-trace mode) can start from a fresh system."""

from __future__ import annotations

from typing import Callable, Dict, List

__all__ = ["VizConfig", "register_viz_config", "viz_configs"]

VizConfig = Callable[[List[str]], object]   # args -> SearchState

_CONFIGS: Dict[str, VizConfig] = {}


def register_viz_config(lab: str):
    def deco(fn: VizConfig) -> VizConfig:
        _CONFIGS[str(lab)] = fn
        return fn

    return deco


def viz_configs() -> Dict[str, VizConfig]:
    _ensure_builtin()
    return dict(_CONFIGS)


def _ensure_builtin() -> None:
    if "0" in _CONFIGS:
        return

    @register_viz_config("0")
    def lab0(args: List[str]):
        from dslabs_tpu_torch.core.address import LocalAddress
        from dslabs_tpu_torch.labs.pingpong.pingpong import (Ping, PingClient,
                                                       PingServer, Pong)
        from dslabs_tpu_torch.search.search_state import SearchState
        from dslabs_tpu_torch.testing.generator import NodeGenerator
        from dslabs_tpu_torch.testing.workload import Workload

        n_clients = int(args[1]) if len(args) > 1 else 1
        cmds = args[2].split(",") if len(args) > 2 else ["hello"]
        server = LocalAddress("pingserver")
        gen = NodeGenerator(
            server_supplier=lambda a: PingServer(a),
            client_supplier=lambda a: PingClient(a, server),
            workload_supplier=lambda a: Workload(
                command_strings=list(cmds), result_strings=list(cmds),
                parser=lambda c, r: (Ping(c),
                                     Pong(r) if r is not None else None)))
        state = SearchState(gen)
        state.add_server(server)
        for i in range(1, n_clients + 1):
            state.add_client_worker(LocalAddress(f"client{i}"))
        return state

    @register_viz_config("1")
    def lab1(args: List[str]):
        from dslabs_tpu_torch.core.address import LocalAddress
        from dslabs_tpu_torch.labs.clientserver.clientserver import (SimpleClient,
                                                               SimpleServer)
        from dslabs_tpu_torch.labs.clientserver.kv_workload import kv_workload
        from dslabs_tpu_torch.labs.clientserver.kvstore import KVStore
        from dslabs_tpu_torch.search.search_state import SearchState
        from dslabs_tpu_torch.testing.generator import NodeGenerator

        n_clients = int(args[1]) if len(args) > 1 else 1
        cmds = (args[2].split(",") if len(args) > 2
                else ["PUT:foo:bar", "GET:foo"])
        server = LocalAddress("server")
        gen = NodeGenerator(
            server_supplier=lambda a: SimpleServer(a, KVStore()),
            client_supplier=lambda a: SimpleClient(a, server),
            workload_supplier=lambda a: kv_workload(list(cmds)))
        state = SearchState(gen)
        state.add_server(server)
        for i in range(1, n_clients + 1):
            state.add_client_worker(LocalAddress(f"client{i}"))
        return state

    @register_viz_config("3")
    def lab3(args: List[str]):
        from dslabs_tpu_torch.core.address import LocalAddress
        from dslabs_tpu_torch.labs.clientserver.kv_workload import kv_workload
        from dslabs_tpu_torch.labs.clientserver.kvstore import KVStore
        from dslabs_tpu_torch.labs.paxos.paxos import PaxosClient, PaxosServer
        from dslabs_tpu_torch.search.search_state import SearchState
        from dslabs_tpu_torch.testing.generator import NodeGenerator

        n_servers = int(args[0]) if args else 3
        n_clients = int(args[1]) if len(args) > 1 else 1
        cmds = (args[2].split(",") if len(args) > 2
                else ["PUT:foo:bar", "GET:foo"])
        servers = tuple(LocalAddress(f"server{i}")
                        for i in range(1, n_servers + 1))
        gen = NodeGenerator(
            server_supplier=lambda a: PaxosServer(a, servers, KVStore()),
            client_supplier=lambda a: PaxosClient(a, servers),
            workload_supplier=lambda a: kv_workload(list(cmds)))
        state = SearchState(gen)
        for a in servers:
            state.add_server(a)
        for i in range(1, n_clients + 1):
            state.add_client_worker(LocalAddress(f"client{i}"))
        return state
