"""Lab search-test shapes for the harness binding, built from either
package: ``dslabs_tpu`` (the JAX reference and its object checker) or
``dslabs_tpu_torch`` (the port and its own copy of the object layer).
One builder per shape, parametrised by the package root, so the two sides
cannot drift.  Shared by ``tests/test_torch_harness.py``,
``tests/test_torch_object.py`` and the ``harness`` phase of
``chip_smoke.py``.

Each case is ``fn(pkg) -> Case``: a fresh object ``SearchState``, its
``SearchSettings``, the end conditions the lab test accepts, and whether
the run ends by depth or by space (so its ``discovered_count`` is exact
and comparable across checkers).  The shapes are those of
``tests/test_search_backend.py`` and ``tests/test_lab3_paxos.py``."""

import dataclasses
import importlib
from typing import Callable, Dict, Tuple


class Pkg:
    """Lazy module access under one package root: ``pkg.mod("core.address")``
    and the handful of names the builders use as attributes."""

    def __init__(self, root: str):
        self.root = root

    def mod(self, name: str):
        return importlib.import_module(f"{self.root}.{name}")

    def __getattr__(self, name):
        where = _NAMES.get(name)
        if where is None:
            raise AttributeError(name)
        return getattr(self.mod(where), name)


_NAMES = {
    "LocalAddress": "core.address",
    "SearchState": "search.search_state",
    "SearchSettings": "search.settings",
    "NodeGenerator": "testing.generator",
    "Workload": "testing.workload",
    "StatePredicate": "testing.predicates",
    "RESULTS_OK": "testing.predicates",
    "CLIENTS_DONE": "testing.predicates",
    "NONE_DECIDED": "testing.predicates",
    "client_has_results": "testing.predicates",
    "kv_workload": "labs.clientserver.kv_workload",
    "different_keys_infinite_workload": "labs.clientserver.kv_workload",
    "KVStore": "labs.clientserver.kvstore",
    "Put": "labs.clientserver.kvstore",
    "SimpleClient": "labs.clientserver.clientserver",
    "SimpleServer": "labs.clientserver.clientserver",
    "Ping": "labs.pingpong.pingpong",
    "Pong": "labs.pingpong.pingpong",
    "PingClient": "labs.pingpong.pingpong",
    "PingServer": "labs.pingpong.pingpong",
    "ViewServer": "labs.primarybackup.viewserver",
    "PBClient": "labs.primarybackup.pb",
    "PBServer": "labs.primarybackup.pb",
    "PaxosClient": "labs.paxos.paxos",
    "PaxosServer": "labs.paxos.paxos",
    "LOGS_CONSISTENT_ALL_SLOTS": "labs.paxos.predicates",
}


@dataclasses.dataclass
class Case:
    state: object
    settings: object
    expect: Tuple[str, ...]         # EndCondition names the lab test accepts
    exact: bool = False             # ends by depth or space: counts compare


# ------------------------------------------------------------------ states

def lab0_state(pkg, num_pings=2):
    """``tests/test_lab0_search.py`` make_state: one PingClient, two pings."""
    server = pkg.LocalAddress("pingserver")

    def parser(cmd, res):
        return pkg.Ping(cmd), (pkg.Pong(res) if res is not None else None)

    gen = pkg.NodeGenerator(
        server_supplier=lambda a: pkg.PingServer(a),
        client_supplier=lambda a: pkg.PingClient(a, server),
        workload_supplier=lambda a: pkg.Workload(
            command_strings=["ping-%i"] * num_pings,
            result_strings=["ping-%i"] * num_pings, parser=parser))
    state = pkg.SearchState(gen)
    state.add_server(server)
    state.add_client_worker(pkg.LocalAddress("client1"))
    return state


def lab1_state(pkg, workloads=None, workload_factory=None):
    """``tests/test_lab1.py`` _search_state: a SimpleServer over a KVStore;
    ``workloads`` adds one client per workload, else one client drawing
    from ``workload_factory``."""
    server = pkg.LocalAddress("server")
    gen = pkg.NodeGenerator(
        server_supplier=lambda a: pkg.SimpleServer(a, pkg.KVStore()),
        client_supplier=lambda a: pkg.SimpleClient(a, server),
        workload_supplier=lambda a: (workload_factory()
                                     if workload_factory else None))
    state = pkg.SearchState(gen)
    state.add_server(server)
    if workloads is None:
        state.add_client_worker(pkg.LocalAddress("client1"))
    for i, wl in enumerate(workloads or (), start=1):
        state.add_client_worker(pkg.LocalAddress(f"client{i}"), wl)
    return state


def lab2_state(pkg, ns=1):
    """``tests/test_lab2_pb.py`` test16: ViewServer, ``ns`` PBServers, one
    client with PUT foo=bar then GET foo."""
    vsa = pkg.LocalAddress("viewserver")
    workload = pkg.kv_workload(["PUT:foo:bar", "GET:foo"], ["PutOk", "bar"])

    def server_supplier(a):
        if a == vsa:
            return pkg.ViewServer(a)
        return pkg.PBServer(a, vsa, pkg.KVStore())

    gen = pkg.NodeGenerator(server_supplier=server_supplier,
                            client_supplier=lambda a: pkg.PBClient(a, vsa),
                            workload_supplier=lambda a: workload)
    state = pkg.SearchState(gen)
    state.add_server(vsa)
    for i in range(1, ns + 1):
        state.add_server(server(pkg, i))
    state.add_client_worker(pkg.LocalAddress("client1"))
    return state


def no_twin_state(pkg):
    """A ViewServer alone: no adapter matches it."""
    gen = pkg.NodeGenerator(server_supplier=lambda a: pkg.ViewServer(a),
                            client_supplier=lambda a: None,
                            workload_supplier=lambda a: None)
    state = pkg.SearchState(gen)
    state.add_server(pkg.LocalAddress("viewserver"))
    return state


def server(pkg, i):
    return pkg.LocalAddress(f"server{i}")


def client(pkg, i):
    return pkg.LocalAddress(f"client{i}")


def lab3_state(pkg, n, workloads):
    """``tests/test_lab3_paxos.py`` make_search_state(n) with one client
    per (commands, results) pair of ``workloads``."""
    addrs = tuple(server(pkg, i) for i in range(1, n + 1))
    gen = pkg.NodeGenerator(
        server_supplier=lambda a: pkg.PaxosServer(a, addrs, pkg.KVStore()),
        client_supplier=lambda a: pkg.PaxosClient(a, addrs),
        workload_supplier=lambda a: None)
    state = pkg.SearchState(gen)
    for a in addrs:
        state.add_server(a)
    for i, (cmds, res) in enumerate(workloads, start=1):
        state.add_client_worker(client(pkg, i), pkg.kv_workload(cmds, res))
    return state


# ------------------------------------------------------------------- cases

def _s(pkg):
    return pkg.SearchSettings()


def lab0_goal(pkg):
    return Case(lab0_state(pkg), _s(pkg).add_invariant(pkg.RESULTS_OK)
                .add_goal(pkg.CLIENTS_DONE), ("GOAL_FOUND",))


def lab0_exhaust(pkg):
    return Case(lab0_state(pkg), _s(pkg).add_invariant(pkg.RESULTS_OK)
                .add_prune(pkg.CLIENTS_DONE), ("SPACE_EXHAUSTED",),
                exact=True)


def lab0_violation(pkg):
    return Case(lab0_state(pkg), _s(pkg).add_invariant(pkg.NONE_DECIDED),
                ("INVARIANT_VIOLATED",))


def lab1_two_clients(pkg):
    wls = [pkg.kv_workload([f"APPEND:foo:{i}"]) for i in (1, 2)]
    return Case(lab1_state(pkg, wls), _s(pkg).add_invariant(pkg.RESULTS_OK)
                .add_goal(pkg.CLIENTS_DONE).max_time(60), ("GOAL_FOUND",))


# The infinite-workload twin fits the capacity ladder's top rung (net_cap
# 64, timer_cap 8) to depth 15 (51 states, the JAX reference's tensor_bfs
# and its object checker alike) and overflows it at depth 16: the JAX
# reference's tensor_bfs raises CapacityOverflow there ("1 semantic drops
# at depth 16"), where its object checker explores 57 states.  A search
# fast enough to reach depth 16 inside lab1_infinite's 5 s raises too.
INFINITE_FITS = (15, 51)
INFINITE_OVERFLOW_DEPTH = 16


def lab1_infinite(pkg):
    """ClientServerPart2Test.test11's bfs part (derandomized streams:
    the caller sets its package's ``search_backend`` to ``tensor``)."""
    state = lab1_state(pkg, workload_factory=lambda:
                       pkg.different_keys_infinite_workload())
    return Case(state, _s(pkg).add_invariant(pkg.RESULTS_OK).max_time(5),
                ("TIME_EXHAUSTED", "SPACE_EXHAUSTED"))


def lab1_infinite_depth(pkg, depth=8):
    """The same infinite workload, limited by depth instead of time, so
    the run ends by space and its count compares exactly."""
    state = lab1_state(pkg, workload_factory=lambda:
                       pkg.different_keys_infinite_workload())
    return Case(state, _s(pkg).add_invariant(pkg.RESULTS_OK)
                .set_max_depth(depth), ("SPACE_EXHAUSTED",), exact=True)


def lab1_infinite_goal(pkg):
    """The terminal-state decode through the stream reconstruction: the
    goal state's first command is the counter-mode stream's first Put."""
    state = lab1_state(pkg, workload_factory=lambda:
                       pkg.different_keys_infinite_workload())
    s = (_s(pkg).add_invariant(pkg.RESULTS_OK)
         .add_goal(pkg.client_has_results(pkg.LocalAddress("client1"), 1))
         .max_time(60))
    return Case(state, s, ("GOAL_FOUND",))


def lab2_single(pkg):
    return Case(lab2_state(pkg), _s(pkg).add_invariant(pkg.RESULTS_OK)
                .add_goal(pkg.CLIENTS_DONE).max_time(90), ("GOAL_FOUND",))


def lab3_depth4(pkg):
    """``test_search_backend.py::test_lab3_depth_limited_count_parity``."""
    state = lab3_state(pkg, 3, [(["PUT:foo:bar"], None)])
    s = _s(pkg).max_time(120).set_max_depth(4)
    s.partition(server(pkg, 1), server(pkg, 2), client(pkg, 1))
    s.deliver_timers(server(pkg, 3), False)
    s.add_invariant(pkg.LOGS_CONSISTENT_ALL_SLOTS)
    return Case(state, s, ("SPACE_EXHAUSTED",), exact=True)


def lab3_test21(pkg, timers=True):
    """test21: n=5, one PUT, partition {s1, s2, c1}, depth 12; its second
    half freezes every timer."""
    state = lab3_state(pkg, 5, [(["PUT:foo:bar"], None)])
    s = _s(pkg).max_time(20)
    s.add_invariant(pkg.NONE_DECIDED)
    s.add_invariant(pkg.LOGS_CONSISTENT_ALL_SLOTS)
    s.partition(server(pkg, 1), server(pkg, 2), client(pkg, 1))
    s.set_max_depth(12)
    if not timers:
        s.deliver_timers(False)
    return Case(state, s, ("SPACE_EXHAUSTED", "TIME_EXHAUSTED"))


def test20_phase1(pkg):
    """test20 phase 1: n=3, one client PUT+GET, partition {s1, s2, c1},
    goal: something decided."""
    state = lab3_state(pkg, 3, [(["PUT:foo:bar", "GET:foo"],
                                 ["PutOk", "bar"])])
    s = _s(pkg).max_time(60)
    s.partition(server(pkg, 1), server(pkg, 2), client(pkg, 1))
    s.add_invariant(pkg.RESULTS_OK).add_invariant(
        pkg.LOGS_CONSISTENT_ALL_SLOTS)
    s.add_goal(pkg.NONE_DECIDED.negate())
    return Case(state, s, ("GOAL_FOUND",))


def test20_phase2(pkg, goal):
    """test20 phase 2, from phase 1's goal state: CLIENTS_DONE."""
    s = _s(pkg).max_time(60)
    s.add_invariant(pkg.RESULTS_OK).add_invariant(
        pkg.LOGS_CONSISTENT_ALL_SLOTS)
    s.add_goal(pkg.CLIENTS_DONE)
    return Case(goal, s, ("GOAL_FOUND",))


def test20_phase3(pkg, goal):
    """test20 phase 3, from phase 1's goal state: the partitioned subspace
    six levels deeper with every timer frozen, done-pruned."""
    s = _s(pkg).max_time(30).set_max_depth(goal.depth + 6)
    s.partition(server(pkg, 1), server(pkg, 2), client(pkg, 1))
    s.deliver_timers(False)
    s.add_invariant(pkg.RESULTS_OK).add_invariant(
        pkg.LOGS_CONSISTENT_ALL_SLOTS)
    s.add_prune(pkg.CLIENTS_DONE)
    return Case(goal, s, ("SPACE_EXHAUSTED", "TIME_EXHAUSTED"))


def test22_phase1(pkg):
    """test22 phase 1: n=3, two clients appending X and Y, X decided in
    partition {s1, s2, c1}."""
    state = lab3_state(pkg, 3, [(["APPEND:foo:X"], ["X"]),
                                (["APPEND:foo:Y"], ["XY"])])
    s = _s(pkg).max_time(60)
    s.add_invariant(pkg.RESULTS_OK).add_invariant(
        pkg.LOGS_CONSISTENT_ALL_SLOTS)
    s.add_goal(pkg.NONE_DECIDED.negate())
    s.partition(server(pkg, 1), server(pkg, 2), client(pkg, 1))
    return Case(state, s, ("GOAL_FOUND",))


def test22_phase2(pkg, goal, other, spectator):
    """test22 phase 2 in majority ``other`` (server numbers) with client
    2: CLIENTS_DONE, the clients' and the spectator's timers gated."""
    s = _s(pkg).max_time(180)
    s.add_invariant(pkg.RESULTS_OK).add_invariant(
        pkg.LOGS_CONSISTENT_ALL_SLOTS)
    s.add_goal(pkg.CLIENTS_DONE)
    s.partition(*(server(pkg, i) for i in other), client(pkg, 2))
    s.deliver_timers(client(pkg, 1), False)
    s.deliver_timers(client(pkg, 2), False)
    s.deliver_timers(server(pkg, spectator), False)
    return Case(goal, s, ("GOAL_FOUND",))


# The lab 0-2 shapes of tests/test_search_backend.py, by name.
LAB02: Dict[str, Callable] = {
    "lab0_goal": lab0_goal,
    "lab0_exhaust": lab0_exhaust,
    "lab0_violation": lab0_violation,
    "lab1_two_clients": lab1_two_clients,
    "lab1_infinite": lab1_infinite,
    "lab1_infinite_depth": lab1_infinite_depth,
    "lab1_infinite_goal": lab1_infinite_goal,
    "lab2_single": lab2_single,
}


def end_name(results) -> str:
    return results.end_condition.name


def terminal(results):
    """The goal or violating state of a results object, or None."""
    return (results.goal_matching_state
            or results.invariant_violating_state)


def terminal_depth(results):
    st = terminal(results)
    return None if st is None else st.depth
