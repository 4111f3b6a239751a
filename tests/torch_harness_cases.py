"""Lab search-test shapes for the harness binding, built from either
package: ``dslabs_tpu`` (the JAX reference and its object checker) or
``dslabs_tpu_torch`` (the port and its own copy of the object layer).
One builder per shape, parametrised by the package root, so the two sides
cannot drift.  Shared by ``tests/test_torch_harness.py``,
``tests/test_torch_object.py`` and the ``harness`` and ``swarm`` phases
of ``chip_smoke.py``.

Each case is ``fn(pkg) -> Case``: a fresh object ``SearchState``, its
``SearchSettings``, the end conditions the lab test accepts, and whether
the run ends by depth or by space (so its ``discovered_count`` is exact
and comparable across checkers).  The shapes are those of
``tests/test_search_backend.py`` and ``tests/test_lab3_paxos.py``, and
:data:`DFS` holds the lab 0-3 ``dfs`` call sites."""

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
    "append_same_key_workload": "labs.clientserver.kv_workload",
    "APPENDS_LINEARIZABLE": "labs.clientserver.kv_workload",
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
    "LOGS_CONSISTENT": "labs.paxos.predicates",
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


def lab2_state(pkg, ns=1, nc=1, workload=None):
    """``tests/test_lab2_pb.py`` test16: ViewServer, ``ns`` PBServers, one
    client with PUT foo=bar then GET foo; or ``nc`` clients sharing
    ``workload``, as make_search_state hands every client the same one."""
    vsa = pkg.LocalAddress("viewserver")
    if workload is None:
        workload = pkg.kv_workload(["PUT:foo:bar", "GET:foo"],
                                   ["PutOk", "bar"])

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
    for i in range(1, nc + 1):
        state.add_client_worker(client(pkg, i))
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


# ---------------------------------------------------------- dfs call sites

# End conditions of a lab dfs test that asserts ``not terminal_found()``.
NO_TERMINAL = ("TIME_EXHAUSTED", "SPACE_EXHAUSTED")


def lab0_dfs(pkg):
    """``tests/test_lab0_search.py:72`` (test 9): RESULTS_OK, depth 100,
    5 s; no violating state."""
    s = _s(pkg).add_invariant(pkg.RESULTS_OK).set_max_depth(100)
    return Case(lab0_state(pkg), s.max_time(5), NO_TERMINAL)


def lab1_test11_dfs(pkg, n_clients=1):
    """``tests/test_lab1.py:381,386`` (test11's two dfs calls): the
    infinite workload, RESULTS_OK, depth 1000, 5 s; the second call with
    a second infinite-workload client."""
    state = lab1_state(pkg, workload_factory=lambda:
                       pkg.different_keys_infinite_workload())
    if n_clients == 2:
        state.add_client_worker(pkg.LocalAddress("client2"),
                                pkg.different_keys_infinite_workload())
    s = _s(pkg).add_invariant(pkg.RESULTS_OK).set_max_depth(1000)
    return Case(state, s.max_time(5), NO_TERMINAL)


def lab1_deep_probe(pkg, w=10):
    """``tests/test_search_backend.py:342`` test_lab1_deep_probe_dfs: w
    PUTs, the invariant "client1 has fewer than w - 1 results", depth
    1000, 45 s; the violation lies at least 2 (w - 1) levels deep."""
    state = lab1_state(pkg, workload_factory=lambda: pkg.kv_workload(
        [f"PUT:key{i}:v{i}" for i in range(1, w + 1)]))
    s = _s(pkg).max_time(45).set_max_depth(1000)
    s.add_invariant(pkg.client_has_results(pkg.LocalAddress("client1"),
                                           w - 1).negate())
    return Case(state, s, ("INVARIANT_VIOLATED",))


def lab2_test20_dfs(pkg):
    """``tests/test_lab2_pb.py:658`` (test20): two PBServers, two clients
    sharing append_same_key_workload(1), APPENDS_LINEARIZABLE,
    CLIENTS_DONE pruned, depth 1000, 8 s."""
    state = lab2_state(pkg, ns=2, nc=2,
                       workload=pkg.append_same_key_workload(1))
    s = _s(pkg).set_max_depth(1000).max_time(8)
    s.add_invariant(pkg.APPENDS_LINEARIZABLE).add_prune(pkg.CLIENTS_DONE)
    return Case(state, s, NO_TERMINAL)


def _lab3_random(pkg, n, workloads, expect):
    s = _s(pkg).set_max_depth(1000).max_time(8)
    s.add_invariant(pkg.APPENDS_LINEARIZABLE).add_invariant(
        pkg.LOGS_CONSISTENT)
    s.add_prune(pkg.CLIENTS_DONE)
    return Case(lab3_state(pkg, n, workloads), s, expect)


def lab3_test25_dfs(pkg):
    """``tests/test_lab3_paxos.py:331`` (test25): three servers, two
    clients appending x, APPENDS_LINEARIZABLE and LOGS_CONSISTENT,
    CLIENTS_DONE pruned, depth 1000, 8 s; the test demands
    TIME_EXHAUSTED."""
    return _lab3_random(pkg, 3, [(["APPEND:foo:x"], None)] * 2,
                        ("TIME_EXHAUSTED",))


def lab3_test26_dfs(pkg):
    """``tests/test_lab3_paxos.py:758`` (test26): five servers, clients
    appending x and y, otherwise test25's settings; no terminal state."""
    return _lab3_random(pkg, 5, [(["APPEND:foo:x"], None),
                                 (["APPEND:foo:y"], None)], NO_TERMINAL)


# The lab 0-3 dfs call sites (the lab 4 ones are in torch_lab4_cases.py).
DFS: Dict[str, Callable] = {
    "lab0_test9": lab0_dfs,
    "lab1_test11_c1": lab1_test11_dfs,
    "lab1_test11_c2": lambda pkg: lab1_test11_dfs(pkg, 2),
    "lab2_test20": lab2_test20_dfs,
    "lab3_test25": lab3_test25_dfs,
    "lab3_test26": lab3_test26_dfs,
}


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


# ------------------------------------------------------------- swarm twins

def make_lock_protocol(m=6, k=9, noise_bits=16):
    """The deep-narrow combination lock of ``tests/test_swarm.py:71``, as a
    batched port twin: ``m`` persistent digit messages, progress advances
    only on the one correct next digit, and a noise register folds every
    delivered digit into the state, so the space branches ``m`` ways per
    step while the violation (progress == ``k``) lies down exactly one
    digit sequence at depth >= ``k``.  A minimized witness has exactly
    ``k`` events."""
    import numpy as np
    import torch

    from dslabs_tpu_torch.tpu.engine import SENTINEL, TensorProtocol

    MW, TW = 2, 3
    mask = (1 << noise_bits) - 1

    def none(n, width):
        return torch.full((n, 1, width), SENTINEL, dtype=torch.int32)

    def step_message(nodes, msg):
        d = msg[:, 0]
        p, noise = nodes[:, 0], nodes[:, 1]
        good = d == (p * 5 + 3) % m
        nodes2 = torch.stack([torch.where(good, p + 1, p),
                              (noise * 31 + d + 1) & mask], dim=1)
        n = nodes.shape[0]
        return (nodes2.to(torch.int32), none(n, MW).to(nodes.device),
                none(n, 1 + TW).to(nodes.device))

    def step_timer(nodes, node_idx, timer):
        n = nodes.shape[0]
        return (nodes, none(n, MW).to(nodes.device),
                none(n, 1 + TW).to(nodes.device))

    return TensorProtocol(
        name=f"lock-m{m}-k{k}-b{noise_bits}", n_nodes=1, node_width=2,
        msg_width=MW, timer_width=TW, net_cap=m, timer_cap=1,
        max_sends=1, max_sets=1,
        init_nodes=lambda: np.array([0, 0], np.int32),
        init_messages=lambda: np.array([[d, 0] for d in range(m)], np.int32),
        init_timers=lambda: np.zeros((0, 1 + TW), np.int32),
        step_message=step_message, step_timer=step_timer,
        msg_dest=lambda msg: torch.zeros(msg.shape[:-1], dtype=torch.int32,
                                         device=msg.device),
        invariants={"LOCK_HELD": lambda s: s["nodes"][:, 0] < k})


def violating(proto):
    """``tests/test_swarm.py`` ``_violating``: the completion goal negated
    into an invariant, violated exactly at the done state."""
    done = proto.goals["CLIENTS_DONE"]
    return dataclasses.replace(
        proto, goals={},
        invariants={"NOT_DONE": lambda s, f=done: ~f(s)})


def pruned(proto):
    """The completion goal as a prune (the supervisor tests' twins: the
    search runs the whole space).  Module-level, so that a warden child
    imports it by reference (``tests.torch_harness_cases:pruned``)."""
    return dataclasses.replace(
        proto, goals={}, prunes={"CLIENTS_DONE": proto.goals["CLIENTS_DONE"]})


def pruned_without_jax(proto):
    """:func:`pruned`, refusing to run in a process that has loaded JAX
    or the JAX package (the warden child must import neither)."""
    import sys

    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "dslabs_tpu")]
    if loaded:
        raise RuntimeError(f"warden child loaded {loaded[:5]}")
    return pruned(proto)


# ------------------------------------------------ rank runs (tpu/ranks.py)
#
# Module-level factories and transforms that a rank process imports by
# reference ("tests.torch_harness_cases:spec_twin"): a rank builds its
# protocol itself, and imports neither JAX nor the JAX package.

def spec_twin(spec: str = "pingpong_spec", args=(2,), goals: str = "prune",
              root: str = "dslabs_tpu_torch"):
    """A generated spec's compiled twin under either package: ``goals`` is
    ``"prune"`` (the first goal as a prune: the search runs the whole
    space) or ``"drop"`` (no goal: the depth-limited Paxos runs)."""
    p = getattr(importlib.import_module(f"{root}.tpu.specs"), spec)(
        *args).compile()
    if goals == "drop":
        return dataclasses.replace(p, goals={})
    name = next(iter(p.goals))
    return dataclasses.replace(p, goals={}, prunes={name: p.goals[name]})


def lab0_violation_protocol():
    """The bound lab 0 twin of :func:`lab0_violation` under the port (its
    runtime masks deliver everything, so the protocol alone is the run)."""
    from dslabs_tpu_torch.tpu import backend as tback

    case = lab0_violation(Pkg("dslabs_tpu_torch"))
    binding = tback.resolve_binding(case.state)
    proto, _, _ = tback._bind_protocol(binding, case.settings,
                                       *binding.initial_caps())
    return proto


def exchange_inputs(width: int, seed: int = 0) -> dict:
    """Seeded inputs of every exchange operation over ``width`` shards:
    the full ``[D, ...]`` arrays (a rank takes its slice)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    D = width
    return {
        "all_to_all": rng.integers(-9, 9, (D, D, 3, 2)).astype(np.int32),
        "all_to_all_bool": rng.integers(0, 2, (D, D, 5)).astype(bool),
        "psum": rng.integers(-50, 50, (D, 4)).astype(np.int64),
        "pmax": rng.integers(-50, 50, (D, 3)).astype(np.int32),
        "pmin": rng.integers(-50, 50, (D, 3)).astype(np.int32),
        "all_gather": rng.integers(0, 99, (D, 2, 3)).astype(np.int64),
        "gather_np": [rng.integers(0, 2 ** 32, (d + 1, 4), dtype=np.uint64)
                      .astype(np.uint32) for d in range(D)],
    }


def exchange_ops(exchange, seed: int = 0) -> dict:
    """Every exchange operation on this process's slice of
    :func:`exchange_inputs` (a rank's call job)."""
    import torch

    x = exchange_inputs(exchange.width, seed)
    g0, L = exchange.rank * exchange.local_width, exchange.local_width

    def mine(a):
        return torch.from_numpy(a[g0:g0 + L])

    many = exchange.all_to_all_many([mine(x["all_to_all"]),
                                     mine(x["all_to_all_bool"][..., :3])])
    return {
        "all_to_all": exchange.all_to_all(mine(x["all_to_all"])).tolist(),
        "all_to_all_bool": exchange.all_to_all(
            mine(x["all_to_all_bool"])).tolist(),
        "all_to_all_many": [t.tolist() for t in many],
        "psum": exchange.psum(mine(x["psum"])).tolist(),
        "pmax": exchange.pmax(mine(x["pmax"])).tolist(),
        "pmin": exchange.pmin(mine(x["pmin"])).tolist(),
        "all_gather": exchange.all_gather(mine(x["all_gather"])).tolist(),
        "gather_np": [a.tolist() for a in exchange.gather_np(
            x["gather_np"][g0:g0 + L])],
        "agree": [exchange.agree(exchange.rank == 0),
                  exchange.agree(exchange.rank != 0)],
    }


def j4_probe(exchange) -> dict:
    """The hot-path audit's rule J4 on a rank (a call job): a reduction
    through the rank's exchange in a site declared single-device, then
    declared multi-device."""
    import torch

    from dslabs_tpu_torch.analysis import hotpath_audit as H

    x = torch.ones((1, 8), dtype=torch.int64)
    out = {}
    for multi in (False, True):
        found = H.audit_sites({"device.promote": dict(
            fn=exchange.psum, args=(x,), in_place=False, multi=multi,
            syncs=0)}, "Fixture")
        out["multi" if multi else "single"] = [f.as_dict() for f in found]
    return out
