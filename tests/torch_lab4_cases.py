"""Lab 4 search-test shapes for the harness binding, built from either
package (``torch_harness_cases.Pkg``): ``dslabs_tpu`` (the JAX reference
and its object checker) or ``dslabs_tpu_torch`` (the port and its own
copy of the object layer).  Shared by ``tests/test_torch_lab4_harness.py``,
``tests/test_torch_object.py`` and the ``lab4`` and ``swarm`` phases of
``chip_smoke.py``.

A lab 4 search test runs in two phases (``tests/test_lab4_shardstore.py``
``_joined_state``): the join phase drives the config controller's Join
commands through the shard master, cut off from the store servers; the
main phase adds the store clients to the join phase's goal state and
searches that.  :func:`join_case` builds the first, :func:`joined_state`
runs it through the package's ``search.bfs`` (so on whichever backend the
package's ``GlobalSettings.search_backend`` names), and each entry of
:data:`SHAPES` builds the phases of one main-phase search test from a
joined state.  :data:`DFS` holds the lab 4 ``dfs`` call sites.
"""

from typing import Callable, Dict, List, Tuple

from tests.torch_harness_cases import Case

NUM_SHARDS = 10


def cca(pkg):
    return pkg.LocalAddress("configController")


def shard_master(pkg, i=1):
    return pkg.LocalAddress(f"shardmaster{i}")


def store_server(pkg, g, i=1):
    return pkg.LocalAddress(f"server{g}-{i}")


def make_search(pkg, num_groups, servers_per_group=1, num_shard_masters=1,
                num_shards=NUM_SHARDS):
    """``tests/test_lab4_shardstore.py`` make_search: shard masters
    running ShardMaster under Paxos, ``num_groups`` store groups, the
    config controller a PaxosClient and every other client a
    ShardStoreClient."""
    PaxosServer = pkg.mod("labs.paxos.paxos").PaxosServer
    PaxosClient = pkg.mod("labs.paxos.paxos").PaxosClient
    ShardMaster = pkg.mod("labs.shardedstore.shardmaster").ShardMaster
    ss = pkg.mod("labs.shardedstore.shardstore")
    masters = tuple(shard_master(pkg, i)
                    for i in range(1, num_shard_masters + 1))
    controller = cca(pkg)

    def server_supplier(a):
        if a in masters:
            return PaxosServer(a, masters, ShardMaster(num_shards))
        g = int(str(a).split("server")[1].split("-")[0])
        grp = tuple(store_server(pkg, g, i)
                    for i in range(1, servers_per_group + 1))
        return ss.ShardStoreServer(a, masters, num_shards, grp, g)

    def client_supplier(a):
        if a == controller:
            return PaxosClient(a, masters)
        return ss.ShardStoreClient(a, masters, num_shards)

    gen = pkg.NodeGenerator(server_supplier=server_supplier,
                            client_supplier=client_supplier,
                            workload_supplier=lambda a: None)
    state = pkg.SearchState(gen)
    for m in masters:
        state.add_server(m)
    for g in range(1, num_groups + 1):
        for i in range(1, servers_per_group + 1):
            state.add_server(store_server(pkg, g, i))
    return state


def join_case(pkg, n_groups, num_shards=NUM_SHARDS, servers_per_group=1):
    """The join phase of ``_joined_state``: the controller's Join(1..G)
    workload, partition {controller, shard master}, store-server timers
    suppressed, goal: the controller done."""
    sm = pkg.mod("labs.shardedstore.shardmaster")
    preds = pkg.mod("testing.predicates")
    state = make_search(pkg, n_groups, servers_per_group, 1, num_shards)
    cmds = [sm.Join(g, frozenset(store_server(pkg, g, i)
                                 for i in range(1, servers_per_group + 1)))
            for g in range(1, n_groups + 1)]
    state.add_client_worker(cca(pkg), pkg.Workload(
        commands=cmds, results=[sm.Ok()] * len(cmds)))
    s = pkg.SearchSettings().max_time(420)
    s.add_invariant(pkg.RESULTS_OK)
    s.partition(cca(pkg), shard_master(pkg))
    for a in list(state.servers):
        if "server" in str(a):
            s.deliver_timers(a, False)
    s.add_goal(preds.client_done(cca(pkg)))
    return Case(state, s, ("GOAL_FOUND",))


def joined_state(pkg, n_groups, num_shards=NUM_SHARDS, servers_per_group=1,
                 run=None):
    """Run the join phase through ``run(case) -> SearchResults`` (the
    package's ``search.bfs`` by default) and return its goal state, the
    main phase's root."""
    case = join_case(pkg, n_groups, num_shards, servers_per_group)
    if run is None:
        res = pkg.mod("search.search").bfs(case.state, case.settings)
    else:
        res = run(case)
    assert res.end_condition.name == "GOAL_FOUND", res
    return res.goal_matching_state


def _main_settings(pkg, max_time):
    """The main phase's narrowing: controller inactive and its timers
    off, the shard master's timers off (it is already the decided
    leader)."""
    s = pkg.SearchSettings()
    if max_time is not None:
        s.max_time(max_time)
    s.add_invariant(pkg.RESULTS_OK)
    s.node_active(cca(pkg), False)
    s.deliver_timers(cca(pkg), False)
    s.deliver_timers(shard_master(pkg), False)
    return s


def _kv(pkg, joined, i, cmds, results):
    joined.add_client_worker(pkg.LocalAddress(f"client{i}"),
                             pkg.kv_workload(cmds, results))


def _tx(pkg, joined, i, cmds, results):
    joined.add_client_worker(pkg.LocalAddress(f"client{i}"),
                             pkg.Workload(commands=cmds, results=results))


def _goal_then_pruned(pkg, joined, goal_time, levels, prune_time):
    """The goal search, then the CLIENTS_DONE-pruned search ``levels``
    below the joined root (test10 of part 2, test08 of part 3)."""
    goal = _main_settings(pkg, goal_time).add_goal(pkg.CLIENTS_DONE)
    pruned = _main_settings(pkg, prune_time).add_prune(pkg.CLIENTS_DONE)
    pruned.set_max_depth(joined.depth + levels)
    return [Case(joined, goal, ("GOAL_FOUND",)),
            Case(joined, pruned, ("SPACE_EXHAUSTED", "TIME_EXHAUSTED"))]


def p2_test10(pkg, joined, levels=6):
    """Part 2 test10: one client PUT foo=bar then GET foo, one group."""
    _kv(pkg, joined, 1, ["PUT:foo:bar", "GET:foo"], ["PutOk", "bar"])
    return _goal_then_pruned(pkg, joined, 240, levels, 240)


def p2_test11(pkg, joined):
    """Part 2 test11 in its tier-1 form: a workload over both groups'
    shards, searched six levels down within 120 s."""
    _kv(pkg, joined, 1, ["PUT:key-1:v1", "PUT:key-6:v6", "GET:key-1"],
        ["PutOk", "PutOk", "v1"])
    s = _main_settings(pkg, 120).set_max_depth(joined.depth + 6)
    return [Case(joined, s, ("SPACE_EXHAUSTED", "TIME_EXHAUSTED"))]


def p2_test12(pkg, joined):
    """Part 2 test12 in its tier-1 form: two clients appending to keys
    of different groups, six levels down within 120 s."""
    _kv(pkg, joined, 1, ["APPEND:foo-1:X1"], ["X1"])
    _kv(pkg, joined, 2, ["APPEND:foo-2:Y2"], ["Y2"])
    s = _main_settings(pkg, 120).set_max_depth(joined.depth + 6)
    return [Case(joined, s, ("SPACE_EXHAUSTED", "TIME_EXHAUSTED"))]


def p3_test08(pkg, joined, levels=6):
    """Part 3 test08: MultiPut then MultiGet in one group (single-group
    transactions bind to the part-1 twin)."""
    tx = pkg.mod("labs.shardedstore.txkvstore")
    _tx(pkg, joined, 1,
        [tx.MultiPut({"key-1": "x", "key-2": "y"}),
         tx.MultiGet({"key-1", "key-2"})],
        [tx.MultiPutOk(), tx.MultiGetResult({"key-1": "x", "key-2": "y"})])
    return _goal_then_pruned(pkg, joined, 240, levels, 240)


def p3_test09(pkg, joined, levels=None):
    """Part 3 test09: a MultiPut across both groups (the 2PC twin), goal
    CLIENTS_DONE; with ``levels``, the depth-limited search without a
    goal instead, whose count is exact."""
    tx = pkg.mod("labs.shardedstore.txkvstore")
    _tx(pkg, joined, 1, [tx.MultiPut({"key-1": "x", "key-2": "y"})],
        [tx.MultiPutOk()])
    if levels is None:
        s = _main_settings(pkg, 300).add_goal(pkg.CLIENTS_DONE)
        return [Case(joined, s, ("GOAL_FOUND",))]
    s = _main_settings(pkg, None).set_max_depth(joined.depth + levels)
    return [Case(joined, s, ("SPACE_EXHAUSTED",), exact=True)]


def count_parity(pkg, joined, levels=4):
    """``tests/test_search_backend.py`` test_lab4_two_phase_tensor's last
    phase: test10's workload, CLIENTS_DONE-pruned, ``levels`` below the
    joined root, no time limit; the count is exact."""
    _kv(pkg, joined, 1, ["PUT:foo:bar", "GET:foo"], ["PutOk", "bar"])
    s = _main_settings(pkg, None).add_prune(pkg.CLIENTS_DONE)
    s.set_max_depth(joined.depth + levels)
    return [Case(joined, s, ("SPACE_EXHAUSTED",), exact=True)]


# name -> (groups, shards, fn(pkg, joined) -> phases run in order).
SHAPES: Dict[str, Tuple[int, int, Callable[..., List[Case]]]] = {
    "p2_test10": (1, NUM_SHARDS, p2_test10),
    "p2_test11": (2, NUM_SHARDS, p2_test11),
    "p2_test12": (2, 2, p2_test12),
    "p3_test08": (1, 2, p3_test08),
    "p3_test09": (2, 2, p3_test09),
    "count_parity": (1, NUM_SHARDS, count_parity),
}


# ---------------------------------------------------------- dfs call sites

NO_TERMINAL = ("TIME_EXHAUSTED", "SPACE_EXHAUSTED")


def _random_settings(pkg, max_time=8):
    """The random searches' settings: depth 1000, RESULTS_OK, CLIENTS_DONE
    pruned, every node active (no main-phase narrowing)."""
    s = pkg.SearchSettings().set_max_depth(1000).max_time(max_time)
    s.add_invariant(pkg.RESULTS_OK)
    s.add_prune(pkg.CLIENTS_DONE)
    return s


def p2_random(pkg, joined):
    """Part 2 test13 / test14 (``tests/test_lab4_shardstore.py:616``
    ``_random_search``): two groups over two shards, clients appending to
    foo-1 and foo-2, 8 s; no terminal state."""
    _kv(pkg, joined, 1, ["APPEND:foo-1:x"], None)
    _kv(pkg, joined, 2, ["APPEND:foo-2:y"], None)
    return [Case(joined, _random_settings(pkg), NO_TERMINAL)]


def p3_test11_random(pkg, joined):
    """Part 3 test11 (``tests/test_lab4_shardstore.py:974``): client1
    MultiPut then Swap over key-1 and key-2, client2 MultiGet, 8 s; no
    terminal state."""
    tx = pkg.mod("labs.shardedstore.txkvstore")
    joined.add_client_worker(pkg.LocalAddress("client1"), pkg.Workload(
        commands=[tx.MultiPut({"key-1": "x", "key-2": "y"}),
                  tx.Swap("key-1", "key-2")]))
    joined.add_client_worker(pkg.LocalAddress("client2"), pkg.Workload(
        commands=[tx.MultiGet({"key-1", "key-2"})]))
    return [Case(joined, _random_settings(pkg), NO_TERMINAL)]


def p3_test12_random(pkg):
    """Part 3 test12 (``tests/test_lab4_shardstore.py:941``
    ``_tx_random_search(3)``): no join phase; the controller's Join, Join,
    Leave(1) race client1's MultiPut and client2's MultiGet over three
    servers per group, with the MultiGet-atomicity invariant (an object
    predicate with no tensor translation), 20 s; no terminal state."""
    sm = pkg.mod("labs.shardedstore.shardmaster")
    tx = pkg.mod("labs.shardedstore.txkvstore")
    state = make_search(pkg, 2, 3, 1, 2)

    def grp(g):
        return frozenset(store_server(pkg, g, i) for i in range(1, 4))

    cmds = [sm.Join(1, grp(1)), sm.Join(2, grp(2)), sm.Leave(1)]
    state.add_client_worker(cca(pkg), pkg.Workload(
        commands=cmds, results=[sm.Ok()] * len(cmds)))
    state.add_client_worker(pkg.LocalAddress("client1"), pkg.Workload(
        commands=[tx.MultiPut({"foo-1": "X", "foo-2": "Y"})],
        results=[tx.MultiPutOk()]))
    state.add_client_worker(pkg.LocalAddress("client2"), pkg.Workload(
        commands=[tx.MultiGet({"foo-1", "foo-2"})]))
    ok_full = tx.MultiGetResult({"foo-1": "X", "foo-2": "Y"})
    ok_none = tx.MultiGetResult({"foo-1": tx.KEY_NOT_FOUND,
                                 "foo-2": tx.KEY_NOT_FOUND})

    def multi_get_atomic(s):
        results = s.client_workers()[pkg.LocalAddress("client2")].results
        if not results:
            return True
        if len(results) > 1:
            return False, "client2 received multiple MultiGetResults"
        if results[0] != ok_full and results[0] != ok_none:
            return False, f"{results[0]} matches neither"
        return True

    s = pkg.SearchSettings().set_max_depth(1000).max_time(20)
    s.add_invariant(pkg.StatePredicate("MultiGet returns correct results",
                                       multi_get_atomic))
    s.add_invariant(pkg.RESULTS_OK)
    s.add_prune(pkg.CLIENTS_DONE)
    return Case(state, s, NO_TERMINAL)


# The lab 4 dfs call sites: name -> (groups, shards, servers per group,
# fn(pkg, joined) -> [Case]) after the join phase, or (None, None, None,
# fn(pkg) -> Case) for a search with no join phase.
DFS: Dict[str, Tuple] = {
    "p2_test13": (2, 2, 1, p2_random),
    "p2_test14": (2, 2, 3, p2_random),
    "p3_test11": (2, 2, 1, p3_test11_random),
    "p3_test12": (None, None, None, p3_test12_random),
}


def dfs_cases(pkg, name, run=None):
    """The searches of one lab 4 dfs call site, its join phase run by
    ``run`` (see :func:`joined_state`)."""
    groups, shards, spg, build = DFS[name]
    if groups is None:
        return [build(pkg)]
    joined = joined_state(pkg, groups, shards, servers_per_group=spg,
                          run=run)
    return build(pkg, joined)


def reference_pins():
    """The JAX package's numbers behind the port's lab 4 pins, on the CPU
    (run under ``JAX_PLATFORMS=cpu``; about fifteen minutes): the
    multi-server twin's unique / explored counts at depths 1 and 2 (its
    generated and its hand twin), the two slow goal searches at chunk
    1024 and ``frontier_cap=2^18``, part 3 test09's goal through the JAX
    ``tensor_bfs`` (the exception it raises, if any) and through the
    object checker.  Yields one dict per result."""
    import dataclasses
    import sys
    import time

    from tests.torch_harness_cases import Pkg

    ref = Pkg("dslabs_tpu")
    eng, lab4 = ref.mod("tpu.engine"), ref.mod("tpu.specs_lab4")
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent
                           / "fixtures"))
    from hand_twins.shardstore_multi import \
        make_shardstore_multi_protocol as hand_multi

    for name, make in (("multi", lab4.make_shardstore_multi_protocol),
                       ("multi_hand", hand_multi)):
        for depth in (1, 2):
            t = time.time()
            o = eng.TensorSearch(dataclasses.replace(make(), goals={}),
                                 chunk=512, max_depth=depth).run()
            yield dict(run=name, depth=depth, unique=o.unique_states,
                       explored=o.states_explored, secs=time.time() - t)
    for name, make, depth in (
            ("store_11_goal",
             lambda: lab4.make_shardstore_protocol([1, 1]), 11),
            ("tx_1_goal", lambda: lab4.make_shardstore_tx_protocol(1), 14)):
        t = time.time()
        o = eng.TensorSearch(make(), chunk=1024, frontier_cap=1 << 18,
                             max_depth=depth).run()
        yield dict(run=name, key=[o.end_condition, o.unique_states,
                                  o.states_explored, o.depth],
                   secs=time.time() - t)
    backend = ref.mod("tpu.backend")
    ref.mod("utils.flags").GlobalSettings.search_backend = "tensor"
    t = time.time()
    joined = joined_state(ref, 2, 2, run=lambda c: backend.tensor_bfs(
        c.state, c.settings))
    (case,) = p3_test09(ref, joined)
    try:
        res = backend.tensor_bfs(case.state, case.settings)
        out = dict(end=res.end_condition.name,
                   depth=res.goal_matching_state.depth)
    except Exception as e:                      # noqa: BLE001 - reported
        out = dict(error=f"{type(e).__name__}: {e}")
    yield dict(run="p3_test09_jax_tensor_bfs", secs=time.time() - t, **out)
    ref.mod("utils.flags").GlobalSettings.search_backend = "object"
    t = time.time()
    joined = joined_state(ref, 2, 2)
    (case,) = p3_test09(ref, joined)
    res = ref.mod("search.search").BFS(case.settings).run(case.state)
    yield dict(run="p3_test09_object", end=res.end_condition.name,
               depth=res.goal_matching_state.depth,
               discovered=res.discovered_count, secs=time.time() - t)


if __name__ == "__main__":
    import json

    for rec in reference_pins():
        print(json.dumps(rec), flush=True)
