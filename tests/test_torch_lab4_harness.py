"""PyTorch port, the lab 4 harness binding
(``dslabs_tpu_torch/tpu/adapters/shardstore.py`` through
``tpu/backend.py``): the lab 4 search-test shapes, built from both
packages by ``tests/torch_lab4_cases.py``, against the JAX package.
Every comparison is exact:

- each binding's batched lane predicates and delivery masks against
  ``jax.vmap`` of the reference's, on random rows, lanes out of range and
  SENTINEL rows;
- ``match_shardstore`` routes every shape to the same binding with the
  same key, address map and modelling flags, and refuses the shapes the
  reference refuses with the same ``NoTensorTwin`` text;
- part 2 test10's two-phase flow through the JAX ``tensor_bfs``, the
  port's ``tensor_bfs(device="cpu")`` and the object checker: the join
  phase's goal depth and ``ss-join`` provenance, the main phase's goal on
  the port, and equal SPACE_EXHAUSTED counts three levels below the
  joined root;
- part 3 test09's cross-group transaction, depth-limited, on the port's
  tensor backend and both packages' object checkers, and its goal on the
  port (the decoded 2PC trace replays on the object layer).

The port's searches run with 64-row chunks (the chunk changes no count,
depth or trace)."""

import functools

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dslabs_tpu.tpu import backend as jback  # noqa: E402
from dslabs_tpu.utils.flags import GlobalSettings as JFlags  # noqa: E402
from dslabs_tpu_torch.tpu import backend as tback  # noqa: E402
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.utils.flags import GlobalSettings as TFlags  # noqa: E402
from tests import torch_harness_cases as H  # noqa: E402
from tests import torch_lab4_cases as C  # noqa: E402

REF = H.Pkg("dslabs_tpu")
PORT = H.Pkg("dslabs_tpu_torch")

# Levels below the joined root of test10's goal (the twin's CLIENTS_DONE
# depth, tests/test_tpu_lab4.py test_lab4_goal_parity) and of test09's
# (the object checker's goal depth, 12 from the root, after 12783 states;
# ``python -m tests.torch_lab4_cases`` reruns it).
TEST10_GOAL_LEVELS = 10
TEST09_GOAL_LEVELS = 8


@pytest.fixture
def tensor(monkeypatch):
    """Both packages' search backend set to ``tensor``, and 64-row chunks
    for the port."""
    monkeypatch.setattr(JFlags, "search_backend", "tensor")
    monkeypatch.setattr(TFlags, "search_backend", "tensor")
    monkeypatch.setattr(tback, "_run_tensor",
                        functools.partial(tback._run_tensor, chunk=64))


def _port(case):
    return tback.tensor_bfs(case.state, case.settings, device="cpu")


def _jax(case):
    return jback.tensor_bfs(case.state, case.settings)


def _object(pkg):
    def run(case):
        return pkg.mod("search.search").BFS(case.settings).run(case.state)
    return run


# --------------------------------------------------------------- shapes

def _shape(pkg, name):
    """(state, settings) of one binding shape; main phases stage from the
    object checker's join-phase goal."""
    if name.startswith("join_g"):
        case = C.join_case(pkg, int(name[-1]))
        return case.state, case.settings
    if name == "p2_test13":
        # The random-search shape narrows nothing: master timers live,
        # the controller's join debris deliverable.
        joined = C.joined_state(pkg, 2, 2, run=_object(pkg))
        case = C.p2_test12(pkg, joined)[0]
        s = pkg.SearchSettings().add_invariant(pkg.RESULTS_OK)
        return case.state, s
    groups, shards, build = C.SHAPES[name]
    joined = C.joined_state(pkg, groups, shards, run=_object(pkg))
    case = build(pkg, joined)[0]
    return case.state, case.settings


BOUND = ["join_g1", "join_g2", "p2_test10", "p2_test11", "p2_test12",
         "p2_test13", "p3_test08", "p3_test09"]


def _tkeys(pkg, name):
    """Every lane-predicate key the binding translates (and two it
    declines), with the package's own address objects."""
    c1 = pkg.LocalAddress("client1")
    keys = [("RESULTS_OK",), ("RESULTS_LINEARIZABLE",), ("CLIENTS_DONE",),
            ("NONE_DECIDED",), ("MULTI_GETS_MATCH",),
            ("CLIENT_DONE", c1), ("CLIENT_HAS_RESULTS", c1, 1),
            ("CLIENT_DONE", C.cca(pkg)), ("CLIENT_HAS_RESULTS",
                                         C.cca(pkg), 1)]
    if name in ("p2_test12", "p2_test13"):
        keys.append(("CLIENT_HAS_RESULTS", pkg.LocalAddress("client2"), 1))
    return keys


@pytest.mark.parametrize("name", BOUND)
def test_lane_predicates_and_masks_match_jax(name):
    """Each binding's batched lane predicates and delivery mask against
    the reference's per-state ones under jax.vmap: random node rows,
    message records with frm/to lanes out of range and SENTINEL rows."""
    (jstate, js), (tstate, ts) = _shape(REF, name), _shape(PORT, name)
    jb, tb = jback.resolve_binding(jstate), tback.resolve_binding(tstate)
    assert type(tb).__name__ == type(jb).__name__
    jb.check_settings(js)
    tb.check_settings(ts)
    p = tb.build_protocol(*tb.initial_caps())
    assert p.name == jb.build_protocol(*jb.initial_caps()).name
    rng = np.random.default_rng(BOUND.index(name))
    nodes = rng.integers(0, 7, size=(512, p.node_width), dtype=np.int32)
    declined = 0
    for jk, tk in zip(_tkeys(REF, name), _tkeys(PORT, name)):
        jf, tf = jb.predicate(jk), tb.predicate(tk)
        assert (jf is None) == (tf is None), tk
        if tf is None:
            declined += 1
            continue
        want = np.asarray(jax.vmap(jf)({"nodes": jnp.asarray(nodes)}))
        got = tf({"nodes": torch.from_numpy(nodes)})
        assert got.shape == (512,) and got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(tk))
        assert (getattr(tf, "value_level", False)
                == getattr(jf, "value_level", False))
    assert 0 < declined < len(_tkeys(PORT, name))
    nn = len(tb.addr_index)
    msgs = rng.integers(-2, nn + 2, size=(512, p.msg_width), dtype=np.int32)
    msgs[::7] = teng.SENTINEL
    marr = rng.random(nn * nn) > 0.5
    want = np.asarray(jax.vmap(jb.msg_mask_fn(), in_axes=(0, None))(
        jnp.asarray(msgs), jnp.asarray(marr)))
    got = tb.msg_mask_fn()(torch.from_numpy(msgs), torch.from_numpy(marr))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.any() and not got.all()


@pytest.mark.parametrize("name", BOUND)
def test_routing_matches_jax(name):
    """match_shardstore binds every shape to the reference's binding: the
    same key, address map, workload shape and modelling flags."""
    (jstate, js), (tstate, ts) = _shape(REF, name), _shape(PORT, name)
    jb, tb = jback.resolve_binding(jstate), tback.resolve_binding(tstate)
    assert type(tb).__module__ == "dslabs_tpu_torch.tpu.adapters.shardstore"
    assert type(tb).__name__ == type(jb).__name__
    assert tb.key == jb.key and tb.addr_index == jb.addr_index
    jb.check_settings(js)
    tb.check_settings(ts)
    for attr in ("groups_of", "Ws", "w", "W", "_model_mh", "_model_ctl",
                 "_cli0", "_ck"):
        assert getattr(tb, attr, None) == getattr(jb, attr, None), attr


def _refused(pkg, name):
    """The call that refuses one lab 4 shape the twins do not model."""
    tx = pkg.mod("labs.shardedstore.txkvstore")
    backend = jback if pkg.root == "dslabs_tpu" else tback
    if name == "two_servers_per_group":
        joined = C.joined_state(pkg, 2, servers_per_group=2,
                                run=_object(pkg))
        C._kv(pkg, joined, 1, ["PUT:key-1:v"], ["PutOk"])
    elif name == "three_groups":
        joined = C.joined_state(pkg, 3, run=_object(pkg))
        C._kv(pkg, joined, 1, ["PUT:key-1:v"], ["PutOk"])
    elif name == "two_tx_clients":
        # Part 3 test10: two clients, cross-group transactions.
        joined = C.joined_state(pkg, 2, 2, run=_object(pkg))
        C._tx(pkg, joined, 1, [tx.MultiPut({"foo-1": "X", "foo-2": "Y"}),
                               tx.Swap("foo-1", "foo-2")],
              [tx.MultiPutOk(), tx.SwapOk()])
        C._tx(pkg, joined, 2, [tx.MultiGet({"foo-1", "foo-2"})],
              [tx.MultiGetResult({"foo-1": "Y", "foo-2": "X"})])
    else:
        # test09 with the master's timers live: the tx twin freezes them.
        joined = C.joined_state(pkg, 2, 2, run=_object(pkg))
        (case,) = C.p3_test09(pkg, joined)
        case.settings.deliver_timers(C.shard_master(pkg), True)
        return lambda: backend.resolve_binding(case.state).check_settings(
            case.settings)
    return lambda: backend.resolve_binding(joined)


@pytest.mark.parametrize("name,match", [
    ("two_servers_per_group", "ONE server per group"),
    ("three_groups", "at most 2 groups"),
    ("two_tx_clients", "exactly one tx-workload client \\(found 2\\)"),
    ("tx_master_timers", "freezes the master's timers"),
])
def test_refusals_match_jax(name, match):
    with pytest.raises(jback.NoTensorTwin, match=match) as ej:
        _refused(REF, name)()
    with pytest.raises(tback.NoTensorTwin, match=match) as et:
        _refused(PORT, name)()
    assert str(et.value) == str(ej.value)


# The lab 4 dfs call sites that no twin binds, in either package.
DFS_REFUSED = {
    "p2_test14": "ONE server per group",
    "p3_test11": "exactly one tx-workload client \\(found 2\\)",
    "p3_test12": "ONE server per group",
}


@pytest.mark.parametrize("name", sorted(DFS_REFUSED))
def test_dfs_sites_without_twin_refused_as_jax(tensor, name):
    """Part 2 test14 (three servers per group), part 3 test11 (two
    transactional clients) and part 3 test12 (three servers per group,
    reconfiguration during the search): the port's tensor_dfs refuses
    each with the JAX tensor_dfs's NoTensorTwin text, before any probe
    or search runs."""
    (jcase,) = C.dfs_cases(REF, name, run=_object(REF))
    (tcase,) = C.dfs_cases(PORT, name, run=_object(PORT))
    with pytest.raises(jback.NoTensorTwin, match=DFS_REFUSED[name]) as ej:
        jback.tensor_dfs(jcase.state, jcase.settings)
    with pytest.raises(tback.NoTensorTwin, match=DFS_REFUSED[name]) as et:
        tback.tensor_dfs(tcase.state, tcase.settings, device="cpu")
    assert str(et.value) == str(ej.value)


# -------------------------------------------------------------- searches

def test_test10_two_phase_flow_matches_jax_and_object(tensor):
    """Part 2 test10 on the tensor backend: the join phase's goal state
    carries ``ss-join`` provenance at the object checker's depth in both
    packages; the main phase validates it as the canonical joined root,
    reaches CLIENTS_DONE ten levels down, and the CLIENTS_DONE-pruned
    search three levels down exhausts with the JAX tensor_bfs's and the
    object checker's count (74, tests/test_tpu_lab4.py)."""
    port_j = C.joined_state(PORT, 1, run=_port)
    ref_j = C.joined_state(REF, 1, run=_jax)
    obj_j = C.joined_state(REF, 1, run=_object(REF))
    assert port_j.depth == ref_j.depth == obj_j.depth == 2
    assert port_j._tensor_provenance.key[0] == "ss-join"
    assert port_j._tensor_provenance.key == ref_j._tensor_provenance.key
    assert PORT.mod("testing.predicates").client_done(
        C.cca(PORT)).check(port_j).value
    goal, pruned = C.p2_test10(PORT, port_j, levels=3)
    res = _port(goal)
    assert H.end_name(res) == "GOAL_FOUND"
    assert H.terminal_depth(res) == port_j.depth + TEST10_GOAL_LEVELS
    assert PORT.CLIENTS_DONE.check(H.terminal(res)).value
    port = _port(pruned)
    ref = _jax(C.p2_test10(REF, ref_j, levels=3)[1])
    obj = _object(REF)(C.p2_test10(REF, obj_j, levels=3)[1])
    ends = [H.end_name(r) for r in (port, ref, obj)]
    assert ends == ["SPACE_EXHAUSTED"] * 3
    assert (port.discovered_count == ref.discovered_count
            == obj.discovered_count == 74)


def test_test09_cross_group_tx_depth_limited_and_goal(tensor):
    """Part 3 test09's MultiPut across both groups binds the 2PC twin:
    three levels below the joined root the port's tensor backend counts
    what both packages' object checkers count, and its goal search
    reaches CLIENTS_DONE with a 2PC trace the object layer replays."""
    counts = []
    for pkg, run in ((PORT, _port), (PORT, _object(PORT)),
                     (REF, _object(REF))):
        joined = C.joined_state(pkg, 2, 2, run=_object(pkg))
        (case,) = C.p3_test09(pkg, joined, levels=3)
        res = run(case)
        assert H.end_name(res) == "SPACE_EXHAUSTED"
        counts.append(res.discovered_count)
    assert counts[0] == counts[1] == counts[2]
    joined = C.joined_state(PORT, 2, 2, run=_port)
    (case,) = C.p3_test09(PORT, joined)
    assert type(tback.resolve_binding(case.state)).__name__ == \
        "ShardStoreTxBinding"
    res = _port(case)
    assert H.end_name(res) == "GOAL_FOUND"
    goal = H.terminal(res)
    assert goal.depth == joined.depth + TEST09_GOAL_LEVELS
    assert PORT.CLIENTS_DONE.check(goal).value and \
        PORT.RESULTS_OK.check(goal).value
