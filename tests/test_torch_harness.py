"""PyTorch port, the harness binding (``dslabs_tpu_torch/tpu/backend.py``
with the lab 0-3 adapters): the same lab search-test shapes, built from
both packages by ``tests/torch_harness_cases.py``, go through the JAX
``tensor_bfs``, the port's ``tensor_bfs(device="cpu")`` and the
reference's object checker.  Every comparison is exact: the same end
condition (on time-limited runs, one the lab test accepts), the same goal
or violation depth, equal ``discovered_count`` on runs that end by depth
or by space, and the object predicate re-checked on the port's replayed
object state.

The lab 3 cases compare the port with the reference's object checker
(and with its numbers, pinned where the object run costs more than the
port's): the JAX ``tensor_bfs`` of lab 3 compiles for minutes on the CPU.
The port's searches here run with 64-row chunks: on the CPU a search
costs time per padded pair slot, and the chunk changes no count, depth or
trace."""

import dataclasses
import functools

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)

from dslabs_tpu.search import search as jsearch  # noqa: E402
from dslabs_tpu.tpu import backend as jback  # noqa: E402
from dslabs_tpu.utils.flags import GlobalSettings as JFlags  # noqa: E402
from dslabs_tpu_torch.search import search as tsearch  # noqa: E402
from dslabs_tpu_torch.tpu import backend as tback  # noqa: E402
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.pingpong import \
    make_exhaustive_pingpong  # noqa: E402
from dslabs_tpu_torch.tpu.trace import (  # noqa: E402
    decode_trace, reconstruct_object_trace)
from dslabs_tpu_torch.utils.flags import GlobalSettings as TFlags  # noqa: E402
from tests import torch_harness_cases as H  # noqa: E402

REF = H.Pkg("dslabs_tpu")
PORT = H.Pkg("dslabs_tpu_torch")

# Goal depths of test20's first two phases, from the reference's object
# checker on tests/torch_harness_cases.py's builders (phase 2 costs the
# object checker ~18 s on the CPU).
TEST20_GOAL_DEPTHS = (7, 11)


@pytest.fixture
def tensor(monkeypatch):
    """Both packages' search backend set to ``tensor`` (derandomized
    workload streams on both sides), and 64-row chunks for the port."""
    monkeypatch.setattr(JFlags, "search_backend", "tensor")
    monkeypatch.setattr(TFlags, "search_backend", "tensor")
    monkeypatch.setattr(tback, "_run_tensor",
                        functools.partial(tback._run_tensor, chunk=64))


def _port(case):
    return tback.tensor_bfs(case.state, case.settings, device="cpu")


def _object(case):
    return jsearch.BFS(case.settings).run(case.state)


def _check_terminal(case, results):
    """The original object predicate holds (goal) or fails (invariant) on
    the terminal state the port replayed."""
    end = H.end_name(results)
    st = H.terminal(results)
    if end == "GOAL_FOUND":
        assert any(p.check(st).value for p in case.settings.goals)
    elif end == "INVARIANT_VIOLATED":
        assert any(not p.check(st).value for p in case.settings.invariants)
    else:
        assert st is None


@pytest.mark.parametrize("name", sorted(H.LAB02))
def test_lab02_shape_matches_jax_and_object(tensor, monkeypatch, name):
    build = H.LAB02[name]
    case = build(PORT)
    if name == "lab1_infinite":
        # Time-limited: with the reference's 512-row chunks the CPU stays
        # well short of the depth where the twin outgrows the ladder's
        # top rung (test_infinite_workload_outgrows_top_rung_as_reference).
        monkeypatch.setattr(tback, "_run_tensor", tback._run_tensor.func)
    port = _port(case)
    jcase = build(REF)
    ref = jback.tensor_bfs(jcase.state, jcase.settings)
    obj = _object(build(REF))
    ends = [H.end_name(r) for r in (port, ref, obj)]
    assert all(e in case.expect for e in ends), ends
    if len(case.expect) == 1:
        assert ends[0] == ends[1] == ends[2]
    assert (H.terminal_depth(port) == H.terminal_depth(ref)
            == H.terminal_depth(obj))
    if case.exact:
        assert (port.discovered_count == ref.discovered_count
                == obj.discovered_count)
    _check_terminal(case, port)
    if name == "lab1_infinite_goal":
        # The command the port decoded is the one the reference's client
        # drew from the same counter-mode stream.
        addr = PORT.LocalAddress("client1")
        sent = H.terminal(port).client_workers()[addr].sent_commands[0]
        want = H.terminal(ref).client_workers()[
            REF.LocalAddress("client1")].sent_commands[0]
        assert isinstance(sent, PORT.Put)
        assert sent.key.startswith("client1-")
        assert repr(sent) == repr(want)


def _tkeys(pkg, lab, b):
    """Every lane-predicate key the lab's adapter translates, with the
    package's own address and command objects."""
    c1 = H.client(pkg, 1)
    keys = [("RESULTS_OK",), ("CLIENTS_DONE",), ("NONE_DECIDED",),
            ("CLIENT_DONE", c1), ("CLIENT_HAS_RESULTS", c1, 1)]
    if lab == "pb":
        keys += [("PB_PROMOTED", "server2"),
                 ("PB_VIEW_SYNCED", 2, "server1", "server2"),
                 ("PB_VIEW_SYNCED", 2, "server2", "server1", "acked")]
    if lab == "paxos":
        s1, s2 = H.server(pkg, 1), H.server(pkg, 2)
        keys += [("PAXOS_LOGS_CONSISTENT", True),
                 ("PAXOS_LOGS_CONSISTENT", False),
                 ("PAXOS_SLOT_VALID", 1), ("PAXOS_SLOT_VALID", 9),
                 ("PAXOS_HAS_COMMAND", s2, 1, b.cmd_objs[1]),
                 ("PAXOS_HAS_COMMAND", s1, 9, b.cmd_objs[1])]
        keys += [("PAXOS_HAS_STATUS", s1, slot, st) for slot in (1, 2, 9)
                 for st in ("EMPTY", "ACCEPTED", "CHOSEN", "CLEARED")]
    return keys


_LAB_STATES = {
    "pingpong": lambda pkg: H.lab0_state(pkg),
    "clientserver": lambda pkg: H.lab1_state(
        pkg, [pkg.kv_workload([f"APPEND:foo:{i}"]) for i in (1, 2)]),
    "pb": lambda pkg: H.lab2_state(pkg, ns=2),
    "paxos": lambda pkg: H.lab3_state(pkg, 3, [
        (["PUT:foo:bar", "GET:foo"], ["PutOk", "bar"]),
        (["APPEND:foo:x", "GET:foo"], None)]),
}


@pytest.mark.parametrize("lab", sorted(_LAB_STATES))
def test_lane_predicates_and_masks_match_jax(lab):
    """Each adapter's batched lane predicates and delivery masks against
    the reference's per-state ones under jax.vmap, on random node rows
    (small values, so statuses, seqs and views all vary; non-negative as
    on every reachable state, where the reference's value-level
    predicates ``seq >= 0`` are the port's constant true), and on message
    records with lanes out of range and SENTINEL rows, which the port's
    gathers must clip where the reference's one-hot select reads 0."""
    import jax.numpy as jnp
    import numpy as np

    jb = jback.resolve_binding(_LAB_STATES[lab](REF))
    tb = tback.resolve_binding(_LAB_STATES[lab](PORT))
    assert jb.key[0] == tb.key[0] and jb.addr_index == tb.addr_index
    p = tb.build_protocol(*tb.initial_caps())
    rng = np.random.default_rng(5)
    nodes = rng.integers(0, 7, size=(512, p.node_width), dtype=np.int32)
    for jk, tk in zip(_tkeys(REF, lab, jb), _tkeys(PORT, lab, tb)):
        want = np.asarray(jax.vmap(jb.predicate(jk))(
            {"nodes": jnp.asarray(nodes)}))
        got = tb.predicate(tk)({"nodes": torch.from_numpy(nodes)})
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(tk))
        assert (getattr(tb.predicate(tk), "value_level", False)
                == getattr(jb.predicate(jk), "value_level", False))
    nn = len(tb.addr_index)
    msgs = rng.integers(-2, nn + 2, size=(512, p.msg_width), dtype=np.int32)
    msgs[::7] = teng.SENTINEL
    marr = rng.random(nn * nn) > 0.5
    want = np.asarray(jax.vmap(jb.msg_mask_fn(), in_axes=(0, None))(
        jnp.asarray(msgs), jnp.asarray(marr)))
    got = tb.msg_mask_fn()(torch.from_numpy(msgs), torch.from_numpy(marr))
    np.testing.assert_array_equal(got.numpy(), want)
    node = np.arange(-2, nn + 2, dtype=np.int32)
    tarr = rng.random(nn) > 0.5
    want = np.asarray(jax.vmap(jback.TwinBinding.tmr_mask_fn(nn),
                               in_axes=(0, None))(jnp.asarray(node),
                                                  jnp.asarray(tarr)))
    got = tback.TwinBinding.tmr_mask_fn(nn)(torch.from_numpy(node),
                                            torch.from_numpy(tarr))
    np.testing.assert_array_equal(got.numpy(), want)


def test_no_twin_raises_in_both(tensor):
    with pytest.raises(tback.NoTensorTwin):
        tback.tensor_bfs(H.no_twin_state(PORT), PORT.SearchSettings(),
                         device="cpu")
    with pytest.raises(jback.NoTensorTwin):
        jback.tensor_bfs(H.no_twin_state(REF), REF.SearchSettings())


def test_infinite_workload_outgrows_top_rung_as_reference(tensor):
    """Depth 16 of the infinite-workload twin overflows the ladder's top
    rung (net_cap 64, timer_cap 8): the port raises CapacityOverflow
    there, as the JAX reference's tensor_bfs does, while depth 15 fits
    with the object checker's count (the JAX runs take 70-80 s on the
    CPU, so their numbers are pinned in H.INFINITE_FITS)."""
    depth, count = H.INFINITE_FITS
    port = _port(H.lab1_infinite_depth(PORT, depth))
    obj = _object(H.lab1_infinite_depth(REF, depth))
    assert H.end_name(port) == H.end_name(obj) == "SPACE_EXHAUSTED"
    assert port.discovered_count == obj.discovered_count == count
    case = H.lab1_infinite_depth(PORT, H.INFINITE_OVERFLOW_DEPTH)
    with pytest.raises(teng.CapacityOverflow,
                       match="net_cap=64, timer_cap=8.*depth 16"):
        _port(case)


def test_lab3_depth4_count_matches_object(tensor):
    """The shape of test_lab3_depth_limited_count_parity: n=3, depth 4,
    partition {s1, s2, c1}, server3's timers off; 85 states on the
    reference's object checker."""
    case = H.lab3_depth4(PORT)
    port = _port(case)
    obj = _object(H.lab3_depth4(REF))
    assert H.end_name(port) == H.end_name(obj) == "SPACE_EXHAUSTED"
    assert port.discovered_count == obj.discovered_count == 85


def test_lab3_staged_phase_replays_provenance(tensor):
    """test20's phase 2 starts from phase 1's replayed goal state: the
    port re-derives the tensor root from the goal's provenance and
    reaches CLIENTS_DONE at the object checker's depth."""
    p1 = _port(H.test20_phase1(PORT))
    assert H.end_name(p1) == "GOAL_FOUND"
    goal = H.terminal(p1)
    assert goal.depth == TEST20_GOAL_DEPTHS[0]
    prov = goal._tensor_provenance
    assert prov.key[0] == "paxos" and len(prov.history) == goal.depth
    case = H.test20_phase2(PORT, goal)
    p2 = _port(case)
    assert H.end_name(p2) == "GOAL_FOUND"
    assert H.terminal_depth(p2) == TEST20_GOAL_DEPTHS[1]
    _check_terminal(case, p2)


def _lab1_staged(pkg, run, depth_limited):
    """Phase 1: client1 has a result; drop the pending messages; then
    either CLIENTS_DONE or a done-pruned exhaust three levels deeper."""
    state = H.lab1_state(pkg, [pkg.kv_workload([f"APPEND:foo:{i}"])
                               for i in (1, 2)])
    s1 = (pkg.SearchSettings().add_invariant(pkg.RESULTS_OK)
          .add_goal(pkg.client_has_results(pkg.LocalAddress("client1"), 1)))
    goal = H.terminal(run(H.Case(state, s1, ("GOAL_FOUND",))))
    goal.drop_pending_messages()
    s2 = pkg.SearchSettings().add_invariant(pkg.RESULTS_OK)
    if depth_limited:
        s2.add_prune(pkg.CLIENTS_DONE).set_max_depth(goal.depth + 3)
    else:
        s2.add_goal(pkg.CLIENTS_DONE)
    return goal, run(H.Case(goal, s2, ()))


@pytest.mark.parametrize("depth_limited", [False, True])
def test_drop_pending_messages_staged_op(tensor, depth_limited):
    """A drop_pending_messages() between phases (as lab 2's and lab 3's
    tests use it) replays as a staged op of the provenance history."""
    g_port, port = _lab1_staged(PORT, _port, depth_limited)
    g_obj, obj = _lab1_staged(REF, _object, depth_limited)
    assert g_port.depth == g_obj.depth
    assert g_port._tensor_provenance.history[-1] == ("drop",)
    assert H.end_name(port) == H.end_name(obj)
    assert H.terminal_depth(port) == H.terminal_depth(obj)
    if depth_limited:
        assert H.end_name(port) == "SPACE_EXHAUSTED"
        assert port.discovered_count == obj.discovered_count


def test_run_host_samples_deepest_level():
    """run_host keeps root-first traces of the first, middle and last
    state of the deepest level that kept rows, each a valid trace."""
    p = make_exhaustive_pingpong(2)
    ts = teng.TensorSearch(p, chunk=16, record_trace=True, device="cpu")
    out = ts.run()
    assert out.end_condition == "SPACE_EXHAUSTED"
    assert 1 <= len(out.samples) <= 3
    for tr in out.samples:
        assert len(tr) == out.depth - 1
        decode_trace(ts, dataclasses.replace(out, trace=tr))


def test_value_level_recheck_turns_exhaust_into_violation(tensor):
    """A value-level invariant the twin cannot falsify (it lowers to a
    constant-true lane predicate) but that fails on every object state:
    the search exhausts, and the samples' object replay reports the
    violation."""
    never = PORT.StatePredicate("never ok", lambda s: False,
                                tkey=("RESULTS_OK",))
    settings = (PORT.SearchSettings().add_invariant(never)
                .add_prune(PORT.CLIENTS_DONE))
    res = tback.tensor_bfs(H.lab0_state(PORT), settings, device="cpu")
    assert H.end_name(res) == "INVARIANT_VIOLATED"
    bad = res.invariant_violating_state
    assert bad.depth > 0 and not never.check(bad).value


def test_object_pipeline_on_port_witness(tensor):
    """A port witness through the object pipeline: minimized and replayed
    (``_object_minimize_verify``), and rebuilt from the tensor outcome by
    ``reconstruct_object_trace``; the violation holds on each."""
    case = H.lab0_violation(PORT)
    res = _port(case)
    pred = PORT.NONE_DECIDED
    bad = res.invariant_violating_state
    mini, r = tback._object_minimize_verify(bad, pred, pred.check(bad))
    assert not r.value and mini.depth <= bad.depth
    case = H.lab0_violation(PORT)
    binding = tback.resolve_binding(case.state)
    protocol, marr, tarr = tback._bind_protocol(
        binding, case.settings, *binding.initial_caps())
    ts = teng.TensorSearch(protocol, chunk=16, record_trace=True,
                           device="cpu")
    ts.set_runtime_masks(marr, tarr)
    out = ts.run()
    end = reconstruct_object_trace(ts, out, case.state, predicate=pred)
    assert out.end_condition == "INVARIANT_VIOLATED"
    assert not pred.check(end).value and end.depth <= out.depth


def test_search_bfs_routes_tensor_backend_to_port(monkeypatch):
    """The port's search.bfs sends the tensor backend to the port's
    tensor_bfs, which runs on the card by default: without CUDA it
    raises and does not fall back to the CPU or the object checker."""
    monkeypatch.setattr(TFlags, "search_backend", "tensor")
    calls = []
    monkeypatch.setattr(tback, "tensor_bfs",
                        lambda st, s: calls.append((st, s)) or "port")
    case = H.lab0_goal(PORT)
    assert tsearch.bfs(case.state, case.settings) == "port"
    assert calls == [(case.state, case.settings)]
    monkeypatch.undo()
    monkeypatch.setattr(TFlags, "search_backend", "tensor")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsearch.bfs(case.state, case.settings)


def test_tensor_dfs_raises_naming_swarm(monkeypatch):
    monkeypatch.setattr(TFlags, "search_backend", "tensor")
    case = H.lab0_goal(PORT)
    for call in (lambda: tback.tensor_dfs(case.state, case.settings),
                 lambda: tsearch.dfs(case.state, case.settings),
                 lambda: tback.tensor_bfs(case.state, case.settings,
                                          _probe_first=True,
                                          device="cpu")):
        with pytest.raises(NotImplementedError, match="swarm"):
            call()
