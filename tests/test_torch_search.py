"""PyTorch port, whole searches: ``TensorSearch(..., device="cpu").run()``
against the JAX ``TensorSearch.run()`` (same end condition, unique and
explored counts, depth), plus the port's own contracts: entry points run
on the card unless asked otherwise (no quiet CPU fallback), unported
options raise, and the package imports no JAX.

Where a JAX count is already pinned (the Paxos twin's 6/25/102 in
tests/test_spec_parity.py, the flagship configuration's 38/98 at depth 2,
measured with the JAX hand twin), the port is compared with the number
instead of paying another JAX compile."""

import ast
import dataclasses
import os
import pathlib
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores, and
# torch's default of one thread per core oversubscribes them, which slows
# the other workers' time-limited searches past their limits.
torch.set_num_threads(1)

from dslabs_tpu.tpu import engine as jeng  # noqa: E402
from dslabs_tpu.tpu.protocols.clientserver import \
    make_clientserver_protocol as j_cs  # noqa: E402
from dslabs_tpu.tpu.protocols.pingpong import (  # noqa: E402
    make_exhaustive_pingpong as j_pp_ex, make_pingpong_protocol as j_pp)
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.tpu import interop, kernels, visited  # noqa: E402
from dslabs_tpu_torch.tpu import specs_lab3 as t_lab3  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.clientserver import \
    make_clientserver_protocol as t_cs  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.paxos import \
    make_paxos_protocol as t_px  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.pingpong import (  # noqa: E402
    make_exhaustive_pingpong as t_pp_ex, make_pingpong_protocol as t_pp)

_FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
if _FIXTURES not in sys.path:
    sys.path.insert(0, _FIXTURES)

from hand_twins.paxos import make_paxos_protocol as j_px  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
PAXOS_KW = dict(n=3, n_clients=1, max_slots=2, net_cap=48, timer_cap=6)
FLAGSHIP_KW = dict(n=3, n_clients=2, w=1, max_slots=3, net_cap=64,
                   timer_cap=6)
SMALL = dict(chunk=64, visited_cap=1 << 12)


def _no_goals(p):
    return dataclasses.replace(p, goals={})


def _goal_as_prune(p):
    return dataclasses.replace(
        p, goals={}, prunes={"CLIENTS_DONE": p.goals["CLIENTS_DONE"]})


def _key(out):
    return (out.end_condition, out.unique_states, out.states_explored,
            out.depth)


def _port(p, **kw):
    return teng.TensorSearch(p, device="cpu", **{**SMALL, **kw})


# ------------------------------------------------------ parity with JAX

@pytest.mark.parametrize("make_j,make_t", [
    (lambda: j_pp(2), lambda: t_pp(2)),                 # goal search
    (lambda: j_pp_ex(2), lambda: t_pp_ex(2)),           # exhaustive
    (lambda: _goal_as_prune(j_cs(2, 1)),
     lambda: _goal_as_prune(t_cs(2, 1))),               # lab1 (2,1) prune
])
def test_search_matches_jax(make_j, make_t):
    ref = jeng.TensorSearch(make_j(), **SMALL).run()
    out = _port(make_t()).run()
    assert _key(out) == _key(ref)
    assert out.predicate_name == ref.predicate_name
    if ref.goal_state is not None:
        for k, v in ref.goal_state.items():
            np.testing.assert_array_equal(np.asarray(v), out.goal_state[k])


@pytest.fixture(scope="module")
def jax_paxos_counts():
    """The JAX hand twin at depths 1-3 from ONE engine (one compile)."""
    js = jeng.TensorSearch(_no_goals(j_px(**PAXOS_KW)), **SMALL)
    counts = {}
    for d in (1, 2, 3):
        js.max_depth = d
        counts[d] = _key(js.run())
    return counts


@pytest.mark.parametrize("depth,unique", [(1, 6), (2, 25), (3, 102)])
def test_paxos_depths_match_jax(jax_paxos_counts, depth, unique):
    out = _port(_no_goals(t_px(**PAXOS_KW)), max_depth=depth).run()
    assert _key(out) == jax_paxos_counts[depth]
    assert out.unique_states == unique      # tests/test_spec_parity.py


def test_paxos_singleton_matches_jax():
    """n=1: the twin's singleton branches (self-election at init, the
    self-vote majority inside send_p2a)."""
    kw = dict(n=1, n_clients=1, max_slots=2, net_cap=16, timer_cap=4)
    ref = jeng.TensorSearch(_no_goals(j_px(**kw)), max_depth=6,
                            **SMALL).run()
    out = _port(_no_goals(t_px(**kw)), max_depth=6).run()
    assert _key(out) == _key(ref)
    assert out.unique_states > 6


def test_flagship_depth2_matches_pinned_counts():
    """The flagship configuration (bench.py: n=3, 2 clients, 3 slots,
    net 64, timers 6, goals stripped): 842 lanes; 38 unique / 98 explored
    at depth 2 (the JAX hand twin's counts)."""
    ts = _port(_no_goals(t_px(**FLAGSHIP_KW)), max_depth=2)
    assert ts.lanes == 842
    assert _key(ts.run()) == ("DEPTH_EXHAUSTED", 38, 98, 2)


def test_search_from_jax_goal_state():
    """Interop: a JAX goal_state carried across with state_from_numpy
    starts a search in the port that ends exactly as the JAX search
    started from the same state."""
    goal = jeng.TensorSearch(j_cs(2, 1), **SMALL).run()
    assert goal.end_condition == "GOAL_FOUND"
    state = {k: np.asarray(v) for k, v in goal.goal_state.items()}
    ref = jeng.TensorSearch(_no_goals(j_cs(2, 1)), **SMALL).run(
        initial=state)
    out = _port(_no_goals(t_cs(2, 1))).run(
        initial=interop.state_from_numpy(state, "cpu"))
    assert _key(out) == _key(ref)
    assert out.end_condition == "SPACE_EXHAUSTED"


def test_frontier_cap_and_table_overflow_match_jax():
    """CAPACITY_EXHAUSTED at a small frontier cap gives the same counts;
    a strict search on a table that is too small raises in both."""
    p_j, p_t = _goal_as_prune(j_cs(2, 2)), _goal_as_prune(t_cs(2, 2))
    kw = dict(chunk=4, frontier_cap=8, visited_cap=1 << 12)
    ref = jeng.TensorSearch(p_j, **kw).run()
    out = teng.TensorSearch(p_t, device="cpu", **kw).run()
    assert ref.end_condition == "CAPACITY_EXHAUSTED"
    assert _key(out) == _key(ref)
    with pytest.raises(jeng.CapacityOverflow):
        jeng.TensorSearch(p_j, chunk=64, visited_cap=16).run()
    with pytest.raises(teng.CapacityOverflow):
        teng.TensorSearch(p_t, chunk=64, visited_cap=16,
                          device="cpu").run()


def test_cpu_search_launches_no_kernel():
    before = (dict(kernels.LAUNCHES), dict(visited.LAUNCHES))
    _port(t_pp_ex(2)).run()
    assert (kernels.LAUNCHES, visited.LAUNCHES) == before


# ------------------------------------------------------------- contracts

def test_no_cpu_fallback_without_cuda():
    """With no card, the default device and an explicit "cuda" both
    raise; neither carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.TensorSearch(t_pp(2))
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.TensorSearch(t_pp(2), device="cuda")


_KEYS_NP = np.zeros((3, 4), dtype=np.uint32)
_STATE_NP = {"nodes": np.zeros((1, 2), np.int32),
             "net": np.zeros((1, 1, 1), np.int32),
             "timers": np.zeros((1, 1, 1, 1), np.int32),
             "exc": np.zeros((1,), np.int32)}


@pytest.mark.parametrize("make", [
    lambda: visited.empty_table(16),
    lambda: visited.build_table(16, torch.zeros((3, 4), dtype=torch.int32)),
    lambda: interop.table_from_numpy(np.zeros((17, 4), np.uint32)),
    lambda: interop.keys_from_numpy(_KEYS_NP),
    lambda: interop.state_from_numpy(_STATE_NP),
], ids=["empty_table", "build_table", "table_from_numpy", "keys_from_numpy",
        "state_from_numpy"])
def test_helpers_default_to_the_card(make):
    """The table and interop helpers also place their tensors on the card
    unless told otherwise: with no card and no device they raise instead
    of building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


def _compiled_flagship():
    return t_lab3.make_paxos_protocol(**FLAGSHIP_KW)


@pytest.mark.parametrize("kw,proto", [
    (dict(checkpoint_path="ck.npz"), None),
    (dict(checkpoint_every=2), None),
    (dict(spill=True), None),
    (dict(telemetry=True), None),
])
def test_unported_options_raise(kw, proto, tmp_path):
    """The options later slices ported build and run to the plain
    search's verdict and counts, ``run(resume=True)`` with no dump from
    the root: ``checkpoint_path``, ``checkpoint_every`` and ``spill``
    (the spill + checkpoint slice) and ``telemetry`` (the telemetry and
    tracing slice, with one level record per level)."""
    p = t_pp(2) if proto is None else proto()
    if "telemetry" in kw:
        from dslabs_tpu_torch.tpu.telemetry import Telemetry

        kw = {"telemetry": Telemetry()}
    if "checkpoint_path" in kw:
        kw = {**kw, "checkpoint_path": str(tmp_path / kw["checkpoint_path"])}
    out = _port(p, **kw).run(resume=True)
    assert _key(out) == _key(_port(p).run())
    assert out.resumed_from_depth == 0
    if "telemetry" in kw:
        assert len(kw["telemetry"].levels) == out.depth


@pytest.mark.parametrize("proto", [_compiled_flagship, lambda: t_pp(2)],
                         ids=["compiled_flagship", "pingpong_hand_twin"])
def test_symmetry_without_groups_is_a_value_error(proto):
    """``symmetry=True`` runs the reduction; on a protocol that declares
    no symmetry groups it is the reference's ``ValueError``."""
    with pytest.raises(ValueError, match="declares no symmetry groups"):
        teng.TensorSearch(proto(), device="cpu", symmetry=True)


def test_fault_protocol_searches_on_the_port():
    """A protocol with a fault model gets the fault segment after the
    message and timer segments, and runs: the partitioned flagship's
    depth-1 successors include the CUT."""
    p = dataclasses.replace(
        t_lab3.make_paxos_partition_spec(**FLAGSHIP_KW).compile(), goals={})
    ts = teng.TensorSearch(p, device="cpu", chunk=8, max_depth=1)
    tgrid = p.n_nodes * p.timer_cap
    assert ts._ev_slots == p.net_cap + tgrid + p.fault.n_events == \
        p.net_cap + tgrid + 2
    out = ts.run()
    assert out.end_condition == "DEPTH_EXHAUSTED"
    assert out.partition_events == out.fault_events == 1
    assert out.crash_events == out.drop_events == out.dup_events == 0


def test_symmetric_search_runs_on_the_port():
    """``symmetry=True`` on a protocol with groups stamps the permutation
    count and never counts more states than the raw search."""
    from dslabs_tpu_torch.tpu.specs import paxos_spec

    p = dataclasses.replace(paxos_spec(3).compile(), goals={})
    raw, sym = (teng.TensorSearch(p, device="cpu", chunk=64, max_depth=3,
                                  symmetry=s).run() for s in (False, True))
    assert (raw.symmetry_perms, sym.symmetry_perms) == (0, 6)
    assert sym.unique_states < raw.unique_states


def test_unported_run_options_raise(tmp_path):
    """``run(resume=True)`` is ported: without a dump at
    ``checkpoint_path`` both loops start from the root."""
    for host in (False, True):
        ts = _port(t_pp(2), use_host_visited=host,
                   checkpoint_path=str(tmp_path / "none.npz"))
        assert not ts.has_resumable_checkpoint()
        out = ts.run(resume=True)
        assert out.resumed_from_depth == 0
        assert _key(out) == _key(_port(t_pp(2),
                                       use_host_visited=host).run())


def _import_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    """Every module of dslabs_tpu_torch, and chip_smoke.py, imports
    neither jax nor anything of the JAX package."""
    files = sorted((REPO / "dslabs_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10 and files[-1].exists()
    for name in ("tpu/trace.py", "tpu/protocols/primarybackup.py",
                 "tpu/compiler.py", "tpu/specs_lab3.py", "tpu/packing.py",
                 "tpu/backend.py", "tpu/adapters/paxos.py",
                 "tpu/specs_lab4.py", "tpu/adapters/shardstore.py",
                 "tpu/swarm.py", "tpu/checkpoint.py", "tpu/spill.py",
                 "tpu/supervisor.py", "tpu/warden.py",
                 "tpu/telemetry.py", "tpu/tracing.py",
                 "search/search.py", "search/trace.py",
                 "harness/__init__.py", "harness/annotations.py",
                 "harness/junit.py", "harness/runner.py", "harness/tee.py",
                 "runner/network.py", "runner/run_settings.py",
                 "runner/run_state.py", "viz/__init__.py", "viz/config.py",
                 "viz/server.py", "viz/debugger.py", "run_tests.py",
                 "_labtests/__init__.py", "analysis/__init__.py",
                 "analysis/__main__.py", "analysis/core.py",
                 "analysis/conformance.py", "analysis/hotpath_audit.py",
                 "tpu/lanes.py", "service/__init__.py",
                 "service/__main__.py", "service/queue.py",
                 "service/scheduler.py", "service/server.py"):
        assert REPO / "dslabs_tpu_torch" / name in files, name
    for f in files:
        for mod in _import_roots(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "dslabs_tpu"), (f, mod)
