"""PyTorch port, the swarm over D walker groups on one device
(``SwarmSearch(mesh=ShardMesh(D))``, ``dslabs_tpu_torch/tpu/swarm.py``),
against the JAX package on the CPU.

The port's walks draw from torch's generator, so a fleet is held by its
verdicts (a BFS is the oracle) and its witnesses, not by equality with
the JAX walks.  Per group: kernel 1 runs once per walk step over the
D * K walkers, kernel 2 once per group on that group's table, and the
round's per-device lanes have one entry per group.  The cross-width
dump case is ``tests/test_chaos.py:282``'s on ``ShardMesh`` groups."""

import dataclasses
import os

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)

from dslabs_tpu.tpu import engine as jeng  # noqa: E402
from dslabs_tpu.tpu.protocols.pingpong import \
    make_pingpong_protocol as j_pp  # noqa: E402
from dslabs_tpu_torch.tpu import checkpoint as tck  # noqa: E402
from dslabs_tpu_torch.tpu import kernels  # noqa: E402
from dslabs_tpu_torch.tpu import supervisor as tsup  # noqa: E402
from dslabs_tpu_torch.tpu import swarm as tsw  # noqa: E402
from dslabs_tpu_torch.tpu import visited as visited_mod  # noqa: E402
from dslabs_tpu_torch.tpu.mesh_exchange import ShardMesh  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.pingpong import \
    make_pingpong_protocol as t_pp  # noqa: E402
from dslabs_tpu_torch.tpu.telemetry import Telemetry  # noqa: E402
from tests.torch_harness_cases import violating  # noqa: E402

pytestmark = pytest.mark.swarm


def _goal_pruned(p):
    return dataclasses.replace(
        p, goals={}, prunes={"CLIENTS_DONE": p.goals["CLIENTS_DONE"]})


def _swarm(proto, groups, **kw):
    kw.setdefault("walkers_per_device", 8)
    kw.setdefault("max_steps", 24)
    kw.setdefault("steps_per_round", 4)
    kw.setdefault("seed", 3)
    return tsw.SwarmSearch(proto, mesh=ShardMesh(groups, "cpu"), **kw)


@pytest.fixture(scope="module")
def bfs_verdict():
    """The JAX BFS verdict of the violating pingpong twin: the oracle."""
    o = jeng.TensorSearch(violating(j_pp(3)), chunk=64).run()
    assert o.end_condition == "INVARIANT_VIOLATED"
    return o.end_condition, o.predicate_name, o.depth


def test_two_groups_find_the_bfs_verdict(bfs_verdict, monkeypatch):
    """Two groups of 8 walkers land the BFS verdict with a verified
    witness no longer than a root-first path can be shorter than the BFS
    depth; each walk step fingerprints once over the 16 walkers and
    inserts once per group into that group's table; the round records
    carry one lane per group."""
    calls = {"fp": [], "insert": []}
    fp0, ins0 = kernels.fingerprint_rows, visited_mod.insert

    def fp(rows):
        calls["fp"].append(rows.shape[0])
        return fp0(rows)

    def ins(table, keys, valid):
        calls["insert"].append((table.data_ptr(), keys.shape[0]))
        return ins0(table, keys, valid)

    monkeypatch.setattr(kernels, "fingerprint_rows", fp)
    monkeypatch.setattr(visited_mod, "insert", ins)
    tel = Telemetry()
    sw = _swarm(violating(t_pp(3)), 2, telemetry=tel)
    steps = []
    walk0 = sw._walk

    def walk(c):
        n_fp, n_ins = len(calls["fp"]), len(calls["insert"])
        walk0(c)
        steps.append((calls["fp"][n_fp:], calls["insert"][n_ins:]))

    sw._walk = walk
    out = sw.run()
    end, pname, depth = bfs_verdict
    assert (out.end_condition, out.predicate_name) == (end, pname)
    assert out.witness.replay_verified and len(out.trace) >= depth
    assert out.swarm["walkers"] == 16
    table = sw.visited_cap + 1
    for fps, inserts in steps:
        assert fps == [16]
        assert [k for _p, k in inserts] == [8, 8]
        # Group 1's table lies one table past group 0's.
        assert inserts[1][0] - inserts[0][0] == table * 4 * 4
    assert len(steps) == sw.walk_steps > 0
    assert tel.levels and all(
        len(r["per_device"]["explored"]) == 2 for r in tel.levels)
    assert all(sum(r["per_device"]["unique"]) == r["unique"]
               for r in tel.levels)


def test_one_group_equals_the_default_fleet():
    """``mesh=ShardMesh(1)`` (or a count of 1) is the default one-group
    fleet: the same walks and counters from the same seed."""
    proto = violating(t_pp(3))
    a = tsw.SwarmSearch(proto, walkers_per_device=8, max_steps=24,
                        steps_per_round=4, seed=3, device="cpu").run()
    b = _swarm(proto, 1).run()
    c = tsw.SwarmSearch(proto, mesh=1, walkers_per_device=8, max_steps=24,
                        steps_per_round=4, seed=3, device="cpu").run()
    assert a.swarm == {**b.swarm, "walkers_per_sec": a.swarm[
        "walkers_per_sec"], "unique_per_min": a.swarm["unique_per_min"]}
    assert a.witness.raw_trace == b.witness.raw_trace == c.witness.raw_trace


def test_swarm_checkpoint_survives_group_count_change(tmp_path):
    """tests/test_chaos.py:282: a fleet dumped at 8 groups resumes at 4
    (walker rows, histories and table key groups redistributed, with a
    warning) and continues; a fleet of another seed refuses the dump."""
    proto = _goal_pruned(t_pp(2))
    ck = str(tmp_path / "swarm.npz")
    kw = dict(walkers_per_device=8, max_steps=12, steps_per_round=4,
              seed=7, visited_cap=1 << 10, checkpoint_path=ck,
              checkpoint_every=1)
    out1 = _swarm(proto, 8, max_rounds=2, **kw).run(check_initial=False)
    assert os.path.exists(ck)
    with pytest.warns(RuntimeWarning, match="redistributes 64 walkers"):
        out2 = _swarm(proto, 4, max_rounds=4, **kw).run(
            check_initial=False, resume=True)
    assert out2.resumed_from_depth >= 1
    assert out2.states_explored >= out1.states_explored
    assert out2.swarm["walkers"] == 32
    other = _swarm(proto, 4, max_rounds=1, **{**kw, "seed": 8})
    with pytest.raises(tck.CheckpointMismatch):
        other.run(check_initial=False, resume=True)


def test_violation_dump_cut_at_eight_groups_resumes_at_four(tmp_path,
                                                            bfs_verdict):
    """A violating fleet cut after round 1 at 8 groups resumes at 4 and
    lands the uncut fleet's verdict with a verified witness; at 8 groups
    it resumes as the identical continuation."""
    proto = violating(t_pp(3))
    kw = dict(walkers_per_device=4, max_steps=24, steps_per_round=2,
              seed=3)
    full = _swarm(proto, 8, **kw).run()
    assert (full.end_condition, full.predicate_name) == bfs_verdict[:2]
    ck = str(tmp_path / "cut.npz")
    cut = _swarm(proto, 8, max_rounds=1, checkpoint_path=ck,
                 checkpoint_every=1, **kw).run()
    assert cut.end_condition == "TIME_EXHAUSTED"
    with pytest.warns(RuntimeWarning, match="from a 8-group dump onto 4x4"):
        half = _swarm(proto, 4, checkpoint_path=ck, **kw).run(resume=True)
    assert (half.end_condition, half.predicate_name) == bfs_verdict[:2]
    assert half.witness.replay_verified and half.resumed_from_depth == 1
    same = _swarm(proto, 8, checkpoint_path=ck, **kw).run(resume=True)
    assert same.witness.raw_trace == full.witness.raw_trace
    for k in ("explored", "unique", "revisits", "restarts", "deepest",
              "rounds"):
        assert same.swarm[k] == full.swarm[k], k


def test_portfolio_on_the_sharded_rung_over_two_groups():
    """Portfolio mode with ``ladder=("sharded",)`` over ``ShardMesh(2)``:
    the BFS lane runs the sharded rung at width 2 and its exhaustive
    verdict wins; the swarm lane runs two groups and stops cancelled."""
    proto = _goal_pruned(t_pp(2))
    bfs = tsup.SearchSupervisor(proto, ladder=("sharded",),
                                mesh=ShardMesh(2, "cpu"), chunk=16,
                                frontier_cap=1 << 8,
                                visited_cap=1 << 10).run()
    sup = tsup.SearchSupervisor(
        proto, ladder=("sharded",), mesh=ShardMesh(2, "cpu"), chunk=16,
        frontier_cap=1 << 8, visited_cap=1 << 10, max_secs=60.0,
        portfolio=True,
        swarm_kwargs=dict(walkers_per_device=8, max_steps=12,
                          steps_per_round=4, seed=1))
    out = sup.run()
    assert (out.end_condition, out.unique_states, out.states_explored) == (
        bfs.end_condition, bfs.unique_states, bfs.states_explored)
    assert (out.engine, out.mesh_width) == ("sharded", 2)
    assert sup.lanes["winner"] == "bfs"
    swarm = sup.lanes["swarm"]
    assert swarm.engine == "swarm" and swarm.swarm["walkers"] == 16
    assert swarm.cancelled
