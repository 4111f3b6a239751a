"""PyTorch port, the owner-sharded engine (``dslabs_tpu_torch/tpu/
sharded.py``, ``tpu/mesh_exchange.py``), on the CPU at small sizes: the
cases of ``tests/test_tpu_sharded.py``, ``tests/test_mesh_exchange.py``,
``tests/test_mesh_packing.py`` and ``tests/test_superstep.py``.

Most cases hold ``ShardedTensorSearch`` at D shards (``make_mesh(D,
device="cpu")``) against the port's solo ``TensorSearch``, which the
port's other suites hold to the JAX package, and against the reference
tests' pinned counts; one case runs the JAX engine on the conftest's
virtual mesh and holds the per-shard frontier occupancies, the frontier
rows and the visited keys equal after the same levels.  Resume,
spill, the cross-package dumps and the swarm's redistribution are in
``tests/test_torch_sharded_resume.py``.  One intra-op thread, no child
process."""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dslabs_tpu_torch.analysis import hotpath_audit as H  # noqa: E402
from dslabs_tpu_torch.tpu import sharded as sh_mod  # noqa: E402
from dslabs_tpu_torch.tpu import telemetry as ttel  # noqa: E402
from dslabs_tpu_torch.tpu.engine import (CapacityOverflow,  # noqa: E402
                                         TensorSearch)
from dslabs_tpu_torch.tpu.mesh_exchange import (LocalExchange,  # noqa: E402
                                                ShardMesh)
from dslabs_tpu_torch.tpu.protocols.clientserver import \
    make_clientserver_protocol  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.pingpong import \
    make_pingpong_protocol  # noqa: E402
from dslabs_tpu_torch.tpu.sharded import (CARRY_PARTITION_RULES,  # noqa: E402
                                          ShardedTensorSearch, make_mesh,
                                          match_partition_rules)
from dslabs_tpu_torch.tpu.specs import (clientserver_spec,  # noqa: E402
                                        paxos_spec, pb_spec, pingpong_spec)
from tests.torch_harness_cases import Pkg, pruned  # noqa: E402

PORT = Pkg("dslabs_tpu_torch")
KW = dict(chunk_per_device=16, frontier_cap=1 << 8, visited_cap=1 << 10)
# tests/test_tpu_sharded.py's pruned pingpong (workload 2): the reference
# engines' verdict and counts.
PINGPONG = ("SPACE_EXHAUSTED", 8, 23, 5)
# Pruned lab 1, two clients of two puts (tests/test_torch_lanes.py).
LAB1 = ("SPACE_EXHAUSTED", 80, 582, 11)


def _key(o):
    return (o.end_condition, o.unique_states, o.states_explored, o.depth)


def _exact(o):
    return _key(o) + (o.dropped,)


def _mesh(d):
    return make_mesh(d, device="cpu")


def _sh(proto, d, **kw):
    return ShardedTensorSearch(proto, _mesh(d), **{**KW, **kw})


def _solo(proto, **kw):
    return TensorSearch(proto, chunk=64, device="cpu", **kw).run()


def _pingpong():
    return pruned(make_pingpong_protocol(workload_size=2))


def _spec_pruned(p):
    name = next(iter(p.goals))
    return dataclasses.replace(p, goals={}, prunes={name: p.goals[name]})


# ------------------------------------------------------------ interface

def test_exchange_interface_and_mesh():
    """``all_to_all`` is a transpose in the reference's receive order, the
    reductions fold the shard dimension; ``make_mesh`` names its device
    and defaults to the card (no card here: an error, never the CPU)."""
    mesh = _mesh(3)
    assert (mesh.width, mesh.device.type, mesh.axis_names) == (
        3, "cpu", ("search",))
    ex = LocalExchange(mesh)
    x = torch.arange(3 * 3 * 2).reshape(3, 3, 2)
    y = ex.all_to_all(x)
    for s in range(3):
        for d in range(3):
            assert torch.equal(y[d, s], x[s, d])
    v = torch.tensor([[4, 1], [2, 7], [3, 3]])
    assert ex.psum(v).tolist() == [9, 11]
    assert ex.pmax(v).tolist() == [4, 7]
    assert ex.pmin(v).tolist() == [2, 1]
    assert ex.all_gather(v) is v
    with pytest.raises(ValueError, match="leading dims"):
        ex.all_to_all(torch.zeros((2, 3)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ShardMesh(1)
    with pytest.raises(TypeError, match="ShardMesh"):
        ShardedTensorSearch(_pingpong(), 2)


def test_partition_rules_cover_every_carry_leaf():
    """Every carry leaf of every configuration has a rule (the shard
    axis, or None for the host's chunk index, window pass and noapp); an
    unmatched leaf raises."""
    pb = _spec_pruned(pb_spec(2, 1, 1).compile())
    for proto, kw in ((_pingpong(), {}),
                      (_pingpong(), dict(record_trace=True)),
                      (_pingpong(), dict(spill=True)), (pb, {})):
        s = _sh(proto, 2, **kw)
        names = s._carry_names()
        specs = match_partition_rules(CARRY_PARTITION_RULES, names)
        assert set(specs) == set(names)
        assert {k for k, v in specs.items() if v is None} == {
            "j", "evp", "noapp"}
        carry = s._empty_carry_sh()
        for k, v in specs.items():
            if v is not None:
                assert carry[k].shape[0] == 2, k
    with pytest.raises(ValueError, match="no partition rule"):
        match_partition_rules(CARRY_PARTITION_RULES, ["cur", "mystery"])


# --------------------------------------------------------- width matrix

@pytest.mark.parametrize("strict", [True, False], ids=["strict", "beam"])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_width_matrix_pingpong(d, strict):
    """SPACE_EXHAUSTED with the solo engine's unique and explored counts
    at every width, with the in-chunk prefilter (strict, D > 1) and with
    owner-side dedup only (beam)."""
    out = _sh(_pingpong(), d, strict=strict).run()
    assert _key(out) == _key(_solo(_pingpong(), strict=strict)) == PINGPONG
    assert out.dropped == 0 and len(out.levels) == out.depth
    assert {len(lv["per_device"]["frontier"]) for lv in out.levels} == {d}


@pytest.mark.parametrize("d", [1, 8])
def test_width_matrix_lab1(d):
    p = pruned(make_clientserver_protocol(n_clients=2, w=2))
    out = _sh(p, d, frontier_cap=1 << 9, visited_cap=1 << 12).run()
    assert _key(out) == _key(_solo(p)) == LAB1


# ------------------------------------------------- drivers, exchanges

@pytest.mark.parametrize("d", [2, 8])
def test_superstep_matches_legacy_driver_and_exchange(d):
    """The fused-exchange superstep, the superstep over the legacy
    exchange and the legacy per-chunk driver agree exactly."""
    p = _pingpong()
    fused = _sh(p, d).run()
    boundary = _sh(p, d, row_exchange=False).run()
    legacy = _sh(p, d, superstep=False).run()
    assert legacy.levels and not _sh(p, d, superstep=False).row_exchange
    assert _exact(fused) == _exact(boundary) == _exact(legacy)
    assert _key(fused) == PINGPONG


def test_drivers_agree_on_paxos_depth_5():
    """``paxos_spec(3)`` to depth 5 (packed) at D = 4: both drivers, both
    exchanges and the solo engine."""
    p = dataclasses.replace(paxos_spec(3).compile(), goals={})
    kw = dict(max_depth=5, frontier_cap=1 << 10, visited_cap=1 << 12)
    runs = [_sh(p, 4, **kw), _sh(p, 4, row_exchange=False, **kw),
            _sh(p, 4, superstep=False, **kw)]
    assert runs[0]._pk is not None
    keys = {_exact(s.run()) for s in runs}
    assert keys == {_key(_solo(p, max_depth=5)) + (0,)}


def test_window_passes_exact_counts():
    """A tiny ``ev_budget`` with window passes gives the full grid's
    counts on both drivers; a beam run without passes counts the events
    past its window as drops."""
    p = _pingpong()
    for sup in (True, False):
        out = _sh(p, 8, ev_budget=(2, 1), ev_spill=True,
                  superstep=sup).run()
        assert _key(out) == PINGPONG and out.dropped == 0
    beam = _sh(p, 2, ev_budget=(2, 1), strict=False).run()
    assert beam.dropped > 0


def test_count_only_final_level_matches_depth_limit():
    """The final depth-limited level counts its fresh states without a
    frontier (noapp): the solo engine's depth-4 counts."""
    p = _pingpong()
    out = _sh(p, 8, max_depth=4).run()
    assert _key(out) == _key(_solo(p, max_depth=4))
    assert out.end_condition == "DEPTH_EXHAUSTED"


# ------------------------------------------------------------- packing

@pytest.mark.parametrize("d", [2, 8])
def test_packed_rows_match_raw_rows(d):
    """The packed wire (the generated spec's codec) and the raw oracle
    (``mesh_pack=False``) agree exactly; the verdict stamps the ratio."""
    p = _spec_pruned(pingpong_spec(2).compile())
    s = _sh(p, d)
    assert s._pk is not None and s.plane == s._pk.words < s.lanes
    packed = s.run()
    raw = _sh(p, d, mesh_pack=False)
    assert raw._pk is None and raw.plane == raw.lanes
    assert _exact(packed) == _exact(raw.run())
    assert packed.pack_ratio == pytest.approx(s.lanes / s.plane, rel=0.01)
    assert all(lv["pack_ratio"] > 1.0 for lv in packed.levels)


def test_delta_lanes_on_the_pb_twin():
    """pb's view-number fields pack against a per-level base (delta
    lanes, level base folded with pmin): equal to the raw wire and to
    the solo engine."""
    p = _spec_pruned(pb_spec(2, 1, 1).compile())
    kw = dict(max_depth=3, frontier_cap=1 << 9, visited_cap=1 << 12)
    s = _sh(p, 2, **kw)
    assert s._mesh_delta and {"pb_cur", "pb_nxt"} <= set(s._carry_names())
    out = s.run()
    assert _exact(out) == _exact(_sh(p, 2, mesh_pack=False, **kw).run())
    assert _key(out) == _key(_solo(p, max_depth=3))
    assert out.states_explored > 0


# -------------------------------------------------------------- steal

def test_steal_plan_conserves_rows():
    """Donations conserve rows, never exceed a chunk per pair, move
    whole chunks past depth 1 and respect the gate."""
    s = _sh(_pingpong(), 8, steal_threshold=1.25)
    D, K = s.n_devices, s.cpd
    occ = [800] + [0] * (D - 1)
    plan = s._steal_plan(occ, depth=5)
    assert plan is not None and plan.shape == (D, D) and plan.max() <= K
    after = [int(o - plan[d].sum() + plan[:, d].sum())
             for d, o in enumerate(occ)]
    assert sum(after) == sum(occ) and max(after) < max(occ)
    assert (plan[plan > 0] % K == 0).all()
    assert s._steal_plan([5] + [0] * (D - 1), depth=1).sum() > 0
    assert s._steal_plan([100] * D, depth=5) is None
    assert _sh(_pingpong(), 1, steal_threshold=1.25)._steal_plan(
        [100], 5) is None
    assert not _sh(_pingpong(), 8)._steal_on


def test_steal_matches_no_steal():
    """On the skewed fixture (a lone root on one owner) the steal moves
    rows and improves the frontier's imbalance; the counts are the
    no-steal run's."""
    p = _spec_pruned(clientserver_spec(3, 4).compile())
    kw = dict(chunk_per_device=4, frontier_cap=1 << 9,
              visited_cap=1 << 13, max_depth=8)
    base = _sh(p, 8, **kw).run()
    out = _sh(p, 8, steal_threshold=1.05, **kw).run()
    assert _exact(out) == _exact(base)
    steals = [lv["steal"] for lv in out.levels if lv.get("steal")]
    assert steals and all(s["moved"] > 0 and s["imbalance_after"]
                          <= s["imbalance_before"] for s in steals)


# ------------------------------------------------------------ capacity

def test_strict_full_table_raises_beam_treats_as_fresh():
    """A table too small: strict raises ``CapacityOverflow``; beam
    treats unresolved keys as fresh, counted on ``visited_overflow``."""
    p = pruned(make_clientserver_protocol(n_clients=2, w=2))
    with pytest.raises(CapacityOverflow):
        _sh(p, 2, visited_cap=8, frontier_cap=1 << 9).run()
    out = _sh(p, 2, visited_cap=8, frontier_cap=1 << 9, strict=False,
              max_depth=5).run()
    assert out.visited_overflow > 0
    assert out.states_explored >= _solo(p, max_depth=5).states_explored


def test_strict_frontier_drop_raises_beam_counts():
    p = pruned(make_clientserver_protocol(n_clients=2, w=2))
    with pytest.raises(CapacityOverflow, match="capacity drops"):
        _sh(p, 2, chunk_per_device=4, frontier_cap=4,
            visited_cap=1 << 12).run()
    beam = _sh(p, 2, chunk_per_device=4, frontier_cap=4,
               visited_cap=1 << 12, strict=False).run()
    assert beam.dropped > 0


# ------------------------------------------------- traces, staged runs

def test_violation_trace_replays_on_object_twin():
    """A sharded INVARIANT_VIOLATED on a bound lab twin (runtime delivery
    masks included) carries a trace of the solo engine's length that
    replays on the object twin to a violating state."""
    from dslabs_tpu_torch.tpu import backend as tback
    from dslabs_tpu_torch.tpu.trace import reconstruct_object_trace
    from tests import torch_harness_cases as HC

    case = HC.lab0_violation(PORT)
    binding = tback.resolve_binding(case.state)
    proto, marr, tarr = tback._bind_protocol(
        binding, case.settings, *binding.initial_caps())
    s = _sh(proto, 8, frontier_cap=1 << 9, visited_cap=1 << 12,
            record_trace=True)
    s.set_runtime_masks(marr, tarr)
    out = s.run()
    solo = TensorSearch(proto, chunk=16, record_trace=True, device="cpu")
    solo.set_runtime_masks(marr, tarr)
    ref = solo.run()
    assert out.end_condition == ref.end_condition == "INVARIANT_VIOLATED"
    assert out.trace and len(out.trace) == len(ref.trace) == out.depth
    pred = PORT.NONE_DECIDED
    end = reconstruct_object_trace(s, out, HC.lab0_violation(PORT).state,
                                   predicate=pred)
    assert not pred.check(end).value and end.depth <= out.depth


def test_staged_search_from_goal_state():
    """``run(initial=)`` from a phase-1 goal state: the solo engine's
    staged verdict and counts."""
    p = make_clientserver_protocol(n_clients=1, w=2)
    kw = dict(chunk_per_device=32, frontier_cap=1 << 9,
              visited_cap=1 << 12)
    phase1 = _sh(p, 8, **kw).run()
    assert phase1.end_condition == "GOAL_FOUND"
    p2 = dataclasses.replace(p, goals={},
                             prunes={"DONE": p.goals["CLIENTS_DONE"]})
    out = _sh(p2, 8, **kw).run(initial=phase1.goal_state)
    solo = TensorSearch(p2, chunk=64, device="cpu").run(
        initial=phase1.goal_state)
    assert _key(out) == _key(solo)
    assert out.end_condition == "SPACE_EXHAUSTED"


def test_symmetric_paxos_canonical_counts():
    """Symmetric ``paxos_spec(3)`` (DECIDED pruned) at D = 4: the solo
    engine's canonical counts, pinned against the JAX package in
    ``tests/test_torch_symmetry.py`` (50 / 375 at depth 11)."""
    p = _spec_pruned(paxos_spec(3).compile())
    out = _sh(p, 4, symmetry=True, frontier_cap=1 << 9,
              visited_cap=1 << 12).run()
    assert _key(out) == ("SPACE_EXHAUSTED", 50, 375, 11)
    assert out.symmetry_perms == 6


def test_fault_counts_ride_the_sharded_stats():
    """The partitioned flagship (a fault model) at D = 2 to depth 2: the
    solo engine's counts and fault-event counts by family, also on the
    last level record."""
    from dslabs_tpu_torch.tpu import specs_lab3

    p = dataclasses.replace(specs_lab3.make_paxos_partition_spec(
        n=3, n_clients=1, w=1, max_slots=2, net_cap=48).compile(),
        goals={})
    out = _sh(p, 2, chunk_per_device=32, frontier_cap=1 << 10,
              visited_cap=1 << 12, max_depth=2).run()
    solo = _solo(p, max_depth=2)

    def faults(o):
        return (o.fault_events, o.partition_events, o.crash_events,
                o.drop_events, o.dup_events)

    assert _key(out) == _key(solo)
    assert faults(out) == faults(solo) and out.partition_events > 0
    assert out.levels[-1]["faults"]["fault_events"] == out.fault_events


# ---------------------------------------------------------- time budget

class _Clock:
    """time() = base + dispatches * step; the dispatch hook advances it,
    so a budget expires at a chosen dispatch."""

    def __init__(self, step):
        self.base, self.step, self.dispatches = 1e6, step, 0

    def time(self):
        return self.base + self.dispatches * self.step


def _clocked(proto, superstep, max_secs, clock):
    s = _sh(proto, 8, chunk_per_device=32, frontier_cap=1 << 9,
            visited_cap=1 << 12, max_secs=max_secs, superstep=superstep,
            superstep_chunks=1)

    def hook(tag, fn, *args):
        clock.dispatches += 1
        return fn(*args)

    s._dispatch_hook = hook
    return s.run()


@pytest.mark.parametrize("superstep", [True, False],
                         ids=["superstep", "legacy"])
def test_time_budget(superstep, monkeypatch):
    """A budget gives TIME_EXHAUSTED with partial counts; a violation in
    a completed chunk is reported even when the budget ran out at its
    own sync."""
    p = _pingpong()
    full = _clocked(p, superstep, None, _Clock(0.0))
    assert full.end_condition == "SPACE_EXHAUSTED"
    clock = _Clock(1.0)
    monkeypatch.setattr(sh_mod, "time", clock)
    out = _clocked(p, superstep, 3.5, clock)
    assert out.end_condition == "TIME_EXHAUSTED"
    assert 0 < out.states_explored < full.states_explored
    monkeypatch.undo()

    v = make_clientserver_protocol(n_clients=1, w=1)
    done = v.goals["CLIENTS_DONE"]
    v = dataclasses.replace(
        v, goals={}, invariants={"NEVER_DONE": lambda s, f=done: ~f(s)})
    counting = _Clock(0.0)
    base = _clocked(v, superstep, None, counting)
    assert base.end_condition == "INVARIANT_VIOLATED"
    clock = _Clock(1.0)
    monkeypatch.setattr(sh_mod, "time", clock)
    out = _clocked(v, superstep, counting.dispatches - 0.5, clock)
    assert out.end_condition == "INVARIANT_VIOLATED"
    assert (out.predicate_name, out.depth) == (base.predicate_name,
                                               base.depth)


# -------------------------------------------------- telemetry, audit

@pytest.mark.parametrize("superstep", [True, False],
                         ids=["superstep", "legacy"])
def test_telemetry_spans_equal_dispatches_per_shard_lanes(superstep):
    """Every dispatch is one span under a registered tag; each level
    record's ``per_device`` lanes have D entries; the outcome record
    names the engine."""
    tel = ttel.Telemetry()
    s = _sh(_pingpong(), 4, telemetry=tel, superstep=superstep)
    tags = []
    s._dispatch_hook = lambda tag, fn, *a: (tags.append(tag), fn(*a))[1]
    out = s.run()
    spans = [r for r in tel.ring if r["t"] == "span"]
    assert len(spans) == len(tags) and tags
    assert {r["tag"] for r in spans} <= set(ttel.DISPATCH_SITES)
    assert (tags.count("sharded.superstep") if superstep
            else tags.count("sharded.sync")) == out.depth
    levels = [r for r in tel.levels if r["engine"] == "sharded"]
    assert len(levels) == out.depth
    for rec in levels:
        pd = rec["per_device"]
        assert {len(v) for v in pd.values()} == {4}
        assert set(rec["skew"]) >= {"explored", "frontier"}
    assert sum(sum(r["per_device"]["explored"]) for r in levels) == \
        out.states_explored


def _audited(s):
    rep = {}
    found = H.audit_search(s, deep=True, report=rep)
    assert found == [], [f.as_dict() for f in found]
    assert {k: v["syncs"] for k, v in rep.items()} == {
        k: v["budget"] for k, v in rep.items()}
    return rep


def test_audit_sharded_sites_at_budget():
    """Every configuration's sites: no finding, syncs equal to budgets
    (the superstep: the readback, plus the count before the pack, the
    window check, the abort code where they apply)."""
    from dslabs_tpu_torch.tpu.spill import spill_manager_for_audit

    rep = _audited(_sh(make_pingpong_protocol(2), 2, superstep=False))
    assert (rep["sharded.step"]["syncs"], rep["sharded.sync"]["syncs"]) \
        == (0, 1)
    rep = _audited(_sh(paxos_spec(3).compile(), 4, symmetry=True,
                       visited_cap=1 << 12, steal_threshold=1.2))
    assert rep["sharded.superstep"]["syncs"] == 2
    assert rep["sharded.steal"]["syncs"] == 1
    rep = _audited(_sh(_spec_pruned(pb_spec(2, 1, 1).compile()), 2,
                       visited_cap=1 << 12,
                       spill=spill_manager_for_audit()))
    assert rep["sharded.superstep"]["syncs"] == 3
    assert rep["sharded.spill_reinject"]["syncs"] == 2
    rep = _audited(_sh(make_pingpong_protocol(2), 2, ev_budget=(2, 1)))
    assert rep["sharded.superstep"]["syncs"] == 2
    for tag in ("sharded.superstep", "sharded.step", "sharded.sync",
                "sharded.promote", "sharded.init", "sharded.steal",
                "sharded.spill_drain", "sharded.spill_evict",
                "sharded.spill_reinject"):
        assert tag in ttel.DISPATCH_SITES, tag
    assert _sh(_pingpong(), 2).lane_signature() is None


# ---------------------------------------------- the JAX engine at D = 2

def test_shards_equal_jax_engine_at_d2(tmp_path):
    """The JAX ``ShardedTensorSearch`` on two virtual devices and the port
    at D = 2 on pruned lab 1 (generated spec, packed): equal per-shard
    frontier occupancies at every level, and after the same levels equal
    dumps: the frontier rows in shard order, the visited keys in shard
    order, the counts."""
    pytest.importorskip("jax")
    from dslabs_tpu.tpu import sharded as jsh
    from dslabs_tpu.tpu.specs import clientserver_spec as j_cs

    kw = dict(max_depth=6, checkpoint_every=1, **KW)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jo = jsh.ShardedTensorSearch(
        _spec_pruned(j_cs(2, 2).compile()), jsh.make_mesh(2),
        checkpoint_path=jpath, **kw).run()
    to = ShardedTensorSearch(
        _spec_pruned(clientserver_spec(2, 2).compile()), _mesh(2),
        checkpoint_path=tpath, **kw).run()
    assert _exact(to) == (jo.end_condition, jo.unique_states,
                          jo.states_explored, jo.depth, jo.dropped)
    assert [lv["per_device"]["frontier"] for lv in to.levels] == \
        [lv["per_device"]["frontier"] for lv in jo.levels]
    assert [lv["per_device"]["explored"] for lv in to.levels] == \
        [lv["per_device"]["explored"] for lv in jo.levels]
    a, b = np.load(jpath), np.load(tpath)
    assert int(a["depth"]) == int(b["depth"]) == 5
    for k in ("frontier", "visited_keys", "explored",
              "extra__frontier_encoding"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(b["frontier"]) > 2
