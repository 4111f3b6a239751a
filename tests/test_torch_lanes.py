"""PyTorch port, batched job lanes (``dslabs_tpu_torch/tpu/lanes.py``), on
the CPU: the cases of ``tests/test_lanes.py``.

Every lane's end condition, unique, explored and depth are held against
the port's solo ``TensorSearch`` and the JAX package's ``LaneSearch`` on
the same protocol (integers, exactly); goal states against both.  The
port runs with ``device="cpu"``, where the kernels' plain versions stand
in.  Batch children are spawned with ``device="cpu"`` and
``OMP_NUM_THREADS=1`` and rebuild the port's protocols
(``tests.torch_harness_cases:pruned_without_jax`` refuses a process that
loaded JAX).  The service drains run with the memo off, as the port has
no memo yet (``CheckServer(memo=False)``)."""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)

from dslabs_tpu.tpu import engine as jeng  # noqa: E402
from dslabs_tpu.tpu import lanes as jlanes  # noqa: E402
from dslabs_tpu.tpu.protocols.clientserver import \
    make_clientserver_protocol as j_cs  # noqa: E402
from dslabs_tpu.tpu.protocols.pingpong import \
    make_pingpong_protocol as j_pp  # noqa: E402
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.tpu.lanes import (LaneBatchWarden, LaneJob,  # noqa: E402
                                        LaneSearch, job_signature)
from dslabs_tpu_torch.tpu.protocols.clientserver import \
    make_clientserver_protocol as t_cs  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.pingpong import \
    make_pingpong_protocol as t_pp  # noqa: E402
from tests.torch_harness_cases import pruned  # noqa: E402

pytestmark = pytest.mark.lanes

CHILD_ENV = {"OMP_NUM_THREADS": "1"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The reference's test sizes (tests/test_lanes.py), so that the JAX
# programs come from the suite's compile cache.
KW = dict(frontier_cap=1 << 10, chunk=64, visited_cap=1 << 12)
TKW = dict(KW, device="cpu")
LAB1 = {"factory": "dslabs_tpu_torch.tpu.protocols.clientserver:"
                   "make_clientserver_protocol",
        "factory_kwargs": {"n_clients": 2, "w": 2},
        "transform": "tests.torch_harness_cases:pruned_without_jax"}


def _key(o):
    return (o.end_condition, o.states_explored, o.unique_states, o.depth)


def _pingpong(pkg_pp):
    return pruned(pkg_pp(workload_size=2))


def _lab1(pkg_cs):
    # 582 explored / 80 unique / depth 11: multi-chunk levels and
    # mixed-depth lanes.
    return pruned(pkg_cs(n_clients=2, w=2))


def _jax_lanes(proto, n_lanes, jobs, **kw):
    res = jlanes.LaneSearch(proto, n_lanes=n_lanes,
                            **dict(KW, **kw)).run_lanes(jobs)
    assert not res.errors
    return {jid: _key(o) for jid, o in res.outcomes.items()}


class _Spy:
    """Dispatch counter at the ``_dispatch`` seam."""

    def __init__(self):
        self.tags = []

    def __call__(self, tag, fn, *args):
        self.tags.append(tag)
        return fn(*args)


# ---------------------------------------------------------- parity matrix

@pytest.fixture(scope="module")
def pingpong_ref():
    """The port's solo run and the JAX LaneSearch's per-lane verdict."""
    solo = teng.TensorSearch(_pingpong(t_pp), strict=True, **TKW).run()
    ref = _jax_lanes(_pingpong(j_pp), 4, [jlanes.LaneJob(f"j{i}")
                                          for i in range(4)])
    assert set(ref.values()) == {_key(solo)}
    return solo


@pytest.mark.parametrize("L", [1, 2, 4])
def test_lane_parity_matrix_pingpong_strict(L, pingpong_ref):
    res = LaneSearch(_pingpong(t_pp), n_lanes=L, strict=True,
                     **TKW).run_lanes([LaneJob(f"j{i}") for i in range(L)])
    assert not res.errors and len(res.outcomes) == L
    for out in res.outcomes.values():
        assert _key(out) == _key(pingpong_ref)
        assert out.engine == "lanes" and out.lane_width == L
    assert sum(o.lane_share for o in res.outcomes.values()) == \
        pytest.approx(1.0, abs=1e-4)


@pytest.mark.parametrize("strict", [True, False])
def test_lane_parity_lab1(strict):
    solo = teng.TensorSearch(_lab1(t_cs), strict=strict, **TKW).run()
    res = LaneSearch(_lab1(t_cs), n_lanes=2, strict=strict,
                     **TKW).run_lanes([LaneJob("a"), LaneJob("b")])
    ref = _jax_lanes(_lab1(j_cs), 2, [jlanes.LaneJob("a"),
                                      jlanes.LaneJob("b")], strict=strict)
    assert not res.errors
    assert {j: _key(o) for j, o in res.outcomes.items()} == ref
    assert set(ref.values()) == {_key(solo)}
    assert _key(solo) == ("SPACE_EXHAUSTED", 582, 80, 11)


def test_lane_parity_mixed_depth_limits():
    """Lane-mates with different depth limits finish at different levels;
    each still equals its own solo run: a finished lane is a no-op for
    its neighbours."""
    proto = _lab1(t_cs)
    solo = {d: _key(teng.TensorSearch(proto, strict=True, max_depth=d,
                                      **TKW).run())
            for d in (None, 4, 7)}
    limits = {"full": None, "d4": 4, "d7": 7, "full2": None}
    res = LaneSearch(proto, n_lanes=4, strict=True, **TKW).run_lanes(
        [LaneJob(j, max_depth=d) for j, d in limits.items()])
    ref = _jax_lanes(_lab1(j_cs), 4, [jlanes.LaneJob(j, max_depth=d)
                                      for j, d in limits.items()])
    assert not res.errors
    got = {j: _key(o) for j, o in res.outcomes.items()}
    assert got == ref
    assert got == {j: solo[d] for j, d in limits.items()}


def test_lane_goal_verdict_parity():
    """A goal verdict survives the per-lane extraction: the predicate,
    the first-hit state and the counters of the solo run and of the JAX
    lanes."""
    solo = teng.TensorSearch(t_pp(workload_size=2), strict=True,
                             **TKW).run()
    res = LaneSearch(t_pp(workload_size=2), n_lanes=2, strict=True,
                     **TKW).run_lanes([LaneJob("g0"), LaneJob("g1")])
    jres = jlanes.LaneSearch(j_pp(workload_size=2), n_lanes=2, strict=True,
                             **KW).run_lanes([jlanes.LaneJob("g0"),
                                              jlanes.LaneJob("g1")])
    assert not res.errors and not jres.errors
    assert solo.end_condition == "GOAL_FOUND"
    for jid, out in res.outcomes.items():
        ref = jres.outcomes[jid]
        assert _key(out) == _key(solo) == _key(ref)
        assert out.predicate_name == solo.predicate_name \
            == ref.predicate_name
        for k in solo.goal_state:
            assert np.array_equal(np.asarray(out.goal_state[k]),
                                  np.asarray(solo.goal_state[k])), k
            assert np.array_equal(np.asarray(out.goal_state[k]),
                                  np.asarray(ref.goal_state[k])), k


def test_lane_parity_finite_ev_budget():
    """A finite ``ev_budget`` needs further window passes over a chunk;
    the batch repeats a pass while any lane has window events left, and a
    lane with none selects no pairs there, so lanes at mixed depths equal
    their solo runs and the JAX lanes."""
    proto = _lab1(t_cs)
    limits = {"full": None, "d5": 5, "full2": None}
    solo = {d: _key(teng.TensorSearch(proto, strict=True, max_depth=d,
                                      ev_budget=2, **TKW).run())
            for d in (None, 5)}
    ls = LaneSearch(proto, n_lanes=3, strict=True, ev_budget=2, **TKW)
    assert ls._windowed
    spy = _Spy()
    ls._dispatch_hook = spy
    res = ls.run_lanes([LaneJob(j, max_depth=d) for j, d in limits.items()])
    ref = _jax_lanes(_lab1(j_cs), 3, [jlanes.LaneJob(j, max_depth=d)
                                      for j, d in limits.items()],
                     ev_budget=2)
    assert not res.errors
    got = {j: _key(o) for j, o in res.outcomes.items()}
    assert got == ref == {j: solo[d] for j, d in limits.items()}
    assert got["full"] == ("SPACE_EXHAUSTED", 582, 80, 11)
    # Still one superstep per level: the window passes run inside it.
    assert spy.tags.count("lanes.superstep") == res.levels


# ------------------------------------------------------ continuous batching

def test_continuous_batching_swap_in_parity():
    proto = _lab1(t_cs)
    solo = _key(teng.TensorSearch(proto, strict=True, **TKW).run())
    solo_d4 = _key(teng.TensorSearch(proto, strict=True, max_depth=4,
                                     **TKW).run())
    limits = {"a": 4, "b": None, "c": 4, "d": None, "e": None}
    res = LaneSearch(proto, n_lanes=2, strict=True, **TKW).run_lanes(
        [LaneJob(j, max_depth=d) for j, d in limits.items()], swap=True)
    jres = jlanes.LaneSearch(_lab1(j_cs), n_lanes=2, strict=True,
                             **KW).run_lanes(
        [jlanes.LaneJob(j, max_depth=d) for j, d in limits.items()],
        swap=True)
    assert not res.errors
    assert res.swaps >= 2 and res.swaps == jres.swaps
    for jid, d in limits.items():
        assert _key(res.outcomes[jid]) == (solo if d is None else solo_d4)
        assert _key(res.outcomes[jid]) == _key(jres.outcomes[jid])
    assert sum(o.lane_share for o in res.outcomes.values()) == \
        pytest.approx(1.0, abs=1e-4)


def test_dispatch_amortization_4_lanes():
    """A 4-lane batch's dispatches per job are at most 0.5x a solo run's
    (counted at the ``_dispatch`` seam), with one superstep per level."""
    proto = _lab1(t_cs)
    spy = _Spy()
    solo = teng.TensorSearch(proto, strict=True, **TKW)
    solo._dispatch_hook = spy
    solo.run()
    spy4 = _Spy()
    ls = LaneSearch(proto, n_lanes=4, strict=True, **TKW)
    ls._dispatch_hook = spy4
    res = ls.run_lanes([LaneJob(f"x{i}") for i in range(4)])
    assert not res.errors
    assert len(spy4.tags) / 4 <= 0.5 * len(spy.tags), (len(spy4.tags),
                                                       len(spy.tags))
    assert spy4.tags.count("lanes.superstep") == res.levels == 11
    assert spy4.tags.count("lanes.sync") == res.levels
    assert spy4.tags.count("lanes.promote") == res.levels
    assert res.dispatches == len(spy4.tags)


def test_solo_paths_untouched_when_lanes_off(monkeypatch):
    """Running a LaneSearch in the same process leaves the solo engine's
    dispatches, readbacks and chunk steps as they were."""
    proto = _pingpong(t_pp)
    calls = {"n": 0}
    orig = teng.to_host

    def counting(t):
        calls["n"] += 1
        return orig(t)

    def measure():
        spy = _Spy()
        s = teng.TensorSearch(proto, strict=True, **TKW)
        s._dispatch_hook = spy
        calls["n"] = 0
        monkeypatch.setattr(teng, "to_host", counting)
        try:
            out = s.run()
        finally:
            monkeypatch.setattr(teng, "to_host", orig)
        return _key(out), spy.tags, calls["n"], s.chunk_steps

    before = measure()
    LaneSearch(proto, n_lanes=2, strict=True, **TKW).run_lanes(
        [LaneJob("a"), LaneJob("b")])
    assert measure() == before


# --------------------------------------------------- checkpoints + resume

def test_lane_checkpoint_is_solo_resumable(tmp_path):
    """A lane's dump is the shared format: the port's solo TensorSearch
    and the JAX package's resume it to the full run's verdict."""
    solo = _key(teng.TensorSearch(_lab1(t_cs), strict=True, **TKW).run())
    ckpt = str(tmp_path / "lane0" / "ckpt.npz")
    os.makedirs(os.path.dirname(ckpt))
    res = LaneSearch(_lab1(t_cs), n_lanes=2, strict=True, **TKW).run_lanes(
        [LaneJob("stub", max_depth=6, checkpoint_path=ckpt,
                 checkpoint_every=1),
         LaneJob("mate", max_depth=3)])
    assert not res.errors
    resumed = teng.TensorSearch(_lab1(t_cs), strict=True,
                                checkpoint_path=ckpt, **TKW)
    assert resumed.has_resumable_checkpoint()
    out = resumed.run(resume=True)
    assert _key(out) == solo
    # The lane's last dump is depth 5: a lane that retires at its depth
    # limit is not dumped (as in the reference's lane loop).
    assert resumed._resumed_from_depth == 5
    jres = jeng.TensorSearch(_lab1(j_cs), strict=True,
                             checkpoint_path=ckpt, **KW)
    assert jres.has_resumable_checkpoint()
    assert _key(jres.run(resume=True)) == solo
    assert jres._resumed_from_depth == 5
    # A resumed lane batch continues the same dump to the same verdict.
    again = LaneSearch(_lab1(t_cs), n_lanes=1, strict=True,
                       **TKW).run_lanes(
        [LaneJob("stub", checkpoint_path=ckpt, checkpoint_every=0)],
        resume=True)
    assert _key(again.outcomes["stub"]) == solo


def test_sigkill_mid_batch_resumes_every_lane(tmp_path):
    """A SIGKILLed batch child respawns and every lane resumes from its
    own dump to its solo verdict; the shares still sum to 1, and the
    batch run dir carries the per-lane STATUS block."""
    solo = _key(teng.TensorSearch(_lab1(t_cs), strict=True, **TKW).run())
    jobs = []
    for i in range(4):
        ck = str(tmp_path / f"j{i}" / "ckpt.npz")
        os.makedirs(os.path.dirname(ck))
        jobs.append({"job_id": f"j{i}", "checkpoint_path": ck,
                     "checkpoint_every": 1})
    w = LaneBatchWarden(jobs=jobs, n_lanes=4, strict=True,
                        run_dir=str(tmp_path / "batch"), env=CHILD_ENV,
                        extra_sys_path=[REPO], device="cpu",
                        fault={"kind": "die", "at": 12}, **LAB1, **KW)
    # The child dies at dispatch 12, after every lane's depth-3 dump.
    kill_dump_depth = 3
    res = w.run()
    assert res.errors == {}, res.errors
    assert res.child_restarts >= 1
    assert w.deaths and w.deaths[0]["kind"] == "oom"
    for jid in ("j0", "j1", "j2", "j3"):
        assert _key(res.outcomes[jid]) == solo
        # Each lane's verdict names the depth of the dump it resumed.
        assert res.outcomes[jid].resumed_from_depth == kill_dump_depth
    assert w.last_platform == "cpu"
    total = sum(o.lane_share for o in res.outcomes.values())
    assert 0.99 <= total <= 1.01, total
    st = json.load(open(tmp_path / "batch" / "STATUS.json"))
    assert st["lanes"], st
    for lrec in st["lanes"]:
        for key in ("lane", "job_id", "depth", "explored", "unique",
                    "frontier"):
            assert key in lrec, (key, lrec)


def test_poisoned_lane_evicts_neighbors_bit_exact():
    """A lane past the strict table-pressure contract is poisoned (an
    eviction error) while its lane-mate equals its solo run."""
    kw = dict(frontier_cap=1 << 10, chunk=64, visited_cap=64, device="cpu")
    with pytest.raises(teng.CapacityOverflow):
        teng.TensorSearch(_lab1(t_cs), strict=True, **kw).run()
    solo_d3 = _key(teng.TensorSearch(_lab1(t_cs), strict=True, max_depth=3,
                                     **kw).run())
    res = LaneSearch(_lab1(t_cs), n_lanes=2, strict=True, **kw).run_lanes(
        [LaneJob("big"), LaneJob("small", max_depth=3)])
    assert "CapacityOverflow" in res.errors["big"]
    assert _key(res.outcomes["small"]) == solo_d3
    jres = jlanes.LaneSearch(_lab1(j_cs), n_lanes=2, strict=True,
                             frontier_cap=1 << 10, chunk=64,
                             visited_cap=64).run_lanes(
        [jlanes.LaneJob("big"), jlanes.LaneJob("small", max_depth=3)])
    assert set(jres.errors) == {"big"}
    assert _key(jres.outcomes["small"]) == solo_d3


# ------------------------------------------------------- scheduler packing

def _job(tenant, seq, **over):
    from dslabs_tpu_torch.service.queue import Job

    kw = dict(job_id=f"{tenant}-{seq:03d}", tenant=tenant,
              factory="f:mk", factory_kwargs={"w": 2}, strict=True,
              chunk=64, frontier_cap=256, visited_cap=1024,
              ladder=("device", "host"))
    kw.update(over)
    return Job(**kw)


def test_job_signature_eligibility():
    base = _job("a", 1)
    assert job_signature(base) == job_signature(_job("b", 2))
    assert job_signature(base) == jlanes.job_signature(base)
    assert job_signature(base) != job_signature(_job("a", 3, chunk=32))
    assert job_signature(base) != job_signature(
        _job("a", 4, factory="g:mk"))
    assert job_signature(_job("a", 5, fault={"kind": "die"})) is None
    assert job_signature(_job("a", 6, solo=True)) is None
    assert job_signature(_job("a", 7, ladder=("sharded", "host"))) is None


def test_pick_batch_quota_and_signature():
    """The lane packer keeps DRR's semantics: a tenant's lanes obey its
    quota, non-matching heads go back in order, matching jobs across
    tenants fill the batch."""
    from dslabs_tpu_torch.service.scheduler import DeficitRoundRobin

    drr = DeficitRoundRobin(quota=1)
    for t in ("a", "b", "c"):
        drr.push(_job(t, 1))
        drr.push(_job(t, 2))
    batch = drr.pick_batch({}, job_signature, max_jobs=4)
    assert sorted(j.tenant for j in batch) == ["a", "b", "c"]
    assert drr.pending() == 3
    drr2 = DeficitRoundRobin(quota=2)
    for t in ("a", "b"):
        drr2.push(_job(t, 1))
        drr2.push(_job(t, 2))
    assert len(drr2.pick_batch({}, job_signature, max_jobs=4)) == 4
    drr3 = DeficitRoundRobin(quota=1)
    drr3.push(_job("a", 1))
    drr3.push(_job("b", 1, chunk=32))
    batch3 = drr3.pick_batch({}, job_signature, max_jobs=4)
    assert [j.tenant for j in batch3] == ["a"]
    assert drr3.pending() == 1
    nxt = drr3.pick({})
    assert nxt is not None and nxt.tenant == "b"


# ------------------------------------------------------------ service stack

FACTORY = ("dslabs_tpu_torch.tpu.protocols.pingpong:"
           "make_exhaustive_pingpong")


def _mk_server(root, lanes, **over):
    from dslabs_tpu_torch.service.server import CheckServer

    kw = dict(workers=1, queue_cap=16, elastic=False, admission=False,
              env=CHILD_ENV, lanes=lanes, memo=False, device="cpu")
    kw.update(over)
    return CheckServer(str(root), **kw)


def _submit_jobs(srv, tenants=("alice", "bob"), per=2):
    for t in tenants:
        for _ in range(per):
            r = srv.submit(factory=FACTORY,
                           factory_kwargs={"workload_size": 2}, tenant=t,
                           chunk=64, frontier_cap=1 << 8,
                           visited_cap=1 << 12, max_secs=60.0)
            assert r.get("accepted"), r


def test_service_lane_drain_costs_match_solo(tmp_path):
    """The reference's lane cost test with the memo off: per-tenant COSTS
    explored and unique equal between a solo and a batched drain,
    dispatches per job at most 0.5x, the lanes block in SERVER_STATUS,
    the drain summary and the journal, and a lane job's causal tree
    carrying the shared batch spans."""
    from dslabs_tpu_torch.tpu import tracing

    def drain(lanes, root):
        srv = _mk_server(root, lanes, quota=2)
        _submit_jobs(srv)
        summary = srv.drain(max_secs=300)
        srv.close()
        return summary

    solo = drain(0, tmp_path / "solo")
    lane = drain(4, tmp_path / "lane")
    assert solo["failed"] == 0 and lane["failed"] == 0
    key = ("tenant", "end", "unique", "explored", "depth")
    sv = sorted(tuple(r.get(k) for k in key) for r in solo["results"])
    lv = sorted(tuple(r.get(k) for k in key) for r in lane["results"])
    assert sv == lv
    # The exhaustive pingpong's verdict in the JAX package.
    jout = jeng.TensorSearch(
        __import__("dslabs_tpu.tpu.protocols.pingpong", fromlist=["x"])
        .make_exhaustive_pingpong(workload_size=2), strict=True,
        chunk=64, frontier_cap=1 << 8, visited_cap=1 << 12).run()
    assert {v[1:] for v in lv} == {(jout.end_condition, jout.unique_states,
                                    jout.states_explored, jout.depth)}
    agg = {}
    for mode, root in (("solo", tmp_path / "solo"),
                       ("lane", tmp_path / "lane")):
        recs, torn = tracing.read_flight_lax(str(root / tracing.COSTS_NAME))
        assert torn == 0
        agg[mode] = tracing.aggregate_costs(recs)
    for t in ("alice", "bob"):
        assert agg["solo"][t]["explored"] == agg["lane"][t]["explored"]
        assert agg["solo"][t]["unique"] == agg["lane"][t]["unique"]
    assert lane["dispatches_per_job"] <= 0.5 * solo["dispatches_per_job"]
    lb = lane["lanes"]
    assert lb["batches"] >= 1 and lb["jobs_in_lanes"] == 4
    assert lb["evicted"] == 0
    assert lb["by_signature"]
    shares = [r["lane_share"] for r in lane["results"]]
    assert sum(shares) == pytest.approx(1.0, abs=1e-4)
    st = json.load(open(tmp_path / "lane" / "SERVER_STATUS.json"))
    assert st["lanes"] == lb
    journal, _ = tracing.read_flight_lax(
        str(tmp_path / "lane" / "journal.jsonl"))
    evs = [r for r in journal if r.get("t") == "lane_batch"]
    assert evs and all(r.get("run_dir") for r in evs)
    tr = tracing.assemble(str(tmp_path / "lane"), job=evs[0]["jobs"][0])
    (j,) = tr["jobs"]
    kinds = {n["kind"] for n in j["nodes"]}
    assert "lane_batch" in kinds, kinds
    assert [n for n in j["nodes"] if n.get("shared")]


@pytest.mark.slow
def test_service_evicted_lane_retries_solo(tmp_path):
    """A job whose lane poisons (strict table pressure) is re-queued solo
    and still lands a verdict through the solo warden ladder (the host
    rung's unbounded visited set)."""
    srv = _mk_server(tmp_path, 2, quota=2)
    for _ in range(2):
        r = srv.submit(factory=FACTORY, factory_kwargs={"workload_size": 2},
                       tenant="carol", chunk=64, frontier_cap=1 << 8,
                       visited_cap=8, max_secs=120.0)
        assert r.get("accepted"), r
    summary = srv.drain(max_secs=300)
    srv.close()
    assert summary["completed"] == 2, summary
    assert summary["lanes"]["evicted"] == 2
    assert {r["end"] for r in summary["results"]} == {"SPACE_EXHAUSTED"}
    assert "lanes" not in {r["engine"] for r in summary["results"]}


# ------------------------------------------------------------ observability

def test_lane_dispatch_sites_registered_and_clean():
    """Every lane tag is in ``telemetry.DISPATCH_SITES``; the audit of a
    LaneSearch (and of the standard audit set, which holds one) reports
    no finding, and each lane site's host syncs equal its budget."""
    from dslabs_tpu_torch.analysis import hotpath_audit as HA
    from dslabs_tpu_torch.tpu.specs import paxos_spec
    from dslabs_tpu_torch.tpu.telemetry import DISPATCH_SITES

    for tag in ("lanes.init", "lanes.superstep", "lanes.promote",
                "lanes.inject", "lanes.restore", "lanes.sync",
                "lanes.flags"):
        assert tag in DISPATCH_SITES, tag
    assert DISPATCH_SITES["lanes.superstep"]["hot"]
    assert DISPATCH_SITES["lanes.superstep"]["in_place"]
    assert DISPATCH_SITES["lanes.superstep"]["syncs"] is None
    assert any(isinstance(e, LaneSearch)
               for e in HA.build_audit_engines("cpu"))
    for ls, step_syncs in (
            (LaneSearch(_pingpong(t_pp), n_lanes=2, frontier_cap=1 << 8,
                        visited_cap=1 << 10, device="cpu"), 0),
            (LaneSearch(paxos_spec(3).compile(), n_lanes=2, symmetry=True,
                        chunk=16, frontier_cap=1 << 8,
                        visited_cap=1 << 12, device="cpu"), 1)):
        assert set(ls.dispatch_site_programs()) <= set(DISPATCH_SITES)
        rep = {}
        findings = HA.audit_search(ls, deep=True, report=rep)
        assert findings == [], [f.as_dict() for f in findings]
        for tag, row in rep.items():
            assert row["syncs"] == row["budget"], (tag, row)
        assert rep["lanes.superstep"]["syncs"] == step_syncs
        assert rep["lanes.restore"]["syncs"] == 3


def test_status_lanes_schema_and_watch(tmp_path):
    """STATUS.json of a lane batch carries the per-lane block, ``telemetry
    watch`` renders it, and each level record has one per-device entry
    per resident lane; swap-ins and evictions are events."""
    from dslabs_tpu_torch.tpu import telemetry as tel_mod

    tel = tel_mod.Telemetry.for_checkpoint(str(tmp_path / "ckpt.npz"),
                                           engine_hint="lane-batch")
    ls = LaneSearch(_pingpong(t_pp), n_lanes=2, telemetry=tel, **TKW)
    res = ls.run_lanes([LaneJob("a"), LaneJob("b", max_depth=3),
                        LaneJob("c", max_depth=2)])
    tel.close()
    assert not res.errors and res.swaps == 1
    st = json.load(open(tmp_path / "STATUS.json"))
    assert isinstance(st["lanes"], list) and st["lanes"]
    for lrec in st["lanes"]:
        assert set(lrec) >= {"lane", "job_id", "depth", "explored",
                             "unique", "frontier"}
    frame = tel_mod.render_watch(str(tmp_path))
    assert "job lane" in frame
    lane_levels = [r for r in tel.levels if r.get("lanes")]
    assert lane_levels and all(r["engine"] == "lanes" for r in lane_levels)
    first = lane_levels[0]
    assert len(first["per_device"]["explored"]) == len(first["lanes"])
    recs = tel_mod.read_flight(str(tmp_path / "flight.jsonl"))
    kinds = [r.get("kind") for r in recs if r.get("t") == "event"]
    assert "lane_swap_in" in kinds
    outs = [r for r in recs if r.get("t") == "outcome"]
    assert len(outs) == 3


def test_compare_guards_dispatches_per_job_and_occupancy(tmp_path):
    """``telemetry compare``: a dispatches-per-job rise or an occupancy
    drop past the threshold is a regression; parity is quiet."""
    from dslabs_tpu_torch.tpu import telemetry as tel_mod

    ok = str(tmp_path / "ok.jsonl")
    rec = {"t": "bench", "value": 100.0,
           "lanes": {"value": 400.0, "dispatches_per_job": 8.0,
                     "occupancy": 4.0},
           "service": {"dispatches_per_job": 8.0}}
    for _ in range(2):
        tel_mod.append_ledger(ok, rec)
    cmp = tel_mod.compare_ledger(tel_mod.read_ledger(ok))
    assert cmp["regressions"] == []
    bad = str(tmp_path / "bad.jsonl")
    tel_mod.append_ledger(bad, rec)
    tel_mod.append_ledger(bad, {
        "t": "bench", "value": 100.0,
        "lanes": {"value": 400.0, "dispatches_per_job": 20.0,
                  "occupancy": 1.5}})
    cmp = tel_mod.compare_ledger(tel_mod.read_ledger(bad))
    flagged = {e["phase"] for e in cmp["regressions"]}
    assert "service:dispatches_per_job" in flagged
    assert "lanes:occupancy" in flagged
    assert "dispatches_per_job" in tel_mod.render_compare(cmp)


def test_lane_outcome_crosses_the_pipe():
    """The lane fields ride the warden's pipe format."""
    from dslabs_tpu_torch.tpu.warden import (outcome_from_dict,
                                             outcome_to_dict)

    res = LaneSearch(_pingpong(t_pp), n_lanes=2, **TKW).run_lanes(
        [LaneJob("a"), LaneJob("b")])
    out = outcome_from_dict(json.loads(json.dumps(
        outcome_to_dict(res.outcomes["b"]))))
    assert (out.lane, out.lane_width, out.engine) == (1, 2, "lanes")
    assert out.lane_share == res.outcomes["b"].lane_share
