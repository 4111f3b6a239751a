"""PyTorch port, the owner-sharded engine over ranks (``dslabs_tpu_torch/
tpu/mesh_exchange.py`` ``RankMesh`` / ``ProcessGroupExchange``,
``tpu/ranks.py``, the supervisor's sharded rung over a ``RankMesh``), on
the CPU with two gloo ranks.

Two rank launches, each shared by its cases through a module-scoped
fixture: one batch of jobs (the exchange's operations on seeded inputs,
the generated pingpong, lab 1 and Paxos twins to depth 5 with a dump at
depth 4, a violating lab 0 twin with traces, lab 1 with and without the
boundary steal, the legacy per-chunk driver, a cut dump, the resume of a
JAX dump, lab 1 in spill mode, the swarm from the root and from a BFS
seed), and one supervised run whose rank 1 raises a fatal fault. Each
rank's result is held against ``LocalExchange`` at D = 2, and the
searches against the JAX ``ShardedTensorSearch`` at ``make_mesh(2)`` on
the conftest's virtual mesh: verdict and counts, the per-shard frontier
lanes of every level, and the dumps' frontier rows and visited keys in
shard order. One intra-op thread; every launch has a deadline and a
process-group timeout."""

import os
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dslabs_tpu_torch.tpu import checkpoint as tck  # noqa: E402
from dslabs_tpu_torch.tpu import ranks  # noqa: E402
from dslabs_tpu_torch.tpu.engine import TensorSearch  # noqa: E402
from dslabs_tpu_torch.tpu.mesh_exchange import (RankMesh,  # noqa: E402
                                                ShardMesh, as_mesh)
from dslabs_tpu_torch.tpu.sharded import (ShardedTensorSearch,  # noqa: E402
                                          make_mesh)
from dslabs_tpu_torch.tpu.supervisor import (FaultPlan,  # noqa: E402
                                             RetryPolicy, SearchSupervisor)
from tests import torch_harness_cases as HC  # noqa: E402

MESH = RankMesh(["cpu", "cpu"], "gloo")
DEADLINE = 300.0
PG_TIMEOUT = 60.0
DEPTH = 5
TWIN = "tests.torch_harness_cases:spec_twin"
CASES = {
    "pingpong": dict(spec="pingpong_spec", args=[2], goals="prune"),
    "lab1": dict(spec="clientserver_spec", args=[2, 2], goals="prune"),
    "paxos": dict(spec="paxos_spec", args=[3], goals="drop"),
}
CAPS = {
    "pingpong": dict(chunk_per_device=16, frontier_cap=1 << 8,
                     visited_cap=1 << 10),
    "lab1": dict(chunk_per_device=16, frontier_cap=1 << 9,
                 visited_cap=1 << 12),
    "paxos": dict(chunk_per_device=16, frontier_cap=1 << 10,
                  visited_cap=1 << 12),
}
PP = "dslabs_tpu_torch.tpu.protocols.pingpong:make_pingpong_protocol"
# Lab 1's spill shape (tests/test_torch_sharded_resume.py): one-row
# chunks, an 8-slot table per shard (about a tenth of the 80 states).
SPILL_KW = dict(chunk_per_device=1, frontier_cap=1 << 9, visited_cap=8,
                spill=True)
SWARM_KW = dict(walkers_per_device=8, max_steps=24, steps_per_round=2,
                seed=3, visited_cap=1 << 12, max_rounds=40)
# tests/test_tpu_sharded.py's pruned pingpong: the whole space.
PINGPONG = ("SPACE_EXHAUSTED", 8, 23, 5)
OPS = ("all_to_all", "all_to_all_bool", "all_to_all_many", "psum", "pmax",
       "pmin", "all_gather", "gather_np", "agree")


def _key(o):
    return (o.end_condition, o.unique_states, o.states_explored, o.depth)


def _twin(name, root="dslabs_tpu_torch"):
    return HC.spec_twin(**CASES[name], root=root)


def _local(name, d=2, **kw):
    return ShardedTensorSearch(_twin(name), make_mesh(d, device="cpu"),
                               **{**CAPS[name], **kw})


def _job(name, **kw):
    return ranks.search_job(TWIN, CASES[name], **{**CAPS[name], **kw})


def _bfs_seed(tmp):
    """A depth-2 BFS dump of the violating pingpong(3), the swarm's
    frontier seed."""
    from dslabs_tpu_torch.tpu.protocols.pingpong import \
        make_pingpong_protocol

    path = str(tmp / "bfs_seed.npz")
    TensorSearch(HC.violating(make_pingpong_protocol(3)), chunk=64,
                 max_depth=2, checkpoint_path=path, checkpoint_every=1,
                 device="cpu").run()
    return path


def _children_alive():
    """Rank processes this test process started that still run."""
    me, alive = os.getpid(), []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if ppid == me and b"dslabs_tpu_torch.tpu.ranks" in cmd:
            alive.append(int(pid))
    return alive


# ------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("ranks")


def _jax_twin(tmp, name):
    """The JAX engine at make_mesh(2): the twin to depth 5 with one dump,
    at depth 4 (one dump per run: the background writer never skips
    it)."""
    from dslabs_tpu.tpu import sharded as jsh

    path = str(tmp / f"j_{name}.npz")
    return jsh.ShardedTensorSearch(
        _twin(name, "dslabs_tpu"), jsh.make_mesh(2), max_depth=DEPTH,
        checkpoint_path=path, checkpoint_every=DEPTH - 1,
        **CAPS[name]).run(), path


@pytest.fixture(scope="module")
def runs(tmp):
    """The JAX engine's twin runs (the ranks resume the pingpong run's
    depth-4 dump), then one launch of two gloo ranks running every job
    of the module.  One after the other, so that the file never keeps
    more than two cores busy beside the suite's other workers."""
    pytest.importorskip("jax")
    jax_runs = {name: _jax_twin(tmp, name) for name in CASES}
    jobs = {"ops": {"kind": "call",
                    "fn": "tests.torch_harness_cases:exchange_ops",
                    "kwargs": {"seed": 7}}}
    for name in CASES:
        jobs[name] = _job(name, max_depth=DEPTH, checkpoint_every=DEPTH - 1,
                          checkpoint_path=str(tmp / f"r_{name}.npz"))
    jobs["violation"] = ranks.search_job(
        "tests.torch_harness_cases:lab0_violation_protocol",
        chunk_per_device=16, frontier_cap=1 << 9, visited_cap=1 << 12,
        record_trace=True)
    jobs["steal"] = _job("lab1", chunk_per_device=2, steal_threshold=1.05)
    jobs["no_steal"] = _job("lab1", chunk_per_device=2)
    jobs["legacy"] = _job("pingpong", superstep=False)
    jobs["cut"] = _job("pingpong", max_depth=3, checkpoint_every=2,
                       checkpoint_path=str(tmp / "r_cut.npz"))
    jobs["jax_resume"] = _job("pingpong", resume=True,
                              checkpoint_path=jax_runs["pingpong"][1])
    jobs["spill"] = _job("lab1", **SPILL_KW)
    jobs["spill_cut"] = _job("lab1", max_depth=6, checkpoint_every=1,
                             checkpoint_path=str(tmp / "r_spill.npz"),
                             **SPILL_KW)
    jobs["swarm"] = ranks.swarm_job(PP, {"workload_size": 3},
                                    "tests.torch_harness_cases:violating",
                                    **SWARM_KW)
    swk = str(tmp / "r_swarm.npz")
    jobs["swarm_cut"] = ranks.swarm_job(
        PP, {"workload_size": 3}, "tests.torch_harness_cases:violating",
        **{**SWARM_KW, "max_rounds": 1}, checkpoint_path=swk,
        checkpoint_every=1)
    jobs["swarm_resume"] = ranks.swarm_job(
        PP, {"workload_size": 3}, "tests.torch_harness_cases:violating",
        resume=True, checkpoint_path=swk, **SWARM_KW)
    jobs["swarm_seeded"] = ranks.swarm_job(
        PP, {"workload_size": 3}, "tests.torch_harness_cases:violating",
        frontier_seed=_bfs_seed(tmp), **SWARM_KW)
    t0 = time.time()
    res = ranks.launch(MESH, list(jobs.values()), deadline=DEADLINE,
                       pg_timeout=PG_TIMEOUT)
    names = list(jobs)
    return {"secs": time.time() - t0, "jax": jax_runs,
            "job": lambda n: [r["results"][names.index(n)] for r in res],
            "outcome": lambda n: ranks.outcome_of(res, names.index(n))}


@pytest.fixture(scope="module")
def batch(runs):
    return runs


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs["jax"]


@pytest.fixture(scope="module")
def supervised(tmp):
    """The elastic supervisor over the 2-rank mesh, rank 1 raising a fatal
    error at the level-4 superstep (dispatch 7 of the rung's init,
    (superstep, promote)* sequence) after the dumps of levels 1-3."""
    plan = FaultPlan().raise_at(7, error=RuntimeError, engine="sharded",
                                rank=1, message="injected rank fault")
    sup = SearchSupervisor(
        _twin("pingpong"), ladder=("sharded", "device", "host"), mesh=MESH,
        elastic=True, protocol_factory=TWIN,
        factory_kwargs=CASES["pingpong"], fault_plan=plan,
        policy=RetryPolicy(max_retries=0),
        checkpoint_path=str(tmp / "sup.npz"), checkpoint_every=1,
        device="cpu", chunk=16, frontier_cap=1 << 8, visited_cap=1 << 10)
    t0 = time.time()
    out = sup.run()
    return sup, out, time.time() - t0, _children_alive()


# ------------------------------------------------------------ the mesh

def test_as_mesh_of_distinct_devices_is_a_rank_mesh():
    """Distinct devices give a RankMesh (gloo unless every device is a
    distinct card); one device named throughout stays a ShardMesh."""
    m = as_mesh(["cpu", "cuda:0"])
    assert isinstance(m, RankMesh) and (m.width, m.backend) == (2, "gloo")
    m = as_mesh(["cuda:0", "cuda:1"])
    assert isinstance(m, RankMesh) and m.backend == "nccl"
    assert m.narrowed(1).devices == [torch.device("cuda", 0)]
    assert isinstance(as_mesh(["cpu", "cpu"]), ShardMesh)
    assert MESH.spec() == {"devices": ["cpu", "cpu"], "backend": "gloo"}


def test_nccl_ranks_cannot_share_a_card():
    with pytest.raises(ValueError, match="cannot share a card"):
        RankMesh(["cuda:0", "cuda:0"], "nccl")
    with pytest.raises(ValueError, match="cannot share a card"):
        RankMesh(["cuda", "cuda:0"], "nccl")
    with pytest.raises(ValueError, match="NCCL ranks run on cards"):
        RankMesh(["cpu", "cpu"], "nccl")


def test_rank_mesh_engine_runs_only_in_its_ranks():
    """Outside a process group a RankMesh builds no engine."""
    with pytest.raises(RuntimeError, match="run_sharded"):
        ShardedTensorSearch(_twin("pingpong"), MESH, **CAPS["pingpong"])


# ------------------------------------------------- the batch launch

@pytest.mark.parametrize("op", OPS)
def test_exchange_op_equals_local_slice(batch, op):
    """Each rank's result of each operation is LocalExchange's for its
    shard: the all-to-alls' slice, the reductions' replicated value, the
    gathers' whole."""
    want = HC.exchange_ops(ShardMesh(2, "cpu").exchange(), seed=7)[op]
    got = [r["value"][op] for r in batch["job"]("ops")]
    if op.startswith("all_to_all"):
        if op == "all_to_all_many":
            want = [[w[r] for w in want] for r in range(2)]
            assert got == [[[x] for x in g] for g in want]
        else:
            assert got == [[want[r]] for r in range(2)]
    elif op == "agree":
        assert got == [[True, False]] * 2
    else:
        assert got == [want] * 2


@pytest.mark.parametrize("name", list(CASES))
def test_twins_equal_local_exchange_and_jax(batch, jax_runs, name):
    """Verdict and counts equal LocalExchange at D = 2 and the JAX engine
    at make_mesh(2); every level's per-shard frontier and explored lanes
    equal the JAX engine's; the last dump (rank 0's gather) holds the JAX
    dump's frontier rows and visited keys in shard order."""
    out = batch["outcome"](name)
    jo, jpath = jax_runs[name]
    local = _local(name, max_depth=DEPTH).run()
    assert _key(out) == _key(local) == _key(jo)
    assert out.dropped == jo.dropped == 0
    for lane in ("frontier", "explored"):
        assert [lv["per_device"][lane] for lv in out.levels] == \
            [lv["per_device"][lane] for lv in jo.levels]
    assert all(lv["exchange"]["calls"] > 0 for lv in out.levels)
    a, b = np.load(jpath), np.load(str(tck_path(jpath, name)))
    assert int(a["depth"]) == int(b["depth"]) == DEPTH - 1
    for k in ("frontier", "visited_keys", "explored"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(b["frontier"]) > 0


def tck_path(jpath, name):
    return os.path.join(os.path.dirname(jpath), f"r_{name}.npz")


def test_violation_trace_replays_on_object_twin(batch):
    """A violating lab 0 twin over ranks: LocalExchange's depth and trace,
    and the trace replays on the object twin to a violating state."""
    from dslabs_tpu_torch.tpu.trace import reconstruct_object_trace

    out = batch["outcome"]("violation")
    s = ShardedTensorSearch(HC.lab0_violation_protocol(),
                            make_mesh(2, device="cpu"), chunk_per_device=16,
                            frontier_cap=1 << 9, visited_cap=1 << 12,
                            record_trace=True)
    ref = s.run()
    assert out.end_condition == ref.end_condition == "INVARIANT_VIOLATED"
    assert out.depth == ref.depth and out.trace == ref.trace
    assert len(out.trace) == out.depth
    pkg = HC.Pkg("dslabs_tpu_torch")
    end = reconstruct_object_trace(s, out, HC.lab0_violation(pkg).state,
                                   predicate=pkg.NONE_DECIDED)
    assert not pkg.NONE_DECIDED.check(end).value


def test_steal_on_and_off_equal_counts(batch):
    """The boundary steal moves frontier rows between ranks (two-row
    chunks, so that whole chunks move) and changes no count: lab 1's
    whole space with the steal, without it, and on LocalExchange."""
    steal, plain = batch["outcome"]("steal"), batch["outcome"]("no_steal")
    assert _key(steal) == _key(plain) == _key(
        _local("lab1", chunk_per_device=2, steal_threshold=1.05).run())
    assert steal.dropped == plain.dropped == 0
    moved = [lv.get("steal", {}).get("moved", 0) for lv in steal.levels]
    assert sum(moved) > 0


def test_legacy_driver_matches(batch):
    out = batch["outcome"]("legacy")
    assert _key(out) == _key(_local("pingpong", superstep=False).run()) \
        == PINGPONG


def test_rank_dump_resumes_in_jax_and_on_local_exchange(batch, tmp):
    """A dump written by the two ranks (cut at depth 2) resumes in the JAX
    engine at make_mesh(2) and on LocalExchange at widths 1 and 4, to
    the uncut run's counts."""
    pytest.importorskip("jax")
    from dslabs_tpu.tpu import sharded as jsh

    assert batch["outcome"]("cut").end_condition == "DEPTH_EXHAUSTED"
    path = str(tmp / "r_cut.npz")
    assert tck.peek_depth(path) == 2
    jo = jsh.ShardedTensorSearch(_twin("pingpong", "dslabs_tpu"),
                                 jsh.make_mesh(2), checkpoint_path=path,
                                 **CAPS["pingpong"]).run(resume=True)
    assert _key(jo) == PINGPONG
    for d in (1, 4):
        out = _local("pingpong", d, checkpoint_path=path).run(resume=True)
        assert _key(out) == PINGPONG and out.resumed_from_depth == 2


def test_jax_dump_resumes_in_ranks(batch):
    """The JAX engine's depth-4 pingpong dump resumes in the two ranks to
    the whole space's counts."""
    out = batch["outcome"]("jax_resume")
    assert _key(out) == PINGPONG and out.resumed_from_depth == DEPTH - 1


def test_rank_records(batch):
    """One record per rank: its device, its collectives and their bytes;
    on the CPU the kernels' plain versions run, so no launch counts."""
    out = batch["outcome"]("pingpong")
    assert [r["rank"] for r in out.ranks] == [0, 1]
    assert all(r["exchange_calls"] > 0 and r["exchange_bytes"] > 0
               for r in out.ranks)
    assert all(r["launches"] == {"fingerprint_rows": 0, "insert": 0}
               for r in out.ranks)
    assert batch["secs"] < DEADLINE


def test_spill_tier_over_ranks(batch, tmp):
    """Strict spill mode over two ranks (each rank's host tier holding
    the whole tier, fed by gathered drains and evictions): the uncapped
    run's counts and LocalExchange's spill counters exactly; its
    spill-mode dump resumes at width 4 without spill."""
    out = batch["outcome"]("spill")
    local = _local("lab1", **SPILL_KW).run()
    base = _local("lab1", chunk_per_device=1).run()
    assert _key(out) == _key(local) == _key(base)
    assert out.dropped == 0 and out.spilled_keys > 0
    assert (out.spilled_keys, out.host_tier_hits, out.respilled_frontier) \
        == (local.spilled_keys, local.host_tier_hits,
            local.respilled_frontier)
    assert batch["outcome"]("spill_cut").end_condition == "DEPTH_EXHAUSTED"
    res = _local("lab1", 4, chunk_per_device=1,
                 checkpoint_path=str(tmp / "r_spill.npz")).run(resume=True)
    assert _key(res) == _key(base) and res.resumed_from_depth == 5


@pytest.mark.parametrize("job", ["swarm", "swarm_seeded"])
def test_swarm_one_group_per_rank(batch, tmp, job):
    """The swarm over ranks, one walker group per rank with its own
    generator, from the root and from a BFS frontier seed: the violation
    the LocalExchange swarm finds at D = 2, with a witness minimized and
    replay-verified on rank 0 that replays to a violating state here."""
    from dslabs_tpu_torch.tpu import swarm as tsw
    from dslabs_tpu_torch.tpu.protocols.pingpong import \
        make_pingpong_protocol

    out = batch["outcome"](job)
    proto = HC.violating(make_pingpong_protocol(3))
    kw = dict(SWARM_KW)
    if job == "swarm_seeded":
        kw["frontier_seed"] = str(tmp / "bfs_seed.npz")
    local = tsw.SwarmSearch(proto, mesh=2, device="cpu", **kw)
    ref = local.run()
    assert out.end_condition == ref.end_condition == "INVARIANT_VIOLATED"
    w = out.witness
    assert w.replay_verified and w.minimized and len(w.trace) > 0
    assert out.swarm["walkers"] == 2 * SWARM_KW["walkers_per_device"]
    if job == "swarm":
        # From the root, the witness replays here to a violating state.
        root = tsw.flatten_state(local.initial_state())[0].cpu().numpy()
        row, n = tsw.replay_events(local, root, w.trace)
        assert n == len(w.trace)
        assert tsw._verdict_check(local, out.end_condition,
                                  out.predicate_name, 0)(row)


def test_swarm_round_dump_over_ranks(batch, tmp):
    """A rank swarm cut after round 1 (rank 0's dump holds every group's
    arrays and every rank's generator state) resumes in the ranks as the
    uncut run's identical continuation, and in one process at two groups
    to the same verdict."""
    from dslabs_tpu_torch.tpu import swarm as tsw
    from dslabs_tpu_torch.tpu.protocols.pingpong import \
        make_pingpong_protocol

    full, cut = batch["outcome"]("swarm"), batch["outcome"]("swarm_cut")
    res = batch["outcome"]("swarm_resume")
    assert cut.end_condition == "TIME_EXHAUSTED" and cut.swarm["rounds"] == 1
    assert res.resumed_from_depth == 1
    counts = [k for k in full.swarm
              if k not in ("walkers_per_sec", "unique_per_min")]
    assert _key(res) == _key(full)
    assert [res.swarm[k] for k in counts] == [full.swarm[k] for k in counts]
    assert res.witness.trace == full.witness.trace
    ck = np.load(str(tmp / "r_swarm.npz"))
    assert ck["extra__gen_states"].shape[0] == 2
    one = tsw.SwarmSearch(HC.violating(make_pingpong_protocol(3)), mesh=2,
                          device="cpu",
                          checkpoint_path=str(tmp / "r_swarm.npz"),
                          **SWARM_KW).run(resume=True)
    assert one.end_condition == full.end_condition
    assert one.resumed_from_depth == 1 and one.witness.replay_verified


# ---------------------------------------------------- the dead rank

def test_dead_rank_is_fatal_within_the_deadline(supervised):
    """Rank 1's fatal error kills the group: the rung fails ``fatal``,
    naming rank 1, well inside the launch's deadline, and no rank process
    outlives the launch."""
    sup, out, secs, alive = supervised
    assert [f.kind for f in sup.failures] == ["fatal"]
    assert "rank 1 of 2" in str(sup.failures[0])
    assert "injected rank fault" in str(sup.failures[0])
    assert secs < DEADLINE
    assert alive == []


def test_elastic_supervisor_reaches_the_pins(supervised):
    """The next rung resumes the ranks' last unified dump and lands the
    pins."""
    sup, out, secs, alive = supervised
    assert _key(out) == PINGPONG
    assert (out.engine, out.failovers) == ("device", 1)
    assert 0 < out.resumed_from_depth <= 3
