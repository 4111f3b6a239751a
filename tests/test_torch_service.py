"""PyTorch port, the checking service (``dslabs_tpu_torch/service/``), on
the CPU: the cases of ``tests/test_service.py``.

The queue, the scheduler, the degrade table and the fairness index are
held against the JAX package's on the same inputs (one journal read by
both replays, one job list picked by both schedulers).  Servers run with
``device="cpu"`` and the memo off (the port has no memo yet:
``memo=True`` raises); their warden children rebuild the port's
protocols with ``OMP_NUM_THREADS=1``.  Verdicts are held against the JAX
package's, its server's drain included (``CheckServer(memo=False)``).
The admission child runs the port's conformance linter off the card."""

import json
import os
import signal
import textwrap
import time

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)

from dslabs_tpu import service as jsvc  # noqa: E402
from dslabs_tpu.tpu import supervisor as jsup  # noqa: E402
from dslabs_tpu_torch.service import (AttemptPlan, CheckServer,  # noqa: E402
                                      DeficitRoundRobin, Job, RetrySpec,
                                      ServiceQueue, degrade, fairness_index,
                                      replay_journal)
from dslabs_tpu_torch.tpu.supervisor import (CHILD_RC_FAILED,  # noqa: E402
                                             _OOM_MARKERS,
                                             classify_child_death,
                                             classify_oom)
from dslabs_tpu_torch.tpu.warden import classify_death  # noqa: E402

pytestmark = pytest.mark.service

CHILD_ENV = {"OMP_NUM_THREADS": "1"}
FACTORY = ("dslabs_tpu_torch.tpu.protocols.pingpong:"
           "make_exhaustive_pingpong")
SMALL = dict(factory_kwargs={"workload_size": 2}, chunk=64,
             frontier_cap=1 << 8, visited_cap=1 << 12)
# An injected hang is cut at steady_grace + slack, about 4 s.
GRACES = {"boot_grace": 120.0, "first_grace": 120.0,
          "steady_grace": 3.0, "idle_grace": 60.0, "grace_slack": 1.0}


def _server(root, **kw):
    kw.setdefault("admission", False)
    kw.setdefault("elastic", False)
    kw.setdefault("env", CHILD_ENV)
    kw.setdefault("warden_kwargs", dict(GRACES))
    kw.setdefault("device", "cpu")
    return CheckServer(str(root), **kw)


def _same_verdict(a: dict, b: dict):
    for key in ("end", "unique", "explored", "depth"):
        assert a[key] == b[key], (key, a, b)


@pytest.fixture(scope="module")
def jax_verdict():
    """The exhaustive pingpong's verdict in the JAX package."""
    from dslabs_tpu.tpu.engine import TensorSearch
    from dslabs_tpu.tpu.protocols.pingpong import make_exhaustive_pingpong

    o = TensorSearch(make_exhaustive_pingpong(workload_size=2),
                     strict=True, chunk=64, frontier_cap=1 << 8,
                     visited_cap=1 << 12).run()
    return {"end": o.end_condition, "unique": o.unique_states,
            "explored": o.states_explored, "depth": o.depth}


# ------------------------------------------------ the death taxonomy

TAXONOMY = [
    (-signal.SIGKILL, True, (), "wedge"),
    (-signal.SIGKILL, False, (), "oom"),
    (-signal.SIGSEGV, False, (), "crash"),
    (-signal.SIGTERM, False, (), "crash"),
    (CHILD_RC_FAILED, False, (), "failed"),
    (1, False, (), "crash"),
    (86, False, (), "crash"),
    (None, False, (), "crash"),
    (1, False, ("Traceback ...", "MemoryError",), "oom"),
    (-signal.SIGSEGV, False, ("RESOURCE_EXHAUSTED: out of memory",),
     "oom"),
    (86, False, ("torch.OutOfMemoryError: CUDA out of memory",), "oom"),
    (-signal.SIGKILL, True, ("MemoryError",), "wedge"),
    (CHILD_RC_FAILED, False, ("MemoryError",), "failed"),
]


def test_unified_death_taxonomy_table():
    for exitcode, killed, stderr, want in TAXONOMY:
        got = classify_child_death(exitcode, killed, stderr)
        assert got == want, (exitcode, killed, stderr, got, want)
        assert classify_death(exitcode, killed, stderr) == want
        if exitcode != CHILD_RC_FAILED and "torch" not in "".join(stderr):
            assert jsup.classify_child_death(exitcode, killed,
                                             stderr) == want


def test_taxonomy_agrees_with_classify_oom():
    for marker in _OOM_MARKERS:
        assert classify_oom(RuntimeError(f"CUDA error: {marker}"))
        assert classify_child_death(1, False, (marker,)) == "oom"
        assert classify_child_death(-signal.SIGSEGV, False,
                                    (marker,)) == "oom"


# ------------------------------------------------- queue + journal

def test_queue_full_returns_structured_rejection(tmp_path):
    q = ServiceQueue(str(tmp_path), cap=2)
    a = q.submit(Job(job_id=q.next_id("a"), tenant="a", factory="m:f"))
    b = q.submit(Job(job_id=q.next_id("a"), tenant="a", factory="m:f"))
    assert a["accepted"] and b["accepted"]
    t0 = time.time()
    r = q.submit(Job(job_id=q.next_id("b"), tenant="b", factory="m:f"))
    assert time.time() - t0 < 1.0
    assert r == {"accepted": False, "rejected": True,
                 "reason": "queue_full",
                 "retry_after_secs": r["retry_after_secs"],
                 "queue_depth": 2, "queue_cap": 2}
    assert r["retry_after_secs"] == 4.0
    assert q.summary()["backpressure"] is True
    q.close()


def test_journal_replay_tolerates_torn_tail(tmp_path):
    q = ServiceQueue(str(tmp_path), cap=8)
    for _ in range(3):
        q.submit(Job(job_id=q.next_id("t"), tenant="t", factory="m:f"))
    q.mark_started("t-000001", attempt=1)
    q.mark_done("t-000001", {"end": "SPACE_EXHAUSTED", "unique": 8})
    q.mark_started("t-000002", attempt=1)
    q.close()
    with open(q.journal_path, "a") as f:
        f.write('{"t": "done", "job_id": "t-0000')
    pending, records, seq = replay_journal(q.journal_path)
    assert seq == 3
    assert records["t-000001"]["status"] == "done"
    assert sorted(j.job_id for j in pending) == ["t-000002", "t-000003"]
    # The journal is the reference's format: its replay reads the same.
    jpend, jrecs, jseq = jsvc.replay_journal(q.journal_path)
    assert jseq == seq and jrecs == records
    assert [j.as_dict() for j in jpend] == [j.as_dict() for j in pending]
    q2 = ServiceQueue(str(tmp_path), cap=8)
    assert q2.depth() == 2
    q2.close()


def test_journal_compaction_is_atomic(tmp_path):
    q = ServiceQueue(str(tmp_path), cap=8)
    for _ in range(2):
        q.submit(Job(job_id=q.next_id("t"), tenant="t", factory="m:f"))
    q.mark_done("t-000001", {"end": "SPACE_EXHAUSTED"})
    q.compact()
    assert not os.path.exists(q.journal_path + ".tmp")
    pending, records, seq = replay_journal(q.journal_path)
    assert records["t-000001"]["status"] == "done"
    assert [j.job_id for j in pending] == ["t-000002"]
    q.submit(Job(job_id=q.next_id("t"), tenant="t", factory="m:f"))
    assert seq == 2 and q.depth() == 2
    q.close()


# --------------------------------------------- scheduler + fairness

def _picks(sched_cls, job_cls, jobs, quota, running=None):
    s = sched_cls(quota=quota)
    for kw in jobs:
        s.push(job_cls(factory="m:f", **kw))
    order = []
    while True:
        j = s.pick(running or {})
        if j is None:
            return order
        order.append(j.job_id)


def test_drr_interleaves_tenants_and_honors_quota():
    jobs = ([dict(job_id=f"a-{i}", tenant="a") for i in range(4)]
            + [dict(job_id=f"b-{i}", tenant="b") for i in range(2)])
    order = _picks(DeficitRoundRobin, Job, jobs, 1)
    assert order == ["a-0", "b-0", "a-1", "b-1", "a-2", "a-3"]
    assert order == _picks(jsvc.DeficitRoundRobin, jsvc.Job, jobs, 1)
    s2 = DeficitRoundRobin(quota=1)
    s2.push(Job(job_id="a-0", tenant="a", factory="m:f"))
    assert s2.pick({"a": 1}) is None
    assert s2.pick({"a": 0}).job_id == "a-0"


def test_drr_budget_weighting():
    jobs = ([dict(job_id="big-0", tenant="big", budget_units=4.0)]
            + [dict(job_id=f"small-{i}", tenant="small")
               for i in range(4)])
    order = _picks(DeficitRoundRobin, Job, jobs, 4)
    assert order.index("big-0") >= 2
    assert sorted(order) == ["big-0", "small-0", "small-1", "small-2",
                             "small-3"]
    assert order == _picks(jsvc.DeficitRoundRobin, jsvc.Job, jobs, 4)


def test_degrade_policy_table():
    retry = RetrySpec(max_attempts=3)
    jretry = jsvc.RetrySpec(max_attempts=3)
    p = AttemptPlan(attempt=1, chunk=64, ladder=("device", "host"))
    nxt = degrade(p, "oom", retry)
    assert (nxt.chunk, nxt.knob_shrinks, nxt.ladder) == (
        32, 1, ("device", "host"))
    nxt = degrade(p, "wedge", retry)
    assert (nxt.ladder, nxt.rung_steps) == (("host",), 1)
    assert degrade(AttemptPlan(1, 64, ("host",)), "wedge",
                   retry).ladder == ("host",)
    assert degrade(p, "crash", retry).chunk == 64
    assert degrade(p, "failed", retry) is None
    assert degrade(AttemptPlan(3, 64, ("device",)), "oom", retry) is None
    for plan in (p, AttemptPlan(2, 64, ("host",)),
                 AttemptPlan(3, 64, ("device",))):
        jplan = jsvc.AttemptPlan(plan.attempt, plan.chunk, plan.ladder)
        for kind in ("oom", "wedge", "crash", "failed"):
            a, b = degrade(plan, kind, retry), jsvc.degrade(jplan, kind,
                                                             jretry)
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.attempt, a.chunk, a.ladder, a.knob_shrinks,
                        a.rung_steps) == (b.attempt, b.chunk, b.ladder,
                                          b.knob_shrinks, b.rung_steps)
                assert a.span_id("j-1") == b.span_id("j-1")


def test_fairness_index_pinned():
    cases = [{}, {"a": {"verdicts": 4, "budget_spent": 4.0},
                  "b": {"verdicts": 2, "budget_spent": 2.0}},
             {"a": {"verdicts": 4, "budget_spent": 2.0},
              "b": {"verdicts": 1, "budget_spent": 2.0}}]
    assert [fairness_index(c) for c in cases] == [1.0, 1.0, 1.6]
    assert [jsvc.fairness_index(c) for c in cases] == [1.0, 1.0, 1.6]


# ------------------------------------------------- admission gate

UNSOUND_MODULE = textwrap.dedent("""
    import random


    class EvilNode:
        def __init__(self, address):
            self.peers = []

        def handle_Req(self, message, sender):
            message["seq"] = random.randint(0, 3)   # C1 + C2
            self.send(message, sender)


    def make_evil_protocol():
        return EvilNode("n1")
""")


def test_admission_rejects_unsound_spec_before_any_twin(tmp_path):
    (tmp_path / "evil_user_proto.py").write_text(UNSOUND_MODULE)
    srv = _server(tmp_path / "svc", admission=True,
                  extra_sys_path=[str(tmp_path)])
    res = srv.submit("evil_user_proto:make_evil_protocol",
                     tenant="mallory")
    assert res["accepted"] is False and res["reason"] == "unsound_spec"
    codes = {f["code"] for f in res["findings"]}
    assert codes & {"C1", "C2"}, res["findings"]
    for f in res["findings"]:
        assert {"code", "path", "obj", "line", "message"} <= set(f)
    assert not os.path.exists(os.path.join(str(tmp_path / "svc"), "jobs"))
    assert srv.queue.depth() == 0
    assert srv.server_status()["tenants"]["mallory"]["rejected"] == 1
    # A sound factory of the port passes the same gate.
    ok = srv.submit(FACTORY, tenant="alice", **SMALL)
    assert ok["accepted"], ok
    journal = [json.loads(x) for x in open(srv.queue.journal_path)]
    adm = [r for r in journal if r.get("t") == "admission"]
    assert [r["findings"] > 0 for r in adm] == [True, False]
    srv.close()


def test_memo_waits_for_its_slice(tmp_path):
    for kw in ({"memo": True}, {"memo_path": str(tmp_path / "m")}):
        with pytest.raises(NotImplementedError, match="memo slice"):
            CheckServer(str(tmp_path / "svc"), device="cpu", **kw)


# ------------------------------------- scheduler-level degradation

def test_oom_death_costs_a_knob_shrink_relevel(tmp_path, jax_verdict):
    """A job whose only rung dies OOM-shaped is retried with halved chunk
    knobs, resumed from its own dump, and lands the exact verdict."""
    srv = _server(tmp_path / "svc", workers=1)
    srv.submit(FACTORY, tenant="alice", ladder=("device",),
               fault={"kind": "die", "at": 8, "after_ckpt": True}, **SMALL)
    out = srv.drain()["results"][0]
    srv.close()
    assert out["status"] == "done"
    _same_verdict(out, jax_verdict)
    assert out["attempts"] == 2
    assert out["knob_shrinks"] == 1
    assert [d["kind"] for d in out["deaths"]] == ["oom"]
    assert out["degraded"] is True
    assert out["resumed_from_depth"] > 0
    assert out["platform"] == "cpu"


# --------------------------- ACCEPTANCE: the tenant-isolation soak

def test_tenant_isolation_chaos_soak(tmp_path, jax_verdict):
    """Three tenants, a fault schedule killing one tenant's jobs (oom,
    hang, crash) and a deterministic in-child failure: neighbours'
    verdicts equal their solo baselines, the victim degraded but sound or
    a structured failure, a full-queue submission rejected with the
    retry-after shape, and no cross-tenant telemetry bleed."""

    def run_solo(tenant):
        srv = _server(tmp_path / f"solo-{tenant}", workers=1)
        assert srv.submit(FACTORY, tenant=tenant, **SMALL)["accepted"]
        summary = srv.drain()
        srv.close()
        assert summary["completed"] == 1
        return summary["results"][0]

    base_b = run_solo("bob")
    base_c = run_solo("carol")
    _same_verdict(base_b, base_c)
    _same_verdict(base_b, jax_verdict)

    srv = _server(tmp_path / "svc", workers=2, queue_cap=6)
    faults = {
        "oom": {"kind": "die", "at": 8, "after_ckpt": True},
        "hang": {"kind": "hang", "at": 8},
        "crash": {"kind": "exit", "at": 5},
    }
    alice_jobs = {}
    for kind, fault in faults.items():
        res = srv.submit(FACTORY, tenant="alice", fault=fault, **SMALL)
        assert res["accepted"], res
        alice_jobs[res["job_id"]] = kind
    res = srv.submit(FACTORY, tenant="alice", ladder=("device",),
                     fault={"kind": "raise", "at": 3}, **SMALL)
    assert res["accepted"]
    raise_job = res["job_id"]
    assert srv.submit(FACTORY, tenant="bob", **SMALL)["accepted"]
    assert srv.submit(FACTORY, tenant="carol", **SMALL)["accepted"]
    over = srv.submit(FACTORY, tenant="dave", **SMALL)
    assert over["accepted"] is False
    assert over["reason"] == "queue_full"
    assert over["retry_after_secs"] > 0
    assert over["queue_depth"] == 6 and over["queue_cap"] == 6

    summary = srv.drain()
    srv.close()
    results = {r["job_id"]: r for r in summary["results"]}
    assert len(results) == 6

    for tenant, base in (("bob", base_b), ("carol", base_c)):
        (job,) = [r for r in results.values() if r["tenant"] == tenant]
        assert job["status"] == "done"
        _same_verdict(job, base)
        assert job["degraded"] is False and not job["deaths"]

    want_kind = {"oom": "oom", "hang": "wedge", "crash": "crash"}
    for job_id, kind in alice_jobs.items():
        r = results[job_id]
        assert r["status"] == "done", r
        _same_verdict(r, base_b)
        assert r["degraded"] is True
        assert [d["kind"] for d in r["deaths"]] == [want_kind[kind]], r
    r = results[raise_job]
    assert r["status"] == "failed" and r["kind"] == "failed"
    assert r["attempts"] == 1 and r["deaths"]

    run_dirs = {r["run_dir"] for r in results.values()}
    assert len(run_dirs) == 6
    for r in results.values():
        listing = os.listdir(r["run_dir"])
        assert "flight.jsonl" in listing and "STATUS.json" in listing
        blob = ""
        for name in ("flight.jsonl", "STATUS.json"):
            with open(os.path.join(r["run_dir"], name)) as f:
                blob += f.read()
        for other in results.values():
            if other["job_id"] != r["job_id"]:
                assert other["job_id"] not in blob

    with open(os.path.join(str(tmp_path / "svc"),
                           "SERVER_STATUS.json")) as f:
        status = json.load(f)
    assert status["queue_depth"] == 0 and status["backpressure"] is False
    t = status["tenants"]
    assert t["alice"]["completed"] == 3 and t["alice"]["failed"] == 1
    assert t["bob"]["completed"] == 1 and t["carol"]["completed"] == 1
    assert t["dave"]["rejected"] == 1
    assert summary["fairness_index"] >= 1.0


# ------------------------------------------ the JAX server's verdicts

def test_lane_drain_equals_jax_server(tmp_path):
    """A batched drain of the port's service gives the JAX server's
    verdicts (memo off, four lanes), and its service root assembles."""
    from dslabs_tpu_torch.tpu import tracing

    def submit(srv, factory):
        for t in ("alice", "bob"):
            for _ in range(2):
                r = srv.submit(factory, tenant=t, max_secs=60.0, **SMALL)
                assert r["accepted"], r

    srv = _server(tmp_path / "port", workers=1, quota=2, lanes=4)
    submit(srv, FACTORY)
    port = srv.drain(max_secs=300)
    srv.close()
    # The JAX batch child on one CPU thread, beside the suite's workers.
    jsrv = jsvc.CheckServer(
        str(tmp_path / "jax"), workers=1, quota=2, lanes=4, memo=False,
        admission=False, elastic=False,
        env={"DSLABS_COMPILE_CACHE": "/tmp/jaxcache-cpu",
             "OMP_NUM_THREADS": "1",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=8 "
                          "--xla_cpu_multi_thread_eigen=false "
                          "intra_op_parallelism_threads=1"})
    submit(jsrv, "dslabs_tpu.tpu.protocols.pingpong:"
                 "make_exhaustive_pingpong")
    ref = jsrv.drain(max_secs=300)
    jsrv.close()
    key = ("tenant", "end", "unique", "explored", "depth", "engine")
    assert sorted(tuple(r[k] for k in key) for r in port["results"]) == \
        sorted(tuple(r[k] for k in key) for r in ref["results"])
    assert port["lanes"]["jobs_in_lanes"] == ref["lanes"]["jobs_in_lanes"]
    assert port["dispatches_per_job"] == ref["dispatches_per_job"] == 4.0
    tr = tracing.assemble(str(tmp_path / "port"))
    assert tr["mode"] == "service" and len(tr["jobs"]) == 4
    for j in tr["jobs"]:
        assert j["status"] == "done" and j["verdict"]["end"]
        assert {"submit", "queue", "admission", "attempt",
                "lane_batch"} <= {n["kind"] for n in j["nodes"]}
    rendered = tracing.render_trace(tr)
    assert "lane batch" in rendered and "per-tenant cost ledger" in rendered


# ----------------------------------------------------------- CLI

def test_service_cli_submit_and_status(tmp_path, capsys):
    from dslabs_tpu_torch.service.__main__ import main

    root = str(tmp_path / "svc")
    rc = main(["submit", "--root", root, "--tenant", "alice",
               "--factory", FACTORY,
               "--kwargs", json.dumps({"workload_size": 2}),
               "--chunk", "64", "--no-admission"])
    sub = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and sub["accepted"] and sub["trace_id"]
    rc = main(["status", "--root", root])
    st = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and st["queue"]["queue_depth"] == 1
    assert st["server"]["lanes"]["width"] == 0


@pytest.mark.slow
def test_service_cli_submit_status_drain(tmp_path, capsys):
    from dslabs_tpu_torch.service.__main__ import main

    root = str(tmp_path / "svc")
    rc = main(["submit", "--root", root, "--tenant", "alice",
               "--factory", FACTORY,
               "--kwargs", json.dumps({"workload_size": 2}),
               "--chunk", "64", "--no-admission"])
    sub = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and sub["accepted"]
    rc = main(["status", "--root", root])
    st = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and st["queue"]["queue_depth"] == 1
    rc = main(["drain", "--root", root, "--no-admission", "--workers", "1",
               "--device", "cpu"])
    dr = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and dr["completed"] == 1 and dr["failed"] == 0
    assert dr["results"][0]["tenant"] == "alice"
    rc = main(["status", "--root", root])
    st = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert st["server"]["tenants"]["alice"]["completed"] == 1
