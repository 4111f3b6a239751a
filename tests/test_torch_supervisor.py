"""PyTorch port, the search supervisor (``dslabs_tpu_torch/tpu/
supervisor.py``), against the JAX package's on the CPU.

Each single-device case of ``tests/test_supervisor.py`` runs on the port
with ``ladder=("device", "host")`` (the reference's cases start on the
``sharded`` rung; this file pins the single-device indices, and the
sharded rung's cases are in tests/test_torch_elastic.py) and on the JAX
supervisor with the same ladder, protocol, policy and an equivalent plan: end
condition, unique and explored counts, the rung that answered, failovers
and, where a case pins them, retries and the resumed depth are held
equal.  A plan's dispatch indices are each package's own (the JAX device
loop dispatches its promote before its stats sync, the port after);
every index below lands on a warm site in both.  The reference's three
superstep cases exist only on the sharded rung.

The port's own cases: the failure classification table (the reference's
cases, torch's ``OutOfMemoryError``, a name-matched ``AcceleratorError``
and the sticky CUDA errors), the knob-shrink re-level on an injected
``torch.cuda.OutOfMemoryError`` against the JAX re-level on an injected
``MemoryError("RESOURCE_EXHAUSTED ...")``, the options that raise naming
their slice, and portfolio mode on the two tier-1 cases of
``tests/test_swarm.py`` (the swarm's walks differ from the JAX walks by
design, so verdicts compare, not walks).

One JAX supervisor per protocol serves the fault-free and faulted JAX
runs: its engines are cached, so their programs compile once."""

import dataclasses
import os
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)

from dslabs_tpu.tpu import engine as jeng  # noqa: E402
from dslabs_tpu.tpu import supervisor as jsup  # noqa: E402
from dslabs_tpu.tpu.protocols.clientserver import \
    make_clientserver_protocol as j_cs  # noqa: E402
from dslabs_tpu.tpu.protocols.pingpong import \
    make_pingpong_protocol as j_pp  # noqa: E402
from dslabs_tpu_torch.tpu import checkpoint as tck  # noqa: E402
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.tpu import supervisor as tsup  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.clientserver import \
    make_clientserver_protocol as t_cs  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.pingpong import \
    make_pingpong_protocol as t_pp  # noqa: E402
from tests.torch_harness_cases import make_lock_protocol  # noqa: E402

pytestmark = pytest.mark.fault

PP_KW = dict(chunk=16, frontier_cap=1 << 8, visited_cap=1 << 10)
LAB1_KW = dict(chunk=64, frontier_cap=1 << 9, visited_cap=1 << 12)
FAST = dict(backoff_base=0.001)


class FatalError(RuntimeError):
    """An injected non-transient failure (classified fatal)."""


def _pruned(p):
    return dataclasses.replace(
        p, goals={}, prunes={"CLIENTS_DONE": p.goals["CLIENTS_DONE"]})


def _tsup(proto, **kw):
    kw.setdefault("ladder", ("device", "host"))
    for k, v in PP_KW.items():
        kw.setdefault(k, v)
    return tsup.SearchSupervisor(proto, device="cpu", **kw)


def _jsup(proto, **kw):
    kw.setdefault("ladder", ("device", "host"))
    for k, v in PP_KW.items():
        kw.setdefault(k, v)
    return jsup.SearchSupervisor(proto, **kw)


def _jrun(sup, plan=None, policy=None):
    """A run of a cached JAX supervisor under ``plan`` and ``policy``."""
    sup.fault_plan = plan
    sup.policy = policy or jsup.RetryPolicy()
    return sup.run()


def _key(o):
    return (o.end_condition, o.unique_states, o.states_explored)


def _recovery(o):
    return (o.engine, o.failovers, o.retries)


@pytest.fixture(scope="module")
def jpp():
    """The JAX supervisor over the pruned pingpong twin, and its
    fault-free outcome."""
    sup = _jsup(_pruned(j_pp(2)))
    base = sup.run()
    assert base.end_condition == "SPACE_EXHAUSTED"
    return sup, base


@pytest.fixture(scope="module")
def tpp_base():
    return _tsup(_pruned(t_pp(2))).run()


# ------------------------------------------------------- classification

class XlaRuntimeError(RuntimeError):
    pass


class AcceleratorError(RuntimeError):
    """Named like ``torch.AcceleratorError``, which only newer torch has:
    the classifier matches runtime errors by type name."""


# name -> (exception builder (package -> exception), classify_failure,
# classify_oom, sticky, whether the JAX classifier takes the case).
CLASSIFY = {
    "transient_injected": (lambda m: m.TransientDeviceError("x"),
                           "transient", False, False, True),
    "timeout": (lambda m: m.DispatchTimeout("x"), "wedged", False, False,
                True),
    "fatal": (lambda m: FatalError("x"), "fatal", False, False, True),
    "xla_resource_exhausted": (
        lambda m: XlaRuntimeError("RESOURCE_EXHAUSTED: hbm oom"),
        "transient", True, False, True),
    "xla_invalid_argument": (lambda m: XlaRuntimeError("INVALID_ARGUMENT"),
                             "fatal", False, False, True),
    "memory_error_resource_exhausted": (
        lambda m: MemoryError("RESOURCE_EXHAUSTED: out of memory"),
        "transient", True, False, True),
    "cuda_oom": (lambda m: torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"),
        "fatal", True, False, False),
    "accelerator_unavailable": (lambda m: AcceleratorError(
        "CUDA error: CUDA-capable device(s) is/are busy or unavailable"),
        "transient", False, False, False),
    "accelerator_illegal_access": (lambda m: AcceleratorError(
        "CUDA error: an illegal memory access was encountered"),
        "fatal", False, True, False),
    "sticky_beats_transient_marker": (lambda m: AcceleratorError(
        "UNAVAILABLE: unspecified launch failure"), "fatal", False, True,
        False),
    "device_side_assert": (lambda m: RuntimeError(
        "CUDA error: device-side assert triggered"), "fatal", False, True,
        False),
    "plain_runtime_error": (lambda m: RuntimeError("UNAVAILABLE"),
                            "fatal", False, False, True),
}


@pytest.mark.parametrize("name", sorted(CLASSIFY))
def test_failure_classification(name):
    """The reference's pinned cases classify as the JAX supervisor does;
    torch's OOM is OOM-shaped and fatal (re-levelled, never retried at
    the same size), a name-matched AcceleratorError with a transient
    status retries, and sticky CUDA errors are fatal whatever else the
    message says."""
    build, failure, oom, sticky, in_jax = CLASSIFY[name]
    exc = build(tsup)
    assert tsup.classify_failure(exc) == failure
    assert tsup.classify_oom(exc) is oom
    assert tsup.is_sticky(exc) is sticky
    if in_jax:
        jexc = build(jsup)
        assert jsup.classify_failure(jexc) == failure
        assert jsup.classify_oom(jexc) is oom
    assert tsup.classify_oom(None) is False


# ------------------------------------------------------ retry-in-place

def test_transient_retry_within_budget_identical_outcome(jpp, tpp_base):
    """Two injected transients, budget three: the run recovers in place
    on the device rung with both counts and retries equal to the JAX
    run's."""
    jsup_, jbase = jpp
    assert _key(tpp_base) == _key(jbase)
    pol = dict(max_retries=3, **FAST)
    out = _tsup(_pruned(t_pp(2)),
                fault_plan=tsup.FaultPlan().raise_at(3, count=2),
                policy=tsup.RetryPolicy(**pol)).run()
    ref = _jrun(jsup_, jsup.FaultPlan().raise_at(3, count=2),
                jsup.RetryPolicy(**pol))
    assert _key(out) == _key(ref) == _key(jbase)
    assert _recovery(out) == _recovery(ref) == ("device", 0, 2)


def test_retry_budget_is_per_rung(jpp):
    """Retries spent on a failed rung do not starve the next rung."""
    jsup_, jbase = jpp

    def plan(m):
        return (m.FaultPlan().raise_always(engine="device")
                .raise_at(2, count=1, engine="host"))

    out = _tsup(_pruned(t_pp(2)), fault_plan=plan(tsup),
                policy=tsup.RetryPolicy(max_retries=2, **FAST)).run()
    ref = _jrun(jsup_, plan(jsup), jsup.RetryPolicy(max_retries=2, **FAST))
    assert _key(out) == _key(ref) == _key(jbase)
    assert _recovery(out) == _recovery(ref) == ("host", 1, 3)


# ---------------------------------------------------------- failover

def test_failover_ladder_lab1_strict_verdict_parity():
    """Exhausted retries on the device rung: the host loop (the parity
    oracle) lands the identical verdict on a lab1 strict BFS."""
    def plan(m):
        return m.FaultPlan().raise_always(engine="device")

    out = _tsup(_pruned(t_cs(n_clients=1, w=2)), fault_plan=plan(tsup),
                policy=tsup.RetryPolicy(max_retries=1, **FAST),
                **LAB1_KW).run()
    jsup_ = _jsup(_pruned(j_cs(n_clients=1, w=2)), **LAB1_KW)
    jbase = jsup_.run()
    assert jbase.end_condition == "SPACE_EXHAUSTED"
    ref = _jrun(jsup_, plan(jsup), jsup.RetryPolicy(max_retries=1, **FAST))
    assert _key(out) == _key(ref) == _key(jbase)
    assert _recovery(out) == _recovery(ref) == ("host", 1, 1)


def test_goal_verdict_survives_failover():
    """Failover keeps terminal verdicts too: the pingpong goal is found
    at the same depth on the next rung."""
    base = _tsup(t_pp(2)).run()
    assert base.end_condition == "GOAL_FOUND"

    def plan(m):
        return m.FaultPlan().raise_always(error=FatalError, engine="device")

    out = _tsup(t_pp(2), fault_plan=plan(tsup),
                policy=tsup.RetryPolicy(max_retries=0)).run()
    jsup_ = _jsup(j_pp(2))
    jbase = jsup_.run()
    ref = _jrun(jsup_, plan(jsup), jsup.RetryPolicy(max_retries=0))
    for o in (out, ref, jbase):
        assert (o.end_condition, o.predicate_name, o.depth) == (
            base.end_condition, base.predicate_name, base.depth)
    assert _recovery(out) == _recovery(ref) == ("host", 1, 0)


def test_all_rungs_fail_is_loud_and_attributable(jpp):
    """When every rung fails the supervisor raises SupervisorExhausted
    with the per-rung failure chain."""
    jsup_, _ = jpp
    with pytest.raises(tsup.SupervisorExhausted) as ei:
        _tsup(_pruned(t_pp(2)),
              fault_plan=tsup.FaultPlan().raise_always(error=FatalError),
              policy=tsup.RetryPolicy(max_retries=0)).run()
    with pytest.raises(jsup.SupervisorExhausted) as ej:
        _jrun(jsup_, jsup.FaultPlan().raise_always(error=FatalError),
              jsup.RetryPolicy(max_retries=0))
    for e in (ei.value, ej.value):
        assert [(f.engine, f.kind) for f in e.failures] == [
            ("device", "fatal"), ("host", "fatal")]
    assert all(isinstance(f, tsup.EngineFailure) for f in ei.value.failures)


def test_capacity_overflow_passes_through_unwrapped():
    """Semantic errors are never absorbed by retry or failover: a
    too-small strict visited table raises CapacityOverflow unchanged, in
    both packages."""
    from dslabs_tpu.tpu.visited import BKT

    with pytest.raises(teng.CapacityOverflow):
        _tsup(_pruned(t_cs(n_clients=1, w=2)), chunk=64, visited_cap=BKT,
              policy=tsup.RetryPolicy(max_retries=3)).run()
    with pytest.raises(jeng.CapacityOverflow):
        _jsup(_pruned(j_cs(n_clients=1, w=2)), chunk=64, visited_cap=BKT,
              policy=jsup.RetryPolicy(max_retries=3)).run()


# ---------------------------------------------------------- watchdog

def test_hung_dispatch_detected_and_recovered(jpp):
    """A dispatch that hangs (injected wedge, dispatch 4: the device
    rung's second chunk step in both packages, a warm site) is abandoned
    at its deadline and the search restarts on the next rung."""
    jsup_, jbase = jpp

    def args(m):
        return (m.FaultPlan().hang_at(4, engine="device", secs=60.0),
                m.RetryPolicy(max_retries=1, deadline_secs=1.0,
                              deadline_first_secs=300.0, **FAST))

    plan, pol = args(tsup)
    sup = _tsup(_pruned(t_pp(2)), fault_plan=plan, policy=pol)
    out = sup.run()
    ref = _jrun(jsup_, *args(jsup))
    assert _key(out) == _key(ref) == _key(jbase)
    assert _recovery(out) == _recovery(ref) == ("host", 1, 0)
    assert [f.kind for f in sup.failures] == ["wedged"]
    assert out.abandoned_threads == 0      # the fault thread exited


# ------------------------------------------------- checkpoint + resume

def test_kill_resume_single_device_engine(tmp_path, jpp):
    """A checkpointed device-loop run cut at depth 2 resumes to the
    straight run's verdict and counts (and the JAX run's)."""
    _, jbase = jpp
    proto = _pruned(t_pp(2))
    full = teng.TensorSearch(proto, chunk=64, device="cpu").run()
    ckpt = str(tmp_path / "dev.npz")
    cut = teng.TensorSearch(proto, chunk=64, max_depth=2, device="cpu",
                            checkpoint_path=ckpt, checkpoint_every=1)
    assert cut.run().end_condition == "DEPTH_EXHAUSTED"
    assert os.path.exists(ckpt)
    resumed = teng.TensorSearch(proto, chunk=64, checkpoint_path=ckpt,
                                device="cpu")
    r = resumed.run(resume=True)
    assert _key(r) == _key(full) == _key(jbase)
    assert resumed._resumed_from_depth == 2 == r.resumed_from_depth


def test_kill_resume_crosses_engines(tmp_path, jpp):
    """The dump is engine-agnostic: a device-loop dump resumes on the
    host loop and the reverse."""
    _, jbase = jpp
    proto = _pruned(t_pp(2))
    ckpt = str(tmp_path / "cross.npz")
    teng.TensorSearch(proto, chunk=64, max_depth=2, checkpoint_path=ckpt,
                      checkpoint_every=1, device="cpu").run()
    host = teng.TensorSearch(proto, chunk=64, checkpoint_path=ckpt,
                             use_host_visited=True,
                             device="cpu").run(resume=True)
    assert _key(host) == _key(jbase)
    ckpt2 = str(tmp_path / "cross2.npz")
    teng.TensorSearch(proto, chunk=64, max_depth=2, use_host_visited=True,
                      checkpoint_path=ckpt2, checkpoint_every=1,
                      device="cpu").run()
    dev = teng.TensorSearch(proto, chunk=64, checkpoint_path=ckpt2,
                            device="cpu").run(resume=True)
    assert _key(dev) == _key(jbase)


def test_failover_resumes_from_checkpoint(tmp_path, jpp):
    """A rung killed mid-search (a fatal fault at dispatch 8, in level 3,
    after the depth-2 dump): the next rung resumes from the checkpoint
    and reports the resumed depth."""
    _, jbase = jpp

    def run(m, sup_cls_kw, path):
        sup = sup_cls_kw(
            fault_plan=m.FaultPlan().raise_at(8, error=FatalError,
                                              engine="device"),
            checkpoint_path=path, checkpoint_every=1,
            policy=m.RetryPolicy(max_retries=0))
        return sup.run()

    out = run(tsup, lambda **kw: _tsup(_pruned(t_pp(2)), **kw),
              str(tmp_path / "port.npz"))
    ref = run(jsup, lambda **kw: _jsup(_pruned(j_pp(2)), **kw),
              str(tmp_path / "jax.npz"))
    assert _key(out) == _key(ref) == _key(jbase)
    assert _recovery(out) == _recovery(ref) == ("host", 1, 0)
    # The background writer skips a dump while one is being written, so
    # the resumed depth is the last dump that landed: 1 or 2.
    assert 0 < out.resumed_from_depth <= 2
    assert 0 < ref.resumed_from_depth <= 2


def test_checkpoint_mismatch_rejected_loudly(tmp_path):
    """A dump of another protocol configuration is refused with both
    fingerprints (the reference's strings) in the error, and a dump of
    another strictness too."""
    proto = _pruned(t_pp(2))
    ckpt = str(tmp_path / "mm.npz")
    teng.TensorSearch(proto, chunk=64, max_depth=2, checkpoint_path=ckpt,
                      checkpoint_every=1, device="cpu").run()
    bigger = dataclasses.replace(proto, net_cap=proto.net_cap * 2)
    other = teng.TensorSearch(bigger, chunk=64, checkpoint_path=ckpt,
                              device="cpu")
    assert not other.has_resumable_checkpoint()
    with pytest.raises(tck.CheckpointMismatch) as ei:
        other.run(resume=True)
    msg = str(ei.value)
    assert other._ckpt_fingerprint() in msg
    jproto = _pruned(j_pp(2))
    assert jeng.TensorSearch(jproto, chunk=64)._ckpt_fingerprint() in msg
    assert jeng.TensorSearch(dataclasses.replace(
        jproto, net_cap=jproto.net_cap * 2),
        chunk=64)._ckpt_fingerprint() in msg
    beam = teng.TensorSearch(proto, chunk=64, strict=False,
                             checkpoint_path=ckpt, device="cpu")
    with pytest.raises(tck.CheckpointMismatch):
        beam.run(resume=True)


def test_supervisor_zero_fault_plan_is_transparent(jpp):
    """A supervisor with the default policy and no faults changes
    nothing: the bare engine's counts, all recovery counters zero."""
    _, jbase = jpp
    proto = _pruned(t_pp(2))
    bare = teng.TensorSearch(proto, chunk=64, device="cpu").run()
    out = _tsup(proto, ladder=("device",), chunk=64).run()
    assert _key(out) == _key(bare) == _key(jbase)
    assert (out.retries, out.failovers, out.resumed_from_depth) == (0, 0, 0)
    assert (out.abandoned_threads, out.child_restarts,
            out.killed_dispatches, out.knob_retries) == (0, 0, 0, 0)
    assert (out.engine, out.mesh_width, out.cancelled) == ("device", 1,
                                                           False)
    assert out.platform == "cpu"


def test_abandoned_thread_accounting_and_warning():
    """The in-process watchdog can only abandon a wedged dispatch: the
    boundary counts the still-blocked threads and warns past the
    threshold."""
    b = tsup.DispatchBoundary(tsup.RetryPolicy(
        max_retries=0, deadline_secs=0.2, deadline_first_secs=0.2))

    def _block():
        # A blocked call that ignores the plan's release event.
        time.sleep(6.0)

    with pytest.raises(tsup.EngineFailure):
        b.dispatch("device.step", _block)
    assert b.abandoned_alive() == 1
    assert b.timeouts == 1
    with pytest.warns(RuntimeWarning, match="abandoned"):
        with pytest.raises(tsup.EngineFailure):
            b.dispatch("device.step", _block)
    assert b.abandoned_alive() == 2


def test_install_retry_single_engine(jpp):
    """install_retry (the backend's wrapper): a transient retries in
    place on a bare engine; exhaustion is a loud EngineFailure."""
    _, jbase = jpp
    proto = _pruned(t_pp(2))
    faulted = teng.TensorSearch(proto, chunk=64, device="cpu")
    boundary = tsup.install_retry(
        faulted, tsup.RetryPolicy(max_retries=2, **FAST),
        tsup.FaultPlan().raise_at(2, count=1))
    assert _key(faulted.run()) == _key(jbase)
    assert boundary.retries == 1
    dead = teng.TensorSearch(proto, chunk=64, device="cpu")
    tsup.install_retry(dead, tsup.RetryPolicy(max_retries=1, **FAST),
                       tsup.FaultPlan().raise_always())
    with pytest.raises(tsup.EngineFailure):
        dead.run()


# --------------------------------------------------- the port's own

def test_knob_shrink_relevel_on_cuda_oom(tmp_path, jpp):
    """An injected torch.cuda.OutOfMemoryError on a chunk step after the
    depth-2 dump re-levels the device rung in place at half the chunk
    from the checkpoint: the JAX re-level on an injected MemoryError
    ("RESOURCE_EXHAUSTED ...") gives the same counts and knob_retries.
    The failed rung's kept carry is released before the re-level."""
    _, jbase = jpp
    sup = _tsup(_pruned(t_pp(2)),
                fault_plan=tsup.FaultPlan().raise_at(
                    7, error=torch.cuda.OutOfMemoryError, engine="device",
                    message="CUDA out of memory. Tried to allocate"),
                checkpoint_path=str(tmp_path / "port.npz"),
                checkpoint_every=1, policy=tsup.RetryPolicy(max_retries=0))
    out = sup.run()
    jsup_ = _jsup(_pruned(j_pp(2)),
                  fault_plan=jsup.FaultPlan().raise_at(
                      7, error=MemoryError, engine="device",
                      message="RESOURCE_EXHAUSTED: out of memory"),
                  checkpoint_path=str(tmp_path / "jax.npz"),
                  checkpoint_every=1,
                  policy=jsup.RetryPolicy(max_retries=0))
    ref = jsup_.run()
    assert _key(out) == _key(ref) == _key(jbase)
    assert _recovery(out) == _recovery(ref) == ("device", 0, 0)
    assert out.knob_retries == ref.knob_retries == 1
    assert sup.last_search.chunk == PP_KW["chunk"] // 2
    assert 0 < out.resumed_from_depth <= 2
    assert sup._engines["device"]._last_dev_carry is None
    assert sup.failures == []


@pytest.mark.parametrize("build,slice_name", [
    (lambda t: _tsup(t_pp(2), ladder=("sharded", "device"),
                     mesh=["cpu", "cuda:0"]),
     "protocol_factory"),
    (lambda t: _tsup(t_pp(2), telemetry=t), None),
    (lambda t: tsup.DispatchBoundary(telemetry=t), None),
    (lambda t: __import__("dslabs_tpu_torch.tpu.warden",
                          fromlist=["Warden"]).Warden(
        "m:f", telemetry=t, device="cpu"), None),
], ids=["sharded_rung", "supervisor_telemetry", "boundary_telemetry",
        "warden_telemetry"])
def test_unported_options_raise_naming_their_slice(build, slice_name):
    """A sharded rung over a mesh of two distinct devices (a RankMesh,
    run in one process per rank: tests/test_torch_ranks.py) without a
    protocol factory raises a ValueError naming ``protocol_factory``: a
    live protocol cannot cross into the ranks; ``telemetry=``, which the
    telemetry and tracing slice ported, builds and keeps the recorder."""
    from dslabs_tpu_torch.tpu.telemetry import Telemetry

    tel = Telemetry()
    if slice_name is None:
        assert build(tel).telemetry is tel
        return
    with pytest.raises(ValueError, match=slice_name):
        build(tel)


def test_ladder_options(tpp_base):
    """An unknown rung is a ValueError; ``elastic`` has nothing to expand
    without a sharded rung and is accepted; the probe runs through the
    boundary on the named device and, with no card and no device,
    raises."""
    with pytest.raises(ValueError, match="unknown ladder rung"):
        _tsup(t_pp(2), ladder=("tpu",))
    out = _tsup(_pruned(t_pp(2)), elastic=True).run()
    assert _key(out) == _key(tpp_base)
    assert (out.mesh_width, out.mesh_shrinks) == (1, 0)
    assert tsup.expand_ladder(("device", "host"), 8, True) == [
        ("device", None), ("host", None)]
    assert tsup.probe_device(device="cpu")["platform"] == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tsup.probe_device()


def test_aot_warmup_loads_the_kernels_before_the_run(monkeypatch,
                                                     tpp_base):
    """``aot_warmup=True`` loads the kernel library before the first rung
    on the card and puts its seconds on ``compile_secs``; on the CPU
    there is nothing to load and the run is unchanged."""
    from dslabs_tpu_torch.tpu import _build

    calls = []
    monkeypatch.setattr(_build, "lib", lambda: calls.append(1))
    out = _tsup(_pruned(t_pp(2)), aot_warmup=True).run()
    assert _key(out) == _key(tpp_base)
    assert (calls, out.compile_secs) == ([], 0.0)
    sup = _tsup(t_pp(2), aot_warmup=True)
    sup.device = torch.device("cuda")
    assert sup._warm_up() > 0 and calls == [1]
    sup.aot_warmup = False
    assert sup._warm_up() == 0.0 and calls == [1]


# ------------------------------------------------------- portfolio

def test_portfolio_beats_bfs_on_deep_narrow():
    """tests/test_swarm.py:324 on the port: BFS alone returns
    TIME_EXHAUSTED on the deep-narrow lock; the portfolio returns the
    violation through the swarm lane with the verdict the JAX test pins
    (INVARIANT_VIOLATED, LOCK_HELD, a replay-verified witness of exactly
    k = 12 events), and the losing BFS lane is cancelled."""
    from dslabs_tpu_torch.tpu import swarm as tsw

    proto = make_lock_protocol(m=8, k=12, noise_bits=22)
    kw = dict(ladder=("device",), chunk=1024, frontier_cap=1 << 19,
              visited_cap=1 << 18, strict=False)
    bfs = _tsup(proto, max_secs=0.5, **kw).run()
    assert bfs.end_condition == "TIME_EXHAUSTED" and not bfs.cancelled
    sup = _tsup(proto, max_secs=90.0, portfolio=True,
                swarm_kwargs=dict(walkers_per_device=24, max_steps=240,
                                  steps_per_round=64, seed=0,
                                  visited_cap=1 << 14), **kw)
    out = sup.run()
    assert (out.end_condition, out.engine, out.predicate_name) == (
        "INVARIANT_VIOLATED", "swarm", "LOCK_HELD")
    w = out.witness
    assert w.replay_verified and len(w.trace) == 12 <= len(w.raw_trace)
    assert sup.lanes["winner"] == "swarm"
    assert sup.lanes["bfs"].cancelled
    assert sup.lanes["bfs"].end_condition == "TIME_EXHAUSTED"
    sw = tsw.SwarmSearch(proto, walkers_per_device=8, device="cpu")
    root = teng.flatten_state(sw.initial_state())[0].numpy()
    row, applied = tsw.replay_events(sw, root, w.trace)
    assert applied == 12 and int(row[0]) == 12


def test_portfolio_exhaustive_bfs_verdict_wins(jpp):
    """With no violation in the space the portfolio returns the BFS
    lane's exhaustive verdict (the JAX BFS's counts) and cancels the
    walkers."""
    _, jbase = jpp
    sup = _tsup(_pruned(t_pp(2)), ladder=("device",), portfolio=True,
                max_secs=60.0,
                swarm_kwargs=dict(walkers_per_device=8, max_steps=16,
                                  steps_per_round=16, seed=1,
                                  visited_cap=1 << 10))
    out = sup.run()
    assert _key(out) == _key(jbase)
    assert out.engine == "device"
    assert sup.lanes["winner"] == "bfs"
    assert sup.lanes["swarm"].cancelled
    assert sup.lanes["swarm"].end_condition == "TIME_EXHAUSTED"


def _rank_portfolio(**kw):
    """A portfolio supervisor over two gloo ranks, its protocol rebuilt
    in each rank from the pingpong factory."""
    from dslabs_tpu_torch.tpu.mesh_exchange import RankMesh

    swarm_kw = dict(walkers_per_device=8, max_steps=16, steps_per_round=16,
                    seed=1, visited_cap=1 << 10)
    swarm_kw.update(kw.pop("swarm_kwargs", {}))
    return _tsup(_pruned(t_pp(2)), ladder=("sharded",), portfolio=True,
                 mesh=RankMesh(["cpu", "cpu"], "gloo"), max_secs=60.0,
                 protocol_factory="dslabs_tpu_torch.tpu.protocols.pingpong:"
                                  "make_pingpong_protocol",
                 factory_kwargs={"workload_size": 2},
                 protocol_transform="tests.torch_harness_cases:"
                                    "pruned_without_jax",
                 swarm_kwargs=swarm_kw, **kw)


def test_portfolio_over_a_rank_mesh(jpp):
    """Both lanes over two gloo ranks (tpu/ranks.py): the sharded rung's
    exhaustive verdict wins with the JAX BFS's counts, and the swarm
    lane's launch is killed and reported cancelled."""
    _, jbase = jpp
    t0 = time.time()
    sup = _rank_portfolio()
    out = sup.run()
    assert _key(out) == _key(jbase)
    assert (out.engine, out.mesh_width) == ("sharded", 2)
    assert sup.lanes["winner"] == "bfs"
    assert sup.lanes["swarm"].cancelled
    assert sup.lanes["swarm"].end_condition == "TIME_EXHAUSTED"
    assert time.time() - t0 < 60.0


def test_portfolio_swarm_lane_dumps_over_a_rank_mesh(tmp_path):
    """The portfolio's swarm lane over two gloo ranks writes its round
    dumps beside the BFS dump, as the one-process lane does: rank 0's
    dump holds both walker groups and both ranks' generator states."""
    from dslabs_tpu_torch.tpu import ranks

    ckpt = str(tmp_path / "port.npz")
    sup = _rank_portfolio(checkpoint_path=ckpt, checkpoint_every=1,
                          swarm_kwargs=dict(max_rounds=1))
    sw = sup._build_swarm()
    assert isinstance(sw, ranks.RankSwarm)
    out = sw.run(check_initial=False)
    assert out.end_condition == "TIME_EXHAUSTED"
    assert out.swarm["rounds"] == 1
    assert tck.peek_depth(ckpt + ".swarm") == 1
    ck = np.load(ckpt + ".swarm")
    assert ck["extra__gen_states"].shape[0] == 2
    assert len(ck["extra__vdev"]) == 2
