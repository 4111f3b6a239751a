"""PyTorch port, the dispatch seam (``TensorSearch._dispatch``) that the
search supervisor's boundary rides, on the CPU:

- every seam tag of every loop (the device loop, ``run_host``, a resumed
  device loop, spill mode, the swarm) is seen by a counting hook on a
  straight run, and a one-shot ``TransientDeviceError`` injected at that
  tag retries in place to the straight run's exact counts (walks and
  witnesses too, for the swarm);
- the port's carry is updated in place, so a transient raised inside a
  dispatch that writes the carry is never retried in place: the run
  fails over (or, for an OOM, re-levels) from the last checkpoint with
  exact counts; the same exception from a read-only site retries in
  place;
- the spill fault matrix and the capacity ladder of ``tests/
  test_spill.py`` (site-targeted transients, a hung drain, transients
  under the async drain, ``spill="ladder"``) against the same JAX runs;
- a lab search through ``tensor_bfs`` (which installs the retry
  boundary) gives the same ``SearchResults`` with and without one
  injected transient."""

import collections
import dataclasses
import functools

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)

from dslabs_tpu.tpu import spill as jspill  # noqa: E402
from dslabs_tpu.tpu import supervisor as jsup  # noqa: E402
from dslabs_tpu.tpu.protocols.clientserver import \
    make_clientserver_protocol as j_cs  # noqa: E402
from dslabs_tpu_torch.tpu import backend as tback  # noqa: E402
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.tpu import spill as tspill  # noqa: E402
from dslabs_tpu_torch.tpu import supervisor as tsup  # noqa: E402
from dslabs_tpu_torch.tpu import swarm as tsw  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.clientserver import \
    make_clientserver_protocol as t_cs  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.pingpong import \
    make_pingpong_protocol as t_pp  # noqa: E402
from dslabs_tpu_torch.utils.flags import GlobalSettings as TFlags  # noqa: E402
from tests import torch_harness_cases as H  # noqa: E402

pytestmark = pytest.mark.fault

FAST = dict(backoff_base=0.001)
LAB1_DEPTH = 11
# The spill shapes of tests/test_spill.py: lab1 c3-w4 to depth 11 with
# the device table at an eighth of its 1,250 states.
LAB1_CAP = 128
SPILL_KW = dict(chunk=16, visited_cap=LAB1_CAP, frontier_cap=1 << 11,
                max_depth=LAB1_DEPTH)


def _pruned(p):
    return dataclasses.replace(
        p, goals={}, prunes={"CLIENTS_DONE": p.goals["CLIENTS_DONE"]})


def _key(o):
    return (o.end_condition, o.unique_states, o.states_explored, o.depth)


# ------------------------------------------------------ the tag matrix

def _loop(name, tmp_path_factory):
    """(search, run kwargs) of one loop at a small shape."""
    if name == "device":
        return teng.TensorSearch(_pruned(t_pp(2)), chunk=16,
                                 device="cpu"), {}
    if name == "goal":
        return teng.TensorSearch(t_pp(2), chunk=16, device="cpu"), {}
    if name == "host":
        return teng.TensorSearch(_pruned(t_pp(2)), chunk=16,
                                 use_host_visited=True, device="cpu"), {}
    if name == "resume":
        path = str(tmp_path_factory.mktemp("seam") / "pp.npz")
        teng.TensorSearch(_pruned(t_pp(2)), chunk=16, max_depth=2,
                          checkpoint_path=path, checkpoint_every=1,
                          device="cpu").run()
        return teng.TensorSearch(_pruned(t_pp(2)), chunk=16,
                                 checkpoint_path=path,
                                 device="cpu"), {"resume": True}
    if name == "spill":
        return teng.TensorSearch(_pruned(t_cs(n_clients=2, w=2)), chunk=16,
                                 visited_cap=32, frontier_cap=64,
                                 spill=True, device="cpu"), {}
    if name == "swarm":
        return tsw.SwarmSearch(H.make_lock_protocol(m=6, k=9,
                                                    noise_bits=16),
                               walkers_per_device=16, max_steps=96,
                               steps_per_round=16, seed=0,
                               device="cpu"), {}
    raise AssertionError(name)


def _swarm_key(o):
    w = o.witness
    return (o.end_condition, o.predicate_name, o.swarm["explored"],
            o.swarm["unique"], o.swarm["restarts"], w.raw_trace, w.trace)


def _run_counted(search, kw):
    tags = collections.Counter()

    def hook(tag, fn, *args):
        tags[tag] += 1
        return fn(*args)

    search._dispatch_hook = hook
    return search.run(**kw), tags


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """Each loop's straight run under a counting hook: (key, tags)."""
    out = {}
    for name in ("device", "goal", "host", "resume", "spill", "swarm"):
        search, kw = _loop(name, tmp_path_factory)
        o, tags = _run_counted(search, kw)
        key = _swarm_key(o) if name == "swarm" else _key(o)
        out[name] = (key, tags)
    return out


SEAM_TAGS = [
    ("device", "device.init"), ("device", "device.step"),
    ("device", "device.sync"), ("device", "device.promote"),
    ("goal", "device.flags"), ("resume", "device.init"),
    ("host", "host.expand"),
    ("spill", "device.init"), ("spill", "device.step"),
    ("spill", "device.sync"), ("spill", "device.promote"),
    ("spill", "device.spill_drain"), ("spill", "device.spill_evict"),
    ("spill", "device.spill_reinject"),
    ("swarm", "swarm.init"), ("swarm", "swarm.step"),
    ("swarm", "swarm.sync"), ("swarm", "swarm.flags"),
]


@pytest.mark.parametrize("loop,tag", SEAM_TAGS,
                         ids=[f"{lp}-{t}" for lp, t in SEAM_TAGS])
def test_every_seam_tag_fires_and_recovers(loop, tag, straight,
                                           tmp_path_factory):
    """The counting hook saw ``tag`` on the loop's straight run; one
    transient injected at the tag's last dispatch (a warm one where the
    tag fires more than once) retries in place to the straight run's
    exact result."""
    key, tags = straight[loop]
    assert tags[tag] > 0, (tag, dict(tags))
    search, kw = _loop(loop, tmp_path_factory)
    engine, site = tag.split(".", 1)
    plan = tsup.FaultPlan().raise_at(tags[tag] - 1, engine=engine,
                                     site=site)
    boundary = tsup.install_retry(
        search, tsup.RetryPolicy(max_retries=1, **FAST), plan)
    o = search.run(**kw)
    assert (_swarm_key(o) if loop == "swarm" else _key(o)) == key
    assert plan.fired == 1 and boundary.retries == 1


# ------------------------------------------- mutating vs read-only sites

def _torn_step(monkeypatch, at: int, error):
    """Patch every device loop's chunk step so that its ``at``-th call
    (over the whole test) runs, writing the carry, and then raises."""
    orig = teng.TensorSearch._build_dev_step
    calls = [0]

    def build(self, cap):
        step = orig(self, cap)

        def torn(carry, j, ev_pass):
            out = step(carry, j, ev_pass)
            calls[0] += 1
            if calls[0] == at:
                raise error
            return out

        return torn

    monkeypatch.setattr(teng.TensorSearch, "_build_dev_step", build)
    return calls


def _ckpt_sup(tmp_path, **kw):
    kw.setdefault("ladder", ("device", "host"))
    return tsup.SearchSupervisor(
        _pruned(t_pp(2)), chunk=16, frontier_cap=1 << 8,
        visited_cap=1 << 10, checkpoint_path=str(tmp_path / "ck.npz"),
        checkpoint_every=1, device="cpu",
        policy=tsup.RetryPolicy(max_retries=3, **FAST), **kw)


@pytest.fixture(scope="module")
def pp_key():
    return _key(teng.TensorSearch(_pruned(t_pp(2)), chunk=16,
                                  device="cpu").run())


def test_transient_inside_a_mutating_step_fails_over(tmp_path,
                                                     monkeypatch, pp_key):
    """A step that wrote the carry and then raised a transient is not
    rerun in place (it would insert its keys and append its rows twice):
    the device rung fails as ``torn`` and the host rung resumes from the
    last dump with the straight run's exact counts."""
    calls = _torn_step(monkeypatch, 3,
                       tsup.TransientDeviceError("after the write"))
    sup = _ckpt_sup(tmp_path)
    out = sup.run()
    assert calls[0] == 3
    assert _key(out) == pp_key
    assert (out.engine, out.failovers, out.retries) == ("host", 1, 0)
    assert [f.kind for f in sup.failures] == ["torn"]
    assert out.resumed_from_depth > 0


def test_oom_inside_a_mutating_step_relevels(tmp_path, monkeypatch,
                                             pp_key):
    """The same write-then-raise with a torch.cuda.OutOfMemoryError:
    the device rung re-levels in place at half the chunk from the last
    dump, with exact counts."""
    _torn_step(monkeypatch, 3, torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 1.00 GiB"))
    sup = _ckpt_sup(tmp_path)
    out = sup.run()
    assert _key(out) == pp_key
    assert (out.engine, out.failovers, out.knob_retries) == ("device", 0, 1)
    assert sup.last_search.chunk == 8
    assert out.resumed_from_depth > 0


@pytest.mark.parametrize("read_only", [True, False],
                         ids=["read_only", "unmarked"])
def test_transient_inside_a_readback(tmp_path, monkeypatch, pp_key,
                                     read_only):
    """The same transient raised inside the stats readback after it read
    (the site is marked read-only) retries in place; the unmarked
    function is treated as a write and fails over."""
    orig = teng.to_host
    calls = [0]

    def flaky(t):
        out = orig(t)
        calls[0] += 1
        if calls[0] == 3:
            raise tsup.TransientDeviceError("after the read")
        return out

    monkeypatch.setattr(teng, "to_host",
                        teng.read_only(flaky) if read_only else flaky)
    sup = _ckpt_sup(tmp_path)
    out = sup.run()
    assert _key(out) == pp_key
    if read_only:
        assert (out.engine, out.failovers, out.retries) == ("device", 0, 1)
    else:
        assert (out.engine, out.failovers, out.retries) == ("host", 1, 0)
        assert [f.kind for f in sup.failures] == ["torn"]


# ------------------------------------------- spill fault matrix vs JAX

@pytest.fixture(scope="module")
def lab1_base():
    out = teng.TensorSearch(_pruned(t_cs(n_clients=3, w=4)), chunk=1024,
                            max_depth=LAB1_DEPTH, device="cpu").run()
    assert _key(out) == ("DEPTH_EXHAUSTED", 1250, 11607, LAB1_DEPTH)
    return out


def _spill_sup(m, **kw):
    proto = (_pruned(t_cs(n_clients=3, w=4)) if m is tsup
             else _pruned(j_cs(n_clients=3, w=4)))
    for k, v in SPILL_KW.items():
        kw.setdefault(k, v)
    if m is tsup:
        kw["device"] = "cpu"
    return m.SearchSupervisor(proto, **kw)


def _site_plan(m):
    plan = m.FaultPlan()
    for site in ("spill_drain", "spill_evict", "spill_reinject"):
        plan.raise_at(1, engine="device", site=site,
                      error=m.TransientDeviceError)
    return plan


@pytest.mark.parametrize("gear", ["spill", "async_drain"])
def test_faultplan_spill_dispatch_transient_retry(lab1_base, gear):
    """Transients targeted at each spill site (the second drain, evict
    and reinject dispatch) retry in place through the boundary with
    exact counts, under the default drain and the async one (the
    abort/revert chaos of tests/test_spill.py), as in the JAX runs."""
    outs = []
    for m, sp in ((tsup, tspill), (jsup, jspill)):
        spill = True if gear == "spill" else sp.SpillConfig(
            async_drain=True)
        plan = _site_plan(m)
        out = _spill_sup(m, ladder=("device",), spill=spill,
                         fault_plan=plan,
                         policy=m.RetryPolicy(max_retries=3, **FAST)).run()
        assert plan.fired == 3
        outs.append(out)
    out, ref = outs
    assert _key(out) == _key(ref) == _key(lab1_base)
    assert out.retries == ref.retries == 3
    assert out.dropped_states == 0
    assert (out.spilled_keys, out.host_tier_hits,
            out.respilled_frontier) == (ref.spilled_keys,
                                        ref.host_tier_hits,
                                        ref.respilled_frontier)


def test_faultplan_spill_dispatch_hang_fails_over(lab1_base):
    """A hang on a spill dispatch is abandoned by the watchdog (never
    retried in place) and the ladder fails over to the host rung, as in
    the JAX run."""
    outs = []
    for m in (tsup, jsup):
        sup = _spill_sup(
            m, ladder=("device", "host"), spill=True,
            fault_plan=m.FaultPlan().hang_at(2, engine="device",
                                             site="spill_drain"),
            policy=m.RetryPolicy(max_retries=1, deadline_secs=1.5,
                                 deadline_first_secs=90.0))
        out = sup.run()
        assert [f.kind for f in sup.failures] == ["wedged"]
        outs.append(out)
    out, ref = outs
    assert _key(out) == _key(ref) == _key(lab1_base)
    assert (out.engine, out.failovers) == (ref.engine, ref.failovers) == (
        "host", 1)


def test_supervisor_capacity_ladder(lab1_base, tmp_path):
    """spill="ladder": a CapacityOverflow is a classified failure (kind
    "capacity" on the chain) and the rung retries with the spill tier,
    resuming from its checkpoint, with exact counts, as in the JAX run."""
    outs = []
    for m in (tsup, jsup):
        sup = _spill_sup(
            m, ladder=("device",), chunk=32, visited_cap=2 * LAB1_CAP,
            checkpoint_path=str(tmp_path / f"{m.__name__}.ckpt"),
            checkpoint_every=2, policy=m.RetryPolicy(max_retries=1),
            spill="ladder")
        out = sup.run()
        assert any(f.kind == "capacity" for f in sup.failures)
        outs.append(out)
    out, ref = outs
    assert _key(out) == _key(ref) == _key(lab1_base)
    assert out.failovers == ref.failovers >= 1
    assert out.spilled_keys > 0 and ref.spilled_keys > 0


# ------------------------------------------------------ tensor_bfs

def test_tensor_bfs_survives_a_transient(monkeypatch):
    """A lab 1 search shape through the port's tensor_bfs: one transient
    injected at its retry boundary changes nothing in the SearchResults
    (end condition, terminal depth, discovered count)."""
    monkeypatch.setattr(TFlags, "search_backend", "tensor")
    monkeypatch.setattr(tback, "_run_tensor",
                        functools.partial(tback._run_tensor, chunk=64))
    port = H.Pkg("dslabs_tpu_torch")

    def search():
        case = H.lab1_two_clients(port)
        r = tback.tensor_bfs(case.state, case.settings, device="cpu")
        return (H.end_name(r), H.terminal_depth(r), r.discovered_count)

    base = search()
    assert base[0] == "GOAL_FOUND"
    orig = tsup.install_retry
    plans = []

    def faulted(search, policy=None, plan=None):
        plans.append(tsup.FaultPlan().raise_at(2))
        return orig(search, tsup.RetryPolicy(**FAST), plans[-1])

    monkeypatch.setattr(tsup, "install_retry", faulted)
    assert search() == base
    assert sum(p.fired for p in plans) >= 1
