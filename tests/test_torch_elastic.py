"""PyTorch port, the supervisor's and the warden's sharded rung and the
elastic width ladder (``dslabs_tpu_torch/tpu/supervisor.py``,
``tpu/warden.py``), against the JAX package on the CPU.

The cases are those of ``tests/test_supervisor.py`` (the three superstep
cases) and ``tests/test_chaos.py`` (the width ladder, the knob shrink,
the warden's SIGKILL ladder) with the reference's pins: the sharded
rung's dispatch sequence is ``init, (superstep, promote)*`` in both
packages, so the reference's fault indices land on the same sites.  The
port's shards share one device: ``ShardMesh(8, "cpu")`` stands for the
reference's ``make_mesh(8)`` on the conftest's eight virtual devices.
The pingpong cases' fault-free counts are the JAX
``ShardedTensorSearch``'s at ``make_mesh(8)``; the warden case, as the
reference's, holds the port's own fault-free 8-wide run."""

import dataclasses

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)

from dslabs_tpu.tpu import supervisor as jsup  # noqa: E402
from dslabs_tpu.tpu.protocols.pingpong import \
    make_pingpong_protocol as j_pp  # noqa: E402
from dslabs_tpu.tpu.sharded import ShardedTensorSearch as JSharded  # noqa: E402
from dslabs_tpu.tpu.sharded import make_mesh as j_mesh  # noqa: E402
from dslabs_tpu_torch.tpu import supervisor as tsup  # noqa: E402
from dslabs_tpu_torch.tpu.chaos import ChaosOOM  # noqa: E402
from dslabs_tpu_torch.tpu.mesh_exchange import ShardMesh  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.clientserver import \
    make_clientserver_protocol as t_cs  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.pingpong import \
    make_pingpong_protocol as t_pp  # noqa: E402
from dslabs_tpu_torch.tpu.sharded import ShardedTensorSearch  # noqa: E402
from dslabs_tpu_torch.tpu.telemetry import Telemetry  # noqa: E402
from dslabs_tpu_torch.tpu.warden import Warden  # noqa: E402

pytestmark = pytest.mark.chaos

PP_KW = dict(chunk=16, frontier_cap=1 << 8, visited_cap=1 << 10)
LAB1_KW = dict(chunk=64, frontier_cap=1 << 9, visited_cap=1 << 12)
FAST = dict(backoff_base=0.001)
CHILD_ENV = {"OMP_NUM_THREADS": "1"}
LAB1 = {
    "factory": "dslabs_tpu_torch.tpu.protocols.clientserver:"
               "make_clientserver_protocol",
    "factory_kwargs": {"n_clients": 1, "w": 2},
    "transform": "tests.torch_harness_cases:pruned_without_jax",
}


class FatalError(RuntimeError):
    """An injected non-transient, non-OOM failure."""


def _pruned(p):
    return dataclasses.replace(
        p, goals={}, prunes={"CLIENTS_DONE": p.goals["CLIENTS_DONE"]})


def _sup(proto, **kw):
    kw.setdefault("mesh", ShardMesh(8, "cpu"))
    for k, v in PP_KW.items():
        kw.setdefault(k, v)
    return tsup.SearchSupervisor(proto, **kw)


def _key(o):
    return (o.end_condition, o.unique_states, o.states_explored)


@pytest.fixture(scope="module")
def base():
    """The port's fault-free sharded rung at width 8, equal to the JAX
    engine's counts at ``make_mesh(8)``."""
    ref = JSharded(_pruned(j_pp(2)), j_mesh(8), chunk_per_device=16,
                   frontier_cap=1 << 8, visited_cap=1 << 10).run()
    sup = _sup(_pruned(t_pp(2)))
    out = sup.run()
    assert _key(out) == _key(ref)
    assert (out.engine, out.mesh_width, out.mesh_shrinks) == ("sharded", 8,
                                                             0)
    assert isinstance(sup._engines["sharded"], ShardedTensorSearch)
    return out


# ------------------------------------------------------ ladder mechanics

@pytest.mark.parametrize("ladder,width,elastic,want", [
    (("sharded", "device", "host"), 8, True,
     [("sharded", None), ("sharded", 4), ("sharded", 2),
      ("device", None), ("host", None)]),
    (("sharded", "device", "host"), 6, True,
     [("sharded", None), ("sharded", 3), ("sharded", 2),
      ("device", None), ("host", None)]),
    (("sharded", "device"), 2, True, [("sharded", None), ("device", None)]),
    (("sharded", "device", "host"), 8, False,
     [("sharded", None), ("device", None), ("host", None)]),
    (("device", "host"), 8, True, [("device", None), ("host", None)]),
], ids=["d8", "d6", "d2", "not_elastic", "no_sharded_rung"])
def test_expand_ladder_widths(ladder, width, elastic, want):
    """The width ladder is the reference's pin (tests/test_chaos.py:104)
    and the JAX function's result."""
    assert tsup.expand_ladder(ladder, width, elastic) == want
    assert jsup.expand_ladder(ladder, width, elastic) == want


def test_classify_oom_markers():
    """tests/test_chaos.py:123 on the port, each case also through the
    JAX classifier (the chaos OOM is the port's own class)."""
    cases = [(MemoryError("boom"), True),
             (RuntimeError("RESOURCE_EXHAUSTED: hbm"), True),
             (RuntimeError("ran out of memory on device"), True),
             (RuntimeError("INVALID_ARGUMENT"), False),
             (None, False)]
    for exc, want in cases:
        assert tsup.classify_oom(exc) is want
        assert jsup.classify_oom(exc) is want
    assert tsup.classify_oom(ChaosOOM("chaos injected allocation failure"))


# ------------------------------------------------- the superstep cases

def test_superstep_transient_fault_retries_in_place(base):
    """tests/test_supervisor.py:307: index 3 of the sharded rung is a
    superstep dispatch; a fault there and on its first retry is absorbed
    in place."""
    sup = _sup(_pruned(t_pp(2)),
               fault_plan=tsup.FaultPlan().raise_at(3, count=2),
               policy=tsup.RetryPolicy(max_retries=3, **FAST))
    out = sup.run()
    assert sup._engines["sharded"].use_superstep
    assert _key(out) == _key(base)
    assert (out.engine, out.retries, out.failovers) == ("sharded", 2, 0)


def test_superstep_fatal_fails_over_and_resumes_checkpoint(base, tmp_path):
    """tests/test_supervisor.py:324: a fatal fault at dispatch 7 (the
    level-4 superstep) fails over to the device rung, which resumes the
    sharded rung's dump at depth 1-3."""
    plan = tsup.FaultPlan().raise_at(7, error=FatalError, engine="sharded")
    sup = _sup(_pruned(t_pp(2)), fault_plan=plan,
               checkpoint_path=str(tmp_path / "ss.npz"), checkpoint_every=1,
               policy=tsup.RetryPolicy(max_retries=0))
    out = sup.run()
    assert sup._engines["sharded"].use_superstep
    assert _key(out) == _key(base)
    assert (out.engine, out.failovers, out.mesh_width) == ("device", 1, 1)
    assert 0 < out.resumed_from_depth <= 3


def test_superstep_watchdog_deadline_scales_with_trip_count(base):
    """tests/test_supervisor.py:347: the boundary reads an installed
    search's published scale live, 1.0 at other sites and with no search;
    a real sharded run publishes its superstep's scale and its spans
    carry it."""

    class Search:
        _dispatch_deadline_scales = {"superstep": 8.0}

    # The boundary holds its search weakly: keep it alive.
    s = Search()
    for m in (tsup, jsup):
        b = m.DispatchBoundary(m.RetryPolicy(deadline_secs=2.0))
        b.install(s)
        assert b._deadline_scale("sharded.superstep") == 8.0
        assert b._deadline_scale("sharded.promote") == 1.0
        bare = m.DispatchBoundary(m.RetryPolicy(deadline_secs=2.0))
        assert bare._deadline_scale("sharded.superstep") == 1.0
    tel = Telemetry()
    sh = ShardedTensorSearch(_pruned(t_pp(2)), ShardMesh(2, "cpu"),
                             chunk_per_device=2, frontier_cap=1 << 8,
                             visited_cap=1 << 10, telemetry=tel)
    assert _key(sh.run()) == _key(base)
    spans = [r for r in tel.ring if r.get("t") == "span"]
    scales = {r["site"]: set() for r in spans}
    for r in spans:
        scales[r["site"]].add(r["scale"])
    assert scales["promote"] == scales["init"] == {1.0}
    assert max(scales["superstep"]) > 1.0
    assert sh._dispatch_deadline_scales["superstep"] in scales["superstep"]


# ------------------------------------------------------ the width ladder

def test_elastic_fatal_degrades_by_half_not_cliff(base, tmp_path):
    """tests/test_chaos.py:131: a fatal error on the 8-wide rung costs
    half the mesh: the 4-wide rung resumes the checkpoint re-sharded and
    lands the fault-free counts, the shrink on the outcome and the
    flight log."""
    tel = Telemetry()
    out = _sup(_pruned(t_pp(2)), elastic=True,
               fault_plan=tsup.FaultPlan().raise_at(8, error=FatalError,
                                                    engine="sharded"),
               checkpoint_path=str(tmp_path / "el.npz"),
               checkpoint_every=1, telemetry=tel,
               policy=tsup.RetryPolicy(max_retries=0)).run()
    assert _key(out) == _key(base)
    assert (out.engine, out.mesh_width, out.mesh_shrinks,
            out.failovers) == ("sharded", 4, 1, 1)
    assert out.resumed_from_depth > 0
    assert out.dropped_states == 0
    shrunk = [e for e in tel.events if e.get("kind") == "mesh_shrunk"]
    assert [(e["from_width"], e["to_width"]) for e in shrunk] == [(8, 4)]
    rungs = [e["width"] for e in tel.events if e.get("kind") == "rung"]
    assert rungs == [8, 4]


def test_knob_shrink_absorbs_oom_in_place(base, tmp_path):
    """tests/test_chaos.py:164: an OOM-shaped failure re-levels the rung
    in place with the chunk and the superstep budget halved: no failover,
    no shrink of the mesh."""
    tel = Telemetry()
    sup = _sup(_pruned(t_pp(2)), elastic=True,
               fault_plan=tsup.FaultPlan().raise_at(6, error=MemoryError,
                                                    engine="sharded"),
               checkpoint_path=str(tmp_path / "oom.npz"),
               checkpoint_every=1, telemetry=tel,
               policy=tsup.RetryPolicy(max_retries=0))
    out = sup.run()
    assert _key(out) == _key(base)
    assert (out.engine, out.mesh_width, out.mesh_shrinks, out.knob_retries,
            out.failovers) == ("sharded", 8, 0, 1, 0)
    kinds = [e.get("kind") for e in tel.events]
    assert "knobs_shrunk" in kinds and "mesh_shrunk" not in kinds
    shrunk = sup._engines[("sharded", None, None, 1)]
    assert shrunk.cpd == PP_KW["chunk"] // 2
    assert shrunk._superstep_chunks == tsup.SUPERSTEP_CHUNKS // 2


def test_knob_shrink_ladder_is_bounded_then_rung_burns(base):
    """tests/test_chaos.py:191: a persistent OOM exhausts the bounded
    shrink ladder (two re-levels) and the rung burns; the device rung
    lands the counts."""
    out = _sup(_pruned(t_pp(2)), ladder=("sharded", "device"),
               fault_plan=tsup.FaultPlan().raise_always(
                   error=MemoryError, engine="sharded"),
               policy=tsup.RetryPolicy(max_retries=0)).run()
    assert _key(out) == _key(base)
    assert (out.engine, out.knob_retries, out.failovers) == ("device", 2, 1)
    assert tsup.MAX_KNOB_SHRINKS == 2


# ------------------------------------------------------------ the warden

def test_warden_sigkill_mid_level_resumes_on_narrower_meshes(tmp_path):
    """tests/test_chaos.py:248: strict lab1 at width 8, SIGKILLed on its
    first dispatch after a durable checkpoint, resumes at width 4; that
    child is killed the same way and the 2-wide child finishes with the
    fault-free 8-wide counts, both deaths attributable."""
    ref = ShardedTensorSearch(
        _pruned(t_cs(n_clients=1, w=2)), ShardMesh(8, "cpu"),
        chunk_per_device=LAB1_KW["chunk"],
        frontier_cap=LAB1_KW["frontier_cap"],
        visited_cap=LAB1_KW["visited_cap"]).run()
    tel = Telemetry()
    w = Warden(**LAB1, ladder=("sharded", "device", "host"), elastic=True,
               mesh_width=8, checkpoint_path=str(tmp_path / "wk.npz"),
               checkpoint_every=1, env=CHILD_ENV, device="cpu",
               telemetry=tel, **LAB1_KW,
               fault={"kind": "die", "at": 2, "spawns": [0, 1],
                      "after_ckpt": True})
    out = w.run()
    assert _key(out) == _key(ref)
    assert (out.engine, out.mesh_width, out.mesh_shrinks,
            out.child_restarts) == ("sharded", 2, 2, 2)
    assert out.resumed_from_depth > 0
    assert out.dropped_states == 0
    assert [d.kind for d in w.deaths] == ["oom", "oom"]
    shrunk = [(e["from_width"], e["to_width"]) for e in tel.events
              if e.get("kind") == "mesh_shrunk"]
    assert shrunk == [(8, 4), (4, 2)]
