"""PyTorch port, the seeded chaos harness (``dslabs_tpu_torch/tpu/
chaos.py``), against the JAX package on the CPU.

``build_plan`` is a pure function of its seed and the observed dispatch
counts: the port's plan equals the JAX plan field by field.  The soak
cases are ``tests/test_chaos.py``'s (the lab1 acceptance and the CLI) on
``ShardMesh(8, "cpu")``: the fault-free run is the JAX
``ShardedTensorSearch``'s counts at ``make_mesh(8)``, and the chaos run
lands them exactly.  The soak's watchdog deadline is shortened here (a
module constant of the port): an injected hang then costs seconds, not
the default twelve."""

import dataclasses
import json

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)

from dslabs_tpu.tpu import chaos as jchaos  # noqa: E402
from dslabs_tpu.tpu.protocols.clientserver import \
    make_clientserver_protocol as j_cs  # noqa: E402
from dslabs_tpu.tpu.sharded import ShardedTensorSearch as JSharded  # noqa: E402
from dslabs_tpu.tpu.sharded import make_mesh as j_mesh  # noqa: E402
from dslabs_tpu_torch.tpu import chaos as tchaos  # noqa: E402
from dslabs_tpu_torch.tpu import supervisor as tsup  # noqa: E402
from dslabs_tpu_torch.tpu.mesh_exchange import ShardMesh  # noqa: E402
from dslabs_tpu_torch.tpu.telemetry import Telemetry  # noqa: E402

pytestmark = pytest.mark.chaos

LAB1_KW = dict(chunk=64, frontier_cap=1 << 9, visited_cap=1 << 12)
# The soak's steady-state watchdog deadline here, seconds: long enough for
# any real dispatch of these shapes on a loaded CPU.
DEADLINE = 4.0


def _pruned(p):
    return dataclasses.replace(
        p, goals={}, prunes={"CLIENTS_DONE": p.goals["CLIENTS_DONE"]})


@pytest.fixture(scope="module")
def lab1_ref():
    """The JAX engine's fault-free lab1 counts at make_mesh(8)."""
    o = JSharded(_pruned(j_cs(n_clients=1, w=2)), j_mesh(8),
                 chunk_per_device=LAB1_KW["chunk"],
                 frontier_cap=LAB1_KW["frontier_cap"],
                 visited_cap=LAB1_KW["visited_cap"]).run()
    return o.end_condition, o.unique_states, o.states_explored


@pytest.mark.parametrize("seed,faults,counts", [
    (3, 24, {("sharded", "init"): 1, ("sharded", "superstep"): 10,
             ("sharded", "promote"): 9}),
    (4, 24, {("sharded", "init"): 1, ("sharded", "superstep"): 10,
             ("sharded", "promote"): 9}),
    (1, 24, {("sharded", "init"): 1, ("sharded", "superstep"): 5,
             ("sharded", "promote"): 4}),
    (11, 32, {("sharded", "init"): 2, ("sharded", "superstep"): 7,
              ("sharded", "promote"): 1}),
], ids=["seed3", "seed4", "seed1_lab1", "seed11_one_multi_site"])
def test_chaos_plan_equals_jax_and_is_seed_deterministic(seed, faults,
                                                         counts):
    """tests/test_chaos.py:319: the same seed and counts give the same
    schedule, field by field the JAX plan's (rules included); the kind
    budget is exact; hangs pin to the promote site when it has more than
    one dispatch."""
    spec = tchaos.ChaosSpec(seed=seed, faults=faults)
    p1, p2 = tchaos.build_plan(spec, counts), tchaos.build_plan(spec, counts)
    ref = jchaos.build_plan(jchaos.ChaosSpec(seed=seed, faults=faults),
                            counts)
    assert p1.schedule == p2.schedule == ref.schedule
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref.spec)

    def rules(plan):
        return [(r.kind, r.at, r.count, r.engine, r.site,
                 r.error.__name__, r.message, r.hang_secs)
                for r in plan.rules]

    assert rules(p1) == rules(ref)
    assert p1.chaos and isinstance(p1, tsup.FaultPlan)
    kinds = [k for (_e, _s, _i, k) in p1.schedule]
    assert len(p1.schedule) == faults
    if seed in (3, 4):
        assert (kinds.count("oom"), kinds.count("fatal"),
                kinds.count("hang"), kinds.count("transient")) == (2, 1,
                                                                   1, 20)
        assert len({(e, s) for (e, s, _i, _k) in p1.schedule}) == 3
        assert all(s == "promote" for (_e, s, _i, k) in p1.schedule
                   if k == "hang")
    if seed == 3:
        p4 = tchaos.build_plan(tchaos.ChaosSpec(seed=4, faults=24), counts)
        assert p4.schedule != p1.schedule
    with pytest.raises(ValueError, match="multi-dispatch"):
        tchaos.build_plan(spec, {("sharded", "init"): 1})


def test_chaos_policy_matches_jax():
    """The soak policy is the reference's, with the deadline a constant
    of the port (12 s) or an argument."""
    spec = tchaos.ChaosSpec(seed=5, faults=24)
    ref = jchaos.chaos_policy(jchaos.ChaosSpec(seed=5, faults=24))
    assert tchaos.DEADLINE_SECS == 12.0
    assert dataclasses.asdict(tchaos.chaos_policy(spec)) == \
        dataclasses.asdict(ref)
    assert tchaos.chaos_policy(spec, 3.0).deadline_secs == 3.0


def test_chaos_soak_lab1_acceptance(tmp_path, lab1_ref):
    """tests/test_chaos.py:341: a seeded soak on strict lab1 at width 8
    fires at least 20 faults over the three sites (transient storms, OOM
    re-levels, a fatal rung burn, a hang) and lands the fault-free
    counts with zero dropped states, both degradation axes exercised and
    every injection on the flight log as a chaos event."""
    spec = tchaos.ChaosSpec(seed=1, faults=24)
    tel = Telemetry()
    report = tchaos.soak(
        tchaos._protocol("lab1"),
        spec=spec,
        supervisor_kwargs=dict(mesh=ShardMesh(8, "cpu"),
                               policy=tchaos.chaos_policy(spec, DEADLINE),
                               **LAB1_KW),
        checkpoint_path=str(tmp_path / "soak.npz"), telemetry=tel,
        min_fired=20, min_sites=3)
    assert report["parity"] is True
    base = report["base"]
    assert (base["verdict"], base["unique"], base["explored"]) == lab1_ref
    assert report["fired"] >= 20
    assert report["sites_fired"] == ["sharded.init", "sharded.promote",
                                     "sharded.superstep"]
    chaos = report["chaos"]
    assert chaos["dropped_states"] == 0
    assert chaos["mesh_shrinks"] >= 1
    assert chaos["knob_retries"] >= 1
    assert chaos["retries"] >= 10
    assert "hang" in report["kinds_fired"]
    assert report["platform"] == "cpu"
    kinds = [e.get("kind") for e in tel.events]
    assert kinds.count("chaos_inject") == report["fired"]
    assert "fault_inject" not in kinds


def test_chaos_cli_prints_one_json_line(monkeypatch, capsys, lab1_ref):
    """tests/test_chaos.py:372: ``python -m dslabs_tpu_torch.tpu.chaos``
    (here its ``main``, in process) prints the soak report as one JSON
    line and exits 0 on parity; ``--device cpu`` keeps it off the card."""
    monkeypatch.setattr(tchaos, "DEADLINE_SECS", DEADLINE)
    assert tchaos.main(["--protocol", "lab1", "--seed", "2", "--faults",
                        "20", "--mesh", "8", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    report = json.loads(lines[-1])
    assert report["parity"] is True
    assert (report["base"]["verdict"], report["base"]["unique"],
            report["base"]["explored"]) == lab1_ref
    assert report["platform"] == "cpu"
    assert report["fired"] >= 20
