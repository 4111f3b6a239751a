"""PyTorch port, the swarm rollout probe (``dslabs_tpu_torch/tpu/swarm.py``)
and the batched single-event step under it (``TensorSearch._step_batch``),
against the JAX package on the CPU.  Every integer result compares
exactly:

- ``_step_batch`` equals ``jax.vmap`` of the JAX engine's ``_step_one`` on
  reachable rows and on events drawn from a numpy seed, past-grid and
  negative ids included;
- the diversification schedules equal the reference's arrays;
- the witness pipeline (``replay_events``, ``minimize_event_trace``,
  ``build_witness``) gives the JAX package's results on the JAX swarm's
  own raw witnesses and on a trace that freezes mid-way;
- the walks themselves draw from torch's generator, so they are held by
  their verdicts (the host BFS is the oracle), their witnesses and
  same-seed determinism, not by equality with the JAX walks.

Sizes follow ``tests/test_swarm.py``: 16 walkers, 32-48 steps."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from dslabs_tpu.tpu import engine as jeng  # noqa: E402
from dslabs_tpu.tpu import specs_lab3 as jlab3  # noqa: E402
from dslabs_tpu.tpu import specs_lab4 as jlab4  # noqa: E402
from dslabs_tpu.tpu import swarm as jsw  # noqa: E402
from dslabs_tpu.tpu.protocols.clientserver import \
    make_clientserver_protocol as j_cs  # noqa: E402
from dslabs_tpu.tpu.protocols.pingpong import \
    make_pingpong_protocol as j_pp  # noqa: E402
from dslabs_tpu.tpu.protocols.primarybackup import \
    make_pb_protocol as j_pb  # noqa: E402
from dslabs_tpu.tpu.sharded import make_mesh  # noqa: E402
from dslabs_tpu_torch.tpu import checkpoint as tck  # noqa: E402
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.tpu import specs_lab3 as tlab3  # noqa: E402
from dslabs_tpu_torch.tpu import specs_lab4 as tlab4  # noqa: E402
from dslabs_tpu_torch.tpu import swarm as tsw  # noqa: E402
from dslabs_tpu_torch.tpu import visited as visited_mod  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.clientserver import \
    make_clientserver_protocol as t_cs  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.pingpong import \
    make_pingpong_protocol as t_pp  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.primarybackup import \
    make_pb_protocol as t_pb  # noqa: E402
from dslabs_tpu_torch.tpu.trace import decode_trace  # noqa: E402
from tests.torch_harness_cases import (make_lock_protocol,  # noqa: E402
                                       violating)

PAXOS_KW = dict(n=3, n_clients=1, w=1, max_slots=2)

# name -> (JAX twin, port twin).  lab1_cap4's net_cap of 4 overflows on
# the rows the walk reaches, so the overflow lane is exercised.
STEP_TWINS = {
    "pingpong": (lambda: j_pp(2), lambda: t_pp(2)),
    "lab1": (lambda: j_cs(2, 2), lambda: t_cs(2, 2)),
    "lab1_cap4": (lambda: j_cs(2, 3, net_cap=4),
                  lambda: t_cs(2, 3, net_cap=4)),
    "lab2_pb": (lambda: j_pb(2, 1, 1), lambda: t_pb(2, 1, 1)),
    "lab3_paxos": (lambda: jlab3.make_paxos_protocol(**PAXOS_KW),
                   lambda: tlab3.make_paxos_protocol(**PAXOS_KW)),
    "lab4_store_11": (lambda: jlab4.make_shardstore_protocol([1, 1]),
                      lambda: tlab4.make_shardstore_protocol([1, 1])),
}


def _reachable_rows(ts, depth, rng, keep=48):
    """Rows of the port's levels 0..depth, each level expanded by every
    grid event through ``_step_batch`` and subsampled to ``keep`` rows."""
    p = ts.p
    grid = p.net_cap + p.n_nodes * p.timer_cap
    rows = teng.flatten_state(ts.initial_state())
    levels = [rows]
    for _ in range(depth):
        succ, ok, over = ts._step_batch(
            rows.repeat_interleave(grid, 0),
            torch.arange(grid).repeat(rows.shape[0]))
        rows = torch.unique(succ[ok & (over == 0)], dim=0)
        if len(rows) > keep:
            rows = rows[torch.as_tensor(rng.choice(len(rows), keep,
                                                   replace=False))]
        levels.append(rows)
    return torch.cat(levels)


@pytest.mark.parametrize("name", sorted(STEP_TWINS))
def test_step_batch_matches_jax_vmap(name):
    """Successor rows, valid and overflow of ``_step_batch`` on 192
    (row, event) pairs drawn from a numpy seed: reachable rows (empty
    net slots among them), message and timer ids, negative ids and ids
    past the timer grid."""
    make_j, make_t = STEP_TWINS[name]
    ts = teng.TensorSearch(make_t(), chunk=16, device="cpu")
    js = jeng.TensorSearch(make_j(), chunk=16)
    rng = np.random.default_rng(11)
    rows = _reachable_rows(ts, 2, rng)
    p = ts.p
    grid = p.net_cap + p.n_nodes * p.timer_cap
    idx = rng.integers(0, len(rows), 192)
    ev = rng.integers(-3, grid + 6, 192)
    ev[:24] = p.net_cap + rng.integers(0, grid - p.net_cap, 24)   # timers
    pick = rows[torch.as_tensor(idx)]
    r_t, v_t, o_t = ts._step_batch(pick, torch.as_tensor(ev))
    r_j, v_j, o_j = jax.jit(jax.vmap(js._step_one))(
        jnp.asarray(pick.numpy()), jnp.asarray(ev, jnp.int32))
    np.testing.assert_array_equal(np.asarray(r_j), r_t.numpy())
    np.testing.assert_array_equal(np.asarray(v_j), v_t.numpy())
    np.testing.assert_array_equal(np.asarray(o_j), o_t.numpy())
    assert v_t.any() and not v_t.all()
    if name == "lab1_cap4":
        assert (o_t > 0).any()


@pytest.mark.parametrize("kw", [
    dict(walkers_per_device=16, max_steps=32),
    dict(walkers_per_device=128, max_steps=192, min_steps=10),
    dict(walkers_per_device=7, max_steps=5, temperature=(0.0, 9.0),
         kind_affinity=-1.5),
], ids=["small", "probe", "odd"])
def test_schedules_match_jax(kw):
    proto_j, proto_t = j_pp(2), t_pp(2)
    js = jsw.SwarmSearch(proto_j, mesh=make_mesh(1), **kw)
    ts = tsw.SwarmSearch(proto_t, device="cpu", **kw)
    for a, b in zip(js._schedules(), ts._schedules()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ witnesses

WITNESS_TWINS = {
    "pingpong": (lambda: violating(j_pp(2)), lambda: violating(t_pp(2))),
    "lab1": (lambda: violating(j_cs(n_clients=1, w=2)),
             lambda: violating(t_cs(n_clients=1, w=2))),
}


@pytest.fixture(scope="module", params=sorted(WITNESS_TWINS))
def jax_witness(request):
    """The JAX swarm's raw witness (seed 7, tests/test_swarm.py's
    ``_swarm``) beside both packages' searches and verdict checks."""
    make_j, make_t = WITNESS_TWINS[request.param]
    js = jsw.SwarmSearch(make_j(), mesh=make_mesh(2), walkers_per_device=16,
                         max_steps=32, steps_per_round=32, seed=7,
                         visited_cap=1 << 12)
    out = js.run()
    assert out.end_condition == "INVARIANT_VIOLATED"
    ts = tsw.SwarmSearch(make_t(), walkers_per_device=16, max_steps=32,
                         device="cpu")
    root = np.asarray(jeng.flatten_state(js.initial_state()))[0]
    np.testing.assert_array_equal(
        root, teng.flatten_state(ts.initial_state())[0].numpy())
    checks = (jsw._verdict_check(js, "INVARIANT_VIOLATED", "NOT_DONE", 0),
              tsw._verdict_check(ts, "INVARIANT_VIOLATED", "NOT_DONE", 0))
    return js, ts, root, out.witness, checks


def test_witness_pipeline_matches_jax(jax_witness, monkeypatch):
    """On the JAX swarm's raw trace: replay (final row, applied prefix),
    minimization (trace and passes, at every batch width) and the whole
    witness equal the JAX package's."""
    js, ts, root, wit, (jc, tc) = jax_witness
    raw = wit.raw_trace
    row_j, n_j = jsw.replay_events(js, root, raw)
    row_t, n_t = tsw.replay_events(ts, root, raw)
    np.testing.assert_array_equal(np.asarray(row_j), row_t)
    assert n_j == n_t == len(raw)
    assert jc(row_j) and tc(row_t)
    want = jsw.minimize_event_trace(js, root, raw, jc)
    assert want == (wit.trace, wit.minimize_passes)
    for width in (1, 3, 64):
        monkeypatch.setitem(tsw.MINIMIZE_WIDTH, "cpu", width)
        got = tsw.minimize_event_trace(ts, root, raw, tc)
        assert got == (list(want[0]), want[1]), width
    w_j = jsw.build_witness(js, root, raw, "INVARIANT_VIOLATED",
                            "NOT_DONE", 0)
    w_t = tsw.build_witness(ts, root, raw, "INVARIANT_VIOLATED",
                            "NOT_DONE", 0)
    assert dataclasses.asdict(w_j) == dataclasses.asdict(w_t)
    assert w_t.replay_verified and w_t.minimized


def test_replay_freezes_at_an_inapplicable_event(jax_witness):
    """A trace with an undeliverable event in the middle (an empty net
    slot) stops applying there in both packages: the same final row, the
    same applied prefix; minimizing it gives the same result."""
    js, ts, root, wit, (jc, tc) = jax_witness
    raw = wit.raw_trace
    mid = len(raw) // 2
    empty = ts.p.net_cap - 1
    trace = raw[:mid] + [empty] + raw[mid:] + [empty, raw[-1]]
    row_j, n_j = jsw.replay_events(js, root, trace)
    row_t, n_t = tsw.replay_events(ts, root, trace)
    np.testing.assert_array_equal(np.asarray(row_j), row_t)
    assert n_j == n_t == mid
    row_t2, _ = tsw.replay_events(ts, root, raw[:mid])
    np.testing.assert_array_equal(row_t, row_t2)
    want = jsw.minimize_event_trace(js, root, trace, jc)
    assert tsw.minimize_event_trace(ts, root, trace, tc) == (
        list(want[0]), want[1])


# --------------------------------------------------------------- walks

def _swarm(proto, **kw):
    kw.setdefault("walkers_per_device", 16)
    kw.setdefault("max_steps", 32)
    kw.setdefault("steps_per_round", 32)
    kw.setdefault("seed", 7)
    kw.setdefault("visited_cap", 1 << 12)
    return tsw.SwarmSearch(proto, device="cpu", **kw)


def _counters(o):
    return {k: v for k, v in o.swarm.items()
            if not k.endswith(("_per_sec", "_per_min"))}


def test_seeded_determinism_identical_witness():
    proto = violating(t_cs(n_clients=1, w=2))
    a = _swarm(proto).run()
    b = _swarm(proto).run()
    assert a.end_condition == b.end_condition == "INVARIANT_VIOLATED"
    assert a.witness.raw_trace == b.witness.raw_trace
    assert a.witness.trace == b.witness.trace
    assert _counters(a) == _counters(b)
    c = _swarm(proto, seed=8).run()
    assert c.end_condition == "INVARIANT_VIOLATED"


@pytest.mark.parametrize("maker", [
    lambda: violating(t_pp(2)),
    lambda: violating(t_cs(n_clients=1, w=2)),
], ids=["pingpong", "lab1"])
def test_swarm_vs_bfs_verdict_parity(maker):
    """The same verdict and predicate as the port's host BFS; the
    minimized witness replays clean and is never shorter than the BFS's
    minimal violation depth."""
    proto = maker()
    bfs = teng.TensorSearch(proto, chunk=64, use_host_visited=True,
                            device="cpu").run()
    assert bfs.end_condition == "INVARIANT_VIOLATED"
    out = _swarm(proto, max_steps=48).run()
    assert out.end_condition == bfs.end_condition
    assert out.predicate_name == bfs.predicate_name
    w = out.witness
    assert w.replay_verified and w.minimized
    assert bfs.depth <= len(w.trace) <= len(w.raw_trace)
    assert out.depth == len(w.raw_trace)


def test_lock_witness_is_exactly_k_events():
    """The deep-narrow lock: the minimized witness is the true minimal
    one, k correct digits, and replays to progress k."""
    proto = make_lock_protocol(m=6, k=9, noise_bits=16)
    sw = _swarm(proto, max_steps=96, steps_per_round=64, seed=0)
    out = sw.run()
    assert out.end_condition == "INVARIANT_VIOLATED"
    assert out.predicate_name == "LOCK_HELD"
    assert len(out.witness.trace) == 9 < len(out.witness.raw_trace)
    root = teng.flatten_state(sw.initial_state())[0].numpy()
    row, applied = tsw.replay_events(sw, root, out.witness.trace)
    assert applied == 9 and int(row[0]) == 9


def test_witness_trace_decodes_and_replays():
    """The witness rides the tpu/trace.py contract: the minimized ids
    decode to concrete records, and re-applying them from the walk root
    reproduces the violation; ``random_rollouts`` is the same walker."""
    proto = violating(t_pp(2))
    sw = _swarm(proto)
    out = sw.run()
    recs = decode_trace(sw, out)
    assert len(recs) == len(out.witness.trace)
    root = teng.flatten_state(
        {k: torch.as_tensor(v) for k, v in sw._trace_root.items()})[0]
    row, applied = tsw.replay_events(sw, root.numpy(), out.witness.trace)
    assert applied == len(out.witness.trace)
    end = sw.unflatten_rows(torch.as_tensor(row)[None])
    assert not bool(proto.invariants["NOT_DONE"](end)[0])
    ts = teng.TensorSearch(proto, chunk=16, device="cpu")
    ro = ts.random_rollouts(n_walkers=16, n_steps=32, seed=7)
    assert ro.end_condition == "INVARIANT_VIOLATED"
    assert ro.witness.replay_verified
    assert len(decode_trace(ts, ro)) == len(ro.witness.trace)


def test_walker_overflow_counted_and_warned():
    """A capacity-truncated walker step restarts loudly: counted on
    ``swarm_overflow`` (with ``walker_restarts``) and warned about; a
    strict swarm raises instead."""
    proto = violating(t_cs(n_clients=2, w=3, net_cap=4))
    sw = _swarm(proto, max_steps=48, steps_per_round=48, max_rounds=2)
    with pytest.warns(RuntimeWarning, match="capacity-truncated"):
        out = sw.run()
    assert out.swarm_overflow > 0
    assert out.walker_restarts > 0
    assert out.swarm["overflow_restarts"] == out.swarm_overflow
    strict = _swarm(proto, max_steps=48, steps_per_round=48, max_rounds=2,
                    strict=True)
    with pytest.raises(teng.CapacityOverflow):
        strict.run()


@pytest.mark.parametrize("kw,slice_name", [
    (dict(frontier_seed="bfs.npz"), None),
    (dict(checkpoint_path="swarm.npz", checkpoint_every=1), None),
    (dict(mesh=["cpu", "cuda:0"]), "inside its ranks"),
    (dict(mesh=["cuda:0", "cuda:1"]), "inside its ranks"),
    (dict(telemetry=True), None),
], ids=["frontier_seed", "checkpoint", "mesh", "mesh_devices",
        "telemetry"])
def test_unported_options_raise_naming_their_slice(kw, slice_name,
                                                   tmp_path):
    """A mesh over two distinct devices (a RankMesh) builds no swarm
    outside its ranks, and says where it runs (one group per rank:
    tests/test_torch_ranks.py; a mesh of groups on one device runs:
    tests/test_torch_swarm_mesh.py); the options the spill + checkpoint
    slice ported (``frontier_seed``, round checkpoints) and
    ``telemetry`` (the telemetry and tracing slice: one round record)
    build and run."""
    if slice_name is not None:
        with pytest.raises(RuntimeError, match=slice_name):
            tsw.SwarmSearch(t_pp(2), device="cpu", **kw)
        return
    proto = _goal_pruned(t_pp(2))
    if "frontier_seed" in kw:
        kw = {"frontier_seed": _bfs_dump(proto, tmp_path)}
    elif "telemetry" in kw:
        from dslabs_tpu_torch.tpu.telemetry import Telemetry

        kw = {"telemetry": Telemetry()}
    else:
        kw = {**kw, "checkpoint_path": str(tmp_path / kw["checkpoint_path"])}
    out = _swarm(proto, max_rounds=1, **kw).run()
    assert out.end_condition == "TIME_EXHAUSTED"
    if "telemetry" in kw:
        assert [r["depth"] for r in kw["telemetry"].levels] == [1]
    assert out.swarm["rounds"] == 1 and out.resumed_from_depth == 0
    if "checkpoint_path" in kw:
        assert tck.peek_depth(kw["checkpoint_path"]) == 1


def _goal_pruned(p):
    """No reachable violation (the goal pruned away), so rounds run to
    their cap and checkpoints land (tests/test_swarm.py:246)."""
    return dataclasses.replace(
        p, goals={}, prunes={"CLIENTS_DONE": p.goals["CLIENTS_DONE"]})


def _bfs_dump(proto, tmp_path, depth=2, name="bfs.npz"):
    pth = str(tmp_path / name)
    teng.TensorSearch(proto, chunk=64, max_depth=depth, checkpoint_path=pth,
                      checkpoint_every=1, device="cpu").run()
    assert tck.peek_depth(pth) == depth
    return pth


# ------------------------------------------ frontier seeding, checkpoints

def _seed_check(pth, proto, seeded):
    """The seeded fleet's pool is the dump's frontier and its table holds
    exactly the dump's keys before the first step (the fleet is one
    group: its pool and table are group 0's)."""
    ck = tck.load(pth, tck.config_fingerprint(proto, True))
    sw = _swarm(proto, frontier_seed=pth, max_rounds=0)
    state = sw._initial_or(None)
    carry = sw._init_carry(state)
    assert sw.preseeded_keys == len(ck.visited_keys) > 1
    np.testing.assert_array_equal(carry["seeds"][0].numpy(), ck.frontier)
    np.testing.assert_array_equal(
        np.sort(visited_mod.host_occupied(carry["visited"][0]), axis=0),
        np.sort(ck.visited_keys, axis=0))
    assert seeded.end_condition == "TIME_EXHAUSTED"
    assert seeded.swarm["vis_over"] == 0 and seeded.unique_states > 0


def test_frontier_seeding_from_a_port_bfs_dump(tmp_path):
    """tests/test_swarm.py:181 on the port: a fleet seeded from a mid-BFS
    dump re-treads covered states at a lower rate than a root-started
    one (the lock protocol's funnel)."""
    proto = make_lock_protocol(m=6, k=10 ** 6, noise_bits=16)
    pth = _bfs_dump(proto, tmp_path, depth=4)
    kw = dict(walkers_per_device=16, max_steps=40, steps_per_round=40,
              max_rounds=1, seed=5)
    rooted = _swarm(proto, **kw).run()
    seeded = _swarm(proto, frontier_seed=pth, **kw).run()
    _seed_check(pth, proto, seeded)

    def rate(o):
        return o.swarm["revisits"] / max(o.swarm["explored"], 1)

    assert rate(seeded) < rate(rooted)


def test_frontier_seeding_from_a_jax_bfs_dump(tmp_path):
    """A BFS dump of the JAX package seeds the port's swarm: the same
    pool and pre-seeded key set as the port's own dump of that level."""
    pth = str(tmp_path / "jax_bfs.npz")
    jeng.TensorSearch(_goal_pruned(j_pp(3)), chunk=64, max_depth=3,
                      checkpoint_path=pth, checkpoint_every=1).run()
    proto = _goal_pruned(t_pp(3))
    own = _bfs_dump(proto, tmp_path, depth=3, name="port_bfs.npz")
    fp = tck.config_fingerprint(proto, True)
    a, b = tck.load(pth, fp), tck.load(own, fp)
    np.testing.assert_array_equal(np.sort(a.visited_keys, axis=0),
                                  np.sort(b.visited_keys, axis=0))
    seeded = _swarm(proto, frontier_seed=pth, max_rounds=1).run()
    _seed_check(pth, proto, seeded)
    again = _swarm(proto, frontier_seed=own, max_rounds=1).run()
    assert again.swarm == {**seeded.swarm,
                           "walkers_per_sec": again.swarm["walkers_per_sec"],
                           "unique_per_min": again.swarm["unique_per_min"]}


def test_cut_and_resume_is_an_identical_continuation(tmp_path):
    """A frontier-seeded swarm cut after round 1 (which does not hit)
    and resumed from its round checkpoint equals the uncut run: verdict,
    raw and minimized witness, counters."""
    proto = violating(t_pp(3))
    kw = dict(walkers_per_device=8, max_steps=24, steps_per_round=2,
              seed=3, frontier_seed=_bfs_dump(proto, tmp_path))
    full = _swarm(proto, **kw).run()
    assert full.end_condition == "INVARIANT_VIOLATED"
    assert full.swarm["rounds"] > 1
    sw_ck = str(tmp_path / "swarm.npz")
    cut = _swarm(proto, max_rounds=1, checkpoint_path=sw_ck,
                 checkpoint_every=1, **kw).run()
    assert cut.end_condition == "TIME_EXHAUSTED"
    assert tck.peek_depth(sw_ck) == 1
    out = _swarm(proto, checkpoint_path=sw_ck, **kw).run(resume=True)
    assert out.end_condition == full.end_condition
    assert out.witness.raw_trace == full.witness.raw_trace
    assert out.witness.trace == full.witness.trace
    for k in ("explored", "unique", "revisits", "restarts", "deepest",
              "rounds"):
        assert out.swarm[k] == full.swarm[k], k
    assert out.resumed_from_depth == 1


def test_swarm_checkpoint_not_resumable_by_bfs(tmp_path):
    """tests/test_swarm.py:246 on the port."""
    proto = _goal_pruned(t_pp(2))
    sw_ck = str(tmp_path / "swarm.npz")
    _swarm(proto, max_rounds=1, checkpoint_path=sw_ck,
           checkpoint_every=1).run()
    bfs = teng.TensorSearch(proto, chunk=64, checkpoint_path=sw_ck,
                            device="cpu")
    assert not bfs.has_resumable_checkpoint()
    with pytest.raises(tck.CheckpointMismatch):
        bfs.run(resume=True)


def test_jax_swarm_checkpoint_refused_by_the_port(tmp_path):
    """A JAX swarm dump holds ``jax.random`` keys: the port's swarm
    refuses it (fingerprint marker) instead of half-resuming it."""
    sw_ck = str(tmp_path / "jax_swarm.npz")
    jsw.SwarmSearch(_goal_pruned(j_pp(2)), mesh=make_mesh(1),
                    walkers_per_device=16, max_steps=32, steps_per_round=32,
                    seed=7, visited_cap=1 << 12, max_rounds=1,
                    checkpoint_path=sw_ck, checkpoint_every=1).run()
    assert tck.peek_depth(sw_ck) == 1
    port = _swarm(_goal_pruned(t_pp(2)), checkpoint_path=sw_ck)
    assert not port.has_resumable_checkpoint()
    with pytest.raises(tck.CheckpointMismatch):
        port.run(resume=True)


def test_swarm_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsw.SwarmSearch(t_pp(2))
