"""PyTorch port, the fault plane (``dslabs_tpu_torch/tpu/faults.py`` and the
fault segment of ``tpu/engine.py``, ``tpu/trace.py`` and ``tpu/swarm.py``)
against the JAX package on the CPU, exact equality (everything is
integer):

- the compiled ``FaultLanes`` field by field for every fault spec of the
  repo and for a ``paxos_spec(3)`` model that declares all four families
  (partition, crash, ``max_drops=1``, ``max_dups=1``);
- the batched ``_flt_step``, ``_fault_event_grid`` and the masked event
  tables against ``jax.vmap`` of the JAX one-row functions on seeded
  reachable rows with scrambled controller lanes, for every fault event
  id; ``_step_batch`` against ``jax.vmap(_step_one)`` over the whole grid;
- the reference's pins on both loops (the device loop and ``run_host``):
  the partition scenario 3416 / 564 / 13 with 320 partition events
  (tests/test_scenarios.py), the zero-budget model equal to the plain
  spec (1548 / 202 / 11), ``make_paxos_partition_spec(3)`` 32 / 64 / 7 and
  133 / 328 / 31 at depths 2 / 3, ``make_shardstore_crash_spec([1, 1])``
  30 / 43 / 7 and 103 / 200 / 29 (tests/test_spec_parity.py), and the
  all-families model against a live JAX search;
- the broken-quorum, NO_HEAL and NO_CRASH witnesses decoded with their
  fault labels, the object replay's refusal of a fault trace, and the
  swarm's NO_HEAL witness minimized to ``[CUT, HEAL]``;
- ``validate_fault``'s red fixtures raise the reference's texts."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from dslabs_tpu.tpu import compiler as jcomp  # noqa: E402
from dslabs_tpu.tpu import engine as jeng  # noqa: E402
from dslabs_tpu.tpu import faults as jfaults  # noqa: E402
from dslabs_tpu.tpu import packing as jpack  # noqa: E402
from dslabs_tpu.tpu import specs as jspecs  # noqa: E402
from dslabs_tpu.tpu import specs_lab3 as jlab3  # noqa: E402
from dslabs_tpu.tpu import specs_lab4 as jlab4  # noqa: E402
from dslabs_tpu_torch.tpu import compiler as tcomp  # noqa: E402
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.tpu import faults as tfaults  # noqa: E402
from dslabs_tpu_torch.tpu import packing as tpack  # noqa: E402
from dslabs_tpu_torch.tpu import specs as tspecs  # noqa: E402
from dslabs_tpu_torch.tpu import specs_lab3 as tlab3  # noqa: E402
from dslabs_tpu_torch.tpu import specs_lab4 as tlab4  # noqa: E402
from dslabs_tpu_torch.tpu import trace as ttrace  # noqa: E402
from dslabs_tpu_torch.tpu.swarm import SwarmSearch  # noqa: E402

JAX_MODS = (jspecs, jlab3, jlab4, jfaults)
PORT_MODS = (tspecs, tlab3, tlab4, tfaults)
KW = dict(chunk=64, frontier_cap=1 << 13, visited_cap=1 << 16)
# bench.py's flagship configuration (the fault flagship adds the partition).
FLAGSHIP_KW = dict(n=3, n_clients=2, w=1, max_slots=3, net_cap=64,
                   timer_cap=6)


def _all_families(m):
    """paxos_spec(3) under a model that declares every fault family."""
    f = m[3]
    return m[0].paxos_spec(3, fault=f.FaultModel(
        partition=f.Partition(blocks=(("proposer",), ("acceptor",))),
        crash=f.Crash(durable={"acceptor": ("bal",)}),
        max_drops=1, max_dups=1))


# id -> function of (specs, specs_lab3, specs_lab4, faults) giving a spec
# with a fault model, called with either package's modules.
SPECS = {
    "paxos_partition": lambda m: m[0].paxos_partition_spec(3),
    "paxos_partition_broken":
        lambda m: m[0].paxos_partition_spec(3, broken=True),
    "pb_crash": lambda m: m[0].pb_crash_spec(),
    "lab3_partition": lambda m: m[1].make_paxos_partition_spec(3),
    "lab4_crash": lambda m: m[2].make_shardstore_crash_spec([1, 1]),
    "all_families": _all_families,
}
# The specs whose full grid is stepped against jax.vmap(_step_one): every
# family's masks and steps, and a crash with timers (the lab twins' JAX
# compile of the whole step costs tens of seconds).
SMALL = ("pb_crash", "all_families")


def _pruned(p):
    """Goals moved to prunes, invariants live: the scenario-count
    discipline of tests/test_scenarios.py."""
    return dataclasses.replace(p, goals={}, prunes=dict(p.goals),
                               invariants=dict(p.invariants))


def _key(out):
    return (out.end_condition, out.unique_states, out.states_explored,
            out.depth)


def _port(p, **kw):
    return teng.TensorSearch(p, device="cpu", **kw)


def _both_loops(p, **kw):
    """The device loop and run_host on the same protocol."""
    return [_port(p, use_host_visited=host, **kw).run()
            for host in (False, True)]


def _eq(ref, port):
    ref = np.asarray(ref)
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    assert ref.shape == port.shape, (ref.shape, port.shape)
    assert (ref.astype(np.int64) == port.astype(np.int64)).all()


# ----------------------------------------------------- compiled descriptor

@pytest.mark.parametrize("name", sorted(SPECS))
def test_fault_lanes_match_jax(name):
    """The compiled FaultLanes, field by field, and the protocol around
    it (node count with the controller, layout, lane domains)."""
    sj, st = SPECS[name](JAX_MODS), SPECS[name](PORT_MODS)
    assert [k.name for k in st.nodes] == [k.name for k in sj.nodes]
    assert st.nodes[-1].name == tfaults.FAULT_KIND
    assert st._layout() == sj._layout()
    pj, pt = sj.compile(), st.compile()
    assert (pt.n_nodes, pt.node_width) == (pj.n_nodes, pj.node_width)
    assert pt.lane_domains == pj.lane_domains
    fj, ft = pj.fault, pt.fault
    assert isinstance(ft, tfaults.FaultLanes)
    for f in dataclasses.fields(fj):
        a, b = getattr(fj, f.name), getattr(ft, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        elif f.name == "model":
            assert repr(a) == repr(b)
        else:
            assert a == b, (f.name, a, b)
    for prop in ("has_partition", "n_crashable", "seg_cut", "seg_heal",
                 "seg_crash", "seg_restart", "seg_drop", "seg_dup",
                 "n_events"):
        assert getattr(ft, prop) == getattr(fj, prop), prop
    assert [ft.event_label(i) for i in range(ft.n_events)] == \
        [fj.event_label(i) for i in range(fj.n_events)]
    assert ft.signature() == fj.signature()
    with pytest.raises(IndexError) as ej:
        fj.event_label(fj.n_events)
    with pytest.raises(IndexError) as et:
        ft.event_label(ft.n_events)
    assert str(et.value) == str(ej.value)


def test_fault_flagship_packs_like_jax():
    """The partitioned flagship's controller lanes pack as ordinary
    declared-domain lanes: the packing descriptor equals the JAX one, and
    a packed search to depth 2 equals the unpacked one."""
    pj = jlab3.make_paxos_partition_spec(**FLAGSHIP_KW).compile()
    pt = tlab3.make_paxos_partition_spec(**FLAGSHIP_KW).compile()
    ts = _port(pt, chunk=8)
    kj, kt = (jpack.derive_packing(pj, ts.lanes),
              tpack.derive_packing(pt, ts.lanes))
    assert (kt.lanes, kt.words) == (kj.lanes, kj.words)
    assert kt.signature() == kj.signature()
    assert ts.plane == kt.words < ts.lanes
    p = dataclasses.replace(pt, goals={})
    a, b = (_port(p, chunk=32, max_depth=2, packed=pk).run()
            for pk in (True, False))
    assert _key(a) == _key(b) and a.partition_events == b.partition_events


def test_fault_controller_is_hidden_last_node():
    """The controller is appended last and the partition-only segment is
    CUT + HEAL; a spec with no model carries no descriptor."""
    spec = tspecs.paxos_spec(3, fault=tfaults.FaultModel(
        partition=tfaults.Partition(blocks=(("proposer",),
                                            ("acceptor",)))))
    proto = spec.compile()
    assert spec.nodes[-1].name == "$fault"
    assert proto.fault.n_events == 2
    assert [proto.fault.event_label(i) for i in (0, 1)] == ["CUT", "HEAL"]
    assert tspecs.paxos_spec(3).compile().fault is None
    ts = _port(proto, chunk=8)
    assert ts._ev_slots == (proto.net_cap + proto.n_nodes
                            * proto.timer_cap + 2)


# ------------------------------------------ batched steps against jax.vmap

def _reachable(ts, rng, depth=3, keep=24):
    """Rows of levels 0..depth of ``ts``'s twin, each level expanded by
    every grid event through ``_step_batch`` and subsampled by ``rng``."""
    p = ts.p
    grid = p.net_cap + p.n_nodes * p.timer_cap + ts._ev_flt
    rows = teng.flatten_state(ts.initial_state())
    levels = [rows]
    for _ in range(depth):
        succ, ok, over = ts._step_batch(
            rows.repeat_interleave(grid, 0),
            torch.arange(grid).repeat(rows.shape[0]))
        rows = torch.unique(succ[ok & (over == 0)], dim=0)
        if len(rows) > keep:
            rows = rows[torch.from_numpy(
                rng.choice(len(rows), keep, replace=False))]
        levels.append(rows)
    return torch.cat(levels)


def _scrambled(ts, rows, rng):
    """``rows`` and a copy whose controller lanes take random values of
    their domains: cuts up, nodes down, budgets spent, so every mask and
    guard of the fault plane sees both sides."""
    fl = ts.p.fault
    dirty = rows.clone()
    n = len(rows)
    lanes = []
    if fl.has_partition:
        lanes += [(fl.pcut_off, 1),
                  (fl.eras_off, max(fl.model.partition.max_eras, 1))]
    if fl.n_crashable:
        lanes += [(int(o), 1) for o in fl.down_off if o >= 0]
        lanes.append((fl.crashes_off, fl.model.crash.max_crashes))
    if fl.model.max_drops:
        lanes.append((fl.drops_off, fl.model.max_drops))
    if fl.model.max_dups:
        lanes.append((fl.dups_off, fl.model.max_dups))
    for off, hi in lanes:
        dirty[:, off] = torch.from_numpy(
            rng.integers(0, hi + 1, n).astype(np.int32))
    return torch.cat([rows, dirty])


@pytest.fixture(scope="module")
def stepped():
    """name -> (JAX search, port search, seeded rows [N, lanes])."""
    out = {}
    for i, name in enumerate(sorted(SPECS)):
        rng = np.random.default_rng(19 + i)
        pj = SPECS[name](JAX_MODS).compile()
        pt = SPECS[name](PORT_MODS).compile()
        ts = _port(pt, chunk=8)
        js = jeng.TensorSearch(pj, chunk=8)
        keep = 24 if name in SMALL else 8
        rows = _scrambled(ts, _reachable(ts, rng, keep=keep), rng)
        out[name] = (js, ts, rows)
    return out


@pytest.mark.parametrize("name", sorted(SPECS))
def test_fault_steps_and_tables_match_jax(stepped, name):
    """Every fault event id on every seeded row: ``_flt_step`` against
    ``jax.vmap(_flt_step)``; the fault event grid and the masked event
    tables (message, timer and fault ids, remaining count) against the
    JAX functions on the same chunk."""
    js, ts, rows = stepped[name]
    fl = ts.p.fault
    n, nf = len(rows), fl.n_events
    rep = rows.repeat_interleave(nf, 0)
    f = torch.arange(nf).repeat(n)
    r_j, ok_j, over_j = jax.vmap(js._flt_step)(jnp.asarray(rep.numpy()),
                                               jnp.asarray(f.numpy()))
    r_t, ok_t, over_t = ts._flt_step(rep, f)
    _eq(r_j, r_t)
    _eq(ok_j, ok_t)
    _eq(over_j, over_t)
    assert 0 < int(ok_t.sum()) < len(f)
    cs_t = ts.unflatten_rows(rows)
    _eq(js._fault_event_grid(js.unflatten_rows(jnp.asarray(rows.numpy()))),
        ts._fault_event_grid(cs_t["nodes"], cs_t["net"]))
    valid = np.ones(n, bool)
    valid[-3:] = False
    got_j = js._event_tables(jnp.asarray(rows.numpy()), jnp.asarray(valid))
    got_t = ts._event_tables(rows, torch.from_numpy(valid))
    for a, b in zip(got_j, got_t):
        _eq(a, b)


@pytest.mark.parametrize("name", SMALL)
def test_step_batch_over_the_grid_matches_jax(stepped, name):
    """``_step_batch`` against ``jax.vmap(_step_one)`` for every grid id
    (message, timer and fault) on every seeded row: the fault masks of the
    message and timer steps and the fault half."""
    js, ts, rows = stepped[name]
    p = ts.p
    grid = p.net_cap + p.n_nodes * p.timer_cap + ts._ev_flt
    rep = rows.repeat_interleave(grid, 0)
    ev = torch.arange(grid).repeat(len(rows))
    r_j, ok_j, over_j = jax.vmap(js._step_one)(jnp.asarray(rep.numpy()),
                                               jnp.asarray(ev.numpy()))
    r_t, ok_t, over_t = ts._step_batch(rep, ev)
    _eq(r_j, r_t)
    _eq(ok_j, ok_t)
    _eq(over_j, over_t)
    # The one-row step agrees on a sample of the fault ids.
    base = p.net_cap + p.n_nodes * p.timer_cap
    for i in range(0, len(rep), 97):
        if int(ev[i]) >= base:
            r1, v1, o1 = ts._step_one(rep[i], int(ev[i]))
            assert torch.equal(r1, r_t[i]) and bool(v1) == bool(ok_t[i])
    with pytest.raises(ValueError, match="outside the event grid"):
        ts._step_one(rows[0], grid)


def test_pb_crash_volatile_wiped_durable_kept():
    """A CRASH resets the crashed node's volatile lanes to their inits and
    leaves its durable ``amo`` lanes (and every other lane) alone, checked
    on a deliberately dirtied row as tests/test_scenarios.py does."""
    pt = tspecs.pb_crash_spec().compile()
    ts = _port(pt, chunk=8)
    fl = pt.fault
    row = teng.flatten_state(ts.initial_state())[0]
    wipe = fl.wipe[0]
    assert wipe.any() and (~wipe).any()
    dirty = row.clone()
    dirty[:fl.node_width][torch.from_numpy(wipe)] = 7
    ev = pt.net_cap + pt.n_nodes * pt.timer_cap + fl.seg_crash
    succ, ok, _ = ts._step_one(dirty, ev)
    assert bool(ok)
    expected = dirty[:fl.node_width].clone().numpy()
    expected[wipe] = fl.init_vec[wipe]
    expected[int(fl.down_off[int(fl.crash_nodes[0])])] = 1
    expected[fl.crashes_off] += 1
    _eq(expected, succ[:fl.node_width])
    assert torch.equal(succ[fl.node_width:-1], dirty[fl.node_width:-1])
    out = _port(_pruned(pt), chunk=64, max_depth=4).run()
    assert out.crash_events > 0
    assert out.fault_events == out.crash_events


# ------------------------------------------------------------------- pins

def test_partition_scenario_pinned_on_both_loops():
    """paxos_partition_spec(3), goal pruned: SPACE_EXHAUSTED 3416 / 564 /
    13 with 320 partition events, on both loops, packed and unpacked."""
    p = _pruned(tspecs.paxos_partition_spec(3).compile())
    outs = _both_loops(p, **KW) + [_port(p, packed=False, **KW).run()]
    for out in outs:
        assert _key(out) == ("SPACE_EXHAUSTED", 564, 3416, 13)
        assert out.partition_events == out.fault_events == 320
        assert out.crash_events == out.drop_events == out.dup_events == 0


def test_zero_budget_model_is_the_plain_spec():
    """A declared zero-budget partition adds lanes and no valid fault
    event: the plain spec's exact counts, every fault counter zero."""
    fm0 = tfaults.FaultModel(partition=tfaults.Partition(
        blocks=(("proposer",), ("acceptor",)), max_eras=0))
    p = _pruned(tspecs.paxos_spec(3, fault=fm0).compile())
    plain = _port(_pruned(tspecs.paxos_spec(3).compile()), **KW).run()
    assert _key(plain) == ("SPACE_EXHAUSTED", 202, 1548, 11)
    assert plain.fault_events == 0
    for out in _both_loops(p, **KW):
        assert _key(out) == _key(plain)
        assert (out.fault_events, out.partition_events, out.crash_events,
                out.drop_events, out.dup_events) == (0, 0, 0, 0, 0)


@pytest.mark.parametrize("name,depth,pin,family", [
    ("lab3_partition", 2, (32, 64, 7), "partition_events"),
    ("lab3_partition", 3, (133, 328, 31), "partition_events"),
    ("lab4_crash", 2, (30, 43, 7), "crash_events"),
    ("lab4_crash", 3, (103, 200, 29), "crash_events"),
])
def test_generated_twin_fault_pins_on_both_loops(name, depth, pin, family):
    """tests/test_spec_parity.py's bounded-depth pins of the lab 3
    partition and lab 4 crash scenarios (unique / explored / fault
    events), on both loops."""
    p = _pruned(SPECS[name](PORT_MODS).compile())
    for out in _both_loops(p, chunk=32, max_depth=depth):
        assert out.end_condition == "DEPTH_EXHAUSTED"
        assert (out.unique_states, out.states_explored,
                getattr(out, family)) == pin
        assert out.fault_events == pin[2]


def test_all_families_match_a_live_jax_search():
    """No spec of the repo declares drops or dups: the all-families model
    is held against the JAX search at depth 4, every count and family
    counter equal, on both of the port's loops."""
    kw = dict(chunk=64, max_depth=4, visited_cap=1 << 14)
    ref = jeng.TensorSearch(_pruned(_all_families(JAX_MODS).compile()),
                            **kw).run()
    assert ref.drop_events > 0 and ref.dup_events > 0
    assert ref.crash_events > 0 and ref.partition_events > 0
    p = _pruned(_all_families(PORT_MODS).compile())
    for out in _both_loops(p, **kw):
        assert _key(out) == _key(ref)
        assert (out.partition_events, out.crash_events, out.drop_events,
                out.dup_events, out.fault_events) == (
            ref.partition_events, ref.crash_events, ref.drop_events,
            ref.dup_events, ref.fault_events)


# -------------------------------------------------------------- witnesses

def test_broken_quorum_witness_names_the_heal():
    """quorum=1 with an initial cut: the violation is reachable only after
    HEAL, at depth 5, with the reference's trace ``[HEAL, PREPARE,
    PROMISE, ACCEPT, ACCEPTED]``; the object replay refuses the fault
    event with the reference's text."""
    spec = tspecs.paxos_partition_spec(3, broken=True)
    search = _port(spec.compile(), record_trace=True, **KW)
    out = search.run()
    assert (out.end_condition, out.predicate_name, out.depth) == (
        "INVARIANT_VIOLATED", "DECIDE_HAS_QUORUM", 5)
    records = ttrace.decode_trace(search, out)
    assert [k for k, _ in records] == ["fault"] + ["message"] * 4
    assert records[0][1] == ("HEAL",)
    assert [int(a[0][0]) for _, a in records[1:]] == [
        spec._mtag[m] for m in ("PREPARE", "PROMISE", "ACCEPT", "ACCEPTED")]
    search.p = dataclasses.replace(
        search.p, decode_message=lambda rec: None,
        decode_timer=lambda node, rec: None)
    with pytest.raises(NotImplementedError, match="fault event 'HEAL'"):
        ttrace.replay_on_object(search, out, None)


def _no_heal(mods):
    spec = mods[1].make_paxos_partition_spec(3)
    spec.invariants["NO_HEAL"] = lambda v: ~(
        (v.get("$fault", 0, "pcut") == 0)
        & (v.get("$fault", 0, "eras") == 1))
    return dataclasses.replace(spec.compile(), goals={})


def _no_crash(mods):
    spec = mods[2].make_shardstore_crash_spec([1, 1])
    spec.invariants["NO_CRASH"] = \
        lambda v: v.get("$fault", 0, "crashes") == 0
    return dataclasses.replace(spec.compile(), goals={})


@pytest.mark.parametrize("make,pred,depth,labels", [
    (_no_heal, "NO_HEAL", 2, ["CUT", "HEAL"]),
    (_no_crash, "NO_CRASH", 1, ["CRASH(server[0])"]),
], ids=["no_heal", "no_crash"])
def test_generated_twin_witnesses_name_the_fault(make, pred, depth, labels):
    """The falsifiable NO_HEAL / NO_CRASH invariants of
    tests/test_spec_parity.py: witnesses at depths 2 and 1 whose decoded
    traces name the fault events, on both loops' verdicts."""
    p = make(PORT_MODS)
    search = _port(p, chunk=32, record_trace=True, max_depth=depth + 2)
    out = search.run()
    assert (out.end_condition, out.predicate_name, out.depth) == (
        "INVARIANT_VIOLATED", pred, depth)
    records = ttrace.decode_trace(search, out)
    assert [a[0] for k, a in records] == labels
    assert all(k == "fault" for k, _ in records)
    dev = _port(p, chunk=32, max_depth=depth + 2).run()
    assert (dev.end_condition, dev.predicate_name, dev.depth) == (
        "INVARIANT_VIOLATED", pred, depth)


def test_swarm_no_heal_witness_minimizes_to_cut_heal():
    """A swarm on the NO_HEAL twin walks the fault segment, finds the
    violation, and minimizes its witness to ``[CUT, HEAL]``, replayed
    through ``_step_batch``."""
    p = _no_heal(PORT_MODS)
    sw = SwarmSearch(p, walkers_per_device=16, max_steps=16, seed=3,
                     max_secs=120, device="cpu")
    out = sw.run()
    assert (out.end_condition, out.predicate_name) == (
        "INVARIANT_VIOLATED", "NO_HEAL")
    base = p.net_cap + p.n_nodes * p.timer_cap
    w = out.witness
    assert w.replay_verified
    assert list(w.trace) == [base, base + 1]
    assert len(w.raw_trace) >= 2
    assert [a[0] for _, a in ttrace.decode_trace(sw, out)] == ["CUT",
                                                                "HEAL"]


# ----------------------------------------------------------- compile gate

def _red(mods, **fm):
    f = mods[3]
    model = {
        "unknown_kind": lambda: f.FaultModel(partition=f.Partition(
            blocks=(("proposer",), ("nonesuch",)))),
        "split_symmetry": lambda: f.FaultModel(partition=f.Partition(
            blocks=((("acceptor", 0),), (("acceptor", 1),
                                         ("acceptor", 2))))),
        "initial_cut": lambda: f.FaultModel(partition=f.Partition(
            blocks=(("proposer",), ("acceptor",)), max_eras=0,
            initial_cut=True)),
        "durable_field": lambda: f.FaultModel(crash=f.Crash(
            durable={"acceptor": ("nonesuch",)})),
        "one_block": lambda: f.FaultModel(partition=f.Partition(
            blocks=(("acceptor",),))),
        "negative_budget": lambda: f.FaultModel(max_drops=-1),
        "negative_eras": lambda: f.FaultModel(partition=f.Partition(
            blocks=(("proposer",), ("acceptor",)), max_eras=-1)),
        "index_range": lambda: f.FaultModel(partition=f.Partition(
            blocks=(("proposer",), (("acceptor", 3),)))),
        "two_blocks": lambda: f.FaultModel(partition=f.Partition(
            blocks=(("acceptor",), (("acceptor", 1),)))),
        "crash_unknown_kind": lambda: f.FaultModel(crash=f.Crash(
            durable={"nonesuch": ()})),
        "negative_crashes": lambda: f.FaultModel(crash=f.Crash(
            durable={"acceptor": ()}, max_crashes=-1)),
    }[fm["case"]]()
    return mods[0].paxos_spec(3, fault=model)


@pytest.mark.parametrize("case,match", [
    ("unknown_kind", "unknown node kind"),
    ("split_symmetry", "symmetry group"),
    ("initial_cut", "initial_cut"),
    ("durable_field", "not declared"),
    ("one_block", ">= 2 blocks"),
    ("negative_budget", ">= 0"),
    ("negative_eras", "max_eras must be >= 0"),
    ("index_range", "out of range"),
    ("two_blocks", "appears in partition blocks"),
    ("crash_unknown_kind", "unknown node kind"),
    ("negative_crashes", "max_crashes must be >= 0"),
])
def test_fault_model_red_fixtures_match_jax(case, match):
    """Misdeclared fault models die at the compile gate with the
    reference's SpecError text, code and kind (tests/test_scenarios.py's
    fixtures and the rest of ``validate_fault``'s refusals)."""
    with pytest.raises(jcomp.SpecError, match=match) as ej:
        _red(JAX_MODS, case=case).compile()
    with pytest.raises(tcomp.SpecError, match=match) as et:
        _red(PORT_MODS, case=case).compile()
    assert str(et.value) == str(ej.value)
    assert (et.value.kind, et.value.field, et.value.code) == (
        ej.value.kind, ej.value.field, ej.value.code)


def test_handler_on_the_controller_is_refused_like_jax():
    """No handler may be registered on the ``$fault`` kind (C6)."""
    errs = []
    for mods, comp in ((JAX_MODS, jcomp), (PORT_MODS, tcomp)):
        spec = mods[0].paxos_partition_spec(3)
        spec.handlers[("$fault", "PREPARE")] = lambda ctx, m: None
        with pytest.raises(comp.SpecError, match="fault controller") as e:
            spec.compile()
        errs.append(e.value)
    assert str(errs[0]) == str(errs[1])
    assert errs[0].code == errs[1].code == "C6"
