"""PyTorch port, the protocol spec compiler
(``dslabs_tpu_torch/tpu/compiler.py``, ``slots.py``, ``quorum.py``,
``specs.py``, ``specs_lab3.py``) against the JAX package on the CPU,
exact equality (everything is integer):

- the compiled twins' batched ``step_message`` / ``step_timer`` against
  ``jax.vmap`` of the JAX twins on seeded random rows, SENTINEL rows and
  out-of-range per-pair indices included;
- the predicates over ``_View`` and the quorum reducers on batches;
- the compile gates raise the same ``SpecError`` text;
- whole searches of the generated twins, held against the port's hand
  twins and the JAX package's pinned counts: generated Paxos n3-c1-s2
  6 / 25 / 102 (tests/test_spec_parity.py), plain ``paxos_spec(3)`` with
  its goal moved to a prune SPACE_EXHAUSTED 1548 explored / 202 unique /
  depth 11 (tests/test_scenarios.py), and the compiled flagship of
  bench.py 38 unique / 98 explored at depth 2 (the JAX hand twin's
  count, equal for the compiled twin)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores, and
# torch's default of one thread per core oversubscribes them, which slows
# the other workers' time-limited searches past their limits.
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from dslabs_tpu.tpu import compiler as jcomp  # noqa: E402
from dslabs_tpu.tpu import quorum as jquorum  # noqa: E402
from dslabs_tpu.tpu import slots as jslots  # noqa: E402
from dslabs_tpu.tpu import specs as jspecs  # noqa: E402
from dslabs_tpu.tpu import specs_lab3 as jlab3  # noqa: E402
from dslabs_tpu_torch.tpu import compiler as tcomp  # noqa: E402
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.tpu import quorum as tquorum  # noqa: E402
from dslabs_tpu_torch.tpu import slots as tslots  # noqa: E402
from dslabs_tpu_torch.tpu import specs as tspecs  # noqa: E402
from dslabs_tpu_torch.tpu import specs_lab3 as tlab3  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.clientserver import \
    make_clientserver_protocol as t_cs  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.pingpong import \
    make_pingpong_protocol as t_pp  # noqa: E402

S = 2 ** 31 - 1
FLAGSHIP_KW = dict(n=3, n_clients=2, w=1, max_slots=3, net_cap=64,
                   timer_cap=6)

# id -> function of (specs, specs_lab3) modules giving the compiled twin,
# called with either package's modules.
TWINS = {
    "flagship": lambda m: m[1].make_paxos_protocol(**FLAGSHIP_KW),
    "pb_s2c1w1": lambda m: m[0].pb_spec(2, 1, 1).compile(),
    "pb_s3c2w2": lambda m: m[0].pb_spec(3, 2, 2).compile(),
    "clientserver_c2w2": lambda m: m[0].clientserver_spec(2, 2).compile(),
    "pingpong_w2": lambda m: m[0].pingpong_spec(2).compile(),
    "paxos_single_decree": lambda m: m[0].paxos_spec(3).compile(),
}
JAX_MODS, PORT_MODS = (jspecs, jlab3), (tspecs, tlab3)


def _key(out):
    return (out.end_condition, out.unique_states, out.states_explored,
            out.depth)


def _no_goals(p):
    return dataclasses.replace(p, goals={})


def _pruned(p):
    return dataclasses.replace(p, goals={}, prunes=dict(p.goals))


def _eq(ref, port):
    ref = np.asarray(ref)
    assert ref.shape == tuple(port.shape), (ref.shape, port.shape)
    np.testing.assert_array_equal(ref, port.numpy())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random_rows(rng, p, n_types, n_ttypes, count=384):
    """Seeded node, message and timer rows: small lane values that reach
    the handlers' branches, node and slot indices one past either end of
    their range, and every 17th message / 13th timer a SENTINEL row."""
    nodes = rng.integers(-1, 5, size=(count, p.node_width)).astype(np.int32)
    msg = rng.integers(-1, 5, size=(count, p.msg_width)).astype(np.int32)
    msg[:, 0] = rng.integers(0, n_types + 1, size=count)
    msg[:, 1:3] = rng.integers(-1, p.n_nodes + 1, size=(count, 2))
    msg[::17] = S
    node_idx = rng.integers(-1, p.n_nodes + 1, size=count).astype(np.int32)
    timer = rng.integers(-1, 5, size=(count, p.timer_width)).astype(np.int32)
    timer[:, 0] = rng.integers(0, n_ttypes + 2, size=count)
    timer[::13] = S
    return nodes, msg, node_idx, timer


# ------------------------------------------------------- batched steps

@pytest.mark.parametrize("name", list(TWINS))
def test_compiled_steps_match_jax_vmap(name):
    """The compiled twin's batched steps equal jax.vmap of the JAX
    compiled twin's steps lane for lane (nodes', sends, timer sets and
    the exc lane where a handler fails), and the layouts, budgets, lane
    domains and initial state agree."""
    pj, pt = TWINS[name](JAX_MODS), TWINS[name](PORT_MODS)
    for f in ("name", "n_nodes", "node_width", "msg_width", "timer_width",
              "net_cap", "timer_cap", "max_sends", "max_sets",
              "max_live_sends", "lane_domains"):
        assert getattr(pt, f) == getattr(pj, f), f
    np.testing.assert_array_equal(pt.init_nodes(), pj.init_nodes())
    np.testing.assert_array_equal(pt.init_messages(), pj.init_messages())
    np.testing.assert_array_equal(pt.init_timers(), pj.init_timers())
    # Tag domains: (0, message types - 1) and (0, timer types).
    n_types = pt.lane_domains["msg"][0][1] + 1
    n_ttypes = pt.lane_domains["timer"][0][1]
    rng = np.random.default_rng(sorted(TWINS).index(name))
    nodes, msg, node_idx, timer = _random_rows(rng, pt, n_types, n_ttypes)
    ref = jax.vmap(pj.step_message)(jnp.asarray(nodes), jnp.asarray(msg))
    out = pt.step_message(_t(nodes), _t(msg))
    assert len(out) == len(ref)
    for a, b in zip(ref, out):
        _eq(a, b)
    assert (out[0] != _t(nodes)).any()
    if pt.max_sends:
        assert (out[1] != S).any() and (out[1] == S).any()
    ref = jax.vmap(pj.step_timer)(jnp.asarray(nodes), jnp.asarray(node_idx),
                                  jnp.asarray(timer))
    out = pt.step_timer(_t(nodes), _t(node_idx), _t(timer))
    for a, b in zip(ref, out):
        _eq(a, b)
    np.testing.assert_array_equal(
        pt.msg_dest(_t(msg)).numpy(), np.asarray(
            jax.vmap(pj.msg_dest)(jnp.asarray(msg))))


def test_flagship_shape_matches_the_hand_twin():
    """bench.py's flagship compiled from the spec: 842 lanes (as the hand
    twin), node_width 209, 5 nodes, 11 sends and 1 timer set per step,
    and a symmetry-free compile carries no tables."""
    p = tlab3.make_paxos_protocol(**FLAGSHIP_KW)
    ts = teng.TensorSearch(p, device="cpu")
    assert (ts.lanes, p.node_width, p.msg_width, p.timer_width, p.n_nodes,
            p.max_sends, p.max_sets) == (842, 209, 8, 4, 5, 11, 1)
    assert p.symmetry is None and p.fault is None


def test_symmetry_tables_match_jax():
    """paxos_spec declares its acceptors a symmetry group: the compiled
    permutation tables are carried as data, equal to the reference's."""
    sj, st = (jspecs.paxos_spec(3).compile().symmetry,
              tspecs.paxos_spec(3).compile().symmetry)
    assert st.n_perms == sj.n_perms == 6 and st.groups == sj.groups
    np.testing.assert_array_equal(st.relab, sj.relab)
    np.testing.assert_array_equal(st.lane_src, sj.lane_src)


# ------------------------------------------------- predicates, quorums

def _views(spec_j, spec_t, nodes):
    """The same predicate inputs for both packages: JAX _View of one
    state (vmapped by the caller), port _View of the batch."""
    table, _ = spec_t._layout()
    assert table == spec_j._layout()[0]
    return table, tcomp._View(spec_t, table, _t(nodes))


@pytest.mark.parametrize("make", [
    lambda m: m[1].make_paxos_spec(**FLAGSHIP_KW),
    lambda m: m[1].make_paxos_spec(n=3, n_clients=1, max_slots=1),
    lambda m: m[0].pb_spec(2, 2, 1),
    lambda m: m[0].paxos_partition_spec(3),
], ids=["flagship", "paxos_s1", "pb_s2c2", "paxos_partition"])
def test_predicates_match_jax_on_batches(make):
    """Goals and invariants over the batched _View (LOGS_CONSISTENT,
    CLIENTS_DONE, DECIDE_HAS_QUORUM's sum over a member vector) equal
    the JAX predicates vmapped over single states."""
    sj, st = make(JAX_MODS), make(PORT_MODS)
    _, width = st._layout()
    rng = np.random.default_rng(width)
    nodes = rng.integers(0, 3, size=(512, width)).astype(np.int32)
    table, view = _views(sj, st, nodes)
    preds = {**{f"goal:{k}": v for k, v in st.goals.items()},
             **{f"inv:{k}": v for k, v in st.invariants.items()}}
    jpreds = {**{f"goal:{k}": v for k, v in sj.goals.items()},
              **{f"inv:{k}": v for k, v in sj.invariants.items()}}
    assert preds.keys() == jpreds.keys() and preds
    for k, fn in preds.items():
        if k == "inv:LOGS_CONSISTENT" and st.slot_blocks[
                ("server", "log")].n == 1:
            # The reference indexes a size-1 log lane as a vector and
            # cannot trace it; the port's batched lane covers it.
            out = fn(view)
            assert out.shape == (512,) and out.dtype == torch.bool
            continue
        ref = jax.vmap(lambda row, fn=jpreds[k]: fn(
            jcomp._View(sj, table, row)))(jnp.asarray(nodes))
        _eq(ref, fn(view))


def test_quorum_reducers_match_jax_on_batches():
    """popcount, count_true, majority, all_of, any_of and the resolved
    Quorum's methods on [P] bitmaps and [P, n] member arrays equal the
    JAX reducers vmapped over single states."""
    rng = np.random.default_rng(7)
    bits = rng.integers(-2 ** 31, 2 ** 31 - 1, size=512).astype(np.int32)
    bits[:64] = rng.integers(0, 32, size=64)
    for n in (1, 3, 5, 7):
        _eq(jax.vmap(lambda b, n=n: jquorum.popcount(b, n))(
            jnp.asarray(bits)), tquorum.popcount(_t(bits), n))
    for n in (1, 3, 4):
        vec = rng.integers(-1, 3, size=(512, n)).astype(np.int32)
        vec[::3] = 0
        for fj, ft in ((jquorum.count_true, tquorum.count_true),
                       (jquorum.majority, tquorum.majority),
                       (jquorum.all_of, tquorum.all_of),
                       (jquorum.any_of, tquorum.any_of)):
            _eq(jax.vmap(fj)(jnp.asarray(vec)), ft(_t(vec)))
        _eq(jax.vmap(lambda v: jquorum.majority(v, n + 2))(
            jnp.asarray(vec)), tquorum.majority(_t(vec), n + 2))
        qj, qt = (jquorum.Quorum("q", "k", n, n // 2 + 1),
                  tquorum.Quorum("q", "k", n, n // 2 + 1))
        _eq(jax.vmap(qj.met)(jnp.asarray(vec)), qt.met(_t(vec)))
        _eq(jax.vmap(qj.met_bits)(jnp.asarray(bits)), qt.met_bits(_t(bits)))


# ------------------------------------------------------- compile gates

def _gate_spec(mods, slot_index=1, quorums=(), kinds=None, handler=None):
    """tests/test_spec_parity.py's gate spec, built from either package's
    compiler (``mods`` = (compiler, slots, quorum) modules)."""
    comp, slots, _ = mods
    spec = comp.ProtocolSpec(
        "spec-gate",
        nodes=kinds(mods) if kinds is not None else [
            comp.NodeKind("proc", 3, (
                comp.Field("x", hi=4),
                slots.Slots("log", 2, (slots.SlotField("cmd", hi=7),),
                            base=1),
            ))],
        messages=[comp.MessageType("GO", ())],
        timers=[comp.TimerType("TICK", (), 10, 10)],
        net_cap=4, timer_cap=1, quorums=quorums(mods) if quorums else ())

    def go(ctx, m):
        if handler is not None:
            return handler(ctx, m)
        ctx.put("x", ctx.slot_get("log", "cmd", slot_index))

    spec.on("proc", "GO")(go)
    spec.initial_messages.append(("GO", 0, 0, {}))
    spec.invariants["OK"] = lambda v: True
    return spec


J_MODS = (jcomp, jslots, jquorum)
T_MODS = (tcomp, tslots, tquorum)


def _ghost_kinds(mods):
    comp, slots, _ = mods
    return [comp.NodeKind("proc", 3, (
                comp.Field("x", hi=4),
                slots.Slots("log", 2, (slots.SlotField("cmd", hi=7),),
                            base=1))),
            comp.NodeKind("ghost", 0, (comp.Field("y", hi=1),))]


@pytest.mark.parametrize("kw,match", [
    (dict(slot_index=3), "outside declared range"),
    (dict(slot_index=0), "outside declared range"),
    (dict(quorums=lambda m: (m[2].QuorumCount("q", over="procs"),)),
     "unknown node kind"),
    (dict(kinds=_ghost_kinds,
          quorums=lambda m: (m[2].QuorumCount("q", over="ghost"),)),
     "EMPTY group"),
    (dict(handler=lambda ctx, m: ctx.put("y", 1)), "undeclared field"),
    (dict(handler=lambda ctx, m: ctx.get_at("x", 5)),
     "outside declared range"),
    (dict(handler=lambda ctx, m: ctx.slot_get("logs", "cmd", 1)),
     "undeclared Slots block"),
    (dict(handler=lambda ctx, m: ctx.quorum("q")), "undeclared quorum"),
    (dict(handler=lambda ctx, m: ctx.put("x", m["nope"])),
     "not declared by"),
    (dict(handler=lambda ctx, m: ctx.send("GO", 0, bad=1)),
     "unknown fields"),
    (dict(handler=lambda ctx, m: ctx.fail(0)), "static positive int"),
], ids=["slot_past_end", "slot_below_base", "quorum_unknown_kind",
        "quorum_empty_group", "undeclared_field", "static_index",
        "undeclared_block", "undeclared_quorum", "payload_field",
        "send_fields", "fail_code"])
def test_compile_gates_match_jax(kw, match):
    """A malformed spec raises the same SpecError, text and all, in both
    packages; the in-range spec compiles in both."""
    _gate_spec(T_MODS).compile()
    with pytest.raises(jcomp.SpecError, match=match) as ej:
        _gate_spec(J_MODS, **kw).compile()
    with pytest.raises(tcomp.SpecError, match=match) as et:
        _gate_spec(T_MODS, **kw).compile()
    assert str(et.value) == str(ej.value)
    assert (et.value.handler, et.value.field, et.value.code) == (
        ej.value.handler, ej.value.field, ej.value.code)


# ------------------------------------------------------------ searches

def _port(p, **kw):
    return teng.TensorSearch(p, device="cpu", **kw)


@pytest.mark.parametrize("gen,hand", [
    (lambda: tspecs.pingpong_spec(2).compile(), lambda: t_pp(2)),
    (lambda: tspecs.clientserver_spec(1, 2).compile(), lambda: t_cs(1, 2)),
    (lambda: tspecs.clientserver_spec(2, 1).compile(), lambda: t_cs(2, 1)),
], ids=["pingpong_w2", "clientserver_c1w2", "clientserver_c2w1"])
def test_generated_twins_match_hand_twins(gen, hand):
    """tests/test_compiler.py's parity on the port: the generated lab0
    and lab1 twins exhaust with the hand twins' counts."""
    g = _port(_pruned(gen()), chunk=128).run()
    h = _port(_pruned(hand()), chunk=128).run()
    assert g.end_condition == h.end_condition == "SPACE_EXHAUSTED"
    assert _key(g) == _key(h)


def test_generated_paxos_pinned_depths():
    """Generated Paxos n3-c1-s2 (make_paxos_protocol's defaults): 6 / 25
    / 102 unique at depths 1 / 2 / 3, the JAX package's pinned counts."""
    p = _no_goals(tlab3.make_paxos_protocol())
    got = [_port(p, chunk=32, max_depth=d, visited_cap=1 << 12).run()
           .unique_states for d in (1, 2, 3)]
    assert got == [6, 25, 102]


def test_compiled_singleton_paxos_matches_hand_twin():
    """n=1 lab3 Paxos (self-election at init, the self-vote majority, a
    one-slot-wide votes block through slot_clear_upto): the compiled twin
    exhausts and reaches its goal with the hand twin's counts (the hand
    twin equals the JAX hand twin, tests/test_torch_search.py; the JAX
    compiled twin cannot trace a one-element slot block)."""
    from dslabs_tpu_torch.tpu.protocols.paxos import \
        make_paxos_protocol as hand

    kw = dict(n=1, n_clients=1, max_slots=2, net_cap=16, timer_cap=4)
    gen_p, hand_p = tlab3.make_paxos_protocol(**kw), hand(**kw)
    for strip, depth, end in ((_no_goals, 6, "SPACE_EXHAUSTED"),
                              (lambda p: p, 12, "GOAL_FOUND")):
        g, h = (_port(strip(p), chunk=64, visited_cap=1 << 12,
                      max_depth=depth).run() for p in (gen_p, hand_p))
        assert _key(g) == _key(h) and g.end_condition == end


def test_plain_paxos_exhausts_at_pinned_counts():
    """paxos_spec(3) with its goal moved to a prune: SPACE_EXHAUSTED with
    1548 explored / 202 unique at depth 11 (no timers: the compiled steps
    return an empty timer block, as in the reference)."""
    p = tspecs.paxos_spec(3).compile()
    msg = torch.as_tensor(p.init_messages())
    nodes = torch.as_tensor(p.init_nodes())[None].expand(len(msg), -1)
    assert p.step_message(nodes, msg)[2].shape == (len(msg), 0, 4)
    out = _port(_pruned(p), chunk=64, frontier_cap=1 << 13,
                visited_cap=1 << 16).run()
    assert _key(out) == ("SPACE_EXHAUSTED", 202, 1548, 11)


def test_compiled_flagship_depth2_pinned():
    """bench.py's flagship compiled from the spec, goals stripped,
    packed (217 words): 38 unique / 98 explored at depth 2."""
    ts = _port(_no_goals(tlab3.make_paxos_protocol(**FLAGSHIP_KW)),
               chunk=64, max_depth=2, visited_cap=1 << 12)
    assert ts.plane == 217
    out = ts.run()
    assert _key(out) == ("DEPTH_EXHAUSTED", 38, 98, 2)
    assert (out.bytes_per_state, out.bytes_per_state_unpacked) == (868,
                                                                   3368)


def test_fault_specs_build_and_refuse_to_compile():
    """The fault-model specs build (with the hidden controller kind, as
    in the reference) and compile() raises until faults are ported."""
    for make in (lambda m: m[0].paxos_partition_spec(3),
                 lambda m: m[0].pb_crash_spec(),
                 lambda m: m[1].make_paxos_partition_spec()):
        sj, st = make(JAX_MODS), make(PORT_MODS)
        assert [k.name for k in st.nodes] == [k.name for k in sj.nodes]
        assert st._layout() == sj._layout()
        with pytest.raises(NotImplementedError, match="symmetry \\+ faults"):
            st.compile()
