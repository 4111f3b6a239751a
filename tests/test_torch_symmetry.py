"""PyTorch port, symmetry reduction (``dslabs_tpu_torch/tpu/symmetry.py`` and
the canonical fingerprint sites of ``tpu/engine.py``) against the JAX
package on the CPU, exact equality (everything is integer):

- ``build_canonicalizer``'s rows against the JAX pass on seeded rows
  (reachable states, their permutation images and rows of random lanes)
  for ``paxos_spec(3)`` (6 permutations) and ``paxos_spec(4)`` (24);
- the reference's pins on both loops (the device loop and ``run_host``),
  DECIDED pruned: 202 raw -> 50 canonical unique (1548 -> 375 explored)
  at depth 11 for three acceptors (tests/test_symmetry.py), 792 -> 84
  (9616 -> 949) at depth 15 for four; packed equals unpacked;
- verdict parity with the raw run, a replayable violation witness,
  permuted states hashing equal, the symmetric partition scenario equal
  to a live JAX search, and ``symmetry=True`` without groups raising the
  reference's ``ValueError``."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from dslabs_tpu.tpu import engine as jeng  # noqa: E402
from dslabs_tpu.tpu import specs as jspecs  # noqa: E402
from dslabs_tpu.tpu.protocols.pingpong import \
    make_pingpong_protocol as j_pp  # noqa: E402
from dslabs_tpu.tpu.symmetry import \
    build_canonicalizer as j_canon  # noqa: E402
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.tpu import specs as tspecs  # noqa: E402
from dslabs_tpu_torch.tpu import specs_lab3 as tlab3  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.pingpong import \
    make_pingpong_protocol as t_pp  # noqa: E402
from dslabs_tpu_torch.tpu.symmetry import \
    build_canonicalizer as t_canon  # noqa: E402

S = 2 ** 31 - 1
KW = dict(chunk=64, visited_cap=1 << 14)
# n_acceptors -> (permutations, raw (unique, explored), canonical (unique,
# explored), depth), DECIDED pruned.
PINS = {3: (6, (202, 1548), (50, 375), 11),
        4: (24, (792, 9616), (84, 949), 15)}


def _pruned(p):
    return dataclasses.replace(p, goals={}, prunes=dict(p.goals),
                               invariants=dict(p.invariants))


def _key(out):
    return (out.end_condition, out.unique_states, out.states_explored,
            out.depth)


def _port(p, **kw):
    return teng.TensorSearch(p, device="cpu", **kw)


# ------------------------------------------------------- the canonicalizer

def _seeded_rows(ts, rng, n_rand=64):
    """Reachable rows of the first levels (every grid event through
    ``_step_batch``), their images under random group permutations, and
    rows of random lanes: node ids in and out of range in the message
    records, some records empty."""
    p = ts.p
    sym = p.symmetry
    grid = p.net_cap + p.n_nodes * p.timer_cap
    rows = teng.flatten_state(ts.initial_state())
    levels = [rows]
    for _ in range(4):
        succ, ok, over = ts._step_batch(
            rows.repeat_interleave(grid, 0),
            torch.arange(grid).repeat(rows.shape[0]))
        rows = torch.unique(succ[ok & (over == 0)], dim=0)
        levels.append(rows)
    reach = torch.cat(levels)
    # Images: new_nodes = old_nodes[lane_src], from/to relabelled (the
    # network left unsorted on purpose: the pass must re-sort it).
    o0, o1, _ = ts._off
    imgs = reach.clone()
    ks = rng.integers(0, sym.n_perms, len(reach))
    for i, k in enumerate(ks):
        imgs[i, :o0] = reach[i, :o0][torch.from_numpy(sym.lane_src[k])]
        net = imgs[i, o0:o1].reshape(p.net_cap, p.msg_width)
        occ = net[:, 0] != S
        for lane in (1, 2):
            net[occ, lane] = torch.from_numpy(
                sym.relab[k].astype(np.int32))[net[occ, lane].long()]
    rand = rng.integers(0, 3, (n_rand, ts.lanes)).astype(np.int32)
    net = rand[:, o0:o1].reshape(n_rand, p.net_cap, p.msg_width)
    net[:, :, 1:3] = rng.integers(-2, p.n_nodes + 2, net[:, :, 1:3].shape)
    net[rng.random(net.shape[:2]) < 0.4] = S
    rand[:, -1] = rng.integers(0, 2, n_rand)
    return torch.cat([reach, imgs, torch.from_numpy(rand)])


@pytest.mark.parametrize("n", [3, 4])
def test_canonicalizer_matches_jax(n):
    """The port's pass, row for row, against the JAX pass: lex-min over
    every permutation, relabelled and re-sorted networks, permuted timer
    queues, the exception lane riding along."""
    rng = np.random.default_rng(15 + n)
    pj, pt = jspecs.paxos_spec(n).compile(), tspecs.paxos_spec(n).compile()
    ts = _port(pt, chunk=8)
    rows = _seeded_rows(ts, rng)
    got = t_canon(pt, ts._off)(rows)
    ref = jax.jit(j_canon(pj, ts._off))(jnp.asarray(rows.numpy()))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    # Canonical rows are fixed points, and the pass is not the identity.
    assert torch.equal(t_canon(pt, ts._off)(got), got)
    assert not torch.equal(got, rows)
    # Fingerprints of the canonical rows are the JAX ones.
    np.testing.assert_array_equal(
        np.asarray(jeng.row_fingerprints(jnp.asarray(got.numpy()))).view(
            np.int32), teng.row_fingerprints(got).numpy())


def test_batched_net_canonicalization_matches_per_network():
    """``canonicalize_net_batched`` equals the one-network form on every
    network of a batch (duplicates, empty records, unsorted input)."""
    rng = np.random.default_rng(7)
    net = rng.integers(-3, 4, (40, 12, 5)).astype(np.int32)
    net[:, 6:] = net[:, :6]
    net[rng.random((40, 12)) < 0.3] = S
    t = torch.from_numpy(net)
    got = teng.canonicalize_net_batched(t)
    for i in range(len(net)):
        assert torch.equal(got[i], teng.canonicalize_net(t[i]))
        np.testing.assert_array_equal(
            np.asarray(jeng.canonicalize_net(jnp.asarray(net[i]))),
            got[i].numpy())


def test_permuted_states_hash_equal():
    """Delivering the root's PREPARE to the first and to the last acceptor
    gives two states of one orbit: different rows, equal canonical rows
    and fingerprints (the reference's unit law)."""
    ts = _port(_pruned(tspecs.paxos_spec(3).compile()), chunk=64,
               symmetry=True)
    row0 = teng.flatten_state(ts.initial_state())
    net = ts.unflatten_rows(row0)["net"][0]
    occ = [i for i in range(net.shape[0]) if int(net[i][0]) != S]
    assert len(occ) == 3
    a, b = (ts._step_one(row0[0], slot)[0] for slot in (occ[0], occ[-1]))
    assert not torch.equal(a, b)
    ca, cb = ts._canon_rows(a[None]), ts._canon_rows(b[None])
    assert torch.equal(ca, cb)
    assert torch.equal(teng.row_fingerprints(ca), teng.row_fingerprints(cb))


# ------------------------------------------------------------------ pins

@pytest.mark.parametrize("n", [3, 4])
def test_canonical_counts_pinned_on_both_loops(n):
    """Raw and canonical counts of ``paxos_spec(n)``, DECIDED pruned, on
    the device loop and ``run_host``: the reference's quotient, same
    verdict and depth as the raw run, the permutation count stamped."""
    perms, raw, canon, depth = PINS[n]
    p = _pruned(tspecs.paxos_spec(n).compile())
    r = _port(p, **KW).run()
    assert _key(r) == ("SPACE_EXHAUSTED",) + raw + (depth,)
    assert r.symmetry_perms == 0
    for host in (False, True):
        out = _port(p, symmetry=True, use_host_visited=host, **KW).run()
        assert _key(out) == ("SPACE_EXHAUSTED",) + canon + (depth,)
        assert out.symmetry_perms == perms


def test_packed_and_symmetry_compose():
    """Packed + symmetric equals unpacked + symmetric (the canonical pass
    reads unpacked rows either way)."""
    p = _pruned(tspecs.paxos_spec(3).compile())
    packed = _port(p, symmetry=True, **KW).run()
    raw = _port(p, symmetry=True, packed=False, **KW).run()
    assert _key(packed) == _key(raw) == ("SPACE_EXHAUSTED", 50, 375, 11)
    assert packed.bytes_per_state < packed.bytes_per_state_unpacked
    assert raw.bytes_per_state == raw.bytes_per_state_unpacked


def test_goal_verdict_parity():
    """With the goal live, the raw and the reduced searches both find
    DECIDED, on both loops."""
    p = tspecs.paxos_spec(3).compile()
    raw = _port(p, **KW).run()
    for host in (False, True):
        sym = _port(p, symmetry=True, use_host_visited=host, **KW).run()
        assert raw.end_condition == sym.end_condition == "GOAL_FOUND"
        assert raw.predicate_name == sym.predicate_name == "DECIDED"
        assert raw.depth == sym.depth


def test_violation_witness_replays():
    """The reduced search's violation trace replays through ``_step_one``
    from the root to a state that violates the invariant: stored rows are
    real states, only fingerprints are canonical."""
    p = dataclasses.replace(
        tspecs.paxos_spec(3, never_decided=True).compile(), goals={})
    eng = _port(p, symmetry=True, record_trace=True, **KW)
    out = eng.run()
    assert (out.end_condition, out.predicate_name) == (
        "INVARIANT_VIOLATED", "NONE_DECIDED")
    assert out.trace
    row = teng.flatten_state(eng.initial_state())[0]
    for ev in out.trace:
        row, ok, over = eng._step_one(row, ev)
        assert bool(ok) and int(over) == 0
    final = eng.unflatten_rows(row[None])
    assert not bool(p.invariants["NONE_DECIDED"](final)[0])
    dev = _port(p, symmetry=True, **KW).run()
    assert (dev.end_condition, dev.depth) == (out.end_condition, out.depth)


def test_symmetric_partition_scenario_matches_jax():
    """Fault lanes under the symmetry pass (the partition keeps the
    acceptor group whole): the reduced partition scenario equals the JAX
    reduced search, fault counts included, on both loops."""
    kw = dict(chunk=64, frontier_cap=1 << 13, visited_cap=1 << 16)
    ref = jeng.TensorSearch(_pruned(jspecs.paxos_partition_spec(3).compile()),
                            symmetry=True, **kw).run()
    assert ref.unique_states < 564
    p = _pruned(tspecs.paxos_partition_spec(3).compile())
    for host in (False, True):
        out = _port(p, symmetry=True, use_host_visited=host, **kw).run()
        assert _key(out) == _key(ref)
        assert out.partition_events == ref.partition_events
        assert out.symmetry_perms == ref.symmetry_perms == 6


@pytest.mark.parametrize("make", [
    lambda m: m[0](2),
    lambda m: m[1].make_paxos_protocol(n=3, n_clients=2, w=1, max_slots=3,
                                       net_cap=64, timer_cap=6),
], ids=["pingpong_hand_twin", "compiled_flagship"])
def test_symmetry_without_groups_raises_like_jax(make):
    """``symmetry=True`` on a protocol with no symmetry groups is the
    reference's ``ValueError``, same text."""
    from dslabs_tpu.tpu import specs_lab3 as jlab3

    with pytest.raises(ValueError, match="symmetry") as ej:
        jeng.TensorSearch(make((j_pp, jlab3)), symmetry=True)
    with pytest.raises(ValueError, match="symmetry") as et:
        _port(make((t_pp, tlab3)), symmetry=True)
    assert str(et.value) == str(ej.value)
