"""PyTorch port, bit-packed frontier rows (``dslabs_tpu_torch/tpu/packing.py``
and the packed path of the device loop in ``engine.py``) against the JAX
package on the CPU, exact equality:

- ``derive_packing`` gives the JAX descriptor's arrays, word count and
  ``signature()`` for the compiled flagship (217 words), ``pb_spec``,
  ``clientserver_spec`` and ``pingpong_spec``; a hand twin derives the
  identity;
- the port's torch ``pack`` gives the bits of JAX ``pack_np`` and
  ``pack_jnp`` (with the out-of-domain counts), ``unpack`` inverts it,
  rows packed by the JAX package unpack on the port through
  ``interop.packing_from_numpy``, and delta lanes round-trip with a base;
- a value outside its declared domain ends a packed search with
  ``CapacityOverflow``;
- packed and unpacked searches give equal counts and frontiers, strict
  and not."""

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

from dslabs_tpu.tpu import packing as jpack  # noqa: E402
from dslabs_tpu.tpu import specs as jspecs  # noqa: E402
from dslabs_tpu.tpu import specs_lab3 as jlab3  # noqa: E402
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.tpu import interop  # noqa: E402
from dslabs_tpu_torch.tpu import packing as tpack  # noqa: E402
from dslabs_tpu_torch.tpu import specs as tspecs  # noqa: E402
from dslabs_tpu_torch.tpu import specs_lab3 as tlab3  # noqa: E402
from dslabs_tpu_torch.tpu.compiler import (Field, MessageType,  # noqa: E402
                                           NodeKind, ProtocolSpec)
from dslabs_tpu_torch.tpu.protocols.paxos import \
    make_paxos_protocol as t_hand_paxos  # noqa: E402

S = 2 ** 31 - 1
FLAGSHIP_KW = dict(n=3, n_clients=2, w=1, max_slots=3, net_cap=64,
                   timer_cap=6)
SPECS = {
    "flagship": lambda m: m[1].make_paxos_protocol(**FLAGSHIP_KW),
    "pb_s2c1w1": lambda m: m[0].pb_spec(2, 1, 1).compile(),
    "clientserver_c2w2": lambda m: m[0].clientserver_spec(2, 2).compile(),
    "pingpong_w2": lambda m: m[0].pingpong_spec(2).compile(),
}
JAX_MODS, PORT_MODS = (jspecs, jlab3), (tspecs, tlab3)
WORDS = {"flagship": 217}


def _lanes(p):
    return (p.node_width + p.net_cap * p.msg_width
            + p.n_nodes * p.timer_cap * p.timer_width + 1)


def _pair(name, delta=False):
    pj, pt = SPECS[name](JAX_MODS), SPECS[name](PORT_MODS)
    lanes = _lanes(pt)
    return (jpack.derive_packing(pj, lanes, delta=delta),
            tpack.derive_packing(pt, lanes, delta=delta))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _in_domain_rows(k, rng, n=256):
    """Seeded rows whose every lane sits inside its declared domain (raw
    lanes anywhere in int32), SENTINEL in some sentinel-capable lanes."""
    hi = np.where(k.raw, 0, (np.int64(1) << k.width) - 2 - k.sent)
    code = rng.integers(0, np.maximum(hi, 0) + 1, size=(n, k.lanes))
    rows = np.where(k.raw, rng.integers(-2 ** 31, 2 ** 31, size=(n, k.lanes)),
                    code + k.lo).astype(np.int32)
    sent = rng.random((n, k.lanes)) < 0.3
    return np.where(sent & k.sent, S, rows).astype(np.int32)


# ------------------------------------------------------------ descriptor

@pytest.mark.parametrize("delta", [False, True], ids=["static", "delta"])
@pytest.mark.parametrize("name", list(SPECS))
def test_derive_packing_matches_jax(name, delta):
    kj, kt = _pair(name, delta)
    assert (kt.lanes, kt.words, kt.identity, kt.has_delta) == (
        kj.lanes, kj.words, kj.identity, kj.has_delta)
    for f in ("word", "shift", "width", "lo", "sent", "raw", "dlt"):
        np.testing.assert_array_equal(getattr(kt, f), getattr(kj, f))
    assert kt.signature() == kj.signature()
    assert kt.descriptor() == kj.descriptor()
    assert kt.words < kt.lanes
    if name in WORDS:
        assert kt.words == WORDS[name] and kt.bytes_per_state == 868
    assert kt.has_delta == (delta and name == "pb_s2c1w1")


def test_hand_twin_derives_identity():
    """The hand twin declares no lane domains: identity packing, frontier
    rows stored at full width, pack and unpack return their input."""
    p = t_hand_paxos(**FLAGSHIP_KW)
    ts = teng.TensorSearch(p, device="cpu")
    k = tpack.derive_packing(p, ts.lanes)
    assert k.identity and k.signature() == "raw" and k.words == 842
    assert ts._pk is None and ts.plane == ts.lanes == 842
    rows = torch.arange(842 * 3, dtype=torch.int32).reshape(3, 842)
    assert k.pack(rows) is rows and k.unpack(rows) is rows
    assert teng.TensorSearch(p, device="cpu", packed=False).plane == 842


# ----------------------------------------------------------------- codec

@pytest.mark.parametrize("name", list(SPECS))
def test_pack_bits_match_jax(name, monkeypatch):
    """Port pack == JAX pack_np == JAX pack_jnp bit for bit, with the
    same out-of-domain counts on rows that leave their domains (values
    past hi, below lo, on the reserved sentinel code, int32 extremes);
    unpack inverts pack on in-domain rows.  Pack goes through rows in
    blocks of 40 here, so the blocks' seams are on the tested path."""
    monkeypatch.setattr(tpack, "PACK_BLOCK", 40)
    kj, kt = _pair(name)
    rng = np.random.default_rng(len(name))
    good = _in_domain_rows(kt, rng)
    bad = rng.integers(-5, 300, size=(128, kt.lanes)).astype(np.int32)
    bad[::9] = S
    bad[::7, :5] = -2 ** 31
    # The JAX device codec on the rows that leave their domains, its host
    # codec on both.
    ref, ref_bad = kj.pack_jnp(jnp.asarray(bad), count_bad=True)
    out, out_bad = kt.pack(_t(bad), count_bad=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out_bad.numpy(), np.asarray(ref_bad))
    np.testing.assert_array_equal(kt.unpack(out).numpy(),
                                  np.asarray(kj.unpack_jnp(ref)))
    for rows in (good, bad):
        out = kt.pack(_t(rows))
        np.testing.assert_array_equal(out.numpy(), kj.pack_np(rows))
        np.testing.assert_array_equal(kt.unpack(out).numpy(),
                                      kj.unpack_np(kj.pack_np(rows)))
    packed = kt.pack(_t(good), count_bad=True)
    assert int(packed[1].sum()) == 0 and int(out_bad.sum()) > 0
    np.testing.assert_array_equal(kt.unpack(packed[0]).numpy(), good)
    np.testing.assert_array_equal(kt.pack_np(good), packed[0].numpy())
    np.testing.assert_array_equal(kt.unpack_np(packed[0].numpy()), good)


@pytest.mark.parametrize("name", list(SPECS))
def test_jax_packed_rows_unpack_on_port(name):
    """Rows packed by the JAX package decode bit-identically on the port
    through interop.packing_from_numpy."""
    kj, kt = _pair(name)
    k = interop.packing_from_numpy(kj)
    assert k.signature() == kj.signature() == kt.signature()
    rows = _in_domain_rows(kt, np.random.default_rng(3))
    np.testing.assert_array_equal(
        k.unpack(_t(kj.pack_np(rows))).numpy(), rows)
    with pytest.raises(ValueError, match="shape"):
        interop.packing_from_numpy(dataclasses.replace(kj, lanes=kj.lanes + 1))


def test_delta_lanes_round_trip_with_a_base():
    """pb_spec's view numbers derive as delta lanes with delta=True: pack
    and unpack against a per-lane base give the JAX bits and invert each
    other; a missing base raises in both packages."""
    kj, kt = _pair("pb_s2c1w1", delta=True)
    assert kt.has_delta and len(kt.delta_lanes) == 4
    rng = np.random.default_rng(11)
    base = rng.integers(-3, 50, size=kt.lanes).astype(np.int32)
    rows = _in_domain_rows(kt, rng)
    rows[:, kt.dlt] = base[kt.dlt] + rng.integers(
        0, 255, size=(len(rows), int(kt.dlt.sum())))
    out, out_bad = kt.pack(_t(rows), base=_t(base), count_bad=True)
    ref, ref_bad = kj.pack_jnp(jnp.asarray(rows), base=jnp.asarray(base),
                               count_bad=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out_bad.numpy(), np.asarray(ref_bad))
    assert int(out_bad.sum()) == 0
    np.testing.assert_array_equal(kt.unpack(out, base=_t(base)).numpy(),
                                  rows)
    np.testing.assert_array_equal(kt.pack_np(rows, base), out.numpy())
    for k, r in ((kt, _t(rows)), (kj, jnp.asarray(rows))):
        with pytest.raises(ValueError, match="base"):
            (k.pack if k is kt else k.pack_jnp)(r)


# --------------------------------------------------------------- engine

def _overflowing_spec(hi: int) -> ProtocolSpec:
    """A counter declared in [0, hi] that the handler drives to 3."""
    spec = ProtocolSpec(
        "overflow", nodes=[NodeKind("n", 1, (Field("c", hi=hi),))],
        messages=[MessageType("GO", ())], timers=[], net_cap=2,
        timer_cap=1)

    @spec.on("n", "GO")
    def go(ctx, m):
        ctx.put("c", ctx.get("c") + 1, when=ctx.get("c") < 3)
        ctx.send("GO", 0)

    spec.initial_messages.append(("GO", 0, 0, {}))
    return spec


def test_out_of_domain_value_is_capacity_overflow():
    """A live value outside its declared domain ends a packed search with
    CapacityOverflow; the unpacked search of the same spec runs, and a
    domain that holds the value packs without complaint."""
    kw = dict(chunk=8, visited_cap=1 << 10, device="cpu")
    with pytest.raises(teng.CapacityOverflow, match="overflowed"):
        teng.TensorSearch(_overflowing_spec(1).compile(), **kw).run()
    out = teng.TensorSearch(_overflowing_spec(1).compile(), packed=False,
                            **kw).run()
    ok = teng.TensorSearch(_overflowing_spec(3).compile(), **kw).run()
    assert out.end_condition == ok.end_condition == "SPACE_EXHAUSTED"
    assert out.unique_states == ok.unique_states == 4


def _key(out):
    return (out.end_condition, out.unique_states, out.states_explored,
            out.depth, out.visited_overflow)


def _pb():
    return tspecs.pb_spec(2, 1, 1).compile()


def _clientserver_pruned():
    p = tspecs.clientserver_spec(2, 2).compile()
    return dataclasses.replace(p, goals={},
                               prunes={"DONE": p.goals["CLIENTS_DONE"]})


def _flagship():
    return dataclasses.replace(tlab3.make_paxos_protocol(**FLAGSHIP_KW),
                               goals={})


@pytest.mark.parametrize("make,kw,strict", [
    (_pb, dict(max_depth=4, chunk=64), True),
    (_pb, dict(max_depth=4, chunk=64), False),
    (_clientserver_pruned, dict(chunk=64), True),
    (_clientserver_pruned, dict(chunk=64), False),
    (_flagship, dict(max_depth=2, chunk=64), True),
], ids=["pb_d4-strict", "pb_d4-lax", "clientserver_exhaustive-strict",
        "clientserver-lax", "flagship_d2-strict"])
def test_packed_and_unpacked_searches_agree(make, kw, strict):
    """The device loop packed and unpacked: equal end condition, counts,
    depth and table overflow, and the last frontier's rows equal once
    unpacked.  Without strict the table is too small for the states, so
    keys go unresolved and both treat them as fresh alike (with a depth
    limit, since such a search re-explores)."""
    p = make()
    vcap = (1 << 12) if strict else 32
    if not strict:
        kw = {"max_depth": 8, **kw}
    runs = {}
    for packed in (True, False):
        ts = teng.TensorSearch(p, device="cpu", packed=packed, strict=strict,
                               visited_cap=vcap, **kw)
        out = ts.run()
        carry = ts._last_dev_carry
        n = int(carry["cur_n"])
        rows = carry["cur"][:n]
        runs[packed] = (out, rows if ts._pk is None else ts._pk.unpack(rows),
                        ts)
    (po, prows, pts), (uo, urows, uts) = runs[True], runs[False]
    assert _key(po) == _key(uo)
    assert torch.equal(prows, urows)
    assert len(prows) > 0 or po.end_condition == "SPACE_EXHAUSTED"
    assert pts.plane < uts.plane == uts.lanes
    assert (po.bytes_per_state, uo.bytes_per_state) == (pts.plane * 4,
                                                        uts.lanes * 4)
    assert po.pack_ratio == round(uts.lanes / pts.plane, 3)
    assert (po.visited_overflow > 0) == (not strict)
