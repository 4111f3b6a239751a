"""PyTorch port, engine state ops and one chunk expand
(``dslabs_tpu_torch/tpu/engine.py``) against the JAX package.

Inputs are made from a seed with numpy and handed to both frameworks;
exact equality everywhere.  The JAX Paxos twin is the hand twin the JAX
package keeps as a parity oracle (``tests/fixtures/hand_twins/paxos.py``,
imported as ``tests/test_spec_parity.py`` does); each protocol's JAX
expand is compiled once per module."""

import functools
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from dslabs_tpu.tpu import engine as jeng  # noqa: E402
from dslabs_tpu.tpu.protocols.clientserver import \
    make_clientserver_protocol as j_cs  # noqa: E402
from dslabs_tpu.tpu.protocols.pingpong import \
    make_pingpong_protocol as j_pp  # noqa: E402
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.clientserver import \
    make_clientserver_protocol as t_cs  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.paxos import \
    make_paxos_protocol as t_px  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.pingpong import \
    make_pingpong_protocol as t_pp  # noqa: E402

_FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
if _FIXTURES not in sys.path:
    sys.path.insert(0, _FIXTURES)

from hand_twins.paxos import make_paxos_protocol as j_px  # noqa: E402

S = int(jeng.SENTINEL)
PAXOS_KW = dict(n=3, n_clients=1, max_slots=2, net_cap=48, timer_cap=6)
FLAGSHIP_KW = dict(n=3, n_clients=2, w=1, max_slots=3, net_cap=64,
                   timer_cap=6)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(ref, port):
    ref = np.asarray(ref)
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    assert ref.shape == port.shape, (ref.shape, port.shape)
    np.testing.assert_array_equal(ref, port)


# ---------------------------------------------------------- random inputs

def _records(rng, n, w, lo=0, hi=3, p_empty=0.3):
    rec = rng.integers(lo, hi, size=(n, w)).astype(np.int32)
    rec[rng.random(n) < p_empty] = S
    return rec


def _canonical_nets(rng, p, cap, mw):
    nets = _records(rng, p * cap, mw).reshape(p, cap, mw)
    return np.stack([np.asarray(jeng.canonicalize_net(jnp.asarray(x)))
                     for x in nets])


def _queues(rng, p, nn, cap, tw):
    """Timer queues with an occupied prefix (appends land at the count)."""
    q = np.full((p, nn, cap, tw), S, np.int32)
    for i in range(p):
        for j in range(nn):
            k = rng.integers(0, cap + 1)
            mn = rng.integers(0, 20, size=k)
            q[i, j, :k, 0] = rng.integers(0, 3, size=k)
            q[i, j, :k, 1] = mn
            q[i, j, :k, 2] = mn + rng.integers(0, 20, size=k)
            q[i, j, :k, 3:] = rng.integers(0, 5, size=(k, tw - 3))
    return q


# ---------------------------------------------------------------- state ops

def test_row_less_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 3, size=(40, 1, 4)).astype(np.int32)
    b = rng.integers(0, 3, size=(1, 30, 4)).astype(np.int32)
    _eq(jeng._row_less(jnp.asarray(a), jnp.asarray(b)),
        teng._row_less(_t(a), _t(b)))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_canonicalize_net_matches_jax(seed):
    rng = np.random.default_rng(seed)
    net = _records(rng, 24, 3, hi=2)            # duplicates likely
    _eq(jeng.canonicalize_net(jnp.asarray(net)),
        teng.canonicalize_net(_t(net)))


@pytest.mark.parametrize("budget", [2, 4, 8])
def test_compact_rows_matches_jax(budget):
    rng = np.random.default_rng(budget)
    rows = _records(rng, 8 * 6, 3).reshape(8, 6, 3)
    for r in rows:
        out_j, over_j = jeng.compact_rows(jnp.asarray(r), budget)
        out_t, over_t = teng.compact_rows(_t(r), budget)
        _eq(out_j, out_t)
        assert int(over_j) == int(over_t)
    out_j, over_j = jeng.compact_rows_batched(
        jnp.asarray(rows.transpose(1, 2, 0)), budget)
    out_t, over_t = teng.compact_rows_batched(_t(rows), budget)
    _eq(np.asarray(out_j).transpose(2, 0, 1), out_t)
    _eq(over_j, over_t)


@pytest.mark.parametrize("cap,s", [(10, 3), (6, 5)])
def test_insert_messages_matches_jax(cap, s):
    rng = np.random.default_rng(cap * 10 + s)
    p, mw = 24, 3
    nets = _canonical_nets(rng, p, cap, mw)
    sends = _records(rng, p * s, mw).reshape(p, s, mw)
    sends[::3, 0] = nets[::3, 0]                # sends already in the net
    sends[1::4, -1] = sends[1::4, 0]            # duplicate sends
    for i in range(0, p, 4):
        out_j, over_j = jeng.insert_messages(jnp.asarray(nets[i]),
                                             jnp.asarray(sends[i]))
        out_t, over_t = teng.insert_messages(_t(nets[i]), _t(sends[i]))
        _eq(out_j, out_t)
        assert int(over_j) == int(over_t)
    out_j, over_j = jeng.insert_messages_batched(
        jnp.asarray(nets.transpose(1, 2, 0)),
        jnp.asarray(sends.transpose(1, 2, 0)))
    out_t, over_t = teng.insert_messages_batched(_t(nets), _t(sends))
    _eq(np.asarray(out_j).transpose(2, 0, 1), out_t)
    _eq(over_j, over_t)


def test_timer_ops_match_jax():
    rng = np.random.default_rng(9)
    p, nn, cap, tw = 20, 3, 5, 4
    q = _queues(rng, p, nn, cap, tw)
    ref = jax.vmap(jax.vmap(jeng.timer_deliverable_mask))(jnp.asarray(q))
    _eq(ref, teng.timer_deliverable_mask(_t(q)))

    idx = rng.integers(0, cap, size=p).astype(np.int32)
    ref = jax.vmap(jeng.remove_timer)(jnp.asarray(q[:, 0]),
                                      jnp.asarray(idx))
    _eq(ref, teng.remove_timer(_t(q[:, 0]), _t(idx)))

    new = rng.integers(0, 9, size=(p, 4, 1 + tw)).astype(np.int32)
    new[:, :, 0] = rng.integers(0, nn, size=(p, 4))
    new[rng.random((p, 4)) < 0.3] = S
    out_j, drop_j = jax.vmap(jeng.append_timers)(jnp.asarray(q),
                                                 jnp.asarray(new))
    out_t, drop_t = teng.append_timers(_t(q), _t(new))
    _eq(out_j, out_t)
    _eq(drop_j, drop_t)
    assert int(drop_t.sum()) > 0                # full queues drop


@pytest.mark.parametrize("make_j,make_t,kw", [
    (j_pp, t_pp, dict(workload_size=2)),
    (j_cs, t_cs, dict(n_clients=3, w=4, net_cap=32)),
    (j_px, t_px, PAXOS_KW),
    (j_px, t_px, FLAGSHIP_KW),
])
def test_initial_state_and_layout_match_jax(make_j, make_t, kw):
    js = jeng.TensorSearch(make_j(**kw))
    ts = teng.TensorSearch(make_t(**kw), device="cpu")
    assert js.lanes == ts.lanes and js._off == ts._off
    assert js._num_events() == ts._num_events()
    rj = np.asarray(jeng.flatten_state(js.initial_state()))
    rt = teng.flatten_state(ts.initial_state())
    _eq(rj, rt)
    back = teng.flatten_state(ts.unflatten_rows(rt))
    assert torch.equal(back, rt)
    if make_t is t_px and kw is FLAGSHIP_KW:
        assert ts.lanes == 842               # the flagship row width


# ------------------------------------------------------------ chunk expand

def _frontiers(js, chunk, levels):
    """[(chunk_rows, chunk_valid, jax outputs)] for the root and the next
    ``levels`` BFS frontiers, each expanded by ONE compiled JAX program;
    frontiers are deduplicated on the host by fingerprint."""
    expand = jax.jit(functools.partial(js._expand_chunk, dedup=False))
    lanes = js.lanes
    root = np.asarray(jeng.flatten_state(js.initial_state()))
    seen = {np.asarray(jeng.row_fingerprints(jnp.asarray(root)))[0]
            .tobytes()}
    frontier = root
    out = []
    for _ in range(levels + 1):
        assert 0 < len(frontier) <= chunk
        rows = np.zeros((chunk, lanes), np.int32)
        rows[:len(frontier)] = frontier
        valid = np.arange(chunk) < len(frontier)
        res = jax.tree.map(np.asarray,
                           expand(jnp.asarray(rows), jnp.asarray(valid)))
        out.append((rows, valid, res))
        succ, vals, fp = res[0], res[1], res[2]
        nxt = []
        for i in np.nonzero(vals)[0]:
            key = fp[i].tobytes()
            if key not in seen:
                seen.add(key)
                nxt.append(succ[i])
        frontier = np.stack(nxt)[:chunk]
    return out


@pytest.fixture(scope="module", params=["clientserver", "paxos"])
def expand_case(request):
    if request.param == "clientserver":
        kw, mj, mt, chunk = dict(n_clients=2, w=1), j_cs, t_cs, 16
    else:
        kw, mj, mt, chunk = PAXOS_KW, j_px, t_px, 32
    js = jeng.TensorSearch(mj(**kw), chunk=chunk)
    ts = teng.TensorSearch(mt(**kw), chunk=chunk, device="cpu")
    return ts, _frontiers(js, chunk, 2)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_expand_chunk_matches_jax(expand_case, level):
    """Root and depth-1/2 frontiers: rows, valids, fingerprints, event ids
    and predicate flags all equal, invalid pair slots included."""
    ts, cases = expand_case
    rows, valid, ref = cases[level]
    out = ts._expand_chunk(_t(rows), _t(valid), dedup=False)
    (rows_j, val_j, fp_j, uniq_j, over_j, rem_j, ev_j, flags_j) = ref
    rows_t, val_t, fp_t, uniq_t, over_t, rem_t, ev_t, flags_t = out
    _eq(rows_j, rows_t)
    _eq(val_j, val_t)
    _eq(fp_j, fp_t.numpy().view(np.uint32))
    _eq(uniq_j, uniq_t)
    _eq(ev_j, ev_t)
    assert int(over_j) == int(over_t) and int(rem_j) == int(rem_t)
    assert flags_j.keys() == flags_t.keys()
    for k in flags_j:
        _eq(flags_j[k], flags_t[k])
    assert val_t.any()


def test_expand_chunk_windowed_budget():
    """A finite ev_budget presents valid events window by window; the
    windows together cover exactly the full-grid expand's successors."""
    p = t_cs(n_clients=2, w=1)
    full = teng.TensorSearch(p, chunk=4, device="cpu")
    win = teng.TensorSearch(p, chunk=4, ev_budget=(1, 2), device="cpu")
    root = teng.flatten_state(full.initial_state())
    rows = root.repeat(4, 1)
    valid = torch.tensor([True, False, False, False])
    ref = full._expand_chunk(rows, valid)
    keys_ref = {tuple(k) for k in ref[2][ref[1]].tolist()}
    keys, ev_pass = set(), 0
    while True:
        out = win._expand_chunk(rows, valid, ev_pass)
        keys |= {tuple(k) for k in out[2][out[1]].tolist()}
        if int(out[5]) == 0:
            break
        ev_pass += 1
    assert ev_pass > 0 and keys == keys_ref


def test_dedup_prefilter_is_not_ported():
    ts = teng.TensorSearch(t_pp(2), device="cpu")
    rows = teng.flatten_state(ts.initial_state())
    with pytest.raises(NotImplementedError, match="run_host"):
        ts._expand_chunk(rows, torch.tensor([True]), dedup=True)
