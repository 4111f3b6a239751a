"""PyTorch port, the lab 2 primary-backup twin
(``dslabs_tpu_torch/tpu/protocols/primarybackup.py``) against the JAX twin
(``dslabs_tpu/tpu/protocols/primarybackup.py``) on the CPU, exact
equality: the batched handlers on random pairs (every branch, tick
counters near the int32 limit, the SENTINEL rows of sends and timer
sets), the initial state and layout, one chunk expand at depths 0-2,
``_step_one`` on every grid event of those frontiers, and whole searches.

The JAX search counts are pinned (measured on the JAX package): (ns=2,
depth 3) 47 unique / 125 explored, (ns=1, depth 4) 36 / 119, and the goal
search GOAL_FOUND at depth 6 with 299 / 2887 and the trace
[0, 2, 3, 4, 5, 6] at chunk 256."""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores, and
# torch's default of one thread per core oversubscribes them, which slows
# the other workers' time-limited searches past their limits.
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from dslabs_tpu.tpu import engine as jeng  # noqa: E402
from dslabs_tpu.tpu import trace as jtrace  # noqa: E402
from dslabs_tpu.tpu.protocols.primarybackup import \
    make_pb_protocol as j_pb  # noqa: E402
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.primarybackup import \
    make_pb_protocol as t_pb  # noqa: E402
from dslabs_tpu_torch.tpu.trace import decode_trace  # noqa: E402

S = int(jeng.SENTINEL)
I32_MAX = 2 ** 31 - 1


def _key(out):
    return (out.end_condition, out.unique_states, out.states_explored,
            out.depth)


def _eq(ref, port):
    ref = np.asarray(ref)
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    assert ref.shape == port.shape, (ref.shape, port.shape)
    np.testing.assert_array_equal(ref, port)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------- random pair inputs

def _random_nodes(rng, p, proto, ns, nc):
    """Node vectors with every lane in a small range that reaches each
    branch (view numbers, ids, flags, seqs), plus rows whose ViewServer
    tick counters sit at the int32 limit."""
    nodes = rng.integers(-1, 4, size=(p, proto.node_width)).astype(np.int32)
    vsw = 5 + 2 * ns
    nodes[:, 1:3] = rng.integers(0, ns + 1, size=(p, 2))      # prim, back
    nodes[:, 5:vsw:2] = rng.integers(0, 3, size=(p, ns))      # ranks
    nodes[:, 6:vsw:2] = rng.integers(0, 3, size=(p, ns))      # ticks
    nodes[::5, 6:vsw:2] = I32_MAX - rng.integers(0, 2, size=(
        len(nodes[::5]), ns))
    sw = 6 + nc
    for s in range(ns):
        base = vsw + s * sw
        nodes[:, base + 1:base + 3] = rng.integers(0, ns + 1, size=(p, 2))
        nodes[:, base + 3] = rng.integers(0, 2, size=p)          # synced
        nodes[:, base + 4] = rng.integers(0, nc + 1, size=p)     # pend c+1
    return nodes


def _random_msgs(rng, p, proto, n_nodes):
    msg = rng.integers(-1, 4, size=(p, proto.msg_width)).astype(np.int32)
    msg[:, 0] = rng.integers(0, 9, size=p)                      # tag
    msg[:, 1:3] = rng.integers(0, n_nodes, size=(p, 2))         # frm, to
    return msg


_CONFIGS = [dict(ns=2, n_clients=1, w=1), dict(ns=1, n_clients=1, w=1),
            dict(ns=3, n_clients=2, w=2)]
_IDS = ["s2c1w1", "s1c1w1", "s3c2w2"]


@pytest.mark.parametrize("kw", _CONFIGS, ids=_IDS)
def test_handlers_match_jax_on_random_pairs(kw):
    """step_message / step_timer on 512 random (state, event) pairs:
    nodes', sends and timer sets equal the JAX twin's vmapped handlers
    lane for lane, blank (SENTINEL) rows included."""
    ns, nc = kw["ns"], kw["n_clients"]
    pj, pt = j_pb(**kw), t_pb(**kw)
    n_nodes = 1 + ns + nc
    rng = np.random.default_rng(ns * 10 + nc)
    p = 512
    nodes = _random_nodes(rng, p, pt, ns, nc)
    msg = _random_msgs(rng, p, pt, n_nodes)
    ref = jax.jit(jax.vmap(pj.step_message))(jnp.asarray(nodes),
                                             jnp.asarray(msg))
    out = pt.step_message(_t(nodes), _t(msg))
    for a, b in zip(ref, out):
        _eq(a, b)
    assert (out[1] != S).any() and (out[1] == S).any()
    assert (out[0] != _t(nodes)).any()

    node_idx = rng.integers(0, n_nodes, size=p).astype(np.int32)
    timer = rng.integers(0, 3, size=(p, pt.timer_width)).astype(np.int32)
    timer[:, 0] = rng.integers(1, 4, size=p)                    # tag
    timer[:, 3] = rng.integers(0, kw["w"] + 2, size=p)          # seq
    ref = jax.jit(jax.vmap(pj.step_timer))(
        jnp.asarray(nodes), jnp.asarray(node_idx), jnp.asarray(timer))
    out = pt.step_timer(_t(nodes), _t(node_idx), _t(timer))
    for a, b in zip(ref, out):
        _eq(a, b)
    assert (out[2] != S).any() and (out[2] == S).any()
    # Ping checks on rows at the limit wrapped exactly as JAX's int32.
    assert (out[0][:, 6:5 + 2 * ns:2] < 0).any()


@pytest.mark.parametrize("kw", _CONFIGS, ids=_IDS)
def test_initial_state_and_layout_match_jax(kw):
    js = jeng.TensorSearch(j_pb(**kw))
    ts = teng.TensorSearch(t_pb(**kw), device="cpu")
    assert js.lanes == ts.lanes and js._off == ts._off
    assert js._num_events() == ts._num_events()
    assert ts.p.max_sends == 5 and ts.p.max_sets == 3
    _eq(jeng.flatten_state(js.initial_state()),
        teng.flatten_state(ts.initial_state()))


# ------------------------------------------------------------ chunk expand

@pytest.fixture(scope="module")
def pb_frontiers():
    """Root and depth-1/2 frontiers of the ns=2 twin (one chunk each), with
    the JAX expand's outputs (dedup on) from one compiled program."""
    chunk = 32
    js = jeng.TensorSearch(j_pb(2, 1, 1), chunk=chunk)
    ts = teng.TensorSearch(t_pb(2, 1, 1), chunk=chunk, device="cpu")
    expand = jax.jit(functools.partial(js._expand_chunk, dedup=True))
    root = np.asarray(jeng.flatten_state(js.initial_state()))
    seen = {np.asarray(jeng.row_fingerprints(jnp.asarray(root)))[0]
            .tobytes()}
    frontier, out = root, []
    for _ in range(3):
        assert 0 < len(frontier) <= chunk
        rows = np.zeros((chunk, js.lanes), np.int32)
        rows[:len(frontier)] = frontier
        valid = np.arange(chunk) < len(frontier)
        res = jax.tree.map(np.asarray,
                           expand(jnp.asarray(rows), jnp.asarray(valid)))
        out.append((rows, valid, res, frontier))
        nxt = []
        for i in np.nonzero(res[1])[0]:
            k = res[2][i].tobytes()
            if k not in seen:
                seen.add(k)
                nxt.append(res[0][i])
        frontier = np.stack(nxt)
    return js, ts, out


@pytest.mark.parametrize("level", [0, 1, 2])
def test_expand_chunk_matches_jax(pb_frontiers, level):
    """Rows, valids, fingerprints, the prefilter's unique mask, event ids
    and goal flags all equal, invalid pair slots included."""
    _, ts, cases = pb_frontiers
    rows, valid, ref, _ = cases[level]
    out = ts._expand_chunk(_t(rows), _t(valid))
    (rows_j, val_j, fp_j, uniq_j, over_j, rem_j, ev_j, flags_j) = ref
    rows_t, val_t, fp_t, uniq_t, over_t, rem_t, ev_t, flags_t = out
    _eq(rows_j, rows_t)
    _eq(val_j, val_t)
    _eq(fp_j, fp_t.numpy().view(np.uint32))
    _eq(uniq_j, uniq_t)
    _eq(ev_j, ev_t)
    assert int(over_j) == int(over_t) == 0 and int(rem_j) == int(rem_t)
    assert flags_j.keys() == flags_t.keys() == {"goal:CLIENTS_DONE"}
    _eq(flags_j["goal:CLIENTS_DONE"], flags_t["goal:CLIENTS_DONE"])
    assert val_t.any()


def test_step_one_matches_jax(pb_frontiers):
    """Every grid event of every frontier row at depths 0-2: successor
    row, valid and overflow equal the JAX engine's ``_step_one``."""
    js, ts, cases = pb_frontiers
    p = ts.p
    step = jax.jit(js._step_one)
    grid = p.net_cap + p.n_nodes * p.timer_cap
    n_valid = 0
    for _, _, _, frontier in cases:
        for row in frontier:
            for ev in range(grid):
                r_j, v_j, o_j = step(jnp.asarray(row), jnp.int32(ev))
                r_t, v_t, o_t = ts._step_one(_t(row), ev)
                _eq(r_j, r_t)
                assert bool(v_j) == bool(v_t) and int(o_j) == int(o_t)
                n_valid += bool(v_t)
    assert n_valid > 50


# ---------------------------------------------------------------- searches

@pytest.mark.parametrize("ns,depth,unique,explored", [
    (2, 3, 47, 125), (1, 4, 36, 119)])
@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_depth_counts_match_pinned(ns, depth, unique, explored, host):
    p = dataclasses.replace(t_pb(ns, 1, 1), goals={})
    out = teng.TensorSearch(p, chunk=256, max_depth=depth,
                            use_host_visited=host, device="cpu").run()
    assert _key(out) == ("DEPTH_EXHAUSTED", unique, explored, depth)


def test_goal_trace_matches_pinned():
    """The goal search with a trace: pinned counts and trace, records
    equal to the JAX decode of that trace, replay ending at the goal."""
    ts = teng.TensorSearch(t_pb(2, 1, 1), chunk=256, max_depth=12,
                           record_trace=True, device="cpu")
    out = ts.run()
    assert _key(out) == ("GOAL_FOUND", 299, 2887, 6)
    assert out.trace == [0, 2, 3, 4, 5, 6]
    shim = jeng.SearchOutcome("GOAL_FOUND", 0, 0, 6, 0.0,
                              trace=list(out.trace))
    ref = jtrace.decode_trace(jeng.TensorSearch(j_pb(2, 1, 1)), shim)
    recs = decode_trace(ts, out)
    assert [r[0] for r in recs] == [r[0] for r in ref] == ["message"] * 6
    for (_, (a,)), (_, (b,)) in zip(ref, recs):
        _eq(a, b)
    row = teng.flatten_state(ts.initial_state())[0]
    for ev in out.trace:
        row, valid, _ = ts._step_one(row, ev)
        assert bool(valid)
    _eq(teng.flatten_state({k: _t(np.array(v)) for k, v in
                            out.goal_state.items()})[0], row)
