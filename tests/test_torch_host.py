"""PyTorch port, the trace-recording host loop (``TensorSearch.run_host``),
its witness traces (``tpu/trace.py``) and runtime delivery masks, against
the JAX package on the CPU.  Everything is integer, so every comparison is
exact.

Where the JAX result is pinned (the Paxos twin's goal search: 7540 unique
at depth 7 with the trace [48, 3, 5, 0, 6, 8, 11], measured on the JAX
package), the port is compared with the number instead of paying for the
JAX search; the decoded records are still compared with the JAX
``decode_trace`` of the same trace."""

import dataclasses
import os
import sys

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
from dslabs_tpu.tpu.protocols.clientserver import \
    make_clientserver_protocol as j_cs  # noqa: E402
from dslabs_tpu.tpu.protocols.pingpong import \
    make_pingpong_protocol as j_pp  # noqa: E402
from dslabs_tpu.tpu.protocols.primarybackup import \
    make_pb_protocol as j_pb  # noqa: E402
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.clientserver import \
    make_clientserver_protocol as t_cs  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.paxos import \
    make_paxos_protocol as t_px  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.pingpong import \
    make_pingpong_protocol as t_pp  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.primarybackup import \
    make_pb_protocol as t_pb  # noqa: E402
from dslabs_tpu_torch.tpu.trace import decode_trace  # noqa: E402

_FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
if _FIXTURES not in sys.path:
    sys.path.insert(0, _FIXTURES)

from hand_twins.paxos import make_paxos_protocol as j_px  # noqa: E402

PAXOS_KW = dict(n=3, n_clients=1, max_slots=2, net_cap=48, timer_cap=6)
SMALL = dict(chunk=64, visited_cap=1 << 12)


def _key(out):
    return (out.end_condition, out.unique_states, out.states_explored,
            out.depth)


def _goal_as_prune(p):
    return dataclasses.replace(
        p, goals={}, prunes={"CLIENTS_DONE": p.goals["CLIENTS_DONE"]})


def _records_equal(ref, port):
    assert len(ref) == len(port)
    for (kind_j, pay_j), (kind_t, pay_t) in zip(ref, port):
        assert kind_j == kind_t
        if kind_j == "timer":
            assert int(pay_j[0]) == pay_t[0]
        np.testing.assert_array_equal(np.asarray(pay_j[-1]), pay_t[-1])


def _replay_end(ts, out):
    """The state decode_trace's last step reaches, as [lanes] numpy."""
    row = teng.flatten_state({k: torch.as_tensor(v) for k, v in
                              ts._trace_root.items()})[0]
    for ev in out.trace:
        row, valid, _ = ts._step_one(row, ev)
        assert bool(valid)
    return row.numpy()


def _state_row(state):
    return teng.flatten_state({k: torch.as_tensor(np.array(v))
                               for k, v in state.items()})[0].numpy()


# ------------------------------------------------------------ host helpers

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sorted_member_matches_jax(seed):
    """Membership against a visited set with long runs of equal h1 (3-way
    and wider collisions), queries hitting every position of a run."""
    rng = np.random.default_rng(seed)
    vh1 = rng.integers(0, 40, size=300).astype(np.uint64)
    vh2 = rng.integers(0, 2 ** 63, size=300, dtype=np.uint64)
    order = np.lexsort((vh2, vh1))
    vh1, vh2 = vh1[order], vh2[order]
    q = rng.integers(0, 300, size=400)
    h1, h2 = vh1[q].copy(), vh2[q].copy()
    h2[::3] += np.uint64(1)                    # same h1, other h2
    h1[::7] += np.uint64(1000)                 # absent h1
    ref = jeng.sorted_member(vh1, vh2, h1, h2)
    out = teng.sorted_member(vh1, vh2, h1, h2)
    np.testing.assert_array_equal(ref, out)
    assert np.bincount(vh1.astype(np.int64)).max() >= 3
    # A hit on the third or later key of a run of equal h1.
    run_pos = q - np.searchsorted(vh1, vh1[q], side="left")
    assert (out & (run_pos >= 2)).any() and (~out).any()
    assert not teng.sorted_member(vh1[:0], vh2[:0], h1, h2).any()


def test_drop_pending_messages_matches_jax():
    ts = teng.TensorSearch(t_cs(2, 1), device="cpu")
    js = jeng.TensorSearch(j_cs(2, 1))
    ref = jeng.drop_pending_messages(js.initial_state())
    out = teng.drop_pending_messages(
        {k: v.numpy() for k, v in ts.initial_state().items()})
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ref[k]),
                                      np.asarray(out[k]))
    assert (np.asarray(out["net"]) == teng.SENTINEL).all()


def _port_frontiers(ts, levels):
    """Frontier rows [k, lanes] of the root and the next ``levels`` BFS
    levels, deduplicated by fingerprint (the port's expand is held to the
    JAX one in test_torch_engine.py)."""
    root = teng.flatten_state(ts.initial_state())
    seen = {tuple(teng.row_fingerprints(root)[0].tolist())}
    out = [root]
    for _ in range(levels):
        cur = out[-1]
        rows, valids, fp = ts._expand_chunk(
            cur, torch.ones(len(cur), dtype=torch.bool), dedup=False)[:3]
        nxt = []
        for i in torch.nonzero(valids).squeeze(1).tolist():
            k = tuple(fp[i].tolist())
            if k not in seen:
                seen.add(k)
                nxt.append(rows[i])
        out.append(torch.stack(nxt))
    return out


def test_step_one_matches_jax():
    """Every grid event (message slots, then the timer grid) of every
    frontier row at levels 0-2 of lab1 (2,1): successor row, valid and
    overflow equal, undeliverable events included."""
    p_t, p_j = t_cs(2, 1), j_cs(2, 1)
    ts = teng.TensorSearch(p_t, chunk=16, device="cpu")
    js = jeng.TensorSearch(p_j, chunk=16)
    step = jax.jit(js._step_one)
    grid = p_t.net_cap + p_t.n_nodes * p_t.timer_cap
    n_valid = 0
    for level in _port_frontiers(ts, 2):
        for row in level:
            row_j = jnp.asarray(row.numpy())
            for ev in range(grid):
                r_j, v_j, o_j = step(row_j, jnp.int32(ev))
                r_t, v_t, o_t = ts._step_one(row, ev)
                np.testing.assert_array_equal(np.asarray(r_j), r_t.numpy())
                assert bool(v_j) == bool(v_t)
                assert int(o_j) == int(o_t)
                n_valid += bool(v_t)
    assert n_valid > 10
    with pytest.raises(ValueError):
        ts._step_one(row, grid)


# ---------------------------------------------------------------- run_host

_HOST_CASES = {
    "pingpong": (lambda: j_pp(2), lambda: t_pp(2), {}),
    "lab1_2_1_pruned": (lambda: _goal_as_prune(j_cs(2, 1)),
                        lambda: _goal_as_prune(t_cs(2, 1)), {}),
    "paxos_d3": (lambda: dataclasses.replace(j_px(**PAXOS_KW), goals={}),
                 lambda: dataclasses.replace(t_px(**PAXOS_KW), goals={}),
                 dict(max_depth=3)),
}


@pytest.mark.parametrize("case", sorted(_HOST_CASES))
def test_run_host_matches_jax(case):
    """use_host_visited runs the host loop: counts and the exact visited
    set equal the JAX host loop's.  Where no goal ends the search early
    (the host loop stops after the chunk that hits, the device loop after
    the wave), the counts also equal the port's device loop's."""
    make_j, make_t, kw = _HOST_CASES[case]
    js = jeng.TensorSearch(make_j(), use_host_visited=True, **SMALL, **kw)
    ref = js.run()
    ts = teng.TensorSearch(make_t(), use_host_visited=True, device="cpu",
                           **SMALL, **kw)
    out = ts.run()
    assert _key(out) == _key(ref)
    assert out.trace is None and ts._levels == []
    for a, b in zip(js._host_visited, ts._host_visited):
        np.testing.assert_array_equal(a, b)
    assert len(ts._host_visited[0]) == out.unique_states
    if out.end_condition != "GOAL_FOUND":
        dev = teng.TensorSearch(make_t(), device="cpu", **SMALL, **kw).run()
        assert _key(dev) == _key(out)
    if case == "paxos_d3":
        assert out.unique_states == 102     # tests/test_spec_parity.py


def test_in_chunk_dedup_off_same_search():
    """in_chunk_dedup=False hands every valid successor to the level-wide
    host dedup: the same counts, visited set and trace."""
    p = t_cs(2, 1)
    on = teng.TensorSearch(p, record_trace=True, device="cpu", **SMALL)
    off = teng.TensorSearch(p, record_trace=True, in_chunk_dedup=False,
                            device="cpu", **SMALL)
    a, b = on.run(), off.run()
    assert _key(a) == _key(b) and a.trace == b.trace
    for x, y in zip(on._host_visited, off._host_visited):
        np.testing.assert_array_equal(x, y)
    rows = teng.flatten_state(off.initial_state()).repeat(4, 1)
    valid = torch.tensor([True, True, False, False])
    out = off._expand_chunk(rows, valid)
    assert torch.equal(out[3], out[1])        # unique = valids


# ------------------------------------------------------------------ traces

@pytest.mark.parametrize("make_j,make_t", [
    (lambda: j_pp(2), lambda: t_pp(2)),
    (lambda: j_cs(2, 1), lambda: t_cs(2, 1)),
], ids=["pingpong", "clientserver"])
def test_trace_matches_jax(make_j, make_t):
    """record_trace goal searches: the same trace, decoded records and
    goal state as the JAX engine; replaying the trace reaches the goal."""
    js = jeng.TensorSearch(make_j(), record_trace=True, **SMALL)
    ref = js.run()
    ts = teng.TensorSearch(make_t(), record_trace=True, device="cpu",
                           **SMALL)
    out = ts.run()
    assert out.end_condition == "GOAL_FOUND"
    assert _key(out) == _key(ref) and out.trace == ref.trace
    assert len(out.trace) == out.depth
    _records_equal(jtrace.decode_trace(js, ref), decode_trace(ts, out))
    np.testing.assert_array_equal(_replay_end(ts, out),
                                  _state_row(out.goal_state))
    np.testing.assert_array_equal(_state_row(ref.goal_state),
                                  _state_row(out.goal_state))


def test_paxos_goal_trace_matches_pinned():
    """The Paxos twin's goal search (n=3, 1 client, 2 slots): the pinned
    unique count, depth and trace, which do not depend on the chunk; the
    records equal the JAX decode of that trace, and the replay ends at the
    goal state.  A small chunk and an event budget of (16, 8) pair slots
    (every state here has fewer valid events) keep the CPU run short, and
    the budget makes the trace go through the compacted-slot to grid-id
    mapping.  (The explored count of a goal search depends on the chunk:
    chip_smoke.py checks the pinned 77101 at chunk 1024 on the card.)"""
    ts = teng.TensorSearch(t_px(**PAXOS_KW), chunk=128, max_depth=12,
                           ev_budget=(16, 8), record_trace=True,
                           device="cpu")
    out = ts.run()
    assert (out.end_condition, out.unique_states, out.depth) == \
        ("GOAL_FOUND", 7540, 7)
    assert out.states_explored > 26389       # levels 1-6 in full
    assert out.trace == [48, 3, 5, 0, 6, 8, 11]
    js = jeng.TensorSearch(j_px(**PAXOS_KW))
    shim = jeng.SearchOutcome("GOAL_FOUND", 0, 0, 7, 0.0,
                              trace=list(out.trace))
    _records_equal(jtrace.decode_trace(js, shim), decode_trace(ts, out))
    np.testing.assert_array_equal(_replay_end(ts, out),
                                  _state_row(out.goal_state))


def _first_done(nodes_col):
    """Stage-1 goal for lab1 (1 client, w=2): the first command done."""
    return nodes_col >= 2


def test_staged_search_trace_replays_from_root():
    """Stage 1 finds the first command done; stage 2 restarts from that
    state with the network dropped (retry timers re-drive it) and finds
    CLIENTS_DONE.  Stage 2's trace is relative to its own root: it replays
    from ``_trace_root``, and both stages equal the JAX engine's."""
    pj, pt = j_cs(1, 2), t_cs(1, 2)
    pj1 = dataclasses.replace(
        pj, goals={"FIRST": lambda s: _first_done(s["nodes"][1])})
    pt1 = dataclasses.replace(
        pt, goals={"FIRST": lambda s: _first_done(s["nodes"][:, 1])})
    ref1 = jeng.TensorSearch(pj1, record_trace=True, **SMALL).run()
    ts1 = teng.TensorSearch(pt1, record_trace=True, device="cpu", **SMALL)
    out1 = ts1.run()
    assert _key(out1) == _key(ref1) and out1.trace == ref1.trace
    js2 = jeng.TensorSearch(pj, record_trace=True, **SMALL)
    ref2 = js2.run(initial=jeng.drop_pending_messages(ref1.goal_state))
    ts2 = teng.TensorSearch(pt, record_trace=True, device="cpu", **SMALL)
    staged = teng.drop_pending_messages(out1.goal_state)
    out2 = ts2.run(initial=staged)
    assert out2.end_condition == "GOAL_FOUND"
    assert _key(out2) == _key(ref2) and out2.trace == ref2.trace
    np.testing.assert_array_equal(_state_row(ts2._trace_root),
                                  _state_row(staged))
    _records_equal(jtrace.decode_trace(js2, ref2), decode_trace(ts2, out2))
    np.testing.assert_array_equal(_replay_end(ts2, out2),
                                  _state_row(out2.goal_state))


def test_decode_trace_rejects_foreign_traces():
    ts = teng.TensorSearch(t_pp(2), record_trace=True, device="cpu",
                           **SMALL)
    out = ts.run()
    with pytest.raises(ValueError, match="no trace"):
        decode_trace(ts, dataclasses.replace(out, trace=None))
    # Slot 3 of the root's network is empty: not deliverable.
    with pytest.raises(ValueError, match="undeliverable"):
        decode_trace(ts, dataclasses.replace(out, trace=[3]))


# ------------------------------------------------------------ runtime masks

PB_NN = 4                      # ViewServer, two servers, one client
CUT = 3                        # the client


def _link_matrix():
    marr = np.ones((PB_NN, PB_NN), bool)
    marr[CUT, :] = False
    marr[:, CUT] = False
    return marr.reshape(-1), np.ones(PB_NN, bool)


def _j_msg_mask(msg, marr, nn=PB_NN):
    """Per message, as the JAX harness binding writes it."""
    k = msg[1].clip(0, nn - 1) * nn + msg[2].clip(0, nn - 1)
    return jnp.sum(jnp.where(jnp.arange(nn * nn) == k, marr, False))


def _j_tmr_mask(node, tarr, nn=PB_NN):
    return jnp.sum(jnp.where(jnp.arange(nn) == node, tarr, False))


def _t_msg_mask(msg, marr, nn=PB_NN):
    """Batched over the leading dimensions."""
    k = msg[..., 1].clamp(0, nn - 1) * nn + msg[..., 2].clamp(0, nn - 1)
    return marr[k.to(torch.int64)]


def _t_tmr_mask(node, tarr):
    return tarr[node.to(torch.int64)]


@pytest.fixture(scope="module")
def masked_pb_counts():
    """The JAX engine's host and device loops on the lab2 twin with the
    client cut off, depth 5, from one protocol."""
    p = dataclasses.replace(j_pb(2, 1, 1), deliver_message_rt=_j_msg_mask,
                            deliver_timer_rt=_j_tmr_mask)
    marr, tarr = _link_matrix()
    out = {}
    for loop, kw in (("host", dict(use_host_visited=True)),
                     ("device", {})):
        js = jeng.TensorSearch(p, max_depth=5, **SMALL, **kw)
        js.set_runtime_masks(marr, tarr)
        out[loop] = _key(js.run())
    return out


@pytest.mark.parametrize("loop", ["host", "device"])
def test_runtime_masks_match_jax(masked_pb_counts, loop):
    """A link matrix that cuts the client off: both of the port's loops
    give the JAX loops' counts, which differ from the unmasked search's."""
    assert masked_pb_counts["host"] == masked_pb_counts["device"]
    p = dataclasses.replace(t_pb(2, 1, 1), deliver_message_rt=_t_msg_mask,
                            deliver_timer_rt=_t_tmr_mask)
    kw = dict(use_host_visited=True) if loop == "host" else {}
    ts = teng.TensorSearch(p, max_depth=5, device="cpu", **SMALL, **kw)
    unmasked = _key(ts.run())
    ts.set_runtime_masks(*_link_matrix())
    assert ts._rt_masks[0].device.type == "cpu"
    out = _key(ts.run())
    assert out == masked_pb_counts[loop]
    assert out[1] < unmasked[1]
