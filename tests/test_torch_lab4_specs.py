"""PyTorch port, the lab 4 twins (``dslabs_tpu_torch/tpu/specs_lab4.py``)
against the JAX package on the CPU, exact equality (everything is
integer):

- every twin's batched ``step_message`` / ``step_timer`` against
  ``jax.vmap`` of the JAX twin's steps on seeded random rows, SENTINEL
  rows and out-of-range per-pair indices included; the layouts, lane
  domains, packing descriptors, budgets and initial state agree;
- the predicates over ``_View`` on batches;
- the fragment arithmetic the multi-server twin leans on (the packed P1b
  log entry) on values near the top bit;
- the pinned unique-state counts through the port's device loop
  (``device="cpu"``): join g=1 3 / 10 at depths 1 / 3 and g=2 6 / 11 at
  depths 2 / 3 (tests/test_spec_parity.py); the part-1 store ``[1, 1]``
  6 / 23 / 74 at depths 1-3 and the two-group ``[1, 2, 1]`` 142 at depth
  3 (tests/test_tpu_lab4.py); tx ``n_tx=1`` 8 / 38 at depths 1-2; the
  multi-server twin 10 at depth 1 (the JAX package's generated and hand
  twins both count 10 there, and 69 at depth 2);
- the crash spec builds, and its ``compile()`` refuses."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from dslabs_tpu.tpu import compiler as jcomp  # noqa: E402
from dslabs_tpu.tpu import packing as jpack  # noqa: E402
from dslabs_tpu.tpu import specs_lab4 as jlab4  # noqa: E402
from dslabs_tpu_torch.tpu import compiler as tcomp  # noqa: E402
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.tpu import packing as tpack  # noqa: E402
from dslabs_tpu_torch.tpu import specs_lab4 as tlab4  # noqa: E402

S = 2 ** 31 - 1

# id -> function of the specs_lab4 module giving the spec, called with
# either package's module.
SPECS = {
    "join_g1": lambda m: m.make_join_spec(1),
    "join_g2": lambda m: m.make_join_spec(2),
    "store_11": lambda m: m.make_shardstore_spec([1, 1]),
    "store_121": lambda m: m.make_shardstore_spec([1, 2, 1]),
    "store_1_2": lambda m: m.make_shardstore_spec([[1], [2]]),
    "store_1_2_full": lambda m: m.make_shardstore_spec(
        [[1], [2]], model_master_timers=True, model_ctl=True),
    "tx_1": lambda m: m.make_shardstore_tx_spec(1),
    "multi": lambda m: m.make_shardstore_multi_spec(),
}


def _eq(ref, port):
    ref = np.asarray(ref)
    assert ref.shape == tuple(port.shape), (ref.shape, port.shape)
    np.testing.assert_array_equal(ref, port.numpy())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random_rows(rng, p, count=256):
    """Seeded node, message and timer rows: small lane values that reach
    the handlers' branches, node and slot indices one past either end of
    their range, and every 17th message / 13th timer a SENTINEL row."""
    n_types = p.lane_domains["msg"][0][1] + 1
    n_ttypes = p.lane_domains["timer"][0][1]
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


@pytest.mark.parametrize("name", list(SPECS))
def test_steps_match_jax_vmap(name):
    """The compiled twin's batched steps equal jax.vmap of the JAX twin's
    steps lane for lane (nodes', sends, timer sets), and the layouts,
    budgets, lane domains, packing descriptors and initial state
    agree."""
    sj, st = SPECS[name](jlab4), SPECS[name](tlab4)
    assert st._layout() == sj._layout()
    assert [k.name for k in st.nodes] == [k.name for k in sj.nodes]
    assert st.fragments == sj.fragments
    pj, pt = sj.compile(), st.compile()
    for f in ("name", "n_nodes", "node_width", "msg_width", "timer_width",
              "net_cap", "timer_cap", "max_sends", "max_sets",
              "max_live_sends", "lane_domains"):
        assert getattr(pt, f) == getattr(pj, f), f
    assert st._lane_domains() == sj._lane_domains()
    lanes = teng.TensorSearch(pt, device="cpu").lanes
    kj, kt = (jpack.derive_packing(pj, lanes),
              tpack.derive_packing(pt, lanes))
    assert (kt.words, kt.identity) == (kj.words, kj.identity)
    assert kt.words < kt.lanes == kj.lanes
    for f in ("word", "shift", "width", "lo", "sent", "raw", "dlt"):
        np.testing.assert_array_equal(getattr(kt, f), getattr(kj, f))
    np.testing.assert_array_equal(pt.init_nodes(), pj.init_nodes())
    np.testing.assert_array_equal(pt.init_messages(), pj.init_messages())
    np.testing.assert_array_equal(pt.init_timers(), pj.init_timers())
    rng = np.random.default_rng(sorted(SPECS).index(name))
    nodes, msg, node_idx, timer = _random_rows(rng, pt)
    ref = jax.vmap(pj.step_message)(jnp.asarray(nodes), jnp.asarray(msg))
    out = pt.step_message(_t(nodes), _t(msg))
    assert len(out) == len(ref)
    for a, b in zip(ref, out):
        _eq(a, b)
    assert (out[0] != _t(nodes)).any()
    assert (out[1] != S).any() and (out[1] == S).any()
    ref = jax.vmap(pj.step_timer)(jnp.asarray(nodes), jnp.asarray(node_idx),
                                  jnp.asarray(timer))
    out = pt.step_timer(_t(nodes), _t(node_idx), _t(timer))
    for a, b in zip(ref, out):
        _eq(a, b)


@pytest.mark.parametrize("name", ["store_121", "store_1_2", "tx_1"])
def test_predicates_match_jax_on_batches(name):
    """CLIENTS_DONE and the tx twin's MULTI_GETS_MATCH over the batched
    _View equal the JAX predicates vmapped over single states."""
    sj, st = SPECS[name](jlab4), SPECS[name](tlab4)
    table, width = st._layout()
    rng = np.random.default_rng(width)
    nodes = rng.integers(0, 5, size=(512, width)).astype(np.int32)
    view = tcomp._View(st, table, _t(nodes))
    preds = {**st.goals, **st.invariants}
    jpreds = {**sj.goals, **sj.invariants}
    assert preds.keys() == jpreds.keys()
    for k, fn in preds.items():
        ref = jax.vmap(lambda row, fn=jpreds[k]: fn(
            jcomp._View(sj, table, row)))(jnp.asarray(nodes))
        out = fn(view)
        _eq(ref, out)
        assert out.any() and not out.all(), k


def test_packed_log_entries_match_jax_near_the_top_bit():
    """The multi-server twin packs a log entry into one P1b lane
    (``cmd << 14``) and unpacks it with arithmetic shifts: a P1b step on
    payload lanes near the top bit, negative and SENTINEL, writes the
    same vote lanes in both packages."""
    pj, pt = SPECS["multi"](jlab4).compile(), SPECS["multi"](tlab4).compile()
    count = 96
    rng = np.random.default_rng(11)
    nodes = np.repeat(pt.init_nodes()[None], count, 0).astype(np.int32)
    tags = {m.name: i for i, m in enumerate(SPECS["multi"](tlab4).messages)}
    msg = np.zeros((count, pt.msg_width), np.int32)
    msg[:, 0] = tags["P1b"]
    msg[:, 1] = rng.integers(1, 4, size=count)          # from a g1 peer
    msg[:, 2] = 1                                       # to g1 server 0
    msg[:, 3] = 0                                       # ballot 0
    payload = rng.integers(-2 ** 31, 2 ** 31 - 1,
                           size=(count, pt.msg_width - 4))
    payload[::3] = S
    payload[1::3] = rng.integers(2 ** 30, 2 ** 31 - 1,
                                 size=payload[1::3].shape)
    msg[:, 4:] = payload.astype(np.int32)
    ref = jax.vmap(pj.step_message)(jnp.asarray(nodes), jnp.asarray(msg))
    out = pt.step_message(_t(nodes), _t(msg))
    for a, b in zip(ref, out):
        _eq(a, b)
    assert (out[0] != _t(nodes)).any()


# ------------------------------------------------------------ searches

def _count(p, depth, chunk=64):
    out = teng.TensorSearch(dataclasses.replace(p, goals={}), chunk=chunk,
                            max_depth=depth, visited_cap=1 << 14,
                            device="cpu").run()
    return out.unique_states


@pytest.mark.parametrize("g,depths,expect", [
    (1, (1, 3), (3, 10)), (2, (2, 3), (6, 11)),
])
def test_join_pinned_counts(g, depths, expect):
    p = tlab4.make_join_protocol(g)
    assert tuple(_count(p, d) for d in depths) == expect


def test_store_pinned_counts():
    """The part-1 store ``[1, 1]``: 6 / 23 / 74 unique at depths 1-3."""
    p = tlab4.make_shardstore_protocol([1, 1])
    assert [_count(p, d) for d in (1, 2, 3)] == [6, 23, 74]


def test_two_group_store_pinned_count():
    """The two-group config walk and g1 -> g2 handoff (``[1, 2, 1]``):
    142 unique at depth 3."""
    assert _count(tlab4.make_shardstore_protocol([1, 2, 1]), 3) == 142


def test_tx_pinned_counts():
    p = tlab4.make_shardstore_tx_protocol(1)
    assert [_count(p, d) for d in (1, 2)] == [8, 38]


def test_multi_pinned_count():
    """The multi-server twin: 10 unique at depth 1, the count both the
    JAX package's generated twin and its hand twin give on the CPU."""
    assert _count(tlab4.make_shardstore_multi_protocol(), 1) == 10


def test_crash_spec_compiles_to_pinned_counts():
    """The crash spec compiles like the JAX one (fault descriptor equal)
    and searches to tests/test_spec_parity.py's depth-2 pin: 30 unique,
    43 explored, 7 crash events (goals moved to prunes)."""
    sj, st = (jlab4.make_shardstore_crash_spec(),
              tlab4.make_shardstore_crash_spec())
    assert st.name == sj.name == "shardstore-g1-c1-w2-crash"
    assert [k.name for k in st.nodes] == [k.name for k in sj.nodes]
    assert st._layout() == sj._layout()
    pj, pt = sj.compile(), st.compile()
    assert pt.fault.signature() == pj.fault.signature()
    np.testing.assert_array_equal(pt.fault.wipe, pj.fault.wipe)
    p = dataclasses.replace(pt, goals={}, prunes=dict(pt.goals))
    out = teng.TensorSearch(p, chunk=32, max_depth=2, visited_cap=1 << 14,
                            device="cpu").run()
    assert (out.unique_states, out.states_explored, out.crash_events) == (
        30, 43, 7)
