"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version on the same device tensors, and a search through the kernels
against the plain path.  Needs an NVIDIA GPU with nvcc (the kernels have
no CPU mode) and imports no JAX, so on the card it runs without the
suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Elsewhere every test skips.  ``chip_smoke.py`` repeats these checks at
the main path's full size."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores, and
# torch's default of one thread per core oversubscribes them, which slows
# the other workers' time-limited searches past their limits.
torch.set_num_threads(1)

from dslabs_tpu_torch.tpu import kernels, visited  # noqa: E402
from dslabs_tpu_torch.tpu.engine import TensorSearch  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.clientserver import \
    make_clientserver_protocol  # noqa: E402
from dslabs_tpu_torch.tpu.trace import decode_trace  # noqa: E402
from tests.torch_insert_cases import (  # noqa: E402
    crowded_case, many_rounds_case)

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _key_batch(n=300, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2 ** 32, size=(n, 4), dtype=np.uint32)
    keys[50:60] = keys[0:10]
    keys[99] = np.uint32(0xFFFFFFFF)
    return (torch.from_numpy(keys.view(np.int32)).cuda(),
            torch.from_numpy(rng.random(n) > 0.2).cuda())


@pytest.mark.parametrize("b,l", [(1001, 842), (7, 167), (1, 4)])
def test_fingerprint_kernel_matches_plain(b, l):
    _need_card()
    rng = np.random.default_rng(b + l)
    flat = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(b, l))
                            .astype(np.int32)).cuda()
    n0 = kernels.LAUNCHES["fingerprint_rows"]
    assert torch.equal(kernels.fingerprint_rows(flat),
                       kernels.row_fingerprints(flat))
    assert kernels.LAUNCHES["fingerprint_rows"] == n0 + 1


def _empty_case(cap, n=300):
    keys, valid = _key_batch(n)
    return visited.empty_table(cap, "cuda"), keys, valid


def _numpy_case(build):
    table, keys, valid = build()
    return (torch.from_numpy(table.view(np.int32)).cuda(),
            torch.from_numpy(keys.view(np.int32)).cuda(),
            torch.from_numpy(valid).cuda())


def _one_key():
    keys = torch.full((1, 4), -1, dtype=torch.int32, device="cuda")
    return (visited.empty_table(1 << 9, "cuda"), keys,
            torch.ones((1,), dtype=torch.bool, device="cuda"))


@pytest.mark.parametrize("case,outcome", [
    pytest.param(lambda: _empty_case(1 << 9), lambda i, u: not u.any(),
                 id="512"),
    pytest.param(lambda: _empty_case(visited.BKT * 2), lambda i, u: u.any(),
                 id="16"),                                      # overflows
    # More than T keys outlive the full phase; the tail cut decides.
    pytest.param(lambda: _numpy_case(many_rounds_case),
                 lambda i, u: int(u.sum()) > 256, id="many-rounds"),
    pytest.param(lambda: _numpy_case(crowded_case),
                 lambda i, u: int(u.sum()) > (1 << 15) // 8 and i.any(),
                 id="crowded-2^16"),
    pytest.param(_one_key, lambda i, u: bool(i.all()), id="n=1"),
    # n a multiple of neither the block (512 threads) nor its 64 probes.
    pytest.param(lambda: _empty_case(1 << 12, n=1001),
                 lambda i, u: not u.any(), id="n=1001"),
])
def test_insert_kernel_matches_plain(case, outcome):
    """The kernel against insert_plain on table rows [0, V), inserted and
    unresolved, with exactly one launch per call."""
    _need_card()
    table, keys, valid = case()
    n0 = visited.LAUNCHES["insert"]
    ta, ia, ua = visited.insert(table.clone(), keys, valid)
    tb, ib, ub = visited.insert_plain(table.clone(), keys, valid)
    assert torch.equal(ta[:-1], tb[:-1])
    assert torch.equal(ia, ib) and torch.equal(ua, ub)
    assert visited.LAUNCHES["insert"] == n0 + 1
    assert outcome(ia, ua)


def test_search_through_kernels_matches_plain_path():
    _need_card()
    p = make_clientserver_protocol(3, 4, net_cap=32)
    kw = dict(max_depth=12, chunk=1024, visited_cap=1 << 16)
    n0 = (kernels.LAUNCHES["fingerprint_rows"], visited.LAUNCHES["insert"])
    card = TensorSearch(p, **kw).run()
    assert kernels.LAUNCHES["fingerprint_rows"] > n0[0]
    assert visited.LAUNCHES["insert"] > n0[1]
    plain = TensorSearch(p, device="cpu", **kw).run()
    key = ("DEPTH_EXHAUSTED", 1723, 17292, 12)
    for out in (card, plain):
        assert (out.end_condition, out.unique_states, out.states_explored,
                out.depth) == key


@pytest.mark.parametrize("kw", [
    dict(record_trace=True),                     # goal search with trace
    dict(use_host_visited=True, max_depth=6),    # before the goal (depth 8)
], ids=["trace", "host_visited"])
def test_run_host_on_card_matches_cpu_path(kw):
    """run_host through the fingerprint kernel equals the plain path on
    the CPU: counts, the visited set, the trace and its decoded records;
    the host keeps the visited set, so the insert kernel never runs."""
    _need_card()
    p = make_clientserver_protocol(2, 2)
    n0 = (kernels.LAUNCHES["fingerprint_rows"], visited.LAUNCHES["insert"])
    card_ts = TensorSearch(p, chunk=64, **kw)
    card = card_ts.run()
    assert kernels.LAUNCHES["fingerprint_rows"] > n0[0]
    assert visited.LAUNCHES["insert"] == n0[1]
    cpu_ts = TensorSearch(p, chunk=64, device="cpu", **kw)
    cpu = cpu_ts.run()
    assert (card.end_condition, card.unique_states, card.states_explored,
            card.depth, card.trace) == (cpu.end_condition, cpu.unique_states,
                                        cpu.states_explored, cpu.depth,
                                        cpu.trace)
    for a, b in zip(card_ts._host_visited, cpu_ts._host_visited):
        np.testing.assert_array_equal(a, b)
    if card.trace is not None:
        assert card.end_condition == "GOAL_FOUND"
        for k in cpu.goal_state:
            np.testing.assert_array_equal(card.goal_state[k],
                                          cpu.goal_state[k])
        for (ka, pa), (kb, pb) in zip(decode_trace(card_ts, card),
                                      decode_trace(cpu_ts, cpu)):
            assert ka == kb
            np.testing.assert_array_equal(pa[-1], pb[-1])


@pytest.mark.parametrize("d", [1, 4])
def test_sharded_through_kernels_matches_plain_path(d):
    """``ShardedTensorSearch`` at D shards on the card equals the plain path
    at the same width on the CPU: the counts and every level's per-shard
    frontier occupancies; kernel 1 runs once per chunk step and kernel 2
    D times (plus the root's)."""
    _need_card()
    from dslabs_tpu_torch.tpu.sharded import ShardedTensorSearch, make_mesh

    p = make_clientserver_protocol(3, 4, net_cap=32)
    kw = dict(max_depth=12, chunk_per_device=1024 // d,
              frontier_cap=1 << 12, visited_cap=1 << 16)
    n0 = (kernels.LAUNCHES["fingerprint_rows"], visited.LAUNCHES["insert"])
    s = ShardedTensorSearch(p, make_mesh(d), **kw)
    card = s.run()
    steps = s.chunk_steps
    assert kernels.LAUNCHES["fingerprint_rows"] - n0[0] == steps + 2
    assert visited.LAUNCHES["insert"] - n0[1] == d * (steps + 1)
    plain = ShardedTensorSearch(p, make_mesh(d, device="cpu"), **kw).run()
    key = ("DEPTH_EXHAUSTED", 1723, 17292, 12)
    for out in (card, plain):
        assert (out.end_condition, out.unique_states, out.states_explored,
                out.depth) == key
    assert [lv["per_device"]["frontier"] for lv in card.levels] == \
        [lv["per_device"]["frontier"] for lv in plain.levels]
