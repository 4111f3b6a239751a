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

from dslabs_tpu_torch.tpu import kernels, visited  # noqa: E402
from dslabs_tpu_torch.tpu.engine import TensorSearch  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.clientserver import \
    make_clientserver_protocol  # noqa: E402

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


@pytest.mark.parametrize("cap", [1 << 9, visited.BKT * 2])
def test_insert_kernel_matches_plain(cap):
    _need_card()
    keys, valid = _key_batch()
    n0 = visited.LAUNCHES["insert"]
    ta, ia, ua = visited.insert(visited.empty_table(cap, "cuda"), keys, valid)
    tb, ib, ub = visited.insert_plain(visited.empty_table(cap, "cuda"), keys,
                                      valid)
    assert torch.equal(ta[:-1], tb[:-1])
    assert torch.equal(ia, ib) and torch.equal(ua, ub)
    assert visited.LAUNCHES["insert"] == n0 + 1
    assert (int(ua.sum()) > 0) == (cap < 64)


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
