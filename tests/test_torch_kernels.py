"""PyTorch port, kernel modules: the 128-bit row fingerprint
(``dslabs_tpu_torch/tpu/kernels.py``) and the visited-table probe/insert
(``dslabs_tpu_torch/tpu/visited.py``) against the JAX package.

Inputs are made from a seed with numpy and handed to both frameworks.
On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
its jnp reference and its Pallas kernel in interpret mode.  Tolerance is
exact equality everywhere: all of this is integer arithmetic.  The CUDA
kernels themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from dslabs_tpu.tpu import engine as jeng  # noqa: E402
from dslabs_tpu.tpu import kernels as jkern  # noqa: E402
from dslabs_tpu.tpu import visited as jvis  # noqa: E402
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.tpu import interop  # noqa: E402
from dslabs_tpu_torch.tpu import kernels as tkern  # noqa: E402
from dslabs_tpu_torch.tpu import visited as tvis  # noqa: E402


def _rows(b, l, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-2 ** 31, 2 ** 31, size=(b, l),
                        dtype=np.int64).astype(np.int32)


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


# ------------------------------------------------------------- fingerprints

@pytest.mark.parametrize("b,l", [
    (128, 64), (384, 257), (135, 33), (5, 4),   # tests/test_tpu_kernels.py
    (128, 842),                                  # flagship Paxos row width
])
def test_fingerprint_plain_matches_jax(b, l):
    flat = _rows(b, l, b * 1000 + l)
    ref = np.asarray(jeng.row_fingerprints(jnp.asarray(flat)))
    pal = np.asarray(jkern.fingerprint_rows(jnp.asarray(flat),
                                            mode="interpret"))
    port = _u32(tkern.row_fingerprints(torch.from_numpy(flat)))
    np.testing.assert_array_equal(ref, port)
    np.testing.assert_array_equal(pal, port)


def test_fingerprint_wrapper_cpu_runs_plain_version():
    flat = torch.from_numpy(_rows(70, 167, 7))
    before = dict(tkern.LAUNCHES)
    out = tkern.fingerprint_rows(flat)
    assert torch.equal(out, tkern.row_fingerprints(flat))
    assert out.dtype == torch.int32 and out.shape == (70, 4)
    assert tkern.LAUNCHES == before          # no kernel on a CPU tensor


def test_mix32_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2 ** 32, size=(64, 9), dtype=np.uint64)
    seed = rng.integers(0, 2 ** 32, size=(1, 9), dtype=np.uint64)
    ref = np.asarray(jeng._mix32(jnp.asarray(x.astype(np.uint32)),
                                 jnp.asarray(seed.astype(np.uint32))))
    port = tkern._mix32(torch.from_numpy(x.astype(np.int64)),
                       torch.from_numpy(seed.astype(np.int64)))
    np.testing.assert_array_equal(ref.astype(np.int64), port.numpy())


def test_host_keys_roundtrip_matches_jax():
    rng = np.random.default_rng(5)
    fp = rng.integers(0, 2 ** 32, size=(50, 4), dtype=np.uint32)
    h1j, h2j = jeng.host_keys(fp)
    h1t, h2t = teng.host_keys(fp.view(np.int32))
    np.testing.assert_array_equal(h1j, h1t)
    np.testing.assert_array_equal(h2j, h2t)
    np.testing.assert_array_equal(teng._keys_to_rows((h1t, h2t)), fp)


# ------------------------------------------------------------------- insert

def _key_batch(n=300, seed=0):
    """The tests/test_mesh_exchange.py batch: in-batch duplicates, the
    all-MAX key, 20% invalid rows."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2 ** 32, size=(n, 4), dtype=np.uint32)
    keys[50:60] = keys[0:10]
    keys[99] = np.uint32(0xFFFFFFFF)
    valid = rng.random(n) > 0.2
    return keys, valid


def _port_insert(table_np, keys, valid, fn=tvis.insert_plain):
    t = interop.table_from_numpy(table_np, "cpu")
    t2, ins, unres = fn(t, interop.keys_from_numpy(keys, "cpu"),
                        torch.from_numpy(valid))
    return interop.table_to_numpy(t2), ins.numpy(), unres.numpy()


def _empty_case(cap):
    keys, valid = _key_batch()
    return np.asarray(jvis.empty_table(cap)), keys, valid


def _crowded_case(seed=8):
    """A 2^10-slot table full except one bucket X, and 2048 keys that all
    step by one bucket a round from homes 1..20 buckets past X: they
    first reach X in tail rounds 44..63, so more than T = 256 keys stay
    unresolved through all 64 full rounds, and which keys the tail takes
    (the lowest-index T) decides which win X's 8 slots.  Adds invalid
    rows, keys already in the table, in-batch duplicates and the all-MAX
    key."""
    rng = np.random.default_rng(seed)
    cap, X, n = 1 << 10, 5, 2048
    vb = cap // jvis.BKT
    table = rng.integers(0, 2 ** 32, size=(cap + 1, 4), dtype=np.uint32)
    home = np.arange(cap) // jvis.BKT           # each stored key at home
    table[:cap, 2] = (table[:cap, 2] & ~np.uint32(vb - 1)) | home
    table[X * jvis.BKT:(X + 1) * jvis.BKT] = 0xFFFFFFFF
    table[cap] = 0xFFFFFFFF                      # dump row
    keys = rng.integers(0, 2 ** 32, size=(n, 4), dtype=np.uint32)
    keys[:, 1] &= 1                              # probe step 1
    near = (X + 1 + rng.integers(0, 20, size=n)) % vb
    keys[:, 2] = (keys[:, 2] & ~np.uint32(vb - 1)) | near.astype(np.uint32)
    keys[200:210] = table[300:310]               # already present
    keys[100:120] = keys[1000:1020]              # in-batch duplicates
    keys[7] = 0xFFFFFFFF
    valid = rng.random(n) > 0.2
    valid[7] = True
    return table, keys, valid


def _crowded_outcome(it, ut):
    return (int(ut.sum()) > 256                  # U > T after the tail
            and 0 < int(it.sum()) <= jvis.BKT    # X's slots, in the tail
            and not (it[200:210] | ut[200:210]).any())  # present


@pytest.mark.parametrize("case,outcome", [
    pytest.param(lambda: _empty_case(1 << 9),
                 lambda it, ut: not ut.any(), id="512-False"),
    pytest.param(lambda: _empty_case(jvis.BKT * 2),
                 lambda it, ut: ut.any(), id="16-True"),      # overflows
    pytest.param(_crowded_case, _crowded_outcome, id="many-rounds"),
])
def test_insert_plain_matches_jax(case, outcome):
    """The port's insert_plain against insert_jnp and the Pallas kernel
    (interpret mode) on the table, inserted and unresolved: on an empty
    table, on one that overflows, and on a crowded one where more than T
    keys stay unresolved through every full round and the tail cuts to
    the lowest-index T of them."""
    table, keys, valid = case()
    tj, ij, uj = jvis.insert_jnp(jnp.asarray(table), jnp.asarray(keys),
                                 jnp.asarray(valid))
    tp, ip, up = jvis.pallas_insert(jnp.asarray(table), jnp.asarray(keys),
                                    jnp.asarray(valid), interpret=True)
    tt, it, ut = _port_insert(table, keys, valid)
    for ref_t, ref_i, ref_u in ((tj, ij, uj), (tp, ip, up)):
        np.testing.assert_array_equal(np.asarray(ref_t)[:-1], tt[:-1])
        np.testing.assert_array_equal(np.asarray(ref_i), it)
        np.testing.assert_array_equal(np.asarray(ref_u), ut)
    assert outcome(it, ut)
    # Invalid rows are never inserted nor unresolved; each distinct new
    # key is inserted once.
    assert not (it & ~valid).any() and not (ut & ~valid).any()
    assert tt[-1].tolist() == [0xFFFFFFFF] * 4     # dump row untouched


def test_insert_wrapper_cpu_runs_plain_version():
    keys, valid = _key_batch(seed=1)
    table = np.asarray(jvis.empty_table(1 << 10))
    before = dict(tvis.LAUNCHES)
    a = _port_insert(table, keys, valid, fn=tvis.insert)
    b = _port_insert(table, keys, valid)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert tvis.LAUNCHES == before


def test_insert_continues_a_jax_table():
    """Interop: a table built by the JAX package, carried across with
    table_from_numpy, takes a second batch exactly as JAX does."""
    k1, v1 = _key_batch(seed=2)
    k2, v2 = _key_batch(seed=3)
    k2[:40] = k1[:40]                  # half-seen second batch
    tj, _, _ = jvis.insert_jnp(jvis.empty_table(1 << 9), jnp.asarray(k1),
                               jnp.asarray(v1))
    tj2, ij, uj = jvis.insert_jnp(tj, jnp.asarray(k2), jnp.asarray(v2))
    tt, it, ut = _port_insert(np.asarray(tj), k2, v2)
    np.testing.assert_array_equal(np.asarray(tj2)[:-1], tt[:-1])
    np.testing.assert_array_equal(np.asarray(ij), it)
    np.testing.assert_array_equal(np.asarray(uj), ut)
    assert not (it[:40] & v1[:40]).any()   # present: never re-inserted


def test_build_table_and_host_helpers_match_jax():
    keys, _ = _key_batch(n=120, seed=4)
    tj, nij, nuj = jvis.build_table(1 << 8, keys)
    tt, nit, nut = tvis.build_table(
        1 << 8, interop.keys_from_numpy(keys, "cpu"), "cpu")
    assert (nij, nuj) == (nit, nut)
    np.testing.assert_array_equal(np.asarray(tj)[:-1], _u32(tt)[:-1])
    np.testing.assert_array_equal(jvis.host_occupied(np.asarray(tj)),
                                  tvis.host_occupied(tt))
    for k in (keys[0], np.full(4, 0xFFFFFFFF, np.uint32)):
        np.testing.assert_array_equal(jvis.host_sanitize_key(k),
                                      tvis.host_sanitize_key(k))
        assert jvis.host_home_slot(k, 1 << 8) == tvis.host_home_slot(
            k, 1 << 8)


def test_sanitize_keys_matches_jax():
    keys, valid = _key_batch(seed=6)
    ref = np.asarray(jvis.sanitize_keys(jnp.asarray(keys),
                                        jnp.asarray(valid)))
    port = tvis.sanitize_keys(interop.keys_from_numpy(keys, "cpu"),
                              torch.from_numpy(valid))
    np.testing.assert_array_equal(ref, _u32(port))


def test_check_cap_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        tvis.empty_table(24, "cpu")
    with pytest.raises(ValueError):
        tvis.empty_table(4, "cpu")
