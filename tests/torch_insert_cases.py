"""Crowded key batches for the visited-table insert, built with numpy
from a seed and shared by the card tests (``tests/test_torch_cuda.py``)
and ``chip_smoke.py``.  Each function returns ``(table, keys, valid)``: a
``[cap + 1, 4]`` uint32 table (trailing dump row EMPTY), ``[n, 4]``
uint32 keys and ``[n]`` bool valid flags.  Both make more than T keys
outlive the 64 full rounds, so the tail's cut to the lowest-index T
decides which keys win."""

import numpy as np

BKT = 8
MAXU32 = np.uint32(0xFFFFFFFF)


def _stored_at_home(rng, cap):
    """A random table whose key in each slot has that slot's bucket as
    its home (lane 2's low bits)."""
    vb = cap // BKT
    table = rng.integers(0, 2 ** 32, size=(cap + 1, 4), dtype=np.uint32)
    table[:cap, 2] = ((table[:cap, 2] & ~np.uint32(vb - 1))
                      | (np.arange(cap) // BKT).astype(np.uint32))
    table[cap] = MAXU32                          # dump row
    return table


def many_rounds_case(seed=8):
    """A 2^10-slot table full except one bucket X, and 2048 keys that all
    step by one bucket a round from homes 1..20 buckets past X: they
    first reach X in tail rounds 44..63, so more than T = 256 keys stay
    unresolved through all 64 full rounds, and which keys the tail takes
    (the lowest-index T) decides which win X's 8 slots.  Adds invalid
    rows, keys already in the table, in-batch duplicates and the all-MAX
    key.  (The ``many-rounds`` case of ``tests/test_torch_kernels.py``,
    there held against the JAX reference.)"""
    rng = np.random.default_rng(seed)
    cap, X, n = 1 << 10, 5, 2048
    vb = cap // BKT
    table = _stored_at_home(rng, cap)
    table[X * BKT:(X + 1) * BKT] = MAXU32
    keys = rng.integers(0, 2 ** 32, size=(n, 4), dtype=np.uint32)
    keys[:, 1] &= 1                              # probe step 1
    near = (X + 1 + rng.integers(0, 20, size=n)) % vb
    keys[:, 2] = (keys[:, 2] & ~np.uint32(vb - 1)) | near.astype(np.uint32)
    keys[200:210] = table[300:310]               # already present
    keys[100:120] = keys[1000:1020]              # in-batch duplicates
    keys[7] = MAXU32
    valid = rng.random(n) > 0.2
    valid[7] = True
    return table, keys, valid


def crowded_case(seed=9, cap=1 << 16, n=1 << 15, period=256):
    """A table about 85% full and keys with clustered homes, at a size
    where the tail selection ranks keys across many blocks.  Buckets
    repeat a pattern of ``period``: the first half full, then one empty
    bucket X, then buckets with 30% of their slots empty.  Every key
    steps by one bucket a round from a home 65..127 buckets before its
    period's X, through full buckets only, so none resolves in the 64
    full rounds except keys already present and in-batch duplicates;
    about 0.8 n stay, far more than T = n / 8.  The lowest-index T reach
    X in tail rounds 1..63: the first eight take its slots, later ones
    step on into the partly empty buckets."""
    rng = np.random.default_rng(seed)
    vb = cap // BKT
    half = period // 2
    table = _stored_at_home(rng, cap)
    pos = (np.arange(cap) // BKT) % period
    empty = (pos == half) | ((pos > half) & (rng.random(cap) < 0.3))
    table[:cap][empty] = MAXU32
    keys = rng.integers(0, 2 ** 32, size=(n, 4), dtype=np.uint32)
    keys[:, 1] &= 1                              # probe step 1
    home = (rng.integers(0, vb // period, size=n) * period + half
            - rng.integers(65, half, size=n))
    keys[:, 2] = (keys[:, 2] & ~np.uint32(vb - 1)) | home.astype(np.uint32)
    keys[200:210] = table[80:90]                 # already present
    keys[100:120] = keys[1000:1020]              # in-batch duplicates
    keys[7] = MAXU32
    valid = rng.random(n) > 0.2
    valid[7] = True
    return table, keys, valid
