"""Device-resident visited set: an open-addressing hash table of 128-bit
keys, the counterpart of ``dslabs_tpu/tpu/visited.py``.

Layout: ``[V + 1, 4]`` int32 holding uint32 bits, V (a power of two) the
slot count, viewed as ``[V/8, 8]``-slot buckets so that one probe reads
one aligned 128-byte line.  EMPTY slots are all-MAX (``-1`` in the int32
view); a real all-MAX key is remapped by :func:`sanitize_keys`.  The
trailing row is a dump that is never written.

:func:`insert` is the entry point.  On a CUDA tensor it launches kernel 2
(``csrc/visited.cu``) and updates the table in place; on a CPU tensor it
runs :func:`insert_plain`, the plain PyTorch version with the reference's
probe order, reservation tie-breaks and two phases, so tables, insert
flags and unresolved flags agree bit for bit.

Kernel 2 is one persistent cooperative launch per call: a grid of as many
blocks as the card holds at once runs every probe round, with grid-wide
barriers between a round's reserve (read the table, take an ``atomicMin``
reservation) and its claim (winners write).  The rounds end on the
device's own per-round counters, round 0 walks the batch and each later
round only the worklist of keys the previous one left, and eight lanes
share a key so that a warp reads four whole 128-byte bucket lines per
load.  It is bound by bytes on the card; random bucket lines, scattered
winner writes and two grid barriers per round keep it from that bound
(``PERF.md``).  The wrapper allocates its outputs and one scratch buffer
with ``torch.empty`` only, so one call is one device launch.

Overflow contract: a key whose probe exhausts is *unresolved*: not
inserted, and the caller must treat it as fresh while surfacing the count
(strict searches raise :class:`~dslabs_tpu_torch.tpu.engine.CapacityOverflow`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dslabs_tpu_torch.tpu import _build

__all__ = ["BKT", "MAXU32", "MAX_ITERS", "LAUNCHES", "check_cap",
           "empty_table", "sanitize_keys", "host_sanitize_key", "host_home_slot",
           "host_occupied", "build_table", "insert", "insert_plain"]

# Slots per bucket: one probe reads one 128-byte line of 8 x 16-byte keys.
BKT = 8
MAXU32 = np.uint32(0xFFFFFFFF)
EMPTY = -1                 # MAXU32 in the int32 view
# Probe rounds of each phase (the reference's ``max_iters`` default).
MAX_ITERS = 64
# Launches of kernel 2 (one per insert call on CUDA tensors).
LAUNCHES = {"insert": 0}


def check_cap(cap: int) -> None:
    if cap & (cap - 1) or cap < BKT:
        raise ValueError(
            f"visited cap must be a power of two >= {BKT} "
            f"(hash-table slot arithmetic), got {cap}")


def empty_table(cap: int, device=None) -> torch.Tensor:
    """A fresh ``[cap + 1, 4]`` all-EMPTY table (+1 dump row), on the card
    unless ``device`` names another."""
    check_cap(cap)
    return torch.full((cap + 1, 4), EMPTY, dtype=torch.int32,
                      device=_build.resolve_device(device))


def sanitize_keys(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Remap the all-MAX key (it would alias EMPTY) on valid rows: lane 3
    becomes MAX - 1 (``-2`` in the int32 view)."""
    all_max = torch.all(keys == EMPTY, dim=1)
    out = keys.clone()
    out[:, 3] = torch.where(all_max & valid, -2, keys[:, 3])
    return out


def host_sanitize_key(key: np.ndarray) -> np.ndarray:
    """Host-side :func:`sanitize_keys` for one [4] uint32 key."""
    key = np.asarray(key).view(np.uint32).copy()
    if (key == MAXU32).all():
        key[3] = np.uint32(MAXU32 - 1)
    return key


def host_home_slot(key: np.ndarray, cap: int) -> int:
    """First slot of a [4] key's home bucket (bucket keyed by lane 2)."""
    check_cap(cap)
    return (int(np.asarray(key).view(np.uint32)[2]) & (cap // BKT - 1)) * BKT


def host_occupied(table) -> np.ndarray:
    """Occupied key lines of a host copy of a ``[V + 1, 4]`` table (dump
    row excluded), as uint32."""
    if isinstance(table, torch.Tensor):
        table = table.cpu().numpy()
    table = np.asarray(table).view(np.uint32)[:-1]
    return table[~(table == MAXU32).all(axis=1)]


def build_table(cap: int, keys: torch.Tensor, device=None
                ) -> Tuple[torch.Tensor, int, int]:
    """A fresh table with ``keys`` ([K, 4] int32 bits) inserted, on the
    card unless ``device`` names another.  Returns ``(table, n_inserted,
    n_unresolved)``; callers treat a nonzero unresolved count as
    CapacityOverflow."""
    device = _build.resolve_device(device)
    keys = keys.to(device=device, dtype=torch.int32).reshape(-1, 4)
    table, ins, unres = insert(
        empty_table(cap, device), keys,
        torch.ones((keys.shape[0],), dtype=torch.bool, device=device))
    return table, int(ins.sum()), int(unres.sum())


def _sizes(n: int) -> Tuple[int, int]:
    """Reservation-table size RT and tail size T for a batch of n keys."""
    rt = 1 << max((n * 2 - 1).bit_length(), 10)
    t = max(n // 8, min(256, n))
    return rt, t


# ------------------------------------------------------------ plain version

def _probe_iter(table, keys, bkt_i, ps, unres, idx, V, RT, batch_n):
    """One probe round: every unresolved key reads its whole bucket (the
    table as it stood at the start of the round), the minimum-index
    contender of each reservation cell claims the first empty slot,
    losers stay, keys of a full bucket step on.  Writes winners into
    ``table`` in place; returns (bkt_i', newly resolved, winners)."""
    VB = V // BKT
    bkt = table[:V].view(VB, BKT, 4)[bkt_i]                  # [n, 8, 4]
    eq = torch.any(torch.all(bkt == keys[:, None, :], dim=2), dim=1)
    empty = torch.all(bkt == EMPTY, dim=2)
    has_empty = torch.any(empty, dim=1)
    first_empty = torch.argmax(empty.to(torch.int32), dim=1)  # first max
    want = unres & ~eq & has_empty
    rcell = bkt_i & (RT - 1)
    res = torch.full((RT + 1,), batch_n, dtype=torch.int64,
                     device=table.device)
    res.scatter_reduce_(0, torch.where(want, rcell, RT), idx, reduce="amin")
    winner = want & (res[rcell] == idx)
    dst = bkt_i * BKT + first_empty
    table[dst[winner]] = keys[winner]
    newly = eq | winner
    nb = (bkt_i + ps) & (VB - 1)
    bkt_i = torch.where(unres & ~newly & ~has_empty, nb, bkt_i)
    return bkt_i, newly & unres, winner & unres


def insert_plain(table: torch.Tensor, keys: torch.Tensor,
                 valid: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Membership + insert of a key batch, the plain PyTorch version of
    kernel 2 (the reference's ``insert_jnp``).  ``table`` [V+1, 4] int32
    is updated in place; ``keys`` [N, 4] int32 bits (sanitised here);
    ``valid`` [N] bool.  Returns ``(table, inserted, unresolved)``:
    exactly one copy of each new distinct key is inserted (the lowest
    index), invalid rows are never inserted nor unresolved."""
    V = table.shape[0] - 1
    check_cap(V)
    VB = V // BKT
    n = keys.shape[0]
    dev = table.device
    if n == 0:
        z = torch.zeros((0,), dtype=torch.bool, device=dev)
        return table, z, z.clone()
    skeys = sanitize_keys(keys, valid)
    slot0 = skeys[:, 2].to(torch.int64) & (VB - 1)
    pstep = (skeys[:, 1] | 1).to(torch.int64)
    RT, T = _sizes(n)
    ridx = torch.arange(n, dtype=torch.int64, device=dev)

    # ---- full phase: one guaranteed round, then while more than T left.
    bkt_i, resolved = slot0, ~valid
    inserted = torch.zeros(n, dtype=torch.bool, device=dev)
    it = 0
    while True:
        left = int((~resolved).sum())
        if not ((it < 1 or left > T) and it < MAX_ITERS and left > 0):
            break
        bkt_i, newly, winner = _probe_iter(table, skeys, bkt_i, pstep,
                                           ~resolved, ridx, V, RT, n)
        resolved = resolved | newly
        inserted = inserted | winner
        it += 1

    # ---- tail phase: the lowest-index T unresolved keys, compacted.
    tail = torch.nonzero(~resolved).flatten()[:T]
    t_keys, t_bkt, t_ps = skeys[tail], bkt_i[tail], pstep[tail]
    t_id = torch.arange(tail.shape[0], dtype=torch.int64, device=dev)
    t_unres = torch.ones(tail.shape[0], dtype=torch.bool, device=dev)
    t_ins = torch.zeros(tail.shape[0], dtype=torch.bool, device=dev)
    it = 0
    while it < MAX_ITERS and bool(t_unres.any()):
        t_bkt, newly, winner = _probe_iter(table, t_keys, t_bkt, t_ps,
                                           t_unres, t_id, V, RT, n)
        t_unres = t_unres & ~newly
        t_ins = t_ins | winner
        it += 1
    resolved[tail] = resolved[tail] | ~t_unres
    inserted[tail] = inserted[tail] | t_ins
    return table, inserted, ~resolved


# ------------------------------------------------------------- the kernel

def insert(table: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The probe/insert entry point.  CPU tensors run
    :func:`insert_plain`; CUDA tensors launch kernel 2, which updates
    ``table`` in place on the current stream with no host synchronisation,
    or raise.  Same contract and results either way."""
    if table.device.type == "cpu":
        return insert_plain(table, keys, valid)
    if table.device.type != "cuda":
        raise ValueError(f"visited.insert: unsupported device {table.device}")
    V = table.shape[0] - 1
    check_cap(V)
    n = keys.shape[0]
    if (table.dtype != torch.int32 or keys.dtype != torch.int32
            or valid.dtype != torch.bool or table.shape[1] != 4
            or keys.shape[1:] != (4,) or valid.shape != (n,)):
        raise ValueError("visited.insert: table [V+1, 4] int32, keys "
                         "[N, 4] int32, valid [N] bool expected")
    if keys.device != table.device or valid.device != table.device:
        raise ValueError("visited.insert: tensors on different devices")
    if not table.is_contiguous():
        raise ValueError("visited.insert: table must be contiguous")
    keys = keys.contiguous()
    valid = valid.contiguous()
    dev = table.device
    flags = torch.empty((2, n), dtype=torch.bool, device=dev)
    inserted, unresolved = flags[0], flags[1]
    if n == 0:
        return table, inserted, unresolved
    RT, T = _sizes(n)
    # Scratch, one allocation that the kernel initialises itself (no fill
    # launches), in int32 words: reservation cells [RT] int64, probe
    # words [n, 2], two round lists [2, n, 2], buckets by index [n],
    # round counters [2 * MAX_ITERS].
    scratch = torch.empty((2 * RT + 7 * n + 2 * MAX_ITERS,),
                          dtype=torch.int32, device=dev)
    res = scratch.data_ptr()
    probe = res + 8 * RT
    lists = probe + 8 * n
    bkt = lists + 16 * n
    ctl = bkt + 4 * n
    rc = _build.lib().dsl_visited_insert_coop(
        table.data_ptr(), keys.data_ptr(), valid.data_ptr(),
        flags.data_ptr(), flags.data_ptr() + n, bkt, probe, lists, res, ctl,
        n, V, RT, T, MAX_ITERS, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "visited.insert")
    LAUNCHES["insert"] += 1
    return table, inserted, unresolved
