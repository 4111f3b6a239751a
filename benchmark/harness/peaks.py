"""The card's peaks and the least work of the port's two kernels.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; the rates assume its
700 W power limit, and the harness prints the card's own limit beside
every share): HBM3 at 3.35 TB/s.  The int32 rate is derived, not read
off the sheet: SMs x 64 int32 add / bitwise / shift lanes per clock (the
CUDA programming guide's throughput for compute capability 9.0) x the
1.98 GHz boost clock behind the sheet's 67 TFLOP/s float32 figure
(132 x 128 x 2 x 1.98 GHz).  The SM count is read from the card.

Kernel 1 (the 128-bit fingerprint of a state row) needs, for each lane
of each row it hashes, 28 int32 operations that only the ALU pipe takes
(4 mixes of 1 xor with the position product, 3 shifts and 3 xors), the
row's bytes read once and its 16-byte key written once.  The work is
that of the rows the search needs hashed: every valid successor and the
root's key twice.

Kernel 2 (the visited-table insert) needs, for each key it dedups, the
key read once (16 B), its home bucket line read once (128 B) and one
result byte written, and for each key it inserts 16 B written.  The keys
are every valid successor and the root; the inserted ones are the unique
states.
"""

from __future__ import annotations

from typing import Optional

HBM_BYTES_PER_S = 3.35e12
BOOST_HZ = 1.98e9
INT32_LANES_PER_SM = 64
FP_OPS_PER_LANE = 28
KEY_BYTES = 16
LINE_BYTES = 128


def int32_ops_per_s(sm_count: int) -> float:
    return sm_count * INT32_LANES_PER_SM * BOOST_HZ


def least_seconds(n_ops: float, n_bytes: float, sm_count: int) -> float:
    """The least time the card could take: the larger of the operations
    over the int32 rate and the bytes over HBM's."""
    return max(n_ops / int32_ops_per_s(sm_count),
               n_bytes / HBM_BYTES_PER_S)


def fingerprint_least_s(rows: int, lanes: int, sm_count: int) -> float:
    return least_seconds(rows * lanes * FP_OPS_PER_LANE,
                         rows * (lanes * 4 + KEY_BYTES), sm_count)


def visited_least_s(keys: int, inserted: int) -> float:
    return (keys * (KEY_BYTES + LINE_BYTES + 1)
            + inserted * KEY_BYTES) / HBM_BYTES_PER_S


def roofline_pct(least_s: float, device_s: float) -> Optional[float]:
    """A kernel's share of its roofline in percent; None where the trace
    holds no time for it (never 0)."""
    if not device_s or device_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / device_s
