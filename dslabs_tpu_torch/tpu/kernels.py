"""Kernel 1, the 128-bit row fingerprint: its plain PyTorch version and
its wrapper.

The counterpart of ``dslabs_tpu/tpu/kernels.py:fingerprint_rows`` and of
the reference engine's ``_mix32`` / ``_fingerprint32`` /
``row_fingerprints``.  One entry point serves both uses the reference
splits between the fused jnp ``row_fingerprints`` (the expand site) and
the Pallas kernel (the root key): on a CUDA tensor it launches
``csrc/fingerprint.cu``; on a CPU tensor it runs :func:`row_fingerprints`.

Keys are stored as int32 with the uint32 bits.  The plain arithmetic runs
in int64 masked with ``0xFFFFFFFF``: torch's CPU build has no shifts or
sums on ``torch.uint32``, and an int32 ``>>`` is arithmetic.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dslabs_tpu_torch.tpu import _build

__all__ = ["fingerprint_rows", "row_fingerprints", "LAUNCHES"]

M32 = 0xFFFFFFFF

# Launches of kernel 1 (one per call on a CUDA tensor).
LAUNCHES = {"fingerprint_rows": 0}


# ----------------------------------------------------------- plain version

def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 holding the unsigned value."""
    return x.to(torch.int64) & M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a value in [0, 2^32) -> int32 with the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) without int64 overflow."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & M32


def _mix32(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Add-shift-xor mixer over uint32 values held in int64 (the
    reference's ``_mix32``); ``x`` and ``seed`` are in [0, 2^32)."""
    x = x ^ _mul32(seed, 0x9E3779B9)
    x = (x + (x << 10)) & M32
    x = x ^ (x >> 6)
    x = (x + (x << 3)) & M32
    x = x ^ (x >> 11)
    x = (x + (x << 15)) & M32
    x = x ^ (x >> 7)
    return x


def _fingerprint32(flat: torch.Tensor, seed: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """64-bit fingerprint of [N, L] int32 rows as a (hi, lo) pair of int64
    tensors holding uint32 values: each lane is mixed with its position and
    a seed, the lanes are summed with uint32 wrap, mixed and summed
    again."""
    _, l = flat.shape
    pos = (torch.arange(l, dtype=torch.int64, device=flat.device)[None, :]
           + seed * 0x1000193) & M32
    h = _mix32(_u32(flat), pos)
    lo = h.sum(dim=1) & M32
    hi = _mix32(h, (pos + 0x27D4EB2F) & M32).sum(dim=1) & M32
    return hi, lo


@_build.plain_version
def row_fingerprints(flat: torch.Tensor) -> torch.Tensor:
    """[N, L] int32 rows -> [N, 4] int32 holding the uint32 keys (a_hi,
    a_lo, b_hi, b_lo): two independent 64-bit fingerprints, one 128-bit
    equivalence key.  The plain version of kernel 1; rows are hashed in
    blocks to bound the int64 temporaries."""
    out = torch.empty((flat.shape[0], 4), dtype=torch.int32,
                      device=flat.device)
    step = 1 << 15
    for s in range(0, flat.shape[0], step):
        blk = flat[s:s + step]
        a_hi, a_lo = _fingerprint32(blk, 1)
        b_hi, b_lo = _fingerprint32(blk, 2)
        out[s:s + step] = _i32(torch.stack([a_hi, a_lo, b_hi, b_lo], dim=1))
    return out


# ------------------------------------------------------------- the kernel

def fingerprint_rows(flat: torch.Tensor) -> torch.Tensor:
    """[B, L] int32 rows -> [B, 4] int32 holding the uint32 fingerprints
    (a_hi, a_lo, b_hi, b_lo), bit-identical to the reference."""
    if flat.device.type == "cpu":
        return row_fingerprints(flat)
    if flat.device.type != "cuda":
        raise ValueError(f"fingerprint_rows: unsupported device {flat.device}")
    if flat.dtype != torch.int32 or flat.dim() != 2:
        raise ValueError("fingerprint_rows: [B, L] int32 expected, got "
                         f"{tuple(flat.shape)} {flat.dtype}")
    flat = flat.contiguous()
    b, l = flat.shape
    out = torch.empty((b, 4), dtype=torch.int32, device=flat.device)
    if b == 0:
        return out
    rc = _build.lib().dsl_fingerprint_rows(
        flat.data_ptr(), out.data_ptr(), b, l,
        torch.cuda.current_stream(flat.device).cuda_stream)
    _build.check(rc, "fingerprint_rows")
    LAUNCHES["fingerprint_rows"] += 1
    return out
