"""State carried across from the JAX package, as numpy arrays.

The port's counterpart of loading weights: a visited table, a key batch,
a search state or a frontier-packing descriptor that the JAX package
produced (for example a ``SearchOutcome.goal_state``, a table from
``visited.build_table``, or a ``LanePacking`` whose packed rows a JAX
frontier holds) comes in here, so a search can continue in the port from
where the reference left off and both compute the same thing.  Only numpy crosses
the boundary; uint32 arrays become int32 tensors with the same bits, on
the card unless the caller names another device.
"""

from __future__ import annotations

import numpy as np
import torch

from dslabs_tpu_torch.tpu._build import resolve_device

__all__ = ["table_from_numpy", "table_to_numpy", "keys_from_numpy",
           "state_from_numpy", "packing_from_numpy"]

_STATE_KEYS = ("nodes", "net", "timers", "exc")


def _u32_bits(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    if a.dtype == np.int32:
        return a
    raise TypeError(f"expected uint32 or int32, got {a.dtype}")


def table_from_numpy(table, device=None) -> torch.Tensor:
    """[V+1, 4] uint32 visited table -> int32 tensor with the same bits."""
    t = _u32_bits(table)
    if t.ndim != 2 or t.shape[1] != 4:
        raise ValueError(f"visited table must be [V+1, 4], got {t.shape}")
    return torch.from_numpy(t.copy()).to(resolve_device(device))


def table_to_numpy(table: torch.Tensor) -> np.ndarray:
    """int32 table tensor -> [V+1, 4] uint32 array (same bits)."""
    return table.detach().cpu().numpy().view(np.uint32)


def keys_from_numpy(keys, device=None) -> torch.Tensor:
    """[N, 4] uint32 keys -> int32 tensor with the same bits."""
    k = _u32_bits(keys).reshape(-1, 4)
    return torch.from_numpy(k.copy()).to(resolve_device(device))


def state_from_numpy(state: dict, device=None) -> dict:
    """A batch-1 state dict of numpy arrays (``nodes`` [1, NW], ``net``
    [1, CAP, MW], ``timers`` [1, NN, T, TW], ``exc`` [1]) -> the port's
    state dict of int32 tensors on ``device``."""
    missing = [k for k in _STATE_KEYS if k not in state]
    if missing:
        raise KeyError(f"state is missing {missing}")
    device = resolve_device(device)
    out = {}
    for k in _STATE_KEYS:
        a = np.asarray(state[k])
        if a.shape[0] != 1:
            raise ValueError(f"{k}: a batch-1 state is expected, got "
                             f"shape {a.shape}")
        out[k] = torch.from_numpy(a.astype(np.int32)).to(device)
    return out


_PACKING_ARRAYS = ("word", "shift", "width", "lo", "raw", "sent", "dlt")


def packing_from_numpy(desc):
    """A JAX ``LanePacking`` (or anything with its ``lanes``, ``words``
    and numpy arrays ``word``, ``shift``, ``width``, ``lo``, ``raw``,
    ``sent``, ``dlt``) -> the port's :class:`~dslabs_tpu_torch.tpu.
    packing.LanePacking`, so rows packed by the JAX package unpack
    bit-identically on the port.  Only numpy crosses."""
    from dslabs_tpu_torch.tpu.packing import LanePacking

    arrays = {}
    for name in _PACKING_ARRAYS:
        a = np.asarray(getattr(desc, name))
        if a.shape != (int(desc.lanes),):
            raise ValueError(f"packing array {name!r} has shape {a.shape},"
                             f" expected ({int(desc.lanes)},)")
        arrays[name] = a.astype(bool if name in ("raw", "sent", "dlt")
                                else np.int64)
    return LanePacking(lanes=int(desc.lanes), words=int(desc.words),
                       **arrays)
