"""Unified, engine-agnostic search checkpoints (atomic ``.npz`` dumps).

The port's own copy of ``dslabs_tpu/tpu/checkpoint.py``, byte for byte in
format: a dump written by either package resumes in the other.  Both
loops of :class:`~dslabs_tpu_torch.tpu.engine.TensorSearch` (the device
wave loop, its spill mode, and ``run_host``) and the swarm read and write
the same file.  A dump stores the search's semantic state, never an
engine's carry layout:

  frontier      [n, lanes or plane] int32  live frontier rows (occupied
                                           only; packed rows carry an
                                           ``extra__frontier_encoding``
                                           marker)
  visited_keys  [K, 4]     uint32  occupied visited-table lines (the
                                   128-bit keys; a table is rebuilt on
                                   load by re-insertion)
  depth / explored / elapsed / vis_over / dropped   scalars
  fp_map        [M, 9]     int64   optional trace chain
  extra__<name> arrays             engine-extension arrays
                                   (``SearchCheckpoint.extra``): the
                                   swarm's walker state, the spill tier's
                                   ``spill_stats``; covered by the
                                   checksum, ignored by loaders that do
                                   not know them.

A spill-mode dump stays tier-agnostic: ``visited_keys`` is the exact
union of the device table and the host tier and ``frontier`` holds every
spooled segment, so a non-spill engine resumes a spill dump (if its table
fits the key set) and a spill engine resumes any dump.

Every dump carries a config fingerprint (:func:`config_fingerprint`):
the protocol's lane shape plus the strict and record_trace flags, the
symmetry pass's permutation count and the fault model's signature.
Throughput knobs (chunk, capacities, ev budgets) are excluded, so a dump
resumes under other capacities unchanged.  A mismatch raises
:class:`CheckpointMismatch` naming both fingerprints.

Writes are atomic: the dump goes to ``<path>.tmp``, the previous dump is
rotated to ``<path>.prev``, then the tmp file is ``os.replace``d into
place; every dump carries a CRC32 content checksum.  The loader falls
back to ``.prev`` with a warning on a torn or corrupt main dump and raises
:class:`CheckpointCorrupt` when no candidate verifies.
:class:`AsyncCheckpointWriter` is the skip-if-busy background writer.

Deliberate differences from the reference: the per-level archive copy
(``DSLABS_MEMO_LEVELS``) belongs to the memo service and is not ported,
nor are the run-directory path helpers.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import warnings
import zlib
from typing import Optional

import numpy as np

__all__ = ["FORMAT_VERSION", "CheckpointMismatch", "CheckpointCorrupt",
           "SearchCheckpoint", "config_fingerprint", "save", "load",
           "peek_fingerprint", "peek_depth", "AsyncCheckpointWriter"]

# Shared with the reference: a dump of either package names this format.
FORMAT_VERSION = "dslabs-search-ckpt-v7"


class CheckpointMismatch(RuntimeError):
    """A checkpoint's config fingerprint does not match the live search;
    the message names both fingerprints."""


class CheckpointCorrupt(RuntimeError):
    """Every candidate dump (main and the rotated ``.prev``) failed its
    checksum or read: there is nothing sound to resume."""


@dataclasses.dataclass
class SearchCheckpoint:
    """The engine-agnostic snapshot of a search at a level boundary."""

    fingerprint: str
    depth: int
    explored: int
    elapsed: float
    frontier: np.ndarray        # [n, lanes] int32, live rows only
    visited_keys: np.ndarray    # [K, 4] uint32, occupied lines only
    vis_over: int = 0
    dropped: int = 0
    fp_map: Optional[np.ndarray] = None   # [M, 9] int64 trace chain
    extra: Optional[dict] = None          # saved as extra__<name>


def config_fingerprint(protocol, strict: bool,
                       record_trace: bool = False,
                       symmetry: int = 0) -> str:
    """The identity a dump must share with the search resuming it: the
    protocol's lane layout and the verdict-affecting flags, the same
    string the reference computes.  ``symmetry`` (the canonicalize
    pass's permutation count, 0 = off) takes part, since a reduced dump
    counts orbits; so does the fault model's signature.  The frontier's
    packed encoding does not: it is converted on resume."""
    base = (FORMAT_VERSION, protocol.name, protocol.n_nodes,
            protocol.node_width, protocol.msg_width,
            protocol.timer_width, protocol.net_cap,
            protocol.timer_cap, bool(strict), bool(record_trace))
    if symmetry:
        base = base + (f"sym{symmetry}",)
    fl = getattr(protocol, "fault", None)
    if fl is not None:
        base = base + (fl.signature(),)
    return repr(base)


def _content_checksum(host: dict) -> np.uint32:
    """CRC32 over every entry's name, dtype/shape and bytes (sorted key
    order, the ``checksum`` entry excluded)."""
    crc = 0
    for key in sorted(host):
        if key == "checksum":
            continue
        arr = np.asarray(host[key])
        crc = zlib.crc32(key.encode(), crc)
        crc = zlib.crc32(repr((arr.dtype.str, arr.shape)).encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(arr).tobytes(), crc)
    return np.uint32(crc & 0xFFFFFFFF)


def save(path: str, ckpt: SearchCheckpoint) -> None:
    """Atomic checksummed dump with one-deep rotation: write
    ``path + '.tmp'``, rotate an existing dump to ``path + '.prev'``,
    then replace.  A kill at any point leaves a complete dump."""
    host = {
        "config": np.bytes_(ckpt.fingerprint.encode()),
        "depth": np.int64(ckpt.depth),
        "explored": np.int64(ckpt.explored),
        "elapsed": np.float64(ckpt.elapsed),
        "vis_over": np.int64(ckpt.vis_over),
        "dropped": np.int64(ckpt.dropped),
        "frontier": np.asarray(ckpt.frontier, np.int32),
        "visited_keys": np.asarray(ckpt.visited_keys, np.uint32),
    }
    if ckpt.fp_map is not None and len(ckpt.fp_map):
        host["fp_map"] = np.asarray(ckpt.fp_map, np.int64)
    for name, arr in (ckpt.extra or {}).items():
        host[f"extra__{name}"] = np.asarray(arr)
    host["checksum"] = _content_checksum(host)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **host)
    if os.path.exists(path):
        os.replace(path, path + ".prev")
    os.replace(tmp, path)


def _candidates(path: str):
    """Load order: the main dump, then the rotated previous dump."""
    return (path, path + ".prev")


def _peek(path: str, key: str):
    for cand in _candidates(path):
        if not os.path.exists(cand):
            continue
        try:
            with np.load(cand) as z:
                if key in z.files:
                    return z[key]
        except Exception:
            continue
    return None


def peek_fingerprint(path: str) -> Optional[str]:
    """The dump's fingerprint without loading its arrays, or None when no
    readable dump exists (an unreadable main dump falls through to
    ``.prev``, as the loader would)."""
    if not path:
        return None
    v = _peek(path, "config")
    return None if v is None else v.item().decode()


def peek_depth(path: str) -> Optional[int]:
    """The dump's depth without loading its arrays, or None."""
    if not path:
        return None
    v = _peek(path, "depth")
    return None if v is None else int(v)


def _load_verified(path: str) -> dict:
    """Every entry of a dump, checksum verified; raises
    :class:`CheckpointCorrupt` on truncation, a missing checksum or a
    mismatch."""
    try:
        with np.load(path) as z:
            data = {k: z[k] for k in z.files}
    except Exception as e:
        raise CheckpointCorrupt(
            f"{path}: unreadable/truncated checkpoint "
            f"({type(e).__name__}: {e})") from e
    if "config" not in data:
        raise CheckpointCorrupt(
            f"{path}: not a search checkpoint (no config fingerprint)")
    if "checksum" not in data:
        raise CheckpointCorrupt(
            f"{path}: no content checksum (pre-{FORMAT_VERSION} or "
            "torn dump)")
    want = int(np.uint32(data["checksum"]))
    got = int(_content_checksum(data))
    if want != got:
        raise CheckpointCorrupt(
            f"{path}: content checksum mismatch (stored {want:#010x}, "
            f"computed {got:#010x}): torn or corrupted dump")
    return data


def load(path: str, fingerprint: str) -> Optional[SearchCheckpoint]:
    """Load and verify a dump: None when no file exists,
    :class:`CheckpointMismatch` when it belongs to another configuration.
    A corrupt main dump falls back to ``.prev`` with a warning; when
    every candidate is corrupt, :class:`CheckpointCorrupt`."""
    if not path:
        return None
    errors = []
    seen_any = False
    for cand in _candidates(path):
        if not os.path.exists(cand):
            continue
        seen_any = True
        try:
            data = _load_verified(cand)
        except CheckpointCorrupt as e:
            warnings.warn(
                f"checkpoint {cand} failed verification ({e}); "
                "falling back to the rotated previous dump",
                RuntimeWarning, stacklevel=2)
            errors.append(e)
            continue
        found = data["config"].item().decode()
        if found != fingerprint:
            raise CheckpointMismatch(
                f"refusing to resume {cand}: checkpoint fingerprint\n"
                f"  {found}\ndoes not match the live search's\n"
                f"  {fingerprint}\n(dump from a different protocol/"
                "capacity config: delete the file or fix the config)")
        return SearchCheckpoint(
            fingerprint=found,
            depth=int(data["depth"]),
            explored=int(data["explored"]),
            elapsed=float(data["elapsed"]),
            frontier=np.asarray(data["frontier"], np.int32),
            visited_keys=np.asarray(data["visited_keys"], np.uint32),
            vis_over=int(data["vis_over"]) if "vis_over" in data else 0,
            dropped=int(data["dropped"]) if "dropped" in data else 0,
            fp_map=(np.asarray(data["fp_map"], np.int64)
                    if "fp_map" in data else None),
            extra=({k[len("extra__"):]: np.asarray(v)
                    for k, v in data.items()
                    if k.startswith("extra__")} or None))
    if not seen_any:
        return None
    raise CheckpointCorrupt(
        f"no readable checkpoint at {path} (main and .prev both failed "
        "verification): " + "; ".join(str(e) for e in errors))


class AsyncCheckpointWriter:
    """Skip-if-busy background dump writer (one thread, never a queue):
    ``kick(fn)`` runs ``fn`` on a daemon thread unless a previous dump is
    still being written, in which case the dump is skipped.  ``join()``
    waits for the one in flight; callers join before they return an
    outcome."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None

    def busy(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def kick(self, fn) -> bool:
        if self.busy():
            return False
        th = threading.Thread(target=fn, daemon=True)
        self._thread = th
        th.start()
        return True

    def join(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
