"""Host-RAM spill tier: a full device table or frontier buffer becomes
"slower, still exact" instead of ``CapacityOverflow``.

The port's own copy of ``dslabs_tpu/tpu/spill.py``, host numpy only (no
tensor reaches this module).  Three pieces; the engine's spill-mode loop
(``TensorSearch._device_attempt_spill``) owns the device half:

* :class:`HostVisitedTier`: the cold half of the visited set, an exact
  sorted store of 128-bit keys as (h1, h2) uint64 pairs.  When the device
  table crosses its high-water mark, its occupied lines are evicted here
  in bulk and the table restarts empty; every batch of rows that leaves
  the device is refiltered against the tier, so a state discovered
  before an eviction is never expanded again after it.

* :class:`FrontierSpool`: frontier rows that would overflow the device
  buffer are drained here and injected again as further waves at the
  same BFS depth, so depth accounting (and a ``DEPTH_EXHAUSTED``
  verdict) stays exact.  Two spools (level being consumed, level being
  assembled) swap at each level boundary.

* :class:`SpillManager`: the bookkeeping that keeps strict counts exact.
  Within one eviction epoch the device table dedups perfectly; across
  epochs a re-discovered state is counted once more by the device
  (``dup_epoch``), and the refilter drops the row and subtracts it:

      unique = len(tier) + vis_n_device_epoch - dup_epoch

  Exactness rests on three invariants: every drained batch is
  refiltered against the tier before the next eviction adds its keys
  (the single ordered drain worker keeps that order); each drained batch
  spans one epoch, so it holds no duplicates; and an aborted chunk step
  is reverted wholesale on the device, table included, so its retry sees
  exactly the state it first saw.

Checkpoints stay tier-agnostic (``tpu/checkpoint.py``): ``visited_keys``
is the deduplicated union of the device table and the tier, the frontier
holds every spooled segment, and the counters ride ``extra__spill_stats``.

Telemetry (``tpu/telemetry.py``): with a recorder on
``SpillManager.telemetry`` (the engine sets it at run start), each
eviction, spooled batch and reinjected segment is an event
(``spill_evict``, ``spill_spool``, ``spill_reinject``), and
:meth:`SpillManager.level_walls` gives the per-level drain wall split
that spill-mode level records carry.  Evictions and spools run on the
drain worker's thread; the recorder's lock orders them.

Deliberate differences from the reference: every size and switch comes
from :class:`SpillConfig` arguments (the ``DSLABS_SPILL*``,
``DSLABS_VISITED_WARN`` and ``DSLABS_DROPPED_WARN`` environment knobs are
not ported).
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue as queue_mod
import threading
import time
import warnings
import zlib
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["SpillConfig", "SpillStats", "HostVisitedTier",
           "FrontierSpool", "SpillManager", "TIER_FORMAT", "TierMismatch",
           "TierCorrupt", "save_tier", "load_tier", "peek_tier_meta",
           "spill_manager_for_audit"]


@dataclasses.dataclass(frozen=True)
class SpillConfig:
    """Spill-tier settings.  ``high_water``: the device-table load factor
    at which a boundary evicts (an aborted chunk step catches whatever
    outruns it).  ``host_cap``: the most keys the host tier accepts;
    past it, ``CapacityOverflow``.  ``async_drain``: the host half of a
    drain (refilter, prune mask, spool, eviction absorb) runs on one
    ordered worker thread while the device goes on; off, it runs inline
    with the same results."""

    high_water: float = 0.60
    host_cap: int = 1 << 26
    async_drain: bool = True


@dataclasses.dataclass
class SpillStats:
    """The accounting a SearchOutcome carries.  ``drain_wall_ms`` is the
    host time inside drain jobs, ``drain_wait_ms`` the time the driver
    blocked waiting for them; their difference overlapped the device."""

    spilled_keys: int = 0        # keys evicted device -> host tier
    host_tier_hits: int = 0      # re-discoveries the refilter removed
    respilled_frontier: int = 0  # frontier rows through the host spool
    evictions: int = 0           # bulk table evictions
    reinjections: int = 0        # spooled segments injected again
    drain_wall_ms: int = 0       # host ms inside drain jobs
    drain_wait_ms: int = 0       # host ms blocked at drain barriers

    def as_array(self) -> np.ndarray:
        return np.asarray([self.spilled_keys, self.host_tier_hits,
                           self.respilled_frontier, self.evictions,
                           self.reinjections, self.drain_wall_ms,
                           self.drain_wait_ms], np.int64)

    @classmethod
    def from_array(cls, a) -> "SpillStats":
        a = np.asarray(a, np.int64).reshape(-1)
        vals = [int(x) for x in a[:7]]
        vals += [0] * (7 - len(vals))     # older dumps: 5 slots
        return cls(*vals)


def _rows_to_u64(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[K, 4] uint32 key rows (or their int32 bits) -> (h1, h2) uint64."""
    keys = np.asarray(keys).view(np.uint32).astype(np.uint64).reshape(-1, 4)
    h1 = (keys[:, 0] << np.uint64(32)) | keys[:, 1]
    h2 = (keys[:, 2] << np.uint64(32)) | keys[:, 3]
    return h1, h2


def _u64_to_rows(h1: np.ndarray, h2: np.ndarray) -> np.ndarray:
    rows = np.empty((len(h1), 4), np.uint32)
    rows[:, 0] = (h1 >> np.uint64(32)).astype(np.uint32)
    rows[:, 1] = (h1 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    rows[:, 2] = (h2 >> np.uint64(32)).astype(np.uint32)
    rows[:, 3] = (h2 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return rows


def _sorted_unique(h1: np.ndarray, h2: np.ndarray):
    order = np.lexsort((h2, h1))
    h1, h2 = h1[order], h2[order]
    first = np.ones(len(h1), bool)
    first[1:] = (h1[1:] != h1[:-1]) | (h2[1:] != h2[:-1])
    return h1[first], h2[first]


class HostVisitedTier:
    """Exact host fingerprint set: sorted (h1, h2) uint64 arrays, probed
    with the engine's collision-safe ``sorted_member`` scan."""

    def __init__(self, host_cap: int = 1 << 26):
        self.h1 = np.empty((0,), np.uint64)
        self.h2 = np.empty((0,), np.uint64)
        self.host_cap = host_cap

    def __len__(self) -> int:
        return len(self.h1)

    def absorb(self, keys: np.ndarray) -> int:
        """Merge [K, 4] key rows into the tier, deduplicated within the
        batch and against the store.  Returns the number of new keys;
        raises ``CapacityOverflow`` past ``host_cap`` (never a silent
        drop)."""
        if not len(keys):
            return 0
        h1, h2 = _sorted_unique(*_rows_to_u64(keys))
        fresh = ~self._contains_u64(h1, h2)
        n_new = int(fresh.sum())
        if n_new == 0:
            return 0
        if len(self) + n_new > self.host_cap:
            from dslabs_tpu_torch.tpu.engine import CapacityOverflow

            raise CapacityOverflow(
                f"host spill tier full: {len(self)} + {n_new} keys > "
                f"host_cap {self.host_cap} (raise SpillConfig.host_cap)")
        mh1 = np.concatenate([self.h1, h1[fresh]])
        mh2 = np.concatenate([self.h2, h2[fresh]])
        mo = np.lexsort((mh2, mh1))
        self.h1, self.h2 = mh1[mo], mh2[mo]
        return n_new

    def _contains_u64(self, h1, h2) -> np.ndarray:
        from dslabs_tpu_torch.tpu.engine import sorted_member

        if not len(self.h1) or not len(h1):
            return np.zeros(len(h1), bool)
        return sorted_member(self.h1, self.h2, h1, h2)

    def contains(self, keys: np.ndarray) -> np.ndarray:
        """[K, 4] key rows -> bool membership mask."""
        return self._contains_u64(*_rows_to_u64(keys))

    def key_rows(self) -> np.ndarray:
        """The whole tier as [K, 4] uint32 rows."""
        return _u64_to_rows(self.h1, self.h2)


# ------------------------------------------------- tier persistence
#
# The reference's versioned on-disk format for one exact tier: CRC32
# checksum, atomic tmp + replace with a ``.prev`` rotation, and a loud
# refusal of a foreign (other pack descriptor or symmetry flag) or torn
# file.

TIER_FORMAT = "dslabs-visited-tier-v1"


class TierMismatch(RuntimeError):
    """The tier on disk belongs to another configuration: its keys hash
    another encoding of state."""


class TierCorrupt(RuntimeError):
    """No candidate tier file passed the content checksum."""


def _tier_checksum(h1: np.ndarray, h2: np.ndarray,
                   meta_blob: bytes) -> np.uint32:
    crc = zlib.crc32(meta_blob)
    crc = zlib.crc32(np.ascontiguousarray(h1).tobytes(), crc)
    crc = zlib.crc32(np.ascontiguousarray(h2).tobytes(), crc)
    return np.uint32(crc & 0xFFFFFFFF)


def save_tier(path: str, h1: np.ndarray, h2: np.ndarray,
              meta: Optional[dict] = None) -> None:
    """Atomic checksummed tier dump with one-deep rotation; ``meta``
    pins the encoding identity that :func:`load_tier` checks."""
    full = {"fmt": TIER_FORMAT}
    full.update(meta or {})
    blob = json.dumps(full, sort_keys=True).encode()
    h1 = np.asarray(h1, np.uint64)
    h2 = np.asarray(h2, np.uint64)
    host = {"meta": np.bytes_(blob), "h1": h1, "h2": h2,
            "checksum": _tier_checksum(h1, h2, blob)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **host)
    if os.path.exists(path):
        os.replace(path, path + ".prev")
    os.replace(tmp, path)


def peek_tier_meta(path: str) -> Optional[dict]:
    """The tier's meta dict without loading the key arrays, or None when
    no readable candidate exists (a torn main file falls through to
    ``.prev``, as :func:`load_tier` would)."""
    for cand in (path, path + ".prev"):
        if not os.path.exists(cand):
            continue
        try:
            with np.load(cand) as z:
                if "meta" in z.files:
                    return json.loads(z["meta"].item().decode())
        except Exception:  # noqa: BLE001 (torn file: try .prev)
            continue
    return None


def load_tier(path: str, expect_meta: Optional[dict] = None
              ) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Load and verify a tier dump -> ``(h1, h2, meta)``.  A torn main
    file falls back to ``.prev`` with a warning; no verifiable candidate
    raises :class:`TierCorrupt`; a format or ``expect_meta`` mismatch
    raises :class:`TierMismatch`."""
    last_err: Optional[str] = None
    for cand in (path, path + ".prev"):
        if not os.path.exists(cand):
            continue
        try:
            with np.load(cand) as z:
                data = {k: z[k] for k in z.files}
        except Exception as e:  # noqa: BLE001 (torn zip: try .prev)
            last_err = f"{cand}: unreadable ({type(e).__name__}: {e})"
            continue
        if not all(k in data for k in ("meta", "h1", "h2", "checksum")):
            last_err = f"{cand}: not a tier dump (missing entries)"
            continue
        blob = data["meta"].item()
        h1 = np.asarray(data["h1"], np.uint64)
        h2 = np.asarray(data["h2"], np.uint64)
        want = int(np.uint32(data["checksum"]))
        got = int(_tier_checksum(h1, h2, blob))
        if want != got:
            last_err = (f"{cand}: tier checksum mismatch "
                        f"(stored {want:#010x}, computed {got:#010x})")
            continue
        if cand.endswith(".prev") and last_err:
            warnings.warn(f"tier {path}: main dump unusable "
                          f"({last_err}); resuming from .prev",
                          RuntimeWarning, stacklevel=2)
        meta = json.loads(blob.decode())
        if meta.get("fmt") != TIER_FORMAT:
            raise TierMismatch(
                f"{cand}: tier format {meta.get('fmt')!r} != expected "
                f"{TIER_FORMAT!r}: refusing a cross-version tier")
        for k, v in (expect_meta or {}).items():
            if meta.get(k) != v:
                raise TierMismatch(
                    f"{cand}: tier {k!r} mismatch: stored "
                    f"{meta.get(k)!r}, expected {v!r} (a foreign "
                    "encoding must never seed exact-dedup state)")
        return h1, h2, meta
    raise TierCorrupt(
        f"{path}: no loadable tier candidate "
        f"({last_err or 'no file exists'})")


class FrontierSpool:
    """Host queue of frontier row segments for one BFS level."""

    def __init__(self):
        self.segments: List[np.ndarray] = []

    def push(self, rows: np.ndarray) -> None:
        if len(rows):
            self.segments.append(np.asarray(rows, np.int32))

    def pop(self) -> Optional[np.ndarray]:
        return self.segments.pop(0) if self.segments else None

    def concat(self, width: int) -> np.ndarray:
        if not self.segments:
            return np.zeros((0, width), np.int32)
        return np.concatenate(self.segments, axis=0)


class _DrainWorker:
    """The single ordered drain worker: jobs run in submission order on
    one daemon thread, so a refilter queued before an eviction always
    sees the pre-eviction tier.  A job that raises parks its exception
    and the rest of the queue is skipped; the next :meth:`barrier`
    raises it on the driver's thread."""

    def __init__(self):
        self._q: "queue_mod.Queue" = queue_mod.Queue()
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        self.busy_secs = 0.0

    def _loop(self) -> None:
        while True:
            fn = self._q.get()
            try:
                if fn is not None and self._exc is None:
                    t0 = time.time()
                    fn()
                    self.busy_secs += time.time() - t0
            except BaseException as e:  # noqa: BLE001 (raised at the
                self._exc = e           # next barrier)
            finally:
                self._q.task_done()

    def submit(self, fn) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="dslabs-spill-drain")
            self._thread.start()
        self._q.put(fn)

    def pending(self) -> bool:
        return self._q.unfinished_tasks > 0

    def barrier(self) -> None:
        self._q.join()
        if self._exc is not None:
            e, self._exc = self._exc, None
            raise e


class SpillManager:
    """Per-run spill state.  The engine decides when (load factor, abort
    codes); this object owns the host tier, the two spools, the exact
    count bookkeeping, the refilter and the ordered drain queue."""

    def __init__(self, config: Optional[SpillConfig] = None):
        self.config = config or SpillConfig()
        self.tier = HostVisitedTier(host_cap=self.config.host_cap)
        self.spool_cur = FrontierSpool()    # level being consumed
        self.spool_next = FrontierSpool()   # level being assembled
        self.stats = SpillStats()
        self._worker: Optional[_DrainWorker] = None
        # The drain walls (busy, wait) at the last level_walls() call.
        self._walls_reported = (0.0, 0.0)
        # The telemetry recorder, set by the engine at run start (None =
        # no events).
        self.telemetry = None
        # Device-table inserts of this epoch that duplicate a tier key
        # (refilter hits); reset at each eviction.
        self.dup_epoch = 0

    def reset_run(self) -> None:
        """Fresh-run reset (tier, spools, counters, epoch), so a search
        run twice never refilters its second run against the first's
        tier.  A resume calls :meth:`restore` instead."""
        self.barrier()
        self.tier = HostVisitedTier(host_cap=self.config.host_cap)
        self.spool_cur = FrontierSpool()
        self.spool_next = FrontierSpool()
        self.stats = SpillStats()
        self.dup_epoch = 0
        self._walls_reported = (0.0, 0.0)
        if self._worker is not None:
            self._worker.busy_secs = 0.0

    # ----------------------------------------------------- drain queue

    def submit_drain(self, fn) -> None:
        """Queue one drain job (refilter + spool, or an eviction absorb):
        on the ordered worker with ``async_drain``, else inline."""
        if not self.config.async_drain:
            fn()
            return
        if self._worker is None:
            self._worker = _DrainWorker()
        self._worker.submit(fn)

    def barrier(self) -> None:
        """Wait for every queued drain job and raise a parked exception;
        every read of the counts or spools goes behind it."""
        w = self._worker
        if w is None:
            return
        if not w.pending():
            w.barrier()
            return
        t0 = time.time()
        try:
            w.barrier()
        finally:
            self.stats.drain_wait_ms += int((time.time() - t0) * 1000)
            self.stats.drain_wall_ms = int(w.busy_secs * 1000)

    def level_walls(self) -> dict:
        """The drain's wall split since the last call: seconds inside
        drain jobs, seconds the search loop blocked on them, and their gap
        (host work hidden behind the device)."""
        busy = (self._worker.busy_secs if self._worker is not None
                else 0.0)
        self.stats.drain_wall_ms = int(busy * 1000)
        wait = self.stats.drain_wait_ms / 1000.0
        pb, pw = self._walls_reported
        self._walls_reported = (busy, wait)
        return {"drain_wall": round(busy - pb, 4),
                "drain_wait": round(wait - pw, 4),
                "drain_overlap": round(max(0.0, (busy - pb)
                                           - (wait - pw)), 4)}

    # ------------------------------------------------------------ state

    @property
    def active(self) -> bool:
        """Once anything has been tiered or spooled, level boundaries
        take the refilter path."""
        self.barrier()
        return (len(self.tier) > 0 or bool(self.spool_cur.segments)
                or bool(self.spool_next.segments))

    def should_evict(self, vis_n: int, cap: int) -> bool:
        return vis_n >= int(self.config.high_water * cap)

    def unique(self, vis_n_device: int) -> int:
        """Exact distinct-state count across tiers."""
        self.barrier()
        return len(self.tier) + int(vis_n_device) - self.dup_epoch

    # ------------------------------------------------------- operations

    def evict(self, occupied_keys: np.ndarray) -> int:
        """Absorb the device table's occupied lines (the caller empties
        the table right after); starts a fresh epoch.  Returns the keys
        newly tiered."""
        n_new = self.tier.absorb(occupied_keys)
        self.stats.spilled_keys += n_new
        self.stats.evictions += 1
        self.dup_epoch = 0
        if self.telemetry is not None:
            self.telemetry.event("spill_evict", keys=n_new,
                                 tier=len(self.tier))
        return n_new

    def refilter(self, rows: np.ndarray, keys: np.ndarray) -> np.ndarray:
        """Drop the rows whose key is already in the tier (re-discoveries
        of pre-eviction states) and charge each to ``dup_epoch``.
        Returns the kept rows."""
        if not len(rows) or not len(self.tier):
            return np.asarray(rows, np.int32)
        hit = self.tier.contains(keys)
        n_hit = int(hit.sum())
        if n_hit:
            self.stats.host_tier_hits += n_hit
            self.dup_epoch += n_hit
            rows = np.asarray(rows)[~hit]
        return np.asarray(rows, np.int32)

    def spool(self, rows: np.ndarray) -> None:
        """Queue refiltered next-level rows for a later wave."""
        if len(rows):
            self.stats.respilled_frontier += len(rows)
            self.spool_next.push(rows)
            if self.telemetry is not None:
                self.telemetry.event(
                    "spill_spool", rows=len(rows),
                    spool_rows=sum(len(r) for r in self.spool_next.segments),
                    tier=len(self.tier))

    def pop_current(self) -> Optional[np.ndarray]:
        self.barrier()
        seg = self.spool_cur.pop()
        if seg is not None:
            self.stats.reinjections += 1
            if self.telemetry is not None:
                self.telemetry.event("spill_reinject", rows=len(seg),
                                     tier=len(self.tier))
        return seg

    def advance_level(self) -> None:
        """Level boundary: the assembled next level becomes current."""
        self.barrier()
        assert not self.spool_cur.segments, \
            "advance_level with unconsumed current-level segments"
        self.spool_cur, self.spool_next = self.spool_next, FrontierSpool()

    # ------------------------------------------------------ checkpoints

    def checkpoint_keys(self, device_keys: np.ndarray) -> np.ndarray:
        """A dump's ``visited_keys``: device table union tier, exactly
        deduplicated (a resumer's unique base is its length)."""
        self.barrier()
        allk = np.concatenate(
            [np.asarray(device_keys).view(np.uint32).reshape(-1, 4),
             self.tier.key_rows()], axis=0)
        if not len(allk):
            return allk
        return _u64_to_rows(*_sorted_unique(*_rows_to_u64(allk)))

    def checkpoint_extra(self) -> dict:
        return {"spill_stats": self.stats.as_array()}

    def restore(self, visited_keys: np.ndarray,
                extra: Optional[dict] = None) -> None:
        """Resume from a dump: every dumped key goes into the tier and
        the device epoch starts empty (len(tier) + 0 - 0 is the dump's
        distinct count)."""
        self.barrier()
        self.tier = HostVisitedTier(host_cap=self.config.host_cap)
        self.spool_cur = FrontierSpool()
        self.spool_next = FrontierSpool()
        self.dup_epoch = 0
        self.tier.absorb(visited_keys)
        if extra and "spill_stats" in extra:
            self.stats = SpillStats.from_array(extra["spill_stats"])

    def attach(self, outcome) -> None:
        """Put the accounting on a SearchOutcome (never silent)."""
        self.barrier()
        if self._worker is not None:
            self.stats.drain_wall_ms = int(self._worker.busy_secs * 1000)
        outcome.spilled_keys = self.stats.spilled_keys
        outcome.host_tier_hits = self.stats.host_tier_hits
        outcome.respilled_frontier = self.stats.respilled_frontier
        outcome.spill_drain_ms = self.stats.drain_wall_ms
        outcome.spill_wait_ms = self.stats.drain_wait_ms


def spill_manager_for_audit() -> SpillConfig:
    """The configuration of a minimal manager whose only job is putting
    an engine in spill mode (``TensorSearch(spill=...)`` builds the
    manager from it), so that the hot-path audit
    (``analysis/hotpath_audit.py``) covers the spill variant's step,
    drain, eviction and reinjection sites.  The audit runs no search: the
    tier stays empty and the small host cap costs nothing."""
    return SpillConfig(high_water=0.60, host_cap=1 << 16)
