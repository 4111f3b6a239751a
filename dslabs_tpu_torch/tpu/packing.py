"""Bit-packed frontier rows: the counterpart of
``dslabs_tpu/tpu/packing.py``.

A compiled spec declares tiny value domains for most lanes (an enum tag,
a node index, a ballot bit); storing each as a full int32 wastes the
frontier's bytes.  :func:`derive_packing` turns a protocol's
``lane_domains`` into a :class:`LanePacking` descriptor, and the device
wave loop stores its frontier buffers at ``words`` int32 words per row
(``engine.py``), decoding each chunk where it is read.  Handlers,
predicates and fingerprints always see the unpacked int32 rows, so a
packed search gives the same counts and verdicts as an unpacked one.

Descriptor model, as in the reference: every flat lane (nodes ++ net ++
timers ++ exc) gets a word, a bit offset, a bit width, a domain bias
``lo`` and whether it can hold the engine's SENTINEL.  A bounded lane
``[lo, hi]`` encodes ``v - lo``; SENTINEL maps to the lane's all-ones
code, which the domain never reaches; an undeclared lane stays a raw
32-bit word; a delta lane (``("delta", bits)``) encodes ``v - base``
against a caller-carried ``base`` when derived with ``delta=True``, and
is raw otherwise (the single-device engine's default).  Lanes are laid
out first-fit in declaration order and never straddle a word, so the
lanes of one word are contiguous.  A protocol with no declared domains
derives the identity descriptor.

The torch codec (:meth:`LanePacking.pack` / :meth:`LanePacking.unpack`)
gives the bits of the reference's ``pack_jnp`` / ``unpack_jnp``, which
loop over words in Python; here each is a few whole-row ops.  Unpack
gathers each lane's word, shifts and masks; pack shifts each lane's code
into place and sums the lanes into their words with ``index_add_``: the
bit fields do not overlap, so the sum is an OR.  uint32 arithmetic runs
in int64 masked to 32 bits (torch's CPU build has no uint32 shifts) and
the words are stored as int32 with the same bits.  Pack works through
the rows in blocks to bound its int64 temporaries.

Packing never guesses: a live value outside its declared domain is
counted by ``pack(..., count_bad=True)`` and the engine raises
``CapacityOverflow``.  The host codec (``pack_np`` / ``unpack_np``) is
the reference's, copied.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ["LanePacking", "derive_packing", "RAW_WIDTH"]

RAW_WIDTH = 32

_M32 = 0xFFFFFFFF

# Rows per block of :meth:`LanePacking.pack`: bounds its int64
# temporaries (one block of flagship rows is 220 MB each).
PACK_BLOCK = 1 << 15

# Engine SENTINEL (duplicated to keep this module import-light; pinned
# equal by tests/test_packing.py).
_SENTINEL = np.int32(2 ** 31 - 1)


def _width_for(lo: int, hi: int, sentinel: bool) -> int:
    """Bit width for domain [lo, hi] (+1 reserved all-ones sentinel
    code when the lane can hold SENTINEL)."""
    span = hi - lo + 1
    codes = span + (1 if sentinel else 0)
    w = max(1, int(codes - 1).bit_length())
    # Sentinel lanes need the all-ones code strictly above the domain:
    # 2^w - 1 >= span, guaranteed by bit_length(codes - 1) with the +1.
    return w


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a value in [0, 2^32) -> int32 with the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class LanePacking:
    """Per-lane packing descriptor for one protocol's flat state rows.

    Arrays are all length ``lanes`` (numpy int64/bool):
    ``word``/``shift``/``width`` place each lane,
    ``lo`` is the domain bias, ``sent`` marks SENTINEL-capable lanes,
    ``raw`` marks 32-bit passthrough lanes, ``dlt`` marks
    delta-from-base lanes (bias supplied at pack/unpack time via the
    ``base`` vector instead of the static ``lo``)."""

    lanes: int
    words: int
    word: np.ndarray
    shift: np.ndarray
    width: np.ndarray
    lo: np.ndarray
    sent: np.ndarray
    raw: np.ndarray
    dlt: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.dlt is None:
            object.__setattr__(self, "dlt",
                               np.zeros(self.lanes, bool))
        # Per-device tensors of the descriptor (see _consts).
        object.__setattr__(self, "_dev", {})

    # ------------------------------------------------------------ meta

    @property
    def identity(self) -> bool:
        """True when packing is a no-op (every lane raw, one word per
        lane) — the hand-twin default; callers skip the wrap entirely."""
        return self.words == self.lanes and bool(self.raw.all())

    @property
    def has_delta(self) -> bool:
        """True when any lane is delta-from-base encoded — pack/unpack
        then REQUIRE the ``base`` vector (a missing base is a loud
        ValueError, never a silent zero-bias decode)."""
        return bool(self.dlt.any())

    @property
    def delta_lanes(self) -> np.ndarray:
        """Flat lane indices of the delta-encoded lanes, in order."""
        return np.nonzero(self.dlt)[0]

    @property
    def bytes_per_state(self) -> int:
        """Packed bytes per stored frontier row."""
        return int(self.words) * 4

    @property
    def bytes_per_state_unpacked(self) -> int:
        return int(self.lanes) * 4

    @property
    def pack_ratio(self) -> float:
        """unpacked/packed bytes — >= 1.0; the capacity multiplier on
        frontier_cap/visited-spool width at fixed HBM."""
        return self.bytes_per_state_unpacked / max(self.bytes_per_state,
                                                   1)

    def signature(self) -> str:
        """Stable identity of the ENCODING (not the protocol): two
        descriptors with equal signatures produce byte-identical packed
        rows.  Rides checkpoints as the ``frontier_encoding`` marker."""
        if self.identity:
            return "raw"
        parts = [
            np.asarray([self.lanes, self.words], np.int64),
            self.word.astype(np.int64), self.shift.astype(np.int64),
            self.width.astype(np.int64), self.lo.astype(np.int64),
            self.sent.astype(np.int64), self.raw.astype(np.int64),
        ]
        # Delta lanes extend the blob ONLY when present, so every
        # pre-existing (static-domain) descriptor keeps its signature
        # and old checkpoints keep resuming.
        if self.has_delta:
            parts.append(self.dlt.astype(np.int64))
        blob = np.concatenate(parts).tobytes()
        return f"packed:{self.words}w:{zlib.crc32(blob) & 0xFFFFFFFF:08x}"

    def descriptor(self) -> dict:
        """The reportable packing descriptor:
        lane -> word/offset/width plus the headline byte counts."""
        return {
            "lanes": int(self.lanes),
            "words": int(self.words),
            "bytes_per_state": self.bytes_per_state,
            "bytes_per_state_unpacked": self.bytes_per_state_unpacked,
            "pack_ratio": round(self.pack_ratio, 3),
            "signature": self.signature(),
            "lane_bits": [int(w) for w in self.width],
            "delta_lanes": int(self.dlt.sum()),
        }

    # ----------------------------------------------- word/lane ranges

    def _word_ranges(self) -> List[Tuple[int, int, int]]:
        """[(word, lane_start, lane_end)] — lanes are assigned to words
        contiguously in order, so each word covers one lane slice."""
        out = []
        for w in range(self.words):
            idx = np.nonzero(self.word == w)[0]
            out.append((w, int(idx[0]), int(idx[-1]) + 1))
        return out

    # ----------------------------------------------------- torch path

    def _require_base(self, base):
        if self.has_delta and base is None:
            raise ValueError(
                "packing descriptor has delta lanes but no base vector "
                "was supplied — the caller must carry the per-level "
                "base")

    def _consts(self, device) -> dict:
        """The descriptor's arrays as tensors on ``device``, built once:
        word index, shift, mask, bias, raw and sentinel-code flags."""
        key = str(device)
        c = self._dev.get(key)
        if c is None:
            mask = (np.int64(1) << self.width.astype(np.int64)) - 1

            def t(a, dtype=torch.int64):
                return torch.as_tensor(np.asarray(a)).to(dtype).to(device)

            c = {"word": t(self.word), "shift": t(self.shift),
                 "mask": t(mask), "lo": t(self.lo),
                 "raw": t(self.raw, torch.bool),
                 "sent": t(self.sent & ~self.raw, torch.bool),
                 "dlt": t(self.dlt, torch.bool)}
            self._dev[key] = c
        return c

    def _lo_eff(self, c: dict, base) -> torch.Tensor:
        """Per-lane bias [lanes] int64: the static ``lo`` except on delta
        lanes, where the caller's ``base`` vector supplies it."""
        if not self.has_delta:
            return c["lo"]
        b = torch.as_tensor(base).to(device=c["lo"].device,
                                     dtype=torch.int64).reshape(-1)
        return torch.where(c["dlt"], b, c["lo"])

    def pack(self, rows: torch.Tensor, base=None, count_bad: bool = False):
        """[N, lanes] int32 -> [N, words] int32, the bits of the
        reference's ``pack_jnp``.  With ``count_bad`` also returns an
        int32 [N] count of each row's values outside their declared
        domain.  ``base`` is the [lanes] bias vector, required iff the
        descriptor has delta lanes.  Rows go through in blocks of
        ``PACK_BLOCK``."""
        self._require_base(base)
        n = rows.shape[0]
        if self.identity:
            return ((rows, torch.zeros((n,), dtype=torch.int32,
                                       device=rows.device))
                    if count_bad else rows)
        c = self._consts(rows.device)
        lo = self._lo_eff(c, base)
        out = torch.empty((n, self.words), dtype=torch.int32,
                          device=rows.device)
        bad = (torch.empty((n,), dtype=torch.int32, device=rows.device)
               if count_bad else None)
        block = PACK_BLOCK
        for s in range(0, n, block):
            blk = rows[s:s + block]
            is_sent = blk == _SENTINEL
            # (v - lo) mod 2^32, the reference's uint32 span.
            span = (blk.to(torch.int64) - lo) & _M32
            enc = torch.where(c["sent"] & is_sent, c["mask"],
                              span & c["mask"])
            words = torch.zeros((blk.shape[0], self.words),
                                dtype=torch.int64, device=rows.device)
            words.index_add_(1, c["word"], enc << c["shift"])
            out[s:s + block] = _i32(words)
            if count_bad:
                # A bounded lane's value not SENTINEL whose span exceeds
                # the lane's width, or hits the reserved sentinel code.
                off = (span > c["mask"]) | (c["sent"] & (span == c["mask"]))
                bad[s:s + block] = (off & ~c["raw"] & ~is_sent).sum(
                    1, dtype=torch.int32)
        return (out, bad) if count_bad else out

    def unpack(self, packed: torch.Tensor, base=None) -> torch.Tensor:
        """[N, words] int32 -> [N, lanes] int32, the exact inverse of
        :meth:`pack` on in-domain rows packed against the same ``base``
        (the bits of the reference's ``unpack_jnp``)."""
        self._require_base(base)
        if self.identity:
            return packed
        c = self._consts(packed.device)
        lo = self._lo_eff(c, base)
        word = packed.to(torch.int64).index_select(1, c["word"]) & _M32
        bits = (word >> c["shift"]) & c["mask"]
        val = torch.where(c["raw"], bits, (bits + lo) & _M32)
        val = _i32(val)
        return torch.where(c["sent"] & (bits == c["mask"]), _SENTINEL, val)

    # ------------------------------------------------------ host path

    def _lo_eff_np(self, base) -> np.ndarray:
        if not self.has_delta:
            return self.lo
        return np.where(self.dlt,
                        np.asarray(base, np.int64).reshape(-1), self.lo)

    def pack_np(self, rows: np.ndarray, base=None) -> np.ndarray:
        """Host-side codec (the reference's ``pack_np``, exact same bits)."""
        self._require_base(base)
        rows = np.asarray(rows, np.int32).reshape(-1, self.lanes)
        if self.identity:
            return rows
        lo_eff = self._lo_eff_np(base)
        mask = ((np.uint64(1) << self.width.astype(np.uint64)) - 1
                ).astype(np.uint32)
        is_sent = rows == _SENTINEL
        enc = ((rows.astype(np.uint32)
                - lo_eff.astype(np.uint32)) & mask)
        enc = np.where(self.raw[None, :], rows.astype(np.uint32), enc)
        enc = np.where((self.sent & ~self.raw)[None, :] & is_sent,
                       mask[None, :], enc)
        shifted = enc << self.shift.astype(np.uint32)[None, :]
        out = np.zeros((len(rows), self.words), np.uint32)
        for w, s, e in self._word_ranges():
            out[:, w] = shifted[:, s:e].sum(axis=1, dtype=np.uint32)
        return out.astype(np.int32)

    def unpack_np(self, packed: np.ndarray, base=None) -> np.ndarray:
        self._require_base(base)
        packed = np.asarray(packed, np.int32).reshape(-1, self.words)
        if self.identity:
            return packed
        pu = packed.astype(np.uint32)
        bits = np.zeros((len(packed), self.lanes), np.uint32)
        for w, s, e in self._word_ranges():
            mk = ((np.uint64(1) << self.width[s:e].astype(np.uint64)) - 1
                  ).astype(np.uint32)
            bits[:, s:e] = ((pu[:, w:w + 1]
                             >> self.shift[s:e].astype(np.uint32)[None, :])
                            & mk[None, :])
        mask = ((np.uint64(1) << self.width.astype(np.uint64)) - 1
                ).astype(np.uint32)
        val = (bits.astype(np.int64)
               + self._lo_eff_np(base).astype(np.int64)).astype(np.int32)
        val = np.where(self.raw[None, :], bits.astype(np.int32), val)
        return np.where((self.sent & ~self.raw)[None, :]
                        & (bits == mask[None, :]), _SENTINEL, val)


def _flat_domains(protocol) -> Tuple[List[Optional[Tuple[int, int]]],
                                     List[bool]]:
    """Expand ``protocol.lane_domains`` to per-flat-lane (domain,
    sentinel-capable) in ``flatten_state`` order: nodes ++ net ++
    timers ++ exc."""
    p = protocol
    ld = getattr(p, "lane_domains", None) or {}
    nodes = list(ld.get("nodes") or [None] * p.node_width)
    msg = list(ld.get("msg") or [None] * p.msg_width)
    tmr = list(ld.get("timer") or [None] * p.timer_width)
    exc = ld.get("exc")
    if len(nodes) != p.node_width or len(msg) != p.msg_width \
            or len(tmr) != p.timer_width:
        raise ValueError(
            f"{p.name}: lane_domains shape mismatch "
            f"(nodes {len(nodes)}/{p.node_width}, msg "
            f"{len(msg)}/{p.msg_width}, timer {len(tmr)}/"
            f"{p.timer_width})")
    doms: List[Optional[Tuple[int, int]]] = []
    sent: List[bool] = []
    doms += nodes
    sent += [False] * p.node_width
    for _ in range(p.net_cap):
        doms += msg
        sent += [True] * p.msg_width
    for _ in range(p.n_nodes * p.timer_cap):
        doms += tmr
        sent += [True] * p.timer_width
    doms.append(exc)
    sent.append(False)
    return doms, sent


def derive_packing(protocol, lanes: int,
                   delta: bool = False) -> LanePacking:
    """Derive the packing descriptor for one protocol's flat rows.
    ``lanes`` is the engine's flat row width (cross-checked).  No
    declared domains -> the identity descriptor.

    ``delta`` opts into the delta-from-base lanes:
    a ``("delta", bits)`` domain packs ``v - base`` in ``bits`` bits
    with a caller-carried base vector.  With ``delta=False`` (the
    single-device engine) delta domains derive as raw 32-bit lanes —
    correct, just uncompressed — so a spec annotated for the mesh
    still runs unchanged on one chip."""
    doms, sent_caps = _flat_domains(protocol)
    if len(doms) != lanes:
        raise ValueError(
            f"{protocol.name}: domain expansion produced {len(doms)} "
            f"lanes, engine rows have {lanes}")
    word = np.zeros(lanes, np.int64)
    shift = np.zeros(lanes, np.int64)
    width = np.zeros(lanes, np.int64)
    lo = np.zeros(lanes, np.int64)
    sent = np.zeros(lanes, bool)
    raw = np.zeros(lanes, bool)
    dlt = np.zeros(lanes, bool)
    cur_word, cur_bits = 0, 0
    for i, (dom, s_cap) in enumerate(zip(doms, sent_caps)):
        is_dlt = False
        if dom is None:
            w, is_raw, lo_i = RAW_WIDTH, True, 0
        elif isinstance(dom, tuple) and len(dom) and dom[0] == "delta":
            bits = int(dom[1])
            if bits < 1:
                raise ValueError(
                    f"{protocol.name}: lane {i} delta width {bits} "
                    "must be >= 1 bit")
            is_dlt = delta and bits < RAW_WIDTH
            if is_dlt:
                w, is_raw, lo_i = bits, False, 0
            else:
                w, is_raw, lo_i = RAW_WIDTH, True, 0
        else:
            lo_i, hi_i = int(dom[0]), int(dom[1])
            if hi_i < lo_i:
                raise ValueError(
                    f"{protocol.name}: lane {i} domain [{lo_i}, {hi_i}] "
                    "is empty (hi < lo)")
            w = _width_for(lo_i, hi_i, s_cap)
            is_raw = w >= RAW_WIDTH or hi_i >= int(_SENTINEL)
            if is_raw:
                w, lo_i = RAW_WIDTH, 0
        if cur_bits + w > 32:
            cur_word += 1
            cur_bits = 0
        word[i] = cur_word
        shift[i] = cur_bits
        width[i] = w
        lo[i] = lo_i
        sent[i] = s_cap and not is_raw
        raw[i] = is_raw
        dlt[i] = is_dlt
        cur_bits += w
    return LanePacking(lanes=lanes, words=int(cur_word + 1), word=word,
                       shift=shift, width=width, lo=lo, sent=sent,
                       raw=raw, dlt=dlt)
