"""The traced search: device activity from ``torch.profiler`` and host
spans at the program's dispatch seam, reduced to what the per-layer
readers and the result's ``breakdown`` take.  Each idle gap of the card
is split over the dispatches open during it, by tag, and the host's
time between dispatches (``host``).

Device activity is read straight from the profiler's kineto events
(summed by name without ``key_averages()``, which took longer than runs
of 90,000-280,000 launches).  The device is busy where any kernel, copy
or fill ran: the union of their intervals, so work that overlaps on two
streams counts once.  Host spans are recorded around each
``TensorSearch._dispatch`` call on the host's monotonic clock; the
profiler's clock is found by which of the monotonic and the wall clock
puts the device's activity inside those spans.
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Optional, Tuple

# Seconds the profiled region waits after its last synchronize before
# the profiler stops, so that the tail of the device records is kept.
SETTLE_SECS = 0.2
TOP = 10


class Spans:
    """Host spans of the dispatch seam: ``hook`` goes in as the
    engine's ``_dispatch_hook``."""

    def __init__(self):
        self.spans: List[Tuple[int, int, str]] = []
        self.on = False
        # One instant on both candidate clocks of the profiler.
        self.mono0 = time.monotonic_ns()
        self.wall0 = time.time_ns()

    def hook(self, tag, fn, *args):
        if not self.on:
            return fn(*args)
        t0 = time.monotonic_ns()
        try:
            return fn(*args)
        finally:
            self.spans.append((t0, time.monotonic_ns(), tag))


def device_events(torch, prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of every timed device record."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda:
            continue
        if ev.is_async() or ev.start_thread_id() != ev.end_thread_id():
            continue
        out.append((ev.name(), ev.start_ns(), ev.end_ns()))
    return out


def is_launch(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def _union(events, lo: int, hi: int) -> List[Tuple[int, int]]:
    iv = sorted((max(s, lo), min(e, hi)) for _n, s, e in events
                if e > lo and s < hi)
    merged: List[List[int]] = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _to_mono(events, spans: Spans) -> Optional[int]:
    """The offset that brings the profiler's clock onto the spans'
    monotonic clock, or None where neither candidate fits."""
    if not events or not spans.spans:
        return None
    lo = spans.spans[0][0] - 10 ** 6
    hi = spans.spans[-1][1] + 10 ** 9
    best, best_in = None, 0.0
    for off in (0, spans.mono0 - spans.wall0):
        inside = sum(lo <= s + off <= hi for _n, s, _e in events)
        share = inside / len(events)
        if share > best_in:
            best, best_in = off, share
    return best if best_in >= 0.9 else None


def reduce(events, spans: Spans, window: Tuple[int, int],
           wall_s: float) -> dict:
    """The traced search's device record: kernels by name, launches, the
    union of device activity in the window (monotonic ns, the search's
    start and end), and the idle gaps by the dispatch tag open at their
    start."""
    by_name: Dict[str, list] = collections.defaultdict(lambda: [0, 0.0])
    for name, s, e in events:
        rec = by_name[name]
        rec[0] += 1
        rec[1] += (e - s) / 1e9
    if not events:
        return {"kernels": {}, "launches": 0, "busy_s": 0.0,
                "window_s": wall_s, "aligned": False, "device_ops": [],
                "idle_gaps": []}
    off = _to_mono(events, spans)
    if off is not None:
        lo, hi = window
        shifted = [(n, s + off, e + off) for n, s, e in events]
    else:
        lo = min(s for _n, s, _e in events)
        hi = max(e for _n, _s, e in events)
        shifted = events
    busy = _union(shifted, lo, hi)
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps: Dict[str, float] = collections.defaultdict(float)
    ordered = sorted(spans.spans)
    ends = [e for _s, e, _t in ordered]
    edges = [lo] + [e for _s, e in busy]
    nexts = [s for s, _e in busy] + [hi]
    for a, b in zip(edges, nexts):
        if b <= a:
            continue
        if off is None:
            gaps["unaligned"] += (b - a) / 1e9
            continue
        # Each part of the gap goes to the dispatch open over it, the
        # rest to the host between dispatches.
        covered = 0
        i = bisect.bisect_right(ends, a)
        while i < len(ordered) and ordered[i][0] < b:
            s0, e0, tag = ordered[i]
            part = min(e0, b) - max(s0, a)
            if part > 0:
                gaps[tag] += part / 1e9
                covered += part
            i += 1
        if b - a > covered:
            gaps["host"] += (b - a - covered) / 1e9
    kernels = {n: {"count": c, "seconds": s} for n, (c, s)
               in by_name.items()}
    return {
        "kernels": kernels,
        "launches": sum(c for n, (c, _s) in by_name.items()
                        if is_launch(n)),
        "busy_s": busy_s,
        "window_s": wall_s,
        "aligned": off is not None,
        "device_ops": [[n[:120], s] for n, (_c, s) in sorted(
            by_name.items(), key=lambda kv: -kv[1][1])[:TOP]],
        "idle_gaps": [[t, s] for t, s in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:TOP]],
    }
