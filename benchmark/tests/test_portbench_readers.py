"""Each per-layer reader on a recorded trace record, the roofline
arithmetic, and the reduction of device events and host spans."""

import json
import os

import pytest

from conftest import BENCH
from harness import peaks
from harness import trace as trace_mod
from harness.manifest import load_reader

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "trace_record.json")


@pytest.fixture
def rec():
    with open(FIXTURE) as f:
        return json.load(f)


def test_chunk_fill(rec):
    assert load_reader("chunk_fill_pct", BENCH)(rec) == pytest.approx(
        100.0 * 1228800 / (100 * 16384))


def test_launches_per_chunk_step(rec):
    assert load_reader("launches_per_chunk_step", BENCH)(rec) == \
        pytest.approx(7002.03)


def test_bytes_per_state(rec):
    assert load_reader("bytes_per_state", BENCH)(rec) == 868


def test_fingerprint_roofline(rec):
    rows = 6000000 + 2
    ops_s = rows * 842 * 28 / (132 * 64 * 1.98e9)
    bytes_s = rows * (842 * 4 + 16) / 3.35e12
    want = 100.0 * max(ops_s, bytes_s) / 0.1
    got = load_reader("fingerprint_roofline_pct", BENCH)(rec)
    assert got == pytest.approx(want)
    assert ops_s > bytes_s          # operations bind kernel 1


def test_visited_roofline(rec):
    want = 100.0 * ((6000000 + 1) * 145 + 1400000 * 16) / 3.35e12 / 0.02
    assert load_reader("visited_roofline_pct", BENCH)(rec) == \
        pytest.approx(want)


def test_device_idle(rec):
    assert load_reader("device_idle_pct", BENCH)(rec) == pytest.approx(25.0)


def test_readers_find_nothing_where_nothing_ran(rec):
    rec["device"] = {"kernels": {}, "launches": 0, "busy_s": 0.0,
                     "window_s": 1.0}
    rec["sm_count"] = None
    for name in ("launches_per_chunk_step", "fingerprint_roofline_pct",
                 "visited_roofline_pct", "device_idle_pct"):
        assert load_reader(name, BENCH)(rec) is None, name


def test_peaks():
    assert peaks.int32_ops_per_s(132) == pytest.approx(1.672704e13)
    assert peaks.least_seconds(1.672704e13, 0, 132) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12, 132) == pytest.approx(1.0)
    assert peaks.roofline_pct(1.0, 0.0) is None
    assert peaks.roofline_pct(1.0, 4.0) == pytest.approx(25.0)


def test_reduce_unions_overlaps_and_names_gaps():
    spans = trace_mod.Spans()
    spans.mono0 = spans.wall0 = 0       # the profiler's clock is ours
    spans.spans = [(1000, 5000, "sharded.superstep"),
                   (6000, 9000, "sharded.promote")]
    events = [("k1", 1000, 2000), ("k2", 1500, 3000),    # overlap
              ("Memcpy HtoD", 6500, 7000), ("k1", 8000, 9000)]
    d = trace_mod.reduce(events, spans, (1000, 10000), 9e-6)
    assert d["aligned"]
    assert d["busy_s"] == pytest.approx((2000 + 500 + 1000) / 1e9)
    assert d["launches"] == 3
    assert d["kernels"]["k1"] == {"count": 2, "seconds": 2e-6}
    gaps = dict(d["idle_gaps"])
    # 3000-5000 inside the superstep, 5000-6000 between dispatches,
    # 6000-6500 and 7000-8000 inside the promote, 9000-10000 after.
    assert gaps["sharded.superstep"] == pytest.approx(2e-6)
    assert gaps["host"] == pytest.approx(2e-6)
    assert gaps["sharded.promote"] == pytest.approx(1.5e-6)
    assert d["idle_gaps"][0][0] in ("sharded.superstep", "host")
    assert d["device_ops"][0][0] == "k1"
