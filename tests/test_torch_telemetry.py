"""PyTorch port, the telemetry layer (``dslabs_tpu_torch/tpu/telemetry.py``
and its feeds in the engine, spill tier, swarm, supervisor and warden),
against the JAX package on the CPU.

The single-device cases of ``tests/test_telemetry.py`` run on the port
with ``device="cpu"``: span count equal to dispatch count; the overhead
guard (the same dispatch schedule and the same number of readbacks with
the full recorder, STATUS.json and a trace in the environment, counted
by spies on ``engine.to_host``, ``engine.host_copy`` and the tensor
readbacks ``cpu`` / ``item`` / ``tolist`` / ``numpy`` / ``__bool__`` /
``__int__`` / ``__float__`` / ``__array__``); the flight log's records
and levels; the torn-tail reader; the run-dir layout; a SIGKILLed run's
flight log naming its in-flight dispatch, and ``watch`` surviving the
kill; the ``report --json`` keys; the ledger compare (both cases);
supervisor retries as events and span retries; the profiler window, by
argument.  The reference's 8-device STATUS / watch and golden-report
cases run here on one device.

Held against the JAX recorder: the level records, field for field but
``wall`` / ``ts`` (and the drain walls' values), on the pruned pingpong
through both loops, lab1 c3-w4 in spill mode and the partitioned Paxos
spec with its ``faults`` block; the key sets of ``report --json`` and
STATUS.json; ``compare_ledger`` on the reference cases' ledgers.  The
swarm's round records are held for keys and count only: its walks differ
from the JAX walks by design.

Deferred with their slices: sharded span parity, the 8-device lanes and
the mesh halves of the overhead guard and golden report (the sharded
engine), and the bench JSON pin (``bench.py`` is not ported)."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)

from dslabs_tpu.tpu import engine as jeng  # noqa: E402
from dslabs_tpu.tpu import specs as jspecs  # noqa: E402
from dslabs_tpu.tpu import swarm as jsw  # noqa: E402
from dslabs_tpu.tpu import telemetry as jtel  # noqa: E402
from dslabs_tpu.tpu.protocols.clientserver import \
    make_clientserver_protocol as j_cs  # noqa: E402
from dslabs_tpu.tpu.protocols.pingpong import \
    make_pingpong_protocol as j_pp  # noqa: E402
from dslabs_tpu.tpu.sharded import make_mesh  # noqa: E402
from dslabs_tpu_torch.tpu import checkpoint as tck  # noqa: E402
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.tpu import specs as tspecs  # noqa: E402
from dslabs_tpu_torch.tpu import supervisor as tsup  # noqa: E402
from dslabs_tpu_torch.tpu import swarm as tsw  # noqa: E402
from dslabs_tpu_torch.tpu import telemetry as ttel  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.clientserver import \
    make_clientserver_protocol as t_cs  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.pingpong import \
    make_pingpong_protocol as t_pp  # noqa: E402
from dslabs_tpu_torch.tpu.telemetry import (Telemetry,  # noqa: E402
                                            build_report, read_flight,
                                            render_report, tail_records)

pytestmark = pytest.mark.obs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PP_KW = dict(max_depth=8, frontier_cap=1 << 10, visited_cap=1 << 12,
             chunk=64)
CHILD_ENV = dict(os.environ, OMP_NUM_THREADS="1")


def _pruned(p):
    return dataclasses.replace(p, goals={}, prunes=dict(p.goals))


def _port(p=None, **kw):
    for k, v in PP_KW.items():
        kw.setdefault(k, v)
    return teng.TensorSearch(_pruned(t_pp(2)) if p is None else p,
                             device="cpu", **kw)


def _counting_hook(counts):
    def hook(tag, fn, *args):
        counts[tag] = counts.get(tag, 0) + 1
        return fn(*args)
    return hook


def _spans(tel):
    return [r for r in tel.ring if r["t"] == "span"]


def _levels(tel):
    """Level records without their clock fields (wall, ts) and with the
    drain split's keys only (its values are walls too)."""
    out = []
    for r in tel.levels:
        r = {k: v for k, v in r.items() if k not in ("wall", "ts")}
        if "spill" in r:
            r["spill"] = sorted(r["spill"])
        out.append(r)
    return out


# ------------------------------------------------- span/dispatch parity

@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_span_count_equals_dispatch_count(host):
    counts = {}
    tel = Telemetry()
    search = _port(use_host_visited=host)
    search._dispatch_hook = _counting_hook(counts)
    tel.attach(search)
    out = search.run()
    assert out.end_condition == "SPACE_EXHAUSTED"
    assert sum(counts.values()) == len(_spans(tel)) > 0
    by_tag = {}
    for s in _spans(tel):
        by_tag[s["tag"]] = by_tag.get(s["tag"], 0) + 1
    assert by_tag == counts
    assert set(by_tag) <= set(ttel.DISPATCH_SITES)
    assert all(s["scale"] == 1.0 and s["outcome"] == "ok"
               for s in _spans(tel))


# ----------------------------------------------------- overhead guard

_READBACKS = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
              "__float__", "__array__")


@pytest.mark.parametrize("mode", ["device", "host", "spill"])
def test_overhead_guard_no_added_dispatches_or_readbacks(
        mode, monkeypatch, tmp_path):
    """The recorder adds no dispatch and no readback: with the full
    recorder (flight log, STATUS.json) and a trace in the environment,
    the dispatch schedule and every counted readback are the same as
    without it, on both loops and in spill mode."""
    gets = []

    def spy(name, real):
        def wrapped(*a, **k):
            gets.append(name)
            return real(*a, **k)
        return wrapped

    for name in ("to_host", "host_copy"):
        monkeypatch.setattr(teng, name, spy(name, getattr(teng, name)))
    for name in _READBACKS:
        monkeypatch.setattr(torch.Tensor, name,
                            spy(name, getattr(torch.Tensor, name)))
    kw = dict(use_host_visited=mode == "host")
    if mode == "spill":
        kw.update(p=_pruned(t_cs(n_clients=3, w=4)), chunk=16,
                  max_depth=11, visited_cap=128, frontier_cap=1 << 11,
                  spill=True)

    def run(telemetry):
        counts = {}
        s = _port(telemetry=telemetry, **kw)
        s._dispatch_hook = _counting_hook(counts)
        del gets[:]
        out = s.run()
        return counts, sorted(gets), out

    c0, g0, o0 = run(None)
    assert g0, "the spies saw no readback"
    tel = Telemetry(flight_log=str(tmp_path / "plain" / "flight.jsonl"))
    c1, g1, o1 = run(tel)
    assert c0 == c1, "telemetry changed the dispatch schedule"
    assert g0 == g1, "telemetry added readbacks"
    assert (o0.unique_states, o0.end_condition) == \
        (o1.unique_states, o1.end_condition)
    assert (tmp_path / "plain" / "STATUS.json").exists()
    # run_host returns at an exhausted level before its record, as the
    # reference's does.
    assert len(tel.levels) == o1.depth - (mode == "host")

    monkeypatch.setenv("DSLABS_TRACE_ID", "cafe0123cafe0123")
    monkeypatch.setenv("DSLABS_PARENT_SPAN", "job-x:a1")
    tel_tr = Telemetry(flight_log=str(tmp_path / "tr" / "flight.jsonl"))
    assert tel_tr.trace_id == "cafe0123cafe0123"
    ct, gt, ot = run(tel_tr)
    assert ct == c0 and gt == g0
    assert ot.trace_id == "cafe0123cafe0123"
    assert all(s.get("trace") == "cafe0123cafe0123"
               for s in _spans(tel_tr))


# ------------------------------------------------------- flight log IO

def test_flight_log_records_and_levels(tmp_path):
    flight = str(tmp_path / "flight.jsonl")
    tel = Telemetry(flight_log=flight)
    search = _port()
    tel.attach(search)
    out = search.run()
    tel.close()
    recs = read_flight(flight)
    assert {"meta", "dispatch", "span", "level", "outcome"} <= \
        {r["t"] for r in recs}
    spans = [r for r in recs if r["t"] == "span"]
    starts = [r for r in recs if r["t"] == "dispatch"]
    assert len(spans) == len(starts)
    levels = [r for r in recs if r["t"] == "level"]
    assert len(levels) == out.depth
    assert [lv["depth"] for lv in levels] == list(range(1, out.depth + 1))
    oc = [r for r in recs if r["t"] == "outcome"][-1]
    assert oc["end_condition"] == out.end_condition
    assert oc["unique_states"] == out.unique_states
    # A record after close() is dropped, never raised.
    tel.event("late")
    with tel.span("tool.block"):
        pass
    assert len(read_flight(flight)) == len(recs)


def test_read_flight_tolerates_torn_tail_only(tmp_path):
    p = tmp_path / "t.jsonl"
    good = json.dumps({"t": "span", "tag": "device.step", "i": 0})
    p.write_text(good + "\n" + good + "\n" + '{"t": "disp')
    assert len(read_flight(str(p))) == 2
    p.write_text('{"t": "sp\n' + good + "\n")
    with pytest.raises(ValueError):
        read_flight(str(p))
    assert tail_records(str(p)) == []
    assert tail_records(None) == []


def test_run_dir_layout_names_flight_log(tmp_path):
    from dslabs_tpu.tpu import checkpoint as jck

    ck = str(tmp_path / "search.ckpt")
    lay = tck.run_dir_layout(ck)
    assert lay == jck.run_dir_layout(ck)
    assert lay["flight_log"] == str(tmp_path / "flight.jsonl")
    assert lay["compile_cache"] == str(tmp_path / "compile_cache")
    assert tck.run_dir_layout(None)["flight_log"] is None
    tel = Telemetry.for_checkpoint(ck)
    assert tel.flight_log == lay["flight_log"]
    assert tel.status_path == lay["status"]
    tel.close()
    assert not os.path.exists(lay["compile_cache"])


# ------------------------------------------------------ SIGKILL survival

_KILL_CHILD = r"""
import dataclasses, sys, time
import torch
torch.set_num_threads(1)
from dslabs_tpu_torch.tpu.engine import TensorSearch
from dslabs_tpu_torch.tpu.protocols.pingpong import make_pingpong_protocol
from dslabs_tpu_torch.tpu.telemetry import Telemetry

pp = make_pingpong_protocol(workload_size=2)
pp = dataclasses.replace(pp, goals={}, prunes=dict(pp.goals))
search = TensorSearch(pp, max_depth=10, frontier_cap=1 << 10,
                      visited_cap=1 << 12, chunk=64, device="cpu")
n = [0]
def hook(tag, fn, *args):
    n[0] += 1
    if n[0] == 6:
        print("WEDGED", flush=True)
        time.sleep(600.0)
    return fn(*args)
search._dispatch_hook = hook
if sys.argv[2] == "flight":
    Telemetry(flight_log=sys.argv[1]).attach(search)
else:
    Telemetry.for_checkpoint(sys.argv[1] + "/search.ckpt").attach(search)
search.run()
"""


def _wedged_child(target: str, mode: str, while_wedged=None):
    proc = subprocess.Popen(
        [sys.executable, "-c", _KILL_CHILD, target, mode],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=CHILD_ENV, cwd=ROOT)
    try:
        line = proc.stdout.readline()
        assert "WEDGED" in line
        time.sleep(0.3)
        if while_wedged is not None:
            while_wedged()
        proc.send_signal(signal.SIGKILL)
    finally:
        proc.wait(timeout=30)


def test_flight_log_survives_sigkill_names_inflight_dispatch(tmp_path):
    """A SIGKILLed run's flight log parses with exactly one open
    dispatch, which the report names."""
    flight = str(tmp_path / "flight.jsonl")
    _wedged_child(flight, "flight")
    recs = read_flight(flight)
    spans = {(r["tag"], r["i"]) for r in recs if r["t"] == "span"}
    starts = [r for r in recs if r["t"] == "dispatch"]
    open_starts = [r for r in starts if (r["tag"], r["i"]) not in spans]
    assert len(open_starts) == 1, recs[-3:]
    rep = build_report(recs)
    assert rep["in_flight"]["tag"] == open_starts[0]["tag"]
    assert "in-flight at EOF" in render_report(rep)


def test_watch_survives_sigkill_mid_level(tmp_path):
    """``watch`` renders a run in another process from its run dir alone,
    while it is wedged and after it is SIGKILLed, naming the dispatch
    in flight."""
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    live = []
    _wedged_child(run_dir, "run_dir",
                  lambda: live.append(ttel.render_watch(run_dir)))
    assert "in-flight" in live[0]
    frame = ttel.render_watch(run_dir)
    assert "engine device" in frame
    assert "depth" in frame and "rate" in frame
    assert "in-flight" in frame, frame
    assert ttel.watch_frame(run_dir)["in_flight"] is not None
    assert ttel.main(["watch", run_dir, "--once"]) == 0


# ------------------------------------------- level records against JAX

def _cases():
    pp = (lambda m: _pruned(m(2)), PP_KW)
    spill = (lambda m: _pruned(m(n_clients=3, w=4)),
             dict(chunk=16, max_depth=11, visited_cap=128,
                  frontier_cap=1 << 11, spill=True))
    flt = (lambda m: _pruned(m.paxos_partition_spec(3).compile()),
           dict(chunk=64, max_depth=6))
    return {"pingpong_device": (pp, (t_pp, j_pp), False),
            "pingpong_host": (pp, (t_pp, j_pp), True),
            "lab1_spill": (spill, (t_cs, j_cs), False),
            "fault_device": (flt, (tspecs, jspecs), False),
            "fault_host": (flt, (tspecs, jspecs), True)}


@pytest.mark.parametrize("name", list(_cases()))
def test_level_records_equal_jax(name):
    """Each loop's level records equal the JAX recorder's field for field
    (clock fields aside); the recorded events too (spill evictions,
    spools and reinjections)."""
    (make, kw), (tmod, jmod), host = _cases()[name]
    tt, jt = Telemetry(), jtel.Telemetry()
    out = teng.TensorSearch(make(tmod), telemetry=tt, device="cpu",
                            use_host_visited=host, **kw).run()
    ref = jeng.TensorSearch(make(jmod), telemetry=jt,
                            use_host_visited=host, **kw).run()
    assert (out.unique_states, out.states_explored) == \
        (ref.unique_states, ref.states_explored)
    assert _levels(tt) == _levels(jt)
    assert len(tt.levels) == out.depth - (
        host and out.end_condition == "SPACE_EXHAUSTED")
    if name.startswith("fault"):
        assert tt.levels[-1]["faults"]["partition_events"] > 0
    if name == "lab1_spill":
        assert all(set(lv["spill"]) == {"drain_wall", "drain_wait",
                                        "drain_overlap"}
                   for lv in tt.levels)

    def kinds(t):
        return [(e["kind"], {k: v for k, v in e.items()
                             if k not in ("t", "ts", "kind")})
                for e in t.events if e.get("t") == "event"]
    assert kinds(tt) == kinds(jt)


def test_swarm_round_records_keys_and_count():
    """Swarm rounds land one level record each with the JAX swarm's keys
    (one lane per per-device field: one card), the warm-up as a
    ``compile`` event, and the verdict as an outcome."""
    kw = dict(walkers_per_device=4, max_steps=8, steps_per_round=4,
              seed=0, visited_cap=1 << 10, max_rounds=2)
    tt, jt = Telemetry(), jtel.Telemetry()
    sw = tsw.SwarmSearch(_pruned(t_pp(2)), device="cpu", telemetry=tt, **kw)
    out = sw.run()
    jt.attach(jsw.SwarmSearch(_pruned(j_pp(2)), mesh=make_mesh(2),
                              **kw)).run()
    rounds = [r for r in tt.levels if r["engine"] == "swarm"]
    jrounds = [r for r in jt.levels if r["engine"] == "swarm"]
    assert len(rounds) == len(jrounds) == 2
    for r, j in zip(rounds, jrounds):
        assert set(r) == set(j)
        assert set(r["per_device"]) == set(j["per_device"])
        assert set(r["skew"]) == set(j["skew"])
        assert all(len(v) == 1 for v in r["per_device"].values())
    assert rounds[-1]["explored"] == out.states_explored
    ev = [e for e in tt.events if e.get("kind") == "compile"]
    assert len(ev) == 1 and ev[0]["engine"] == "swarm"
    assert [e["engine"] for e in tt.events if e.get("t") == "outcome"] \
        == ["swarm"]
    spans = _spans(tt)
    assert spans and {s["tag"] for s in spans} <= set(ttel.DISPATCH_SITES)


# ------------------------------------------------- STATUS.json / watch

def _status_keys(st):
    return set(st) - {"rung", "lane", "spill", "drain", "capacity",
                      "faults", "resilience", "lanes"}


def test_status_json_schema_and_watch_finished_run(tmp_path, capsys):
    """STATUS.json in the run dir (the reference's pinned keys, and the
    JAX recorder's key set on the same search), and ``watch`` rendering
    depth, rate, skew and the end from the dir alone."""
    ck = str(tmp_path / "port" / "search.ckpt")
    assert tck.run_dir_layout(ck)["status"] == \
        str(tmp_path / "port" / "STATUS.json")
    tel = Telemetry.for_checkpoint(ck)
    out = _port(telemetry=tel).run()
    tel.close()
    st = json.loads((tmp_path / "port" / "STATUS.json").read_text())
    for key in ("t", "pid", "updated", "uptime", "spans", "levels",
                "last_span", "in_flight", "flight_log", "engine",
                "depth", "explored", "unique", "rate_per_min",
                "rate_per_min_window", "skew", "per_device",
                "end_condition", "mesh_width", "trace_id",
                "parent_span", "span_id", "capacity", "skew_agg"):
        assert key in st, f"STATUS.json missing {key!r}"
    assert st["rate_per_min"] is not None
    assert st["rate_per_min_window"] is not None
    assert st["pid"] == os.getpid()
    assert st["engine"] == "device"
    assert st["depth"] == out.depth
    assert st["end_condition"] == out.end_condition
    assert st["in_flight"] is None
    assert st["mesh_width"] == 1
    assert len(st["per_device"]["explored"]) == 1

    jck = str(tmp_path / "jax" / "search.ckpt")
    jt = jtel.Telemetry.for_checkpoint(jck)
    jeng.TensorSearch(_pruned(j_pp(2)), telemetry=jt, **PP_KW).run()
    jt.close()
    jst = json.loads((tmp_path / "jax" / "STATUS.json").read_text())
    assert set(st) == set(jst)

    assert ttel.main(["watch", str(tmp_path / "port"), "--once"]) == 0
    text = capsys.readouterr().out
    assert f"depth {out.depth}" in text
    assert "rate" in text and "skew:" in text
    assert f"end: {out.end_condition}" in text
    assert ttel.main(["watch", str(tmp_path / "port"), "--json"]) == 0
    frame = json.loads(capsys.readouterr().out)
    assert frame["finished"] is True and frame["in_flight"] is None


# ------------------------------------------------- report --json schema

def test_report_json_schema_pin(tmp_path, capsys):
    """``report --json``: the reference's pinned keys, the JAX report's
    key set, and the per-device lanes on the series records."""
    flight = str(tmp_path / "flight.jsonl")
    tel = Telemetry(flight_log=flight)
    out = _port(telemetry=tel).run()
    tel.close()
    assert ttel.main(["report", flight, "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    for key in ("meta", "n_spans", "sites", "series", "timeline",
                "outcomes", "counts", "total_wall", "compile_wall",
                "in_flight", "source"):
        assert key in rep, f"report --json missing {key!r}"
    assert rep["source"] == flight
    assert rep["in_flight"] is None
    assert len(rep["series"]["device"]) == out.depth
    assert rep["series"]["device"][0]["per_device"]["explored"]
    assert rep["outcomes"][-1]["end_condition"] == out.end_condition

    jflight = str(tmp_path / "jax.flight.jsonl")
    jt = jtel.Telemetry(flight_log=jflight)
    jeng.TensorSearch(_pruned(j_pp(2)), telemetry=jt, **PP_KW).run()
    jt.close()
    assert jtel.main(["report", jflight, "--json"]) == 0
    jrep = json.loads(capsys.readouterr().out)
    assert set(rep) == set(jrep)
    assert set(rep["series"]["device"][0]) == \
        set(jrep["series"]["device"][0])
    assert set(rep["outcomes"][-1]) == set(jrep["outcomes"][-1])


# --------------------------------------------------- bench ledger diff

def _compare_both(ledger):
    out = ttel.compare_ledger(ttel.read_ledger(ledger))
    assert out == jtel.compare_ledger(jtel.read_ledger(ledger))
    assert ttel.render_compare(out, ledger) == \
        jtel.render_compare(out, ledger)
    return out


def test_ledger_compare_flags_injected_regression_and_parity(
        tmp_path, capsys):
    """``compare`` flags an injected slow run with its phase and delta
    and a parity run not at all, as the JAX compare does."""
    ledger = str(tmp_path / "BENCH_HISTORY.jsonl")
    base = {"t": "bench", "value": 4.0e6,
            "strict": {"value": 4.0e6, "unique": 1000},
            "swarm": {"value": 2.0e6}}
    ttel.append_ledger(ledger, base)
    ttel.append_ledger(ledger, {**base, "value": 3.9e6,
                                "strict": {"value": 3.8e6}})
    assert ttel.main(["compare", ledger]) == 0
    text = capsys.readouterr().out
    assert "parity: no phase regressed" in text
    assert "REGRESSION" not in text
    _compare_both(ledger)

    ttel.append_ledger(ledger, {**base, "value": 1.0e6,
                                "strict": {"value": 0.9e6}})
    assert ttel.main(["compare", ledger]) == 1
    assert "REGRESSION: phase=strict" in capsys.readouterr().out
    cmp = _compare_both(ledger)
    reg = {e["phase"]: e for e in cmp["regressions"]}
    assert "strict" in reg and "headline" in reg
    assert reg["strict"]["delta_pct"] < -25.0
    with open(ledger, "a") as f:
        f.write('{"t": "ben')
    assert _compare_both(ledger)["regressions"]


def test_ledger_compare_flags_headline_mesh_width_fallback(tmp_path):
    ledger = str(tmp_path / "BENCH_HISTORY.jsonl")
    ttel.append_ledger(ledger, {"t": "bench", "value": 4.0e6,
                                "mesh_width": 8, "mesh": {"value": 4.0e6}})
    ttel.append_ledger(ledger, {"t": "bench", "value": 6.0e6,
                                "mesh_width": 1, "mesh": {"value": 6.0e6}})
    reg = {e["phase"]: e for e in _compare_both(ledger)["regressions"]}
    assert reg["headline:mesh_width"]["latest"] == 1
    assert reg["headline:mesh_width"]["best_prior"] == 8
    ttel.append_ledger(ledger, {"t": "bench", "value": 7.0e6,
                                "mesh_width": 8, "mesh": {"value": 7.0e6}})
    cmp = _compare_both(ledger)
    assert not any(e["phase"] == "headline:mesh_width"
                   for e in cmp["regressions"])
    assert cmp["phases"]["mesh"]["latest"] == 7000000.0


def test_ledger_compare_every_guard_equals_jax(tmp_path):
    """Every guard of the compare (service, compile, lanes, capacity,
    memo, mesh, scenarios, labs, sanitizer, resilience) on a ledger that
    trips each, equal to the JAX compare."""
    ledger = str(tmp_path / "L.jsonl")
    good = {"t": "bench", "value": 5.0, "mesh_width": 8,
            "failovers": 0, "sanitizer": {"findings": 0},
            "strict": {"value": 5.0, "compile_secs": 10.0},
            "service": {"value": 3.0, "fairness_index": 1.0,
                        "cost_per_unique": 1e-4, "dispatches_per_job": 4,
                        "device_secs_saved": 2.0},
            "lanes": {"value": 2.0, "occupancy": 3.5},
            "capacity2": {"value": 1.0, "bytes_per_state": 800},
            "memo": {"value": 1.0, "hit_rate": 0.9},
            "mesh": {"value": 4.0, "imbalance_max": 1.1,
                     "wire": {"wire_bytes_per_state": 100}},
            "scenarios": {"value": 1.0, "verdict_parity": 1},
            "labs": {"value": 1.0, "bytes_per_state": 500}}
    bad = json.loads(json.dumps(good))
    bad.update(value=2.0, mesh_width=4, failovers=2,
               sanitizer={"findings": 3})
    bad["strict"]["compile_secs"] = 40.0
    bad["service"].update(fairness_index=2.0, cost_per_unique=9e-4,
                          dispatches_per_job=9, device_secs_saved=0.5)
    bad["lanes"]["occupancy"] = 1.0
    bad["capacity2"]["bytes_per_state"] = 1600
    bad["memo"]["hit_rate"] = 0.1
    bad["mesh"].update(imbalance_max=3.0,
                       wire={"wire_bytes_per_state": 400})
    bad["scenarios"]["verdict_parity"] = 0
    bad["labs"]["bytes_per_state"] = 900
    for rec in (good, bad):
        ttel.append_ledger(ledger, rec)
    cmp = _compare_both(ledger)
    assert len(cmp["regressions"]) >= 15


# ------------------------------------------------------------ report CLI

def test_report_cli_golden_sections(tmp_path, capsys):
    """The report from the log alone, on one device: the section
    headers, a one-cell heatmap row and a throughput row per level, the
    site table and the outcome."""
    tel = Telemetry(flight_log=str(tmp_path / "flight.jsonl"))
    out = _port(telemetry=tel).run()
    tel.close()
    assert ttel.main(["report", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    for header in ("== dslabs run report", "-- dispatch latency by site --",
                   "-- per-level throughput --",
                   "-- per-device skew (explored share per level) --",
                   "-- recovery timeline --",
                   "-- spill / overflow / recovery counts --"):
        assert header in text, f"missing section {header!r}"
    heat = [ln for ln in text.splitlines()
            if ln.startswith("d") and "|" in ln and "imb=" in ln]
    assert len(heat) == out.depth
    assert all(len(ln.split("|")[1]) == 1 for ln in heat)
    assert "device.step" in text and "[engine device]" in text
    assert f"outcome: {out.end_condition}" in text
    assert "p50ms" in text and "p99ms" in text and "states/s" in text
    lines = text.splitlines()
    i = lines.index("[engine device]")
    rows = [ln for ln in lines[i + 2:] if ln and ln[0] != "["
            and not ln.startswith("--")]
    assert len([r for r in rows if r.strip()
                and r.strip()[0].isdigit()]) == out.depth
    assert ttel.main(["sites"]) == 0
    assert "device.step" in capsys.readouterr().out


# ------------------------------------------- supervisor / event plumbing

def test_supervisor_retries_become_events_and_span_retries():
    tel = Telemetry()
    plan = tsup.FaultPlan().raise_at(2, engine="host")
    sup = tsup.SearchSupervisor(
        _pruned(t_pp(2)), ladder=("host",),
        policy=tsup.RetryPolicy(max_retries=2, backoff_base=0.001),
        fault_plan=plan, max_depth=8, chunk=64, frontier_cap=1 << 10,
        visited_cap=1 << 12, telemetry=tel, device="cpu")
    out = sup.run()
    assert out.end_condition == "SPACE_EXHAUSTED"
    assert out.retries >= 1
    ev = {r["kind"] for r in tel.events if r.get("t") == "event"}
    assert {"rung", "retry", "fault_inject"} <= ev
    assert tel.registry.counters["events.retry"].value >= 1
    assert sum(s["retries"] for s in _spans(tel)) == out.retries
    assert out.trace_id == tel.trace_id


def test_supervisor_failover_and_knob_shrink_events():
    """A fatal fault on the device rung is a ``failover`` event, a
    CUDA-OOM-shaped one a ``knobs_shrunk`` re-level; the rungs' engines
    all feed the one recorder."""
    tel = Telemetry()
    sup = tsup.SearchSupervisor(
        _pruned(t_pp(2)), ladder=("device", "host"),
        fault_plan=tsup.FaultPlan().raise_at(
            3, engine="device", error=torch.cuda.OutOfMemoryError,
            message="CUDA out of memory").raise_at(
            12, engine="device", error=RuntimeError, count=None),
        max_depth=8, chunk=64, frontier_cap=1 << 10, visited_cap=1 << 12,
        telemetry=tel, device="cpu")
    out = sup.run()
    assert out.engine == "host" and out.knob_retries == 1
    kinds = [r["kind"] for r in tel.events if r.get("t") == "event"]
    assert kinds.count("rung") == 3
    assert "knobs_shrunk" in kinds and "failover" in kinds
    assert {lv["engine"] for lv in tel.levels} == {"device", "host"}


def test_profiler_window_by_argument(tmp_path):
    """``profile_dir`` / ``profile_steps`` open a ``torch.profiler``
    window after each hot site's first dispatch and export a Chrome
    trace; the search is unaffected, and ``close()`` closes a window
    still open."""
    prof = tmp_path / "prof"
    tel = Telemetry(profile_dir=str(prof), profile_steps=2)
    out = _port(telemetry=tel).run()
    assert out.end_condition == "SPACE_EXHAUSTED"
    assert not tel.profile.active and tel.profile.error is None
    trace = json.loads(open(tel.profile.trace_path).read())
    assert trace["traceEvents"]
    assert os.path.dirname(tel.profile.trace_path) == str(prof)
    # A window longer than the run stays open until close().
    tel2 = Telemetry(profile_dir=str(tmp_path / "p2"), profile_steps=10 ** 6)
    _port(telemetry=tel2).run()
    assert tel2.profile.active
    tel2.close()
    assert not tel2.profile.active and os.path.exists(
        tel2.profile.trace_path)
    # Off by default.
    assert Telemetry().profile.done


def test_telemetry_options_build_everywhere():
    """``telemetry=`` no longer raises on any entry point."""
    tel = Telemetry()
    assert teng.TensorSearch(t_pp(2), telemetry=tel,
                             device="cpu")._telemetry is tel
    assert tsw.SwarmSearch(t_pp(2), telemetry=tel,
                           device="cpu")._telemetry is tel
    assert tsup.DispatchBoundary(telemetry=tel).telemetry is tel
    assert tsup.SearchSupervisor(t_pp(2), telemetry=tel,
                                 device="cpu").telemetry is tel
    from dslabs_tpu_torch.tpu.warden import Warden

    assert Warden("m:f", telemetry=tel, device="cpu").telemetry is tel
    assert ttel.device_memory_stats([torch.device("cpu")]) is None


def test_recorder_threads_lose_no_record(tmp_path):
    """Portfolio lanes, the spill drain worker and an abandoned watchdog
    thread emit into one recorder: under many threads and a short switch
    interval no dispatch index repeats, no record is lost and every
    flight-log line parses; a span closing after ``close()`` raises
    nothing."""
    import threading

    tel = Telemetry(flight_log=str(tmp_path / "flight.jsonl"))
    n_threads, n_calls = 16, 50

    class Search:
        _current_depth = 3
        _dispatch_boundary = None

    gate = threading.Event()
    late = []

    def work(k):
        for j in range(n_calls):
            tel.record_dispatch(Search(), "device.sync", None,
                                lambda: None)
            tel.event("heartbeat", n=j, lane=k)
        if k == 0:
            late.append(threading.Thread(target=lambda: (
                gate.wait(10), tel.record_dispatch(
                    Search(), "device.step", None, lambda: None))))
            late[0].start()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    tel.close()
    gate.set()
    late[0].join(timeout=10)
    assert not late[0].is_alive()
    recs = read_flight(str(tmp_path / "flight.jsonl"))
    spans = [r for r in recs if r["t"] == "span"]
    total = n_threads * n_calls
    assert len(spans) == total
    assert sorted(s["i"] for s in spans) == list(range(total))
    assert len([r for r in recs if r["t"] == "event"]) == total
    assert tel.registry.counters["events.heartbeat"].value == total
    assert tel.summary()["spans"] == total + 1
