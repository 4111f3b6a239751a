"""PyTorch port, causal tracing and cost accounting
(``dslabs_tpu_torch/tpu/tracing.py``), on the CPU.

The single-run cases of ``tests/test_tracing.py`` run on the port: trace
and span ids and their environment pair; the torn-line-tolerant reader
and per-child segmentation; the tolerant JSON reader; spans, outcome and
STATUS.json carrying the trace, and the run-dir ``trace`` CLI; the cost
meter; the compare's compile-creep and cost guards, equal to the JAX
compare.  The port's own cases: a traced warden child with a run-dir
recorder, SIGKILLed after a dump and resumed by the next rung's child,
whose run dir assembles into one tree naming the dead child's in-flight
dispatch (and which ``watch``, ``report`` and ``trace`` read); and
``assemble`` on an empty service root.  The service trace chain (submit,
queue, admission, attempts, the shared spans of a lane batch) and the
per-tenant ledger of a service root are held by
``tests/test_torch_service.py`` and ``tests/test_torch_lanes.py``."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)

from dslabs_tpu.tpu import telemetry as jtel  # noqa: E402
from dslabs_tpu.tpu import tracing as jtracing  # noqa: E402
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.tpu import telemetry as tel_mod  # noqa: E402
from dslabs_tpu_torch.tpu import tracing  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.pingpong import \
    make_pingpong_protocol  # noqa: E402
from dslabs_tpu_torch.tpu.warden import Warden  # noqa: E402

pytestmark = pytest.mark.trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pruned_pingpong():
    pp = make_pingpong_protocol(workload_size=2)
    return dataclasses.replace(pp, goals={}, prunes=dict(pp.goals))


# ------------------------------------------------------------- id basics

def test_trace_ids_and_env_roundtrip(monkeypatch):
    a, b = tracing.mint_trace_id(), tracing.mint_trace_id()
    assert a != b and len(a) == 16 and len(tracing.new_span_id()) == 8
    assert tracing.attempt_span_id("t-000001", 2) == "t-000001:a2"
    env = tracing.child_trace_env(a, "t-000001:a2")
    assert env == {tracing.TRACE_ENV: a, tracing.PARENT_ENV: "t-000001:a2"}
    # The cross-process contract is the reference's environment pair.
    assert (tracing.TRACE_ENV, tracing.PARENT_ENV) == \
        (jtracing.TRACE_ENV, jtracing.PARENT_ENV)
    monkeypatch.setenv(tracing.TRACE_ENV, a)
    monkeypatch.setenv(tracing.PARENT_ENV, "t-000001:a2")
    assert tracing.current_trace() == (a, "t-000001:a2")
    # The warden forwards the inherited pair to its children.
    w = Warden("m:f", device="cpu")
    assert (w.trace_id, w.parent_span) == (a, "t-000001:a2")
    child = w._child_env(w._spec("device", False))
    assert child[tracing.TRACE_ENV] == a
    monkeypatch.delenv(tracing.TRACE_ENV)
    monkeypatch.delenv(tracing.PARENT_ENV)
    assert tracing.current_trace() == (None, None)


def test_read_flight_lax_and_segmentation(tmp_path):
    """A flight log shared by a warden run's children: a torn line mid
    file is skipped and counted, and in-flight detection is per child
    (dispatch indices restart in every child)."""
    p = tmp_path / "flight.jsonl"
    lines = [
        {"t": "meta", "started": 100.0, "span_id": "s1",
         "parent_span": "j:a1", "trace_id": "abc"},
        {"t": "dispatch", "ts": 0.1, "tag": "device.step", "i": 0},
        {"t": "span", "ts": 0.2, "tag": "device.step", "i": 0,
         "wall": 0.1},
        {"t": "dispatch", "ts": 0.3, "tag": "device.step", "i": 1},
    ]
    body = "\n".join(json.dumps(r) for r in lines)
    body += "\n" + '{"t": "span", "ts": 0.35, "tag":'
    lines2 = [
        {"t": "meta", "started": 110.0, "span_id": "s2",
         "parent_span": "j:a1", "trace_id": "abc"},
        {"t": "dispatch", "ts": 0.1, "tag": "host.expand", "i": 0},
        {"t": "span", "ts": 0.2, "tag": "host.expand", "i": 0,
         "wall": 0.1},
    ]
    body += "\n" + "\n".join(json.dumps(r) for r in lines2) + "\n"
    p.write_text(body)
    recs, torn = tracing.read_flight_lax(str(p))
    assert torn == 1 and len(recs) == 7
    assert (recs, torn) == jtracing.read_flight_lax(str(p))
    segs = tracing.segment_flight(recs)
    assert len(segs) == 2
    assert segs[0]["in_flight"]["i"] == 1
    assert segs[0]["in_flight"]["tag"] == "device.step"
    assert segs[1]["in_flight"] is None
    assert segs == jtracing.segment_flight(recs)
    assert tracing.read_flight_lax(str(tmp_path / "none.jsonl")) == ([], 0)


def test_load_json_tolerant_mid_write(tmp_path):
    p = tmp_path / "SERVER_STATUS.json"
    p.write_text('{"t": "server_status", "queue_de')
    assert tracing.load_json_tolerant(str(p)) is None
    p.write_text(json.dumps({"t": "server_status", "queue_depth": 0}))
    assert tracing.load_json_tolerant(str(p))["queue_depth"] == 0
    assert tracing.load_json_tolerant(str(tmp_path / "nope.json")) is None
    assert tracing.load_json_tolerant(None) is None


# ------------------------------------------------ recorder integration

def test_spans_and_status_carry_trace_and_run_dir_trace_cli(
        tmp_path, monkeypatch, capsys):
    """A recorder in a traced process stamps the trace into its meta
    record, every span, the outcome and STATUS.json; ``trace <run-dir>``
    assembles the run's causal tree from the flight log alone."""
    trace = tracing.mint_trace_id()
    monkeypatch.setenv(tracing.TRACE_ENV, trace)
    monkeypatch.setenv(tracing.PARENT_ENV, "job-1:a1")
    tel = tel_mod.Telemetry.for_checkpoint(
        str(tmp_path / "search.ckpt"), engine_hint="trace-test")
    assert tel.trace_id == trace and tel.parent_span == "job-1:a1"
    search = teng.TensorSearch(_pruned_pingpong(), max_depth=8,
                               frontier_cap=1 << 10, visited_cap=1 << 12,
                               chunk=64, telemetry=tel, device="cpu")
    out = search.run()
    tel.close()
    assert out.trace_id == trace

    recs = tel_mod.read_flight(str(tmp_path / "flight.jsonl"))
    meta = recs[0]
    assert meta["t"] == "meta" and meta["trace_id"] == trace
    assert meta["parent_span"] == "job-1:a1"
    spans = [r for r in recs if r["t"] == "span"]
    assert spans and all(s.get("trace") == trace for s in spans)
    assert [r for r in recs if r["t"] == "outcome"][-1]["trace"] == trace

    st = json.loads((tmp_path / "STATUS.json").read_text())
    assert (st["trace_id"], st["parent_span"], st["span_id"]) == \
        (trace, "job-1:a1", tel.span_id)
    assert st["rate_per_min"] is not None
    assert st["rate_per_min_window"] is not None
    frame = tel_mod.watch_frame(str(tmp_path))
    assert frame["trace_id"] == trace
    assert frame["finished"] is True and frame["in_flight"] is None
    assert isinstance(frame["stale"], bool)

    assert tel_mod.main(["trace", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    assert "== dslabs causal trace" in text and trace in text
    tr = tracing.assemble(str(tmp_path))
    j = tr["jobs"][0]
    assert j["trace_id"] == trace
    ids = {n["span_id"] for n in j["nodes"]}
    assert len(ids) == len(j["nodes"])
    assert all(n["parent"] is None or n["parent"] in ids
               for n in j["nodes"])
    assert j["phases"]["search_secs"] > 0
    # The JAX assembler reads the port's run dir into the same tree shape.
    jtr = jtracing.assemble(str(tmp_path))
    assert {n["kind"] for n in jtr["jobs"][0]["nodes"]} == \
        {n["kind"] for n in j["nodes"]}
    pf = tracing.to_perfetto(tr)
    assert any(e.get("ph") == "X" for e in pf["traceEvents"])
    assert tel_mod.main(["trace", str(tmp_path), "--json", "--perfetto",
                         str(tmp_path / "pf.json")]) == 0
    assert json.loads(capsys.readouterr().out)["mode"] == "run"
    assert json.loads((tmp_path / "pf.json").read_text())["traceEvents"]


# ------------------------------------- a traced warden child, killed

CHILD_ENV = {"OMP_NUM_THREADS": "1"}
PINGPONG = {
    "factory": "dslabs_tpu_torch.tpu.protocols.pingpong:"
               "make_pingpong_protocol",
    "factory_kwargs": {"workload_size": 2},
    "transform": "tests.torch_harness_cases:pruned_without_jax",
}


def test_traced_warden_child_killed_run_dir_trace(tmp_path, monkeypatch,
                                                  capsys):
    """A traced warden ladder whose first child SIGKILLs itself after a
    durable dump: each checkpointed child records into the run dir, the
    successor appends its own segment and lands the straight run's
    verdict; the flight log keeps the dead child's open ``device.*``
    dispatch, ``watch`` names it, ``assemble`` gives both children under
    the trace with every parent in the tree, the parent's recorder holds
    the heartbeats and the death, and the CLIs exit 0."""
    trace = tracing.mint_trace_id()
    monkeypatch.setenv(tracing.TRACE_ENV, trace)
    run_dir = tmp_path / "run"
    parent = tel_mod.Telemetry()
    w = Warden(**PINGPONG, ladder=("device", "host"),
               checkpoint_path=str(run_dir / "pp.npz"), checkpoint_every=1,
               chunk=64, frontier_cap=1 << 8, visited_cap=1 << 12,
               env=CHILD_ENV, device="cpu", telemetry=parent,
               fault={"kind": "die", "at": 8, "engine": "device",
                      "after_ckpt": True})
    out = w.run()
    straight = teng.TensorSearch(_pruned_pingpong(), chunk=64,
                                 device="cpu").run()
    assert (out.end_condition, out.unique_states, out.states_explored) == \
        (straight.end_condition, straight.unique_states,
         straight.states_explored)
    assert out.child_restarts == 1 and out.trace_id == trace
    kinds = [e["kind"] for e in parent.events if e.get("t") == "event"]
    assert "heartbeat" in kinds and kinds.count("child_death") == 1

    recs, _torn = tracing.read_flight_lax(str(run_dir / "flight.jsonl"))
    segs = tracing.segment_flight(recs)
    assert len(segs) == 2
    assert all(s["meta"]["trace_id"] == trace for s in segs)
    assert [s["meta"]["hint"] for s in segs] == \
        ["warden-child:device", "warden-child:host"]
    dead = segs[0]["in_flight"]
    assert dead is not None and dead["tag"].startswith("device.")
    assert segs[1]["in_flight"] is None
    assert "in-flight" in tel_mod.render_watch(str(run_dir))
    assert tel_mod.watch_frame(str(run_dir))["finished"] is True

    tr = tracing.assemble(str(run_dir))
    j = tr["jobs"][0]
    assert j["trace_id"] == trace
    nodes = {n["span_id"]: n for n in j["nodes"]}
    assert all(n["parent"] is None or n["parent"] in nodes
               for n in j["nodes"])
    runs = [n for n in j["nodes"] if n["kind"] == "run"]
    assert len(runs) == 2
    inflight = [n for n in j["nodes"] if n["kind"] == "in_flight"]
    assert len(inflight) == 1 and inflight[0]["tag"] == dead["tag"]
    assert nodes[inflight[0]["parent"]]["span_id"] == \
        segs[0]["meta"]["span_id"]
    assert "!! in-flight" in tracing.render_trace(tr)
    for cmd in ("report", "trace"):
        rc = subprocess.run(
            [sys.executable, "-m", "dslabs_tpu_torch.tpu.telemetry", cmd,
             str(run_dir)], capture_output=True, text=True, cwd=ROOT,
            env=dict(os.environ, **CHILD_ENV), timeout=120)
        assert rc.returncode == 0, rc.stderr[-2000:]


def test_assemble_service_root_raises(tmp_path):
    """A service root assembles through the service's journal replay
    (it raised before the service was ported): an empty journal is a
    service trace with no jobs, as the reference's is."""
    (tmp_path / "journal.jsonl").write_text("")
    tr = tracing.assemble(str(tmp_path))
    assert (tr["mode"], tr["jobs"], tr["costs"]) == ("service", [], {})
    ref = jtracing.assemble(str(tmp_path))
    assert (ref["mode"], ref["jobs"]) == (tr["mode"], tr["jobs"])
    assert "(no jobs found)" in tracing.render_trace(tr)


# --------------------------------------------------- cost meter units

def test_cost_meter_replays_ledger_and_flight_costs(tmp_path):
    flight = tmp_path / "flight.jsonl"
    recs = [
        {"t": "meta", "started": 100.0},
        {"t": "span", "ts": 0.1, "tag": "device.init", "i": 0,
         "wall": 1.0, "retries": 0},
        {"t": "span", "ts": 0.3, "tag": "device.step", "i": 1,
         "wall": 0.5, "retries": 1},
        {"t": "span", "ts": 0.6, "tag": "device.step", "i": 2,
         "wall": 0.25, "retries": 0},
        {"t": "level", "ts": 0.7, "depth": 1, "wall": 0.6},
        {"t": "outcome", "ts": 0.8, "compile_secs": 2.0},
    ]
    flight.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    fc = tracing.CostMeter.flight_costs(str(flight))
    assert fc["device_secs"] == 1.75
    assert fc["device_secs_by_site"] == {"device.init": 1.0,
                                         "device.step": 0.75}
    assert fc["dispatches"] == 3 and fc["retries"] == 1
    assert fc["compile_secs"] == 3.5
    assert fc["search_secs"] == 0.25
    assert fc["levels"] == 1
    assert fc == jtracing.CostMeter.flight_costs(str(flight))

    path = str(tmp_path / "COSTS.jsonl")
    m = tracing.CostMeter(path)
    m.charge({"job_id": "a-1", "tenant": "a", "status": "done",
              "unique": 10, "explored": 20, "budget_units": 2.0},
             str(flight))
    m.charge({"job_id": "a-2", "tenant": "a", "status": "failed",
              "unique": 0, "explored": 0})
    m.close()
    m2 = tracing.CostMeter(path)
    per = m2.tenant_summary()
    assert per["a"]["jobs"] == 2 and per["a"]["completed"] == 1
    assert per["a"]["unique"] == 10 and per["a"]["explored"] == 20
    assert per["a"]["cost_per_unique"] == round(1.75 / 10, 9)
    tot = m2.totals()
    assert tot["device_secs"] == 1.75 and tot["unique"] == 10
    m2.close()
    jm = jtracing.CostMeter(path)
    assert jm.tenant_summary() == per and jm.totals() == tot
    jm.close()


# ------------------------------------------- ledger compare satellites

def test_compare_flags_compile_creep_and_cost_regression(tmp_path):
    def both(ledger):
        cmp = tel_mod.compare_ledger(tel_mod.read_ledger(ledger))
        assert cmp == jtel.compare_ledger(jtel.read_ledger(ledger))
        return cmp

    ledger = str(tmp_path / "BENCH_HISTORY.jsonl")
    base = {"t": "bench", "value": 4.0e6,
            "strict": {"value": 4.0e6, "compile_secs": 10.0},
            "service": {"value": 12.0, "fairness_index": 1.0,
                        "cost_per_unique": 1.0e-4}}
    tel_mod.append_ledger(ledger, base)
    tel_mod.append_ledger(ledger, {**base,
                                   "strict": {"value": 3.9e6,
                                              "compile_secs": 10.5},
                                   "service": {"value": 12.0,
                                               "cost_per_unique": 1.05e-4}})
    cmp = both(ledger)
    assert not cmp["regressions"]
    assert cmp["compile"]["strict"]["latest"] == 10.5
    tel_mod.append_ledger(ledger, {**base,
                                   "strict": {"value": 4.0e6,
                                              "compile_secs": 30.0},
                                   "service": {"value": 12.0,
                                               "cost_per_unique": 5.0e-4}})
    reg = {e["phase"] for e in both(ledger)["regressions"]}
    assert "compile:strict" in reg
    assert "service:cost_per_unique" in reg
    ledger2 = str(tmp_path / "L2.jsonl")
    tel_mod.append_ledger(ledger2, {"t": "bench", "value": 1.0,
                                    "strict": {"value": 1.0,
                                               "compile_secs": 0.2}})
    tel_mod.append_ledger(ledger2, {"t": "bench", "value": 1.0,
                                    "strict": {"value": 1.0,
                                               "compile_secs": 0.8}})
    assert not any(e["phase"].startswith("compile:")
                   for e in both(ledger2)["regressions"])
