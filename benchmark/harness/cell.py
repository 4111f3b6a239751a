"""One run of a cell: set-up, the measured window, the check.

Set-up builds the configuration's twin through the port's factory and
the engine the traffic names, lists the run's roots in an order drawn
from the seed, makes the port's root states from them and warms the
engine up with one shallow search from the first root.  The window then
runs whole searches back to back, one at a time (a closed loop: a
checking job waits for its verdict), in rounds of every root once, and
starts a new round only while fewer than ``seconds`` have passed.
Afterwards the port's state is freed and the plain reference searches a
sample of the window's roots, drawn from the seed, for the comparison
that decides ``correct``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import time
from typing import Optional

import numpy as np

from harness import check as check_mod
from harness import trace as trace_mod
from harness.manifest import Cell, read_metrics

GIB = float(1 << 30)


def _import(path: str):
    mod, _, attr = path.partition(":")
    return getattr(importlib.import_module(mod), attr)


def build_protocol(config: dict):
    """The configuration's twin through the port's own factory."""
    prog = config["program"]
    p = _import(prog["factory"])(**config["sizes"])
    if hasattr(p, "compile"):
        p = p.compile()
    if prog.get("strip_goals"):
        p = dataclasses.replace(p, goals={})
    return p


def build_reference(config: dict, device, key_bits: Optional[int] = None,
                    block_pairs: Optional[int] = None):
    """The configuration's plain reference search (``reference/``)."""
    from reference.bfs import Partition, ReferenceSearch

    ref = config["reference"]
    twin = _import(ref["twin"])(**config["sizes"])
    if ref.get("strip_goals"):
        twin = dataclasses.replace(twin, goals={})
    part = ref.get("partition")
    part = (Partition(blocks=part["blocks"], max_eras=part["max_eras"])
            if part else None)
    kw = {} if block_pairs is None else {"block_pairs": block_pairs}
    return ReferenceSearch(twin, part, device=device, key_bits=key_bits,
                           **kw)


def draw_walks(walker, seed: int, traffic: dict) -> list:
    """The run's roots as walks of events from the initial state: every
    distinct state within ``roots.within`` events of it (the first walk,
    in the reference's canonical event order, that reaches it), in an
    order drawn from the seed.  Every seed searches the same roots, so
    the same work, in another order."""
    within = int(traffic["roots"]["within"])
    st0 = walker.initial()
    seen = set(walker.state_keys(st0))
    walks, frontier = [[]], [([], st0)]
    for _ in range(within):
        nxt = []
        for evs, st in frontier:
            for ev in walker.events(st):
                s2 = walker.apply(st, ev)
                k = walker.state_keys(s2)[0]
                if k not in seen:
                    seen.add(k)
                    walks.append(evs + [ev])
                    nxt.append((evs + [ev], s2))
        frontier = nxt
    rng = np.random.Generator(np.random.PCG64(seed))
    return [walks[int(i)] for i in rng.permutation(len(walks))]


def _event_id(ts, row, ev) -> int:
    import torch

    p = ts.p
    if ev[0] == "msg":
        net = ts.unflatten_rows(row[None])["net"][0]
        rec = torch.as_tensor(ev[1], dtype=net.dtype, device=net.device)
        hit = torch.nonzero(torch.all(net == rec, dim=1)).squeeze(1)
        if hit.numel() != 1:
            raise RuntimeError(f"root walk: message {ev[1]} not in the "
                               "port's network")
        return int(hit[0])
    if ev[0] == "timer":
        return p.net_cap + ev[1] * p.timer_cap + ev[2]
    fl = p.fault
    seg = {"CUT": fl.seg_cut, "HEAL": fl.seg_heal}[ev[1]]
    return p.net_cap + p.n_nodes * p.timer_cap + seg


def program_roots(ts, walks: list) -> list:
    """The port's root states: its initial state advanced by each walk
    through its own step, one batched step per walk position."""
    import torch

    from dslabs_tpu_torch.tpu.engine import flatten_state

    row0 = flatten_state(ts.initial_state())
    rows = row0.repeat(len(walks), 1)
    for pos in range(max(len(w) for w in walks)):
        live = [i for i, w in enumerate(walks) if len(w) > pos]
        ids = torch.as_tensor([_event_id(ts, rows[i], walks[i][pos])
                               for i in live], device=rows.device)
        sel = torch.as_tensor(live, device=rows.device)
        succ, ok, over = ts._step_batch(rows[sel], ids)
        if not bool(ok.all()) or bool((over != 0).any()):
            raise RuntimeError(f"root walk: an event at position {pos} "
                               "was not enabled")
        rows[sel] = succ
    return [ts.unflatten_rows(rows[i:i + 1]) for i in range(len(walks))]


def build_engine(proto, traffic: dict, target):
    """The engine the traffic names over ``target``: a device (a mesh of
    ``mesh_width`` shards on it) or a RankMesh (inside its ranks)."""
    if traffic["engine"] not in ("sharded", "ranks"):
        raise ValueError(f"unknown engine {traffic['engine']!r}")
    from dslabs_tpu_torch.tpu.sharded import ShardedTensorSearch, make_mesh

    mesh = (target if hasattr(target, "devices")
            else make_mesh(traffic["mesh_width"], device=target))
    return ShardedTensorSearch(
        proto, mesh, chunk_per_device=traffic["chunk_per_device"],
        frontier_cap=traffic["frontier_cap"],
        visited_cap=traffic["visited_cap"],
        max_depth=traffic["max_depth"], strict=True)


def setup_engine(config: dict, traffic: dict, walks: list, target, dev):
    """Set-up after the walks: the twin, the engine, the port's roots and
    one shallow warm-up search from the first root -> (engine, roots,
    marks)."""
    marks = [("start", time.time())]
    ts = build_engine(build_protocol(config), traffic, target)
    marks.append(("engine", time.time()))
    roots = program_roots(ts, walks)
    marks.append(("roots", time.time()))
    depth = ts.max_depth
    ts.max_depth = traffic["warmup_depth"]
    ts.run(initial=roots[0])
    ts.max_depth = depth
    dev.sync()
    marks.append(("warmup", time.time()))
    return ts, roots, marks


class _Device:
    """The few device calls the run makes, which are no-ops on the CPU
    (the tests drive the whole run there)."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = str(device).startswith("cuda")

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return (self.torch.cuda.max_memory_allocated() if self.cuda
                else 0)

    def free(self):
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()

    def sm_count(self) -> Optional[int]:
        if not self.cuda:
            return None
        cur = self.torch.cuda.current_device()
        return self.torch.cuda.get_device_properties(
            cur).multi_processor_count


def _profiled(torch, dev: "_Device", ts, root, spans):
    """One search under torch.profiler with the seam's spans on ->
    (outcome, chunk steps, device record with the exchange's bytes)."""
    acts = [torch.profiler.ProfilerActivity.CUDA] if dev.cuda else [
        torch.profiler.ProfilerActivity.CPU]
    dev.sync()
    steps0 = ts.chunk_steps
    x0 = getattr(ts.exchange, "bytes_sent", 0)
    with torch.profiler.profile(activities=acts) as prof:
        spans.on = True
        w0 = time.monotonic_ns()
        o = ts.run(initial=root)
        dev.sync()
        w1 = time.monotonic_ns()
        spans.on = False
        time.sleep(trace_mod.SETTLE_SECS)
    events = trace_mod.device_events(torch, prof)
    devrec = trace_mod.reduce(events, spans, (w0, w1), (w1 - w0) / 1e9)
    devrec["exchange_bytes"] = getattr(ts.exchange, "bytes_sent", 0) - x0
    return o, ts.chunk_steps - steps0, devrec


def answer(o) -> dict:
    """A search's answer as plain data (what the check and the readers
    take)."""
    return {"end_condition": o.end_condition, "depth": o.depth,
            "unique_states": o.unique_states,
            "states_explored": o.states_explored,
            "levels": [{k: lv[k] for k in ("depth", "explored", "unique",
                                           "next_frontier", "per_device")
                        if k in lv} for lv in (o.levels or [])]}


def run_window(ts, roots, seconds: float, trace: bool, dev, spans,
               agree=None, catch: bool = True) -> dict:
    """Whole rounds of searches, one at a time, each round every root
    once in the seed's order, a round started while fewer than
    ``seconds`` have passed (``agree``: rank 0's clock decides for every
    rank).  Every run thus holds the same work, whatever the seed and
    however fast the searches are.  With ``trace`` the second search
    runs under the profiler.  A failed search ends the window
    (``catch``) or raises."""
    import torch

    agree = agree or (lambda flag: flag)
    out = {"searches": [], "times": [], "errors": [], "attempted": 0,
           "traced": None}
    if trace:
        ts._dispatch_hook = spans.hook
    dev.reset_peak()
    t0 = time.perf_counter()
    while not out["errors"] and agree(time.perf_counter() - t0 < seconds):
        for i in range(len(roots)):
            out["attempted"] += 1
            t_s = time.perf_counter()
            try:
                if trace and out["attempted"] == min(2, len(roots)):
                    o, steps, devrec = _profiled(torch, dev, ts, roots[i],
                                                 spans)
                    out["traced"] = {"answer": answer(o), "steps": steps,
                                     "device": devrec}
                else:
                    o = ts.run(initial=roots[i])
            except Exception as e:  # counted as failed, the window ends
                if not catch:
                    raise
                out["errors"].append(f"{type(e).__name__}: {e}")
                break
            out["searches"].append([i, answer(o)])
            out["times"].append([i, o.unique_states,
                                 time.perf_counter() - t_s])
    dev.sync()
    out["wall"] = time.perf_counter() - t0
    out["peak"] = dev.peak()
    out["sm_count"] = dev.sm_count()
    out["shape"] = {"width": ts.n_devices, "cpd": ts.cpd,
                    "lanes": ts.lanes, "plane": ts.plane,
                    "events": ts._num_events()}
    return out


def layer_record(name: str, engine: str, win: dict) -> dict:
    """What the per-layer readers take from the traced search."""
    tr, sh = win["traced"], win["shape"]
    a = tr["answer"]
    levels = a["levels"]
    frontier = [sum(lv["per_device"]["frontier"]) if "per_device" in lv
                else lv["next_frontier"] for lv in levels[:-1]]
    return {
        "cell": name,
        "engine": engine,
        "width": sh["width"],
        "rows_per_chunk_step": sh["cpd"] * sh["width"],
        "chunk_steps": tr["steps"],
        "states_expanded": 1 + sum(frontier),
        "explored": a["states_explored"],
        "unique": a["unique_states"],
        "lanes": sh["lanes"],
        "plane_words": sh["plane"],
        "events_per_state": sh["events"],
        "sm_count": win["sm_count"],
        "levels": levels,
        "exchange_bytes": tr["device"].get("exchange_bytes", 0),
        "device": tr["device"],
    }


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None) -> dict:
    """One whole run -> the result line's object (its ``checks`` last)."""
    import torch

    t_start = time.time() if t_start is None else t_start
    dev = _Device(torch, device)
    tr = cell.traffic
    walks = draw_walks(build_reference(cell.config, "cpu"), seed, tr)
    if tr["engine"] == "ranks":
        from harness import rankwindow

        win, setup_end, marks = rankwindow.run_ranks(cell, walks, seconds,
                                                     trace, device)
        setup_s = setup_end - t_start
    else:
        ts, roots, marks = setup_engine(cell.config, tr, walks, device, dev)
        setup_s = time.time() - t_start
        win = run_window(ts, roots, seconds, trace, dev, trace_mod.Spans())
        del ts, roots
    dev.free()

    metrics, devinfo = {}, {}
    if not trace:
        done = sum(a["unique_states"] for _i, a in win["searches"])
        vals = {"unique_per_s": done / win["wall"],
                "peak_mem_gib": win["peak"] / GIB, "setup_s": setup_s}
        metrics = {m.name: {"value": vals[m.name], "unit": m.unit}
                   for m in cell.end_to_end if m.name in vals}
    elif win["traced"] is not None:
        rec = layer_record(cell.name, tr["engine"], win)
        metrics = read_metrics(cell.per_layer, rec)
        d = win["traced"]["device"]
        devinfo = {"busy_s": d.get("busy_s_mean", d["busy_s"]),
                   "window_s": d["window_s"]}

    # ---- the check, with the port's state freed
    ref = build_reference(cell.config, device,
                          block_pairs=tr["check"]["block_pairs"])
    errors = list(win["errors"])
    searches = [(i, check_mod.Answer.of(a)) for i, a in win["searches"]]
    checks, checked, ref_s = check_mod.check_window(ref, walks, searches,
                                                    seed, tr, errors)
    out = {"correct": check_mod.passed(checks) and not errors,
           "attempted": win["attempted"],
           "failed": len(win["errors"]), "metrics": metrics,
           "device": dict({"platform": "gpu" if dev.cuda else "cpu",
                           "kind": (torch.cuda.get_device_name(0)
                                    if dev.cuda else "cpu"),
                           "count": cell.chips,
                           "memory_peak_bytes": win["peak"]}, **devinfo)}
    if win["traced"] is not None:
        d = win["traced"]["device"]
        out["breakdown"] = {"device_ops": d["device_ops"],
                            "idle_gaps": d["idle_gaps"]}
    out["run"] = {"searches": win["times"], "window_s": win["wall"],
                  "roots_checked": checked, "reference_s": ref_s,
                  "errors": errors[:3],
                  "setup": [[k, round(t - marks[0][1], 3)]
                            for k, t in marks[1:]]}
    out["checks"] = checks
    return out
