"""The ``ranks`` engine: one process per card of a RankMesh, started
once by the port's launcher (``dslabs_tpu_torch.tpu.ranks.launch``) with
one ``call`` job that runs the whole of set-up and the window inside
every rank (:func:`rank_window`), so no rank starts inside the window.
Rank 0's clock decides for every rank when the window ends; each rank
reports its searches, its peak memory and, in a traced run, its own
trace of the profiled search.  The result is rank 0's window (its
answers are the mesh's, which every rank holds alike) with the highest
rank's peak and the mesh's kernel time and exchange bytes."""

from __future__ import annotations

import os
import time

from harness import cell as cell_mod
from harness import trace as trace_mod
from harness.manifest import BENCH_DIR, ROOT


def rank_window(exchange, config: dict, traffic: dict, walks: list,
                seconds: float, trace: bool, prepare=None) -> dict:
    """Set-up and the window in one rank (the launcher's ``call`` job)."""
    import torch

    if prepare:
        cell_mod._import(prepare)()
    dev = cell_mod._Device(torch, exchange.device)
    ts, roots, marks = cell_mod.setup_engine(config, traffic, walks,
                                             exchange.mesh, dev)
    ts.exchange.agree(True)
    setup_end = time.time()
    win = cell_mod.run_window(ts, roots, seconds, trace, dev,
                              trace_mod.Spans(), agree=ts.exchange.agree,
                              catch=False)
    win["setup_end"] = setup_end
    win["marks"] = marks
    return win


def run_ranks(cell, walks: list, seconds: float, trace: bool, device):
    """-> (rank 0's window merged over the ranks, rank 0's set-up end,
    rank 0's set-up marks)."""
    from dslabs_tpu_torch.tpu.mesh_exchange import RankMesh
    from dslabs_tpu_torch.tpu.ranks import launch

    tr = cell.traffic
    width = int(tr["mesh_width"])
    if str(device).startswith("cuda"):
        mesh = RankMesh([f"cuda:{r}" for r in range(width)], "nccl")
    else:
        mesh = RankMesh(["cpu"] * width, "gloo")
    path = [ROOT, BENCH_DIR] + ([os.environ["PYTHONPATH"]]
                                if os.environ.get("PYTHONPATH") else [])
    job = {"kind": "call", "fn": "harness.rankwindow:rank_window",
           "kwargs": {"config": cell.config, "traffic": tr,
                      "walks": walks, "seconds": seconds,
                      "trace": bool(trace),
                      "prepare": tr.get("rank_prepare")}}
    res = launch(mesh, [job], env={"PYTHONPATH": os.pathsep.join(path)})
    wins = [r["results"][0]["value"] for r in res]
    w0 = dict(wins[0])
    w0["peak"] = max(w["peak"] for w in wins)
    if w0["traced"] is not None:
        devs = [w["traced"]["device"] for w in wins]
        merged = dict(devs[0])
        kernels: dict = {}
        for d in devs:
            for name, k in d["kernels"].items():
                m = kernels.setdefault(name, {"count": 0, "seconds": 0.0})
                m["count"] += k["count"]
                m["seconds"] += k["seconds"]
        merged["kernels"] = kernels
        merged["launches"] = sum(d["launches"] for d in devs) / len(devs)
        merged["exchange_bytes"] = sum(d["exchange_bytes"] for d in devs)
        merged["busy_s_mean"] = sum(d["busy_s"] for d in devs) / len(devs)
        w0["traced"] = dict(w0["traced"], device=merged)
    return w0, w0["setup_end"], w0["marks"]
