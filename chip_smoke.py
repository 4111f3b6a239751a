#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``dslabs_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``dslabs_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, reproduces the
reference's pinned search counts through the kernels, and drives the main
path (the device-resident BFS of the flagship Paxos twin with a 2^24-slot
visited table) once.  Each phase prints one JSON line:

  device   the card (torch.cuda.get_device_name) and nvidia-smi's name and
           power limit;
  build    nvcc build of csrc/*.cu for sm_90a: seconds and the compiler's
           per-kernel register / shared-memory report;
  kernels  per kernel: bit-exact comparisons with the plain version at the
           main path's shapes, then timings (CUDA events, median of 20
           runs after warm-up) beside the least time the card could take
           (bound) and the plain version's time;
  parity   TensorSearch(device="cuda").run() against pinned counts: lab1
           clientserver c3-w4 (1723 / 17292), the Paxos twin n3-c1-s2 to
           depth 6 (7540 / 26389), the flagship to depth 4 (713 / 2457),
           the last also through the port's plain path on the CPU;
  profile  the flagship to depth 8 under torch.profiler: the device's busy
           share (summed kernel time over wall time), the ported kernels'
           device time and the top kernels by device time;
  search   the main path at full size (strict, visited_cap 2^24,
           frontier_cap 2^20, chunk 4096, depth 10 or SEARCH_MAX_SECS):
           outcome, unique states/min, peak device memory, and the launch
           count of each kernel during that run (each must be > 0).

Then one line ``{"kernels": [...]}`` with every kernel's numbers, the
card's name and power limit as nvidia-smi prints them, and last
``{"ok": true, "device": {...}}``.  Any mismatch or error exits non-zero
before the last line.  Without CUDA, or without the package beside it,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 3.35 TB/s.  int32
# logic/shift/add rate: 132 SMs x 64 lanes per clock (the CUDA
# programming guide's compute-capability-9.0 throughput for 32-bit
# add, bitwise and shift) x 1.98 GHz boost, the clock behind the data
# sheet's 67 TFLOP/s float32 figure (132 x 128 x 2 x 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations per lane of the fingerprint that only the ALU pipe can
# take: each of the 4 mixes is 1 xor with the position product, 3 right
# shifts and 3 xors, so 4 x 7 = 28.  The rest runs on the FMA pipe and
# does not bind: the mixes' shift-adds x + (x << k) are multiplies by
# 1 + 2^k (IMAD), the position products are IMULs, and the 4
# accumulating adds can issue as IMAD.IADD.
FP_OPS_PER_LANE = 28

# Wave-loop budget of the search phase: with the parity phases and the
# build this keeps the whole script well inside its 1200 s limit even if
# the wave that starts just before the budget is the largest one.
SEARCH_MAX_SECS = 240.0
# Depth of the profiled flagship search: deep enough that most chunks are
# full (4096 states).
PROFILE_DEPTH = 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, setup=None, reps=20, warmup=3) -> float:
    """Median milliseconds of ``fn(setup())`` between CUDA events."""
    for _ in range(warmup):
        fn(setup() if setup else None)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        arg = setup() if setup else None
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / INT32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------- phases

def phase_kernels(torch, mods, gen):
    kernels, visited, engine = mods["kernels"], mods["visited"], \
        mods["engine"]
    dev = "cuda"
    C, B, L = 4096, 94, 842          # flagship chunk x events x lanes
    n_main = C * B
    out = {}

    # ---- kernel 1: fingerprint, bit-exact on the main path's shapes.
    cases = [(4096 * 48, L), (n_main, L), (1, L), (1001, L), (7, 167)]
    fp_err = 0
    for b, l in cases:
        flat = torch.randint(-2 ** 31, 2 ** 31 - 1, (b, l), generator=gen,
                             dtype=torch.int32, device="cpu").to(dev)
        k = kernels.fingerprint_rows(flat)
        p = engine.row_fingerprints(flat)
        torch.cuda.synchronize()
        err = int((k.to(torch.int64) - p.to(torch.int64)).abs().max())
        check(err == 0 and k.shape == (b, 4),
              f"fingerprint_rows [{b},{l}] disagrees with its plain "
              f"version (max abs err {err})")
        fp_err = max(fp_err, err)
    flat = torch.randint(-2 ** 31, 2 ** 31 - 1, (n_main, L), generator=gen,
                         dtype=torch.int32, device="cpu").to(dev)
    fp_ms = cuda_ms(torch, lambda _: kernels.fingerprint_rows(flat))
    fp_plain = cuda_ms(torch, lambda _: engine.row_fingerprints(flat),
                       reps=20, warmup=1)
    b_ms, b_by = bound_ms(n_main * L * 4 + n_main * 16,
                          n_main * L * FP_OPS_PER_LANE)
    out["fingerprint_rows"] = dict(
        cases=[list(c) for c in cases], max_abs_err=fp_err, ms=fp_ms,
        plain_ms=fp_plain, bound_ms=b_ms, bound_by=b_by, shape=[n_main, L])
    del flat

    # ---- kernel 2: insert, bit-exact on the contract cases.
    def rand_keys(n):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 4), generator=gen,
                             dtype=torch.int32, device="cpu").to(dev)

    def rand_valid(n, p_valid=0.8):
        return (torch.rand((n,), generator=gen) < p_valid).to(dev)

    def compare(name, table, keys, valid):
        ta, ia, ua = visited.insert(table.clone(), keys, valid)
        tb, ib, ub = visited.insert_plain(table.clone(), keys, valid)
        torch.cuda.synchronize()
        err = int((ta[:-1].to(torch.int64) - tb[:-1].to(torch.int64))
                  .abs().max())
        same = (err == 0 and torch.equal(ia, ib) and torch.equal(ua, ub))
        check(same, f"visited.insert case {name!r} disagrees with "
                    f"insert_plain (table max abs err {err})")
        return err, int(ia.sum()), int(ua.sum())

    ins_err = 0
    results = {}
    keys = rand_keys(4096)
    results["low_load"] = compare(
        "low_load", visited.empty_table(1 << 16, dev), keys,
        torch.ones(4096, dtype=torch.bool, device=dev))
    keys = rand_keys(4096)
    keys[2048:3072] = keys[:1024]
    results["in_batch_duplicates"] = compare(
        "in_batch_duplicates", visited.empty_table(1 << 16, dev), keys,
        rand_valid(4096))
    keys = rand_keys(300)
    keys[99] = -1
    keys[150] = -1
    valid = rand_valid(300)
    valid[99] = True
    results["all_max_key"] = compare(
        "all_max_key", visited.empty_table(1 << 9, dev), keys, valid)
    full, _, _ = visited.build_table(1 << 10, rand_keys(900), dev)
    r = compare("nearly_full", full, rand_keys(512),
                torch.ones(512, dtype=torch.bool, device=dev))
    check(r[2] > 0, "nearly_full case left no key unresolved")
    results["nearly_full"] = r
    # Flagship shape: 2^24 slots holding 2^20 keys, one chunk's worth of
    # successor keys (30% already present, in-batch duplicates, 20%
    # invalid).
    base, _, unres = visited.build_table(1 << 24, rand_keys(1 << 20), dev)
    check(unres == 0, "flagship table prefill left keys unresolved")
    present = visited.host_occupied(base[: 1 << 22])
    keys = rand_keys(n_main)
    k_old = min(len(present), n_main * 3 // 10)
    keys[:k_old] = torch.from_numpy(present[:k_old].view("int32")).to(dev)
    d = n_main // 20
    keys[k_old:k_old + d] = keys[k_old + d:k_old + 2 * d]
    valid = rand_valid(n_main)
    results["flagship"] = compare("flagship", base, keys, valid)
    ins_err = max(r[0] for r in results.values())
    ins_ms = cuda_ms(torch, lambda t: visited.insert(t, keys, valid),
                     setup=lambda: base.clone())
    ins_plain = cuda_ms(torch, lambda t: visited.insert_plain(t, keys, valid),
                        setup=lambda: base.clone(), reps=20, warmup=1)
    n_valid = int(valid.sum())
    n_ins = results["flagship"][1]
    # Least work: every key's 16 B and valid byte read once, each valid
    # key's home bucket line (128 B) read once, each inserted key written
    # once (16 B), two flag bytes written per key.
    b_ms, b_by = bound_ms(n_main * 17 + n_valid * 128 + n_ins * 16
                          + n_main * 2, 0)
    out["insert"] = dict(
        cases={k: dict(max_abs_err=v[0], inserted=v[1], unresolved=v[2])
               for k, v in results.items()},
        max_abs_err=ins_err, ms=ins_ms, plain_ms=ins_plain, bound_ms=b_ms,
        bound_by=b_by, shape=dict(V=1 << 24, N=n_main, valid=n_valid))
    del base
    torch.cuda.empty_cache()
    emit({"phase": "kernels", **out})
    return out


def phase_parity(torch, mods):
    engine = mods["engine"]
    from dslabs_tpu_torch.tpu.protocols.clientserver import \
        make_clientserver_protocol
    from dslabs_tpu_torch.tpu.protocols.paxos import make_paxos_protocol

    def key(o):
        return [o.end_condition, o.unique_states, o.states_explored, o.depth]

    runs = {}
    t = time.time()
    o = engine.TensorSearch(make_clientserver_protocol(3, 4, net_cap=32),
                            max_depth=12, chunk=4096,
                            visited_cap=1 << 20).run()
    runs["lab1_c3w4_d12"] = key(o) + [time.time() - t]
    check(key(o) == ["DEPTH_EXHAUSTED", 1723, 17292, 12],
          f"lab1 parity: {key(o)}")
    px = dataclasses.replace(make_paxos_protocol(
        n=3, n_clients=1, max_slots=2, net_cap=48, timer_cap=6), goals={})
    t = time.time()
    o = engine.TensorSearch(px, max_depth=6, chunk=4096,
                            visited_cap=1 << 20).run()
    runs["paxos_c1s2_d6"] = key(o) + [time.time() - t]
    check(key(o) == ["DEPTH_EXHAUSTED", 7540, 26389, 6],
          f"paxos parity: {key(o)}")
    fl = flagship_protocol()
    t = time.time()
    o = engine.TensorSearch(fl, max_depth=4, chunk=4096,
                            visited_cap=1 << 20).run()
    runs["flagship_d4"] = key(o) + [time.time() - t]
    check(key(o) == ["DEPTH_EXHAUSTED", 713, 2457, 4],
          f"flagship parity: {key(o)}")
    t = time.time()
    o = engine.TensorSearch(fl, max_depth=4, chunk=256, visited_cap=1 << 14,
                            device="cpu").run()
    runs["flagship_d4_plain_cpu"] = key(o) + [time.time() - t]
    check(key(o) == ["DEPTH_EXHAUSTED", 713, 2457, 4],
          f"flagship plain-path parity: {key(o)}")
    emit({"phase": "parity", "runs": runs,
          "fields": ["end", "unique", "explored", "depth", "secs"]})


def flagship_protocol():
    from dslabs_tpu_torch.tpu.protocols.paxos import make_paxos_protocol

    return dataclasses.replace(make_paxos_protocol(
        n=3, n_clients=2, w=1, max_slots=3, net_cap=64, timer_cap=6),
        goals={})


# CUDA kernels of each ported function, as torch.profiler names them.
PORT_KERNELS = {
    "fingerprint_rows": re.compile(r"\bfingerprint_rows_kernel\("),
    "insert": re.compile(
        r"\b(init|reserve|claim|select_tail|finalize)_kernel\("),
}


def phase_profile(torch, mods, depth: int):
    """The flagship search to ``depth`` under torch.profiler: the device's
    busy share (summed kernel time over wall time), the time of the two
    ported kernels, and the kernels that take the most device time."""
    engine = mods["engine"]
    ts = engine.TensorSearch(flagship_protocol(), visited_cap=1 << 24,
                             frontier_cap=1 << 20, chunk=4096,
                             max_depth=depth)
    warm = ts.run()                            # warm-up, unprofiled
    # Device activity only: host-side op events would multiply the trace
    # (about four per kernel) and its processing time.
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        o = ts.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check((o.unique_states, o.states_explored, o.depth)
          == (warm.unique_states, warm.states_explored, warm.depth),
          f"profiled search differs from its warm-up: {o} vs {warm}")
    kern = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]

    def dev_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / 1e3

    busy_ms = sum(dev_ms(e) for e in kern)
    check(busy_ms > 0, "torch.profiler recorded no device time")
    port_ms = {name: sum(dev_ms(e) for e in kern if pat.search(e.key))
               for name, pat in PORT_KERNELS.items()}
    check(all(v > 0 for v in port_ms.values()),
          f"profiled search ran no ported kernel: {port_ms}")
    emit({"phase": "profile", "depth": o.depth, "end": o.end_condition,
          "unique": o.unique_states, "explored": o.states_explored,
          "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / wall_ms,
          "port_kernels_ms": port_ms,
          "device_launches": sum(e.count for e in kern),
          "top_kernels": [[e.key[:80], e.count, dev_ms(e)]
                          for e in sorted(kern, key=dev_ms,
                                          reverse=True)[:10]]})


def phase_search(torch, mods, max_secs: float):
    engine, kernels, visited = mods["engine"], mods["kernels"], \
        mods["visited"]
    ts = engine.TensorSearch(flagship_protocol(), visited_cap=1 << 24,
                             frontier_cap=1 << 20, chunk=4096, max_depth=10,
                             max_secs=max_secs, strict=True)
    check(ts.lanes == 842, f"flagship lanes {ts.lanes}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.LAUNCHES["fingerprint_rows"] = 0
    visited.LAUNCHES["insert"] = 0
    t0 = time.time()
    o = ts.run()
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = {"fingerprint_rows": kernels.LAUNCHES["fingerprint_rows"],
                "insert": visited.LAUNCHES["insert"]}
    check(o.end_condition in ("DEPTH_EXHAUSTED", "TIME_EXHAUSTED",
                              "CAPACITY_EXHAUSTED"),
          f"search ended {o.end_condition}")
    check(o.depth >= 4 and o.unique_states >= 713
          and o.states_explored >= o.unique_states - 1
          and o.visited_overflow == 0,
          f"search outcome implausible: {o}")
    check(all(v > 0 for v in launches.values()),
          f"main path skipped a kernel: {launches}")
    emit({"phase": "search", "end": o.end_condition, "depth": o.depth,
          "unique": o.unique_states, "explored": o.states_explored,
          "secs": secs, "unique_per_min": o.unique_states / secs * 60,
          "explored_per_min": o.states_explored / secs * 60,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, "max_secs": max_secs})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "dslabs_tpu_torch")):
        print("chip_smoke: run from a checkout (dslabs_tpu_torch/ missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dslabs_tpu_torch.tpu import _build, engine, kernels, visited

    mods = {"engine": engine, "kernels": kernels, "visited": visited}
    t_start = time.time()
    card = smi()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": name,
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t = time.time()
    _build.build(force=True)
    _build.lib()
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "secs": time.time() - t,
          "nvcc_secs": _build.BUILD_SECS, "ptxas": ptxas})

    gen = torch.Generator().manual_seed(0)
    kres = phase_kernels(torch, mods, gen)
    phase_parity(torch, mods)
    phase_profile(torch, mods, PROFILE_DEPTH)
    launches = phase_search(torch, mods, SEARCH_MAX_SECS)

    replaces = {
        "fingerprint_rows": ("dslabs_tpu_torch/csrc/fingerprint.cu",
                             "dslabs_tpu/tpu/kernels.py:74"),
        "insert": ("dslabs_tpu_torch/csrc/visited.cu",
                   "dslabs_tpu/tpu/visited.py:315"),
    }
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": replaces[k][0],
         "replaces": replaces[k][1], "launches": launches[k],
         "max_abs_err": kres[k]["max_abs_err"], "ms": kres[k]["ms"],
         "plain_ms": kres[k]["plain_ms"], "bound_ms": kres[k]["bound_ms"],
         "bound_by": kres[k]["bound_by"], "library_ms": None}
        for k in ("fingerprint_rows", "insert")]})
    print(f"chip_smoke: {time.time() - t_start:.1f} s", file=sys.stderr)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
