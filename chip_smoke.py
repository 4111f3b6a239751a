#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``dslabs_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``dslabs_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, reproduces the
reference's pinned search counts through the kernels, and drives the main
path (the device-resident BFS of the flagship: the lab3 multi-Paxos twin
compiled from its spec, ``specs_lab3.make_paxos_protocol`` at bench.py's
configuration, with bit-packed frontier rows and a 2^24-slot visited
table) once.  Each phase prints one JSON line:

  device   the card (torch.cuda.get_device_name) and nvidia-smi's name and
           power limit;
  build    nvcc build of csrc/*.cu for sm_90a: seconds and the compiler's
           per-kernel register / shared-memory report;
  kernels  per kernel: bit-exact comparisons with the plain version at the
           main path's shapes (for the insert also two crowded cases from
           tests/torch_insert_cases.py where the tail cut decides), then
           timings (CUDA events, median of 20 runs after warm-up) beside
           the least time the card could take (bound) and the plain
           version's time; for the insert also the time per call of 19
           calls issued back to back (pipelined_ms), where the wrapper's
           host work overlaps the device;
  parity   TensorSearch(device="cuda").run() against pinned counts: lab1
           clientserver c3-w4 (1723 / 17292), the Paxos hand twin n3-c1-s2
           to depth 6 (7540 / 26389), the flagship's hand twin to depth 4
           (713 / 2457); and the lab2 primary-backup twin with runtime
           delivery masks that cut the client off, through both loops on
           the card, against the plain path on the CPU;
  compiled the spec compiler and packed rows: the compiled flagship's
           shape (842 lanes, 217 packed words, 868 bytes per state), the
           generated twins' pinned counts on the card (Paxos n3-c1-s2
           6 / 25 / 102, plain single-decree Paxos exhausted at 1548 / 202
           / 11, generated pingpong and clientserver equal to their hand
           twins, the compiled flagship to depth 4 713 / 2457 also on the
           CPU), then the compiled flagship to depth 8 packed and unpacked
           in turns beside the hand twin, with equal counts: seconds,
           unique states/min, peak device memory, chunk steps and the
           launches of each kernel per run; and the device time and
           launches of one unpack call (a 4096-row chunk) and one pack
           call (the rows one chunk step appends on average) by CUDA
           events and under torch.profiler;
  profile  the compiled flagship (packed) and the hand twin to depth 8
           under torch.profiler: the device's busy share (summed kernel
           time over wall time), device launches per chunk step, the
           ported kernels' device time, the insert's device launches
           beside its calls (must be equal: one launch per insert) and the
           top kernels by device time;
  trace    the trace-recording host loop (record_trace=True, run_host):
           the flagship to depth 8 twice between two device-loop runs to
           the same depth, with equal counts, seconds, unique states/min,
           peak device memory and the launches of each kernel during the
           traced runs (the fingerprint's must be > 0; the host keeps the
           visited set, so the insert's must be 0), then once more under
           torch.profiler (busy share, top kernels); the Paxos twin's goal
           search with its pinned trace, replayed by decode_trace to the
           goal state; and the lab2 twin's goal search with a trace, equal
           on the card and on the CPU;
  harness  lab search tests through the harness binding: the port's
           search.bfs with the tensor backend (tpu/backend.py, its lab
           0-3 adapters, run_host underneath) on the card.  The lab 0-2
           shapes of tests/torch_harness_cases.py beside the port's own
           object checker (same end condition, goal or violation depth,
           and count on runs that end by depth or space; the replayed
           terminal state re-checked with the object predicate), the lab 1
           infinite workload to depth 15 (51 states), a composition with
           no twin (NoTensorTwin); lab 3 at full width against pins from
           the reference's object checker: test20's three staged phases
           (goal depths 7 and 11, then 138 states with timers frozen),
           test22's first append and CLIENTS_DONE in both other
           majorities (goal depths 7, 11 and 16), test21 (n=5, depth 12,
           partition; with timers frozen 2 states) and the depth-4
           count-parity shape (85).  The time-limited lab 1 infinite
           workload may raise CapacityOverflow at depth 16 on the top rung
           of the capacity ladder, where the reference's tensor_bfs raises
           too.  Per search: seconds, unique states/min, peak device
           memory, the ladder rung, and each kernel's launches (the
           fingerprint's must be > 0);
  search   the main path at full size: the compiled flagship, packed
           (strict, visited_cap 2^24, frontier_cap 2^20, chunk 4096, depth
           10 or SEARCH_MAX_SECS): outcome, unique states/min, peak device
           memory, bytes per state, chunk steps, and the launch count of
           each kernel during that run (each must be > 0).

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
# bench.py's flagship configuration.
FLAGSHIP_KW = dict(n=3, n_clients=2, w=1, max_slots=3, net_cap=64,
                   timer_cap=6)


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


def pipelined_ms(torch, fn, args) -> float:
    """Milliseconds per call of ``fn(arg)`` for each of ``args`` issued
    back to back between two CUDA events."""
    fn(args[-1])                                 # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for arg in args[:-1]:
        fn(arg)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (len(args) - 1)


def bound_ms(n_bytes: float, n_ops: float):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / INT32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------- phases

def phase_kernels(torch, mods, gen):
    kernels, visited, engine = mods["kernels"], mods["visited"], \
        mods["engine"]
    insert_cases = mods["insert_cases"]
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
    # Crowded: more than T keys outlive the 64 full rounds, so the tail's
    # cut to the lowest-index T decides the winners (numpy-built).
    for name, build in (("many_rounds", insert_cases.many_rounds_case),
                        ("crowded_2^16", insert_cases.crowded_case)):
        table, keys, valid = build()
        r = compare(name, torch.from_numpy(table.view("int32")).to(dev),
                    torch.from_numpy(keys.view("int32")).to(dev),
                    torch.from_numpy(valid).to(dev))
        check(r[2] > len(keys) // 8, f"{name}: tail cut not reached")
        results[name] = r
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
    # The same calls back to back on fresh copies of the table: each
    # call's host work then overlaps the device work of the one before,
    # so this is the device time per call while the host keeps ahead.
    ins_piped = pipelined_ms(
        torch, lambda t: visited.insert(t, keys, valid),
        [base.clone() for _ in range(20)])
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
        max_abs_err=ins_err, ms=ins_ms, pipelined_ms=ins_piped,
        plain_ms=ins_plain, bound_ms=b_ms,
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
    t = time.time()
    o = engine.TensorSearch(hand_flagship_protocol(), max_depth=4,
                            chunk=4096, visited_cap=1 << 20).run()
    runs["hand_flagship_d4"] = key(o) + [time.time() - t]
    check(key(o) == ["DEPTH_EXHAUSTED", 713, 2457, 4],
          f"hand flagship parity: {key(o)}")
    masked = masked_pb_protocol()
    marr, tarr = pb_link_matrix()
    for name, dev, kw in (
            ("pb_masked_d6_device", "cuda", dict(chunk=4096)),
            ("pb_masked_d6_host", "cuda",
             dict(chunk=4096, use_host_visited=True)),
            ("pb_masked_d6_plain_cpu", "cpu", dict(chunk=64))):
        t = time.time()
        ts = engine.TensorSearch(masked, max_depth=6, visited_cap=1 << 16,
                                 device=dev, **kw)
        ts.set_runtime_masks(marr, tarr)
        o = ts.run()
        runs[name] = key(o) + [time.time() - t]
    t = time.time()
    o = engine.TensorSearch(masked, max_depth=6, chunk=4096,
                            visited_cap=1 << 16).run()
    runs["pb_unmasked_d6"] = key(o) + [time.time() - t]
    check(runs["pb_masked_d6_device"][:4] == runs["pb_masked_d6_host"][:4]
          == runs["pb_masked_d6_plain_cpu"][:4]
          == ["DEPTH_EXHAUSTED", 209, 874, 6]
          and o.unique_states > 209,
          f"masked lab2 parity: {runs}")
    emit({"phase": "parity", "runs": runs,
          "fields": ["end", "unique", "explored", "depth", "secs"]})


def pb_link_matrix():
    """Runtime masks of the lab2 twin (ViewServer, two servers, client 3):
    a link matrix with every link to and from the client cut, and every
    node's timers deliverable."""
    import numpy as np

    marr = np.ones((4, 4), bool)
    marr[3, :] = False
    marr[:, 3] = False
    return marr.reshape(-1), np.ones(4, bool)


def masked_pb_protocol():
    """The lab2 twin (ns=2, 1 client, w=1) with runtime delivery masks
    over [tag, frm, to, ...] records, batched over leading dimensions."""
    from dslabs_tpu_torch.tpu.protocols.primarybackup import make_pb_protocol

    def msg_mask(msg, marr):
        k = msg[..., 1].clamp(0, 3) * 4 + msg[..., 2].clamp(0, 3)
        return marr[k.long()]

    def tmr_mask(node, tarr):
        return tarr[node.long()]

    return dataclasses.replace(make_pb_protocol(2, 1, 1), goals={},
                               deliver_message_rt=msg_mask,
                               deliver_timer_rt=tmr_mask)


def flagship_protocol():
    """The main path's twin: bench.py's flagship compiled from its spec
    (specs_lab3), goals stripped."""
    from dslabs_tpu_torch.tpu.specs_lab3 import make_paxos_protocol

    return dataclasses.replace(make_paxos_protocol(**FLAGSHIP_KW), goals={})


def hand_flagship_protocol():
    """The same configuration through the hand-written twin."""
    from dslabs_tpu_torch.tpu.protocols.paxos import make_paxos_protocol

    return dataclasses.replace(make_paxos_protocol(**FLAGSHIP_KW), goals={})


def timed_search(torch, mods, ts):
    """``ts.run()`` with every kernel count set to 0 just before and read
    just after -> (outcome, record of its key, seconds, unique/min, peak
    device memory, bytes per state, chunk steps and the launches of each
    kernel)."""
    kernels, visited = mods["kernels"], mods["visited"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.LAUNCHES["fingerprint_rows"] = 0
    visited.LAUNCHES["insert"] = 0
    steps0 = ts.chunk_steps
    t0 = time.time()
    o = ts.run()
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = {"fingerprint_rows": kernels.LAUNCHES["fingerprint_rows"],
                "insert": visited.LAUNCHES["insert"]}
    return o, dict(key=[o.end_condition, o.unique_states,
                        o.states_explored, o.depth],
                   secs=secs, unique_per_min=o.unique_states / secs * 60,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   bytes_per_state=o.bytes_per_state,
                   chunk_steps=ts.chunk_steps - steps0, launches=launches)


def profiled_call(torch, fn):
    """One ``fn()`` under torch.profiler (device activity) -> (device ms,
    device launches)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return sum(dev_ms(e) for e in kern), sum(e.count for e in kern)


def phase_compiled(torch, mods, depth: int):
    """The spec compiler and packed rows on the card: the compiled
    flagship's shape, the generated twins' pinned counts, the compiled
    flagship to ``depth`` packed and unpacked in turns beside the hand
    twin, and the device time of pack and unpack at the path's shapes."""
    engine = mods["engine"]
    from dslabs_tpu_torch.tpu import specs
    from dslabs_tpu_torch.tpu.protocols.clientserver import \
        make_clientserver_protocol
    from dslabs_tpu_torch.tpu.protocols.pingpong import \
        make_pingpong_protocol
    from dslabs_tpu_torch.tpu.specs_lab3 import make_paxos_protocol

    def key(o):
        return [o.end_condition, o.unique_states, o.states_explored, o.depth]

    def pruned(p):
        return dataclasses.replace(p, goals={}, prunes=dict(p.goals))

    fl = flagship_protocol()
    ts = engine.TensorSearch(fl, visited_cap=1 << 20, chunk=4096)
    pk = ts._pk
    shape = dict(lanes=ts.lanes, plane=ts.plane, node_width=fl.node_width,
                 bytes_per_state=pk.bytes_per_state,
                 bytes_per_state_unpacked=ts.lanes * 4,
                 signature=pk.signature())
    check((ts.lanes, ts.plane, pk.bytes_per_state) == (842, 217, 868),
          f"compiled flagship shape: {shape}")

    counts = {}
    t = time.time()
    gp = dataclasses.replace(make_paxos_protocol(), goals={})
    got = [engine.TensorSearch(gp, max_depth=d, chunk=1024,
                               visited_cap=1 << 16).run().unique_states
           for d in (1, 2, 3)]
    counts["gen_paxos_c1s2_d123"] = got + [time.time() - t]
    check(got == [6, 25, 102], f"generated paxos: {got}")
    t = time.time()
    o = engine.TensorSearch(pruned(specs.paxos_spec(3).compile()),
                            chunk=1024, visited_cap=1 << 16).run()
    counts["paxos_single_decree"] = key(o) + [time.time() - t]
    check(key(o) == ["SPACE_EXHAUSTED", 202, 1548, 11],
          f"plain paxos: {key(o)}")
    for name, gen, hand in (
            ("pingpong_w2", specs.pingpong_spec(2).compile(),
             make_pingpong_protocol(2)),
            ("clientserver_c2w2", specs.clientserver_spec(2, 2).compile(),
             make_clientserver_protocol(2, 2))):
        t = time.time()
        og, oh = (engine.TensorSearch(pruned(p), chunk=1024,
                                      visited_cap=1 << 16).run()
                  for p in (gen, hand))
        counts[name] = key(og) + [time.time() - t]
        check(key(og) == key(oh) and og.end_condition == "SPACE_EXHAUSTED",
              f"{name}: generated {key(og)} vs hand {key(oh)}")
    for dev, chunk in (("cuda", 4096), ("cpu", 256)):
        t = time.time()
        o = engine.TensorSearch(fl, max_depth=4, chunk=chunk,
                                visited_cap=1 << 14, device=dev).run()
        counts[f"flagship_d4_{dev}"] = key(o) + [time.time() - t]
        check(key(o) == ["DEPTH_EXHAUSTED", 713, 2457, 4],
              f"compiled flagship d4 on {dev}: {key(o)}")

    def search(p, packed=True):
        return engine.TensorSearch(p, visited_cap=1 << 24,
                                   frontier_cap=1 << 20, chunk=4096,
                                   max_depth=depth, packed=packed)

    hand = hand_flagship_protocol()
    runs = []
    for label, p, packed in (
            ("compiled_packed", fl, True), ("hand", hand, True),
            ("compiled_unpacked", fl, False),
            ("compiled_unpacked", fl, False), ("hand", hand, True),
            ("compiled_packed", fl, True)):
        runs.append(dict(run=label, **timed_search(
            torch, mods, search(p, packed))[1]))
        check(all(v > 0 for v in runs[-1]["launches"].values()),
              f"{label}: a kernel was not launched: {runs[-1]}")
    check(all(r["key"] == runs[1]["key"] for r in runs)
          and runs[0]["key"][0] == "DEPTH_EXHAUSTED",
          f"compiled and hand flagship differ: {runs}")

    # pack and unpack as the device loop calls them: one chunk of packed
    # rows unpacked, and the rows one chunk step appends (the packed run's
    # mean) packed with the out-of-domain count.
    torch.manual_seed(1)
    n_app = -(-runs[0]["key"][1] // runs[0]["chunk_steps"])
    codes = torch.randint(0, 2, (4096, ts.lanes), dtype=torch.int32,
                          device="cuda")
    rows = pk.unpack(pk.pack(codes))
    chunk = pk.pack(rows)
    check(torch.equal(pk.unpack(chunk), rows), "pack/unpack round trip")
    rows = rows.repeat(-(-n_app // 4096), 1)[:n_app].contiguous()
    pack_ms = cuda_ms(torch, lambda _: pk.pack(rows, count_bad=True),
                      reps=10, warmup=2)
    unpack_ms = cuda_ms(torch, lambda _: pk.unpack(chunk))
    pack_prof = profiled_call(torch, lambda: pk.pack(rows, count_bad=True))
    unpack_prof = profiled_call(torch, lambda: pk.unpack(chunk))
    del codes, rows, chunk
    torch.cuda.empty_cache()
    emit({"phase": "compiled", "shape": shape, "counts": counts,
          "count_fields": ["end", "unique", "explored", "depth", "secs"],
          "depth": depth, "runs": runs,
          "pack": dict(rows=n_app, ms=pack_ms,
                       profiled_device_ms=pack_prof[0],
                       device_launches=pack_prof[1]),
          "unpack": dict(rows=4096, ms=unpack_ms,
                         profiled_device_ms=unpack_prof[0],
                         device_launches=unpack_prof[1])})


# CUDA kernels of each ported function, as torch.profiler names them.
PORT_KERNELS = {
    "fingerprint_rows": re.compile(r"\bfingerprint_rows_kernel\("),
    "insert": re.compile(r"\binsert_coop_kernel\("),
}


def dev_ms(e) -> float:
    """Device milliseconds of one key_averages() entry."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0)) / 1e3


def profiled_run(torch, ts):
    """``ts.run()`` under torch.profiler -> (outcome, wall ms, CUDA kernel
    entries of key_averages(), summed device ms).  Device activity only:
    host-side op events would multiply the trace (about four per kernel)
    and its processing time."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        o = ts.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_ms = sum(dev_ms(e) for e in kern)
    check(busy_ms > 0, "torch.profiler recorded no device time")
    return o, wall_ms, kern, busy_ms


def top_kernels(kern, n: int = 10):
    return [[e.key[:80], e.count, dev_ms(e)]
            for e in sorted(kern, key=dev_ms, reverse=True)[:n]]


def phase_profile(torch, mods, depth: int):
    """The compiled flagship (packed) and the hand twin to ``depth`` under
    torch.profiler, one after the other."""
    for twin, proto in (("compiled_packed", flagship_protocol()),
                        ("hand", hand_flagship_protocol())):
        profile_twin(torch, mods, depth, twin, proto)


def profile_twin(torch, mods, depth: int, twin: str, proto):
    """One search to ``depth`` under torch.profiler: the device's busy
    share (summed kernel time over wall time), device launches per chunk
    step, the time of the two ported kernels, the insert's device
    launches beside its calls (one each), and the kernels that take the
    most device time."""
    engine, visited = mods["engine"], mods["visited"]
    ts = engine.TensorSearch(proto, visited_cap=1 << 24,
                             frontier_cap=1 << 20, chunk=4096,
                             max_depth=depth)
    warm = ts.run()                            # warm-up, unprofiled
    calls0 = visited.LAUNCHES["insert"]
    steps0 = ts.chunk_steps
    o, wall_ms, kern, busy_ms = profiled_run(torch, ts)
    insert_calls = visited.LAUNCHES["insert"] - calls0
    chunk_steps = ts.chunk_steps - steps0
    check((o.unique_states, o.states_explored, o.depth)
          == (warm.unique_states, warm.states_explored, warm.depth),
          f"profiled search differs from its warm-up: {o} vs {warm}")
    port_ms = {name: sum(dev_ms(e) for e in kern if pat.search(e.key))
               for name, pat in PORT_KERNELS.items()}
    check(all(v > 0 for v in port_ms.values()),
          f"profiled search ran no ported kernel: {port_ms}")
    insert_launches = sum(e.count for e in kern
                          if PORT_KERNELS["insert"].search(e.key))
    check(insert_launches == insert_calls,
          f"insert: {insert_launches} device launches for {insert_calls} "
          "calls (one each expected)")
    launches = sum(e.count for e in kern)
    emit({"phase": "profile", "twin": twin, "depth": o.depth,
          "end": o.end_condition,
          "unique": o.unique_states, "explored": o.states_explored,
          "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / wall_ms,
          "port_kernels_ms": port_ms,
          "insert_calls": insert_calls,
          "insert_device_launches": insert_launches,
          "device_launches": launches, "chunk_steps": chunk_steps,
          "device_launches_per_chunk_step": launches / chunk_steps,
          "top_kernels": top_kernels(kern)})


def phase_trace(torch, mods, depth: int):
    """The trace-recording host loop on the card: the flagship to
    ``depth`` through run_host (twice) between two device-loop runs to the
    same depth, then two goal searches whose traces are checked."""
    engine = mods["engine"]
    from dslabs_tpu_torch.tpu.protocols.paxos import make_paxos_protocol
    from dslabs_tpu_torch.tpu.protocols.primarybackup import make_pb_protocol
    from dslabs_tpu_torch.tpu.trace import decode_trace

    def key(o):
        return [o.end_condition, o.unique_states, o.states_explored, o.depth]

    def flagship_search(trace: bool):
        return engine.TensorSearch(flagship_protocol(), visited_cap=1 << 24,
                                   frontier_cap=1 << 20, chunk=4096,
                                   max_depth=depth, record_trace=trace)

    def timed(trace: bool):
        return dict(loop="host" if trace else "device", **timed_search(
            torch, mods, flagship_search(trace))[1])

    flagship = [timed(False), timed(True), timed(True), timed(False)]
    check(all(r["key"] == flagship[0]["key"] for r in flagship)
          and flagship[0]["key"][0] == "DEPTH_EXHAUSTED",
          f"flagship run_host and device loop differ: {flagship}")
    for r in flagship:
        want_insert = r["loop"] == "device"
        check(r["launches"]["fingerprint_rows"] > 0
              and (r["launches"]["insert"] > 0) == want_insert,
              f"{r['loop']} loop launches: {r['launches']}")
    # One more traced run under the profiler: where its time goes.
    o, wall_ms, kern, busy_ms = profiled_run(torch, flagship_search(True))
    check(key(o) == flagship[0]["key"], f"profiled run_host: {key(o)}")
    host_profile = dict(
        wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_busy_share=busy_ms / wall_ms,
        device_launches=sum(e.count for e in kern),
        fingerprint_ms=sum(dev_ms(e) for e in kern if
                           PORT_KERNELS["fingerprint_rows"].search(e.key)),
        top_kernels=top_kernels(kern, 6))

    def replay_end(ts, o):
        row = engine.flatten_state({k: torch.as_tensor(v).cuda() for k, v
                                    in ts._trace_root.items()})[0]
        for ev in o.trace:
            row, valid, _ = ts._step_one(row, ev)
            check(bool(valid), f"trace event {ev} undeliverable on replay")
        return row.cpu()

    def goal_row(o):
        return engine.flatten_state({k: torch.as_tensor(v) for k, v in
                                     o.goal_state.items()})[0]

    goals = {}
    t = time.time()
    ts = engine.TensorSearch(make_paxos_protocol(
        n=3, n_clients=1, max_slots=2, net_cap=48, timer_cap=6),
        chunk=1024, max_depth=12, record_trace=True)
    o = ts.run()
    recs = decode_trace(ts, o)
    goals["paxos_c1s2"] = key(o) + [o.trace, time.time() - t]
    check(key(o) == ["GOAL_FOUND", 7540, 77101, 7]
          and o.trace == [48, 3, 5, 0, 6, 8, 11] and len(recs) == 7
          and torch.equal(replay_end(ts, o), goal_row(o)),
          f"paxos goal trace: {goals['paxos_c1s2']}")
    pb = {}
    for dev in ("cuda", "cpu"):
        t = time.time()
        ts = engine.TensorSearch(make_pb_protocol(2, 1, 1), chunk=256,
                                 max_depth=12, record_trace=True, device=dev)
        o = ts.run()
        pb[dev] = (o, [(r[0], r[1][-1].tolist()) for r in
                       decode_trace(ts, o)])
        goals[f"pb_s2c1_{dev}"] = key(o) + [o.trace, time.time() - t]
    (oc, rc), (oh, rh) = pb["cuda"], pb["cpu"]
    check(key(oc) == key(oh) == ["GOAL_FOUND", 299, 2887, 6]
          and oc.trace == oh.trace == [0, 2, 3, 4, 5, 6] and rc == rh
          and torch.equal(goal_row(oc), goal_row(oh)),
          f"lab2 goal trace, card vs CPU: {goals}")
    emit({"phase": "trace", "depth": depth, "flagship": flagship,
          "host_profile": host_profile, "goals": goals,
          "goal_fields": ["end", "unique", "explored", "depth", "trace",
                          "secs"]})


# Pins of the harness phase's lab 3 searches, from the reference's object
# checker (dslabs_tpu.search.search.BFS) on the CPU over the builders of
# tests/torch_harness_cases.py: goal depths, and discovered_count where
# the object run ends by depth or by space.
HARNESS_PINS = {
    "test20_phase1": ("GOAL_FOUND", 7, None),
    "test20_phase2": ("GOAL_FOUND", 11, None),
    "test20_phase3": ("SPACE_EXHAUSTED", None, 138),
    "test22_phase1": ("GOAL_FOUND", 7, None),
    "test22_phase2_s1s3": ("GOAL_FOUND", 11, None),
    "test22_phase2_s2s3": ("GOAL_FOUND", 16, None),
    # test21's space is past the object checker's reach (it had not
    # ended after 15 minutes; the card explores 189,288 states to depth
    # 11 in its 20 s), so no count: only the accepted end conditions.
    "test21": ("SPACE_EXHAUSTED", None, None),
    "test21_no_timers": ("SPACE_EXHAUSTED", None, 2),
    "lab3_depth4": ("SPACE_EXHAUSTED", None, 85),
}


def phase_harness(torch, mods):
    """Lab search tests through the harness binding on the card: the
    port's ``search.bfs`` with the tensor backend (``tpu/backend.py`` and
    its adapters, ``run_host`` underneath).  The lab 0-2 shapes run beside
    the port's own object checker in this process; the lab 3 searches are
    held against HARNESS_PINS.  Every search: seconds, unique states/min,
    peak device memory, the capacity-ladder rung taken, and the kernels'
    launches with the counts set to 0 just before it (the fingerprint's
    must be > 0)."""
    kernels, visited = mods["kernels"], mods["visited"]
    from dslabs_tpu_torch.search import search as osearch
    from dslabs_tpu_torch.tpu import backend
    from dslabs_tpu_torch.tpu.engine import CapacityOverflow
    from dslabs_tpu_torch.utils.flags import GlobalSettings
    from tests import torch_harness_cases as H

    P = H.Pkg("dslabs_tpu_torch")
    GlobalSettings.search_backend = "tensor"
    runs = []
    run_tensor = backend._run_tensor

    def spy(*a, **kw):
        runs.append(run_tensor(*a, **kw))
        return runs[-1]

    backend._run_tensor = spy
    records = {}

    def tensor(name, case):
        """One search through search.bfs on the card -> (results or the
        CapacityOverflow it raised, record)."""
        del runs[:]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.LAUNCHES["fingerprint_rows"] = 0
        visited.LAUNCHES["insert"] = 0
        t0 = time.time()
        try:
            res = osearch.bfs(case.state, case.settings)
        except CapacityOverflow as e:
            res = e
        torch.cuda.synchronize()
        secs = time.time() - t0
        rec = dict(secs=secs, peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   launches={"fingerprint_rows":
                             kernels.LAUNCHES["fingerprint_rows"],
                             "insert": visited.LAUNCHES["insert"]})
        if isinstance(res, CapacityOverflow):
            rec.update(end="CapacityOverflow", error=str(res))
        else:
            search, outcome, _ = runs[-1]
            rec.update(
                end=H.end_name(res), depth=H.terminal_depth(res),
                unique=res.discovered_count,
                unique_per_min=res.discovered_count / secs * 60,
                tensor_end=outcome.end_condition,
                tensor_depth=outcome.depth,
                rung=[f for f, _ in backend._LADDER].index(
                    search.frontier_cap))
        check(rec["launches"]["fingerprint_rows"] > 0,
              f"harness {name}: the fingerprint kernel never launched")
        records[name] = rec
        return res, rec

    try:
        for name in sorted(H.LAB02):
            build = H.LAB02[name]
            res, rec = tensor(name, build(P))
            case = build(P)
            obj = osearch.BFS(case.settings).run(case.state)
            rec["object"] = dict(end=H.end_name(obj),
                                 depth=H.terminal_depth(obj),
                                 unique=obj.discovered_count)
            if name == "lab1_infinite" and rec["end"] == "CapacityOverflow":
                # The reference's tensor_bfs raises at the same place: the
                # twin outgrows the ladder's top rung at depth 16.
                check(re.search(r"net_cap=64, timer_cap=8.*depth "
                                f"{H.INFINITE_OVERFLOW_DEPTH} ",
                                rec["error"]) is not None,
                      f"harness {name}: {rec['error']}")
                continue
            check(rec["end"] in case.expect
                  and rec["depth"] == rec["object"]["depth"]
                  and (len(case.expect) > 1
                       or rec["end"] == rec["object"]["end"])
                  and (not case.exact
                       or rec["unique"] == rec["object"]["unique"]),
                  f"harness {name}: {rec}")
            if rec["end"] in ("GOAL_FOUND", "INVARIANT_VIOLATED"):
                preds = (case.settings.goals if rec["end"] == "GOAL_FOUND"
                         else case.settings.invariants)
                st = H.terminal(res)
                check(any(p.check(st).value == (rec["end"] == "GOAL_FOUND")
                          for p in preds),
                      f"harness {name}: object predicate on replayed state")
        depth, count = H.INFINITE_FITS
        res, rec = tensor("lab1_infinite_d15",
                          H.lab1_infinite_depth(P, depth))
        check(rec["end"] == "SPACE_EXHAUSTED" and rec["unique"] == count,
              f"harness lab1_infinite_d15: {rec}")
        try:
            tensor("no_twin", H.Case(H.no_twin_state(P),
                                     P.SearchSettings(), ()))
        except backend.NoTensorTwin:
            records.pop("no_twin", None)
        else:
            raise AssertionError("harness no_twin: no NoTensorTwin raised")

        def lab3(name, case):
            res, rec = tensor(name, case)
            end, depth, count = HARNESS_PINS[name]
            check(rec["end"] in case.expect, f"harness {name}: {rec}")
            if rec["end"] == end:
                check((depth is None or rec["depth"] == depth)
                      and (count is None or rec["unique"] == count),
                      f"harness {name}: {rec} against pin {end, depth, count}")
            return res

        res = lab3("test20_phase1", H.test20_phase1(P))
        goal = H.terminal(res)
        lab3("test20_phase2", H.test20_phase2(P, goal))
        lab3("test20_phase3", H.test20_phase3(P, goal))
        res = lab3("test22_phase1", H.test22_phase1(P))
        goal = H.terminal(res)
        lab3("test22_phase2_s1s3", H.test22_phase2(P, goal, (1, 3), 2))
        lab3("test22_phase2_s2s3", H.test22_phase2(P, goal, (2, 3), 1))
        lab3("test21", H.lab3_test21(P))
        lab3("test21_no_timers", H.lab3_test21(P, timers=False))
        lab3("lab3_depth4", H.lab3_depth4(P))
    finally:
        backend._run_tensor = run_tensor
        GlobalSettings.search_backend = "object"
    emit({"phase": "harness", "searches": records})


def phase_search(torch, mods, max_secs: float):
    engine = mods["engine"]
    ts = engine.TensorSearch(flagship_protocol(), visited_cap=1 << 24,
                             frontier_cap=1 << 20, chunk=4096, max_depth=10,
                             max_secs=max_secs, strict=True)
    check((ts.lanes, ts.plane) == (842, 217),
          f"flagship lanes {ts.lanes}, plane {ts.plane}")
    o, rec = timed_search(torch, mods, ts)
    launches = rec["launches"]
    check(o.end_condition in ("DEPTH_EXHAUSTED", "TIME_EXHAUSTED",
                              "CAPACITY_EXHAUSTED"),
          f"search ended {o.end_condition}")
    check(o.depth >= 4 and o.unique_states >= 713
          and o.states_explored >= o.unique_states - 1
          and o.visited_overflow == 0,
          f"search outcome implausible: {o}")
    check(all(v > 0 for v in launches.values()),
          f"main path skipped a kernel: {launches}")
    emit({"phase": "search", **rec,
          "explored_per_min": o.states_explored / rec["secs"] * 60,
          "max_secs": max_secs})
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
    from tests import torch_insert_cases

    mods = {"engine": engine, "kernels": kernels, "visited": visited,
            "insert_cases": torch_insert_cases}
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
    phase_compiled(torch, mods, PROFILE_DEPTH)
    phase_profile(torch, mods, PROFILE_DEPTH)
    phase_trace(torch, mods, PROFILE_DEPTH)
    phase_harness(torch, mods)
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
