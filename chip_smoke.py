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
           CPU), then the compiled flagship to depth 8 packed, the hand
           twin and the compiled flagship unpacked, once each, with equal
           counts: seconds,
           unique states/min, peak device memory, chunk steps and the
           launches of each kernel per run; and the device time and
           launches of one unpack call (a 4096-row chunk) and one pack
           call (the rows one chunk step appends on average) by CUDA
           events and under torch.profiler;
  profile  the compiled flagship (packed) and the hand twin to depth 6
           under torch.profiler: the device's busy share (summed kernel
           time over wall time), device launches per chunk step, the
           ported kernels' device time, the insert's device launches
           beside its calls (must be equal: one launch per insert) and the
           top kernels by device time;
  trace    the trace-recording host loop (record_trace=True, run_host):
           the flagship to depth 8 once beside a device-loop run to the
           same depth, with equal counts, seconds, unique states/min,
           peak device memory and the launches of each kernel during the
           traced runs (the fingerprint's must be > 0; the host keeps the
           visited set, so the insert's must be 0), then once more under
           torch.profiler (busy share, top kernels); the Paxos twin's goal
           search with its pinned trace, replayed by decode_trace to the
           goal state; and the lab2 twin's goal search with a trace, equal
           on the card and on the CPU;
  harness  lab search tests through the harness binding: the port's
           search.bfs with the tensor backend (tpu/backend.py, its lab
           0-3 adapters, a one-shard ShardedTensorSearch underneath) on
           the card.  The lab 0-2
           shapes of tests/torch_harness_cases.py beside the port's own
           object checker (same end condition, goal or violation depth,
           and count on runs that end by depth or space; the replayed
           terminal state re-checked with the object predicate), the lab 1
           infinite workload to depth 15 (51 states), a composition with
           no twin (NoTensorTwin), and lab 3's depth-4 count-parity shape
           at full width (85, from the reference's object checker; lab 3's
           search tests run in the labtests phase, held to the pins of
           HARNESS_PINS).  The time-limited lab 1 infinite
           workload may raise CapacityOverflow at depth 16 on the top rung
           of the capacity ladder, where the reference's tensor_bfs raises
           too.  Per search: seconds, unique states/min, peak device
           memory, the ladder rung, and each kernel's launches (both must
           be > 0: kernel 2 inserts each chunk step's keys);
  lab4     the lab 4 twins (specs_lab4: join g=1 and g=2, the part-1
           stores [1, 1], [1, 2, 1] and [[1], [2]] with master timers and
           controller, 2PC tx, multi-server groups): each twin's shape
           (lanes, event slots, packed words, bytes per state); the
           fingerprint kernel bit-exact at each width on the depth-3
           successor rows, seeded random rows and SENTINEL rows; the pinned
           counts through the device loop (join 3 / 10 and 6 / 11, stores
           6 / 23 / 74 / 219 / 606 and 8 / 38 / 142 / 467 / 1411, tx 8 /
           38, multi 10 / 69), each twin's depth-3 run equal to the same
           run on the CPU, and one insert device launch per insert call
           under torch.profiler; the reference's two slow goal searches
           at full width (store [1, 1] GOAL_FOUND 51243 / 310245 at depth
           10, tx GOAL_FOUND 27549 / 129682 at depth 8); and the lab 4
           search tests of tests/torch_lab4_cases.py through the harness
           binding: each join phase (ss-join provenance), then part 2
           test10 (goal ten levels down, then six levels done-pruned),
           test11 and test12 six levels down, part 3 test08 and test09
           (the 2PC twin, goal eight levels down) and the depth-4
           count-parity shape, equal to the port's object checker (219).
           Per search: seconds, unique states/min, peak device memory,
           chunk steps or the ladder rung, and each kernel's launches;
  swarm    the swarm rollout probe (tpu/swarm.py): _step_batch on the
           card bit for bit against per-row _step_one on 128 (row, event)
           pairs (message, timer and undeliverable ids) of the compiled
           flagship and the lab 4 store [1, 1], and on 32 ids outside the
           grid against the CPU; the lock twin (m=8, k=12) twice with one
           seed: a 12-event witness replayed to progress 12, and equal
           raw and minimized traces and counters; the lock twin over
           SWARM_GROUPS = 2 walker groups (mesh=ShardMesh(2)): a verified
           12-event witness, one kernel-1 launch and one kernel-2 launch
           per group at every walk step; the lab 1 deep probe
           (INVARIANT_VIOLATED at depth >= 18, object-verified witness) and
           lab1 test11's two dfs calls (tests/torch_harness_cases.py),
           which the lab test file never reaches, through the port's
           search.dfs (both raise the ladder's top-rung CapacityOverflow,
           as the reference does; the other lab dfs sites run in the
           labtests phase); the reference's slow deep-narrow Paxos
           shape (128 walkers, 90 s), whose verdict, if any, must be
           replay-verified; and both kernels at the walker's shapes.  Per
           search: seconds, walk steps/s, ms per walk step, the aten ops
           one walk step dispatches, rounds, deepest depth, overflow
           restarts, witness sizes and seconds, and each kernel's
           launches;
  labtests the lab test files (tests/test_lab*.py, unedited) through the
           port's driver, run_tests.main(["--lab", N, "--no-run"]) for
           labs 0-4 on the tensor backend on the card, then lab 0's run
           tests (--no-search), each run's results file and output in a
           temporary directory of the checkout.  Every search test passes
           except LABTEST_FAILS (lab1 test11's CapacityOverflow at depth
           16, and four lab 4 tests no twin binds), each with the
           reference's error; lab 3's staged searches with a pin are held to
           HARNESS_PINS; every dfs search launches both kernels, and every
           bfs search that launches kernel 1 launches kernel 2.  Per lab:
           seconds, tests passed, points, the trace-meta fold's host
           seconds beside the level walls (trace_fold), and per test its
           seconds and each search's record (as the harness and swarm
           phases print them); the kernels' launches over the phase (both
           > 0); and no
           module of jax or of the JAX package loaded in the process;
  scenarios symmetry reduction and the fault plane: the partitioned
           flagship (the flagship's spec under the reference's one-era
           partition, make_paxos_partition_spec, goals stripped) at full
           width on the device loop, strict and packed, to depth 7 or
           SCENARIO_SECS: lanes, packed words, outcome, unique
           states/min, peak device memory, partition events (> 0, equal
           to the fault events) and each kernel's launches (> 0); the
           device loop against run_host at depths 1-5 (unique, explored,
           partition events); the zero-budget model (max_eras=0) equal
           to the plain flagship at depth 6; the symmetric
           paxos_spec(5) (120 permutations, DECIDED pruned) raw and
           reduced on both loops (12024 / 170400 and 306 / 4237 at depth
           18), with the canonicalize pass's CUDA-event ms per call and
           share of the run and one call under torch.profiler; the
           reference's pins on both loops (202 -> 50; the partition
           scenario 3416 / 564 / 13 / 320; the lab 3 partition and lab 4
           crash twins at depths 2 and 3) and its witnesses decoded with
           their fault labels (broken quorum, NO_HEAL, NO_CRASH, and a
           swarm on NO_HEAL minimized to CUT, HEAL); and both kernels
           bit-exact against their plain versions on a full chunk of the
           partitioned flagship's successor rows and on canonical rows;
  spill    the host-RAM spill tier, checkpoints and swarm seeding:
           flagship_spill, the compiled flagship in spill mode
           (frontier_cap 2^18, visited_cap 2^20, high water 0.60) to
           depth 9, past the frontier cap where the search phase ends
           CAPACITY_EXHAUSTED, equal in unique, explored and depth to a
           non-spill oracle (frontier_cap 2^22, visited_cap 2^24) with
           spilled keys and respilled rows > 0 and nothing dropped;
           kill_resume, the same flagship in spill mode at visited_cap
           2^18 in a subprocess with a dump per level, SIGKILLed once its
           dump reaches depth 6, resumed in spill mode and by a non-spill
           search (kernel 2 rebuilding the dump's key set), both equal to
           a straight run to depth 8 (316,096 unique); swarm_seed, a BFS
           dump of the swarm phase's Paxos twin seeding a SwarmSearch
           (the pre-seeded table holds the dump's keys) and a seeded lock
           swarm cut after round 1 and resumed, equal to the uncut run
           (verdict, witness, counters); and both kernels bit-exact
           against their plain versions at the path's new shapes
           (kernel 2 on the dump's keys into 2^24 slots, kernel 1 on a
           full drain's [2^18, 842] rows) with CUDA-event times.  Per
           run: seconds, unique states/min, peak device memory, the spill
           counters and drain ms, evictions and spooled segments, the
           dumps' sizes and write seconds, and each kernel's launches;
  supervisor the search supervisor and the warden (tpu/supervisor.py,
           tpu/warden.py) on the compiled packed flagship (strict, chunk
           4096, frontier_cap and visited_cap 2^20) to depth 7 (69,673 /
           301,551): probe_device on the card; a bare TensorSearch run
           and SearchSupervisor(ladder=("device", "host")) fault-free,
           with the pinned counts, zero recovery counters and equal
           kernel launches; two injected transients on a depth-5 chunk
           step (retries 2); an injected torch.cuda.OutOfMemoryError on
           depth 6's first step, re-levelled in place at chunk 2048 from
           the depth >= 4 dump, with memory_allocated before and after the
           failed rung's release; a real 1 TiB allocation caught and
           classified OOM; a fatal fault after the depth-5 dump failed
           over to the host rung (run_host on the card), and a hung stats
           sync abandoned by the 5 s watchdog and failed over, both
           against a bare run to depth 7; a warden child SIGKILLed after
           a durable dump and the next child resumed on the card (ladder
           device, device, host; these children run beside the
           in-process cases above); a warden child hung on a depth-6
           chunk step on the card and reaped at its announced 5 s grace
           plus slack, the next child resumed on the card to the pinned
           counts (the same ladder); and
           portfolio mode on the swarm phase's lock twin (the swarm lane's
           replay-verified 12-event witness, the winning lane).  Per run:
           seconds, peak device memory, the recovery fields and each
           kernel's launches;
  telemetry the telemetry layer (tpu/telemetry.py, tpu/tracing.py) on the
           supervisor phase's flagship to depth 7 (69,673 / 301,551):
           bare and recorded runs in turns (B, R, B, R; R with
           Telemetry.for_checkpoint, the flight log and STATUS.json on),
           with equal counts, equal dispatches per tag (a counting hook),
           equal launches of each kernel and an equal count of
           synchronising CUDA calls (set_sync_debug_mode("warn"), each
           warning recorded), spans equal to dispatches and one level
           record per depth of each attempt of the device loop; per run
           its seconds, and the ratio of the medians, the flight log's
           records and bytes, the p50 / p90 of device.step, .sync and
           .promote and their summed walls (step = the host's launch
           time, sync = device wait), in a process that earlier phases
           have warmed (run alone, the phase first runs once uncounted); a
           run under the torch.profiler window (4 steps), whose Chrome
           trace must hold both kernels, and its device ms;
           the supervisor with a recorder and one transient on a depth-5
           step (rung and retry events, the spans' retries summing to the
           outcome's); and a traced warden ladder (device, device, host)
           whose first child hangs on depth 6's first step after a dump,
           is reaped at its grace and resumed on the card to the pins: the
           run dir's flight log keeps the dead child's open device.step,
           watch names it, tracing.assemble gives both children under the
           trace with every parent in the tree, and ``python -m
           dslabs_tpu_torch.tpu.telemetry report|trace`` exit 0;
  analysis the analysis layer (dslabs_tpu_torch/analysis/): the hot-path
           audit's sync rules on primitive calls
           (dslabs_tpu_torch/analysis/sync_cases.py: each call's
           synchronising CUDA calls equal to the table, to the audit's
           count on the card and on the CPU); the conformance linter over
           the port's tree (zero findings, its seconds); the hot-path
           audit's standard set (run_jaxpr: the pingpong engine, the
           compiled paxos_spec(3) with symmetry, the spill variant and
           the swarm) on the card with zero findings,
           the rebuild check included; and the compiled packed flagship
           and the hand flagship at full width (chunk 4096, frontier_cap
           2^20, visited_cap 2^24) audited site by site.  For every site
           the synchronising CUDA calls of one call (after an uncounted
           warm-up) under set_sync_debug_mode("warn") must equal the
           audit's count on the card, its count on the CPU (the audit set
           on the CPU; the flagships at chunk 16) and the site's budget;
           the flagships' chunk step takes 1 sync packed and 0 by the hand
           twin.  Per site: the counts and the aten ops of one call (the
           host's issue work); per flagship: the chunk step's syncs and
           ops, the kernels' launches over its audit;
  lanes    batched job lanes (tpu/lanes.py) on the compiled packed
           flagship at full width (strict, frontier_cap and visited_cap
           2^20, chunk 1024, so that a lane step at L=4 holds the solo
           step's 4,096 rows): four solo runs to depth 8 at chunk 4096,
           then four identical jobs in one batch, each lane at the pins
           (316,096 / 1,495,288), with one superstep per level and the
           batch's dispatches per job at most 0.5x a solo run's (its wall
           against the four solo walls is recorded, not gated); a mixed
           batch of more jobs than lanes with per-job depth limits
           (LANE_MIXED; lanes refilled, swaps >= 2), each job equal to a
           solo device-loop run of it; a LaneBatchWarden child on the card
           SIGKILLed after its lanes' depth-4 dumps (classified oom, the
           batch run dir's STATUS.json with its per-lane block) and
           respawned, the new child resuming every lane on the card from
           its own dump (resumed_from_depth 4), each lane equal to its
           solo run (these children run beside the mixed batch and the
           next one); and a poisoned lane (the
           lab 1 wide twin at visited_cap 64, where the solo run raises)
           evicted beside a max_depth=3 mate equal to its solo run.  Per
           batch: seconds, unique states/min summed over the lanes, peak
           device memory, lane steps, levels, swaps, dispatches by tag and
           each kernel's launches, inside the supersteps kernel 1 once and
           kernel 2 L times per lane step;
  service  the checking service (service/) on the card, run beside the
           spill phase (it launches no kernel in this process; its
           children do), admission on (the port's conformance linter
           gates every job in a child off the card): two tenants' jobs
           (two pingpong jobs and one lab 1 client/server job each)
           drained solo by a CheckServer (memo off, lanes=0, one worker,
           one warden child per job), the same
           jobs (the last submitted with ``python -m
           dslabs_tpu_torch.service submit --no-memo``, the queue read
           with ``status``) drained in lane batches by the CLI's ``drain
           --lanes 4 --workers 1 --no-memo``, and the same jobs drained by
           a CheckServer with the memo on (admission off, lanes=0, one
           worker; the three servers side by side), every command exiting
           0: equal
           verdicts, per-tenant COSTS explored and unique equal between
           the solo and lanes drains, the lanes drain's dispatches per job
           at most 0.5x the solo drain's, each batch's lane shares summing
           to 1, SERVER_STATUS.json's lanes block equal to the drain
           summary's, a lane job's causal tree (tracing.assemble on the
           service root) holding its batch's shared spans; in the memo
           drain every job whose identical twin ran first (four of six,
           unless a lab 1 end is one the memo never caches) a memo_hit
           with no warden child and no flight log, whose causal tree has
           the memo node.  Seconds of each step, dispatches per job,
           device seconds, the memo block;
  memo     cross-job memoization (service/memo.py) in process at full
           width: the compiled packed flagship (caps 2^20, chunk 4096)
           introspected (a strong spec fingerprint, its seconds); a cold
           run to depth 6 with a dump per level and its per-level archive
           (TensorSearch(levels_dir=)), archived with its verdict; the
           warm start planned for depth 7 from the depth-6 seed, resumed
           to the depth-7 pins (69,673 / 301,551); the exact hit planned
           for depth 6 (no search, no launch); the flagship with its
           heartbeat-reply handler edited (memo_edited_flagship) planned
           incremental (levels skipped >= 1) and resumed, equal to a cold
           run of the edited spec; both kernels bit-exact against their
           plain versions at the path's new shapes (kernel 2 rebuilding
           the seed's key set into 2^20 slots, kernel 1 on the seed's
           frontier rows) with CUDA-event times.  Per run: seconds,
           unique states/min, peak device memory, the resumed depth and
           each kernel's launches;
  search   the main path at full size: the compiled flagship, packed
           (strict, visited_cap 2^24, frontier_cap 2^20, chunk 4096, depth
           10 or SEARCH_MAX_SECS): outcome, unique states/min, peak device
           memory, bytes per state, chunk steps, and the launch count of
           each kernel during that run (each must be > 0);
  sharded  the owner-sharded engine (tpu/sharded.py) at full width: the
           compiled packed flagship on ShardedTensorSearch at D = 1 and
           D = 4 (chunk_per_device 4096 // D, caps 2^17 / 2^20 per shard)
           to depth 8, each at the pins (316,096 / 1,495,288), with one
           sharded.superstep per level, each superstep's synchronising
           calls (sync debug mode) equal to 1 + its chunk steps, kernel 1
           launched once per chunk step and kernel 2 D times (plus the
           root's); per run: seconds, unique states/min beside the search
           phase's solo rate, peak device memory, the per-shard frontier
           occupancies and their worst imbalance; both kernels bit-exact
           against their plain versions on inputs captured from a D = 4
           run (kernel 1 on the chunk step's [D*C*B, 842] rows, kernel 2 on
           a shard's table with the D*bucket received keys) with CUDA-event
           times; a D = 4 run dumped at depth 6 and resumed at D = 2 and on
           the solo engine to the depth-8 pins; pruned pingpong and lab 1
           at D = 1, 2, 4 and 8 at their pins; a swarm dump cut at 8
           walkers resumed at 4 and 16 with the uncut run's verdict;
  elastic  the supervisor's and the warden's sharded rung and the elastic
           width ladder (tpu/supervisor.py, tpu/warden.py) on the compiled
           packed flagship at ShardMesh(4) (chunk_per_device 1024, the
           sharded phase's caps) to depth 8: a fatal fault at the level-6
           superstep degrades the rung to width 2, which resumes the
           checkpoint re-sharded and lands the pins (316,096 / 1,495,288)
           with mesh_shrinks 1 and one mesh_shrunk event (4 -> 2); two
           transients inside the level-2 superstep retried in place at
           width 4; a warden child at width 4 SIGKILLed after a durable
           dump and its width-2 child resumed to the pins on the card
           (these children run beside the in-process cases); both kernels
           bit-exact against their plain versions at the width-2 rung's
           shapes with CUDA-event times;
  chaos    tpu/chaos.py's seeded soak (seed 1, 24 faults) on strict lab 1
           at ShardMesh(8): the fault-free baseline at its pins (8 / 23),
           then the chaos run on the elastic ladder with a checkpoint per
           level, with exact parity, no dropped state, at least one mesh
           shrink and one knob shrink, and a hang among the fired faults;
           the fired count, sites and kinds;
  ranks    the sharded engine over ranks (tpu/ranks.py, the process-group
           exchange of tpu/mesh_exchange.py): two gloo ranks sharing
           cuda:0 run the compiled packed flagship at width 2
           (chunk_per_device 2048, the sharded phase's caps) to depth 8,
           whose rank-0 outcome must hold the pins (316,096 / 1,495,288)
           and the per-shard frontier and explored lanes of every level
           of the LocalExchange run at D = 2, whose captured inputs hold
           both kernels bit-exact against their plain versions at a
           rank's shapes (kernel 1 on one shard's [192,512, 842] rows,
           kernel 2 on one shard's received keys), with CUDA-event
           times; per rank its chunk steps,
           launches of both kernels (kernel 2 once per chunk step and
           once at the root, kernel 1 once per chunk step and twice at
           the root), peak device memory and seconds, and the bytes and
           collectives each level exchanged; the hot-path audit of the
           engine's sites on both ranks (gloo stages card tensors through
           the host), every sharded site's syncs at its budget; the
           ranks' depth-6 dump (the state a run cut there leaves)
           resumed in-process at width 1 to the pins; rank 1 raising a
           fatal error at the level-5 superstep, after which the elastic
           supervisor's next rung (the device loop) resumes the ranks'
           last dump to the pins, with the rungs it stepped; and NCCL
           ranks across the cards to the pins where the machine has two
           or more (else a line that says NCCL did not run on one card).

Then one line ``{"kernels": [...]}`` with every kernel's numbers (its
launches those of the search, swarm, labtests, scenarios, spill,
supervisor, telemetry, analysis, lanes, memo, sharded, elastic and chaos
phases' runs, and the ranks' own counts of the ranks phase), the
card's name and power limit as nvidia-smi prints them, and last
``{"ok": true, "device": {...}}``.  Any mismatch or error exits non-zero
before the last line.  Without CUDA, or without the package beside it,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
# Where this run and its child processes keep compiled bytecode (listed
# in .gitignore; see bytecode_cache).
BYTECODE_CACHE = os.path.join(ROOT, ".pycache")

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
# Depth of the compiled and trace phases' flagship runs: deep enough that
# most chunks are full (4096 states).
FLAGSHIP_DEPTH = 8
# Depth of the profile phase's flagship runs, cut from 8 for the script's
# 1,200 s limit: torch.profiler's processing of ~7,400 device records per
# chunk step is most of the phase (134-176 s at depth 8 on H100 hosts,
# 49 s at depth 6).  At depth 6 the run has 12 chunk steps, against 38 at
# depth 8, and fewer of its chunks are full, so the phase's busy share
# and launches per chunk step are not comparable with depth-8 figures.
PROFILE_DEPTH = 6
# bench.py's flagship configuration.
FLAGSHIP_KW = dict(n=3, n_clients=2, w=1, max_slots=3, net_cap=64,
                   timer_cap=6)


_EMIT_LOCK = threading.Lock()


def emit(obj) -> None:
    # One line per call, whole, also from the service phase's thread.
    with _EMIT_LOCK:
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


def timed_search(torch, mods, ts, resume: bool = False):
    """``ts.run(resume=resume)`` with every kernel count set to 0 just
    before and read just after -> (outcome, record of its key, seconds,
    unique/min, peak device memory, bytes per state, chunk steps and the
    launches of each kernel)."""
    kernels, visited = mods["kernels"], mods["visited"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.LAUNCHES["fingerprint_rows"] = 0
    visited.LAUNCHES["insert"] = 0
    steps0 = ts.chunk_steps
    t0 = time.time()
    o = ts.run(resume=True) if resume else ts.run()
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


# Seconds a profiled region waits, after its last synchronize and outside
# its timed part, before the profiler stops: without it the card's trace
# lost the tail of a session's device records (the last few hundred to
# few thousand) in about half of the short runs that followed the big
# profiled phases, so lab 4's one-launch-per-insert check saw the last
# insert missing three runs in a row; with it, no such tail was lost.
PROFILE_SETTLE_SECS = 0.2


class KernelStat:
    """One name of a profiled run's device activity: ``key``, ``count``
    (launches) and ``self_device_time_total`` (summed device
    microseconds), the fields of a ``key_averages()`` entry the phases
    read."""

    def __init__(self, key: str):
        self.key, self.count, self.self_device_time_total = key, 0, 0.0


def device_kernels(torch, prof) -> list:
    """A finished torch.profiler run's CUDA entries, summed by name
    straight from its kineto events: the entries ``key_averages()`` gives
    for the device (an async record counted with no time, as there), less
    its processing, which builds an event object, and a tree, of every
    record first and took longer than the runs of 90,000-280,000
    launches it read."""
    cuda = torch.autograd.DeviceType.CUDA
    stats = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda:
            continue
        name = ev.name()
        s = stats.get(name)
        if s is None:
            s = stats[name] = KernelStat(name)
        s.count += 1
        if not (ev.is_async() or ev.start_thread_id() != ev.end_thread_id()):
            s.self_device_time_total += (ev.end_ns() - ev.start_ns()) / 1e3
    return list(stats.values())


def profiled_call(torch, fn):
    """One ``fn()`` under torch.profiler (device activity) -> (device ms,
    device launches)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_SECS)
    kern = device_kernels(torch, prof)
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
    # Each once: the equal counts are the check; the seconds beside each
    # other are one call's reading, not a ranked comparison.
    for label, p, packed in (
            ("compiled_packed", fl, True), ("hand", hand, True),
            ("compiled_unpacked", fl, False)):
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
    """Device milliseconds of one :class:`KernelStat`."""
    return e.self_device_time_total / 1e3


def profiled_run(torch, ts):
    """``ts.run()`` under torch.profiler -> (outcome, wall ms, CUDA kernel
    entries (:func:`device_kernels`), summed device ms).  Device activity
    only: host-side op events would multiply the trace (about four per
    kernel)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        o = ts.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_SETTLE_SECS)
    kern = device_kernels(torch, prof)
    busy_ms = sum(dev_ms(e) for e in kern)
    check(busy_ms > 0, "torch.profiler recorded no device time")
    return o, wall_ms, kern, busy_ms


def profiled_inserts(torch, mods, ts, label: str):
    """``ts.run()`` under torch.profiler (:func:`profiled_run`) with the
    insert wrapper's calls counted beside the insert kernel's device
    launches in the trace, which must be equal: one launch per call.
    torch.profiler drops device records at random (the same depth-8
    flagship run showed 4-37 fewer of its ~282,000 launches from one
    profiled run to the next), so a run whose trace holds fewer insert
    launches than calls is profiled again, twice at most; more launches
    than calls fails at once.  -> (outcome, wall ms, kernel entries,
    busy ms, insert calls, chunk steps, profiled runs)."""
    visited = mods["visited"]
    for runs in (1, 2, 3):
        calls0, steps0 = visited.LAUNCHES["insert"], ts.chunk_steps
        o, wall_ms, kern, busy_ms = profiled_run(torch, ts)
        calls = visited.LAUNCHES["insert"] - calls0
        launches = sum(e.count for e in kern
                       if PORT_KERNELS["insert"].search(e.key))
        check(launches <= calls,
              f"{label}: insert: {launches} device launches for {calls} "
              "calls (one each expected)")
        if launches == calls:
            return (o, wall_ms, kern, busy_ms, calls,
                    ts.chunk_steps - steps0, runs)
    raise AssertionError(
        f"{label}: insert: {launches} device launches for {calls} calls "
        "(one each expected) in 3 profiled runs")


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
    engine = mods["engine"]
    ts = engine.TensorSearch(proto, visited_cap=1 << 24,
                             frontier_cap=1 << 20, chunk=4096,
                             max_depth=depth)
    warm = ts.run()                            # warm-up, unprofiled
    (o, wall_ms, kern, busy_ms, insert_calls, chunk_steps,
     profiled_runs) = profiled_inserts(torch, mods, ts, f"profile {twin}")
    check((o.unique_states, o.states_explored, o.depth)
          == (warm.unique_states, warm.states_explored, warm.depth),
          f"profiled search differs from its warm-up: {o} vs {warm}")
    port_ms = {name: sum(dev_ms(e) for e in kern if pat.search(e.key))
               for name, pat in PORT_KERNELS.items()}
    check(all(v > 0 for v in port_ms.values()),
          f"profiled search ran no ported kernel: {port_ms}")
    launches = sum(e.count for e in kern)
    emit({"phase": "profile", "twin": twin, "depth": o.depth,
          "end": o.end_condition,
          "unique": o.unique_states, "explored": o.states_explored,
          "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / wall_ms,
          "port_kernels_ms": port_ms,
          "insert_calls": insert_calls,
          "insert_device_launches": insert_calls,
          "profiled_runs": profiled_runs,
          "device_launches": launches, "chunk_steps": chunk_steps,
          "device_launches_per_chunk_step": launches / chunk_steps,
          "top_kernels": top_kernels(kern)})


def phase_trace(torch, mods, depth: int):
    """The trace-recording host loop on the card: the flagship to
    ``depth`` through the device loop and then through run_host, then two
    goal searches whose traces are checked."""
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

    flagship = [timed(False), timed(True)]
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


# Pins of lab 3's searches (the harness phase's depth-4 shape, and the
# staged searches of the lab test file's test20, test21 and test22 in the
# labtests phase), from the reference's object checker
# (dslabs_tpu.search.search.BFS) on the CPU over the builders of
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


class HarnessRuns:
    """Lab searches through the port's ``search.bfs`` with the tensor
    backend on the card, as a lab test runs them.  Inside the ``with``
    block the backend is ``tensor`` and ``backend._run_tensor`` is wrapped
    to keep each search's engine and outcome; :meth:`search` runs one
    search with the kernel counts set to 0 just before it and records its
    seconds, unique states/min, peak device memory, the capacity-ladder
    rung taken and the kernels' launches (the fingerprint's must be
    > 0)."""

    def __init__(self, torch, mods):
        from dslabs_tpu_torch.tpu import backend

        self.torch, self.mods, self.backend = torch, mods, backend
        self.records = {}
        self._runs = []
        self._run_tensor = backend._run_tensor

    def __enter__(self):
        from dslabs_tpu_torch.utils.flags import GlobalSettings

        GlobalSettings.search_backend = "tensor"

        def spy(*a, **kw):
            self._runs.append(self._run_tensor(*a, **kw))
            return self._runs[-1]

        self.backend._run_tensor = spy
        return self

    def __exit__(self, *exc):
        from dslabs_tpu_torch.utils.flags import GlobalSettings

        self.backend._run_tensor = self._run_tensor
        GlobalSettings.search_backend = "object"

    def search(self, name, case):
        """One search through search.bfs on the card -> (results or the
        CapacityOverflow it raised, record)."""
        from dslabs_tpu_torch.search import search as osearch
        from dslabs_tpu_torch.tpu.engine import CapacityOverflow
        from tests import torch_harness_cases as H

        torch = self.torch
        kernels, visited = self.mods["kernels"], self.mods["visited"]
        del self._runs[:]
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
            search, outcome, _ = self._runs[-1]
            rec.update(
                end=H.end_name(res), depth=H.terminal_depth(res),
                unique=res.discovered_count,
                unique_per_min=res.discovered_count / secs * 60,
                tensor_end=outcome.end_condition,
                tensor_depth=outcome.depth,
                rung=[f for f, _ in self.backend._LADDER].index(
                    search.frontier_cap))
        check(rec["launches"]["fingerprint_rows"] > 0
              and rec["launches"]["insert"] > 0,
              f"harness {name}: a kernel never launched: "
              f"{rec['launches']}")
        self.records[name] = rec
        return res, rec


def phase_harness(torch, mods):
    """Lab search tests through the harness binding on the card
    (:class:`HarnessRuns`).  The lab 0-2 shapes run beside the port's own
    object checker in this process; the lab 3 count-parity shape is held
    against HARNESS_PINS."""
    from dslabs_tpu_torch.search import search as osearch
    from tests import torch_harness_cases as H

    P = H.Pkg("dslabs_tpu_torch")
    with HarnessRuns(torch, mods) as hr:
        for name in sorted(H.LAB02):
            build = H.LAB02[name]
            res, rec = hr.search(name, build(P))
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
        res, rec = hr.search("lab1_infinite_d15",
                             H.lab1_infinite_depth(P, depth))
        check(rec["end"] == "SPACE_EXHAUSTED" and rec["unique"] == count,
              f"harness lab1_infinite_d15: {rec}")
        try:
            hr.search("no_twin", H.Case(H.no_twin_state(P),
                                        P.SearchSettings(), ()))
        except hr.backend.NoTensorTwin:
            hr.records.pop("no_twin", None)
        else:
            raise AssertionError("harness no_twin: no NoTensorTwin raised")

        def lab3(name, case):
            res, rec = hr.search(name, case)
            end, depth, count = HARNESS_PINS[name]
            check(rec["end"] in case.expect, f"harness {name}: {rec}")
            if rec["end"] == end:
                check((depth is None or rec["depth"] == depth)
                      and (count is None or rec["unique"] == count),
                      f"harness {name}: {rec} against pin {end, depth, count}")
            return res

        # Lab 3's test20, test21 and test22 run in the labtests phase,
        # from the lab test file.
        lab3("lab3_depth4", H.lab3_depth4(P))
    emit({"phase": "harness", "searches": hr.records})


# The lab 4 twins of the lab4 phase: name -> (factory over specs_lab4,
# chunk, {depth: pinned unique states}).  Pins: the JAX package's
# tests/test_spec_parity.py (join, tx) and tests/test_tpu_lab4.py
# docstrings (part-1 stores, depths 1-5); the multi-server twin's 10 / 69
# from its JAX twins on the CPU (python -m tests.torch_lab4_cases).  The
# [[1], [2]] store with master timers and the controller modelled has no
# pin: it is held against the same search on the CPU.
LAB4_TWINS = {
    "join_g1": (lambda L: L.make_join_protocol(1), 1024, {1: 3, 3: 10}),
    "join_g2": (lambda L: L.make_join_protocol(2), 1024, {2: 6, 3: 11}),
    "store_11": (lambda L: L.make_shardstore_protocol([1, 1]), 1024,
                 {1: 6, 2: 23, 3: 74, 4: 219, 5: 606}),
    "store_121": (lambda L: L.make_shardstore_protocol([1, 2, 1]), 1024,
                  {1: 8, 2: 38, 3: 142, 4: 467, 5: 1411}),
    "store_1_2_full": (lambda L: L.make_shardstore_protocol(
        [[1], [2]], model_master_timers=True, model_ctl=True), 1024, {}),
    "tx_1": (lambda L: L.make_shardstore_tx_protocol(1), 1024,
             {1: 8, 2: 38}),
    "multi": (lambda L: L.make_shardstore_multi_protocol(), 512,
              {1: 10, 2: 69}),
}
# The reference's slow goal tests, on the card through the device loop:
# name -> (factory, max_depth, pinned [end, unique, explored, depth]) at
# chunk 1024 and frontier_cap 2^18; the pins are one run of the JAX
# package's TensorSearch with the same arguments on the CPU
# (python -m tests.torch_lab4_cases).
LAB4_GOALS = {
    "store_11_goal": (lambda L: L.make_shardstore_protocol([1, 1]), 11,
                      ["GOAL_FOUND", 51243, 310245, 10]),
    "tx_1_goal": (lambda L: L.make_shardstore_tx_protocol(1), 14,
                  ["GOAL_FOUND", 27549, 129682, 8]),
}
# Levels below the joined root at which the harness goals are found:
# part 2 test10 and part 3 test08 (the store twin's goal depth), part 3
# test09 (the object checker's goal depth).
LAB4_GOAL_LEVELS = {"p2_test10": 10, "p3_test08": 10, "p3_test09": 8}


def phase_lab4(torch, mods):
    """The lab 4 twins on the card: shapes, the fingerprint kernel
    bit-exact at their widths, their pinned counts through the device loop
    (each twin's depth-3 run equal to the same run on the CPU, insert
    device launches equal to insert calls), the reference's two slow goal
    searches at full width, and the lab 4 search tests through the
    harness binding."""
    engine, kernels = mods["engine"], mods["kernels"]
    from dslabs_tpu_torch.tpu import specs_lab4 as L

    def key(o):
        return [o.end_condition, o.unique_states, o.states_explored, o.depth]

    t_part = time.time()
    shapes, fps, pins = {}, {}, {}
    gen = torch.Generator().manual_seed(4)
    sentinel = engine.SENTINEL
    for name, (make, chunk, pinned) in LAB4_TWINS.items():
        p = dataclasses.replace(make(L), goals={})
        ts = engine.TensorSearch(p, chunk=chunk, visited_cap=1 << 20)
        pk = ts._pk
        shapes[name] = dict(
            lanes=ts.lanes, node_lanes=p.node_width, nodes=p.n_nodes,
            event_slots=ts._num_events(), packed_words=ts.plane,
            bytes_per_state=(pk.bytes_per_state if pk is not None
                             else ts.lanes * 4))
        # Depth 3 on the card, with the fingerprint's inputs kept: its
        # last call holds the successor rows of the depth-3 level.
        seen = []
        fp_kernel = kernels.fingerprint_rows

        def spy(flat, seen=seen, fp_kernel=fp_kernel):
            seen[:] = [flat]
            return fp_kernel(flat)

        kernels.fingerprint_rows = spy
        try:
            o3, rec3 = timed_search(torch, mods, engine.TensorSearch(
                p, chunk=chunk, visited_cap=1 << 20, max_depth=3))
        finally:
            kernels.fingerprint_rows = fp_kernel
        t = time.time()
        cpu = engine.TensorSearch(p, chunk=64,
                                  visited_cap=1 << 20, max_depth=3,
                                  device="cpu").run()
        cpu_secs = time.time() - t
        check(key(cpu) == rec3["key"],
              f"lab4 {name} depth 3: card {rec3['key']} vs CPU {key(cpu)}")
        runs = {3: dict(rec3, cpu_secs=cpu_secs)}
        deepest = max(pinned, default=3)
        for d in sorted(pinned):
            if d == 3:
                continue
            ts_d = engine.TensorSearch(p, chunk=chunk, visited_cap=1 << 20,
                                       max_depth=d)
            if d == deepest:
                # The deepest run under the profiler: one insert device
                # launch per insert call.
                o, wall_ms, _, busy_ms, calls, _, n_prof = \
                    profiled_inserts(torch, mods, ts_d, f"lab4 {name} d{d}")
                check(calls > 0, f"lab4 {name} depth {d}: no insert call")
                runs[d] = dict(key=key(o), wall_ms=wall_ms,
                               device_busy_share=busy_ms / wall_ms,
                               insert_calls=calls,
                               insert_device_launches=calls,
                               profiled_runs=n_prof)
            else:
                runs[d] = timed_search(torch, mods, ts_d)[1]
        for d, want in pinned.items():
            check(runs[d]["key"][1] == want
                  and runs[d]["key"][0] == "DEPTH_EXHAUSTED",
                  f"lab4 {name} depth {d}: {runs[d]['key']} vs pin {want}")
        check(all(v > 0 for v in rec3["launches"].values()),
              f"lab4 {name}: a kernel was not launched: {rec3}")
        pins[name] = runs

        # The fingerprint kernel at this width: the depth-3 successor
        # rows, seeded random rows and SENTINEL rows, bit-exact.
        lanes = ts.lanes
        rand = torch.randint(-2 ** 31, 2 ** 31 - 1, (4096, lanes),
                             generator=gen, dtype=torch.int32).cuda()
        sent = torch.full_like(rand[:64], sentinel)
        mixed = torch.where(torch.rand((4096, lanes), generator=gen)
                            .cuda() < 0.3, sentinel, rand)
        cases = dict(depth3_successors=seen[-1], random=rand,
                     sentinel=sent, mixed=mixed)
        errs = {}
        for cname, flat in cases.items():
            k = kernels.fingerprint_rows(flat)
            pl = engine.row_fingerprints(flat)
            torch.cuda.synchronize()
            errs[cname] = [list(flat.shape), int(
                (k.to(torch.int64) - pl.to(torch.int64)).abs().max())]
            check(errs[cname][1] == 0,
                  f"lab4 {name}: fingerprint_rows {cname} {errs[cname]}")
        fps[name] = errs
    emit({"phase": "lab4", "part": "twins", "secs": time.time() - t_part,
          "shapes": shapes, "fingerprint": fps, "pins": pins})

    t_part = time.time()
    goals = {}
    for name, (make, depth, want) in LAB4_GOALS.items():
        ts = engine.TensorSearch(make(L), chunk=1024, frontier_cap=1 << 18,
                                 max_depth=depth)
        o, rec = timed_search(torch, mods, ts)
        check(rec["key"] == want and all(
            v > 0 for v in rec["launches"].values()),
              f"lab4 {name}: {rec} vs pin {want}")
        goals[name] = rec
    emit({"phase": "lab4", "part": "goals", "secs": time.time() - t_part,
          "goals": goals})

    lab4_harness(torch, mods)


def lab4_harness(torch, mods):
    """The lab 4 search tests through the harness binding on the card
    (:class:`HarnessRuns`): each join phase, then the main phases of
    tests/torch_lab4_cases.py's shapes; the count-parity shape also on
    the port's object checker in this process."""
    from dslabs_tpu_torch.search import search as osearch
    from tests import torch_harness_cases as H
    from tests import torch_lab4_cases as C

    P = H.Pkg("dslabs_tpu_torch")
    t_part = time.time()
    with HarnessRuns(torch, mods) as hr:
        for name, (groups, shards, build) in C.SHAPES.items():
            joined = C.joined_state(
                P, groups, shards,
                run=lambda case, n=name: hr.search(f"{n}_join", case)[0])
            check(joined._tensor_provenance.key[0] == "ss-join",
                  f"lab4 {name}: join provenance "
                  f"{joined._tensor_provenance.key}")
            for i, case in enumerate(build(P, joined)):
                label = f"{name}_{i}"
                res, rec = hr.search(label, case)
                rec["root_depth"] = joined.depth
                check(rec["end"] in case.expect, f"lab4 {label}: {rec}")
                if rec["end"] == "GOAL_FOUND":
                    check(rec["depth"] == joined.depth
                          + LAB4_GOAL_LEVELS[name]
                          and any(p.check(H.terminal(res)).value
                                  for p in case.settings.goals),
                          f"lab4 {label}: goal {rec}")
                if name == "count_parity":
                    obj = osearch.BFS(case.settings).run(case.state)
                    rec["object"] = dict(end=H.end_name(obj),
                                         unique=obj.discovered_count)
                    check(rec["end"] == H.end_name(obj) == "SPACE_EXHAUSTED"
                          and rec["unique"] == obj.discovered_count,
                          f"lab4 {label}: {rec}")
    emit({"phase": "lab4", "part": "harness", "secs": time.time() - t_part,
          "searches": hr.records})


# The lab 4 shapes no twin binds, in either package: the NoTensorTwin
# text of the JAX package's binding on the same shapes
# (tests/test_torch_lab4_harness.py holds the port's equal to it).
ONE_SERVER_PER_GROUP = ("shardstore twin models ONE server per group "
                        "(group 1 has several) — use the multi-server twin "
                        "shapes")
ONE_TX_CLIENT = "shardstore twin models exactly one tx-workload client " \
                "(found 2)"
# The wall budget of the reference's slow deep-narrow Paxos shape
# (tests/test_swarm.py:398), for the swarm alone.
PAXOS_DEEP_SECS = 90.0


class SwarmRuns:
    """Swarm runs on the card with their kernel counts: inside the
    ``with`` block every ``SwarmSearch.run`` is recorded (the search and
    its outcome) and every witness pipeline is timed, so a probe inside
    ``search.dfs`` is seen as well as a swarm run directly."""

    def __init__(self, torch, mods):
        from dslabs_tpu_torch.tpu import swarm

        self.torch, self.mods, self.swarm = torch, mods, swarm
        self.runs = []
        self.witness_secs = []

    def __enter__(self):
        swarm = self.swarm
        self._run, self._build = swarm.SwarmSearch.run, swarm.build_witness
        run, build = self._run, self._build

        def spy_run(sw, *a, **kw):
            out = run(sw, *a, **kw)
            self.runs.append((sw, out))
            return out

        def spy_build(*a, **kw):
            t = time.time()
            w = build(*a, **kw)
            self.witness_secs.append(time.time() - t)
            return w

        swarm.SwarmSearch.run = spy_run
        swarm.build_witness = spy_build
        return self

    def __exit__(self, *exc):
        self.swarm.SwarmSearch.run = self._run
        self.swarm.build_witness = self._build

    def reset(self):
        """Set every kernel count to 0 and forget earlier runs."""
        self.torch.cuda.synchronize()
        self.mods["kernels"].LAUNCHES["fingerprint_rows"] = 0
        self.mods["visited"].LAUNCHES["insert"] = 0
        del self.runs[:]
        del self.witness_secs[:]

    def launches(self):
        self.torch.cuda.synchronize()
        return {"fingerprint_rows":
                self.mods["kernels"].LAUNCHES["fingerprint_rows"],
                "insert": self.mods["visited"].LAUNCHES["insert"]}

    def record(self, i=-1):
        """Swarm run ``i`` (the last by default): verdict, fleet
        statistics, walk steps per second and milliseconds per walk step
        (host clock around the rounds, one sync per step), warm-up and
        witness seconds, and the aten ops one walk step and one
        ``_step_batch`` of its fleet dispatch (counted after the run, on a
        fresh carry)."""
        if not self.runs:
            return None
        sw, out = self.runs[i]
        steps = sw.walk_steps
        rec = dict(end=out.end_condition, walk_steps=steps,
                   walk_secs=sw.walk_secs,
                   walk_steps_per_s=steps / max(sw.walk_secs, 1e-9),
                   ms_per_walk_step=sw.walk_secs / max(steps, 1) * 1e3,
                   compile_secs=out.compile_secs, lanes=sw.lanes,
                   stats=out.swarm)
        counts = (self.mods["kernels"].LAUNCHES,
                  self.mods["visited"].LAUNCHES)
        before = [dict(c) for c in counts]
        carry = sw._init_carry(sw.initial_state())
        rec["ops_per_walk_step"] = dispatched_ops(lambda: sw._walk(carry))
        rec["ops_per_step_batch"] = dispatched_ops(
            lambda: sw._step_batch(carry["rows"], carry["depths"]))
        # The counted walk step's launches are not the run's.
        for c, b in zip(counts, before):
            c.update(b)
        if out.witness is not None:
            w = out.witness
            rec["witness"] = dict(
                raw=len(w.raw_trace), trace=len(w.trace),
                passes=w.minimize_passes, verified=w.replay_verified,
                object_verified=w.object_verified,
                secs=self.witness_secs[-1] if self.witness_secs else None)
        return rec


def dispatched_ops(fn) -> int:
    """The aten ops ``fn()`` dispatches: the host's dispatch work of an eager
    step (on the card most are one kernel launch each)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        fn()
    return count.n


def reachable_rows(torch, ts, depth, gen, keep=32):
    """Rows of levels 0..depth of ``ts``'s twin on its device, each level
    expanded by every grid event through ``_step_batch`` and subsampled
    to ``keep`` rows by ``gen``."""
    p = ts.p
    grid = p.net_cap + p.n_nodes * p.timer_cap + ts._ev_flt
    from dslabs_tpu_torch.tpu.engine import flatten_state

    rows = flatten_state(ts.initial_state())
    levels = [rows]
    for _ in range(depth):
        succ, ok, over = ts._step_batch(
            rows.repeat_interleave(grid, 0),
            torch.arange(grid, device=rows.device).repeat(rows.shape[0]))
        rows = torch.unique(succ[ok & (over == 0)], dim=0)
        if len(rows) > keep:
            rows = rows[torch.randperm(len(rows), generator=gen)[:keep]
                        .to(rows.device)]
        levels.append(rows)
    return torch.cat(levels)


def swarm_step_parity(torch, mods, name, proto, gen):
    """``_step_batch`` on the card against per-row ``_step_one`` on the
    card, bit for bit, on 128 (row, event) pairs of reachable rows with
    message ids (deliverable or not) and timer ids; and on 32 pairs with
    ids outside the grid, which ``_step_one`` refuses, against
    ``_step_batch`` on the CPU."""
    engine = mods["engine"]
    t0 = time.time()
    ts = engine.TensorSearch(proto, chunk=16, device="cuda")
    p = ts.p
    grid = p.net_cap + p.n_nodes * p.timer_cap
    rows = reachable_rows(torch, ts, 2, gen)
    idx = torch.randint(0, len(rows), (160,), generator=gen)
    ev = torch.randint(0, grid, (160,), generator=gen)
    ev[:40] = p.net_cap + torch.randint(0, grid - p.net_cap, (40,),
                                        generator=gen)
    ev[128:144] = -torch.randint(1, 4, (16,), generator=gen)
    ev[144:] = grid + torch.randint(0, 6, (16,), generator=gen)
    pick = rows[idx.to("cuda")]
    succ, ok, over = ts._step_batch(pick, ev.to("cuda"))
    for i in range(128):
        r1, v1, o1 = ts._step_one(pick[i], int(ev[i]))
        check(torch.equal(r1, succ[i]) and bool(v1) == bool(ok[i])
              and int(o1) == int(over[i]),
              f"swarm step parity {name}: pair {i} (event {int(ev[i])}) "
              "differs from _step_one")
    cpu = engine.TensorSearch(proto, chunk=16, device="cpu")
    s_c, ok_c, over_c = cpu._step_batch(pick[128:].cpu(), ev[128:])
    check(torch.equal(s_c, succ[128:].cpu())
          and torch.equal(ok_c, ok[128:].cpu())
          and torch.equal(over_c, over[128:].cpu()),
          f"swarm step parity {name}: ids outside the grid differ from "
          "the CPU")
    return dict(lanes=ts.lanes, grid=grid, pairs=128, outside_grid=32,
                valid=int(ok[:128].sum()), timer_ids=40,
                overflowed=int((over[:128] > 0).sum()),
                secs=time.time() - t0)


def swarm_kernel_times(torch, mods, lanes_list, gen):
    """Both kernels at the walker's shapes: the fingerprint of 128 rows
    at each probe twin's width and the insert of 128 keys into a 2^18-slot
    table already holding 2^14 keys; bit-exact against the plain versions,
    timed as in the kernels phase beside their bounds."""
    kernels, visited, engine = mods["kernels"], mods["visited"], \
        mods["engine"]
    dev = "cuda"
    out = {}
    for lanes in lanes_list:
        flat = torch.randint(-2 ** 31, 2 ** 31 - 1, (128, lanes),
                             generator=gen, dtype=torch.int32).to(dev)
        check(torch.equal(kernels.fingerprint_rows(flat),
                          engine.row_fingerprints(flat)),
              f"fingerprint_rows [128, {lanes}] disagrees with its plain "
              "version")
        b_ms, b_by = bound_ms(128 * lanes * 4 + 128 * 16,
                              128 * lanes * FP_OPS_PER_LANE)
        out[f"fingerprint_rows[128,{lanes}]"] = dict(
            ms=cuda_ms(torch, lambda _: kernels.fingerprint_rows(flat)),
            plain_ms=cuda_ms(torch, lambda _: engine.row_fingerprints(flat)),
            bound_ms=b_ms, bound_by=b_by)

    def keys(n):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 4), generator=gen,
                             dtype=torch.int32).to(dev)

    base, _, unres = visited.build_table(1 << 18, keys(1 << 14), dev)
    check(unres == 0, "swarm table prefill left keys unresolved")
    k = keys(128)
    valid = torch.ones(128, dtype=torch.bool, device=dev)
    ta, ia, ua = visited.insert(base.clone(), k, valid)
    tb, ib, ub = visited.insert_plain(base.clone(), k, valid)
    check(torch.equal(ta, tb) and torch.equal(ia, ib) and torch.equal(ua, ub),
          "insert [128 keys, 2^18 slots] disagrees with insert_plain")
    b_ms, b_by = bound_ms(128 * 17 + 128 * 128 + int(ia.sum()) * 16
                          + 128 * 2, 0)
    out["insert[128,2^18]"] = dict(
        ms=cuda_ms(torch, lambda t: visited.insert(t, k, valid),
                   setup=lambda: base.clone()),
        plain_ms=cuda_ms(torch, lambda t: visited.insert_plain(t, k, valid),
                         setup=lambda: base.clone()),
        bound_ms=b_ms, bound_by=b_by)
    return out


# Walker groups of the swarm phase's group run (the reference's devices).
SWARM_GROUPS = 2


def phase_swarm(torch, mods):
    """The swarm rollout probe on the card (module docstring): step
    parity, the lock twin and its same-seed rerun, the lab 1 deep probe
    and the ten lab dfs call sites through the port's search.dfs, the
    slow deep-narrow Paxos shape, then both kernels at the walker's
    shapes.  Returns the kernels' launches over the phase's searches."""
    from dslabs_tpu_torch.search import search as osearch
    from dslabs_tpu_torch.tpu import backend, specs_lab3, specs_lab4
    from dslabs_tpu_torch.tpu.engine import CapacityOverflow
    from dslabs_tpu_torch.tpu.swarm import SwarmSearch, replay_events
    from tests import torch_harness_cases as H

    t_phase = time.time()
    gen = torch.Generator().manual_seed(7)
    parity = {
        "flagship": swarm_step_parity(torch, mods, "flagship",
                                      flagship_protocol(), gen),
        "store_11": swarm_step_parity(
            torch, mods, "store_11",
            specs_lab4.make_shardstore_protocol([1, 1]), gen)}
    emit({"phase": "swarm", "part": "step_parity", **parity})
    total = {"fingerprint_rows": 0, "insert": 0}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    P = H.Pkg("dslabs_tpu_torch")
    with SwarmRuns(torch, mods) as sr:
        # ---- the lock twin, twice with one seed.
        locks = []
        for _ in range(2):
            sr.reset()
            proto = H.make_lock_protocol(m=8, k=12, noise_bits=22)
            sw = SwarmSearch(proto, walkers_per_device=128, max_steps=240,
                             steps_per_round=64, seed=0,
                             visited_cap=1 << 14, device="cuda")
            t0 = time.time()
            out = sw.run()
            rec = dict(secs=time.time() - t0, **sr.record(),
                       launches=sr.launches())
            add(rec["launches"])
            w = out.witness
            root = mods["engine"].flatten_state(
                sw.initial_state())[0].cpu().numpy()
            row, applied = replay_events(sw, root, w.trace)
            check(out.end_condition == "INVARIANT_VIOLATED"
                  and len(w.trace) == 12 and applied == 12
                  and int(row[0]) == 12 and w.replay_verified,
                  f"swarm lock: {rec}")
            locks.append((w.raw_trace, w.trace, {
                k: v for k, v in out.swarm.items()
                if not k.endswith(("_per_sec", "_per_min"))}, rec))
        check(locks[0][:3] == locks[1][:3],
              "swarm lock: same seed, different walks on the card")
        emit({"phase": "swarm", "part": "lock", "runs": [x[3] for x in locks],
              "same_seed_identical": True})

        # ---- the lock twin over SWARM_GROUPS walker groups: per walk
        # step one kernel-1 launch over every group's walkers and one
        # kernel-2 launch per group, on that group's table.
        from dslabs_tpu_torch.tpu.mesh_exchange import ShardMesh

        sr.reset()
        sw = SwarmSearch(H.make_lock_protocol(m=8, k=12, noise_bits=22),
                         mesh=ShardMesh(SWARM_GROUPS), walkers_per_device=128,
                         max_steps=240, steps_per_round=64, seed=0,
                         visited_cap=1 << 14)
        per_step = []
        walk0 = sw._walk

        def walk(c):
            k0 = kernel_counts(mods)
            walk0(c)
            per_step.append(tuple(v - k0[k] for k, v in
                                  kernel_counts(mods).items()))

        sw._walk = walk
        t0 = time.time()
        out = sw.run()
        rec = dict(secs=time.time() - t0, groups=SWARM_GROUPS,
                   **sr.record(), launches=sr.launches(),
                   per_step=sorted(set(per_step)))
        add(rec["launches"])
        w = out.witness
        check(out.end_condition == "INVARIANT_VIOLATED"
              and w.replay_verified and len(w.trace) == 12
              and out.swarm["walkers"] == 128 * SWARM_GROUPS
              and per_step and set(per_step) == {(1, SWARM_GROUPS)},
              f"swarm groups: {rec}")
        emit({"phase": "swarm", "part": "groups", **rec})

        # ---- lab dfs call sites through search.dfs on the card.
        records = {}
        with HarnessRuns(torch, mods) as hr:
            def dfs(name, case):
                sr.reset()
                del hr._runs[:]
                torch.cuda.reset_peak_memory_stats()
                t0 = time.time()
                try:
                    res = osearch.dfs(case.state, case.settings)
                except (CapacityOverflow, backend.NoTensorTwin) as e:
                    res = e
                rec = dict(secs=time.time() - t0, launches=sr.launches(),
                           peak_mem_bytes=torch.cuda.max_memory_allocated(),
                           probe=sr.record())
                add(rec["launches"])
                if isinstance(res, Exception):
                    rec.update(end=type(res).__name__, error=str(res))
                else:
                    rec.update(end=H.end_name(res),
                               depth=H.terminal_depth(res),
                               unique=res.discovered_count)
                    if hr._runs:
                        search, outcome, _ = hr._runs[-1]
                        rec["bfs"] = dict(
                            end=outcome.end_condition, depth=outcome.depth,
                            rung=[f for f, _ in backend._LADDER].index(
                                search.frontier_cap))
                check(rec["launches"]["fingerprint_rows"] > 0
                      and rec["launches"]["insert"] > 0,
                      f"swarm {name}: a kernel never launched: {rec}")
                records[name] = rec
                return res, rec

            res, rec = dfs("lab1_deep_probe", H.lab1_deep_probe(P))
            bad = H.terminal(res)
            check(rec["end"] == "INVARIANT_VIOLATED" and bad.depth >= 18
                  and rec["probe"]["witness"]["object_verified"]
                  and rec["probe"]["witness"]["verified"],
                  f"swarm lab1_deep_probe: {rec}")
            # lab1 test11's two dfs calls: the lab test file never
            # reaches them (its bfs call fails first, in the labtests
            # phase).  The other lab dfs sites run in that phase.
            for name in ("lab1_test11_c1", "lab1_test11_c2"):
                case = H.DFS[name](P)
                res, rec = dfs(name, case)
                if name.startswith("lab1_test11") and \
                        rec["end"] == "CapacityOverflow":
                    # The twin outgrows the ladder's top rung at depth 16,
                    # in both packages' tensor_bfs (ROADMAP.md Queue C).
                    check(re.search(r"net_cap=64, timer_cap=8.*depth 16 ",
                                    rec["error"]) is not None,
                          f"swarm {name}: {rec['error']}")
                    continue
                check(rec["end"] in case.expect
                      and H.terminal(res) is None,
                      f"swarm {name}: {rec}")
        emit({"phase": "swarm", "part": "dfs", "searches": records})

        # ---- the reference's slow deep-narrow Paxos shape.
        sr.reset()
        proto = H.violating(specs_lab3.make_paxos_protocol(
            n=3, n_clients=1, w=2, max_slots=3))
        sw = SwarmSearch(proto, walkers_per_device=128, max_steps=192,
                         steps_per_round=64, seed=0, visited_cap=1 << 16,
                         max_secs=PAXOS_DEEP_SECS, device="cuda")
        t0 = time.time()
        out = sw.run()
        rec = dict(secs=time.time() - t0, **sr.record(),
                   launches=sr.launches())
        add(rec["launches"])
        check(out.end_condition in ("INVARIANT_VIOLATED", "TIME_EXHAUSTED")
              and (out.witness is None or out.witness.replay_verified),
              f"swarm paxos_deep: {rec}")
        emit({"phase": "swarm", "part": "paxos_deep", **rec})
    lanes = sorted({locks[0][3]["lanes"], rec["lanes"],
                    records["lab1_deep_probe"]["probe"]["lanes"]})
    emit({"phase": "swarm", "part": "kernels",
          **swarm_kernel_times(torch, mods, lanes, gen)})
    check(all(v > 0 for v in total.values()),
          f"swarm phase skipped a kernel: {total}")
    emit({"phase": "swarm", "secs": time.time() - t_phase,
          "launches": total})
    return total


# The lab test files' search tests that fail on the tensor backend in both
# packages (ROADMAP.md Queue C): (lab, part, number) -> a regular
# expression the last line of the failure must match.  lab1 test11's bfs
# call outgrows the capacity ladder's top rung at depth 16 before its dfs
# calls run (those two are driven by the swarm phase); part 3 test10 has
# two transactional clients, as test11 has
# (tests/test_torch_lab4_harness.py holds that refusal equal to the JAX
# package's).
NO_TWIN = r"^dslabs_tpu_torch\.tpu\.backend\.NoTensorTwin: "
LABTEST_FAILS = {
    ("1", 3, 11): r"^dslabs_tpu_torch\.tpu\.engine\.CapacityOverflow: "
                  r".*net_cap=64, timer_cap=8.* at depth 16 ",
    ("4", 2, 14): NO_TWIN + re.escape(ONE_SERVER_PER_GROUP) + "$",
    ("4", 3, 10): NO_TWIN + re.escape(ONE_TX_CLIENT) + "$",
    ("4", 3, 11): NO_TWIN + re.escape(ONE_TX_CLIENT) + "$",
    ("4", 3, 12): NO_TWIN + re.escape(ONE_SERVER_PER_GROUP) + "$",
}
# The lab 3 search tests' searches in call order, by their HARNESS_PINS
# name (None: no pin).
LAB3_PINNED_CALLS = {
    "test20_basic_search": ["test20_phase1", "test20_phase2",
                            "test20_phase3"],
    "test21_no_progress_in_minority_search": ["test21", "test21_no_timers"],
    "test22_two_clients_search": ["test22_phase1", "test22_phase2_s1s3",
                                  "test22_phase2_s2s3", None, None],
}


class LabTestRuns:
    """The searches of the lab test files while the port's driver runs
    them: every top-level call of the port's ``tensor_bfs`` or
    ``tensor_dfs`` (``search.bfs`` / ``search.dfs`` on the tensor backend)
    is recorded with its seconds, peak device memory, kernel launches,
    result or exception, the BFS engine's outcome and ladder rung (through
    :class:`HarnessRuns`' spy) and the swarm probe's runs (through
    :class:`SwarmRuns`)."""

    def __init__(self, torch, mods, hr, sr):
        from dslabs_tpu_torch.tpu import backend

        self.torch, self.mods, self.backend = torch, mods, backend
        self.hr, self.sr = hr, sr
        self.calls = []
        self._depth = 0

    def _spy(self, kind, fn):
        torch = self.torch

        def spy(*a, **kw):
            if self._depth:
                return fn(*a, **kw)
            self._depth += 1
            torch.cuda.reset_peak_memory_stats()
            call = dict(kind=kind, before=self.sr.launches(),
                        runs=len(self.hr._runs), swarm=len(self.sr.runs),
                        t0=time.time())
            try:
                call["result"] = fn(*a, **kw)
                return call["result"]
            except Exception as e:
                call["error"] = e
                raise
            finally:
                call["after"] = self.sr.launches()
                call["t1"] = time.time()
                call["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
                call["runs"] = self.hr._runs[call["runs"]:]
                call["swarm"] = range(call["swarm"], len(self.sr.runs))
                self.calls.append(call)
                self._depth -= 1
        return spy

    def __enter__(self):
        b = self.backend
        self._fns = b.tensor_bfs, b.tensor_dfs
        b.tensor_bfs = self._spy("bfs", b.tensor_bfs)
        b.tensor_dfs = self._spy("dfs", b.tensor_dfs)
        return self

    def __exit__(self, *exc):
        self.backend.tensor_bfs, self.backend.tensor_dfs = self._fns

    def record(self, call):
        """One search's record, as the harness and swarm phases print
        theirs."""
        from tests import torch_harness_cases as H

        secs = call["t1"] - call["t0"]
        rec = dict(kind=call["kind"], secs=secs,
                   peak_mem_bytes=call["peak_mem_bytes"],
                   launches={k: call["after"][k] - call["before"][k]
                             for k in call["after"]})
        if "error" in call:
            e = call["error"]
            rec.update(end=type(e).__name__, error=str(e))
        else:
            res = call["result"]
            rec.update(end=H.end_name(res), depth=H.terminal_depth(res),
                       unique=res.discovered_count,
                       unique_per_min=res.discovered_count / secs * 60)
        if call["runs"]:
            search, outcome, _ = call["runs"][-1]
            rec["bfs"] = dict(
                end=outcome.end_condition, depth=outcome.depth,
                rung=[f for f, _ in self.backend._LADDER].index(
                    search.frontier_cap))
        if call["swarm"]:
            rec["probe"] = self.sr.record(call["swarm"][-1])
        return rec


class TmetaMeter:
    """The host's share of the lab searches' levels: inside the ``with``
    block every ``ShardedTensorSearch._spill_tmeta`` (the fold of a
    level's trace meta into the host fingerprint map) is timed, with the
    map's largest size, and every run's level walls (the recorder's
    ``wall``, which the fold is part of) are summed.  :meth:`take` returns
    the sums since the last call."""

    def __init__(self):
        from dslabs_tpu_torch.tpu import sharded

        self.cls = sharded.ShardedTensorSearch
        self.take()

    def __enter__(self):
        cls = self.cls
        self._fold, self._run = cls._spill_tmeta, cls.run
        fold, run = self._fold, self._run

        def timed_fold(ts, carry):
            t = time.perf_counter()
            fold(ts, carry)
            self.secs += time.perf_counter() - t
            self.calls += 1
            self.map_max = max(self.map_max, len(ts._fp_map))

        def walled_run(ts, *a, **kw):
            out = run(ts, *a, **kw)
            self.level_secs += sum(lv["wall"] for lv in out.levels or ())
            return out

        cls._spill_tmeta, cls.run = timed_fold, walled_run
        return self

    def __exit__(self, *exc):
        self.cls._spill_tmeta, self.cls.run = self._fold, self._run

    def take(self) -> dict:
        rec = {} if not hasattr(self, "secs") else dict(
            tmeta_secs=self.secs, tmeta_calls=self.calls,
            fp_map_max=self.map_max, level_wall_secs=self.level_secs,
            tmeta_share=self.secs / max(self.level_secs, 1e-9))
        self.secs, self.calls, self.map_max, self.level_secs = 0.0, 0, 0, 0.0
        return rec


def labtest_run(torch, mods, lt, out_dir, argv):
    """One call of the port's driver (``run_tests.main(argv)``) with the
    kernel counts set to 0 just before it; its results file and its output
    go to ``out_dir``.  Returns (exit code, results, launches, seconds)."""
    from dslabs_tpu_torch import run_tests

    name = "_".join(a.strip("-") for a in argv if a != "--lab")
    results = os.path.join(out_dir, f"{name}.json")
    torch.cuda.synchronize()
    mods["kernels"].LAUNCHES["fingerprint_rows"] = 0
    mods["visited"].LAUNCHES["insert"] = 0
    del lt.calls[:]
    t0 = time.time()
    with open(os.path.join(out_dir, f"{name}.log"), "w") as log, \
            contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
        rc = run_tests.main(list(argv) + ["--results-file", results])
    launches = lt.sr.launches()
    secs = time.time() - t0
    with open(results) as f:
        return rc, json.load(f), launches, secs


def phase_labtests(torch, mods, labs="01234"):
    """The lab test files through the port's driver on the card: each lab's
    search tests (``--no-run``) on the tensor backend, and lab 0's run
    tests once.  Every search test passes except LABTEST_FAILS, each with
    its error; the lab 3 searches with a pin are held to HARNESS_PINS.
    Per lab: seconds, tests passed, points, per-test seconds and each
    search's record, and the kernels' launches.  Returns the kernels'
    launches over the phase's search tests."""
    t_phase = time.time()
    total = {"fingerprint_rows": 0, "insert": 0}
    with tempfile.TemporaryDirectory(dir=ROOT) as out_dir, \
            HarnessRuns(torch, mods) as hr, SwarmRuns(torch, mods) as sr, \
            LabTestRuns(torch, mods, hr, sr) as lt, TmetaMeter() as tm:
        for lab in labs:
            sr.reset()
            del hr._runs[:]
            tm.take()
            rc, res, launches, secs = labtest_run(
                torch, mods, lt, out_dir, ["--lab", lab, "--no-run"])
            host_fold = tm.take()
            for k in total:
                total[k] += launches[k]
            tests = []
            for t in res["tests"]:
                key = (t["lab"], t["part"], t["number"])
                calls = [c for c in lt.calls
                         if t["start_time"] <= c["t0"] <= t["end_time"]]
                rec = dict(test=".".join(str(x) for x in key[1:]
                                         if x is not None),
                           name=t["name"], passed=t["passed"],
                           secs=t["end_time"] - t["start_time"],
                           points=t["points_earned"],
                           searches=[lt.record(c) for c in calls])
                if not t["passed"]:
                    rec["error"] = t["error"].strip().splitlines()[-1]
                tests.append(rec)
                if key in LABTEST_FAILS:
                    check(not t["passed"] and re.search(
                        LABTEST_FAILS[key], rec["error"]) is not None,
                          f"labtests lab {lab} test {rec['test']}: expected "
                          f"to fail with {LABTEST_FAILS[key]!r}: {rec}")
                    continue
                check(t["passed"], f"labtests lab {lab} test {rec['test']} "
                      f"failed: {t['error']}")
                for c, s in zip(calls, rec["searches"]):
                    if c["kind"] == "dfs":
                        check(s["launches"]["fingerprint_rows"] > 0
                              and s["launches"]["insert"] > 0,
                              f"labtests {t['name']}: a kernel never "
                              f"launched: {s}")
                    else:
                        # A bfs runs the sharded engine: a search that
                        # expands anything inserts through kernel 2.
                        check((s["launches"]["fingerprint_rows"] > 0)
                              == (s["launches"]["insert"] > 0),
                              f"labtests {t['name']}: kernel 2 never "
                              f"launched beside kernel 1: {s}")
                for pin, s in zip(LAB3_PINNED_CALLS.get(t["name"], ()),
                                  rec["searches"]):
                    if pin is None:
                        continue
                    end, depth, count = HARNESS_PINS[pin]
                    s["pin"] = pin
                    check(s["launches"]["fingerprint_rows"] > 0,
                          f"labtests {pin}: the fingerprint kernel never "
                          "launched")
                    if s["end"] == end:
                        check((depth is None or s["depth"] == depth)
                              and (count is None or s["unique"] == count),
                              f"labtests {pin}: {s} against pin "
                              f"{end, depth, count}")
            emit({"phase": "labtests", "lab": lab, "argv": ["--no-run"],
                  "rc": rc, "secs": secs, "passed": res["num_passed"],
                  "tests": res["num_tests"],
                  "points": [res["points_earned"], res["points_available"]],
                  "launches": launches, "trace_fold": host_fold,
                  "per_test": tests})
        check(total["fingerprint_rows"] > 0 and total["insert"] > 0,
              f"labtests: a kernel never launched: {total}")
        # Lab 0's run tests: the real-time runner (runner/) on this
        # machine.
        rc, res, _, secs = labtest_run(
            torch, mods, lt, out_dir, ["--lab", "0", "--no-search"])
        check(rc == 0, "labtests lab 0 run tests: " + "; ".join(
            f"{t['name']}: {t['error']}" for t in res["tests"]
            if not t["passed"]))
        emit({"phase": "labtests", "lab": "0", "argv": ["--no-search"],
              "rc": rc, "secs": secs, "passed": res["num_passed"],
              "tests": res["num_tests"],
              "per_test": {t["name"]: t["end_time"] - t["start_time"]
                           for t in res["tests"]}})
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "dslabs_tpu"))
    check(not loaded, f"labtests: modules of JAX or its package loaded: "
          f"{loaded[:10]}")
    emit({"phase": "labtests", "secs": time.time() - t_phase,
          "launches": total, "jax_or_dslabs_tpu_modules": loaded})
    return total


# ------------------------------------------------------------- scenarios

# The partitioned flagship's budget on the device loop, and its depth.
SCENARIO_SECS = 60.0
# Depth 8 until the lanes and service phases needed the time.
SCENARIO_DEPTH = 7
# The symmetric search at width: paxos_spec(SYM_N), DECIDED pruned, raw and
# canonical (unique, explored, depth) and its permutations (the JAX
# package's counts on the CPU).
SYM_N = 5
SYM_PIN = dict(raw=(12024, 170400, 18), canonical=(306, 4237, 18),
               perms=120)


def flagship_partition():
    """The main path's twin under the reference's one-era partition (the
    last server cut off from the other two until HEAL), goals stripped."""
    from dslabs_tpu_torch.tpu.specs_lab3 import make_paxos_partition_spec

    return dataclasses.replace(
        make_paxos_partition_spec(**FLAGSHIP_KW).compile(), goals={})


def kernel_counts(mods) -> dict:
    return {"fingerprint_rows": mods["kernels"].LAUNCHES["fingerprint_rows"],
            "insert": mods["visited"].LAUNCHES["insert"]}


def last_frontier(ts, n: int):
    """Run ``ts`` on the device loop and return the first ``n`` rows of
    its last frontier, unpacked (repeated up to ``n`` if it holds
    fewer)."""
    ts.run()
    c = ts._last_dev_carry
    rows = c["cur"][:int(c["cur_n"])]
    rows = rows if ts._pk is None else ts._pk.unpack(rows)
    del ts._last_dev_carry
    return rows.repeat(-(-n // len(rows)), 1)[:n].contiguous()


def timed_canon(torch, ts) -> list:
    """Wrap ``ts``'s canonicalize pass with a CUDA event pair per call;
    returns the list the pairs go to."""
    events = []
    canon = ts._canon

    def wrapped(rows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = canon(rows)
        end.record()
        events.append((start, end))
        return out

    ts._canon = wrapped
    return events


def scenario_kernels(torch, mods, rows_by_case):
    """Both kernels bit-exact against their plain versions on the given
    rows: the fingerprint of each case's rows, and the insert of those
    keys (20% invalid) into an empty table and into one that already
    holds half of them."""
    kernels, visited, engine = mods["kernels"], mods["visited"], \
        mods["engine"]
    gen = torch.Generator().manual_seed(9)
    out = {}
    for name, rows in rows_by_case.items():
        k = kernels.fingerprint_rows(rows)
        p = engine.row_fingerprints(rows)
        check(torch.equal(k, p), f"scenarios: fingerprint_rows on {name} "
              f"rows {list(rows.shape)} disagrees with its plain version")
        valid = (torch.rand((len(k),), generator=gen) < 0.8).to("cuda")
        cap = 1 << max(10, int(len(k) * 4).bit_length())
        half, _, unres = visited.build_table(cap, k[::2].contiguous(),
                                             "cuda")
        check(unres == 0, f"scenarios: {name} table prefill unresolved")
        inserted = {}
        for tname, table in (("empty", visited.empty_table(cap, "cuda")),
                             ("half_full", half)):
            ta, ia, ua = visited.insert(table.clone(), k, valid)
            tb, ib, ub = visited.insert_plain(table.clone(), k, valid)
            check(torch.equal(ta[:-1], tb[:-1]) and torch.equal(ia, ib)
                  and torch.equal(ua, ub),
                  f"scenarios: insert of {name} keys into a {tname} table "
                  "disagrees with insert_plain")
            inserted[tname] = int(ia.sum())
        out[name] = dict(rows=list(rows.shape), inserted=inserted,
                         max_abs_err=0)
    return out


def phase_scenarios(torch, mods):
    """Symmetry reduction and the fault plane on the card: the partitioned
    flagship at full width on the device loop (with its parity oracles),
    the symmetric paxos_spec(5) on both loops, the reference's scenario
    pins and witnesses, and both kernels on fault and canonical rows.
    Returns the kernels' launches over the phase's searches."""
    engine = mods["engine"]
    from dslabs_tpu_torch.tpu import specs, specs_lab3, specs_lab4
    from dslabs_tpu_torch.tpu.faults import FaultModel, Partition
    from dslabs_tpu_torch.tpu.swarm import SwarmSearch
    from dslabs_tpu_torch.tpu.trace import decode_trace

    t_phase = time.time()
    total = {"fingerprint_rows": 0, "insert": 0}

    def counted(fn):
        torch.cuda.synchronize()
        before = kernel_counts(mods)
        out = fn()
        torch.cuda.synchronize()
        for k, v in kernel_counts(mods).items():
            total[k] += v - before[k]
        return out

    def key(o):
        return [o.end_condition, o.unique_states, o.states_explored, o.depth]

    def pruned(p):
        return dataclasses.replace(p, goals={}, prunes=dict(p.goals),
                                   invariants=dict(p.invariants))

    # ---- the partitioned flagship at full width (device loop).
    fp = flagship_partition()
    ts = engine.TensorSearch(fp, visited_cap=1 << 24, frontier_cap=1 << 20,
                             chunk=4096, max_depth=SCENARIO_DEPTH,
                             max_secs=SCENARIO_SECS, strict=True)
    o, rec = timed_search(torch, mods, ts)
    for k in total:
        total[k] += rec["launches"][k]
    flagship = dict(lanes=ts.lanes, plane=ts.plane,
                    fault_events=o.fault_events,
                    partition_events=o.partition_events, **rec)
    plain_lanes = engine.TensorSearch(flagship_protocol(), chunk=8).lanes
    check(ts.lanes == plain_lanes + 2 + fp.timer_cap * fp.timer_width
          and ts.plane < ts.lanes and fp.fault.n_events == 2,
          f"partitioned flagship shape: {flagship}")
    check(o.end_condition in ("DEPTH_EXHAUSTED", "TIME_EXHAUSTED")
          and o.depth >= 6 and o.visited_overflow == 0
          and o.fault_events == o.partition_events > 0
          and all(v > 0 for v in rec["launches"].values()),
          f"partitioned flagship: {flagship}")
    emit({"phase": "scenarios", "part": "flagship", **flagship})

    # ---- device loop against run_host at depths 1-5, and the zero-budget
    # model against the plain flagship at depth 6.
    loops = {}
    for d in range(1, 6):
        got = []
        for host in (False, True):
            s = engine.TensorSearch(fp, visited_cap=1 << 20, chunk=4096,
                                    max_depth=d, use_host_visited=host)
            x = counted(s.run)
            got.append(key(x) + [x.partition_events])
        check(got[0] == got[1], f"partitioned flagship depth {d}: device "
              f"loop {got[0]} vs run_host {got[1]}")
        loops[d] = got[0]
    n = FLAGSHIP_KW["n"]
    zero = FaultModel(partition=Partition(blocks=(
        tuple(("server", i) for i in range(n - 1)), (("server", n - 1),)),
        max_eras=0))
    zp = dataclasses.replace(specs_lab3.make_paxos_spec(
        **FLAGSHIP_KW, fault=zero).compile(), goals={})
    outs = [counted(engine.TensorSearch(
        p, visited_cap=1 << 22, frontier_cap=1 << 20, chunk=4096,
        max_depth=6).run) for p in (zp, flagship_protocol())]
    check(key(outs[0]) == key(outs[1]) and outs[0].fault_events == 0
          and outs[0].depth == 6,
          f"zero-budget flagship {key(outs[0])} vs plain {key(outs[1])}")
    emit({"phase": "scenarios", "part": "flagship_parity",
          "device_vs_host": loops,
          "fields": ["end", "unique", "explored", "depth",
                     "partition_events"],
          "zero_budget_d6": key(outs[0]), "plain_d6": key(outs[1])})

    # ---- symmetry at width: paxos_spec(5), 120 permutations.
    p5 = pruned(specs.paxos_spec(SYM_N).compile())
    sym = {}
    canon_rows = None
    for sym_on in (False, True):
        for host in (False, True):
            s = engine.TensorSearch(p5, chunk=256, visited_cap=1 << 18,
                                    symmetry=sym_on, use_host_visited=host)
            events = timed_canon(torch, s) if sym_on else []
            t0 = time.time()
            x = counted(s.run)
            wall_ms = (time.time() - t0) * 1e3
            r = dict(key=key(x), perms=x.symmetry_perms, wall_ms=wall_ms)
            if sym_on:
                c_ms = sum(a.elapsed_time(b) for a, b in events)
                r.update(canon_calls=len(events), canon_ms=c_ms,
                         canon_ms_per_call=c_ms / max(len(events), 1),
                         canon_share=c_ms / wall_ms)
                if not host:
                    r["chunk_steps"] = s.chunk_steps
            sym[("sym" if sym_on else "raw")
                + ("_host" if host else "_device")] = r
            want = SYM_PIN["canonical" if sym_on else "raw"]
            check(r["key"] == ["SPACE_EXHAUSTED", want[0], want[1], want[2]]
                  and r["perms"] == (SYM_PIN["perms"] if sym_on else 0),
                  f"paxos_spec({SYM_N}) symmetry={sym_on} host={host}: {r}")
    # One canonicalize call under the profiler, on the successors of a
    # chunk of the raw search's depth-9 frontier.
    front = last_frontier(engine.TensorSearch(p5, chunk=256, max_depth=9),
                          256)
    s = engine.TensorSearch(p5, chunk=256, symmetry=True)
    succ = s._expand_chunk(front, torch.ones(len(front), dtype=torch.bool,
                                             device="cuda"))[0]
    prof_ms, prof_launches = profiled_call(torch, lambda: s._canon(succ))
    canon_rows = s._canon(succ)
    sym["profiled_call"] = dict(rows=list(succ.shape), device_ms=prof_ms,
                                device_launches=prof_launches)
    emit({"phase": "scenarios", "part": f"symmetry_paxos{SYM_N}", **sym})

    # ---- the reference's pins.
    pins = {}

    def both(name, p, want, family, **kw):
        for host in (False, True):
            x = counted(engine.TensorSearch(p, use_host_visited=host,
                                            **kw).run)
            got = key(x) + [getattr(x, family), x.fault_events]
            pins[name + ("_host" if host else "_device")] = got
            check(got[:len(want)] == list(want),
                  f"scenario pin {name} host={host}: {got} vs {want}")

    kw = dict(chunk=256, frontier_cap=1 << 13, visited_cap=1 << 16)
    both("paxos3_symmetric", pruned(specs.paxos_spec(3).compile()),
         ["SPACE_EXHAUSTED", 50, 375, 11], "partition_events",
         symmetry=True, **kw)
    both("paxos_partition", pruned(specs.paxos_partition_spec(3).compile()),
         ["SPACE_EXHAUSTED", 564, 3416, 13, 320, 320], "partition_events",
         **kw)
    for d, pin in ((2, (32, 64, 7)), (3, (133, 328, 31))):
        both(f"lab3_partition_d{d}",
             pruned(specs_lab3.make_paxos_partition_spec(3).compile()),
             ["DEPTH_EXHAUSTED", pin[0], pin[1], d, pin[2], pin[2]],
             "partition_events", chunk=256, max_depth=d)
    for d, pin in ((2, (30, 43, 7)), (3, (103, 200, 29))):
        both(f"lab4_crash_d{d}",
             pruned(specs_lab4.make_shardstore_crash_spec([1, 1]).compile()),
             ["DEPTH_EXHAUSTED", pin[0], pin[1], d, pin[2], pin[2]],
             "crash_events", chunk=256, max_depth=d)

    # ---- witnesses, decoded with their fault labels.
    wit = {}
    spec = specs.paxos_partition_spec(3, broken=True)
    names = {v: k for k, v in spec._mtag.items()}
    s = engine.TensorSearch(spec.compile(), record_trace=True, **kw)
    x = counted(s.run)
    recs = decode_trace(s, x)
    wit["broken_quorum"] = [a[0] if k == "fault" else names[int(a[0][0])]
                            for k, a in recs]
    check((x.end_condition, x.predicate_name, x.depth) == (
        "INVARIANT_VIOLATED", "DECIDE_HAS_QUORUM", 5)
        and wit["broken_quorum"] == ["HEAL", "PREPARE", "PROMISE", "ACCEPT",
                                     "ACCEPTED"],
        f"broken-quorum witness: {key(x)} {wit}")

    def no_heal():
        sp = specs_lab3.make_paxos_partition_spec(3)
        sp.invariants["NO_HEAL"] = lambda v: ~(
            (v.get("$fault", 0, "pcut") == 0)
            & (v.get("$fault", 0, "eras") == 1))
        return dataclasses.replace(sp.compile(), goals={})

    def no_crash():
        sp = specs_lab4.make_shardstore_crash_spec([1, 1])
        sp.invariants["NO_CRASH"] = \
            lambda v: v.get("$fault", 0, "crashes") == 0
        return dataclasses.replace(sp.compile(), goals={})

    for name, make, depth, labels in (
            ("no_heal", no_heal, 2, ["CUT", "HEAL"]),
            ("no_crash", no_crash, 1, ["CRASH(server[0])"])):
        s = engine.TensorSearch(make(), chunk=256, record_trace=True,
                                max_depth=depth + 2)
        x = counted(s.run)
        wit[name] = [a[0] for _, a in decode_trace(s, x)]
        check(x.end_condition == "INVARIANT_VIOLATED" and x.depth == depth
              and wit[name] == labels, f"{name} witness: {key(x)} {wit}")
    # A swarm on NO_HEAL finds the violation and minimizes it to CUT, HEAL.
    p = no_heal()
    sw = SwarmSearch(p, walkers_per_device=128, max_steps=32, seed=0,
                     max_secs=60.0, device="cuda")
    t0 = time.time()
    x = counted(sw.run)
    base = p.net_cap + p.n_nodes * p.timer_cap
    w = x.witness
    wit["swarm_no_heal"] = dict(
        end=x.end_condition, secs=time.time() - t0,
        raw=None if w is None else len(w.raw_trace),
        trace=None if w is None else [int(e) for e in w.trace],
        labels=None if w is None else [a[0] for _, a in
                                       decode_trace(sw, x)])
    check(x.end_condition == "INVARIANT_VIOLATED" and w.replay_verified
          and list(w.trace) == [base, base + 1]
          and wit["swarm_no_heal"]["labels"] == ["CUT", "HEAL"],
          f"swarm NO_HEAL witness: {wit['swarm_no_heal']}")
    emit({"phase": "scenarios", "part": "pins", "pins": pins,
          "fields": ["end", "unique", "explored", "depth", "family_events",
                     "fault_events"], "witnesses": wit})

    # ---- both kernels on fault rows and on canonical rows.  These
    # comparisons' launches are not the phase's.
    # The fault rows: every successor row of a full chunk of the
    # partitioned flagship's depth-5 frontier, at the main path's shape.
    saved = kernel_counts(mods)
    ts = engine.TensorSearch(fp, chunk=4096, max_depth=5)
    front = last_frontier(ts, ts.chunk)
    fault_rows = ts._expand_chunk(front, torch.ones(
        len(front), dtype=torch.bool, device="cuda"))[0]
    kern = scenario_kernels(torch, mods, {"fault_flagship": fault_rows,
                                          "canonical_paxos5": canon_rows})
    mods["kernels"].LAUNCHES["fingerprint_rows"] = saved["fingerprint_rows"]
    mods["visited"].LAUNCHES["insert"] = saved["insert"]
    check(all(v > 0 for v in total.values()),
          f"scenarios phase skipped a kernel: {total}")
    emit({"phase": "scenarios", "part": "kernels", **kern})
    emit({"phase": "scenarios", "secs": time.time() - t_phase,
          "launches": total})
    return total


# The spill phase: the flagship past its frontier cap in spill mode
# against a non-spill oracle, a SIGKILLed spill run resumed two ways, and
# swarm frontier seeding and round checkpoints.
SPILL_DEPTH = 9
SPILL_FRONTIER_CAP = 1 << 18
SPILL_VISITED_CAP = 1 << 20
# The oracle holds depth 9's next frontier (about 1.09M rows) in one
# buffer: frontier_cap 2^22 (the buffer grows x8 from 4096 and stops at
# 2^21, 868 B per row).
ORACLE_FRONTIER_CAP = 1 << 22
KILL_DEPTH = 8
KILL_AT = 6
KILL_VISITED_CAP = 1 << 18
KILL_SECS = 300.0
# Rounds cap of the lock swarm's cut-and-resume (4 steps each).
SWARM_MAX_ROUNDS = 500
# The flagship's pinned depth-8 count (the compiled phase).
FLAGSHIP_D8_UNIQUE = 316096

# The killed child: the flagship in spill mode to KILL_DEPTH with a dump
# per level; each dump's depth, size and write seconds go to stdout.
SPILL_CHILD = """
import dataclasses, json, os, sys, time
sys.path.insert(0, {root!r})
from dslabs_tpu_torch.tpu import _build, checkpoint, spill
from dslabs_tpu_torch.tpu.engine import TensorSearch
from dslabs_tpu_torch.tpu.specs_lab3 import make_paxos_protocol

save = checkpoint.save


def timed_save(path, ck, levels_dir=None):
    t = time.time()
    save(path, ck, levels_dir=levels_dir)
    print(json.dumps({{"depth": ck.depth, "secs": time.time() - t,
                      "bytes": os.path.getsize(path),
                      "frontier_rows": len(ck.frontier),
                      "keys": len(ck.visited_keys)}}), flush=True)


checkpoint.save = timed_save
_build.lib()
p = dataclasses.replace(make_paxos_protocol(**{kw!r}), goals={{}})
TensorSearch(p, chunk=4096, strict=True, max_depth={depth},
             visited_cap={vcap}, frontier_cap={fcap},
             spill=spill.SpillConfig(high_water=0.60),
             checkpoint_path={path!r}, checkpoint_every=1,
             device="cuda").run()
print("done", flush=True)
"""


class SpoolCount:
    """Counts the segments the spill managers spool (the spill stats
    count the evictions and the segments injected again, not these)."""

    def __init__(self):
        from dslabs_tpu_torch.tpu import spill

        self.mgr = spill.SpillManager
        self.segments = 0

    def __enter__(self):
        spool = self._spool = self.mgr.spool

        def counted(sp, rows):
            if len(rows):
                self.segments += 1
            return spool(sp, rows)

        self.mgr.spool = counted
        return self

    def __exit__(self, *exc):
        self.mgr.spool = self._spool


def spill_record(o, ts, rec):
    """A timed_search record with the outcome's spill and resume fields
    and, in spill mode, the evictions and re-injected segments."""
    st = ts._spill.stats if ts._spill is not None else None
    rec = dict(rec, end=o.end_condition,
               resumed_from_depth=o.resumed_from_depth,
               spilled_keys=o.spilled_keys, host_tier_hits=o.host_tier_hits,
               respilled_frontier=o.respilled_frontier,
               dropped_states=o.dropped_states,
               spill_drain_ms=o.spill_drain_ms, spill_wait_ms=o.spill_wait_ms)
    if st is not None:
        rec.update(evictions=st.evictions, reinjections=st.reinjections)
    return rec


def spill_kernels(torch, mods, keys, rows_u):
    """Both kernels bit-exact against their plain versions at the spill
    path's new shapes, then timed by CUDA events: kernel 2 rebuilding a
    resumed dump's key set into 2^24 slots (``visited.build_table``),
    kernel 1 on a drained batch's power-of-two row bucket."""
    kernels, visited, engine = mods["kernels"], mods["visited"], \
        mods["engine"]
    out = {}
    V = 1 << 24
    valid = torch.ones((len(keys),), dtype=torch.bool, device="cuda")
    ta, ia, ua = visited.insert(visited.empty_table(V, "cuda"), keys, valid)
    tb, ib, ub = visited.insert_plain(visited.empty_table(V, "cuda"), keys,
                                      valid)
    check(torch.equal(ta[:-1], tb[:-1]) and torch.equal(ia, ib)
          and torch.equal(ua, ub) and not bool(ua.any()),
          "spill: build_table of the resumed keys disagrees with "
          "insert_plain")
    n_ins = int(ia.sum())
    del ta, tb
    ms = cuda_ms(torch, lambda t: visited.insert(t, keys, valid),
                 setup=lambda: visited.empty_table(V, "cuda"), reps=10)
    plain = cuda_ms(torch, lambda t: visited.insert_plain(t, keys, valid),
                    setup=lambda: visited.empty_table(V, "cuda"), reps=5,
                    warmup=1)
    n = len(keys)
    b_ms, b_by = bound_ms(n * 17 + n * 128 + n_ins * 16 + n * 2, 0)
    out["insert"] = dict(shape=dict(V=V, N=n), inserted=n_ins,
                         max_abs_err=0, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by)
    m, L = rows_u.shape
    k = kernels.fingerprint_rows(rows_u)
    p = engine.row_fingerprints(rows_u)
    check(torch.equal(k, p), f"spill: fingerprint_rows on the drained "
          f"bucket [{m}, {L}] disagrees with its plain version")
    ms = cuda_ms(torch, lambda _: kernels.fingerprint_rows(rows_u), reps=10)
    plain = cuda_ms(torch, lambda _: engine.row_fingerprints(rows_u),
                    reps=5, warmup=1)
    b_ms, b_by = bound_ms(m * L * 4 + m * 16, m * L * FP_OPS_PER_LANE)
    out["fingerprint_rows"] = dict(shape=[m, L], max_abs_err=0, ms=ms,
                                   plain_ms=plain, bound_ms=b_ms,
                                   bound_by=b_by)
    return out


def kill_child(torch, path: str, log: str):
    """Run SPILL_CHILD to KILL_DEPTH and SIGKILL it once its dump reaches
    KILL_AT -> (dump depth, the child's dump log records)."""
    import signal

    torch.cuda.empty_cache()
    src = SPILL_CHILD.format(root=ROOT, kw=FLAGSHIP_KW, depth=KILL_DEPTH,
                             vcap=KILL_VISITED_CAP, fcap=SPILL_FRONTIER_CAP,
                             path=path)
    ckpt = _spill_mods()["checkpoint"]
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", src], stdout=f,
                                stderr=subprocess.STDOUT, cwd=ROOT)
    try:
        deadline = time.time() + KILL_SECS
        while time.time() < deadline and proc.poll() is None:
            d = ckpt.peek_depth(path)
            if d is not None and d >= KILL_AT:
                break
            time.sleep(0.05)
        alive = proc.poll() is None
        if alive:
            proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    with open(log) as f:
        text = f.read()
    check(alive and proc.returncode == -signal.SIGKILL,
          f"spill kill_resume: the child was not killed mid-run "
          f"(rc {proc.returncode}): {text[-2000:]}")
    dumps = [json.loads(ln) for ln in text.splitlines()
             if ln.startswith("{")]
    return ckpt.peek_depth(path), dumps


def _spill_mods():
    from dslabs_tpu_torch.tpu import checkpoint, spill, swarm

    return {"checkpoint": checkpoint, "spill": spill, "swarm": swarm}


def phase_spill(torch, mods):
    """The host-RAM spill tier, checkpoints and swarm seeding on the card
    (module docstring).  Returns the kernels' launches over the phase's
    searches."""
    engine = mods["engine"]
    sm = _spill_mods()
    ckpt, spill = sm["checkpoint"], sm["spill"]
    SwarmSearch = sm["swarm"].SwarmSearch
    from dslabs_tpu_torch.tpu import specs_lab3
    from tests import torch_harness_cases as H

    t_phase = time.time()
    total = {"fingerprint_rows": 0, "insert": 0}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    def flagship(**kw):
        return engine.TensorSearch(flagship_protocol(), chunk=4096,
                                   strict=True, **kw)

    # ---- flagship_spill: past the frontier cap in spill mode, against
    # the non-spill oracle.
    oracle = flagship(max_depth=SPILL_DEPTH, visited_cap=1 << 24,
                      frontier_cap=ORACLE_FRONTIER_CAP)
    o_or, r_or = timed_search(torch, mods, oracle)
    add(r_or["launches"])
    check(o_or.end_condition == "DEPTH_EXHAUSTED"
          and o_or.depth == SPILL_DEPTH and o_or.visited_overflow == 0,
          f"spill oracle: {r_or}")
    del oracle
    torch.cuda.empty_cache()
    ts = flagship(max_depth=SPILL_DEPTH, visited_cap=SPILL_VISITED_CAP,
                  frontier_cap=SPILL_FRONTIER_CAP,
                  spill=spill.SpillConfig(high_water=0.60))
    with SpoolCount() as sc:
        o_sp, r_sp = timed_search(torch, mods, ts)
    add(r_sp["launches"])
    r_sp = spill_record(o_sp, ts, r_sp)
    r_sp["spooled_segments"] = sc.segments
    check(o_sp.end_condition == "DEPTH_EXHAUSTED"
          and r_sp["key"] == r_or["key"]
          and o_sp.spilled_keys > 0 and o_sp.respilled_frontier > 0
          and o_sp.dropped_states == 0
          and all(v > 0 for v in r_sp["launches"].values()),
          f"spill flagship_spill: {r_sp} against the oracle {r_or}")
    emit({"phase": "spill", "part": "flagship_spill",
          "config": dict(depth=SPILL_DEPTH, visited_cap=SPILL_VISITED_CAP,
                         frontier_cap=SPILL_FRONTIER_CAP, high_water=0.60,
                         oracle_frontier_cap=ORACLE_FRONTIER_CAP),
          "spill": r_sp, "oracle": r_or})
    del ts
    torch.cuda.empty_cache()

    # ---- kill_resume: a SIGKILLed spill run resumed in spill mode and
    # by a non-spill search, against a straight run.
    straight = flagship(max_depth=KILL_DEPTH, visited_cap=1 << 24,
                        frontier_cap=1 << 20)
    o_st, r_st = timed_search(torch, mods, straight)
    add(r_st["launches"])
    check(o_st.unique_states == FLAGSHIP_D8_UNIQUE, f"spill straight: {r_st}")
    del straight
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = os.path.join(tmp, "flagship.npz")
        t0 = time.time()
        depth, dumps = kill_child(torch, path, os.path.join(tmp, "child.log"))
        kill_secs = time.time() - t0
        dump_bytes = os.path.getsize(path)
        resumed = {}
        for how, kw in (
                ("spill", dict(visited_cap=KILL_VISITED_CAP,
                               frontier_cap=SPILL_FRONTIER_CAP,
                               spill=spill.SpillConfig(high_water=0.60))),
                ("non_spill", dict(visited_cap=1 << 24,
                                   frontier_cap=1 << 20))):
            ts = flagship(max_depth=KILL_DEPTH, checkpoint_path=path, **kw)
            run = ts.run
            ts.run = lambda: run(resume=True)
            o, r = timed_search(torch, mods, ts)
            add(r["launches"])
            r = spill_record(o, ts, r)
            check(o.end_condition == "DEPTH_EXHAUSTED"
                  and r["key"] == r_st["key"]
                  and o.unique_states == FLAGSHIP_D8_UNIQUE
                  and o.resumed_from_depth >= KILL_AT,
                  f"spill kill_resume {how}: {r} against {r_st}")
            resumed[how] = r
            del ts
            torch.cuda.empty_cache()
        # The resumed key set and its frontier rows (decoded) for the
        # kernel checks.
        ck = flagship(checkpoint_path=path)._load_ckpt()
        keys = torch.from_numpy(ck.visited_keys.view("int32")).to("cuda")
        rows = torch.from_numpy(ck.frontier).to("cuda")
    emit({"phase": "spill", "part": "kill_resume", "killed_at_depth": depth,
          "child_secs": kill_secs, "dump_bytes": dump_bytes,
          "dump_keys": len(ck.visited_keys),
          "dump_frontier_rows": len(ck.frontier), "child_dumps": dumps,
          "straight": r_st, **resumed})

    # ---- swarm_seed: frontier seeding from a BFS dump of the swarm
    # phase's Paxos twin, and a seeded lock swarm cut after round 1 and
    # resumed.
    swarm_recs = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        proto = H.violating(specs_lab3.make_paxos_protocol(
            n=3, n_clients=1, w=2, max_slots=3))
        bfs = os.path.join(tmp, "paxos_bfs.npz")
        o = engine.TensorSearch(proto, chunk=4096, max_depth=4,
                                checkpoint_path=bfs,
                                checkpoint_every=1).run()
        check(o.end_condition == "DEPTH_EXHAUSTED",
              f"spill swarm paxos BFS: {o.end_condition}")
        ck_p = ckpt.load(bfs, ckpt.config_fingerprint(proto, True))
        torch.cuda.synchronize()
        kernels0 = kernel_counts(mods)
        sw = SwarmSearch(proto, walkers_per_device=128, max_steps=192,
                         steps_per_round=8, max_rounds=1, seed=0,
                         visited_cap=1 << 16, frontier_seed=bfs,
                         device="cuda")
        t0 = time.time()
        out = sw.run()
        swarm_recs["paxos_seed"] = dict(
            bfs=[o.end_condition, o.unique_states, o.depth],
            dump_keys=len(ck_p.visited_keys),
            dump_frontier=len(ck_p.frontier),
            preseeded_keys=sw.preseeded_keys, end=out.end_condition,
            secs=time.time() - t0, stats=out.swarm)
        check(sw.preseeded_keys == len(ck_p.visited_keys) == o.unique_states
              and out.swarm["vis_over"] == 0,
              f"spill swarm paxos_seed: {swarm_recs['paxos_seed']}")
        lock = H.make_lock_protocol(m=8, k=12, noise_bits=22)
        lbfs = os.path.join(tmp, "lock_bfs.npz")
        engine.TensorSearch(lock, chunk=4096, max_depth=2,
                            checkpoint_path=lbfs, checkpoint_every=1).run()
        sw_ck = os.path.join(tmp, "swarm.npz")
        # Four steps per round: round 1 cannot reach progress 12 from a
        # depth-2 seed.  The table stays far from full (membership, and
        # so every counter, then does not depend on the table's layout,
        # which a resume rebuilds).
        kw = dict(walkers_per_device=128, max_steps=240, steps_per_round=4,
                  max_rounds=SWARM_MAX_ROUNDS, seed=0, visited_cap=1 << 20,
                  frontier_seed=lbfs, device="cuda")
        runs = {}
        for name, extra, resume in (
                ("uncut", {}, False),
                ("cut", dict(max_rounds=1, checkpoint_path=sw_ck,
                             checkpoint_every=1), False),
                ("resumed", dict(checkpoint_path=sw_ck), True)):
            sw = SwarmSearch(lock, **{**kw, **extra})
            t0 = time.time()
            out = sw.run(resume=resume)
            w = out.witness
            runs[name] = dict(
                end=out.end_condition, secs=time.time() - t0,
                rounds=out.swarm["rounds"],
                resumed_from_depth=out.resumed_from_depth,
                raw=None if w is None else w.raw_trace,
                trace=None if w is None else w.trace,
                counters={k: v for k, v in out.swarm.items()
                          if not k.endswith(("_per_sec", "_per_min"))})
        u, c, r = runs["uncut"], runs["cut"], runs["resumed"]
        check(u["end"] == "INVARIANT_VIOLATED" and u["rounds"] > 1
              and c["end"] == "TIME_EXHAUSTED" and c["rounds"] == 1
              and (r["end"], r["raw"], r["trace"], r["counters"])
              == (u["end"], u["raw"], u["trace"], u["counters"])
              and r["resumed_from_depth"] == 1,
              f"spill swarm cut_resume: {runs}")
        swarm_recs["cut_resume"] = runs
        torch.cuda.synchronize()
        launches = {k: v - kernels0[k] for k, v in kernel_counts(mods).items()}
        add(launches)
        swarm_recs["launches"] = launches
    emit({"phase": "spill", "part": "swarm_seed", **swarm_recs})

    # ---- kernels at the spill path's shapes: the dump's keys, and a
    # full drain's rows (a frontier-full abort drains 2^18 rows) made of
    # the dump's frontier rows.
    rows_u = rows.repeat(-(-SPILL_FRONTIER_CAP // len(rows)), 1)[
        :SPILL_FRONTIER_CAP].contiguous()
    kern = spill_kernels(torch, mods, keys, rows_u)
    del keys, rows, rows_u
    torch.cuda.empty_cache()
    emit({"phase": "spill", "part": "kernels", **kern})
    check(all(v > 0 for v in total.values()),
          f"spill phase skipped a kernel: {total}")
    emit({"phase": "spill", "secs": time.time() - t_phase,
          "launches": total})
    return total


# The supervisor phase: the flagship at full width through SearchSupervisor
# and the warden, fault-free and under each kind of fault, to depth 7
# (depth 8 until the lanes and service phases needed the time; every
# fault is injected at depth 5 or 6 either way).
SUP_DEPTH = 7
SUP_FAILOVER_DEPTH = 7
SUP_CAPS = dict(chunk=4096, frontier_cap=1 << 20, visited_cap=1 << 20)
# The flagship's pinned depth-7 and depth-8 counts (PERF.md §6).
FLAGSHIP_D7 = ["DEPTH_EXHAUSTED", 69673, 301551, 7]
FLAGSHIP_D8_EXPLORED = 1495288
SUP_DEADLINE = 5.0
WARDEN_STEADY_GRACE = 5.0
WARDEN_SLACK = 2.0
WARDEN_FLAGSHIP = {
    "factory": "dslabs_tpu_torch.tpu.specs_lab3:make_paxos_protocol",
    "factory_kwargs": FLAGSHIP_KW,
    "transform": "chip_smoke:strip_goals",
}


def strip_goals(proto):
    """The flagship's goals stripped (the warden children rebuild the
    main path's twin from its factory through this)."""
    return dataclasses.replace(proto, goals={})


def phase_supervisor(torch, mods):
    """The search supervisor and the warden on the card (module
    docstring).  Returns the kernels' launches over the phase's
    in-process supervised runs."""
    engine = mods["engine"]
    from dslabs_tpu_torch.tpu import supervisor as S
    from dslabs_tpu_torch.tpu.warden import Warden

    t_phase = time.time()
    total = {"fingerprint_rows": 0, "insert": 0}

    def key(o):
        return [o.end_condition, o.unique_states, o.states_explored, o.depth]

    def recovery(o):
        return dict(engine=o.engine, retries=o.retries,
                    failovers=o.failovers, knob_retries=o.knob_retries,
                    resumed_from_depth=o.resumed_from_depth,
                    abandoned_threads=o.abandoned_threads,
                    child_restarts=o.child_restarts,
                    killed_dispatches=o.killed_dispatches)

    def supervised(sup, resume=False):
        """``sup.run()`` with the kernel counts read around it; what
        earlier runs left is collected first, so that the memory read at
        a release is the failed rung's own."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = kernel_counts(mods)
        t0 = time.time()
        o = sup.run(resume=resume)
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in kernel_counts(mods).items()}
        for k in total:
            total[k] += launches[k]
        return o, dict(key=key(o), secs=time.time() - t0,
                       peak_mem_bytes=torch.cuda.max_memory_allocated(),
                       launches=launches, **recovery(o))

    def sup(depth=SUP_DEPTH, **kw):
        # The device rung's dispatch indices below are pinned against the
        # solo loop's sequence: the sharded rung is the elastic phase's.
        kw.setdefault("ladder", ("device", "host"))
        return S.SearchSupervisor(flagship_protocol(), strict=True,
                                  max_depth=depth, **SUP_CAPS, **kw)

    pinned = FLAGSHIP_D7
    clean = dict(engine="device", retries=0, failovers=0, knob_retries=0,
                 resumed_from_depth=0, abandoned_threads=0,
                 child_restarts=0, killed_dispatches=0)

    # ---- the probe.
    probe = S.probe_device()
    check(probe["platform"] == "cuda", f"supervisor probe: {probe}")
    emit({"phase": "supervisor", "part": "probe", **probe})

    # ---- fault-free: a bare run, then the supervised one (with the
    # kernel library loaded ahead of the run) and an observer that
    # records each dispatch's (tag, index, depth).
    bare = engine.TensorSearch(flagship_protocol(), strict=True,
                               max_depth=SUP_DEPTH, **SUP_CAPS)
    o_bare, r_bare = timed_search(torch, mods, bare)
    check(r_bare["key"] == pinned, f"supervisor bare run: {r_bare}")
    del bare
    torch.cuda.empty_cache()
    seen = []
    o, r_free = supervised(sup(ladder=("device", "host"), aot_warmup=True,
                               dispatch_observer=lambda ph, tag, i, d:
                               seen.append((tag, i, d)) if ph == "start"
                               else None))
    check(r_free["key"] == pinned
          and {k: r_free[k] for k in clean} == clean
          and r_free["launches"] == r_bare["launches"]
          and o.platform == "cuda" and o.compile_secs > 0,
          f"supervisor fault-free: {r_free} against the bare {r_bare}")
    emit({"phase": "supervisor", "part": "fault_free", "bare": r_bare,
          "supervised": r_free, "compile_secs": o.compile_secs,
          "dispatches": len(seen)})
    torch.cuda.empty_cache()

    def first_step(depth):
        return next(i for tag, i, d in seen
                    if tag == "device.step" and d == depth)

    def first_sync(depth):
        return next(i for tag, i, d in seen
                    if tag == "device.sync" and d == depth)

    recs = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        # ---- the warden: a child SIGKILLed after a durable dump, the
        # next child resumed on the card, the host rung unused.  The
        # ladder's children run in their own processes while the
        # in-process cases below run here.
        def warden_kill():
            w = Warden(**WARDEN_FLAGSHIP, ladder=("device", "device", "host"),
                       max_depth=SUP_DEPTH, **SUP_CAPS,
                       checkpoint_path=os.path.join(tmp, "warden.npz"),
                       checkpoint_every=1,
                       fault={"kind": "die", "at": first_step(6),
                              "after_ckpt": True})
            t0 = time.time()
            o = w.run()
            return w, o, time.time() - t0

        f_kill = pool.submit(warden_kill)

        # ---- transient: two injected transients on a warm chunk step.
        at = first_step(5)
        o, r = supervised(sup(fault_plan=S.FaultPlan().raise_at(at, count=2),
                              policy=S.RetryPolicy(backoff_base=0.01)))
        check(r["key"] == pinned and r["retries"] == 2
              and r["failovers"] == 0 and r["engine"] == "device",
              f"supervisor transient: {r}")
        recs["transient"] = dict(at=at, **r)

        # ---- OOM re-level: an injected CUDA OOM on the first step of
        # depth 6, after the depth-4 and depth-5 dumps.
        s = sup(fault_plan=S.FaultPlan().raise_at(
                    first_step(6), error=torch.cuda.OutOfMemoryError,
                    message="CUDA out of memory. Tried to allocate"),
                checkpoint_path=os.path.join(tmp, "oom.npz"),
                checkpoint_every=1)
        mem = []
        release = s._release

        def traced(search, exc):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            release(search, exc)
            torch.cuda.synchronize()
            mem.append([before, torch.cuda.memory_allocated()])

        s._release = traced
        o, r = supervised(s)
        check(r["key"] == pinned and r["knob_retries"] == 1
              and r["failovers"] == 0 and r["engine"] == "device"
              and r["resumed_from_depth"] >= 4
              and s.last_search.chunk == SUP_CAPS["chunk"] // 2
              and len(mem) == 1 and mem[0][1] < mem[0][0],
              f"supervisor OOM re-level: {r}, memory {mem}")
        recs["oom_relevel"] = dict(relevel_chunk=s.last_search.chunk,
                                   memory_allocated_release=mem[0], **r)
        del s
        torch.cuda.empty_cache()

        # ---- a real OOM.
        try:
            torch.empty(2 ** 40, dtype=torch.uint8, device="cuda")
            real = None
        except torch.cuda.OutOfMemoryError as e:
            real = dict(type=type(e).__name__, oom=S.classify_oom(e),
                        failure=S.classify_failure(e),
                        message=str(e).splitlines()[0][:160])
        torch.cuda.empty_cache()
        check(real is not None and real["oom"] and real["failure"] == "fatal",
              f"supervisor real OOM: {real}")
        recs["real_oom"] = real

        # ---- fatal, then failover to the host rung (run_host on the
        # card), resumed from the depth-5 dump, against a bare device run
        # to the same depth.
        bare7 = engine.TensorSearch(flagship_protocol(), strict=True,
                                    max_depth=SUP_FAILOVER_DEPTH, **SUP_CAPS)
        o7, r7 = timed_search(torch, mods, bare7)
        del bare7
        torch.cuda.empty_cache()
        o, r = supervised(sup(
            depth=SUP_FAILOVER_DEPTH, ladder=("device", "host"),
            fault_plan=S.FaultPlan().raise_at(
                first_step(6), error=RuntimeError,
                message="injected fatal fault"),
            checkpoint_path=os.path.join(tmp, "fatal.npz"),
            checkpoint_every=1))
        check(r["key"] == r7["key"] and r["failovers"] == 1
              and r["engine"] == "host" and r["resumed_from_depth"] >= 4,
              f"supervisor fatal failover: {r} against {r7}")
        recs["fatal_failover"] = dict(bare=r7, **r)
        torch.cuda.empty_cache()

        # ---- watchdog: a hang on a warm stats sync, abandoned at the
        # deadline, failed over to the host rung from the last dump.
        s = sup(depth=SUP_FAILOVER_DEPTH, ladder=("device", "host"),
                fault_plan=S.FaultPlan().hang_at(first_sync(6), secs=600.0),
                policy=S.RetryPolicy(deadline_secs=SUP_DEADLINE),
                checkpoint_path=os.path.join(tmp, "hang.npz"),
                checkpoint_every=1)
        o, r = supervised(s)
        check(r["key"] == r7["key"] and r["failovers"] == 1
              and r["engine"] == "host"
              and [f.kind for f in s.failures] == ["wedged"]
              and r["abandoned_threads"] == 0,
              f"supervisor watchdog: {r}")
        recs["watchdog"] = dict(deadline_secs=SUP_DEADLINE, **r)
        del s
        torch.cuda.empty_cache()
        emit({"phase": "supervisor", "part": "in_process", **recs})
        w, o, secs = f_kill.result()
        r_kill = dict(key=key(o), secs=secs, platform=w.last_platform,
                      deaths=[d.kind for d in w.deaths], **recovery(o))
        check(r_kill["key"] == pinned and o.child_restarts == 1
              and o.engine == "device" and w.last_platform == "cuda"
              and o.platform == "cuda" and r_kill["deaths"] == ["oom"]
              and o.resumed_from_depth >= 4,
              f"supervisor warden kill: {r_kill}")

        # ---- the warden: a child hung on a warm chunk step on the card
        # after a durable dump, SIGKILLed at its announced grace; the next
        # child resumes on the card, the host rung unused.
        w = Warden(**WARDEN_FLAGSHIP, ladder=("device", "device", "host"),
                   max_depth=SUP_DEPTH, **SUP_CAPS,
                   checkpoint_path=os.path.join(tmp, "warden_hang.npz"),
                   checkpoint_every=1,
                   steady_grace=WARDEN_STEADY_GRACE,
                   grace_slack=WARDEN_SLACK,
                   fault={"kind": "hang", "at": first_step(6),
                          "spawns": [0], "after_ckpt": True})
        t0 = time.time()
        o = w.run()
        d = w.deaths[0]
        hung = dict(key=key(o), secs=time.time() - t0, kind=d.kind,
                    exitcode=d.exitcode, silent_secs=d.silent_secs,
                    last_tag=d.last_hb and d.last_hb.get("tag"),
                    last_grace=d.last_hb and d.last_hb.get("grace"),
                    platform=w.last_platform, **recovery(o))
        check(hung["key"] == pinned
              and hung["kind"] == "wedge" and hung["exitcode"] == -9
              and hung["killed_dispatches"] == 1
              and hung["child_restarts"] == 1
              and hung["last_tag"] == "device.step"
              and hung["last_grace"] == WARDEN_STEADY_GRACE
              and WARDEN_STEADY_GRACE <= hung["silent_secs"]
              <= WARDEN_STEADY_GRACE + WARDEN_SLACK + 1.0
              and hung["platform"] == "cuda" and o.platform == "cuda"
              and hung["engine"] == "device"
              and hung["resumed_from_depth"] >= 4,
              f"supervisor warden hang: {hung}")
        emit({"phase": "supervisor", "part": "warden", "killed": r_kill,
              "hung": hung})

    # ---- portfolio on the swarm phase's lock twin.
    from tests import torch_harness_cases as H

    lock = H.make_lock_protocol(m=8, k=12, noise_bits=22)
    s = S.SearchSupervisor(
        lock, ladder=("device",), chunk=4096, frontier_cap=1 << 20,
        visited_cap=1 << 20, strict=False, max_secs=120.0, portfolio=True,
        swarm_kwargs=dict(walkers_per_device=128, max_steps=240,
                          steps_per_round=64, seed=0, visited_cap=1 << 14))
    o, r = supervised(s)
    w_ = o.witness
    lanes = {k: dict(end=v.end_condition, secs=v.elapsed_secs,
                     cancelled=v.cancelled)
             for k, v in s.lanes.items() if k in ("bfs", "swarm")}
    check(o.end_condition == "INVARIANT_VIOLATED" and w_ is not None
          and w_.replay_verified and len(w_.trace) == 12,
          f"supervisor portfolio: {r}, lanes {lanes}")
    emit({"phase": "supervisor", "part": "portfolio",
          "winner": s.lanes["winner"], "lanes": lanes,
          "witness": [len(w_.raw_trace), len(w_.trace)], **r})
    check(all(v > 0 for v in total.values()),
          f"supervisor phase skipped a kernel: {total}")
    emit({"phase": "supervisor", "secs": time.time() - t_phase,
          "launches": total})
    return total


# The telemetry phase: the flagship at the supervisor phase's width and
# depth, bare and recorded in turns, under a profiler window, under the
# supervisor with a recorder, and as a traced warden ladder.
TEL_PROFILE_STEPS = 4


def dispatch_counter(counts):
    """A ``_dispatch_hook`` counting dispatches per tag."""
    def hook(tag, fn, *args):
        counts[tag] = counts.get(tag, 0) + 1
        return fn(*args)
    return hook


def counted_run(torch, mods, ts):
    """``timed_search`` with a counting hook on the seam and the
    synchronising CUDA calls counted (``set_sync_debug_mode("warn")``,
    each warning recorded) -> (outcome, record + dispatches + syncs)."""
    import warnings

    counts = {}
    ts._dispatch_hook = dispatch_counter(counts)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            o, rec = timed_search(torch, mods, ts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    rec["dispatches"] = counts
    sites = {}
    for w in caught:
        # The sync debug mode's own warning; set_sync_debug_mode's one-off
        # prototype notice also says "synchronizing" and is not a sync.
        if "called a synchronizing" in str(w.message):
            at = f"{os.path.basename(w.filename)}:{w.lineno}"
            sites[at] = sites.get(at, 0) + 1
    rec["syncs"] = sum(sites.values())
    rec["sync_sites"] = sites
    return o, rec


def level_runs(levels):
    """Level records' depths split into runs that restart at depth 1 (a
    frontier-buffer growth restarts the device loop from the root)."""
    runs = []
    for lv in levels:
        if lv["depth"] == 1 or not runs:
            runs.append([])
        runs[-1].append(lv["depth"])
    return runs


def phase_telemetry(torch, mods, warm_up: bool = True):
    """The telemetry layer on the card (module docstring).  ``warm_up``
    runs the flagship once uncounted first, for a process in which no
    earlier phase has run it.  Returns the kernels' launches over the
    phase's in-process runs."""
    engine = mods["engine"]
    from dslabs_tpu_torch.tpu import supervisor as S
    from dslabs_tpu_torch.tpu import telemetry as T
    from dslabs_tpu_torch.tpu import tracing
    from dslabs_tpu_torch.tpu.warden import Warden

    t_phase = time.time()
    total = {"fingerprint_rows": 0, "insert": 0}
    pinned = FLAGSHIP_D7

    def search(**kw):
        gc.collect()
        torch.cuda.empty_cache()
        return engine.TensorSearch(flagship_protocol(), strict=True,
                                   max_depth=SUP_DEPTH, **SUP_CAPS, **kw)

    def add(launches):
        for k in total:
            total[k] += launches[k]

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        # ---- bare against recorded, in turns: B, R, B, R, in a warm
        # process (on an H100 the first run in a process made 96
        # synchronising calls, each later run 72).
        warm_secs = None
        if warm_up:
            o, r = timed_search(torch, mods, search())
            add(r["launches"])
            warm_secs = r["secs"]
        runs = []
        for i, kind in enumerate("BRBR"):
            tel = None
            if kind == "R":
                tel = T.Telemetry.for_checkpoint(
                    os.path.join(tmp, f"rec{i}", "search.ckpt"))
            o, r = counted_run(torch, mods, search(telemetry=tel))
            add(r["launches"])
            if tel is not None:
                tel.close()
                recs = T.read_flight(tel.flight_log)
                spans = [x for x in recs if x["t"] == "span"]
                levels = [x for x in recs if x["t"] == "level"]
                by_tag = {}
                for s in spans:
                    by_tag[s["tag"]] = by_tag.get(s["tag"], 0) + 1
                lruns = level_runs(levels)
                check(by_tag == r["dispatches"]
                      and lruns[-1] == list(range(1, SUP_DEPTH + 1))
                      and len(lruns) == by_tag["device.init"]
                      and all(x == list(range(1, len(x) + 1))
                              for x in lruns)
                      and os.path.exists(tel.status_path),
                      f"telemetry recorded run: spans {by_tag} against "
                      f"dispatches {r['dispatches']}, levels {lruns}")
                rep = T.build_report(recs)
                r["flight"] = dict(
                    records=len(recs),
                    bytes=os.path.getsize(tel.flight_log),
                    levels=len(levels), attempts=len(lruns),
                    sites={t: {q: rep["sites"][t][q]
                               for q in ("count", "p50", "p90", "total")}
                           for t in ("device.step", "device.sync",
                                     "device.promote")})
                r["step_wall"] = rep["sites"]["device.step"]["total"]
                r["sync_wall"] = rep["sites"]["device.sync"]["total"]
                r["spans"] = len(spans)
                if i == 1:
                    step5 = next(s["i"] for s in spans
                                 if s["tag"] == "device.step"
                                 and s["depth"] == 5)
                    step6 = next(s["i"] for s in spans
                                 if s["tag"] == "device.step"
                                 and s["depth"] == 6)
            check(r["key"] == pinned, f"telemetry run {kind}{i}: {r}")
            runs.append(r)
        b, rr = runs[0::2], runs[1::2]
        same = ("launches", "dispatches", "syncs")
        check(all(x[k] == b[0][k] for x in runs for k in same)
              and b[0]["syncs"] > 0,
              "telemetry: bare and recorded runs differ in "
              + json.dumps({f"{'BRBR'[i]}{i}": {k: x[k] for k in same}
                            for i, x in enumerate(runs)})
              + "; synchronising calls by site: "
              + json.dumps([x["sync_sites"] for x in runs]))
        med_b = statistics.median(x["secs"] for x in b)
        med_r = statistics.median(x["secs"] for x in rr)
        emit({"phase": "telemetry", "part": "bare_vs_recorded",
              "runs": [{"kind": "BRBR"[i], "secs": x["secs"],
                        "launches": x["launches"], "syncs": x["syncs"],
                        "dispatches": sum(x["dispatches"].values()),
                        "peak_mem_bytes": x["peak_mem_bytes"],
                        **({"flight": x["flight"], "spans": x["spans"],
                            "step_wall": x["step_wall"],
                            "sync_wall": x["sync_wall"]}
                           if "flight" in x else {})}
                       for i, x in enumerate(runs)],
              "median_ratio": med_r / med_b, "warm_up_secs": warm_secs,
              "dispatches_by_tag": b[0]["dispatches"]})

        # ---- the profiler window.
        pdir = os.path.join(tmp, "profile")
        tel = T.Telemetry(profile_dir=pdir,
                          profile_steps=TEL_PROFILE_STEPS)
        o, r = timed_search(torch, mods, search(telemetry=tel))
        tel.close()
        add(r["launches"])
        win = tel.profile
        check(r["key"] == pinned and win.error is None
              and win.trace_path is not None
              and os.path.exists(win.trace_path),
              f"telemetry profiler window: {r}, error {win.error}")
        with open(win.trace_path) as f:
            ev = json.load(f)["traceEvents"]
        kern = [e for e in ev if e.get("cat") == "kernel"]
        names = {n: sum(1 for e in kern if n in e.get("name", ""))
                 for n in ("fingerprint_rows_kernel", "insert_coop_kernel")}
        check(all(v > 0 for v in names.values()),
              f"telemetry profiler window: kernels {names} among "
              f"{len(kern)} kernel events")
        emit({"phase": "telemetry", "part": "profile_window",
              "secs": r["secs"], "steps": TEL_PROFILE_STEPS,
              "trace_bytes": os.path.getsize(win.trace_path),
              "kernel_events": len(kern), "ported_kernel_events": names,
              "device_ms": sum(e.get("dur", 0) for e in kern) / 1e3})

        # ---- the supervisor under a recorder: one transient on a
        # depth-5 chunk step.
        tel = T.Telemetry()
        sup = S.SearchSupervisor(
            flagship_protocol(), ladder=("device", "host"), strict=True,
            max_depth=SUP_DEPTH, telemetry=tel,
            fault_plan=S.FaultPlan().raise_at(step5),
            policy=S.RetryPolicy(backoff_base=0.01), **SUP_CAPS)
        kernels, visited = mods["kernels"], mods["visited"]
        kernels.LAUNCHES["fingerprint_rows"] = 0
        visited.LAUNCHES["insert"] = 0
        t0 = time.time()
        o = sup.run()
        torch.cuda.synchronize()
        secs = time.time() - t0
        add(kernel_counts(mods))
        kinds = [e["kind"] for e in tel.events if e.get("t") == "event"]
        span_retries = sum(s["retries"] for s in tel.ring
                           if s["t"] == "span")
        check([o.end_condition, o.unique_states, o.states_explored,
               o.depth] == pinned and o.retries == 1
              and "rung" in kinds and "retry" in kinds
              and span_retries == o.retries
              and o.trace_id == tel.trace_id,
              f"telemetry supervisor: retries {o.retries}, spans' "
              f"{span_retries}, events {kinds}")
        emit({"phase": "telemetry", "part": "supervisor", "at": step5,
              "secs": secs, "retries": o.retries,
              "span_retries": span_retries, "events": kinds,
              "summary": {k: v for k, v in tel.summary().items()
                          if k in ("spans", "dispatches", "events",
                                   "levels")}})

        # ---- a traced warden ladder: the first child hung on depth 6's
        # first step after a dump and reaped; the next resumes on the card.
        trace = tracing.mint_trace_id()
        run_dir = os.path.join(tmp, "warden")
        saved = os.environ.get(tracing.TRACE_ENV)
        os.environ[tracing.TRACE_ENV] = trace
        try:
            w = Warden(**WARDEN_FLAGSHIP, ladder=("device", "device", "host"),
                       max_depth=SUP_DEPTH, **SUP_CAPS,
                       checkpoint_path=os.path.join(run_dir, "warden.npz"),
                       checkpoint_every=1,
                       steady_grace=WARDEN_STEADY_GRACE,
                       grace_slack=WARDEN_SLACK,
                       fault={"kind": "hang", "at": step6, "spawns": [0],
                              "after_ckpt": True})
            t0 = time.time()
            o = w.run()
            secs = time.time() - t0
        finally:
            if saved is None:
                os.environ.pop(tracing.TRACE_ENV, None)
            else:
                os.environ[tracing.TRACE_ENV] = saved
        recs, torn = tracing.read_flight_lax(
            os.path.join(run_dir, "flight.jsonl"))
        segs = tracing.segment_flight(recs)
        dead = segs[0]["in_flight"] if segs else None
        watch = T.render_watch(run_dir)
        tr = tracing.assemble(run_dir)
        nodes = tr["jobs"][0]["nodes"]
        ids = {n["span_id"] for n in nodes}
        cli = {}
        for cmd in ("report", "trace"):
            p = subprocess.run(
                [sys.executable, "-m", "dslabs_tpu_torch.tpu.telemetry",
                 cmd, run_dir], capture_output=True, text=True, cwd=ROOT,
                timeout=120)
            cli[cmd] = [p.returncode, len(p.stdout)]
        check([o.end_condition, o.unique_states, o.states_explored,
               o.depth] == pinned and o.platform == "cuda"
              and [d.kind for d in w.deaths] == ["wedge"]
              and len(segs) == 2
              and all(s["meta"].get("trace_id") == trace for s in segs)
              and dead is not None and dead["tag"] == "device.step"
              and segs[1]["in_flight"] is None
              and "in-flight" in watch
              and tr["jobs"][0]["trace_id"] == trace
              and sum(1 for n in nodes if n["kind"] == "run") == 2
              and any(n["kind"] == "in_flight" for n in nodes)
              and all(n["parent"] is None or n["parent"] in ids
                      for n in nodes)
              and all(v[0] == 0 for v in cli.values()),
              f"telemetry warden: {o.end_condition} {o.unique_states} "
              f"{o.states_explored}, deaths {[d.kind for d in w.deaths]}, "
              f"segments {len(segs)}, dead {dead}, cli {cli}")
        emit({"phase": "telemetry", "part": "warden", "secs": secs,
              "trace_id": trace, "segments": len(segs), "torn_lines": torn,
              "in_flight": {k: dead[k] for k in ("tag", "i", "depth")},
              "resumed_from_depth": o.resumed_from_depth,
              "nodes": len(nodes), "phases": tr["jobs"][0]["phases"],
              "cli": cli})
    check(all(v > 0 for v in total.values()),
          f"telemetry phase skipped a kernel: {total}")
    emit({"phase": "telemetry", "secs": time.time() - t_phase,
          "launches": total})
    return total


# The analysis phase: the audit set's and the flagships' dispatch sites,
# each site's synchronising calls counted three ways.  The flagships'
# CPU predictions run the same code at a small size (sync counts do not
# depend on widths).
ANALYSIS_FLAGSHIP_CAPS = dict(chunk=4096, frontier_cap=1 << 20,
                              visited_cap=1 << 24)
ANALYSIS_CPU_CAPS = dict(chunk=16, frontier_cap=1 << 8, visited_cap=1 << 12)


def sync_debug_count(torch, fn, args) -> tuple:
    """The synchronising CUDA calls of one ``fn(*args)`` under
    ``torch.cuda.set_sync_debug_mode("warn")``, each warning recorded and
    filtered as ``counted_run`` filters them -> (count, their lines)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    at = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
          if "called a synchronizing" in str(w.message)]
    return len(at), at


def site_debug_counts(torch, sites) -> dict:
    """Per site function: its synchronising calls on the card in one call
    after an uncounted warm-up, on clones of its arguments (the audit's
    protocol)."""
    from dslabs_tpu_torch.analysis.hotpath_audit import (clone_args,
                                                         site_entries)

    out = {}
    for tag, name, e in site_entries(sites):
        e["fn"](*clone_args(tuple(e["args"])))
        args = clone_args(tuple(e["args"]))
        out[tag if name is None else f"{tag}:{name}"] = \
            sync_debug_count(torch, e["fn"], args)
    return out


def three_way(card: dict, debug: dict, cpu: dict, what: str) -> dict:
    """Each site's sync count on the card under sync debug mode, by the
    audit on the card and on the CPU, and its budget: all equal."""
    check(set(card) == set(debug) == set(cpu),
          f"{what}: site sets differ: card {sorted(card)}, debug "
          f"{sorted(debug)}, cpu {sorted(cpu)}")
    table = {}
    for k in sorted(card):
        row = dict(debug=debug[k][0], card=card[k]["syncs"],
                   cpu=cpu[k]["syncs"], budget=card[k]["budget"],
                   ops=card[k]["ops"])
        check(row["debug"] == row["card"] == row["cpu"] == row["budget"]
              == cpu[k]["budget"],
              f"{what} {k}: syncs debug {debug[k]}, audit on the card "
              f"{card[k]['sync_ops']}, on the CPU {cpu[k]['sync_ops']}, "
              f"budget {row['budget']}")
        table[k] = row
    return table


def phase_analysis(torch, mods):
    """The analysis layer on the card (module docstring).  Returns the
    kernels' launches over the phase's audits."""
    from dslabs_tpu_torch import analysis
    from dslabs_tpu_torch.analysis import hotpath_audit as HA
    from dslabs_tpu_torch.tpu.engine import TensorSearch

    from dslabs_tpu_torch.analysis import sync_cases as SC

    t_phase = time.time()
    kern, vis = mods["kernels"], mods["visited"]
    # The J1 rules on primitive calls (analysis/sync_cases.py): the
    # table's count, the sync debug mode's and the audit's on the card
    # and on the CPU, each after a warm-up call.
    rules = {}
    for name, (fn, want) in sorted(SC.CASES.items()):
        fn(SC.operand("cuda"))
        got = (sync_debug_count(torch, fn, (SC.operand("cuda"),))[0],
               len(HA.count_syncs(fn, (SC.operand("cuda"),))),
               len(HA.count_syncs(fn, (SC.operand("cpu"),))))
        check(got == (want,) * 3,
              f"sync rule {name}: table {want}, debug / audit on the card "
              f"/ on the CPU {got}")
        rules[name] = want
    t = time.time()
    conf = analysis.run_conformance()
    conf_secs = time.time() - t
    check(conf == [], "conformance findings: "
          + "; ".join(f.render() for f in conf))

    # The standard audit set (run_jaxpr, J5 rebuild included) on the card
    # and, as the prediction, on the CPU.
    torch.cuda.synchronize()
    kern.LAUNCHES["fingerprint_rows"] = 0
    vis.LAUNCHES["insert"] = 0
    t = time.time()
    card_rep, cpu_rep = {}, {}
    found = analysis.run_jaxpr(device="cuda", report=card_rep)
    check(not [f for f in found if not f.waived],
          "audit set findings on the card: "
          + "; ".join(f.render() for f in found))
    audit_secs = time.time() - t
    t = time.time()
    debug = {}
    for i, eng in enumerate(HA.build_audit_engines("cuda")):
        debug[f"{i}:{type(eng).__name__}"] = site_debug_counts(
            torch, eng.dispatch_site_programs())
    debug_secs = time.time() - t
    t = time.time()
    found = analysis.run_jaxpr(device="cpu", deep=False, report=cpu_rep)
    check(found == [], "audit set findings on the CPU: "
          + "; ".join(f.render() for f in found))
    cpu_secs = time.time() - t
    check(sorted(card_rep) == sorted(debug) == sorted(cpu_rep),
          f"audit sets differ: {sorted(card_rep)} {sorted(debug)} "
          f"{sorted(cpu_rep)}")
    audit_set = {eng: three_way(card_rep[eng], debug[eng], cpu_rep[eng],
                                eng) for eng in sorted(card_rep)}

    # The flagships at full width: the compiled packed twin and the hand
    # twin, each site audited and counted on the card, predicted on the
    # CPU at a small size.
    flagships = {}
    for name, proto in (("compiled", flagship_protocol()),
                        ("hand", hand_flagship_protocol())):
        t = time.time()
        gc.collect()
        torch.cuda.empty_cache()
        ts = TensorSearch(proto, strict=True, **ANALYSIS_FLAGSHIP_CAPS)
        sites = ts.dispatch_site_programs()
        before = dict(kern.LAUNCHES), dict(vis.LAUNCHES)
        rep = {}
        found = HA.audit_sites(sites, "TensorSearch", report=rep)
        torch.cuda.synchronize()
        launches = {
            "fingerprint_rows": kern.LAUNCHES["fingerprint_rows"]
            - before[0]["fingerprint_rows"],
            "insert": vis.LAUNCHES["insert"] - before[1]["insert"]}
        check(found == [], f"{name} flagship findings: "
              + "; ".join(f.render() for f in found))
        dbg = site_debug_counts(torch, sites)
        del sites, ts
        cpu = {}
        found = HA.audit_search(
            TensorSearch(proto, device="cpu", **ANALYSIS_CPU_CAPS),
            report=cpu)
        check(found == [], f"{name} flagship findings on the CPU: "
              + "; ".join(f.render() for f in found))
        table = three_way(rep, dbg, cpu, f"{name} flagship")
        check(table["device.step"]["debug"]
              == (1 if name == "compiled" else 0),
              f"{name} flagship device.step: {table['device.step']}")
        check(launches["fingerprint_rows"] > 0 and launches["insert"] > 0,
              f"{name} flagship audit skipped a kernel: {launches}")
        flagships[name] = dict(
            step_syncs=table["device.step"]["debug"],
            step_ops=table["device.step"]["ops"],
            step_sync_lines=dbg["device.step"][1],
            launches=launches, secs=time.time() - t, sites=table)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    total = {"fingerprint_rows": kern.LAUNCHES["fingerprint_rows"],
             "insert": vis.LAUNCHES["insert"]}
    check(all(v > 0 for v in total.values()),
          f"analysis phase skipped a kernel: {total}")
    emit({"phase": "analysis", "secs": time.time() - t_phase,
          "sync_rules": rules,
          "conformance": {"findings": len(conf), "secs": conf_secs},
          "audit_set": {"findings": 0, "card_secs": audit_secs,
                        "debug_secs": debug_secs, "cpu_secs": cpu_secs,
                        "sites": audit_set},
          "flagships": flagships, "launches": total})
    return total


# The lanes phase: the compiled packed flagship at full width in L-lane
# batches at chunk 1024 (one lane step holds the solo step's 4,096 rows),
# to depth 8; the mixed batch's per-job depth limits (more jobs than lanes,
# so lanes are refilled); the killed batch child's depth limit and the
# dispatch index its SIGKILL fires at (depth 5's superstep: init is 0,
# then superstep, sync and promote per level, each lane dumped after its
# promote); the poisoned-lane pair's caps.
LANE_L = 4
LANE_DEPTH = 8
LANE_CAPS = dict(chunk=1024, frontier_cap=1 << 20, visited_cap=1 << 20)
LANE_MIXED = (4, 5, 6, 5, 4, 6)
LANE_KILL_DEPTH = 6
LANE_KILL_AT = 13
LANE_EVICT_CAPS = dict(chunk=64, frontier_cap=1 << 10, visited_cap=64)
LANE_FLAGSHIP = dict(WARDEN_FLAGSHIP, factory_kwargs=dict(FLAGSHIP_KW))


def prune_done(proto):
    """The lab 1 twin with its completion goal as a prune, as the
    reference's lane tests build it (the search runs the whole space)."""
    return dataclasses.replace(proto, goals={},
                               prunes={"CLIENTS_DONE":
                                       proto.goals["CLIENTS_DONE"]})


class LaunchSpy:
    """A ``_dispatch`` hook that counts an engine's dispatches by tag and
    the kernels' launches inside each tag's dispatches."""

    def __init__(self, mods):
        self.mods = mods
        self.tags = {}
        self.launches = {}

    def __call__(self, tag, fn, *args):
        before = kernel_counts(self.mods)
        out = fn(*args)
        self.tags[tag] = self.tags.get(tag, 0) + 1
        got = self.launches.setdefault(tag, {k: 0 for k in before})
        for k, v in kernel_counts(self.mods).items():
            got[k] += v - before[k]
        return out

    @property
    def dispatches(self) -> int:
        return sum(self.tags.values())


def lane_run(torch, mods, ls, jobs, **kw):
    """``ls.run_lanes(jobs)`` with the kernel counts set to 0 just before
    and read just after, and a LaunchSpy at the seam -> (result, record:
    seconds, unique/min summed over the lanes, peak device memory, lane
    steps, dispatches by tag, launches of each kernel in all and inside
    the supersteps)."""
    spy = LaunchSpy(mods)
    ls._dispatch_hook = spy
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mods["kernels"].LAUNCHES["fingerprint_rows"] = 0
    mods["visited"].LAUNCHES["insert"] = 0
    steps0 = ls.chunk_steps
    t0 = time.time()
    res = ls.run_lanes(jobs, **kw)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = kernel_counts(mods)
    unique = sum(o.unique_states for o in res.outcomes.values())
    step_launches = spy.launches.get("lanes.superstep",
                                     {k: 0 for k in launches})
    lane_steps = ls.chunk_steps - steps0
    check(step_launches["fingerprint_rows"] == lane_steps
          and step_launches["insert"] == ls.L * lane_steps,
          f"lane steps {lane_steps} at L={ls.L}: superstep launches "
          f"{step_launches}")
    return res, dict(
        secs=secs, unique_per_min=unique / secs * 60,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        lane_steps=lane_steps, levels=res.levels, swaps=res.swaps,
        occupancy=res.occupancy, dispatches=spy.dispatches,
        dispatches_by_tag=dict(spy.tags), launches=launches,
        superstep_launches=step_launches,
        jobs={j: [o.end_condition, o.unique_states, o.states_explored,
                  o.depth] for j, o in sorted(res.outcomes.items())},
        errors=dict(res.errors))


def phase_lanes(torch, mods):
    """Batched job lanes on the card (module docstring).  Returns the
    kernels' launches over the phase's in-process lane batches."""
    engine = mods["engine"]
    from dslabs_tpu_torch.tpu.lanes import LaneBatchWarden, LaneJob, \
        LaneSearch

    t_phase = time.time()
    total = {"fingerprint_rows": 0, "insert": 0}
    pinned = ["DEPTH_EXHAUSTED", FLAGSHIP_D8_UNIQUE, FLAGSHIP_D8_EXPLORED,
              LANE_DEPTH]
    fl = flagship_protocol()

    def add(rec):
        for k in total:
            total[k] += rec["launches"][k]

    # ---- four solo runs of the job, at chunk 4096, each with its
    # dispatches counted at the seam.
    solo = []
    for _ in range(4):
        ts = engine.TensorSearch(fl, strict=True, max_depth=LANE_DEPTH,
                                 **SUP_CAPS)
        spy = LaunchSpy(mods)
        ts._dispatch_hook = spy
        o, rec = timed_search(torch, mods, ts)
        check(rec["key"] == pinned, f"lanes solo: {rec}")
        solo.append(dict(rec, dispatches=spy.dispatches))
        del ts
    solo_secs = sum(r["secs"] for r in solo)
    solo_disp = statistics.mean(r["dispatches"] for r in solo)

    # ---- L identical jobs in one batch.
    ls = LaneSearch(fl, n_lanes=LANE_L, strict=True, **LANE_CAPS)
    check((ls.lanes, ls.plane) == (842, 217),
          f"lane flagship lanes {ls.lanes}, plane {ls.plane}")
    res, same = lane_run(torch, mods, ls, [
        LaneJob(f"same{i}", max_depth=LANE_DEPTH) for i in range(LANE_L)])
    add(same)
    check(not res.errors and all(v == pinned for v in same["jobs"].values())
          and len(same["jobs"]) == LANE_L, f"lanes identical: {same}")
    check(same["dispatches_by_tag"]["lanes.superstep"] == res.levels
          == LANE_DEPTH, f"lanes identical supersteps: {same}")
    disp_ratio = same["dispatches"] / LANE_L / solo_disp
    check(disp_ratio <= 0.5, f"lanes dispatches per job {disp_ratio} x solo")
    check(abs(sum(o.lane_share for o in res.outcomes.values()) - 1.0)
          < 1e-4, f"lanes identical shares: {res.outcomes}")
    del ls, res

    # ---- a batch child on the card SIGKILLed after its lanes' depth-4
    # dumps, respawned by the warden, every lane resumed on the card from
    # its own dump.  The children run in their own processes while the
    # mixed and evict batches below run here (after the timed identical
    # batch, so its wall against the solo walls is taken alone).
    kill_dir = tempfile.TemporaryDirectory(dir=ROOT)
    kill_jobs = [{"job_id": f"kill{i}", "max_depth": LANE_KILL_DEPTH,
                  "checkpoint_path": os.path.join(kill_dir.name, f"kill{i}",
                                                  "ckpt.npz"),
                  "checkpoint_every": 1} for i in range(2)]
    for j in kill_jobs:
        os.makedirs(os.path.dirname(j["checkpoint_path"]))
    kill_w = LaneBatchWarden(jobs=kill_jobs, n_lanes=2, strict=True,
                             run_dir=os.path.join(kill_dir.name, "batch"),
                             fault={"kind": "die", "at": LANE_KILL_AT},
                             steady_grace=60.0, max_restarts=1,
                             **LANE_FLAGSHIP, **LANE_CAPS)

    def kill_batch():
        t0 = time.time()
        kres = kill_w.run()
        return kres, time.time() - t0

    pool = concurrent.futures.ThreadPoolExecutor(1)
    f_kill = pool.submit(kill_batch)
    try:
        mixed, evict, refs = lanes_beside_kill(torch, mods, fl, pinned, add)
        kres, kill_secs = f_kill.result()
        status = json.load(open(os.path.join(kill_dir.name, "batch",
                                             "STATUS.json")))
    finally:
        pool.shutdown(wait=True)
        kill_dir.cleanup()
    killed = dict(
        secs=kill_secs, deaths=kill_w.deaths, child_restarts=kres.child_restarts,
        platform=kill_w.last_platform, levels=kres.levels, errors=kres.errors,
        status_lanes=status.get("lanes"),
        jobs={j: [o.end_condition, o.unique_states, o.states_explored,
                  o.depth, o.resumed_from_depth, o.platform]
              for j, o in sorted(kres.outcomes.items())})
    want = refs[LANE_KILL_DEPTH] + [4, "cuda"]
    check(not kres.errors and [d["kind"] for d in kill_w.deaths] == ["oom"]
          and kres.child_restarts == 1 and kill_w.last_platform == "cuda"
          and killed["status_lanes"]
          and killed["jobs"] == {j["job_id"]: want for j in kill_jobs}
          and kres.levels == LANE_KILL_DEPTH - 4
          and abs(sum(o.lane_share for o in kres.outcomes.values()) - 1.0)
          < 1e-4,
          f"lanes kill/respawn: {killed}, solo {refs[LANE_KILL_DEPTH]}")
    check(all(v > 0 for v in total.values()),
          f"lanes phase skipped a kernel: {total}")
    emit({"phase": "lanes", "secs": time.time() - t_phase,
          "L": LANE_L, "caps": LANE_CAPS, "depth": LANE_DEPTH,
          "solo": solo, "identical": same,
          "wall_vs_four_solo": same["secs"] / solo_secs,
          "dispatches_per_job_vs_solo": disp_ratio,
          "mixed": mixed, "mixed_limits": LANE_MIXED, "mixed_solo": refs,
          "killed": killed, "evict": evict, "launches": total})
    return total


def lanes_beside_kill(torch, mods, fl, pinned, add):
    """The lanes phase's in-process batches that run beside the killed
    batch's children: the mixed batch with its solo references, and the
    poisoned lane.  Returns (mixed record, evict record, solo keys by
    depth limit)."""
    engine = mods["engine"]
    from dslabs_tpu_torch.tpu.lanes import LaneJob, LaneSearch
    from dslabs_tpu_torch.tpu.protocols.clientserver import \
        make_clientserver_protocol

    def key(o):
        return [o.end_condition, o.unique_states, o.states_explored, o.depth]

    # ---- a mixed batch: more jobs than lanes, per-job depth limits, each
    # job against a solo device-loop run of the same job.
    refs = {LANE_DEPTH: pinned}
    for d in sorted(set(LANE_MIXED) - {LANE_DEPTH}):
        o = engine.TensorSearch(fl, strict=True, max_depth=d,
                                **SUP_CAPS).run()
        refs[d] = key(o)
    ls = LaneSearch(fl, n_lanes=LANE_L, strict=True, **LANE_CAPS)
    res, mixed = lane_run(torch, mods, ls, [
        LaneJob(f"mix{i}", max_depth=d) for i, d in enumerate(LANE_MIXED)])
    add(mixed)
    check(not res.errors and res.swaps >= 2
          and mixed["jobs"] == {f"mix{i}": refs[d]
                                for i, d in enumerate(LANE_MIXED)},
          f"lanes mixed: {mixed}, solo {refs}")
    del ls, res

    # ---- a poisoned lane (strict table pressure) evicted, its lane-mate
    # equal to its solo run.
    lab1 = prune_done(make_clientserver_protocol(n_clients=2, w=2))
    try:
        engine.TensorSearch(lab1, strict=True, **LANE_EVICT_CAPS).run()
        check(False, "lanes evict: the solo full-space run did not raise")
    except engine.CapacityOverflow:
        pass
    ref3 = key(engine.TensorSearch(lab1, strict=True, max_depth=3,
                                   **LANE_EVICT_CAPS).run())
    ls = LaneSearch(lab1, n_lanes=2, strict=True, **LANE_EVICT_CAPS)
    res, evict = lane_run(torch, mods, ls, [LaneJob("big"),
                                            LaneJob("small", max_depth=3)])
    add(evict)
    check(list(res.errors) == ["big"]
          and "CapacityOverflow" in res.errors["big"]
          and evict["jobs"] == {"small": ref3},
          f"lanes evict: {evict}, solo {ref3}")
    return mixed, evict, refs


# The service phase's jobs: each of two tenants submits two pingpong jobs
# and one lab 1 client/server job.  The three drains run SERVICE_WORKERS
# worker at a time: the solo drain one warden child per job, the CLI's
# drain one lane batch child per batch, the memo drain one warden child
# per job its verdict cache cannot answer.
SERVICE_JOBS = (
    ("dslabs_tpu_torch.tpu.protocols.pingpong:make_exhaustive_pingpong",
     {"workload_size": 2}),
    ("dslabs_tpu_torch.tpu.protocols.pingpong:make_exhaustive_pingpong",
     {"workload_size": 2}),
    ("dslabs_tpu_torch.tpu.protocols.clientserver:"
     "make_clientserver_protocol", {"n_clients": 2, "w": 2}),
)
# The CLI's submit sets only the chunk: the caps are the service's
# defaults (frontier_cap 2^14, visited_cap 2^20) for every job, so that all
# jobs of one factory share a lane signature.
SERVICE_CAPS = dict(chunk=64)
SERVICE_LANES = 4
SERVICE_QUOTA = 3
SERVICE_WORKERS = 1
# Arguments the CLI's drain gets (none: its jobs run on the card).
SERVICE_CLI_ARGS = ()


def phase_service(torch, mods):
    """The checking service on the card (module docstring)."""
    from dslabs_tpu_torch.service import memo as memo_mod
    from dslabs_tpu_torch.service.server import CheckServer
    from dslabs_tpu_torch.tpu import tracing

    t_phase = time.time()
    secs = {}

    def server(root, memo=False, admission=True, **kw):
        return CheckServer(root, admission=admission, quota=SERVICE_QUOTA,
                           elastic=False, memo=memo, **kw)

    def submit(srv, jobs):
        for tenant, (factory, kw) in jobs:
            r = srv.submit(factory, tenant=tenant, factory_kwargs=kw,
                           **SERVICE_CAPS)
            check(r.get("accepted"), f"service submit: {r}")

    def cli(*argv):
        t0 = time.time()
        p = subprocess.run([sys.executable, "-m", "dslabs_tpu_torch.service",
                            *argv], capture_output=True, text=True,
                           cwd=ROOT, timeout=600)
        secs[f"cli_{argv[0]}"] = time.time() - t0
        check(p.returncode == 0, f"service CLI {argv[0]}: rc "
              f"{p.returncode}: {p.stderr[-1500:]}")
        return json.loads(p.stdout.strip().splitlines()[-1])

    jobs = [(t, j) for t in ("alice", "bob") for j in SERVICE_JOBS]
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        roots = {m: os.path.join(tmp, m) for m in ("solo", "lanes", "memo")}

        def solo_side():
            # One warden child per job.
            t0 = time.time()
            srv = server(roots["solo"], workers=SERVICE_WORKERS, lanes=0)
            submit(srv, jobs)
            secs["solo_submit"] = time.time() - t0
            t0 = time.time()
            summary = srv.drain(max_secs=600)
            srv.close()
            secs["solo_drain"] = time.time() - t0
            return summary

        def lanes_side():
            # The same jobs, the last one submitted through the CLI, the
            # backlog drained in lane batches by the CLI.
            t0 = time.time()
            srv = server(roots["lanes"])
            submit(srv, jobs[:-1])
            srv.close()
            tenant, (factory, kw) = jobs[-1]
            sub = cli("submit", "--root", roots["lanes"], "--tenant",
                      tenant, "--factory", factory, "--kwargs",
                      json.dumps(kw), "--chunk", str(SERVICE_CAPS["chunk"]),
                      "--no-memo")
            secs["lanes_submit"] = time.time() - t0
            st = cli("status", "--root", roots["lanes"])
            summary = cli("drain", "--root", roots["lanes"], "--lanes",
                          str(SERVICE_LANES), "--quota", str(SERVICE_QUOTA),
                          "--workers", str(SERVICE_WORKERS), "--full",
                          "--no-memo", *SERVICE_CLI_ARGS)
            check(sub["accepted"]
                  and st["queue"]["queue_depth"] == len(jobs),
                  f"service CLI submit {sub}, status {st}")
            return summary

        def memo_side():
            # The solo drain's jobs with the memo on (lane batches bypass
            # it): each job whose identical twin ran first is answered
            # from the verdict cache.
            t0 = time.time()
            srv = server(roots["memo"], memo=True, workers=SERVICE_WORKERS,
                         lanes=0, admission=False)
            submit(srv, jobs)
            secs["memo_submit"] = time.time() - t0
            t0 = time.time()
            summary = srv.drain(max_secs=600)
            srv.close()
            secs["memo_drain"] = time.time() - t0
            return summary

        # The three servers are independent (own roots, own children):
        # they run side by side, as tenants' front ends would.
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            f_solo, f_lane, f_memo = (pool.submit(solo_side),
                                      pool.submit(lanes_side),
                                      pool.submit(memo_side))
            solo, lane, memo = (f_solo.result(), f_lane.result(),
                                f_memo.result())
        key = ("tenant", "end", "unique", "explored", "depth")
        verdicts = {m: sorted(tuple(r.get(k) for k in key)
                              for r in d["results"])
                    for m, d in (("solo", solo), ("lanes", lane))}
        check(solo["failed"] == lane["failed"] == 0
              and len(solo["results"]) == len(lane["results"]) == len(jobs)
              and verdicts["solo"] == verdicts["lanes"]
              and all(r["platform"] == "cuda"
                      for d in (solo, lane) for r in d["results"]),
              f"service verdicts: {verdicts}, solo {solo['results']}, "
              f"lanes {lane['results']}")
        costs = {}
        for m in ("solo", "lanes"):
            recs, torn = tracing.read_flight_lax(
                os.path.join(roots[m], tracing.COSTS_NAME))
            check(torn == 0, f"service {m} COSTS torn")
            costs[m] = tracing.aggregate_costs(recs)
        for t in ("alice", "bob"):
            check(all(costs["solo"][t][k] == costs["lanes"][t][k]
                      for k in ("explored", "unique")),
                  f"service COSTS {t}: {costs}")
        ratio = lane["dispatches_per_job"] / solo["dispatches_per_job"]
        check(ratio <= 0.5, f"service dispatches per job: lanes "
              f"{lane['dispatches_per_job']}, solo "
              f"{solo['dispatches_per_job']}")
        shares = {}
        for r in lane["results"]:
            shares.setdefault(r["lane_batch"], []).append(r["lane_share"])
        check(all(abs(sum(v) - 1.0) < 1e-4 for v in shares.values())
              and lane["lanes"]["jobs_in_lanes"] == len(jobs)
              and lane["lanes"]["evicted"] == 0,
              f"service lane shares {shares}, lanes {lane['lanes']}")
        status = json.load(open(os.path.join(roots["lanes"],
                                             "SERVER_STATUS.json")))
        check(status["lanes"] == lane["lanes"],
              f"SERVER_STATUS lanes {status['lanes']} vs drain "
              f"{lane['lanes']}")
        job_id = lane["results"][0]["job_id"]
        tr = tracing.assemble(roots["lanes"], job=job_id)
        nodes = tr["jobs"][0]["nodes"] if tr["jobs"] else []
        check(tr["mode"] == "service"
              and any(n["kind"] == "lane_batch" and n.get("shared")
                      for n in nodes),
              f"service trace of {job_id}: {[n['kind'] for n in nodes]}")

        # The memo drain: the solo drain's verdicts; every job whose
        # identical twin (same factory and kwargs) ran first is a memo_hit
        # (unless its end is one the memo never caches), with no warden
        # child and no flight log, and its causal tree has the memo node.
        solo_journal, _ = tracing.read_flight_lax(
            os.path.join(roots["solo"], "journal.jsonl"))
        job_key = {e["job"]["job_id"]: (e["job"]["factory"], json.dumps(
            e["job"]["factory_kwargs"], sort_keys=True))
            for e in solo_journal if e.get("t") == "submit"}
        ends = {job_key[r["job_id"]]: r["end"] for r in solo["results"]}
        want_hits = sum(
            sum(1 for _t, (f, kw) in jobs
                if (f, json.dumps(kw, sort_keys=True)) == k) - 1
            for k, end in ends.items()
            if end not in memo_mod.UNCACHEABLE_ENDS)
        memo_v = sorted(tuple(r.get(k) for k in key)
                        for r in memo["results"])
        journal, _ = tracing.read_flight_lax(
            os.path.join(roots["memo"], "journal.jsonl"))
        hits = [e["job_id"] for e in journal if e.get("t") == "memo_hit"]
        started = {e["job_id"] for e in journal if e.get("t") == "start"}
        check(memo["failed"] == 0 and memo_v == verdicts["solo"]
              and len(hits) == want_hits == memo["memo"]["hits"]
              and not started & set(hits)
              and not any(os.path.exists(os.path.join(
                  roots["memo"], "jobs", j, "flight.jsonl")) for j in hits)
              and all(r.get("cached") or r["platform"] == "cuda"
                      for r in memo["results"]),
              f"service memo: verdicts {memo_v}, hits {hits} (want "
              f"{want_hits}), started {started}, memo {memo['memo']}")
        hit_trees = []
        for j in hits:
            tr = tracing.assemble(roots["memo"], job=j)
            kinds = [n["kind"] for n in tr["jobs"][0]["nodes"]]
            hit_trees.append(kinds)
            check("memo" in kinds and "attempt" not in kinds,
                  f"service memo trace of {j}: {kinds}")

    def brief(d):
        return {k: d[k] for k in ("wall_secs", "dispatches_per_job",
                                  "device_secs", "verdicts_per_min",
                                  "fairness_index", "lanes")}

    emit({"phase": "service", "secs": time.time() - t_phase,
          "verdicts": verdicts["solo"], "solo": brief(solo),
          "lanes": brief(lane), "memo_drain": dict(brief(memo),
                                                    memo=memo["memo"]),
          "memo_hits": len(hits), "memo_hit_trees": hit_trees,
          "dispatches_per_job_ratio": ratio,
          "lane_shares": shares, "costs": costs, "step_secs": secs})


# The memo phase (in process, at full width): the compiled packed
# flagship at the supervisor phase's caps, a cold run to MEMO_DEPTH with a
# dump per level, archived; the warm start one level deeper (the
# supervisor phase's depth-7 pins); the verdict-cache hit; the incremental
# re-check of memo_edited_flagship.
MEMO_DEPTH = 6
MEMO_LADDER = ("device", "host")


def memo_edited_flagship():
    """The flagship with one handler edited: the leader drops every
    heartbeat reply (no peer progress recorded, no log GC).  The root's
    events cannot fire that handler: a HeartbeatReply first exists four
    levels down."""
    from dslabs_tpu_torch.tpu.specs_lab3 import make_paxos_spec

    spec = make_paxos_spec(**FLAGSHIP_KW)

    def srv_heartbeat_reply_dropped(ctx, p):
        return

    spec.handlers[("server", "HeartbeatReply")] = srv_heartbeat_reply_dropped
    return dataclasses.replace(spec.compile(), goals={})


def memo_kernels(torch, mods, ck, pk):
    """Both kernels bit-exact against their plain versions at the memo
    path's new shapes, then timed by CUDA events: kernel 2 rebuilding the
    seed dump's key set into the warm run's 2^20 slots (the resume's
    ``visited.build_table``), kernel 1 on the seed's frontier rows
    (unpacked)."""
    kernels, visited, engine = mods["kernels"], mods["visited"], \
        mods["engine"]
    out = {}
    V = SUP_CAPS["visited_cap"]
    keys = torch.from_numpy(ck.visited_keys.view("int32")).to("cuda")
    valid = torch.ones((len(keys),), dtype=torch.bool, device="cuda")
    ta, ia, ua = visited.insert(visited.empty_table(V, "cuda"), keys, valid)
    tb, ib, ub = visited.insert_plain(visited.empty_table(V, "cuda"), keys,
                                      valid)
    check(torch.equal(ta[:-1], tb[:-1]) and torch.equal(ia, ib)
          and torch.equal(ua, ub) and not bool(ua.any()),
          "memo: build_table of the seed's keys disagrees with insert_plain")
    n_ins = int(ia.sum())
    del ta, tb
    ms = cuda_ms(torch, lambda t: visited.insert(t, keys, valid),
                 setup=lambda: visited.empty_table(V, "cuda"), reps=10)
    plain = cuda_ms(torch, lambda t: visited.insert_plain(t, keys, valid),
                    setup=lambda: visited.empty_table(V, "cuda"), reps=5,
                    warmup=1)
    n = len(keys)
    b_ms, b_by = bound_ms(n * 17 + n * 128 + n_ins * 16 + n * 2, 0)
    out["insert"] = dict(shape=dict(V=V, N=n), inserted=n_ins,
                         max_abs_err=0, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by)
    rows = pk.unpack(torch.from_numpy(ck.frontier).to("cuda")).contiguous()
    m, L = rows.shape
    k = kernels.fingerprint_rows(rows)
    p = engine.row_fingerprints(rows)
    check(torch.equal(k, p), f"memo: fingerprint_rows on the seed's rows "
          f"[{m}, {L}] disagrees with its plain version")
    ms = cuda_ms(torch, lambda _: kernels.fingerprint_rows(rows), reps=10)
    plain = cuda_ms(torch, lambda _: engine.row_fingerprints(rows),
                    reps=5, warmup=1)
    b_ms, b_by = bound_ms(m * L * 4 + m * 16, m * L * FP_OPS_PER_LANE)
    out["fingerprint_rows"] = dict(shape=[m, L], max_abs_err=0, ms=ms,
                                   plain_ms=plain, bound_ms=b_ms,
                                   bound_by=b_by)
    return out


def phase_memo(torch, mods):
    """Cross-job memoization on the card (module docstring).  Returns the
    kernels' launches over the phase's searches."""
    engine = mods["engine"]
    from dslabs_tpu_torch.service import memo as memo_mod
    from dslabs_tpu_torch.tpu import checkpoint as ckpt_mod

    t_phase = time.time()
    total = {"fingerprint_rows": 0, "insert": 0}
    runs = {}

    def search(name, proto, depth, rd=None, seed=None):
        """One search of ``proto`` to ``depth`` on the card; with ``rd`` a
        dump per level and its per-level archive in ``rd``, with ``seed``
        resumed from a copy of that dump."""
        kw = {}
        if rd is not None:
            os.makedirs(rd, exist_ok=True)
            kw = dict(checkpoint_path=os.path.join(rd, "ckpt.npz"),
                      checkpoint_every=1,
                      levels_dir=os.path.join(rd, "levels"))
            if seed is not None:
                shutil.copyfile(seed, kw["checkpoint_path"])
        ts = engine.TensorSearch(proto, strict=True, max_depth=depth,
                                 **SUP_CAPS, **kw)
        o, rec = timed_search(torch, mods, ts, resume=seed is not None)
        rec["resumed_from_depth"] = o.resumed_from_depth
        check(all(v > 0 for v in rec["launches"].values()),
              f"memo {name}: a kernel did not launch: {rec}")
        for k in total:
            total[k] += rec["launches"][k]
        runs[name] = rec
        del ts
        torch.cuda.empty_cache()
        return o, rec

    def plan(intro, depth):
        return store.plan(intro, True, SUP_CAPS["chunk"],
                          SUP_CAPS["frontier_cap"], SUP_CAPS["visited_cap"],
                          MEMO_LADDER, depth, None)

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        flag = flagship_protocol()
        t0 = time.time()
        intro = memo_mod.introspect_protocol(flag)
        intro_secs = time.time() - t0
        check(intro["kind"] == "spec" and not intro["weak"],
              f"memo: the flagship's fingerprint: {intro['kind']}, weak "
              f"{intro['weak']}")

        # ---- cold, archived.
        cold_dir = os.path.join(tmp, "cold")
        o, r_cold = search("cold", flag, MEMO_DEPTH, cold_dir)
        levels = sorted(os.listdir(os.path.join(cold_dir, "levels")))
        check(o.end_condition == "DEPTH_EXHAUSTED" and o.depth == MEMO_DEPTH
              and ckpt_mod.peek_depth(os.path.join(cold_dir, "ckpt.npz"))
              == MEMO_DEPTH and f"level_{MEMO_DEPTH}.npz" in levels,
              f"memo cold: {r_cold}, levels {levels}")
        store = memo_mod.MemoStore(os.path.join(tmp, "memo"))
        fields = memo_mod.key_fields(
            intro, True, SUP_CAPS["chunk"], SUP_CAPS["frontier_cap"],
            SUP_CAPS["visited_cap"], MEMO_LADDER)
        verdict = {"status": "done", "end": o.end_condition,
                   "unique": o.unique_states,
                   "explored": o.states_explored, "depth": o.depth,
                   "engine": "device", "predicate": o.predicate_name,
                   "witness": memo_mod.witness_digest(
                       o.predicate_name, o.violating_state, o.goal_state,
                       o.trace)}
        t0 = time.time()
        sig = store.archive(intro, fields, verdict, cold_dir,
                            r_cold["secs"])
        stored = store.record_verdict(fields, MEMO_DEPTH, None, verdict,
                                      r_cold["secs"])
        archive_secs = time.time() - t0
        check(sig is not None and stored, f"memo archive: {sig} {stored}")
        tier_keys = store._load_sig(sig)["tier_keys"]

        # ---- warm: one level deeper than the archive.
        p_warm = plan(intro, MEMO_DEPTH + 1)
        check(p_warm.mode == "warm" and p_warm.seed_depth == MEMO_DEPTH,
              f"memo warm plan: {p_warm.mode} {p_warm.seed_depth} "
              f"{p_warm.reason}")
        seed = ckpt_mod.load(p_warm.seed_ckpt, fields["ckpt_fp"])
        o, r_warm = search("warm", flag, MEMO_DEPTH + 1,
                           os.path.join(tmp, "warm"), p_warm.seed_ckpt)
        check(r_warm["key"] == FLAGSHIP_D7
              and o.resumed_from_depth == MEMO_DEPTH,
              f"memo warm: {r_warm} against {FLAGSHIP_D7}")

        # ---- the exact hit: no search at all.
        before = kernel_counts(mods)
        t0 = time.time()
        p_hit = plan(intro, MEMO_DEPTH)
        hit_secs = time.time() - t0
        hit_launches = {k: v - before[k]
                        for k, v in kernel_counts(mods).items()}
        check(p_hit.mode == "hit"
              and all(p_hit.verdict[k] == verdict[k] for k in (
                  "end", "unique", "explored", "depth", "witness"))
              and not any(hit_launches.values()),
              f"memo hit: {p_hit.mode} {p_hit.verdict} {hit_launches}")

        # ---- incremental: one handler edited.
        edited = memo_edited_flagship()
        t0 = time.time()
        intro_e = memo_mod.introspect_protocol(edited)
        intro_e_secs = time.time() - t0
        changed = sorted(h for h in intro["handlers"]
                         if intro["handlers"][h] != intro_e["handlers"][h])
        check(not intro_e["weak"]
              and changed == ["m:server:HeartbeatReply"]
              and intro_e["base_fp"] == intro["base_fp"],
              f"memo edited flagship: weak {intro_e['weak']}, changed "
              f"{changed}")
        p_inc = plan(intro_e, MEMO_DEPTH)
        check(p_inc.mode == "incremental" and p_inc.levels_skipped >= 1,
              f"memo incremental plan: {p_inc.mode} {p_inc.reason}")
        o, r_inc = search("incremental", edited, MEMO_DEPTH,
                          os.path.join(tmp, "inc"), p_inc.seed_ckpt)
        _, r_edit = search("edited_cold", edited, MEMO_DEPTH)
        check(r_inc["key"] == r_edit["key"]
              and o.resumed_from_depth == p_inc.seed_depth,
              f"memo incremental: {r_inc} against the cold {r_edit}")

        pk = engine.TensorSearch(flag, strict=True, **SUP_CAPS)._pk
        kern = memo_kernels(torch, mods, seed, pk)
        del seed
    emit({"phase": "memo", "secs": time.time() - t_phase,
          "introspect_secs": intro_secs,
          "introspect_edited_secs": intro_e_secs,
          "archive_secs": archive_secs, "levels": levels,
          "tier_keys": tier_keys,
          "plans": {"warm": [p_warm.mode, p_warm.seed_depth,
                             p_warm.levels_skipped],
                    "hit": [p_hit.mode, 0, 0],
                    "incremental": [p_inc.mode, p_inc.seed_depth,
                                    p_inc.levels_skipped, p_inc.reason]},
          "hit_secs": hit_secs, "hit_launches": hit_launches,
          "runs": runs, "kernels": kern, "launches": total})
    return total


# The sharded phase: the compiled packed flagship on ShardedTensorSearch
# at D = 1 and D = 4 (chunk_per_device 4096 // D, so every chunk step
# expands the solo step's 4,096 rows), caps per shard; the resume cut
# (a D = 4 run to depth 7 dumps at depth 6 only); the small width matrix.
SHARD_WIDTHS = (1, 4)
SHARD_DEPTH = 8
SHARD_CUT_DEPTH = 6
SHARD_CAPS = dict(frontier_cap=1 << 17, visited_cap=1 << 20)
SHARD_ROWS = 4096
SHARD_MATRIX = {"pingpong": ("SPACE_EXHAUSTED", 8, 23, 5),
                "lab1": ("SPACE_EXHAUSTED", 80, 582, 11)}


def sharded_kernel_checks(torch, mods, proto, D: int = 4, ts=None,
                          one_shard: bool = False):
    """Both kernels at the width-D chunk step's shapes, bit-exact against
    their plain versions on inputs captured from a flagship run (counted
    apart from the main-path runs): kernel 1 on the step's [D*C*B, 842]
    successor rows (the run's last step; with ``one_shard`` the first
    shard's [C*B, 842], a rank's shape), kernel 2 on a shard's table with
    the D*bucket received keys of the run's fullest batch (invalid slots
    included), with CUDA-event times.  ``ts`` is the run to capture from
    (default: a new one to depth 7); its outcome is left on
    ``mods["captured_outcome"]``."""
    from dslabs_tpu_torch.tpu.sharded import ShardedTensorSearch, make_mesh

    kernels, visited, engine = mods["kernels"], mods["visited"], \
        mods["engine"]
    if ts is None:
        ts = ShardedTensorSearch(proto, make_mesh(D), max_depth=7,
                                 chunk_per_device=SHARD_ROWS // D,
                                 **SHARD_CAPS)
    n_rows = D * ts.cpd * ts._num_events()
    n_keys = D * ts._bucket
    got = {}
    fp0, ins0 = kernels.fingerprint_rows, visited.insert

    def fp_cap(rows):
        if rows.shape[0] == n_rows:
            got["rows"] = rows.clone()
        return fp0(rows)

    def ins_cap(table, keys, valid):
        # The fullest received batch of the run (a sync per call: this
        # run is not a measured one).
        n = int(valid.sum()) if keys.shape[0] == n_keys else -1
        if n > got.get("n", 0):
            got.update(n=n, table=table.clone(), keys=keys.clone(),
                       valid=valid.clone())
        return ins0(table, keys, valid)

    kernels.fingerprint_rows, visited.insert = fp_cap, ins_cap
    try:
        mods["captured_outcome"] = ts.run()
    finally:
        kernels.fingerprint_rows, visited.insert = fp0, ins0
    check({"rows", "keys"} <= set(got), f"sharded capture: {sorted(got)}")
    rows = got.pop("rows")
    if one_shard:
        rows = rows[:n_rows // D].contiguous()
    k = kernels.fingerprint_rows(rows)
    p = engine.row_fingerprints(rows)
    torch.cuda.synchronize()
    fp_err = int((k.to(torch.int64) - p.to(torch.int64)).abs().max())
    check(fp_err == 0, f"sharded fingerprint_rows {list(rows.shape)} "
                       f"disagrees with its plain version ({fp_err})")
    b_ms, b_by = bound_ms(rows.numel() * 4 + rows.shape[0] * 16,
                          rows.numel() * FP_OPS_PER_LANE)
    out = {"fingerprint_rows": dict(
        shape=list(rows.shape), max_abs_err=fp_err,
        ms=cuda_ms(torch, lambda _: kernels.fingerprint_rows(rows)),
        plain_ms=cuda_ms(torch, lambda _: engine.row_fingerprints(rows),
                         reps=5, warmup=1),
        bound_ms=b_ms, bound_by=b_by)}
    del rows, k, p
    table, keys, valid = got["table"], got["keys"], got["valid"]
    ta, ia, ua = visited.insert(table.clone(), keys, valid)
    tb, ib, ub = visited.insert_plain(table.clone(), keys, valid)
    torch.cuda.synchronize()
    ins_err = int((ta[:-1].to(torch.int64) - tb[:-1].to(torch.int64))
                  .abs().max())
    check(ins_err == 0 and torch.equal(ia, ib) and torch.equal(ua, ub),
          f"sharded visited.insert disagrees with insert_plain ({ins_err})")
    n_valid = int(valid.sum())
    check(0 < n_valid < n_keys, f"received keys: {n_valid} valid of "
                                f"{n_keys}")
    b_ms, b_by = bound_ms(n_keys * 17 + n_valid * 128
                          + int(ia.sum()) * 16 + n_keys * 2, 0)
    out["insert"] = dict(
        V=table.shape[0] - 1, N=n_keys, valid=n_valid,
        inserted=int(ia.sum()), max_abs_err=ins_err,
        ms=cuda_ms(torch, lambda t: visited.insert(t, keys, valid),
                   setup=lambda: table.clone()),
        plain_ms=cuda_ms(torch, lambda t: visited.insert_plain(t, keys,
                                                               valid),
                         setup=lambda: table.clone(), reps=5, warmup=1),
        bound_ms=b_ms, bound_by=b_by)
    return out


def phase_sharded(torch, mods):
    """The owner-sharded engine (tpu/sharded.py) on the card (module
    docstring).  Returns the kernels' launches of the flagship runs."""
    from dslabs_tpu_torch.tpu import telemetry as tel_mod
    from dslabs_tpu_torch.tpu.protocols.clientserver import \
        make_clientserver_protocol
    from dslabs_tpu_torch.tpu.protocols.pingpong import \
        make_pingpong_protocol
    from dslabs_tpu_torch.tpu.sharded import ShardedTensorSearch, make_mesh
    from dslabs_tpu_torch.tpu.swarm import SwarmSearch
    from tests.torch_harness_cases import pruned, violating

    t_phase = time.time()
    engine = mods["engine"]
    proto = flagship_protocol()
    pinned = ["DEPTH_EXHAUSTED", FLAGSHIP_D8_UNIQUE, FLAGSHIP_D8_EXPLORED,
              SHARD_DEPTH]
    total = {"fingerprint_rows": 0, "insert": 0}
    runs = {}
    # Uncounted warm-up: the compiled handlers' constants reach the card
    # at their first use (compiler._const), an upload that would count
    # as a sync of the first superstep.
    ShardedTensorSearch(proto, make_mesh(1), max_depth=1,
                        chunk_per_device=64, frontier_cap=64,
                        visited_cap=1 << 10).run()
    for D in SHARD_WIDTHS:
        gc.collect()
        torch.cuda.empty_cache()
        ts = ShardedTensorSearch(proto, make_mesh(D), max_depth=SHARD_DEPTH,
                                 chunk_per_device=SHARD_ROWS // D,
                                 **SHARD_CAPS)
        check((ts.lanes, ts.plane) == (842, 217),
              f"sharded flagship lanes {ts.lanes}, plane {ts.plane}")
        tags, supers = [], []

        def hook(tag, fn, *args):
            tags.append(tag)
            if tag != "sharded.superstep":
                return fn(*args)
            box = {}
            n, _ = sync_debug_count(
                torch, lambda *a: box.setdefault("s", fn(*a)), args)
            supers.append((n, int(box["s"][ts._stat_idx()["steps"]])))
            return box["s"]

        ts._dispatch_hook = hook
        o, rec = timed_search(torch, mods, ts)
        check(rec["key"] == pinned, f"sharded D={D}: {rec['key']}")
        steps = rec["chunk_steps"]
        want = {"fingerprint_rows": steps + 2, "insert": D * (steps + 1)}
        check(rec["launches"] == want,
              f"sharded D={D} launches {rec['launches']}, want {want}")
        check(all(n == 1 + k for n, k in supers),
              f"sharded D={D} syncs per superstep {supers}")
        check(tags.count("sharded.superstep") == o.depth,
              f"sharded D={D} dispatches {tags}")
        for k in total:
            total[k] += rec["launches"][k]
        occ = [lv["per_device"]["frontier"] for lv in o.levels]
        check(all(len(x) == D for x in occ), f"per_device lanes {occ}")
        runs[f"D{D}"] = dict(
            rec, superstep_per_level=tags.count("sharded.superstep")
            / o.depth,
            syncs_per_superstep=[n for n, _ in supers],
            steps_per_superstep=[k for _, k in supers],
            frontier_per_shard=occ,
            frontier_imbalance_max=max(
                tel_mod.skew_metrics(x)["imbalance"] for x in occ),
            kernel2_per_step=rec["launches"]["insert"] / max(steps, 1))
        del ts, o
    kchecks = sharded_kernel_checks(torch, mods, proto)

    # Flagship resume: D = 4 cut (dump at depth 6), resumed at D = 2 and
    # on the solo engine to the depth-8 pins.
    tmp = tempfile.mkdtemp(dir=ROOT, prefix=".sharded-")
    try:
        path = os.path.join(tmp, "cut.npz")
        cut = ShardedTensorSearch(
            proto, make_mesh(4), max_depth=SHARD_CUT_DEPTH + 1,
            checkpoint_path=path, checkpoint_every=SHARD_CUT_DEPTH,
            chunk_per_device=SHARD_ROWS // 4, **SHARD_CAPS)
        t = time.time()
        cut.run()
        cut_secs = time.time() - t
        resumed = {}
        for name, ts in (
                ("D2", ShardedTensorSearch(
                    proto, make_mesh(2), max_depth=SHARD_DEPTH,
                    checkpoint_path=path, chunk_per_device=SHARD_ROWS // 2,
                    **SHARD_CAPS)),
                ("solo", engine.TensorSearch(
                    proto, max_depth=SHARD_DEPTH, checkpoint_path=path,
                    chunk=SHARD_ROWS, frontier_cap=1 << 20,
                    visited_cap=1 << 22))):
            o, rec = timed_search(torch, mods, ts, resume=True)
            check(rec["key"] == pinned and o.resumed_from_depth
                  == SHARD_CUT_DEPTH, f"sharded resume {name}: {rec['key']} "
                  f"from {o.resumed_from_depth}")
            resumed[name] = dict(secs=rec["secs"], key=rec["key"],
                                 launches=rec["launches"])

        # The small width matrix and the swarm's redistribution.
        matrix = {}
        for name, p in (("pingpong", pruned(make_pingpong_protocol(2))),
                        ("lab1", pruned(make_clientserver_protocol(2, 2)))):
            for D in (1, 2, 4, 8):
                o = ShardedTensorSearch(p, make_mesh(D), chunk_per_device=16,
                                        frontier_cap=1 << 9,
                                        visited_cap=1 << 12).run()
                key = (o.end_condition, o.unique_states, o.states_explored,
                       o.depth)
                check(key == SHARD_MATRIX[name], f"{name} D={D}: {key}")
            matrix[name] = list(SHARD_MATRIX[name])
        p = violating(make_pingpong_protocol(3))
        seed = os.path.join(tmp, "bfs.npz")
        engine.TensorSearch(p, chunk=64, max_depth=2, checkpoint_path=seed,
                            checkpoint_every=1).run()
        kw = dict(max_steps=24, steps_per_round=2, seed=3,
                  frontier_seed=seed, visited_cap=1 << 12)
        full = SwarmSearch(p, walkers_per_device=8, **kw).run()
        swk = os.path.join(tmp, "swarm.npz")
        SwarmSearch(p, walkers_per_device=8, max_rounds=1,
                    checkpoint_path=swk, checkpoint_every=1, **kw).run()
        swarm = {"full": full.end_condition}
        for k in (4, 16):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                o = SwarmSearch(p, walkers_per_device=k,
                                checkpoint_path=swk, **kw).run(resume=True)
            check(o.end_condition == full.end_condition
                  and o.witness is not None and o.resumed_from_depth == 1,
                  f"swarm resumed at {k} walkers: {o.end_condition}")
            swarm[f"K{k}"] = o.end_condition
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "sharded", "secs": time.time() - t_phase,
          "solo_unique_per_min": mods.get("search_unique_per_min"),
          "runs": runs, "kernels": kchecks, "cut_secs": cut_secs,
          "resumed": resumed, "width_matrix": matrix, "swarm": swarm,
          "launches": total})
    return total


# The elastic phase: the compiled packed flagship on the supervisor's
# sharded rung at ELASTIC_WIDTH shards (chunk_per_device 4096 // width,
# the sharded phase's caps), to the depth-8 pins.  The fatal fault fires
# at the superstep of level ELASTIC_FATAL_LEVEL (dispatch 2 * level - 1 of
# the rung's init, (superstep, promote)* sequence), after the dumps of the
# levels before it; the warden's first child dies at its first dispatch
# at or past ELASTIC_KILL_AT once a dump is on disk.
ELASTIC_WIDTH = 4
ELASTIC_FATAL_LEVEL = 6
ELASTIC_KILL_AT = 9


def phase_elastic(torch, mods):
    """The supervisor's and the warden's sharded rung and the elastic
    width ladder on the card (module docstring).  Returns the kernels'
    launches of the in-process supervised runs."""
    from dslabs_tpu_torch.tpu import supervisor as S
    from dslabs_tpu_torch.tpu.chaos import ChaosError
    from dslabs_tpu_torch.tpu.mesh_exchange import ShardMesh
    from dslabs_tpu_torch.tpu.telemetry import Telemetry
    from dslabs_tpu_torch.tpu.warden import Warden

    t_phase = time.time()
    proto = flagship_protocol()
    pinned = ["DEPTH_EXHAUSTED", FLAGSHIP_D8_UNIQUE, FLAGSHIP_D8_EXPLORED,
              SHARD_DEPTH]
    caps = dict(chunk=SHARD_ROWS // ELASTIC_WIDTH, **SHARD_CAPS)
    total = {"fingerprint_rows": 0, "insert": 0}

    def supervised(sup):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        before = kernel_counts(mods)
        t0 = time.time()
        o = sup.run()
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in kernel_counts(mods).items()}
        for k in total:
            total[k] += launches[k]
        return o, dict(
            key=[o.end_condition, o.unique_states, o.states_explored,
                 o.depth], secs=time.time() - t0, engine=o.engine,
            mesh_width=o.mesh_width, mesh_shrinks=o.mesh_shrinks,
            failovers=o.failovers, retries=o.retries,
            knob_retries=o.knob_retries,
            resumed_from_depth=o.resumed_from_depth,
            dropped_states=o.dropped_states, launches=launches)

    recs = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        # ---- the warden: the width-4 child SIGKILLed after a durable
        # dump, the width-2 child resumes and finishes.  Its children run
        # in their own processes beside the in-process cases.
        def warden_pair():
            tel = Telemetry()
            w = Warden(**WARDEN_FLAGSHIP, ladder=("sharded", "device", "host"),
                       elastic=True, mesh_width=ELASTIC_WIDTH,
                       max_depth=SHARD_DEPTH, telemetry=tel, **caps,
                       checkpoint_path=os.path.join(tmp, "warden.npz"),
                       checkpoint_every=1,
                       fault={"kind": "die", "at": ELASTIC_KILL_AT,
                              "spawns": [0], "after_ckpt": True})
            t0 = time.time()
            o = w.run()
            shrunk = [(e["from_width"], e["to_width"]) for e in tel.events
                      if e.get("kind") == "mesh_shrunk"]
            return w, o, shrunk, time.time() - t0

        f_pair = pool.submit(warden_pair)

        # ---- a fatal fault on the width-4 rung: the width-2 rung resumes
        # the checkpoint re-sharded and lands the pins.
        tel = Telemetry()
        at = 2 * ELASTIC_FATAL_LEVEL - 1
        o, r = supervised(S.SearchSupervisor(
            proto, ladder=("sharded", "device", "host"),
            mesh=ShardMesh(ELASTIC_WIDTH), elastic=True, strict=True,
            max_depth=SHARD_DEPTH, telemetry=tel,
            fault_plan=S.FaultPlan().raise_at(at, error=ChaosError,
                                              engine="sharded"),
            checkpoint_path=os.path.join(tmp, "fatal.npz"),
            checkpoint_every=1, policy=S.RetryPolicy(max_retries=0),
            **caps))
        shrunk = [(e["from_width"], e["to_width"]) for e in tel.events
                  if e.get("kind") == "mesh_shrunk"]
        spans = [x for x in tel.ring if x.get("t") == "span"
                 and x.get("site") == "superstep"]
        check(r["key"] == pinned and r["engine"] == "sharded"
              and r["mesh_width"] == ELASTIC_WIDTH // 2
              and r["mesh_shrinks"] == 1 and r["failovers"] == 1
              and 0 < r["resumed_from_depth"] < ELASTIC_FATAL_LEVEL
              and r["dropped_states"] == 0
              and shrunk == [(ELASTIC_WIDTH, ELASTIC_WIDTH // 2)]
              and all(v > 0 for v in r["launches"].values()),
              f"elastic fatal: {r}, shrunk {shrunk}")
        recs["fatal"] = dict(at=at, shrunk=shrunk,
                             superstep_scales=sorted({x["scale"]
                                                      for x in spans}),
                             **r)

        # ---- two transients inside the level-2 superstep: retried in
        # place on the full mesh.
        o, r = supervised(S.SearchSupervisor(
            proto, ladder=("sharded", "device", "host"),
            mesh=ShardMesh(ELASTIC_WIDTH), strict=True,
            max_depth=SHARD_DEPTH,
            fault_plan=S.FaultPlan().raise_at(3, count=2),
            policy=S.RetryPolicy(backoff_base=0.01), **caps))
        check(r["key"] == pinned and r["engine"] == "sharded"
              and r["retries"] == 2 and r["failovers"] == 0
              and r["mesh_width"] == ELASTIC_WIDTH,
              f"elastic superstep transient: {r}")
        recs["transient"] = r

        # ---- both kernels at the width-2 rung's shapes.
        kchecks = sharded_kernel_checks(torch, mods, proto,
                                        D=ELASTIC_WIDTH // 2)

        w, o, shrunk, secs = f_pair.result()
        key = [o.end_condition, o.unique_states, o.states_explored, o.depth]
        check(key == pinned and o.engine == "sharded"
              and o.mesh_width == ELASTIC_WIDTH // 2
              and o.mesh_shrinks == 1 and o.child_restarts == 1
              and o.resumed_from_depth > 0 and o.dropped_states == 0
              and [d.kind for d in w.deaths] == ["oom"]
              and shrunk == [(ELASTIC_WIDTH, ELASTIC_WIDTH // 2)]
              and o.platform == "cuda",
              f"elastic warden: {key} {o.engine} width {o.mesh_width} "
              f"deaths {[d.kind for d in w.deaths]} shrunk {shrunk}")
        recs["warden"] = dict(
            key=key, secs=secs, mesh_width=o.mesh_width,
            mesh_shrinks=o.mesh_shrinks, child_restarts=o.child_restarts,
            resumed_from_depth=o.resumed_from_depth,
            deaths=[d.kind for d in w.deaths], platform=o.platform)
    emit({"phase": "elastic", "secs": time.time() - t_phase,
          "width": ELASTIC_WIDTH, "runs": recs, "kernels": kchecks,
          "launches": total})
    return total


# The chaos phase: tpu/chaos.py's soak on strict lab1 (one client, two
# commands, done pruned) at CHAOS_WIDTH shards, its CLI's shapes, with
# the fault-free counts pinned from the JAX ShardedTensorSearch at
# make_mesh(8) on the CPU (tests/test_torch_chaos.py holds them there).
CHAOS_WIDTH = 8
CHAOS_PIN = ("SPACE_EXHAUSTED", 8, 23)


def phase_chaos(torch, mods):
    """The seeded chaos soak on the card (module docstring).  Returns the
    kernels' launches of its two runs (the baseline and the chaos run)."""
    from dslabs_tpu_torch.tpu import chaos
    from dslabs_tpu_torch.tpu.mesh_exchange import ShardMesh

    t_phase = time.time()
    spec = chaos.ChaosSpec(seed=1, faults=24)
    torch.cuda.synchronize()
    before = kernel_counts(mods)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        report = chaos.soak(
            chaos._protocol("lab1"), spec=spec,
            supervisor_kwargs=dict(mesh=ShardMesh(CHAOS_WIDTH), chunk=64,
                                   frontier_cap=1 << 9, visited_cap=1 << 12),
            checkpoint_path=os.path.join(tmp, "soak.npz"),
            min_fired=20, min_sites=3)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in kernel_counts(mods).items()}
    base = report["base"]
    c = report["chaos"]
    check(report["parity"] and (base["verdict"], base["unique"],
                                base["explored"]) == CHAOS_PIN
          and c["dropped_states"] == 0 and c["mesh_shrinks"] >= 1
          and c["knob_retries"] >= 1 and "hang" in report["kinds_fired"]
          and report["platform"] == "cuda"
          and all(v > 0 for v in launches.values()),
          f"chaos soak: {report}, launches {launches}")
    emit({"phase": "chaos", "secs": time.time() - t_phase,
          "width": CHAOS_WIDTH, "fired": report["fired"],
          "scheduled": report["scheduled"],
          "sites_fired": report["sites_fired"],
          "kinds_fired": report["kinds_fired"], "parity": report["parity"],
          "base": base, "chaos": c, "wall_secs": report["wall_secs"],
          "launches": launches})
    return launches


# The ranks phase: the compiled packed flagship over RankMesh ranks
# (tpu/ranks.py), one shard per rank, at the sharded phase's caps with
# chunk_per_device 4096 // width: two gloo ranks sharing the card, and
# NCCL ranks across the cards where there are two or more.  The fatal
# fault fires in rank 1 at the level-RANK_FATAL_LEVEL superstep (dispatch
# 2 * level - 1 of the rung's init, (superstep, promote)* sequence).
RANK_WIDTH = 2
RANK_CUT_DEPTH = 6
RANK_FATAL_LEVEL = 5
RANK_DEADLINE = 300.0
RANK_PG_TIMEOUT = 120.0


def rank_caps(width: int) -> dict:
    return dict(chunk_per_device=SHARD_ROWS // width, **SHARD_CAPS)


def rank_record(o) -> dict:
    """A RankMesh run's per-rank numbers, and the checks every rank's
    launches must meet: kernel 2 once per chunk step and once at the
    root; kernel 1 once per chunk step and twice at the root."""
    per = []
    for r in o.ranks:
        k = r["chunk_steps"]
        want = {"fingerprint_rows": k + 2, "insert": k + 1}
        check(r["launches"] == want,
              f"rank {r['rank']} launches {r['launches']}, want {want}")
        per.append(dict(rank=r["rank"], device=r["device"],
                        chunk_steps=k, launches=r["launches"],
                        peak_mem_bytes=r["peak_bytes"], secs=r["secs"],
                        collectives=r["exchange_calls"],
                        bytes_sent=r["exchange_bytes"]))
    return {"ranks": per,
            "bytes_sent_per_level": [lv["exchange"]["bytes_sent"]
                                     for lv in o.levels],
            "collectives_per_level": [lv["exchange"]["calls"]
                                      for lv in o.levels]}


def ckpt_depth(path: str):
    from dslabs_tpu_torch.tpu import checkpoint as ckpt_mod

    return ckpt_mod.peek_depth(path)


def _rank_key(o):
    return [o.end_condition, o.unique_states, o.states_explored, o.depth]


def _rank_lanes(o):
    return [(lv["per_device"]["frontier"], lv["per_device"]["explored"])
            for lv in o.levels]


def ranks_flagship(torch, mods, mesh, cut=None):
    """One launch over ``mesh``: the flagship to depth 8 (with ``cut``, a
    path, its depth-6 dump written there: the state a run cut at depth 6
    leaves), then the audit of the engine's sites. Checks the pins,
    every level's per-shard lanes against the LocalExchange run at the
    mesh's width on cuda:0 (whose inputs hold both kernels against their
    plain versions at a rank's shapes), and every rank's sharded sites
    at their sync budgets. Returns (the launch's results, its record)."""
    from dslabs_tpu_torch.tpu import ranks
    from dslabs_tpu_torch.tpu.sharded import ShardedTensorSearch, make_mesh

    pinned = ["DEPTH_EXHAUSTED", FLAGSHIP_D8_UNIQUE, FLAGSHIP_D8_EXPLORED,
              SHARD_DEPTH]
    w = mesh.width
    caps = rank_caps(w)
    dump = (dict(checkpoint_path=cut, checkpoint_every=RANK_CUT_DEPTH)
            if cut else {})
    jobs = [ranks.search_job(**WARDEN_FLAGSHIP, max_depth=SHARD_DEPTH,
                             **dump, **caps),
            dict(ranks.search_job(**WARDEN_FLAGSHIP, **caps), kind="audit")]
    t0 = time.time()
    res = ranks.launch(mesh, jobs, deadline=RANK_DEADLINE,
                       pg_timeout=RANK_PG_TIMEOUT)
    launch_secs = time.time() - t0
    o = ranks.outcome_of(res, 0)
    check(_rank_key(o) == pinned,
          f"ranks flagship over {mesh}: {_rank_key(o)}")
    gc.collect()
    torch.cuda.empty_cache()
    # The LocalExchange run at the same width, its inputs captured for
    # both kernels at a rank's shapes: kernel 1 on one shard's rows.
    t0 = time.time()
    kchecks = sharded_kernel_checks(
        torch, mods, None, D=w, one_shard=True, ts=ShardedTensorSearch(
            flagship_protocol(), make_mesh(w), max_depth=SHARD_DEPTH,
            **caps))
    ref = mods.pop("captured_outcome")
    local_secs = time.time() - t0
    check(_rank_key(ref) == pinned and _rank_lanes(o) == _rank_lanes(ref)
          and o.dropped == ref.dropped == 0,
          f"ranks vs LocalExchange D={w}: {_rank_key(o)} {_rank_key(ref)}; "
          f"lanes {_rank_lanes(o)} vs {_rank_lanes(ref)}")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    # The audit: the syncs of one superstep (one chunk step) and of every
    # other site on each rank (gloo ranks on a card stage every
    # collective through the host; NCCL ranks do not).
    audits = [r["results"][1] for r in res]
    for a in audits:
        check(a["staged"] == (mesh.backend == "gloo")
              and a["findings"] == [],
              f"rank audit: staged {a['staged']}, {a['findings']}")
        for tag, rep in a["report"].items():
            if tag.startswith("sharded."):
                check(rep["syncs"] == rep["budget"],
                      f"rank audit {tag}: {rep['syncs']} syncs, budget "
                      f"{rep['budget']}")
    rec = dict(width=w, backend=mesh.backend,
               devices=[str(d) for d in mesh.devices], key=_rank_key(o),
               launch_secs=launch_secs, secs=o.ranks[0]["secs"],
               local_secs=local_secs, kernels=kchecks,
               frontier_per_shard=[x for x, _ in _rank_lanes(o)],
               syncs={tag: dict(syncs=rep["syncs"], budget=rep["budget"])
                      for tag, rep in audits[0]["report"].items()
                      if tag.startswith("sharded.")},
               **rank_record(o))
    return res, rec


def phase_ranks(torch, mods, gloo: bool = True):
    """The sharded engine over ranks (module docstring); ``gloo=False``
    runs the NCCL part alone.  Returns the kernels' launches of the
    ranks' flagship runs, summed over the ranks (their own counts)."""
    from dslabs_tpu_torch.tpu import ranks
    from dslabs_tpu_torch.tpu import supervisor as S
    from dslabs_tpu_torch.tpu.chaos import ChaosError
    from dslabs_tpu_torch.tpu.mesh_exchange import RankMesh
    from dslabs_tpu_torch.tpu.sharded import ShardedTensorSearch, make_mesh
    from dslabs_tpu_torch.tpu.telemetry import Telemetry

    t_phase = time.time()
    pinned = ["DEPTH_EXHAUSTED", FLAGSHIP_D8_UNIQUE, FLAGSHIP_D8_EXPLORED,
              SHARD_DEPTH]
    total = {"fingerprint_rows": 0, "insert": 0}

    def count(rec):
        for r in rec["ranks"]:
            for k in total:
                total[k] += r["launches"][k]

    out = {"phase": "ranks"}
    mesh = RankMesh(["cuda:0"] * RANK_WIDTH, "gloo")
    caps = rank_caps(RANK_WIDTH)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        if gloo:
            cut = os.path.join(tmp, "cut.npz")
            res, rec = ranks_flagship(torch, mods, mesh, cut=cut)
            count(rec)
            out["gloo"] = rec
            # ---- the ranks' dump at depth 6 resumed in-process on
            # LocalExchange at width 1.
            check(ckpt_depth(cut) == RANK_CUT_DEPTH,
                  f"ranks dump depth {ckpt_depth(cut)}")
            rs = ShardedTensorSearch(flagship_protocol(), make_mesh(1),
                                     max_depth=SHARD_DEPTH,
                                     checkpoint_path=cut, **rank_caps(1))
            t0 = time.time()
            ro = rs.run(resume=True)
            torch.cuda.synchronize()
            check(_rank_key(ro) == pinned
                  and ro.resumed_from_depth == RANK_CUT_DEPTH,
                  f"ranks dump resumed at D=1: {_rank_key(ro)} from "
                  f"{ro.resumed_from_depth}")
            out["resume_d1"] = dict(key=_rank_key(ro), secs=time.time() - t0,
                                    resumed_from_depth=ro.resumed_from_depth)
            del rs
            gc.collect()
            torch.cuda.empty_cache()
            # ---- rank 1 raises a fatal error at the level-5 superstep;
            # the elastic supervisor's next rung resumes the ranks' last
            # dump.
            tel = Telemetry()
            at = 2 * RANK_FATAL_LEVEL - 1
            sup = S.SearchSupervisor(
                flagship_protocol(), ladder=("sharded", "device", "host"),
                mesh=mesh, elastic=True, strict=True, max_depth=SHARD_DEPTH,
                telemetry=tel, protocol_factory=WARDEN_FLAGSHIP["factory"],
                factory_kwargs=WARDEN_FLAGSHIP["factory_kwargs"],
                protocol_transform=WARDEN_FLAGSHIP["transform"],
                fault_plan=S.FaultPlan().raise_at(at, error=ChaosError,
                                                  engine="sharded", rank=1),
                policy=S.RetryPolicy(max_retries=0),
                checkpoint_path=os.path.join(tmp, "fatal.npz"),
                checkpoint_every=1, chunk=caps["chunk_per_device"],
                frontier_cap=SUP_CAPS["frontier_cap"],
                visited_cap=SHARD_CAPS["visited_cap"])
            t0 = time.time()
            so = sup.run()
            torch.cuda.synchronize()
            rungs = [(e["engine"], e["width"]) for e in tel.events
                     if e.get("kind") == "rung"]
            check(_rank_key(so) == pinned and so.engine == "device"
                  and so.failovers == 1
                  and [f.kind for f in sup.failures] == ["fatal"]
                  and "rank 1 of 2" in str(sup.failures[0])
                  and 0 < so.resumed_from_depth < RANK_FATAL_LEVEL
                  and rungs == [("sharded", RANK_WIDTH), ("device", 1)],
                  f"ranks killed rank: {_rank_key(so)} {so.engine} failures "
                  f"{[str(f)[:200] for f in sup.failures]} rungs {rungs} "
                  f"from {so.resumed_from_depth}")
            out["killed_rank"] = dict(
                key=_rank_key(so), secs=time.time() - t0, at=at,
                rungs=rungs, failure=str(sup.failures[0])[:300],
                engine=so.engine, resumed_from_depth=so.resumed_from_depth)
    # ---- NCCL ranks across the cards.
    n = torch.cuda.device_count()
    if n >= 2:
        _, rec = ranks_flagship(
            torch, mods, RankMesh([f"cuda:{i}" for i in range(n)], "nccl"))
        count(rec)
        out["nccl"] = rec
    else:
        emit({"phase": "ranks", "nccl": "not run: 1 card"})
        out["nccl"] = "not run: 1 card"
    out.update(secs=time.time() - t_phase, launches=total)
    emit(out)
    return total


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
    mods["search_unique_per_min"] = rec["unique_per_min"]
    return launches


def bytecode_cache() -> None:
    """Keep compiled bytecode in the checkout (BYTECODE_CACHE) for this
    process and every child it starts.  The card's host sets
    PYTHONDONTWRITEBYTECODE and its torch has no ``__pycache__``, so each
    fresh process compiled torch's sources anew; this process writes the
    cache while it imports torch, and its children read it."""
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = BYTECODE_CACHE
    sys.dont_write_bytecode = False
    sys.pycache_prefix = BYTECODE_CACHE


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "dslabs_tpu_torch")):
        print("chip_smoke: run from a checkout (dslabs_tpu_torch/ missing)",
              file=sys.stderr)
        return 1
    bytecode_cache()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
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
    phase_secs = {}

    def run(phase, *args):
        t = time.time()
        out = phase(torch, mods, *args)
        phase_secs[phase.__name__[len("phase_"):]] = time.time() - t
        return out

    kres = run(phase_kernels, gen)
    run(phase_parity)
    run(phase_compiled, FLAGSHIP_DEPTH)
    run(phase_profile, PROFILE_DEPTH)
    run(phase_trace, FLAGSHIP_DEPTH)
    run(phase_harness)
    run(phase_lab4)
    swarm_launches = run(phase_swarm)
    lab_launches = run(phase_labtests)
    scen_launches = run(phase_scenarios)
    # The service phase waits on its child processes and launches no
    # kernel in this process, so it runs beside the spill phase, whose
    # checks are counts (its times are recorded, not gated).
    with concurrent.futures.ThreadPoolExecutor(1) as side:
        service = side.submit(run, phase_service)
        spill_launches = run(phase_spill)
        service.result()
    sup_launches = run(phase_supervisor)
    tel_launches = run(phase_telemetry, False)
    ana_launches = run(phase_analysis)
    lane_launches = run(phase_lanes)
    memo_launches = run(phase_memo)
    launches = run(phase_search, SEARCH_MAX_SECS)
    shard_launches = run(phase_sharded)
    elastic_launches = run(phase_elastic)
    chaos_launches = run(phase_chaos)
    rank_launches = run(phase_ranks)

    replaces = {
        "fingerprint_rows": ("dslabs_tpu_torch/csrc/fingerprint.cu",
                             "dslabs_tpu/tpu/kernels.py:74"),
        "insert": ("dslabs_tpu_torch/csrc/visited.cu",
                   "dslabs_tpu/tpu/visited.py:315"),
    }
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": replaces[k][0],
         "replaces": replaces[k][1],
         "launches": (launches[k] + swarm_launches[k] + lab_launches[k]
                      + scen_launches[k] + spill_launches[k]
                      + sup_launches[k] + tel_launches[k]
                      + ana_launches[k] + lane_launches[k]
                      + memo_launches[k] + shard_launches[k]
                      + elastic_launches[k] + chaos_launches[k]
                      + rank_launches[k]),
         "launches_by_path": {"search": launches[k],
                              "swarm": swarm_launches[k],
                              "labtests": lab_launches[k],
                              "scenarios": scen_launches[k],
                              "spill": spill_launches[k],
                              "supervisor": sup_launches[k],
                              "telemetry": tel_launches[k],
                              "analysis": ana_launches[k],
                              "lanes": lane_launches[k],
                              "memo": memo_launches[k],
                              "sharded": shard_launches[k],
                              "elastic": elastic_launches[k],
                              "chaos": chaos_launches[k],
                              "ranks": rank_launches[k]},
         "max_abs_err": kres[k]["max_abs_err"], "ms": kres[k]["ms"],
         "plain_ms": kres[k]["plain_ms"], "bound_ms": kres[k]["bound_ms"],
         "bound_by": kres[k]["bound_by"], "library_ms": None}
        for k in ("fingerprint_rows", "insert")]})
    print(f"chip_smoke: {time.time() - t_start:.1f} s; phases (s): "
          f"{json.dumps(phase_secs)}", file=sys.stderr)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
