"""PyTorch port, the host-RAM spill tier (``dslabs_tpu_torch/tpu/spill.py``
and the spill mode of ``TensorSearch``'s device loop), against the JAX
package on the CPU.  Integer results compare exactly:

- the reference's unit cases (``tests/test_spill.py``) on both packages'
  ``HostVisitedTier`` and ``SpillManager`` with the same inputs;
- spill searches equal the JAX spill search of the same shape in end,
  unique, explored and depth and in ``spilled_keys``, ``host_tier_hits``
  and ``respilled_frontier``: pingpong at ``visited_cap=8``, the lab1
  hand twin at 1/8 of its reachable count, and a compiled (packed) lab1
  spec; the counts equal the uncapped run's, with nothing dropped;
- spill keys are canonical fingerprints (a symmetric search spills to the
  orbit count) and fault searches spill exactly;
- spill with checkpoints: a cut run resumes in spill mode and in a
  non-spill search; a run SIGKILLed in a subprocess resumes exactly;
- the asynchronous and the synchronous drain give equal counts;
- ``spill`` together with ``record_trace`` raises."""

import dataclasses
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)

from dslabs_tpu.tpu import engine as jeng  # noqa: E402
from dslabs_tpu.tpu import spill as jspill  # noqa: E402
from dslabs_tpu.tpu import specs as jspecs  # noqa: E402
from dslabs_tpu.tpu.protocols.clientserver import \
    make_clientserver_protocol as j_cs  # noqa: E402
from dslabs_tpu.tpu.protocols.pingpong import \
    make_pingpong_protocol as j_pp  # noqa: E402
from dslabs_tpu_torch.tpu import checkpoint as tck  # noqa: E402
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.tpu import spill as tspill  # noqa: E402
from dslabs_tpu_torch.tpu import specs as tspecs  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.clientserver import \
    make_clientserver_protocol as t_cs  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.pingpong import \
    make_pingpong_protocol as t_pp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The reference's lab1 acceptance shape (tests/test_spill.py): c3-w4 to
# depth 11 (1,250 unique), its table capped at 128 = 1/8, chunk 16.
LAB1_DEPTH = 11
LAB1_CAP = 128
LAB1_SPILL = dict(chunk=16, max_depth=LAB1_DEPTH, visited_cap=LAB1_CAP,
                  frontier_cap=1 << 11)
SPILL_COUNTERS = ("spilled_keys", "host_tier_hits", "respilled_frontier")


def _pruned(p):
    """Goals become prunes: the search runs the whole space."""
    return dataclasses.replace(p, goals={}, prunes=dict(p.goals))


def _key(out):
    return (out.end_condition, out.unique_states, out.states_explored,
            out.depth)


def _spill_key(out):
    return _key(out) + tuple(getattr(out, k) for k in SPILL_COUNTERS)


def _port(p, **kw):
    return teng.TensorSearch(p, device="cpu", **kw)


@pytest.fixture(scope="module")
def lab1_base():
    out = _port(_pruned(t_cs(n_clients=3, w=4)), chunk=256,
                max_depth=LAB1_DEPTH).run()
    assert _key(out) == ("DEPTH_EXHAUSTED", 1250, 11607, LAB1_DEPTH)
    assert LAB1_CAP * 8 <= out.unique_states
    return out


# ------------------------------------------------------------ unit layer

@pytest.mark.parametrize("mod", [jspill, tspill], ids=["jax", "port"])
def test_host_tier_absorb_contains_dedup(mod):
    """tests/test_spill.py:97 on both packages: the tier is an exact set
    with a loud capacity wall."""
    over = (jeng.CapacityOverflow if mod is jspill
            else teng.CapacityOverflow)
    tier = mod.HostVisitedTier(host_cap=8)
    keys = np.arange(24, dtype=np.uint32).reshape(6, 4)
    dup = np.concatenate([keys, keys[:3]])
    assert tier.absorb(dup) == 6
    assert len(tier) == 6
    assert tier.contains(keys).all()
    assert not tier.contains(keys + np.uint32(100)).any()
    assert tier.absorb(keys) == 0
    with pytest.raises(over):
        tier.absorb(np.arange(100, 100 + 12 * 4,
                              dtype=np.uint32).reshape(12, 4))
    np.testing.assert_array_equal(tier.key_rows(), keys)


@pytest.mark.parametrize("mod", [jspill, tspill], ids=["jax", "port"])
def test_spill_manager_unique_formula(mod):
    """tests/test_spill.py:115 on both packages: unique = len(tier) +
    vis_n_epoch - dup_epoch."""
    sp = mod.SpillManager(mod.SpillConfig(high_water=0.5))
    keys = np.arange(40, dtype=np.uint32).reshape(10, 4)
    sp.evict(keys)
    assert sp.unique(0) == 10
    rows = np.arange(12, dtype=np.int32).reshape(3, 4)
    kept = sp.refilter(rows, keys[:3])
    assert len(kept) == 0 and sp.dup_epoch == 3
    assert sp.unique(3) == 10
    sp.evict(keys[:3])
    assert len(sp.tier) == 10 and sp.dup_epoch == 0


def test_spill_managers_agree_on_a_random_workload():
    """Both managers fed the same evictions, refilters, spools and level
    advances from a numpy seed: equal tiers, spools, stats and dump
    keys."""
    rng = np.random.default_rng(7)
    mgrs = [m.SpillManager(m.SpillConfig(high_water=0.5, async_drain=False))
            for m in (jspill, tspill)]
    pool = rng.integers(0, 2 ** 32, (300, 4), dtype=np.uint32)
    for _ in range(12):
        ev = pool[rng.integers(0, 300, 40)]
        q = pool[rng.integers(0, 300, 30)]
        rows = rng.integers(-50, 50, (30, 5), dtype=np.int32)
        outs = []
        for sp in mgrs:
            sp.evict(ev)
            kept = sp.refilter(rows, q)
            sp.spool(kept)
            sp.advance_level()
            outs.append((kept, sp.unique(5), sp.stats.as_array(),
                         sp.spool_cur.concat(5), sp.checkpoint_keys(q),
                         sp.pop_current()))
        for a, b in zip(*outs):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_tier_persistence_round_trip(tmp_path):
    pth = str(tmp_path / "tier.npz")
    h1 = np.arange(5, dtype=np.uint64)
    h2 = h1 * np.uint64(3)
    tspill.save_tier(pth, h1, h2, {"pack": "raw", "sym": 0})
    got1, got2, meta = jspill.load_tier(pth, {"pack": "raw"})
    np.testing.assert_array_equal(got1, h1)
    np.testing.assert_array_equal(got2, h2)
    assert meta == {"fmt": tspill.TIER_FORMAT, "pack": "raw", "sym": 0}
    with pytest.raises(tspill.TierMismatch):
        tspill.load_tier(pth, {"sym": 6})


# ------------------------------------------------- engine parity layer

def test_spill_parity_pingpong():
    """tests/test_spill.py:131: the table capped to one bucket."""
    kw = dict(chunk=64, max_depth=12, visited_cap=8, spill=True)
    ref = jeng.TensorSearch(_pruned(j_pp(2)), **kw).run()
    out = _port(_pruned(t_pp(2)), **kw).run()
    assert _spill_key(out) == _spill_key(ref)
    base = _port(_pruned(t_pp(2)), chunk=64, max_depth=12).run()
    assert _key(out) == _key(base)
    assert out.spilled_keys > 0 and out.dropped_states == 0


def test_spill_parity_lab1_eighth_capacity(lab1_base):
    """tests/test_spill.py:143: lab1 with its table at 1/8 of the
    reachable count; every counter equals the JAX run's."""
    ref = jeng.TensorSearch(_pruned(j_cs(n_clients=3, w=4)), spill=True,
                            **LAB1_SPILL).run()
    out = _port(_pruned(t_cs(n_clients=3, w=4)), spill=True,
                **LAB1_SPILL).run()
    assert _spill_key(out) == _spill_key(ref)
    assert _key(out) == _key(lab1_base)
    assert out.dropped_states == 0
    assert out.spilled_keys > 0 and out.host_tier_hits > 0 \
        and out.respilled_frontier > 0


def test_spill_parity_packed_compiled_spec():
    """The spill drain on packed rows (the flagship's storage): a
    compiled lab1 spec, 8 words per row, at 1/8 capacity."""
    kw = dict(chunk=8, max_depth=12, visited_cap=64, frontier_cap=64,
              spill=True)
    jp = _pruned(jspecs.clientserver_spec(n_clients=2, w=3).compile())
    tp = _pruned(tspecs.clientserver_spec(n_clients=2, w=3).compile())
    ref = jeng.TensorSearch(jp, **kw).run()
    ts = _port(tp, **kw)
    assert ts._pk is not None
    out = ts.run()
    assert _spill_key(out) == _spill_key(ref)
    assert out.spilled_keys > 0 and out.respilled_frontier > 0
    base = _port(tp, chunk=64, max_depth=12).run()
    assert _key(out) == _key(base)


def test_spill_keys_are_canonical_fingerprints():
    """Under symmetry the tier holds canonical keys: the spilled search
    counts the 50 orbits of paxos_spec(3) (tests/test_symmetry.py).  The
    pinned explored count and spill counters are the JAX package's spill
    run of this shape (12 s of JAX compiles on the CPU, so pinned)."""
    p = tspecs.paxos_spec(3).compile()
    p = dataclasses.replace(p, goals={}, prunes={"D": p.goals["DECIDED"]})
    out = _port(p, chunk=4, visited_cap=32, frontier_cap=32, spill=True,
                symmetry=True).run()
    assert _spill_key(out) == ("SPACE_EXHAUSTED", 50, 375, 11, 49, 19, 22)
    assert out.symmetry_perms == 6


def test_fault_search_spills_exactly():
    """The partitioned paxos_spec(3) (tests/test_scenarios.py: 564 unique,
    3,416 explored, depth 13, 320 partition events) with its table at
    1/8 of that: the JAX spill run's counters."""
    kw = dict(chunk=8, visited_cap=64, frontier_cap=128, spill=True)
    ref = jeng.TensorSearch(
        _pruned(jspecs.paxos_partition_spec(3).compile()), **kw).run()
    out = _port(_pruned(tspecs.paxos_partition_spec(3).compile()),
                **kw).run()
    assert _spill_key(out) == _spill_key(ref)
    assert _key(out) == ("SPACE_EXHAUSTED", 564, 3416, 13)
    assert out.partition_events == 320
    assert out.spilled_keys > 0


def test_async_and_sync_drain_agree(lab1_base):
    """The drain worker shares the manager with the search thread; with
    the interpreter switching threads as often as it can, the async
    drain still gives the inline drain's counts (a drained batch read
    after the carry moved on would not)."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outs = [_port(_pruned(t_cs(n_clients=3, w=4)),
                      spill=tspill.SpillConfig(async_drain=a),
                      **LAB1_SPILL).run() for a in (True, False, True)]
    finally:
        sys.setswitchinterval(interval)
    assert _spill_key(outs[0]) == _spill_key(outs[1]) == \
        _spill_key(outs[2])
    assert _key(outs[0]) == _key(lab1_base)


def test_spill_with_record_trace_raises():
    with pytest.raises(ValueError, match="record_trace"):
        _port(t_pp(2), spill=True, record_trace=True)


def test_rerun_does_not_see_the_previous_tier(lab1_base):
    ts = _port(_pruned(t_cs(n_clients=3, w=4)), spill=True, **LAB1_SPILL)
    first, second = ts.run(), ts.run()
    assert _spill_key(first) == _spill_key(second)


# ---------------------------------------------------- spill + checkpoints

def test_spill_checkpoint_resume_parity(lab1_base, tmp_path):
    """tests/test_spill.py:176: a spill run cut at depth 6 resumes in
    spill mode, and a NON-spill search resumes the same dump (the format
    is tier-agnostic), both to the straight run's counts."""
    pth = str(tmp_path / "spill.npz")
    kw = dict(LAB1_SPILL, spill=True, checkpoint_path=pth,
              checkpoint_every=1)
    cut = _port(_pruned(t_cs(n_clients=3, w=4)), **{**kw, "max_depth": 6}
                ).run()
    assert cut.depth == 6 and cut.spilled_keys > 0
    ck = tck.load(pth, _port(_pruned(t_cs(n_clients=3, w=4)))
                  ._ckpt_fingerprint())
    assert ck.depth == 6 and "spill_stats" in ck.extra
    out = _port(_pruned(t_cs(n_clients=3, w=4)), **kw).run(resume=True)
    assert _key(out) == _key(lab1_base)
    assert out.resumed_from_depth == 6
    out2 = _port(_pruned(t_cs(n_clients=3, w=4)), chunk=256,
                 max_depth=LAB1_DEPTH, visited_cap=1 << 14,
                 checkpoint_path=pth).run(resume=True)
    assert _key(out2) == _key(lab1_base)


# The child of the kill test: the lab1 spill run with a dump per level.
# Past its depth-6 dump it stalls at the next level boundary (level 7
# expanded, its dump not written), so the parent's SIGKILL lands mid-run
# whatever the machine's speed.
_CHILD = """
import dataclasses, sys, time
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from dslabs_tpu_torch.tpu.engine import TensorSearch
from dslabs_tpu_torch.tpu.protocols.clientserver import \\
    make_clientserver_protocol

class Slow(TensorSearch):
    def _ckpt_due(self, depth):
        if depth > 6:
            time.sleep(60)
        return super()._ckpt_due(depth)

cs = make_clientserver_protocol(n_clients=3, w=4)
cs = dataclasses.replace(cs, goals={{}}, prunes=dict(cs.goals))
Slow(cs, device="cpu", chunk=16, max_depth={depth}, visited_cap={cap},
     frontier_cap=2048, spill=True, checkpoint_path={pth!r},
     checkpoint_every=1).run()
"""


def test_sigkill_mid_spill_resume_parity(lab1_base, tmp_path):
    """tests/test_spill.py:202: the capped lab1 run, SIGKILLed in a
    subprocess once its dump reaches depth 6 (the tier is live by then),
    resumes to the straight run's counts."""
    pth = str(tmp_path / "kill.npz")
    src = _CHILD.format(repo=REPO, depth=LAB1_DEPTH, cap=LAB1_CAP, pth=pth)
    proc = subprocess.Popen([sys.executable, "-c", src],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 60
        while time.time() < deadline and proc.poll() is None:
            d = tck.peek_depth(pth)
            if d is not None and d >= 6:
                break
            time.sleep(0.05)
        assert proc.poll() is None, "the child ended before the kill"
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == -signal.SIGKILL
    d = tck.peek_depth(pth)
    assert d == 6
    out = _port(_pruned(t_cs(n_clients=3, w=4)), spill=True,
                checkpoint_path=pth, checkpoint_every=1,
                **LAB1_SPILL).run(resume=True)
    assert _key(out) == _key(lab1_base)
    assert out.resumed_from_depth == d and out.dropped_states == 0
