"""PyTorch port, unified checkpoints (``dslabs_tpu_torch/tpu/checkpoint.py``
and the resume paths of ``TensorSearch``), against the JAX package on the
CPU.  Integer results compare exactly:

- ``config_fingerprint`` gives the reference's string for a hand twin, a
  lab1 twin, a compiled lab3 spec, the symmetric ``paxos_spec(3)`` and a
  fault spec, and the packed frontier encodings agree;
- the dump format: save and load round-trip (the JAX loader reads a port
  dump), a truncated main dump falls back to ``.prev`` with a warning, a
  foreign fingerprint raises ``CheckpointMismatch``, ``peek_depth`` and
  ``peek_fingerprint``;
- both loops resume at depth k to depth N with the straight run's counts
  and the reference's; a dump written by the JAX package's device loop
  (packed compiled spec) resumes in the port, and a port dump resumes in
  the JAX package;
- the reference's refusals: a symmetric dump against an unreduced search
  and the reverse, a fault dump against a fault-free search, and
  ``resume`` together with ``record_trace``.

One JAX engine (a compiled lab1 spec) serves every JAX run of the file:
its programs compile once."""

import dataclasses
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)

from dslabs_tpu.tpu import checkpoint as jck  # noqa: E402
from dslabs_tpu.tpu import engine as jeng  # noqa: E402
from dslabs_tpu.tpu import specs as jspecs  # noqa: E402
from dslabs_tpu.tpu import specs_lab3 as jlab3  # noqa: E402
from dslabs_tpu.tpu.protocols.clientserver import \
    make_clientserver_protocol as j_cs  # noqa: E402
from dslabs_tpu.tpu.protocols.pingpong import \
    make_pingpong_protocol as j_pp  # noqa: E402
from dslabs_tpu_torch.tpu import checkpoint as tck  # noqa: E402
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.tpu import specs as tspecs  # noqa: E402
from dslabs_tpu_torch.tpu import specs_lab3 as tlab3  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.clientserver import \
    make_clientserver_protocol as t_cs  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.pingpong import \
    make_pingpong_protocol as t_pp  # noqa: E402

LAB3_KW = dict(n=3, n_clients=1, w=1, max_slots=2, net_cap=32, timer_cap=6)
# The resume shape: the compiled lab1 spec, packed to 8 words per row.
DEPTH_K, DEPTH_N = 3, 10
KW = dict(chunk=64, visited_cap=1 << 12)


def _pruned(p):
    """Goals become prunes: the search runs the whole space."""
    return dataclasses.replace(p, goals={}, prunes=dict(p.goals))


def _lab1(specs):
    return _pruned(specs.clientserver_spec(n_clients=2, w=2).compile())


def _key(out):
    return (out.end_condition, out.unique_states, out.states_explored,
            out.depth)


def _port(p, **kw):
    return teng.TensorSearch(p, device="cpu", **{**KW, **kw})


# ------------------------------------------------------------ fingerprints

FINGERPRINT_TWINS = {
    "pingpong_hand": (lambda m: m[0](2), {}),
    "lab1_hand": (lambda m: m[1](2, 2), {}),
    "lab3_compiled": (lambda m: m[2].make_paxos_protocol(**LAB3_KW), {}),
    "paxos_spec3_symmetric": (lambda m: m[3].paxos_spec(3).compile(),
                              dict(symmetry=True)),
    "paxos_partition_fault": (
        lambda m: m[3].paxos_partition_spec(3).compile(), {}),
}
J_MODS = (j_pp, j_cs, jlab3, jspecs)
T_MODS = (t_pp, t_cs, tlab3, tspecs)


@pytest.mark.parametrize("name", sorted(FINGERPRINT_TWINS))
def test_config_fingerprint_matches_reference(name):
    make, kw = FINGERPRINT_TWINS[name]
    jp, tp = make(J_MODS), make(T_MODS)
    for strict in (True, False):
        for rt in (False, True):
            assert (tck.config_fingerprint(tp, strict, rt)
                    == jck.config_fingerprint(jp, strict, rt))
    js = jeng.TensorSearch(jp, **kw)
    ts = teng.TensorSearch(tp, device="cpu", **kw)
    assert ts._ckpt_fingerprint() == js._ckpt_fingerprint()
    assert ts._frontier_encoding() == js._frontier_encoding()
    if kw.get("symmetry"):
        assert "sym6" in ts._ckpt_fingerprint()
    if tp.fault is not None:
        assert tp.fault.signature() in ts._ckpt_fingerprint()


# -------------------------------------------------------------- the format

def _ckpt(depth=3, fingerprint="fp"):
    rng = np.random.default_rng(depth)
    return tck.SearchCheckpoint(
        fingerprint=fingerprint, depth=depth, explored=100 + depth,
        elapsed=1.5, frontier=rng.integers(-9, 9, (5, 7), dtype=np.int32),
        visited_keys=rng.integers(0, 2 ** 32, (9, 4), dtype=np.uint32),
        vis_over=2, extra={"spill_stats": np.arange(7, dtype=np.int64)})


def test_save_load_round_trip(tmp_path):
    """Every field and extra array survives; the JAX loader reads the
    port's dump to the same arrays (one format)."""
    pth = str(tmp_path / "ck.npz")
    ck = _ckpt()
    tck.save(pth, ck)
    for mod in (tck, jck):
        got = mod.load(pth, "fp")
        assert (got.depth, got.explored, got.elapsed, got.vis_over) == \
            (3, 103, 1.5, 2)
        np.testing.assert_array_equal(got.frontier, ck.frontier)
        np.testing.assert_array_equal(got.visited_keys, ck.visited_keys)
        np.testing.assert_array_equal(got.extra["spill_stats"],
                                      np.arange(7))
    assert tck.load(str(tmp_path / "missing.npz"), "fp") is None


def test_truncated_dump_falls_back_to_prev(tmp_path):
    pth = str(tmp_path / "ck.npz")
    tck.save(pth, _ckpt(depth=4))
    tck.save(pth, _ckpt(depth=5))
    assert os.path.exists(pth + ".prev")
    with open(pth, "r+b") as f:
        f.truncate(os.path.getsize(pth) // 2)
    with pytest.warns(RuntimeWarning, match="failed verification"):
        got = tck.load(pth, "fp")
    assert got.depth == 4
    assert tck.peek_depth(pth) == 4        # peek tracks the loader
    with open(pth + ".prev", "r+b") as f:
        f.truncate(10)
    with pytest.warns(RuntimeWarning):
        with pytest.raises(tck.CheckpointCorrupt):
            tck.load(pth, "fp")


def test_foreign_fingerprint_raises(tmp_path):
    pth = str(tmp_path / "ck.npz")
    tck.save(pth, _ckpt(fingerprint="theirs"))
    with pytest.raises(tck.CheckpointMismatch, match="theirs"):
        tck.load(pth, "ours")


def test_peek_depth_and_fingerprint(tmp_path):
    pth = str(tmp_path / "ck.npz")
    assert tck.peek_depth(pth) is None
    assert tck.peek_fingerprint(pth) is None
    tck.save(pth, _ckpt(depth=7, fingerprint="abc"))
    assert tck.peek_depth(pth) == 7
    assert tck.peek_fingerprint(pth) == "abc"


def test_async_writer_skips_while_busy():
    import threading

    gate = threading.Event()
    ran = []
    w = tck.AsyncCheckpointWriter()
    assert w.kick(lambda: (gate.wait(), ran.append(1)))
    assert w.busy()
    assert not w.kick(lambda: ran.append(2))       # skipped, not queued
    gate.set()
    w.join()
    assert ran == [1] and not w.busy()


# ----------------------------------------------------------------- resume

@pytest.fixture(scope="module")
def jax_engine(tmp_path_factory):
    """The JAX device loop on the compiled lab1 spec: its straight run to
    DEPTH_N, and its dump at DEPTH_K (packed rows)."""
    d = tmp_path_factory.mktemp("jax")
    js = jeng.TensorSearch(_lab1(jspecs), max_depth=DEPTH_K,
                           checkpoint_path=str(d / "k.npz"),
                           checkpoint_every=1, **KW)
    assert js._pk is not None
    assert js.run().depth == DEPTH_K
    js.checkpoint_path = None
    js.max_depth = DEPTH_N
    straight = js.run()
    assert straight.end_condition == "DEPTH_EXHAUSTED"
    return js, straight, str(d / "k.npz")


@pytest.mark.parametrize("loop", ["device", "host"])
def test_resume_matches_straight_run(jax_engine, tmp_path, loop):
    """Cut at DEPTH_K with a dump per level, resumed to DEPTH_N: the
    straight run's counts and the reference's."""
    _js, ref, _ = jax_engine
    host = loop == "host"
    pth = str(tmp_path / "port.npz")
    straight = _port(_lab1(tspecs), max_depth=DEPTH_N,
                     use_host_visited=host).run()
    cut = _port(_lab1(tspecs), max_depth=DEPTH_K, checkpoint_path=pth,
                checkpoint_every=1, use_host_visited=host).run()
    assert cut.depth == DEPTH_K and tck.peek_depth(pth) == DEPTH_K
    out = _port(_lab1(tspecs), max_depth=DEPTH_N, checkpoint_path=pth,
                use_host_visited=host).run(resume=True)
    assert _key(out) == _key(straight) == _key(ref)
    assert out.resumed_from_depth == DEPTH_K
    assert straight.resumed_from_depth == 0


def test_jax_dump_resumes_in_the_port(jax_engine):
    """A packed dump of the JAX device loop: the port decodes its rows
    (same encoding marker) and both port loops finish it exactly."""
    _js, ref, jdump = jax_engine
    assert tck.load(jdump, _port(_lab1(tspecs))._ckpt_fingerprint()
                    ).extra["frontier_encoding"].item().decode().startswith(
        "packed:")
    for host in (False, True):
        out = _port(_lab1(tspecs), max_depth=DEPTH_N, checkpoint_path=jdump,
                    use_host_visited=host).run(resume=True)
        assert _key(out) == _key(ref)
        assert out.resumed_from_depth == DEPTH_K


def test_port_dump_resumes_in_jax(jax_engine, tmp_path):
    js, ref, _ = jax_engine
    pth = str(tmp_path / "port.npz")
    _port(_lab1(tspecs), max_depth=DEPTH_K, checkpoint_path=pth,
          checkpoint_every=1).run()
    js.checkpoint_path = pth
    try:
        out = js.run(resume=True)
    finally:
        js.checkpoint_path = None
    assert _key(out) == _key(ref)
    # The JAX engine records the depth; its supervisor stamps outcomes.
    assert js._resumed_from_depth == DEPTH_K


def test_resume_without_dump_starts_at_the_root(tmp_path):
    out = _port(_lab1(tspecs), max_depth=4,
                checkpoint_path=str(tmp_path / "none.npz")).run(resume=True)
    assert out.resumed_from_depth == 0
    assert _key(out) == _key(_port(_lab1(tspecs), max_depth=4).run())


def test_resume_of_a_finished_search(tmp_path):
    """A dump written after the last level reports the finished verdict
    on both loops."""
    pth = str(tmp_path / "done.npz")
    p = _pruned(t_pp(2))
    full = _port(p, checkpoint_path=pth, checkpoint_every=1).run()
    assert full.end_condition == "SPACE_EXHAUSTED"
    for host in (False, True):
        out = _port(p, checkpoint_path=pth,
                    use_host_visited=host).run(resume=True)
        assert (out.end_condition, out.unique_states) == \
            ("SPACE_EXHAUSTED", full.unique_states)


# --------------------------------------------------------------- refusals

def _sym_paxos():
    p = tspecs.paxos_spec(3).compile()
    return dataclasses.replace(p, goals={},
                               prunes={"D": p.goals["DECIDED"]})


def test_symmetric_dump_refused_by_unreduced_search(tmp_path):
    """tests/test_symmetry.py:158 on the port: a reduced dump counts
    orbits, so an unreduced search refuses it, and the reverse; the
    reduced search resumes its own dump exactly."""
    pth = str(tmp_path / "sym.npz")
    kw = dict(checkpoint_path=pth, checkpoint_every=1)
    _port(_sym_paxos(), symmetry=True, max_depth=4, **kw).run()
    unreduced = _port(_sym_paxos(), max_depth=8, **kw)
    assert not unreduced.has_resumable_checkpoint()
    with pytest.raises(tck.CheckpointMismatch):
        unreduced.run(resume=True)
    full = _port(_sym_paxos(), symmetry=True).run()
    reduced = _port(_sym_paxos(), symmetry=True, **kw)
    assert reduced.has_resumable_checkpoint()
    out = reduced.run(resume=True)
    assert (out.end_condition, out.unique_states) == \
        (full.end_condition, full.unique_states) == ("SPACE_EXHAUSTED", 50)
    raw = str(tmp_path / "raw.npz")
    _port(_sym_paxos(), max_depth=2, checkpoint_path=raw,
          checkpoint_every=1).run()
    with pytest.raises(tck.CheckpointMismatch):
        _port(_sym_paxos(), symmetry=True,
              checkpoint_path=raw).run(resume=True)


def test_fault_dump_refused_by_fault_free_search(tmp_path):
    """tests/test_scenarios.py:275 on the port, both ways."""
    plain = _pruned(tspecs.paxos_spec(3).compile())
    part = _pruned(tspecs.paxos_partition_spec(3).compile())
    a, b = str(tmp_path / "plain.npz"), str(tmp_path / "part.npz")
    _port(plain, max_depth=3, checkpoint_path=a, checkpoint_every=1).run()
    _port(part, max_depth=3, checkpoint_path=b, checkpoint_every=1).run()
    with pytest.raises(tck.CheckpointMismatch):
        _port(part, checkpoint_path=a).run(resume=True)
    with pytest.raises(tck.CheckpointMismatch):
        _port(plain, checkpoint_path=b).run(resume=True)


def test_fault_counts_count_from_the_resume_point(tmp_path):
    """A resumed fault run counts fault events from its resume point, as
    the reference's does: the cut run's and the resumed run's counts
    add up to the straight run's (pinned 564 unique, 320 partition
    events: tests/test_scenarios.py)."""
    part = _pruned(tspecs.paxos_partition_spec(3).compile())
    pth = str(tmp_path / "part.npz")
    straight = _port(part).run()
    assert (straight.unique_states, straight.partition_events) == (564, 320)
    cut = _port(part, max_depth=6, checkpoint_path=pth,
                checkpoint_every=1).run()
    out = _port(part, checkpoint_path=pth).run(resume=True)
    assert _key(out) == _key(straight)
    assert cut.partition_events + out.partition_events == 320


def test_resume_with_record_trace_is_a_value_error(tmp_path):
    """The reference's refusal: a trace-recording search cannot rebuild
    its per-level records from a dump (one with its own fingerprint)."""
    pth = str(tmp_path / "ck.npz")
    _port(_lab1(tspecs), max_depth=2, checkpoint_path=pth,
          checkpoint_every=1).run()
    traced = _port(_lab1(tspecs), record_trace=True, checkpoint_path=pth)
    ck = tck.load(pth, _port(_lab1(tspecs))._ckpt_fingerprint())
    tck.save(pth, dataclasses.replace(
        ck, fingerprint=traced._ckpt_fingerprint()))
    with pytest.raises(ValueError, match="record_trace"):
        traced.run(resume=True)
