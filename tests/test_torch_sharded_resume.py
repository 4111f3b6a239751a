"""PyTorch port, the owner-sharded engine's checkpoints and spill tier
(``dslabs_tpu_torch/tpu/sharded.py``) and the swarm's walker
redistribution (``tpu/swarm.py``), on the CPU at small sizes: the resume
and spill cases of ``tests/test_tpu_sharded.py``,
``tests/test_mesh_exchange.py`` and ``tests/test_mesh_packing.py``, and
``tests/test_swarm.py``'s cross-width resume.

A dump cut at one width resumes at every other width and on the solo
engine with the straight run's counts, packed and raw; the JAX engine's
sharded dumps resume in the port and the port's in the JAX engine, at
another width (two cases run the JAX engine, on the conftest's virtual
mesh); spill at an eighth of the table gives the full run's counts; a
swarm dump resumes at half and twice its walker count with the uncut
run's verdict and bit-exact at its own.  One intra-op thread, no child
process."""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dslabs_tpu_torch.tpu import checkpoint as tck  # noqa: E402
from dslabs_tpu_torch.tpu import swarm as tsw  # noqa: E402
from dslabs_tpu_torch.tpu.engine import TensorSearch  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.clientserver import \
    make_clientserver_protocol  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.pingpong import \
    make_pingpong_protocol  # noqa: E402
from dslabs_tpu_torch.tpu.sharded import (ShardedTensorSearch,  # noqa: E402
                                          make_mesh)
from dslabs_tpu_torch.tpu.specs import pingpong_spec  # noqa: E402
from tests.torch_harness_cases import pruned, violating  # noqa: E402

KW = dict(chunk_per_device=16, frontier_cap=1 << 8, visited_cap=1 << 10)
PINGPONG = ("SPACE_EXHAUSTED", 8, 23, 5)


def _key(o):
    return (o.end_condition, o.unique_states, o.states_explored, o.depth)


def _sh(proto, d, **kw):
    return ShardedTensorSearch(proto, make_mesh(d, device="cpu"),
                               **{**KW, **kw})


def _spec_pingpong():
    p = pingpong_spec(2).compile()
    name = next(iter(p.goals))
    return dataclasses.replace(p, goals={}, prunes={name: p.goals[name]})


# ------------------------------------------------------- cross-width

@pytest.mark.parametrize("packed", [True, False], ids=["packed", "raw"])
def test_resume_8_4_2_1_and_solo(packed, tmp_path):
    """A dump cut at D = 8 resumes at 4, that run's at 2, that run's at
    1, to the straight run's counts; the solo engine resumes the D = 8
    dump, and a D = 4 engine resumes the solo engine's."""
    proto = _spec_pingpong()
    kw = dict(mesh_pack=packed)
    straight = _sh(proto, 8, **kw).run()
    assert _key(straight) == PINGPONG
    path = str(tmp_path / "mesh.npz")
    out = _sh(proto, 8, checkpoint_path=path, checkpoint_every=1,
              max_depth=2, **kw).run()
    assert out.end_condition == "DEPTH_EXHAUSTED"
    ck = np.load(path)
    assert ("extra__frontier_encoding" in ck.files) == packed
    for width, depth, start in ((4, 3, 1), (2, 4, 2), (1, None, 3)):
        s = _sh(proto, width, checkpoint_path=path, checkpoint_every=1,
                max_depth=depth, **kw)
        assert (s._pk is not None) == packed
        out = s.run(resume=True)
        assert out.resumed_from_depth == start
    assert _key(out) == _key(straight)

    _sh(proto, 8, checkpoint_path=path, checkpoint_every=1, max_depth=2,
        **kw).run()
    solo = TensorSearch(proto, chunk=64, device="cpu", checkpoint_path=path,
                        packed=packed).run(resume=True)
    assert _key(solo) == _key(straight) and solo.resumed_from_depth == 1
    spath = str(tmp_path / "solo.npz")
    TensorSearch(proto, chunk=64, device="cpu", checkpoint_path=spath,
                 checkpoint_every=1, max_depth=3, packed=packed).run()
    out = _sh(proto, 4, checkpoint_path=spath, **kw).run(resume=True)
    assert _key(out) == _key(straight) and out.resumed_from_depth == 3


def test_finished_and_foreign_dumps(tmp_path):
    """A dump written after the last level resumes to its verdict; a dump
    of another configuration is refused by name."""
    proto = pruned(make_pingpong_protocol(workload_size=2))
    path = str(tmp_path / "done.npz")
    f1 = _sh(proto, 4, checkpoint_path=path, checkpoint_every=1).run()
    f2 = _sh(proto, 2, checkpoint_path=path).run(resume=True)
    assert _key(f1) == _key(f2) == PINGPONG
    bigger = dataclasses.replace(proto, net_cap=proto.net_cap * 2)
    other = _sh(bigger, 4, checkpoint_path=path)
    assert not other.has_resumable_checkpoint()
    with pytest.raises(tck.CheckpointMismatch) as ei:
        other.run(resume=True)
    assert other._ckpt_fingerprint() in str(ei.value)
    assert _sh(proto, 8, chunk_per_device=32,
               checkpoint_path=path).has_resumable_checkpoint()


# ------------------------------------------------------------- spill

def test_spill_at_an_eighth_of_the_table(tmp_path):
    """Strict spill mode with the table at about 1/8 of the reachable
    count: the full run's counts, the tier engaged; its spill-mode dump
    resumes at another width without spill."""
    proto = pruned(make_clientserver_protocol(n_clients=2, w=2))
    kw = dict(frontier_cap=1 << 9, chunk_per_device=1)
    base = _sh(proto, 2, visited_cap=1 << 12, **kw).run()
    cap = 1 << max(3, int(np.floor(np.log2(max(base.unique_states // 8,
                                                8)))))
    out = _sh(proto, 2, visited_cap=cap, spill=True, **kw).run()
    assert _key(out) == _key(base) == ("SPACE_EXHAUSTED", 80, 582, 11)
    assert out.spilled_keys > 0 and out.dropped_states == 0
    path = str(tmp_path / "spill.npz")
    cut = _sh(proto, 4, visited_cap=cap, spill=True, checkpoint_path=path,
              checkpoint_every=1, max_depth=6, **kw).run()
    assert cut.end_condition == "DEPTH_EXHAUSTED"
    res = _sh(proto, 2, visited_cap=1 << 12, checkpoint_path=path,
              **kw).run(resume=True)
    assert _key(res) == _key(base) and res.resumed_from_depth == 5


# -------------------------------------------- dumps across the packages

def _jax_proto():
    from dslabs_tpu.tpu.specs import pingpong_spec as j_pp

    p = j_pp(2).compile()
    name = next(iter(p.goals))
    return dataclasses.replace(p, goals={}, prunes={name: p.goals[name]})


def test_jax_sharded_dump_resumes_in_the_port(tmp_path):
    """A JAX sharded dump (D = 2, packed) resumes on the port at D = 4 and
    on the port's solo engine, to the straight run's counts."""
    pytest.importorskip("jax")
    from dslabs_tpu.tpu import sharded as jsh

    path = str(tmp_path / "jax.npz")
    jsh.ShardedTensorSearch(_jax_proto(), jsh.make_mesh(2),
                            checkpoint_path=path, checkpoint_every=2,
                            max_depth=3, **KW).run()
    assert tck.peek_depth(path) == 2
    out = _sh(_spec_pingpong(), 4, checkpoint_path=path).run(resume=True)
    assert _key(out) == PINGPONG and out.resumed_from_depth == 2
    solo = TensorSearch(_spec_pingpong(), chunk=64, device="cpu",
                        checkpoint_path=path).run(resume=True)
    assert _key(solo) == PINGPONG


def test_port_sharded_dump_resumes_in_jax(tmp_path):
    """A port sharded dump (D = 4, packed) resumes on the JAX engine at
    D = 2, to the straight run's counts."""
    pytest.importorskip("jax")
    from dslabs_tpu.tpu import sharded as jsh

    path = str(tmp_path / "port.npz")
    _sh(_spec_pingpong(), 4, checkpoint_path=path, checkpoint_every=2,
        max_depth=3).run()
    assert tck.peek_depth(path) == 2
    out = jsh.ShardedTensorSearch(_jax_proto(), jsh.make_mesh(2),
                                  checkpoint_path=path, **KW).run(
        resume=True)
    assert (out.end_condition, out.unique_states, out.states_explored,
            out.depth) == PINGPONG


# ------------------------------------------------- swarm redistribution

def _bfs_dump(proto, tmp_path):
    pth = str(tmp_path / "bfs.npz")
    TensorSearch(proto, chunk=64, max_depth=2, checkpoint_path=pth,
                 checkpoint_every=1, device="cpu").run()
    return pth


def _swarm(proto, walkers, **kw):
    return tsw.SwarmSearch(proto, walkers_per_device=walkers,
                           visited_cap=1 << 12, device="cpu", **kw)


def test_swarm_dump_resumes_at_half_and_twice_its_walkers(tmp_path):
    """A frontier-seeded swarm cut after round 1 at K = 8 walkers resumes
    at K = 4 and K = 16 (redistributed, with a warning) with the uncut
    run's verdict and a replay-verified witness, and at K = 8 as the
    identical continuation."""
    proto = violating(make_pingpong_protocol(3))
    kw = dict(max_steps=24, steps_per_round=2, seed=3,
              frontier_seed=_bfs_dump(proto, tmp_path))
    full = _swarm(proto, 8, **kw).run()
    assert full.end_condition == "INVARIANT_VIOLATED"
    assert full.swarm["rounds"] > 1
    ck = str(tmp_path / "swarm.npz")
    cut = _swarm(proto, 8, max_rounds=1, checkpoint_path=ck,
                 checkpoint_every=1, **kw).run()
    assert cut.end_condition == "TIME_EXHAUSTED"
    for k in (4, 16):
        with pytest.warns(RuntimeWarning, match="redistributes 8 walkers"):
            out = _swarm(proto, k, checkpoint_path=ck, **kw).run(
                resume=True)
        assert out.end_condition == full.end_condition
        assert out.predicate_name == full.predicate_name
        assert out.witness is not None and out.witness.trace
        assert out.resumed_from_depth == 1
        assert out.swarm["walkers"] == k
        assert out.swarm["explored"] >= cut.swarm["explored"]
    same = _swarm(proto, 8, checkpoint_path=ck, **kw).run(resume=True)
    assert same.witness.raw_trace == full.witness.raw_trace
    for k in ("explored", "unique", "revisits", "restarts", "deepest",
              "rounds"):
        assert same.swarm[k] == full.swarm[k], k
