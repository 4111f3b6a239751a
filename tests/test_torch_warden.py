"""PyTorch port, the process-isolated dispatch warden (``dslabs_tpu_torch/
tpu/warden.py``), on the CPU: the cases of ``tests/test_warden.py``.

Children are spawned with ``device="cpu"`` in their spec and
``OMP_NUM_THREADS=1``, rebuild their protocol from a factory of the port
(``dslabs_tpu_torch.tpu.protocols.*``) and import no JAX: the transform
``tests.torch_harness_cases:pruned_without_jax`` refuses to run in a
process that loaded JAX or the JAX package.  Verdicts are held against
the straight port run and the JAX package's straight run, and the
process-isolated supervisor against the JAX warden on the JAX factory;
the exit-code table is pinned as the reference pins it, and both
packages' classifiers agree on it.

Not ported here: the reference's ``.prev`` rotation and truncated-main
cases, which ``tests/test_torch_checkpoint.py`` holds."""

import dataclasses
import os
import signal
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)

from dslabs_tpu.tpu import engine as jeng  # noqa: E402
from dslabs_tpu.tpu import supervisor as jsup  # noqa: E402
from dslabs_tpu.tpu import warden as jwarden  # noqa: E402
from dslabs_tpu.tpu.protocols.clientserver import \
    make_clientserver_protocol as j_cs  # noqa: E402
from dslabs_tpu.tpu.protocols.pingpong import \
    make_pingpong_protocol as j_pp  # noqa: E402
from dslabs_tpu_torch.tpu import checkpoint as tck  # noqa: E402
from dslabs_tpu_torch.tpu import engine as teng  # noqa: E402
from dslabs_tpu_torch.tpu import supervisor as tsup  # noqa: E402
from dslabs_tpu_torch.tpu import warden as twarden  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.clientserver import \
    make_clientserver_protocol as t_cs  # noqa: E402
from dslabs_tpu_torch.tpu.protocols.pingpong import \
    make_pingpong_protocol as t_pp  # noqa: E402
from tests.torch_harness_cases import pruned  # noqa: E402

pytestmark = pytest.mark.fault

CHILD_ENV = {"OMP_NUM_THREADS": "1"}
TRANSFORM = "tests.torch_harness_cases:pruned_without_jax"
PINGPONG = {
    "factory": "dslabs_tpu_torch.tpu.protocols.pingpong:"
               "make_pingpong_protocol",
    "factory_kwargs": {"workload_size": 2},
    "transform": TRANSFORM,
}
LAB1 = {
    "factory": "dslabs_tpu_torch.tpu.protocols.clientserver:"
               "make_clientserver_protocol",
    "factory_kwargs": {"n_clients": 1, "w": 2},
    "transform": TRANSFORM,
}


def _warden(refs, **kw):
    kw.setdefault("chunk", 64)
    kw.setdefault("frontier_cap", 1 << 8)
    kw.setdefault("visited_cap", 1 << 12)
    kw.setdefault("env", CHILD_ENV)
    kw.setdefault("device", "cpu")
    return twarden.Warden(**refs, **kw)


def _key(o):
    return (o.end_condition, o.unique_states, o.states_explored)


@pytest.fixture(scope="module")
def base_pingpong():
    """The straight port run, equal to the JAX package's."""
    out = teng.TensorSearch(pruned(t_pp(2)), chunk=64, device="cpu").run()
    ref = jeng.TensorSearch(pruned(j_pp(2)), chunk=64).run()
    assert _key(out) == _key(ref)
    assert out.end_condition == "SPACE_EXHAUSTED"
    return out


@pytest.fixture(scope="module")
def base_lab1():
    out = teng.TensorSearch(pruned(t_cs(n_clients=1, w=2)), chunk=64,
                            device="cpu").run()
    ref = jeng.TensorSearch(pruned(j_cs(n_clients=1, w=2)), chunk=64).run()
    assert _key(out) == _key(ref)
    assert out.end_condition == "SPACE_EXHAUSTED"
    return out


# ------------------------------------------------- exit-code taxonomy

DEATHS = [
    ((-signal.SIGKILL, True), "wedge"),
    ((-signal.SIGKILL, False), "oom"),
    ((-signal.SIGSEGV, False), "crash"),
    ((-signal.SIGTERM, False), "crash"),
    ((tsup.CHILD_RC_FAILED, False), "failed"),
    ((1, False), "crash"),
    ((86, False), "crash"),
    ((1, False, ["torch.OutOfMemoryError: CUDA out of memory."]), "oom"),
    ((1, False, ["MemoryError"]), "oom"),
    ((tsup.CHILD_RC_FAILED, False, ["out of memory"]), "failed"),
]


@pytest.mark.parametrize("args,kind", DEATHS,
                         ids=[f"{a[0]}-{a[1]}-{len(a) > 2}"
                              for a, _ in DEATHS])
def test_exit_code_classification_pinned(args, kind):
    """The death taxonomy is part of the warden's contract, and both
    packages agree on the reference's table (an OutOfMemoryError
    traceback in a stderr tail is the port's addition)."""
    assert twarden.classify_death(*args) == kind
    assert tsup.CHILD_RC_FAILED == jsup.CHILD_RC_FAILED
    if not (len(args) > 2 and "OutOfMemoryError" in args[2][0]):
        assert jwarden.classify_death(*args) == kind


# --------------------------------------- SIGKILL mid-search -> resume

def test_child_sigkill_mid_search_resumes_strict_pingpong(tmp_path,
                                                          base_pingpong):
    """A child SIGKILLed mid-search (armed at dispatch 8 of the device
    rung, after a durable dump) gives the straight run's verdict and
    counts, resumed from the checkpoint by the next rung's child."""
    w = _warden(PINGPONG, ladder=("device", "host"),
                checkpoint_path=str(tmp_path / "pp.npz"),
                checkpoint_every=1,
                fault={"kind": "die", "at": 8, "engine": "device",
                       "after_ckpt": True})
    out = w.run()
    assert _key(out) == _key(base_pingpong)
    assert (out.engine, out.failovers, out.child_restarts) == ("host", 1, 1)
    assert out.resumed_from_depth > 0
    assert [d.kind for d in w.deaths] == ["oom"]
    # The heartbeats carried the seam's state out of the dead child.
    hb = w.deaths[0].last_hb
    assert hb is not None and hb["tag"].startswith("device.")
    for key in ("n", "depth", "ckpt_depth"):
        assert key in hb
    assert w.last_platform == "cpu"


def test_child_sigkill_mid_search_resumes_strict_lab1(tmp_path, base_lab1):
    """The same on the lab1 strict clientserver BFS (a deeper space)."""
    w = _warden(LAB1, ladder=("device", "host"),
                checkpoint_path=str(tmp_path / "cs.npz"),
                checkpoint_every=1,
                fault={"kind": "die", "at": 11, "engine": "device",
                       "after_ckpt": True})
    out = w.run()
    assert _key(out) == _key(base_lab1)
    assert (out.engine, out.child_restarts) == ("host", 1)
    assert out.resumed_from_depth > 0


# --------------------------------------------------- hang -> SIGKILL

def test_hung_child_is_reaped_within_deadline(tmp_path, base_pingpong):
    """A child that wedges mid-dispatch (an uninterruptible hang) is
    SIGKILLed within its announced grace and the search completes on the
    next rung, in seconds."""
    t0 = time.time()
    w = _warden(PINGPONG, ladder=("device", "host"),
                checkpoint_path=str(tmp_path / "hang.npz"),
                checkpoint_every=1,
                boot_grace=120.0, first_grace=120.0, steady_grace=3.0,
                idle_grace=60.0, grace_slack=1.0,
                fault={"kind": "hang", "at": 8, "engine": "device"})
    out = w.run()
    elapsed = time.time() - t0
    assert _key(out) == _key(base_pingpong)
    assert [d.kind for d in w.deaths] == ["wedge"]
    assert w.deaths[0].exitcode == -signal.SIGKILL
    assert 3.0 <= w.deaths[0].silent_secs < 3.0 + 1.0 + 2.0
    assert out.killed_dispatches == 1
    assert out.child_restarts == 1
    # The hang itself was cut at steady_grace + slack = 4 s.
    assert elapsed < 60.0, f"hung child reaped too slowly ({elapsed:.0f}s)"


# ------------------------------------------------ crash / failed rungs

def test_abrupt_child_exit_classified_crash_and_failed_over(tmp_path,
                                                            base_pingpong):
    """An abrupt os._exit mid-search is a ``crash``; the ladder recovers
    on the next rung with the straight run's counts."""
    w = _warden(PINGPONG, ladder=("device", "host"),
                checkpoint_path=str(tmp_path / "crash.npz"),
                checkpoint_every=1,
                fault={"kind": "exit", "at": 8, "engine": "device"})
    out = w.run()
    assert _key(out) == _key(base_pingpong)
    assert [d.kind for d in w.deaths] == ["crash"]
    assert w.deaths[0].exitcode == 86


def test_in_child_fatal_error_reported_and_exhausts_ladder():
    """A classified in-child failure is reported over the pipe
    (``failed``, CHILD_RC_FAILED) and a one-rung ladder surfaces it as a
    loud SupervisorExhausted."""
    w = _warden(PINGPONG, ladder=("device",),
                fault={"kind": "raise", "at": 3, "engine": "device"})
    with pytest.raises(tsup.SupervisorExhausted) as ei:
        w.run()
    assert len(ei.value.failures) == 1
    f = ei.value.failures[0]
    assert isinstance(f, tsup.EngineFailure)
    assert (f.engine, f.kind) == ("device", "failed")
    assert w.deaths[0].exitcode == tsup.CHILD_RC_FAILED


def test_last_rung_forces_cpu_runtime(base_pingpong):
    """The last rung's child runs off the card: ``device="cpu"`` in its
    spec and ``CUDA_VISIBLE_DEVICES=`` in its environment (the earlier
    rungs keep the warden's device), and it reports the CPU."""
    w = _warden(PINGPONG, ladder=("host",))
    out = w.run()
    assert out.engine == "host"
    assert _key(out) == _key(base_pingpong)
    assert w.last_platform == "cpu"
    two = _warden(PINGPONG, ladder=("device", "device", "host"))
    two.device = "cuda"
    specs = []
    for _ in two.ladder:
        specs.append(two._spec("device", False))
        two.deaths.append(None)
    assert [(s["device"], s["force_cpu"]) for s in specs] == [
        ("cuda", False), ("cuda", False), ("cpu", True)]
    env = two._child_env(specs[-1])
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    assert env["OMP_NUM_THREADS"] == "1"
    assert two._child_env(specs[0]).get("CUDA_VISIBLE_DEVICES") == \
        os.environ.get("CUDA_VISIBLE_DEVICES")


def test_one_rung_ladder_keeps_the_spec_device():
    """Only a child that replaces a dead one is forced off the card: the
    first child of a one-rung ladder keeps the warden's device and the
    caller's environment, and a replacement on that rung would not."""
    one = _warden(PINGPONG, ladder=("device",))
    one.device = "cuda"
    spec = one._spec("device", False)
    assert (spec["device"], spec["force_cpu"]) == ("cuda", False)
    assert one._child_env(spec).get("CUDA_VISIBLE_DEVICES") == \
        os.environ.get("CUDA_VISIBLE_DEVICES")
    two = _warden(PINGPONG, ladder=("device", "device"))
    two.device = "cuda"
    assert two._spec("device", False)["device"] == "cuda"
    two.deaths.append(None)
    assert (two._spec("device", True)["device"],
            two._spec("device", True)["force_cpu"]) == ("cpu", True)


# -------------------------------------- supervisor process-isolation

def test_supervisor_process_isolation_mode_verdict_parity(base_pingpong):
    """SearchSupervisor(process_isolation=True) rides the warden with the
    verdict of the JAX package's warden on the JAX factory, and the
    recovery fields present and zero."""
    sup = tsup.SearchSupervisor(
        None, ladder=("device",), chunk=64, frontier_cap=1 << 8,
        visited_cap=1 << 12, process_isolation=True,
        protocol_factory=PINGPONG["factory"],
        factory_kwargs=PINGPONG["factory_kwargs"],
        protocol_transform=PINGPONG["transform"],
        warden_kwargs={"env": CHILD_ENV}, device="cpu")
    out = sup.run()
    ref = jsup.SearchSupervisor(
        None, ladder=("device",), chunk=64, frontier_cap=1 << 8,
        visited_cap=1 << 12, process_isolation=True,
        protocol_factory="dslabs_tpu.tpu.protocols.pingpong:"
                         "make_pingpong_protocol",
        factory_kwargs={"workload_size": 2},
        protocol_transform="tests.test_warden:prune_pingpong",
        warden_kwargs={"env": {"OMP_NUM_THREADS": "1"}}).run()
    assert _key(out) == _key(ref) == _key(base_pingpong)
    assert out.engine == ref.engine == "device"
    assert (out.failovers, out.child_restarts, out.killed_dispatches) == (
        0, 0, 0)
    assert sup.failures == []
    # The child's platform reaches the caller on the outcome and on the
    # supervisor, as the in-process ladder reports its own.
    assert out.platform == sup.last_platform == "cpu"


def test_process_isolation_requires_factory():
    sup = tsup.SearchSupervisor(None, ladder=("device",),
                                process_isolation=True, device="cpu")
    with pytest.raises(ValueError, match="protocol_factory"):
        sup.run()


# ------------------------------- checkpoint torn-write robustness

def _mini_ckpt(fingerprint, depth):
    return tck.SearchCheckpoint(
        fingerprint=fingerprint, depth=depth, explored=10 * depth,
        elapsed=1.0 * depth,
        frontier=np.full((2, 3), depth, np.int32),
        visited_keys=np.full((4, 4), depth, np.uint32))


def test_corrupt_payload_detected_by_checksum(tmp_path):
    """A bit flip that keeps the zip readable is caught by the content
    checksum; with no ``.prev`` the loader raises CheckpointCorrupt, in
    both packages' loaders."""
    from dslabs_tpu.tpu import checkpoint as jck

    path = str(tmp_path / "flip.npz")
    tck.save(path, _mini_ckpt("fp", 3))
    with open(path, "r+b") as f:
        blob = bytearray(f.read())
        payload = np.full((2, 3), 3, np.int32).tobytes()
        off = blob.find(payload)
        assert off > 0, "frontier payload not found in npz"
        blob[off] ^= 0xFF
        f.seek(0)
        f.write(blob)
    for mod in (tck, jck):
        with pytest.warns(RuntimeWarning):
            with pytest.raises(mod.CheckpointCorrupt):
                mod.load(path, "fp")


def test_sigkill_mid_checkpoint_write_resume_parity(tmp_path,
                                                    base_pingpong):
    """A run cut at depth 2 whose next dump was killed mid-write (the
    good dump rotated to ``.prev``, the main one torn): a fresh engine
    resumes from the rotated dump to the straight run's verdict."""
    proto = pruned(t_pp(2))
    path = str(tmp_path / "kill.npz")
    cut = teng.TensorSearch(proto, chunk=64, max_depth=2,
                            checkpoint_path=path, checkpoint_every=1,
                            device="cpu")
    assert cut.run().end_condition == "DEPTH_EXHAUSTED"
    with open(path, "rb") as f:
        blob = f.read()
    os.replace(path, path + ".prev")
    with open(path, "wb") as f:
        f.write(blob[:200])
    resumed = teng.TensorSearch(proto, chunk=64, checkpoint_path=path,
                                device="cpu")
    with pytest.warns(RuntimeWarning):
        r = resumed.run(resume=True)
    assert _key(r) == _key(base_pingpong)
    assert resumed._resumed_from_depth == 2


def _marked_processes(mark: str):
    """Live processes whose environment carries ``mark``."""
    found = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if mark.encode() in f.read():
                    found.append(int(pid))
        except OSError:
            continue
    return found


def test_sharded_child_runs_its_ranks(tmp_path, base_pingpong):
    """A sharded child over a rank mesh (two gloo ranks on the CPU) runs
    the ranks itself and relays rank 0's dispatches as its heartbeats; a
    SIGKILL of that child once a dump is on disk takes its ranks with it,
    and the host rung resumes the ranks' dump to the straight run's
    verdict."""
    from dslabs_tpu_torch.tpu.telemetry import Telemetry

    mark = f"DSLABS_RANK_TEST_{os.getpid()}_{time.time_ns()}"
    tel = Telemetry()
    w = _warden(PINGPONG, ladder=("sharded", "host"),
                rank_mesh={"devices": ["cpu", "cpu"], "backend": "gloo"},
                env={**CHILD_ENV, mark: "1"}, telemetry=tel,
                checkpoint_path=str(tmp_path / "ranks.npz"),
                checkpoint_every=1,
                fault={"kind": "die", "at": 5, "spawns": [0],
                       "after_ckpt": True})
    assert w.mesh_width == 2
    out = w.run()
    assert _key(out) == _key(base_pingpong)
    assert out.engine == "host" and out.resumed_from_depth > 0
    assert [d.kind for d in w.deaths] == ["oom"]
    tags = {e.get("tag") for e in tel.events if e.get("kind") == "heartbeat"}
    assert "sharded.superstep" in tags
    t_end = time.time() + 10.0
    while _marked_processes(mark) and time.time() < t_end:
        time.sleep(0.1)
    assert _marked_processes(mark) == []


def test_outcome_round_trips_through_the_pipe_format():
    """outcome_to_dict / outcome_from_dict keep every recovery field and
    the terminal state."""
    out = teng.TensorSearch(t_pp(2), chunk=64, device="cpu").run()
    out.retries, out.failovers, out.engine = 2, 1, "host"
    out.knob_retries, out.cancelled = 1, True
    back = twarden.outcome_from_dict(twarden.outcome_to_dict(out))
    for f in dataclasses.fields(out):
        a, b = getattr(out, f.name), getattr(back, f.name)
        if f.name in ("goal_state", "violating_state") and a is not None:
            assert {k: np.asarray(v).tolist() for k, v in a.items()} == \
                {k: np.asarray(v).tolist() for k, v in b.items()}
        elif f.name in twarden._SCALAR_FIELDS:
            assert a == b, f.name
