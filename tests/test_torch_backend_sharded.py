"""PyTorch port, the harness binding's search on the owner-sharded engine
(``tensor_bfs`` over ``ShardedTensorSearch``, ``dslabs_tpu_torch/tpu/
backend.py``), against the JAX package on the CPU.

``_run_tensor`` runs ``ShardedTensorSearch`` at ``make_mesh(None)``, one
shard on the CPU, as the reference runs it over its devices.  The port's
verdict, counts and ``samples`` (root-first traces of the first, middle
and last state of the deepest level that kept rows, walked back through
the host fingerprint map) equal the JAX ``ShardedTensorSearch``'s at
``make_mesh(1)`` on the same bound twin; the whole ``tensor_bfs`` result
equals the JAX ``tensor_bfs``'s.  Kernel 2 runs on the harness path now:
one insert per chunk step, and the ladder's ``visited_cap`` bounds a
device table.  The port's searches run with 64-row chunks (the chunk
changes no count, depth or trace)."""

import functools

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)

from dslabs_tpu.tpu import backend as jback  # noqa: E402
from dslabs_tpu.tpu.sharded import ShardedTensorSearch as JSharded  # noqa: E402
from dslabs_tpu.tpu.sharded import make_mesh as j_mesh  # noqa: E402
from dslabs_tpu.utils.flags import GlobalSettings as JFlags  # noqa: E402
from dslabs_tpu_torch.tpu import backend as tback  # noqa: E402
from dslabs_tpu_torch.tpu import visited as visited_mod  # noqa: E402
from dslabs_tpu_torch.tpu.sharded import ShardedTensorSearch  # noqa: E402
from dslabs_tpu_torch.utils.flags import GlobalSettings as TFlags  # noqa: E402
from tests import torch_harness_cases as H  # noqa: E402

REF = H.Pkg("dslabs_tpu")
PORT = H.Pkg("dslabs_tpu_torch")
CHUNK = 64
CPU = torch.device("cpu")


@pytest.fixture
def tensor(monkeypatch):
    """Both packages' search backend set to ``tensor`` (derandomized
    workload streams on both sides), and 64-row chunks for the port."""
    monkeypatch.setattr(JFlags, "search_backend", "tensor")
    monkeypatch.setattr(TFlags, "search_backend", "tensor")
    monkeypatch.setattr(tback, "_run_tensor",
                        functools.partial(tback._run_tensor, chunk=CHUNK))


def _jax_first_rung(case):
    """The JAX engine at make_mesh(1) on the ladder's first rung of the
    case's bound twin, as ``_run_tensor`` builds it (no warm-up: these
    cases have no time limit)."""
    binding = jback.resolve_binding(case.state)
    binding.check_settings(case.settings)
    net_cap, timer_cap = binding.initial_caps()
    proto, marr, tarr = jback._bind_protocol(binding, case.settings,
                                             net_cap, timer_cap)
    f_cap, v_cap = jback._LADDER[0]
    s = JSharded(proto, j_mesh(1), chunk_per_device=CHUNK, frontier_cap=f_cap,
                 visited_cap=v_cap, strict=True, record_trace=True)
    s.set_runtime_masks(marr, tarr)
    root, _ = binding.derive_root(s, case.state)
    if case.settings.depth_limited():
        s.max_depth = case.settings.max_depth - case.state.depth
    return s.run(initial=root)


@pytest.mark.parametrize("name,build", [
    ("lab0_exhaust", H.lab0_exhaust),
    ("lab1_depth6", functools.partial(H.lab1_infinite_depth, depth=6)),
], ids=["lab0_exhaust", "lab1_depth6"])
def test_run_tensor_is_the_sharded_engine_with_jax_samples(
        tensor, monkeypatch, name, build):
    """``_run_tensor`` builds a one-shard ``ShardedTensorSearch`` on the
    CPU; its end condition, counts, depth and samples equal the JAX
    engine's at make_mesh(1); kernel 2 runs once at the root and once
    per chunk step."""
    inserts = []
    ins0 = visited_mod.insert

    def ins(table, keys, valid):
        inserts.append(keys.shape[0])
        return ins0(table, keys, valid)

    monkeypatch.setattr(visited_mod, "insert", ins)
    case = build(PORT)
    search, out, _hist = tback._run_tensor(
        tback.resolve_binding(case.state), case.settings, case.state, CPU,
        chunk=CHUNK)
    assert type(search) is ShardedTensorSearch
    assert (search.n_devices, search.device.type, search.record_trace,
            search.strict) == (1, "cpu", True, True)
    ref = _jax_first_rung(build(REF))
    assert (out.end_condition, out.unique_states, out.states_explored,
            out.depth) == (ref.end_condition, ref.unique_states,
                           ref.states_explored, ref.depth)
    assert out.samples and out.samples == ref.samples
    assert len(inserts) == 1 + sum(lv["chunks"] for lv in out.levels)


def test_tensor_bfs_lab0_exhaust_equals_jax(tensor):
    """The public entry: the port's ``tensor_bfs`` on the lab 0 exhaust
    shape gives the JAX ``tensor_bfs``'s verdict and discovered count
    (and the object checker's)."""
    port = tback.tensor_bfs(H.lab0_exhaust(PORT).state,
                            H.lab0_exhaust(PORT).settings, device="cpu")
    jcase = H.lab0_exhaust(REF)
    ref = jback.tensor_bfs(jcase.state, jcase.settings)
    assert H.end_name(port) == H.end_name(ref) == "SPACE_EXHAUSTED"
    assert port.discovered_count == ref.discovered_count


def test_visited_cap_bounds_a_device_table_and_escalates(tensor,
                                                         monkeypatch):
    """A first rung whose 8-slot table cannot hold the lab 1 depth-6
    space overflows (a strict table past 75 %) and the ladder escalates
    to the next rung, which lands the exact count."""
    case = H.lab1_infinite_depth(PORT, 6)
    full = tback.tensor_bfs(case.state, case.settings, device="cpu")
    seen = []
    init0 = ShardedTensorSearch.__init__

    def init(self, *a, **kw):
        seen.append(kw["visited_cap"])
        init0(self, *a, **kw)

    monkeypatch.setattr(ShardedTensorSearch, "__init__", init)
    monkeypatch.setattr(tback, "_LADDER", [(1 << 10, 1 << 3),
                                           (1 << 10, 1 << 10)])
    small = tback.tensor_bfs(case.state, case.settings, device="cpu")
    assert seen == [1 << 3, 1 << 10]
    assert H.end_name(small) == H.end_name(full) == "SPACE_EXHAUSTED"
    assert small.discovered_count == full.discovered_count > 6
