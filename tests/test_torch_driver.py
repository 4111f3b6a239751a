"""PyTorch port, the lab test driver (``python -m dslabs_tpu_torch.run_tests``)
against the root ``run_tests.py``: the same lab tests discovered and
selected, the same per-test PASS and points on lab 0 (object backend, and
the tensor backend on the CPU), saved traces replayed with the same verdict
line (a trace the JAX package wrote is skipped unimported), the same trace
HTML, and no quiet fallback (no card, no twin, no cloudpickle).  The port's
processes are checked, through ``python -X importtime``, to import nothing
of ``jax`` or ``dslabs_tpu``."""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

import run_tests as ref_driver
from dslabs_tpu_torch import run_tests as port_driver
from tests import torch_harness_cases as H

# One intra-op thread, here and in every child (OMP_NUM_THREADS): the
# suite runs several workers on a few cores.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PY = sys.executable

# The port's driver with its search tests' device moved to the CPU and
# 64-row chunks (the reference's 512 cost ~10x there and change no count).
CPU_DRIVER = """
import functools, sys, torch
from dslabs_tpu_torch.tpu import _build, backend, engine
def cpu(device=None):
    return torch.device("cpu" if device is None else device)
for m in (_build, backend, engine):
    m.resolve_device = cpu
backend._run_tensor = functools.partial(backend._run_tensor, chunk=64)
from dslabs_tpu_torch import run_tests
sys.exit(run_tests.main(sys.argv[1:]))
"""

# A violation trace saved through the harness (GlobalSettings.save_traces)
# by package argv[1]: ping-pong under the invariant "clients not done".
# Run with ``-c``, so its lambdas pickle by value.
MAKE_TRACE = """
import importlib, sys
def mod(name):
    return importlib.import_module(sys.argv[1] + "." + name)
LocalAddress = mod("core.address").LocalAddress
pp = mod("labs.pingpong.pingpong")
W = mod("testing.workload").Workload
P = mod("testing.predicates")
junit = mod("harness.junit")
mod("utils.flags").GlobalSettings.save_traces = True
SERVER = LocalAddress("pingserver")
gen = mod("testing.generator").NodeGenerator(
    server_supplier=lambda a: pp.PingServer(a),
    client_supplier=lambda a: pp.PingClient(a, SERVER),
    workload_supplier=lambda a: W(
        command_strings=["ping-%i"], result_strings=["ping-%i"],
        parser=lambda c, r: (pp.Ping(c), pp.Pong(r) if r is not None
                             else None)))
state = mod("search.search_state").SearchState(gen)
state.add_server(SERVER)
state.add_client_worker(LocalAddress("client1"))
settings = mod("search.settings").SearchSettings().add_invariant(
    P.CLIENTS_DONE.negate())
results = mod("search.search").bfs(state, settings)
try:
    junit.assert_end_condition_valid(results, lab="0", test_name="pings")
except junit.TestFailure as e:
    print("TestFailure:", e)
"""


def _env(**kw):
    env = dict(os.environ)
    env.pop("DSLABS_SEARCH_BACKEND", None)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    env.update(kw)
    return env


def _run(argv, cwd, timeout=240, **env):
    return subprocess.run(argv, cwd=cwd, env=_env(**env), text=True,
                          capture_output=True, timeout=timeout)


def _foreign_imports(stderr):
    """The modules of jax or of the JAX package a ``python -X importtime``
    process imported."""
    mods = [ln.rsplit("|", 1)[1].strip() for ln in stderr.splitlines()
            if ln.startswith("import time:")]
    assert mods, "no -X importtime lines"
    return sorted(m for m in mods
                  if m.split(".")[0] in ("jax", "jaxlib", "dslabs_tpu"))


def _results(path):
    """A results file without timings and output: per test its identity,
    points and verdict, and the totals."""
    data = json.loads(pathlib.Path(path).read_text())
    keep = ("lab", "part", "number", "name", "description", "categories",
            "points_earned", "points_available", "passed")
    return ([{k: t[k] for k in keep} for t in data["tests"]],
            [data[k] for k in ("num_passed", "num_tests", "points_earned",
                               "points_available")])


def _entries(registry, prefix):
    """The lab test files' entries of a registry, their modules under
    ``prefix``, as (module, identity) pairs."""
    mods = {prefix + m for m in port_driver.LAB_TEST_MODULES}
    return [(e.fn.__module__[len(prefix):],
             (e.lab, e.part, e.num, e.description, e.points, e.categories,
              e.timeout_secs, e.name))
            for e in registry if e.fn.__module__ in mods]


@pytest.fixture(scope="module")
def registries():
    from dslabs_tpu.harness import registry as ref_registry
    from dslabs_tpu_torch.harness import registry as port_registry

    ref_driver._discover()
    port_driver._discover()
    return ref_registry(), port_registry()


def test_discovers_the_reference_lab_tests(registries):
    ref, port = registries
    assert port_driver.LAB_TEST_MODULES == [
        m.split(".", 1)[1] for m in ref_driver.LAB_TEST_MODULES]
    want = _entries(ref, "tests.")
    have = _entries(port, "dslabs_tpu_torch._labtests.")
    assert len(want) > 100 and {m for m, _ in want} == set(
        port_driver.LAB_TEST_MODULES)
    assert have == want
    # Each registry holds its own package's entries only.
    assert all(e.fn.__module__.startswith("dslabs_tpu_torch.")
               for e in port)
    assert not any(e.fn.__module__.startswith("dslabs_tpu_torch.")
                   for e in ref)
    lab1 = sys.modules["dslabs_tpu_torch._labtests.test_lab1"]
    assert lab1.bfs.__module__ == "dslabs_tpu_torch.search.search"
    assert lab1.__file__ == str(REPO / "tests" / "test_lab1.py")


@pytest.mark.parametrize("sel", [
    dict(lab="3", exclude_run=True),
    dict(lab="1", part=2, nums=[3, 5]),
    dict(lab="4", part=3, exclude_search=True),
    dict(lab="2", exclude_unreliable=True),
], ids=["lab3-no-run", "lab1-part2-n3,5", "lab4-part3-no-search",
        "lab2-reliable"])
def test_selects_as_the_reference(registries, sel):
    from dslabs_tpu.harness import select_tests as ref_select
    from dslabs_tpu_torch.harness import select_tests as port_select

    ref, port = registries
    picked = [_entries(sel_fn(reg, **sel), prefix)
              for sel_fn, reg, prefix in (
                  (ref_select, ref, "tests."),
                  (port_select, port, "dslabs_tpu_torch._labtests."))]
    assert picked[0] and picked[0] == picked[1]


def test_lab0_object_backend_matches_reference(tmp_path):
    port = _run([PY, "-X", "importtime", "-m", "dslabs_tpu_torch.run_tests",
                 "--lab", "0", "--search-backend", "object",
                 "--results-file", str(tmp_path / "port.json")], tmp_path)
    ref = _run([PY, str(REPO / "run_tests.py"), "--lab", "0",
                "--search-backend", "object",
                "--results-file", str(tmp_path / "ref.json")], tmp_path)
    assert ref.returncode == 0, ref.stdout[-3000:]
    assert port.returncode == 0, port.stdout[-3000:]
    assert _results(tmp_path / "port.json") == _results(tmp_path / "ref.json")
    assert _foreign_imports(port.stderr) == []
    tail = port.stdout[port.stdout.index("Tests passed"):]
    assert tail.splitlines()[:2] == ["Tests passed: 10/10", "Points: 0/0"]


def test_lab0_tensor_backend_on_cpu_matches_reference(tmp_path):
    port = _run([PY, "-X", "importtime", "-c", CPU_DRIVER, "--lab", "0",
                 "--no-run", "--results-file", str(tmp_path / "port.json")],
                tmp_path)
    ref = _run([PY, str(REPO / "run_tests.py"), "--lab", "0", "--no-run",
                "--search-backend", "tensor",
                "--results-file", str(tmp_path / "ref.json")], tmp_path,
               DSLABS_FORCE_CPU="1", JAX_PLATFORMS="cpu", XLA_FLAGS="")
    assert ref.returncode == 0, ref.stdout[-3000:]
    assert port.returncode == 0, port.stdout[-3000:]
    assert _results(tmp_path / "port.json") == _results(tmp_path / "ref.json")
    assert _foreign_imports(port.stderr) == []


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """package -> the path of the trace that package saved."""
    out = {}
    for pkg in ("dslabs_tpu_torch", "dslabs_tpu"):
        d = tmp_path_factory.mktemp(pkg)
        r = _run([PY, "-c", MAKE_TRACE, pkg], d)
        assert r.returncode == 0 and "Saved trace to" in r.stdout, r.stderr
        (path,) = (d / "traces").iterdir()
        out[pkg] = path
    return out


def _verdicts(stdout):
    return [ln for ln in stdout.splitlines()
            if ln.startswith(("PASS", "FAIL")) or "saved traces pass" in ln]


def test_replay_traces_as_the_reference(tmp_path, traces):
    mixed = tmp_path / "mixed" / "traces"
    mixed.mkdir(parents=True)
    shutil.copy(traces["dslabs_tpu_torch"], mixed / "lab0_port.trace")
    shutil.copy(traces["dslabs_tpu"], mixed / "lab0_ref.trace")
    alone = tmp_path / "ref" / "traces"
    alone.mkdir(parents=True)
    shutil.copy(traces["dslabs_tpu"], alone)
    port = _run([PY, "-X", "importtime", "-m", "dslabs_tpu_torch.run_tests",
                 "--replay-traces"], tmp_path / "mixed")
    ref = _run([PY, str(REPO / "run_tests.py"), "--replay-traces"],
               tmp_path / "ref")
    assert port.returncode == ref.returncode == 1
    want = _verdicts(ref.stdout)
    assert want[0].startswith("FAIL  SerializableTrace(lab=0, part=None, "
                              "test=pings, events=")
    assert _verdicts(port.stdout) == want
    # The JAX package's trace is skipped as stale, and nothing of that
    # package is imported to read it.
    assert "Skipping unreadable trace" in port.stderr
    assert "lab0_ref.trace" in port.stderr
    assert _foreign_imports(port.stderr) == []


def test_render_trace_html_as_the_reference(traces):
    from dslabs_tpu.search.trace import SerializableTrace as RefTrace
    from dslabs_tpu.viz.server import render_trace_html as ref_render
    from dslabs_tpu_torch.search.trace import SerializableTrace as PortTrace
    from dslabs_tpu_torch.viz.server import render_trace_html as port_render

    port = PortTrace.load(str(traces["dslabs_tpu_torch"]))
    ref = RefTrace.load(str(traces["dslabs_tpu"]))
    assert len(port.history) == len(ref.history) > 0

    def html(render, t):
        # A field without a repr of its own shows its object's address,
        # which differs between loads.
        return re.sub(r" object at 0x[0-9a-f]+>", " object>", render(t))

    assert html(port_render, port) == html(ref_render, ref).replace(
        "dslabs_tpu.", "dslabs_tpu_torch.")
    # The port never loads the JAX package's trace.
    assert PortTrace.load(str(traces["dslabs_tpu"])) is None


def test_missing_cloudpickle_raises_where_a_trace_is_saved_or_loaded(
        monkeypatch, tmp_path, traces):
    from dslabs_tpu_torch.search import trace

    P = H.Pkg("dslabs_tpu_torch")
    state = H.lab0_state(P)
    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    with pytest.raises(ImportError, match="cloudpickle"):
        trace.SerializableTrace.load(str(traces["dslabs_tpu_torch"]))
    with pytest.raises(ImportError, match="cloudpickle"):
        trace.save_trace(state, [], "0", None, "", "t", directory=tmp_path)
    assert not any(tmp_path.iterdir())


def test_harness_imports_without_cloudpickle(tmp_path):
    r = _run([PY, "-c", "import sys; sys.modules['cloudpickle'] = None; "
              "import dslabs_tpu_torch.harness, dslabs_tpu_torch.viz, "
              "dslabs_tpu_torch.run_tests, dslabs_tpu_torch.search.trace"],
             tmp_path)
    assert r.returncode == 0, r.stderr


def test_tensor_backend_without_card_raises(monkeypatch):
    from dslabs_tpu_torch.utils.flags import GlobalSettings

    monkeypatch.setattr(GlobalSettings, "search_backend", "object")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_driver.main(["--lab", "0", "--no-run"])
    assert GlobalSettings.search_backend == "tensor"


def test_missing_twin_stays_a_fail(monkeypatch):
    from dslabs_tpu_torch.harness import SEARCH_TESTS, TestEntry, run_tests
    from dslabs_tpu_torch.tpu import backend
    from dslabs_tpu_torch.utils.flags import GlobalSettings

    monkeypatch.setattr(GlobalSettings, "search_backend", "tensor")
    monkeypatch.setattr(backend, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    P = H.Pkg("dslabs_tpu_torch")

    def no_twin():
        P.mod("search.search").bfs(H.no_twin_state(P), P.SearchSettings())

    report = run_tests([TestEntry(fn=no_twin, lab="0", num=1,
                                  description="no twin",
                                  categories=(SEARCH_TESTS,))])
    (r,) = report.results
    assert not r.passed and "NoTensorTwin: no tensor twin adapter" in r.error


def test_lint_is_not_ported(monkeypatch, tmp_path, capsys):
    """``--lint`` raised until the analysis slice; now it runs the port's
    conformance linter first, clean on the shipped tree."""
    from dslabs_tpu_torch.utils.flags import GlobalSettings

    monkeypatch.setattr(GlobalSettings, "search_backend", "object")
    monkeypatch.chdir(tmp_path)
    assert port_driver.main(["--lint", "--replay-traces"]) == 0
    out = capsys.readouterr().out
    assert "conformance lint: 0 finding(s)" in out
