"""PyTorch port, its own copy of the object layer: every copied module
equals the reference's source with the import root ``dslabs_tpu.``
rewritten to ``dslabs_tpu_torch.`` (so the copy cannot drift), and the
object checkers of both packages give the same verdict, depth and
``discovered_count`` on the lab 0-3 search-test shapes of
``tests/torch_harness_cases.py`` and the lab 4 join phase of
``tests/torch_lab4_cases.py``.  Every comparison is exact."""

import pathlib

import pytest

from tests import torch_harness_cases as H
from tests import torch_lab4_cases as L4

REPO = pathlib.Path(__file__).resolve().parent.parent

# The closure of what the port's harness binding imports from the object
# layer, each package's __init__.py included.
COPIED = [
    "utils/__init__.py", "utils/flags.py", "utils/structural.py",
    "utils/check_logger.py",
    "core/__init__.py", "core/address.py", "core/types.py", "core/node.py",
    "core/client_utils.py",
    "testing/__init__.py", "testing/events.py", "testing/workload.py",
    "testing/client_worker.py", "testing/generator.py",
    "testing/settings.py", "testing/state.py", "testing/predicates.py",
    "search/__init__.py", "search/timer_queue.py",
    "search/search_state.py", "search/settings.py", "search/results.py",
    "search/minimize.py", "search/replay.py", "search/search.py",
    "labs/__init__.py", "labs/pingpong/__init__.py",
    "labs/pingpong/pingpong.py", "labs/clientserver/__init__.py",
    "labs/clientserver/amo.py", "labs/clientserver/kvstore.py",
    "labs/clientserver/clientserver.py", "labs/clientserver/kv_workload.py",
    "labs/primarybackup/__init__.py", "labs/primarybackup/viewserver.py",
    "labs/primarybackup/pb.py", "labs/paxos/__init__.py",
    "labs/paxos/paxos.py", "labs/paxos/predicates.py",
    "labs/shardedstore/__init__.py", "labs/shardedstore/shardmaster.py",
    "labs/shardedstore/txkvstore.py", "labs/shardedstore/shardstore.py",
    # The lab test driver's closure: the harness, the real-time runner and
    # the trace viewer.
    "harness/__init__.py", "harness/annotations.py", "harness/junit.py",
    "harness/tee.py", "harness/runner.py",
    "runner/__init__.py", "runner/network.py", "runner/run_settings.py",
    "runner/run_state.py",
    "viz/__init__.py", "viz/config.py", "viz/server.py", "viz/debugger.py",
]
# search/trace.py is a copy too, apart from two hunks: cloudpickle is
# imported where a trace is saved or loaded, and loading refuses a trace
# that names a module of the JAX package.  Each hunk: the first and last
# lines of the port's text, and the reference's text it stands for.
TRACE = "search/trace.py"
TRACE_HUNKS = [
    ("# Port deviation 1: cloudpickle is imported where a trace is saved or\n",
     "import pickle\n",
     "import cloudpickle as pickle\n"),
    ("        cloudpickle = SerializableTrace._cloudpickle()\n",
     "                trace = SerializableTrace._Unpickler(f).load()\n",
     """        with open(path, "wb") as f:
            pickle.dump(self, f)
        self.file_name = path
        return path

    @staticmethod
    def load(path: str) -> Optional["SerializableTrace"]:
        try:
            with open(path, "rb") as f:
                trace = pickle.load(f)
"""),
]


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_reference(rel):
    ref = (REPO / "dslabs_tpu" / rel).read_text()
    port = (REPO / "dslabs_tpu_torch" / rel).read_text()
    assert port == ref.replace("dslabs_tpu.", "dslabs_tpu_torch.")


def test_trace_equals_reference_outside_its_two_hunks():
    ref = (REPO / "dslabs_tpu" / TRACE).read_text().replace(
        "dslabs_tpu.", "dslabs_tpu_torch.")
    port = (REPO / "dslabs_tpu_torch" / TRACE).read_text()
    for n, (first, last, ref_text) in enumerate(TRACE_HUNKS, 1):
        start = port.index(first)
        end = port.index(last, start) + len(last)
        assert f"Port deviation {n}" in port[start:end]
        port = port[:start] + ref_text + port[end:]
    assert port == ref


def test_no_other_object_layer_module_is_copied():
    """The port holds the closure above, search/trace.py, and nothing more
    of the object layer (no service/ or analysis/)."""
    port = REPO / "dslabs_tpu_torch"
    have = sorted(str(f.relative_to(port)) for d in
                  ("utils", "core", "testing", "search", "labs", "harness",
                   "runner", "viz")
                  for f in (port / d).rglob("*.py"))
    assert have == sorted(COPIED + [TRACE])


def _object_run(root, build):
    pkg = H.Pkg(root)
    case = build(pkg)
    return case, pkg.mod("search.search").BFS(case.settings).run(case.state)


SHAPES = {name: fn for name, fn in H.LAB02.items()
          if name != "lab1_infinite"}      # time-limited: no fixed count
SHAPES["lab3_depth4"] = H.lab3_depth4
SHAPES["lab4_join_g2"] = lambda pkg: L4.join_case(pkg, 2)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_object_checkers_agree(monkeypatch, name):
    # Derandomized workload streams in both packages (the infinite
    # workload's commands are then a function of address and index).
    for root in ("dslabs_tpu", "dslabs_tpu_torch"):
        monkeypatch.setattr(H.Pkg(root).mod("utils.flags").GlobalSettings,
                            "search_backend", "tensor")
    case, ref = _object_run("dslabs_tpu", SHAPES[name])
    _, port = _object_run("dslabs_tpu_torch", SHAPES[name])
    assert H.end_name(ref) == H.end_name(port)
    assert H.end_name(port) in case.expect
    assert H.terminal_depth(ref) == H.terminal_depth(port)
    assert ref.discovered_count == port.discovered_count
