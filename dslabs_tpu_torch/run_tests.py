"""Lab-test CLI driver of the PyTorch port: the root ``run_tests.py`` with
this package's harness, object layer and tensor backend.

    python -m dslabs_tpu_torch.run_tests --lab 3                 # all lab 3 tests
    python -m dslabs_tpu_torch.run_tests --lab 1 --part 2 -n 3,5 # selection
    python -m dslabs_tpu_torch.run_tests --lab 2 --no-run        # search tests only
    python -m dslabs_tpu_torch.run_tests --replay-traces         # re-check saved traces

It runs the repo's lab test files (``tests/test_lab*.py``) unedited,
loaded as modules of ``dslabs_tpu_torch._labtests``, and prints the same
selection and PASS/points output as the root driver.  Where they differ:

* search tests run on the tensor backend by default, on the card; with no
  card that raises before any test runs.  ``--search-backend object`` (or
  ``DSLABS_SEARCH_BACKEND=object``) asks for the object checker on the
  host;
* ``DSLABS_FORCE_CPU`` is not read: it pins JAX's platform.

``--lint`` runs the port's conformance linter
(``dslabs_tpu_torch.analysis``) over the port's specs, twins and labs
before any test, and returns 1 on an unwaived finding.

Exit code 1 on any failure.
"""

from __future__ import annotations

import argparse
import os
import sys

LAB_TEST_MODULES = [
    "test_lab0_run",
    "test_lab0_search",
    "test_lab1",
    "test_lab2_viewserver",
    "test_lab2_pb",
    "test_lab3_paxos",
    "test_lab4_shardmaster",
    "test_lab4_shardstore",
]


def _discover() -> None:
    """Populate this package's registry by importing the lab test files
    as ``dslabs_tpu_torch._labtests`` modules."""
    import importlib

    for mod in LAB_TEST_MODULES:
        importlib.import_module(f"dslabs_tpu_torch._labtests.{mod}")


def _parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lab", "-l", help="lab to run (0-4)")
    p.add_argument("--part", "-p", type=int, help="part number")
    p.add_argument("--test-num", "-n",
                   help="comma-separated test numbers (e.g. 2,5,7)")
    p.add_argument("--no-run", "--exclude-run-tests", action="store_true",
                   dest="no_run", help="skip run tests")
    p.add_argument("--no-search", "--exclude-search-tests",
                   action="store_true", dest="no_search",
                   help="skip search tests")
    p.add_argument("--exclude-unreliable", action="store_true",
                   help="skip unreliable-network tests")
    p.add_argument("--checks", action="store_true",
                   help="enable conformance checks (determinism, "
                        "idempotence, clone consistency)")
    p.add_argument("--lint", action="store_true",
                   help="run the static protocol conformance linter "
                        "(C1-C6) before the labs; unwaived findings "
                        "fail the run")
    p.add_argument("--no-timeouts", action="store_true",
                   help="disable per-test timeouts")
    p.add_argument("--single-threaded", action="store_true",
                   help="single-threaded run states / searches")
    p.add_argument("-s", "--save-traces", action="store_true",
                   help="save violation traces to traces/")
    p.add_argument("-z", "--start-viz", action="store_true",
                   help="open the trace viewer on search-test failure")
    p.add_argument("-g", "--log-level", default=None, help="log level")
    p.add_argument("--search-backend", choices=("object", "tensor"),
                   default=None,
                   help="search strategy for search tests: the tensor "
                        "engine on the card via protocol twins (default) "
                        "or the object graph checker on the host")
    p.add_argument("--results-file", default=None,
                   help="write JSON results to this file")
    p.add_argument("--replay-traces", action="store_true",
                   help="re-check all saved traces in traces/")
    p.add_argument("--visualize-trace", metavar="TRACE",
                   help="open a saved trace in the trace viewer")
    p.add_argument("--debugger", nargs="*", metavar="ARG",
                   help="render a lab's initial system in the viewer: "
                        "--debugger <numServers> <numClients> <workload> "
                        "(with --lab); VizConfig analog")
    return p.parse_args(argv)


def _apply_flags(args) -> None:
    from dslabs_tpu_torch.utils.flags import GlobalSettings

    if args.checks:
        GlobalSettings.do_checks = True
    if args.no_timeouts:
        GlobalSettings.test_timeouts_disabled = True
    if args.single_threaded:
        GlobalSettings.single_threaded = True
    if args.save_traces:
        GlobalSettings.save_traces = True
    if args.start_viz:
        GlobalSettings.start_viz = True
    if args.log_level:
        import logging

        GlobalSettings.log_level = args.log_level
        logging.basicConfig(level=args.log_level.upper())
    GlobalSettings.search_backend = args.search_backend or os.environ.get(
        "DSLABS_SEARCH_BACKEND", "tensor")


def _replay_traces() -> int:
    """CheckSavedTracesTest analog (junit/CheckSavedTracesTest.java:44-108):
    one check per saved trace, replaying its history under its invariants."""
    from dslabs_tpu_torch.search.replay import replay_trace
    from dslabs_tpu_torch.search.results import EndCondition
    from dslabs_tpu_torch.search.settings import SearchSettings
    from dslabs_tpu_torch.search.trace import SerializableTrace

    traces = SerializableTrace.traces()
    if not traces:
        print("No saved traces found in traces/")
        return 0
    failures = 0
    for t in traces:
        settings = SearchSettings()
        for inv in t.invariants:
            settings.add_invariant(inv)
        results = replay_trace(t.initial_state(), t.history, settings)
        ok = results.end_condition not in (
            EndCondition.INVARIANT_VIOLATED, EndCondition.EXCEPTION_THROWN)
        print(f"{'PASS' if ok else 'FAIL'}  {t!r}")
        if not ok:
            failures += 1
            state = (results.invariant_violating_state
                     or results.exceptional_state)
            if state is not None:
                state.print_trace()
    print(f"\n{len(traces) - failures}/{len(traces)} saved traces pass")
    return 1 if failures else 0


def _debugger(lab, dbg_args) -> int:
    """VizClient.main analog (VizClient.java:39-102): build a lab's
    initial state from CLI args and serve the interactive
    branch-exploring debugger over it (DebuggerWindow.java:89)."""
    from dslabs_tpu_torch.viz import viz_configs
    from dslabs_tpu_torch.viz.debugger import serve_debugger

    configs = viz_configs()
    if lab is None or str(lab) not in configs:
        print(f"No viz config for lab {lab!r}; available: "
              f"{sorted(configs)}")
        return 1
    state = configs[str(lab)](list(dbg_args))
    serve_debugger(state)
    return 0


def _visualize_trace(path: str) -> int:
    """SavedTraceViz analog: render the static HTML step viewer and serve
    the interactive debugger preloaded with the trace's event path."""
    from dslabs_tpu_torch.search.trace import SerializableTrace
    from dslabs_tpu_torch.viz.debugger import serve_debugger
    from dslabs_tpu_torch.viz.server import render_trace_html

    trace = SerializableTrace.load(path)
    if trace is None:
        print(f"Could not load trace {path}")
        return 1
    out_path = path + ".html"
    with open(out_path, "w") as f:
        f.write(render_trace_html(trace))
    print(f"Static trace view: {out_path} ({len(trace.history)} events)")
    serve_debugger(trace.initial_state(), preload_events=trace.history)
    return 0


def main(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    _apply_flags(args)

    if args.lint:
        # The static half of --checks: the conformance linter runs before
        # the labs, and an unwaived finding gates them (a protocol that
        # fails conformance would give untrustworthy verdicts anyway).
        from dslabs_tpu_torch import analysis

        findings = analysis.run_conformance()
        print(analysis.render_findings(findings,
                                       header="conformance lint"))
        if any(not f.waived for f in findings):
            return 1
    if args.replay_traces:
        return _replay_traces()
    if args.visualize_trace:
        return _visualize_trace(args.visualize_trace)
    if args.debugger is not None:
        return _debugger(args.lab, args.debugger)

    from dslabs_tpu_torch.harness import (SEARCH_TESTS, registry, run_tests,
                                          select_tests)
    from dslabs_tpu_torch.utils.flags import GlobalSettings

    _discover()
    nums = None
    if args.test_num:
        nums = [int(x) for x in args.test_num.split(",") if x.strip()]
    selected = select_tests(
        registry(), lab=args.lab, part=args.part, nums=nums,
        exclude_run=args.no_run, exclude_search=args.no_search,
        exclude_unreliable=args.exclude_unreliable)
    if not selected:
        print("No tests matched the selection")
        return 1
    if GlobalSettings.search_backend == "tensor" and any(
            SEARCH_TESTS in e.categories for e in selected):
        # The search tests' device, resolved before the first test: with
        # no card this raises instead of failing every search test.
        from dslabs_tpu_torch.tpu import backend

        backend.resolve_device(None)
    report = run_tests(selected, results_output_file=args.results_file)
    return 0 if report.all_passed else 1


if __name__ == "__main__":
    sys.exit(main())
