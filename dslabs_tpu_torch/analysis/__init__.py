"""The soundness sanitizer of the PyTorch port, the counterpart of
``dslabs_tpu/analysis/``: two legs behind one CLI.

* **Leg A, the conformance linter** (:mod:`.conformance`): AST and
  spec-introspection rules C1-C6 over the port's ``ProtocolSpec``
  handlers, hand twins, adapters and object-level labs.  Pure Python; it
  touches no device.
* **Leg B, the hot-path auditor** (:mod:`.hotpath_audit`): rules J0-J5
  over every dispatch site of the port's engines, enumerated from
  ``tpu/telemetry.py DISPATCH_SITES`` through each engine's
  ``dispatch_site_programs()``.  PyTorch has no lowering to read, so the
  auditor runs each site once under torch's interception modes; it runs
  on the card unless the caller asks for the CPU (``device="cpu"``,
  ``--device cpu``), and raises with no card and no such request.  The
  leg keeps the reference's name ``jaxpr`` in findings and JSON, so the
  ``sanitizer`` counters of ``telemetry.compare_ledger`` read the same.

CLI::

    python -m dslabs_tpu_torch.analysis {conformance,jaxpr,all}
        [--waivers FILE] [--json] [--paths P ...] [--device DEV]

Exit 0 clean (waived findings allowed), 1 on unwaived findings, 2 on a
usage error or a crash.  The waiver file (``.sanitizer-waivers``, format in
:mod:`.core`) is the JAX package's; the port reads it and never writes
it.  ``python -m dslabs_tpu_torch.run_tests --lint`` runs leg A before
the labs.
"""

from __future__ import annotations

import json as _json
import os
import subprocess
import sys
from typing import List, Optional, Sequence

from dslabs_tpu_torch.analysis.core import (Finding, RULES, Waiver,  # noqa: F401
                                            apply_waivers,
                                            default_waiver_path,
                                            load_waivers, render_findings,
                                            repo_root)

__all__ = ["Finding", "Waiver", "RULES", "load_waivers", "apply_waivers",
           "render_findings", "default_waiver_path", "run_conformance",
           "run_jaxpr", "run_all", "sanitizer_summary", "main"]


def run_conformance(paths: Optional[Sequence[str]] = None,
                    waivers: Optional[str] = None) -> List[Finding]:
    """Leg A over the shipped tree (or ``paths``): the AST lint, plus the
    C4 spec introspection of every spec factory when no paths are
    given."""
    from dslabs_tpu_torch.analysis import conformance as conf

    findings = conf.lint_paths(paths)
    if paths is None:
        findings += conf.lint_specs()
    return apply_waivers(findings, load_waivers(waivers))


def run_jaxpr(waivers: Optional[str] = None, deep: bool = True,
              device=None, report: Optional[dict] = None) -> List[Finding]:
    """Leg B over the standard audit set (``build_audit_engines``), the
    J5 rebuild check included, on the card unless ``device`` names
    another.  ``report`` (a dict) receives each engine's per-site record
    under ``"<i>:<EngineClass>"``, ``i`` the engine's place in the set."""
    from dslabs_tpu_torch.analysis.hotpath_audit import (audit_search,
                                                         build_audit_engines)

    findings: List[Finding] = []
    for i, search in enumerate(build_audit_engines(device)):
        rep = {} if report is not None else None
        findings += audit_search(search, deep=deep, report=rep)
        if report is not None:
            report[f"{i}:{type(search).__name__}"] = rep
    return apply_waivers(findings, load_waivers(waivers))


def run_all(paths: Optional[Sequence[str]] = None,
            waivers: Optional[str] = None, device=None) -> List[Finding]:
    return (run_conformance(paths, waivers=waivers)
            + run_jaxpr(waivers=waivers, device=device))


def sanitizer_summary(timeout: int = 180) -> dict:
    """The bench's ``sanitizer`` block: live findings per leg and the
    waived count, from the CLI in a child process (``OMP_NUM_THREADS=1``),
    so the caller's process never runs the audit.  The audit runs on the
    card, the CLI's default; with no card the child exits 2 and the block
    is an error.  Never raises; a failure comes back as
    ``{"error": ...}``.  It has no caller until ``bench.py`` is
    ported."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "dslabs_tpu_torch.analysis", "all",
             "--json"],
            capture_output=True, text=True, timeout=timeout,
            cwd=repo_root(), env=env)
        if not proc.stdout.strip():
            return {"error": f"rc {proc.returncode}: "
                             f"{proc.stderr.strip()[-400:]}"}
        data = _json.loads(proc.stdout.strip().splitlines()[-1])
        return {"conformance": data["conformance"],
                "jaxpr": data["jaxpr"], "waived": data["waived"],
                "findings": data["findings"]}
    except Exception as e:  # noqa: BLE001 - the caller's JSON must land
        return {"error": f"{type(e).__name__}: {e}"}


# ------------------------------------------------------------------ CLI

_USAGE = """usage: python -m dslabs_tpu_torch.analysis <command> [options]

  conformance   Leg A: protocol conformance linter (C1-C6)
  jaxpr         Leg B: hot-path auditor (J0-J5), each dispatch site run
                once under torch's interception modes
  all           both legs

options:
  --waivers FILE   waiver file (default: <repo>/.sanitizer-waivers)
  --paths P [P..]  conformance: lint these files/dirs instead of the
                   shipped default set
  --device DEV     jaxpr: where the audit runs (default cuda; cpu on a
                   machine with no card)
  --json           one machine-readable JSON line instead of the report

exit code: 0 clean (waived findings allowed), 1 unwaived findings,
2 usage or crash (no card for the audit, a malformed waiver file).
Rule catalog and waiver format: dslabs_tpu_torch/analysis/core.py.
"""


def _option(flags: List[str], name: str) -> Optional[str]:
    if name not in flags:
        return None
    i = flags.index(name) + 1
    if i >= len(flags) or flags[i].startswith("--"):
        raise ValueError(f"{name} needs a value")
    return flags[i]


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("conformance", "jaxpr", "all"):
        print(_USAGE, file=sys.stderr)
        return 2
    cmd, flags = argv[0], argv[1:]
    try:
        waivers = _option(flags, "--waivers")
        device = _option(flags, "--device") or "cuda"
    except ValueError as e:
        print(f"{e}\n\n{_USAGE}", file=sys.stderr)
        return 2
    paths: Optional[List[str]] = None
    if "--paths" in flags:
        i = flags.index("--paths") + 1
        paths = []
        while i < len(flags) and not flags[i].startswith("--"):
            paths.append(flags[i])
            i += 1
    as_json = "--json" in flags

    findings: List[Finding] = []
    try:
        if cmd in ("conformance", "all"):
            findings += run_conformance(paths, waivers=waivers)
        if cmd in ("jaxpr", "all"):
            findings += run_jaxpr(waivers=waivers, device=device)
    except Exception as e:  # noqa: BLE001 - a crash is rc 2, not 1
        print(f"analysis {cmd}: {type(e).__name__}: {e}", file=sys.stderr)
        return 2

    live = [f for f in findings if not f.waived]
    if as_json:
        print(_json.dumps({
            "cmd": cmd,
            "findings": len(live),
            "waived": sum(1 for f in findings if f.waived),
            "conformance": sum(1 for f in live
                               if f.leg == "conformance"),
            "jaxpr": sum(1 for f in live if f.leg == "jaxpr"),
            "detail": [f.as_dict() for f in findings],
        }))
    else:
        print(render_findings(findings, header=f"sanitizer {cmd}"))
    return 1 if live else 0
