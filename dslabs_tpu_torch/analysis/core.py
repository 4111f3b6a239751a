"""Shared sanitizer plumbing: the finding record, the rule catalog and
the waiver file, the counterpart of ``dslabs_tpu/analysis/core.py``.

A finding is one rule violation at one location.  Conformance findings
(C1-C6) locate as ``<repo-relative-path>::<qualname>``; hot-path audit
findings (J0-J5) as ``<engine-class>::<dispatch-tag>``.  Either way
``Finding.target`` is the string waiver patterns match against.

Waiver file (default ``<repo root>/.sanitizer-waivers``, the file the
JAX package reads too; the port reads it and never writes it), one
waiver per line::

    # comment
    <CODE> <target-glob> <one-line justification>

``<CODE>`` is a rule code or ``*``; ``<target-glob>`` is an ``fnmatch``
pattern over ``Finding.target``.  A waived finding still prints (marked
``waived``) but does not fail the CLI.  The rule codes are the JAX
package's, so one waiver file serves both packages; the J texts say
what each rule checks in the port.  There is no environment default for
the waiver path (the reference's ``DSLABS_SANITIZE_WAIVERS``): a
``waivers=`` argument or ``--waivers FILE`` names another file.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import os
from typing import List, Optional, Sequence

__all__ = ["Finding", "Waiver", "RULES", "load_waivers", "apply_waivers",
           "render_findings", "default_waiver_path", "repo_root"]

RULES = {
    "C1": "handler purity: mutation of a received message/timer "
          "payload, or aliasing mutable node state into a send",
    "C2": "nondeterminism: random/time/id()/unordered set iteration "
          "inside a handler (breaks replay, minimization, and "
          "fingerprint determinism)",
    "C3": "dedup soundness: public node-state field that defeats "
          "structural freeze/hash (utils.structural.sfreeze)",
    "C4": "spec hygiene: declared message/timer with no handler, "
          "put/get of undeclared fields, handler for unknown "
          "kind/message",
    "C5": "symmetry hygiene: a handler on a kind inside a declared "
          "symmetry group branches on the raw node id (node_index() "
          "compared against a constant) — breaks member "
          "interchangeability, so the canonicalize pass would merge "
          "states with DIFFERENT behavior",
    "C6": "fault-model opacity: a handler reads or branches on fault "
          "controller internals (the '$fault' kind or its "
          "pcut/eras/crashes/drops/dups/down_* lanes) — protocols "
          "must observe faults only through message loss and timer "
          "silence, or the scenario stops modeling a real network",
    "J0": "site-registry coverage: dispatch site missing from "
          "telemetry.DISPATCH_SITES, or its function raised when the "
          "audit ran it",
    "J1": "host sync: more host syncs in one call of a dispatch site "
          "than its syncs budget (readbacks, .item()/int()/bool(), "
          "nonzero, tolist, data-dependent-shape ops, host-to-device "
          "uploads)",
    "J2": "float64 or complex128 tensor among a dispatch site's op "
          "outputs",
    "J3": "in-place audit: a site declared in_place whose carry "
          "tensors of >= 64 KiB changed storage over the call",
    "J4": "unexpected collective: a c10d / _c10d_functional op in a "
          "site not declared multi",
    "J5": "retrace hazard: rebuilding the site's function gives a "
          "different op trace or different outputs on the same inputs "
          "(the hazard a CUDA-graph capture inherits)",
}


@dataclasses.dataclass
class Finding:
    code: str                  # rule code, RULES key
    leg: str                   # "conformance" | "jaxpr"
    path: str                  # repo-relative file, or engine class
    obj: str                   # qualname, or dispatch tag
    message: str
    line: int = 0
    waived: bool = False
    waiver: str = ""           # justification of the matching waiver

    @property
    def target(self) -> str:
        return f"{self.path}::{self.obj}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        w = f"  (waived: {self.waiver})" if self.waived else ""
        return f"[{self.code}] {loc} {self.obj}: {self.message}{w}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Waiver:
    code: str                  # rule code or "*"
    pattern: str               # fnmatch glob over Finding.target
    reason: str

    def matches(self, f: Finding) -> bool:
        return (self.code in ("*", f.code)
                and fnmatch.fnmatch(f.target, self.pattern))


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def default_waiver_path() -> str:
    return os.path.join(repo_root(), ".sanitizer-waivers")


def load_waivers(path: Optional[str] = None) -> List[Waiver]:
    """Parse the waiver file; a missing file is an empty waiver set, a
    malformed line is a loud ValueError (a silently dropped waiver would
    flip the CLI red with no hint why)."""
    path = path or default_waiver_path()
    out: List[Waiver] = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for n, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(None, 2)
            if len(parts) < 3:
                raise ValueError(
                    f"{path}:{n}: waiver needs '<CODE> <target-glob> "
                    f"<justification>', got {line!r}")
            code, pattern, reason = parts
            if code != "*" and code not in RULES:
                raise ValueError(
                    f"{path}:{n}: unknown rule code {code!r} "
                    f"(known: {sorted(RULES)})")
            out.append(Waiver(code, pattern, reason))
    return out


def apply_waivers(findings: Sequence[Finding],
                  waivers: Sequence[Waiver]) -> List[Finding]:
    for f in findings:
        for w in waivers:
            if w.matches(f):
                f.waived = True
                f.waiver = w.reason
                break
    return list(findings)


def render_findings(findings: Sequence[Finding],
                    header: str = "sanitizer") -> str:
    live = [f for f in findings if not f.waived]
    waived = [f for f in findings if f.waived]
    out = [f"== {header}: {len(live)} finding(s)"
           + (f", {len(waived)} waived" if waived else "") + " =="]
    for f in findings:
        out.append(f.render())
    if not findings:
        out.append("clean: no findings")
    return "\n".join(out)
