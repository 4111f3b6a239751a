"""PyTorch port, the conformance linter (``dslabs_tpu_torch/analysis/``,
leg A) against the JAX package's (``dslabs_tpu/analysis/``) on the CPU.

The same fixture sources as ``tests/test_analysis.py`` (its C5 texts are
imported from it, the others are copied verbatim) go through both
packages' ``lint_source``: the findings must be equal in code, object,
line and message.  The port's rule counterparts that differ on purpose
(torch for jax) are separate cases, each named: a draw from torch's
global generator is a C2 finding only in the port (one with an explicit
``generator=`` is none in either), and a public field holding a torch
array is a C3 finding only in the port.  Both linters' ``lint_paths``
over each package's object-level ``labs/`` tree give the same findings
with the path prefix mapped; ``check_spec`` on each pair of spec
factories and both packages' ``lint_specs()`` are clean.  The red
fixture specs (undeclared field, unknown message, malformed symmetry
groups, untouched Slots block and quorum, the dead-letter idiom, the
unhandled declared types), built with each package's compiler, give the
same findings: the port's compiler keeps the dry-run's coverage record
as the reference's does.  Then waivers, the CLI's rc contract and
``run_tests --lint``."""

import json
import textwrap

import pytest
import torch

from dslabs_tpu.analysis import conformance as jconf
from dslabs_tpu_torch import analysis as port_analysis
from dslabs_tpu_torch import run_tests as port_driver
from dslabs_tpu_torch.analysis import conformance as pconf
from dslabs_tpu_torch.analysis.core import (RULES, apply_waivers,
                                            load_waivers)
from tests.test_analysis import _C5_RED, _C5_REP_RED

# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)


def _key(findings, prefix=("", "")):
    return [(f.code, f.obj, f.line, f.message,
             f.path.replace(prefix[0], prefix[1], 1)) for f in findings]


# ------------------------------------------------------ fixture sources

SOURCES = {
    "c1_payload_mutation": """
        class FooNode(Node):
            def handle_Req(self, message, sender):
                message.seq = 1
                message.entries.append(3)
            def on_Tick(self, timer):
                timer.count += 1

        @spec.on("server", "REQ")
        def srv(ctx, m):
            m["i"] = 3
    """,
    "c1_alias_into_send": """
        class FooNode(Node):
            def __init__(self, address):
                self.log = []
                self.acks: Dict[int, int] = {}
            def handle_Req(self, message, sender):
                self.send(Reply(self.log), sender)          # finding
                self.send(Reply(list(self.log)), sender)    # copied: ok
                self.send(Reply(clone(self.acks)), sender)  # cloned: ok
                self.broadcast(Reply(self.acks), sender)    # finding
    """,
    "c2_nondeterminism": """
        import random, time
        class FooNode(Node):
            def __init__(self, address):
                self.peers = set()
            def handle_Req(self, message, sender):
                a = random.randint(0, 3)
                b = time.time()
                c = id(message)
                for p in self.peers:
                    self.send(Reply(1), p)
                for p in sorted(self.peers):   # canonical order: ok
                    pass
    """,
    "c3_hash_hostile_state": """
        import numpy as np
        class FooNode(Node):
            def __init__(self, address):
                self.weights = np.zeros(4)     # finding
                self.pick = lambda x: x        # finding
                self._scratch = np.zeros(4)    # private: excluded
    """,
    "c5_red": _C5_RED,
    "c5_clean_from": _C5_RED.replace("me == 1", 'm["_from"] == me'),
    "c5_clean_outside": _C5_RED.replace('symmetry=("acceptor",)',
                                        "symmetry=()"),
    "c5_direct": _C5_RED.replace(
        "me = ctx.node_index()\n"
        "    ctx.put(\"b\", 1, when=me == 1)        "
        "# member-specific branch",
        "ctx.put(\"b\", 1, when=ctx.node_index() == 2)"),
    "c5_rep_red": _C5_REP_RED,
    "c5_quorum_bitmask": _C5_REP_RED.replace(
        'ctx.put_at("seen", 2, 1)          # fixed member\'s element',
        'ctx.put("bv", ctx.quorum("q").met_bits(5))'),
    "c5_rep_clean_from": _C5_REP_RED.replace(
        'ctx.put_at("seen", 2, 1)', 'ctx.put_at("seen", m["_from"], 1)'),
    "c5_rep_clean_own_bits": _C5_REP_RED.replace(
        'ctx.put_at("seen", 2, 1)',
        'ctx.put("bv", ctx.quorum("q").met_bits(ctx.get("bv")))'),
    "c5_rep_clean_non_group": _C5_REP_RED.replace(
        'ctx.put_at("seen", 2, 1)', 'ctx.put_at("bv", 0, 1)'),
    "c5_rep_clean_asym": _C5_REP_RED.replace('symmetry=("acceptor",),',
                                             ""),
    "c6_fault_lanes": """
        @spec.on("server", "REQ")
        def srv(ctx, m):
            ctx.put("x", ctx.get("pcut"))
            ctx.put("y", 1, when=ctx.get("down_server") == 0)
            k = "$fault"
    """,
    "syntax_error": "def broken(:\n",
}

# The reference's counts on its own fixtures (tests/test_analysis.py),
# held here so that equal-but-empty findings cannot pass.
WANT_CODES = {
    "c1_payload_mutation": ["C1"] * 4,
    "c1_alias_into_send": ["C1"] * 2,
    "c2_nondeterminism": ["C2"] * 4,
    "c3_hash_hostile_state": ["C3"] * 2,
    "c5_red": ["C5"], "c5_direct": ["C5"], "c5_rep_red": ["C5"],
    "c5_quorum_bitmask": ["C5"], "c6_fault_lanes": ["C6"] * 3,
    "syntax_error": ["C4"],
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_fixture_sources_match_reference(name):
    src = textwrap.dedent(SOURCES[name])
    port = pconf.lint_source(src, "fixture.py")
    ref = jconf.lint_source(src, "fixture.py")
    assert _key(port) == _key(ref)
    assert sorted(f.code for f in port) == WANT_CODES.get(name, [])
    assert all(f.leg == "conformance" for f in port)


# The port's rule counterparts, torch for jax: (source, port codes,
# reference codes).
TORCH_FOR_JAX = {
    "c2_torch_global_generator": ("""
        import torch
        class FooNode(Node):
            def handle_Req(self, message, sender):
                a = torch.randint(0, 3, (1,))
                b = torch.rand(2)
    """, ["C2", "C2"], []),
    "c2_torch_explicit_generator_is_keyed": ("""
        import torch
        class FooNode(Node):
            def handle_Req(self, message, sender):
                a = torch.randint(0, 3, (1,), generator=self._gen)
    """, [], []),
    "c3_torch_array_field": ("""
        import torch
        class FooNode(Node):
            def __init__(self, address):
                self.weights = torch.zeros(4)
                self.seen = torch.tensor([1, 2])
                self._scratch = torch.zeros(4)
    """, ["C3", "C3"], []),
    "c3_numpy_and_jax_arrays_both": ("""
        import numpy as np
        import jax.numpy as jnp
        class FooNode(Node):
            def __init__(self, address):
                self.a = np.arange(3)
                self.b = jnp.zeros(2)
    """, ["C3", "C3"], ["C3", "C3"]),
}


@pytest.mark.parametrize("name", sorted(TORCH_FOR_JAX))
def test_torch_for_jax_counterparts(name):
    src, want_port, want_ref = TORCH_FOR_JAX[name]
    src = textwrap.dedent(src)
    port = pconf.lint_source(src, "fixture.py")
    ref = jconf.lint_source(src, "fixture.py")
    assert sorted(f.code for f in port) == want_port
    assert sorted(f.code for f in ref) == want_ref
    if want_port == want_ref:
        assert _key(port) == _key(ref)


def test_lint_paths_labs_trees_match():
    """Both linters over each package's object-level labs/ tree: the
    same findings with the path prefix mapped (both trees lint clean)."""
    port = pconf.lint_paths(["dslabs_tpu_torch/labs"])
    ref = jconf.lint_paths(["dslabs_tpu/labs"])
    assert _key(port, ("dslabs_tpu_torch/", "dslabs_tpu/")) == _key(ref)
    assert port == []


def test_default_lint_paths_name_the_port():
    assert all(p.startswith("dslabs_tpu_torch/")
               for p in pconf.DEFAULT_LINT_PATHS)
    assert [p.replace("dslabs_tpu_torch/", "dslabs_tpu/")
            for p in pconf.DEFAULT_LINT_PATHS] == list(
                jconf.DEFAULT_LINT_PATHS)


# --------------------------------------------------- spec introspection

def _factories():
    import dslabs_tpu_torch.tpu.specs as s
    import dslabs_tpu_torch.tpu.specs_lab3 as l3
    import dslabs_tpu_torch.tpu.specs_lab4 as l4

    out = [("specs", n) for n in s.__all__]
    for tag, m in (("specs_lab3", l3), ("specs_lab4", l4)):
        out += [(tag, n) for n in m.__all__
                if n.startswith("make_") and n.endswith("_spec")]
    return out


@pytest.mark.parametrize("mod,name", _factories())
def test_check_spec_pairs_clean(mod, name):
    import importlib

    port = getattr(importlib.import_module(f"dslabs_tpu_torch.tpu.{mod}"),
                   name)()
    ref = getattr(importlib.import_module(f"dslabs_tpu.tpu.{mod}"), name)()
    pf = pconf.check_spec(port, origin=f"dslabs_tpu_torch/tpu/{mod}.py")
    rf = jconf.check_spec(ref, origin=f"dslabs_tpu/tpu/{mod}.py")
    assert _key(pf, ("dslabs_tpu_torch/", "dslabs_tpu/")) == _key(rf)
    assert pf == []
    # The dry-run's coverage record is the reference's.
    assert port._touched_slots == ref._touched_slots
    assert port._touched_quorums == ref._touched_quorums
    assert port._touched_sends == ref._touched_sends


def test_lint_specs_clean_both_packages():
    assert pconf.lint_specs() == []
    assert jconf.lint_specs() == []


def _red_specs(pkg):
    """The reference's red fixture specs (tests/test_analysis.py), built
    with ``pkg``'s compiler."""
    import importlib

    c = importlib.import_module(f"{pkg}.tpu.compiler")
    Q = importlib.import_module(f"{pkg}.tpu.quorum")
    S = importlib.import_module(f"{pkg}.tpu.slots")
    F, M, N, P, T = (c.Field, c.MessageType, c.NodeKind, c.ProtocolSpec,
                     c.TimerType)
    out = {}

    sp = P("bad", nodes=[N("n", 1, (F("x"),))],
           messages=[M("M", ("i",))], timers=[])

    @sp.on("n", "M")
    def h(ctx, m):
        ctx.put("y", m["i"])
    out["undeclared_field"] = sp

    sp = P("bad2", nodes=[N("n", 1, ())], messages=[M("M", ())],
           timers=[])

    @sp.on("n", "NOPE")
    def h2(ctx, m):
        pass
    out["unknown_message"] = sp

    sp = P("bad3", nodes=[N("n", 1, ())], messages=[M("M", ("i",))],
           timers=[])

    @sp.on("ghost", "M")
    def h3(ctx, m):
        pass
    out["unknown_kind"] = sp

    sp = P("bad4", nodes=[N("n", 1, ())], messages=[M("M", ("i",))],
           timers=[])

    @sp.on("n", "M")
    def h4(ctx, m):
        _ = m["zz"]
    out["unknown_payload"] = sp

    sp = P("bad5", nodes=[N("n", 1, ())], messages=[M("M", ("i",))],
           timers=[T("T", ())])

    @sp.on("n", "M")
    def h5(ctx, m):
        ctx.send("GHOST", 0, i=1)
    out["undeclared_send"] = sp

    out["group_unknown_kind"] = P(
        "s1", nodes=[N("n", 2, ())], messages=[M("M", ())], timers=[],
        symmetry=("ghost",))
    out["group_bad_index_group"] = P(
        "s2", nodes=[N("p", 1, (F("x", size=3, index_group="a"),)),
                     N("a", 2, ())],
        messages=[M("M", ())], timers=[], symmetry=("a",))

    sp = P("soft", nodes=[N("n", 1, ())],
           messages=[M("M", ()), M("DEAD", ())], timers=[T("TICK", ())])

    @sp.on("n", "M")
    def h6(ctx, m):
        pass
    out["unhandled_types"] = sp

    for touch in (False, True):
        sp = P("dead", nodes=[N("n", 3, (
            F("x", hi=3),
            S.Slots("log", 2, base=1, fields=(S.SlotField("cmd", hi=3),))))],
            messages=[M("M", ())], timers=[],
            quorums=(Q.QuorumCount("q", over="n", threshold="majority"),))

        @sp.on("n", "M")
        def h7(ctx, m, touch=touch):
            if touch:
                ctx.slot_put("log", "cmd", 1, 2)
                ctx.put("x", ctx.quorum("q").met_bits(ctx.get("x")))
            else:
                ctx.put("x", 1)
        out[f"slots_quorum_{'touched' if touch else 'untouched'}"] = sp

    sp = P("dl", nodes=[N("n", 2, (F("x"),))],
           messages=[M("M", ()), M("DEBRIS", ())], timers=[])

    @sp.on("n", "M")
    def h8(ctx, m):
        ctx.send("DEBRIS", to=1)
    out["dead_letter"] = sp
    return out


RED_SPECS = sorted(_red_specs("dslabs_tpu_torch"))
CLEAN_SPECS = ("slots_quorum_touched", "dead_letter")


@pytest.mark.parametrize("name", RED_SPECS)
def test_red_fixture_specs_match_reference(name):
    port = pconf.check_spec(_red_specs("dslabs_tpu_torch")[name],
                            origin="fixture")
    ref = jconf.check_spec(_red_specs("dslabs_tpu")[name],
                           origin="fixture")
    assert [(f.code, f.obj, f.message) for f in port] == \
        [(f.code, f.obj, f.message) for f in ref]
    assert (port == []) == (name in CLEAN_SPECS)


# ------------------------------------------------------- waivers + CLI

def test_waiver_file_suppresses_but_reports(tmp_path):
    wf = tmp_path / "waivers"
    wf.write_text("# test waivers\n"
                  "C1 fixture.py::FooNode.* known-shared reply buffer\n"
                  "J3 TensorSearch::device.step a J waiver loads too\n")
    src = textwrap.dedent("""
        class FooNode(Node):
            def handle_Req(self, message, sender):
                message.seq = 1
    """)
    found = apply_waivers(pconf.lint_source(src, "fixture.py"),
                          load_waivers(str(wf)))
    assert len(found) == 1 and found[0].waived
    assert found[0].waiver == "known-shared reply buffer"
    assert [w.code for w in load_waivers(str(wf))] == ["C1", "J3"]


def test_waiver_file_malformed_line_is_loud(tmp_path):
    wf = tmp_path / "waivers"
    wf.write_text("C1 only-two-fields\n")
    with pytest.raises(ValueError, match="waiver needs"):
        load_waivers(str(wf))
    wf.write_text("Q9 x::y reason\n")
    with pytest.raises(ValueError, match="unknown rule code"):
        load_waivers(str(wf))


def test_shared_waiver_file_and_rule_codes():
    """The repo's waiver file loads in the port with no active waiver,
    and the rule codes are the reference's."""
    from dslabs_tpu.analysis.core import RULES as JRULES

    assert load_waivers() == []
    assert sorted(RULES) == sorted(JRULES)


def test_cli_rc_contract(tmp_path, capsys, monkeypatch):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        class FooNode(Node):
            def handle_Req(self, message, sender):
                message.seq = 1
    """))
    rc = port_analysis.main(["conformance", "--paths", str(bad), "--json"])
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 1 and out["findings"] == 1
    assert out["detail"][0]["code"] == "C1"
    wf = tmp_path / "waivers"
    wf.write_text(f"C1 {bad}::* justified for the fixture\n")
    rc = port_analysis.main(["conformance", "--paths", str(bad),
                             "--waivers", str(wf), "--json"])
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 0 and out["findings"] == 0 and out["waived"] == 1
    assert port_analysis.main([]) == 2
    assert port_analysis.main(["lint"]) == 2
    assert port_analysis.main(["conformance", "--waivers"]) == 2
    # The audit leg with no card and no --device raises, as rc 2.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_analysis.main(["jaxpr"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err


def test_conformance_cli_clean_on_shipped_tree(capsys):
    assert port_analysis.main(["conformance"]) == 0
    assert "sanitizer conformance: 0 finding(s)" in capsys.readouterr().out


def test_run_tests_lint_flag(tmp_path, capsys, monkeypatch):
    """``run_tests --lint`` runs the conformance pass before the labs and
    passes on the shipped tree."""
    monkeypatch.chdir(tmp_path)
    assert port_driver.main(["--lint", "--replay-traces"]) == 0
    assert "conformance lint" in capsys.readouterr().out
