"""The manifest keeps the benchmark contract's names, units and limits,
and nothing under ``benchmark/`` loads JAX or the JAX package."""

import ast
import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "dslabs_tpu"}


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_counts(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["benchmark"]
    assert 1 <= man["run_seconds"] <= 51
    assert 1 <= len(man["configs"]) <= 24
    assert 1 <= len(man["workloads"]) <= 24
    assert 1 <= len(man["end_to_end"]) <= 16
    assert 1 <= len(man["per_layer"]) <= 128
    fours = sum(w["chips"] == 4 for w in man["workloads"])
    assert fours <= max(1, len(man["workloads"]) // 4)
    assert len(json.dumps(man)) <= 64 * 1024


def test_names_and_units(man):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in man[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
    assert len(names) == len(set(names))
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in man["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200


def test_metrics_and_bounds(man):
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in man["workloads"]}
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in man["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if m["name"].endswith("_roofline_pct"):
            assert m["unit"] == "%"


def test_cells_find_their_files(man):
    cfgs = {c["name"]: c for c in man["configs"]}
    for w in man["workloads"]:
        c = cfgs[w["config"]]
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
    assert {w["config"] for w in man["workloads"]} == set(cfgs)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for dirpath, _dirs, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_anywhere():
    for path in _sources():
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        names = set(_imports(path))
        assert "dslabs_tpu_torch" not in names, path
        assert not names & FORBIDDEN, path
    for f in os.listdir(os.path.join(BENCH, "configs")):
        with open(os.path.join(BENCH, "configs", f)) as fh:
            cfg = json.load(fh)
        twin = cfg["reference"]["twin"].split(":")[0].split(".")[0]
        assert twin == "reference", cfg["name"]
        prog = cfg["program"]["factory"].split(":")[0].split(".")[0]
        assert prog == "dslabs_tpu_torch", cfg["name"]
