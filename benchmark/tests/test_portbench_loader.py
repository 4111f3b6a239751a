"""A configuration, a traffic mix and a per-layer metric are added as new
files and manifest entries only, and the harness's loader finds them."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT
from harness.manifest import load_cell, read_metrics

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "trace_record.json")


def test_addition_needs_new_files_only(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs" / "paxos3c2.json").read_text())
    cfg["name"] = "dummy"
    (bench / "configs" / "dummy.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "bfs8.json").read_text())
    mix["max_depth"] = 2
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (bench / "metrics" / "dummy_states.py").write_text(
        "def read(rec):\n    return rec['unique']\n")
    man["configs"].append({"name": "dummy", "source": "https://example.org",
                           "file": "benchmark/configs/dummy.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "dummy.dummy_mix", "config": "dummy",
                             "traffic": "dummy_mix", "chips": 1,
                             "why": "a test"})
    man["per_layer"].append({"name": "dummy_states", "unit": "states",
                             "better": "higher",
                             "source": "program_counter", "layer": "test",
                             "moves": "unique_per_s",
                             "workloads": ["dummy.dummy_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    cell = load_cell("dummy.dummy_mix", str(tmp_path))
    assert cell.config["name"] == "dummy"
    assert cell.traffic["max_depth"] == 2
    names = [m.name for m in cell.per_layer]
    assert names == ["dummy_states"]
    with open(FIXTURE) as f:
        rec = json.load(f)
    assert read_metrics(cell.per_layer, rec) == {
        "dummy_states": {"value": 1400000, "unit": "states"}}
    # The shipped cells are unchanged by the addition.
    assert load_cell("paxos3c2.bfs8", str(tmp_path)).traffic["max_depth"] \
        == load_cell("paxos3c2.bfs8", ROOT).traffic["max_depth"]


def _cli(cwd, *args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "paxos3c2.bfs8",
         "--seed", str(2 ** 31 + 9), "--seconds", "1", *args],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, timeout=300)


def test_cli_needs_the_card():
    """Without CUDA the run exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines "
                    "without one")
    r = _cli(ROOT)
    assert r.returncode != 0 and r.stdout == ""


def test_cli_needs_the_port(tmp_path):
    """A directory with only BENCHMARK.json and benchmark/ gives no
    result."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    r = _cli(str(tmp_path))
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.cuda
def test_cli_on_the_card():
    """One short run of the first cell on the card: a correct result."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    r = _cli(ROOT, "--trace", "0")
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
