"""The ``ranks`` engine (one process per card, the window inside the
ranks) driven whole on the CPU over four gloo ranks at a tiny size:
correct as it stands, and not correct with the exchange between the
ranks left out."""

import os

import pytest

from conftest import BENCH, ROOT, TINY
from harness.cell import run_cell
from harness.manifest import load_cell, load_manifest

SEED = 2 ** 31 + 515


@pytest.fixture
def rank_cell():
    man = load_manifest(ROOT)
    names = {w["name"] for w in man["workloads"]}
    if "paxos3c2.bfs8.nccl4" not in names:
        man["workloads"].append({"name": "paxos3c2.bfs8.nccl4",
                                 "config": "paxos3c2",
                                 "traffic": "bfs8.nccl4", "chips": 4,
                                 "why": "the four-rank traffic"})
    cell = load_cell("paxos3c2.bfs8.nccl4", ROOT, manifest=man)
    cell.traffic.update(TINY, chunk_per_device=16)
    return cell


def test_four_gloo_ranks_are_correct(rank_cell):
    r = run_cell(rank_cell, SEED, 1.0, False, device="cpu")
    assert r["correct"], r["checks"]
    assert r["device"]["count"] == 4
    assert r["run"]["roots_checked"] >= 1


def test_exchange_left_out_is_not_correct(rank_cell, monkeypatch):
    tests = os.path.join(BENCH, "tests")
    monkeypatch.setenv("PYTHONPATH", tests)
    rank_cell.traffic["rank_prepare"] = "rank_faults:exchange_left_out"
    r = run_cell(rank_cell, SEED, 1.0, False, device="cpu")
    assert not r["correct"], r["checks"]
