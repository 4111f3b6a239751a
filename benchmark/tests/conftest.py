"""The benchmark's own tests: run from the checkout's root with
``python -m pytest benchmark/tests``.  They import the harness as the
benchmark does (``benchmark/`` first on the path) and drive whole runs on
the CPU at a tiny size."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

# A cell's traffic cut to what the CPU runs in seconds: the searches,
# the check and the roots' walks are the cell's own code paths.
TINY = dict(chunk_per_device=64, frontier_cap=1 << 12, visited_cap=1 << 15,
            max_depth=3, warmup_depth=1,
            check={"roots": 2, "block_pairs": 4096})


@pytest.fixture
def tiny_cell():
    from harness.manifest import load_cell

    def make(name):
        cell = load_cell(name, ROOT)
        cell.traffic.update(TINY)
        return cell

    return make
