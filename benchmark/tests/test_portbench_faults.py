"""Whole runs on the CPU at a tiny size with the timed path broken
underneath: each fault a one-chip cell can have turns ``correct`` false.
(The exchange between chips cannot be left out on one shard, whose
exchange is the identity; a four-chip cell would add that fault.)"""

import pytest

from dslabs_tpu_torch.tpu import kernels
from dslabs_tpu_torch.tpu.sharded import ShardedTensorSearch
from harness.cell import run_cell

SEED = 2 ** 31 + 4242
ORIG_EXPAND = ShardedTensorSearch._expand_chunk
ORIG_RUN = ShardedTensorSearch.run


def _unchanged(self, chunk_rows, chunk_valid, *a, **k):
    """Every successor is its parent: the step returns its state."""
    out = list(ORIG_EXPAND(self, chunk_rows, chunk_valid, *a, **k))
    b = out[0].shape[0] // chunk_rows.shape[0]
    out[0] = chunk_rows.repeat_interleave(b, 0)
    out[2] = kernels.fingerprint_rows(out[0])
    return tuple(out)


def _half(self, chunk_rows, chunk_valid, *a, **k):
    """Half of each chunk's successors (every other row) is left out."""
    out = list(ORIG_EXPAND(self, chunk_rows, chunk_valid, *a, **k))
    out[1] = out[1].clone()
    out[1][1::2] = False
    out[3] = out[3] & out[1]
    return tuple(out)


def _altered(self, *a, **k):
    """The answer is altered where it is produced."""
    o = ORIG_RUN(self, *a, **k)
    o.unique_states += 1
    return o


def test_sound_run_is_correct(tiny_cell):
    r = run_cell(tiny_cell("paxos3c2.bfs8"), SEED, 2.0, False,
                 device="cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"unique_per_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("attr,fault", [("_expand_chunk", _unchanged),
                                        ("_expand_chunk", _half),
                                        ("run", _altered)],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
def test_fault_turns_correct_false(tiny_cell, monkeypatch, attr, fault):
    cell = tiny_cell("paxos3c2part.bfs8")
    monkeypatch.setattr(ShardedTensorSearch, attr, fault)
    r = run_cell(cell, SEED, 2.0, False, device="cpu")
    assert not r["correct"], r["checks"]
