"""The comparison's arithmetic on hand-made answers: each number reads 0
on the reference's own answer and separates every kind of wrong one."""

import dataclasses

import pytest

from harness import check as check_mod


@dataclasses.dataclass
class Ref:
    end_condition: str = "DEPTH_EXHAUSTED"
    depth: int = 2
    unique: int = 7
    explored: int = 12
    levels: tuple = ((1, 3, 4), (2, 9, 7))


def _answer(**kw):
    r = Ref()
    d = dict(end_condition=r.end_condition, depth=r.depth,
             unique_states=r.unique, states_explored=r.explored,
             levels=[{"depth": a, "explored": b, "unique": c}
                     for a, b, c in r.levels])
    d.update(kw)
    return check_mod.Answer(**d)


def test_the_references_answer_reads_zero():
    assert check_mod.level_gap(_answer(), Ref()) == 0


@pytest.mark.parametrize("kw,gap", [
    ({"levels": [{"depth": 1, "explored": 3, "unique": 4},
                 {"depth": 2, "explored": 8, "unique": 5}]}, 3),
    ({"levels": [{"depth": 1, "explored": 3, "unique": 4}]}, 19),
    ({"end_condition": "INVARIANT_VIOLATED"}, 19),
    ({"depth": 1}, 19),
], ids=["counts", "a_level_missing", "verdict", "depth"])
def test_level_gap_separates(kw, gap):
    assert check_mod.level_gap(_answer(**kw), Ref()) == gap


def test_passed_and_lines():
    ok = {k: {"value": 0, "limit": v} for k, v in check_mod.LIMITS.items()}
    assert check_mod.passed(ok)
    bad = dict(ok, unique_gap={"value": 1, "limit": 0})
    assert not check_mod.passed(bad)
    assert check_mod.lines(bad) == ["unique_gap 1 limit 0",
                                    "level_gap 0 limit 0"]
