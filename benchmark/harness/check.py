"""The comparison that decides ``correct``.

Each search of the window answers with its end condition, depth, unique
and explored counts, and the same counts after every level.  A sample of
the window's distinct roots, drawn from the seed, is searched again by
the plain reference (``reference/bfs.py``) from its own copy of each
root (the same walk of events from the twin's initial state), and every
window search of a sampled root is held against it.  Two numbers are
compared, both exact, so both limits are 0:

* ``unique_gap``: the largest difference in unique states;
* ``level_gap``: the largest difference in explored plus unique states
  at one level; a search whose levels, depth or end condition differ
  from the reference's reads the reference's whole count (explored plus
  unique), so a wrong verdict is a gap too.

A run in which no root could be checked, or the reference had no
answer, is not correct whatever the numbers read.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

LIMITS = {"unique_gap": 0, "level_gap": 0}


@dataclasses.dataclass
class Answer:
    """One search's answer: a port outcome's fields the check reads."""

    end_condition: str
    depth: int
    unique_states: int
    states_explored: int
    levels: list

    @classmethod
    def of(cls, d: dict) -> "Answer":
        return cls(d["end_condition"], d["depth"], d["unique_states"],
                   d["states_explored"], d["levels"])


def _levels(o) -> list:
    return [(lv["depth"], lv["explored"], lv["unique"])
            for lv in (o.levels or [])]


def level_gap(o: Answer, r) -> int:
    """``o``'s gap from the reference's result ``r`` level by level."""
    mine = _levels(o)
    ref = [tuple(x) for x in r.levels]
    if (len(mine) != len(ref) or [x[0] for x in mine] != [x[0] for x in ref]
            or (o.end_condition, o.depth) != (r.end_condition, r.depth)):
        return r.explored + r.unique
    return max([abs(x[1] - y[1]) + abs(x[2] - y[2])
                for x, y in zip(mine, ref)] + [0])


def sample_roots(searched: list, seed: int, k: int) -> list:
    """``k`` of the distinct roots the window searched, by the seed."""
    rng = np.random.Generator(np.random.PCG64([seed, 0x0C4EC4]))
    distinct = sorted(set(searched))
    if len(distinct) <= k:
        return distinct
    return sorted(int(x) for x in rng.choice(distinct, size=k,
                                             replace=False))


def check_window(ref, walks: list, searches: list, seed: int,
                 traffic: dict, errors: list):
    """-> (checks: name -> {value, limit}, roots checked, reference
    seconds).  A root the reference cannot answer goes to ``errors``."""
    from reference.bfs import ReferenceError

    t0 = time.time()
    vals = dict.fromkeys(LIMITS, 0)
    picked = sample_roots([i for i, _o in searches], seed,
                          int(traffic["check"]["roots"]))
    depth = int(traffic["max_depth"])
    checked = 0
    for i in picked:
        try:
            r = ref.search(ref.walk(walks[i]), depth)
        except ReferenceError as e:
            errors.append(f"reference, root {i}: {e}")
            continue
        checked += 1
        for j, o in searches:
            if j == i:
                vals["unique_gap"] = max(vals["unique_gap"],
                                         abs(o.unique_states - r.unique))
                vals["level_gap"] = max(vals["level_gap"], level_gap(o, r))
    if not checked:
        errors.append("no root of the window was checked")
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in vals.items()}
    return checks, checked, time.time() - t0


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def lines(checks: dict) -> list:
    """One plain line per number compared, with its limit."""
    return [f"{k} {c['value']} limit {c['limit']}" for k, c in checks.items()]
