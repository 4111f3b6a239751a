"""The plain reference against the port at a tiny depth on the CPU, from
the initial state and from seeded staged roots, for every configuration;
and the control: the reference with a lossy visited table, put in the
port's place, fails the comparison."""

import pytest

from harness import cell as cell_mod
from harness.control import readings

DEPTH = 3


def _port(cell, walks):
    proto = cell_mod.build_protocol(cell.config)
    ts = cell_mod.build_engine(proto, cell.traffic, "cpu")
    ts.max_depth = DEPTH
    return ts, cell_mod.program_roots(ts, walks)


@pytest.mark.parametrize("name", ["paxos3c2.bfs8", "paxos3c2part.bfs8"])
def test_reference_matches_the_port(tiny_cell, name):
    cell = tiny_cell(name)
    walker = cell_mod.build_reference(cell.config, "cpu")
    walks = [[]] + cell_mod.draw_walks(walker, 2 ** 31 + 77,
                                       cell.traffic)[:3]
    ts, roots = _port(cell, walks)
    ref = cell_mod.build_reference(cell.config, "cpu", block_pairs=512)
    for evs, root in zip(walks, roots):
        o = ts.run(initial=root)
        r = ref.search(ref.walk(evs), DEPTH)
        assert (o.end_condition, o.depth, o.unique_states,
                o.states_explored) == (r.end_condition, r.depth, r.unique,
                                       r.explored), evs
        assert [(lv["depth"], lv["explored"], lv["unique"])
                for lv in o.levels] == [tuple(x) for x in r.levels]


def test_initial_counts_are_the_pinned_ones(tiny_cell):
    """The flagship to depth 4 from its initial state: 713 / 2,457, the
    count the JAX package's tests pin."""
    ref = cell_mod.build_reference(tiny_cell("paxos3c2.bfs8").config, "cpu")
    r = ref.search(ref.initial(), 4)
    assert (r.unique, r.explored) == (713, 2457)


def test_control_fails(tiny_cell):
    cell = tiny_cell("paxos3c2.bfs8")
    r = readings(cell, 2 ** 31 + 5, key_bits=10)
    assert not r["passed"]
    assert r["checks"]["unique_gap"]["value"] > 0


def test_exact_reference_in_the_ports_place_passes(tiny_cell):
    cell = tiny_cell("paxos3c2part.bfs8")
    r = readings(cell, 2 ** 31 + 5, key_bits=None)
    assert r["passed"], r["checks"]
