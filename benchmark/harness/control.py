"""The control of the comparison that decides ``correct``: the plain
reference put in the port's place with a lossy visited table (``key_bits``
of its first hash, trusted: shorter keys, the step that would tempt a
later change) must fail the comparison that the port passes.  The
benchmark's own runs never run it; ``benchmark/control.py`` runs it on
the card at a cell's own size, and the tests at a tiny one."""

from __future__ import annotations

import time

from harness import cell as cell_mod
from harness import check as check_mod


def readings(cell, seed: int, key_bits, device="cpu") -> dict:
    """The check's numbers for seed ``seed``'s sampled roots, with the
    reference at ``key_bits``-bit keys (None: exact) in the port's
    place."""
    tr = cell.traffic
    walks = cell_mod.draw_walks(cell_mod.build_reference(cell.config,
                                                         "cpu"), seed, tr)
    picked = check_mod.sample_roots(list(range(len(walks))), seed,
                                    int(tr["check"]["roots"]))
    bp = tr["check"]["block_pairs"]
    lossy = cell_mod.build_reference(cell.config, device,
                                     key_bits=key_bits, block_pairs=bp)
    t0 = time.time()
    searches = []
    for i in picked:
        r = lossy.search(lossy.walk(walks[i]), tr["max_depth"])
        levels = [{"depth": d, "explored": e, "unique": u}
                  for d, e, u in r.levels]
        searches.append((i, check_mod.Answer(r.end_condition, r.depth,
                                             r.unique, r.explored,
                                             levels)))
    del lossy
    control_s = time.time() - t0
    ref = cell_mod.build_reference(cell.config, device, block_pairs=bp)
    errors: list = []
    checks, _checked, ref_s = check_mod.check_window(ref, walks, searches,
                                                     seed, tr, errors)
    return {"seed": seed, "key_bits": key_bits, "roots": picked,
            "unique": [a.unique_states for _i, a in searches],
            "control_s": control_s, "reference_s": ref_s,
            "passed": check_mod.passed(checks) and not errors,
            "checks": checks}
