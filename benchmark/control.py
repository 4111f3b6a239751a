#!/usr/bin/env python3
"""Run the control of a cell's comparison on the card (see
``harness/control.py``): for each seed, the roots a run with that seed
checks, searched by the reference with ``--key-bits``-bit keys in the
port's place and by the exact reference, and the comparison's numbers.
One JSON line per seed.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--key-bits 32] [--device cuda]
"""

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--key-bits", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH, ROOT]
    from harness.control import readings
    from harness.manifest import load_cell

    cell = load_cell(args.workload, ROOT)
    for s in args.seeds.split(","):
        for bits in (args.key_bits, None):
            r = readings(cell, int(s), bits, args.device)
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
