#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``dslabs_tpu_torch``).

Run from the root of a checkout on a machine with the cards the cell
asks for:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration, traffic and per-layer metrics are found by name under
``benchmark/`` (``harness/manifest.py``).  Set-up, the measured window
and the check are in ``harness/cell.py``.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, then the
card's name and power limit and, last, every number compared with its
limit, which also close standard error.  Without CUDA, with fewer cards
than the cell needs, without the port beside the benchmark, or with JAX
or the JAX package loaded once the window has closed, the run exits
non-zero and prints no result.

Bytecode, kernel builds and compiler caches live at fixed paths inside
the checkout: ``benchmark/.cache/`` and the port's own
``dslabs_tpu_torch/_build/``.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, ".cache")
# Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "dslabs_tpu")


def fixed_caches() -> None:
    """Every cache this process and its children write, at fixed paths in
    the checkout; bytecode too (the card's host sets
    PYTHONDONTWRITEBYTECODE, so each process compiled torch anew)."""
    pyc = os.path.join(CACHE, "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = pyc
    sys.dont_write_bytecode = False
    sys.pycache_prefix = pyc
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["USE_FLAX"] = "0"


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "dslabs_tpu_torch")):
        print("benchmark: the port (dslabs_tpu_torch/) is not beside the "
              "benchmark", file=sys.stderr)
        return 1
    fixed_caches()
    sys.path[:0] = [BENCH, ROOT]
    import torch

    from harness import check as check_mod
    from harness.cell import run_cell
    from harness.manifest import load_cell

    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("benchmark: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=T_START)
    leaked = loaded_forbidden()
    if leaked:
        print(f"benchmark: loaded in this process: {', '.join(leaked)}",
              file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["card"] = card()
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    print(f"card: {result['card']}", file=sys.stderr)
    for line in check_mod.lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
