"""Kernel 2 (``tpu/visited.py`` + ``csrc/visited.cu``): the least HBM
traffic of deduplicating the traced search's valid successors and its
root and inserting its unique states (``harness/peaks.py``), at
3.35 TB/s, over the kernel's profiled time."""

import re

from harness import peaks

KERNEL = re.compile(r"\binsert_coop_kernel\b")


def read(rec):
    secs = sum(k["seconds"] for n, k in rec["device"]["kernels"].items()
               if KERNEL.search(n))
    least = peaks.visited_least_s(rec["explored"] + 1, rec["unique"])
    return peaks.roofline_pct(least, secs)
