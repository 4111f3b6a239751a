"""Kernel 1 (``tpu/kernels.py`` + ``csrc/fingerprint.cu``): the least time
the card needs to hash the traced search's valid successors and its
root twice (``harness/peaks.py``) over the kernel's profiled time."""

import re

from harness import peaks

KERNEL = re.compile(r"\bfingerprint_rows_kernel\b")


def read(rec):
    if not rec.get("sm_count"):
        return None
    secs = sum(k["seconds"] for n, k in rec["device"]["kernels"].items()
               if KERNEL.search(n))
    least = peaks.fingerprint_least_s(rec["explored"] + 2, rec["lanes"],
                                      rec["sm_count"])
    return peaks.roofline_pct(least, secs)
