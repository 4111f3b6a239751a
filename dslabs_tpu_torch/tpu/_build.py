"""Build and load the hand-written CUDA kernels of ``dslabs_tpu_torch/csrc``.

Each ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` (Hopper), and the objects are linked into
one shared library with a plain C interface.  The library is loaded with
``ctypes``: pointers and the CUDA stream travel as ``c_void_p``, and every
C entry returns ``cudaGetLastError()`` so that a refused launch raises in
the wrapper instead of passing unnoticed.

The build happens at first use, into ``dslabs_tpu_torch/_build/`` (listed
in ``.gitignore``), keyed by a digest of the sources and flags: a checkout
that holds only the committed files builds itself.  PyTorch's own
extension builder is not used because a source that includes PyTorch's
headers takes minutes to compile.

:func:`resolve_device` is the one place where the port's entry points pick
their device: the card unless the caller names another.
:func:`plain_version` marks the kernels' plain PyTorch versions while they
run, so that the hot-path audit (``analysis/hotpath_audit.py``) leaves
their ops out on the CPU, as it cannot see the kernels on the card.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LIB: Optional[ctypes.CDLL] = None
# Seconds the last build took (None = loaded from an earlier build) and
# the compiler's per-kernel resource report (registers, shared memory).
BUILD_SECS: Optional[float] = None
BUILD_LOG: str = ""

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# C entry points and their argument types (return type is always int).
SIGNATURES = {
    "dsl_fingerprint_rows": [_P, _P, _LL, _I, _P],
    "dsl_visited_insert_coop": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _LL, _LL, _LL, _LL, _I, _P],
}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of dslabs_tpu_torch are built from source")
    return found


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return h.hexdigest()[:16]


def lib_path() -> str:
    return os.path.join(BUILD_DIR, f"libdslabs_kernels_{_digest()}.so")


def build(force: bool = False) -> str:
    """Compile ``csrc/*.cu`` (one ``nvcc`` each, in parallel) and link the
    shared library; returns its path.  Raises with the compiler output if
    any step fails.  Processes that build at once (the ranks of one card)
    take turns on a file lock in the build directory; a process that
    waited finds the library built."""
    out = lib_path()
    if os.path.exists(out) and not force:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out) and not force:
            return out
        return _build_locked(out)


def _build_locked(out: str) -> str:
    global BUILD_SECS, BUILD_LOG
    t0 = time.time()
    cc = nvcc()
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    procs = []
    for src in sources():
        obj = os.path.join(tmp, os.path.basename(src) + ".o")
        cmd = [cc] + NVCC_FLAGS + ["-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for src, obj, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {os.path.basename(src)}\n{text}")
        if proc.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(failed) + "\n"
                           + "\n".join(log))
    tmp_so = os.path.join(tmp, "lib.so")
    link = subprocess.run(
        [cc, "-shared", "-o", tmp_so] + [obj for _, obj, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed\n" + link.stdout)
    os.replace(tmp_so, out)
    shutil.rmtree(tmp, ignore_errors=True)
    BUILD_SECS = time.time() - t0
    BUILD_LOG = "\n".join(log)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another.  No CUDA and no explicit device is an error, never a
    quiet move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path")
    return dev


# Plain-version calls running on each thread (see plain_version).
_PLAIN = threading.local()


def plain_version(fn):
    """Mark ``fn`` as a kernel's plain PyTorch version: while it runs,
    :func:`in_plain_version` is true on its thread.  What ``fn`` computes
    does not change."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        _PLAIN.depth = getattr(_PLAIN, "depth", 0) + 1
        try:
            return fn(*args, **kwargs)
        finally:
            _PLAIN.depth -= 1

    return wrapped


def in_plain_version() -> bool:
    """True inside a kernel's plain version on this thread."""
    return getattr(_PLAIN, "depth", 0) > 0
