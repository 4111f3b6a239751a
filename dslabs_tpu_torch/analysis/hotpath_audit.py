"""Leg B of the soundness sanitizer: the hot-path auditor, the
counterpart of ``dslabs_tpu/analysis/jaxpr_audit.py``.

The reference audits the lowered StableHLO of each dispatch-site
program.  Eager PyTorch has no lowering to read, so this module RUNS each
site once, on a clone of its arguments, under PyTorch's own interception
modes: a ``TorchFunctionMode`` sees the Python-level calls that move data
between the host and the device (``.cpu()``, ``.item()``, ``int()``,
``bool()``, ``.tolist()``, ``torch.as_tensor(..., device=)``,
``.to(device)`` of a host tensor, ``nonzero`` and the other ops whose
output shape depends on the data), and a ``TorchDispatchMode`` sees every
aten op with its outputs.  The sites come from each engine's
``dispatch_site_programs()``, keyed by the tags of
``tpu/telemetry.py DISPATCH_SITES``, which holds each site's contract
(``in_place``, ``multi``, ``syncs``); an entry is ``dict(fn, args,
builder)``, with a contract key only where the engine's configuration
sets it, or a list of such dicts (with a ``name``) for a tag the loop
dispatches with several functions.

Rules (the reference's codes; the catalog is ``core.RULES``):

J0  registry coverage: an enumerated site missing from
    ``DISPATCH_SITES``, or a site function that raised when the audit
    ran it.
J1  host syncs: more host syncs in one call than the site's ``syncs``
    budget (the entry's, else the registry's); each sync is listed with
    its op and the Python line that issued it.  A host sync is a
    readback (``.cpu()``, ``.numpy()``, ``.item()``, ``int()``,
    ``bool()``, ``float()``, ``.tolist()``, ``np.asarray``), an op
    whose output shape depends on the data (``nonzero``, a boolean-mask
    index, ``masked_select``, ``unique``, ``repeat_interleave`` by a
    tensor), or an upload of host data to the device (a host tensor's
    ``.to(device)``, ``torch.as_tensor(data, device=)``); an empty
    transfer is none.  These are the calls that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports on the card; the
    table :mod:`.sync_cases` holds each rule, on the CPU and on the
    card.
J2  a ``float64`` or ``complex128`` tensor among the site's op outputs
    (int64 is allowed: the plain hash arithmetic is int64 masked to 32
    bits).
J3  a site declared ``in_place`` whose argument tensors of >= 64 KiB
    (``DONATE_MIN``) hold another set of storages after the call than
    before (a swap of ``cur`` / ``nxt`` keeps the set): the carry
    reallocated.
J4  an op of the ``c10d`` / ``_c10d_functional`` namespaces in a site
    not declared ``multi``.
J5  retrace hazard (deep check only): the function rebuilt by the
    entry's ``builder``, run on a fresh clone of the arguments, gives
    another op trace (op names, output shapes and dtypes, in order) or
    other return values.  A CUDA-graph capture of the site would
    inherit the difference.

Each site runs once uncounted first, so that constants a site builds on
its first call and caches (the compiled steps' constants, the packing
and symmetry tables) stay out of the count: the count is a steady-state
call's.  Host and device: on the card a tensor's device says where it
lives.  On the CPU every tensor lives on the host, so the audit tracks
which tensors stand for host memory on the card: those made from host
data without a ``device`` (``torch.from_numpy``, ``torch.tensor(x)``),
the results of readbacks, and ops whose tensor inputs are all such; every
other tensor stands for device memory.  A ``.to()`` of a device tensor
is a readback only when its target is the string ``"cpu"``.

The kernels are ``ctypes`` calls that neither mode sees on the card.  On
the CPU their plain versions stand in for them and do sync (the insert's
probe rounds read their counts); the audit leaves out everything that
runs inside a plain version (``_build.plain_version``), so the CPU count
predicts the card's.

The run-time hook is ``TensorSearch(sanitize="on" | "full")`` (and the
same argument of ``SwarmSearch``): when the engine's first run starts,
:func:`sanitize_engine` audits its sites ("full" adds J5), records
each finding as a ``sanitizer_finding`` event on an attached recorder,
warns once, and never raises.  ``sanitize=None`` (the default) imports
nothing of this package.  The reference's ``DSLABS_SANITIZE`` and
``DSLABS_SANITIZE_DONATE_MIN`` are the argument and the constant
``DONATE_MIN``.
"""

from __future__ import annotations

import os
import sys
import warnings
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from dslabs_tpu_torch.analysis.core import (Finding, apply_waivers,
                                            load_waivers, repo_root)

__all__ = ["audit_sites", "audit_search", "sanitize_engine",
           "build_audit_engines", "site_entries", "clone_args",
           "count_syncs", "DONATE_MIN"]

# Argument tensors below this many bytes are left out of the J3 check.
DONATE_MIN = 65536

_READBACKS = {"item", "tolist", "numpy", "__int__", "__bool__",
              "__float__", "__index__", "__complex__", "__array__"}
# Ops that return a host value computed on the device.
_VERDICTS = {"equal", "allclose", "is_nonzero"}
_SHAPE_OPS = {"nonzero", "argwhere", "masked_select", "unique",
              "unique_consecutive", "bincount"}
_UPLOADS = {"tensor", "as_tensor", "asarray"}
_COLLECTIVES = ("c10d", "_c10d_functional", "_c10d_functional_autograd")
_WIDE = (torch.float64, torch.complex128)
_TORCH_DIR = os.path.dirname(torch.__file__)
_HERE = os.path.abspath(__file__)


def _host_literal(d) -> bool:
    return isinstance(d, str) and d.split(":")[0] == "cpu"


class _Watch:
    """What one run of a site did: its host syncs (op and line), its aten
    op trace, wide dtypes and collectives.  ``cpu`` = the run is on the
    CPU, where host tensors are tracked by marks (module docstring)."""

    def __init__(self, cpu: bool) -> None:
        self.cpu = cpu
        self.syncs: List[tuple] = []
        self.trace: List[tuple] = []
        self.wide: List[str] = []
        self.collectives: List[str] = []
        self._host: Dict[int, weakref.ref] = {}

    # -------------------------------------------------------- host marks

    def is_host(self, t) -> bool:
        if not isinstance(t, torch.Tensor):
            return True
        if not self.cpu:
            return t.device.type == "cpu"
        return id(t) in self._host

    def mark_host(self, t) -> None:
        if self.cpu and isinstance(t, torch.Tensor):
            i = id(t)
            self._host[i] = weakref.ref(
                t, lambda _r, i=i, h=self._host: h.pop(i, None))

    def _target_host(self, target, other) -> bool:
        if other is not None:
            return self.is_host(other)
        if self.cpu:
            return _host_literal(target)
        return torch.device(target).type == "cpu"

    # ----------------------------------------------------------- records

    def sync(self, op: str) -> None:
        f = sys._getframe(2)
        while f is not None and (f.f_code.co_filename.startswith(_TORCH_DIR)
                                 or os.path.abspath(
                                     f.f_code.co_filename) == _HERE):
            f = f.f_back
        where = "?"
        if f is not None:
            path = os.path.relpath(f.f_code.co_filename, repo_root())
            if path.startswith(".."):
                path = f.f_code.co_filename
            where = f"{path}:{f.f_lineno}"
        self.syncs.append((op, where))

    def op(self, func, out) -> None:
        ts = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        name = str(func)
        self.trace.append(
            (name, tuple((tuple(t.shape), str(t.dtype)) for t in ts)))
        if any(t.dtype in _WIDE for t in ts):
            self.wide.append(name)
        if getattr(func, "namespace", "") in _COLLECTIVES:
            self.collectives.append(name)


def _numel(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel()
    if isinstance(x, np.ndarray):
        return x.size
    if isinstance(x, (list, tuple)):
        return len(x)
    return 1


def _fresh(out, src):
    """A new tensor object for a result that is its source on the CPU
    (``.cpu()`` or ``.to()`` of a CPU tensor returns it): the marks then
    follow the result, not the source."""
    return out.detach() if out is src else out


class _FunctionMode(TorchFunctionMode):
    def __init__(self, w: _Watch) -> None:
        super().__init__()
        self.w = w

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from dslabs_tpu_torch.tpu import _build

        kwargs = kwargs or {}
        if _build.in_plain_version():
            return func(*args, **kwargs)
        w = self.w
        if isinstance(func, torch._ops.OpOverload):
            # An aten op reached from the dispatch mode's handler: only
            # torch.from_numpy's lift_fresh shows here, a host tensor.
            out = func(*args, **kwargs)
            if func.__name__.split(".")[0] == "lift_fresh":
                w.mark_host(out)
            return out
        name = getattr(func, "__name__", None) or str(func)
        src = args[0] if args else None
        if name in _READBACKS:
            if not w.is_host(src) and _numel(src) > 0:
                w.sync(f"Tensor.{name}")
            return func(*args, **kwargs)
        if name == "cpu":
            out = func(*args, **kwargs)
            if not w.is_host(src):
                if src.numel() > 0:
                    w.sync("Tensor.cpu")
                out = _fresh(out, src)
                w.mark_host(out)
            return out
        if name == "to":
            return self._to(func, args, kwargs)
        if name in _UPLOADS and isinstance(func, type(torch.tensor)):
            return self._upload(func, args, kwargs)
        if name == "copy_" and len(args) > 1:
            dst_host, src_host = w.is_host(args[0]), w.is_host(args[1])
            if dst_host != src_host and _numel(args[1]) > 0:
                w.sync("Tensor.copy_")
            return func(*args, **kwargs)
        on_dev = any(not w.is_host(t) for t in tree_leaves((args, kwargs))
                     if isinstance(t, torch.Tensor))
        if name in ("__getitem__", "__setitem__") \
                and not w.is_host(src):
            self._index(name, args)
        elif on_dev and (name in _SHAPE_OPS or name in _VERDICTS or (
                name == "where" and len(args) == 1 and not kwargs)):
            w.sync(f"torch.{name}")
        elif on_dev and name == "repeat_interleave" and isinstance(
                args[1] if len(args) > 1 else kwargs.get("repeats", src),
                torch.Tensor) and kwargs.get("output_size") is None:
            # Two readbacks on the card (analysis/sync_cases.py).
            w.sync("torch.repeat_interleave")
            w.sync("torch.repeat_interleave")
        out = func(*args, **kwargs)
        if w.cpu:
            dev = kwargs.get("device")
            leaves = [t for t in tree_leaves((args, kwargs))
                      if isinstance(t, torch.Tensor)]
            host = (all(w.is_host(t) for t in leaves)
                    and (dev is None or _host_literal(dev)))
            if host:
                for t in tree_leaves(out):
                    w.mark_host(t)
        return out

    def _to(self, func, args, kwargs):
        w = self.w
        src = args[0]
        target, other = kwargs.get("device"), None
        for a in args[1:]:
            if isinstance(a, torch.Tensor):
                other = a
            elif isinstance(a, (str, torch.device)) or (
                    isinstance(a, int) and not isinstance(a, bool)):
                target = a
        out = func(*args, **kwargs)
        src_host = w.is_host(src)
        if target is None and other is None:
            if src_host:
                w.mark_host(out)
            return out
        dst_host = w._target_host(target, other)
        if src_host != dst_host:
            if src.numel() > 0:
                w.sync("Tensor.to")
            out = _fresh(out, src)
            if dst_host:
                w.mark_host(out)
        elif src_host:
            w.mark_host(out)
        return out

    def _upload(self, func, args, kwargs):
        w = self.w
        data = args[0] if args else kwargs.get("data")
        dev = kwargs.get("device")
        out = func(*args, **kwargs)
        if dev is not None and not w._target_host(dev, None):
            if w.is_host(data) and out.numel() > 0:
                w.sync(f"torch.{func.__name__}")
            if isinstance(data, torch.Tensor):
                out = _fresh(out, data)
        elif w.is_host(data):
            w.mark_host(out)
        return out

    def _index(self, name, args) -> None:
        """A boolean-mask read is a ``nonzero`` (a boolean-mask store of
        a scalar is a masked fill, no sync); a list or host-tensor index,
        or a host value stored into the device tensor, is an upload."""
        w = self.w
        idx = args[1] if len(args) > 1 else None
        parts = idx if isinstance(idx, tuple) else (idx,)
        v = args[2] if len(args) > 2 else None
        scalar_store = name == "__setitem__" and (
            not isinstance(v, (torch.Tensor, np.ndarray, list))
            or (isinstance(v, torch.Tensor) and v.dim() == 0))
        for p in parts:
            if isinstance(p, torch.Tensor) and p.dtype in (torch.bool,
                                                           torch.uint8):
                if not scalar_store:
                    w.sync(f"Tensor.{name} (boolean mask)")
            elif (isinstance(p, torch.Tensor) and w.is_host(p)) or (
                    isinstance(p, (list, np.ndarray)) and len(p)):
                w.sync(f"Tensor.{name} (host index)")
        if name == "__setitem__" and len(args) > 2:
            v = args[2]
            if (isinstance(v, torch.Tensor) and w.is_host(v)
                    and v.dim() > 0 and v.numel() > 0) or (
                    isinstance(v, (np.ndarray, list)) and _numel(v) > 0):
                w.sync("Tensor.__setitem__ (host value)")


class _DispatchMode(TorchDispatchMode):
    def __init__(self, w: _Watch) -> None:
        super().__init__()
        self.w = w

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from dslabs_tpu_torch.tpu import _build

        out = func(*args, **(kwargs or {}))
        if not _build.in_plain_version():
            self.w.op(func, out)
        return out


def _watched(fn, args, cpu: bool):
    """Run ``fn(*args)`` under both modes -> (result, watch)."""
    w = _Watch(cpu)
    with _FunctionMode(w), _DispatchMode(w):
        out = fn(*args)
    return out, w


# ------------------------------------------------------------- helpers

def clone_args(args):
    """A deep copy of the tensors of ``args`` (dicts, lists and tuples
    walked; other values shared), so a site run never writes the
    caller's tensors."""
    if isinstance(args, torch.Tensor):
        return args.clone()
    if isinstance(args, dict):
        return type(args)((k, clone_args(v)) for k, v in args.items())
    if isinstance(args, (list, tuple)):
        return type(args)(clone_args(v) for v in args)
    return args


def _big(args) -> List[torch.Tensor]:
    return [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)
            and t.numel() * t.element_size() >= DONATE_MIN]


def _storages(ts) -> set:
    return {t.untyped_storage().data_ptr() for t in ts}


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.shape == b.shape and a.dtype == b.dtype
                and bool(torch.equal(a.cpu(), b.cpu())))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(map(_equal, a, b))
    return a == b


def site_entries(sites: Dict[str, object]):
    """``(tag, name, entry)`` for every function of a site map (a tag's
    entry, or each entry of its list; ``name`` is None for a single
    one), in tag order."""
    for tag in sorted(sites):
        v = sites[tag]
        if isinstance(v, dict):
            yield tag, None, v
        else:
            for e in v:
                yield tag, e.get("name"), e


def _device_of(args) -> str:
    for t in tree_leaves(args):
        if isinstance(t, torch.Tensor):
            return t.device.type
    return "cpu"


def count_syncs(fn, args) -> List[tuple]:
    """The host syncs of one ``fn(*args)`` as the audit counts them, on
    the device of ``args``: ``(op, line)`` each."""
    return _watched(fn, tuple(args), _device_of(args) == "cpu")[1].syncs


# --------------------------------------------------------------- audit

def audit_sites(sites: Dict[str, object], engine_name: str,
                deep: bool = False,
                report: Optional[dict] = None) -> List[Finding]:
    """Audit a ``{tag: entry or [entries]}`` site map (the shape
    ``dispatch_site_programs()`` returns):

    entry = {"fn": callable, "args": real tensors (and values) on the
             engine's device, "builder": optional () -> a rebuilt fn
             (J5), "name": which function of the tag; and, each only to
             override the registry's contract: "in_place": declared in
             place?, "multi": collectives expected?, "syncs": host syncs
             one call may take}

    ``report`` (a dict) receives per function ``"tag"`` or
    ``"tag:name"``: its syncs with their ops and lines, its budget and
    its aten op count."""
    from dslabs_tpu_torch.tpu.telemetry import DISPATCH_SITES

    findings: List[Finding] = []

    def emit(code: str, tag: str, message: str) -> None:
        findings.append(Finding(code=code, leg="jaxpr", path=engine_name,
                                obj=tag, message=message))

    missing = set()
    for tag, name, entry in site_entries(sites):
        where = tag if name is None else f"{tag} ({name})"
        meta = DISPATCH_SITES.get(tag)
        if meta is None:
            if tag not in missing:
                missing.add(tag)
                emit("J0", tag,
                     "dispatch site is not in telemetry.DISPATCH_SITES: "
                     "register it so spans, profiler captures and this "
                     "audit cover it")
            meta = dict(hot=False, in_place=False, multi=False,
                        program=True, syncs=0)
        budget = entry.get("syncs", meta["syncs"])
        in_place = entry.get("in_place", meta["in_place"])
        multi = entry.get("multi", meta["multi"])
        if budget is None:
            emit("J0", tag, f"{where}: the site's sync budget depends on "
                 f"the engine's configuration, and its entry gives none")
            continue
        fn, args = entry["fn"], tuple(entry.get("args", ()))
        cpu = _device_of(args) == "cpu"
        try:
            fn(*clone_args(args))          # warm-up, uncounted
            run_args = clone_args(args)
            big = _big(run_args) if in_place else []
            before = _storages(big)
            out, w = _watched(fn, run_args, cpu)
            after = _storages(_big(run_args)) if in_place else set()
        except Exception as e:  # noqa: BLE001 - a site that raises is
            emit("J0", tag,     # audit rot, loudly
                 f"{where}: function raised when the audit ran it: "
                 f"{type(e).__name__}: {e}")
            continue
        if report is not None:
            report[tag if name is None else f"{tag}:{name}"] = dict(
                syncs=len(w.syncs), budget=budget,
                sync_ops=[f"{op} at {at}" for op, at in w.syncs],
                ops=len(w.trace))
        if len(w.syncs) > budget:
            emit("J1", tag,
                 f"{where}: {len(w.syncs)} host sync(s) in one call, "
                 f"budget {budget}: "
                 + "; ".join(f"{op} at {at}" for op, at in w.syncs))
        if w.wide:
            emit("J2", tag,
                 f"{where}: float64/complex128 output of "
                 f"{sorted(set(w.wide))[:4]}: the engines are int32 / "
                 f"int64 / float32 end to end; find the upcast (a numpy "
                 f"float64 array or a Python float promoted)")
        if in_place and before != after:
            nbytes = sum(t.numel() * t.element_size() for t in big)
            emit("J3", tag,
                 f"{where}: declared in_place but its carry tensors of "
                 f">= {DONATE_MIN} bytes (~{nbytes >> 10} KiB) changed "
                 f"storage over the call: the carry reallocates every "
                 f"dispatch (a rebinding where an in-place write was "
                 f"meant)")
        if not multi and w.collectives:
            emit("J4", tag,
                 f"{where}: collective {w.collectives[0]} in a "
                 f"single-device site: a process-group op here means the "
                 f"site was built for the wrong scope")
        builder = entry.get("builder")
        if deep and builder is not None:
            try:
                fn2 = builder()
                fn2(*clone_args(args))     # its own warm-up, uncounted
                out2, w2 = _watched(fn2, clone_args(args), cpu)
            except Exception as e:  # noqa: BLE001
                emit("J0", tag,
                     f"{where}: builder failed to rebuild the function "
                     f"for the retrace check: {type(e).__name__}: {e}")
                continue
            if w2.trace != w.trace or not _equal(out, out2):
                what = ("op trace" if w2.trace != w.trace
                        else "return values")
                emit("J5", tag,
                     f"{where}: the rebuilt function gives another "
                     f"{what} on the same inputs: per-build constants or "
                     f"id()-ordered iteration in the builder, which a "
                     f"CUDA-graph capture of the site would inherit")
    return findings


def audit_search(search, deep: bool = False,
                 report: Optional[dict] = None) -> List[Finding]:
    """Audit one built engine through its ``dispatch_site_programs()``."""
    return audit_sites(search.dispatch_site_programs(),
                       type(search).__name__, deep=deep, report=report)


def sanitize_engine(search, deep: bool = False) -> List[Finding]:
    """The run-time hook (``sanitize="on"`` / ``"full"`` on
    ``TensorSearch`` and ``SwarmSearch``): audit, apply the waiver file,
    record each finding as a ``sanitizer_finding`` event on an attached
    recorder and warn once.  Never raises: a sanitizer crash must not
    take the engine down with it.  The engine's run counters
    (``chunk_steps``, ``walk_steps``) are left as they were."""
    kept = {k: getattr(search, k) for k in ("chunk_steps", "walk_steps")
            if hasattr(search, k)}
    try:
        findings = apply_waivers(audit_search(search, deep=deep),
                                 load_waivers())
    except Exception as e:  # noqa: BLE001 - never fatal to the run
        warnings.warn(f"sanitize: audit failed on "
                      f"{type(search).__name__}: {type(e).__name__}: {e}",
                      RuntimeWarning, stacklevel=4)
        return []
    finally:
        for k, v in kept.items():
            setattr(search, k, v)
    tel = getattr(search, "_telemetry", None)
    if tel is not None:
        for f in findings:
            tel.event("sanitizer_finding", code=f.code, site=f.obj,
                      engine=f.path, message=f.message, waived=f.waived)
    live = [f for f in findings if not f.waived]
    if live:
        warnings.warn(
            f"sanitize: {len(live)} hot-path audit finding(s) on "
            f"{type(search).__name__}: "
            + "; ".join(f"[{f.code}] {f.obj}" for f in live[:6]),
            RuntimeWarning, stacklevel=4)
    return findings


# ------------------------------------------------- CLI audit targets

def build_audit_engines(device=None, with_swarm: bool = True,
                        with_spill: bool = True) -> List:
    """The CLI's standard audit set, on the card unless ``device`` names
    another: the pingpong hand twin's ``TensorSearch``, the compiled
    ``paxos_spec(3)`` with ``symmetry=True`` (so that the packing and
    canonicalize sites register), the pingpong spill variant, and the
    one-device ``SwarmSearch``, a two-lane pingpong ``LaneSearch`` and a
    two-shard pingpong ``ShardedTensorSearch`` (the reference's set
    holds the same), on small caps.  These engines run in one process,
    where no site issues a collective; rule J4's real content, a
    collective in a site declared single-device, shows on the ranks of a
    ``RankMesh``, where the sharded and swarm sites are declared
    multi-device and every other site single-device (an audit job of
    ``tpu/ranks.py`` runs this audit on each rank)."""
    from dslabs_tpu_torch.tpu._build import resolve_device
    from dslabs_tpu_torch.tpu.engine import TensorSearch
    from dslabs_tpu_torch.tpu.protocols.pingpong import \
        make_pingpong_protocol
    from dslabs_tpu_torch.tpu.specs import paxos_spec

    device = resolve_device(device)
    caps = dict(max_depth=8, chunk=64, frontier_cap=1 << 8,
                visited_cap=1 << 10, device=device)
    proto = make_pingpong_protocol(workload_size=2)
    engines = [TensorSearch(proto, **caps),
               TensorSearch(paxos_spec(3).compile(), symmetry=True,
                            **caps)]
    if with_spill:
        from dslabs_tpu_torch.tpu.spill import spill_manager_for_audit

        engines.append(TensorSearch(proto, spill=spill_manager_for_audit(),
                                    **caps))
    if with_swarm:
        from dslabs_tpu_torch.tpu.swarm import SwarmSearch

        engines.append(SwarmSearch(proto, walkers_per_device=8,
                                   max_steps=8, max_rounds=2,
                                   visited_cap=1 << 10, device=device))
    from dslabs_tpu_torch.tpu.lanes import LaneSearch

    engines.append(LaneSearch(proto, n_lanes=2, chunk=64,
                              frontier_cap=1 << 8, visited_cap=1 << 10,
                              device=device))
    from dslabs_tpu_torch.tpu.sharded import ShardedTensorSearch, make_mesh

    engines.append(ShardedTensorSearch(
        proto, make_mesh(2, device=device), chunk_per_device=16,
        frontier_cap=1 << 8, visited_cap=1 << 10, max_depth=8))
    return engines
