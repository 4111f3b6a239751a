"""Cross-job memoization for the checking service.

Counterpart of ``dslabs_tpu/service/memo.py``.  The service's traffic is
redundant: a class of students submits near-identical protocols, and
each student resubmits after a one-line fix.  Three reuse legs, all keyed
on a structural spec fingerprint (never source text):

* **Verdict cache**: an exact-key hit (same structure, same predicates,
  same budget and engine-relevant knobs) returns the cached verdict with
  zero device dispatches, journaled as a ``memo_hit`` event with a
  ``cached=true`` verdict and a near-zero COSTS charge.
* **Warm start**: same structure, bigger budget: the new job's run dir
  is seeded with the prior run's deepest checkpoint, so the search
  resumes at the cached frontier depth through ``tpu/checkpoint.py``
  (kernel 2 rebuilds the visited table from the dump) with the counts of
  a cold run at equal depth: the dump stores the exact visited union.
* **Incremental re-check**: the structural diff localizes to a handler
  set H; tag-reachability over the compiled spec's event table bounds
  the first level whose expansion could fire H, and the job resumes from
  the deepest archived per-level checkpoint at or below that bound
  (``levels_skipped`` >= 1 for any handler not reachable at the root).

Invalidation is loud and conservative: the engine checkpoint
``config_fingerprint`` (protocol name, widths, caps, strictness, the
symmetry permutation count, the checkpoint format), the engine settings
the job's search runs with (packed frontier, symmetry) and the memo
format all ride the key; any mismatch, or any spec whose closure the
fingerprinter cannot hash by value, is a cold run, never a stale
verdict.  A tenant module's own file contents are hashed into the
introspection cache key; modules it imports are not.

Store layout (beside the service journal, torn-tolerant; the
reference's, so a store is read by either package):

    memo/verdicts.jsonl            append-only exact-key verdict lines
    memo/sigs/<sig>/sig.json       signature record (atomic replace)
    memo/sigs/<sig>/ckpt.npz       deepest checkpoint for the signature
    memo/sigs/<sig>/tier.npz       versioned visited tier (tpu/spill.py)
    memo/sigs/<sig>/levels/*.npz   per-level checkpoints (incremental)

Running this module as ``__main__`` is the introspection child, off the
card (the admission child's parent/child split): it builds the protocol,
computes the structural fingerprint and the handler effect table, and
prints one JSON line.

Deliberate differences from the reference: no environment knobs.  The
memo is ``CheckServer(memo=)`` (the CLI's ``--no-memo``) where the
reference reads ``DSLABS_MEMO``; the store is ``memo_path=`` (default
:func:`memo_dir`) for ``DSLABS_MEMO_DIR``; :data:`TIER_CAP` and
``MemoStore(tier_cap=)`` for ``DSLABS_MEMO_TIER_CAP``;
:data:`INTROSPECT_SECS` for ``DSLABS_MEMO_INTROSPECT_SECS``; the levels
directory is an argument of the search (``TensorSearch(levels_dir=)``)
for ``DSLABS_MEMO_LEVELS``.  The key's engine settings are the ones a
warden child's search runs with (packed, no symmetry: the supervisor sets
neither), not ``DSLABS_PACKED`` / ``DSLABS_SYMMETRY``.  The introspection
child leaves
the card with ``CUDA_VISIBLE_DEVICES=`` where the reference sets
``JAX_PLATFORMS=cpu``; it runs the port's compiler's ``Ctx`` on P = 1 CPU
tensors in the batched layout.  A captured frozen dataclass (the slot
lowering's ``SlotField`` default, which every spec with a callable slot
init carries, the flagship's included) is hashed by its fields' values,
where the reference marks the fingerprint weak.  A compiled spec's
destination mask is the compiler's own (lane 2 of a message row); it is
hashed under the reference's spelling (:data:`_SPEC_MSG_DEST_SRC`), so the
two packages' fingerprints of one spec agree and a store is shared.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import inspect
import json
import os
import shutil
import sys
import textwrap
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["MemoStore", "MemoPlan", "MEMO_FORMAT", "MEMO", "memo_dir",
           "introspect_protocol", "introspect_child",
           "factory_source_hash", "env_fingerprint", "key_fields",
           "verdict_key", "sig_key", "divergence_depth",
           "witness_digest", "UNCACHEABLE_ENDS", "TIER_CAP",
           "INTROSPECT_SECS"]

MEMO_FORMAT = "dslabs-memo-v1"

# Verdicts whose end condition depends on wall time or transient
# capacity pressure are never cached: an identical resubmit could
# legitimately produce a different (better) answer.
UNCACHEABLE_ENDS = ("TIME_EXHAUSTED", "CAPACITY_EXHAUSTED")

# The service's default (``CheckServer(memo=)``), the largest visited
# tier archived per signature (keys), and the introspection child's time
# limit (seconds): the reference's environment defaults as constants.
MEMO = True
TIER_CAP = 1 << 22
INTROSPECT_SECS = 120.0

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def memo_dir(root: str) -> str:
    """The store's default place: ``<root>/memo``."""
    return os.path.join(root, "memo")


def _sha(obj) -> str:
    """Canonical short hash of a JSON-able object."""
    blob = json.dumps(obj, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


# ------------------------------------------------------------ fingerprint
#
# The structural fingerprint hashes what the spec is, not what it is
# called or how it is formatted: node kinds (fields, domains, init),
# message / timer types (fields, bounds), caps, symmetry groups, initial
# events, handler ASTs (docstrings, decorators and function names
# stripped), and predicate ASTs.  The spec's display name, the factory
# module name, whitespace and comments do not take part: a rename-only
# resubmit lands the same fingerprint.


class _HashAcc:
    """Accumulates value hashes; remembers when a closure cell could
    only be hashed by type (not value): such fingerprints are marked weak
    and the store refuses to memoize on them."""

    def __init__(self):
        self.weak = False


def _fn_ast_hash(fn, acc: _HashAcc) -> str:
    """AST-normalized hash of one handler or predicate: decorators, the
    function name and the docstring are stripped, so a renamed or
    re-wrapped but identical function hashes the same.  Closure cell
    values take part (a spec parameterized by ``workload_size`` captures
    it), as do defaults."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
        fd = tree.body[0]
        if isinstance(fd, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fd.decorator_list = []
            fd.name = "_h"
            body = list(fd.body)
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                body = body[1:] or [ast.Pass()]
            fd.body = body
        dump = ast.dump(tree, include_attributes=False)
    except (OSError, TypeError, SyntaxError, IndentationError,
            ValueError):
        # No retrievable source (REPL, C function, exec'd code): the
        # bytecode hash, which still normalizes names out.
        return _code_hash(fn, acc)
    return _ast_dump_hash(dump, fn, acc)


def _ast_dump_hash(dump: str, fn, acc: _HashAcc) -> str:
    return _sha({"ast": hashlib.sha256(dump.encode()).hexdigest(),
                 "cells": _closure_values(fn, acc),
                 "defaults": [_value_hash(v, acc)
                              for v in (fn.__defaults__ or ())]})


def _closure_values(fn, acc: _HashAcc) -> list:
    out = []
    for name, cell in zip(fn.__code__.co_freevars,
                          fn.__closure__ or ()):
        try:
            v = cell.cell_contents
        except ValueError:
            out.append([name, "<empty>"])
            continue
        out.append([name, _value_hash(v, acc)])
    return out


def _code_hash(fn, acc: _HashAcc) -> str:
    code = fn.__code__
    consts = [_value_hash(c, acc) for c in code.co_consts]
    return _sha({"co": hashlib.sha256(code.co_code).hexdigest(),
                 "consts": consts, "names": code.co_names,
                 "nargs": code.co_argcount,
                 "cells": _closure_values(fn, acc),
                 "defaults": [_value_hash(v, acc)
                              for v in (fn.__defaults__ or ())]})


def _array_hash(a) -> str:
    return _sha({"dtype": str(a.dtype), "shape": a.shape,
                 "sha": hashlib.sha256(a.tobytes()).hexdigest()})


def _value_hash(v, acc: _HashAcc, depth: int = 0) -> str:
    """Hash a captured value by value where possible.  The escape hatch
    (type only) marks the accumulator weak: two different specs could
    then collide, so the store treats a weak fingerprint as not
    memoizable rather than risk a stale verdict.  A torch tensor on the
    CPU is hashed by value through numpy (as the reference hashes a JAX
    array); one on the card stays weak."""
    import numpy as np

    if depth > 6:
        acc.weak = True
        return f"<deep:{type(v).__name__}>"
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return repr(v)
    if isinstance(v, type((lambda: 0).__code__)):
        return hashlib.sha256(v.co_code).hexdigest()[:16]
    if callable(v) and hasattr(v, "__code__"):
        return _fn_ast_hash(v, acc)
    if isinstance(v, (tuple, list)):
        return _sha([_value_hash(x, acc, depth + 1) for x in v])
    if isinstance(v, dict):
        return _sha(sorted((repr(k), _value_hash(x, acc, depth + 1))
                           for k, x in v.items()))
    if type(v).__module__.split(".")[0] == "torch" and hasattr(v, "device"):
        if getattr(v.device, "type", None) == "cpu":
            return _array_hash(v.detach().numpy())
        acc.weak = True
        return f"<tensor:{v.device}>"
    if hasattr(v, "__array__"):
        return _array_hash(np.asarray(v))
    # A spec-shaped object captured by a predicate wrapper: hash it
    # structurally instead of by identity.
    if hasattr(v, "handlers") and hasattr(v, "messages"):
        try:
            return _sha(_spec_base(v))
        except Exception:  # noqa: BLE001 (fall through to the weak path)
            pass
    if isinstance(v, type(os)):  # a module: its name is its identity
        return f"<module:{v.__name__}>"
    if (dataclasses.is_dataclass(v) and not isinstance(v, type)
            and v.__dataclass_params__.frozen):
        # An immutable declaration (the slot lowering's captured
        # SlotField): its value is its fields'.
        return _sha([type(v).__qualname__]
                    + [[f.name, _value_hash(getattr(v, f.name), acc,
                                            depth + 1)]
                       for f in dataclasses.fields(v)])
    acc.weak = True
    return f"<type:{type(v).__module__}.{type(v).__qualname__}>"


def _recover_spec(proto):
    """A compiled ``ProtocolSpec`` twin carries its spec in the
    ``step_message`` closure: recover it, so generated twins fingerprint
    structurally (handler ASTs) instead of through opaque closures."""
    from dslabs_tpu_torch.tpu.compiler import ProtocolSpec

    if isinstance(proto, ProtocolSpec):
        return proto
    fn = getattr(proto, "step_message", None)
    for cell in (getattr(fn, "__closure__", None) or ()):
        try:
            v = cell.cell_contents
        except ValueError:
            continue
        if isinstance(v, ProtocolSpec):
            return v
    return None


def _field_init(f, acc: _HashAcc):
    return (_fn_ast_hash(f.init, acc) if callable(f.init)
            else repr(f.init))


def _slot_decls(spec, acc: _HashAcc) -> list:
    """Slots declarations, from ``spec.slot_blocks``: the expanded node
    fields carry each record field's lanes and domain, but not the
    ``clear`` value ``slot_clear_upto`` writes or the block's logical
    base.  A declaration missing the expected shape (a duck-typed block)
    marks the fingerprint weak."""
    out = []
    for (kind, _bn), b in sorted(getattr(spec, "slot_blocks", {}).items()):
        try:
            out.append([kind, b.name, b.n, b.base,
                        [[sf.name, _field_init(sf, acc), sf.lo,
                          repr(sf.hi), repr(sf.delta), sf.clear]
                         for sf in b.fields]])
        except AttributeError:
            acc.weak = True
            out.append([kind, repr(type(b))])
    return out


def _quorum_decls(spec, acc: _HashAcc) -> list:
    """Quorum declarations: the threshold takes part (``ctx.quorum``
    reads resolve through it, so "majority" -> 2 is a change the handler
    ASTs cannot see)."""
    out = []
    for q in getattr(spec, "quorums", ()) or ():
        try:
            out.append([q.name, q.over, repr(q.threshold)])
        except AttributeError:
            acc.weak = True
            out.append([repr(type(q))])
    return sorted(out)


def _spec_base(spec, acc: Optional[_HashAcc] = None) -> dict:
    """The structure of a declarative spec minus its handlers and display
    name: kinds, fields and domains, slot blocks, quorums, fragments,
    message and timer types, caps, symmetry groups, initial events."""
    acc = acc or _HashAcc()
    return {
        "fmt": MEMO_FORMAT, "kind": "spec",
        "nodes": [[k.name, k.count,
                   [[f.name, f.size, _field_init(f, acc), f.lo,
                     repr(f.hi), repr(getattr(f, "index_group", None))]
                    for f in k.fields]] for k in spec.nodes],
        "slots": _slot_decls(spec, acc),
        "quorums": _quorum_decls(spec, acc),
        "fragments": sorted(list(getattr(spec, "fragments", []) or [])),
        "messages": [[m.name, list(m.fields),
                      sorted((k, list(v)) for k, v in
                             (m.bounds or {}).items())]
                     for m in spec.messages],
        "timers": [[t.name, list(t.fields), t.min_ms, t.max_ms,
                    sorted((k, list(v)) for k, v in
                           (t.bounds or {}).items())]
                   for t in spec.timers],
        "net_cap": spec.net_cap, "timer_cap": spec.timer_cap,
        "symmetry": repr(getattr(spec, "symmetry", None)),
        "initial_messages": repr(spec.initial_messages),
        "initial_timers": repr(spec.initial_timers),
    }


def _twin_base(proto, acc: _HashAcc) -> dict:
    """Structural base of a hand-written twin: the lane layout, the
    concrete initial arrays and the step closures hashed by code and
    captured values.  The display name is excluded here (it still rides
    the checkpoint fingerprint, which guards seeding)."""
    import numpy as np

    def _arr(fn):
        a = fn()
        if hasattr(a, "detach"):
            a = a.detach().cpu().numpy()
        a = np.asarray(a)
        return {"dtype": str(a.dtype), "shape": a.shape,
                "sha": hashlib.sha256(a.tobytes()).hexdigest()}

    return {
        "fmt": MEMO_FORMAT, "kind": "twin",
        "n_nodes": proto.n_nodes, "node_width": proto.node_width,
        "msg_width": proto.msg_width, "timer_width": proto.timer_width,
        "net_cap": proto.net_cap, "timer_cap": proto.timer_cap,
        "max_sends": proto.max_sends, "max_sets": proto.max_sets,
        "max_live_sends": getattr(proto, "max_live_sends", None),
        "init_nodes": _arr(proto.init_nodes),
        "init_messages": _arr(proto.init_messages),
        "init_timers": _arr(proto.init_timers),
        "symmetry": repr(getattr(proto, "symmetry", None)),
        "lane_domains": repr(sorted(
            (getattr(proto, "lane_domains", None) or {}).items())),
    }


def _unwrap_pred(fn):
    """The spec compiler wraps each predicate in a ``_pred`` closure:
    hash the tenant's function, not the wrapper, so one predicate
    attached before or after compile fingerprints alike."""
    code = getattr(fn, "__code__", None)
    if code is not None and "fn" in code.co_freevars:
        idx = code.co_freevars.index("fn")
        try:
            inner = (fn.__closure__ or ())[idx].cell_contents
        except (ValueError, IndexError):
            return fn
        if callable(inner):
            return inner
    return fn


# The compiled spec's destination mask as the reference's compiler spells
# it (one message row's lane 2; the port's batched copy reads the last
# axis): hashed under this spelling, the mask is the same rule in both
# packages' fingerprints.
_SPEC_MSG_DEST_SRC = "msg_dest=lambda msg: msg[2],\n"


def _is_compiler_msg_dest(fn) -> bool:
    return (getattr(fn, "__module__", None)
            == "dslabs_tpu_torch.tpu.compiler"
            and getattr(fn, "__qualname__", "").startswith(
                "ProtocolSpec.compile."))


def _mask_hash(role: str, fn, acc: _HashAcc, spec) -> str:
    if spec is not None and role == "msg_dest" and \
            _is_compiler_msg_dest(fn):
        dump = ast.dump(ast.parse(_SPEC_MSG_DEST_SRC),
                        include_attributes=False)
        return _ast_dump_hash(dump, fn, acc)
    return _fn_ast_hash(fn, acc)


def _proto_predicates(proto, acc: _HashAcc, spec=None) -> Dict[str, str]:
    preds: Dict[str, str] = {}
    for role in ("goals", "invariants", "prunes"):
        for name, fn in sorted(
                (getattr(proto, role, None) or {}).items()):
            preds[f"{role}:{name}"] = _fn_ast_hash(_unwrap_pred(fn), acc)
    for role in ("deliver_message", "deliver_timer",
                 "deliver_message_rt", "deliver_timer_rt", "msg_dest"):
        fn = getattr(proto, role, None)
        if fn is not None:
            preds[f"mask:{role}"] = _mask_hash(role, fn, acc, spec)
    return preds


def _handler_effects(spec) -> Dict[str, dict]:
    """The compiled spec's event table: run every handler once with a
    dummy context (the compiler's ``_count_budgets`` discipline: handlers
    are straight-line over the combinators) on P = 1 CPU tensors in the
    batched layout (a scalar field ``[1]``, an array field ``[1, size]``)
    and read the concrete message tag (row lane 0) and timer tag (row
    lane 1) off each effect row.  Nested ``ctx.cond`` children share the
    effect lists, so conditional sends are captured too."""
    import torch

    from dslabs_tpu_torch.tpu.compiler import Ctx, _Step

    table, _ = spec._layout()
    if getattr(spec, "_sizes", None) is None:
        spec._sizes = {(f, k): size for (k, _i, f), (_o, size)
                       in table.items()}
    step = _Step(1, torch.device("cpu"))

    def dummy_state():
        return {key: torch.zeros((1,) if size == 1 else (1, size),
                                 dtype=torch.int32)
                for key, (_, size) in table.items()}

    def zero():
        return torch.zeros((1,), dtype=torch.int32)

    def tags(rows, lane, prefix):
        return sorted({f"{prefix}{int(r[0, lane])}" for r, _ in rows})

    false = torch.zeros((1,), dtype=torch.bool)
    eff: Dict[str, dict] = {}
    seen = set()
    for kind, i in spec._instances():
        if kind.name in seen:
            continue
        seen.add(kind.name)
        for types, registry, tagmap, prefix, with_from in (
                (spec.messages, spec.handlers, spec._mtag, "m", True),
                (spec.timers, spec.timer_handlers, spec._ttag, "t",
                 False)):
            for t in types:
                fn = registry.get((kind.name, t.name))
                if fn is None:
                    continue
                sends: list = []
                sets: list = []
                ctx = Ctx(spec, dummy_state(), kind.name, i, false, sends,
                          sets, handler=spec._handler_id(fn), step=step)
                payload = {f: zero() for f in t.fields}
                if with_from:
                    payload["_from"] = zero()
                spec._invoke(fn, ctx, payload, t.name)
                eff[f"{prefix}:{kind.name}:{t.name}"] = {
                    "trigger": f"{prefix}{tagmap[t.name]}",
                    "sends": tags(sends, 0, "m"),
                    "sets": tags(sets, 1, "t")}
    return eff


def _initial_events(spec) -> List[str]:
    return sorted({f"m{spec._mtag[name]}"
                   for name, _, _, _ in spec.initial_messages}
                  | {f"t{spec._ttag[name]}"
                     for name, _, _ in spec.initial_timers})


_INF = 1 << 30


def divergence_depth(effects: Dict[str, dict], initial: List[str],
                     changed) -> int:
    """Lower bound on the first search depth whose expansion can fire a
    changed handler: Bellman-Ford over event-type availability.  An
    event type is available at depth 0 if initial, else one past the
    earliest firing of any handler (changed or not) that emits it; the
    union effect table of the old and new spec keeps the bound a true
    lower bound for both state spaces, so every level at or below it is
    shared and resumable.  ``_INF`` when no changed handler's trigger is
    reachable at all (the edit is dead code for this initial
    condition)."""
    avail = {ev: 0 for ev in initial}
    for _ in range(len(effects) + len(avail) + 2):
        moved = False
        for e in effects.values():
            d = avail.get(e["trigger"])
            if d is None:
                continue
            for out_ev in list(e["sends"]) + list(e["sets"]):
                if avail.get(out_ev, _INF) > d + 1:
                    avail[out_ev] = d + 1
                    moved = True
        if not moved:
            break
    fires = [avail.get(effects[h]["trigger"], _INF)
             for h in changed if h in effects]
    return min(fires) if fires else _INF


def _union_effects(a: Dict[str, dict],
                   b: Dict[str, dict]) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for k in set(a) | set(b):
        ea, eb = a.get(k), b.get(k)
        if ea is None or eb is None:
            e = ea or eb
            out[k] = {"trigger": e["trigger"],
                      "sends": list(e["sends"]), "sets": list(e["sets"])}
            continue
        out[k] = {"trigger": ea["trigger"],
                  "sends": sorted(set(ea["sends"]) | set(eb["sends"])),
                  "sets": sorted(set(ea["sets"]) | set(eb["sets"]))}
    return out


def introspect_protocol(proto) -> dict:
    """The full memo view of one live protocol object: the structural
    fingerprint (base + handlers + predicates), the handler effect table
    (spec twins only), and the engine checkpoint fingerprints the
    warm-start guard compares (strict and beam) for a search without
    symmetry, as a warden child's runs."""
    from dslabs_tpu_torch.tpu import checkpoint as ckpt_mod

    acc = _HashAcc()
    spec = _recover_spec(proto)
    if spec is not None:
        base = _spec_base(spec, acc)
        handlers = {
            f"m:{k}:{m}": _fn_ast_hash(fn, acc)
            for (k, m), fn in sorted(spec.handlers.items())}
        handlers.update({
            f"t:{k}:{t}": _fn_ast_hash(fn, acc)
            for (k, t), fn in sorted(spec.timer_handlers.items())})
        effects = _handler_effects(spec)
        initial = _initial_events(spec)
        kind = "spec"
    else:
        base = _twin_base(proto, acc)
        handlers = {
            "step_message": _fn_ast_hash(proto.step_message, acc),
            "step_timer": _fn_ast_hash(proto.step_timer, acc)}
        effects = None
        initial = None
        kind = "twin"
    predicates = _proto_predicates(proto, acc, spec)
    base_fp = _sha(base)
    spec_fp = _sha({"base": base_fp, "handlers": sorted(handlers.items()),
                    "predicates": sorted(predicates.items())})
    ckpt_fp = {"strict": ckpt_mod.config_fingerprint(proto, True, False),
               "beam": ckpt_mod.config_fingerprint(proto, False, False)}
    return {"ok": True, "fmt": MEMO_FORMAT, "kind": kind,
            "weak": acc.weak, "name": proto.name,
            "base_fp": base_fp, "spec_fp": spec_fp,
            "handlers": handlers, "predicates": predicates,
            "effects": effects, "initial": initial,
            "ckpt_fp": ckpt_fp, "sym": 0}


# --------------------------------------------------------- source keying
#
# The server caches introspection per (factory ref, kwargs, transform,
# factory module file hash): a student editing the module in place gets a
# fresh introspection child (a fresh interpreter, no stale
# ``sys.modules``), so an edited spec can never ride a stale fingerprint
# into the verdict cache.

def factory_source_hash(factory: str,
                        extra_sys_path: Optional[List[str]] = None
                        ) -> Optional[str]:
    import importlib.util

    mod_name = factory.partition(":")[0]
    old = sys.path[:]
    try:
        sys.path[:0] = list(extra_sys_path or [])
        try:
            spec = importlib.util.find_spec(mod_name)
        except (ImportError, ValueError, AttributeError):
            return None
    finally:
        sys.path[:] = old
    origin = getattr(spec, "origin", None) if spec else None
    if not origin or not os.path.isfile(origin):
        return None
    try:
        with open(origin, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()[:16]
    except OSError:
        return None


def introspect_child(factory: str, factory_kwargs: Optional[dict],
                     transform: Optional[str],
                     extra_sys_path: Optional[List[str]] = None,
                     env: Optional[dict] = None,
                     timeout: float = INTROSPECT_SECS) -> dict:
    """Run the introspection in a subprocess off the card (the admission
    child's discipline: tenant code never runs in the server process, and
    a hung or crashing child is a structured miss: the job runs cold)."""
    import subprocess

    child_env = dict(os.environ)
    child_env["CUDA_VISIBLE_DEVICES"] = ""
    paths = [_REPO_ROOT] + list(extra_sys_path or [])
    if child_env.get("PYTHONPATH"):
        paths.append(child_env["PYTHONPATH"])
    child_env["PYTHONPATH"] = os.pathsep.join(paths)
    child_env.update(env or {})
    spec = {"factory": factory, "factory_kwargs": factory_kwargs or {},
            "transform": transform}
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "dslabs_tpu_torch.service.memo"],
            input=json.dumps(spec), capture_output=True, text=True,
            env=child_env, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": f"introspection child exceeded "
                                      f"{timeout:.0f}s"}
    except OSError as e:
        return {"ok": False, "error": f"spawn failed: {e}"}
    if proc.returncode != 0 or not proc.stdout.strip():
        tail = (proc.stderr or "").strip().splitlines()[-1:]
        return {"ok": False,
                "error": f"child rc={proc.returncode} tail={tail}"}
    try:
        return json.loads(proc.stdout.strip().splitlines()[-1])
    except ValueError:
        return {"ok": False, "error": "unparsable child output"}


def _introspect_main() -> int:
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    spec = json.load(sys.stdin)
    try:
        from dslabs_tpu_torch.tpu.warden import _resolve

        proto = _resolve(spec["factory"])(**(spec.get("factory_kwargs")
                                             or {}))
        if spec.get("transform"):
            proto = _resolve(spec["transform"])(proto)
        out = introspect_protocol(proto)
    except BaseException as e:  # noqa: BLE001 (a raising factory = no memo)
        out = {"ok": False,
               "error": f"{type(e).__name__}: {e}"[:300]}
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
    return 0


# ------------------------------------------------------------- key schema

def env_fingerprint() -> str:
    """The engine settings a verdict depends on, in the reference's
    string: the packed frontier, the symmetry pass, the checkpoint format
    and the memo format.  The settings are those a warden child's search
    runs with: the supervisor builds its ``TensorSearch`` packed and
    without symmetry.  A format bump invalidates every prior entry:
    loudly cold, never stale."""
    from dslabs_tpu_torch.tpu import checkpoint as ckpt_mod

    return (f"packed=1,sym=0,ckpt={ckpt_mod.FORMAT_VERSION},"
            f"memo={MEMO_FORMAT}")


def key_fields(intro: dict, strict: bool, chunk: int,
               frontier_cap: int, visited_cap: int,
               ladder: Tuple[str, ...]) -> dict:
    """Everything except the depth / time budget: the signature key.  The
    verdict key adds (max_depth, max_secs) on top."""
    return {
        "spec_fp": intro["spec_fp"],
        "strict": bool(strict),
        "chunk": int(chunk),
        "frontier_cap": int(frontier_cap),
        "visited_cap": int(visited_cap),
        "ladder": list(ladder),
        "env_fp": env_fingerprint(),
        "ckpt_fp": intro["ckpt_fp"]["strict" if strict else "beam"],
    }


def sig_key(fields: dict) -> str:
    return _sha(fields)


def verdict_key(fields: dict, max_depth: Optional[int],
                max_secs: Optional[float]) -> str:
    return _sha({"sig": fields, "max_depth": max_depth,
                 "max_secs": max_secs})


def _as_list(v):
    import numpy as np

    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v).tolist()


def witness_digest(predicate: Optional[str], violating_state,
                   goal_state, trace) -> Optional[str]:
    """A stable digest of the (minimized) witness attached to a verdict,
    so a cached or incremental verdict can be checked identical to its
    cold run without shipping the full state.  The reference's digest:
    the same states give the same string in either package."""
    if (predicate is None and violating_state is None
            and goal_state is None):
        return None

    def _state(s):
        if s is None:
            return None
        return {k: _as_list(v) for k, v in s.items()}

    return _sha({"predicate": predicate,
                 "violating": _state(violating_state),
                 "goal": _state(goal_state),
                 "trace": (_as_list(trace) if trace is not None
                           else None)})


# ------------------------------------------------------------------ store

class MemoPlan:
    """What the store decided for one submission: ``mode`` is one of
    ``cold`` / ``hit`` / ``warm`` / ``incremental``; warm and incremental
    carry the seed checkpoint to copy into the job's run dir."""

    def __init__(self, mode: str, sig: str, fields: dict,
                 seed_ckpt: Optional[str] = None,
                 seed_depth: int = 0, levels_skipped: int = 0,
                 base_device_secs: float = 0.0, reason: str = "",
                 verdict: Optional[dict] = None):
        self.mode = mode
        self.sig = sig
        self.fields = fields
        self.seed_ckpt = seed_ckpt
        self.seed_depth = seed_depth
        self.levels_skipped = levels_skipped
        self.base_device_secs = base_device_secs
        self.reason = reason
        self.verdict = verdict


class MemoStore:
    """The persistent cross-job memo store.  Torn-tolerant by
    construction: the verdict cache is an append-only JSONL (bad lines
    skipped on read), signature records are atomic tmp + replace, and
    every seed file is guarded by the engine's own checkpoint fingerprint
    check plus the versioned tier CRC: a half-written artifact gives a
    cold run, never a wrong one."""

    def __init__(self, path: str, tier_cap: int = TIER_CAP):
        self.path = os.path.abspath(path)
        os.makedirs(os.path.join(self.path, "sigs"), exist_ok=True)
        self.verdicts_path = os.path.join(self.path, "verdicts.jsonl")
        self.tier_cap = int(tier_cap)
        self._lock = threading.Lock()
        self.stats = {"hits": 0, "warm_starts": 0, "incremental": 0,
                      "levels_skipped": 0, "device_secs_saved": 0.0,
                      "misses": 0, "stores": 0}

    # ---------------------------------------------------------- stats

    def stats_block(self) -> dict:
        with self._lock:
            st = dict(self.stats)
        st["device_secs_saved"] = round(st["device_secs_saved"], 3)
        lookups = st["hits"] + st["warm_starts"] + st["incremental"] \
            + st["misses"]
        st["hit_rate"] = (round(
            (st["hits"] + st["warm_starts"] + st["incremental"])
            / lookups, 3) if lookups else None)
        st["enabled"] = True
        st["dir"] = self.path
        return st

    def bump(self, counter: str, by=1) -> None:
        with self._lock:
            self.stats[counter] += by

    # -------------------------------------------------------- verdicts

    def _iter_verdicts(self):
        try:
            with open(self.verdicts_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        yield json.loads(line)
                    except ValueError:
                        continue  # a torn tail line: skip, stay sound
        except OSError:
            return

    def lookup_verdict(self, fields: dict, max_depth: Optional[int],
                       max_secs: Optional[float]) -> Optional[dict]:
        key = verdict_key(fields, max_depth, max_secs)
        found = None
        for rec in self._iter_verdicts():
            if rec.get("key") == key:
                found = rec
        return found

    def record_verdict(self, fields: dict, max_depth: Optional[int],
                       max_secs: Optional[float], verdict: dict,
                       device_secs: float) -> bool:
        if verdict.get("status") != "done":
            return False
        if verdict.get("end") in UNCACHEABLE_ENDS:
            return False
        if verdict.get("degraded") or verdict.get("deaths"):
            return False
        keep = {k: verdict.get(k) for k in (
            "end", "unique", "explored", "depth", "engine",
            "predicate", "witness")}
        rec = {"t": "memo_verdict",
               "key": verdict_key(fields, max_depth, max_secs),
               "sig": sig_key(fields), "fields": fields,
               "max_depth": max_depth, "max_secs": max_secs,
               "verdict": keep,
               "device_secs": round(float(device_secs), 4)}
        line = json.dumps(rec) + "\n"
        with self._lock:
            try:
                with open(self.verdicts_path, "a") as f:
                    f.write(line)
            except OSError:
                return False
            self.stats["stores"] += 1
        return True

    # ------------------------------------------------------ signatures

    def sig_dir(self, sig: str) -> str:
        return os.path.join(self.path, "sigs", sig)

    def _load_sig(self, sig: str) -> Optional[dict]:
        try:
            with open(os.path.join(self.sig_dir(sig), "sig.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _sig_levels(self, sig: str) -> Dict[int, str]:
        d = os.path.join(self.sig_dir(sig), "levels")
        out: Dict[int, str] = {}
        try:
            names = os.listdir(d)
        except OSError:
            return out
        for n in names:
            if n.startswith("level_") and n.endswith(".npz"):
                try:
                    out[int(n[len("level_"):-len(".npz")])] = \
                        os.path.join(d, n)
                except ValueError:
                    continue
        return out

    def _tier_ok(self, sig: str, rec: dict) -> Tuple[bool, str]:
        """Validate the signature's archived visited tier (versioned
        format, ``tpu/spill.py``): a CRC or meta refusal means the seed
        lineage is suspect, so the plan falls back to cold, loudly."""
        tier_path = os.path.join(self.sig_dir(sig), "tier.npz")
        if not os.path.exists(tier_path):
            return True, ""  # the tier is optional (cap-skipped archives)
        from dslabs_tpu_torch.tpu import spill as spill_mod

        try:
            spill_mod.load_tier(tier_path, expect_meta={
                "pack": rec.get("pack", "identity"),
                "sym": rec.get("sym", 0)})
        except Exception as e:  # noqa: BLE001 (any doubt = cold run)
            return False, f"{type(e).__name__}: {e}"[:200]
        return True, ""

    # ------------------------------------------------------------ plan

    def plan(self, intro: dict, strict: bool, chunk: int,
             frontier_cap: int, visited_cap: int,
             ladder: Tuple[str, ...],
             max_depth: Optional[int], max_secs: Optional[float]
             ) -> MemoPlan:
        """Decide the reuse mode for one submission.  Precedence: exact
        verdict hit > warm start (same signature, new budget) >
        incremental (handler-localized diff) > cold.  Every guard failure
        degrades toward cold with a reason string the server journals:
        never an exception, never a stale seed."""
        fields = key_fields(intro, strict, chunk, frontier_cap,
                            visited_cap, ladder)
        sig = sig_key(fields)
        if intro.get("weak"):
            return MemoPlan("cold", sig, fields,
                            reason="weak_fingerprint")
        hit = self.lookup_verdict(fields, max_depth, max_secs)
        if hit is not None:
            return MemoPlan(
                "hit", sig, fields,
                base_device_secs=float(hit.get("device_secs", 0.0)),
                verdict=dict(hit.get("verdict") or {}))
        rec = self._load_sig(sig)
        if rec is not None:
            plan = self._plan_same_sig(sig, rec, fields, max_depth)
            if plan is not None:
                return plan
        plan = self._plan_incremental(intro, fields, sig, max_depth)
        if plan is not None:
            return plan
        return MemoPlan("cold", sig, fields, reason="miss")

    def _plan_same_sig(self, sig: str, rec: dict, fields: dict,
                       max_depth: Optional[int]) -> Optional[MemoPlan]:
        if rec.get("ckpt_fp") != fields["ckpt_fp"]:
            return MemoPlan("cold", sig, fields,
                            reason="ckpt_fingerprint_mismatch")
        ok, why = self._tier_ok(sig, rec)
        if not ok:
            return MemoPlan("cold", sig, fields,
                            reason=f"tier_refused:{why}")
        depth = int(rec.get("depth", 0))
        ck = os.path.join(self.sig_dir(sig), "ckpt.npz")
        if os.path.exists(ck) and depth > 0 and (
                max_depth is None or depth <= max_depth):
            return MemoPlan("warm", sig, fields, seed_ckpt=ck,
                            seed_depth=depth, levels_skipped=depth,
                            base_device_secs=float(
                                rec.get("device_secs", 0.0)))
        # The deepest checkpoint overshoots the new (smaller) depth
        # budget: the deepest archived level inside it.
        levels = self._sig_levels(sig)
        usable = [d for d in levels
                  if d > 0 and (max_depth is None or d <= max_depth)]
        if usable:
            d = max(usable)
            return MemoPlan("warm", sig, fields, seed_ckpt=levels[d],
                            seed_depth=d, levels_skipped=d,
                            base_device_secs=float(
                                rec.get("device_secs", 0.0)))
        return None

    def _plan_incremental(self, intro: dict, fields: dict,
                          new_sig: str, max_depth: Optional[int]
                          ) -> Optional[MemoPlan]:
        if intro.get("kind") != "spec" or not intro.get("effects"):
            return None
        try:
            sigs = os.listdir(os.path.join(self.path, "sigs"))
        except OSError:
            return None
        for sig in sorted(sigs)[:256]:
            if sig == new_sig:
                continue
            rec = self._load_sig(sig)
            if rec is None:
                continue
            f_old = rec.get("fields") or {}
            if any(f_old.get(k) != fields[k] for k in (
                    "strict", "chunk", "frontier_cap", "visited_cap",
                    "ladder", "env_fp", "ckpt_fp")):
                continue
            if rec.get("base_fp") != intro["base_fp"]:
                continue
            if rec.get("predicates") != intro["predicates"]:
                continue
            old_h = rec.get("handlers") or {}
            new_h = intro["handlers"]
            if set(old_h) != set(new_h):
                continue  # a handler added or removed: structure changed
            changed = sorted(k for k in new_h if old_h[k] != new_h[k])
            if not changed:
                continue  # the same spec_fp would have matched above
            ok, why = self._tier_ok(sig, rec)
            if not ok:
                return MemoPlan("cold", new_sig, fields,
                                reason=f"tier_refused:{why}")
            union = _union_effects(rec.get("effects") or {},
                                   intro["effects"])
            e_low = divergence_depth(
                union, intro.get("initial") or [], changed)
            levels = self._sig_levels(sig)
            usable = [d for d in levels
                      if 0 < d <= e_low
                      and (max_depth is None or d <= max_depth)]
            if not usable:
                continue
            d = max(usable)
            return MemoPlan(
                "incremental", new_sig, fields, seed_ckpt=levels[d],
                seed_depth=d, levels_skipped=d,
                base_device_secs=float(rec.get("device_secs", 0.0)),
                reason=f"changed={','.join(changed)[:120]} "
                       f"divergence>={e_low}")
        return None

    # --------------------------------------------------------- archive

    def archive(self, intro: dict, fields: dict, verdict: dict,
                run_dir: str, device_secs: float) -> Optional[str]:
        """Persist one finished cold or warm run for future reuse: the
        deepest checkpoint, the per-level dumps the job's search archived
        (``<run_dir>/levels``), the versioned visited tier and the
        signature record; all atomic, never fatal."""
        from dslabs_tpu_torch.tpu import checkpoint as ckpt_mod

        if verdict.get("status") != "done" or verdict.get("deaths"):
            return None
        if intro.get("weak"):
            return None
        src = os.path.join(run_dir, "ckpt.npz")
        if not os.path.exists(src):
            return None
        try:
            fp = ckpt_mod.peek_fingerprint(src)
            depth = ckpt_mod.peek_depth(src)
        except Exception:  # noqa: BLE001 (an unreadable dump: no archive)
            return None
        if fp != fields["ckpt_fp"]:
            return None  # a foreign dump: never seed from it
        sig = sig_key(fields)
        sd = self.sig_dir(sig)
        os.makedirs(os.path.join(sd, "levels"), exist_ok=True)
        old = self._load_sig(sig)
        if old is not None and int(old.get("depth", 0)) >= int(depth):
            self._merge_levels(sig, run_dir)
            return sig  # keep the deeper archive, still adopt levels
        try:
            tmp = os.path.join(sd, "ckpt.npz.tmp")
            shutil.copyfile(src, tmp)
            os.replace(tmp, os.path.join(sd, "ckpt.npz"))
        except OSError:
            return None
        self._merge_levels(sig, run_dir)
        pack, sym, n_keys = self._archive_tier(sd, src, fp)
        rec = {"fmt": MEMO_FORMAT, "sig": sig, "fields": fields,
               "spec_fp": intro["spec_fp"], "base_fp": intro["base_fp"],
               "handlers": intro["handlers"],
               "predicates": intro["predicates"],
               "effects": intro.get("effects"),
               "initial": intro.get("initial"),
               "kind": intro.get("kind"), "name": intro.get("name"),
               "ckpt_fp": fp, "depth": int(depth),
               "pack": pack, "sym": sym, "tier_keys": n_keys,
               "device_secs": round(float(device_secs), 4),
               "end": verdict.get("end")}
        try:
            tmp = os.path.join(sd, "sig.json.tmp")
            with open(tmp, "w") as f:
                f.write(json.dumps(rec))
            os.replace(tmp, os.path.join(sd, "sig.json"))
        except OSError:
            return None
        with self._lock:
            self.stats["stores"] += 1
        return sig

    def _merge_levels(self, sig: str, run_dir: str) -> None:
        src_dir = os.path.join(run_dir, "levels")
        dst_dir = os.path.join(self.sig_dir(sig), "levels")
        try:
            names = os.listdir(src_dir)
        except OSError:
            return
        os.makedirs(dst_dir, exist_ok=True)
        for n in names:
            if not (n.startswith("level_") and n.endswith(".npz")):
                continue
            try:
                tmp = os.path.join(dst_dir, n + ".tmp")
                shutil.copyfile(os.path.join(src_dir, n), tmp)
                os.replace(tmp, os.path.join(dst_dir, n))
            except OSError:
                continue

    def _archive_tier(self, sig_dir: str, ckpt_path: str,
                      fp: str) -> Tuple[str, int, int]:
        """Write the signature's exact visited tier in the versioned
        on-disk format (``tpu/spill.py`` ``save_tier``): the (h1, h2)
        fingerprint union from the checkpoint's ``visited_keys``, with the
        pack descriptor and symmetry flag pinned in the meta so that a
        foreign consumer is refused loudly.  Skipped (not truncated) past
        ``tier_cap`` keys."""
        import numpy as np

        from dslabs_tpu_torch.tpu import checkpoint as ckpt_mod
        from dslabs_tpu_torch.tpu import spill as spill_mod

        pack, sym = "identity", 0
        try:
            ck = ckpt_mod.load(ckpt_path, fp)
        except Exception:  # noqa: BLE001 (the tier is optional)
            return pack, sym, 0
        if ck is None:
            return pack, sym, 0
        if ck.extra and "frontier_encoding" in ck.extra:
            try:
                pack = np.asarray(
                    ck.extra["frontier_encoding"]).tobytes().decode()
            except Exception:  # noqa: BLE001
                pack = "unknown"
        if "sym" in fp:
            # config_fingerprint appends 'symN' for reduced dumps.
            try:
                sym = int(fp.rsplit("sym", 1)[-1].rstrip("'\") ,"))
            except ValueError:
                sym = 1
        keys = np.asarray(ck.visited_keys, np.uint32)
        n = int(keys.shape[0])
        if n > self.tier_cap:
            return pack, sym, 0
        h1, h2 = spill_mod._rows_to_u64(keys)
        try:
            spill_mod.save_tier(
                os.path.join(sig_dir, "tier.npz"), h1, h2,
                meta={"pack": pack, "sym": sym, "ckpt_fp": fp})
        except OSError:
            return pack, sym, 0
        return pack, sym, n


if __name__ == "__main__":
    sys.exit(_introspect_main())
