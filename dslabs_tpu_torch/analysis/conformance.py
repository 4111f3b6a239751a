"""Leg A of the soundness sanitizer: the protocol conformance linter,
the counterpart of ``dslabs_tpu/analysis/conformance.py`` over the
port's tree.

The object runner keeps student protocols sound with runtime machinery:
deep cloning on every send plus conformance-check logging
(search/search_state.py clone-on-send, utils/check_logger.py).  The
tensor twins generated by ``tpu/specs.py`` have no clone-on-send, so a
handler that mutates a received payload, leaks nondeterminism, or
carries hash-hostile state silently breaks generated-vs-hand parity.
This module checks the same contract statically, over

* ``ProtocolSpec`` handlers (spec introspection + AST),
* the hand-written tensor twins (``tpu/protocols/``) and their
  bindings (``tpu/adapters/``),
* object-level ``Node`` code (``labs/``),

as six rules (the JAX package's codes, listed in ``core.RULES``;
tests/test_torch_analysis.py holds the port's findings against the
reference's on the same sources):

C1  handler purity — mutation of a received message/timer payload
    (``m["x"] = ...``, ``message.seq += 1``, ``message.entries.append``)
    or aliasing a mutable node-state container into a send without a
    copy (``self.send(Reply(self.log), dst)``).
C2  nondeterminism — ``random``/``time``/``id()``/``uuid``/``secrets``
    calls, a draw from torch's global generator (``torch.rand*`` and the
    other samplers with no ``generator=``; a draw from an explicit
    generator is seeded and threaded, the counterpart of the reference's
    ``jax.random`` exemption), or iteration over an unordered ``set``
    (not wrapped in ``sorted``) inside handler code.
C3  dedup soundness — a PUBLIC node-state field assigned a value that
    defeats ``utils.structural.sfreeze``/``shash`` (an array from a
    numpy, torch or jax constructor, a lambda, a generator,
    ``object()``, ``id()``, open files, locks): structural equality
    degrades to identity and the visited set stops deduping.
C4  spec hygiene — declared messages/timers with no handler, put/get
    of undeclared fields, handlers registered for unknown
    kinds/messages.  The hard half of C4 is also enforced at
    ``ProtocolSpec.compile()`` time as structured ``SpecError``s
    (tpu/compiler.py); this linter reports the same failures as
    findings plus the soft half (unhandled declared types).  The budget
    dry-run (``spec._count_budgets()``) executes every handler once, so
    it also covers the replicated-protocol layer: slot ops on
    undeclared blocks / static slot indices outside ``[base,
    base+n)``, and reads of undeclared quorums, surface here as C4
    findings; declared ``Slots`` blocks and quorums the dry-run never
    touched are reported as the soft half (dead declarations widen
    every packed row for nothing).
C5  symmetry hygiene (tpu/symmetry.py) — a handler on a kind inside a
    declared ``symmetry=`` group branches on the RAW node id
    (``ctx.node_index()`` — or a local derived from it — compared
    against an integer constant).  The symmetry reduction's soundness
    argument is that any group permutation is an automorphism of the
    transition system; a member-specific branch breaks
    interchangeability, so the canonicalize pass would merge states
    with different behavior.  Two member-specific access patterns from
    the slot/quorum layer fall under the same argument and are flagged
    too: ``ctx.get_at``/``ctx.put_at`` of an ``index_group`` array over
    a symmetric kind at an INTEGER CONSTANT index, and
    ``ctx.quorum(q).met_bits``/``count_bits`` fed a constant bitmask
    when the quorum's ``over=`` kind is symmetric (bit k names member
    k).  Soft findings (the spec may be intentionally asymmetric with
    the groups removed).
C6  fault-model opacity (tpu/faults.py) — a handler reads, writes, or
    branches on the fault controller's internals: the reserved
    ``"$fault"`` kind name, or a ``ctx.get``/``put`` of its lanes
    (``pcut``/``eras``/``crashes``/``drops``/``dups``/``down_*``).
    Protocol steps must be a function of delivered events only: a
    handler that peeks at the schedule would behave differently under
    a cut than any real implementation could.  The compile gate
    (tpu/compiler.py) hard-fails handler registration on the
    controller kind; this rule catches the read/branch half statically.
    Soft finding: a protocol field that merely shares a fault lane name
    is waivable.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from dslabs_tpu_torch.analysis.core import Finding, repo_root

__all__ = ["lint_source", "lint_paths", "check_spec", "lint_specs",
           "DEFAULT_LINT_PATHS"]

# The shipped surface the CLI lints by default (repo-relative).
DEFAULT_LINT_PATHS = (
    "dslabs_tpu_torch/tpu/specs.py",
    "dslabs_tpu_torch/tpu/specs_lab3.py",
    "dslabs_tpu_torch/tpu/specs_lab4.py",
    "dslabs_tpu_torch/tpu/protocols",
    "dslabs_tpu_torch/tpu/adapters",
    "dslabs_tpu_torch/labs",
)

# Method calls that mutate their receiver in place.
_MUTATORS = {"append", "add", "update", "pop", "popitem", "clear",
             "remove", "discard", "extend", "insert", "setdefault",
             "sort", "reverse"}
# Wrapping any of these around an aliased container is the sanctioned
# copy discipline (clone is utils.structural.clone).
_COPY_WRAPPERS = {"dict", "list", "set", "tuple", "frozenset", "sorted",
                  "copy", "deepcopy", "clone", "sfreeze"}
# Modules whose use inside a handler is nondeterminism (C2).
_NONDET_TIME_ATTRS = {"time", "time_ns", "monotonic", "monotonic_ns",
                      "perf_counter", "perf_counter_ns", "clock"}
# torch samplers that draw from the global generator unless given a
# ``generator=`` (C2).
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like",
                "randn_like", "randint_like", "bernoulli", "multinomial",
                "normal", "poisson"}
# Constructors whose values defeat sfreeze/shash on PUBLIC fields (C3):
# the array constructors of numpy, torch and jax.
_C3_ARRAY_ROOTS = ("numpy", "torch", "jax")
_C3_NUMPY_CTORS = {"array", "zeros", "ones", "empty", "full", "arange",
                   "asarray", "frombuffer", "tensor", "as_tensor",
                   "from_numpy"}
_C3_BAD_CALLS = {"object", "iter", "open", "Lock", "RLock", "Event",
                 "Condition", "Semaphore", "Thread", "Queue"}
# Fault-controller internals a handler must never touch (C6).  Kept as
# source-level literals (mirroring tpu/faults.py FAULT_KIND /
# FAULT_FIELDS) so the linter stays importable without the tpu stack.
_C6_FAULT_KIND = "$fault"
_C6_FAULT_FIELDS = {"pcut", "eras", "crashes", "drops", "dups"}
# ctx methods whose first string argument names a node-state field.
_C6_FIELD_METHODS = {"get", "get_at", "put", "put_at"}


def _call_root(node: ast.AST) -> Optional[str]:
    """Dotted name of a call target / attribute chain root, e.g.
    ``np.random.shuffle`` -> "np.random.shuffle"; None when the chain
    is not made of plain names."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_name(node: ast.AST, name: str) -> bool:
    return isinstance(node, ast.Name) and node.id == name


class _ClassInfo:
    """Per-class facts the rules need: which public attributes are
    mutable containers (C1 aliasing) and which are set-typed (C2
    iteration)."""

    def __init__(self) -> None:
        self.mutable_attrs: Set[str] = set()
        self.set_attrs: Set[str] = set()

    @staticmethod
    def _ann_root(ann: Optional[ast.AST]) -> str:
        """Head name of an annotation: ``Dict[int, X]`` -> "Dict"."""
        if isinstance(ann, ast.Subscript):
            ann = ann.value
        if isinstance(ann, ast.Attribute):
            return ann.attr
        if isinstance(ann, ast.Name):
            return ann.id
        return ""

    @staticmethod
    def collect(cls: ast.ClassDef) -> "_ClassInfo":
        info = _ClassInfo()
        for node in ast.walk(cls):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            value = node.value
            ann = (node.annotation if isinstance(node, ast.AnnAssign)
                   else None)
            if value is None and ann is None:
                continue
            for t in targets:
                if not (isinstance(t, ast.Attribute)
                        and _is_name(t.value, "self")):
                    continue
                name = t.attr
                if isinstance(value, (ast.List, ast.Dict, ast.Set,
                                      ast.ListComp, ast.DictComp,
                                      ast.SetComp)):
                    info.mutable_attrs.add(name)
                elif isinstance(value, ast.Call):
                    cn = _call_root(value.func) or ""
                    base = cn.split(".")[-1]
                    if base in ("list", "dict", "set", "defaultdict",
                                "OrderedDict", "deque", "Counter"):
                        info.mutable_attrs.add(name)
                    if base == "set":
                        info.set_attrs.add(name)
                if isinstance(value, (ast.Set, ast.SetComp)):
                    info.set_attrs.add(name)
                # Annotation-driven typing: the labs prefer
                # ``self.locks: Dict[...] = {}`` and ``s: Set[...]``.
                head = _ClassInfo._ann_root(ann)
                if head in ("Dict", "List", "Set", "DefaultDict",
                            "dict", "list", "set", "Deque",
                            "OrderedDict", "Counter", "MutableMapping",
                            "MutableSet", "MutableSequence"):
                    info.mutable_attrs.add(name)
                if head in ("Set", "set", "MutableSet"):
                    info.set_attrs.add(name)
        return info


class _HandlerLinter(ast.NodeVisitor):
    """Lints ONE handler-ish function body for C1/C2 (and C5 when the
    handler is registered on a kind inside a symmetry group)."""

    def __init__(self, path: str, qual: str, payload: Optional[str],
                 cls: Optional[_ClassInfo], module_aliases: Dict[str, str],
                 findings: List[Finding],
                 symmetric_kind: Optional[str] = None,
                 sym_kinds: Optional[Set[str]] = None,
                 group_fields: Optional[Dict[str, str]] = None,
                 quorum_over: Optional[Dict[str, str]] = None) -> None:
        self.path = path
        self.qual = qual
        self.payload = payload           # name of the received payload
        self.cls = cls
        self.aliases = module_aliases    # local alias -> module name
        self.findings = findings
        self.set_locals: Set[str] = set()
        # C5 state: the symmetric kind this handler serves (None = rule
        # off) and locals tainted by a node_index() read.
        self.symmetric_kind = symmetric_kind
        self.ni_locals: Set[str] = set()
        # C5 slot/quorum state (module-wide: a CLIENT handler indexing
        # a server-group array at a constant is just as member-specific
        # as a server handler doing it).
        self.sym_kinds = sym_kinds or set()
        self.group_fields = group_fields or {}   # field -> index_group
        self.quorum_over = quorum_over or {}     # quorum -> over kind

    def _emit(self, code: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            code=code, leg="conformance", path=self.path, obj=self.qual,
            line=getattr(node, "lineno", 0), message=message))

    # -------------------------------------------------------------- C1

    def _payload_rooted(self, node: ast.AST) -> bool:
        """Is this attribute/subscript chain rooted at the payload
        parameter?"""
        while isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        return self.payload is not None and _is_name(node, self.payload)

    def _check_payload_mutation(self, target: ast.AST,
                                node: ast.AST) -> None:
        if isinstance(target, (ast.Attribute, ast.Subscript)) \
                and self._payload_rooted(target):
            self._emit("C1", node,
                       f"mutates the received payload "
                       f"{self.payload!r} — handlers must treat "
                       f"messages/timers as immutable (tensor twins "
                       f"have no clone-on-send)")

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._check_payload_mutation(t, node)
        # C2: set-typed locals for the iteration rule.
        if isinstance(node.value, (ast.Set, ast.SetComp)) or (
                isinstance(node.value, ast.Call)
                and (_call_root(node.value.func) or "").split(".")[-1]
                == "set"):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.set_locals.add(t.id)
        # C5: locals derived from the raw node id stay tainted.
        if self.symmetric_kind and self._mentions_node_index(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.ni_locals.add(t.id)
        self.generic_visit(node)

    # -------------------------------------------------------------- C5

    def _mentions_node_index(self, node: Optional[ast.AST]) -> bool:
        if node is None:
            return False
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and isinstance(
                    sub.func, ast.Attribute) \
                    and sub.func.attr == "node_index":
                return True
            if isinstance(sub, ast.Name) and sub.id in self.ni_locals:
                return True
        return False

    @staticmethod
    def _has_int_constant(node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Constant) and isinstance(
                    sub.value, int) and not isinstance(sub.value, bool):
                return True
        return False

    def visit_Compare(self, node: ast.Compare) -> None:
        if self.symmetric_kind:
            sides = [node.left] + list(node.comparators)
            tainted = [s for s in sides
                       if self._mentions_node_index(s)]
            const = [s for s in sides if self._has_int_constant(s)
                     and not self._mentions_node_index(s)]
            if tainted and const:
                self._emit(
                    "C5", node,
                    f"handler on symmetric kind "
                    f"{self.symmetric_kind!r} compares the raw node "
                    f"id (node_index()) against a constant — members "
                    f"of a symmetry group must be interchangeable "
                    f"(identify peers via _from and index per-member "
                    f"state with index_group fields), or remove the "
                    f"kind from the symmetry declaration")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_payload_mutation(node.target, node)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._check_payload_mutation(t, node)
        self.generic_visit(node)

    def _is_send_call(self, node: ast.Call) -> Optional[str]:
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in (
                "send", "broadcast", "send_message"):
            return fn.attr
        return None

    def _scan_alias(self, node: ast.AST, send: str, top: ast.AST,
                    protected: bool) -> None:
        """Flag ``self.<mutable>`` reaching a send un-copied; a copy
        wrapper anywhere above it sanctions the whole subtree."""
        if isinstance(node, ast.Call):
            cn = _call_root(node.func) or ""
            base = cn.split(".")[-1]
            if base in _COPY_WRAPPERS:
                protected = True
        if (isinstance(node, ast.Attribute)
                and _is_name(node.value, "self")
                and self.cls is not None
                and node.attr in self.cls.mutable_attrs
                and not protected):
            self._emit(
                "C1", node,
                f"aliases mutable node state 'self.{node.attr}' into "
                f"{send}() without a copy — the receiver and this "
                f"node would share one object (clone-on-send is an "
                f"object-runner service the tensor twins do not have)")
        for child in ast.iter_child_nodes(node):
            self._scan_alias(child, send, top, protected)

    # -------------------------------------------------------------- C2

    def visit_Call(self, node: ast.Call) -> None:
        send = self._is_send_call(node)
        if send is not None:
            for arg in list(node.args) + [kw.value for kw in
                                          node.keywords]:
                self._scan_alias(arg, send, node, False)
        # payload mutating-method call: message.entries.append(x)
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS \
                and self._payload_rooted(fn.value):
            self._emit("C1", node,
                       f"mutates the received payload "
                       f"{self.payload!r} via .{fn.attr}()")
        # C6: handler get/put of a fault-controller lane.
        if isinstance(fn, ast.Attribute) \
                and fn.attr in _C6_FIELD_METHODS and node.args:
            a0 = node.args[0]
            if isinstance(a0, ast.Constant) \
                    and isinstance(a0.value, str) \
                    and (a0.value in _C6_FAULT_FIELDS
                         or a0.value.startswith("down_")):
                self._emit(
                    "C6", node,
                    f"handler {fn.attr}s fault-controller lane "
                    f"{a0.value!r} — protocols must observe faults "
                    f"only through message loss and timer silence "
                    f"(waive if the field is genuinely the "
                    f"protocol's own)")
        # C5: member-specific access through the replicated layer —
        # a constant element index into an index_group array whose
        # group is symmetric (the permuted array has no fixed slot 2).
        if isinstance(fn, ast.Attribute) \
                and fn.attr in ("get_at", "put_at") \
                and len(node.args) >= 2:
            a0, a1 = node.args[0], node.args[1]
            if isinstance(a0, ast.Constant) \
                    and isinstance(a0.value, str) \
                    and self.group_fields.get(a0.value) in self.sym_kinds \
                    and isinstance(a1, ast.Constant) \
                    and isinstance(a1.value, int) \
                    and not isinstance(a1.value, bool):
                self._emit(
                    "C5", node,
                    f"{fn.attr} of index_group field {a0.value!r} "
                    f"(over symmetric kind "
                    f"{self.group_fields[a0.value]!r}) at constant "
                    f"index {a1.value} — members of a symmetry group "
                    f"are interchangeable, so a fixed element names "
                    f"no one after canonicalization (index via _from "
                    f"or node_index(), or remove the kind from the "
                    f"symmetry declaration)")
        # C5: a constant vote bitmask tested against a quorum whose
        # over= kind is symmetric (bit k of the mask names member k).
        if isinstance(fn, ast.Attribute) \
                and fn.attr in ("met_bits", "count_bits") \
                and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, int) \
                and not isinstance(node.args[0].value, bool) \
                and isinstance(fn.value, ast.Call) \
                and isinstance(fn.value.func, ast.Attribute) \
                and fn.value.func.attr == "quorum" \
                and fn.value.args \
                and isinstance(fn.value.args[0], ast.Constant):
            qname = fn.value.args[0].value
            if self.quorum_over.get(qname) in self.sym_kinds:
                self._emit(
                    "C5", node,
                    f"{fn.attr} of quorum {qname!r} (over symmetric "
                    f"kind {self.quorum_over[qname]!r}) with constant "
                    f"bitmask {node.args[0].value} — bit k names "
                    f"member k, so the test is member-specific; feed "
                    f"it the protocol's own vote-bit field instead")
        cn = _call_root(fn)
        if cn is not None:
            parts = cn.split(".")
            # Resolve through the module's import aliases, so
            # ``from time import time; time()`` and ``np.random.x()``
            # both land on their true dotted path.
            resolved = self.aliases.get(parts[0], parts[0])
            if len(parts) > 1:
                resolved += "." + ".".join(parts[1:])
            rp = resolved.split(".")
            head, tail = rp[0], rp[-1]
            if cn == "id" and node.args:
                self._emit("C2", node,
                           "id() is identity, not structure — its "
                           "value differs across clones/replays")
            elif (head == "random" and len(rp) > 1) or (
                    head == "numpy" and "random" in rp[1:-1]):
                # A key-threaded generator is deterministic; the
                # global-PRNG modules are the trap.
                self._emit("C2", node,
                           f"{cn}() draws unseeded randomness in a "
                           f"handler (breaks replay and minimization)")
            elif head == "torch" and tail in _TORCH_DRAWS \
                    and not any(kw.arg == "generator"
                                for kw in node.keywords):
                self._emit("C2", node,
                           f"{cn}() draws from torch's global generator "
                           f"in a handler (breaks replay and "
                           f"minimization; pass a seeded generator=)")
            elif head == "time" and tail in _NONDET_TIME_ATTRS \
                    and len(rp) > 1:
                self._emit("C2", node,
                           f"{cn}() reads the wall clock in a handler "
                           f"(state must be a function of delivered "
                           f"events only)")
            elif head in ("uuid", "secrets") and len(rp) > 1:
                self._emit("C2", node,
                           f"{cn}() is nondeterministic in a handler")
            elif head == "os" and tail == "urandom":
                self._emit("C2", node,
                           "os.urandom() is nondeterministic in a "
                           "handler")
        self.generic_visit(node)

    # -------------------------------------------------------------- C6

    def visit_Constant(self, node: ast.Constant) -> None:
        if node.value == _C6_FAULT_KIND:
            self._emit(
                "C6", node,
                f"handler references the reserved fault-controller "
                f"kind {_C6_FAULT_KIND!r} — fault-model internals are "
                f"opaque to protocol code (declare scenarios via "
                f"fault=FaultModel(...) and observe them only as "
                f"message loss / timer silence)")
        self.generic_visit(node)

    def _iter_is_unordered_set(self, it: ast.AST) -> bool:
        if isinstance(it, ast.Call):
            cn = (_call_root(it.func) or "").split(".")[-1]
            return cn == "set"
        if isinstance(it, (ast.Set, ast.SetComp)):
            return True
        if isinstance(it, ast.Name) and it.id in self.set_locals:
            return True
        if (isinstance(it, ast.Attribute) and _is_name(it.value, "self")
                and self.cls is not None
                and it.attr in self.cls.set_attrs):
            return True
        return False

    def _check_iter(self, it: ast.AST, node: ast.AST) -> None:
        if self._iter_is_unordered_set(it):
            self._emit("C2", node,
                       "iterates an unordered set in a handler — wrap "
                       "in sorted(...) so replay, minimization, and "
                       "fingerprints see one canonical order")

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node.iter, node)
        self.generic_visit(node)

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            self._check_iter(gen.iter, node)
        self.generic_visit(node)

    visit_ListComp = visit_SetComp = visit_DictComp = \
        visit_GeneratorExp = _visit_comp


class _ModuleLinter(ast.NodeVisitor):
    """Walks one module: finds handler-ish functions and node classes,
    dispatches the per-handler linter, and applies C3 to class state."""

    def __init__(self, path: str, tree: ast.Module,
                 findings: List[Finding]) -> None:
        self.path = path
        self.findings = findings
        self.aliases: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = \
                        a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.aliases[a.asname or a.name] = \
                        f"{node.module}.{a.name}"
        self._cls: Optional[_ClassInfo] = None
        self._qual: List[str] = []
        # C5 pre-pass: spec variable -> declared symmetric kind names
        # (``spec = ProtocolSpec(..., symmetry=("acceptor",))``).
        self._sym_kinds: Dict[str, Set[str]] = {}
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            cn = (_call_root(node.value.func) or "").split(".")[-1]
            if cn != "ProtocolSpec":
                continue
            kinds: Set[str] = set()
            for kw in node.value.keywords:
                if kw.arg != "symmetry":
                    continue
                if isinstance(kw.value, (ast.Tuple, ast.List)):
                    for el in kw.value.elts:
                        if isinstance(el, ast.Constant) and isinstance(
                                el.value, str):
                            kinds.add(el.value)
            if not kinds:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self._sym_kinds[t.id] = kinds
        # C5 slot/quorum pre-pass: which array fields are
        # indexed BY a node group (Field(..., index_group="kind")) and
        # which kind each declared quorum counts over
        # (QuorumCount(name, over="kind", ...)).  Collected module-wide
        # — a fixture/spec module declares these once, at top level or
        # inside a factory.
        self._all_sym: Set[str] = set()
        for ks in self._sym_kinds.values():
            self._all_sym |= ks
        self._group_fields: Dict[str, str] = {}
        self._quorum_over: Dict[str, str] = {}
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            cn = (_call_root(node.func) or "").split(".")[-1]
            if cn == "Field" and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                for kw in node.keywords:
                    if kw.arg == "index_group" and isinstance(
                            kw.value, ast.Constant) and isinstance(
                            kw.value.value, str):
                        self._group_fields[node.args[0].value] = \
                            kw.value.value
            elif cn == "QuorumCount" and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                over = None
                if len(node.args) > 1 and isinstance(
                        node.args[1], ast.Constant):
                    over = node.args[1].value
                for kw in node.keywords:
                    if kw.arg == "over" and isinstance(
                            kw.value, ast.Constant):
                        over = kw.value.value
                if isinstance(over, str):
                    self._quorum_over[node.args[0].value] = over

    # ------------------------------------------------------- discovery

    def _spec_handler_payload(self, fn) -> Tuple[Optional[str],
                                                 Optional[str]]:
        """Spec handlers: ``@spec.on(...)`` / ``@spec.on_timer(...)``
        decorated ``(ctx, m)`` functions.  Returns ``(payload_name,
        symmetric_kind)`` — the latter set when the registered kind is
        inside the spec's declared symmetry groups (C5)."""
        for dec in fn.decorator_list:
            if isinstance(dec, ast.Call) and isinstance(
                    dec.func, ast.Attribute) and dec.func.attr in (
                        "on", "on_timer"):
                args = fn.args.args
                payload = args[1].arg if len(args) > 1 else None
                sym_kind = None
                spec_var = dec.func.value
                if (isinstance(spec_var, ast.Name) and dec.args
                        and isinstance(dec.args[0], ast.Constant)):
                    kind = dec.args[0].value
                    if kind in self._sym_kinds.get(spec_var.id, ()):
                        sym_kind = kind
                return payload, sym_kind
        return None, None

    def _node_handler_payload(self, fn) -> Tuple[bool, Optional[str]]:
        """Node methods: ``handle_X(self, message, sender)``,
        ``on_X(self, timer)``, and ``init(self)``."""
        if self._cls is None:
            return False, None
        args = [a.arg for a in fn.args.args]
        if not args or args[0] != "self":
            return False, None
        if fn.name.startswith("handle_") or fn.name.startswith("on_"):
            return True, (args[1] if len(args) > 1 else None)
        if fn.name == "init":
            return True, None
        return False, None

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        prev_cls, self._cls = self._cls, _ClassInfo.collect(node)
        self._qual.append(node.name)
        self._lint_c3(node)
        self.generic_visit(node)
        self._qual.pop()
        self._cls = prev_cls

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        payload, sym_kind = self._spec_handler_payload(node)
        is_handler = payload is not None or sym_kind is not None \
            or any(isinstance(d, ast.Call) and isinstance(
                d.func, ast.Attribute) and d.func.attr in (
                "on", "on_timer") for d in node.decorator_list)
        if not is_handler:
            is_handler, payload = self._node_handler_payload(node)
        self._qual.append(node.name)
        qual = ".".join(self._qual)
        if is_handler:
            linter = _HandlerLinter(self.path, qual, payload, self._cls,
                                    self.aliases, self.findings,
                                    symmetric_kind=sym_kind,
                                    sym_kinds=self._all_sym,
                                    group_fields=self._group_fields,
                                    quorum_over=self._quorum_over)
            for stmt in node.body:
                linter.visit(stmt)
        self.generic_visit(node)
        self._qual.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # -------------------------------------------------------------- C3

    def _lint_c3(self, cls: ast.ClassDef) -> None:
        qual = ".".join(self._qual)
        for node in ast.walk(cls):
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                if not (isinstance(t, ast.Attribute)
                        and _is_name(t.value, "self")
                        and not t.attr.startswith("_")):
                    continue
                bad = self._c3_reason(node.value)
                if bad:
                    self.findings.append(Finding(
                        code="C3", leg="conformance", path=self.path,
                        obj=f"{qual}.{t.attr}", line=node.lineno,
                        message=f"public state field 'self.{t.attr}' "
                                f"assigned {bad} — sfreeze/shash "
                                f"degrade to identity, so the visited "
                                f"set stops deduping states that "
                                f"differ only here (underscore-prefix "
                                f"the field to exclude it from "
                                f"structural equality)"))

    def _c3_reason(self, value: ast.AST) -> Optional[str]:
        if isinstance(value, ast.Lambda):
            return "a lambda"
        if isinstance(value, ast.GeneratorExp):
            return "a generator"
        if isinstance(value, ast.Call):
            cn = _call_root(value.func) or ""
            parts = cn.split(".")
            root = self.aliases.get(parts[0], parts[0]).split(".")[0]
            if root in _C3_ARRAY_ROOTS and parts[-1] in _C3_NUMPY_CTORS:
                return f"an array ({cn}) — unhashable, identity-equal"
            if parts[-1] in _C3_BAD_CALLS and len(parts) <= 2:
                return f"{cn}() — identity-based / unfreezable"
            if cn == "id":
                return "id() — identity, differs across clones"
        return None


# ---------------------------------------------------------------- API

def lint_source(src: str, path: str) -> List[Finding]:
    """Lint one module's source text (the fixture-test entry point)."""
    findings: List[Finding] = []
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        findings.append(Finding(
            code="C4", leg="conformance", path=path, obj="<module>",
            line=e.lineno or 0, message=f"syntax error: {e.msg}"))
        return findings
    _ModuleLinter(path, tree, findings).visit(tree)
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings


def lint_paths(paths: Optional[Sequence[str]] = None,
               root: Optional[str] = None) -> List[Finding]:
    """Lint files/directories (repo-relative unless absolute)."""
    root = root or repo_root()
    out: List[Finding] = []
    files: List[str] = []
    for p in (paths or DEFAULT_LINT_PATHS):
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isdir(full):
            for dirpath, _dirs, names in os.walk(full):
                files += [os.path.join(dirpath, n) for n in sorted(names)
                          if n.endswith(".py")]
        elif os.path.isfile(full):
            files.append(full)
    for f in sorted(set(files)):
        rel = os.path.relpath(f, root)
        if rel.startswith(".."):     # outside the repo (CLI --paths):
            rel = f                  # keep the path waivers were
        with open(f) as fh:          # written against
            out += lint_source(fh.read(), rel)
    return out


# --------------------------------------------- C4: spec introspection

def check_spec(spec, origin: Optional[str] = None) -> List[Finding]:
    """C4 over a live :class:`~dslabs_tpu_torch.tpu.compiler.ProtocolSpec`:
    the registration/field checks the compile gate raises
    (tpu/compiler.py SpecError) reported as findings, plus the soft
    hygiene the gate tolerates (declared types with no handler)."""
    from dslabs_tpu_torch.tpu.compiler import SpecError

    path = origin or "ProtocolSpec"
    findings: List[Finding] = []

    def _from_err(e: SpecError) -> Finding:
        return Finding(code=e.code, leg="conformance", path=path,
                       obj=e.handler or spec.name, line=e.line or 0,
                       message=str(e))

    try:
        spec.validate()
    except SpecError as e:
        findings.append(_from_err(e))
        return findings           # registration broken: stop here
    try:
        # Executes every handler once (the budget-count pass) — the
        # runtime half of C4: undeclared field put/get, unknown sends,
        # unknown payload reads, through helper functions too.
        spec._count_budgets()
    except SpecError as e:
        findings.append(_from_err(e))
    handled_msgs = {m for _, m in spec.handlers}
    handled_tmrs = {t for _, t in spec.timer_handlers}
    # Messages the dry-run saw a handler SEND (or the init vector
    # seeds) are live wire traffic even without a receiver — the
    # dead-letter idiom the hand twins use for reconfig debris rows
    # (delivery to an address that ignores them still occupies a
    # deduped network row).  Only a message nobody handles AND nobody
    # produces is a dead declaration.
    produced = set(getattr(spec, "_touched_sends", ())) \
        | {name for name, *_ in getattr(spec, "initial_messages", ())}
    for m in spec.messages:
        if m.name not in handled_msgs and m.name not in produced:
            findings.append(Finding(
                code="C4", leg="conformance", path=path, obj=spec.name,
                message=f"declared message {m.name!r} has no handler "
                        f"on any kind and is never sent — dead weight "
                        f"in every record, or a missing registration"))
    for t in spec.timers:
        if t.name not in handled_tmrs:
            findings.append(Finding(
                code="C4", leg="conformance", path=path, obj=spec.name,
                message=f"declared timer {t.name!r} has no handler on "
                        f"any kind — it can fire but never be "
                        f"delivered"))
    # Soft C4 over the replicated layer: the budget dry-run
    # records which Slots blocks / quorums handlers actually touched
    # (tpu/compiler.py Ctx); declarations it never reached are dead
    # weight in every packed row.
    touched_slots = getattr(spec, "_touched_slots", set())
    for (kind, bname), decl in sorted(
            getattr(spec, "slot_blocks", {}).items()):
        if (kind, bname) not in touched_slots:
            findings.append(Finding(
                code="C4", leg="conformance", path=path, obj=spec.name,
                message=f"declared Slots block {bname!r} on kind "
                        f"{kind!r} ({decl.n} slots x "
                        f"{len(decl.fields)} fields) is never read, "
                        f"written, or cleared by any handler — "
                        f"{decl.n * len(decl.fields)} dead lanes per "
                        f"state row"))
    touched_q = getattr(spec, "_touched_quorums", set())
    for q in sorted(getattr(spec, "quorums", ()),
                    key=lambda q: q.name):
        if q.name not in touched_q:
            findings.append(Finding(
                code="C4", leg="conformance", path=path, obj=spec.name,
                message=f"declared quorum {q.name!r} (over "
                        f"{q.over!r}) is never read by any handler — "
                        f"remove it or wire it into a decision"))
    return findings


def lint_specs() -> List[Finding]:
    """C4 over every spec factory the shipped spec modules export:
    everything in ``tpu/specs.py`` ``__all__`` plus the ``make_*_spec``
    factories of the generated-lab modules (``tpu/specs_lab3.py`` /
    ``tpu/specs_lab4.py`` — the ``make_*_protocol`` variants wrap the
    same specs in a full compile, so linting the spec halves covers
    them without compiling)."""
    import dslabs_tpu_torch.tpu.specs as specs_mod
    import dslabs_tpu_torch.tpu.specs_lab3 as lab3_mod
    import dslabs_tpu_torch.tpu.specs_lab4 as lab4_mod

    out: List[Finding] = []
    surfaces = [
        (specs_mod, "dslabs_tpu_torch/tpu/specs.py", lambda n: True),
        (lab3_mod, "dslabs_tpu_torch/tpu/specs_lab3.py",
         lambda n: n.startswith("make_") and n.endswith("_spec")),
        (lab4_mod, "dslabs_tpu_torch/tpu/specs_lab4.py",
         lambda n: n.startswith("make_") and n.endswith("_spec")),
    ]
    for mod, path, keep in surfaces:
        for name in getattr(mod, "__all__", []):
            if not keep(name):
                continue
            factory = getattr(mod, name)
            try:
                spec = factory()
            except Exception as e:  # noqa: BLE001 — a broken factory
                out.append(Finding(  # is itself a finding, not a crash
                    code="C4", leg="conformance", path=path, obj=name,
                    message=f"spec factory raised "
                            f"{type(e).__name__}: {e}"))
                continue
            out += check_spec(spec, origin=path)
    return out
