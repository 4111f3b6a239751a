"""Structural equality, hashing, and cloning for protocol state.

The reference framework (dslabs, Java) requires every piece of node state to
implement equals/hashCode and be deep-clonable (framework/src/dslabs/framework/
Node.java:50-101, framework/tst/.../utils/Cloning.java:64-159).  The model
checker's visited set keys on that equality.

In this rebuild, protocol objects are ordinary Python objects; this module
supplies the structural primitives:

  * ``sfreeze(obj)``   -> a canonical, hashable "frozen" form of an object graph
                          (order-insensitive for dicts/sets, order-sensitive for
                          lists/tuples).  Two objects are search-equivalent iff
                          their frozen forms are equal.
  * ``shash(obj)``     -> hash of the frozen form (memoised per call tree).
  * ``clone(obj)``     -> deep clone (copy.deepcopy with a shared memo guard);
                          fields named with a leading underscore on framework
                          classes are treated like Java ``transient`` fields and
                          excluded from equality/hash (but still deep-copied
                          unless the class opts out via ``__deepcopy_skip__``).

Classes participate by inheriting :class:`StructEq`, which derives
``__eq__``/``__hash__`` from the public instance ``__dict__`` (every attribute
whose name does not start with ``_``).  This mirrors Lombok's
``@EqualsAndHashCode`` used pervasively in the reference.
"""

from __future__ import annotations

import copy
from typing import Any

from dslabs_tpu_torch.utils.flags import GlobalSettings

__all__ = ["sfreeze", "shash", "clone", "StructEq", "ImmutableMarker"]


class ImmutableMarker:
    """Mix-in marking a class as immutable: clone() returns it unchanged.

    Mirrors the reference's ``@Immutable`` short-circuit in its cloning layer
    (framework/tst/.../utils/Cloning.java:64-141), used by e.g. LocalAddress.
    """


def _public_items(obj: Any):
    d = obj.__dict__
    return [(k, v) for k, v in d.items() if not k.startswith("_")]


def _slot_items(obj: Any):
    """Public values stored in __slots__ across the MRO (objects like Address
    keep their state in slots, not __dict__)."""
    items = []
    for cls in type(obj).__mro__:
        for name in getattr(cls, "__slots__", ()):
            if name.startswith("__"):
                continue
            try:
                items.append((name, getattr(obj, name)))
            except AttributeError:
                pass
    return items


def sfreeze(obj: Any) -> Any:
    """Return a canonical hashable representation of ``obj``.

    dicts and sets freeze order-insensitively (like Java HashMap/HashSet
    hashCodes); lists/tuples keep order.  Objects with ``StructEq`` freeze as
    (class, frozen public fields).  A class may define ``__sfreeze__`` to
    supply its own canonical form.
    """
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return obj
    custom = getattr(obj, "__sfreeze__", None)
    if custom is not None:
        return (type(obj).__qualname__, custom())
    if isinstance(obj, (list, tuple)):
        return ("#l", tuple(sfreeze(x) for x in obj))
    if isinstance(obj, dict):
        return ("#d", frozenset((sfreeze(k), sfreeze(v)) for k, v in obj.items()))
    if isinstance(obj, (set, frozenset)):
        return ("#s", frozenset(sfreeze(x) for x in obj))
    if isinstance(obj, StructEq):
        # Use the class's equality fields so customised equality (e.g.
        # ClientWorker's (client, results)) shapes nested hashing too.
        return (type(obj).__qualname__, ("#d", frozenset(
            (k, sfreeze(v)) for k, v in obj._eq_fields().items())))
    if hasattr(obj, "__dict__") or hasattr(type(obj), "__slots__"):
        # Plain objects (e.g. dataclasses, slotted classes): structural over
        # public __dict__ entries plus public slot values.
        fields = _public_items(obj) if hasattr(obj, "__dict__") else []
        fields += _slot_items(obj)
        return (type(obj).__qualname__, ("#d", frozenset(
            (k, sfreeze(v)) for k, v in fields)))
    # Fall back to the object's own hashability (enums, etc).
    return obj


def shash(obj: Any) -> int:
    return hash(sfreeze(obj))


def clone(obj: Any):
    """Deep-clone an object graph.

    Equivalent role to the reference's Cloning.clone (utils/Cloning.java:109-141):
    used for clone-on-send and copy-on-write successor states.  Immutable-marked
    objects are returned as-is.  Under ``do_error_checks`` every clone is
    verified equal-and-hash-consistent with its original and failures are
    routed to the CheckLogger (Cloning.java:130-138).
    """
    if obj is None or isinstance(obj, (bool, int, float, str, bytes, ImmutableMarker)):
        return obj
    out = copy.deepcopy(obj)
    if GlobalSettings.do_error_checks():
        from dslabs_tpu_torch.utils.check_logger import CheckLogger

        try:
            eq = bool(out == obj)
        except Exception:  # noqa: BLE001 — incomparable (e.g. array-valued
            eq = None      # __eq__); cannot judge, not a conformance finding
        if eq is False:
            CheckLogger.clone_not_equal(obj)
        elif eq:
            try:
                if shash(out) != shash(obj):
                    CheckLogger.hash_inconsistent(obj)
            except Exception:  # noqa: BLE001 — unhashable: nothing to check
                pass
    return out


class StructEq:
    """Structural equality/hash over public instance attributes.

    Attributes starting with ``_`` are excluded (Java ``transient`` analog: the
    reference nulls transient fields before comparing/cloning,
    utils/Cloning.java:80-104).  Subclasses may extend/override
    ``_eq_fields()`` to customise (e.g. ClientWorker compares only
    (client, results), ClientWorker.java:49-52).
    """

    def _eq_fields(self):
        return {k: v for k, v in self.__dict__.items() if not k.startswith("_")}

    def __eq__(self, other: Any) -> bool:
        if self is other:
            return True
        if type(self) is not type(other):
            return NotImplemented
        return self._eq_fields() == other._eq_fields()

    def __ne__(self, other: Any) -> bool:
        r = self.__eq__(other)
        return r if r is NotImplemented else not r

    def __hash__(self) -> int:
        return hash((type(self).__qualname__, frozenset(
            (k, sfreeze(v)) for k, v in self._eq_fields().items())))

    def __deepcopy__(self, memo):
        cls = self.__class__
        new = cls.__new__(cls)
        memo[id(self)] = new
        skip = getattr(self, "__deepcopy_skip__", ())
        for k, v in self.__dict__.items():
            if k in skip:
                setattr(new, k, None)
            else:
                setattr(new, k, copy.deepcopy(v, memo))
        return new

    def __repr__(self) -> str:  # debugger-friendly default
        fields = ", ".join(f"{k}={v!r}" for k, v in self._eq_fields().items())
        return f"{type(self).__name__}({fields})"
