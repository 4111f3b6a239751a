"""Node addresses.

Re-design of the reference's Address hierarchy (framework/src/dslabs/framework/
Address.java:41-104): an opaque, totally-ordered, immutable identifier.  Tests
use string-named LocalAddress; node hierarchies (lab4 sub-nodes) use SubAddress
printed ``parent/id``.
"""

from __future__ import annotations

import functools
from typing import Optional

from dslabs_tpu_torch.utils.structural import ImmutableMarker

__all__ = ["Address", "LocalAddress", "SubAddress", "sub_address", "root_address"]


@functools.total_ordering
class Address(ImmutableMarker):
    """Base address.  Compares by string representation, like the reference's
    ``compareTo`` over ``toString`` ordering (Address.java:47-56)."""

    __slots__ = ()

    def root_address(self) -> "Address":
        return self

    def __lt__(self, other: "Address") -> bool:
        return str(self) < str(other)

    def __eq__(self, other) -> bool:
        return isinstance(other, Address) and str(self) == str(other)

    def __hash__(self) -> int:
        return hash(str(self))

    def __deepcopy__(self, memo):
        return self  # immutable

    def __sfreeze__(self):
        # Canonical frozen form for structural hashing: the printed name is
        # the identity (equality/ordering are string-based above).
        return str(self)

    def __repr__(self) -> str:
        return str(self)


class LocalAddress(Address):
    """String-named address used by tests (testing/LocalAddress.java:33-54)."""

    __slots__ = ("_name",)

    def __init__(self, name: str):
        self._name = name

    def __str__(self) -> str:
        return self._name

    # pickle support despite __slots__
    def __getstate__(self):
        return self._name

    def __setstate__(self, state):
        self._name = state


class SubAddress(Address):
    """Address of a sub-node: ``parent/id`` (Address.java:60-104)."""

    __slots__ = ("_parent", "_id")

    def __init__(self, parent: Address, sub_id: str):
        self._parent = parent
        self._id = sub_id

    @property
    def parent(self) -> Address:
        return self._parent

    @property
    def sub_id(self) -> str:
        return self._id

    def root_address(self) -> Address:
        return self._parent.root_address()

    def __str__(self) -> str:
        return f"{self._parent}/{self._id}"

    def __getstate__(self):
        return (self._parent, self._id)

    def __setstate__(self, state):
        self._parent, self._id = state


def sub_address(parent: Address, sub_id: str) -> SubAddress:
    return SubAddress(parent, sub_id)


def root_address(address: Optional[Address]) -> Optional[Address]:
    return None if address is None else address.root_address()
