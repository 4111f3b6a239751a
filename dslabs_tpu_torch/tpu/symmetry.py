"""Symmetry-group permutation tables: the data half of
``dslabs_tpu/tpu/symmetry.py``.

``ProtocolSpec.compile()`` emits a :class:`SymmetrySpec` for a spec that
declares symmetry groups, and the compiled protocol carries it.  The
canonicalize-before-fingerprint pass that reads it comes with the
symmetry and faults slice of the port; until then
``TensorSearch(symmetry=True)`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["SymmetrySpec"]


@dataclasses.dataclass(frozen=True)
class SymmetrySpec:
    """Static permutation tables for one protocol's symmetry groups.

    ``relab``    [P, n_nodes]    relab[p][old_node_id] = new_node_id
    ``lane_src`` [P, node_width] new_nodes[l] = old_nodes[lane_src[p][l]]
    ``groups``   ((kind, base, count), ...)
    ``msg_node_lanes``  message-record lanes holding node ids
    """

    relab: np.ndarray
    lane_src: np.ndarray
    groups: Tuple[Tuple[str, int, int], ...] = ()
    msg_node_lanes: Tuple[int, ...] = (1, 2)

    @property
    def n_perms(self) -> int:
        return int(self.relab.shape[0])
