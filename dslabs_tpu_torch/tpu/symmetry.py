"""Symmetry reduction: canonical ordering of interchangeable node ids.  The
counterpart of ``dslabs_tpu/tpu/symmetry.py``.

A spec that declares ``symmetry=("acceptor", ...)`` marks those node
kinds' instances as interchangeable: any permutation of the group is an
automorphism of the transition system, so every permutation image of a
reachable state behaves the same and one representative per orbit covers
them all.

``ProtocolSpec.compile()`` turns the declaration into a
:class:`SymmetrySpec` (static permutation tables over the node lanes and
the node-id relabel map).  :func:`build_canonicalizer` turns the tables
into the pass the engine runs right before fingerprinting when
``TensorSearch(symmetry=True)`` asks for it (default off: canonical
unique counts differ from raw counts by design):

  for each permutation p:  candidate_p = apply(p, rows)
      - node lanes gather through the static lane_src table,
      - the from/to lanes of occupied message records relabel through
        the relab map and the network re-sorts to canonical order,
      - per-node timer queues move with their nodes,
      - the exception lane rides along unchanged;
  canonical(rows) = lexicographic min over the candidates.

Only the fingerprint sees the canonical form: stored rows stay the real
states, so witnesses, traces and predicate flags replay on reachable
states.  The pass is plain PyTorch, as the reference's is plain ``jnp``;
it keeps a running minimum over the permutations and never holds more
than one candidate batch.

Scope, as in the reference: the from/to lanes of the compiler's uniform
message records are relabelled; message and timer payload fields that
carry raw node ids are not.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

__all__ = ["SymmetrySpec", "build_canonicalizer"]


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


def build_canonicalizer(protocol, offsets) -> Callable:
    """Compile ``protocol.symmetry`` into the canonicalize pass
    ``fn(rows [N, lanes] int32) -> [N, lanes] int32`` on the rows'
    device.  ``offsets`` is the engine's ``(o_net, o_timers, o_exc)``
    split of a flat row."""
    from dslabs_tpu_torch.tpu.engine import (SENTINEL, _row_less,
                                             canonicalize_net_batched)

    sym: SymmetrySpec = protocol.symmetry
    if sym is None:
        raise ValueError(f"{protocol.name}: no symmetry groups declared")
    p = protocol
    o0, o1, o2 = offsets
    nn = p.n_nodes
    relab = np.asarray(sym.relab, np.int64)
    lane_src = np.asarray(sym.lane_src, np.int64)
    n_perms = relab.shape[0]
    # Timer-axis gather: new_timers[j] = old_timers[inv[j]] where
    # relab[old] = new  =>  inv[new] = old.
    inv = np.zeros_like(relab)
    for k in range(n_perms):
        inv[k][relab[k]] = np.arange(nn)
    node_lanes = [lane for lane in range(p.msg_width)
                  if lane in sym.msg_node_lanes]
    # Which parts permutation k moves (the identity parts are skipped).
    moves = [(not (lane_src[k] == np.arange(o0)).all(),
              not (relab[k] == np.arange(nn)).all(),
              not (inv[k] == np.arange(nn)).all())
             for k in range(n_perms)]
    tables = {}

    def on(dev):
        t = tables.get(dev)
        if t is None:
            t = tables[dev] = tuple(
                torch.as_tensor(a, device=dev)
                for a in (lane_src, relab.astype(np.int32), inv))
        return t

    def _apply(rows, k, t):
        n = rows.shape[0]
        t_src, t_rel, t_inv = t
        move_nodes, move_net, move_timers = moves[k]
        nodes = rows[:, :o0]
        if move_nodes:
            nodes = nodes.index_select(1, t_src[k])
        net = rows[:, o0:o1].reshape(n, p.net_cap, p.msg_width)
        if move_net:
            occ = net[:, :, 0] != SENTINEL
            net = net.clone()
            for lane in node_lanes:
                col = net[:, :, lane]
                # The reference's one-hot relabel: an id outside
                # [0, n_nodes) maps to 0.
                new = torch.where((col >= 0) & (col < nn),
                                  t_rel[k][col.clamp(0, nn - 1).long()], 0)
                net[:, :, lane] = torch.where(occ, new, col)
            # Relabelled records break the sorted-set order: re-sort, so
            # equal sets hash equal.
            net = canonicalize_net_batched(net)
        timers = rows[:, o1:o2].reshape(n, nn, p.timer_cap, p.timer_width)
        if move_timers:
            timers = timers.index_select(1, t_inv[k])
        return torch.cat([nodes, net.reshape(n, -1), timers.reshape(n, -1),
                          rows[:, o2:o2 + 1]], dim=1)

    def canonicalize(rows):
        # Permutation 0 is the identity (the compiler orders it first):
        # candidate 0 is the input itself.
        t = on(rows.device)
        best = rows
        for k in range(1, n_perms):
            cand = _apply(rows, k, t)
            best = torch.where(_row_less(cand, best)[:, None], cand, best)
        return best

    return canonicalize
