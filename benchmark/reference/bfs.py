"""Exact breadth-first search over a reference twin, in plain PyTorch.

The search semantics of the checked model, written out once more and
independently of the measured program:

* a state is the twin's node lanes, the partition controller's two lanes
  (cut flag, eras used) when the configuration declares a partition, the
  network as a *set* of message records, one insertion-ordered timer
  queue per node, and an exception code;
* an event is the delivery of a network message (it stays in the set:
  delivery does not consume), the firing of a deliverable timer (it
  leaves its queue), or, with a partition, CUT or HEAL;
* a timer at queue position i is deliverable iff its ``min`` is below
  the smallest ``max`` of the timers queued before it (DSLabs'
  TimerQueue partial order); a message is deliverable unless a cut
  separates the blocks of its sender and its receiver (nodes in no block
  are never cut off);
* the sends of a step are set-inserted into the network (a duplicate of
  a record already there adds nothing), the timers it sets are appended
  to their node's queue; a full network or queue is an error, never a
  silent drop;
* the BFS counts every state within ``max_depth`` events of the root
  once: ``explored`` counts every enabled (state, event) pair of the
  expanded levels, ``unique`` the distinct states, root included.  A
  successor with an exception code ends the search EXCEPTION_THROWN, one
  that breaks an invariant INVARIANT_VIOLATED, at that level.

The network's canonical order is by a 62-bit hash of each record, with
equal hashes of unequal records a loud error; states are deduplicated by
two independent 64-bit hashes of all their lanes, and two states that
share the first but not the second is again a loud error.  With
``key_bits`` the visited set keeps only that many bits of the first hash
and trusts them: the lossy table of the benchmark's control.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from reference.twin import SENTINEL

_M62 = (1 << 62) - 1
_I64_MAX = (1 << 63) - 1


class ReferenceError(RuntimeError):
    """A capacity the configuration fixes was exceeded, or the
    reference's own hashes collided: the reference has no answer."""


@dataclasses.dataclass(frozen=True)
class Partition:
    """A one-schedule partition: ``blocks`` of node indices, cut at most
    ``max_eras`` times, starting healed."""

    blocks: Sequence[Sequence[int]]
    max_eras: int = 1


@dataclasses.dataclass
class Result:
    """One search's answer: what the comparison reads."""

    end_condition: str
    depth: int
    unique: int
    explored: int
    # (depth, explored so far, unique so far) after each level.
    levels: List[tuple]


def _odd_constants(gen: torch.Generator, n: int) -> torch.Tensor:
    hi = torch.randint(0, 1 << 31, (n,), generator=gen, dtype=torch.int64)
    lo = torch.randint(0, 1 << 31, (n,), generator=gen, dtype=torch.int64)
    return (hi << 32) ^ (lo << 1) ^ 1


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A fixed int64 bit mixer (wrapping multiplies, arithmetic shifts)."""
    x = x ^ (x >> 31)
    x = x * -0x40A7B892E31B1A47
    x = x ^ (x >> 29)
    x = x * -0x6B2FB644ECCEEE15
    return x ^ (x >> 32)


class ReferenceSearch:
    """Exact BFS over ``twin`` (a :class:`reference.twin.TwinSpec`) with
    an optional :class:`Partition`, on ``device``.  ``block_pairs``
    bounds the (state, event) pairs stepped at once."""

    def __init__(self, twin, partition: Optional[Partition] = None,
                 device="cpu", block_pairs: int = 1 << 16,
                 key_bits: Optional[int] = None):
        self.t = twin
        self.part = partition
        self.dev = torch.device(device)
        self.block_pairs = int(block_pairs)
        self.key_bits = key_bits
        t = twin
        self.nn, self.cap, self.tcap = t.n_nodes, t.net_cap, t.timer_cap
        self.mw, self.tw = t.msg_width, t.timer_width
        self.n_flt = 2 if partition is not None else 0
        self.width = (t.node_width + self.n_flt + self.cap * self.mw
                      + self.nn * self.tcap * self.tw + 1)
        gen = torch.Generator().manual_seed(0x5EED_0F_BF5)
        self._msg_a = _odd_constants(gen, self.mw).to(self.dev)
        self._a1 = _odd_constants(gen, self.width).to(self.dev)
        self._a2 = _odd_constants(gen, self.width).to(self.dev)
        self._lane = (torch.arange(self.width, dtype=torch.int64)
                      * 0x2545F4914F6CDD1D).to(self.dev)
        blk = np.full((self.nn,), -1, np.int64)
        if partition is not None:
            for b, nodes in enumerate(partition.blocks):
                blk[list(nodes)] = b
        self._blk = torch.as_tensor(blk, device=self.dev)

    # ------------------------------------------------------------ states

    def initial(self) -> Dict[str, torch.Tensor]:
        """The twin's initial state, batch 1."""
        t, dev = self.t, self.dev
        nodes = torch.as_tensor(np.asarray(t.init_nodes()),
                                dtype=torch.int32, device=dev)[None]
        msgs = torch.as_tensor(np.asarray(t.init_messages()),
                               dtype=torch.int32, device=dev)
        net = torch.full((1, self.cap, self.mw), SENTINEL,
                         dtype=torch.int32, device=dev)
        net = self._set_insert(net, msgs[None])
        tms = torch.as_tensor(np.asarray(t.init_timers()),
                              dtype=torch.int32, device=dev)
        timers = torch.full((1, self.nn, self.tcap, self.tw), SENTINEL,
                            dtype=torch.int32, device=dev)
        timers = self._append_timers(timers, tms[None])
        return {"nodes": nodes,
                "flt": torch.zeros((1, self.n_flt), dtype=torch.int32,
                                   device=dev),
                "net": net, "timers": timers,
                "exc": torch.zeros((1,), dtype=torch.int32, device=dev)}

    def flat(self, st: dict) -> torch.Tensor:
        n = st["nodes"].shape[0]
        return torch.cat([st["nodes"], st["flt"],
                          st["net"].reshape(n, -1),
                          st["timers"].reshape(n, -1),
                          st["exc"].reshape(n, 1)], dim=1)

    @staticmethod
    def _take(st: dict, idx: torch.Tensor) -> dict:
        return {k: v[idx] for k, v in st.items()}

    @staticmethod
    def _cat(parts: List[dict]) -> dict:
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    # ------------------------------------------------- network and timers

    def _msg_keys(self, msgs: torch.Tensor) -> torch.Tensor:
        x = _mix(msgs.to(torch.int64) + self._lane[:self.mw])
        return _mix((x * self._msg_a).sum(-1)) & _M62

    def _set_insert(self, net: torch.Tensor, sends: torch.Tensor
                    ) -> torch.Tensor:
        """Set-insert ``sends`` [P, S, MW] into ``net`` [P, CAP, MW]."""
        p = net.shape[0]
        allm = torch.cat([net, sends.to(torch.int32)], dim=1)
        empty = allm[:, :, 0] == SENTINEL
        key = torch.where(empty, _I64_MAX, self._msg_keys(allm))
        ks, order = torch.sort(key, dim=1, stable=True)
        rows = allm.gather(1, order[:, :, None].expand_as(allm))
        empty_s = ks == _I64_MAX
        same_row = torch.all(rows[:, 1:] == rows[:, :-1], dim=2)
        clash = (ks[:, 1:] == ks[:, :-1]) & ~same_row & ~empty_s[:, 1:]
        if bool(clash.any()):
            raise ReferenceError("reference: two message records share "
                                 "a hash")
        keep = ~empty_s
        keep[:, 1:] &= ~same_row
        count = keep.sum(1)
        if bool((count > self.cap).any()):
            raise ReferenceError(f"reference: network set over its "
                                 f"capacity {self.cap}")
        pos = torch.cumsum(keep.to(torch.int64), 1) - 1
        dest = torch.where(keep, pos, self.cap)
        out = torch.full((p, self.cap + 1, self.mw), SENTINEL,
                         dtype=torch.int32, device=net.device)
        out.scatter_(1, dest[:, :, None].expand_as(rows), rows)
        return out[:, :self.cap]

    def _append_timers(self, timers: torch.Tensor, sets: torch.Tensor
                       ) -> torch.Tensor:
        """Append each valid set row (lane 0 = node) of ``sets``
        [P, MS, 1+TW], in order, to its node's queue in ``timers``."""
        q = timers.clone()
        ar = torch.arange(q.shape[0], device=q.device)
        for s in range(sets.shape[1]):
            node = sets[:, s, 0]
            valid = node != SENTINEL
            if not bool(valid.any()):
                continue
            nd = torch.where(valid, node, 0).to(torch.int64)
            cnt = (q[ar, nd, :, 0] != SENTINEL).sum(1)
            if bool((valid & (cnt >= self.tcap)).any()):
                raise ReferenceError(f"reference: timer queue over its "
                                     f"capacity {self.tcap}")
            sel = torch.nonzero(valid).squeeze(1)
            q[sel, nd[sel], cnt[sel]] = sets[sel, s, 1:].to(torch.int32)
        return q

    def _deliverable_timers(self, timers: torch.Tensor) -> torch.Tensor:
        """[N, NN, T, TW] -> [N, NN, T] bool (the partial order)."""
        occ = timers[..., 0] != SENTINEL
        mx = torch.where(occ, timers[..., 2], SENTINEL).to(torch.int64)
        before = torch.cummin(mx, dim=-1).values
        before = torch.cat([torch.full_like(before[..., :1], _I64_MAX),
                            before[..., :-1]], dim=-1)
        return occ & (timers[..., 1].to(torch.int64) < before)

    def _deliverable_msgs(self, st: dict) -> torch.Tensor:
        net = st["net"]
        ok = net[:, :, 0] != SENTINEL
        if self.part is not None:
            frm = net[:, :, 1].clamp(0, self.nn - 1).to(torch.int64)
            to = net[:, :, 2].clamp(0, self.nn - 1).to(torch.int64)
            bf, bt = self._blk[frm], self._blk[to]
            cross = (bf >= 0) & (bt >= 0) & (bf != bt)
            ok = ok & ~((st["flt"][:, 0] > 0)[:, None] & cross)
        return ok

    def _fault_ok(self, st: dict) -> torch.Tensor:
        """[N, 2] enabled CUT, HEAL."""
        cut, eras = st["flt"][:, 0], st["flt"][:, 1]
        return torch.stack([(cut == 0) & (eras < self.part.max_eras),
                            cut > 0], dim=1)

    # ------------------------------------------------------------- steps

    def _after(self, st: dict, par, nodes2, sends, sets, exc, timers):
        return {"nodes": nodes2.to(torch.int32), "flt": st["flt"][par],
                "net": self._set_insert(st["net"][par], sends),
                "timers": self._append_timers(timers, sets),
                "exc": exc.to(torch.int32).reshape(-1)}

    def _step_msgs(self, st: dict, par, slot) -> dict:
        msg = st["net"][par, slot]
        out = self.t.step_message(st["nodes"][par], msg)
        nodes2, sends, sets = out[:3]
        exc = out[3] if len(out) > 3 else torch.zeros_like(par)
        return self._after(st, par, nodes2, sends, sets, exc,
                           st["timers"][par])

    def _step_timers(self, st: dict, par, node, pos) -> dict:
        q = st["timers"][par].clone()
        ar = torch.arange(par.shape[0], device=par.device)
        qn = q[ar, node]                                  # [P, T, TW]
        timer = qn[ar, pos]
        shifted = torch.cat([qn[:, 1:], torch.full_like(qn[:, :1],
                                                        SENTINEL)], dim=1)
        later = (torch.arange(self.tcap, device=par.device)[None, :]
                 >= pos[:, None])
        q[ar, node] = torch.where(later[:, :, None], shifted, qn)
        out = self.t.step_timer(st["nodes"][par], node.to(torch.int32),
                                timer)
        nodes2, sends, sets = out[:3]
        exc = out[3] if len(out) > 3 else torch.zeros_like(par)
        return self._after(st, par, nodes2, sends, sets, exc, q)

    def _step_faults(self, st: dict, par, which) -> dict:
        flt = st["flt"][par].clone()
        cut = which == 0
        flt[:, 0] = torch.where(cut, 1, 0).to(torch.int32)
        flt[:, 1] = flt[:, 1] + cut.to(torch.int32)
        return {"nodes": st["nodes"][par], "flt": flt,
                "net": st["net"][par], "timers": st["timers"][par],
                "exc": torch.zeros_like(st["exc"][par])}

    def _pairs(self, st: dict):
        """Every enabled (state, event) pair of the batch ``st``, as
        (kind, index tensors): message pairs (state, slot), timer pairs
        (state, node, position), fault pairs (state, 0 = CUT / 1 =
        HEAL)."""
        m = torch.nonzero(self._deliverable_msgs(st))
        t = torch.nonzero(self._deliverable_timers(st["timers"]))
        out = [("msg", m[:, 0], (m[:, 1],)),
               ("timer", t[:, 0], (t[:, 1], t[:, 2]))]
        if self.part is not None:
            f = torch.nonzero(self._fault_ok(st))
            out.append(("fault", f[:, 0], (f[:, 1],)))
        return out

    def _step(self, st: dict, kind: str, par, args) -> dict:
        if kind == "msg":
            return self._step_msgs(st, par, *args)
        if kind == "timer":
            return self._step_timers(st, par, *args)
        return self._step_faults(st, par, *args)

    def successors(self, st: dict):
        """Yield (kind, parent index, event args, successor batch) over
        every enabled pair of ``st``, at most ``block_pairs`` at a time."""
        for kind, par, args in self._pairs(st):
            for s in range(0, par.shape[0], self.block_pairs):
                sl = slice(s, s + self.block_pairs)
                p, a = par[sl], tuple(x[sl] for x in args)
                yield kind, p, a, self._step(st, kind, p, a)

    # ------------------------------------------------------------- walks

    def events(self, st: dict) -> list:
        """The enabled events of the batch-1 state ``st`` in a canonical
        order, each as a descriptor that names it by content: ("msg",
        record), ("timer", node, position) or ("fault", "CUT" / "HEAL")."""
        out = []
        for kind, par, args in self._pairs(st):
            if kind == "msg":
                recs = st["net"][0, args[0]].tolist()
                out += [("msg", tuple(r)) for r in sorted(recs)]
            elif kind == "timer":
                out += sorted(("timer", int(a), int(b))
                              for a, b in zip(args[0].tolist(),
                                              args[1].tolist()))
            else:
                out += [("fault", ("CUT", "HEAL")[int(w)])
                        for w in args[0].tolist()]
        return out

    def apply(self, st: dict, ev) -> dict:
        """The successor of the batch-1 state ``st`` by descriptor ``ev``."""
        dev = self.dev
        par = torch.zeros((1,), dtype=torch.int64, device=dev)

        def one(v):
            return torch.full((1,), int(v), dtype=torch.int64, device=dev)

        if ev[0] == "msg":
            rec = torch.as_tensor(ev[1], dtype=torch.int32, device=dev)
            hit = torch.nonzero(torch.all(st["net"][0] == rec, dim=1))
            if hit.numel() != 1:
                raise ReferenceError(f"reference: no message {ev[1]}")
            return self._step_msgs(st, par, one(hit[0, 0]))
        if ev[0] == "timer":
            return self._step_timers(st, par, one(ev[1]), one(ev[2]))
        return self._step_faults(st, par, one(("CUT", "HEAL").index(ev[1])))

    def walk(self, events: list) -> dict:
        """The initial state advanced by ``events`` (descriptors)."""
        st = self.initial()
        for ev in events:
            st = self.apply(st, ev)
        return st

    # -------------------------------------------------------------- keys

    def state_keys(self, st: dict) -> list:
        """The exact keys of a batch's states, as host tuples."""
        k1, k2 = self._keys(st)
        return list(zip(k1.tolist(), k2.tolist()))

    def _keys(self, st: dict):
        flat = self.flat(st)
        h1 = torch.zeros(flat.shape[0], dtype=torch.int64, device=self.dev)
        h2 = torch.zeros_like(h1)
        for b in range(0, self.width, 256):
            x = _mix(flat[:, b:b + 256].to(torch.int64)
                     + self._lane[b:b + 256])
            h1 = h1 + (x * self._a1[b:b + 256]).sum(1)
            h2 = h2 + (x * self._a2[b:b + 256]).sum(1)
        h1, h2 = _mix(h1), _mix(h2)
        if self.key_bits is not None:
            return h1 & ((1 << self.key_bits) - 1), torch.zeros_like(h2)
        return h1, h2

    def _fresh(self, vis, k1, k2) -> torch.Tensor:
        """Mark the keys of ``(k1, k2)`` that are in neither ``vis``
        (sorted (h1, h2)) nor earlier in the batch, and add them to
        ``vis`` in place; -> [P] bool."""
        exact = self.key_bits is None
        s1, perm = torch.sort(k1, stable=True)
        s2 = k2[perm]
        first = torch.ones_like(s1, dtype=torch.bool)
        same = s1[1:] == s1[:-1]
        first[1:] = ~same
        if exact and bool((same & (s2[1:] != s2[:-1])).any()):
            raise ReferenceError("reference: two states share a key")
        c1, c2, cidx = s1[first], s2[first], perm[first]
        v1, v2 = vis
        pos = torch.searchsorted(v1, c1)
        posc = pos.clamp(max=max(v1.shape[0] - 1, 0))
        found = (pos < v1.shape[0]) & (v1[posc] == c1)
        if exact and bool((found & (v2[posc] != c2)).any()):
            raise ReferenceError("reference: two states share a key")
        new = ~found
        m1 = torch.cat([v1, c1[new]])
        m2 = torch.cat([v2, c2[new]])
        m1, o = torch.sort(m1, stable=True)
        vis[0], vis[1] = m1, m2[o]
        mask = torch.zeros_like(k1, dtype=torch.bool)
        mask[cidx[new]] = True
        return mask

    # ------------------------------------------------------------ search

    def search(self, root: dict, max_depth: int) -> Result:
        """BFS of every state within ``max_depth`` events of ``root``."""
        k1, k2 = self._keys(root)
        vis = [k1, k2]
        frontier = root
        explored, unique = 0, 1
        levels = []
        for depth in range(1, max_depth + 1):
            last = depth == max_depth
            before = unique
            parts = []
            for _kind, _par, _args, succ in self.successors(frontier):
                explored += int(succ["exc"].shape[0])
                end = self._terminal(succ)
                if end is not None:
                    return Result(end, depth, unique, explored, levels)
                new = self._fresh(vis, *self._keys(succ))
                unique += int(new.sum())
                if not last:
                    parts.append(self._take(succ, torch.nonzero(new)
                                            .squeeze(1)))
            levels.append((depth, explored, unique))
            if last:
                return Result("DEPTH_EXHAUSTED" if unique > before
                              else "SPACE_EXHAUSTED", depth, unique,
                              explored, levels)
            if unique == before:
                return Result("SPACE_EXHAUSTED", depth, unique, explored,
                              levels)
            frontier = self._cat(parts)
            del parts
        return Result("SPACE_EXHAUSTED", 0, unique, explored, levels)

    def _terminal(self, succ: dict) -> Optional[str]:
        if bool((succ["exc"] != 0).any()):
            return "EXCEPTION_THROWN"
        for fn in self.t.invariants.values():
            if not bool(fn({"nodes": succ["nodes"]}).all()):
                return "INVARIANT_VIOLATED"
        return None
