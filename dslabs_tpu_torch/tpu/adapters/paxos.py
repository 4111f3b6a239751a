"""Lab 3 multi-Paxos twin adapter: object search configurations ->
tensor twin bindings for the harness search backend (tpu/backend.py);
counterpart of ``dslabs_tpu/tpu/adapters/paxos.py``.

Recognises a ``SearchState`` whose servers are all ``PaxosServer`` and
whose client workers drive ``PaxosClient`` with finite KV workloads, and
binds it to ``make_paxos_protocol`` with:

- twin node indices: ``server{i+1}`` -> i, ``client{c+1}`` -> n + c
  (the parity-test naming, tests/test_tpu_engine.py);
- command ids: client ``c``'s k-th workload command (1-based seq) ->
  ``c * w + k`` (the twin's ``cmd_id``); 0 = the no-op hole filler;
- lane predicates for the lab 3 predicate library (log statuses and
  consistency mirror PaxosServer.status/command semantics,
  labs/paxos/paxos.py:210-233, on the packed lanes of
  ``paxos_layout``);
- object decoders for trace replay (tpu/trace.py): every tensor message
  record maps to the exact object Message — the twin models every field
  except the ``PaxosReply`` RESULT VALUE, which is resolved from the
  replayed object state's own network via a MessageTemplate (the object
  execution is the source of truth for application values).

**Value-collapse argument** (why result-blind lanes give the same
verdicts): client workloads are sequential, so a client's k-th result is
produced by executing the agreed log prefix up to its command's slot —
a deterministic function of lanes the twin DOES model (log contents +
executed_through + per-client seq).  ``RESULTS_OK``-class predicates can
therefore only fire on states whose log/exec lanes already differ, and
on this repo's (correct) lab 3 implementation they fire on neither
backend.  The bounded-depth parity tests (tests/test_search_backend.py)
pin the unique-state counts of both backends against each other under
the actual lab settings, which is what guards this argument in CI.

Lane predicates take a leading batch dimension: each maps a state batch
(``nodes`` [N, NW]) to [N] bool.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch

from dslabs_tpu_torch.tpu.backend import (NoTensorTwin, TwinBinding,
                                    register_adapter)

__all__ = ["PaxosBinding"]


def _workload_pairs(worker, addr):
    wl = copy.deepcopy(worker.workload)
    wl.reset()
    if wl.infinite():
        raise NoTensorTwin("infinite workloads have no tensor twin")
    return [wl._next_pair(addr) for _ in range(wl.size())]


def _num_suffix(name: str, prefix: str) -> Optional[int]:
    if not name.startswith(prefix):
        return None
    try:
        return int(name[len(prefix):])
    except ValueError:
        return None


class PaxosBinding(TwinBinding):

    def __init__(self, state):
        from dslabs_tpu_torch.tpu.specs_lab3 import paxos_layout

        servers = sorted(state.servers,
                         key=lambda a: _num_suffix(str(a), "server") or 0)
        clients = sorted(state.client_workers(),
                         key=lambda a: _num_suffix(str(a), "client") or 0)
        self.n = len(servers)
        self.nc = len(clients)
        self.server_names = [str(a) for a in servers]
        self.client_names = [str(a) for a in clients]
        self.addr_index = {s: i for i, s in enumerate(self.server_names)}
        self.addr_index.update(
            {c: self.n + j for j, c in enumerate(self.client_names)})
        workers = state.client_workers()
        pairs = [_workload_pairs(workers[a], a) for a in clients]
        sizes = {len(p) for p in pairs}
        if len(sizes) != 1:
            raise NoTensorTwin(
                f"per-client workload sizes differ ({sizes}); the twin "
                "models a uniform per-client command count")
        self.w = sizes.pop()
        self.S = self.w * self.nc
        # command object -> twin cmd ids (clients may send EQUAL raw
        # commands — each occurrence has its own id; has_command matches
        # any of them, exactly the object predicate's equality)
        self.cmd_ids: Dict[object, list] = {}
        self.cmd_objs: Dict[int, object] = {}
        self.results: Dict[int, object] = {}
        for c, plist in enumerate(pairs):
            for k, (cmd, res) in enumerate(plist, start=1):
                cid = c * self.w + k
                self.cmd_ids.setdefault(cmd, []).append(cid)
                self.cmd_objs[cid] = cmd
                if res is not None:
                    self.results[cid] = res
        self.L = paxos_layout(self.n, self.nc, self.S)
        self.key = ("paxos", self.n, self.nc, self.w, self.S,
                    tuple(self.server_names), tuple(self.client_names),
                    tuple(repr(self.cmd_objs[i])
                          for i in sorted(self.cmd_objs)))

    def initial_caps(self):
        return 32, 6

    # ------------------------------------------------------------ protocol

    def build_protocol(self, net_cap, timer_cap):
        import dataclasses

        from dslabs_tpu_torch.tpu.specs_lab3 import make_paxos_protocol

        p = make_paxos_protocol(n=self.n, n_clients=self.nc, w=self.w,
                                max_slots=self.S, net_cap=net_cap,
                                timer_cap=timer_cap)
        return dataclasses.replace(
            p, decode_message=self._decode_message,
            decode_timer=self._decode_timer)

    # ------------------------------------------------------------ decoders

    def _addr(self, idx: int):
        from dslabs_tpu_torch.core.address import LocalAddress

        names = self.server_names + self.client_names
        return LocalAddress(names[int(idx)])

    def _ballot(self, b: int):
        return (int(b) // self.n, int(b) % self.n)

    def _amo(self, cid: int):
        from dslabs_tpu_torch.labs.clientserver.amo import AMOCommand

        cid = int(cid)
        c, k = (cid - 1) // self.w, (cid - 1) % self.w + 1
        from dslabs_tpu_torch.core.address import LocalAddress

        return AMOCommand(self.cmd_objs[cid],
                          LocalAddress(self.client_names[c]), k)

    def _decode_message(self, rec):
        from dslabs_tpu_torch.labs.clientserver.amo import AMOResult
        from dslabs_tpu_torch.labs.paxos import paxos as P
        from dslabs_tpu_torch.tpu.specs_lab3 import (CREP, CREQ, HB, HBR,
                                                    P1A, P1B, P2A, P2B,
                                                    REPLY, REQ)
        from dslabs_tpu_torch.tpu.trace import MessageTemplate

        r = [int(x) for x in rec]
        tag, frm, to, p = r[0], r[1], r[2], r[3:]
        fa, ta = self._addr(frm), self._addr(to)
        if tag == REQ:
            return fa, ta, P.PaxosRequest(self._amo(p[0] * self.w + p[1]))
        if tag == REPLY:
            cid = p[0] * self.w + p[1]
            seq = (cid - 1) % self.w + 1
            fallback = P.PaxosReply(AMOResult(self.results.get(cid), seq))
            return fa, ta, MessageTemplate(
                P.PaxosReply, fallback,
                lambda m, s=seq: m.result.sequence_num == s)
        if tag == P1A:
            return fa, ta, P.P1a(self._ballot(p[0]))
        if tag == P1B:
            entries = []
            for s in range(1, self.S + 1):
                ex, lb, cmd, ch = _unpack(p[s])
                if ex:
                    entries.append(
                        (s, (self._ballot(lb),
                             self._amo(cmd) if cmd else None, bool(ch))))
            return fa, ta, P.P1b(self._ballot(p[0]), tuple(entries))
        if tag == P2A:
            return fa, ta, P.P2a(self._ballot(p[0]), p[1],
                                 self._amo(p[2]) if p[2] else None)
        if tag == P2B:
            return fa, ta, P.P2b(self._ballot(p[0]), p[1])
        if tag == HB:
            return fa, ta, P.Heartbeat(self._ballot(p[0]), p[1], p[2])
        if tag == HBR:
            return fa, ta, P.HeartbeatReply(self._ballot(p[0]), p[1])
        if tag == CREQ:
            return fa, ta, P.CatchupRequest(p[0])
        if tag == CREP:
            base, count = p[0], p[1]
            ents = tuple(
                (base + k, self._amo(p[2 + k]) if p[2 + k] else None)
                for k in range(count))
            return fa, ta, P.CatchupReply(ents)
        raise NoTensorTwin(f"unknown paxos message tag {tag}")

    def _decode_timer(self, node_idx, rec):
        from dslabs_tpu_torch.labs.paxos import paxos as P
        from dslabs_tpu_torch.tpu.specs_lab3 import (CLIENT_MS,
                                                    ELECTION_MAX,
                                                    ELECTION_MIN,
                                                    HEARTBEAT_MS,
                                                    T_CLIENT, T_ELECTION,
                                                    T_HEARTBEAT)

        tag, p0 = int(rec[0]), int(rec[3])
        a = self._addr(node_idx)
        if tag == T_ELECTION:
            return a, P.ElectionTimer(), ELECTION_MIN, ELECTION_MAX
        if tag == T_HEARTBEAT:
            return (a, P.HeartbeatTimer(self._ballot(p0)), HEARTBEAT_MS,
                    HEARTBEAT_MS)
        if tag == T_CLIENT:
            return a, P.ClientTimer(p0), CLIENT_MS, CLIENT_MS
        raise NoTensorTwin(f"unknown paxos timer tag {tag}")

    # ---------------------------------------------------------- predicates

    def _lane(self, s, i, off):
        return s["nodes"][:, i * self.L["SW"] + off]

    def _log(self, s, i, slot, j):
        # The compiled layout is field-major: each log field owns S
        # consecutive lanes (j: 0=ex, 1=lb, 2=cmd, 3=ch).
        key = ("log.ex", "log.lb", "log.cmd", "log.ch")[j]
        return s["nodes"][:, i * self.L["SW"] + self.L[key] + (slot - 1)]

    def _k(self, s, c):
        return s["nodes"][:, self.n * self.L["SW"] + c]

    def _statuses(self, s, slot):
        """Per-server (cleared, empty, accepted, chosen, cmd) lane bools
        for one slot, mirroring PaxosServer.status/command
        (labs/paxos/paxos.py:210-226)."""
        out = []
        for i in range(self.n):
            cl = self._lane(s, i, 5)
            ex = self._log(s, i, slot, 0) == 1
            ch = self._log(s, i, slot, 3) == 1
            cmd = self._log(s, i, slot, 2)
            cleared = slot <= cl
            out.append((cleared, ~cleared & ~ex, ~cleared & ex & ~ch,
                        ~cleared & ex & ch, cmd))
        return out

    def _slot_valid(self, s, slot):
        """slotValid's live checks on lanes (the status-vs-marker
        consistency checks are definitionally true on the twin): no two
        different chosen commands, and chosen/cleared only with a
        majority accepting (labs/paxos/predicates.py:47-82)."""
        st = self._statuses(s, slot)
        any_chosen = torch.zeros_like(st[0][0])
        any_cleared = torch.zeros_like(st[0][0])
        conflict = torch.zeros_like(st[0][0])
        chosen_cmd = torch.full_like(st[0][4], -1)
        for cleared, empty, acc, ch, cmd in st:
            conflict = conflict | (ch & any_chosen & (cmd != chosen_cmd))
            chosen_cmd = torch.where(ch, cmd, chosen_cmd)
            any_chosen = any_chosen | ch
            any_cleared = any_cleared | cleared
        count = torch.zeros_like(st[0][4])
        for cleared, empty, acc, ch, cmd in st:
            ok = ~empty & (~acc | ~any_chosen | (cmd == chosen_cmd))
            count = count + ok.to(count.dtype)
        quorum = (~(any_chosen | any_cleared)
                  | (2 * count > self.n))
        return ~conflict & quorum

    def predicate(self, tkey):
        kind = tkey[0]
        n, w, S = self.n, self.w, self.S

        def const_true(s):
            # Structurally true on the twin (see the module docstring's
            # value-collapse argument): [N] ones over the batch.
            return torch.ones(s["nodes"].shape[0], dtype=torch.bool,
                              device=s["nodes"].device)

        if kind in ("RESULTS_OK", "RESULTS_LINEARIZABLE",
                    "ALL_RESULTS_SAME", "PAXOS_MARKERS_VALID"):
            # value_level marks predicates the twin cannot falsify — the
            # backend re-checks them object-side on sampled deepest
            # states before trusting an exhaust verdict
            # (backend.tensor_bfs).  Marked ONLY here, not on the shared
            # const_true closure: the out-of-range structural uses below
            # are true on both twins by construction and need no replay.
            fn = lambda s: const_true(s)     # noqa: E731
            fn.value_level = True
            return fn
        if kind == "CLIENTS_DONE":
            def fn(s):
                return torch.stack([self._k(s, c) == w + 1
                                    for c in range(self.nc)]).all(0)
            return fn
        if kind == "NONE_DECIDED":
            def fn(s):
                return torch.stack([self._k(s, c) == 1
                                    for c in range(self.nc)]).all(0)
            return fn
        if kind == "CLIENT_DONE":
            c = self.client_names.index(str(tkey[1].root_address()))
            return lambda s: self._k(s, c) == w + 1
        if kind == "CLIENT_HAS_RESULTS":
            c = self.client_names.index(str(tkey[1].root_address()))
            num = tkey[2]
            return lambda s: self._k(s, c) >= num + 1
        if kind == "PAXOS_SLOT_VALID":
            slot = tkey[1]
            if not 1 <= slot <= S:
                return const_true       # out-of-range slots stay EMPTY
            return lambda s: self._slot_valid(s, slot)
        if kind == "PAXOS_LOGS_CONSISTENT":
            all_slots = tkey[1]

            def fn(s):
                ok = const_true(s)
                if not all_slots:
                    min_nc = self._lane(s, 0, 5)
                    for i in range(1, n):
                        min_nc = torch.minimum(min_nc, self._lane(s, i, 5))
                    min_nc = min_nc + 1
                for slot in range(1, S + 1):
                    v = self._slot_valid(s, slot)
                    if not all_slots:
                        v = v | (slot < min_nc)
                    ok = ok & v
                return ok
            return fn
        if kind == "PAXOS_HAS_STATUS":
            i = self.server_names.index(str(tkey[1].root_address()))
            slot, status = tkey[2], tkey[3]
            if not 1 <= slot <= S:
                if status == "EMPTY":
                    return const_true
                return lambda s: ~const_true(s)

            def fn(s):
                cleared, empty, acc, ch, _ = self._statuses(s, slot)[i]
                return {"CLEARED": cleared, "EMPTY": empty,
                        "ACCEPTED": acc, "CHOSEN": ch}[status]
            return fn
        if kind == "PAXOS_HAS_COMMAND":
            i = self.server_names.index(str(tkey[1].root_address()))
            slot, cmd = tkey[2], tkey[3]
            cids = self.cmd_ids.get(cmd)
            if not cids or not 1 <= slot <= S:
                # A command no client ever sends (or an out-of-range
                # slot) can never be in a log: constant false, exactly
                # the object predicate's value.
                return lambda s: ~const_true(s)

            def fn(s):
                cl = self._lane(s, i, 5)
                ex = self._log(s, i, slot, 0) == 1
                c = self._log(s, i, slot, 2)
                hit = torch.zeros_like(ex)
                for cid in cids:
                    hit = hit | (c == cid)
                return (slot > cl) & ex & hit
            return fn
        return None


def _unpack(packed: int):
    """Inverse of the twin's packed log-entry bit layout (the
    tpu/specs_lab3.py Slots lowering, kept in lockstep)."""
    v = int(packed)
    return v & 1, (v >> 2) & 0xFFF, v >> 14, (v >> 1) & 1


@register_adapter
def match_paxos(state):
    from dslabs_tpu_torch.labs.paxos.paxos import PaxosClient, PaxosServer

    servers = state.servers
    workers = state.client_workers()
    if not servers or not workers:
        return None
    if not all(isinstance(s, PaxosServer) for s in servers.values()):
        return None
    if not all(isinstance(wk.client, PaxosClient)
               for wk in workers.values()):
        return None
    return PaxosBinding(state)
