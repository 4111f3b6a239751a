"""Tensor twin of lab 3 multi-Paxos, batched: the flagship workload.

Port of the hand-written twin that the JAX package keeps as a parity
oracle (``tests/fixtures/hand_twins/paxos.py``, pinned to the generated
``specs_lab3`` twin by equal lane widths and unique counts).  It mirrors
the object implementation (``dslabs_tpu/labs/paxos/paxos.py``) handler for
handler, including everything that takes part in state equality: the log,
ballot/leader/heard flags, raw P1b vote contents, P2b vote bitmasks,
proposed_seq, peer_executed + GC frontiers, and the AMO application
state.  Handler cascades (leader self-accept/self-vote, execution chains
with client replies) are inlined as the object's local deliveries are.

The lane layout is exactly the JAX twin's, so rows and fingerprints
compare bit for bit.  Every transition takes a leading batch dimension P:
``_unpack`` slices the node vector once into per-server fields (``b[i]``
[P], ``log[i]`` [P, S, 4], ``votes[i]`` [P, n, 1+4S], ...), every update
replaces one field tensor (never an in-place write, so a value read
earlier stays a snapshot, as in the functional original), and ``_repack``
concatenates the lanes back in the original order.

Workload: ``n_clients`` clients each Put their own key W times, so the
KVStore + AMO state collapses to one last-executed-seq lane per client.
Command ids: ``c * W + s`` (1-based); 0 = no-op.

Lanes per server (offsets from the server's base):
  0 ballot (round * n + leader_idx)   4 executed_through
  1 leader flag                       5 cleared_through
  2 heard_from_leader                 6 gc_through
  3 slot_in                           7 peer_executed bitmask
  8..8+n-1      peer_executed values
  AMO           n_clients lanes: last executed seq per client
  PROP          n_clients lanes: proposed_seq (0 = none)
  P2B           S lanes: vote bitmask per slot
  LOG           S x [exists, ballot, cmd, chosen]
  VOTES         n x [have, S x [exists, ballot, cmd, chosen]]  raw P1b votes
Clients contribute one lane each: k = seq in flight (W+1 = done).
"""

from __future__ import annotations

import numpy as np
import torch

from dslabs_tpu_torch.tpu.engine import SENTINEL, TensorProtocol

__all__ = ["make_paxos_protocol", "paxos_layout"]

# Message tags
REQ, P1A, P1B, P2A, P2B, HB, HBR, CREQ, CREP, REPLY = range(10)
# Timer tags
T_ELECTION, T_HEARTBEAT, T_CLIENT = 1, 2, 3
# Exception code: a ballot/cmd reached a _pack_entry field width — the
# search ends EXCEPTION_THROWN instead of silently aliasing states.
EXC_PACK_WIDTH = 101

ELECTION_MIN, ELECTION_MAX = 150, 300
HEARTBEAT_MS = 50
CLIENT_MS = 100

I32 = torch.int32


def paxos_layout(n: int, n_clients: int, max_slots: int) -> dict:
    """Server lane offsets of the node vector (the module docstring's
    table)."""
    S, NC = max_slots, n_clients
    PEER = 8
    AMO = PEER + n
    PROP = AMO + NC
    P2BV = PROP + NC
    LOG = P2BV + S
    VOTES = LOG + 4 * S
    SW = VOTES + n * (1 + 4 * S)
    return {"PEER": PEER, "AMO": AMO, "PROP": PROP, "P2BV": P2BV,
            "LOG": LOG, "VOTES": VOTES, "SW": SW,
            "NW": n * SW + NC, "N_NODES": n + NC}


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Population count of uint32 values held in int32 bits (SWAR, in
    int64 masked to 32 bits)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(I32)


def _setcol(t: torch.Tensor, j: int, val: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` with ``t[:, j] = val``."""
    out = t.clone()
    out[:, j] = val
    return out


def make_paxos_protocol(n: int = 3, n_clients: int = 1, w: int = 1,
                        max_slots: int = 2, net_cap: int = 64,
                        timer_cap: int = 8) -> TensorProtocol:
    S = max_slots
    NC = n_clients
    maj = n // 2 + 1

    _L = paxos_layout(n, NC, S)
    PEER, AMO, PROP = _L["PEER"], _L["AMO"], _L["PROP"]
    P2BV, LOG, VOTES = _L["P2BV"], _L["LOG"], _L["VOTES"]
    SW, NW, N_NODES = _L["SW"], _L["NW"], _L["N_NODES"]

    # ---- message layout: [tag, frm, to, p0..]  payload:
    #   REQ:   [client, seq]          P1A: [ballot]
    #   P1B:   [ballot, S x packed log entry (see _pack_entry)]
    #   P2A:   [ballot, slot, cmd]    P2B: [ballot, slot]
    #   HB:    [ballot, commit, gc]   HBR: [ballot, executed]
    #   CREQ:  [from_slot]            CREP: [base, count, S x cmd]
    #   REPLY: [client, seq]
    PAYLOAD = max(1 + S, 3, 2 + S)
    MW = 3 + PAYLOAD
    TW = 4  # [tag, min, max, p0]

    def _pack_entry(ex, lb, cmd, ch):
        """(exists, ballot, cmd, chosen) -> one int32, bijective within
        ballot < 2^12 and cmd < 2^17 (guarded by _pack_guard)."""
        return (ex | (ch << 1) | (lb << 2) | (cmd << 14)).to(I32)

    def _pack_guard(st):
        """EXC_PACK_WIDTH where any ballot or cmd id in the state reached a
        _pack_entry field width, else 0."""
        over = torch.zeros_like(st["b"][0], dtype=torch.bool)
        for i in range(n):
            over = (over | (st["b"][i] >= (1 << 12))
                    | torch.any(st["log"][i][:, :, 1] >= (1 << 12), dim=1)
                    | torch.any(st["log"][i][:, :, 2] >= (1 << 17), dim=1))
        return torch.where(over, EXC_PACK_WIDTH, 0).to(I32)

    def _unpack_entry(v):
        return v & 1, (v >> 2) & 0xFFF, v >> 14, (v >> 1) & 1

    # Static send/set row budgets, as in the JAX twin.
    SRV_SENDS = 7 + 2 * (n - 1) + S * (n - 1) + 3 * S
    if n == 1:
        SRV_SENDS += (2 * S + 2) * S
    SRV_SETS = 3 if n == 1 else 2
    CLI_SENDS, CLI_SETS = n, 1
    MAX_SENDS = SRV_SENDS + CLI_SENDS
    MAX_SETS = SRV_SETS + CLI_SETS

    def cmd_id(client, seq):
        return client * w + seq  # 1-based; 0 = none/noop

    def cmd_client(cmd):
        return (cmd - 1) // w

    def cmd_seq(cmd):
        return (cmd - 1) % w + 1

    # ------------------------------------------------------------- builders

    def col(v, like):
        """v (Python int or [P] / 0-d tensor) as a [P] int32 column."""
        if isinstance(v, torch.Tensor):
            return v.to(I32).expand(like.shape)
        return torch.full(like.shape, int(v), dtype=I32, device=like.device)

    class Rows:
        """Collects conditional records of one width; blank rows are
        all-SENTINEL so blocks from mutually exclusive branches merge by
        elementwise minimum."""

        def __init__(self, width):
            self.width = width
            self.rows = []

        def _add(self, cond, lanes):
            lanes = list(lanes)
            while len(lanes) < self.width:
                lanes.append(0)
            rec = torch.stack([col(v, cond) for v in lanes], dim=1)
            self.rows.append(torch.where(cond[:, None], rec, SENTINEL))

        def finalize(self, count, like):
            rows = list(self.rows)
            assert len(rows) <= count, (len(rows), count)
            blank = torch.full((like.shape[0], self.width), SENTINEL,
                               dtype=I32, device=like.device)
            while len(rows) < count:
                rows.append(blank)
            return torch.stack(rows, dim=1)

    class Sends(Rows):
        def __init__(self):
            super().__init__(MW)

        def add(self, cond, tag, frm, to, payload):
            self._add(cond, [tag, frm, to] + list(payload))

    class Sets(Rows):
        def __init__(self):
            super().__init__(1 + TW)

        def add(self, cond, node, tag, mn, mx, p0):
            self._add(cond, [node, tag, mn, mx, p0])

    # -------------------------------------------------- unpack/repack state
    # st maps each field to a list over servers (clients: "k" over
    # clients) of [P, ...] tensors:
    #   b, ld, hd, si, ex, cl, gc, pm : [P]      peer [P, n]
    #   amo, prop [P, NC]   p2bv [P, S]   log [P, S, 4]   votes [P, n, 1+4S]

    def _unpack(nodes):
        p = nodes.shape[0]

        def per(off, width):
            return [nodes[:, i * SW + off:i * SW + off + width]
                    for i in range(n)]

        def sc(off):
            return [nodes[:, i * SW + off] for i in range(n)]

        return {
            "b": sc(0), "ld": sc(1), "hd": sc(2), "si": sc(3),
            "ex": sc(4), "cl": sc(5), "gc": sc(6), "pm": sc(7),
            "peer": per(PEER, n), "amo": per(AMO, NC),
            "prop": per(PROP, NC), "p2bv": per(P2BV, S),
            "log": [x.reshape(p, S, 4) for x in per(LOG, 4 * S)],
            "votes": [x.reshape(p, n, 1 + 4 * S)
                      for x in per(VOTES, n * (1 + 4 * S))],
            "k": [nodes[:, n * SW + c] for c in range(NC)],
        }

    def _repack(st):
        p = st["b"][0].shape[0]
        parts = []
        for i in range(n):
            parts.extend([
                st["b"][i][:, None], st["ld"][i][:, None],
                st["hd"][i][:, None], st["si"][i][:, None],
                st["ex"][i][:, None], st["cl"][i][:, None],
                st["gc"][i][:, None], st["pm"][i][:, None],
                st["peer"][i], st["amo"][i], st["prop"][i], st["p2bv"][i],
                st["log"][i].reshape(p, 4 * S),
                st["votes"][i].reshape(p, n * (1 + 4 * S)),
            ])
        parts.extend(k[:, None] for k in st["k"])
        return torch.cat([x.to(I32) for x in parts], dim=1)

    def _set(st, key, i, val):
        st[key][i] = col(val, st[key][i])

    # One-hot row access for traced indices (0 / no-op when out of range).

    def oh_get(row, idx, size):
        """row [P, size, ...]; idx [P] -> row[p, idx[p]], 0 if out of
        range."""
        idx = col(idx, row[:, 0] if row.dim() == 2 else row[:, 0, 0])
        m = torch.arange(size, device=row.device)[None, :] == idx[:, None]
        m = m.reshape(m.shape + (1,) * (row.dim() - 2))
        return (m * row).sum(1).to(I32)

    def oh_put(row, idx, size, val, cond):
        """row with row[p, idx[p]] = val[p] where cond[p]."""
        idx = col(idx, cond)
        m = (torch.arange(size, device=row.device)[None, :] == idx[:, None]
             ) & cond[:, None]
        m = m.reshape(m.shape + (1,) * (row.dim() - 2))
        if isinstance(val, torch.Tensor):
            val = val.to(row.dtype)
            if val.dim() == 1:
                val = val.reshape((-1,) + (1,) * (row.dim() - 1))
            else:
                val = val[:, None]
        return torch.where(m, val, row)

    def entry(vals, like):
        return torch.stack([col(v, like) for v in vals], dim=1)

    def log_get(st, i, slot):
        """slot is 1-based; returns [P, 4] = (exists, ballot, cmd, chosen),
        zeros when out of range."""
        return oh_get(st["log"][i], col(slot, st["b"][i]) - 1, S)

    def log_set(st, i, slot, vals, cond):
        st["log"][i] = oh_put(st["log"][i], col(slot, cond) - 1, S,
                              entry(vals, cond), cond)

    def exec_chain(st, i, sends, cond):
        """Execute contiguous chosen slots, sending client replies; the
        leader updates its own peer_executed."""
        for _ in range(S):
            ex = st["ex"][i]
            e = log_get(st, i, ex + 1)
            can = cond & (ex + 1 <= S) & (e[:, 0] == 1) & (e[:, 3] == 1)
            _set(st, "ex", i, torch.where(can, ex + 1, ex))
            cmd = e[:, 2]
            has_cmd = can & (cmd != 0)
            cl = cmd_client(cmd).clamp(0, NC - 1)
            sq = cmd_seq(cmd)
            last = oh_get(st["amo"][i], cl, NC)
            reply = has_cmd & (sq >= last)
            newlast = torch.where(has_cmd & (sq > last), sq, last)
            st["amo"][i] = oh_put(st["amo"][i], cl, NC, newlast, has_cmd)
            sends.add(reply, REPLY, i, n + cl, [cl, sq])
        is_leader = cond & (st["ld"][i] == 1) & (st["b"][i] % n == i)
        _leader_exec_update(st, i, is_leader)

    def _leader_exec_update(st, i, is_leader):
        ex = st["ex"][i]
        mask = st["pm"][i]
        _set(st, "pm", i, torch.where(is_leader, mask | (1 << i), mask))
        cur = st["peer"][i][:, i]
        st["peer"][i] = _setcol(st["peer"][i], i,
                                torch.where(is_leader, ex, cur))
        maybe_gc(st, i, is_leader)

    def maybe_gc(st, i, cond):
        mask = st["pm"][i]
        have_all = mask == (1 << n) - 1
        floor = st["peer"][i][:, 0]
        for j in range(1, n):
            floor = torch.minimum(floor, st["peer"][i][:, j])
        do = cond & have_all & (floor > st["gc"][i])
        _set(st, "gc", i, torch.where(do, floor, st["gc"][i]))
        gc_to(st, i, floor, do)

    def gc_to(st, i, through, cond):
        through = torch.minimum(through, st["ex"][i])
        cleared = st["cl"][i]
        do = cond & (through > cleared)
        for slot in range(1, S + 1):
            clear = do & (slot > cleared) & (slot <= through)
            log_set(st, i, slot, [0, 0, 0, 0], clear)
        _set(st, "cl", i, torch.where(do, through, cleared))

    def accept_p2a(st, i, ballot, slot, cmd, cond):
        """The acceptor body of handle_P2a (ballot already >= checked)."""
        e = log_get(st, i, slot)
        write = (cond & (slot > st["cl"][i])
                 & ~((e[:, 0] == 1) & (e[:, 3] == 1)))
        log_set(st, i, slot, [1, ballot, cmd, 0], write)

    def record_own_p2b(st, i, ballot, slot, cond):
        """Leader self-vote (send_p2a -> self P2a -> self P2b)."""
        e = log_get(st, i, slot)
        ok = (cond & (st["b"][i] == ballot)
              & (e[:, 0] == 1) & (e[:, 3] == 0) & (e[:, 1] == ballot))
        row = st["p2bv"][i]
        hit = ((torch.arange(S, device=row.device)[None, :]
                == (col(slot, cond) - 1)[:, None]) & ok[:, None])
        st["p2bv"][i] = torch.where(hit, row | (1 << i), row)

    def send_p2a(st, i, slot, sends, cond):
        """Broadcast P2a for log[slot] + inline self-accept/self-vote."""
        slot = col(slot, cond)
        e = log_get(st, i, slot)
        ballot = st["b"][i]
        for j in range(n):
            if j == i:
                continue
            sends.add(cond, P2A, i, j, [ballot, slot, e[:, 2]])
        accept_p2a(st, i, ballot, slot, e[:, 2], cond)
        _set(st, "hd", i, torch.where(cond, 1, st["hd"][i]))
        record_own_p2b(st, i, ballot, slot, cond)
        if n == 1:
            # Singleton: the self-vote IS the majority.
            e1 = log_get(st, i, slot)
            ch = (cond & (e1[:, 0] == 1) & (e1[:, 3] == 0)
                  & (e1[:, 1] == ballot))
            row = st["p2bv"][i]
            hit = ((torch.arange(S, device=row.device)[None, :]
                    == (slot - 1)[:, None]) & ch[:, None])
            st["p2bv"][i] = torch.where(hit, 0, row)
            log_set(st, i, slot, [1, e1[:, 1], e1[:, 2], 1], ch)
            exec_chain(st, i, sends, ch)

    def heartbeat_sends(st, i, sends, cond):
        ballot, commit, gc = st["b"][i], st["ex"][i], st["gc"][i]
        for j in range(n):
            if j == i:
                continue
            sends.add(cond, HB, i, j, [ballot, commit, gc])

    # ----------------------------------------------------- message handlers

    def step_message(nodes, msg):
        tag, frm, to = msg[:, 0], msg[:, 1], msg[:, 2]
        p = msg[:, 3:]
        st = _unpack(nodes)
        srv_rows, srv_sets = None, None
        for i in range(n):
            here = to == i
            sends, sets = Sends(), Sets()
            _server_handle(st, i, here, tag, frm, p, sends, sets)
            r = sends.finalize(SRV_SENDS, tag)
            t = sets.finalize(SRV_SETS, tag)
            srv_rows = r if srv_rows is None else torch.minimum(srv_rows, r)
            srv_sets = t if srv_sets is None else torch.minimum(srv_sets, t)
        cli_rows, cli_sets = None, None
        for c in range(NC):
            here = to == n + c
            sends, sets = Sends(), Sets()
            _client_handle(st, c, here, tag, p, sends, sets)
            r = sends.finalize(CLI_SENDS, tag)
            t = sets.finalize(CLI_SETS, tag)
            cli_rows = r if cli_rows is None else torch.minimum(cli_rows, r)
            cli_sets = t if cli_sets is None else torch.minimum(cli_sets, t)
        rows = torch.cat([srv_rows, cli_rows], dim=1)
        tsets = torch.cat([srv_sets, cli_sets], dim=1)
        return _repack(st), rows, tsets, _pack_guard(st)

    def _server_handle(st, i, here, tag, frm, p, sends, sets):
        ballot = st["b"][i]

        # ---- PaxosRequest
        is_req = here & (tag == REQ)
        client, seq = p[:, 0], p[:, 1]
        ci = client.clamp(0, NC - 1)
        amo_last = oh_get(st["amo"][i], ci, NC)
        already = seq <= amo_last
        sends.add(is_req & already & (seq == amo_last), REPLY, i,
                  n + client, [client, seq])
        is_leader = (st["ld"][i] == 1) & (ballot % n == i)
        believed = ballot % n
        fwd = (is_req & ~already & ~is_leader
               & ((frm == i) | (frm >= n)) & (believed != i))
        sends.add(fwd, REQ, i, believed, [client, seq])
        prop = oh_get(st["prop"][i], ci, NC)
        do_prop = is_req & ~already & is_leader & (seq > prop)
        slot = st["si"][i]
        do_prop = do_prop & (slot <= S)
        st["prop"][i] = oh_put(st["prop"][i], ci, NC, seq, do_prop)
        _set(st, "si", i, torch.where(do_prop, slot + 1, slot))
        log_set(st, i, slot, [1, ballot, cmd_id(client, seq), 0], do_prop)
        send_p2a(st, i, slot, sends, do_prop)

        # ---- P1a
        is_p1a = here & (tag == P1A)
        mb = p[:, 0]
        adopt = is_p1a & (mb > ballot)
        _set(st, "b", i, torch.where(adopt, mb, st["b"][i]))
        _set(st, "ld", i, torch.where(adopt, 0, st["ld"][i]))
        promise = is_p1a & (mb == st["b"][i])
        lg = st["log"][i]
        sends.add(promise, P1B, i, frm,
                  [st["b"][i]] + [
                      _pack_entry(lg[:, s, 0], lg[:, s, 1], lg[:, s, 2],
                                  lg[:, s, 3])
                      for s in range(S)])

        # ---- P1b
        is_p1b = here & (tag == P1B)
        vb = p[:, 0]
        accept_vote = (is_p1b & (vb == st["b"][i])
                       & (st["b"][i] % n == i) & (st["ld"][i] == 0))
        # The S packed log entries back into the raw vote-row layout
        # [have, S x (exists, ballot, cmd, chosen)].
        vlanes = [torch.ones_like(vb)]
        for s in range(S):
            vlanes += list(_unpack_entry(p[:, 1 + s]))
        vrec = torch.stack(vlanes, dim=1).to(I32)
        st["votes"][i] = oh_put(st["votes"][i], frm, n, vrec, accept_vote)
        nvotes = st["votes"][i][:, :, 0].sum(1)
        win = accept_vote & (nvotes >= maj)
        _p1b_win(st, i, win, sends, sets)

        # ---- P2a
        is_p2a = here & (tag == P2A)
        ab, aslot, acmd = p[:, 0], p[:, 1], p[:, 2]
        ok2a = is_p2a & (ab >= st["b"][i])
        _set(st, "ld", i, torch.where(ok2a & (ab > st["b"][i]), 0,
                                      st["ld"][i]))
        _set(st, "b", i, torch.where(ok2a, ab, st["b"][i]))
        _set(st, "hd", i, torch.where(ok2a, 1, st["hd"][i]))
        accept_p2a(st, i, ab, aslot, acmd, ok2a)
        sends.add(ok2a, P2B, i, frm, [ab, aslot])

        # ---- P2b
        is_p2b = here & (tag == P2B)
        bb, bslot = p[:, 0], p[:, 1]
        lead_ok = (is_p2b & (bb == st["b"][i])
                   & (st["ld"][i] == 1) & (st["b"][i] % n == i))
        e = log_get(st, i, bslot)
        count_ok = (lead_ok & (e[:, 0] == 1) & (e[:, 3] == 0)
                    & (e[:, 1] == bb))
        vmask = oh_get(st["p2bv"][i], bslot - 1, S)
        one = torch.ones_like(frm)
        vmask2 = torch.where(
            count_ok,
            vmask | torch.bitwise_left_shift(one, frm.clamp(0, n - 1)),
            vmask)
        chosen_now = count_ok & (_popcount(vmask2) >= maj)
        st["p2bv"][i] = oh_put(st["p2bv"][i], bslot - 1, S,
                               torch.where(chosen_now, 0, vmask2), count_ok)
        log_set(st, i, bslot, [1, e[:, 1], e[:, 2], 1], chosen_now)
        exec_chain(st, i, sends, chosen_now)

        # ---- Heartbeat
        is_hb = here & (tag == HB)
        hb_b, hb_commit, hb_gc = p[:, 0], p[:, 1], p[:, 2]
        hb_ok = is_hb & (hb_b >= st["b"][i])
        _set(st, "ld", i, torch.where(hb_ok & (hb_b > st["b"][i]), 0,
                                      st["ld"][i]))
        _set(st, "b", i, torch.where(hb_ok, hb_b, st["b"][i]))
        _set(st, "hd", i, torch.where(hb_ok, 1, st["hd"][i]))
        gc_to(st, i, hb_gc, hb_ok)
        lagging = hb_ok & (st["ex"][i] < hb_commit)
        sends.add(lagging, CREQ, i, frm, [st["ex"][i] + 1])
        sends.add(hb_ok, HBR, i, frm, [st["b"][i], st["ex"][i]])

        # ---- HeartbeatReply
        is_hbr = here & (tag == HBR)
        rb, rexec = p[:, 0], p[:, 1]
        hbr_ok = (is_hbr & (rb == st["b"][i])
                  & (st["ld"][i] == 1) & (st["b"][i] % n == i))
        pcur = oh_get(st["peer"][i], frm, n)
        st["peer"][i] = oh_put(st["peer"][i], frm, n,
                               torch.maximum(pcur, rexec), hbr_ok)
        mask = st["pm"][i]
        _set(st, "pm", i, torch.where(
            hbr_ok, mask | torch.bitwise_left_shift(one, frm.clamp(0, n - 1)),
            mask))
        maybe_gc(st, i, hbr_ok)

        # ---- CatchupRequest
        is_cq = here & (tag == CREQ)
        from_slot = torch.maximum(p[:, 0], st["cl"][i] + 1)
        cmds = []
        count = torch.zeros_like(from_slot)
        contiguous = torch.ones_like(is_cq)
        for k in range(S):
            slot = from_slot + k
            e = log_get(st, i, slot)
            ok = (contiguous & (slot <= st["ex"][i])
                  & (e[:, 0] == 1) & (e[:, 3] == 1))
            contiguous = ok
            cmds.append(torch.where(ok, e[:, 2], 0))
            count = count + ok.to(I32)
        sends.add(is_cq & (count > 0), CREP, i, frm,
                  [from_slot, count] + cmds)

        # ---- CatchupReply
        is_cp = here & (tag == CREP)
        base, ccount = p[:, 0], p[:, 1]
        for k in range(S):
            slot = base + k
            cmd = p[:, 2 + k]
            e = log_get(st, i, slot)
            install = (is_cp & (k < ccount) & (slot > st["cl"][i])
                       & ~((e[:, 0] == 1) & (e[:, 3] == 1)))
            log_set(st, i, slot, [1, st["b"][i], cmd, 1], install)
        exec_chain(st, i, sends, is_cp)

    def _p1b_win(st, i, win, sends, sets):
        """Phase-1 victory (handle_P1b body after majority)."""
        ballot = st["b"][i]
        _set(st, "ld", i, torch.where(win, 1, st["ld"][i]))
        st["p2bv"][i] = torch.where(win[:, None], 0, st["p2bv"][i])
        _set(st, "pm", i, torch.where(win, 1 << i, st["pm"][i]))
        me = torch.arange(n, device=win.device)[None, :] == i
        st["peer"][i] = torch.where(
            win[:, None], torch.where(me, st["ex"][i][:, None], 0),
            st["peer"][i]).to(I32)
        # Adoption: per slot, chosen wins; else max-ballot accepted.
        zero = torch.zeros_like(ballot)
        for s in range(1, S + 1):
            a_ex, a_b, a_c, a_ch = zero, zero - 1, zero, zero
            votes = st["votes"][i]
            for j in range(n):
                have = votes[:, j, 0]
                ex = votes[:, j, 1 + 4 * (s - 1) + 0]
                vb = votes[:, j, 1 + 4 * (s - 1) + 1]
                vc = votes[:, j, 1 + 4 * (s - 1) + 2]
                vch = votes[:, j, 1 + 4 * (s - 1) + 3]
                valid = (have == 1) & (ex == 1)
                take = valid & ((vch == 1) & (a_ch == 0)
                                | (a_ch == 0) & ((a_ex == 0) | (vb > a_b)))
                a_b = torch.where(take, vb, a_b)
                a_c = torch.where(take, vc, a_c)
                a_ch = torch.where(take, torch.maximum(a_ch, vch), a_ch)
                a_ex = torch.where(take, 1, a_ex)
            mine = st["log"][i][:, s - 1]
            adopt = (win & (a_ex == 1) & (s > st["cl"][i])
                     & ~((mine[:, 0] == 1) & (mine[:, 3] == 1)))
            log_set(st, i, s, [1, ballot, a_c, a_ch], adopt)
        # top = last non-empty; fill holes with no-ops; repropose unchosen.
        top = st["cl"][i]
        for s in range(1, S + 1):
            top = torch.where(st["log"][i][:, s - 1, 0] == 1, s, top)
        for s in range(1, S + 1):
            e = st["log"][i][:, s - 1]
            in_span = win & (s > st["ex"][i]) & (s <= top)
            fill = in_span & (e[:, 0] == 0)
            log_set(st, i, s, [1, ballot, 0, 0], fill)
            reprop = in_span & (st["log"][i][:, s - 1, 3] == 0)
            send_p2a(st, i, s, sends, reprop)
        _set(st, "si", i, torch.where(win, top + 1, st["si"][i]))
        # proposed_seq from logged commands (max seq per client).
        for c in range(NC):
            best = zero
            for s in range(1, S + 1):
                e = st["log"][i][:, s - 1]
                mine_c = ((e[:, 0] == 1) & (e[:, 2] != 0)
                          & (cmd_client(e[:, 2]) == c))
                best = torch.where(mine_c,
                                   torch.maximum(best, cmd_seq(e[:, 2])),
                                   best)
            st["prop"][i] = _setcol(
                st["prop"][i], c,
                torch.where(win, best, st["prop"][i][:, c]))
        exec_chain(st, i, sends, win)
        sets.add(win, i, T_HEARTBEAT, HEARTBEAT_MS, HEARTBEAT_MS, ballot)
        heartbeat_sends(st, i, sends, win)

    def _client_handle(st, c, here, tag, p, sends, sets):
        k = st["k"][c]
        is_reply = here & (tag == REPLY) & (p[:, 0] == c)
        match = is_reply & (p[:, 1] == k) & (k <= w)
        k2 = torch.where(match, k + 1, k)
        st["k"][c] = k2.to(I32)
        has_next = match & (k2 <= w)
        for j in range(n):
            sends.add(has_next, REQ, n + c, j, [c, k2])
        sets.add(has_next, n + c, T_CLIENT, CLIENT_MS, CLIENT_MS, k2)

    # ------------------------------------------------------- timer handlers

    def step_timer(nodes, node_idx, timer):
        tag, p0 = timer[:, 0], timer[:, 3]
        st = _unpack(nodes)
        srv_rows, srv_sets = None, None
        for i in range(n):
            here = node_idx == i
            sends, sets = Sends(), Sets()
            _server_timer(st, i, here, tag, p0, sends, sets)
            r = sends.finalize(SRV_SENDS, tag)
            t = sets.finalize(SRV_SETS, tag)
            srv_rows = r if srv_rows is None else torch.minimum(srv_rows, r)
            srv_sets = t if srv_sets is None else torch.minimum(srv_sets, t)
        cli_rows, cli_sets = None, None
        for c in range(NC):
            here = node_idx == n + c
            sends, sets = Sends(), Sets()
            k = st["k"][c]
            live = here & (tag == T_CLIENT) & (p0 == k) & (k <= w)
            for j in range(n):
                sends.add(live, REQ, n + c, j, [c, k])
            sets.add(live, n + c, T_CLIENT, CLIENT_MS, CLIENT_MS, k)
            r = sends.finalize(CLI_SENDS, tag)
            t = sets.finalize(CLI_SETS, tag)
            cli_rows = r if cli_rows is None else torch.minimum(cli_rows, r)
            cli_sets = t if cli_sets is None else torch.minimum(cli_sets, t)
        rows = torch.cat([srv_rows, cli_rows], dim=1)
        tsets = torch.cat([srv_sets, cli_sets], dim=1)
        return _repack(st), rows, tsets, _pack_guard(st)

    def _server_timer(st, i, here, tag, p0, sends, sets):
        ballot = st["b"][i]
        is_leader = (st["ld"][i] == 1) & (ballot % n == i)

        # ---- ElectionTimer (on_ElectionTimer + _start_election inline)
        is_el = here & (tag == T_ELECTION)
        elect = is_el & ~is_leader & (st["hd"][i] == 0)
        new_ballot = (ballot // n + 1) * n + i
        _set(st, "b", i, torch.where(elect, new_ballot, st["b"][i]))
        _set(st, "ld", i, torch.where(elect, 0, st["ld"][i]))
        st["votes"][i] = torch.where(elect[:, None, None], 0, st["votes"][i])
        for j in range(n):
            if j == i:
                continue
            sends.add(elect, P1A, i, j, [new_ballot])
        # Self-promise: own vote with own log (P1a -> P1b self-delivery).
        own = torch.cat([torch.ones_like(ballot)[:, None],
                         st["log"][i].reshape(-1, 4 * S)], dim=1)
        votes = st["votes"][i].clone()
        votes[:, i] = torch.where(elect[:, None], own, votes[:, i])
        st["votes"][i] = votes
        if n == 1:
            # Singleton group: our own vote IS the majority.
            _p1b_win(st, i, elect, sends, sets)
        _set(st, "hd", i, torch.where(is_el, 0, st["hd"][i]))
        sets.add(is_el, i, T_ELECTION, ELECTION_MIN, ELECTION_MAX, 0)

        # ---- HeartbeatTimer
        is_hbt = here & (tag == T_HEARTBEAT)
        live = is_hbt & (p0 == st["b"][i]) & is_leader
        heartbeat_sends(st, i, sends, live)
        for s in range(1, S + 1):
            e = st["log"][i][:, s - 1]
            inflight = (live & (s > st["ex"][i]) & (s < st["si"][i])
                        & (e[:, 0] == 1) & (e[:, 3] == 0))
            send_p2a(st, i, s, sends, inflight)
        sets.add(live, i, T_HEARTBEAT, HEARTBEAT_MS, HEARTBEAT_MS, p0)

    # ------------------------------------------------------------ initials

    def init_nodes():
        nodes = np.zeros((NW,), np.int32)
        for i in range(n):
            nodes[i * SW + 3] = 1  # slot_in = 1
        if n == 1:
            # A lone server self-elects synchronously at init.
            nodes[0] = 1
            nodes[1] = 1
            nodes[VOTES] = 1
        for c in range(NC):
            nodes[n * SW + c] = 1    # first command in flight
        return nodes

    def init_messages():
        msgs = []
        for c in range(NC):
            for j in range(n):
                rec = np.zeros((MW,), np.int32)
                rec[0:3] = [REQ, n + c, j]
                rec[3:5] = [c, 1]
                msgs.append(rec)
        return np.stack(msgs)

    def init_timers():
        recs = []
        for i in range(n):
            recs.append([i, T_ELECTION, ELECTION_MIN, ELECTION_MAX, 0])
            if n == 1:
                recs.append([i, T_HEARTBEAT, HEARTBEAT_MS, HEARTBEAT_MS, 1])
        for c in range(NC):
            recs.append([n + c, T_CLIENT, CLIENT_MS, CLIENT_MS, 1])
        return np.array(recs, np.int32)

    def msg_dest(msg):
        return msg[:, 2]

    # ----------------------------------------------------------- predicates

    def clients_done(state):
        return torch.all(state["nodes"][:, n * SW:n * SW + NC] == w + 1,
                         dim=1)

    def logs_consistent(state):
        """slotValid core: no two different commands chosen in a slot."""
        nodes = state["nodes"]
        ok = torch.ones(nodes.shape[0], dtype=torch.bool,
                        device=nodes.device)
        for s in range(1, S + 1):
            chosen_cmd = torch.full_like(nodes[:, 0], -1)
            seen = torch.zeros_like(ok)
            bad = torch.zeros_like(ok)
            for i in range(n):
                base = i * SW + LOG + 4 * (s - 1)
                is_ch = (nodes[:, base] == 1) & (nodes[:, base + 3] == 1)
                ec = nodes[:, base + 2]
                bad = bad | (is_ch & seen & (ec != chosen_cmd))
                chosen_cmd = torch.where(is_ch, ec, chosen_cmd)
                seen = seen | is_ch
            ok = ok & ~bad
        return ok

    return TensorProtocol(
        name=f"paxos-n{n}-c{NC}-w{w}-s{S}",
        n_nodes=N_NODES,
        node_width=NW,
        msg_width=MW,
        timer_width=TW,
        net_cap=net_cap,
        timer_cap=timer_cap,
        max_sends=MAX_SENDS,
        max_sets=MAX_SETS,
        # Worst simultaneous sends: the P1b-win cascade.
        max_live_sends=min(S * (n - 1) + S + (n - 1) + 1, MAX_SENDS),
        init_nodes=init_nodes,
        init_messages=init_messages,
        init_timers=init_timers,
        step_message=step_message,
        step_timer=step_timer,
        msg_dest=msg_dest,
        invariants={"LOGS_CONSISTENT": logs_consistent},
        goals={"CLIENTS_DONE": clients_done},
    )
