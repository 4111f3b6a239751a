"""Tensor twin of lab 2 primary-backup (ViewServer + PBServer/PBClient),
batched: counterpart of ``dslabs_tpu/tpu/protocols/primarybackup.py``,
same node order, lanes, message tags, timers and send/set budgets, so rows
and fingerprints compare bit for bit.

It mirrors the object implementation (``dslabs_tpu/labs/primarybackup/``
``viewserver.py``, ``pb.py``) handler for handler, including the pieces
that shape the search graph: the ViewServer's first-ping-order idle
selection and unbounded tick counters (int32, wrapping as the
reference's do), the ack-before-view-change rule, primary state transfer
with refusal to serve until acked, one-outstanding-op forwarding, and the
client's re-poll of the view on every retry.

Workload (as the lab-1 twin): each of ``n_clients`` clients Puts its own
key W times, so the AMO/KV state per application collapses to one
last-executed-seq lane per client.

Node order: 0 = ViewServer, 1..NS = PBServers, NS+1.. = clients.

Lanes:
  ViewServer: [vn, prim, back, acked, next_rank] + per server [rank, ticks]
              (rank 0 = never pinged; rank order = first-ping order, which
              breaks idle-selection ties)
  PBServer s: [vn, prim, back, synced, pend_client+1, pend_seq] + amo[NC]
  Client c:   [k, vn, prim, back]          k = seq in flight, W+1 = done

Messages [tag, frm, to, payload...]:
  PING [vn]    GETVIEW []      VIEWREPLY [vn, prim, back]
  REQ [c, s]   REPLY [c, s]    FWD [vn, c, s]   FWDACK [vn, c, s]
  XFER [vn, prim, back, amo_0..amo_NC-1]        XFERACK [vn]

Every transition takes a leading batch dimension P.  ``_unpack`` splits
the node vector into [P] columns (``st["amo"][s][c]`` and so on); an
update replaces a column, never writes into one, so a value read earlier
stays a snapshot as in the functional original; ``_repack`` stacks the
columns back in lane order.  A field indexed by a per-pair value (the
pinging server, a client id from a payload) is read with :func:`_pick`
and written column by column under ``index == column``.  Blank send and
timer rows are all-SENTINEL, so blocks of mutually exclusive branches
merge by elementwise minimum, exactly as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from dslabs_tpu_torch.tpu.engine import SENTINEL, TensorProtocol

__all__ = ["make_pb_protocol"]

PING, GETVIEW, VIEWREPLY, REQ, REPLY, FWD, FWDACK, XFER, XFERACK = range(9)
T_PINGCHECK, T_PING, T_CLIENT = 1, 2, 3
PINGCHECK_MS = 100
PING_MS = 25
CLIENT_MS = 100
DEAD_TICKS = 2

I32 = torch.int32


def _pick(cols, idx: torch.Tensor) -> torch.Tensor:
    """``cols[idx]`` per pair: cols is a list of [P] columns, idx [P] in
    range."""
    return torch.stack(cols, dim=1).gather(
        1, idx.to(torch.int64)[:, None])[:, 0]


def _put(cols, idx: torch.Tensor, cond: torch.Tensor, val: torch.Tensor):
    """``cols[idx] = val`` where ``cond``, per pair (a new list)."""
    return [torch.where(cond & (idx == j), val, x).to(I32)
            for j, x in enumerate(cols)]


def make_pb_protocol(ns: int = 2, n_clients: int = 1, w: int = 1,
                     net_cap: int = 32, timer_cap: int = 4) -> TensorProtocol:
    NS, NC = ns, n_clients
    VSW = 5 + 2 * NS
    SW = 6 + NC
    CW = 4
    NW = VSW + NS * SW + NC * CW
    N_NODES = 1 + NS + NC
    PAYLOAD = max(3 + NC, 3)
    MW = 3 + PAYLOAD
    TW = 4
    # rows: ViewServer 1 + servers 2 + clients 2 (message handler)
    MAX_SENDS = 5
    MAX_SETS = 3
    SRV_FIELDS = ("svn", "sp", "sb", "sync", "pc", "ps")
    CLI_FIELDS = ("k", "cvn", "cp", "cb")

    # ------------------------------------------------------- un/pack state

    def _unpack(nodes):
        col = [nodes[:, i] for i in range(NW)]
        st = {"vvn": col[0], "vp": col[1], "vb": col[2], "vack": col[3],
              "vnext": col[4],
              "rank": [col[5 + 2 * s] for s in range(NS)],
              "ticks": [col[6 + 2 * s] for s in range(NS)]}
        for j, name in enumerate(SRV_FIELDS):
            st[name] = [col[VSW + s * SW + j] for s in range(NS)]
        st["amo"] = [[col[VSW + s * SW + 6 + c] for c in range(NC)]
                     for s in range(NS)]
        cb = VSW + NS * SW
        for j, name in enumerate(CLI_FIELDS):
            st[name] = [col[cb + c * CW + j] for c in range(NC)]
        return st

    def _repack(st):
        cols = [st["vvn"], st["vp"], st["vb"], st["vack"], st["vnext"]]
        for s in range(NS):
            cols += [st["rank"][s], st["ticks"][s]]
        for s in range(NS):
            cols += [st[name][s] for name in SRV_FIELDS] + st["amo"][s]
        for c in range(NC):
            cols += [st[name][c] for name in CLI_FIELDS]
        return torch.stack([x.to(I32) for x in cols], dim=1)

    # ------------------------------------------------------------ builders

    def _col(v, like):
        if isinstance(v, torch.Tensor):
            return v.to(I32).expand(like.shape)
        return torch.full(like.shape, int(v), dtype=I32, device=like.device)

    def mk_row(cond, tag, frm, to, payload):
        """[P, MW] message record where ``cond``, else blank."""
        lanes = [tag, frm, to] + list(payload)
        lanes += [0] * (MW - len(lanes))
        rec = torch.stack([_col(v, cond) for v in lanes], dim=1)
        return torch.where(cond[:, None], rec, SENTINEL)

    def mk_set(cond, node, tag, ms, p0):
        """[P, 1 + TW] timer set (target node first) where ``cond``."""
        rec = torch.stack([_col(v, cond) for v in (node, tag, ms, ms, p0)],
                          dim=1)
        return torch.where(cond[:, None], rec, SENTINEL)

    def blank(like, n, width):
        return torch.full((like.shape[0], n, width), SENTINEL, dtype=I32,
                          device=like.device)

    # -------------------------------------------------- ViewServer helpers

    def vs_alive(st, a):
        """a is a 1-based server id (0 = None)."""
        ai = (a - 1).clamp(0, NS - 1)
        return ((a > 0) & (_pick(st["rank"], ai) > 0)
                & (_pick(st["ticks"], ai) < DEAD_TICKS))

    def vs_idle(st):
        """First alive non-primary/backup server in first-ping (rank)
        order; 0 if none."""
        best_rank = torch.full_like(st["vp"], 1 << 30)
        best = torch.zeros_like(st["vp"])
        for s in range(NS):
            sid = s + 1
            ok = ((st["rank"][s] > 0) & (st["ticks"][s] < DEAD_TICKS)
                  & (st["vp"] != sid) & (st["vb"] != sid)
                  & (st["rank"][s] < best_rank))
            best_rank = torch.where(ok, st["rank"][s], best_rank)
            best = torch.where(ok, sid, best)
        return best

    def vs_evaluate(st, cond):
        """The view-change rules, as masks."""
        prim, back, acked = st["vp"], st["vb"], st["vack"]
        idle = vs_idle(st)
        ap = vs_alive(st, prim)
        ab = vs_alive(st, back)
        c0 = cond & (prim == 0) & (idle > 0)                  # startup
        guard = cond & (prim != 0) & (acked == 1)
        c1 = guard & ~ap & ab                                 # promote backup
        c2 = guard & ~ap & (back == 0) & (idle > 0)           # dead solo prim
        c3 = guard & ap & (back != 0) & ~ab                   # replace backup
        c4 = guard & ap & (back == 0) & (idle > 0)            # fill backup
        did = c0 | c1 | c2 | c3 | c4
        np_ = torch.where(c0, idle, torch.where(c1, back, prim))
        nb = torch.where(c0, 0, torch.where(c1 | c2 | c3 | c4, idle, back))
        st["vp"] = torch.where(did, np_, prim).to(I32)
        st["vb"] = torch.where(did, nb, back).to(I32)
        st["vvn"] = torch.where(did, st["vvn"] + 1, st["vvn"]).to(I32)
        st["vack"] = torch.where(did, 0, st["vack"]).to(I32)

    # ---------------------------------------------------- PBServer helpers

    def setf(st, name, s, val):
        lst = list(st[name])
        lst[s] = val.to(I32)
        st[name] = lst

    def set_amo(st, s, lst):
        amo = list(st["amo"])
        amo[s] = lst
        st["amo"] = amo

    def srv_adopt(st, s, view, sends, can_send: bool):
        """Adopt a newer view for server index s (0-based); view = (vn,
        prim, back) columns, the condition riding in vn > svn."""
        sid = s + 1
        vn, prim, back = view
        do = vn > st["svn"][s]
        setf(st, "svn", s, torch.where(do, vn, st["svn"][s]))
        setf(st, "sp", s, torch.where(do, prim, st["sp"][s]))
        setf(st, "sb", s, torch.where(do, back, st["sb"][s]))
        setf(st, "pc", s, torch.where(do, 0, st["pc"][s]))
        setf(st, "ps", s, torch.where(do, 0, st["ps"][s]))
        is_p = do & (prim == sid)
        is_b = do & (back == sid)
        new_sync = torch.where(is_p, torch.where(back != 0, 0, 1),
                               torch.where(is_b, 0, 1))
        setf(st, "sync", s, torch.where(do, new_sync, st["sync"][s]))
        if can_send:
            xfer = is_p & (back != 0)
            sends.append(mk_row(xfer, XFER, sid, back,
                                [vn, prim, back] + list(st["amo"][s])))

    # ----------------------------------------------------- message handler

    def step_message(nodes, msg):
        tag, frm, to = msg[:, 0], msg[:, 1], msg[:, 2]
        p = [msg[:, 3 + i] for i in range(PAYLOAD)]
        st = _unpack(nodes)

        # ---------------- ViewServer (node 0)
        vs_here = to == 0
        is_ping = vs_here & (tag == PING)
        si = (frm - 1).clamp(0, NS - 1)
        # first ping assigns the next rank (first-ping order)
        newcomer = is_ping & (_pick(st["rank"], si) == 0)
        st["vnext"] = torch.where(newcomer, st["vnext"] + 1,
                                  st["vnext"]).to(I32)
        st["rank"] = _put(st["rank"], si, newcomer, st["vnext"])
        st["ticks"] = _put(st["ticks"], si, is_ping,
                           torch.zeros_like(st["vnext"]))
        st["vack"] = torch.where(
            is_ping & (frm == st["vp"]) & (p[0] == st["vvn"]),
            1, st["vack"]).to(I32)
        vs_evaluate(st, is_ping)
        is_gv = vs_here & (tag == GETVIEW)
        vs_rows = mk_row(is_ping | is_gv, VIEWREPLY, 0, frm,
                         [st["vvn"], st["vp"], st["vb"]])[:, None]

        # ---------------- PBServers (nodes 1..NS)
        srv_rows = None
        for s in range(NS):
            sid = s + 1
            here = to == sid
            sends = []
            # ViewReply -> adopt (may send a state transfer)
            is_vr = here & (tag == VIEWREPLY)
            srv_adopt(st, s, (torch.where(is_vr, p[0], -1), p[1], p[2]),
                      sends, can_send=True)

            # Request: serve when primary and synced
            is_rq = here & (tag == REQ)
            c, sq = p[0].clamp(0, NC - 1), p[1]
            serving = (is_rq & (st["sp"][s] == sid)
                       & (st["sync"][s] == 1))
            amo_c = _pick(st["amo"][s], c)
            already = serving & (sq <= amo_c)
            reply_cached = already & (sq == amo_c)
            solo = serving & ~already & (st["sb"][s] == 0)
            set_amo(st, s, _put(st["amo"][s], c, solo, sq))
            can_fwd = (serving & ~already & (st["sb"][s] != 0)
                       & (st["pc"][s] == 0))
            setf(st, "pc", s, torch.where(can_fwd, c + 1, st["pc"][s]))
            setf(st, "ps", s, torch.where(can_fwd, sq, st["ps"][s]))

            # ForwardRequest: the backup executes and acks
            is_fw = here & (tag == FWD)
            fw_ok = (is_fw & (st["sb"][s] == sid)
                     & (p[0] == st["svn"][s]) & (st["sync"][s] == 1))
            fc, fs = p[1].clamp(0, NC - 1), p[2]
            set_amo(st, s, _put(st["amo"][s], fc,
                                fw_ok & (fs > _pick(st["amo"][s], fc)), fs))

            # ForwardAck: the primary commits and replies
            is_fa = here & (tag == FWDACK)
            fa_ok = (is_fa & (st["sp"][s] == sid)
                     & (p[0] == st["svn"][s])
                     & (st["pc"][s] == p[1] + 1) & (st["ps"][s] == p[2]))
            ac, asq = p[1].clamp(0, NC - 1), p[2]
            setf(st, "pc", s, torch.where(fa_ok, 0, st["pc"][s]))
            setf(st, "ps", s, torch.where(fa_ok, 0, st["ps"][s]))
            amo_a = _pick(st["amo"][s], ac)
            fa_reply = fa_ok & (asq >= amo_a)
            set_amo(st, s, _put(st["amo"][s], ac, fa_ok & (asq > amo_a),
                                asq))

            # StateTransfer
            is_xf = here & (tag == XFER)
            mine = is_xf & (p[2] == sid)
            srv_adopt(st, s, (torch.where(mine, p[0], -1), p[1], p[2]),
                      sends, can_send=False)
            xf_cur = mine & (st["svn"][s] == p[0])
            install = xf_cur & (st["sync"][s] == 0)
            set_amo(st, s, [torch.where(install, p[3 + c2], a).to(I32)
                            for c2, a in enumerate(st["amo"][s])])
            setf(st, "sync", s, torch.where(install, 1, st["sync"][s]))

            # StateTransferAck
            is_xa = here & (tag == XFERACK)
            xa_ok = is_xa & (st["sp"][s] == sid) & (st["svn"][s] == p[0])
            setf(st, "sync", s, torch.where(xa_ok, 1, st["sync"][s]))

            # merged reply row (mutually exclusive reply branches)
            rep = reply_cached | solo | fa_reply
            rep_c = torch.where(fa_reply, ac, c)
            rep_s = torch.where(fa_reply, asq, sq)
            sends.append(torch.minimum(torch.minimum(
                mk_row(rep, REPLY, sid, 1 + NS + rep_c, [rep_c, rep_s]),
                mk_row(can_fwd, FWD, sid, st["sb"][s],
                       [st["svn"][s], c, sq])),
                torch.minimum(
                    mk_row(fw_ok, FWDACK, sid, frm, [p[0], fc, fs]),
                    mk_row(xf_cur, XFERACK, sid, frm, [p[0]]))))
            r = torch.stack(sends, dim=1)                  # [P, 2, MW]
            srv_rows = r if srv_rows is None else torch.minimum(srv_rows, r)

        # ---------------- Clients (nodes NS+1..)
        cli_rows, cli_sets = None, None
        for c in range(NC):
            cid = 1 + NS + c
            here = to == cid
            # ViewReply; cvn == -1 means view=None (distinct from an
            # adopted View(0, None, None) in the object)
            is_vr = here & (tag == VIEWREPLY)
            newer = is_vr & ((st["cvn"][c] == -1) | (p[0] > st["cvn"][c]))
            setf(st, "cvn", c, torch.where(newer, p[0], st["cvn"][c]))
            setf(st, "cp", c, torch.where(newer, p[1], st["cp"][c]))
            setf(st, "cb", c, torch.where(newer, p[2], st["cb"][c]))
            k = st["k"][c]
            waiting = k <= w
            vr_send = newer & waiting & (st["cp"][c] > 0)
            vr_gv = newer & waiting & (st["cp"][c] == 0)

            # Reply: the worker pumps the next command
            is_rp = here & (tag == REPLY) & (p[0] == c)
            match = is_rp & (p[1] == k) & waiting
            k2 = torch.where(match, k + 1, k)
            setf(st, "k", c, k2)
            has_next = match & (k2 <= w)
            nx_req = has_next & (st["cp"][c] > 0)
            nx_gv = has_next & (st["cp"][c] == 0)
            seq = torch.where(has_next, k2, k)
            r = torch.stack([
                torch.minimum(
                    mk_row(vr_send, REQ, cid, st["cp"][c], [c, k]),
                    mk_row(nx_req, REQ, cid, st["cp"][c], [c, seq])),
                mk_row(vr_gv | nx_gv, GETVIEW, cid, 0, [])], dim=1)
            t = mk_set(has_next, cid, T_CLIENT, CLIENT_MS, k2)[:, None]
            cli_rows = r if cli_rows is None else torch.minimum(cli_rows, r)
            cli_sets = t if cli_sets is None else torch.minimum(cli_sets, t)

        rows = torch.cat([vs_rows, srv_rows, cli_rows], dim=1)
        tsets = torch.cat([cli_sets, blank(nodes, MAX_SETS - 1, 1 + TW)],
                          dim=1)
        return _repack(st), rows, tsets

    # ------------------------------------------------------ timer handler

    def step_timer(nodes, node_idx, timer):
        tag, p0 = timer[:, 0], timer[:, 3]
        st = _unpack(nodes)

        # ---- ViewServer PingCheckTimer
        is_pc = (node_idx == 0) & (tag == T_PINGCHECK)
        st["ticks"] = [torch.where(is_pc & (st["rank"][s] > 0),
                                   st["ticks"][s] + 1, st["ticks"][s]).to(I32)
                       for s in range(NS)]
        vs_evaluate(st, is_pc)
        vs_sets = mk_set(is_pc, 0, T_PINGCHECK, PINGCHECK_MS, 0)

        # ---- PBServer PingTimer
        srv_rows, srv_sets = None, None
        for s in range(NS):
            sid = s + 1
            here = (node_idx == sid) & (tag == T_PING)
            is_p = st["sp"][s] == sid
            has_b = st["sb"][s] != 0
            unsynced = is_p & has_b & (st["sync"][s] == 0)
            # svn == -1 means view=None (pings 0)
            acked_vn = torch.where(
                st["svn"][s] == -1, 0,
                torch.where(unsynced, st["svn"][s] - 1, st["svn"][s]))
            resend_x = here & unsynced
            refwd = (here & is_p & has_b & (st["sync"][s] == 1)
                     & (st["pc"][s] > 0))
            r = torch.stack([
                mk_row(here, PING, sid, 0, [acked_vn]),
                torch.minimum(
                    mk_row(resend_x, XFER, sid, st["sb"][s],
                           [st["svn"][s], st["sp"][s], st["sb"][s]]
                           + list(st["amo"][s])),
                    mk_row(refwd, FWD, sid, st["sb"][s],
                           [st["svn"][s], st["pc"][s] - 1, st["ps"][s]]))],
                dim=1)
            t = mk_set(here, sid, T_PING, PING_MS, 0)
            srv_rows = r if srv_rows is None else torch.minimum(srv_rows, r)
            srv_sets = t if srv_sets is None else torch.minimum(srv_sets, t)

        # ---- Client ClientTimer
        cli_rows, cli_sets = None, None
        for c in range(NC):
            cid = 1 + NS + c
            here = (node_idx == cid) & (tag == T_CLIENT)
            k = st["k"][c]
            live = here & (p0 == k) & (k <= w)
            r = torch.stack([
                mk_row(live, GETVIEW, cid, 0, []),
                mk_row(live & (st["cp"][c] > 0), REQ, cid, st["cp"][c],
                       [c, k])], dim=1)
            t = mk_set(live, cid, T_CLIENT, CLIENT_MS, k)
            cli_rows = r if cli_rows is None else torch.minimum(cli_rows, r)
            cli_sets = t if cli_sets is None else torch.minimum(cli_sets, t)

        rows = torch.cat([blank(nodes, 1, MW), srv_rows, cli_rows], dim=1)
        tsets = torch.stack([vs_sets, srv_sets, cli_sets], dim=1)
        return _repack(st), rows, tsets

    # ------------------------------------------------------------ initials

    def init_nodes():
        return np.array(
            [0] * VSW
            + sum([[-1, 0, 0, 1, 0, 0] + [0] * NC for _ in range(NS)], [])
            + sum([[1, -1, 0, 0] for _ in range(NC)], []), np.int32)

    def init_messages():
        msgs = np.zeros((NS + NC, MW), np.int32)
        for s in range(NS):
            msgs[s, 0:3] = [PING, s + 1, 0]
        for c in range(NC):
            msgs[NS + c, 0:3] = [GETVIEW, 1 + NS + c, 0]
        return msgs

    def init_timers():
        recs = [[0, T_PINGCHECK, PINGCHECK_MS, PINGCHECK_MS, 0]]
        for s in range(NS):
            recs.append([s + 1, T_PING, PING_MS, PING_MS, 0])
        for c in range(NC):
            recs.append([1 + NS + c, T_CLIENT, CLIENT_MS, CLIENT_MS, 1])
        return np.array(recs, np.int32)

    def msg_dest(msg):
        return msg[:, 2]

    def clients_done(state):
        cb = VSW + NS * SW
        return torch.all(state["nodes"][:, cb:cb + NC * CW:CW] == w + 1,
                         dim=1)

    return TensorProtocol(
        name=f"pb-s{NS}-c{NC}-w{w}",
        n_nodes=N_NODES,
        node_width=NW,
        msg_width=MW,
        timer_width=TW,
        net_cap=net_cap,
        timer_cap=timer_cap,
        max_sends=MAX_SENDS,
        max_sets=MAX_SETS,
        init_nodes=init_nodes,
        init_messages=init_messages,
        init_timers=init_timers,
        step_message=step_message,
        step_timer=step_timer,
        msg_dest=msg_dest,
        goals={"CLIENTS_DONE": clients_done},
    )
