"""Declarative protocol specs for the schema compiler
(``tpu/compiler.py``): the counterpart of ``dslabs_tpu/tpu/specs.py``.

Lab 0 ping-pong, lab 1 exactly-once client/server, lab 2 primary-backup
and single-decree Paxos, written as bounded field/message/handler
declarations and compiled to batched TensorProtocols.  The handlers are
the reference's; the few that compute with tensors directly do so on the
port's batched values (a scalar field is ``[P]``, an array field
``[P, size]``, reductions run over the last dimension).  The generated
twins explore state spaces isomorphic to the hand twins (equal unique
counts; lane layouts differ).

``paxos_partition_spec`` and ``pb_crash_spec`` build their specs with a
fault model; compiling them raises ``NotImplementedError`` until the
symmetry and faults slice of the port."""

from __future__ import annotations

import torch

from dslabs_tpu_torch.tpu.compiler import (Field, MessageType, NodeKind,
                                     ProtocolSpec, TimerType)

__all__ = ["pingpong_spec", "clientserver_spec", "pb_spec",
           "paxos_spec", "paxos_partition_spec", "pb_crash_spec"]


def pingpong_spec(workload_size: int = 2,
                  never_done: bool = False) -> ProtocolSpec:
    """Lab 0: a stateless echo server + one ClientWorker-collapsed
    client walking W commands (the same state collapse as the hand twin,
    tpu/protocols/pingpong.py: one k lane, 'waiting on command k').
    ``never_done`` adds the NONE_DECIDED invariant (the violation-probe
    configuration)."""
    w = workload_size
    # Declared domains (tpu/packing.py): k walks 1..w+1, the
    # command index i walks 1..w — the packed frontier stores each in
    # a few bits instead of a full int32 lane.
    spec = ProtocolSpec(
        "pingpong-gen",
        nodes=[NodeKind("server", 1, ()),
               NodeKind("client", 1, (Field("k", init=1, hi=w + 1),))],
        messages=[MessageType("REQ", ("i",), bounds={"i": (0, w)}),
                  MessageType("REPLY", ("i",), bounds={"i": (0, w)})],
        timers=[TimerType("PING", ("i",), 10, 10,
                          bounds={"i": (0, w)})],
        net_cap=8, timer_cap=4)

    @spec.on("server", "REQ")
    def srv_req(ctx, m):
        ctx.send("REPLY", 1, i=m["i"])

    @spec.on("client", "REPLY")
    def cli_reply(ctx, m):
        k = ctx.get("k")
        match = (m["i"] == k) & (k <= w)
        ctx.put("k", k + 1, when=match)
        k2 = ctx.get("k")
        nxt = match & (k2 <= w)
        ctx.send("REQ", 0, when=nxt, i=k2)
        ctx.set_timer("PING", when=nxt, i=k2)

    @spec.on_timer("client", "PING")
    def cli_timer(ctx, t):
        k = ctx.get("k")
        live = (t["i"] == k) & (k <= w)
        ctx.send("REQ", 0, when=live, i=k)
        ctx.set_timer("PING", when=live, i=k)

    spec.initial_messages.append(("REQ", 1, 0, {"i": 1}))
    spec.initial_timers.append(("PING", 1, {"i": 1}))

    def clients_done(v):
        return v.get("client", 0, "k") == w + 1

    def none_decided(v):
        return v.get("client", 0, "k") == 1

    spec.goals["CLIENTS_DONE"] = clients_done
    if never_done:
        spec.invariants["NONE_DECIDED"] = none_decided
    return spec


def clientserver_spec(n_clients: int = 1, w: int = 1) -> ProtocolSpec:
    """Lab 1: AMO server + NC clients, the hand twin's collapse
    (tpu/protocols/clientserver.py): server state = per-client
    last-executed seq, client state = seq in flight."""
    nc = n_clients
    # Declared domains: per-client last-executed seq a and
    # in-flight seq k are bounded by the workload, client ids by NC —
    # the packed frontier encoding derives its lane widths from these.
    cb, sb = (0, max(nc - 1, 0)), (0, w)
    spec = ProtocolSpec(
        "clientserver-gen",
        nodes=[NodeKind("server", 1, (Field("a", size=nc, hi=w),)),
               NodeKind("client", nc, (Field("k", init=1, hi=w + 1),))],
        messages=[MessageType("REQ", ("c", "s"),
                              bounds={"c": cb, "s": sb}),
                  MessageType("REPLY", ("c", "s"),
                              bounds={"c": cb, "s": sb})],
        timers=[TimerType("RETRY", ("s",), 100, 100,
                          bounds={"s": sb})],
        net_cap=16, timer_cap=4)

    @spec.on("server", "REQ")
    def srv_req(ctx, m):
        c, s = m["c"], m["s"]
        a = ctx.get_at("a", c)
        ctx.put_at("a", c, s, when=s > a)
        # fresh -> execute + reply; s == a -> cached reply; older -> drop
        ctx.send("REPLY", 1 + c, when=s >= a, c=c, s=s)

    @spec.on("client", "REPLY")
    def cli_reply(ctx, m):
        c, s = m["c"], m["s"]
        k = ctx.get("k")
        mine = c == (ctx.node_index() - 1)
        match = mine & (s == k) & (k <= w)
        ctx.put("k", k + 1, when=match)
        k2 = ctx.get("k")
        nxt = match & (k2 <= w)
        ctx.send("REQ", 0, when=nxt, c=c, s=k2)
        ctx.set_timer("RETRY", when=nxt, s=k2)

    @spec.on_timer("client", "RETRY")
    def cli_timer(ctx, t):
        k = ctx.get("k")
        c = ctx.node_index() - 1
        live = (t["s"] == k) & (k <= w)
        ctx.send("REQ", 0, when=live, c=c, s=k)
        ctx.set_timer("RETRY", when=live, s=k)

    for c in range(nc):
        spec.initial_messages.append(("REQ", 1 + c, 0, {"c": c, "s": 1}))
        spec.initial_timers.append(("RETRY", 1 + c, {"s": 1}))

    def clients_done(v):
        done = True
        for c in range(nc):
            done = done & (v.get("client", c, "k") == w + 1)
        return done

    spec.goals["CLIENTS_DONE"] = clients_done
    return spec


def pb_spec(ns: int = 2, n_clients: int = 1, w: int = 1,
            fault=None) -> ProtocolSpec:
    """Lab 2 primary-backup: ViewServer + PBServers + clients — the
    first STATEFUL multi-role protocol through the compiler (round-4
    verdict item 7: "a new protocol becomes searchable without
    twin-authoring expertise" is unproven until lab2's view-change /
    state-transfer compiles from a spec).  Handler-for-handler mirror of
    the hand twin (tpu/protocols/primarybackup.py), which itself mirrors
    labs/primarybackup/{viewserver,pb}.py: first-ping-rank idle
    selection, ack-before-view-change, primary state transfer with
    refusal to serve until acked, one-outstanding-op forwarding, and the
    client's view re-poll on every retry."""
    NS, NC = ns, n_clients
    DEAD = 2
    amo_fields = tuple(f"a{c}" for c in range(NC))
    # Declared domains: server/client ids, sync/acked bits,
    # amo seqs, and rank are all tiny.  View numbers (vn/svn/cvn)
    # genuinely grow with depth and defeat a static hi= — they carry
    # the delta-from-level-base annotation instead:
    # the mesh engine packs them as 8-bit offsets from the per-level
    # minimum, the single-device engine keeps them as full int32
    # lanes.  Liveness ticks stay raw: a dead server's ticks diverge
    # from the level base without bound, so a delta window would
    # overflow (loudly) on exactly the executions lab2 must explore.
    sid, cid, seq = (0, NS), (0, max(NC - 1, 0)), (0, w)
    amo_b = {f: seq for f in amo_fields}
    spec = ProtocolSpec(
        "pb-gen",
        nodes=[NodeKind("vs", 1, (
                   Field("vn", delta=8), Field("prim", hi=NS),
                   Field("back", hi=NS),
                   Field("acked", hi=1), Field("nextrank", hi=NS),
                   Field("rank", size=NS, hi=NS),
                   Field("ticks", size=NS))),
               NodeKind("server", NS, (
                   Field("svn", init=-1, delta=8), Field("sp", hi=NS),
                   Field("sb", hi=NS),
                   Field("sync", init=1, hi=1), Field("pc", hi=NC),
                   Field("ps", hi=w),
                   Field("amo", size=NC, hi=w))),
               NodeKind("client", NC, (
                   Field("k", init=1, hi=w + 1),
                   Field("cvn", init=-1, delta=8),
                   Field("cp", hi=NS), Field("cb", hi=NS)))],
        messages=[MessageType("PING", ("vn",)),
                  MessageType("GETVIEW", ()),
                  MessageType("VIEWREPLY", ("vn", "prim", "back"),
                              bounds={"prim": sid, "back": sid}),
                  MessageType("REQ", ("c", "s"),
                              bounds={"c": cid, "s": seq}),
                  MessageType("REPLY", ("c", "s"),
                              bounds={"c": cid, "s": seq}),
                  MessageType("FWD", ("vn", "c", "s"),
                              bounds={"c": cid, "s": seq}),
                  MessageType("FWDACK", ("vn", "c", "s"),
                              bounds={"c": cid, "s": seq}),
                  MessageType("XFER", ("vn", "prim", "back")
                              + amo_fields,
                              bounds={"prim": sid, "back": sid,
                                      **amo_b}),
                  MessageType("XFERACK", ("vn",))],
        timers=[TimerType("PINGCHECK", (), 100, 100),
                TimerType("PING", (), 25, 25),
                TimerType("CLIENT", ("s",), 100, 100,
                          bounds={"s": seq})],
        net_cap=32, timer_cap=4, fault=fault)

    # ------------------------------------------------ ViewServer helpers

    def vs_alive(ctx, a):
        ai = (a - 1).clip(0, NS - 1)
        return ((a > 0) & (ctx.get_at("rank", ai) > 0)
                & (ctx.get_at("ticks", ai) < DEAD))

    def vs_idle(ctx):
        """First alive non-primary/backup server in first-ping (rank)
        order; 0 if none (viewserver.py:112-116)."""
        prim, back = ctx.get("prim"), ctx.get("back")
        best_rank, best = 1 << 30, torch.zeros_like(prim)
        for s in range(NS):
            sid = s + 1
            rank_s = ctx.get_at("rank", s)
            ok = ((rank_s > 0) & (ctx.get_at("ticks", s) < DEAD)
                  & (prim != sid) & (back != sid) & (rank_s < best_rank))
            best_rank = torch.where(ok, rank_s, best_rank)
            best = torch.where(ok, sid, best)
        return best

    def vs_evaluate(ctx):
        """The view-change rules (viewserver.py:118-139) under the
        ctx's guard, as sequential conditional puts."""
        prim, back, acked = ctx.get("prim"), ctx.get("back"), \
            ctx.get("acked")
        idle = vs_idle(ctx)
        ap, ab = vs_alive(ctx, prim), vs_alive(ctx, back)
        c0 = (prim == 0) & (idle > 0)                  # startup
        guard = (prim != 0) & (acked == 1)
        c1 = guard & ~ap & ab                          # promote backup
        c2 = guard & ~ap & (back == 0) & (idle > 0)    # dead solo prim
        c3 = guard & ap & (back != 0) & ~ab            # replace backup
        c4 = guard & ap & (back == 0) & (idle > 0)     # fill backup
        did = c0 | c1 | c2 | c3 | c4
        ctx.put("vn", ctx.get("vn") + 1, when=did)
        ctx.put("acked", 0, when=did)
        ctx.put("prim", idle, when=c0)
        ctx.put("prim", back, when=c1)
        ctx.put("back", 0, when=c0)
        ctx.put("back", idle, when=c1 | c2 | c3 | c4)

    def vs_reply(ctx, to):
        ctx.send("VIEWREPLY", to, vn=ctx.get("vn"),
                 prim=ctx.get("prim"), back=ctx.get("back"))

    @spec.on("vs", "PING")
    def vs_ping(ctx, m):
        frm = m["_from"]
        si = (frm - 1).clip(0, NS - 1)
        newcomer = ctx.get_at("rank", si) == 0
        nv = ctx.get("nextrank") + 1
        ctx.put("nextrank", nv, when=newcomer)
        ctx.put_at("rank", si, nv, when=newcomer)
        ctx.put_at("ticks", si, 0)
        ctx.put("acked", 1, when=(frm == ctx.get("prim"))
                & (m["vn"] == ctx.get("vn")))
        vs_evaluate(ctx)
        vs_reply(ctx, frm)

    @spec.on("vs", "GETVIEW")
    def vs_getview(ctx, m):
        vs_reply(ctx, m["_from"])

    @spec.on_timer("vs", "PINGCHECK")
    def vs_pingcheck(ctx, t):
        for s in range(NS):
            ctx.put_at("ticks", s, ctx.get_at("ticks", s) + 1,
                       when=ctx.get_at("rank", s) > 0)
        vs_evaluate(ctx)
        ctx.set_timer("PINGCHECK")

    # -------------------------------------------------- PBServer helpers

    def srv_adopt(ctx, vn, prim, back, can_send):
        """_adopt (pb.py:123-137); mutations ride ``vn > svn``."""
        sid = ctx.node_index()
        do = vn > ctx.get("svn")
        ctx.put("svn", vn, when=do)
        ctx.put("sp", prim, when=do)
        ctx.put("sb", back, when=do)
        ctx.put("pc", 0, when=do)
        ctx.put("ps", 0, when=do)
        is_p, is_b = do & (prim == sid), do & (back == sid)
        ctx.put("sync", 1, when=do)
        ctx.put("sync", 0, when=(is_p & (back != 0)) | is_b)
        if can_send:
            ctx.send("XFER", back, when=is_p & (back != 0), vn=vn,
                     prim=prim, back=back,
                     **{f"a{c}": ctx.get_at("amo", c)
                        for c in range(NC)})

    @spec.on("server", "VIEWREPLY")
    def srv_viewreply(ctx, m):
        srv_adopt(ctx, m["vn"], m["prim"], m["back"], can_send=True)

    @spec.on("server", "REQ")
    def srv_req(ctx, m):
        sid = ctx.node_index()
        c, sq = m["c"], m["s"]
        serving = (ctx.get("sp") == sid) & (ctx.get("sync") == 1)
        amo_c = ctx.get_at("amo", c)
        already = serving & (sq <= amo_c)
        reply_cached = already & (sq == amo_c)
        solo = serving & ~already & (ctx.get("sb") == 0)
        ctx.put_at("amo", c, sq, when=solo)
        can_fwd = (serving & ~already & (ctx.get("sb") != 0)
                   & (ctx.get("pc") == 0))
        ctx.put("pc", c + 1, when=can_fwd)
        ctx.put("ps", sq, when=can_fwd)
        ctx.send("REPLY", 1 + NS + c, when=reply_cached | solo, c=c,
                 s=sq)
        ctx.send("FWD", ctx.get("sb"), when=can_fwd,
                 vn=ctx.get("svn"), c=c, s=sq)

    @spec.on("server", "FWD")
    def srv_fwd(ctx, m):
        sid = ctx.node_index()
        ok = ((ctx.get("sb") == sid) & (m["vn"] == ctx.get("svn"))
              & (ctx.get("sync") == 1))
        fc, fs = m["c"], m["s"]
        ctx.put_at("amo", fc, fs,
                   when=ok & (fs > ctx.get_at("amo", fc)))
        ctx.send("FWDACK", m["_from"], when=ok, vn=m["vn"], c=fc, s=fs)

    @spec.on("server", "FWDACK")
    def srv_fwdack(ctx, m):
        sid = ctx.node_index()
        ok = ((ctx.get("sp") == sid) & (m["vn"] == ctx.get("svn"))
              & (ctx.get("pc") == m["c"] + 1) & (ctx.get("ps") == m["s"]))
        ac, asq = m["c"], m["s"]
        ctx.put("pc", 0, when=ok)
        ctx.put("ps", 0, when=ok)
        reply = ok & (asq >= ctx.get_at("amo", ac))
        ctx.put_at("amo", ac, asq,
                   when=ok & (asq > ctx.get_at("amo", ac)))
        ctx.send("REPLY", 1 + NS + ac, when=reply, c=ac, s=asq)

    @spec.on("server", "XFER")
    def srv_xfer(ctx, m):
        sid = ctx.node_index()
        mine = m["back"] == sid
        c2 = ctx.cond(mine)
        srv_adopt(c2, m["vn"], m["prim"], m["back"], can_send=False)
        cur = mine & (ctx.get("svn") == m["vn"])
        install = cur & (ctx.get("sync") == 0)
        for c in range(NC):
            ctx.put_at("amo", c, m[f"a{c}"], when=install)
        ctx.put("sync", 1, when=install)
        ctx.send("XFERACK", m["_from"], when=cur, vn=m["vn"])

    @spec.on("server", "XFERACK")
    def srv_xferack(ctx, m):
        sid = ctx.node_index()
        ok = (ctx.get("sp") == sid) & (ctx.get("svn") == m["vn"])
        ctx.put("sync", 1, when=ok)

    @spec.on_timer("server", "PING")
    def srv_ping(ctx, t):
        sid = ctx.node_index()
        svn, sync = ctx.get("svn"), ctx.get("sync")
        is_p = ctx.get("sp") == sid
        has_b = ctx.get("sb") != 0
        # view=None pings 0; an unsynced primary acks the PREVIOUS view
        # (pb.py:114-121)
        acked_vn = torch.where(
            svn == -1, 0,
            torch.where(is_p & has_b & (sync == 0), svn - 1, svn))
        ctx.send("PING", 0, vn=acked_vn)
        ctx.send("XFER", ctx.get("sb"),
                 when=is_p & has_b & (sync == 0), vn=svn,
                 prim=ctx.get("sp"), back=ctx.get("sb"),
                 **{f"a{c}": ctx.get_at("amo", c) for c in range(NC)})
        ctx.send("FWD", ctx.get("sb"),
                 when=is_p & has_b & (sync == 1) & (ctx.get("pc") > 0),
                 vn=svn, c=ctx.get("pc") - 1, s=ctx.get("ps"))
        ctx.set_timer("PING")

    # ------------------------------------------------------------ clients

    @spec.on("client", "VIEWREPLY")
    def cli_viewreply(ctx, m):
        cvn = ctx.get("cvn")
        newer = (cvn == -1) | (m["vn"] > cvn)
        ctx.put("cvn", m["vn"], when=newer)
        ctx.put("cp", m["prim"], when=newer)
        ctx.put("cb", m["back"], when=newer)
        k = ctx.get("k")
        waiting = k <= w
        cp = ctx.get("cp")
        c = ctx.node_index() - 1 - NS
        ctx.send("REQ", cp, when=newer & waiting & (cp > 0), c=c, s=k)
        ctx.send("GETVIEW", 0, when=newer & waiting & (cp == 0))

    @spec.on("client", "REPLY")
    def cli_reply(ctx, m):
        c = ctx.node_index() - 1 - NS
        k = ctx.get("k")
        match = (m["c"] == c) & (m["s"] == k) & (k <= w)
        ctx.put("k", k + 1, when=match)
        k2 = ctx.get("k")
        has_next = match & (k2 <= w)
        cp = ctx.get("cp")
        ctx.send("REQ", cp, when=has_next & (cp > 0), c=c, s=k2)
        ctx.send("GETVIEW", 0, when=has_next & (cp == 0))
        ctx.set_timer("CLIENT", when=has_next, s=k2)

    @spec.on_timer("client", "CLIENT")
    def cli_timer(ctx, t):
        c = ctx.node_index() - 1 - NS
        k = ctx.get("k")
        live = (t["s"] == k) & (k <= w)
        ctx.send("GETVIEW", 0, when=live)
        ctx.send("REQ", ctx.get("cp"), when=live & (ctx.get("cp") > 0),
                 c=c, s=k)
        ctx.set_timer("CLIENT", when=live, s=k)

    # ----------------------------------------------------------- initials

    for s in range(NS):
        spec.initial_messages.append(("PING", 1 + s, 0, {"vn": 0}))
        spec.initial_timers.append(("PING", 1 + s, {}))
    for c in range(NC):
        spec.initial_messages.append(("GETVIEW", 1 + NS + c, 0, {}))
        spec.initial_timers.append(("CLIENT", 1 + NS + c, {"s": 1}))
    spec.initial_timers.insert(0, ("PINGCHECK", 0, {}))

    def clients_done(v):
        done = True
        for c in range(NC):
            done = done & (v.get("client", c, "k") == w + 1)
        return done

    spec.goals["CLIENTS_DONE"] = clients_done
    return spec


def paxos_spec(n_acceptors: int = 3, quorum: int = 0,
               never_decided: bool = False,
               fault=None) -> ProtocolSpec:
    """Single-decree Paxos (one ballot, one proposer, ``n_acceptors``
    INTERCHANGEABLE acceptors) — the symmetry-reduction flagship
    (tpu/symmetry.py): the acceptors are declared a
    ``symmetry`` group, so states that differ only in WHICH acceptors
    have promised/accepted collapse to one canonical orbit
    representative when the reduction is on (engines' ``symmetry=True``
    knob; default OFF keeps raw counts).

    The spec is written in the symmetry-safe style the C5 conformance
    rule enforces: the proposer identifies responders by ``_from``
    (relabeled by the canonicalize pass) and tracks per-acceptor
    promise/accept bits in ``index_group`` arrays (permuted WITH the
    group); no handler compares ``node_index()`` against a constant.
    Every lane is domain-bounded, so the packed frontier encoding
    (tpu/packing.py) compresses it well past the 2x acceptance bar.

    Flow: initial PREPAREs fan out; acceptors PROMISE; at quorum the
    proposer broadcasts ACCEPT; acceptors reply ACCEPTED; at quorum
    the proposer decides (goal DECIDED).  ``never_decided`` installs
    the violation-probe invariant instead (witness tests)."""
    NA = n_acceptors
    Q = quorum or NA // 2 + 1
    spec = ProtocolSpec(
        "paxos-gen",
        nodes=[NodeKind("proposer", 1, (
                   Field("ph", hi=2),
                   Field("prom", size=NA, hi=1,
                         index_group="acceptor"),
                   Field("accs", size=NA, hi=1,
                         index_group="acceptor"),
                   Field("dec", hi=1))),
               NodeKind("acceptor", NA, (
                   Field("bal", hi=1), Field("acc", hi=1)))],
        messages=[MessageType("PREPARE", ()),
                  MessageType("PROMISE", ()),
                  MessageType("ACCEPT", ()),
                  MessageType("ACCEPTED", ())],
        timers=[],
        net_cap=4 * NA + 2, timer_cap=2,
        symmetry=("acceptor",), fault=fault)

    @spec.on("acceptor", "PREPARE")
    def acc_prepare(ctx, m):
        ctx.put("bal", 1)
        ctx.send("PROMISE", 0)

    @spec.on("proposer", "PROMISE")
    def prop_promise(ctx, m):
        ai = m["_from"] - 1
        ctx.put_at("prom", ai, 1)
        cnt = 0
        for a in range(NA):
            cnt = cnt + ctx.get_at("prom", a)
        go = (ctx.get("ph") == 0) & (cnt >= Q)
        ctx.put("ph", 1, when=go)
        for a in range(NA):
            ctx.send("ACCEPT", 1 + a, when=go)

    @spec.on("acceptor", "ACCEPT")
    def acc_accept(ctx, m):
        ctx.put("acc", 1)
        ctx.send("ACCEPTED", 0)

    @spec.on("proposer", "ACCEPTED")
    def prop_accepted(ctx, m):
        ai = m["_from"] - 1
        ctx.put_at("accs", ai, 1)
        cnt = 0
        for a in range(NA):
            cnt = cnt + ctx.get_at("accs", a)
        win = (ctx.get("ph") >= 1) & (cnt >= Q)
        ctx.put("dec", 1, when=win)
        ctx.put("ph", 2, when=win)

    for a in range(NA):
        spec.initial_messages.append(("PREPARE", 0, 1 + a, {}))

    def decided(v):
        return v.get("proposer", 0, "dec") == 1

    def none_decided(v):
        return v.get("proposer", 0, "dec") == 0

    if never_decided:
        spec.invariants["NONE_DECIDED"] = none_decided
    else:
        spec.goals["DECIDED"] = decided
    return spec


def paxos_partition_spec(n_acceptors: int = 3,
                         broken: bool = False) -> ProtocolSpec:
    """Single-decree Paxos under a checkable partition scenario: the
    proposer and the acceptors sit in separate partition blocks, and the
    fault controller may CUT the link between them once
    (``max_eras=1``) and HEAL it again — the search explores every
    interleaving of the cut with the protocol's own messages.

    Two modes share one invariant, DECIDE_HAS_QUORUM (``dec == 1``
    implies a true majority of ACCEPTED bits):

    * ``broken=False`` — honest majority quorum.  The invariant holds
      on every reachable state: a decision needs ``NA//2+1`` ACCEPTED
      messages through the (possibly cut-then-healed) link, and each
      carries a real acceptor bit.  Exhaustive search (goal pruned to
      a prune by the scenario tests) proves safety with exact counts.

    * ``broken=True`` — quorum deliberately lowered to 1 AND the
      partition starts cut (``initial_cut=True``): the initial
      PREPAREs are frozen in flight until the controller fires HEAL,
      so every path to the (unsafe, single-vote) decision contains the
      HEAL fault event — the violation witness must name it.  The
      DECIDED goal is removed so the search runs to the violation."""
    from dslabs_tpu_torch.tpu.faults import FaultModel, Partition

    NA = n_acceptors
    maj = NA // 2 + 1
    fm = FaultModel(partition=Partition(
        blocks=(("proposer",), ("acceptor",)),
        max_eras=1, initial_cut=broken))
    spec = paxos_spec(n_acceptors=NA, quorum=1 if broken else 0,
                      fault=fm)
    spec.name = "paxos-part-broken" if broken else "paxos-part"
    if broken:
        del spec.goals["DECIDED"]

    def decide_has_quorum(v):
        return ((v.get("proposer", 0, "dec") == 0)
                | (v.get("proposer", 0, "accs").sum(-1) >= maj))

    spec.invariants["DECIDE_HAS_QUORUM"] = decide_has_quorum
    return spec


def pb_crash_spec(ns: int = 2, n_clients: int = 1,
                  w: int = 1) -> ProtocolSpec:
    """Primary-backup under a crash-recovery scenario: any
    server may crash once and restart.  The per-client ``amo``
    (at-most-once) table is declared DURABLE — it survives the crash —
    while the rest of the server state (view number, sync/primary
    bits, pending op) is volatile and resets to field inits on
    restart, forcing re-sync through the view service.  The protocol
    observes the crash only as message loss and timer silence; the
    exactly-once obligation must hold across it."""
    from dslabs_tpu_torch.tpu.faults import Crash, FaultModel

    fm = FaultModel(crash=Crash(durable={"server": ("amo",)},
                                max_crashes=1))
    spec = pb_spec(ns=ns, n_clients=n_clients, w=w, fault=fm)
    spec.name = "pb-crash"
    return spec
