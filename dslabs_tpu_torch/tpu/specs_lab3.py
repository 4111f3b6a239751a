"""Generated lab 3 multi-Paxos: the counterpart of
``dslabs_tpu/tpu/specs_lab3.py``, the twin that the reference's
``bench.py`` flagship and lab 3 harness adapter bind, built as a
:class:`~dslabs_tpu_torch.tpu.compiler.ProtocolSpec` on the
replicated-protocol layer: :class:`~dslabs_tpu_torch.tpu.slots.Slots`
blocks for the per-slot log, P2b vote bitmaps and raw P1b votes, and a
declared majority :class:`~dslabs_tpu_torch.tpu.quorum.QuorumCount`.

Every handler mirrors the hand twin (``tpu/protocols/paxos.py``) and the
reference spec handler for handler; message and timer records are
lane-identical to the hand twin's, and node state is a lane permutation
of the hand layout, so unique-state counts are exactly preserved while
every lowered lane declares its own packing domain (ballot lanes cap at
12 bits, the hand twin's ``_pack_entry`` width).  Handlers that compute
with tensors directly do so on the port's batched values (a scalar field
is ``[P]``; ``_max``/``_min`` take an int on either side).

Workload model: ``n_clients`` clients each Put their own key ``w``
times; command ids ``c * w + s`` (1-based), 0 = no-op.
"""

from __future__ import annotations

import torch

from dslabs_tpu_torch.tpu.compiler import (Field, MessageType,
                                           NodeKind, ProtocolSpec,
                                           TimerType)
from dslabs_tpu_torch.tpu.quorum import QuorumCount
from dslabs_tpu_torch.tpu.slots import SlotField, Slots

__all__ = ["make_paxos_spec", "make_paxos_protocol",
           "make_paxos_partition_spec", "paxos_layout",
           "BALLOT_HI",
           "REQ", "P1A", "P1B", "P2A", "P2B", "HB", "HBR",
           "CREQ", "CREP", "REPLY",
           "T_ELECTION", "T_HEARTBEAT", "T_CLIENT"]

ELECTION_MIN, ELECTION_MAX = 150, 300
HEARTBEAT_MS = 50
CLIENT_MS = 100

# Message/timer tag enum mirrors the spec's declaration order — kept
# as module constants so adapters and tools can name wire rows without
# reaching into the compiled protocol.
REQ, P1A, P1B, P2A, P2B, HB, HBR, CREQ, CREP, REPLY = range(10)
T_ELECTION, T_HEARTBEAT, T_CLIENT = 1, 2, 3

# The hand twin's _pack_entry ballot width: ballots at or past this
# value are a loud overflow (there: EXC_PACK_WIDTH; here: the packed
# lane's declared domain) — never silent aliasing.
BALLOT_HI = (1 << 12) - 1


def _max(a, b):
    """Elementwise maximum of two values, either a tensor or an int."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    return (torch.maximum(a, b) if isinstance(b, torch.Tensor)
            else a.clamp(min=b))


def _min(a, b):
    """Elementwise minimum of two values, either a tensor or an int."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    return (torch.minimum(a, b) if isinstance(b, torch.Tensor)
            else a.clamp(max=b))


def make_paxos_spec(n: int = 3, n_clients: int = 1, w: int = 1,
                    max_slots: int = 2, net_cap: int = 64,
                    timer_cap: int = 8, fault=None) -> ProtocolSpec:
    S, NC = max_slots, n_clients
    cmd_hi = NC * w

    def cmd_id(client, seq):
        return client * w + seq        # 1-based; 0 = none/noop

    def cmd_client(cmd):
        return (cmd - 1) // w

    def cmd_seq(cmd):
        return (cmd - 1) % w + 1

    # ---- state: one Slots block per replicated structure ------------
    # Lane ORDER differs from the hand twin (struct-of-arrays vs the
    # hand interleave) — a bijective permutation, counts preserved.
    log = Slots("log", S, base=1, fields=(
        SlotField("ex", hi=1), SlotField("lb", hi=BALLOT_HI),
        SlotField("cmd", hi=cmd_hi), SlotField("ch", hi=1)))
    p2bv = Slots("p2bv", S, base=1, fields=(
        SlotField("v", hi=(1 << n) - 1),))
    # Raw P1b votes, one record per PEER: have flag + S packed-log
    # quadruples (the hand twin's votes [n, 1+4S] block).
    vote_fields = [SlotField("have",
                             init=lambda i, j: 1 if n == 1 else 0,
                             hi=1)]
    for s in range(1, S + 1):
        vote_fields += [SlotField(f"ex{s}", hi=1),
                        SlotField(f"lb{s}", hi=BALLOT_HI),
                        SlotField(f"cmd{s}", hi=cmd_hi),
                        SlotField(f"ch{s}", hi=1)]
    votes = Slots("votes", n, fields=tuple(vote_fields))

    server = NodeKind("server", n, (
        Field("b", init=1 if n == 1 else 0, hi=BALLOT_HI),
        Field("ld", init=1 if n == 1 else 0, hi=1),
        Field("hd", hi=1),
        Field("si", init=1, lo=1, hi=S + 1),
        Field("ex", hi=S), Field("cl", hi=S), Field("gc", hi=S),
        Field("pm", hi=(1 << n) - 1),
        Field("peer", size=n, hi=S, index_group="server"),
        Field("amo", size=NC, hi=w, index_group="client"),
        Field("prop", size=NC, hi=w, index_group="client"),
        p2bv, log, votes))
    client = NodeKind("client", NC, (Field("k", init=1, hi=w + 1),))

    # ---- message/timer enums: tag order and payload lane order are
    # the hand twin's (record-identical wire forms).
    e_hi = 3 + (BALLOT_HI << 2) + (cmd_hi << 14)
    bal = (0, BALLOT_HI)
    messages = [
        MessageType("Request", ("client", "seq"),
                    bounds={"client": (0, max(NC - 1, 0)),
                            "seq": (1, w)}),
        MessageType("P1a", ("b",), bounds={"b": bal}),
        MessageType("P1b", ("b",) + tuple(f"e{s}"
                                          for s in range(1, S + 1)),
                    bounds={"b": bal} | {f"e{s}": (0, e_hi)
                                         for s in range(1, S + 1)}),
        MessageType("P2a", ("b", "slot", "cmd"),
                    bounds={"b": bal, "slot": (1, S),
                            "cmd": (0, cmd_hi)}),
        MessageType("P2b", ("b", "slot"),
                    bounds={"b": bal, "slot": (1, S)}),
        MessageType("Heartbeat", ("b", "commit", "gc"),
                    bounds={"b": bal, "commit": (0, S), "gc": (0, S)}),
        MessageType("HeartbeatReply", ("b", "exec"),
                    bounds={"b": bal, "exec": (0, S)}),
        MessageType("CatchupRequest", ("slot",),
                    bounds={"slot": (1, S + 1)}),
        MessageType("CatchupReply",
                    ("base", "count") + tuple(f"c{s}"
                                              for s in range(1, S + 1)),
                    bounds={"base": (1, S + 1), "count": (0, S)}
                    | {f"c{s}": (0, cmd_hi) for s in range(1, S + 1)}),
        MessageType("Reply", ("client", "seq"),
                    bounds={"client": (0, max(NC - 1, 0)),
                            "seq": (1, w)}),
    ]
    timers = [
        TimerType("Election", (), min_ms=ELECTION_MIN,
                  max_ms=ELECTION_MAX),
        TimerType("Heartbeat", ("b",), min_ms=HEARTBEAT_MS,
                  max_ms=HEARTBEAT_MS, bounds={"b": bal}),
        TimerType("Client", ("k",), min_ms=CLIENT_MS, max_ms=CLIENT_MS,
                  bounds={"k": (1, w)}),
    ]

    spec = ProtocolSpec(
        name=f"paxos-n{n}-c{NC}-w{w}-s{S}",
        nodes=[server, client], messages=messages, timers=timers,
        net_cap=net_cap, timer_cap=timer_cap, fault=fault,
        quorums=(QuorumCount("servers", over="server",
                             threshold="majority"),))

    # ------------------------------------------------- shared helpers
    # Each mirrors the hand twin's helper of the same name; `ctx` is
    # already refined to the branch condition, `when` carries any extra.

    def pack_entry(ex, lb, cmd, ch):
        return ex | (ch << 1) | (lb << 2) | (cmd << 14)

    def unpack_entry(v):
        return v & 1, (v >> 2) & 0xFFF, v >> 14, (v >> 1) & 1

    def log_get(ctx, slot):
        return (ctx.slot_get("log", "ex", slot),
                ctx.slot_get("log", "lb", slot),
                ctx.slot_get("log", "cmd", slot),
                ctx.slot_get("log", "ch", slot))

    def log_set(ctx, slot, ex, lb, cmd, ch, when=True):
        ctx.slot_put("log", "ex", slot, ex, when=when)
        ctx.slot_put("log", "lb", slot, lb, when=when)
        ctx.slot_put("log", "cmd", slot, cmd, when=when)
        ctx.slot_put("log", "ch", slot, ch, when=when)

    def exec_chain(ctx):
        """Execute contiguous chosen slots (paxos.py _execute_chosen),
        sending client replies; leader updates its own peer_executed."""
        i = ctx.node_index()
        for _ in range(S):
            ex = ctx.get("ex")
            e_ex, _lb, cmd, e_ch = log_get(ctx, ex + 1)
            can = (ex + 1 <= S) & (e_ex == 1) & (e_ch == 1)
            ctx.put("ex", ex + 1, when=can)
            has_cmd = can & (cmd != 0)
            cl = cmd_client(cmd).clip(0, NC - 1)
            sq = cmd_seq(cmd)
            last = ctx.get_at("amo", cl)
            ctx.send("Reply", to=n + cl, when=has_cmd & (sq >= last),
                     client=cl, seq=sq)
            ctx.put_at("amo", cl, _max(last, sq), when=has_cmd)
        is_leader = (ctx.get("ld") == 1) & (ctx.get("b") % n == i)
        ctx.put("pm", ctx.get("pm") | (1 << i), when=is_leader)
        ctx.put_at("peer", i, ctx.get("ex"), when=is_leader)
        maybe_gc(ctx, is_leader)

    def maybe_gc(ctx, when):
        mask = ctx.get("pm")
        floor = ctx.get_at("peer", 0)
        for j in range(1, n):
            floor = _min(floor, ctx.get_at("peer", j))
        do = when & (mask == (1 << n) - 1) & (floor > ctx.get("gc"))
        ctx.put("gc", floor, when=do)
        gc_to(ctx, floor, do)

    def gc_to(ctx, through, when):
        through = _min(through, ctx.get("ex"))
        do = when & (through > ctx.get("cl"))
        # Slots at or below the collective floor reset to their
        # cleared value — the slot-windowed garbage bound (slots below
        # `cl` are already cleared, so the wider window is idempotent).
        ctx.slot_clear_upto("log", through + 1, when=do)
        ctx.put("cl", through, when=do)

    def accept_p2a(ctx, ballot, slot, cmd, when=True):
        e_ex, _lb, _c, e_ch = log_get(ctx, slot)
        write = when & (slot > ctx.get("cl")) \
            & ~((e_ex == 1) & (e_ch == 1))
        log_set(ctx, slot, 1, ballot, cmd, 0, when=write)

    def send_p2a(ctx, slot):
        """Broadcast P2a for log[slot] + inline self-accept/self-vote
        (singleton groups complete the agreement in the same step)."""
        i = ctx.node_index()
        _ex, _lb, cmd, _ch = log_get(ctx, slot)
        ballot = ctx.get("b")
        for j in range(n):
            if j != i:
                ctx.send("P2a", to=j, b=ballot, slot=slot, cmd=cmd)
        accept_p2a(ctx, ballot, slot, cmd)
        ctx.put("hd", 1)
        e_ex, e_lb, _c, e_ch = log_get(ctx, slot)
        ok = (ctx.get("b") == ballot) & (e_ex == 1) & (e_ch == 0) \
            & (e_lb == ballot)
        ctx.slot_put("p2bv", "v", slot,
                     ctx.slot_get("p2bv", "v", slot) | (1 << i),
                     when=ok)
        if n == 1:
            e_ex, e_lb, e_cmd, e_ch = log_get(ctx, slot)
            ch = (e_ex == 1) & (e_ch == 0) & (e_lb == ballot)
            ctx.slot_put("p2bv", "v", slot, 0, when=ch)
            log_set(ctx, slot, 1, e_lb, e_cmd, 1, when=ch)
            exec_chain(ctx.cond(ch))

    def heartbeat_sends(ctx):
        i = ctx.node_index()
        for j in range(n):
            if j != i:
                ctx.send("Heartbeat", to=j, b=ctx.get("b"),
                         commit=ctx.get("ex"), gc=ctx.get("gc"))

    def p1b_win(ctx):
        """Phase-1 victory (handle_P1b body after majority); ctx is
        refined to the win condition."""
        i = ctx.node_index()
        ballot = ctx.get("b")
        ctx.put("ld", 1)
        ctx.put("p2bv.v", 0)
        ctx.put("pm", 1 << i)
        ex_self = ctx.get("ex")
        for j in range(n):
            ctx.put_at("peer", j, ex_self if j == i else 0)
        # Adoption: per slot, chosen wins; else max-ballot accepted.
        for s in range(1, S + 1):
            # a_ex is held as a flag: it only ever goes from 0 to 1.
            a_ex, a_b, a_c, a_ch = False, -1, 0, 0
            for j in range(n):
                have = ctx.slot_get("votes", "have", j)
                ex = ctx.slot_get("votes", f"ex{s}", j)
                vb = ctx.slot_get("votes", f"lb{s}", j)
                vc = ctx.slot_get("votes", f"cmd{s}", j)
                vch = ctx.slot_get("votes", f"ch{s}", j)
                valid = (have == 1) & (ex == 1)
                not_ex = ~a_ex if isinstance(a_ex, torch.Tensor) else True
                take = valid & ((vch == 1) & (a_ch == 0)
                                | (a_ch == 0) & (not_ex | (vb > a_b)))
                a_b = torch.where(take, vb, a_b)
                a_c = torch.where(take, vc, a_c)
                a_ch = torch.where(take, _max(a_ch, vch), a_ch)
                a_ex = take | a_ex
            m_ex, _lb, _c, m_ch = log_get(ctx, s)
            adopt = a_ex & (s > ctx.get("cl")) \
                & ~((m_ex == 1) & (m_ch == 1))
            log_set(ctx, s, 1, ballot, a_c, a_ch, when=adopt)
        # top = last non-empty; fill holes with no-ops; repropose
        # unchosen.
        top = ctx.get("cl")
        for s in range(1, S + 1):
            e_ex = ctx.slot_get("log", "ex", s)
            top = torch.where(e_ex == 1, s, top)
        for s in range(1, S + 1):
            e_ex = ctx.slot_get("log", "ex", s)
            in_span = (s > ctx.get("ex")) & (s <= top)
            log_set(ctx, s, 1, ballot, 0, 0, when=in_span & (e_ex == 0))
            reprop = in_span & (ctx.slot_get("log", "ch", s) == 0)
            send_p2a(ctx.cond(reprop), s)
        ctx.put("si", top + 1)
        # proposed_seq from logged commands (max seq per client).
        for c in range(NC):
            best = 0
            for s in range(1, S + 1):
                e_ex, _lb, e_cmd, _ch = log_get(ctx, s)
                mine = (e_ex == 1) & (e_cmd != 0) \
                    & (cmd_client(e_cmd) == c)
                best = torch.where(mine, _max(best, cmd_seq(e_cmd)),
                                   best)
            ctx.put_at("prop", c, best)
        exec_chain(ctx)
        ctx.set_timer("Heartbeat", b=ballot)
        heartbeat_sends(ctx)

    # ----------------------------------------------- message handlers

    @spec.on("server", "Request")
    def srv_request(ctx, p):
        i = ctx.node_index()
        client, seq, frm = p["client"], p["seq"], p["_from"]
        b = ctx.get("b")
        ci = client.clip(0, NC - 1)
        last = ctx.get_at("amo", ci)
        already = seq <= last
        ctx.send("Reply", to=n + client,
                 when=already & (seq == last), client=client, seq=seq)
        is_leader = (ctx.get("ld") == 1) & (b % n == i)
        believed = b % n
        ctx.send("Request", to=believed,
                 when=~already & ~is_leader & ((frm == i) | (frm >= n))
                 & (believed != i), client=client, seq=seq)
        prop = ctx.get_at("prop", ci)
        slot = ctx.get("si")
        do_prop = ~already & is_leader & (seq > prop) & (slot <= S)
        ctx.put_at("prop", ci, seq, when=do_prop)
        ctx.put("si", slot + 1, when=do_prop)
        pctx = ctx.cond(do_prop)
        log_set(pctx, slot, 1, b, cmd_id(client, seq), 0)
        send_p2a(pctx, slot)

    @spec.on("server", "P1a")
    def srv_p1a(ctx, p):
        mb, frm = p["b"], p["_from"]
        adopt = mb > ctx.get("b")
        ctx.put("b", mb, when=adopt)
        ctx.put("ld", 0, when=adopt)
        ctx.send("P1b", to=frm, when=mb == ctx.get("b"),
                 b=ctx.get("b"),
                 **{f"e{s}": pack_entry(*log_get(ctx, s))
                    for s in range(1, S + 1)})

    @spec.on("server", "P1b")
    def srv_p1b(ctx, p):
        i = ctx.node_index()
        vb, frm = p["b"], p["_from"]
        accept_vote = (vb == ctx.get("b")) & (ctx.get("b") % n == i) \
            & (ctx.get("ld") == 0)
        ctx.slot_put("votes", "have", frm, 1, when=accept_vote)
        for s in range(1, S + 1):
            ex, lb, cmd, ch = unpack_entry(p[f"e{s}"])
            ctx.slot_put("votes", f"ex{s}", frm, ex, when=accept_vote)
            ctx.slot_put("votes", f"lb{s}", frm, lb, when=accept_vote)
            ctx.slot_put("votes", f"cmd{s}", frm, cmd,
                         when=accept_vote)
            ctx.slot_put("votes", f"ch{s}", frm, ch, when=accept_vote)
        q = ctx.quorum("servers")
        win = accept_vote & q.met(ctx.get("votes.have"))
        p1b_win(ctx.cond(win))

    @spec.on("server", "P2a")
    def srv_p2a(ctx, p):
        ab, aslot, acmd, frm = p["b"], p["slot"], p["cmd"], p["_from"]
        ok = ab >= ctx.get("b")
        ctx.put("ld", 0, when=ok & (ab > ctx.get("b")))
        ctx.put("b", ab, when=ok)
        ctx.put("hd", 1, when=ok)
        accept_p2a(ctx, ab, aslot, acmd, when=ok)
        ctx.send("P2b", to=frm, when=ok, b=ab, slot=aslot)

    @spec.on("server", "P2b")
    def srv_p2b(ctx, p):
        i = ctx.node_index()
        bb, bslot, frm = p["b"], p["slot"], p["_from"]
        lead_ok = (bb == ctx.get("b")) & (ctx.get("ld") == 1) \
            & (ctx.get("b") % n == i)
        e_ex, e_lb, e_cmd, e_ch = log_get(ctx, bslot)
        count_ok = lead_ok & (e_ex == 1) & (e_ch == 0) & (e_lb == bb)
        vmask = ctx.slot_get("p2bv", "v", bslot)
        vmask2 = torch.where(count_ok,
                             vmask | (1 << frm.clip(0, n - 1)), vmask)
        q = ctx.quorum("servers")
        chosen_now = count_ok & q.met_bits(vmask2)
        ctx.slot_put("p2bv", "v", bslot,
                     torch.where(chosen_now, 0, vmask2), when=count_ok)
        log_set(ctx, bslot, 1, e_lb, e_cmd, 1, when=chosen_now)
        exec_chain(ctx.cond(chosen_now))

    @spec.on("server", "Heartbeat")
    def srv_heartbeat(ctx, p):
        hb_b, hb_commit, hb_gc = p["b"], p["commit"], p["gc"]
        frm = p["_from"]
        ok = hb_b >= ctx.get("b")
        ctx.put("ld", 0, when=ok & (hb_b > ctx.get("b")))
        ctx.put("b", hb_b, when=ok)
        ctx.put("hd", 1, when=ok)
        gc_to(ctx, hb_gc, ok)
        ctx.send("CatchupRequest", to=frm,
                 when=ok & (ctx.get("ex") < hb_commit),
                 slot=ctx.get("ex") + 1)
        ctx.send("HeartbeatReply", to=frm, when=ok, b=ctx.get("b"),
                 exec=ctx.get("ex"))

    @spec.on("server", "HeartbeatReply")
    def srv_heartbeat_reply(ctx, p):
        i = ctx.node_index()
        rb, rexec, frm = p["b"], p["exec"], p["_from"]
        ok = (rb == ctx.get("b")) & (ctx.get("ld") == 1) \
            & (ctx.get("b") % n == i)
        pcur = ctx.get_at("peer", frm)
        ctx.put_at("peer", frm, torch.maximum(pcur, rexec), when=ok)
        ctx.put("pm", ctx.get("pm") | (1 << frm.clip(0, n - 1)),
                when=ok)
        maybe_gc(ctx, ok)

    @spec.on("server", "CatchupRequest")
    def srv_catchup_request(ctx, p):
        frm = p["_from"]
        from_slot = torch.maximum(p["slot"], ctx.get("cl") + 1)
        cmds = {}
        count = 0
        contiguous = True
        for k in range(S):
            slot = from_slot + k
            e_ex, _lb, e_cmd, e_ch = log_get(ctx, slot)
            ok = contiguous & (slot <= ctx.get("ex")) & (e_ex == 1) \
                & (e_ch == 1)
            contiguous = ok
            cmds[f"c{k + 1}"] = torch.where(ok, e_cmd, 0)
            count = count + ok.to(torch.int32)
        ctx.send("CatchupReply", to=frm, when=count > 0,
                 base=from_slot, count=count, **cmds)

    @spec.on("server", "CatchupReply")
    def srv_catchup_reply(ctx, p):
        base, ccount = p["base"], p["count"]
        for k in range(S):
            slot = base + k
            e_ex, _lb, _c, e_ch = log_get(ctx, slot)
            install = (k < ccount) & (slot > ctx.get("cl")) \
                & ~((e_ex == 1) & (e_ch == 1))
            log_set(ctx, slot, 1, ctx.get("b"), p[f"c{k + 1}"], 1,
                    when=install)
        exec_chain(ctx)

    @spec.on("client", "Reply")
    def cli_reply(ctx, p):
        c = ctx.node_index() - n
        k = ctx.get("k")
        match = (p["client"] == c) & (p["seq"] == k) & (k <= w)
        k2 = torch.where(match, k + 1, k)
        ctx.put("k", k2)
        has_next = match & (k2 <= w)
        for j in range(n):
            ctx.send("Request", to=j, when=has_next, client=c, seq=k2)
        ctx.set_timer("Client", when=has_next, k=k2)

    # ------------------------------------------------- timer handlers

    @spec.on_timer("server", "Election")
    def srv_election(ctx, p):
        i = ctx.node_index()
        b = ctx.get("b")
        is_leader = (ctx.get("ld") == 1) & (b % n == i)
        elect = ~is_leader & (ctx.get("hd") == 0)
        new_ballot = (b // n + 1) * n + i
        ctx.put("b", new_ballot, when=elect)
        ctx.put("ld", 0, when=elect)
        for sf in votes.fields:
            ctx.put(votes.lane(sf.name), 0, when=elect)
        for j in range(n):
            if j != i:
                ctx.send("P1a", to=j, when=elect, b=new_ballot)
        # Self-promise: own vote with own log (P1a -> P1b
        # self-delivery).
        ectx = ctx.cond(elect)
        ectx.slot_put("votes", "have", i, 1)
        for s in range(1, S + 1):
            e_ex, e_lb, e_cmd, e_ch = log_get(ectx, s)
            ectx.slot_put("votes", f"ex{s}", i, e_ex)
            ectx.slot_put("votes", f"lb{s}", i, e_lb)
            ectx.slot_put("votes", f"cmd{s}", i, e_cmd)
            ectx.slot_put("votes", f"ch{s}", i, e_ch)
        if n == 1:
            # Singleton group: our own vote IS the majority — the
            # object server wins phase 1 inside the same ElectionTimer
            # handler, so the generated twin fires the win cascade here
            # (it arms the leader heartbeat itself).
            p1b_win(ectx)
        ctx.put("hd", 0)
        ctx.set_timer("Election")

    @spec.on_timer("server", "Heartbeat")
    def srv_heartbeat_timer(ctx, p):
        i = ctx.node_index()
        live = (p["b"] == ctx.get("b")) & (ctx.get("ld") == 1) \
            & (ctx.get("b") % n == i)
        lctx = ctx.cond(live)
        heartbeat_sends(lctx)
        for s in range(1, S + 1):
            e_ex = ctx.slot_get("log", "ex", s)
            e_ch = ctx.slot_get("log", "ch", s)
            inflight = live & (s > ctx.get("ex")) \
                & (s < ctx.get("si")) & (e_ex == 1) & (e_ch == 0)
            send_p2a(ctx.cond(inflight), s)
        ctx.set_timer("Heartbeat", when=live, b=p["b"])

    @spec.on_timer("client", "Client")
    def cli_timer(ctx, p):
        c = ctx.node_index() - n
        k = ctx.get("k")
        live = (p["k"] == k) & (k <= w)
        for j in range(n):
            ctx.send("Request", to=j, when=live, client=c, seq=k)
        ctx.set_timer("Client", when=live, k=k)

    # -------------------------------------------- initials/predicates

    for c in range(NC):
        for j in range(n):
            spec.initial_messages.append(
                ("Request", n + c, j, {"client": c, "seq": 1}))
    for i in range(n):
        spec.initial_timers.append(("Election", i, {}))
        if n == 1:
            # A lone server self-elects SYNCHRONOUSLY at init (the
            # object never spends an ElectionTimer event becoming
            # leader); its win cascade armed the heartbeat, so the root
            # timer queue is [Election, Heartbeat].
            spec.initial_timers.append(("Heartbeat", i, {"b": 1}))
    for c in range(NC):
        spec.initial_timers.append(("Client", n + c, {"k": 1}))

    def clients_done(view):
        done = True
        for c in range(NC):
            done = done & (view.get("client", c, "k") == w + 1)
        return done

    def logs_consistent(view):
        """slotValid core: no two different commands chosen in a
        slot."""
        def lane(i, field, s):
            v = view.get("server", i, field)
            return v if S == 1 else v[:, s - 1]

        ok = True
        for s in range(1, S + 1):
            # seen is held as a flag: it only ever goes from 0 to 1.
            chosen_cmd, seen, bad = -1, False, False
            for i in range(n):
                e0 = lane(i, "log.ex", s)
                ech = lane(i, "log.ch", s)
                ec = lane(i, "log.cmd", s)
                is_ch = (e0 == 1) & (ech == 1)
                bad = bad | (is_ch & seen & (ec != chosen_cmd))
                chosen_cmd = torch.where(is_ch, ec, chosen_cmd)
                seen = is_ch | seen
            ok = ok & ~bad
        return ok

    spec.goals["CLIENTS_DONE"] = clients_done
    spec.invariants["LOGS_CONSISTENT"] = logs_consistent
    return spec


def make_paxos_protocol(n: int = 3, n_clients: int = 1, w: int = 1,
                        max_slots: int = 2, net_cap: int = 64,
                        timer_cap: int = 8, fault=None):
    """Drop-in replacement for the deleted hand twin's factory: same
    signature, same protocol name, same searched state space (exact
    pinned-count parity) — now compiled from the spec."""
    return make_paxos_spec(n, n_clients, w, max_slots, net_cap,
                           timer_cap, fault=fault).compile()


def make_paxos_partition_spec(n: int = 3, n_clients: int = 1,
                              w: int = 1, max_slots: int = 2,
                              net_cap: int = 64,
                              timer_cap: int = 8) -> ProtocolSpec:
    """The generated multi-decree paxos under a one-era partition
    scenario: the last server is isolated from the rest until the heal.
    CUT/HEAL interleave with protocol events as ordinary model
    transitions, so leader elections that straddle the cut are explored
    exhaustively; the clients are never cut off.  The spec builds;
    compiling it raises until fault models are ported."""
    from dslabs_tpu_torch.tpu.faults import FaultModel, Partition

    fm = FaultModel(partition=Partition(blocks=(
        tuple(("server", i) for i in range(n - 1)),
        (("server", n - 1),)), max_eras=1))
    spec = make_paxos_spec(n, n_clients, w, max_slots, net_cap,
                           timer_cap, fault=fm)
    spec.name += "-part"
    return spec


def paxos_layout(n: int, n_clients: int, max_slots: int) -> dict:
    """Per-server lane offsets of the GENERATED node vector, for the
    harness backend's lane predicates (tpu/adapters/paxos.py).  Keys
    name spec fields; "SW"/"NW"/"N_NODES" mirror the old hand-layout
    helper so adapter arithmetic stays one lookup away from the spec."""
    spec = make_paxos_spec(n, n_clients, max_slots=max_slots)
    table, nw = spec._layout()
    offs = {f: off for (kind, i, f), (off, _s)
            in table.items() if kind == "server" and i == 0}
    sw = (table[("server", 1, "b")][0] if n > 1
          else max(off + s for (k, _i, _f), (off, s) in table.items()
                   if k == "server"))
    cli0 = table[("client", 0, "k")][0]
    return offs | {"SW": sw, "NW": nw, "N_NODES": n + n_clients,
                   "CLI0": cli0}
