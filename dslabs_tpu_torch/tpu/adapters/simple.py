"""Lab 0 (ping-pong), lab 1 (exactly-once client/server) and lab 2
(primary-backup) twin adapters for the harness search backend
(tpu/backend.py); counterpart of ``dslabs_tpu/tpu/adapters/simple.py``,
bound to the port's hand twins in ``tpu/protocols/``.

Both twins collapse application values to per-client sequence progress
(tpu/protocols/pingpong.py, clientserver.py docstrings); the adapters
rebuild exact object messages from the binding's ACTUAL workloads, and
resolve the one value the twins do not model — the server reply's
application result — from the replayed object state's network via
MessageTemplate (tpu/trace.py), the same value-collapse discipline as
the paxos adapter (tpu/adapters/paxos.py docstring).

Lane predicates and delivery masks take a leading batch dimension: a
predicate maps a state batch to [N] bool, a mask maps message records
[..., MW] to bool [...] by a gather from the link matrix."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from dslabs_tpu_torch.tpu.adapters.paxos import _num_suffix, _workload_pairs
from dslabs_tpu_torch.tpu.backend import (NoTensorTwin, TwinBinding,
                                    register_adapter)

__all__ = ["PingPongBinding", "ClientServerBinding",
           "PrimaryBackupBinding"]


def _true(s):
    """Constant-true [N] bool over a state batch."""
    return torch.ones(s["nodes"].shape[0], dtype=torch.bool,
                      device=s["nodes"].device)


def _all_clients(k, s, nc, want):
    """[N] bool: every client's seq lane equals ``want``."""
    return torch.stack([k(s, c) == want for c in range(nc)]).all(0)


class PingPongBinding(TwinBinding):
    """One PingServer + one ClientWorker(PingClient) walking a finite
    echo workload; twin node indices: server 0, client 1."""

    def __init__(self, state):
        workers = state.client_workers()
        self.server_name = str(next(iter(state.servers)))
        self.client_name = str(next(iter(workers)))
        self.addr_index = {self.server_name: 0, self.client_name: 1}
        (addr, worker), = workers.items()
        pairs = _workload_pairs(worker, addr)
        self.cmds = [c for c, _ in pairs]
        for c, r in pairs:
            if r is not None and r.value != c.value:
                raise NoTensorTwin(
                    "pingpong twin models the echo server; expected "
                    f"result {r!r} != command {c!r}")
        self.w = len(pairs)
        self.key = ("pingpong", self.server_name, self.client_name,
                    tuple(repr(c) for c in self.cmds))

    def initial_caps(self):
        return 8, 4

    def build_protocol(self, net_cap, timer_cap):
        from dslabs_tpu_torch.tpu.protocols.pingpong import \
            make_pingpong_protocol

        p = make_pingpong_protocol(self.w)
        return dataclasses.replace(
            p, net_cap=max(net_cap // 4, p.net_cap),
            timer_cap=max(timer_cap // 2, p.timer_cap),
            decode_message=self._decode_message,
            decode_timer=self._decode_timer)

    def _decode_message(self, rec):
        from dslabs_tpu_torch.core.address import LocalAddress
        from dslabs_tpu_torch.labs.pingpong.pingpong import (PingRequest,
                                                       PongReply, Pong)
        from dslabs_tpu_torch.tpu.protocols.pingpong import REQ

        tag, i = int(rec[0]), int(rec[1])
        server = LocalAddress(self.server_name)
        client = LocalAddress(self.client_name)
        cmd = self.cmds[i - 1]
        if tag == REQ:
            return client, server, PingRequest(cmd)
        return server, client, PongReply(Pong(cmd.value))

    def _decode_timer(self, node_idx, rec):
        from dslabs_tpu_torch.core.address import LocalAddress
        from dslabs_tpu_torch.labs.pingpong.pingpong import PingTimer
        from dslabs_tpu_torch.tpu.protocols.pingpong import PING_MS

        i = int(rec[3])
        return (LocalAddress(self.client_name), PingTimer(self.cmds[i - 1]),
                PING_MS, PING_MS)

    def msg_mask_fn(self):
        # Record layout [tag, i]: REQ rides client(1) -> server(0),
        # REPLY the reverse — no frm/to lanes to read.
        from dslabs_tpu_torch.tpu.protocols.pingpong import REQ

        def fn(msg, marr):
            return marr[torch.where(msg[..., 0] == REQ, 1 * 2 + 0,
                                    0 * 2 + 1).long()]
        return fn

    def predicate(self, tkey):
        kind = tkey[0]
        w = self.w

        def k(s):
            return s["nodes"][:, 0]

        if kind in ("RESULTS_OK", "RESULTS_LINEARIZABLE",
                    "ALL_RESULTS_SAME"):
            fn = lambda s: _true(s)     # noqa: E731
            fn.value_level = True       # object-side re-check on exhaust
            return fn
        if kind in ("CLIENTS_DONE", "CLIENT_DONE"):
            return lambda s: k(s) == w + 1
        if kind == "NONE_DECIDED":
            return lambda s: k(s) == 1
        if kind == "CLIENT_HAS_RESULTS":
            return lambda s: k(s) >= tkey[2] + 1
        return None


class _StreamPairs:
    """Command lookup for INFINITE workloads under the counter-mode
    deterministic streams (testing/workload.py stream_rng): the pair at
    1-based index i is a pure function of (client address, i-1), so
    decode seeks the workload copy directly — no history replay, no
    global-rng irreproducibility (round-4 verdict item 8; the previous
    shape was a loud _NoDecodePairs refusal)."""

    def __init__(self, workload, addr):
        import copy as _copy

        self._wl = _copy.deepcopy(workload)
        self._addr = addr
        self._cache: Dict[int, tuple] = {}

    def __getitem__(self, i):
        from dslabs_tpu_torch.testing.workload import derandomized

        if not derandomized():
            raise NoTensorTwin(
                "random infinite-workload commands are not "
                "reconstructible without the tensor strategy's "
                "derandomized streams")
        if i not in self._cache:
            self._wl._i = i
            self._cache[i] = self._wl._next_pair(self._addr)
        return self._cache[i]


class ClientServerBinding(TwinBinding):
    """One SimpleServer + NC ClientWorker(SimpleClient)s with finite OR
    infinite KV workloads; twin node indices: server 0, client c ->
    1 + c.  Infinite workloads bind with an unreachable done bound (the
    per-client seq lanes are unbounded int32 either way) and lazy
    command decode."""

    def __init__(self, state):
        workers = state.client_workers()
        clients = sorted(workers,
                         key=lambda a: _num_suffix(str(a), "client") or 0)
        self.server_name = str(next(iter(state.servers)))
        self.client_names = [str(a) for a in clients]
        self.nc = len(clients)
        self.addr_index = {self.server_name: 0}
        self.addr_index.update(
            {c: 1 + j for j, c in enumerate(self.client_names)})
        infinite = [workers[a].workload.infinite() for a in clients]
        if all(infinite):
            self.w = 1 << 20        # done (k == w + 1) is unreachable
            self.pairs = [_StreamPairs(workers[a].workload, a)
                          for a in clients]
            # Counter-mode streams are a pure function of (address,
            # index) AND the workload template, so the key carries the
            # type + template signature: same-type workloads with
            # different command templates must NOT be interchangeable
            # across staged phases (the command reconstruction would
            # silently decode the wrong commands), while identical
            # templates are (round-4: a uuid nonce made every staged
            # reuse a refusal).
            def sig(wl):
                return (type(wl).__name__,
                        tuple(wl._command_strings or ())
                        if wl._commands is None
                        else tuple(repr(c) for c in wl._commands),
                        tuple(wl._result_strings or ()))

            self.key = ("clientserver", self.server_name,
                        tuple(self.client_names), "infinite",
                        tuple(sig(workers[a].workload)
                              for a in clients))
        elif any(infinite):
            raise NoTensorTwin("mixed finite/infinite workloads")
        else:
            pairs = [_workload_pairs(workers[a], a) for a in clients]
            sizes = {len(p) for p in pairs}
            if len(sizes) != 1:
                raise NoTensorTwin(
                    f"per-client workload sizes differ ({sizes})")
            self.w = sizes.pop()
            self.pairs = pairs
            self.key = ("clientserver", self.server_name,
                        tuple(self.client_names),
                        tuple(repr(c) for p in pairs for c, _ in p))

    def initial_caps(self):
        return 16, 4

    def build_protocol(self, net_cap, timer_cap):
        from dslabs_tpu_torch.tpu.protocols.clientserver import \
            make_clientserver_protocol

        p = make_clientserver_protocol(n_clients=self.nc, w=self.w,
                                       net_cap=net_cap,
                                       timer_cap=timer_cap)
        return dataclasses.replace(
            p, decode_message=self._decode_message,
            decode_timer=self._decode_timer)

    def _amo(self, c, s):
        from dslabs_tpu_torch.core.address import LocalAddress
        from dslabs_tpu_torch.labs.clientserver.amo import AMOCommand

        return AMOCommand(self.pairs[c][s - 1][0],
                          LocalAddress(self.client_names[c]), s)

    def _decode_message(self, rec):
        from dslabs_tpu_torch.core.address import LocalAddress
        from dslabs_tpu_torch.labs.clientserver.amo import AMOResult
        from dslabs_tpu_torch.labs.clientserver.clientserver import (Reply,
                                                               Request)
        from dslabs_tpu_torch.tpu.protocols.clientserver import REQ
        from dslabs_tpu_torch.tpu.trace import MessageTemplate

        tag, c, s = int(rec[0]), int(rec[1]), int(rec[2])
        server = LocalAddress(self.server_name)
        client = LocalAddress(self.client_names[c])
        if tag == REQ:
            return client, server, Request(self._amo(c, s))
        fallback = Reply(AMOResult(self.pairs[c][s - 1][1], s))
        return server, client, MessageTemplate(
            Reply, fallback, lambda m, s=s: m.result.sequence_num == s)

    def _decode_timer(self, node_idx, rec):
        from dslabs_tpu_torch.core.address import LocalAddress
        from dslabs_tpu_torch.labs.clientserver.clientserver import ClientTimer
        from dslabs_tpu_torch.tpu.protocols.clientserver import CLIENT_MS

        c, s = int(node_idx) - 1, int(rec[3])
        return (LocalAddress(self.client_names[c]),
                ClientTimer(self._amo(c, s)), CLIENT_MS, CLIENT_MS)

    def msg_mask_fn(self):
        # Record layout [tag, c, s]: REQ rides client(1+c) -> server(0),
        # REPLY the reverse — frm/to derive from (tag, c).
        from dslabs_tpu_torch.tpu.protocols.clientserver import REQ

        nn = 1 + self.nc

        def fn(msg, marr, nn=nn):
            c = msg[..., 1].clamp(0, nn - 2)
            k = torch.where(msg[..., 0] == REQ, (1 + c) * nn + 0,
                            0 * nn + 1 + c)
            return marr[k.long()]
        return fn

    def predicate(self, tkey):
        kind = tkey[0]
        nc, w = self.nc, self.w

        def k(s, c):
            return s["nodes"][:, nc + c]

        if kind in ("RESULTS_OK", "RESULTS_LINEARIZABLE",
                    "ALL_RESULTS_SAME"):
            fn = lambda s: _true(s)      # noqa: E731
            fn.value_level = True        # object-side re-check on exhaust
            return fn
        if kind == "CLIENTS_DONE":
            return lambda s: _all_clients(k, s, nc, w + 1)
        if kind == "NONE_DECIDED":
            return lambda s: _all_clients(k, s, nc, 1)
        if kind == "CLIENT_DONE":
            c = self.client_names.index(str(tkey[1].root_address()))
            return lambda s: k(s, c) == w + 1
        if kind == "CLIENT_HAS_RESULTS":
            c = self.client_names.index(str(tkey[1].root_address()))
            return lambda s: k(s, c) >= tkey[2] + 1
        return None


@register_adapter
def match_pingpong(state):
    from dslabs_tpu_torch.labs.pingpong.pingpong import PingClient, PingServer

    servers = state.servers
    workers = state.client_workers()
    if len(servers) != 1 or len(workers) != 1:
        return None
    if not all(isinstance(s, PingServer) for s in servers.values()):
        return None
    if not all(isinstance(wk.client, PingClient)
               for wk in workers.values()):
        return None
    return PingPongBinding(state)


@register_adapter
def match_clientserver(state):
    from dslabs_tpu_torch.labs.clientserver.clientserver import (SimpleClient,
                                                           SimpleServer)

    servers = state.servers
    workers = state.client_workers()
    if len(servers) != 1 or not workers:
        return None
    if not all(isinstance(s, SimpleServer) for s in servers.values()):
        return None
    if not all(isinstance(wk.client, SimpleClient)
               for wk in workers.values()):
        return None
    return ClientServerBinding(state)


class PrimaryBackupBinding(TwinBinding):
    """Lab 2: ViewServer + NS PBServers + NC ClientWorker(PBClient)s with
    finite KV workloads; twin node indices: viewserver 0, server{s} -> s,
    client c -> NS + 1 + c (tpu/protocols/primarybackup.py lane table).
    The StateTransfer's full application payload — the one field the twin
    collapses to per-client AMO seqs — resolves from the replayed object
    state's network, discriminated by (view_num, per-client last-executed
    seqs), which is exact within the twin's collapse."""

    def __init__(self, state):
        workers = state.client_workers()
        servers = [a for a in state.servers
                   if _num_suffix(str(a), "server") is not None]
        vs = [a for a in state.servers if str(a) not in
              {str(s) for s in servers}]
        if len(vs) != 1:
            raise NoTensorTwin("expected exactly one ViewServer")
        self.vs_name = str(vs[0])
        servers.sort(key=lambda a: _num_suffix(str(a), "server"))
        clients = sorted(workers,
                         key=lambda a: _num_suffix(str(a), "client") or 0)
        self.server_names = [str(a) for a in servers]
        self.client_names = [str(a) for a in clients]
        self.ns, self.nc = len(servers), len(clients)
        self.addr_index = {self.vs_name: 0}
        self.addr_index.update(
            {s: 1 + i for i, s in enumerate(self.server_names)})
        self.addr_index.update(
            {c: 1 + self.ns + j for j, c in enumerate(self.client_names)})
        pairs = [_workload_pairs(workers[a], a) for a in clients]
        sizes = {len(p) for p in pairs}
        if len(sizes) != 1:
            raise NoTensorTwin(
                f"per-client workload sizes differ ({sizes})")
        self.w = sizes.pop()
        self.pairs = pairs
        self.key = ("primarybackup", self.vs_name,
                    tuple(self.server_names), tuple(self.client_names),
                    tuple(repr(c) for p in pairs for c, _ in p))

    def initial_caps(self):
        return 32, 4

    def build_protocol(self, net_cap, timer_cap):
        from dslabs_tpu_torch.tpu.protocols.primarybackup import make_pb_protocol

        p = make_pb_protocol(ns=self.ns, n_clients=self.nc, w=self.w,
                             net_cap=net_cap, timer_cap=timer_cap)
        return dataclasses.replace(
            p, decode_message=self._decode_message,
            decode_timer=self._decode_timer)

    # ------------------------------------------------------------ decoders

    def _addr(self, idx):
        from dslabs_tpu_torch.core.address import LocalAddress

        names = [self.vs_name] + self.server_names + self.client_names
        return LocalAddress(names[int(idx)])

    def _view(self, vn, prim, back):
        from dslabs_tpu_torch.labs.primarybackup.viewserver import View

        return View(int(vn),
                    self._addr(prim) if prim else None,
                    self._addr(back) if back else None)

    def _amo(self, c, s):
        from dslabs_tpu_torch.core.address import LocalAddress
        from dslabs_tpu_torch.labs.clientserver.amo import AMOCommand

        return AMOCommand(self.pairs[c][s - 1][0],
                          LocalAddress(self.client_names[c]), s)

    def _decode_message(self, rec):
        from dslabs_tpu_torch.labs.clientserver.amo import AMOResult
        from dslabs_tpu_torch.labs.primarybackup import pb as P
        from dslabs_tpu_torch.labs.primarybackup import viewserver as V
        from dslabs_tpu_torch.tpu.protocols.primarybackup import (
            FWD, FWDACK, GETVIEW, PING, REPLY, REQ, VIEWREPLY, XFER,
            XFERACK)
        from dslabs_tpu_torch.tpu.trace import MessageTemplate

        r = [int(x) for x in rec]
        tag, frm, to, p = r[0], r[1], r[2], r[3:]
        fa, ta = self._addr(frm), self._addr(to)
        if tag == PING:
            return fa, ta, V.Ping(p[0])
        if tag == GETVIEW:
            return fa, ta, V.GetView()
        if tag == VIEWREPLY:
            return fa, ta, V.ViewReply(self._view(p[0], p[1], p[2]))
        if tag == REQ:
            return fa, ta, P.Request(self._amo(p[0], p[1]))
        if tag == REPLY:
            c, s = p[0], p[1]
            fallback = P.Reply(AMOResult(self.pairs[c][s - 1][1], s))
            return fa, ta, MessageTemplate(
                P.Reply, fallback,
                lambda m, s=s: m.result.sequence_num == s)
        if tag == FWD:
            return fa, ta, P.ForwardRequest(p[0], self._amo(p[1], p[2]))
        if tag == FWDACK:
            return fa, ta, P.ForwardAck(p[0], self._amo(p[1], p[2]))
        if tag == XFER:
            vn, amo = p[0], p[3:3 + self.nc]

            def match(m, vn=vn, amo=tuple(amo)):
                from dslabs_tpu_torch.core.address import LocalAddress

                if m.view.view_num != vn:
                    return False
                for c, want in enumerate(amo):
                    got = m.app.last.get(
                        LocalAddress(self.client_names[c]))
                    if (got[0] if got else 0) != want:
                        return False
                return True

            return fa, ta, MessageTemplate(P.StateTransfer, None, match)
        if tag == XFERACK:
            return fa, ta, P.StateTransferAck(p[0])
        raise NoTensorTwin(f"unknown pb message tag {tag}")

    def _decode_timer(self, node_idx, rec):
        from dslabs_tpu_torch.labs.primarybackup import pb as P
        from dslabs_tpu_torch.labs.primarybackup import viewserver as V
        from dslabs_tpu_torch.tpu.protocols.primarybackup import (
            CLIENT_MS, PING_MS, PINGCHECK_MS, T_CLIENT, T_PING,
            T_PINGCHECK)

        tag, p0 = int(rec[0]), int(rec[3])
        a = self._addr(node_idx)
        if tag == T_PINGCHECK:
            return a, V.PingCheckTimer(), PINGCHECK_MS, PINGCHECK_MS
        if tag == T_PING:
            return a, P.PingTimer(), PING_MS, PING_MS
        if tag == T_CLIENT:
            c = int(node_idx) - 1 - self.ns
            return a, P.ClientTimer(self._amo(c, p0)), CLIENT_MS, CLIENT_MS
        raise NoTensorTwin(f"unknown pb timer tag {tag}")

    # ---------------------------------------------------------- predicates

    def predicate(self, tkey):
        kind = tkey[0]
        ns, nc, w = self.ns, self.nc, self.w
        VSW = 5 + 2 * ns
        SW = 6 + nc
        cb = VSW + ns * SW

        def k(s, c):
            return s["nodes"][:, cb + c * 4]

        if kind in ("RESULTS_OK", "RESULTS_LINEARIZABLE",
                    "ALL_RESULTS_SAME"):
            fn = lambda s: _true(s)      # noqa: E731
            fn.value_level = True        # object-side re-check on exhaust
            return fn
        if kind == "CLIENTS_DONE":
            return lambda s: _all_clients(k, s, nc, w + 1)
        if kind == "NONE_DECIDED":
            return lambda s: _all_clients(k, s, nc, 1)
        if kind == "CLIENT_DONE":
            c = self.client_names.index(str(tkey[1].root_address()))
            return lambda s: k(s, c) == w + 1
        if kind == "CLIENT_HAS_RESULTS":
            c = self.client_names.index(str(tkey[1].root_address()))
            return lambda s: k(s, c) >= tkey[2] + 1
        if kind == "PB_PROMOTED":
            # A named server serves a view with itself primary, no
            # backup, synced (the failover goal, test19).
            pi = self.server_names.index(tkey[1]) + 1

            def fn(s):
                def srv(i, off):
                    return s["nodes"][:, VSW + i * SW + off]
                return ((srv(pi - 1, 1) == pi) & (srv(pi - 1, 2) == 0)
                        & (srv(pi - 1, 3) == 1)
                        & (srv(pi - 1, 0) > 0))
            return fn
        if kind == "PB_VIEW_SYNCED":
            # The lab tests' staged goal: the NAMED primary reports view
            # vn with (primary, backup) and synced, and the named backup
            # reports vn synced — other servers (often gated off) are
            # not constrained (tests/test_lab2_pb.py view2_synced).
            vn = tkey[1]
            pi = self.server_names.index(tkey[2]) + 1
            bi = self.server_names.index(tkey[3]) + 1

            want_acked = len(tkey) > 4 and tkey[4] == "acked"

            def fn(s):
                def srv(i, off):
                    return s["nodes"][:, VSW + i * SW + off]
                ok = ((srv(pi - 1, 0) == vn) & (srv(pi - 1, 1) == pi)
                      & (srv(pi - 1, 2) == bi) & (srv(pi - 1, 3) == 1)
                      & (srv(bi - 1, 0) == vn) & (srv(bi - 1, 3) == 1))
                if want_acked:
                    # ViewServer acked flag (lane 3 of the master block,
                    # tpu/protocols/primarybackup.py _unpack).
                    ok = ok & (s["nodes"][:, 3] == 1)
                return ok
            return fn
        return None


@register_adapter
def match_primarybackup(state):
    from dslabs_tpu_torch.labs.primarybackup.pb import PBClient, PBServer
    from dslabs_tpu_torch.labs.primarybackup.viewserver import ViewServer

    servers = state.servers
    workers = state.client_workers()
    if not servers or not workers:
        return None
    kinds = {type(s) for s in servers.values()}
    if kinds != {ViewServer, PBServer}:
        return None
    if not all(isinstance(wk.client, PBClient)
               for wk in workers.values()):
        return None
    return PrimaryBackupBinding(state)
