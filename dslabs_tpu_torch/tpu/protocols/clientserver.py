"""Tensor twin of lab 1 exactly-once client/server, batched (counterpart
of ``dslabs_tpu/tpu/protocols/clientserver.py``; same lanes, bit for bit).

``n_clients`` clients each Put their own key W times through an
AMOApplication(KVStore) server with a 100 ms client retry timer.  Every
object-state component collapses to two small integers per client:

  a_c  server-side AMO last-executed seq for client c,
  k_c  client progress: waiting on command k, or done (W + 1).

Lanes:
  nodes  = [a_0..a_{NC-1}, k_0..k_{NC-1}]   node 0 = server, 1+c = client c
  msg    = [tag, c, seq]                    REQ -> server, REPLY -> client c
  timer  = [tag, min, max, seq]             ClientTimer on node 1+c

Every transition takes a leading batch dimension P.
"""

from __future__ import annotations

import numpy as np
import torch

from dslabs_tpu_torch.tpu.engine import SENTINEL, TensorProtocol

__all__ = ["make_clientserver_protocol"]

REQ, REPLY = 0, 1
T_CLIENT = 1
CLIENT_MS = 100


def _rec(cond, cols):
    """[P, 1, W] record of the lanes ``cols`` where ``cond``, else blank."""
    p = cond.shape[0]
    rec = torch.stack([c.to(torch.int32).expand(p)
                       if isinstance(c, torch.Tensor)
                       else torch.full((p,), c, dtype=torch.int32,
                                       device=cond.device)
                       for c in cols], dim=1)
    return torch.where(cond[:, None], rec, SENTINEL)[:, None, :]


def make_clientserver_protocol(n_clients: int = 1, w: int = 1,
                               net_cap: int = 16,
                               timer_cap: int = 4) -> TensorProtocol:
    NC = n_clients
    MW, TW = 3, 4
    NW = 2 * NC

    def msg_row(cond, tag, c, seq):
        return _rec(cond, (tag, c, seq))

    def timer_row(cond, c, seq):
        return _rec(cond, (1 + c, T_CLIENT, CLIENT_MS, CLIENT_MS, seq))

    def step_message(nodes, msg):
        tag, c, s = msg[:, 0], msg[:, 1], msg[:, 2]
        ci = c.clamp(0, NC - 1).to(torch.int64)
        rows = torch.arange(nodes.shape[0], device=nodes.device)
        nodes = nodes.clone()
        # ---- server: AMO executes fresh seqs, replies for fresh or
        # exactly-cached seqs.
        is_req = tag == REQ
        a = nodes[rows, ci]
        fresh = is_req & (s > a)
        nodes[rows, ci] = torch.where(fresh, s, a).to(torch.int32)
        reply = is_req & (s >= a)
        sends = msg_row(reply, REPLY, c, s)
        # ---- client c: the worker pumps the next command on a match.
        is_rep = tag == REPLY
        k = nodes[rows, NC + ci]
        match = is_rep & (s == k) & (k <= w)
        k2 = torch.where(match, k + 1, k)
        nodes[rows, NC + ci] = k2.to(torch.int32)
        has_next = match & (k2 <= w)
        sends = torch.minimum(sends, msg_row(has_next, REQ, c, k2))
        tsets = timer_row(has_next, ci, k2)
        return nodes, sends, tsets

    def step_timer(nodes, node_idx, timer):
        # ClientTimer on node 1+c: retry iff still waiting on that seq.
        tag, s = timer[:, 0], timer[:, 3]
        ci = (node_idx - 1).clamp(0, NC - 1).to(torch.int64)
        rows = torch.arange(nodes.shape[0], device=nodes.device)
        k = nodes[rows, NC + ci]
        live = (node_idx >= 1) & (tag == T_CLIENT) & (s == k) & (k <= w)
        return nodes, msg_row(live, REQ, ci, k), timer_row(live, ci, k)

    def init_nodes():
        nodes = np.zeros((NW,), np.int32)
        nodes[NC:] = 1            # every client waiting on command 1
        return nodes

    def init_messages():
        return np.array([[REQ, c, 1] for c in range(NC)], np.int32)

    def init_timers():
        return np.array([[1 + c, T_CLIENT, CLIENT_MS, CLIENT_MS, 1]
                         for c in range(NC)], np.int32)

    def msg_dest(msg):
        return torch.where(msg[:, 0] == REQ, 0, 1 + msg[:, 1])

    def clients_done(state):
        return torch.all(state["nodes"][:, NC:2 * NC] == w + 1, dim=1)

    return TensorProtocol(
        name=f"clientserver-c{NC}-w{w}",
        n_nodes=1 + NC,
        node_width=NW,
        msg_width=MW,
        timer_width=TW,
        net_cap=net_cap,
        timer_cap=timer_cap,
        max_sends=1,
        max_sets=1,
        init_nodes=init_nodes,
        init_messages=init_messages,
        init_timers=init_timers,
        step_message=step_message,
        step_timer=step_timer,
        msg_dest=msg_dest,
        goals={"CLIENTS_DONE": clients_done},
    )
