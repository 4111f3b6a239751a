"""Tensor twin of lab 0 ping-pong, batched (counterpart of
``dslabs_tpu/tpu/protocols/pingpong.py``; same lanes, bit for bit).

A stateless PingServer echoes Ping(i) -> Pong(i); a PingClient walks a
``hi-%i`` workload of W commands with a (10, 10) retry timer.  The client
state is one integer k: waiting on command k (1..W) or done (W + 1).

Lanes:
  nodes  = [k]                                   (server is stateless)
  msg    = [tag, i]        tag 0 = PingRequest -> server, 1 = PongReply
  timer  = [tag, min, max, i]                    PingTimer(i), (10, 10)

Every transition takes a leading batch dimension P.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dslabs_tpu_torch.tpu.engine import SENTINEL, TensorProtocol

__all__ = ["make_pingpong_protocol", "make_exhaustive_pingpong",
           "SERVER", "CLIENT"]

SERVER, CLIENT = 0, 1
REQ, REPLY = 0, 1
PING_MS = 10


def _row(cond: torch.Tensor, *cols) -> torch.Tensor:
    """[P, 1, W] record with the given lanes where ``cond``, else blank."""
    p = cond.shape[0]
    rec = torch.stack([c.to(torch.int32).expand(p)
                       if isinstance(c, torch.Tensor)
                       else torch.full((p,), c, dtype=torch.int32,
                                       device=cond.device)
                       for c in cols], dim=1)
    return torch.where(cond[:, None], rec, SENTINEL)[:, None, :]


def make_pingpong_protocol(workload_size: int) -> TensorProtocol:
    w = workload_size
    mw, tw = 2, 4

    def init_nodes():
        return np.array([1], np.int32)  # waiting on command 1

    def init_messages():
        return np.array([[REQ, 1]], np.int32)

    def init_timers():
        return np.array([[CLIENT, 1, PING_MS, PING_MS, 1]], np.int32)

    def step_message(nodes, msg):
        k = nodes[:, 0]
        tag, i = msg[:, 0], msg[:, 1]
        # PingRequest at the server: echo a PongReply.
        is_req = tag == REQ
        req_sends = _row(is_req, REPLY, i)
        # PongReply at the client: if it answers the in-flight ping, the
        # worker records the result and pumps the next command.
        matches = (tag == REPLY) & (k == i) & (k <= w)
        k2 = torch.where(matches, k + 1, k)
        has_next = matches & (k2 <= w)
        reply_sends = _row(has_next, REQ, k2)
        reply_sets = _row(has_next, CLIENT, 1, PING_MS, PING_MS, k2)
        nodes2 = k2[:, None].to(torch.int32)
        sends = torch.where(is_req[:, None, None], req_sends, reply_sends)
        sets = torch.where(is_req[:, None, None], SENTINEL, reply_sets)
        return nodes2, sends, sets

    def step_timer(nodes, node_idx, timer):
        k = nodes[:, 0]
        i = timer[:, 3]
        live = (node_idx == CLIENT) & (k == i) & (k <= w)
        return (nodes, _row(live, REQ, i),
                _row(live, CLIENT, 1, PING_MS, PING_MS, i))

    def msg_dest(msg):
        return torch.where(msg[:, 0] == REQ, SERVER, CLIENT)

    def clients_done(state):
        return state["nodes"][:, 0] == w + 1

    def results_ok(state):
        # The echo protocol cannot mis-answer.
        return torch.ones(state["nodes"].shape[0], dtype=torch.bool,
                          device=state["nodes"].device)

    return TensorProtocol(
        name=f"pingpong-w{w}",
        n_nodes=2,
        node_width=1,
        msg_width=mw,
        timer_width=tw,
        net_cap=2 * w + 2,
        timer_cap=w + 2,
        max_sends=1,
        max_sets=1,
        init_nodes=init_nodes,
        init_messages=init_messages,
        init_timers=init_timers,
        step_message=step_message,
        step_timer=step_timer,
        msg_dest=msg_dest,
        invariants={"RESULTS_OK": results_ok},
        goals={"CLIENTS_DONE": clients_done},
    )


def make_exhaustive_pingpong(workload_size: int = 2) -> TensorProtocol:
    """CLIENTS_DONE as a prune instead of a goal: a strict search then
    measures the full space instead of racing to the first goal."""
    p = make_pingpong_protocol(workload_size)
    return dataclasses.replace(
        p, goals={}, prunes={"CLIENTS_DONE": p.goals["CLIENTS_DONE"]})
