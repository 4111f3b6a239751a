"""Trace decoding in tensor space: from a search outcome's event-id trace
to the concrete message and timer records it delivered.

Counterpart of ``decode_trace`` in ``dslabs_tpu/tpu/trace.py``.  A
``record_trace`` search (``TensorSearch.run_host``) keeps per level the
(parent row, event id) of every kept successor, and
``SearchOutcome.trace`` is the root-first event-id list of the terminal
state.  Event ids alone say nothing without the parent state's canonical
network and timer queues, so :func:`decode_trace` replays the list from
the search's root one state at a time, reading each event's record
before stepping.

The object half maps those records back to object events:
:func:`replay_on_object` passes each record through the protocol's
``decode_message`` / ``decode_timer`` and steps the port's own object
``SearchState`` (``dslabs_tpu_torch/search``) with the envelopes, which
rebuilds the parent chain the minimizer and the trace printer read;
:func:`reconstruct_object_trace` adds the minimization.  A twin that does
not model a field of a message (a reply's application result) decodes it
to a :class:`MessageTemplate`, resolved against the replayed object
state's own network.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from dslabs_tpu_torch.testing.events import MessageEnvelope, TimerEnvelope
from dslabs_tpu_torch.tpu.engine import (SearchOutcome, TensorSearch,
                                         flatten_state)

__all__ = ["decode_trace", "replay_on_object", "reconstruct_object_trace",
           "MessageTemplate"]


class MessageTemplate:
    """A decoded message whose full payload the twin does not model (a
    reply's application result value).  At replay time it resolves
    against the object state's own network, the source of truth for
    application values, and falls back to ``fallback`` only when no
    network message matches.  Ambiguity is a loud error, never a guess."""

    def __init__(self, cls, fallback, match):
        self.cls = cls
        self.fallback = fallback
        self.match = match

    def resolve(self, state, frm, to):
        cands = {m.message for m in state.network()
                 if m.frm.root_address() == frm.root_address()
                 and m.to.root_address() == to.root_address()
                 and isinstance(m.message, self.cls)
                 and self.match(m.message)}
        if len(cands) == 1:
            return next(iter(cands))
        if not cands:
            if self.fallback is None:
                # No object-side candidate and no way to build one: a
                # None message would fail far away in a handler.
                raise ValueError(
                    f"template resolution found no {self.cls.__name__} "
                    f"candidate from {frm} to {to} in the object network "
                    "and the binding provides no fallback")
            return self.fallback
        raise ValueError(
            f"ambiguous template resolution: {len(cands)} distinct "
            f"{self.cls.__name__} candidates from {frm} to {to}")


def decode_trace(search: TensorSearch,
                 outcome: SearchOutcome) -> List[Tuple[str, tuple]]:
    """Replay ``outcome.trace`` (grid event ids) from the root the search
    recorded it against; return root-first records ``("message",
    (lanes,))`` / ``("timer", (node, lanes))``, lanes as numpy int32.

    Raises ``ValueError`` when the outcome has no trace or a step of the
    replay is not deliverable (the trace does not belong to this
    search)."""
    if outcome.trace is None:
        raise ValueError("outcome has no trace "
                         "(run the search with record_trace=True)")
    p = search.p
    # A staged search (run(initial=...)) records against its own root,
    # not the protocol's initial state.
    root = getattr(search, "_trace_root", None)
    if root is None:
        root = search.initial_state()
    row = flatten_state({k: torch.as_tensor(v).to(search.device)
                         for k, v in root.items()})[0]
    tgrid = p.n_nodes * p.timer_cap
    records: List[Tuple[str, tuple]] = []
    for ev in outcome.trace:
        state = search._slice_state(row.cpu().numpy())
        if ev < p.net_cap:
            records.append(("message", (state["net"][ev].copy(),)))
        elif ev < p.net_cap + tgrid:
            node, slot = divmod(ev - p.net_cap, p.timer_cap)
            records.append(("timer",
                            (node, state["timers"][node, slot].copy())))
        else:
            raise NotImplementedError(
                f"{p.name}: trace event {ev} is a fault event; fault "
                "models come with the symmetry + faults slice of the "
                "PyTorch port (see ROADMAP.md)")
        row, valid, _ = search._step_one(row, ev)
        if not bool(valid):
            raise ValueError(
                f"trace replay hit an undeliverable event {ev}: the trace "
                "does not belong to this search's root")
    return records


def replay_on_object(search: TensorSearch, outcome: SearchOutcome,
                     initial_object_state, settings=None):
    """Replay the decoded records on the object twin from
    ``initial_object_state``; return the final object ``SearchState``,
    whose parent chain is the trace.  Raises ``ValueError`` when the
    protocol has no decoders and ``AssertionError`` when the object twin
    rejects a decoded event (a tensor/object divergence)."""
    p = search.p
    if p.decode_message is None or p.decode_timer is None:
        raise ValueError(f"{p.name}: protocol has no object-twin decoders")
    state = initial_object_state
    for kind, payload in decode_trace(search, outcome):
        if kind == "message":
            frm, to, msg = p.decode_message(payload[0])
            if isinstance(msg, MessageTemplate):
                msg = msg.resolve(state, frm, to)
            event = MessageEnvelope(frm, to, msg)
        else:
            node, rec = payload
            to, timer, mn, mx = p.decode_timer(node, rec)
            event = TimerEnvelope(to, timer, mn, mx)
        nxt = state.step_event(event, settings, skip_checks=True)
        assert nxt is not None, (
            f"object twin rejected reconstructed event {event!r} — "
            "tensor/object divergence")
        state = nxt
    return state


def reconstruct_object_trace(search: TensorSearch, outcome: SearchOutcome,
                             initial_object_state, predicate=None,
                             settings=None, minimize: bool = True):
    """Tensor outcome -> replayed object state -> (optionally) minimized
    against ``predicate``, the object analog of the violated invariant or
    matched goal.  ``.print_trace()`` of the result gives the readable
    causal trace."""
    end = replay_on_object(search, outcome, initial_object_state, settings)
    if minimize and predicate is not None:
        from dslabs_tpu_torch.search.minimize import minimize_trace

        end = minimize_trace(end, predicate.check(end))
    return end
