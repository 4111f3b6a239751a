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

The object-layer half of the reference module (``replay_on_object``,
``reconstruct_object_trace``, ``MessageTemplate``) needs the port's copy
of the object layer and comes with the harness slice.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from dslabs_tpu_torch.tpu.engine import (SearchOutcome, TensorSearch,
                                         flatten_state)

__all__ = ["decode_trace"]


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
