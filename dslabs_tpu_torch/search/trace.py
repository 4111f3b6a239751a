"""Persistent traces and human-readable trace reordering.

Re-design of framework/tst/.../search/SerializableTrace.java:59-254 and the
causal reordering in SearchState.humanReadableTrace (SearchState.java:373-474).

A saved trace = (event history, invariants, node generator, server addresses,
client-worker (address, workload) pairs, lab/part/test metadata), pickled to
``traces/lab<id>[part<p>]_<timestamp>.trace``.  ``initial_state``/``end_state``
reconstruct by replay; loading tolerates stale traces that no longer
unpickle (skipped with a warning).
"""

from __future__ import annotations

import logging
import os
import time

# cloudpickle serializes lambdas/closures by value — the analog of the
# reference's SerializableFunction/Supplier SAM types (utils/Serializable*.java)
# that let predicates, workloads and generators survive trace serialization.
# Port deviation 1: cloudpickle is imported where a trace is saved or
# loaded (``SerializableTrace._cloudpickle``), not here.  The harness
# imports this module, so the lab tests run where cloudpickle is not
# installed; only saving or loading a trace needs it, and there its
# absence raises an ImportError that names it.  The standard ``pickle``
# below is the base of deviation 2's unpickler.
import pickle
from typing import List, Optional, Tuple

from dslabs_tpu_torch.core.address import Address
from dslabs_tpu_torch.search.search_state import SearchState
from dslabs_tpu_torch.testing.events import Event, MessageEnvelope
from dslabs_tpu_torch.testing.generator import NodeGenerator
from dslabs_tpu_torch.testing.predicates import StatePredicate
from dslabs_tpu_torch.testing.workload import Workload

LOG = logging.getLogger("dslabs.trace")

__all__ = ["SerializableTrace", "human_readable_trace",
           "human_readable_trace_end_state", "save_trace", "TRACES_DIR"]

TRACES_DIR = "traces"


def human_readable_trace(state: SearchState) -> List[SearchState]:
    """Topologically reorder a trace into causal order for display.

    Builds the happens-before graph over events: an event depends on (a) the
    step that first sent its message and (b) the previous step at the same
    node; then replays a depth-first linearization
    (SearchState.java:373-474)."""
    original = state.trace()

    class GNode:
        __slots__ = ("event", "next", "previous")

        def __init__(self, event):
            self.event = event
            self.next: List[GNode] = []
            self.previous: List[GNode] = []

    when_sent = {}
    last_step = {}
    init_steps: List[GNode] = []

    for s in original[1:]:
        event = s.previous_event
        gn = GNode(event)
        if isinstance(event, MessageEnvelope):
            sender = when_sent.get(event)
            if sender is not None:
                sender.next.append(gn)
                gn.previous.append(sender)
        a = event.location_root_address()
        if a in last_step:
            p = last_step[a]
            p.next.append(gn)
            gn.previous.append(p)
        last_step[a] = gn
        for me in s.new_messages:
            if me not in when_sent:
                when_sent[me] = gn
        if not gn.previous:
            init_steps.append(gn)

    events: List[Event] = []
    stack = list(init_steps)  # reference reverses then pushes; net: LIFO order
    while stack:
        gn = stack.pop()
        events.append(gn.event)
        for nxt in gn.next:
            nxt.previous.remove(gn)
            if not nxt.previous:
                stack.append(nxt)

    initial = original[0]
    new_trace = [initial]
    prev = initial
    for event in events:
        nxt = prev.step_event(event, None, skip_checks=True)
        if nxt is None:
            LOG.error("Human-readable reorder produced null state; "
                      "returning original trace")
            return original
        if nxt == prev:  # skip no-op events
            continue
        new_trace.append(nxt)
        prev = nxt
    return new_trace


def human_readable_trace_end_state(state: SearchState) -> SearchState:
    return human_readable_trace(state)[-1]


class SerializableTrace:

    def __init__(self, history: List[Event],
                 invariants: List[StatePredicate],
                 generator: NodeGenerator,
                 server_addresses: List[Address],
                 client_workers: List[Tuple[Address, Workload]],
                 lab_id: str, lab_part: Optional[int],
                 test_class_name: str, test_method_name: str):
        self.history = list(history)
        self.invariants = list(invariants)
        self.generator = generator
        self.server_addresses = list(server_addresses)
        self.client_workers = list(client_workers)
        self.lab_id = lab_id
        self.lab_part = lab_part
        self.test_class_name = test_class_name
        self.test_method_name = test_method_name
        self.created_at = time.time()
        self.file_name: Optional[str] = None

    # ------------------------------------------------------------ replaying

    def initial_state(self) -> SearchState:
        state = SearchState(self.generator)
        for a in self.server_addresses:
            state.add_server(a)
        for a, workload in self.client_workers:
            workload.reset()
            state.add_client_worker(a, workload)
        return state

    def end_state(self) -> Optional[SearchState]:
        s = self.initial_state()
        for e in self.history:
            nxt = s.step_event(e, None, skip_checks=True)
            if nxt is None:
                return None
            s = nxt
        return s

    # ----------------------------------------------------------- persistence

    def default_file_name(self) -> str:
        part = f"part{self.lab_part}" if self.lab_part is not None else ""
        stamp = time.strftime("%Y-%m-%d_%H-%M-%S", time.localtime(self.created_at))
        return f"lab{self.lab_id}{part}_{stamp}.trace"

    def save(self, directory: str = TRACES_DIR) -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, self.default_file_name())
        n = 1
        while os.path.exists(path):
            path = os.path.join(directory, f"{self.default_file_name()}.{n}")
            n += 1
        cloudpickle = SerializableTrace._cloudpickle()
        with open(path, "wb") as f:
            cloudpickle.dump(self, f)
        self.file_name = path
        return path

    @staticmethod
    def _cloudpickle():
        """Port deviation 1 (see the imports): cloudpickle, imported
        here; an ImportError naming it where it is not installed."""
        try:
            import cloudpickle
        except ImportError as e:
            raise ImportError(
                "saving or loading a trace needs the cloudpickle package, "
                "which is not installed") from e
        return cloudpickle

    class _Unpickler(pickle.Unpickler):
        """Port deviation 2: a trace that names a module of the JAX
        package (``dslabs_tpu`` and below, as a trace written by it does)
        is refused before anything of it is imported, so ``load`` skips
        it as a stale trace.  cloudpickle's ``subimport``, which imports a
        module by name while a stream loads, is held to the same rule."""

        @staticmethod
        def _refuse(module: str) -> None:
            if module == "dslabs_tpu" or module.startswith("dslabs_tpu."):
                raise pickle.UnpicklingError(
                    f"trace names {module!r}, a module of the JAX package")

        def find_class(self, module, name):
            self._refuse(module)
            obj = super().find_class(module, name)
            if module.startswith("cloudpickle") and name == "subimport":
                def subimport(mod_name, _sub=obj):
                    self._refuse(mod_name)
                    return _sub(mod_name)
                return subimport
            return obj

    @staticmethod
    def load(path: str) -> Optional["SerializableTrace"]:
        SerializableTrace._cloudpickle()
        try:
            with open(path, "rb") as f:
                trace = SerializableTrace._Unpickler(f).load()
            trace.file_name = path
            return trace
        except Exception as e:  # noqa: BLE001 — stale traces are skipped
            LOG.warning("Skipping unreadable trace %s: %r", path, e)
            return None

    @staticmethod
    def traces(directory: str = TRACES_DIR) -> List["SerializableTrace"]:
        if not os.path.isdir(directory):
            return []
        out = []
        for name in sorted(os.listdir(directory)):
            if ".trace" not in name:
                continue
            t = SerializableTrace.load(os.path.join(directory, name))
            if t is not None:
                out.append(t)
        return out

    def __repr__(self) -> str:
        return (f"SerializableTrace(lab={self.lab_id}, part={self.lab_part}, "
                f"test={self.test_method_name}, events={len(self.history)})")


def save_trace(state: SearchState, invariants: List[StatePredicate],
               lab_id: str, lab_part: Optional[int],
               test_class_name: str, test_method_name: str,
               directory: str = TRACES_DIR) -> str:
    """Persist the trace ending at ``state`` (SearchState.java:490-532)."""
    trace = state.trace()
    history = [s.previous_event for s in trace[1:]]
    end = state
    client_workers = []
    for a, w in end.client_workers().items():
        workload = w.workload
        workload.reset()
        client_workers.append((a, workload))
    st = SerializableTrace(
        history, invariants, end.generator,
        list(end.servers.keys()), client_workers,
        lab_id, lab_part, test_class_name, test_method_name)
    return st.save(directory)
