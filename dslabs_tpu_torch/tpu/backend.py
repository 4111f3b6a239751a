"""The tensor engine as a harness-selectable search strategy.

Counterpart of ``dslabs_tpu/tpu/backend.py``.  :func:`tensor_bfs` takes
the same object ``SearchState`` + ``SearchSettings`` a lab search test
builds, runs the search on the port's tensor engine through the lab's
protocol twin, and returns an object ``SearchResults`` whose terminal
states are real object states, rebuilt by trace replay on the object
twin (``tpu/trace.py``).  Staged searches (``goal_matching_state`` fed
into the next ``bfs``) and trace assertions keep working unchanged.  The
port's ``search.bfs`` / ``search.dfs`` send the ``tensor`` backend here
(``GlobalSettings.search_backend``, or ``DSLABS_SEARCH_BACKEND=tensor``).

Pipeline per call:

1. **Twin resolution**: registered adapters (``tpu/adapters/``) inspect
   the object state's node composition and return a :class:`TwinBinding`
   (tensor protocol, address and command maps, lane predicates).  No twin
   is a loud :class:`NoTensorTwin`, never a fall back to the object
   checker.
2. **Root derivation**: a depth-0 state maps to the twin's initial
   state.  A staged state (a goal state of an earlier tensor phase)
   carries a :class:`TensorProvenance` history of events and staged ops
   (``drop_pending_messages`` and the undrops), and the tensor root is
   re-derived by replaying that history through the twin's transition.
3. **Settings compilation**: link / sender / receiver / network flags
   become a [NN * NN] delivery matrix, per-node timer gating a [NN]
   vector, both runtime mask arrays of the engine; every invariant, goal
   and prune ``StatePredicate`` is translated to a batched lane predicate
   through its ``tkey`` (combinators translate structurally).
4. **Run**: ``ShardedTensorSearch`` (``tpu/sharded.py``) over
   ``make_mesh(None)``, ``strict=True`` and ``record_trace=True``: one
   superstep dispatch per level, the visited set in each shard's device
   table; a capacity ladder retries ``CapacityOverflow`` (a strict
   frontier or routing drop, a table past 75 %) with larger caps
   (frontier 2^14 / 2^17 / 2^19 rows and visited 2^19 / 2^22 / 2^24 slots
   per shard).
5. **Results**: end conditions map onto the object ``EndCondition`` (the
   object checker treats the depth limit as a prune, so a tensor
   DEPTH_EXHAUSTED reports SPACE_EXHAUSTED); terminal states are replayed
   on the object twin and re-checked with the original object predicate,
   and a twin/object divergence raises instead of returning an answer.

:func:`tensor_dfs` (the ``dfs`` call sites) first runs a swarm rollout
probe (``tpu/swarm.py``) at the capacity ladder's top rung: a violation
it finds ships with its minimized, replay-verified witness, confirmed
again on the object twin; otherwise a strict BFS runs under the same
settings, its time budget less the probe's seconds.

Deliberate differences from the reference: the mesh is
``make_mesh(None)``, one shard per card (1 on one H100, 1 on the CPU),
where the reference's spans every visible device; and the probe's
warm-up (``compile_secs``) is not deducted from the BFS's budget.  As in
the reference, the search and the probe each run under
``supervisor.install_retry``: a transient dispatch error retries with
backoff instead of failing the lab test.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dslabs_tpu_torch.tpu._build import resolve_device

__all__ = ["NoTensorTwin", "TensorProvenance", "TwinBinding",
           "register_adapter", "tensor_bfs", "tensor_dfs"]


class NoTensorTwin(RuntimeError):
    """No tensor twin or translation exists for this search configuration.

    Raised loudly rather than falling back to the object checker: the
    ``tensor`` backend must mean the tensor engine ran the search."""


@dataclasses.dataclass
class TensorProvenance:
    """How a staged object state was produced, in twin terms: the binding
    key it belongs to and the ordered history of events and staged ops
    (``("ev_msg", net_slot)``, ``("ev_tmr", node, queue_slot)``,
    ``("drop",)``, ``("undrop_from", name)``, ``("undrop_to", name)``,
    ``("undrop_all",)``) from the twin's initial state.  Events are kept
    independent of the caps (canonical network packing keeps occupied
    slot indices the same under any net_cap >= occupancy, and timer
    (node, slot) pairs do not read the grid stride), so the history
    replays the same under another rung of the capacity ladder."""

    key: tuple
    history: List[tuple] = dataclasses.field(default_factory=list)


def _norm_event(p, ev: int) -> tuple:
    """Grid event id (relative to protocol p's caps) -> cap-independent
    provenance op."""
    if ev < p.net_cap:
        return ("ev_msg", int(ev))
    t = ev - p.net_cap
    return ("ev_tmr", int(t) // p.timer_cap, int(t) % p.timer_cap)


def _denorm_event(p, op: tuple) -> int:
    # A history recorded at a higher rung of the ladder can name slots
    # past this rung's caps: that escalates the ladder, it is not a
    # missing twin.
    from dslabs_tpu_torch.tpu.engine import CapacityOverflow

    if op[0] == "ev_msg":
        if op[1] >= p.net_cap:
            raise CapacityOverflow(
                f"provenance slot {op[1]} beyond net_cap {p.net_cap}")
        return op[1]
    if op[2] >= p.timer_cap:
        raise CapacityOverflow(
            f"provenance timer slot {op[2]} beyond timer_cap "
            f"{p.timer_cap}")
    return p.net_cap + op[1] * p.timer_cap + op[2]


class TwinBinding:
    """A resolved (object configuration -> tensor twin) binding.

    Subclasses (one per lab family, see ``tpu/adapters/``) provide:

    - ``key``: hashable config identity (stable across staged phases)
    - ``build_protocol(net_cap, timer_cap) -> TensorProtocol`` (no masks)
    - ``addr_index``: root-address name -> twin node index
    - ``predicate(tkey) -> fn(state batch) -> [N] bool`` lane predicate
    - ``initial_caps() -> (net_cap, timer_cap)`` starting capacities
    """

    key: tuple = ()
    addr_index: Dict[str, int] = {}

    def build_protocol(self, net_cap: int, timer_cap: int):
        raise NotImplementedError

    def initial_caps(self) -> Tuple[int, int]:
        raise NotImplementedError

    def predicate(self, tkey) -> Callable:
        raise NotImplementedError

    def check_settings(self, settings) -> None:
        """Hook: raise NoTensorTwin when the settings demand events the
        twin does not model.  Twins that model every node's full event
        surface keep the default no-op."""

    def derive_root(self, search, state):
        """Hook: object initial or staged state -> (tensor root state
        dict or None for the twin's initial state, provenance history)."""
        return derive_root(self, search, state)

    def msg_mask_fn(self) -> Callable:
        """fn(msg [..., MW], [NN * NN] link matrix) -> bool [...], for the
        default [tag, frm, to, ...] record layout; bindings whose twins
        carry no frm/to lanes override it.  The indices are clipped: a
        SENTINEL row must not index past the matrix."""
        nn = len(self.addr_index)

        def fn(msg, marr, nn=nn):
            frm = msg[..., 1].clamp(0, nn - 1)
            to = msg[..., 2].clamp(0, nn - 1)
            return marr[(frm * nn + to).long()]
        return fn

    @staticmethod
    def tmr_mask_fn(nn: int) -> Callable:
        """fn(node [...], [NN] timer vector) -> bool [...]; a node index
        outside the vector reads False."""
        def fn(node, tarr, nn=nn):
            inside = (node >= 0) & (node < nn)
            return inside & tarr[node.clamp(0, nn - 1).long()]
        return fn


_ADAPTERS: List[Callable] = []


def register_adapter(fn: Callable) -> Callable:
    """Register ``fn(object_state) -> Optional[TwinBinding]``."""
    _ADAPTERS.append(fn)
    return fn


def _load_adapters() -> None:
    # Imported for their registration side effects.
    from dslabs_tpu_torch.tpu.adapters import paxos as _p  # noqa: F401
    from dslabs_tpu_torch.tpu.adapters import shardstore as _ss  # noqa: F401
    from dslabs_tpu_torch.tpu.adapters import simple as _s  # noqa: F401


def resolve_binding(state) -> TwinBinding:
    _load_adapters()
    for fn in _ADAPTERS:
        b = fn(state)
        if b is not None:
            return b
    kinds = sorted({type(n).__name__ for n in state.nodes()})
    raise NoTensorTwin(
        f"no tensor twin adapter matches node composition {kinds} — "
        "the tensor search backend only covers protocols with registered "
        "twins (tpu/adapters/)")


# ------------------------------------------------------------ predicates

def translate_predicate(binding: TwinBinding, pred) -> Callable:
    """Object StatePredicate -> batched twin lane predicate, recursing
    through combinator structure; loud NoTensorTwin when untranslatable."""
    st = getattr(pred, "structure", None)
    if st is not None:
        op = st[0]
        subs = [translate_predicate(binding, q) for q in st[1:]]
        if op == "not":
            return lambda s, f=subs[0]: ~f(s)
        if op == "and":
            return lambda s, a=subs[0], b=subs[1]: a(s) & b(s)
        if op == "or":
            return lambda s, a=subs[0], b=subs[1]: a(s) | b(s)
        if op == "implies":
            return lambda s, a=subs[0], b=subs[1]: ~a(s) | b(s)
    tkey = getattr(pred, "tkey", None)
    if tkey is None:
        raise NoTensorTwin(
            f"predicate {pred.name!r} has no tensor translation key and "
            "no combinator structure")
    fn = binding.predicate(tkey)
    if fn is None:
        raise NoTensorTwin(
            f"binding {binding.key} cannot translate predicate "
            f"{pred.name!r} (tkey {tkey!r})")
    return fn


# -------------------------------------------------------------- settings

def _addr_name(a) -> str:
    return str(a.root_address())


def compile_masks(binding: TwinBinding, settings):
    """TestSettings network/timer gating -> ([NN*NN] link matrix,
    [NN] timer vector) bool arrays.  The matrix reproduces
    TestSettings.should_deliver's precedence exactly: link override ->
    sender -> receiver -> network_active (testing/settings.py).  The
    engine takes both as runtime arguments (``set_runtime_masks``), so
    staged phases share one protocol."""
    idx = binding.addr_index
    nn = len(idx)
    names = {i: a for a, i in idx.items()}
    mat = np.zeros((nn, nn), dtype=bool)
    link = {(_addr_name(f), _addr_name(t)): v
            for (f, t), v in settings._link_active.items()}
    snd = {_addr_name(a): v for a, v in settings._sender_active.items()}
    rcv = {_addr_name(a): v for a, v in settings._receiver_active.items()}
    for fi in range(nn):
        for ti in range(nn):
            f, t = names[fi], names[ti]
            v = link.get((f, t))
            if v is None:
                v = snd.get(f)
            if v is None:
                v = rcv.get(t)
            if v is None:
                v = settings._network_active
            mat[fi, ti] = v
    from dslabs_tpu_torch.core.address import LocalAddress

    tvec = np.array(
        [settings.should_deliver_timer(LocalAddress(names[i]))
         for i in range(nn)], dtype=bool)
    return mat.reshape(-1), tvec


# ------------------------------------------------------------ state root

def derive_root(binding: TwinBinding, search, state):
    """Object initial state -> (tensor root state dict or None for the
    twin's initial state, provenance history list).  Depth-0 states map
    to the twin's initial state; staged states replay their history."""
    from dslabs_tpu_torch.tpu.engine import (CapacityOverflow, SENTINEL,
                                             TensorSearch, flatten_state)

    prov = getattr(state, "_tensor_provenance", None)
    if prov is None:
        if state.depth != 0:
            raise NoTensorTwin(
                "staged search from a state with no tensor provenance "
                "(depth {}) — only states produced by a previous "
                "tensor-backend phase can seed a new phase".format(
                    state.depth))
        # Staged mutations of the pristine state (drop_pending_messages
        # before the first bfs) are recorded on the instance and replay
        # like any provenance history.
        staged = list(getattr(state, "_staged_ops", []))
        prov = TensorProvenance(binding.key, staged)
        if not staged:
            return None, []
    if prov.key != binding.key:
        raise NoTensorTwin(
            f"staged state's provenance {prov.key} does not match the "
            f"current binding {binding.key}")
    row = flatten_state(search.initial_state())[0].cpu().numpy()
    # Replay without masks: the history's events were deliverable under
    # the masks of the phases that recorded them, not this phase's.
    # Masks gate validity only, never the transition, so the unmasked
    # replay reproduces each successor exactly.
    p = dataclasses.replace(search.p, deliver_message=None,
                            deliver_timer=None)
    replayer = TensorSearch(p, chunk=1, packed=False, device=search.device)
    o0, o1 = search._off[0], search._off[1]
    dropped: List[np.ndarray] = []
    for op in prov.history:
        if op[0] in ("ev_msg", "ev_tmr"):
            ev = _denorm_event(p, op)
            succ, valid, over = replayer._step_one(
                torch.as_tensor(row, device=search.device), ev)
            if int(over):
                # A truncated root would corrupt every later verdict:
                # escalate the ladder instead.
                raise CapacityOverflow(
                    f"provenance replay of {op!r} overflowed caps "
                    f"(net_cap={p.net_cap}, timer_cap={p.timer_cap})")
            if not bool(valid):
                raise NoTensorTwin(
                    f"provenance replay hit undeliverable event {op!r}")
            row = succ.cpu().numpy()
        elif op[0] == "drop":
            net = row[o0:o1].reshape(p.net_cap, p.msg_width)
            dropped.extend(r.copy() for r in net if r[0] != SENTINEL)
            row = row.copy()
            row[o0:o1] = SENTINEL
        elif op[0].startswith("undrop"):
            net = row[o0:o1].reshape(p.net_cap, p.msg_width).copy()
            want = (binding.addr_index[op[1]] if len(op) > 1 else None)
            back = []
            for r in dropped:
                if op[0] == "undrop_from" and int(r[1]) != want:
                    continue
                if op[0] == "undrop_to" and int(r[2]) != want:
                    continue
                back.append(r)
            have = [r for r in net if r[0] != SENTINEL]
            merged = {tuple(r) for r in have} | {tuple(r) for r in back}
            rows = sorted(merged)
            if len(rows) > p.net_cap:
                raise CapacityOverflow(
                    f"undrop needs {len(rows)} net slots > cap "
                    f"{p.net_cap}")
            net[:] = SENTINEL
            for i, r in enumerate(rows):
                net[i] = r
            row = row.copy()
            row[o0:o1] = net.reshape(-1)
        else:
            raise NoTensorTwin(f"unknown staged op {op!r}")
    return (search.unflatten_rows(torch.as_tensor(row[None])),
            list(prov.history))


# ------------------------------------------------------------------- run

# Capacity escalation ladder: (frontier_cap, visited_cap) per attempt,
# with net/timer caps growing alongside.  Every CapacityOverflow retries
# one rung up, and the last failure is loud.
_LADDER = [(1 << 14, 1 << 19), (1 << 17, 1 << 22), (1 << 19, 1 << 24)]


def _run_tensor(binding: TwinBinding, settings, state, device, chunk=512):
    from dslabs_tpu_torch.tpu.engine import CapacityOverflow
    from dslabs_tpu_torch.tpu.sharded import ShardedTensorSearch, make_mesh
    from dslabs_tpu_torch.tpu.supervisor import install_retry
    from dslabs_tpu_torch.utils.flags import GlobalSettings

    net_cap, timer_cap = binding.initial_caps()
    mesh = make_mesh(None, device)
    last: Optional[Exception] = None
    # Before build_protocol: a binding may fix settings-dependent
    # modelling flags there, and the first attempt must see them.
    binding.check_settings(settings)
    for attempt, (f_cap, v_cap) in enumerate(_LADDER):
        protocol, marr, tarr = _bind_protocol(
            binding, settings, net_cap << attempt,
            timer_cap + 2 * attempt)
        search = ShardedTensorSearch(
            protocol, mesh, chunk_per_device=chunk, frontier_cap=f_cap,
            visited_cap=v_cap, strict=True, record_trace=True)
        # Transient-dispatch retry (tpu/supervisor.py): a transient device
        # error mid-search retries with backoff instead of failing the lab
        # test; verdict flow is untouched (CapacityOverflow passes
        # straight through to the capacity ladder below).
        install_retry(search)
        search.set_runtime_masks(marr, tarr)
        rel = None
        if settings.depth_limited():
            rel = settings.max_depth - state.depth
            if rel < 0:
                raise NoTensorTwin("staged state already beyond max_depth")
        try:
            # Inside the attempt: a root recorded at a higher rung can
            # overflow this rung's caps, which escalates.
            root, history = binding.derive_root(search, state)
            if settings.max_time_secs is not None and (
                    rel is None or rel > 2):
                # The warm-up keeps the kernels' first build out of the
                # test's time budget (the reference charges neither
                # compilation nor class loading to maxTime).  A phase
                # within 2 levels of its depth limit skips it: the
                # warm-up would be the whole search.
                search.max_depth = 2
                search.run(initial=root, check_initial=False)
            search.max_depth = rel
            if settings.max_time_secs is not None:
                search.max_secs = (settings.max_time_secs
                                   * GlobalSettings.time_scale)
            else:
                search.max_secs = None
            outcome = search.run(initial=root)
            return search, outcome, history
        except CapacityOverflow as e:
            last = e
            continue
    raise last


def _materialize(binding, search, outcome, state, history):
    """Tensor terminal state -> object SearchState by trace replay, with
    provenance attached for the next staged phase."""
    from dslabs_tpu_torch.tpu.trace import replay_on_object

    obj = replay_on_object(search, outcome, state)
    obj._tensor_provenance = TensorProvenance(
        binding.key, list(history) + [_norm_event(search.p, e)
                                      for e in outcome.trace])
    return obj


def _sampled_value_recheck(binding, search, outcome, settings, state):
    """Value-level invariants (RESULTS_OK and its kin) are constant-true
    lane predicates on the twin, so the tensor search can never falsify
    them; before an exhaust verdict is trusted, replay the outcome's
    sampled deepest states on the object twin and check every value-level
    invariant there.  Returns the first violated ``(object_state,
    predicate, result)`` or ``None``."""
    if not outcome.samples:
        return None
    value_preds = [p for p in settings.invariants
                   if getattr(translate_predicate(binding, p),
                              "value_level", False)]
    if not value_preds:
        return None
    from dslabs_tpu_torch.tpu.trace import replay_on_object

    for tr in outcome.samples:
        shim = dataclasses.replace(outcome, trace=list(tr))
        obj = replay_on_object(search, shim, state)
        for p in value_preds:
            r = p.check(obj)
            if not r.value:
                return obj, p, r
    return None


def _bind_protocol(binding, settings, net_cap, timer_cap,
                   with_goals=True):
    """The runnable twin of one capacity rung: the protocol with its
    translated predicates, and the runtime mask arrays.  One code path for
    the BFS ladder and the rollout probe, so both search identically
    configured twins."""
    marr, tarr = compile_masks(binding, settings)
    protocol = binding.build_protocol(net_cap, timer_cap)
    inv = {p.name: translate_predicate(binding, p)
           for p in settings.invariants}
    goals = ({p.name: translate_predicate(binding, p)
              for p in settings.goals} if with_goals else {})
    prunes = {p.name: translate_predicate(binding, p)
              for p in settings.prunes}
    protocol = dataclasses.replace(
        protocol, invariants=inv, goals=goals, prunes=prunes,
        deliver_message_rt=binding.msg_mask_fn(),
        deliver_timer_rt=TwinBinding.tmr_mask_fn(len(tarr)))
    return protocol, marr, tarr


def _object_minimize_verify(obj, pred, result):
    """Object-side confirmation of a violation witness: minimize the
    replayed object state (``search/minimize.py``) and replay the
    minimized event history independently (``search/replay.py``) under
    the violated predicate.  Returns the minimized ``(state,
    predicate_result)``; any divergence is a loud NoTensorTwin."""
    from dslabs_tpu_torch.search.minimize import minimize_trace
    from dslabs_tpu_torch.search.replay import replay_trace
    from dslabs_tpu_torch.search.results import EndCondition
    from dslabs_tpu_torch.search.settings import SearchSettings

    mini = minimize_trace(obj, result)
    r2 = pred.check(mini)
    if r2.value:
        raise NoTensorTwin(
            f"object minimization broke the violation of "
            f"{pred.name!r} (minimizer/predicate divergence)")
    events = []
    s = mini
    while s.previous is not None:
        events.insert(0, s.previous_event)
        s = s.previous
    replayed = replay_trace(s, events,
                            SearchSettings().add_invariant(pred))
    if replayed.end_condition is not EndCondition.INVARIANT_VIOLATED:
        raise NoTensorTwin(
            f"replaying the minimized witness did not reproduce the "
            f"violation of {pred.name!r} "
            f"(got {replayed.end_condition})")
    return mini, r2


def _rollout_probe(binding, settings, state, device):
    """The swarm deep probe before a dfs-routed BFS: a diversified
    random-walk fleet (``SwarmSearch``) reaches depth d in O(d) steps, so
    the deep, narrow violations the object RandomDFS could hit inside a
    budget are covered before the level-by-level search starts.  This
    function keeps only the budget accounting; the walkers, dedup,
    overflow-restart counting and the witness pipeline live in
    ``tpu/swarm.py``.  Returns ``((search, outcome, history),
    probe_secs)`` on a violation or exception, else ``(None,
    probe_secs)``; a CapacityOverflow skips the probe (the BFS ladder
    owns the caps).  ``probe_secs`` leaves out the probe's warm-up."""
    import time

    from dslabs_tpu_torch.tpu.engine import CapacityOverflow
    from dslabs_tpu_torch.tpu.supervisor import install_retry
    from dslabs_tpu_torch.tpu.swarm import SwarmSearch
    from dslabs_tpu_torch.utils.flags import GlobalSettings

    t_probe = time.time()
    search = None

    def secs():
        warm = search.compile_secs if search is not None else 0.0
        return time.time() - t_probe - warm

    try:
        binding.check_settings(settings)
        net_cap, timer_cap = binding.initial_caps()
        # Probe at the ladder's top rung outright: walkers hold K rows,
        # not a frontier, so the wide caps cost little, and at base caps
        # every truncated step would restart a walker below the depths
        # the probe exists to reach.
        top = len(_LADDER) - 1
        protocol, marr, tarr = _bind_protocol(
            binding, settings, net_cap << top, timer_cap + 2 * top,
            with_goals=False)
        rel = (settings.max_depth - state.depth
               if settings.depth_limited() else 192)
        if rel <= 0:
            return None, secs()
        search = SwarmSearch(protocol, walkers_per_device=128,
                             max_steps=min(rel, 192), seed=0, device=device)
        install_retry(search)
        search.set_runtime_masks(marr, tarr)
        root, history = binding.derive_root(search, state)
        budget = 10.0 * GlobalSettings.time_scale
        if settings.max_time_secs is not None:
            budget = min(budget, settings.max_time_secs / 3
                         * GlobalSettings.time_scale)
        search.max_secs = budget
        outcome = search.run(initial=root, check_initial=False)
    except CapacityOverflow:
        return None, secs()
    if outcome.end_condition in ("INVARIANT_VIOLATED", "EXCEPTION_THROWN"):
        return (search, outcome, history), secs()
    return None, secs()


def tensor_bfs(initial_state, settings=None, _probe_first=False, *,
               device=None):
    """The tensor-strategy analog of ``search.bfs``: same inputs, same
    ``SearchResults`` contract.  Runs on the card unless ``device`` names
    another (``device="cpu"`` is the plain PyTorch path); with no card
    and no device it raises.  ``_probe_first`` runs the rollout probe
    first (:func:`tensor_dfs`)."""
    from dslabs_tpu_torch.search.results import EndCondition, SearchResults
    from dslabs_tpu_torch.search.settings import SearchSettings

    device = resolve_device(device)
    settings = settings if settings is not None else SearchSettings()
    binding = resolve_binding(initial_state)
    trip = None
    if _probe_first:
        trip, probe_secs = _rollout_probe(binding, settings, initial_state,
                                          device)
        if trip is None and settings.max_time_secs is not None:
            # The probe spends part of the same maxTime the object
            # RandomDFS honours: the BFS gets the rest, on a copy (the
            # caller's settings are theirs).
            import copy

            settings = copy.copy(settings)
            settings.max_time_secs = max(
                1.0, settings.max_time_secs - probe_secs)
    if trip is not None:
        search, outcome, history = trip
    else:
        search, outcome, history = _run_tensor(binding, settings,
                                               initial_state, device)
    results = SearchResults(settings.invariants, settings.goals)
    results.discovered_count = outcome.unique_states
    results.visited_overflow = outcome.visited_overflow
    end = outcome.end_condition
    by_name = {p.name: p for p in (settings.invariants + settings.goals)}
    if end == "GOAL_FOUND":
        obj = _materialize(binding, search, outcome, initial_state,
                           history)
        pred = by_name[outcome.predicate_name]
        r = pred.check(obj)
        if not r.value:
            raise NoTensorTwin(
                f"twin/object divergence: tensor goal "
                f"{outcome.predicate_name!r} does not hold on the "
                "replayed object state")
        results.goal_found(obj, r)
        results.end_condition = EndCondition.GOAL_FOUND
    elif end == "INVARIANT_VIOLATED":
        obj = _materialize(binding, search, outcome, initial_state,
                           history)
        pred = by_name[outcome.predicate_name]
        r = pred.check(obj)
        if r.value:
            raise NoTensorTwin(
                f"twin/object divergence: tensor invariant violation "
                f"{outcome.predicate_name!r} holds on the replayed "
                "object state")
        if trip is not None:
            # A probe witness, already minimized and replay-verified in
            # tensor space, is confirmed again on the object twin.
            obj, r = _object_minimize_verify(obj, pred, r)
            outcome.witness.object_verified = True
        results.invariant_violated(obj, r)
        results.end_condition = EndCondition.INVARIANT_VIOLATED
    elif end == "EXCEPTION_THROWN":
        obj = _materialize(binding, search, outcome, initial_state,
                           history)
        results.exception_thrown(obj)
        results.end_condition = EndCondition.EXCEPTION_THROWN
    else:
        hit = _sampled_value_recheck(binding, search, outcome, settings,
                                     initial_state)
        if hit is not None:
            obj, pred, r = hit
            results.invariant_violated(obj, r)
            results.end_condition = EndCondition.INVARIANT_VIOLATED
        elif end == "TIME_EXHAUSTED":
            results.end_condition = EndCondition.TIME_EXHAUSTED
        else:
            # SPACE_EXHAUSTED or DEPTH_EXHAUSTED: the object checker
            # treats the depth limit as a prune and reports
            # SPACE_EXHAUSTED.
            results.end_condition = EndCondition.SPACE_EXHAUSTED
    return results


def tensor_dfs(initial_state, settings=None, *, device=None):
    """Tensor strategy for dfs call sites: the swarm rollout probe
    (RandomDFS's O(d) depth reach), then a strict BFS under the same
    settings when the probe finds nothing.  A probe violation carries its
    replayed object state and witness; the BFS adds what RandomDFS never
    could, exhaustiveness at every level it completes.  Runs on the card
    unless ``device`` names another."""
    return tensor_bfs(initial_state, settings, _probe_first=True,
                      device=device)
