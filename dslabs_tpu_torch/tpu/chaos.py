"""Seeded chaos harness: deterministic multi-site fault schedules and a soak.

Counterpart of ``dslabs_tpu/tpu/chaos.py``.  Each recovery path of the
supervisor (``tpu/supervisor.py``) is proven by a hand-placed
:class:`~dslabs_tpu_torch.tpu.supervisor.FaultPlan` rule; what none of
those cases proves is the composition: one long run absorbing transient
storms, OOM re-levels, wedges and fatal rung burns and still landing the
exact fault-free verdict.  This module makes that one call:

* **ChaosSpec / build_plan**: a seeded schedule of faults over the
  dispatch sites of a real run, site x kind x dispatch index, drawn from
  a ``random.Random(seed)``, so every soak is reproducible.  The kinds
  map onto the supervisor's failure taxonomy:

  - ``transient``: a retryable raise (``TransientDeviceError``), absorbed
    by the in-place retry;
  - ``oom``: :class:`ChaosOOM` (a ``MemoryError``), answered by the
    knob-shrink re-level (halved chunk and superstep budget);
  - ``fatal``: :class:`ChaosError`, which burns the rung; the elastic
    ladder rebuilds a mesh of half the shards from the checkpoint
    (``mesh_shrunk``);
  - ``hang``: an injected wedge; the watchdog abandons the dispatch and
    the ladder fails over.

  Transient, OOM and fatal faults are bursts of consecutive site-local
  dispatch indices anchored near the start of each site's stream: a
  raise consumes its index and the retry takes the next, so every
  scheduled fault fires on any run that reaches its anchor.

* **soak()**: the fault-free baseline runs first (and measures each
  site's dispatch count), the plan is drawn from those counts, the same
  search runs under the plan on the elastic ladder with a checkpoint
  every level, and exact verdict / unique / explored parity,
  ``dropped_states == 0`` and the asked-for coverage are asserted.  The
  report names what fired and what recovered it.

CLI: ``python -m dslabs_tpu_torch.tpu.chaos --protocol lab1 --seed 3``
prints the soak report as one JSON line.  The soak runs on the card
unless ``--device cpu`` is given.

Deliberate difference from the reference: the watchdog deadline is
:data:`DEADLINE_SECS` or ``chaos_policy``'s argument, where the
reference reads ``DSLABS_CHAOS_DEADLINE``.
"""

from __future__ import annotations

import dataclasses
import os
import random
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from dslabs_tpu_torch.tpu.supervisor import (FaultPlan, RetryPolicy,
                                             SearchSupervisor,
                                             TransientDeviceError)

__all__ = ["ChaosError", "ChaosOOM", "ChaosSpec", "ChaosPlan",
           "build_plan", "chaos_policy", "soak", "DEFAULT_SITES",
           "DEADLINE_SECS"]

# The soak's steady-state watchdog deadline per dispatch, seconds: an
# injected hang costs this much (the sharded superstep's is stretched by
# its published scale).
DEADLINE_SECS = 12.0


class ChaosError(RuntimeError):
    """An injected non-transient fault: classified fatal, burns the rung
    (the elastic ladder's ``mesh_shrunk`` path)."""


class ChaosOOM(MemoryError):
    """An injected OOM-shaped fault (a ``MemoryError`` with no transient
    marker): answered by the supervisor's in-place knob-shrink
    re-level."""


# The first rung's dispatch sites under the superstep driver: one
# one-shot site (init) and the two per-level sites.  The elastic ladder
# keeps the engine name "sharded" at every width, so injection persists
# across shrinks.
DEFAULT_SITES = (("sharded", "init"), ("sharded", "superstep"),
                 ("sharded", "promote"))


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """A chaos schedule's knobs.  ``faults`` is the total injection
    count; ``oom_faults`` / ``fatal_faults`` / ``hang_faults`` carve
    special kinds out of it (the rest are transient).  Keep
    ``fatal_faults + hang_faults`` at least two below the rung count:
    each burns a rung, and parity needs a surviving rung."""

    seed: int = 0
    faults: int = 24
    oom_faults: int = 2
    fatal_faults: int = 1
    hang_faults: int = 1
    sites: tuple = DEFAULT_SITES
    hang_secs: float = 3600.0
    burst: int = 4                  # most consecutive faults per burst


class ChaosPlan(FaultPlan):
    """A :class:`FaultPlan` generated from a seed.  ``chaos = True`` makes
    the boundary log its injections as ``chaos_inject`` events;
    ``schedule`` keeps every ``(engine, site, index, kind)`` for the
    report."""

    chaos = True

    def __init__(self, spec: ChaosSpec,
                 schedule: List[Tuple[str, str, int, str]]):
        super().__init__()
        self.spec = spec
        self.schedule = schedule

    def sites_fired(self):
        return {(e, s) for (e, s, _k, _i) in self.fired_log}


def build_plan(spec: ChaosSpec,
               site_counts: Dict[tuple, int]) -> ChaosPlan:
    """The seeded schedule over the observed dispatch counts
    (``site_counts``: the fault-free run's per-``(engine, site)``
    dispatches, e.g. ``supervisor.boundary.site_counts``).  A one-shot
    site (one dispatch per rung, like ``init``) gets a transient at index
    0; multi-dispatch sites get bursts of consecutive indices anchored
    within their first few real dispatches."""
    rng = random.Random(spec.seed)
    sites = [(e, s, int(site_counts.get((e, s), 0)))
             for (e, s) in spec.sites]
    one_shot = [(e, s) for e, s, n in sites if n == 1]
    multi = [(e, s, n) for e, s, n in sites if n > 1]
    if not multi:
        raise ValueError(
            "chaos needs at least one multi-dispatch site; observed "
            f"counts: {dict(site_counts)}")

    schedule: List[Tuple[str, str, int, str]] = []
    for e, s in one_shot:
        schedule.append((e, s, 0, "transient"))

    remaining = max(0, spec.faults - len(schedule))
    specials = (["oom"] * min(spec.oom_faults, remaining)
                + ["fatal"] * min(spec.fatal_faults, remaining))
    hangs = ["hang"] * min(spec.hang_faults, remaining)
    n_transient = max(0, remaining - len(specials) - len(hangs))
    kinds = ["transient"] * n_transient + specials
    rng.shuffle(kinds)

    # Round-robin the kinds over the multi sites; hangs pin to the site
    # with the lowest deadline scale (promote: a superstep hang would
    # wait the stretched deadline) and go first there, so the wedge lands
    # while plenty of run remains for the faults behind it.
    per_site: Dict[int, List[str]] = {i: [] for i in range(len(multi))}
    for j, kind in enumerate(kinds):
        per_site[j % len(multi)].append(kind)
    hang_site = next((i for i, (_e, s, _n) in enumerate(multi)
                      if s == "promote"), 0)
    per_site[hang_site] = hangs + per_site[hang_site]

    for i, (e, s, _n) in enumerate(multi):
        ks = per_site[i]
        if not ks:
            continue
        # A raise consumes its index and the retry takes the next, so a
        # consecutive burst fires end to end once its anchor is reached;
        # only the anchor and the one-dispatch gaps between bursts take
        # real dispatches.  The burst length grows with the site's load,
        # so a heavy schedule never needs more real dispatches than a
        # short run has.
        burst_len = max(spec.burst, -(-len(ks) // 3))
        idx = rng.randint(1, 2)
        burst = 0
        for kind in ks:
            schedule.append((e, s, idx, kind))
            idx += 1
            burst += 1
            if burst >= burst_len:
                burst = 0
                idx += 1                   # one real dispatch between

    plan = ChaosPlan(spec, schedule)
    for e, s, idx, kind in schedule:
        if kind == "transient":
            plan.raise_at(idx, engine=e, site=s,
                          error=TransientDeviceError,
                          message="chaos transient")
        elif kind == "oom":
            plan.raise_at(idx, engine=e, site=s, error=ChaosOOM,
                          message="chaos injected allocation failure")
        elif kind == "fatal":
            plan.raise_at(idx, engine=e, site=s, error=ChaosError,
                          message="chaos fatal")
        else:
            plan.hang_at(idx, engine=e, site=s, secs=spec.hang_secs)
    return plan


def chaos_policy(spec: ChaosSpec,
                 deadline_secs: Optional[float] = None) -> RetryPolicy:
    """The soak's retry policy: a budget big enough that transient bursts
    never starve a rung (the soak measures recovery, not budget
    arithmetic), near-zero backoff, and a watchdog of ``deadline_secs``
    (default :data:`DEADLINE_SECS`) so an injected hang costs seconds.
    The first dispatch at each site keeps a build-sized grace."""
    if deadline_secs is None:
        deadline_secs = DEADLINE_SECS
    return RetryPolicy(max_retries=spec.faults + 8,
                       backoff_base=0.005, backoff_factor=1.5,
                       backoff_max=0.05,
                       deadline_secs=float(deadline_secs),
                       deadline_first_secs=900.0, seed=spec.seed)


def soak(protocol, spec: Optional[ChaosSpec] = None,
         supervisor_kwargs: Optional[dict] = None,
         checkpoint_path: Optional[str] = None,
         telemetry=None, min_fired: int = 0, min_sites: int = 0) -> dict:
    """Run a strict search under sustained seeded injection and assert
    exact parity with the fault-free run.

    1. The fault-free baseline runs first (same supervisor settings, no
       plan): its verdict and counts are the oracle, and its per-site
       dispatch counts are the budgets the plan is drawn from.
    2. The chaos run executes the seeded plan on the elastic ladder,
       checkpointing every level so burned rungs resume.
    3. Parity (verdict, unique, explored), ``dropped_states == 0`` and
       the asked-for injection and site coverage are asserted: a soak
       that under-injects fails.

    Returns the report dict (what the CLI prints)."""
    spec = spec or ChaosSpec()
    kw = dict(supervisor_kwargs or {})
    kw.setdefault("strict", True)
    kw.setdefault("elastic", True)

    base_sup = SearchSupervisor(protocol, **kw)
    base = base_sup.run()
    site_counts = dict(base_sup.boundary.site_counts)
    plan = build_plan(spec, site_counts)

    if checkpoint_path is None:
        checkpoint_path = os.path.join(
            tempfile.mkdtemp(prefix="dslabs-chaos-"), "soak.ckpt")
    kw2 = dict(kw)
    kw2.setdefault("checkpoint_every", 1)
    kw2["checkpoint_path"] = checkpoint_path
    kw2.setdefault("policy", chaos_policy(spec))
    sup = SearchSupervisor(protocol, fault_plan=plan,
                           telemetry=telemetry, **kw2)
    t0 = time.time()
    out = sup.run()

    fired_sites = sorted(f"{e}.{s}" for e, s in plan.sites_fired())
    parity = (out.end_condition == base.end_condition
              and out.unique_states == base.unique_states
              and out.states_explored == base.states_explored)
    report = {
        "seed": spec.seed,
        "scheduled": len(plan.schedule),
        "fired": plan.fired,
        "sites_fired": fired_sites,
        "kinds_fired": sorted({k for (_e, _s, k, _i)
                               in plan.fired_log}),
        "parity": bool(parity),
        "verdict": out.end_condition,
        "base": {"verdict": base.end_condition,
                 "unique": base.unique_states,
                 "explored": base.states_explored,
                 "depth": base.depth},
        "chaos": {"unique": out.unique_states,
                  "explored": out.states_explored,
                  "depth": out.depth,
                  "engine": out.engine,
                  "mesh_width": out.mesh_width,
                  "mesh_shrinks": out.mesh_shrinks,
                  "knob_retries": out.knob_retries,
                  "failovers": out.failovers,
                  "retries": out.retries,
                  "resumed_from_depth": out.resumed_from_depth,
                  "dropped_states": out.dropped_states},
        "platform": out.platform,
        "wall_secs": round(time.time() - t0, 2),
        "checkpoint": checkpoint_path,
    }
    if plan.fired < min_fired:
        raise AssertionError(
            f"chaos soak under-injected: {plan.fired} faults fired "
            f"(wanted >= {min_fired}); report: {report}")
    if len(fired_sites) < min_sites:
        raise AssertionError(
            f"chaos soak covered {len(fired_sites)} sites "
            f"({fired_sites}), wanted >= {min_sites}; report: {report}")
    if not parity:
        raise AssertionError(f"chaos soak broke parity: {report}")
    if out.dropped_states:
        raise AssertionError(
            f"chaos soak dropped {out.dropped_states} states: {report}")
    return report


# ------------------------------------------------------------------ CLI

def _protocol(name: str):
    """The CLI's protocols, in their exhaustive shape: the goal becomes a
    prune, so the soak measures full-space parity, not a first-goal
    race."""
    if name == "pingpong":
        from dslabs_tpu_torch.tpu.protocols.pingpong import \
            make_pingpong_protocol

        p = make_pingpong_protocol(2)
    elif name == "lab1":
        from dslabs_tpu_torch.tpu.protocols.clientserver import \
            make_clientserver_protocol

        p = make_clientserver_protocol(n_clients=1, w=2)
    elif name == "paxos-partition":
        # A job whose model carries fault events (partition cut and heal)
        # soaked under the supervisor's own fault injection: the two
        # compose without disturbing the verdict.
        from dslabs_tpu_torch.tpu.specs import paxos_partition_spec

        p = paxos_partition_spec().compile()
        return dataclasses.replace(p, goals={},
                                   prunes={"DECIDED": p.goals["DECIDED"]})
    else:
        raise SystemExit(f"unknown --protocol {name!r} "
                         "(pingpong | lab1 | paxos-partition)")
    return dataclasses.replace(
        p, goals={}, prunes={"CLIENTS_DONE": p.goals["CLIENTS_DONE"]})


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json

    from dslabs_tpu_torch.tpu.mesh_exchange import ShardMesh

    ap = argparse.ArgumentParser(
        prog="python -m dslabs_tpu_torch.tpu.chaos",
        description="seeded chaos soak: strict search under sustained "
                    "fault injection, exact parity asserted")
    ap.add_argument("--protocol", default="lab1",
                    choices=("pingpong", "lab1", "paxos-partition"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--faults", type=int, default=24)
    ap.add_argument("--mesh", type=int, default=None,
                    help="shards of the sharded rung (default: one per "
                         "card)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    kw = {"chunk": 64, "frontier_cap": 1 << 9, "visited_cap": 1 << 12,
          "device": args.device}
    if args.mesh:
        kw["mesh"] = ShardMesh(args.mesh, args.device)
    report = soak(_protocol(args.protocol),
                  spec=ChaosSpec(seed=args.seed, faults=args.faults),
                  supervisor_kwargs=kw,
                  min_fired=min(args.faults, 20), min_sites=3)
    print(json.dumps(report))
    return 0 if report["parity"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
