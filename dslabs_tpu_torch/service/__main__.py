"""Service CLI: ``python -m dslabs_tpu_torch.service {submit,status,drain}``.

Counterpart of ``dslabs_tpu/service/__main__.py``.

The queue journal is the hand-off: ``submit`` appends durably and
returns (the structured accept/reject line on stdout), a later
``drain`` — on the same ``--root`` — replays the journal and runs the
backlog under the scheduler, and ``status`` renders SERVER_STATUS.json
plus the journal summary without touching either.  Every subcommand
prints exactly one JSON line on stdout (stderr is free-form), so the
CLI composes with scripts.  Jobs run on the card unless ``drain`` is
given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

__all__ = ["main"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m dslabs_tpu_torch.service",
        description="multi-tenant checking service: submit jobs, "
                    "inspect status, drain the queue")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("submit", help="enqueue one job (structured "
                       "accept/reject on stdout; never blocks)")
    s.add_argument("--root", required=True,
                   help="service run dir (journal + job run dirs)")
    s.add_argument("--tenant", default="default")
    s.add_argument("--factory", required=True,
                   help="'module:callable' protocol factory spec of the "
                        "port")
    s.add_argument("--kwargs", default="{}",
                   help="factory kwargs as a JSON object")
    s.add_argument("--transform", default=None,
                   help="optional 'module:callable' protocol transform")
    s.add_argument("--max-depth", type=int, default=None)
    s.add_argument("--max-secs", type=float, default=None)
    s.add_argument("--budget", type=float, default=1.0,
                   help="DRR budget units this job is billed")
    s.add_argument("--chunk", type=int, default=1 << 10)
    s.add_argument("--no-admission", action="store_true",
                   help="skip the conformance admission gate")

    st = sub.add_parser("status", help="render SERVER_STATUS.json + "
                        "the journal summary")
    st.add_argument("--root", required=True)

    d = sub.add_parser("drain", help="run the journaled backlog to "
                       "completion under the fair scheduler")
    d.add_argument("--root", required=True)
    d.add_argument("--workers", type=int, default=None)
    d.add_argument("--max-secs", type=float, default=None)
    d.add_argument("--no-admission", action="store_true")
    d.add_argument("--lanes", type=int, default=None,
                   help="batched job lanes: pack up to N compatible "
                        "jobs into one lane batch (0/1 = off)")
    d.add_argument("--quota", type=int, default=None,
                   help="jobs of one tenant running at once")
    d.add_argument("--device", default=None,
                   help="where the jobs run (default: the card)")
    d.add_argument("--full", action="store_true",
                   help="include per-job results in the JSON line")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)

    from dslabs_tpu_torch.service.server import CheckServer

    if args.cmd == "submit":
        srv = CheckServer(args.root, admission=not args.no_admission)
        try:
            res = srv.submit(
                factory=args.factory, tenant=args.tenant,
                factory_kwargs=json.loads(args.kwargs),
                transform=args.transform, max_depth=args.max_depth,
                max_secs=args.max_secs, budget_units=args.budget,
                chunk=args.chunk)
        finally:
            srv.close()
        print(json.dumps(res))
        return 0 if res.get("accepted") else 1

    if args.cmd == "status":
        import os

        from dslabs_tpu_torch.service.queue import ServiceQueue
        from dslabs_tpu_torch.service.server import SERVER_STATUS_NAME
        from dslabs_tpu_torch.tpu import tracing

        # Both snapshots are read tolerantly: a
        # mid-write SERVER_STATUS (the tmp+replace race) or a torn
        # COSTS.jsonl tail (a server killed mid-append) must degrade
        # to partial output, never a crashed status command.
        status_path = os.path.join(args.root, SERVER_STATUS_NAME)
        server = tracing.load_json_tolerant(status_path)
        cost_recs, _torn = tracing.read_flight_lax(
            os.path.join(args.root, tracing.COSTS_NAME))
        q = ServiceQueue(args.root)
        try:
            summary = q.summary()
        finally:
            q.close()
        print(json.dumps({"server": server, "queue": summary,
                          "costs": tracing.aggregate_costs(cost_recs),
                          "status_path": status_path}))
        return 0

    # drain
    kw = {k: getattr(args, k) for k in ("workers", "lanes", "quota")
          if getattr(args, k) is not None}
    srv = CheckServer(args.root, admission=not args.no_admission,
                      device=args.device, **kw)
    try:
        summary = srv.drain(max_secs=args.max_secs)
    finally:
        srv.close()
    if not args.full:
        summary = dict(summary)
        summary["results"] = [
            {k: r.get(k) for k in ("job_id", "tenant", "trace_id",
                                   "status", "end", "unique",
                                   "attempts", "degraded", "kind")}
            for r in summary.get("results", [])]
    print(json.dumps(summary))
    return 0 if summary.get("failed", 0) == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
