"""PyTorch port, the hot-path auditor (``dslabs_tpu_torch/analysis/
hotpath_audit.py``, leg B), the counterpart of the reference's jaxpr
audit, on the CPU.

One red fixture per rule J0-J5, each a torch function with its clean
twin: an unregistered tag and a raising function (J0); a stray
``.item()``, ``.tolist()``, ``nonzero``, host upload and boolean-mask
read beyond the site's budget (J1); a ``float64`` upcast (J2); an
in-place site that reallocates a 1 MiB carry, beside an in-place write
and a buffer swap (J3); a collective on a one-rank ``gloo`` group built
in the test (J4; ``dist.all_reduce``, dispatched as
``c10d.allreduce_``); a builder with per-build random constants (J5).
The table of primitive calls and their syncs on the card
(``dslabs_tpu_torch/analysis/sync_cases.py``) holds the audit's count
on the CPU.  The plain versions of the two kernels sync on the CPU (the
insert's probe rounds read their counts) and are not counted.  The clean pin:
the port's audit set on the CPU has zero findings, with each site's sync
count equal to its budget, and the flagships' chunk steps take one sync
packed, none by the hand twin.  Site-set parity with the reference's
``build_audit_engines``, the sharded engine's tags included.
The ``sanitize=`` hook, at the first run, records ``sanitizer_finding``
events when a tag is hidden from the registry, and off is off.
``compare_ledger`` flags a sanitizer rise.  The deep retrace pin on the
real engines and the CLI in a child process are ``slow``, as in the
reference."""

import dataclasses
import os
import socket
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from dslabs_tpu_torch.analysis import hotpath_audit as H
from dslabs_tpu_torch.tpu import kernels, visited
from dslabs_tpu_torch.tpu import telemetry as ttel
from dslabs_tpu_torch.tpu.engine import TensorSearch
from dslabs_tpu_torch.tpu.protocols.pingpong import make_pingpong_protocol
from dslabs_tpu_torch.analysis.sync_cases import CASES as SYNC_CASES
from dslabs_tpu_torch.analysis.sync_cases import operand as sync_operand

# One intra-op thread here and in every child: the suite runs several
# workers on a few cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPS = dict(max_depth=8, chunk=64, frontier_cap=1 << 8,
            visited_cap=1 << 10, device="cpu")


def _entry(fn, args, in_place=False, multi=False, syncs=0, builder=None):
    return dict(fn=fn, args=args, in_place=in_place, multi=multi,
                syncs=syncs, builder=builder)


def _codes(findings):
    return sorted({f.code for f in findings})


def _audit(tag, entry, deep=False):
    return H.audit_sites({tag: entry}, "Fixture", deep=deep)


X = torch.arange(16, dtype=torch.int32)


# ------------------------------------------------------------------ J0

def test_j0_unregistered_tag_and_its_registered_twin():
    found = _audit("bogus.site", _entry(lambda x: x + 1, (X,)))
    assert _codes(found) == ["J0"]
    assert "DISPATCH_SITES" in found[0].message
    assert _audit("device.promote", _entry(lambda x: x + 1, (X,))) == []


def test_j0_raising_function():
    def broken(x):
        raise RuntimeError("site bomb")
    found = _audit("device.promote", _entry(broken, (X,)))
    assert _codes(found) == ["J0"]
    assert "raised when the audit ran it" in found[0].message
    assert "site bomb" in found[0].message


# ------------------------------------------------------------------ J1

J1_RED = {
    "item": lambda x: x.sum().item(),
    "int": lambda x: int(x[3]),
    "bool": lambda x: bool((x > 3).any()),
    "tolist": lambda x: x.tolist(),
    "nonzero": lambda x: torch.nonzero(x > 3),
    "cpu": lambda x: x.cpu(),
    "upload": lambda x: x + torch.as_tensor(3, dtype=torch.int32,
                                            device=x.device),
    "from_numpy_upload": lambda x: x + torch.from_numpy(
        np.ones(16, np.int32)).to(x.device),
    "bool_mask_read": lambda x: x[x > 3],
    "host_list_index": lambda x: x[[0, 2]],
    "repeat_interleave_by_tensor": lambda x: torch.repeat_interleave(
        x.clamp(max=2)),
}


@pytest.mark.parametrize("name", sorted(J1_RED))
def test_j1_stray_sync_over_budget(name):
    found = _audit("device.promote", _entry(J1_RED[name], (X,)))
    assert _codes(found) == ["J1"]
    assert "budget 0" in found[0].message
    assert "test_torch_hotpath_audit.py:" in found[0].message


@pytest.mark.parametrize("name", sorted(SYNC_CASES))
def test_sync_rules_table(name):
    """The audit's count on the CPU equals the card's count of each
    primitive (``dslabs_tpu_torch/analysis/sync_cases.py``, held on the
    card by ``chip_smoke.py``'s analysis phase)."""
    fn, want = SYNC_CASES[name]
    assert len(H.count_syncs(fn, (sync_operand("cpu"),))) == want


def test_j1_within_budget_and_sync_free_twins():
    rep = {}
    assert H.audit_sites({"device.sync": _entry(lambda x: x.cpu().numpy(),
                                                (X,), syncs=1)},
                         "Fixture", report=rep) == []
    assert rep["device.sync"]["syncs"] == 1      # .cpu(), not .numpy()
    clean = {
        "device.promote": _entry(lambda x: torch.where(x > 3, x, 0).sum(),
                                 (X,)),
        "device.init": _entry(lambda x: x + torch.full_like(x, 3), (X,)),
        # A masked fill by a boolean mask and a scalar, and host-only
        # work on numpy, take no sync.
        "device.flags": _entry(lambda x: x.clone().__setitem__(x > 3, 0)
                               or np.arange(3).sum(), (X,)),
    }
    rep = {}
    assert H.audit_sites(clean, "Fixture", report=rep) == []
    assert {k: v["syncs"] for k, v in rep.items()} == dict.fromkeys(
        clean, 0)


def test_j1_empty_transfers_are_none():
    def fn(x):
        z = x[:0]
        return (z.cpu(), torch.from_numpy(np.zeros((0,), np.int32))
                .to(x.device))
    rep = {}
    assert H.audit_sites({"device.promote": _entry(fn, (X,))}, "Fixture",
                         report=rep) == []
    assert rep["device.promote"]["syncs"] == 0


def test_plain_kernels_syncs_not_counted():
    """On the CPU the plain versions stand in for the kernels and read
    their own counts; the audit leaves them out, and counts the same
    reads made outside them."""
    table = visited.empty_table(1 << 10, "cpu")
    keys = kernels.fingerprint_rows(
        torch.arange(64 * 5, dtype=torch.int32).reshape(64, 5))
    valid = torch.ones((64,), dtype=torch.bool)
    rep = {}
    sites = {
        "visited.insert": _entry(visited.insert, (table, keys, valid),
                                 in_place=True),
        "device.init": _entry(lambda r: kernels.fingerprint_rows(r),
                              (torch.ones((8, 5), dtype=torch.int32),)),
        # The insert's own count read, issued outside a plain version.
        "device.promote": _entry(
            lambda t, k, v: int((~visited.insert(t, k, v)[1]).sum()),
            (table, keys, valid), in_place=True, syncs=1),
    }
    assert H.audit_sites(sites, "Fixture", report=rep) == []
    assert [rep[t]["syncs"] for t in sorted(rep)] == [0, 1, 0]
    # The marker changes nothing the plain versions compute.
    t1, i1, u1 = visited.insert_plain(table.clone(), keys, valid)
    t2, i2, u2 = visited.insert_plain.__wrapped__(table.clone(), keys,
                                                  valid)
    assert torch.equal(t1, t2) and torch.equal(i1, i2) \
        and torch.equal(u1, u2) and int(i1.sum()) == 64


# ------------------------------------------------------------------ J2

def test_j2_float64_upcast_and_float32_twin():
    found = _audit("device.promote",
                   _entry(lambda x: x.to(torch.float64) * 1.5, (X,)))
    assert _codes(found) == ["J2"]
    assert _audit("device.promote",
                  _entry(lambda x: x.to(torch.float32) * 1.5, (X,))) == []
    # int64 stays allowed (the plain hash arithmetic).
    assert _audit("device.promote",
                  _entry(lambda x: x.to(torch.int64) * 3, (X,))) == []


# ------------------------------------------------------------------ J3

def _carry():
    return {"big": torch.zeros((512, 512), dtype=torch.int32),   # 1 MiB
            "other": torch.ones((512, 512), dtype=torch.int32),
            "n": torch.zeros((1,), dtype=torch.int64)}


def test_j3_in_place_site_that_reallocates():
    def realloc(c):
        c["big"] = c["big"] * 2
    found = _audit("device.step", _entry(realloc, (_carry(),),
                                         in_place=True))
    assert _codes(found) == ["J3"]
    assert "changed storage" in found[0].message
    # The same function declared not in place is no J3.
    assert _audit("device.step", _entry(realloc, (_carry(),),
                                        in_place=False)) == []


def test_j3_in_place_write_and_swap_are_clean():
    def write(c):
        c["big"].mul_(2)
        c["n"] = c["n"] + 1          # small: under DONATE_MIN

    def swap(c):
        c["big"], c["other"] = c["other"], c["big"]
    for fn in (write, swap):
        assert _audit("device.step", _entry(fn, (_carry(),),
                                            in_place=True)) == []


# ------------------------------------------------------------------ J4

def test_j4_collective_on_a_one_rank_gloo_group():
    import torch.distributed as dist

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        def reduce(x):
            dist.all_reduce(x)
            return x
        x = torch.ones((8,), dtype=torch.float32)
        found = _audit("device.promote", _entry(reduce, (x,)))
        assert _codes(found) == ["J4"]
        assert "allreduce" in found[0].message
        assert _audit("device.promote",
                      _entry(reduce, (x,), multi=True)) == []
    finally:
        dist.destroy_process_group()


RANK_AUDITS = {
    "superstep": dict(spec="pingpong_spec", args=[2], goals="prune"),
    "steal": dict(spec="clientserver_spec", args=[2, 2], goals="prune"),
    "legacy": dict(spec="pingpong_spec", args=[2], goals="prune"),
    "delta": dict(spec="paxos_spec", args=[3], goals="drop"),
    "spill": dict(spec="clientserver_spec", args=[2, 2], goals="prune"),
}
RANK_AUDIT_KW = {"steal": dict(steal_threshold=1.05),
                 "legacy": dict(superstep=False),
                 "delta": dict(frontier_cap=1 << 10, visited_cap=1 << 12),
                 "spill": dict(spill=True, visited_cap=1 << 6)}


@pytest.fixture(scope="module")
def rank_audit():
    """One launch of two gloo ranks (tpu/ranks.py): the J4 probe, then
    the audit of the sharded engine's sites in four configurations."""
    from dslabs_tpu_torch.tpu import ranks
    from dslabs_tpu_torch.tpu.mesh_exchange import RankMesh

    jobs = [{"kind": "call", "fn": "tests.torch_harness_cases:j4_probe"}]
    for name, case in RANK_AUDITS.items():
        kw = dict(chunk_per_device=16, frontier_cap=1 << 8,
                  visited_cap=1 << 10)
        kw.update(RANK_AUDIT_KW.get(name, {}))
        job = ranks.search_job("tests.torch_harness_cases:spec_twin", case,
                               **kw)
        jobs.append(dict(job, kind="audit"))
    jobs.append(dict(ranks.swarm_job(
        "dslabs_tpu_torch.tpu.protocols.pingpong:make_pingpong_protocol",
        {"workload_size": 2}, walkers_per_device=8, max_steps=16,
        visited_cap=1 << 10), kind="audit", swarm=True))
    res = ranks.launch(RankMesh(["cpu", "cpu"], "gloo"), jobs,
                       deadline=240.0, pg_timeout=60.0)
    return {name: [r["results"][i] for r in res]
            for i, name in enumerate(["j4"] + list(RANK_AUDITS)
                                     + ["swarm"])}


def test_rank_swarm_sites_clean(rank_audit):
    """The swarm's four sites on two gloo ranks (one walker group per
    rank): declared multi-device there, so its collectives are no J4,
    and no site exceeds its budget."""
    for r in rank_audit["swarm"]:
        assert r["findings"] == []
        assert {k for k in r["report"] if k.startswith("swarm.")} == {
            "swarm.init", "swarm.step", "swarm.sync", "swarm.flags"}


def test_j4_collective_in_two_gloo_ranks(rank_audit):
    """On each of two ranks a collective of the exchange is J4 in a site
    declared single-device and clean in one declared multi-device."""
    for r in rank_audit["j4"]:
        single, multi = r["value"]["single"], r["value"]["multi"]
        assert [f["code"] for f in single] == ["J4"]
        assert "allreduce" in single[0]["message"]
        assert multi == []


@pytest.mark.parametrize("name", list(RANK_AUDITS))
def test_rank_sites_clean_with_syncs_at_budget(rank_audit, name):
    """The sharded sites on a gloo rank over the CPU: no finding (their
    collectives are declared), and each site's measured syncs equal its
    configured budget (no staging on the CPU: LocalExchange's counts)."""
    for r in rank_audit[name]:
        assert r["findings"] == [] and r["staged"] is False
        sharded = {k: v for k, v in r["report"].items()
                   if k.startswith("sharded.")}
        assert sharded and all(v["syncs"] == v["budget"]
                               for v in sharded.values()), sharded
        if name == "steal":
            assert "sharded.steal" in sharded
        if name == "legacy":
            assert "sharded.step" in sharded
        if name == "spill":
            assert {"sharded.spill_drain:fetch", "sharded.spill_evict:fetch",
                    "sharded.spill_reinject"} <= set(sharded)


# ------------------------------------------------------------------ J5

def test_j5_per_build_random_constants_and_stable_twin():
    y = torch.zeros((8,), dtype=torch.float32)

    def churning():
        consts = torch.rand(8)          # fresh per build
        return lambda x: x + consts

    found = _audit("device.promote",
                   _entry(churning(), (y,), builder=churning), deep=True)
    assert _codes(found) == ["J5"]
    assert "return values" in found[0].message

    def reshaping():
        n = reshaping.n = getattr(reshaping, "n", 0) + 1
        return lambda x: x[:n] + 1      # another trace per build

    found = _audit("device.promote",
                   _entry(reshaping(), (y,), builder=reshaping), deep=True)
    assert _codes(found) == ["J5"] and "op trace" in found[0].message

    stable = torch.ones((8,), dtype=torch.float32)

    def steady():
        return lambda x: x + stable

    assert _audit("device.promote",
                  _entry(steady(), (y,), builder=steady), deep=True) == []
    # Not deep: no rebuild.
    assert _audit("device.promote",
                  _entry(churning(), (y,), builder=churning)) == []


# --------------------------------------------------------- clean pins

def _engine_set():
    return H.build_audit_engines("cpu")


@pytest.mark.parametrize("i", range(6), ids=["pingpong", "paxos_symmetry",
                                              "spill", "swarm", "lanes",
                                              "sharded"])
def test_audit_set_clean_with_syncs_at_budget(i):
    search = _engine_set()[i]
    rep = {}
    assert H.audit_search(search, report=rep) == []
    assert rep and {k: v["syncs"] for k, v in rep.items()} == {
        k: v["budget"] for k, v in rep.items()}


def test_audit_set_budgets():
    """The budgets the registry's design notes give, per configuration."""
    want = {
        0: {"device.step": 0, "device.sync": 1, "device.flags": 1,
            "host.expand": 0, "device.init": 0, "visited.insert": 0},
        1: {"device.step": 1, "packing.pack": 0, "packing.unpack": 0,
            "symmetry.canonicalize": 0},
        2: {"device.step": 1, "device.spill_drain:fetch": 3,
            "device.spill_drain:reset": 0, "device.spill_evict:fetch": 1,
            "device.spill_evict:reset": 0, "device.spill_reinject": 1},
        3: {"swarm.init": 3, "swarm.step": 1, "swarm.sync": 1,
            "swarm.flags": 6},
        4: {"lanes.init": 0, "lanes.superstep": 0, "lanes.sync": 1,
            "lanes.promote": 0, "lanes.inject": 0, "lanes.restore": 3,
            "lanes.flags": 1, "visited.insert": 0},
        5: {"sharded.init": 0, "sharded.superstep": 1,
            "sharded.promote": 0, "visited.insert": 0},
    }
    for i, search in enumerate(_engine_set()):
        rep = {}
        H.audit_search(search, report=rep)
        assert {k: rep[k]["syncs"] for k in want[i]} == want[i], i


@pytest.mark.parametrize("twin", ["compiled", "hand"])
def test_flagship_chunk_step_syncs(twin):
    """The flagship's chunk step at a small chunk: one sync packed
    (``torch.nonzero`` before the pack), none by the hand twin."""
    if twin == "compiled":
        from dslabs_tpu_torch.tpu.specs_lab3 import make_paxos_protocol
    else:
        from dslabs_tpu_torch.tpu.protocols.paxos import make_paxos_protocol
    p = dataclasses.replace(make_paxos_protocol(
        n=3, n_clients=1, w=1, max_slots=2, net_cap=48, timer_cap=6),
        goals={})
    ts = TensorSearch(p, chunk=16, frontier_cap=1 << 8,
                      visited_cap=1 << 12, device="cpu")
    sites = ts.dispatch_site_programs()
    rep = {}
    assert H.audit_sites({"device.step": sites["device.step"]},
                         "TensorSearch", report=rep) == []
    assert rep["device.step"]["syncs"] == (1 if twin == "compiled" else 0)
    if twin == "compiled":
        assert "torch.nonzero at dslabs_tpu_torch/tpu/engine.py:" in \
            rep["device.step"]["sync_ops"][0]


def test_throwaway_carry_is_not_the_search_s():
    """The sites run on a carry built for the audit: a search run after
    its engine was audited keeps its counts."""
    p = make_pingpong_protocol(2)
    base = TensorSearch(p, **CAPS).run()
    ts = TensorSearch(p, **CAPS)
    H.audit_search(ts, deep=True)
    out = ts.run()
    assert (out.end_condition, out.unique_states, out.states_explored,
            out.depth) == (base.end_condition, base.unique_states,
                           base.states_explored, base.depth)


def test_site_set_parity_with_reference():
    """The tags the port audits map one to one onto the reference's
    ``build_audit_engines`` tags, the sharded engine's included; the port
    also audits the readbacks and host helpers the reference's registry
    lists without a program."""
    from dslabs_tpu.analysis.jaxpr_audit import \
        build_audit_engines as ref_engines
    from dslabs_tpu.tpu.telemetry import DISPATCH_SITES as REF_SITES

    ref = set()
    for e in ref_engines(mesh_devices=2):
        ref |= set(e.dispatch_site_programs())
    assert {t for t in ref if t.split(".")[0] == "sharded"} == {
        "sharded.init", "sharded.promote", "sharded.superstep"}
    # The reference's fused swarm round is the port's walk step plus its
    # stats readback (swarm.sync, a tag of the port's own).
    rename = {"swarm.round": "swarm.step"}
    mapped = {rename.get(t, t) for t in ref}
    port = set()
    for e in _engine_set():
        port |= set(e.dispatch_site_programs())
    extra = {"device.sync", "device.flags", "host.expand",
             "device.spill_reinject", "swarm.init", "swarm.sync",
             "swarm.flags", "lanes.sync", "lanes.flags"}
    assert port == mapped | extra and not mapped & extra
    assert extra - {"swarm.sync"} <= set(REF_SITES)
    assert all(not REF_SITES[t]["program"]
               for t in extra - {"swarm.init", "swarm.sync"})
    assert port <= set(ttel.DISPATCH_SITES)


# ------------------------------------------------------ run-time hook

def test_sanitize_hook_records_telemetry_events(monkeypatch):
    """The audit runs when the first run starts; its findings are events
    and one warning, and its steps are not the run's."""
    p = make_pingpong_protocol(2)
    bare = TensorSearch(p, **CAPS)
    bare.run()
    sites = {k: v for k, v in ttel.DISPATCH_SITES.items()
             if k != "device.promote"}
    monkeypatch.setattr(ttel, "DISPATCH_SITES", sites)
    tel = ttel.Telemetry()
    ts = TensorSearch(p, telemetry=tel, sanitize="on", **CAPS)
    assert not tel.events                # nothing at build time
    with pytest.warns(RuntimeWarning, match="hot-path audit finding"):
        ts.run()
    evs = [e for e in tel.events if e.get("kind") == "sanitizer_finding"]
    assert evs and evs[0]["code"] == "J0"
    assert evs[0]["site"] == "device.promote"
    assert ts.chunk_steps == bare.chunk_steps


def test_sanitize_swarm_and_bad_mode():
    from dslabs_tpu_torch.tpu.swarm import SwarmSearch

    def swarm(**kw):
        return SwarmSearch(make_pingpong_protocol(2), walkers_per_device=8,
                           max_steps=8, max_rounds=2, visited_cap=1 << 10,
                           device="cpu", **kw)
    bare = swarm()
    bare.run()
    tel = ttel.Telemetry()
    sw = swarm(telemetry=tel, sanitize="full")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sw.run()
    assert not [e for e in tel.events
                if e.get("kind") == "sanitizer_finding"]
    assert sw.walk_steps == bare.walk_steps
    with pytest.raises(ValueError, match="sanitize"):
        TensorSearch(make_pingpong_protocol(2), sanitize="yes", **CAPS)


def test_sanitize_audits_a_subclass_once(monkeypatch):
    """A subclass of the engine that adds no hook of its own is audited
    too, once over its runs."""
    called = []
    monkeypatch.setattr(H, "audit_search",
                        lambda *a, **k: called.append(a[0]) or [])

    class Sub(TensorSearch):
        pass

    ts = Sub(make_pingpong_protocol(2), sanitize="on", **CAPS)
    assert not called
    ts.run()
    ts.run()
    assert called == [ts]


def test_sanitize_off_is_off(monkeypatch):
    """``sanitize=None``: the audit is never called, and a bare run's
    dispatches are those of a run whose engine was audited."""
    called = []
    monkeypatch.setattr(H, "audit_search",
                        lambda *a, **k: called.append(1) or [])

    def run(**kw):
        counts = {}
        ts = TensorSearch(make_pingpong_protocol(2), **CAPS, **kw)

        def hook(tag, fn, *args):
            counts[tag] = counts.get(tag, 0) + 1
            return fn(*args)
        ts._dispatch_hook = hook
        out = ts.run()
        return counts, (out.unique_states, out.states_explored)

    off = run()
    assert not called
    assert run(sanitize="on") == off and called


def test_sanitize_off_imports_nothing_of_the_audit():
    code = ("import sys, torch\n"
            "from dslabs_tpu_torch.tpu.engine import TensorSearch\n"
            "from dslabs_tpu_torch.tpu.protocols.pingpong import "
            "make_pingpong_protocol\n"
            "TensorSearch(make_pingpong_protocol(2), max_depth=4, chunk=64,"
            " frontier_cap=256, visited_cap=1024, device='cpu').run()\n"
            "print(sorted(m for m in sys.modules if 'analysis' in m))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_entries_override_the_registry_only_by_configuration():
    """``DISPATCH_SITES`` holds each site's contract: an engine's entry
    sets ``syncs`` only for ``device.step``, ``lanes.superstep`` and
    ``sharded.superstep`` (by configuration) and the spill resets, and
    never ``in_place`` or ``multi``; the ``sites`` CLI prints the
    configuration-dependent budget as such."""
    cfg = ("device.step", "lanes.superstep", "sharded.superstep")
    for e in _engine_set():
        for tag, name, entry in H.site_entries(e.dispatch_site_programs()):
            assert not {"in_place", "multi"} & set(entry), tag
            if "syncs" in entry:
                assert tag in cfg or name == "reset", tag
            else:
                assert ttel.DISPATCH_SITES[tag]["syncs"] is not None, tag
    for tag in cfg:
        line = next(ln for ln in ttel._render_registry().splitlines()
                    if ln.startswith(tag + " "))
        assert line.split()[-1] == "cfg"


def test_sanitizer_summary_runs_the_audit_on_the_card(monkeypatch):
    """The summary's child takes the CLI's default device, the card; a
    child that exits 2 with no card comes back as an error."""
    from dslabs_tpu_torch import analysis as A

    argv = []

    def child(cmd, **kw):
        argv.extend(cmd)
        return subprocess.CompletedProcess(
            cmd, 2, stdout="", stderr="analysis all: RuntimeError: no card")
    monkeypatch.setattr(A.subprocess, "run", child)
    out = A.sanitizer_summary()
    assert argv[1:] == ["-m", "dslabs_tpu_torch.analysis", "all", "--json"]
    assert out == {"error": "rc 2: analysis all: RuntimeError: no card"}


# ------------------------------------------------------- ledger compare

def test_compare_ledger_flags_sanitizer_rise():
    prior = {"t": "bench", "value": 100.0,
             "sanitizer": {"findings": 0, "conformance": 0, "jaxpr": 0,
                           "waived": 0}}
    worse = {"t": "bench", "value": 100.0,
             "sanitizer": {"findings": 2, "conformance": 1, "jaxpr": 1,
                           "waived": 0}}
    cmp = ttel.compare_ledger([prior, worse])
    assert "sanitizer:findings" in {e["phase"] for e in cmp["regressions"]}
    cmp = ttel.compare_ledger([prior, dict(prior)])
    assert not any(e["phase"].startswith("sanitizer")
                   for e in cmp["regressions"])
    assert cmp["sanitizer"]["findings"]["latest"] == 0


# ---------------------------------------------------------------- slow

@pytest.mark.slow
def test_deep_retrace_clean_audit_set():
    """The J5 rebuild on every site of the audit set gives the same op
    trace and return values."""
    for search in _engine_set():
        assert H.audit_search(search, deep=True) == []


@pytest.mark.slow
def test_cli_all_subprocess_clean():
    proc = subprocess.run(
        [sys.executable, "-m", "dslabs_tpu_torch.analysis", "all", "--json",
         "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    import json

    data = json.loads(proc.stdout.strip().splitlines()[-1])
    assert data["findings"] == 0
    assert data["conformance"] == 0 and data["jaxpr"] == 0
