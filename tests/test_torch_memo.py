"""PyTorch port, cross-job memoization (``dslabs_tpu_torch/service/memo.py``)
on the CPU: the cases of ``tests/test_memo.py`` and the port's parity with
the JAX package's memo.

Fingerprints are held against the JAX package's field by field on the
reference's fixtures, rewritten against each package's compiler, and on
the port's own specs.  The reference's service cases run on the port's
``CheckServer(device="cpu")`` with the memo on; their cold references are
the port's own searches in process.  Two cases drain the JAX server beside
the port's with the memo on: a job sequence that takes every memo mode
(server parity), and the reference's lane cost drain, whose solo side the
memo answers (the reason that reference test is red).  A memo store and
per-level dumps are read across the packages in process.  Warden and
introspection children run with ``OMP_NUM_THREADS=1``."""

import concurrent.futures
import importlib.util
import json
import os
import shutil
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several workers on a few cores.
torch.set_num_threads(1)

from dslabs_tpu import service as jsvc  # noqa: E402
from dslabs_tpu.service import memo as jmemo  # noqa: E402
from dslabs_tpu.tpu import engine as jeng  # noqa: E402
from dslabs_tpu_torch.service import CheckServer  # noqa: E402
from dslabs_tpu_torch.service import memo as memo_mod  # noqa: E402
from dslabs_tpu_torch.tpu import engine as peng  # noqa: E402
from dslabs_tpu_torch.tpu import spill as spill_mod  # noqa: E402
from dslabs_tpu_torch.tpu import tracing  # noqa: E402
from dslabs_tpu_torch.tpu.specs import pingpong_spec  # noqa: E402

pytestmark = [pytest.mark.service, pytest.mark.memo]

CHILD_ENV = {"OMP_NUM_THREADS": "1"}
# The JAX server's children: one CPU thread, the reference tests' cache.
JAX_CHILD_ENV = {"DSLABS_COMPILE_CACHE": "/tmp/jaxcache-cpu",
                 "OMP_NUM_THREADS": "1",
                 "XLA_FLAGS": "--xla_force_host_platform_device_count=8 "
                              "--xla_cpu_multi_thread_eigen=false "
                              "intra_op_parallelism_threads=1"}
FACTORY = ("dslabs_tpu_torch.tpu.protocols.pingpong:"
           "make_exhaustive_pingpong")
CAPS = dict(chunk=64, frontier_cap=1 << 8, visited_cap=1 << 12)
SMALL = dict(factory_kwargs={"workload_size": 2}, **CAPS)
# The pingpong-spec session's jobs run on one rung, so a fault's death is
# a scheduler-level retry (attempt 2).
PP = dict(SMALL, ladder=("device",))
GRACES = {"boot_grace": 120.0, "first_grace": 120.0,
          "steady_grace": 3.0, "idle_grace": 60.0, "grace_slack": 1.0}
LADDER = ("device", "host")


def _server(root, **kw):
    kw.setdefault("admission", False)
    kw.setdefault("elastic", False)
    kw.setdefault("env", CHILD_ENV)
    kw.setdefault("warden_kwargs", dict(GRACES))
    kw.setdefault("device", "cpu")
    return CheckServer(str(root), **kw)


def _jax_server(root, **kw):
    kw.setdefault("admission", False)
    kw.setdefault("elastic", False)
    kw.setdefault("env", JAX_CHILD_ENV)
    kw.setdefault("warden_kwargs", dict(GRACES))
    return jsvc.CheckServer(str(root), **kw)


def _same_verdict(a: dict, b: dict):
    for key in ("end", "unique", "explored", "depth"):
        assert a[key] == b[key], (key, a, b)


def _journal(root):
    with open(os.path.join(str(root), "journal.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _events(root, kind):
    return [e for e in _journal(root) if e.get("t") == kind]


def _costs(root, tenant):
    with open(os.path.join(str(root), "COSTS.jsonl")) as f:
        return [r for r in map(json.loads, f) if r.get("tenant") == tenant]


def _by_tenant(results, tenant):
    (v,) = [v for v in results if v["tenant"] == tenant]
    return v


def _cold(proto, **kw):
    """A cold port search in process -> the verdict fields and witness a
    warden child's verdict carries."""
    o = peng.TensorSearch(proto, strict=True, device="cpu", **CAPS,
                          **kw).run()
    return {"end": o.end_condition, "unique": o.unique_states,
            "explored": o.states_explored, "depth": o.depth,
            "predicate": o.predicate_name,
            "witness": memo_mod.witness_digest(
                o.predicate_name, o.violating_state, o.goal_state,
                o.trace)}


def _import(path, name: str):
    spec = importlib.util.spec_from_file_location(name, str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------- spec fixture modules

# The reference's 3-stage message chain: S1 -> S2 -> S3, x walks
# 0..FINAL.  FINAL=3 exhausts the space; FINAL=4 fires NO_FOUR at depth
# 3.  Field bounds are equal in both versions, so only the S3 handler's
# hash differs.  ``{pkg}`` names the compiler's package.
CHAIN_MODULE = textwrap.dedent("""
    from {pkg}.tpu.compiler import (Field, MessageType, NodeKind,
                                         ProtocolSpec, TimerType)


    def make_chain():
        spec = ProtocolSpec(
            "memo-chain",
            nodes=[NodeKind("proc", 1, (Field("x", init=0, hi=4),))],
            messages=[MessageType("S1", ()), MessageType("S2", ()),
                      MessageType("S3", ())],
            timers=[TimerType("TICK", (), 10, 10)],
            net_cap=4, timer_cap=1)

        @spec.on("proc", "S1")
        def h1(ctx, m):
            ctx.put("x", 1)
            ctx.send("S2", 0)

        @spec.on("proc", "S2")
        def h2(ctx, m):
            ctx.put("x", 2)
            ctx.send("S3", 0)

        @spec.on("proc", "S3")
        def h3(ctx, m):
            ctx.put("x", {final})

        spec.initial_messages.append(("S1", 0, 0, {{}}))

        def no_four(v):
            return v.get("proc", 0, "x") != 4

        spec.invariants["NO_FOUR"] = no_four
        return spec.compile()
""")

# Rename-only variants of the pingpong-spec factory: another module name,
# another factory name, comments, whitespace and a docstring.
SPEC_PP = textwrap.dedent("""
    from dslabs_tpu_torch.tpu.specs import pingpong_spec


    def make(workload_size=2):
        return pingpong_spec(workload_size).compile()
""")

SPEC_PP_RENAMED = textwrap.dedent('''
    # A cosmetic rewrite of the same submission: renamed module,
    # renamed factory, reflowed whitespace.  Structurally identical.
    from dslabs_tpu_torch.tpu.specs import pingpong_spec


    def build(workload_size=2):
        """Same lab-0 spec, different spelling."""

        return pingpong_spec(workload_size).compile()
''')

REP_MODULE = textwrap.dedent("""
    from dslabs_tpu_torch.tpu.compiler import (Field, MessageType,
                                               NodeKind, ProtocolSpec,
                                               TimerType)
    from dslabs_tpu_torch.tpu.quorum import QuorumCount
    from dslabs_tpu_torch.tpu.slots import SlotField, Slots


    def {factory}():
        spec = ProtocolSpec(
            "memo-rep",
            nodes=[NodeKind("proc", 3, (
                Field("x", hi=7),
                Slots("log", {n}, (SlotField("cmd", hi=7,
                                             clear={clear}),),
                      base=1),
            ))],
            messages=[MessageType("GO", ())],
            timers=[TimerType("TICK", (), 10, 10)],
            net_cap=4, timer_cap=1,
            quorums=(QuorumCount("q", over="proc",
                                 threshold={threshold!r}),))

        @spec.on("proc", "GO")
        def go(ctx, m):
            met = ctx.quorum("q").met_bits(ctx.get("x"))
            ctx.slot_put("log", "cmd", 1, 2, when=met)
            ctx.slot_clear_upto("log", 2, when=~met)

        spec.initial_messages.append(("GO", 0, 0, {{}}))
        spec.invariants["OK"] = lambda v: True
        return spec.compile()
""")


def _write_chain(d, name, final, pkg="dslabs_tpu_torch"):
    (d / f"{name}.py").write_text(CHAIN_MODULE.format(pkg=pkg,
                                                      final=final))
    return f"{name}:make_chain"


def _chain(d, name, final, pkg="dslabs_tpu_torch"):
    _write_chain(d, name, final, pkg)
    return _import(d / f"{name}.py", name).make_chain()


# -------------------------------------------- fingerprint parity

INTRO_FIELDS = ("kind", "weak", "base_fp", "spec_fp", "handlers",
                "predicates", "effects", "initial", "ckpt_fp")


def test_fingerprint_parity_chain(tmp_path):
    """``introspect_protocol`` of the CHAIN fixture (FINAL 3 and 4) equals
    the JAX package's on every field, ``env_fingerprint`` with the default
    settings equals the reference's with an empty environment, and the
    divergence bound over the union of the two tables agrees."""
    ours, ref = {}, {}
    for final in (3, 4):
        ours[final] = memo_mod.introspect_protocol(
            _chain(tmp_path, f"pchain{final}", final))
        ref[final] = jmemo.introspect_protocol(
            _chain(tmp_path, f"jchain{final}", final, pkg="dslabs_tpu"))
        for k in INTRO_FIELDS:
            assert ours[final][k] == ref[final][k], (final, k)
        assert ours[final]["kind"] == "spec" and not ours[final]["weak"]
    assert memo_mod.env_fingerprint() == jmemo.env_fingerprint({})
    union = memo_mod._union_effects(ours[3]["effects"], ours[4]["effects"])
    assert union == jmemo._union_effects(ref[3]["effects"],
                                         ref[4]["effects"])
    for changed in (["m:proc:S1"], ["m:proc:S2"], ["m:proc:S3"],
                    ["m:proc:S2", "m:proc:S3"]):
        assert memo_mod.divergence_depth(union, ours[4]["initial"],
                                         changed) == \
            jmemo.divergence_depth(union, ref[4]["initial"], changed)


@pytest.mark.parametrize("name", ["pingpong_spec(2)", "paxos_spec(3)"])
def test_fingerprint_parity_port_specs(name):
    """The port's copies of the lab specs fingerprint as the reference's
    do, every field (no field differs for these two)."""
    from dslabs_tpu.tpu import specs as jspecs
    from dslabs_tpu_torch.tpu import specs as pspecs

    fn, arg = name[:-3], int(name[-2])
    ours = memo_mod.introspect_protocol(getattr(pspecs, fn)(arg).compile())
    ref = jmemo.introspect_protocol(getattr(jspecs, fn)(arg).compile())
    for k in INTRO_FIELDS:
        assert ours[k] == ref[k], k
    assert not ours["weak"]


def test_flagship_fingerprint_is_strong():
    """The flagship (lab3 multi-Paxos at bench.py's configuration) has a
    strong fingerprint in the port: its slot lowering's captured
    ``SlotField`` is hashed by value, where the reference's fingerprint is
    weak (ROADMAP Queue C).  Beside the reference's, the port's
    ``base_fp`` (that SlotField), ``handlers`` and ``predicates`` (the
    port's batched sources), hence ``spec_fp``, differ; its effect table
    is the reference's, pinned here: the root's events fire Request,
    Election and the client timer, and the heartbeat reply first fires
    expanding depth 4."""
    import dataclasses

    from dslabs_tpu_torch.tpu import specs_lab3 as plab3

    ours = memo_mod.introspect_protocol(dataclasses.replace(
        plab3.make_paxos_protocol(n=3, n_clients=2, w=1, max_slots=3,
                                  net_cap=64, timer_cap=6), goals={}))
    assert ours["kind"] == "spec" and not ours["weak"]
    assert ours["initial"] == ["m0", "t1", "t3"]
    eff = ours["effects"]
    assert len(eff) == 13 and eff["m:server:HeartbeatReply"] == {
        "trigger": "m6", "sends": [], "sets": []}
    assert [memo_mod.divergence_depth(eff, ours["initial"], [h]) for h in (
        "m:server:Request", "m:server:P2a", "m:server:P2b",
        "t:server:Heartbeat", "m:server:HeartbeatReply",
        "m:server:CatchupReply")] == [0, 1, 2, 3, 4, 5]


def test_hand_twin_introspects_as_twin():
    from dslabs_tpu_torch.tpu.protocols.pingpong import \
        make_exhaustive_pingpong

    a = memo_mod.introspect_protocol(make_exhaustive_pingpong(2))
    b = memo_mod.introspect_protocol(make_exhaustive_pingpong(2))
    assert a["kind"] == "twin" and not a["weak"]
    assert a["effects"] is None and a["initial"] is None
    assert a == b


# ------------------------------------ the reference's fingerprint cases

def test_rename_only_same_fingerprint(tmp_path):
    """Whitespace / rename-only edits hash to the same structural
    fingerprint; a handler edit hashes to another one."""
    (tmp_path / "fp_a.py").write_text(SPEC_PP)
    (tmp_path / "fp_b.py").write_text(SPEC_PP_RENAMED)
    ma = _import(tmp_path / "fp_a.py", "fp_a")
    mb = _import(tmp_path / "fp_b.py", "fp_b")
    a = memo_mod.introspect_protocol(ma.make(2))
    b = memo_mod.introspect_protocol(mb.build(2))
    assert a["ok"] and b["ok"]
    assert not a["weak"] and not b["weak"]
    assert a["spec_fp"] == b["spec_fp"]
    assert a["base_fp"] == b["base_fp"]
    # Another workload: another structure (the domains change).
    c = memo_mod.introspect_protocol(ma.make(3))
    assert c["spec_fp"] != a["spec_fp"]
    # A one-handler edit: another spec_fp, the same base and predicates,
    # exactly one differing handler hash (the incremental precondition).
    i1 = memo_mod.introspect_protocol(_chain(tmp_path, "fp_v1", 3))
    i2 = memo_mod.introspect_protocol(_chain(tmp_path, "fp_v2", 4))
    assert i1["kind"] == "spec" and not i1["weak"]
    assert i1["spec_fp"] != i2["spec_fp"]
    assert i1["base_fp"] == i2["base_fp"]
    assert i1["predicates"] == i2["predicates"]
    diff = [k for k in i1["handlers"]
            if i1["handlers"][k] != i2["handlers"][k]]
    assert diff == ["m:proc:S3"]


def _rep(tmp_path, name, factory="make_rep", n=2, clear=0,
         threshold="majority"):
    (tmp_path / f"{name}.py").write_text(REP_MODULE.format(
        factory=factory, n=n, clear=clear, threshold=threshold))
    out = memo_mod.introspect_protocol(
        getattr(_import(tmp_path / f"{name}.py", name), factory)())
    assert out["ok"] and not out["weak"], out
    return out


def test_slot_quorum_rename_vs_resize_fingerprints(tmp_path):
    """The Slots and Quorum declarations take part in the fingerprint: a
    factory rename is cosmetic; resizing the slot block, changing a
    SlotField ``clear`` or moving the quorum threshold each change the
    base fingerprint, with every handler hash unchanged."""
    base = _rep(tmp_path, "rep_a")
    renamed = _rep(tmp_path, "rep_b", factory="build_replicated")
    assert renamed["spec_fp"] == base["spec_fp"]
    assert renamed["base_fp"] == base["base_fp"]
    resized = _rep(tmp_path, "rep_c", n=3)
    cleared = _rep(tmp_path, "rep_d", clear=1)
    rethresh = _rep(tmp_path, "rep_e", threshold="all")
    fps = {v["base_fp"] for v in (base, resized, cleared, rethresh)}
    assert len(fps) == 4, fps
    assert resized["handlers"] == base["handlers"]
    assert cleared["handlers"] == base["handlers"]
    assert rethresh["handlers"] == base["handlers"]


def test_duck_typed_slot_block_marks_weak():
    """A slot declaration that is not a real Slots block fingerprints
    weak, so the store refuses to memoize it."""
    from dslabs_tpu_torch.tpu.compiler import (Field, MessageType,
                                               NodeKind, ProtocolSpec,
                                               TimerType)
    from dslabs_tpu_torch.tpu.slots import SlotField, Slots

    spec = ProtocolSpec(
        "memo-duck",
        nodes=[NodeKind("proc", 1, (
            Field("x", hi=4),
            Slots("log", 2, (SlotField("cmd", hi=7),), base=1)))],
        messages=[MessageType("GO", ())],
        timers=[TimerType("TICK", (), 10, 10)],
        net_cap=4, timer_cap=1)

    @spec.on("proc", "GO")
    def go(ctx, m):
        ctx.put("x", ctx.slot_get("log", "cmd", 1))

    spec.initial_messages.append(("GO", 0, 0, {}))
    spec.invariants["OK"] = lambda v: True
    proto = spec.compile()
    assert not memo_mod.introspect_protocol(proto)["weak"]

    class DuckBlock:
        # Enough surface for the Ctx slot ops (the effect-table run
        # still works), but no ``name`` / ``fields``.
        base, n = 1, 2

        def lane(self, field):
            return f"log.{field}"

    spec.slot_blocks[("proc", "log")] = DuckBlock()
    assert memo_mod.introspect_protocol(proto)["weak"]


def test_divergence_bound_chain(tmp_path):
    """Tag-reachability lower-bounds the first level a changed handler
    can fire: editing S3 in the 3-stage chain shares levels 0..2."""
    i1 = memo_mod.introspect_protocol(_chain(tmp_path, "div_v1", 3))
    eff, init = i1["effects"], i1["initial"]
    assert memo_mod.divergence_depth(eff, init, {"m:proc:S3"}) == 2
    assert memo_mod.divergence_depth(eff, init, {"m:proc:S2"}) == 1
    assert memo_mod.divergence_depth(eff, init, {"m:proc:S1"}) == 0
    assert memo_mod.divergence_depth(
        eff, ["m1"], {"m:proc:S1"}) >= memo_mod._INF


# ------------------------------------- visited-tier save/load/refuse

def _tier_arrays(n=64, seed=7):
    rng = np.random.default_rng(seed)
    h1 = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    h2 = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    return h1, h2


def test_tier_roundtrip_and_prev_rotation(tmp_path):
    path = str(tmp_path / "tier.npz")
    assert spill_mod.peek_tier_meta(path) is None
    h1, h2 = _tier_arrays()
    spill_mod.save_tier(path, h1, h2, {"pack": "p1", "sym": 0})
    r1, r2, meta = spill_mod.load_tier(
        path, expect_meta={"pack": "p1", "sym": 0})
    assert np.array_equal(r1, h1) and np.array_equal(r2, h2)
    assert meta["fmt"] == spill_mod.TIER_FORMAT
    assert spill_mod.peek_tier_meta(path) == meta
    # The second save rotates .prev; a torn main file falls back to it.
    g1, g2 = _tier_arrays(seed=8)
    spill_mod.save_tier(path, g1, g2, {"pack": "p1", "sym": 3})
    assert os.path.exists(path + ".prev")
    assert spill_mod.peek_tier_meta(path)["sym"] == 3
    with open(path, "wb") as f:
        f.write(b"torn")
    assert spill_mod.peek_tier_meta(path)["sym"] == 0
    f1, _, _ = spill_mod.load_tier(path,
                                   expect_meta={"pack": "p1", "sym": 0})
    assert np.array_equal(f1, h1)  # .prev holds the first save
    # Both torn: loud corruption, never empty arrays.
    with open(path + ".prev", "wb") as f:
        f.write(b"also-torn")
    assert spill_mod.peek_tier_meta(path) is None
    with pytest.raises(spill_mod.TierCorrupt):
        spill_mod.load_tier(path, expect_meta={"pack": "p1", "sym": 0})


def test_tier_refuses_foreign_pack_and_symmetry(tmp_path):
    path = str(tmp_path / "tier.npz")
    h1, h2 = _tier_arrays()
    spill_mod.save_tier(path, h1, h2, {"pack": "pack-v1:abcd", "sym": 0})
    with pytest.raises(spill_mod.TierMismatch, match="pack"):
        spill_mod.load_tier(path, expect_meta={"pack": "pack-v2:ffff",
                                               "sym": 0})
    with pytest.raises(spill_mod.TierMismatch, match="sym"):
        spill_mod.load_tier(path, expect_meta={"pack": "pack-v1:abcd",
                                               "sym": 6})


# ----------------------------------- per-level dumps across packages

def test_archived_levels_resume_in_both_packages(tmp_path):
    """A port run with a levels directory writes ``level_<d>.npz`` for
    each completed depth; each resumes in both packages to the counts of
    the straight run (to depth 3: each JAX resume compiles anew)."""
    from dslabs_tpu.tpu.protocols.pingpong import \
        make_exhaustive_pingpong as jpp
    from dslabs_tpu_torch.tpu.protocols.pingpong import \
        make_exhaustive_pingpong as ppp

    levels = tmp_path / "levels"
    straight = peng.TensorSearch(
        ppp(2), strict=True, device="cpu", max_depth=3, **CAPS,
        checkpoint_path=str(tmp_path / "ckpt.npz"), checkpoint_every=1,
        levels_dir=str(levels)).run()
    want = (straight.end_condition, straight.unique_states,
            straight.states_explored, straight.depth)
    names = sorted(os.listdir(levels))
    assert names == [f"level_{d}.npz" for d in range(1, straight.depth + 1)]
    assert straight.end_condition == "DEPTH_EXHAUSTED"
    jts = jeng.TensorSearch(jpp(2), strict=True, max_depth=3, **CAPS)
    for n in names:
        got = []
        for pkg in ("port", "jax"):
            path = str(tmp_path / f"{pkg}_{n}")
            shutil.copyfile(levels / n, path)
            if pkg == "port":
                o = peng.TensorSearch(ppp(2), strict=True,
                                      device="cpu", max_depth=3, **CAPS,
                                      checkpoint_path=path).run(resume=True)
            else:
                jts.checkpoint_path = path
                o = jts.run(resume=True)
            got.append((o.end_condition, o.unique_states,
                        o.states_explored, o.depth))
        assert got == [want, want], n


def _archive(mod, store_path, o, intro, run_dir, ladder=LADDER,
             **fields_kw):
    """Archive one finished in-process run ``o`` of ``mod``'s package."""
    verdict = {"status": "done", "end": o.end_condition,
               "unique": o.unique_states, "explored": o.states_explored,
               "depth": o.depth, "engine": "device"}
    store = mod.MemoStore(str(store_path))
    fields = mod.key_fields(intro, True, CAPS["chunk"],
                            CAPS["frontier_cap"], CAPS["visited_cap"],
                            ladder, **fields_kw)
    assert store.archive(intro, fields, verdict, str(run_dir), 1.0)
    return store


def test_memo_store_shared_across_packages(tmp_path, monkeypatch):
    """A store archived by the JAX package on the CHAIN fixture is read by
    the port's MemoStore: ``plan`` gives warm and the port's resumed run
    gives the JAX's cold counts; and the reverse."""
    jproto = _chain(tmp_path, "xj", 3, pkg="dslabs_tpu")
    pproto = _chain(tmp_path, "xp", 3)
    jintro = jmemo.introspect_protocol(jproto)
    pintro = memo_mod.introspect_protocol(pproto)
    jts = jeng.TensorSearch(jproto, strict=True, **CAPS)
    jcold = jts.run()
    pcold = peng.TensorSearch(pproto, strict=True, device="cpu",
                              **CAPS).run()
    want = (jcold.end_condition, jcold.unique_states,
            jcold.states_explored, jcold.depth)
    assert want == (pcold.end_condition, pcold.unique_states,
                    pcold.states_explored, pcold.depth)

    # JAX archives (its dumps levelled through DSLABS_MEMO_LEVELS), the
    # port plans and resumes.
    jrd = tmp_path / "jrun"
    jrd.mkdir()
    monkeypatch.setenv("DSLABS_MEMO_LEVELS", str(jrd / "levels"))
    jts.max_depth, jts.checkpoint_path = 2, str(jrd / "ckpt.npz")
    jts.checkpoint_every = 1
    _archive(jmemo, tmp_path / "jstore", jts.run(), jintro, jrd, env={})
    monkeypatch.delenv("DSLABS_MEMO_LEVELS")
    plan = memo_mod.MemoStore(str(tmp_path / "jstore")).plan(
        pintro, True, CAPS["chunk"], CAPS["frontier_cap"],
        CAPS["visited_cap"], LADDER, None, None)
    assert plan.mode == "warm" and plan.seed_depth >= 1
    seed = str(tmp_path / "pseed.npz")
    shutil.copyfile(plan.seed_ckpt, seed)
    o = peng.TensorSearch(pproto, strict=True, device="cpu", **CAPS,
                          checkpoint_path=seed).run(resume=True)
    assert o.resumed_from_depth == plan.seed_depth
    assert (o.end_condition, o.unique_states, o.states_explored,
            o.depth) == want

    # The port archives, the JAX package plans and resumes.
    prd = tmp_path / "prun"
    prd.mkdir()
    ps = peng.TensorSearch(pproto, strict=True, device="cpu", **CAPS,
                           max_depth=2, checkpoint_path=str(prd / "ckpt.npz"),
                           checkpoint_every=1,
                           levels_dir=str(prd / "levels"))
    _archive(memo_mod, tmp_path / "pstore", ps.run(), pintro, prd)
    jplan = jmemo.MemoStore(str(tmp_path / "pstore")).plan(
        jintro, True, CAPS["chunk"], CAPS["frontier_cap"],
        CAPS["visited_cap"], LADDER, None, None, env={})
    assert jplan.mode == "warm" and jplan.seed_depth >= 1
    jseed = str(tmp_path / "jseed.npz")
    shutil.copyfile(jplan.seed_ckpt, jseed)
    jts.max_depth, jts.checkpoint_path = None, jseed
    jts.checkpoint_every = 0
    o = jts.run(resume=True)
    assert (o.end_condition, o.unique_states, o.states_explored,
            o.depth) == want


# ------------------------------------------- service-level reuse

@pytest.fixture(scope="module")
def pp_session(tmp_path_factory):
    """One memo server on the pingpong spec, one worker: alice's job to
    depth 3 (cold); then bob's full job (warm from alice's dump), carol's
    wider one (cold) and dave's copy of bob's (answered at run time once
    bob archived) in one drain; then erin's copy answered at submit."""
    d = tmp_path_factory.mktemp("pp")
    (d / "pp_a.py").write_text(SPEC_PP)
    (d / "pp_b.py").write_text(SPEC_PP_RENAMED)
    root = d / "svc"
    srv = _server(root, workers=1, extra_sys_path=[str(d)])
    first = srv.submit("pp_a:make", tenant="alice", max_depth=3, **PP)
    assert first["accepted"], first
    srv.drain()
    for tenant in ("bob", "carol", "dave"):
        kw = dict(PP, factory_kwargs={
            "workload_size": 3 if tenant == "carol" else 2})
        assert srv.submit("pp_a:make", tenant=tenant, **kw)["accepted"]
    drain2 = srv.drain()
    erin = srv.submit("pp_a:make", tenant="erin", **PP)
    srv.close()
    return {"dir": d, "root": root, "srv": srv, "drain2": drain2,
            "erin": erin, "results": srv.results,
            "cold": _cold(pingpong_spec(2).compile()),
            "cold3": _cold(pingpong_spec(2).compile(), max_depth=3)}


def test_exact_hit_zero_dispatch(pp_session):
    """The identical resubmit returns the cached verdict with zero
    dispatches: memo_hit journaled, cached=true, 0 COSTS device seconds."""
    s = pp_session
    res = s["erin"]
    assert res.get("memo") == "hit"
    hit = res["verdict"]
    assert hit["cached"] is True
    src = [v for v in s["results"]
           if v["tenant"] in ("bob", "dave") and not v.get("cached")][0]
    _same_verdict(hit, src)
    _same_verdict(hit, s["cold"])
    assert hit["witness"] == src["witness"]
    hits = [e for e in _events(s["root"], "memo_hit")
            if e["job_id"] == hit["job_id"]]
    assert len(hits) == 1
    erin = _costs(s["root"], "erin")[-1]
    assert erin["device_secs"] == 0.0 and erin["dispatches"] == 0
    st = s["srv"].server_status()
    assert st["memo"]["hits"] == 2          # dave's and erin's
    assert st["memo"]["device_secs_saved"] > 0


def test_warm_start_parity(pp_session):
    """The budget grew and the signature matched: the job resumed from
    the archived frontier with the counts of a cold run at that depth."""
    s = pp_session
    _same_verdict(_by_tenant(s["results"], "alice"), s["cold3"])
    warm = [v for v in s["results"]
            if v["tenant"] in ("bob", "dave") and not v.get("cached")]
    assert len(warm) == 1
    _same_verdict(warm[0], s["cold"])
    assert warm[0]["resumed_from_depth"] > 0
    ev = [e for e in _events(s["root"], "memo") if e.get("mode") == "warm"]
    assert len(ev) == 1 and ev[0]["seed_depth"] == 3
    assert ev[0]["job_id"] == warm[0]["job_id"]
    assert s["srv"].server_status()["memo"]["warm_starts"] == 1


def test_three_tenant_drain_resubmit_bills_under_ten_percent(pp_session):
    """In a 3-tenant drain an identical resubmit of a job that ran in the
    same drain bills under 10% of its device seconds in COSTS (here 0:
    the hit never dispatches)."""
    s = pp_session
    summary = s["drain2"]
    # The summary counts the server's verdicts: alice's, and this drain's
    # three.
    assert summary["completed"] == 4 and summary["failed"] == 0
    assert sorted(r["tenant"] for r in summary["results"]) == [
        "alice", "bob", "carol", "dave"]
    ran = [v for v in s["results"]
           if v["tenant"] in ("bob", "dave") and not v.get("cached")]
    hit = [v for v in s["results"]
           if v["tenant"] in ("bob", "dave") and v.get("cached")]
    assert len(ran) == len(hit) == 1
    _same_verdict(ran[0], hit[0])
    c_ran = _costs(s["root"], ran[0]["tenant"])[-1]
    c_hit = _costs(s["root"], hit[0]["tenant"])[-1]
    assert c_ran["device_secs"] > 0
    assert c_hit["device_secs"] < 0.10 * c_ran["device_secs"]
    assert summary["memo"]["hits"] == 1
    # The hit started no warden child: its job has no flight log (the
    # reason the reference's tenant-isolation soak, which lists every
    # job's flight log, is red with the memo on).
    assert not os.path.exists(os.path.join(
        str(s["root"]), "jobs", hit[0]["job_id"], "flight.jsonl"))
    assert os.path.exists(os.path.join(
        str(s["root"]), "jobs", ran[0]["job_id"], "flight.jsonl"))
    _same_verdict(_by_tenant(s["results"], "carol"),
                  _cold(pingpong_spec(3).compile()))
    # A memo-hit job's causal tree carries the memo node, and no attempt.
    tr = tracing.assemble(str(s["root"]), job=hit[0]["job_id"])
    (j,) = tr["jobs"]
    kinds = [n["kind"] for n in j["nodes"]]
    assert "memo" in kinds and "attempt" not in kinds
    assert "memo: memo-hit" in tracing.render_trace(tr)


def test_rename_only_resubmit_hits_both_caches(pp_session, tmp_path):
    """Admission and the memo share one spec identity: a rename-only
    resubmit is an admission-cache hit and a verdict-cache hit."""
    s = pp_session
    root = tmp_path / "svc"
    srv = _server(root, admission=True, extra_sys_path=[str(s["dir"])],
                  memo_path=str(s["root"] / "memo"))
    res = srv.submit("pp_a:make", tenant="alice", **PP)
    res2 = srv.submit("pp_b:build", tenant="bob", **PP)
    srv.close()
    assert res.get("accepted") and res2.get("memo") == "hit"
    adm = _events(root, "admission")
    assert [e["cached"] for e in adm] == [False, True]
    _same_verdict(res2["verdict"], res["verdict"])
    _same_verdict(res2["verdict"], s["cold"])


def test_memo_off_overhead_guard(pp_session, tmp_path):
    """Memo off leaves the service path as it was: no memo dir, no memo
    events, no introspection, the same verdict.  On is the default."""
    s = pp_session
    srv = _server(tmp_path / "off", memo=False,
                  extra_sys_path=[str(s["dir"])])
    assert srv.memo is None
    srv.submit("pp_a:make", tenant="a", max_depth=3, **PP)
    srv.drain()
    srv.close()
    (a,) = srv.results
    assert a["status"] == "done"
    _same_verdict(a, _by_tenant(s["results"], "alice"))
    assert not os.path.isdir(str(tmp_path / "off" / "memo"))
    ev = _journal(tmp_path / "off")
    assert not [e for e in ev if e.get("t") in ("memo", "memo_hit")]
    assert srv.server_status()["memo"] == {"enabled": False}
    srv_on = CheckServer(str(tmp_path / "on"), device="cpu")
    assert srv_on.memo is not None
    assert srv_on.server_status()["memo"]["enabled"] is True
    srv_on.close()


def test_sigkill_mid_warm_start_resume_parity(pp_session, tmp_path):
    """A SIGKILL mid-warm-start is survived by the normal resume path:
    the seeded job's verdict equals the cold full run, and the fault
    never lands a cached verdict.  The job shares the session's store
    (its depth-3 dump); its depth limit 4 is past the goal's depth but a
    new verdict key."""
    s = pp_session
    srv = _server(tmp_path / "svc", workers=1,
                  extra_sys_path=[str(s["dir"])],
                  memo_path=str(s["root"] / "memo"))
    # The seeded dump exists before the child boots, so after_ckpt arms
    # at once and the kill lands on the first warm dispatch.
    srv.submit("pp_a:make", tenant="b", max_depth=4,
               fault={"kind": "die", "at": 1, "after_ckpt": True}, **PP)
    srv.drain()
    srv.close()
    out = _by_tenant(srv.results, "b")
    assert out["status"] == "done"
    _same_verdict(out, s["cold"])
    assert out["attempts"] >= 2           # the fault really fired
    assert out.get("cached") is not True
    warm = [e for e in _events(tmp_path / "svc", "memo")
            if e.get("mode") == "warm"]
    assert len(warm) == 1                 # seeded before the SIGKILL


# --------------------------------------- server parity with the JAX memo

def _modes(root) -> dict:
    """job_id -> (mode, seed_depth, levels_skipped) from the journal."""
    out = {}
    for e in _journal(root):
        if e.get("t") == "memo_hit":
            out[e["job_id"]] = ("hit", 0, 0)
        elif e.get("t") == "memo" and e.get("job_id") \
                and e.get("mode") in ("warm", "incremental"):
            out[e["job_id"]] = (e["mode"], e["seed_depth"],
                                e["levels_skipped"])
    return out


def _chain_sequence(make_server, d, pkg) -> list:
    """Cold to depth 2, the identical resubmit, the deeper resubmit, and
    the one-handler edit written over the module in place."""
    name = "seq_" + pkg.split("_")[-1]
    factory = _write_chain(d, name, 3, pkg=pkg)
    srv = make_server(d / f"svc_{pkg}", extra_sys_path=[str(d)],
                      workers=1)
    jobs = []
    for tenant, final, depth in (("cold", 3, 2), ("again", 3, 2),
                                 ("deeper", 3, None), ("edit", 4, None)):
        if final == 4:
            _write_chain(d, name, 4, pkg=pkg)
        res = srv.submit(factory, tenant=tenant, max_depth=depth, **CAPS)
        assert res.get("accepted"), res
        srv.drain()
    srv.close()
    modes = _modes(d / f"svc_{pkg}")
    for v in srv.results:
        jobs.append(dict(
            {k: v.get(k) for k in ("tenant", "end", "unique", "explored",
                                   "depth", "witness", "predicate")},
            memo=modes.get(v["job_id"], ("cold", 0, 0))))
    return sorted(jobs, key=lambda j: ["cold", "again", "deeper",
                                       "edit"].index(j["tenant"]))


def _lane_cost_drain(make_server, root, factory):
    """The reference's lane cost drain, solo side: two tenants, two
    identical pingpong jobs each, one worker, quota 2."""
    srv = make_server(root, workers=1, quota=2, queue_cap=16)
    for t in ("alice", "bob"):
        for _ in range(2):
            r = srv.submit(factory=factory,
                           factory_kwargs={"workload_size": 2},
                           tenant=t, max_secs=60.0, **CAPS)
            assert r.get("accepted"), r
    summary = srv.drain(max_secs=300)
    srv.close()
    recs, _ = tracing.read_flight_lax(str(root / tracing.COSTS_NAME))
    return summary, recs


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """The server drains that only wait on their children run on one
    background thread from the module's start, one after another, while
    the other cases run: the JAX server's CHAIN sequence, the port's, and
    the JAX server's lane cost drain."""
    d = tmp_path_factory.mktemp("chain")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield {"dir": d,
               "chain_jax": pool.submit(_chain_sequence, _jax_server, d,
                                        "dslabs_tpu"),
               "chain_port": pool.submit(_chain_sequence, _server, d,
                                         "dslabs_tpu_torch"),
               "lanes_jax": pool.submit(
                   _lane_cost_drain, _jax_server,
                   tmp_path_factory.mktemp("lanes_jax"),
                   "dslabs_tpu.tpu.protocols.pingpong:"
                   "make_exhaustive_pingpong")}


@pytest.fixture(scope="module")
def chain_servers(background):
    """The CHAIN job sequence through the port's and the JAX package's
    servers with the memo on."""
    return {"dir": background["dir"],
            "port": background["chain_port"].result(),
            "jax": background["chain_jax"].result()}


def test_server_parity_with_jax_memo(chain_servers):
    """Per job the memo mode, seed depth, levels skipped and the verdict
    (end, unique, explored, depth, witness) equal the JAX server's."""
    port, ref = chain_servers["port"], chain_servers["jax"]
    assert [j["memo"][0] for j in port] == ["cold", "hit", "warm",
                                            "incremental"]
    assert port == ref


def test_incremental_recheck_and_stale_impossibility(chain_servers,
                                                     tmp_path):
    """The module edited in place under the same factory path never
    returns the old cached verdict: it completes through an incremental
    re-check (levels_skipped >= 1) with a verdict and witness equal to
    its own cold run."""
    ref = _cold(_chain(tmp_path, "chain_cold", 4))
    assert ref["end"] == "INVARIANT_VIOLATED"
    assert ref["predicate"] == "NO_FOUR"
    v1 = chain_servers["port"][2]
    assert v1["end"] == "SPACE_EXHAUSTED"
    v2 = chain_servers["port"][3]
    mode, seed, skipped = v2["memo"]
    assert mode == "incremental" and skipped >= 1 and seed == skipped
    assert v2["end"] == "INVARIANT_VIOLATED"
    _same_verdict(v2, ref)
    assert v2["predicate"] == ref["predicate"]
    assert v2["witness"] == ref["witness"] is not None
    root = chain_servers["dir"] / "svc_dslabs_tpu_torch"
    hits = _events(root, "memo_hit")
    assert len(hits) == 1                 # the identical resubmit only
    edit_job = [e for e in _journal(root) if e.get("t") == "submit"
                and e["job"]["tenant"] == "edit"][0]["job"]["job_id"]
    assert all(h["job_id"] != edit_job for h in hits)
    srv = _server(root, extra_sys_path=[str(chain_servers["dir"])])
    st = srv.server_status()
    srv.close()
    assert st["memo"]["enabled"] is True


def test_lane_cost_drain_memo_on_matches_jax_server(background, tmp_path):
    """The reference's lane cost drain (two tenants, two identical
    pingpong jobs each, one worker, quota 2), solo side, with the memo on
    in both packages: the first job runs, the other three are answered
    from the verdict cache with 0 dispatches, so the solo mean is 16 / 4
    = 4.0 dispatches per job, the lanes' figure: the reason the
    reference's ``test_lanes.py::test_service_lane_drain_costs_match_solo``
    (``lanes <= 0.5 x solo``) is red."""

    port, port_costs = _lane_cost_drain(_server, tmp_path / "port",
                                        FACTORY)
    ref, ref_costs = background["lanes_jax"].result()
    for summary, costs in ((port, port_costs), (ref, ref_costs)):
        assert summary["completed"] == 4 and summary["failed"] == 0
        assert sorted(r["dispatches"] for r in costs) == [0, 0, 0, 16]
        assert summary["dispatches_per_job"] == 4.0
        assert summary["memo"]["hits"] == 3
        assert sum(bool(r.get("cached")) for r in summary["results"]) == 3
    key = ("tenant", "end", "unique", "explored", "depth")
    assert sorted(tuple(r.get(k) for k in key) + (bool(r.get("cached")),)
                  for r in port["results"]) == \
        sorted(tuple(r.get(k) for k in key) + (bool(r.get("cached")),)
               for r in ref["results"])
