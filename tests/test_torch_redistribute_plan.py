"""The port's multi-hop redistribution planner held to the JAX reference's.

Mirrors ``tests/test_redistribute_plan.py`` (all but its script test) and
the planner cases of ``tests/test_quantcomm.py``.  Plans are searched on
layout-only meshes in this process, beside the reference's on conftest's
8 virtual devices: hop kinds, intermediate specs, bytes and costs are
exact.  Transitions run in gloo worlds of 8 and 4 ranks
(``tests/torch_spmd_child.py``'s ``plan*`` cases) on numpy-seeded inputs:
every rank's piece and full tensor exactly the reference's (integer-valued
inputs where a sum is involved), and the int8 transition bitwise
``collectives.all_reduce_q`` and the reference's quantized redistribute.

The port's single hop serves some pairs the reference plans in several
hops (ROADMAP.md section C): there the dispatch takes one pass (tier
``kernel``), and the planner, asked directly, still plans them as the
reference does and its plan runs to the same result.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vescale_tpu as vt
from vescale_tpu import placements as ref_pl
from vescale_tpu import redistribute_plan as ref_rp
from vescale_tpu.spec import DArraySpec as RefSpec, TensorMeta as RefMeta

import torch_spmd_child as child
from torch_spmd_child import enc, make_input

from vescale_tpu_torch import placements as pl
from vescale_tpu_torch import redistribute_plan as rp
from vescale_tpu_torch import transfer
from vescale_tpu_torch.mesh import DeviceMesh
from vescale_tpu_torch.spec import DArraySpec, TensorMeta

S, R, P = ref_pl.Shard, ref_pl.Replicate, ref_pl.Partial
IS, RS, SRS = ref_pl.InterleavedShard, ref_pl.RaggedShard, ref_pl.StridedRaggedShard
STRICT = {"VESCALE_STRICT_REDISTRIBUTE": 1}


@pytest.fixture(scope="module")
def worlds():
    made = {}

    def get(n):
        if n not in made:
            made[n] = child.World(n)
        return made[n]

    yield get
    for w in made.values():
        w.close()


@pytest.fixture(autouse=True)
def _fresh_caches():
    import importlib

    rp.clear_plan_cache()
    ref_rp.clear_plan_cache()
    importlib.import_module("vescale_tpu.redistribute")._warned_pairs.clear()
    yield
    rp.clear_plan_cache()
    ref_rp.clear_plan_cache()


def _port(p):
    return child.dec(enc(p), pl)


def _specs(mesh_shape, names, src, dst, shape, dtype=np.float32, dst_mesh=None):
    """(reference src, reference dst, port src, port dst) specs."""
    rm = vt.DeviceMesh(tuple(names), tuple(mesh_shape))
    pm = DeviceMesh(tuple(names), tuple(mesh_shape), device_type="cpu")
    rdm, pdm = rm, pm
    if dst_mesh is not None:
        rdm = vt.DeviceMesh(tuple(dst_mesh[1]), tuple(dst_mesh[0]))
        pdm = DeviceMesh(tuple(dst_mesh[1]), tuple(dst_mesh[0]), device_type="cpu")
    rmeta = RefMeta(tuple(shape), jnp.dtype(dtype))
    pmeta = TensorMeta(tuple(shape), torch.from_numpy(np.zeros(0, dtype)).dtype)
    return (RefSpec(rm, list(src), rmeta), RefSpec(rdm, list(dst), rmeta),
            DArraySpec(pm, [_port(p) for p in src], pmeta),
            DArraySpec(pdm, [_port(p) for p in dst], pmeta))


def _sig(plan):
    """A plan as (kind, destination placements, bytes, cost) per hop."""
    if plan is None:
        return None
    return [(h.kind, [enc(p) for p in h.dst.placements], h.bytes_moved, round(h.cost, 6))
            for h in plan.hops]


def _child_sig(hops):
    return None if hops is None else [(h["kind"], h["dst"], h["bytes"], round(h["cost"], 6))
                                      for h in hops]


def _ref_result(mesh_shape, names, src, dst, shape, seed, kind, partial_locals, dst_mesh=None):
    m = vt.DeviceMesh(tuple(names), tuple(mesh_shape))
    if partial_locals:
        locs = [child.local_operand(mesh_shape, [enc(p) for p in src], shape, seed, kind, r)
                for r in range(m.size())]
        d = vt.from_local(locs, m, list(src), shape=tuple(shape))
    else:
        d = vt.distribute_tensor(make_input(shape, seed, kind), m, list(src))
    target = vt.DeviceMesh(tuple(dst_mesh[1]), tuple(dst_mesh[0])) if dst_mesh else None
    return d.redistribute(target, list(dst))


def _run(worlds, mesh_shape, names, src, dst, shape, seed=0, kind="normal", partial_locals=False,
         dst_mesh=None, env=STRICT, direct=False, check_pieces=True):
    """The port's transition in a gloo world: every rank's full tensor (and
    piece, unless a Partial survives) exactly the reference's."""
    n = int(np.prod(mesh_shape))
    res = worlds(n).run("plan", mesh_shape=list(mesh_shape), names=list(names),
                        src=[enc(p) for p in src], dst=[enc(p) for p in dst], shape=list(shape),
                        seed=seed, kind=kind, partial_locals=partial_locals,
                        dst_mesh=[list(dst_mesh[0]), list(dst_mesh[1])] if dst_mesh else None,
                        env=env, direct=direct)
    out = _ref_result(mesh_shape, names, src, dst, shape, seed, kind, partial_locals, dst_mesh)
    golden = np.asarray(out.full_tensor())
    pieces = check_pieces and not any(p.is_partial() for p in dst)
    for r, got in enumerate(res):
        assert "raised" not in got
        np.testing.assert_array_equal(got["full"], golden, err_msg=f"rank {r}: {src} -> {dst}")
        if pieces:
            np.testing.assert_array_equal(got["local"], np.asarray(out.to_local(rank=r)),
                                          err_msg=f"rank {r} piece: {src} -> {dst}")
        assert got["repeat_equal"]
    return res


# ------------------------------------------------------- the plans
PLAN_MESHES = [((2, 4), ("dp", "tp"), (8, 8)), ((2, 4), ("dp", "tp"), (7, 12)),
               ((2, 2), ("dp", "tp"), (8, 6))]
PLAN_CANDS = [R(), S(0), S(1), P(), P("max"), IS(0, 2)]


@pytest.mark.parametrize("mesh_shape,names,shape", PLAN_MESHES)
def test_plans_are_the_references_on_the_lattice(mesh_shape, names, shape):
    """Every pair of two-mesh-dim placements over {R, S(0), S(1), P(sum),
    P(max), IS(0,2)}: the port's plan (or decline, with its code) equals
    the reference's hop for hop, byte for byte and cost for cost, and every
    intermediate's per-shard bytes are the reference's."""
    n = 0
    for src in itertools.product(PLAN_CANDS, repeat=2):
        for dst in itertools.product(PLAN_CANDS, repeat=2):
            try:
                rs, rd, ps, pd = _specs(mesh_shape, names, src, dst, shape)
                rs.layout(), rd.layout()
            except ValueError:
                continue
            a, b = ref_rp.plan_redistribute(rs, rd), rp.plan_redistribute(ps, pd)
            assert _sig(b) == _sig(a), (src, dst)
            if a is None:
                assert rp.decline_finding(ps, pd).code == ref_rp.decline_finding(rs, rd).code
            assert rp.physical_shard_bytes(ps) == rs.per_shard_bytes()
            n += 1
    assert n > 600


def test_ragged_and_interleaved_plans_are_the_references():
    """Ragged and strided-ragged pairs on (8,) and (2, 4), and interleave
    changes on one and two mesh dims."""
    rag = [RS((0,), (1, 2, 1, 2, 1, 3, 3, 3)), RS((0,), (3, 3, 3, 1, 2, 1, 2, 1)), R(), S(0)]
    for src, dst in itertools.product(rag, repeat=2):
        rs, rd, ps, pd = _specs((8,), ("x",), [src], [dst], (64,))
        assert _sig(rp.plan_redistribute(ps, pd)) == _sig(ref_rp.plan_redistribute(rs, rd))
    strided = [[S(0), SRS((0,), (1, 2, 3, 2), split_factor=2)],
               [S(0), SRS((0,), (2, 3, 2, 1), split_factor=2)], [R(), R()], [S(0), R()]]
    for src, dst in itertools.product(strided, repeat=2):
        rs, rd, ps, pd = _specs((2, 4), ("tp", "fsdp"), src, dst, (64,))
        assert _sig(rp.plan_redistribute(ps, pd)) == _sig(ref_rp.plan_redistribute(rs, rd))
    inter = [IS(0, 2), IS(0, 4), S(0), R(), IS(1, 2), S(1)]
    for src in itertools.product(inter, repeat=2):
        for dst in itertools.product(inter, repeat=2):
            try:
                rs, rd, ps, pd = _specs((2, 4), ("dp", "tp"), src, dst, (16, 8))
                rs.layout(), rd.layout()
            except ValueError:
                continue
            assert _sig(rp.plan_redistribute(ps, pd)) == _sig(ref_rp.plan_redistribute(rs, rd)), \
                (src, dst)


def test_edges_are_the_references():
    """The single-hop edge of every pair above: same kind, bytes and cost
    as the reference's ``_edge``, and the dense edge exactly where the
    reference's ``_plan_ops`` accepts the pair."""
    from vescale_tpu import transfer as ref_transfer

    for src in itertools.product(PLAN_CANDS, repeat=2):
        for dst in itertools.product(PLAN_CANDS, repeat=2):
            try:
                rs, rd, ps, pd = _specs((2, 4), ("dp", "tp"), src, dst, (7, 12))
                rs.layout(), rd.layout()
            except ValueError:
                continue
            a, b = ref_rp._edge(rs, rd), rp._edge(ps, pd)
            assert (a is None) == (b is None), (src, dst)
            if a is not None:
                assert (b.kind, b.bytes_moved, b.cost, b.collectives) == \
                    (a.kind, a.bytes_moved, a.cost, a.collectives), (src, dst)
            assert transfer._plan_ops(ps, pd) == ref_transfer._plan_ops(rs, rd)


# ------------------------------------------- acceptance: planning
def test_axis_swap_plans_within_three_hops(worlds):
    """[Shard(0), Shard(1)] -> [Shard(1), Shard(0)], the axis-swap cycle no
    single hop serves: planned in <=3 per-shard hops (the reference's),
    strict-safe, every piece exact, no fallback."""
    src, dst = [S(0), S(1)], [S(1), S(0)]
    rs, rd, ps, pd = _specs((2, 4), ("dp", "tp"), src, dst, (7, 12))
    assert transfer._plan_ops(ps, pd) is None
    res = _run(worlds, (2, 4), ("dp", "tp"), src, dst, (7, 12))
    want = _sig(ref_rp.plan_redistribute(rs, rd))
    for got in res:
        assert got["tier"] == "planned" and got["counts"]["redistribute.fallbacks"] == 0
        assert _child_sig(got["hops"]) == want and 1 <= len(want) <= 3


def test_partial_cross_dim_shard_plans(worlds):
    """Partial composed with cross-dim Shard moves: the reference plans
    each in <=3 hops; the port's single hop serves them in one pass (a
    ROADMAP.md section C departure), and the planner asked directly gives
    the reference's plan, whose run is exact too."""
    for src, dst in [([P(), S(0)], [S(0), P()]), ([S(0), R()], [P(), S(0)]),
                     ([P("max"), R()], [P("sum"), R()])]:
        rs, rd, ps, pd = _specs((2, 4), ("dp", "tp"), src, dst, (8, 8))
        assert transfer._plan_ops(ps, pd) is None
        partial = any(p.is_partial() for p in src)
        kind = "int" if partial else "normal"
        res = _run(worlds, (2, 4), ("dp", "tp"), src, dst, (8, 8), kind=kind,
                   partial_locals=partial)
        assert all(r["tier"] == "kernel" and r["counts"]["redistribute.fallbacks"] == 0
                   for r in res)
        want = _sig(ref_rp.plan_redistribute(rs, rd))
        assert want is not None and len(want) <= 3
        res = _run(worlds, (2, 4), ("dp", "tp"), src, dst, (8, 8), kind=kind,
                   partial_locals=partial, direct=True)
        assert all(_child_sig(r["hops"]) == want for r in res)


def test_multi_dim_interleave_change_plans(worlds):
    """Interleaves changing on both mesh dims: the reference plans two
    interleaved hops; the port's single hop serves the pair (section C),
    and the planner's own two-hop plan runs to the same pieces."""
    src, dst = [IS(0, 2), IS(1, 2)], [R(), S(1)]
    rs, rd, ps, pd = _specs((2, 4), ("dp", "tp"), src, dst, (8, 8))
    want = _sig(ref_rp.plan_redistribute(rs, rd))
    assert [h[0] for h in want] == ["interleaved", "interleaved"]
    assert _sig(rp.plan_redistribute(ps, pd)) == want
    res = _run(worlds, (2, 4), ("dp", "tp"), src, dst, (8, 8))
    assert all(r["tier"] == "kernel" and not r["warned"] for r in res)
    res = _run(worlds, (2, 4), ("dp", "tp"), src, dst, (8, 8), direct=True)
    assert all(_child_sig(r["hops"]) == want for r in res)


def test_plan_cache_hit_no_replan_no_retrace(worlds):
    """A repeated transition is a cache hit: one miss, then hits, the same
    plan object, hops counted each run, the bytes the summary reports."""
    res = _run(worlds, (2, 4), ("dp", "tp"), [S(0), S(1)], [S(1), S(0)], (7, 12), env={})
    for got in res:
        c = got["counts"]
        assert c["redistribute.plan_misses"] == 1 and c["redistribute.plan_hits"] == 1
        assert c["redistribute.hops"] == 2 * len(got["hops"])
    rs, rd, ps, pd = _specs((2, 4), ("dp", "tp"), [S(0), S(1)], [S(1), S(0)], (7, 12))
    p1 = rp.plan_redistribute(ps, pd)
    assert rp.plan_redistribute(ps, pd) is p1
    assert rp.plan_comm_summary(p1)["bytes_moved"] == p1.bytes_moved == \
        ref_rp.plan_redistribute(rs, rd).bytes_moved
    assert rp.plan_cache_stats() == {"plans": 1, "declines": 0, "quant_declines": 0}


def test_planner_memory_budget_and_env_knob(worlds):
    """A skewed ragged -> Shard(0) move's only bridge is full replication,
    above the default budget: declined (VSC120), through the fallback with
    its warning and counter.  VESCALE_REDISTRIBUTE_MEM_FACTOR=16 plans it
    (all-gather-v, then a slice) with no fallback."""
    src, dst = [RS((0,), (1, 2, 1, 2, 1, 3, 3, 3))], [S(0)]
    res = _run(worlds, (8,), ("x",), src, dst, (64,), env={})
    for got in res:  # two runs: two fallbacks, one warning for the pair
        assert got["counts"]["redistribute.fallbacks"] == 2 and got["tier"] == "fallback"
        assert len(got["warned"]) == 1 and "[VSC120]" in got["warned"][0] and "memory budget" in got["decline"]
    res = _run(worlds, (8,), ("x",), src, dst, (64,),
               env={"VESCALE_REDISTRIBUTE_MEM_FACTOR": 16, **STRICT})
    rs, rd, ps, pd = _specs((8,), ("x",), src, dst, (64,))
    import os

    os.environ["VESCALE_REDISTRIBUTE_MEM_FACTOR"] = "16"
    try:
        want = _sig(ref_rp.plan_redistribute(rs, rd))
    finally:
        os.environ.pop("VESCALE_REDISTRIBUTE_MEM_FACTOR")
    assert len(want) == 2
    for got in res:
        assert got["counts"]["redistribute.fallbacks"] == 0 and not got["warned"]
        assert got["tier"] == "planned" and _child_sig(got["hops"]) == want


def test_intermediates_respect_budget():
    """Every intermediate of a plan stays within the budget."""
    _rs, _rd, ps, pd = _specs((2, 4), ("dp", "tp"), [S(0), S(1)], [S(1), S(0)], (7, 12))
    plan = rp.plan_redistribute(ps, pd)
    cap = rp._mem_factor() * max(rp.physical_shard_bytes(ps), rp.physical_shard_bytes(pd))
    for hop in plan.hops[:-1]:
        assert rp.physical_shard_bytes(hop.dst) <= cap, hop.dst


def test_cross_mesh_planned_with_bridge(worlds):
    """(2, 4) [Partial, IS(0, 2)] -> (8,) [Shard(0)]: strip, the device_put
    bridge (one all-to-all-v over every rank), dress; strict-safe, exact,
    the reference's plan."""
    src, dst, dm = [P(), IS(0, 2)], [S(0)], ((8,), ("tp8",))
    rs, rd, ps, pd = _specs((2, 4), ("dp", "tp"), src, dst, (64, 4), dst_mesh=dm)
    want = _sig(ref_rp.plan_redistribute(rs, rd))
    assert any(h[0] == "device_put" for h in want)
    res = _run(worlds, (2, 4), ("dp", "tp"), src, dst, (64, 4), kind="int", partial_locals=True,
               dst_mesh=dm)
    for got in res:
        assert got["tier"] == "planned" and got["counts"]["redistribute.fallbacks"] == 0
        assert _child_sig(got["hops"]) == want


def test_plan_ops_none_branches_resolve_or_raise(worlds):
    """Every reachable ``return None`` of ``_plan_ops``: cross-mesh,
    interleaved, nested (even), Partial -> other Partial, Shard -> Partial,
    the axis-swap cycle: each resolves exactly under strict mode.  The
    padded nested destination the reference cannot serve per shard (strict
    raises there) is one all-to-all here: the port's single hop exchanges
    the pieces (section C)."""
    cases = [
        ([S(0), S(1)], [S(0)], (8, 8), ((8,), ("x",)), False),
        ([IS(0, 2), S(1)], [S(0), S(1)], (8, 8), None, False),
        ([S(0), S(1)], [S(0), S(0)], (8, 8), None, False),
        ([P("max"), R()], [P("sum"), R()], (8, 8), None, True),
        ([S(0), R()], [P(), S(0)], (8, 8), None, False),
        ([S(0), S(1)], [S(1), S(0)], (7, 12), None, False),
        ([S(0), S(1)], [S(0), S(0)], (7, 12), None, False),
    ]
    for src, dst, shape, dm, partial in cases:
        rs, rd, ps, pd = _specs((2, 4), ("dp", "tp"), src, dst, shape, dst_mesh=dm)
        assert transfer._plan_ops(ps, pd) is None, (src, dst)
        res = _run(worlds, (2, 4), ("dp", "tp"), src, dst, shape, kind="int" if partial else
                   "normal", partial_locals=partial, dst_mesh=dm)
        assert all(r["counts"]["redistribute.fallbacks"] == 0 for r in res), (src, dst)
    rs, rd, ps, pd = _specs((2, 4), ("dp", "tp"), [S(0), S(1)], [S(0), S(0)], (7, 12))
    assert ref_rp.plan_redistribute(rs, rd) is None and rp.plan_redistribute(ps, pd) is None
    assert rp.decline_finding(ps, pd).code == ref_rp.decline_finding(rs, rd).code


def test_former_fallback_battery_emits_no_warnings(worlds):
    """The reference's former-fallback battery: no warning, no fallback,
    every result exact."""
    battery = [
        ([S(0), S(1)], [S(1), S(0)], (7, 12), False),
        ([P(), S(0)], [S(0), P()], (8, 8), True),
        ([S(0), R()], [P(), S(0)], (8, 8), False),
        ([IS(0, 2), IS(1, 2)], [R(), S(1)], (8, 8), False),
    ]
    for src, dst, shape, partial in battery:
        res = _run(worlds, (2, 4), ("dp", "tp"), src, dst, shape, env={},
                   kind="int" if partial else "normal", partial_locals=partial)
        assert all(not r["warned"] and r["counts"]["redistribute.fallbacks"] == 0 for r in res)


@pytest.mark.parametrize("src,dst,shape", [
    ([S(0), S(1)], [S(1), S(0)], (8, 12)),
    ([S(1), R()], [R(), S(0)], (16, 12)),
])
def test_battery_on_a_world_of_four(worlds, src, dst, shape):
    """The same planner on a (2, 2) mesh of four ranks."""
    rs, rd, ps, pd = _specs((2, 2), ("dp", "tp"), src, dst, shape)
    want = _sig(ref_rp.plan_redistribute(rs, rd))
    res = _run(worlds, (2, 2), ("dp", "tp"), src, dst, shape, direct=want is not None)
    for got in res:
        assert got["counts"]["redistribute.fallbacks"] == 0
        if want is not None:
            assert _child_sig(got["hops"]) == want


# ------------------------------------------------ comm_mode attribution
def test_comm_mode_attributes_plan_hops(worlds):
    """``attribute_plan(compiled=True)`` runs each hop and attaches what it
    issued: every collective kind the static view names was issued, the
    region's counts are the ``collectives.CALLS`` delta, the bytes the
    plan's, and the result exact."""
    res = worlds(8).run("plan_comm", mesh_shape=[2, 4], names=["dp", "tp"],
                        src=[enc(S(0)), enc(S(1))], dst=[enc(S(1)), enc(S(0))], shape=[7, 12],
                        seed=4)
    golden = make_input((7, 12), 4)
    for got in res:
        s = got["summary"]
        assert s["n_hops"] == len(s["hops"]) and s["bytes_moved"] == got["bytes_moved"] > 0
        assert got["calls"] == got["delta"]
        dense = [h for h in s["hops"] if h["kind"] == "dense"]
        assert dense
        for h in dense:
            for kind in h["collectives"]:
                assert h["hlo_collectives"].get(kind, 0) >= 1, h
        np.testing.assert_array_equal(got["full"], golden)


# ------------------------------------------------ checkpoint planner reuse
def test_plain_load_spec_scope():
    from vescale_tpu_torch.checkpoint.reshard import plain_load_spec

    mesh = DeviceMesh(("dp", "tp"), (2, 4), device_type="cpu")
    meta = TensorMeta((8, 8), torch.float32)
    spec = DArraySpec(mesh, [pl.Shard(0), pl.InterleavedShard(1, 2)], meta)
    mid = plain_load_spec(spec)
    assert mid is not None and mid.placements == (pl.Shard(0), pl.Shard(1))
    assert rp.can_redistribute_per_shard(mid, spec)
    assert plain_load_spec(DArraySpec(mesh, [pl.Shard(0), pl.Shard(1)], meta)) is None
    assert plain_load_spec(DArraySpec(mesh, [pl.Partial(), pl.InterleavedShard(1, 2)], meta)) is None


# ----------------------------------------------------- the int8 overlay
@pytest.mark.parametrize("rounding,key_seed", [("nearest", None), ("stochastic", 7)])
def test_quant_transition_is_all_reduce_q_bitwise(worlds, rounding, key_seed):
    """The int8 Partial -> Replicate transition on four ranks is bitwise
    ``all_reduce_q`` (the same block, rounding and key), and the overlay
    under VESCALE_REDISTRIBUTE_QUANT=1 takes a one-hop quant plan whose
    result is the reference's quantized redistribute bitwise."""
    import os

    res = worlds(4).run("plan_quant", mesh_shape=[4], names=["dp"], src=[enc(P())],
                        dst=[enc(R())], shape=[256, 64], seed=11, rounding=rounding,
                        key_seed=key_seed)
    for got in res:
        np.testing.assert_array_equal(got["local"], got["all_reduce_q"])
        assert [h["kind"] for h in got["overlay_hops"] or []] in ([], ["quant"])
    m = vt.DeviceMesh(("dp",), (4,))
    locs = [child.local_operand([4], [enc(P())], (256, 64), 11, "normal", r) for r in range(4)]
    os.environ["VESCALE_REDISTRIBUTE_QUANT"] = "1"
    try:
        ref_rp.clear_plan_cache()
        spec_r = RefSpec(m, [P()], RefMeta((256, 64), jnp.dtype(jnp.float32)))
        taken = ref_rp.quant_single_hop_plan(spec_r, spec_r.with_placements((R(),)))
        out = vt.from_local(locs, m, [P()], shape=(256, 64)).redistribute(placements=[R()])
    finally:
        os.environ.pop("VESCALE_REDISTRIBUTE_QUANT")
        ref_rp.clear_plan_cache()
    assert (taken is not None) == (res[0]["overlay_hops"] is not None)
    if rounding == "nearest":
        for r, got in enumerate(res):
            np.testing.assert_array_equal(got["overlay"], np.asarray(out.to_local(rank=r)))


@pytest.fixture
def quant_gate(monkeypatch):
    monkeypatch.setenv("VESCALE_REDISTRIBUTE_QUANT", "1")
    rp.clear_plan_cache()
    ref_rp.clear_plan_cache()
    yield
    rp.clear_plan_cache()
    ref_rp.clear_plan_cache()


def _pr_specs(n, dtype=np.float32, shape=(4096, 64)):
    return _specs((n,), ("dp",), [P()], [R()], shape, dtype)


def test_quant_hop_taken_where_cost_model_wins(quant_gate):
    rs, rd, ps, pd = _pr_specs(2)
    verdict, hop = rp.quant_outcome(ps, pd)
    assert verdict == "taken" and hop.collectives == {"all_reduce:int8": 1}
    assert hop.bytes_moved < hop.bytes_raw / 3.5
    ref_hop = ref_rp.quant_outcome(rs, rd)[1]
    assert (hop.bytes_moved, hop.bytes_raw, hop.cost) == \
        (ref_hop.bytes_moved, ref_hop.bytes_raw, ref_hop.cost)
    plan = rp.quant_single_hop_plan(ps, pd)
    assert plan is not None and plan.hops[0].kind == "quant"


def test_quant_structured_decline_where_it_loses(quant_gate):
    rs, rd, ps, pd = _pr_specs(8)
    verdict, decline = rp.quant_outcome(ps, pd)
    assert verdict == "declined" and decline.code == "VSC127" and "cost model" in decline.message
    assert decline.message == ref_rp.quant_outcome(rs, rd)[1].message
    assert rp.quant_decline_finding(ps, pd).code == "VSC127"


def test_quant_decline_on_unquantizable_dtype(quant_gate):
    _rs, _rd, ps, pd = _pr_specs(2, np.int32)
    verdict, decline = rp.quant_outcome(ps, pd)
    assert verdict == "declined" and decline.code == "VSC127"
    assert "no quantizable" in decline.message
    assert rp.plan_cache_stats()["quant_declines"] >= 1


def test_quant_gate_off_is_inert():
    _rs, _rd, ps, pd = _pr_specs(2)
    assert rp.quant_outcome(ps, pd) is None and rp.quant_single_hop_plan(ps, pd) is None


def test_quant_multi_hop_plan_can_carry_quant_edge(quant_gate):
    """A composite pair under the gate plans, as the reference's does."""
    src, dst = [P(), S(1)], [S(0), R()]
    rs, rd, ps, pd = _specs((2, 4), ("dp", "tp"), src, dst, (512, 64))
    assert _sig(rp.plan_redistribute(ps, pd)) == _sig(ref_rp.plan_redistribute(rs, rd))
    assert rp.plan_redistribute(ps, pd) is not None


def test_quant_plan_info_is_the_references():
    """Byte accounting of the int8 transition, term for term."""
    from vescale_tpu import transfer as ref_transfer

    for src, dst, shape in [([P(), R()], [R(), R()], (64, 32)), ([P(), S(1)], [S(0), R()], (64, 32)),
                            ([S(0), R()], [R(), R()], (63, 32)), ([S(0), R()], [S(1), R()], (64, 32)),
                            ([P(), R()], [S(0), R()], (64, 32))]:
        rs, rd, ps, pd = _specs((2, 4), ("dp", "tp"), src, dst, shape)
        assert transfer.quant_plan_info(ps, pd, 64) == ref_transfer.quant_plan_info(rs, rd, 64)
