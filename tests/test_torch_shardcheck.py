"""The port's shardcheck (``vescale_tpu_torch/analysis``) on the reference's
test programs, held to the codes the reference's shardcheck emits.

Mirrors ``tests/test_analysis.py:188-489`` and ``:613-705`` but the lint
and env-registry tests (the port has neither: ROADMAP.md section A).  Each
program is written twice, in ``jax.numpy`` and in torch, on the same
shapes and input shardings; the reference's report and the port's carry
the same set of codes (exact), and where the reference prices a finding
the port's bytes are the same.  The decline codes VSC120-126 come from the
same planner pairs, the transition findings from the same specs.
"""

import textwrap
import warnings

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

import vescale_tpu as vt
from vescale_tpu import analysis as ref_an
from vescale_tpu import redistribute_plan as ref_rp
from vescale_tpu.placements import Partial as RP_, RaggedShard as RRS, Replicate as RR, Shard as RS_
from vescale_tpu.spec import DArraySpec as RefSpec, TensorMeta as RefMeta

from vescale_tpu_torch import analysis
from vescale_tpu_torch import redistribute_plan as rp
from vescale_tpu_torch.analysis import (
    Severity,
    ShardcheckError,
    SymSharding,
    check_param_plan,
    check_stage_boundaries,
    check_transition,
    shardcheck,
)
from vescale_tpu_torch.mesh import DeviceMesh
from vescale_tpu_torch.placements import InterleavedShard, Partial, RaggedShard, Replicate, Shard
from vescale_tpu_torch.spec import DArraySpec, TensorMeta

AX = {"dp": 2, "tp": 4}
of = SymSharding.of


@pytest.fixture(autouse=True)
def _fresh():
    rp.clear_plan_cache()
    ref_rp.clear_plan_cache()
    yield
    rp.clear_plan_cache()
    ref_rp.clear_plan_cache()


def _spec(mesh, placements, shape, dtype=torch.float32):
    return DArraySpec(mesh, placements, TensorMeta(tuple(shape), dtype))


def _rspec(mesh, placements, shape):
    return RefSpec(mesh, placements, RefMeta(tuple(shape), jnp.dtype(jnp.float32)))


@pytest.fixture
def mesh2d():
    return DeviceMesh(("dp", "tp"), (2, 4), device_type="cpu")


@pytest.fixture
def mesh8():
    return DeviceMesh(("x",), (8,), device_type="cpu")


def _both(jfn, tfn, shapes, jspecs, tspecs, **kw):
    """(reference report, port report) of one program on the same shapes."""
    jargs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    targs = [torch.zeros(s) for s in shapes]
    ref = ref_an.shardcheck(jfn, *jargs, in_specs=jspecs, mesh=AX, min_bytes=0,
                            check_source=False, **kw)
    port = shardcheck(tfn, *targs, in_specs=tspecs, mesh=AX, min_bytes=0, check_source=False,
                      **kw)
    return ref, port


def test_shardcheck_flags_materializing_reshape():
    ref, rep = _both(lambda a: jnp.reshape(a, (64 * 512,)), lambda a: a.reshape(64 * 512),
                     [(64, 512)], [P(None, "tp")], [of(None, "tp")])
    f = rep.by_code("VSC101")
    assert rep.codes() == ref.codes() == ["VSC101"]
    assert f[0].mesh_dim == "tp" and f[0].bytes_est == 64 * 512 * 4 == ref.by_code("VSC101")[0].bytes_est
    assert f[0].cost_us and f[0].cost_us > 0  # priced by collectives.py
    assert not rep.ok()


def test_shardcheck_clean_program_is_clean():
    ref, rep = _both(lambda a: jnp.mean(jnp.tanh(a) * 2.0, axis=1),
                     lambda a: (torch.tanh(a) * 2.0).mean(dim=1),
                     [(64, 512)], [P("dp", None)], [of("dp", None)])
    assert rep.ok(strict=True) and ref.ok(strict=True), rep.format()
    assert rep.codes() == ref.codes() == []


def test_shardcheck_sharding_preserving_reshape_is_clean():
    ref, rep = _both(lambda a: jnp.reshape(a, (64, 8, 64)), lambda a: a.reshape(64, 8, 64),
                     [(64, 512)], [P("dp", None)], [of("dp", None)])
    assert rep.ok(strict=True), rep.format()
    assert rep.codes() == ref.codes()


def test_shardcheck_flags_concat_along_sharded_dim():
    ref, rep = _both(lambda a: jnp.concatenate([a, a], axis=1), lambda a: torch.cat([a, a], 1),
                     [(64, 512)], [P(None, "tp")], [of(None, "tp")])
    assert rep.by_code("VSC101") and rep.codes() == ref.codes()


def test_shardcheck_flags_elementwise_sharding_conflict():
    ref, rep = _both(lambda a, b: a + b, lambda a, b: a + b, [(64, 512), (64, 512)],
                     [P("dp", None), P("tp", None)], [of("dp", None), of("tp", None)])
    assert rep.by_code("VSC102") and rep.codes() == ref.codes()


def test_shardcheck_partial_consumed_by_nonlinear_op(mesh2d):
    rmesh = vt.DeviceMesh(("dp", "tp"), (2, 4))
    spec = _spec(mesh2d, [Replicate(), Partial()], (64, 64))
    rspec = _rspec(rmesh, [RR(), RP_()], (64, 64))
    ref, rep = _both(jnp.exp, torch.exp, [(64, 64)], [rspec], [spec])
    f = rep.by_code("VSC103")
    assert f and f[0].mesh_dim == "tp" and rep.codes() == ref.codes()
    ref2, rep2 = _both(lambda a: (a * 2.0) + a, lambda a: (a * 2.0) + a, [(64, 64)], [rspec],
                       [spec])
    assert not rep2.by_code("VSC103") and rep2.codes() == ref2.codes(), rep2.format()


def test_shardcheck_dot_general_derived_partial_is_gspmd_business(mesh2d):
    """A contraction over a tp-sharded dim derives a partial the
    partitioner reduces: tanh(x @ y) is clean.  A declared Partial input
    through the same product is the caller's reduction: VSC103."""
    ref, rep = _both(lambda x, y: jnp.tanh(x @ y), lambda x, y: torch.tanh(x @ y),
                     [(8, 512), (512, 128)], [P(None, "tp"), P("tp", None)],
                     [of(None, "tp"), of("tp", None)])
    assert rep.ok(strict=True) and rep.codes() == ref.codes(), rep.format()
    rmesh = vt.DeviceMesh(("dp", "tp"), (2, 4))
    ref2, rep2 = _both(lambda x, y: jnp.tanh(x @ y), lambda x, y: torch.tanh(x @ y),
                       [(8, 512), (512, 128)], [_rspec(rmesh, [RR(), RP_()], (8, 512)), P()],
                       [_spec(mesh2d, [Replicate(), Partial()], (8, 512)), None])
    assert rep2.by_code("VSC103") and rep2.codes() == ref2.codes()


def test_shardcheck_donation_miss():
    """A functional step returning a new same-shape parameter misses the
    donation unless the caller donates it; the same step updating the
    parameter in place aliases it and has nothing to find."""
    params = torch.zeros((1024, 512))
    grads = torch.zeros((1024, 512), dtype=torch.bfloat16)

    def step(p, g):
        return p - 0.1 * g.to(p.dtype), g.float().sum()

    rep = shardcheck(step, params, grads, check_source=False)
    ref = ref_an.shardcheck(lambda p, g: (p - 0.1 * g.astype(p.dtype), jnp.sum(g)),
                            jnp.zeros((1024, 512)), jnp.zeros((1024, 512), jnp.bfloat16),
                            check_source=False)
    f = rep.by_code("VSC105")
    assert f and f[0].severity == Severity.WARNING and rep.codes() == ref.codes()
    assert f[0].bytes_est == 1024 * 512 * 4
    assert not shardcheck(step, params, grads, donate_argnums=(0,),
                          check_source=False).by_code("VSC105")

    def in_place(p, g):
        p.sub_(0.1 * g.to(p.dtype))
        return p, g.float().sum()

    assert not shardcheck(in_place, params, grads, check_source=False).by_code("VSC105")
    assert torch.count_nonzero(params) == 0  # the trace ran on meta copies


def test_shardcheck_in_place_train_step_has_nothing_to_find():
    """The port's train step updates its state in place: shardcheck of its
    functional form (``FunctionalStep``'s signature, parameters and
    optimizer state in and out) finds no donation miss."""
    def fstep(params, opt_state, g):
        for k in params:
            opt_state[k].mul_(0.9).add_(g[k].float())
            params[k].sub_(1e-3 * opt_state[k])
        return params, opt_state, sum(v.float().sum() for v in g.values())

    p = {"w": torch.zeros(1024, 512), "b": torch.zeros(512)}
    s = {"w": torch.zeros(1024, 512), "b": torch.zeros(512)}
    # bf16 grads: dtype-distinct from the fp32 state, as in the reference's test
    g = {"w": torch.ones(1024, 512, dtype=torch.bfloat16), "b": torch.ones(512, dtype=torch.bfloat16)}
    rep = shardcheck(fstep, p, s, g, check_source=False)
    assert not rep.by_code("VSC105"), rep.format()

    def functional(params, opt_state, g):
        m = {k: 0.9 * opt_state[k] + g[k].float() for k in params}
        return {k: params[k] - 1e-3 * m[k] for k in params}, m, 0

    assert shardcheck(functional, p, s, g, check_source=False).by_code("VSC105")
    assert not shardcheck(functional, p, s, g, donate_argnums=(0, 1),
                          check_source=False).by_code("VSC105")


def test_shardcheck_recurses_into_scan():
    """The reference walks a scan's body; torch traces the loop unrolled,
    so each step's flatten is in the graph."""
    def jloop(a):
        def body(carry, _):
            return jnp.reshape(jnp.reshape(carry, (64 * 512,)), (64, 512)), ()

        out, _ = jax.lax.scan(body, a, jnp.arange(3))
        return out

    def tloop(a):
        for _ in range(3):
            a = a.reshape(64 * 512).reshape(64, 512)
        return a

    ref, rep = _both(jloop, tloop, [(64, 512)], [P(None, "tp")], [of(None, "tp")])
    assert rep.by_code("VSC101") and rep.codes() == ref.codes()


def test_shardcheck_reads_sharding_constraints():
    """A mid-program constraint introduces the sharding; the flatten after
    it materializes it."""
    import json

    from vescale_tpu_torch.analysis.shardcheck import constraint

    def f(a):
        a = constraint(a, json.dumps([[], ["tp"]]))
        return a.reshape(64 * 512)

    rep = shardcheck(f, torch.zeros(64, 512), mesh=AX, min_bytes=0, check_source=False)
    assert rep.codes() == ["VSC101"]


def test_shardcheck_rank_divergent_collective_in_source(tmp_path):
    mod_path = tmp_path / "divergent_mod.py"
    mod_path.write_text(textwrap.dedent("""
        rank = 0

        def barrier():
            pass

        def program(a):
            if rank == 0:
                barrier()
            return a + 1
    """))
    import importlib.util

    spec_ = importlib.util.spec_from_file_location("divergent_mod", mod_path)
    m = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(m)
    rep = shardcheck(m.program, torch.ones(4), check_source=True)
    assert rep.codes() == ["VSC104"]


def test_shardcheck_untraceable_degrades_to_info():
    rep = shardcheck(lambda a: a.no_such_attr, torch.ones(4), check_source=False)
    assert rep.codes() == ["VSC109"] and rep.ok()


def test_shardcheck_static_argnums_are_honored():
    def f(a, flatten):
        if flatten:
            return a.reshape(64 * 512)
        return a

    rep = shardcheck(f, torch.zeros(64, 512), True, static_argnums=(1,),
                     in_specs=[of(None, "tp")], mesh=AX, min_bytes=0, check_source=False)
    assert rep.by_code("VSC101"), rep.format()
    assert not rep.by_code("VSC109")


# ================================================== decline codes (VSC12x)
def test_decline_budget_emits_vsc120(mesh8):
    src = _spec(mesh8, [RaggedShard((0,), (1, 2, 1, 2, 1, 3, 3, 3))], (64,))
    dst = _spec(mesh8, [Shard(0)], (64,))
    assert rp.plan_redistribute(src, dst) is None
    d = rp.decline_finding(src, dst)
    assert isinstance(d, rp.Decline) and d.code == "VSC120"
    assert "[VSC120]" in rp.decline_reason(src, dst) and "memory budget" in d.message


def test_decline_hop_bound_emits_vsc121(mesh2d, monkeypatch):
    monkeypatch.setenv("VESCALE_REDISTRIBUTE_MAX_HOPS", "0")
    src = _spec(mesh2d, [Shard(0), Shard(1)], (8, 8))
    dst = _spec(mesh2d, [Shard(1), Shard(0)], (8, 8))
    assert rp.plan_redistribute(src, dst) is None
    assert rp.decline_finding(src, dst).code == "VSC121"
    assert "0 hops" in rp.decline_finding(src, dst).message


def test_decline_cross_mesh_no_bridge_emits_vsc122(mesh8):
    other = DeviceMesh(("y",), (8,), device_type="cpu")
    src = _spec(mesh8, [RaggedShard((0,), (1,) * 8)], (64,))
    dst = _spec(other, [Shard(0)], (64,))
    assert rp.plan_redistribute(src, dst) is None
    assert rp.decline_finding(src, dst).code == "VSC122"


def test_decline_cross_mesh_budget_emits_vsc123(mesh8):
    other = DeviceMesh(("y",), (8,), device_type="cpu")
    src = _spec(mesh8, [Shard(0)], (10,))
    dst = _spec(other, [Shard(0)], (10,))
    assert rp.plan_redistribute(src, dst) is None
    assert rp.decline_finding(src, dst).code == "VSC123"


def test_decline_cross_mesh_strip_and_dress_emit_vsc124_125(mesh8, monkeypatch):
    other = DeviceMesh(("y",), (8,), device_type="cpu")
    monkeypatch.setattr(rp, "_search_same_mesh",
                        lambda s, d: (None, rp.Decline("VSC121", "synthetic decline")))
    plan, reason = rp._plan_cross_mesh(_spec(mesh8, [Partial()], (64,)),
                                       _spec(other, [Replicate()], (64,)))
    assert plan is None and reason.code == "VSC124"
    plan, reason = rp._plan_cross_mesh(_spec(mesh8, [Replicate()], (64,)),
                                       _spec(other, [Partial()], (64,)))
    assert plan is None and reason.code == "VSC125"


def test_decline_not_consulted_emits_vsc126(mesh8):
    src = _spec(mesh8, [Shard(0)], (1024,))
    assert rp.decline_finding(src, _spec(mesh8, [Replicate()], (1024,))).code == "VSC126"


def test_warn_fallback_message_carries_the_code():
    """The fallback's warning names the planner's decline (a world of 8)."""
    import torch_spmd_child as child
    from torch_spmd_child import enc

    w = child.World(8)
    try:
        res = w.run("plan", mesh_shape=[8], names=["x"],
                    src=[enc(RRS((0,), (1, 2, 1, 2, 1, 3, 3, 3)))], dst=[enc(RS_(0))],
                    shape=[64], seed=0, env={}, repeats=1)
    finally:
        w.close()
    assert all(len(r["warned"]) == 1 and "[VSC120]" in r["warned"][0] for r in res)
    assert all("through Replicate" in r["warned"][0] for r in res)


# ===================================================== transition findings
def _codes(findings):
    return {f.code.code for f in findings}


def test_check_transition_fallback_yields_vsc106_with_decline(mesh8):
    src = _spec(mesh8, [RaggedShard((0,), (1, 2, 1, 2, 1, 3, 3, 3))], (64,))
    dst = _spec(mesh8, [Shard(0)], (64,))
    findings = check_transition(src, dst)
    rmesh = vt.DeviceMesh(("x",), (8,))
    ref = ref_an.check_transition(_rspec(rmesh, [RRS((0,), (1, 2, 1, 2, 1, 3, 3, 3))], (64,)),
                                  _rspec(rmesh, [RS_(0)], (64,)))
    assert _codes(findings) == _codes(ref) == {"VSC106", "VSC120"}
    assert "[VSC120]" in findings[0].message and findings[0].bytes_est == ref[0].bytes_est


def test_check_transition_planned_yields_costed_info(mesh2d):
    """The reference plans [IS(0,2), IS(1,2)] -> [R, S(1)] (VSC108); the
    port's single hop serves it, so there is nothing to find (ROADMAP.md
    section C).  The axis swap is planned by both: a costed VSC108 with the
    reference's bytes."""
    src = _spec(mesh2d, [InterleavedShard(0, 2), InterleavedShard(1, 2)], (8, 8))
    dst = _spec(mesh2d, [Replicate(), Shard(1)], (8, 8))
    assert check_transition(src, dst) == [] and check_transition(src, src) == []
    src = _spec(mesh2d, [Shard(0), Shard(1)], (7, 12))
    dst = _spec(mesh2d, [Shard(1), Shard(0)], (7, 12))
    findings = check_transition(src, dst)
    rmesh = vt.DeviceMesh(("dp", "tp"), (2, 4))
    ref = ref_an.check_transition(_rspec(rmesh, [RS_(0), RS_(1)], (7, 12)),
                                  _rspec(rmesh, [RS_(1), RS_(0)], (7, 12)))
    assert [f.code.code for f in findings] == [f.code.code for f in ref] == ["VSC108"]
    assert findings[0].severity == Severity.INFO and findings[0].bytes_est == ref[0].bytes_est


def test_check_stage_boundaries(mesh8):
    good = _spec(mesh8, [Shard(0)], (64,))
    bad_out = _spec(mesh8, [RaggedShard((0,), (1, 2, 1, 2, 1, 3, 3, 3))], (64,))
    rep = check_stage_boundaries([good, bad_out], [good, good], labels=["b0", "b1"])
    assert all(f.where != "b0" for f in rep.by_code("VSC106"))
    assert any(f.where == "b1" for f in rep.by_code("VSC106"))


# ====================================================== integration points
class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(4, 4)


def test_dmodule_rejects_partial_param_plan_in_strict(monkeypatch):
    from vescale_tpu_torch.dmodule import parallelize_module

    mesh = DeviceMesh(("dp", "tp"), (1, 1), device_type="cpu")
    monkeypatch.setenv("VESCALE_SHARDCHECK", "strict")
    with pytest.raises(ShardcheckError, match="VSC107"):
        parallelize_module(_Tiny(), mesh, {"parameter": {r".*": [Partial()]}})
    monkeypatch.setenv("VESCALE_SHARDCHECK", "warn")
    with pytest.warns(UserWarning, match="VSC107"):
        try:
            parallelize_module(_Tiny(), mesh, {"parameter": {r".*": [Partial()]}})
        except NotImplementedError:
            pass  # the audit warned before the plan was refused
    monkeypatch.setenv("VESCALE_SHARDCHECK", "off")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        try:
            parallelize_module(_Tiny(), mesh, {"parameter": {r".*": [Partial()]}})
        except NotImplementedError:
            pass
    monkeypatch.setenv("VESCALE_SHARDCHECK", "strict")
    parallelize_module(_Tiny(), mesh, {"parameter": {r".*": [Replicate()]}})


def test_step_report_carries_shardcheck_section(monkeypatch):
    from vescale_tpu_torch.telemetry.step_report import build_step_report

    def f(a):
        return (a * 2).sum()

    monkeypatch.setenv("VESCALE_SHARDCHECK", "warn")
    rep = build_step_report(f, torch.ones(8, 8), name="t")
    assert rep["shardcheck"]["name"] == "t" and rep["shardcheck"]["n_findings"] == 0
    monkeypatch.setenv("VESCALE_SHARDCHECK", "off")
    assert build_step_report(f, torch.ones(8, 8), name="t")["shardcheck"] is None
    # donation: unknown (None, the default) never flags VSC105; donate_argnums=()
    # on a step that rebuilds its buffer does
    monkeypatch.setenv("VESCALE_SHARDCHECK", "warn")
    big = torch.zeros(1024, 512)
    step = lambda p: p * 0.5  # noqa: E731
    assert "VSC105" not in build_step_report(step, big, name="d")["shardcheck"]["codes"]
    assert "VSC105" in build_step_report(step, big, name="u",
                                         donate_argnums=())["shardcheck"]["codes"]


def test_pipeline_plan_boundary_report(mesh8):
    from vescale_tpu_torch.plan import PipelineParallelPlan

    plan = PipelineParallelPlan(
        num_stages=2, stage_out_placements=[[RaggedShard((0,), (1, 2, 1, 2, 1, 3, 3, 3))]],
        stage_in_placements=[[Shard(0)]])
    assert plan.boundary_report(mesh8, (64,)).by_code("VSC106")
    good = PipelineParallelPlan(num_stages=2, stage_out_placements=[[Shard(0)]],
                                stage_in_placements=[[Shard(0)]])
    assert good.boundary_report(mesh8, (64,)).ok(strict=True)
    with pytest.raises(ValueError, match="declared together"):
        PipelineParallelPlan(num_stages=2, stage_out_placements=[[Shard(0)]])


def test_param_plan_check(mesh2d):
    assert check_param_plan({r"dense.*": [Shard(0)]}, mesh2d).ok(strict=True)
    f = check_param_plan({r"dense.*": [Partial()]}, mesh2d).by_code("VSC107")
    assert f and f[0].mesh_dim == "dp"


def test_analysis_mode_helpers(monkeypatch):
    monkeypatch.delenv("VESCALE_SHARDCHECK", raising=False)
    assert analysis.mode() == "warn" and analysis.enabled()
    monkeypatch.setenv("VESCALE_SHARDCHECK", "strict")
    assert analysis.is_strict()
    monkeypatch.setenv("VESCALE_SHARDCHECK", "off")
    assert not analysis.enabled()
    monkeypatch.setenv("VESCALE_SHARDCHECK", "bogus")
    assert analysis.mode() == "warn"


# ============================================ a model under its plan (tp=2)
LLAMA = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)


@pytest.mark.parametrize("flash,rows", [(True, 2), (False, 2), (True, 1)])
def test_llama_plan_is_clean_and_a_bad_plan_is_found(flash, rows):
    """The tiny Llama's forward at tp=2 (traced on ``meta``; 1 row, as the
    1.3B rung's batch, puts a size-1 dim beside the heads): the hand plan
    reports no error, whether attention runs through the flash kernel's
    op or the dense einsums; planting ``o_proj`` column-parallel reports
    VSC101 or VSC102 with a byte estimate."""
    from vescale_tpu_torch.analysis import shardcheck_module
    from vescale_tpu_torch.models import Llama, LlamaConfig, llama_plan

    cfg = LlamaConfig(dtype=torch.float32, use_flash_attention=flash, **LLAMA)
    model = Llama(cfg, device="meta")
    mesh = DeviceMesh(("tp",), (2,), device_type="cpu")
    tokens = torch.zeros((rows, 32), dtype=torch.long)
    good = shardcheck_module(model, llama_plan(mesh), mesh, tokens, min_bytes=0)
    assert good.ok(), good.format()
    assert not good.by_code("VSC109")
    bad_plan = llama_plan(mesh)
    key = next(k for k in bad_plan["parameter"] if "o_proj" in k)
    bad_plan["parameter"][key] = [Shard(1)]
    bad = shardcheck_module(model, bad_plan, mesh, tokens, min_bytes=0)
    found = bad.by_code("VSC101") + bad.by_code("VSC102")
    assert found and all(f.bytes_est for f in found), bad.format()


@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_shardcheck_of_a_live_dmodule_is_its_plan_on_the_plain_module(kind):
    """A parallelized module is checked as its plain module (on ``meta``,
    at the global shapes) under its own plan and mesh: the same report as
    the plain module under that plan, clean, and the DModule untouched."""
    import torch_spmd_child as child

    w = child.World(2)
    try:
        res = w.run("shardcheck_dmodule", kind=kind, tp=2, seed=0)
    finally:
        w.close()
    for got in res:
        assert got["codes"] == got["plain_codes"] and got["n"] == 0
        assert got["logits_finite"]
