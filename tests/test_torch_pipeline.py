"""The port's pipeline (A15) against the JAX package, on the CPU: the plan,
every schedule generator, the simulator and the cost-driven zero bubble,
the stage split, and the eager ``PipeEngine`` on the reference's small
``GPTConfig`` (tests/test_pipeline.py's ``CFG``), with each group's
weights carried across from the reference's ``init_all`` by
``params_from_jax`` and tokens from a numpy seed.

Held:

  * every generator (GPipe, 1F1B, interleaved, zero bubble, the greedy
    and cost-driven zero bubble at V=1 and 2, under a memory cap) gives the
    reference's instruction lists exactly, ``simulate_schedule`` its
    makespans exactly, and both raise where it raises;
  * ``estimate_stage_costs`` under one calibration table picks the
    reference's schedule;
  * ``construct_pipeline_stage``'s UNIFORM, MANUAL and PARAMETERS splits
    are the reference's;
  * ``PipeEngine``'s loss and per-group grads under GPipe, 1F1B,
    interleaved and zero bubble within ``LOSS_ULPS`` / ``GRAD_ULPS`` of the
    reference engine's (fp32, dense attention; measured below 1 and 16);
  * with flash attention (the kernels' custom ops), the engine's loss is
    bitwise the unpipelined ``GPT``'s over the same microbatches, and
    every grad but the tied ``wte`` (summed in another order) bitwise under
    1F1B and zero bubble;
  * the tied embedding's synced grads, ``forward_only`` without a target,
    the zero-bubble deferral (each weight grad computed after later
    dgrads), and no weight-grad matmul in any BACKWARD_DGRAD, counted by
    ``graph_split.OpRecorder``.

The multi-rank refusal runs in a gloo world of 2 in
``tests/test_torch_pipe_spmd.py``.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vescale_tpu.models import nanogpt as jg
from vescale_tpu import pipe as RP
from vescale_tpu import plan as RPlan
from vescale_tpu.pipe import schedules as RS
from vescale_tpu.telemetry import calibrate as ref_cal

from vescale_tpu_torch import pipe as PP
from vescale_tpu_torch import plan as PPlan
from vescale_tpu_torch.kernels import ulps_at_scale
from vescale_tpu_torch.models import GPT, GPTConfig, gpt_pipeline_units, gpt_unit_params
from vescale_tpu_torch.models import params_from_jax
from vescale_tpu_torch.models.nanogpt import cross_entropy_loss
from vescale_tpu_torch.pipe import schedules as PS
from vescale_tpu_torch.pipe.graph_split import OpRecorder
from vescale_tpu_torch.pipe.pipe_stage import flatten_tree
from vescale_tpu_torch.telemetry import calibrate as cal

from test_torch_ndtimeline import reset_all

CFG = dict(block_size=16, vocab_size=64, n_layer=4, n_head=2, n_embd=32, dropout=0.0)
ROWS, T, M = 8, 12, 4  # microbatch rows 2*12 = 24: no activation has a kernel's shape
LOSS_ULPS = 4.0
GRAD_ULPS = 64.0


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("VESCALE_KERNELS", raising=False)
    monkeypatch.delenv("VESCALE_COST_CALIBRATION", raising=False)
    reset_all()
    yield
    reset_all()


def _key(ins):
    return (ins.kind.value, ins.stage, ins.microbatch, ins.chunk)


def _lists(sched):
    return [[_key(i) for i in stage] for stage in sched]


def _costs(mod, kind, S):
    if kind == "uniform":
        return mod.StageCosts.uniform(S, comm=0.1)
    if kind == "tail":
        return mod.StageCosts.from_weights([1.0] * (S - 1) + [3.0], comm=0.2)
    return mod.StageCosts.from_weights([1.0 + (s % 2) for s in range(S)], comm=0.3)


# ------------------------------------------------------------- schedules
@pytest.mark.parametrize("S,M_", [(1, 3), (2, 2), (2, 5), (4, 4), (4, 8), (3, 7)])
def test_fixed_schedules_equal_the_reference(S, M_):
    for name in ("gpipe_schedule", "one_f_one_b_schedule", "zero_bubble_schedule"):
        assert _lists(getattr(PS, name)(S, M_)) == _lists(getattr(RS, name)(S, M_)), name
    for V in (1, 2, 3):
        if V > 1 and M_ % S:
            for mod in (PS, RS):
                with pytest.raises(ValueError, match="divisible"):
                    mod.interleaved_1f1b_schedule(S, M_, V)
            continue
        got = PS.interleaved_1f1b_schedule(S, M_, V)
        assert _lists(got) == _lists(RS.interleaved_1f1b_schedule(S, M_, V))
        for kind in ("uniform", "tail", "alt"):
            assert (PS.simulate_schedule(got, _costs(PS, kind, S))
                    == RS.simulate_schedule(RS.interleaved_1f1b_schedule(S, M_, V),
                                            _costs(RS, kind, S)))


@pytest.mark.parametrize("S,M_,V,cap", [(2, 4, 1, None), (4, 8, 1, None), (4, 16, 1, 4),
                                        (4, 32, 1, None), (4, 8, 2, None), (2, 4, 2, None),
                                        (4, 5, 3, None), (5, 7, 2, None), (3, 6, 1, 2)])
def test_cost_driven_zero_bubble_equals_the_reference(S, M_, V, cap):
    for kind in ("uniform", "tail", "alt"):
        got = PS.zero_bubble_cost_schedule(S, M_, _costs(PS, kind, S), virtual_chunks=V,
                                           max_inflight=cap)
        want = RS.zero_bubble_cost_schedule(S, M_, _costs(RS, kind, S), virtual_chunks=V,
                                            max_inflight=cap)
        assert _lists(got) == _lists(want), (kind, S, M_, V, cap)
        assert (PS.simulate_schedule(got, _costs(PS, kind, S))
                == RS.simulate_schedule(want, _costs(RS, kind, S)))
        greedy = PS._zb_greedy_schedule(S, M_, _costs(PS, kind, S), V, cap)
        assert _lists(greedy) == _lists(RS._zb_greedy_schedule(S, M_, _costs(RS, kind, S), V,
                                                                cap))


def test_schedule_validation_and_cost_coercion_equal_the_reference():
    for mod in (PS, RS):
        with pytest.raises(ValueError, match="stages"):
            mod.zero_bubble_cost_schedule(4, 4, [1.0, 2.0, 3.0])
        with pytest.raises(ValueError, match="stages"):
            mod.simulate_schedule(mod.zero_bubble_schedule(2, 2), mod.StageCosts.uniform(3))
        with pytest.raises(ValueError, match="V=1"):
            mod.zero_bubble_cost_schedule(4, 8, None, virtual_chunks=2, max_inflight=4)
        a = mod.StageCosts.uniform(2, comm=np.float32(0.5))
        assert a == mod.StageCosts.uniform(2, comm=0.5) and type(a.comm) is float
        lists = mod.StageCosts(f=[1.0, 1.0], bd=[1.0, 1.0], w=[1.0, 1.0])
        assert hash(lists) == hash(mod.StageCosts.uniform(2))
    got = PS.zero_bubble_cost_schedule(4, 8, [1.0, 2.0, 1.0, 3.0])
    assert _lists(got) == _lists(RS.zero_bubble_cost_schedule(4, 8, [1.0, 2.0, 1.0, 3.0]))


@pytest.mark.parametrize("stype,V,costs", [
    ("GPIPE", 1, None), ("SIMPLE_1F1B", 1, None), ("INTERLEAVED_1F1B", 2, None),
    ("ZERO_BUBBLE", 1, None), ("ZERO_BUBBLE", 1, [1.0, 1.0, 1.0, 3.0]),
    ("ZERO_BUBBLE", 2, None)])
def test_build_schedule_and_plan_equal_the_reference(stype, V, costs):
    kw = dict(num_stages=4, virtual_chunks=V)
    plans = [mod.PipelineParallelPlan(schedule_type=getattr(mod.PipelineScheduleType, stype),
                                      schedule_costs=costs, **kw) for mod in (PPlan, RPlan)]
    assert plans[0].virtual_chunks == plans[1].virtual_chunks
    assert _lists(PS.build_schedule(plans[0], 8)) == _lists(RS.build_schedule(plans[1], 8))
    zb = [mod.PipelineParallelPlan(use_zero_bubble=True) for mod in (PPlan, RPlan)]
    assert zb[0].schedule_type.value == zb[1].schedule_type.value == "zbv"
    for mod in (PPlan, RPlan):
        with pytest.raises(ValueError, match="together"):
            mod.PipelineParallelPlan(stage_out_placements=[None])
    # nothing declared: both audits are empty reports of the same name
    got, want = (mod.PipelineParallelPlan().boundary_report(None, (2, 3)) for mod in (PPlan, RPlan))
    assert got.findings == want.findings == [] and got.name == want.name
    assert [e.value for e in PPlan.TracerType] == [e.value for e in RPlan.TracerType]
    assert [e.value for e in PPlan.PipelineSplitMethodType] == [
        e.value for e in RPlan.PipelineSplitMethodType]


# ------------------------------------------------------------ the split
def _ref_units():
    return jg.gpt_pipeline_units(jg.GPTConfig(**CFG))


def _units(**kw):
    return gpt_pipeline_units(GPTConfig(**CFG, **kw))


@pytest.mark.parametrize("method,S,V,points", [
    ("UNIFORM", 2, 1, None), ("UNIFORM", 4, 1, None), ("UNIFORM", 2, 2, None),
    ("UNIFORM", 3, 1, None), ("MANUAL", 2, 1, ["h_1"]), ("MANUAL", 3, 1, ["wpe", "h_3"]),
    ("PARAMETERS", 2, 1, None), ("PARAMETERS", 4, 1, None), ("PARAMETERS", 2, 2, None)])
def test_construct_pipeline_stage_splits_equal_the_reference(method, S, V, points):
    plans = [mod.PipelineParallelPlan(num_stages=S, virtual_chunks=V, split_points=points,
                                      split_method=getattr(mod.PipelineSplitMethodType, method))
             for mod in (PPlan, RPlan)]
    pm = PP.construct_pipeline_stage(_units(), plans[0])
    ref = RP.construct_pipeline_stage(_ref_units(), plans[1],
                                      x_example=jnp.ones((1, 8), jnp.int32))
    assert [[u.name for u in g] for g in pm.groups] == [[u.name for u in g] for g in ref.groups]
    assert pm.shared_groups == ref.shared_groups
    assert pm.virtual_chunks == ref.virtual_chunks
    assert [pm.stage_of_group(g) for g in range(pm.num_groups)] == [
        ref.stage_of_group(g) for g in range(ref.num_groups)]


def test_split_errors_and_tail_heavy_cuts():
    from vescale_tpu.pipe.pipe_stage import _cuts_by_weight as ref_cuts
    from vescale_tpu_torch.pipe.pipe_stage import _cuts_by_weight

    for w, n in (([1, 1, 1, 1, 1, 1, 60, 40], 4), ([5, 1, 1], 3), ([1] * 10, 3)):
        assert _cuts_by_weight(w, n) == ref_cuts(w, n)
    units = _units()
    for plan, match in ((PPlan.PipelineParallelPlan(num_stages=9), "groups for"),
                        (PPlan.PipelineParallelPlan(
                            split_method=PPlan.PipelineSplitMethodType.MANUAL), "split_points"),
                        (PPlan.PipelineParallelPlan(
                            split_method=PPlan.PipelineSplitMethodType.MANUAL,
                            split_points=["nope"]), "not among")):
        with pytest.raises(ValueError, match=match):
            PP.construct_pipeline_stage(units, plan)


# --------------------------------------------------------------- engine
def _tokens(seed=1, rows=ROWS, width=T + 1):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], (rows, width)).astype(
        np.int32)


_REF = {}


def _ref_setup(S, V, stype):
    """The reference module (split as the port splits) and its init_all
    params, made once per (S, V)."""
    plan = RPlan.PipelineParallelPlan(num_stages=S, virtual_chunks=V,
                                      schedule_type=getattr(RPlan.PipelineScheduleType, stype))
    key = (S, V)
    if key not in _REF:
        pm = RP.construct_pipeline_stage(_ref_units(), plan)
        _REF[key] = (pm, pm.init_all(jax.random.key(0), jnp.ones((2, T), jnp.int32)))
    pm, params = _REF[key]
    return pm, plan, params


def _port_params(ref_params):
    return [params_from_jax(gp, device="cpu") for gp in ref_params]


def _ulps(port_grads, ref_grads):
    worst = 0.0
    for pg, rg in zip(port_grads, ref_grads):
        rflat = flatten_tree(jax.tree_util.tree_map(np.asarray, rg))
        pflat = flatten_tree(pg)
        assert set(pflat) == set(rflat)
        for k, v in pflat.items():
            worst = max(worst, ulps_at_scale(v.numpy(), rflat[k]))
    return worst


ENGINE_CASES = [("GPIPE", 4, 1), ("SIMPLE_1F1B", 4, 1), ("INTERLEAVED_1F1B", 2, 2),
                ("ZERO_BUBBLE", 4, 1), ("ZERO_BUBBLE", 2, 1)]


@pytest.mark.parametrize("stype,S,V", ENGINE_CASES)
def test_engine_loss_and_grads_match_the_reference_engine(stype, S, V):
    rpm, rplan, rparams = _ref_setup(S, V, stype)
    toks = _tokens()
    rbatch = {"input": jnp.asarray(toks[:, :-1]), "target": jnp.asarray(toks[:, 1:])}
    rloss, rgrads = RP.PipeEngine(rpm, rplan, jg.cross_entropy_loss).forward_backward(
        rparams, rbatch, num_microbatches=M)

    plan = PPlan.PipelineParallelPlan(num_stages=S, virtual_chunks=V,
                                      schedule_type=getattr(PPlan.PipelineScheduleType, stype))
    pm = PP.construct_pipeline_stage(_units(), plan)
    t = torch.from_numpy(toks).long()
    loss, grads = PP.PipeEngine(pm, plan, cross_entropy_loss).forward_backward(
        _port_params(rparams), {"input": t[:, :-1], "target": t[:, 1:]}, num_microbatches=M)
    assert ulps_at_scale(np.asarray(loss), np.asarray(rloss)) <= LOSS_ULPS
    assert _ulps(grads, rgrads) <= GRAD_ULPS


def _golden(params, toks, cfg):
    """The unpipelined ``GPT`` over the same microbatches: loss summed in
    microbatch order and divided by M, grads accumulated in microbatch
    order and divided by M (``make_train_step``'s accumulation)."""
    model = GPT(cfg, params, device="cpu")
    l_sum, acc = None, {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    for rows in torch.from_numpy(toks).long().chunk(M):
        model.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(model(rows[:, :-1]), rows[:, 1:])
        loss.backward()
        for n, p in model.named_parameters():
            acc[n].add_(p.grad)
        l_sum = loss.detach() if l_sum is None else l_sum + loss.detach()
    return l_sum / M, {n: g / M for n, g in acc.items()}


@pytest.mark.parametrize("stype,S,V,exact", [("SIMPLE_1F1B", 4, 1, True),
                                             ("ZERO_BUBBLE", 4, 1, True),
                                             ("GPIPE", 4, 1, False),
                                             ("INTERLEAVED_1F1B", 2, 2, True)])
def test_flash_engine_loss_is_bitwise_the_unpipelined_model(stype, S, V, exact):
    from vescale_tpu_torch.models import init_params

    cfg = GPTConfig(**CFG, use_flash_attention=True)
    params = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    toks = _tokens(seed=3)
    gloss, ggrads = _golden(params, toks, cfg)
    plan = PPlan.PipelineParallelPlan(num_stages=S, virtual_chunks=V,
                                      schedule_type=getattr(PPlan.PipelineScheduleType, stype))
    pm = PP.construct_pipeline_stage(gpt_pipeline_units(cfg), plan)
    t = torch.from_numpy(toks).long()
    loss, grads = PP.PipeEngine(pm, plan, cross_entropy_loss).forward_backward(
        pm.partition_params(gpt_unit_params(params, cfg.n_layer)),
        {"input": t[:, :-1], "target": t[:, 1:]}, num_microbatches=M)
    assert torch.equal(loss, gloss)
    for g, gd in enumerate(grads):
        for unit, tree in gd.items():
            for name, got in flatten_tree(tree).items():
                want = ggrads[name if unit in ("wte", "wpe", "ln_f", "head") else f"{unit}.{name}"]
                if exact and unit not in ("wte", "head"):  # GPipe sums in reverse order
                    assert torch.equal(got, want), (unit, name)
                else:
                    assert ulps_at_scale(got.numpy(), want.numpy()) <= 4.0, (unit, name)


def test_tied_embedding_grads_synced():
    rpm, rplan, rparams = _ref_setup(2, 1, "SIMPLE_1F1B")
    params = _port_params(rparams)
    assert torch.equal(params[0]["wte"]["wte"]["embedding"], params[1]["head"]["wte"]["embedding"])
    plan = PPlan.PipelineParallelPlan(num_stages=2)
    pm = PP.construct_pipeline_stage(_units(), plan)
    t = torch.from_numpy(_tokens(rows=4)).long()
    _, grads = PP.PipeEngine(pm, plan, cross_entropy_loss).forward_backward(
        params, {"input": t[:, :-1], "target": t[:, 1:]}, num_microbatches=2)
    a, b = grads[0]["wte"]["wte"]["embedding"], grads[1]["head"]["wte"]["embedding"]
    assert torch.equal(a, b)
    _, rgrads = RP.PipeEngine(rpm, rplan, jg.cross_entropy_loss).forward_backward(
        rparams, {"input": jnp.asarray(t[:, :-1].numpy()), "target": jnp.asarray(
            t[:, 1:].numpy())}, num_microbatches=2)
    assert ulps_at_scale(a.numpy(), np.asarray(rgrads[0]["wte"]["wte"]["embedding"])) <= GRAD_ULPS


def test_forward_only_without_target():
    rpm, rplan, rparams = _ref_setup(2, 1, "SIMPLE_1F1B")
    plan = PPlan.PipelineParallelPlan(num_stages=2)
    pm = PP.construct_pipeline_stage(_units(), plan)
    toks = _tokens(rows=4, width=T)
    eng = PP.PipeEngine(pm, plan, cross_entropy_loss)
    loss, outs = eng.forward_only(_port_params(rparams), {"input": torch.from_numpy(toks).long()},
                                  num_microbatches=2)
    rloss, routs = RP.PipeEngine(rpm, rplan, jg.cross_entropy_loss).forward_backward(
        rparams, {"input": jnp.asarray(toks)}, num_microbatches=2, forward_only=True)
    assert loss is None and rloss is None
    assert tuple(outs.shape) == (4, T, CFG["vocab_size"]) and not outs.requires_grad
    assert ulps_at_scale(outs.numpy(), np.asarray(routs)) <= GRAD_ULPS
    with pytest.raises(ValueError, match="target"):
        eng.forward_backward(_port_params(rparams), {"input": torch.from_numpy(toks).long()}, 2)


def test_zero_bubble_wgrad_deferred_and_dgrad_runs_no_weight_matmul(monkeypatch):
    """At BACKWARD_DGRAD only the input cotangent is computed and a
    ``PendingWgrad`` is stashed; its weight-grad matmuls run when
    BACKWARD_WGRAD executes, after later microbatches' dgrads.  Counted:
    every matmul of every DGRAD writes an activation's shape, and there are
    exactly as many as the groups' forward matmuls (one input-grad product
    each); the WGRADs make every weight-shaped product."""
    import vescale_tpu_torch.pipe.engine as engine_mod

    events = []
    orig_init, orig_compute = engine_mod.PendingWgrad.__init__, engine_mod.PendingWgrad.compute

    def spy_init(self, *a, **kw):
        events.append("stash")
        return orig_init(self, *a, **kw)

    def spy_compute(self):
        events.append("wgrad")
        return orig_compute(self)

    monkeypatch.setattr(engine_mod.PendingWgrad, "__init__", spy_init)
    monkeypatch.setattr(engine_mod.PendingWgrad, "compute", spy_compute)
    rpm, rplan, rparams = _ref_setup(2, 1, "ZERO_BUBBLE")
    plan = PPlan.PipelineParallelPlan(num_stages=2, schedule_type=PPlan.PipelineScheduleType.ZERO_BUBBLE)
    pm = PP.construct_pipeline_stage(_units(), plan)
    eng = PP.PipeEngine(pm, plan, cross_entropy_loss)
    census = {k: OpRecorder() for k in ("F", "Bd", "W")}
    eng.instruction_context = lambda ins: census.get(ins.kind.value, contextlib.nullcontext())
    t = torch.from_numpy(_tokens()).long()
    batch = {"input": t[:, :-1], "target": t[:, 1:]}
    loss, grads = eng.forward_backward(_port_params(rparams), batch, num_microbatches=M)
    G = pm.num_groups
    stashes = [i for i, e in enumerate(events) if e == "stash"]
    wgrads = [i for i, e in enumerate(events) if e == "wgrad"]
    assert len(stashes) == M * G and len(wgrads) == M * G
    assert wgrads[0] > stashes[1]  # the schedule holds W back to fill the bubble

    kernels = {tuple(v.shape) for gd in grads for tree in gd.values()
               for v in flatten_tree(tree).values() if v.dim() == 2}
    assert census["Bd"].weight_shaped(kernels) == 0
    # group 0's DGRAD computes nothing (its input is tokens); the last
    # group's forward products (2-D: the linears; attention's dense branch
    # is batched) are its 2 blocks' 4 linears and the tied head
    def products(c):
        return sum(1 for s in c.matmul_shapes() if len(s) == 2)

    assert products(census["Bd"]) == M * (4 * 2 + 1)
    assert products(census["F"]) == M * (4 * 2 + 4 * 2 + 1)
    assert census["W"].weight_shaped(kernels) == M * (4 * 4 + 1)  # 16 block kernels, the head

    # and the result is the fused-backward engine's
    plan_f = PPlan.PipelineParallelPlan(num_stages=2)
    loss_f, grads_f = PP.PipeEngine(pm, plan_f, cross_entropy_loss).forward_backward(
        _port_params(rparams), batch, num_microbatches=M)
    assert torch.equal(loss, loss_f)
    assert _ulps(grads, [jax.tree_util.tree_map(lambda x: x.numpy(), g) for g in grads_f]) <= 4.0


def test_cost_schedule_through_the_engine_and_telemetry(tmp_path):
    """A plan carrying ``schedule_costs`` routes through the cost-driven
    generator; the engine's counters and per-instruction spans are the
    reference's names, and ``bubble_fraction`` reads the spans."""
    from vescale_tpu_torch import ndtimeline, telemetry
    from vescale_tpu_torch.ndtimeline.handlers import ChromeTraceHandler
    from vescale_tpu_torch.telemetry.trace import bubble_fraction, spans_from_perfetto

    rpm, _, rparams = _ref_setup(4, 1, "ZERO_BUBBLE")
    plan = PPlan.PipelineParallelPlan(num_stages=4,
                                      schedule_type=PPlan.PipelineScheduleType.ZERO_BUBBLE,
                                      schedule_costs=PS.StageCosts.from_weights([1, 1, 1, 3],
                                                                                comm=0.1))
    pm = PP.construct_pipeline_stage(_units(), plan)
    telemetry.init(out_dir=str(tmp_path), timeseries=False, alerts=False, costaudit=False)
    handler = ChromeTraceHandler(str(tmp_path / "trace.json"))
    ndtimeline.init_ndtimers(handlers=[handler])
    t = torch.from_numpy(_tokens()).long()
    PP.PipeEngine(pm, plan, cross_entropy_loss).forward_backward(
        _port_params(rparams), {"input": t[:, :-1], "target": t[:, 1:]}, num_microbatches=M)
    ndtimeline.flush()
    handler.write()
    reg = telemetry.get_registry()
    text = telemetry.prometheus_dump()
    for name in ("pipe_forward_backward_total", "pipe_instructions_total",
                 "pipe_num_microbatches", "pipe_forward_backward_seconds"):
        assert name in text, name
    assert reg is not None
    spans = spans_from_perfetto(str(tmp_path / "trace.json"))
    pipe_spans = [s for s in spans if s.tags and "stage" in s.tags]
    assert len(pipe_spans) == 3 * M * 4
    frac = bubble_fraction(spans)
    assert frac is not None and 0.0 <= frac < 1.0


def test_estimate_stage_costs_picks_the_references_schedule():
    """FLOP-unit costs: blocks-only middle stages weigh the same; under a
    calibration table (µs units, a ppermute bucket at the boundary's
    bytes) the port picks the reference's schedule."""
    S = 4
    rpm, _, rparams = _ref_setup(S, 1, "ZERO_BUBBLE")
    plan = PPlan.PipelineParallelPlan(num_stages=S, schedule_type=PPlan.PipelineScheduleType.ZERO_BUBBLE)
    pm = PP.construct_pipeline_stage(_units(), plan)
    x = _tokens(rows=2, width=T)
    costs = PP.estimate_stage_costs(pm, _port_params(rparams), torch.from_numpy(x).long(), comm=0.0)
    assert len(costs.f) == S and all(w > 0 for w in costs.f)
    assert costs.f[1] == pytest.approx(costs.f[2], rel=1e-9)
    act_bytes = 2 * T * CFG["n_embd"] * 4
    tables = []
    for mod in (ref_cal, cal):
        tbl = mod.CalibrationTable(meta={"platform": "cpu", "matmul_gflops": 0.05})
        tbl.add_sample("ppermute", S, act_bytes, 40e-6)
        mod.set_active(tbl)
        tables.append(tbl)
    ref_costs = RP.estimate_stage_costs(rpm, rparams, jnp.asarray(x), comm=None)
    port_costs = PP.estimate_stage_costs(pm, _port_params(rparams), torch.from_numpy(x).long(),
                                         comm=None)
    assert port_costs.comm == ref_costs.comm > 0
    for M_ in (4, 8):
        assert _lists(PS.zero_bubble_cost_schedule(S, M_, port_costs)) == _lists(
            RS.zero_bubble_cost_schedule(S, M_, ref_costs))
