"""The port's trace timeline, straggler detector and telemetry wiring against
the JAX package's, on the CPU.

Fixed span lists go through both packages: ``merge_traces`` under given
offsets (a ``ClockSync``, a mapping, replica-qualified streams), the
Perfetto file and its reload, ``critical_path`` (per step too),
``bubble_fraction``, ``step_span_summary`` and ``record_trace_metrics``,
and the straggler detector's duration and skew-corrected lag flags: all
exactly equal.  ``estimate_clock_offsets`` runs over a gloo world of 2.
``telemetry.init`` with the time-series store, the alert engine and the
cost auditor on gives the reference's dashboard and Prometheus text.  The
tiny Llama's steps, fed by each package's ``TokenDataLoader``, give the
reference's TRAIN_STEP and DATA_LOAD spans and ``spans`` rollups in
``steps.jsonl`` (the port adds its OPTIMIZER_STEP: every optimizer of the
port is eager, the reference's runs inside its compiled step).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vescale_tpu import ndtimeline as ref_nd
from vescale_tpu import telemetry as ref_tel
from vescale_tpu.ndtimeline.timer import Span as RefSpan
from vescale_tpu.telemetry import straggler as ref_straggler
from vescale_tpu.telemetry import trace as ref_trace

from vescale_tpu_torch import ndtimeline as nd
from vescale_tpu_torch import telemetry as tel
from vescale_tpu_torch.ndtimeline import predefined as P
from vescale_tpu_torch.ndtimeline.timer import Span
from vescale_tpu_torch.telemetry import straggler, trace

from test_torch_ndtimeline import gloo_world
from torch_reset import all_dormant, reset_all


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("VESCALE_KERNELS", raising=False)
    reset_all()
    yield
    reset_all()
    assert all_dormant()


def _pipe_rows():
    """Two ranks of a 2-stage pipeline over two steps, rank 1's clock 3 ms
    ahead, plus host spans and a flow pair."""
    rows = []
    for step in range(2):
        base = 50.0 + step * 0.1
        for rank, skew in ((0, 0.0), (1, 0.003)):
            for i in range(4):
                t = base + skew + i * 0.011 + rank * 0.005
                rows.append(("forward-compute", t, 0.004, step, rank, {"stage": rank, "mb": i}))
                rows.append(("backward-compute", t + 0.005, 0.0045, step, rank,
                             {"stage": rank, "mb": i}))
            rows.append(("train-step", base + skew, 0.06 + 0.01 * rank, step, rank, None))
        rows.append(("serve-submit", base + 0.001, 0.0, step, 0,
                     {"flow_id": f"f{step}", "flow_role": "send"}))
        rows.append(("serve-terminal", base + 0.02, 0.0, step, 1,
                     {"flow_id": f"f{step}", "flow_role": "recv"}))
    rows.append(("zero", 50.5, 0.0, 3, 0, None))
    rows.append(("zero", 50.5, 0.0, 3, 0, None))
    return rows


def _spans(cls, rows=None):
    return [cls(m, s, d, st, r, dict(t) if t else None) for m, s, d, st, r, t in rows or _pipe_rows()]


def _tuples(spans):
    return [(s.metric, s.start, s.duration, s.step, s.rank, s.tags) for s in spans]


def _cp(cp):
    return {**cp, "spans": _tuples(cp["spans"])}


def test_merge_critical_path_bubble_and_summary_equal_the_reference():
    ref_sync = ref_trace.ClockSync(offsets_us=[0.0, 3000.0], residual_us=12.5, rounds=4)
    sync = trace.ClockSync.from_dict(ref_sync.as_dict())
    assert sync.as_dict() == ref_sync.as_dict() and sync.offset_s(5) == 0.0
    for clock, ref_clock in ((sync, ref_sync), ({1: 0.003}, {1: 0.003}), (None, None)):
        want = ref_trace.merge_traces(_spans(RefSpan), ref_clock)
        got = trace.merge_traces(_spans(Span), clock)
        assert _tuples(got) == _tuples(want)
        by_rank = {0: _spans(Span)[:5], 1: _spans(Span)[5:]}
        ref_by_rank = {0: _spans(RefSpan)[:5], 1: _spans(RefSpan)[5:]}
        assert _tuples(trace.merge_traces(by_rank, clock)) == \
            _tuples(ref_trace.merge_traces(ref_by_rank, ref_clock))
    streams = {"router": _spans(Span)[:3], "r1": _spans(Span)[3:9], "r0": _spans(Span)[9:]}
    ref_streams = {"router": _spans(RefSpan)[:3], "r1": _spans(RefSpan)[3:9],
                   "r0": _spans(RefSpan)[9:]}
    offs = {"r1": 0.002}
    assert _tuples(trace.merge_traces(streams, offs)) == \
        _tuples(ref_trace.merge_traces(ref_streams, offs))
    assert trace.stream_process_names(streams) == ref_trace.stream_process_names(ref_streams)
    with pytest.raises(TypeError):
        trace.merge_traces(_spans(Span), clock=3.0)
    merged = trace.merge_traces(_spans(Span), sync)
    ref_merged = ref_trace.merge_traces(_spans(RefSpan), ref_sync)
    assert _cp(trace.critical_path(merged)) == _cp(ref_trace.critical_path(ref_merged))
    assert trace.critical_path([]) == ref_trace.critical_path([])
    got = {k: _cp(v) for k, v in trace.critical_paths_by_step(merged).items()}
    want = {k: _cp(v) for k, v in ref_trace.critical_paths_by_step(ref_merged).items()}
    assert got == want and set(got) == {0, 1, 3}
    for step in (None, 0, 1, 7):
        assert trace.bubble_fraction(merged, step) == ref_trace.bubble_fraction(ref_merged, step)
    assert trace.bubble_fraction(merged) is not None
    for step in (None, 0, 1, 9):
        mgr, ref_mgr = nd.api.NDTimerManager(), ref_nd.api.NDTimerManager()
        for s, r in zip(_spans(Span), _spans(RefSpan)):
            mgr.record(s.metric, s.start, s.duration, s.tags, step=s.step)
            ref_mgr.record(r.metric, r.start, r.duration, r.tags, step=r.step)
        assert trace.step_span_summary(step, manager=mgr) == \
            ref_trace.step_span_summary(step, manager=ref_mgr)
    assert trace.step_span_summary() is None  # dormant


def test_perfetto_write_reload_and_spans_equal_the_reference(tmp_path):
    from vescale_tpu.ndtimeline import WorldInfo as RefWorld

    merged = trace.merge_traces(_spans(Span), {1: 0.003})
    ref_merged = ref_trace.merge_traces(_spans(RefSpan), {1: 0.003})
    worlds = {0: nd.WorldInfo(rank=0, dp_rank=0), 1: nd.WorldInfo(rank=1, dp_rank=1)}
    ref_worlds = {0: RefWorld(rank=0, dp_rank=0), 1: RefWorld(rank=1, dp_rank=1)}
    got = trace.write_perfetto(merged, str(tmp_path / "port.json"), world_infos=worlds)
    want = ref_trace.write_perfetto(ref_merged, str(tmp_path / "ref.json"), world_infos=ref_worlds)
    assert trace.load_perfetto(got) == ref_trace.load_perfetto(want)
    back = trace.spans_from_perfetto(got)
    assert _tuples(back) == _tuples(ref_trace.spans_from_perfetto(want))
    assert len(back) == len(merged)
    assert [(x.metric, x.step, x.rank) for x in back] == [(x.metric, x.step, x.rank) for x in merged]
    (tmp_path / "bad.json").write_text("{}")
    with pytest.raises(ValueError):
        trace.load_perfetto(str(tmp_path / "bad.json"))


def test_record_trace_metrics_gauges_equal_the_reference():
    kw = dict(timeseries=False, alerts=False, costaudit=False, memtrack=False)
    ref_tel.init(out_dir=None, **kw)
    tel.init(out_dir=None, **kw)
    sync = trace.ClockSync([0.0, 3000.0], 12.5, 4)
    ref_trace.record_trace_metrics(ref_trace.merge_traces(_spans(RefSpan)),
                                   clock=ref_trace.ClockSync([0.0, 3000.0], 12.5, 4))
    trace.record_trace_metrics(trace.merge_traces(_spans(Span)), clock=sync)
    assert tel.get_registry().snapshot() == ref_tel.get_registry().snapshot()
    assert tel.dashboard() == ref_tel.dashboard()
    assert "trace:" in tel.dashboard() and "critical-path:" in tel.dashboard()


def _straggler_rows():
    rows = []
    for step in range(6):
        for rank in range(4):
            dur = 0.010 * (2.5 if rank == 3 else 1.0) + 0.0001 * step
            lag = 0.004 if rank == 2 else 0.0
            rows.append(("train-step", 10.0 + step + lag + rank * 0.0005, dur, step, rank, None))
            rows.append(("data-load", 10.0 + step, 0.001, step, rank, None))
    return rows


@pytest.mark.parametrize("offsets", [None, "clock", "mapping"])
def test_straggler_flags_equal_the_reference(offsets):
    got, want = straggler.StragglerDetector(threshold=1.5), ref_straggler.StragglerDetector(
        threshold=1.5)
    if offsets == "clock":
        got.set_clock_offsets(trace.ClockSync([0.0, 500.0, 1000.0, 1500.0], 200.0, 8))
        want.set_clock_offsets(ref_trace.ClockSync([0.0, 500.0, 1000.0, 1500.0], 200.0, 8))
    elif offsets == "mapping":
        got.set_clock_offsets({1: 0.0005, 2: 0.001})
        want.set_clock_offsets({1: 0.0005, 2: 0.001})
    got(_spans(Span, _straggler_rows()))
    want(_spans(RefSpan, _straggler_rows()))
    assert got.report() == want.report() and got.report()
    assert got.lag_report() == want.lag_report()
    assert got.summary() == want.summary() and got.healthy() == want.healthy() is False
    assert got.rank_means("train-step") == want.rank_means("train-step")
    from vescale_tpu.ndtimeline.parser_handler import merge_ranks as ref_merge

    from vescale_tpu_torch.ndtimeline.parser_handler import merge_ranks

    a, b = straggler.StragglerDetector(), ref_straggler.StragglerDetector()
    a.update_from_merged(merge_ranks(_spans(Span, _straggler_rows())))
    b.update_from_merged(ref_merge(_spans(RefSpan, _straggler_rows())))
    assert a.report() == b.report() and a.spans_seen == b.spans_seen
    with pytest.raises(ValueError):
        straggler.StragglerDetector(threshold=1.0)


def test_straggler_routes_through_a_live_alert_engine():
    from vescale_tpu_torch.telemetry import alerts

    tel.init(out_dir=None, timeseries=False, alerts=True, costaudit=False, memtrack=False)
    det = straggler.StragglerDetector()
    det(_spans(Span, _straggler_rows()))
    assert "straggler-lag" in alerts.digest()["firing"]


def test_clock_offsets_single_process_and_over_a_gloo_world():
    one = trace.estimate_clock_offsets(rounds=3)
    assert one.offsets_us == [0.0] and one.residual_us == 0.0 and one.rounds == 3
    rows = gloo_world("from vescale_tpu_torch.telemetry.trace import estimate_clock_offsets\n"
                      "result = estimate_clock_offsets(rounds=4).as_dict()")
    for r in rows:
        assert len(r["offsets_us"]) == 2 and r["offsets_us"][0] == 0.0 and r["rounds"] == 4
        # two processes of one host share its clock: the offset is the
        # gather's own skew, within the residual the estimate reports plus
        # the scheduling noise of a loaded box
        assert abs(r["offsets_us"][1]) <= max(r["residual_us"], 0.0) + 50_000
    assert rows[0]["offsets_us"] == rows[1]["offsets_us"]


def _feed_both():
    for pkg in (ref_tel, tel):
        pkg.count("serve_requests_shed_total", 2)
        pkg.set_gauge("cost_model_divergence", 1.25)
        for i in range(4):
            pkg.record_step({"step": i, "step_time_s": 0.5, "loss": 3.0 - i / 4, "tokens": 64})


def test_init_with_the_three_subsystems_exports_equal_the_reference():
    """``telemetry.init`` with the store, the engine and the auditor on (the
    defaults): the dashboard (its ``alerts:``, ``timeseries:`` and
    ``cost-model:`` blocks too) and the Prometheus text equal a reference
    run with the same three on.  memtrack is off on both sides: its host
    RSS lines differ by process."""
    from vescale_tpu.telemetry import alerts as ref_alerts

    from vescale_tpu_torch.telemetry import alerts

    for pkg in (ref_tel, tel):
        st = pkg.init(out_dir=None, memtrack=False, timeseries_cadence_s=0.0)
        assert st.timeseries is not None and st.alerts is not None and st.costaudit is not None
    ref_alerts.raise_alert("manual-one", message="m", severity="info")
    alerts.raise_alert("manual-one", message="m", severity="info")
    _feed_both()
    got, want = tel.dashboard(), ref_tel.dashboard()
    assert got == want
    for block in ("alerts:", "timeseries:", "firing:  manual-one"):
        assert block in got
    assert tel.prometheus_dump() == ref_tel.prometheus_dump()
    assert set(alerts.payload()) == set(ref_alerts.payload())
    assert alerts.digest() == ref_alerts.digest()
    assert sorted(alerts.get_engine().rules) == sorted(ref_alerts.get_engine().rules)


def test_record_step_spans_rollup_and_auto_inc_equal_the_reference(tmp_path):
    """The reference's record_step/auto_inc ordering on hand-recorded
    spans: each steps.jsonl line carries the rollup of the step it records."""
    for pkg, nd_pkg, where in ((ref_tel, ref_nd, "ref"), (tel, nd, "port")):
        pkg.init(out_dir=str(tmp_path / where), memtrack=False, timeseries=False,
                 alerts=False, costaudit=False)
        mgr = nd_pkg.init_ndtimers()
        for i in range(3):
            mgr.record(P.DATA_LOAD, 1.0 + i, 0.001 * (i + 1))
            mgr.record(P.TRAIN_STEP, 1.5 + i, 0.01 * (i + 1))
            mgr.inc_step()
            pkg.record_step({"step": i, "loss": 1.0})
        pkg.shutdown()
        nd_pkg.api.deinit_ndtimers()
    lines = {w: [json.loads(x) for x in (tmp_path / w / "steps.jsonl").read_text().splitlines()]
             for w in ("ref", "port")}
    assert [x["spans"] for x in lines["port"]] == [x["spans"] for x in lines["ref"]]
    assert lines["port"][2]["spans"][P.TRAIN_STEP] == {"count": 1, "total_ms": 30.0}


def _jax_llama():
    from vescale_tpu.models import llama as jl

    cfg = jl.LlamaConfig(dtype=jnp.float32, vocab_size=128, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
                         max_position_embeddings=64)
    model = jl.Llama(cfg)
    params = model.init(jax.random.key(0), jnp.ones((2, 16), jnp.int32))["params"]
    return cfg, model, params


def test_train_step_spans_and_rollup_keys_equal_the_reference(tmp_path):
    from vescale_tpu.data.loader import TokenDataLoader as JaxLoader
    from vescale_tpu.models.nanogpt import cross_entropy_loss as jax_xent
    from vescale_tpu.parallel.optimizer import adamw_lowmem
    from vescale_tpu.train import make_train_step as jax_make_train_step

    from vescale_tpu_torch.data import TokenDataLoader
    from vescale_tpu_torch.models import Llama, LlamaConfig, cross_entropy_loss, params_from_jax
    from vescale_tpu_torch.parallel import AdamWLowmem
    from vescale_tpu_torch.train import make_train_step

    path = str(tmp_path / "tok.bin")
    np.random.default_rng(0).integers(0, 128, 8192).astype(np.uint16).tofile(path)
    cfg, jmodel, params = _jax_llama()
    kw = dict(memtrack=False, timeseries=False, alerts=False, costaudit=False)
    steps = 3

    ref_tel.init(out_dir=str(tmp_path / "ref"), **kw)
    ref_mgr = ref_nd.init_ndtimers()
    tx = adamw_lowmem(1e-3)
    jstep = jax_make_train_step(jmodel, tx, lambda lg, b: jax_xent(lg, b["target"]), donate=False)
    loader = JaxLoader(path, 2, 16, seed=1)
    p, s = params, tx.init(params)
    ref_losses = []
    for _ in range(steps):
        b = loader.next()
        p, s, loss = jstep(p, s, {"input": jnp.asarray(b["input"]), "target": jnp.asarray(b["target"])})
        ref_losses.append(float(loss))
    loader.close()
    ref_spans = ref_mgr.tail()
    ref_tel.shutdown()

    tel.init(out_dir=str(tmp_path / "port"), **kw)
    mgr = nd.init_ndtimers()
    tcfg = LlamaConfig(dtype=torch.float32, **{k: getattr(cfg, k) for k in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "max_position_embeddings")})
    model = Llama(tcfg, params_from_jax(params, device="cpu"), device="cpu")
    tstep = make_train_step(model, AdamWLowmem(model.parameters(), 1e-3),
                            lambda lg, b: cross_entropy_loss(lg, b["target"]))
    tloader = TokenDataLoader(path, 2, 16, seed=1, device="cpu")
    losses = [float(tstep(tloader.next())) for _ in range(steps)]
    tloader.close()
    spans = mgr.tail()
    tel.shutdown()

    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    on_path = (P.TRAIN_STEP, P.DATA_LOAD)
    assert [(x.metric, x.step) for x in spans if x.metric in on_path] == \
        [(x.metric, x.step) for x in ref_spans if x.metric in on_path]
    assert [x.metric for x in spans if x.metric == P.OPTIMIZER_STEP] == [P.OPTIMIZER_STEP] * steps
    assert nd.api.get_manager().step == ref_nd.api.get_manager().step == steps
    lines = {w: [json.loads(x) for x in (tmp_path / w / "steps.jsonl").read_text().splitlines()]
             for w in ("ref", "port")}
    for got, want in zip(lines["port"], lines["ref"]):
        assert set(got) == set(want)  # grad_norm and the spans rollup included
        assert set(got["spans"]) == set(want["spans"]) | {P.OPTIMIZER_STEP}
        assert {k: v["count"] for k, v in got["spans"].items() if k in on_path} == \
            {k: v["count"] for k, v in want["spans"].items()}
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)


def test_train_feed_scalars_under_a_dynamic_loss_scale(tmp_path):
    """The feed's ``grad_norm`` (unscaled), ``loss_scale`` (after the step)
    and ``skip_count`` under a ``DistributedOptimizer`` without a mesh; a
    non-finite step is skipped, counted, and halves the scale."""
    from vescale_tpu_torch.parallel import AdamWLowmem, DistributedOptimizer
    from vescale_tpu_torch.train import make_train_step

    torch.manual_seed(0)
    lin = torch.nn.Linear(4, 2)
    dopt = DistributedOptimizer(lambda ps: AdamWLowmem(ps, 1e-3), models=lin, loss_scale="dynamic",
                                init_scale=1024.0)
    step = make_train_step(lin, dopt, lambda out, b: out.pow(2).mean())
    x = torch.ones(3, 4)
    lin(x).pow(2).mean().backward()
    want_norm = float(torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in lin.parameters()])))
    lin.zero_grad()
    tel.init(out_dir=str(tmp_path), memtrack=False, timeseries=False, alerts=False, costaudit=False)
    step({"input": x})
    step({"input": torch.full((3, 4), float("inf"))})
    lines = [json.loads(x) for x in (tmp_path / "steps.jsonl").read_text().splitlines()]
    assert [(ln["loss_scale"], ln["skip_count"]) for ln in lines] == [(1024.0, 0), (512.0, 1)]
    np.testing.assert_allclose(lines[0]["grad_norm"], want_norm, rtol=1e-5)
    assert tel.get_registry().gauge("train_skipped_steps").value == 1
    assert tel.get_registry().gauge("train_loss_scale").value == 512.0
