"""The port's cost auditor, calibration table and layer attribution against
the JAX package's, on the CPU.

Ledger and calibration: the same predictions and measurements give the
same ledger and divergence folds; the same tagged spans harvest into the
same table; the table's ``collective_calibration.json`` is byte-identical
with an equal digest; lookups interpolate alike, and ``suggested_k`` reads
the same depth off the same table.  The port's sweep over a gloo world of
2 measures the keys the reference's measures on its CPU mesh (the times
are the machine's).

Attribution: the tiny Llama's train step, attributed to its layers by the
port (aten ops under a dispatch mode, the kernels by their own ``cost``)
and by the reference (its optimized HLO), has the same matmul FLOPs per
layer.  The names need no map: the port's module paths are the flax
scopes.  With dense attention every layer is equal; with the flash
kernels, self_attn's aten matmuls are the reference's less its dense
attention dots (12 B H T^2 D, forward and backward), and the kernels'
own FLOPs are 9 B H T^2 D (causal: forward 2, dq 3, dkv 4).  Bytes are
not held equal: XLA counts every HLO op's operands, aten counts each op
once, and the port's total was 0.17-0.18 of the reference's here.
"""

import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vescale_tpu.mesh import DeviceMesh as RefMesh
from vescale_tpu.telemetry import calibrate as ref_cal
from vescale_tpu.telemetry import costaudit as ref_ca
from vescale_tpu.telemetry.registry import MetricsRegistry as RefRegistry

from vescale_tpu_torch import kernels
from vescale_tpu_torch.serve import suggested_k
from vescale_tpu_torch.telemetry import calibrate as cal
from vescale_tpu_torch.telemetry import costaudit as ca
from vescale_tpu_torch.telemetry.registry import MetricsRegistry

from test_torch_ndtimeline import gloo_world
from torch_reset import all_dormant, reset_all


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("VESCALE_KERNELS", raising=False)
    monkeypatch.delenv("VESCALE_COST_CALIBRATION", raising=False)
    reset_all()
    yield
    reset_all()
    assert all_dormant() and kernels.COST_SINK is None


def _span(op, axis, nbytes, dur_s, start):
    return types.SimpleNamespace(tags={"collective_op": op, "axis_size": axis, "bytes": nbytes},
                                 start=start, duration=dur_s)


SAMPLES = [("all_reduce", 2, 4096, 31e-6), ("all_reduce", 2, 65536, 120e-6),
           ("all_reduce", 2, 1 << 20, 1.5e-3), ("all_gather", 2, 4096, 20e-6),
           ("all_gather", 2, 5000, 26e-6), ("ppermute", 4, 65536, 80e-6),
           ("serve_decode", 8, 8, 0.004), ("serve_decode", 8, 8, 0.0042),
           ("serve_draft", 8, 4, 0.0021), ("serve_draft", 8, 2, 0.0013)]


def _tables(meta_platform="cpu"):
    out = []
    for mod in (ref_cal, cal):
        t = mod.CalibrationTable(meta={"mesh": {"dim_names": ["dp"], "shape": [2]},
                                       "platform": meta_platform, "matmul_gflops": 12.5,
                                       "launch_us": 3.0})
        for op, ax, nb, s in SAMPLES:
            t.add_sample(op, ax, nb, s)
        t.add_sample("all_reduce", 2, 4096, 29e-6, decay=0.25)
        out.append(t)
    return out


def test_calibration_json_bytes_digest_and_lookups_equal_the_reference(tmp_path):
    ref, got = _tables()
    assert got.to_json() == ref.to_json()
    assert got.digest() == ref.digest()
    got.save(str(tmp_path / "port" / cal.TABLE_FILENAME))
    ref.save(str(tmp_path / "ref" / ref_cal.TABLE_FILENAME))
    assert (tmp_path / "port" / cal.TABLE_FILENAME).read_bytes() == \
        (tmp_path / "ref" / ref_cal.TABLE_FILENAME).read_bytes()
    back = cal.load_table(str(tmp_path / "ref" / ref_cal.TABLE_FILENAME))
    assert back.digest() == ref.digest() and len(back) == len(ref)
    for op, ax in (("all_reduce", 2), ("all_gather", 2), ("ppermute", 4), ("all_to_all", 2)):
        for nb in (1, 1000, 4096, 9000, 65536, 300_000, 1 << 20, 1 << 24):
            assert got.lookup_us(op, ax, nb) == ref.lookup_us(op, ax, nb)
    for op in ("serve_decode", "serve_draft", "nothing"):
        assert got.op_estimate_us(op) == ref.op_estimate_us(op)
    with pytest.raises(ValueError):
        cal.CalibrationTable.from_json({"format": 99})


def test_active_table_gate_and_cost_lookups_equal_the_reference(tmp_path, monkeypatch):
    ref, got = _tables()
    path = str(tmp_path / "t.json")
    got.save(path)
    monkeypatch.setenv("VESCALE_COST_CALIBRATION", path)
    for mod in (cal, ref_cal):
        mod.clear_warned()
    assert cal.active_table().digest() == ref_cal.active_table().digest() == got.digest()
    assert cal.active_digest() == ref_cal.active_digest()
    for op, ax, nb in (("all_reduce", 2, 10_000), ("all_gather", 2, 3000), ("ppermute", 4, 1)):
        assert cal.collective_cost_us(op, ax, nb) == ref_cal.collective_cost_us(op, ax, nb)
    assert cal.collective_cost_us("all_reduce", 1, 10) is None
    with pytest.warns(UserWarning, match="no measured bucket"):
        assert cal.collective_cost_us("all_to_all", 2, 100) is None
    assert cal.hop_latency_us() == ref_cal.hop_latency_us() == 3.0
    assert cal.compute_cost_us(1e9) == ref_cal.compute_cost_us(1e9)
    from vescale_tpu_torch.mesh import DeviceMesh

    with pytest.warns(UserWarning, match="stale table"):
        assert cal.table_for(DeviceMesh(("dp",), (4,), device_type="cpu")) is None
    assert cal.table_for(DeviceMesh(("dp",), (2,), device_type="cpu")) is not None
    cal.set_active(cal.CalibrationTable(meta={"platform": "cuda"}, entries={("x", 2, 1): {
        "us": 1.0, "samples": 1}}))
    with pytest.warns(UserWarning, match="platform 'cuda'"):
        assert cal.table_for(None) is None
    cal.set_active(None)
    assert cal.active_table() is None and cal.active_digest() is None


def test_suggested_k_equals_the_reference_on_the_same_table():
    from vescale_tpu.serve.speculative import suggested_k as ref_suggested_k

    ref, got = _tables()
    # a decode step of 4.1 ms against 0.43 ms a drafter launch: k = 3
    assert suggested_k(got) == ref_suggested_k(ref) == 3
    assert suggested_k(cal.CalibrationTable()) is None
    cal.set_active(got)
    assert suggested_k() == 3


def test_device_peaks_on_the_cpu():
    assert ca.device_mem_gbps("cpu") == 50.0
    assert cal.device_peak_flops("cpu") == 1e12
    cal.set_active(_tables()[1])
    assert cal.device_peak_flops(torch.device("cpu")) == 12.5e9
    assert cal.matmul_gflops("cpu", k=32, reps=1) > 0


def test_ledger_harvest_and_audit_equal_the_reference():
    outs = []
    for mod, camod, Reg in ((ref_cal, ref_ca, RefRegistry), (cal, ca, MetricsRegistry)):
        reg = Reg()
        table = mod.CalibrationTable(meta={"platform": "cpu"})
        table.add_sample("all_reduce", 2, 4096, 40e-6)
        mod.set_active(table)
        aud = camod.CostAudit(reg, depth=3, threshold=2.0, decay=0.5, cadence_s=1e9)
        p1 = aud.record_prediction("redistribute", predicted_us=100.0, digest="abc")
        p2 = aud.record_prediction("serve_step", predicted_us=10.0)
        p3 = aud.record_prediction("aot_memory", predicted_bytes=1000.0, unit="bytes")
        ratios = [aud.record_measurement(p1, measured_us=300.0),
                  aud.record_measurement(p2, measured_us=5.0),
                  aud.record_measurement(p3, measured_bytes=1100.0),
                  aud.record_measurement(None), aud.record_measurement(10 ** 9)]
        for i in range(4):
            aud.record_prediction("serve_step", predicted_us=10.0 + i)
        spans = [_span("all_reduce", 2, 4096, 20e-6 * (i + 1), 10.0 + i) for i in range(4)]
        spans.append(_span("all_gather", 2, 65536, 70e-6, 20.0))
        spans.append(types.SimpleNamespace(tags={"other": 1}, start=30.0, duration=1.0))
        n1 = aud.harvest(spans)
        n2 = aud.harvest(spans)  # the high-water mark: nothing twice
        summary = aud.audit_step("train")
        ledger = [{k: v for k, v in r.items() if k not in ("plan_id", "ts")} for r in aud.ledger()]
        outs.append((ratios, n1, n2, summary, ledger, aud.bucket_divergence(), table.to_json(),
                     table.digest(), reg.snapshot(), aud.summary()))
        mod.reset_active()
    assert outs[1] == outs[0]
    assert outs[1][1] == 5 and outs[1][2] == 0


def test_module_gate_and_drift_rule(tmp_path, monkeypatch):
    from vescale_tpu_torch import telemetry as tel
    from vescale_tpu_torch.telemetry import alerts

    assert ca.record_prediction is ca._noop_record_prediction
    assert ca.audit_step("train") is None and ca.harvest() == 0 and ca.audit_summary() is None
    st = tel.init(out_dir=str(tmp_path), memtrack=False)
    assert ca.is_active() and st.costaudit is ca.get_auditor()
    assert "cost-model-drift" in alerts.get_engine().rules
    assert [r.__dict__ for r in ca.costaudit_rule_pack(2.0)] == \
        [r.__dict__ for r in ref_ca.costaudit_rule_pack(2.0)]
    pid = ca.record_prediction("serve_step", predicted_us=10.0)
    ca.record_measurement(pid, measured_us=50.0)
    tel.record_step({"step": 1, "loss": 1.0})
    line = json.loads((tmp_path / "steps.jsonl").read_text().splitlines()[-1])
    assert line["cost_audit"]["divergence"] == 5.0
    assert tel.get_registry().gauge("cost_model_divergence").value == 5.0
    path = str(tmp_path / "persist.json")
    cal.set_active(_tables()[1])
    assert ca.get_auditor().persist_now(path) == path
    assert cal.load_table(path).digest() == _tables()[1].digest()


def test_roofline_tracks_equal_the_reference(tmp_path):
    att = ca.summarize_attribution(
        {"a/b": {"flops": 4e9, "bytes": 1e6, "ops": 3, "matmul_flops": 4e9, "kernel_flops": 0.0,
                 "kernels": 0},
         "c": {"flops": 0.0, "bytes": 5e8, "ops": 9, "matmul_flops": 0.0, "kernel_flops": 0.0,
               "kernels": 0}}, peak_flops=1e12, mem_gbps=100.0)
    assert [(r["layer"], r["bound"]) for r in att["layers"]] == [("c", "memory"),
                                                                   ("a/b", "compute")]
    assert ca.roofline_counter_events(att, pid=2, ts0=5.0) == \
        ref_ca.roofline_counter_events(att, pid=2, ts0=5.0)
    base = {"traceEvents": [{"ph": "X", "ts": 10.0, "dur": 4.0, "name": "x", "pid": 0}]}
    for name in ("port.json", "ref.json"):
        (tmp_path / name).write_text(json.dumps(base))
    assert ca.attach_roofline_tracks(str(tmp_path / "port.json"), att) == \
        ref_ca.attach_roofline_tracks(str(tmp_path / "ref.json"), att) == 2
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "ref.json").read_text())


# ------------------------------------------------------- the calibration sweep
def test_sweep_over_a_gloo_world_measures_the_references_keys():
    buckets = (1 << 10, 1 << 14)
    ref = ref_cal.calibrate(RefMesh(("dp",), (2,), devices=jax.devices()[:2]), byte_buckets=buckets,
                            reps=1, measure_matmul=False)
    rows = gloo_world(f"""
import json
from vescale_tpu_torch.mesh import init_device_mesh
from vescale_tpu_torch.telemetry.calibrate import CalibrationTable, calibrate
table = calibrate(init_device_mesh("cpu", (2,), mesh_dim_names=("dp",)),
                  byte_buckets={buckets!r}, reps=1)
back = CalibrationTable.from_json(json.loads(json.dumps(table.to_json())))
result = {{"keys": sorted([list(k) for k in table.entries]), "meta": table.meta,
           "round_trip": back.digest() == table.digest(),
           "all_positive": all(v["us"] > 0 for v in table.entries.values())}}
""")
    want = sorted([list(k) for k in ref.entries])
    for r in rows:
        assert r["keys"] == want and r["round_trip"] and r["all_positive"]
        assert r["meta"]["mesh"] == ref.meta["mesh"] and r["meta"]["platform"] == "cpu"
        assert r["meta"]["matmul_gflops"] > 0


# ---------------------------------------------------------- attribution
B, T = 2, 32
LLAMA = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)


def _llama_pair(flash):
    from vescale_tpu.models import llama as jl

    from vescale_tpu_torch.models import Llama, LlamaConfig, params_from_jax

    kw = dict(LLAMA, use_flash_attention=flash)
    jmodel = jl.Llama(jl.LlamaConfig(dtype=jnp.float32, **kw))
    params = jmodel.init(jax.random.key(0), jnp.ones((B, T), jnp.int32))["params"]
    model = Llama(LlamaConfig(dtype=torch.float32, **kw), params_from_jax(params, device="cpu"),
                  device="cpu")
    return jmodel, params, model


def _tokens():
    return np.random.default_rng(0).integers(0, 512, (B, T + 1)).astype(np.int32)


def _ref_attribution(jmodel, params):
    from vescale_tpu.models.nanogpt import cross_entropy_loss as jax_xent
    from vescale_tpu.parallel.optimizer import adamw_lowmem
    from vescale_tpu.train import make_train_step as jax_make_train_step

    tx = adamw_lowmem(1e-3)
    step = jax_make_train_step(jmodel, tx, lambda lg, b: jax_xent(lg, b["target"]), donate=False)
    toks = _tokens()
    batch = {"input": jnp.asarray(toks[:, :-1]), "target": jnp.asarray(toks[:, 1:])}
    text = step.lower(params, tx.init(params), batch).compile().as_text()
    return ref_ca.layer_attribution(text, peak_flops=1e12, mem_gbps=100.0)


def _port_step(model):
    from vescale_tpu_torch.models import cross_entropy_loss
    from vescale_tpu_torch.parallel import AdamWLowmem
    from vescale_tpu_torch.train import make_train_step

    step = make_train_step(model, AdamWLowmem(model.parameters(), 1e-3),
                           lambda lg, b: cross_entropy_loss(lg, b["target"]))
    t = torch.from_numpy(_tokens()).long()
    return step, {"input": t[:, :-1], "target": t[:, 1:]}


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_layer_attribution_matmul_flops_equal_the_references_per_layer(flash):
    jmodel, params, model = _llama_pair(flash)
    ref = _ref_attribution(jmodel, params)
    step, batch = _port_step(model)
    got = ca.layer_attribution(step, batch, peak_flops=1e12, mem_gbps=100.0)
    want = {r["layer"]: r["flops"] for r in ref["layers"] if r["flops"]}
    mine = {r["layer"]: r for r in got["layers"]}
    assert {k for k, r in mine.items() if r["matmul_flops"]} == set(want)
    H, D = LLAMA["num_attention_heads"], LLAMA["hidden_size"] // LLAMA["num_attention_heads"]
    dense_attention = 12 * B * H * T * T * D  # QK^T and PV, forward and backward
    for layer, flops in want.items():
        attention = dense_attention if (flash and layer.endswith("self_attn")) else 0
        assert mine[layer]["matmul_flops"] == flops - attention, layer
        # causal kernels: forward 2, dq 3 and dkv 4 (x B H T^2 D)
        assert mine[layer]["kernel_flops"] == (9 * B * H * T * T * D if attention else 0)
        assert mine[layer]["kernels"] == (2 if attention else 0)  # flash_fwd, flash_bwd
    assert mine["fused_adamw"]["kernels"] == 1 and mine["fused_adamw"]["matmul_flops"] == 0
    n = sum(p.numel() for p in model.parameters())
    assert mine["fused_adamw"]["kernel_flops"] == 12 * n
    ratio = got["total_bytes"] / ref["total_bytes"]
    assert 0.1 < ratio < 0.3, ratio  # stated in the module docstring, not held equal
    assert got["total_flops"] == sum(r["flops"] for r in got["layers"])
    assert all(r["bound"] in ("compute", "memory") for r in got["layers"])


def test_attribution_changes_no_number():
    """The same step twice from the same weights, once attributed: the loss
    and every parameter bitwise equal."""
    outs = []
    for attribute in (False, True):
        _, _, model = _llama_pair(True)
        step, batch = _port_step(model)
        if attribute:
            with ca.LayerAttribution(model) as att:
                loss = step(batch)
            assert att.layers
        else:
            loss = step(batch)
        outs.append((loss, [p.detach().clone() for p in model.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    assert not model._forward_hooks and not model._forward_pre_hooks


def test_kernel_wrappers_count_their_cost_and_nothing_inside():
    from vescale_tpu_torch.kernels import cross_entropy as X
    from vescale_tpu_torch.kernels import flash_attention as F
    from vescale_tpu_torch.kernels import fused_adamw as A
    from vescale_tpu_torch.kernels import paged_attention as PA

    g = torch.Generator().manual_seed(0)
    q = torch.randn(2 * 4, 16, 32, generator=g)
    kv = torch.randn(2 * 2, 16, 32, generator=g)
    args = dict(scale=0.2, causal=True, H=4, KV=2)
    with ca.LayerAttribution() as att:
        o, lse = F.flash_fwd(q, kv, kv, **args)
        F.flash_bwd(q, kv, kv, o, o, lse, **args)
    fwd_flops = 2 * 16 * 16 * 4 * 32 * 2  # causal: half of 4 T^2 H D B
    fwd_bytes = (q.numel() + 2 * kv.numel() + q.numel()) * 4 + 8 * 16 * 4
    assert F.flash_fwd_cost(q, kv, kv, **args) == (fwd_flops, fwd_bytes)
    assert att.layers["flash_fwd"] == {"flops": fwd_flops, "ops": 1, "kernels": 1,
                                       "bytes": fwd_bytes, "matmul_flops": 0.0,
                                       "kernel_flops": fwd_flops}
    fl, by = F.flash_bwd_cost(q, kv, kv, o, o, lse, **args)
    assert fl == F.flash_bwd_dq_cost(q, kv, kv, o, lse, lse, **args)[0] + \
        F.flash_bwd_dkv_cost(q, kv, kv, o, lse, lse, **args)[0] == 7 * 16 * 16 * 4 * 32 * 2 // 2 * 2
    assert att.layers["flash_bwd"]["ops"] == 1 and att.layers["flash_bwd"]["bytes"] == by
    # the counts the chip smoke's bounds divide by, at one of its shapes
    n_q, n_kv, rows = q.numel(), kv.numel(), 8 * 16
    assert F.flash_bwd_dq_cost(q, kv, kv, o, lse, lse, **args) == (
        6 * 0.5 * 16 * 16 * 4 * 32 * 2, (n_q + 2 * n_kv + n_q + n_q) * 4 + 2 * rows * 4)
    assert F.flash_bwd_dkv_cost(q, kv, kv, o, lse, lse, **args) == (
        8 * 0.5 * 16 * 16 * 4 * 32 * 2, (n_q + 2 * n_kv + n_q + 2 * n_kv) * 4 + 2 * rows * 4)
    lg = torch.randn(6, 50, generator=g).to(torch.bfloat16)
    idx = torch.arange(6)
    assert X.xent_fwd_cost(lg, idx, None) == (4 * 6 * 50, 6 * 50 * 2 + 6 * 12 + 3 * 6 * 4)
    assert X.xent_bwd_cost(lg, idx, *[None] * 4) == (5 * 6 * 50, 2 * 6 * 50 * 2 + 6 * 12 + 3 * 6 * 4)
    gs = [torch.zeros(10), torch.zeros(3, 4)]
    ms = [torch.zeros(10, dtype=torch.bfloat16), torch.zeros(3, 4, dtype=torch.bfloat16)]
    assert A.fused_adamw_cost(gs, ms, ms, 1.0, 1.0) == (12 * 22, 22 * (2 * 4 + 4 * 2))
    qd = torch.zeros(2, 4, 32)
    pool = torch.zeros(5, 4, 2, 32, dtype=torch.bfloat16)
    table = torch.zeros(2, 3, dtype=torch.int32)
    lengths = torch.tensor([5, 3], dtype=torch.int32)
    assert PA.paged_decode_cost(qd, pool, pool, table, lengths) == (
        4 * 8 * 4 * 32, 2 * 8 * 2 * 32 * 2 + qd.numel() * 4 + 6 * 4 + 2 * 4 + 2 * 4 * 32 * 4)
    assert PA.paged_decode.cost is PA.paged_decode_cost


# ========================================================= what-if scorer
def test_mesh_candidates_enumerate_factorizations():
    cands = ca.mesh_candidates(8)
    assert (1, 8, 1) in cands and (8, 1, 1) in cands and (2, 2, 2) in cands
    assert all(dp * tp * pp == 8 for dp, tp, pp in cands)
    for n in range(1, 17):
        assert ca.mesh_candidates(n) == ref_ca.mesh_candidates(n)


def test_score_candidates_ranks_and_confidence_tiers():
    ranked = ca.score_candidates(ca.mesh_candidates(8), params_bytes=1e9, activation_bytes=1e8,
                                 flops_per_step=1e12, device="cpu")
    costs = [r["predicted_step_us"] for r in ranked]
    assert len(ranked) >= 3 and costs == sorted(costs)
    scored = [r for r in ranked if r["terms"]]
    assert scored and all(t["source"] == "analytic" for r in scored for t in r["terms"])
    assert all(r["confidence"] == pytest.approx(0.25) for r in scored)
    t = cal.CalibrationTable()
    for nb in (1 << 20, 1 << 24, 1 << 27, 1 << 28):
        t.add_sample("all_reduce", 8, nb, 1e-3)
    dp8 = next(r for r in ca.score_candidates([(8, 1, 1)], params_bytes=1e9,
                                              activation_bytes=1e8, flops_per_step=1e12,
                                              table=t, device="cpu") if r["terms"])
    assert dp8["terms"][0]["source"] == "measured" and dp8["confidence"] == pytest.approx(0.5)


@pytest.mark.parametrize("with_table", [False, True])
def test_score_candidates_rank_as_the_references(monkeypatch, with_table):
    """Given the same table, the same link rate and the same compute peak
    (the table's matmul sample: both price a CPU so), the port's scores
    are the reference's number for number and rank the same.  The link
    rate is the one departure: the reference's TPU ICI figure (100 GB/s)
    against the card's NVLink datasheet default, so it is set equal."""
    from vescale_tpu_torch import collectives as C

    monkeypatch.setattr(C, "_LINK_GBPS", 100.0)
    tables = []
    for mod in (ref_cal, cal):
        t = mod.CalibrationTable(meta={"platform": "cpu", "matmul_gflops": 50.0})
        if with_table:
            for op, n in (("all_reduce", 2), ("all_gather", 4), ("ppermute", 2)):
                for nb in (1 << 20, 1 << 24, 1 << 27):
                    t.add_sample(op, n, nb, 1e-3 * n)
        mod.set_active(t)
        tables.append(t)
    kw = dict(params_bytes=2.6e9, activation_bytes=3.4e7, flops_per_step=5e13)
    for n in (2, 4, 8):
        ref = ref_ca.score_candidates(ref_ca.mesh_candidates(n), device=jax.devices()[0], **kw)
        port = ca.score_candidates(ca.mesh_candidates(n), device="cpu", **kw)
        assert port == ref


def test_cost_model_is_the_references_at_the_same_link_rate(monkeypatch):
    """``collectives``' analytic costs and ``redistribute_cost`` equal the
    reference's when both price the same link."""
    from vescale_tpu import collectives as RC
    from vescale_tpu.placements import Partial as RP, Replicate as RR, Shard as RS
    from vescale_tpu.spec import DArraySpec as RSpec, TensorMeta as RMeta
    from vescale_tpu_torch import collectives as C
    from vescale_tpu_torch.mesh import DeviceMesh
    from vescale_tpu_torch.placements import Partial, Replicate, Shard
    from vescale_tpu_torch.spec import DArraySpec, TensorMeta

    assert C._LINK_GBPS == 450.0  # H100 NVLink 4 datasheet, each way
    monkeypatch.setattr(C, "_LINK_GBPS", 100.0)
    for gb in (1e-6, 0.01, 2.5):
        for n in (1, 2, 8):
            for op in ("all_gather", "reduce_scatter", "all_to_all", "all_reduce", "ppermute"):
                assert C.analytic_cost_us(op, gb, n) == RC.analytic_cost_us(op, gb, n)
            assert C.allgather_cost(gb, n) == RC.allgather_cost(gb, n)
            assert C.allreduce_cost(gb, n) == RC.allreduce_cost(gb, n)
            assert C.reduce_scatter_cost(gb, n) == RC.reduce_scatter_cost(gb, n)
            assert C.all_to_all_cost(gb, n) == RC.all_to_all_cost(gb, n)
    rm, pm = RefMesh(("dp", "tp"), (2, 4)), DeviceMesh(("dp", "tp"), (2, 4), device_type="cpu")
    pairs = [((RP(), RS(0)), (RR(), RS(0)), (Partial(), Shard(0)), (Replicate(), Shard(0))),
             ((RS(0), RS(1)), (RS(1), RS(0)), (Shard(0), Shard(1)), (Shard(1), Shard(0))),
             ((RP(), RR()), (RS(1), RR()), (Partial(), Replicate()), (Shard(1), Replicate()))]
    for rs, rd, ps, pd in pairs:
        ref = RC.redistribute_cost(RSpec(rm, rs, RMeta((512, 256), jnp.dtype(jnp.float32))),
                                   RSpec(rm, rd, RMeta((512, 256), jnp.dtype(jnp.float32))))
        port = C.redistribute_cost(DArraySpec(pm, ps, TensorMeta((512, 256), torch.float32)),
                                   DArraySpec(pm, pd, TensorMeta((512, 256), torch.float32)))
        assert port == ref


def test_whatif_cli_ranks_meshes(tmp_path):
    import pathlib
    import subprocess
    import sys

    t = cal.CalibrationTable()
    t.add_sample("all_reduce", 8, 1 << 27, 2e-3)
    tab = tmp_path / "cal.json"
    t.save(str(tab))
    out = subprocess.run(
        [sys.executable, "-m", "vescale_tpu_torch.analysis", "--json", "whatif", "--devices", "8",
         "--table", str(tab), "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        cwd=pathlib.Path(__file__).resolve().parent.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    rep = json.loads(out.stdout)
    assert rep["num_devices"] == 8 and len(rep["candidates"]) >= 3
    costs = [c["predicted_step_us"] for c in rep["candidates"]]
    assert costs == sorted(costs)
