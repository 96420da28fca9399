"""The port's step report on the CPU, and its AOT-drift leg against the JAX
package's.

The port measures one run of the step where the reference compiles it
(a stated departure): ``flops`` and ``bytes_accessed`` are the layer
attribution's totals, ``peak_bytes`` is the card's allocator peak (None on
the CPU), ``collectives`` the delta of ``collectives.CALLS`` over the
step, the compile-time keys come back None, and ``shardcheck`` is the
placement analysis of the step's model forward, traced on ``meta``.
``compare_with_aot`` is the reference's on the same report and AOT
document; ``telemetry.write_step_report`` writes the file, sets the
gauges, ledgers the AOT budget and raises the drift alert.
"""

import json

import numpy as np
import pytest
import torch

from vescale_tpu.telemetry.memory_report import compare_with_aot as ref_compare

from vescale_tpu_torch import telemetry as tel
from vescale_tpu_torch.models import Llama, LlamaConfig, cross_entropy_loss
from vescale_tpu_torch.parallel import AdamWLowmem
from vescale_tpu_torch.telemetry import alerts, costaudit
from vescale_tpu_torch.telemetry.memory_report import compare_with_aot
from vescale_tpu_torch.telemetry.step_report import (build_step_report, read_step_report,
                                                      write_step_report)
from vescale_tpu_torch.train import make_train_step

from test_torch_ndtimeline import all_dormant, reset_all

CFG = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
           num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=32)


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    reset_all()
    assert all_dormant()


def _step(seed=0):
    torch.manual_seed(seed)
    model = Llama(LlamaConfig(dtype=torch.float32, **CFG), device="cpu")
    step = make_train_step(model, AdamWLowmem(model.parameters(), 1e-3),
                           lambda lg, b: cross_entropy_loss(lg, b["target"]))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (2, 17))).long()
    return model, step, {"input": toks[:, :-1], "target": toks[:, 1:]}


def test_report_keys_and_measured_values():
    model, step, batch = _step()
    rep = build_step_report(step, batch, name="tiny")
    assert rep["name"] == "tiny" and rep["platform"] == "cpu" and rep["num_devices"] == 1
    assert rep["peak_bytes"] is None and rep["collectives"] == {}
    assert rep["shardcheck"]["name"] == "tiny" and rep["shardcheck"]["n_findings"] == 0
    for key in ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
                "generated_code_bytes"):
        assert rep[key] is None
    att = rep["layer_attribution"]
    assert rep["flops"] == att["total_flops"] > 0 and rep["bytes_accessed"] == att["total_bytes"]
    layers = {r["layer"] for r in att["layers"]}
    assert {"layers_0/self_attn", "layers_1/mlp", "lm_head", "fused_adamw"} <= layers
    # the matmuls of a step: 6 x params x tokens for the projections and the
    # head, plus the attention kernels' own count
    tokens, hd = 2 * 16, CFG["hidden_size"] // CFG["num_attention_heads"]
    proj = sum(p.numel() for n, p in model.named_parameters()
               if n.endswith("kernel") and "embed" not in n)
    matmul = sum(r["matmul_flops"] for r in att["layers"])
    assert matmul == 6 * proj * tokens
    kernel = sum(r["kernel_flops"] for r in att["layers"] if r["layer"].endswith("self_attn"))
    assert kernel == 2 * 9 * 2 * CFG["num_attention_heads"] * 16 * 16 * hd
    assert json.loads(json.dumps(rep, default=str))["name"] == "tiny"


def test_report_run_is_the_step_it_measures():
    """A report's run is one real step: the same loss and weights as a
    plain step from the same start."""
    model_a, step_a, batch = _step()
    model_b, step_b, _ = _step()
    build_step_report(step_a, batch)
    step_b(batch)
    for a, b in zip(model_a.parameters(), model_b.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(step_a(batch), step_b(batch))


def _aot(bytes_):
    return {"measured": {"per_device_bytes_fp32_compile": bytes_}}


@pytest.mark.parametrize("aot", [_aot(1000.0), _aot(1500.0), {"bf16_basis_memory": {
    "total_bytes": 800.0}}, {}, "missing"])
def test_compare_with_aot_equals_the_reference(aot, tmp_path):
    report = {"peak_bytes": 1050.0, "argument_bytes": None, "temp_bytes": 3}
    if aot == "missing":
        aot = str(tmp_path / "none.json")
    assert compare_with_aot(report, aot) == ref_compare(report, aot)
    assert compare_with_aot({"peak_bytes": None}, _aot(1.0)) is None
    path = tmp_path / "aot.json"
    path.write_text(json.dumps(_aot(1000.0)))
    assert compare_with_aot(report, str(path)) == ref_compare(report, str(path))


def test_write_step_report_files_gauges_ledger_and_drift_alert(tmp_path, monkeypatch):
    import vescale_tpu_torch.telemetry.step_report as sr

    model, step, batch = _step()
    assert tel.write_step_report("train", step, batch) is None  # dormant
    tel.init(out_dir=str(tmp_path), memtrack=False)
    real = sr.build_step_report

    def with_peak(*a, **k):  # a card's report: the CPU has no allocator peak
        rep = real(*a, **k)
        rep["peak_bytes"] = 2.0e6
        if k.get("aot_report") is not None:
            rep["aot_drift"] = compare_with_aot(rep, k["aot_report"])
        return rep

    monkeypatch.setattr(sr, "build_step_report", with_peak)
    rep = tel.write_step_report("train", step, batch, aot_report=_aot(1.0e6))
    on_disk = read_step_report(str(tmp_path / "train_report.json"))
    assert on_disk["flops"] == rep["flops"] and tel.get_state().last_step_report is rep
    reg = tel.get_registry()
    assert reg.gauge("step_report_train_flops").value == rep["flops"]
    assert reg.gauge("step_report_train_peak_bytes").value == 2.0e6
    assert reg.gauge("step_report_train_aot_drift_frac").value == 1.0
    assert "aot-drift-train" in alerts.digest()["firing"]
    kinds = [r["kind"] for r in costaudit.get_auditor().ledger()]
    assert kinds == ["aot_memory"] and costaudit.get_auditor().ledger()[0]["divergence"] == 2.0
    tel.write_step_report("train", step, batch, aot_report=_aot(2.0e6))
    assert "aot-drift-train" not in alerts.digest()["firing"]
    assert write_step_report({"a": 1}, str(tmp_path / "x" / "r.json")).endswith("r.json")
