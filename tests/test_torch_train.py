"""The port's training path against the JAX package, on the CPU: the Llama
module against flax ``Llama.apply`` and ``jax.grad`` on the same weights,
``make_train_step`` with ``AdamWLowmem`` against ``vescale_tpu.train.
make_train_step`` with ``adamw_lowmem``, gradient accumulation, and the
trained weights served by the slice-1 ``ServeEngine``.  Small fp32
configs; inputs from numpy seeds.  The fp32 runs differ only in how the
two frameworks order their sums (and flax's attention, with
``VESCALE_KERNELS`` unset, is the dense softmax where the port recomputes
P from the logsumexp), so the bounds below are a few ulps per op,
compounded through the layers."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vescale_tpu.models import llama as jl
from vescale_tpu.models.nanogpt import cross_entropy_loss as jax_xent
from vescale_tpu.parallel.optimizer import adamw_lowmem
from vescale_tpu.train import make_train_step as jax_make_train_step

from vescale_tpu_torch import bench
from vescale_tpu_torch.kernels import LAUNCHES, ulps_at_scale
from vescale_tpu_torch.models import (
    Llama,
    LlamaConfig,
    cross_entropy_loss,
    load_params,
    module_tree,
    params_from_jax,
)
from vescale_tpu_torch.parallel import AdamWLowmem
from vescale_tpu_torch.serve import KVCacheConfig, PagedKVCache, ServeEngine
from vescale_tpu_torch.train import make_train_step

B, T = 2, 32
CONFIGS = {
    # bench.py's CPU rung config, and a GQA variant of it
    "cpu_bench": dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=64),
    "gqa": dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64),
    "tied": dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=1,
                 num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=64,
                 tie_word_embeddings=True),
    # the flax model's dense-attention branch (use_flash_attention=False)
    "dense": dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                  use_flash_attention=False),
}
# measured: logits 8.1-11.6 ulps at scale, grads 17.6-24.5, trajectories
# 3.2e-7 relative; each bound leaves about 3x room
LOGIT_ULPS = 32.0  # two layers of fp32 GEMMs and attention, sums in other orders
GRAD_ULPS = 64.0  # the backward compounds the forward's differences once more


@pytest.fixture(autouse=True)
def kernels_unset(monkeypatch):
    """The JAX reference runs its default dispatch (no Pallas kernels)."""
    monkeypatch.delenv("VESCALE_KERNELS", raising=False)


def _jax(name, seed=0):
    cfg = jl.LlamaConfig(dtype=jnp.float32, **CONFIGS[name])
    model = jl.Llama(cfg)
    params = model.init(jax.random.key(seed), jnp.ones((B, T), jnp.int32))["params"]
    return model, params


def _port(name, params, **over):
    cfg = LlamaConfig(dtype=torch.float32, **{**CONFIGS[name], **over})
    return Llama(cfg, params_from_jax(params, device="cpu"), device="cpu")


def _tokens(vocab, seed=0, batch=B):
    return np.random.default_rng(seed).integers(0, vocab, (batch, T + 1)).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_parameter_names_are_the_flax_paths(name):
    _, params = _jax(name)
    model = _port(name, params)
    flat = _flat(params)
    named = dict(model.named_parameters())
    assert set(named) == set(flat)
    for key, p in named.items():
        assert p.dtype == torch.float32 and tuple(p.shape) == flat[key].shape
        assert np.array_equal(p.detach().numpy(), flat[key])  # load_params copies exactly
    tree = module_tree(model)
    assert set(_flat(tree)) == set(flat)
    with pytest.raises(ValueError, match="missing"):
        load_params(model, {k: v for k, v in tree.items() if k != "norm"})


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_match_flax(name):
    jmodel, params = _jax(name)
    toks = _tokens(CONFIGS[name]["vocab_size"])[:, :-1]
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(toks)))
    model = _port(name, params)
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long())
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert ulps_at_scale(got.numpy(), ref) <= LOGIT_ULPS


@pytest.mark.parametrize("name", ["cpu_bench", "gqa"])
def test_loss_grads_match_jax_grad(name):
    jmodel, params = _jax(name)
    toks = _tokens(CONFIGS[name]["vocab_size"], seed=1)

    def loss(p):
        return jax_xent(jmodel.apply({"params": p}, jnp.asarray(toks[:, :-1])), jnp.asarray(toks[:, 1:]))

    ref_loss, ref = jax.value_and_grad(loss)(params)
    model = _port(name, params)
    t = torch.from_numpy(toks).long()
    out = cross_entropy_loss(model(t[:, :-1]), t[:, 1:])
    out.backward()
    assert abs(float(out.detach()) - float(ref_loss)) <= 4 * np.spacing(np.float32(float(ref_loss)))
    ref = _flat(ref)
    for key, p in model.named_parameters():
        assert ulps_at_scale(p.grad.numpy(), ref[key]) <= GRAD_ULPS, key


def _jax_trajectory(name, steps, lr):
    jmodel, params = _jax(name)
    tx = adamw_lowmem(lr)
    step = jax_make_train_step(jmodel, tx, lambda lg, b: jax_xent(lg, b["target"]), donate=False)
    toks = jnp.asarray(_tokens(CONFIGS[name]["vocab_size"], seed=2))
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
    p, s, losses = params, tx.init(params), []
    for _ in range(steps):
        p, s, loss = step(p, s, batch)
        losses.append(float(loss))
    return params, losses


def _torch_trajectory(name, params, steps, lr, grad_accum_steps=1, state_dtype=torch.bfloat16):
    model = _port(name, params)
    opt = AdamWLowmem(model.parameters(), lr, state_dtype=state_dtype)
    step = make_train_step(model, opt, lambda lg, b: cross_entropy_loss(lg, b["target"]),
                           grad_accum_steps=grad_accum_steps)
    toks = torch.from_numpy(_tokens(CONFIGS[name]["vocab_size"], seed=2)).long()
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
    return model, [float(step(batch)) for _ in range(steps)]


@pytest.mark.parametrize("name", ["cpu_bench", "gqa"])
def test_five_step_trajectory_matches_jax_make_train_step(name):
    """Bound: 1e-5 relative per step.  The first loss differs by fp32
    rounding only; later ones also by bf16 moment roundings that the
    frameworks' last-bit grad differences can tip either way."""
    params, ref = _jax_trajectory(name, 5, 1e-3)
    _, got = _torch_trajectory(name, params, 5, 1e-3)
    assert ref[-1] < ref[0] - 0.05  # the trajectory moves
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)


def test_grad_accum_two_equals_one_full_batch():
    """Two micro-batches of 1 against one batch of 2: the same mean loss and
    fp32 grads up to rounding, so the same steps (fp32 moments here, so no
    bf16 rounding of a moment can tip either way).  Params within 1e-5, 1%
    of one step's lr: Adam's normalised update turns the last-bit grad
    differences of near-zero grads into visible ones (measured 1.1e-6)."""
    _, params = _jax("gqa")
    full, l_full = _torch_trajectory("gqa", params, 2, 1e-3, state_dtype=torch.float32)
    accum, l_acc = _torch_trajectory("gqa", params, 2, 1e-3, grad_accum_steps=2,
                                     state_dtype=torch.float32)
    np.testing.assert_allclose(l_acc, l_full, rtol=1e-6, atol=0)
    for (key, a), (_, b) in zip(accum.named_parameters(), full.named_parameters()):
        assert torch.allclose(a, b, rtol=0, atol=1e-5), key


def test_has_aux_reduces_micro_batch_metrics():
    _, params = _jax("gqa")
    model = _port("gqa", params)
    opt = AdamWLowmem(model.parameters(), 1e-3)

    def loss_fn(logits, b):
        loss = cross_entropy_loss(logits, b["target"])
        return loss, {"tokens": torch.tensor(b["target"].numel()), "loss": loss}

    step = make_train_step(model, opt, loss_fn, has_aux=True, grad_accum_steps=2)
    toks = torch.from_numpy(_tokens(512, seed=3)).long()
    loss, aux = step({"input": toks[:, :-1], "target": toks[:, 1:]})
    assert int(aux["tokens"]) == B * T  # integer counts sum
    assert abs(float(aux["loss"]) - float(loss)) <= 1e-6 * float(loss)  # floats average
    assert not aux["loss"].requires_grad
    with pytest.raises(ValueError, match="divisible"):
        make_train_step(model, opt, loss_fn, has_aux=True, grad_accum_steps=3)(
            {"input": toks[:, :-1], "target": toks[:, 1:]})


def test_trained_weights_serve_the_same_logits():
    """Weights trained by the port go into the slice-1 ServeEngine: its
    first prefill logits equal the module's forward on the prompt at the
    last position, within the logits bound (the engine pads the prompt to
    its cache length, so its products have other shapes)."""
    _, params = _jax("gqa")
    model, _ = _torch_trajectory("gqa", params, 2, 1e-3)
    c = model.config
    kc = KVCacheConfig(layers=c.num_hidden_layers, kv_heads=c.num_key_value_heads, head_dim=c.head_dim,
                       num_slots=2, page_size=8, pages_per_slot=8)
    eng = ServeEngine(c, module_tree(model), PagedKVCache(kc, device="cpu"), device="cpu")
    prompt = [int(x) for x in _tokens(c.vocab_size, seed=4)[0, :19]]
    slot = eng.cache.alloc(len(prompt), 1)
    served = eng.prefill(prompt, slot)
    with torch.no_grad():
        ref = model(torch.tensor([prompt]))[0, -1].numpy()
    assert served.shape == ref.shape
    assert ulps_at_scale(served, ref) <= LOGIT_ULPS


@pytest.mark.parametrize("scope", ["block", "mlp"])
def test_remat_recomputes_the_same_grads(scope):
    _, params = _jax("gqa")
    toks = torch.from_numpy(_tokens(512, seed=5)).long()
    grads = []
    for over in ({}, {"remat": True, "remat_scope": scope}):
        model = _port("gqa", params, **over)
        cross_entropy_loss(model(toks[:, :-1]), toks[:, 1:]).backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("option", [dict(scan_layers=True), dict(remat=True, remat_policy="dots_saveable"),
                                    dict(use_fp8=True)])
def test_unported_options_raise(option):
    """``scan_layers``, ``remat_policy`` and ``use_fp8`` are ported.  The
    first two build and give the plain model's logits on the same weights
    (tests/test_torch_scan_layers.py holds them to the reference); an fp8
    model takes the two-collection bundle and refuses a plain tree
    (tests/test_torch_fp8.py holds it to the reference)."""
    cfg = LlamaConfig(dtype=torch.float32, **{**CONFIGS["tied"], **option})
    if "use_fp8" in option:
        from vescale_tpu_torch.models import init_params

        bundle = init_params(cfg, 0, device="cpu")
        assert set(bundle) == {"params", "_overwrite_with_gradient"}
        Llama(cfg, bundle, device="cpu")
        with pytest.raises(ValueError, match="bundle"):
            Llama(cfg, bundle["params"], device="cpu")
        return
    from vescale_tpu_torch.models import init_params, scan_tree

    base = LlamaConfig(dtype=torch.float32, **CONFIGS["tied"])
    params = init_params(base, 0, device="cpu")
    if cfg.scan_layers:
        params = scan_tree(params, cfg.num_hidden_layers)
    toks = torch.arange(8).reshape(1, 8)
    assert torch.equal(Llama(cfg, params, device="cpu")(toks),
                       Llama(base, init_params(base, 0, device="cpu"), device="cpu")(toks))


def test_entry_points_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Llama(LlamaConfig(dtype=torch.float32, **CONFIGS["tied"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.prepare("1.3b")


def test_bench_cpu_rung_prints_one_json_line(capsys):
    LAUNCHES["fused_adamw"] = 0
    assert bench.main(["--rung", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["rung"] == "cpu" and out["device"] == "cpu" and out["mfu"] is None
    assert out["params"] == 459392 and len(out["losses"]) == 7 and np.isfinite(out["losses"]).all()
    assert out["launches_per_step"] == [{k: 0 for k in LAUNCHES}] * 5


def test_bench_leaf_count_and_peak(monkeypatch):
    from vescale_tpu_torch.models import param_shapes

    fields, Bb, Tb, _, _ = bench.RUNGS["1.3b"]
    shapes = []

    def walk(node):
        for v in node.values():
            walk(v) if isinstance(v, dict) else shapes.append(v)

    walk(param_shapes(LlamaConfig(**fields)))
    assert len(shapes) == 24 * 9 + 3 and (Bb, Tb) == (1, 4096)
    assert sum(int(np.prod(s)) for s in shapes) == 1263634432
    for name, peak in (("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a, name=name: name)
        assert bench.peak_bf16_flops(0) == peak
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(RuntimeError, match="no bf16 peak"):
        bench.peak_bf16_flops(0)
