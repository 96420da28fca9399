"""The port's nanoGPT against the JAX package, on the CPU: the ``GPT``
module against flax ``GPT.apply`` and ``jax.grad`` on the same weights
(fp32 and bf16, flash attention on and off), the parameter tree and its
conversion, and a 5-step trajectory of ``make_train_step`` with
``AdamWLowmem`` and ``vocab_parallel_cross_entropy`` against the
reference's ``make_train_step`` with ``adamw_lowmem`` and its
``vocab_parallel_cross_entropy`` under ``VESCALE_KERNELS=interpret``.
Small configs (2 layers, width 128, head_dim 64); inputs from numpy seeds.

Bounds, each about 3x to 5x the measured value: fp32 logits 32 ulps at
scale (measured 6.5: two layers of GEMMs, LayerNorm statistics and
attention, sums in other orders); bf16 logits 4 bf16 steps at scale
(measured 1.25: the frameworks round bf16 GELU, softmax and the residual
adds at different places); fp32 grads 64 ulps (measured 13.25: the
backward compounds the forward's differences once more); trajectories
1e-5 relative per step, as the Llama's (measured 3.1e-7).
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vescale_tpu.loss import vocab_parallel_cross_entropy as jax_vpce
from vescale_tpu.models import nanogpt as jg
from vescale_tpu.parallel.optimizer import adamw_lowmem
from vescale_tpu.train import make_train_step as jax_make_train_step

from vescale_tpu_torch import bench
from vescale_tpu_torch.kernels import LAUNCHES, ulps_at_scale
from vescale_tpu_torch.loss import vocab_parallel_cross_entropy
from vescale_tpu_torch.models import (
    GPT,
    GPTConfig,
    init_params,
    load_params,
    module_tree,
    param_shapes,
    params_from_jax,
)
from vescale_tpu_torch.parallel import AdamWLowmem
from vescale_tpu_torch.train import make_train_step

from torch_reset import dormant_module, dormant_test  # noqa: F401 (autouse: both packages dormant)

B, T = 2, 32
CONFIGS = {
    "small": dict(block_size=64, vocab_size=256, n_layer=2, n_head=2, n_embd=128),
    "nobias": dict(block_size=64, vocab_size=256, n_layer=1, n_head=2, n_embd=128, bias=False),
}
LOGIT_ULPS = 32.0
BF16_LOGIT_STEPS = 4.0
GRAD_ULPS = 64.0
BF16_STEP = 2.0 ** 16  # one bf16 step in fp32 ulps at the same scale


@pytest.fixture(autouse=True)
def kernels_unset(monkeypatch):
    """The JAX reference runs its default dispatch unless a test sets it."""
    monkeypatch.delenv("VESCALE_KERNELS", raising=False)


def _tokens(vocab, seed=0, batch=B):
    return np.random.default_rng(seed).integers(0, vocab, (batch, T + 1)).astype(np.int32)


_PARAMS = {}


def _jax_params(name):
    """flax ``GPT.init`` params of config ``name`` (seed 0), made once."""
    if name not in _PARAMS:
        model = jg.GPT(jg.GPTConfig(**CONFIGS[name]))
        init = jax.jit(model.init)
        _PARAMS[name] = init(jax.random.key(0), jnp.ones((B, T), jnp.int32))["params"]
    return _PARAMS[name]


def _jax_model(name, dtype=jnp.float32, flash=True):
    return jg.GPT(jg.GPTConfig(dtype=dtype, use_flash_attention=flash, **CONFIGS[name]))


def _port(name, params, dtype=torch.float32, flash=True):
    cfg = GPTConfig(dtype=dtype, use_flash_attention=flash, **CONFIGS[name])
    return GPT(cfg, params_from_jax(params, device="cpu"), device="cpu")


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
    params = _jax_params(name)
    model = _port(name, params)
    flat = _flat(params)
    named = dict(model.named_parameters())
    assert set(named) == set(flat)
    for key, p in named.items():
        assert p.dtype == torch.float32 and tuple(p.shape) == flat[key].shape
        assert np.array_equal(p.detach().numpy(), flat[key])  # params_from_jax carries it exactly
    assert set(_flat(module_tree(model))) == set(flat)
    shapes = _flat(param_shapes(GPTConfig(**CONFIGS[name])))
    assert {k: tuple(v) for k, v in shapes.items()} == {k: v.shape for k, v in flat.items()}
    with pytest.raises(ValueError, match="missing"):
        load_params(model, {k: v for k, v in module_tree(model).items() if k != "ln_f"})


def test_gpt2_124m_has_the_published_parameter_count():
    def count(node):
        return sum(count(v) for v in node.values()) if isinstance(node, dict) else int(np.prod(node))

    assert count(param_shapes(GPTConfig())) == 124_475_904  # the tied head counted once
    assert GPTConfig() == GPTConfig(block_size=1024, vocab_size=50304, n_layer=12, n_head=12,
                                    n_embd=768, dropout=0.0, bias=True)


def test_init_params_follows_flax_defaults():
    cfg = GPTConfig(**CONFIGS["small"])
    a = _flat(init_params(cfg, seed=3, device="cpu"))
    b = _flat(init_params(cfg, seed=3, device="cpu"))
    assert all(np.array_equal(a[k], b[k]) for k in a)  # the seed fixes the tree
    assert np.all(a["h_0.ln_1.scale"] == 1.0) and np.all(a["h_0.ln_1.bias"] == 0.0)
    assert np.all(a["h_1.attn.c_attn.bias"] == 0.0)
    std = a["h_0.mlp.c_proj.kernel"].std()
    assert abs(std - 1 / np.sqrt(4 * 128)) < 0.1 / np.sqrt(4 * 128)  # lecun-normal scale
    assert abs(a["wte.embedding"].std() - 1 / np.sqrt(128)) < 0.1 / np.sqrt(128)


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_flax(dtype, flash):
    params = _jax_params("small")
    toks = _tokens(256)[:, :-1]
    jmodel = _jax_model("small", getattr(jnp, dtype), flash)
    ref = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(toks)).astype(jnp.float32))
    model = _port("small", params, getattr(torch, dtype), flash)
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long())
    assert got.shape == ref.shape and got.dtype == getattr(torch, dtype)
    bound = LOGIT_ULPS if dtype == "float32" else BF16_LOGIT_STEPS * BF16_STEP
    assert ulps_at_scale(got.float().numpy(), ref) <= bound


def test_nobias_logits_match_flax():
    params = _jax_params("nobias")
    toks = _tokens(256, seed=6)[:, :-1]
    ref = np.asarray(_jax_model("nobias").apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = _port("nobias", params)(torch.from_numpy(toks).long())
    assert ulps_at_scale(got.numpy(), ref) <= LOGIT_ULPS


@pytest.mark.parametrize("flash", [True, False])
def test_loss_grads_match_jax_grad(flash):
    """Through each package's ``vocab_parallel_cross_entropy``: the
    reference's XLA path (``VESCALE_KERNELS`` unset), the port's plain
    versions of the fused kernels."""
    params = _jax_params("small")
    toks = _tokens(256, seed=1)
    jmodel = _jax_model("small", flash=flash)

    def loss(p):
        return jax_vpce(jmodel.apply({"params": p}, jnp.asarray(toks[:, :-1])), jnp.asarray(toks[:, 1:]))

    ref_loss, ref = jax.jit(jax.value_and_grad(loss))(params)
    model = _port("small", params, flash=flash)
    t = torch.from_numpy(toks).long()
    out = vocab_parallel_cross_entropy(model(t[:, :-1]), t[:, 1:])
    out.backward()
    assert abs(float(out.detach()) - float(ref_loss)) <= 4 * np.spacing(np.float32(float(ref_loss)))
    ref = _flat(ref)
    for key, p in model.named_parameters():
        assert ulps_at_scale(p.grad.numpy(), ref[key]) <= GRAD_ULPS, key


def test_five_step_trajectory_matches_jax_make_train_step(monkeypatch):
    """The reference with every Pallas kernel interpreted (flash forward and
    backward, fused cross entropy, fused AdamW) against the port's plain
    versions, bf16 moments on both sides."""
    params = _jax_params("small")
    toks = _tokens(256, seed=2)
    monkeypatch.setenv("VESCALE_KERNELS", "interpret")
    jmodel = _jax_model("small")
    tx = adamw_lowmem(1e-3)
    step = jax_make_train_step(jmodel, tx, lambda lg, b: jax_vpce(lg, b["target"]), donate=False)
    jbatch = {"input": jnp.asarray(toks[:, :-1]), "target": jnp.asarray(toks[:, 1:])}
    p, s, ref = params, tx.init(params), []
    for _ in range(5):
        p, s, loss = step(p, s, jbatch)
        ref.append(float(loss))

    model = _port("small", params)
    opt = AdamWLowmem(model.parameters(), 1e-3, state_dtype=torch.bfloat16)
    tstep = make_train_step(model, opt, lambda lg, b: vocab_parallel_cross_entropy(lg, b["target"]))
    t = torch.from_numpy(toks).long()
    got = [float(tstep({"input": t[:, :-1], "target": t[:, 1:]})) for _ in range(5)]
    assert ref[-1] < ref[0] - 0.5  # the trajectory moves
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)


def test_tied_head_gradient_sums_lookup_and_head():
    """wte is one fp32 master: its gradient is the lookup's plus the head's,
    as flax sums the two uses of one parameter."""
    params = _jax_params("small")
    toks = torch.from_numpy(_tokens(256, seed=4)).long()
    model = _port("small", params)
    vocab_parallel_cross_entropy(model(toks[:, :-1]), toks[:, 1:]).backward()
    full = model.wte.embedding.grad.clone()
    # the head alone: gradient through attend, with the lookup's input detached
    model.zero_grad(set_to_none=True)
    x = model.wte(toks[:, :-1]).detach() + model.wpe(torch.arange(T))[None]
    for i in range(2):
        x = getattr(model, f"h_{i}")(x)
    vocab_parallel_cross_entropy(model.wte.attend(model.ln_f(x)), toks[:, 1:]).backward()
    head = model.wte.embedding.grad
    lookup = full - head
    used = torch.zeros(256, dtype=torch.bool)
    used[toks[:, :-1].flatten()] = True
    assert lookup[~used].abs().max() <= 1e-6 * full.abs().max()  # the lookup touches only its rows
    assert lookup[used].abs().max() > 1e-3 * full.abs().max()


def test_dropout_is_not_ported_yet():
    """Dropout is ported now (``tests/test_torch_dropout.py`` holds its
    masks to flax's): a GPT with ``dropout > 0`` builds, its deterministic
    forward (the default) is bitwise the dropout-free model's, and a
    non-deterministic forward without the "dropout" rng refuses, as flax's
    ``make_rng`` does."""
    params = init_params(GPTConfig(**CONFIGS["nobias"]), 0, device="cpu", dtype=torch.float32)
    model = GPT(GPTConfig(dropout=0.1, **CONFIGS["nobias"]), params, device="cpu")
    plain = GPT(GPTConfig(**CONFIGS["nobias"]), params, device="cpu")
    x = torch.from_numpy(_tokens(256)[:, :-1]).long()
    with torch.no_grad():
        assert torch.equal(model(x), plain(x))
    with pytest.raises(ValueError, match="rng"):
        model(x, deterministic=False)


def test_bench_gpt_cpu_rung_prints_one_json_line(capsys):
    before = dict(LAUNCHES)
    assert bench.main(["--rung", "gpt_cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["rung"] == "gpt_cpu" and out["device"] == "cpu" and out["mfu"] is None
    cfg = GPTConfig(**bench.GPT_RUNGS["gpt_cpu"][0])
    assert out["params"] == 478720 and out["tokens_per_step"] == 2 * 128
    assert out["flops_per_token"] == 6 * 478720 + 12 * cfg.n_layer * 128 * cfg.n_embd
    losses = out["losses"]
    assert len(losses) == 7 and np.isfinite(losses).all() and losses[-1] < losses[2] < losses[0]
    assert LAUNCHES == before  # the CPU rung runs the plain versions


def test_bench_gpt2_rung_is_the_published_recipe():
    fields, Bb, Tb, state_dtype, _ = bench.GPT_RUNGS["gpt2"]
    cfg = GPTConfig(**fields)
    assert (Bb, Tb, state_dtype) == (12, 1024, torch.bfloat16)
    assert cfg == GPTConfig(dtype=torch.bfloat16, use_flash_attention=True)


def test_token_file_is_seeded_zipf_below_the_vocab(tmp_path):
    a = bench.write_token_file(str(tmp_path / "a.bin"), 10_000, 50304, seed=1)
    b = bench.write_token_file(str(tmp_path / "b.bin"), 10_000, 50304, seed=1)
    ta, tb = np.fromfile(a, np.uint16), np.fromfile(b, np.uint16)
    assert np.array_equal(ta, tb) and ta.size == 10_000 and ta.max() < 50304
    counts = np.sort(np.bincount(ta))[::-1]
    assert counts[0] > 20 * counts[100]  # skewed: a unigram distribution to learn
