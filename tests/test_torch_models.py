"""The port's model pieces against the JAX package, on the CPU: the config
and its presets, RMSNorm, rotary embeddings, and the parameter tree taken
from a flax-initialised Llama (MHA and GQA)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vescale_tpu.models import llama as jl
from vescale_tpu.serve.engine import _rmsnorm as jax_engine_rmsnorm

from vescale_tpu_torch.kernels import ulps_at_scale
from vescale_tpu_torch.models import llama as tl
from vescale_tpu_torch.models import init_params, param_shapes, params_from_jax, tree_to

ULP_BOUND = 8.0

TINY = {
    "mha": dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=64),
    "gqa": dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64),
    "tied": dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=1,
                 num_attention_heads=4, num_key_value_heads=2, tie_word_embeddings=True),
}


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}


@pytest.mark.parametrize("name", ["LLAMA2_7B", "OPEN_LLAMA_3B", "LLAMA3_8B", "LLAMA3_70B", "LLAMA3_405B"])
def test_presets_equal_the_jax_packages(name):
    assert _fields(getattr(tl, name)) == _fields(getattr(jl, name))
    assert getattr(tl, name).head_dim == getattr(jl, name).head_dim


def test_config_validation_matches():
    for bad in (dict(remat_policy="dots_saveable"), dict(remat_scope="mlp"), dict(remat_scope="x")):
        with pytest.raises(ValueError):
            jl.LlamaConfig(**bad)
        with pytest.raises(ValueError):
            tl.LlamaConfig(**bad)
    # the training options are accepted (and inert in the serve slice)
    tl.LlamaConfig(remat=True, remat_scope="mlp", scan_layers=True, use_fp8=True)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_rmsnorm_matches_flax_and_engine(eps):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32) * 3.0
    w = rng.normal(size=(32,)).astype(np.float32)
    ref = jl.RMSNorm(eps, jnp.float32).apply({"params": {"weight": jnp.asarray(w)}}, jnp.asarray(x))
    got = tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), eps)
    assert got.dtype == torch.float32
    assert ulps_at_scale(got.numpy(), np.asarray(ref)) <= ULP_BOUND
    eng = jax_engine_rmsnorm(jnp.asarray(x), jnp.asarray(w), eps)
    assert ulps_at_scale(got.numpy(), np.asarray(eng)) <= ULP_BOUND


@pytest.mark.parametrize("theta,T", [(10000.0, 64), (500000.0, 1024)])
def test_rotary_matches_jax(theta, T):
    """fp32 phases: cos/sin of angles up to T radians, whose last-place
    rounding differs between XLA's and PyTorch's math libraries."""
    rng = np.random.default_rng(1)
    B, H, KV, hd = 2, 4, 2, 16
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    pos = np.tile(np.arange(T, dtype=np.int32)[None], (B, 1))
    jq, jk = jl.rotary(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), theta)
    tq, tk = tl.rotary(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(pos), theta)
    # an angle a carries fp32 rounding of |a| * 2^-24; at a = T that is
    # T / 2 ulps of the unit-scale result
    bound = max(ULP_BOUND, T / 2)
    assert ulps_at_scale(tq.numpy(), np.asarray(jq)) <= bound
    assert ulps_at_scale(tk.numpy(), np.asarray(jk)) <= bound
    # position 0 is the identity in both
    assert np.array_equal(tq.numpy()[:, 0], q[:, 0])


def _flax_params(shape):
    cfg = jl.LlamaConfig(dtype=jnp.float32, **shape)
    params = jl.Llama(cfg).init(jax.random.key(3), jnp.ones((1, 4), jnp.int32))["params"]
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if hasattr(v, "items"):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


@pytest.mark.parametrize("shape", sorted(TINY))
def test_params_from_jax_copies_the_flax_tree_exactly(shape):
    _, params = _flax_params(TINY[shape])
    got = params_from_jax(params, device="cpu")
    flat_j, flat_t = _flatten(params), _flatten(got)
    assert sorted(flat_j) == sorted(flat_t)
    for path, arr in flat_j.items():
        t = flat_t[path]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert tuple(t.shape) == arr.shape and t.dtype == torch.float32
        assert np.array_equal(t.numpy(), arr), path
    bf = params_from_jax(params, device="cpu", dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in _flatten(bf).values())


@pytest.mark.parametrize("shape", sorted(TINY))
def test_init_params_has_the_flax_layout(shape):
    """init_params draws the tree the flax model would init: same paths,
    same (in, out) kernel shapes."""
    jcfg, params = _flax_params(TINY[shape])
    tcfg = tl.LlamaConfig(dtype=torch.float32, **TINY[shape])
    got = init_params(tcfg, seed=0, device="cpu")
    flat_j, flat_t = _flatten(params), _flatten(got)
    assert sorted(flat_j) == sorted(flat_t)
    for path, arr in flat_j.items():
        assert tuple(flat_t[path].shape) == arr.shape, path
    shapes = _flatten(param_shapes(tcfg))
    assert {p: tuple(s) for p, s in shapes.items()} == {p: a.shape for p, a in flat_j.items()}
    # seeded: the same seed gives the same tree; another seed does not
    again = _flatten(init_params(tcfg, seed=0, device="cpu"))
    other = _flatten(init_params(tcfg, seed=1, device="cpu"))
    emb = "embed_tokens.embedding"
    assert torch.equal(again[emb], flat_t[emb]) and not torch.equal(other[emb], flat_t[emb])
    assert torch.all(flat_t["norm.weight"] == 1)
    moved = _flatten(tree_to(got, "cpu", torch.bfloat16))
    assert all(t.dtype == torch.bfloat16 for t in moved.values())
