"""The numerics of the bf16 tensor-core flash backward, on the CPU.

For bf16 inputs the port's dq and dkv kernels (``csrc/flash_bwd.cu``, the
``wgmma`` kernels) round P and dS to bf16 before the dV, dK and dQ
products, where the JAX package's Pallas kernels keep them in fp32.
``flash_bwd_reference(pd_dtype=torch.bfloat16)`` models that rounding; the
kernels are held to it on the card by ``chip_smoke.py``.  These tests show
on the CPU that the departure fits the bound stated for the kernels: the
model is within 2 bf16 steps at scale (``ulps_at_scale`` / 2^16) of the
reference run in float64 and of the JAX package's dense backward
(``ops/flash_attention.py::_xla_bwd_4d``) on the same bf16 inputs.  And
``pd_dtype=None``, the default, is still the unrounded function, bit for
bit.  Inputs are made with numpy from a seed.
"""

import importlib
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vescale_tpu_torch.kernels import ulps_at_scale
from vescale_tpu_torch.kernels.flash_attention import flash_bwd_reference, flash_fwd_reference

jax_ops = importlib.import_module("vescale_tpu.ops.flash_attention")

BF16_STEP = 2.0 ** 16  # one bf16 step in fp32 ulps at the same scale
BOUND = 2 * BF16_STEP

CASES = [
    pytest.param(T, D, rep, causal, id=f"T{T}-D{D}-rep{rep}-{'causal' if causal else 'full'}")
    for T in (64, 257, 1000)
    for D in (64, 128)
    for rep in (1, 2)
    for causal in (True, False)
]


def _to3(x):
    B, T, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, T, D).contiguous()


def _from3(x, B):
    BH, T, D = x.shape
    return x.reshape(B, BH // B, T, D).permute(0, 2, 1, 3)


def _inputs(T, D, rep, causal, dtype=torch.bfloat16):
    """(B, T, H, D) q and do, (B, T, KV, D) k and v in ``dtype``, o (B*H, T,
    D) in ``dtype`` and lse (B, H, T) fp32 from the port's plain forward."""
    B, KV = 1, 2
    H = KV * rep
    rng = np.random.default_rng(T * 100 + D + 10 * rep + causal)
    q, do = (torch.from_numpy(rng.normal(size=(B, T, H, D)).astype(np.float32)).to(dtype)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, T, KV, D)).astype(np.float32)).to(dtype)
            for _ in range(2))
    args = dict(scale=1.0 / math.sqrt(D), causal=causal, H=H, KV=KV)
    o3, lse = flash_fwd_reference(_to3(q), _to3(k), _to3(v), **args)
    return q, k, v, do, o3, lse, args


def _model(q, k, v, do, o3, lse, args):
    return flash_bwd_reference(_to3(q), _to3(k), _to3(v), o3, _to3(do), lse,
                               pd_dtype=torch.bfloat16, **args)


@pytest.mark.parametrize("T, D, rep, causal", CASES)
def test_bf16_pd_model_within_two_steps_of_float64(T, D, rep, causal):
    q, k, v, do, o3, lse, args = _inputs(T, D, rep, causal)
    model = _model(q, k, v, do, o3, lse, args)
    exact = flash_bwd_reference(*(t.double() for t in (_to3(q), _to3(k), _to3(v), o3, _to3(do))),
                                lse.double(), **args)
    for name, m, e in zip(("dq", "dk", "dv"), model, exact):
        assert m.dtype == torch.bfloat16 and torch.isfinite(m.float()).all()
        steps = ulps_at_scale(m.double().numpy(), e.numpy()) / BF16_STEP
        assert steps <= BOUND / BF16_STEP, f"{name}: {steps} bf16 steps from float64"


@pytest.mark.parametrize("T, D, rep, causal", CASES)
def test_bf16_pd_model_within_two_steps_of_xla_bwd_4d(T, D, rep, causal):
    q, k, v, do, o3, lse, args = _inputs(T, D, rep, causal)
    B = q.shape[0]
    model = _model(q, k, v, do, o3, lse, args)
    as_jnp = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    ref = jax_ops._xla_bwd_4d(as_jnp(q), as_jnp(k), as_jnp(v), as_jnp(_from3(o3, B)), as_jnp(do),
                              jnp.asarray(lse.numpy()), args["scale"], causal)
    for name, m, r in zip(("dq", "dk", "dv"), model, ref):
        assert r.dtype == jnp.bfloat16
        steps = ulps_at_scale(_from3(m, B).float().numpy(), np.asarray(r, np.float32)) / BF16_STEP
        assert steps <= BOUND / BF16_STEP, f"{name}: {steps} bf16 steps from _xla_bwd_4d"


def _unrounded(q3, k3, v3, o3, do3, lse, *, scale, causal, H, KV):
    """The plain backward as it stood before ``pd_dtype``: a frozen copy."""
    BH, T, D = q3.shape
    B, rep = BH // H, H // KV
    acc = torch.float64 if q3.dtype == torch.float64 else torch.float32
    q = q3.to(acc).reshape(B, KV, rep, T, D)
    k = k3.to(acc).reshape(B, KV, T, D)
    v = v3.to(acc).reshape(B, KV, T, D)
    do = do3.to(acc).reshape(B, KV, rep, T, D)
    s = scale * torch.einsum("bgrqd,bgkd->bgrqk", q, k)
    if causal:
        mask = torch.tril(torch.ones(T, T, dtype=torch.bool))
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.exp(s - lse.to(acc).reshape(B, KV, rep, T)[..., None])
    delta = (do * o3.to(acc).reshape(B, KV, rep, T, D)).sum(dim=-1)
    dp = torch.einsum("bgrqd,bgkd->bgrqk", do, v)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bgrqk,bgkd->bgrqd", ds, k).reshape(BH, T, D).to(q3.dtype)
    dk = torch.einsum("bgrqk,bgrqd->bgkd", ds, q).reshape(B * KV, T, D).to(k3.dtype)
    dv = torch.einsum("bgrqk,bgrqd->bgkd", p, do).reshape(B * KV, T, D).to(v3.dtype)
    return dq, dk, dv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_pd_dtype_none_is_bitwise_unchanged(dtype, causal):
    q, k, v, do, o3, lse, args = _inputs(57, 64, 2, causal, dtype)
    q3, k3, v3, do3 = (_to3(t) for t in (q, k, v, do))
    want = _unrounded(q3, k3, v3, o3, do3, lse, **args)
    for got in (flash_bwd_reference(q3, k3, v3, o3, do3, lse, **args),
                flash_bwd_reference(q3, k3, v3, o3, do3, lse, pd_dtype=None, **args)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
