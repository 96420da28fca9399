"""The numerics of the bf16 tensor-core flash forward, on the CPU.

For bf16 inputs the port's forward kernel (``csrc/flash_fwd.cu``, the
``wgmma`` kernel) rounds P to bf16 before the value product, where the JAX
package's Pallas kernel keeps it in fp32; it sums l from the unrounded P.
``flash_fwd_reference(pd_dtype=torch.bfloat16)`` models that rounding; the
kernel is held to it on the card by ``chip_smoke.py``.  These tests show on
the CPU that the departure fits the bound stated for the kernel: the model
is within 2 bf16 steps at scale (``ulps_at_scale`` / 2^16) of the reference
run in float64 and of the JAX package's dense forward
(``ops/flash_attention.py::_xla_fwd_4d``) on the same bf16 inputs; its lse
is the unrounded function's, bit for bit; and ``pd_dtype=None``, the
default, is still the unrounded function, bit for bit.  Inputs are made
with numpy from a seed.
"""

import importlib
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vescale_tpu_torch.kernels import ulps_at_scale
from vescale_tpu_torch.kernels.flash_attention import flash_fwd_reference

jax_ops = importlib.import_module("vescale_tpu.ops.flash_attention")

BF16_STEP = 2.0 ** 16  # one bf16 step in fp32 ulps at the same scale
BOUND = 2 * BF16_STEP

CASES = [
    pytest.param(T, D, rep, causal, id=f"T{T}-D{D}-rep{rep}-{'causal' if causal else 'full'}")
    for T in (64, 257, 1000)
    for D in (64, 128)
    for rep in (1, 2, 4)
    for causal in (True, False)
]


def _to3(x):
    B, T, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, T, D).contiguous()


def _from3(x, B):
    BH, T, D = x.shape
    return x.reshape(B, BH // B, T, D).permute(0, 2, 1, 3)


def _inputs(T, D, rep, causal, dtype=torch.bfloat16):
    """(B, T, H, D) q and (B, T, KV, D) k, v in ``dtype``, and the kernel
    arguments."""
    B, KV = 1, 2
    H = KV * rep
    rng = np.random.default_rng(T * 100 + D + 10 * rep + causal)
    q = torch.from_numpy(rng.normal(size=(B, T, H, D)).astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rng.normal(size=(B, T, KV, D)).astype(np.float32)).to(dtype)
            for _ in range(2))
    return q, k, v, dict(scale=1.0 / math.sqrt(D), causal=causal, H=H, KV=KV)


def _model(q, k, v, args):
    return flash_fwd_reference(_to3(q), _to3(k), _to3(v), pd_dtype=torch.bfloat16, **args)


@pytest.mark.parametrize("T, D, rep, causal", CASES)
def test_bf16_pd_model_within_two_steps_of_float64(T, D, rep, causal):
    q, k, v, args = _inputs(T, D, rep, causal)
    o, lse = _model(q, k, v, args)
    o64, lse64 = flash_fwd_reference(*(_to3(t).double() for t in (q, k, v)), **args)
    assert o.dtype == torch.bfloat16 and torch.isfinite(o.float()).all()
    assert o64.dtype == torch.float64 and lse64.dtype == torch.float64
    steps = ulps_at_scale(o.double().numpy(), o64.numpy()) / BF16_STEP
    assert steps <= BOUND / BF16_STEP, f"o: {steps} bf16 steps from float64"
    # lse is fp32 in both the model and the kernel: 16 fp32 ulps at scale
    assert ulps_at_scale(lse.numpy(), lse64.numpy()) <= 16.0


@pytest.mark.parametrize("T, D, rep, causal", CASES)
def test_bf16_pd_model_within_two_steps_of_xla_fwd_4d(T, D, rep, causal):
    q, k, v, args = _inputs(T, D, rep, causal)
    B = q.shape[0]
    o, lse = _model(q, k, v, args)
    as_jnp = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    ref_o, ref_lse = jax_ops._xla_fwd_4d(as_jnp(q), as_jnp(k), as_jnp(v), args["scale"], causal)
    assert ref_o.dtype == jnp.bfloat16
    steps = ulps_at_scale(_from3(o, B).float().numpy(), np.asarray(ref_o, np.float32)) / BF16_STEP
    assert steps <= BOUND / BF16_STEP, f"o: {steps} bf16 steps from _xla_fwd_4d"
    assert ulps_at_scale(lse.numpy(), np.asarray(ref_lse)) <= 16.0


@pytest.mark.parametrize("T, D, rep, causal", CASES)
def test_bf16_pd_model_lse_is_the_unrounded_lse(T, D, rep, causal):
    q, k, v, args = _inputs(T, D, rep, causal)
    _, lse = _model(q, k, v, args)
    _, want = flash_fwd_reference(_to3(q), _to3(k), _to3(v), **args)
    assert lse.dtype == torch.float32 and torch.equal(lse, want)


def _unrounded(q3, k3, v3, *, scale, causal, H, KV):
    """The plain forward as it stood before ``pd_dtype``: a frozen copy."""
    BH, T, D = q3.shape
    B, rep = BH // H, H // KV
    q = q3.float().reshape(B, KV, rep, T, D)
    k = k3.float().reshape(B, KV, T, D)
    v = v3.float().reshape(B, KV, T, D)
    s = scale * torch.einsum("bgrqd,bgkd->bgrqk", q, k)
    if causal:
        mask = torch.tril(torch.ones(T, T, dtype=torch.bool))
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p, v) / l_safe[..., None]
    lse = (m + torch.log(l_safe)).reshape(B, H, T)
    return o.reshape(BH, T, D).to(q3.dtype), lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_pd_dtype_none_is_bitwise_unchanged(dtype, causal):
    q, k, v, args = _inputs(57, 64, 2, causal, dtype)
    q3, k3, v3 = (_to3(t) for t in (q, k, v))
    want = _unrounded(q3, k3, v3, **args)
    for got in (flash_fwd_reference(q3, k3, v3, **args),
                flash_fwd_reference(q3, k3, v3, pd_dtype=None, **args)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
