"""The port's flash-attention backward against the JAX package, on the CPU.

On CPU tensors ``kernels.flash_bwd`` runs its plain version,
``flash_bwd_reference``; these tests hold it to the JAX package's dense
backward (``ops/flash_attention.py::_xla_bwd_4d``) and to its Pallas dq/dkv
kernels run through the interpreter, and the port's autograd op to
``jax.grad`` of the JAX op.  The CUDA kernels are held to the plain version
on the card by ``chip_smoke.py``.  Inputs are made with numpy from a seed.
"""

import importlib
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vescale_tpu.kernels.flash_attention import _flash_bwd_pallas

from vescale_tpu_torch import kernels
from vescale_tpu_torch.kernels import ulps_at_scale
from vescale_tpu_torch.kernels.flash_attention import (
    flash_bwd,
    flash_bwd_reference,
    flash_fwd,
    flash_fwd_reference,
)

jax_ops = importlib.import_module("vescale_tpu.ops.flash_attention")
torch_ops = importlib.import_module("vescale_tpu_torch.ops.flash_attention")

ULP_BOUND = 8.0  # fp32: summation order is the only difference
BF16_STEP = 2.0 ** 16  # one bf16 step in fp32 ulps at the same scale


def _case(seed, B, T, H, KV, D):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, T, KV, D)).astype(np.float32) for _ in range(2))
    return q, k, v, do


def _to3(x):
    B, T, H, D = x.shape
    return np.ascontiguousarray(np.transpose(x, (0, 2, 1, 3)).reshape(B * H, T, D))


def _from3(x, B):
    BH, T, D = x.shape
    return np.transpose(np.asarray(x).reshape(B, BH // B, T, D), (0, 2, 1, 3))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32).copy()).to(dtype)


def _jax_fwd(q, k, v, scale, causal):
    o, lse = jax_ops._xla_fwd_4d(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal)
    return np.asarray(o), np.asarray(lse)


@pytest.mark.parametrize("T", [32, 37])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_reference_matches_xla_bwd_4d(causal, rep, T):
    B, KV, D = 2, 2, 16
    H = KV * rep
    q, k, v, do = _case(rep * 10 + T, B, T, H, KV, D)
    scale = 1.0 / math.sqrt(D)
    o, lse = _jax_fwd(q, k, v, scale, causal)
    ref = jax_ops._xla_bwd_4d(*(jnp.asarray(x) for x in (q, k, v, o, do, lse)), scale, causal)
    got = flash_bwd_reference(*(_t(_to3(x)) for x in (q, k, v, o, do)), _t(lse),
                              scale=scale, causal=causal, H=H, KV=KV)
    for g, r, n in zip(got, ref, (H, KV, KV)):
        assert g.dtype == torch.float32 and g.shape == (B * n, T, D)
        assert ulps_at_scale(_from3(g.numpy(), B), np.asarray(r)) <= ULP_BOUND


def test_bwd_reference_bf16_matches_xla_bwd_4d():
    """bf16 inputs: both upcast to fp32 and round one fp32 result to bf16,
    so they agree within 2 bf16 steps at scale."""
    B, T, H, KV, D = 1, 40, 4, 2, 16
    q, k, v, do = _case(5, B, T, H, KV, D)
    as_bf16 = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    q, k, v, do = (as_bf16(x) for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(D)
    o, lse = _jax_fwd(q, k, v, scale, True)
    o = as_bf16(o)
    ref = jax_ops._xla_bwd_4d(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, o, do)),
                              jnp.asarray(lse), scale, True)
    got = flash_bwd_reference(*(_t(_to3(x), torch.bfloat16) for x in (q, k, v, o, do)), _t(lse),
                              scale=scale, causal=True, H=H, KV=KV)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        assert ulps_at_scale(_from3(g.float().numpy(), B), np.asarray(r, np.float32)) <= 2 * BF16_STEP


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_reference_matches_pallas_interpret(causal, rep, streaming):
    """The interpreted TPU kernels (K3/K4 resident, K5/K6 streaming) with
    32-blocks on the same inputs, o and lse: within 8 ulps, or no further
    from them than the JAX package's own dense backward is.  The dense
    math (the port's and ``_xla_bwd_4d``) rounds s to fp32 before exp, and
    dp - delta cancels; on the causal rep-4 case that puts both 13 ulps
    from the Pallas kernels, which are 2 ulps from a float64 run."""
    B, KV, D, T = 1, 2, 16, 64
    H = KV * rep
    q, k, v, do = _case(rep + 100 * causal, B, T, H, KV, D)
    scale = 1.0 / math.sqrt(D)
    o, lse = _jax_fwd(q, k, v, scale, causal)
    q3, k3, v3, o3, do3 = (_to3(x) for x in (q, k, v, o, do))
    lse3 = lse.reshape(B * H, T, 1)
    ref = _flash_bwd_pallas(*(jnp.asarray(x) for x in (q3, k3, v3, o3, do3, lse3)), scale, causal,
                            32, 32, True, H, KV, streaming=streaming)
    own = jax_ops._xla_bwd_4d(*(jnp.asarray(x) for x in (q, k, v, o, do, lse)), scale, causal)
    got = flash_bwd(*(_t(x) for x in (q3, k3, v3, o3, do3)), _t(lse),
                    scale=scale, causal=causal, H=H, KV=KV)
    for g, r, x in zip(got, ref, own):
        own_ulps = ulps_at_scale(_to3(np.asarray(x)), np.asarray(r))
        assert own_ulps <= 2 * ULP_BOUND
        assert ulps_at_scale(g.numpy(), np.asarray(r)) <= max(ULP_BOUND, own_ulps)


# Different forward algorithms feed the two backwards: the interpreted
# Pallas forward's online softmax and the port's dense one give o and lse a
# few ulps apart, and the backward's ds = p * (dp - delta) amplifies them
# where dp and delta nearly cancel.
GRAD_BOUND = 32.0


@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_jax_grad_of_the_pallas_op(causal, rep):
    B, KV, D, T = 1, 2, 16, 64
    H = KV * rep
    q, k, v, w = _case(7 + rep, B, T, H, KV, D)

    def jax_loss(q, k, v):
        o = jax_ops.flash_attention(q, k, v, causal=causal, block_q=32, block_k=32, interpret=True)
        return jnp.sum(o * jnp.asarray(w))

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    (torch_ops.flash_attention(*leaves, causal=causal) * _t(w)).sum().backward()
    for x, r in zip(leaves, ref):
        assert x.grad.shape == r.shape
        assert ulps_at_scale(x.grad.numpy(), np.asarray(r)) <= GRAD_BOUND


def test_autograd_matches_dense_reference_autograd():
    """The same grads through autograd of the dense ``_dense_ref`` (GQA
    heads repeated): another algorithm for the same function, so the bound
    is the one above."""
    B, T, H, KV, D = 2, 48, 4, 2, 16
    q, k, v, w = _case(21, B, T, H, KV, D)
    grads = []
    for fn in (lambda a, b, c: torch_ops.flash_attention(a, b, c, causal=True),
               lambda a, b, c: torch_ops._dense_ref(a, b, c, 1.0 / math.sqrt(D), True)):
        leaves = [_t(x).requires_grad_() for x in (q, k, v)]
        (fn(*leaves) * _t(w)).sum().backward()
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        assert ulps_at_scale(a.numpy(), b.numpy()) <= GRAD_BOUND


def test_forward_through_the_autograd_op_is_the_kernels_forward():
    """The serve path (no grad) computes exactly what ``flash_fwd`` does."""
    B, T, H, KV, D = 1, 33, 4, 2, 16
    q, k, v, _ = _case(3, B, T, H, KV, D)
    o3, _ = flash_fwd_reference(*(_t(_to3(x)) for x in (q, k, v)), scale=0.25, causal=True,
                                H=H, KV=KV)
    with torch.no_grad():
        o = torch_ops.flash_attention(_t(q), _t(k), _t(v), causal=True, scale=0.25)
    assert torch.equal(o, torch.from_numpy(_from3(o3.numpy(), B)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    o_grad = torch_ops.flash_attention(*leaves, causal=True, scale=0.25)
    assert o_grad.requires_grad and torch.equal(o_grad.detach(), o)


def test_cpu_runs_move_no_launch_counter():
    kernels.reset_launches()
    B, T, H, KV, D = 1, 16, 2, 1, 8
    q, k, v, w = _case(1, B, T, H, KV, D)
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    (torch_ops.flash_attention(*leaves) * _t(w)).sum().backward()
    o3, lse = flash_fwd(*(_t(_to3(x)) for x in (q, k, v)), scale=0.3, causal=True, H=H, KV=KV)
    flash_bwd(*(_t(_to3(x)) for x in (q, k, v)), o3, _t(_to3(w)), lse, scale=0.3, causal=True,
              H=H, KV=KV)
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    assert {"flash_bwd_dq", "flash_bwd_dkv", "fused_adamw"} <= set(kernels.LAUNCHES)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel-only entry points have no plain fallback."""
    from vescale_tpu_torch.kernels.flash_attention import flash_bwd_dkv, flash_bwd_dq

    x = torch.zeros(2, 8, 64)
    lse, delta = torch.zeros(2, 8), torch.zeros(2, 8)
    for fn in (flash_bwd_dq, flash_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(x, x, x, x, lse, delta, scale=0.1, causal=True, H=2, KV=2)
