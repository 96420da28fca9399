"""The port's fused cross entropy against the JAX package, on the CPU.

On CPU tensors ``kernels.cross_entropy`` runs its plain versions; these
tests hold them to the reference's Pallas kernels run through the
interpreter (``fused_xent_parts(..., interpret=True)`` and ``jax.vjp`` of
it), and ``loss.vocab_parallel_cross_entropy`` to the reference's with
``VESCALE_KERNELS`` at ``interpret`` and at ``off`` (the XLA path), at the
reference's own bound: the gold pick exact, the sums and gradients within
8 ulps at tensor scale (``docs/kernels.md``).  Shards narrower than 8
columns, where the reference's shape gate sends the loss to its XLA path,
are held to the reference's XLA expressions; the port's kernel masks and
takes them.  Inputs come from numpy seeds.  The CUDA kernels are held to
these plain versions on the card by ``chip_smoke.py``.
"""

import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vescale_tpu.kernels.cross_entropy import fused_xent_parts as jax_xent_parts
from vescale_tpu.kernels.cross_entropy import xent_blocks
from vescale_tpu.loss import vocab_parallel_cross_entropy as jax_vpce

from vescale_tpu_torch import kernels
from vescale_tpu_torch.kernels import ulps_at_scale
from vescale_tpu_torch.kernels.cross_entropy import (
    fused_xent_parts,
    xent_bwd,
    xent_bwd_reference,
    xent_fwd,
    xent_parts_reference,
)
from vescale_tpu_torch.loss import loss_parallel, vocab_parallel_cross_entropy
from vescale_tpu_torch.model.patch import VocabParallelCrossEntropy

ULP_BOUND = 8.0  # docs/kernels.md: sums in another order
BF16_STEP = 2.0 ** 16  # one bf16 step in fp32 ulps at the same scale

# (N, Vs): odd rows, narrow shards (below the reference's 8-column gate),
# non-power-of-two widths, and a few hundred columns
SHAPES = [(3, 7), (5, 1), (6, 40), (4, 100), (16, 128), (7, 1000)]


def _case(N, Vs, seed=0, nan_at=None, dtype=np.float32):
    rng = np.random.default_rng(seed * 1000 + N * 7 + Vs)
    lg = (3.0 * rng.normal(size=(N, Vs))).astype(np.float32)
    if nan_at is not None:
        lg[nan_at] = np.nan
    if dtype != np.float32:  # bf16: the same values both sides
        lg = np.asarray(jnp.asarray(lg, jnp.bfloat16).astype(jnp.float32))
    idx = rng.integers(0, Vs, N).astype(np.int32)
    gmax = lg.max(axis=-1)  # NaN rows stay NaN, as jnp.max and torch.amax keep them
    return lg, idx, gmax


def _jax_parts(lg_j, idx, gmax):
    """The reference's parts of a jnp ``lg_j``: its Pallas kernel where its
    gate takes the shape, else the XLA path's expressions
    (``loss.py:167-175``)."""
    if xent_blocks(*lg_j.shape) is not None:
        return jax_xent_parts(lg_j, jnp.asarray(idx), jnp.asarray(gmax), True)
    lg32 = lg_j.astype(jnp.float32)
    sumexp = jnp.sum(jnp.exp(lg32 - jnp.asarray(gmax)[:, None]), axis=-1)
    picked = jnp.take_along_axis(lg32, jnp.asarray(idx)[:, None], axis=-1)[:, 0]
    return sumexp, picked, jnp.sum(lg32, axis=-1)


def _torch(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32).copy()).to(dtype)


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_plain_matches_interpreted_pallas(shape):
    lg, idx, gmax = _case(*shape)
    ref = [np.asarray(x) for x in _jax_parts(jnp.asarray(lg), idx, gmax)]
    got = [x.numpy() for x in xent_parts_reference(_torch(lg), torch.from_numpy(idx).long(),
                                                   _torch(gmax))]
    assert np.array_equal(got[1], ref[1])  # the pick is exact
    assert ulps_at_scale(got[0], ref[0]) <= ULP_BOUND
    assert ulps_at_scale(got[2], ref[2]) <= ULP_BOUND


@pytest.mark.parametrize("shape", [(6, 40), (7, 1000), (3, 7)])
def test_forward_bf16_logits_sum_their_exact_upcast(shape):
    lg, idx, gmax = _case(*shape, dtype="bf16")
    ref = [np.asarray(x) for x in _jax_parts(jnp.asarray(lg, jnp.bfloat16), idx, gmax)]
    got = [x.numpy() for x in xent_parts_reference(_torch(lg, torch.bfloat16),
                                                   torch.from_numpy(idx), _torch(gmax))]
    assert got[0].dtype == np.float32
    assert np.array_equal(got[1], ref[1])
    assert ulps_at_scale(got[0], ref[0]) <= ULP_BOUND
    assert ulps_at_scale(got[2], ref[2]) <= ULP_BOUND


@pytest.mark.parametrize("shape", [(4, 100), (3, 7)])
def test_nan_rows_agree(shape):
    lg, idx, gmax = _case(*shape, nan_at=(1, 2))
    ref = [np.asarray(x) for x in _jax_parts(jnp.asarray(lg), idx, gmax)]
    got = [x.numpy() for x in xent_parts_reference(_torch(lg), torch.from_numpy(idx), _torch(gmax))]
    assert np.isnan(got[0][1]) and np.isnan(got[2][1]) and not np.isnan(got[0][0])
    for a, b in zip(got, ref):
        assert np.array_equal(np.isnan(a), np.isnan(b))
        assert ulps_at_scale(a, b) <= ULP_BOUND  # inf if the NaN patterns differed


def test_out_of_range_index_never_hits():
    lg, idx, gmax = _case(4, 64)
    idx[0], idx[2] = -1, 64
    ref = np.asarray(jax_xent_parts(jnp.asarray(lg), jnp.asarray(idx), jnp.asarray(gmax), True)[1])
    got = xent_parts_reference(_torch(lg), torch.from_numpy(idx), _torch(gmax))[1].numpy()
    assert got[0] == 0.0 and got[2] == 0.0
    assert np.array_equal(got, ref)


def _cotangents(N, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=N).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_plain_matches_vjp_of_interpreted_pallas(shape):
    lg, idx, gmax = _case(*shape, seed=1)
    cts = _cotangents(shape[0])
    _, vjp = jax.vjp(lambda x: _jax_parts(x, idx, gmax), jnp.asarray(lg))
    (ref,) = vjp(tuple(jnp.asarray(c) for c in cts))
    got = xent_bwd_reference(_torch(lg), torch.from_numpy(idx), _torch(gmax), *map(_torch, cts))
    assert got.dtype == torch.float32
    assert ulps_at_scale(got.numpy(), np.asarray(ref)) <= ULP_BOUND


@pytest.mark.parametrize("shape", [(6, 40), (7, 1000)])
def test_backward_bf16_rounds_once_to_bf16(shape):
    """bf16 logits: dlg comes back in bf16, each value the fp32 gradient
    rounded once; within one bf16 step at scale of the reference (both
    round the same fp32 formula, whose exp may differ in the last fp32
    bit)."""
    lg, idx, gmax = _case(*shape, seed=2, dtype="bf16")
    cts = _cotangents(shape[0], seed=3)
    _, vjp = jax.vjp(lambda x: _jax_parts(x, idx, gmax), jnp.asarray(lg, jnp.bfloat16))
    (ref,) = vjp(tuple(jnp.asarray(c) for c in cts))
    got = xent_bwd_reference(_torch(lg, torch.bfloat16), torch.from_numpy(idx), _torch(gmax),
                             *map(_torch, cts))
    assert got.dtype == torch.bfloat16
    assert ulps_at_scale(got.float().numpy(), np.asarray(ref.astype(jnp.float32))) <= BF16_STEP


def test_autograd_function_runs_the_plain_versions_on_cpu():
    lg, idx, gmax = _case(5, 33, seed=4)
    cts = [_torch(c) for c in _cotangents(5, seed=5)]
    before = dict(kernels.LAUNCHES)
    for tidx in (torch.from_numpy(idx), torch.from_numpy(idx).long()):
        x = _torch(lg).requires_grad_()
        g = _torch(gmax).requires_grad_()
        outs = fused_xent_parts(x, tidx, g)
        ref = xent_parts_reference(_torch(lg), tidx, _torch(gmax))
        for a, b in zip(outs, ref):
            assert torch.equal(a, b)
        sum(o.mul(c).sum() for o, c in zip(outs, cts)).backward()
        assert torch.equal(x.grad, xent_bwd_reference(_torch(lg), tidx, _torch(gmax), *cts))
        assert g.grad is None  # gmax is a constant to autograd, as in the reference
        # an output left out arrives in the backward as zeros
        x.grad = None
        outs = fused_xent_parts(x, tidx, g)
        (outs[0] * cts[0]).sum().backward()
        zero = torch.zeros(5)
        assert torch.equal(x.grad, xent_bwd_reference(_torch(lg), tidx, _torch(gmax), cts[0], zero,
                                                      zero))
    assert kernels.LAUNCHES == before  # CPU tensors never launch


def test_non_cpu_tensors_never_take_the_plain_version():
    lg = torch.empty(4, 16, device="meta")
    idx = torch.zeros(4, dtype=torch.int64, device="meta")
    gmax = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        xent_fwd(lg, idx, gmax)
    with pytest.raises(ValueError, match="CUDA tensor"):
        xent_bwd(lg, idx, gmax, gmax, gmax, gmax)


# ===================================================================== loss
LOSS_SHAPES = [(2, 8, 128), (3, 7, 96), (2, 3, 5)]  # the last is below the 8-column gate


def _loss_case(shape, seed=0, dtype=np.float32):
    rng = np.random.default_rng(int(np.prod(shape)) + seed)
    logits = rng.normal(size=shape).astype(np.float32)
    if dtype != np.float32:
        logits = np.asarray(jnp.asarray(logits, jnp.bfloat16).astype(jnp.float32))
    tgt = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    return logits, tgt


def _jax_loss(monkeypatch, mode, logits, tgt, smoothing, dtype=jnp.float32):
    monkeypatch.setenv("VESCALE_KERNELS", mode)
    fn = lambda lg: jax_vpce(lg, jnp.asarray(tgt), label_smoothing=smoothing)
    loss, grad = jax.value_and_grad(fn)(jnp.asarray(logits, dtype))
    return np.asarray(loss), np.asarray(grad.astype(jnp.float32))


def _port_loss(logits, tgt, smoothing, dtype=torch.float32):
    x = _torch(logits, dtype).requires_grad_()
    loss = vocab_parallel_cross_entropy(x, torch.from_numpy(tgt).long(), label_smoothing=smoothing)
    loss.backward()
    return loss.detach().numpy(), x.grad.float().numpy()


@pytest.mark.parametrize("mode", ["interpret", "off"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("shape", LOSS_SHAPES)
def test_loss_value_and_grad_match_the_reference(monkeypatch, shape, smoothing, mode):
    logits, tgt = _loss_case(shape)
    ref_loss, ref_grad = _jax_loss(monkeypatch, mode, logits, tgt, smoothing)
    loss, grad = _port_loss(logits, tgt, smoothing)
    assert loss.dtype == np.float32 and grad.shape == shape
    assert ulps_at_scale(loss, ref_loss) <= ULP_BOUND
    assert ulps_at_scale(grad, ref_grad) <= ULP_BOUND


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_loss_bf16_logits(monkeypatch, smoothing):
    """bf16 logits: the loss is the fp32 loss of their exact upcast; the
    gradient comes back in bf16, within one bf16 step at scale."""
    logits, tgt = _loss_case((2, 8, 64), seed=4, dtype="bf16")
    ref_loss, ref_grad = _jax_loss(monkeypatch, "interpret", logits, tgt, smoothing, jnp.bfloat16)
    loss, grad = _port_loss(logits, tgt, smoothing, torch.bfloat16)
    assert ulps_at_scale(loss, ref_loss) <= ULP_BOUND
    assert ulps_at_scale(grad, ref_grad) <= BF16_STEP


@pytest.mark.parametrize("mode", ["interpret", "off"])
def test_nan_poisoned_logits_give_a_nan_loss(monkeypatch, mode):
    logits, tgt = _loss_case((4, 64))
    logits[1, 3] = np.nan
    ref_loss, ref_grad = _jax_loss(monkeypatch, mode, logits, tgt, 0.0)
    loss, grad = _port_loss(logits, tgt, 0.0)
    assert np.isnan(ref_loss) and np.isnan(loss)
    assert np.isnan(grad[1]).all() and not np.isnan(grad[[0, 2, 3]]).any()
    assert ulps_at_scale(grad, ref_grad) <= ULP_BOUND  # inf if the NaN patterns differed


def test_mesh_path_is_not_ported_yet():
    logits, tgt = _loss_case((2, 4, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        vocab_parallel_cross_entropy(_torch(logits), torch.from_numpy(tgt), mesh=object(),
                                     vocab_dim_name="tp")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VocabParallelCrossEntropy(mesh=object())(_torch(logits), torch.from_numpy(tgt))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_module_form_equals_the_function(smoothing):
    logits, tgt = _loss_case((3, 5, 40), seed=2)
    t = torch.from_numpy(tgt).long()
    ref = vocab_parallel_cross_entropy(_torch(logits), t, label_smoothing=smoothing)
    got = VocabParallelCrossEntropy(label_smoothing=smoothing)(_torch(logits), t)
    assert torch.equal(got, ref)


def test_loss_parallel_warns_once():
    from vescale_tpu_torch import loss as loss_mod

    loss_mod._warned = False
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with loss_parallel():
            pass
        with loss_parallel():
            pass
    assert len([w for w in seen if "loss_parallel" in str(w.message)]) == 1
