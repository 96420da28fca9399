"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; these tests
hold that version (and the ops front end over it) to the JAX package's
reference math and to its Pallas kernels run through the interpreter, at
the JAX package's own parity bound (``ulps_at_scale``, docs/kernels.md).
The CUDA kernels themselves are held to these plain versions on the card
by ``chip_smoke.py``.  Inputs are made with numpy from a seed.
"""

import importlib
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vescale_tpu.kernels.flash_attention import _flash_fwd_pallas
from vescale_tpu.kernels.paged_attention import paged_decode as jax_paged_decode

from vescale_tpu_torch import kernels
from vescale_tpu_torch.kernels import ulps_at_scale
from vescale_tpu_torch.kernels.flash_attention import flash_fwd, flash_fwd_reference
from vescale_tpu_torch.kernels.paged_attention import paged_decode, paged_decode_reference

# the modules (each package's ``ops`` re-exports a function of the same name)
jax_ops = importlib.import_module("vescale_tpu.ops.flash_attention")
torch_ops = importlib.import_module("vescale_tpu_torch.ops.flash_attention")

ULP_BOUND = 8.0  # fp32: accumulation order is the only difference
BF16_POOL_BOUND = 64.0  # bf16 K/V pools, as tests/test_kernels.py states


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


# ================================================================ flash
def _flash_case(seed, B, T, H, KV, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, T, KV, D)).astype(np.float32)
    return q, k, v


def _to3(x):
    B, T, H, D = x.shape
    return np.ascontiguousarray(np.transpose(x, (0, 2, 1, 3)).reshape(B * H, T, D))


@pytest.mark.parametrize("T", [32, 37])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_reference_matches_xla_fwd_4d(causal, rep, T):
    B, KV, D = 2, 2, 16
    H = KV * rep
    q, k, v = _flash_case(rep * 100 + T, B, T, H, KV, D)
    scale = 1.0 / math.sqrt(D)
    o_ref, lse_ref = jax_ops._xla_fwd_4d(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal)
    o3, lse = flash_fwd_reference(_t(_to3(q)), _t(_to3(k)), _t(_to3(v)),
                                  scale=scale, causal=causal, H=H, KV=KV)
    o = o3.reshape(B, H, T, D).permute(0, 2, 1, 3)
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    assert ulps_at_scale(o.numpy(), np.asarray(o_ref)) <= ULP_BOUND
    assert ulps_at_scale(lse.numpy(), np.asarray(lse_ref)) <= ULP_BOUND
    # the (B, T, H, D) front end runs the same plain version on the CPU
    o_ops = torch_ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert ulps_at_scale(o_ops.numpy(), np.asarray(o_ref)) <= ULP_BOUND


@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_reference_matches_pallas_interpret(causal, rep):
    """T divisible by the Pallas block sizes: the interpreted TPU kernel,
    resident and streaming variants both."""
    B, KV, D, T = 1, 2, 16, 32
    H = KV * rep
    q, k, v = _flash_case(rep + 7, B, T, H, KV, D)
    scale = 1.0 / math.sqrt(D)
    o3, lse = flash_fwd_reference(_t(_to3(q)), _t(_to3(k)), _t(_to3(v)),
                                  scale=scale, causal=causal, H=H, KV=KV)
    for streaming in (False, True):
        po3, plse = _flash_fwd_pallas(
            jnp.asarray(_to3(q)), jnp.asarray(_to3(k)), jnp.asarray(_to3(v)), scale, causal,
            16, 16, True, H, KV, streaming=streaming,
        )
        assert ulps_at_scale(o3.numpy(), np.asarray(po3)) <= ULP_BOUND
        assert ulps_at_scale(lse.numpy().reshape(-1), np.asarray(plse).reshape(-1)) <= ULP_BOUND


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ops_matches_jax_flash_attention(causal):
    """The front ends agree: the port's on its plain version, the JAX
    package's with its kernels off (the dense reference); and the port's
    ``_dense_ref`` is the JAX one."""
    q, k, v = _flash_case(5, 1, 24, 4, 2, 8)
    out = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = torch_ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.shape == (1, 24, 4, 8)
    assert ulps_at_scale(got.numpy(), np.asarray(out)) <= ULP_BOUND
    dense = torch_ops._dense_ref(_t(q), _t(k), _t(v), 0.125, causal)
    dense_ref = jax_ops._dense_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.125, causal)
    assert ulps_at_scale(dense.numpy(), np.asarray(dense_ref)) <= ULP_BOUND


def test_flash_ops_rejects_bad_gqa():
    q, k, v = _flash_case(0, 1, 8, 3, 2, 8)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        torch_ops.flash_attention(_t(q), _t(k), _t(v))


# ========================================================== paged decode
def _paged_case(rng, S, Pmax, page, KV, hd, H, dtype):
    """The case of tests/test_kernels.py, as (jax arrays, torch tensors)
    holding the same values (bf16 pools rounded once, in JAX)."""
    N = S * Pmax + 1
    kp = jnp.asarray(rng.normal(size=(N, page, KV, hd)), np.float32).astype(dtype)
    vp = jnp.asarray(rng.normal(size=(N, page, KV, hd)), np.float32).astype(dtype)
    q = jnp.asarray(rng.normal(size=(S, H, hd)), jnp.float32)
    table = jnp.asarray(rng.permutation(np.arange(1, N))[: S * Pmax].reshape(S, Pmax), jnp.int32)
    lengths = jnp.asarray(rng.integers(1, page * Pmax + 1, S), jnp.int32)
    return (q, kp, vp, table, lengths), _torch_args(q, kp, vp, table, lengths)


def _torch_args(q, kp, vp, table, lengths):
    tdtype = torch.bfloat16 if kp.dtype == jnp.bfloat16 else torch.float32
    return (
        _t(q), _t(kp).to(tdtype), _t(vp).to(tdtype),
        torch.from_numpy(np.array(table)), torch.from_numpy(np.array(lengths)),
    )


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("page,Pmax", [(4, 4), (8, 2), (6, 3), (16, 1)])
def test_paged_reference_matches_pallas_interpret(dtype, page, Pmax):
    rng = np.random.default_rng(page * 10 + Pmax)
    S, KV, hd, H = 3, 2, 16, 4
    jargs, targs = _paged_case(rng, S, Pmax, page, KV, hd, H, dtype)
    scale = 1.0 / np.sqrt(hd)
    ref = jax_paged_decode(*jargs, scale=scale, interpret=True)
    out = paged_decode_reference(*targs, scale=scale)
    assert out.dtype == torch.float32 and out.shape == (S, H, hd)
    bound = ULP_BOUND if dtype == jnp.float32 else BF16_POOL_BOUND
    assert ulps_at_scale(out.numpy(), np.asarray(ref)) <= bound


def test_paged_reference_edge_lengths():
    """length 1 (only the fresh token) and a full slot."""
    rng = np.random.default_rng(7)
    S, Pmax, page, KV, hd, H = 3, 2, 4, 1, 8, 2
    (q, kp, vp, table, _), _ = _paged_case(rng, S, Pmax, page, KV, hd, H, jnp.float32)
    lengths = jnp.asarray([1, page * Pmax, 3], jnp.int32)
    scale = 1.0 / np.sqrt(hd)
    ref = jax_paged_decode(q, kp, vp, table, lengths, scale=scale, interpret=True)
    out = paged_decode_reference(*_torch_args(q, kp, vp, table, lengths), scale=scale)
    assert ulps_at_scale(out.numpy(), np.asarray(ref)) <= ULP_BOUND
    assert np.isfinite(out.numpy()).all()


def test_paged_reference_nan_poison():
    """NaN in a VALID position poisons exactly that slot in both packages;
    NaN in a masked position (stale page tail) leaks into neither."""
    rng = np.random.default_rng(11)
    S, Pmax, page, KV, hd, H = 3, 2, 4, 2, 8, 4
    (q, kp, vp, table, _), _ = _paged_case(rng, S, Pmax, page, KV, hd, H, jnp.float32)
    lengths = jnp.asarray([5, 2, 7], jnp.int32)
    scale = 1.0 / np.sqrt(hd)
    kp1 = kp.at[table[0, 0], 2, 0, 3].set(jnp.nan)  # valid: slot 0, position 2
    kp1 = kp1.at[table[1, 0], 3, 1, 0].set(jnp.nan)  # masked: slot 1, position 3
    ref = np.asarray(jax_paged_decode(q, kp1, vp, table, lengths, scale=scale, interpret=True))
    out = paged_decode_reference(*_torch_args(q, kp1, vp, table, lengths), scale=scale).numpy()
    assert list(np.unique(np.argwhere(np.isnan(out))[:, 0])) == [0]
    assert list(np.unique(np.argwhere(np.isnan(ref))[:, 0])) == [0]
    assert ulps_at_scale(out, ref) <= ULP_BOUND  # NaN patterns agree exactly


# ============================================================== dispatch
def test_cpu_tensors_take_plain_versions_and_launch_nothing():
    kernels.reset_launches()
    q, k, v = _flash_case(3, 1, 16, 4, 2, 8)
    q3, k3, v3 = (_t(_to3(x)) for x in (q, k, v))
    o, lse = flash_fwd(q3, k3, v3, scale=0.25, causal=True, H=4, KV=2)
    o_ref, lse_ref = flash_fwd_reference(q3, k3, v3, scale=0.25, causal=True, H=4, KV=2)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    rng = np.random.default_rng(1)
    _, targs = _paged_case(rng, 2, 2, 4, 2, 8, 4, jnp.float32)
    assert torch.equal(paged_decode(*targs, scale=0.5), paged_decode_reference(*targs, scale=0.5))
    assert {"flash_fwd", "paged_decode"} <= set(kernels.LAUNCHES)
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_non_cpu_non_cuda_tensors_raise_instead_of_falling_back():
    q = torch.empty((4, 16, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_fwd(q, q[:2], q[:2], scale=0.125, causal=True, H=2, KV=1)
    qd = torch.empty((2, 4, 64), device="meta")
    pool = torch.empty((3, 4, 2, 64), device="meta")
    idx = torch.empty((2, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_decode(qd, pool, pool, idx, idx[:, 0], scale=0.125)
    assert {"flash_fwd", "paged_decode"} <= set(kernels.LAUNCHES)
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_ulps_at_scale_is_the_jax_packages_metric():
    from vescale_tpu.kernels import ulps_at_scale as jax_ulps

    rng = np.random.default_rng(2)
    a = rng.normal(size=64).astype(np.float32)
    b = a + np.float32(1e-6) * rng.normal(size=64).astype(np.float32)
    for x, y in ((a, b), (a, a), (np.array([np.nan, 1.0]), np.array([1.0, 1.0])),
                 (np.array([np.inf]), np.array([np.inf]))):
        assert ulps_at_scale(x, y) == jax_ulps(x, y)
