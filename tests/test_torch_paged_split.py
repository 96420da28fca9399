"""The paged decode kernel's partition, modelled on the CPU.

``paged_decode_split_reference`` cuts each slot's positions as the CUDA
kernel does (chunks of ``CHUNK`` dealt round-robin to the ``CLUSTER`` CTAs
of a (slot, kv head), ``WARP_ROWS`` positions of a chunk to each warp, an
online softmax a warp, partials combined in warp order and then rank order).
Here it is held to the JAX package's Pallas kernel run through the
interpreter and to the port's gather chain, at the JAX package's bounds
(``ulps_at_scale``: 8 with fp32 pools, 64 with bf16 pools, docs/kernels.md),
at the lengths where the partition changes shape.  The card holds the kernel
to the same plain versions (``chip_smoke.py``).  Inputs are made with numpy
from a seed.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vescale_tpu.kernels.paged_attention import paged_decode as jax_paged_decode

from vescale_tpu_torch.kernels import ulps_at_scale
from vescale_tpu_torch.kernels.paged_attention import (
    CHUNK, CLUSTER, WARP_ROWS, paged_decode_reference, paged_decode_split_reference,
)

FP32_BOUND = 8.0  # fp32: only the order of the sums differs
BF16_POOL_BOUND = 64.0  # bf16 K/V pools, as tests/test_kernels.py states
KV = 2


def _lengths(page, Pmax):
    """Where the partition changes shape: only the fresh token, a chunk less
    one, a chunk, a chunk and one, the ranks wrapping (CLUSTER chunks, less
    and more one), a full slot, and a length past the table's reach (the
    kernel clamps it to page * Pmax)."""
    span = CLUSTER * CHUNK
    return [1, CHUNK - 1, CHUNK, CHUNK + 1, span - 1, span + 1, page * Pmax, page * Pmax + 50]


def _case(seed, page, Pmax, G, hd, dtype, lengths):
    """numpy-seeded inputs as (jax arrays, torch tensors) with the same
    values (bf16 pools rounded once, in JAX)."""
    rng = np.random.default_rng(seed)
    S = len(lengths)
    N = S * Pmax + 1
    kp = jnp.asarray(rng.normal(size=(N, page, KV, hd)), np.float32).astype(dtype)
    vp = jnp.asarray(rng.normal(size=(N, page, KV, hd)), np.float32).astype(dtype)
    q = jnp.asarray(rng.normal(size=(S, KV * G, hd)), jnp.float32)
    table = jnp.asarray(rng.permutation(np.arange(1, N))[: S * Pmax].reshape(S, Pmax), jnp.int32)
    lens = jnp.asarray(lengths, jnp.int32)
    return (q, kp, vp, table, lens), _torch(q, kp, vp, table, lens)


def _torch(q, kp, vp, table, lengths):
    tdtype = torch.bfloat16 if kp.dtype == jnp.bfloat16 else torch.float32
    as_t = lambda x: torch.from_numpy(np.asarray(x, np.float32).copy())
    return (as_t(q), as_t(kp).to(tdtype), as_t(vp).to(tdtype),
            torch.from_numpy(np.array(table)), torch.from_numpy(np.array(lengths)))


GEOMETRIES = [  # (page, Pmax, G, hd): pages of 16 and 6, hd 64 and 128, G 1, 4 and 16
    (16, 20, 1, 64),
    (16, 20, 4, 128),
    (6, 50, 16, 64),
    (6, 50, 4, 128),
]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("page,Pmax,G,hd", GEOMETRIES)
def test_split_model_matches_jax_kernel_and_reference(page, Pmax, G, hd, dtype):
    jargs, targs = _case(page * 100 + G * 10 + hd, page, Pmax, G, hd, dtype, _lengths(page, Pmax))
    scale = 1.0 / np.sqrt(hd)
    got = paged_decode_split_reference(*targs, scale=scale)
    assert got.dtype == torch.float32 and got.shape == targs[0].shape
    assert np.isfinite(got.numpy()).all()
    bound = FP32_BOUND if dtype == jnp.float32 else BF16_POOL_BOUND
    # the Pallas kernel masks at the unclamped length, which is the same
    # thing: its grid never reaches past page * Pmax
    ref = np.asarray(jax_paged_decode(*jargs, scale=scale, interpret=True))
    assert ulps_at_scale(got.numpy(), ref) <= bound
    plain = paged_decode_reference(*targs, scale=scale).numpy()
    assert ulps_at_scale(got.numpy(), plain) <= bound


def test_split_partition_is_the_kernels():
    """The constants are the kernel's, and a chunk is whole warps."""
    src = (__import__("pathlib").Path(__file__).resolve().parents[1]
           / "vescale_tpu_torch/kernels/csrc/paged_decode.cuh").read_text()
    assert f"constexpr int kCluster = {CLUSTER};" in src
    assert f"constexpr int kRows = {WARP_ROWS};" in src
    assert "kChunk == 64" in src and CHUNK == 64 and CHUNK % WARP_ROWS == 0


@pytest.mark.parametrize("where", ["k", "v"])
def test_nan_in_a_late_chunk_poisons_its_kv_group_only(where):
    """A NaN in the K (or V) row of a valid position in the last chunk of a
    long slot poisons that slot's heads of that kv group, in the model, the
    plain version and the JAX kernel alike; a NaN in a K row past a slot's
    length (a stale page tail) reaches nothing."""
    page, Pmax, G, hd = 16, 20, 4, 64
    lengths = [300, 5, 190]
    jargs, _ = _case(3, page, Pmax, G, hd, jnp.float32, lengths)
    q, kp, vp, table, lens = jargs
    pos = 299  # slot 0's last position: chunk 4, rank 0's second step
    at = (table[0, pos // page], pos % page, 1, 7)  # kv head 1, column 7
    if where == "k":
        kp = kp.at[at].set(jnp.nan)
    else:
        vp = vp.at[at].set(jnp.nan)
    kp = kp.at[table[1, 0], 9, 0, 0].set(jnp.nan)  # slot 1, position 9 >= its length
    jargs = (q, kp, vp, table, lens)
    targs = _torch(*jargs)
    scale = 1.0 / np.sqrt(hd)
    outs = [paged_decode_split_reference(*targs, scale=scale).numpy(),
            paged_decode_reference(*targs, scale=scale).numpy(),
            np.asarray(jax_paged_decode(*jargs, scale=scale, interpret=True))]
    for out in outs:
        nan_heads = sorted({(int(s), int(h)) for s, h, _ in np.argwhere(np.isnan(out))})
        if where == "k":  # a NaN score: every column of the group's heads
            assert nan_heads == [(0, h) for h in range(G, 2 * G)]
            assert np.isnan(out[0, G:2 * G]).all()
        else:  # a NaN value: its column of the group's heads
            assert nan_heads == [(0, h) for h in range(G, 2 * G)]
            assert np.argwhere(np.isnan(out[0]))[:, 1].tolist() == [7] * G
    assert ulps_at_scale(outs[0], outs[2]) <= FP32_BOUND  # NaN patterns agree exactly


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_a_slots_output_depends_on_its_own_length_only(dtype):
    """Bitwise: a slot's row of the model is the same when the other slots'
    lengths change, and when it runs alone (S=1)."""
    page, Pmax, G, hd = 16, 20, 4, 64
    lengths = _lengths(page, Pmax)
    _, (q, kp, vp, table, lens) = _case(5, page, Pmax, G, hd, jnp.float32, lengths)
    kp, vp = kp.to(dtype), vp.to(dtype)
    full = paged_decode_split_reference(q, kp, vp, table, lens, scale=0.125)
    for s in range(len(lengths)):
        other = (lens * 7 + 3) % (page * Pmax) + 1
        other[s] = lens[s]
        changed = paged_decode_split_reference(q, kp, vp, table, other, scale=0.125)
        assert torch.equal(changed[s], full[s])
        alone = paged_decode_split_reference(q[s:s + 1], kp, vp, table[s:s + 1], lens[s:s + 1],
                                             scale=0.125)
        assert torch.equal(alone[0], full[s])


def test_length_zero_writes_zero():
    """An uncommitted slot (length 0): every rank empty, the output 0."""
    _, (q, kp, vp, table, lens) = _case(9, 16, 4, 4, 64, jnp.float32, [0, 17])
    out = paged_decode_split_reference(q, kp, vp, table, lens, scale=0.125)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.isfinite(out[1]).all()
