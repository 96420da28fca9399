"""The port's global-index RNG against ``jax.random`` and the reference
tracker, in one process.

Bitwise: keys and ``fold_in``, the raw 32-, 16- and 8-bit draws, ``uniform``
in float32, bfloat16 and float16 (with and without a range), ``bernoulli``,
``dropout`` and the tracker's named streams, over several seeds; a draw made
shard by shard (``global_offset``/``global_shape``, or ``index`` for
interleaved and ragged pieces) equals the whole draw.

Bound: ``normal`` is ``sqrt(2) * erfinv(u)`` in both, from bitwise-equal
``u``; ``torch.erfinv`` and XLA's float32 ``erf_inv`` polynomial differ.
Measured over 20 seeds x 20,000 draws: XLA's sits up to 48 float32 ulps
(relative) from float64 ``scipy.special.erfinv`` of the same ``u`` and
torch's within 1, so the port is held within 2 ulps of the float64 value
and within 64 ulps of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erfinv

import vescale_tpu as vt
from vescale_tpu import random as ref_random
from vescale_tpu_torch import random as R
from vescale_tpu_torch.darray import rand, randn
from vescale_tpu_torch.mesh import DeviceMesh
from vescale_tpu_torch.placements import InterleavedShard, RaggedShard, Replicate, Shard

SEEDS = (0, 1, 7, 1234, 2**31 - 1)
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _reseed_port_tracker():
    R.manual_seed(0)
    yield
    R.manual_seed(0)


def _kd(k):
    return tuple(int(x) for x in jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_are_jaxs(seed):
    k = jax.random.key(seed)
    assert R.key(seed) == _kd(k)
    for data in (0, 1, 42, 0x7FFFFFFF, 2**32 - 1):
        assert R.fold_in(R.key(seed), data) == _kd(jax.random.fold_in(k, data))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("width,dt", [(32, jnp.uint32), (16, jnp.uint16), (8, jnp.uint8)])
def test_random_bits_are_jaxs(seed, width, dt):
    k = jax.random.key(seed)
    ref = np.asarray(jax.random.bits(k, (5, 7, 3), dt)).astype(np.int64)
    got = R.random_bits(R.key(seed), (5, 7, 3), width, device="cpu").numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_uniform_is_bitwise_jaxs(seed, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    k = jax.random.key(seed)
    for lo, hi in ((0.0, 1.0), (-2.5, 3.0)):
        ref = np.asarray(jax.random.uniform(k, (33, 17), dtype=jdt, minval=lo, maxval=hi).astype(jnp.float32))
        got = R.uniform((33, 17), tdt, key=R.key(seed), minval=lo, maxval=hi, device="cpu").float().numpy()
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32), err_msg=f"{dtype} [{lo},{hi})")


@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli_and_dropout_are_bitwise_jaxs(seed):
    k = jax.random.key(seed)
    for p in (0.1, 0.5, 0.9):
        ref = np.asarray(jax.random.bernoulli(k, p, (257,)))
        np.testing.assert_array_equal(R.bernoulli(p, (257,), key=R.key(seed), device="cpu").numpy(), ref)
    x = np.random.default_rng(seed).standard_normal((6, 40)).astype(np.float32)
    for rate in (0.1, 0.5):
        tracker = ref_random.RNGStateTracker(seed)
        ref = np.asarray(tracker.dropout(jnp.asarray(x), rate, name="dropout"))
        got = R.RNGStateTracker(seed).dropout(torch.from_numpy(x), rate, name="dropout").numpy()
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(ref_random.RNGStateTracker(seed).dropout(xb, 0.1).astype(jnp.float32))
    got = R.RNGStateTracker(seed).dropout(torch.from_numpy(x).bfloat16(), 0.1).float().numpy()
    np.testing.assert_array_equal(got, ref)
    assert R.dropout(torch.ones(3), 0.0).tolist() == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("seed", SEEDS)
def test_tracker_streams_match_the_reference(seed):
    ref, got = ref_random.RNGStateTracker(seed), R.RNGStateTracker(seed)
    assert got.base_key == _kd(ref.base_key)
    for name in ("default", "tensor-parallel", "data-parallel", "default", "tensor-parallel"):
        assert got.stream(name) == _kd(ref.stream(name))
        assert got.next_key(name) == _kd(ref.next_key(name))
    a = np.asarray(ref.uniform((4, 9), name="tp"))
    b = got.uniform((4, 9), name="tp", device="cpu").numpy()
    np.testing.assert_array_equal(b, a)
    with got._distribute_region(name="tp") as k1:
        with ref._distribute_region(name="tp") as k2:
            assert k1 == _kd(k2)
    for cls in (R.OffsetBasedRNGTracker, R.ThreadBasedRNGTracker, R.TensorParallelRNGTracker):
        assert cls(seed).next_key() == got.__class__(seed).next_key()


@pytest.mark.parametrize("seed", range(6))
def test_normal_within_its_stated_bound(seed):
    k = jax.random.key(seed)
    ref = np.asarray(jax.random.normal(k, (4096,)))
    got = R.normal((4096,), key=R.key(seed), device="cpu").numpy()
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    u = R.uniform((4096,), key=R.key(seed), minval=lo, maxval=1.0, device="cpu").double().numpy()
    exact = np.sqrt(2.0) * erfinv(u)
    rel = lambda a, b: np.abs(a.astype(np.float64) - b) / np.maximum(np.abs(b), 1e-30) / EPS32
    assert rel(got, exact).max() <= 2.0
    assert rel(got, ref.astype(np.float64)).max() <= 64.0
    assert np.isfinite(got).all()


# ------------------------------------------------------- sharded draws
def test_a_box_of_a_draw_equals_that_box_of_the_whole_draw():
    k = R.key(3)
    whole = R.uniform((12, 10, 6), key=k, device="cpu")
    for off, shape in (((0, 0, 0), (12, 10, 6)), ((3, 5, 1), (4, 4, 5)), ((11, 9, 5), (1, 1, 1)),
                       ((2, 0, 0), (0, 10, 6))):
        part = R.uniform(shape, key=k, device="cpu", global_offset=off, global_shape=(12, 10, 6))
        box = whole[off[0]:off[0] + shape[0], off[1]:off[1] + shape[1], off[2]:off[2] + shape[2]]
        assert torch.equal(part, box)
    x = torch.randn(12, 10, 6)
    full = R.dropout(x, 0.3, key=k)
    part = R.dropout(x[3:7, 5:9, 1:6].contiguous(), 0.3, key=k, global_offset=(3, 5, 1),
                     global_shape=(12, 10, 6))
    assert torch.equal(part, full[3:7, 5:9, 1:6])
    with pytest.raises(ValueError, match="does not fit"):
        R.uniform((4,), key=k, device="cpu", global_offset=(9,), global_shape=(12,))


LAYOUTS = [
    ((2, 4), ("dp", "tp"), [Shard(0), Shard(1)], (16, 8)),
    ((2, 4), ("dp", "tp"), [Shard(1), Shard(0)], (7, 5)),
    ((8,), ("tp",), [InterleavedShard(0, 3)], (24, 4)),
    ((4,), ("fsdp",), [RaggedShard((0, 1), (1, 2, 3, 2))], (8, 4)),
    ((2, 4), ("dp", "tp"), [Replicate(), Shard(0)], (10, 3)),
]


@pytest.mark.parametrize("i", range(len(LAYOUTS)))
def test_darray_rand_and_randn_match_the_reference_rank_by_rank(i):
    """``rand`` is bitwise the reference's ``vt.rand`` on every rank's
    piece, whatever the layout; ``randn`` within normal's bound."""
    from torch_spmd_child import enc

    import vescale_tpu.placements as ref_pl
    from torch_spmd_child import dec

    mesh_shape, names, ps, shape = LAYOUTS[i]
    mesh = DeviceMesh(names, mesh_shape, device_type="cpu")
    ref_mesh = vt.DeviceMesh(names, mesh_shape)
    ref_ps = [dec(enc(p), ref_pl) for p in ps]
    vt.manual_seed(5)
    ref_u = vt.rand(shape, device_mesh=ref_mesh, placements=ref_ps)
    ref_n = vt.randn(shape, device_mesh=ref_mesh, placements=ref_ps)
    for r in range(mesh.size()):
        R.manual_seed(5)
        u = rand(shape, device_mesh=mesh, placements=ps, rank=r)
        n = randn(shape, device_mesh=mesh, placements=ps, rank=r)
        np.testing.assert_array_equal(u.to_local().numpy(), np.asarray(ref_u.to_local(rank=r)))
        ref = np.asarray(ref_n.to_local(rank=r)).astype(np.float64)
        got = n.to_local().numpy().astype(np.float64)
        assert got.shape == ref.shape
        if got.size:
            assert (np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30) / EPS32).max() <= 64.0
