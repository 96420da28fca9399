"""The port's tensor-parallel pieces on gloo worlds of 2 and 4 ranks: the
autograd collectives of ``dmodule._comm`` against their definitions, and
the vocab-parallel loss, the parallel linears, ``VocabParallelEmbedding``
and ``flash_attention_sharded`` against the JAX reference on the same
numpy-seeded inputs.

Each rank (children of ``tests/torch_spmd_child.py``) computes its piece;
the reference runs in this process on conftest's virtual devices.  Bounds:
the vocab-parallel loss and each rank's dlogits piece within 8 ulps at
scale of ``vocab_parallel_cross_entropy(mesh=, vocab_dim_name="tp")``
(``ulps_at_scale``, fp32, with and without label smoothing); the parallel
modules within rtol/atol 2e-5 (outputs) and 5e-5 (gradients), the
tolerances of ``tests/test_dmodule.py``; each rank's flash output piece
within 8 ulps at scale of the reference's output sharded the same way
(``docs/kernels.md``'s flash bound).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from vescale_tpu.loss import vocab_parallel_cross_entropy as ref_xent
from vescale_tpu.mesh import DeviceMesh as RefMesh
from vescale_tpu.model.patch import (ColumnParallelLinear as RefCol, RowParallelLinear as RefRow,
                                     VocabParallelEmbedding as RefEmb)
from vescale_tpu.ops.flash_attention import flash_attention_sharded as ref_flash_sharded

from vescale_tpu_torch.kernels import ulps_at_scale

import torch_spmd_child as child

ULPS = 8.0
FWD_TOL, GRAD_TOL = 2e-5, 5e-5


@pytest.fixture(scope="module")
def worlds():
    made = {}

    def get(n):
        if n not in made:
            made[n] = child.World(n)
        return made[n]

    yield get
    for w in made.values():
        w.close()


def _mesh(tp):
    return RefMesh(("tp",), (tp,), devices=jax.devices()[:tp])


def _piece(a, axis, tp, r):
    w = a.shape[axis] // tp
    return np.take(a, np.arange(r * w, (r + 1) * w), axis=axis)


# ------------------------------------------------------- the collectives
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("op", child.TP_COMM_OPS)
def test_autograd_collective_and_its_transpose(worlds, op, tp):
    """Forward as defined on the ranks' operands; backward the transpose:
    each input gradient is what <g, f(x)> summed over ranks gives."""
    got = worlds(tp).run("tp_comm", op=op, seed=5, tp=tp)
    xs, ys, gs, dxs = ([a[k] for a in got] for k in ("x", "y", "g", "dx"))
    d = 1
    if op == "copy_to_tp":
        want_y, want_dx = xs, [sum(gs)] * tp
    elif op == "reduce_from_tp":
        want_y, want_dx = [sum(xs)] * tp, gs
    elif op.startswith("all_gather"):
        want_y = [np.concatenate(xs, axis=d)] * tp
        if op == "all_gather_partial":
            want_dx = [_piece(sum(gs), d, tp, r) for r in range(tp)]
        else:
            want_dx = [_piece(gs[r], d, tp, r) for r in range(tp)]
    elif op == "reduce_scatter":
        want_y = [_piece(sum(xs), d, tp, r) for r in range(tp)]
        want_dx = [np.concatenate(gs, axis=d)] * tp
    else:  # split of a Replicate input
        want_y = [_piece(xs[0], d, tp, r) for r in range(tp)]
        want_dx = [np.concatenate(gs, axis=d)] * tp
    for r in range(tp):
        np.testing.assert_allclose(ys[r], want_y[r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(dxs[r], want_dx[r], rtol=1e-6, atol=1e-6)


# ------------------------------------------------------ vocab-parallel loss
XENT = [(tp, ls) for tp in (2, 4) for ls in (0.0, 0.1)]


@pytest.mark.parametrize("tp,ls", XENT)
def test_vocab_parallel_loss_and_dlogits_pieces(worlds, tp, ls):
    rows, vocab, seed = 64, 128, 11
    got = worlds(tp).run("tp_xent", rows=rows, vocab=vocab, label_smoothing=ls, seed=seed, tp=tp)
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((rows, vocab)).astype(np.float32) * 3.0
    tgt = rng.integers(0, vocab, (rows,)).astype(np.int64)
    mesh = _mesh(tp)
    loss, dlg = jax.value_and_grad(lambda x: ref_xent(
        x, jnp.asarray(tgt, jnp.int32), mesh=mesh, vocab_dim_name="tp", label_smoothing=ls))(
        jnp.asarray(lg))
    dlg = np.asarray(dlg)
    for r, ans in enumerate(got):
        assert ulps_at_scale(np.asarray(ans["loss"]).reshape(1), np.asarray(loss).reshape(1)) <= ULPS
        assert ulps_at_scale(ans["dlogits"], _piece(dlg, 1, tp, r)) <= ULPS


# --------------------------------------------------- the parallel modules
@pytest.mark.parametrize("tp", [2, 4])
def test_parallel_linears_and_embedding_match_the_reference(worlds, tp):
    seed = 7
    got = worlds(tp).run("tp_patch", seed=seed, tp=tp)
    rng = np.random.default_rng(seed)
    w1 = rng.standard_normal((16, 32)).astype(np.float32) / 4
    b1 = rng.standard_normal((32,)).astype(np.float32) / 10
    w2 = rng.standard_normal((32, 8)).astype(np.float32) / 6
    b2 = rng.standard_normal((8,)).astype(np.float32) / 10
    table = rng.standard_normal((64, 16)).astype(np.float32)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    ids = rng.integers(0, 64, (4, 5)).astype(np.int64)
    mesh = _mesh(tp)
    col, row, emb = RefCol(32, mesh=mesh), RefRow(8, mesh=mesh), RefEmb(64, 16, mesh=mesh)

    def mlp(p, x):
        h = col.apply({"params": p["col"]}, x)
        return h, row.apply({"params": p["row"]}, h)

    p = {"col": {"kernel": w1, "bias": b1}, "row": {"kernel": w2, "bias": b2}}
    h, y = mlp(p, x)
    (dp, dx) = jax.grad(lambda p, x: jnp.sum(jnp.square(mlp(p, x)[1])), argnums=(0, 1))(p, x)
    e = emb.apply({"params": {"embedding": table}}, ids)
    dt = jax.grad(lambda t: jnp.sum(jnp.square(emb.apply({"params": {"embedding": t}}, ids))))(table)
    for r, ans in enumerate(got):
        close = lambda a, b, tol: np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)
        close(ans["h"], _piece(np.asarray(h), 1, tp, r), FWD_TOL)
        close(ans["y"], y, FWD_TOL)
        close(ans["e"], e, FWD_TOL)
        close(ans["dx"], dx, GRAD_TOL)
        close(ans["dw1"], _piece(np.asarray(dp["col"]["kernel"]), 1, tp, r), GRAD_TOL)
        close(ans["db1"], _piece(np.asarray(dp["col"]["bias"]), 0, tp, r), GRAD_TOL)
        close(ans["dw2"], _piece(np.asarray(dp["row"]["kernel"]), 0, tp, r), GRAD_TOL)
        close(ans["db2"], dp["row"]["bias"], GRAD_TOL)
        close(ans["dtable"], _piece(np.asarray(dt), 0, tp, r), GRAD_TOL)


# ------------------------------------------------- flash_attention_sharded
FLASH = [(tp, shape) for tp in (2, 4) for shape in ((2, 24, 8, 4, 16), (1, 40, 4, 4, 32))]


@pytest.mark.parametrize("tp,shape", FLASH, ids=lambda v: str(v))
def test_flash_attention_sharded_pieces(worlds, tp, shape):
    B, T, H, KV, D = shape
    seed = 3
    got = worlds(tp).run("tp_flash", shape=list(shape), seed=seed, tp=tp)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    out = np.asarray(ref_flash_sharded(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), _mesh(tp),
                                       batch_dims=(), head_dim="tp", causal=True))
    for r, ans in enumerate(got):
        assert ans["o"].shape == (B, T, H // tp, D)
        assert ulps_at_scale(ans["o"], _piece(out, 2, tp, r)) <= ULPS


def test_flash_attention_sharded_refuses_split_groups():
    """A GQA group split across ranks (its kv heads not divisible by the
    head dim) raises, as the reference's shard_map cannot split it."""
    import torch

    from vescale_tpu_torch.mesh import DeviceMesh
    from vescale_tpu_torch.ops.flash_attention import flash_attention_sharded

    q = torch.zeros(1, 4, 3, 8)
    kv = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="kv heads"):
        flash_attention_sharded(q, kv, kv, DeviceMesh(("tp",), (2,), device_type="cpu"))


@pytest.mark.parametrize("tp", [2])
def test_host_route_gives_the_backends_results(worlds, tp):
    """``collectives.HOST_ROUTE`` (the card's route for the op gloo refuses
    on CUDA tensors) gives the backend's own result, bitwise, and counts
    one ``<backend>.<op>.host_copy``."""
    for ans in worlds(tp).run("host_route", seed=9, tp=tp):
        for op, want in ans["plain"].items():
            np.testing.assert_array_equal(ans["routed"][op], want, err_msg=op)
        assert ans["copies"] == {f"gloo.{op}.host_copy": 1 for op in ans["plain"]}
