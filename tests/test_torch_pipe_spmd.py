"""The compiled pipeline over a ``pp`` mesh (``pipe/spmd.py``) against the
JAX package's, on the CPU: gloo worlds of 2 and 4 ranks (children of
``tests/torch_spmd_child.py``, spawned once a size) run
``pipeline_blocks`` (V = 1, 2; M = S and 2S) and ``pipeline_blocks_zb``
(V = 1, 2) of tests/test_pipeline.py's ``_ZBBlk`` chunks, and the
reference runs the same stacked weights (numpy-seeded) on conftest's
8-device mesh, ("pp", "dp") = (S, 8 / S), under ``jax.jit``.

Held, on every rank: the output and the loss mean(out²) within
``OUT_ULPS``; this rank's (V, ...) slice of the stacked grads and the
input's grad within ``GRAD_ULPS`` of the reference's (both sum chunk grads
over microbatches in their own orders); the input's grad equal on every
rank.  The zero-bubble dgrad phase runs no weight-grad matmul: counted by
``graph_split.OpRecorder``, it runs the two products of each recomputed
block and their two input-grad products, and nothing else.  The replicated embedding and head
around the pipeline (trap (a): the output's backward delivers the last
stage's one cotangent, not S of them; trap (b): stage 0's input grad
reaches every rank's embedding): every rank's loss and grads equal each
other bitwise and the reference's within ``GRAD_ULPS``.  ``PipeEngine``
refuses a live world of 2.
"""

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp

import vescale_tpu as vt
from vescale_tpu.pipe.spmd import pipeline_blocks, pipeline_blocks_zb, stack_interleaved_params

from vescale_tpu_torch.kernels import ulps_at_scale
from vescale_tpu_torch.pipe.pipe_stage import flatten_tree

import torch_spmd_child as child

OUT_ULPS = 32.0   # measured 13 (the loss's mean over 2,048 squares), outputs 5.5
GRAD_ULPS = 32.0  # measured 9 (grads 6, input grads 7.6)


class _ZBBlk(nn.Module):
    """tests/test_pipeline.py's fixture block."""

    @nn.compact
    def __call__(self, x):
        h = nn.Dense(64)(nn.LayerNorm()(x))
        return x + nn.Dense(x.shape[-1])(nn.tanh(h))


_BLK = _ZBBlk()


def _bf(p, xm):
    return _BLK.apply({"params": p}, xm)


@pytest.fixture(scope="module")
def worlds():
    ws = {}
    yield lambda n: ws.setdefault(n, child.World(n, timeout_s=120))
    for w in ws.values():
        w.close()


_REF = {}


def _reference(S, V, M, zb, seed=0):
    key = (S, V, M, zb, seed)
    if key not in _REF:
        mesh = vt.DeviceMesh(("pp", "dp"), (S, 8 // S))
        plist = jax.tree_util.tree_map(jnp.asarray, child.zb_block_params(S * V, seed))
        stacked = stack_interleaved_params(plist, S)
        x = jnp.asarray(child.pipe_input(seed + 1))
        run = pipeline_blocks_zb if zb else pipeline_blocks

        def loss(s, x):
            out = run(_bf, s, x, mesh, num_microbatches=M, virtual_chunks=V)
            return (out ** 2).mean(), out

        (l, out), (gs, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            stacked, x)
        _REF[key] = (float(l), np.asarray(out), flatten_tree(jax.tree_util.tree_map(np.asarray, gs)),
                     np.asarray(gx))
    return _REF[key]


CASES = [(V, mult, zb) for zb, V, mult in ((False, 1, 1), (False, 1, 2), (False, 2, 1),
                                           (False, 2, 2), (True, 1, 1), (True, 2, 2))]


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("V,mult,zb", CASES)
def test_pipeline_blocks_match_the_reference(worlds, S, V, mult, zb):
    M = mult * S
    ranks = worlds(S).run("pipe_blocks", V=V, M=M, zb=zb)
    l, out, gs, gx = _reference(S, V, M, zb)
    for r, res in enumerate(ranks):
        assert ulps_at_scale(res["loss"], l) <= OUT_ULPS
        assert ulps_at_scale(res["out"], out) <= OUT_ULPS
        assert ulps_at_scale(res["dx"], gx) <= GRAD_ULPS
        assert np.array_equal(res["dx"], ranks[0]["dx"])
        for k, g in res["grads"].items():
            assert ulps_at_scale(g, gs[k][r * V:(r + 1) * V]) <= GRAD_ULPS, (r, k)
        # the dgrad phase recomputes each of its M*V active steps' two
        # products and runs two input-grad products; a weight-grad product
        # would make it three
        assert res["dgrad_matmuls"] == (4 * M * V if zb else 0)


def _reference_embed_head(S, V, M, zb, seed=0):
    mesh = vt.DeviceMesh(("pp", "dp"), (S, 8 // S))
    rng = np.random.default_rng(seed + 7)
    E, VOC = child.PIPE_E, child.PIPE_VOCAB
    table = jnp.asarray((rng.standard_normal((VOC, E)) * 0.5).astype(np.float32))
    head = jnp.asarray((rng.standard_normal((E, VOC)) / np.sqrt(E)).astype(np.float32))
    toks = jnp.asarray(rng.integers(0, VOC, (child.PIPE_B, child.PIPE_T + 1)))
    stacked = stack_interleaved_params(
        jax.tree_util.tree_map(jnp.asarray, child.zb_block_params(S * V, seed)), S)
    run = pipeline_blocks_zb if zb else pipeline_blocks

    def loss(table, head):
        out = run(_bf, stacked, table[toks[:, :-1]], mesh, num_microbatches=M, virtual_chunks=V)
        logits = (out @ head).reshape(-1, VOC)
        gold = jnp.take_along_axis(logits, toks[:, 1:].reshape(-1, 1), axis=-1)[:, 0]
        return jnp.mean(jax.nn.logsumexp(logits, axis=-1) - gold)

    l, (gt, gh) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(table, head)
    return float(l), np.asarray(gt), np.asarray(gh)


@pytest.mark.parametrize("S,V,zb", [(2, 1, False), (2, 2, True), (4, 1, True), (4, 2, False)])
def test_replicated_embedding_and_head_around_the_pipeline(worlds, S, V, zb):
    M = S
    ranks = worlds(S).run("pipe_embed_head", V=V, M=M, zb=zb)
    l, gt, gh = _reference_embed_head(S, V, M, zb)
    for res in ranks:
        assert res["loss"] == ranks[0]["loss"]
        assert np.array_equal(res["table_grad"], ranks[0]["table_grad"])  # trap (b)
        assert np.array_equal(res["head_grad"], ranks[0]["head_grad"])
        assert ulps_at_scale(res["loss"], l) <= OUT_ULPS
        # trap (a): one cotangent from the last stage, not S summed copies
        assert ulps_at_scale(res["table_grad"], gt) <= GRAD_ULPS
        assert ulps_at_scale(res["head_grad"], gh) <= GRAD_ULPS


def test_pipe_engine_refuses_a_multi_rank_world(worlds):
    assert [r["refused"] for r in worlds(2).run("pipe_engine_refuses")] == [True, True]
