"""The port's context parallelism (``vescale_tpu_torch.parallel.context``)
against the JAX reference ``vescale_tpu.parallel.context`` on the same
numpy-seeded inputs.

Held:

  * ``blockwise_attention`` at an uneven T (the padded keys masked),
    causal and full, output and grads against the reference's
    ``blockwise_attention`` within its own 2e-5;
  * ``ring_self_attention`` and ``ulysses_self_attention`` on gloo worlds
    of 2 and 4 (children of ``tests/torch_spmd_child.py``, one spawn
    each), causal and full: every rank's output piece and its pieces of
    the q/k/v grads of sum(out * w) against the reference's on conftest's
    CPU mesh, within the reference's 2e-5; the ring with GQA k/v (the
    kernels' layout) against the reference on the repeated heads, its
    k/v grads summed over each group; the permute and all-to-all counts
    (the ring moves k and v together, n - 1 hops forward, and n - 1 + n
    backward with the travelling dk/dv sums);
  * the ring merges its steps through the global lse, so a merge that
    dropped the lse's cotangent would fail the grads above;
  * T % n != 0 raises, as the reference does (a ``DArray`` input);
  * Ulysses with no ``attn_fn`` runs the flash op;
  * the bench's ``longctx_cpu`` rung (the reference's long-context CPU
    smoke: block remat, T=512): three steps' losses against the
    reference ``make_train_step`` with ``adamw_lowmem(3e-4)`` from the
    same weights.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vescale_tpu as vt
from vescale_tpu.parallel import context as RC

from vescale_tpu_torch.parallel import blockwise_attention, ring_self_attention

import torch_spmd_child as child
from test_torch_ndtimeline import reset_all

TOL = 2e-5  # tests/test_context_parallel.py's rtol and atol


@pytest.fixture(autouse=True)
def managers_reset():
    reset_all()
    yield
    reset_all()


@pytest.fixture(scope="module")
def worlds():
    made = {n: child.World(n) for n in (2, 4)}  # both start together
    yield made
    for w in made.values():
        w.close()


def _qkv(shape, seed, kv_heads=None):
    B, T, H, D = shape
    rng = np.random.default_rng(seed)
    G = kv_heads or H
    return [rng.standard_normal(s).astype(np.float32) for s in ((B, T, H, D), (B, T, G, D),
                                                               (B, T, G, D))]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention_at_an_uneven_length(causal):
    shape = (2, 37, 4, 8)
    q, k, v = _qkv(shape, 3)
    w = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    ref_fn = lambda q, k, v: RC.blockwise_attention(q, k, v, causal=causal, block_size=16)
    ref = ref_fn(*(jnp.asarray(a) for a in (q, k, v)))
    ref_g = jax.grad(lambda q, k, v: jnp.sum(ref_fn(q, k, v) * w), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = blockwise_attention(*ts, causal=causal, block_size=16)
    (out * torch.from_numpy(w)).sum().backward()
    assert out.shape == shape
    _close(out.detach(), ref)
    for t, g in zip(ts, ref_g):
        _close(t.grad, g)


def _reference(kind, n, causal, shape, seed, kv_heads=None):
    """The reference's output and q/k/v grads of sum(out * w) on the
    global arrays; GQA k/v are repeated to the query heads inside the
    differentiated function (the reference takes H heads)."""
    q, k, v = _qkv(shape, seed, kv_heads)
    w = np.random.default_rng(seed + 1).standard_normal(shape).astype(np.float32)
    mesh = vt.DeviceMesh(("sp",), (n,))
    fn = RC.ring_self_attention if kind == "ring" else RC.ulysses_self_attention
    rep = shape[2] // (kv_heads or shape[2])

    def f(q, k, v):
        k, v = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)
        return fn(q, k, v, mesh, causal=causal)

    args = tuple(jnp.asarray(a) for a in (q, k, v))
    out = f(*args)
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * w), argnums=(0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


CASES = [("ring", 2, True, None), ("ring", 2, False, None), ("ring", 4, True, None),
         ("ring", 4, False, None), ("ring", 4, True, 2), ("ulysses", 2, True, None),
         ("ulysses", 2, False, None), ("ulysses", 4, True, None), ("ulysses", 4, False, None)]


@pytest.mark.parametrize("kind,n,causal,kv_heads", CASES)
def test_sharded_attention_matches_the_reference(worlds, kind, n, causal, kv_heads):
    shape = (2, 32, 4, 8)
    ranks = worlds[n].run("ctx_attn", kind=kind, causal=causal, seed=11, shape=list(shape),
                          kv_heads=kv_heads)
    out, grads = _reference(kind, n, causal, shape, 11, kv_heads)
    t = shape[1] // n
    for r, got in enumerate(ranks):
        sl = slice(r * t, (r + 1) * t)
        _close(got["out"], out[:, sl])
        for name, g in zip(("dq", "dk", "dv"), grads):
            _close(got[name], g[:, sl])
        calls = got["calls"]
        if kind == "ring":
            # k and v move together: n - 1 hops forward, n - 1 backward and
            # n hops of the travelling dk/dv sums
            assert calls == {"gloo.ppermute": 3 * n - 2}, calls
        else:
            # q, k, v in and the output back, forward and backward
            assert calls == {"gloo.all_to_all": 8}, calls


def test_seq_len_must_divide_the_sp_size():
    from vescale_tpu_torch.darray import distribute_tensor
    from vescale_tpu_torch.mesh import DeviceMesh
    from vescale_tpu_torch.placements import Shard

    mesh = DeviceMesh(("sp",), (4,), device_type="cpu")
    x = torch.zeros(1, 30, 4, 8)
    q = distribute_tensor(x, mesh, [Shard(1)], rank=0)
    with pytest.raises(ValueError, match="not divisible by sp=4"):
        ring_self_attention(q, q, q, mesh)
    rmesh = vt.DeviceMesh(("sp",), (4,))
    with pytest.raises(ValueError, match="not divisible by sp=4"):
        RC.ring_self_attention(*(jnp.zeros((1, 30, 4, 8)),) * 3, rmesh)


def test_ulysses_runs_the_flash_op_by_default(monkeypatch):
    """With no ``attn_fn`` Ulysses runs ``ops.flash_attention``, whose
    forward is ``kernels.flash_fwd`` (the kernel on a CUDA tensor, its
    plain version here), never the dense attention: the output is the
    flash op's, bitwise, through one ``flash_fwd`` call."""
    import importlib

    from vescale_tpu_torch.mesh import DeviceMesh
    from vescale_tpu_torch.parallel import ulysses_self_attention

    ops = importlib.import_module("vescale_tpu_torch.ops.flash_attention")

    calls = []
    real = ops.flash_fwd
    monkeypatch.setattr(ops, "flash_fwd", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 64, 4, 16, generator=g)
    k, v = (torch.randn(1, 64, 2, 16, generator=g) for _ in range(2))
    out = ulysses_self_attention(q, k, v, DeviceMesh(("sp",), (1,), device_type="cpu"))
    assert calls == [1]
    assert torch.equal(out, ops.flash_attention(q, k, v))


@pytest.mark.parametrize("layout", [{}, dict(scan_layers=True, remat_scope="mlp")],
                         ids=["rung", "longctx_layout"])
def test_longctx_cpu_rung_trains_as_the_reference(layout):
    """Three steps of the bench's longctx_cpu rung against the reference
    ``make_train_step`` over ``adamw_lowmem(3e-4)``, from the reference's
    weights, on the reference bench's batch; and the same with the card
    rung's layout (``scan_layers``, remat over the MLP: the recompute runs
    on the scanned layer's slices)."""
    from vescale_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig
    from vescale_tpu.models.nanogpt import cross_entropy_loss as jax_xent
    from vescale_tpu.parallel.optimizer import adamw_lowmem
    from vescale_tpu.train import make_train_step as jax_step

    from vescale_tpu_torch import bench
    from vescale_tpu_torch.models import load_params, params_from_jax

    T = 512
    cfg = JConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=T,
                  dtype=jnp.float32, remat=True, **layout)
    params = JLlama(cfg).init(jax.random.key(0), jnp.ones((1, T), jnp.int32))["params"]
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, T + 1))
    batch = {"input": jnp.asarray(toks[:, :-1], jnp.int32), "target": jnp.asarray(toks[:, 1:])}
    tx = adamw_lowmem(3e-4)
    step = jax_step(JLlama(cfg), tx, lambda lg, b: jax_xent(lg, b["target"]), donate=False)
    p, s, ref = params, tx.init(params), []
    for _ in range(3):
        p, s, loss = step(p, s, batch)
        ref.append(float(loss))

    if layout:  # the card rung's layout on the cpu rung's config
        fields = dict(bench.RUNGS["longctx_cpu"][0], **layout)
        model = bench.Llama(bench.LlamaConfig(max_position_embeddings=T, **fields),
                            params_from_jax(params, device="cpu"), device="cpu")
        opt = bench.AdamWLowmem(model.parameters(), bench.LR,
                                state_dtype=bench.RUNGS["longctx_cpu"][3])
        step = bench.make_train_step(model, opt,
                                     lambda lg, b: bench.cross_entropy_loss(lg, b["target"]))
        t = torch.from_numpy(toks)
        next_batch = lambda: {"input": t[:, :-1], "target": t[:, 1:]}
    else:
        run = bench.prepare("longctx_cpu")
        assert run.config.remat and run.config.max_position_embeddings == T
        load_params(run.model, params_from_jax(params, device="cpu"))
        step, next_batch = run.step, run.next_batch
    got = [float(step(next_batch())) for _ in range(3)]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
    assert got[-1] < got[0]
