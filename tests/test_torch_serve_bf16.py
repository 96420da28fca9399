"""The port's serve slice in bf16 against the JAX package's bf16 engine, on
the CPU.

The same flax-initialised Llama weights, rounded once to bf16, go through
``vescale_tpu.serve`` (the reference, ``LlamaConfig(dtype=bfloat16)`` and a
bf16 ``KVCacheConfig``) and ``vescale_tpu_torch.serve`` (the port, plain
PyTorch on the CPU, the same dtypes): the configuration the serve path runs
on the card, where the paged decode kernel reads bf16 pools.  The JAX
engine runs with ``VESCALE_KERNELS=off`` (its XLA chain) and at
``interpret`` (its Pallas kernels through the interpreter).

Checks: prefill logits, decode logits teacher-forced on the reference's
tokens, and the K/V pools, each within a stated bf16 bound; the greedy
streams equal, and where a stream parts, the reference's top-2 margin there
is within what the logit bound allows.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vescale_tpu.mesh import DeviceMesh
from vescale_tpu.models.llama import Llama
from vescale_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from vescale_tpu import serve as jserve

from vescale_tpu_torch.kernels import ulps_at_scale
from vescale_tpu_torch.models import LlamaConfig, params_from_jax
from vescale_tpu_torch import serve as tserve

from test_torch_serve import CACHE, DECODE_STEPS, PROMPTS, SHAPES

# One bf16 step is 2^16 fp32 ulps at the same scale.  Both engines round to
# bf16 at every op boundary the model code names, but not at the same
# places: at VESCALE_KERNELS=off the JAX prefill's attention
# (ops/flash_attention.py::_dense_ref) rounds the scores and P to bf16 where
# the port's plain version keeps them in fp32 (as the JAX kernels do at
# interpret); under jit XLA keeps fp32 between the fused elementwise ops
# (silu(g) * u) where PyTorch rounds each op.  Each is at most one bf16 step
# on an element, compounded through two layers of a 16-wide bf16 residual
# stream: 2.3-3.1 steps at scale measured on these shapes.  Bound: 4 steps.
BF16_STEP_ULPS = 2.0 ** 16
LOGIT_BOUND = 4 * BF16_STEP_ULPS
KV_BOUND = 4 * BF16_STEP_ULPS
MODES = ("off", "interpret")


def _mesh():
    return DeviceMesh(("tp",), (1,), devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def weights():
    """Per config: the JAX config and bf16 tree, the port's config and the
    same tree as torch bf16 (the fp32 init rounded once, identically)."""
    out = {}
    for name, shape in SHAPES.items():
        init_cfg = JaxLlamaConfig(dtype=jnp.float32, **shape)
        params = Llama(init_cfg).init(jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"]
        params = jax.tree_util.tree_map(np.asarray, params)
        jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
        tparams = params_from_jax(params, device="cpu", dtype=torch.bfloat16)
        out[name] = (JaxLlamaConfig(dtype=jnp.bfloat16, **shape), jparams,
                     LlamaConfig(dtype=torch.bfloat16, **shape), tparams)
    return out


def _jax_engine(jcfg, params):
    kc = jserve.KVCacheConfig(layers=jcfg.num_hidden_layers, kv_heads=jcfg.num_key_value_heads,
                              head_dim=jcfg.head_dim, dtype=jnp.bfloat16, **CACHE)
    cache = jserve.PagedKVCache(kc, _mesh())
    return jserve.ServeEngine(jcfg, _mesh(), params, cache), cache


def _torch_engine(tcfg, params):
    kc = tserve.KVCacheConfig(layers=tcfg.num_hidden_layers, kv_heads=tcfg.num_key_value_heads,
                              head_dim=tcfg.head_dim, dtype=torch.bfloat16, **CACHE)
    cache = tserve.PagedKVCache(kc, device="cpu")
    return tserve.ServeEngine(tcfg, params, cache, device="cpu"), cache


def _run(eng, cache, prompt, forced=None):
    """Prefill, then DECODE_STEPS decode steps; returns the logits row of
    each step.  Each step is fed ``forced[i]`` when given (teacher forcing
    on the reference's tokens), else the greedy token.  The slot stays
    allocated, so the second prompt shares the batch with the first."""
    slot = cache.alloc(len(prompt), DECODE_STEPS + 1)
    rows = [np.asarray(eng.prefill(prompt, slot), np.float32)]
    cache.commit_prefill(slot, len(prompt))
    for i in range(DECODE_STEPS):
        t = np.zeros((cache.num_slots,), np.int32)
        t[slot] = forced[i] if forced is not None else int(np.argmax(rows[-1]))
        rows.append(np.asarray(eng.decode(t), np.float32)[slot])
        cache.advance(slot)
    return rows


def _pools(k, v):
    """(k, v) as float64 numpy without the null page 0 (racing writes)."""
    return tuple(np.asarray(x, np.float64)[:, 1:] for x in (k, v))


@pytest.fixture(scope="module")
def runs(weights):
    """Per config and JAX kernel mode: the reference's logits rows and greedy
    tokens, the port's teacher-forced logits rows, and both pools."""
    out = {}
    for name, (jcfg, jparams, tcfg, tparams) in weights.items():
        for mode in MODES:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("VESCALE_KERNELS", mode)
                jeng, jcache = _jax_engine(jcfg, jparams)
                jrows = [_run(jeng, jcache, p) for p in PROMPTS[:2]]
                jpools = _pools(jcache.k.data.astype(jnp.float32), jcache.v.data.astype(jnp.float32))
            jtoks = [[int(np.argmax(r)) for r in rows] for rows in jrows]
            teng, tcache = _torch_engine(tcfg, tparams)
            trows = [_run(teng, tcache, p, forced=t) for p, t in zip(PROMPTS[:2], jtoks)]
            tpools = _pools(tcache.k.float().numpy(), tcache.v.float().numpy())
            out[name, mode] = (jrows, jtoks, trows, jpools, tpools)
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bf16_prefill_logits_within_bound(runs, shape, mode):
    jrows, _, trows, *_ = runs[shape, mode]
    for j, t in zip(jrows, trows):
        assert t[0].shape == j[0].shape and np.isfinite(t[0]).all()
        assert ulps_at_scale(t[0], j[0]) <= LOGIT_BOUND


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bf16_decode_logits_teacher_forced_within_bound(runs, shape, mode):
    jrows, _, trows, *_ = runs[shape, mode]
    for j, t in zip(jrows, trows):
        assert len(t) == DECODE_STEPS + 1
        assert ulps_at_scale(np.stack(t[1:]), np.stack(j[1:])) <= LOGIT_BOUND


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bf16_kv_pools_within_bound(runs, shape, mode):
    *_, jpools, tpools = runs[shape, mode]
    for j, t in zip(jpools, tpools):
        assert t.shape == j.shape
        assert ulps_at_scale(t, j) <= KV_BOUND


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bf16_greedy_streams_equal_or_part_at_a_near_tie(runs, shape, mode):
    """The port's greedy token at each step (argmax of its teacher-forced
    logits) is the reference's.  Where it is not, the logits there are
    within the bound of each other elementwise, so the reference's margin
    between its token and the port's is at most twice the bound in absolute
    terms (each of the two logits may move by the bound): a near-tie, which
    the test checks."""
    jrows, jtoks, trows, *_ = runs[shape, mode]
    for j, toks, t in zip(jrows, jtoks, trows):
        scale = float(np.max(np.abs(np.stack(j))))
        allowed = 2 * LOGIT_BOUND * float(np.spacing(np.float32(scale)))
        for i, (row, tok) in enumerate(zip(t, toks)):
            mine = int(np.argmax(row))
            if mine != tok:
                assert j[i][tok] - j[i][mine] <= allowed, (i, tok, mine)
