"""The port's serve slice as a whole against the JAX package, on the CPU.

The same flax-initialised Llama weights go through ``vescale_tpu.serve``
(the reference) and ``vescale_tpu_torch.serve`` (the port, plain PyTorch
on the CPU).  Held to the reference's own contract: prefill logits within
a stated ulp bound, greedy token streams and the serve loop's outcomes
ledger exactly equal, K/V pools within the bound.  The JAX engine runs once
with ``VESCALE_KERNELS=off`` (its XLA decode chain) and once at
``interpret`` (its Pallas kernels through the interpreter).
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

from vescale_tpu_torch.kernels import LAUNCHES, ulps_at_scale
from vescale_tpu_torch.models import LlamaConfig, params_from_jax
from vescale_tpu_torch import serve as tserve

# fp32 everywhere; XLA and PyTorch sum the projections and attention in
# different orders, two layers deep, so logits and the cached K/V differ
# by that rounding (about 6 ulps at tensor scale on these shapes)
LOGIT_ULP_BOUND = 16.0
KV_ULP_BOUND = 16.0
DECODE_STEPS = 8
PROMPTS = ((5, 9, 17, 3, 44), (7, 3, 29), (40, 2, 33, 8, 12, 6))

SHAPES = {
    # the tiny config of tests/test_serve.py, and a GQA variant (H=4, KV=2)
    "mha": dict(vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=64),
    "gqa": dict(vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64),
}
CACHE = dict(num_slots=2, page_size=4, pages_per_slot=4)


def _mesh():
    return DeviceMesh(("tp",), (1,), devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def weights():
    out = {}
    for name, shape in SHAPES.items():
        jcfg = JaxLlamaConfig(dtype=jnp.float32, **shape)
        params = Llama(jcfg).init(jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"]
        params = jax.tree_util.tree_map(np.asarray, params)
        out[name] = (jcfg, LlamaConfig(dtype=torch.float32, **shape), params)
    return out


def _jax_engine(jcfg, params):
    kc = jserve.KVCacheConfig(layers=jcfg.num_hidden_layers, kv_heads=jcfg.num_key_value_heads,
                              head_dim=jcfg.head_dim, **CACHE)
    cache = jserve.PagedKVCache(kc, _mesh())
    return jserve.ServeEngine(jcfg, _mesh(), params, cache), cache


def _torch_engine(tcfg, params):
    kc = tserve.KVCacheConfig(layers=tcfg.num_hidden_layers, kv_heads=tcfg.num_key_value_heads,
                              head_dim=tcfg.head_dim, **CACHE)
    cache = tserve.PagedKVCache(kc, device="cpu")
    return tserve.ServeEngine(tcfg, params_from_jax(params, device="cpu"), cache, device="cpu"), cache


def _generate(eng, cache, prompt):
    """Prefill one prompt, then DECODE_STEPS greedy decode steps; returns
    (prefill logits, token stream).  The slot stays allocated."""
    slot = cache.alloc(len(prompt), DECODE_STEPS + 1)
    first = np.asarray(eng.prefill(prompt, slot))
    cache.commit_prefill(slot, len(prompt))
    toks = [int(np.argmax(first))]
    for _ in range(DECODE_STEPS):
        t = np.zeros((cache.num_slots,), np.int32)
        t[slot] = toks[-1]
        lg = np.asarray(eng.decode(t))
        cache.advance(slot)
        toks.append(int(np.argmax(lg[slot])))
    return first, toks


def _pools(k, v):
    """(k, v) as float64 numpy without the null page 0 (racing writes)."""
    return np.asarray(k, np.float64)[:, 1:], np.asarray(v, np.float64)[:, 1:]


@pytest.fixture(scope="module")
def runs(weights):
    """Both packages over PROMPTS (two of them sharing the batch), per
    config and per JAX kernel mode; the env is restored on exit."""
    out = {}
    for name, (jcfg, tcfg, params) in weights.items():
        teng, tcache = _torch_engine(tcfg, params)
        tres = [_generate(teng, tcache, p) for p in PROMPTS[:2]]
        tpools = _pools(tcache.k.numpy(), tcache.v.numpy())
        for mode in ("off", "interpret"):
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("VESCALE_KERNELS", mode)
                jeng, jcache = _jax_engine(jcfg, params)
                jres = [_generate(jeng, jcache, p) for p in PROMPTS[:2]]
                jpools = _pools(jcache.k.data, jcache.v.data)
            out[name, mode] = (jres, tres, jpools, tpools, jcache.fingerprint(), tcache.fingerprint())
    return out


@pytest.mark.parametrize("mode", ["off", "interpret"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_prefill_logits_within_bound(runs, shape, mode):
    jres, tres, *_ = runs[shape, mode]
    for (jl, _), (tl, _) in zip(jres, tres):
        assert tl.shape == jl.shape and tl.dtype == np.float32
        assert ulps_at_scale(tl, jl) <= LOGIT_ULP_BOUND


@pytest.mark.parametrize("mode", ["off", "interpret"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_greedy_streams_equal(runs, shape, mode):
    jres, tres, *_ = runs[shape, mode]
    for (_, jt), (_, tt) in zip(jres, tres):
        assert len(tt) == DECODE_STEPS + 1
        assert tt == jt


@pytest.mark.parametrize("mode", ["off", "interpret"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kv_pools_within_bound_and_fingerprints_equal(runs, shape, mode):
    _, _, jpools, tpools, jfp, tfp = runs[shape, mode]
    for j, t in zip(jpools, tpools):
        assert t.shape == j.shape
        assert ulps_at_scale(t, j) <= KV_ULP_BOUND
    assert tuple(int(x) for x in tfp) == tuple(int(x) for x in jfp)


def _arrivals():
    """Seven requests over two slots: queueing, slot turnover, a request
    that completes at its prefill, and one shed by the bounded queue."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(7):
        prompt = tuple(int(x) for x in rng.integers(1, 60, 3 + i % 3))
        out.append((i // 2, dict(rid=i, prompt=prompt, max_new_tokens=1 if i == 4 else 4,
                                 deadline_steps=50)))
    return out


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_run_serve_ledger_equals_run_serve_resilient(weights, shape, monkeypatch):
    monkeypatch.setenv("VESCALE_KERNELS", "off")
    jcfg, tcfg, params = weights[shape]
    arrivals = _arrivals()

    jeng, jcache = _jax_engine(jcfg, params)
    jsched = jserve.ContinuousBatchingScheduler(jcache, max_queue=3)
    jres = jserve.run_serve_resilient(
        engine=jeng, scheduler=jsched,
        arrivals=[(s, jserve.Request(**r)) for s, r in arrivals],
        coordinate=False, install_signal_handlers=False,
    )
    teng, tcache = _torch_engine(tcfg, params)
    tsched = tserve.ContinuousBatchingScheduler(tcache, max_queue=3)
    tres = tserve.run_serve(teng, tsched, [(s, tserve.Request(**r)) for s, r in arrivals])

    tsched.ledger_check()
    ledger = lambda res: {rid: (o["status"], list(o["tokens"])) for rid, o in res.outcomes.items()}
    assert ledger(tres) == ledger(jres)
    assert tres.counts == jres.counts
    assert tres.steps == jres.steps
    assert tsched.fingerprint() == jsched.fingerprint()
    assert {o["status"] for o in tres.outcomes.values()} >= {"completed", "shed"}


def test_cpu_serve_launches_no_kernel(weights):
    _, tcfg, params = weights["gqa"]
    before = dict(LAUNCHES)
    teng, tcache = _torch_engine(tcfg, params)
    _generate(teng, tcache, PROMPTS[2])
    assert LAUNCHES == before
