"""The port's prefix cache, multi-token paged step and speculative decoding
against the JAX package, on the CPU.

The same flax-initialised weights (through ``params_from_jax``) go through
``vescale_tpu.serve`` (the reference) and ``vescale_tpu_torch.serve`` (the
port, plain PyTorch on the CPU).  Held to the reference's own contract: the
radix tree's decisions, page ids and the cache fingerprint exactly equal
step by step; ``decode_multi`` and ``prefill_suffix`` logits and pools
within ``tests/test_torch_serve.py``'s ulp bounds; ``run_serve`` with the
prefix cache and with speculation exactly equal to ``run_serve_resilient``
in tokens, ledger, hit counts, acceptance counts and fingerprints, and to
plain decode in tokens.  A bf16 run measures how far the multi-token step
sits from prefill and plain decode, in bf16 steps.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vescale_tpu.analysis import envreg
from vescale_tpu.mesh import DeviceMesh
from vescale_tpu.models.llama import Llama
from vescale_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from vescale_tpu import serve as jserve
from vescale_tpu.serve.speculative import SpeculativeDecoder as JaxSpeculativeDecoder

from vescale_tpu_torch.kernels import ulps_at_scale
from vescale_tpu_torch.kernels.flash_attention import flash_fwd_reference
from vescale_tpu_torch.models import LlamaConfig, init_params, params_from_jax
from vescale_tpu_torch import serve as tserve
from vescale_tpu_torch import config as tconfig
from vescale_tpu_torch.serve.speculative import drafter_config, slice_drafter_params

from test_torch_serve import KV_ULP_BOUND, LOGIT_ULP_BOUND, SHAPES

BF16_ULP = 2.0 ** 16  # one bf16 step is 2^16 fp32 steps at the same scale


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


def _kc(ns, cfg, **kw):
    geo = dict(num_slots=2, page_size=4, pages_per_slot=4)
    geo.update(kw)
    return ns.KVCacheConfig(layers=cfg.num_hidden_layers, kv_heads=cfg.num_key_value_heads,
                            head_dim=cfg.head_dim, **geo)


def _jax_cache(cfg, **kw):
    return jserve.PagedKVCache(_kc(jserve, cfg, **kw), _mesh())


def _torch_cache(cfg, **kw):
    return tserve.PagedKVCache(_kc(tserve, cfg, **kw), device="cpu")


SIDES = {"jax": (_jax_cache, jserve.PrefixCache), "torch": (_torch_cache, tserve.PrefixCache)}
TREE_CFG = SHAPES["mha"]


class _Cfg:
    num_hidden_layers = TREE_CFG["num_hidden_layers"]
    num_key_value_heads = TREE_CFG["num_key_value_heads"]
    head_dim = TREE_CFG["hidden_size"] // TREE_CFG["num_attention_heads"]


# ============================================================= radix tree
def _state(c, t):
    """Everything the tree and the pool's bookkeeping decide, as ints."""
    return (tuple(int(x) for x in c.fingerprint()), t.node_count(), t.retained_pages,
            c.free_page_count(), tuple(int(x) for x in c._page_refs),
            tuple(map(tuple, c.page_table.tolist())), tuple(c.lengths.tolist()))


def _fill(c, t, prompt, max_new=0):
    """Admit + fake-prefill + insert one prompt; returns the slot."""
    got = t.try_admit(prompt, max_new)
    assert got is not None
    slot, _ = got
    c.commit_prefill(slot, len(prompt))
    t.insert(prompt, c.page_table[slot])
    return slot


def _match(t, toks):
    m, pages = t.match(toks)
    return m, [int(p) for p in pages]


def case_roundtrip_and_cap(mk, PC, rec):
    c = mk(_Cfg, num_slots=2, page_size=4, pages_per_slot=4)
    t = PC(c)
    prompt = tuple(range(1, 11))
    s = _fill(c, t, prompt)
    rec(_match(t, prompt[:8]), _match(t, prompt[:7]), t._match_cap(8), t._match_cap(9))
    c.free(s)
    got = t.try_admit(prompt, 0)
    assert got is not None and got[1] == 8
    rec(got, _state(c, t))


def case_split_on_divergence(mk, PC, rec):
    c = mk(_Cfg, num_slots=3, page_size=4, pages_per_slot=4)
    t = PC(c)
    pa = (1, 2, 3, 4, 5, 6, 7, 8, 9)
    pb = (1, 2, 3, 4, 9, 9, 9, 9, 1)
    _fill(c, t, pa)
    rec(t.node_count(), _state(c, t))
    _fill(c, t, pb)
    assert t.node_count() == 3
    rec(_match(t, pa[:8]), _match(t, pb[:8]), _match(t, pa), _state(c, t))


def case_dedup_existing_page_wins(mk, PC, rec):
    c = mk(_Cfg, num_slots=2, page_size=4, pages_per_slot=4)
    t = PC(c)
    prompt = tuple(range(1, 9))
    s0 = _fill(c, t, prompt)
    s1 = _fill(c, t, prompt)
    rec(t.retained_pages, _match(t, prompt[:8]), _state(c, t))
    c.free(s0), c.free(s1)
    rec(t.evictable_pages(), _state(c, t))


def case_lru_eviction_deterministic(mk, PC, rec):
    c = mk(_Cfg, num_slots=3, page_size=4, pages_per_slot=2)
    t = PC(c)
    slots = [_fill(c, t, (i + 1, i + 2, i + 3, i + 4)) for i in range(3)]
    for s in slots:
        c.free(s)
    t.match((1, 2, 3, 4))
    rec(t.evict(1), _state(c, t))
    assert t.match((2, 3, 4, 5))[0] == 0
    rec(_match(t, (1, 2, 3, 4)), _match(t, (2, 3, 4, 5)), _match(t, (3, 4, 5, 6)))


def case_evict_never_frees_referenced_page(mk, PC, rec):
    c = mk(_Cfg, num_slots=2, page_size=4, pages_per_slot=2)
    t = PC(c)
    s0 = _fill(c, t, (1, 2, 3, 4))
    rec(t.evictable_pages(), t.evict(1), _match(t, (1, 2, 3, 4)))
    c.free(s0)
    rec(t.evictable_pages(), t.evict(1), _state(c, t))


def case_max_pages_cap_evicts_lru_to_fit(mk, PC, rec):
    c = mk(_Cfg, num_slots=3, page_size=4, pages_per_slot=2)
    t = PC(c, max_pages=1)
    c.free(_fill(c, t, (1, 2, 3, 4)))
    c.free(_fill(c, t, (5, 6, 7, 8)))
    rec(t.retained_pages, _match(t, (1, 2, 3, 4)), _match(t, (5, 6, 7, 8)), _state(c, t))


def case_insert_cap_eviction_protects_attach_path(mk, PC, rec):
    c = mk(_Cfg, num_slots=2, page_size=4, pages_per_slot=3)
    t = PC(c, max_pages=2)
    c.free(_fill(c, t, (1, 2, 3, 4, 5, 6, 7, 8)))
    pb = (1, 2, 3, 4, 9, 9, 9, 9, 8, 8, 8, 8)
    s1 = c.alloc(len(pb), 0)
    c.commit_prefill(s1, len(pb))
    rec(t.insert(pb, c.page_table[s1]))
    c.free(s1)
    assert t.match(pb[:8])[0] == 8
    rec(_match(t, (1, 2, 3, 4)), _match(t, pb[:8]), _state(c, t))


def case_cache_reset_drops_tree_references(mk, PC, rec):
    c = mk(_Cfg, num_slots=2, page_size=4, pages_per_slot=4)
    t = PC(c)
    _fill(c, t, tuple(range(1, 9)))
    c.reset()
    assert c.free_page_count() == c.num_pages - 1
    rec(_state(c, t))


def case_tree_reset_releases_every_retained_page(mk, PC, rec):
    c = mk(_Cfg, num_slots=2, page_size=4, pages_per_slot=4)
    t = PC(c)
    c.free(_fill(c, t, tuple(range(1, 9))))
    t.reset()
    assert c.free_page_count() == c.num_pages - 1
    rec(_state(c, t))


def case_try_admit_evicts_to_cover_fresh_remainder(mk, PC, rec):
    c = mk(_Cfg, num_slots=2, page_size=4, pages_per_slot=2, num_pages=5)
    t = PC(c)
    c.free(_fill(c, t, (1, 2, 3, 4, 5, 6, 7, 8)))
    got = t.try_admit((9, 9, 9, 9, 8, 8, 8, 8), 0)
    rec(got, _state(c, t))
    c.free(got[0])
    t.reset()
    c.free(_fill(c, t, (1, 2, 3, 4, 5, 6, 7, 8)))
    got = t.try_admit((1, 2, 3, 4, 9, 9, 9, 9), 0)
    assert got is not None and got[1] == 4
    rec(got, _match(t, (1, 2, 3, 4)), _state(c, t))


TREE_CASES = [
    case_roundtrip_and_cap, case_split_on_divergence, case_dedup_existing_page_wins,
    case_lru_eviction_deterministic, case_evict_never_frees_referenced_page,
    case_max_pages_cap_evicts_lru_to_fit, case_insert_cap_eviction_protects_attach_path,
    case_cache_reset_drops_tree_references, case_tree_reset_releases_every_retained_page,
    case_try_admit_evicts_to_cover_fresh_remainder,
]


def _trace(case, side):
    mk, PC = SIDES[side]
    out = []
    case(mk, PC, lambda *v: out.append(v))
    return out


@pytest.mark.parametrize("case", TREE_CASES, ids=lambda f: f.__name__[5:])
def test_prefix_cache_case_equals_the_reference(case):
    theirs, ours = _trace(case, "jax"), _trace(case, "torch")
    assert ours and ours == theirs


def _random_ops(side, seed, page, max_pages, n_ops=500):
    """A numpy-seeded mix of try_admit / insert / evict / free over prompts
    that share prefixes; every step's result and state recorded."""
    mk, PC = SIDES[side]
    c = mk(_Cfg, num_slots=4, page_size=page, pages_per_slot=4, num_pages=11)
    t = PC(c, max_pages=max_pages)
    rng = np.random.default_rng(seed)
    stems = [tuple(int(x) for x in rng.integers(1, 9, 3 * page)) for _ in range(3)]
    pending, live, out = [], [], []
    for _ in range(n_ops):
        op = int(rng.choice(4, p=[0.35, 0.3, 0.1, 0.25]))
        if op == 0:
            stem = stems[int(rng.integers(0, len(stems)))]
            cut = int(rng.integers(page // 2, 3 * page))
            tail = tuple(int(x) for x in rng.integers(1, 9, int(rng.integers(1, page + 1))))
            prompt = (stem[:cut] + tail)[: 3 * page]
            got = t.try_admit(prompt, int(rng.integers(0, page + 1)))
            if got is not None:
                pending.append((got[0], prompt))
            res = got
        elif op == 1 and pending:
            slot, prompt = pending.pop(int(rng.integers(0, len(pending))))
            c.commit_prefill(slot, len(prompt))
            res = t.insert(prompt, c.page_table[slot])
            live.append(slot)
        elif op == 2:
            res = t.evict(int(rng.integers(1, 4)))
        else:
            slots = [s for s, _ in pending] + live
            res = None
            if slots:
                res = slots[int(rng.integers(0, len(slots)))]
                pending = [(s, p) for s, p in pending if s != res]
                live = [s for s in live if s != res]
                c.free(res)
        out.append((op, res, _state(c, t), t.stats.hits, t.stats.hit_tokens))
    return out


@pytest.mark.parametrize("seed,page,max_pages", [(0, 4, 0), (1, 5, 0), (2, 4, 5), (3, 5, 6)])
def test_prefix_cache_random_operations_equal_the_reference(seed, page, max_pages):
    theirs = _random_ops("jax", seed, page, max_pages)
    ours = _random_ops("torch", seed, page, max_pages)
    assert len(ours) == len(theirs) == 500
    for i, (o, j) in enumerate(zip(ours, theirs)):
        assert o == j, f"step {i}"
    hits = sum(1 for o in ours if o[0] == 0 and o[1] is not None and o[1][1])
    evicted = sum(o[1] for o in ours if o[0] == 2)
    assert hits >= 20 and evicted >= 5, (hits, evicted)


# ================================================ decode_multi, prefill_suffix
PROMPT = (5, 9, 17, 3, 44, 8, 21, 30, 2, 11)
SUFFIXED = PROMPT[:8] + (13, 14, 15)
WINDOW = (7, 11, 2, 5)  # one page wide, the suffix chunks' width: one JAX compile


def _multi_scenario(eng, cache):
    """Prefill PROMPT, score WINDOW in one decode_multi step, then admit
    SUFFIXED on the first two pages of PROMPT's slot and prefill its suffix."""
    slot = cache.alloc(len(PROMPT), 6)
    eng.prefill(PROMPT, slot)
    cache.commit_prefill(slot, len(PROMPT))
    toks = np.zeros((cache.num_slots, len(WINDOW)), np.int32)
    toks[slot] = WINDOW
    multi = np.asarray(eng.decode_multi(toks))[slot]
    pages = [int(p) for p in cache.page_table[slot][:2]]
    for p in pages:
        cache.retain_page(p)
    slot_b = cache.alloc_shared(pages, len(SUFFIXED), 4)
    cache.commit_prefill(slot_b, 8)
    suffix = np.asarray(eng.prefill_suffix(SUFFIXED, slot_b, 8))
    return multi, suffix, slot_b


def _jax_engine(jcfg, params, **kw):
    cache = _jax_cache(jcfg, **kw)
    return jserve.ServeEngine(jcfg, _mesh(), params, cache), cache


def _torch_engine(tcfg, params, **kw):
    cache = _torch_cache(tcfg, **kw)
    return tserve.ServeEngine(tcfg, params_from_jax(params, device="cpu"), cache, device="cpu"), cache


@pytest.fixture(scope="module")
def multi_runs(weights):
    out = {}
    for name, (jcfg, tcfg, params) in weights.items():
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("VESCALE_KERNELS", "off")
            jeng, jcache = _jax_engine(jcfg, params)
            jres = _multi_scenario(jeng, jcache)
            jpools = (np.asarray(jcache.k.data, np.float64)[:, 1:],
                      np.asarray(jcache.v.data, np.float64)[:, 1:])
        teng, tcache = _torch_engine(tcfg, params)
        tres = _multi_scenario(teng, tcache)
        tpools = (tcache.k.numpy().astype(np.float64)[:, 1:],
                  tcache.v.numpy().astype(np.float64)[:, 1:])
        out[name] = (jres, tres, jpools, tpools, jcache.fingerprint(), tcache.fingerprint(),
                     teng, tcache)
    return out


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_decode_multi_and_prefill_suffix_within_bound_of_the_reference(multi_runs, shape):
    (jm, js, _), (tm, ts, _), *_ = multi_runs[shape]
    assert tm.shape == jm.shape == (len(WINDOW), SHAPES[shape]["vocab_size"])
    assert tm.dtype == ts.dtype == np.float32
    assert ulps_at_scale(tm, jm) <= LOGIT_ULP_BOUND
    assert ulps_at_scale(ts, js) <= LOGIT_ULP_BOUND
    assert tm.argmax(-1).tolist() == jm.argmax(-1).tolist()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_multi_step_pools_within_bound_and_fingerprints_equal(multi_runs, shape):
    _, _, jpools, tpools, jfp, tfp, *_ = multi_runs[shape]
    for j, t in zip(jpools, tpools):
        assert ulps_at_scale(t, j) <= KV_ULP_BOUND
    assert tuple(int(x) for x in tfp) == tuple(int(x) for x in jfp)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_prefill_suffix_within_bound_of_a_full_prefill(multi_runs, weights, shape):
    _, (_, suffix, _), *_ = multi_runs[shape]
    _, tcfg, params = weights[shape]
    eng, cache = _torch_engine(tcfg, params)
    slot = cache.alloc(len(SUFFIXED), 4)
    full = eng.prefill(SUFFIXED, slot)
    assert ulps_at_scale(suffix, full) <= LOGIT_ULP_BOUND


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_decode_multi_matches_sequential_decode(weights, shape):
    """The window scored in one multi-token step has the argmax surface of
    sequential single-token decode steps."""
    _, tcfg, params = weights[shape]
    prompt, window = (5, 9, 17, 3, 44), (7, 11, 2)
    eng, cache = _torch_engine(tcfg, params)
    slot = cache.alloc(len(prompt), 8)
    eng.prefill(prompt, slot)
    cache.commit_prefill(slot, len(prompt))
    seq = []
    for tok in window:
        t = np.zeros((cache.num_slots,), np.int64)
        t[slot] = tok
        lg = eng.decode(t)
        cache.advance(slot)
        seq.append(lg[slot])
    eng2, cache2 = _torch_engine(tcfg, params)
    slot2 = cache2.alloc(len(prompt), 8)
    eng2.prefill(prompt, slot2)
    cache2.commit_prefill(slot2, len(prompt))
    toks = np.zeros((cache2.num_slots, len(window)), np.int64)
    toks[slot2] = window
    multi = eng2.decode_multi(toks)[slot2]
    assert multi.argmax(-1).tolist() == np.stack(seq).argmax(-1).tolist()
    assert ulps_at_scale(multi, np.stack(seq)) <= LOGIT_ULP_BOUND


def test_prefill_suffix_validations(weights):
    _, tcfg, params = weights["mha"]
    eng, cache = _torch_engine(tcfg, params)
    slot = cache.alloc(len(PROMPT), 2)
    cache.commit_prefill(slot, 8)
    with pytest.raises(ValueError, match="must be in"):
        eng.prefill_suffix(PROMPT, slot, 0)
    with pytest.raises(ValueError, match="page-aligned"):
        eng.prefill_suffix(PROMPT, slot, 6)
    with pytest.raises(ValueError, match="commit_prefill"):
        eng.prefill_suffix(PROMPT, slot, 4)


def test_decode_flops_per_step_beside_the_reference(weights, monkeypatch):
    """The port counts the projections, the head and attention's two
    products over every gathered position; XLA's cost analysis of the JAX
    step (kernels off) also counts the norms, rotary, softmax, activation
    and the gather's masking.  At the tiny config the port's count, 28,672
    (24,576 in the projections and head, 4,096 in attention), is 0.842 of
    XLA's 34,036; the test holds the ratio to 0.842 within 0.5%."""
    monkeypatch.setenv("VESCALE_KERNELS", "off")
    jcfg, tcfg, params = weights["mha"]
    jeng, _ = _jax_engine(jcfg, params)
    teng, _ = _torch_engine(tcfg, params)
    ours, theirs = teng.decode_flops_per_step(), jeng.decode_flops_per_step()
    c = tcfg
    S, Tmax = 2, 16
    matmuls = 2 * S * (c.num_hidden_layers * (c.hidden_size * 4 * c.hidden_size
                                              + 3 * c.hidden_size * c.intermediate_size)
                       + c.hidden_size * c.vocab_size)
    assert ours == matmuls + 2 * S * c.num_hidden_layers * 2 * c.hidden_size * Tmax
    assert theirs is not None and ours / theirs == pytest.approx(0.842, rel=5e-3)


# =============================================================== the loop
def _shared_arrivals(ns, n=5, plen_shared=6, max_new=4):
    """Tests/test_spec_prefix.py's arrivals: one shared system prompt plus a
    1-3 token tail each, every other step."""
    rng = np.random.default_rng(7)
    shared = tuple(int(x) for x in rng.integers(1, 60, plen_shared))
    out = []
    for i in range(n):
        tail = tuple(int(x) for x in rng.integers(1, 60, 1 + i % 3))
        out.append((2 * i, ns.Request(rid=i, prompt=shared + tail, max_new_tokens=max_new)))
    return out


def _ledger(res):
    return {rid: (o["status"], list(o["tokens"])) for rid, o in res.outcomes.items()}


def _serve(side, cfg, params, *, page, prefix, k=None, max_new=4):
    """One serve run on a fresh rig; returns what the comparison reads."""
    if side == "jax":
        eng, cache = _jax_engine(cfg, params, page_size=page)
        ns = jserve
    else:
        eng, cache = _torch_engine(cfg, params, page_size=page)
        ns = tserve
    pc = ns.PrefixCache(cache) if prefix else None
    sched = ns.ContinuousBatchingScheduler(cache, max_queue=16, prefix_cache=pc)
    spec = None
    if k is not None:
        dparams = (jserve.slice_drafter_params(params, 1) if side == "jax"
                   else slice_drafter_params(eng.params, 1))
        Spec = JaxSpeculativeDecoder if side == "jax" else tserve.SpeculativeDecoder
        spec = Spec(eng, dparams, drafter_layers=1, k=k)
    arrivals = _shared_arrivals(ns, max_new=max_new)
    if side == "jax":
        res = jserve.run_serve_resilient(engine=eng, scheduler=sched, arrivals=arrivals,
                                         speculative=spec, coordinate=False,
                                         install_signal_handlers=False)
    else:
        res = tserve.run_serve(eng, sched, arrivals, speculative=spec)
    sched.ledger_check()
    out = dict(ledger=_ledger(res), counts=dict(res.counts), steps=res.steps,
               cache_fp=tuple(int(x) for x in cache.fingerprint()),
               sched_fp=tuple(int(x) for x in sched.fingerprint()))
    if pc is not None:
        st = pc.stats
        out["prefix"] = (st.hits, st.misses, st.hit_tokens, st.prompt_tokens,
                         st.inserted_pages, st.evicted_pages, pc.node_count())
    if spec is not None:
        out["spec"] = (spec.drafted, spec.accepted, spec.verify_steps)
    if side == "torch":
        out["telemetry"] = dict(sched.telemetry.counters)
    return out


@pytest.fixture(scope="module")
def plain(weights):
    _, tcfg, params = weights["mha"]
    return {(page, max_new): _serve("torch", tcfg, params, page=page, prefix=False, max_new=max_new)
            for page in (4, 5) for max_new in (4, 5)}


def _check_equal(ours, theirs, golden):
    assert ours["ledger"] == theirs["ledger"]
    assert all(s == "completed" for s, _ in ours["ledger"].values())
    assert {r: t for r, (_, t) in ours["ledger"].items()} == {
        r: t for r, (_, t) in golden["ledger"].items()}
    for key in ("counts", "steps", "cache_fp", "sched_fp", "prefix", "spec"):
        assert ours.get(key) == theirs.get(key), key


@pytest.mark.parametrize("page", [4, 5])
def test_run_serve_prefix_cache_equals_the_reference_and_plain_decode(weights, plain, page,
                                                                     monkeypatch):
    monkeypatch.setenv("VESCALE_KERNELS", "off")
    jcfg, tcfg, params = weights["mha"]
    theirs = _serve("jax", jcfg, params, page=page, prefix=True)
    ours = _serve("torch", tcfg, params, page=page, prefix=True)
    _check_equal(ours, theirs, plain[page, 4])
    hits, _, hit_tokens = ours["prefix"][:3]
    assert hits >= 1 and hit_tokens > 0
    assert ours["telemetry"]["serve_prefix_hits_total"] == hits
    assert ours["telemetry"]["serve_prefix_hit_tokens_total"] == hit_tokens


@pytest.mark.parametrize("k", [1, 4, 8])
def test_run_serve_speculative_equals_the_reference_and_plain_decode(weights, plain, k,
                                                                    monkeypatch):
    monkeypatch.setenv("VESCALE_KERNELS", "off")
    jcfg, tcfg, params = weights["mha"]
    theirs = _serve("jax", jcfg, params, page=4, prefix=False, k=k, max_new=5)
    ours = _serve("torch", tcfg, params, page=4, prefix=False, k=k, max_new=5)
    _check_equal(ours, theirs, plain[4, 5])
    drafted, accepted, verify_steps = ours["spec"]
    assert verify_steps > 0 and drafted > 0 and 0 <= accepted <= drafted
    tel = ours["telemetry"]
    assert (tel["serve_spec_drafted_tokens_total"], tel["serve_spec_accepted_tokens_total"],
            tel["serve_spec_verify_steps_total"]) == (drafted, accepted, verify_steps)


def test_run_serve_speculative_with_prefix_cache_equals_the_reference(weights, plain,
                                                                      monkeypatch):
    monkeypatch.setenv("VESCALE_KERNELS", "off")
    jcfg, tcfg, params = weights["mha"]
    theirs = _serve("jax", jcfg, params, page=5, prefix=True, k=4)
    ours = _serve("torch", tcfg, params, page=5, prefix=True, k=4)
    _check_equal(ours, theirs, plain[5, 4])
    assert ours["prefix"][2] > 0 and ours["spec"][0] > 0


# ==================================================== speculative plumbing
def test_accept_budget_eos_and_self_correction():
    spec = tserve.SpeculativeDecoder.__new__(tserve.SpeculativeDecoder)
    spec.k = 4
    greedy = [3, 5, 1, 2, 7]
    lg = np.full((5, 8), -1.0, np.float32)
    lg[np.arange(5), greedy] = 1.0
    cases = [
        (greedy[:4], 10, None, greedy, 4),  # full acceptance + the bonus token
        ([3, 5, 9, 9], 10, None, [3, 5, 1], 2),  # first divergence: the correction
        ([0, 0, 0, 0], 10, None, [3], 0),  # an undrafted slot still emits
        (greedy[:4], 2, None, greedy[:2], 2),  # the budget clamps
        (greedy[:4], 10, 5, [3, 5], 2),  # EOS cuts mid-window
    ]
    for drafts, budget, eos, emitted, accepted in cases:
        assert spec.accept(np.array(drafts), lg, budget=budget, eos_id=eos) == (emitted, accepted)


def test_drafter_config_and_slice_validations(weights):
    _, tcfg, params = weights["mha"]
    assert drafter_config(tcfg, 1).num_hidden_layers == 1
    for bad in (0, tcfg.num_hidden_layers + 1):
        with pytest.raises(ValueError, match="drafter_layers"):
            drafter_config(tcfg, bad)
    tree = params_from_jax(params, device="cpu")
    sliced = slice_drafter_params(tree, 1)
    assert "layers_0" in sliced and "layers_1" not in sliced
    assert "embed_tokens" in sliced and "norm" in sliced and "lm_head" in sliced
    assert sliced["layers_0"] is tree["layers_0"]  # the same leaves, no copy
    assert slice_drafter_params({"params": tree}, 2).keys() == tree.keys()
    with pytest.raises(ValueError, match="layers_0"):
        slice_drafter_params({"embed_tokens": {}}, 1)


def test_drafter_holds_the_target_tensors(weights):
    _, tcfg, params = weights["gqa"]
    eng, _ = _torch_engine(tcfg, params)
    spec = tserve.SpeculativeDecoder(eng, slice_drafter_params(eng.params, 1),
                                     drafter_layers=1, k=2)
    assert spec.engine.params["layers_0"]["mlp"]["up_proj"]["kernel"] is (
        eng.params["layers_0"]["mlp"]["up_proj"]["kernel"])
    assert spec.cache.config.pool_pages == eng.cache.config.pool_pages
    assert spec.cache.config.layers == 1 and spec.engine.device == eng.device


def test_bad_k_raises(weights, monkeypatch):
    _, tcfg, params = weights["mha"]
    eng, _ = _torch_engine(tcfg, params)
    dparams = slice_drafter_params(eng.params, 1)
    for k in (0, -1):
        with pytest.raises(ValueError, match="k must be >= 1"):
            tserve.SpeculativeDecoder(eng, dparams, drafter_layers=1, k=k)
    monkeypatch.setenv("VESCALE_SPEC_K", "0")
    with pytest.raises(ValueError, match="k must be >= 1"):
        tserve.SpeculativeDecoder(eng, dparams, drafter_layers=1)
    monkeypatch.setenv("VESCALE_SPEC_K", "3")
    monkeypatch.setenv("VESCALE_SPEC_DRAFTER_LAYERS", "2")
    spec = tserve.SpeculativeDecoder(eng, slice_drafter_params(eng.params, 2))
    assert spec.k == 3 and spec.cache.config.layers == 2


KNOBS = ("VESCALE_SERVE_PREFIX_CACHE", "VESCALE_SERVE_PREFIX_CACHE_PAGES",
         "VESCALE_SPEC_K", "VESCALE_SPEC_DRAFTER_LAYERS")


@pytest.mark.parametrize("name", KNOBS)
def test_knob_defaults_equal_the_registrations(name, monkeypatch):
    monkeypatch.delenv(name, raising=False)
    var = envreg.lookup(name)
    assert tconfig.DEFAULTS[name] == var.default
    get = {"bool": tconfig.get_bool, "int": tconfig.get_int}[var.type]
    assert get(name) == {"bool": envreg.get_bool, "int": envreg.get_int}[var.type](name)


@pytest.mark.parametrize("raw", ["", "0", "false", "OFF", " no ", "1", "true", "yes"])
def test_get_bool_parses_as_envreg(raw, monkeypatch):
    monkeypatch.setenv("VESCALE_SERVE_PREFIX_CACHE", raw)
    assert tconfig.get_bool("VESCALE_SERVE_PREFIX_CACHE") == envreg.get_bool(
        "VESCALE_SERVE_PREFIX_CACHE")


def test_scheduler_builds_the_prefix_cache_from_env(monkeypatch):
    cache = _torch_cache(_Cfg)
    monkeypatch.setenv("VESCALE_SERVE_PREFIX_CACHE", "1")
    monkeypatch.setenv("VESCALE_SERVE_PREFIX_CACHE_PAGES", "3")
    sched = tserve.ContinuousBatchingScheduler(cache, max_queue=4)
    assert isinstance(sched.prefix, tserve.PrefixCache) and sched.prefix.cache is cache
    assert sched.prefix.max_pages == 3
    monkeypatch.delenv("VESCALE_SERVE_PREFIX_CACHE")
    assert tserve.ContinuousBatchingScheduler(cache, max_queue=4).prefix is None


def test_cpu_decode_is_the_eager_step_and_swap_params_drops_the_graph(weights):
    _, tcfg, params = weights["gqa"]
    eng, cache = _torch_engine(tcfg, params)
    eng2, cache2 = _torch_engine(tcfg, params)
    for e, c in ((eng, cache), (eng2, cache2)):
        slot = c.alloc(len(PROMPT), 4)
        e.prefill(PROMPT, slot)
        c.commit_prefill(slot, len(PROMPT))
    toks = np.array([7, 0])
    assert np.array_equal(eng.decode(toks), eng2.decode_eager(toks))
    assert eng._graph is None  # no graph on the CPU
    eng._graph = object()
    eng.swap_params(eng.params)
    assert eng._graph is None


# ========================================================= bf16 step gap
def _bf16_engine(page=8):
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=16,
                      num_attention_heads=8, num_key_value_heads=2, max_position_embeddings=128,
                      dtype=torch.bfloat16)
    params = init_params(cfg, seed=3, device="cpu", dtype=torch.bfloat16)
    kc = tserve.KVCacheConfig(layers=16, kv_heads=2, head_dim=cfg.head_dim, num_slots=2,
                              page_size=page, pages_per_slot=8, dtype=torch.bfloat16)
    cache = tserve.PagedKVCache(kc, device="cpu")
    return tserve.ServeEngine(cfg, params, cache, device="cpu"), cache


# The gaps below, in bf16 steps at the logits' scale, measured at 16 layers:
# 1.72 (suffix) and 2.0 (window) through the CPU's plain flash forward, 2.5
# and 4.0 with the prefill's attention through the model of the card's
# kernel, which rounds P to bf16.  At 32 layers the same measurement gave
# 3.1-3.8 and 4.2-5.0 (widths 256 and 512, two prompts).  The card adds
# what no CPU run models: cuBLAS sums the bf16 GEMMs in an order that
# depends on M (8 rows in decode, 16 in a suffix chunk, 1024 in prefill).
# So chip_smoke.py's spec_prefix phase holds Llama-3-8B's two comparisons to
# BF16_CARD_BOUND: three times the 32-layer measurement, rounded up.
BF16_CPU_BOUND = 4.0
BF16_CARD_BOUND = 16.0


@pytest.mark.parametrize("attention", ["plain", "card_model"])
def test_bf16_multi_token_step_gap_to_prefill_and_plain_decode(attention, monkeypatch):
    """bf16 weights and pool: the suffix prefill's last logits against a full
    prefill's, and a 16-token decode_multi window against 16 plain decode
    steps teacher-forced on the same tokens, in bf16 steps at scale.
    ``card_model`` sends the prefill's attention through
    ``flash_fwd_reference(pd_dtype=torch.bfloat16)``, the model of the
    card's flash kernel."""
    if attention == "card_model":
        ops_fa = importlib.import_module("vescale_tpu_torch.ops.flash_attention")
        monkeypatch.setattr(ops_fa, "flash_fwd", lambda *a, **kw: flash_fwd_reference(
            *a, pd_dtype=torch.bfloat16, **kw))
    rng = np.random.default_rng(11)
    shared = tuple(int(x) for x in rng.integers(1, 512, 32))
    prompt = shared + tuple(int(x) for x in rng.integers(1, 512, 13))
    eng, cache = _bf16_engine()
    first = cache.alloc(len(shared) + 1, 1)
    eng.prefill(shared + (1,), first)
    cache.commit_prefill(first, len(shared) + 1)
    pages = [int(p) for p in cache.page_table[first][:4]]
    for p in pages:
        cache.retain_page(p)
    cache.free(first)
    slot = cache.alloc_shared(pages, len(prompt), 16)
    cache.commit_prefill(slot, 32)
    suffix = eng.prefill_suffix(prompt, slot, 32)
    eng2, cache2 = _bf16_engine()
    slot2 = cache2.alloc(len(prompt), 16)
    full = eng2.prefill(prompt, slot2)
    cache2.commit_prefill(slot2, len(prompt))
    gap_suffix = ulps_at_scale(suffix, full) / BF16_ULP

    window = [int(np.argmax(full))]
    rows = []
    for _ in range(16):
        t = np.zeros((2,), np.int64)
        t[slot2] = window[-1]
        lg = eng2.decode(t)
        cache2.advance(slot2)
        rows.append(lg[slot2])
        window.append(int(np.argmax(lg[slot2])))
    toks = np.zeros((2, 16), np.int64)
    toks[slot] = window[:16]
    multi = eng.decode_multi(toks)[slot]
    gap_multi = ulps_at_scale(multi, np.stack(rows)) / BF16_ULP
    assert 0 < max(gap_suffix, gap_multi) <= BF16_CPU_BOUND, (gap_suffix, gap_multi)


def test_a_slot_the_drafter_cannot_mirror_decodes_undrafted(weights):
    """Prefix sharing lets the target's pool hold more than the drafter's,
    which allocates every slot's full need: such a slot is left undrafted,
    and leaves the set when it ends."""
    _, tcfg, params = weights["mha"]
    eng, cache = _torch_engine(tcfg, params, num_pages=5)
    spec = tserve.SpeculativeDecoder(eng, slice_drafter_params(eng.params, 1),
                                     drafter_layers=1, k=2)
    assert spec.admit(0, PROMPT[:8], 4) and spec.drafted_slots([0]) == [0]
    assert not spec.admit(1, PROMPT[:8], 4)  # 3 more pages; the drafter has 1
    assert spec.undrafted == {1} and spec.drafted_slots([0, 1]) == [0]
    spec.sync_slots([0])
    assert spec.undrafted == set() and spec.cache.active_slots() == [0]
