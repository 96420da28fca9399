"""The port's paged KV cache against the JAX package's, on the CPU: the same
sequence of host operations gives the same page table, lengths, refcounts
and fingerprint, step by step."""

import numpy as np
import pytest

import jax
import torch

from vescale_tpu.analysis import envreg
from vescale_tpu.mesh import DeviceMesh
from vescale_tpu.serve import kv_cache as jkv

from vescale_tpu_torch import config as tconfig
from vescale_tpu_torch.serve import kv_cache as tkv

GEOM = dict(layers=2, kv_heads=2, head_dim=8, num_slots=3, page_size=4, pages_per_slot=3)


def _pair(**kw):
    geom = {**GEOM, **kw}
    mesh = DeviceMesh(("tp",), (1,), devices=jax.devices()[:1])
    return jkv.PagedKVCache(jkv.KVCacheConfig(**geom), mesh), tkv.PagedKVCache(tkv.KVCacheConfig(**geom), device="cpu")


def _same(j, t):
    assert tuple(int(x) for x in t.fingerprint()) == tuple(int(x) for x in j.fingerprint())
    assert np.array_equal(t.page_table, j.page_table)
    assert np.array_equal(t.lengths, j.lengths)
    assert np.array_equal(t._page_refs, j._page_refs)
    assert t._free_pages == j._free_pages and t._free_slots == j._free_slots
    assert t.active_slots() == j.active_slots()
    assert t.utilization() == j.utilization()


def _page(c, slot, i):
    return int(c.page_table[slot, i])


# every host operation of the cache, in an order that shares pages,
# rewinds, frees with live references and reuses slots
OPS = [
    ("alloc", lambda c: c.alloc(5, 3)),
    ("commit_prefill", lambda c: c.commit_prefill(0, 5)),
    ("advance", lambda c: c.advance(0)),
    ("advance", lambda c: c.advance(0)),
    ("alloc", lambda c: c.alloc(2, 1)),
    ("commit_prefill", lambda c: c.commit_prefill(1, 2)),
    ("retain_page", lambda c: c.retain_page(_page(c, 0, 0))),
    ("alloc_shared", lambda c: c.alloc_shared([_page(c, 0, 0)], 6, 2)),
    ("commit_prefill", lambda c: c.commit_prefill(2, 4)),
    ("advance", lambda c: c.advance(2)),
    ("rollback", lambda c: c.rollback(0, 6)),
    ("free", lambda c: c.free(0)),
    ("release_page", lambda c: c.release_page(_page(c, 2, 0))),
    ("advance", lambda c: c.advance(1)),
    ("alloc", lambda c: c.alloc(3, 1)),
    ("free", lambda c: c.free(2)),
    ("free", lambda c: c.free(1)),
    ("free again", lambda c: c.free(1)),  # a no-op in both
    ("commit_prefill", lambda c: c.commit_prefill(0, 3)),
    ("reset", lambda c: c.reset()),
    ("alloc", lambda c: c.alloc(1, 0)),
]


def test_host_bookkeeping_matches_step_by_step():
    j, t = _pair()
    _same(j, t)
    for name, op in OPS:
        assert op(t) == op(j), name
        _same(j, t)


@pytest.mark.parametrize("prompt,new", [(12, 1), (10, 4), (3, 0)])
def test_capacity_verdicts_match(prompt, new):
    j, t = _pair()
    assert t.can_admit(prompt, new) == j.can_admit(prompt, new)
    assert t.pages_needed(prompt + new) == j.pages_needed(prompt + new)
    for cache in (j, t):
        if not cache.can_admit(prompt, new):
            with pytest.raises((jkv.KVCacheOutOfPages, tkv.KVCacheOutOfPages)):
                cache.alloc(prompt, new)
    _same(j, t)


def test_errors_match():
    j, t = _pair()
    for cache in (j, t):
        s = cache.alloc(4, 0)
        cache.commit_prefill(s, 4)
        with pytest.raises(ValueError):
            cache.rollback(s, 5)
        with pytest.raises(ValueError):
            cache.retain_page(0)
        assert not cache.can_advance(s)
    with pytest.raises(jkv.KVCacheOutOfPages):
        j.advance(0)
    with pytest.raises(tkv.KVCacheOutOfPages):
        t.advance(0)
    _same(j, t)


def test_pools_shape_dtype_device():
    _, t = _pair()
    assert t.k.shape == (2, t.num_pages, 4, 2, 8) == t.v.shape
    assert t.k.dtype == torch.float32 and t.k.device.type == "cpu"
    tb = tkv.PagedKVCache(tkv.KVCacheConfig(**GEOM, dtype=torch.bfloat16), device="cpu")
    assert tb.dtype == torch.bfloat16 and tb.v.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        t.update(t.k[:1], t.v)
    t.update(t.k.clone(), t.v.clone())


def test_config_from_env_matches(monkeypatch):
    for name, default in tconfig.DEFAULTS.items():
        assert envreg.lookup(name).default == default, name
    monkeypatch.setenv("VESCALE_SERVE_SLOTS", "5")
    monkeypatch.setenv("VESCALE_SERVE_PAGE_SIZE", "6")
    monkeypatch.setenv("VESCALE_SERVE_PAGES_PER_SLOT", "7")
    jc = jkv.KVCacheConfig.from_env(2, 2, 8)
    tc = tkv.KVCacheConfig.from_env(2, 2, 8)
    assert (tc.num_slots, tc.page_size, tc.pages_per_slot, tc.max_seq_len, tc.pool_pages) == (
        jc.num_slots, jc.page_size, jc.pages_per_slot, jc.max_seq_len, jc.pool_pages)
    assert tc.num_slots == 5
