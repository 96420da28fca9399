"""The port's tensor-parallel serve engine on a gloo world of 2 ranks, held
to the JAX reference's tp2 engine on the same numpy-seeded weights.

The reference's own tp2 form (``tests/test_serve.py``): the serve tests'
tiny Llama on ``DeviceMesh(("tp",), (2,))`` over a pool placed Shard(3)
(kv heads over "tp"), from replicated weights and from ``llama_plan``
DArrays.  Each rank of the port (``tests/torch_spmd_child.py``'s
``tp_serve``) serves the same weights in the same two forms over its own
Shard(3) pool piece.  Held: greedy streams exactly equal (two prompts
sharing the decode batch, then a third alone); each rank's pool piece
within the port's serve bound (16 fp32 ulps at scale,
``tests/test_torch_serve.py``: the two frameworks sum in other orders)
of the reference pool's Shard(3) piece, the null page aside; this rank's
kv heads resident; the decode step eager over gloo.
"""

import re

import numpy as np
import pytest

import jax

import vescale_tpu as vt
from vescale_tpu import serve as jserve
from vescale_tpu.mesh import DeviceMesh as RefMesh
from vescale_tpu.models import llama as ref_llama

from vescale_tpu_torch.kernels import ulps_at_scale

import torch_spmd_child as child

KV_ULP_BOUND = 16.0  # tests/test_torch_serve.py
FORMS = ("replicated", "plan")
SEED = 4
TP = 2


@pytest.fixture(scope="module")
def port_runs():
    w = child.World(TP)
    try:
        yield {form: w.run("tp_serve", form=form, seed=SEED, tp=TP) for form in FORMS}
    finally:
        w.close()


@pytest.fixture(scope="module")
def ref_runs():
    out = {}
    cfg = child.tp_config("serve", ref_llama)
    mesh = RefMesh(("tp",), (TP,), devices=jax.devices()[:TP])
    tree = child.tp_tree("serve", SEED)
    plan = ref_llama.llama_plan(mesh)["parameter"]

    def lay(node, path=""):
        if isinstance(node, dict):
            return {k: lay(v, f"{path}.{k}" if path else k) for k, v in node.items()}
        # the DArray's global array, sharded as llama_plan says: the form
        # the reference engine takes sharded weights in (``_replicate``)
        return vt.distribute_tensor(node, mesh, next(v for p, v in plan.items()
                                                     if re.fullmatch(p, path))).data

    for form in FORMS:
        kc = jserve.KVCacheConfig(layers=cfg.num_hidden_layers, kv_heads=cfg.num_key_value_heads,
                                  head_dim=cfg.head_dim, **child.SERVE_CACHE)
        cache = jserve.PagedKVCache(kc, mesh)
        eng = jserve.ServeEngine(cfg, mesh, tree if form == "replicated" else lay(tree), cache)
        streams = child.serve_generate(eng, cache)
        out[form] = dict(streams=streams, k=np.asarray(cache.k.data), v=np.asarray(cache.v.data))
    return out


@pytest.mark.parametrize("form", FORMS)
def test_greedy_streams_equal_the_reference_tp2_engine(port_runs, ref_runs, form):
    want = ref_runs[form]["streams"]
    assert len(want) == len(child.SERVE_PROMPTS)
    for ans in port_runs[form]:
        assert ans["streams"] == want


@pytest.mark.parametrize("form", FORMS)
def test_pool_pieces_are_the_reference_shard3_pieces(port_runs, ref_runs, form):
    ref = ref_runs[form]
    for r, ans in enumerate(port_runs[form]):
        for name in ("k", "v"):
            full = ref[name]
            w = full.shape[3] // TP  # (L, pages, page, kv heads, hd)
            want = full[:, 1:, :, r * w:(r + 1) * w]
            got = np.asarray(ans[name])[:, 1:]
            assert got.shape == want.shape
            assert ulps_at_scale(got, want) <= KV_ULP_BOUND


@pytest.mark.parametrize("form", FORMS)
def test_each_rank_holds_its_kv_heads_and_decodes_eagerly_over_gloo(port_runs, form):
    kv = child.TP_CONFIGS["serve"]["num_key_value_heads"]
    for ans in port_runs[form]:
        assert ans["kv_local"] == kv // TP
        assert ans["graphed"] is False


def test_pool_refuses_kv_heads_that_do_not_split():
    """The reference's divisibility error (``serve/kv_cache.py:155-170``)."""
    from vescale_tpu_torch.mesh import DeviceMesh
    from vescale_tpu_torch.serve import KVCacheConfig, PagedKVCache

    kc = KVCacheConfig(layers=1, kv_heads=2, head_dim=8)
    with pytest.raises(ValueError, match="not divisible"):
        PagedKVCache(kc, mesh=DeviceMesh(("tp",), (4,), device_type="cpu"))


@pytest.fixture(scope="module")
def paths():
    w = child.World(TP)
    try:
        yield w.run("tp_serve_paths", seed=SEED, tp=TP)
    finally:
        w.close()


def test_multi_token_step_and_suffix_prefill_match_one_device(paths):
    """``decode_multi`` and ``prefill_suffix`` on the tp mesh within the
    serve bound of the single-device engine on the same weights."""
    for ans in paths:
        assert max(ans["ulps"]) <= KV_ULP_BOUND


def test_swap_params_on_the_tp_mesh(paths):
    """A swap to other weights changes the stream as it does on one device,
    and swapping back restores it."""
    for ans in paths:
        before, swapped, back = ans["streams"]
        assert back == before and swapped == ans["single_swapped"]


def test_decode_flops_count_this_ranks_share(paths):
    for ans in paths:
        tp_flops, one_flops = ans["flops"]
        assert one_flops / TP * 0.5 < tp_flops < one_flops
