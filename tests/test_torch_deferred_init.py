"""Deferred init on the meta device and the serve engine built on a mesh.

``deferred_init`` gives the eager initializer's shapes and dtypes with
nothing allocated; ``materialize_*`` give each rank's piece, equal to the
eager initializer's value cut as the JAX reference cuts it
(``to_local(rank=r)`` of ``vescale_tpu.distribute_tensor`` of the same
values), on a layout-only mesh in this process (every rank) and on a live
gloo mesh of 2 ranks.  ``ServeEngine(..., mesh=...)`` from those DArray
leaves gives exactly the greedy streams of the engine without a mesh.
"""

import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import vescale_tpu as vt
from vescale_tpu import placements as ref_pl
from vescale_tpu_torch import placements as pl
from vescale_tpu_torch.darray import DArray, distribute_tensor
from vescale_tpu_torch.initialize import (
    deferred_init,
    is_deferred,
    materialize_dparameter,
    materialize_dtensor,
    materialize_module,
)
from vescale_tpu_torch.mesh import DeviceMesh
from vescale_tpu_torch.models import init_params, param_shapes
from vescale_tpu_torch.serve import KVCacheConfig, PagedKVCache, ServeEngine

import torch_spmd_child as child
from torch_spmd_child import PROMPTS, _tiny, enc


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}" if path else k)
    else:
        yield path, tree


def test_deferred_init_gives_shapes_and_allocates_nothing():
    cfg = _tiny()
    meta = deferred_init(init_params, cfg, seed=0)
    assert is_deferred(meta)
    shapes = dict(_leaves(param_shapes(cfg)))
    got = dict(_leaves(meta))
    assert set(got) == set(shapes)
    for path, t in got.items():
        assert t.device.type == "meta" and tuple(t.shape) == tuple(shapes[path])
        assert t.dtype == cfg.dtype
    assert not is_deferred(init_params(cfg, seed=0, device="cpu"))
    assert not is_deferred({})
    # a factory without a device= parameter runs under the meta device
    t = deferred_init(lambda: torch.zeros(3, 4))
    assert t.device.type == "meta" and t.shape == (3, 4)


PLACEMENT_TREES = {
    "replicate": [ref_pl.Replicate(), ref_pl.Replicate()],
    "shard_rows": [ref_pl.Shard(0), ref_pl.Replicate()],
    "nested_rows": [ref_pl.Shard(0), ref_pl.Shard(0)],
    "ragged": [ref_pl.Replicate(), ref_pl.RaggedShard((0, 1), (1, 3, 2, 2))],
}


@pytest.mark.parametrize("name", sorted(PLACEMENT_TREES))
def test_materialize_module_every_rank_equals_the_eager_init_sliced(name):
    cfg = _tiny()
    ref_ps = PLACEMENT_TREES[name]
    ps = [child.dec(enc(p), pl) for p in ref_ps]
    mesh = DeviceMesh(("dp", "tp"), (2, 4), device_type="cpu")
    ref_mesh = vt.DeviceMesh(("dp", "tp"), (2, 4))
    eager = dict(_leaves(init_params(cfg, seed=3, device="cpu")))
    for r in range(8):
        tree = materialize_module(init_params, ps, cfg, seed=3, mesh=mesh, rank=r)
        for path, d in _leaves(tree):
            assert isinstance(d, DArray) and d.rank == r and d.shape == tuple(eager[path].shape)
            ref = vt.distribute_tensor(eager[path].numpy(), ref_mesh, ref_ps)
            np.testing.assert_array_equal(d.to_local().numpy(), np.asarray(ref.to_local(rank=r)),
                                          err_msg=f"{path} rank {r}")


def test_materialize_module_takes_a_placements_tree_and_the_single_leaf_flavours():
    cfg = _tiny()
    mesh = DeviceMesh(("tp",), (4,), device_type="cpu")
    tree = {k: [pl.Replicate()] for k in param_shapes(cfg)}
    tree["embed_tokens"] = {"embedding": [pl.Shard(1)]}
    out = materialize_module(init_params, tree, cfg, seed=1, mesh=mesh, rank=2)
    eager = init_params(cfg, seed=1, device="cpu")
    emb = out["embed_tokens"]["embedding"]
    assert emb.placements == (pl.Shard(1),)
    assert torch.equal(emb.to_local(), eager["embed_tokens"]["embedding"][:, 8:12])
    assert torch.equal(out["norm"]["weight"].to_local(), eager["norm"]["weight"])
    d = materialize_dtensor(lambda device: torch.arange(12.0, device=device).reshape(4, 3), mesh,
                            [pl.Shard(0)], rank=1)
    assert d.to_local().tolist() == [[3.0, 4.0, 5.0]]
    p = materialize_dparameter(lambda: torch.ones(8), mesh, [pl.Shard(0)], rank=3)
    assert isinstance(p.to_local(), torch.nn.Parameter) and p.to_local().shape == (2,)


def _views_and_intermediates(device=None):
    """An initializer with a view leaf, a Parameter leaf, intermediates,
    a tied leaf and a constant, drawing from its own generator and from
    the default one."""
    g = torch.Generator(device=device).manual_seed(7)
    w = torch.empty(8, 6, device=device).normal_(generator=g)
    a = torch.randn(6, 8, device=device, generator=g).t()
    b = w * 2.0 + torch.tensor(1.0)
    c = torch.nn.Parameter(torch.rand(8, 3, device=device))
    return {"w": w, "a": a, "b": b, "c": c, "tied": [w, w]}


def test_materialize_module_replays_views_parameters_and_intermediates():
    mesh = DeviceMesh(("x",), (4,), device_type="cpu")
    torch.manual_seed(11)
    eager = _views_and_intermediates(device="cpu")
    for r in range(4):
        torch.manual_seed(11)
        tree = materialize_module(_views_and_intermediates, [pl.Shard(0)], mesh=mesh, rank=r)
        for k in ("w", "a", "b", "c"):
            assert torch.equal(tree[k].to_local(), eager[k].detach()[2 * r:2 * r + 2]), (k, r)
        assert all(torch.equal(t.to_local(), eager["w"][2 * r:2 * r + 2]) for t in tree["tied"])
        # each piece is a copy of its rows, not a view that keeps the full leaf
        assert all(t.to_local().untyped_storage().nbytes() == t.to_local().nbytes
                   for t in (tree["w"], tree["a"], tree["c"]))


class _LiveBytes(TorchDispatchMode):
    """The peak, over the ops it sees, of the bytes of the storages that
    some tensor made by those ops still holds (meta tensors not counted)."""

    def __init__(self):
        super().__init__()
        self.refs = []
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.refs.append(weakref.ref(t))
        live = {}
        for ref in self.refs:
            t = ref()
            if t is not None:
                live[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        self.peak = max(self.peak, sum(live.values()))
        return out


def test_materialize_module_holds_one_full_leaf_at_a_time():
    """Shard(0) over 8 ranks: the peak of live bytes while rank 3's pieces
    are made is at most every piece plus the largest full leaf and its
    piece; the eager initializer's tree is the whole model."""
    cfg = _tiny()
    mesh = DeviceMesh(("x",), (8,), device_type="cpu")
    leaves = [t for _, t in _leaves(init_params(cfg, seed=2, device="cpu"))]
    with _LiveBytes() as live:
        tree = materialize_module(init_params, [pl.Shard(0)], cfg, seed=2, mesh=mesh, rank=3)
    pieces = [d.to_local() for _, d in _leaves(tree)]
    bound = (sum(p.nbytes for p in pieces) + max(t.nbytes for t in leaves)
             + max(p.nbytes for p in pieces))
    assert live.peak <= bound < sum(t.nbytes for t in leaves) / 2
    with _LiveBytes() as eager:
        init_params(cfg, seed=2, device="cpu")
    assert eager.peak == sum(t.nbytes for t in leaves)


def _engine(params, mesh=None, device="cpu"):
    cfg = _tiny()
    kc = KVCacheConfig(layers=2, kv_heads=2, head_dim=cfg.head_dim, num_slots=2, page_size=4,
                       pages_per_slot=4)
    return ServeEngine(cfg, params, PagedKVCache(kc, device="cpu"), mesh=mesh,
                       device=None if mesh is not None else device)


def test_serve_engine_on_a_mesh_gives_the_streams_of_the_engine_without_one():
    cfg = _tiny()
    golden = [_engine(init_params(cfg, seed=0, device="cpu")).replay_greedy(p, 6) for p in PROMPTS]
    mesh = DeviceMesh(("dp",), (2,), device_type="cpu")
    tree = materialize_module(init_params, [pl.Replicate()], cfg, seed=0, mesh=mesh, rank=1)
    eng = _engine(tree, mesh=mesh)
    assert eng.mesh is mesh and eng.device.type == "cpu"
    assert [eng.replay_greedy(p, 6) for p in PROMPTS] == golden
    # the replicated pieces are the DArrays' own tensors, not copies
    assert eng.params["norm"]["weight"] is tree["norm"]["weight"].to_local()


def test_serve_engine_mesh_checks():
    cfg = _tiny()
    mesh = DeviceMesh(("dp",), (2,), device_type="cpu")
    tree = materialize_module(init_params, [pl.Replicate()], cfg, seed=0, mesh=mesh, rank=0)
    with pytest.raises(ValueError, match="not the mesh's device"):
        ServeEngine(cfg, tree, PagedKVCache(KVCacheConfig(layers=2, kv_heads=2, head_dim=cfg.head_dim,
                                                          num_slots=1, page_size=4, pages_per_slot=2),
                                            device="cpu"), mesh=mesh, device="meta")
    other = DeviceMesh(("tp",), (2,), device_type="cpu")
    with pytest.raises(ValueError, match="lives on"):
        _engine(tree, mesh=other)
    sharded = dict(tree)
    sharded["norm"] = {"weight": distribute_tensor(torch.ones(16), mesh, [pl.Shard(0)], rank=0)}
    with pytest.raises(ValueError, match="replicated weights"):
        _engine(sharded, mesh=mesh)


def test_two_ranks_materialize_and_serve_on_a_live_gloo_mesh():
    """Each of 2 gloo ranks materializes the tiny Llama (Replicate on its
    live CPU mesh) and serves four prompts: both ranks' streams equal the
    engine without a mesh, and the deferred tree allocated nothing."""
    cfg = _tiny()
    golden = [_engine(init_params(cfg, seed=0, device="cpu")).replay_greedy(p, 6) for p in PROMPTS]
    world = child.World(2)
    try:
        served = world.run("serve", mesh_shape=[2], names=["dp"])
        pieces = world.run("deferred", mesh_shape=[2], names=["dp"],
                           placements=[enc(ref_pl.Shard(0))], seed=4)
    finally:
        world.close()
    assert all(r["streams"] == golden for r in served)
    eager = init_params(cfg, seed=4, device="cpu")
    for r, got in enumerate(pieces):
        assert got["deferred"] is True
        np.testing.assert_array_equal(got["embedding"], eager["embed_tokens"]["embedding"][32 * r:32 * (r + 1)])
        np.testing.assert_array_equal(got["gate"],
                                      eager["layers_1"]["mlp"]["gate_proj"]["kernel"][8 * r:8 * (r + 1)])
