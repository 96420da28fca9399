"""The port's DArray over gloo worlds of 2 and 8 ranks, held to the JAX
reference on conftest's virtual 8-device mesh.

Each rank of a world (children of ``tests/torch_spmd_child.py``, spawned
once for this module) builds its piece with ``distribute_tensor`` /
``from_local`` / the factories on a live mesh; its piece is held exactly to
the reference's ``to_local(rank=r)`` and its ``full_tensor`` (a collective)
to the input.  Also: the live mesh, ``VeDeviceMesh``, the distributed
helpers, and the eager elementwise ops with their ``Partial`` guards.
"""

import numpy as np
import pytest
import torch

import vescale_tpu as vt
from vescale_tpu import placements as ref_pl
from vescale_tpu_torch import placements as pl
from vescale_tpu_torch.darray import distribute_tensor, from_local
from vescale_tpu_torch.mesh import DeviceMesh

import torch_spmd_child as child
from torch_spmd_child import dec, enc, make_input

S, R, P = ref_pl.Shard, ref_pl.Replicate, ref_pl.Partial
IS, RS, SRS = ref_pl.InterleavedShard, ref_pl.RaggedShard, ref_pl.StridedRaggedShard


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


# conftest's 1-D, 2-D and 4-D meshes, and the 2-rank world's
LAYOUTS = {
    "1d_shard": ((8,), ("tp",), [S(0)], (16, 3)),
    "1d_uneven_empty": ((8,), ("tp",), [S(0)], (10,)),
    "1d_shard_last_dim": ((8,), ("tp",), [S(1)], (3, 13)),
    "1d_partial_avg": ((8,), ("tp",), [P("avg")], (4, 2), "int"),
    "1d_interleaved": ((8,), ("tp",), [IS(0, 3)], (48, 2)),
    "1d_ragged": ((8,), ("fsdp",), [RS((0,), (1, 2, 1, 2, 1, 3, 3, 3))], (64,)),
    "1d_ragged_2d": ((8,), ("fsdp",), [RS((0, 1), (2, 0, 1, 1, 1, 3, 3, 5))], (8, 8)),
    "2d_shard_shard": ((2, 4), ("dp", "tp"), [S(0), S(1)], (8, 8)),
    "2d_nested": ((2, 4), ("dp", "tp"), [S(0), S(0)], (13, 3)),
    "2d_replicate_interleaved": ((2, 4), ("dp", "tp"), [R(), IS(1, 2)], (3, 16)),
    "2d_strided_ragged": ((2, 4), ("tp", "fsdp"), [S(0), SRS((0,), (1, 2, 3, 2), split_factor=2)],
                          (64,)),
    "2d_ragged_first_strided": ((4, 2), ("fsdp", "tp"), [SRS((0,), (3, 1, 2, 2), split_factor=2), S(0)],
                                (32,)),
    "4d_mixed": ((2, 2, 1, 2), ("pp", "dp", "sp", "tp"), [S(0), R(), S(1), S(1)], (6, 10)),
    "4d_interleaved": ((2, 2, 1, 2), ("pp", "dp", "sp", "tp"), [IS(0, 2), R(), R(), S(1)], (8, 5)),
}
LAYOUTS_2 = {
    "2_shard": ((2,), ("dp",), [S(0)], (5, 4)),
    "2_ragged": ((2,), ("dp",), [RS((0, 1), (3, 1))], (4, 4)),
    "2_partial_max": ((2,), ("dp",), [P("max")], (3,)),
    "2_interleaved": ((2,), ("dp",), [IS(1, 2)], (2, 8)),
}


def _check_layout(worlds, mesh_shape, names, ps, shape, kind="normal"):
    """Integer-valued inputs where full_tensor reduces (avg: a sum / n)."""
    n = int(np.prod(mesh_shape))
    x = make_input(shape, 2, kind)
    res = worlds(n).run("layout", mesh_shape=list(mesh_shape), names=list(names),
                        placements=[enc(p) for p in ps], shape=list(shape), seed=2, kind=kind)
    ref = vt.distribute_tensor(x, vt.DeviceMesh(names, mesh_shape), ps)
    for r, got in enumerate(res):
        assert got["rank"] == r and tuple(got["coord"]) == ref.mesh.coordinate_of_rank(r)
        np.testing.assert_array_equal(got["local"], np.asarray(ref.to_local(rank=r)), err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["full"], x)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_distribute_to_local_full_tensor_on_8_ranks(worlds, name):
    _check_layout(worlds, *LAYOUTS[name])


@pytest.mark.parametrize("name", sorted(LAYOUTS_2))
def test_distribute_to_local_full_tensor_on_2_ranks(worlds, name):
    _check_layout(worlds, *LAYOUTS_2[name])


FROM_LOCAL = {
    # placements, each rank's local shape: uneven, empty and ragged pieces
    "uneven_rows": ([S(0)], [(2, 3)] * 5 + [(0, 3)] * 3),
    "ragged": ([RS((0,), (1, 2, 1, 2, 1, 3, 3, 3))], [(2,), (4,), (2,), (4,), (2,), (6,), (6,), (6,)]),
    "interleaved": ([IS(0, 2)], [(4, 2)] * 8),
    "replicate": ([R()], [(3, 2)] * 8),
}


@pytest.mark.parametrize("name", sorted(FROM_LOCAL))
def test_from_local_run_check_infers_the_global_shape(worlds, name):
    """run_check gathers every rank's local shape: the global shape comes
    out exact (uneven and ragged too), and a replicated mesh dim ends with
    coordinate 0's values on every rank, as the reference canonicalizes."""
    ps, shapes = FROM_LOCAL[name]
    res = worlds(8).run("from_local", mesh_shape=[8], names=["x"], placements=[enc(p) for p in ps],
                        local_shapes=[list(s) for s in shapes], seed=4)
    locals_ = [make_input(s, 4, "normal", rank=r) for r, s in enumerate(shapes)]
    ref = vt.from_local(locals_, vt.DeviceMesh(("x",), (8,)), ps)
    for r, got in enumerate(res):
        assert tuple(got["shape"]) == ref.shape
        np.testing.assert_array_equal(got["local"], np.asarray(ref.to_local(rank=r)))
        np.testing.assert_array_equal(got["full"], np.asarray(ref.full_tensor()))


def test_from_local_run_check_on_a_2d_mesh(worlds):
    """Uneven pieces on both mesh dims: the gathered shapes come back in
    flat rank order and give the exact global shape."""
    ps = [S(0), S(1)]
    ref_mesh = vt.DeviceMesh(("dp", "tp"), (2, 4))
    shapes = [tuple(int(x) for x in np.asarray(vt.distribute_tensor(np.zeros((5, 7), np.float32), ref_mesh,
                                                                     ps).to_local(rank=r)).shape)
              for r in range(8)]
    res = worlds(8).run("from_local", mesh_shape=[2, 4], names=["dp", "tp"],
                        placements=[enc(p) for p in ps], local_shapes=[list(s) for s in shapes], seed=8)
    locals_ = [make_input(s, 8, "normal", rank=r) for r, s in enumerate(shapes)]
    ref = vt.from_local(locals_, ref_mesh, ps)
    assert ref.shape == (5, 7)
    for r, got in enumerate(res):
        assert tuple(got["shape"]) == (5, 7)
        np.testing.assert_array_equal(got["local"], locals_[r])
        np.testing.assert_array_equal(got["full"], np.asarray(ref.full_tensor()))


@pytest.mark.parametrize("ps", [[S(0), S(1)], [R(), IS(0, 2)], [S(1), R()]])
def test_factories_on_8_ranks(worlds, ps):
    """rand is bitwise the reference's vt.rand on every rank's piece;
    randn within normal's bound (tests/test_torch_random.py); the fills
    exact, a Partial(sum) off coordinate 0 zeros."""
    shape = (8, 6)
    res = worlds(8).run("factories", mesh_shape=[2, 4], names=["dp", "tp"],
                        placements=[enc(p) for p in ps], shape=list(shape), seed=9)
    mesh = vt.DeviceMesh(("dp", "tp"), (2, 4))
    vt.manual_seed(9)
    ref_u = vt.rand(shape, device_mesh=mesh, placements=ps)
    ref_n = vt.randn(shape, device_mesh=mesh, placements=ps)
    for r, got in enumerate(res):
        np.testing.assert_array_equal(got["rand"], np.asarray(ref_u.to_local(rank=r)))
        ref = np.asarray(ref_n.to_local(rank=r)).astype(np.float64)
        rel = np.abs(got["randn"] - ref) / np.maximum(np.abs(ref), 1e-30) / np.finfo(np.float32).eps
        assert rel.max(initial=0.0) <= 64.0
        assert got["zeros"].shape == got["ones"].shape == got["rand"].shape
        assert not got["zeros"].any() and (got["ones"] == 1).all() and (got["full"] == 2.5).all()


def test_live_mesh_devicemesh_api_and_distributed_helpers(worlds):
    res = worlds(8).run("mesh_api")
    ref = vt.DeviceMesh(("dp", "tp"), (2, 4))
    for r, got in enumerate(res):
        c = ref.coordinate_of_rank(r)
        assert got["rank"] == r and tuple(got["coord"]) == c == tuple(got["strategy"])
        assert (got["dp"], got["tp"], got["pp"], got["lookup_tp"]) == (c[0], c[1], 0, c[1])
        assert got["first"] and got["last"]
        assert got["tp_mesh_ranks"] == [4 * c[0] + j for j in range(4)] and got["tp_live"]
        assert got["all_tp"] == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert got["groups"] == [[c[1], 4 + c[1]], [4 * c[0] + j for j in range(4)]]
        assert got["backend"] == "gloo" and got["hybrid"] == [[2, 4], list(c)]
        assert got["ok_all"] is True and got["ok_one"] is False
        assert "differently tagged" in got["mismatch"]
        assert got["initialized"] and got["count"] == 8 and got["index"] == r


def test_initialize_joins_a_two_rank_world_by_its_arguments():
    """The worlds above join by torch's env:// variables; this one passes
    the address, size and rank to ``initialize`` itself."""
    world = child.World(2, join="args")
    try:
        res = world.run("mesh_api")
    finally:
        world.close()
    for r, got in enumerate(res):
        assert got["initialized"] and got["count"] == 2 and got["index"] == r
        assert got["backend"] == "gloo" and got["groups"] == [[r], [0, 1]]
        assert got["ok_all"] is True and got["ok_one"] is False


def test_initialize_alone_is_a_world_of_one_and_a_new_world_gets_new_groups(monkeypatch):
    """Without an address or MASTER_ADDR, ``initialize`` makes a world of
    one on a local store; after ``destroy_process_group`` a new world's
    redistribute group is that world's, not the destroyed one."""
    import torch.distributed as dist

    from vescale_tpu_torch import distributed as D
    from vescale_tpu_torch.redistribute import _world_group

    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="needs coordinator_address"):
        D.initialize(num_processes=2, device_type="cpu")
    with pytest.raises(ValueError, match="needs num_processes and process_id"):
        D.initialize("127.0.0.1:1", device_type="cpu")
    assert not D.is_initialized()
    groups = []
    try:
        for _ in range(2):
            D.initialize(device_type="cpu")
            assert D.is_initialized() and D.process_count() == 1 and D.process_index() == 0
            assert dist.get_backend() == "gloo"
            groups.append(_world_group("cpu", [0]))
            assert groups[-1] is dist.group.WORLD
            dist.destroy_process_group()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert groups[0] is not groups[1]


def test_elementwise_ops_on_8_ranks(worlds):
    res = worlds(8).run("elementwise", mesh_shape=[2, 4], names=["dp", "tp"], seed=6)
    a, b = make_input((8, 3), 6), make_input((8, 3), 7)
    for r, got in enumerate(res):
        np.testing.assert_array_equal(got["c"], a + b * np.float32(2.0) - np.float32(1.0))
        np.testing.assert_array_equal(got["neg"], -a)
        ref = vt.distribute_tensor(a / np.float32(4.0), vt.DeviceMesh(("dp", "tp"), (2, 4)), [S(0), S(0)])
        np.testing.assert_array_equal(got["div"], np.asarray(ref.to_local(rank=r)))
    q = sum(make_input((4,), 6, "int", rank=r) for r in range(8)) * 2 * 3
    assert all(np.array_equal(got["q"], q) for got in res)


def test_elementwise_guards_as_the_reference():
    """Partial(max) refuses negation and scalar *, specs must match, and no
    broadcasting against a piece (reference darray.py:134-190)."""
    m = DeviceMesh(("tp",), (8,), device_type="cpu")
    d = from_local(torch.tensor([1.0, 5.0]), m, [pl.Partial("max")], rank=3)
    with pytest.raises(ValueError, match="negation"):
        -d
    with pytest.raises(ValueError, match="scalar"):
        d * -2.0
    with pytest.raises(ValueError, match="linear"):
        d + d
    a = distribute_tensor(torch.ones(8), m, [pl.Shard(0)], rank=1)
    b = distribute_tensor(torch.ones(8), m, [pl.Replicate()], rank=1)
    with pytest.raises(ValueError, match="matching specs"):
        a + b
    c = distribute_tensor(torch.ones(8), m, [pl.Replicate()], rank=1)
    with pytest.raises(ValueError, match="broadcasting"):
        c + torch.ones(4, 8)
    s = from_local(torch.ones(2), m, [pl.Partial("sum")], rank=0)
    assert torch.equal((s * 3.0).to_local(), torch.full((2,), 3.0))
    assert (s + s).to_local().tolist() == [2.0, 2.0] and (-s).to_local().tolist() == [-1.0, -1.0]
    assert (2.0 - a).to_local().tolist() == [1.0] and (a / 2).to_local().tolist() == [0.5]
    assert a.astype(torch.float64).dtype == torch.float64
    with pytest.raises(ValueError, match="ragged from_local needs shape"):
        from_local(torch.ones(3), m, [pl.RaggedShard((0,), (1,) * 8)], rank=0)
    assert from_local(torch.ones(2, 3), m, [pl.Shard(0)], rank=0).shape == (16, 3)
    assert from_local(torch.ones(2, 3), m, [pl.Shard(0)], rank=6, shape=(15, 3)).to_local().shape == (2, 3)
    with pytest.raises(ValueError, match="local shape"):
        from_local(torch.ones(2, 3), m, [pl.Shard(0)], rank=7, shape=(10, 3))
    with pytest.raises(RuntimeError, match="layout-only"):
        a.full_tensor()
    assert dec(enc(P()), pl) == pl.Partial()
