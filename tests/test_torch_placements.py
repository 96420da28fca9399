"""The port's placements and layout algebra, held to the JAX reference in
one process.

Placements: the same reprs, strs, equality and validation errors.  Layouts:
on a layout-only mesh, ``distribute_tensor(..., rank=r)`` gives rank ``r``'s
piece, held exactly to the reference's ``to_local(rank=r)`` on conftest's
virtual 8-device mesh; ``redistribute_local_tensor`` (the single-process
model of a transition) to the reference's ``redistribute(...).to_local(r)``.
"""

import warnings

import numpy as np
import pytest
import torch

import vescale_tpu as vt
from vescale_tpu import placements as ref_pl
from vescale_tpu import spec as ref_spec
from vescale_tpu_torch import placements as pl
from vescale_tpu_torch.darray import arange, distribute_tensor, full, ones, zeros
from vescale_tpu_torch.mesh import DeviceMesh, _mesh_env, backend_of, init_device_mesh
from vescale_tpu_torch.redistribute import plan, redistribute_local_tensor
from vescale_tpu_torch.spec import DArraySpec, TensorMeta

from torch_spmd_child import dec, enc, make_input

S, R, P = ref_pl.Shard, ref_pl.Replicate, ref_pl.Partial
IS, RS, SRS = ref_pl.InterleavedShard, ref_pl.RaggedShard, ref_pl.StridedRaggedShard


def port(ps):
    return [dec(enc(p), pl) for p in ps]


PLACEMENTS = [S(0), S(-1), R(), P(), P("max"), P("avg"), IS(1, 3), RS((0,), (1, 2)),
              RS((0, 1), (0, 3, 1)), SRS((0,), (1, 2, 3, 2), split_factor=2)]


@pytest.mark.parametrize("i", range(len(PLACEMENTS)))
def test_placement_repr_str_and_predicates(i):
    ref = PLACEMENTS[i]
    got = dec(enc(ref), pl)
    assert repr(got) == repr(ref) and str(got) == str(ref)
    for q in ("is_shard", "is_interleaved_shard", "is_ragged_shard", "is_replicate", "is_partial"):
        assert getattr(got, q)() == getattr(ref, q)(), q
    assert got == dec(enc(ref), pl) and hash(got) == hash(dec(enc(ref), pl))


@pytest.mark.parametrize("bad", [
    lambda m: m.Partial("bogus"),
    lambda m: m.RaggedShard((0, 2), (1, 1)),
    lambda m: m.RaggedShard((0,), (0, 0)),
    lambda m: m.RaggedShard((), (1,)),
    lambda m: m.InterleavedShard(0, 0),
    lambda m: m.StridedRaggedShard((0,), (1,), split_factor=0),
])
def test_placement_validation_raises_as_the_reference(bad):
    with pytest.raises(ValueError) as ref_err:
        bad(ref_pl)
    with pytest.raises(ValueError) as got_err:
        bad(pl)
    assert str(got_err.value) == str(ref_err.value)


def test_shard_chunking_and_ragged_sizes():
    for n, size in ((4, 10), (8, 10), (3, 7), (8, 64)):
        for r in range(n):
            assert (pl.Shard(0).local_shard_size_and_offset(size, n, r)
                    == ref_pl.Shard(0).local_shard_size_and_offset(size, n, r))
        assert pl.Shard(0).padded_size(size, n) == ref_pl.Shard(0).padded_size(size, n)
    rp, rr = pl.RaggedShard((0,), (1, 2, 3, 2)), RS((0,), (1, 2, 3, 2))
    assert rp.local_sizes_and_offsets(16) == rr.local_sizes_and_offsets(16)
    with pytest.raises(ValueError):
        rp.unit_size(15)


def test_normalize_placements_transition_candidates_and_plan_axes():
    args = ([0, "r", "partial", "S(1)"], 5, 2)
    assert [enc(p) for p in pl.normalize_placements(*args)] == \
        [enc(p) for p in ref_pl.normalize_placements(*args)]
    assert pl.normalize_placements([pl.Shard(-1)], 1, tensor_ndim=3) == (pl.Shard(2),)
    assert pl.normalize_placements(None, 2) == (pl.Replicate(), pl.Replicate())
    with pytest.raises(ValueError):
        pl.normalize_placements([0, 1, 0], 2)
    for a, b in ((IS(0, 2), S(1)), (P(), R()), (RS((0,), (1, 1)), S(0))):
        got = pl.transition_candidates(dec(enc(a), pl), dec(enc(b), pl))
        assert [enc(p) for p in got] == [enc(p) for p in ref_pl.transition_candidates(a, b)]
    mesh = DeviceMesh(("pp", "dp", "tp"), (2, 2, 2), device_type="cpu")
    ref_mesh = vt.DeviceMesh(("pp", "dp", "tp"), (2, 2, 2))
    assert [enc(p) for p in pl.plan_axes(mesh, tp=0, dp="r")] == \
        [enc(p) for p in ref_pl.plan_axes(ref_mesh, tp=0, dp="r")]
    with pytest.warns(UserWarning, match="no dim named 'sp'"):
        pl.plan_axes(mesh, sp=1)


# ----------------------------------------------------------------- mesh
def test_mesh_coordinates_submeshes_and_scope():
    ref = vt.DeviceMesh(("dp", "tp"), (2, 4))
    m = DeviceMesh(("dp", "tp"), (2, 4), device_type="cpu")
    for r in range(8):
        assert m.coordinate_of_rank(r) == ref.coordinate_of_rank(r)
    assert m.size() == 8 and m.size("tp") == 4 and m.size(0) == 2 and m._dim_index("tp") == 1
    assert m.dim_name(1) == "tp" and m.shape == (2, 4) and m.ndim == 2
    sub = m["tp"]
    assert sub.shape == (4,) and sub.ranks.tolist() == [0, 1, 2, 3]
    t = m[("tp", "dp")]
    assert t.shape == (4, 2) and t.ranks.tolist() == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert not m.is_live and m == DeviceMesh(("dp", "tp"), (2, 4), device_type="cpu")
    assert m != DeviceMesh(("dp", "tp"), (4, 2), device_type="cpu")
    with m:
        assert _mesh_env.get_current_mesh() is m
    with pytest.raises(RuntimeError, match="No device mesh"):
        _mesh_env.get_current_mesh()
    with pytest.raises(RuntimeError, match="layout-only"):
        m.get_group(0)
    with pytest.raises(RuntimeError, match="layout-only"):
        m.get_rank()
    assert backend_of("cuda") == "nccl" and backend_of("cpu") == "gloo"


def test_cuda_mesh_without_a_card_raises_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_device_mesh("cuda", (1,), mesh_dim_names=("dp",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceMesh(("dp",), (1,)).device
    with pytest.raises(ValueError):
        DeviceMesh(("dp",), (1,), device_type="xpu")


# --------------------------------------------------------------- layouts
# (mesh shape, names, placements, tensor shape): the layouts of the
# reference's darray and placement tests, and uneven, nested, interleaved,
# ragged and strided ragged ones on conftest's meshes.
LAYOUTS = {
    "shard_2d": ((2, 4), ("dp", "tp"), [S(0), S(1)], (8, 8)),
    "replicate": ((2, 4), ("dp", "tp"), [R(), R()], (3, 4)),
    "uneven_1d": ((8,), ("tp",), [S(0)], (10,)),
    "uneven_both": ((2, 4), ("dp", "tp"), [S(1), S(0)], (7, 5)),
    "nested_same_dim": ((2, 4), ("dp", "tp"), [S(0), S(0)], (13, 3)),
    "nested_uneven_empty": ((2, 4), ("dp", "tp"), [S(0), S(0)], (5, 2)),
    "interleaved": ((4,), ("tp",), [IS(0, 3)], (24,)),
    "interleaved_ceil": ((8,), ("tp",), [IS(0, 3)], (12,)),
    "interleaved_negative_dim": ((4,), ("tp",), [IS(-1, 3)], (2, 12)),
    "double_interleaved": ((2, 2), ("a", "b"), [IS(0, 2), IS(1, 2)], (4, 8)),
    "interleaved_nested": ((2, 4), ("dp", "tp"), [IS(1, 2), IS(1, 2)], (3, 32)),
    "partial_sum_shard": ((2, 4), ("dp", "tp"), [P(), S(0)], (8, 4)),
    "partial_max": ((8,), ("tp",), [P("max")], (2, 3)),
    "ragged": ((4,), ("fsdp",), [RS((0,), (1, 2, 3, 2))], (16,)),
    "ragged_2d_zero_unit": ((8,), ("fsdp",), [RS((0, 1), (0, 2, 1, 2, 1, 3, 3, 4))], (8, 16)),
    "ragged_with_replicate": ((2, 4), ("dp", "fsdp"), [R(), RS((0,), (1, 2, 3, 2))], (16,)),
    "strided_ragged": ((2, 4), ("fsdp", "ep"), [S(0), SRS((0,), (1, 2, 3, 2), split_factor=2)], (16,)),
    "strided_ragged_first": ((4, 2), ("fsdp", "tp"), [SRS((0,), (1, 2, 3, 2), split_factor=2), S(0)],
                             (64,)),
    "mesh4d": ((2, 2, 1, 2), ("pp", "dp", "sp", "tp"), [S(0), R(), S(1), S(1)], (6, 10)),
}


def _ref_layout(name):
    mesh_shape, names, ps, shape = LAYOUTS[name]
    x = make_input(shape, 1)
    return x, vt.distribute_tensor(x, vt.DeviceMesh(names, mesh_shape), ps)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_every_ranks_piece_matches_the_reference(name):
    mesh_shape, names, ps, shape = LAYOUTS[name]
    x, ref = _ref_layout(name)
    mesh = DeviceMesh(names, mesh_shape, device_type="cpu")
    locals_ = []
    for r in range(mesh.size()):
        d = distribute_tensor(torch.from_numpy(x), mesh, port(ps), rank=r)
        assert d.rank == r and d.shape == tuple(shape)
        assert [enc(p) for p in d.placements] == [enc(p) for p in ref.placements]
        np.testing.assert_array_equal(d.to_local().numpy(), np.asarray(ref.to_local(rank=r)),
                                      err_msg=f"{name} rank {r}")
        assert tuple(d.to_local().shape) == d.spec.local_shape(d.coordinate)
        locals_.append(d.to_local())
    spec = DArraySpec(mesh, port(ps), TensorMeta(tuple(shape), torch.float32))
    np.testing.assert_array_equal(spec.assemble(locals_).numpy(), np.asarray(ref.full_tensor()))


def test_chunk_queries_match_the_reference():
    for mesh_shape, names, ps, shape in LAYOUTS.values():
        mesh = DeviceMesh(names, mesh_shape, device_type="cpu")
        spec = DArraySpec(mesh, port(ps), TensorMeta(tuple(shape), torch.float32))
        rspec = ref_spec.DArraySpec(vt.DeviceMesh(names, mesh_shape), ps,
                                    ref_spec.TensorMeta(tuple(shape), np.float32))
        for r in range(mesh.size()):
            c = mesh.coordinate_of_rank(r)
            if spec.has_ragged():
                assert spec.ragged_local_chunk(c) == rspec.ragged_local_chunk(c)
            elif any(isinstance(p, pl.InterleavedShard) for p in spec.placements):
                assert spec.interleaved_local_slices(c) == rspec.interleaved_local_slices(c)
            else:
                assert spec.local_chunk(c) == rspec.local_chunk(c)
        if spec.has_ragged():
            assert spec.layout().cell_pad == rspec.layout().cell_pad


@pytest.mark.parametrize("bad", [
    ((2, 4), ("dp", "tp"), [S(0), IS(0, 2)], (8, 4)),
    ((4,), ("tp",), [IS(0, 3)], (10,)),
    ((2, 4), ("dp", "tp"), [RS((0,), (1, 1)), RS((0,), (1, 1, 1, 1))], (8,)),
    ((2, 4), ("dp", "tp"), [P(), RS((0,), (1, 1, 1, 1))], (8,)),
    ((2, 4), ("dp", "tp"), [S(0), RS((0,), (1, 1, 1, 1))], (8,)),
    ((4,), ("fsdp",), [RS((0,), (1, 1, 1))], (8,)),
    ((2, 4), ("fsdp", "ep"), [S(0), SRS((0,), (1, 1, 1, 1), split_factor=4)], (16,)),
    ((2, 4), ("fsdp", "ep"), [S(0), SRS((0,), (1, 2, 1, 1), split_factor=2)], (5,)),
])
def test_invalid_layouts_raise_as_the_reference(bad):
    mesh_shape, names, ps, shape = bad
    with pytest.raises(ValueError):
        ref_spec.DArraySpec(vt.DeviceMesh(names, mesh_shape), ps,
                            ref_spec.TensorMeta(shape, np.float32)).layout()
    with pytest.raises(ValueError):
        DArraySpec(DeviceMesh(names, mesh_shape, device_type="cpu"), port(ps),
                   TensorMeta(shape, torch.float32)).layout()


def test_spec_equality_hash_and_bytes():
    m = DeviceMesh(("dp", "tp"), (2, 4), device_type="cpu")
    a = DArraySpec(m, [pl.Shard(0), pl.Replicate()], TensorMeta((8, 4), torch.float32))
    b = DArraySpec(m, [pl.Shard(0), pl.Replicate()], TensorMeta((8, 4), torch.float32))
    c = DArraySpec(m, [pl.Shard(1), pl.Replicate()], TensorMeta((8, 4), torch.float32))
    assert a == b and hash(a) == hash(b) and a != c and len({a, b, c}) == 2
    assert a.logical_bytes() == 128 and a.per_shard_bytes() == 64
    assert repr(a) == "DArraySpec([S(0), R] over {'dp': 2, 'tp': 4}, shape=(8, 4))"


# ------------------------------------------------ single-process model
MODEL = {
    "shard_to_replicate": ((8,), ("tp",), [S(0)], [R()], (16,), False),
    "shard0_to_shard1_uneven": ((2, 4), ("dp", "tp"), [R(), S(0)], [S(1), R()], (7, 12), False),
    "interleaved_to_shard": ((8,), ("tp",), [IS(0, 3)], [S(0)], (96, 3), False),
    "ragged_a2av": ((8,), ("fsdp",), [RS((0,), (1, 2, 1, 2, 1, 3, 3, 3))],
                    [RS((0,), (3, 3, 3, 1, 2, 1, 2, 1))], (64,), False),
    "ragged_to_replicate": ((4,), ("fsdp",), [RS((0,), (1, 2, 3, 2))], [R()], (16,), False),
    "replicate_to_strided": ((2, 4), ("tp", "fsdp"), [R(), R()],
                             [S(0), SRS((0,), (1, 2, 3, 2), split_factor=2)], (64,), False),
    "strided_a2a": ((2, 4), ("tp", "fsdp"), [S(0), SRS((0,), (1, 2, 3, 2), split_factor=2)],
                    [S(0), SRS((0,), (2, 3, 2, 1), split_factor=2)], (64,), False),
    "partial_to_shard": ((8,), ("tp",), [P()], [S(0)], (8,), True),
    "replicate_to_partial": ((2, 4), ("dp", "tp"), [R(), R()], [P(), S(0)], (7, 12), False),
    "ragged_to_shard": ((8,), ("x",), [RS((0,), (1, 2, 1, 2, 1, 3, 3, 3))], [S(0)], (64,), False),
}


@pytest.mark.parametrize("name", sorted(MODEL))
def test_redistribute_local_tensor_matches_the_reference(name):
    mesh_shape, names, src, dst, shape, partial = MODEL[name]
    import torch_spmd_child as child

    mesh = DeviceMesh(names, mesh_shape, device_type="cpu")
    ref_mesh = vt.DeviceMesh(names, mesh_shape)
    n = mesh.size()
    if partial:
        np_locals = [child.local_operand(mesh_shape, [enc(p) for p in src], shape, 3, "int", r)
                     for r in range(n)]
        ref = vt.from_local(np_locals, ref_mesh, src, shape=shape)
        locals_ = [torch.from_numpy(a) for a in np_locals]
    else:
        x = make_input(shape, 3)
        ref = vt.distribute_tensor(x, ref_mesh, src)
        locals_ = [distribute_tensor(torch.from_numpy(x), mesh, port(src), rank=r).to_local()
                   for r in range(n)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = ref.redistribute(placements=dst)
    ss = DArraySpec(mesh, port(src), TensorMeta(tuple(shape), torch.float32))
    ds = DArraySpec(mesh, port(dst), TensorMeta(tuple(shape), torch.float32))
    for r in range(n):
        got = redistribute_local_tensor(locals_, ss, ds, rank=r)
        np.testing.assert_array_equal(got.numpy(), np.asarray(out.to_local(rank=r)), err_msg=f"rank {r}")


def test_redistribute_local_tensor_guard():
    m = DeviceMesh(("tp",), (8,), device_type="cpu")
    src = DArraySpec(m, [pl.Shard(0)], TensorMeta((16,), torch.float32))
    dst = DArraySpec(m, [pl.Replicate()], TensorMeta((16,), torch.float32))
    with pytest.raises(ValueError, match="replicated"):
        redistribute_local_tensor(torch.arange(2.0), src, dst)
    locals_ = [torch.arange(r * 2, r * 2 + 2, dtype=torch.float32) for r in range(8)]
    assert torch.equal(redistribute_local_tensor(locals_, src, dst), torch.arange(16.0))
    rep = DArraySpec(m, [pl.Replicate()], TensorMeta((16,), torch.float32))
    assert torch.equal(redistribute_local_tensor(torch.arange(16.0), rep, src, rank=3), torch.arange(6.0, 8.0))


@pytest.mark.parametrize("case", ["partial_source", "ragged_to_columns"])
def test_redistribute_local_tensor_fallback_warns_counts_and_strict_raises(case, monkeypatch):
    """The model's two assembling branches are the fallback of the live
    path: a Partial source, and flat ragged pieces against dense column
    pieces (no common index space).  Each warns, counts one
    ``redistribute.fallbacks`` and is exact; the strict knob raises."""
    from vescale_tpu_torch.telemetry.registry import GLOBAL

    m = DeviceMesh(("x",), (8,), device_type="cpu")
    x = torch.from_numpy(make_input((8, 4), 5, "int"))
    meta = TensorMeta((8, 4), torch.float32)
    if case == "partial_source":
        src = DArraySpec(m, [pl.Partial()], meta)
        locals_ = [x if r == 0 else torch.zeros_like(x) for r in range(8)]
    else:
        src = DArraySpec(m, [pl.RaggedShard((0, 1), (1,) * 8)], meta)
        locals_ = [x.reshape(-1)[4 * r:4 * r + 4] for r in range(8)]
    dst = DArraySpec(m, [pl.Shard(1)], meta)
    before = GLOBAL.counter("redistribute.fallbacks")
    with pytest.warns(UserWarning, match="through Replicate"):
        got = redistribute_local_tensor(locals_, src, dst, rank=2)
    assert GLOBAL.counter("redistribute.fallbacks") - before == 1
    assert torch.equal(got, x[:, 2:3])
    monkeypatch.setenv("VESCALE_STRICT_REDISTRIBUTE", "1")
    with pytest.raises(RuntimeError, match="VESCALE_STRICT_REDISTRIBUTE"):
        redistribute_local_tensor(locals_, src, dst, rank=5)


@pytest.mark.parametrize("pair", [
    ([S(0), R()], [R(), S(1)], False),
    ([R(), S(0)], [R(), S(1)], False),
    ([P(), R()], [S(0), R()], False),
    ([S(0), S(0)], [R(), R()], False),
    ([R(), S(0)], [S(0), S(0)], True),
    ([RS((0,), (1, 1, 1, 1)), R()], [S(0), R()], True),
    ([R(), RS((0,), (1, 2, 3, 2))], [S(0), SRS((0,), (2, 3, 2, 1), split_factor=2)], False),
])
def test_plan_hops_and_when_it_goes_through_replicate(pair):
    """One hop a changed mesh dim; a gather and a slice on one mesh dim
    (the fallback tier) only where no single hop serves."""
    src, dst, fallback = pair
    hops, fb = plan(port(src), port(dst), 2)
    assert fb == fallback, hops
    assert all(k in ("unstride", "gather", "exchange", "reduce", "slice", "seed", "stride")
               for k, _, _ in hops)


# --------------------------------------------------------- factories
def test_factories_on_a_layout_only_mesh():
    m = DeviceMesh(("dp", "tp"), (2, 4), device_type="cpu")
    ref_mesh = vt.DeviceMesh(("dp", "tp"), (2, 4))
    for r in range(8):
        z = zeros((4, 4), device_mesh=m, placements=[pl.Shard(0)], rank=r)
        o = ones((4, 4), device_mesh=m, placements=[pl.Replicate(), pl.Shard(1)], rank=r)
        f = full((5, 3), 2.5, device_mesh=m, placements=[pl.Partial(), pl.Shard(0)], rank=r)
        a = arange(10, device_mesh=m, placements=[pl.Shard(0)], rank=r)
        ra = vt.arange(10, device_mesh=ref_mesh, placements=[S(0)])
        np.testing.assert_array_equal(a.to_local().numpy(), np.asarray(ra.to_local(rank=r)))
        assert z.to_local().shape == (2, 4) and not z.to_local().any()
        assert o.to_local().shape == (4, 1) and bool((o.to_local() == 1).all())
        expect = 2.5 if m.coordinate_of_rank(r)[0] == 0 else 0.0  # Partial(sum) seeds coordinate 0
        assert bool((f.to_local() == expect).all())
    a5 = arange(2, 20, 3, device_mesh=m, placements=[pl.Shard(0), pl.Shard(0)], rank=5)
    r5 = vt.arange(2, 20, 3, device_mesh=ref_mesh, placements=[S(0), S(0)])
    assert a5.to_local().tolist() == np.asarray(r5.to_local(rank=5)).tolist() == [14]
