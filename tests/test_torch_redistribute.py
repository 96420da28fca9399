"""The port's redistribute, api calls and mesh collectives over gloo, held
to the JAX reference on conftest's virtual 8-device mesh.

The port runs in one gloo world of 8 ranks and one of 4 (children of
``tests/torch_spmd_child.py``, spawned once for this module); the reference
runs here.  Rank ``r``'s piece is held to the reference's
``to_local(rank=r)`` and every rank's ``full_tensor`` to the input, exactly:
the inputs are numpy-seeded normals, or integer-valued where a sum is
involved, so the reference is exact too.  A mesh collective's rank ``r`` is
held to slice ``r`` of the reference's stacked result.
"""

import zlib

import numpy as np
import pytest

import vescale_tpu as vt
from vescale_tpu import collectives as ref_coll
from vescale_tpu import placements as ref_pl

import torch_spmd_child as child
from torch_spmd_child import enc, make_input

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


def _ref_mesh(shape, names):
    return vt.DeviceMesh(tuple(names), tuple(shape))


def _ref_darray(mesh_shape, names, src, shape, seed, kind, partial_locals):
    m = _ref_mesh(mesh_shape, names)
    if partial_locals:
        locs = [child.local_operand(mesh_shape, [enc(p) for p in src], shape, seed, kind, r)
                for r in range(m.size())]
        return vt.from_local(locs, m, list(src), shape=tuple(shape))
    return vt.distribute_tensor(make_input(shape, seed, kind), m, list(src))


def _run(worlds, mesh_shape, names, src, dst, shape, seed=0, kind="normal", partial_locals=False,
         dst_mesh=None):
    """Port and reference of one transition: every rank's piece exactly the
    reference's, every rank's full tensor exactly the reference's."""
    n = int(np.prod(mesh_shape))
    res = worlds(n).run("redistribute", mesh_shape=list(mesh_shape), names=list(names),
                        src=[enc(p) for p in src], dst=[enc(p) for p in dst], shape=list(shape),
                        seed=seed, kind=kind, partial_locals=partial_locals,
                        dst_mesh=[list(dst_mesh[0]), list(dst_mesh[1])] if dst_mesh else None)
    d = _ref_darray(mesh_shape, names, src, shape, seed, kind, partial_locals)
    out = d.redistribute(_ref_mesh(*dst_mesh) if dst_mesh else None, list(dst))
    golden = np.asarray(out.full_tensor())
    for r, got in enumerate(res):
        np.testing.assert_array_equal(got["local"], np.asarray(out.to_local(rank=r)),
                                      err_msg=f"rank {r}: {src} -> {dst}")
        np.testing.assert_array_equal(got["full"], golden, err_msg=f"rank {r} full: {src} -> {dst}")
    return res


# The transitions of tests/test_darray.py and tests/test_placements.py,
# with the meshes they use: (mesh shape, names, src, dst, tensor shape,
# input kind, partial locals).
CASES_8 = {
    "shard_to_replicate": ((8,), ("tp",), [S(0)], [R()], (16, 1), "normal", False),
    "partial_to_replicate": ((8,), ("tp",), [P()], [R()], (4,), "int", True),
    "partial_to_shard": ((8,), ("tp",), [P()], [S(0)], (8,), "int", True),
    "partial_avg_to_replicate": ((8,), ("tp",), [P("avg")], [R()], (8, 2), "int", True),
    "partial_max_to_replicate": ((8,), ("tp",), [P("max")], [R()], (2,), "normal", True),
    "partial_min_to_shard": ((8,), ("tp",), [P("min")], [S(0)], (12, 3), "normal", True),
    "shard_to_shard_2d": ((2, 4), ("dp", "tp"), [R(), S(0)], [R(), S(1)], (8, 8), "normal", False),
    "uneven_shard_to_replicate": ((8,), ("tp",), [S(0)], [R()], (10,), "normal", False),
    "uneven_shard0_to_shard1": ((8,), ("tp",), [S(0)], [S(1)], (10, 13), "normal", False),
    "replicate_to_uneven_shard": ((8,), ("tp",), [R()], [S(1)], (3, 11), "normal", False),
    # the per-shard transition battery (test_transition_fast_path_battery)
    "battery_s0r_rs1": ((2, 4), ("dp", "tp"), [S(0), R()], [R(), S(1)], (7, 12), "normal", False),
    "battery_rs0_rs1": ((2, 4), ("dp", "tp"), [R(), S(0)], [R(), S(1)], (7, 12), "normal", False),
    "battery_rs0_s0r": ((2, 4), ("dp", "tp"), [R(), S(0)], [S(0), R()], (7, 12), "normal", False),
    "battery_pr_rr": ((2, 4), ("dp", "tp"), [P(), R()], [R(), R()], (7, 12), "int", True),
    "battery_pr_s0r": ((2, 4), ("dp", "tp"), [P(), R()], [S(0), R()], (7, 12), "int", True),
    "battery_pavg_s1": ((2, 4), ("dp", "tp"), [P("avg"), S(1)], [R(), S(1)], (7, 12), "int", True),
    "battery_rr_ps0": ((2, 4), ("dp", "tp"), [R(), R()], [P(), S(0)], (7, 12), "normal", False),
    "battery_pmax_s1r": ((2, 4), ("dp", "tp"), [P("max"), R()], [S(1), R()], (7, 12), "normal", True),
    # ragged all-gather-v, slice-v and all-to-all-v (test_ragged_transition_kernels)
    "ragged_to_replicate": ((8,), ("fsdp",), [RS((0,), (1, 2, 1, 2, 1, 3, 3, 3))], [R()], (64,),
                            "normal", False),
    "replicate_to_ragged": ((8,), ("fsdp",), [R()], [RS((0,), (1, 2, 1, 2, 1, 3, 3, 3))], (64,),
                            "normal", False),
    "ragged_to_ragged": ((8,), ("fsdp",), [RS((0,), (1, 2, 1, 2, 1, 3, 3, 3))],
                         [RS((0,), (3, 3, 3, 1, 2, 1, 2, 1))], (64,), "normal", False),
    "ragged_to_ragged_back": ((8,), ("fsdp",), [RS((0,), (3, 3, 3, 1, 2, 1, 2, 1))],
                              [RS((0,), (1, 2, 1, 2, 1, 3, 3, 3))], (64,), "normal", False),
    "ragged_2d_units_with_zero": ((8,), ("fsdp",), [RS((0, 1), (0, 2, 1, 2, 1, 3, 3, 4))],
                                  [RS((0, 1), (2, 2, 2, 2, 2, 2, 2, 2))], (8, 16), "normal", False),
    # strided ragged (test_strided_ragged_* and test_plain_strided_ragged_transitions)
    "strided_to_replicate": ((2, 4), ("tp", "fsdp"), [S(0), SRS((0,), (1, 1, 1, 1), split_factor=2)],
                             [R(), R()], (32,), "normal", False),
    "replicate_to_strided": ((2, 4), ("tp", "fsdp"), [R(), R()],
                             [S(0), SRS((0,), (1, 1, 1, 1), split_factor=2)], (32,), "normal", False),
    "strided_a2a": ((2, 4), ("tp", "fsdp"), [S(0), SRS((0,), (1, 2, 3, 2), split_factor=2)],
                    [S(0), SRS((0,), (2, 3, 2, 1), split_factor=2)], (64,), "normal", False),
    "strided_a2a_back": ((2, 4), ("tp", "fsdp"), [S(0), SRS((0,), (2, 3, 2, 1), split_factor=2)],
                         [S(0), SRS((0,), (1, 2, 3, 2), split_factor=2)], (64,), "normal", False),
    "strided_a2a_ragged_first": ((4, 2), ("fsdp", "tp"), [SRS((0,), (1, 2, 3, 2), split_factor=2), S(0)],
                                 [SRS((0,), (2, 3, 2, 1), split_factor=2), S(0)], (64,), "normal", False),
    "strided_a2a_ragged_first_back": ((4, 2), ("fsdp", "tp"),
                                      [SRS((0,), (2, 3, 2, 1), split_factor=2), S(0)],
                                      [SRS((0,), (1, 2, 3, 2), split_factor=2), S(0)], (64,), "normal",
                                      False),
    "plain_to_strided": ((2, 4), ("tp", "fsdp"), [R(), RS((0,), (1, 2, 3, 2))],
                         [S(0), SRS((0,), (2, 3, 2, 1), split_factor=2)], (64,), "normal", False),
    "strided_to_plain": ((2, 4), ("tp", "fsdp"), [S(0), SRS((0,), (2, 3, 2, 1), split_factor=2)],
                         [R(), RS((0,), (1, 2, 3, 2))], (64,), "normal", False),
    "plain_to_strided_ragged_first": ((4, 2), ("fsdp", "tp"), [RS((0,), (1, 2, 3, 2)), R()],
                                      [SRS((0,), (2, 3, 2, 1), split_factor=2), S(0)], (64,),
                                      "normal", False),
    "strided_to_plain_ragged_first": ((4, 2), ("fsdp", "tp"),
                                      [SRS((0,), (2, 3, 2, 1), split_factor=2), S(0)],
                                      [RS((0,), (1, 2, 3, 2)), R()], (64,), "normal", False),
    # interleaved piece exchanges (test_interleaved_transition_kernels)
    "is3_to_shard": ((8,), ("tp",), [IS(0, 3)], [S(0)], (96, 3), "normal", False),
    "shard_to_is3": ((8,), ("tp",), [S(0)], [IS(0, 3)], (96, 3), "normal", False),
    "is2_to_is4": ((8,), ("tp",), [IS(0, 2)], [IS(0, 4)], (96, 3), "normal", False),
    "is3_to_replicate": ((8,), ("tp",), [IS(0, 3)], [R()], (96, 3), "normal", False),
    "replicate_to_is6": ((8,), ("tp",), [R()], [IS(0, 6)], (96, 3), "normal", False),
    "is_passthrough_dp": ((2, 4), ("dp", "tp"), [S(0), IS(1, 2)], [S(0), S(1)], (8, 32), "normal",
                          False),
    "is_passthrough_dp_back": ((2, 4), ("dp", "tp"), [S(0), S(1)], [S(0), IS(1, 4)], (8, 32), "normal",
                               False),
    "is_uneven_sections": ((8,), ("tp",), [IS(0, 3)], [R()], (12, 2), "normal", False),
    # nested shards on one tensor dim, and the 4-D mesh of conftest
    "nested_to_replicate": ((2, 4), ("dp", "tp"), [S(0), S(0)], [R(), R()], (13, 3), "normal", False),
    "nested_inner_to_outer": ((2, 4), ("dp", "tp"), [R(), S(0)], [S(0), S(0)], (16, 2), "normal",
                              False),
    "nested_interleaved_to_replicate": ((2, 4), ("dp", "tp"), [IS(1, 2), IS(1, 2)], [R(), R()], (3, 32),
                                        "normal", False),
    "nested_interleaved_inner_change": ((2, 4), ("dp", "tp"), [IS(1, 2), IS(1, 2)], [IS(1, 2), S(0)],
                                        (5, 32), "normal", False),
    "mesh4d_swap": ((2, 2, 1, 2), ("pp", "dp", "sp", "tp"), [S(0), R(), R(), S(1)],
                    [R(), S(1), R(), S(0)], (6, 10), "normal", False),
    "mesh4d_partial": ((2, 2, 1, 2), ("pp", "dp", "sp", "tp"), [P(), S(0), R(), P()],
                       [S(1), S(0), R(), R()], (4, 6), "int", True),
}

CASES_4 = {
    "ragged_fsdp4_to_replicate": ((4,), ("fsdp",), [RS((0,), (1, 2, 3, 2))], [R()], (16,), "normal",
                                  False),
    "ragged_fsdp4_a2av": ((4,), ("fsdp",), [RS((0,), (1, 2, 3, 2))], [RS((0,), (2, 2, 2, 2))], (16,),
                          "normal", False),
    "interleaved_tp4": ((4,), ("tp",), [IS(0, 3)], [R()], (24,), "normal", False),
    "double_interleaved": ((2, 2), ("a", "b"), [IS(0, 2), IS(1, 2)], [R(), R()], (4, 8), "normal",
                           False),
    "nested_roundtrip": ((2, 2), ("a", "b"), [S(0), S(0)], [R(), S(1)], (8, 2), "normal", False),
    "partial_2x2": ((2, 2), ("a", "b"), [P(), P()], [R(), S(0)], (6, 2), "int", True),
}


@pytest.mark.parametrize("name", sorted(CASES_8))
def test_transition_on_8_ranks(worlds, name):
    mesh_shape, names, src, dst, shape, kind, partial = CASES_8[name]
    res = _run(worlds, mesh_shape, names, src, dst, shape, seed=zlib.crc32(name.encode()) % 1000, kind=kind,
               partial_locals=partial)
    assert all(r["placements"] == [enc(p) for p in dst] for r in res)


@pytest.mark.parametrize("name", sorted(CASES_4))
def test_transition_on_4_ranks(worlds, name):
    mesh_shape, names, src, dst, shape, kind, partial = CASES_4[name]
    _run(worlds, mesh_shape, names, src, dst, shape, seed=7, kind=kind, partial_locals=partial)


def _random_pairs(n, seed=2026):
    """``n`` seeded (mesh, src, dst, shape) draws over the dense kinds."""
    rng = np.random.default_rng(seed)
    kinds = [S(0), S(1), R(), IS(0, 2), IS(1, 3), P()]
    meshes = [((2, 4), ("dp", "tp")), ((4, 2), ("a", "b")), ((2, 2, 2), ("x", "y", "z"))]

    def valid(ps):
        inter = {}
        for p in ps:
            if isinstance(p, IS):
                if inter.setdefault(p.dim, p) != p:
                    return False
        return not any(type(p) is S and p.dim in inter for p in ps)

    out = []
    while len(out) < n:
        mesh_shape, names = meshes[len(out) % 3]
        src = [kinds[i] for i in rng.integers(0, len(kinds), len(mesh_shape))]
        dst = [kinds[i] for i in rng.integers(0, len(kinds), len(mesh_shape))]
        if valid(src) and valid(dst) and src != dst:
            out.append((mesh_shape, names, src, dst, (2 * int(rng.integers(5, 14)), 6 * int(rng.integers(1, 4)))))
    return out


RANDOM_PAIRS = _random_pairs(18)


@pytest.mark.parametrize("i", range(len(RANDOM_PAIRS)))
def test_random_transitions_match_the_reference(worlds, i):
    """Seeded random pairs of dense placements (uneven, nested, interleaved,
    partial) on three meshes: every rank's full tensor exactly the
    reference's; every piece exactly the reference's unless the destination
    keeps a Partial mesh dim, where the port leaves each rank's contribution
    in place and the reference may seed the sum at coordinate 0 (the same
    value: a 120-pair sweep differed only there)."""
    mesh_shape, names, src, dst, shape = RANDOM_PAIRS[i]
    partial = any(p.is_partial() for p in src)
    kind = "int" if partial or any(p.is_partial() for p in dst) else "normal"
    res = worlds(8).run("redistribute", mesh_shape=list(mesh_shape), names=list(names),
                        src=[enc(p) for p in src], dst=[enc(p) for p in dst], shape=list(shape),
                        seed=i, kind=kind, partial_locals=partial)
    d = _ref_darray(mesh_shape, names, src, shape, i, kind, partial)
    out = d.redistribute(placements=dst)
    for r, got in enumerate(res):
        np.testing.assert_array_equal(got["full"], np.asarray(out.full_tensor()), err_msg=f"{src} -> {dst}")
        if not any(p.is_partial() for p in dst):
            np.testing.assert_array_equal(got["local"], np.asarray(out.to_local(rank=r)),
                                          err_msg=f"rank {r}: {src} -> {dst}")


def test_no_single_hop_transition_took_the_fallback(worlds):
    """Every table transition above is one hop a mesh dim: none warned."""
    for name in ("ragged_to_ragged", "strided_a2a", "is2_to_is4", "battery_rs0_rs1"):
        mesh_shape, names, src, dst, shape, kind, partial = CASES_8[name]
        res = worlds(8).run("redistribute", mesh_shape=list(mesh_shape), names=list(names),
                            src=[enc(p) for p in src], dst=[enc(p) for p in dst], shape=list(shape),
                            seed=1, kind=kind, partial_locals=partial)
        assert all(r["warned"] == [] and r["fallbacks"] == 0 for r in res), name


@pytest.mark.parametrize("case", [
    ((8,), ("x",), [RS((0,), (2,) * 8)], [RS((0,), (1, 3, 1, 3, 1, 3, 1, 3))], (1 << 14,)),
    ((2, 4), ("tp", "fsdp"), [S(0), SRS((0,), (1, 2, 3, 2), split_factor=2)],
     [S(0), SRS((0,), (2, 3, 2, 1), split_factor=2)], (4096,)),
    ((8,), ("x",), [S(0)], [S(1)], (64, 48)),
])
def test_all_to_all_v_moves_only_o_shard_buffers(worlds, case):
    """The reference holds its ragged reshard to peak memory O(shard)
    (test_ragged_reshard_peak_memory_o_shard).  Here a rank's transition
    buffers are its send (at most its source piece; a strided piece's
    chunk, split_factor cells, after the inner gather) and its receive
    (its destination piece), and no all-gather of the whole tensor runs."""
    mesh_shape, names, src, dst, shape = case
    res = worlds(8).run("exchange_buffers", mesh_shape=list(mesh_shape), names=list(names),
                        src=[enc(p) for p in src], dst=[enc(p) for p in dst], shape=list(shape), seed=2)
    total = int(np.prod(shape))
    for got in res:
        assert len(got["sizes"]) == 1
        (send, recv), = got["sizes"]
        factor = 2 if isinstance(src[-1], SRS) else 1
        assert send <= factor * got["src_numel"] and recv <= factor * got["dst_numel"]
        assert max(send, recv) <= total // 2
        assert set(got["calls"]) <= {"gloo.all_to_all", "gloo.all_gather"}
        if factor == 1:
            assert set(got["calls"]) == {"gloo.all_to_all"}


def test_cross_mesh_plain(worlds):
    """(2, 4) -> (8,) shards, a Partial source reduced on its own mesh
    first, and an interleaved source (test_cross_mesh_redistribute_per_shard),
    none through the fallback."""
    a, b = ((2, 4), ("dp", "tp")), ((8,), ("tp8",))
    res = _run(worlds, *a, [S(0), S(1)], [S(0)], (64, 4), dst_mesh=b)
    assert all(r["fallbacks"] == 0 for r in res)
    res = _run(worlds, *a, [P(), R()], [S(0)], (8, 4), kind="int", partial_locals=True, dst_mesh=b)
    assert all(r["fallbacks"] == 0 for r in res)
    res = _run(worlds, *a, [R(), IS(0, 2)], [S(0)], (64, 4), dst_mesh=b)
    assert all(r["fallbacks"] == 0 for r in res)
    _run(worlds, *b, [S(1)], [S(1), IS(0, 2)], (10, 9), dst_mesh=a)


def test_fallback_warns_counts_and_strict_raises(worlds):
    """ragged -> dense Shard has no single hop (the reference's planner
    declines it too): it goes through Replicate with the warning and one
    ``redistribute.fallbacks``; VESCALE_STRICT_REDISTRIBUTE=1 raises."""
    args = dict(mesh_shape=[8], names=["x"], src=[enc(RS((0,), (1, 2, 1, 2, 1, 3, 3, 3)))],
                dst=[enc(S(0))], shape=[64], seed=3)
    res = _run(worlds, (8,), ("x",), [RS((0,), (1, 2, 1, 2, 1, 3, 3, 3))], [S(0)], (64,), seed=3)
    assert all(len(r["warned"]) == 1 and r["fallbacks"] == 1 for r in res)
    assert "through Replicate" in res[0]["warned"][0]
    strict = worlds(8).run("redistribute", strict=True, **args)
    assert all("VESCALE_STRICT_REDISTRIBUTE" in r["raised"] for r in strict)


def test_partial_sums_are_bitwise_equal_on_every_rank_and_run(worlds):
    """Float (not integer) contributions: the reduction's bits are the
    same on all 8 ranks and on a second run of the same world."""
    res = worlds(8).run("partial_bits", mesh_shape=[2, 4], names=["dp", "tp"], shape=[33, 7], seed=5)
    first = res[0]["outs"][0]
    for r in res:
        for o in r["outs"]:
            assert o.tobytes() == first.tobytes()
    # the reference's value, within the rounding of another summation order
    locs = [make_input((33, 7), 5, "normal", rank=r) for r in range(8)]
    ref = np.asarray(vt.from_local(locs, _ref_mesh((2, 4), ("dp", "tp")), [P(), P()]).full_tensor())
    np.testing.assert_allclose(first, ref, rtol=0, atol=8 * np.finfo(np.float32).eps * np.abs(ref).max())


# ------------------------------------------------------------ api calls
API_CASES = {
    "all_gather_tp": ([R(), S(0)], (8, 2), "vescale_all_gather", {"mesh_dims": ["tp"]}, False),
    "all_gather_all": ([S(1), S(0)], (8, 6), "vescale_all_gather", {}, False),
    "all_gather_interleaved": ([R(), IS(0, 3)], (24,), "vescale_all_gather", {}, False),
    "all_reduce_dp": ([P(), P()], (8, 2), "vescale_all_reduce", {"mesh_dims": ["dp"]}, True),
    "all_reduce_all": ([P(), P()], (5, 3), "vescale_all_reduce", {}, True),
    "reduce_scatter_tp": ([R(), P()], (8, 4), "vescale_reduce_scatter",
                          {"scatter_dim": 1, "mesh_dims": ["tp"]}, True),
    "reduce_scatter_two_dims": ([P(), P()], (8, 4), "vescale_reduce_scatter",
                                {"scatter_dim": [0, 1], "mesh_dims": ["dp", "tp"]}, True),
}


@pytest.mark.parametrize("name", sorted(API_CASES))
def test_api_calls(worlds, name):
    src, shape, call, kw, partial = API_CASES[name]
    res = worlds(8).run("api", mesh_shape=[2, 4], names=["dp", "tp"], src=[enc(p) for p in src],
                        shape=list(shape), seed=11, call=call, kind="int", partial_locals=partial, **kw)
    d = _ref_darray((2, 4), ("dp", "tp"), src, shape, 11, "int", partial)
    out = getattr(vt, call)(d, **kw)
    for r, got in enumerate(res):
        assert got["placements"] == [enc(p) for p in out.placements]
        np.testing.assert_array_equal(got["local"], np.asarray(out.to_local(rank=r)))
        np.testing.assert_array_equal(got["full"], np.asarray(out.full_tensor()))


# ---------------------------------------------------- mesh collectives
COLL_CASES = {
    "all_reduce_sum": ("mesh_all_reduce", {"reduce_op": "sum"}, (4, 3), 1, False),
    "all_reduce_max": ("mesh_all_reduce", {"reduce_op": "max"}, (4, 3), 0, False),
    "all_reduce_avg": ("mesh_all_reduce", {"reduce_op": "avg"}, (4, 3), 1, False),
    "all_gather_dim1": ("mesh_all_gather", {"gather_dim": 1}, (2, 3), 1, False),
    "reduce_scatter_sum": ("mesh_reduce_scatter", {"reduce_op": "sum", "scatter_dim": 0}, (8, 3), 1,
                           True),
    "reduce_scatter_min": ("mesh_reduce_scatter", {"reduce_op": "min", "scatter_dim": 1}, (3, 8), 1,
                           True),
    "all_to_all": ("mesh_all_to_all", {"split_dim": 0, "concat_dim": 1}, (8, 2), 1, True),
    "broadcast": ("mesh_broadcast", {"src_rank": 2}, (5,), 1, False),
    "ppermute": ("mesh_ppermute", {"shift": 1}, (3, 2), 1, True),
    "ppermute_dp": ("mesh_ppermute", {"shift": 1}, (3, 2), 0, True),
}


@pytest.mark.parametrize("name", sorted(COLL_CASES))
def test_mesh_collectives(worlds, name):
    """Rank r's result is slice r (along the mesh dim) of the reference's
    stacked result, or its whole unstacked result."""
    op, kw, shape, mesh_dim, stacked_out = COLL_CASES[name]
    res = worlds(8).run("collective", mesh_shape=[2, 4], names=["dp", "tp"], op=op, shape=list(shape),
                        seed=13, mesh_dim=mesh_dim, **kw)
    ref_mesh = _ref_mesh((2, 4), ("dp", "tp"))
    n = ref_mesh.shape[mesh_dim]
    stacked = make_input([n] + list(shape), 13, "int")
    ref = np.asarray(getattr(ref_coll, op)(stacked, ref_mesh, mesh_dim=mesh_dim, **kw))
    for r, got in enumerate(res):
        idx = ref_mesh.coordinate_of_rank(r)[mesh_dim]
        np.testing.assert_array_equal(got["out"], ref[idx] if stacked_out else ref, err_msg=name)
        assert sum(got["calls"].values()) >= 1 and all(k.startswith("gloo.") for k in got["calls"])


def test_mesh_scatter_matches_array_split(worlds):
    res = worlds(8).run("collective", mesh_shape=[2, 4], names=["dp", "tp"], op="mesh_scatter",
                        shape=[12, 3], seed=17, mesh_dim=1, scatter_dim=0, src_rank=1)
    stacked = make_input([4, 12, 3], 17, "int")
    ref = np.asarray(ref_coll.mesh_scatter(stacked[1], _ref_mesh((2, 4), ("dp", "tp")), mesh_dim=1))
    for r, got in enumerate(res):
        np.testing.assert_array_equal(got["out"], ref[r % 4])
