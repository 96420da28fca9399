"""The port's checkpoint against the JAX package's, on the CPU.

``vescale_tpu_torch.checkpoint`` writes the reference's format: the same
``meta.json`` ``"arrays"`` block and, chunk by chunk, the same ``.npy``
bytes for fp32, bf16 and int32 leaves, dense and ragged; each package
restores what the other wrote, bit for bit.  Multi-rank saves and loads run
on a gloo world of 4 (children of ``tests/torch_spmd_child.py``, spawned
once for this module), each rank's piece held to the reference's
``to_local(rank=r)``; the rest runs in this process on one-rank and
layout-only meshes.  The tests mirror ``tests/test_checkpoint.py`` and the
checkpoint cases of ``tests/test_elastic.py``, then the port's own: chunk
math over hypothesis-drawn boxes against the reference's, the save that
must raise when the mesh is larger than the world, a failed write on one
rank failing the save everywhere, and a bf16 load with ``ml_dtypes``
blocked.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import vescale_tpu as vt
import vescale_tpu.checkpoint as jck
from vescale_tpu import placements as jpl
from vescale_tpu.checkpoint import reshard as jrs

from vescale_tpu_torch import checkpoint as tck
from vescale_tpu_torch import placements as pl
from vescale_tpu_torch.checkpoint import CheckpointManager, ElasticMismatchError
from vescale_tpu_torch.checkpoint import elastic as tel
from vescale_tpu_torch.checkpoint import native_io
from vescale_tpu_torch.checkpoint import reshard as trs
from vescale_tpu_torch.checkpoint.storage import FileSystemStorage
from vescale_tpu_torch.darray import distribute_tensor
from vescale_tpu_torch.mesh import DeviceMesh
from vescale_tpu_torch.resilience import faultsim as tfs

import torch_spmd_child as child
from torch_spmd_child import enc, make_input

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, R, IS, RS, PT = jpl.Shard, jpl.Replicate, jpl.InterleavedShard, jpl.RaggedShard, jpl.Partial


@pytest.fixture(scope="module")
def world():
    w = child.World(4)
    yield w
    w.close()


@pytest.fixture(autouse=True)
def clean():
    yield
    tfs.disarm()


# ------------------------------------------------------------- helpers
def leaf(key, shape, placements, dtype="float32", seed=0, **kw):
    return dict(key=key, shape=list(shape), placements=[enc(p) for p in placements], dtype=dtype,
                seed=seed, **kw)


def ref_value(lf):
    """The reference's value of a case leaf: the same numpy input, cast as
    the port casts it (bf16 rounds to nearest even in both)."""
    kind = "int" if lf["dtype"] == "int32" else lf.get("kind", "normal")
    x = make_input(lf["shape"], lf["seed"], kind)
    return jnp.asarray(x).astype(jnp.bfloat16) if lf["dtype"] == "bfloat16" else x.astype(lf["dtype"])


def ref_mesh(shape, names):
    n = int(np.prod(shape))
    return vt.DeviceMesh(tuple(names), tuple(shape), devices=jax.devices()[:n])


def ref_leaves(mesh, leaves):
    out = {}
    for lf in leaves:
        ps = [child.dec(e, jpl) for e in lf["placements"]]
        if lf.get("host"):
            out[lf["key"]] = np.arange(float(np.prod(lf["shape"]))).reshape(lf["shape"])
        elif lf.get("partial"):
            locs = [child.local_operand(list(mesh.shape), lf["placements"], lf["shape"], lf["seed"],
                                        lf.get("kind", "normal"), r) for r in range(mesh.size())]
            out[lf["key"]] = vt.from_local(locs, mesh, ps)
        else:
            out[lf["key"]] = vt.distribute_tensor(ref_value(lf), mesh, ps)
    return out


def bits(x) -> bytes:
    """The raw bytes of a piece as the reference or the port holds it (the
    gloo children send bf16 pieces as their exact float32 values)."""
    if isinstance(x, torch.Tensor):
        x = x.float() if x.dtype == torch.bfloat16 else x
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        a = a.astype(np.float32)
    return np.ascontiguousarray(a).tobytes()


def same_files(ref_root, port_root):
    """The "arrays" blocks equal and every chunk file byte-identical."""
    mr = json.load(open(os.path.join(ref_root, "meta.json")))
    mp = json.load(open(os.path.join(port_root, "meta.json")))
    assert mp["arrays"] == mr["arrays"]
    n = 0
    for entry in mr["arrays"].values():
        for c in entry["chunks"]:
            with open(os.path.join(ref_root, c["file"]), "rb") as a, \
                    open(os.path.join(port_root, c["file"]), "rb") as b:
                assert a.read() == b.read(), c["file"]
            n += 1
    return mr, mp, n


def check_pieces(res, leaves, mesh_shape, names):
    """Every rank's loaded piece exactly the reference's to_local(r) of the
    same layout, and its full tensor the input."""
    ref = ref_leaves(ref_mesh(mesh_shape, names), leaves)
    for r, got in enumerate(res):
        for lf in leaves:
            if lf.get("host"):
                np.testing.assert_array_equal(got["full"][lf["key"]], ref[lf["key"]])
                continue
            want = ref[lf["key"]]
            assert bits(got["locals"][lf["key"]]) == bits(want.to_local(rank=r)), (lf["key"], r)
            assert bits(got["full"][lf["key"]]) == bits(want.full_tensor()), lf["key"]


# ----------------------------------------------------- chunk-box math
def test_box_math():
    a = trs.Box((0, 0), (4, 4))
    b = trs.Box((2, 2), (4, 4))
    assert trs.intersect(a, b) == trs.Box((2, 2), (2, 2))
    assert trs.intersect(trs.Box((0,), (2,)), trs.Box((2,), (2,))) is None
    assert trs.dense_to_flat_ranges(trs.Box((1, 0), (2, 3)), (4, 3)) == [(3, 6)]
    assert trs.dense_to_flat_ranges(trs.Box((0, 1), (2, 2)), (2, 4)) == [(1, 2), (5, 2)]


@st.composite
def shape_and_boxes(draw):
    shape = tuple(draw(st.lists(st.integers(1, 5), min_size=1, max_size=3)))

    def box():
        off = tuple(draw(st.integers(0, n - 1)) for n in shape)
        size = tuple(draw(st.integers(0, n - o)) for n, o in zip(shape, off))
        return off, size

    return shape, [box() for _ in range(draw(st.integers(1, 4)))]


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(shape_and_boxes())
def test_box_math_equals_the_reference(case):
    shape, boxes = case
    for (ao, asz) in boxes:
        ta, ja = trs.Box(ao, asz), jrs.Box(ao, asz)
        assert trs.dense_to_flat_ranges(ta, shape) == jrs.dense_to_flat_ranges(ja, shape)
        assert ta.to_json() == ja.to_json() and ta.nelems == ja.nelems
        for (bo, bsz) in boxes:
            ti, ji = trs.intersect(ta, trs.Box(bo, bsz)), jrs.intersect(ja, jrs.Box(bo, bsz))
            assert (ti is None and ji is None) or ti.to_json() == ji.to_json()


@st.composite
def fill_case(draw):
    shape = tuple(draw(st.lists(st.integers(1, 5), min_size=1, max_size=3)))
    n = int(np.prod(shape))
    # the saved chunks tile the array: dense row blocks or flat runs
    flat_saved = draw(st.booleans())
    cuts = sorted(set(draw(st.lists(st.integers(1, (n if flat_saved else shape[0]) - 1 or 1),
                                    max_size=3))))
    ext = n if flat_saved else shape[0]
    edges = [0] + [c for c in cuts if 0 < c < ext] + [ext]
    saved = []
    for lo, hi in zip(edges, edges[1:]):
        if flat_saved:
            saved.append(((lo,), (hi - lo,), True))
        else:
            saved.append(((lo,) + (0,) * (len(shape) - 1), (hi - lo,) + shape[1:], False))
    if draw(st.booleans()):
        off = draw(st.integers(0, n - 1))
        target = ((off,), (draw(st.integers(0, n - off)),), True)
    else:
        off = tuple(draw(st.integers(0, d - 1)) for d in shape)
        target = (off, tuple(draw(st.integers(0, d - o)) for d, o in zip(shape, off)), False)
    return shape, saved, target


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(fill_case())
def test_fill_box_from_chunks_equals_the_reference(case):
    shape, saved, (toff, tsize, tflat) = case
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    chunks = {}
    for i, (off, size, flat) in enumerate(saved):
        if flat:
            chunks[f"c{i}"] = x.reshape(-1)[off[0]:off[0] + size[0]]
        else:
            chunks[f"c{i}"] = x[tuple(slice(o, o + s) for o, s in zip(off, size))]
    got = trs.fill_box_from_chunks(trs.Box(toff, tsize, tflat), shape, np.float32,
                                   [(trs.Box(o, s, f), f"c{i}") for i, (o, s, f) in enumerate(saved)],
                                   chunks.__getitem__)
    want = jrs.fill_box_from_chunks(jrs.Box(toff, tsize, tflat), shape, np.float32,
                                    [(jrs.Box(o, s, f), f"c{i}") for i, (o, s, f) in enumerate(saved)],
                                    chunks.__getitem__)
    assert got.shape == want.shape and got.tobytes() == want.tobytes()


def test_fill_box_coprime_shard_counts():
    """3 saved shards -> 2 readers: every target range straddles a saved
    chunk boundary (the multi-source fill path)."""
    x = np.arange(30, dtype=np.float32)
    chunks = {f"c{i}": x[o:o + 10] for i, o in enumerate((0, 10, 20))}
    saved = [(trs.Box((o,), (10,), flat=True), f"c{i}") for i, o in enumerate((0, 10, 20))]
    for off, size in [(0, 15), (15, 15)]:
        out = trs.fill_box_from_chunks(trs.Box((off,), (size,), flat=True), (30,), np.float32,
                                       saved, chunks.__getitem__)
        assert np.array_equal(out, x[off:off + size])
    dense = [(trs.Box((r * 10,), (10,)), f"c{r}") for r in range(3)]
    out = trs.fill_box_from_chunks(trs.Box((7,), (16,), flat=True), (30,), np.float32, dense,
                                   chunks.__getitem__)
    assert np.array_equal(out, x[7:23])


# ------------------------------------------- the same bytes, one rank
ONE_RANK = {
    "dense": ((6, 10), lambda: [pl.Shard(0)], [S(0)]),
    "ragged": ((60,), lambda: [pl.RaggedShard((0,), (1,))], [RS((0,), (1,))]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("layout", sorted(ONE_RANK))
def test_one_rank_chunk_files_are_the_references(tmp_path, dtype, layout):
    """A one-rank mesh DArray, a plain tensor and a scalar: the same
    "arrays" block and chunk bytes as the reference's save of the same
    values on its one-device mesh; and each package restores the other's."""
    shape, port_pl, ref_pl = ONE_RANK[layout]
    lf = leaf("d", shape, ref_pl, dtype=dtype, seed=3)
    x = child.ckpt_value(lf)
    tm = DeviceMesh(("dp",), (1,), device_type="cpu")
    jm = ref_mesh((1,), ("dp",))
    port = {"m": {"d": distribute_tensor(x, tm, port_pl(), rank=0), "t": x, "s": 7}}
    ref = {"m": {"d": vt.distribute_tensor(ref_value(lf), jm, ref_pl), "t": ref_value(lf), "s": 7}}
    tck.save(str(tmp_path / "p"), port)
    jck.save(str(tmp_path / "r"), ref)
    _, _, n = same_files(str(tmp_path / "r"), str(tmp_path / "p"))
    assert n == 3
    # the port restores the reference's files, bit for bit
    got = tck.load(str(tmp_path / "r"), {"m": {"d": distribute_tensor(torch.zeros_like(x), tm,
                                                                      port_pl(), rank=0),
                                               "t": torch.empty_like(x), "s": 0}})["m"]
    assert bits(got["d"].to_local()) == bits(x) and bits(got["t"]) == bits(x) and got["s"] == 7
    if dtype != "bfloat16":  # the reference cannot load bf16 chunks (ROADMAP §C)
        back = jck.load(str(tmp_path / "p"), ref)["m"]
        assert bits(back["d"].full_tensor()) == bits(x) and bits(back["t"]) == bits(x)


# ------------------------------------------------ gloo world of four
def test_save_load_roundtrip_on_four_ranks(world, tmp_path):
    leaves = [leaf("w", (8, 8), [S(0), S(1)]), leaf("b", (3,), [], host=True)]
    assert world.run("ckpt_save", root=str(tmp_path), mesh_shape=[2, 2], names=["dp", "tp"],
                     leaves=leaves) == [{"ok": True}] * 4
    res = world.run("ckpt_load", root=str(tmp_path), mesh_shape=[2, 2], names=["dp", "tp"],
                    leaves=leaves)
    check_pieces(res, leaves, (2, 2), ("dp", "tp"))
    assert all(r["stats"]["elastic"] == 0 for r in res)


@pytest.mark.parametrize("name", ["reshard_2d_to_1d", "ragged_to_dense", "dense_to_ragged",
                                  "ragged_units", "oversharded", "partial_and_interleaved"])
def test_reshard_on_load_on_four_ranks(world, tmp_path, name):
    """Saved in one layout, loaded in another: each rank reads the chunks
    its piece intersects (the reference's reshard round trips)."""
    cases = {
        "reshard_2d_to_1d": ((2, 2), ("dp", "tp"), [leaf("w", (8, 8), [S(0), S(1)])],
                             (4,), ("tp",), [leaf("w", (8, 8), [S(1)])]),
        "ragged_to_dense": ((4,), ("fsdp",), [leaf("buf", (16,), [RS((0,), (1, 2, 3, 2))])],
                            (4,), ("fsdp",), [leaf("buf", (16,), [S(0)])]),
        "dense_to_ragged": ((4,), ("fsdp",), [leaf("buf", (16,), [S(0)])],
                            (4,), ("fsdp",), [leaf("buf", (16,), [RS((0,), (1, 2, 3, 2))])]),
        "ragged_units": ((4,), ("fsdp",), [leaf("buf", (24,), [RS((0,), (3, 9, 6, 6))])],
                         (4,), ("fsdp",), [leaf("buf", (24,), [RS((0,), (6, 6, 9, 3))])]),
        "oversharded": ((4,), ("fsdp",), [leaf("x", (6,), [RS((0,), (1, 2, 2, 1))])],
                        (4,), ("fsdp",), [leaf("x", (6,), [S(0)])]),
        "partial_and_interleaved": (
            (4,), ("tp",), [leaf("p", (4,), [PT()], kind="int", partial=True),
                            leaf("il", (24,), [IS(0, 3)])],
            (4,), ("tp",), [leaf("p", (4,), [S(0)], kind="int", partial=True),
                            leaf("il", (24,), [S(0)])]),
    }
    smesh, snames, sleaves, lmesh, lnames, lleaves = cases[name]
    assert world.run("ckpt_save", root=str(tmp_path), mesh_shape=list(smesh), names=list(snames),
                     leaves=sleaves) == [{"ok": True}] * 4
    res = world.run("ckpt_load", root=str(tmp_path), mesh_shape=list(lmesh), names=list(lnames),
                    leaves=lleaves)
    if name == "partial_and_interleaved":
        # the Partial is reduced on save: the load sees the sum of the parts
        saved = ref_leaves(ref_mesh(smesh, snames), sleaves)
        want = vt.distribute_tensor(np.asarray(saved["p"].full_tensor()), ref_mesh(lmesh, lnames),
                                    [S(0)])
        for r, got in enumerate(res):
            assert bits(got["locals"]["p"]) == bits(want.to_local(rank=r))
        lleaves = lleaves[1:]
    check_pieces(res, lleaves, lmesh, lnames)


def test_load_reads_only_the_chunks_its_piece_needs(world, tmp_path):
    """4-way Shard(0) saved: the same layout reads one file a rank, a
    (2, 2) layout two, each chunk once (the local-only load plan)."""
    leaves = [leaf("w", (32, 32), [S(0)])]
    payload = 32 * 32 * 4
    world.run("ckpt_save", root=str(tmp_path), mesh_shape=[4], names=["dp"], leaves=leaves)
    res = world.run("ckpt_load", root=str(tmp_path), mesh_shape=[4], names=["dp"], leaves=leaves)
    for got in res:
        assert got["stats"]["files_read"] == 1
        assert payload // 4 <= got["stats"]["bytes_read"] <= payload // 4 + 256
    two = [leaf("w", (32, 32), [S(0), S(1)])]
    res = world.run("ckpt_load", root=str(tmp_path), mesh_shape=[2, 2], names=["dp", "tp"], leaves=two)
    for got in res:
        assert got["stats"]["files_read"] == 2
        assert payload // 2 <= got["stats"]["bytes_read"] <= payload // 2 + 2 * 256
    check_pieces(res, two, (2, 2), ("dp", "tp"))


def test_sharded_optimizer_state_writes_a_chunk_a_rank(world, tmp_path):
    """A dp-sharded fp32 master and bf16 moments (the reference's ZeRO
    state test at dp=4): each leaf is 4 chunk files of a quarter of it, and
    each rank reads back about a quarter of the state."""
    leaves = [leaf("main_params", (64, 32), [S(0)]), leaf("mu", (64, 32), [S(0)], dtype="bfloat16"),
              leaf("nu", (64, 32), [S(0)], dtype="bfloat16", seed=1)]
    world.run("ckpt_save", root=str(tmp_path), mesh_shape=[4], names=["dp"], leaves=leaves)
    for key, item in (("main_params", 4), ("mu", 2), ("nu", 2)):
        d = tmp_path / "data" / "m" / key
        files = sorted(os.listdir(d))
        assert len(files) == 4
        for f in files:
            assert 64 * 32 * item // 4 <= os.path.getsize(d / f) <= 64 * 32 * item // 4 + 256
    res = world.run("ckpt_load", root=str(tmp_path), mesh_shape=[4], names=["dp"], leaves=leaves)
    payload = 64 * 32 * (4 + 2 + 2)
    assert all(r["stats"]["bytes_read"] <= payload / 4 * 1.25 for r in res)
    check_pieces(res, leaves, (4,), ("dp",))


TWO_BY_TWO = [leaf("w", (8, 8), [S(0), S(1)]), leaf("bf", (6, 4), [S(0), R()], dtype="bfloat16", seed=1),
              leaf("i", (10, 3), [R(), S(0)], dtype="int32", seed=2),
              leaf("rg", (40,), [R(), RS((0,), (1, 3))], seed=3),
              leaf("rb", (12,), [RS((0,), (2, 1)), R()], dtype="bfloat16", seed=4)]


def test_four_rank_chunk_files_are_the_references(world, tmp_path):
    """A (2, 2) mesh on 4 gloo ranks against the reference's save on 4 of
    its 8 devices: the same "arrays" block and chunk bytes.  The writer
    blocks differ as ROADMAP §C states (4 processes here, 1 there)."""
    world.run("ckpt_save", root=str(tmp_path / "p"), mesh_shape=[2, 2], names=["dp", "tp"],
              leaves=TWO_BY_TWO)
    jck.save(str(tmp_path / "r"), {"m": ref_leaves(ref_mesh((2, 2), ("dp", "tp")), TWO_BY_TWO)})
    mr, mp, n = same_files(str(tmp_path / "r"), str(tmp_path / "p"))
    assert n == 4 + 2 + 2 + 2 + 2
    assert mp["writer"] == {"process_count": 4, "device_count": 4, "meshes": ["dp=2/tp=2"]}
    assert mr["writer"] == {"process_count": 1, "device_count": 8, "meshes": ["dp=2/tp=2"]}


def test_port_checkpoint_restores_in_the_reference(world, tmp_path):
    """What 4 gloo ranks wrote on (2, 2), the reference restores on its
    (2, 4) mesh bit for bit (fp32 and int32: the reference cannot load
    bf16 chunks at all, ROADMAP §C)."""
    leaves = [lf for lf in TWO_BY_TWO if lf["dtype"] != "bfloat16"]
    world.run("ckpt_save", root=str(tmp_path), mesh_shape=[2, 2], names=["dp", "tp"], leaves=leaves)
    m24 = ref_mesh((2, 4), ("dp", "tp"))
    tmpl = {"w": vt.distribute_tensor(np.zeros((8, 8), np.float32), m24, [S(1), S(0)]),
            "i": vt.distribute_tensor(np.zeros((10, 3), np.int32), m24, [S(0), R()]),
            "rg": vt.distribute_tensor(np.zeros(40, np.float32), m24, [R(), RS((0,), (5, 1, 1, 3))])}
    out = jck.load(str(tmp_path), {"m": tmpl})["m"]
    for lf in leaves:
        assert bits(out[lf["key"]].full_tensor()) == bits(ref_value(lf)), lf["key"]
    assert jck.LAST_LOAD_STATS["elastic"] == 1


SAVED_24 = [leaf("w", (8, 8), [S(0), S(1)]), leaf("uneven", (10, 3), [R(), S(0)], seed=1),
            leaf("il", (16, 4), [R(), IS(0, 2)], seed=2),
            leaf("rg", (32,), [R(), RS((0,), (1, 2, 3, 2))], seed=3),
            leaf("bf", (8, 8), [S(0), S(1)], dtype="bfloat16", seed=4)]
LOADS = {
    "1d": ((4,), ("x",), [leaf("w", (8, 8), [S(1)]), leaf("uneven", (10, 3), [S(0)], seed=1),
                          leaf("il", (16, 4), [IS(0, 2)], seed=2),
                          leaf("rg", (32,), [RS((0,), (2, 2, 2, 2))], seed=3),
                          leaf("bf", (8, 8), [S(0)], dtype="bfloat16", seed=4)]),
    "2d": ((2, 2), ("dp", "tp"), [leaf("w", (8, 8), [S(0), S(1)]),
                                  leaf("uneven", (10, 3), [S(0), S(0)], seed=1),
                                  leaf("il", (16, 4), [R(), IS(0, 2)], seed=2),
                                  leaf("rg", (32,), [R(), RS((0,), (3, 1))], seed=3),
                                  leaf("bf", (8, 8), [S(1), R()], dtype="bfloat16", seed=4)]),
}


@pytest.mark.parametrize("layout", sorted(LOADS))
def test_reference_2x4_checkpoint_restores_on_four_ranks(world, tmp_path, layout):
    """Shard, uneven Shard, InterleavedShard, RaggedShard and bf16 leaves
    written by the reference on its (2, 4) mesh, restored by 4 gloo ranks
    (the interleaved template through redistribute): every piece is the
    reference's own piece of that layout, and the load is elastic."""
    jck.save(str(tmp_path), {"m": ref_leaves(ref_mesh((2, 4), ("dp", "tp")), SAVED_24)})
    mesh_shape, names, leaves = LOADS[layout]
    res = world.run("ckpt_load", root=str(tmp_path), mesh_shape=list(mesh_shape), names=list(names),
                    leaves=leaves)
    check_pieces(res, leaves, mesh_shape, names)
    assert all(r["stats"]["elastic"] == 1 for r in res)


def test_reference_2x4_checkpoint_restores_on_one_rank(tmp_path):
    """The same checkpoint restored in this process: every rank's piece of
    a layout-only (2, 4) mesh in other placements (the ``rank=`` path), and
    the whole of each leaf on a one-rank mesh."""
    jck.save(str(tmp_path), {"m": ref_leaves(ref_mesh((2, 4), ("dp", "tp")), SAVED_24)})
    loads = [leaf("w", (8, 8), [S(1), S(0)]), leaf("uneven", (10, 3), [S(0), R()], seed=1),
             leaf("il", (16, 4), [IS(0, 2), S(1)], seed=2),
             leaf("rg", (32,), [RS((0,), (1, 1)), R()], seed=3),
             leaf("bf", (8, 8), [R(), S(0)], dtype="bfloat16", seed=4)]
    m8 = DeviceMesh(("dp", "tp"), (2, 4), device_type="cpu")
    ref = ref_leaves(ref_mesh((2, 4), ("dp", "tp")), loads)
    for r in range(8):
        tmpl = {lf["key"]: distribute_tensor(torch.zeros_like(child.ckpt_value(lf)), m8,
                                             [child.dec(e, pl) for e in lf["placements"]], rank=r)
                for lf in loads}
        out = tck.load(str(tmp_path), {"m": tmpl})["m"]
        for lf in loads:
            assert bits(out[lf["key"]].to_local()) == bits(ref[lf["key"]].to_local(rank=r)), (lf["key"], r)
        assert tck.LAST_LOAD_STATS["elastic"] == 1
    m1 = DeviceMesh(("x",), (1,), device_type="cpu")
    whole = {lf["key"]: distribute_tensor(torch.zeros_like(child.ckpt_value(lf)), m1, [pl.Replicate()],
                                          rank=0) for lf in SAVED_24}
    out = tck.load(str(tmp_path), {"m": whole})["m"]
    for lf in SAVED_24:
        assert bits(out[lf["key"]].to_local()) == bits(ref_value(lf)), lf["key"]


def test_failed_write_on_one_rank_fails_the_save_everywhere(world, tmp_path):
    """An injected write failure on rank 2 (no retry): every rank's save
    raises after the vote, and no commit marker lands."""
    leaves = [leaf("w", (8, 8), [S(0)])]
    res = world.run("ckpt_save", root=str(tmp_path), mesh_shape=[4], names=["dp"], leaves=leaves,
                    fail="storage_write:call=0,rank=2")
    assert "injected storage write failure" in res[2]["raised"]
    for r in (0, 1, 3):
        assert "a process reported a write failure" in res[r]["raised"]
    assert not (tmp_path / "meta.json").exists()


def test_failure_before_the_writes_fails_the_save_everywhere(world, tmp_path):
    """Rank 1 cannot serialize its chunk (before any write is queued): it
    still votes, so every rank raises instead of waiting, and nothing is
    committed."""
    leaves = [leaf("w", (8, 8), [S(0)])]
    res = world.run("ckpt_save", root=str(tmp_path), mesh_shape=[4], names=["dp"], leaves=leaves,
                    submit_fails_on=1)
    assert "cannot serialize" in res[1]["raised"]
    for r in (0, 2, 3):
        assert "a process reported a write failure" in res[r]["raised"]
    assert not (tmp_path / "meta.json").exists()


def test_async_save_on_four_ranks_commits_in_wait(world, tmp_path):
    leaves = [leaf("w", (8, 8), [S(0), S(1)]), leaf("i", (5,), [R(), R()], dtype="int32")]
    assert world.run("ckpt_save", root=str(tmp_path), mesh_shape=[2, 2], names=["dp", "tp"],
                     leaves=leaves, async_save=True) == [{"ok": True}] * 4
    res = world.run("ckpt_load", root=str(tmp_path), mesh_shape=[2, 2], names=["dp", "tp"],
                    leaves=leaves)
    check_pieces(res, leaves, (2, 2), ("dp", "tp"))


def test_checkpoint_manager_on_four_ranks(world, tmp_path):
    """Rotation, the agreed newest step and its restore, every rank alike."""
    leaves = [leaf("w", (8, 4), [S(0)])]
    res = world.run("ckpt_manager", root=str(tmp_path), mesh_shape=[4], names=["dp"], leaves=leaves,
                    steps=[1, 2, 3], keep=2)
    x = make_input((8, 4), 0)
    for got in res:
        assert got["common"] == 3
        assert got["dirs"] == ["step_0000000002", "step_0000000003"]
        assert bits(got["full"]["w"]) == bits(x + 3.0)


def test_save_of_a_mesh_larger_than_the_world_raises(tmp_path):
    """One process holds one rank's piece of a layout-only mesh of 4: the
    other pieces are not here, so the save raises and writes nothing."""
    m4 = DeviceMesh(("dp",), (4,), device_type="cpu")
    d = distribute_tensor(torch.arange(8.0), m4, [pl.Shard(0)], rank=1)
    with pytest.raises(ValueError, match="mesh has 4 ranks"):
        tck.save(str(tmp_path / "c"), {"m": {"x": d}})
    assert not (tmp_path / "c" / "meta.json").exists() and not (tmp_path / "c" / "data").exists()


# ------------------------------------------------------ one process
def _m1():
    return DeviceMesh(("tp",), (1,), device_type="cpu")


def _d(x, placements=None):
    return distribute_tensor(torch.as_tensor(x), _m1(), placements or [pl.Shard(0)], rank=0)


def test_memory_storage_async():
    x = torch.arange(32, dtype=torch.float32)
    h = tck.save("mem://fast_port", {"s": {"x": _d(x), "t": x}}, async_checkpoint=True)
    h.wait()
    out = tck.load("mem://fast_port", {"s": {"x": _d(torch.zeros(32)), "t": torch.empty(32)}})
    assert torch.equal(out["s"]["x"].to_local(), x) and torch.equal(out["s"]["t"], x)


def test_model_and_optimizer_round_trip_continues_training(tmp_path):
    """Train a tiny Llama one step, save params and AdamWLowmem moments,
    restore into a fresh model and optimizer: the next steps give the same
    losses bit for bit (the reference's flagship round trip, on one
    device)."""
    from vescale_tpu_torch.models import Llama, LlamaConfig, cross_entropy_loss, init_params, module_tree
    from vescale_tpu_torch.parallel import AdamWLowmem
    from vescale_tpu_torch.train import make_train_step

    cfg = LlamaConfig(vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                      num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=64,
                      dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (2, 17))).long()
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}

    def make(seed):
        model = Llama(cfg, init_params(cfg, seed=seed, device="cpu"), device="cpu")
        opt = AdamWLowmem(model.parameters(), 1e-2)
        return model, opt, make_train_step(model, opt, lambda lg, b: cross_entropy_loss(lg, b["target"]))

    def state(model, opt):
        names = {id(p): n for n, p in model.named_parameters()}
        return {"model": module_tree(model),
                "optimizer": {"step": opt.param_groups[0]["step"],
                              "moments": {names[id(p)]: dict(opt.state[p]) for p in opt.state}}}

    model_a, opt_a, step_a = make(0)
    step_a(batch)
    tck.save(str(tmp_path / "c"), state(model_a, opt_a))
    model_b, opt_b, step_b = make(1)
    step_b(batch)  # the same tree structure, other values
    loaded = tck.load(str(tmp_path / "c"), state(model_b, opt_b))
    with torch.no_grad():
        params = dict(model_b.named_parameters())
        flat = tck.planner.flatten_state(loaded["model"])
        for key, t in flat:
            params[key.replace("/", ".")].copy_(t)
        opt_b.param_groups[0]["step"] = loaded["optimizer"]["step"]
        for name, p in params.items():
            opt_b.state[p].update(loaded["optimizer"]["moments"][name])
    assert [float(step_a(batch)) for _ in range(2)] == [float(step_b(batch)) for _ in range(2)]


def test_load_missing_key_errors(tmp_path):
    tck.save(str(tmp_path / "c"), {"m": {"a": _d(torch.ones(4))}})
    with pytest.raises(KeyError):
        tck.load(str(tmp_path / "c"), {"m": {"zzz": _d(torch.ones(4))}})


def test_wrong_shape_template_rejected(tmp_path):
    tck.save(str(tmp_path / "c"), {"m": {"x": _d(torch.arange(16.0))}})
    with pytest.raises(ValueError):
        tck.load(str(tmp_path / "c"), {"m": {"x": _d(torch.zeros(8))}})


def test_load_strict_false_keeps_template_for_new_keys(tmp_path):
    x = torch.arange(8, dtype=torch.float32)
    tck.save(str(tmp_path / "old"), {"opt": {"scale": _d(x)}})
    tmpl = {"opt": {"scale": _d(torch.zeros(8)), "skip_count": np.asarray(7, np.int32)}}
    with pytest.raises(KeyError):
        tck.load(str(tmp_path / "old"), tmpl)
    out = tck.load(str(tmp_path / "old"), tmpl, strict=False)
    assert torch.equal(out["opt"]["scale"].to_local(), x) and int(out["opt"]["skip_count"]) == 7


def test_meta_template_lands_on_the_given_device_and_the_card_by_default(tmp_path, monkeypatch):
    x = torch.arange(6, dtype=torch.float32)
    tck.save(str(tmp_path / "c"), {"m": {"x": x}})
    out = tck.load(str(tmp_path / "c"), {"m": {"x": torch.empty(6, device="meta")}}, device="cpu")
    assert out["m"]["x"].device.type == "cpu" and torch.equal(out["m"]["x"], x)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tck.load(str(tmp_path / "c"), {"m": {"x": torch.empty(6, device="meta")}})


def test_mem_server_storage_roundtrip():
    from vescale_tpu_torch.checkpoint.mem_server import RemoteMemoryStorage, start_server

    srv = start_server("tt_inproc")
    try:
        st_ = RemoteMemoryStorage("tt_inproc", "a")
        st_.write_bytes("x/y.npy", b"hello")
        assert st_.exists("x/y.npy") and not st_.exists("zz")
        assert st_.read_bytes("x/y.npy") == b"hello" and st_.list() == ["x/y.npy"]
        st2 = RemoteMemoryStorage("tt_inproc", "b")
        assert st2.list() == []
        x = torch.arange(64, dtype=torch.float32)
        tck.save("memsvr://tt_inproc/run1", {"m": {"x": _d(x)}})
        out = tck.load("memsvr://tt_inproc/run1", {"m": {"x": _d(torch.zeros(64))}})
        assert torch.equal(out["m"]["x"].to_local(), x)
        st_.close()
        st2.close()
    finally:
        srv.stop()


def test_mem_server_detached_survives_writer():
    """The detached server (``python -m vescale_tpu_torch.checkpoint.mem_server``)
    outlives the writer: a separate process reads the checkpoint from it."""
    from vescale_tpu_torch.checkpoint.mem_server import shutdown_server, start_detached

    name = f"tt_detached_{os.getpid()}"
    try:
        assert start_detached(name, timeout=60.0) > 0
        x = torch.arange(32, dtype=torch.float32)
        tck.save(f"memsvr://{name}/runA", {"m": {"x": _d(x)}})
        code = ("import json, sys\n"
                "from vescale_tpu_torch.checkpoint.mem_server import RemoteMemoryStorage\n"
                f"st = RemoteMemoryStorage({name!r}, 'runA')\n"
                "meta = json.loads(st.read_bytes('meta.json'))\n"
                "assert 'm/x' in meta['arrays'], meta\n"
                "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'vescale_tpu')]\n"
                "print('CHILD OK')\n")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
        env["PYTHONPATH"] = REPO
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=120, cwd=REPO, env=env)
        assert out.returncode == 0 and "CHILD OK" in out.stdout, out.stderr[-2000:]
        m1 = _m1()
        got = tck.load(f"memsvr://{name}/runA",
                       {"m": {"x": distribute_tensor(torch.zeros(32), m1, [pl.Replicate()], rank=0)}})
        assert torch.equal(got["m"]["x"].to_local(), x)
    finally:
        shutdown_server(name)


def test_checkpoint_manager_rotate_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpts"), keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore({"m": {}})
    x = torch.arange(16, dtype=torch.float32)
    for step in (10, 20):
        mgr.save(step, {"m": {"x": _d(x + step)}})
    mgr.save(30, {"m": {"x": _d(x + 30)}}, async_checkpoint=True).wait()
    assert mgr.latest_step() == 30
    assert not os.path.exists(mgr.step_path(10)) and os.path.exists(mgr.step_path(20))
    os.makedirs(mgr.step_path(40) + "/data", exist_ok=True)  # torn: no meta.json
    assert mgr.latest_step() == 30
    tmpl = {"m": {"x": _d(torch.zeros(16), [pl.Replicate()])}}
    assert torch.equal(mgr.restore(tmpl)["m"]["x"].to_local(), x + 30)
    assert torch.equal(mgr.restore(tmpl, step=20)["m"]["x"].to_local(), x + 20)
    with pytest.raises(ValueError):
        CheckpointManager("mem://nope")


def _until(cond, timeout_s=30.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline and not cond():
        time.sleep(0.05)
    return cond()


def test_checkpoint_manager_fire_and_forget_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ff"), keep=1)
    x = torch.arange(8, dtype=torch.float32)
    for step in (1, 2, 3):
        mgr.save(step, {"m": {"x": _d(x + step)}}, async_checkpoint=True)  # handle dropped
    assert _until(lambda: mgr.latest_step() == 3 and not os.path.exists(mgr.step_path(1))
                  and not os.path.exists(mgr.step_path(2)))


def test_checkpoint_manager_rollback_prunes_stale_futures(tmp_path):
    x = torch.arange(8, dtype=torch.float32)
    mgr0 = CheckpointManager(str(tmp_path / "ck"), keep=2)
    for step in (20, 30, 40):
        mgr0.save(step, {"m": {"x": _d(x + step)}})
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)  # a restart resuming from 20
    mgr.save(25, {"m": {"x": _d(x + 25)}})
    assert mgr.latest_step() == 25
    assert not os.path.exists(mgr.step_path(30)) and not os.path.exists(mgr.step_path(40))
    assert torch.equal(mgr.restore({"m": {"x": _d(torch.zeros(8))}})["m"]["x"].to_local(), x + 25)


def test_checkpoint_manager_same_step_resave_drains_pending(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ss"), keep=3)
    x = torch.arange(8, dtype=torch.float32)
    mgr.save(5, {"m": {"x": _d(x + 1)}}, async_checkpoint=True)
    h2 = mgr.save(5, {"m": {"x": _d(x + 2)}}, async_checkpoint=True)
    if h2 is not None:
        h2.wait()
    assert _until(lambda: mgr.latest_step() == 5)
    out = mgr.restore({"m": {"x": _d(torch.zeros(8))}}, step=5)
    assert torch.equal(out["m"]["x"].to_local(), x + 2)


def test_checkpoint_manager_reascend_after_rollback(tmp_path):
    root = str(tmp_path / "ra")
    x = torch.arange(8, dtype=torch.float32)
    CheckpointManager(root, keep=3).save(200, {"m": {"x": _d(x)}})
    mgr = CheckpointManager(root, keep=3)
    assert mgr.save(100, {"m": {"x": _d(x + 1)}}, async_checkpoint=True) is None  # rollback: sync
    assert not os.path.exists(mgr.step_path(200))
    h2 = mgr.save(101, {"m": {"x": _d(x + 2)}}, async_checkpoint=True)
    assert h2 is not None
    h2.wait()
    assert _until(lambda: mgr.latest_step() == 101)
    assert os.path.exists(mgr.step_path(100)) and not os.path.exists(mgr.step_path(200))


def test_async_save_failure_surfaces(tmp_path, monkeypatch):
    orig = FileSystemStorage.write_bytes

    def failing(self, name, data):
        if name.startswith("data/"):
            raise IOError("disk full (injected)")
        return orig(self, name, data)

    monkeypatch.setattr(FileSystemStorage, "write_bytes", failing)
    monkeypatch.setenv("VESCALE_NATIVE_CKPT_IO", "0")
    h = tck.save(str(tmp_path / "fail"), {"m": {"x": _d(torch.arange(16.0))}}, async_checkpoint=True)
    assert _until(lambda: h.failed, 20.0)
    with pytest.raises(IOError):
        h.wait()
    assert not (tmp_path / "fail" / "meta.json").exists()


def test_storage_write_fault_is_retried_then_lands(tmp_path, monkeypatch):
    """faultsim ``storage_write`` fails the first write; the retry policy
    absorbs it and the checkpoint commits."""
    from vescale_tpu_torch.resilience.retry import reset_default_policies

    monkeypatch.setenv("VESCALE_NATIVE_CKPT_IO", "0")
    monkeypatch.setenv("VESCALE_IO_BACKOFF_BASE", "0")
    reset_default_policies()
    try:
        tfs.arm(tfs.parse_schedule("storage_write:call=0"))
        x = torch.arange(4.0)
        tck.save(str(tmp_path / "c"), {"m": {"x": x}})
        assert tfs.get_injector().fired_total["storage_write"] == 1
    finally:
        tfs.disarm()
        reset_default_policies()
    assert torch.equal(tck.load(str(tmp_path / "c"), {"m": {"x": torch.empty(4)}})["m"]["x"], x)


def test_drain_mid_flight_save_cannot_commit(tmp_path, monkeypatch):
    release = threading.Event()
    orig = FileSystemStorage.write_bytes

    def blocking(self, name, data):
        if name.startswith("data/"):
            assert release.wait(timeout=30)
        return orig(self, name, data)

    monkeypatch.setattr(FileSystemStorage, "write_bytes", blocking)
    monkeypatch.setenv("VESCALE_NATIVE_CKPT_IO", "0")
    committed = []
    d = _d(torch.arange(16.0))
    h = tck.save(str(tmp_path / "doomed"), {"m": {"x": d}}, async_checkpoint=True,
                 on_commit=lambda: committed.append(1))
    drained = threading.Thread(target=h.drain)
    drained.start()
    time.sleep(0.2)
    release.set()
    drained.join(timeout=30)
    assert not drained.is_alive()
    time.sleep(0.5)
    assert not (tmp_path / "doomed" / "meta.json").exists() and not committed
    h2 = tck.save(str(tmp_path / "doomed"), {"m": {"x": d}}, async_checkpoint=True,
                  on_commit=lambda: committed.append(2))
    h2.wait()
    assert _until(lambda: committed == [2], 20.0)
    assert (tmp_path / "doomed" / "meta.json").exists()


def test_native_ckpt_writer(tmp_path, monkeypatch):
    """The C++ writer builds into ``checkpoint/build/``, writes atomically,
    counts what it wrote, and writes the same bytes as the Python pool."""
    so = native_io.build_native()
    assert os.path.exists(so) and os.sep + os.path.join("checkpoint", "build") + os.sep in so
    pool = native_io.NativeWritePool.get()
    assert pool is not None
    p = str(tmp_path / "direct" / "deep" / "chunk.bin")
    pool.submit(p, b"abc123" * 100)
    pool.drain()
    pool.close()
    assert open(p, "rb").read() == b"abc123" * 100 and not os.path.exists(p + ".tmp")
    x = torch.arange(256, dtype=torch.float32)
    native_io.reset_writes()
    tck.save(str(tmp_path / "nat"), {"m": {"x": _d(x)}})
    assert native_io.WRITES["files"] == 1
    monkeypatch.setenv("VESCALE_NATIVE_CKPT_IO", "0")
    tck.save(str(tmp_path / "py"), {"m": {"x": _d(x)}})
    assert native_io.WRITES["files"] == 1  # the Python pool wrote this one
    a = open(tmp_path / "nat" / "data" / "m" / "x" / "0.npy", "rb").read()
    assert a == open(tmp_path / "py" / "data" / "m" / "x" / "0.npy", "rb").read()
    out = tck.load(str(tmp_path / "nat"), {"m": {"x": _d(torch.zeros(256))}})
    assert torch.equal(out["m"]["x"].to_local(), x)


def test_plan_cache_reused(tmp_path):
    d = _d(torch.arange(16.0))
    before = len(tck._PLANNER._cache)
    tck.save(str(tmp_path / "c8"), {"m": {"x": d}})
    after_first = len(tck._PLANNER._cache)
    tck.save(str(tmp_path / "c8b"), {"m": {"x": d}})
    assert after_first == len(tck._PLANNER._cache) >= before


def test_tree_keys_are_the_reference_key_paths(tmp_path):
    """Nested dicts, lists, tuples, namedtuples and None: the port's keys
    and leaf order are ``jax.tree_util``'s, and the loaded tree keeps the
    template's structure."""
    import collections

    NT = collections.namedtuple("NT", "mu nu")
    tree = {"b": [np.float32(1.0), (np.arange(2.0), None)], "a": NT(np.ones(3), {"z": 2, "y": 3})}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    from vescale_tpu.checkpoint.planner import key_of_path

    assert [k for k, _ in tck.planner.flatten_state(tree)] == [key_of_path(kp) for kp, _ in flat]
    tck.save(str(tmp_path / "c"), {"t": tree})
    jck.save(str(tmp_path / "r"), {"t": tree})
    same_files(str(tmp_path / "r"), str(tmp_path / "c"))
    out = tck.load(str(tmp_path / "c"), {"t": tree})["t"]
    assert isinstance(out["a"], NT) and out["b"][1][1] is None and out["a"].nu["z"] == 2


# ------------------------------------------------------------ elastic
def _ref_sharded(mesh, vals):
    return {"w": jax.device_put(vals, NamedSharding(mesh.jax_mesh, P("dp", None)))}


def test_writer_meta_is_the_port_world(tmp_path):
    """The port records its own world (ROADMAP §C): processes = the
    ``torch.distributed`` world, devices = the same, and the meshes."""
    tck.save(str(tmp_path / "c"), {"model": {"w": _d(torch.zeros(8, 4))}})
    meta = json.load(open(tmp_path / "c" / "meta.json"))
    assert meta["writer"] == {"process_count": 1, "device_count": 1, "meshes": ["tp=1"]}
    assert tck.read_writer_meta(str(tmp_path / "c")) == meta["writer"]
    mgr = CheckpointManager(str(tmp_path / "m"), keep=2)
    mgr.save(0, {"model": {"w": _d(torch.zeros(8, 4))}})
    assert mgr.writer_meta(0)["meshes"] == ["tp=1"] and mgr.writer_meta(99) is None


def test_cross_mesh_load_counts_elastic(tmp_path):
    """A reference checkpoint from dp=4 loaded as pieces of dp=8: elastic;
    the port's own one-rank checkpoint back on its mesh: not."""
    vals = np.arange(32, dtype=np.float32).reshape(8, 4)
    jck.save(str(tmp_path / "c"), {"model": _ref_sharded(ref_mesh((4,), ("dp",)), vals)})
    m8 = DeviceMesh(("dp",), (8,), device_type="cpu")
    for r in range(8):
        out = tck.load(str(tmp_path / "c"), {"model": {"w": distribute_tensor(
            torch.zeros(8, 4), m8, [pl.Shard(0)], rank=r)}})
        assert tck.LAST_LOAD_STATS["elastic"] == 1
        assert np.array_equal(out["model"]["w"].to_local().numpy(), vals[r:r + 1])
    tck.save(str(tmp_path / "p"), {"model": {"w": _d(torch.from_numpy(vals))}})
    tck.load(str(tmp_path / "p"), {"model": {"w": _d(torch.zeros(8, 4))}})
    assert tck.LAST_LOAD_STATS["elastic"] == 0


def test_shape_mismatch_is_coded_and_preread(tmp_path, monkeypatch):
    tck.save(str(tmp_path / "c"), {"model": {"w": _d(torch.zeros(8, 4))}})
    reads = []
    orig = FileSystemStorage.read_bytes

    def counting(self, name):
        reads.append(name)
        return orig(self, name)

    monkeypatch.setattr(FileSystemStorage, "read_bytes", counting)
    with pytest.raises(ElasticMismatchError) as ei:
        tck.load(str(tmp_path / "c"), {"model": {"w": _d(torch.zeros(16, 2))}})
    assert "VSC131" in str(ei.value) and "model/w" in str(ei.value)
    assert ei.value.report.by_code("VSC131") and isinstance(ei.value, ValueError)
    assert reads == ["meta.json"]


def test_elastic_restore_opt_out(tmp_path, monkeypatch):
    vals = np.zeros((8, 4), np.float32)
    jck.save(str(tmp_path / "c"), {"model": _ref_sharded(ref_mesh((4,), ("dp",)), vals)})
    m8 = DeviceMesh(("dp",), (8,), device_type="cpu")
    monkeypatch.setenv("VESCALE_ELASTIC_RESTORE", "0")
    with pytest.raises(ElasticMismatchError, match="VSC132"):
        tck.load(str(tmp_path / "c"), {"model": {"w": distribute_tensor(torch.zeros(8, 4), m8,
                                                                      [pl.Shard(0)], rank=0)}})
    tck.save(str(tmp_path / "p"), {"model": {"w": _d(torch.zeros(8, 4))}})
    tck.load(str(tmp_path / "p"), {"model": {"w": _d(torch.zeros(8, 4))}})  # same world: fine


def test_preflight_reports_vsc130(tmp_path):
    jck.save(str(tmp_path / "c"), {"model": _ref_sharded(ref_mesh((4,), ("dp",)),
                                                         np.zeros((8, 4), np.float32))})
    meta = json.load(open(tmp_path / "c" / "meta.json"))
    m2 = DeviceMesh(("dp",), (2,), device_type="cpu")
    report, elastic = tel.preflight(meta, {"model": {"w": distribute_tensor(
        torch.zeros(8, 4), m2, [pl.Shard(0)], rank=0)}}, "c")
    assert elastic and report.codes() == ["VSC130"]


def test_vsc13x_codes_equal_the_references():
    from vescale_tpu.analysis import findings as jf
    from vescale_tpu_torch.analysis import findings as tf

    assert tf.CODES["VSC130"].severity == tf.Severity.INFO
    for c in ("VSC131", "VSC132", "VSC133"):
        assert tf.CODES[c].severity == tf.Severity.ERROR
    # every code and severity is the reference's, every title but VSC206's,
    # whose rule is the port's own (kernels reached only through
    # vescale_tpu_torch/kernels/, where the reference polices pallas_call)
    assert {k: int(v.severity) for k, v in tf.CODES.items()} == \
        {k: int(v.severity) for k, v in jf.CODES.items()}
    assert {k: v.title for k, v in tf.CODES.items() if k != "VSC206"} == \
        {k: v.title for k, v in jf.CODES.items() if k != "VSC206"}
    assert "vescale_tpu_torch/kernels" in tf.CODES["VSC206"].title


def test_ragged_rebucket_coprime_worlds(tmp_path):
    """Flat buffers saved by the reference under a 3-rank bucketing,
    restored as the pieces of a 2-rank re-balanced bucketing."""
    x = np.arange(24, dtype=np.float32)
    jck.save(str(tmp_path / "rg"), {"m": {"buf": vt.distribute_tensor(
        x, ref_mesh((3,), ("dp",)), [RS((0,), (10, 6, 8))])}})
    m2 = DeviceMesh(("dp",), (2,), device_type="cpu")
    got = []
    for r in range(2):
        tmpl = distribute_tensor(torch.zeros(24), m2, [pl.RaggedShard((0,), (12, 12))], rank=r)
        got.append(tck.load(str(tmp_path / "rg"), {"m": {"buf": tmpl}})["m"]["buf"].to_local())
        assert tck.LAST_LOAD_STATS["elastic"] == 1
    assert np.array_equal(torch.cat(got).numpy(), x)


def test_host_template_load_is_not_elastic(tmp_path, monkeypatch):
    vals = np.arange(32, dtype=np.float32).reshape(8, 4)
    jck.save(str(tmp_path / "c"), {"model": _ref_sharded(ref_mesh((4,), ("dp",)), vals)})
    monkeypatch.setenv("VESCALE_ELASTIC_RESTORE", "0")
    out = tck.load(str(tmp_path / "c"), {"model": {"w": np.zeros((8, 4), np.float32)}})
    assert tck.LAST_LOAD_STATS["elastic"] == 0 and np.array_equal(out["model"]["w"], vals)


def test_latest_common_step_joining_rank_abstains():
    rows = np.array([[-1, -1, -1], [2, 5, 8], [-1, 5, 8]])
    assert CheckpointManager._common_from_rows(rows) == 8
    assert CheckpointManager._common_from_rows(np.array([[-1], [-1]])) is None
    assert CheckpointManager._common_from_rows(np.array([[2, 5], [3, 5]])) == 5
    assert CheckpointManager._common_from_rows(np.array([[2], [3]])) is None


# ------------------------------------------------- bf16 without ml_dtypes
def test_bf16_load_with_ml_dtypes_blocked(tmp_path):
    """A bf16 checkpoint the reference wrote loads in a process where
    ``ml_dtypes`` cannot be imported (the card's machine has none): the
    port maps the manifest dtype itself."""
    xb = jnp.asarray(make_input((5, 7), 9)).astype(jnp.bfloat16)
    jck.save(str(tmp_path / "c"), {"m": {"w": xb}})
    want = np.asarray(xb).view(np.int16).tobytes().hex()
    code = ("import sys\n"
            "sys.modules['ml_dtypes'] = None\n"
            "import torch\n"
            "from vescale_tpu_torch import checkpoint\n"
            f"out = checkpoint.load({str(tmp_path / 'c')!r}, "
            "{'m': {'w': torch.empty(5, 7, dtype=torch.bfloat16)}})['m']['w']\n"
            f"assert out.dtype == torch.bfloat16 and out.view(torch.int16).numpy().tobytes().hex() == {want!r}\n"
            "assert 'ml_dtypes' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
            "print('BF16 OK')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=REPO, env=env)
    assert out.returncode == 0 and "BF16 OK" in out.stdout, out.stderr[-3000:]
