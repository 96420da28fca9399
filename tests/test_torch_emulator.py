"""The port's collective emulator (``vescale_tpu_torch.emulator``) against
the JAX reference ``vescale_tpu.emulator`` on the same numpy inputs.

Held:

  * every ``Emulator`` algorithm and ``EmulatorProcessGroup`` call
    (ring, tree, int8) bitwise the reference's, dtypes and shapes too;
  * the mesh collectives over a layout-only port mesh bitwise the
    reference's over conftest's (2, 4) mesh, on each mesh dim;
  * the quantized replays (nearest and stochastic, sum and avg, and the
    per-bucket report) bitwise the reference's replays: both call their
    own package's quantizer, and the two quantizers agree bit for bit
    (tests/test_torch_dp.py);
  * on gloo worlds of 2 and 4 (``tests/torch_spmd_child.py``): the
    replay bitwise the port's ``all_reduce_q`` / ``reduce_scatter_q`` on
    every rank, and ``verify_all_reduce_against_backend`` (the replay
    against gloo's own all-reduce: exact on integer-valued sums);
  * the tuning functions equal to the reference's under explicit link
    parameters (the reference's ICI defaults passed by hand: the port
    has none).
"""

import numpy as np
import pytest

from vescale_tpu import emulator as RE
from vescale_tpu.collectives import _ICI_GBPS, _LAUNCH_US
from vescale_tpu.emulator import mesh_collectives as RM
from vescale_tpu.emulator import tuning as RT

from vescale_tpu_torch import emulator as PE
from vescale_tpu_torch.emulator import mesh_collectives as PM
from vescale_tpu_torch.mesh import DeviceMesh

import torch_spmd_child as child
from torch_reset import reset_all


@pytest.fixture(autouse=True)
def managers_reset():
    reset_all()
    yield
    reset_all()


@pytest.fixture(scope="module")
def worlds():
    made = {n: child.World(n) for n in (2, 4)}
    yield made
    for w in made.values():
        w.close()


def _locals(n, shape, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * (1 + r)).astype(dtype) for r in range(n)]


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
def test_emulator_algorithms_are_the_references(n, op):
    xs = _locals(n, (13,), seed=n)
    pe, re_ = PE.Emulator(n), RE.Emulator(n)
    _same(pe.ring_reduce_scatter(xs, op), re_.ring_reduce_scatter(xs, op))
    _same(pe.ring_all_reduce(xs, op), re_.ring_all_reduce(xs, op))
    _same(pe.tree_all_reduce(xs, op), re_.tree_all_reduce(xs, op))
    _same(pe.reduce_scatter(xs, op), re_.reduce_scatter(xs, op))
    shards = [x[: 3 + r] for r, x in enumerate(xs)]
    _same(pe.ring_all_gather(shards), re_.ring_all_gather(shards))
    _same(pe.all_gather(xs), re_.all_gather(xs))
    _same(pe.all_to_all(xs), re_.all_to_all(xs))
    _same(pe.broadcast(xs, src=n - 1), re_.broadcast(xs, src=n - 1))


@pytest.mark.parametrize("algo", ["ring", "tree"])
def test_process_group_is_the_references(algo):
    xs = _locals(4, (8, 10), seed=5)
    pg, rg = PE.init_process_group(4, algo), RE.init_process_group(4, algo)
    _same(pg.all_reduce(xs), rg.all_reduce(xs))
    _same(pg.reduce_scatter(xs), rg.reduce_scatter(xs))
    _same(pg.all_gather(xs), rg.all_gather(xs))
    _same(pg.all_to_all(xs), rg.all_to_all(xs))
    _same(pg.broadcast(xs, 2), rg.broadcast(xs, 2))
    q = PE.EmulatorProcessGroup(4, quantized="int8", block=32)
    rq = RE.EmulatorProcessGroup(4, quantized="int8", block=32)
    _same(q.all_reduce(xs), rq.all_reduce(xs))
    _same(q.reduce_scatter(xs, "avg"), rq.reduce_scatter(xs, "avg"))


def test_auto_algorithm_needs_a_link():
    with pytest.raises(ValueError, match="LinkParams"):
        PE.EmulatorProcessGroup(8, "auto")
    ici = PE.LinkParams(bandwidth_gbps=_ICI_GBPS, latency_us=_LAUNCH_US)
    for nbytes in (64, 1 << 12, 1 << 26):
        xs = _locals(8, (nbytes // 32 // 4 or 1,), seed=1)
        pg = PE.EmulatorProcessGroup(8, "auto", params=ici)
        _same(pg.all_reduce(xs), RE.EmulatorProcessGroup(8, "auto").all_reduce(xs))


@pytest.mark.parametrize("mesh_dim", ["dp", "tp"])
def test_mesh_collectives_are_the_references(mesh2d, mesh_dim):
    pmesh = DeviceMesh(("dp", "tp"), (2, 4), device_type="cpu")
    xs = _locals(8, (12,), seed=7)
    for algo in ("ring", "tree"):
        _same(PM.emulate_mesh_all_reduce(xs, pmesh, mesh_dim, algo=algo),
              RM.emulate_mesh_all_reduce(xs, mesh2d, mesh_dim, algo=algo))
    _same(PM.emulate_mesh_all_gather(xs, pmesh, mesh_dim),
          RM.emulate_mesh_all_gather(xs, mesh2d, mesh_dim))
    _same(PM.emulate_mesh_reduce_scatter(xs, pmesh, mesh_dim),
          RM.emulate_mesh_reduce_scatter(xs, mesh2d, mesh_dim))


@pytest.mark.parametrize("rounding,seed", [("nearest", None), ("stochastic", 3)])
@pytest.mark.parametrize("n", [2, 4])
def test_quantized_replays_are_the_references(rounding, seed, n):
    xs = _locals(n, (8, 50), seed=n)
    for op in ("sum", "avg"):
        _same(PE.quantized_all_reduce(xs, 64, rounding, seed, op),
              RE.quantized_all_reduce(xs, 64, rounding, seed, op))
        _same(PE.quantized_reduce_scatter(xs, 64, rounding, seed, op),
              RE.quantized_reduce_scatter(xs, 64, rounding, seed, op))
    got, want = (mod.quantized_ring_report(xs, 64, rounding, seed) for mod in (PE, RE))
    assert got == want


@pytest.mark.parametrize("rounding,key_seed", [("nearest", None), ("stochastic", 5)])
@pytest.mark.parametrize("n", [2, 4])
def test_replay_is_the_ports_quantized_collectives(worlds, n, rounding, key_seed):
    shape = (8, 100)
    ranks = worlds[n].run("emu_qcoll", shape=list(shape), seed=3, rounding=rounding,
                          key_seed=key_seed)
    xs = [child.make_input(shape, 3, rank=r) for r in range(n)]
    for op in ("sum", "avg"):
        ar = PE.quantized_all_reduce(xs, 64, rounding, key_seed, op)
        rs = PE.quantized_reduce_scatter(xs, 64, rounding, key_seed, op)
        for r, got in enumerate(ranks):
            np.testing.assert_array_equal(got[f"ar_{op}"], ar[r])
            np.testing.assert_array_equal(got[f"rs_{op}"], rs[r])


@pytest.mark.parametrize("n", [2, 4])
def test_verify_against_the_backend(worlds, n):
    ranks = worlds[n].run("emu_verify", shape=[33], seed=4)
    for got in ranks:
        bitwise, diff = got["int"]
        assert bitwise and diff == 0.0  # integer-valued sums are exact in any order
        bitwise, diff = got["normal"]
        assert diff < 1e-5  # the reference's bound on reduction-order divergence


def test_tuning_is_the_references_under_explicit_parameters():
    for bw, lat in ((_ICI_GBPS, _LAUNCH_US), (450.0, 3.0), (25.0, 12.5)):
        pp = PE.LinkParams(bandwidth_gbps=bw, latency_us=lat)
        rp = RT.IciParams(bandwidth_gbps=bw, latency_us=lat)
        for nbytes in (0, 1024, 1 << 20, 10_000_000, 1 << 30):
            for world in (1, 2, 3, 8, 64):
                assert PE.choose_algorithm(nbytes, world, pp) == RT.choose_algorithm(
                    nbytes, world, rp)
                for algo in ("ring", "tree"):
                    assert PE.estimate_time_us(nbytes, world, algo, pp) == RT.estimate_time_us(
                        nbytes, world, algo, rp)
                assert PE.calculate_chunk_size(nbytes, world, pp) == RT.calculate_chunk_size(
                    nbytes, world, rp)
    with pytest.raises(TypeError):
        PE.LinkParams()  # no default link
    with pytest.raises(ValueError):
        PE.estimate_time_us(1, 2, "star", PE.LinkParams(1.0, 1.0))
    with pytest.raises(ValueError):
        PE.calculate_chunk_size(1, 0, PE.LinkParams(1.0, 1.0))
