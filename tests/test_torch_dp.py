"""The port's data parallelism (A11) against the JAX reference: the int8
block quantizer and the quantized collectives, DDP's gradient sync, ZeRO-2
(``DistributedOptimizer``) with loss scaling, the ragged FSDP buffer and
its train step, and the elastic restore of sharded optimizer state.

The ranks are gloo worlds of 2 and 4 (children of
``tests/torch_spmd_child.py``, spawned once for this module); the
reference runs in this process on conftest's virtual devices, on the same
numpy-seeded weights, batches and keys.  Held:

  * blockscale: codes, scales, packed bytes and dequantized values
    bitwise, non-finite blocks and stochastic rounding with one key
    included;
  * ``all_reduce_q``, ``reduce_scatter_q``, ``q_all_gather`` and
    ``q_all_to_all``: every rank's result bitwise the reference's slice,
    nearest and stochastic; the wire-byte reckoning equal;
  * DDP ``finish_grad_sync``: tests/test_optim.py:242's values, and every
    piece of a leaf Partial on both mesh dims (the kept tp Partial) and of
    a tp-sharded leaf exactly the reference's, exact and int8;
  * ZeRO-2 on the tiny GPT of tests/test_optim.py:25 on a (2, 2) ("dp",
    "tp") world, with a global-norm clip: every state piece the
    reference's ``state_pspecs`` shard (box and placements), three steps'
    losses and state within 5e-5 (tests/test_optim.py:84's tolerance);
    then both packages go on from the reference's state
    (``zero_state_from_jax``) for one more step;
  * the dynamic scale of tests/test_optim.py:91-175: the same scales and
    skip counts, and every rank bitwise unchanged when only one rank's
    gradient holds the inf;
  * FSDP: units, ``local_params`` and the packed pieces the reference's,
    three steps within tests/test_optim.py:296-302's 2e-4 (loss) and 2e-3
    (params);
  * a ZeRO-2 state and an FSDP buffer saved by a world of 2 restored on a
    world of 4 bit for bit, and a reference (2, 4) ZeRO state restored in
    the port and the port's in the reference.

The dp=2 x tp=2 ``make_train_step`` is held to the reference's in
``tests/test_torch_dmodule.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import vescale_tpu as vt
from vescale_tpu import checkpoint as ref_ckpt
from vescale_tpu import collectives as RC
from vescale_tpu.checkpoint.planner import flatten_state as ref_flatten_state
from vescale_tpu.dmodule import parallelize_module as ref_parallelize
from vescale_tpu.mesh import DeviceMesh as RefMesh
from vescale_tpu.models import nanogpt as ref_nanogpt
from vescale_tpu.models.nanogpt import cross_entropy_loss as ref_xent
from vescale_tpu.parallel import DistributedDataParallel as RefDDP
from vescale_tpu.parallel import DistributedOptimizer as RefDOpt
from vescale_tpu.parallel import FSDPParamBuffer as RefFSDP
from vescale_tpu.parallel.ddp import dp_grad_reduce as ref_dp_grad_reduce
from vescale_tpu.parallel.fsdp import make_fsdp_train_step as ref_fsdp_step
from vescale_tpu.parallel.optimizer import adamw_lowmem
from vescale_tpu.placements import Partial as RPartial, Replicate as RReplicate, Shard as RShard
from vescale_tpu.quant import blockscale as RB

from vescale_tpu_torch import random as PR
from vescale_tpu_torch.mesh import DeviceMesh
from vescale_tpu_torch.models.convert import fsdp_buffer_from_jax
from vescale_tpu_torch.parallel import FSDPParamBuffer, fsdp_plan
from vescale_tpu_torch.quant import blockscale as PB

import torch_spmd_child as child
from torch_spmd_child import enc

SEED = 0
STEPS = 3
ZERO_TOL = 5e-5       # tests/test_optim.py:84
ZERO_CLIP = 1.0       # a global-norm clip that binds: the first step's norm is 12.3
FSDP_LOSS_TOL = 2e-4  # tests/test_optim.py:296
FSDP_PARAM_TOL = 2e-3  # tests/test_optim.py:302
# GPT's key bias has a zero gradient in exact arithmetic (softmax ignores a
# constant added to every key), so AdamW moves it by about lr a step on
# rounding noise in either framework (tests/test_torch_dmodule.py)
NOISE_TOL = 2 * STEPS * child.DP_LR


def _key_bias_noise(key, shape, index):
    """The elements of a state piece at ``index`` (its slices in the
    global leaf) whose gradient is rounding noise: columns [E, 2E) of
    c_attn's fused bias."""
    if not key.endswith("c_attn/bias"):
        return np.zeros([len(range(*sl.indices(n))) for sl, n in zip(index, shape)], bool)
    E = child.TP_CONFIGS["gpt"]["n_embd"]
    cols = np.arange(shape[0])[index[0]]
    return (cols >= E) & (cols < 2 * E)


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


def _ref_mesh(names, shape):
    n = int(np.prod(shape))
    return RefMesh(tuple(names), tuple(shape), devices=jax.devices()[:n])


def _flat(tree, prefix="", sep="."):
    for k, v in tree.items():
        path = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _flat(v, path, sep)
        else:
            yield path, v


def _shards(arr, sharding, n):
    """Every device's slice of a global array under ``sharding``, in mesh
    order (rank r = device r)."""
    idx = sharding.devices_indices_map(tuple(arr.shape))
    host = np.asarray(arr)
    return [host[idx[d]] for d in jax.devices()[:n]]


# ------------------------------------------------------------ blockscale
def _bs_input(n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.exp(rng.standard_normal(n) * 3)).astype(np.float32)
    if n > 300:
        x[5], x[130], x[299] = np.nan, np.inf, -np.inf  # three poisoned blocks
        x[200:256] = 0.0                                # an all-zero block
    return x


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("n,block,rounding", [
    (1000, 64, "nearest"), (1000, 64, "stochastic"), (777, 32, "nearest"),
    (777, 128, "stochastic"), (64, 64, "nearest"), (5, 64, "stochastic")])
def test_blockscale_is_the_references_bitwise(n, block, rounding):
    x = _bs_input(n, seed=n + block)
    rk = jax.random.fold_in(jax.random.key(11), n) if rounding == "stochastic" else None
    pk = PR.fold_in(PR.key(11), n) if rounding == "stochastic" else None
    qr = RB.quantize_int8_blocks(jnp.asarray(x), block, rounding, rk)
    qp = PB.quantize_int8_blocks(torch.from_numpy(x), block, rounding, pk)
    np.testing.assert_array_equal(qp.q.numpy(), np.asarray(qr.q))
    np.testing.assert_array_equal(_bits(qp.scales.numpy()), _bits(qr.scales))
    pr, pp = np.asarray(RB.pack_int8_payload(qr)), PB.pack_int8_payload(qp).numpy()
    np.testing.assert_array_equal(pp, pr)
    assert pp.nbytes == PB.packed_nbytes(n, block) == RB.packed_nbytes(n, block)
    nb = qp.q.shape[0]
    dr = RB.dequantize_int8_blocks(RB.unpack_int8_payload(jnp.asarray(pr), nb, block), (n,),
                                   jnp.float32)
    dp = PB.dequantize_int8_blocks(PB.unpack_int8_payload(torch.from_numpy(pp), nb, block),
                                   (n,), torch.float32)
    np.testing.assert_array_equal(_bits(dp.numpy()), _bits(dr))
    # a block holding a non-finite element dequantizes non-finite as a whole
    pad = np.concatenate([x, np.zeros(nb * block - n, np.float32)]).reshape(nb, block)
    poisoned = np.repeat(~np.isfinite(pad).all(axis=1), block)[:n]
    assert poisoned.any() == (n > 300)
    np.testing.assert_array_equal(~np.isfinite(dp.numpy()), poisoned)


def test_blockscale_helpers_are_the_references():
    amax = np.array([0.0, 1e-30, 0.5, 127.0, 128.0, 3e38, np.inf, np.nan], np.float32)
    np.testing.assert_array_equal(
        _bits(PB.pow2_scale_from_amax(torch.from_numpy(amax)).numpy()),
        _bits(RB.pow2_scale_from_amax(jnp.asarray(amax))))
    # fp8's per-tensor scale: an IEEE division on both sides, bitwise (a
    # Python float over a tensor takes the reciprocal first, which put
    # 448 / 3e38 one ulp away until the port divided explicitly)
    np.testing.assert_array_equal(PB.scale_from_amax(torch.from_numpy(amax[:6]), 448.0).numpy(),
                                  np.asarray(RB.scale_from_amax(jnp.asarray(amax[:6]), 448.0)))
    x = _bs_input(1000, 3)
    np.testing.assert_array_equal(PB.block_amax(torch.from_numpy(x)).numpy(),
                                  np.asarray(RB.block_amax(jnp.asarray(x))))
    y = np.linspace(-300, 300, 101).astype(np.float32)
    np.testing.assert_array_equal(
        PB.quantize_clip(torch.from_numpy(y), 0.5, torch.int8, 127.0).numpy(),
        np.asarray(RB.quantize_clip(jnp.asarray(y), 0.5, jnp.int8, 127.0)))
    with pytest.raises(ValueError, match="non-finite"):
        PB.quantize_int8_blocks(torch.from_numpy(x), validate=True)
    with pytest.raises(ValueError, match="key"):
        PB.quantize_int8_blocks(torch.from_numpy(x), rounding="stochastic")


# -------------------------------------------------- quantized collectives
QCOLL = [(2, "nearest", None), (2, "stochastic", 5), (4, "nearest", None), (4, "stochastic", 9)]


@pytest.mark.parametrize("n,rounding,key_seed", QCOLL, ids=lambda v: str(v))
def test_quantized_collectives_are_the_references_bitwise(worlds, n, rounding, key_seed):
    shape = (2 * n, 70)
    got = worlds(n).run("dp_qcoll", mesh_shape=[n], names=["dp"], shape=list(shape), seed=7,
                        rounding=rounding, key_seed=key_seed)
    mesh = _ref_mesh(("dp",), (n,))
    stacked = jnp.asarray(np.stack([child.make_input(shape, 7, rank=r) for r in range(n)]))
    key = None if key_seed is None else jax.random.key(key_seed)
    kw = dict(block=64, rounding=rounding, key=key)

    def body(fn):
        return RC._smap(mesh, lambda x: fn(jnp.squeeze(x, 0))[None], P("dp"), P("dp"))

    @jax.jit  # one program for all six: eager shard_map is slow
    def reference(s):
        return {"ar_sum": RC.all_reduce_q(s, mesh, "sum", **kw),
                "ar_avg": RC.all_reduce_q(s, mesh, "avg", **kw),
                "rs_sum": RC.reduce_scatter_q(s, mesh, "sum", 0, **kw),
                "rs_avg": RC.reduce_scatter_q(s, mesh, "avg", 0, **kw),
                "ag": body(lambda x: RC.q_all_gather(x, "dp", n, axis=0, extent=shape[0] * n,
                                                     **kw))(s),
                "a2a": body(lambda x: RC.q_all_to_all(x, "dp", n, split_axis=0, concat_axis=1,
                                                      **kw))(s),
                "dpgr": RC._smap(mesh, lambda x: jax.tree_util.tree_map(
                    lambda v: v[None], ref_dp_grad_reduce(
                        {"b": x[0] * 2.0, "a": x[0]}, "dp", n, compress="int8", step=3,
                        reduce_op="avg", **kw)), P("dp"), P("dp"))(s)}

    want = reference(stacked)
    for r, ans in enumerate(got):
        for k in ("ar_sum", "ar_avg"):
            np.testing.assert_array_equal(_bits(ans[k]), _bits(want[k]), err_msg=k)
        for k in ("rs_sum", "rs_avg", "ag", "a2a"):
            np.testing.assert_array_equal(_bits(ans[k]), _bits(np.asarray(want[k])[r]),
                                          err_msg=k)
        for leaf in ("a", "b"):  # dp_grad_reduce: one q_psum a leaf, its key folded
            np.testing.assert_array_equal(_bits(ans["dpgr"][leaf]),
                                          _bits(np.asarray(want["dpgr"][leaf])[r]), err_msg=leaf)
        np.testing.assert_allclose(ans["dpgr_exact"]["a"], np.asarray(stacked).mean(0),
                                   rtol=1e-6, atol=1e-6)
        elems = int(np.prod(shape))
        raw, q = RC._compress_wire_bytes(elems, 4, 64, "all_reduce", n)
        assert ans["compress"]["all_reduce.raw_wire"] == 2 * raw
        assert ans["compress"]["all_reduce.q_wire"] == 2 * q
        raw, q = RC._compress_wire_bytes(elems, 4, 64, "reduce_scatter", n)
        assert ans["compress"]["reduce_scatter.q_wire"] == pytest.approx(2 * q)
        assert ans["calls"]["gloo.q_psum"] == 2 and ans["calls"]["gloo.q_psum_scatter"] == 2
        assert ans["bytes"]["gloo.q_psum"] == 2 * RB.packed_nbytes(elems, 64)


# ------------------------------------------------------------------- DDP
@pytest.mark.parametrize("compress", [None, "int8"])
def test_ddp_finish_grad_sync_is_the_references(worlds, compress):
    got = worlds(4).run("dp_ddp_sync", seed=SEED, compress=compress)
    mesh = _ref_mesh(("dp", "tp"), (2, 2))
    leaves = {
        "ones": vt.from_local([np.ones((2, 2), np.float32)] * 4, mesh,
                              [RPartial(), RReplicate()]),
        "pp": vt.from_local([child.make_input((4, 6), SEED, rank=r) for r in range(4)], mesh,
                            [RPartial(), RPartial()]),
        "ps": vt.from_local([child.make_input((4, 3), SEED + 1, rank=r) for r in range(4)], mesh,
                            [RPartial(), RShard(1)]),
    }
    for tag, zero in (("ddp", False), ("zero", True)):
        ddp = RefDDP(None, mesh, use_distributed_optimizer=zero, grad_compress=compress)
        want = ddp.finish_grad_sync(leaves)
        for k, v in want.items():
            full = np.asarray(v.full_tensor())
            for r, ans in enumerate(got):
                a = ans[tag][k]
                assert a["placements"] == [enc(p) for p in v.placements], (tag, k)
                np.testing.assert_array_equal(_bits(a["full"]), _bits(full), err_msg=(tag, k))
                np.testing.assert_array_equal(_bits(a["local"]),
                                              _bits(np.asarray(v.to_local(rank=r))),
                                              err_msg=(tag, k, r))
    for ans in got:
        np.testing.assert_array_equal(ans["ddp"]["ones"]["full"], 2.0)  # test_optim.py:242
        assert ans["main_dtype"] == "torch.float32"
        np.testing.assert_array_equal(ans["scaled"], 1.0)
    # shard_batch: dp rank r's rows (ranks 0, 1 are dp 0; 2, 3 dp 1)
    for r, ans in enumerate(got):
        np.testing.assert_array_equal(ans["batch"], np.arange(24).reshape(8, 3)[4 * (r // 2):
                                                                               4 * (r // 2) + 4])


# ------------------------------------------------------------------ ZeRO
def _ref_gpt_dm(mesh, plan=True):
    cfg = child.tp_config("gpt", ref_nanogpt)
    model = ref_nanogpt.GPT(cfg)
    dm = ref_parallelize(model, mesh, ref_nanogpt.nanogpt_plan(mesh) if plan else {})
    variables = {"params": child.tp_tree("gpt", SEED)}
    shardings = dm.variables_shardings(jax.eval_shape(lambda: variables))
    return dm, jax.device_put(variables, shardings)["params"]


def _ref_batch(kind="gpt"):
    toks = child.dp_tokens(kind, SEED)
    return {"input": jnp.asarray(toks[:, :-1]), "target": jnp.asarray(toks[:, 1:])}


def _ref_loss(logits, batch):
    return ref_xent(logits, batch["target"])


@pytest.fixture(scope="module")
def zero_runs(worlds):
    """The port's ZeRO-2 on the (2, 2) world and the reference's on the
    same weights and batch."""
    got = worlds(4).run("dp_zero", mesh_shape=[2, 2], names=["dp", "tp"], seed=SEED,
                        steps=STEPS, grad_clip=ZERO_CLIP)
    mesh = _ref_mesh(("dp", "tp"), (2, 2))
    dm, params = _ref_gpt_dm(mesh)
    pspecs = jax.tree_util.tree_map(lambda p: p.sharding.spec, params)
    dopt = RefDOpt(adamw_lowmem(child.DP_LR, state_dtype=jnp.float32), mesh, pspecs,
                   grad_clip=ZERO_CLIP)
    state = dopt.init(params)
    state_pspecs = dopt.state_pspecs(params)
    batch = _ref_batch()

    @jax.jit
    def step(params, state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: _ref_loss(dm.apply({"params": p}, batch["input"]), batch))(params)
        params, state = dopt.step(params, state, grads)
        return params, state, loss

    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    return got, dict(mesh=mesh, state=state, pspecs=state_pspecs, losses=losses, params=params,
                     step=step, batch=batch)


def _ref_state_leaf(tree, key):
    """The reference state leaf (or pspec) at a port state key."""
    parts = key.split("/")
    node = tree
    for p in parts:
        if p.startswith("."):
            node = getattr(node, p[1:])
        elif isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
            node = node[int(p)]
        else:
            node = node[p]
    return node


def _placements_of(pspec, names, ndim):
    out = [["R"] for _ in names]
    entries = list(pspec) + [None] * (ndim - len(pspec))
    for d, e in enumerate(entries):
        for name in (e if isinstance(e, tuple) else (e,)):
            if name is not None:
                out[names.index(name)] = ["S", d]
    return out


def _state_checks(got, ref, state):
    for key in (k for k in got[0]["state"] if k != "inner/0/.count"):
        pspec = _ref_state_leaf(ref["pspecs"], key)
        leaf = _ref_state_leaf(state, key)
        sharding = NamedSharding(ref["mesh"].jax_mesh, pspec)
        index = sharding.devices_indices_map(tuple(leaf.shape))
        want = _shards(leaf, sharding, 4)
        for r, ans in enumerate(got):
            noise = _key_bias_noise(key, leaf.shape, index[jax.devices()[r]])
            diff = np.abs(ans["state"][key] - want[r])
            assert (diff <= ZERO_TOL * (1 + np.abs(want[r])))[~noise].all(), (key, r)
            assert diff[noise].max(initial=0.0) <= NOISE_TOL, (key, r)


def test_zero2_state_pieces_are_the_reference_shards(zero_runs):
    got, ref = zero_runs
    names = ("dp", "tp")
    keys = [k for k in got[0]["state"] if k != "inner/0/.count"]
    assert any(k.startswith("main_params/") for k in keys) and any("/.nu/" in k for k in keys)
    for key in keys:
        pspec = _ref_state_leaf(ref["pspecs"], key)
        leaf = _ref_state_leaf(ref["state"], key)
        want = _shards(leaf, NamedSharding(ref["mesh"].jax_mesh, pspec), 4)
        for r, ans in enumerate(got):
            assert ans["placements"][key] == _placements_of(pspec, names, leaf.ndim), key
            assert ans["state_placements"][key] == ans["placements"][key], key
            assert ans["state"][key].shape == want[r].shape, key
    _state_checks(got, ref, ref["state"])
    # the moments are dp-sharded (tests/test_optim.py:86)
    assert ["S", 0] in got[0]["placements"]["inner/0/.mu/h_0/attn/c_proj/kernel"]
    for ans in got:
        assert ans["state"]["inner/0/.count"].item() == STEPS


def test_zero2_steps_match_the_reference(zero_runs):
    got, ref = zero_runs
    for ans in got:
        np.testing.assert_allclose(ans["losses"], ref["losses"], rtol=ZERO_TOL, atol=ZERO_TOL)
    # every rank's parameter pieces: the ranks of one tp coordinate agree bitwise
    for a, b in ((0, 2), (1, 3)):
        for name, v in got[a]["final"].items():
            np.testing.assert_array_equal(v, got[b]["final"][name], err_msg=name)


def test_zero2_goes_on_from_the_reference_state(worlds, zero_runs, tmp_path):
    """Both packages take one more step from the reference's state after
    three: the port loads it through ``zero_state_from_jax``."""
    _, ref = zero_runs
    path = str(tmp_path / "state.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in ref_flatten_state(ref["state"])})
    got = worlds(4).run("dp_zero", mesh_shape=[2, 2], names=["dp", "tp"], seed=SEED, steps=1,
                        grad_clip=ZERO_CLIP, from_state=path)
    params, state, loss = ref["step"](ref["params"], ref["state"], ref["batch"])
    for ans in got:
        np.testing.assert_allclose(ans["losses"], [float(loss)], rtol=ZERO_TOL, atol=ZERO_TOL)
        assert ans["state"]["inner/0/.count"].item() == STEPS + 1
    _state_checks(got, ref, state)


def test_zero2_int8_reduce_scatter_moves_fewer_bytes(worlds):
    exact = worlds(2).run("dp_zero", mesh_shape=[2], names=["dp"], seed=SEED, steps=2)
    q = worlds(2).run("dp_zero", mesh_shape=[2], names=["dp"], seed=SEED, steps=2,
                      grad_compress="int8")
    for a, b in zip(exact, q):
        np.testing.assert_allclose(b["losses"], a["losses"], rtol=0.05)  # quantcomm LOSS_TOL
        assert b["calls"].get("gloo.q_psum_scatter", 0) > 0 and "gloo.reduce_scatter" not in b["calls"]
        assert b["compress"]["reduce_scatter.raw_wire"] >= 3.5 * b["compress"]["reduce_scatter.q_wire"]


# ----------------------------------------------------------- loss scaling
@pytest.fixture(scope="module")
def ref_scale_sequence():
    mesh = _ref_mesh(("tp",), (2,))
    params = {"w": jnp.arange(16.0, dtype=jnp.float32).reshape(4, 4)}
    tx = adamw_lowmem(1e-2, state_dtype=jnp.float32)
    dopt = RefDOpt(tx, mesh, {"w": P()}, dp_dims=("tp",), loss_scale="dynamic",
                   init_scale=1024.0, growth_interval=2)
    state = dopt.init(params)
    step = jax.jit(dopt.step)
    good = {"w": jnp.ones((4, 4), jnp.float32) * 1024.0}
    bad = {"w": good["w"].at[1, 2].set(jnp.inf)}
    seq = []
    for g in (bad, good, good):
        params, state = step(params, state, g)
        ls = state["loss_scale"]
        seq.append(dict(w=np.asarray(params["w"]), scale=float(ls["scale"]),
                        growth=int(ls["growth_count"]), skip=int(ls["skip_count"])))
    return seq


@pytest.mark.parametrize("inf_rank", [None, 1], ids=["inf_everywhere", "inf_on_rank1"])
def test_dynamic_loss_scale_matches_the_reference(worlds, ref_scale_sequence, inf_rank):
    got = worlds(2).run("dp_scale_sequence", inf_rank=inf_rank)
    for ans in got:
        seq = ans["dynamic"]
        start, after_bad = seq[0], seq[1]
        assert after_bad["skipped"] and not seq[2]["skipped"]
        for k in (k for k in start if not k.startswith("loss_scale")):
            # the skipped step changed no bit on any rank
            np.testing.assert_array_equal(_bits(after_bad[k]), _bits(start[k]), err_msg=k)
        for mine, ref in zip(seq[1:], ref_scale_sequence):
            assert mine["loss_scale/scale"].item() == ref["scale"]
            assert mine["loss_scale/growth_count"].item() == ref["growth"]
            assert mine["loss_scale/skip_count"].item() == ref["skip"]
            np.testing.assert_allclose(mine["w"], ref["w"], rtol=1e-6, atol=1e-6)
        assert ans["scale_loss"] == 2048.0
    np.testing.assert_array_equal(got[0]["dynamic"][-1]["w"], got[1]["dynamic"][-1]["w"])


def test_loss_scale_floor_skip_counter_and_static_scale(worlds):
    """tests/test_optim.py:138-175: 4 -> 2 -> 1 -> 1 -> 1 with the skip
    counter climbing, a clean step resetting it; a static scale skips on
    NaN and keeps no scale state."""
    for ans in worlds(2).run("dp_scale_sequence"):
        floor = ans["floor"]
        assert [s["loss_scale/scale"].item() for s in floor] == [2.0, 1.0, 1.0, 1.0, 1.0]
        assert [s["loss_scale/skip_count"].item() for s in floor] == [1, 2, 3, 4, 0]
        assert ans["floor_scale_loss"] == 3.0
        assert ans["static_skipped"] and not ans["static_has_scale_state"]
        np.testing.assert_array_equal(ans["static_w"], np.arange(16.0).reshape(4, 4))


# ------------------------------------------------------------------- FSDP
@pytest.fixture(scope="module")
def fsdp_ref():
    """The reference's buffer layout at dp 2 and 4, and its FSDP steps at
    dp 2 (the trajectory is the same math at any dp)."""
    out = {}
    for dp in (2, 4):
        mesh = _ref_mesh(("dp",), (dp,))
        dm, params = _ref_gpt_dm(mesh, plan=False)
        buffer = RefFSDP(params, mesh, dim="dp")
        phys = buffer.pack(params)
        out[dp] = dict(units=list(buffer.local_units), phys={k: np.asarray(v) for k, v in phys.items()},
                       local_params=[buffer.local_params(r) for r in range(dp)])
        if dp != 2:
            continue
        tx = adamw_lowmem(child.DP_LR, state_dtype=jnp.float32)
        opt_state = tx.init(phys)
        step = ref_fsdp_step(dm, tx, _ref_loss, buffer, donate=False)
        buf, losses = phys, []
        for _ in range(STEPS):
            buf, opt_state, loss = step(buf, opt_state, _ref_batch())
            losses.append(float(loss))
        out["losses"] = losses
        out["final"] = dict(_flat(jax.tree_util.tree_map(np.asarray, buffer.gather(buf))))
    return out


@pytest.mark.parametrize("dp", [2, 4])
def test_fsdp_buffer_layout_is_the_references(worlds, fsdp_ref, dp):
    got = worlds(dp).run("dp_fsdp", dp=dp, seed=SEED, steps=STEPS)
    ref = fsdp_ref[dp]
    lay = FSDPParamBuffer(child._torch_tree(child.tp_tree("gpt", SEED)),
                          DeviceMesh(("dp",), (dp,), device_type="cpu"), dim="dp")
    for r, ans in enumerate(got):
        assert ans["units"] == ref["units"]
        assert [[list(t) for t in lp] for lp in ref["local_params"]] == ans["local_params"]
        assert ans["roundtrip"]
        want = fsdp_buffer_from_jax(ref["phys"], lay, rank=r, device="cpu")
        assert set(want) == set(ans["pieces"]) == {"float32"}
        np.testing.assert_array_equal(ans["pieces"]["float32"], want["float32"].numpy())


@pytest.mark.parametrize("dp", [2, 4])
def test_fsdp_steps_match_the_reference(worlds, fsdp_ref, dp):
    got = worlds(dp).run("dp_fsdp", dp=dp, seed=SEED, steps=STEPS)
    ref = fsdp_ref
    for ans in got:
        np.testing.assert_allclose(ans["losses"], ref["losses"], rtol=FSDP_LOSS_TOL,
                                   atol=FSDP_LOSS_TOL)
        for name, v in ans["final"].items():
            np.testing.assert_allclose(v, ref["final"][name], rtol=FSDP_PARAM_TOL,
                                       atol=FSDP_PARAM_TOL, err_msg=name)
    for ans in got[1:]:  # every rank gathers the same model
        for name, v in ans["final"].items():
            np.testing.assert_array_equal(v, got[0]["final"][name], err_msg=name)


def test_fsdp_plan_is_the_references():
    params = {"w": torch.ones(8, 6), "tiny": torch.ones(3), "h": {"k": torch.ones(3, 4)}}
    mine = fsdp_plan(params, DeviceMesh(("dp", "tp"), (2, 4), device_type="cpu"), dim="dp")
    ref = vt.parallel.fsdp_plan(jax.tree_util.tree_map(lambda t: jnp.ones(t.shape), params),
                                RefMesh(("dp", "tp"), (2, 4)), dim="dp")
    assert list(mine) == list(ref)
    assert {k: [enc(p) for p in v] for k, v in mine.items()} == \
        {k: [enc(p) for p in v] for k, v in ref.items()}


# ------------------------------------------------------- elastic restore
def _expected_piece(full, placements, names, shape, rank):
    from vescale_tpu_torch import placements as pl_mod
    from vescale_tpu_torch.spec import DArraySpec, TensorMeta

    lay = DeviceMesh(tuple(names), tuple(shape), device_type="cpu")
    t = torch.from_numpy(np.array(full, copy=True))
    spec = DArraySpec(lay, [child.dec(e, pl_mod) for e in placements],
                      TensorMeta(tuple(t.shape), t.dtype))
    return spec.local_from_full(t, lay.coordinate_of_rank(rank)).numpy()


def test_zero2_and_fsdp_state_restore_on_a_larger_world(worlds, tmp_path):
    """Saved by a world of 2, restored through ``state_template`` and
    ``buffer_templates`` on a world of 4: every piece bitwise the piece a
    dp=4 layout cuts from the same values, the ZeRO state on the dp=4
    placements, the FSDP buffers on the dp=4 units."""
    root = str(tmp_path / "ck")
    saved = worlds(2).run("dp_ckpt", root=root, phase="save", dp=2, seed=SEED)[0]
    got = worlds(4).run("dp_ckpt", root=root, phase="load", dp=4, seed=SEED)
    units4 = list(FSDPParamBuffer(child._torch_tree(child.tp_tree("gpt", SEED)),
                                  DeviceMesh(("dp",), (4,), device_type="cpu")).local_units)
    for r, ans in enumerate(got):
        assert set(ans["locals"]) == set(saved)
        for key, piece in ans["locals"].items():
            if key not in ans["placements"]:  # the step counter
                np.testing.assert_array_equal(piece, saved[key])
                continue
            pl = ans["placements"][key]
            if key.startswith("fsdp/"):
                assert pl == [["RS", [0], units4]], key
            want = _expected_piece(saved[key], pl, ("dp",), (4,), r)
            np.testing.assert_array_equal(_bits(piece), _bits(want), err_msg=key)
        assert ans["placements"]["optimizer/main_params/wte/embedding"] == [["S", 0]]
        for name, p in ans["params"].items():  # load_state_tree wrote the params
            key = "optimizer/main_params/" + name.replace(".", "/")
            np.testing.assert_array_equal(_bits(p), _bits(saved[key]), err_msg=name)


def _ref_zero(mesh):
    dm, params = _ref_gpt_dm(mesh)
    pspecs = jax.tree_util.tree_map(lambda p: p.sharding.spec, params)
    return dm, params, RefDOpt(adamw_lowmem(child.DP_LR, state_dtype=jnp.float32), mesh, pspecs)



def test_reference_zero_state_restores_in_the_port_and_back(worlds, tmp_path):
    """A fp32 ZeRO-2 state saved by the reference on a ("dp", "tp") mesh of
    (2, 4) restores on the port's (2, 2) world, each piece bitwise its cut
    of the reference's values; the port's state, saved on (2, 2), restores
    in the reference on (2, 4) bitwise."""
    mesh = _ref_mesh(("dp", "tp"), (2, 4))
    _, params, dopt = _ref_zero(mesh)
    state = dopt.init(params)
    rng = np.random.default_rng(3)  # one step on seeded gradients: moments nonzero
    grads = jax.tree_util.tree_map(
        lambda p: jax.device_put(rng.standard_normal(p.shape).astype(np.float32), p.sharding),
        params)
    params, state = jax.jit(dopt.step)(params, state, grads)
    root = str(tmp_path / "ref")
    ref_ckpt.save(root, {"optimizer": state})
    got = worlds(4).run("dp_ckpt", root=root, phase="load", dp=2, names=["dp", "tp"], seed=SEED,
                        fsdp=False)
    for r, ans in enumerate(got):
        assert len(ans["locals"]) == len(jax.tree_util.tree_leaves(state))
        for key, piece in ans["locals"].items():
            leaf = np.asarray(_ref_state_leaf(state, key[len("optimizer/"):]))
            if key not in ans["placements"]:
                np.testing.assert_array_equal(piece, leaf)
                continue
            want = _expected_piece(leaf, ans["placements"][key], ("dp", "tp"), (2, 2), r)
            np.testing.assert_array_equal(_bits(piece), _bits(want), err_msg=key)
    back = str(tmp_path / "port")
    saved = worlds(4).run("dp_ckpt", root=back, phase="save", dp=2, names=["dp", "tp"],
                          seed=SEED, fsdp=False)[0]
    loaded = ref_ckpt.load(back, {"optimizer": dopt.state_template(params)})["optimizer"]
    flat = dict(ref_flatten_state({"optimizer": loaded}))
    assert set(flat) == set(saved)
    for key, v in flat.items():
        np.testing.assert_array_equal(_bits(np.asarray(v)), _bits(saved[key]), err_msg=key)
