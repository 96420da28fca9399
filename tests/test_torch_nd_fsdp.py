"""The port's n-D compositions without MoE's "ep" alone (A11, A16): a
parameter plan that shards over "dp", ZeRO over two plain dp dims, and the
5D rung at toy scale, against the JAX reference.

Held, on gloo worlds of 2, 4 and 8 (children of
``tests/torch_spmd_child.py``):

  * FSDP by the plan: the tiny GPT under ``nanogpt_plan`` on ("dp", "tp")
    = (2, 2) with ``c_fc.kernel`` as P("dp", "tp") and ``c_proj.kernel``
    as P("tp", "dp"), 3 steps of ``make_train_step`` with a
    ``DistributedOptimizer``: the losses, every state piece (the two
    kernels' state on the plan's placements) and the final pieces against
    the reference's ``DModule`` and ``DistributedOptimizer`` on the same
    plan; then saved, and loaded on a world of 2 (("dp", "tp") = (1, 2)
    and (2, 1)), every piece bitwise its cut of the saved values;
  * ZeRO over ("dpa", "dpb") = (2, 2) on the tiny GPT with the batch over
    both: the same against the reference's ``dp_dims=("dpa", "dpb")``;
  * the 5D rung (tests/test_5d_compose.py:35-105, ``slow`` there and not
    run in tier-1): ("pp", "dp", "ep") = (2, 2, 2) on a world of 8 through
    ``pipeline_blocks``, MoE blocks whose experts are Shard(0) over "ep"
    (bound by ``MoEMLP.place``) and ``zero_sharded(dp_dims=("dp",))``:
    3 steps' losses and final parameters within ``ND5_LOSS_REL`` /
    ``ND5_PARAM_TOL`` of the port's one-rank run of the same model, which
    is held to the reference's single-device step within the same bounds;
    the checkpoint loaded onto a ("x",) mesh of 8 bitwise.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import flax.linen as nn
import optax

from vescale_tpu.dmodule import parallelize_module as ref_parallelize
from vescale_tpu.models import nanogpt as ref_nanogpt
from vescale_tpu.models.nanogpt import cross_entropy_loss as ref_xent
from vescale_tpu.moe.layer import MoEConfig as RefMoEConfig
from vescale_tpu.parallel import DistributedOptimizer as RefDOpt
from vescale_tpu.parallel.optimizer import adamw_lowmem
from vescale_tpu.placements import Shard as RShard

import torch_spmd_child as child
from test_5d_compose import MoEBlock
from test_torch_nd_moe import _flat, _piece, _ref_mesh, check_zero_state

from torch_reset import dormant_module, dormant_test  # noqa: F401 (autouse: both packages dormant)

SEED = 0
STEPS = 3
LOSS_TOL = 5e-5   # tests/test_optim.py:84 (tests/test_torch_dp.py's ZERO_TOL)
ND5_LOSS_REL = 1e-5  # fp32 sums in other orders: tests/test_torch_mixtral.py's LOSS_REL
ND5_PARAM_TOL = 1e-4  # tests/test_torch_mixtral.py's fp32 PARAM_TOL
# GPT's key bias has a zero gradient in exact arithmetic, so AdamW moves it
# by about lr a step on rounding noise (tests/test_torch_dp.py's NOISE_TOL)
NOISE_TOL = 2 * STEPS * child.DP_LR


@pytest.fixture(scope="module")
def worlds():
    made = {n: child.World(n) for n in (2, 4, 8)}  # all start together

    def get(n):
        return made[n]

    yield get
    for w in made.values():
        w.close()


# ------------------------------------------------------- FSDP by the plan
def reference_gpt(names, shape, plan_over=None, steps=STEPS):
    """The reference's tiny GPT (``nanogpt_plan`` with ``plan_over``'s
    entries updated in place, or no plan) and ``DistributedOptimizer``
    over ``adamw_lowmem`` (fp32 moments) with the mesh's dp dims."""
    mesh = _ref_mesh(names, shape)
    if plan_over is None:
        plan = {}
    else:
        plan = ref_nanogpt.nanogpt_plan(mesh)
        plan["parameter"].update(plan_over)
    dm = ref_parallelize(ref_nanogpt.GPT(child.tp_config("gpt", ref_nanogpt)), mesh, plan)
    variables = {"params": child.tp_tree("gpt", SEED)}
    shardings = dm.variables_shardings(jax.eval_shape(lambda: variables))
    params = jax.device_put(variables, shardings)["params"]
    pspecs = jax.tree_util.tree_map(lambda p: p.sharding.spec, params)
    dp_dims = ("dp",) if plan_over is not None else tuple(names)
    dopt = RefDOpt(adamw_lowmem(child.DP_LR, state_dtype=jnp.float32), mesh, pspecs,
                   dp_dims=dp_dims)
    state = dopt.init(params)
    toks = child.dp_tokens("gpt", SEED, batch=child.ND_FSDP_BATCH)
    batch = {"input": jnp.asarray(toks[:, :-1]), "target": jnp.asarray(toks[:, 1:])}

    @jax.jit
    def step(p, s, b):
        loss, g = jax.value_and_grad(
            lambda q: ref_xent(dm.apply({"params": q}, b["input"]), b["target"]))(p)
        p, s = dopt.step(p, s, g)
        return p, s, loss

    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    return dict(mesh=mesh, losses=losses, state=state, pspecs=dopt.state_pspecs(params),
                final={k: np.asarray(v) for k, v in _flat(params).items()})


def _noise(name):
    """The elements whose gradient is rounding noise: c_attn's key bias."""
    return name.endswith("c_attn.bias")


def _check(got, ref, names, shape):
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["losses"], ref["losses"], rtol=LOSS_TOL, atol=LOSS_TOL)
        for name, v in g["final"].items():
            want = _piece(ref["final"][name], g["param_placements"][name], names, shape, r)
            tol = NOISE_TOL if _noise(name) else LOSS_TOL
            np.testing.assert_allclose(v, want, rtol=tol, atol=tol, err_msg=name)


def _check_state(got, ref, names):
    """``check_zero_state`` with the key bias's moments, rounding noise
    (tests/test_torch_dp.py), left to the parameter check above."""
    clean = [dict(g, state={k: v for k, v in g["state"].items() if not k.endswith("c_attn/bias")})
             for g in got]
    check_zero_state(clean, ref["mesh"], ref["pspecs"], ref["state"], names, 4)


def test_a_plan_that_shards_over_dp_trains_as_the_reference(worlds, tmp_path):
    names, shape = ("dp", "tp"), (2, 2)
    over = {r"h_\d+\.mlp\.c_fc\.kernel": [RShard(0), RShard(1)],
            r"h_\d+\.mlp\.c_proj\.kernel": [RShard(1), RShard(0)]}
    ref = reference_gpt(names, shape, over)
    root = str(tmp_path / "ck")
    got = worlds(4).run("nd_fsdp", mesh_shape=list(shape), names=list(names), seed=SEED,
                        steps=STEPS, root=root)
    for g in got:
        assert g["dp_sharded"] == [f"h_{i}.mlp.{k}.kernel" for i in range(2)
                                   for k in ("c_fc", "c_proj")]
        assert g["param_placements"]["h_0.mlp.c_fc.kernel"] == [["S", 0], ["S", 1]]
        assert g["param_placements"]["h_0.mlp.c_proj.kernel"] == [["S", 1], ["S", 0]]
        # the ZeRO rule leaves a leaf sharded over "dp" as the plan has it
        assert g["placements"]["inner/0/.mu/h_0/mlp/c_fc/kernel"] == [["S", 0], ["S", 1]]
    _check(got, ref, names, shape)
    _check_state(got, ref, names)
    saved = got[0]["saved"]
    for load_shape in ([1, 2], [2, 1]):
        back = worlds(2).run("nd_fsdp_load", root=root, mesh_shape=load_shape,
                             names=list(names), seed=SEED)
        for r, ans in enumerate(back):
            assert set(ans["locals"]) == set(saved)
            for key, piece in ans["locals"].items():
                if key not in ans["placements"]:  # the step counter
                    np.testing.assert_array_equal(piece, saved[key])
                    continue
                want = _piece(saved[key], ans["placements"][key], names, load_shape, r)
                np.testing.assert_array_equal(piece, want, err_msg=key)
            for name, p in ans["params"].items():  # load_state_tree wrote the params
                want = _piece(saved["model/" + name], ans["placements"]["model/" + name],
                              names, load_shape, r)
                np.testing.assert_array_equal(p, want, err_msg=name)


def test_zero_over_two_plain_dp_dims_is_the_references(worlds):
    names, shape = ("dpa", "dpb"), (2, 2)
    ref = reference_gpt(names, shape)
    got = worlds(4).run("nd_fsdp", mesh_shape=list(shape), names=list(names), seed=SEED,
                        steps=STEPS, two_dims=True)
    _check(got, ref, names, shape)
    _check_state(got, ref, names)
    assert got[0]["placements"]["inner/0/.mu/h_0/mlp/c_fc/kernel"] == [["S", 0], ["S", 0]]
    for g in got[1:]:  # every rank holds the same parameters
        for name, v in g["final"].items():
            np.testing.assert_array_equal(v, got[0]["final"][name], err_msg=name)


def test_what_the_port_refuses(worlds):
    """Two departures: a parameter sharded over "dp" on the tensor dim a
    tensor-parallel dim shards too (the reference's P(("dp", "tp"))), and
    ``dp_dims`` out of mesh order (the reference's P(("tp", "dp"))), raise
    with what is refused."""
    for ans in worlds(4).run("nd_refusals"):
        assert "no tensor-parallel dim shards" in ans["same_dim"]
        assert "mesh order" in ans["dp_dims_order"]


# ------------------------------------------------------------ the 5D rung
def reference_5d_single(steps=STEPS):
    """tests/test_5d_compose.py's model and loss on one device, the blocks
    in sequence, ``optax.adamw(1e-3)``, from ``child.nd5_params``."""
    blk = MoEBlock(RefMoEConfig(**child.ND5_MOE))
    emb = nn.Embed(child.ND5_VOCAB, child.ND5_MOE["d_model"])
    head = nn.Dense(child.ND5_VOCAB, use_bias=False)
    params = jax.tree_util.tree_map(jnp.asarray, child.nd5_params(SEED))
    toks = child.nd5_tokens(SEED)
    batch = {"input": jnp.asarray(toks[:, :-1]), "target": jnp.asarray(toks[:, 1:])}

    def loss_fn(p):
        x = emb.apply({"params": p["emb"]}, batch["input"])
        for i in range(2):
            x = blk.apply({"params": p[f"blocks_{i}"]}, x)
        return ref_xent(head.apply({"params": p["head"]}, x), batch["target"])

    tx = optax.adamw(child.ND5_LR)
    state = tx.init(params)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(loss_fn)(p)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in _flat(params).items()}


def test_5d_rung_trains_as_one_rank_and_its_checkpoint_reshards(worlds, tmp_path):
    one = child.nd5_run(None, SEED, STEPS)
    ref_losses, ref_final = reference_5d_single()
    np.testing.assert_allclose(one["losses"], ref_losses, rtol=ND5_LOSS_REL)
    for name, v in one["final"].items():
        np.testing.assert_allclose(v.numpy(), ref_final[name], rtol=ND5_PARAM_TOL,
                                   atol=ND5_PARAM_TOL, err_msg=name)
    assert one["losses"][-1] < one["losses"][0]
    got = worlds(8).run("nd_5d", root=str(tmp_path / "c5d"), seed=SEED, steps=STEPS)
    for g in got:
        np.testing.assert_allclose(g["losses"], one["losses"], rtol=ND5_LOSS_REL)
        for name, v in g["final"].items():
            if name.startswith("blocks."):  # stacked (2, ...): block i at row i
                for i in range(2):
                    want = one["final"][f"blocks_{i}." + name[len("blocks."):]].numpy()
                    np.testing.assert_allclose(v[i], want, rtol=ND5_PARAM_TOL,
                                               atol=ND5_PARAM_TOL, err_msg=f"{name}[{i}]")
            else:
                np.testing.assert_allclose(v, one["final"][name].numpy(), rtol=ND5_PARAM_TOL,
                                           atol=ND5_PARAM_TOL, err_msg=name)
        # the round trip onto the ("x",) mesh: every leaf whole and bitwise
        assert set(g["loaded"]) == set(g["final"])
        for name, v in g["loaded"].items():
            np.testing.assert_array_equal(v, g["final"][name], err_msg=name)
