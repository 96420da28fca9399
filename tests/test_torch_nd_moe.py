"""The port's n-D compositions around MoE (A16, A11) against the JAX
reference on virtual CPU meshes of the same shapes.

Held, on gloo worlds of 2, 4 and 8 (children of
``tests/torch_spmd_child.py``) and the tiny Mixtral of
tests/test_models.py:26-37 (numpy-seeded weights, fp32):

  * MoE over "dp" gives the reference's global batch (fault C5): at
    ``capacity_factor=1.0``, where the reference drops routed pairs, the
    logits, the aux losses, ``expert_tokens`` and every gradient of the
    readout plus the aux losses, on ("dp", "ep") = (2, 2) and ("dp",) =
    (2,), against the reference's global run;
  * tp x ep: ``mixtral_plan`` on ("ep", "tp") = (2, 2), with and without
    sequence parallelism, the same quantities, every rank's pieces;
  * dp x ep through ``make_train_step``'s default DDP: 3 steps of
    examples/mixtral_4d_benchmark/mixtral_train.py:70-79's step (optax
    ``adamw(3e-4)``, the aux losses added) at a dropping capacity, the
    losses and every rank's final pieces; the replicated leaves bitwise
    equal across "ep";
  * ZeRO over ("dp", "ep"): ``DistributedOptimizer(dp_dims=("dp",
    "ep"))`` against the reference's over ``adamw_lowmem`` (fp32
    moments, optax's adamw with the same state layout): every state
    piece the reference's shard (box, placements, values), the losses and
    the final pieces; the port's checkpoint of that state loaded by the
    reference bitwise; then one more step from the reference's state
    saved on that mesh, through ``zero_state_from_jax``;
  * ("dp", "ep", "tp") = (2, 2, 2) on a world of 8: 3 steps through the
    default DDP, against the reference.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding

import vescale_tpu as vt
from vescale_tpu import checkpoint as ref_ckpt
from vescale_tpu.checkpoint.planner import flatten_state as ref_flatten_state
from vescale_tpu.dmodule import parallelize_module as ref_parallelize
from vescale_tpu.models import mixtral as ref_mixtral
from vescale_tpu.models.nanogpt import cross_entropy_loss as ref_xent
from vescale_tpu.moe.token_dispatcher import TokenDispatcher as RefDispatcher
from vescale_tpu.parallel import DistributedOptimizer as RefDOpt
from vescale_tpu.parallel.optimizer import adamw_lowmem

from vescale_tpu_torch import placements as pl_mod
from vescale_tpu_torch.mesh import DeviceMesh
from vescale_tpu_torch.models import MixtralConfig, param_shapes
from vescale_tpu_torch.spec import DArraySpec, TensorMeta

import torch_spmd_child as child

from torch_reset import dormant_module, dormant_test  # noqa: F401 (autouse: both packages dormant)

FWD_TOL = 2e-5   # tests/test_moe.py:84 (tests/test_torch_mixtral.py's FWD_TOL)
GRAD_TOL = 5e-5  # tests/test_dmodule.py's step tolerance (GRAD_TOL there)
AUX_REL = 1e-6   # tests/test_torch_mixtral.py's AUX_REL
LOSS_REL = 1e-5  # tests/test_torch_mixtral.py's fp32 LOSS_REL
PARAM_TOL = 1e-4  # tests/test_torch_mixtral.py's fp32 PARAM_TOL
ZERO_TOL = 5e-5  # tests/test_optim.py:84
DROP_CF = 1.0    # a capacity at which the tiny Mixtral drops routed pairs
STEPS = 3
SEED = 0
EXPERT_LEAVES = ("w_in", "b_in", "w_out", "b_out", "w_gate")


@pytest.fixture(scope="module")
def worlds():
    made = {n: child.World(n) for n in (2, 4, 8)}  # all start together

    def get(n):
        return made[n]

    yield get
    for w in made.values():
        w.close()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def _rcfg(cf):
    return ref_mixtral.MixtralConfig(**dict(child.MIXTRAL_TINY, capacity_factor=cf),
                                     dtype=jnp.float32)


def _ref_mesh(names, shape):
    n = int(np.prod(shape))
    return vt.DeviceMesh(tuple(names), tuple(shape), devices=jax.devices()[:n])


def _params():
    shapes = param_shapes(MixtralConfig(**child.MIXTRAL_TINY, dtype=torch.float32))
    return jax.tree_util.tree_map(jnp.asarray, child.moe_tree(shapes, SEED))


def _piece(full, placements, names, shape, rank):
    """Rank ``rank``'s piece of ``full`` under the encoded ``placements``."""
    lay = DeviceMesh(tuple(names), tuple(shape), device_type="cpu")
    t = torch.from_numpy(np.array(full, copy=True))
    spec = DArraySpec(lay, [child.dec(e, pl_mod) for e in placements],
                      TensorMeta(tuple(t.shape), t.dtype))
    return spec.local_from_full(t, lay.coordinate_of_rank(rank)).numpy()


def reference_forward(names, shape, cf, sp=False):
    """The reference DModule over ``mixtral_plan`` on a virtual mesh: the
    global logits, the aux losses, each layer's ``expert_tokens`` and
    dropped pairs, and the grads of sum(logits * w) + the aux losses."""
    rcfg = _rcfg(cf)
    mesh = _ref_mesh(names, shape)
    dm = ref_parallelize(ref_mixtral.Mixtral(rcfg), mesh,
                         ref_mixtral.mixtral_plan(mesh, sequence_parallel=sp))
    toks = jnp.asarray(child.moe_tokens(SEED))
    w = jnp.asarray(child.moe_readout(SEED))
    L = rcfg.num_hidden_layers

    def parts(p):
        logits, state = dm.apply({"params": p}, toks, mutable=["losses", "intermediates"])
        aux = [state["losses"][f"layers_{i}"]["router_aux"][0] for i in range(L)]
        tokens = [state["intermediates"][f"layers_{i}"]["block_sparse_moe"]["expert_tokens"][0]
                  for i in range(L)]
        return jnp.sum(logits * w) + sum(aux), (logits, aux, tokens)

    grads, (logits, aux, tokens) = jax.jit(jax.grad(parts, has_aux=True))(_params())
    N = toks.size
    C = RefDispatcher.capacity_for(N, rcfg.num_local_experts, rcfg.num_experts_per_tok, cf)
    tokens = [np.asarray(t) for t in tokens]
    return dict(logits=np.asarray(logits), aux=[float(a) for a in aux], tokens=tokens,
                dropped=[int(np.maximum(t - C, 0).sum()) for t in tokens],
                grads={k: np.asarray(v) for k, v in _flat(grads).items()})


def _check_forward(got, ref, names, shape):
    dp = shape[names.index("dp")] if "dp" in names else 1
    rows = ref["logits"].shape[0] // dp
    for r, g in enumerate(got):
        coord = np.unravel_index(r, shape)
        d = coord[names.index("dp")] if "dp" in names else 0
        np.testing.assert_allclose(g["logits"], ref["logits"][d * rows:(d + 1) * rows],
                                   rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_allclose(g["aux"], ref["aux"], rtol=AUX_REL)
        for mine, want in zip(g["expert_tokens"], ref["tokens"]):
            np.testing.assert_array_equal(mine, want)
        for name, grad in g["grads"].items():
            want = _piece(ref["grads"][name], g["placements"][name], names, shape, r)
            np.testing.assert_allclose(grad, want, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("names,shape", [(("dp", "ep"), (2, 2)), (("dp",), (2,))],
                         ids=["dp2xep2", "dp2"])
def test_dropped_tokens_under_dp_are_the_references(worlds, names, shape):
    """C5: each dp rank used to take its capacity, slot positions and aux
    loss from its own rows; at a capacity that drops pairs the ranks now
    give the reference's global batch."""
    ref = reference_forward(names, shape, DROP_CF)
    assert sum(ref["dropped"]) > 0, ref["dropped"]
    got = worlds(int(np.prod(shape))).run("moe_ep_model", mesh_shape=list(shape),
                                          names=list(names), seed=SEED, aux=True,
                                          capacity_factor=DROP_CF)
    _check_forward(got, ref, names, shape)


@pytest.mark.parametrize("sp", [False, True], ids=["tp", "tp_sp"])
def test_tp_by_ep_matches_the_reference_mesh(worlds, sp):
    """``mixtral_plan`` with "tp": attention, the embedding and the head
    over "tp", the experts Shard(0) over "ep" and replicated over "tp";
    the MoE layer sums over "ep" only."""
    names, shape = ("ep", "tp"), (2, 2)
    ref = reference_forward(names, shape, DROP_CF, sp)
    got = worlds(4).run("moe_ep_model", mesh_shape=list(shape), names=list(names), seed=SEED,
                        aux=True, sp=sp, capacity_factor=DROP_CF)
    _check_forward(got, ref, names, shape)
    for g in got:
        assert g["placements"]["layers_0.block_sparse_moe.w_in"] == [["S", 0], ["R"]]
        assert g["placements"]["layers_0.self_attn.q_proj.kernel"] == [["R"], ["S", 1]]


# ------------------------------------------------------------- training
def reference_train(names, shape, cf=DROP_CF, sp=False, zero_dims=None, steps=STEPS):
    """examples/mixtral_4d_benchmark/mixtral_train.py:70-79's step on a
    virtual mesh (cross entropy plus the aux losses, ``optax.adamw``), or
    with ``zero_dims`` the reference ``DistributedOptimizer`` over
    ``adamw_lowmem`` (fp32 moments) with those dp dims."""
    mesh = _ref_mesh(names, shape)
    dm = ref_parallelize(ref_mixtral.Mixtral(_rcfg(cf)), mesh,
                         ref_mixtral.mixtral_plan(mesh, sequence_parallel=sp))
    params = _params()
    shardings = dm.variables_shardings(jax.eval_shape(lambda: {"params": params}))
    params = jax.device_put({"params": params}, shardings)["params"]
    toks = child.dp_tokens("gpt", SEED, batch=child.MOE_BATCH)
    batch = {"input": jnp.asarray(toks[:, :-1]), "target": jnp.asarray(toks[:, 1:])}

    def lf(p, b):
        logits, aux = dm.apply({"params": p}, b["input"], mutable=["losses"])
        return ref_xent(logits, b["target"]) + sum(jax.tree_util.tree_leaves(aux["losses"]))

    if zero_dims is None:
        tx = optax.adamw(child.ND_LR)
        state = tx.init(params)

        def update(p, s, g):
            u, s = tx.update(g, s, p)
            return optax.apply_updates(p, u), s
    else:
        pspecs = jax.tree_util.tree_map(lambda p: p.sharding.spec, params)
        dopt = RefDOpt(adamw_lowmem(child.ND_LR, state_dtype=jnp.float32), mesh, pspecs,
                       dp_dims=tuple(zero_dims))
        state = dopt.init(params)
        update = dopt.step

    @jax.jit
    def step(p, s, b):
        loss, g = jax.value_and_grad(lf)(p, b)
        p, s = update(p, s, g)
        return p, s, loss

    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    out = dict(mesh=mesh, losses=losses, params=params, state=state, step=step, batch=batch,
               final={k: np.asarray(v) for k, v in _flat(params).items()})
    if zero_dims is not None:
        out["pspecs"] = dopt.state_pspecs(params)
        out["dopt"] = dopt
    return out


def _check_train(got, ref, names, shape):
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["losses"], ref["losses"], rtol=LOSS_REL)
        for name, v in g["final"].items():
            want = _piece(ref["final"][name], g["param_placements"][name], names, shape, r)
            np.testing.assert_allclose(v, want, rtol=PARAM_TOL, atol=PARAM_TOL, err_msg=name)


def test_dp_by_ep_trains_through_ddp_as_the_reference(worlds):
    names, shape = ("dp", "ep"), (2, 2)
    ref = reference_train(names, shape)
    got = worlds(4).run("nd_moe_train", mesh_shape=list(shape), names=list(names), seed=SEED,
                        steps=STEPS, capacity_factor=DROP_CF)
    _check_train(got, ref, names, shape)
    # the replicated leaves stay bitwise equal across "ep" (ep is the inner dim)
    for r, g in enumerate(got):
        for name, v in g["final"].items():
            if name.rsplit(".", 1)[-1] not in EXPERT_LEAVES:
                np.testing.assert_array_equal(v, got[r ^ 1]["final"][name], err_msg=name)


def _ref_state_leaf(tree, key):
    node = tree
    for p in key.split("/"):
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


def check_zero_state(got, mesh, pspecs, state, names, n):
    """Every state piece of every rank: its placements the reference's
    ``state_pspecs``, its box and values the reference's shard."""
    keys = [k for k in got[0]["state"] if k != "inner/0/.count"]
    assert any(k.startswith("main_params/") for k in keys)
    for key in keys:
        pspec = _ref_state_leaf(pspecs, key)
        leaf = np.asarray(_ref_state_leaf(state, key))
        sharding = NamedSharding(mesh.jax_mesh, pspec)
        idx = sharding.devices_indices_map(tuple(leaf.shape))
        for r, g in enumerate(got):
            assert g["placements"][key] == _placements_of(pspec, names, leaf.ndim), key
            assert g["state_placements"][key] == g["placements"][key], key
            want = leaf[idx[jax.devices()[r]]]
            assert g["state"][key].shape == want.shape, key
            np.testing.assert_allclose(g["state"][key], want, rtol=ZERO_TOL, atol=ZERO_TOL,
                                       err_msg=f"{key} rank {r}")


def test_zero_over_dp_and_ep_is_the_references(worlds, tmp_path):
    """The expert leaves keep Shard(0) over "ep" for their state; every
    other leaf's state is cut over the flattened (dp, ep) grid."""
    names, shape = ("dp", "ep"), (2, 2)
    ref = reference_train(names, shape, zero_dims=names)
    root = str(tmp_path / "port")
    got = worlds(4).run("nd_moe_train", mesh_shape=list(shape), names=list(names), seed=SEED,
                        steps=STEPS, capacity_factor=DROP_CF, zero_dims=list(names), root=root)
    _check_train(got, ref, names, shape)
    check_zero_state(got, ref["mesh"], ref["pspecs"], ref["state"], names, 4)
    # the port's checkpoint of that state loads in the reference, bitwise
    loaded = ref_ckpt.load(root, {"optimizer": ref["dopt"].state_template(ref["params"])})
    flat = dict(ref_flatten_state(loaded))
    assert set(flat) == set(got[0]["saved"])
    for key, v in flat.items():
        np.testing.assert_array_equal(np.asarray(v), got[0]["saved"][key], err_msg=key)
    pl = got[0]["placements"]
    assert pl["inner/0/.mu/layers_0/block_sparse_moe/w_in"] == [["R"], ["S", 0]]
    assert pl["inner/0/.mu/layers_0/block_sparse_moe/router"] == [["S", 0], ["S", 0]]
    assert pl["inner/0/.mu/lm_head/kernel"] == [["S", 0], ["S", 0]]
    # the reference's state saved on that mesh, and one more step from it
    path = str(tmp_path / "state.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in ref_flatten_state(ref["state"])})
    more = worlds(4).run("nd_moe_train", mesh_shape=list(shape), names=list(names), seed=SEED,
                         steps=1, capacity_factor=DROP_CF, zero_dims=list(names),
                         from_state=path)
    params, state, loss = ref["step"](ref["params"], ref["state"], ref["batch"])
    for g in more:
        np.testing.assert_allclose(g["losses"], [float(loss)], rtol=LOSS_REL)
    check_zero_state(more, ref["mesh"], ref["pspecs"], state, names, 4)


def test_dp_ep_tp_trains_through_ddp_as_the_reference(worlds):
    """Without sequence parallelism: the reference's ``mixtral_plan`` with
    it on a mesh with "dp" constrains the MoE block's 0-d aux loss to
    Shard(0) and fails to trace."""
    names, shape = ("dp", "ep", "tp"), (2, 2, 2)
    ref = reference_train(names, shape)
    got = worlds(8).run("nd_moe_train", mesh_shape=list(shape), names=list(names), seed=SEED,
                        steps=STEPS, capacity_factor=DROP_CF)
    _check_train(got, ref, names, shape)
