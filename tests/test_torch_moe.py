"""The port's mixture of experts (``vescale_tpu_torch.moe``, A16) against
the JAX reference ``vescale_tpu.moe`` on the same numpy-seeded inputs.

Held:

  * ``build_masks`` and ``dispatch``: exactly the reference's (one nonzero
    term a slot); ``combine``: exactly in the drop case of
    tests/test_moe.py:146-162 and within 1 fp32 ulp at scale on random
    gates (each output row sums K products, in another order than XLA's
    dot);
  * ``capacity_for`` and both allocators over a set of loads: equal,
    refusals included;
  * ``MoEMLP``, GELU and SwiGLU, fp32 and bf16, with and without capacity
    drops, the reference's weights carried across through
    ``params_from_jax``: ``expert_tokens`` exactly, ``aux`` within 2 fp32
    ulps, ``y`` and the grads of sum(y * w) + aux against ``jax.grad``
    within 8 / 16 fp32 ulps at scale (measured 2.5 / 5), and in bf16
    within 2 / 4 bf16 steps (measured 1.25 / 3);
  * ``MoEParamBuffer`` on gloo worlds of 2 and 4 (children of
    ``tests/torch_spmd_child.py``, one spawn each): every rank's pieces,
    before and after ``refresh``, exactly the reference's ``to_local(r)`` on
    its mesh, the ep x tp submesh included, and the gathered leaves exact;
  * ``all_to_all_dispatch``: each rank's capacity block in, its experts'
    rows of every block out, as the reference's resharded buffer holds
    them;
  * ``MoEOptimizer``: SGD and Adam steps, a refresh between them, each
    rank's parameter and moment pieces within 1e-6 of the reference's
    (optax) and the step count kept;
  * tests/test_moe.py:181-240's load-aware loop: the port's run with a
    refresh bitwise its run without one (losses, parameters, moments),
    the units changed, and the losses within 1e-5 of the reference
    layer's trained by optax's Adam.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import vescale_tpu as vt
from vescale_tpu.moe import BasicExpertsAllocator as RBasic
from vescale_tpu.moe import ExpertsAllocator as RAlloc
from vescale_tpu.moe import MoEConfig as RMoEConfig
from vescale_tpu.moe import MoEMLP as RMoEMLP
from vescale_tpu.moe import MoEOptimizer as RMoEOptimizer
from vescale_tpu.moe import MoEParamBuffer as RMoEParamBuffer
from vescale_tpu.moe import TokenDispatcher as RTD

from vescale_tpu_torch.kernels import ulps_at_scale
from vescale_tpu_torch.models import load_params, params_from_jax
from vescale_tpu_torch.moe import (BasicExpertsAllocator, ExpertsAllocator, MoEConfig, MoEMLP,
                                   TokenDispatcher)

import torch_spmd_child as child

BF16_STEP = 65536.0  # one bf16 step in fp32 ulps at scale
Y_ULPS = {torch.float32: 8.0, torch.bfloat16: 2 * BF16_STEP}
GRAD_ULPS = {torch.float32: 16.0, torch.bfloat16: 4 * BF16_STEP}
AUX_ULPS = 2.0
OPT_TOL = 1e-6    # optax's sgd/adam against torch.optim.SGD / AdamWLowmem
LOOP_REL = 1e-5   # tests/test_moe.py:237's rtol


@pytest.fixture(scope="module")
def worlds():
    made = {n: child.World(n) for n in (2, 4)}  # both start together

    def get(n):
        return made[n]

    yield get
    for w in made.values():
        w.close()


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _routing(N, K, E, seed):
    """(gate_idx, gate_vals): each token's K distinct experts (the top-K of
    random scores) and random gate values."""
    rng = np.random.default_rng(seed)
    scores = rng.random((N, E)).astype(np.float32)
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :K].astype(np.int32)
    return idx, rng.random((N, K)).astype(np.float32), rng


@pytest.mark.parametrize("N,K,E,C,seed", [(16, 2, 4, 3, 0), (32, 2, 8, 4, 1), (10, 1, 4, 2, 2),
                                          (24, 2, 4, 30, 3)])
def test_masks_dispatch_and_combine_are_the_references(N, K, E, C, seed):
    idx, vals, rng = _routing(N, K, E, seed)
    ref, port = RTD(E, C), TokenDispatcher(E, C)
    disp_r, comb_r = ref.build_masks(jnp.asarray(idx), jnp.asarray(vals))
    disp, comb = port.build_masks(torch.from_numpy(idx), torch.from_numpy(vals))
    assert disp.dtype == comb.dtype == torch.float32
    assert np.array_equal(disp.numpy(), np.asarray(disp_r))
    assert np.array_equal(comb.numpy(), np.asarray(comb_r))
    x = rng.standard_normal((N, 6)).astype(np.float32)
    assert np.array_equal(port.dispatch(torch.from_numpy(x), disp).numpy(),
                          np.asarray(ref.dispatch(jnp.asarray(x), disp_r)))
    xb = params_from_jax({"x": jnp.asarray(x, jnp.bfloat16)}, device="cpu")["x"]
    assert np.array_equal(port.dispatch(xb, disp).float().numpy(),
                          _np(ref.dispatch(jnp.asarray(x, jnp.bfloat16), disp_r)))
    ye = rng.standard_normal((E, C, 6)).astype(np.float32)
    got = port.combine(torch.from_numpy(ye), comb).numpy()
    want = np.asarray(ref.combine(jnp.asarray(ye), comb_r))
    assert ulps_at_scale(got, want) <= 1.0
    if K == 1:  # one product a row: nothing to sum in another order
        assert np.array_equal(got, want)


def test_dropped_token_case_is_the_references():
    """tests/test_moe.py:146-162: three tokens to expert 0 (capacity 2),
    one to expert 1; the third is dropped: zero rows, zero output."""
    idx = np.array([[0], [0], [0], [1]], np.int32)
    vals = np.ones((4, 1), np.float32)
    x = np.arange(4, dtype=np.float32)[:, None] * np.ones((4, 3), np.float32)
    ref, port = RTD(num_experts=2, capacity=2), TokenDispatcher(num_experts=2, capacity=2)
    disp_r, comb_r = ref.build_masks(jnp.asarray(idx), jnp.asarray(vals))
    disp, comb = port.build_masks(torch.from_numpy(idx), torch.from_numpy(vals))
    assert tuple(disp.shape) == (4, 2, 2) and float(disp[2].sum()) == 0.0
    xe = port.dispatch(torch.from_numpy(x), disp)
    xe_r = ref.dispatch(jnp.asarray(x), disp_r)
    assert np.array_equal(xe.numpy(), np.asarray(xe_r))
    assert float(xe[0, 0, 0]) == 0.0 and float(xe[0, 1, 0]) == 1.0 and float(xe[1, 0, 0]) == 3.0
    y = port.combine(xe, comb)
    assert np.array_equal(y.numpy(), np.asarray(ref.combine(xe_r, comb_r)))
    assert float(y[3, 0]) == 3.0 and not y[2].any()


def test_capacity_and_allocators_are_the_references():
    for N in (1, 7, 10, 64, 4096):
        for E in (2, 4, 8):
            for K in (1, 2):
                for cf in (0.25, 1.0, 1.25, 2.0, 8.0):
                    assert (TokenDispatcher.capacity_for(N, E, K, cf)
                            == RTD.capacity_for(N, E, K, cf)), (N, E, K, cf)
    assert TokenDispatcher.capacity_for(10, 8, 2, 1.0) == 3  # tests/test_moe.py:177
    rng = np.random.default_rng(0)
    for E, ep in ((8, 4), (8, 2), (4, 4), (6, 4), (8, 3), (3, 4), (1, 1)):
        loads = [None, list(rng.random(E) * 10), [8.0, 8.0] + [1.0] * (E - 2) if E > 2 else None,
                 [0.0] * E, list(rng.zipf(1.5, E).astype(float))]
        for cls, rcls in ((ExpertsAllocator, RAlloc), (BasicExpertsAllocator, RBasic)):
            try:
                ref = rcls(E, ep)
            except ValueError:
                with pytest.raises(ValueError):
                    cls(E, ep)
                continue
            port = cls(E, ep)
            for load in loads:
                assert port.allocate(load) == ref.allocate(load), (cls.__name__, E, ep, load)
    with pytest.raises(ValueError, match="shape"):
        BasicExpertsAllocator(8, 4).allocate([1.0] * 7)


def _layer_case(swiglu, dtype, cf, seed=0):
    """The reference layer's weights and output on one input, and the port
    layer loaded with the same weights."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    fields = dict(num_experts=4, d_model=16, d_ff=32, top_k=2, capacity_factor=cf,
                  swiglu=swiglu)
    layer = RMoEMLP(RMoEConfig(**fields, dtype=jdt))
    x = jnp.asarray(np.random.default_rng(seed).standard_normal((2, 8, 16)), jdt)
    variables = jax.jit(layer.init)(jax.random.key(seed + 1), x)
    w = np.random.default_rng(seed + 5).standard_normal((2, 8, 16)).astype(np.float32)

    def loss(p):
        (y, aux), mut = layer.apply({"params": p}, x, mutable=["intermediates"])
        return jnp.sum(y.astype(jnp.float32) * w) + aux, (y, aux, mut["intermediates"]["expert_tokens"][0])

    (_, (y, aux, tokens)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    port = MoEMLP(MoEConfig(**fields, dtype=dtype), device="cpu")
    load_params(port, params_from_jax(variables["params"], device="cpu"))
    xt = params_from_jax({"x": x}, device="cpu")["x"]
    return port, xt, w, dict(y=_np(y), aux=float(aux), tokens=np.asarray(tokens),
                             grads={k: _np(v) for k, v in grads.items()})


@pytest.mark.parametrize("cf", [8.0, 1.0], ids=["no_drops", "drops"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("swiglu", [False, True], ids=["gelu", "swiglu"])
def test_moe_mlp_matches_the_reference(swiglu, dtype, cf):
    port, x, w, ref = _layer_case(swiglu, dtype, cf)
    for name in ("w_in", "b_in", "w_out", "b_out") + (("w_gate",) if swiglu else ()):
        assert getattr(port, name).dtype == dtype, name
    assert port.router.dtype == torch.float32
    y, aux = port(x)
    assert y.dtype == dtype and tuple(y.shape) == tuple(x.shape)
    assert np.array_equal(port.expert_tokens.numpy(), ref["tokens"])
    assert not port.expert_tokens.requires_grad
    assert ulps_at_scale(aux.detach().numpy(), np.float32(ref["aux"])) <= AUX_ULPS
    assert ulps_at_scale(y.float().detach().numpy(), ref["y"]) <= Y_ULPS[dtype]
    if cf == 1.0:  # C = ceil(2 * 16 / 4) = 8: some of the 32 (token, k) pairs drop
        assert int(port.expert_tokens.max()) > 8
    ((y.float() * torch.from_numpy(w)).sum() + aux).backward()
    for name, p in port.named_parameters():
        assert p.grad.dtype == p.dtype
        assert ulps_at_scale(p.grad.float().numpy(), ref["grads"][name]) <= GRAD_ULPS[dtype], name


def test_topk_ties_go_to_the_lower_expert():
    """``jax.lax.top_k`` breaks ties toward the lower index: a router of
    zeros gives every expert the same probability."""
    from vescale_tpu_torch.moe.layer import route

    x = torch.randn(5, 8)
    _, vals, idx = route(x, torch.zeros(8, 6), 3)
    assert idx.tolist() == [[0, 1, 2]] * 5
    ref = jax.lax.top_k(jax.nn.softmax(jnp.zeros((5, 6)), axis=-1), 3)[1]
    assert np.array_equal(idx.numpy(), np.asarray(ref))
    assert torch.allclose(vals, torch.full((5, 3), 1 / 3))


# --------------------------------------------------- the ragged buffer
def _ref_mesh(shape, names):
    return vt.DeviceMesh(tuple(names), tuple(shape))


def _ref_pieces(sharded, n):
    return {k: [np.asarray(d.to_local(r)).reshape(-1) for r in range(n)] for k, d in sharded.items()}


BUFFER_CASES = [
    ([2], ["ep"], (2, 2), (3, 1), None),
    ([2], ["ep"], (1, 3), (4, 0), None),
    ([4], ["ep"], (1, 1, 1, 1), (2, 1, 1, 0), None),  # tests/test_moe.py:110-127
    ([2, 2], ["ep", "tp"], (3, 1), (1, 3), "tp"),     # tests/test_moe.py:243-270 at tp=2
]


@pytest.mark.parametrize("mesh_shape,names,units,new_units,tp_dim", BUFFER_CASES,
                         ids=["ep2", "ep2_to_one_rank", "ep4", "ep2xtp2"])
def test_param_buffer_pieces_are_the_references(worlds, mesh_shape, names, units, new_units,
                                                 tp_dim):
    n = int(np.prod(mesh_shape))
    got = worlds(n).run("moe_buffer", mesh_shape=mesh_shape, names=names, units=list(units),
                        new_units=list(new_units), tp_dim=tp_dim)
    E = sum(units)
    full = {k: v.numpy() for k, v in child.moe_buffer_params(E, 0).items()}
    mesh = _ref_mesh(mesh_shape, names)
    buf = RMoEParamBuffer(mesh, "ep", E, units, tp_dim=tp_dim)
    sharded = buf.shard_params({k: jnp.asarray(v) for k, v in full.items()})
    new_buf, moved = buf.refresh(sharded, new_units)
    want, want_moved = _ref_pieces(sharded, n), _ref_pieces(moved, n)
    for r in range(n):
        for k in full:
            assert np.array_equal(got[r]["pieces"][k].reshape(-1), want[k][r]), (r, k)
            assert np.array_equal(got[r]["moved"][k].reshape(-1), want_moved[k][r]), (r, k)
            assert np.array_equal(got[r]["gathered"][k], full[k])
            assert np.array_equal(got[r]["gathered_moved"][k], full[k])
        assert tuple(got[r]["local"]) == buf.local_experts(r)
        assert tuple(got[r]["new_local"]) == new_buf.local_experts(r)


def test_all_to_all_dispatch_reshards_capacity_to_experts(worlds):
    """tests/test_moe.py:165-173 on a world of 4: the capacity axis's
    blocks in, each rank's experts out, values kept; the reference
    reshards its buffer to the same layout."""
    E, C, d = 4, 2, 3
    got = worlds(4).run("moe_a2a", E=E, C=C, d=d)
    full = np.arange(E * 4 * C * d, dtype=np.float32).reshape(E, 4 * C, d)
    mesh = _ref_mesh([4], ["ep"])
    ref = RTD(E, C, mesh).all_to_all_dispatch(jnp.asarray(full))
    assert ref.sharding.spec[0] == "ep"
    for r, g in enumerate(got):
        assert g["shape"] == [E, 4 * C, d] and g["placements"] == [["S", 0]]
        assert np.array_equal(g["local"], full[r:r + 1])
        assert np.array_equal(g["local"], np.asarray(ref.addressable_shards[r].data))


@pytest.mark.parametrize("inner", ["sgd", "adam"])
def test_moe_optimizer_step_and_refresh_are_the_references(worlds, inner):
    units, new_units = (1, 1, 1, 1), (2, 2, 0, 0)
    got = worlds(4).run("moe_optimizer", mesh_shape=[4], names=["ep"], units=list(units),
                        new_units=list(new_units), inner=inner)
    E = sum(units)
    mesh = _ref_mesh([4], ["ep"])
    buf = RMoEParamBuffer(mesh, "ep", E, units)
    jt = lambda tree: {k: jnp.asarray(v.numpy()) for k, v in tree.items()}
    sharded = buf.shard_params(jt(child.moe_buffer_params(E, 0)))
    tx = optax.sgd(0.1) if inner == "sgd" else optax.adam(child.MOE_LOOP_LR)
    opt = RMoEOptimizer(tx, buf)
    state = opt.init(sharded)
    for i in range(2):
        grads = opt.buffer.shard_params(jt(child.moe_buffer_params(E, 10 + i)))
        sharded, state = opt.step(sharded, state, grads)
        want = _ref_pieces(sharded, 4)
        for r in range(4):
            for k in want:
                np.testing.assert_allclose(got[r][f"step{i}"][k].reshape(-1), want[k][r],
                                           rtol=OPT_TOL, atol=OPT_TOL)
        if inner == "adam":
            adam = state[0]
            for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
                ref = _ref_pieces(tree, 4)
                for r in range(4):
                    for k in ref:
                        np.testing.assert_allclose(got[r][f"state{i}"][key][k].reshape(-1),
                                                   ref[k][r], rtol=OPT_TOL, atol=1e-9)
        if i == 0:
            _, sharded, state = opt.refresh(sharded, state, new_units)
            moved = _ref_pieces(sharded, 4)
            for r in range(4):
                for k in moved:
                    assert got[r]["refreshed"][k].size == moved[k][r].size
                    np.testing.assert_allclose(got[r]["refreshed"][k].reshape(-1), moved[k][r],
                                               rtol=OPT_TOL, atol=OPT_TOL)
    assert {g["step_count"] for g in got} == ({None} if inner == "sgd" else {2})
    if inner == "adam":  # the moments moved with their parameters
        assert all(g["refreshed_state"]["exp_avg"]["w_in"].size == g["refreshed"]["w_in"].size
                   for g in got)


def _reference_losses(params0, x):
    """The losses of tests/test_moe.py:181-240's loop in the reference: its
    ``MoEMLP`` trained by ``optax.adam(1e-2)`` on the expert and router
    parts.  The buffer and the refresh are left out: that test holds
    them to change the layout only (losses within 1e-5 with and without a
    refresh), and the reference's ragged buffer steps eagerly, ~10 s a
    run on the CPU."""
    layer = RMoEMLP(RMoEConfig(**child.MOE_LOOP))
    keys = [k for k in params0 if k != "router"]
    tx = optax.adam(child.MOE_LOOP_LR)

    @jax.jit
    def step(params, states):
        def loss_fn(p):
            y, aux = layer.apply({"params": p}, x)
            return jnp.mean((y - x) ** 2) + aux

        loss, grads = jax.value_and_grad(loss_fn)(params)
        out, new_states = dict(params), []
        for part, st in zip((keys, ["router"]), states):
            upd, st = tx.update({k: grads[k] for k in part}, st, {k: params[k] for k in part})
            out.update(optax.apply_updates({k: params[k] for k in part}, upd))
            new_states.append(st)
        return out, tuple(new_states), loss

    params = dict(params0)
    states = (tx.init({k: params[k] for k in keys}), tx.init({"router": params["router"]}))
    losses = []
    for _ in range(6):
        params, states, loss = step(params, states)
        losses.append(float(loss))
    return losses


def test_load_aware_refresh_leaves_the_run_bitwise_unchanged(worlds):
    cfg = RMoEConfig(**child.MOE_LOOP)
    layer = RMoEMLP(cfg)
    x = jax.random.normal(jax.random.key(0), (4, 16, cfg.d_model))
    params0 = dict(layer.init(jax.random.key(1), x)["params"])
    params0["router"] = params0["router"].at[:, 0].add(4.0)  # expert 0 in every top-k
    got = worlds(4).run("moe_loop",
                        params=child.to_wire({k: np.asarray(v) for k, v in params0.items()}),
                        x=child.to_wire(np.asarray(x)))
    ref = _reference_losses(params0, x)
    for r in got:
        base, re = r["base"], r["re"]
        assert len(re["units"]) == 2 and re["units"][1] != re["units"][0], re["units"]
        assert base["losses"] == re["losses"]  # bitwise: the floats as read
        for k in base["params"]:
            assert np.array_equal(base["params"][k], re["params"][k]), k
        for key in base["moments"]:
            for k in base["moments"][key]:
                assert np.array_equal(base["moments"][key][k], re["moments"][key][k]), (key, k)
        assert base["step"] == re["step"] == 6
        assert base["losses"][-1] < base["losses"][0]
    assert all(r["base"]["losses"] == got[0]["base"]["losses"] for r in got)
    np.testing.assert_allclose(got[0]["re"]["losses"], ref, rtol=LOOP_REL, atol=1e-6)
