"""The port's fused AdamW and optimizers against the JAX package, on the CPU.

On CPU tensors ``kernels.fused_adamw_update`` runs its plain version,
``fused_adamw_reference``; these tests hold it to the reference chain of
``vescale_tpu/parallel/optimizer.py::scale_by_adam_lowmem`` run op by op
in jnp, to the JAX package's Pallas kernel run through the interpreter,
and ``AdamWLowmem`` to ``adamw_lowmem`` applied with optax.  The CUDA
kernel is held to the plain version on the card by ``chip_smoke.py``.
Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from vescale_tpu.kernels.fused_adamw import fused_adamw_update as jax_fused_adamw_update
from vescale_tpu.parallel import optimizer as jopt

from vescale_tpu_torch import kernels
from vescale_tpu_torch.kernels.fused_adamw import fused_adamw_reference, fused_adamw_update
from vescale_tpu_torch.parallel import (
    AdamWLowmem,
    BasicOptimizer,
    clip_grad_norm_fp32,
    found_inf,
)
from vescale_tpu_torch.parallel.optimizer import bias_corrections

B1, B2, EPS = 0.9, 0.999, 1e-8
U_ULPS = 4.0  # docs/kernels.md: the update's bound; the moments are bitwise

STATE = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


def ulps_elementwise(a, b) -> float:
    """Max per-element fp32 ulp distance, each element at its own spacing
    (``tests/test_kernels.py``'s metric for the update); NaN patterns must
    agree."""
    a32 = np.asarray(a, np.float32).ravel()
    b32 = np.asarray(b, np.float32).ravel()
    if not np.array_equal(np.isnan(a32), np.isnan(b32)):
        return float("inf")
    fin = np.isfinite(a32) & np.isfinite(b32)
    if not fin.any():
        return 0.0
    step = np.spacing(np.abs(b32[fin]).astype(np.float32))
    return float(np.max(np.abs(a32[fin].astype(np.float64) - b32[fin]) / step))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _bits_equal(t: torch.Tensor, j) -> bool:
    return np.array_equal(_np(t).view(np.uint32), _np(j).view(np.uint32))


def _leaf(n, state, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n,)).astype(np.float32)
    m = rng.normal(size=(n,)).astype(np.float32)
    v = np.abs(rng.normal(size=(n,))).astype(np.float32)
    jdt, tdt = STATE[state]
    jx = [jnp.asarray(g), jnp.asarray(m).astype(jdt), jnp.asarray(v).astype(jdt)]
    tx = [torch.from_numpy(g), torch.from_numpy(m).to(tdt), torch.from_numpy(v).to(tdt)]
    return jx, tx


def _jax_chain(g, m, v, count, state_dtype):
    """The reference chain of ``scale_by_adam_lowmem``, op by op, eager."""
    c1 = 1.0 - B1 ** jnp.asarray(count, jnp.float32)
    c2 = 1.0 - B2 ** jnp.asarray(count, jnp.float32)
    g32 = g.astype(jnp.float32)
    m32 = B1 * m.astype(jnp.float32) + (1.0 - B1) * g32
    v32 = B2 * v.astype(jnp.float32) + (1.0 - B2) * jnp.square(g32)
    u = ((m32 / c1) / (jnp.sqrt(v32 / c2) + EPS)).astype(g.dtype)
    return u, m32.astype(state_dtype), v32.astype(state_dtype)


@pytest.mark.parametrize("state", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [1, 255, 256, 257])
def test_reference_matches_the_jax_chain(n, state):
    (jg, jm, jv), (tg, tm, tv) = _leaf(n, state, n)
    ju, jmo, jvo = _jax_chain(jg, jm, jv, 5, STATE[state][0])
    c1, c2 = bias_corrections(B1, B2, 5)
    us, ms, vs = fused_adamw_reference([tg], [tm], [tv], c1, c2, b1=B1, b2=B2, eps=EPS)
    assert ms[0].dtype == STATE[state][1] and us[0].dtype == torch.float32
    assert _bits_equal(ms[0], jmo) and _bits_equal(vs[0], jvo)
    assert ulps_elementwise(us[0].numpy(), np.asarray(ju)) <= U_ULPS


@pytest.mark.parametrize("state", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 4099])
def test_matches_the_interpreted_pallas_kernel(n, state):
    """The JAX package's kernel (K8) through the interpreter, called with
    the same fp32 c1/c2.  It is not bitwise with its own chain: XLA compiles
    the interpreted body as one fused program and contracts b1 * m + (1 -
    b1) * g into an FMA, one rounding where the chain has two.  Measured
    bound: bf16 moments bitwise (the bf16 rounding absorbs it); fp32
    moments within 1 ulp at scale (elementwise, hundreds of ulps where the
    sum cancels to near zero); u within 2 ulps at scale.  The port equals
    the chain run op by op exactly (test above)."""
    from vescale_tpu_torch.kernels import ulps_at_scale

    (jg, jm, jv), (tg, tm, tv) = _leaf(n, state, 1000 + n)
    c1, c2 = bias_corrections(B1, B2, 3)
    ju, jmo, jvo = jax_fused_adamw_update(
        jg, jm, jv, jnp.float32(c1), jnp.float32(c2), b1=B1, b2=B2, eps=EPS,
        state_dtype=STATE[state][0], interpret=True)
    us, ms, vs = fused_adamw_update([tg], [tm], [tv], c1, c2, b1=B1, b2=B2, eps=EPS)
    if state == "bfloat16":
        assert _bits_equal(ms[0], jmo) and _bits_equal(vs[0], jvo)
    else:
        assert ulps_at_scale(ms[0].numpy(), _np(jmo)) <= 1.0
        assert ulps_at_scale(vs[0].numpy(), _np(jvo)) <= 1.0
    assert ulps_at_scale(us[0].numpy(), _np(ju)) <= 2.0


def test_bias_corrections_match_the_reference_in_fp32():
    for count in (1, 2, 10, 1000):
        c1 = float(1.0 - B1 ** jnp.asarray(count, jnp.float32))
        c2 = float(1.0 - B2 ** jnp.asarray(count, jnp.float32))
        t1, t2 = bias_corrections(B1, B2, count)
        # both in fp32; a pow of another library may round the last bit apart
        assert abs(t1 - c1) <= np.spacing(np.float32(c1)) and abs(t2 - c2) <= np.spacing(np.float32(c2))


def test_nan_poisons_its_element_only():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(37,)).astype(np.float32))
    g[5] = float("nan")
    m = torch.from_numpy(rng.normal(size=(37,)).astype(np.float32)).bfloat16()
    v = torch.from_numpy(np.abs(rng.normal(size=(37,))).astype(np.float32)).bfloat16()
    outs = fused_adamw_update([g, torch.ones(4)], [m, torch.zeros(4, dtype=torch.bfloat16)],
                              [v, torch.zeros(4, dtype=torch.bfloat16)], 0.5, 0.1,
                              b1=B1, b2=B2, eps=EPS)
    for out in outs:
        assert torch.nonzero(torch.isnan(out[0].float())).flatten().tolist() == [5]
        assert not torch.isnan(out[1].float()).any()


def test_many_leaves_odd_and_empty():
    shapes = [(0,), (1,), (3, 5), (2, 0, 4), (129,)]
    rng = np.random.default_rng(4)
    gs = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in shapes]
    ms = [torch.zeros(s, dtype=torch.bfloat16) for s in shapes]
    vs = [torch.zeros(s, dtype=torch.bfloat16) for s in shapes]
    us, mo, vo = fused_adamw_update(gs, ms, vs, 0.1, 0.001, b1=B1, b2=B2, eps=EPS)
    for g, u, m2, v2 in zip(gs, us, mo, vo):
        assert u.shape == g.shape and m2.shape == g.shape and v2.dtype == torch.bfloat16
    assert fused_adamw_update([], [], [], 0.1, 0.1, b1=B1, b2=B2, eps=EPS) == ([], [], [])
    with pytest.raises(ValueError, match="grads"):
        fused_adamw_update(gs, ms[:1], vs, 0.1, 0.1, b1=B1, b2=B2, eps=EPS)
    assert kernels.LAUNCHES["fused_adamw"] == 0  # CPU tensors: the plain version


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(17, 9)).astype(np.float32),
            "b": {"w": rng.normal(size=(33,)).astype(np.float32),
                  "s": rng.normal(size=(1,)).astype(np.float32)}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("state", ["bfloat16", "float32"])
def test_adamw_lowmem_three_steps_match_optax(state):
    """Three steps from the same params and grads.  Bound: params within 2
    ulps at scale and moments bitwise.  The two run the same fp32 ops in the
    same order; c1/c2 come from two libraries' fp32 pow, which may round
    the last bit apart and move u (never the moments) by an ulp."""
    from vescale_tpu_torch.kernels import ulps_at_scale

    jdt, tdt = STATE[state]
    params = _tree(0)
    tx = jopt.adamw_lowmem(3e-3, state_dtype=jdt)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jp)
    names = list(_flat(params))
    tparams = [torch.nn.Parameter(torch.from_numpy(_flat(params)[n].copy())) for n in names]
    opt = AdamWLowmem(tparams, 3e-3, state_dtype=tdt)
    for step in range(3):
        grads = _tree(10 + step)
        jg = jax.tree_util.tree_map(jnp.asarray, grads)
        upd, jstate = tx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, n in zip(tparams, names):
            p.grad = torch.from_numpy(_flat(grads)[n].copy())
        opt.step()
    jflat = _flat(jp)
    mu, nu = _flat(jstate[0].mu), _flat(jstate[0].nu)
    for p, n in zip(tparams, names):
        assert ulps_at_scale(p.detach().numpy(), np.asarray(jflat[n])) <= 2.0
        st = opt.state[p]
        assert st["exp_avg"].dtype == tdt
        assert _bits_equal(st["exp_avg"], mu[n]) and _bits_equal(st["exp_avg_sq"], nu[n])
    assert opt.param_groups[0]["step"] == 3 and int(jstate[0].count) == 3



def test_adamw_lowmem_steps_a_leaf_without_grad_as_the_reference_does():
    """Two 8-element leaves from numpy seed 0; the loss reads only ``w``, so
    torch leaves ``u.grad`` None where ``jax.grad`` gives ``u`` zeros.  The
    reference still decays u's moments and applies weight decay to it; the
    port must step it the same.  Three steps at lr 1e-2, weight decay 0.1,
    bf16 moments.  Bounds as in the three-step test above: params within 2
    ulps at scale, moments bitwise, step counts equal."""
    from vescale_tpu_torch.kernels import ulps_at_scale

    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(8,)).astype(np.float32),
              "u": rng.normal(size=(8,)).astype(np.float32)}
    tx = jopt.adamw_lowmem(1e-2, weight_decay=0.1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jp)
    grad = jax.grad(lambda t: jnp.sum(jnp.square(t["w"])))
    tw, tu = (torch.nn.Parameter(torch.from_numpy(params[n].copy())) for n in ("w", "u"))
    opt = AdamWLowmem([tw, tu], lr=1e-2, weight_decay=0.1)
    for _ in range(3):
        upd, jstate = tx.update(grad(jp), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad(set_to_none=True)
        torch.sum(torch.square(tw)).backward()
        assert tu.grad is None
        opt.step()
    assert not np.array_equal(np.asarray(jp["u"]), params["u"])  # the reference moves u
    for p, n in ((tw, "w"), (tu, "u")):
        assert ulps_at_scale(p.detach().numpy(), np.asarray(jp[n])) <= 2.0, n
        st = opt.state[p]
        assert _bits_equal(st["exp_avg"], jstate[0].mu[n]), n
        assert _bits_equal(st["exp_avg_sq"], jstate[0].nu[n]), n
    assert opt.param_groups[0]["step"] == 3 and int(jstate[0].count) == 3

def test_clip_grad_norm_matches_reference():
    grads = _tree(3)
    grads["a"] = grads["a"] * 1e3
    leaves = [grads["a"], grads["b"]["w"], grads["b"]["s"]]
    for max_norm, norm_type in ((1.0, 2), (1e9, 2), (5.0, 1)):
        ref, ref_total = jopt.clip_grad_norm_fp32([jnp.asarray(x) for x in leaves], max_norm, norm_type)
        got, total = clip_grad_norm_fp32([torch.from_numpy(x.copy()) for x in leaves], max_norm, norm_type)
        assert abs(float(total) - float(ref_total)) <= 4 * np.spacing(np.float32(float(ref_total)))
        for g, r in zip(got, ref):
            assert np.allclose(g.numpy(), np.asarray(r), rtol=4e-7, atol=0)
    bf = [torch.ones(3, dtype=torch.bfloat16) * 7]
    clipped, _ = clip_grad_norm_fp32(bf, 1.0)
    assert clipped[0].dtype == torch.bfloat16


def test_found_inf_matches_reference():
    for bad in (None, float("nan"), float("inf"), -float("inf")):
        leaves = [np.ones((3,), np.float32), np.zeros((2, 2), np.float32)]
        if bad is not None:
            leaves[1][1, 0] = bad
        ref = bool(jopt.found_inf([jnp.asarray(x) for x in leaves]))
        assert bool(found_inf([torch.from_numpy(x) for x in leaves])) == ref == (bad is not None)
    assert bool(found_inf([])) is False


def test_basic_optimizer_clips_before_the_step():
    p = torch.nn.Parameter(torch.ones(4))
    opt = BasicOptimizer(torch.optim.SGD([p], lr=1.0), grad_clip=1.0)
    p.grad = torch.full((4,), 10.0)
    opt.step()
    # |g| = 20 clipped to norm 1: each element 0.5, less the rounding of 1e-6
    assert torch.allclose(p.detach(), torch.full((4,), 0.5), atol=1e-6)
    opt.zero_grad()
    assert p.grad is None
