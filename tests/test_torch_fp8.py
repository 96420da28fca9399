"""The port's fp8 training (``vescale_tpu_torch.quant.fp8``, the
``use_fp8`` Llama and the train step's fp8 state) against the JAX
reference on the same numpy-seeded inputs, on the CPU, where every fp8
product is the plain upcast-and-matmul.

Held:

  * ``fp8_dot`` (the reference's ``quant/fp8.py``): the x, w and g
    histories and the scales they give bitwise; y within 4 fp32 ulps at
    scale and dx, dw within 8 (measured 1 and 2: the fp8 products are
    exact in fp32, their sums run in another order); the non-finite
    guard; dw in fp32 for fp32 weights beside bf16 activations; the
    reference's own accuracy and training checks (tests/test_fp8.py);
  * the module op, flax's ``Fp8DirectDotGeneralOp`` inside ``nn.Dense``,
    in bf16 and fp32: all six new state leaves bitwise, and y, dx and dk
    bitwise in bf16 and within 2 fp32 ulps at scale in fp32 (measured 1:
    the order of the fp32 sums shows only there);
  * ``Llama(use_fp8=True)`` from ``params_from_jax`` of the flax
    variables (fp32 compute): logits, parameter grads and the whole
    ``_overwrite_with_gradient`` tree of "grads" against ``jax.grad``,
    and three ``make_train_step`` steps (plain, grad accumulation of 2,
    ``scan_layers``): losses, parameters and the state tree against the
    reference ``make_train_step``.  The fp8 quantize turns a one-ulp
    difference upstream into a whole e4m3 step when a value sits at a
    rounding edge, so the bounds here are those of the unquantized
    model's comparisons (tests/test_torch_train.py) with the gap
    measured below each;
  * a forward-only call leaves the state unchanged, with and without
    grad mode, as flax's apply does;
  * a model moved by ``Module.to`` trains its state as before the move,
    and a state leaf that gets no gradient raises in the step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flax.linen as nn

from vescale_tpu.models import llama as jl
from vescale_tpu.models.nanogpt import cross_entropy_loss as jax_xent
from vescale_tpu.parallel.optimizer import adamw_lowmem
from vescale_tpu.quant import fp8 as RF
from vescale_tpu.train import make_train_step as jax_make_train_step

from vescale_tpu_torch.kernels import ulps_at_scale
from vescale_tpu_torch.models import Llama, LlamaConfig, module_tree, params_from_jax
from vescale_tpu_torch.models.llama import Dense
from vescale_tpu_torch.models.nanogpt import cross_entropy_loss
from vescale_tpu_torch.parallel import AdamWLowmem
from vescale_tpu_torch.quant import fp8 as PF
from vescale_tpu_torch.train import make_train_step

from test_torch_ndtimeline import reset_all

OWG = "_overwrite_with_gradient"
Y_ULPS, DXW_ULPS = 4.0, 8.0
LOGIT_ULPS, GRAD_ULPS = 32.0, 64.0  # tests/test_torch_train.py's bounds
STATE_REL = 2e-6  # an amax history entry or a scale, relative (measured <= 6.1e-7)
LOSS_RTOL = 1e-5  # three steps' losses (tests/test_torch_train.py's trajectory bound)
# parameters after three AdamW(3e-4) steps: an element whose gradient is a
# rounding away from zero moves by up to lr a step either way (measured
# <= 2.8e-5; losses measured within 1.1e-7)
PARAM_ATOL = 3e-4

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=32)
B, T = 2, 16


@pytest.fixture(autouse=True)
def kernels_unset(monkeypatch):
    monkeypatch.delenv("VESCALE_KERNELS", raising=False)
    reset_all()
    yield
    reset_all()


# ------------------------------------------------------------- fp8_dot
def _dot_inputs(seed=0, hist_len=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((32, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 16)) * 0.1).astype(np.float32)
    gy = rng.standard_normal((32, 16)).astype(np.float32)
    hist = [(np.abs(rng.standard_normal(hist_len)) * s).astype(np.float32) for s in (3.0, 0.3, 2.0)]
    return x, w, gy, hist


def _ref_dot(x, w, gy, hist):
    st = RF.Fp8DotState(*(RF.Fp8TensorState(jnp.asarray(h)) for h in hist))

    def f(x, w, st):
        y, st2 = RF.fp8_dot(x, w, st)
        return jnp.sum(y.astype(jnp.float32) * gy), (y, st2)

    (_, (y, fwd)), (gx, gw, gst) = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), st)
    return y, gx, gw, fwd, gst


def _port_dot(x, w, gy, hist, x_dtype=torch.float32):
    st = PF.Fp8DotState(*(PF.Fp8TensorState(torch.from_numpy(h.copy()).requires_grad_(True))
                          for h in hist))
    xt = torch.from_numpy(x).to(x_dtype).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y, fwd = PF.fp8_dot(xt, wt, st)
    (y.float() * torch.from_numpy(gy)).sum().backward()
    return y, xt.grad, wt.grad, fwd, PF.fp8_state_grads(st)


def test_fp8_dot_matches_the_reference():
    x, w, gy, hist = _dot_inputs()
    y, gx, gw, fwd, gst = _ref_dot(x, w, gy, hist)
    py, pgx, pgw, pfwd, pgst = _port_dot(x, w, gy, hist)
    assert ulps_at_scale(py.detach().numpy(), np.asarray(y)) <= Y_ULPS
    assert ulps_at_scale(pgx.numpy(), np.asarray(gx)) <= DXW_ULPS
    assert ulps_at_scale(pgw.numpy(), np.asarray(gw)) <= DXW_ULPS
    merged, pmerged = RF.merge_fp8_state(fwd, gst), PF.merge_fp8_state(pfwd, pgst)
    for a, b in zip(pmerged, merged):
        np.testing.assert_array_equal(a.amax_history.detach().numpy(), np.asarray(b.amax_history))
    # the delayed scales the merged state gives next step
    for a, b, fmax in zip(pmerged, merged, (RF.E4M3_MAX, RF.E4M3_MAX, RF.E5M2_MAX)):
        np.testing.assert_array_equal(PF._delayed_scale(a.amax_history, fmax).numpy(),
                                      np.asarray(RF._delayed_scale(b, fmax)))
    assert pmerged.g.amax_history[0] == float(np.abs(gy).max())
    assert pmerged.x.amax_history[0] == float(np.abs(x).max())


def test_fp8_dot_first_steps_and_accuracy():
    """tests/test_fp8.py's accuracy check, step for step against the
    reference: scale 1.0 on the empty history, then calibrated."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 16)) * 0.1).astype(np.float32)
    rst, pst = RF.init_fp8_dot_state(), PF.init_fp8_dot_state()
    for _ in range(2):
        ry, rst = RF.fp8_dot(jnp.asarray(x), jnp.asarray(w), rst)
        py, pst = PF.fp8_dot(torch.from_numpy(x), torch.from_numpy(w), pst)
        assert ulps_at_scale(py.detach().numpy(), np.asarray(ry)) <= Y_ULPS
        for a, b in zip(pst, rst):
            np.testing.assert_array_equal(a.amax_history.detach().numpy(),
                                          np.asarray(b.amax_history))
    rel = np.abs(py.detach().numpy() - x @ w) / (np.abs(x @ w) + 1e-3)
    assert float(np.median(rel)) < 0.05


def test_fp8_dot_guard_and_primal_dtypes():
    x, w, gy, hist = _dot_inputs(1)
    y, gx, gw, fwd, gst = _port_dot(x, w, gy, hist, x_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16 and gx.dtype == torch.bfloat16
    assert gw.dtype == torch.float32  # fp32 masters keep an fp32 dw
    bad = PF.Fp8DotState(gst.x, gst.w, PF.Fp8TensorState(gst.g.amax_history.clone()))
    bad.g.amax_history[0] = float("inf")
    bad.g.amax_history[3] = float("nan")
    safe = PF.merge_fp8_state(fwd, bad)
    assert torch.isfinite(safe.g.amax_history).all()
    ref = RF.merge_fp8_state(
        RF.Fp8DotState(*(RF.Fp8TensorState(jnp.asarray(s.amax_history.detach().numpy()))
                         for s in fwd)),
        RF.Fp8DotState(*(RF.Fp8TensorState(jnp.asarray(s.amax_history.detach().numpy()))
                         for s in bad)))
    np.testing.assert_array_equal(safe.g.amax_history.detach().numpy(),
                                  np.asarray(ref.g.amax_history))
    # a non-finite amax in the forward repeats the newest entry
    xi = torch.from_numpy(x).clone()
    xi[0, 0] = float("inf")
    _, fwd_inf = PF.fp8_dot(xi, torch.from_numpy(w), PF.init_fp8_dot_state())
    assert fwd_inf.x.amax_history[0] == 0.0


def test_fp8_training_tracks_fp32():
    """tests/test_fp8.py's regression net: the fp8 run trains and tracks
    the exact-matmul run within 10% (the reference's bar)."""
    rng = np.random.default_rng(2)
    X = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
    Wtrue = (rng.normal(size=(32, 8)) * 0.5).astype(np.float32)
    Y = X @ torch.from_numpy(Wtrue) + 0.01 * torch.from_numpy(
        rng.normal(size=(64, 8)).astype(np.float32))
    W0 = (rng.normal(size=(32, 8)) * 0.1).astype(np.float32)

    def run(fp8: bool, steps=20):
        w = torch.from_numpy(W0.copy()).requires_grad_(True)
        opt = torch.optim.SGD([w], lr=5e-2)
        state, losses = PF.init_fp8_dot_state(), []
        for _ in range(steps):
            opt.zero_grad()
            y, fwd = PF.fp8_dot(X, w, state) if fp8 else (X @ w, None)
            loss = ((y - Y) ** 2).mean()
            loss.backward()
            opt.step()
            if fp8:
                state = PF.merge_fp8_state(fwd, PF.fp8_state_grads(state))
            losses.append(float(loss))
        return losses

    l8, l32 = run(True), run(False)
    assert l8[-1] < l8[0] * 0.7
    assert abs(l8[-1] - l32[-1]) / l32[-1] < 0.1


# ------------------------------------------------- the module op (flax's)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dense_op_is_flax_bitwise(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    k = (rng.standard_normal((32, 48)) * 0.2).astype(np.float32)
    gy = rng.standard_normal((2, 16, 48)).astype(np.float32)
    hist = {n: (np.abs(rng.standard_normal(1024)) * s).astype(np.float32)
            for n, s in (("input_amax_history", 3.0), ("kernel_amax_history", 0.5),
                         ("output_grad_amax_history", 2.0))}
    scales = {n: np.array([s], np.float32) for n, s in (("input_scale", 0.01),
                                                         ("kernel_scale", 0.002),
                                                         ("output_grad_scale", 1e-4))}
    state = {**hist, **scales}
    jd = getattr(jnp, dtype)
    d = nn.Dense(48, use_bias=False, dtype=jd, dot_general_cls=nn.Fp8DirectDotGeneralOp)

    def f(xx, params, st):
        y = d.apply({"params": params, OWG: {"Fp8DirectDotGeneralOp_0": st}}, xx)
        return jnp.sum(y.astype(jnp.float32) * gy), y

    xj = jnp.asarray(x, jd)
    (_, y), (gx, gp, gst) = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        xj, {"kernel": jnp.asarray(k)}, {n: jnp.asarray(v) for n, v in state.items()})

    td = getattr(torch, dtype)
    m = Dense(32, 48, td, device="cpu", fp8=True)
    with torch.no_grad():
        m.kernel.copy_(torch.from_numpy(k))
        for n, v in state.items():
            getattr(m.fp8, n).copy_(torch.from_numpy(v))
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(td).requires_grad_(True)
    yt = m(xt)
    (yt.float() * torch.from_numpy(gy)).sum().backward()

    def eq(a, b, ulps=0.0):
        a, b = a.detach().float().numpy(), np.asarray(b, np.float32)
        if ulps:
            assert ulps_at_scale(a, b) <= ulps
        else:
            np.testing.assert_array_equal(a, b)

    # bf16 rounds the fp32 sum once, so the sums' order cannot show; fp32
    # keeps it (measured 1 ulp)
    prod_ulps = 0.0 if dtype == "bfloat16" else 2.0
    eq(yt, y, prod_ulps)
    eq(xt.grad, gx, prod_ulps)
    eq(m.kernel.grad, gp["kernel"], prod_ulps)
    for n in PF.FP8_LEAVES:
        eq(getattr(m.fp8, n).grad, gst[n])
        assert not np.array_equal(np.asarray(gst[n]), state[n])  # every leaf moved


# ------------------------------------------------------ the fp8 Llama
def _jax_model(scan=False, seed=0):
    cfg = jl.LlamaConfig(dtype=jnp.float32, use_fp8=True, scan_layers=scan, **CFG)
    model = jl.Llama(cfg)
    variables = model.init(jax.random.key(seed), jnp.ones((B, T), jnp.int32))
    return model, {"params": variables["params"], OWG: variables[OWG]}


def _port_model(bundle, scan=False):
    cfg = LlamaConfig(dtype=torch.float32, use_fp8=True, scan_layers=scan, **CFG)
    return Llama(cfg, params_from_jax(bundle, device="cpu"), device="cpu")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _tokens(seed=0, rows=B):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], (rows, T + 1))


def _state_close(got: dict, want: dict) -> float:
    """The largest relative gap of any state leaf; histories and scales
    are amax values or amax / fp8 max, so relative is the measure."""
    assert set(got) == set(want)
    worst = 0.0
    for key, a in got.items():
        b = want[key]
        assert a.shape == b.shape, key
        assert np.isfinite(a).all()
        denom = np.maximum(np.abs(b), 1e-30)
        worst = max(worst, float(np.max(np.abs(a - b) / denom)))
    return worst


def test_llama_fp8_logits_grads_and_state_match_flax():
    model, bundle = _jax_model()
    toks = _tokens()[:, :-1]

    def loss(p, st):
        lg = model.apply({"params": p, OWG: st}, jnp.asarray(toks))
        return jnp.mean(lg.astype(jnp.float32) ** 2), lg

    (_, lg), (gp, gst) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        bundle["params"], bundle[OWG])
    m = _port_model(bundle)
    out = m(torch.from_numpy(toks))
    (out.float() ** 2).mean().backward()
    assert ulps_at_scale(out.detach().numpy(), np.asarray(lg)) <= LOGIT_ULPS
    ref = _flat(gp)
    for name, p in m.named_parameters():
        assert ulps_at_scale(p.grad.numpy(), ref[name]) <= GRAD_ULPS, name
    got = {n: b.grad.numpy() for n, b in PF.owg_buffers(m).items()}
    assert _state_close(got, _flat(gst)) <= STATE_REL


def _jax_steps(bundle, model, steps, grad_accum, rows):
    tx = adamw_lowmem(3e-4)
    step = jax_make_train_step(model, tx, lambda lg, b: jax_xent(lg, b["target"]),
                               grad_accum_steps=grad_accum, donate=False)
    toks = jnp.asarray(_tokens(1, rows))
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
    p, s, losses = bundle, tx.init(bundle["params"]), []
    for _ in range(steps):
        p, s, loss = step(p, s, batch)
        losses.append(float(loss))
    return p, losses


def _port_steps(model, steps, grad_accum, rows):
    opt = AdamWLowmem(model.parameters(), 3e-4)
    step = make_train_step(model, opt, lambda lg, b: cross_entropy_loss(lg, b["target"]),
                           grad_accum_steps=grad_accum)
    toks = torch.from_numpy(_tokens(1, rows))
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
    return [float(step(batch)) for _ in range(steps)]


@pytest.mark.parametrize("grad_accum,scan", [(1, False), (2, False), (1, True)])
def test_three_train_steps_match_the_reference(grad_accum, scan):
    model, bundle = _jax_model(scan)
    p_ref, l_ref = _jax_steps(bundle, model, 3, grad_accum, 2 * grad_accum)
    m = _port_model(bundle, scan)
    l_got = _port_steps(m, 3, grad_accum, 2 * grad_accum)
    np.testing.assert_allclose(l_got, l_ref, rtol=LOSS_RTOL, atol=0)
    tree = module_tree(m)
    ref_params = _flat(p_ref["params"])
    for key, a in _flat(tree["params"]).items():
        np.testing.assert_allclose(a, ref_params[key], rtol=0, atol=PARAM_ATOL, err_msg=key)
    got_state, ref_state = _flat(tree[OWG]), _flat(p_ref[OWG])
    assert _state_close(got_state, ref_state) <= STATE_REL
    # three steps put three amax values into every history: flax rolls by
    # -1 and then sets [0], so the older two sit at the end
    for key, a in got_state.items():
        if key.endswith("amax_history"):
            assert (a[..., [0, -2, -1]] > 0).all() and (a[..., 1:-2] == 0).all(), key


def test_forward_only_leaves_the_state_unchanged():
    _, bundle = _jax_model()
    m = _port_model(bundle)
    before = {n: b.detach().clone() for n, b in PF.owg_buffers(m).items()}
    toks = torch.from_numpy(_tokens()[:, :-1])
    with torch.no_grad():
        m(toks)
    m(toks)  # grad mode, no backward
    for n, b in PF.owg_buffers(m).items():
        assert torch.equal(b, before[n]) and b.grad is None, n


@pytest.mark.parametrize("scan", [False, True])
def test_a_moved_model_trains_its_state(scan):
    """``Module.to`` keeps each fp8 state leaf (the same tensor, a leaf in
    fp32), so a model moved through another dtype trains as the unmoved
    one: the same losses and state, every history filled."""
    _, bundle = _jax_model(scan)
    still, moved = _port_model(bundle, scan), _port_model(bundle, scan)
    moved.to(torch.float64).to(torch.float32)
    for b in PF.owg_buffers(moved).values():
        assert b.is_leaf and b.requires_grad and b.dtype == torch.float32
    assert _port_steps(moved, 2, 1, 2) == _port_steps(still, 2, 1, 2)
    got, want = _flat(module_tree(moved)[OWG]), _flat(module_tree(still)[OWG])
    for key, a in got.items():
        np.testing.assert_array_equal(a, want[key], err_msg=key)
        if key.endswith("amax_history"):
            assert (a[..., [0, -1]] > 0).all(), key


def test_a_state_leaf_without_a_gradient_raises():
    """A state buffer the backward cannot reach (here swapped for a
    non-leaf) raises in the step instead of staying at its start."""
    _, bundle = _jax_model()
    m = _port_model(bundle)
    name = next(iter(PF.owg_buffers(m)))
    owner, leaf = name.rsplit(".", 1)
    op = m.get_submodule(owner)
    op._buffers[leaf] = op._buffers[leaf] * 1.0
    with pytest.raises(RuntimeError, match="got no gradient"):
        _port_steps(m, 1, 1, 2)


def test_fp8_bundle_layout_and_load():
    from vescale_tpu_torch.models import init_params, param_shapes

    for scan in (False, True):
        cfg = LlamaConfig(dtype=torch.float32, use_fp8=True, scan_layers=scan, **CFG)
        _, bundle = _jax_model(scan)
        shapes = param_shapes(cfg)
        ref = {k: v.shape for k, v in _flat(bundle[OWG]).items()}
        assert {k: tuple(v) for k, v in _flat(shapes[OWG]).items()} == ref
        ours = init_params(cfg, 0, device="cpu")
        for key, v in _flat(ours[OWG]).items():
            np.testing.assert_array_equal(v, _flat(bundle[OWG])[key])
        m = Llama(cfg, ours, device="cpu")
        with pytest.raises(ValueError, match="bundle"):
            from vescale_tpu_torch.models import load_params

            load_params(m, ours["params"])
