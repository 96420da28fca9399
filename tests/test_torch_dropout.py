"""The port's nanoGPT dropout, ``make_train_step(step_key=...)`` and
``make_eval_step`` against the JAX package on the CPU.

The reference's masks are captured from flax itself: an interceptor on
every ``nn.Dropout`` call draws the module's key with ``make_rng`` (the
call the module would make) and hands it to the call, recording
``bernoulli(key, 1 - rate)``.  The port's masks are recorded at its one
draw (``models.nanogpt._dropout_mask``).  Masks are integer work, so they
are compared bitwise; losses to 1e-5 relative (measured <= 9.2e-8: fp32 sums
in other orders), as the dropout-free trajectories of
``tests/test_torch_nanogpt.py``.  The tensor-parallel case is in
``tests/test_torch_dmodule.py``.
"""

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch

from vescale_tpu.models import nanogpt as jg
from vescale_tpu.parallel.optimizer import adamw_lowmem
from vescale_tpu.train import make_eval_step as jax_make_eval_step
from vescale_tpu.train import make_train_step as jax_make_train_step

from vescale_tpu_torch import random as trandom
from vescale_tpu_torch.models import GPT, GPTConfig, cross_entropy_loss, params_from_jax
from vescale_tpu_torch.models import nanogpt as tg
from vescale_tpu_torch.parallel import AdamWLowmem
from vescale_tpu_torch.train import FunctionalStep, make_eval_step, make_train_step

from torch_reset import dormant_module, dormant_test  # noqa: F401 (autouse: both packages dormant)

B, T = 4, 32
CFG = dict(block_size=64, vocab_size=256, n_layer=2, n_head=2, n_embd=128)
LOSS_RTOL = 1e-5
STEPS = 3
LR = 1e-3


@pytest.fixture(autouse=True)
def kernels_unset(monkeypatch):
    monkeypatch.delenv("VESCALE_KERNELS", raising=False)


_PARAMS = {}


def _params():
    if "p" not in _PARAMS:
        model = jg.GPT(jg.GPTConfig(**CFG))
        _PARAMS["p"] = jax.jit(model.init)(jax.random.key(0), jnp.ones((B, T), jnp.int32))["params"]
    return _PARAMS["p"]


def _tokens(seed=1):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], (B, T + 1)).astype(np.int32)


def _port_key(k):
    return trandom.as_key(np.asarray(jax.random.key_data(k)))


def ref_masks(rate, params, x, rngs):
    """{flax path: mask} of one reference forward with ``rngs``."""
    out = {}

    def interceptor(next_fun, args, kwargs, ctx):
        mod = ctx.module
        if not isinstance(mod, nn.Dropout) or ctx.method_name != "__call__" or mod.deterministic:
            return next_fun(*args, **kwargs)
        k = mod.make_rng("dropout")
        out[".".join(mod.scope.path)] = np.asarray(
            jax.random.bernoulli(k, 1.0 - mod.rate, args[0].shape))
        return next_fun(*args, rng=k, **kwargs)

    with nn.intercept_methods(interceptor):
        jg.GPT(jg.GPTConfig(**CFG, dropout=rate)).apply({"params": params}, jnp.asarray(x),
                                                          deterministic=False, rngs=rngs)
    return out


@pytest.fixture
def port_masks(monkeypatch):
    """The port's masks as they are drawn: a list of (path, mask)."""
    got = []
    real = tg._dropout_mask

    def spy(k, keep_prob, shape, device, goff, gshape):
        m = real(k, keep_prob, shape, device, goff, gshape)
        got.append(m.clone())
        return m

    monkeypatch.setattr(tg, "_dropout_mask", spy)
    return got


SITES = ["Dropout_0"] + [f"h_{i}.{s}" for i in range(CFG["n_layer"])
                         for s in ("attn.Dropout_0", "attn.Dropout_1", "mlp.Dropout_0")]


@pytest.mark.parametrize("rate", [0.1, 0.2])
def test_forward_masks_and_logits_are_flaxs(rate, port_masks):
    params = _params()
    x = _tokens()[:, :-1]
    k = jax.random.key(11)
    want = ref_masks(rate, params, x, {"dropout": k})
    assert sorted(want) == sorted(SITES)
    ref = np.asarray(jg.GPT(jg.GPTConfig(**CFG, dropout=rate)).apply(
        {"params": params}, jnp.asarray(x), deterministic=False, rngs={"dropout": k}))
    model = GPT(GPTConfig(**CFG, dropout=rate), params_from_jax(params, device="cpu"), device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x).long(), deterministic=False,
                    rngs={"dropout": _port_key(k)})
    # the forward's draw order: the embedding, then each block's three
    assert len(port_masks) == len(SITES)
    for site, m in zip(SITES, port_masks):
        assert m.dtype == torch.bool and np.array_equal(m.numpy(), want[site]), site
    keep = np.mean([want[s].mean() for s in SITES])
    assert abs(keep - (1 - rate)) < 0.02
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
    # deterministic (the default) draws nothing and is the dropout-free model
    with torch.no_grad():
        plain = model(torch.from_numpy(x).long())
    want_plain = np.asarray(jg.GPT(jg.GPTConfig(**CFG)).apply({"params": params}, jnp.asarray(x)))
    assert len(port_masks) == len(SITES)
    np.testing.assert_allclose(plain.numpy(), want_plain, rtol=2e-5, atol=2e-5)


def test_a_forward_without_the_rng_refuses_and_rate_one_zeroes():
    model = GPT(GPTConfig(**CFG, dropout=0.1), params_from_jax(_params(), device="cpu"),
                device="cpu")
    x = torch.from_numpy(_tokens()[:, :-1]).long()
    with pytest.raises(ValueError, match="dropout"):
        model(x, deterministic=False)
    d = tg.Dropout(1.0)
    assert torch.equal(d(torch.ones(3), deterministic=False), torch.zeros(3))
    assert torch.equal(d(torch.ones(3)), torch.ones(3))


def _ref_train(rate, keys, grad_accum_steps=1):
    params = _params()
    model = jg.GPT(jg.GPTConfig(**CFG, dropout=rate))
    tx = adamw_lowmem(LR)
    step = jax_make_train_step(model, tx, lambda lg, b: jg.cross_entropy_loss(lg, b["target"]),
                               donate=False, grad_accum_steps=grad_accum_steps)
    toks = jnp.asarray(_tokens(2))
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
    p, s, losses = params, tx.init(params), []
    for k in keys:
        p, s, loss = step(p, s, batch, k)
        losses.append(float(loss))
    return losses


def _port_train(rate, keys, grad_accum_steps=1):
    model = GPT(GPTConfig(**CFG, dropout=rate), params_from_jax(_params(), device="cpu"),
                device="cpu")
    opt = AdamWLowmem(model.parameters(), LR)
    step = make_train_step(model, opt, lambda lg, b: cross_entropy_loss(lg, b["target"]),
                           grad_accum_steps=grad_accum_steps)
    toks = torch.from_numpy(_tokens(2)).long()
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
    return [float(step(batch, None if k is None else _port_key(k))) for k in keys], model


@pytest.mark.parametrize("accum", [1, 2])
def test_three_train_steps_with_dropout_match_the_reference(accum, port_masks):
    """Each step's masks bitwise the reference's for its step key (micro-
    batch ``i`` under ``fold_in(step_key, 1000 + i)``), the losses within
    1e-5 relative of the reference's jitted step."""
    rate = 0.2
    keys = [jax.random.fold_in(jax.random.key(5), s) for s in range(STEPS)]
    ref = _ref_train(rate, keys, accum)
    got, _ = _port_train(rate, keys, accum)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL, atol=0)
    assert ref[-1] < ref[0]
    toks = _tokens(2)[:, :-1]
    mb = B // accum
    per_step = len(SITES) * accum
    assert len(port_masks) == per_step * STEPS
    for s, k in enumerate(keys):
        for i in range(accum):
            key_i = k if accum == 1 else jax.random.fold_in(k, 1000 + i)
            want = ref_masks(rate, _params(), toks[i * mb:(i + 1) * mb],
                             {"dropout": jax.random.fold_in(key_i, 0)})
            drawn = port_masks[s * per_step + i * len(SITES):s * per_step + (i + 1) * len(SITES)]
            for site, m in zip(SITES, drawn):
                assert np.array_equal(m.numpy(), want[site]), (s, i, site)


def test_no_step_key_is_the_deterministic_step(port_masks):
    """Without a key the step draws nothing and trains as the reference's
    keyless step does: the dropout-free model."""
    ref = _ref_train(0.2, [None] * 2)
    got, _ = _port_train(0.2, [None] * 2)
    assert port_masks == []
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL, atol=0)


def test_functional_step_passes_the_step_key(port_masks):
    model = GPT(GPTConfig(**CFG, dropout=0.1), params_from_jax(_params(), device="cpu"),
                device="cpu")
    opt = AdamWLowmem(model.parameters(), LR)
    fstep = FunctionalStep(make_train_step(model, opt, lambda lg, b: cross_entropy_loss(
        lg, b["target"])), model, opt)
    toks = torch.from_numpy(_tokens(2)).long()
    fstep(fstep.params, fstep.opt_state, {"input": toks[:, :-1], "target": toks[:, 1:]},
          trandom.key(3))
    assert len(port_masks) == len(SITES)


def test_eval_step_matches_the_reference():
    params = _params()
    toks = _tokens(3)
    ref_eval = jax_make_eval_step(jg.GPT(jg.GPTConfig(**CFG, dropout=0.2)),
                                  lambda lg, b: jg.cross_entropy_loss(lg, b["target"]))
    want = float(ref_eval(params, {"input": jnp.asarray(toks[:, :-1]),
                                   "target": jnp.asarray(toks[:, 1:])}))
    model = GPT(GPTConfig(**CFG, dropout=0.2), params_from_jax(params, device="cpu"), device="cpu")
    ev = make_eval_step(model, lambda lg, b: cross_entropy_loss(lg, b["target"]))
    t = torch.from_numpy(toks).long()
    got = ev({"input": t[:, :-1], "target": t[:, 1:]})
    assert not got.requires_grad
    assert abs(float(got) - want) <= LOSS_RTOL * abs(want)


def test_pipeline_units_with_dropout_run_deterministic_as_the_references():
    """``gpt_pipeline_units`` at dropout 0.2: each unit's output equals the
    reference unit's ``apply`` (no rngs: flax's blocks default to
    deterministic), unit by unit through the whole model."""
    from vescale_tpu_torch.models import gpt_pipeline_units
    from vescale_tpu_torch.models import gpt_unit_params
    from vescale_tpu_torch.models.convert import load_params
    from vescale_tpu.models.nanogpt import gpt_pipeline_units as ref_units

    cfg = GPTConfig(**CFG, dropout=0.2)
    rcfg = jg.GPTConfig(**CFG, dropout=0.2)
    params = _params()
    port_params = gpt_unit_params(params_from_jax(params, device="cpu"), CFG["n_layer"])
    ref_params = {"wte": {"wte": params["wte"]}, "wpe": {"wpe": params["wpe"]},
                  **{f"h_{i}": params[f"h_{i}"] for i in range(CFG["n_layer"])},
                  "ln_f": {"ln_f": params["ln_f"]}, "head": {"wte": params["wte"]}}
    x = jnp.asarray(_tokens()[:, :-1])
    xt = torch.from_numpy(np.array(x)).long()
    for pu, ru in zip(gpt_pipeline_units(cfg, device="cpu"), ref_units(rcfg)):
        assert pu.name == ru.name
        load_params(pu.module, port_params[pu.name])
        x = ru.module.apply({"params": ref_params[ru.name]}, x)
        with torch.no_grad():
            xt = pu.module(xt)
        np.testing.assert_allclose(xt.numpy(), np.asarray(x), rtol=2e-5, atol=2e-5)


def test_a_data_parallel_ranks_masks_are_its_rows_of_the_global_masks(port_masks):
    """Two ranks' halves of a batch, each forward under ``random.batch_rows``
    (its rows of the global batch), draw exactly the rows of the masks one
    forward over the whole batch draws: the reference's global-batch masks
    under a "dp"-sharded batch."""
    model = GPT(GPTConfig(**CFG, dropout=0.2), params_from_jax(_params(), device="cpu"),
                device="cpu")
    x = torch.from_numpy(_tokens()[:, :-1]).long()
    rngs = {"dropout": trandom.key(8)}
    with torch.no_grad():
        model(x, deterministic=False, rngs=rngs)
        whole = list(port_masks)
        for r in range(2):
            del port_masks[:]
            with trandom.batch_rows(r * B // 2, B):
                model(x[r * B // 2:(r + 1) * B // 2], deterministic=False, rngs=rngs)
            for w, m in zip(whole, port_masks):
                assert torch.equal(m, w[r * B // 2:(r + 1) * B // 2])
    assert trandom.current_batch_rows() is None
