"""The port's Muon against the JAX package's ``muon``, on the CPU: the
Newton-Schulz orthogonalization against the reference's jitted
``_newton_schulz`` on wide, tall and square inputs, the labels against the
reference's ``multi_transform`` masks on Llama, GPT and Mixtral, and three
train steps of the tiny Llama and the tiny GPT through ``make_train_step``
against the reference's jitted ``make_train_step`` with the same ``muon``,
in the default form (fp32 momentum, ``optax.adamw(3e-4)`` fallback) and the
1B sweep's (bf16 momentum, ``adamw_lowmem(3e-4)`` fallback).

Bounds, each a few times the measured value: Newton-Schulz 2e-6 absolute on
an output of entries below ~1 (fp32 products summed in other orders through
five cubic iterations); on the same gradients, parameters 2e-5 absolute
after three updates of lr 0.02, momenta 2e-5 absolute in fp32 and one bf16
step at scale in bf16, the fallback's moments 8 fp32 ulps or one bf16 step
at scale; through the train step, losses 1e-5 relative and the weights as
``test_three_muon_train_steps_match_the_reference`` says.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from vescale_tpu.models import llama as jl
from vescale_tpu.models import mixtral as jm
from vescale_tpu.models import nanogpt as jg
from vescale_tpu.parallel.optimizer import _newton_schulz, adamw_lowmem, muon as jax_muon
from vescale_tpu.train import make_train_step as jax_make_train_step

from vescale_tpu_torch.kernels import ulps_at_scale
from vescale_tpu_torch.models import (GPT, GPTConfig, Llama, LlamaConfig, Mixtral, MixtralConfig,
                                      cross_entropy_loss, params_from_jax)
from vescale_tpu_torch.parallel import AdamWLowmem, Muon, muon, muon_labels, newton_schulz
from vescale_tpu_torch.train import make_train_step

import torch_spmd_child as child

from torch_reset import dormant_module, dormant_test  # noqa: F401 (autouse: both packages dormant)

NS_ATOL = 2e-6
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
MOM_ATOL = 2e-5
DRIFT_REL = 0.3
BF16_STEP = 2.0 ** 16
STEPS = 3
B, T = 2, 32
LLAMA = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
GPT_CFG = dict(block_size=64, vocab_size=256, n_layer=2, n_head=2, n_embd=128)


@pytest.fixture(autouse=True)
def kernels_unset(monkeypatch):
    monkeypatch.delenv("VESCALE_KERNELS", raising=False)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def _masked_flat(tree):
    return _flat(jax.tree_util.tree_map(lambda x: x, tree,
                                        is_leaf=lambda x: isinstance(x, optax.MaskedNode)))


@pytest.mark.parametrize("shape", [(48, 160), (160, 48), (96, 96)], ids=["wide", "tall", "square"])
def test_newton_schulz_matches_the_reference(shape):
    g = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jax.jit(_newton_schulz)(jnp.asarray(g)))
    got = newton_schulz(torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == shape
    assert np.abs(got.numpy() - ref).max() <= NS_ATOL
    # near-orthogonal: the singular values pushed towards [0.7, 1.2] (a
    # square Gaussian's smallest one stays small after five steps)
    sv = np.linalg.svd(got.numpy(), compute_uv=False)
    assert np.median(sv) > 0.5 and sv.max() < 1.3


def test_newton_schulz_rounds_the_input_to_bf16_once_then_runs_fp32():
    """The iterations run in fp32 (JAX promotes the bf16 input divided by
    the fp32 norm), so an fp32 input whose bits below bf16 differ gives the
    same result, and a bf16 input comes back bf16."""
    g = np.random.default_rng(0).standard_normal((32, 64)).astype(np.float32)
    t = torch.from_numpy(g)
    assert torch.equal(newton_schulz(t), newton_schulz(t.to(torch.bfloat16).float()))
    out = newton_schulz(t.to(torch.bfloat16))
    ref = jax.jit(_newton_schulz)(jnp.asarray(g, jnp.bfloat16))
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    diff = np.abs(out.float().numpy() - np.asarray(ref, np.float32))
    assert diff.max() <= 2.0 ** -7  # at most one bf16 step of a value below 2


def _ref_labels(params):
    """The reference's labels: the leaves its "muon" partition keeps."""
    state = jax.eval_shape(jax_muon(0.02).init, params)
    masked = _masked_flat(state.inner_states["muon"].inner_state)
    return {k: "fallback" if isinstance(v, optax.MaskedNode) else "muon"
            for k, v in masked.items()}


def _models():
    """(name, the reference's parameter shapes, the port's module)."""
    toks = jnp.ones((B, T), jnp.int32)

    def shapes(model, x):
        return jax.eval_shape(model.init, jax.random.key(0), x)["params"]

    yield ("llama", shapes(jl.Llama(jl.LlamaConfig(dtype=jnp.float32, **LLAMA)), toks),
           Llama(LlamaConfig(dtype=torch.float32, **LLAMA), device="cpu"))
    yield ("gpt", shapes(jg.GPT(jg.GPTConfig(**GPT_CFG)), toks),
           GPT(GPTConfig(**GPT_CFG), device="cpu"))
    yield ("mixtral", shapes(jm.Mixtral(jm.MixtralConfig(**child.MIXTRAL_TINY, dtype=jnp.float32)),
                             toks[:, :16]),
           Mixtral(MixtralConfig(**child.MIXTRAL_TINY, dtype=torch.float32), device="cpu"))


def test_labels_are_the_references_on_llama_gpt_and_mixtral():
    seen = set()
    for name, params, model in _models():
        got = muon_labels(model.named_parameters())
        assert got == _ref_labels(params), name
        seen |= {(name, v) for v in got.values()}
        if name == "mixtral":  # the 3-D expert stacks go to the fallback
            assert got["layers_0.block_sparse_moe.w_in"] == "fallback"
    assert {(m, lab) for m in ("llama", "gpt", "mixtral") for lab in ("muon", "fallback")} <= seen


def _tokens(vocab, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, (B, T + 1)).astype(np.int32)


def _setup(kind):
    toks = _tokens(LLAMA["vocab_size"] if kind == "llama" else GPT_CFG["vocab_size"])
    if kind == "llama":
        jmodel = jl.Llama(jl.LlamaConfig(dtype=jnp.float32, **LLAMA))
        params = jmodel.init(jax.random.key(0), jnp.asarray(toks[:, :-1]))["params"]
        model = Llama(LlamaConfig(dtype=torch.float32, **LLAMA), params_from_jax(params, device="cpu"),
                      device="cpu")
    else:
        jmodel = jg.GPT(jg.GPTConfig(**GPT_CFG))
        params = jmodel.init(jax.random.key(0), jnp.asarray(toks[:, :-1]))["params"]
        model = GPT(GPTConfig(**GPT_CFG), params_from_jax(params, device="cpu"), device="cpu")
    return jmodel, params, model, toks


VARIANTS = {
    # muon's defaults: fp32 momentum, optax.adamw(3e-4)
    "default": (lambda: jax_muon(0.02), lambda named: muon(named, 0.02)),
    # scripts/bench_1b_sweep.py's: bf16 momentum, adamw_lowmem(3e-4)
    "sweep": (lambda: jax_muon(0.02, fallback=adamw_lowmem(3e-4), state_dtype=jnp.bfloat16),
              lambda named: muon(named, 0.02, state_dtype=torch.bfloat16,
                                 fallback=lambda ps: AdamWLowmem(ps, 3e-4))),
}


def _ref_run(tx, params, grads_fn, steps=STEPS):
    p, s = params, tx.init(params)
    upd = jax.jit(tx.update)
    for i in range(steps):
        u, s = upd(grads_fn(i), s, p)
        p = optax.apply_updates(p, u)
    return p, s


_DT = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_three_muon_updates_on_the_same_grads_match_the_reference(kind, variant):
    """The optimizer alone: both packages step the same parameters with the
    same numpy-seeded gradients three times.  Parameters, momenta (in the
    reference's dtype) and the fallback's moments and count agree."""
    _, params, model, _ = _setup(kind)
    flat0 = _flat(params)
    rng = np.random.default_rng(7)
    grads = [{k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in flat0.items()}
             for _ in range(STEPS)]

    def nest(flat):
        out = {}
        for k, v in flat.items():
            *path, leaf = k.split(".")
            node = out
            for q in path:
                node = node.setdefault(q, {})
            node[leaf] = jnp.asarray(v)
        return out

    make_ref, make_port = VARIANTS[variant]
    p, s = _ref_run(make_ref(), params, lambda i: nest(grads[i]))
    opt = make_port(model.named_parameters())
    named = dict(model.named_parameters())
    for i in range(STEPS):
        for k, prm in named.items():
            prm.grad = torch.from_numpy(grads[i][k])
        opt.step()

    ref_p = _flat(p)
    for name, prm in named.items():
        assert np.abs(prm.detach().numpy() - np.asarray(ref_p[name])).max() <= PARAM_ATOL, name
    ref_m = _masked_flat(s.inner_states["muon"].inner_state)
    muon_names = [n for n, lab in opt.labels.items() if lab == "muon"]
    assert muon_names
    for name in muon_names:
        m, want = opt.state[named[name]]["momentum_buffer"], ref_m[name]
        assert m.dtype == _DT[jnp.dtype(want.dtype)], name
        got, want = m.float().numpy(), np.asarray(want, np.float32)
        if m.dtype == torch.float32:
            assert np.abs(got - want).max() <= MOM_ATOL, name
        else:
            assert ulps_at_scale(got, want) <= BF16_STEP, name
    ref_f = s.inner_states["fallback"].inner_state[0]
    assert int(ref_f.count) == opt.fallback.param_groups[0]["step"] == STEPS
    mu, nu = _masked_flat(ref_f.mu), _masked_flat(ref_f.nu)
    for name in (n for n, lab in opt.labels.items() if lab == "fallback"):
        st = opt.fallback.state[named[name]]
        for key, ref in (("exp_avg", mu[name]), ("exp_avg_sq", nu[name])):
            got = st[key]
            assert got.dtype == _DT[jnp.dtype(ref.dtype)], (name, key)
            bound = 8.0 if got.dtype == torch.float32 else BF16_STEP
            assert ulps_at_scale(got.float().numpy(), np.asarray(ref, np.float32)) <= bound, (
                name, key)


@pytest.mark.parametrize("kind,variant", [("llama", "default"), ("gpt", "sweep")])
def test_three_muon_train_steps_match_the_reference(kind, variant):
    """``make_train_step`` with Muon against the reference's jitted step:
    losses within 1e-5 relative.  The weights drift further: the gradients
    differ in their last fp32 bits, which can flip G's one rounding to bf16,
    and Newton-Schulz amplifies a small singular direction up to a^5 ~ 485
    times, so the weights are held by the difference's L2 norm relative to
    the reference's own three-step change (measured 0.0098 on the Llama and
    0.092 on the GPT, whose key bias and key kernel train on rounding
    noise alone)."""
    jmodel, params, model, toks = _setup(kind)
    make_ref, make_port = VARIANTS[variant]
    tx = make_ref()
    step = jax_make_train_step(jmodel, tx, lambda lg, b: jg.cross_entropy_loss(lg, b["target"]),
                               donate=False)
    jb = {"input": jnp.asarray(toks[:, :-1]), "target": jnp.asarray(toks[:, 1:])}
    p, s, ref_losses = params, tx.init(params), []
    for _ in range(STEPS):
        p, s, loss = step(p, s, jb)
        ref_losses.append(float(loss))

    opt = make_port(model.named_parameters())
    assert isinstance(opt, Muon)
    tstep = make_train_step(model, opt, lambda lg, b: cross_entropy_loss(lg, b["target"]))
    tb = torch.from_numpy(toks).long()
    losses = [float(tstep({"input": tb[:, :-1], "target": tb[:, 1:]})) for _ in range(STEPS)]
    assert ref_losses[-1] < ref_losses[0]
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL, atol=0)
    ref_p, p0 = _flat(p), _flat(params)
    for name, prm in model.named_parameters():
        change = np.asarray(ref_p[name]) - np.asarray(p0[name])
        diff = prm.detach().numpy() - np.asarray(ref_p[name])
        assert np.linalg.norm(diff) <= DRIFT_REL * max(np.linalg.norm(change), 1e-12), name


def test_muon_without_a_2d_weight_steps_the_fallback_only():
    lin = torch.nn.Linear(4, 3, device="cpu")
    opt = Muon([("bias", lin.bias)])
    assert opt.labels == {"bias": "fallback"} and opt.param_groups[0]["params"] == []
    lin.bias.grad = torch.ones(3)
    before = lin.bias.detach().clone()
    opt.step()
    assert not torch.equal(lin.bias.detach(), before)


def test_bench_muon_rung_trains_on_the_cpu(capsys):
    """``python -m vescale_tpu_torch.bench --rung cpu --opt muon``: the cpu
    Llama rung stepped by Muon (its fallback AdamW over the embedding, the
    head and the norms); the loss falls."""
    from vescale_tpu_torch import bench

    assert bench.main(["--rung", "cpu", "--opt", "muon"]) == 0
    import json

    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "llama_cpu_smoke_tokens_per_s_muon"
    assert out["losses"][-1] < out["losses"][0]
    run = bench.prepare("cpu", opt="muon")
    assert isinstance(run.optimizer, Muon) and run.optimizer.fallback is not None
    assert {n for n, lab in run.optimizer.labels.items() if lab == "fallback"} >= {
        "embed_tokens.embedding", "lm_head.kernel", "norm.weight"}
    run.close()
    with pytest.raises(ValueError, match="Llama rungs"):
        bench.prepare("gpt_cpu", opt="muon")
