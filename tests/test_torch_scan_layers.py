"""``Llama(scan_layers=True)``, ``remat_policy`` and the Llama pipeline
units against the JAX package, on the CPU, in tests/test_torch_models.py's
style: tiny configs, the flax init carried across by ``params_from_jax``,
tokens from a numpy seed.

Held: the scanned parameter tree (``layers.block.*``, leading (L,) axis)
is flax ``nn.scan``'s, path for path and shape for shape, and
``init_params``/``param_shapes`` give it; ``scan_tree``/``unscan_tree``
round-trip; the scanned model's logits and grads within ``ULPS`` of the
flax scanned model's (fp32, dense attention; 4x that through the flash
kernels' plain version, measured 28.25) and bitwise the unscanned
port model's on the same weights; each mapped ``remat_policy`` within
``ULPS`` of flax under the same ``jax.checkpoint_policies`` entry and
bitwise the port's no-remat run; an unmapped name raises; ``LlamaEmbed``
and ``LlamaHead`` equal the flax units; three ``make_train_step`` steps of
the scanned model bitwise the unscanned model's, losses and masters.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vescale_tpu.models import llama as jl

from vescale_tpu_torch.kernels import ulps_at_scale
from vescale_tpu_torch.models import (Llama, LlamaConfig, LlamaEmbed, LlamaHead, init_params,
                                      module_tree, param_shapes, params_from_jax, scan_tree,
                                      unscan_tree)
from vescale_tpu_torch.models.convert import load_params
from vescale_tpu_torch.models.llama import REMAT_POLICIES
from vescale_tpu_torch.models.nanogpt import cross_entropy_loss
from vescale_tpu_torch.parallel import AdamWLowmem
from vescale_tpu_torch.pipe.graph_split import OpRecorder
from vescale_tpu_torch.pipe.pipe_stage import flatten_tree
from vescale_tpu_torch.train import make_train_step

ULPS = 16.0
SHAPE = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=3,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
B, T = 2, 12


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, SHAPE["vocab_size"], (B, T + 1)).astype(np.int32)


_FLAX = {}


def _flax(**over):
    key = tuple(sorted(over.items()))
    if key not in _FLAX:
        cfg = jl.LlamaConfig(dtype=jnp.float32, scan_layers=True, **SHAPE, **over)
        params = jl.Llama(cfg).init(jax.random.key(3), jnp.ones((1, 4), jnp.int32))["params"]
        _FLAX[key] = (cfg, jax.tree_util.tree_map(np.asarray, params))
    return _FLAX[key]


def _port_cfg(**over):
    return LlamaConfig(dtype=torch.float32, scan_layers=True, **SHAPE, **over)


def _flax_loss_grads(cfg, params, toks):
    def loss(p):
        logits = jl.Llama(cfg).apply({"params": p}, jnp.asarray(toks[:, :-1]))
        lse = jax.nn.logsumexp(logits, -1)
        gold = jnp.take_along_axis(logits, jnp.asarray(toks[:, 1:])[..., None], -1)[..., 0]
        return jnp.mean(lse - gold), logits

    (l, logits), g = jax.value_and_grad(loss, has_aux=True)(params)
    return float(l), np.asarray(logits), flatten_tree(jax.tree_util.tree_map(np.asarray, g))


def _port_loss_grads(model, toks):
    t = torch.from_numpy(toks).long()
    logits = model(t[:, :-1])
    loss = cross_entropy_loss(logits, t[:, 1:])
    loss.backward()
    return loss.detach(), logits.detach(), {n: p.grad for n, p in model.named_parameters()}


def test_scanned_tree_is_the_flax_layout():
    _, params = _flax()
    got = params_from_jax(params, device="cpu")
    cfg = _port_cfg()
    flat_f, flat_p = flatten_tree(params), flatten_tree(got)
    assert sorted(flat_f) == sorted(flat_p)
    assert all(k.startswith(("layers.block.", "embed_tokens", "norm", "lm_head")) for k in flat_p)
    shapes = flatten_tree(param_shapes(cfg))
    assert {k: tuple(v) for k, v in shapes.items()} == {k: v.shape for k, v in flat_f.items()}
    drawn = flatten_tree(init_params(cfg, 0, device="cpu"))
    assert {k: tuple(v.shape) for k, v in drawn.items()} == {k: v.shape for k, v in flat_f.items()}
    model = Llama(cfg, got, device="cpu")
    assert sorted(dict(model.named_parameters())) == sorted(flat_f)
    # one seed gives the same weights in both layouts
    flat_cfg = dataclasses.replace(cfg, scan_layers=False)
    unscanned = init_params(flat_cfg, 0, device="cpu")
    for k, v in flatten_tree(scan_tree(unscanned, 3)).items():
        assert torch.equal(v, drawn[k])
    for k, v in flatten_tree(unscan_tree(scan_tree(unscanned, 3))).items():
        assert torch.equal(v, flatten_tree(unscanned)[k])


@pytest.mark.parametrize("flash", [False, True])
def test_scanned_model_matches_flax_and_the_unscanned_model(flash):
    fcfg, params = _flax()
    toks = _tokens()
    fl, flogits, fgrads = _flax_loss_grads(fcfg, params, toks)
    cfg = _port_cfg(use_flash_attention=flash)
    model = Llama(cfg, params_from_jax(params, device="cpu"), device="cpu")
    loss, logits, grads = _port_loss_grads(model, toks)
    # the flash kernels' plain version against flax's dense branch (the
    # reference's CPU path): measured 28.25 ulps on the logits
    bound = 4 * ULPS if flash else ULPS
    assert ulps_at_scale(logits.numpy(), flogits) <= bound
    assert ulps_at_scale(loss.numpy(), np.float32(fl)) <= bound
    for k, g in grads.items():
        assert ulps_at_scale(g.numpy(), fgrads[k]) <= 4 * bound, k
    plain = Llama(dataclasses.replace(cfg, scan_layers=False),
                  unscan_tree(params_from_jax(params, device="cpu")), device="cpu")
    ploss, plogits, pgrads = _port_loss_grads(plain, toks)
    assert torch.equal(loss, ploss) and torch.equal(logits, plogits)
    for k, g in grads.items():
        if not k.startswith("layers.block."):
            assert torch.equal(g, pgrads[k]), k
            continue
        for i in range(cfg.num_hidden_layers):
            assert torch.equal(g[i], pgrads[f"layers_{i}." + k[len("layers.block."):]]), (k, i)


@pytest.mark.parametrize("policy", sorted(REMAT_POLICIES))
def test_remat_policy_matches_flax_and_no_remat(policy):
    fcfg, params = _flax(remat=True, remat_policy=policy)
    toks = _tokens(1)
    fl, flogits, fgrads = _flax_loss_grads(fcfg, params, toks)
    got = params_from_jax(params, device="cpu")
    model = Llama(_port_cfg(remat=True, remat_policy=policy), got, device="cpu")
    loss, logits, grads = _port_loss_grads(model, toks)
    assert ulps_at_scale(loss.numpy(), np.float32(fl)) <= ULPS
    for k, g in grads.items():
        assert ulps_at_scale(g.numpy(), fgrads[k]) <= 4 * ULPS, k
    base = Llama(_port_cfg(), got, device="cpu")
    bloss, blogits, bgrads = _port_loss_grads(base, toks)
    assert torch.equal(loss, bloss) and torch.equal(logits, blogits)
    for k, g in grads.items():
        assert torch.equal(g, bgrads[k]), k


def _matmuls_and_ops(model, toks):
    """The matmuls (name, output shape) that one loss's forward and its
    backward dispatch, as sorted lists, and the backward's op names."""
    t = torch.from_numpy(toks).long()
    with OpRecorder() as fwd:
        loss = cross_entropy_loss(model(t[:, :-1]), t[:, 1:])
    with OpRecorder() as bwd:
        loss.backward()

    def mm(rec):
        shapes = iter(rec.matmul_shapes())
        return [(n, next(shapes)) for n, _ in rec.ops if n in REMAT_POLICIES["dots_saveable"]]

    return mm(fwd), mm(bwd), [n for n, _ in bwd.ops]


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("policy", [None, *sorted(REMAT_POLICIES)])
def test_remat_policy_recomputes_what_it_does_not_save(policy, flash):
    """What a policy saves shows in the backward: each matmul it does not
    save runs there a second time (the backward's own products are the
    no-remat run's).  ``dots_saveable`` reruns none, ``dots_with_no_batch_
    dims_saveable`` reruns attention's batched ``bmm``s and no projection,
    ``nothing_saveable`` (and full remat, ``None``) every product of the
    blocks that the backward reads; the head is outside the checkpoint.  The flash op is no matmul:
    every policy reruns it, once a layer."""
    _, params = _flax()
    got = params_from_jax(params, device="cpu")
    toks = _tokens(5)
    base = Llama(_port_cfg(use_flash_attention=flash), got, device="cpu")
    base_f, base_b, base_ops = _matmuls_and_ops(base, toks)
    model = Llama(_port_cfg(use_flash_attention=flash, remat=True, remat_policy=policy), got,
                  device="cpu")
    f, b, ops = _matmuls_and_ops(model, toks)
    assert f == base_f
    rerun = collections.Counter(b)
    rerun.subtract(collections.Counter(base_b))
    assert min(rerun.values(), default=0) >= 0
    rerun = sorted(rerun.elements())
    assert base_f[-1] == ("mm", (B * T, SHAPE["vocab_size"]))  # the head
    L = SHAPE["num_hidden_layers"]
    per = 7 if flash else 9  # 7 projections, 2 bmm
    assert len(base_f) - 1 == L * per
    # a layer's last product (down_proj) feeds only the residual add, which
    # saves nothing: the checkpoint stops recomputing before it
    blocks = [m for i in range(L) for m in base_f[i * per:(i + 1) * per - 1]]
    assert all(m[1] == (B * T, SHAPE["hidden_size"]) for m in base_f[per - 1:-1:per])
    saved = REMAT_POLICIES.get(policy, ())
    assert rerun == sorted(m for m in blocks if m[0] not in saved)
    if policy == "dots_with_no_batch_dims_saveable":
        assert {n for n, _ in rerun} == (set() if flash else {"bmm"})
    assert ops.count("flash_attention") == (L if flash else 0)
    assert base_ops.count("flash_attention") == 0


def test_unmapped_remat_policy_raises():
    with pytest.raises(NotImplementedError, match="remat_policy"):
        Llama(_port_cfg(remat=True, remat_policy="offload_dot_with_no_batch_dims"), device="cpu")


def test_pipeline_units_match_flax():
    cfg = jl.LlamaConfig(dtype=jnp.float32, **SHAPE)
    toks = _tokens(2)[:, :-1]
    emb_p = jl.LlamaEmbed(cfg).init(jax.random.key(1), jnp.asarray(toks))["params"]
    x = np.asarray(jl.LlamaEmbed(cfg).apply({"params": emb_p}, jnp.asarray(toks)))
    head_p = jl.LlamaHead(cfg).init(jax.random.key(2), jnp.asarray(x))["params"]
    y = np.asarray(jl.LlamaHead(cfg).apply({"params": head_p}, jnp.asarray(x)))
    pcfg = LlamaConfig(dtype=torch.float32, **SHAPE)
    emb, head = LlamaEmbed(pcfg, "cpu"), LlamaHead(pcfg, "cpu")
    load_params(emb, params_from_jax(emb_p, device="cpu"))
    load_params(head, params_from_jax(head_p, device="cpu"))
    got_x = emb(torch.from_numpy(toks).long())
    assert np.array_equal(got_x.detach().numpy(), x)
    assert ulps_at_scale(head(torch.from_numpy(x)).detach().numpy(), y) <= ULPS
    assert sorted(flatten_tree(module_tree(head))) == sorted(flatten_tree(head_p))


def test_scanned_training_is_bitwise_the_unscanned():
    cfg = _port_cfg(use_flash_attention=True)
    flat_cfg = dataclasses.replace(cfg, scan_layers=False)
    params = init_params(flat_cfg, 0, device="cpu")
    t = torch.from_numpy(_tokens(4)).long()
    batch = {"input": t[:, :-1], "target": t[:, 1:]}
    runs = []
    for c, p in ((flat_cfg, params), (cfg, scan_tree(params, cfg.num_hidden_layers))):
        model = Llama(c, p, device="cpu")
        step = make_train_step(model, AdamWLowmem(model.parameters(), 3e-3),
                               lambda lg, b: cross_entropy_loss(lg, b["target"]))
        losses = [step(batch) for _ in range(3)]
        runs.append((losses, module_tree(model)))
    (la, ta), (lb, tb) = runs
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    flat_b = flatten_tree(unscan_tree(tb))
    for k, v in flatten_tree(ta).items():
        assert torch.equal(v, flat_b[k]), k
