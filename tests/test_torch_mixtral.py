"""The port's Mixtral (``vescale_tpu_torch.models.mixtral``, A16) against the
JAX reference ``vescale_tpu.models.mixtral``.

Held:

  * the tiny Mixtral of tests/test_models.py:26-37 (reference init,
    carried across by ``params_from_jax``): the reference's leaf dtypes
    and paths, logits within 8 fp32 ulps at scale, each block's router
    aux loss within 4 fp32 ulps, and still in the graph;
  * 3 steps of ``make_train_step`` with ``AdamWLowmem`` over
    ``param_dtype_groups`` against the reference's ``make_train_step``
    with ``optax.adamw``: fp32 losses within 1e-5 relative and
    parameters within 1e-4; a variant in bf16 (bf16 experts and compute,
    two parameter groups, bf16 moments for the experts) within 2e-2 of
    the loss and 4e-2 of the parameters (optax does a bf16 leaf's moment
    arithmetic in bf16, the port's AdamW in fp32);
  * ``mixtral_plan`` and ``parallelize_experts`` on a gloo world of 2
    (ep = 2) and ``mixtral_plan`` on a world of 4 (dp x ep = 2 x 2),
    children of ``tests/torch_spmd_child.py``, against the reference's
    ``DModule`` on a (dp, ep) = (2, 4) mesh: each rank's logits within
    2e-5 (tests/test_moe.py:84's tolerance), the aux losses within 1e-6,
    the grads of sum(logits * w) + the aux losses (an aux loss counted
    twice would show) within 5e-5, each rank's expert
    grads against the matching rows, the replicated grads bitwise equal
    on every ep rank;
  * ``hf_mixtral_to_params`` and ``hf_llama_to_params`` on the synthetic
    HF dicts of tests/test_hf_convert.py: the trees exactly the
    reference's, and the logits within 8 fp32 ulps at scale;
  * the bench's ``moe_cpu`` rung runs on the CPU and its loss falls.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import vescale_tpu as vt
from vescale_tpu.dmodule import parallelize_module as ref_parallelize
from vescale_tpu.models import convert as ref_convert
from vescale_tpu.models import llama as ref_llama
from vescale_tpu.models import mixtral as ref_mixtral
from vescale_tpu.models.nanogpt import cross_entropy_loss as ref_xent
from vescale_tpu.train import make_train_step as ref_make_train_step

from vescale_tpu_torch import bench
from vescale_tpu_torch.kernels import ulps_at_scale
from vescale_tpu_torch.models import (Llama, LlamaConfig, Mixtral, MixtralConfig,
                                      cross_entropy_loss, hf_llama_to_params,
                                      hf_mixtral_to_params, init_params, param_shapes,
                                      params_from_jax)
from vescale_tpu_torch.parallel import AdamWLowmem, param_dtype_groups
from vescale_tpu_torch.train import make_train_step

import torch_spmd_child as child
from test_hf_convert import CFG as HF_LLAMA_CFG, _fake_hf_state

LOGIT_ULPS = 8.0
AUX_ULPS = 4.0
LR = 1e-3
STEPS = 3
LOSS_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
PARAM_TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-2}
FWD_TOL = 2e-5   # tests/test_moe.py:84
GRAD_TOL = 5e-5  # tests/test_dmodule.py's step tolerance
AUX_REL = 1e-6


def _cfgs(dtype=torch.float32, **over):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    fields = dict(child.MIXTRAL_TINY, **over)
    return MixtralConfig(**fields, dtype=dtype), ref_mixtral.MixtralConfig(**fields, dtype=jdt)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _tokens(seed, B=2, T=16):
    return np.random.default_rng(seed).integers(0, child.MIXTRAL_TINY["vocab_size"],
                                                (B, T)).astype(np.int32)


def test_logits_and_aux_losses_match_the_reference():
    cfg, rcfg = _cfgs()
    rmodel = ref_mixtral.Mixtral(rcfg)
    toks = _tokens(0)
    params = jax.jit(rmodel.init)(jax.random.key(0), jnp.asarray(toks))["params"]
    logits, state = jax.jit(lambda p, t: rmodel.apply({"params": p}, t, mutable=["losses"]))(
        params, jnp.asarray(toks))
    model = Mixtral(cfg, params_from_jax(params, device="cpu"), device="cpu")
    ref_flat = _flat(params)
    assert [n for n, _ in model.named_parameters()] == list(_flat(param_shapes(cfg)))
    assert set(ref_flat) == {n for n, _ in model.named_parameters()}
    got = model(torch.from_numpy(toks).long())
    assert ulps_at_scale(got.detach().numpy(), np.asarray(logits)) <= LOGIT_ULPS
    auxes = model.router_aux_losses()
    assert len(auxes) == cfg.num_hidden_layers and all(a.requires_grad for a in auxes)
    for i, a in enumerate(auxes):
        want = np.asarray(state["losses"][f"layers_{i}"]["router_aux"][0])
        assert ulps_at_scale(a.detach().numpy(), want) <= AUX_ULPS, i


def test_leaf_dtypes_are_the_references():
    """bf16 experts, every other leaf fp32, in ``init_params``, the module
    and the reference's own init."""
    cfg, rcfg = _cfgs(torch.bfloat16)
    toks = jnp.asarray(_tokens(0))
    ref = _flat(jax.eval_shape(ref_mixtral.Mixtral(rcfg).init, jax.random.key(0), toks)["params"])
    tree = _flat(init_params(cfg, 0, device="cpu"))
    model = Mixtral(cfg, device="cpu")
    for name, p in model.named_parameters():
        want = torch.bfloat16 if ref[name].dtype == jnp.bfloat16 else torch.float32
        assert p.dtype == tree[name].dtype == want, name
    assert {n for n, p in model.named_parameters() if p.dtype == torch.bfloat16} == {
        f"layers_{i}.block_sparse_moe.{k}" for i in range(2)
        for k in ("w_in", "b_in", "w_out", "b_out", "w_gate")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16_experts"])
def test_three_train_steps_match_the_reference(dtype):
    cfg, rcfg = _cfgs(dtype)
    rmodel = ref_mixtral.Mixtral(rcfg)
    toks = _tokens(1, T=17)
    params = jax.jit(rmodel.init)(jax.random.key(0), jnp.asarray(toks[:, :-1]))["params"]
    tx = optax.adamw(LR)
    step = ref_make_train_step(rmodel, tx, lambda lg, b: ref_xent(lg, b["target"]), donate=False)
    batch = {"input": jnp.asarray(toks[:, :-1]), "target": jnp.asarray(toks[:, 1:])}
    p, s, ref_losses = params, tx.init(params), []
    for _ in range(STEPS):
        p, s, loss = step(p, s, batch)
        ref_losses.append(float(loss))

    model = Mixtral(cfg, params_from_jax(params, device="cpu"), device="cpu")
    groups = param_dtype_groups(model.parameters())
    assert [g["state_dtype"] for g in groups] == (
        [torch.float32] if dtype == torch.float32 else [torch.float32, torch.bfloat16])
    opt = AdamWLowmem(groups, LR)
    tstep = make_train_step(model, opt, lambda lg, b: cross_entropy_loss(lg, b["target"]))
    t = torch.from_numpy(toks).long()
    losses = [float(tstep({"input": t[:, :-1], "target": t[:, 1:]})) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_REL[dtype])
    want = _flat(p)
    for name, q in model.named_parameters():
        np.testing.assert_allclose(q.detach().float().numpy(), _np(want[name]),
                                   rtol=PARAM_TOL[dtype], atol=PARAM_TOL[dtype], err_msg=name)
        assert opt.state[q]["exp_avg"].dtype == q.dtype
    # the optimizer's one state tree holds both groups
    tree = opt.state_tree(model)[0]
    assert int(tree.count) == STEPS and _flat(tree.mu).keys() == want.keys()


# --------------------------------------------------------- expert parallel
@pytest.fixture(scope="module")
def worlds():
    made = {n: child.World(n) for n in (2, 4)}  # both start together

    def get(n):
        return made[n]

    yield get
    for w in made.values():
        w.close()


@pytest.fixture(scope="module")
def reference_ep(worlds):  # the worlds start while this compiles
    """The reference DModule on a (dp, ep) = (2, 4) mesh over the numpy-
    seeded weights: logits, aux losses, and the grads of sum(logits * w)
    and of the aux losses apart."""
    _, rcfg = _cfgs()
    mesh = vt.DeviceMesh(("dp", "ep"), (2, 4))
    dm = ref_parallelize(ref_mixtral.Mixtral(rcfg), mesh, ref_mixtral.mixtral_plan(mesh))
    from vescale_tpu_torch.models import MixtralConfig as PCfg

    shapes = param_shapes(PCfg(**child.MIXTRAL_TINY, dtype=torch.float32))
    params = jax.tree_util.tree_map(jnp.asarray, child.moe_tree(shapes, 0))
    toks = jnp.asarray(child.moe_tokens(0))
    w = jnp.asarray(child.moe_readout(0))

    def parts(p):
        logits, state = dm.apply({"params": p}, toks, mutable=["losses"])
        aux = [state["losses"][f"layers_{i}"]["router_aux"][0] for i in range(rcfg.num_hidden_layers)]
        return jnp.sum(logits * w), sum(aux), logits, aux

    def grads(p):
        out_g = jax.grad(lambda q: parts(q)[0])(p)
        aux_g = jax.grad(lambda q: parts(q)[1])(p)
        _, _, logits, aux = parts(p)
        return logits, aux, out_g, aux_g

    logits, aux, out_g, aux_g = jax.jit(grads)(params)
    out_g, aux_g = _flat(out_g), _flat(aux_g)
    return dict(logits=np.asarray(logits), aux=[float(a) for a in aux],
                out_grads={k: np.asarray(v) for k, v in out_g.items()},
                all_grads={k: np.asarray(out_g[k] + aux_g[k]) for k in out_g})


EP_CASES = [([2], ["ep"], "plan", True), ([2], ["ep"], "experts", True),
            ([2, 2], ["dp", "ep"], "plan", True)]


@pytest.mark.parametrize("mesh_shape,names,api,aux", EP_CASES,
                         ids=["ep2_plan", "ep2_parallelize_experts", "dp2xep2_plan"])
def test_expert_parallel_matches_the_reference_mesh(worlds, reference_ep, mesh_shape, names, api,
                                                    aux):
    n = int(np.prod(mesh_shape))
    got = worlds(n).run("moe_ep_model", mesh_shape=mesh_shape, names=names, seed=0, api=api,
                        aux=aux)
    ref = reference_ep
    want = ref["all_grads"] if aux else ref["out_grads"]
    E = child.MIXTRAL_TINY["num_local_experts"]
    ep = mesh_shape[names.index("ep")]
    dp = mesh_shape[names.index("dp")] if "dp" in names else 1
    rows = ref["logits"].shape[0] // dp
    for r, g in enumerate(got):
        coord = np.unravel_index(r, mesh_shape)
        d = coord[names.index("dp")] if "dp" in names else 0
        e = coord[names.index("ep")]
        np.testing.assert_allclose(g["logits"], ref["logits"][d * rows:(d + 1) * rows],
                                   rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_allclose(g["aux"], ref["aux"], rtol=AUX_REL)
        lo = e * (E // ep)
        for i, (first, count) in enumerate(g["local_experts"]):
            assert (first, count) == (lo, E // ep), i
        for name, grad in g["grads"].items():
            full = want[name]
            if name.split(".")[-1] in ("w_in", "b_in", "w_out", "b_out", "w_gate"):
                full = full[lo:lo + E // ep]
            np.testing.assert_allclose(grad, full, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)
    # the replicated leaves' grads (the router's included) bitwise equal on
    # every ep rank of a dp row
    for r, g in enumerate(got):
        peer = got[r ^ 1]  # the other ep coordinate: ep is the inner dim
        for name, grad in g["grads"].items():
            if "block_sparse_moe" not in name or name.endswith("router"):
                assert np.array_equal(grad, peer["grads"][name]), name


# ----------------------------------------------------- HuggingFace layouts
def _fake_hf_mixtral(rcfg, seed=1):
    """tests/test_hf_convert.py:137-238's synthetic MixtralForCausalLM dict."""
    g = torch.Generator().manual_seed(seed)

    def W(o, i):
        return torch.randn(o, i, generator=g) * 0.05

    d, it, E = rcfg.hidden_size, rcfg.intermediate_size, rcfg.num_local_experts
    hd = rcfg.as_llama().head_dim
    sd = {"model.embed_tokens.weight": W(rcfg.vocab_size, d), "model.norm.weight": torch.ones(d),
          "lm_head.weight": W(rcfg.vocab_size, d)}
    for layer in range(rcfg.num_hidden_layers):
        p = f"model.layers.{layer}."
        sd[p + "self_attn.q_proj.weight"] = W(rcfg.num_attention_heads * hd, d)
        sd[p + "self_attn.k_proj.weight"] = W(rcfg.num_key_value_heads * hd, d)
        sd[p + "self_attn.v_proj.weight"] = W(rcfg.num_key_value_heads * hd, d)
        sd[p + "self_attn.o_proj.weight"] = W(d, rcfg.num_attention_heads * hd)
        sd[p + "input_layernorm.weight"] = torch.ones(d)
        sd[p + "post_attention_layernorm.weight"] = torch.ones(d)
        sd[p + "block_sparse_moe.gate.weight"] = W(E, d)
        for k in range(E):
            sd[p + f"block_sparse_moe.experts.{k}.w1.weight"] = W(it, d)
            sd[p + f"block_sparse_moe.experts.{k}.w2.weight"] = W(d, it)
            sd[p + f"block_sparse_moe.experts.{k}.w3.weight"] = W(it, d)
    return sd


def _trees_equal(port, ref):
    port, ref = _flat(port), _flat(ref)
    assert port.keys() == ref.keys()
    for k in ref:
        assert port[k].dtype == torch.float32 and np.array_equal(port[k].numpy(), np.asarray(ref[k])), k


def test_hf_mixtral_conversion_is_the_references():
    fields = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=1,
                  num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
                  num_experts_per_tok=2, capacity_factor=8.0, max_position_embeddings=32)
    cfg = MixtralConfig(**fields, dtype=torch.float32)
    rcfg = ref_mixtral.MixtralConfig(**fields, dtype=jnp.float32)
    sd = _fake_hf_mixtral(rcfg)
    tree, ref_tree = hf_mixtral_to_params(sd, cfg, device="cpu"), ref_convert.hf_mixtral_to_params(sd, rcfg)
    _trees_equal(tree, ref_tree)
    idx = np.array([[3, 9, 1, 40, 22, 5, 60, 11]])
    want, _ = jax.jit(lambda p, t: ref_mixtral.Mixtral(rcfg).apply(
        {"params": p}, t, mutable=["losses"]))(ref_tree, jnp.asarray(idx))
    got = Mixtral(cfg, tree, device="cpu")(torch.from_numpy(idx))
    assert ulps_at_scale(got.detach().numpy(), np.asarray(want)) <= LOGIT_ULPS
    with pytest.raises(ValueError, match="missing"):
        hf_mixtral_to_params({k: v for k, v in sd.items() if "experts.3.w2" not in k}, cfg,
                             device="cpu")
    with pytest.raises(ValueError, match="num_hidden_layers"):
        hf_mixtral_to_params({**sd, "model.layers.1.input_layernorm.weight": torch.ones(32)},
                             cfg, device="cpu")


def test_hf_llama_conversion_is_the_references():
    c = HF_LLAMA_CFG
    cfg = LlamaConfig(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                      intermediate_size=c.intermediate_size,
                      num_hidden_layers=c.num_hidden_layers,
                      num_attention_heads=c.num_attention_heads,
                      num_key_value_heads=c.num_key_value_heads,
                      max_position_embeddings=c.max_position_embeddings, dtype=torch.float32)
    sd = _fake_hf_state(c)
    tree, ref_tree = hf_llama_to_params(sd, cfg, device="cpu"), ref_convert.hf_llama_to_params(sd, c)
    _trees_equal(tree, ref_tree)
    idx = np.array([[1, 5, 9, 2, 33, 60, 7, 8]])
    want = ref_llama.Llama(c).apply({"params": ref_tree}, jnp.asarray(idx))
    got = Llama(cfg, tree, device="cpu")(torch.from_numpy(idx))
    assert ulps_at_scale(got.detach().numpy(), np.asarray(want)) <= LOGIT_ULPS
    with pytest.raises(ValueError, match="missing"):
        hf_llama_to_params({k: v for k, v in sd.items() if k != "lm_head.weight"}, cfg,
                           device="cpu")


def test_moe_cpu_rung_runs_and_its_loss_falls():
    run = bench.prepare("moe_cpu")
    out = bench.measure(run)
    assert out["device"] == "cpu" and out["mfu"] is None
    assert np.all(np.isfinite(out["losses"])) and out["losses"][-1] < out["losses"][0]
    assert out["active_params"] < out["params"]
    assert len(run.optimizer.param_groups) == 1  # fp32 config: one group
