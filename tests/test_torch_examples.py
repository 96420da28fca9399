"""The port's example programs (``vescale_tpu_torch/examples/``) against the
reference's (``examples/``), on the CPU, at small widths: the same weights
(the reference's key-0 init through ``params_from_jax``) and the same
batches (each package's ``TokenDataLoader`` over one corpus file, or
numpy-seeded tokens).

Held:
  * the loss parity of nanoGPT and Llama-2 at ``loss_parity.py``'s
    configs, 6 steps: the port's one-device run against the reference's
    within 1e-5 relative in fp32 and 1% in bf16 (the reference README's
    bar), and the port's (dp, tp) = (2, 4) run on eight gloo ranks (the
    ``torchrun`` rendezvous) against its own one-device run, the same;
  * Mixtral over (dp, ep) = (2, 2) on four ranks, 3 steps, aux losses in
    the loss: within 2e-5 of the reference;
  * OpenLLaMA's tiny config at T=128 within 1e-5; the MFU calculator equal
    to the reference's; ``--hf-ckpt`` read from a shard written here;
  * resilient training: a crash at step 12 of 20 (exit 137) and a resume
    bitwise an uninterrupted run; the loss scale's trajectory the
    reference's;
  * fp8 in fp32 compute: scales equal, the first step's loss and amax
    head within 1e-5, later steps within ``FP8_STEPS_REL`` (a stated
    departure);
  * the auto-split pipeline: the stages' parameter lists the reference's
    at 2 and 3 stages, losses within 1e-5 of the unsplit model's;
  * the attention kernels' head-dim contract: every head dim of every
    config the port ships is accepted, others raise, and the plain
    versions at D = 100 against the reference's functions.
"""

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import vescale_tpu as vt
from vescale_tpu.dmodule import parallelize_module as ref_parallelize
from vescale_tpu.kernels.flash_attention import _flash_bwd_pallas, _flash_fwd_pallas
from vescale_tpu.kernels.paged_attention import paged_decode as jax_paged_decode

from vescale_tpu_torch.examples import (_common, autosplit_pipeline, fp8_train,
                                        llama_mfu_calculator, open_llama_4d_benchmark,
                                        resilient_train)
from vescale_tpu_torch.kernels import kernel_head_dim, ulps_at_scale
from vescale_tpu_torch.models import params_from_jax
from vescale_tpu_torch.testing import make_child_env, run_gloo_world

from torch_reset import dormant_module, dormant_test  # noqa: F401 (autouse: both packages dormant)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
PARITY_STEPS = 6
FP32_REL = 1e-5
BF16_REL = 1e-2  # the reference README's bar for bf16 ("~1%")
OWG = "_overwrite_with_gradient"
# fp8 losses and amax histories after the first update, relative (measured
# 9.3e-4 for a loss and 7.8e-3 for a history entry by the fourth step)
FP8_STEPS_REL = 1e-2


def _ref_example(rel_path: str, name: str):
    """A reference example program, imported from its file."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "examples", rel_path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torchrun(n: int, module: str, args, out: str, timeout: float = 150.0) -> dict:
    """``module`` on ``n`` gloo ranks of the CPU joined as ``torchrun``
    joins them (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, from the gloo rig); returns the JSON rank 0 wrote to
    ``out``."""
    def spawn(port):
        return [subprocess.Popen([sys.executable, "-m", module, *args, "--cpu", "--out", out],
                                 env=make_child_env(port, r, n), cwd=REPO,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(n)]

    results = run_gloo_world(spawn, timeout=timeout)
    bad = [(r, rc) for r, (rc, _) in enumerate(results) if rc != 0]
    assert not bad, f"ranks {bad} failed:\n" + "\n".join(log[-3000:] for _, log in results)
    with open(out) as f:
        return json.load(f)


def _rel(a, b) -> float:
    return max(abs(x - y) / max(abs(y), 1e-9) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("corpus") / "corpus_char.bin")
    _common.build_corpus_bin(path, None, max_bytes=1 << 20)
    return path


def test_corpus_file_is_the_references(tmp_path, corpus):
    ref = _ref_example("nanogpt_4d_finetune/loss_parity.py", "ref_nanogpt_parity")
    want = str(tmp_path / "ref.bin")
    assert ref.build_corpus_bin(want, None, max_bytes=1 << 20) == 256
    with open(want, "rb") as a, open(corpus, "rb") as b:
        assert a.read() == b.read()


# ------------------------------------------------------------ loss parity
PARITY = {
    # model: (reference program, port module, cfg_kw, port flags)
    "nanogpt": ("nanogpt_4d_finetune/loss_parity.py", "nanogpt_4d_finetune",
                dict(n_layer=4, n_embd=128, n_head=4), []),
    "llama2": ("llama2_4d_finetune/loss_parity.py", "llama2_4d_finetune",
               dict(hidden_size=128, intermediate_size=256, num_hidden_layers=4,
                    num_attention_heads=4, num_key_value_heads=2), []),
}


def _ref_parity_params(model: str, cfg_kw, seq: int):
    """The reference run's init: its model under its plan on a (1, 1) mesh,
    ``dm.init(key(0), ones((2, seq)))``, as ``loss_parity.py::run`` makes it."""
    mesh = vt.DeviceMesh(("dp", "tp"), (1, 1))
    if model == "nanogpt":
        from vescale_tpu.models.nanogpt import GPT, GPTConfig, nanogpt_plan

        cfg = GPTConfig(block_size=seq, vocab_size=256, dropout=0.0, dtype=jnp.float32, **cfg_kw)
        dm = ref_parallelize(GPT(cfg), mesh, nanogpt_plan(mesh, sequence_parallel=True))
    else:
        from vescale_tpu.models.llama import Llama, LlamaConfig, llama_plan

        cfg = LlamaConfig(vocab_size=256, max_position_embeddings=seq, dtype=jnp.float32,
                          use_flash_attention=False, **cfg_kw)
        dm = ref_parallelize(Llama(cfg), mesh, llama_plan(mesh, sequence_parallel=True))
    return _np_tree(dm.init(jax.random.key(0), jnp.ones((2, seq), jnp.int32))["params"])


@pytest.mark.parametrize("model", sorted(PARITY))
def test_loss_parity_one_device_and_4d_against_the_reference(tmp_path, corpus, model):
    ref_path, port_mod, cfg_kw, flags = PARITY[model]
    ref = _ref_example(ref_path, f"ref_{model}_parity")
    batch, seq, lr = 8, 128, 1e-3
    init = str(tmp_path / "init.npz")
    _common.save_tree(init, _ref_parity_params(model, cfg_kw, seq))
    got = _torchrun(8, f"vescale_tpu_torch.examples.{port_mod}",
                    ["parity", "--steps", str(PARITY_STEPS), "--data", corpus, "--init", init,
                     *flags], str(tmp_path / "out.json"))
    for dtype_name, bar in (("fp32", FP32_REL), ("bf16", BF16_REL)):
        want = ref.run((1, 1), PARITY_STEPS, batch, seq, cfg_kw, corpus, dtype_name, lr)
        base, par = got[dtype_name]["base"], got[dtype_name]["par"]
        assert len(base) == len(par) == PARITY_STEPS
        assert _rel(base, want) <= bar, (dtype_name, base, want)
        assert _rel(par, base) <= bar, (dtype_name, par, base)
        assert base[-1] < base[0] - 1.0  # it learns


# ------------------------------------------------------------------ mixtral
MIXTRAL = dict(bsz=4, seqlen=32, layers=2, hidden=64, inter=128, experts=4)


def test_mixtral_ep_over_dp_and_ep_against_the_reference(tmp_path):
    from vescale_tpu.models.mixtral import Mixtral, MixtralConfig
    from vescale_tpu.models.nanogpt import cross_entropy_loss

    m = MIXTRAL
    cfg = MixtralConfig(vocab_size=32000, hidden_size=m["hidden"], intermediate_size=m["inter"],
                        num_hidden_layers=m["layers"], num_attention_heads=8,
                        num_key_value_heads=4, num_local_experts=m["experts"],
                        num_experts_per_tok=2, dtype=jnp.float32)
    model = Mixtral(cfg)
    params = model.init(jax.random.key(0), jnp.ones((2, m["seqlen"]), jnp.int32))["params"]
    init = str(tmp_path / "init.npz")
    _common.save_tree(init, _np_tree(params))
    toks = jnp.asarray(_common.seeded_tokens(1, m["bsz"], m["seqlen"], 32000))
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
    tx = optax.adamw(3e-4)

    @jax.jit
    def step(p, s):
        def lf(p):
            logits, aux = model.apply({"params": p}, batch["input"], mutable=["losses"])
            return cross_entropy_loss(logits, batch["target"]) + sum(
                jax.tree_util.tree_leaves(aux["losses"]))

        loss, grads = jax.value_and_grad(lf)(p)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    p, s, want = params, tx.init(params), []
    for _ in range(3):
        p, s, loss = step(p, s)
        want.append(float(loss))
    got = _torchrun(4, "vescale_tpu_torch.examples.mixtral_4d_benchmark",
                    ["--dp", "2", "--ep", "2", "--steps", "2", "--init", init,
                     *(f"--{k}={v}" for k, v in m.items())], str(tmp_path / "out.json"))
    assert got["mesh"] == {"dp": 2, "ep": 2} and len(got["losses"]) == 3
    assert _rel(got["losses"], want) <= 2e-5, (got["losses"], want)


# --------------------------------------------------------------- open llama
def test_open_llama_tiny_against_the_reference():
    from vescale_tpu.models.llama import Llama, llama_plan
    from vescale_tpu.models.nanogpt import cross_entropy_loss
    from vescale_tpu.parallel.optimizer import adamw_lowmem, zero_sharded
    from vescale_tpu.train import make_train_step

    seq, steps = 128, 3
    cfg = open_llama_4d_benchmark.config(True, seq, torch.float32, False)
    from vescale_tpu.models.llama import LlamaConfig

    ref_cfg = LlamaConfig(
        vocab_size=32000, hidden_size=256, intermediate_size=512, num_hidden_layers=4,
        num_attention_heads=8, num_key_value_heads=4, max_position_embeddings=seq,
        dtype=jnp.float32)
    assert (cfg.hidden_size, cfg.num_attention_heads, cfg.use_flash_attention) == (256, 8, True)
    mesh = vt.DeviceMesh(("dp", "tp"), (1, 1))
    dm = ref_parallelize(Llama(ref_cfg), mesh, llama_plan(mesh, sequence_parallel=True))
    params = dm.init(jax.random.key(0), jnp.ones((2, seq), jnp.int32))["params"]
    pspecs = jax.tree_util.tree_map(lambda x: x.sharding.spec, params)
    tx = zero_sharded(adamw_lowmem(3e-5), mesh, pspecs, dp_dims=("dp",))
    step = make_train_step(dm, tx, lambda lg, b: cross_entropy_loss(lg, b["target"]), donate=False)
    toks = jnp.asarray(_common.seeded_tokens(0, 2, seq, 32000))
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
    p, s, want = params, tx.init(params), []
    for _ in range(steps):
        p, s, loss = step(p, s, batch, jax.random.key(1))
        want.append(float(loss))
    got = open_llama_4d_benchmark.run(tiny=True, seq=seq, steps=1, warmup=2, device=CPU,
                                      params=params_from_jax(_np_tree(params), device="cpu"))
    assert _rel(got["losses"], want) <= FP32_REL, (got["losses"], want)
    assert got["mfu"] is None and got["params"] == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))


def test_mfu_calculator_is_the_references():
    ref = _ref_example("open_llama_4d_benchmark/llama_mfu_calculator.py", "ref_mfu")
    for args in ((4096, 11008, 32, 32000, 4096), (3200, 8640, 26, 32000, 2048, 1.0),
                 (2048, 5632, 24, 32000, 4096, 0.5), (256, 512, 4, 32000, 128, 0.5)):
        fpt = llama_mfu_calculator.llama_flops_per_token(*args)
        assert fpt == ref.llama_flops_per_token(*args)
        assert llama_mfu_calculator.mfu(1234.5, fpt, 459e12) == ref.mfu(1234.5, fpt, 459e12)
    # the port's default peak is the H100 SXM's bf16, not the v5p's
    assert llama_mfu_calculator.mfu(1.0, 989e12) == 1.0
    # OpenLLaMA-3B at T=2048: 21.98 GFLOP a token
    fpt = llama_mfu_calculator.llama_flops_per_token(3200, 8640, 26, 32000, 2048, 1.0)
    assert abs(fpt - 2.198e10) < 1e8


def test_open_llama_trains_from_an_hf_checkpoint(tmp_path):
    from safetensors.numpy import save_file

    from vescale_tpu.models.convert import load_hf_llama as ref_load

    seq = 32
    cfg = open_llama_4d_benchmark.config(True, seq, torch.float32, False)
    rng = np.random.default_rng(3)
    E, I, V, H, KV = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, 8, 4
    hd = E // H
    sd = {"model.embed_tokens.weight": rng.normal(size=(V, E)),
          "model.norm.weight": 1.0 + 0.1 * rng.normal(size=(E,)),
          "lm_head.weight": rng.normal(size=(V, E)) / math.sqrt(E)}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        for n, shape in (("self_attn.q_proj", (H * hd, E)), ("self_attn.k_proj", (KV * hd, E)),
                         ("self_attn.v_proj", (KV * hd, E)), ("self_attn.o_proj", (E, H * hd)),
                         ("mlp.gate_proj", (I, E)), ("mlp.up_proj", (I, E)),
                         ("mlp.down_proj", (E, I))):
            sd[p + n + ".weight"] = rng.normal(size=shape) / math.sqrt(shape[1])
        for n in ("input_layernorm", "post_attention_layernorm"):
            sd[p + n + ".weight"] = 1.0 + 0.1 * rng.normal(size=(E,))
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    d = tmp_path / "hf"
    d.mkdir()
    save_file(sd, str(d / "model-00001-of-00001.safetensors"))
    from vescale_tpu.models.llama import LlamaConfig

    ref_cfg = LlamaConfig(
        vocab_size=V, hidden_size=E, intermediate_size=I, num_hidden_layers=4,
        num_attention_heads=H, num_key_value_heads=KV, max_position_embeddings=seq,
        dtype=jnp.float32)
    want = _np_tree(ref_load(str(d), ref_cfg))
    a = open_llama_4d_benchmark.run(tiny=True, seq=seq, steps=0, warmup=1, device=CPU,
                                    hf_ckpt=str(d))
    b = open_llama_4d_benchmark.run(tiny=True, seq=seq, steps=0, warmup=1, device=CPU,
                                    params=params_from_jax(want, device="cpu"))
    assert a["losses"] == b["losses"] and np.isfinite(a["losses"][0])


# --------------------------------------------------------------- resilient
def _resilient(tmp_path, ckpt: str, name: str, *extra) -> "subprocess.CompletedProcess":
    """The example as its own process on one CPU thread: CPU bf16 products
    on several threads sum in a varying order, one thread in a fixed one
    (the card's kernels are deterministic)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("VESCALE_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    args = ["--dp", "1", "--tp", "1", "--steps", "20", "--save-every", "5", "--cpu",
            "--ckpt-dir", str(tmp_path / ckpt), "--out", str(tmp_path / f"{name}.json")]
    return subprocess.run([sys.executable, "-m", "vescale_tpu_torch.examples.resilient_train",
                           *args, *extra], env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=150)


def test_resilient_crash_and_resume_is_bitwise_an_uninterrupted_run(tmp_path):
    out = _resilient(tmp_path, "crashed", "crash", "--crash-at", "12")
    assert out.returncode == resilient_train.CRASH_EXIT_CODE, out.stdout[-2000:] + out.stderr[-2000:]
    assert "[crash] simulating SIGKILL at step 12" in out.stdout
    for name, ckpt in (("resumed", "crashed"), ("whole", "whole")):
        out = _resilient(tmp_path, ckpt, name)
        assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    resumed, whole = (json.loads((tmp_path / f"{n}.json").read_text())
                      for n in ("resumed", "whole"))
    # the newest committed step of 0, 5 and 10: fire-and-forget saves still
    # in flight when the child died are lost, as a kill loses them
    assert resumed["start"] in (1, 6, 11) and whole["start"] == 0
    assert resumed["digest"] == whole["digest"]
    for i in range(resumed["start"], 20):
        assert resumed["losses"][str(i)] == whole["losses"][str(i)], i
        assert resumed["scales"][str(i)] == whole["scales"][str(i)], i
    assert resumed["latest"] == whole["latest"] == 19


def test_resilient_loss_scale_trajectory_is_the_references(tmp_path):
    from vescale_tpu.models.nanogpt import GPT, GPTConfig, cross_entropy_loss, nanogpt_plan
    from vescale_tpu.parallel import DistributedOptimizer

    steps = 6
    cfg = GPTConfig(block_size=128, vocab_size=512, n_layer=4, n_head=8, n_embd=256,
                    dropout=0.0, dtype=jnp.bfloat16)
    mesh = vt.DeviceMesh(("dp", "tp"), (1, 1))
    dm = ref_parallelize(GPT(cfg), mesh, nanogpt_plan(mesh))
    params = dm.init(jax.random.key(0), jnp.ones((2, cfg.block_size), jnp.int32))["params"]
    pspecs = jax.tree_util.tree_map(lambda p: p.sharding.spec, params)
    dopt = DistributedOptimizer(optax.adamw(3e-4), mesh, pspecs, grad_clip=1.0,
                                loss_scale="dynamic")
    opt_state = dopt.init(params)

    @jax.jit
    def step_fn(params, opt_state, batch):
        def lf(p):
            logits = dm.apply({"params": p}, batch["input"])
            return dopt.scale_loss(cross_entropy_loss(logits, batch["target"]), opt_state)

        loss, grads = jax.value_and_grad(lf)(params)
        unscaled = loss / dopt.current_scale(opt_state)
        params, opt_state = dopt.step(params, opt_state, grads)
        return params, opt_state, unscaled

    rng = np.random.default_rng(0)
    want_loss, want_scale = [], []
    for _ in range(steps):
        toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (4, cfg.block_size + 1)), jnp.int32)
        params, opt_state, loss = step_fn(params, opt_state,
                                          {"input": toks[:, :-1], "target": toks[:, 1:]})
        want_loss.append(float(loss))
        want_scale.append(float(dopt.current_scale(opt_state)))
    init = dm.init(jax.random.key(0), jnp.ones((2, cfg.block_size), jnp.int32))["params"]
    got = resilient_train.run(dp=1, tp=1, steps=steps, save_every=100,
                              ckpt_dir=str(tmp_path / "c"), device=CPU, log=lambda *_: None,
                              params=params_from_jax(_np_tree(init), device="cpu"))
    assert [got["scales"][i] for i in range(steps)] == want_scale
    # bf16 compute: the reference README's bar
    assert _rel([got["losses"][i] for i in range(steps)], want_loss) <= BF16_REL


# --------------------------------------------------------------------- fp8
def test_fp8_train_in_fp32_against_the_reference():
    from vescale_tpu.models.llama import Llama, LlamaConfig, llama_plan
    from vescale_tpu.models.nanogpt import cross_entropy_loss
    from vescale_tpu.parallel.optimizer import DistributedOptimizer
    from vescale_tpu.train import make_train_step

    steps = 4
    cfg = LlamaConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=4, num_attention_heads=8, num_key_value_heads=4,
                      max_position_embeddings=128, dtype=jnp.float32, use_flash_attention=False,
                      use_fp8=True)
    mesh = vt.DeviceMesh(("dp", "tp"), (1, 1))
    dm = ref_parallelize(Llama(cfg), mesh, llama_plan(mesh))
    variables = dm.init(jax.random.key(0), jnp.ones((2, 64), jnp.int32))
    bundle = {"params": variables["params"], OWG: variables[OWG]}
    start = _np_tree(bundle)
    pspecs = jax.tree_util.tree_map(lambda p: p.sharding.spec, variables["params"])
    dopt = DistributedOptimizer(optax.adamw(3e-4), mesh, pspecs, loss_scale="dynamic",
                                init_scale=2.0 ** 10)
    opt_state = dopt.init(variables["params"])
    step = make_train_step(dm, dopt, lambda lg, b: cross_entropy_loss(lg, b["target"]),
                           donate=False)
    toks = jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 65)), jnp.int32)
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
    want_loss, want_scale, want_head = [], [], []
    for _ in range(steps):
        bundle, opt_state, loss = step(bundle, opt_state, batch)
        want_loss.append(float(loss))
        want_scale.append(float(dopt.current_scale(opt_state)))
        want_head.append(np.asarray(jax.tree_util.tree_leaves(bundle[OWG])[0])[:3])
    got = fp8_train.run(steps=steps, device=CPU, params=params_from_jax(start, device="cpu"))
    assert got["scales"] == want_scale
    # the first step runs the two packages' models on the same weights
    assert _rel(got["losses"][:1], want_loss[:1]) <= FP32_REL, (got["losses"], want_loss)
    np.testing.assert_allclose(got["amax_heads"][0], want_head[0], rtol=FP32_REL, atol=0)
    # after an update the weights differ in their last fp32 bits, and a bit
    # at an e4m3 rounding edge moves a whole fp8 step (ROADMAP.md §C: fp8 is
    # bitwise flax's per op, not per model)
    assert _rel(got["losses"], want_loss) <= FP8_STEPS_REL, (got["losses"], want_loss)
    for a, b in zip(got["amax_heads"], want_head):
        np.testing.assert_allclose(a, b, rtol=FP8_STEPS_REL, atol=0)
    assert got["amax_head"][0] > 0 and got["losses"][-1] < got["losses"][0]


# --------------------------------------------------------------- autosplit
@pytest.fixture(scope="module")
def tangled():
    ref = _ref_example("autosplit_pipeline/train.py", "ref_autosplit")
    model = ref.TangledLM()
    params = model.init(jax.random.key(0), jnp.ones((2, 32), jnp.int32))["params"]
    return model, params


@pytest.mark.parametrize("stages", [2, 3])
def test_autosplit_stages_against_the_reference(tangled, stages):
    """The stages' parameter lists equal the reference's jaxpr cut at 2 and
    3 stages (the TangledNet departure of ROADMAP.md §C does not arise on
    the example's model); the split model trains as the unsplit one."""
    from vescale_tpu.pipe import split_graph as ref_split
    from vescale_tpu.plan import PipelineParallelPlan as RefPlan
    from vescale_tpu.plan import PipelineScheduleType as RefSched

    model, params = tangled
    plan = RefPlan(num_stages=stages, schedule_type=RefSched.SIMPLE_1F1B, use_zero_bubble=True)
    gm = ref_split(lambda p, x: model.apply({"params": p}, x), params,
                   jnp.ones((2, 32), jnp.int32), plan)
    got = autosplit_pipeline.run(stages=stages, zero_bubble=True, steps=3, device=CPU,
                                 params=params_from_jax(_np_tree(params), device="cpu"),
                                 unsplit=True)
    assert got["groups"] == [list(gm.group_param_names(g)) for g in range(gm.num_groups)]
    assert got["shared_groups"] == sorted(gm.shared_groups) == ["emb.embedding"]
    assert _rel(got["losses"], got["unsplit_losses"]) <= FP32_REL
    assert got["losses"][-1] < got["losses"][0]


# ------------------------------------------------------- head-dim contract
def _every_config():
    """(name, head dim) of every Llama, GPT and Mixtral config the port
    ships: ``models``' constants, ``bench``'s rungs and the examples'."""
    import dataclasses

    from vescale_tpu_torch import bench, models
    from vescale_tpu_torch.examples import (llama2_4d_finetune, mixtral_4d_benchmark,
                                            nanogpt_4d_finetune)
    from vescale_tpu_torch.models import GPTConfig, LlamaConfig, MixtralConfig

    out = []

    def add(name, c):
        if isinstance(c, GPTConfig):
            out.append((name, c.n_embd // c.n_head))
        else:
            out.append((name, c.hidden_size // c.num_attention_heads))

    for mod in (models, models.llama, models.mixtral, models.nanogpt):
        for n, v in vars(mod).items():
            if isinstance(v, (LlamaConfig, GPTConfig, MixtralConfig)):
                add(f"{mod.__name__}.{n}", v)
    add("GPTConfig()", GPTConfig())
    for n, (kw, *_) in bench.RUNGS.items():
        add(f"bench.{n}", LlamaConfig(**kw))
    for n, (kw, *_) in bench.GPT_RUNGS.items():
        add(f"bench.{n}", dataclasses.replace(GPTConfig(), **kw))
    for n in bench.MOE_RUNGS:
        add(f"bench.{n}", bench.moe_config(n))
    add("open_llama tiny", open_llama_4d_benchmark.config(True, 128, torch.float32, False))
    add("open_llama 3b", open_llama_4d_benchmark.config(False, 2048, torch.bfloat16, True))
    add("llama2 tiny", llama2_4d_finetune.config(True, 256, torch.float32))
    add("llama2 7b", llama2_4d_finetune.config(False, 256, torch.bfloat16))
    add("llama2 parity", llama2_4d_finetune.parity_config(128, torch.float32, dict(
        hidden_size=128, intermediate_size=256, num_hidden_layers=4, num_attention_heads=4,
        num_key_value_heads=2)))
    add("nanogpt train", GPTConfig(block_size=256, n_layer=4, n_head=8, n_embd=256))
    add("nanogpt parity", GPTConfig(block_size=128, vocab_size=256, n_layer=4, n_head=4,
                                    n_embd=128))
    add("mixtral example", mixtral_4d_benchmark.config(512, 1024, 2, 8, torch.bfloat16))
    add("fp8", fp8_train.config(True))
    add("resilient", resilient_train.config())
    return out


def test_attention_kernels_take_every_head_dim_the_port_ships():
    configs = _every_config()
    dims = {d for _, d in configs}
    assert {16, 32, 64, 100, 128} <= dims, sorted(dims)
    for name, d in configs:
        w = kernel_head_dim(name, d)
        assert w in (64, 128) and d <= w, (name, d)
    for d in (2, 6, 98, 130, 256):
        with pytest.raises(ValueError, match="head_dim"):
            kernel_head_dim("flash", d)


def test_the_kernels_shape_checks_hold_the_head_dim_contract():
    """The wrappers' shape checks (run before every launch, here on CPU
    tensors) take the head dims of the contract and refuse the others; the
    flash wrappers pad a head dim to the kernels' width; the costs count
    the work at that width on the card and at D elsewhere."""
    from vescale_tpu_torch.kernels import flash_attention as F
    from vescale_tpu_torch.kernels import paged_attention as PA

    def pool(d):
        return torch.zeros(3, 4, 2, d)

    table, lengths = torch.zeros(2, 2, dtype=torch.int32), torch.ones(2, dtype=torch.int32)
    for d in (16, 32, 64, 100, 128):
        q, kv = torch.zeros(8, 16, d), torch.zeros(4, 16, d)
        assert F.check_shapes("flash_fwd", q, kv, kv, 4, 2, do=q) == (2, 16, d)
        PA.check_shapes(torch.zeros(2, 4, d), pool(d), pool(d), table, lengths)
        padded = F._padded(d, q, kv)
        assert [t.shape[-1] for t in padded] == [kernel_head_dim("x", d)] * 2
        assert all(torch.equal(t[..., :d], s) and not t[..., d:].any()
                   for t, s in zip(padded, (q, kv)))
    for d in (6, 98, 130):
        q, kv = torch.zeros(8, 16, d), torch.zeros(4, 16, d)
        with pytest.raises(ValueError, match="head_dim"):
            F.check_shapes("flash_fwd", q, kv, kv, 4, 2)
        with pytest.raises(ValueError, match="head_dim"):
            PA.check_shapes(torch.zeros(2, 4, d), pool(d), pool(d), table, lengths)
    cpu_q = torch.zeros(4, 8, 100)
    assert F.flash_fwd_cost(cpu_q, cpu_q, cpu_q, causal=True, H=4, KV=4)[0] == \
        2 * 8 * 8 * 4 * 100
    assert PA.paged_decode_cost(torch.zeros(1, 1, 100), pool(100)[:, :, :1],
                                pool(100)[:, :, :1], torch.zeros(1, 2, dtype=torch.int32),
                                torch.tensor([3], dtype=torch.int32))[0] == 4 * 3 * 1 * 100


def _to3(x):
    B, T, H, D = x.shape
    return np.ascontiguousarray(np.transpose(x, (0, 2, 1, 3)).reshape(B * H, T, D))


def test_plain_versions_at_head_dim_100_against_the_reference():
    """OpenLLaMA-3B's head dim: the flash forward and backward plain
    versions against the reference's Pallas kernels (interpreted) and the
    paged decode's against the reference's, at D = 100."""
    from vescale_tpu_torch.kernels.flash_attention import flash_bwd_reference, flash_fwd_reference
    from vescale_tpu_torch.kernels.paged_attention import paged_decode_reference

    B, T, H, KV, D = 1, 32, 4, 2, 100
    rng = np.random.default_rng(100)
    q, do = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, T, KV, D)).astype(np.float32) for _ in range(2))
    scale = 1.0 / math.sqrt(D)
    q3, k3, v3, do3 = (_to3(x) for x in (q, k, v, do))
    t = lambda x: torch.from_numpy(np.array(x, np.float32))  # noqa: E731
    o, lse = flash_fwd_reference(t(q3), t(k3), t(v3), scale=scale, causal=True, H=H, KV=KV)
    po, plse = _flash_fwd_pallas(jnp.asarray(q3), jnp.asarray(k3), jnp.asarray(v3), scale, True,
                                 16, 16, True, H, KV)
    assert ulps_at_scale(o.numpy(), np.asarray(po)) <= 8.0
    assert ulps_at_scale(lse.numpy().reshape(-1), np.asarray(plse).reshape(-1)) <= 8.0
    grads = flash_bwd_reference(t(q3), t(k3), t(v3), o, t(do3), lse, scale=scale, causal=True,
                                H=H, KV=KV)
    ref = _flash_bwd_pallas(*(jnp.asarray(x) for x in (q3, k3, v3, o.numpy(), do3)),
                            jnp.asarray(lse.numpy().reshape(B * H, T, 1)), scale, True, 16, 16,
                            True, H, KV)
    for g, r in zip(grads, ref):
        assert ulps_at_scale(g.numpy(), np.asarray(r)) <= 16.0
    S, page, Pmax = 3, 4, 4
    N = S * Pmax + 1
    kp, vp = (rng.normal(size=(N, page, KV, D)).astype(np.float32) for _ in range(2))
    qd = rng.normal(size=(S, H, D)).astype(np.float32)
    table = rng.permutation(np.arange(1, N))[: S * Pmax].reshape(S, Pmax).astype(np.int32)
    lengths = np.array([1, 7, 16], np.int32)
    want = jax_paged_decode(*(jnp.asarray(x) for x in (qd, kp, vp, table, lengths)),
                            scale=scale, interpret=True)
    got = paged_decode_reference(t(qd), t(kp), t(vp), torch.from_numpy(table),
                                 torch.from_numpy(lengths), scale=scale)
    assert ulps_at_scale(got.numpy(), np.asarray(want)) <= 8.0
