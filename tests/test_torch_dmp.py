"""The port's auto-plan (``vescale_tpu_torch/dmp``) held to the JAX
reference's.

Mirrors the auto-plan tests of ``tests/test_aux_subsystems.py:116-283``.
The MEGATRON policy reads parameter names and shapes; the port's modules
keep flax's names and (in, out) kernels, so on the same configs its plan
equals the reference policy's entry for entry (exact), and resolves, like
the reference's, to the hand plans' per-parameter placements and
per-module forward placements for nanoGPT, Llama and the scanned Llama.
On gloo worlds of 2 and 4 (``tests/torch_spmd_child.py``'s ``dmp_auto``
case) ``auto_parallelize_module`` gives every parameter its hand plan's
placements, and the logits and train losses bitwise the hand plan's.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vescale_tpu as vt
from vescale_tpu.dmp.policies.megatron import megatron_policy as ref_policy

import torch_spmd_child as child
from torch_spmd_child import enc

from vescale_tpu_torch.dmodule.api import PlacementsInterface, _match
from vescale_tpu_torch.dmp import PlanGenerator, get_policy, register_policy
from vescale_tpu_torch.dmp.policies.megatron import megatron_policy
from vescale_tpu_torch.mesh import DeviceMesh
from vescale_tpu_torch.placements import normalize_placements

GPT_CFG = dict(block_size=16, vocab_size=64, n_layer=2, n_head=2, n_embd=32)
LLAMA_CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=32)


@pytest.fixture(scope="module")
def worlds():
    made = {}

    def get(n):
        if n not in made:
            made[n] = child.World(n)
        return made[n]

    yield get
    for w in made.values():
        w.close()


def _mesh():
    return DeviceMesh(("dp", "tp"), (2, 4), device_type="cpu")


def _port_params(kind, scanned=False):
    from vescale_tpu_torch.models import GPT, GPTConfig, Llama, LlamaConfig

    if kind == "gpt":
        return dict(GPT(GPTConfig(**GPT_CFG), device="meta").named_parameters())
    cfg = LlamaConfig(dtype=torch.float32, scan_layers=scanned, **LLAMA_CFG)
    return dict(Llama(cfg, device="meta").named_parameters())


def _ref_params(kind, scanned=False):
    from vescale_tpu.models.llama import Llama, LlamaConfig
    from vescale_tpu.models.nanogpt import GPT, GPTConfig

    idx = jnp.ones((2, 8), jnp.int32)
    if kind == "gpt":
        model = GPT(GPTConfig(**GPT_CFG))
    else:
        model = Llama(LlamaConfig(dtype=jnp.float32, scan_layers=scanned, **LLAMA_CFG))
    return jax.eval_shape(lambda: model.init(jax.random.key(0), idx))["params"]


def _expand(plan, params, mesh):
    """A regex plan resolved against named parameters: each parameter's
    placements and each module's forward (input, output) placements, as
    ``enc`` lists."""
    paths = {}
    modules = {""}
    for path, leaf in params.items():
        paths[path] = len(leaf.shape)
        parts = path.split(".")[:-1]
        for i in range(1, len(parts) + 1):
            modules.add(".".join(parts[:i]))
    pp = {}
    for path, nd in paths.items():
        _pat, v = _match(plan.get("parameter", {}), path)
        pp[path] = [enc(p) for p in normalize_placements(v, mesh.ndim, nd)]

    def norm(lst):
        if lst is None:
            return None
        return [None if p is None else [enc(q) for q in normalize_placements(p, mesh.ndim, 3)]
                for p in lst]

    fp = {}
    for fqn in sorted(modules):
        hit = None
        for pattern, v in plan.get("forward", {}).items():
            if ":" not in pattern and re.fullmatch(pattern, fqn):
                hit = PlacementsInterface.normalize(v)
                break
        fp[fqn] = None if hit is None else (norm(hit.input), norm(hit.output))
    return pp, fp


def _enc_plan(plan, ndims):
    """A plan's entries as ``enc`` lists (either package's placements)."""
    def e(v, nd):
        return [enc(p) for p in v] if isinstance(v, (list, tuple)) else v

    param = {k: e(v, ndims.get(k)) for k, v in plan["parameter"].items()}
    fwd = {k: {io: [e(p, 3) for p in v[io]] for io in ("input", "output")}
           for k, v in plan["forward"].items()}
    return param, fwd


@pytest.mark.parametrize("kind,scanned", [("gpt", False), ("llama", False), ("llama", True)])
def test_policy_plan_is_the_references(kind, scanned):
    """The port's MEGATRON plan equals the reference policy's on the same
    config: the same escaped-name keys (each matches one parameter, so
    their order does not matter), the same placements, the same forward
    entries in the same order."""
    port = megatron_policy(_port_params(kind, scanned), _mesh())
    ref = ref_policy(_ref_params(kind, scanned), vt.DeviceMesh(("dp", "tp"), (2, 4)))
    assert sorted(port["parameter"]) == sorted(ref["parameter"])
    assert list(port["forward"]) == list(ref["forward"])
    assert _enc_plan(port, {}) == _enc_plan(ref, {})


def test_auto_plan_matches_hand_plan():
    """The MEGATRON plan resolves to the hand-written plans' per-parameter
    placements and per-module forward placements (nanoGPT and Llama)."""
    from vescale_tpu_torch.models import llama_plan, nanogpt_plan

    mesh = _mesh()
    for kind, hand in (("gpt", nanogpt_plan(mesh)), ("llama", llama_plan(mesh))):
        params = _port_params(kind)
        ap, af = _expand(megatron_policy(params, mesh), params, mesh)
        hp, hf = _expand(hand, params, mesh)
        assert ap == hp, {k: (ap[k], hp[k]) for k in ap if ap[k] != hp[k]}
        assert af == hf, {k: (af[k], hf[k]) for k in af if af[k] != hf[k]}


def test_auto_parallelize_scanned_llama():
    """Stacked (L, in, out) block kernels shard one dim further in, as
    ``llama_plan(scanned=True)`` does."""
    from vescale_tpu_torch.models import llama_plan

    mesh = _mesh()
    params = _port_params("llama", scanned=True)
    ap, _ = _expand(megatron_policy(params, mesh), params, mesh)
    hp, _ = _expand(llama_plan(mesh, scanned=True), params, mesh)
    assert ap == hp
    assert ap["layers.block.self_attn.q_proj.kernel"] == [["R"], ["S", 2]]
    assert ap["layers.block.self_attn.o_proj.kernel"] == [["R"], ["S", 1]]


def test_plan_generator_builds_on_meta():
    """A factory is built on ``meta`` (nothing allocated) and gives the
    plan the built module gives."""
    from vescale_tpu_torch.models import GPT, GPTConfig

    mesh = _mesh()
    from_factory = PlanGenerator().generate(GPT, mesh, GPTConfig(**GPT_CFG))
    from_module = PlanGenerator("megatron").generate(GPT(GPTConfig(**GPT_CFG), device="meta"),
                                                     mesh)
    assert _enc_plan(from_factory, {}) == _enc_plan(from_module, {})


def test_policy_registry():
    @register_policy("replicate_all")
    def rep(params, mesh):
        return {"parameter": {".*": [["R"]] * 0}, "forward": {}}

    assert get_policy("REPLICATE_ALL") is rep
    with pytest.raises(KeyError, match="unknown auto-plan policy"):
        get_policy("nope")


@pytest.mark.parametrize("kind,tp,names", [("gpt", 2, ("tp",)), ("llama", 2, ("tp",)),
                                           ("llama", 4, ("dp", "tp"))])
def test_auto_parallelize_module(worlds, kind, tp, names):
    """``auto_parallelize_module`` on live meshes: every parameter gets its
    hand plan's placements, the logits and two train steps' losses are
    bitwise the hand plan's (fp32), and a ``CommDebugMode`` around the
    steps counts the ``collectives.CALLS`` / ``BYTES`` deltas exactly."""
    res = worlds(tp).run("dmp_auto", kind=kind, tp=tp, seed=3, names=list(names))
    for got in res:
        assert got["auto_placements"] == got["hand_placements"]
        assert any(p[-1] == ["S", 1] for p in got["auto_placements"].values())  # column
        assert any(p[-1] == ["S", 0] for p in got["auto_placements"].values())  # row
        np.testing.assert_array_equal(got["auto_logits"], got["hand_logits"])
        assert got["auto_losses"] == got["hand_losses"]
        assert got["comm_calls"] == got["calls_delta"] and got["comm_bytes"] == got["bytes_delta"]
        assert got["comm_total"] > 0
