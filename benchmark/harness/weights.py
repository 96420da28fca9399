"""Random weights from a run's seed, made on the device.

The trees are in the flax layout that ``Mixtral(config, params)`` and
``ServeEngine(config, params, cache)`` take (kernels (in, out), experts
stacked on a leading dim).  Each leaf is one ``torch.randn`` call on the
device, from its own ``torch.Generator`` seeded by (run seed, leaf
index), in the dtype it is served or trained in, so any one leaf can be
made again later without the others: the reference takes its weights so,
never from the program.  Kernels are normal with std 1 / sqrt(fan-in),
an expert's fan-in being its own input width; the embedding normal with
std 1 / sqrt(width); norm weights ones and biases zeros.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

Spec = Tuple[str, Tuple[int, ...], torch.dtype, str, float]  # path, shape, dtype, kind, std


def mixtral_specs(c: Dict, expert_dtype=torch.bfloat16) -> List[Spec]:
    """The Mixtral tree's leaves: the expert leaves in ``expert_dtype``,
    every other leaf fp32 (the port's leaf dtypes)."""
    d, f, V, L = c["hidden_size"], c["intermediate_size"], c["vocab_size"], c["num_hidden_layers"]
    H, KV, E = c["num_attention_heads"], c["num_key_value_heads"], c["num_local_experts"]
    hd = d // H
    f32, ex = torch.float32, expert_dtype
    out: List[Spec] = [("embed_tokens.embedding", (V, d), f32, "normal", 1 / math.sqrt(d))]
    for i in range(L):
        p = f"layers_{i}."
        out += [
            (p + "input_layernorm.weight", (d,), f32, "ones", 0.0),
            (p + "self_attn.q_proj.kernel", (d, H * hd), f32, "normal", 1 / math.sqrt(d)),
            (p + "self_attn.k_proj.kernel", (d, KV * hd), f32, "normal", 1 / math.sqrt(d)),
            (p + "self_attn.v_proj.kernel", (d, KV * hd), f32, "normal", 1 / math.sqrt(d)),
            (p + "self_attn.o_proj.kernel", (H * hd, d), f32, "normal", 1 / math.sqrt(H * hd)),
            (p + "post_attention_layernorm.weight", (d,), f32, "ones", 0.0),
            (p + "block_sparse_moe.router", (d, E), f32, "normal", 1 / math.sqrt(d)),
            (p + "block_sparse_moe.w_in", (E, d, f), ex, "normal", 1 / math.sqrt(d)),
            (p + "block_sparse_moe.b_in", (E, f), ex, "zeros", 0.0),
            (p + "block_sparse_moe.w_out", (E, f, d), ex, "normal", 1 / math.sqrt(f)),
            (p + "block_sparse_moe.b_out", (E, d), ex, "zeros", 0.0),
            (p + "block_sparse_moe.w_gate", (E, d, f), ex, "normal", 1 / math.sqrt(d)),
        ]
    out += [("norm.weight", (d,), f32, "ones", 0.0),
            ("lm_head.kernel", (d, V), f32, "normal", 1 / math.sqrt(d))]
    return out


def llama_specs(c: Dict, dtype=torch.bfloat16) -> List[Spec]:
    """A Llama-family tree (Mistral's layers) with every leaf in ``dtype``."""
    d, f, V, L = c["hidden_size"], c["intermediate_size"], c["vocab_size"], c["num_hidden_layers"]
    H, KV = c["num_attention_heads"], c["num_key_value_heads"]
    hd = d // H
    out: List[Spec] = [("embed_tokens.embedding", (V, d), dtype, "normal", 1 / math.sqrt(d))]
    for i in range(L):
        p = f"layers_{i}."
        out += [
            (p + "input_layernorm.weight", (d,), dtype, "ones", 0.0),
            (p + "self_attn.q_proj.kernel", (d, H * hd), dtype, "normal", 1 / math.sqrt(d)),
            (p + "self_attn.k_proj.kernel", (d, KV * hd), dtype, "normal", 1 / math.sqrt(d)),
            (p + "self_attn.v_proj.kernel", (d, KV * hd), dtype, "normal", 1 / math.sqrt(d)),
            (p + "self_attn.o_proj.kernel", (H * hd, d), dtype, "normal", 1 / math.sqrt(H * hd)),
            (p + "post_attention_layernorm.weight", (d,), dtype, "ones", 0.0),
            (p + "mlp.gate_proj.kernel", (d, f), dtype, "normal", 1 / math.sqrt(d)),
            (p + "mlp.up_proj.kernel", (d, f), dtype, "normal", 1 / math.sqrt(d)),
            (p + "mlp.down_proj.kernel", (f, d), dtype, "normal", 1 / math.sqrt(f)),
        ]
    out += [("norm.weight", (d,), dtype, "ones", 0.0),
            ("lm_head.kernel", (d, V), dtype, "normal", 1 / math.sqrt(d))]
    return out


def _leaf_seed(seed: int, index: int) -> int:
    ss = np.random.SeedSequence([int(seed) % (1 << 64), 7, index])
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


def make_leaf(spec: Spec, seed: int, index: int, device) -> torch.Tensor:
    """Leaf ``index`` of a tree for ``seed``, made on ``device``."""
    _, shape, dtype, kind, std = spec
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(_leaf_seed(seed, index))
    return torch.randn(shape, generator=g, dtype=dtype, device=device).mul_(std)


def iter_leaves(specs: List[Spec], seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    for i, spec in enumerate(specs):
        yield spec[0], make_leaf(spec, seed, i, device)


def make_tree(specs: List[Spec], seed: int, device) -> Dict:
    """The nested dict of every leaf."""
    tree: Dict = {}
    for path, leaf in iter_leaves(specs, seed, device):
        node = tree
        *parents, name = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = leaf
    return tree


def flat(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, path))
        else:
            out[path] = v
    return out
