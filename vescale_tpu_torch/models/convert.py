"""Llama and GPT parameter trees for the port: from the JAX package, or
random.

The serve engine consumes the JAX package's flax ``params`` layout as a
nested dict of torch tensors::

    embed_tokens.embedding              (vocab, hidden)
    layers_<i>.input_layernorm.weight   (hidden,)
    layers_<i>.self_attn.{q,k,v,o}_proj.kernel   (in, out)
    layers_<i>.post_attention_layernorm.weight
    layers_<i>.mlp.{gate,up,down}_proj.kernel    (in, out)
    norm.weight                         (hidden,)
    lm_head.kernel                      (hidden, vocab), absent when tied

Kernels keep flax's (in, out) layout, so ``x @ kernel`` is the same product
as the JAX engine's ``dense``.  A ``GPTConfig`` tree (``models/nanogpt.py``)
is flax's nanoGPT tree::

    wte.embedding, wpe.embedding        (vocab, n_embd), (block, n_embd)
    h_<i>.ln_{1,2}.{scale,bias}         (n_embd,)
    h_<i>.attn.c_attn.{kernel,bias}     (n_embd, 3 n_embd), (3 n_embd,)
    h_<i>.attn.c_proj.{kernel,bias}     (n_embd, n_embd), (n_embd,)
    h_<i>.mlp.c_fc.{kernel,bias}        (n_embd, 4 n_embd), (4 n_embd,)
    h_<i>.mlp.c_proj.{kernel,bias}      (4 n_embd, n_embd), (n_embd,)
    ln_f.{scale,bias}                   (n_embd,)

with no ``bias`` leaves when ``config.bias`` is False.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from .llama import LlamaConfig
from .nanogpt import GPTConfig

__all__ = ["params_from_jax", "init_params", "param_shapes", "tree_to", "module_tree",
           "load_params"]


def params_from_jax(tree: Mapping[str, Any], device=None,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The JAX package's flax ``params`` tree (numpy or JAX array leaves,
    read through ``np.asarray``) as the same nested dict of torch tensors
    on ``device`` (default: the card), in ``dtype`` (default: each leaf's
    own).  Values are copied exactly."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, Mapping):
            return {str(k): conv(v) for k, v in node.items()}
        t = torch.from_numpy(np.array(node, copy=True))
        return t.to(device=dev, dtype=dtype if dtype is not None else t.dtype)

    return conv(tree)


def _gpt_param_shapes(c: GPTConfig) -> Dict[str, Any]:
    E = c.n_embd

    def dense(n_in, n_out):
        return {"kernel": (n_in, n_out), **({"bias": (n_out,)} if c.bias else {})}

    norm = {"scale": (E,), **({"bias": (E,)} if c.bias else {})}
    layer = {
        "ln_1": norm,
        "attn": {"c_attn": dense(E, 3 * E), "c_proj": dense(E, E)},
        "ln_2": norm,
        "mlp": {"c_fc": dense(E, 4 * E), "c_proj": dense(4 * E, E)},
    }
    tree: Dict[str, Any] = {"wte": {"embedding": (c.vocab_size, E)},
                            "wpe": {"embedding": (c.block_size, E)}}
    for i in range(c.n_layer):
        tree[f"h_{i}"] = layer
    tree["ln_f"] = norm
    return tree


def param_shapes(config: Union[LlamaConfig, GPTConfig]) -> Dict[str, Any]:
    """The nested dict of leaf shapes of a Llama or GPT parameter tree."""
    if isinstance(config, GPTConfig):
        return _gpt_param_shapes(config)
    c = config
    E, F = c.hidden_size, c.intermediate_size
    H, KV, hd = c.num_attention_heads, c.num_key_value_heads, c.head_dim
    layer = {
        "input_layernorm": {"weight": (E,)},
        "self_attn": {
            "q_proj": {"kernel": (E, H * hd)},
            "k_proj": {"kernel": (E, KV * hd)},
            "v_proj": {"kernel": (E, KV * hd)},
            "o_proj": {"kernel": (H * hd, E)},
        },
        "post_attention_layernorm": {"weight": (E,)},
        "mlp": {
            "gate_proj": {"kernel": (E, F)},
            "up_proj": {"kernel": (E, F)},
            "down_proj": {"kernel": (F, E)},
        },
    }
    tree: Dict[str, Any] = {"embed_tokens": {"embedding": (c.vocab_size, E)}}
    for i in range(c.num_hidden_layers):
        tree[f"layers_{i}"] = layer
    tree["norm"] = {"weight": (E,)}
    if not c.tie_word_embeddings:
        tree["lm_head"] = {"kernel": (E, c.vocab_size)}
    return tree


def init_params(config: Union[LlamaConfig, GPTConfig], seed: int = 0, device=None,
                dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Random weights drawn on ``device`` (default: the card) from a
    ``torch.Generator`` seeded with ``seed``, in ``dtype`` (default
    ``config.dtype``).  Norm weights and scales are ones and biases zeros
    (flax's defaults); every kernel is normal with std 1/sqrt(fan_in)
    (flax's lecun-normal scale, untruncated); an embedding is normal with
    std 1/sqrt(width).  The same seed on the same device type gives the
    same tree; CPU and CUDA generators differ, so make the tree on one
    device and copy it to compare two."""
    dev = resolve_device(device)
    dt = dtype if dtype is not None else config.dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(path: str, shape):
        if path.endswith(("weight", "scale")):
            return torch.ones(shape, dtype=dt, device=dev)
        if path.endswith("bias"):
            return torch.zeros(shape, dtype=dt, device=dev)
        std = 1.0 / math.sqrt(shape[1] if path.endswith("embedding") else shape[0])
        return torch.empty(shape, dtype=dt, device=dev).normal_(0.0, std, generator=gen)

    def build(node, path: str):
        if isinstance(node, dict):
            return {k: build(v, f"{path}.{k}" if path else k) for k, v in node.items()}
        return draw(path, node)

    return build(param_shapes(config), "")


def tree_to(tree: Union[Mapping[str, Any], torch.Tensor], device=None,
            dtype: Optional[torch.dtype] = None):
    """A copy of a parameter tree on another device and/or dtype."""
    if isinstance(tree, Mapping):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype if dtype is not None else tree.dtype)


def module_tree(module: torch.nn.Module) -> Dict[str, Any]:
    """The nested dict of ``module``'s parameters by their dotted names
    (``models.llama.Llama`` names them as the flax tree): the leaves are
    the parameters themselves, detached, not copies."""
    tree: Dict[str, Any] = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.detach()
    return tree


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


@torch.no_grad()
def load_params(module: torch.nn.Module, tree: Mapping[str, Any]) -> None:
    """Copy a flax-layout tree (torch tensors, or arrays read through
    ``np.asarray``) into ``module``'s parameters, each into its own dtype
    and device.  The tree must hold exactly the module's parameters, with
    the same shapes."""
    flat = _flatten(tree)
    params = dict(module.named_parameters())
    missing, extra = sorted(set(params) - set(flat)), sorted(set(flat) - set(params))
    if missing or extra:
        raise ValueError(f"load_params: missing {missing[:5]}, unexpected {extra[:5]}")
    for name, p in params.items():
        src = flat[name]
        if not isinstance(src, torch.Tensor):
            src = torch.from_numpy(np.array(src, copy=True))
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"load_params: {name} has shape {tuple(src.shape)}, "
                             f"the module {tuple(p.shape)}")
        p.copy_(src)
