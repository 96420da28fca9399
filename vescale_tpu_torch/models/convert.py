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

with no ``bias`` leaves when ``config.bias`` is False.  A Llama config with
``scan_layers`` keeps the block leaves stacked, flax ``nn.scan``'s layout::

    layers.block.<path>                 (num_hidden_layers, *shape)

``scan_tree`` and ``unscan_tree`` move a tree between the two layouts.
A Llama config with ``use_fp8`` has the two-collection bundle of flax's
fp8 model, ``{"params": <the tree above>, "_overwrite_with_gradient":
<the fp8 state>}``, the state six leaves under each block projection::

    layers_<i>.<self_attn|mlp>.<proj>.Fp8DirectDotGeneralOp_0.<leaf>
        {input,kernel,output_grad}_amax_history (1024,) fp32, zeros
        {input,kernel,output_grad}_scale        (1,)    fp32, ones

(stacked under ``layers.block`` with ``scan_layers``); ``param_shapes``,
``init_params``, ``load_params`` and ``module_tree`` carry it, and
``params_from_jax`` reads flax's variables as they are.
A ``MixtralConfig`` tree is the Llama tree with each layer's ``mlp``
replaced by the stacked experts::

    layers_<i>.block_sparse_moe.router          (hidden, experts)        fp32
    layers_<i>.block_sparse_moe.{w_in,w_gate}   (experts, hidden, ffn)   config.dtype
    layers_<i>.block_sparse_moe.w_out           (experts, ffn, hidden)   config.dtype
    layers_<i>.block_sparse_moe.{b_in,b_out}    (experts, ffn / hidden)  config.dtype

and a ``MoEConfig`` tree is one such ``block_sparse_moe`` subtree (with
``w_gate`` only when ``swiglu``).  ``hf_llama_to_params`` and
``hf_mixtral_to_params`` map a HuggingFace state dict onto these trees;
``load_hf_llama`` reads one from a checkpoint directory's shard files
(``read_safetensors`` parses the safetensors format itself: the port needs
no ``safetensors`` package).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..moe.layer import MoEConfig
from .llama import LlamaConfig
from .mixtral import MixtralConfig
from .nanogpt import GPTConfig

__all__ = ["params_from_jax", "init_params", "param_shapes", "tree_to", "module_tree",
           "load_params", "zero_state_from_jax", "fsdp_buffer_from_jax", "scan_tree",
           "unscan_tree", "leaf_dtype", "hf_llama_to_params", "hf_mixtral_to_params",
           "load_hf_llama", "read_safetensors"]

Config = Union[LlamaConfig, GPTConfig, MixtralConfig, MoEConfig]


def _torch_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A numpy array as a torch tensor; an ``ml_dtypes`` bfloat16 array (a
    bf16 JAX leaf read through ``np.asarray``) by its bits."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


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
        t = _torch_from_numpy(np.array(node, copy=True))
        return t.to(device=dev, dtype=dtype if dtype is not None else t.dtype)

    return conv(tree)


def _piece(value, template, device=None) -> Any:
    """A full reference array (read through ``np.asarray``) cut as the
    template leaf is: a ``DArray`` template gives its rank's piece, a
    tensor template the whole value in its dtype."""
    from ..darray import DArray

    full = _torch_from_numpy(np.array(np.asarray(value), copy=True))
    if isinstance(template, DArray):
        spec = template.spec
        local = spec.local_from_full(full, spec.mesh.coordinate_of_rank(template.rank))
        dev = spec.mesh.device if device is None else resolve_device(device)
        return DArray(local.to(device=dev, dtype=spec.dtype).contiguous(), spec, template.rank)
    dev = template.device if device is None else resolve_device(device)
    return full.to(device=dev, dtype=template.dtype).reshape(template.shape)


def zero_state_from_jax(state: Mapping[str, Any], template, device=None):
    """A reference ``DistributedOptimizer`` state over ``adamw_lowmem``
    (``{"inner": (ScaleByAdamLowmemState(count, mu, nu), ...),
    "main_params": ..., "loss_scale": ...}``, leaves read through
    ``np.asarray``) as the port's ``DistributedOptimizer.state_tree``: each
    leaf cut as ``template`` (``state_template()``) lays it out, so the
    result is this rank's pieces, ready for ``load_state_tree``."""
    from ..parallel.optimizer import ScaleByAdamLowmemState

    def cut(values, tmpl):
        if isinstance(tmpl, Mapping):
            return {k: cut(values[k], v) for k, v in tmpl.items()}
        return _piece(values, tmpl, device)

    inner, t_inner = state["inner"][0], template["inner"][0]
    out = {"inner": [ScaleByAdamLowmemState(cut(inner.count, t_inner.count),
                                            cut(inner.mu, t_inner.mu),
                                            cut(inner.nu, t_inner.nu))],
           "main_params": cut(state["main_params"], template["main_params"])}
    if "loss_scale" in template:
        out["loss_scale"] = cut(state["loss_scale"], template["loss_scale"])
    return out


def fsdp_buffer_from_jax(physicals: Mapping[str, Any], buffer, rank: Optional[int] = None,
                         device=None) -> Dict[str, torch.Tensor]:
    """A reference ``FSDPParamBuffer.pack`` output (``{dtype name: padded
    rank-major physical buffer}``: rank ``r``'s chunk at ``r * pad``, pad
    the largest chunk) as ``rank``'s pieces of the port's ``buffer``
    (default: this process's rank), the port's ``pack`` layout."""
    coord = buffer._coord(rank)
    dev = buffer.mesh.device if device is None else resolve_device(device)
    out = {}
    for name, g in buffer.groups.items():
        phys = torch.from_numpy(np.array(np.asarray(physicals[name]), copy=True))
        c = list(coord)
        sizes = []
        for r in range(buffer.mesh.size(buffer.dim)):
            c[buffer.dim_index] = r
            sizes.append(g.spec.ragged_local_chunk(c)[0])
        me = coord[buffer.dim_index]
        pad = max(sizes)
        out[name] = phys.narrow(0, me * pad, sizes[me]).to(device=dev, dtype=g.dtype).clone()
    return out


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


def _moe_param_shapes(c: MoEConfig) -> Dict[str, Any]:
    E, d, f = c.num_experts, c.d_model, c.d_ff
    tree = {"router": (d, E), "w_in": (E, d, f), "b_in": (E, f), "w_out": (E, f, d),
            "b_out": (E, d)}
    if c.swiglu:
        tree["w_gate"] = (E, d, f)
    return tree


def _fp8_state_shapes(c: LlamaConfig) -> Dict[str, Any]:
    """The ``_overwrite_with_gradient`` collection's shapes of an fp8
    Llama (flax's ``Fp8DirectDotGeneralOp_0`` under each projection)."""
    from ..quant.fp8 import AMAX_HISTORY_LEN, FP8_LEAVES

    op = {"Fp8DirectDotGeneralOp_0": {n: (AMAX_HISTORY_LEN,) if n.endswith("history") else (1,)
                                      for n in FP8_LEAVES}}
    layer = {"self_attn": {p: op for p in ("q_proj", "k_proj", "v_proj", "o_proj")},
             "mlp": {p: op for p in ("gate_proj", "up_proj", "down_proj")}}
    if c.scan_layers:
        L = c.num_hidden_layers
        stack = lambda node: ({k: stack(v) for k, v in node.items()} if isinstance(node, dict)
                              else (L, *node))
        return {"layers": {"block": stack(layer)}}
    return {f"layers_{i}": layer for i in range(c.num_hidden_layers)}


def param_shapes(config: Config) -> Dict[str, Any]:
    """The nested dict of leaf shapes of a Llama, Mixtral, GPT or MoE
    layer parameter tree; of an fp8 Llama, the two-collection bundle."""
    if isinstance(config, LlamaConfig) and config.use_fp8:
        from ..quant.fp8 import OWG

        return {"params": param_shapes(dataclasses.replace(config, use_fp8=False)),
                OWG: _fp8_state_shapes(config)}
    if isinstance(config, GPTConfig):
        return _gpt_param_shapes(config)
    if isinstance(config, MoEConfig):
        return _moe_param_shapes(config)
    mixtral = isinstance(config, MixtralConfig)
    c = config.as_llama() if mixtral else config
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
    }
    if mixtral:
        layer["block_sparse_moe"] = _moe_param_shapes(config.moe())
    else:
        layer["mlp"] = {
            "gate_proj": {"kernel": (E, F)},
            "up_proj": {"kernel": (E, F)},
            "down_proj": {"kernel": (F, E)},
        }
    tree: Dict[str, Any] = {"embed_tokens": {"embedding": (c.vocab_size, E)}}
    if c.scan_layers:
        L = c.num_hidden_layers
        stack = lambda node: ({k: stack(v) for k, v in node.items()} if isinstance(node, dict)
                              else (L, *node))
        tree["layers"] = {"block": stack(layer)}
    else:
        for i in range(c.num_hidden_layers):
            tree[f"layers_{i}"] = layer
    tree["norm"] = {"weight": (E,)}
    if not c.tie_word_embeddings:
        tree["lm_head"] = {"kernel": (E, c.vocab_size)}
    return tree


def leaf_dtype(config: Config, path: str) -> torch.dtype:
    """The dtype the reference gives leaf ``path`` of ``config``'s tree:
    a Mixtral's or an MoE layer's expert leaves ``config.dtype`` and every
    other leaf fp32 (flax parameters); a Llama's or a GPT's
    ``config.dtype`` (what ``init_params`` has always drawn; the modules
    hold fp32 masters)."""
    if isinstance(config, (MixtralConfig, MoEConfig)):
        from ..moe.layer import EXPERT_LEAVES

        return config.dtype if path.rsplit(".", 1)[-1] in EXPERT_LEAVES else torch.float32
    return config.dtype


def init_params(config: Config, seed: int = 0, device=None,
                dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Random weights drawn on ``device`` (default: the card) from a
    ``torch.Generator`` seeded with ``seed``, in ``dtype`` (default: each
    leaf's :func:`leaf_dtype`); with ``scan_layers``, the same draws stacked.  Norm weights and scales are ones and biases zeros
    (flax's defaults); every kernel is normal with std 1/sqrt(fan_in), the
    fan-in of an (..., in, out) kernel being the product of all but its
    last dim (flax's lecun-normal scale, untruncated); an embedding is
    normal with std 1/sqrt(width).  The same seed on the same device type gives the
    same tree; CPU and CUDA generators differ, so make the tree on one
    device and copy it to compare two.  On ``device="meta"`` it allocates
    nothing (shapes and dtypes only: ``initialize.deferred_init``).  An
    fp8 Llama gets the bundle: the parameters the same config without fp8
    draws, and flax's initial fp8 state (zero histories, unit scales) in
    fp32."""
    if isinstance(config, LlamaConfig) and config.use_fp8:
        from ..quant.fp8 import OWG

        dev = resolve_device(device)
        state = _fp8_state_shapes(config)

        def build_state(node, leaf=""):
            if isinstance(node, dict):
                return {k: build_state(v, k) for k, v in node.items()}
            fill = torch.zeros if leaf.endswith("history") else torch.ones
            return fill(node, dtype=torch.float32, device=dev)

        return {"params": init_params(dataclasses.replace(config, use_fp8=False), seed, dev,
                                      dtype),
                OWG: build_state(state)}
    if isinstance(config, LlamaConfig) and config.scan_layers:
        # the unscanned draws, stacked: one seed gives the same weights in
        # both layouts
        flat = init_params(dataclasses.replace(config, scan_layers=False), seed, device, dtype)
        return scan_tree(flat, config.num_hidden_layers)
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

    def build(node, path: str):
        if isinstance(node, dict):
            return {k: build(v, f"{path}.{k}" if path else k) for k, v in node.items()}
        dt = dtype if dtype is not None else leaf_dtype(config, path)
        return draw_leaf(path, node, dt, dev, gen)

    return build(param_shapes(config), "")


def scan_tree(tree: Mapping[str, Any], num_layers: int) -> Dict[str, Any]:
    """A Llama tree's ``layers_<i>`` subtrees stacked into
    ``layers.block`` (leading (L,) axis); the other leaves as they are."""
    out = {k: v for k, v in tree.items() if not k.startswith("layers_")}
    layers = [tree[f"layers_{i}"] for i in range(num_layers)]

    def stack(*nodes):
        if isinstance(nodes[0], Mapping):
            return {k: stack(*(n[k] for n in nodes)) for k in nodes[0]}
        return torch.stack(nodes, dim=0)

    out["layers"] = {"block": stack(*layers)}
    return out


def unscan_tree(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`scan_tree`: ``layers.block`` unstacked into
    ``layers_<i>`` subtrees (views of the stacked leaves)."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    block = tree["layers"]["block"]

    def n_layers(node):
        return n_layers(next(iter(node.values()))) if isinstance(node, Mapping) else node.shape[0]

    def take(node, i):
        if isinstance(node, Mapping):
            return {k: take(v, i) for k, v in node.items()}
        return node[i]

    for i in range(n_layers(block)):
        out[f"layers_{i}"] = take(block, i)
    return out


def draw_leaf(path: str, shape, dtype, device, gen):
    """One leaf of :func:`init_params` by its path: ones for norm weights
    and scales, zeros for biases (``b_in``/``b_out`` of the experts too),
    normal with std 1/sqrt(fan_in) for a kernel (..., in, out), fan_in
    the product of all but the last dim, and 1/sqrt(width) for an
    embedding (num, width)."""
    if path.endswith(("weight", "scale")):
        return torch.ones(shape, dtype=dtype, device=device)
    if path.endswith(("bias", "b_in", "b_out")):
        return torch.zeros(shape, dtype=dtype, device=device)
    std = 1.0 / math.sqrt(shape[1] if path.endswith("embedding") else math.prod(shape[:-1]))
    return torch.empty(shape, dtype=dtype, device=device).normal_(0.0, std, generator=gen)


def tree_to(tree: Union[Mapping[str, Any], torch.Tensor], device=None,
            dtype: Optional[torch.dtype] = None):
    """A copy of a parameter tree on another device and/or dtype."""
    if isinstance(tree, Mapping):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype if dtype is not None else tree.dtype)


def _nest(named) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, p in named:
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.detach()
    return tree


def module_tree(module: torch.nn.Module) -> Dict[str, Any]:
    """The nested dict of ``module``'s parameters by their dotted names
    (``models.llama.Llama`` names them as the flax tree): the leaves are
    the parameters themselves, detached, not copies.  A module with fp8
    state gives the bundle, its state buffers under
    ``_overwrite_with_gradient``."""
    from ..quant.fp8 import OWG, owg_buffers

    tree = _nest(module.named_parameters())
    state = owg_buffers(module)
    return {"params": tree, OWG: _nest(state.items())} if state else tree


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
    the same shapes; a module with fp8 state takes the bundle, whose
    ``_overwrite_with_gradient`` collection must hold exactly its state
    buffers."""
    from ..quant.fp8 import OWG, owg_buffers

    state = owg_buffers(module)
    if state or OWG in tree:
        if not state or set(tree) != {"params", OWG}:
            raise ValueError(f"load_params: an fp8 model takes the bundle of 'params' and "
                             f"'{OWG}' and only it (tree keys {sorted(tree)[:4]}, "
                             f"{len(state)} fp8 state buffers)")
        _copy_leaves(_flatten(tree[OWG]), state)
        tree = tree["params"]
    _copy_leaves(_flatten(tree), dict(module.named_parameters()))


def _copy_leaves(flat: Dict[str, Any], params: Dict[str, torch.Tensor]) -> None:
    missing, extra = sorted(set(params) - set(flat)), sorted(set(flat) - set(params))
    if missing or extra:
        raise ValueError(f"load_params: missing {missing[:5]}, unexpected {extra[:5]}")
    for name, p in params.items():
        src = flat[name]
        if not isinstance(src, torch.Tensor):
            src = _torch_from_numpy(np.array(src, copy=True))
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"load_params: {name} has shape {tuple(src.shape)}, "
                             f"the module {tuple(p.shape)}")
        p.copy_(src)


# ----------------------------------------------------- HuggingFace layouts
def _put(params: Dict[str, Any], path: str, arr, transpose: bool = False, device=None) -> None:
    """Insert into a nested dict at a dotted path, as an fp32 tensor (the
    reference keeps every converted leaf fp32; the model's dtype casts)."""
    t = arr if isinstance(arr, torch.Tensor) else _torch_from_numpy(np.asarray(arr))
    t = t.detach().to(device=device, dtype=torch.float32)
    if transpose:
        t = t.T
    node = params
    parts = path.split(".")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = t.clone(memory_format=torch.contiguous_format)


def _check_layer_bound(name: str, m, num_layers: int) -> None:
    if m and int(m.group(1)) >= num_layers:
        raise ValueError(
            f"{name} exceeds config.num_hidden_layers={num_layers}; "
            "a truncated conversion would silently change the model"
        )


def hf_llama_to_params(state_dict: Mapping[str, Any], config: LlamaConfig,
                       device=None) -> Dict[str, Any]:
    """An HF ``LlamaForCausalLM`` state dict (torch tensors or numpy
    arrays) as the flax-layout tree of ``models.llama.Llama``, fp32 on
    ``device`` (default: the card); the reference's
    ``models/convert.py::hf_llama_to_params``.

    Name map (HF -> ours):
      model.embed_tokens.weight            -> embed_tokens.embedding
      model.layers.N.self_attn.{q,k,v,o}_proj.weight -> layers_N.self_attn.*.kernel (transposed)
      model.layers.N.mlp.{gate,up,down}_proj.weight  -> layers_N.mlp.*.kernel (transposed)
      model.layers.N.input_layernorm.weight          -> layers_N.input_layernorm.weight
      model.layers.N.post_attention_layernorm.weight -> layers_N.post_attention_layernorm.weight
      model.norm.weight                    -> norm.weight
      lm_head.weight                       -> lm_head.kernel (transposed)
    """
    import re

    dev = resolve_device(device)
    params: Dict[str, Any] = {}

    def put(path, arr, transpose=False):
        _put(params, path, arr, transpose, dev)

    consumed = set()
    for name, tensor in state_dict.items():
        m = re.fullmatch(r"model\.layers\.(\d+)\.(.+)", name)
        _check_layer_bound(name, m, config.num_hidden_layers)
        if m:
            i, rest = int(m.group(1)), m.group(2)
            base = f"layers_{i}"
            if rest.endswith("_proj.weight"):
                put(f"{base}.{rest[: -len('.weight')]}.kernel", tensor, transpose=True)
            elif rest in ("input_layernorm.weight", "post_attention_layernorm.weight"):
                put(f"{base}.{rest}", tensor)
            else:
                continue
            consumed.add(name)
        elif name == "model.embed_tokens.weight":
            put("embed_tokens.embedding", tensor)
            consumed.add(name)
        elif name == "model.norm.weight":
            put("norm.weight", tensor)
            consumed.add(name)
        elif name == "lm_head.weight":
            if not config.tie_word_embeddings:
                put("lm_head.kernel", tensor, transpose=True)
            consumed.add(name)

    missing = []
    for i in range(config.num_hidden_layers):
        for sub in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
                    "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj"):
            if f"model.layers.{i}.{sub}.weight" not in consumed:
                missing.append(f"model.layers.{i}.{sub}.weight")
        for ln in ("input_layernorm", "post_attention_layernorm"):
            if f"model.layers.{i}.{ln}.weight" not in consumed:
                missing.append(f"model.layers.{i}.{ln}.weight")
    if "model.embed_tokens.weight" not in consumed:
        missing.append("model.embed_tokens.weight")
    if "model.norm.weight" not in consumed:
        missing.append("model.norm.weight")
    if not config.tie_word_embeddings and "lm_head.weight" not in consumed:
        missing.append("lm_head.weight (or set tie_word_embeddings=True)")
    if missing:
        raise ValueError(f"HF state dict is missing {len(missing)} tensors, e.g. {missing[:4]}")
    return params


# the safetensors format's dtype names
_ST_DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8, "I16": torch.int16,
    "U16": torch.uint16, "I32": torch.int32, "U32": torch.uint32, "I64": torch.int64,
    "U64": torch.uint64, "F16": torch.float16, "BF16": torch.bfloat16, "F32": torch.float32,
    "F64": torch.float64, "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, as CPU tensors in the file's
    dtypes: an 8-byte little-endian header length, the JSON header (each
    tensor's ``dtype``, ``shape`` and ``data_offsets`` into the data that
    follows; ``__metadata__`` skipped), then the raw little-endian bytes.
    The file is read once into one buffer that the tensors view."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        if n <= 0 or 8 + n > size:
            raise ValueError(f"{path}: not a safetensors file (header length {n})")
        header = json.loads(f.read(n))
        buf = bytearray(size - 8 - n)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: truncated")
    data = torch.frombuffer(buf, dtype=torch.uint8) if buf else torch.empty(0, dtype=torch.uint8)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']!r}")
        lo, hi = info["data_offsets"]
        shape = [int(d) for d in info["shape"]]
        itemsize = torch.empty((), dtype=dtype).element_size()
        if hi - lo != math.prod(shape) * itemsize or hi > len(buf):
            raise ValueError(f"{path}: {name}'s offsets {lo, hi} do not hold {shape} {info['dtype']}")
        raw = data[lo:hi]
        if lo % itemsize:  # a view of another dtype must start on its alignment
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(shape)
    return out


def load_hf_llama(path: str, config: LlamaConfig, device=None) -> Dict[str, Any]:
    """``hf_llama_to_params`` of a checkpoint directory: every
    ``*.safetensors`` shard under ``path`` merged in sorted order (read by
    :func:`read_safetensors`), else every ``pytorch_model*.bin`` shard
    (``torch.load(..., weights_only=True)``); ``FileNotFoundError`` when
    there are neither (the reference's ``models/convert.py::
    load_hf_llama``).  The tree is fp32 on ``device`` (default: the
    card)."""
    names = sorted(os.listdir(path))
    st_files = [f for f in names if f.endswith(".safetensors")]
    bin_files = [f for f in names if f.startswith("pytorch_model") and f.endswith(".bin")]
    state: Dict[str, Any] = {}
    if st_files:
        for f in st_files:
            state.update(read_safetensors(os.path.join(path, f)))
    elif bin_files:
        for f in bin_files:
            state.update(torch.load(os.path.join(path, f), map_location="cpu", weights_only=True))
    else:
        raise FileNotFoundError(f"no .safetensors or pytorch_model*.bin under {path}")
    return hf_llama_to_params(state, config, device=device)


def hf_mixtral_to_params(state_dict: Mapping[str, Any], config: MixtralConfig,
                         device=None) -> Dict[str, Any]:
    """An HF ``MixtralForCausalLM`` state dict as the tree of
    ``models.mixtral.Mixtral``, every leaf fp32 on ``device`` (default: the
    card), as the reference's ``hf_mixtral_to_params`` gives it (the
    model's own expert leaves are ``config.dtype``: ``Mixtral(config,
    tree)`` casts them on load).

    Expert map (HF -> ours, per layer; ours stacks experts on a leading dim):
      block_sparse_moe.gate.weight        -> block_sparse_moe.router (transposed)
      block_sparse_moe.experts.K.w1.weight -> block_sparse_moe.w_gate[K] (transposed)
      block_sparse_moe.experts.K.w3.weight -> block_sparse_moe.w_in[K]   (transposed)
      block_sparse_moe.experts.K.w2.weight -> block_sparse_moe.w_out[K]  (transposed)
    ``b_in`` and ``b_out`` are zeros (HF experts have no biases).
    Attention, norm, embedding and head names follow the llama map.
    """
    import re

    dev = resolve_device(device)
    params: Dict[str, Any] = {}

    def put(path, arr, transpose=False):
        _put(params, path, arr, transpose, dev)

    E = config.num_local_experts
    expert_stacks: Dict[str, Dict[str, list]] = {}
    consumed = set()
    for name, tensor in state_dict.items():
        m = re.fullmatch(r"model\.layers\.(\d+)\.(.+)", name)
        _check_layer_bound(name, m, config.num_hidden_layers)
        if m:
            i, rest = int(m.group(1)), m.group(2)
            base = f"layers_{i}"
            em = re.fullmatch(r"block_sparse_moe\.experts\.(\d+)\.(w1|w2|w3)\.weight", rest)
            if em:
                k, w = int(em.group(1)), em.group(2)
                if k >= E:
                    raise ValueError(f"{name} exceeds config.num_local_experts={E}")
                ours = {"w1": "w_gate", "w3": "w_in", "w2": "w_out"}[w]
                t = tensor if isinstance(tensor, torch.Tensor) else _torch_from_numpy(
                    np.asarray(tensor))
                expert_stacks.setdefault(base, {}).setdefault(ours, [None] * E)[k] = \
                    t.detach().float().T
                consumed.add(name)
            elif rest == "block_sparse_moe.gate.weight":
                put(f"{base}.block_sparse_moe.router", tensor, transpose=True)
                consumed.add(name)
            elif rest.endswith("_proj.weight"):
                put(f"{base}.{rest[: -len('.weight')]}.kernel", tensor, transpose=True)
                consumed.add(name)
            elif rest in ("input_layernorm.weight", "post_attention_layernorm.weight"):
                put(f"{base}.{rest}", tensor)
                consumed.add(name)
        elif name == "model.embed_tokens.weight":
            put("embed_tokens.embedding", tensor)
            consumed.add(name)
        elif name == "model.norm.weight":
            put("norm.weight", tensor)
            consumed.add(name)
        elif name == "lm_head.weight":
            put("lm_head.kernel", tensor, transpose=True)
            consumed.add(name)

    # every layer needs attention, norms, router and whole expert stacks
    missing = []
    for i in range(config.num_hidden_layers):
        pre = f"model.layers.{i}."
        for sub in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj"):
            if pre + sub + ".weight" not in consumed:
                missing.append(pre + sub + ".weight")
        for ln in ("input_layernorm", "post_attention_layernorm"):
            if pre + ln + ".weight" not in consumed:
                missing.append(pre + ln + ".weight")
        if pre + "block_sparse_moe.gate.weight" not in consumed:
            missing.append(pre + "block_sparse_moe.gate.weight")
        for k in range(E):
            for w in ("w1", "w2", "w3"):
                if pre + f"block_sparse_moe.experts.{k}.{w}.weight" not in consumed:
                    missing.append(pre + f"block_sparse_moe.experts.{k}.{w}.weight")
    for g in ("model.embed_tokens.weight", "model.norm.weight", "lm_head.weight"):
        if g not in consumed:
            missing.append(g)
    if missing:
        raise ValueError(f"HF state dict is missing {len(missing)} tensors, e.g. {missing[:4]}")

    for base, stacks in expert_stacks.items():
        for ours, slots in stacks.items():
            put(f"{base}.block_sparse_moe.{ours}", torch.stack(slots, dim=0))
        d_ff, d = stacks["w_out"][0].shape
        put(f"{base}.block_sparse_moe.b_in", torch.zeros((E, d_ff)))
        put(f"{base}.block_sparse_moe.b_out", torch.zeros((E, d)))
    return params
