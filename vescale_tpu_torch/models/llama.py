"""LLaMA family — configuration, the per-token math, and the training model.

The port of ``vescale_tpu/models/llama.py``: the same ``LlamaConfig``
fields and presets, RMSNorm with fp32 math, split-half rotary embeddings
with fp32 phases, and the model as ``nn.Module``s (``RMSNorm``, ``Dense``,
``Embed``, ``LlamaAttention``, ``LlamaMLP``, ``LlamaBlock``, ``Llama``)
whose parameters carry the flax paths: ``dict(model.named_parameters())``
has exactly the keys of the flattened flax ``params`` tree, with kernels in
flax's (in, out) layout.  As in flax, parameters are fp32 master weights
and every layer computes in ``config.dtype`` (``Dense``: both operands cast,
then the product; ``Embed``: the table cast, then gathered; ``RMSNorm``:
fp32 math, then the result cast).  Attention runs
``ops.flash_attention`` (the CUDA kernels on the card), GQA without
repeating K/V.  The serve engine keeps its own functional forward over the
same parameter tree.

``remat`` with ``remat_scope`` "block" or "mlp" checkpoints through
``torch.utils.checkpoint``.  ``scan_layers``, ``remat_policy`` and
``use_fp8`` are accepted by the config, so that a config moves between the
packages unchanged, but ``Llama`` raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device

__all__ = [
    "LlamaConfig",
    "rmsnorm",
    "rotary",
    "RMSNorm",
    "Dense",
    "Embed",
    "LlamaAttention",
    "LlamaMLP",
    "LlamaBlock",
    "Llama",
    "LLAMA2_7B",
    "LLAMA3_8B",
    "LLAMA3_70B",
    "LLAMA3_405B",
    "OPEN_LLAMA_3B",
]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32  # < heads -> GQA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    use_flash_attention: bool = True
    remat: bool = False
    remat_policy: Optional[str] = None  # Llama raises: not ported yet
    remat_scope: str = "block"
    scan_layers: bool = False  # Llama raises: not ported yet
    use_fp8: bool = False  # Llama raises: not ported yet
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if self.remat_policy and not self.remat:
            raise ValueError(
                "remat_policy is set but remat=False — the policy would be "
                "silently ignored; set remat=True (or drop the policy)"
            )
        if self.remat_scope not in ("block", "mlp"):
            raise ValueError(f"remat_scope must be 'block' or 'mlp', got {self.remat_scope!r}")
        if self.remat_scope != "block" and not self.remat:
            raise ValueError(
                "remat_scope is set but remat=False — the scope would be "
                "silently ignored; set remat=True (or drop the scope)"
            )
        if self.remat_policy and self.remat_scope != "block":
            raise ValueError("remat_policy applies to remat_scope='block' only")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


LLAMA2_7B = LlamaConfig()
OPEN_LLAMA_3B = LlamaConfig(hidden_size=3200, intermediate_size=8640, num_hidden_layers=26, num_attention_heads=32)
LLAMA3_8B = LlamaConfig(
    vocab_size=128256,
    hidden_size=4096,
    intermediate_size=14336,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    max_position_embeddings=8192,
    rope_theta=500000.0,
)
LLAMA3_70B = LlamaConfig(
    vocab_size=128256,
    hidden_size=8192,
    intermediate_size=28672,
    num_hidden_layers=80,
    num_attention_heads=64,
    num_key_value_heads=8,
    rope_theta=500000.0,
)
LLAMA3_405B = LlamaConfig(
    vocab_size=128256,
    hidden_size=16384,
    intermediate_size=53248,
    num_hidden_layers=126,
    num_attention_heads=128,
    num_key_value_heads=8,
    rope_theta=500000.0,
)


def rmsnorm(x, weight, eps: float):
    """RMSNorm in fp32; the caller casts (the serve engine's ``_rmsnorm``)."""
    x32 = x.float()
    x32 = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return x32 * weight


def rotary(q, k, positions, theta: float):
    """Split-half rotary position embeddings with fp32 phases.  ``q``/``k``:
    (B, T, heads, hd); ``positions``: (B, T) integer positions."""
    hd = q.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=q.device) / hd))
    angles = positions[..., None].float() * freqs  # (B, T, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)

    def rot(x):
        x1, x2 = x.float().chunk(2, dim=-1)
        c = cos[:, :, None, :]
        s = sin[:, :, None, :]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)

    return rot(q), rot(k)


# ------------------------------------------------------------ the modules
def _param(shape, device) -> nn.Parameter:
    """An fp32 master parameter, filled by ``Llama`` from ``init_params``
    or by ``convert.load_params``."""
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))


class RMSNorm(nn.Module):
    """flax ``RMSNorm``: fp32 math with the fp32 ``weight``, result in
    ``dtype``."""

    def __init__(self, features: int, eps: float, dtype, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = _param((features,), device)

    def forward(self, x):
        return rmsnorm(x, self.weight, self.eps).to(self.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` (in, out) and, with ``use_bias``,
    ``bias`` (out,); input, kernel and bias cast to ``dtype``, then the
    product, then the bias added (two roundings, as in flax)."""

    def __init__(self, features_in: int, features_out: int, dtype, device=None,
                 use_bias: bool = False):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param((features_in, features_out), device)
        self.bias = _param((features_out,), device) if use_bias else None

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``: the table cast to ``dtype``, then gathered;
    ``attend`` is the tied head."""

    def __init__(self, num: int, features: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = _param((num, features), device)

    def forward(self, idx):
        return F.embedding(idx, self.embedding.to(self.dtype))

    def attend(self, x):
        return x.to(self.dtype) @ self.embedding.to(self.dtype).T


class LlamaAttention(nn.Module):
    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        self.config = c
        E, H, KV, hd = c.hidden_size, c.num_attention_heads, c.num_key_value_heads, c.head_dim
        self.q_proj = Dense(E, H * hd, c.dtype, device)
        self.k_proj = Dense(E, KV * hd, c.dtype, device)
        self.v_proj = Dense(E, KV * hd, c.dtype, device)
        self.o_proj = Dense(H * hd, E, c.dtype, device)

    def forward(self, x, positions):
        c = self.config
        B, T, _ = x.shape
        H, KV, hd = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        q = self.q_proj(x).reshape(B, T, H, hd)
        k = self.k_proj(x).reshape(B, T, KV, hd)
        v = self.v_proj(x).reshape(B, T, KV, hd)
        q, k = rotary(q, k, positions, c.rope_theta)
        if c.use_flash_attention:
            from ..ops.flash_attention import flash_attention

            # GQA runs natively in the kernels: no repeated K/V
            y = flash_attention(q, k, v, causal=True).reshape(B, T, H * hd)
        else:
            if KV != H:  # GQA: repeat kv heads for the dense einsum
                k = torch.repeat_interleave(k, H // KV, dim=2)
                v = torch.repeat_interleave(v, H // KV, dim=2)
            att = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
            mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
            att = torch.where(mask, att, torch.full_like(att, torch.finfo(torch.float32).min))
            att = torch.softmax(att, dim=-1).to(c.dtype)
            y = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, T, H * hd)
        return self.o_proj(y)


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))`` in the compute dtype."""

    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        E, Fi = c.hidden_size, c.intermediate_size
        self.gate_proj = Dense(E, Fi, c.dtype, device)
        self.up_proj = Dense(E, Fi, c.dtype, device)
        self.down_proj = Dense(Fi, E, c.dtype, device)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        self.config = c
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, c.dtype, device)
        self.self_attn = LlamaAttention(c, device)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, c.dtype, device)
        self.mlp = LlamaMLP(c, device)

    def forward(self, x, positions):
        c = self.config
        x = x + self.self_attn(self.input_layernorm(x), positions)
        h = self.post_attention_layernorm(x)
        if c.remat and c.remat_scope == "mlp" and torch.is_grad_enabled():
            return x + checkpoint(self.mlp, h, use_reentrant=False)
        return x + self.mlp(h)


class Llama(nn.Module):
    """The flax ``Llama``: token ids (B, T) to logits (B, T, vocab) in
    ``config.dtype``.  Parameters are fp32, on ``device`` (default: the
    card), from ``params`` (a flax-layout tree, e.g. ``init_params`` or
    ``params_from_jax``, copied in) or else ``init_params(config, seed)``."""

    def __init__(self, config: LlamaConfig, params=None, *, device=None, seed: int = 0):
        super().__init__()
        c = config
        for name, item in (("scan_layers", "A2"), ("remat_policy", "A2"), ("use_fp8", "A17")):
            if getattr(c, name):
                raise NotImplementedError(
                    f"LlamaConfig.{name} is not ported yet (ROADMAP.md queue A, item {item})")
        self.config = c
        dev = resolve_device(device)
        self.embed_tokens = Embed(c.vocab_size, c.hidden_size, c.dtype, dev)
        for i in range(c.num_hidden_layers):
            self.add_module(f"layers_{i}", LlamaBlock(c, dev))
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps, c.dtype, dev)
        if not c.tie_word_embeddings:
            self.lm_head = Dense(c.hidden_size, c.vocab_size, c.dtype, dev)
        from .convert import init_params, load_params

        if params is None:
            params = init_params(c, seed, device=dev, dtype=torch.float32)
        load_params(self, params)

    def forward(self, idx):
        c = self.config
        B, T = idx.shape
        x = self.embed_tokens(idx)
        positions = torch.arange(T, device=idx.device)[None, :].expand(B, T)
        remat_blocks = c.remat and c.remat_scope == "block" and torch.is_grad_enabled()
        for i in range(c.num_hidden_layers):
            block = getattr(self, f"layers_{i}")
            if remat_blocks:
                x = checkpoint(block, x, positions, use_reentrant=False)
            else:
                x = block(x, positions)
        x = self.norm(x)
        if c.tie_word_embeddings:
            return self.embed_tokens.attend(x)
        return self.lm_head(x)
