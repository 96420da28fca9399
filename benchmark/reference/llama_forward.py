"""Plain PyTorch reference of a Llama-family decoder (Mistral-7B's
layers): RMSNorm, split-half rotary embeddings, grouped-query causal
attention with a float32 softmax, SwiGLU, an untied head.

Every operation is float32 (``precision.mm`` in ``"fp32"`` mode, TF32 off
by the caller) unless the control's ``"fp8"`` mode rounds the products'
operands.  Weights are a flat ``{path: tensor}`` map in the flax layout,
in any dtype; each layer's leaves are cast to float32 as the layer runs,
so only one layer's float32 copy is alive at a time.  Nothing here comes
from the program under test.
"""

from __future__ import annotations

from typing import Dict

import torch

from .precision import mm, operand


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding of (B, T, heads, hd) ``x`` at
    (T,) ``positions``; the phases in float64, then float32."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd))
    ang = positions.to(torch.float64)[:, None] * inv[None, :]
    cos, sin = ang.cos().float()[None, :, None, :], ang.sin().float()[None, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, mode: str) -> torch.Tensor:
    """Causal GQA over (B, T, H, hd) q and (B, T, KV, hd) k, v; returns
    (B, T, H * hd)."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    qg = operand(q, mode).reshape(B, T, KV, H // KV, hd)
    s = torch.einsum("btkgd,bskd->bkgts", qg, operand(k, mode)) / hd ** 0.5
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", operand(p, mode), operand(v, mode))
    return o.reshape(B, T, H * hd)


def attention_block(P: Dict[str, torch.Tensor], x, c: Dict, mode: str) -> torch.Tensor:
    """``x`` plus self-attention of its normed input; ``P`` the layer's
    leaves without the ``layers_i.`` prefix."""
    B, T, d = x.shape
    H, KV = c["num_attention_heads"], c["num_key_value_heads"]
    hd = d // H
    pos = torch.arange(T, device=x.device)
    h = rmsnorm(x, P["input_layernorm.weight"], c["rms_norm_eps"])
    q = mm(h, P["self_attn.q_proj.kernel"], mode).reshape(B, T, H, hd)
    k = mm(h, P["self_attn.k_proj.kernel"], mode).reshape(B, T, KV, hd)
    v = mm(h, P["self_attn.v_proj.kernel"], mode).reshape(B, T, KV, hd)
    q, k = rope(q, pos, c["rope_theta"]), rope(k, pos, c["rope_theta"])
    return x + mm(attention(q, k, v, mode), P["self_attn.o_proj.kernel"], mode)


def layer_leaves(weights: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    p = f"layers_{i}."
    return {k[len(p):]: v for k, v in weights.items() if k.startswith(p)}


@torch.no_grad()
def forward_logits(c: Dict, weights: Dict[str, torch.Tensor], tokens: torch.Tensor,
                   mode: str = "fp32") -> torch.Tensor:
    """(T, vocab) float32 logits of the (T,) token ids, every position."""
    x = weights["embed_tokens.embedding"][tokens].float()[None]
    for i in range(c["num_hidden_layers"]):
        P = {k: v.float() for k, v in layer_leaves(weights, i).items()}
        x = attention_block(P, x, c, mode)
        h = rmsnorm(x, P["post_attention_layernorm.weight"], c["rms_norm_eps"])
        g = torch.nn.functional.silu(mm(h, P["mlp.gate_proj.kernel"], mode))
        x = x + mm(g * mm(h, P["mlp.up_proj.kernel"], mode), P["mlp.down_proj.kernel"], mode)
        del P
    h = rmsnorm(x, weights["norm.weight"], c["rms_norm_eps"])
    return mm(h, weights["lm_head.kernel"], mode)[0]
