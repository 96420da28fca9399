"""Flash attention — the (B, T, H, D) front end over the flash kernels.

The port of ``vescale_tpu/ops/flash_attention.py::flash_attention``: a
``torch.autograd.Function`` (the reference's ``custom_vjp``) whose forward
runs ``kernels.flash_fwd`` and saves q, k, v, o and the logsumexp, and
whose backward runs ``kernels.flash_bwd``.  Under ``torch.no_grad`` (the
serve path) only the forward runs.  No sharding rule yet.  The kernels mask
any T, so there is no block-size divisibility rule and no dense fallback:
a CUDA tensor always runs the kernels, a CPU tensor their plain versions.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels.flash_attention import flash_bwd, flash_fwd

__all__ = ["flash_attention"]

_NEG_INF = -1e30


def _dense_ref(q, k, v, scale, causal):
    """The JAX package's dense reference, as it is: GQA heads repeated,
    fp32 scores, softmax, P cast to q's dtype before the value matmul."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        T = q.shape[1]
        mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=q.device))
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)


def _to3(x):
    B, T, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, T, D).contiguous()


def _from3(x, B, H):
    BH, T, D = x.shape
    return x.reshape(B, H, T, D).permute(0, 2, 1, 3)


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom_vjp: residuals (q, k, v, o, lse)
    in the kernels' (B*H, T, D) layout."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        B, T, H, D = q.shape
        G = k.shape[2]
        q3, k3, v3 = _to3(q), _to3(k), _to3(v)
        o3, lse = flash_fwd(q3, k3, v3, scale=scale, causal=causal, H=H, KV=G)
        ctx.save_for_backward(q3, k3, v3, o3, lse)
        ctx.args = (scale, causal, B, H, G)
        return _from3(o3, B, H)

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, o3, lse = ctx.saved_tensors
        scale, causal, B, H, G = ctx.args
        dq3, dk3, dv3 = flash_bwd(q3, k3, v3, o3, _to3(do), lse, scale=scale, causal=causal,
                                  H=H, KV=G)
        return _from3(dq3, B, H), _from3(dk3, B, G), _from3(dv3, B, G), None, None


def flash_attention(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Fused attention over (B, T, H, D) q with (B, T, G, D) k/v, G | H;
    GQA runs natively in the kernels.  Returns (B, T, H, D) in q's dtype;
    differentiable in q, k and v."""
    B, T, H, D = q.shape
    G = k.shape[2]
    if H % max(G, 1):
        raise ValueError(f"q heads {H} not a multiple of kv heads {G}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    return _Flash.apply(q, k, v, float(scale), bool(causal))
