"""Flash attention — the (B, T, H, D) front end over the flash kernels.

The port of ``vescale_tpu/ops/flash_attention.py::flash_attention``: a
custom op (``vtt::flash_attention``, the reference's ``custom_vjp``) whose
forward runs ``kernels.flash_fwd`` and saves q, k, v, o and the
logsumexp, and whose registered backward runs ``kernels.flash_bwd``
(``vtt::flash_attention_bwd``).  Under ``torch.no_grad`` (the
serve path) only the forward runs.  ``flash_attention_sharded`` is the
reference's multi-rank entry: it runs the same op on this rank's batch
and head pieces, with no communication.  The kernels mask
any T, so there is no block-size divisibility rule and no dense fallback:
a CUDA tensor always runs the kernels, a CPU tensor their plain versions.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..kernels.flash_attention import flash_bwd, flash_fwd

__all__ = ["flash_attention", "flash_attention_sharded", "flash_attention_op",
           "flash_attention_bwd_op"]

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


# The kernels run as two ``torch.library`` custom ops, the forward with the
# backward registered as its autograd formula (the reference's ``_flash``
# custom_vjp).  A custom op is one node to every tracer and dispatch mode:
# torch.fx (``pipe.graph_split``) records ``vtt.flash_attention`` itself,
# and replaying that node launches the kernel on the card, where a trace of
# the ctypes launch inside would record only the ``torch.empty`` around it.
@torch.library.custom_op("vtt::flash_attention", mutates_args=())
def flash_attention_op(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor, scale: float,
                       causal: bool, H: int, KV: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o3, lse) in the kernels' (B*H, T, D) layout: ``kernels.flash_fwd``."""
    return flash_fwd(q3, k3, v3, scale=scale, causal=causal, H=H, KV=KV)


@flash_attention_op.register_fake
def _(q3, k3, v3, scale, causal, H, KV):
    return torch.empty_like(q3), q3.new_empty((q3.shape[0] // H, H, q3.shape[1]),
                                             dtype=torch.float32)


@torch.library.custom_op("vtt::flash_attention_bwd", mutates_args=())
def flash_attention_bwd_op(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                           o3: torch.Tensor, do3: torch.Tensor, lse: torch.Tensor, scale: float,
                           causal: bool, H: int,
                           KV: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq3, dk3, dv3): ``kernels.flash_bwd``."""
    return flash_bwd(q3, k3, v3, o3, do3.contiguous(), lse, scale=scale, causal=causal, H=H,
                     KV=KV)


@flash_attention_bwd_op.register_fake
def _(q3, k3, v3, o3, do3, lse, scale, causal, H, KV):
    return torch.empty_like(q3), torch.empty_like(k3), torch.empty_like(v3)


def _flash_setup(ctx, inputs, output):
    q3, k3, v3, scale, causal, H, KV = inputs
    o3, lse = output
    ctx.save_for_backward(q3, k3, v3, o3, lse)
    ctx.args = (scale, causal, H, KV)


def _flash_backward(ctx, do3, dlse):
    """Residuals (q, k, v, o, lse).  The logsumexp's cotangent ``dlse`` is
    dropped: the op is differentiable in q, k and v through o only, so a
    caller that merges attention blocks through the returned lse (a ring
    step's merge) gets wrong gradients from it and must run the backward
    kernels itself (``parallel.context``'s ring does)."""
    q3, k3, v3, o3, lse = ctx.saved_tensors
    scale, causal, H, KV = ctx.args
    dq3, dk3, dv3 = flash_attention_bwd_op(q3, k3, v3, o3, do3, lse, scale, causal, H, KV)
    return dq3, dk3, dv3, None, None, None, None


flash_attention_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def flash_attention(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Fused attention over (B, T, H, D) q with (B, T, G, D) k/v, G | H;
    GQA runs natively in the kernels.  Returns (B, T, H, D) in q's dtype;
    differentiable in q, k and v."""
    B, T, H, D = q.shape
    G = k.shape[2]
    if H % max(G, 1):
        raise ValueError(f"q heads {H} not a multiple of kv heads {G}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    o3, _ = flash_attention_op(_to3(q), _to3(k), _to3(v), float(scale), bool(causal), H, G)
    return _from3(o3, B, H)


def flash_attention_sharded(q, k, v, mesh, *, batch_dims=("dp",), head_dim: Optional[str] = "tp",
                            causal: bool = True, scale: Optional[float] = None):
    """Multi-rank flash attention (reference ``ops/flash_attention.py:346``):
    batch sharded over ``batch_dims`` and heads over ``head_dim``.
    Attention is independent per (batch, head), so each rank runs
    :func:`flash_attention` (the kernels) on its own pieces with no
    communication.  ``q``: this rank's (B/dp, T, H/tp, D) piece, ``k``/``v``
    its (B/dp, T, KV/tp, D) pieces (heads [r·H/tp, (r+1)·H/tp) for the
    coordinate r on ``head_dim``); returns its (B/dp, T, H/tp, D) output
    piece.  A GQA group must not straddle ranks: KV divisible by the head
    dim's size, as the reference's shard_map requires, so the local pieces
    keep H/KV.  ``batch_dims`` is taken as the reference takes it, and
    asks for no check: each rank's batch piece is its own.  ``scale``
    defaults to 1/sqrt(D)."""
    hd = head_dim if head_dim in mesh.mesh_dim_names else None
    if hd is not None:
        H, G = q.shape[2], k.shape[2]
        if G < 1 or H % G or v.shape[2] != G:
            raise ValueError(f"flash_attention_sharded: local q heads {H}, kv heads {G} "
                             f"and {v.shape[2]}: the kv heads must split over {hd!r} "
                             "with their query groups")
    return flash_attention(q, k, v, causal=causal, scale=scale)
