"""Context parallelism: ring attention, Ulysses and blockwise attention.

The port of ``vescale_tpu/parallel/context.py``.  The sequence dim of q,
k and v is sharded over an ``sp`` mesh dim; each rank passes its own
contiguous (B, T/n, H, D) pieces (or ``DArray``s sharded on dim 1, whose
global T is then checked) and gets its own piece of the output.

  * ``ring_self_attention`` — each rank keeps its q block; the k/v blocks
    travel n - 1 hops around the ring (``collectives.mesh_ppermute``).
    Every ring step is one ``kernels.flash_fwd`` on (q, k_cur, v_cur):
    causal on the diagonal block, full for the blocks of lower ranks.
    Blocks past the diagonal are skipped, where the reference computes
    them fully masked (they add nothing).  The steps merge by their
    logsumexp in fp32.  The backward is its own ``autograd.Function``: it
    saves the final O and the global lse, computes delta = rowsum(dO∘O)
    once, and runs ``kernels.flash_bwd`` (its dq and dkv kernels) on each
    block with that global lse and delta, so each block's P is its slice
    of the whole row's softmax.  dq accumulates locally in fp32; dk and dv
    accumulate in fp32 buffers that travel the ring with k and v and
    return to their owners.  On a CPU tensor the same code runs the
    kernels' plain versions, which take the same lse.
  * ``ulysses_self_attention`` — all-to-all seq -> heads
    (``dmodule._comm.all_to_all``: split dim 2, concat dim 1), any
    full-sequence attention on H/n heads, and the reverse all-to-all.
    The default ``attn_fn`` is ``ops.flash_attention``: the kernels on a
    CUDA tensor, their plain versions on a CPU one.
  * ``blockwise_attention`` — one device, the reference's online-softmax
    loop over every (q block, kv block) pair, padded to ``block_size``
    with the padded keys masked.

On a mesh dim of size one the ring is one flash call and Ulysses calls
``attn_fn`` directly.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .. import collectives as C
from ..darray import DArray
from ..dmodule._comm import TPDim, all_to_all
from ..kernels.flash_attention import _delta, flash_bwd, flash_fwd
from ..ops.flash_attention import flash_attention

__all__ = ["ring_self_attention", "ulysses_self_attention", "blockwise_attention"]


def _to3(x):
    B, T, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, T, D).contiguous()


def _from3(x, B, H):
    BH, T, D = x.shape
    return x.reshape(B, H, T, D).permute(0, 2, 1, 3)


def _locals(q, k, v, n: int, need_heads: bool = False):
    """The local pieces of q, k and v, and a function that wraps this
    rank's output piece as its input was (a ``DArray`` like q, or a
    tensor).  A ``DArray`` input's global T must divide by the sp size
    ``n``, and with ``need_heads`` so must its heads."""
    if isinstance(q, DArray):
        T, H = q.shape[1], q.shape[2]
        if T % n:
            raise ValueError(f"seq len {T} not divisible by sp={n}")
        if need_heads and H % n:
            raise ValueError(f"seq {T} and heads {H} must divide sp={n}")
        spec, rank = q.spec, q.rank
        return (q.to_local(), k.to_local(), v.to_local(),
                lambda out: DArray(out, spec, rank))
    if need_heads and (q.shape[2] % n or k.shape[2] % n):
        raise ValueError(f"heads {q.shape[2]} (kv {k.shape[2]}) must divide sp={n}")
    return q, k, v, lambda out: out


def _hop(x, sp: TPDim):
    """Rank j's ``x`` to rank j + 1 on the ring (no hop on one rank)."""
    return x if sp.size == 1 else C.mesh_ppermute(x, sp.mesh, sp.index)


def _attends(me: int, src: int, causal: bool) -> bool:
    """Whether rank ``me``'s queries see rank ``src``'s keys at all."""
    return not causal or src <= me


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sp, causal, scale):
        B, t, H, D = q.shape
        G = k.shape[2]
        n, me = sp.size, sp.rank
        q3 = _to3(q)
        kv = torch.stack([_to3(k), _to3(v)])  # one permute a hop moves both
        o_acc = torch.zeros(q3.shape, dtype=torch.float32, device=q.device)
        lse = torch.full((B, H, t), float("-inf"), dtype=torch.float32, device=q.device)
        for r in range(n):
            src = (me - r) % n
            if _attends(me, src, causal):
                o_blk, lse_blk = flash_fwd(q3, kv[0], kv[1], scale=scale,
                                           causal=causal and src == me, H=H, KV=G)
                new = torch.logaddexp(lse, lse_blk)
                o_acc = (o_acc * torch.exp(lse - new).reshape(B * H, t, 1)
                         + o_blk.float() * torch.exp(lse_blk - new).reshape(B * H, t, 1))
                lse = new
            if r < n - 1:
                kv = _hop(kv, sp)
        o3 = o_acc.to(q.dtype)
        ctx.save_for_backward(q3, _to3(k), _to3(v), o3, lse)
        ctx.args = (sp, causal, scale, B, H, G)
        return _from3(o3, B, H)

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, o3, lse = ctx.saved_tensors
        sp, causal, scale, B, H, G = ctx.args
        n, me = sp.size, sp.rank
        do3 = _to3(do.to(q3.dtype))
        delta = _delta(o3, do3)
        dq = torch.zeros(q3.shape, dtype=torch.float32, device=q3.device)
        kv = torch.stack([k3, v3])
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q3.device)
        for r in range(n):
            src = (me - r) % n
            if _attends(me, src, causal):
                dq_b, dk_b, dv_b = flash_bwd(q3, kv[0], kv[1], o3, do3, lse, scale=scale,
                                             causal=causal and src == me, H=H, KV=G,
                                             delta=delta)
                dq += dq_b.float()
                dkv[0] += dk_b.float()
                dkv[1] += dv_b.float()
            if r < n - 1:
                kv = _hop(kv, sp)
            # the sums travel with their block; the last hop returns them
            # to the rank that owns it
            dkv = _hop(dkv, sp)
        return (_from3(dq.to(q3.dtype), B, H), _from3(dkv[0].to(k3.dtype), B, G),
                _from3(dkv[1].to(v3.dtype), B, G), None, None, None)


def ring_self_attention(q, k, v, mesh, sp_dim="sp", causal: bool = True,
                        scale: Optional[float] = None):
    """Attention over a sequence sharded on ``sp_dim``: this rank's
    (B, T/n, H, D) q and its (B, T/n, G, D) k/v (G | H) in, its
    (B, T/n, H, D) output out, differentiable in q, k and v.  Rank j
    holds positions [j·T/n, (j+1)·T/n).  ``DArray`` inputs (Shard(1) on
    ``sp_dim``) give a ``DArray``; their T must divide by the sp size."""
    q, k, v, wrap = _locals(q, k, v, mesh.size(sp_dim))
    sp = TPDim(mesh, sp_dim)
    D = q.shape[-1]
    if q.shape[2] % k.shape[2] or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} vs k {tuple(k.shape)}, v {tuple(v.shape)}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    return wrap(_Ring.apply(q, k, v, sp, bool(causal), scale))


def ulysses_self_attention(q, k, v, mesh, sp_dim="sp", causal: bool = True,
                           scale: Optional[float] = None, attn_fn: Optional[Callable] = None):
    """All-to-all sequence parallelism (Ulysses): this rank's (B, T/n, H,
    D) pieces resharded to (B, T, H/n, D), ``attn_fn(q, k, v, causal,
    scale)`` over the whole sequence on those heads, and resharded back;
    differentiable (the all-to-all's transpose is the swapped
    all-to-all).  H and the kv heads must divide by the sp size.  The
    default ``attn_fn`` is ``ops.flash_attention``."""
    q, k, v, wrap = _locals(q, k, v, mesh.size(sp_dim), need_heads=True)
    sp = TPDim(mesh, sp_dim)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    attn_fn = attn_fn or flash_attention
    qh, kh, vh = (all_to_all(x, sp, 2, 1) for x in (q, k, v))
    return wrap(all_to_all(attn_fn(qh, kh, vh, causal, scale), sp, 1, 2))


def _online_block(q, k, v, mask, scale, m_prev, l_prev, o_prev):
    """One kv block of the online softmax, in fp32 (the reference's
    ``_online_block``: fully masked rows keep m = -inf and add nothing)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, float("-inf")))
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    safe_m = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    alpha = torch.where(torch.isfinite(m_prev), torch.exp(m_prev - safe_m),
                        torch.zeros_like(m_prev))
    l_new = l_prev * alpha + p.sum(dim=-1)
    o_new = o_prev * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return m_new, l_new, o_new


def blockwise_attention(q, k, v, causal: bool = True, scale: Optional[float] = None,
                        block_size: int = 512):
    """Single-device blockwise attention over (B, T, H, D) q, k and v with
    the ring's online-softmax math: the sequence padded to a multiple of
    ``block_size``, every kv block visited for every q block (blocks past
    the causal diagonal add nothing), padded keys masked.  Differentiable
    through autograd."""
    B, T, H, D = q.shape
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    nb = -(-T // block_size)
    pad = nb * block_size - T
    if pad:
        q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
    pos = torch.arange(nb * block_size, device=q.device)
    outs = []
    for qi in range(nb):
        q_blk = q[:, qi * block_size:(qi + 1) * block_size]
        q_pos = pos[qi * block_size:(qi + 1) * block_size]
        m = torch.full((B, H, block_size), float("-inf"), dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, block_size), dtype=torch.float32, device=q.device)
        o = torch.zeros((B, H, block_size, D), dtype=torch.float32, device=q.device)
        for ki in range(nb):
            sl = slice(ki * block_size, (ki + 1) * block_size)
            k_pos = pos[sl]
            mask = (k_pos < T)[None, None, None, :]
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])[None, None]
            m, l, o = _online_block(q_blk, k[:, sl], v[:, sl], mask, scale, m, l, o)
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        outs.append((o / l[..., None]).to(q.dtype).permute(0, 2, 1, 3))
    return torch.cat(outs, dim=1)[:, :T]
