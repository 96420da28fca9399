"""Flash attention forward — the kernel half of ``ops/flash_attention.py``.

``flash_fwd`` computes softmax attention, causal or full, with an online
fp32 softmax and saves the per-row logsumexp, over (B*H, T, D) q and
(B*KV, T, D) k/v: GQA routes q row b to kv row (b // H) * KV + (b % H) //
(H // KV), so the repeated K/V heads never exist in memory.  On a CUDA
tensor it launches ``csrc/flash_fwd.cu`` (the port of
``vescale_tpu/kernels/flash_attention.py::_fwd_kernel`` and
``::_fwd_kernel_stream``); on a CPU tensor it runs
:func:`flash_fwd_reference`, the math of the JAX package's
``ops/flash_attention.py::_xla_fwd_4d``.  Forward only: the backward
kernels come with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, _build, require_hopper

__all__ = ["flash_fwd", "flash_fwd_reference"]

_NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


def flash_fwd_reference(q3, k3, v3, *, scale, causal, H, KV):
    """Plain PyTorch, dense: the full (T, T) score matrix per head in fp32.
    Returns (o (B*H, T, D) in q's dtype, lse (B, H, T) fp32)."""
    BH, T, D = q3.shape
    B, rep = BH // H, H // KV
    q = q3.float().reshape(B, KV, rep, T, D)
    k = k3.float().reshape(B, KV, T, D)
    v = v3.float().reshape(B, KV, T, D)
    s = scale * torch.einsum("bgrqd,bgkd->bgrqk", q, k)
    if causal:
        mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=q3.device))
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p, v) / l_safe[..., None]
    lse = (m + torch.log(l_safe)).reshape(B, H, T)
    return o.reshape(BH, T, D).to(q3.dtype), lse


def flash_fwd(q3, k3, v3, *, scale, causal, H, KV):
    """(o, lse) of softmax attention; see the module docstring for layouts.
    o has q's dtype; lse is fp32 (B, H, T)."""
    if q3.device.type == "cpu":
        return flash_fwd_reference(q3, k3, v3, scale=scale, causal=causal, H=H, KV=KV)
    require_hopper(q3)
    BH, T, D = q3.shape
    if H <= 0 or KV <= 0 or H % KV or BH % H or T < 1:
        raise ValueError(f"flash_fwd: q {tuple(q3.shape)} with H={H}, KV={KV}")
    B = BH // H
    if k3.shape != (B * KV, T, D) or v3.shape != k3.shape:
        raise ValueError(f"flash_fwd: q {tuple(q3.shape)} vs k {tuple(k3.shape)}, v {tuple(v3.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd: head_dim {D} not in {_HEAD_DIMS}")
    if q3.dtype not in _DTYPES or k3.dtype != q3.dtype or v3.dtype != q3.dtype:
        raise ValueError(f"flash_fwd: dtypes {q3.dtype}/{k3.dtype}/{v3.dtype}")
    for name, t in (("q", q3), ("k", k3), ("v", v3)):
        if t.device != q3.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_fwd: {name} must be contiguous on {q3.device}, 16-byte aligned")
    o = torch.empty_like(q3)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q3.device)
    fn = _build.load("flash_fwd", "vtt_flash_fwd", _ARGTYPES)
    rc = fn(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(), lse.data_ptr(),
        BH, T, D, H, KV, float(scale), int(bool(causal)), int(q3.dtype == torch.bfloat16),
        torch.cuda.current_stream(q3.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {rc}")
    LAUNCHES["flash_fwd"] += 1
    return o, lse
