"""Paged-attention decode — K/V read straight from the page pool.

``paged_decode`` is one decode step's attention for every slot: one query
row per head against the K/V the slot holds in the paged pool, reached
through its page table, masked at its length, with an online fp32 softmax.
On a CUDA tensor it launches ``csrc/paged_decode.cu`` (the port of
``vescale_tpu/kernels/paged_attention.py::_decode_kernel``); on a CPU
tensor it runs :func:`paged_decode_reference`, the gather chain the JAX
serve engine runs with its kernels off (``serve/engine.py::paged_attention``).
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, _build, require_hopper

__all__ = ["paged_decode", "paged_decode_reference"]

_NEG_INF = -1e30
_MAX_GROUP = 16  # q heads per kv head the kernel holds on chip
_HEAD_DIMS = (64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_void_p,
)


def paged_decode_reference(q, k_pool, v_pool, table, lengths, *, scale):
    """Plain PyTorch: gather each slot's pages into a dense (S, Tmax) view,
    mask by length, fp32 softmax, matmul.  Returns fp32 (S, H, hd)."""
    S, H, hd = q.shape
    _, page, KV, _ = k_pool.shape
    Tmax = page * table.shape[1]
    idx = table.long()
    ks = k_pool[idx].reshape(S, Tmax, KV, hd)
    vs = v_pool[idx].reshape(S, Tmax, KV, hd)
    qg = (q.float() * scale).reshape(S, KV, H // KV, hd)
    s = torch.einsum("skgd,stkd->skgt", qg, ks.float())
    mask = torch.arange(Tmax, device=q.device)[None, :] < lengths[:, None].to(q.device)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("skgt,stkd->skgd", p, vs.float()).reshape(S, H, hd)


def paged_decode(q, k_pool, v_pool, table, lengths, *, scale):
    """One decode-step attention over ONE layer's paged pool.

    ``q``: (S, H, hd) new-token queries; ``k_pool``/``v_pool``:
    (N, page, KV, hd), page 0 the null page; ``table``: (S, Pmax) int32
    physical page ids; ``lengths``: (S,) int32 valid positions per slot, the
    new token included, each at least 1.  Returns fp32 (S, H, hd)."""
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pool, v_pool, table, lengths, scale=scale)
    require_hopper(q)
    S, H, hd = q.shape
    N, page, KV, hd2 = k_pool.shape
    Pmax = table.shape[1] if table.dim() == 2 else -1
    if hd2 != hd or v_pool.shape != k_pool.shape or H % KV or H // KV > _MAX_GROUP:
        raise ValueError(f"paged_decode: q {tuple(q.shape)} vs pools {tuple(k_pool.shape)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"paged_decode: head_dim {hd} not in {_HEAD_DIMS}")
    if table.shape != (S, Pmax) or lengths.shape != (S,):
        raise ValueError(f"paged_decode: table {tuple(table.shape)}, lengths {tuple(lengths.shape)}")
    if q.dtype not in _DTYPES or k_pool.dtype not in _DTYPES or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"paged_decode: dtypes q {q.dtype}, pools {k_pool.dtype}/{v_pool.dtype}")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_decode: table and lengths must be int32")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool), ("table", table), ("lengths", lengths)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_decode: {name} must be contiguous on {q.device}")
    out = torch.empty((S, H, hd), dtype=torch.float32, device=q.device)
    fn = _build.load("paged_decode", "vtt_paged_decode", _ARGTYPES)
    rc = fn(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_pool.data_ptr(), v_pool.data_ptr(),
        int(k_pool.dtype == torch.bfloat16), table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        S, H, KV, hd, page, Pmax, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: cudaError {rc}")
    LAUNCHES["paged_decode"] += 1
    return out
