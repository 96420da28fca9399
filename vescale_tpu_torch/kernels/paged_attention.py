"""Paged-attention decode — K/V read straight from the page pool.

``paged_decode`` is one decode step's attention for every slot: one query
row per head against the K/V the slot holds in the paged pool, reached
through its page table, masked at its length, with an online fp32 softmax.
On a CUDA tensor it launches ``csrc/paged_decode.cuh``'s kernel (the port of
``vescale_tpu/kernels/paged_attention.py::_decode_kernel``); on a CPU
tensor it runs :func:`paged_decode_reference`, the gather chain the JAX
serve engine runs with its kernels off (``serve/engine.py::paged_attention``).

:func:`paged_decode_split_reference` is a plain model of how the kernel
cuts the work: chunks of ``CHUNK`` positions dealt round-robin to the
``CLUSTER`` CTAs of a (slot, kv head), ``WARP_ROWS`` positions of a chunk to
each warp, each warp an online softmax over its steps, the partials combined
in warp order and then in rank order.  The tests hold it to the JAX
package; nothing on the card's path runs it.

Head dims: the kernel is compiled at hd = 64 and 128 and takes every hd
<= 128 with hd % 4 == 0 (:func:`kernels.kernel_head_dim`).  A pool of
another hd keeps its own layout (the KV cache's, never padded); the
kernel runs at the next compiled width with its lanes predicated on
d < hd, computing zeros past hd (``csrc/paged_decode_pad.cu``, a library of
its own beside ``paged_decode.cu``'s compiled widths).
"""

from __future__ import annotations

import ctypes

import torch

from . import (KERNEL_HEAD_DIMS, LAUNCHES, _build, costed, kernel_head_dim, require_hopper,
               work_head_dim)

__all__ = ["paged_decode", "paged_decode_reference", "paged_decode_split_reference", "check_shapes",
           "kernel_layout", "CHUNK", "CLUSTER", "WARP_ROWS"]

_NEG_INF = -1e30
# the kernel's partition (csrc/paged_decode.cuh: kChunk, kCluster, kRows)
CHUNK = 64  # positions a chunk
CLUSTER = 4  # CTAs a (slot, kv head); rank r takes chunks r, r + CLUSTER, ...
WARP_ROWS = 16  # positions of a chunk each warp takes
_MAX_GROUP = 16  # q heads per kv head the kernel holds on chip
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


def _fmax_rows(x, dim):
    """Max along ``dim`` ignoring NaN, as the kernel's ``fmaxf`` does (an
    all-NaN row gives -1e30)."""
    return torch.where(torch.isnan(x), torch.full_like(x, _NEG_INF), x).amax(dim)


def _combine(m, l, acc):
    """Partials (..., P) / (..., P, hd) combined along P in order: M = max m,
    w = exp(m - M), l = sum w l, acc = sum w acc."""
    M = m.amax(-1)
    w = torch.exp(m - M[..., None])
    return M, (w * l).sum(-1), (w[..., None] * acc).sum(-2)


def paged_decode_split_reference(q, k_pool, v_pool, table, lengths, *, scale):
    """Plain PyTorch model of the kernel's partition and combine, slot by
    slot.  Positions of a slot (its length clamped to ``page * Pmax``) are
    cut into chunks of ``CHUNK``; chunk j goes to rank j % ``CLUSTER``, at
    its step j // ``CLUSTER``; positions [w * WARP_ROWS, (w + 1) * WARP_ROWS)
    of a chunk go to warp w.  Each (rank, warp) runs an online fp32 softmax over
    its steps (max ignoring NaN, masked positions exactly 0), the warps of a
    rank are combined, then the ranks that had chunks, each in order.  A
    slot's output depends on its own length, table row and pool rows only.
    Returns fp32 (S, H, hd)."""
    S, H, hd = q.shape
    _, page, KV, _ = k_pool.shape
    G = H // KV
    Pmax = table.shape[1]
    chunk, cluster, rows = CHUNK, CLUSTER, WARP_ROWS
    warps = chunk // rows
    span = chunk * cluster
    out = torch.zeros((S, H, hd), dtype=torch.float32, device=q.device)
    for s in range(S):
        n = max(0, min(int(lengths[s]), page * Pmax))
        if n == 0:
            continue
        steps = -(-n // span)
        T = steps * span
        pos = torch.arange(T, device=q.device)
        valid = pos < n
        safe = torch.where(valid, pos, torch.zeros_like(pos))
        pg = table[s].long()[safe // page]
        zero = torch.zeros((), dtype=torch.float32, device=q.device)
        ks = torch.where(valid[:, None, None], k_pool[pg, safe % page].float(), zero)
        vs = torch.where(valid[:, None, None], v_pool[pg, safe % page].float(), zero)
        qg = (q[s].float() * scale).reshape(KV, G, hd)
        sc = (qg[:, :, None, :] * ks.permute(1, 0, 2)[:, None]).sum(-1)  # (KV, G, T)
        sc = torch.where(valid, sc, torch.full_like(sc, _NEG_INF))
        # position = ((step * cluster + rank) * warps + warp) * rows + i
        sc = sc.reshape(KV, G, steps, cluster, warps, rows)
        ok = valid.reshape(steps, cluster, warps, rows)
        vv = vs.reshape(steps, cluster, warps, rows, KV, hd)
        m = torch.full((KV, G, cluster, warps), _NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((KV, G, cluster, warps, hd), device=q.device)
        for st in range(steps):
            x = sc[:, :, st]
            m_new = torch.fmax(m, _fmax_rows(x, -1))
            p = torch.where(ok[st], torch.exp(x - m_new[..., None]), zero)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("kgcwr,cwrkd->kgcwd", p, vv[st])
            m = m_new
        m_r, l_r, acc_r = _combine(m, l, acc)  # the warps of each rank
        ranks = min(-(-n // chunk), cluster)  # those that had chunks
        _, l_s, acc_s = _combine(m_r[..., :ranks], l_r[..., :ranks], acc_r[..., :ranks, :])
        l_s = torch.where(l_s == 0, torch.ones_like(l_s), l_s)
        out[s] = (acc_s / l_s[..., None]).reshape(H, hd)
    return out


def kernel_layout(kv_dtype, hd: int, group: int) -> dict:
    """Shared memory bytes a CTA and cp.async ring stages of the kernel that
    serves pools of ``kv_dtype`` at ``hd`` and ``group`` q heads per kv head
    (builds the library on first use; needs the toolkit, not a card)."""
    fn = _build.load("paged_decode", "vtt_paged_decode_layout",
                     (ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)))
    smem, stages = ctypes.c_int(), ctypes.c_int()
    rc = fn(int(kv_dtype == torch.bfloat16), hd, group, ctypes.byref(smem), ctypes.byref(stages))
    if rc != 0:
        raise ValueError(f"paged_decode: no kernel for hd {hd}, group {group}")
    return dict(smem_bytes=smem.value, stages=stages.value)


def paged_decode_cost(q, k_pool, v_pool, table, lengths, **_):
    """(flops, bytes) of one decode step over this call's lengths (read
    on the host): the K/V rows the slots hold, read once; q, the table and
    the lengths; the fp32 output.  QK^T and PV over those rows, on a CUDA
    tensor at the kernel's compiled head dim (the bytes stay hd's: the
    kernel reads no padding)."""
    S, H, hd = q.shape
    KV = k_pool.shape[2]
    tokens = int(lengths.sum())
    nbytes = (2 * tokens * KV * hd * k_pool.element_size() + q.numel() * q.element_size()
              + table.numel() * 4 + lengths.numel() * 4 + S * H * hd * 4)
    return 4 * tokens * H * work_head_dim(q, hd), nbytes


def check_shapes(q, k_pool, v_pool, table, lengths) -> None:
    """The kernel's contract on shapes, head dims (``kernel_head_dim``),
    dtypes and memory, on any device; raises otherwise."""
    S, H, hd = q.shape
    N, page, KV, hd2 = k_pool.shape
    Pmax = table.shape[1] if table.dim() == 2 else -1
    if hd2 != hd or v_pool.shape != k_pool.shape or H % KV or H // KV > _MAX_GROUP:
        raise ValueError(f"paged_decode: q {tuple(q.shape)} vs pools {tuple(k_pool.shape)}")
    kernel_head_dim("paged_decode", hd)
    if table.shape != (S, Pmax) or lengths.shape != (S,):
        raise ValueError(f"paged_decode: table {tuple(table.shape)}, lengths {tuple(lengths.shape)}")
    if q.dtype not in _DTYPES or k_pool.dtype not in _DTYPES or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"paged_decode: dtypes q {q.dtype}, pools {k_pool.dtype}/{v_pool.dtype}")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_decode: table and lengths must be int32")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool), ("table", table), ("lengths", lengths)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_decode: {name} must be contiguous on {q.device}")


@costed("paged_decode", paged_decode_cost)
def paged_decode(q, k_pool, v_pool, table, lengths, *, scale):
    """One decode-step attention over ONE layer's paged pool.

    ``q``: (S, H, hd) new-token queries; ``k_pool``/``v_pool``:
    (N, page, KV, hd), page 0 the null page; ``table``: (S, Pmax) int32
    physical page ids; ``lengths``: (S,) int32 valid positions per slot, the
    new token included, each at least 1.  Returns fp32 (S, H, hd)."""
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pool, v_pool, table, lengths, scale=scale)
    require_hopper(q)
    check_shapes(q, k_pool, v_pool, table, lengths)
    S, H, hd = q.shape
    N, page, KV, _ = k_pool.shape
    Pmax = table.shape[1]
    out = torch.empty((S, H, hd), dtype=torch.float32, device=q.device)
    # the compiled head dims and the padded ones are two libraries
    lib = "paged_decode" if hd in KERNEL_HEAD_DIMS else "paged_decode_pad"
    fn = _build.load(lib, "vtt_" + lib, _ARGTYPES)
    rc = fn(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_pool.data_ptr(), v_pool.data_ptr(),
        int(k_pool.dtype == torch.bfloat16), table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        S, H, KV, hd, page, Pmax, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: cudaError {rc}")
    LAUNCHES["paged_decode"] += 1
    return out
