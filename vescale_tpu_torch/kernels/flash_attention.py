"""Flash attention, forward and backward — the kernel half of
``ops/flash_attention.py``.

``flash_fwd`` computes softmax attention, causal or full, with an online
fp32 softmax and saves the per-row logsumexp, over (B*H, T, D) q and
(B*KV, T, D) k/v: GQA routes q row b to kv row (b // H) * KV + (b % H) //
(H // KV), so the repeated K/V heads never exist in memory.  On a CUDA
tensor it launches ``csrc/flash_fwd.cu`` (the port of
``vescale_tpu/kernels/flash_attention.py::_fwd_kernel`` and
``::_fwd_kernel_stream``): for bf16 inputs the tensor-core (``wgmma``)
kernel, which rounds P to bf16 before the value product; for fp32 inputs
the CUDA-core kernel, all in fp32.  On a CPU tensor it runs
:func:`flash_fwd_reference`, the math of the JAX package's
``ops/flash_attention.py::_xla_fwd_4d``; its ``pd_dtype`` argument models
the bf16 kernel's rounding.

``flash_bwd`` is its gradient: (dq, dk, dv) from q, k, v, the forward's o
and lse, and do, with the probabilities recomputed from lse.  On a CUDA
tensor it launches the two kernels of ``csrc/flash_bwd.cu`` (the port of
``::_dq_kernel``/``::_dq_kernel_stream`` and
``::_dkv_kernel``/``::_dkv_kernel_stream``): for bf16 inputs the
tensor-core (``wgmma``) kernels, which round P and dS to bf16 before the
dV, dK and dQ products; for fp32 inputs the CUDA-core kernels, all in
fp32.  On a CPU tensor it runs :func:`flash_bwd_reference`, the math of
``ops/flash_attention.py::_xla_bwd_4d``; its ``pd_dtype`` argument models
the bf16 kernels' rounding.  delta = rowsum(do * o) is a plain fp32 op on
both, as the reference computes it outside its kernels.

Head dims: the CUDA kernels are compiled at D = 64 and 128.  A head dim
between (every D <= 128 with D % 4 == 0, :func:`kernels.kernel_head_dim`)
runs at the next compiled width: the wrappers copy q, k, v (and dO) into
zero-padded tensors, launch with the caller's ``scale`` (1/sqrt(D), never
the padded width's) and keep the first D columns of o, dq, dk and dv.
Zero columns change neither QK^T nor delta = rowsum(dO * O), so the
padded launch computes the same function; it reads and computes the
padded width, which the ``*_cost`` functions count on a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, _build, costed, kernel_head_dim, require_hopper, work_head_dim

__all__ = [
    "flash_fwd",
    "flash_fwd_reference",
    "flash_bwd",
    "flash_bwd_dq",
    "flash_bwd_dkv",
    "flash_bwd_reference",
    "check_shapes",
]

_NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)
# q, k, v, do, lse, delta, out..., BH, seq, D, H, KV, scale, causal, is_bf16, stream
_BWD_ARGTYPES = {
    "vtt_flash_bwd_dq": (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5
    + (ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
    "vtt_flash_bwd_dkv": (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 5
    + (ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
}


def flash_fwd_reference(q3, k3, v3, *, scale, causal, H, KV, pd_dtype=None):
    """Plain PyTorch, dense: the full (T, T) score matrix per head in fp32.
    Returns (o (B*H, T, D) in q's dtype, lse (B, H, T) fp32).  Float64
    inputs are computed in float64 throughout (lse too): the same function
    without fp32 rounding, the arbiter the bf16 kernel is held to.

    ``pd_dtype`` (default None: no rounding) rounds P = exp(s - m) to that
    dtype before the value product, where the bf16 tensor-core kernel
    rounds it; l sums the unrounded P, as the kernel's does, so lse is the
    same either way.  ``torch.bfloat16`` is the model that kernel is held
    to."""
    BH, T, D = q3.shape
    B, rep = BH // H, H // KV
    acc = torch.float64 if q3.dtype == torch.float64 else torch.float32
    q = q3.to(acc).reshape(B, KV, rep, T, D)
    k = k3.to(acc).reshape(B, KV, T, D)
    v = v3.to(acc).reshape(B, KV, T, D)
    s = scale * torch.einsum("bgrqd,bgkd->bgrqk", q, k)
    if causal:
        mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=q3.device))
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    if pd_dtype is not None:
        p = p.to(pd_dtype).to(acc)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p, v) / l_safe[..., None]
    lse = (m + torch.log(l_safe)).reshape(B, H, T)
    return o.reshape(BH, T, D).to(q3.dtype), lse


def check_shapes(what, q3, k3, v3, H, KV, **others):
    """The kernels' contract on shapes, head dims (``kernel_head_dim``),
    dtypes and memory, on any device; raises otherwise.  ``others`` are
    further (B*H, T, D) tensors in q's dtype.  Returns (B, T, D)."""
    BH, T, D = q3.shape
    if H <= 0 or KV <= 0 or H % KV or BH % H or T < 1:
        raise ValueError(f"{what}: q {tuple(q3.shape)} with H={H}, KV={KV}")
    B = BH // H
    if k3.shape != (B * KV, T, D) or v3.shape != k3.shape:
        raise ValueError(f"{what}: q {tuple(q3.shape)} vs k {tuple(k3.shape)}, v {tuple(v3.shape)}")
    kernel_head_dim(what, D)
    if q3.dtype not in _DTYPES or k3.dtype != q3.dtype or v3.dtype != q3.dtype:
        raise ValueError(f"{what}: dtypes {q3.dtype}/{k3.dtype}/{v3.dtype}")
    for name, t in others.items():
        if t.shape != q3.shape or t.dtype != q3.dtype:
            raise ValueError(f"{what}: {name} {tuple(t.shape)}/{t.dtype} vs q {tuple(q3.shape)}/{q3.dtype}")
    for name, t in (("q", q3), ("k", k3), ("v", v3), *others.items()):
        if t.device != q3.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous on {q3.device}, 16-byte aligned")
    return B, T, D


def _check(what, q3, k3, v3, H, KV, **others):
    """:func:`check_shapes` on a Hopper card's tensors."""
    require_hopper(q3)
    return check_shapes(what, q3, k3, v3, H, KV, **others)


def flash_fwd_cost(q3, k3, v3, *, causal, H, KV, **_):
    """(flops, bytes) of one forward: QK^T and PV, halved when causal; q,
    k, v read and o written in their dtype, lse written in fp32.  On a CUDA
    tensor at the kernel's (padded) head dim, elsewhere at D."""
    BH, T, D = q3.shape
    W = work_head_dim(q3, D)
    B = BH // H
    elt = q3.element_size()
    nbytes = (2 * BH + 2 * k3.shape[0]) * T * W * elt + B * H * T * 4
    return (2 if causal else 4) * T * T * H * W * B, nbytes


def _bwd_cost(q3, k3, causal, H, products, outs_kv):
    BH, T, D = q3.shape
    W = work_head_dim(q3, D)
    B = BH // H
    elt = q3.element_size()
    n_q, n_kv = BH * T * W, k3.shape[0] * T * W
    frac = 0.5 if causal else 1.0
    # q k v do read, lse and delta read in fp32, then dq or (dk, dv) written
    nbytes = (n_q + 2 * n_kv + n_q + (2 * n_kv if outs_kv else n_q)) * elt + 2 * BH * T * 4
    return 2 * products * frac * T * T * H * W * B, nbytes


def flash_bwd_dq_cost(q3, k3, v3, do3, lse, delta, *, causal, H, KV, **_):
    """(flops, bytes) of the dq kernel: S, dP and dQ recomputed per tile."""
    return _bwd_cost(q3, k3, causal, H, 3, False)


def flash_bwd_dkv_cost(q3, k3, v3, do3, lse, delta, *, causal, H, KV, **_):
    """(flops, bytes) of the dkv kernel: S, dP, dV and dK."""
    return _bwd_cost(q3, k3, causal, H, 4, True)


def flash_bwd_cost(q3, k3, v3, o3, do3, lse, *, causal, H, KV, **_):
    """(flops, bytes) of the backward: the dq and dkv kernels together."""
    a = _bwd_cost(q3, k3, causal, H, 3, False)
    b = _bwd_cost(q3, k3, causal, H, 4, True)
    return a[0] + b[0], a[1] + b[1]


def _padded(D, *ts):
    """``ts`` zero-padded on their last dim from head dim ``D`` to the
    kernels' width (the tensors themselves when ``D`` is compiled)."""
    W = kernel_head_dim("flash", D)
    if W == D:
        return ts
    return tuple(torch.nn.functional.pad(t, (0, W - D)) for t in ts)


def _unpadded(D, t):
    return t if t.shape[-1] == D else t[..., :D].contiguous()


@costed("flash_fwd", flash_fwd_cost)
def flash_fwd(q3, k3, v3, *, scale, causal, H, KV):
    """(o, lse) of softmax attention; see the module docstring for layouts.
    o has q's dtype; lse is fp32 (B, H, T)."""
    if q3.device.type == "cpu":
        return flash_fwd_reference(q3, k3, v3, scale=scale, causal=causal, H=H, KV=KV)
    BH = q3.shape[0]
    B, T, D0 = _check("flash_fwd", q3, k3, v3, H, KV)
    q3, k3, v3 = _padded(D0, q3, k3, v3)
    D = q3.shape[2]
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
    return _unpadded(D0, o), lse


# ----------------------------------------------------------------- backward
def flash_bwd_reference(q3, k3, v3, o3, do3, lse, *, scale, causal, H, KV, pd_dtype=None):
    """Plain PyTorch, dense: ``_xla_bwd_4d`` in the (B*H, T, D) layout, the
    full (T, T) probabilities per head in fp32, recomputed from ``lse``
    ((B, H, T) or (B*H, T)).  dk and dv sum the group's heads in fp32 before
    the cast.  Returns (dq, dk, dv) in q's, k's and v's dtypes.  Float64
    inputs are computed in float64 throughout: the same function without
    fp32 rounding, the arbiter a kernel's sums are held to at long T.

    ``pd_dtype`` (default None: no rounding) rounds P and dS to that dtype
    before the dV, dK and dQ products, where the bf16 tensor-core kernels
    round them: ``torch.bfloat16`` is the model those kernels are held to."""
    BH, T, D = q3.shape
    B, rep = BH // H, H // KV
    acc = torch.float64 if q3.dtype == torch.float64 else torch.float32
    q = q3.to(acc).reshape(B, KV, rep, T, D)
    k = k3.to(acc).reshape(B, KV, T, D)
    v = v3.to(acc).reshape(B, KV, T, D)
    do = do3.to(acc).reshape(B, KV, rep, T, D)
    s = scale * torch.einsum("bgrqd,bgkd->bgrqk", q, k)
    if causal:
        mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=q3.device))
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.exp(s - lse.to(acc).reshape(B, KV, rep, T)[..., None])
    delta = (do * o3.to(acc).reshape(B, KV, rep, T, D)).sum(dim=-1)
    dp = torch.einsum("bgrqd,bgkd->bgrqk", do, v)
    ds = p * (dp - delta[..., None]) * scale
    if pd_dtype is not None:
        p, ds = p.to(pd_dtype).to(acc), ds.to(pd_dtype).to(acc)
    dq = torch.einsum("bgrqk,bgkd->bgrqd", ds, k).reshape(BH, T, D).to(q3.dtype)
    dk = torch.einsum("bgrqk,bgrqd->bgkd", ds, q).reshape(B * KV, T, D).to(k3.dtype)
    dv = torch.einsum("bgrqk,bgrqd->bgkd", p, do).reshape(B * KV, T, D).to(v3.dtype)
    return dq, dk, dv


def _delta(o3, do3):
    """rowsum(do * o) in fp32, (B*H, T): the reference's jnp op before its
    kernels (``kernels/flash_attention.py:388``)."""
    return (do3.float() * o3.float()).sum(dim=-1)


def _bwd_launch(symbol, q3, k3, v3, do3, lse, delta, outs, scale, causal, H, KV):
    BH, T, D = q3.shape
    if lse.numel() != BH * T or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"{symbol}: lse must be contiguous fp32 with {BH * T} values")
    if delta.shape != (BH, T) or delta.dtype != torch.float32 or not delta.is_contiguous():
        raise ValueError(f"{symbol}: delta must be contiguous fp32 ({BH}, {T})")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.device != q3.device or t.data_ptr() % 16:
            raise ValueError(f"{symbol}: {name} must lie on {q3.device}, 16-byte aligned")
    fn = _build.load("flash_bwd", symbol, _BWD_ARGTYPES[symbol])
    rc = fn(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *(0 if t is None else t.data_ptr() for t in outs), BH, T, D, H, KV,
        float(scale),
        int(bool(causal)), int(q3.dtype == torch.bfloat16),
        torch.cuda.current_stream(q3.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {rc}")


@costed("flash_bwd_dq", flash_bwd_dq_cost)
def flash_bwd_dq(q3, k3, v3, do3, lse, delta, *, scale, causal, H, KV):
    """dq (B*H, T, D) in q's dtype from the dq kernel; CUDA tensors only.
    ``delta`` is :func:`_delta` of (o, do)."""
    D0 = _check("flash_bwd_dq", q3, k3, v3, H, KV, do=do3)[2]
    q3, k3, v3, do3 = _padded(D0, q3, k3, v3, do3)
    dq = torch.empty_like(q3)
    _bwd_launch("vtt_flash_bwd_dq", q3, k3, v3, do3, lse, delta, (dq,), scale, causal, H, KV)
    LAUNCHES["flash_bwd_dq"] += 1
    return _unpadded(D0, dq)


@costed("flash_bwd_dkv", flash_bwd_dkv_cost)
def flash_bwd_dkv(q3, k3, v3, do3, lse, delta, *, scale, causal, H, KV):
    """(dk, dv) (B*KV, T, D) in k's dtype from the dkv kernel; CUDA
    tensors only."""
    D0 = _check("flash_bwd_dkv", q3, k3, v3, H, KV, do=do3)[2]
    q3, k3, v3, do3 = _padded(D0, q3, k3, v3, do3)
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    # the fp32 kernel's running sums of dk and dv over the group's queries;
    # the bf16 kernel keeps its sums in registers and takes none
    total = None
    if q3.dtype == torch.float32:
        total = torch.empty((2, *k3.shape), dtype=torch.float32, device=k3.device)
    _bwd_launch("vtt_flash_bwd_dkv", q3, k3, v3, do3, lse, delta, (dk, dv, total), scale, causal,
                H, KV)
    LAUNCHES["flash_bwd_dkv"] += 1
    return _unpadded(D0, dk), _unpadded(D0, dv)


@costed("flash_bwd", flash_bwd_cost)
def flash_bwd(q3, k3, v3, o3, do3, lse, *, scale, causal, H, KV, delta=None):
    """(dq, dk, dv) of softmax attention; see the module docstring for
    layouts.  ``lse`` is the forward's, (B, H, T) or (B*H, T) fp32.
    ``delta`` is :func:`_delta` of (o3, do3), computed here when not given
    (a ring backward passes its one delta to every block); the plain
    version computes its own."""
    if q3.device.type == "cpu":
        return flash_bwd_reference(q3, k3, v3, o3, do3, lse, scale=scale, causal=causal, H=H, KV=KV)
    if o3.shape != q3.shape or do3.shape != q3.shape:
        raise ValueError(f"flash_bwd: o {tuple(o3.shape)}, do {tuple(do3.shape)} vs q {tuple(q3.shape)}")
    lse = lse.reshape(q3.shape[0], q3.shape[1])
    if delta is None:
        delta = _delta(o3, do3)
    args = dict(scale=scale, causal=causal, H=H, KV=KV)
    # pad once for both kernels, which then see a compiled width
    D = q3.shape[2]
    q3p, k3p, v3p, do3p = _padded(D, q3, k3, v3, do3)
    dq = flash_bwd_dq(q3p, k3p, v3p, do3p, lse, delta, **args)
    dk, dv = flash_bwd_dkv(q3p, k3p, v3p, do3p, lse, delta, **args)
    return _unpadded(D, dq), _unpadded(D, dk), _unpadded(D, dv)
