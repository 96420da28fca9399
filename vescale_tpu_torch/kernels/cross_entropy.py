"""Fused cross entropy over the vocab dim — the kernel half of ``loss.py``.

``fused_xent_parts(lg, idx, gmax)`` returns, per row of ``lg`` (N, Vs),
the three sums the loss needs, in fp32, from one read of the logits::

    sumexp = sum_c exp(lg[:, c] - gmax)
    picked = lg[:, idx]          (0 where idx is outside [0, Vs))
    sumlg  = sum_c lg[:, c]

It is differentiable in ``lg`` (custom ops ``vtt::xent_parts`` and
``vtt::xent_bwd``, the port of the reference's ``custom_vjp``): the backward is
``dlg = gse * exp(lg - gmax) + onehot(idx) * gpk + gsl``, in lg's dtype,
and ``idx`` and ``gmax`` get no gradient (``gmax`` is the caller's
stop-gradient row max).  Gradients of unused outputs arrive as zeros.

On CUDA tensors the forward launches ``vtt_xent_fwd`` and the backward
``vtt_xent_bwd`` of ``csrc/cross_entropy.cu`` (the ports of
``vescale_tpu/kernels/cross_entropy.py::_xent_fwd_kernel`` and
``::_xent_bwd_kernel``); on CPU tensors they run
:func:`xent_parts_reference` and :func:`xent_bwd_reference`.  ``lg`` is
fp32 or bf16: bf16 is upcast exactly inside the kernel, so the sums equal
those of an fp32 copy, and dlg is rounded once to bf16, as the reference's
``astype`` transpose rounds it.  The kernels mask, so any N and Vs >= 1
run: there is no shape gate and no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import LAUNCHES, _build, costed, require_hopper

__all__ = ["fused_xent_parts", "xent_fwd", "xent_bwd", "xent_parts_reference",
           "xent_bwd_reference"]

_DTYPES = (torch.float32, torch.bfloat16)
_P = ctypes.c_void_p
_ARGTYPES = {
    # lg, idx, gmax, se, pk, sl, n_rows, vs, is_bf16, vec, stream
    "vtt_xent_fwd": (_P,) * 6 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P),
    # lg, idx, gmax, gse, gpk, gsl, dlg, n_rows, vs, is_bf16, vec, stream
    "vtt_xent_bwd": (_P,) * 7 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P),
}


def _acc(lg: torch.Tensor) -> torch.dtype:
    """fp32 sums, or float64 for float64 input: the same function without
    fp32 rounding, the arbiter a kernel's long fp32 sums are held to."""
    return torch.float64 if lg.dtype == torch.float64 else torch.float32


def _pick(lg: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    Vs = lg.shape[1]
    hit = (idx >= 0) & (idx < Vs)
    got = torch.gather(lg, 1, idx.clamp(0, Vs - 1)[:, None].long())[:, 0]
    return torch.where(hit, got, torch.zeros_like(got))


def xent_parts_reference(lg, idx, gmax):
    """Plain PyTorch: (sumexp, picked, sumlg) of (N, Vs) ``lg`` in fp32
    (float64 for float64 input)."""
    acc = _acc(lg)
    lg = lg.to(acc)
    sumexp = torch.exp(lg - gmax.to(acc)[:, None]).sum(dim=-1)
    return sumexp, _pick(lg, idx), lg.sum(dim=-1)


def xent_bwd_reference(lg, idx, gmax, gse, gpk, gsl):
    """Plain PyTorch: dlg in lg's dtype, the reference's op order, computed
    in fp32 (float64 for float64 input)."""
    acc = _acc(lg)
    lg32 = lg.to(acc)
    cols = torch.arange(lg.shape[1], device=lg.device)
    d = gse.to(acc)[:, None] * torch.exp(lg32 - gmax.to(acc)[:, None])
    hit = cols[None, :] == idx.long()[:, None]
    d = d + torch.where(hit, gpk.to(acc)[:, None], torch.zeros((), dtype=acc, device=lg.device))
    d = d + gsl.to(acc)[:, None]
    return d.to(lg.dtype)


def _check(what, lg, idx, rows):
    """The kernels' contract; returns (lg, idx, vec) ready to launch."""
    require_hopper(lg)
    if lg.dim() != 2 or lg.shape[1] < 1:
        raise ValueError(f"{what}: lg must be (N, Vs) with Vs >= 1, got {tuple(lg.shape)}")
    if lg.dtype not in _DTYPES:
        raise ValueError(f"{what}: lg dtype {lg.dtype} not in {_DTYPES}")
    N, Vs = lg.shape
    if N >= 2 ** 31 or Vs >= 2 ** 31:
        raise ValueError(f"{what}: {N} rows of {Vs} columns exceed the kernel's int32 grid")
    if idx.shape != (N,) or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{what}: idx must be ({N},) int32/int64, got {tuple(idx.shape)} {idx.dtype}")
    for name, t in rows.items():
        if t.shape != (N,):
            raise ValueError(f"{what}: {name} must be ({N},), got {tuple(t.shape)}")
    for name, t in (("idx", idx), *rows.items()):
        if t.device != lg.device:
            raise ValueError(f"{what}: {name} on {t.device}, lg on {lg.device}")
    lg = lg.contiguous()
    vec = int(Vs % 4 == 0 and lg.data_ptr() % 16 == 0)
    return lg, idx.to(torch.int64).contiguous(), vec


def _rows_bytes(N, idx):
    # idx and gmax read once a row; the three fp32 sums (or cotangents) a row
    return N * (idx.element_size() + 4) + 3 * N * 4


def xent_fwd_cost(lg, idx, gmax):
    """(flops, bytes) of the forward: the logits read once; exp, two
    adds and a compare an element, counted as fp32 operations."""
    N, Vs = lg.shape
    return 4 * N * Vs, N * Vs * lg.element_size() + _rows_bytes(N, idx)


def xent_bwd_cost(lg, idx, gmax, gse, gpk, gsl):
    """(flops, bytes) of the backward: the logits read and dlogits
    written once; five fp32 operations an element."""
    N, Vs = lg.shape
    return 5 * N * Vs, 2 * N * Vs * lg.element_size() + _rows_bytes(N, idx)


@costed("fused_xent_fwd", xent_fwd_cost)
def xent_fwd(lg, idx, gmax):
    """(sumexp, picked, sumlg), (N,) fp32 each; see the module docstring."""
    if lg.device.type == "cpu":
        return xent_parts_reference(lg, idx, gmax)
    gmax = gmax.float().contiguous()
    lg, idx, vec = _check("xent_fwd", lg, idx, {"gmax": gmax})
    N, Vs = lg.shape
    outs = tuple(torch.empty(N, dtype=torch.float32, device=lg.device) for _ in range(3))
    if N == 0:
        return outs
    fn = _build.load("cross_entropy", "vtt_xent_fwd", _ARGTYPES["vtt_xent_fwd"])
    rc = fn(lg.data_ptr(), idx.data_ptr(), gmax.data_ptr(), *(o.data_ptr() for o in outs), N, Vs,
            int(lg.dtype == torch.bfloat16), vec, torch.cuda.current_stream(lg.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"xent_fwd launch failed: cudaError {rc}")
    LAUNCHES["fused_xent_fwd"] += 1
    return outs


@costed("fused_xent_bwd", xent_bwd_cost)
def xent_bwd(lg, idx, gmax, gse, gpk, gsl):
    """dlg (N, Vs) in lg's dtype; see the module docstring."""
    if lg.device.type == "cpu":
        return xent_bwd_reference(lg, idx, gmax, gse, gpk, gsl)
    # cotangents may arrive broadcast (stride 0) from the mean's backward
    gmax, gse, gpk, gsl = (t.float().contiguous() for t in (gmax, gse, gpk, gsl))
    lg, idx, vec = _check("xent_bwd", lg, idx, dict(gmax=gmax, gse=gse, gpk=gpk, gsl=gsl))
    N, Vs = lg.shape
    dlg = torch.empty_like(lg)
    if N == 0:
        return dlg
    fn = _build.load("cross_entropy", "vtt_xent_bwd", _ARGTYPES["vtt_xent_bwd"])
    rc = fn(lg.data_ptr(), idx.data_ptr(), gmax.data_ptr(), gse.data_ptr(), gpk.data_ptr(),
            gsl.data_ptr(), dlg.data_ptr(), N, Vs, int(lg.dtype == torch.bfloat16),
            int(vec and dlg.data_ptr() % 16 == 0),
            torch.cuda.current_stream(lg.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"xent_bwd launch failed: cudaError {rc}")
    LAUNCHES["fused_xent_bwd"] += 1
    return dlg


# The kernels run as two ``torch.library`` custom ops, the backward
# registered as the forward's autograd formula (the reference's
# ``fused_xent_parts`` custom_vjp), so a tracer (``pipe.graph_split``) or a
# dispatch mode sees each launch as one node.
@torch.library.custom_op("vtt::xent_parts", mutates_args=())
def xent_parts_op(lg: torch.Tensor, idx: torch.Tensor,
                  gmax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sumexp, picked, sumlg): :func:`xent_fwd`."""
    return tuple(xent_fwd(lg, idx, gmax))


@xent_parts_op.register_fake
def _(lg, idx, gmax):
    return tuple(lg.new_empty(lg.shape[0], dtype=torch.float32) for _ in range(3))


@torch.library.custom_op("vtt::xent_bwd", mutates_args=())
def xent_bwd_op(lg: torch.Tensor, idx: torch.Tensor, gmax: torch.Tensor, gse: torch.Tensor,
                gpk: torch.Tensor, gsl: torch.Tensor) -> torch.Tensor:
    """dlg: :func:`xent_bwd`."""
    return xent_bwd(lg, idx, gmax, gse, gpk, gsl)


@xent_bwd_op.register_fake
def _(lg, idx, gmax, gse, gpk, gsl):
    return torch.empty_like(lg)


def _xent_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _xent_backward(ctx, gse, gpk, gsl):
    """Residuals (lg, idx, gmax); no gradient for idx or gmax, and the
    cotangent of an unused output is zeros."""
    lg, idx, gmax = ctx.saved_tensors
    gs = [torch.zeros(lg.shape[0], dtype=torch.float32, device=lg.device) if g is None else g
          for g in (gse, gpk, gsl)]
    return xent_bwd_op(lg, idx, gmax, *gs), None, None


xent_parts_op.register_autograd(_xent_backward, setup_context=_xent_setup)


def fused_xent_parts(lg: torch.Tensor, idx: torch.Tensor, gmax: torch.Tensor):
    """(sumexp, picked, sumlg) over the vocab dim of (N, Vs) ``lg`` in one
    pass; ``idx`` (N,) integer gold columns, ``gmax`` (N,) fp32 row max
    (treated as a constant)."""
    return xent_parts_op(lg, idx, gmax.detach())
