"""fp8 training: the delayed-scaling fp8 matmul, two ways.

The port of ``vescale_tpu/quant/fp8.py`` (the functional ``fp8_dot``) and
of the module path the JAX package's ``LlamaConfig.use_fp8`` takes
through flax's ``Fp8DirectDotGeneralOp`` (``flax/linen/fp8_ops.py``).
Each keeps its own conventions, which differ:

``fp8_dot`` (functional; ``Fp8DotState`` threads through the caller):
  * scale = ``scale_from_amax`` = fp8 max / max(history), and quantize
    *multiplies* by it (``blockscale.quantize_clip``);
  * the x and w histories roll in the forward ([0] the newest); the g
    history rolls in the backward from the raw cotangent's amax;
  * the products run on the fp8 operands with fp32 output, then are
    multiplied by 1 / (scale · scale); dx and dw come back in their
    primal's dtype (fp32 masters get fp32 dw);
  * the state's "gradient" is the new state: the three history tensors
    take ``requires_grad``, the backward returns x's and w's histories as
    they came and g's rolled one as their gradients, and
    :func:`merge_fp8_state` takes x and w from the forward's state and g
    from those gradients, non-finite values replaced by 0.

``Fp8DirectDotGeneralOp`` (the module; six state leaves, flax's names):
  * ``input_amax_history``, ``kernel_amax_history`` and
    ``output_grad_amax_history`` (1024,) fp32, zeros, and ``input_scale``,
    ``kernel_scale`` and ``output_grad_scale`` (1,) fp32, ones;
  * scale = amax / fp8 max (as 1 / (fp8 max / amax)), the new scale from
    the *pre-step* history (the old one kept while amax is 0 or not
    finite), and quantize *divides* by it in the compute dtype (the
    kernel's); a history rolls by ``roll(-1)`` and then sets ``[0]``;
  * forward: the e4m3 × e4m3 product to x's dtype, then times
    (input_scale · kernel_scale) cast to x's dtype; backward: g quantized
    to e5m2 with the updated grad scale, dx = q_g · q_kᵀ and dk = q_xᵀ ·
    q_g, each to x's dtype and then dequantized the same way; no gradient
    flows through a quantize;
  * all six leaves change only through the backward's "gradient" (the
    buffers take ``requires_grad``; ``train.make_train_step`` overwrites
    them with their ``.grad`` under a finite guard), so a forward-only
    call leaves the state as it was.

The products: on a CUDA tensor each runs through ``torch._scaled_mm`` on
Hopper's fp8 tensor cores with unit scales (the scales are applied
afterwards, in the reference's order, so the fp32 sum is rounded once to
the output dtype before the dequantize).  ``_scaled_mm`` wants both
operands' dims multiples of 16, the second operand column-major and no
e5m2 × e5m2; a shape it refuses raises, nothing falls back.
``SCALED_MM_CALLS`` counts the calls by operand formats.  On a CPU tensor
each product is the plain upcast to fp32 and matmul, then the cast.  The
quantize passes (amax, scale, clip, cast) are plain torch on both.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, NamedTuple

import torch
from torch import nn

from .blockscale import quantize_clip, scale_from_amax

__all__ = [
    "E4M3_MAX",
    "E5M2_MAX",
    "Fp8TensorState",
    "Fp8DotState",
    "init_fp8_dot_state",
    "fp8_dot",
    "fp8_state_grads",
    "merge_fp8_state",
    "OWG",
    "FP8_LEAVES",
    "AMAX_HISTORY_LEN",
    "Fp8DirectDotGeneralOp",
    "owg_buffers",
    "SCALED_MM_CALLS",
    "fp8_matmul",
]

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2
E4M3_MAX = float(torch.finfo(E4M3).max)  # 448
E5M2_MAX = float(torch.finfo(E5M2).max)  # 57344

# "<lhs>x<rhs>" operand formats -> _scaled_mm calls
SCALED_MM_CALLS: Counter = Counter()
_FORMAT = {E4M3: "e4m3", E5M2: "e5m2"}


def fp8_matmul(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` of two fp8 matrices, the exact fp32 sum rounded once to
    ``out_dtype``: ``torch._scaled_mm`` with unit scales on a CUDA tensor
    (``b`` made column-major; dims must be multiples of 16, and e5m2 ×
    e5m2 is refused), the plain upcast-and-matmul on a CPU one."""
    if a.device.type == "cpu":
        return (a.to(torch.float32) @ b.to(torch.float32)).to(out_dtype)
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2 or m % 16 or k % 16 or n % 16:
        raise ValueError(f"fp8 matmul: ({m}, {k}) @ ({k2}, {n}) needs matching inner dims, "
                         "each a multiple of 16 (torch._scaled_mm)")
    if a.dtype == E5M2 and b.dtype == E5M2:
        raise ValueError("fp8 matmul: torch._scaled_mm refuses e5m2 x e5m2")
    one = torch.ones((), dtype=torch.float32, device=a.device)
    out = torch._scaled_mm(a.contiguous(), b.t().contiguous().t(), scale_a=one, scale_b=one,
                           out_dtype=out_dtype)
    SCALED_MM_CALLS[f"{_FORMAT[a.dtype]}x{_FORMAT[b.dtype]}"] += 1
    return out


# ----------------------------------------------------------- fp8_dot
class Fp8TensorState(NamedTuple):
    """Delayed-scaling state of one tensor slot (x, w or g)."""

    amax_history: torch.Tensor  # (H,) fp32, rolling; [0] is the newest


class Fp8DotState(NamedTuple):
    x: Fp8TensorState
    w: Fp8TensorState
    g: Fp8TensorState


def init_fp8_dot_state(history_len: int = 16, device=None) -> Fp8DotState:
    """Three zero histories of ``history_len`` fp32 values (``device``
    default: the CPU), each taking ``requires_grad`` so that the
    backward's new g state arrives as their gradient."""

    def one():
        return Fp8TensorState(torch.zeros((history_len,), dtype=torch.float32, device=device,
                                          requires_grad=True))

    return Fp8DotState(one(), one(), one())


def _delayed_scale(hist: torch.Tensor, fp8_max: float) -> torch.Tensor:
    """fp8 max / max(history); an all-zero history gives 1.0."""
    return scale_from_amax(hist.detach().amax(), fp8_max)


def _roll(hist: torch.Tensor, amax_now: torch.Tensor) -> torch.Tensor:
    """The history with ``amax_now`` pushed in front (a non-finite amax
    repeats the newest entry instead)."""
    hist = hist.detach()
    amax_now = torch.where(torch.isfinite(amax_now), amax_now, hist[0])
    return torch.cat([amax_now.reshape(1), hist[:-1]])


def _amax(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.float32).abs().amax()


class _Fp8DotCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w, hx, hw, hg):
        sx, sw = _delayed_scale(hx, E4M3_MAX), _delayed_scale(hw, E4M3_MAX)
        qx = quantize_clip(x2, sx, E4M3, E4M3_MAX)
        qw = quantize_clip(w, sw, E4M3, E4M3_MAX)
        y = fp8_matmul(qx, qw, torch.float32) * (1.0 / (sx * sw))
        ctx.save_for_backward(qx, qw, sx, sw, hx, hw, hg)
        ctx.dtypes = (x2.dtype, w.dtype)
        return y.to(x2.dtype)

    @staticmethod
    def backward(ctx, dy):
        qx, qw, sx, sw, hx, hw, hg = ctx.saved_tensors
        x_dtype, w_dtype = ctx.dtypes
        sg = _delayed_scale(hg, E5M2_MAX)
        qg = quantize_clip(dy, sg, E5M2, E5M2_MAX)
        dx = fp8_matmul(qg, qw.t(), torch.float32) * (1.0 / (sg * sw))
        dw = fp8_matmul(qx.t(), qg, torch.float32) * (1.0 / (sx * sg))
        g_new = _roll(hg, _amax(dy))
        # each grad in its primal's dtype: fp32 masters keep an fp32 dw
        return (dx.to(x_dtype), dw.to(w_dtype), hx.detach().clone(), hw.detach().clone(),
                g_new)


def fp8_dot(x: torch.Tensor, w: torch.Tensor, state: Fp8DotState):
    """``x @ w`` through delayed-scaling fp8 quantization.  Returns ``(y,
    state_after_forward)``: x's and w's histories rolled with this call's
    amax values.  g's new history arrives as the gradient of
    ``state.g.amax_history`` (:func:`fp8_state_grads`,
    :func:`merge_fp8_state`).  ``x``: (..., K), flattened to 2-D for the
    product; ``w``: (K, N)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = _Fp8DotCore.apply(x2, w, state.x.amax_history, state.w.amax_history,
                          state.g.amax_history)
    new_state = Fp8DotState(Fp8TensorState(_roll(state.x.amax_history, _amax(x2))),
                            Fp8TensorState(_roll(state.w.amax_history, _amax(w))), state.g)
    return y.reshape(*lead, w.shape[-1]), new_state


def fp8_state_grads(state: Fp8DotState) -> Fp8DotState:
    """The gradients of ``state``'s histories after a backward, as an
    ``Fp8DotState`` (a history with no gradient stands for itself)."""
    return Fp8DotState(*(Fp8TensorState(t.amax_history.grad if t.amax_history.grad is not None
                                         else t.amax_history.detach()) for t in state))


def merge_fp8_state(state_fwd, state_grads):
    """The next state of a tree (dict, list or tuple) of ``Fp8DotState``s:
    x and w from the forward's state, g from the gradients', non-finite
    values replaced by 0 so that an overflow step cannot poison the
    history.  The result's histories take ``requires_grad`` again."""
    if isinstance(state_fwd, Fp8DotState):
        g = state_grads.g.amax_history.detach()
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        return Fp8DotState(*(Fp8TensorState(h.detach().clone().requires_grad_(True))
                             for h in (state_fwd.x.amax_history, state_fwd.w.amax_history, g)))
    if isinstance(state_fwd, dict):
        return {k: merge_fp8_state(v, state_grads[k]) for k, v in state_fwd.items()}
    return type(state_fwd)(merge_fp8_state(a, b) for a, b in zip(state_fwd, state_grads))


# ------------------------------------------- the module path (flax's op)
OWG = "_overwrite_with_gradient"  # flax's collection name
AMAX_HISTORY_LEN = 1024
FP8_LEAVES = ("input_amax_history", "input_scale", "kernel_amax_history", "kernel_scale",
              "output_grad_amax_history", "output_grad_scale")


def _compute_scale(amax, scale, fp8_max: float):
    """flax ``compute_scale``: 1 / (fp8 max / amax), the previous scale
    kept where amax is 0 or not finite."""
    prev = 1.0 / scale
    sf = torch.full_like(amax, fp8_max) / amax  # IEEE, as XLA divides
    sf = torch.where(amax > 0.0, sf, prev)
    sf = torch.where(torch.isfinite(amax), sf, prev)
    return 1.0 / sf


def _update_meta(x, fp8_max: float, scale, hist):
    """flax ``update_fp8_meta``: (the new scale from the pre-step history,
    the history rolled by -1 with this call's amax at [0])."""
    new_scale = _compute_scale(hist.amax(dim=0), scale, fp8_max)
    amax = x.abs().amax().to(hist.dtype)
    new_hist = torch.roll(hist, -1, 0)
    new_hist[0] = amax
    return new_scale, new_hist


def _flax_quantize(x, q_dtype, fp8_max: float, scale, compute_dtype):
    """flax ``quantize``: x / scale in the compute dtype, clipped to ±fp8
    max, cast."""
    scaled = x / scale.to(compute_dtype)
    return torch.clamp(scaled, -fp8_max, fp8_max).to(q_dtype)


class _Fp8DirectDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, k, in_hist, in_scale, k_hist, k_scale, g_hist, g_scale):
        comp = k.dtype
        s_in, h_in = _update_meta(x2, E4M3_MAX, in_scale.detach(), in_hist.detach())
        s_k, h_k = _update_meta(k, E4M3_MAX, k_scale.detach(), k_hist.detach())
        qx = _flax_quantize(x2, E4M3, E4M3_MAX, s_in, comp)
        qk = _flax_quantize(k, E4M3, E4M3_MAX, s_k, comp)
        y = fp8_matmul(qx, qk, x2.dtype) * (s_in * s_k).to(x2.dtype)
        ctx.save_for_backward(qx, qk, s_in, h_in, s_k, h_k, g_scale.detach(), g_hist.detach())
        return y

    @staticmethod
    def backward(ctx, gy):
        qx, qk, s_in, h_in, s_k, h_k, g_scale, g_hist = ctx.saved_tensors
        dt = gy.dtype
        s_g, h_g = _update_meta(gy, E5M2_MAX, g_scale, g_hist)
        qg = _flax_quantize(gy, E5M2, E5M2_MAX, s_g, dt)
        dx = fp8_matmul(qg, qk.t(), dt) * (s_k * s_g).to(dt)
        dk = fp8_matmul(qx.t(), qg, dt) * (s_in * s_g).to(dt)
        return dx, dk, h_in, s_in, h_k, s_k, h_g, s_g


class Fp8DirectDotGeneralOp(nn.Module):
    """flax ``Fp8DirectDotGeneralOp``: the six delayed-scaling leaves as
    buffers (each taking ``requires_grad``: its gradient is its next
    value) and ``forward(x, kernel)``, the fp8 product of x's last dim with
    the kernel's first, in the kernel's dtype.  Under ``scan_layers`` the
    model stacks the leaves on a leading (L,) axis."""

    def __init__(self, device=None, history_len: int = AMAX_HISTORY_LEN):
        super().__init__()
        for name in FP8_LEAVES:
            shape = (history_len,) if name.endswith("history") else (1,)
            fill = torch.zeros if name.endswith("history") else torch.ones
            self.register_buffer(name, fill(shape, dtype=torch.float32, device=device)
                                 .requires_grad_(True))

    def _apply(self, fn, recurse=True):
        # Module._apply (.to, .cuda, .float) maps buffers outside no_grad
        # and swaps them for its results, so a state leaf would come back a
        # non-leaf that backward never gives a gradient.  Each leaf keeps
        # its tensor instead, as parameters do, and stays a leaf in fp32.
        leaves = {n: self._buffers[n] for n in FP8_LEAVES}
        with torch.no_grad():
            super()._apply(fn, recurse)
            for n, b in leaves.items():
                b.data = self._buffers[n].to(torch.float32)
                self._buffers[n] = b
        return self

    def forward(self, x, kernel):
        x = x.to(kernel.dtype)
        lead = x.shape[:-1]
        y = _Fp8DirectDot.apply(x.reshape(-1, x.shape[-1]), kernel,
                                *(getattr(self, n) for n in FP8_LEAVES))
        return y.reshape(*lead, kernel.shape[-1])


def owg_buffers(module: nn.Module) -> Dict[str, torch.Tensor]:
    """Every fp8 state leaf of ``module`` (an ``nn.Module``, or a wrapper
    such as a ``DModule`` holding one as ``.module``) by its dotted name,
    which is the leaf's path in flax's ``_overwrite_with_gradient``
    collection."""
    while not isinstance(module, nn.Module):
        module = module.module
    out: Dict[str, Any] = {}
    for mname, m in module.named_modules():
        if isinstance(m, Fp8DirectDotGeneralOp):
            for bname, b in m.named_buffers(recurse=False):
                out[f"{mname}.{bname}" if mname else bname] = b
    return out
