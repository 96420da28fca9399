"""Matrix products of the plain references, in float32 or in the fp8 of
the control.

``mode="fp32"``: plain float32 products (the caller turns TF32 off).
``mode="fp8"``: the control, one precision below the bf16 that the
configurations compute in: every operand of a product is rounded to
float8 e4m3 with a per-tensor scale (its absolute max onto e4m3's 448)
before a float32 product, and in a backward the incoming gradient is
rounded to e5m2 the same way, as fp8 training does.
"""

from __future__ import annotations

import torch

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
_MAX = {E4M3: 448.0, E5M2: 57344.0}


def round_fp8(t: torch.Tensor, dtype=E4M3) -> torch.Tensor:
    """``t`` rounded to ``dtype`` under a per-tensor scale, back in fp32."""
    t = t.float()
    if t.numel() == 0:
        return t
    amax = t.abs().amax()
    if not bool(amax > 0):
        return t
    scale = amax / _MAX[dtype]
    return (t / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    """The identity on a value that the forward rounds to e4m3 and whose
    gradient the backward rounds to e5m2."""

    @staticmethod
    def forward(ctx, t):
        return round_fp8(t, E4M3)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, E5M2)


def operand(t: torch.Tensor, mode: str) -> torch.Tensor:
    """An operand of a product as ``mode`` computes it."""
    if mode == "fp32":
        return t.float()
    if mode == "fp8":
        return _Fp8.apply(t.float())
    raise ValueError(f"precision mode {mode!r}")


def mm(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    return operand(x, mode) @ operand(w, mode)


class NoTF32:
    """Float32 products in full float32 while the block runs."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False
