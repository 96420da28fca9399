"""Optimizers: ``AdamWLowmem``, ``BasicOptimizer``, ``clip_grad_norm_fp32``,
``found_inf``.

The single-device part of ``vescale_tpu/parallel/optimizer.py``, written
from scratch on ``torch.optim`` (the reference is an optax chain):

  * ``AdamWLowmem`` — ``adamw_lowmem``: ``scale_by_adam_lowmem`` (moments
    kept in ``state_dtype``, bf16 by default, all arithmetic in fp32; the
    moment update is ``kernels.fused_adamw_update``, one launch for every
    leaf on the card), then ``add_decayed_weights(weight_decay)``, then
    ``scale_by_learning_rate(lr)``, then ``apply_updates``, in optax's op
    order: ``u + wd * p``, ``(-lr) * u``, ``(p + u)`` in p's dtype.  The
    parameters are updated in place.  Every parameter of a group takes the
    step, as every leaf of the reference's tree does: one whose ``.grad``
    is None is stepped with zero grads.
  * ``BasicOptimizer`` — an optimizer plus an optional global-norm clip.
  * ``clip_grad_norm_fp32`` and ``found_inf`` over lists of grads.

Not here yet: ``DistributedOptimizer`` (ZeRO), the loss scaler, Muon.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch

from ..kernels.fused_adamw import fused_adamw_update

__all__ = ["AdamWLowmem", "BasicOptimizer", "clip_grad_norm_fp32", "found_inf", "bias_corrections"]


def found_inf(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """Scalar bool tensor: any non-finite value in any grad (the
    reference's ``found_inf``)."""
    flags = [(~torch.isfinite(g)).any() for g in grads if g is not None]
    if not flags:
        return torch.tensor(False)
    out = flags[0]
    for f in flags[1:]:
        out = torch.logical_or(out, f)
    return out


def clip_grad_norm_fp32(grads: Sequence[torch.Tensor], max_norm: float,
                        norm_type: int = 2) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Global-norm clip in fp32 (the reference's ``clip_grad_norm_fp32``):
    the norm is taken over grads pre-scaled by the global max |g| so the
    squared sum cannot overflow fp32.  Returns (clipped grads in their own
    dtypes, total norm)."""
    grads = list(grads)
    g32 = [g.float() for g in grads]
    gmax = torch.stack([g.abs().max() for g in g32]).max()
    gmax = torch.maximum(torch.tensor(1e-30, dtype=torch.float32, device=gmax.device), gmax)
    if norm_type == 2:
        total = gmax * torch.sqrt(sum(torch.sum(torch.square(g / gmax)) for g in g32))
    else:
        total = gmax * sum(torch.sum(torch.abs(g / gmax) ** norm_type) for g in g32) ** (
            1.0 / norm_type
        )
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    return [(g * scale).to(o.dtype) for g, o in zip(g32, grads)], total


def bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    """(c1, c2) = (1 - b1**count, 1 - b2**count) computed in fp32, as the
    reference does (``parallel/optimizer.py:513-515``)."""
    n = torch.tensor(float(count), dtype=torch.float32)
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** n
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** n
    return float(c1), float(c2)


class AdamWLowmem(torch.optim.Optimizer):
    """AdamW with ``state_dtype`` moments; see the module docstring.  One
    step counter per parameter group, as optax keeps one per tree."""

    def __init__(self, params, lr: float, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-4,
                 state_dtype: torch.dtype = torch.bfloat16):
        if lr < 0 or eps < 0 or weight_decay < 0:
            raise ValueError(f"lr={lr}, eps={eps}, weight_decay={weight_decay}")
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                        state_dtype=state_dtype, step=0)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            b1, b2 = group["betas"]
            # a parameter the loss did not read has no grad; the reference
            # gives every leaf one, zeros for an unused leaf, so its moments
            # decay and weight decay applies
            # (vescale_tpu/parallel/optimizer.py:535, :557)
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            for p in params:
                st = self.state[p]
                if not st:
                    st["exp_avg"] = torch.zeros_like(p, dtype=group["state_dtype"])
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=group["state_dtype"])
            group["step"] += 1
            c1, c2 = bias_corrections(b1, b2, group["step"])
            us, ms, vs = fused_adamw_update(
                grads, [self.state[p]["exp_avg"] for p in params],
                [self.state[p]["exp_avg_sq"] for p in params], c1, c2,
                b1=b1, b2=b2, eps=group["eps"],
            )
            for p, m, v in zip(params, ms, vs):
                self.state[p]["exp_avg"], self.state[p]["exp_avg_sq"] = m, v
            # add_decayed_weights, scale_by_learning_rate, apply_updates;
            # u + wd * p promotes a low-precision u to p's dtype, as in jnp
            us = [u.to(torch.promote_types(u.dtype, p.dtype)) for u, p in zip(us, params)]
            torch._foreach_add_(us, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_mul_(us, -group["lr"])
            if all(u.dtype == p.dtype for u, p in zip(us, params)):
                torch._foreach_add_(params, us)
            else:
                for p, u in zip(params, us):
                    p.copy_(p + u)
        return loss


class BasicOptimizer:
    """An optimizer plus an optional global-norm clip of the grads before
    its step (the reference's ``BasicOptimizer``)."""

    def __init__(self, optimizer: torch.optim.Optimizer, grad_clip: Optional[float] = None):
        self.optimizer = optimizer
        self.grad_clip = grad_clip

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self):
        if self.grad_clip is not None:
            params = [p for g in self.optimizer.param_groups for p in g["params"]
                      if p.grad is not None]
            clipped, _ = clip_grad_norm_fp32([p.grad for p in params], self.grad_clip)
            for p, g in zip(params, clipped):
                p.grad = g
        self.optimizer.step()
