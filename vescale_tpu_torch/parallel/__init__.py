"""Optimizers of the port (single device so far)."""

from .optimizer import AdamWLowmem, BasicOptimizer, clip_grad_norm_fp32, found_inf

__all__ = ["AdamWLowmem", "BasicOptimizer", "clip_grad_norm_fp32", "found_inf"]
