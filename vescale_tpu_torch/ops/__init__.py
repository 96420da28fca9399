"""Tensor ops of the port: the front ends over the CUDA kernels."""

from .flash_attention import flash_attention

__all__ = ["flash_attention"]
