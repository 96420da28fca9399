"""Patched modules: the loss in module form."""

from .vp_cross_entropy import VocabParallelCrossEntropy

__all__ = ["VocabParallelCrossEntropy"]
