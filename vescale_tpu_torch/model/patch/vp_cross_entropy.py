"""``VocabParallelCrossEntropy`` — the module form of the port's loss.

The port of ``vescale_tpu/model/patch/vp_cross_entropy.py``: an
``nn.Module`` over ``loss.vocab_parallel_cross_entropy``.  With
``mesh=None`` it runs the single-device branch, as the reference does.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ...loss import vocab_parallel_cross_entropy

__all__ = ["VocabParallelCrossEntropy"]


class VocabParallelCrossEntropy(nn.Module):
    def __init__(self, mesh: Optional[Any] = None, vocab_dim_name: Optional[str] = "tp",
                 label_smoothing: float = 0.0):
        super().__init__()
        self.mesh, self.vocab_dim_name = mesh, vocab_dim_name
        self.label_smoothing = label_smoothing

    def forward(self, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return vocab_parallel_cross_entropy(
            logits,
            targets,
            mesh=self.mesh,
            vocab_dim_name=self.vocab_dim_name if self.mesh is not None else None,
            label_smoothing=self.label_smoothing,
        )
