"""nanoGPT's loss, shared by the Llama training path.

The port of ``vescale_tpu/models/nanogpt.py::cross_entropy_loss``.  The
``GPT`` model itself is not ported yet (ROADMAP.md queue A, item 2).
"""

from __future__ import annotations

import torch

__all__ = ["cross_entropy_loss"]


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Token-level cross entropy, fp32: logsumexp minus the gold logit,
    mean over every token."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.mean(logz - gold)
