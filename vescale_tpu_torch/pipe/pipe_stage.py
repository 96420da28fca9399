"""Stage-split math — a copy of ``vescale_tpu/pipe/pipe_stage.py::_cuts_by_weight``.

The serve engine cuts its layer stack into ``num_stages`` contiguous
segments with this greedy, so a stage count splits the layers exactly as
the JAX engine (and its pipeline engine) would.
"""

from __future__ import annotations

from typing import List

__all__ = ["_cuts_by_weight"]


def _cuts_by_weight(weights: List[float], n: int) -> List[int]:
    """Contiguous partition of unit weights into n groups balancing totals
    (same greedy as the reference's params/uniform split)."""
    total = sum(weights)
    target = total / n
    cuts = []
    acc = 0.0
    for k, w in enumerate(weights):
        if len(cuts) < n - 1 and acc >= target * (len(cuts) + 1):
            cuts.append(k)
        acc += w
    while len(cuts) < n - 1:
        cuts.append(len(weights))
    # repair pass: cuts must be strictly increasing with >= 1 unit per group
    # (weight concentrated at the end can otherwise produce empty groups)
    for i in range(n - 1):
        lo = (cuts[i - 1] if i > 0 else 0) + 1
        hi = len(weights) - (n - 1 - i)
        cuts[i] = min(max(cuts[i], lo), hi)
    return cuts
