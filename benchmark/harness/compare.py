"""The numbers that decide ``correct``, worked out from the program's
readings and the reference's."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Tuple


def loss_gap(prog: List[float], ref: List[float]) -> float:
    """The widest relative gap between two runs' losses, step by step."""
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the
    median leaf."""
    names = list(ref) if leaves is None else list(leaves)
    floor = statistics.median(ref[n] for n in ref)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], floor) for n in names}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """(gap, leaf) of the worst leaf (:func:`leaf_gaps`)."""
    gaps = leaf_gaps(prog, ref, leaves)
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                    leaves: Optional[Iterable[str]] = None) -> float:
    """The median over the leaves of :func:`leaf_gaps`."""
    return statistics.median(leaf_gaps(prog, ref, leaves).values())


def moving_leaves(ref_grad: Dict[str, float], share: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient is above ``share`` of the median
    leaf's: the others move under Adam by round-off alone."""
    floor = share * statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g > floor]


def logit_gap(ref_logits, tokens) -> float:
    """The widest gap by which a served token's reference logit lies
    below the reference's best at its position: ``ref_logits`` (n, V)
    float32, ``tokens`` the n served ids."""
    import torch

    t = torch.as_tensor(tokens, device=ref_logits.device).long()
    best = ref_logits.max(dim=-1).values
    return float((best - ref_logits.gather(1, t[:, None])[:, 0]).max())
