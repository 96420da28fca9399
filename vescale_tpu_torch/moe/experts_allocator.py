"""ExpertsAllocator — which expert-parallel ranks hold which experts.

The port of ``vescale_tpu/moe/experts_allocator.py`` (numpy only, copied):
an allocation is a ragged unit vector over the ep mesh dim, experts per
rank, which ``MoEParamBuffer`` turns into a ``RaggedShard`` of the stacked
expert parameters.  A new allocation is a ragged -> ragged redistribute
(all-to-all-v).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["ExpertsAllocator", "BasicExpertsAllocator"]


class ExpertsAllocator:
    """Base allocator: uniform static assignment."""

    def __init__(self, num_experts: int, ep_size: int):
        if num_experts % ep_size != 0 and ep_size > num_experts:
            raise ValueError(f"{num_experts} experts over {ep_size} ranks")
        self.num_experts = num_experts
        self.ep_size = ep_size

    def allocate(self, load: Optional[Sequence[float]] = None) -> Tuple[int, ...]:
        """experts-per-rank units (sum == num_experts)."""
        base = self.num_experts // self.ep_size
        rem = self.num_experts % self.ep_size
        return tuple(base + (1 if r < rem else 0) for r in range(self.ep_size))


class BasicExpertsAllocator(ExpertsAllocator):
    """Load-aware allocator: given per-expert load (token counts or their
    EMA), greedily assigns contiguous expert ranges so that each rank's
    total load is balanced; lightly loaded experts pack more to a rank."""

    def allocate(self, load: Optional[Sequence[float]] = None) -> Tuple[int, ...]:
        if load is None:
            return super().allocate()
        load = np.asarray(load, dtype=np.float64)
        if load.shape != (self.num_experts,):
            raise ValueError(f"load must have shape ({self.num_experts},)")
        load = np.maximum(load, 1e-9)
        target = load.sum() / self.ep_size
        units = [0] * self.ep_size
        r, acc = 0, 0.0
        for e in range(self.num_experts):
            # keep at least (remaining ranks - 1) experts for later ranks
            remaining_experts = self.num_experts - e
            remaining_ranks = self.ep_size - r
            if r < self.ep_size - 1 and acc >= target * (r + 1) and remaining_experts > remaining_ranks - 1:
                if units[r] > 0:
                    r += 1
            units[r] += 1
            acc += load[e]
        # no empty rank when there are at least as many experts as ranks
        if self.num_experts >= self.ep_size:
            for r in range(self.ep_size):
                if units[r] == 0:
                    donor = int(np.argmax(units))
                    units[donor] -= 1
                    units[r] += 1
        if sum(units) != self.num_experts:
            raise AssertionError(f"units {units} do not sum to {self.num_experts}")
        return tuple(units)
