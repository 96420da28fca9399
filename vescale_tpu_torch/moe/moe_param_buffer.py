"""MoEParamBuffer — expert parameters as ragged pieces over the ep mesh dim.

The port of ``vescale_tpu/moe/moe_param_buffer.py``: each expert leaf (E,
...) is flattened expert-major into one ``DArray`` with a ``RaggedShard``
whose units are experts-per-rank times the leaf's per-expert size, so rank
r holds its experts' rows as one flat piece.  ``gather_params`` is the
all-gather-v back to full (E, ...) tensors; ``refresh`` moves to a new
expert -> rank assignment by a ragged -> ragged ``redistribute`` of every
leaf (an all-to-all-v), and ``MoEOptimizer.refresh`` moves the optimizer's
moments the same way.  With ``tp_dim`` each expert's flattened rows are
further split evenly over that dim inside its ragged cell
(``StridedRaggedShard`` over ep, ``Shard(0)`` over tp).
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

from ..darray import DArray, distribute_tensor
from ..mesh import DeviceMesh
from ..parallel.ddp import tree_map
from ..placements import RaggedShard, Replicate, Shard, StridedRaggedShard
from ..redistribute import redistribute

__all__ = ["MoEParamBuffer"]


class MoEParamBuffer:
    """A nested dict of expert parameters (every leaf's leading dim is E)
    held as ragged ``DArray``s over ``ep_dim``, ``units`` experts a rank."""

    def __init__(self, mesh: DeviceMesh, ep_dim: str, num_experts: int, units: Sequence[int],
                 tp_dim: Optional[str] = None):
        self.mesh = mesh
        self.ep_dim = ep_dim
        self.ep_index = mesh._dim_index(ep_dim)
        self.tp_dim = tp_dim
        self.tp_index = mesh._dim_index(tp_dim) if tp_dim is not None else None
        self.num_experts = num_experts
        self.units = tuple(int(u) for u in units)
        if sum(self.units) != num_experts:
            raise ValueError(f"units {units} != num_experts {num_experts}")

    def _placement(self, leaf_shape) -> List:
        per_expert = math.prod(leaf_shape[1:]) if len(leaf_shape) > 1 else 1
        units = tuple(u * per_expert for u in self.units)
        placements = [Replicate()] * self.mesh.ndim
        dims = tuple(range(len(leaf_shape)))
        if self.tp_index is None:
            placements[self.ep_index] = RaggedShard(dims, units)
        else:
            s = self.mesh.shape[self.tp_index]
            placements[self.ep_index] = StridedRaggedShard(dims, units, split_factor=s)
            placements[self.tp_index] = Shard(0)
        return placements

    # ----------------------------------------------------------- pack/own
    def shard_params(self, expert_params) -> Any:
        """A nested dict of (E, ...) tensors -> the same of ragged
        ``DArray``s (this rank's pieces)."""
        return tree_map(lambda leaf: distribute_tensor(leaf, self.mesh,
                                                       self._placement(tuple(leaf.shape))),
                        expert_params)

    def gather_params(self, sharded) -> Any:
        """Ragged ``DArray``s -> full (E, ...) tensors (all-gather-v)."""
        return tree_map(lambda d: d.full_tensor().reshape(d.shape), sharded)

    def local_experts(self, rank: int) -> Tuple[int, int]:
        """(first_expert, count) owned by flat mesh rank ``rank``."""
        r = self.mesh.coordinate_of_rank(rank)[self.ep_index]
        return sum(self.units[:r]), self.units[r]

    # ------------------------------------------------------------ refresh
    def refresh(self, sharded, new_units: Sequence[int]) -> Tuple["MoEParamBuffer", Any]:
        """The buffer of a new expert -> rank assignment and every leaf
        moved to it (ragged -> ragged redistribute: an all-to-all-v)."""
        new_buf = MoEParamBuffer(self.mesh, self.ep_dim, self.num_experts, new_units,
                                 tp_dim=self.tp_dim)
        return new_buf, tree_map(lambda d: new_buf.move(d), sharded)

    def move(self, d: DArray) -> DArray:
        """``d`` (a leaf laid out by any buffer of this mesh) laid out as
        this buffer lays out a leaf of its shape."""
        return redistribute(d, self._placement(d.shape))
