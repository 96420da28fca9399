"""DArray-level collective API: the port of ``vescale_tpu/api.py``
(reference legacy/vescale/dtensor/api.py:314-388: vescale_all_gather /
vescale_all_reduce / vescale_reduce_scatter).

These are placement rewrites over ``redistribute``, which runs the
collective (all-gather, all-reduce, reduce-scatter) over the mesh dims'
process groups.
"""

from __future__ import annotations

from typing import Sequence, Union

from .darray import DArray
from .placements import Replicate, Shard
from .redistribute import redistribute

__all__ = ["vescale_all_gather", "vescale_all_reduce", "vescale_reduce_scatter"]


def _dims(mesh_dims, mesh) -> list:
    if mesh_dims is None:
        return list(range(mesh.ndim))
    if isinstance(mesh_dims, (int, str)):
        mesh_dims = [mesh_dims]
    return [mesh._dim_index(d) for d in mesh_dims]


def vescale_all_gather(darr: DArray, mesh_dims=None) -> DArray:
    """Shard -> Replicate on the given mesh dims (api.py:314)."""
    new = list(darr.placements)
    for i in _dims(mesh_dims, darr.mesh):
        if new[i].is_shard() or new[i].is_ragged_shard() or new[i].is_interleaved_shard():
            new[i] = Replicate()
    return redistribute(darr, new)


def vescale_all_reduce(darr: DArray, reduce_op: str = "sum", mesh_dims=None) -> DArray:
    """Partial -> Replicate on the given mesh dims (api.py:344).
    ``reduce_op`` must match the Partial placement's op (the reduction is a
    property of how the operands were produced, not of this call)."""
    new = list(darr.placements)
    for i in _dims(mesh_dims, darr.mesh):
        if new[i].is_partial():
            if new[i].reduce_op != reduce_op:
                raise ValueError(
                    f"reduce_op {reduce_op!r} != Partial placement's {new[i].reduce_op!r} on mesh dim {i}"
                )
            new[i] = Replicate()
    return redistribute(darr, new)


def vescale_reduce_scatter(darr: DArray, scatter_dim: Union[int, Sequence[int]] = 0, reduce_op: str = "sum", mesh_dims=None) -> DArray:
    """Partial -> Shard(scatter_dim) on the given mesh dims (api.py:388)."""
    dims = _dims(mesh_dims, darr.mesh)
    sdims = [scatter_dim] * len(dims) if isinstance(scatter_dim, int) else list(scatter_dim)
    if len(sdims) != len(dims):
        raise ValueError(f"{len(sdims)} scatter dims for {len(dims)} mesh dims")
    new = list(darr.placements)
    for i, sd in zip(dims, sdims):
        if new[i].is_partial():
            if new[i].reduce_op != reduce_op:
                raise ValueError(
                    f"reduce_op {reduce_op!r} != Partial placement's {new[i].reduce_op!r} on mesh dim {i}"
                )
            new[i] = Shard(sd)
    return redistribute(darr, new)
