"""Mesh collectives over the process groups of a live ``DeviceMesh``.

The port of the mesh collectives of ``vescale_tpu/collectives.py``.  The
reference takes and returns *stacked* global arrays (dim 0 carries each
rank's operand) because one controller holds every rank's data; here each
rank passes its own operand and gets its own result, the calling
convention of the legacy veScale ``_collective_utils.py``.  So the port's
rank ``r`` computes slice ``r`` of the reference's stacked result (or the
whole result where the reference returns an unstacked one).

One code path serves NCCL ("cuda" meshes) and gloo ("cpu" meshes): the
tensors live on the mesh's device and the group's backend carries them.
Ragged and uneven pieces are padded to one chunk size, because both
backends want equal-sized buffers, and unpadded after.

``CALLS`` counts every collective issued, keyed by ``"<backend>.<op>"``.

Not here yet: the quantized collectives (``q_*``, ``all_reduce_q``,
``reduce_scatter_q``) come with the data-parallel item, and the cost model
with the planner.
"""

from __future__ import annotations

import warnings
from collections import Counter
from typing import List, Sequence

import torch
import torch.distributed as dist

from .mesh import DeviceMesh

__all__ = [
    "CALLS",
    "reset_calls",
    "mesh_all_reduce",
    "mesh_all_gather",
    "mesh_reduce_scatter",
    "mesh_all_to_all",
    "mesh_broadcast",
    "mesh_scatter",
    "mesh_ppermute",
]

CALLS: Counter = Counter()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def reset_calls() -> None:
    CALLS.clear()


def _count(group, op: str) -> None:
    CALLS[f"{dist.get_backend(group)}.{op}"] += 1


def _quiet(fn, *args, **kwargs):
    """Call a collective whose name newer torch marks deprecated (the
    replacement does not exist on every torch the port runs on)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kwargs)


# ------------------------------------------------------------ primitives
def all_reduce(t: torch.Tensor, group, reduce_op: str = "sum") -> torch.Tensor:
    """The reduction of every member's ``t`` (a new tensor).  ``avg`` is a
    sum divided by the group size, as ``jax.lax.pmean`` computes it."""
    out = t.contiguous().clone()
    _count(group, "all_reduce")
    dist.all_reduce(out, op=_OPS["sum" if reduce_op == "avg" else reduce_op], group=group)
    if reduce_op == "avg":
        out = out / dist.get_world_size(group)
    return out


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every member's ``t`` (equal shapes) concatenated along dim 0, in
    group-rank order."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    _count(group, "all_gather")
    _quiet(dist.all_gather_into_tensor, out, t, group=group)
    return out


def reduce_scatter(t: torch.Tensor, group, reduce_op: str = "sum") -> torch.Tensor:
    """Dim 0 of ``t`` cut into group-size equal chunks; this member gets
    the reduction of every member's chunk at its own group rank."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 of {tuple(t.shape)} not divisible by {n}")
    out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
    _count(group, "reduce_scatter")
    _quiet(dist.reduce_scatter_tensor, out, t,
           op=_OPS["sum" if reduce_op == "avg" else reduce_op], group=group)
    if reduce_op == "avg":
        out = out / n
    return out


def all_to_all_v(send: torch.Tensor, send_splits: Sequence[int], recv_splits: Sequence[int],
                 group) -> torch.Tensor:
    """A flat all-to-all with per-member split sizes (all-to-all-v):
    ``send`` is the concatenation of the pieces for each member in group
    order; the result concatenates the pieces received from each."""
    out = send.new_empty((int(sum(recv_splits)),))
    _count(group, "all_to_all")
    dist.all_to_all_single(out, send.contiguous(), output_split_sizes=list(recv_splits),
                           input_split_sizes=list(send_splits), group=group)
    return out


def pad_dim0(t: torch.Tensor, size: int) -> torch.Tensor:
    if t.shape[0] == size:
        return t
    pad = t.new_zeros((size - t.shape[0],) + tuple(t.shape[1:]))
    return torch.cat([t, pad])


def gather_v(t: torch.Tensor, sizes: Sequence[int], group) -> torch.Tensor:
    """All-gather-v along dim 0: member ``j`` holds ``sizes[j]`` rows; pad
    each to the largest, all-gather, unpad."""
    pad = max(sizes) if sizes else 0
    buf = all_gather(pad_dim0(t, pad), group)
    if all(s == pad for s in sizes):
        return buf
    return torch.cat([buf.narrow(0, j * pad, s) for j, s in enumerate(sizes)])


# ---------------------------------------------------- mesh collectives
def mesh_all_reduce(tensor: torch.Tensor, mesh: DeviceMesh, reduce_op: str = "sum",
                    mesh_dim=0) -> torch.Tensor:
    """The reduction of every rank's ``tensor`` along ``mesh_dim``
    (_collective_utils.py:344)."""
    return all_reduce(tensor, mesh.get_group(mesh_dim), reduce_op)


def mesh_all_gather(tensor: torch.Tensor, mesh: DeviceMesh, mesh_dim=0,
                    gather_dim: int = 0) -> torch.Tensor:
    """Every rank's ``tensor`` (equal shapes) concatenated along
    ``gather_dim`` in mesh order (_collective_utils.py:315)."""
    out = all_gather(tensor.movedim(gather_dim, 0), mesh.get_group(mesh_dim))
    return out.movedim(0, gather_dim)


def mesh_reduce_scatter(tensor: torch.Tensor, mesh: DeviceMesh, reduce_op: str = "sum",
                        scatter_dim: int = 0, mesh_dim=0) -> torch.Tensor:
    """Each rank contributes a full tensor; rank ``j`` along ``mesh_dim``
    gets chunk ``j`` (of ``scatter_dim``, evenly divided) of the reduction
    (_collective_utils.py:288).  max/min reduce whole and slice, as the
    reference does."""
    g = mesh.get_group(mesh_dim)
    n = mesh.size(mesh_dim)
    if reduce_op in ("sum", "avg"):
        return reduce_scatter(tensor.movedim(scatter_dim, 0), g, reduce_op).movedim(0, scatter_dim)
    full = all_reduce(tensor, g, reduce_op)
    chunk = full.shape[scatter_dim] // n
    idx = mesh.get_coordinate()[mesh._dim_index(mesh_dim)]
    return full.narrow(scatter_dim, idx * chunk, chunk).contiguous()


def mesh_all_to_all(tensor: torch.Tensor, mesh: DeviceMesh, mesh_dim=0, split_dim: int = 0,
                    concat_dim: int = 0) -> torch.Tensor:
    """Each rank splits ``tensor`` evenly along ``split_dim``, sends chunk
    ``j`` to rank ``j`` and concatenates what it receives along
    ``concat_dim`` (_collective_utils.py:119)."""
    g = mesh.get_group(mesh_dim)
    n = mesh.size(mesh_dim)
    if tensor.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(tensor.shape)} not divisible by {n}")
    chunks = [c.contiguous().reshape(-1) for c in torch.chunk(tensor, n, dim=split_dim)]
    sizes = [c.numel() for c in chunks]
    out = all_to_all_v(torch.cat(chunks), sizes, sizes, g)
    shape = list(tensor.shape)
    shape[split_dim] //= n
    return torch.cat([p.view(shape) for p in out.split(sizes)], dim=concat_dim)


def mesh_broadcast(tensor: torch.Tensor, mesh: DeviceMesh, mesh_dim=0,
                   src_rank: int = 0) -> torch.Tensor:
    """Rank ``src_rank``'s ``tensor`` (its index along ``mesh_dim``) on
    every rank of the dim (_collective_utils.py:237); the others pass a
    tensor of the same shape and dtype."""
    g = mesh.get_group(mesh_dim)
    out = tensor.contiguous().clone()
    _count(g, "broadcast")
    dist.broadcast(out, src=dist.get_global_rank(g, src_rank), group=g)
    return out


def _split_sizes(extent: int, n: int) -> List[int]:
    """``numpy.array_split``'s chunk sizes (the first ones one larger)."""
    q, r = divmod(extent, n)
    return [q + 1 if j < r else q for j in range(n)]


def mesh_scatter(tensor: torch.Tensor, mesh: DeviceMesh, mesh_dim=0, scatter_dim: int = 0,
                 src_rank: int = 0) -> torch.Tensor:
    """Rank ``src_rank``'s ``tensor`` cut along ``scatter_dim`` as
    ``numpy.array_split`` cuts it; rank ``j`` gets chunk ``j``
    (_collective_utils.py:50).  Every rank passes a tensor of the full
    shape; only the source's values are read."""
    g = mesh.get_group(mesh_dim)
    n = mesh.size(mesh_dim)
    sizes = _split_sizes(tensor.shape[scatter_dim], n)
    pad = max(sizes)
    moved = tensor.movedim(scatter_dim, 0)
    me = mesh.get_coordinate()[mesh._dim_index(mesh_dim)]
    out = moved.new_empty((pad,) + tuple(moved.shape[1:]))
    src = dist.get_global_rank(g, src_rank)
    pieces = None
    if me == src_rank:
        pieces = [pad_dim0(p, pad).contiguous() for p in torch.split(moved, sizes)]
    _count(g, "scatter")
    dist.scatter(out, scatter_list=pieces, src=src, group=g)
    return out.narrow(0, 0, sizes[me]).movedim(0, scatter_dim).contiguous()


def mesh_ppermute(tensor: torch.Tensor, mesh: DeviceMesh, mesh_dim=0, shift: int = 1) -> torch.Tensor:
    """Rank ``j`` sends ``tensor`` to rank ``j + shift`` (mod the dim size)
    and returns what rank ``j - shift`` sent: the ring permute of pipeline
    p2p (``batch_isend_irecv``)."""
    g = mesh.get_group(mesh_dim)
    n = mesh.size(mesh_dim)
    me = mesh.get_coordinate()[mesh._dim_index(mesh_dim)]
    send = tensor.contiguous()
    out = torch.empty_like(send)
    if shift % n == 0:
        return send.clone()
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(g, (me + shift) % n), g),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(g, (me - shift) % n), g)]
    _count(g, "ppermute")
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out
