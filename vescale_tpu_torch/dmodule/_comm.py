"""Autograd-aware collectives of tensor and sequence parallelism, and the
placement tags activations carry between the modules of a ``DModule``.

The JAX package has no counterpart: GSPMD derives every tensor-parallel
collective and its transpose from sharding annotations.  Here each one is
a ``torch.autograd.Function`` over the counted collectives of
``collectives.py``, with its transpose as the backward (legacy veScale's
``dmodule/_hook.py`` and ``_grad_sync.py`` are the precedent):

  ``copy_to_tp``       identity forward, all-reduce backward: a Replicate
                       activation entering tensor-parallel compute, whose
                       gradient comes back Partial
  ``reduce_from_tp``   Partial -> Replicate: all-reduce forward, identity
                       backward
  ``all_gather``       Shard(d) -> Replicate; the backward is a
                       reduce-scatter when the gathered tensor feeds
                       tensor-parallel compute (its gradient is Partial) and
                       a split otherwise (its gradient is Replicate)
  ``reduce_scatter``   Partial -> Shard(d), all-gather backward
  ``split``            Replicate -> Shard(d), all-gather backward
  ``ring_permute``     rank j's tensor to rank j + shift (the pipeline's
                       stage-to-stage send), the reverse rotation backward
  ``all_to_all``       split dim s, concat dim c (Ulysses' seq <-> heads
                       reshard), the swapped all-to-all backward

Megatron's ``gather_from_sequence_parallel_region`` and
``reduce_scatter_to_sequence_parallel_region`` are ``all_gather(x, tp, 1,
True)`` and ``reduce_scatter(x, tp, 1)``.

A tensor's placement travels as a tag (``tag`` / ``tag_of``): the
placements over the mesh, and whether its gradient will be Partial over
the tensor-parallel dims (a Replicate activation inside tensor-parallel
compute).  Tags live on the tensor object, so a new tensor made from a
tagged one carries none: code between modules reads widths from its
weights, not tags.  On a mesh dim of size one every function is the
identity.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import collectives as C
from ..placements import Partial, Placement, Replicate, Shard

__all__ = [
    "TPDim",
    "tag",
    "tag_of",
    "grad_partial",
    "copy_to_tp",
    "reduce_from_tp",
    "all_gather",
    "reduce_scatter",
    "split",
    "narrow",
    "enter_tp",
    "take_piece",
    "ring_permute",
    "all_to_all",
]


class TPDim:
    """One mesh dim that splits tensors across ranks: the mesh, the dim's
    index, its size and this process's coordinate along it."""

    def __init__(self, mesh, mesh_dim):
        self.mesh = mesh
        self.index = mesh._dim_index(mesh_dim)
        self.size = mesh.size(self.index)
        self.rank = mesh.get_coordinate()[self.index] if self.size > 1 else 0

    @property
    def name(self) -> str:
        return self.mesh.dim_name(self.index)

    def placements(self, p: Placement) -> Tuple[Placement, ...]:
        """``p`` on this dim, Replicate on the others."""
        return tuple(p if i == self.index else Replicate() for i in range(self.mesh.ndim))

    def __repr__(self) -> str:
        return f"TPDim({self.name}={self.rank}/{self.size})"


# ------------------------------------------------------------------ tags
def tag(t: torch.Tensor, placements: Sequence[Placement], partial_grad: bool = False):
    """Record ``t``'s placements (and whether its gradient is Partial) on
    the tensor object; returns ``t``."""
    t._vtt_placements = tuple(placements)
    t._vtt_partial_grad = bool(partial_grad)
    return t


def tag_of(t: torch.Tensor) -> Optional[Tuple[Placement, ...]]:
    return getattr(t, "_vtt_placements", None)


def grad_partial(t: torch.Tensor) -> bool:
    return bool(getattr(t, "_vtt_partial_grad", False))


def _dim(d: int, ndim: int) -> int:
    return d % ndim


# --------------------------------------------------------- the functions
def _gather(x, tp: TPDim, d: int):
    return C.mesh_all_gather(x, tp.mesh, tp.index, gather_dim=d)


def _scatter_sum(x, tp: TPDim, d: int):
    return C.mesh_reduce_scatter(x, tp.mesh, "sum", scatter_dim=d, mesh_dim=tp.index)


def _piece(x, tp: TPDim, d: int):
    n = x.shape[d]
    if n % tp.size:
        raise ValueError(f"dim {d} of {tuple(x.shape)} does not split evenly over {tp}")
    w = n // tp.size
    return x.narrow(d, tp.rank * w, w).contiguous()


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return C.mesh_all_reduce(g, ctx.tp.mesh, "sum", ctx.tp.index), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return C.mesh_all_reduce(x, tp.mesh, "sum", tp.index)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, d, partial_grad):
        ctx.args = (tp, d, partial_grad)
        return _gather(x, tp, d)

    @staticmethod
    def backward(ctx, g):
        tp, d, partial_grad = ctx.args
        # contiguous: a parameter's gathered piece gets this as its .grad
        return ((_scatter_sum(g, tp, d).contiguous() if partial_grad else _piece(g, tp, d)),
                None, None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, d):
        ctx.args = (tp, d)
        return _scatter_sum(x, tp, d)

    @staticmethod
    def backward(ctx, g):
        tp, d = ctx.args
        return _gather(g, tp, d), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, d):
        ctx.args = (tp, d)
        return _piece(x, tp, d)

    @staticmethod
    def backward(ctx, g):
        tp, d = ctx.args
        return _gather(g, tp, d), None, None


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, shift):
        ctx.args = (tp, shift)
        return C.mesh_ppermute(x, tp.mesh, tp.index, shift=shift)

    @staticmethod
    def backward(ctx, g):
        tp, shift = ctx.args
        return C.mesh_ppermute(g, tp.mesh, tp.index, shift=-shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, split_dim, concat_dim):
        ctx.args = (tp, split_dim, concat_dim)
        return C.mesh_all_to_all(x, tp.mesh, tp.index, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        tp, split_dim, concat_dim = ctx.args
        return C.mesh_all_to_all(g, tp.mesh, tp.index, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, tp: TPDim, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Each rank cuts ``x`` into size-of-dim chunks along ``split_dim``,
    sends chunk j to rank j and concatenates what it gets along
    ``concat_dim`` in rank order (``collectives.mesh_all_to_all``, JAX's
    tiled ``all_to_all``); the gradient takes the swapped all-to-all."""
    if tp.size == 1:
        return x
    return _AllToAll.apply(x, tp, _dim(split_dim, x.ndim), _dim(concat_dim, x.ndim))


def ring_permute(x: torch.Tensor, tp: TPDim, shift: int = 1) -> torch.Tensor:
    """Rank j sends ``x`` to rank j + ``shift`` along the dim and gets rank
    j - ``shift``'s (``collectives.mesh_ppermute``); the gradient rotates
    the other way."""
    if tp.size == 1:
        return x
    return _RingPermute.apply(x, tp, shift)


def copy_to_tp(x: torch.Tensor, tp: TPDim) -> torch.Tensor:
    """Replicate in, Replicate out with a Partial gradient (all-reduced in
    the backward)."""
    if tp.size == 1:
        return x
    return tag(_CopyToTP.apply(x, tp), tp.placements(Replicate()), True)


def reduce_from_tp(x: torch.Tensor, tp: TPDim) -> torch.Tensor:
    """Partial -> Replicate: the sum over the dim; the gradient passes
    through."""
    if tp.size == 1:
        return x
    return tag(_ReduceFromTP.apply(x, tp), tp.placements(Replicate()))


def all_gather(x: torch.Tensor, tp: TPDim, d: int, partial_grad: bool) -> torch.Tensor:
    """Shard(d) -> Replicate.  ``partial_grad``: the result feeds
    tensor-parallel compute, so its gradient is Partial and the backward
    reduce-scatters; otherwise the backward keeps this rank's piece."""
    if tp.size == 1:
        return x
    d = _dim(d, x.ndim)
    return tag(_AllGather.apply(x, tp, d, bool(partial_grad)), tp.placements(Replicate()),
               partial_grad)


def reduce_scatter(x: torch.Tensor, tp: TPDim, d: int) -> torch.Tensor:
    """Partial -> Shard(d): this rank's chunk of the sum."""
    if tp.size == 1:
        return x
    d = _dim(d, x.ndim)
    return tag(_ReduceScatter.apply(x, tp, d), tp.placements(Shard(d)))


def split(x: torch.Tensor, tp: TPDim, d: int) -> torch.Tensor:
    """Replicate (with a Replicate gradient) -> Shard(d): this rank's
    chunk; the backward all-gathers the gradient's chunks."""
    if tp.size == 1:
        return x
    d = _dim(d, x.ndim)
    return tag(_Split.apply(x, tp, d), tp.placements(Shard(d)))


def narrow(x: torch.Tensor, tp: TPDim, d: int) -> torch.Tensor:
    """Replicate with a Partial gradient -> Shard(d): this rank's chunk;
    autograd zero-pads the gradient, which keeps it Partial."""
    if tp.size == 1:
        return x
    d = _dim(d, x.ndim)
    return tag(_piece(x, tp, d), tp.placements(Shard(d)))


def take_piece(x: torch.Tensor, tp: TPDim, d: int) -> torch.Tensor:
    """A Replicate ``x`` cut to this rank's chunk of dim ``d``: ``narrow``
    when its gradient is Partial, else ``split``."""
    return narrow(x, tp, d) if grad_partial(x) else split(x, tp, d)


def enter_tp(x: torch.Tensor, tp: TPDim) -> torch.Tensor:
    """``x`` made ready for tensor-parallel compute (a column-parallel
    product): Replicate with a Partial gradient.  A tensor already so is
    returned as it is; one tagged Shard(d) on the dim is all-gathered with
    the reduce-scatter backward; any other is taken as Replicate and goes
    through ``copy_to_tp``."""
    if tp.size == 1 or grad_partial(x):
        return x
    pl = tag_of(x)
    if pl is not None:
        p = pl[tp.index]
        if isinstance(p, Shard):
            return all_gather(x, tp, p.dim, True)
        if isinstance(p, Partial):
            raise ValueError(f"a Partial activation cannot enter tensor-parallel compute on {tp}")
    return copy_to_tp(x, tp)

