"""The compiled pipeline over a ``pp`` mesh — the multi-rank path.

The port of ``vescale_tpu/pipe/spmd.py``.  Where the reference compiles
the whole pipeline into one XLA program (a ``shard_map`` over ``pp`` whose
``lax.scan`` rotates activations with ``lax.ppermute``), here every rank
of the ``pp`` mesh dim runs the same slot loop eagerly: ``T =
_vpp_total_steps(S, V, M)`` steps, at step ``t`` stage ``idx`` applies the
chunk ``_vpp_slot`` names to the microbatch in that slot, and every rank
rotates its output one stage forward with a ring permute, whether its slot
was active or not, so the collectives pair up.

Stage parameters are stacked: leaves ``(S, ...)`` (``stack_stage_params``)
or stage-major ``(S·V, ...)`` (``stack_interleaved_params``), each rank
holding its ``(V, ...)`` chunks — the ``Shard(0)`` pieces of
``shard_stacked_params`` (``DArray`` leaves; their local tensors carry the
gradients).

Schedules (reference _schedules/):
  - 1F1B-equivalent  ``pipeline_blocks``       <- pipedream_flush.py
  - Interleaved/VPP  ``pipeline_blocks(virtual_chunks=V)`` <- looping_bfs.py:699,873
  - Zero-bubble      ``pipeline_blocks_zb``    <- zero_bubble_v.py:132,198,602

``pipeline_blocks`` is plain autograd: the ring permute is
``dmodule._comm.ring_permute``, whose backward is the reverse rotation, so
``backward()`` of its output IS the backward pipeline.  Every rank's graph
holds the same chain of permutes and selects (an idle slot's zeros are
selected from its input, never a constant), so every rank runs the reverse
permutes in the same order.  ``pipeline_blocks_zb`` is a ``torch.autograd.Function``
whose backward runs the reference's two phases: a reverse dgrad-only loop
that recomputes each active step's block forward on detached parameters
(no weight-gradient matmul runs) and rotates cotangents backwards, then a
wgrad loop over the stashed ``(x_in, dy)`` pairs.

The embedding and head run outside, replicated on every rank.  The output
lives on the last stage; both entry points hand it to every rank
(a broadcast) whose backward delivers ONE cotangent, the last stage's
own, not the sum of S replicated ones.  The input's gradient appears on
stage 0 only; its backward broadcasts stage 0's ``dx`` so every rank's
replicated embedding receives the same gradient.  Over gloo with CUDA
tensors the permutes go through the host (``collectives.HOST_ROUTE``).

Requirements: homogeneous stages (one block parameter structure per
chunk) whose ``block_fn(chunk_params, x_micro)`` keeps the activation's
shape — the canonical transformer middle.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional

import torch

from .. import collectives as C
from ..dmodule import _comm
from .pipe_stage import flatten_tree, unflatten_tree

__all__ = [
    "pipeline_blocks",
    "pipeline_blocks_zb",
    "stack_stage_params",
    "stack_interleaved_params",
    "shard_stacked_params",
    "stage_chunks",
]


def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


def stack_stage_params(params_list):
    """Stack per-stage param trees (same structure) along a new leading
    axis -> leaves (S, ...)."""
    return _tree_map(lambda *xs: torch.stack(xs, dim=0), *params_list)


def stack_interleaved_params(groups_params, num_stages: int):
    """Stack ``S*V`` per-group param trees (PipeModule group order: group
    ``g`` = chunk ``g // S`` on stage ``g % S``) into leaves (S*V, ...)
    ordered *stage-major* (index = stage*V + chunk), so that ``Shard(0)``
    on the pp mesh dim gives each stage its V contiguous chunks."""
    n = len(groups_params)
    if n % num_stages:
        raise ValueError(f"{n} groups not divisible by {num_stages} stages")
    V = n // num_stages
    reordered = [groups_params[v * num_stages + s] for s in range(num_stages) for v in range(V)]
    return stack_stage_params(reordered)


def shard_stacked_params(
    stacked,
    mesh,
    param_plan,
    pp_dim: str = "pp",
    fqn_prefix: str = "",
):
    """Place pp-stacked per-stage block params by a DModule param plan.

    Each leaf is (S, *block_shape), or the flat stage-major (S*V,
    *block_shape) of ``stack_interleaved_params``; the leading axis is
    ``Shard(0)`` on ``pp_dim`` and the block dims follow the plan's
    placements for ``fqn_prefix + leaf_path`` (the FQN-regex plans
    ``parallelize_module`` takes, shifted by the stack axis).  Returns the
    tree with ``DArray`` leaves: this rank's pieces."""
    from ..darray import distribute_tensor
    from ..dmodule.api import _match
    from ..placements import Shard, normalize_placements

    pp_index = mesh._dim_index(pp_dim)

    def one(path, leaf):
        _, v = _match(param_plan, fqn_prefix + path)
        placements = list(normalize_placements(v, mesh.ndim, leaf.ndim - 1))
        # the block dims shift by the stack axis; pp is the stack axis
        placements = [Shard(p.dim + 1) if isinstance(p, Shard) else p for p in placements]
        placements[pp_index] = Shard(0)
        return distribute_tensor(leaf, mesh, placements)

    flat = flatten_tree(stacked)
    return unflatten_tree({k: one(k, t) for k, t in flat.items()})


def stage_chunks(stacked, mesh, pp_dim: str = "pp"):
    """This rank's (V, ...) chunks of a pp-stacked tree of full tensors
    (the local pieces ``shard_stacked_params`` would give, as plain
    tensors)."""
    S = mesh.size(pp_dim)
    idx = mesh.get_coordinate()[mesh._dim_index(pp_dim)]

    def cut(t):
        V = t.shape[0] // S
        return t[idx * V:(idx + 1) * V]

    return _tree_map(cut, stacked)


# ------------------------------------------------------------ schedule math
def _vpp_slot(t: int, idx: int, S: int, V: int, M: int):
    """The (microbatch, chunk) occupying stage ``idx`` at step ``t``.

    Megatron wave ordering (looping_bfs.py): microbatch ``m`` enters stage 0
    chunk 0 at ``t = (m // S) * S*V + m % S``; each step the activation
    rotates one stage forward, re-entering stage 0 for the next chunk after
    stage S-1.  Returns (m, v, active, inject, collect)."""
    u = t - idx
    w = u // (S * V)
    q = u - w * (S * V)
    v = q // S
    j = q - v * S
    m = w * S + j
    active = (u >= 0) and (m < M)
    inject = active and v == 0 and idx == 0
    collect = active and v == V - 1 and idx == S - 1
    return m, v, active, inject, collect


def _vpp_total_steps(S: int, V: int, M: int) -> int:
    return ((M - 1) // S) * S * V + ((M - 1) % S) + S * V


def _local(leaf):
    from ..darray import DArray

    return leaf.to_local() if isinstance(leaf, DArray) else leaf


def _prepare(x, mesh, pp_dim, num_microbatches, virtual_chunks, stacked_params):
    S = mesh.size(pp_dim)
    M = num_microbatches or S
    B = x.shape[0]
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    flat = {k: _local(t) for k, t in flatten_tree(stacked_params).items()}
    for k, t in flat.items():
        if t.shape[0] != virtual_chunks:
            raise ValueError(
                f"this rank's stacked leaf {k} has leading axis {t.shape[0]} != virtual_chunks "
                f"{virtual_chunks} (stack with stack_stage_params / stack_interleaved_params and "
                "pass this rank's pieces: shard_stacked_params or stage_chunks)")
    idx = mesh.get_coordinate()[mesh._dim_index(pp_dim)]
    return S, M, B, idx, flat


def _chunk(flat: Dict[str, torch.Tensor], v: int):
    """Chunk ``v``'s parameter tree from this rank's (V, ...) leaves."""
    return unflatten_tree({k: t[v] for k, t in flat.items()})


class _FromFirst(torch.autograd.Function):
    """Identity forward on the replicated pipeline input; the backward
    hands every rank stage 0's gradient (the only stage that injects)."""

    @staticmethod
    def forward(ctx, x, mesh, pp_dim):
        ctx.args = (mesh, pp_dim)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, pp_dim = ctx.args
        return C.mesh_broadcast(g, mesh, pp_dim, src_rank=0), None, None


class _FromLast(torch.autograd.Function):
    """The last stage's output on every rank; the backward keeps only the
    last stage's own cotangent (the others' replicated copies of it are
    not summed in)."""

    @staticmethod
    def forward(ctx, y, mesh, pp_dim, last: bool):
        ctx.last = last
        return C.mesh_broadcast(y, mesh, pp_dim, src_rank=mesh.size(pp_dim) - 1)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None, None, None


# ------------------------------------------------------------- 1F1B / VPP
def pipeline_blocks(
    block_fn: Callable,
    stacked_params,
    x,
    mesh,
    pp_dim: str = "pp",
    num_microbatches: Optional[int] = None,
    virtual_chunks: int = 1,
):
    """Apply ``S * virtual_chunks`` sequential model chunks (V on each pp
    rank, Megatron interleaved assignment) to ``x``, pipelined over
    microbatches.

    ``block_fn(chunk_params, x_micro) -> y_micro`` must keep the
    activation shape.  ``stacked_params``: this rank's (V, ...) pieces of
    the stacked leaves (``shard_stacked_params`` or ``stage_chunks``).
    ``x``: (B, ...) replicated on every rank, B divisible by
    num_microbatches (default S).  Returns the (B, ...) output on every
    rank, as if the chunks were applied sequentially; differentiable in
    ``x`` and the local parameter tensors."""
    S, M, B, idx, flat = _prepare(x, mesh, pp_dim, num_microbatches, virtual_chunks,
                                  stacked_params)
    V = virtual_chunks
    T = _vpp_total_steps(S, V, M)
    tp = _comm.TPDim(mesh, pp_dim)
    micro = _FromFirst.apply(x, mesh, pp_dim).reshape(M, B // M, *x.shape[1:])
    act = torch.zeros_like(micro[0])
    zero = torch.zeros_like(act)
    # device-resident selectors: where() keeps both branches in every rank's
    # graph (the unselected one gets a zero gradient) with no host sync
    flag = {b: torch.full((), b, dtype=torch.bool, device=x.device) for b in (False, True)}
    outs: List[Optional[torch.Tensor]] = [None] * M
    for t in range(T):
        m, v, active, inject, collect = _vpp_slot(t, idx, S, V, M)
        x_in = torch.where(flag[inject], micro[min(max(m, 0), M - 1)], act)
        if active:
            y = block_fn(_chunk(flat, v), x_in)
            if collect:
                outs[m] = y
        else:
            y = torch.where(flag[False], x_in, zero)  # an idle slot sends zeros
        act = _comm.ring_permute(y, tp, 1)
    last = idx == S - 1
    out = torch.stack(outs) if last else torch.where(flag[False], micro, zero[None])
    # the last permute's output joins the output (with a zero gradient), so
    # every permute of the chain is in every rank's backward, in one order
    out = torch.where(flag[False], act[None], out)
    return _FromLast.apply(out, mesh, pp_dim, last).reshape(B, *x.shape[1:])


# ------------------------------------------------------------- zero bubble
class _ZBPipe(torch.autograd.Function):
    """The zero-bubble pipeline: forward stashes each step's input; the
    backward runs the dgrad phase, then the wgrad phase."""

    @staticmethod
    def forward(ctx, block_fn, spec, x, *leaves):
        mesh, pp_dim, S, V, M, idx, names, dgrad_context = spec
        flat = dict(zip(names, leaves))
        T = _vpp_total_steps(S, V, M)
        micro = x.reshape(M, x.shape[0] // M, *x.shape[1:])
        act = torch.zeros_like(micro[0])
        outs = torch.zeros_like(micro)
        xins: Dict[int, torch.Tensor] = {}
        for t in range(T):
            m, v, active, inject, collect = _vpp_slot(t, idx, S, V, M)
            if active:
                x_in = micro[m] if inject else act
                xins[t] = x_in
                y = block_fn(_chunk(flat, v), x_in)
                if collect:
                    outs[m] = y
            else:
                y = torch.zeros_like(act)
            act = C.mesh_ppermute(y, mesh, pp_dim, shift=1)
        ctx.block_fn, ctx.spec, ctx.xins = block_fn, spec, xins
        ctx.save_for_backward(*leaves)
        ctx.x_shape = x.shape
        return outs.reshape(x.shape)

    @staticmethod
    def backward(ctx, d_out):
        block_fn, xins = ctx.block_fn, ctx.xins
        mesh, pp_dim, S, V, M, idx, names, dgrad_context = ctx.spec
        leaves = ctx.saved_tensors
        flat = dict(zip(names, leaves))
        T = _vpp_total_steps(S, V, M)
        d_outs = d_out.reshape(M, d_out.shape[0] // M, *d_out.shape[1:])
        dmicro = torch.zeros_like(d_outs)
        dact = torch.zeros_like(d_outs[0])
        dys: Dict[int, torch.Tensor] = {}

        # ---- phase 1: dgrad-only reverse loop (the critical path) ----
        detached = {k: t.detach() for k, t in flat.items()}
        with (dgrad_context() if dgrad_context is not None else contextlib.nullcontext()):
            for t in range(T - 1, -1, -1):
                m, v, active, inject, collect = _vpp_slot(t, idx, S, V, M)
                dx = torch.zeros_like(dact)
                if active:
                    # this step's output cotangent: what flowed back from the
                    # next stage, plus the direct output cotangent if collected
                    dy = dact + d_outs[m] if collect else dact
                    dys[t] = dy
                    x_in = xins[t].detach().requires_grad_(True)
                    with torch.enable_grad():
                        y = block_fn(_chunk(detached, v), x_in)
                    (dx,) = torch.autograd.grad(y, x_in, dy)
                    if inject:  # injected steps terminate at the microbatch input
                        dmicro[m] = dx
                        dx = torch.zeros_like(dx)
                dact = C.mesh_ppermute(dx, mesh, pp_dim, shift=-1)

        # ---- phase 2: deferred wgrads (fill the bubbles) ----
        dparams = {k: torch.zeros_like(t) for k, t in flat.items()}
        for t in range(T):
            m, v, active, _, _ = _vpp_slot(t, idx, S, V, M)
            if not active:
                continue
            p_v = {k: t_[v].detach().requires_grad_(True) for k, t_ in flat.items()}
            with torch.enable_grad():
                y = block_fn(unflatten_tree(p_v), xins[t].detach())
            got = torch.autograd.grad(y, list(p_v.values()), dys[t], allow_unused=True,
                                      materialize_grads=True)
            for k, g in zip(p_v, got):
                dparams[k][v] += g
        ctx.xins = None
        dx_all = C.mesh_broadcast(dmicro.reshape(ctx.x_shape), mesh, pp_dim, src_rank=0)
        return (None, None, dx_all, *(dparams[k] for k in names))


def pipeline_blocks_zb(
    block_fn: Callable,
    stacked_params,
    x,
    mesh,
    pp_dim: str = "pp",
    num_microbatches: Optional[int] = None,
    virtual_chunks: int = 1,
    dgrad_context: Optional[Callable[[], Any]] = None,
):
    """``pipeline_blocks`` with a REAL zero-bubble backward (reference
    zero_bubble_v.py: the B/W split).

    Forward is the same rotating loop (inputs stashed per step, no graph
    kept).  The backward runs two phases:

      1. **dgrad** (reverse): recomputes each active step's block on
         detached parameters and asks autograd for the input cotangent
         only — no weight-grad matmul runs — rotating cotangents
         backwards.  The per-step output cotangents are stashed.
      2. **wgrad**: recomputes each active step's block with the
         parameters as the inputs and accumulates every deferred weight
         grad into its chunk, in step order.

    Cost: one extra block forward per phase (recomputation), the
    reference's trade of memory for FLOPs.  ``dgrad_context`` (a factory
    of context managers, e.g. ``graph_split.OpRecorder``) is entered around
    phase 1."""
    S, M, B, idx, flat = _prepare(x, mesh, pp_dim, num_microbatches, virtual_chunks,
                                  stacked_params)
    names = list(flat)
    spec = (mesh, pp_dim, S, virtual_chunks, M, idx, names, dgrad_context)
    out = _ZBPipe.apply(block_fn, spec, x, *flat.values())
    # every rank's output joins the graph, so every rank runs the backward
    # (its permutes are collective); the non-last ranks' outputs are zeros
    return _FromLast.apply(out, mesh, pp_dim, idx == S - 1)
