"""Cross entropy for language-model training, on one device or over
vocab-sharded logits.

The port of ``vescale_tpu/loss.py``: ``vocab_parallel_cross_entropy`` with
its single-device branch (``mesh=None``, ``loss.py:83-91``) and its
vocab-parallel body (``loss.py:144-189``, the reference's
``_vocab_parallel_fn`` shard_map), label smoothing included, and the
``loss_parallel()`` context manager.  The per-row heavy pass (sumexp,
gold pick and, for smoothing, the sum of the logits) runs as the fused
kernels of ``kernels/cross_entropy.py`` on the card, and as their plain
versions on the CPU: there is no XLA-path counterpart and no knob.  On a
mesh each rank passes its own (..., V/n) slice of the logits and gets the
whole loss; the cross-rank max and sums are the counted collectives of
``collectives.py``.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, Optional

import torch

from .kernels.cross_entropy import fused_xent_parts

__all__ = ["loss_parallel", "vocab_parallel_cross_entropy"]

_warned = False


@contextlib.contextmanager
def loss_parallel():
    """The reference's context manager (``loss.py:33``): it scopes intent
    only and warns once per process that it intercepts nothing; call
    :func:`vocab_parallel_cross_entropy` for the loss."""
    global _warned
    if not _warned:
        _warned = True
        # an API-semantics notice to the calling developer, not a runtime
        # health signal: a process-wide warn-once, not an alert
        warnings.warn(  # vescale-lint: disable=VSC207
            "loss_parallel() performs no dispatch interception: call "
            "vocab_parallel_cross_entropy(...) for the fused loss",
            stacklevel=3,
        )
    yield


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, *,
                                 mesh: Optional[Any] = None,
                                 vocab_dim_name: Optional[str] = None,
                                 label_smoothing: float = 0.0) -> torch.Tensor:
    """Token-mean cross entropy over (..., V) ``logits`` and (...) integer
    ``targets``, in fp32; with ``label_smoothing`` the uniform-smoothing
    loss ``logz - (1 - ls) * gold - ls * mean_v(logit)``.

    bf16 logits go to the kernels as they are (the upcast to fp32 happens
    in registers, exactly; the gradient comes back in bf16, rounded once);
    any other dtype is cast to fp32 first, as the reference casts.  The row
    max is a plain op outside the kernel and a constant to autograd, as the
    reference's ``stop_gradient`` max is.

    With ``mesh`` and ``vocab_dim_name``, ``logits`` is this rank's slice
    (..., V/n) of the vocab, columns [r·V/n, (r+1)·V/n) on the dim's
    coordinate r, and ``targets`` the global ids: the vocab-parallel body
    (:func:`_vocab_parallel`)."""
    if mesh is not None and vocab_dim_name is not None:
        return _vocab_parallel(logits, targets, mesh, vocab_dim_name, float(label_smoothing))
    V = logits.shape[-1]
    lg = logits.reshape(-1, V)
    if lg.dtype not in (torch.float32, torch.bfloat16):
        lg = lg.float()
    gmax = torch.amax(lg, dim=-1).detach().float()
    sumexp, picked, sumlg = fused_xent_parts(lg, targets.reshape(-1), gmax)
    logz = gmax + torch.log(sumexp)
    if label_smoothing > 0.0:
        return torch.mean(logz - (1 - label_smoothing) * picked - label_smoothing * (sumlg / V))
    return torch.mean(logz - picked)


def _vocab_parallel(logits, targets, mesh, vocab_dim_name: str, label_smoothing: float):
    """The reference's shard_map body on this rank's (..., V/n) slice: the
    global max an all-reduce(max) of the detached local maxima; the fused
    kernels' sums on the (N, V/n) slice with the local gold index clipped
    into it; then sumexp, the masked gold pick and, for smoothing, the
    logit sum each summed over the dim in that order (all-reduce forward,
    identity backward: ``dmodule._comm.reduce_from_tp``)."""
    from .collectives import mesh_all_reduce
    from .dmodule._comm import TPDim, reduce_from_tp

    tp = TPDim(mesh, vocab_dim_name)
    Vs = logits.shape[-1]
    V = Vs * tp.size
    lg = logits.reshape(-1, Vs)
    if lg.dtype not in (torch.float32, torch.bfloat16):
        lg = lg.float()
    tgt = targets.reshape(-1)
    local_max = torch.amax(lg, dim=-1).detach().float()
    gmax = mesh_all_reduce(local_max, mesh, "max", tp.index) if tp.size > 1 else local_max
    lo = tp.rank * Vs
    in_range = (tgt >= lo) & (tgt < lo + Vs)
    local_idx = torch.clamp(tgt - lo, 0, Vs - 1)
    sumexp, picked, sumlg = fused_xent_parts(lg, local_idx, gmax)
    logz = gmax + torch.log(reduce_from_tp(sumexp, tp))
    gold = reduce_from_tp(torch.where(in_range, picked, torch.zeros_like(picked)), tp)
    if label_smoothing > 0.0:
        mean_v = reduce_from_tp(sumlg, tp) / V
        return torch.mean(logz - (1 - label_smoothing) * gold - label_smoothing * mean_v)
    return torch.mean(logz - gold)
