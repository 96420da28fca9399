"""Cross entropy for language-model training, on one device.

The port of ``vescale_tpu/loss.py``: ``vocab_parallel_cross_entropy`` with
its single-device branch (``mesh=None``, ``loss.py:83-91``), label
smoothing included, and the ``loss_parallel()`` context manager.  The
per-row heavy pass (sumexp, gold pick and, for smoothing, the sum of the
logits) runs as the fused kernels of ``kernels/cross_entropy.py`` on the
card, and as their plain versions on the CPU: there is no XLA-path
counterpart and no knob.  The vocab-parallel body (``loss.py:144-189``)
comes with tensor parallelism (ROADMAP.md queue A, item 10).
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
        warnings.warn(
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
    reference's ``stop_gradient`` max is.  ``mesh`` with ``vocab_dim_name``
    (the vocab-sharded path) is not ported yet."""
    if mesh is not None and vocab_dim_name is not None:
        raise NotImplementedError(
            "vocab_parallel_cross_entropy over a vocab-sharded mesh is not ported yet "
            "(ROADMAP.md queue A, item 10)")
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
