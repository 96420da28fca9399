"""vescale_tpu_torch.kernels — the hand-written CUDA kernels of the port.

Every kernel here replaces a Pallas TPU kernel of ``vescale_tpu.kernels``
and sits beside its plain PyTorch version, in the same module.  Dispatch
is by the tensor's device and nothing else:

  * a CPU tensor takes the plain version;
  * a CUDA tensor launches the kernel, or raises.  No knob sends the card
    to the plain version, and no failed build or launch falls back to it.

Kernels:

  * ``flash_fwd``    (``flash_attention.py``) — fused causal/full softmax
    attention forward; the prefill attention of the serve engine.
  * ``paged_decode`` (``paged_attention.py``) — one decode step's
    attention read straight from the paged KV pool.
  * ``flash_bwd_dq`` and ``flash_bwd_dkv`` (``flash_attention.py``) — the
    flash-attention backward, dQ and dK/dV, recomputing the probabilities
    from the forward's logsumexp; the training step's attention backward.
  * ``fused_adamw`` (``fused_adamw.py``) — the ``adamw_lowmem`` moment
    update of every leaf of a model in one multi-tensor launch.
  * ``fused_xent_fwd`` and ``fused_xent_bwd`` (``cross_entropy.py``) — the
    cross entropy's three row sums over the vocab dim in one read of the
    logits, and its gradient in one elementwise pass; the loss of
    ``loss.py::vocab_parallel_cross_entropy``.

Each wrapper adds one to ``LAUNCHES[name]`` when its kernel launched, and
nowhere else, so a run can show that its main path went through the
kernels.  The CUDA sources build on first use (``_build.py``).

Each kernel has a ``<name>_cost(...)`` beside its wrapper, taking the
wrapper's arguments and giving ``(flops, bytes)``: the operations it does
and the bytes it must move (each input read once, each output written
once), the counts its roofline bound divides by.  While a layer
attribution runs (``telemetry.costaudit.LayerAttribution``), a wrapper
adds its cost to the current layer and nothing inside it is counted, on
the card and on the CPU alike (:func:`costed`).
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np

__all__ = ["LAUNCHES", "reset_launches", "on_hopper", "require_hopper", "ulps_at_scale",
           "costed", "kernel_head_dim", "work_head_dim", "KERNEL_HEAD_DIMS"]

LAUNCHES: Dict[str, int] = {
    "flash_fwd": 0,
    "paged_decode": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dkv": 0,
    "fused_adamw": 0,
    "fused_xent_fwd": 0,
    "fused_xent_bwd": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# the running layer attribution, or None: one module-global check a call
COST_SINK = None


def costed(name: str, cost):
    """Decorate a kernel wrapper: while a layer attribution runs, it takes
    ``cost(*args, **kwargs)`` (flops, bytes) for the call and counts nothing
    inside it; otherwise the wrapper runs as it is."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            sink = COST_SINK
            if sink is None:
                return fn(*args, **kwargs)
            return sink.kernel(name, cost(*args, **kwargs), fn, args, kwargs)

        wrapped.cost = cost
        return wrapped

    return deco


# the head dims the attention kernels are compiled for
KERNEL_HEAD_DIMS = (64, 128)


def kernel_head_dim(what: str, D: int) -> int:
    """The compiled width the attention kernels (flash forward and backward,
    paged decode) run a head dim ``D`` at: the least of
    ``KERNEL_HEAD_DIMS`` that holds it.  They take every ``D`` <= 128 with
    ``D % 4 == 0`` (OpenLLaMA-3B's 100, the tiny configs' 16 and 32); the
    flash wrappers zero-pad q, k, v and dO to that width, the paged decode
    predicates its lanes on ``d < D``.  Raises for any other ``D``."""
    D = int(D)
    if not 0 < D <= KERNEL_HEAD_DIMS[-1] or D % 4:
        raise ValueError(f"{what}: head_dim {D}; the kernels take a multiple of 4 "
                         f"up to {KERNEL_HEAD_DIMS[-1]}")
    return next(w for w in KERNEL_HEAD_DIMS if D <= w)


def work_head_dim(t, D: int) -> int:
    """The head dim a call on ``t`` computes at: the kernel's width on a
    CUDA tensor, ``D`` itself elsewhere (the plain versions, and ``meta``
    tensors for a bound that counts the function's own work).  A ``D`` no
    kernel takes counts as itself."""
    if t.device.type != "cuda" or not 0 < D <= KERNEL_HEAD_DIMS[-1] or D % 4:
        return D
    return kernel_head_dim("work_head_dim", D)


def on_hopper() -> bool:
    """A CUDA device of compute capability (9, 0) is present: the kernels
    are built for ``sm_90a`` only."""
    import torch

    return torch.cuda.is_available() and torch.cuda.get_device_capability(0) == (9, 0)


def require_hopper(t) -> None:
    """Raise unless ``t`` lies on a Hopper card the kernels can run on."""
    import torch

    if t.device.type != "cuda":
        raise ValueError(f"kernel launch needs a CUDA tensor, got {t.device}")
    if torch.cuda.get_device_capability(t.device) != (9, 0):
        raise RuntimeError(
            f"the CUDA kernels are built for sm_90a; {torch.cuda.get_device_name(t.device)} "
            f"has capability {torch.cuda.get_device_capability(t.device)}"
        )


def ulps_at_scale(a, b) -> float:
    """The parity metric of the kernel layer: max ``|a - b|`` over the fp32
    spacing at the reference ``b``'s max magnitude — "off by N representable
    steps at the tensor's scale", so near-zero elements don't inflate the
    number.  NaN and signed-Inf patterns must agree exactly: a kernel that
    overflows to Inf (or drops/creates a NaN) where the reference doesn't
    returns ``inf``, a parity failure, never an excluded element.  A copy of
    ``vescale_tpu.kernels.ulps_at_scale``, so both packages hold their
    kernels to the same number."""
    a64 = np.asarray(a, np.float64).ravel()
    b64 = np.asarray(b, np.float64).ravel()
    if (
        not (np.isnan(a64) == np.isnan(b64)).all()
        or not (np.isposinf(a64) == np.isposinf(b64)).all()
        or not (np.isneginf(a64) == np.isneginf(b64)).all()
    ):
        return float("inf")
    fin = np.isfinite(a64) & np.isfinite(b64)
    if not fin.any():
        return 0.0
    step = float(np.spacing(np.float32(np.max(np.abs(b64[fin])) or 1.0)))
    return float(np.max(np.abs(a64[fin] - b64[fin])) / step)
