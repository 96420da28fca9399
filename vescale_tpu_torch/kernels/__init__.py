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

Each wrapper adds one to ``LAUNCHES[name]`` when its kernel launched, and
nowhere else, so a run can show that its main path went through the
kernels.  The CUDA sources build on first use (``_build.py``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["LAUNCHES", "reset_launches", "on_hopper", "require_hopper", "ulps_at_scale"]

LAUNCHES: Dict[str, int] = {
    "flash_fwd": 0,
    "paged_decode": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dkv": 0,
    "fused_adamw": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
