"""vescale_tpu_torch — the PyTorch/CUDA port of vescale_tpu, for NVIDIA Hopper.

A package beside ``vescale_tpu`` (the JAX reference, which it never
imports).  It serves Llama models on one card (the paged KV cache, the
serve engine with flash-attention prefill and paged-attention decode, the
continuous-batching scheduler and the serve loop) and trains them on one
card (the ``Llama`` module, ``AdamWLowmem`` and ``make_train_step``, with
the flash-attention backward and a fused AdamW update).  Every kernel is
hand-written CUDA for ``sm_90a``.  Entry points run on the card unless the
caller passes ``device="cpu"``; kernels dispatch by the tensor's device.
"""

from .models import LLAMA3_8B, Llama, LlamaConfig, init_params, params_from_jax
from .parallel import AdamWLowmem
from .serve import (
    ContinuousBatchingScheduler,
    KVCacheConfig,
    KVCacheOutOfPages,
    PagedKVCache,
    Request,
    ServeEngine,
    ServeResult,
    ShedError,
    run_serve,
)
from .train import make_train_step

__all__ = [
    "AdamWLowmem",
    "ContinuousBatchingScheduler",
    "KVCacheConfig",
    "KVCacheOutOfPages",
    "LLAMA3_8B",
    "Llama",
    "LlamaConfig",
    "PagedKVCache",
    "Request",
    "ServeEngine",
    "ServeResult",
    "ShedError",
    "init_params",
    "make_train_step",
    "params_from_jax",
    "run_serve",
]
