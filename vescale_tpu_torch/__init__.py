"""vescale_tpu_torch — the PyTorch/CUDA port of vescale_tpu, for NVIDIA Hopper.

A package beside ``vescale_tpu`` (the JAX reference, which it never
imports).  This slice serves Llama models on one card: the paged KV cache,
the serve engine (flash-attention prefill and paged-attention decode, both
hand-written CUDA kernels for ``sm_90a``), the continuous-batching
scheduler and the serve loop.  Entry points run on the card unless the
caller passes ``device="cpu"``; kernels dispatch by the tensor's device.
"""

from .models import LLAMA3_8B, LlamaConfig, init_params, params_from_jax
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

__all__ = [
    "ContinuousBatchingScheduler",
    "KVCacheConfig",
    "KVCacheOutOfPages",
    "LLAMA3_8B",
    "LlamaConfig",
    "PagedKVCache",
    "Request",
    "ServeEngine",
    "ServeResult",
    "ShedError",
    "init_params",
    "params_from_jax",
    "run_serve",
]
