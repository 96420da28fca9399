"""vescale_tpu_torch — the PyTorch/CUDA port of vescale_tpu, for NVIDIA Hopper.

A package beside ``vescale_tpu`` (the JAX reference, which it never
imports).  It serves Llama models on one card (the paged KV cache, the
serve engine with flash-attention prefill and paged-attention decode, the
continuous-batching scheduler and the resilient serve loop, alone or as a
fleet replica over HTTP) and trains them on one
card (the ``Llama`` module, ``AdamWLowmem`` and ``make_train_step``, with
the flash-attention backward and a fused AdamW update), and trains nanoGPT
(``GPT``) through ``vocab_parallel_cross_entropy`` and its fused
cross-entropy kernels on batches from ``TokenDataLoader``; both train and
serve tensor- and sequence-parallel over a mesh (``dmodule.parallelize_module``
with ``models.llama_plan`` / ``nanogpt_plan``), and train pipeline-parallel
(``pipe``: the schedules, the eager ``PipeEngine``, ``split_graph`` and the
compiled pipeline over a ``pp`` mesh).  Every kernel
is hand-written CUDA for ``sm_90a``.  Entry points run on the card unless the
caller passes ``device="cpu"``; kernels dispatch by the tensor's device.
"""

from .data import TokenDataLoader
from .loss import vocab_parallel_cross_entropy
from .models import GPT, LLAMA3_8B, GPTConfig, Llama, LlamaConfig, init_params, params_from_jax
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
    run_serve_resilient,
    serve_replica,
)
from .train import make_train_step

__all__ = [
    "AdamWLowmem",
    "ContinuousBatchingScheduler",
    "GPT",
    "GPTConfig",
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
    "TokenDataLoader",
    "init_params",
    "make_train_step",
    "params_from_jax",
    "run_serve",
    "run_serve_resilient",
    "serve_replica",
    "vocab_parallel_cross_entropy",
]
