"""Optimizers, data and context parallelism of the port: ``AdamWLowmem``,
``Muon``, ``BasicOptimizer``, ``DistributedOptimizer`` (ZeRO), DDP, the ragged
FSDP buffer, and ring, Ulysses and blockwise attention (``context.py``)."""

from .context import blockwise_attention, ring_self_attention, ulysses_self_attention
from .ddp import DistributedDataParallel, dp_grad_reduce, resolve_grad_compress
from .fsdp import FSDPParamBuffer, fsdp_plan, make_fsdp_train_step
from .optimizer import (
    AdamWLowmem,
    BasicOptimizer,
    DistributedOptimizer,
    Muon,
    clip_grad_norm_fp32,
    found_inf,
    muon,
    muon_labels,
    newton_schulz,
    param_dtype_groups,
    zero_sharded,
)

__all__ = ["AdamWLowmem", "BasicOptimizer", "DistributedDataParallel", "DistributedOptimizer",
           "FSDPParamBuffer", "Muon", "blockwise_attention", "clip_grad_norm_fp32", "dp_grad_reduce",
           "found_inf", "fsdp_plan", "make_fsdp_train_step", "muon", "muon_labels",
           "newton_schulz", "param_dtype_groups",
           "resolve_grad_compress", "ring_self_attention", "ulysses_self_attention",
           "zero_sharded"]
