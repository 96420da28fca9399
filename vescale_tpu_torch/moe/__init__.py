"""Mixture of experts: the port of ``vescale_tpu/moe``.

``MoEMLP`` (capacity-routed top-k experts, expert parallel over an "ep"
mesh dim), ``TokenDispatcher``, ``moe_plan`` and ``parallelize_experts``,
the allocators, and ``MoEParamBuffer`` / ``MoEOptimizer`` (ragged expert
pieces and their load-aware reallocation)."""

from .api import parallelize_experts, moe_plan
from .layer import MoEConfig, MoEMLP
from .experts_allocator import ExpertsAllocator, BasicExpertsAllocator
from .token_dispatcher import TokenDispatcher
from .moe_param_buffer import MoEParamBuffer
from .moe_optimizer import MoEOptimizer

__all__ = ["parallelize_experts", "moe_plan", "MoEConfig", "MoEMLP", "ExpertsAllocator",
           "BasicExpertsAllocator", "TokenDispatcher", "MoEParamBuffer", "MoEOptimizer"]
