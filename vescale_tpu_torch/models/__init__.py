"""Model configurations and parameter trees of the port."""

from .convert import init_params, param_shapes, params_from_jax, tree_to
from .llama import (
    LLAMA2_7B,
    LLAMA3_8B,
    LLAMA3_70B,
    LLAMA3_405B,
    OPEN_LLAMA_3B,
    LlamaConfig,
    rmsnorm,
    rotary,
)

__all__ = [
    "LlamaConfig",
    "rmsnorm",
    "rotary",
    "LLAMA2_7B",
    "LLAMA3_8B",
    "LLAMA3_70B",
    "LLAMA3_405B",
    "OPEN_LLAMA_3B",
    "init_params",
    "param_shapes",
    "params_from_jax",
    "tree_to",
]
