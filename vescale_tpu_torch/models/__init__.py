"""Model configurations and parameter trees of the port."""

from .convert import (
    init_params,
    load_params,
    module_tree,
    param_shapes,
    params_from_jax,
    tree_to,
)
from .llama import (
    LLAMA2_7B,
    LLAMA3_8B,
    LLAMA3_70B,
    LLAMA3_405B,
    OPEN_LLAMA_3B,
    Llama,
    LlamaConfig,
    rmsnorm,
    rotary,
)
from .nanogpt import GPT, GPTConfig, cross_entropy_loss

__all__ = [
    "GPT",
    "GPTConfig",
    "Llama",
    "LlamaConfig",
    "cross_entropy_loss",
    "load_params",
    "module_tree",
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
