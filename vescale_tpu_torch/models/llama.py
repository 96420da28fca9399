"""LLaMA family — configuration and the per-token math the serve engine uses.

The port of ``vescale_tpu/models/llama.py``: the same ``LlamaConfig``
fields and presets, RMSNorm with fp32 math, and split-half rotary
embeddings with fp32 phases.  The serve engine runs the forward itself
over the flax-layout parameter tree (``models/convert.py``).

``remat``, ``remat_policy``, ``remat_scope``, ``scan_layers`` and
``use_fp8`` are training options of the flax model.  They are accepted and
validated so that a config moves between the packages unchanged, and they
change nothing in this serve-only slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

__all__ = [
    "LlamaConfig",
    "rmsnorm",
    "rotary",
    "LLAMA2_7B",
    "LLAMA3_8B",
    "LLAMA3_70B",
    "LLAMA3_405B",
    "OPEN_LLAMA_3B",
]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32  # < heads -> GQA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    use_flash_attention: bool = True
    remat: bool = False  # inert here (training)
    remat_policy: Optional[str] = None  # inert here (training)
    remat_scope: str = "block"  # inert here (training)
    scan_layers: bool = False  # inert here (training)
    use_fp8: bool = False  # inert here (training)
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if self.remat_policy and not self.remat:
            raise ValueError(
                "remat_policy is set but remat=False — the policy would be "
                "silently ignored; set remat=True (or drop the policy)"
            )
        if self.remat_scope not in ("block", "mlp"):
            raise ValueError(f"remat_scope must be 'block' or 'mlp', got {self.remat_scope!r}")
        if self.remat_scope != "block" and not self.remat:
            raise ValueError(
                "remat_scope is set but remat=False — the scope would be "
                "silently ignored; set remat=True (or drop the scope)"
            )
        if self.remat_policy and self.remat_scope != "block":
            raise ValueError("remat_policy applies to remat_scope='block' only")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


LLAMA2_7B = LlamaConfig()
OPEN_LLAMA_3B = LlamaConfig(hidden_size=3200, intermediate_size=8640, num_hidden_layers=26, num_attention_heads=32)
LLAMA3_8B = LlamaConfig(
    vocab_size=128256,
    hidden_size=4096,
    intermediate_size=14336,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    max_position_embeddings=8192,
    rope_theta=500000.0,
)
LLAMA3_70B = LlamaConfig(
    vocab_size=128256,
    hidden_size=8192,
    intermediate_size=28672,
    num_hidden_layers=80,
    num_attention_heads=64,
    num_key_value_heads=8,
    rope_theta=500000.0,
)
LLAMA3_405B = LlamaConfig(
    vocab_size=128256,
    hidden_size=16384,
    intermediate_size=53248,
    num_hidden_layers=126,
    num_attention_heads=128,
    num_key_value_heads=8,
    rope_theta=500000.0,
)


def rmsnorm(x, weight, eps: float):
    """RMSNorm in fp32; the caller casts (the serve engine's ``_rmsnorm``)."""
    x32 = x.float()
    x32 = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return x32 * weight


def rotary(q, k, positions, theta: float):
    """Split-half rotary position embeddings with fp32 phases.  ``q``/``k``:
    (B, T, heads, hd); ``positions``: (B, T) integer positions."""
    hd = q.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=q.device) / hd))
    angles = positions[..., None].float() * freqs  # (B, T, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)

    def rot(x):
        x1, x2 = x.float().chunk(2, dim=-1)
        c = cos[:, :, None, :]
        s = sin[:, :, None, :]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)

    return rot(q), rot(k)
