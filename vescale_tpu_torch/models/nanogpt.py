"""nanoGPT — a GPT-2-style decoder, and its loss.

The port of ``vescale_tpu/models/nanogpt.py``: the same ``GPTConfig``
fields and defaults (GPT-2 124M: 12 layers, 12 heads, width 768, block
1024, vocab 50304), and the model as ``nn.Module``s (``LayerNorm``,
``CausalSelfAttention``, ``MLP``, ``Block``, ``GPT``) whose parameters
carry the flax paths: ``dict(model.named_parameters())`` has exactly the
keys of the flattened flax ``params`` tree (``wte.embedding``,
``wpe.embedding``, ``h_<i>.attn.c_attn.kernel`` ..., ``h_<i>.ln_1.scale``
..., ``ln_f.bias``), kernels in flax's (in, out) layout.  As in flax,
parameters are fp32 master weights and every layer computes in
``config.dtype``; ``LayerNorm`` follows flax's math (fp32 statistics with
Var = E[x²] − E[x]² clipped at 0, epsilon 1e-6, the result cast to the
dtype), the MLP's GELU is the tanh approximation (flax ``nn.gelu``'s
default), and the head is tied: ``wte.attend``.  Attention runs
``ops.flash_attention`` (the CUDA kernels on the card) with
``use_flash_attention``, else the reference's dense einsum branch in the
compute dtype.

Not here yet: dropout (``dropout > 0`` raises; its RNG streams are an open
item of ROADMAP.md queue A, item 5), ``nanogpt_plan`` (waits for items 9
and 10) and the pipeline stage units (item 15).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .llama import Dense, Embed, _param

__all__ = ["GPTConfig", "LayerNorm", "CausalSelfAttention", "MLP", "Block", "GPT",
           "cross_entropy_loss"]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    block_size: int = 1024
    vocab_size: int = 50304  # GPT-2's 50257 padded to a multiple of 64
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    dropout: float = 0.0
    bias: bool = True
    use_flash_attention: bool = False
    dtype: Any = torch.float32


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (epsilon 1e-6, ``use_fast_variance``): mean and
    E[x²] in fp32, Var = max(0, E[x²] − mean²), then
    ``(x − mean) * (rsqrt(Var + eps) * scale) + bias`` in fp32, cast to
    ``dtype``."""

    eps = 1e-6

    def __init__(self, features: int, use_bias: bool, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = _param((features,), device)
        self.bias = _param((features,), device) if use_bias else None

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        mean2 = (x32 * x32).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, c: GPTConfig, device=None):
        super().__init__()
        self.config = c
        self.c_attn = Dense(c.n_embd, 3 * c.n_embd, c.dtype, device, use_bias=c.bias)
        self.c_proj = Dense(c.n_embd, c.n_embd, c.dtype, device, use_bias=c.bias)

    def forward(self, x):
        c = self.config
        B, T, E = x.shape
        H, hd = c.n_head, E // c.n_head
        q, k, v = self.c_attn(x).split(E, dim=-1)
        q, k, v = (t.reshape(B, T, H, hd) for t in (q, k, v))
        if c.use_flash_attention:
            from ..ops.flash_attention import flash_attention

            y = flash_attention(q, k, v, causal=True).reshape(B, T, E)
        else:
            # the reference's dense branch, op by op in the compute dtype
            att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
            att = torch.where(mask, att, torch.full_like(att, torch.finfo(att.dtype).min))
            att = torch.softmax(att, dim=-1)
            y = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, T, E)
        return self.c_proj(y)


class MLP(nn.Module):
    """``c_proj(gelu(c_fc(x)))`` with the tanh GELU, in the compute dtype."""

    def __init__(self, c: GPTConfig, device=None):
        super().__init__()
        self.c_fc = Dense(c.n_embd, 4 * c.n_embd, c.dtype, device, use_bias=c.bias)
        self.c_proj = Dense(4 * c.n_embd, c.n_embd, c.dtype, device, use_bias=c.bias)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, c: GPTConfig, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(c.n_embd, c.bias, c.dtype, device)
        self.attn = CausalSelfAttention(c, device)
        self.ln_2 = LayerNorm(c.n_embd, c.bias, c.dtype, device)
        self.mlp = MLP(c, device)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class GPT(nn.Module):
    """The flax ``GPT``: token ids (B, T) to logits (B, T, vocab) in
    ``config.dtype``.  Parameters are fp32, on ``device`` (default: the
    card), from ``params`` (a flax-layout tree, e.g. ``init_params`` or
    ``params_from_jax``, copied in) or else ``init_params(config, seed)``.
    The head is tied to ``wte``: one fp32 master, whose gradient sums the
    lookup's and the head's."""

    def __init__(self, config: GPTConfig, params=None, *, device=None, seed: int = 0):
        super().__init__()
        c = config
        if c.dropout > 0.0:
            raise NotImplementedError(
                "GPTConfig.dropout > 0 is not ported yet: dropout RNG streams "
                "(ROADMAP.md queue A, item 5)")
        self.config = c
        dev = resolve_device(device)
        self.wte = Embed(c.vocab_size, c.n_embd, c.dtype, dev)
        self.wpe = Embed(c.block_size, c.n_embd, c.dtype, dev)
        for i in range(c.n_layer):
            self.add_module(f"h_{i}", Block(c, dev))
        self.ln_f = LayerNorm(c.n_embd, c.bias, c.dtype, dev)
        from .convert import init_params, load_params

        if params is None:
            params = init_params(c, seed, device=dev, dtype=torch.float32)
        load_params(self, params)

    def forward(self, idx):
        c = self.config
        T = idx.shape[1]
        if T > c.block_size:
            raise ValueError(f"sequence of {T} tokens exceeds block_size {c.block_size}")
        x = self.wte(idx) + self.wpe(torch.arange(T, device=idx.device))[None]
        for i in range(c.n_layer):
            x = getattr(self, f"h_{i}")(x)
        return self.wte.attend(self.ln_f(x))


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Token-level cross entropy, fp32: logsumexp minus the gold logit,
    mean over every token."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.mean(logz - gold)
