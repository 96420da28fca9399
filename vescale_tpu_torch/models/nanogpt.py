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

Dropout sits where flax's ``nn.Dropout`` sits: on the embedding sum, on
the attention weights (the dense branch: flash attention runs only when
``dropout == 0``), on the attention output and on the MLP output, each a
``Dropout`` module under flax's auto-name (``Dropout_0``, ``Dropout_1``),
so its module path is flax's scope path.  ``GPT.forward(idx,
deterministic=True, rngs=None)`` takes the reference's arguments: with
``deterministic=False`` each site draws ``bernoulli(make_rng("dropout"),
1 - rate)`` and keeps ``x / (1 - rate)`` where it holds, with the key flax
derives for that path from ``rngs["dropout"]`` (``random.make_rng``) and
JAX's partitionable threefry over the element's global index
(``random.bernoulli``), so the masks are bitwise flax's.  A tensor-parallel
rank draws its heads' piece of the attention weights' mask, and a
data-parallel rank its rows' piece (``random.batch_rows``).

``nanogpt_plan`` is the reference's TP/SP plan for
``dmodule.parallelize_module``.  ``gpt_pipeline_units`` is the model as
pipeline stage units (``TokEmbed``, ``PosEmbed``, the blocks, ``FinalNorm``,
``TiedHead``) for ``pipe.construct_pipeline_stage``; as in the reference,
the units run their blocks deterministic (no dropout) at any rate.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .llama import Dense, Embed, _param

__all__ = ["GPTConfig", "LayerNorm", "Dropout", "CausalSelfAttention", "MLP", "Block", "GPT",
           "cross_entropy_loss", "nanogpt_plan", "TokEmbed", "PosEmbed", "FinalNorm",
           "TiedHead", "gpt_pipeline_units", "gpt_unit_params"]


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


def _dropout_mask(k, keep_prob: float, shape, device, global_offset, global_shape) -> torch.Tensor:
    """flax's mask: ``bernoulli(k, keep_prob)`` at each element's global
    index (the piece at ``global_offset`` of ``global_shape``)."""
    from .. import random as _random

    return _random.bernoulli(keep_prob, shape, key=k, device=device, global_offset=global_offset,
                             global_shape=global_shape)


class _DropoutRng(threading.local):
    key = None  # the "dropout" stream's key of the running GPT forward


_RNG = _DropoutRng()


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)`` at its flax path ``path`` (set by
    ``GPT``): identity when ``deterministic`` or ``rate == 0``, zeros at
    ``rate == 1``, else ``where(keep, x / keep_prob, 0)`` (the divisor in
    ``x``'s dtype, as JAX's weak-typed ``x / keep_prob``) with ``keep`` the
    mask flax draws for this path's first ``make_rng`` in the forward.
    ``x`` is the piece at ``global_offset`` of a ``global_shape`` tensor
    (default: the whole), offset on dim 0 by ``random.batch_rows``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.path = ()

    def forward(self, x, deterministic: bool = True, global_offset=None, global_shape=None):
        if self.rate == 0.0 or deterministic:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if _RNG.key is None:
            raise ValueError(f"Dropout {'.'.join(self.path)} needs the 'dropout' rng: call the "
                             "GPT with rngs={'dropout': key} when deterministic=False")
        from .. import random as _random

        goff = list(global_offset) if global_offset is not None else [0] * x.dim()
        gshape = list(global_shape) if global_shape is not None else list(x.shape)
        rows = _random.current_batch_rows()
        if rows is not None:
            goff[0] += rows[0]
            gshape[0] = rows[1]
        keep_prob = 1.0 - self.rate
        keep = _dropout_mask(_random.make_rng(_RNG.key, self.path), keep_prob, x.shape, x.device,
                             goff, gshape)
        kp = torch.tensor(keep_prob, dtype=x.dtype, device=x.device)
        return torch.where(keep, x / kp, torch.zeros_like(x))


class CausalSelfAttention(nn.Module):
    """Multi-head attention over the fused ``c_attn`` projection.  Under
    tensor parallelism ``c_attn`` is column-parallel on its fused (q | k |
    v) columns, whose pieces do not follow head boundaries: the pieces are
    all-gathered (reduce-scatter backward) and this rank keeps its
    ``c_proj`` rows' heads of q, k and v, so its head count is read from
    ``c_proj``'s local kernel."""

    _tp_region = True

    def __init__(self, c: GPTConfig, device=None):
        super().__init__()
        self.config = c
        self.c_attn = Dense(c.n_embd, 3 * c.n_embd, c.dtype, device, use_bias=c.bias)
        self.c_proj = Dense(c.n_embd, c.n_embd, c.dtype, device, use_bias=c.bias)
        # flax's auto-names on the dense branch: the weights', the output's
        self.Dropout_0 = Dropout(c.dropout)
        self.Dropout_1 = Dropout(c.dropout)

    def forward(self, x, deterministic: bool = True):
        c = self.config
        B, T, _ = x.shape
        E = c.n_embd
        hd = E // c.n_head
        El = self.c_proj.kernel.shape[0]  # this rank's q/k/v width
        H = El // hd
        qkv = self.c_attn(x)
        tp = self.c_attn.tp
        if tp is not None:
            from ..dmodule._comm import all_gather

            qkv = all_gather(qkv, tp, -1, True)
        q, k, v = qkv.split(E, dim=-1)
        if El != E:
            q, k, v = (t.narrow(-1, tp.rank * El, El) for t in (q, k, v))
        q, k, v = (t.reshape(B, T, H, hd) for t in (q, k, v))
        if c.dropout == 0.0 and c.use_flash_attention:
            from ..ops.flash_attention import flash_attention, flash_attention_sharded

            if tp is not None:
                y = flash_attention_sharded(q, k, v, tp.mesh, causal=True).reshape(B, T, El)
            else:
                y = flash_attention(q, k, v, causal=True).reshape(B, T, El)
            return self.c_proj(y)  # flax's Dropout at rate 0: the identity
        # the reference's dense branch, op by op in the compute dtype
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
        att = torch.where(mask, att, torch.full_like(att, torch.finfo(att.dtype).min))
        att = torch.softmax(att, dim=-1)
        # this rank's heads of the (B, n_head, T, T) weights
        h0 = tp.rank * H if El != E else 0
        att = self.Dropout_0(att, deterministic, global_offset=(0, h0, 0, 0),
                             global_shape=(B, c.n_head, T, T))
        y = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, T, El)
        return self.Dropout_1(self.c_proj(y), deterministic)


class MLP(nn.Module):
    """``c_proj(gelu(c_fc(x)))`` with the tanh GELU, in the compute dtype;
    column- then row-parallel under tensor parallelism."""

    _tp_region = True

    def __init__(self, c: GPTConfig, device=None):
        super().__init__()
        self.c_fc = Dense(c.n_embd, 4 * c.n_embd, c.dtype, device, use_bias=c.bias)
        self.c_proj = Dense(4 * c.n_embd, c.n_embd, c.dtype, device, use_bias=c.bias)
        self.Dropout_0 = Dropout(c.dropout)

    def forward(self, x, deterministic: bool = True):
        return self.Dropout_0(self.c_proj(F.gelu(self.c_fc(x), approximate="tanh")), deterministic)


class Block(nn.Module):
    def __init__(self, c: GPTConfig, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(c.n_embd, c.bias, c.dtype, device)
        self.attn = CausalSelfAttention(c, device)
        self.ln_2 = LayerNorm(c.n_embd, c.bias, c.dtype, device)
        self.mlp = MLP(c, device)

    def forward(self, x, deterministic: bool = True):
        x = x + self.attn(self.ln_1(x), deterministic)
        return x + self.mlp(self.ln_2(x), deterministic)


class GPT(nn.Module):
    """The flax ``GPT``: token ids (B, T) to logits (B, T, vocab) in
    ``config.dtype``.  Parameters are fp32, on ``device`` (default: the
    card), from ``params`` (a flax-layout tree, e.g. ``init_params`` or
    ``params_from_jax``, copied in) or else ``init_params(config, seed)``.
    The head is tied to ``wte``: one fp32 master, whose gradient sums the
    lookup's and the head's.  ``forward(idx, deterministic=True,
    rngs=None)``: with ``deterministic=False`` the dropout sites draw from
    ``rngs["dropout"]`` (a ``random`` key), as flax's ``apply(...,
    rngs=...)`` does."""

    def __init__(self, config: GPTConfig, params=None, *, device=None, seed: int = 0):
        super().__init__()
        c = config
        self.config = c
        dev = resolve_device(device)
        self.wte = Embed(c.vocab_size, c.n_embd, c.dtype, dev)
        self.wpe = Embed(c.block_size, c.n_embd, c.dtype, dev)
        for i in range(c.n_layer):
            self.add_module(f"h_{i}", Block(c, dev))
        self.ln_f = LayerNorm(c.n_embd, c.bias, c.dtype, dev)
        self.Dropout_0 = Dropout(c.dropout)
        for name, m in self.named_modules():
            if isinstance(m, Dropout):  # flax's scope path of each site
                m.path = tuple(name.split("."))
        from .convert import init_params, load_params

        if params is None:
            params = init_params(c, seed, device=dev, dtype=torch.float32)
        load_params(self, params)

    def forward(self, idx, deterministic: bool = True, rngs=None):
        c = self.config
        T = idx.shape[1]
        if T > c.block_size:
            raise ValueError(f"sequence of {T} tokens exceeds block_size {c.block_size}")
        from .. import random as _random

        prev = _RNG.key
        _RNG.key = (_random.as_key(rngs["dropout"])
                    if not deterministic and rngs and "dropout" in rngs else None)
        try:
            x = self.wte(idx) + self.wpe(torch.arange(T, device=idx.device))[None]
            x = self.Dropout_0(x, deterministic)
            for i in range(c.n_layer):
                x = getattr(self, f"h_{i}")(x, deterministic)
            return self.wte.attend(self.ln_f(x))
        finally:
            _RNG.key = prev


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Token-level cross entropy, fp32: logsumexp minus the gold logit,
    mean over every token."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def nanogpt_plan(mesh, sequence_parallel: bool = True):
    """TP/SP sharding plan over mesh dims ("dp", "tp") (reference
    ``models/nanogpt.py::nanogpt_plan``, after
    legacy/examples/nanogpt_4D_finetune/sharding_plan.py:23-70), with the
    reference's regexes: column-parallel c_attn/c_fc, row-parallel c_proj,
    hidden-sharded embeddings, LayerNorms replicated; batch over dp, the
    LayerNorm regions sequence-parallel, attn/mlp tensor-parallel."""
    from ..placements import Shard, plan_axes

    S = Shard
    col = plan_axes(mesh, tp=S(1))
    # column-parallel bias and row-parallel kernel both shard tensor dim 0 on tp
    row = plan_axes(mesh, tp=S(0))
    col_b = row
    rep = plan_axes(mesh)
    dp_only = plan_axes(mesh, dp=S(0))  # activations (B, T, E): batch over dp
    seq_par = plan_axes(mesh, dp=S(0), tp=S(1)) if sequence_parallel else dp_only
    param_plan = {
        r"wte\.embedding": col,
        r"wpe\.embedding": col,
        r"h_\d+\.attn\.c_attn\.kernel": col,
        r"h_\d+\.attn\.c_attn\.bias": col_b,
        r"h_\d+\.attn\.c_proj\.kernel": row,
        r"h_\d+\.attn\.c_proj\.bias": rep,
        r"h_\d+\.mlp\.c_fc\.kernel": col,
        r"h_\d+\.mlp\.c_fc\.bias": col_b,
        r"h_\d+\.mlp\.c_proj\.kernel": row,
        r"h_\d+\.mlp\.c_proj\.bias": rep,
        # LayerNorm scales/biases replicated (their grads summed by grad sync)
        r".*ln_\d*\.(scale|bias)": rep,
        r".*": rep,
    }
    fwd_plan = {
        r"": {"input": [dp_only], "output": [dp_only]},
        r"h_\d+\.ln_[12]": {"input": [seq_par], "output": [seq_par]},
        r"h_\d+\.attn": {"input": [dp_only], "output": [dp_only]},
        r"h_\d+\.mlp": {"input": [dp_only], "output": [dp_only]},
        r"ln_f": {"input": [seq_par], "output": [dp_only]},
    }
    return {"parameter": param_plan, "forward": fwd_plan}


# ---------------------------------------------------------------- pipeline
class TokEmbed(nn.Module):
    """Token embedding unit (pipeline stage granularity)."""

    def __init__(self, c: GPTConfig, device=None):
        super().__init__()
        self.wte = Embed(c.vocab_size, c.n_embd, c.dtype, device)

    def forward(self, idx):
        return self.wte(idx)


class PosEmbed(nn.Module):
    """``x`` plus the position embedding, as ``GPT.forward`` adds it."""

    def __init__(self, c: GPTConfig, device=None):
        super().__init__()
        self.wpe = Embed(c.block_size, c.n_embd, c.dtype, device)

    def forward(self, x):
        T = x.shape[1]
        return x + self.wpe(torch.arange(T, device=x.device))[None]


class FinalNorm(nn.Module):
    def __init__(self, c: GPTConfig, device=None):
        super().__init__()
        self.ln_f = LayerNorm(c.n_embd, c.bias, c.dtype, device)

    def forward(self, x):
        return self.ln_f(x)


class TiedHead(nn.Module):
    """LM head tied to the token embedding: the parameter tree of
    ``TokEmbed``, so a pipeline shared group can alias them (reference
    build_shared_module_group, pipe_stage.py:311)."""

    def __init__(self, c: GPTConfig, device=None):
        super().__init__()
        self.wte = Embed(c.vocab_size, c.n_embd, c.dtype, device)

    def forward(self, x):
        return self.wte.attend(x)


def gpt_pipeline_units(config: GPTConfig, device="meta"):
    """Ordered stage units for PP: [wte*, wpe, h_0..h_{L-1}, ln_f, head*]
    (* = the tied "embeddings" shared group).  The units are templates
    (on ``meta`` by default): the parameters travel in the per-group trees
    of ``PipeModule.init_all`` or :func:`gpt_unit_params`.  Feed them to
    ``pipe.construct_pipeline_stage``."""
    from ..pipe.pipe_stage import StageUnit

    dev = torch.device(device)
    units = [
        StageUnit("wte", TokEmbed(config, dev), shared_group="embeddings"),
        StageUnit("wpe", PosEmbed(config, dev)),
    ]
    units += [StageUnit(f"h_{i}", Block(config, dev)) for i in range(config.n_layer)]
    units += [
        StageUnit("ln_f", FinalNorm(config, dev)),
        StageUnit("head", TiedHead(config, dev), shared_group="embeddings"),
    ]
    return units


def gpt_unit_params(params, n_layer: int):
    """A ``GPT`` parameter tree as ``{unit_name: tree}`` for
    :func:`gpt_pipeline_units` (``PipeModule.partition_params``): the
    leaves themselves, not copies; ``wte`` serves both tied units."""
    out = {"wte": {"wte": params["wte"]}, "wpe": {"wpe": params["wpe"]}}
    out.update({f"h_{i}": params[f"h_{i}"] for i in range(n_layer)})
    out["ln_f"] = {"ln_f": params["ln_f"]}
    out["head"] = {"wte": params["wte"]}
    return out
