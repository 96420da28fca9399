"""LLaMA family — configuration, the per-token math, and the training model.

The port of ``vescale_tpu/models/llama.py``: the same ``LlamaConfig``
fields and presets, RMSNorm with fp32 math, split-half rotary embeddings
with fp32 phases, and the model as ``nn.Module``s (``RMSNorm``, ``Dense``,
``Embed``, ``LlamaAttention``, ``LlamaMLP``, ``LlamaBlock``, ``Llama``)
whose parameters carry the flax paths: ``dict(model.named_parameters())``
has exactly the keys of the flattened flax ``params`` tree, with kernels in
flax's (in, out) layout.  As in flax, parameters are fp32 master weights
and every layer computes in ``config.dtype`` (``Dense``: both operands cast,
then the product; ``Embed``: the table cast, then gathered; ``RMSNorm``:
fp32 math, then the result cast).  Attention runs
``ops.flash_attention`` (the CUDA kernels on the card), GQA without
repeating K/V.  The serve engine keeps its own functional forward over the
same parameter tree.

``llama_plan`` is the reference's TP/SP sharding plan for
``dmodule.parallelize_module``; a parallelized ``Llama`` computes on this
rank's weight pieces (``Dense``, ``Embed``, ``LlamaAttention``).

``remat`` with ``remat_scope`` "block" or "mlp" checkpoints through
``torch.utils.checkpoint``; ``remat_policy`` names a
``jax.checkpoint_policies`` entry, mapped onto selective checkpointing
(``REMAT_POLICIES``).  ``scan_layers`` keeps the block parameters stacked
under ``layers.block.*`` with a leading (L,) axis, the flax ``nn.scan``
layout, and the forward runs one layer's slice each iteration.
``use_fp8`` runs the seven block projections (q, k, v, o, gate, up, down)
through ``quant.fp8.Fp8DirectDotGeneralOp``, flax's delayed-scaling fp8
op: each ``Dense`` holds the op's six state leaves as buffers named as
flax's ``_overwrite_with_gradient`` collection names them, and on the card
its three products run on Hopper's fp8 tensor cores (``torch._scaled_mm``);
the embedding and ``lm_head`` stay in ``dtype``.  ``make_train_step``
overwrites the leaves with their gradients.  Such a model takes the
two-collection bundle ``{"params": ..., "_overwrite_with_gradient":
...}`` (``init_params`` and ``params_from_jax`` give one).
``LlamaEmbed`` and ``LlamaHead`` are the pipeline's first and last units.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..telemetry.costaudit import _MATMUL_LHS

__all__ = [
    "LlamaConfig",
    "rmsnorm",
    "rotary",
    "RMSNorm",
    "Dense",
    "Embed",
    "LlamaAttention",
    "LlamaMLP",
    "LlamaBlock",
    "Llama",
    "LlamaEmbed",
    "LlamaHead",
    "REMAT_POLICIES",
    "llama_plan",
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
    remat: bool = False
    # a jax.checkpoint_policies name (REMAT_POLICIES): with a policy only the
    # activations it does not save are recomputed; None = full remat
    remat_policy: Optional[str] = None
    remat_scope: str = "block"
    # block params stacked under layers.block.* with a leading (L,) axis
    scan_layers: bool = False
    # the block projections through the delayed-scaling fp8 op
    # (quant.fp8.Fp8DirectDotGeneralOp); its state is the model's buffers
    use_fp8: bool = False
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


# ------------------------------------------------------------ the modules
def _param(shape, device) -> nn.Parameter:
    """An fp32 master parameter, filled by ``Llama`` from ``init_params``
    or by ``convert.load_params``."""
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))


class RMSNorm(nn.Module):
    """flax ``RMSNorm``: fp32 math with the fp32 ``weight``, result in
    ``dtype``."""

    def __init__(self, features: int, eps: float, dtype, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = _param((features,), device)

    def forward(self, x):
        return rmsnorm(x, self.weight, self.eps).to(self.dtype)


def _tp_dense(x, kernel, bias, dtype, kind: str, tp):
    """A dense layer on this rank's kernel piece.  ``"col"``: kernel (in,
    out/tp) and bias (out/tp,), ``x`` entering tensor-parallel compute,
    the output Shard(-1).  ``"row"``: kernel (in/tp, out), ``x`` this
    rank's features (a full-width ``x`` is cut to them), the products
    summed over the dim, then the whole bias added once (the reference's
    ``linear.py:56``); the output Replicate."""
    from ..dmodule import _comm
    from ..placements import Shard

    if kind == "col":
        x = _comm.enter_tp(x, tp)
        y = x.to(dtype) @ kernel.to(dtype)
        if bias is not None:
            y = y + bias.to(dtype)
        return _comm.tag(y, tp.placements(Shard(y.ndim - 1)))
    if x.shape[-1] != kernel.shape[0]:
        x = _comm.take_piece(x, tp, -1)
    y = _comm.reduce_from_tp(x.to(dtype) @ kernel.to(dtype), tp)
    return y if bias is None else y + bias.to(dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` (in, out) and, with ``use_bias``,
    ``bias`` (out,); input, kernel and bias cast to ``dtype``, then the
    product, then the bias added (two roundings, as in flax).  A kernel
    sharded by ``parallelize_module`` makes it column-parallel
    (``Shard(1)``) or row-parallel (``Shard(0)``): ``_tp_dense``."""

    def __init__(self, features_in: int, features_out: int, dtype, device=None,
                 use_bias: bool = False, fp8: bool = False):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param((features_in, features_out), device)
        self.bias = _param((features_out,), device) if use_bias else None
        self.tp, self.tp_kind = None, None
        if fp8:
            from ..quant.fp8 import Fp8DirectDotGeneralOp

            # flax's auto-name of the op inside its Dense: the state's path
            self.Fp8DirectDotGeneralOp_0 = Fp8DirectDotGeneralOp(device)

    @property
    def fp8(self):
        """The fp8 op, or None."""
        return self._modules.get("Fp8DirectDotGeneralOp_0")

    def shard_param(self, name: str, placement, tp) -> None:
        """``parallelize_module``'s notice that ``name`` is now a piece."""
        if self.fp8 is not None:
            raise NotImplementedError("a tensor-parallel fp8 Dense is not ported")
        kind = {("kernel", 1): "col", ("kernel", 0): "row", ("bias", 0): "col"}.get(
            (name, getattr(placement, "dim", None)))
        if kind is None or (self.tp_kind not in (None, kind)):
            raise NotImplementedError(f"Dense.{name} as {placement} (kernel {self.tp_kind})")
        self.tp, self.tp_kind = tp, kind

    def forward(self, x):
        if self.tp is not None:
            return _tp_dense(x, self.kernel, self.bias, self.dtype, self.tp_kind, self.tp)
        if self.fp8 is not None:
            y = self.fp8(x.to(self.dtype), self.kernel.to(self.dtype))
        else:
            y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


def _vocab_lookup(idx, table, dtype, tp):
    """A vocab-sharded lookup: this rank's rows (ids outside them read
    zeros), summed over the dim."""
    from ..dmodule import _comm

    n = table.shape[0]
    lo = tp.rank * n
    hit = (idx >= lo) & (idx < lo + n)
    y = F.embedding(torch.where(hit, idx - lo, torch.zeros_like(idx)), table.to(dtype))
    return _comm.reduce_from_tp(y * hit[..., None].to(dtype), tp)


class Embed(nn.Module):
    """flax ``nn.Embed``: the table cast to ``dtype``, then gathered;
    ``attend`` is the tied head.  A table sharded by
    ``parallelize_module`` on the hidden dim (``Shard(1)``) looks up this
    rank's columns and all-gathers them (Replicate out), and ``attend``
    gives Partial logits; on the vocab dim (``Shard(0)``) the lookup is
    masked and summed, and ``attend`` gives vocab-sharded logits."""

    def __init__(self, num: int, features: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = _param((num, features), device)
        self.tp, self.tp_kind = None, None

    def shard_param(self, name: str, placement, tp) -> None:
        kind = {1: "hidden", 0: "vocab"}.get(getattr(placement, "dim", None))
        if kind is None:
            raise NotImplementedError(f"Embed.{name} as {placement}")
        self.tp, self.tp_kind = tp, kind

    def forward(self, idx):
        if self.tp is None:
            return F.embedding(idx, self.embedding.to(self.dtype))
        from ..dmodule import _comm

        if self.tp_kind == "vocab":
            return _vocab_lookup(idx, self.embedding, self.dtype, self.tp)
        y = F.embedding(idx, self.embedding.to(self.dtype))
        return _comm.all_gather(y, self.tp, -1, False)

    def attend(self, x):
        if self.tp is None:
            return x.to(self.dtype) @ self.embedding.to(self.dtype).T
        from ..dmodule import _comm
        from ..placements import Partial, Shard

        tp = self.tp
        if self.tp_kind == "vocab":
            y = _comm.enter_tp(x, tp).to(self.dtype) @ self.embedding.to(self.dtype).T
            return _comm.tag(y, tp.placements(Shard(y.ndim - 1)))
        y = _comm.take_piece(x, tp, -1).to(self.dtype) @ self.embedding.to(self.dtype).T
        return _comm.tag(y, tp.placements(Partial()))


class LlamaAttention(nn.Module):
    """Grouped-query attention.  Its head counts are read from its
    weights, so a tensor-parallel rank (column-parallel q/k/v, row-parallel
    o) attends over its own H/tp query and KV/tp kv heads."""

    _tp_region = True  # its input feeds column-parallel products

    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        self.config = c
        E, H, KV, hd = c.hidden_size, c.num_attention_heads, c.num_key_value_heads, c.head_dim
        f8 = c.use_fp8
        self.q_proj = Dense(E, H * hd, c.dtype, device, fp8=f8)
        self.k_proj = Dense(E, KV * hd, c.dtype, device, fp8=f8)
        self.v_proj = Dense(E, KV * hd, c.dtype, device, fp8=f8)
        self.o_proj = Dense(H * hd, E, c.dtype, device, fp8=f8)

    def forward(self, x, positions):
        c = self.config
        B, T, _ = x.shape
        hd = c.head_dim
        H, cols = self.q_proj.kernel.shape[1] // hd, self.k_proj.kernel.shape[1]
        tp = self.q_proj.tp
        whole = cols >= hd and cols % hd == 0 and H % (cols // hd) == 0
        if not whole and tp is None:
            raise ValueError(f"attention pieces of {H} query and {cols} key columns do not "
                             f"hold whole GQA groups of head_dim {hd}")
        if tp is not None:
            from ..dmodule._comm import enter_tp

            x = enter_tp(x, tp)  # once for q, k and v
        q = self.q_proj(x).reshape(B, T, H, hd)
        k, v = self.k_proj(x), self.v_proj(x)
        if not whole:  # fewer kv heads than ranks, or a group across ranks
            k, v = (self._kv_of_my_heads(t, tp, H, hd) for t in (k, v))
        KV = k.shape[-1] // hd
        k = k.reshape(B, T, KV, hd)
        v = v.reshape(B, T, KV, hd)
        q, k = rotary(q, k, positions, c.rope_theta)
        if c.use_flash_attention:
            from ..ops.flash_attention import flash_attention, flash_attention_sharded

            # GQA runs natively in the kernels: no repeated K/V
            if tp is not None:
                y = flash_attention_sharded(q, k, v, tp.mesh, causal=True)
            else:
                y = flash_attention(q, k, v, causal=True)
            y = y.reshape(B, T, H * hd)
        else:
            if KV != H:  # GQA: repeat kv heads for the dense einsum
                k = torch.repeat_interleave(k, H // KV, dim=2)
                v = torch.repeat_interleave(v, H // KV, dim=2)
            att = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
            mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
            att = torch.where(mask, att, torch.full_like(att, torch.finfo(torch.float32).min))
            att = torch.softmax(att, dim=-1).to(c.dtype)
            y = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, T, H * hd)
        return self.o_proj(y)

    @staticmethod
    def _kv_of_my_heads(t, tp, H: int, hd: int):
        """This rank's k or v columns (B, T, cols) when its pieces of the
        column-parallel k/v projection do not hold whole kv heads with
        their query groups, as GSPMD lets the reference cut them (KV = 2
        heads over tp = 4): all-gathered over "tp" (the backward sums the
        ranks' partial gradients and keeps this rank's columns), then the
        kv heads that this rank's H query heads read, in GQA order."""
        from ..dmodule._comm import all_gather

        full = all_gather(t, tp, -1, True)
        KV = full.shape[-1] // hd
        rep = H * tp.size // KV  # query heads a kv head serves
        if H % rep and rep % H:
            raise ValueError(f"{H} query heads a rank do not fall into whole GQA groups "
                             f"of {rep} query heads")
        first, last = tp.rank * H // rep, ((tp.rank + 1) * H - 1) // rep
        return full[..., first * hd:(last + 1) * hd]


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))`` in the compute dtype; under
    tensor parallelism on this rank's intermediate columns."""

    _tp_region = True

    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        E, Fi = c.hidden_size, c.intermediate_size
        f8 = c.use_fp8
        self.gate_proj = Dense(E, Fi, c.dtype, device, fp8=f8)
        self.up_proj = Dense(E, Fi, c.dtype, device, fp8=f8)
        self.down_proj = Dense(Fi, E, c.dtype, device, fp8=f8)

    def forward(self, x):
        if self.gate_proj.tp is not None:
            from ..dmodule._comm import enter_tp

            x = enter_tp(x, self.gate_proj.tp)  # once for gate and up
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        self.config = c
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, c.dtype, device)
        self.self_attn = LlamaAttention(c, device)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, c.dtype, device)
        self.mlp = LlamaMLP(c, device)

    def forward(self, x, positions):
        c = self.config
        x = x + self.self_attn(self.input_layernorm(x), positions)
        h = self.post_attention_layernorm(x)
        if c.remat and c.remat_scope == "mlp" and torch.is_grad_enabled():
            # the recompute runs in the backward, after a scanned layer's
            # ``functional_call`` has put the stacked leaves back: it takes
            # the tensors this forward saw
            state = {**dict(self.mlp.named_parameters()), **dict(self.mlp.named_buffers())}
            mlp = lambda t: torch.func.functional_call(self.mlp, state, (t,))
            return x + checkpoint(mlp, h, use_reentrant=False)
        return x + self.mlp(h)


# jax.checkpoint_policies names -> the matmuls whose outputs a selective
# checkpoint saves (the aten matmuls costaudit counts, but convolution).
# At dispatch a (B, T, E) @ (E, F) projection is one ``mm`` (no batch
# dims); attention's einsums are ``bmm`` (batched).  The flash kernel's
# custom op is no matmul: under every policy it is recomputed, as the
# Pallas call is under JAX's policies.
REMAT_POLICIES = {
    "dots_saveable": tuple(n for n in _MATMUL_LHS if n != "convolution"),
    "dots_with_no_batch_dims_saveable": ("mm", "addmm"),
    "nothing_saveable": (),
}


def _remat_context(policy: str):
    """The ``context_fn`` of a selective checkpoint that saves the outputs
    of ``policy``'s matmuls and recomputes everything else."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    if policy not in REMAT_POLICIES:
        raise NotImplementedError(
            f"remat_policy {policy!r} has no selective-checkpoint mapping in the port; "
            f"mapped: {sorted(REMAT_POLICIES)}")
    saved = REMAT_POLICIES[policy]

    def policy_fn(ctx, func, *args, **kwargs):
        name = getattr(getattr(func, "overloadpacket", None), "__name__", "")
        if name in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


class ScannedBlocks(nn.Module):
    """The ``scan_layers`` layout: one ``LlamaBlock`` template (``block``)
    whose every parameter (and fp8 state buffer) has a leading (L,) axis,
    as flax's ``nn.scan`` stacks them.  ``forward`` unbinds each leaf once
    (one stack in the backward) and runs layer i on the i-th slices."""

    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        self.num_layers = c.num_hidden_layers
        self.block = LlamaBlock(c, torch.device("meta"))
        L = c.num_hidden_layers
        for name, p in list(self.block.named_parameters()):
            *path, leaf = name.split(".")
            owner = self.block.get_submodule(".".join(path))
            setattr(owner, leaf, _param((L, *p.shape), device))
        # the fp8 state stacks on the same (L,) axis (flax's variable_axes)
        for name, b in list(self.block.named_buffers()):
            *path, leaf = name.split(".")
            stacked = b.new_empty((L, *b.shape), device=device)
            self.block.get_submodule(".".join(path)).register_buffer(
                leaf, stacked.requires_grad_(b.requires_grad))

    def layer_fn(self, params):
        """``(x, positions) -> block(x)`` on one layer's parameter slices."""
        return lambda x, positions: torch.func.functional_call(self.block, params,
                                                               (x, positions))

    def layer_params(self):
        names, leaves = zip(*self.block.named_parameters(), *self.block.named_buffers())
        slices = [t.unbind(0) for t in leaves]
        return [dict(zip(names, (s[i] for s in slices))) for i in range(self.num_layers)]


class Llama(nn.Module):
    """The flax ``Llama``: token ids (B, T) to logits (B, T, vocab) in
    ``config.dtype``.  Parameters are fp32, on ``device`` (default: the
    card), from ``params`` (a flax-layout tree, e.g. ``init_params`` or
    ``params_from_jax``, copied in) or else ``init_params(config, seed)``.
    With ``scan_layers`` the block parameters are ``layers.block.*``,
    stacked (L, ...).  With ``use_fp8`` ``params`` is the two-collection
    bundle and the fp8 state lives in the projections' buffers."""

    def __init__(self, config: LlamaConfig, params=None, *, device=None, seed: int = 0):
        super().__init__()
        c = config
        if c.remat and c.remat_policy:
            _remat_context(c.remat_policy)  # an unmapped name raises here
        self.config = c
        dev = resolve_device(device)
        self.embed_tokens = Embed(c.vocab_size, c.hidden_size, c.dtype, dev)
        if c.scan_layers:
            self.layers = ScannedBlocks(c, dev)
        else:
            for i in range(c.num_hidden_layers):
                self.add_module(f"layers_{i}", LlamaBlock(c, dev))
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps, c.dtype, dev)
        if not c.tie_word_embeddings:
            self.lm_head = Dense(c.hidden_size, c.vocab_size, c.dtype, dev)
        from .convert import init_params, load_params

        if params is None:
            params = init_params(c, seed, device=dev, dtype=torch.float32)
        load_params(self, params)

    def forward(self, idx, deterministic: bool = True, rngs=None):
        # ``deterministic`` and ``rngs`` are flax's ``__call__`` arguments:
        # the Llama draws no randomness, so both are unused
        c = self.config
        B, T = idx.shape
        x = self.embed_tokens(idx)
        positions = torch.arange(T, device=idx.device)[None, :].expand(B, T)
        remat_blocks = c.remat and c.remat_scope == "block" and torch.is_grad_enabled()
        kw = {}
        if remat_blocks and c.remat_policy:
            kw["context_fn"] = _remat_context(c.remat_policy)
        if c.scan_layers:
            blocks = [self.layers.layer_fn(p) for p in self.layers.layer_params()]
        else:
            blocks = [getattr(self, f"layers_{i}") for i in range(c.num_hidden_layers)]
        for block in blocks:
            if remat_blocks:
                x = checkpoint(block, x, positions, use_reentrant=False, **kw)
            else:
                x = block(x, positions)
        x = self.norm(x)
        if c.tie_word_embeddings:
            return self.embed_tokens.attend(x)
        return self.lm_head(x)


class LlamaEmbed(nn.Module):
    """Token-embedding pipeline unit (first-stage granularity; the legacy
    smallest_unsplittable_units for HF llama, pipe_parser.py)."""

    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        self.embed_tokens = Embed(c.vocab_size, c.hidden_size, c.dtype, device)

    def forward(self, idx):
        return self.embed_tokens(idx)


class LlamaHead(nn.Module):
    """Final-norm + LM-head pipeline unit (last-stage granularity)."""

    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps, c.dtype, device)
        self.lm_head = Dense(c.hidden_size, c.vocab_size, c.dtype, device)

    def forward(self, x):
        return self.lm_head(self.norm(x))


def llama_plan(mesh, sequence_parallel: bool = True, scanned: bool = False):
    """TP/SP plan (reference ``models/llama.py::llama_plan``, after
    legacy/examples/open_llama_4D_benchmark/sharding_plan.py): column-parallel
    q/k/v + gate/up, row-parallel o/down, hidden-sharded embedding,
    vocab-sharded head; RMSNorms replicated with SP activations.  The same
    regexes as the reference; shardings bind to the mesh dims *named*
    "dp"/"tp" (``plan_axes``), and the forward-plan regexes tolerate a
    missing ``layers_N.`` prefix.

    ``scanned=True`` targets the ``scan_layers`` layout: block leaves live
    under ``layers.block.*`` with a leading (L,) stack axis, so their tp
    Shard dims shift by one (embed and head are unstacked and keep
    theirs)."""
    from ..placements import Shard, plan_axes

    S = Shard
    off = 1 if scanned else 0
    col = plan_axes(mesh, tp=S(1))  # column-parallel kernel (in, out/tp)
    row = plan_axes(mesh, tp=S(0))  # row-parallel kernel (in/tp, out)
    bcol = plan_axes(mesh, tp=S(1 + off))  # block kernels (maybe stacked)
    brow = plan_axes(mesh, tp=S(0 + off))
    rep = plan_axes(mesh)
    dp_only = plan_axes(mesh, dp=S(0))
    seq_par = plan_axes(mesh, dp=S(0), tp=S(1)) if sequence_parallel else dp_only
    blk = r"(layers\.block\.)" if scanned else r"(layers_\d+\.)?"
    param_plan = {
        r"embed_tokens\.embedding": col,
        blk + r"self_attn\.(q_proj|k_proj|v_proj)\.kernel": bcol,
        blk + r"self_attn\.o_proj\.kernel": brow,
        blk + r"mlp\.(gate_proj|up_proj)\.kernel": bcol,
        blk + r"mlp\.down_proj\.kernel": brow,
        r"lm_head\.kernel": col,
        r".*layernorm\.weight": rep,
        r"norm\.weight": rep,
        r".*": rep,
    }
    fwd_plan = {
        r"": {"input": [dp_only], "output": [dp_only]},
        blk + r"(input_layernorm|post_attention_layernorm)": {
            "input": [seq_par],
            "output": [seq_par],
        },
        blk + r"self_attn": {"input": [dp_only], "output": [dp_only]},
        blk + r"mlp": {"input": [dp_only], "output": [dp_only]},
        r"norm": {"input": [seq_par], "output": [dp_only]},
    }
    return {"parameter": param_plan, "forward": fwd_plan}
