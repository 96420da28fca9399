"""Mixtral — the sparse-MoE Llama variant.

The port of ``vescale_tpu/models/mixtral.py``: Llama blocks whose MLP is
``moe.MoEMLP`` (top-2 routed SwiGLU experts), built from the port's
``LlamaAttention``, ``RMSNorm``, ``Embed`` and ``Dense``.  Parameters carry
the flax paths (``layers_<i>.block_sparse_moe.{router,w_in,b_in,w_out,
b_out,w_gate}``) and the reference's dtypes: the expert leaves in
``config.dtype`` (bf16 by default), every other leaf fp32, each layer
computing in ``config.dtype``.  After a forward each block's router aux
loss, still attached to the graph, is ``block.router_aux`` and
``Mixtral.router_aux_losses()`` lists them (the reference's
``sow("losses", "router_aux")``); the logits alone are the output, so a
loss that wants the aux adds it.

``mixtral_plan`` is the reference's TP + EP plan: the experts ``Shard(0)``
over "ep", attention tensor-parallel over "tp" when the mesh has it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import torch
from torch import nn

from ..device import resolve_device
from ..moe.layer import MoEConfig, MoEMLP
from .llama import Dense, Embed, LlamaAttention, LlamaConfig, RMSNorm

__all__ = ["MixtralConfig", "MixtralBlock", "Mixtral", "mixtral_plan", "MIXTRAL_8X7B"]


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    capacity_factor: float = 2.0
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 1000000.0
    dtype: Any = torch.bfloat16

    def as_llama(self) -> LlamaConfig:
        return LlamaConfig(
            vocab_size=self.vocab_size,
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            max_position_embeddings=self.max_position_embeddings,
            rms_norm_eps=self.rms_norm_eps,
            rope_theta=self.rope_theta,
            dtype=self.dtype,
        )

    def moe(self) -> MoEConfig:
        return MoEConfig(
            num_experts=self.num_local_experts,
            d_model=self.hidden_size,
            d_ff=self.intermediate_size,
            top_k=self.num_experts_per_tok,
            capacity_factor=self.capacity_factor,
            swiglu=True,  # HF Mixtral expert convention (w1/w3/w2)
            dtype=self.dtype,
        )


MIXTRAL_8X7B = MixtralConfig()


class MixtralBlock(nn.Module):
    def __init__(self, c: MixtralConfig, device=None):
        super().__init__()
        lc = c.as_llama()
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, c.dtype, device)
        self.self_attn = LlamaAttention(lc, device)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, c.dtype, device)
        self.block_sparse_moe = MoEMLP(c.moe(), device)
        self.router_aux = None

    def forward(self, x, positions):
        x = x + self.self_attn(self.input_layernorm(x), positions)
        y, self.router_aux = self.block_sparse_moe(self.post_attention_layernorm(x))
        return x + y


class Mixtral(nn.Module):
    """The flax ``Mixtral``: token ids (B, T) to logits (B, T, vocab) in
    ``config.dtype``, on ``device`` (default: the card), the parameters
    from ``params`` (a flax-layout tree, copied in) or else
    ``init_params(config, seed)``."""

    def __init__(self, config: MixtralConfig, params=None, *, device=None, seed: int = 0):
        super().__init__()
        c = self.config = config
        dev = resolve_device(device)
        self.embed_tokens = Embed(c.vocab_size, c.hidden_size, c.dtype, dev)
        for i in range(c.num_hidden_layers):
            self.add_module(f"layers_{i}", MixtralBlock(c, dev))
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps, c.dtype, dev)
        self.lm_head = Dense(c.hidden_size, c.vocab_size, c.dtype, dev)
        from .convert import init_params, load_params

        if params is None:
            params = init_params(c, seed, device=dev)
        load_params(self, params)

    def blocks(self) -> List[MixtralBlock]:
        return [getattr(self, f"layers_{i}") for i in range(self.config.num_hidden_layers)]

    def router_aux_losses(self) -> List[torch.Tensor]:
        """Each block's router aux loss of the last forward (in the graph)."""
        return [b.router_aux for b in self.blocks()]

    def forward(self, idx, deterministic: bool = True, rngs=None):
        # flax's ``__call__`` arguments; the Mixtral draws no randomness
        B, T = idx.shape
        x = self.embed_tokens(idx)
        positions = torch.arange(T, device=idx.device)[None, :].expand(B, T)
        for block in self.blocks():
            x = block(x, positions)
        return self.lm_head(self.norm(x))


def mixtral_plan(mesh, ep_dim: str = "ep", sequence_parallel: bool = False):
    """TP + EP plan over mesh dims ("dp", "ep"/"tp", ...) (reference
    ``models/mixtral.py::mixtral_plan``, after legacy
    mixtral_4D_benchmark/sharding_plan.py): the experts Shard(0) over
    ``ep_dim``, the router replicated; attention, the embedding and the
    head tensor-parallel over "tp" when the mesh has it."""
    from ..placements import Replicate, Shard

    R, S = Replicate(), Shard
    names = mesh.mesh_dim_names
    has_tp = "tp" in names

    def pl(**kw):
        out = [R] * mesh.ndim
        for dim_name, shard in kw.items():
            if dim_name in names:
                out[names.index(dim_name)] = shard
        return out

    dp_only = pl(dp=S(0))
    param_plan = {
        r".*block_sparse_moe\.(w_in|w_out|w_gate|b_in|b_out)": pl(**{ep_dim: S(0)}),
        r".*block_sparse_moe\.router": [R] * mesh.ndim,
    }
    if has_tp:
        param_plan.update(
            {
                r"layers_\d+\.self_attn\.(q_proj|k_proj|v_proj)\.kernel": pl(tp=S(1)),
                r"layers_\d+\.self_attn\.o_proj\.kernel": pl(tp=S(0)),
                r"embed_tokens\.embedding": pl(tp=S(1)),
                r"lm_head\.kernel": pl(tp=S(1)),
            }
        )
    param_plan[r".*"] = [R] * mesh.ndim
    fwd_plan = {r"": {"input": [dp_only], "output": [dp_only]}}
    if sequence_parallel and has_tp:
        seq_par = pl(dp=S(0), tp=S(1))
        fwd_plan.update(
            {
                r"layers_\d+\.(input_layernorm|post_attention_layernorm)": {
                    "input": [seq_par],
                    "output": [seq_par],
                },
                r"layers_\d+\.self_attn": {"input": [dp_only], "output": [dp_only]},
                r"layers_\d+\.block_sparse_moe": {"input": [dp_only], "output": [dp_only]},
                r"norm": {"input": [seq_par], "output": [dp_only]},
            }
        )
    return {"parameter": param_plan, "forward": fwd_plan}
