"""Serve engine — prefill and decode steps over the paged KV cache.

The port of ``vescale_tpu/serve/engine.py::ServeEngine``: a llama-family
forward over the flax-layout parameter tree (``models/convert.py``), in
PyTorch on one device.

  **prefill** — the prompt padded to the cache's ``max_seq_len`` runs the
  full stack once, as the JAX engine does, with flash attention
  (``ops.flash_attention``: the CUDA kernel on the card) in every layer.
  Each layer's K/V is written straight into the slot's reserved pages, in
  place.  The layer stack is cut into ``num_stages`` segments with the
  pipe engine's stage split, as in the JAX engine.

  **decode** — one token per slot: project q/k/v at the slot's length,
  write k/v in place into the page the slot's table maps that position to,
  then paged attention (``kernels.paged_decode``: the CUDA kernel on the
  card) straight from the pool.  Slots that are not decoding compute too
  (the batch keeps its shape) but write only the reserved null page, and
  their logits are ignored.

Decode is a deterministic function of (params, prompt, cache geometry): a
slot's result depends on its own tokens only, so a request replayed in any
slot and any pages regenerates the same tokens.

Not in this slice: ``decode_multi`` and ``prefill_suffix`` (prefix cache
and speculative decoding), ``decode_flops_per_step``, and the rollout
canary's faultsim hook in ``replay_greedy``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels.paged_attention import paged_decode
from ..models.llama import rmsnorm, rotary
from ..ops.flash_attention import flash_attention
from ..pipe.pipe_stage import _cuts_by_weight
from .kv_cache import PagedKVCache

__all__ = ["ServeEngine", "stack_params_check"]


def stack_params_check(params: Dict[str, Any], num_layers: int) -> None:
    """The engine consumes the UNSTACKED per-layer layout (``layers_i.*``);
    a ``scan_layers`` checkpoint (stacked ``layers.block.*``) must be
    unstacked first — fail with the fix named, not a KeyError."""
    if "layers_0" not in params:
        if "layers" in params:
            raise ValueError(
                "params use the scan_layers stacked layout (layers.block.*); "
                "serve the unstacked layout (LlamaConfig.scan_layers=False) or "
                "unstack the leading layer axis before building ServeEngine"
            )
        raise ValueError("params have no layers_0 — not a llama-family tree")
    for l in range(num_layers):
        if f"layers_{l}" not in params:
            raise ValueError(f"params missing layers_{l} (num_hidden_layers={num_layers})")


def _as_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    """Accept {"params": tree} bundles or the bare tree."""
    if isinstance(params, dict) and "params" in params and "embed_tokens" not in params:
        return params["params"]
    return params


def _leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += [(f"{k}.{p}" if p else k, t) for p, t in _leaves(tree[k])]
        return out
    return [("", tree)]


class ServeEngine:
    """Prefill/decode over ``cache``.  ``config`` is the model's
    ``LlamaConfig``; ``params`` the nested dict of tensors in the flax
    layout.  Leaves not on ``device`` (default: the card) are copied there
    once, at construction."""

    def __init__(
        self,
        config,
        params: Dict[str, Any],
        cache: PagedKVCache,
        *,
        num_stages: int = 1,
        device=None,
    ):
        c = config
        self.device = resolve_device(device)
        if cache.device != self.device:
            raise ValueError(f"cache lives on {cache.device}, engine on {self.device}")
        if cache.config.layers != c.num_hidden_layers:
            raise ValueError(
                f"cache has {cache.config.layers} layers, model {c.num_hidden_layers}"
            )
        if cache.config.kv_heads != c.num_key_value_heads:
            raise ValueError(
                f"cache has {cache.config.kv_heads} kv heads, model {c.num_key_value_heads}"
            )
        if cache.config.head_dim != c.head_dim:
            raise ValueError(f"cache head_dim {cache.config.head_dim} != model {c.head_dim}")
        if not (1 <= num_stages <= c.num_hidden_layers):
            raise ValueError(f"num_stages={num_stages} for {c.num_hidden_layers} layers")
        self.config = c
        self.cache = cache
        self.num_stages = num_stages
        params = _as_tree(params)
        stack_params_check(params, c.num_hidden_layers)
        self.params = self._place(params)
        self.stage_bounds = self._stage_bounds(num_stages)
        self._positions = torch.arange(cache.max_seq_len, device=self.device)[None, :]
        self._scale = 1.0 / math.sqrt(c.head_dim)

    # ------------------------------------------------------------- params
    def _place(self, tree):
        if isinstance(tree, dict):
            return {k: self._place(v) for k, v in tree.items()}
        return torch.as_tensor(tree).to(self.device)

    def swap_params(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Hot-swap the weight tree: a tree with identical structure, shapes
        and dtypes slots straight in.  Returns the PRIOR tree (the rollback
        handle).  Incompatible trees raise before anything is touched."""
        new = _as_tree(params)
        stack_params_check(new, self.config.num_hidden_layers)
        new = self._place(new)
        old_leaves, new_leaves = _leaves(self.params), _leaves(new)
        if [p for p, _ in old_leaves] != [p for p, _ in new_leaves]:
            raise ValueError(
                "swap_params: new tree structure differs from the serving tree "
                "(rebuild the engine instead)"
            )
        for (path, o), (_, n) in zip(old_leaves, new_leaves):
            if o.shape != n.shape or o.dtype != n.dtype:
                raise ValueError(
                    f"swap_params: leaf {path} {tuple(n.shape)}/{n.dtype} vs serving "
                    f"{tuple(o.shape)}/{o.dtype}"
                )
        old, self.params = self.params, new
        return old

    def _stage_bounds(self, num_stages: int) -> List[Tuple[int, int]]:
        """Contiguous layer ranges balanced by param count — the pipe
        engine's stage-split math over the decoder stack."""
        L = self.config.num_hidden_layers
        if num_stages == 1:
            return [(0, L)]
        weights = [
            float(sum(t.numel() for _, t in _leaves(self.params[f"layers_{l}"])))
            for l in range(L)
        ]
        bounds = []
        lo = 0
        for cut in list(_cuts_by_weight(weights, num_stages)) + [L]:
            bounds.append((lo, cut))
            lo = cut
        return bounds

    # ------------------------------------------------------------ the math
    def _dense(self, x, kernel):
        dtype = self.config.dtype
        return x.to(dtype) @ kernel.to(dtype)

    def _embed(self, tokens):
        return self.params["embed_tokens"]["embedding"][tokens].to(self.config.dtype)

    def _head(self, x):
        c = self.config
        xn = rmsnorm(x, self.params["norm"]["weight"], c.rms_norm_eps).to(c.dtype)
        if c.tie_word_embeddings:
            logits = xn @ self.params["embed_tokens"]["embedding"].to(c.dtype).T
        else:
            logits = self._dense(xn, self.params["lm_head"]["kernel"])
        return logits.float()

    def _mlp(self, lp, x):
        c = self.config
        xn2 = rmsnorm(x, lp["post_attention_layernorm"]["weight"], c.rms_norm_eps).to(c.dtype)
        g = self._dense(xn2, lp["mlp"]["gate_proj"]["kernel"])
        u = self._dense(xn2, lp["mlp"]["up_proj"]["kernel"])
        return x + self._dense(F.silu(g) * u, lp["mlp"]["down_proj"]["kernel"])

    def _qkv(self, lp, x, B, T):
        c = self.config
        H, KV, hd = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        xn = rmsnorm(x, lp["input_layernorm"]["weight"], c.rms_norm_eps).to(c.dtype)
        q = self._dense(xn, lp["self_attn"]["q_proj"]["kernel"]).reshape(B, T, H, hd)
        k = self._dense(xn, lp["self_attn"]["k_proj"]["kernel"]).reshape(B, T, KV, hd)
        v = self._dense(xn, lp["self_attn"]["v_proj"]["kernel"]).reshape(B, T, KV, hd)
        return q, k, v

    # ---------------------------------------------------------------- API
    @torch.no_grad()
    def prefill(self, prompt: Sequence[int], slot: int) -> np.ndarray:
        """Run the prompt through the stack, write its K/V into ``slot``'s
        reserved pages, and return the next-token logits (fp32, host).  The
        prompt is padded to ``max_seq_len``, so every prefill has one
        shape."""
        c = self.config
        cache = self.cache
        n = len(prompt)
        if not (0 < n <= cache.max_seq_len):
            raise ValueError(f"prompt length {n} not in (0, {cache.max_seq_len}]")
        Tmax = cache.max_seq_len
        page, Pmax = cache.config.page_size, cache.config.pages_per_slot
        KV, hd = c.num_key_value_heads, c.head_dim
        toks = np.zeros((Tmax,), np.int64)
        toks[:n] = np.asarray(prompt, np.int64)
        x = self._embed(torch.from_numpy(toks).to(self.device))[None]
        # table entries past the reserved pages are 0: the null page takes
        # the padding's K/V, racing writes nobody reads
        page_row = torch.from_numpy(cache.page_table[slot].astype(np.int64)).to(self.device)
        for lo, hi in self.stage_bounds:
            for l in range(lo, hi):
                lp = self.params[f"layers_{l}"]
                q, k, v = self._qkv(lp, x, 1, Tmax)
                q, k = rotary(q, k, self._positions, c.rope_theta)
                y = flash_attention(q, k, v, causal=True).reshape(1, Tmax, -1)
                x = x + self._dense(y, lp["self_attn"]["o_proj"]["kernel"])
                x = self._mlp(lp, x)
                cache.k[l, page_row] = k[0].reshape(Pmax, page, KV, hd).to(cache.dtype)
                cache.v[l, page_row] = v[0].reshape(Pmax, page, KV, hd).to(cache.dtype)
        logits = self._head(x[:, n - 1])[0]
        return logits.cpu().numpy()

    @torch.no_grad()
    def decode(self, tokens: np.ndarray) -> np.ndarray:
        """One decode step for every slot (slots not decoding write only the
        null page): appends each token's K/V at its slot's current length
        and returns (num_slots, vocab) fp32 logits for the NEXT position.
        Callers advance lengths via ``cache.advance`` for slots whose token
        was real."""
        c = self.config
        cache = self.cache
        S = cache.num_slots
        page, Pmax = cache.config.page_size, cache.config.pages_per_slot
        dev = self.device
        table = torch.from_numpy(cache.table_array()).to(dev)
        lengths = torch.from_numpy(cache.lengths_array()).to(dev)
        toks = torch.from_numpy(np.asarray(tokens, np.int64).reshape(S)).to(dev)
        x = self._embed(toks)  # (S, E)
        pos = lengths  # write position of the new token
        # capacity guard: a position past the slot's reserved pages writes
        # the reserved null page instead of aliasing a live page, and so
        # does an uncommitted slot (length 0)
        valid = (pos < Pmax * page) & (lengths > 0)
        safe = torch.where(valid, pos, torch.zeros_like(pos)).long()
        pg = torch.gather(table, 1, (safe // page)[:, None])[:, 0].long()
        pg = torch.where(valid, pg, torch.zeros_like(pg))
        off = safe % page
        attend_len = (pos + 1).to(torch.int32)
        for l in range(c.num_hidden_layers):
            lp = self.params[f"layers_{l}"]
            q, k, v = self._qkv(lp, x, S, 1)
            q, k = rotary(q, k, pos[:, None], c.rope_theta)
            kl, vl = cache.k[l], cache.v[l]
            kl[pg, off] = k[:, 0].to(cache.dtype)
            vl[pg, off] = v[:, 0].to(cache.dtype)
            y = paged_decode(q[:, 0].contiguous(), kl, vl, table, attend_len, scale=self._scale)
            y = y.reshape(S, -1).to(c.dtype)
            x = x + self._dense(y, lp["self_attn"]["o_proj"]["kernel"])
            x = self._mlp(lp, x)
        return self._head(x).cpu().numpy()

    def replay_greedy(self, prompt: Sequence[int], max_new_tokens: int,
                      *, eos_id: Optional[int] = None) -> List[int]:
        """Standalone greedy generation through the CURRENT weights on a
        temporarily allocated slot; the slot is freed before returning."""
        cache = self.cache
        slot = cache.alloc(len(prompt), max_new_tokens)
        try:
            row = self.prefill(list(prompt), slot)
            cache.commit_prefill(slot, len(prompt))
            out: List[int] = []
            tok = self.greedy(row)
            out.append(tok)
            for _ in range(max_new_tokens - 1):
                if eos_id is not None and tok == eos_id:
                    break
                toks = np.zeros((cache.num_slots,), np.int64)
                toks[slot] = tok
                logits = self.decode(toks)
                cache.advance(slot)
                tok = self.greedy(logits[slot])
                out.append(tok)
            return out
        finally:
            cache.free(slot)

    @staticmethod
    def greedy(logits_row: np.ndarray) -> int:
        """Deterministic greedy sample (ties break to the lowest id)."""
        return int(np.argmax(logits_row))
