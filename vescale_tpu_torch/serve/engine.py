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
  their logits are ignored.  On the card the step is a CUDA graph, the
  port's counterpart of the JAX engine's compiled decode program: the
  first decode runs the step eagerly (loading the kernels and cuBLAS) and
  then captures it; every later decode copies the page table, lengths and
  tokens into the graph's input buffers, replays it and reads back its
  logits buffer.  ``swap_params`` and ``PagedKVCache.update`` replace
  tensors the graph reads by address, so either one drops the graph and
  the next decode captures it again.  A capture or replay that fails
  raises; nothing falls back to the eager step.  On the CPU the step stays
  eager (:meth:`ServeEngine.decode_eager`).

  **decode_multi** — ``W`` tokens per slot in one step (the speculative
  verify and the prefix cache's suffix prefill): the window's K/V is
  written into the pool first, then each slot's pages are gathered and
  token ``i`` attends positions ``<= lengths + i`` with an fp32 softmax.
  The JAX package computes this step outside any Pallas kernel, so it is
  plain PyTorch here too, eager.

**Tensor parallelism** — on a mesh whose dim named "tp" shards the pool's
kv heads (``PagedKVCache(..., mesh=)``, Shard(3) by default) each rank
holds the ``llama_plan`` pieces of the weights: ``DArray`` leaves laid out
by ``llama_plan`` are taken as they are, and replicated leaves (the JAX
package's own tp2 form: replicated weights over a Shard(3) pool) are cut
to those pieces at construction.  A rank embeds through its hidden columns
and all-gathers them, runs prefill (flash) and decode (paged) on its H/tp
query and KV/tp kv heads against its own pool piece, sums the
row-parallel o/down products over "tp" (all-reduce), and all-gathers the
vocab-sharded logits before the greedy argmax, so ties break as on one
device.  The decode step is a CUDA graph only when every collective in it
can be captured, i.e. when the "tp" group is NCCL; over gloo (several
ranks on one card) the step runs eagerly.  ``graphed`` reports the
choice, made from the mesh's backend at construction.

Decode is a deterministic function of (params, prompt, cache geometry): a
slot's result depends on its own tokens only, so a request replayed in any
slot and any pages regenerates the same tokens.  ``replay_greedy`` is the
weight rollout's canary replay; with ``canary=True`` it consults the
faultsim ``canary_diverge`` hook.
"""

from __future__ import annotations

import math
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels import LAUNCHES
from ..kernels.paged_attention import paged_decode
from ..models.llama import rmsnorm, rotary
from ..ops.flash_attention import flash_attention
from ..pipe.pipe_stage import _cuts_by_weight
from ..resilience import faultsim as _fs
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


_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture_stream(device) -> "torch.cuda.Stream":
    """One side stream per device for every capture: cuBLAS keeps a
    workspace for each stream it has run on, for the life of the process."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


class _DecodeGraph:
    """One captured decode step: its static input buffers (page table,
    lengths, tokens), its logits buffer, pinned host staging for each, the
    kernel launches it holds, and weak references to the pools it was
    captured over."""

    def __init__(self, engine: "ServeEngine"):
        cache = engine.cache
        dev = engine.device
        S, Pmax = cache.num_slots, cache.config.pages_per_slot
        self.table = torch.zeros((S, Pmax), dtype=torch.int32, device=dev)
        self.lengths = torch.zeros((S,), dtype=torch.int32, device=dev)
        self.tokens = torch.zeros((S,), dtype=torch.int64, device=dev)
        self.h_table = torch.zeros((S, Pmax), dtype=torch.int32).pin_memory()
        self.h_lengths = torch.zeros((S,), dtype=torch.int32).pin_memory()
        self.h_tokens = torch.zeros((S,), dtype=torch.int64).pin_memory()
        self.h_logits = None
        self.logits = None
        self.graph = torch.cuda.CUDAGraph()
        self.stream = _capture_stream(dev)
        self.launches: Dict[str, int] = {}
        self.pools = (weakref.ref(cache.k), weakref.ref(cache.v))

    def current(self, cache: PagedKVCache) -> bool:
        return self.pools[0]() is cache.k and self.pools[1]() is cache.v

    def load(self, cache: PagedKVCache, tokens: np.ndarray) -> None:
        """Stage the host state in pinned memory and copy it into the input
        buffers on the current stream (outside any capture)."""
        self.h_table.numpy()[:] = cache.page_table
        self.h_lengths.numpy()[:] = cache.lengths
        self.h_tokens.numpy()[:] = np.asarray(tokens, np.int64).reshape(-1)
        for dst, src in ((self.table, self.h_table), (self.lengths, self.h_lengths),
                         (self.tokens, self.h_tokens)):
            dst.copy_(src, non_blocking=True)

    def read(self) -> np.ndarray:
        self.h_logits.copy_(self.logits, non_blocking=True)
        torch.cuda.current_stream(self.logits.device).synchronize()
        return self.h_logits.numpy().copy()


class ServeEngine:
    """Prefill/decode over ``cache``.  ``config`` is the model's
    ``LlamaConfig``; ``params`` the nested dict of tensors in the flax
    layout.  Leaves not on ``device`` (default: the card) are copied there
    once, at construction.

    With ``mesh`` (a ``DeviceMesh``) the mesh's device is the engine's
    device (a different ``device`` raises), leaves may be ``DArray`` pieces
    on that mesh, and host leaves are replicated onto it once here, as the
    JAX engine does (``_replicate``).  When the cache's pool is sharded on
    the mesh's "tp" dim the engine runs tensor-parallel (module
    docstring): sharded leaves must be laid out as ``llama_plan`` lays
    them out."""

    def __init__(
        self,
        config,
        params: Dict[str, Any],
        cache: PagedKVCache,
        *,
        num_stages: int = 1,
        device=None,
        mesh=None,
    ):
        c = config
        self.mesh = mesh
        if mesh is not None:
            self.device = mesh.device
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"engine device {resolve_device(device)} is not the mesh's "
                                 f"device {self.device}")
        else:
            self.device = resolve_device(device)
        if cache.device != self.device:
            raise ValueError(f"cache lives on {cache.device}, engine on {self.device}")
        self.tp = None
        if cache.spec is not None:
            if mesh is None or cache.mesh != mesh:
                raise ValueError(f"the cache's pool lives on {cache.mesh}, the engine on {mesh}")
            from ..dmodule._comm import TPDim

            for i, p in enumerate(cache.spec.placements):
                if p.is_shard(3) and mesh.shape[i] > 1:
                    if mesh.dim_name(i) != "tp":
                        raise NotImplementedError(
                            f"kv heads sharded on mesh dim {mesh.dim_name(i)!r}: the engine "
                            "shards its weights as llama_plan does, on the dim named 'tp'")
                    self.tp = TPDim(mesh, i)
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
        self._specs = self._plan_specs()
        self.params = self._place(params)
        self.stage_bounds = self._stage_bounds(num_stages)
        self._positions = torch.arange(cache.max_seq_len, device=self.device)[None, :]
        self._scale = 1.0 / math.sqrt(c.head_dim)
        self._graph: Optional[_DecodeGraph] = None
        # a graph captures every collective of the step: NCCL ones only
        self.graphed = self.device.type == "cuda" and (
            self.tp is None or torch.distributed.get_backend(mesh.get_group(self.tp.index)) == "nccl")

    # ------------------------------------------------------------- params
    def _plan_specs(self) -> Dict[str, Any]:
        """Each weight path's ``llama_plan`` placements under tensor
        parallelism (empty without it)."""
        if self.tp is None:
            return {}
        from ..dmodule.api import _match
        from ..models.convert import _flatten, param_shapes
        from ..models.llama import llama_plan

        plan = llama_plan(self.mesh)["parameter"]
        return {path: _match(plan, path)[1] for path in _flatten(param_shapes(self.config))}

    def _place(self, tree, path: str = ""):
        if isinstance(tree, dict):
            return {k: self._place(v, f"{path}.{k}" if path else k) for k, v in tree.items()}
        from ..darray import DArray, distribute_tensor
        from ..placements import normalize_placements

        want = self._specs.get(path)
        if isinstance(tree, DArray):
            if self.mesh is not None and tree.mesh != self.mesh:
                raise ValueError(f"a weight lives on {tree.mesh}, the engine on {self.mesh}")
            if tree.spec.is_replicated() and want is not None:
                return distribute_tensor(tree.to_local(), self.mesh, want).to_local()
            if not tree.spec.is_replicated() and (
                    want is None or tree.placements != normalize_placements(
                        want, self.mesh.ndim, tree.ndim)):
                raise ValueError(f"{path}: placements {tree.placements}; the engine serves "
                                 "replicated weights or llama_plan's pieces over a Shard(3) pool")
            return tree.to_local().to(self.device)
        if self.mesh is not None:
            return distribute_tensor(torch.as_tensor(tree), self.mesh, want).to_local()
        return torch.as_tensor(tree).to(self.device)

    def swap_params(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Hot-swap the weight tree: a tree with identical structure, shapes
        and dtypes slots straight in.  Returns the PRIOR tree (the rollback
        handle; under tensor parallelism as this rank's ``llama_plan``
        DArrays).  Incompatible trees raise before anything is touched."""
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
        self._graph = None  # it reads the old weights by address
        return self._as_darrays(old) if self.tp is not None else old

    def _as_darrays(self, tree, path: str = ""):
        """This rank's pieces as ``llama_plan`` DArrays, which ``_place``
        takes back as they are (swapping back a tree of bare pieces would
        read them as full weights)."""
        if isinstance(tree, dict):
            return {k: self._as_darrays(v, f"{path}.{k}" if path else k) for k, v in tree.items()}
        from ..darray import DArray
        from ..models.convert import _flatten, param_shapes
        from ..spec import DArraySpec, TensorMeta

        shape = _flatten(param_shapes(self.config))[path]
        spec = DArraySpec(self.mesh, self._specs[path], TensorMeta(tuple(shape), tree.dtype))
        return DArray(tree, spec, self.mesh.get_rank())

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

    def _row(self, x, kernel):
        """A row-parallel product: this rank's partial sum, summed over
        "tp" (the plain product without tensor parallelism)."""
        y = self._dense(x, kernel)
        if self.tp is None:
            return y
        from ..collectives import mesh_all_reduce

        return mesh_all_reduce(y, self.mesh, "sum", self.tp.index)

    def _gather_last(self, x):
        if self.tp is None:
            return x
        from ..collectives import mesh_all_gather

        return mesh_all_gather(x, self.mesh, self.tp.index, gather_dim=x.ndim - 1)

    def _embed(self, tokens):
        return self._gather_last(
            self.params["embed_tokens"]["embedding"][tokens].to(self.config.dtype))

    def _head(self, x):
        c = self.config
        xn = rmsnorm(x, self.params["norm"]["weight"], c.rms_norm_eps).to(c.dtype)
        if c.tie_word_embeddings:
            emb = self.params["embed_tokens"]["embedding"]
            if self.tp is not None:  # hidden-sharded table: Partial logits
                w = emb.shape[1]
                return self._row(xn.narrow(-1, self.tp.rank * w, w), emb.T).float()
            logits = xn @ emb.to(c.dtype).T
        else:
            logits = self._gather_last(self._dense(xn, self.params["lm_head"]["kernel"]))
        return logits.float()

    def _mlp(self, lp, x):
        c = self.config
        xn2 = rmsnorm(x, lp["post_attention_layernorm"]["weight"], c.rms_norm_eps).to(c.dtype)
        g = self._dense(xn2, lp["mlp"]["gate_proj"]["kernel"])
        u = self._dense(xn2, lp["mlp"]["up_proj"]["kernel"])
        return x + self._row(F.silu(g) * u, lp["mlp"]["down_proj"]["kernel"])

    def _heads(self, lp):
        """This rank's query and kv head counts, read from its weights."""
        hd = self.config.head_dim
        att = lp["self_attn"]
        return att["q_proj"]["kernel"].shape[1] // hd, att["k_proj"]["kernel"].shape[1] // hd

    def _qkv(self, lp, x, B, T):
        c = self.config
        hd = c.head_dim
        H, KV = self._heads(lp)
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
        hd = c.head_dim
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
                x = x + self._row(y, lp["self_attn"]["o_proj"]["kernel"])
                x = self._mlp(lp, x)
                KV = k.shape[2]
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
        was real.  On the card this replays the captured graph (capturing
        it first when there is none, or when the pools were replaced); on
        the CPU, or when ``graphed`` is false, it is :meth:`decode_eager`."""
        if not self.graphed:
            return self.decode_eager(tokens)
        g = self._graph
        if g is None or not g.current(self.cache):
            return self._capture(tokens)
        g.load(self.cache, tokens)
        g.graph.replay()
        for name, n in g.launches.items():
            LAUNCHES[name] += n
        return g.read()

    @torch.no_grad()
    def decode_eager(self, tokens: np.ndarray) -> np.ndarray:
        """:meth:`decode` run op by op, without the graph."""
        cache = self.cache
        dev = self.device
        table = torch.from_numpy(cache.table_array()).to(dev)
        lengths = torch.from_numpy(cache.lengths_array()).to(dev)
        toks = torch.from_numpy(np.asarray(tokens, np.int64).reshape(cache.num_slots)).to(dev)
        return self._decode_step(table, lengths, toks).cpu().numpy()

    def _capture(self, tokens: np.ndarray) -> np.ndarray:
        """Run this step eagerly through fresh input buffers on a side
        stream (it loads the kernels and cuBLAS and returns this call's
        logits), then capture the same step into a graph on that stream.
        Capture runs nothing on the card, so the launches it counted are
        taken back and added again at each replay."""
        self._graph = None
        g = _DecodeGraph(self)
        g.load(self.cache, tokens)
        cur = torch.cuda.current_stream(self.device)
        g.stream.wait_stream(cur)
        with torch.cuda.stream(g.stream):
            logits = self._decode_step(g.table, g.lengths, g.tokens)
        cur.wait_stream(g.stream)
        out = logits.cpu().numpy()
        before = dict(LAUNCHES)
        with torch.cuda.graph(g.graph, stream=g.stream):
            g.logits = self._decode_step(g.table, g.lengths, g.tokens)
        g.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
        LAUNCHES.update(before)
        g.h_logits = torch.empty(g.logits.shape, dtype=g.logits.dtype).pin_memory()
        self._graph = g
        return out

    def _decode_step(self, table, lengths, toks):
        """The decode step on device tensors: ``table`` (S, Pmax) int32,
        ``lengths`` (S,) int32, ``toks`` (S,) int64; returns the (S, vocab)
        fp32 logits on the device.  No host transfer, so it can be
        captured."""
        c = self.config
        cache = self.cache
        S = cache.num_slots
        page, Pmax = cache.config.page_size, cache.config.pages_per_slot
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
            x = x + self._row(y, lp["self_attn"]["o_proj"]["kernel"])
            x = self._mlp(lp, x)
        return self._head(x)

    @torch.no_grad()
    def decode_multi(self, tokens: np.ndarray) -> np.ndarray:
        """One batched MULTI-token paged step (the speculative verify and the
        suffix prefill): for every slot, ``tokens[s, i]``'s K/V lands at
        position ``lengths[s] + i`` and ``logits[s, i]`` predicts the token
        AFTER it.  Lengths do NOT advance (callers commit the accepted
        positions via ``cache.advance``); positions past a slot's reserved
        pages write the null page and their logits are garbage the host
        must ignore.  Returns (num_slots, W, vocab) fp32."""
        return self._multi_step(tokens).cpu().numpy()

    def _multi_step(self, tokens: np.ndarray) -> torch.Tensor:
        """:meth:`decode_multi`'s step; its logits stay on the device."""
        c = self.config
        cache = self.cache
        S, Tmax = cache.num_slots, cache.max_seq_len
        page, Pmax = cache.config.page_size, cache.config.pages_per_slot
        hd = c.head_dim
        H, KV = self._heads(self.params["layers_0"])
        dev = self.device
        tokens = np.asarray(tokens, np.int64)
        W = int(tokens.shape[-1])
        toks = torch.from_numpy(tokens.reshape(S, W)).to(dev)
        table = torch.from_numpy(cache.table_array().astype(np.int64)).to(dev)
        lengths = torch.from_numpy(cache.lengths_array().astype(np.int64)).to(dev)
        x = self._embed(toks)  # (S, W, E)
        pos = lengths[:, None] + torch.arange(W, device=dev)[None, :]
        # the same null-page guard as decode: positions past the slot's
        # reserved pages and slots awaiting their prefill (length 0, whose
        # tables may already map pages SHARED with live slots) write the
        # null page, never a live one
        valid = (pos < Pmax * page) & (lengths[:, None] > 0)
        safe = torch.where(valid, pos, torch.zeros_like(pos))
        pg = torch.gather(table, 1, safe // page)
        pg = torch.where(valid, pg, torch.zeros_like(pg))
        off = safe % page
        # token i of a slot's window sees positions <= lengths + i, its own
        # window's earlier tokens included: every window K/V is written
        # before the gather
        hidden = torch.arange(Tmax, device=dev)[None, None, :] > pos[:, :, None]
        hidden = hidden[:, :, None, None, :]  # (S, W, 1, 1, Tmax)
        g = H // KV
        for l in range(c.num_hidden_layers):
            lp = self.params[f"layers_{l}"]
            q, k, v = self._qkv(lp, x, S, W)
            q, k = rotary(q, k, pos, c.rope_theta)
            kl, vl = cache.k[l], cache.v[l]
            kl[pg, off] = k.to(cache.dtype)
            vl[pg, off] = v.to(cache.dtype)
            ks = kl[table].reshape(S, Tmax, KV, hd).float()
            vs = vl[table].reshape(S, Tmax, KV, hd).float()
            qg = (q.float() * self._scale).reshape(S, W, KV, g, hd)
            s = torch.einsum("swkgd,stkd->swkgt", qg, ks).masked_fill(hidden, -1e30)
            p = torch.softmax(s, dim=-1)
            o = torch.einsum("swkgt,stkd->swkgd", p, vs)
            y = o.reshape(S, W, H * hd).to(c.dtype)
            x = x + self._row(y, lp["self_attn"]["o_proj"]["kernel"])
            x = self._mlp(lp, x)
        return self._head(x)  # (S, W, vocab) fp32

    @torch.no_grad()
    def prefill_suffix(self, prompt: Sequence[int], slot: int, matched: int) -> np.ndarray:
        """Prefix-cache hit path: the slot's page table already maps cached
        pages covering ``prompt[:matched]`` (page-aligned, via
        ``alloc_shared``) and the cache length sits at ``matched``
        (``commit_prefill(slot, matched)``); run ONLY the suffix through
        multi-token paged steps of one page each, appending its K/V after
        the shared prefix, and return the next-token logits row (vocab,)
        fp32 for the last prompt position."""
        cache = self.cache
        n = len(prompt)
        page = cache.config.page_size
        if not (0 < matched < n):
            raise ValueError(f"matched={matched} must be in (0, {n})")
        if matched % page:
            raise ValueError(f"matched={matched} is not page-aligned (page={page})")
        if int(cache.lengths[slot]) != matched:
            raise ValueError(
                f"slot {slot} length {int(cache.lengths[slot])} != matched {matched} "
                "(commit_prefill the shared prefix first)"
            )
        W = page  # chunk width: one page per multi-token step
        out = None
        i = matched
        while i < n:
            chunk = [int(t) for t in prompt[i:i + W]]
            toks = np.zeros((cache.num_slots, W), np.int64)
            toks[slot, : len(chunk)] = chunk
            logits = self._multi_step(toks)
            for _ in chunk:
                cache.advance(slot)
            out = logits[slot, len(chunk) - 1]
            i += len(chunk)
        return out.cpu().numpy()

    def decode_flops_per_step(self) -> float:
        """FLOPs of ONE decode step (all slots): the numerator of a serve MFU.
        The JAX engine reads XLA's cost analysis of its compiled step; the
        port has no compiler to ask, so this is an analytic count of the
        step as the port computes it: every projection and the head, 2·M·K·N
        each over the ``num_slots`` rows, plus attention's two products over
        each slot's gathered pages (``page_size · pages_per_slot`` positions
        a slot, whatever its length).  Norms, rotary, the softmax and the
        activation are not counted.  Under tensor parallelism it counts this
        rank's share: its heads, intermediate and vocab columns."""
        c = self.config
        cache = self.cache
        S, Tmax = cache.num_slots, cache.max_seq_len
        n = self.tp.size if self.tp is not None else 1
        E, F_, V = c.hidden_size, c.intermediate_size // n, c.vocab_size // n
        hd = c.head_dim
        H, KV = self._heads(self.params["layers_0"])
        proj = E * (H + 2 * KV) * hd + H * hd * E + 3 * E * F_
        attn = 2 * H * hd * Tmax
        return float(2 * S * (c.num_hidden_layers * (proj + attn) + E * V))

    def replay_greedy(self, prompt: Sequence[int], max_new_tokens: int,
                      *, eos_id: Optional[int] = None, canary: bool = False) -> List[int]:
        """Standalone greedy generation through the CURRENT weights on a
        temporarily allocated slot, freed before returning: the rollout's
        canary replay and its baseline recorder.  Call it only while a slot
        is free (the rollout replays after its drain).

        ``canary=True`` marks a verification replay after a weight swap:
        each greedy pick consults the faultsim ``canary_diverge`` hook,
        which, when armed and due, flips the sign of the pick's top logit
        (the deterministic stand-in for a bad checkpoint)."""
        cache = self.cache
        slot = cache.alloc(len(prompt), max_new_tokens)

        def _pick(row: np.ndarray) -> int:
            if canary and _fs.fires("canary_diverge", ctx="replay"):
                row = np.array(row, copy=True)
                j = int(np.argmax(row))
                row[j] = -row[j]
            return self.greedy(row)

        try:
            row = self.prefill(list(prompt), slot)
            cache.commit_prefill(slot, len(prompt))
            out: List[int] = []
            tok = _pick(row)
            out.append(tok)
            for _ in range(max_new_tokens - 1):
                if eos_id is not None and tok == eos_id:
                    break
                toks = np.zeros((cache.num_slots,), np.int64)
                toks[slot] = tok
                logits = self.decode(toks)
                cache.advance(slot)
                tok = _pick(logits[slot])
                out.append(tok)
            return out
        finally:
            cache.free(slot)

    @staticmethod
    def greedy(logits_row: np.ndarray) -> int:
        """Deterministic greedy sample (ties break to the lowest id)."""
        return int(np.argmax(logits_row))
