"""Plain PyTorch reference of Mixtral training steps: the forward (the
Llama attention block, then top-k routed SwiGLU experts with a capacity),
token cross-entropy plus each layer's load-balancing loss, the backward
and AdamW.

Every operation is float32 (TF32 off by the caller), or the control's
fp8 (``precision``).  Each leaf and its two moments are kept in the dtype
the configuration states for it (the expert leaves bf16, every other leaf
fp32); every update is worked out in float32 and rounded once into that
storage.  To fit beside nothing but its own state, the step runs layer by
layer: a forward without a graph keeps each layer's input, then the head
and every layer from the top are run again with a graph, their gradient
taken, and their leaves updated at once (a layer's update needs only its
own gradient, and the layers below never read its leaves).

The MoE layer is written from its description: the router's float32
softmax, the top-k by a stable descending sort (ties to the lower
expert), the gates normalized to sum to one; each expert keeps its first
``C = ceil(k * N / E * capacity_factor)`` (token, choice) pairs in token
order and drops the rest; the load-balancing loss is ``coef * E *
sum_e(mean prob_e * share of tokens whose top-k holds e)``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from .llama_forward import attention_block, layer_leaves, rmsnorm
from .precision import mm


def moe(P: Dict[str, torch.Tensor], h: torch.Tensor, c: Dict, mode: str):
    """(output (N, d), aux loss) of the expert layer on (N, d) ``h``."""
    N, d = h.shape
    E, K = c["num_local_experts"], c["num_experts_per_tok"]
    probs = torch.softmax(h.float() @ P["block_sparse_moe.router"].float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :K], idx[:, :K]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    C = max(1, math.ceil(K * N / E * c["capacity_factor"]))
    flat = idx.reshape(-1)  # pairs in (token, choice) order
    onehot = F.one_hot(flat, E)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    keep = pos < C
    tok = torch.arange(N, device=h.device).repeat_interleave(K)
    y = torch.zeros(N, d, dtype=torch.float32, device=h.device)
    for e in range(E):
        sel = keep & (flat == e)
        n, g = tok[sel], gates.reshape(-1)[sel]
        xe = h[n]
        a = F.silu(mm(xe, P["block_sparse_moe.w_gate"][e], mode))
        u = mm(xe, P["block_sparse_moe.w_in"][e], mode) + P["block_sparse_moe.b_in"][e].float()
        ye = mm(a * u, P["block_sparse_moe.w_out"][e], mode) + P["block_sparse_moe.b_out"][e].float()
        y = y.index_add(0, n, g[:, None] * ye)
    routed = F.one_hot(idx, E).amax(dim=1).float()
    aux = c["router_aux_loss_coef_as_run"] * E * torch.sum(probs.mean(dim=0) * routed.mean(dim=0))
    return y, aux


def layer(P: Dict[str, torch.Tensor], x: torch.Tensor, c: Dict, mode: str):
    x = attention_block(P, x, c, mode)
    h = rmsnorm(x, P["post_attention_layernorm.weight"], c["rms_norm_eps"])
    B, T, d = x.shape
    y, aux = moe(P, h.reshape(B * T, d), c, mode)
    return x + y.reshape(B, T, d), aux


def head_loss(W: Dict[str, torch.Tensor], x: torch.Tensor, targets: torch.Tensor, c: Dict,
              mode: str, loss_tokens: int) -> torch.Tensor:
    """Token-mean cross entropy over the first ``loss_tokens`` positions
    of each row (all of them but in the half-batch fault)."""
    logits = mm(rmsnorm(x, W["norm.weight"], c["rms_norm_eps"]), W["lm_head.kernel"], mode)
    logits, targets = logits[:, :loss_tokens], targets[:, :loss_tokens]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))


class AdamW:
    """optax ``adamw`` with each leaf's moments in the leaf's dtype, the
    arithmetic in float32: m' = b1 m + (1 - b1) g, v' = b2 v + (1 - b2)
    g^2, u = (m' / c1) / (sqrt(v' / c2) + eps) + wd * p, p' = p - lr u."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float, wd: float):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, wd
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def update(self, name: str, p: torch.Tensor, g: torch.Tensor, t: int) -> None:
        if name not in self.m:
            self.m[name], self.v[name] = torch.zeros_like(p), torch.zeros_like(p)
        # a stacked leaf one expert at a time: the float32 temporaries of
        # one slice, not of the leaf
        parts = range(p.shape[0]) if p.ndim == 3 else [slice(None)]
        c1, c2 = 1 - self.b1 ** t, 1 - self.b2 ** t
        for i in parts:
            pm, pv, pp, pg = self.m[name][i], self.v[name][i], p[i], g[i]
            m = self.b1 * pm.float() + (1 - self.b1) * pg
            v = self.b2 * pv.float() + (1 - self.b2) * pg * pg
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps) + self.wd * pp.float()
            pp.copy_(pp.float() - self.lr * u)
            pm.copy_(m)
            pv.copy_(v)


def _leaf(p: torch.Tensor) -> torch.Tensor:
    """A float32 copy of a stored leaf to take a gradient on (never the
    stored tensor itself, whose gradient would add up over the steps)."""
    return torch.empty(p.shape, dtype=torch.float32, device=p.device).copy_(p).requires_grad_()


def train_steps(c: Dict, weights: Dict[str, torch.Tensor], batches: Sequence[Dict], opt: AdamW,
                mode: str = "fp32", half_batch: bool = False,
                on_grad: Callable[[int, str, torch.Tensor], None] = lambda t, n, g: None
                ) -> List[float]:
    """Train ``weights`` (a flat map, updated in place) on ``batches``
    (each {"input", "target"}, (B, T) ids); returns each step's loss.
    ``on_grad(step, leaf, fp32 gradient)`` sees every gradient before its
    update.  ``half_batch`` is the fault that leaves half the tokens out
    of the loss's mean."""
    L = c["num_hidden_layers"]
    losses = []
    for t, batch in enumerate(batches, start=1):
        ids, tgt = batch["input"], batch["target"]
        T = ids.shape[1]
        loss_tokens = T // 2 if half_batch else T
        with torch.no_grad():
            xs = [weights["embed_tokens.embedding"][ids].float()]
            aux_total = 0.0
            for i in range(L):
                x, aux = layer(layer_leaves(weights, i), xs[-1], c, mode)
                xs.append(x)
                aux_total += float(aux)
        W = {k: _leaf(weights[k]) for k in ("norm.weight", "lm_head.kernel")}
        top = xs[-1].requires_grad_()
        ce = head_loss(W, top, tgt, c, mode, loss_tokens)
        ce.backward()
        losses.append(float(ce.detach()) + aux_total)
        for k, w in W.items():
            on_grad(t, k, w.grad)
            opt.update(k, weights[k], w.grad, t)
        g = top.grad
        del W, top, ce
        for i in reversed(range(L)):
            raw = layer_leaves(weights, i)
            P = {k: _leaf(v) for k, v in raw.items()}
            x_in = xs[i].requires_grad_()
            x_out, aux = layer(P, x_in, c, mode)
            torch.autograd.backward([x_out, aux], [g, torch.ones_like(aux)])
            g = x_in.grad
            for k, w in P.items():
                name = f"layers_{i}.{k}"
                on_grad(t, name, w.grad)
                opt.update(name, raw[k], w.grad, t)
            del P, x_in, x_out, aux
            xs[i + 1] = None
        emb = weights["embed_tokens.embedding"]
        ge = torch.zeros(emb.shape, dtype=torch.float32, device=emb.device)
        ge.index_add_(0, ids.reshape(-1), g.reshape(-1, g.shape[-1]))
        on_grad(t, "embed_tokens.embedding", ge)
        opt.update("embed_tokens.embedding", emb, ge, t)
        del ge, g, xs
    return losses
