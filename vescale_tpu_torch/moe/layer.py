"""MoE layer — top-k routed expert MLPs.

The port of ``vescale_tpu/moe/layer.py``: capacity-based dense dispatch and
combine products (the Mesh-TensorFlow / GSPMD MoE pattern) around a bank of
expert MLPs whose parameters are stacked on a leading expert dim.

Numerics follow the reference: the router (``router``, (d, E)) and its
softmax in fp32; the top-k by a stable descending sort, so ties go to the
lower expert index as ``jax.lax.top_k`` breaks them; the expert leaves
(``w_in``, ``w_gate``, ``w_out``, ``b_in``, ``b_out``) in ``config.dtype``
and the expert products in it; GELU is the tanh approximation
(``jax.nn.gelu``'s default); the masks cast to the operand's dtype before
the dispatch and the combine.  The load-balancing aux loss and
``expert_tokens`` (the per-expert routed-token counts, a detached module
attribute set by each forward, the reference's ``sow``) count routed tokens
before the capacity drops.

**Expert parallel.**  ``parallelize_module`` with ``moe_plan`` (or
``mixtral_plan``) hands the layer ``Shard(0)`` pieces of its expert leaves
over an "ep" mesh dim (``shard_param``).  The tokens stay replicated over
"ep": every rank routes all of them, dispatches to its own experts and
combines their outputs, and the partial outputs are summed over "ep"
(``reduce_from_tp``).  The experts' input and the gate values enter through
``copy_to_tp``, so their gradients, which each rank computes for its own
experts only, are summed over "ep" in the backward; the router's own path
(its logits, the softmax and the aux loss) is computed whole on every
rank and is not summed, so the router's gradient is the same on every ep
rank and counts the aux loss once.

**Data parallel.**  Under a ``DModule`` whose mesh has a "dp" dim, the
layer is handed that dim (``bind_batch_dim``; ``place`` binds both dims
from a mesh, for a layer called functionally, e.g. inside a pipeline
block), and each rank holds its rows of the global batch.  The layer
then gives what the reference's GSPMD program gives for the global
batch: the capacity is ``capacity_for(N * dp, ...)``; a pair is kept
when its global position is below C, its position among the earlier dp
ranks' pairs for its expert (one all-gather of each rank's (E,) routed
counts over "dp") plus its local exclusive cumsum; ``expert_tokens``
holds the global counts and the aux loss the global value.  Only the
keep decision is global: a kept pair takes the slot of its local
position, of ``min(C, N)`` slots (a rank's pairs for one expert are at
most its N rows), so the dense products are the size one rank's rows
need, not dp-fold.  The aux loss's gradient follows DDP's average over
"dp": the dp mean of the router probabilities enters with an identity
backward, so rank r's aux carries dp times its share of the global aux
loss's gradient, and the average of the ranks' gradients is the
reference's.  Without a "dp" dim (or with one of size 1) the layer
computes as above, bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .token_dispatcher import TokenDispatcher

__all__ = ["MoEConfig", "MoEMLP", "route", "EXPERT_LEAVES"]

# the leaves stacked on the expert dim, in the reference's creation order
EXPERT_LEAVES = ("w_in", "b_in", "w_out", "b_out", "w_gate")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    d_model: int = 64
    d_ff: int = 256
    top_k: int = 2
    capacity_factor: float = 2.0
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01
    swiglu: bool = False  # SwiGLU experts (HF Mixtral convention) vs GELU
    dtype: Any = torch.float32


def route(x2: torch.Tensor, router: torch.Tensor, top_k: int):
    """(probs (N, E), gate_vals (N, K), gate_idx (N, K)) of tokens ``x2``
    (N, d): the fp32 router softmax, its top ``top_k`` by a stable
    descending sort (ties to the lower expert index), the gate values
    normalized to sum to one."""
    probs = torch.softmax(x2.float() @ router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :top_k], idx[:, :top_k]
    return probs, gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True), gate_idx


class _DPStats(torch.autograd.Function):
    """Each dp rank's (E,) routed counts and (E,) mean router
    probabilities, all-gathered over the dp dim in one collective: the
    (dp, E) counts (rank order) and the dp mean of the probabilities.
    The backward hands the mean's gradient through unscaled: DDP averages
    it over the ranks."""

    @staticmethod
    def forward(ctx, counts, me_local, dp):
        from .. import collectives as C

        E = counts.shape[0]
        buf = torch.cat([counts.to(me_local.dtype), me_local]).reshape(1, 2 * E)
        got = C.mesh_all_gather(buf, dp.mesh, dp.index)  # (dp, 2E)
        all_counts = got[:, :E].round().to(torch.int32)
        ctx.mark_non_differentiable(all_counts)
        return all_counts, got[:, E:].mean(dim=0)

    @staticmethod
    def backward(ctx, g_counts, g_me):
        return None, g_me, None


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class MoEMLP(nn.Module):
    """Top-k gated expert MLP bank (GELU, or SwiGLU with
    ``config.swiglu``).  ``forward(x)`` returns ``(y, aux_loss)``; tokens
    over an expert's capacity C = ceil(k * N / E * capacity_factor) get a
    zero output (they pass through the residual).  The parameters are
    allocated on ``device`` and left unset: load them with
    ``models.load_params`` (from ``models.init_params(config)`` or a
    reference tree through ``models.params_from_jax``)."""

    def __init__(self, config: MoEConfig, device=None):
        super().__init__()
        c = self.config = config
        E, d, f = c.num_experts, c.d_model, c.d_ff
        self.router = _param((d, E), torch.float32, device)
        self.w_in = _param((E, d, f), c.dtype, device)
        self.b_in = _param((E, f), c.dtype, device)
        self.w_out = _param((E, f, d), c.dtype, device)
        self.b_out = _param((E, d), c.dtype, device)
        self.w_gate = _param((E, d, f), c.dtype, device) if c.swiglu else None
        self.ep = None  # the expert-parallel mesh dim (dmodule._comm.TPDim)
        self.dp = None  # the batch's mesh dim: the capacity and aux loss are global
        self.expert_tokens: Optional[torch.Tensor] = None

    def shard_param(self, name: str, placement, tp) -> None:
        """``parallelize_module``'s notice that expert leaf ``name`` is now
        this rank's ``Shard(0)`` piece over the mesh dim ``tp``."""
        E = self.config.num_experts
        if name not in EXPERT_LEAVES or getattr(placement, "dim", None) != 0:
            raise NotImplementedError(f"MoEMLP.{name} as {placement}: only the expert leaves, "
                                      "Shard(0) over the ep dim")
        if E % tp.size:
            raise ValueError(f"{E} experts do not split evenly over {tp}")
        if self.ep is not None and self.ep.index != tp.index:
            raise NotImplementedError(f"MoEMLP experts over two mesh dims ({self.ep}, {tp})")
        self.ep = tp

    def bind_batch_dim(self, dp) -> None:
        """``parallelize_module``'s notice that this rank holds its rows
        of a batch split over the mesh dim ``dp`` (a ``TPDim``)."""
        self.dp = dp

    def place(self, mesh) -> None:
        """Bind the layer to ``mesh``'s "ep" and "dp" dims (each where the
        mesh has it), as ``parallelize_module`` would: for a layer called
        functionally (``torch.func.functional_call`` with this rank's
        expert pieces), e.g. in a pipeline block."""
        from ..dmodule._comm import TPDim

        names = mesh.mesh_dim_names
        if "ep" in names:
            tp = TPDim(mesh, "ep")
            if self.config.num_experts % tp.size:
                raise ValueError(f"{self.config.num_experts} experts do not split evenly over {tp}")
            self.ep = tp
        if "dp" in names:
            self.dp = TPDim(mesh, "dp")

    def local_experts(self) -> Tuple[int, int]:
        """(first expert, count) of this rank's expert leaves."""
        E = self.config.num_experts
        if self.ep is None:
            return 0, E
        n = E // self.ep.size
        return self.ep.rank * n, n

    def forward(self, x):
        from ..dmodule import _comm

        c = self.config
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])  # (N, d)
        N = x2.shape[0]
        E, K = c.num_experts, c.top_k
        probs, gate_vals, gate_idx = route(x2, self.router, K)
        dp = self.dp if self.dp is not None and self.dp.size > 1 else None
        offset = slots = None
        if dp is None:
            td = TokenDispatcher(E, TokenDispatcher.capacity_for(N, E, K, c.capacity_factor))
        else:
            counts = F.one_hot(gate_idx, E).amax(dim=1).sum(dim=0)  # (E,) routed here
            all_counts, me = _DPStats.apply(counts, probs.mean(dim=0), dp)
            td = TokenDispatcher(E, TokenDispatcher.capacity_for(N * dp.size, E, K,
                                                                 c.capacity_factor))
            offset = all_counts[:dp.rank].sum(dim=0)
            slots = min(td.capacity, N)
        lo, n = self.local_experts()
        xd = x2
        if self.ep is not None:
            xd, gate_vals = _comm.copy_to_tp(x2, self.ep), _comm.copy_to_tp(gate_vals, self.ep)
        disp, comb = td.build_masks(gate_idx, gate_vals, offset, slots)  # (N, E, C) fp32
        if n != E:
            disp, comb = disp[:, lo:lo + n], comb[:, lo:lo + n]
        xe = td.dispatch(xd.to(c.dtype), disp)  # (E_local, C, d)
        if c.swiglu:
            # SwiGLU experts (HF Mixtral w1/w3/w2): silu(gate) * up -> down
            g = F.silu(torch.einsum("ecd,edf->ecf", xe, self.w_gate))
            u = torch.einsum("ecd,edf->ecf", xe, self.w_in) + self.b_in[:, None, :]
            h = g * u
        else:
            h = F.gelu(torch.einsum("ecd,edf->ecf", xe, self.w_in) + self.b_in[:, None, :],
                       approximate="tanh")
        ye = torch.einsum("ecf,efd->ecd", h, self.w_out) + self.b_out[:, None, :]
        y = td.combine(ye, comb)  # (N, d), this rank's experts' share
        if self.ep is not None:
            y = _comm.reduce_from_tp(y, self.ep)

        # load-balancing aux loss (Switch): mean router prob x the fraction
        # of tokens whose top-k holds the expert, before capacity drops
        if dp is None:
            routed = F.one_hot(gate_idx, E).amax(dim=1).float()  # (N, E)
            aux = c.aux_loss_coef * E * torch.sum(probs.mean(dim=0) * routed.mean(dim=0))
            self.expert_tokens = routed.sum(dim=0).detach()
        else:
            total = all_counts.sum(dim=0).float()
            aux = c.aux_loss_coef * E * torch.sum(me * (total / (N * dp.size)))
            self.expert_tokens = total
        return y.reshape(shape).to(x.dtype), aux
