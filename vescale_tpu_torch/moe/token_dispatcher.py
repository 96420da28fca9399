"""TokenDispatcher — routes tokens to experts and back.

The port of ``vescale_tpu/moe/token_dispatcher.py``: the dispatch and
combine are dense one-hot products over capacity slots, (N, E, C) masks in
fp32, as the reference computes them; a dropped token (over its expert's
capacity) has a zero row in both masks.  ``all_to_all_dispatch`` is the
explicit expert-parallel token exchange: the capacity axis resharded to the
expert axis over "ep", one ``redistribute`` from ``Shard(1)`` to
``Shard(0)`` (an all-to-all).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..mesh import DeviceMesh

__all__ = ["TokenDispatcher"]


class TokenDispatcher:
    @staticmethod
    def capacity_for(num_tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
        """C = ceil(k*N/E * factor) (Switch/Mixtral convention)."""
        return max(1, math.ceil(top_k * num_tokens / num_experts * capacity_factor))

    def __init__(self, num_experts: int, capacity: int, mesh: Optional[DeviceMesh] = None,
                 ep_dim: str = "ep"):
        self.num_experts = num_experts
        self.capacity = capacity
        self.mesh = mesh
        self.ep_dim = ep_dim

    # ---------------------------------------------------------- routing
    def build_masks(self, gate_idx: torch.Tensor, gate_vals: torch.Tensor,
                    offset: Optional[torch.Tensor] = None,
                    slots: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, K) expert assignments -> the dispatch (N, E, C) one-hot and
        the combine (N, E, C) gate-weighted masks, fp32.  Capacity
        positions count the (n, k) pairs in their flattened order; a pair
        past its expert's capacity gets a zero row (``jax.nn.one_hot`` of
        the index C).

        ``offset`` (E,): the pairs routed to each expert ahead of these
        rows (the earlier dp ranks' rows of a global batch); a pair is
        then kept when ``offset`` plus its position here is below C, and
        still takes the slot of its position here.  ``slots`` (default C):
        the masks' last dim."""
        N, K = gate_idx.shape
        E, C = self.num_experts, self.capacity
        expert_onehot = F.one_hot(gate_idx.long(), E).to(torch.int32)  # (N, K, E)
        flat = expert_onehot.reshape(N * K, E)
        pos = (torch.cumsum(flat, dim=0, dtype=torch.int32) - flat).reshape(N, K, E)
        pos = torch.sum(pos * expert_onehot, dim=-1)  # (N, K)
        if offset is not None:  # the global position decides the keep
            keep = pos + torch.sum(offset.to(torch.int32) * expert_onehot, dim=-1) < C
        else:
            keep = pos < C
        S = C if slots is None else slots
        pos_oh = F.one_hot(torch.where(keep, pos, S).long(), S + 1)[..., :S].float()
        onehot = expert_onehot.float()
        disp = torch.einsum("nke,nkc->nec", onehot, pos_oh)
        comb = torch.einsum("nke,nkc,nk->nec", onehot, pos_oh, gate_vals.float())
        return disp, comb

    def dispatch(self, x: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
        """(N, d), (N, E, C) -> (E, C, d) expert inputs."""
        return torch.einsum("nec,nd->ecd", disp.to(x.dtype), x)

    def combine(self, expert_out: torch.Tensor, comb: torch.Tensor) -> torch.Tensor:
        """(E, C, d), (N, E, C) -> (N, d)."""
        return torch.einsum("nec,ecd->nd", comb.to(expert_out.dtype), expert_out)

    # ----------------------------------------- explicit all-to-all path
    def all_to_all_dispatch(self, buffers, mesh: Optional[DeviceMesh] = None):
        """The explicit expert-parallel token exchange.  ``buffers`` is a
        ``DArray`` of global shape (E, n*C, d) whose capacity axis is
        sharded over the ep dim (each source rank's C-sized block holds the
        tokens it routed to every expert), or this rank's (E, C, d) block
        of it.  Returns it sharded on the expert axis instead: each rank
        holds its experts' buffers from every source rank.  The reshard is
        one all-to-all."""
        from ..darray import DArray, from_local
        from ..placements import Replicate, Shard
        from ..redistribute import redistribute

        mesh = mesh or self.mesh
        ep = mesh._dim_index(self.ep_dim)

        def on_ep(p):
            return [p if i == ep else Replicate() for i in range(mesh.ndim)]

        if not isinstance(buffers, DArray):
            buffers = from_local(buffers, mesh, on_ep(Shard(1)))
        return redistribute(buffers, on_ep(Shard(0)))
