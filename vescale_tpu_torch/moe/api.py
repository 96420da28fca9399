"""parallelize_experts — expert-parallel placement of a model's MoE layers.

The port of ``vescale_tpu/moe/api.py``: ``moe_plan`` is a parameter-plan
fragment (FQN regex -> placements) in which the expert-stacked leaves
(E, ...) are ``Shard(0)`` over the ep mesh dim and the router stays
replicated; ``parallelize_experts`` merges it in front of a module's plan
and calls ``parallelize_module``.  The reference lets GSPMD turn the
sharded experts into all-to-alls; here ``MoEMLP`` computes its own
experts' share and sums the outputs over "ep" (``moe/layer.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..dmodule.api import DModule, parallelize_module
from ..mesh import DeviceMesh
from ..placements import Replicate, Shard

__all__ = ["moe_plan", "parallelize_experts"]


def moe_plan(mesh: DeviceMesh, experts_expr: str = r".*moe.*", ep_dim: str = "ep") -> Dict[str, Any]:
    """Param-plan fragment for MoE layers: expert-stacked leaves Shard(0)
    over ``ep_dim``; the router stays replicated."""
    ep = mesh._dim_index(ep_dim)

    def pl(shard_dim: Optional[int]):
        out = [Replicate()] * mesh.ndim
        if shard_dim is not None:
            out[ep] = Shard(shard_dim)
        return out

    return {
        experts_expr.rstrip("$") + r"\.(w_in|w_out|w_gate|b_in|b_out)": pl(0),
        experts_expr.rstrip("$") + r"\.router": pl(None),
    }


def parallelize_experts(
    module,
    experts_expr: str = r".*moe.*",
    device_mesh: Optional[DeviceMesh] = None,
    sharding_plan: Optional[Dict[str, Any]] = None,
    ep_dim: str = "ep",
) -> DModule:
    """``module`` with its MoE experts sharded over ``ep_dim``, composed
    with an existing plan (the expert entries go first: the first regex
    that matches a parameter wins)."""
    plan = dict(sharding_plan or {})
    param_plan = dict(plan.get("parameter", {}))
    merged = {**moe_plan(device_mesh, experts_expr, ep_dim), **param_plan}
    plan["parameter"] = merged
    return parallelize_module(module, device_mesh, plan)
