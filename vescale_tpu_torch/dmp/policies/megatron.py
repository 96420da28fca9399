"""MEGATRON auto-plan policy (reference legacy/vescale/dmp/policies/
megatron.py:33-218).

The port of ``vescale_tpu/dmp/policies/megatron.py``.  It walks the
parameter names and shapes: each 2-D ``kernel`` (in, out) is column- or
row-parallel by Megatron naming, a 3-D one is a stacked block (the
``scan_layers`` layout, its shard dim one further in), embeddings and the
head shard their hidden dim, norms replicate.  The port's modules keep
flax's leaf names and (in, out) kernels, so the reference's name rules
apply unchanged and its plans come out the same.

Forward plans per module, from the same names:
  - a module (not the root) with both column- and row-parallel child
    projections is a TP region (attention, mlp): inputs and outputs
    batch-sharded;
  - a norm that is a sibling of a TP region is a Megatron-SP norm: inputs
    and outputs also sequence-sharded over tp;
  - a top-level norm (the final one) takes SP in and gives batch-sharded
    out;
  - the root takes and gives batch-sharded activations over dp.
Unsure means Replicate: always correct, only not sharded.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

from ...placements import Replicate, Shard
from .registry import register_policy

_COL_HINTS = (
    "c_attn", "q_proj", "k_proj", "v_proj", "query", "key", "value",
    "c_fc", "gate_proj", "up_proj", "fc1", "w1", "w3", "wi",
)
_ROW_HINTS = ("c_proj", "o_proj", "down_proj", "fc2", "w2", "wo", "dense_4h_to_h", "out_proj")
_HEAD_HINTS = ("lm_head",)
_NORM_HINTS = ("ln", "layernorm", "norm")


def _parent(path: str) -> str:
    return path.rsplit(".", 1)[0] if "." in path else ""


@register_policy("MEGATRON")
def megatron_policy(abstract_params: Dict[str, Any], mesh, tp_dim: str = "tp",
                    dp_dim: str = "dp", sequence_parallel: bool = True) -> Dict[str, Any]:
    """{"parameter", "forward"} plans from ``{name: tensor}`` (names and
    shapes only)."""
    names = mesh.mesh_dim_names
    tp_i = names.index(tp_dim) if tp_dim in names else None
    n_tp = mesh.shape[tp_i] if tp_i is not None else 1

    def pl(shard_dim=None):
        out: List[Any] = [Replicate()] * mesh.ndim
        if shard_dim is not None and tp_i is not None:
            out[tp_i] = Shard(shard_dim)
        return out

    param_plan: Dict[str, Any] = {}
    col_parents: set = set()
    row_parents: set = set()
    norm_modules: set = set()

    for path, leaf in abstract_params.items():
        low = path.lower()
        key = re.escape(path)
        shape = tuple(leaf.shape)
        mod = _parent(path)
        if any(h in low for h in _NORM_HINTS) or len(shape) == 0:
            if any(h in mod.lower().rsplit(".", 1)[-1] for h in _NORM_HINTS):
                norm_modules.add(mod)
            param_plan[key] = pl()
            continue
        if low.endswith(".embedding") or any(h in low for h in _HEAD_HINTS):
            d = 1 if len(shape) > 1 and shape[1] % n_tp == 0 else None
            param_plan[key] = pl(d)
            continue
        if len(shape) in (2, 3) and low.endswith("kernel"):
            off = len(shape) - 2  # a stacked (L, in, out) block
            parent = low.rsplit(".", 2)[-2] if "." in low else low
            if any(h in parent for h in _COL_HINTS) and shape[1 + off] % n_tp == 0:
                param_plan[key] = pl(1 + off)
                col_parents.add(_parent(mod))
                continue
            if any(h in parent for h in _ROW_HINTS) and shape[0 + off] % n_tp == 0:
                param_plan[key] = pl(0 + off)
                row_parents.add(_parent(mod))
                continue
            param_plan[key] = pl()
            continue
        if len(shape) == 1 and low.endswith("bias"):
            parent = low.rsplit(".", 2)[-2] if "." in low else low
            if any(h in parent for h in _COL_HINTS) and shape[0] % n_tp == 0:
                param_plan[key] = pl(0)
                continue
        param_plan[key] = pl()

    dp_i = names.index(dp_dim) if dp_dim in names else None

    def act(seq: bool = False):
        out: List[Any] = [Replicate()] * mesh.ndim
        if dp_i is not None:
            out[dp_i] = Shard(0)  # the batch
        if seq and tp_i is not None:
            out[tp_i] = Shard(1)  # Megatron-SP: the sequence over tp
        return out

    dp_only = act()
    seq_par = act(seq=sequence_parallel)
    regions = {m for m in (col_parents & row_parents) if m}
    region_parents = {_parent(m) for m in regions}
    fwd_plan: Dict[str, Any] = {r"": {"input": [dp_only], "output": [dp_only]}}
    for m in sorted(regions):
        fwd_plan[re.escape(m)] = {"input": [dp_only], "output": [dp_only]}
    for m in sorted(norm_modules):
        par = _parent(m)
        if par in regions or m in regions:
            continue  # q/k norms inside attention: the region's rules
        if par in region_parents and par != "":
            fwd_plan[re.escape(m)] = {"input": [seq_par], "output": [seq_par]}
        elif par == "" and regions:
            fwd_plan[re.escape(m)] = {"input": [seq_par], "output": [dp_only]}
    return {"parameter": param_plan, "forward": fwd_plan}
