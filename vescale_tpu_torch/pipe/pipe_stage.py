"""Pipeline stage construction — the port of ``vescale_tpu/pipe/pipe_stage.py``
(legacy veScale's PipeParser/PipeModule, pipe_parser.py:46,
pipe_stage.py:64,285,311):

  - split an ordered list of stage units into stages (uniform, manual
    split points, or balanced by parameter count);
  - virtual chunks for interleaved schedules: with ``virtual_chunks`` V > 1
    the units are split into S·V *groups*, group ``g`` running as model
    chunk ``g // S`` on physical stage ``g % S`` (Megatron's VPP
    assignment); a microbatch traverses groups g = 0 .. S·V-1;
  - shared groups (tied embeddings) whose gradients are summed;
  - per-group parameter trees.

A stage unit is an ``nn.Module`` used as a template: its parameters are
not read.  ``group_forward(g)`` is a plain function ``(group_params, x) ->
y`` that runs each unit through ``torch.func.functional_call`` on the
given tensors, as the reference's ``module.apply({"params": ...}, x)``
does, so the engine differentiates the parameters it was handed.
Parameter trees are nested dicts keyed like the flax trees
(``{unit_name: {"wte": {"embedding": t}}}``), so the tests carry weights
across group by group with ``models.convert.params_from_jax``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ..plan import PipelineParallelPlan, PipelineSplitMethodType

__all__ = ["PipeModule", "construct_pipeline_stage", "StageUnit", "_cuts_by_weight",
           "flatten_tree", "unflatten_tree", "tree_add", "activation_leaves", "rebuild"]


@dataclasses.dataclass
class StageUnit:
    """One indivisible unit (the legacy plan's smallest_unsplittable_units)."""

    name: str
    module: nn.Module
    shared_group: Optional[str] = None  # e.g. "embeddings" for a tied wte


# ------------------------------------------------------------ param trees
def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested dict as ``{"a.b.c": leaf}``, in insertion order."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, path))
        else:
            out[path] = v
    return out


def unflatten_tree(flat: Mapping[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def activation_leaves(x) -> List[Any]:
    """The tensors of an activation (a tensor or nested tuples of them)."""
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in activation_leaves(v)]
    return [x]


def rebuild(x, flat: List[Any]):
    """``flat`` (``activation_leaves`` order) in the structure of ``x``."""
    it = iter(flat)

    def go(v):
        if isinstance(v, (tuple, list)):
            return type(v)(go(e) for e in v)
        return next(it)

    return go(x)


def tree_add(a, b):
    """``a + b`` leaf by leaf over two trees of one structure."""
    if isinstance(a, Mapping):
        return {k: tree_add(a[k], b[k]) for k in a}
    return a + b


def unit_forward(module: nn.Module, params: Mapping[str, Any], *args):
    """``module`` run on ``params`` (its nested parameter tree) in place of
    its own parameters."""
    return torch.func.functional_call(module, flatten_tree(params), args, strict=True)


class PipeModule:
    """Per-group unit lists, shared groups and the per-group forward
    (reference pipe_stage.py:64)."""

    def __init__(self, groups: List[List[StageUnit]], plan: PipelineParallelPlan):
        self.groups = groups
        self.plan = plan
        self.num_stages = plan.num_stages
        self.virtual_chunks = max(1, len(groups) // plan.num_stages)
        if len(groups) != self.num_stages * self.virtual_chunks:
            raise ValueError(
                f"{len(groups)} groups != num_stages {self.num_stages} x virtual chunks"
            )
        # shared groups: name -> [(group_idx, unit_name), ...]
        self.shared_groups: Dict[str, List[Tuple[int, str]]] = {}
        for g, units in enumerate(groups):
            for u in units:
                if u.shared_group:
                    self.shared_groups.setdefault(u.shared_group, []).append((g, u.name))

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    def group_index(self, stage: int, chunk: int = 0) -> int:
        return chunk * self.num_stages + stage

    def stage_of_group(self, g: int) -> Tuple[int, int]:
        """(physical stage, chunk) of group g."""
        return g % self.num_stages, g // self.num_stages

    # ------------------------------------------------------------- init
    def init_all(self, seed: int = 0, x_example=None, *, device=None,
                 dtype: torch.dtype = torch.float32) -> List[Dict[str, Any]]:
        """Random parameters of every group in model order, tied units
        sharing one tree (reference ``init_all`` with
        build_shared_module_group, pipe_stage.py:311): each leaf drawn by
        ``models.convert.init_params``'s rule from one ``torch.Generator``
        seeded with ``seed`` on ``device`` (default: the card).
        ``x_example`` is accepted for the reference's signature; a torch
        unit knows its shapes without it."""
        from ..device import resolve_device
        from ..models.convert import draw_leaf

        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        shared: Dict[str, Any] = {}
        out = []
        for units in self.groups:
            params = {}
            for u in units:
                if u.shared_group and u.shared_group in shared:
                    params[u.name] = shared[u.shared_group]
                    continue
                p = unflatten_tree({n: draw_leaf(n, tuple(t.shape), dtype, dev, gen)
                                    for n, t in u.module.named_parameters()})
                if u.shared_group:
                    shared[u.shared_group] = p
                params[u.name] = p
            out.append(params)
        return out

    def partition_params(self, unit_params: Mapping[str, Any]) -> List[Dict[str, Any]]:
        """``{unit_name: tree}`` as the per-group list ``init_all`` gives."""
        return [{u.name: unit_params[u.name] for u in units} for units in self.groups]

    # ---------------------------------------------------------- forward
    def group_forward(self, g: int) -> Callable:
        """Plain fn (group_params, x) -> y running group g's units."""
        units = self.groups[g]

        def fwd(params, x):
            for u in units:
                x = unit_forward(u.module, params[u.name], x)
            return x

        return fwd

    def stage_forward(self, stage: int, chunk: int = 0) -> Callable:
        return self.group_forward(self.group_index(stage, chunk))

    def sync_shared_params_grads(self, grads_per_group):
        """Sum the grads of tied units across their groups (reference
        engine/pipe.py:211 sync_shared_params)."""
        for name, members in self.shared_groups.items():
            if len(members) < 2:
                continue
            total = None
            for g, uname in members:
                gr = grads_per_group[g].get(uname)
                if gr is None:
                    continue
                total = gr if total is None else tree_add(total, gr)
            for g, uname in members:
                if uname in grads_per_group[g]:
                    grads_per_group[g][uname] = total
        return grads_per_group


def _cuts_by_weight(weights: List[float], n: int) -> List[int]:
    """Contiguous partition of unit weights into n groups balancing totals
    (same greedy as the reference's params/uniform split).  The serve
    engine cuts its layer stack with it too."""
    total = sum(weights)
    target = total / n
    cuts = []
    acc = 0.0
    for k, w in enumerate(weights):
        if len(cuts) < n - 1 and acc >= target * (len(cuts) + 1):
            cuts.append(k)
        acc += w
    while len(cuts) < n - 1:
        cuts.append(len(weights))
    # repair pass: cuts must be strictly increasing with >= 1 unit per group
    # (weight concentrated at the end can otherwise produce empty groups)
    for i in range(n - 1):
        lo = (cuts[i - 1] if i > 0 else 0) + 1
        hi = len(weights) - (n - 1 - i)
        cuts[i] = min(max(cuts[i], lo), hi)
    return cuts


def construct_pipeline_stage(
    units: Sequence[StageUnit],
    plan: PipelineParallelPlan,
    x_example=None,
) -> PipeModule:
    """Split an ordered list of stage units into ``num_stages *
    virtual_chunks`` groups (reference construct_pipeline_stage,
    pipe_stage.py:285).

    - MANUAL: ``plan.split_points`` lists the unit *names that end* each
      group but the last (num_stages*virtual_chunks - 1 names).
    - UNIFORM: balance by unit count.
    - PARAMETERS: balance by parameter count.  The reference needs
      ``x_example`` to shape its lazy flax units; a torch unit counts its
      parameters without it, so it is optional here.
    """
    units = list(units)
    n = plan.num_stages * max(1, plan.virtual_chunks)
    if n > len(units):
        raise ValueError(f"{n} groups for {len(units)} units")

    if plan.split_method == PipelineSplitMethodType.MANUAL:
        if not plan.split_points or len(plan.split_points) != n - 1:
            raise ValueError(f"MANUAL split needs {n - 1} split_points")
        names = [u.name for u in units]
        cuts = []
        for sp in plan.split_points:
            if sp not in names:
                raise ValueError(f"split point {sp!r} not among units {names}")
            cuts.append(names.index(sp) + 1)
        if cuts != sorted(cuts):
            raise ValueError("split_points must be in model order")
    elif plan.split_method == PipelineSplitMethodType.PARAMETERS:
        weights = [float(sum(p.numel() for p in u.module.parameters())) for u in units]
        cuts = _cuts_by_weight(weights, n)
    else:  # UNIFORM
        per = len(units) / n
        cuts = [int(round(per * (i + 1))) for i in range(n - 1)]

    bounds = [0] + list(cuts) + [len(units)]
    groups = [units[bounds[i]:bounds[i + 1]] for i in range(n)]
    if any(len(g) == 0 for g in groups):
        raise ValueError(f"empty pipeline group in split {bounds}")
    return PipeModule(groups, plan)
