"""DModule — plan-driven tensor and sequence parallelism of torch modules.

The port of ``vescale_tpu/dmodule/api.py``: ``parallelize_module(module,
mesh, {"parameter": ..., "forward": ...})`` binds a module to a mesh and a
sharding plan of FQN regexes, and returns a :class:`DModule`.

  **The parameter plan.**  Each parameter's ``named_parameters()`` name
  (the flax path: ``models/llama.py``) is matched by the first regex that
  fullmatches it (``_match``); the parameter is replaced in place by this
  rank's piece under the matched placements, cut from the full tensor the
  module holds or, for a module on ``meta``, materialized through
  ``initialize.materialize_module`` from ``init_fn``.  ``param_specs()``
  gives the ``DArraySpec`` tree (global shapes) that the checkpoint
  consumes.  A parameter sharded on a mesh dim goes to a module that
  computes on its piece: the port's ``Dense`` (column-parallel when its
  kernel is ``Shard(1)``, row-parallel when ``Shard(0)``) and ``Embed``
  (hidden-sharded when ``Shard(1)``, vocab-sharded when ``Shard(0)``), and
  ``model.patch``'s parallel modules; any other module refuses it.  A
  parameter the plan shards over the batch dim "dp" (alone or beside one
  tensor-parallel dim: FSDP by the plan) keeps its (dp, tp) piece; a
  forward pre-hook on its module all-gathers the dp piece, through
  ``_comm.all_gather`` whose backward reduce-scatters, so each rank's
  piece gets the sum of the dp ranks' gradients (``dp_sharded`` names
  them: DDP and ``DistributedOptimizer`` scale them to the average and
  leave them out of their own reduce).  Modules that compute over the
  global batch (``moe.MoEMLP``'s capacity and aux loss) are handed the
  "dp" dim (``bind_batch_dim``).

  **The forward plan.**  The reference constrains layouts and lets GSPMD
  place collectives.  Here forward pre-hooks and forward hooks move each
  activation from the placement it carries (the tag its producer put on
  it, ``dmodule._comm``) to the plan's, by the autograd-aware collectives
  of ``dmodule._comm``: Replicate -> Shard(d) a split, Shard(d) ->
  Replicate an all-gather (with a reduce-scatter backward when the module
  runs tensor-parallel compute on it: ``module._tp_region``), Partial ->
  Replicate an all-reduce, Partial -> Shard(d) a reduce-scatter.  An
  untagged tensor is Replicate; a planned module's untagged output takes
  the placement of its first input.  As in the reference, bare keys bind
  ``forward``, ``"fqn:method"`` keys bind another method (e.g.
  ``embed_tokens:attend``, wrapped with ``model.patch.patch_method``),
  input placements align with the positional and then keyword arguments
  (one entry broadcasts to all), ``default_input`` is kept, and patterns
  that match nothing warn (``_warn_unmatched``: the parameter plan's at
  parallelize time, the forward plan's at the first call).  A mesh dim
  named ``"dp"`` carries the batch: each rank is handed its own batch
  piece, and the hooks move nothing on it.

  **Grad sync.**  A Replicate parameter of a module whose planned input is
  sharded on a mesh dim (the norms under sequence parallelism) gets this
  rank's part of its gradient: :meth:`DModule.finish_grad_sync` sums those
  gradients over that dim, in one all-reduce, before the optimizer step
  (GSPMD does this implicitly in the reference).

``pspec_of`` and ``keypath_fqn`` are JAX PartitionSpec and tree-path
helpers with no torch counterpart here: parameter names are already
dotted FQNs, and placements are applied directly.
"""

from __future__ import annotations

import dataclasses
import re
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import collectives as C
from ..mesh import DeviceMesh
from ..placements import Partial, Placement, Replicate, Shard, normalize_placements
from ..spec import DArraySpec, TensorMeta
from . import _comm
from ._comm import TPDim

__all__ = ["parallelize_module", "DModule", "PlacementsInterface"]

_BATCH_DIM = "dp"


@dataclasses.dataclass
class PlacementsInterface:
    """Input/output resharding hints for one module
    (reference dmodule/placements_interface.py)."""

    input: Optional[Sequence] = None   # per positional arg: placements | None
    output: Optional[Sequence] = None  # per output leaf: placements | None

    @classmethod
    def normalize(cls, v) -> "PlacementsInterface":
        if isinstance(v, PlacementsInterface):
            return v
        if isinstance(v, dict):
            return cls(input=v.get("input"), output=v.get("output"))
        # bare list == input placements
        return cls(input=v)


def _match(plan: Dict[str, Any], fqn: str) -> Tuple[Optional[str], Any]:
    """(pattern, value) of the first plan entry fullmatching ``fqn``."""
    for pattern, v in plan.items():
        if re.fullmatch(pattern, fqn):
            return pattern, v
    return None, None


def _align_placements(placements_list, n: int):
    pl = list(placements_list)
    if len(pl) == 1 and n > 1:
        pl = pl * n
    return pl + [None] * (n - len(pl))


def _tensor_leaves(entry, fn):
    """``entry`` with ``fn`` applied to every tensor leaf (lists, tuples and
    dicts walked)."""
    if isinstance(entry, torch.Tensor):
        return fn(entry)
    if isinstance(entry, (list, tuple)):
        return type(entry)(_tensor_leaves(e, fn) for e in entry)
    if isinstance(entry, dict):
        return {k: _tensor_leaves(v, fn) for k, v in entry.items()}
    return entry


def _first_tensor(entry):
    if isinstance(entry, torch.Tensor):
        return entry
    if isinstance(entry, (list, tuple)):
        entry = list(entry)
    elif isinstance(entry, dict):
        entry = list(entry.values())
    else:
        return None
    for e in entry:
        t = _first_tensor(e)
        if t is not None:
            return t
    return None


class DModule:
    """A torch module bound to a mesh and a sharding plan.

    ``dm(*args)`` runs the module with the forward plan applied, the root
    entry's output placements included; ``dm.forward_local(*args)`` keeps
    the root output in the placement its producer gave it (the train step
    reads vocab-sharded logits so).  ``dm.module`` is the parallelized
    module itself, its parameters this rank's pieces."""

    def __init__(self, module: nn.Module, device_mesh: DeviceMesh,
                 sharding_plan: Dict[str, Any], validate_plan: bool = True,
                 init_fn: Optional[Callable[[], Any]] = None):
        self.module = module
        self.mesh = device_mesh
        self.validate_plan = validate_plan
        plan = sharding_plan or {}
        self.param_plan: Dict[str, Any] = dict(plan.get("parameter", {}))
        self.fwd_plan: Dict[str, PlacementsInterface] = {
            k: PlacementsInterface.normalize(v) for k, v in dict(plan.get("forward", {})).items()
        }
        self.default_input_placements = plan.get("default_input", None)
        self._fwd_matched: set = set()
        self._param_matched: set = set()
        self._warned_fwd = False
        self._keep_root_output = False
        # the mesh dims activations move on: every dim but the batch's
        self._move = [i for i, n in enumerate(device_mesh.mesh_dim_names) if n != _BATCH_DIM]
        self._tp: Dict[int, TPDim] = {i: TPDim(device_mesh, i) for i in self._move}
        self._specs: Dict[str, DArraySpec] = {}
        # the batch dim, where it splits the rows: handed to modules that
        # compute over the global batch (moe.MoEMLP) and used to gather the
        # parameters the plan shards over it
        self._dp: Optional[TPDim] = None
        if _BATCH_DIM in device_mesh.mesh_dim_names and device_mesh.size(_BATCH_DIM) > 1:
            self._dp = TPDim(device_mesh, _BATCH_DIM)
        self._gathered: Dict[nn.Module, List[Tuple[str, int]]] = {}
        self.dp_sharded: set = set()  # names of the parameters sharded over the batch dim
        self._sync_params: Dict[int, List[nn.Parameter]] = {}
        # the plan's static audit (analysis/shardcheck.py, VSC107) before
        # any parameter is cut: one warning under VESCALE_SHARDCHECK=warn,
        # ShardcheckError under strict
        if validate_plan and self.param_plan:
            from .. import analysis as _analysis

            if _analysis.enabled():
                _analysis.dispatch_report(_analysis.check_param_plan(
                    self.param_plan, device_mesh, name="dmodule parameter plan"), stacklevel=3)
        self._shard_parameters(init_fn)
        self._bind_forward_plan()

    # --------------------------------------------------------- param plans
    def param_placements(self, path: str, ndim: int) -> Tuple[Placement, ...]:
        pattern, v = _match(self.param_plan, path)
        if pattern is not None:
            self._param_matched.add(pattern)
        return normalize_placements(v, self.mesh.ndim, ndim)

    def _warn_unmatched(self, plan: Dict[str, Any], matched: set, kind: str) -> None:
        unmatched = [p for p in plan if p not in matched and p != r".*"]
        if unmatched and self.validate_plan:
            warnings.warn(
                f"{kind} plan patterns matched nothing: {unmatched} — "
                "typo'd FQN regexes silently leave params/activations "
                "unconstrained (reference plans are validated the same way)",
                stacklevel=4,
            )

    def _shard_parameters(self, init_fn) -> None:
        named = list(self.module.named_parameters())
        placements = {name: self.param_placements(name, p.ndim) for name, p in named}
        if self.param_plan:
            self._warn_unmatched(self.param_plan, self._param_matched, "parameter")
        meta = [name for name, p in named if p.is_meta]
        if meta and (init_fn is None or len(meta) != len(named)):
            raise ValueError(f"parameters on meta ({meta[:3]}...): a module built on meta "
                             "(all of it) materializes from init_fn")
        pieces = {}
        if meta:
            from ..initialize import materialize_module

            tree: Dict[str, Any] = {}
            for name in meta:
                *path, leaf = name.split(".")
                node = tree
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = list(placements[name])
            got = materialize_module(init_fn, tree, mesh=self.mesh)

            def walk(node, prefix):
                for k, v in node.items():
                    path = f"{prefix}.{k}" if prefix else k
                    if isinstance(v, dict):
                        walk(v, path)
                    else:
                        pieces[path] = v.to_local()

            walk(got, "")
        coord = self.mesh.get_coordinate() if self.mesh.is_live else (0,) * self.mesh.ndim
        owners = dict(self.module.named_modules())
        for name, p in named:
            pl = placements[name]
            spec = DArraySpec(self.mesh, pl, TensorMeta(tuple(p.shape), p.dtype))
            self._specs[name] = spec
            sharded = [i for i, q in enumerate(pl) if not q.is_replicate() and self.mesh.size(i) > 1]
            if any(isinstance(pl[i], Partial) for i in sharded):
                raise ValueError(f"parameter {name}: a Partial parameter placement {pl}")
            owner_name, _, leaf = name.rpartition(".")
            owner = owners[owner_name]
            tp_dims = [i for i in sharded if i in self._move]
            on_dp = [i for i in sharded if i not in self._move]
            if len(tp_dims) > 1:
                raise NotImplementedError(
                    f"parameter {name} sharded as {pl}: one tensor-parallel mesh dim a parameter")
            if on_dp:
                dp_dim = pl[on_dp[0]]
                if not isinstance(dp_dim, Shard) or any(
                        getattr(pl[i], "dim", None) == dp_dim.dim for i in tp_dims):
                    raise NotImplementedError(
                        f"parameter {name} sharded as {pl}: over '{_BATCH_DIM}' a plain Shard "
                        "of a tensor dim that no tensor-parallel dim shards")
                self._gathered.setdefault(owner, []).append((leaf, dp_dim.dim))
                self.dp_sharded.add(name)
            if tp_dims and not hasattr(owner, "shard_param"):
                raise NotImplementedError(
                    f"parameter {name} sharded as {pl}, but {type(owner).__name__} "
                    "does not compute on parameter pieces")
            if name in pieces:
                local = pieces[name]
            else:
                spec.layout()
                local = spec.local_from_full(p.detach(), coord)
                local = local.clone() if sharded else local
            new = nn.Parameter(local.to(self.mesh.device).contiguous(),
                               requires_grad=p.requires_grad)
            setattr(owner, leaf, new)
            if tp_dims:
                owner.shard_param(leaf, pl[tp_dims[0]], self._tp[tp_dims[0]])
        if self._dp is not None:
            for mod in self.module.modules():
                if hasattr(mod, "bind_batch_dim"):
                    mod.bind_batch_dim(self._dp)
        for owner, leaves in self._gathered.items():
            owner.register_forward_pre_hook(lambda m, a, leaves=leaves: self._gather(m, leaves))
            owner.register_forward_hook(lambda m, a, o, leaves=leaves: self._release(m, leaves))

    def _gather(self, owner: nn.Module, leaves) -> None:
        """Before ``owner``'s forward: each of its parameters sharded over
        the batch dim all-gathered there (the backward reduce-scatters the
        gradient: each rank's piece gets the sum of the ranks' gradients),
        seen by the forward in place of the piece."""
        for leaf, dim in leaves:
            owner.__dict__[leaf] = _comm.all_gather(owner._parameters[leaf], self._dp, dim, True)

    @staticmethod
    def _release(owner: nn.Module, leaves) -> None:
        for leaf, _ in leaves:
            owner.__dict__.pop(leaf, None)

    def param_specs(self) -> Dict[str, Any]:
        """The nested dict of ``DArraySpec`` (global shapes, the plan's
        placements) keyed by the parameter paths."""
        tree: Dict[str, Any] = {}
        for name, spec in self._specs.items():
            *path, leaf = name.split(".")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = spec
        return tree

    # ------------------------------------------------------- forward plan
    def _move_to(self, t: torch.Tensor, dst, tp_region: bool = False) -> torch.Tensor:
        """``t`` moved from its placements (its tag, else Replicate) to
        ``dst`` on every moving mesh dim, tagged."""
        if not (t.is_floating_point() or t.dtype in (torch.int32, torch.int64)):
            return t
        dst = normalize_placements(dst, self.mesh.ndim, t.ndim)
        have = _comm.tag_of(t) or tuple(Replicate() for _ in dst)
        partial_grad = _comm.grad_partial(t)
        for i in self._move:
            tp = self._tp[i]
            a, b = have[i], dst[i]
            if tp.size == 1 or a == b:
                continue
            if a.is_replicate() and isinstance(b, Shard):
                t = _comm.narrow(t, tp, b.dim) if partial_grad else _comm.split(t, tp, b.dim)
                partial_grad = False
            elif isinstance(a, Shard) and b.is_replicate():
                partial_grad = tp_region and t.is_floating_point()
                t = _comm.all_gather(t, tp, a.dim, partial_grad)
            elif isinstance(a, Partial) and a.reduce_op == "sum" and b.is_replicate():
                t = _comm.reduce_from_tp(t, tp)
                partial_grad = False
            elif isinstance(a, Partial) and a.reduce_op == "sum" and isinstance(b, Shard):
                t = _comm.reduce_scatter(t, tp, b.dim)
                partial_grad = False
            else:
                raise NotImplementedError(f"activation {a} -> {b} on mesh dim {tp.name}")
        placed = tuple(dst[i] if i in self._move else have[i] for i in range(self.mesh.ndim))
        return _comm.tag(t, placed, partial_grad)

    def _pre(self, module, pi: PlacementsInterface, args, kwargs):
        entries = list(args) + list(kwargs.values())
        plist = pi.input if pi.input is not None else self.default_input_placements
        if plist is not None:
            region = bool(getattr(module, "_tp_region", False))
            pl = _align_placements(plist, len(entries))
            entries = [e if p is None else _tensor_leaves(e, lambda t, p=p: self._move_to(
                t, p, tp_region=region)) for e, p in zip(entries, pl)]
        first = _first_tensor(entries)
        stack = module.__dict__.setdefault("_vtt_in_placements", [])
        stack.append(_comm.tag_of(first) if first is not None else None)
        return tuple(entries[: len(args)]), dict(zip(kwargs.keys(), entries[len(args):]))

    def _post(self, module, pi: PlacementsInterface, out, root: bool):
        inherited = module.__dict__["_vtt_in_placements"].pop()

        def settle(t, p=None):
            if _comm.tag_of(t) is None and inherited is not None:
                _comm.tag(t, inherited)
            return t if p is None else self._move_to(t, p)

        if pi.output is None or (root and self._keep_root_output):
            return _tensor_leaves(out, settle)
        entries = list(out) if isinstance(out, (tuple, list)) else [out]
        pl = _align_placements(pi.output, len(entries))
        res = [_tensor_leaves(e, lambda t, p=p: settle(t, p)) for e, p in zip(entries, pl)]
        if isinstance(out, tuple):
            return tuple(res)
        if isinstance(out, list):
            return res
        return res[0]

    def _bind_forward_plan(self) -> None:
        from ..model.patch.monkey_patch import patch_method

        for fqn, mod in self.module.named_modules():
            for pattern, pi in self.fwd_plan.items():
                pat_fqn, _, method = pattern.rpartition(":")
                if not pat_fqn and ":" not in pattern:
                    pat_fqn, method = method, "forward"
                if not re.fullmatch(pat_fqn, fqn):
                    continue
                self._fwd_matched.add(pattern)
                root = fqn == ""
                if method == "forward":
                    mod.register_forward_pre_hook(
                        lambda m, a, k, pi=pi: self._pre(m, pi, a, k), with_kwargs=True)
                    mod.register_forward_hook(
                        lambda m, a, k, o, pi=pi, root=root: self._post(m, pi, o, root),
                        with_kwargs=True)
                    self._bind_grad_sync(fqn, mod, pi)
                else:
                    old = getattr(mod, method)

                    def wrapped(*a, _old=old, _m=mod, _pi=pi, **k):
                        a, k = self._pre(_m, _pi, a, k)
                        return self._post(_m, _pi, _old(*a, **k), False)

                    patch_method(mod, method, wrapped)
                break

    def _bind_grad_sync(self, fqn: str, mod: nn.Module, pi: PlacementsInterface) -> None:
        """The Replicate parameters of a module whose planned input is
        sharded on a moving dim get Partial gradients there."""
        if pi.input is None:
            return
        dims = set()
        for p in pi.input:
            if p is None:
                continue
            pl = normalize_placements(p, self.mesh.ndim)
            dims |= {i for i in self._move if isinstance(pl[i], Shard) and self.mesh.size(i) > 1}
        for i in sorted(dims):
            for name, prm in mod.named_parameters():
                full = f"{fqn}.{name}" if fqn else name
                if self._specs[full].placements[i].is_replicate():
                    self._sync_params.setdefault(i, []).append(prm)

    def finish_grad_sync(self) -> None:
        """Sum the Partial gradients (``_bind_grad_sync``) over their mesh
        dim: one all-reduce of every such gradient, flattened, a dim."""
        for i, params in self._sync_params.items():
            grads = [p.grad for p in params if p.grad is not None]
            if not grads:
                continue
            flat = torch.cat([g.reshape(-1).float() for g in grads])
            flat = C.mesh_all_reduce(flat, self.mesh, "sum", i)
            off = 0
            for g in grads:
                n = g.numel()
                g.copy_(flat[off:off + n].view_as(g))
                off += n

    def data_parallel_size(self) -> int:
        return self.mesh.size(_BATCH_DIM) if _BATCH_DIM in self.mesh.mesh_dim_names else 1

    # ------------------------------------------------------------- calls
    def _warn_unmatched_fwd_once(self) -> None:
        if self._warned_fwd or not self.fwd_plan:
            return
        self._warned_fwd = True
        # method-scoped entries ("fqn:method") often bind paths the first
        # call never takes (e.g. decode-only attend) — exclude them
        call_plan = {p: v for p, v in self.fwd_plan.items() if ":" not in p}
        self._warn_unmatched(call_plan, self._fwd_matched, "forward")

    def __call__(self, *args, **kwargs):
        out = self.module(*args, **kwargs)
        self._warn_unmatched_fwd_once()
        return out

    def forward_local(self, *args, **kwargs):
        """The call with the root entry's output left where its producer
        put it (tagged)."""
        self._keep_root_output = True
        try:
            return self(*args, **kwargs)
        finally:
            self._keep_root_output = False

    def output_to(self, t: torch.Tensor, placements) -> torch.Tensor:
        """An output of :meth:`forward_local` moved to ``placements``."""
        return self._move_to(t, placements)

    def parameters(self, recurse: bool = True):
        return self.module.parameters(recurse)

    def named_parameters(self, *args, **kwargs):
        return self.module.named_parameters(*args, **kwargs)


def parallelize_module(
    module: nn.Module,
    device_mesh: DeviceMesh,
    sharding_plan: Optional[Dict[str, Any]] = None,
    validate_plan: bool = True,
    *,
    init_fn: Optional[Callable[[], Any]] = None,
) -> DModule:
    """Reference dmodule/api.py:33 — bind ``module`` to ``device_mesh``
    and a sharding plan, in place: its parameters become this rank's
    pieces and the forward plan's hooks are registered.  A module built on
    ``meta`` takes its values from ``init_fn()`` (a flax-layout tree, e.g.
    ``lambda: init_params(config, seed)``), of which only this rank's
    pieces are kept.

    ``validate_plan=False`` silences the matched-nothing warnings."""
    if not device_mesh.is_live and any(device_mesh.size(i) > 1 for i in range(device_mesh.ndim)):
        raise ValueError("parallelize_module needs a live mesh (init_device_mesh) of this "
                         "process's world")
    return DModule(module, device_mesh, sharding_plan or {}, validate_plan=validate_plan,
                   init_fn=init_fn)
