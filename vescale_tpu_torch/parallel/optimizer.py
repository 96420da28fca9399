"""Optimizers: ``AdamWLowmem``, ``BasicOptimizer``, ``DistributedOptimizer``
(ZeRO), ``zero_sharded``, ``clip_grad_norm_fp32``, ``found_inf``.

The port of ``vescale_tpu/parallel/optimizer.py``, written on
``torch.optim`` (the reference is an optax chain):

  * ``AdamWLowmem`` — ``adamw_lowmem``: ``scale_by_adam_lowmem`` (moments
    kept in ``state_dtype``, bf16 by default, all arithmetic in fp32; the
    moment update is ``kernels.fused_adamw_update``, one launch for every
    leaf on the card, in the moments' own storage), then ``add_decayed_weights(weight_decay)``, then
    ``scale_by_learning_rate(lr)``, then ``apply_updates``, in optax's op
    order: ``u + wd * p``, ``(-lr) * u``, ``(p + u)`` in p's dtype.  The
    parameters are updated in place.  Every parameter of a group takes the
    step, as every leaf of the reference's tree does: one whose ``.grad``
    is None is stepped with zero grads.
  * ``BasicOptimizer`` — an optimizer plus an optional global-norm clip.
  * ``DistributedOptimizer`` — ZeRO-2: fp32 main params and the inner
    optimizer's state sharded over the dp dims, each leaf on its first
    free dim that the dp world divides (``zero_placements``, the
    reference's ``_zero_pspec_for``), so each rank's state pieces are the
    reference's shards.  ``reduce_grads`` reduce-scatters the gradients
    into those pieces, the inner optimizer (``AdamWLowmem``: one K8 launch
    over this rank's pieces) steps them, and the params are all-gathered
    back.  Loss scaling (``None``, a float or ``"dynamic"``), the found-inf
    skip (all-reduced over every mesh dim: a step is skipped on every rank
    or none, before the inner step, so a skipped step changes no bit) and
    the global-norm clip (over every dp and tp piece) ride along.
  * ``clip_grad_norm_fp32`` and ``found_inf`` over lists of grads.
  * ``Muon`` (also ``muon``) — the reference's ``muon``: momentum and a quintic
    Newton-Schulz orthogonalization (``newton_schulz``) for the hidden 2-D
    weights, a fallback optimizer (``AdamWLowmem(3e-4)`` with fp32 moments,
    the port's ``optax.adamw(3e-4)``) for every other parameter, split by
    ``muon_labels`` on the parameters' flax paths.

While ndtimeline is active (``ndtimeline.init_ndtimers``) each optimizer's
``step`` records one OPTIMIZER_STEP span (the outermost one when a step
calls another optimizer's, as ``DistributedOptimizer`` and
``BasicOptimizer`` do).  The reference records it only for its eager
optimizer steps; every optimizer of the port is eager.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import collectives as C
from ..kernels.fused_adamw import fused_adamw_update
from ..mesh import DeviceMesh
from ..placements import InterleavedShard, Placement, Replicate, Shard
from ..spec import DArraySpec, TensorMeta
from .ddp import (DEFAULT_BUCKET, bucketed_all_gather, bucketed_all_reduce, bucketed_reduce_scatter,
                  resolve_grad_compress, tree_map)

__all__ = ["AdamWLowmem", "BasicOptimizer", "Muon", "muon", "muon_labels", "newton_schulz",
           "DistributedOptimizer", "EmptyState",
           "ScaleByAdamLowmemState", "param_dtype_groups",
           "clip_grad_norm_fp32", "found_inf", "bias_corrections", "zero_placements",
           "zero_sharded"]


_SPAN_DEPTH = [0]  # > 0 inside an optimizer step that records its span


def _optimizer_step_span(step):
    """Wrap an optimizer's ``step`` in an OPTIMIZER_STEP span while
    ndtimeline is active; a step inside another records none."""
    from ..ndtimeline import api as _nd
    from ..ndtimeline.predefined import OPTIMIZER_STEP

    @functools.wraps(step)
    def wrapped(*args, **kwargs):
        if _SPAN_DEPTH[0] or not _nd.is_active():
            return step(*args, **kwargs)
        _SPAN_DEPTH[0] += 1
        try:
            with _nd.ndtimeit(OPTIMIZER_STEP):
                return step(*args, **kwargs)
        finally:
            _SPAN_DEPTH[0] -= 1

    return wrapped


def _all_reduce_mesh(t: torch.Tensor, mesh: Optional[DeviceMesh], op: str) -> torch.Tensor:
    """``t`` reduced over every dim of a live ``mesh`` (one all-reduce a
    dim of size > 1), or ``t`` itself."""
    if mesh is None or not mesh.is_live:
        return t
    for i in range(mesh.ndim):
        if mesh.size(i) > 1:
            t = C.all_reduce(t, mesh.get_group(i), op)
    return t


def found_inf(grads: Iterable[torch.Tensor], mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Scalar bool tensor: any non-finite value in any grad (the
    reference's ``found_inf``).  With a live ``mesh`` the flag is
    all-reduced (max) over every mesh dim, so every rank agrees, as the
    reference's found_inf_reduce_handler does."""
    flags = [(~torch.isfinite(g)).any() for g in grads if g is not None]
    out = torch.tensor(False) if not flags else flags[0]
    for f in flags[1:]:
        out = torch.logical_or(out, f)
    if mesh is not None and mesh.is_live:
        flag = out.to(device=mesh.device, dtype=torch.int32).reshape(1)
        out = _all_reduce_mesh(flag, mesh, "max")[0] > 0
    return out


def clip_grad_norm_fp32(grads: Sequence[torch.Tensor], max_norm: float,
                        norm_type: int = 2) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Global-norm clip in fp32 (the reference's ``clip_grad_norm_fp32``):
    the norm is taken over grads pre-scaled by the global max |g| so the
    squared sum cannot overflow fp32.  Returns (clipped grads in their own
    dtypes, total norm)."""
    grads = list(grads)
    g32 = [g.float() for g in grads]
    gmax = torch.stack([g.abs().max() for g in g32]).max()
    gmax = torch.maximum(torch.tensor(1e-30, dtype=torch.float32, device=gmax.device), gmax)
    if norm_type == 2:
        total = gmax * torch.sqrt(sum(torch.sum(torch.square(g / gmax)) for g in g32))
    else:
        total = gmax * sum(torch.sum(torch.abs(g / gmax) ** norm_type) for g in g32) ** (
            1.0 / norm_type
        )
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    return [(g * scale).to(o.dtype) for g, o in zip(g32, grads)], total


def bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    """(c1, c2) = (1 - b1**count, 1 - b2**count) computed in fp32, as the
    reference does (``parallel/optimizer.py:513-515``)."""
    n = torch.tensor(float(count), dtype=torch.float32)
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** n
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** n
    return float(c1), float(c2)


class AdamWLowmem(torch.optim.Optimizer):
    """AdamW with ``state_dtype`` moments; see the module docstring.  One
    step counter per parameter group, as optax keeps one per tree."""

    def __init__(self, params, lr: float, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-4,
                 state_dtype: torch.dtype = torch.bfloat16):
        if lr < 0 or eps < 0 or weight_decay < 0:
            raise ValueError(f"lr={lr}, eps={eps}, weight_decay={weight_decay}")
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                        state_dtype=state_dtype, step=0)
        super().__init__(params, defaults)

    @_optimizer_step_span
    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            b1, b2 = group["betas"]
            # a parameter the loss did not read has no grad; the reference
            # gives every leaf one, zeros for an unused leaf, so its moments
            # decay and weight decay applies
            # (vescale_tpu/parallel/optimizer.py:535, :557)
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            for p in params:
                st = self.state[p]
                if not st:
                    st["exp_avg"] = torch.zeros_like(p, dtype=group["state_dtype"])
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=group["state_dtype"])
            group["step"] += 1
            c1, c2 = bias_corrections(b1, b2, group["step"])
            # the moments are updated in their own storage: a state_tree
            # taken before the step still names the live state after it
            us, _, _ = fused_adamw_update(
                grads, [self.state[p]["exp_avg"] for p in params],
                [self.state[p]["exp_avg_sq"] for p in params], c1, c2,
                b1=b1, b2=b2, eps=group["eps"], inplace=True,
            )
            # add_decayed_weights, scale_by_learning_rate, apply_updates;
            # u + wd * p promotes a low-precision u to p's dtype, as in jnp
            us = [u.to(torch.promote_types(u.dtype, p.dtype)) for u, p in zip(us, params)]
            torch._foreach_add_(us, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_mul_(us, -group["lr"])
            if all(u.dtype == p.dtype for u, p in zip(us, params)):
                torch._foreach_add_(params, us)
            else:
                for p, u in zip(params, us):
                    p.copy_(p + u)
        return loss

    # --------------------------------------------------------------- state
    def _named(self, module: torch.nn.Module):
        """[(group, dotted name, param)] over every parameter group, named
        by ``module``, and the groups' one step count (the groups of one
        tree step together, as optax's one count does)."""
        names = {id(p): n for n, p in module.named_parameters()}
        named = []
        for group in self.param_groups:
            missing = [i for i, p in enumerate(group["params"]) if id(p) not in names]
            if missing:
                raise ValueError(f"state_tree: parameters {missing[:5]} are not in the module")
            named += [(group, names[id(p)], p) for p in group["params"]]
        steps = {g["step"] for g in self.param_groups}
        if len(steps) != 1:
            raise ValueError(f"state_tree: parameter groups at different steps {sorted(steps)}")
        return named, steps.pop()

    def state_tree(self, module: torch.nn.Module):
        """The state in the reference ``adamw_lowmem`` layout, its moment
        trees keyed by ``module``'s parameter names as ``models.
        module_tree`` keys the parameters: optax's chain
        ``(ScaleByAdamLowmemState(count, mu, nu), EmptyState(),
        EmptyState())``, which a checkpoint names ``0/.count``,
        ``0/.mu/<param>`` and ``0/.nu/<param>``.  ``count`` is a 0-d int32
        tensor; the moments are the live state tensors (zeros of their
        group's ``state_dtype`` before the first step), not copies.  Every
        parameter group goes into the one tree (``param_dtype_groups``)."""
        named, step = self._named(module)
        mu: Dict[str, Any] = {}
        nu: Dict[str, Any] = {}
        for group, name, p in named:
            st = self.state[p]
            if not st:
                st["exp_avg"] = torch.zeros_like(p, dtype=group["state_dtype"])
                st["exp_avg_sq"] = torch.zeros_like(p, dtype=group["state_dtype"])
            _set_path(mu, name, st["exp_avg"])
            _set_path(nu, name, st["exp_avg_sq"])
        count = torch.tensor(step, dtype=torch.int32)
        return (ScaleByAdamLowmemState(count, mu, nu), EmptyState(), EmptyState())

    @torch.no_grad()
    def load_state_tree(self, state, module: torch.nn.Module) -> None:
        """Restore from a tree laid out as :meth:`state_tree` (a
        reference checkpoint's ``"optimizer"`` branch included): the step
        count (the bias corrections come from it) and the moments, copied
        into the live state tensors where they exist."""
        named, _ = self._named(module)
        inner = state[0]
        for group, name, p in named:
            st = self.state[p]
            for key, tree in (("exp_avg", inner.mu), ("exp_avg_sq", inner.nu)):
                src = torch.as_tensor(_get_path(tree, name))
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(f"load_state_tree: {name} has shape {tuple(src.shape)}, "
                                     f"the parameter {tuple(p.shape)}")
                if key in st:
                    st[key].copy_(src)
                else:
                    st[key] = src.to(device=p.device, dtype=group["state_dtype"]).clone()
        for group in self.param_groups:
            group["step"] = int(torch.as_tensor(inner.count))


def param_dtype_groups(params) -> List[Dict[str, Any]]:
    """``params`` as ``AdamWLowmem`` parameter groups, one a dtype in the
    order each dtype first appears, each with ``state_dtype`` its
    parameters' dtype: optax keeps an ``adamw``'s moments in each
    parameter's own dtype.  So a model of fp32 and bf16 leaves (Mixtral:
    bf16 experts) takes two fused AdamW launches a step, fp32 moments for
    the fp32 leaves and bf16 for the bf16 ones.  (optax does a bf16 leaf's
    moment arithmetic in bf16; the kernel does it in fp32 and rounds the
    moments to bf16.)"""
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        groups.setdefault(p.dtype, []).append(p)
    return [{"params": ps, "state_dtype": dt} for dt, ps in groups.items()]


def _set_path(tree: Dict[str, Any], dotted: str, value) -> None:
    *path, leaf = dotted.split(".")
    for key in path:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


def _get_path(tree, dotted: str):
    for key in dotted.split("."):
        tree = tree[key]
    return tree


class BasicOptimizer:
    """An optimizer plus an optional global-norm clip of the grads before
    its step (the reference's ``BasicOptimizer``)."""

    def __init__(self, optimizer: torch.optim.Optimizer, grad_clip: Optional[float] = None):
        self.optimizer = optimizer
        self.grad_clip = grad_clip

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @_optimizer_step_span
    @torch.no_grad()
    def step(self):
        if self.grad_clip is not None:
            params = [p for g in self.optimizer.param_groups for p in g["params"]
                      if p.grad is not None]
            clipped, _ = clip_grad_norm_fp32([p.grad for p in params], self.grad_clip)
            for p, g in zip(params, clipped):
                p.grad = g
        self.optimizer.step()


# -------------------------------------------------------------------- muon
_NS_COEFFS = (3.4445, -4.7750, 2.0315)
# a parameter whose lower-cased flax path holds one of these goes to the
# fallback optimizer (reference ``parallel/optimizer.py:623``)
_MUON_EXCLUDE = ("embed", "embedding", "wte", "wpe", "lm_head", "head")


def newton_schulz(G: torch.Tensor, steps: int = 5, eps: float = 1e-7) -> torch.Tensor:
    """The reference's quintic Newton-Schulz orthogonalization of a 2-D
    ``G`` (``parallel/optimizer.py::_newton_schulz``), with its dtypes: G
    is rounded to bf16 once, then divided by its fp32 Frobenius norm,
    which promotes it to fp32, so the ``steps`` iterations run in fp32
    (as JAX promotes them); the result is cast back to G's dtype.  On the
    card the products are fp32 matmuls, true fp32 while
    ``torch.backends.cuda.matmul.allow_tf32`` stays off (PyTorch's
    default)."""
    a, b, c = _NS_COEFFS
    X = G.to(torch.bfloat16).float()
    X = X / (torch.linalg.vector_norm(X) + eps)
    transpose = G.shape[0] > G.shape[1]
    if transpose:
        X = X.T
    for _ in range(steps):
        A = X @ X.T
        B = b * A + c * (A @ A)
        X = a * X + B @ X
    if transpose:
        X = X.T
    return X.to(G.dtype)


def muon_labels(named_params) -> Dict[str, str]:
    """``{name: "muon" | "fallback"}`` over ``(name, parameter)`` pairs,
    the reference's labels: a parameter goes to the fallback when it is not
    2-D or when its lower-cased name (the flax path, e.g. from
    ``named_parameters()`` of the port's models) holds ``embed``,
    ``embedding``, ``wte``, ``wpe``, ``lm_head`` or ``head``."""
    out = {}
    for name, p in named_params:
        path = name.lower()
        out[name] = ("fallback" if p.dim() != 2 or any(tok in path for tok in _MUON_EXCLUDE)
                     else "muon")
    return out


def _default_fallback(params):
    # optax.adamw(3e-4): b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4,
    # moments in the parameters' (fp32) dtype
    return AdamWLowmem(params, 3e-4, state_dtype=torch.float32)


class Muon(torch.optim.Optimizer):
    """Muon over named parameters (the reference's ``muon``, an optax
    ``multi_transform``).  ``named_params``: ``(name, parameter)`` pairs,
    e.g. ``model.named_parameters()``; :func:`muon_labels` splits them.

    Each "muon" parameter (2-D, in flax's (in, out) layout) keeps a
    momentum buffer in ``state_dtype`` (its own dtype when None); a step
    computes, in the gradient's dtype, ``m = momentum * m + g`` (stored
    back in ``state_dtype``), ``eff = momentum * m + g`` under ``nesterov``
    (else ``m``), the update ``-lr * sqrt(max(1, shape[1] / shape[0])) *
    newton_schulz(eff, ns_steps)`` in fp32 cast to the gradient's dtype,
    and adds it to the parameter in the parameter's dtype.  A parameter
    without a gradient steps with zeros, as every leaf of the reference's
    tree does.  ``fallback`` builds the optimizer of the other parameters
    from their list (default: ``AdamWLowmem(params, 3e-4,
    state_dtype=torch.float32)``, the port's ``optax.adamw(3e-4)``); it is
    ``self.fallback`` and steps in the same ``step``, after the Muon
    updates.  ``self.labels`` holds the split."""

    def __init__(self, named_params, lr: float = 0.02, momentum: float = 0.95,
                 nesterov: bool = True, ns_steps: int = 5,
                 fallback: Optional[Callable[[List[torch.Tensor]], Any]] = None,
                 state_dtype: Optional[torch.dtype] = None):
        named = list(named_params)
        if not named:
            raise ValueError("Muon: no parameters")
        self.labels = muon_labels(named)
        hidden = [p for n, p in named if self.labels[n] == "muon"]
        rest = [p for n, p in named if self.labels[n] == "fallback"]
        defaults = dict(lr=lr, momentum=momentum, nesterov=nesterov, ns_steps=ns_steps,
                        state_dtype=state_dtype)
        # one group, empty when no parameter is a hidden 2-D weight (then
        # only the fallback steps)
        super().__init__([{"params": hidden}], defaults)
        self.fallback = (fallback or _default_fallback)(rest) if rest else None

    def zero_grad(self, set_to_none: bool = True) -> None:
        super().zero_grad(set_to_none=set_to_none)
        if self.fallback is not None:
            self.fallback.zero_grad(set_to_none=set_to_none)

    @_optimizer_step_span
    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            mom = group["momentum"]
            for p in group["params"]:
                g = torch.zeros_like(p) if p.grad is None else p.grad
                st = self.state[p]
                if not st:
                    st["momentum_buffer"] = torch.zeros_like(
                        p, dtype=group["state_dtype"] or p.dtype)
                m = st["momentum_buffer"]
                m_new = (mom * m.to(g.dtype) + g).to(m.dtype)
                m.copy_(m_new)
                eff = mom * m_new.to(g.dtype) + g if group["nesterov"] else m_new.to(g.dtype)
                o = newton_schulz(eff, group["ns_steps"]).float()
                # -lr * sqrt(max(1, fan_out / fan_in)), rounded to fp32 as
                # JAX rounds it, then a host scalar exact in fp32
                scale = torch.sqrt(torch.tensor(max(1.0, g.shape[1] / g.shape[0]),
                                                dtype=torch.float32))
                coeff = float(torch.tensor(-group["lr"], dtype=torch.float32) * scale)
                u = (coeff * o).to(g.dtype)
                p.copy_(p + u.to(torch.promote_types(u.dtype, p.dtype)))
        if self.fallback is not None:
            self.fallback.step()
        return loss


# the reference's name: muon(named_params, 0.02, fallback=..., state_dtype=...)
muon = Muon


# -------------------------------------------------------------------- ZeRO
class ScaleByAdamLowmemState(NamedTuple):
    """The reference's ``scale_by_adam_lowmem`` state: the step counter
    and the two moment trees (``inner/0/.count``, ``.mu``, ``.nu`` in a
    checkpoint, as optax's chain names them)."""

    count: Any
    mu: Any
    nu: Any


class EmptyState(NamedTuple):
    """optax's stateless transforms' state (``add_decayed_weights``,
    ``scale_by_learning_rate`` in the chain): no leaves."""


def zero_placements(shape: Sequence[int], placements: Sequence[Placement], mesh: DeviceMesh,
                    dp_dims: Sequence[str]) -> Tuple[Placement, ...]:
    """The ZeRO placements of a state leaf of a parameter laid out as
    ``placements`` (the reference's ``_zero_pspec_for``): the dp mesh dims
    shard the first tensor dim that no mesh dim shards and that the dp
    world divides.  A leaf already sharded on a dp dim, too small or
    indivisible keeps ``placements``."""
    placements = tuple(placements)
    dp_idx = [mesh._dim_index(d) for d in dp_dims]
    if any(not placements[i].is_replicate() for i in dp_idx):
        return placements
    used = set()
    for p in placements:
        if isinstance(p, (Shard, InterleavedShard)):
            used.add(p.dim)
        elif not (p.is_replicate() or p.is_partial()):
            return placements  # ragged: the whole tensor is already cut
    dp_total = 1
    for i in dp_idx:
        dp_total *= mesh.size(i)
    for d, s in enumerate(shape):
        if d not in used and s % dp_total == 0 and s >= dp_total:
            new = list(placements)
            for i in dp_idx:
                new[i] = Shard(d)
            return tuple(new)
    return placements


def _flat_specs(tree, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat_specs(v, path))
        else:
            out[path] = v
    return out


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Dotted names to the nested dict of the flax tree."""
    tree: Dict[str, Any] = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


class _ZeroLeaf:
    """One parameter under ZeRO: its global spec, the state spec, the
    tensor dim the dp dims cut (None: not cut) and this rank's offset and
    extent on it; for a leaf not cut, the dp mesh dims its gradient is
    averaged over (those it is replicated on) and the factor that makes a
    gradient already summed over the others (a leaf the plan shards over
    "dp", gathered in the forward) their average."""

    __slots__ = ("name", "param", "spec", "zspec", "dim", "offset", "size", "reduce", "scale")

    def __init__(self, name, param, spec, zspec, dim, offset, size, reduce=(), scale=1.0):
        self.name, self.param, self.spec, self.zspec = name, param, spec, zspec
        self.dim, self.offset, self.size = dim, offset, size
        self.reduce, self.scale = reduce, scale


class DistributedOptimizer:
    """ZeRO-2 optimizer (reference ``DistributedOptimizer``, legacy
    ``distributed_optimizer.py:131``).

    ``optimizer`` makes the inner optimizer from a list of tensors, e.g.
    ``functools.partial(AdamWLowmem, lr=3e-4)``; it steps this rank's fp32
    main-param pieces.  ``models`` is the model: a ``DModule`` (its mesh
    and parameter specs are the defaults), a module, or a dict of named
    tensors, each this rank's piece under ``param_specs`` (a dict, flat or
    nested, of ``DArraySpec``; default Replicate).  Without a ``mesh``
    nothing is sharded and no collective runs.  A step::

        dopt.zero_grad()
        dopt.scale_loss(loss).backward()
        dm.finish_grad_sync()       # tensor-parallel sums, if any
        dopt.reduce_grads()         # dp reduce-scatter into the pieces
        dopt.step()

    Each rank's gradient is its own contribution (the gradient of its
    rows' mean loss); ``reduce_grads`` averages over the dp dim.  With
    ``loss_scale="dynamic"`` (or a float), ``step`` unscales, all-reduces
    the found-inf flag over every mesh dim and, on overflow, skips: the
    params, the main params, the moments and the step counter are left
    bit for bit, and the dynamic scale backs off (never below
    ``min_scale``); after ``growth_interval`` clean steps it grows.  The
    flag is read on the host each step.  ``state_tree`` is the
    reference's state layout (``inner/0/.mu``, ``main_params``,
    ``loss_scale``) as ``DArray``s; ``state_template`` the same without
    data, for ``checkpoint.load``.

    Over several dp mesh dims (``dp_dims=("dp", "ep")``, in mesh order) a
    cut leaf's state is cut over their flattened grid (the reference's
    ``P(("dp", "ep"))``) and its gradient reduce-scattered over the
    flattened group; a leaf already sharded on one of them (the experts'
    ``Shard(0)`` over "ep") keeps its placements and its gradient is
    averaged over the dp dims it is replicated on.  A leaf a ``DModule``'s
    plan shards over "dp" (``DModule.dp_sharded``) arrives with the dp
    ranks' gradients summed by its forward's gather, and is scaled to
    their average.
    """

    def __init__(self, optimizer: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
                 mesh: Optional[DeviceMesh] = None, param_specs=None, models=None,
                 dp_dims: Sequence[str] = ("dp",), grad_clip: Optional[float] = None,
                 main_param_dtype: torch.dtype = torch.float32, loss_scale=None, init_scale: float = 2.0 ** 15, growth_interval: int = 2000,
                 growth_factor: float = 2.0, backoff_factor: float = 0.5, min_scale: float = 1.0,
                 skip_nonfinite: Optional[bool] = None, grad_compress: Optional[str] = None,
                 compress_block: Optional[int] = None, **_: Any):
        from ..dmodule import DModule

        if models is None:
            raise ValueError("DistributedOptimizer needs models= (a DModule, module or dict)")
        if isinstance(models, DModule):
            mesh = mesh if mesh is not None else models.mesh
            if param_specs is None:
                param_specs = dict(models._specs)
            named = list(models.module.named_parameters())
        elif isinstance(models, torch.nn.Module):
            named = list(models.named_parameters())
        else:
            named = list(_flat_specs(models).items())
        specs = _flat_specs(param_specs) if param_specs is not None else {}
        self.mesh = mesh
        self.dp_dims = tuple(dp_dims)
        self.grad_compress = resolve_grad_compress(grad_compress)
        self.compress_block = compress_block
        self.grad_clip = grad_clip
        self.main_param_dtype = main_param_dtype
        self.loss_scale = loss_scale
        self.init_scale = float(init_scale)
        self.growth_interval = int(growth_interval)
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        if float(min_scale) <= 0.0:
            raise ValueError(f"min_scale must be > 0, got {min_scale}")
        # the floor sits at most at init_scale, so a backoff never raises it
        self.min_scale = min(float(min_scale), float(init_scale))
        self.skip_nonfinite = (loss_scale is not None) if skip_nonfinite is None else skip_nonfinite
        if loss_scale == "dynamic" and not self.skip_nonfinite:
            raise ValueError("loss_scale='dynamic' requires skip_nonfinite: the scale's backoff "
                             "and growth are driven by the overflow flag")
        live = mesh is not None and mesh.is_live
        coord = mesh.get_coordinate() if live else (0,) * (mesh.ndim if mesh is not None else 0)
        self._rank = mesh.get_rank() if live else 0
        # the dp mesh dims that split anything (size > 1), in mesh order
        self._dp_idx: Tuple[int, ...] = ()
        if mesh is not None:
            idx = [mesh._dim_index(d) for d in self.dp_dims]
            if idx != sorted(set(idx)):
                raise ValueError(f"dp_dims {self.dp_dims} must be distinct and in mesh order "
                                 f"{mesh.mesh_dim_names}")
            self._dp_idx = tuple(i for i in idx if mesh.size(i) > 1)
            if self.grad_compress is not None and len(self._dp_idx) > 1:
                raise NotImplementedError("grad_compress over more than one dp mesh dim")
        gathered = getattr(models, "dp_sharded", set())
        self.leaves: List[_ZeroLeaf] = []
        mains = []
        for name, p in named:
            spec = specs.get(name)
            reduce, scale = (), 1.0
            if mesh is None:
                spec = zspec = None
                dim, off, size = None, 0, 0
            else:
                if not isinstance(spec, DArraySpec):
                    spec = DArraySpec(mesh, spec if spec is not None else [Replicate()] * mesh.ndim,
                                      TensorMeta(tuple(p.shape), p.dtype))
                zpl = zero_placements(spec.shape, spec.placements, mesh, self.dp_dims)
                zspec = DArraySpec(mesh, zpl, TensorMeta(spec.shape, main_param_dtype))
                dim = next((zpl[i].dim for i in (mesh._dim_index(d) for d in self.dp_dims)
                            if zpl[i] != spec.placements[i]), None)
                off = size = 0
                if dim is not None:
                    shape, offs = zspec.local_chunk(coord)
                    off, size = offs[dim], shape[dim]
                    if live and self._dp_idx:
                        j = dist.get_rank(self._group())
                        if off != j * size:  # the flattened group's chunk order
                            raise ValueError(f"{name}: ZeRO piece at {off} is not chunk {j} of "
                                             f"the flattened {self.dp_dims} group")
                else:
                    reduce = tuple(i for i in self._dp_idx if spec.placements[i].is_replicate())
                    if name in gathered:
                        for i in self._dp_idx:
                            if not spec.placements[i].is_replicate():
                                scale /= mesh.size(i)
            leaf = _ZeroLeaf(name, p, spec, zspec, dim, off, size, reduce, scale)
            src = p.detach()
            if dim is not None:
                src = src.narrow(dim, off, size)
            mains.append(src.to(main_param_dtype, copy=True, memory_format=torch.contiguous_format))
            self.leaves.append(leaf)
        self.main_params = mains
        self.inner = optimizer(mains)
        self._pieces: Optional[List[torch.Tensor]] = None
        self.loss_scale_state = None
        if loss_scale == "dynamic":
            self.loss_scale_state = {"scale": torch.tensor(self.init_scale, dtype=torch.float32),
                                     "growth_count": torch.tensor(0, dtype=torch.int32),
                                     "skip_count": torch.tensor(0, dtype=torch.int32)}

    # ------------------------------------------------------- loss scaling
    def current_scale(self) -> float:
        if self.loss_scale == "dynamic":
            return float(self.loss_scale_state["scale"])
        if self.loss_scale is not None:
            return float(np.float32(self.loss_scale))
        return 1.0

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The loss times the current scale (call before ``backward``)."""
        return loss * torch.tensor(self.current_scale(), dtype=loss.dtype, device=loss.device)

    # ----------------------------------------------------- grad reduction
    def zero_grad(self, set_to_none: bool = True) -> None:
        for leaf in self.leaves:
            leaf.param.grad = None
        self._pieces = None

    def _group(self, dims: Optional[Sequence[int]] = None):
        """The process group over the flattened dp mesh dims ``dims``
        (default: every dp dim of size > 1)."""
        dims = self._dp_idx if dims is None else dims
        return self.mesh.get_group(tuple(self.mesh.dim_name(i) for i in dims))

    def dp_group(self):
        """The group of the ranks whose gradients this optimizer averages
        (the flattened dp dims), or None when nothing is averaged."""
        if self.mesh is None or not self.mesh.is_live or not self._dp_idx:
            return None
        return self._group()

    def reduce_grads(self, grads=None, dp_dim: Optional[str] = None):
        """With ``grads`` (a tree of ``DArray``s): each leaf Partial on the
        dp dim reduced there to Shard(0) when dim 0 divides the dp world,
        else to Replicate; int8 with ``grad_compress``; other leaves
        unchanged (the reference's ``reduce_grads``).  Without: the
        parameters' gradients averaged over the dp dim into this rank's
        state pieces, in flat buckets (reduce-scatter for the ZeRO-cut
        leaves, all-reduce for the others); the parameters' ``.grad`` is
        released."""
        from ..darray import DArray
        from .ddp import _reduce_partial_leaf

        if grads is not None:
            if self.mesh is None:
                return grads
            dp_index = self.mesh._dim_index(dp_dim or self.dp_dims[0])
            n = self.mesh.size(dp_index)

            def one(g):
                if not (isinstance(g, DArray) and g.placements[dp_index].is_partial()):
                    return g
                target = Shard(0) if g.shape and g.shape[0] % n == 0 else Replicate()
                return _reduce_partial_leaf(g, dp_index, target, self.grad_compress,
                                            self.compress_block)

            return tree_map(one, grads, is_leaf=lambda x: isinstance(x, DArray))
        grads = [leaf.param.grad if leaf.param.grad is not None else torch.zeros_like(leaf.param)
                 for leaf in self.leaves]
        if self.dp_group() is None:
            pieces = [g.narrow(leaf.dim, leaf.offset, leaf.size) if leaf.dim is not None else g
                      for g, leaf in zip(grads, self.leaves)]
        else:
            group = self._group()
            kw = dict(compress=self.grad_compress, block=self.compress_block, mesh=self.mesh,
                      mesh_dim=self._dp_idx[0])
            pieces = [None] * len(grads)
            by_dims: Dict[Tuple[int, ...], List[int]] = {}
            for i, leaf in enumerate(self.leaves):
                if leaf.dim is None:
                    by_dims.setdefault(leaf.reduce, []).append(i)
            for dims, whole in by_dims.items():
                g32 = [grads[i].float() if self.leaves[i].scale == 1.0 else
                       grads[i].float() * self.leaves[i].scale for i in whole]
                if dims:
                    bucketed_all_reduce(g32, self._group(dims), "avg", DEFAULT_BUCKET,
                                        **dict(kw, mesh_dim=dims[0]))
                for i, g in zip(whole, g32):
                    pieces[i] = g
            cut = [i for i, leaf in enumerate(self.leaves) if leaf.dim is not None]
            flats = [grads[i].float().movedim(self.leaves[i].dim, 0).contiguous().view(-1)
                     for i in cut]
            outs = bucketed_reduce_scatter(flats, group, "avg", DEFAULT_BUCKET, **kw)
            for i, out in zip(cut, outs):
                leaf = self.leaves[i]
                moved = list(grads[i].movedim(leaf.dim, 0).shape)
                moved[0] = leaf.size
                pieces[i] = out.view(moved).movedim(0, leaf.dim)
        for leaf in self.leaves:
            leaf.param.grad = None
        self._pieces = pieces
        return None

    # -------------------------------------------------------------- step
    def _clip(self, g32: List[torch.Tensor]) -> List[torch.Tensor]:
        """The global-norm clip of ``clip_grad_norm_fp32`` over every dp
        and tp piece: each element counted once (a piece replicated on a
        mesh dim counts at its coordinate 0 only)."""
        dev = g32[0].device if g32 else torch.device("cpu")
        live = self.mesh is not None and self.mesh.is_live
        coord = self.mesh.get_coordinate() if live else None
        amax = torch.stack([g.abs().max() if g.numel() else torch.zeros((), device=dev)
                            for g in g32]).max().reshape(1)
        gmax = torch.clamp(_all_reduce_mesh(amax, self.mesh, "max"), min=1e-30)
        sq = torch.zeros(1, dtype=torch.float32, device=dev)
        for g, leaf in zip(g32, self.leaves):
            if coord is not None and any(coord[i] != 0 for i, p in enumerate(leaf.zspec.placements)
                                         if p.is_replicate()):
                continue
            sq = sq + torch.sum(torch.square(g / gmax))
        total = gmax * torch.sqrt(_all_reduce_mesh(sq, self.mesh, "sum"))
        scale = torch.clamp(self.grad_clip / (total + 1e-6), max=1.0)
        return [g * scale for g in g32]

    def _update_scale(self, overflow: bool) -> None:
        ls = self.loss_scale_state
        if ls is None:
            return
        f32 = np.float32
        scale = f32(ls["scale"])
        growth = 0 if overflow else int(ls["growth_count"]) + 1
        grown = growth >= self.growth_interval
        if overflow:
            scale = max(f32(scale * f32(self.backoff_factor)), f32(self.min_scale))
        elif grown:
            scale = f32(scale * f32(self.growth_factor))
        ls["scale"] = torch.tensor(float(scale), dtype=torch.float32)
        ls["growth_count"] = torch.tensor(0 if grown else growth, dtype=torch.int32)
        ls["skip_count"] = torch.tensor(int(ls["skip_count"]) + 1 if overflow else 0,
                                        dtype=torch.int32)

    @_optimizer_step_span
    @torch.no_grad()
    def step(self) -> bool:
        """Unscale, check, clip, step the pieces, gather the params (the
        reference's ``step``).  Returns whether the step was skipped."""
        if self._pieces is None:
            self.reduce_grads()
        pieces, self._pieces = self._pieces, None
        inv = float(np.float32(1.0) / np.float32(self.current_scale()))
        g32 = [g.to(self.main_param_dtype).contiguous() for g in pieces]  # K8 takes dense leaves
        if inv != 1.0:
            g32 = [g * torch.tensor(inv, dtype=g.dtype, device=g.device) for g in g32]
        overflow = bool(found_inf(g32, self.mesh)) if self.skip_nonfinite else False
        if overflow:
            self._update_scale(True)
            return True
        if self.grad_clip is not None:
            g32 = self._clip(g32)
        for m, g in zip(self.main_params, g32):
            m.grad = g
        self.inner.step()
        for m in self.main_params:
            m.grad = None
        del g32, pieces
        self._write_params()
        self._update_scale(False)
        return False

    def _write_params(self) -> None:
        """main -> params: the ZeRO-cut leaves all-gathered over the dp dim
        (flat buckets), the others copied."""
        cut = [i for i, leaf in enumerate(self.leaves) if leaf.dim is not None]
        for i, leaf in enumerate(self.leaves):
            if leaf.dim is None:
                leaf.param.data.copy_(self.main_params[i].to(leaf.param.dtype))
        if not cut:
            return
        if self.dp_group() is None:
            for i in cut:
                self.leaves[i].param.data.copy_(self.main_params[i].to(self.leaves[i].param.dtype))
            return
        outs, writes = [], []
        for i in cut:
            leaf, m = self.leaves[i], self.main_params[i]
            p = leaf.param.data
            if leaf.dim == 0 and p.dtype == m.dtype and p.is_contiguous():
                outs.append(p.view(-1))
                writes.append(None)
            else:
                moved = p.movedim(leaf.dim, 0)
                outs.append(torch.empty(moved.numel(), dtype=m.dtype, device=m.device))
                writes.append(tuple(moved.shape))
        sources = [self.main_params[i].movedim(self.leaves[i].dim, 0).contiguous() for i in cut]
        bucketed_all_gather(sources, outs, self._group(), DEFAULT_BUCKET)
        for i, out, shape in zip(cut, outs, writes):
            if shape is not None:
                leaf = self.leaves[i]
                leaf.param.data.copy_(out.view(shape).movedim(0, leaf.dim).to(leaf.param.dtype))

    # ------------------------------------------------------------- state
    def _darray(self, leaf: _ZeroLeaf, local, dtype):
        from ..darray import DArray

        spec = DArraySpec(self.mesh, leaf.zspec.placements, TensorMeta(leaf.zspec.shape, dtype))
        return DArray(local, spec, self._rank)

    def _inner_state(self):
        if not isinstance(self.inner, AdamWLowmem):
            raise TypeError(f"state_tree lays out AdamWLowmem's state, not "
                            f"{type(self.inner).__name__}'s")
        group = self.inner.param_groups[0]
        sd = group["state_dtype"]
        mus, nus = [], []
        for m in self.main_params:
            st = self.inner.state.get(m) or {}
            mus.append(st.get("exp_avg", torch.zeros_like(m, dtype=sd)))
            nus.append(st.get("exp_avg_sq", torch.zeros_like(m, dtype=sd)))
        return group, mus, nus

    def _tree(self, leaf_fn, scalar_fn):
        group, mus, nus = self._inner_state()
        sd = group["state_dtype"]

        def tree(values, dtype):
            return _nest({leaf.name: leaf_fn(leaf, v, dtype)
                          for leaf, v in zip(self.leaves, values)})

        state = {"inner": [ScaleByAdamLowmemState(
                     scalar_fn(torch.tensor(group["step"], dtype=torch.int32)),
                     tree(mus, sd), tree(nus, sd))],
                 "main_params": tree(self.main_params, self.main_param_dtype)}
        if self.loss_scale_state is not None:
            state["loss_scale"] = {k: scalar_fn(v.clone()) for k, v in self.loss_scale_state.items()}
        return state

    def state_tree(self):
        """This rank's optimizer state in the reference's layout:
        ``{"inner": [ScaleByAdamLowmemState(count, mu, nu)], "main_params":
        ..., "loss_scale": {...}}`` with ``DArray`` pieces (plain tensors
        without a mesh) and 0-d host tensors for the scalars."""
        if self.mesh is None:
            return self._tree(lambda leaf, v, dt: v, lambda t: t)
        return self._tree(lambda leaf, v, dt: self._darray(leaf, v, dt), lambda t: t)

    def state_placements(self):
        """The placements of every state leaf (None for the host scalars):
        the counterpart of the reference's ``state_pspecs``."""
        if self.mesh is None:
            return self._tree(lambda leaf, v, dt: None, lambda t: None)
        return self._tree(lambda leaf, v, dt: leaf.zspec.placements, lambda t: None)

    def state_template(self):
        """``state_tree``'s layout with no data: ``DArray`` templates for
        ``checkpoint.load``, which fills each rank's pieces from whichever
        saved chunks intersect them (an elastic restore across dp worlds)."""
        if self.mesh is None:
            return self._tree(lambda leaf, v, dt: torch.empty_like(v), lambda t: torch.zeros_like(t))
        return self._tree(lambda leaf, v, dt: self._darray(leaf, None, dt),
                          lambda t: torch.zeros_like(t))

    @torch.no_grad()
    def load_state_tree(self, state) -> None:
        """Restore from a tree laid out as ``state_tree`` (e.g. what
        ``checkpoint.load`` returned for ``state_template()``)."""
        from ..darray import DArray
        from ..models.convert import _flatten

        def local(x, like):
            t = x.to_local() if isinstance(x, DArray) else torch.as_tensor(x)
            return t.to(device=like.device, dtype=like.dtype).reshape(like.shape)

        inner = state["inner"][0]
        mains = _flatten(state["main_params"])
        mus, nus, count = _flatten(inner.mu), _flatten(inner.nu), inner.count
        group, cur_mu, cur_nu = self._inner_state()
        for leaf, m, mu, nu in zip(self.leaves, self.main_params, cur_mu, cur_nu):
            m.copy_(local(mains[leaf.name], m))
            st = self.inner.state[m]
            st["exp_avg"] = local(mus[leaf.name], mu)
            st["exp_avg_sq"] = local(nus[leaf.name], nu)
        group["step"] = int(torch.as_tensor(count))
        if self.loss_scale_state is not None and "loss_scale" in state:
            for k in self.loss_scale_state:
                self.loss_scale_state[k] = torch.as_tensor(state["loss_scale"][k]).clone().cpu()
        self._write_params()


def zero_sharded(optimizer: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
                 mesh: DeviceMesh, param_specs=None, dp_dims: Sequence[str] = ("dp",), *,
                 models=None, **kwargs) -> DistributedOptimizer:
    """``optimizer`` with its state (and fp32 main params) ZeRO-sharded
    over ``dp_dims``: a ``DistributedOptimizer`` without loss scaling."""
    return DistributedOptimizer(optimizer, mesh, param_specs, models=models, dp_dims=dp_dims,
                                **kwargs)
