"""The train step: forward, loss, backward and one optimizer update.

The port of the single-device core of ``vescale_tpu/train.py::
make_train_step``.  PyTorch runs eagerly, so the step is a plain function
over a module and an optimizer that updates the parameters in place,
where the reference returns new params and optimizer state from one
compiled program.

Over a ``DModule`` (``dmodule.parallelize_module``) the step runs tensor
and sequence parallel: the model's output stays vocab-sharded (a Partial
tied head is reduce-scattered to it) and goes to ``loss_fn`` as this
rank's slice, the Partial gradients are summed (``finish_grad_sync``)
before the optimizer steps this rank's parameter pieces (the fused AdamW
on local shards, as the reference's custom_partitioning rule runs it).

Over a "dp" mesh dim of size > 1 each rank computes on its own rows, and
the gradient is then averaged over "dp": by a ``DistributedDataParallel``
(passed as ``model``, or made with its defaults around a ``DModule``), or
by ``DistributedOptimizer.reduce_grads`` into its ZeRO pieces.  With a
``DistributedOptimizer`` the loss is scaled before backward and reported
unscaled, as the reference's step does (``vescale_tpu/train.py:221-228``).
The reported loss is the mean over the dp ranks.

While ndtimeline is active (``ndtimeline.init_ndtimers``), each step is
one TRAIN_STEP span (a host region around the step's launches, also a
``torch.profiler`` range) and, with ``auto_inc_step`` (default), advances
the ndtimeline step counter, as the reference's step does
(``train.py:256-300``).  While telemetry is on (``telemetry.init`` before
the step runs), each step reads its loss on the host (the sync that makes
the step time wall clock, the observability trade a telemetry run opts
into), arms the train alert pack and records ``step_time_s``, ``loss``,
``tokens``, ``tokens_per_sec`` and ``grad_norm`` (the global fp32 norm of
the grads before the update, unscaled), and under a
``DistributedOptimizer`` with loss scaling ``loss_scale`` and
``skip_count``, through ``telemetry.record_step`` (reference
``train.py:231-343``).  None of this changes a number of the step.

:class:`FunctionalStep` wraps the in-place step in the reference's
functional signature, ``step_fn(params, opt_state, batch[, step_key]) ->
(params, opt_state, loss)``, for ``resilience.run_resilient``.

An fp8 model (``LlamaConfig.use_fp8``) carries the reference's
``_overwrite_with_gradient`` collection as the fp8 ops' state buffers
(``quant.fp8.owg_buffers``).  They never meet the optimizer: after the
backward each buffer's gradient is its next value, and the step copies
it in under a finite guard, so an overflow step cannot poison the
histories (reference ``train.py:207-216``).  Under grad accumulation the
histories combine by elementwise max over the micro-batches and the
scales come from the latest one (``train.py:163-182``).  With a
``DistributedOptimizer``'s loss scale the g histories record the scaled
gradients, as the reference's do.

The step takes the reference's ``step_key`` (a ``random`` key): each
stream of ``rng_streams`` gets ``fold_in(step_key, i)`` and the model runs
with ``deterministic=False, rngs=...`` (the GPT's dropout), micro-batch
``i`` of a grad accumulation under ``fold_in(step_key, 1000 + i)``
(reference ``train.py:103-114``, ``:155``); with no key the forward is the
deterministic one.  Over "dp" each rank draws its rows of the global
batch's masks (``random.batch_rows``).  :func:`make_eval_step` is the
reference's eval step: the deterministic forward and the loss, no
gradient.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

__all__ = ["FunctionalStep", "make_eval_step", "make_train_step"]

# the double-increment guard of auto_inc_step: the manager it last saw, the
# step it left the counter at, and whether it has warned (reference
# ``train.py:25-32``)
_AUTO_STEP_GUARD: Dict[str, Any] = {"mgr": None, "step": None, "warned": False}


def _auto_inc_step() -> None:
    from .ndtimeline import api as _nd

    mgr = _nd.get_manager()
    g = _AUTO_STEP_GUARD
    if g["mgr"] is not mgr:  # a new manager: start tracking afresh
        g["mgr"], g["step"] = mgr, None
    if not g["warned"] and g["step"] is not None and mgr.step > g["step"]:
        import warnings

        g["warned"] = True
        # a caller-contract misuse notice (fix the call site), not a
        # runtime health signal: it stays a warn-once
        warnings.warn(  # vescale-lint: disable=VSC207
            "make_train_step(auto_inc_step=True) advances the ndtimeline step counter itself, "
            "but it was also advanced elsewhere (inc_step() or flush(next_iteration=True)) "
            "within one training step, so steps are counted twice.  Pass auto_inc_step=False "
            "to keep manual control, or drop the other increment.", stacklevel=3)
    mgr.inc_step()
    g["step"] = mgr.step


def _grad_norm(params) -> float:
    """The global L2 norm of the grads, in fp32 (0.0 without grads)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return 0.0
    return float(torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])))


def _take_owg(owg: Dict[str, torch.Tensor], acc: Dict[str, torch.Tensor]) -> None:
    """Fold each fp8 state buffer's gradient (its next value) into
    ``acc`` and clear it: histories by elementwise max (from zeros, as the
    reference's accumulator starts), scales the latest.  Every fp8 op is
    reached by the forward, so a buffer without a gradient raises: its
    state would otherwise stay as it started for the whole run."""
    for name, b in owg.items():
        new = b.grad
        if new is None:
            raise RuntimeError(f"fp8 state {name!r} got no gradient from the backward: the "
                               "step's fp8 ops must all run, on the buffers the step was "
                               "built over (build the step after moving the model)")
        b.grad = None
        if "amax_history" in name:
            acc[name] = torch.maximum(acc.get(name, torch.zeros_like(new)), new)
        else:
            acc[name] = new


@torch.no_grad()
def _overwrite_owg(owg: Dict[str, torch.Tensor], acc: Dict[str, torch.Tensor]) -> None:
    for name, new in acc.items():
        b = owg[name]
        b.copy_(torch.where(torch.isfinite(new), new, b))


def _split(batch, n: int):
    """``batch`` (a tensor or a dict of tensors, batch dim first) cut into
    ``n`` micro-batches along dim 0."""
    if isinstance(batch, dict):
        parts = {k: _split(v, n) for k, v in batch.items()}
        return [{k: parts[k][i] for k in batch} for i in range(n)]
    if batch.shape[0] % n:
        raise ValueError(f"batch dim {batch.shape[0]} not divisible by grad_accum_steps={n}")
    return list(torch.chunk(batch, n, dim=0))


def _detach(aux):
    if isinstance(aux, dict):
        return {k: _detach(v) for k, v in aux.items()}
    return aux.detach() if isinstance(aux, torch.Tensor) else aux


def _reduce_aux(leaves):
    """Micro-batch metrics: means for floats, sums for integer counts."""
    first = leaves[0]
    if isinstance(first, dict):
        return {k: _reduce_aux([a[k] for a in leaves]) for k in first}
    stacked = torch.stack([torch.as_tensor(a).detach() for a in leaves])
    if stacked.is_floating_point():
        return stacked.mean(dim=0).to(stacked.dtype)
    return stacked.sum(dim=0)


def _forward_fn(model):
    """``forward(x, **kw)``: ``model``'s output for ``x``; over a ``DModule``
    this rank's vocab slice (Shard(-1) on "tp"), as the loss takes it."""
    from .dmodule import DModule

    if not isinstance(model, DModule):
        return model

    def forward(x, **kw):
        from .placements import Shard, plan_axes

        out = model.forward_local(x, **kw)
        return model.output_to(out, plan_axes(model.mesh, tp=Shard(out.ndim - 1)))

    return forward


def make_train_step(model: torch.nn.Module, optimizer, loss_fn: Callable, *,
                    has_aux: bool = False, grad_accum_steps: int = 1,
                    auto_inc_step: bool = True, rng_streams: tuple = ("dropout",)):
    """Build ``step(batch, step_key=None) -> loss`` (``(loss, aux)`` with
    ``has_aux``).

    ``loss_fn(output, batch)`` computes the scalar loss from the model's
    output on ``batch["input"]``.  Each call zeroes the grads, runs forward
    and backward, and steps ``optimizer`` (any object with ``zero_grad``
    and ``step``, e.g. ``AdamWLowmem`` or ``BasicOptimizer``), which updates
    the parameters in place.  The returned loss is a detached tensor on the
    model's device; reading it synchronises.

    ``grad_accum_steps`` > 1 splits the batch into micro-batches whose
    grads are summed in fp32 and averaged before the one update, as is the
    loss; ``loss_fn`` must be mean-reduced for that to equal one full
    batch.  With ``has_aux``, float aux leaves are averaged across
    micro-batches and integer ones summed.

    ``model`` may be a ``DModule``: ``loss_fn`` then gets this rank's
    vocab slice of the logits (Shard(-1) on the mesh's "tp" dim) and must
    compute the whole loss from it, as
    ``vocab_parallel_cross_entropy(..., mesh=, vocab_dim_name="tp")``
    does.  ``batch`` is then this rank's rows on a "dp" dim.  ``model``
    may be a ``DistributedDataParallel`` (around a ``DModule`` or a plain
    module): its ``finish_grad_sync`` averages the gradients over "dp".
    ``optimizer`` may be a ``DistributedOptimizer``: it scales the loss
    and reduces the gradients into its pieces itself.

    ``auto_inc_step`` (default True): while ndtimeline is active, each
    call advances its step counter after the TRAIN_STEP span, so a loop
    over this step must not call ``inc_step()`` too (it warns once if it
    does).  The returned step carries ``.model`` and ``.optimizer``, which
    ``telemetry.costaudit.layer_attribution`` and the step report read.

    ``step_key`` (a ``random`` key, e.g. ``random.key(seed)`` folded with
    the step): the model is called as ``model(x, deterministic=False,
    rngs={name: fold_in(key, i) for i, name in enumerate(rng_streams)})``,
    ``key`` the step key or, for micro-batch ``i`` of a grad
    accumulation, ``fold_in(step_key, 1000 + i)``: the reference's
    streams.  Without it the model is called as ``model(x)``."""
    from .dmodule import DModule
    from .parallel.ddp import DistributedDataParallel
    from .parallel.optimizer import DistributedOptimizer

    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps={grad_accum_steps}")
    ddp = model if isinstance(model, DistributedDataParallel) else None
    if ddp is not None:
        model = ddp.module
    dm = model if isinstance(model, DModule) else None
    dopt = optimizer if isinstance(optimizer, DistributedOptimizer) else None
    if ddp is None and dopt is None and dm is not None and dm.data_parallel_size() > 1:
        ddp = DistributedDataParallel(dm)
    dp_group = None
    if ddp is not None and ddp.dp_size > 1:
        dp_group = ddp.mesh.get_group(ddp.dp_dim)
    elif dopt is not None:
        dp_group = dopt.dp_group()

    from .quant.fp8 import owg_buffers

    owg = owg_buffers(model)

    forward = _forward_fn(model)
    from . import random as _random

    def micro(mb, key):
        x = mb["input"]
        if key is None:
            out = forward(x)
        else:
            rngs = {name: _random.fold_in(key, i) for i, name in enumerate(rng_streams)}
            if dp_group is None:
                out = forward(x, deterministic=False, rngs=rngs)
            else:  # this rank's rows of the global batch
                import torch.distributed as dist

                n, r = dist.get_world_size(dp_group), dist.get_rank(dp_group)
                with _random.batch_rows(r * x.shape[0], n * x.shape[0]):
                    out = forward(x, deterministic=False, rngs=rngs)
        res = loss_fn(out, mb)
        return res if has_aux else (res, None)

    def backward(loss):
        (dopt.scale_loss(loss) if dopt is not None else loss).backward()

    def step(batch: Dict[str, Any], step_key=None):
        from . import telemetry as _tel
        from .ndtimeline import api as _nd
        from .ndtimeline.predefined import TRAIN_STEP

        key = None if step_key is None else _random.as_key(step_key)
        tel_on = _tel.is_active()
        if not tel_on and not _nd.is_active():
            return run(batch, key)
        t0 = time.perf_counter()
        metrics: Optional[Dict[str, Any]] = {} if tel_on else None
        with _nd.ndtimeit(TRAIN_STEP):
            out = run(batch, key, metrics)
        if auto_inc_step and _nd.is_active():
            _auto_inc_step()
        if not tel_on:
            return out
        # reading the loss waits for the step: the recorded time is wall
        # clock, not launch time
        loss_val = float(out[0] if has_aux else out)
        dt = time.perf_counter() - t0
        rec: Dict[str, Any] = {"step_time_s": dt, "loss": loss_val}
        leaf = batch.get("input") if isinstance(batch, dict) else None
        if leaf is not None and hasattr(leaf, "shape"):
            tokens = 1
            for n in leaf.shape:
                tokens *= int(n)
            rec["tokens"] = tokens
            if dt > 0:
                rec["tokens_per_sec"] = tokens / dt
        rec.update(metrics)
        from .telemetry import alerts as _alerts

        if _alerts.is_active():  # arm_pack dedups by name
            _alerts.get_engine().arm_pack("train", _alerts.train_rule_pack())
        _tel.record_step(rec)
        return out

    def run(batch: Dict[str, Any], key, metrics=None):
        optimizer.zero_grad(set_to_none=True)
        owg_next: Dict[str, torch.Tensor] = {}
        for b in owg.values():
            b.grad = None
        if grad_accum_steps == 1:
            loss, aux = micro(batch, key)
            backward(loss)
            _take_owg(owg, owg_next)
            loss, aux = loss.detach(), _detach(aux)
        else:
            params = [p for p in model.parameters() if p.requires_grad]
            g_sum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            l_sum, auxes = None, []
            for i, mb in enumerate(_split(batch, grad_accum_steps)):
                l, aux_i = micro(mb, None if key is None else _random.fold_in(key, 1000 + i))
                backward(l)
                _take_owg(owg, owg_next)
                for acc, p in zip(g_sum, params):
                    if p.grad is not None:
                        acc.add_(p.grad.float())
                        p.grad = None
                l_sum = l.detach() if l_sum is None else l_sum + l.detach()
                auxes.append(aux_i)
            for acc, p in zip(g_sum, params):
                p.grad = (acc / grad_accum_steps).to(p.dtype)
            loss = l_sum / grad_accum_steps
            aux = _reduce_aux(auxes) if has_aux else None
        _overwrite_owg(owg, owg_next)
        if dm is not None:
            dm.finish_grad_sync()
        if ddp is not None:
            ddp.finish_grad_sync()
        if metrics is not None:  # the telemetry feed: read, never written
            gnorm = _grad_norm(model.parameters())
            if dopt is not None:
                gnorm /= dopt.current_scale()
            metrics["grad_norm"] = gnorm
        if dopt is not None:
            dopt.reduce_grads()
        optimizer.step()
        if metrics is not None and dopt is not None and dopt.loss_scale_state is not None:
            # the scale after the step, as the reference's new state has it
            metrics["loss_scale"] = dopt.current_scale()
            metrics["skip_count"] = int(dopt.loss_scale_state["skip_count"])
        if dp_group is not None:
            from . import collectives as C

            loss = C.all_reduce(loss.float().reshape(1), dp_group, "avg")[0].to(loss.dtype)
        return (loss, aux) if has_aux else loss

    step.model = model
    step.optimizer = optimizer
    return step


def make_eval_step(model: torch.nn.Module, loss_fn: Callable):
    """Build ``eval_step(batch) -> loss``: the deterministic forward on
    ``batch["input"]`` and ``loss_fn(output, batch)``, with no gradient
    (reference ``train.py::make_eval_step``, which takes the params as an
    argument; here they are the module's).  A ``DModule`` hands ``loss_fn``
    this rank's vocab slice, as :func:`make_train_step` does; a
    ``DistributedDataParallel`` is evaluated through its module."""
    from .parallel.ddp import DistributedDataParallel

    if isinstance(model, DistributedDataParallel):
        model = model.module
    forward = _forward_fn(model)

    @torch.no_grad()
    def eval_step(batch: Dict[str, Any]):
        return loss_fn(forward(batch["input"]), batch)

    eval_step.model = model
    return eval_step


def _state_tree(optimizer, module):
    from .parallel.optimizer import AdamWLowmem, BasicOptimizer

    if isinstance(optimizer, BasicOptimizer):
        optimizer = optimizer.optimizer
    if isinstance(optimizer, AdamWLowmem):
        return optimizer.state_tree(module)
    return optimizer.state_tree()


def _load_state_tree(optimizer, state, module) -> None:
    from .parallel.optimizer import AdamWLowmem, BasicOptimizer

    if isinstance(optimizer, BasicOptimizer):
        optimizer = optimizer.optimizer
    if isinstance(optimizer, AdamWLowmem):
        optimizer.load_state_tree(state, module)
    else:
        optimizer.load_state_tree(state)


class FunctionalStep:
    """The in-place train step in the reference's functional signature::

        fstep = FunctionalStep(make_train_step(model, opt, loss_fn), model, opt)
        res = run_resilient(step_fn=fstep, params=fstep.params,
                            opt_state=fstep.opt_state, ...)

    ``params`` is ``models.module_tree(model)`` (the parameters, detached,
    not copies) and ``opt_state`` the optimizer's ``state_tree`` (the
    reference ``adamw_lowmem`` layout for ``AdamWLowmem``, the ZeRO layout
    for a ``DistributedOptimizer``); both are rebuilt after every step, so
    they always describe the live state.  When the caller hands in trees
    that are not the live ones (``run_resilient`` after a restore), they
    are copied into the module's parameters and the optimizer's state
    first, in place: the parameters keep their storage (``data_ptr``), and
    the optimizer's step count comes back with the moments, so the bias
    corrections of a replayed step are the original's; the handed-in
    trees then alias the live state (:meth:`load`).  The train step
    uses no CUDA graph, so no captured pointer can go stale.  ``step_key``
    goes to the step (the GPT's dropout streams).

    While memtrack is live the parameters are tagged ``params`` and the
    optimizer's state ``optimizer_state`` after each step."""

    def __init__(self, step: Callable, model: torch.nn.Module, optimizer, *,
                 has_aux: bool = False):
        self.step = step
        self.module = getattr(model, "module", model)  # a DDP wrapper: its module
        self.optimizer = optimizer
        self.has_aux = has_aux
        self._refresh()

    def _refresh(self) -> None:
        from .models import module_tree
        from .telemetry import memtrack as _memtrack

        self.params = module_tree(self.module)
        self.opt_state = _state_tree(self.optimizer, self.module)
        _memtrack.tag_tree(list(self.module.parameters()), "params")
        _memtrack.tag_tree(self.opt_state, "optimizer_state")

    @torch.no_grad()
    def load(self, params, opt_state) -> None:
        """Copy ``params`` and ``opt_state`` (trees of the live layout) into
        the module and the optimizer.  Each tensor leaf of the given trees
        is then pointed at the live tensor it was copied into: the caller
        (``run_resilient`` after a restore) holds its trees until the step
        returns, and their own storage, a second copy of the whole state,
        is freed here instead of living through that step."""
        from .checkpoint.planner import flatten_state
        from .models import load_params

        load_params(self.module, params)
        _load_state_tree(self.optimizer, opt_state, self.module)
        self._refresh()
        for given, live in ((params, self.params), (opt_state, self.opt_state)):
            live_leaves = dict(flatten_state(live))
            for key, t in flatten_state(given):
                dst = live_leaves.get(key)
                if (isinstance(t, torch.Tensor) and isinstance(dst, torch.Tensor)
                        and t is not dst and (t.dtype, t.shape, t.device)
                        == (dst.dtype, dst.shape, dst.device)):
                    t.set_(dst.detach())

    def __call__(self, params, opt_state, batch, step_key=None):
        if params is not self.params or opt_state is not self.opt_state:
            self.load(params, opt_state)
        out = self.step(batch, step_key)
        self._refresh()
        if self.has_aux:
            loss, aux = out
            return self.params, self.opt_state, loss, aux
        return self.params, self.opt_state, out
