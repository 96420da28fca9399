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

While telemetry is on (``telemetry.init`` before the step runs), each
step reads its loss on the host (the sync that makes the step time wall
clock, the observability trade a telemetry run opts into) and records
``step_time_s``, ``loss``, ``tokens`` and ``tokens_per_sec`` through
``telemetry.record_step`` (reference ``train.py:310-343``).

:class:`FunctionalStep` wraps the in-place step in the reference's
functional signature, ``step_fn(params, opt_state, batch[, step_key]) ->
(params, opt_state, loss)``, for ``resilience.run_resilient``.

Not here yet (ROADMAP.md): the fp8 ``_overwrite_with_gradient`` bundle,
the grad-norm and loss-scale scalars of the telemetry feed, the ndtimeline
spans, and dropout RNG streams (the Llama has no dropout).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict

import torch

__all__ = ["FunctionalStep", "make_train_step"]


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


def make_train_step(model: torch.nn.Module, optimizer, loss_fn: Callable, *,
                    has_aux: bool = False, grad_accum_steps: int = 1):
    """Build ``step(batch) -> loss`` (``(loss, aux)`` with ``has_aux``).

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
    and reduces the gradients into its pieces itself."""
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
    elif dopt is not None and dopt.mesh is not None and dopt.mesh.size(dopt.dp_dims[0]) > 1:
        dp_group = dopt.mesh.get_group(dopt.dp_dims[0])

    def forward(x):
        if dm is None:
            return model(x)
        from .placements import Shard, plan_axes

        out = dm.forward_local(x)
        return dm.output_to(out, plan_axes(dm.mesh, tp=Shard(out.ndim - 1)))

    def micro(mb):
        res = loss_fn(forward(mb["input"]), mb)
        return res if has_aux else (res, None)

    def backward(loss):
        (dopt.scale_loss(loss) if dopt is not None else loss).backward()

    def step(batch: Dict[str, Any]):
        from . import telemetry as _tel

        if not _tel.is_active():
            return run(batch)
        t0 = time.perf_counter()
        out = run(batch)
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
        _tel.record_step(rec)
        return out

    def run(batch: Dict[str, Any]):
        optimizer.zero_grad(set_to_none=True)
        if grad_accum_steps == 1:
            loss, aux = micro(batch)
            backward(loss)
            loss, aux = loss.detach(), _detach(aux)
        else:
            params = [p for p in model.parameters() if p.requires_grad]
            g_sum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            l_sum, auxes = None, []
            for mb in _split(batch, grad_accum_steps):
                l, aux_i = micro(mb)
                backward(l)
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
        if dm is not None:
            dm.finish_grad_sync()
        if ddp is not None:
            ddp.finish_grad_sync()
        if dopt is not None:
            dopt.reduce_grads()
        optimizer.step()
        if dp_group is not None:
            from . import collectives as C

            loss = C.all_reduce(loss.float().reshape(1), dp_group, "avg")[0].to(loss.dtype)
        return (loss, aux) if has_aux else loss

    return step


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
    is accepted and unused: the port's models draw no dropout.

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
        out = self.step(batch)
        self._refresh()
        if self.has_aux:
            loss, aux = out
            return self.params, self.opt_state, loss, aux
        return self.params, self.opt_state, out
