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

Not here yet (ROADMAP.md): the fp8 ``_overwrite_with_gradient`` bundle,
the telemetry feed and the ndtimeline spans, and dropout RNG streams (the
Llama has no dropout).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

__all__ = ["make_train_step"]


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
