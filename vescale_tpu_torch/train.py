"""The train step: forward, loss, backward and one optimizer update.

The port of the single-device core of ``vescale_tpu/train.py::
make_train_step``.  PyTorch runs eagerly, so the step is a plain function
over a module and an optimizer that updates the parameters in place,
where the reference returns new params and optimizer state from one
compiled program.

Not here yet (ROADMAP.md): the fp8 ``_overwrite_with_gradient`` bundle,
``DistributedOptimizer`` loss scaling, the telemetry feed and the
ndtimeline spans, and dropout RNG streams (the Llama has no dropout).
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
    micro-batches and integer ones summed."""
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps={grad_accum_steps}")

    def micro(mb):
        res = loss_fn(model(mb["input"]), mb)
        return res if has_aux else (res, None)

    def step(batch: Dict[str, Any]):
        optimizer.zero_grad(set_to_none=True)
        if grad_accum_steps == 1:
            loss, aux = micro(batch)
            loss.backward()
            loss, aux = loss.detach(), _detach(aux)
        else:
            params = [p for p in model.parameters() if p.requires_grad]
            g_sum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            l_sum, auxes = None, []
            for mb in _split(batch, grad_accum_steps):
                l, aux_i = micro(mb)
                l.backward()
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
        optimizer.step()
        return (loss, aux) if has_aux else loss

    return step
