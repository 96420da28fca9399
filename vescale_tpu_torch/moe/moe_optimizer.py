"""MoEOptimizer — an optimizer over ragged expert pieces that moves its state.

The port of ``vescale_tpu/moe/moe_optimizer.py``.  The reference wraps an
optax transformation; here ``optimizer`` is a factory from a list of
tensors to a ``torch.optim.Optimizer`` (as ``DistributedOptimizer`` takes
one, e.g. ``functools.partial(AdamWLowmem, lr=3e-4)``).  ``init`` binds
the inner optimizer to this rank's pieces of a ``MoEParamBuffer``'s
``DArray``s (the parameters share the pieces' storage), ``step`` runs it on
this rank's gradient pieces (``AdamWLowmem``: one fused AdamW launch over
every local piece on the card), updating the pieces in place, and
``refresh`` moves the parameters and every tensor of the inner optimizer's
state shaped as its parameter (the moments) to a new expert -> rank
assignment through the same ragged -> ragged redistribute, binds the moved
state to the new pieces and keeps the step count.  The state tree
(``state_tree``) holds each moment as a ``DArray`` laid out as its
parameter, keyed ``{state key: {leaf path: DArray}}``, and ``"step"``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch import nn

from ..darray import DArray
from ..parallel.optimizer import _flat_specs as _flatten
from ..parallel.optimizer import _set_path
from ..spec import DArraySpec, TensorMeta
from .moe_param_buffer import MoEParamBuffer

__all__ = ["MoEOptimizer"]


def _with_dtype(d: DArray, local: torch.Tensor) -> DArray:
    """``local`` as a piece laid out as ``d``, in its own dtype."""
    spec = DArraySpec(d.mesh, d.placements, TensorMeta(d.shape, local.dtype))
    return DArray(local, spec, d.rank)


class MoEOptimizer:
    def __init__(self, optimizer: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
                 buffer: MoEParamBuffer):
        self.make = optimizer
        self.buffer = buffer
        self.inner = None
        self._params: Dict[str, nn.Parameter] = {}  # leaf path -> this rank's piece
        self._darrays: Dict[str, DArray] = {}

    def init(self, sharded_params) -> Dict[str, Any]:
        """Bind a fresh inner optimizer to ``sharded_params`` (the
        buffer's ``DArray`` tree); returns :meth:`state_tree`."""
        self._bind(_flatten(sharded_params))
        self.inner = self.make(list(self._params.values()))
        return self.state_tree()

    def _bind(self, flat: Dict[str, DArray]) -> None:
        self._darrays = dict(flat)
        self._params = {k: nn.Parameter(d.to_local(), requires_grad=True) for k, d in flat.items()}

    def state_tree(self) -> Dict[str, Any]:
        """The inner optimizer's parameter-shaped state as ``DArray``s laid
        out as their parameters, and the first group's step count."""
        out: Dict[str, Any] = {}
        for path, p in self._params.items():
            for key, v in self.inner.state.get(p, {}).items():
                if isinstance(v, torch.Tensor) and v.shape == p.shape:
                    _set_path(out.setdefault(key, {}), path, _with_dtype(self._darrays[path], v))
        out["step"] = self.inner.param_groups[0].get("step")
        return out

    def step(self, sharded_params, opt_state, sharded_grads) -> Tuple[Any, Dict[str, Any]]:
        """One inner step on this rank's gradient pieces (a ``DArray`` tree
        laid out as the parameters); the pieces are updated in place.
        Returns ``(sharded_params, state_tree())``."""
        flat_p, flat_g = _flatten(sharded_params), _flatten(sharded_grads)
        for path, p in self._params.items():
            if flat_p[path].to_local().data_ptr() != p.data_ptr():
                raise ValueError(f"{path}: not the piece this optimizer was bound to (init or "
                                 "refresh gives the live tree)")
            p.grad = flat_g[path].to_local().to(p.dtype)
        self.inner.step()
        for p in self._params.values():
            p.grad = None
        return sharded_params, self.state_tree()

    def refresh(self, sharded_params, opt_state,
                new_units: Sequence[int]) -> Tuple[MoEParamBuffer, Any, Dict[str, Any]]:
        """Reallocate the experts: the parameters and the inner optimizer's
        parameter-shaped state move to ``new_units`` (ragged -> ragged
        redistribute), the state is bound to the new pieces and the step
        count stays.  Returns ``(new buffer, new params, state_tree())``."""
        new_buffer, new_params = self.buffer.refresh(sharded_params, new_units)
        old_params, old_darrays = self._params, self._darrays
        self._bind(_flatten(new_params))
        by_id = {id(p): path for path, p in old_params.items()}
        for group in self.inner.param_groups:
            for i, p in enumerate(group["params"]):
                path = by_id[id(p)]
                q = self._params[path]
                st = self.inner.state.pop(p, None)
                if st:
                    self.inner.state[q] = {
                        k: (new_buffer.move(_with_dtype(old_darrays[path], v)).to_local()
                            if isinstance(v, torch.Tensor) and v.shape == p.shape else v)
                        for k, v in st.items()}
                group["params"][i] = q
        self.buffer = new_buffer
        return new_buffer, new_params, self.state_tree()
