"""Row- and column-parallel linear modules (reference
``vescale_tpu/model/patch/linear.py``, after legacy veScale's
``model/patch/linear.py:32,56``).

The reference's modules declare kernel layouts and GSPMD places the
collectives.  Here each module holds this rank's piece and issues them
itself (``dmodule._comm``):

  ``ColumnParallelLinear``  kernel (in, out/tp), bias (out/tp,) (Shard(0));
                            the input enters tensor-parallel compute
                            (``enter_tp``), the output is Shard(-1)
  ``RowParallelLinear``     kernel (in/tp, out); the input is this rank's
                            features (a full-width input is cut to them),
                            the products are Partial and summed over the
                            dim, then the bias is added once (the
                            reference's ``linear.py:56``); output Replicate

Without ``mesh`` (or on a dim of size one) both are flax ``nn.Dense``.
Parameters are fp32; the product runs in ``dtype``.  ``init_params``
gives full weights; :meth:`load_full` takes this rank's piece of them.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ...dmodule._comm import TPDim
from ...models.llama import _tp_dense

__all__ = ["ColumnParallelLinear", "RowParallelLinear"]


class _ParallelLinear(nn.Module):
    _kind = ""

    def __init__(self, in_features: int, features: int, mesh=None, tp_dim_name: str = "tp",
                 use_bias: bool = True, dtype: Any = torch.float32, device=None):
        super().__init__()
        self.tp = TPDim(mesh, tp_dim_name) if mesh is not None else None
        n = self.tp.size if self.tp is not None else 1
        col = self._kind == "col"
        if (features if col else in_features) % n:
            raise ValueError(f"{type(self).__name__}: {features if col else in_features} "
                             f"features do not split over {n} ranks")
        self.full_shape = (in_features, features)
        shape = (in_features, features // n) if col else (in_features // n, features)
        dev = mesh.device if mesh is not None and device is None else device
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(shape, dtype=torch.float32, device=dev))
        bias_n = features // n if col else features
        self.bias = (nn.Parameter(torch.zeros((bias_n,), dtype=torch.float32, device=dev))
                     if use_bias else None)

    @torch.no_grad()
    def load_full(self, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None) -> None:
        """Copy this rank's piece of the full ``kernel`` (in, out) and
        ``bias`` (out,) into the parameters."""
        r, n = (self.tp.rank, self.tp.size) if self.tp is not None else (0, 1)
        col = self._kind == "col"
        d = 1 if col else 0
        w = kernel.shape[d] // n
        self.kernel.copy_(kernel.narrow(d, r * w, w))
        if self.bias is not None:
            self.bias.copy_(bias.narrow(0, r * w, w) if col else bias)

    def forward(self, x):
        if self.tp is None or self.tp.size == 1:
            y = x.to(self.dtype) @ self.kernel.to(self.dtype)
            return y if self.bias is None else y + self.bias.to(self.dtype)
        return _tp_dense(x, self.kernel, self.bias, self.dtype, self._kind, self.tp)


class ColumnParallelLinear(_ParallelLinear):
    _kind = "col"


class RowParallelLinear(_ParallelLinear):
    _kind = "row"
