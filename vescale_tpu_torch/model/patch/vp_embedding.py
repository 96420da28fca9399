"""VocabParallelEmbedding (reference ``vescale_tpu/model/patch/
vp_embedding.py``, after legacy veScale's ``vp_embedding.py:38``): the
table sharded on the VOCAB dim; each rank looks up its rows (ids outside
them read zeros) and the partial results are summed over the dim, the
masked local lookup plus all-reduce GSPMD derives in the reference.

Without ``mesh`` it is flax ``nn.Embed``.  The table is fp32, cast to
``dtype`` before the gather; :meth:`load_full` takes this rank's rows of a
full table.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ...dmodule._comm import TPDim
from ...models.llama import _vocab_lookup

__all__ = ["VocabParallelEmbedding"]


class VocabParallelEmbedding(nn.Module):
    def __init__(self, num_embeddings: int, features: int, mesh=None,
                 vocab_dim_name: str = "tp", dtype: Any = torch.float32, device=None):
        super().__init__()
        self.tp = TPDim(mesh, vocab_dim_name) if mesh is not None else None
        n = self.tp.size if self.tp is not None else 1
        if num_embeddings % n:
            raise ValueError(f"vocab {num_embeddings} does not split over {n} ranks")
        dev = mesh.device if mesh is not None and device is None else device
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty((num_embeddings // n, features),
                                                  dtype=torch.float32, device=dev))

    @torch.no_grad()
    def load_full(self, table: torch.Tensor) -> None:
        r = self.tp.rank if self.tp is not None else 0
        w = self.embedding.shape[0]
        self.embedding.copy_(table.narrow(0, r * w, w))

    def forward(self, idx):
        if self.tp is None or self.tp.size == 1:
            return F.embedding(idx, self.embedding.to(self.dtype))
        return _vocab_lookup(idx, self.embedding, self.dtype, self.tp)
