"""Model patches of the port: the vocab-parallel embedding and loss, the
row- and column-parallel linears, and ``patch_method``."""

from .linear import ColumnParallelLinear, RowParallelLinear
from .monkey_patch import patch_method
from .vp_cross_entropy import VocabParallelCrossEntropy
from .vp_embedding import VocabParallelEmbedding

__all__ = ["ColumnParallelLinear", "RowParallelLinear", "VocabParallelCrossEntropy",
           "VocabParallelEmbedding", "patch_method"]
