"""Emulator verification — compare emulated collectives against the real
all-reduce.

The port of ``vescale_tpu/emulator/verify.py`` (the reference's test
strategy, legacy/test/emulator/test_distributed.py: run the real
collective, replay on the emulator, compare bitwise).  The reference
compares with XLA's psum over its mesh; here every rank runs
``collectives.mesh_all_reduce`` over the mesh's process group (gloo or
NCCL) on its own operand, and the answer quantifies the divergence
between the ring/tree replay and the backend's own reduction order.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..collectives import mesh_all_reduce
from ..mesh import DeviceMesh
from .core import Emulator

__all__ = ["verify_all_reduce_against_backend"]


def verify_all_reduce_against_backend(
    mesh: DeviceMesh, locals_: List[np.ndarray], op: str = "sum", algo: str = "ring", mesh_dim=0
) -> Tuple[bool, float]:
    """(bitwise_equal, max_abs_diff) between the emulated all-reduce of
    ``locals_`` (every rank's operand, in rank order along ``mesh_dim``)
    and this rank's ``mesh_all_reduce`` of its own operand over the live
    mesh.  Every rank of the dim calls it with the same ``locals_``."""
    em = Emulator(mesh.size(mesh_dim))
    emulated = em.ring_all_reduce(locals_, op) if algo == "ring" else em.tree_all_reduce(locals_, op)
    me = mesh.get_coordinate()[mesh._dim_index(mesh_dim)]
    mine = torch.from_numpy(np.ascontiguousarray(locals_[me])).to(mesh.device)
    real = mesh_all_reduce(mine, mesh, op, mesh_dim).cpu().numpy()
    diff = float(np.max(np.abs(real.astype(np.float64)
                               - emulated[me].reshape(real.shape).astype(np.float64))))
    return diff == 0.0, diff
