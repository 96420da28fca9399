"""Emulated mesh collectives over DArray-style per-rank locals (reference
legacy/vescale/emulator/mesh_collectives.py / comm_api.py).

The port of ``vescale_tpu/emulator/mesh_collectives.py`` over the port's
``DeviceMesh``: only its layout is read (a layout-only mesh is enough),
and ``locals_[r]`` is flat rank r's numpy array."""

from __future__ import annotations

from typing import List

import numpy as np

from ..mesh import DeviceMesh
from .core import Emulator

__all__ = ["emulate_mesh_all_reduce", "emulate_mesh_all_gather", "emulate_mesh_reduce_scatter"]


def _groups(mesh: DeviceMesh, mesh_dim: int):
    """Flat-rank groups along one mesh dim (every other coord fixed)."""
    import itertools

    shape = mesh.shape
    others = [range(s) for i, s in enumerate(shape) if i != mesh_dim]
    out = []
    for combo in itertools.product(*others):
        group = []
        for r in range(shape[mesh_dim]):
            coord = list(combo)
            coord.insert(mesh_dim, r)
            group.append(int(np.ravel_multi_index(coord, shape)))
        out.append(group)
    return out


def emulate_mesh_all_reduce(locals_: List[np.ndarray], mesh: DeviceMesh, mesh_dim=0, op="sum", algo="ring"):
    dim = mesh._dim_index(mesh_dim)
    em = Emulator(mesh.shape[dim])
    out = [None] * mesh.size()
    for group in _groups(mesh, dim):
        vals = [locals_[r] for r in group]
        red = em.ring_all_reduce(vals, op) if algo == "ring" else em.tree_all_reduce(vals, op)
        for r, v in zip(group, red):
            out[r] = v
    return out


def emulate_mesh_all_gather(locals_: List[np.ndarray], mesh: DeviceMesh, mesh_dim=0):
    dim = mesh._dim_index(mesh_dim)
    em = Emulator(mesh.shape[dim])
    out = [None] * mesh.size()
    for group in _groups(mesh, dim):
        gathered = em.all_gather([locals_[r] for r in group])
        for r, v in zip(group, gathered):
            out[r] = v
    return out


def emulate_mesh_reduce_scatter(locals_: List[np.ndarray], mesh: DeviceMesh, mesh_dim=0, op="sum"):
    dim = mesh._dim_index(mesh_dim)
    em = Emulator(mesh.shape[dim])
    out = [None] * mesh.size()
    for group in _groups(mesh, dim):
        red = em.reduce_scatter([locals_[r] for r in group], op)
        for r, v in zip(group, red):
            out[r] = v
    return out
