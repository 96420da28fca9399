"""VeDeviceMesh: the process-global mesh and its strategy-dim lookups.

The port of ``vescale_tpu/devicemesh_api.py`` (reference
legacy/vescale/devicemesh_api/api.py:28,48,188,221,290-361,380-388,475): one
mesh with named strategy dims (PP/DP/TP/...) and the rank and submesh
lookups the trainers use.  The mesh is live (``init_device_mesh``), so the
lookups answer for this process.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .mesh import DeviceMesh, init_device_mesh as _init

__all__ = ["VeDeviceMesh", "VESCALE_DEVICE_MESH"]  # vescale-lint: disable=VSC202 (API singleton name, not an env var)


class VeDeviceMesh:
    PP, DP, TP = "PP", "DP", "TP"

    def __init__(self) -> None:
        self._mesh: Optional[DeviceMesh] = None

    # ------------------------------------------------------------- init
    def init_device_mesh(
        self,
        device_type: str = "cuda",
        mesh_shape: Sequence[int] = (),
        mesh_dim_names: Optional[Sequence[str]] = None,
        check_uniqueness: bool = False,
    ) -> DeviceMesh:
        """(reference api.py:48) Create and register the global mesh."""
        if check_uniqueness and self._mesh is not None:
            raise RuntimeError("device mesh already initialized")
        self._mesh = _init(device_type, mesh_shape, mesh_dim_names=mesh_dim_names)
        return self._mesh

    def reset(self) -> None:
        """Forget the registered mesh (its process groups stay)."""
        self._mesh = None

    def get(self) -> DeviceMesh:
        if self._mesh is None:
            raise RuntimeError("call init_device_mesh first")
        return self._mesh

    @property
    def ndim(self) -> int:
        return self.get().ndim

    def size(self, dim: Optional[Union[int, str]] = None) -> int:
        return self.get().size(dim)

    # ------------------------------------------------------ coordinates
    def get_strategy_coordinate(self, local_rank: Optional[int] = None) -> Tuple[int, ...]:
        """(api.py:188) n-D coordinate of a flat rank (default: this one)."""
        mesh = self.get()
        r = local_rank if local_rank is not None else mesh.get_rank()
        return mesh.coordinate_of_rank(r)

    def lookup_rank(self, dim: Union[int, str]) -> int:
        """(api.py:221) This process's index along one strategy dim."""
        mesh = self.get()
        return self.get_strategy_coordinate()[mesh._dim_index(dim)]

    def get_local_rank(self) -> int:
        return self.get().get_rank()

    # ------------------------------------------------- PP/DP/TP helpers
    def _dim_or_none(self, name: str):
        lowered = [d.lower() for d in self.get().mesh_dim_names]
        return lowered.index(name.lower()) if name.lower() in lowered else None

    def _rank_on(self, name: str) -> int:
        d = self._dim_or_none(name)
        return 0 if d is None else self.get_strategy_coordinate()[d]

    def get_pipeline_parallel_rank(self) -> int:
        return self._rank_on("pp")

    def get_data_parallel_rank(self) -> int:
        return self._rank_on("dp")

    def get_tensor_parallel_rank(self) -> int:
        return self._rank_on("tp")

    def _submesh(self, name: str, default: str) -> DeviceMesh:
        mesh = self.get()
        d = self._dim_or_none(name)
        return mesh[mesh.mesh_dim_names[d] if d is not None else default]

    def get_pipeline_parallel_mesh(self) -> DeviceMesh:
        return self._submesh("pp", self.get().mesh_dim_names[0])

    def get_data_parallel_mesh(self) -> DeviceMesh:
        return self._submesh("dp", self.get().mesh_dim_names[0])

    def get_tensor_parallel_mesh(self) -> DeviceMesh:
        return self._submesh("tp", self.get().mesh_dim_names[-1])

    def get_global_tensor_parallel_meshes(self) -> List[DeviceMesh]:
        """Every TP submesh, this process's among them (api.py:290-361):
        layout-only meshes over each TP group's ranks."""
        mesh = self.get()
        tp = self._dim_or_none("tp")
        if tp is None:
            return [mesh.layout_only()]
        name = mesh.mesh_dim_names[tp]
        grid = np.moveaxis(mesh.ranks, tp, -1).reshape(-1, mesh.shape[tp])
        return [DeviceMesh((name,), (mesh.shape[tp],), device_type=mesh.device_type, ranks=row)
                for row in grid]

    def is_first_stage(self) -> bool:
        """(api.py:380)"""
        return self.get_pipeline_parallel_rank() == 0

    def is_last_stage(self) -> bool:
        """(api.py:388)"""
        d = self._dim_or_none("pp")
        n = 1 if d is None else self.get().shape[d]
        return self.get_pipeline_parallel_rank() == n - 1


VESCALE_DEVICE_MESH = VeDeviceMesh()
