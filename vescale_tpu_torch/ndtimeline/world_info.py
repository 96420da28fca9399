"""WorldInfo (reference legacy/vescale/ndtimeline/world_info.py): identity of
a rank inside the nD topology, attached to every flushed span batch."""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["WorldInfo"]


@dataclasses.dataclass
class WorldInfo:
    rank: int = 0
    world_size: int = 1
    dp_rank: int = 0
    tp_rank: int = 0
    pp_rank: int = 0
    dp_size: int = 1
    tp_size: int = 1
    pp_size: int = 1
    step: int = 0

    @classmethod
    def from_mesh(cls, mesh, rank: int = 0) -> "WorldInfo":
        coord = mesh.coordinate_of_rank(rank)
        names = [n.lower() for n in mesh.mesh_dim_names]

        def get(n):
            return coord[names.index(n)] if n in names else 0

        def size(n):
            return mesh.shape[names.index(n)] if n in names else 1

        return cls(
            rank=rank,
            world_size=mesh.size(),
            dp_rank=get("dp"),
            tp_rank=get("tp"),
            pp_rank=get("pp"),
            dp_size=size("dp"),
            tp_size=size("tp"),
            pp_size=size("pp"),
        )
