"""Placement types: the sharding vocabulary of the SPMD core.

The port of ``vescale_tpu/placements.py``.  A *placement* says how a global
(logical) tensor relates to one mesh dimension; a layout is a tuple of
placements, one per mesh dim.  ``Shard``, ``InterleavedShard``,
``Replicate`` and ``Partial`` follow the legacy veScale DTensor;
``RaggedShard`` and ``StridedRaggedShard`` are veScale's asymmetric shards
of a flattened group of dims.

Placements are declarative, as in the reference: they hold index math only
(chunk sizes, offsets).  ``spec.py`` turns a layout into each rank's local
piece, and ``redistribute.py`` turns a change of placements into
``torch.distributed`` collectives over the mesh dims' process groups.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

__all__ = [
    "Placement",
    "Shard",
    "Replicate",
    "Partial",
    "InterleavedShard",
    "RaggedShard",
    "StridedRaggedShard",
    "normalize_placement",
    "normalize_placements",
    "plan_axes",
    "transition_candidates",
]


class Placement:
    """Base class for placements (pure metadata, hashable, immutable)."""

    def is_shard(self, dim: Optional[int] = None) -> bool:
        is_shard = isinstance(self, Shard)
        if dim is not None and is_shard:
            return self.dim == dim  # type: ignore[attr-defined]
        return is_shard

    def is_interleaved_shard(self, dim: Optional[int] = None) -> bool:
        is_ils = isinstance(self, InterleavedShard)
        if dim is not None and is_ils:
            return self.dim == dim  # type: ignore[attr-defined]
        return is_ils

    def is_ragged_shard(self) -> bool:
        return isinstance(self, RaggedShard)

    def is_replicate(self) -> bool:
        return isinstance(self, Replicate)

    def is_partial(self) -> bool:
        return isinstance(self, Partial)


@dataclasses.dataclass(frozen=True)
class Shard(Placement):
    """Shard the tensor dim ``dim`` contiguously across a mesh dim.

    Uneven sizes follow the reference semantics: chunk sizes are
    ``ceil(size / n)`` with trailing ranks possibly holding smaller or empty
    shards; collectives pad each chunk to that size and unpad.
    """

    dim: int

    def local_shard_size_and_offset(self, global_size: int, num_chunks: int, rank: int) -> Tuple[int, int]:
        """(local_size, global_offset) of ``rank``'s chunk of a dim of
        ``global_size`` split into ``num_chunks`` (ceil-division chunking,
        mirrors reference Shard._local_shard_size_on_dim)."""
        chunk = -(-global_size // num_chunks)  # ceil
        off = min(chunk * rank, global_size)
        return min(chunk, global_size - off), off

    def padded_size(self, global_size: int, num_chunks: int) -> int:
        return -(-global_size // num_chunks) * num_chunks

    def __repr__(self) -> str:
        return f"Shard(dim={self.dim})"

    def __str__(self) -> str:
        return f"S({self.dim})"


@dataclasses.dataclass(frozen=True)
class InterleavedShard(Placement):
    """Non-contiguous interleaved shard (reference placement_types.py:284).

    The tensor dim is logically split into ``interleaved_size`` contiguous
    sections; *each* section is sharded across the mesh dim.  Rank ``r`` holds
    the concatenation of the r-th chunk of every section.  Canonical use:
    merged QKV / gate-up projections where each logical sub-matrix must be
    TP-sharded independently.

    Layout: a view of ``dim`` as ``(interleaved_size, size/interleaved_size)``
    whose second factor is sharded (see spec.py).
    """

    dim: int
    interleaved_size: int

    def __post_init__(self):
        if self.interleaved_size <= 0:
            raise ValueError("interleaved_size must be positive")

    def __repr__(self) -> str:
        return f"InterleavedShard(dim={self.dim}, interleaved_size={self.interleaved_size})"

    def __str__(self) -> str:
        return f"IS({self.dim},{self.interleaved_size})"


@dataclasses.dataclass(frozen=True)
class Replicate(Placement):
    """Replicate across the mesh dim."""

    def __repr__(self) -> str:
        return "Replicate()"

    def __str__(self) -> str:
        return "R"


@dataclasses.dataclass(frozen=True)
class Partial(Placement):
    """Pending reduction across the mesh dim (reference placement_types.py:249).

    Each participant holds a same-shaped local tensor; the logical global
    value is the elementwise reduction.  ``reduce_op`` in {"sum", "avg",
    "max", "min"}.

    Each rank's local tensor is its own contribution; ``redistribute``
    reduces them with an all-reduce or a reduce-scatter.
    """

    reduce_op: str = "sum"

    _VALID = ("sum", "avg", "max", "min")

    def __post_init__(self):
        if self.reduce_op not in self._VALID:
            raise ValueError(f"unsupported reduce_op {self.reduce_op!r}; expected one of {self._VALID}")

    def __repr__(self) -> str:
        return f"Partial({self.reduce_op})"

    def __str__(self) -> str:
        return f"P({self.reduce_op})"


@dataclasses.dataclass(frozen=True)
class RaggedShard(Placement):
    """Asymmetric contiguous shard of a *flattened* group of dims
    (reference vescale/dtensor/placement_types.py:46, raggedshard.md).

    ``dims`` — the leading-contiguous tensor dims that are flattened before
    splitting.  ``local_units`` — one weight per mesh-dim rank; rank ``r``
    owns ``local_units[r] / sum(local_units)`` of the flattened extent.  Unit
    boundaries must divide the flattened size exactly.

    A rank's local tensor is its flat chunk.  Collectives pad each chunk to
    the largest one (all-gather-v) or exchange exactly the overlapping
    ranges (all-to-all-v).
    """

    dims: Tuple[int, ...]
    local_units: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "dims", tuple(self.dims))
        object.__setattr__(self, "local_units", tuple(int(u) for u in self.local_units))
        if len(self.dims) == 0:
            raise ValueError("RaggedShard needs at least one dim")
        if tuple(self.dims) != tuple(range(self.dims[0], self.dims[0] + len(self.dims))):
            raise ValueError(f"RaggedShard dims must be contiguous, got {self.dims}")
        if any(u < 0 for u in self.local_units) or sum(self.local_units) == 0:
            raise ValueError(f"invalid local_units {self.local_units}")

    @property
    def total_units(self) -> int:
        return sum(self.local_units)

    def unit_size(self, flat_size: int) -> int:
        if flat_size % self.total_units != 0:
            raise ValueError(f"flattened size {flat_size} not divisible by total units {self.total_units}")
        return flat_size // self.total_units

    def local_sizes_and_offsets(self, flat_size: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Per-rank (sizes, offsets) in elements of the flattened extent."""
        us = self.unit_size(flat_size)
        sizes = tuple(u * us for u in self.local_units)
        offs = tuple(int(x) for x in _exclusive_cumsum(sizes))
        return sizes, offs

    def __repr__(self) -> str:
        return f"RaggedShard(dims={self.dims}, local_units={self.local_units})"

    def __str__(self) -> str:
        return f"RS({list(self.dims)},{list(self.local_units)})"


@dataclasses.dataclass(frozen=True)
class StridedRaggedShard(RaggedShard):
    """RaggedShard composed *inside* an outer ``Shard`` of the same flat
    extent (reference vescale/dtensor/placement_types.py:229).

    ``split_factor`` = product of the outer mesh-dim sizes that shard the same
    flattened extent before this placement applies.  Rank ``r`` of this mesh
    dim owns its ragged chunk *within each* of the ``split_factor`` outer
    chunks, enabling 2-D (e.g. fsdp x ep) ragged layouts.
    """

    split_factor: int = 1

    def __post_init__(self):
        super().__post_init__()
        if self.split_factor < 1:
            raise ValueError("split_factor must be >= 1")

    def __repr__(self) -> str:
        return (
            f"StridedRaggedShard(dims={self.dims}, local_units={self.local_units}, "
            f"split_factor={self.split_factor})"
        )

    def __str__(self) -> str:
        return f"SRS({list(self.dims)},{list(self.local_units)},sf={self.split_factor})"


def _exclusive_cumsum(xs: Sequence[int]):
    out, acc = [], 0
    for x in xs:
        out.append(acc)
        acc += x
    return out


def normalize_placement(p, ndim: Optional[int] = None) -> Placement:
    """Accept shorthand: int -> Shard(int), "replicate"/"r" -> Replicate(),
    "partial" -> Partial(); negative Shard dims normalized given ndim."""
    if isinstance(p, Placement):
        if ndim is not None and isinstance(p, (Shard, InterleavedShard)) and p.dim < 0:
            return dataclasses.replace(p, dim=p.dim + ndim)
        return p
    if isinstance(p, int):
        return Shard(p if ndim is None or p >= 0 else p + ndim)
    if isinstance(p, str):
        s = p.strip().lower()
        if s in ("r", "replicate"):
            return Replicate()
        if s in ("p", "partial"):
            return Partial()
        if s.startswith("s(") and s.endswith(")"):
            return Shard(int(s[2:-1]))
    raise ValueError(f"cannot interpret placement {p!r}")


def normalize_placements(placements, mesh_ndim: int, tensor_ndim: Optional[int] = None) -> Tuple[Placement, ...]:
    """Normalize a user-facing placements argument to a full tuple of length
    ``mesh_ndim`` (missing trailing entries replicate, mirroring reference
    api semantics)."""
    if placements is None:
        return tuple(Replicate() for _ in range(mesh_ndim))
    if isinstance(placements, (Placement, int, str)):
        placements = [placements]
    out = [normalize_placement(p, tensor_ndim) for p in placements]
    if len(out) > mesh_ndim:
        raise ValueError(f"{len(out)} placements for mesh of {mesh_ndim} dims")
    out.extend(Replicate() for _ in range(mesh_ndim - len(out)))
    return tuple(out)


def transition_candidates(src_p: Placement, dst_p: Placement) -> Tuple[Placement, ...]:
    """Candidate intermediate placements for ONE mesh dim when planning a
    multi-hop redistribution (the reference's ``redistribute_plan.py``).

    The lattice spanned per mesh dim: the two endpoint placements, the
    plain-``Shard`` relaxation of any ``InterleavedShard`` endpoint (the
    bridge for merged-QKV interleave changes that differ on several mesh
    dims at once), and ``Replicate`` — the universal bridge every primitive
    kernel can reach (gather) and leave (slice/seed).  Kept deliberately
    small: the planner's node set is the cartesian product across mesh dims,
    and 3-4 candidates per dim keep a 4-D mesh's lattice under ~300 specs.
    """
    out: list = []
    for p in (src_p, dst_p):
        if p not in out:
            out.append(p)
        if isinstance(p, InterleavedShard):
            s = Shard(p.dim)
            if s not in out:
                out.append(s)
    r = Replicate()
    if r not in out:
        out.append(r)
    return tuple(out)


def plan_axes(mesh, **dims) -> list:
    """Placements list for ``mesh`` with ``dims[name]`` at the mesh dim
    *named* ``name`` and Replicate elsewhere.

    Makes sharding plans mesh-shape-agnostic: the reference's plans are
    positional lists tied to a fixed ("dp","tp") mesh
    (legacy/examples/open_llama_4D_benchmark/sharding_plan.py); here the same
    plan composes unchanged onto ("pp","dp","tp") or 5-D meshes — names
    absent from the mesh are simply dropped (that axis stays unsharded).
    """
    out = [Replicate() for _ in range(len(mesh.mesh_dim_names))]
    for name, p in dims.items():
        if name in mesh.mesh_dim_names:
            out[mesh.mesh_dim_names.index(name)] = normalize_placement(p)
        elif len(mesh.mesh_dim_names) > 1:
            import warnings

            warnings.warn(
                f"plan_axes: mesh {mesh.mesh_dim_names} has no dim named {name!r}; "
                "that axis stays unsharded (replicated)",
                stacklevel=2,
            )
    return out
