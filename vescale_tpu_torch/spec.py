"""DArraySpec: the layout algebra of the SPMD core.

The port of ``vescale_tpu/spec.py``, without its ``PartitionSpec`` lowering.
The reference packs a logical array into one padded *physical* global
array; here every rank holds only its local piece, unpadded, so a spec
answers one question for any mesh coordinate: which elements of the global
tensor that coordinate holds, and in what order.

  * ``Shard(d)``             contiguous ceil-division chunks of dim ``d``;
                             several mesh dims on one tensor dim nest in
                             mesh-dim order (earlier = outer).  Trailing
                             ranks may hold smaller or empty chunks.
  * ``InterleavedShard(d,m)`` dim ``d`` seen as ``(m, S[d]/m)``; the second
                             factor is chunked, so a rank holds its chunk of
                             every section, section-major.
  * ``Partial``              every rank holds a tensor of its local shape:
                             its own contribution.
  * ``RaggedShard(dims,u)``  ``dims`` flattened; rank ``r`` holds the flat
                             range of ``u[r]`` units, ranges packed in rank
                             order.
  * ``StridedRaggedShard``   the ragged split first (outer); the composed
                             even ``Shard`` splits each ragged chunk into
                             ``split_factor`` cells.

An *index set* describes a rank's piece: ``("dense", segs)`` with one list
of ``(global_start, length)`` segments per tensor dim (the piece is the
product of the per-dim concatenations), or ``("flat", segs)`` with segments
of the flattened tensor.  Every transition of ``redistribute.py`` and every
draw of ``random.py`` works from them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch

from .mesh import DeviceMesh
from .placements import (
    InterleavedShard,
    Partial,
    Placement,
    RaggedShard,
    Shard,
    StridedRaggedShard,
    normalize_placements,
)

__all__ = ["DArraySpec", "TensorMeta", "nested_chunk", "innermost_chunk"]

@dataclasses.dataclass(frozen=True)
class TensorMeta:
    """Logical (global) tensor metadata (reference placement_types.py:373)."""

    shape: Tuple[int, ...]
    dtype: Any

    @property
    def ndim(self) -> int:
        return len(self.shape)


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def nested_chunk(extent: int, sizes: Sequence[int], idx: Sequence[int]) -> Tuple[int, int]:
    """(local_size, logical_offset) after nested ceil-chunking of ``extent``
    by mesh-dim sizes ``sizes`` at coordinates ``idx`` (outer-to-inner)."""
    ext, off = extent, 0
    for n, r in zip(sizes, idx):
        c = _ceil(ext, n)
        o = min(c * r, ext)
        ext = min(c, ext - o)
        off += o
    return ext, off


def innermost_chunk(extent: int, sizes: Sequence[int]) -> int:
    c = extent
    for n in sizes:
        c = _ceil(c, n)
    return c


@dataclasses.dataclass(frozen=True)
class _Layout:
    partial_mesh_dims: Tuple[int, ...]
    interleaves: Tuple[Tuple[int, int], ...]    # (logical_dim, m), sorted
    dim_mesh_dims: Tuple[Tuple[int, ...], ...]  # per tensor dim: sharding mesh dims, outer first
    ragged: Optional[Tuple[int, RaggedShard]]
    ragged_inner_shard: Optional[int]
    cell_pad: int                               # largest ragged cell (elements)


class DArraySpec:
    """mesh + placements + logical tensor meta, with a cached layout."""

    __slots__ = ("mesh", "placements", "meta", "_layout")

    def __init__(self, mesh: DeviceMesh, placements, meta: TensorMeta):
        self.mesh = mesh
        self.placements: Tuple[Placement, ...] = normalize_placements(
            placements, mesh.ndim, len(meta.shape)
        )
        self.meta = meta
        self._layout: Optional[_Layout] = None

    # ------------------------------------------------------------- basics
    @property
    def shape(self) -> Tuple[int, ...]:
        return self.meta.shape

    @property
    def dtype(self):
        return self.meta.dtype

    @property
    def ndim(self) -> int:
        return len(self.meta.shape)

    def is_replicated(self) -> bool:
        return all(p.is_replicate() for p in self.placements)

    def has_partial(self) -> bool:
        return any(p.is_partial() for p in self.placements)

    def has_ragged(self) -> bool:
        return any(p.is_ragged_shard() for p in self.placements)

    def with_placements(self, placements) -> "DArraySpec":
        return DArraySpec(self.mesh, placements, self.meta)

    def logical_bytes(self) -> int:
        """Bytes of the full logical tensor."""
        return _prod(self.meta.shape) * _itemsize(self.meta.dtype)

    def per_shard_bytes(self) -> int:
        """Bytes of the largest rank's local piece."""
        return max(_prod(self.local_shape(self.mesh.coordinate_of_rank(r)))
                   for r in range(self.mesh.size())) * _itemsize(self.meta.dtype)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, DArraySpec)
            and self.mesh == other.mesh
            and self.placements == other.placements
            and self.meta == other.meta
        )

    def __hash__(self) -> int:
        return hash((self.mesh, self.placements, self.meta))

    def __repr__(self) -> str:
        ps = ", ".join(str(p) for p in self.placements)
        return f"DArraySpec([{ps}] over {dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))}, shape={self.shape})"

    # ------------------------------------------------------------- layout
    def layout(self) -> _Layout:
        if self._layout is None:
            self._layout = self._compute_layout()
        return self._layout

    def _compute_layout(self) -> _Layout:
        placements, shape = self.placements, self.meta.shape
        ragged = [(i, p) for i, p in enumerate(placements) if isinstance(p, RaggedShard)]
        if len(ragged) > 1:
            raise ValueError("at most one RaggedShard placement per DArray")
        if ragged:
            return self._compute_ragged_layout(ragged[0])

        partial_dims = tuple(i for i, p in enumerate(placements) if p.is_partial())
        interleaves = {}
        for p in placements:
            if isinstance(p, InterleavedShard):
                if p.dim in interleaves and interleaves[p.dim] != p.interleaved_size:
                    raise ValueError(f"conflicting interleaved sizes on dim {p.dim}")
                if shape[p.dim] % p.interleaved_size != 0:
                    raise ValueError(
                        f"dim {p.dim} size {shape[p.dim]} not divisible by interleaved_size {p.interleaved_size}"
                    )
                interleaves[p.dim] = p.interleaved_size
        for p in placements:
            if type(p) is Shard and p.dim in interleaves:
                raise ValueError(f"cannot mix Shard and InterleavedShard on dim {p.dim}")
        dim_mesh_dims: List[List[int]] = [[] for _ in shape]
        for i, p in enumerate(placements):
            if isinstance(p, (Shard, InterleavedShard)):
                if not 0 <= p.dim < len(shape):
                    raise ValueError(f"{p} out of range for a {len(shape)}-D tensor")
                dim_mesh_dims[p.dim].append(i)
        return _Layout(
            partial_mesh_dims=partial_dims,
            interleaves=tuple(sorted(interleaves.items())),
            dim_mesh_dims=tuple(tuple(m) for m in dim_mesh_dims),
            ragged=None,
            ragged_inner_shard=None,
            cell_pad=0,
        )

    def _compute_ragged_layout(self, ragged_entry) -> _Layout:
        mesh, placements, shape = self.mesh, self.placements, self.meta.shape
        rj, rp = ragged_entry
        partial_dims = tuple(i for i, p in enumerate(placements) if p.is_partial())
        inner_shard = None
        for i, p in enumerate(placements):
            if i == rj or p.is_partial() or p.is_replicate():
                continue
            if type(p) is Shard:
                if isinstance(rp, StridedRaggedShard) and p.dim == rp.dims[0] and inner_shard is None:
                    inner_shard = i
                    continue
            raise ValueError(
                "RaggedShard composes only with Replicate/Partial (or one even "
                f"Shard via StridedRaggedShard); got {p} on mesh dim {i}"
            )
        if isinstance(rp, StridedRaggedShard):
            if inner_shard is None and rp.split_factor != 1:
                raise ValueError("StridedRaggedShard.split_factor set but no composing Shard found")
            if inner_shard is not None and mesh.shape[inner_shard] != rp.split_factor:
                raise ValueError(
                    f"split_factor {rp.split_factor} != size of composing mesh dim {mesh.shape[inner_shard]}"
                )
        if rp.dims[0] != 0 or rp.dims[-1] != len(shape) - 1:
            # ragged flattens the whole tensor (the reference's round-1
            # semantics: FSDP flattens whole parameter groups too)
            if any(shape[d] != 1 for d in range(len(shape)) if d not in rp.dims):
                raise ValueError("RaggedShard must cover all non-trivial dims")
        if partial_dims:
            raise ValueError("Partial + RaggedShard composition is not supported")
        nj = mesh.shape[rj]
        if len(rp.local_units) != nj:
            raise ValueError(f"local_units {rp.local_units} != mesh dim size {nj}")
        sizes, _ = rp.local_sizes_and_offsets(_prod(shape))
        s = mesh.shape[inner_shard] if inner_shard is not None else 1
        for sz in sizes:
            if sz % s != 0:
                raise ValueError(f"ragged chunk {sz} not divisible by inner shard factor {s}")
        return _Layout(
            partial_mesh_dims=(),
            interleaves=(),
            dim_mesh_dims=tuple(() for _ in shape),
            ragged=(rj, rp),
            ragged_inner_shard=inner_shard,
            cell_pad=max(sz // s for sz in sizes),
        )

    # -------------------------------------------- per-rank chunk queries
    def local_chunk(self, coord: Sequence[int]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(local logical shape, global offsets) for the rank at mesh
        coordinate ``coord``: Shard/Replicate/Partial layouts (a Partial
        local is its shape at offset 0).  Ragged uses
        ``ragged_local_chunk``, interleaved ``interleaved_local_slices``."""
        if self.has_ragged():
            raise ValueError("use ragged_local_chunk for ragged specs")
        shape = list(self.meta.shape)
        offs = [0] * len(shape)
        for i, p in enumerate(self.placements):
            if type(p) is Shard:
                sz, off = p.local_shard_size_and_offset(shape[p.dim], self.mesh.shape[i], coord[i])
                shape[p.dim] = sz
                offs[p.dim] += off
            elif isinstance(p, InterleavedShard):
                raise ValueError("InterleavedShard local chunk is strided; use interleaved_local_slices")
        return tuple(shape), tuple(offs)

    def ragged_local_chunk(self, coord: Sequence[int]) -> Tuple[int, int]:
        """(flat_size, flat_offset) of the ragged chunk owned at ``coord``."""
        lay = self.layout()
        rj, rp = lay.ragged
        sizes, offs = rp.local_sizes_and_offsets(_prod(self.meta.shape))
        r = coord[rj]
        if lay.ragged_inner_shard is not None:
            a = coord[lay.ragged_inner_shard]
            cell = sizes[r] // self.mesh.shape[lay.ragged_inner_shard]
            return cell, offs[r] + a * cell
        return sizes[r], offs[r]

    def interleaved_local_slices(self, coord: Sequence[int]):
        """For InterleavedShard dims: list of (dim, [(offset, size), ...])
        describing the strided global slices owned at ``coord``."""
        out = []
        for i, p in enumerate(self.placements):
            if isinstance(p, InterleavedShard):
                sec = self.meta.shape[p.dim] // p.interleaved_size
                ext, off = nested_chunk(sec, [self.mesh.shape[i]], [coord[i]])
                out.append((p.dim, [(j * sec + off, ext) for j in range(p.interleaved_size)]))
        return out

    def index_set(self, coord: Sequence[int]):
        """The global elements held at ``coord``: ``("flat", segs)`` for a
        ragged layout, else ``("dense", per-dim segs)``."""
        lay = self.layout()
        if lay.ragged is not None:
            size, off = self.ragged_local_chunk(coord)
            return "flat", [(off, size)]
        inter = dict(lay.interleaves)
        out = []
        for d, extent in enumerate(self.meta.shape):
            dims = lay.dim_mesh_dims[d]
            m = inter.get(d, 1)
            sec = extent // m
            ext, off = nested_chunk(sec, [self.mesh.shape[i] for i in dims], [coord[i] for i in dims])
            out.append([(j * sec + off, ext) for j in range(m)])
        return "dense", out

    def local_shape(self, coord: Sequence[int]) -> Tuple[int, ...]:
        kind, segs = self.index_set(coord)
        if kind == "flat":
            return (segs[0][1],)
        return tuple(sum(n for _, n in s) for s in segs)

    def data_mesh_dims(self) -> Tuple[int, ...]:
        """Mesh dims whose coordinate selects data (shard, ragged or
        partial); coordinates on the others are replicas."""
        return tuple(i for i, p in enumerate(self.placements) if not p.is_replicate())

    def seeds_zero(self, coord: Sequence[int]) -> bool:
        """Whether ``coord`` holds zeros when a full value is *distributed*
        onto this spec: a ``Partial("sum")`` contribution sits at coordinate
        0 of its mesh dim and zeros elsewhere ("avg"/"max"/"min" replicate),
        as the reference's ``pack(partial_seed=True)`` does."""
        return any(isinstance(p, Partial) and p.reduce_op == "sum" and coord[i] != 0
                   for i, p in enumerate(self.placements))

    # ------------------------------------------------------ local pieces
    def local_from_full(self, full: torch.Tensor, coord: Sequence[int]) -> torch.Tensor:
        """``coord``'s local piece of the full tensor: a view where the piece
        is one contiguous block, else a copy; Partial seeding applied."""
        kind, segs = self.index_set(coord)
        if kind == "flat":
            (off, size), = segs
            x = full.reshape(-1).narrow(0, off, size)
        else:
            x = full
            for d, s in enumerate(segs):
                if len(s) == 1:
                    if s[0][1] != x.shape[d]:
                        x = x.narrow(d, s[0][0], s[0][1])
                else:
                    x = torch.cat([x.narrow(d, a, n) for a, n in s], dim=d)
        return torch.zeros_like(x) if self.seeds_zero(coord) else x

    def assemble(self, locals_: Sequence[torch.Tensor]) -> torch.Tensor:
        """The full logical tensor from every rank's local piece, in flat
        rank order (the single-process model of an all-gather): each
        replica group's data comes from its coordinate 0, and Partial
        contributions are reduced over their mesh dims."""
        mesh = self.mesh
        if len(locals_) != mesh.size():
            raise ValueError(f"need {mesh.size()} locals, got {len(locals_)}")
        lay = self.layout()
        ref = locals_[0]
        parts = {}
        for r in range(mesh.size()):
            coord = mesh.coordinate_of_rank(r)
            if any(coord[i] != 0 for i, p in enumerate(self.placements) if p.is_replicate()):
                continue
            pkey = tuple(coord[i] for i in lay.partial_mesh_dims)
            full = parts.get(pkey)
            if full is None:
                full = parts[pkey] = torch.empty(self.meta.shape, dtype=ref.dtype, device=ref.device)
            loc = locals_[r]
            if tuple(loc.shape) != self.local_shape(coord):
                raise ValueError(f"rank {r}: local shape {tuple(loc.shape)} != expected "
                                 f"{self.local_shape(coord)}")
            _write_piece(full, loc, self.index_set(coord))
        if not lay.partial_mesh_dims:
            return parts[()]
        stack = torch.stack([parts[k] for k in sorted(parts)])
        op = self.placements[lay.partial_mesh_dims[0]].reduce_op
        if any(self.placements[i].reduce_op != op for i in lay.partial_mesh_dims):
            raise ValueError("assemble needs one reduce_op over all Partial mesh dims")
        if op == "sum":
            return stack.sum(0)
        if op == "avg":
            return stack.mean(0)
        return stack.amax(0) if op == "max" else stack.amin(0)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _write_piece(full: torch.Tensor, local: torch.Tensor, index_set) -> None:
    kind, segs = index_set
    if kind == "flat":
        (off, size), = segs
        full.view(-1).narrow(0, off, size).copy_(local.reshape(-1))
        return
    for blk_full, blk_local in _blocks(segs):
        full[blk_full].copy_(local[blk_local])


def _blocks(segs):
    """(global slices, local slices) of each block of a dense index set."""
    per_dim = []
    for s in segs:
        rows, lo = [], 0
        for a, n in s:
            if n:
                rows.append((slice(a, a + n), slice(lo, lo + n)))
            lo += n
        per_dim.append(rows)
    if any(not rows for rows in per_dim):
        return []
    out = [((), ())]
    for rows in per_dim:
        out = [(g + (rg,), l + (rl,)) for g, l in out for rg, rl in rows]
    return out


def overlap_blocks(src_set, dst_set):
    """The elements two index sets share, as a list of ``(src local
    slices, dst local slices)`` blocks in a fixed order (the same on the
    sending and the receiving rank).  Both sets must be of one kind."""
    skind, ssegs = src_set
    dkind, dsegs = dst_set
    if skind != dkind:
        raise ValueError("overlap of a flat and a dense index set")
    per_dim = []
    for s, d in zip(ssegs, dsegs) if skind == "dense" else [(ssegs, dsegs)]:
        rows = []
        lo_s = 0
        for a, n in s:
            lo_d = 0
            for b, m in d:
                lo, hi = max(a, b), min(a + n, b + m)
                if lo < hi:
                    rows.append((slice(lo_s + lo - a, lo_s + hi - a), slice(lo_d + lo - b, lo_d + hi - b)))
                lo_d += m
            lo_s += n
        if not rows:
            return []
        per_dim.append(rows)
    out = [((), ())]
    for rows in per_dim:
        out = [(a + (rs,), b + (rd,)) for a, b in out for rs, rd in rows]
    return out


def flat_view(index_set, shape):
    """A dense index set that covers the whole tensor, as the flat set
    ``[(0, N)]``; None when it does not cover it."""
    kind, segs = index_set
    if kind == "flat":
        return index_set
    if all(len(s) == 1 and s[0] == (0, n) for s, n in zip(segs, shape)):
        return "flat", [(0, _prod(shape))]
    return None
