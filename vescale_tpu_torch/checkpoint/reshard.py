"""Chunk-box math for checkpoint save and load with resharding.

The port of ``vescale_tpu/checkpoint/reshard.py`` (framework-free there
too): the reference's load-time resharding (legacy vescale
``vescale_planner.py:64`` create_default_local_load_plan: intersect the
saved chunks with the current spec) and the ragged chunk math of
``vescale_utils/checkpoint.py:70`` (_break_ragged_box).

A *box* is (offsets, sizes) in the logical global index space of one
array.  Ragged chunks are boxes over the flattened space (``flat=True``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Box",
    "box_of_rank",
    "chunks_for_spec",
    "dense_to_flat_ranges",
    "fill_box_from_chunks",
    "intersect",
    "plain_load_spec",
]


def plain_load_spec(spec):
    """The loadable relaxation of a template whose local pieces are not
    contiguous boxes (``InterleavedShard``): the same mesh with each
    ``InterleavedShard(d, m)`` relaxed to ``Shard(d)``.  The loader fills
    this spec's box and ``redistribute`` moves it into the template's
    layout.  None when the template has no interleave or has a Partial or
    ragged placement."""
    from ..placements import InterleavedShard, Shard
    from ..spec import DArraySpec

    if not spec.layout().interleaves or spec.has_partial() or spec.has_ragged():
        return None
    placements = tuple(Shard(p.dim) if isinstance(p, InterleavedShard) else p
                       for p in spec.placements)
    return DArraySpec(spec.mesh, placements, spec.meta)


@dataclasses.dataclass(frozen=True)
class Box:
    offset: Tuple[int, ...]
    size: Tuple[int, ...]
    flat: bool = False  # offsets and sizes in the flattened index space

    @property
    def nelems(self) -> int:
        n = 1
        for s in self.size:
            n *= s
        return n

    def to_json(self):
        return {"offset": list(self.offset), "size": list(self.size), "flat": self.flat}

    @staticmethod
    def from_json(d) -> "Box":
        return Box(tuple(d["offset"]), tuple(d["size"]), bool(d.get("flat", False)))


def box_of_rank(spec, rank: int) -> Box:
    """The box the mesh's flat position ``rank`` holds under a Shard,
    Replicate or ragged spec (a flat box when ragged)."""
    coord = spec.mesh.coordinate_of_rank(rank)
    if spec.has_ragged():
        size, off = spec.ragged_local_chunk(coord)
        return Box((off,), (size,), flat=True)
    shape, offs = spec.local_chunk(coord)
    return Box(tuple(offs), tuple(shape))


def intersect(a: Box, b: Box) -> Optional[Box]:
    """The intersection of two boxes of one index space (None if empty).
    Mixed flat and dense boxes are intersected by the caller in the flat
    space (``dense_to_flat_ranges``)."""
    if a.flat != b.flat:
        raise ValueError("boxes live in different index spaces; flatten first")
    off, size = [], []
    for (ao, asz), (bo, bsz) in zip(zip(a.offset, a.size), zip(b.offset, b.size)):
        lo, hi = max(ao, bo), min(ao + asz, bo + bsz)
        if lo >= hi:
            return None
        off.append(lo)
        size.append(hi - lo)
    return Box(tuple(off), tuple(size), a.flat)


def dense_to_flat_ranges(box: Box, shape: Sequence[int]) -> List[Tuple[int, int]]:
    """A dense box as contiguous (start, length) runs of the flattened
    row-major space (to intersect dense saves with ragged loads: the
    reference's _break_ragged_box)."""
    if box.nelems == 0:
        return []
    if box.flat:
        return [(box.offset[0], box.size[0])]
    if not shape:
        return [(0, 1)]
    strides = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    # j = the last dim not fully covered; every dim after j is full, so one
    # run spans size[j] * prod(shape[j+1:]) elements
    j = 0
    for d in range(len(shape) - 1, -1, -1):
        if not (box.offset[d] == 0 and box.size[d] == shape[d]):
            j = d
            break
    run = box.size[j] * strides[j]
    ranges: List[Tuple[int, int]] = []
    idx = [0] * j  # odometer over dims 0..j-1
    while True:
        start = box.offset[j] * strides[j]
        start += sum((box.offset[d] + idx[d]) * strides[d] for d in range(j))
        ranges.append((int(start), int(run)))
        d = j - 1
        while d >= 0:
            idx[d] += 1
            if idx[d] < box.size[d]:
                break
            idx[d] = 0
            d -= 1
        if d < 0 or j == 0:
            break
    return ranges


def chunks_for_spec(spec) -> List[Tuple[Box, Tuple[int, ...]]]:
    """The unique chunks of a spec, each with every flat rank holding it,
    deduped across replicated mesh dims (the reference planner's save-side
    WriteItems, ``vescale_planner.py:106``).  Every replica is recorded so
    a multi-process save can spread chunk writes over the processes that
    hold the data (``vescale_planner.py:132,137``)."""
    seen: dict = {}
    for r in range(spec.mesh.size()):
        box = box_of_rank(spec, r)
        if box.nelems > 0:
            seen.setdefault(box, []).append(r)
    return [(box, tuple(ranks)) for box, ranks in seen.items()]


def _typed(data: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """A saved chunk in the assembly dtype: bfloat16 chunks read as 2-byte
    voids and are viewed as their ``int16`` bits."""
    data = np.asarray(data)
    if data.dtype.kind == "V" and data.dtype.itemsize == dtype.itemsize:
        return data.view(dtype)
    return data


def fill_box_from_chunks(tbox: Box, shape: Sequence[int], dtype, saved, read) -> np.ndarray:
    """The contents of one target box from the saved chunks that intersect
    it, reading ONLY those chunks (the reference's local-only load plan).

    ``saved`` is ``[(Box, fname), ...]``; ``read(fname)`` returns the
    chunk's array and is expected to cache and count reads.  Mixed flat
    (ragged) and dense boxes are resolved in the flattened row-major space
    through ``dense_to_flat_ranges``: a dense box's elements in row-major
    order are the concatenation of its flat runs, so run overlaps map
    source positions to target positions with no full-array buffer.  A
    target box that is exactly one saved chunk comes back as that chunk's
    array (read-only, no copy)."""
    dtype = np.dtype(dtype)
    for box, fname in saved:
        if box == tbox and tbox.nelems > 0:
            return _typed(read(fname), dtype).reshape(tbox.size)
    out = np.zeros(tbox.size, dtype)
    if tbox.nelems == 0:
        return out  # an over-sharded rank owns an empty piece; nothing to read
    any_flat = tbox.flat or any(b.flat for b, _ in saved)
    if not any_flat:
        for box, fname in saved:
            inter = intersect(box, tbox)
            if inter is None:
                continue
            data = _typed(read(fname), dtype).reshape(box.size)
            src = tuple(slice(o - bo, o - bo + s) for o, bo, s in zip(inter.offset, box.offset, inter.size))
            dst = tuple(slice(o - to, o - to + s) for o, to, s in zip(inter.offset, tbox.offset, inter.size))
            out[dst] = data[src]
        return out
    outflat = out.reshape(-1)
    tranges = dense_to_flat_ranges(tbox, shape)
    tpos = np.cumsum([0] + [n for _s, n in tranges[:-1]])
    tmin, tmax = tranges[0][0], max(ts + tl for ts, tl in tranges)
    for box, fname in saved:
        sranges = dense_to_flat_ranges(box, shape)
        # cheap whole-chunk rejection before the run-pair scan
        if not sranges or sranges[-1][0] + sranges[-1][1] <= tmin or sranges[0][0] >= tmax:
            continue
        data = None
        sp = 0
        for ss, sl in sranges:
            if ss >= tmax:
                break  # both run lists ascend; nothing later can overlap
            if ss + sl > tmin:
                for (ts, tl), tp in zip(tranges, tpos):
                    lo, hi = max(ts, ss), min(ts + tl, ss + sl)
                    if lo >= hi:
                        continue
                    if data is None:
                        data = _typed(read(fname), dtype).reshape(-1)
                    outflat[tp + lo - ts: tp + hi - ts] = data[sp + lo - ss: sp + hi - ss]
            sp += sl
    return out
