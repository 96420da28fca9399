"""Redistribute: placement transitions as collectives over the mesh dims.

The port of ``vescale_tpu/redistribute.py``.  Each rank holds its piece, so
a transition is a sequence of hops on one mesh dim at a time, each over
that dim's process group (the legacy veScale ``redistribute.py:223`` table):

  Shard/Interleaved -> Replicate   all-gather (uneven pieces padded, unpadded)
  RaggedShard -> Replicate          all-gather-v (pad to the largest chunk)
  Replicate -> any shard            local slice, no communication
  Partial -> Replicate              all-reduce
  Partial -> Shard(d)               reduce-scatter (max/min: all-reduce, slice)
  Replicate -> Partial              local seed (sum: zeros off coordinate 0)
  shard -> shard on one mesh dim    all-to-all(-v) of exactly the elements
                                    each pair of ranks shares: Shard(d) ->
                                    Shard(d'), interleaved changes, ragged ->
                                    ragged (memory O(shard))
  StridedRaggedShard                its inner Shard gathered (cells -> chunk)
                                    before, and sliced after, its ragged hop

Hops run inner mesh dims first for gathers and outer first for slices; a
hop on a tensor dim that an inner mesh dim also shards first gathers that
inner dim.  A Partial mesh dim that does not change keeps every rank's
contribution where it is (the reference may instead seed the sum at
coordinate 0: the same value, split otherwise).  Cross-mesh transitions of plain placements (no ragged; Partial
reduced on the source mesh first) are one all-to-all-v over every rank.

``redistribute()`` takes the reference's tiers in order: the int8 overlay
(``VESCALE_REDISTRIBUTE_QUANT``, a lossy quantized single hop where the
cost model prefers it), the trivial no-op, the single hop (``plan`` with
no gather and slice on one mesh dim), the multi-hop planner
(``redistribute_plan.py``: per-shard hops within a memory budget), the
plain cross-mesh all-to-all-v, and last the fallback: through Replicate,
which may hold the logical tensor, so it warns once per pair with the
planner's ``[VSC12x]`` decline, counts ``redistribute.fallbacks`` in
``telemetry.registry.GLOBAL`` and raises under
``VESCALE_STRICT_REDISTRIBUTE=1``.  ``classify_transition`` names the tier
a pair takes without running it.  The port's single hop serves some pairs
the reference plans in several hops (a Partial with a Shard move on
another mesh dim, interleaves changing on several mesh dims): those never
reach the planner here (ROADMAP.md section C).

``redistribute_local_tensor`` is the single-process model: every rank's
source piece in, one rank's destination piece out.  It runs the plan of
the all-to-all-v that ``_exchange`` sends (the elements each pair of ranks
shares, over every rank at once) and copies each block from its sender's
piece, where the live path moves it through a collective.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import collectives as C
from . import config
from .darray import DArray
from .mesh import DeviceMesh
from .placements import (
    InterleavedShard,
    Partial,
    Placement,
    RaggedShard,
    Replicate,
    Shard,
    StridedRaggedShard,
    normalize_placements,
)
from .spec import DArraySpec, TensorMeta, flat_view, nested_chunk, overlap_blocks

__all__ = ["redistribute", "redistribute_local_tensor", "classify_transition"]


def _strict() -> bool:
    return config.get_bool("VESCALE_STRICT_REDISTRIBUTE")


# ------------------------------------------------------------- the plan
def _ragged_inner(placements, i):
    """The mesh dim of the Shard composed into the StridedRaggedShard at
    ``i`` (None when it has none)."""
    p = placements[i]
    if not isinstance(p, StridedRaggedShard):
        return None
    for j, q in enumerate(placements):
        if j != i and type(q) is Shard and q.dim == p.dims[0]:
            return j
    return None


def _plain(p: Placement) -> Placement:
    return RaggedShard(p.dims, p.local_units) if isinstance(p, RaggedShard) else p


def _touch(p: Placement, ndim: int) -> set:
    """The tensor dims a placement shards (ragged: all of them)."""
    if isinstance(p, (Shard, InterleavedShard)):
        return {p.dim}
    if isinstance(p, RaggedShard):
        return set(range(ndim))
    return set()


def _shardlike(p: Placement) -> bool:
    return isinstance(p, (Shard, InterleavedShard, RaggedShard))


def _exchangeable(a: Placement, b: Placement) -> bool:
    """One all-to-all moves a to b on its mesh dim: both dense shards, or
    both ragged."""
    return (_shardlike(a) and _shardlike(b)
            and isinstance(a, RaggedShard) == isinstance(b, RaggedShard))


def plan(src: Sequence[Placement], dst: Sequence[Placement], ndim: int):
    """The hops from ``src`` to ``dst`` placements on one mesh, and whether
    the plan goes through Replicate (gathers, then slices, one mesh dim).
    A hop is ``(kind, mesh_dim, placement)``; kinds: ``unstride``,
    ``gather``, ``exchange``, ``reduce``, ``slice``, ``seed``, ``stride``."""
    cur = list(src)
    n = len(cur)
    hops = []
    gathered = set()
    fallback = False
    for i in range(n):
        k = _ragged_inner(cur, i)
        if k is not None and (cur[i] != dst[i] or cur[k] != dst[k]):
            hops.append(("unstride", i, k))
            cur[i], cur[k] = _plain(cur[i]), Replicate()
    target = list(dst)
    strided = {}
    for i in range(n):
        k = _ragged_inner(dst, i)
        if k is not None:
            strided[i] = k
            target[i], target[k] = _plain(dst[i]), Replicate()
    changing = {i for i in range(n) if cur[i] != target[i]}
    grew = True
    while grew:  # a hop on a tensor dim first gathers the inner mesh dims on it
        grew = False
        for i in sorted(changing):
            dims = _touch(cur[i], ndim) | _touch(target[i], ndim)
            for j in range(i + 1, n):
                if j not in changing and _touch(cur[j], ndim) & dims:
                    changing.add(j)
                    grew = True
    for i in sorted(changing, reverse=True):  # gathers and exchanges, inner first
        outer = set()
        for k in changing:
            if k < i:
                outer |= _touch(cur[k], ndim) | _touch(target[k], ndim)
        mine = _touch(cur[i], ndim) | _touch(target[i], ndim)
        if cur[i] != target[i] and _exchangeable(cur[i], target[i]) and not outer & mine:
            hops.append(("exchange", i, target[i]))
            cur[i] = target[i]
        elif _shardlike(cur[i]):
            hops.append(("gather", i, Replicate()))
            cur[i] = Replicate()
            gathered.add(i)
    for i in range(n):  # reductions, slices and seeds, outer first
        if cur[i] != target[i]:
            if cur[i].is_partial():
                if type(target[i]) is Shard and cur[i].reduce_op in ("sum", "avg"):
                    hops.append(("reduce", i, target[i]))
                    cur[i] = target[i]
                else:
                    hops.append(("reduce", i, Replicate()))
                    cur[i] = Replicate()
            if cur[i] != target[i]:
                kind = "seed" if target[i].is_partial() else "slice"
                fallback |= kind == "slice" and i in gathered
                hops.append((kind, i, target[i]))
                cur[i] = target[i]
        for ri, k in strided.items():
            if max(ri, k) == i:
                fallback |= k in gathered
                hops.append(("stride", ri, (dst[ri], k)))
                cur[ri], cur[k] = dst[ri], dst[k]
    if cur != list(dst):
        raise AssertionError(f"redistribute plan ended at {cur}, not {list(dst)}")
    return hops, fallback


# ---------------------------------------------------------- the hops
class _State:
    """One rank's piece mid-transition: its placements so far and tensor."""

    def __init__(self, spec: DArraySpec, local: torch.Tensor, coord):
        self.mesh = spec.mesh
        self.meta = spec.meta
        self.cur: List[Placement] = list(spec.placements)
        self.local = local
        self.coord = tuple(coord)

    def spec(self, placements=None) -> DArraySpec:
        return DArraySpec(self.mesh, placements if placements is not None else self.cur, self.meta)

    def set(self, i: int, p: Placement, local: torch.Tensor) -> None:
        self.cur[i] = p
        self.local = local


def _level_extent(st: _State, i: int, d: int, sec: int) -> int:
    """Extent of tensor dim ``d`` (of a section of ``sec``) at mesh dim
    ``i``: chunked by the mesh dims before ``i`` that shard it."""
    outer = [j for j in range(i)
             if isinstance(st.cur[j], (Shard, InterleavedShard)) and st.cur[j].dim == d]
    ext, _ = nested_chunk(sec, [st.mesh.shape[j] for j in outer], [st.coord[j] for j in outer])
    return ext


def _gather(st: _State, i: int, _=None) -> None:
    """cur[i] (a shard) -> Replicate: all-gather over mesh dim i."""
    p = st.cur[i]
    g = st.mesh.get_group(i)
    n = st.mesh.shape[i]
    if isinstance(p, RaggedShard):
        spec = st.spec()
        sizes = []
        for r in range(n):
            c = list(st.coord)
            c[i] = r
            sizes.append(spec.ragged_local_chunk(c)[0])
        flat = C.gather_v(st.local.reshape(-1), sizes, g)
        st.set(i, Replicate(), flat.reshape(st.meta.shape))
        return
    d = p.dim
    m = p.interleaved_size if isinstance(p, InterleavedShard) else 1
    E = _level_extent(st, i, d, st.meta.shape[d] // m)
    chunk = -(-E // n)
    x = st.local.movedim(d, 0)
    x = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:])).movedim(1, 0)  # (ext, m, ...)
    buf = C.all_gather(C.pad_dim0(x, chunk), g).narrow(0, 0, E)        # (E, m, ...)
    out = buf.movedim(0, 1).reshape((m * E,) + tuple(buf.shape[2:])).movedim(0, d)
    st.set(i, Replicate(), out.contiguous())


def _slice(st: _State, i: int, p: Placement) -> None:
    """cur[i] Replicate -> p (a shard): this rank's cut, no communication."""
    n, r = st.mesh.shape[i], st.coord[i]
    if isinstance(p, RaggedShard):
        sizes, offs = p.local_sizes_and_offsets(st.local.numel())
        st.set(i, p, st.local.reshape(-1).narrow(0, offs[r], sizes[r]).clone())
        return
    d = p.dim
    m = p.interleaved_size if isinstance(p, InterleavedShard) else 1
    E = st.local.shape[d] // m
    sz, off = Shard(0).local_shard_size_and_offset(E, n, r)
    if m == 1:
        out = st.local.narrow(d, off, sz).clone()
    else:
        out = torch.cat([st.local.narrow(d, j * E + off, sz) for j in range(m)], dim=d)
    st.set(i, p, out.contiguous())


def _reduce(st: _State, i: int, p: Placement) -> None:
    """cur[i] Partial -> Replicate (all-reduce) or -> Shard(d)
    (reduce-scatter of the piece padded to whole chunks)."""
    op = st.cur[i].reduce_op
    g = st.mesh.get_group(i)
    if p.is_replicate():
        st.set(i, p, C.all_reduce(st.local, g, op))
        return
    n = st.mesh.shape[i]
    d = p.dim
    E = st.local.shape[d]
    chunk = -(-E // n)
    x = C.pad_dim0(st.local.movedim(d, 0), chunk * n)
    sz, _ = p.local_shard_size_and_offset(E, n, st.coord[i])
    out = C.reduce_scatter(x, g, op).narrow(0, 0, sz).movedim(0, d)
    st.set(i, p, out.contiguous())


def _seed(st: _State, i: int, p: Partial) -> None:
    """cur[i] Replicate -> Partial: the value at coordinate 0 ("sum") or
    on every rank ("avg", "max", "min")."""
    local = st.local
    if p.reduce_op == "sum" and st.coord[i] != 0:
        local = torch.zeros_like(local)
    st.set(i, p, local)


def _unstride(st: _State, i: int, k: int) -> None:
    """A StridedRaggedShard at i with its inner Shard at k: gather each
    ragged chunk's equal cells over k, leaving a plain RaggedShard at i
    and Replicate at k."""
    chunk = C.all_gather(st.local.reshape(-1), st.mesh.get_group(k))
    st.cur[k] = Replicate()
    st.set(i, _plain(st.cur[i]), chunk)


def _stride(st: _State, i: int, arg) -> None:
    """A plain RaggedShard at i -> the strided one ``arg[0]``: cut this
    rank's chunk into ``split_factor`` cells along the composing mesh dim
    ``arg[1]``."""
    p, k = arg
    cell = st.local.numel() // st.mesh.shape[k]
    st.cur[k] = Shard(p.dims[0])
    st.set(i, p, st.local.reshape(-1).narrow(0, st.coord[k] * cell, cell).clone())


def _exchange_dim(st: _State, i: int, p: Placement) -> None:
    """cur[i] -> p between two shards on mesh dim i: all-to-all(-v) among
    the ranks along i."""
    new = list(st.cur)
    new[i] = p
    peers = []
    for r in range(st.mesh.shape[i]):
        c = list(st.coord)
        c[i] = r
        f = int(np.ravel_multi_index(c, st.mesh.shape))
        peers.append((f, f))
    out = _exchange(st.local, st.spec(), st.spec(new), peers, st.coord[i], st.mesh.get_group(i))
    st.set(i, p, out)


_HOPS = {"unstride": _unstride, "gather": _gather, "exchange": _exchange_dim, "reduce": _reduce,
         "slice": _slice, "seed": _seed, "stride": _stride}


def _numel(slices) -> int:
    n = 1
    for s in slices:
        n *= s.stop - s.start
    return n


def _match(a, b, shape):
    """Index set ``a`` in the kind of ``b``: a covering dense set becomes
    flat."""
    if a[0] == b[0]:
        return a
    v = flat_view(a, shape)
    if v is None:
        raise ValueError("no common index space for a flat and a partial dense piece")
    return v


def _exchange_blocks(src_spec: DArraySpec, dst_spec: DArraySpec, peers):
    """The plan of an all-to-all-v: ``blocks(k, j)`` is the index kind and
    the (source, destination) blocks of the elements participant k sends
    participant j.  ``peers[k]`` is participant k's (source, destination)
    flat mesh rank (None where it is not in that mesh).  Of the
    participants holding the same piece (replicas), the receiver itself
    sends when it is one, else the first of them."""
    shape = src_spec.shape
    data = set(src_spec.data_mesh_dims())
    scoords = [None if s is None else src_spec.mesh.coordinate_of_rank(s) for s, _ in peers]
    sets_s = [None if c is None else src_spec.index_set(c) for c in scoords]
    sets_d = [None if d is None else dst_spec.index_set(dst_spec.mesh.coordinate_of_rank(d))
              for _, d in peers]

    keys = [None if c is None else tuple(c[t] for t in sorted(data)) for c in scoords]
    first = {}
    for k, key in enumerate(keys):
        if key is not None:
            first.setdefault(key, k)

    def sends(k, j):
        if keys[k] is None or sets_d[j] is None:
            return False
        return k == j if keys[j] == keys[k] else k == first[keys[k]]

    def blocks(k, j):
        if not sends(k, j):
            return "dense", []
        a = _match(sets_s[k], sets_d[j], shape)
        return a[0], overlap_blocks(a, _match(sets_d[j], sets_s[k], shape))

    return blocks


def _exchange(local: torch.Tensor, src_spec: DArraySpec, dst_spec: DArraySpec, peers, me: int,
              group) -> torch.Tensor:
    """All-to-all-v over ``group`` (participant ``me`` of ``peers``, in
    group order): send each participant the elements of this piece that its
    destination piece holds, and receive the same from each."""
    blocks = _exchange_blocks(src_spec, dst_spec, peers)
    pieces, send_sizes = [], []
    for j in range(len(peers)):
        kind, bl = blocks(me, j)
        src = local if kind == "dense" else local.reshape(-1)
        ps = [src[s].reshape(-1) for s, _ in bl]
        pieces += ps
        send_sizes.append(sum(x.numel() for x in ps))
    recv_plan = [blocks(k, me) for k in range(len(peers))]
    recv_sizes = [sum(_numel(b) for _, b in bl) for _, bl in recv_plan]
    send = torch.cat(pieces) if pieces else local.new_empty((0,))
    recv = C.all_to_all_v(send, send_sizes, recv_sizes, group)
    out = local.new_empty(dst_spec.local_shape(dst_spec.mesh.coordinate_of_rank(peers[me][1])))
    pos = 0
    for kind, bl in recv_plan:
        view = out if kind == "dense" else out.reshape(-1)
        for _, b in bl:
            tgt = view[b]
            tgt.copy_(recv.narrow(0, pos, tgt.numel()).view(tgt.shape))
            pos += tgt.numel()
    return out


# ---------------------------------------------------------------- API
_warned_pairs = set()


def _warn_fallback(src: DArraySpec, dst: DArraySpec) -> None:
    from .debug import DebugLogger
    from .redistribute_plan import decline_reason
    from .telemetry.registry import GLOBAL

    GLOBAL.count("redistribute.fallbacks")
    logical = src.logical_bytes()
    shard = max(logical // max(1, src.mesh.size()), logical // max(1, dst.mesh.size()))
    msg = (
        f"redistribute fallback for {src.placements} -> {dst.placements} "
        f"(mesh {src.mesh.mesh_dim_names}{'->' + str(dst.mesh.mesh_dim_names) if dst.mesh != src.mesh else ''}) "
        f"may materialize the LOGICAL tensor: ~{logical / 2**20:.1f} MiB vs "
        f"~{shard / 2**20:.1f} MiB per-shard; no single hop serves it, so it goes "
        f"through Replicate; multi-hop planner declined: {decline_reason(src, dst)}"
    )
    if _strict():
        raise RuntimeError(msg + " (VESCALE_STRICT_REDISTRIBUTE=1)")
    key = (src, dst)
    if key not in _warned_pairs:
        _warned_pairs.add(key)
        from .telemetry import alerts as _alerts

        if _alerts.is_active():
            # a live engine: one alert with a lifecycle, refreshed for each
            # new pair (the message names the pair), visible on /alerts
            _alerts.raise_alert("redistribute-fallback", message=msg, severity="warning")
        else:
            # a dormant engine: the legacy warning, once a pair
            warnings.warn(msg, stacklevel=3)  # vescale-lint: disable=VSC207
    DebugLogger.log("redistribute", msg)


def redistribute(darr: DArray, placements, mesh: Optional[DeviceMesh] = None) -> DArray:
    """``darr`` laid out as ``placements`` (on ``mesh``, default its own).
    Collective: every rank of the mesh calls it with the same arguments."""
    from .redistribute_plan import plan_redistribute, quant_single_hop_plan

    dst_mesh = mesh or darr.mesh
    dst_placements = normalize_placements(placements, dst_mesh.ndim, darr.ndim)
    src = darr.spec
    dst = DArraySpec(dst_mesh, dst_placements, TensorMeta(src.shape, src.dtype))
    dst.layout()
    if dst_mesh == src.mesh and config.get_bool("VESCALE_REDISTRIBUTE_QUANT"):
        qplan = quant_single_hop_plan(src, dst)
        if qplan is not None:
            return qplan.execute(darr)
    if dst == src:
        return darr
    if dst_mesh == src.mesh:
        hops, fallback = plan(src.placements, dst.placements, src.ndim)
        if not fallback:
            return _run(darr, src, dst, hops)
    multi = plan_redistribute(src, dst)
    if multi is not None:
        return multi.execute(darr)
    if dst_mesh != src.mesh:
        return _cross_mesh(darr, src, dst)
    _warn_fallback(src, dst)
    return _run(darr, src, dst, hops)


def _run(darr: DArray, src: DArraySpec, dst: DArraySpec, hops) -> DArray:
    st = _State(src, darr.to_local(), darr.coordinate)
    for kind, i, arg in hops:
        _HOPS[kind](st, i, arg)
    return DArray(st.local, dst, darr.rank)


def classify_transition(src: DArraySpec, dst: DArraySpec) -> str:
    """The tier of ``redistribute()`` that serves src -> dst, without
    running it: ``trivial`` | ``kernel`` (one per-shard pass) | ``planned``
    (the multi-hop planner) | ``cross_mesh_plain`` (the all-to-all-v over
    every rank) | ``fallback`` (through Replicate, may hold the logical
    tensor).  Kept beside the dispatch so the two cannot drift."""
    from .redistribute_plan import plan_redistribute

    if dst == src:
        return "trivial"
    if src.mesh == dst.mesh and not plan(src.placements, dst.placements, src.ndim)[1]:
        return "kernel"
    if plan_redistribute(src, dst) is not None:
        return "planned"
    if src.mesh != dst.mesh and _plain_placements(src) is not None \
            and _plain_placements(dst) is not None:
        return "cross_mesh_plain"
    return "fallback"


def _plain_placements(spec: DArraySpec):
    """Partials reduced to Replicate; None for a ragged spec."""
    if spec.has_ragged():
        return None
    return tuple(Replicate() if p.is_partial() else p for p in spec.placements)


def _cross_mesh(darr: DArray, src: DArraySpec, dst: DArraySpec) -> DArray:
    """Between two live meshes over the same ranks: reduce partials on the
    source mesh, then one all-to-all-v over every rank; ragged layouts go
    through Replicate (a fallback)."""
    sp, dp = _plain_placements(src), _plain_placements(dst)
    if sp is None or dp is None:
        _warn_fallback(src, dst)
        rep = redistribute(darr, [Replicate()] * src.mesh.ndim)
        return _distribute_on(rep.to_local(), dst)
    if sp != src.placements:
        darr = redistribute(darr, sp)
        src = darr.spec
    res = _exchange_world(darr, src, DArraySpec(dst.mesh, dp, dst.meta))
    return res if res.spec == dst else redistribute(res, dst.placements)


def _exchange_world(darr: DArray, src: DArraySpec, dst: DArraySpec) -> DArray:
    """``darr`` (laid out as ``src``) as ``dst`` by one all-to-all-v over
    every rank of both meshes (the same ranks): each rank sends each other
    rank the elements their pieces share.  Both specs are plain (no
    Partial): the planner's reshard and cross-mesh bridge."""
    if sorted(src.mesh.ranks.reshape(-1).tolist()) != sorted(dst.mesh.ranks.reshape(-1).tolist()):
        raise ValueError("cross-mesh redistribute needs two meshes over the same ranks")
    world = sorted(src.mesh.ranks.reshape(-1).tolist())
    peers = [(src.mesh.flat_rank_of(g), dst.mesh.flat_rank_of(g)) for g in world]
    me = world.index(dist.get_rank())
    group = _world_group(src.mesh, world)
    out = _exchange(darr.to_local(), src, dst, peers, me, group)
    return DArray(out, dst, peers[me][1])


def _distribute_on(full: torch.Tensor, spec: DArraySpec) -> DArray:
    from .darray import distribute_tensor

    return distribute_tensor(full, spec.mesh, spec.placements)


_WORLD_GROUPS = {}  # (id of the default group, backend, ranks) -> (default group, group)


def _world_group(mesh, ranks: List[int]):
    """A group of ``ranks`` on ``mesh``'s backend (the one its own groups
    use: gloo for a "cuda" mesh made with ``backend="gloo"``; a device
    type names its default backend), made once per default group: a world
    made after ``destroy_process_group`` gets its own.  The entry holds
    the default group, so its id is not reused."""
    from .mesh import backend_of

    backend = backend_of(mesh) if isinstance(mesh, str) else dist.get_backend(mesh.get_group(0))
    world = dist.group.WORLD
    key = (id(world), backend, tuple(ranks))
    if key not in _WORLD_GROUPS:
        if dist.get_backend() == backend and len(ranks) == dist.get_world_size():
            _WORLD_GROUPS[key] = (world, world)
        else:
            _WORLD_GROUPS[key] = (world, dist.new_group(ranks=list(ranks), backend=backend))
    return _WORLD_GROUPS[key][1]


def redistribute_local_tensor(locals_, src_spec: DArraySpec, dst_spec: DArraySpec, rank: int = 0):
    """``rank``'s destination piece from every rank's source piece (flat
    rank order), in one process (reference redistribute.py:260).  A single
    tensor is accepted only for a replicated source.  It runs the plan of
    the live path's all-to-all-v over every rank (``_exchange_blocks``) and
    copies each block it receives straight from its sender's piece, so its
    memory is the destination piece's size.  A Partial source, or a pair
    of ragged and partial dense pieces with no common index space, is
    assembled whole: the fallback, which warns, counts and raises under
    ``VESCALE_STRICT_REDISTRIBUTE=1`` as ``redistribute`` does."""
    if not isinstance(locals_, (list, tuple)):
        if not src_spec.is_replicated():
            raise ValueError(
                "single-local redistribute is only defined for a replicated "
                "source; pass the full per-rank list of locals"
            )
        locals_ = [locals_] * src_spec.mesh.size()
    if len(locals_) != src_spec.mesh.size():
        raise ValueError(f"need {src_spec.mesh.size()} locals, got {len(locals_)}")
    dcoord = dst_spec.mesh.coordinate_of_rank(rank)
    ref = locals_[0]
    out = torch.empty(dst_spec.local_shape(dcoord), dtype=ref.dtype, device=ref.device)
    if dst_spec.seeds_zero(dcoord):
        return out.zero_()
    n_src, n_dst = src_spec.mesh.size(), dst_spec.mesh.size()
    peers = [(k if k < n_src else None, k if k < n_dst else None) for k in range(max(n_src, n_dst))]
    recv = None
    if not src_spec.has_partial():
        try:
            blocks = _exchange_blocks(src_spec, dst_spec, peers)
            recv = [blocks(k, rank) for k in range(n_src)]
        except ValueError:  # no common index space
            pass
    if recv is None:
        _warn_fallback(src_spec, dst_spec)
        return dst_spec.local_from_full(src_spec.assemble(locals_), dcoord).clone()
    for k, (kind, bl) in enumerate(recv):
        loc = locals_[k] if kind == "dense" else locals_[k].reshape(-1)
        view = out if kind == "dense" else out.reshape(-1)
        for s, d in bl:
            view[d].copy_(loc[s])
    return out
