"""Per-shard transitions: the edges the redistribution planner composes.

The port of the part of ``vescale_tpu/transfer.py`` that
``redistribute_plan.py`` needs.  The reference compiles one ``shard_map``
program per kind of single-hop transition (dense, ragged, interleaved);
the port already moves pieces hop by hop (``redistribute``'s primitives
``_gather``, ``_exchange_dim`` (an all-to-all-v), ``_reduce``, ``_slice``,
``_seed``), so its transition functions are views over those:

  * ``transition_fn``: the pairs the reference's static plan
    (``_plan_ops``) accepts, its ops (reduces, gathers, topo-sorted moves,
    reduce-scatters and slices, seeds) run in its order by the port's
    primitives.  The port's own one-pass ``plan`` refuses a few of these
    (a move followed by a slice of the moved-from dim on an outer mesh
    dim), so the reference's order is kept here;
  * ``ragged_transition_fn`` / ``interleaved_transition_fn``: the pairs
    the reference's ragged and interleaved scopes accept, run by the
    port's ``plan`` (which serves each of them in one pass).

The reference's rules decide the edge set, so the planner searches the
reference's graph and, in byte-weight mode, chooses the reference's hops
and intermediate specs.  Each function is ``fn(darray) -> darray`` on this
rank's piece.

``quant_plan_info`` and ``quant_transition_fn`` are the int8 variant:
every wire op of ``_plan_ops``'s static plan moves one block-scaled int8
payload (``collectives.q_psum`` / ``q_psum_scatter`` / ``q_all_gather`` /
``q_all_to_all``) while slices and seeds stay exact.  The ops run on this
rank's piece padded to the reference's physical shard (each sharded dim to
its chunk), so the quantization blocks, and with them the result, are the
reference's; a one-op Partial -> Replicate is bitwise
``collectives.all_reduce_q``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch

from .placements import InterleavedShard, Partial, Replicate, Shard
from .spec import DArraySpec

__all__ = [
    "transition_fn",
    "ragged_transition_fn",
    "interleaved_transition_fn",
    "quant_plan_info",
    "quant_transition_fn",
]


# ---------------------------------------------------------- feasibility
def _single_shard_map(spec: DArraySpec) -> Optional[Dict[int, int]]:
    """{tensor_dim: mesh_dim} when every Shard-ed tensor axis has exactly
    one mesh dim; None for nested sharding."""
    m: Dict[int, int] = {}
    for i, p in enumerate(spec.placements):
        if type(p) is Shard:
            if p.dim in m:
                return None
            m[p.dim] = i
    return m


def _plan_ops(src: DArraySpec, dst: DArraySpec) -> Optional[List[Tuple]]:
    """The reference's static dense plan (reduces, gathers, topo-sorted
    moves, reduce-scatters and slices, seeds), or None."""
    if src.mesh != dst.mesh:
        return None
    for s in (src, dst):
        if s.has_ragged() or s.layout().interleaves:
            return None
    smap, dmap = _single_shard_map(src), _single_shard_map(dst)
    if smap is None or dmap is None:
        return None

    reduces: List[Tuple] = []
    gathers: List[Tuple] = []
    moves: List[Tuple] = []
    finals: List[Tuple] = []  # reduce_scatter / slice
    seeds: List[Tuple] = []
    changed_axes: set = set()

    for i in range(src.mesh.ndim):
        sp, dp = src.placements[i], dst.placements[i]
        if sp == dp:
            continue
        if isinstance(sp, Partial):
            if isinstance(dp, Replicate):
                reduces.append(("reduce", i, sp.reduce_op))
            elif type(dp) is Shard:
                finals.append(("reduce_scatter", i, sp.reduce_op, dp.dim))
                changed_axes.add(dp.dim)
            else:
                return None  # Partial -> Partial with another op
        elif type(sp) is Shard:
            if isinstance(dp, Replicate):
                gathers.append(("gather", i, sp.dim))
                changed_axes.add(sp.dim)
            elif type(dp) is Shard:
                moves.append(("move", i, sp.dim, dp.dim))
                changed_axes.update((sp.dim, dp.dim))
            else:
                return None  # Shard -> Partial has no meaning
        elif isinstance(sp, Replicate):
            if type(dp) is Shard:
                finals.append(("slice", i, dp.dim))
                changed_axes.add(dp.dim)
            elif isinstance(dp, Partial):
                seeds.append(("seed", i, dp.reduce_op))
            else:
                return None
        else:
            return None

    # an axis keeping its mesh dim must not change extent through another op
    for d, i in smap.items():
        if dmap.get(d) == i and d in changed_axes:
            return None

    ordered_moves: List[Tuple] = []
    pending = list(moves)
    while pending:
        progress = False
        for mv in list(pending):
            _, _i, d, d2 = mv
            if not any(o is not mv and o[2] == d2 for o in pending):
                ordered_moves.append(mv)
                pending.remove(mv)
                progress = True
        if not progress:
            return None  # an axis-swap cycle
    return reduces + gathers + ordered_moves + finals + seeds


def _port_serves(src: DArraySpec, dst: DArraySpec) -> bool:
    """The port's hop engine moves ``src`` to ``dst`` without a gather and
    a slice on one mesh dim (no pass through Replicate)."""
    from .redistribute import plan

    try:
        _hops, fallback = plan(src.placements, dst.placements, src.ndim)
    except (AssertionError, ValueError):
        return False
    return not fallback


def _run_hops(src: DArraySpec, dst: DArraySpec):
    """``fn(darray) -> darray``: the port's hops from ``src`` to ``dst``
    on this rank's piece."""
    from .darray import DArray
    from .redistribute import _HOPS, _State, plan

    hops, _ = plan(src.placements, dst.placements, src.ndim)

    def fn(d):
        st = _State(src, d.to_local(), d.coordinate)
        for kind, i, arg in hops:
            _HOPS[kind](st, i, arg)
        return DArray(st.local, dst, d.rank)

    return fn


def _run_ops(src: DArraySpec, dst: DArraySpec, ops):
    """``fn(darray) -> darray``: ``_plan_ops``'s ops in their order, by the
    port's hop primitives (a max/min Partial reduced, then sliced, as the
    reference's reduce-then-slice does)."""
    from .darray import DArray
    from .redistribute import _State, _exchange_dim, _gather, _reduce, _seed, _slice

    def fn(d):
        st = _State(src, d.to_local(), d.coordinate)
        for op in ops:
            kind, i = op[0], op[1]
            if kind == "reduce":
                _reduce(st, i, Replicate())
            elif kind == "reduce_scatter":
                if op[2] in ("sum", "avg"):
                    _reduce(st, i, Shard(op[3]))
                else:
                    _reduce(st, i, Replicate())
                    _slice(st, i, Shard(op[3]))
            elif kind == "gather":
                _gather(st, i)
            elif kind == "move":
                _exchange_dim(st, i, Shard(op[3]))
            elif kind == "slice":
                _slice(st, i, Shard(op[2]))
            else:  # seed
                _seed(st, i, dst.placements[i])
        return DArray(st.local, dst, d.rank)

    return fn


@functools.lru_cache(maxsize=256)
def transition_fn(src: DArraySpec, dst: DArraySpec):
    """The dense single hop ``src -> dst`` (reference scope:
    ``_plan_ops``), or None."""
    ops = _plan_ops(src, dst)
    return None if ops is None else _run_ops(src, dst, ops)


def _ragged_scope(src: DArraySpec, dst: DArraySpec) -> bool:
    """The reference's ragged kernels: ragged -> Replicate (all-gather-v),
    Replicate -> ragged (slice-v), ragged -> ragged on the same mesh dim
    with compatible inner shards (all-to-all-v)."""
    if src.mesh != dst.mesh or src.shape != dst.shape:
        return False
    sr, dr = src.layout().ragged, dst.layout().ragged
    if sr is not None and dst.is_replicated():
        return True
    if src.is_replicated() and dr is not None:
        return True
    if sr is None or dr is None or sr[0] != dr[0]:
        return False
    si, di = src.layout().ragged_inner_shard, dst.layout().ragged_inner_shard
    return si is None or di is None or si == di


@functools.lru_cache(maxsize=256)
def ragged_transition_fn(src: DArraySpec, dst: DArraySpec):
    """The ragged single hop ``src -> dst``, or None."""
    if not _ragged_scope(src, dst) or not _port_serves(src, dst):
        return None
    return _run_hops(src, dst)


def _interleaved_scope(src: DArraySpec, dst: DArraySpec) -> bool:
    """The reference's interleaved piece exchange: one mesh dim differs,
    both sides place the same tensor dim there by Shard / InterleavedShard
    / Replicate with at least one interleave, that dim belongs to that mesh
    dim alone, and every extent divides evenly."""
    if src.mesh != dst.mesh or src.shape != dst.shape:
        return False
    if src.has_ragged() or dst.has_ragged():
        return False
    if not (src.layout().interleaves or dst.layout().interleaves):
        return False
    mesh = src.mesh
    diff = [i for i in range(mesh.ndim) if src.placements[i] != dst.placements[i]]
    if len(diff) != 1:
        return False
    i = diff[0]
    sp, dp = src.placements[i], dst.placements[i]
    ok = (Shard, InterleavedShard, Replicate)
    if not (isinstance(sp, ok) and isinstance(dp, ok)):
        return False
    if not (isinstance(sp, InterleavedShard) or isinstance(dp, InterleavedShard)):
        return False
    dims = {p.dim for p in (sp, dp) if not isinstance(p, Replicate)}
    if len(dims) != 1:
        return False
    d = dims.pop()
    for spec in (src, dst):
        for j, p in enumerate(spec.placements):
            if j != i and isinstance(p, (Shard, InterleavedShard)) and p.dim == d:
                return False
    n, L = mesh.shape[i], src.shape[d]
    for p in (sp, dp):
        if isinstance(p, InterleavedShard) and L % (p.interleaved_size * n) != 0:
            return False
        if type(p) is Shard and L % n != 0:
            return False
    return True


@functools.lru_cache(maxsize=256)
def interleaved_transition_fn(src: DArraySpec, dst: DArraySpec):
    """The interleaved single hop ``src -> dst``, or None."""
    if not _interleaved_scope(src, dst) or not _port_serves(src, dst):
        return None
    return _run_hops(src, dst)


# ------------------------------------------------- the int8 transition
_Q_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_Q_WIRE = {"reduce", "reduce_scatter", "gather", "move"}


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def quant_plan_info(src: DArraySpec, dst: DArraySpec, block: int = 64):
    """Feasibility and byte accounting of the int8 transition (the
    reference's, term for term): ``(ops, collectives, q_bytes, raw_bytes,
    compute_bytes, wire_detail)`` or None.  ``collectives`` maps the tagged
    logical ops (``all_reduce:int8`` ...) to counts; ``q_bytes`` is the
    packed wire estimate a device, ``raw_bytes`` what the unquantized ops
    would move, ``compute_bytes`` the bytes the quantize and dequantize
    passes touch, and ``wire_detail`` one ``(tag, q_bytes, mesh-dim size,
    packed payload)`` a wire op."""
    from .quant.blockscale import packed_nbytes
    from .redistribute_plan import physical_shard_bytes

    if src.dtype not in _Q_DTYPES:
        return None
    ops = _plan_ops(src, dst)
    if ops is None:
        return None
    wire = [op for op in ops if op[0] in _Q_WIRE]
    if not wire:
        return None
    itemsize = _itemsize(src.dtype)
    sb, db = physical_shard_bytes(src), physical_shard_bytes(dst)
    colls: Dict[str, int] = {}
    q_bytes = raw_bytes = compute_bytes = 0.0
    wire_detail: List[Tuple[str, int, int, int]] = []
    for op in wire:
        kind, i = op[0], op[1]
        n = src.mesh.shape[i]
        f = (n - 1) / max(1, n)
        if kind == "reduce":
            if op[2] not in ("sum", "avg"):
                return None
            payload = packed_nbytes(int(sb // itemsize), block)
            q, r, c = f * n * payload, 2 * f * sb, "all_reduce:int8"
            comp = (1 + n) * sb
        elif kind == "reduce_scatter":
            if op[2] not in ("sum", "avg"):
                return None
            payload = packed_nbytes(int(sb // itemsize), block)
            q, r, c = f * payload, f * sb, "reduce_scatter:int8"
            comp = 2 * sb
        elif kind == "gather":
            elems = db // itemsize
            payload = packed_nbytes(int(elems) // max(1, n), block)
            q, r, c = f * packed_nbytes(int(elems), block), f * db, "all_gather:int8"
            comp = db // max(1, n) + db
        else:  # move
            payload = packed_nbytes(int(max(sb, db) // itemsize), block)
            q, r, c = f * payload, f * max(sb, db), "all_to_all:int8"
            comp = 2 * max(sb, db)
        colls[c] = colls.get(c, 0) + 1
        q_bytes += q
        raw_bytes += r
        compute_bytes += comp
        wire_detail.append((c, int(q), int(n), int(payload)))
    return ops, colls, int(q_bytes), int(raw_bytes), int(compute_bytes), wire_detail


def _chunk_of(spec: DArraySpec, d: int) -> int:
    """Per-rank slot of tensor dim ``d`` (one mesh dim shards it at most)."""
    from .spec import innermost_chunk

    dims = spec.layout().dim_mesh_dims[d]
    return innermost_chunk(spec.shape[d], [spec.mesh.shape[i] for i in dims]) if dims \
        else spec.shape[d]


def _pad_to(x: torch.Tensor, d: int, size: int) -> torch.Tensor:
    if x.shape[d] == size:
        return x
    if x.shape[d] > size:
        return x.narrow(d, 0, size)
    pad = list(x.shape)
    pad[d] = size - x.shape[d]
    return torch.cat([x, x.new_zeros(pad)], dim=d)


@functools.lru_cache(maxsize=128)
def quant_transition_fn(src: DArraySpec, dst: DArraySpec, block: int = 64,
                        rounding: str = "nearest"):
    """``fn(darray, key=None) -> darray``: ``src -> dst`` with every wire op
    of the static plan quantized to block-scaled int8, or None when
    ``quant_plan_info`` has no plan.  ``key`` (stochastic rounding) is a
    runtime argument; wire op ``j`` uses ``fold_in(key, j)``, as the
    reference folds its op ordinal in."""
    from . import collectives as C
    from .darray import DArray
    from .random import fold_in

    info = quant_plan_info(src, dst, block)
    if info is None:
        return None
    ops = info[0]
    mesh = src.mesh
    ext = dict(enumerate(src.shape))
    phys_src = [_chunk_of(src, d) for d in range(src.ndim)]

    def fn(d, key=None):
        x = d.to_local()
        for t, size in enumerate(phys_src):  # the reference's physical shard
            x = _pad_to(x, t, size)
        coord = d.coordinate
        for j, op in enumerate(ops):
            kind = op[0]
            k = None if key is None else fold_in(key, j)
            qkw = dict(block=block, rounding=rounding, key=k)
            if kind == "reduce":
                _, i, rop = op
                x = C.q_psum(x, mesh.get_group(i), reduce_op=rop, **qkw)
            elif kind == "reduce_scatter":
                _, i, rop, t = op
                n = mesh.shape[i]
                x = _pad_to(x, t, _chunk_of(dst, t) * n)
                x = C.q_psum_scatter(x, mesh.get_group(i), scatter_dim=t, reduce_op=rop, **qkw)
            elif kind == "gather":
                _, i, t = op
                x = C.q_all_gather(x, mesh.get_group(i), axis=t, extent=ext[t], **qkw)
            elif kind == "move":
                _, i, t, t2 = op
                n = mesh.shape[i]
                x = _pad_to(x, t2, _chunk_of(dst, t2) * n)
                x = C.q_all_to_all(x, mesh.get_group(i), split_axis=t2, concat_axis=t, **qkw)
                x = _pad_to(x, t, ext[t])
            elif kind == "slice":
                _, i, t = op
                n, chunk = mesh.shape[i], _chunk_of(dst, t)
                x = _pad_to(x, t, chunk * n).narrow(t, coord[i] * chunk, chunk)
            elif kind == "seed":
                _, i, rop = op
                if rop == "sum" and coord[i] != 0:
                    x = torch.zeros_like(x)
        local = dst.local_shape(coord)
        for t, size in enumerate(local):  # unpad to this rank's piece
            x = x.narrow(t, 0, size)
        return DArray(x.contiguous(), dst, d.rank)

    return fn
