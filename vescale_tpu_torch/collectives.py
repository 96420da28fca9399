"""Mesh collectives over the process groups of a live ``DeviceMesh``.

The port of the mesh collectives of ``vescale_tpu/collectives.py``.  The
reference takes and returns *stacked* global arrays (dim 0 carries each
rank's operand) because one controller holds every rank's data; here each
rank passes its own operand and gets its own result, the calling
convention of the legacy veScale ``_collective_utils.py``.  So the port's
rank ``r`` computes slice ``r`` of the reference's stacked result (or the
whole result where the reference returns an unstacked one).

One code path serves NCCL ("cuda" meshes) and gloo ("cpu" meshes): the
tensors live on the mesh's device and the group's backend carries them.
Ragged and uneven pieces are padded to one chunk size, because both
backends want equal-sized buffers, and unpadded after.

``CALLS`` counts every collective issued, keyed by ``"<backend>.<op>"``,
and ``BYTES`` the bytes of each rank's operand under the same key.  With
``TIMING`` set, each collective waits for the card's queued work first
and ``SECONDS[op]`` adds its own wall time (a measurement mode: the waits
change the overlap it measures).

A backend may refuse a device's tensors for some ops.  ``HOST_ROUTE``
names those ops for each (backend, device type); their operands are
copied to the host, the op runs there and the result is copied back,
each such copy counted under ``"<backend>.<op>.host_copy"``.  The rule
is a table, fixed in advance: nothing catches a refusal and retries.  On
the card gloo carries every collective on CUDA tensors and refuses only
point-to-point sends (``mesh_ppermute``), so that is the one op the
table routes.

The quantized collectives (``q_psum``, ``q_all_gather``,
``q_psum_scatter``, ``q_all_to_all`` over a process group, and the mesh
wrappers ``all_reduce_q`` and ``reduce_scatter_q``) quantize each rank's
operand once to block-scaled int8 (``quant/blockscale.py``), move one
packed buffer, and dequantize and accumulate every rank's contribution in
fp32 in rank order, so the result is deterministic and the reference's
bit for bit.  They count under their own names (``"<backend>.q_psum"``
...), and ``COMPRESS`` keeps the wire-byte reckoning of each
(``_compress_wire_bytes``): raw against quantized bytes.

The cost model (``analytic_cost_us``, ``allgather_cost``,
``reduce_scatter_cost``, ``allreduce_cost``, ``all_to_all_cost``,
``redistribute_cost``) prices a collective in microseconds: each
``*_cost`` asks the armed calibration table first
(``telemetry.calibrate.collective_cost_us``, the table that prices a run
on the card), and falls back to the reference's ring formula over
``_LINK_GBPS``, the card's NVLink datasheet rate (a stated default, not a
measurement).  The redistribution planner, shardcheck's byte prices, the
pipeline's stage-boundary hop and the what-if scorer read it.
"""

from __future__ import annotations

import functools
import itertools
import time
import warnings
from collections import Counter
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import DeviceMesh

__all__ = [
    "BYTES",
    "CALLS",
    "SECONDS",
    "HOST_ROUTE",
    "reset_calls",
    "gather_v",
    "reduce_scatter_v",
    "mesh_all_reduce",
    "mesh_all_gather",
    "mesh_reduce_scatter",
    "mesh_all_to_all",
    "mesh_broadcast",
    "mesh_scatter",
    "mesh_ppermute",
    "COMPRESS",
    "next_sr_key",
    "q_psum",
    "q_all_gather",
    "q_psum_scatter",
    "q_all_to_all",
    "all_reduce_q",
    "reduce_scatter_q",
    "analytic_cost_us",
    "allgather_cost",
    "reduce_scatter_cost",
    "allreduce_cost",
    "all_to_all_cost",
    "redistribute_cost",
]

CALLS: Counter = Counter()
BYTES: Counter = Counter()
SECONDS: Counter = Counter()
# "<op>.raw_wire" / "<op>.q_wire": each quantized call's wire bytes a rank,
# uncompressed and quantized (``_compress_wire_bytes``)
COMPRESS: Counter = Counter()
TIMING = False

# (backend, device type) -> the ops that backend refuses on that device's
# tensors.  gloo on CUDA tensors (torch 2.11, H100): point-to-point sends
# hand the device pointer to the socket ("writev ... Bad address"); every
# collective is carried (``chip_smoke.py --gloo-probe``)
HOST_ROUTE = {("gloo", "cuda"): frozenset({"ppermute"})}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def reset_calls() -> None:
    CALLS.clear()
    BYTES.clear()
    SECONDS.clear()
    COMPRESS.clear()


def _timed(op: str):
    """Add the wrapped collective's wall time to ``SECONDS[op]`` while
    ``TIMING`` is set, the card's queued work drained before and after."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not TIMING:
                return fn(*args, **kwargs)
            cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if cuda:
                torch.cuda.synchronize()
            SECONDS[op] += time.perf_counter() - t0
            return out
        return run
    return wrap


def _count(group, op: str, t: torch.Tensor = None) -> None:
    key = f"{dist.get_backend(group)}.{op}"
    CALLS[key] += 1
    if t is not None:
        BYTES[key] += t.numel() * t.element_size()


def _via_host(group, op: str, t: torch.Tensor) -> bool:
    """Whether ``op`` on ``t`` runs on a host copy (``HOST_ROUTE``); counts
    the copy when it does."""
    backend = dist.get_backend(group)
    if op not in HOST_ROUTE.get((backend, t.device.type), ()):
        return False
    CALLS[f"{backend}.{op}.host_copy"] += 1
    return True


def _quiet(fn, *args, **kwargs):
    """Call a collective whose name newer torch marks deprecated (the
    replacement does not exist on every torch the port runs on)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kwargs)


# ------------------------------------------------------------ primitives
@_timed("all_reduce")
def all_reduce(t: torch.Tensor, group, reduce_op: str = "sum") -> torch.Tensor:
    """The reduction of every member's ``t`` (a new tensor).  ``avg`` is a
    sum divided by the group size, as ``jax.lax.pmean`` computes it."""
    out = t.contiguous().clone()
    _count(group, "all_reduce", out)
    dist.all_reduce(out, op=_OPS["sum" if reduce_op == "avg" else reduce_op], group=group)
    if reduce_op == "avg":
        out = out / dist.get_world_size(group)
    return out


@_timed("all_gather")
def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every member's ``t`` (equal shapes) concatenated along dim 0, in
    group-rank order."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    _count(group, "all_gather", t)
    _quiet(dist.all_gather_into_tensor, out, t, group=group)
    return out


@_timed("reduce_scatter")
def reduce_scatter(t: torch.Tensor, group, reduce_op: str = "sum") -> torch.Tensor:
    """Dim 0 of ``t`` cut into group-size equal chunks; this member gets
    the reduction of every member's chunk at its own group rank."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 of {tuple(t.shape)} not divisible by {n}")
    out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
    _count(group, "reduce_scatter", t)
    _quiet(dist.reduce_scatter_tensor, out, t,
           op=_OPS["sum" if reduce_op == "avg" else reduce_op], group=group)
    if reduce_op == "avg":
        out = out / n
    return out


@_timed("all_to_all")
def all_to_all_v(send: torch.Tensor, send_splits: Sequence[int], recv_splits: Sequence[int],
                 group) -> torch.Tensor:
    """A flat all-to-all with per-member split sizes (all-to-all-v):
    ``send`` is the concatenation of the pieces for each member in group
    order; the result concatenates the pieces received from each."""
    out = send.new_empty((int(sum(recv_splits)),))
    _count(group, "all_to_all", send)
    dist.all_to_all_single(out, send.contiguous(), output_split_sizes=list(recv_splits),
                           input_split_sizes=list(send_splits), group=group)
    return out


def pad_dim0(t: torch.Tensor, size: int) -> torch.Tensor:
    if t.shape[0] == size:
        return t
    pad = t.new_zeros((size - t.shape[0],) + tuple(t.shape[1:]))
    return torch.cat([t, pad])


def gather_v(t: torch.Tensor, sizes: Sequence[int], group, *, bucket: Optional[int] = None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All-gather-v along dim 0: member ``j`` holds ``sizes[j]`` rows; pad
    each to the largest, all-gather, unpad (into ``out`` when given).
    With ``bucket`` (rows over all members) the padded pieces go in
    windows, one all-gather a window, so no call moves more than a
    bucket."""
    pad = max(sizes) if sizes else 0
    n = len(sizes)
    w = pad if bucket is None else max(1, min(pad, int(bucket) // max(1, n)))
    if out is None:
        if w >= pad and all(s == pad for s in sizes):
            return all_gather(pad_dim0(t, pad), group)
        out = t.new_empty((int(sum(sizes)),) + tuple(t.shape[1:]))
    offs = [0]
    for s_ in sizes[:-1]:
        offs.append(offs[-1] + s_)
    for a in range(0, pad, max(1, w)):
        b = min(pad, a + w)
        piece = t.narrow(0, min(a, t.shape[0]), max(0, min(b, t.shape[0]) - a))
        got = all_gather(pad_dim0(piece, b - a), group)
        for j, s_ in enumerate(sizes):
            valid = max(0, min(b, s_) - a)
            if valid:
                out.narrow(0, offs[j] + a, valid).copy_(got.narrow(0, j * (b - a), valid))
    return out


def reduce_scatter_v(t: torch.Tensor, sizes: Sequence[int], group, reduce_op: str = "sum", *,
                     bucket: Optional[int] = None) -> torch.Tensor:
    """Reduce-scatter-v along dim 0: every member passes the whole ``t``
    (``sum(sizes)`` rows); member ``j`` gets rows ``[off_j, off_j +
    sizes[j])`` reduced over the group.  Each member's piece is padded to
    the largest (``reduce_scatter`` wants equal chunks), in windows of
    ``bucket`` rows over all members when given."""
    n, me = len(sizes), dist.get_rank(group)
    pad = max(sizes) if sizes else 0
    w = pad if bucket is None else max(1, min(pad, int(bucket) // max(1, n)))
    offs = [0]
    for s_ in sizes[:-1]:
        offs.append(offs[-1] + s_)
    out = t.new_empty((sizes[me],) + tuple(t.shape[1:]))
    for a in range(0, pad, max(1, w)):
        b = min(pad, a + w)
        buf = torch.cat([pad_dim0(t.narrow(0, offs[j] + min(a, s_), max(0, min(b, s_) - a)), b - a)
                         for j, s_ in enumerate(sizes)])
        red = reduce_scatter(buf, group, reduce_op)
        valid = max(0, min(b, sizes[me]) - a)
        if valid:
            out.narrow(0, a, valid).copy_(red.narrow(0, 0, valid))
    return out


# ---------------------------------------------------- mesh collectives
def mesh_all_reduce(tensor: torch.Tensor, mesh: DeviceMesh, reduce_op: str = "sum",
                    mesh_dim=0) -> torch.Tensor:
    """The reduction of every rank's ``tensor`` along ``mesh_dim``
    (_collective_utils.py:344)."""
    return all_reduce(tensor, mesh.get_group(mesh_dim), reduce_op)


def mesh_all_gather(tensor: torch.Tensor, mesh: DeviceMesh, mesh_dim=0,
                    gather_dim: int = 0) -> torch.Tensor:
    """Every rank's ``tensor`` (equal shapes) concatenated along
    ``gather_dim`` in mesh order (_collective_utils.py:315)."""
    out = all_gather(tensor.movedim(gather_dim, 0), mesh.get_group(mesh_dim))
    return out.movedim(0, gather_dim)


def mesh_reduce_scatter(tensor: torch.Tensor, mesh: DeviceMesh, reduce_op: str = "sum",
                        scatter_dim: int = 0, mesh_dim=0) -> torch.Tensor:
    """Each rank contributes a full tensor; rank ``j`` along ``mesh_dim``
    gets chunk ``j`` (of ``scatter_dim``, evenly divided) of the reduction
    (_collective_utils.py:288).  max/min reduce whole and slice, as the
    reference does."""
    g = mesh.get_group(mesh_dim)
    n = mesh.size(mesh_dim)
    if reduce_op in ("sum", "avg"):
        return reduce_scatter(tensor.movedim(scatter_dim, 0), g, reduce_op).movedim(0, scatter_dim)
    full = all_reduce(tensor, g, reduce_op)
    chunk = full.shape[scatter_dim] // n
    idx = mesh.get_coordinate()[mesh._dim_index(mesh_dim)]
    return full.narrow(scatter_dim, idx * chunk, chunk).contiguous()


def mesh_all_to_all(tensor: torch.Tensor, mesh: DeviceMesh, mesh_dim=0, split_dim: int = 0,
                    concat_dim: int = 0) -> torch.Tensor:
    """Each rank splits ``tensor`` evenly along ``split_dim``, sends chunk
    ``j`` to rank ``j`` and concatenates what it receives along
    ``concat_dim`` (_collective_utils.py:119)."""
    g = mesh.get_group(mesh_dim)
    n = mesh.size(mesh_dim)
    if tensor.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(tensor.shape)} not divisible by {n}")
    chunks = [c.contiguous().reshape(-1) for c in torch.chunk(tensor, n, dim=split_dim)]
    sizes = [c.numel() for c in chunks]
    out = all_to_all_v(torch.cat(chunks), sizes, sizes, g)
    shape = list(tensor.shape)
    shape[split_dim] //= n
    return torch.cat([p.view(shape) for p in out.split(sizes)], dim=concat_dim)


@_timed("broadcast")
def mesh_broadcast(tensor: torch.Tensor, mesh: DeviceMesh, mesh_dim=0,
                   src_rank: int = 0) -> torch.Tensor:
    """Rank ``src_rank``'s ``tensor`` (its index along ``mesh_dim``) on
    every rank of the dim (_collective_utils.py:237); the others pass a
    tensor of the same shape and dtype."""
    g = mesh.get_group(mesh_dim)
    out = tensor.contiguous().clone()
    _count(g, "broadcast", out)
    dist.broadcast(out, src=dist.get_global_rank(g, src_rank), group=g)
    return out


def _split_sizes(extent: int, n: int) -> List[int]:
    """``numpy.array_split``'s chunk sizes (the first ones one larger)."""
    q, r = divmod(extent, n)
    return [q + 1 if j < r else q for j in range(n)]


@_timed("scatter")
def mesh_scatter(tensor: torch.Tensor, mesh: DeviceMesh, mesh_dim=0, scatter_dim: int = 0,
                 src_rank: int = 0) -> torch.Tensor:
    """Rank ``src_rank``'s ``tensor`` cut along ``scatter_dim`` as
    ``numpy.array_split`` cuts it; rank ``j`` gets chunk ``j``
    (_collective_utils.py:50).  Every rank passes a tensor of the full
    shape; only the source's values are read."""
    g = mesh.get_group(mesh_dim)
    n = mesh.size(mesh_dim)
    sizes = _split_sizes(tensor.shape[scatter_dim], n)
    pad = max(sizes)
    moved = tensor.movedim(scatter_dim, 0)
    me = mesh.get_coordinate()[mesh._dim_index(mesh_dim)]
    out = moved.new_empty((pad,) + tuple(moved.shape[1:]))
    src = dist.get_global_rank(g, src_rank)
    pieces = None
    if me == src_rank:
        pieces = [pad_dim0(p, pad).contiguous() for p in torch.split(moved, sizes)]
    _count(g, "scatter", out)
    dist.scatter(out, scatter_list=pieces, src=src, group=g)
    return out.narrow(0, 0, sizes[me]).movedim(0, scatter_dim).contiguous()


@_timed("ppermute")
def mesh_ppermute(tensor: torch.Tensor, mesh: DeviceMesh, mesh_dim=0, shift: int = 1) -> torch.Tensor:
    """Rank ``j`` sends ``tensor`` to rank ``j + shift`` (mod the dim size)
    and returns what rank ``j - shift`` sent: the ring permute of pipeline
    p2p (``batch_isend_irecv``)."""
    g = mesh.get_group(mesh_dim)
    n = mesh.size(mesh_dim)
    me = mesh.get_coordinate()[mesh._dim_index(mesh_dim)]
    send = tensor.contiguous()
    out = torch.empty_like(send)
    if shift % n == 0:
        return send.clone()
    _count(g, "ppermute", send)
    host = _via_host(g, "ppermute", send)
    s_buf, r_buf = (send.cpu(), out.cpu()) if host else (send, out)
    ops = [dist.P2POp(dist.isend, s_buf, dist.get_global_rank(g, (me + shift) % n), g),
           dist.P2POp(dist.irecv, r_buf, dist.get_global_rank(g, (me - shift) % n), g)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out.copy_(r_buf) if host else out


# ------------------------------------------------- quantized collectives
# Block-scaled int8 collectives (EQuARX, arXiv:2506.17615): quantize each
# rank's contribution once, move one packed int8 buffer, accumulate the
# dequantized contributions in fp32 in fixed rank order.  Reductions move
# int8 payloads and pure data movement uint8, the reference's wire-dtype
# convention.
_SR_CALLS = itertools.count()
_WARNED_COUNTERPRODUCTIVE: set = set()


def _rank_key(key, index: int, rounding: str):
    """This rank's stochastic-rounding key: its position ``index`` on the
    mesh dim folded into ``key``."""
    if rounding != "stochastic":
        return None
    from .random import fold_in

    return fold_in(key, index)


def next_sr_key():
    """A fresh stochastic-rounding key for one eager quantized reduction:
    ``fold_in(key(VESCALE_GRAD_COMPRESS_SEED), call_index)``, a pure
    function of (seed, call order)."""
    from . import config
    from .random import fold_in, key

    return fold_in(key(config.get_int("VESCALE_GRAD_COMPRESS_SEED") or 0), next(_SR_CALLS))


def _compress_settings(block, rounding):
    """Explicit arguments win, else the ``VESCALE_GRAD_COMPRESS_*`` knobs."""
    from . import config
    from .quant import blockscale

    if block is None:
        block = config.get_int("VESCALE_GRAD_COMPRESS_BLOCK") or blockscale.DEFAULT_BLOCK
    if rounding is None:
        rounding = "stochastic" if config.get_bool("VESCALE_GRAD_COMPRESS_SR") else "nearest"
    return int(block), rounding


def _compress_defaults(block, rounding, key):
    """``_compress_settings`` plus a fresh ``next_sr_key`` for a
    stochastic call without a key."""
    block, rounding = _compress_settings(block, rounding)
    if rounding == "stochastic" and key is None:
        key = next_sr_key()
    return block, rounding, key


def _check_op(reduce_op: str) -> None:
    if reduce_op not in ("sum", "avg"):
        raise ValueError(f"quantized reduction supports sum/avg, got {reduce_op!r}")


def _payload(x: torch.Tensor, block: int, rounding: str, key):
    from .quant import blockscale

    qb = blockscale.quantize_int8_blocks(x, block, rounding, key)
    return blockscale.pack_int8_payload(qb), qb.q.shape[0]


def _gather_payload(payload: torch.Tensor, group, op: str) -> torch.Tensor:
    """Every member's payload, (n, P), in group order; counted as ``op``."""
    n = dist.get_world_size(group)
    out = payload.new_empty((n * payload.numel(),))
    _count(group, op, payload)
    _quiet(dist.all_gather_into_tensor, out, payload.contiguous(), group=group)
    return out.view(n, -1)


def _exchange_payloads(payloads: torch.Tensor, group, op: str) -> torch.Tensor:
    """(n, P) -> (n, P): row ``j`` goes to member ``j``; row ``r`` of the
    result came from member ``r``.  Counted as ``op``."""
    out = torch.empty_like(payloads)
    _count(group, op, payloads)
    dist.all_to_all_single(out, payloads.contiguous(), group=group)
    return out


def _accumulate(rows, n_blocks: int, block: int, acc_dtype, reduce_op: str, n: int):
    """The dequantized rows summed in ``acc_dtype`` in rank order (the
    multiply is exact: power-of-two scales)."""
    from .quant import blockscale

    acc = None
    for r in range(n):
        qr = blockscale.unpack_int8_payload(rows[r], n_blocks, block)
        d = qr.q.to(acc_dtype) * qr.scales.to(acc_dtype)[:, None]
        acc = d if acc is None else acc + d
    return acc / n if reduce_op == "avg" else acc


@_timed("q_psum")
def q_psum(x: torch.Tensor, group, *, block: int, rounding: str = "nearest", key=None,
           acc_dtype=torch.float32, reduce_op: str = "sum") -> torch.Tensor:
    """Quantized all-reduce over ``group``: quantize, all-gather one packed
    int8 buffer, dequantize and accumulate every member's in rank order."""
    _check_op(reduce_op)
    n, me = dist.get_world_size(group), dist.get_rank(group)
    payload, nb = _payload(x, block, rounding, _rank_key(key, me, rounding))
    rows = _gather_payload(payload, group, "q_psum")
    acc = _accumulate(rows, nb, block, acc_dtype, reduce_op, n)
    return acc.reshape(-1)[: x.numel()].reshape(x.shape).to(x.dtype)


@_timed("q_all_gather")
def q_all_gather(x: torch.Tensor, group, *, axis: int, extent: int, block: int,
                 rounding: str = "nearest", key=None, acc_dtype=torch.float32) -> torch.Tensor:
    """Quantized all-gather along ``axis``: every member's chunk (this
    one's too) round-trips through int8, concatenated in rank order and
    trimmed to ``extent``."""
    from .quant import blockscale

    n, me = dist.get_world_size(group), dist.get_rank(group)
    payload, nb = _payload(x, block, rounding, _rank_key(key, me, rounding))
    rows = _gather_payload(payload.view(torch.uint8), group, "q_all_gather")
    parts = [blockscale.dequantize_int8_blocks(
        blockscale.unpack_int8_payload(rows[r].view(torch.int8), nb, block), x.shape, x.dtype,
        acc_dtype) for r in range(n)]
    out = torch.cat(parts, dim=axis)
    return out.narrow(axis, 0, extent) if out.shape[axis] != extent else out


def _chunk_payloads(x: torch.Tensor, n: int, dim: int, me: int, block: int, rounding: str, key,
                    name: str):
    if x.shape[dim] % n:
        raise ValueError(f"{name}: dim {dim} extent {x.shape[dim]} not divisible by {n} "
                         "(pad first)")
    chunks = torch.chunk(x, n, dim=dim)
    key0 = _rank_key(key, me, rounding)
    from .random import fold_in

    out, nb = [], None
    for c, chunk in enumerate(chunks):
        p, nb = _payload(chunk, block, rounding, None if key0 is None else fold_in(key0, c))
        out.append(p)
    return chunks[0].shape, torch.stack(out), nb


@_timed("q_psum_scatter")
def q_psum_scatter(x: torch.Tensor, group, *, scatter_dim: int, block: int,
                   rounding: str = "nearest", key=None, acc_dtype=torch.float32,
                   reduce_op: str = "sum") -> torch.Tensor:
    """Quantized reduce-scatter: ``x`` cut into group-size chunks along
    ``scatter_dim`` (divisible), each quantized on its own; one all-to-all
    of the packed chunks; this member accumulates the chunks it received in
    rank order."""
    _check_op(reduce_op)
    n, me = dist.get_world_size(group), dist.get_rank(group)
    cshape, stack, nb = _chunk_payloads(x, n, scatter_dim, me, block, rounding, key,
                                        "q_psum_scatter")
    recv = _exchange_payloads(stack, group, "q_psum_scatter")
    acc = _accumulate(recv, nb, block, acc_dtype, reduce_op, n)
    csize = 1
    for s in cshape:
        csize *= int(s)
    return acc.reshape(-1)[:csize].reshape(cshape).to(x.dtype)


@_timed("q_all_to_all")
def q_all_to_all(x: torch.Tensor, group, *, split_axis: int, concat_axis: int, block: int,
                 rounding: str = "nearest", key=None, acc_dtype=torch.float32) -> torch.Tensor:
    """Quantized all-to-all: split along ``split_axis`` (divisible), move
    packed uint8 chunks, concatenate what arrives along ``concat_axis`` in
    rank order."""
    from .quant import blockscale

    n, me = dist.get_world_size(group), dist.get_rank(group)
    cshape, stack, nb = _chunk_payloads(x, n, split_axis, me, block, rounding, key,
                                        "q_all_to_all")
    recv = _exchange_payloads(stack.view(torch.uint8), group, "q_all_to_all")
    parts = [blockscale.dequantize_int8_blocks(
        blockscale.unpack_int8_payload(recv[r].view(torch.int8), nb, block), cshape, x.dtype,
        acc_dtype) for r in range(n)]
    return torch.cat(parts, dim=concat_axis)


def _compress_wire_bytes(n_elements: int, itemsize: int, block: int, op: str, n: int):
    """(raw, quantized) wire bytes a rank of one collective: the quantized
    all-reduce gathers (n-1) packed contributions against the ring's
    2(n-1)/n raw, so at large n it moves more; the reduce-scatter is an
    all-to-all of packed chunks against the ring's (n-1)/n raw."""
    from .quant import blockscale

    raw = n_elements * itemsize
    packed = blockscale.packed_nbytes(n_elements, block)
    f = (n - 1) / max(1, n)
    if op == "all_reduce":
        return 2.0 * f * raw, float((n - 1) * packed)
    return f * raw, f * packed


def _compress_telemetry(n_elements: int, itemsize: int, block: int, op: str, n: int) -> None:
    """Add one quantized call's wire bytes to ``COMPRESS`` and the
    ``grad_compress_*`` counters of ``telemetry.registry.GLOBAL``; warn
    once per (op, n) where quantizing moves no fewer bytes."""
    from .telemetry.registry import GLOBAL

    GLOBAL.count("grad_compress_collectives_total")
    GLOBAL.count(f"grad_compress_{op}_total")
    COMPRESS[f"{op}.calls"] += 1
    if n <= 1:
        return
    raw_wire, q_wire = _compress_wire_bytes(n_elements, itemsize, block, op, n)
    COMPRESS[f"{op}.raw_wire"] += raw_wire
    COMPRESS[f"{op}.q_wire"] += q_wire
    GLOBAL.count("grad_compress_bytes_saved_total", max(0.0, raw_wire - q_wire))
    if q_wire >= raw_wire and (op, n) not in _WARNED_COUNTERPRODUCTIVE:
        _WARNED_COUNTERPRODUCTIVE.add((op, n))
        warnings.warn(
            f"grad_compress='int8' {op} over a mesh dim of {n} moves ~{int(q_wire)} bytes on "
            f"the wire vs ~{int(raw_wire)} uncompressed (the gather-based quantized all-reduce "
            "is O(n) in wire bytes): prefer the ZeRO reduce-scatter path or disable "
            "VESCALE_GRAD_COMPRESS", stacklevel=3)


def all_reduce_q(tensor: torch.Tensor, mesh: DeviceMesh, reduce_op: str = "sum", mesh_dim=0, *,
                 block: Optional[int] = None, rounding: Optional[str] = None, key=None,
                 acc_dtype=torch.float32) -> torch.Tensor:
    """Block-scaled int8 all-reduce of every rank's ``tensor`` along
    ``mesh_dim``: the quantized ``mesh_all_reduce``; the knobs default
    from ``VESCALE_GRAD_COMPRESS_*``."""
    block, rounding, key = _compress_defaults(block, rounding, key)
    out = q_psum(tensor, mesh.get_group(mesh_dim), block=block, rounding=rounding, key=key,
                 acc_dtype=acc_dtype, reduce_op=reduce_op)
    _compress_telemetry(tensor.numel(), tensor.element_size(), block, "all_reduce",
                        mesh.size(mesh_dim))
    return out


def reduce_scatter_q(tensor: torch.Tensor, mesh: DeviceMesh, reduce_op: str = "sum",
                     scatter_dim: int = 0, mesh_dim=0, *, block: Optional[int] = None,
                     rounding: Optional[str] = None, key=None,
                     acc_dtype=torch.float32) -> torch.Tensor:
    """Block-scaled int8 reduce-scatter: each rank contributes a full
    ``tensor``; rank ``j`` along ``mesh_dim`` gets chunk ``j`` (of
    ``scatter_dim``, evenly divided) of the reduction."""
    block, rounding, key = _compress_defaults(block, rounding, key)
    out = q_psum_scatter(tensor, mesh.get_group(mesh_dim), scatter_dim=scatter_dim, block=block,
                         rounding=rounding, key=key, acc_dtype=acc_dtype, reduce_op=reduce_op)
    _compress_telemetry(tensor.numel(), tensor.element_size(), block, "reduce_scatter",
                        mesh.size(mesh_dim))
    return out


# ------------------------------------------------------------- cost model
# The reference's bandwidth-factor model (legacy veScale
# _collective_utils.py:406-475): microseconds for ``bytes_gb`` gigabytes
# over a mesh dim of ``n`` ranks.  The link rate is the H100 SXM
# datasheet's NVLink 4 figure, 900 GB/s bidirectional, so 450 GB/s each
# way: a stated default, not a measurement.  A calibration table measured
# on the run's own mesh (telemetry/calibrate.py) is what prices a run on
# the card; the formula answers only for buckets the table lacks.
_LINK_GBPS = 450.0
_LAUNCH_US = 1.0  # per-op overhead, the reference's constant


def _ring_cost(bytes_gb: float, n: int, steps_factor: float) -> float:
    if n <= 1:
        return 0.0
    return _LAUNCH_US + (bytes_gb * steps_factor * (n - 1) / n) / _LINK_GBPS * 1e6


def _measured_us(op: str, num_devices: int, bytes_gb: float):
    from .telemetry import calibrate as _cal

    return _cal.collective_cost_us(op, num_devices, bytes_gb * 1e9)


_FACTORS = {"all_gather": 1.0, "reduce_scatter": 1.0, "all_to_all": 1.0, "all_reduce": 2.0,
            "ppermute": 1.0}


def analytic_cost_us(op: str, bytes_gb: float, num_devices: int) -> float:
    """The ring formula alone (never the calibration table): the planner's
    price for an op whose bucket the table lacks, so one search never mixes
    bytes and microseconds."""
    return _ring_cost(bytes_gb, num_devices, _FACTORS[op])


def _cost(op: str, bytes_gb: float, num_devices: int) -> float:
    us = _measured_us(op, num_devices, bytes_gb)
    return us if us is not None else analytic_cost_us(op, bytes_gb, num_devices)


def allgather_cost(bytes_gb: float, num_devices: int) -> float:
    return _cost("all_gather", bytes_gb, num_devices)


def reduce_scatter_cost(bytes_gb: float, num_devices: int) -> float:
    return _cost("reduce_scatter", bytes_gb, num_devices)


def allreduce_cost(bytes_gb: float, num_devices: int) -> float:
    return _cost("all_reduce", bytes_gb, num_devices)


def all_to_all_cost(bytes_gb: float, num_devices: int) -> float:
    return _cost("all_to_all", bytes_gb, num_devices)


def redistribute_cost(src_spec, dst_spec) -> float:
    """Estimated microseconds of ``redistribute(src -> dst)`` (the
    reference's ``redistribute_cost``, _collective_utils.py:453), one term
    per mesh dim that changes; a cross-mesh pair is infinite."""
    if src_spec.mesh != dst_spec.mesh:
        return float("inf")
    gb = src_spec.logical_bytes() / 1e9
    cost = 0.0
    for i, (s, d) in enumerate(zip(src_spec.placements, dst_spec.placements)):
        n = src_spec.mesh.shape[i]
        if s == d:
            continue
        if s.is_partial() and d.is_replicate():
            cost += allreduce_cost(gb, n)
        elif s.is_partial() and d.is_shard():
            cost += reduce_scatter_cost(gb, n)
        elif (s.is_shard() or s.is_ragged_shard()) and d.is_replicate():
            cost += allgather_cost(gb / n, n)
        elif s.is_shard() and d.is_shard():
            cost += all_to_all_cost(gb / n, n)
        elif s.is_replicate() and (d.is_shard() or d.is_ragged_shard()):
            cost += 0.0  # a local slice
        else:
            cost += allreduce_cost(gb, n)
    return cost
