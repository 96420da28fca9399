"""Emulator quantized mode — bitwise replay of the int8 gradient collectives.

The port of ``vescale_tpu/emulator/quantized.py``.
``collectives.all_reduce_q`` / ``reduce_scatter_q`` quantize each rank's
contribution ONCE (block-scaled int8, quant/blockscale.py), move one packed
buffer, and dequantize-accumulate in fixed rank order.  This module replays
that exact schedule on ONE host so the divergence introduced by
quantization can be isolated and reproduced bit-for-bit (the same role
``Emulator.ring_all_reduce`` plays for reduction-order divergence).

Why the replay matches bitwise: quantize/dequantize are elementwise IEEE
ops (mul, clip, round-half-to-even, cast) plus a per-block max, the scales
are powers of two, and the accumulation is an explicit rank-ordered chain
of fp32 adds on both sides.  The replay calls the SAME quantizer the
collectives call (the port's ``quant.blockscale.quantize_int8_blocks``, on
the host), so a change to the quantizer cannot split the two paths.
Stochastic rounding replays too — the rank key is ``fold_in(key, rank)``
exactly as ``collectives._rank_key`` folds the rank's index — but ONLY when
the collective side was given ``key=random.key(seed)`` explicitly: the
eager wrappers' default SR keys fold in a process-wide call counter
(``collectives.next_sr_key``) that this replay cannot reconstruct.  The
bit-for-bit guarantee rests on the deterministic "nearest" path.

Note on "ring": like EQuARX's one-shot variant, the quantized schedule
exchanges ONCE and accumulates locally instead of requantizing at every
ring hop — requantization per hop would compound error with world size.
The per-bucket error report still buckets by ring chunk so it lines up
with the unquantized ring replay's accounting.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


__all__ = [
    "quantized_all_reduce",
    "quantized_reduce_scatter",
    "quantized_ring_report",
]


def _key(seed: Optional[int], *path: int):
    from .. import random as _random

    k = _random.key(0 if seed is None else seed)
    for d in path:
        k = _random.fold_in(k, d)
    return k


def _quantize(x: np.ndarray, block: int, rounding: str, key):
    """One contribution through the port's own quantizer, on the host."""
    import torch

    from ..quant import blockscale

    qb = blockscale.quantize_int8_blocks(torch.from_numpy(np.ascontiguousarray(x)), block,
                                         rounding, key)
    return qb.q.numpy(), qb.scales.numpy()


def _quantize_rank(x: np.ndarray, block: int, rounding: str, seed: Optional[int], rank: int):
    """Quantize one rank's contribution as that rank does inside
    ``q_psum`` (its key ``fold_in(key(seed), rank)`` when stochastic)."""
    return _quantize(x, block, rounding, _key(seed, rank) if rounding == "stochastic" else None)


def _rank_contribution(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    # mirrors q_psum's `q.astype(f32) * scales[:, None]` dequantize
    return q.astype(np.float32) * scales.astype(np.float32)[:, None]


def quantized_all_reduce(
    tensors: List[np.ndarray],
    block: int = 64,
    rounding: str = "nearest",
    seed: Optional[int] = None,
    reduce_op: str = "sum",
) -> List[np.ndarray]:
    """Replay of ``all_reduce_q``: every rank gets the identical
    quantize-once → gather → rank-ordered fp32 accumulation result."""
    if reduce_op not in ("sum", "avg"):
        raise ValueError(f"quantized reduction supports sum/avg, got {reduce_op!r}")
    n = len(tensors)
    shape, dtype = tensors[0].shape, tensors[0].dtype
    acc = None
    for r in range(n):
        q, s = _quantize_rank(np.asarray(tensors[r]), block, rounding, seed, r)
        d = _rank_contribution(q, s)
        acc = d if acc is None else acc + d
    if reduce_op == "avg":
        acc = acc / np.float32(n)
    size = int(np.prod(shape)) if shape else 1
    out = acc.reshape(-1)[:size].reshape(shape).astype(dtype)
    return [out.copy() for _ in range(n)]


def quantized_reduce_scatter(
    tensors: List[np.ndarray],
    block: int = 64,
    rounding: str = "nearest",
    seed: Optional[int] = None,
    reduce_op: str = "sum",
) -> List[np.ndarray]:
    """Replay of ``reduce_scatter_q`` (scatter over the flattened dim 0,
    even split): rank r accumulates every rank's chunk r in rank order.
    Chunk c of rank r is quantized with ``fold_in(fold_in(key, r), c)`` —
    the same key schedule ``collectives.q_psum_scatter`` uses."""
    n = len(tensors)
    shape, dtype = tensors[0].shape, tensors[0].dtype
    if shape[0] % n:
        raise ValueError(f"dim0 extent {shape[0]} not divisible by world {n}")
    out = []
    for rank_out in range(n):
        acc = None
        chunk_shape = None
        for r in range(n):
            chunk = np.array_split(np.asarray(tensors[r]), n, axis=0)[rank_out]
            chunk_shape = chunk.shape
            key = _key(seed, r, rank_out) if rounding == "stochastic" else None
            q, s = _quantize(chunk, block, rounding, key)
            d = _rank_contribution(q, s)
            acc = d if acc is None else acc + d
        if reduce_op == "avg":
            acc = acc / np.float32(n)
        size = int(np.prod(chunk_shape))
        out.append(acc.reshape(-1)[:size].reshape(chunk_shape).astype(dtype))
    return out


def quantized_ring_report(
    tensors: List[np.ndarray],
    block: int = 64,
    rounding: str = "nearest",
    seed: Optional[int] = None,
) -> Dict:
    """Per-bucket quantization-error report: the quantized all-reduce
    replay vs the exact fp32 ring replay, bucketed by ring chunk (the
    same chunking ``Emulator.ring_reduce_scatter`` uses), each bucket
    compared BITWISE plus max-abs/rel error — the divergence-accounting
    view the unquantized emulator provides for reduction order."""
    from ..quant import blockscale
    from .core import Emulator

    n = len(tensors)
    em = Emulator(n)
    exact = em.ring_all_reduce([np.asarray(t) for t in tensors])[0].ravel()
    quant = quantized_all_reduce(tensors, block, rounding, seed)[0].ravel()
    ref64 = np.sum([np.asarray(t, np.float64) for t in tensors], axis=0).ravel()
    buckets = []
    bounds = np.cumsum([0] + [c.size for c in np.array_split(exact, n)])
    for b in range(n):
        lo, hi = int(bounds[b]), int(bounds[b + 1])
        e, q = exact[lo:hi], quant[lo:hi]
        abserr = np.abs(q.astype(np.float64) - ref64[lo:hi])
        denom = np.maximum(np.abs(ref64[lo:hi]), 1e-12)
        buckets.append({
            "bucket": b,
            "n_elements": int(hi - lo),
            # elements the quantized path reproduces BITWISE vs the exact
            # fp32 ring replay (== comparison is bit-exact for the finite
            # values these buckets hold)
            "bitwise_equal_elements": int(np.sum(e == q)),
            "max_abs_err": float(abserr.max()) if abserr.size else 0.0,
            "max_rel_err": float((abserr / denom).max()) if abserr.size else 0.0,
        })
    raw = int(sum(int(np.prod(t.shape)) * t.dtype.itemsize for t in tensors))
    packed = int(sum(blockscale.packed_nbytes(int(np.prod(t.shape)), block) for t in tensors))
    return {
        "world_size": n,
        "block": block,
        "rounding": rounding,
        "bitwise_equal": bool(np.array_equal(exact, quant)),
        "max_abs_err": float(max(b["max_abs_err"] for b in buckets)) if buckets else 0.0,
        "payload_bytes_raw": raw,
        "payload_bytes_quantized": packed,
        "compress_ratio": raw / packed if packed else 0.0,
        "buckets": buckets,
    }
