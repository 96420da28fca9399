"""Collective algorithm selection + chunk-size modeling.

The port of ``vescale_tpu/emulator/tuning.py`` (reference
legacy/vescale/emulator/calculate_chunk_size.py + nccl/graph/tuning.py +
nccl/constants.py): choose ring vs tree per message size and model the
chunk schedule from a link's latency and bandwidth.

The reference defaults its link to the TPU's ICI figures
(``collectives._ICI_GBPS`` and the launch latency).  Those are no figures
of an NVLink or PCIe link, so here the link's bandwidth and latency are
required fields of ``LinkParams`` with no default: a caller states the
link it models (a measured one, or the reference's values to compare
with the reference).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

__all__ = ["LinkParams", "choose_algorithm", "calculate_chunk_size", "estimate_time_us"]


@dataclasses.dataclass(frozen=True)
class LinkParams:
    """One link's characteristics: bandwidth in GB/s and per-hop latency
    in µs (both required), and the ring's chunk-size clamps."""

    bandwidth_gbps: float
    latency_us: float
    min_chunk_bytes: int = 4096
    max_chunk_bytes: int = 1 << 22  # 4 MiB


def choose_algorithm(nbytes: int, world: int, params: LinkParams) -> Literal["ring", "tree"]:
    """Ring amortizes bandwidth for large messages; tree wins on latency for
    small ones (the reference's tuning-table decision, reduced to the
    crossover of the two cost models)."""
    if world <= 2:
        return "ring"
    ring = estimate_time_us(nbytes, world, "ring", params)
    tree = estimate_time_us(nbytes, world, "tree", params)
    return "ring" if ring <= tree else "tree"


def estimate_time_us(nbytes: int, world: int, algo: str, params: LinkParams) -> float:
    if algo not in ("ring", "tree"):
        raise ValueError(f"unknown algorithm {algo!r}; expected 'ring' or 'tree'")
    gb = nbytes / 1e9
    bw_us = gb / params.bandwidth_gbps * 1e6
    if algo == "ring":
        # 2(n-1)/n bandwidth term, 2(n-1) latency hops (reduce-scatter + ag)
        return 2 * (world - 1) * params.latency_us + 2 * (world - 1) / world * bw_us
    # tree: log2(n) latency depth (up + down), but the full message crosses
    # each tree level -> ~2x bandwidth term; latency-optimal, bw-suboptimal
    depth = math.ceil(math.log2(max(2, world)))
    return 2 * depth * params.latency_us + 2.0 * bw_us


def calculate_chunk_size(nbytes: int, world: int, params: LinkParams) -> int:
    """Ring chunk size (reference calculate_chunk_size.py): message split in
    `world` chunks, clamped to [min_chunk, max_chunk], 128-byte aligned."""
    if world <= 0:
        raise ValueError("world must be positive")
    chunk = max(params.min_chunk_bytes, min(params.max_chunk_bytes, -(-nbytes // world)))
    return (chunk + 127) // 128 * 128
