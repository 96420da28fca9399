"""Collective emulator — deterministic single-process replay of collectives.

The port of ``vescale_tpu/emulator/core.py``, which is numpy and moves
over unchanged: the same algorithms, the same chunking, the same
reduction order.  Capability parity with the reference emulator
(legacy/vescale/emulator/: distributed.py:52 emulated ProcessGroup,
all_reduce.py ring/tree algorithms, calculate_chunk_size.py, nccl tuning
tables): replay collective algorithms on ONE device with an explicit,
deterministic reduction order, so numerical divergence between the
"mathematical" result and the algorithm's floating-point order can be
isolated and reproduced bitwise (emulator/README.md:37-41).

The algorithms emulated are ring and tree schedules; chunking follows
the ring schedule (n-1 reduce-scatter steps + n-1 all-gather steps).  The
NCCL protocol/tuning tables reduce to the algorithm choice parameter here
(``tuning.py`` prices the two with link parameters the caller gives).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

__all__ = ["Emulator", "EmulatorProcessGroup", "init_process_group"]

_OPS = {
    "sum": np.add,
    "max": np.maximum,
    "min": np.minimum,
    "prod": np.multiply,
}


class Emulator:
    """Stateless collective algorithms over per-rank host arrays."""

    def __init__(self, world_size: int):
        self.world_size = world_size

    # ------------------------------------------------------------- rings
    def ring_reduce_scatter(self, tensors: List[np.ndarray], op: str = "sum") -> List[np.ndarray]:
        """Chunked ring reduce-scatter: after n-1 steps rank r owns the fully
        reduced chunk (r+1) % n, having accumulated contributions in ring
        order — the reference's all_reduce.py ring schedule."""
        n = self.world_size
        f = _OPS[op]
        chunks = [np.array_split(t.ravel().copy(), n) for t in tensors]
        # step s: rank r sends chunk (r - s) to (r+1), which accumulates
        for s in range(n - 1):
            moved = [chunks[r][(r - s) % n].copy() for r in range(n)]
            for r in range(n):
                src = (r - 1) % n
                c = (src - s) % n
                chunks[r][c] = f(chunks[r][c], moved[src])
        # rank r now holds the fully-reduced chunk (r + 1) % n
        return [chunks[r][(r + 1) % n] for r in range(n)]

    def ring_all_gather(self, shards: List[np.ndarray], owner_of_chunk: Optional[Sequence[int]] = None) -> List[np.ndarray]:
        n = self.world_size
        have = [{(r + 1) % n if owner_of_chunk is None else owner_of_chunk[r]: shards[r]} for r in range(n)]
        for _s in range(n - 1):
            snapshot = [dict(h) for h in have]
            for r in range(n):
                src = (r - 1) % n
                for cid, data in snapshot[src].items():
                    have[r].setdefault(cid, data)
        out = []
        for r in range(n):
            out.append(np.concatenate([have[r][c] for c in sorted(have[r])]))
        return out

    def ring_all_reduce(self, tensors: List[np.ndarray], op: str = "sum") -> List[np.ndarray]:
        shape = tensors[0].shape
        shards = self.ring_reduce_scatter(tensors, op)
        full = self.ring_all_gather(shards)
        # chunk c_id ordering: chunk id equals split index; reassemble
        return [t.reshape(shape) for t in full]

    # ------------------------------------------------------------- trees
    def tree_all_reduce(self, tensors: List[np.ndarray], op: str = "sum") -> List[np.ndarray]:
        """Binary-tree reduce to rank 0 then broadcast (reference tree
        algorithm): different reduction order than ring — comparing the two
        exposes order-sensitivity in the summed values."""
        n = self.world_size
        f = _OPS[op]
        vals = [t.astype(t.dtype, copy=True) for t in tensors]
        stride = 1
        while stride < n:
            for r in range(0, n, stride * 2):
                peer = r + stride
                if peer < n:
                    vals[r] = f(vals[r], vals[peer])
            stride *= 2
        return [vals[0].copy() for _ in range(n)]

    # ------------------------------------------------------------ others
    def all_gather(self, tensors: List[np.ndarray]) -> List[np.ndarray]:
        full = np.concatenate([t.ravel() for t in tensors])
        return [full.copy() for _ in range(self.world_size)]

    def reduce_scatter(self, tensors: List[np.ndarray], op: str = "sum") -> List[np.ndarray]:
        return self.ring_reduce_scatter(tensors, op)

    def all_to_all(self, tensors: List[np.ndarray]) -> List[np.ndarray]:
        n = self.world_size
        split = [np.array_split(t.ravel(), n) for t in tensors]
        return [np.concatenate([split[src][dst] for src in range(n)]) for dst in range(n)]

    def broadcast(self, tensors: List[np.ndarray], src: int = 0) -> List[np.ndarray]:
        return [tensors[src].copy() for _ in range(self.world_size)]


class EmulatorProcessGroup:
    """Stateful pg facade (reference distributed.py:52): holds per-rank
    buffers and executes emulated collectives in place.

    ``quantized="int8"`` switches all_reduce / reduce_scatter to the
    block-scaled int8 replay (emulator/quantized.py) — the bitwise mirror
    of ``collectives.all_reduce_q`` / ``reduce_scatter_q`` with matching
    ``block``.  Bit-for-bit holds unconditionally for the deterministic
    ``rounding="nearest"`` path; for stochastic rounding it holds only
    when the collective was given ``key=random.key(seed)`` EXPLICITLY
    — the eager wrappers' default keys fold in a process-wide call
    counter (``collectives.next_sr_key``) the replay cannot see.

    ``algo="auto"`` prices ring against tree (``tuning.choose_algorithm``)
    and needs ``params``, the link's ``LinkParams``: the port carries no
    default link."""

    def __init__(
        self,
        world_size: int,
        algo: str = "ring",
        quantized: Optional[str] = None,
        block: int = 64,
        rounding: str = "nearest",
        seed: Optional[int] = None,
        params=None,
    ):
        if algo not in ("ring", "tree", "auto"):
            raise ValueError(f"unknown algorithm {algo!r}")
        if quantized not in (None, "int8"):
            raise ValueError(f"quantized must be None or 'int8', got {quantized!r}")
        if algo == "auto" and params is None:
            raise ValueError("algo='auto' needs the link's LinkParams (no default link)")
        self.params = params
        self.world_size = world_size
        self.algo = algo
        self.quantized = quantized
        self.block = block
        self.rounding = rounding
        self.seed = seed
        self.emulator = Emulator(world_size)

    def _pick(self, tensors) -> str:
        if self.algo != "auto":
            return self.algo
        from .tuning import choose_algorithm

        return choose_algorithm(int(tensors[0].nbytes), self.world_size, self.params)

    def all_reduce(self, tensors: List[np.ndarray], op: str = "sum") -> List[np.ndarray]:
        if self.quantized == "int8":
            from .quantized import quantized_all_reduce

            return quantized_all_reduce(
                tensors, self.block, self.rounding, self.seed, reduce_op=op
            )
        if self._pick(tensors) == "tree":
            return self.emulator.tree_all_reduce(tensors, op)
        return self.emulator.ring_all_reduce(tensors, op)

    def all_gather(self, tensors):
        return self.emulator.all_gather(tensors)

    def reduce_scatter(self, tensors, op: str = "sum"):
        if self.quantized == "int8":
            from .quantized import quantized_reduce_scatter

            return quantized_reduce_scatter(
                tensors, self.block, self.rounding, self.seed, reduce_op=op
            )
        return self.emulator.reduce_scatter(tensors, op)

    def all_to_all(self, tensors):
        return self.emulator.all_to_all(tensors)

    def broadcast(self, tensors, src: int = 0):
        return self.emulator.broadcast(tensors, src)


_GROUP: Optional[EmulatorProcessGroup] = None


def init_process_group(world_size: int, algo: str = "ring", params=None) -> EmulatorProcessGroup:
    """(reference distributed.py:642)"""
    global _GROUP
    _GROUP = EmulatorProcessGroup(world_size, algo, params=params)
    return _GROUP
