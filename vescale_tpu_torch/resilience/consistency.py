"""Cross-rank desync detection: cheap fingerprints, loud mismatches.

The port of ``vescale_tpu/resilience/consistency.py``.  SPMD training is
correct only while every process runs the SAME program over the same
host-side state: step counter, RNG stream, data position, replicated
parameters, mesh and plan.  A rank that silently drifts (a bit flip in host
memory, a rank-local retry that consumed an extra batch) does not crash:
its collectives still pair up, and the first hard evidence is a
checkpoint that LOOKS committed.

Every rank computes a small int64 fingerprint of its host-side state, the
vectors are all-gathered (``distributed.allgather_ints``), and any
field-wise mismatch raises ``DesyncError`` naming the field and every
rank's value, before the next save can commit divergent state.

Fingerprint fields (one int64 each, ``FIELDS`` order):

  magic       schema version constant: catches mixed-code-version runs
  step        next training step
  data_cursor next batch index
  rng_seed    the run's RNG seed (-1: unseeded)
  loader      hash of the loader's rank-INVARIANT position (every key but
              ``dp_rank``)
  structure   hash of the params / optimizer-state tree STRUCTURE: key
              paths, leaf kinds, shapes, dtypes and placements
  params      hash of a strided value sample of the REPLICATED leaves:
              Python scalars, numpy arrays, plain tensors and all-
              ``Replicate`` DArrays' pieces (every rank holds the same
              copy, so a difference is real divergence); other DArrays
              count toward ``structure`` only
  extra       caller-provided discriminator (0 default)

``magic``, ``step``, ``data_cursor``, ``rng_seed``, ``loader``,
``params`` and ``extra`` equal the reference's for the same values (a
tensor's sample is hashed as the float64 bytes numpy gives the reference's
array).  ``structure`` is the port's own: the reference hashes JAX
treedef and sharding strings (ROADMAP §C).  A sample is taken on the
tensor's device and only the sampled elements travel to the host; nothing
is gathered.  One process: checks need no collective, so one code path
runs everywhere.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "FIELDS",
    "MAGIC",
    "DesyncError",
    "tree_structure_fingerprint",
    "replicated_sample_fingerprint",
    "fingerprint",
    "compare_rows",
    "check",
    "ConsistencyChecker",
]

# field order of the fingerprint vector; MAGIC changes with the schema, so
# ranks running different code versions mismatch on field 0
FIELDS = ("magic", "step", "data_cursor", "rng_seed", "loader", "structure", "params", "extra")
MAGIC = 0x7E5CA1E_01


def _h64(parts: Sequence[Any]) -> int:
    """Stable 63-bit hash of a sequence of parts' reprs (blake2b: no
    per-process salt, unlike ``hash``)."""
    h = hashlib.blake2b(digest_size=8)
    for p in parts:
        h.update(repr(p).encode())
        h.update(b"\x00")
    return int.from_bytes(h.digest(), "little") & 0x7FFFFFFFFFFFFFFF


def _mask(v: int) -> int:
    return int(v) & 0x7FFFFFFFFFFFFFFF


def _leaves(tree) -> List[Any]:
    from ..checkpoint.planner import flatten_state

    return flatten_state(tree)


def _replicated_sample(leaf, stride: int) -> Optional[np.ndarray]:
    """A strided sample of ``leaf``'s flat value on the host, IFF every
    process provably holds the same copy; None otherwise.  Never gathers."""
    from ..darray import DArray
    from ..placements import Replicate

    if isinstance(leaf, (bool, int, float)):
        return np.asarray(leaf).reshape(-1)[::stride]
    if isinstance(leaf, np.ndarray):
        return leaf.reshape(-1)[::stride]
    if isinstance(leaf, DArray):
        if not all(isinstance(p, Replicate) for p in leaf.placements):
            return None
        leaf = leaf.to_local()
    if isinstance(leaf, torch.Tensor):
        if leaf.device.type == "meta":
            return None
        sample = leaf.detach().reshape(-1)[::stride]
        if sample.dtype in (torch.bfloat16, torch.float16):
            sample = sample.float()  # exact: numpy has no bfloat16
        return sample.cpu().numpy()
    return None


def _leaf_structure(leaf) -> tuple:
    from ..darray import DArray

    if isinstance(leaf, DArray):
        return ("darray", tuple(leaf.shape), str(leaf.dtype), repr(tuple(leaf.placements)))
    if isinstance(leaf, torch.Tensor):
        return ("tensor", tuple(leaf.shape), str(leaf.dtype))
    if isinstance(leaf, np.ndarray):
        return ("np", tuple(leaf.shape), str(leaf.dtype))
    return ("py", type(leaf).__name__)


def tree_structure_fingerprint(*trees) -> int:
    """Hash of the trees' STRUCTURE: key paths and each leaf's kind,
    shape, dtype and placements.  Catches a rank that built another mesh,
    plan or state schema: desyncs that corrupt checkpoints without ever
    making a NaN."""
    parts: List[Any] = []
    for tree in trees:
        for key, leaf in _leaves(tree):
            parts.append(key)
            parts.append(_leaf_structure(leaf))
    return _h64(parts)


def replicated_sample_fingerprint(*trees, sample_stride: int = 4097) -> int:
    """Hash of a strided value sample of every replicated leaf.
    ``sample_stride`` keeps the host transfer to a few elements a leaf.
    Non-finite values hash by position (NaN != NaN would make every
    fingerprint unique)."""
    parts: List[Any] = []
    for tree in trees:
        for _key, leaf in _leaves(tree):
            sample = _replicated_sample(leaf, max(1, sample_stride))
            if sample is None:
                continue
            with np.errstate(all="ignore"):
                finite = np.nan_to_num(sample.astype(np.float64, copy=False))
            parts.append(finite.tobytes())
            parts.append(sample.shape)
    return _h64(parts)


def _loader_fingerprint(loader_state: Optional[Dict[str, int]]) -> int:
    if not loader_state:
        return 0
    # dp_rank differs per rank by design (each rank reads its own slice)
    inv = {k: int(v) for k, v in sorted(loader_state.items()) if k != "dp_rank"}
    return _h64(sorted(inv.items()))


def fingerprint(
    *,
    step: int,
    data_cursor: int = 0,
    rng_seed: Optional[int] = None,
    loader_state: Optional[Dict[str, int]] = None,
    params: Any = None,
    opt_state: Any = None,
    sample_stride: int = 4097,
    extra: int = 0,
) -> np.ndarray:
    """This rank's fingerprint vector (int64, ``FIELDS`` order)."""
    trees = [t for t in (params, opt_state) if t is not None]
    return np.asarray(
        [
            MAGIC,
            int(step),
            int(data_cursor),
            _mask(rng_seed) if rng_seed is not None else -1,
            _loader_fingerprint(loader_state),
            tree_structure_fingerprint(*trees) if trees else 0,
            replicated_sample_fingerprint(*trees, sample_stride=sample_stride) if trees else 0,
            _mask(extra),
        ],
        np.int64,
    )


class DesyncError(RuntimeError):
    """Ranks disagree on state that must be identical.  Carries the whole
    gathered matrix, so the message names which field diverged and every
    rank's value."""

    def __init__(self, mismatched: Dict[str, List[int]], rows: np.ndarray):
        self.mismatched = mismatched
        self.rows = rows
        detail = "; ".join(
            f"{name}: " + ", ".join(f"rank{r}={v}" for r, v in enumerate(vals))
            for name, vals in mismatched.items()
        )
        super().__init__(f"cross-rank desync detected on {sorted(mismatched)} — {detail}")


def compare_rows(rows: np.ndarray, fields: Sequence[str] = FIELDS) -> Dict[str, List[int]]:
    """Field-wise mismatch map of a gathered matrix (one row per rank);
    empty when every rank agrees."""
    rows = np.asarray(rows)
    out: Dict[str, List[int]] = {}
    for i, name in enumerate(fields[: rows.shape[1]]):
        col = rows[:, i]
        if not np.all(col == col[0]):
            out[name] = [int(v) for v in col]
    return out


def check(fp: np.ndarray, tag: str = "resilience_consistency",
          timeout_s: Optional[float] = None) -> np.ndarray:
    """All-gather this rank's fingerprint and verify that every rank
    matches: ``DesyncError`` on a mismatch (every rank sees the same
    matrix, so every rank raises).  Returns the gathered matrix."""
    from .. import telemetry as _tel
    from ..distributed import allgather_ints

    rows = allgather_ints(fp, tag=tag, timeout_s=timeout_s)
    _tel.count("consistency_checks_total")
    mismatched = compare_rows(rows)
    if mismatched:
        _tel.count("consistency_mismatches_total")
        _tel.record_event("resilience_desync", fields=sorted(mismatched),
                          rows={f: v for f, v in mismatched.items()})
        raise DesyncError(mismatched, rows)
    return rows


class ConsistencyChecker:
    """Cadenced fingerprint checks for a training loop::

        checker = ConsistencyChecker(every=32)
        checker.maybe_check(step, params=params, opt_state=opt,
                            data_cursor=cursor, rng_seed=seed,
                            loader_state=loader.state())

    ``every`` trades detection latency against the (tiny) allgather;
    ``run_resilient`` puts its own control-plane exchange on this cadence,
    so a desync is caught before the next save commits."""

    def __init__(self, every: int = 32, sample_stride: int = 4097,
                 timeout_s: Optional[float] = None):
        if every <= 0:
            raise ValueError("ConsistencyChecker every must be positive")
        self.every = int(every)
        self.sample_stride = int(sample_stride)
        self.timeout_s = timeout_s
        self.checks = 0

    def due(self, step: int) -> bool:
        return step % self.every == 0

    def fingerprint(self, step: int, **state) -> np.ndarray:
        return fingerprint(step=step, sample_stride=self.sample_stride, **state)

    def maybe_check(self, step: int, **state) -> Optional[np.ndarray]:
        if not self.due(step):
            return None
        self.checks += 1
        return check(self.fingerprint(step, **state), timeout_s=self.timeout_s)
