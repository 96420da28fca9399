"""Measured collective-cost calibration: wall-clock data in place of
guessed bandwidth factors.

The port of ``vescale_tpu/telemetry/calibrate.py``.  The planners that
price layouts (the redistribution planner, the pipeline schedules) read a
cost model; this module is its measurement half:

  * :class:`CalibrationTable` — per ``(op, mesh-axis size, byte bucket)``
    measured wall times (microseconds), the mesh they were measured on, a
    matmul-throughput sample (FLOPs -> us for stage costs) and a content
    digest, so a perf record can name the cost model that priced it.  Its
    JSON file (``collective_calibration.json``) and digest are the
    reference's byte for byte for the same entries.
  * :func:`calibrate` — a sweep: each collective of the port's mesh
    (``collectives.mesh_*``) over each mesh dim at a ladder of byte
    buckets, timed on the host after a ``torch.cuda.synchronize()`` on a
    CUDA mesh, each rep an ndtimeline span tagged with the sample (so the
    sweep shows on the timeline and :meth:`CalibrationTable.ingest_spans`
    can harvest any span stream that carries the same tags).  The matmul
    sample is one plain ``torch.matmul``.
  * The consumption contract: ``VESCALE_COST_CALIBRATION=<path>`` (or
    :func:`set_active`) arms calibrated mode; :func:`collective_cost_us`
    interpolates log-log between buckets and returns ``None`` — after a
    one-time warning per (op, axis size) — for a missing bucket, so every
    caller keeps its analytic fallback.  A table measured on another mesh
    shape or another device type is stale: it warns once and behaves as
    absent.  An empty table (or none) changes nothing.
  * :func:`device_peak_flops` — the MFU denominator: a CUDA card's
    datasheet bf16 peak (``device.peak_bf16_flops``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import threading
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "CalibrationTable",
    "calibrate",
    "load_table",
    "set_active",
    "reset_active",
    "active_table",
    "table_for",
    "collective_cost_us",
    "table_cost_us",
    "compute_cost_us",
    "active_digest",
    "hop_latency_us",
    "device_peak_flops",
    "matmul_gflops",
    "clear_warned",
    "TABLE_FILENAME",
    "CALIBRATION_OPS",
]

TABLE_FILENAME = "collective_calibration.json"
FORMAT_VERSION = 1

# the ops the sweep measures — the vocabulary of the planner's edge kinds
# (collective_permute prices as all_to_all's wire pattern; ppermute is the
# p2p hop simulate_schedule's comm term reads)
CALIBRATION_OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "ppermute")

# span tag contract: any span carrying these tags is a calibration sample
# (the sweep emits them; a runtime wrapper may too)
SPAN_TAGS = ("collective_op", "axis_size", "bytes")

# flat per-hop dispatch/launch overhead in calibrated (us-denominated) mode —
# the analytic model's _HOP_LATENCY analog.  Overridable per table
# (meta["launch_us"], measured by the sweep's smallest bucket residual).
DEFAULT_LAUNCH_US = 2.0


def _bucket(nbytes: int) -> int:
    """Canonical byte bucket: the power of two at or below ``nbytes``
    (bucket 1 for anything sub-byte).  Buckets key measurements; lookups
    interpolate between them in log-log space."""
    n = max(1, int(nbytes))
    return 1 << (n.bit_length() - 1)


@dataclasses.dataclass
class CalibrationTable:
    """Measured ``(op, axis_size, byte bucket) -> wall microseconds``.

    ``entries`` values are ``{"us": float, "samples": int}`` running means —
    harvesting more spans refines, never replaces, a bucket.  ``meta`` holds
    the provenance the staleness check reads: the mesh (dim names + shape)
    the measurements ran on, the platform, and optional ``matmul_gflops``
    (device compute throughput, for FLOPs -> us stage-cost conversion)."""

    entries: Dict[Tuple[str, int, int], Dict[str, float]] = dataclasses.field(
        default_factory=dict
    )
    meta: Dict = dataclasses.field(default_factory=dict)
    # memoized content hash — digest() is consulted on EVERY plan-cache
    # lookup (_cal_key), so it must not re-serialize the table each time
    _digest: Optional[str] = dataclasses.field(default=None, repr=False, compare=False)

    # ------------------------------------------------------------- build
    def add_sample(self, op: str, axis_size: int, nbytes: int, seconds: float,
                   decay: Optional[float] = None) -> None:
        """Fold one measurement into its bucket.  Default: the plain
        running mean (every sample weighs ``1/n`` — the sweep's batch
        semantics).  ``decay``: a fixed EWMA weight for the ONLINE harvest
        (costaudit.py) — recent wall-clock outweighs history, so a table
        skewed by stale measurements converges back to reality instead of
        averaging it away."""
        key = (str(op), int(axis_size), _bucket(nbytes))
        cell = self.entries.get(key)
        us = float(seconds) * 1e6
        self._digest = None  # content changed: drop the memoized hash
        if cell is None:
            self.entries[key] = {"us": us, "samples": 1}
        elif decay is not None:
            a = min(1.0, max(0.0, float(decay)))
            cell["us"] += a * (us - cell["us"])
            cell["samples"] += 1
        else:
            n = cell["samples"] + 1
            cell["us"] += (us - cell["us"]) / n
            cell["samples"] = n

    def ingest_spans(self, spans, decay: Optional[float] = None) -> int:
        """Harvest calibration samples from a span stream: any span whose
        tags carry ``collective_op``/``axis_size``/``bytes`` (the sweep's
        own spans, or runtime instrumentation honoring the contract).
        ``decay`` forwards to :meth:`add_sample` (the online harvest's
        EWMA weight).  Returns the number of samples absorbed."""
        n = 0
        for s in spans:
            tags = getattr(s, "tags", None) or {}
            if not all(t in tags for t in SPAN_TAGS):
                continue
            try:
                self.add_sample(
                    tags["collective_op"], int(tags["axis_size"]),
                    int(tags["bytes"]), float(s.duration), decay=decay,
                )
                n += 1
            except (TypeError, ValueError):
                continue
        return n

    # ``harvest`` is the contract name the audit layer and docs use for
    # span-stream ingestion; same semantics as ingest_spans
    harvest = ingest_spans

    # ------------------------------------------------------------ lookup
    def lookup_us(self, op: str, axis_size: int, nbytes: int) -> Optional[float]:
        """Measured wall time for ``op`` over a mesh axis of ``axis_size``
        moving ``nbytes``: log-log interpolation between measured byte
        buckets, per-byte-rate extrapolation beyond the measured range,
        ``None`` when this (op, axis size) has no buckets at all."""
        pts = sorted(
            (k[2], v["us"])
            for k, v in self.entries.items()
            if k[0] == op and k[1] == int(axis_size)
        )
        if not pts:
            return None
        n = max(1, int(nbytes))
        if len(pts) == 1 or n <= pts[0][0]:
            b, us = pts[0]
            return us * (n / b) if n != b else us
        if n >= pts[-1][0]:
            b, us = pts[-1]
            return us * (n / b) if n != b else us
        for (b0, u0), (b1, u1) in zip(pts, pts[1:]):
            if b0 <= n <= b1:
                if b0 == b1:
                    return u0
                t = (math.log(n) - math.log(b0)) / (math.log(b1) - math.log(b0))
                return math.exp(math.log(u0) * (1 - t) + math.log(u1) * t)
        return pts[-1][1]  # unreachable; defensive

    def op_estimate_us(self, op: str) -> Optional[float]:
        """Sample-weighted mean wall time over EVERY bucket of ``op`` —
        the coarse single-number seed for consumers that know the op but
        not the payload (the serve scheduler's audited ``retry_after_s``
        seed reads ``serve_decode``).  None when the op was never
        measured."""
        total = weight = 0.0
        for k, v in self.entries.items():
            if k[0] == op:
                total += v["us"] * v["samples"]
                weight += v["samples"]
        return total / weight if weight else None

    def matches_mesh(self, mesh) -> bool:
        """Staleness check: the table speaks for the mesh it measured.
        Compares dim names + shape (a ``DeviceMesh`` or anything exposing
        ``mesh_dim_names``/``shape``); a table without mesh provenance
        matches nothing."""
        want = self.meta.get("mesh")
        if not want:
            return False
        try:
            return tuple(want.get("dim_names", ())) == tuple(mesh.mesh_dim_names) and tuple(
                want.get("shape", ())
            ) == tuple(mesh.shape)
        except AttributeError:
            return False

    def __len__(self) -> int:
        return len(self.entries)

    # ------------------------------------------------------- persistence
    def to_json(self) -> Dict:
        return {
            "format": FORMAT_VERSION,
            "meta": self.meta,
            "entries": [
                {"op": k[0], "axis_size": k[1], "bucket_bytes": k[2], **v}
                for k, v in sorted(self.entries.items())
            ],
        }

    @classmethod
    def from_json(cls, data: Dict) -> "CalibrationTable":
        if int(data.get("format", 0)) != FORMAT_VERSION:
            raise ValueError(
                f"calibration table format {data.get('format')!r} unsupported "
                f"(this build reads format {FORMAT_VERSION})"
            )
        t = cls(meta=dict(data.get("meta") or {}))
        for e in data.get("entries", ()):
            t.entries[(str(e["op"]), int(e["axis_size"]), int(e["bucket_bytes"]))] = {
                "us": float(e["us"]),
                "samples": int(e.get("samples", 1)),
            }
        return t

    def digest(self) -> str:
        """Stable short content hash — BENCH lines and plan-cache keys
        record it so a perf number names the cost model that priced it.
        Memoized until the next ``add_sample``/``ingest_spans``."""
        if self._digest is None:
            blob = json.dumps(self.to_json(), sort_keys=True).encode()
            self._digest = hashlib.sha256(blob).hexdigest()[:12]
        return self._digest

    def save(self, path: str) -> str:
        """Atomic persist (tmp + rename): the online harvest rewrites the
        table on a cadence while planners may re-read it mid-write via the
        ``VESCALE_COST_CALIBRATION`` mtime reload — a torn read must be
        impossible."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        data = self.to_json()
        data["digest"] = self.digest()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    def launch_us(self) -> float:
        return float(self.meta.get("launch_us", DEFAULT_LAUNCH_US))


def load_table(path: str) -> CalibrationTable:
    with open(path) as f:
        return CalibrationTable.from_json(json.load(f))


# --------------------------------------------------------------- sweep
def _timed(fn, *args, cuda: bool = False) -> float:
    """Host seconds of ``fn(*args)``; on a CUDA mesh the card is
    synchronized before the clock stops."""
    import torch

    t0 = time.perf_counter()
    fn(*args)
    if cuda:
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def calibrate(
    mesh,
    ops: Sequence[str] = CALIBRATION_OPS,
    byte_buckets: Sequence[int] = (1 << 12, 1 << 16, 1 << 20),
    reps: int = 3,
    measure_matmul: bool = True,
) -> CalibrationTable:
    """The measurement sweep: for each mesh dim of size > 1, each op and each
    byte bucket, run the collective ``reps`` times after one untimed warmup
    and record the median.  Each measured rep is also an ndtimeline span
    tagged with the sample while ndtimeline is active.

    Every rank of the mesh calls this together (the collectives are
    collective).  Each rank passes its own operand: ``nbytes`` of fp32 for
    all_reduce and all_gather, and the reference's stacked operand (a
    multiple of the dim size) for reduce_scatter, all_to_all and
    ppermute."""
    import numpy as np
    import torch

    from .. import collectives as C
    from ..ndtimeline.api import ndtimeit

    cuda = mesh.device_type == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    table = CalibrationTable(
        meta={
            "mesh": {
                "dim_names": list(mesh.mesh_dim_names),
                "shape": list(mesh.shape),
            },
            "platform": mesh.device_type,
            "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "launch_us": DEFAULT_LAUNCH_US,
        }
    )

    def run(op: str, dim: int, x):
        if op == "all_reduce":
            return C.mesh_all_reduce(x, mesh, mesh_dim=dim)
        if op == "all_gather":
            return C.mesh_all_gather(x, mesh, mesh_dim=dim)
        if op == "reduce_scatter":
            return C.mesh_reduce_scatter(x, mesh, mesh_dim=dim)
        if op == "all_to_all":
            return C.mesh_all_to_all(x, mesh, mesh_dim=dim)
        if op == "ppermute":
            return C.mesh_ppermute(x, mesh, mesh_dim=dim)
        raise ValueError(f"unknown calibration op {op!r}")

    def make_input(op: str, dim: int, nbytes: int):
        n = int(mesh.shape[dim])
        elems = max(1, int(nbytes) // 4)  # fp32 payloads
        if op in ("reduce_scatter", "all_to_all", "ppermute"):
            elems = max(n, (elems // n) * n)  # chunked by the dim size
        return torch.ones(elems, dtype=torch.float32, device=dev)

    for dim in range(len(mesh.shape)):
        n = int(mesh.shape[dim])
        if n <= 1:
            continue
        for op in ops:
            for nbytes in byte_buckets:
                x = make_input(op, dim, int(nbytes))
                _timed(run, op, dim, x, cuda=cuda)  # warmup: first dispatch
                samples = []
                for _ in range(max(1, int(reps))):
                    with ndtimeit(
                        "calibrate-collective",
                        tags={"collective_op": op, "axis_size": n, "bytes": int(nbytes)},
                    ):
                        samples.append(_timed(run, op, dim, x, cuda=cuda))
                table.add_sample(op, n, int(nbytes), float(np.median(samples)))

    if measure_matmul:
        table.meta["matmul_gflops"] = matmul_gflops(dev, reps=reps)
    return table


def matmul_gflops(device, k: int = 256, reps: int = 3) -> float:
    """The calibration's compute sample: GFLOP/s of one fp32 ``k`` x ``k``
    ``torch.matmul`` on ``device``, the median of ``reps`` timed calls
    after a warmup (FLOPs -> us for calibrated stage costs)."""
    import numpy as np
    import torch

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    a = torch.ones((k, k), dtype=torch.float32, device=dev)
    _timed(torch.matmul, a, a, cuda=cuda)
    dt = float(np.median([_timed(torch.matmul, a, a, cuda=cuda) for _ in range(max(1, int(reps)))]))
    return 2.0 * k * k * k / dt / 1e9


# ------------------------------------------------------- active table gate
_LOCK = threading.Lock()
_ACTIVE: Optional[CalibrationTable] = None          # programmatic override
_ACTIVE_EXPLICIT = False
_LOADED: Dict[str, Tuple[float, Optional[CalibrationTable]]] = {}  # path -> (mtime, table)
_WARNED: set = set()  # one-time fallback warnings, keyed by reason


def set_active(table: Optional[CalibrationTable]) -> None:
    """Programmatically arm (or, with ``None``, disarm) calibrated mode for
    this process, overriding ``VESCALE_COST_CALIBRATION``.  Call
    ``reset_active()`` to return control to the env knob."""
    global _ACTIVE, _ACTIVE_EXPLICIT
    with _LOCK:
        _ACTIVE = table
        _ACTIVE_EXPLICIT = True


def reset_active() -> None:
    global _ACTIVE, _ACTIVE_EXPLICIT
    with _LOCK:
        _ACTIVE = None
        _ACTIVE_EXPLICIT = False
        _LOADED.clear()
        _WARNED.clear()


def clear_warned() -> None:
    """Re-arm the one-time fallback warnings (test hook)."""
    with _LOCK:
        _WARNED.clear()


def _warn_once(key: str, message: str) -> None:
    """Stale/missing-table signals route through the alert engine when it
    is live (rule ``calibration-<reason>``: one lifecycle, /alerts
    visibility); the dormant path keeps the legacy per-key one-shot
    warning so analytic fallbacks stay visible without telemetry."""
    with _LOCK:
        if key in _WARNED:
            return
        _WARNED.add(key)
    from . import alerts as _alerts

    if _alerts.is_active():
        _alerts.raise_alert(
            f"calibration-{key.split(':', 1)[0]}", message=message,
            severity="warning",
        )
        return
    # dormant-engine legacy fallback; live runs route through the
    # telemetry.alerts branch above
    warnings.warn(message, stacklevel=3)  # vescale-lint: disable=VSC207


def active_table() -> Optional[CalibrationTable]:
    """The armed calibration table, or None (analytic mode).  Resolution:
    an explicit :func:`set_active` wins; else ``VESCALE_COST_CALIBRATION``
    names a JSON path, loaded lazily and re-read when its mtime changes
    (live env semantics).  An unreadable path warns once
    and behaves as absent — a typo'd knob must not crash planning."""
    with _LOCK:
        if _ACTIVE_EXPLICIT:
            return _ACTIVE
    from .. import config as envreg

    path = envreg.get_str("VESCALE_COST_CALIBRATION")
    if not path:
        return None
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        _warn_once(
            f"missing:{path}",
            f"VESCALE_COST_CALIBRATION={path!r}: table not readable — "
            "falling back to the analytic cost model",
        )
        return None
    with _LOCK:
        cached = _LOADED.get(path)
        if cached is not None and cached[0] == mtime:
            return cached[1]
    try:
        table = load_table(path)
    except (OSError, ValueError, KeyError) as e:
        _warn_once(
            f"unparseable:{path}",
            f"VESCALE_COST_CALIBRATION={path!r}: failed to load ({e}) — "
            "falling back to the analytic cost model",
        )
        table = None
    with _LOCK:
        _LOADED[path] = (mtime, table)
    return table


def _platform(mesh) -> str:
    """Where this process runs: the mesh's device type, else the card when
    there is one."""
    if mesh is not None and getattr(mesh, "device_type", None):
        return mesh.device_type
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def table_for(mesh) -> Optional[CalibrationTable]:
    """The armed NON-EMPTY table when it speaks for ``mesh`` (or when no
    mesh is given), else None.  A stale table — measured on a different
    mesh shape, or on a different BACKEND than the one now running — warns
    once and resolves to None, so every consumer degrades to its analytic
    model identically.  The platform check covers mesh-less consumers:
    gloo-CPU wall times must never silently price a card's plan."""
    t = active_table()
    if t is None or len(t) == 0:
        return None
    want_platform = t.meta.get("platform")
    if want_platform:
        have = _platform(mesh)
        if have != want_platform:
            _warn_once(
                f"platform:{t.digest()}",
                f"VESCALE_COST_CALIBRATION: table was measured on platform "
                f"{want_platform!r} but this process runs on {have!r} — "
                "stale table; falling back to the analytic cost model "
                "(re-run telemetry.calibrate.calibrate() on this backend)",
            )
            return None
    if mesh is not None and not t.matches_mesh(mesh):
        _warn_once(
            f"stale:{t.digest()}",
            "VESCALE_COST_CALIBRATION: table was measured on mesh "
            f"{t.meta.get('mesh')} but is being consulted for {mesh!r} — "
            "stale table; falling back to the analytic cost model "
            "(re-run telemetry.calibrate.calibrate() on this mesh)",
        )
        return None
    return t


def active_digest() -> Optional[str]:
    """Digest of the armed NON-EMPTY table, else None.  The signature the
    planner's cache key and bench lines embed: an empty table is
    cost-model-identical to no table and must key identically."""
    t = active_table()
    if t is None or len(t) == 0:
        return None
    return t.digest()


def table_cost_us(
    table: Optional[CalibrationTable], op: str, axis_size: int, nbytes: float
) -> Optional[float]:
    """Measured lookup against an ALREADY-RESOLVED table — the planner's
    hot path resolves the table once per edge set and must not pay the
    env-read + mtime-stat + platform-probe of :func:`table_for` again per
    wire op.  Same one-time missing-bucket warning as
    :func:`collective_cost_us`.  ``nbytes`` is the per-rank OPERAND
    payload (the sweep's own key), never ring-scaled wire bytes."""
    if table is None or int(axis_size) <= 1:
        return None
    us = table.lookup_us(op, int(axis_size), int(nbytes))
    if us is None:
        _warn_once(
            f"bucket:{op}:{axis_size}",
            f"cost calibration: no measured bucket for op={op!r} over a mesh "
            f"axis of {axis_size} — using the analytic model for this op "
            "(extend the calibrate() sweep to cover it)",
        )
        return None
    return us


def collective_cost_us(
    op: str, axis_size: int, nbytes: float, mesh=None
) -> Optional[float]:
    """Measured cost of one collective in microseconds, or None (caller
    falls back to its analytic model).  ``mesh`` (when the caller has one)
    arms the mesh-shape staleness check on top of the always-on platform
    check; a stale table warns once and is treated as absent."""
    if int(axis_size) <= 1:
        return None
    return table_cost_us(table_for(mesh), op, axis_size, nbytes)


# assumed elementwise-pass bandwidth for pricing quantize/dequantize compute
# in calibrated (us-denominated) mode; deliberately conservative so a quant
# hop must win on WIRE time, as in the analytic model
_COMPUTE_GBPS = 10.0


def compute_cost_us(nbytes: float) -> float:
    """Calibrated-mode price of an elementwise pass touching ``nbytes``
    (quantize/dequantize terms of the planner's quant edge)."""
    return float(nbytes) / 1e9 / _COMPUTE_GBPS * 1e6


def hop_latency_us() -> float:
    """Per-hop dispatch overhead in calibrated mode (the analytic model's
    flat ``_HOP_LATENCY`` byte term, re-denominated in microseconds)."""
    t = active_table()
    return t.launch_us() if t is not None else DEFAULT_LAUNCH_US


def device_peak_flops(device) -> float:
    """Peak (bf16 matmul) FLOP/s of one card — the MFU denominator of the
    bench and the serve MFU gauge.  A CUDA card takes its datasheet figure
    (``device.peak_bf16_flops``: 989e12 for an H100 SXM); anything else
    takes the active calibration table's measured ``matmul_gflops`` (an
    achievable peak on a CPU rig), else 1e12, so an MFU line still prints
    rather than dividing by an unknown."""
    from ..device import peak_bf16_flops

    try:
        peak = peak_bf16_flops(device)
    except (RuntimeError, AssertionError):  # a CUDA index without a card
        peak = None
    if peak:
        return float(peak)
    t = active_table()
    if t is not None:
        g = t.meta.get("matmul_gflops")
        if g:
            return float(g) * 1e9
    return 1e12
