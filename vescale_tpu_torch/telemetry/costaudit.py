"""Plan-vs-reality cost auditing — the predict→measure→recalibrate loop.

The port of ``vescale_tpu/telemetry/costaudit.py``:

  * **Prediction ledger** — :func:`record_prediction` appends a priced
    decision (plan id, predicted µs or bytes, cost-model digest, unit) to a
    bounded ring; :func:`record_measurement` joins the measured outcome by
    plan id and folds the divergence ratio ``max(m/p, p/m)`` into decayed
    running means, overall and per kind.
  * **Per-step auditor** — :func:`audit_step` (called by
    ``telemetry.record_step`` before the time-series sample) publishes the
    ratios as ``cost_model_*`` gauges, which the store and the
    ``cost-model-drift`` rule (:func:`costaudit_rule_pack`) read, and
    returns the ``cost_audit`` field of a steps.jsonl line.
  * **Online calibration** — the auditor harvests spans that carry the
    :data:`calibrate.SPAN_TAGS` into the active
    :class:`~.calibrate.CalibrationTable` with a decayed running mean and
    persists it atomically on a cadence.
  * **Per-layer roofline attribution** — :func:`layer_attribution` runs a
    step once and attributes FLOPs and bytes to the model's layers, each
    classified compute- or memory-bound against the card's roofline;
    :func:`attach_roofline_tracks` renders it as Perfetto counter tracks.
    The reference parses optimized HLO; the port has none, so it applies
    the same rules to each aten op under a ``TorchDispatchMode`` and to
    each hand-written kernel through its wrapper's ``cost`` (see
    :class:`LayerAttribution`).

  * **What-if scoring** — :func:`mesh_candidates` enumerates the (dp, tp,
    pp) factorizations of a world and :func:`score_candidates` re-prices
    each against the audited calibration table: compute at the card's
    peak (``calibrate.device_peak_flops``) plus the collectives its layout
    implies, each from the table (or ``collectives.analytic_cost_us``),
    with a confidence from the audit history of those buckets.

Gating contract: ``record_prediction`` / ``record_measurement`` /
``audit_step`` / ``harvest`` are module-level no-op function references
while dormant; ``telemetry.init()`` activates (``VESCALE_COSTAUDIT``),
``shutdown()`` restores the no-ops.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "record_prediction",
    "record_measurement",
    "audit_step",
    "harvest",
    "activate",
    "deactivate",
    "is_active",
    "get_auditor",
    "audit_summary",
    "costaudit_rule_pack",
    "CostAudit",
    "LayerAttribution",
    "layer_attribution",
    "summarize_attribution",
    "roofline_counter_events",
    "attach_roofline_tracks",
    "device_mem_gbps",
    "mesh_candidates",
    "score_candidates",
    "PLAN_ID_TAG",
]

# span tag naming the prediction a measured span belongs to (rides next to
# the calibrate SPAN_TAGS contract on instrumented redistribute hops)
PLAN_ID_TAG = "plan_id"


# ------------------------------------------------------- dormant no-op hooks
# Named module-level functions (never lambdas — VSC203): the planners call
# these unconditionally and an un-audited run must pay only the attribute
# load.  activate()/deactivate() swap the module attributes, memtrack-style.

def _noop_record_prediction(kind, predicted_us=None, predicted_bytes=None,
                            digest=None, unit="us", detail=None):
    return None


def _noop_record_measurement(plan_id, measured_us=None, measured_bytes=None):
    return None


def _noop_audit_step(kind=None):
    return None


def _noop_harvest(spans=None):
    return 0


record_prediction = _noop_record_prediction
record_measurement = _noop_record_measurement
audit_step = _noop_audit_step
harvest = _noop_harvest


# plan ids are PROCESS-monotonic, not per-auditor: plans cached in the
# planner outlive telemetry init/shutdown cycles, and a stale id must fall
# off the new ledger as unknown — never collide with a fresh prediction
_ID_LOCK = threading.Lock()
_NEXT_ID = 1


def _new_id() -> int:
    global _NEXT_ID
    with _ID_LOCK:
        i = _NEXT_ID
        _NEXT_ID += 1
        return i


class CostAudit:
    """The live auditor: bounded prediction ledger + divergence aggregates
    + the online-calibration harvester.  Exists only between
    :func:`activate` and :func:`deactivate` — its absence IS the off
    state."""

    def __init__(self, registry, *, depth: int = 256, threshold: float = 3.0,
                 decay: float = 0.25, cadence_s: float = 30.0,
                 harvest_spans: bool = True):
        self.registry = registry
        self.depth = max(1, int(depth))
        self.threshold = float(threshold)
        self.decay = float(decay)
        self.cadence_s = float(cadence_s)
        self.harvest_spans = bool(harvest_spans)
        self._lock = threading.Lock()
        self._ledger: "OrderedDict[int, Dict]" = OrderedDict()
        self._predicted = 0
        self._matched = 0
        self._divergence: Optional[float] = None          # decayed mean ratio
        self._by_kind: Dict[str, Dict[str, Any]] = {}
        self._bucket_div: Dict[Tuple[str, int, int], Dict[str, float]] = {}
        self._harvested = 0
        self._harvest_hwm = 0.0      # span-start high-water mark (no re-ingest)
        self._last_persist = time.monotonic()
        self._digest_rotations = 0

    # -------------------------------------------------------------- ledger
    def record_prediction(self, kind: str, predicted_us: Optional[float] = None,
                          predicted_bytes: Optional[float] = None,
                          digest: Optional[str] = None, unit: str = "us",
                          detail: Optional[Dict] = None) -> int:
        """Append one priced decision; returns the plan id the producer
        threads through its spans/measurement."""
        pid = _new_id()
        with self._lock:
            self._ledger[pid] = {
                "plan_id": pid,
                "kind": str(kind),
                "predicted_us": None if predicted_us is None else float(predicted_us),
                "predicted_bytes": None if predicted_bytes is None else float(predicted_bytes),
                "digest": digest,
                "unit": str(unit),
                "detail": detail,
                "ts": time.time(),
                "measured_us": None,
                "measured_bytes": None,
                "divergence": None,
            }
            while len(self._ledger) > self.depth:
                self._ledger.popitem(last=False)
            self._predicted += 1
            k = self._by_kind.setdefault(
                str(kind), {"predictions": 0, "matched": 0, "divergence": None}
            )
            k["predictions"] += 1
        if self.registry is not None:
            self.registry.counter("cost_model_predictions_total").inc()
        return pid

    def record_measurement(self, plan_id, measured_us: Optional[float] = None,
                           measured_bytes: Optional[float] = None) -> Optional[float]:
        """Join a measured outcome to its prediction.  Returns the
        divergence ratio ``max(m/p, p/m)`` when both sides are µs-priced
        and positive, else None.  Unknown/expired plan ids are ignored —
        the ring is bounded and the producer may outlive it."""
        if plan_id is None:
            return None
        ratio = None
        with self._lock:
            rec = self._ledger.get(plan_id)
            if rec is None:
                return None
            first = rec["measured_us"] is None and rec["measured_bytes"] is None
            rec["measured_us"] = None if measured_us is None else float(measured_us)
            rec["measured_bytes"] = (
                None if measured_bytes is None else float(measured_bytes)
            )
            if first:
                self._matched += 1
                self._by_kind[rec["kind"]]["matched"] += 1
            p, m = rec["predicted_us"], rec["measured_us"]
            if rec["unit"] == "bytes":  # byte-denominated (AOT memory budget)
                p, m = rec["predicted_bytes"], rec["measured_bytes"]
            if rec["unit"] in ("us", "bytes") and p and m and p > 0 and m > 0:
                ratio = max(m / p, p / m)
                rec["divergence"] = ratio
                self._divergence = self._fold(self._divergence, ratio)
                k = self._by_kind[rec["kind"]]
                k["divergence"] = self._fold(k["divergence"], ratio)
        if self.registry is not None:
            self.registry.counter("cost_model_matched_total").inc()
        return ratio

    def _fold(self, mean: Optional[float], ratio: float) -> float:
        """Decayed running mean of divergence ratios (same decay constant
        the calibration harvest uses)."""
        if mean is None:
            return float(ratio)
        a = min(1.0, max(0.0, self.decay))
        return mean + a * (ratio - mean)

    # ------------------------------------------------------------- auditor
    def audit_step(self, kind: Optional[str] = None) -> Optional[Dict]:
        """The per-step join: harvest fresh tagged spans, publish the
        divergence gauges (which the timeseries sample taken right after
        and the ``cost-model-drift`` rule read), and return the summary
        dict for the steps.jsonl ``cost_audit`` field — None when nothing
        has ever been priced or harvested (the jsonl line stays
        bit-identical to an un-audited run)."""
        if self.harvest_spans:
            self.harvest(None)
        with self._lock:
            predicted, matched = self._predicted, self._matched
            overall = self._divergence
            by_kind = {
                k: dict(v) for k, v in self._by_kind.items()
            }
            harvested = self._harvested
        if predicted == 0 and harvested == 0:
            return None
        reg = self.registry
        if reg is not None:
            if overall is not None:
                reg.gauge("cost_model_divergence").set(overall)
            for k, v in by_kind.items():
                if v["divergence"] is not None:
                    reg.gauge(f"cost_model_divergence_{k}").set(v["divergence"])
            reg.gauge("cost_model_unmatched").set(predicted - matched)
        out: Dict[str, Any] = {
            "predictions": predicted,
            "matched": matched,
            "divergence": overall,
            "harvested_spans": harvested,
        }
        if by_kind:
            out["by_kind"] = by_kind
        return out

    # -------------------------------------------------- online calibration
    def harvest(self, spans=None) -> int:
        """Fold tagged spans into the active CalibrationTable with the
        decayed running mean, note per-bucket divergence against the
        table's prior estimate, and persist atomically on cadence to the
        ``VESCALE_COST_CALIBRATION`` path.  ``spans=None`` peeks the live
        ndtimeline ring (high-water-marked by span start time, so repeated
        peeks never double-ingest).  Returns samples absorbed."""
        from ..ndtimeline import api as _nd
        from . import calibrate as _cal

        if spans is None:
            if not _nd.is_active():
                return 0
            spans = _nd.get_manager().tail(4096)
        fresh = []
        for s in spans:
            tags = getattr(s, "tags", None) or {}
            if not all(t in tags for t in _cal.SPAN_TAGS):
                continue
            start = float(getattr(s, "start", 0.0) or 0.0)
            if start <= self._harvest_hwm:
                continue
            fresh.append((start, s, tags))
        if not fresh:
            return 0
        hwm = max(f[0] for f in fresh)
        table = _cal.active_table()
        if table is None:
            self._harvest_hwm = hwm
            return 0
        old_digest = table.digest() if len(table) else None
        n = 0
        for _, s, tags in fresh:
            try:
                op = str(tags["collective_op"])
                ax = int(tags["axis_size"])
                nb = int(tags["bytes"])
                dur = float(s.duration)
            except (TypeError, ValueError):
                continue
            prior = table.lookup_us(op, ax, nb)
            table.add_sample(op, ax, nb, dur, decay=self.decay)
            us = dur * 1e6
            if prior and prior > 0 and us > 0:
                self._note_bucket(op, ax, nb, max(us / prior, prior / us))
            n += 1
        self._harvest_hwm = hwm
        if n == 0:
            return 0
        with self._lock:
            self._harvested += n
        reg = self.registry
        if reg is not None:
            reg.counter("cost_model_harvested_spans_total").inc(n)
        if old_digest is not None and table.digest() != old_digest:
            self._digest_rotations += 1
            if reg is not None:
                reg.counter("cost_model_digest_rotations_total").inc()
        self._maybe_persist(table)
        return n

    def _note_bucket(self, op: str, axis_size: int, nbytes: int, ratio: float) -> None:
        from .calibrate import _bucket

        key = (op, int(axis_size), _bucket(nbytes))
        cell = self._bucket_div.get(key)
        if cell is None:
            self._bucket_div[key] = {"ratio": float(ratio), "samples": 1}
        else:
            cell["ratio"] = self._fold(cell["ratio"], ratio)
            cell["samples"] += 1

    def _maybe_persist(self, table) -> None:
        from .. import config as envreg

        path = envreg.get_str("VESCALE_COST_CALIBRATION")
        if not path:
            return
        now = time.monotonic()
        if now - self._last_persist < self.cadence_s:
            return
        try:
            table.save(path)  # atomic (tmp + os.replace) since the audit PR
            self._last_persist = now
            if self.registry is not None:
                self.registry.counter("cost_model_table_persists_total").inc()
        except OSError:
            pass  # a read-only path must not fail a step

    def persist_now(self, path: Optional[str] = None) -> Optional[str]:
        """Cadence-bypassing persist (shutdown flush / test hook)."""
        from . import calibrate as _cal
        from .. import config as envreg

        table = _cal.active_table()
        target = path or envreg.get_str("VESCALE_COST_CALIBRATION")
        if table is None or not target:
            return None
        try:
            table.save(target)
        except OSError:
            return None
        self._last_persist = time.monotonic()
        return target

    # ------------------------------------------------------------ readouts
    def bucket_divergence(self) -> Dict[Tuple[str, int, int], Dict[str, float]]:
        """Audit history per (op, axis_size, byte bucket) — the what-if
        scorer's confidence input."""
        with self._lock:
            return {k: dict(v) for k, v in self._bucket_div.items()}

    def ledger(self) -> List[Dict]:
        with self._lock:
            return [dict(r) for r in self._ledger.values()]

    def summary(self) -> Dict[str, Any]:
        """The bench ``audit`` block: predicted-vs-measured rollup for the
        run's own plans."""
        with self._lock:
            return {
                "predictions": self._predicted,
                "matched": self._matched,
                "divergence": self._divergence,
                "by_kind": {k: dict(v) for k, v in self._by_kind.items()},
                "harvested_spans": self._harvested,
                "digest_rotations": self._digest_rotations,
                "ledger_depth": len(self._ledger),
            }


# ------------------------------------------------------------- activation
_AUDIT: Optional[CostAudit] = None


def _active_record_prediction(kind, predicted_us=None, predicted_bytes=None,
                              digest=None, unit="us", detail=None):
    a = _AUDIT
    if a is None:
        return None
    return a.record_prediction(kind, predicted_us=predicted_us,
                               predicted_bytes=predicted_bytes, digest=digest,
                               unit=unit, detail=detail)


def _active_record_measurement(plan_id, measured_us=None, measured_bytes=None):
    a = _AUDIT
    if a is None:
        return None
    return a.record_measurement(plan_id, measured_us=measured_us,
                                measured_bytes=measured_bytes)


def _active_audit_step(kind=None):
    a = _AUDIT
    if a is None:
        return None
    return a.audit_step(kind)


def _active_harvest(spans=None):
    a = _AUDIT
    if a is None:
        return 0
    return a.harvest(spans)


def costaudit_rule_pack(threshold: float = 3.0) -> List:
    """The ``cost-model-drift`` rule: sustained predicted-vs-measured
    divergence beyond ``threshold`` (a ratio — 3.0 means the cost model is
    off by 3x in either direction) over the gauge the auditor publishes
    every step.  Self-healing context rides in the message: online
    recalibration rotates the digest, so a firing rule that later resolves
    means the table corrected itself."""
    from .alerts import ThresholdRule

    return [
        ThresholdRule(
            "cost-model-drift", "cost_model_divergence", ">", float(threshold),
            window_s=60.0, reducer="last", for_s=0.0, severity="warning",
            message=(
                "cost model predictions diverge from measured outcomes by "
                f"more than {threshold:g}x (decayed mean of max(m/p, p/m)); "
                "online recalibration is folding measured spans back into "
                "the calibration table — sustained firing means the spans "
                "the planner prices are not the spans it produces"
            ),
        )
    ]


def activate(registry=None, *, depth: Optional[int] = None,
             threshold: Optional[float] = None, decay: Optional[float] = None,
             cadence_s: Optional[float] = None,
             harvest_spans: Optional[bool] = None) -> CostAudit:
    """Swap the live hooks in (telemetry.init's job; knobs default to the
    ``VESCALE_COSTAUDIT_*`` knobs) and arm the drift rule when the
    alert engine is live."""
    global _AUDIT, record_prediction, record_measurement, audit_step, harvest
    from .. import config as envreg

    a = CostAudit(
        registry,
        depth=depth if depth is not None else envreg.get_int("VESCALE_COSTAUDIT_DEPTH"),
        threshold=(threshold if threshold is not None
                   else envreg.get_float("VESCALE_COSTAUDIT_THRESHOLD")),
        decay=decay if decay is not None else envreg.get_float("VESCALE_COSTAUDIT_DECAY"),
        cadence_s=(cadence_s if cadence_s is not None
                   else envreg.get_float("VESCALE_COSTAUDIT_CADENCE_S")),
        harvest_spans=(harvest_spans if harvest_spans is not None
                       else envreg.get_bool("VESCALE_COSTAUDIT_HARVEST")),
    )
    _AUDIT = a
    record_prediction = _active_record_prediction
    record_measurement = _active_record_measurement
    audit_step = _active_audit_step
    harvest = _active_harvest
    from . import alerts as _alerts

    eng = _alerts.get_engine()
    if eng is not None:
        eng.arm_pack("costaudit", costaudit_rule_pack(a.threshold))
    return a


def deactivate() -> None:
    """Restore the dormant no-op hooks (telemetry.shutdown's job)."""
    global _AUDIT, record_prediction, record_measurement, audit_step, harvest
    _AUDIT = None
    record_prediction = _noop_record_prediction
    record_measurement = _noop_record_measurement
    audit_step = _noop_audit_step
    harvest = _noop_harvest


def is_active() -> bool:
    return _AUDIT is not None


def get_auditor() -> Optional[CostAudit]:
    return _AUDIT


def audit_summary() -> Optional[Dict]:
    """Module-level summary (bench's audit block); None while dormant."""
    a = _AUDIT
    return a.summary() if a is not None else None


# ----------------------------------------------- per-layer roofline model
# The reference reads optimized HLO: each op's bytes are its output plus
# its operands, FLOPs are counted for dot/convolution only, as
# 2 * lhs_elems * out_last_dim, and the layer is the first two model-scope
# segments of its op_name.  The port applies the same rules to each aten
# op of one run of the step, and keys the layer by the first two segments
# of the nn.Module path the op ran in: forward pre-hooks give the path in
# the forward, and the autograd node being executed gives it in the
# backward (the forward hooks note each node's layer by its sequence
# number, which is unique on the forward's thread: a node's Python
# wrapper and its ``metadata`` need not outlive the walk that tags it).  A
# hand-written kernel launches through ctypes, where no dispatch mode sees
# it: its wrapper adds its own ``cost`` (the counts ``chip_smoke.py``'s
# bounds divide by) and the ops inside the wrapper (the plain version's,
# on the CPU) are not counted.  XLA fuses where aten does not, so bytes
# differ from the reference's by construction; matmul FLOPs do not.

# aten matmuls and the argument index of their lhs
_MATMUL_LHS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1, "addbmm": 1, "convolution": 0}


def device_mem_gbps(device) -> float:
    """Device memory bandwidth (GB/s) of one card — the roofline's memory
    roof: 3350 for an H100 SXM (HBM3, the figure ``chip_smoke.py``'s bounds
    use), 2000 for an H100 PCIe; anything else gets a host-DRAM ballpark so
    a CPU rig still classifies rather than dividing by an unknown."""
    import torch

    try:
        dev = torch.device(device) if not isinstance(device, int) else torch.device("cuda", device)
    except (TypeError, RuntimeError):
        return 50.0
    if dev.type == "cuda" and torch.cuda.is_available():
        name = torch.cuda.get_device_name(dev)
        if "H100" in name:
            return 2000.0 if "PCIe" in name else 3350.0
    return 50.0


def _tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _aliases(outs, ins) -> bool:
    """Whether an output shares its storage with an input."""
    held = {t.untyped_storage().data_ptr() for t in ins if t.numel()}
    return any(t.numel() and t.untyped_storage().data_ptr() in held for t in outs)


class LayerAttribution:
    """Context manager that attributes FLOPs and bytes of everything run
    inside it to the layers of ``model`` (an ``nn.Module``, or None to key
    every op by its own name).  ``layers`` holds the raw per-layer sums;
    :meth:`summary` classifies them (:func:`summarize_attribution`)."""

    def __init__(self, model=None):
        self.model = model
        self.layers: Dict[str, Dict[str, float]] = {}
        self._stack: List[Tuple[str, int]] = []  # (layer, first sequence nr)
        self._node_layer: Dict[int, str] = {}  # autograd sequence nr -> layer
        self._hooks: List[Any] = []
        self._inside_kernel = 0
        self._internal = False
        self._mode = None

    # ----------------------------------------------------------- layers
    def _acc(self, layer: str) -> Dict[str, float]:
        return self.layers.setdefault(layer, {"flops": 0.0, "bytes": 0.0, "ops": 0,
                                              "matmul_flops": 0.0, "kernel_flops": 0.0,
                                              "kernels": 0})

    def _current(self, fallback: str) -> str:
        import torch

        node = torch._C._current_autograd_node()
        if node is not None:  # the backward: the layer that made the node;
            # a node made outside every module is keyed as its op is
            return self._node_layer.get(node._sequence_nr(), fallback)
        if self._stack:
            return self._stack[-1][0]
        return fallback

    def _seq_now(self) -> int:
        """The autograd sequence number the next node will take."""
        import torch

        self._internal = True
        try:
            with torch.enable_grad():
                probe = torch.empty(0, requires_grad=True).view(0)
            return probe.grad_fn._sequence_nr()
        finally:
            self._internal = False

    def _pre_hook(self, layer):
        def hook(module, args):
            self._stack.append((layer, self._seq_now()))
        return hook

    def _post_hook(self, layer):
        def hook(module, args, output):
            _, first = self._stack.pop()
            self._tag(output, layer, first)
        return hook

    def _tag(self, output, layer: str, first: int) -> None:
        """Note the layer of every autograd node this module's forward made
        (sequence number >= ``first``) that no inner module noted."""
        todo = [t.grad_fn for t in _tensors(output) if t.grad_fn is not None]
        seen = set()
        while todo:
            node = todo.pop()
            if node is None or "AccumulateGrad" in node.name():
                continue
            seq = node._sequence_nr()
            if seq < first or seq in seen:
                continue
            seen.add(seq)
            self._node_layer.setdefault(seq, layer)
            todo.extend(nxt for nxt, _ in node.next_functions)

    # ----------------------------------------------------------- counting
    def op(self, func, args, kwargs, out) -> None:
        if self._inside_kernel or self._internal or func.is_view:
            return
        if func.namespace == "vtt":  # a kernel's custom op: its wrapper's cost counts
            return
        outs = list(_tensors(out))
        if not outs:
            return
        ins = list(_tensors((args, kwargs)))
        if not func._schema.is_mutable and _aliases(outs, ins):
            return  # a view by another name (``_unsafe_view``): no bytes move
        name = func.overloadpacket.__name__
        acc = self._acc(self._current(name))
        nbytes = sum(_nbytes(t) for t in outs) + sum(_nbytes(t) for t in ins)
        flops = 0.0
        lhs_at = _MATMUL_LHS.get(name)
        if lhs_at is not None and len(args) > lhs_at:
            last = outs[0].shape[-1] if outs[0].dim() else 1
            flops = 2.0 * args[lhs_at].numel() * max(1, int(last))
        acc["flops"] += flops
        acc["matmul_flops"] += flops
        acc["bytes"] += nbytes
        acc["ops"] += 1

    def kernel(self, name: str, cost, fn, args, kwargs):
        """Run a kernel wrapper: add its ``cost`` (flops, bytes) to the
        current layer and count none of the ops inside it."""
        if self._inside_kernel:
            return fn(*args, **kwargs)
        flops, nbytes = cost
        acc = self._acc(self._current(name))
        acc["flops"] += float(flops)
        acc["kernel_flops"] += float(flops)
        acc["bytes"] += float(nbytes)
        acc["ops"] += 1
        acc["kernels"] += 1
        self._inside_kernel += 1
        try:
            return fn(*args, **kwargs)
        finally:
            self._inside_kernel -= 1

    # ------------------------------------------------------------ gating
    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        from .. import kernels as _kernels

        attr = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                attr.op(func, args, kwargs, out)
                return out

        if self.model is not None:
            for path, mod in self.model.named_modules():
                if not path:
                    continue
                layer = "/".join(path.split(".")[:2])
                self._hooks.append(mod.register_forward_pre_hook(self._pre_hook(layer)))
                self._hooks.append(mod.register_forward_hook(self._post_hook(layer)))
        if _kernels.COST_SINK is not None:
            raise RuntimeError("a layer attribution is already running")
        _kernels.COST_SINK = self
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        from .. import kernels as _kernels

        self._mode.__exit__(*exc)
        self._mode = None
        _kernels.COST_SINK = None
        for h in self._hooks:
            h.remove()
        self._hooks.clear()
        self._stack.clear()
        return False

    def summary(self, device=None, peak_flops: Optional[float] = None,
                mem_gbps: Optional[float] = None) -> Dict[str, Any]:
        return summarize_attribution(self.layers, device=device, peak_flops=peak_flops,
                                     mem_gbps=mem_gbps)


def summarize_attribution(per_layer: Dict[str, Dict[str, float]], device=None,
                          peak_flops: Optional[float] = None,
                          mem_gbps: Optional[float] = None) -> Dict[str, Any]:
    """Classify raw per-layer sums against the roofline of ``device`` (the
    card by default, the CPU without one): the reference's result, plus
    each layer's ``matmul_flops`` (aten matmuls), ``kernel_flops`` and
    ``kernels`` (hand-written kernel launches)."""
    import torch

    if peak_flops is None or mem_gbps is None:
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if torch.cuda.is_available() else torch.device("cpu"))
        from . import calibrate as _cal

        if peak_flops is None:
            peak_flops = _cal.device_peak_flops(device)
        if mem_gbps is None:
            mem_gbps = device_mem_gbps(device)
    bw = float(mem_gbps) * 1e9
    ridge = float(peak_flops) / bw
    layers = []
    total_flops = total_bytes = 0.0
    for layer, acc in per_layer.items():
        total_flops += acc["flops"]
        total_bytes += acc["bytes"]
        intensity = acc["flops"] / acc["bytes"] if acc["bytes"] else 0.0
        layers.append({
            "layer": layer,
            "flops": acc["flops"],
            "bytes": acc["bytes"],
            "ops": int(acc["ops"]),
            "intensity": intensity,
            "bound": "compute" if intensity > ridge else "memory",
            "est_us": max(acc["flops"] / peak_flops, acc["bytes"] / bw) * 1e6,
            "matmul_flops": acc["matmul_flops"],
            "kernel_flops": acc["kernel_flops"],
            "kernels": int(acc["kernels"]),
        })
    layers.sort(key=lambda r: (-r["est_us"], r["layer"]))
    return {
        "layers": layers,
        "ridge_flops_per_byte": ridge,
        "peak_flops": float(peak_flops),
        "mem_gbps": float(mem_gbps),
        "total_flops": total_flops,
        "total_bytes": total_bytes,
    }


def layer_attribution(fn, *args, model=None, device=None, peak_flops: Optional[float] = None,
                      mem_gbps: Optional[float] = None, **kwargs) -> Dict[str, Any]:
    """Per-layer FLOPs/bytes attribution of one call ``fn(*args,
    **kwargs)``, classified compute- or memory-bound against the card's
    roofline.  ``model``: the module whose layers key the result (default
    ``fn.model``, which ``train.make_train_step``'s step carries).  The call
    runs for real: a train step steps its optimizer.

    Returns ``{"layers": [{layer, flops, bytes, ops, intensity, bound,
    est_us, matmul_flops, kernel_flops, kernels}...] (est_us-descending),
    "ridge_flops_per_byte", "peak_flops", "mem_gbps", "total_flops",
    "total_bytes"}``."""
    if model is None:
        model = getattr(fn, "model", None)
    with LayerAttribution(model) as att:
        fn(*args, **kwargs)
    return att.summary(device=device, peak_flops=peak_flops, mem_gbps=mem_gbps)


def roofline_counter_events(attribution: Dict, pid: int = 0,
                            ts0: float = 0.0) -> List[Dict]:
    """Chrome-trace ``C`` (counter) events rendering the attribution as
    per-layer roofline tracks: one ``roofline:<layer>`` counter per layer,
    laid out sequentially by estimated time so the track reads as a
    time-weighted layer walk."""
    evs = []
    ts = float(ts0)
    for lay in attribution.get("layers", ()):
        evs.append({
            "ph": "C", "pid": int(pid), "ts": ts,
            "name": f"roofline:{lay['layer']}",
            "args": {
                "est_us": round(lay["est_us"], 3),
                "flops_per_byte": round(lay["intensity"], 3),
                "bound": 1.0 if lay["bound"] == "compute" else 0.0,
            },
        })
        ts += max(1.0, lay["est_us"])
    return evs


def attach_roofline_tracks(perfetto_path: str, attribution: Dict,
                           pid: int = 0) -> int:
    """Append the roofline counter tracks to an existing Perfetto JSON
    trace (atomically), starting after its last event.  Returns the number
    of counter events added."""
    with open(perfetto_path) as f:
        data = json.load(f)
    evs = data.setdefault("traceEvents", [])
    ts0 = 0.0
    for e in evs:
        if isinstance(e, dict):
            ts0 = max(ts0, float(e.get("ts", 0) or 0) + float(e.get("dur", 0) or 0))
    added = roofline_counter_events(attribution, pid=pid, ts0=ts0)
    evs.extend(added)
    tmp = perfetto_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f)
    os.replace(tmp, perfetto_path)
    return len(added)


# -------------------------------------------------------- what-if scoring
def mesh_candidates(num_devices: int) -> List[Tuple[int, int, int]]:
    """Every (dp, tp, pp) factorization of ``num_devices``."""
    out = []
    n = max(1, int(num_devices))
    for dp in range(1, n + 1):
        if n % dp:
            continue
        rest = n // dp
        for tp in range(1, rest + 1):
            if rest % tp:
                continue
            out.append((dp, tp, rest // tp))
    return out


def score_candidates(candidates: Sequence[Tuple[int, int, int]], *, params_bytes: float,
                     activation_bytes: float, flops_per_step: float, table=None, device=None,
                     auditor: Optional[CostAudit] = None) -> List[Dict]:
    """Re-price candidate (dp, tp, pp) meshes against the audited table:
    a predicted step time each (compute at ``device``'s peak, the card
    unless ``device="cpu"``, plus the collectives the layout implies) and
    a confidence from the decayed divergence of exactly the buckets it
    reads: 0.25 for an analytic term, 0.5 for a measured bucket never
    audited, ``1/ratio`` for an audited one.  Ranked by predicted step."""
    from .. import collectives as C
    from ..device import resolve_device
    from . import calibrate as _cal

    if table is None:
        table = _cal.active_table()
    if auditor is None:
        auditor = _AUDIT
    peak = _cal.device_peak_flops(resolve_device(device))
    bdiv = auditor.bucket_divergence() if auditor is not None else {}
    usable = table is not None and len(table) > 0
    results = []
    for dp, tp, pp in candidates:
        world = max(1, dp * tp * pp)
        compute_us = float(flops_per_step) / world / peak * 1e6
        terms: List[Tuple[str, int, float]] = []
        if dp > 1:  # the data-parallel gradient reduction
            terms.append(("all_reduce", dp, float(params_bytes) / max(1, tp * pp)))
        if tp > 1:  # the tensor-parallel activation gather and grad scatter
            shard = float(activation_bytes) / tp
            terms.append(("all_gather", tp, shard))
            terms.append(("reduce_scatter", tp, shard))
        if pp > 1:  # the stage-boundary p2p per microbatch wave
            terms.append(("ppermute", pp, float(activation_bytes)))
        comm_us = 0.0
        notes, scores = [], []
        for op, ax, nb in terms:
            us = table.lookup_us(op, ax, int(nb)) if usable else None
            if us is None:
                us = C.analytic_cost_us(op, nb / 1e9, ax)
                source, score = "analytic", 0.25
            else:
                d = bdiv.get((op, ax, _cal._bucket(int(nb))))
                if d is None:
                    source, score = "measured", 0.5
                else:
                    source = "audited"
                    score = max(0.0, min(1.0, 1.0 / max(1.0, d["ratio"])))
            comm_us += us
            scores.append(score)
            notes.append({"op": op, "axis_size": ax, "bytes": int(nb), "us": us,
                          "source": source})
        results.append({
            "mesh": {"dp": dp, "tp": tp, "pp": pp},
            "predicted_step_us": compute_us + comm_us,
            "compute_us": compute_us,
            "comm_us": comm_us,
            "confidence": sum(scores) / len(scores) if scores else 1.0,
            "terms": notes,
        })
    results.sort(key=lambda r: r["predicted_step_us"])
    return results
