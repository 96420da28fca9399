"""Serve-replica observability: goodput and MFU accounting, and the
``/healthz`` and ``/router`` providers.

The port of ``ServeObservability`` and ``FleetObservability`` from
``vescale_tpu/serve/obs.py``.  A ``ServeObservability`` per
``run_serve_resilient`` call:

  * **goodput against raw throughput**: ``serve_goodput_tokens_per_s``
    counts only tokens of COMPLETED requests, ``serve_throughput_tokens_per_s``
    every sampled token; the gap is the work spent on evicted, timed-out
    and drained requests.
  * **serve MFU**: ``ServeEngine.decode_flops_per_step`` over the measured
    step wall over the card's dense bf16 peak (``device.peak_bf16_flops``:
    989 TFLOP/s on an H100 SXM), published per decode step as the
    ``serve_mfu`` gauge; None on the CPU and while speculation is on (the
    step then is no single-token decode).
  * **the ``/router`` feed**, FROZEN at schema v5 (``ROUTER_FIELDS``, the
    JAX package's field set, asserted at the source): the port's and the
    reference's fleet routers poll it.  ``rollout`` is the loop's live weight-rollout state
    (``None`` outside a rollout), and ``accepting`` is false while a
    rollout holds admission.  ``alerts`` (on ``/router`` and ``/healthz``)
    is the alert engine's digest (``telemetry.alerts.digest``).
  * **the calibrated step estimate** (``calibrated_step_estimate``): the
    decode step priced from the active calibration table, the scheduler's
    cold-start ``retry_after_s`` seed.

A ``FleetObservability`` per ``FleetRouter`` rolls the cached replica feeds,
breaker states and ledger into the ``/fleet`` feed (frozen at schema v5,
``FLEET_FIELDS``), the router's ``/healthz`` and the ``fleet_timeline_*``
gauges the fleet rule pack and the autoscaler read.

Everything here is host-side arithmetic: the providers run on the ops
thread and make no CUDA call.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from .. import config as _config

__all__ = [
    "ServeObservability",
    "FleetObservability",
    "ROUTER_SCHEMA_VERSION",
    "ROUTER_FIELDS",
    "FLEET_SCHEMA_VERSION",
    "FLEET_FIELDS",
    "FLEET_FIELDS_V2",
    "FLEET_FIELDS_V3",
    "FLEET_FIELDS_V4",
    "FLEET_REPLICA_FIELDS",
    "FLEET_REPLICA_FIELDS_V1",
    "FLEET_REPLICA_FIELDS_V2",
]

ROUTER_SCHEMA_VERSION = 5
# v1, then the additive deltas of v2 (replica_id, accepting), v3
# (prefix_hit_rate, spec_accept_rate), v4 (alerts) and v5 (tenants, rollout)
ROUTER_FIELDS = frozenset((
    "schema_version", "rank", "draining", "queue_depth", "inflight", "slots", "free_slots",
    "pages", "free_pages", "ttft_s", "itl_s", "shed_rate", "retry_after_s",
    "goodput_tokens_per_s", "throughput_tokens_per_s", "mfu", "decode_steps", "serve_step",
    "uptime_s",
    "replica_id", "accepting",
    "prefix_hit_rate", "spec_accept_rate",
    "alerts",
    "tenants", "rollout",
))

# the router-side ``/fleet`` rollup, frozen under the same contract as
# ROUTER_FIELDS (fields only ever added; the JAX package's sets).  v2 is the
# first frozen set; v3 adds the router's own alert digest, v4 the aggregate
# queue depth, the per-tenant rollup and the autoscaler's state, v5 the
# router HA block (null while journaling is off)
FLEET_SCHEMA_VERSION = 5
FLEET_FIELDS_V2 = frozenset((
    "schema_version", "healthy_replicas", "pending_requests", "counts", "replicas",
    "breaker_transitions", "goodput_tokens_per_s", "throughput_tokens_per_s", "mfu",
    "ttft_p99_s", "shed_rate", "slo_ttft_s", "slo_burn_rate", "uptime_s",
))
FLEET_FIELDS_V3 = FLEET_FIELDS_V2 | frozenset(("alerts",))
FLEET_FIELDS_V4 = FLEET_FIELDS_V3 | frozenset(("queue_depth", "tenants", "autoscale"))
FLEET_FIELDS = FLEET_FIELDS_V4 | frozenset(("ha",))
# one replica's row of ``/fleet``: v2 passes the /router v3 cache-warmth
# columns through, v3 the replica's live rollout state (/router v5)
FLEET_REPLICA_FIELDS_V1 = frozenset((
    "breaker", "accepting", "queue_depth", "inflight", "shed_rate", "goodput_tokens_per_s",
    "throughput_tokens_per_s", "mfu", "serve_step", "dispatches", "opens", "reopens", "closes",
))
FLEET_REPLICA_FIELDS_V2 = FLEET_REPLICA_FIELDS_V1 | frozenset(("prefix_hit_rate",
                                                               "spec_accept_rate"))
FLEET_REPLICA_FIELDS = FLEET_REPLICA_FIELDS_V2 | frozenset(("rollout",))

def _alerts_digest() -> Dict:
    """The inline alert summary every feed carries (dormant-safe)."""
    from ..telemetry import alerts as _alerts

    return _alerts.digest()


def _pcts(hist) -> Dict[str, Optional[float]]:
    return {"p50": hist.percentile(0.5), "p95": hist.percentile(0.95), "p99": hist.percentile(0.99)}


class ServeObservability:
    """Derived rates and endpoint providers for one serve loop."""

    def __init__(self, scheduler, engine=None, watchdog=None, rank: int = 0,
                 replica_id: Optional[str] = None, speculative=None):
        self.scheduler = scheduler
        self.engine = engine
        self.watchdog = watchdog
        self.speculative = speculative
        self.rank = int(rank)
        # stable fleet identity: the argument, else the knob, else the rank
        self.replica_id = (replica_id or _config.get_str("VESCALE_SERVE_REPLICA_ID")
                           or f"rank{self.rank}")
        self.draining = False  # the loop sets it; /healthz reports it
        # the loop's reload machine sets it: None outside a rollout, else
        # {"state", "checkpoint", "detail"} (passed through on /router)
        self.rollout: Optional[Dict] = None
        self.serve_step = 0
        self.decode_steps = 0
        self._start = time.perf_counter()
        self._last_decode: Optional[float] = None
        self._last_mfu: Optional[float] = None
        # both read here, on the serving thread, once; an engine without a
        # FLOP count or a device publishes no MFU
        flops = getattr(engine, "decode_flops_per_step", None)
        self._flops = flops() if flops is not None else None
        self._peak = self._peak_flops()

    # ------------------------------------------------------------- rates
    def _peak_flops(self) -> Optional[float]:
        """The card's bf16 peak (``calibrate.device_peak_flops``); None
        without a CUDA engine, so the CPU publishes no MFU."""
        import torch

        device = getattr(self.engine, "device", None)
        if device is None or torch.device(device).type != "cuda":
            return None
        from ..telemetry.calibrate import device_peak_flops

        return device_peak_flops(device)

    def calibrated_step_estimate(self) -> Optional[float]:
        """Decode-step seconds priced from the calibration table, or None
        without one: measured ``serve_decode`` buckets when the table has
        them (harvested from a prior run's tagged decode spans), else the
        engine's decode FLOPs over the table's measured ``matmul_gflops``."""
        from ..telemetry.calibrate import active_table

        t = active_table()
        if t is None:
            return None
        us = t.op_estimate_us("serve_decode")
        if us is not None:
            return float(us) / 1e6
        g = t.meta.get("matmul_gflops")
        if not g or not self._flops:
            return None
        return float(self._flops) / (float(g) * 1e9)

    def on_decode_step(self, step: int, dt_s: float, active: int) -> None:
        """Per decode step: advance the rate clocks and publish the goodput,
        throughput, shed, free-page and MFU gauges."""
        self.decode_steps += 1
        self.serve_step = int(step)
        self._last_decode = time.perf_counter()
        sched = self.scheduler
        tel = sched.telemetry
        up = max(1e-9, self._last_decode - self._start)
        goodput = sched.goodput_tokens / up
        raw = sched.raw_tokens / up
        tel.set_gauge("serve_goodput_tokens_per_s", goodput)
        tel.set_gauge("serve_throughput_tokens_per_s", raw)
        tel.set_gauge("serve_shed_rate", sched.counts["shed"] / max(1, sched.counts["submitted"]))
        tel.set_gauge("serve_goodput_fraction", goodput / raw if raw > 0 else 1.0)
        tel.set_gauge("serve_free_pages", sched.cache.free_page_count())
        if self.speculative is None and self._flops and self._peak and dt_s > 0:
            self._last_mfu = self._flops / dt_s / self._peak
            tel.set_gauge("serve_mfu", self._last_mfu)

    # --------------------------------------------------------- providers
    def health(self) -> Dict:
        """``/healthz``: alive and making progress? The watchdog's view
        (last-beat age), the decode loop's (last-step age), and headroom."""
        sched = self.scheduler
        cache = sched.cache
        now = time.perf_counter()
        wd = self.watchdog
        return {
            "ok": not self.draining,
            "draining": self.draining,
            "replica_id": self.replica_id,
            "shedding": sched.currently_shedding(),
            "retry_after_s": sched.retry_after_s(),
            "serve_step": self.serve_step,
            "decode_steps": self.decode_steps,
            "queue_depth": len(sched.queue),
            "inflight": len(sched.active),
            "free_slots": cache.free_slot_count(),
            "free_pages": cache.free_page_count(),
            "watchdog_last_beat_age_s": round(wd.stalled_s, 6) if wd is not None else None,
            "last_decode_step_age_s": (
                round(now - self._last_decode, 6) if self._last_decode is not None else None
            ),
            "uptime_s": round(now - self._start, 6),
            "wall_time_us": int(time.time() * 1e6),
            "alerts": _alerts_digest(),
        }

    def router(self) -> Dict:
        """``/router``: the dispatch feed, frozen schema v5."""
        sched = self.scheduler
        cache = sched.cache
        up = max(1e-9, time.perf_counter() - self._start)
        submitted = max(1, sched.counts["submitted"])
        prefix = sched.prefix
        spec = self.speculative
        ro = self.rollout
        rollout_busy = ro is not None and ro.get("state") in (
            "draining", "baseline", "swapping", "canary")
        out = {
            "schema_version": ROUTER_SCHEMA_VERSION,
            "rank": self.rank,
            "replica_id": self.replica_id,
            "draining": self.draining,
            # false while draining, while admission would shed, or while a
            # rollout holds admission
            "accepting": (not self.draining and not rollout_busy
                          and sched.currently_shedding() is None),
            "queue_depth": len(sched.queue),
            "inflight": len(sched.active),
            "slots": cache.num_slots,
            "free_slots": cache.free_slot_count(),
            "pages": cache.num_pages - 1,  # page 0 is the reserved null page
            "free_pages": cache.free_page_count(),
            "ttft_s": _pcts(sched._ttft),
            "itl_s": _pcts(sched._itl),
            "shed_rate": sched.counts["shed"] / submitted,
            "retry_after_s": sched.retry_after_s(),
            "goodput_tokens_per_s": sched.goodput_tokens / up,
            "throughput_tokens_per_s": sched.raw_tokens / up,
            "mfu": self._last_mfu,
            "decode_steps": self.decode_steps,
            "serve_step": self.serve_step,
            "uptime_s": round(up, 6),
            # null (never 0.0) while the multiplier is off or has no samples
            "prefix_hit_rate": prefix.stats.hit_rate() if prefix is not None else None,
            "spec_accept_rate": spec.accept_rate() if spec is not None else None,
            "alerts": _alerts_digest(),
            "tenants": sched.tenant_stats(),
            "rollout": self.rollout,
        }
        assert set(out) == ROUTER_FIELDS  # the freeze, enforced at the source
        return out


class FleetObservability:
    """Fleet-scope health rollups over a :class:`~.router.FleetRouter`'s
    cached replica feeds, breaker states and ledger — the router-side
    twin of :class:`ServeObservability`.

    Owns the numbers no single replica can answer: aggregate goodput and
    throughput (sums over feeds), fleet MFU (throughput-weighted mean),
    the fleet p99 TTFT (worst replica — the tail a client actually
    sees), per-replica shed rates, the breaker state-transition history,
    and the p99-TTFT **SLO burn rate** (fleet p99 / SLO budget: > 1
    means the fleet is currently burning error budget; sustained > 1 is
    the page).  Served three ways: the ``/fleet`` ops endpoint (frozen
    schema ``FLEET_FIELDS``), the ``fleet_timeline_*`` registry gauges
    (the ``fleet-timeline:`` dashboard block), and the router process's
    own ``/metrics``.  Everything works with telemetry dormant — gauges
    are simply skipped (the ServeObservability contract)."""

    def __init__(self, router, slo_ttft_s: Optional[float] = None):
        self.router = router
        if slo_ttft_s is None:
            slo_ttft_s = _config.get_float("VESCALE_SERVE_SLO_TTFT_S") or 0.0
        self.slo_ttft_s = float(slo_ttft_s)
        # serve.autoscale.Autoscaler attaches its state callable here so
        # /fleet v4 carries the control loop's view (null until attached)
        self.autoscale_provider = None
        # FleetRouter wires its _ha_state here when a journal/lease is
        # attached so /fleet v5 carries leadership + journal health
        self.ha_provider = None
        self._start = time.perf_counter()

    # ------------------------------------------------------------ rollups
    def _rollup(self) -> Dict:
        feeds = {
            h.id: h.feed for h in self.router.replicas.values() if h.feed is not None
        }
        goodput = sum(float(f.get("goodput_tokens_per_s") or 0.0) for f in feeds.values())
        raw = sum(float(f.get("throughput_tokens_per_s") or 0.0) for f in feeds.values())
        # fleet MFU: throughput-weighted mean over replicas reporting one
        # (equal weights when nothing has throughput yet)
        num = den = 0.0
        for f in feeds.values():
            mfu = f.get("mfu")
            if mfu is None:
                continue
            w = float(f.get("throughput_tokens_per_s") or 0.0) or 1.0
            num += float(mfu) * w
            den += w
        fleet_mfu = (num / den) if den else None
        p99s = [
            (f.get("ttft_s") or {}).get("p99")
            for f in feeds.values()
            if isinstance(f.get("ttft_s"), dict)
        ]
        p99s = [p for p in p99s if p is not None]
        ttft_p99 = max(p99s) if p99s else None
        burn = (
            ttft_p99 / self.slo_ttft_s
            if (self.slo_ttft_s > 0 and ttft_p99 is not None)
            else None
        )
        counts = self.router.ledger.counts
        shed_rate = counts["shed"] / max(1, counts["submitted"])
        # the autoscaler's load-trend input: work waiting ANYWHERE in the
        # fleet — router-pending plus every replica's local queue
        queue_depth = self.router.ledger.pending_count() + sum(
            int(f.get("queue_depth") or 0) for f in feeds.values()
        )
        # per-tenant stats summed across feeds (absent pre-v5 feeds -> {})
        tenants: Dict[str, Dict] = {}
        for f in feeds.values():
            for t, row in (f.get("tenants") or {}).items():
                agg = tenants.setdefault(
                    t, {"submitted": 0, "shed": 0, "completed": 0, "queue_depth": 0}
                )
                for k in agg:
                    agg[k] += int(row.get(k) or 0)
        return {
            "feeds": feeds,
            "goodput": goodput,
            "raw": raw,
            "mfu": fleet_mfu,
            "ttft_p99": ttft_p99,
            "burn": burn,
            "shed_rate": shed_rate,
            "queue_depth": queue_depth,
            "tenants": tenants,
        }

    def fleet(self) -> Dict:
        """`/fleet`: the aggregated fleet feed — FROZEN schema
        (``FLEET_FIELDS`` outer, ``FLEET_REPLICA_FIELDS`` per replica;
        fields only ever added, the ROUTER_FIELDS contract)."""
        r = self._rollup()
        replicas = {}
        for h in self.router.replicas.values():
            f = h.feed or {}
            row = {
                "breaker": h.breaker.state,
                "accepting": bool(f.get("accepting", not f.get("draining", False)))
                if f
                else False,
                "queue_depth": f.get("queue_depth"),
                "inflight": f.get("inflight"),
                "shed_rate": f.get("shed_rate"),
                "goodput_tokens_per_s": f.get("goodput_tokens_per_s"),
                "throughput_tokens_per_s": f.get("throughput_tokens_per_s"),
                "mfu": f.get("mfu"),
                "serve_step": f.get("serve_step"),
                "dispatches": h.dispatches,
                "opens": h.breaker.opens,
                "reopens": h.breaker.reopens,
                "closes": h.breaker.closes,
                # v2: the /router v3 cache-warmth columns, passed through
                # (absent from an old replica's v2 feed -> null)
                "prefix_hit_rate": f.get("prefix_hit_rate"),
                "spec_accept_rate": f.get("spec_accept_rate"),
                # v3: the replica's live rollout stage (/router v5)
                "rollout": f.get("rollout"),
            }
            assert set(row) == FLEET_REPLICA_FIELDS  # frozen at source
            replicas[h.id] = row
        out = {
            "schema_version": FLEET_SCHEMA_VERSION,
            "healthy_replicas": sum(
                1 for h in self.router.replicas.values() if h.breaker.dispatchable
            ),
            "pending_requests": self.router.ledger.pending_count(),
            "counts": dict(self.router.ledger.counts),
            "replicas": replicas,
            "breaker_transitions": list(self.router.breaker_transitions)[-64:],
            "goodput_tokens_per_s": r["goodput"],
            "throughput_tokens_per_s": r["raw"],
            "mfu": r["mfu"],
            "ttft_p99_s": r["ttft_p99"],
            "shed_rate": r["shed_rate"],
            "slo_ttft_s": self.slo_ttft_s,
            "slo_burn_rate": r["burn"],
            "uptime_s": round(time.perf_counter() - self._start, 6),
            # v3: the router process's own alert digest (fleet-scope rules)
            "alerts": _alerts_digest(),
            # v4: aggregate load, per-tenant rollup, autoscaler state
            "queue_depth": r["queue_depth"],
            "tenants": r["tenants"],
            "autoscale": (
                self.autoscale_provider() if self.autoscale_provider else None
            ),
            # v5: the router HA block (null while journaling is off)
            "ha": self.ha_provider() if self.ha_provider else None,
        }
        assert set(out) == FLEET_FIELDS  # the freeze, enforced at source
        return out

    def health(self) -> Dict:
        """Router-process `/healthz`: liveness + the wall clock the fleet
        clock sync samples (not frozen — the /fleet feed is the API)."""
        return {
            "ok": True,
            "role": "router",
            "replicas": len(self.router.replicas),
            "healthy_replicas": sum(
                1 for h in self.router.replicas.values() if h.breaker.dispatchable
            ),
            "pending_requests": self.router.ledger.pending_count(),
            "uptime_s": round(time.perf_counter() - self._start, 6),
            "wall_time_us": int(time.time() * 1e6),
            "alerts": _alerts_digest(),
        }

    def publish(self) -> None:
        """Push the rollups into the gated registry as ``fleet_timeline_*``
        gauges — the ``fleet-timeline:`` dashboard block.  No-op while
        telemetry is dormant."""
        from .. import telemetry as _tel

        if not _tel.is_active():
            return
        r = self._rollup()
        # the fleet rule pack's no-healthy-replicas input
        _tel.set_gauge(
            "fleet_timeline_healthy_replicas",
            sum(1 for h in self.router.replicas.values() if h.breaker.dispatchable),
        )
        _tel.set_gauge("fleet_timeline_goodput_tokens_per_s", r["goodput"])
        _tel.set_gauge("fleet_timeline_throughput_tokens_per_s", r["raw"])
        if r["mfu"] is not None:
            _tel.set_gauge("fleet_timeline_mfu", r["mfu"])
        if r["ttft_p99"] is not None:
            _tel.set_gauge("fleet_timeline_ttft_p99_s", r["ttft_p99"])
        if r["burn"] is not None:
            _tel.set_gauge("fleet_timeline_slo_burn_rate", r["burn"])
        _tel.set_gauge("fleet_timeline_shed_rate", r["shed_rate"])
        # the autoscaler's two control inputs, published every poll so
        # the time-series store can trend them: total queued work and the
        # dispatchable replica count it scales against
        _tel.set_gauge("fleet_timeline_queue_depth", r["queue_depth"])
        _tel.set_gauge(
            "fleet_timeline_replica_count", len(self.router.replicas)
        )
        for rid, f in r["feeds"].items():
            if f.get("shed_rate") is not None:
                _tel.set_gauge(f"fleet_timeline_shed_rate_{rid}", f["shed_rate"])
