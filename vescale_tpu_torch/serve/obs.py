"""Serve-replica observability: goodput and MFU accounting, and the
``/healthz`` and ``/router`` providers.

The port of ``ServeObservability`` from ``vescale_tpu/serve/obs.py``.  One
per ``run_serve_resilient`` call:

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
    JAX package's field set, asserted at the source): the reference fleet
    router polls it.  ``rollout`` is the loop's live weight-rollout state
    (``None`` outside a rollout), and ``accepting`` is false while a
    rollout holds admission.  ``alerts`` carries the engine's digest while
    it is off: the alert engine is not ported yet.

Everything here is host-side arithmetic: the providers run on the ops
thread and make no CUDA call.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from .. import config as _config
from ..device import peak_bf16_flops

__all__ = ["ServeObservability", "ROUTER_SCHEMA_VERSION", "ROUTER_FIELDS"]

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

# the alert engine's digest while it is off (the engine is not ported yet)
_ALERTS_DORMANT = {"active": False, "firing": [], "pending": []}


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
        device = getattr(engine, "device", None)
        self._peak = peak_bf16_flops(device) if device is not None else None

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
            "alerts": dict(_ALERTS_DORMANT),
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
            "alerts": dict(_ALERTS_DORMANT),
            "tenants": sched.tenant_stats(),
            "rollout": self.rollout,
        }
        assert set(out) == ROUTER_FIELDS  # the freeze, enforced at the source
        return out
