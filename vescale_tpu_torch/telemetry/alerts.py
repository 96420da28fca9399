"""Declarative SLO alerting over the time-series store — ONE lifecycle for
every watcher in the repo.

The port of ``vescale_tpu/telemetry/alerts.py``: the engine, its rules,
``payload``/``digest`` and the serve, train and fleet packs (the fleet
pack watches a ``FleetRouter``'s ``fleet_timeline_*`` gauges).  The bench
pack is not ported: its gauge is one only the JAX package's bench sets.

Before this module each watcher invented its own one-shot warn path
(memtrack's leak ``warnings.warn``, the AOT-drift warning, the calibration
staleness ``_warn_once``, the watchdog's stderr print, the straggler
detector's silent report).  Now there is one engine with one lifecycle —

    ok -> pending -> firing -> resolved (-> ok)

— and every transition emits the SAME three signals: a ``record_event``
line on steps.jsonl, an ndtimeline ``alert`` span (firings render on the
merged Perfetto fleet timeline next to the step/request spans that caused
them), and registry counters (``alerts_fired_total`` + per-rule).  The
``/alerts`` ops endpoint serves :func:`payload` (FROZEN schema v1 —
``ALERTS_FIELDS``, the ROUTER_FIELDS contract: fields only ever added).

Rule grammar (docs/observability.md "Alerting"):

  * :class:`ThresholdRule` — ``reduce(metric, window_s, reducer) OP
    threshold``, held ``for_s`` seconds before firing (pending in
    between).
  * :class:`BurnRateRule` — the SRE multi-window multi-burn-rate
    formulation over an error-budget spec: burn(window) =
    avg(metric over window) / slo; the rule fires when BOTH the long and
    the short window of any configured (long_s, short_s, factor) pair
    burn faster than ``factor`` (the short window gates alert RESET —
    a long window alone would keep paging hours after recovery).
  * :class:`TrendRule` — least-squares slope per second over a window
    crosses a limit (queue-depth growth, page-pool drain, mem growth).
  * :class:`ZScoreRule` — |latest - window mean| / window std exceeds z
    (loss anomalies, grad-norm spikes) with a ``min_samples`` floor.
  * :class:`ManualRule` — code-driven: :func:`raise_alert` /
    :func:`resolve` walk the same lifecycle for watchers whose condition
    lives outside the store (watchdog stall, stale calibration table,
    AOT drift).

Gating contract (memtrack precedent): dormant hooks ``evaluate`` /
``raise_alert`` / ``resolve`` ARE the module no-op references (identity-
asserted).  The dormant ``raise_alert`` degrades to the legacy one-shot
``warnings.warn`` (once per rule name per process) so un-instrumented
runs still surface watcher signals — that latch is THE sanctioned
warn-once path (lint VSC207 flags any other).
"""

from __future__ import annotations

import collections
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "ALERTS_SCHEMA_VERSION",
    "ALERTS_FIELDS",
    "SEVERITIES",
    "Rule",
    "ThresholdRule",
    "BurnRateRule",
    "TrendRule",
    "ZScoreRule",
    "ManualRule",
    "AlertEngine",
    "activate",
    "deactivate",
    "is_active",
    "get_engine",
    "evaluate",
    "raise_alert",
    "resolve",
    "payload",
    "digest",
    "serve_rule_pack",
    "train_rule_pack",
    "fleet_rule_pack",
    "burn_windows_from_env",
    "clear_fallback_warned",
]

ALERTS_SCHEMA_VERSION = 1
# the frozen /alerts v1 field set (ROUTER_FIELDS contract: only ever ADD)
ALERTS_FIELDS = frozenset(
    (
        "schema_version",
        "active",
        "rules",
        "firing",
        "pending",
        "history",
        "counts",
        "uptime_s",
    )
)
# per-rule row of the /alerts feed (frozen with the outer schema)
ALERTS_RULE_FIELDS = frozenset(
    (
        "kind",
        "severity",
        "state",
        "since_s",
        "value",
        "message",
        "fired_count",
    )
)

SEVERITIES = ("info", "warning", "critical")

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


# -------------------------------------------------------------------- rules
class Rule:
    """Base declarative rule: subclasses implement :meth:`condition`
    returning ``(condition_holds, observed_value)`` over the store.

    ``for_s`` holds the rule PENDING that long before firing;
    ``resolve_for_s`` is the symmetric hysteresis on the way down — a
    firing rule must stay below threshold that long before ok-ing (the
    anti-flap hold consumers like the autoscaler key off: a noisy burn
    signal that dips for one sample must not read as recovered)."""

    kind = "rule"

    def __init__(self, name: str, severity: str = "warning",
                 message: str = "", for_s: float = 0.0,
                 resolve_for_s: float = 0.0):
        if severity not in SEVERITIES:
            raise ValueError(f"rule {name!r}: severity must be one of {SEVERITIES}")
        if for_s < 0:
            raise ValueError(f"rule {name!r}: for_s must be >= 0")
        if resolve_for_s < 0:
            raise ValueError(f"rule {name!r}: resolve_for_s must be >= 0")
        self.name = name
        self.severity = severity
        self.message = message
        self.for_s = float(for_s)
        self.resolve_for_s = float(resolve_for_s)

    def condition(self, store, now: float) -> Tuple[bool, Optional[float]]:
        raise NotImplementedError


class ThresholdRule(Rule):
    """``reduce(metric, window_s, reducer) OP threshold`` held ``for_s``."""

    kind = "threshold"

    def __init__(self, name: str, metric: str, op: str, threshold: float,
                 window_s: float = 60.0, reducer: str = "last",
                 for_s: float = 0.0, severity: str = "warning",
                 message: str = "", resolve_for_s: float = 0.0):
        super().__init__(name, severity=severity, message=message, for_s=for_s,
                         resolve_for_s=resolve_for_s)
        if op not in _OPS:
            raise ValueError(f"rule {name!r}: op must be one of {sorted(_OPS)}")
        self.metric = metric
        self.op = op
        self.threshold = float(threshold)
        self.window_s = float(window_s)
        self.reducer = reducer

    def condition(self, store, now: float) -> Tuple[bool, Optional[float]]:
        v = store.reduce(self.metric, self.window_s, self.reducer, now=now)
        if v is None:
            return False, None
        return _OPS[self.op](v, self.threshold), v


class BurnRateRule(Rule):
    """Multi-window multi-burn-rate SLO rule (the SRE formulation).

    ``burn(window) = avg(metric over window) / slo`` — for a latency SLO
    the metric is a percentile series (``serve_ttft_seconds:p99``) and the
    slo is the budget in the same unit; burn 1.0 means exactly spending
    budget, burn N means exhausting it N times faster.  ``windows`` is a
    sequence of ``(long_s, short_s, factor)`` pairs; the rule's condition
    holds when ANY pair has BOTH windows burning above its factor (the
    short window makes the alert reset promptly after recovery)."""

    kind = "burn_rate"

    def __init__(self, name: str, metric: str, slo: float,
                 windows: Sequence[Tuple[float, float, float]] = (
                     (3600.0, 300.0, 14.4),
                     (21600.0, 1800.0, 6.0),
                 ),
                 for_s: float = 0.0, severity: str = "critical",
                 message: str = "", resolve_for_s: float = 0.0):
        super().__init__(name, severity=severity, message=message, for_s=for_s,
                         resolve_for_s=resolve_for_s)
        if slo <= 0:
            raise ValueError(f"rule {name!r}: slo must be > 0, got {slo}")
        if not windows:
            raise ValueError(f"rule {name!r}: need at least one window pair")
        self.metric = metric
        self.slo = float(slo)
        self.windows = tuple((float(l), float(s), float(f)) for l, s, f in windows)

    def burn(self, store, span_s: float, now: float) -> Optional[float]:
        v = store.reduce(self.metric, span_s, "avg", now=now)
        return None if v is None else v / self.slo

    def condition(self, store, now: float) -> Tuple[bool, Optional[float]]:
        worst: Optional[float] = None
        hold = False
        for long_s, short_s, factor in self.windows:
            bl = self.burn(store, long_s, now)
            bs = self.burn(store, short_s, now)
            for b in (bl, bs):
                if b is not None and (worst is None or b > worst):
                    worst = b
            if bl is not None and bs is not None and bl > factor and bs > factor:
                hold = True
        return hold, worst


class TrendRule(Rule):
    """Least-squares slope per second over ``window_s`` beyond a limit.
    ``direction="up"`` fires on slope > ``slope_per_s``; ``"down"`` on
    slope < ``-slope_per_s`` (pass the magnitude, not a signed value)."""

    kind = "trend"

    def __init__(self, name: str, metric: str, slope_per_s: float,
                 window_s: float = 120.0, direction: str = "up",
                 min_samples: int = 4, for_s: float = 0.0,
                 severity: str = "warning", message: str = "",
                 resolve_for_s: float = 0.0):
        super().__init__(name, severity=severity, message=message, for_s=for_s,
                         resolve_for_s=resolve_for_s)
        if direction not in ("up", "down"):
            raise ValueError(f"rule {name!r}: direction must be 'up' or 'down'")
        if slope_per_s <= 0:
            raise ValueError(f"rule {name!r}: slope_per_s is a magnitude, > 0")
        self.metric = metric
        self.slope_per_s = float(slope_per_s)
        self.window_s = float(window_s)
        self.direction = direction
        self.min_samples = int(min_samples)

    def condition(self, store, now: float) -> Tuple[bool, Optional[float]]:
        win = store.window(self.metric, self.window_s, now=now)
        if len(win) < self.min_samples:
            return False, None
        from .timeseries import _reduce_samples

        slope = _reduce_samples(win, "slope")
        if slope is None:
            return False, None
        if self.direction == "up":
            return slope > self.slope_per_s, slope
        return slope < -self.slope_per_s, slope


class ZScoreRule(Rule):
    """|latest - window mean| / window std exceeds ``z`` — the anomaly
    shape (loss spikes, grad-norm blowups).  Needs ``min_samples`` in the
    window and a non-degenerate std; ``direction`` limits which side
    counts (``"up"``/``"down"``/``"both"``)."""

    kind = "zscore"

    def __init__(self, name: str, metric: str, z: float = 4.0,
                 window_s: float = 300.0, min_samples: int = 8,
                 direction: str = "both", for_s: float = 0.0,
                 severity: str = "warning", message: str = "",
                 resolve_for_s: float = 0.0):
        super().__init__(name, severity=severity, message=message, for_s=for_s,
                         resolve_for_s=resolve_for_s)
        if direction not in ("up", "down", "both"):
            raise ValueError(f"rule {name!r}: bad direction {direction!r}")
        self.metric = metric
        self.z = float(z)
        self.window_s = float(window_s)
        self.min_samples = int(min_samples)
        self.direction = direction

    def condition(self, store, now: float) -> Tuple[bool, Optional[float]]:
        win = store.window(self.metric, self.window_s, now=now)
        if len(win) < self.min_samples:
            return False, None
        vals = [v for _, v in win]
        latest = vals[-1]
        base = vals[:-1]  # the latest sample must not dilute its own baseline
        mean = sum(base) / len(base)
        var = sum((v - mean) ** 2 for v in base) / len(base)
        std = var ** 0.5
        if std <= 1e-12:
            return False, 0.0
        score = (latest - mean) / std
        if self.direction == "up":
            return score > self.z, score
        if self.direction == "down":
            return score < -self.z, score
        return abs(score) > self.z, score


class ManualRule(Rule):
    """Code-driven rule: :func:`raise_alert`/:func:`resolve` flip it.  The
    migration target for watchers whose condition lives outside the store
    (watchdog stall, stale calibration table, AOT drift)."""

    kind = "manual"

    def __init__(self, name: str, severity: str = "warning", message: str = ""):
        super().__init__(name, severity=severity, message=message, for_s=0.0)
        self.raised = False
        self.raised_value: Optional[float] = None

    def condition(self, store, now: float) -> Tuple[bool, Optional[float]]:
        return self.raised, self.raised_value


# ------------------------------------------------------------------- engine
class AlertEngine:
    """Rules + lifecycle states + the bounded transition-history ring
    (created ONLY by ``telemetry.init(alerts=True)``; its absence IS the
    off state)."""

    def __init__(self, store=None, history: int = 256,
                 min_eval_interval_s: float = 0.0):
        self.store = store
        self.history: "collections.deque" = collections.deque(maxlen=history)
        self.rules: Dict[str, Rule] = {}
        self._states: Dict[str, Dict] = {}
        self._packs: set = set()
        self._lock = threading.RLock()
        self.min_eval_interval_s = float(min_eval_interval_s)
        self._last_eval = 0.0
        self._start = time.time()
        self.counts = {"fired": 0, "resolved": 0, "pending": 0, "evaluations": 0}

    # ------------------------------------------------------------ rule mgmt
    def add_rule(self, rule: Rule) -> Rule:
        """Register (or replace — same name) one rule; its lifecycle state
        starts at ``ok``."""
        with self._lock:
            self.rules[rule.name] = rule
            self._states.setdefault(
                rule.name,
                {"state": "ok", "since": time.time(), "value": None,
                 "message": rule.message, "fired_count": 0},
            )
        return rule

    def arm_pack(self, pack: str, rules: Sequence[Rule]) -> bool:
        """Idempotently install a named rule pack (the serve loop re-arms
        on every construction; only the first arm installs)."""
        with self._lock:
            if pack in self._packs:
                return False
            self._packs.add(pack)
            for r in rules:
                self.add_rule(r)
            return True

    def state_of(self, name: str) -> Optional[Dict]:
        with self._lock:
            st = self._states.get(name)
            return dict(st) if st is not None else None

    def firing(self) -> List[str]:
        with self._lock:
            return sorted(n for n, s in self._states.items()
                          if s["state"] == "firing")

    def pending(self) -> List[str]:
        with self._lock:
            return sorted(n for n, s in self._states.items()
                          if s["state"] == "pending")

    # ------------------------------------------------------------ lifecycle
    def _transition(self, rule: Rule, st: Dict, new_state: str, now: float,
                    value: Optional[float], message: str) -> Dict:
        """One lifecycle edge: dedup is the caller's job (same-state calls
        never reach here).  Emits the event line, the span, the counters,
        and appends the bounded history entry."""
        old = st["state"]
        fired_at = st.get("fired_at")
        st["state"] = new_state
        st["since"] = now
        st["value"] = value
        st["message"] = message or rule.message
        if new_state == "firing":
            st["fired_at"] = now
            st["fired_count"] += 1
        rec = {
            "rule": rule.name,
            "kind": rule.kind,
            "severity": rule.severity,
            "from": old,
            "to": new_state,
            "ts": now,
            "value": value,
            "message": st["message"],
        }
        self.history.append(rec)
        self._emit(rule, rec, fired_at, now)
        return rec

    def _emit(self, rule: Rule, rec: Dict, fired_at: Optional[float],
              now: float) -> None:
        from . import api as _tel

        to = rec["to"]
        if to == "pending":
            self.counts["pending"] += 1
            _tel.count("alerts_pending_total")
        elif to == "firing":
            self.counts["fired"] += 1
            _tel.count("alerts_fired_total")
            _tel.count(f"alerts_fired_total_{_safe(rule.name)}")
        elif rec["from"] == "firing":  # firing -> ok IS the resolve edge
            self.counts["resolved"] += 1
            _tel.count("alerts_resolved_total")
            _tel.count(f"alerts_resolved_total_{_safe(rule.name)}")
        _tel.set_gauge("alerts_firing", float(len(self.firing())))
        # per-rule state gauge for the prom export: 0 ok / 1 pending /
        # 2 firing — a scraper's view of the lifecycle without JSON
        _tel.set_gauge(f"alerts_state_{_safe(rule.name)}",
                       {"ok": 0.0, "pending": 1.0, "firing": 2.0}[to])
        _tel.record_event(
            "alert",
            rule=rec["rule"],
            severity=rec["severity"],
            transition=f"{rec['from']}->{to}",
            value=rec["value"],
            message=rec["message"],
        )
        self._emit_span(rule, rec, fired_at, now)

    def _emit_span(self, rule: Rule, rec: Dict, fired_at: Optional[float],
                   now: float) -> None:
        """The timeline presence: a point span at each transition, plus —
        on resolve — one span COVERING the firing episode, so Perfetto
        shows the alert as a bar spanning exactly the degraded region of
        the step/request lanes under it."""
        from ..ndtimeline import api as _nd

        if not _nd.is_active():
            return
        from ..ndtimeline.predefined import ALERT

        mgr = _nd.get_manager()
        tags = {
            "rule": rec["rule"],
            "severity": rec["severity"],
            "transition": f"{rec['from']}->{rec['to']}",
            "value": rec["value"],
        }
        # stamp with the step that JUST finished — the loops advance the
        # profiler counter before record_step() evaluates us, so the
        # counter already names the (empty) next step; the newest buffered
        # span's step is the finished step (step_span_summary's own rule)
        tail = mgr.tail(1)
        step = tail[-1].step if tail else mgr.step
        mgr.record(ALERT, now, 0.0, tags=tags, step=step)
        if rec["from"] == "firing" and fired_at is not None:
            mgr.record(
                ALERT,
                fired_at,
                max(0.0, now - fired_at),
                tags={**tags, "episode": rec["rule"]},
                step=step,
            )

    def evaluate(self, now: Optional[float] = None) -> List[Dict]:
        """Walk every rule's condition over the store and advance the
        lifecycles.  Returns the transitions this call produced (empty on
        quiet evaluations and rate-limited calls)."""
        now = time.time() if now is None else now
        out: List[Dict] = []
        with self._lock:
            if self.min_eval_interval_s > 0 and \
                    (now - self._last_eval) < self.min_eval_interval_s:
                return out
            self._last_eval = now
            self.counts["evaluations"] += 1
            for name, rule in list(self.rules.items()):
                st = self._states[name]
                try:
                    hold, value = (
                        rule.condition(self.store, now)
                        if self.store is not None or rule.kind == "manual"
                        else (False, None)
                    )
                except Exception:  # a broken rule must not kill the loop
                    hold, value = False, None
                cur = st["state"]
                if hold:
                    if cur == "ok":
                        if rule.for_s > 0:
                            st["pending_since"] = now
                            out.append(self._transition(
                                rule, st, "pending", now, value, rule.message))
                        else:
                            out.append(self._transition(
                                rule, st, "firing", now, value, rule.message))
                    elif cur == "pending":
                        if (now - st.get("pending_since", now)) >= rule.for_s:
                            out.append(self._transition(
                                rule, st, "firing", now, value, rule.message))
                        else:
                            st["value"] = value
                    else:  # already firing: dedup, just refresh the value
                        # re-holding resets the resolve hysteresis clock
                        st.pop("below_since", None)
                        st["value"] = value
                else:
                    if cur == "pending":
                        out.append(self._transition(
                            rule, st, "ok", now, value, rule.message))
                    elif cur == "firing":
                        # resolve_for_s hysteresis: the rule must stay
                        # below threshold that long before the resolve
                        # edge — one quiet sample must not un-page
                        if rule.resolve_for_s > 0:
                            below = st.setdefault("below_since", now)
                            if (now - below) < rule.resolve_for_s:
                                st["value"] = value
                                continue
                        st.pop("below_since", None)
                        out.append(self._transition(
                            rule, st, "ok", now, value, rule.message))
        return out

    # ------------------------------------------------------- manual alerts
    def raise_alert(self, name: str, message: str = "",
                    severity: str = "warning",
                    value: Optional[float] = None) -> Optional[Dict]:
        """Fire (or refresh) a :class:`ManualRule` NOW — no store, no
        evaluate() round trip; the watchdog's stall must not wait for the
        next poll.  Deduped: raising an already-firing alert only updates
        its value/message."""
        now = time.time()
        with self._lock:
            rule = self.rules.get(name)
            if rule is None:
                rule = self.add_rule(ManualRule(name, severity=severity,
                                                message=message))
            if not isinstance(rule, ManualRule):
                raise TypeError(
                    f"alert {name!r} is a declarative {rule.kind} rule; "
                    "raise_alert only drives manual rules"
                )
            rule.raised = True
            rule.raised_value = value
            st = self._states[name]
            if st["state"] == "firing":
                st["value"] = value
                if message:
                    st["message"] = message
                return None
            return self._transition(rule, st, "firing", now, value,
                                    message or rule.message)

    def resolve(self, name: str, message: str = "") -> Optional[Dict]:
        """Resolve a manual alert (no-op when unknown or not firing)."""
        now = time.time()
        with self._lock:
            rule = self.rules.get(name)
            if rule is None or not isinstance(rule, ManualRule):
                return None
            rule.raised = False
            st = self._states[name]
            if st["state"] not in ("pending", "firing"):
                return None
            return self._transition(rule, st, "ok", now, rule.raised_value,
                                    message or rule.message)

    # ------------------------------------------------------------- payload
    def snapshot(self) -> Dict:
        """The `/alerts` body — FROZEN schema v1 (``ALERTS_FIELDS``)."""
        now = time.time()
        with self._lock:
            rules = {}
            for name, rule in self.rules.items():
                st = self._states[name]
                row = {
                    "kind": rule.kind,
                    "severity": rule.severity,
                    "state": st["state"],
                    "since_s": round(now - st["since"], 6),
                    "value": st["value"],
                    "message": st["message"],
                    "fired_count": st["fired_count"],
                }
                assert set(row) == ALERTS_RULE_FIELDS  # frozen at source
                rules[name] = row
            out = {
                "schema_version": ALERTS_SCHEMA_VERSION,
                "active": True,
                "rules": rules,
                "firing": sorted(n for n, s in self._states.items()
                                 if s["state"] == "firing"),
                "pending": sorted(n for n, s in self._states.items()
                                  if s["state"] == "pending"),
                "history": list(self.history)[-64:],
                "counts": dict(self.counts),
                "uptime_s": round(now - self._start, 6),
            }
        assert set(out) == ALERTS_FIELDS  # the freeze, enforced at source
        return out


def _safe(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


# --------------------------------------------------------------- gate flips
_ENGINE: Optional[AlertEngine] = None

# legacy fallback latch — THE one sanctioned warn-once path (VSC207 exempts
# this module); keyed by rule name, cleared by clear_fallback_warned()
_FALLBACK_WARNED: set = set()
_FALLBACK_LOCK = threading.Lock()


def clear_fallback_warned() -> None:
    """Reset the dormant-mode warn-once latch (tests)."""
    with _FALLBACK_LOCK:
        _FALLBACK_WARNED.clear()


# These ARE the module's public hooks while dormant (identity-asserted).
# The dormant raise_alert keeps the legacy operator signal: one
# warnings.warn per rule name per process, so a watcher tripping without
# telemetry still prints SOMETHING.
def _noop_evaluate(now: Optional[float] = None) -> List[Dict]:
    return []


def _fallback_raise_alert(name: str, message: str = "",
                          severity: str = "warning",
                          value: Optional[float] = None) -> None:
    with _FALLBACK_LOCK:
        if name in _FALLBACK_WARNED:
            return None
        _FALLBACK_WARNED.add(name)
    warnings.warn(f"[alert:{name}] {message}" if message else f"[alert:{name}]",
                  stacklevel=3)
    return None


def _noop_resolve(name: str, message: str = "") -> None:
    return None


evaluate = _noop_evaluate
raise_alert = _fallback_raise_alert
resolve = _noop_resolve


def is_active() -> bool:
    return _ENGINE is not None


def get_engine() -> Optional[AlertEngine]:
    return _ENGINE


def activate(store=None, history: int = 256,
             min_eval_interval_s: float = 0.0) -> AlertEngine:
    """Create the engine and bind the live hooks (called by
    ``telemetry.init``; do not call directly unless you know why)."""
    global _ENGINE, evaluate, raise_alert, resolve
    _ENGINE = AlertEngine(store=store, history=history,
                          min_eval_interval_s=min_eval_interval_s)
    evaluate = _ENGINE.evaluate
    raise_alert = _ENGINE.raise_alert
    resolve = _ENGINE.resolve
    return _ENGINE


def deactivate() -> None:
    """Drop the engine and restore the dormant hook references."""
    global _ENGINE, evaluate, raise_alert, resolve
    _ENGINE = None
    evaluate = _noop_evaluate
    raise_alert = _fallback_raise_alert
    resolve = _noop_resolve


def payload() -> Dict:
    """The `/alerts` endpoint provider — works DORMANT (a probe must not
    require a metrics pipeline): same frozen schema, ``active: false``."""
    eng = _ENGINE
    if eng is not None:
        return eng.snapshot()
    out = {
        "schema_version": ALERTS_SCHEMA_VERSION,
        "active": False,
        "rules": {},
        "firing": [],
        "pending": [],
        "history": [],
        "counts": {"fired": 0, "resolved": 0, "pending": 0, "evaluations": 0},
        "uptime_s": 0.0,
    }
    assert set(out) == ALERTS_FIELDS
    return out


def digest() -> Dict:
    """The inline alert summary the `/router` (v4) and `/fleet` (v3)
    feeds carry: ``{"active", "firing", "pending"}`` — sorted rule names
    only, no states/history (that is `/alerts`).  Dormant-safe."""
    eng = _ENGINE
    if eng is None:
        return {"active": False, "firing": [], "pending": []}
    return {"active": True, "firing": eng.firing(), "pending": eng.pending()}


# --------------------------------------------------------------- rule packs
def burn_windows_from_env() -> Optional[Sequence[Tuple[float, float, float]]]:
    """Parse ``VESCALE_ALERTS_BURN_WINDOWS`` — ``"long:short:factor"``
    triples, comma-separated (seconds, seconds, burn multiple), e.g.
    ``"3600:300:14.4,21600:1800:6"``.  None when unset; a malformed value
    raises (a silently-dropped paging rule is worse than a crash at
    arm time)."""
    from .. import config as envreg

    raw = envreg.get_str("VESCALE_ALERTS_BURN_WINDOWS")
    if not raw:
        return None
    out = []
    for part in raw.split(","):
        pieces = part.strip().split(":")
        if len(pieces) != 3:
            raise ValueError(
                f"VESCALE_ALERTS_BURN_WINDOWS: expected long:short:factor, got {part!r}"
            )
        long_s, short_s, factor = (float(p) for p in pieces)
        out.append((long_s, short_s, factor))
    return tuple(out)


def _burn_for_s_from_env() -> float:
    from .. import config as envreg

    return envreg.get_float("VESCALE_ALERTS_BURN_FOR_S") or 0.0


def serve_rule_pack(slo_ttft_s: Optional[float] = None,
                    burn_windows: Optional[Sequence[Tuple[float, float, float]]] = None,
                    burn_for_s: Optional[float] = None,
                    ) -> List[Rule]:
    """The default serve-replica pack (armed by ``run_serve_resilient``
    when the engine is live).  The burn-rate rule needs a TTFT SLO — with
    ``slo_ttft_s`` unset/0 it is omitted (the rest still arm).
    ``burn_windows``/``burn_for_s`` default from the
    ``VESCALE_ALERTS_BURN_WINDOWS`` / ``VESCALE_ALERTS_BURN_FOR_S`` knobs
    (then the Google-SRE pairs / 0)."""
    rules: List[Rule] = [
        ThresholdRule(
            "serve-shed-rate", "serve_shed_rate", ">", 0.1,
            window_s=60.0, reducer="avg", for_s=0.0, severity="warning",
            message="admission control is shedding >10% of submissions",
        ),
        TrendRule(
            "serve-queue-depth-trend", "serve_queue_depth", slope_per_s=0.5,
            window_s=120.0, direction="up", severity="warning",
            message="request queue depth growing — demand exceeds decode capacity",
        ),
        ThresholdRule(
            "serve-goodput-collapse", "serve_goodput_fraction", "<", 0.5,
            window_s=120.0, reducer="avg", for_s=0.0, severity="critical",
            message="less than half of sampled tokens reach completed requests",
        ),
        TrendRule(
            "serve-page-pool-drain", "serve_free_pages", slope_per_s=0.2,
            window_s=120.0, direction="down", severity="warning",
            message="KV page pool draining — exhaustion (and eviction storms) ahead",
        ),
    ]
    if slo_ttft_s:
        rules.insert(0, BurnRateRule(
            "serve-ttft-slo-burn", "serve_ttft_seconds:p99", float(slo_ttft_s),
            windows=(burn_windows or burn_windows_from_env()
                     or ((3600.0, 300.0, 14.4), (21600.0, 1800.0, 6.0))),
            for_s=burn_for_s if burn_for_s is not None else _burn_for_s_from_env(),
            severity="critical",
            message="p99 TTFT burning the SLO error budget across both windows",
        ))
    return rules


def train_rule_pack() -> List[Rule]:
    """The default train-loop pack (armed by ``train.py`` when the engine
    is live)."""
    return [
        ZScoreRule(
            "train-loss-anomaly", "train_loss", z=6.0, window_s=600.0,
            min_samples=16, direction="up", severity="critical",
            message="loss spiked beyond 6 sigma of its recent window",
        ),
        ZScoreRule(
            "train-grad-norm-spike", "train_grad_norm", z=6.0, window_s=600.0,
            min_samples=16, direction="up", severity="warning",
            message="gradient norm spiked beyond 6 sigma of its recent window",
        ),
        TrendRule(
            "train-step-time-regression", "train_step_time_seconds:p50",
            slope_per_s=0.001, window_s=600.0, direction="up",
            severity="warning",
            message="median step time trending up — throughput regression",
        ),
        TrendRule(
            "train-mem-growth", "mem_tag_untagged_bytes", slope_per_s=1024.0,
            window_s=600.0, direction="up", severity="warning",
            message="untagged live-array bytes trending up — possible leak",
        ),
    ]


def fleet_rule_pack(slo_ttft_s: Optional[float] = None,
                    burn_windows: Optional[Sequence[Tuple[float, float, float]]] = None,
                    burn_for_s: Optional[float] = None,
                    ) -> List[Rule]:
    """The router-side pack: fleet-scope rules over the AGGREGATED
    ``fleet_timeline_*`` gauges FleetObservability publishes — a
    fleet-wide SLO burn fires here even when every replica looks healthy
    alone."""
    rules: List[Rule] = [
        ThresholdRule(
            "fleet-shed-rate", "fleet_timeline_shed_rate", ">", 0.1,
            window_s=60.0, reducer="avg", severity="warning",
            message="fleet-wide shed rate above 10%",
        ),
        ThresholdRule(
            "fleet-no-healthy-replicas", "fleet_timeline_healthy_replicas",
            "<", 1.0, window_s=30.0, reducer="last", severity="critical",
            message="no dispatchable replica left in the fleet",
        ),
    ]
    if slo_ttft_s:
        rules.insert(0, BurnRateRule(
            "fleet-ttft-slo-burn", "fleet_timeline_ttft_p99_s",
            float(slo_ttft_s),
            windows=(burn_windows or burn_windows_from_env()
                     or ((3600.0, 300.0, 14.4), (21600.0, 1800.0, 6.0))),
            for_s=burn_for_s if burn_for_s is not None else _burn_for_s_from_env(),
            severity="critical",
            message="fleet p99 TTFT burning the SLO error budget across both windows",
        ))
    return rules
