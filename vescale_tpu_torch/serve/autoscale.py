"""The fleet that operates itself: autoscaling + rolling weight rollout.

The port of ``vescale_tpu/serve/autoscale.py``.  Two router-side
controllers close the loop between the observability stack (the
time-series store, ``FleetObservability``) and the supervisor and router
actuators:

:class:`Autoscaler`
    A hysteresis control loop over the time-series store.  Each
    :meth:`~Autoscaler.tick` reads the ``fleet_timeline_slo_burn_rate``
    gauge (averaged over the decision window) and the
    ``fleet_timeline_queue_depth`` trend (slope over the same window);
    sustained overload past ``up_hold_s`` spawns a replica
    (``FleetSupervisor.spawn_like`` — fresh reserved port, elastic
    start-up in the child, router readmission through the
    existing breaker half-open probe), sustained underload past
    ``down_hold_s`` drains one (``FleetSupervisor.drain`` — clean
    SIGTERM; the replica finishes in-flight work, the router harvests
    its outcomes through the linger window, and the affinity ring
    re-homes its sessions when the dead replica is finally removed).
    Separate up/down thresholds, hold times, min/max bounds and a
    post-action cooldown keep the loop from flapping; with the
    time-series store dormant it falls back to the instantaneous
    ``FleetObservability`` rollup, so the loop still works un-instrumented.

:class:`RolloutController`
    The rolling weight rollout: hot-swap a new training checkpoint one
    replica at a time through the ``/control`` channel
    (``loop.ControlChannel``).  Each leg drains the replica, swaps
    params in-process (no restart, no recompile), and runs the canary
    stage — the pinned golden prompts replay twice through the fresh
    weights (bit-identical or it's a divergence; faultsim's
    ``canary_diverge`` flips one logit's sign to prove the tripwire)
    and, from the second replica on, must also match the first
    replica's streams exactly.  Two-phase commit: every replica parks
    its old tree until the whole fleet passes, so ONE divergence
    anywhere auto-rolls-back every already-swapped replica
    (``revert``), and only a clean sweep drops the old weights
    (``commit``).  Every stage lands as a ``fleet-rollout-stage`` span
    in the fleet timeline and a ``fleet_rollout_*`` event.

Both controllers are single-threaded and injectable-clock, like the
router they drive: a test ticks them with fake time and fake feeds and
gets deterministic decisions.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from .. import config as _config
from . import fleettrace

__all__ = ["Autoscaler", "RolloutController"]


class Autoscaler:
    """Router-side replica-count control loop (see module docstring).

    ``tick(now)`` is the whole API: call it from the same thread that
    pumps the router, as often as convenient — the decision window,
    hold times and cooldown make the cadence irrelevant.  All knobs
    fall back to ``VESCALE_AUTOSCALE_*`` env values, then defaults.

    Scale-up condition (must HOLD for ``up_hold_s``):
        burn-rate avg >= ``up_burn``  OR
        (queue depth >= ``up_queue`` AND queue-depth slope > 0)
    Scale-down condition (must hold for ``down_hold_s``):
        burn-rate avg <= ``down_burn`` (or no SLO configured)
        AND queue depth == 0
    Thresholds are deliberately asymmetric (``down_burn`` well under
    ``up_burn``): the band between them is the hysteresis dead zone
    where the fleet just stays put.
    """

    def __init__(
        self,
        router,
        supervisor,
        template_id: str,
        *,
        client_factory: Optional[Callable[[Any], Any]] = None,
        min_replicas: Optional[int] = None,
        max_replicas: Optional[int] = None,
        up_burn: Optional[float] = None,
        down_burn: Optional[float] = None,
        up_queue: Optional[int] = None,
        up_hold_s: Optional[float] = None,
        down_hold_s: Optional[float] = None,
        cooldown_s: Optional[float] = None,
        window_s: Optional[float] = None,
        tick_s: Optional[float] = None,
        now_fn: Callable[[], float] = time.monotonic,
    ):
        def _f(val, knob, default):
            if val is not None:
                return val
            v = _config.get_float(knob)
            return default if v is None else v

        def _i(val, knob, default):
            if val is not None:
                return int(val)
            v = _config.get_int(knob)
            return default if v is None else int(v)

        self.router = router
        self.supervisor = supervisor
        self.template_id = template_id
        if client_factory is None:
            from .router import HttpReplicaClient

            client_factory = lambda spec: HttpReplicaClient(spec.url)  # noqa: E731
        self.client_factory = client_factory
        self.min_replicas = _i(min_replicas, "VESCALE_AUTOSCALE_MIN", 1)
        self.max_replicas = _i(max_replicas, "VESCALE_AUTOSCALE_MAX", 4)
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"need 1 <= min ({self.min_replicas}) <= max ({self.max_replicas})"
            )
        self.up_burn = _f(up_burn, "VESCALE_AUTOSCALE_UP_BURN", 1.0)
        self.down_burn = _f(down_burn, "VESCALE_AUTOSCALE_DOWN_BURN", 0.5)
        self.up_queue = _i(up_queue, "VESCALE_AUTOSCALE_UP_QUEUE", 4)
        self.up_hold_s = _f(up_hold_s, "VESCALE_AUTOSCALE_UP_HOLD_S", 1.0)
        self.down_hold_s = _f(down_hold_s, "VESCALE_AUTOSCALE_DOWN_HOLD_S", 5.0)
        self.cooldown_s = _f(cooldown_s, "VESCALE_AUTOSCALE_COOLDOWN_S", 5.0)
        self.window_s = _f(window_s, "VESCALE_AUTOSCALE_WINDOW_S", 10.0)
        self.tick_s = _f(tick_s, "VESCALE_AUTOSCALE_TICK_S", 0.25)
        self._now = now_fn
        self._last_tick_at: Optional[float] = None
        self._over_since: Optional[float] = None
        self._under_since: Optional[float] = None
        self._last_action_at: Optional[float] = None
        self._draining: Dict[str, float] = {}  # victim -> drain start
        self.last_decision = "idle"
        self.last_signals: Dict[str, Optional[float]] = {}
        self.scale_ups = 0
        self.scale_downs = 0
        # /fleet v4 carries the controller's view once one is attached
        router.obs.autoscale_provider = self.state
        # the router's journal snapshots carry the control clocks (HA);
        # a router recovered from a journal hands them straight back
        router.autoscale_journal_provider = self.snapshot_state
        recovered = getattr(router, "recovered_autoscale_state", None)
        if recovered:
            self.restore_state(recovered)
            router.recovered_autoscale_state = None

    # ------------------------------------------------------------ signals
    def _signals(self) -> Dict[str, Optional[float]]:
        """The two control inputs: SLO burn (window average) and queue
        depth + its trend (window slope).  Time-series store first; the
        instantaneous FleetObservability rollup when it's dormant/thin."""
        from ..telemetry import timeseries as _ts

        burn = depth = slope = None
        store = _ts.get_store()
        if store is not None:
            burn = store.reduce("fleet_timeline_slo_burn_rate", self.window_s, "avg")
            depth = store.reduce("fleet_timeline_queue_depth", self.window_s, "last")
            slope = store.reduce("fleet_timeline_queue_depth", self.window_s, "slope")
        if burn is None or depth is None:
            r = self.router.obs._rollup()
            if burn is None:
                burn = r["burn"]
            if depth is None:
                depth = float(r["queue_depth"])
        return {"burn": burn, "queue_depth": depth, "queue_slope": slope}

    def _active_count(self) -> int:
        return len(self.router.replicas) - len(self._draining)

    # ------------------------------------------------------------ actions
    def _scale_up(self, now: float, sig: Dict) -> str:
        from .. import telemetry as _tel

        t0 = time.perf_counter()
        spec = self.supervisor.spawn_like(self.template_id)
        self.router.add_replica(spec.replica_id, self.client_factory(spec))
        self.scale_ups += 1
        self._last_action_at = now
        self._over_since = None
        reason = (
            f"burn={_fmt(sig['burn'])} queue={_fmt(sig['queue_depth'])} "
            f"slope={_fmt(sig['queue_slope'])}"
        )
        fleettrace.scale_event("up", spec.replica_id, reason,
                               time.perf_counter() - t0)
        _tel.record_event("fleet_scale_up", replica=spec.replica_id,
                          port=spec.port, reason=reason)
        return f"scale_up:{spec.replica_id}"

    def _scale_down(self, now: float, sig: Dict) -> str:
        from .. import telemetry as _tel

        victim = self._pick_victim()
        if victim is None:
            return "idle"  # nothing drainable (only the template is left)
        self.supervisor.drain(victim)
        self._draining[victim] = now
        self.scale_downs += 1
        self._last_action_at = now
        self._under_since = None
        reason = f"burn={_fmt(sig['burn'])} queue={_fmt(sig['queue_depth'])}"
        fleettrace.scale_event("down", victim, reason)
        _tel.record_event("fleet_scale_down", replica=victim, reason=reason)
        return f"scale_down:{victim}"

    def _pick_victim(self) -> Optional[str]:
        """Least-loaded drainable replica.  The template replica is never
        drained — it's the spec every future scale-up clones."""
        cands = [
            rid
            for rid in self.router.replicas
            if rid != self.template_id
            and rid not in self._draining
            and rid in self.supervisor.managed
        ]
        if not cands:
            return None

        def _load(rid: str) -> tuple:
            f = self.router.replicas[rid].feed or {}
            return (
                int(f.get("inflight") or 0) + int(f.get("queue_depth") or 0),
                rid,
            )

        return min(cands, key=_load)

    def _finish_drains(self) -> None:
        """Remove drained victims once their process is gone: the router
        fails over anything the drain left behind, and the affinity ring
        re-homes their sessions onto the survivors."""
        for rid in list(self._draining):
            if self.supervisor.alive(rid):
                continue
            if rid in self.router.replicas:
                self.router.remove_replica(rid)
            del self._draining[rid]

    # --------------------------------------------------------------- tick
    def tick(self, now: Optional[float] = None) -> str:
        """One control decision.  Returns what happened: ``idle``,
        ``cooldown``, ``holding_up``, ``holding_down``,
        ``scale_up:<id>``, ``scale_down:<id>``, ``at_max``, ``at_min``.

        Rate-limited by ``tick_s``: a caller may tick every decode step /
        pump turn and the loop still runs at control-plane cadence — the
        throttled fast path costs two comparisons, so a QUIESCENT fleet
        pays ~nothing per step.  Hold/cooldown clocks are wall-anchored,
        so the coarser cadence only delays decisions by < one tick."""
        if now is None:
            now = self._now()
        if (
            self._last_tick_at is not None
            and now - self._last_tick_at < self.tick_s
        ):
            return self.last_decision
        self._last_tick_at = now
        self._finish_drains()
        sig = self.last_signals = self._signals()
        self.last_decision = self._decide(now, sig)
        return self.last_decision

    def _decide(self, now: float, sig: Dict) -> str:
        if (
            self._last_action_at is not None
            and now - self._last_action_at < self.cooldown_s
        ):
            return "cooldown"
        burn, depth, slope = sig["burn"], sig["queue_depth"], sig["queue_slope"]
        over = (burn is not None and burn >= self.up_burn) or (
            depth is not None
            and depth >= self.up_queue
            and (slope is None or slope > 0)
        )
        under = (burn is None or burn <= self.down_burn) and (
            depth is not None and depth <= 0
        )
        if over:
            self._under_since = None
            if self._over_since is None:
                self._over_since = now
            if now - self._over_since < self.up_hold_s:
                return "holding_up"
            if self._active_count() >= self.max_replicas:
                return "at_max"
            return self._scale_up(now, sig)
        self._over_since = None
        if under:
            if self._under_since is None:
                self._under_since = now
            if now - self._under_since < self.down_hold_s:
                return "holding_down"
            if self._active_count() <= self.min_replicas:
                return "at_min"
            return self._scale_down(now, sig)
        self._under_since = None
        return "idle"

    # -------------------------------------------------------------- state
    def state(self) -> Dict[str, Any]:
        """The /fleet v4 ``autoscale`` snapshot."""
        now = self._now()
        return {
            "replicas": len(self.router.replicas),
            "active": self._active_count(),
            "draining": sorted(self._draining),
            "min": self.min_replicas,
            "max": self.max_replicas,
            "last_decision": self.last_decision,
            "signals": dict(self.last_signals),
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "cooldown_remaining_s": (
                max(0.0, self.cooldown_s - (now - self._last_action_at))
                if self._last_action_at is not None
                else 0.0
            ),
        }

    # --------------------------------------------------- journal carry
    def snapshot_state(self) -> Dict[str, Any]:
        """The hold/cooldown clocks as AGES (clock-independent), folded
        into the router's journal snapshots so a recovered router neither
        flaps a half-held scale decision nor forgets a live cooldown."""
        now = self._now()

        def _age(t: Optional[float]) -> Optional[float]:
            return None if t is None else max(0.0, now - t)

        return {
            "over_for_s": _age(self._over_since),
            "under_for_s": _age(self._under_since),
            "since_action_s": _age(self._last_action_at),
            "draining_for_s": {r: _age(t) for r, t in self._draining.items()},
            "last_decision": self.last_decision,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
        }

    def restore_state(self, snap: Dict[str, Any],
                      now: Optional[float] = None) -> None:
        """Back-convert a :meth:`snapshot_state` dict onto THIS
        controller's clock (the inverse of the age encoding)."""
        if not snap:
            return
        if now is None:
            now = self._now()

        def _at(age) -> Optional[float]:
            return None if age is None else now - float(age)

        self._over_since = _at(snap.get("over_for_s"))
        self._under_since = _at(snap.get("under_for_s"))
        self._last_action_at = _at(snap.get("since_action_s"))
        self._draining = {
            r: _at(a) for r, a in (snap.get("draining_for_s") or {}).items()
        }
        self.last_decision = snap.get("last_decision", self.last_decision)
        self.scale_ups = int(snap.get("scale_ups") or 0)
        self.scale_downs = int(snap.get("scale_downs") or 0)


def _fmt(v: Optional[float]) -> str:
    return "na" if v is None else f"{float(v):.3g}"


class RolloutController:
    """Fleet-wide rolling weight rollout with canary auto-rollback (see
    module docstring).  One :meth:`run` call per checkpoint.

    The first replica's canary streams become the fleet reference: every
    later replica's streams must match them bit-for-bit, so a checkpoint
    that loads differently anywhere — or a ``canary_diverge`` fault
    flipping one logit — rolls the WHOLE fleet back to the old weights.
    ``expected`` short-circuits that bootstrap when the trainer already
    published golden streams for the checkpoint; ``baseline=True``
    instead asserts the new weights reproduce the OLD weights' streams
    (the checkpoint-equivalence rollout the smoke test runs).
    """

    def __init__(
        self,
        router,
        checkpoint: str,
        prompts: List[List[int]],
        *,
        max_new_tokens: int = 8,
        canary: bool = True,
        baseline: bool = False,
        expected: Optional[List[List[int]]] = None,
        stage_timeout_s: float = 60.0,
        poll_slice_s: float = 0.05,
        now_fn: Callable[[], float] = time.monotonic,
        sleep_fn: Callable[[float], None] = time.sleep,
    ):
        if not prompts and canary:
            raise ValueError("a canary rollout needs at least one golden prompt")
        self.router = router
        self.checkpoint = checkpoint
        self.prompts = [[int(t) for t in p] for p in prompts]
        self.max_new_tokens = int(max_new_tokens)
        self.canary = bool(canary)
        self.baseline = bool(baseline)
        self.expected = expected
        self.stage_timeout_s = float(stage_timeout_s)
        self.poll_slice_s = float(poll_slice_s)
        self._now = now_fn
        self._sleep = sleep_fn

    # ------------------------------------------------------------ plumbing
    def _control(self, rid: str, payload: Dict) -> Dict:
        h = self.router.replicas.get(rid)
        if h is None:
            return {"ok": False, "error": f"replica {rid!r} not registered"}
        try:
            return h.client.control(payload)
        except Exception as e:
            return {"ok": False, "error": str(e)}

    def _post_and_wait(self, rid: str, payload: Dict,
                       terminal=("committed", "rolled_back")) -> Dict:
        """Post one control op (retrying 'busy') and poll status until the
        replica's machine reaches a terminal state.  The router keeps
        polling throughout, so feeds/outcomes/timeline advance while the
        replica drains and swaps."""
        deadline = self._now() + self.stage_timeout_s
        posted = False
        while self._now() < deadline:
            if not posted:
                r = self._control(rid, payload)
                if r.get("ok"):
                    posted = True
                elif r.get("error") != "busy":
                    return {"ok": False, "reason": r.get("error", "post failed")}
            else:
                s = self._control(rid, {"op": "status"})
                ro = s.get("rollout") if s.get("ok") else None
                if ro is not None and ro.get("state") in terminal:
                    return {"ok": True, "rollout": ro}
            self.router.poll()
            self._sleep(self.poll_slice_s)
        return {"ok": False, "reason": f"timed out after {self.stage_timeout_s}s"}

    # ------------------------------------------------------------ rollout
    def run(self) -> Dict[str, Any]:
        """Drive the rolling rollout across every registered replica.
        Returns ``{"ok", "committed", "rolled_back", "diverged",
        "reason", "streams"}``."""
        from .. import telemetry as _tel

        order = sorted(self.router.replicas)
        _tel.count("fleet_rollouts_total")
        _tel.record_event("fleet_rollout_begin", checkpoint=self.checkpoint,
                          replicas=len(order))
        expected = (
            [[int(t) for t in s] for s in self.expected]
            if self.expected is not None
            else None
        )
        committed: List[str] = []
        for rid in order:
            # mirrored into the journal snapshots (router HA): a router
            # crash mid-rollout recovers this and can resume_revert —
            # reverse-order, exactly what _rollback would have done
            self.router.rollout_state = {
                "checkpoint": self.checkpoint,
                "committed": list(committed),
                "in_progress": rid,
            }
            t0 = time.perf_counter()
            res = self._post_and_wait(
                rid,
                {
                    "op": "reload",
                    "checkpoint": self.checkpoint,
                    "prompts": self.prompts,
                    "max_new_tokens": self.max_new_tokens,
                    "canary": self.canary,
                    # only the FIRST replica may need to bootstrap the
                    # reference from its old weights; later legs compare
                    # against the fleet reference instead
                    "baseline": self.baseline and expected is None,
                    "expected": expected,
                },
            )
            leg_s = time.perf_counter() - t0
            ro = res.get("rollout") or {}
            ok = res["ok"] and ro.get("state") == "committed"
            why = res.get("reason") or (ro.get("detail") or {}).get("reason")
            fleettrace.rollout_stage(rid, "fleet-leg", leg_s, ok=ok,
                                     reason=why, checkpoint=self.checkpoint)
            if not ok:
                return self._rollback(rid, committed, why or "canary diverged")
            _tel.record_event("fleet_rollout_replica_committed", replica=rid,
                              checkpoint=self.checkpoint)
            committed.append(rid)
            if self.canary and expected is None:
                streams = (ro.get("detail") or {}).get("streams")
                if streams:
                    expected = [[int(t) for t in s] for s in streams]
        # clean sweep: finalize — every replica drops its parked old tree
        for rid in committed:
            self._post_and_wait(rid, {"op": "commit"}, terminal=("committed",))
        _tel.record_event("fleet_rollout_committed", checkpoint=self.checkpoint,
                          replicas=len(committed))
        self.router.rollout_state = None
        return {
            "ok": True,
            "committed": committed,
            "rolled_back": [],
            "diverged": None,
            "reason": None,
            "streams": expected,
        }

    def _rollback(self, diverged: str, committed: List[str],
                  why: str) -> Dict[str, Any]:
        """The auto-rollback leg: ONE divergence reverts every replica
        that already swapped (their parked old trees go straight back
        in); the diverged replica rolled itself back already."""
        from .. import telemetry as _tel

        _tel.count("fleet_rollbacks_total")
        _tel.record_event("fleet_rollout_diverged", replica=diverged,
                          checkpoint=self.checkpoint, reason=why)
        rolled = [diverged]
        for rid in reversed(committed):
            t0 = time.perf_counter()
            res = self._post_and_wait(rid, {"op": "revert"},
                                      terminal=("rolled_back",))
            fleettrace.rollout_stage(rid, "fleet-revert",
                                     time.perf_counter() - t0,
                                     ok=res["ok"], checkpoint=self.checkpoint)
            rolled.append(rid)
        _tel.record_event("fleet_rollout_rolled_back",
                          checkpoint=self.checkpoint, reason=why,
                          replicas=len(rolled))
        self.router.rollout_state = None
        return {
            "ok": False,
            "committed": [],
            "rolled_back": rolled,
            "diverged": diverged,
            "reason": why,
            "streams": None,
        }

    @classmethod
    def resume_revert(cls, router, **kw) -> Optional[Dict[str, Any]]:
        """Finish an interrupted rollout after crash recovery: the
        journal snapshot carried ``router.rollout_state`` — the replicas
        already committed and the one that was mid-swap when the leader
        died.  The only safe completion without the original canary
        context is the rollback leg: revert the in-progress replica and
        then every committed one in REVERSE order (the same walk
        ``_rollback`` does).  Returns that rollback result, or None when
        no rollout was in flight."""
        from .. import telemetry as _tel

        st = getattr(router, "rollout_state", None)
        if not st:
            return None
        ctl = cls(router, st["checkpoint"], prompts=[], canary=False, **kw)
        why = "rollout interrupted by router crash"
        # unlike _rollback's diverged replica (which reverted itself),
        # the mid-swap replica got no verdict — revert it too, first
        order = [r for r in st.get("committed") or [] if r in router.replicas]
        in_progress = st.get("in_progress")
        if in_progress in router.replicas and in_progress not in order:
            order.append(in_progress)
        _tel.count("fleet_rollbacks_total")
        rolled: List[str] = []
        for rid in reversed(order):
            t0 = time.perf_counter()
            res = ctl._post_and_wait(rid, {"op": "revert"},
                                     terminal=("rolled_back",))
            fleettrace.rollout_stage(rid, "fleet-revert",
                                     time.perf_counter() - t0,
                                     ok=res["ok"], reason=why,
                                     checkpoint=ctl.checkpoint)
            rolled.append(rid)
        _tel.record_event("fleet_rollout_rolled_back",
                          checkpoint=ctl.checkpoint, reason=why,
                          replicas=len(rolled))
        router.rollout_state = None
        return {
            "ok": False,
            "committed": [],
            "rolled_back": rolled,
            "diverged": in_progress,
            "reason": why,
            "streams": None,
        }
