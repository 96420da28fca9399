"""run_serve_resilient — the continuous-batching serve loop inside its
fault envelope.

The port of ``vescale_tpu/serve/loop.py::run_serve_resilient``, step for
step.  At each boundary the due arrivals (and, in fleet mode, the inbox's
network submissions) are submitted, queued and in-flight requests past a
deadline time out, the queue head is admitted into free slots and
prefilled (the first token is sampled from the prefill logits, so its
latency is the TTFT), finished requests complete, then one batched decode
step samples a token for every in-flight request.  The outcomes ledger is
the JAX loop's for the same arrivals, faults and greedy tokens.

The envelope, leg by leg:

  hung decode            ``beat()`` lands at every boundary, prefill and
                         decode step; a step that stops progressing trips
                         the watchdog: stack dump, and (optionally) abort.
  request deadline       ``deadline_steps`` per request and the wall budget
                         ``wall_deadline_s`` (``VESCALE_SERVE_DEADLINE_S``):
                         the request is rejected explicitly (``timed_out``)
                         at the boundary, its slot and pages freed.
  slow decode            faultsim ``slow_decode`` sleeps before the step.
  OOM mid-batch          faultsim ``oom``: the NEWEST admitted request is
                         evicted and replayed from its prompt (decode is
                         deterministic: it regenerates the same tokens).
  SIGTERM / preemption   stop admitting and DRAIN: in-flight requests decode
                         to completion, queued ones are rejected
                         re-queueable, then ``status="preempted"``.
  multi-rank desync      with ``coordinate``, every rank exchanges a fixed
                         control vector each boundary (``allgather_ints``):
                         the fault flags and the wall-deadline slot mask are
                         OR-agreed, and any difference in the scheduler and
                         cache digests or the sampled tokens raises
                         ``DesyncError`` on every rank before the batch
                         decodes.
  replica crash          faultsim ``replica_kill``: ``os._exit`` mid-load,
                         no drain (the fleet router's failover substrate).

Every submitted request reaches exactly one terminal outcome:
``completed``, ``shed``, ``timed_out`` or ``preempted_requeue``.

Fleet mode: ``inbox`` (a :class:`~vescale_tpu_torch.serve.fleet.RequestInbox`)
feeds network submissions, drained at each boundary (a duplicate rid is
rejected and counted, never fatal); an idle replica sleeps
``VESCALE_SERVE_IDLE_S`` per boundary and runs until the inbox closes or a
drain ends it.  ``ops`` is a started ``OpsServer`` the caller owns; without
one the loop starts its own when ``VESCALE_SERVE_OPS_PORT`` is set.

The prefix cache and speculative decoding work inside the envelope: a hit
prefills only the suffix and every prefill's full pages go into the radix
tree; with ``speculative=`` each decode step drafts ``k`` tokens per
mirrored slot and verifies them in one ``decode_multi`` step, the streams
staying those of plain decode.

The weight rollout (``control``, a :class:`ControlChannel`, which
``serve_replica`` wires to the ``/control`` endpoint): a ``reload`` job
runs drain -> [baseline] -> swap -> canary -> committed | rolled_back at
step boundaries.  Admission pauses while in-flight requests decode out on
the old weights; the checkpoint is restored params-only in this process
(``serve.load_params`` into ``ServeEngine.swap_params``); pinned prompts
replay twice through the new weights, and any divergence swaps the old
tree straight back.  ``commit`` drops the retained old tree, ``revert``
swaps it back.  Each stage's seconds go into ``scheduler.telemetry`` as a
``serve_rollout_stage`` event (the reference's ``fleettrace`` span, which
comes with ROADMAP A19).

``run_serve`` is this loop with the envelope off.  Not ported yet: request
trace spans, alerts and the cost audit.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import distributed as _dist
from ..resilience import consistency as _cons
from ..resilience import faultsim as _fs
from ..resilience.preempt import PreemptionHandler
from ..resilience.watchdog import Watchdog
from ..telemetry import ops_server as _ops
from .. import config as _config
from .engine import ServeEngine
from .obs import ServeObservability
from .scheduler import ContinuousBatchingScheduler, Request
from .speculative import SpeculativeDecoder

__all__ = ["ControlChannel", "ServeResult", "run_serve", "run_serve_resilient"]

# the control vector (fixed width): [magic, step, preempt, oom, rtimeout,
# wall_mask, draining, the scheduler fingerprint fields, the sampled-token
# crc].  preempt/oom/rtimeout/wall_mask are ORed across ranks; everything
# else must agree or the batch must not decode again.
_COORD_MAGIC = 0x5E47E
_OR_FIELDS = ("preempt", "oom", "rtimeout", "wall_mask")
_COORD_FIELDS = ("coord_magic", "step", "preempt", "oom", "rtimeout", "wall_mask", "draining")
_FP_FIELDS = (
    "sched_hash", "queue_len", "active", "cache_hash", "free_slots",
    "free_pages", "tokens_held", "page_refs",
)


@dataclass
class ServeResult:
    status: str  # "completed" | "preempted"
    steps: int = 0
    outcomes: Dict[int, Dict[str, Any]] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    drained: int = 0  # in-flight requests finished during the drain
    rejected_on_drain: int = 0


class ControlChannel:
    """The replica's thread-safe control mailbox: the ``/control`` POST
    provider (on the ops HTTP thread) posts one job at a time, and the serve
    loop takes it at a step boundary, so weights only ever change between
    decode steps.

    Ops (the rolling-rollout wire protocol of the reference
    ``RolloutController``):

      ``reload``   ``{"op": "reload", "checkpoint": path, "prompts":
                   [[tok, ...], ...], "max_new_tokens": N, "canary": bool,
                   "baseline": bool, "expected": [[tok, ...], ...] | null}``:
                   drain, swap in the checkpoint's weights, then replay
                   each prompt TWICE through them (the two streams must be
                   equal: the determinism check that catches
                   ``canary_diverge``) and, with ``expected``, equal to it.
                   ``baseline`` records ``expected`` from the OLD weights
                   first.  A divergence swaps the old weights back
                   (``rolled_back``); a pass keeps them parked
                   (``committed``) until ``commit`` or ``revert``.
      ``commit``   drop the parked old tree.
      ``revert``   drain, swap the parked old tree back in.
      ``status``   the live rollout state (also on ``/router``).

    Posting while a job is pending answers ``{"ok": false, "error":
    "busy"}``; the controller retries."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._job: Optional[Dict[str, Any]] = None
        self.state: Optional[Dict[str, Any]] = None  # mirror of obs.rollout

    def provider(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        op = payload.get("op")
        if op == "status":
            return {"ok": True, "rollout": self.state}
        if op in ("reload", "commit", "revert"):
            if op == "reload" and not payload.get("checkpoint"):
                return {"ok": False, "error": "reload needs a checkpoint path"}
            with self._lock:
                if self._job is not None:
                    return {"ok": False, "error": "busy", "rollout": self.state}
                self._job = dict(payload)
            return {"ok": True, "accepted": op}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def take(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            job, self._job = self._job, None
            return job


def run_serve(
    engine: ServeEngine,
    scheduler: ContinuousBatchingScheduler,
    arrivals: Sequence[Tuple[int, Request]],
    max_steps: int = 100_000,
    on_step: Optional[Callable[[int, int], None]] = None,
    speculative: Optional[SpeculativeDecoder] = None,
) -> ServeResult:
    """Serve ``arrivals`` (``(arrival_step, Request)`` pairs) until every
    request is terminal: :func:`run_serve_resilient` with the envelope off
    (no signal handlers, no watchdog, no wall deadline, no coordination).
    Faults armed in ``faultsim`` and the ops port knob still apply."""
    return run_serve_resilient(
        engine=engine, scheduler=scheduler, arrivals=arrivals, max_steps=max_steps,
        on_step=on_step, speculative=speculative, install_signal_handlers=False,
        watchdog_timeout_s=0, wall_deadline_s=0, coordinate=False,
    )


def run_serve_resilient(
    *,
    engine: ServeEngine,
    scheduler: ContinuousBatchingScheduler,
    arrivals: Sequence[Tuple[int, Request]],
    max_steps: int = 100_000,
    wall_deadline_s: Optional[float] = None,
    preemption: Optional[PreemptionHandler] = None,
    install_signal_handlers: bool = True,
    watchdog: Optional[Watchdog] = None,
    watchdog_timeout_s: Optional[float] = None,
    coordinate: Optional[bool] = None,
    barrier_timeout_s: Optional[float] = None,
    on_step: Optional[Callable[[int, int], None]] = None,
    inbox: Optional[Any] = None,
    ops: Optional[_ops.OpsServer] = None,
    idle_sleep_s: Optional[float] = None,
    replica_id: Optional[str] = None,
    speculative: Optional[SpeculativeDecoder] = None,
    control: Optional[ControlChannel] = None,
) -> ServeResult:
    """Serve ``arrivals`` (a deterministic open-loop schedule of
    ``(arrival_step, Request)`` pairs) under the fault envelope; returns
    when every request is terminal (``"completed"``) or a preemption drain
    ends (``"preempted"``).  ``ServeResult.outcomes`` is the ledger.

    ``wall_deadline_s`` defaults to ``VESCALE_SERVE_DEADLINE_S`` (0 = off).
    ``watchdog`` is a started :class:`Watchdog` the caller owns; without
    one the loop runs its own from the ``VESCALE_WATCHDOG_*`` knobs
    (``watchdog_timeout_s`` overrides the deadline; 0 disables).
    ``coordinate`` defaults to whether a ``torch.distributed`` group of
    more than one process is up; ``barrier_timeout_s`` bounds each exchange
    (default ``VESCALE_BARRIER_TIMEOUT``).  ``on_step(step, active)`` runs
    at the end of every boundary.  Faults come from ``faultsim`` (armed
    from ``VESCALE_FAULTSIM`` when nothing is armed).  Counters and latency
    histograms land in ``scheduler.telemetry``.

    ``control`` runs the weight rollout (module docstring).  It is for
    single-process replicas: nothing coordinates a weight swap across
    ranks, so a coordinated loop refuses it."""
    tel = scheduler.telemetry
    coord = (_dist.process_count() > 1) if coordinate is None else bool(coordinate)
    if wall_deadline_s is None:
        wall_deadline_s = _config.get_float("VESCALE_SERVE_DEADLINE_S") or 0.0
    if coord and wall_deadline_s and scheduler.cache.num_slots > 63:
        raise ValueError(
            "coordinated wall deadlines ride an int64 slot bitmask on the "
            f"control plane: num_slots={scheduler.cache.num_slots} > 63; "
            "use per-request deadline_steps instead"
        )
    if coord and control is not None:
        raise ValueError("the /control reload machine is single-process (fleet mode): "
                         "nothing coordinates a weight swap across ranks")
    if not _fs.is_armed():
        _fs.arm_from_env()
    handler = preemption or PreemptionHandler()
    own_handler = preemption is None
    if own_handler and install_signal_handlers:
        handler.install()

    own_wd = False
    wd = watchdog
    if wd is None:
        wd = Watchdog.from_env(timeout_s=watchdog_timeout_s, telemetry=tel)
        own_wd = wd is not None
    if own_wd:
        wd.start()

    def _beat(step: int, phase: str) -> None:
        if wd is not None:
            wd.beat(step, phase=phase)

    def _fires(kind: str, step: int) -> bool:
        hit = _fs.fires(kind, ctx=f"serve_step{step}")
        if hit:
            tel.count("resilience_faults_injected_total")
        return hit

    arrivals = sorted(arrivals, key=lambda p: (p[0], p[1].rid))
    next_arrival = 0
    token_crc = 0  # running digest of every sampled token (desync tripwire)
    draining = False
    reload_job: Optional[Dict[str, Any]] = None  # the /control job in flight
    reload_t0 = 0.0  # when its drain began
    retained_params = None  # the old tree a committed swap parks
    result = ServeResult(status="completed")
    cache = scheduler.cache

    # the /healthz and /router providers; the ops thread starts only when
    # VESCALE_SERVE_OPS_PORT is set (else no socket, no thread)
    obs = ServeObservability(scheduler, engine=engine, watchdog=wd,
                             rank=_dist.process_index(), replica_id=replica_id,
                             speculative=speculative)
    if ops is not None:
        # a started server (fleet mode): its owner keeps it serving after
        # this loop returns
        ops.register("healthz", obs.health).register("router", obs.router)
        own_ops = False
    else:
        ops = _ops.maybe_start(health=obs.health, router=obs.router, registry=tel)
        own_ops = ops is not None

    def _submit_inbox(reqs, step: int) -> None:
        # a malformed or duplicate wire submission is rejected and counted,
        # never allowed to end the loop
        for req in reqs:
            try:
                scheduler.submit(req, step)
            except ValueError as e:
                tel.count("serve_inbox_rejected_total")
                tel.record_event("serve_inbox_reject", rid=getattr(req, "rid", -1),
                                 at_step=step, error=str(e))

    # ------------------------------------------------- rollout machine
    def _rollout_state(state: str, step: int, **detail) -> None:
        """Publish the rollout stage at once on ``/router`` (v5
        ``rollout``), the ``/control`` status and a
        ``serve_rollout_<state>`` event."""
        snap = {"state": state, "checkpoint": (reload_job or {}).get("checkpoint"),
                "detail": detail}
        obs.rollout = snap
        if control is not None:
            control.state = snap
        tel.record_event(f"serve_rollout_{state}", at_step=step,
                         **{k: v for k, v in detail.items() if not isinstance(v, (list, dict))})

    def _stage(stage: str, seconds: float, **tags) -> None:
        tel.record_event("serve_rollout_stage", stage=stage, seconds=seconds,
                         replica=obs.replica_id, **tags)

    def _perform_reload(step: int) -> None:
        """The post-drain half of a ``/control`` job, at a step boundary
        with nothing in flight: [baseline ->] swap -> canary -> committed |
        rolled_back for ``reload``; drop the parked tree for ``commit``;
        swap it back for ``revert``.  Queued requests wait and then decode
        through whichever tree survives."""
        nonlocal retained_params
        from . import load_params

        job = reload_job
        op = job.get("op", "reload")
        if op == "commit":
            finalized = retained_params is not None
            retained_params = None
            _rollout_state("committed", step, finalized=finalized)
            return
        if op == "revert":
            if retained_params is None:
                _rollout_state("rolled_back", step, reverted=False, reason="nothing retained")
                return
            t0 = time.perf_counter()
            engine.swap_params(retained_params)
            retained_params = None
            tel.count("serve_rollbacks_total")
            _stage("reverted", time.perf_counter() - t0)
            _rollout_state("rolled_back", step, reverted=True)
            return
        ckpt = job["checkpoint"]
        prompts = [[int(t) for t in p] for p in (job.get("prompts") or [])]
        mnt = max(1, int(job.get("max_new_tokens") or 8))
        canary = bool(job.get("canary", True)) and bool(prompts)
        expected = job.get("expected")
        tel.count("serve_rollouts_total")
        if canary and expected is None and job.get("baseline"):
            # the checkpoint-equivalence rollout: the OLD weights' streams are
            # what the new weights must reproduce
            _rollout_state("baseline", step, prompts=len(prompts))
            b0 = time.perf_counter()
            expected = [engine.replay_greedy(p, mnt) for p in prompts]
            _stage("baseline", time.perf_counter() - b0, checkpoint=ckpt)
        _rollout_state("swapping", step)
        s0 = time.perf_counter()
        try:
            old = engine.swap_params(load_params(ckpt, engine.params, device=engine.device))
        except Exception as e:  # noqa: BLE001 — an unreadable checkpoint: no swap
            why = f"restore failed: {e}"
            _stage("swap", time.perf_counter() - s0, ok=False, reason=why, checkpoint=ckpt)
            tel.count("serve_rollbacks_total")
            _rollout_state("rolled_back", step, reason=why)
            return
        _stage("swap", time.perf_counter() - s0, checkpoint=ckpt)
        ok, why, streams = True, "", []
        if canary:
            _rollout_state("canary", step, prompts=len(prompts))
            c0 = time.perf_counter()
            for p in prompts:
                s1 = engine.replay_greedy(p, mnt, canary=True)
                s2 = engine.replay_greedy(p, mnt, canary=True)
                if ok and s1 != s2:
                    # one replay's flipped logit (faultsim canary_diverge, or
                    # real nondeterminism) does not reproduce
                    ok, why = False, "canary replay not deterministic"
                streams.append(s1)
            if ok and expected is not None:
                if [[int(t) for t in s] for s in expected] != streams:
                    ok, why = False, "canary streams diverged from expected"
            _stage("canary", time.perf_counter() - c0, ok=ok, reason=why or None, checkpoint=ckpt)
        if ok:
            # two-phase: park the old tree until the fleet-wide commit (or a
            # revert, if a later replica's canary fails)
            retained_params = old
            _stage("committed", 0.0, checkpoint=ckpt)
            _rollout_state("committed", step, finalized=False, streams=streams, canary=canary)
        else:
            engine.swap_params(old)
            tel.count("serve_rollbacks_total")
            _stage("rolled_back", 0.0, ok=False, reason=why, checkpoint=ckpt)
            _rollout_state("rolled_back", step, reason=why, streams=streams)

    def _coordinate(step: int, oom_fired: bool, rt_fired: bool,
                    wall_mask: int) -> Tuple[bool, bool, bool, int]:
        """One control-plane allgather: OR the fault and preempt flags and
        the rank-local wall-deadline slot mask, and check the scheduler and
        cache fingerprints agree.  Raises DesyncError on every rank (each
        sees the same gathered matrix) on any divergence."""
        fp = scheduler.fingerprint()
        vec = [
            _COORD_MAGIC,
            step,
            1 if handler.requested() else 0,
            1 if oom_fired else 0,
            1 if rt_fired else 0,
            wall_mask,
            1 if draining else 0,
            *[int(v) & 0x7FFFFFFF for v in fp],
            token_crc & 0x7FFFFFFF,
        ]
        rows = _dist.allgather_ints(vec, tag="serve_coord", timeout_s=barrier_timeout_s)
        if rows.shape[0] == 1:
            return bool(vec[2]), oom_fired, rt_fired, wall_mask
        preempt_any = bool(rows[:, 2].any())
        oom_any = bool(rows[:, 3].any())
        rt_any = bool(rows[:, 4].any())
        wall_any = int(np.bitwise_or.reduce(rows[:, 5]))
        fields = _COORD_FIELDS + _FP_FIELDS[: len(fp)] + ("token_crc",)
        mismatched = _cons.compare_rows(rows[:, : len(fields)], fields)
        for f in _OR_FIELDS:
            mismatched.pop(f, None)
        if mismatched:
            tel.count("consistency_mismatches_total")
            tel.record_event("serve_desync", at_step=step, fields=sorted(mismatched))
            raise _cons.DesyncError(mismatched, rows)
        if preempt_any and not handler.requested():
            handler.request()  # a peer is being preempted: drain together
        return preempt_any, oom_any, rt_any, wall_any

    def _sample(slot: int, token: int) -> None:
        nonlocal token_crc
        scheduler.record_token(slot, token)
        tel.count("serve_tokens_generated_total")
        token_crc = zlib.crc32(int(token).to_bytes(4, "little", signed=False), token_crc)

    def _prefill_admitted(step: int) -> None:
        for inf in scheduler.admit(step):
            _beat(step, "prefill")
            inf.admit_wall = time.perf_counter()
            tel.observe("serve_ttft_queue_wait_seconds", max(0.0, inf.admit_wall - inf.submit_wall))
            if inf.prefix_hit:
                # the slot's leading table entries map cached pages: commit
                # them and run only the suffix
                cache.commit_prefill(inf.slot, inf.prefix_hit)
                logits = engine.prefill_suffix(inf.req.prompt, inf.slot, inf.prefix_hit)
            else:
                logits = engine.prefill(inf.req.prompt, inf.slot)
                cache.commit_prefill(inf.slot, len(inf.req.prompt))
            tel.count("serve_prefills_total")
            if scheduler.prefix is not None:
                # adopt the freshly written full pages into the radix tree
                scheduler.prefix.insert(inf.req.prompt, cache.page_table[inf.slot])
                hit_rate = scheduler.prefix.stats.hit_rate()
                if hit_rate is not None:
                    tel.set_gauge("serve_prefix_hit_rate", hit_rate)
            if speculative is not None:
                # mirror the admission in the drafter (its own full prefill);
                # a drafter pool too full to mirror leaves the slot undrafted
                speculative.admit(inf.slot, inf.req.prompt, inf.req.max_new_tokens)
            _sample(inf.slot, engine.greedy(logits))
            now = time.perf_counter()
            prefill_s = now - inf.admit_wall
            scheduler.seed_step_time(prefill_s)
            tenant = inf.req.tenant
            ttft = now - inf.submit_wall
            scheduler.observe_ttft(
                ttft,
                tenant=tenant if (tenant != "default" or scheduler.tenant_weights) else None,
            )
            tel.observe("serve_ttft_prefill_seconds", prefill_s)
            tel.record_event("serve_admit", rid=inf.req.rid, slot=inf.slot, at_step=step,
                             replays=inf.replays, ttft_s=round(ttft, 6))

    def _finish_done(step: int) -> None:
        """Complete slots that hit EOS or their token budget."""
        for slot in sorted(list(scheduler.active)):
            inf = scheduler.active[slot]
            done = len(inf.tokens) >= inf.req.max_new_tokens or (
                inf.req.eos_id is not None and inf.tokens and inf.tokens[-1] == inf.req.eos_id
            )
            if done:
                scheduler.complete(slot)
                tel.record_event("serve_complete", rid=inf.req.rid, slot=slot, at_step=step,
                                 tokens=len(inf.tokens))

    def _decode(step: int) -> Tuple[float, Dict[int, int]]:
        """One batched decode step (or draft-then-verify); returns its wall
        time and the tokens it emitted per slot."""
        t0 = time.perf_counter()
        tokens = [0] * cache.num_slots
        active_slots = []
        for slot, inf in scheduler.active.items():
            tokens[slot] = inf.tokens[-1]
            active_slots.append(slot)
        emitted_per_slot = {slot: 1 for slot in active_slots}
        drafted_rows = (speculative.drafted_slots(active_slots)
                        if speculative is not None else [])
        if not drafted_rows:
            # plain decode, also speculation's step when no active slot is
            # mirrored by the drafter
            logits = engine.decode(tokens)
            for slot in sorted(active_slots):
                cache.advance(slot)
                _sample(slot, engine.greedy(logits[slot]))
        else:
            spec = speculative
            drafts = spec.draft(tokens, drafted_rows)
            toks = np.zeros((cache.num_slots, spec.k + 1), np.int64)
            for slot in active_slots:
                toks[slot, 0] = tokens[slot]
                toks[slot, 1:] = drafts[slot]
            vlogits = engine.decode_multi(toks)
            drafted_now = accepted_now = 0
            for slot in sorted(active_slots):
                inf = scheduler.active[slot]
                budget = inf.req.max_new_tokens - len(inf.tokens)
                emitted, accepted = spec.accept(drafts[slot], vlogits[slot], budget, inf.req.eos_id)
                for tok in emitted:
                    cache.advance(slot)
                    _sample(slot, tok)
                emitted_per_slot[slot] = len(emitted)
                if slot not in spec.undrafted:
                    drafted_now += min(spec.k, budget)
                    accepted_now += accepted
            spec.drafted += drafted_now
            spec.accepted += accepted_now
            spec.verify_steps += 1
            # rejected draft positions: roll the drafter back to the
            # target's committed lengths
            spec.rewind(cache.lengths, drafted_rows)
            tel.count("serve_spec_drafted_tokens_total", drafted_now)
            tel.count("serve_spec_accepted_tokens_total", accepted_now)
            tel.count("serve_spec_verify_steps_total")
            rate = spec.accept_rate()
            if rate is not None:
                tel.set_gauge("serve_spec_accept_rate", rate)
        return time.perf_counter() - t0, emitted_per_slot

    step = 0
    try:
        while True:
            if step >= max_steps:
                raise RuntimeError(
                    f"serve loop exceeded max_steps={max_steps} with "
                    f"{len(scheduler.queue)} queued / {len(scheduler.active)} active"
                )
            _fs.set_step(step)
            _beat(step, "boundary")
            # liveness: the /router feed's serve_step advances every boundary,
            # so a fleet router can tell idle from wedged
            obs.serve_step = step
            if _fires("hang", step):
                # a wedged step: only the watchdog's dump/abort path notices
                time.sleep(_config.get_float("VESCALE_FAULTSIM_HANG_S"))
            if _fires("preempt", step):
                handler.request()
            oom_fired = _fires("oom", step)
            rt_fired = _fires("request_timeout", step)

            # ------------------------------------------------ arrivals
            while (not draining and next_arrival < len(arrivals)
                   and arrivals[next_arrival][0] <= step):
                _, req = arrivals[next_arrival]
                next_arrival += 1
                scheduler.submit(req, step)
            if inbox is not None:
                # mid-drain arrivals still enter the ledger: the exit flush
                # below ends them preempted_requeue
                _submit_inbox(inbox.drain(), step)

            # -------------------------------------------- weight rollout
            if control is not None:
                if reload_job is None:
                    reload_job = control.take()
                    if reload_job is not None:
                        reload_t0 = time.perf_counter()
                        if reload_job.get("op", "reload") != "commit":
                            # admission pauses (the /router feed drops
                            # accepting); in-flight requests decode out
                            _rollout_state("draining", step, inflight=len(scheduler.active))
                if reload_job is not None:
                    op = reload_job.get("op", "reload")
                    if op == "commit" or not scheduler.active:
                        if op != "commit":
                            _stage("drain", time.perf_counter() - reload_t0)
                        _perform_reload(step)
                        reload_job = None

            # ------------------------------------------- control plane
            # wall-deadline verdicts are rank-local clock reads: computed
            # before the exchange so every rank applies the ORed set
            wall_mask = 0
            for slot in scheduler.wall_expired_slots(time.perf_counter(), wall_deadline_s):
                wall_mask |= 1 << slot
            if coord:
                preempt_now, oom_fired, rt_fired, wall_mask = _coordinate(
                    step, oom_fired, rt_fired, wall_mask)
            else:
                preempt_now = handler.requested()

            # ------------------------------------------------- faults
            if oom_fired and scheduler.active:
                # mid-batch OOM: evict the newest request and replay it later
                victim = scheduler.requeue_newest(reason="injected oom")
                tel.record_event("serve_oom_evict", rid=victim, at_step=step)
            force_slots: List[int] = []
            if rt_fired and scheduler.active:
                # the OLDEST in-flight request's deadline is forced expired
                force_slots = [min(scheduler.active,
                                   key=lambda s: (scheduler.active[s].admit_step, s))]

            # ------------------------------------- timeout cancellation
            scheduler.timeout_queued(step)
            wall_slots = [s for s in range(cache.num_slots) if wall_mask & (1 << s)]
            for rid in scheduler.expire_active(step, force_slots=force_slots,
                                               wall_slots=wall_slots):
                tel.record_event("serve_request_timeout", rid=rid, at_step=step)

            # ------------------------------------------------ drain / done
            if preempt_now and not draining:
                draining = True
                obs.draining = True
                tel.count("resilience_preemptions_total")
                tel.record_event("serve_drain_begin", at_step=step,
                                 inflight=len(scheduler.active), queued=len(scheduler.queue))
                result.rejected_on_drain = len(scheduler.reject_queued("preempted"))
            if draining and not scheduler.active:
                # a mid-drain eviction may have requeued its victim: flush it
                # re-queueable too, so the ledger ends all-terminal
                result.rejected_on_drain += len(scheduler.reject_queued("preempted"))
                result.status = "preempted"
                break
            if (not draining and next_arrival >= len(arrivals)
                    and (inbox is None or inbox.closed) and scheduler.all_terminal()):
                # close() may have raced this boundary's drain: what was
                # pushed before the close is still owed service
                late = inbox.drain() if inbox is not None else ()
                if not late:
                    result.status = "completed"
                    break
                _submit_inbox(late, step)

            # ---------------------------------------------- admit + decode
            if speculative is not None:
                # free drafter slots whose target ended since the last
                # boundary, before admission can reuse the slot ids
                speculative.sync_slots(scheduler.active)
            if not draining and reload_job is None:
                _prefill_admitted(step)
                # the prefill-sampled token may already satisfy the request
                _finish_done(step)
            if scheduler.active:
                if _fires("slow_decode", step):
                    time.sleep(_config.get_float("VESCALE_FAULTSIM_SLOW_DECODE_S"))
                _beat(step, "decode")
                active = len(scheduler.active)
                dt, emitted_per_slot = _decode(step)
                scheduler.observe_step_time(dt)
                # the step's wall is each active slot's gap between tokens,
                # split evenly over the tokens it emitted for the slot
                for m in emitted_per_slot.values():
                    for _ in range(m):
                        scheduler.observe_itl(dt / max(1, m))
                tel.count("serve_decode_steps_total")
                obs.on_decode_step(step, dt, active)
                if _fires("replica_kill", step):
                    # an abrupt crash mid-load (consulted only on decode steps
                    # with work in flight): no drain, no cleanup
                    tel.record_event("serve_replica_kill", at_step=step, inflight=active)
                    os._exit(_config.get_int("VESCALE_FAULTSIM_KILL_EXIT_CODE"))
                before = scheduler.counts["completed"]
                _finish_done(step)
                if draining:
                    result.drained += scheduler.counts["completed"] - before
            if on_step is not None:
                on_step(step, len(scheduler.active))
            if (inbox is not None and not draining and not scheduler.active
                    and not scheduler.queue and next_arrival >= len(arrivals)):
                # an idle inbox-fed replica sleeps one slice per boundary (the
                # beats and serve_step keep advancing)
                if idle_sleep_s is None:
                    idle_sleep_s = _config.get_float("VESCALE_SERVE_IDLE_S")
                if idle_sleep_s:
                    time.sleep(idle_sleep_s)
            step += 1
    finally:
        result.steps = step
        result.outcomes = dict(scheduler.outcomes)
        result.counts = dict(scheduler.counts)
        if own_ops:
            ops.stop()
        if own_wd:
            wd.stop()
        if own_handler and install_signal_handlers:
            handler.uninstall()
    tel.record_event("serve_done", status=result.status, steps=step, **result.counts)
    return result
