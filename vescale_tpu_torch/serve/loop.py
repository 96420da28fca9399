"""run_serve — the continuous-batching serve loop.

The core of ``vescale_tpu/serve/loop.py::run_serve_resilient``, step for
step: at each boundary the due arrivals are submitted, queued and in-flight
requests past their step deadline time out, the queue head is admitted into
free slots and prefilled (the first token is sampled from the prefill
logits, so its latency is the TTFT), finished requests complete, then one
batched decode step samples a token for every in-flight request.  The
outcomes ledger comes out the same as the JAX loop's for the same arrivals
and the same greedy tokens.

Not in this slice (each a leg of the JAX loop): the hang watchdog, faultsim
injection, preemption drain, wall-clock deadlines, multi-rank
coordination, the fleet inbox, ops endpoints, the ``/control`` weight
rollout, prefix-cache suffix prefill, speculative decoding and request
trace spans.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from .engine import ServeEngine
from .scheduler import ContinuousBatchingScheduler, Request

__all__ = ["ServeResult", "run_serve"]


@dataclass
class ServeResult:
    status: str  # "completed"
    steps: int = 0
    outcomes: Dict[int, Dict[str, Any]] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)


def run_serve(
    engine: ServeEngine,
    scheduler: ContinuousBatchingScheduler,
    arrivals: Sequence[Tuple[int, Request]],
    max_steps: int = 100_000,
    on_step: Optional[Callable[[int, int], None]] = None,
) -> ServeResult:
    """Serve ``arrivals`` (``(arrival_step, Request)`` pairs) until every
    request is terminal; ``ServeResult.outcomes`` is the ledger.  Raises
    when ``max_steps`` boundaries pass first.  ``on_step(step, active)``
    runs at the end of every boundary.  Counters and latency histograms
    land in ``scheduler.telemetry`` (``serve_prefills_total``,
    ``serve_decode_steps_total``, ``serve_tokens_generated_total``, ...)."""
    cache = scheduler.cache
    tel = scheduler.telemetry
    arrivals = sorted(arrivals, key=lambda p: (p[0], p[1].rid))
    next_arrival = 0
    result = ServeResult(status="completed")

    def _sample(slot: int, token: int) -> None:
        scheduler.record_token(slot, token)
        tel.count("serve_tokens_generated_total")

    def _prefill_admitted(step: int) -> None:
        for inf in scheduler.admit(step):
            inf.admit_wall = time.perf_counter()
            tel.observe("serve_ttft_queue_wait_seconds", max(0.0, inf.admit_wall - inf.submit_wall))
            logits = engine.prefill(inf.req.prompt, inf.slot)
            cache.commit_prefill(inf.slot, len(inf.req.prompt))
            tel.count("serve_prefills_total")
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

    step = 0
    try:
        while True:
            if step >= max_steps:
                raise RuntimeError(
                    f"serve loop exceeded max_steps={max_steps} with "
                    f"{len(scheduler.queue)} queued / {len(scheduler.active)} active"
                )
            while next_arrival < len(arrivals) and arrivals[next_arrival][0] <= step:
                _, req = arrivals[next_arrival]
                next_arrival += 1
                scheduler.submit(req, step)

            scheduler.timeout_queued(step)
            for rid in scheduler.expire_active(step):
                tel.record_event("serve_request_timeout", rid=rid, at_step=step)

            if next_arrival >= len(arrivals) and scheduler.all_terminal():
                break

            _prefill_admitted(step)
            # the prefill-sampled token may already satisfy the request
            _finish_done(step)
            if scheduler.active:
                t0 = time.perf_counter()
                tokens = [0] * cache.num_slots
                active_slots = []
                for slot, inf in scheduler.active.items():
                    tokens[slot] = inf.tokens[-1]
                    active_slots.append(slot)
                logits = engine.decode(tokens)
                for slot in sorted(active_slots):
                    cache.advance(slot)
                    _sample(slot, engine.greedy(logits[slot]))
                dt = time.perf_counter() - t0
                scheduler.observe_step_time(dt)
                for _ in active_slots:
                    scheduler.observe_itl(dt)
                tel.count("serve_decode_steps_total")
                _finish_done(step)
            if on_step is not None:
                on_step(step, len(scheduler.active))
            step += 1
    finally:
        result.steps = step
        result.outcomes = dict(scheduler.outcomes)
        result.counts = dict(scheduler.counts)
    tel.record_event("serve_done", status=result.status, steps=step, **result.counts)
    return result
