"""run_serve — the continuous-batching serve loop.

The core of ``vescale_tpu/serve/loop.py::run_serve_resilient``, step for
step: at each boundary the due arrivals are submitted, queued and in-flight
requests past their step deadline time out, the queue head is admitted into
free slots and prefilled (the first token is sampled from the prefill
logits, so its latency is the TTFT), finished requests complete, then one
batched decode step samples a token for every in-flight request.  The
outcomes ledger comes out the same as the JAX loop's for the same arrivals
and the same greedy tokens.

With the scheduler's prefix cache, a hit commits the matched pages and
prefills only the suffix (``ServeEngine.prefill_suffix``), and every
prefill's full pages go into the tree.  With ``speculative=`` a
:class:`~vescale_tpu_torch.serve.speculative.SpeculativeDecoder`, each
decode step drafts ``k`` tokens per mirrored slot, verifies them in one
``decode_multi`` step of width ``k + 1`` and emits the accepted prefix plus
the target's own next token; the streams stay those of plain decode.

Not in this slice (each a leg of the JAX loop): the hang watchdog, faultsim
injection, preemption drain, wall-clock deadlines, multi-rank
coordination, the fleet inbox, ops endpoints, the ``/control`` weight
rollout and request trace spans.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from .engine import ServeEngine
from .scheduler import ContinuousBatchingScheduler, Request
from .speculative import SpeculativeDecoder

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
    speculative: Optional[SpeculativeDecoder] = None,
) -> ServeResult:
    """Serve ``arrivals`` (``(arrival_step, Request)`` pairs) until every
    request is terminal; ``ServeResult.outcomes`` is the ledger.  Raises
    when ``max_steps`` boundaries pass first.  ``on_step(step, active)``
    runs at the end of every boundary.  Counters and latency histograms
    land in ``scheduler.telemetry`` (``serve_prefills_total``,
    ``serve_decode_steps_total``, ``serve_tokens_generated_total``,
    ``serve_prefix_hits_total``, ``serve_spec_verify_steps_total``, ...)."""
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

            if speculative is not None:
                # free drafter slots whose target ended since the last
                # boundary, before admission can reuse the slot ids
                speculative.sync_slots(scheduler.active)
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
                emitted_per_slot = {slot: 1 for slot in active_slots}
                drafted_rows = (speculative.drafted_slots(active_slots)
                                if speculative is not None else [])
                if not drafted_rows:
                    # plain decode, also speculation's step when no active
                    # slot is mirrored by the drafter
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
                        emitted, accepted = spec.accept(
                            drafts[slot], vlogits[slot], budget, inf.req.eos_id)
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
                dt = time.perf_counter() - t0
                scheduler.observe_step_time(dt)
                # the step's wall is each active slot's gap between tokens,
                # split evenly over the tokens it emitted for the slot
                for slot in active_slots:
                    m = emitted_per_slot[slot]
                    for _ in range(m):
                        scheduler.observe_itl(dt / max(1, m))
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
