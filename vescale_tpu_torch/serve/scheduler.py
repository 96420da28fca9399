"""Continuous-batching scheduler — admission control, slots, load shedding.

The port of ``vescale_tpu/serve/scheduler.py``, with the same decisions:
requests are admitted into FREE decode slots at step boundaries (FIFO; a
head request the cache cannot hold yet blocks the queue), the queue is
bounded, a p99-TTFT SLO sheds new submissions while it is breached,
per-tenant weights cap each tenant's share of the queue, and every
submitted request ends in exactly one terminal outcome (``completed`` /
``shed`` / ``timed_out`` / ``preempted_requeue``).  ``fingerprint()``
digests every decision, as in the JAX package.

Admission goes through the radix-tree prefix cache when the scheduler has
one (``prefix_cache=``, or ``VESCALE_SERVE_PREFIX_CACHE=1``): matched
prompt pages map into the new slot for free and the hit is folded into the
digest, as in the JAX package.

The fault envelope's calls are here too: ``requeue_newest`` (the
mid-batch OOM evicts the NEWEST request and replays it from its prompt),
``reject_queued`` (the preemption drain), ``wall_expired_slots`` and
``expire_active(force_slots=, wall_slots=)`` (wall-clock and injected
deadlines), ``step_time_estimate`` and ``tenant_stats`` (the ``/router``
feed).  Every decision folds into the digest with the JAX package's codes.

Differences from the JAX package: metrics go to the scheduler's own
:class:`~vescale_tpu_torch.telemetry.Registry` instead of the global
telemetry gate, and the request-trace spans (``reqtrace``) are not emitted.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from ..telemetry.registry import Histogram, Registry
from .. import config as _config
from . import reqtrace
from .kv_cache import PagedKVCache
from .prefix_cache import PrefixCache

__all__ = ["Request", "ShedError", "ContinuousBatchingScheduler"]

TERMINAL = ("completed", "shed", "timed_out", "preempted_requeue")


def _safe(name: str) -> str:
    """Metric-name-safe tenant slug."""
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def _tenant_weights_from_env() -> Dict[str, float]:
    """Parse ``VESCALE_SERVE_TENANT_WEIGHTS`` — ``"tenant:weight"`` pairs,
    comma-separated (``"paid:3,free:1"``).  Empty/unset means the
    weight-aware admission gate is OFF.  Malformed values raise."""
    raw = _config.get_str("VESCALE_SERVE_TENANT_WEIGHTS")
    if not raw:
        return {}
    out: Dict[str, float] = {}
    for part in raw.split(","):
        name, sep, w = part.strip().partition(":")
        if not sep or not name:
            raise ValueError(
                f"VESCALE_SERVE_TENANT_WEIGHTS: expected tenant:weight, got {part!r}"
            )
        out[name] = float(w)
    return out


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.  ``deadline_steps`` is relative to the
    submission step.  ``eos_id`` stops generation early; ``max_new_tokens``
    always bounds it.  ``tag`` is an OPAQUE client token echoed verbatim
    into the terminal outcome row."""

    rid: int
    prompt: Tuple[int, ...]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    deadline_steps: Optional[int] = None
    tag: Optional[int] = None
    tenant: str = "default"

    def __post_init__(self):
        if not self.prompt:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens must be >= 1")
        if not self.tenant:
            raise ValueError(f"request {self.rid}: tenant must be a non-empty string")


class ShedError(RuntimeError):
    """Raised to a *direct* ``submit(..., raise_on_shed=True)`` caller when
    admission control rejects the request; carries the retry hint."""

    def __init__(self, rid: int, reason: str, retry_after_s: float):
        self.rid = rid
        self.reason = reason
        self.retry_after_s = retry_after_s
        super().__init__(
            f"request {rid} shed ({reason}); retry after ~{retry_after_s:.2f}s"
        )


@dataclasses.dataclass
class _InFlight:
    req: Request
    slot: int
    submit_step: int
    admit_step: int
    submit_wall: float = 0.0  # perf_counter at SUBMISSION (TTFT anchor)
    admit_wall: float = 0.0  # perf_counter at admission
    tokens: List[int] = dataclasses.field(default_factory=list)
    replays: int = 0  # times this request was evicted and replayed
    # prompt tokens served from cached prefix pages: the loop prefills only
    # prompt[prefix_hit:]
    prefix_hit: int = 0


class ContinuousBatchingScheduler:
    """Queue + slots + outcome ledger.  The serve loop drives it:
    ``submit`` on arrivals, timeouts then ``admit`` at each step boundary,
    ``record_token`` per decoded token, ``complete`` as requests finish."""

    def __init__(
        self,
        cache: PagedKVCache,
        *,
        max_queue: Optional[int] = None,
        slo_ttft_s: Optional[float] = None,
        ttft_window: int = 256,
        prefix_cache: Optional[PrefixCache] = None,
        tenant_weights: Optional[Dict[str, float]] = None,
        telemetry: Optional[Registry] = None,
    ):
        self.cache = cache
        # an explicit tree wins; otherwise VESCALE_SERVE_PREFIX_CACHE=1
        # builds one from the environment
        if prefix_cache is None and _config.get_bool("VESCALE_SERVE_PREFIX_CACHE"):
            prefix_cache = PrefixCache.from_env(cache)
        self.prefix = prefix_cache
        self.telemetry = telemetry if telemetry is not None else Registry()
        self.max_queue = (
            max_queue if max_queue is not None else _config.get_int("VESCALE_SERVE_MAX_QUEUE")
        )
        if slo_ttft_s is None:
            slo_ttft_s = _config.get_float("VESCALE_SERVE_SLO_TTFT_S")
        self.slo_ttft_s = float(slo_ttft_s) if slo_ttft_s else 0.0
        # (request, submit_step, submit_wall) — the wall stamp anchors TTFT
        self.queue: Deque[Tuple[Request, int, float]] = deque()
        self.active: Dict[int, _InFlight] = {}  # slot -> in-flight
        self.outcomes: Dict[int, Dict[str, Any]] = {}  # rid -> terminal record
        self._ttft = Histogram("serve_ttft_seconds", window=ttft_window)
        self._step_time = Histogram("serve_decode_step_seconds", window=ttft_window)
        self._itl = Histogram("serve_itl_seconds", window=ttft_window)
        self._step_time_seed: Optional[float] = None
        # raw counts every sampled token; goodput only tokens of COMPLETED
        # requests
        self.raw_tokens = 0
        self.goodput_tokens = 0
        self.counts = {
            "submitted": 0,
            "admitted": 0,
            "completed": 0,
            "shed": 0,
            "timed_out": 0,
            "evicted": 0,
            "requeued": 0,
            "resubmitted": 0,
        }
        if tenant_weights is None:
            tenant_weights = _tenant_weights_from_env()
        self.tenant_weights: Dict[str, float] = dict(tenant_weights or {})
        for t, w in self.tenant_weights.items():
            if w <= 0:
                raise ValueError(f"tenant {t!r}: weight must be > 0, got {w}")
        self.tenant_counts: Dict[str, Dict[str, int]] = {}
        self._tenant_ttft: Dict[str, Any] = {}
        self._tenant_qdepth: Dict[str, int] = {}
        self._tenant_cap_cache: Dict[str, Optional[int]] = {}
        self._ttft_window = ttft_window
        self._digest = 0

    def _fold(self, *ints: int) -> None:
        self._digest = zlib.crc32(
            b"".join((v & 0xFFFFFFFF).to_bytes(4, "little") for v in ints), self._digest
        )

    # ------------------------------------------------------------- tenants
    def _tenant_counts(self, tenant: str) -> Dict[str, int]:
        counts = self.tenant_counts.get(tenant)
        if counts is None:
            counts = self.tenant_counts[tenant] = {
                "submitted": 0, "shed": 0, "completed": 0,
            }
        return counts

    def _tenant_observe_ttft(self, tenant: str, seconds: float) -> None:
        hist = self._tenant_ttft.get(tenant)
        if hist is None:
            hist = self._tenant_ttft[tenant] = Histogram(
                f"serve_ttft_seconds_tenant_{_safe(tenant)}",
                window=self._ttft_window,
            )
        hist.observe(seconds)
        self.telemetry.observe(f"serve_ttft_seconds_tenant_{_safe(tenant)}", seconds)

    def tenant_stats(self) -> Dict[str, Dict[str, Any]]:
        """The per-tenant rollup of the ``/router`` v5 feed: counters, live
        queue depth, weighted cap and the class's own p99 TTFT."""
        tenants = set(self.tenant_counts) | set(self._tenant_qdepth)
        out: Dict[str, Dict[str, Any]] = {}
        for t in sorted(tenants):
            counts = self._tenant_counts(t)
            hist = self._tenant_ttft.get(t)
            out[t] = {
                "submitted": counts["submitted"],
                "shed": counts["shed"],
                "completed": counts["completed"],
                "queue_depth": self.tenant_queue_depth(t),
                "weight": float(self.tenant_weights.get(t, 1.0)),
                "cap": self.tenant_cap(t),
                "ttft_p99_s": hist.percentile(0.99) if hist is not None else None,
            }
        return out

    def tenant_queue_depth(self, tenant: str) -> int:
        return self._tenant_qdepth.get(tenant, 0)

    def _tq(self, tenant: str, delta: int) -> None:
        d = self._tenant_qdepth.get(tenant, 0) + delta
        if d:
            self._tenant_qdepth[tenant] = d
        else:
            self._tenant_qdepth.pop(tenant, None)

    def tenant_cap(self, tenant: str) -> Optional[int]:
        """The weighted queue slice a tenant may hold before it sheds
        (None = no weights configured, gate off).  An UNLISTED tenant
        weighs 1.0 against the configured classes."""
        if not self.tenant_weights or not self.max_queue:
            return None
        if tenant in self._tenant_cap_cache:
            return self._tenant_cap_cache[tenant]
        w = float(self.tenant_weights.get(tenant, 1.0))
        total = sum(self.tenant_weights.values())
        if tenant not in self.tenant_weights:
            total += 1.0
        cap = max(1, int(self.max_queue * w / total))
        self._tenant_cap_cache[tenant] = cap
        return cap

    def _tenant_shed_reason(self, req: Request) -> Optional[str]:
        cap = self.tenant_cap(req.tenant)
        if cap is not None and self.tenant_queue_depth(req.tenant) >= cap:
            return (
                f"tenant {req.tenant} over weighted queue share "
                f"({self.tenant_queue_depth(req.tenant)}/{cap})"
            )
        return None

    # ------------------------------------------------------------- metrics
    def observe_ttft(self, seconds: float, tenant: Optional[str] = None) -> None:
        self._ttft.observe(seconds)
        self.telemetry.observe("serve_ttft_seconds", seconds)
        if tenant is not None:
            self._tenant_observe_ttft(tenant, seconds)

    def observe_step_time(self, seconds: float) -> None:
        self._step_time.observe(seconds)
        self.telemetry.observe("serve_decode_step_seconds", seconds)

    def observe_itl(self, seconds: float) -> None:
        self._itl.observe(seconds)
        self.telemetry.observe("serve_itl_seconds", seconds)

    def ttft_p99(self) -> Optional[float]:
        return self._ttft.percentile(0.99)

    def seed_step_time(self, seconds: float) -> None:
        """Seed the decode-step estimator before any real sample exists
        (the loop passes the first PREFILL wall time).  Ignored once set or
        once real samples landed."""
        if self._step_time_seed is None and self._step_time.count == 0:
            self._step_time_seed = max(float(seconds), 1e-4)

    def step_time_estimate(self) -> Optional[float]:
        """The best guess at the next decode step's wall time (seconds):
        the observed p50, else the cold-start seed, else None."""
        p50 = self._step_time.percentile(0.5)
        return p50 if p50 is not None else self._step_time_seed

    def retry_after_s(self) -> float:
        """Backpressure hint: queue depth x observed decode-step p50 (the
        seeded estimate at cold start, then a 10ms floor)."""
        p50 = self._step_time.percentile(0.5)
        if p50 is None:
            p50 = self._step_time_seed or 0.01
        return max(0.01, (len(self.queue) + 1) * max(p50, 1e-4))

    def currently_shedding(self) -> Optional[str]:
        """The admission-control reason a new submission would be shed
        RIGHT NOW (bounded queue / p99-TTFT SLO breach), or None."""
        if len(self.queue) >= self.max_queue:
            return f"queue full ({len(self.queue)}/{self.max_queue})"
        if self.slo_ttft_s > 0:
            p99 = self.ttft_p99()
            if p99 is not None and p99 > self.slo_ttft_s:
                return f"p99 TTFT {p99:.3f}s over SLO {self.slo_ttft_s:g}s"
        return None

    # ----------------------------------------------------------- admission
    def submit(self, req: Request, step: int, raise_on_shed: bool = False) -> bool:
        """Enqueue a request at ``step``; returns False (and records the
        terminal ``shed`` outcome) when admission control rejects it."""
        tel = self.telemetry
        if any(r.rid == req.rid for r, _, _ in self.queue) or any(
            f.req.rid == req.rid for f in self.active.values()
        ):
            raise ValueError(f"duplicate request id {req.rid} (still pending)")
        prior = self.outcomes.get(req.rid)
        if prior is not None:
            if prior.get("status") not in TERMINAL:
                raise ValueError(f"duplicate request id {req.rid} (replay pending)")
            # a shed/timed-out/preempted request MAY come back with the same
            # rid — the new attempt supersedes the prior terminal outcome
            self.outcomes.pop(req.rid)
            self.counts["resubmitted"] += 1
            self._fold(17, req.rid, step)
        self.counts["submitted"] += 1
        tcounts = self._tenant_counts(req.tenant)
        tcounts["submitted"] += 1
        tel.count(f"serve_tenant_{_safe(req.tenant)}_submitted_total")
        reqtrace.submit(req.rid, step, tag=req.tag)
        reason = self.currently_shedding()
        tenant_shed = False
        if reason is None:
            reason = self._tenant_shed_reason(req)
            tenant_shed = reason is not None
        total = len(req.prompt) + req.max_new_tokens
        if reason is None and total > self.cache.max_seq_len:
            reason = (
                f"request needs {total} tokens, "
                f"cache max_seq_len is {self.cache.max_seq_len}"
            )
        if reason is None and self.cache.pages_needed(total) > self.cache.num_pages - 1:
            # could NEVER be admitted even into an empty pool
            reason = (
                f"request needs {self.cache.pages_needed(total)} pages, "
                f"pool holds {self.cache.num_pages - 1}"
            )
        if reason is not None:
            retry = self.retry_after_s()
            self.counts["shed"] += 1
            tcounts["shed"] += 1
            self.outcomes[req.rid] = {
                "status": "shed",
                "reason": reason,
                "retry_after_s": retry,
                "tokens": [],
                "tag": req.tag,
            }
            tel.count("serve_requests_shed_total")
            tel.count("resilience_shed_total")
            tel.count(f"serve_tenant_{_safe(req.tenant)}_shed_total")
            tel.record_event("serve_shed", rid=req.rid, reason=reason, retry_after_s=retry)
            reqtrace.terminal(req.rid, "shed", 0, reason=reason)
            self._fold(10, req.rid, step)
            if tenant_shed:
                self._fold(20, req.rid, step)
            if raise_on_shed:
                raise ShedError(req.rid, reason, retry)
            return False
        self._fold(11, req.rid, step)
        self.queue.append((req, step, time.perf_counter()))
        self._tq(req.tenant, +1)
        tel.set_gauge("serve_queue_depth", len(self.queue))
        return True

    def admit(self, step: int) -> List[_InFlight]:
        """Fill free slots from the queue head (FIFO — deterministic) at a
        step boundary; returns the newly admitted in-flight records (the
        loop prefills them).  A head request the cache cannot hold yet
        BLOCKS the queue."""
        tel = self.telemetry
        admitted: List[_InFlight] = []
        while self.queue:
            req, submit_step, submit_wall = self.queue[0]
            matched = 0
            if self.prefix is not None:
                # the radix tree decides: matched pages map for free, and
                # unreferenced cached leaves may be evicted to cover the
                # rest (try_admit mutates nothing else when it fails)
                got = self.prefix.try_admit(req.prompt, req.max_new_tokens)
                if got is None:
                    break
                slot, matched = got
            else:
                if not self.cache.can_admit(len(req.prompt), req.max_new_tokens):
                    break
                slot = self.cache.alloc(len(req.prompt), req.max_new_tokens)
            self.queue.popleft()
            self._tq(req.tenant, -1)
            inf = _InFlight(req=req, slot=slot, submit_step=submit_step,
                            admit_step=step, submit_wall=submit_wall,
                            prefix_hit=matched)
            prev = self.outcomes.pop(req.rid, None)  # a replayed eviction
            if prev is not None and prev.get("status") != "evicted_replay":
                raise RuntimeError(f"request {req.rid} readmitted after terminal {prev}")
            if prev is not None:
                inf.replays = int(prev.get("replays", 0)) + 1
            self.active[slot] = inf
            self.counts["admitted"] += 1
            admitted.append(inf)
            self._fold(12, req.rid, slot, step)
            if matched:
                # the hit is a scheduling decision: fold it so a rank whose
                # tree diverged desyncs before the batch decodes
                self._fold(19, req.rid, matched)
                tel.count("serve_prefix_hits_total")
                tel.count("serve_prefix_hit_tokens_total", matched)
            tel.count("serve_requests_admitted_total")
        tel.set_gauge("serve_queue_depth", len(self.queue))
        tel.set_gauge("serve_inflight", len(self.active))
        return admitted

    # ------------------------------------------------------------ outcomes
    def _terminal(self, inf: _InFlight, status: str, **extra) -> None:
        self.outcomes[inf.req.rid] = {
            "status": status,
            "tokens": list(inf.tokens),
            "replays": inf.replays,
            "tag": inf.req.tag,
            **extra,
        }

    def record_token(self, slot: int, token: int) -> None:
        self.active[slot].tokens.append(int(token))
        self.raw_tokens += 1

    def complete(self, slot: int) -> Dict[str, Any]:
        """EOS / token budget reached: the request is done."""
        tel = self.telemetry
        inf = self.active.pop(slot)
        self.cache.free(slot)
        self.counts["completed"] += 1
        self._tenant_counts(inf.req.tenant)["completed"] += 1
        self.goodput_tokens += len(inf.tokens)
        self._fold(13, inf.req.rid, slot, len(inf.tokens))
        self._terminal(inf, "completed")
        reqtrace.terminal(inf.req.rid, "completed", len(inf.tokens), slot=slot)
        tel.count("serve_requests_completed_total")
        tel.count(f"serve_tenant_{_safe(inf.req.tenant)}_completed_total")
        tel.count("serve_goodput_tokens_total", len(inf.tokens))
        tel.set_gauge("serve_inflight", len(self.active))
        return self.outcomes[inf.req.rid]

    def timeout(self, slot: int, reason: str = "deadline") -> Dict[str, Any]:
        """Deadline expired mid-flight: cancel, free the slot, record the
        EXPLICIT rejection (partial tokens kept for diagnosis)."""
        tel = self.telemetry
        inf = self.active.pop(slot)
        self.cache.free(slot)
        self.counts["timed_out"] += 1
        self._fold(14, inf.req.rid, slot)
        self._terminal(inf, "timed_out", reason=reason)
        reqtrace.terminal(inf.req.rid, "timed_out", len(inf.tokens), reason=reason, slot=slot)
        tel.count("serve_requests_timed_out_total")
        tel.record_event("serve_timeout", rid=inf.req.rid, slot=slot, reason=reason)
        tel.set_gauge("serve_inflight", len(self.active))
        return self.outcomes[inf.req.rid]

    def timeout_queued(self, step: int) -> List[int]:
        """Expire queued (never admitted) requests whose step deadline
        passed while they waited."""
        tel = self.telemetry
        expired: List[int] = []
        keep: Deque[Tuple[Request, int, float]] = deque()
        for req, submit_step, submit_wall in self.queue:
            d = req.deadline_steps
            if d is not None and step - submit_step > d:
                self.counts["timed_out"] += 1
                self._fold(18, req.rid, step)
                self.outcomes[req.rid] = {
                    "status": "timed_out",
                    "tokens": [],
                    "replays": self._queued_replays(req.rid),
                    "reason": "queued past deadline",
                    "tag": req.tag,
                }
                reqtrace.terminal(req.rid, "timed_out", 0, reason="queued past deadline")
                tel.count("serve_requests_timed_out_total")
                tel.record_event("serve_timeout", rid=req.rid, reason="queued past deadline")
                expired.append(req.rid)
                self._tq(req.tenant, -1)
            else:
                keep.append((req, submit_step, submit_wall))
        self.queue = keep
        if expired:
            tel.set_gauge("serve_queue_depth", len(self.queue))
        return expired

    def _queued_replays(self, rid: int) -> int:
        """How many times a still-QUEUED rid was already evicted and
        requeued: its ``evicted_replay`` marker holds the count before the
        eviction."""
        prev = self.outcomes.get(rid)
        if prev is not None and prev.get("status") == "evicted_replay":
            return int(prev.get("replays", 0)) + 1
        return 0

    def requeue_newest(self, reason: str = "oom") -> Optional[int]:
        """Evict the NEWEST admitted request and put it back at the queue
        head: the mid-batch OOM protocol.  The batch survives; the victim
        prefills again later and, decode being deterministic, regenerates
        the same tokens.  Returns the victim's rid, or None with nothing in
        flight."""
        tel = self.telemetry
        if not self.active:
            return None
        slot = max(self.active, key=lambda s: (self.active[s].admit_step, s))
        inf = self.active.pop(slot)
        self.cache.free(slot)
        self.counts["evicted"] += 1
        self.counts["requeued"] += 1
        self._fold(15, inf.req.rid, slot)
        # a transient marker, not terminal: admit() consumes it to count the
        # replay; generation restarts from the prompt
        self.outcomes[inf.req.rid] = {
            "status": "evicted_replay",
            "tokens": [],
            "replays": inf.replays,
            "reason": reason,
        }
        # the original submit stamps ride along: the replay's TTFT counts
        # everything since the client submitted
        self.queue.appendleft((inf.req, inf.submit_step, inf.submit_wall))
        self._tq(inf.req.tenant, +1)
        # the fork marker: this rid's chain runs queue-wait -> prefill again
        reqtrace.evict(inf.req.rid, slot, reason, replays=inf.replays + 1)
        tel.count("serve_requests_evicted_total")
        tel.record_event("serve_evict", rid=inf.req.rid, slot=slot, reason=reason)
        tel.set_gauge("serve_inflight", len(self.active))
        return inf.req.rid

    def reject_queued(self, reason: str = "preempted") -> List[int]:
        """The drain: every still-queued request is rejected explicitly as
        re-queueable (the client may resubmit it verbatim)."""
        tel = self.telemetry
        rejected = []
        while self.queue:
            req, _, _ = self.queue.popleft()
            self._tq(req.tenant, -1)
            self._fold(16, req.rid)
            self.outcomes[req.rid] = {
                "status": "preempted_requeue",
                "tokens": [],
                "replays": self._queued_replays(req.rid),
                "reason": reason,
                "retry_after_s": self.retry_after_s(),
                "tag": req.tag,
            }
            reqtrace.terminal(req.rid, "preempted_requeue", 0, reason=reason)
            self.counts["shed"] += 1
            tel.count("serve_requests_shed_total")
            tel.count("resilience_shed_total")
            rejected.append(req.rid)
        tel.set_gauge("serve_queue_depth", 0)
        return rejected

    # ------------------------------------------------------------ expiry
    def wall_expired_slots(self, now_s: float, wall_deadline_s: float) -> List[int]:
        """Slots whose request has been in flight longer than the wall
        budget: computed, not applied, so the loop can OR the rank-local
        verdicts across ranks before any rank acts."""
        if not wall_deadline_s:
            return []
        return [
            slot for slot in sorted(self.active)
            if (now_s - self.active[slot].admit_wall) > wall_deadline_s
        ]

    def expire_active(self, step: int, force_slots: Sequence[int] = (),
                      wall_slots: Sequence[int] = ()) -> List[int]:
        """Timeout cancellation at a step boundary: step-deadline expiry,
        ``wall_slots`` (agreed wall-budget expiries) and ``force_slots``
        (faultsim's ``request_timeout``).  Returns the cancelled rids."""
        out: List[int] = []
        for slot in sorted(self.active):
            inf = self.active[slot]
            d = inf.req.deadline_steps
            forced = slot in force_slots
            step_over = d is not None and step - inf.submit_step > d
            if forced or step_over or slot in wall_slots:
                reason = "injected request_timeout" if forced else (
                    "step deadline" if step_over else "wall deadline"
                )
                self.timeout(slot, reason=reason)
                out.append(inf.req.rid)
        return out

    # ----------------------------------------------------------- agreement
    def fingerprint(self) -> Tuple[int, ...]:
        """Deterministic digest of the full scheduling-decision history +
        the cache's allocation digest."""
        return (self._digest, len(self.queue), len(self.active)) + self.cache.fingerprint()

    def all_terminal(self) -> bool:
        return not self.queue and not self.active

    def percentile(self, metric: str, q: float) -> Optional[float]:
        """Percentile ``q`` of the rolling ``ttft``, ``step_time`` or ``itl``
        window (seconds); None when empty."""
        hist = {"ttft": self._ttft, "step_time": self._step_time, "itl": self._itl}[metric]
        return hist.percentile(q)

    def ledger_check(self) -> None:
        """Assert total accounting: every accepted submission ended exactly
        one way (a resubmission supersedes its prior terminal outcome)."""
        terminal = [r for r in self.outcomes.values() if r.get("status") in TERMINAL]
        if self.queue or self.active:
            raise AssertionError("ledger_check before drain")
        expected = self.counts["submitted"] - self.counts["resubmitted"]
        if len(terminal) != expected:
            raise AssertionError(
                f"{self.counts['submitted']} submitted "
                f"({self.counts['resubmitted']} resubmissions) but "
                f"{len(terminal)} terminal outcomes"
            )
