"""Fleet router: multi-replica dispatch with failure detection, request
failover, and a zero-loss fleet ledger.

The port of ``vescale_tpu/serve/router.py``, with its names, wire format
and decisions.  N ``run_serve_resilient`` replica processes stand behind
one front-end that places requests, notices replicas dying, and re-drives
their in-flight work somewhere healthy; the unit of recovery is a
replica.  The router holds no tensors and makes no CUDA call.

Design:

  * **Polling, not push.**  The router learns everything from each
    replica's frozen ``/router`` feed (schema v1 consumable, v2 fields
    used when present) at ``VESCALE_FLEET_POLL_S`` cadence — queue depth,
    TTFT percentiles, free slots, ``retry_after_s``, ``accepting``.  No
    replica-side router awareness: a replica that predates the fleet
    still routes.
  * **Least-loaded scoring** — ``(queue_depth + inflight +
    locally-dispatched-since-last-poll) / slots + p99 TTFT seconds``,
    lowest wins, ties broken by least-recently-dispatched then replica
    id (deterministic).  The local-dispatch term keeps a burst between
    two polls from piling onto one replica.
  * **Session affinity** — consistent hashing (crc32 ring, virtual
    nodes) on an opaque session key, for future prefix-cache locality:
    the same session lands on the same replica while it stays healthy,
    and replica churn only remaps the keys that hashed to the dead node.
  * **Circuit breaker per replica** — ``VESCALE_FLEET_BREAKER_FAILURES``
    consecutive poll/submit failures (or a feed whose ``serve_step``
    stops advancing for ``VESCALE_FLEET_HEALTH_STALE_S`` — a reachable
    but wedged replica) opens the breaker; after
    ``VESCALE_FLEET_BREAKER_COOLDOWN_S`` the next poll is a HALF-OPEN
    probe — success closes and readmits the replica to the rotation,
    failure re-opens with a fresh cooldown.
  * **Request failover** — when a breaker opens, every request in-flight
    on that replica is re-dispatched **from the prompt** to a healthy
    one (decode is deterministic, so the replayed tokens are
    bit-identical).  The resubmission is counted, never hidden.
  * **Total accounting at fleet scope** — every request submitted to the
    router ends in EXACTLY one terminal outcome *across the fleet*
    (``completed`` / ``shed`` / ``timed_out`` / ``preempted_requeue``),
    no matter how many replicas it visited; :meth:`FleetLedger.check`
    asserts it (the fleet-smoke invariant: a replica kill can never lose
    or duplicate a request).
  * **Backpressure honored** — a replica-side ``shed`` outcome (or a
    ``Retry-After`` header) backs the replica off for its own
    ``retry_after_s`` hint; the router only sheds at FLEET level when
    every healthy replica is shedding (the degradation order: spill to
    peers first, reject only when the whole fleet is saturated).
  * **Deadline propagation** — ``deadline_steps`` rides the submit
    payload verbatim (the replica enforces it); a wall ``deadline_s``
    is enforced by the router: it bounds every retry/backoff sleep, and
    an unresolved request past it is terminally ``timed_out`` (a late
    replica completion is superseded — wasted work, visible in the
    goodput gap, never a duplicate outcome).
  * **Hedging (off by default)** — with ``VESCALE_FLEET_HEDGE_S > 0`` a
    request still unresolved after the bound is dispatched to a SECOND
    replica; the first terminal outcome wins and the loser is ignored
    (decode determinism makes either answer identical; the ledger
    counts the hedge, and duplicates stay impossible because the fleet
    record resolves exactly once).

Transport is pluggable: :class:`HttpReplicaClient` speaks to a live
``telemetry.ops_server`` over localhost urllib; tests drive the same
router with in-memory fakes (no sockets) — the breaker/affinity/ledger
state machines are transport-blind.  Clock and sleep are injectable for
deterministic unit tests.

Telemetry rides the gated registry (``fleet:`` dashboard block):
``fleet_dispatch_total``, ``fleet_redispatch_total``,
``fleet_failover_total``, ``fleet_hedge_total``, ``fleet_shed_total``,
``fleet_poll_failures_total``, ``fleet_breaker_{open,reopen,close}_total``
and the ``fleet_healthy_replicas`` / ``fleet_pending_requests`` gauges.

Observability: with the ndtimeline profiler live every routed
request emits its router-side journey chain (``fleet-submit ->
fleet-dispatch-attempt[i] -> fleet-terminal``, plus backoff forks and
breaker transitions as spans — serve/fleettrace.py), the dispatch tag
doubling as the trace context that stitches to replica chains; the
:class:`~.obs.FleetObservability` aggregator (``self.obs``) rolls the
cached feeds into fleet health (``/fleet`` via :meth:`start_ops`,
``fleet_timeline_*`` gauges, the ``fleet-timeline:`` dashboard block).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import time
import urllib.error
import urllib.request
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .. import config as _config
from . import fleettrace
from .journal import (
    FencedEpochError,
    FleetJournal,
    LeaderLease,
    make_tag,
    slim_outcome,
    tag_epoch,
)
from .scheduler import Request, TERMINAL

__all__ = [
    "ReplicaUnreachable",
    "CircuitBreaker",
    "ConsistentHashRing",
    "FleetLedger",
    "FleetRouter",
    "HttpReplicaClient",
    "StandbyRouter",
    "request_payload",
    "request_from_payload",
]


class ReplicaUnreachable(RuntimeError):
    """A poll or submit against a replica failed at the transport level
    (connection refused, timeout, blackholed reply, malformed body)."""


# --------------------------------------------------------------- payloads
def request_payload(
    req: Request, session: Optional[str] = None, tag: Optional[int] = None
) -> Dict[str, Any]:
    """The wire form of a :class:`Request` (the POST ``/submit`` body).
    ``deadline_steps`` rides verbatim — the replica enforces it.  ``tag``
    (default: the request's own) is the dispatch-attempt token the
    replica echoes into the outcome row."""
    d: Dict[str, Any] = {
        "rid": req.rid,
        "prompt": list(req.prompt),
        "max_new_tokens": req.max_new_tokens,
    }
    if req.eos_id is not None:
        d["eos_id"] = req.eos_id
    if req.deadline_steps is not None:
        d["deadline_steps"] = req.deadline_steps
    if session is not None:
        d["session"] = session
    if tag is None:
        tag = req.tag
    if tag is not None:
        d["tag"] = tag
    if req.tenant != "default":
        # additive wire field: default-tenant payloads are byte-identical
        # to the pre-tenant wire, so old replicas still parse them
        d["tenant"] = req.tenant
    return d


def request_from_payload(d: Dict[str, Any]) -> Request:
    """Parse a ``/submit`` body back into a :class:`Request` (validation
    is the dataclass's — empty prompts and bad budgets raise here, on the
    serving side of the wire)."""
    return Request(
        rid=int(d["rid"]),
        prompt=tuple(int(t) for t in d["prompt"]),
        max_new_tokens=int(d.get("max_new_tokens", 16)),
        eos_id=(None if d.get("eos_id") is None else int(d["eos_id"])),
        deadline_steps=(
            None if d.get("deadline_steps") is None else int(d["deadline_steps"])
        ),
        tag=(None if d.get("tag") is None else int(d["tag"])),
        tenant=str(d.get("tenant") or "default"),
    )


# --------------------------------------------------------- circuit breaker
class CircuitBreaker:
    """Per-replica failure gate: CLOSED -> (N consecutive failures) ->
    OPEN -> (cooldown) -> HALF_OPEN probe -> CLOSED on success, back to
    OPEN on probe failure.  ``now_fn`` is injectable so the state machine
    is unit-testable without sleeping."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(
        self,
        failures: Optional[int] = None,
        cooldown_s: Optional[float] = None,
        now_fn: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = (
            failures
            if failures is not None
            else _config.get_int("VESCALE_FLEET_BREAKER_FAILURES")
        )
        self.cooldown_s = (
            cooldown_s
            if cooldown_s is not None
            else _config.get_float("VESCALE_FLEET_BREAKER_COOLDOWN_S")
        )
        self._now = now_fn
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.opened_at: Optional[float] = None
        self.opens = 0  # CLOSED->OPEN transitions
        self.reopens = 0  # HALF_OPEN probe failures
        self.closes = 0  # HALF_OPEN->CLOSED readmissions

    def record_success(self) -> None:
        if self.state == self.HALF_OPEN:
            self.closes += 1
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.opened_at = None

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state == self.HALF_OPEN:
            # the probe itself failed: straight back to OPEN, fresh cooldown
            self.state = self.OPEN
            self.opened_at = self._now()
            self.reopens += 1
        elif (
            self.state == self.CLOSED
            and self.consecutive_failures >= self.failure_threshold
        ):
            self.state = self.OPEN
            self.opened_at = self._now()
            self.opens += 1

    def poll_disposition(self) -> str:
        """What the next poll of this replica is: ``"poll"`` (normal),
        ``"probe"`` (half-open trial), or ``"skip"`` (open, cooling)."""
        if self.state == self.CLOSED:
            return "poll"
        if self.state == self.OPEN:
            if self._now() - (self.opened_at or 0.0) >= self.cooldown_s:
                self.state = self.HALF_OPEN
                return "probe"
            return "skip"
        return "probe"  # HALF_OPEN

    @property
    def dispatchable(self) -> bool:
        """Requests are only placed on CLOSED replicas; a HALF_OPEN
        replica earns readmission with a successful *poll* probe first."""
        return self.state == self.CLOSED


# ------------------------------------------------------- consistent hashing
class ConsistentHashRing:
    """crc32 hash ring with virtual nodes — deterministic across
    processes (no salted ``hash()``), stable under churn: removing a node
    only remaps the keys that hashed to it."""

    def __init__(self, vnodes: int = 64):
        self.vnodes = int(vnodes)
        self._points: List[Tuple[int, str]] = []  # sorted (hash, node)

    @staticmethod
    def _h(s: str) -> int:
        return zlib.crc32(s.encode())

    def add(self, node: str) -> None:
        for i in range(self.vnodes):
            bisect.insort(self._points, (self._h(f"{node}#{i}"), node))

    def remove(self, node: str) -> None:
        self._points = [(h, n) for h, n in self._points if n != node]

    def nodes(self) -> Tuple[str, ...]:
        return tuple(sorted({n for _, n in self._points}))

    def lookup(self, key: str, eligible: Sequence[str]) -> Optional[str]:
        """The first eligible node at or after ``key``'s ring position
        (wrapping).  ``eligible`` filters without mutating the ring, so a
        replica's points survive its outage — when it heals, its sessions
        come home."""
        if not self._points:
            return None
        ok = set(eligible)
        if not ok:
            return None
        start = bisect.bisect_left(self._points, (self._h(f"k:{key}"), ""))
        n = len(self._points)
        for off in range(n):
            node = self._points[(start + off) % n][1]
            if node in ok:
                return node
        return None


# ------------------------------------------------------------ fleet ledger
@dataclasses.dataclass
class FleetRecord:
    """One request's fleet-wide lifetime: where it has been dispatched,
    how many times it was re-driven, and the single terminal outcome."""

    req: Request
    session: Optional[str] = None
    deadline_at: Optional[float] = None  # router-clock absolute wall bound
    status: Optional[str] = None  # a TERMINAL string once resolved
    outcome: Optional[Dict[str, Any]] = None  # the winning replica record
    replica: Optional[str] = None  # replica that resolved it
    live_on: List[str] = dataclasses.field(default_factory=list)
    # dispatch-attempt token per replica: an /outcomes row whose echoed
    # tag differs is a STALE row from a prior dispatch of this rid there
    # (tags are router-unique, so rows can never alias across attempts
    # or client resubmissions)
    tag_by_replica: Dict[str, int] = dataclasses.field(default_factory=dict)
    attempts: List[Tuple[str, float]] = dataclasses.field(default_factory=list)
    resubmissions: int = 0
    failovers: int = 0
    hedged: bool = False
    submitted_at: float = 0.0
    resolved_at: Optional[float] = None
    last_dispatch_at: float = 0.0

    @property
    def pending(self) -> bool:
        return self.status is None


class FleetLedger:
    """Fleet-scope total accounting: every rid submitted to the router
    resolves to EXACTLY one terminal outcome, resubmissions counted.
    The multi-replica analog of ``ContinuousBatchingScheduler``'s ledger
    — :meth:`check` is what the fleet smoke asserts after a replica kill."""

    def __init__(self):
        self.records: Dict[int, FleetRecord] = {}
        # pending rids maintained incrementally: submit/pump are on the
        # dispatch hot path and must stay O(pending), not O(history)
        self._pending: Dict[int, FleetRecord] = {}
        self.counts: Dict[str, int] = {
            "submitted": 0,
            "dispatched": 0,
            # client-level: the SAME rid submitted again after a terminal
            # outcome (the retry_after_s contract) — nets in check()
            "resubmitted": 0,
            # fleet-internal: extra placements within one rid lifetime
            # (failover / shed spill-over / hedge) — informational
            "redispatched": 0,
            "failovers": 0,
            "hedges": 0,
            "completed": 0,
            "shed": 0,
            "timed_out": 0,
            "preempted_requeue": 0,
        }

    def submitted(self, rec: FleetRecord) -> None:
        if rec.req.rid in self.records and self.records[rec.req.rid].pending:
            raise ValueError(f"duplicate fleet request id {rec.req.rid} (still pending)")
        prior = self.records.get(rec.req.rid)
        if prior is not None:
            # same contract as the replica scheduler: a terminal rid MAY be
            # resubmitted by the client; the new lifetime supersedes
            self.counts["resubmitted"] += 1
        self.records[rec.req.rid] = rec
        self._pending[rec.req.rid] = rec
        self.counts["submitted"] += 1
        fleettrace.fleet_submit(rec.req.rid, session=rec.session)

    def dispatched(self, rec: FleetRecord, replica_id: str, now: float) -> None:
        rec.attempts.append((replica_id, now))
        rec.last_dispatch_at = now
        if replica_id not in rec.live_on:
            rec.live_on.append(replica_id)
        self.counts["dispatched"] += 1

    def resolve(
        self, rec: FleetRecord, status: str, outcome: Optional[Dict[str, Any]],
        replica_id: Optional[str], now: float,
    ) -> bool:
        """First terminal wins; a late outcome (hedge loser, a deadline
        superseded by the router) returns False and changes nothing."""
        if not rec.pending:
            return False
        if status not in TERMINAL:
            raise ValueError(f"non-terminal fleet status {status!r}")
        rec.status = status
        rec.outcome = outcome
        rec.replica = replica_id
        rec.resolved_at = now
        rec.live_on.clear()
        self.counts[status] += 1
        self._pending.pop(rec.req.rid, None)
        fleettrace.fleet_terminal(
            rec.req.rid, status, replica_id,
            tokens=len((outcome or {}).get("tokens") or ()),
            failovers=rec.failovers,
        )
        return True

    def pending(self) -> List[FleetRecord]:
        return list(self._pending.values())

    def pending_count(self) -> int:
        return len(self._pending)

    def check(self) -> None:
        """Assert fleet-wide total accounting (``fleet_ledger_check``):
        nothing pending, every submission resolved exactly once, terminal
        counts and the resubmission net agree with the records."""
        stuck = [r.req.rid for r in self.records.values() if r.pending]
        if stuck:
            raise AssertionError(f"fleet_ledger_check: unresolved rids {stuck}")
        terminal = sum(self.counts[s] for s in TERMINAL)
        expected = self.counts["submitted"] - self.counts["resubmitted"]
        if len(self.records) != expected or terminal != self.counts["submitted"]:
            raise AssertionError(
                f"fleet_ledger_check: {self.counts['submitted']} submitted "
                f"({self.counts['resubmitted']} resubmissions) vs "
                f"{len(self.records)} records / {terminal} terminal counts"
            )
        for r in self.records.values():
            if r.status not in TERMINAL:
                raise AssertionError(
                    f"fleet_ledger_check: rid {r.req.rid} status {r.status!r}"
                )


# fleet_ledger_check as a function: the smokes call it off the router
def fleet_ledger_check(ledger: FleetLedger) -> None:
    ledger.check()


# ---------------------------------------------------------------- clients
class HttpReplicaClient:
    """urllib transport against one replica's live ops endpoints
    (``telemetry.ops_server``).  Every failure — refused, timed out,
    blackholed, non-JSON — normalizes to :class:`ReplicaUnreachable` so
    the breaker sees one failure vocabulary."""

    def __init__(self, base_url: str, timeout_s: Optional[float] = None):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = (
            timeout_s
            if timeout_s is not None
            else _config.get_float("VESCALE_FLEET_POLL_TIMEOUT_S")
        )
        self.last_retry_after_header: Optional[float] = None

    def _get(self, path: str) -> Dict[str, Any]:
        try:
            with urllib.request.urlopen(
                f"{self.base_url}{path}", timeout=self.timeout_s
            ) as resp:
                self._capture_retry_after(resp)
                return json.loads(resp.read().decode())
        except Exception as e:  # narrow normalization boundary: transport only
            raise ReplicaUnreachable(f"GET {path} on {self.base_url}: {e}") from e

    def _capture_retry_after(self, resp) -> None:
        # reset first: a hint captured minutes ago must not leak into an
        # unrelated later backpressure decision (the field reflects the
        # LATEST response only)
        self.last_retry_after_header = None
        ra = resp.headers.get("Retry-After")
        if ra is not None:
            try:
                self.last_retry_after_header = float(ra)
            except ValueError:
                pass

    def poll_router(self) -> Dict[str, Any]:
        return self._get("/router")

    def poll_health(self) -> Dict[str, Any]:
        return self._get("/healthz")

    def outcomes(self) -> Dict[str, Any]:
        return self._get("/outcomes")

    def submit(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        return self._post("/submit", payload)

    def control(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """The rollout control hop: POST ``/control`` (``reload`` /
        ``status`` ops — serve/fleet.py registers the provider)."""
        return self._post("/control", payload)

    def _post(self, path: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            f"{self.base_url}{path}", data=body,
            headers={"Content-Type": "application/json"}, method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                self._capture_retry_after(resp)
                return json.loads(resp.read().decode())
        except Exception as e:
            raise ReplicaUnreachable(f"POST {path} on {self.base_url}: {e}") from e


class _Replica:
    """Router-side state for one replica: its client, breaker, the last
    feed, local dispatch count since that feed, and backoff bookkeeping."""

    def __init__(self, replica_id: str, client, breaker: CircuitBreaker):
        self.id = replica_id
        self.client = client
        self.breaker = breaker
        self.feed: Optional[Dict[str, Any]] = None
        self.last_poll_at: Optional[float] = None
        self.pending_local = 0  # dispatches since the feed last refreshed
        self.backoff_until = 0.0  # replica-shed retry_after_s honor
        self.last_serve_step: Optional[int] = None
        self.last_advance_at: Optional[float] = None
        self.last_dispatch_at = 0.0
        self.dispatches = 0


# ------------------------------------------------------------------ router
class FleetRouter:
    """The fleet front-end.  Single-threaded by design: callers drive it
    with :meth:`submit` / :meth:`pump` (or :meth:`drain`), which keeps
    every decision deterministic given the feed/outcome sequence — the
    property the faked-feed unit tests pin."""

    def __init__(
        self,
        *,
        poll_interval_s: Optional[float] = None,
        breaker_failures: Optional[int] = None,
        breaker_cooldown_s: Optional[float] = None,
        health_stale_s: Optional[float] = None,
        dispatch_retries: Optional[int] = None,
        backoff_s: Optional[float] = None,
        backoff_max_s: Optional[float] = None,
        hedge_s: Optional[float] = None,
        now_fn: Callable[[], float] = time.monotonic,
        sleep_fn: Callable[[float], None] = time.sleep,
        journal: Optional[FleetJournal] = None,
        lease: Optional[LeaderLease] = None,
    ):
        def _f(val, knob):
            return val if val is not None else _config.get_float(knob)

        self.poll_interval_s = _f(poll_interval_s, "VESCALE_FLEET_POLL_S")
        self.health_stale_s = _f(health_stale_s, "VESCALE_FLEET_HEALTH_STALE_S")
        self.dispatch_retries = (
            dispatch_retries
            if dispatch_retries is not None
            else _config.get_int("VESCALE_FLEET_RETRIES")
        )
        self.backoff_s = _f(backoff_s, "VESCALE_FLEET_BACKOFF_S")
        self.backoff_max_s = _f(backoff_max_s, "VESCALE_FLEET_BACKOFF_MAX_S")
        self.hedge_s = _f(hedge_s, "VESCALE_FLEET_HEDGE_S")
        self._breaker_failures = breaker_failures
        self._breaker_cooldown_s = breaker_cooldown_s
        self._now = now_fn
        self._sleep = sleep_fn
        self.replicas: Dict[str, _Replica] = {}
        self.ring = ConsistentHashRing()
        self.ledger = FleetLedger()
        self._tag_counter = 0  # router-unique dispatch-attempt tokens
        # breaker state-transition history (bounded): the /fleet feed's
        # breaker_transitions tail, and the source of fleet-breaker spans
        self.breaker_transitions: collections.deque = collections.deque(maxlen=256)
        # fleet health aggregator: rollups over the cached feeds + ledger
        # (the /fleet provider + fleet_timeline_* gauges); import here to
        # keep obs.py -> router.py import-order freedom
        from .obs import FleetObservability

        self.obs = FleetObservability(self)
        self._ops = None  # router-side ops server (start_ops)
        # ----- HA: write-ahead journal + fenced leader lease.
        # epoch 0 == journaling off: tags stay bare counters and every
        # pre-HA behavior (and test) is byte-identical.
        self.journal = journal
        self.lease = lease
        if self.journal is None:
            jdir = _config.get_str("VESCALE_FLEET_JOURNAL_DIR")
            if jdir:
                self.journal = FleetJournal(jdir)
        if self.lease is None:
            lpath = _config.get_str("VESCALE_FLEET_LEASE_PATH")
            if lpath:
                self.lease = LeaderLease(lpath, holder=f"router-{os.getpid()}")
        self.epoch = 0
        if self.lease is not None:
            self.epoch = self.lease.acquire()
        elif self.journal is not None:
            # no lease: each (re)start is still a fresh generation, so a
            # prior incarnation's stale placements can never tag-match
            self.epoch = self.journal.last_epoch + 1
        if self.journal is not None:
            self.journal.attach_lease(self.lease)
            self.journal.begin_epoch(self.epoch)
        # journal-snapshot providers (extras the tail can't reconstruct):
        # the Autoscaler attaches its clock snapshot here; the rollout
        # controller mirrors its stage into rollout_state as it commits
        self.autoscale_journal_provider: Optional[Callable[[], Dict[str, Any]]] = None
        self.rollout_state: Optional[Dict[str, Any]] = None
        self.recovered_autoscale_state: Optional[Dict[str, Any]] = None
        self.recovery: Optional[Dict[str, Any]] = None  # recover_from_journal fills
        self.obs.ha_provider = self._ha_state

    # ---------------------------------------------------------- lifecycle
    def add_replica(self, replica_id: str, client) -> None:
        if replica_id in self.replicas:
            raise ValueError(f"replica {replica_id!r} already registered")
        breaker = CircuitBreaker(
            failures=self._breaker_failures,
            cooldown_s=self._breaker_cooldown_s,
            now_fn=self._now,
        )
        self.replicas[replica_id] = _Replica(replica_id, client, breaker)
        self.ring.add(replica_id)

    def remove_replica(self, replica_id: str) -> None:
        """Administrative removal (scale-down).  In-flight work on the
        replica is failed over exactly as if it had died."""
        h = self.replicas.pop(replica_id, None)
        self.ring.remove(replica_id)
        if h is not None:
            self._failover_replica(replica_id)

    # ------------------------------------------------------------ polling
    def poll(self, force: bool = False) -> None:
        """Refresh the feeds of every replica whose poll is due; open /
        probe / close breakers as the polls land; fail over in-flight
        requests off replicas whose breakers opened."""
        from .. import telemetry as _tel

        now = self._now()
        polled_any = False
        for h in list(self.replicas.values()):
            due = (
                force
                or h.last_poll_at is None
                or now - h.last_poll_at >= self.poll_interval_s
            )
            if not due:
                continue
            polled_any = True
            pre_state = h.breaker.state
            disposition = h.breaker.poll_disposition()
            if (
                pre_state == CircuitBreaker.OPEN
                and h.breaker.state == CircuitBreaker.HALF_OPEN
            ):
                self._note_transition(h.id, pre_state, h.breaker.state,
                                      "cooldown elapsed")
            if disposition == "skip":
                continue
            was_open = h.breaker.state != CircuitBreaker.CLOSED
            h.last_poll_at = now
            try:
                feed = h.client.poll_router()
                if not isinstance(feed, dict) or "queue_depth" not in feed:
                    raise ReplicaUnreachable(f"malformed /router feed: {feed!r}")
            except ReplicaUnreachable:
                self._record_failure(h, "poll")
                continue
            # liveness beyond reachability: a feed whose serve_step stops
            # advancing is a wedged replica (a stale /healthz)
            step = feed.get("serve_step")
            if step != h.last_serve_step or h.last_advance_at is None:
                h.last_serve_step = step
                h.last_advance_at = now
            elif (
                self.health_stale_s
                and now - h.last_advance_at > self.health_stale_s
            ):
                self._record_failure(h, "stale")
                continue
            h.feed = feed
            h.pending_local = 0
            pre_state = h.breaker.state
            h.breaker.record_success()
            if pre_state != CircuitBreaker.CLOSED:
                self._note_transition(
                    h.id, pre_state, CircuitBreaker.CLOSED,
                    "probe success" if pre_state == CircuitBreaker.HALF_OPEN
                    else "poll success",
                )
            if was_open and h.breaker.state == CircuitBreaker.CLOSED:
                _tel.count("fleet_breaker_close_total")
                _tel.record_event("fleet_readmit", replica=h.id)
        _tel.set_gauge(
            "fleet_healthy_replicas",
            sum(1 for h in self.replicas.values() if h.breaker.dispatchable),
        )
        # HA housekeeping rides the real poll cadence (not every poll()
        # CALL — _dispatch invokes poll per attempt): renew the lease,
        # flush buffered journal records, snapshot on cadence.  A full
        # buffer flushes regardless so an idle-poll router stays bounded.
        if self.lease is not None and polled_any:
            self.lease.renew()  # FencedEpochError => this leader is deposed
        if self.journal is not None and (
            polled_any or self.journal.buffered >= self.journal.max_buffer
        ):
            self.journal.flush()
            if self.journal.should_snapshot():
                self.journal.write_snapshot(self._journal_extras())
        # poll boundary = the router's step boundary: refresh the
        # fleet_timeline_* rollup gauges, snapshot them into the
        # time-series store, and run the alert rules over the history
        # (all three are dormant-gated no-ops without telemetry.init())
        from ..telemetry import alerts as _alerts
        from ..telemetry import timeseries as _ts

        self.obs.publish()
        if _alerts.is_active():
            # lazy idempotent arming: the router may be built before the
            # engine comes up, so the pack arms at the first live poll
            _alerts.get_engine().arm_pack(
                "fleet", _alerts.fleet_rule_pack(slo_ttft_s=self.obs.slo_ttft_s)
            )
        _ts.sample("fleet")
        _alerts.evaluate()

    def _note_transition(self, replica_id: str, old: str, new: str, reason: str) -> None:
        """One breaker state transition: append to the bounded history
        (the /fleet feed's ``breaker_transitions`` tail), emit the
        fleet-breaker span, count it."""
        from .. import telemetry as _tel

        self.breaker_transitions.append({
            "ts": time.time(), "replica": replica_id,
            "from": old, "to": new, "reason": reason,
        })
        fleettrace.breaker_transition(replica_id, old, new, reason)
        _tel.count("fleet_breaker_transitions_total")

    def _record_failure(self, h: _Replica, why: str) -> None:
        from .. import telemetry as _tel

        before = h.breaker.state
        h.breaker.record_failure()
        if h.breaker.state != before:
            self._note_transition(h.id, before, h.breaker.state, why)
        _tel.count("fleet_poll_failures_total")
        if h.breaker.state == CircuitBreaker.OPEN and before != CircuitBreaker.OPEN:
            _tel.count(
                "fleet_breaker_reopen_total"
                if before == CircuitBreaker.HALF_OPEN
                else "fleet_breaker_open_total"
            )
            _tel.record_event("fleet_breaker_open", replica=h.id, reason=why)
            if before != CircuitBreaker.HALF_OPEN:
                # a replica just died/wedged with requests on it: re-drive
                # them from the prompt on healthy peers NOW, not at the
                # next outcome poll
                self._failover_replica(h.id)

    # ------------------------------------------------------------ scoring
    @staticmethod
    def score(feed: Dict[str, Any], pending_local: int = 0) -> float:
        """Least-loaded score (lower is better): backlog per slot plus the
        p99 TTFT in seconds — occupancy says where room is, the latency
        tail says where room is a lie."""
        slots = max(1, int(feed.get("slots") or 1))
        backlog = (
            int(feed.get("queue_depth") or 0)
            + int(feed.get("inflight") or 0)
            + pending_local
        )
        ttft = feed.get("ttft_s") or {}
        p99 = ttft.get("p99") if isinstance(ttft, dict) else None
        return backlog / slots + float(p99 or 0.0)

    @staticmethod
    def _accepting(feed: Optional[Dict[str, Any]]) -> bool:
        """v2 feeds say it outright; v1 feeds fall back to ``draining``
        (the freeze contract: the router must run against v1)."""
        if feed is None:
            return False
        if "accepting" in feed:
            return bool(feed["accepting"])
        return not feed.get("draining", False)

    def _eligible(self, exclude: Sequence[str] = ()) -> List[_Replica]:
        now = self._now()
        return [
            h
            for h in self.replicas.values()
            if h.id not in exclude
            and h.breaker.dispatchable
            and h.feed is not None
            and self._accepting(h.feed)
            and now >= h.backoff_until
        ]

    def pick(
        self, session: Optional[str] = None, exclude: Sequence[str] = ()
    ) -> Optional[_Replica]:
        """The dispatch target: session affinity when a key is given
        (consistent-hash, healthy-filtered), else the least-loaded
        eligible replica."""
        elig = self._eligible(exclude)
        if not elig:
            return None
        if session is not None:
            rid = self.ring.lookup(str(session), [h.id for h in elig])
            if rid is not None:
                return self.replicas[rid]
        return min(
            elig,
            key=lambda h: (self.score(h.feed, h.pending_local), h.last_dispatch_at, h.id),
        )

    # ----------------------------------------------------------- dispatch
    def submit(
        self,
        req: Request,
        *,
        session: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ) -> FleetRecord:
        """Accept a request at fleet scope and dispatch it.  Always
        returns a record that WILL resolve: if no replica can take it,
        the record is already terminally ``shed`` (fleet-level shedding —
        only when every healthy replica is shedding or none is healthy)."""
        from .. import telemetry as _tel

        now = self._now()
        rec = FleetRecord(
            req=req,
            session=session,
            deadline_at=(now + deadline_s) if deadline_s else None,
            submitted_at=now,
        )
        self.ledger.submitted(rec)
        if self.journal is not None:
            # wall-clock deadline: a recovered router (a different
            # process, a different monotonic clock) re-anchors from it
            self.journal.append("submit", {
                "rid": req.rid,
                "req": request_payload(req, session=session),
                "deadline_wall": (time.time() + deadline_s) if deadline_s else None,
            })
        _tel.count("fleet_requests_total")
        self._dispatch(rec)
        _tel.set_gauge("fleet_pending_requests", self.ledger.pending_count())
        return rec

    def _remaining(self, rec: FleetRecord) -> float:
        if rec.deadline_at is None:
            return float("inf")
        return rec.deadline_at - self._now()

    def _resolve(
        self, rec: FleetRecord, status: str, outcome: Optional[Dict[str, Any]],
        replica_id: Optional[str], now: float,
    ) -> bool:
        """Journal-then-resolve: the terminal record is durable (flushed
        through the lease fence) BEFORE the outcome is acked into the
        ledger — a deposed leader's flush raises ``FencedEpochError``
        here, so a stale leader can never double-resolve a rid the new
        leader owns."""
        if self.journal is not None and rec.pending and status in TERMINAL:
            self.journal.append("terminal", {
                "rid": rec.req.rid, "status": status, "replica": replica_id,
                "outcome": slim_outcome(outcome),
            })
            self.journal.flush()
        return self.ledger.resolve(rec, status, outcome, replica_id, now)

    def _journal_drop(self, rec: FleetRecord, replica_id: str, why: str) -> None:
        """A rid left a replica WITHOUT a terminal (shed spill-over,
        failover): journaled so recovery's live_on — the set of replicas
        whose /outcomes may legitimately hold this rid's terminal row —
        stays exact (a stale shed row must not be harvestable)."""
        if self.journal is not None:
            self.journal.append(
                "drop", {"rid": rec.req.rid, "replica": replica_id, "why": why}
            )

    def _dispatch(
        self, rec: FleetRecord, exclude: Sequence[str] = (), kind: str = "dispatch",
        allow_shed: bool = True,
    ) -> bool:
        """Bounded retry-with-backoff placement.  ``kind`` is the ledger
        counter bucket: ``dispatch`` (first placement), ``redispatch``
        (replica shed/drain spill-over), ``failover`` (replica died),
        ``hedge`` (tail-latency second copy — ``allow_shed=False``: a
        failed hedge must never terminate a request still live on its
        original replica)."""
        from .. import telemetry as _tel

        excluded = list(exclude)
        backoff = self.backoff_s
        for attempt in range(max(1, self.dispatch_retries)):
            if self._remaining(rec) <= 0:
                self._resolve(
                    rec, "timed_out",
                    {"status": "timed_out", "tokens": [], "reason": "fleet deadline"},
                    None, self._now(),
                )
                _tel.count("fleet_timeout_total")
                return False
            self.poll()
            h = self.pick(session=rec.session, exclude=excluded)
            if h is None:
                if not allow_shed:
                    return False
                if self._all_healthy_shedding():
                    # fleet-level shedding: every healthy replica is already
                    # rejecting — the fleet's own admission control engages
                    return self._fleet_shed(rec, "every healthy replica shedding")
                if not any(x.breaker.dispatchable for x in self.replicas.values()):
                    if attempt + 1 >= self.dispatch_retries:
                        return self._fleet_shed(rec, "no healthy replica")
                # replicas exist but none eligible yet (unpolled feeds,
                # backoffs): bounded wait then try again
                wait = min(backoff, max(0.0, self._remaining(rec)))
                fleettrace.backoff(rec.req.rid, wait, "no eligible replica")
                self._sleep(wait)
                backoff = min(backoff * 2, self.backoff_max_s)
                continue
            self._tag_counter += 1
            # epoch-fenced dispatch token: a deposed leader's placements
            # carry its (older) epoch and can never tag-match a recovered
            # router's expectations.  epoch 0 keeps the pre-HA bare tag.
            tag = (
                make_tag(self.epoch, self._tag_counter)
                if self.epoch
                else self._tag_counter
            )
            # span tag only — skip the recompute entirely while dormant
            # (this is the hop cost the bench's <1% bar measures)
            score = (
                self.score(h.feed, h.pending_local)
                if (h.feed and fleettrace.is_active())
                else None
            )
            t0 = time.perf_counter()
            try:
                resp = h.client.submit(
                    request_payload(rec.req, session=rec.session, tag=tag)
                )
            except ReplicaUnreachable:
                fleettrace.dispatch_attempt(
                    rec.req.rid, h.id, tag, kind, time.perf_counter() - t0,
                    score=score, ok=False, reason="unreachable",
                )
                self._record_failure(h, "submit")
                excluded.append(h.id)
                wait = min(backoff, max(0.0, self._remaining(rec)))
                fleettrace.backoff(rec.req.rid, wait, f"{h.id} unreachable")
                self._sleep(wait)
                backoff = min(backoff * 2, self.backoff_max_s)
                continue
            if not resp.get("accepted", True):
                # synchronous backpressure: honor the replica's retry hint
                fleettrace.dispatch_attempt(
                    rec.req.rid, h.id, tag, kind, time.perf_counter() - t0,
                    score=score, ok=False, reason="rejected",
                )
                self._backoff_replica(h, resp.get("retry_after_s"))
                excluded.append(h.id)
                continue
            fleettrace.dispatch_attempt(
                rec.req.rid, h.id, tag, kind, time.perf_counter() - t0,
                score=score,
            )
            now = self._now()
            h.pending_local += 1
            h.dispatches += 1
            h.last_dispatch_at = now
            rec.tag_by_replica[h.id] = tag
            self.ledger.dispatched(rec, h.id, now)
            if self.journal is not None:
                # placement barrier: the replica ACCEPTED this dispatch —
                # journal it (and flush, so a pump-boundary crash can
                # never re-drive an already-placed rid into a duplicate)
                self.journal.append("dispatch", {
                    "rid": rec.req.rid, "replica": h.id, "tag": tag, "kind": kind,
                })
                self.journal.flush()
            if kind != "dispatch":
                rec.resubmissions += 1
                self.ledger.counts["redispatched"] += 1
                _tel.count("fleet_redispatch_total")
            if kind == "failover":
                rec.failovers += 1
                self.ledger.counts["failovers"] += 1
                _tel.count("fleet_failover_total")
            elif kind == "hedge":
                rec.hedged = True
                self.ledger.counts["hedges"] += 1
                _tel.count("fleet_hedge_total")
            _tel.count("fleet_dispatch_total")
            _tel.record_event(
                "fleet_dispatch", rid=rec.req.rid, replica=h.id, dispatch=kind,
            )
            return True
        if not allow_shed:
            return False
        return self._fleet_shed(rec, "dispatch retries exhausted")

    def _backoff_replica(self, h: _Replica, retry_after_s) -> None:
        hint = retry_after_s
        if hint is None and getattr(h.client, "last_retry_after_header", None):
            hint = h.client.last_retry_after_header
        h.backoff_until = self._now() + max(0.01, float(hint or 0.05))

    def _all_healthy_shedding(self) -> bool:
        healthy = [h for h in self.replicas.values() if h.breaker.dispatchable]
        now = self._now()
        return bool(healthy) and all(
            h.feed is not None
            and (not self._accepting(h.feed) or now < h.backoff_until)
            for h in healthy
        )

    def _fleet_shed(self, rec: FleetRecord, reason: str) -> bool:
        from .. import telemetry as _tel

        retry = min(
            (
                float(h.feed.get("retry_after_s") or 0.05)
                for h in self.replicas.values()
                if h.feed is not None
            ),
            default=0.05,
        )
        self._resolve(
            rec, "shed",
            {"status": "shed", "tokens": [], "reason": reason, "retry_after_s": retry},
            None, self._now(),
        )
        _tel.count("fleet_shed_total")
        _tel.record_event("fleet_shed", rid=rec.req.rid, reason=reason)
        return False

    # ----------------------------------------------------------- failover
    def _failover_replica(self, replica_id: str) -> None:
        """Re-drive every request in-flight on a dead/removed replica from
        the prompt on a healthy peer — the tokens replay bit-identically,
        and the fleet record counts the failover."""
        for rec in self.ledger.pending():
            if replica_id in rec.live_on:
                rec.live_on.remove(replica_id)
                self._journal_drop(rec, replica_id, "failover")
                if not rec.live_on:  # no hedge copy still running elsewhere
                    self._dispatch(rec, exclude=[replica_id], kind="failover")

    # -------------------------------------------------------------- pump
    def pump(self) -> int:
        """One router turn: poll due feeds, harvest terminal outcomes from
        replicas that hold in-flight work, enforce fleet deadlines, place
        hedges.  Returns the number of requests still pending."""
        from .. import telemetry as _tel
        from ..resilience import faultsim as _fs

        if _fs.fires("router_kill", ctx="pump"):
            # the ROUTER dies abruptly (the HA smoke's kill -9): no
            # flush, no cleanup — buffered journal records are LOST by
            # design, which is exactly what recovery must absorb
            os._exit(int(_config.get_int("VESCALE_FAULTSIM_KILL_EXIT_CODE") or 29))
        self.poll()
        now = self._now()
        # ---- harvest outcomes from every replica holding live work
        live_by_replica: Dict[str, List[FleetRecord]] = {}
        for rec in self.ledger.pending():
            for rid in rec.live_on:
                live_by_replica.setdefault(rid, []).append(rec)
        for replica_id, recs in live_by_replica.items():
            h = self.replicas.get(replica_id)
            if h is None or not h.breaker.dispatchable:
                continue
            try:
                outs = h.client.outcomes().get("outcomes", {})
            except ReplicaUnreachable:
                self._record_failure(h, "outcomes")
                continue
            for rec in recs:
                out = outs.get(str(rec.req.rid))
                if out is None or out.get("status") not in TERMINAL:
                    continue
                # tag gate: a row echoing a different dispatch token is a
                # STALE terminal from a prior dispatch of this rid to this
                # replica (the new submission is still in its inbox) —
                # consuming it would shed/redispatch a request the replica
                # is about to serve.  Tagless rows (pre-tag replicas) pass.
                out_tag = out.get("tag")
                expected = rec.tag_by_replica.get(h.id)
                if (
                    out_tag is not None
                    and expected is not None
                    and int(out_tag) != expected
                ):
                    if tag_epoch(int(out_tag)) != tag_epoch(expected):
                        # epoch-fenced rejection: a DEPOSED leader's
                        # placement landed late — visible, never consumed
                        _tel.count("fleet_stale_epoch_outcome_total")
                    continue
                self._on_outcome(rec, h, out)
        # ---- fleet deadline enforcement (bounds failover loops too)
        for rec in self.ledger.pending():
            if self._remaining(rec) <= 0:
                self._resolve(
                    rec, "timed_out",
                    {"status": "timed_out", "tokens": [], "reason": "fleet deadline"},
                    None, now,
                )
                _tel.count("fleet_timeout_total")
        # ---- hedging: a request stuck past the bound gets a second copy
        if self.hedge_s:
            for rec in self.ledger.pending():
                if (
                    not rec.hedged
                    and rec.live_on
                    and now - rec.last_dispatch_at > self.hedge_s
                    and self.pick(session=rec.session, exclude=rec.live_on) is not None
                ):
                    self._dispatch(
                        rec, exclude=list(rec.live_on), kind="hedge", allow_shed=False
                    )
        pending = self.ledger.pending_count()
        _tel.set_gauge("fleet_pending_requests", pending)
        self.obs.publish()  # fleet_timeline_* rollup gauges (dormant-gated)
        return pending

    def _on_outcome(self, rec: FleetRecord, h: _Replica, out: Dict[str, Any]) -> None:
        status = out["status"]
        if status == "completed" or status == "timed_out":
            # timed_out is the request's OWN deadline expiring on-replica:
            # resubmitting would break deadline semantics — it is final
            self._resolve(rec, status, out, h.id, self._now())
        elif status == "shed":
            # replica-level backpressure: honor the hint, spill elsewhere
            self._backoff_replica(h, out.get("retry_after_s"))
            if h.id in rec.live_on:
                rec.live_on.remove(h.id)
                self._journal_drop(rec, h.id, "shed")
            if not rec.live_on:
                if self._all_healthy_shedding():
                    self._fleet_shed(rec, "every healthy replica shedding")
                else:
                    self._dispatch(rec, exclude=[h.id], kind="redispatch")
        elif status == "preempted_requeue":
            # the replica is draining: it finished what it could, queued
            # work comes back re-queueable — re-drive it on a peer
            if h.id in rec.live_on:
                rec.live_on.remove(h.id)
                self._journal_drop(rec, h.id, "preempted_requeue")
            if not rec.live_on:
                self._dispatch(rec, exclude=[h.id], kind="redispatch")

    # -------------------------------------------------------------- drive
    def drain(
        self, timeout_s: float = 120.0, poll_slice_s: Optional[float] = None
    ) -> None:
        """Pump until every submitted request is terminal (the loop a
        smoke or bench runs).  Raises TimeoutError with the stuck rids if
        the fleet cannot settle inside ``timeout_s``."""
        deadline = self._now() + timeout_s
        slice_s = poll_slice_s if poll_slice_s is not None else self.poll_interval_s
        while True:
            if self.pump() == 0:
                return
            if self._now() > deadline:
                raise TimeoutError(
                    "fleet drain timed out with pending rids "
                    f"{[r.req.rid for r in self.ledger.pending()]}"
                )
            self._sleep(slice_s)

    # --------------------------------------------------------- router ops
    def start_ops(self, port: Optional[int] = None):
        """Start the ROUTER-side ops endpoints: ``/fleet`` (the aggregated
        fleet rollup, frozen schema ``obs.FLEET_FIELDS``), ``/healthz``
        (router liveness + wall clock), ``/alerts`` (the router's own
        alert-engine snapshot — the fleet-scope rules live HERE, not on
        any replica) and ``/metrics`` (this process's registry — the
        ``fleet_*`` counters live here).  Gated exactly
        like the replica endpoints: ``port`` overrides
        ``VESCALE_FLEET_OPS_PORT``; unset = OFF (no socket, no thread,
        returns None); 0 = auto-assign (read ``.port`` back)."""
        from ..telemetry import ops_server as _ops

        if port is None:
            port = _config.get_int("VESCALE_FLEET_OPS_PORT")
        if port is None:
            return None
        from .. import telemetry as _tel
        from ..telemetry import alerts as _alerts

        # /metrics reads the process registry live at start (503 while
        # telemetry is dormant)
        srv = _ops.OpsServer(port=int(port), registry=_tel.get_registry())
        srv.register("fleet", self.obs.fleet)
        srv.register("healthz", self.obs.health)
        srv.register("alerts", _alerts.payload)
        srv.start()
        self._ops = srv
        return srv

    def stop_ops(self) -> None:
        if self._ops is not None:
            self._ops.stop()
            self._ops = None

    # ------------------------------------------------------------- HA
    def _journal_extras(self) -> Dict[str, Any]:
        """The snapshot-only state the record tail can't reconstruct:
        ring membership + replica URLs, breaker states, the autoscaler's
        hold/cooldown clocks (attached by the Autoscaler), and the
        in-progress rollout stage (mirrored by RolloutController)."""
        return {
            "ring": list(self.ring.nodes()),
            "replica_urls": {
                rid: getattr(h.client, "base_url", None)
                for rid, h in self.replicas.items()
            },
            "breakers": {
                rid: h.breaker.state for rid, h in self.replicas.items()
            },
            "autoscale": (
                self.autoscale_journal_provider()
                if self.autoscale_journal_provider is not None
                else None
            ),
            "rollout": self.rollout_state,
        }

    def _ha_state(self) -> Optional[Dict[str, Any]]:
        """The ``/fleet`` v5 ``ha`` block: None while HA is off (journal
        and lease both absent), else leadership + journal health."""
        if self.journal is None and self.lease is None:
            return None
        out: Dict[str, Any] = {"role": "leader", "epoch": self.epoch}
        if self.journal is not None:
            out["journal"] = self.journal.stats()
        if self.lease is not None:
            out["lease"] = self.lease.read()
        if self.recovery is not None:
            out["recovery"] = dict(self.recovery)
        return out

    @classmethod
    def recover_from_journal(
        cls,
        journal,
        clients: Dict[str, Any],
        *,
        lease: Optional[LeaderLease] = None,
        harvest: bool = True,
        **router_kw,
    ) -> "FleetRouter":
        """Crash recovery: rebuild a router from the journal's
        snapshot+tail, then reconcile with the live fleet.

        ``journal`` is a :class:`~.journal.FleetJournal` or a directory
        path; ``clients`` maps replica_id -> transport (the recovered
        process re-establishes its own connections — URLs ride the
        snapshot's ``replica_urls`` if the caller wants to rebuild them).

        The sequence: replay (torn tail tolerated,
        CRC-bad records quarantined+counted) -> new epoch (lease acquire
        when fencing, else last_epoch+1) -> rebuild pending rids with
        their per-replica dispatch tags -> **harvest** already-finished
        outcomes from the replicas' ``/outcomes`` linger (exact tag
        match — idempotent: a row the dead leader already journaled
        terminal is never consumed twice) -> **re-drive** rids that were
        never placed from the prompt (bit-identical by decode
        determinism).  Ends with a fresh snapshot under the new epoch;
        ``router.recovery`` carries the audit the smoke asserts."""
        t0 = time.perf_counter()
        if isinstance(journal, str):
            journal = FleetJournal(journal)
        state = journal.state
        fr = cls(journal=journal, lease=lease, **router_kw)
        fr._tag_counter = int(state.get("tag_counter") or 0)
        led = fr.ledger
        for key, val in (state.get("counts") or {}).items():
            if key in led.counts:
                led.counts[key] = int(val)
        now = fr._now()
        wall = time.time()
        # ---- resolved rids: terminal history (tokens included) so the
        # ledger stays total over everything ever submitted
        for rid_s, row in (state.get("resolved") or {}).items():
            req = (
                request_from_payload(row["req"])
                if row.get("req")
                else Request(rid=int(rid_s), prompt=(0,), max_new_tokens=1)
            )
            rec = FleetRecord(
                req=req,
                session=(row.get("req") or {}).get("session"),
                status=row.get("status"),
                outcome=row.get("outcome"),
                replica=row.get("replica"),
                failovers=int(row.get("failovers") or 0),
                resubmissions=int(row.get("resubmissions") or 0),
                hedged=bool(row.get("hedged")),
                submitted_at=now,
                resolved_at=now,
            )
            led.records[req.rid] = rec
        # ---- pending rids: reconstructed WITH tags/live_on so harvest
        # can match rows exactly and stale rows stay unconsumable
        for rid_s, ent in (state.get("pending") or {}).items():
            req = request_from_payload(ent["req"]) if ent.get("req") else Request(
                rid=int(rid_s), prompt=(0,), max_new_tokens=1
            )
            dw = ent.get("deadline_wall")
            rec = FleetRecord(
                req=req,
                session=(ent.get("req") or {}).get("session"),
                deadline_at=(now + (float(dw) - wall)) if dw else None,
                live_on=list(ent.get("live_on") or ()),
                tag_by_replica={
                    str(r): int(t) for r, t in (ent.get("tags") or {}).items()
                },
                attempts=[(str(r), now) for r in (ent.get("attempts") or ())],
                resubmissions=int(ent.get("resubmissions") or 0),
                failovers=int(ent.get("failovers") or 0),
                hedged=bool(ent.get("hedged")),
                submitted_at=now,
            )
            led.records[req.rid] = rec
            led._pending[req.rid] = rec
        for rid, client in clients.items():
            fr.add_replica(rid, client)
        extras = state.get("extras") or {}
        # breaker states restore as-is; an OPEN breaker's cooldown clock
        # restarts NOW (conservative: one extra probe, never a stale close)
        for rid, bstate in (extras.get("breakers") or {}).items():
            h = fr.replicas.get(rid)
            if h is not None and bstate in (
                CircuitBreaker.OPEN, CircuitBreaker.HALF_OPEN,
            ):
                h.breaker.state = CircuitBreaker.OPEN
                h.breaker.opened_at = now
        fr.recovered_autoscale_state = extras.get("autoscale")
        fr.rollout_state = extras.get("rollout")
        pending_at_recovery = led.pending_count()
        harvested = redriven = 0
        if harvest:
            fr.poll(force=True)
            for rec in list(led.pending()):
                # harvest: any replica this rid is still live on may hold
                # its terminal row in the post-drain /outcomes linger
                for rep_id in list(rec.live_on):
                    h = fr.replicas.get(rep_id)
                    if h is None:
                        rec.live_on.remove(rep_id)
                        continue
                    try:
                        outs = h.client.outcomes().get("outcomes", {})
                    except ReplicaUnreachable:
                        continue  # breaker path fails it over on poll
                    out = outs.get(str(rec.req.rid))
                    if out is None or out.get("status") not in TERMINAL:
                        continue
                    out_tag = out.get("tag")
                    expected = rec.tag_by_replica.get(rep_id)
                    if (
                        out_tag is not None
                        and expected is not None
                        and int(out_tag) != expected
                    ):
                        continue  # stale row from a prior dispatch/epoch
                    fr._on_outcome(rec, h, out)
                    if not rec.pending:
                        harvested += 1
                        break
                # re-drive: a rid with NO live placement (its dispatch
                # records were lost with the crash, or its replicas are
                # gone) replays from the prompt — bit-identical tokens
                if rec.pending and not rec.live_on:
                    if fr._dispatch(rec, kind="failover"):
                        redriven += 1
        fr.recovery = {
            "pending_at_recovery": pending_at_recovery,
            "harvested": harvested,
            "redriven": redriven,
            "replayed_records": journal.replay_stats["records"],
            "quarantined": journal.replay_stats["quarantined"],
            "torn": journal.replay_stats["torn"],
            "epoch": fr.epoch,
            "takeover": False,
        }
        from .. import telemetry as _tel

        _tel.count("fleet_recover_total")
        fleettrace.recover_event(
            time.perf_counter() - t0,
            epoch=fr.epoch,
            records=journal.replay_stats["records"],
            quarantined=journal.replay_stats["quarantined"],
            pending=pending_at_recovery,
            harvested=harvested,
            redriven=redriven,
        )
        # fresh-epoch baseline: the next crash replays from HERE
        journal.write_snapshot(fr._journal_extras())
        return fr

    # ---------------------------------------------------------- reporting
    def fleet_ledger_check(self) -> None:
        self.ledger.check()

    def summary(self) -> Dict[str, Any]:
        """Aggregate fleet stats for the bench rung / smoke print."""
        per_replica = {
            h.id: {
                "breaker": h.breaker.state,
                "dispatches": h.dispatches,
                "opens": h.breaker.opens,
                "reopens": h.breaker.reopens,
                "closes": h.breaker.closes,
            }
            for h in self.replicas.values()
        }
        return {"counts": dict(self.ledger.counts), "replicas": per_replica}


class StandbyRouter:
    """Warm standby: tails the journal directory, watches the leader
    lease, and promotes itself to a full :class:`FleetRouter` (via
    :meth:`FleetRouter.recover_from_journal`) when the lease expires.

    The standby holds NO fleet state of its own between polls — the
    journal on shared storage IS the state, so a takeover is exactly a
    crash recovery plus an epoch bump (the lease acquire fences the old
    leader: its next flush raises :class:`~.journal.FencedEpochError`,
    and its already-placed dispatch tags carry the old epoch, so any
    outcome it might still try to claim is rejected by the tag gate).

    Call :meth:`poll` on a cadence faster than the lease TTL; it returns
    ``None`` while the leader is alive and the promoted ``FleetRouter``
    once takeover completes (subsequent calls return the same router)."""

    def __init__(
        self,
        journal_dir: str,
        clients: Dict[str, Any],
        *,
        lease: Optional[LeaderLease] = None,
        holder: str = "standby",
        router_kwargs: Optional[Dict[str, Any]] = None,
        journal_kwargs: Optional[Dict[str, Any]] = None,
    ):
        self.journal_dir = journal_dir
        self.clients = dict(clients)
        self.lease = lease or LeaderLease(
            os.path.join(journal_dir, "LEASE"), holder=holder
        )
        self.router_kwargs = dict(router_kwargs or {})
        self.journal_kwargs = dict(journal_kwargs or {})
        self.router: Optional[FleetRouter] = None
        self.takeovers = 0

    def tail(self) -> Dict[str, Any]:
        """Cheap standby-side view: replay the journal read-only and
        report its health (no router is built, nothing is written)."""
        from .journal import replay_dir

        state, stats = replay_dir(self.journal_dir)
        return {
            "epoch": state.get("epoch", 0),
            "pending": len(state.get("pending") or ()),
            "lease": self.lease.read(),
            **stats,
        }

    def poll(self) -> Optional[FleetRouter]:
        if self.router is not None:
            return self.router
        st = self.lease.read()
        if st is not None and not self.lease.expired(st):
            return None  # leader alive
        t0 = time.perf_counter()
        journal = FleetJournal(self.journal_dir, **self.journal_kwargs)
        fr = FleetRouter.recover_from_journal(
            journal, self.clients, lease=self.lease, **self.router_kwargs
        )
        fr.recovery["takeover"] = True
        self.router = fr
        self.takeovers += 1
        from .. import telemetry as _tel

        _tel.count("fleet_takeover_total")
        fleettrace.takeover_event(
            time.perf_counter() - t0,
            epoch=fr.epoch,
            reason="lease_expired" if st is not None else "no_leader",
        )
        return fr
