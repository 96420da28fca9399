"""Fleet-wide tracing: router span chains, the fleet timeline assembler,
and fleet-scope journey verification.

The port of ``vescale_tpu/serve/fleettrace.py`` over the port's
``ndtimeline``.  A request that bounces replica A -> breaker-open ->
failover to B leaves two disconnected span chains on two replicas; the
router's own waits (poll staleness, breaker cooldown, redispatch backoff)
would be invisible.  This module closes that gap:

  * **Router span emitters** — every routed request emits a router-side
    chain through the existing ndtimeline ring::

        fleet-submit -> fleet-dispatch-attempt[i]* -> fleet-terminal
                         (backoff forks between attempts; breaker
                          transitions as their own fleet-breaker spans)

    Dispatch-attempt spans carry the placement's ``score``, the target
    ``replica``, the attempt ``kind`` (``dispatch`` / ``failover`` /
    ``redispatch`` / ``hedge``) and the router-unique dispatch ``tag`` —
    the SAME tag that rides the ``/submit`` wire and is echoed in
    ``/outcomes``, so it doubles as the trace context that
    stitches router chains to replica chains by construction.  All
    emitters are ``is_active()``-gated no-ops while the profiler is
    dormant (the reqtrace contract).

  * **HTTP clock sync** — :func:`estimate_fleet_clock_offsets` reuses the
    round structure of ``telemetry.trace.estimate_clock_offsets`` over
    the ops endpoints: K rounds of ``GET /healthz`` per replica, offset =
    median of ``replica_wall - router_midpoint`` (NTP-style midpoint),
    residual bounded by the best round's half-RTT and the cross-round
    spread.  Replicas and router usually share no control plane — HTTP is
    the only wire they share.

  * **Fleet timeline assembler** — :func:`assemble_fleet_timeline` merges
    the router stream plus per-replica streams (replica-qualified lanes
    via ``merge_traces``' string-keyed form: no two replicas' rank-0
    spans can collide), applies the per-replica clock offsets, and
    stitches cross-process flow arrows router -> replica: each placed
    ``fleet-dispatch-attempt`` span (tag T) becomes the send end and the
    replica's ``serve-submit`` span echoing tag T the recv end of flow
    ``disp<T>`` — an A -> B failover renders as ONE visible journey.

  * **Journey verification** — :func:`verify_fleet_journeys` asserts
    every rid in the :class:`~.router.FleetLedger` maps to exactly one
    journey (one submit, one terminal whose outcome matches the ledger)
    with exactly ``failovers + 1`` dispatch sub-chains when failovers
    were the only re-drives (in general: one per ledgered attempt —
    ``1 + resubmissions``), zero orphan and zero duplicate journeys.
    :func:`superseded_rids` feeds ``reqtrace.verify_request_chains``'s
    ``superseded`` parameter so a chain stranded on a killed/partitioned
    replica classifies as ``superseded-by-failover`` instead of failing
    per-replica verification as an orphan.

``chip_smoke.py``'s ``fleet`` phase merges the router's and the
replicas' streams and verifies every journey against the fleet ledger.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Set

from .. import config as _config
from ..ndtimeline import predefined as _p
from ..ndtimeline.api import get_manager, is_active

__all__ = [
    "FLEET_SPAN_METRICS",
    "fleet_submit",
    "dispatch_attempt",
    "backoff",
    "breaker_transition",
    "fleet_terminal",
    "scale_event",
    "rollout_stage",
    "recover_event",
    "takeover_event",
    "FleetClockSync",
    "estimate_fleet_clock_offsets",
    "assemble_fleet_timeline",
    "fleet_process_names",
    "superseded_rids",
    "verify_fleet_journeys",
]

# the router-side journey span vocabulary
FLEET_SPAN_METRICS = frozenset(
    (
        _p.FLEET_SUBMIT,
        _p.FLEET_DISPATCH,
        _p.FLEET_BACKOFF,
        _p.FLEET_BREAKER,
        _p.FLEET_TERMINAL,
    )
)


def _flow(rid: int) -> str:
    # distinct from the replica-side "req<rid>" flow: both arrows appear
    # in one merged timeline and must not alias
    return f"fleet{rid}"


def _record(metric: str, start: float, duration: float, tags: Dict) -> None:
    get_manager().record(metric, start, max(0.0, duration), tags)


# ------------------------------------------------------------- emitters
def fleet_submit(rid: int, session: Optional[str] = None) -> None:
    """The journey's root: a zero-duration span at fleet submission, flow
    SEND on ``fleet<rid>`` (closed by :func:`fleet_terminal`)."""
    if not is_active():
        return
    tags: Dict[str, Any] = {"rid": rid, "flow_id": _flow(rid), "flow_role": "send"}
    if session is not None:
        tags["session"] = session
    _record(_p.FLEET_SUBMIT, time.time(), 0.0, tags)


def dispatch_attempt(
    rid: int, replica: str, tag: int, kind: str, dur_s: float,
    score: Optional[float] = None, ok: bool = True,
    reason: Optional[str] = None,
) -> None:
    """One placement attempt, covering the ``/submit`` round trip.  A
    PLACED attempt (``ok=True``) starts one dispatch sub-chain of the
    journey; its ``tag`` is the stitch point to the replica's chain.
    Failed attempts (unreachable replica, synchronous rejection) stay
    visible with ``ok=False`` — the retry/backoff story is the point."""
    if not is_active():
        return
    now = time.time()
    tags: Dict[str, Any] = {
        "rid": rid, "replica": replica, "tag": tag, "kind": kind, "ok": ok,
    }
    if score is not None:
        tags["score"] = round(float(score), 6)
    if reason is not None:
        tags["reason"] = reason
    _record(_p.FLEET_DISPATCH, now - dur_s, dur_s, tags)


def backoff(rid: int, dur_s: float, reason: str) -> None:
    """A backoff fork between dispatch attempts (no eligible replica,
    unreachable submit): the wait is real tail latency — make it a span,
    not a gap."""
    if not is_active():
        return
    now = time.time()
    _record(_p.FLEET_BACKOFF, now - dur_s, dur_s, {"rid": rid, "reason": reason})


def breaker_transition(replica: str, old: str, new: str, reason: str) -> None:
    """One circuit-breaker state transition (closed -> open -> half_open
    -> closed …) as a zero-duration span, so the breaker's history reads
    inline on the merged timeline next to the journeys it re-routed."""
    if not is_active():
        return
    _record(
        _p.FLEET_BREAKER, time.time(), 0.0,
        {"replica": replica, "from": old, "to": new, "reason": reason},
    )


def fleet_terminal(
    rid: int, status: str, replica: Optional[str], tokens: int,
    failovers: int = 0,
) -> None:
    """The journey's end: ``outcome`` is the FleetLedger status verbatim,
    flow RECV closes the fleet-submit -> fleet-terminal arrow."""
    if not is_active():
        return
    tags: Dict[str, Any] = {
        "rid": rid, "outcome": status, "tokens": tokens,
        "failovers": failovers,
        "flow_id": _flow(rid), "flow_role": "recv",
    }
    if replica is not None:
        tags["replica"] = replica
    _record(_p.FLEET_TERMINAL, time.time(), 0.0, tags)


def scale_event(direction: str, replica: str, reason: str,
                dur_s: float = 0.0) -> None:
    """One autoscaler decision (``direction`` is ``up`` or ``down``) as a
    span in the router's stream — the spawn/drain reads inline on the
    merged timeline next to the load spike that caused it."""
    if not is_active():
        return
    now = time.time()
    _record(_p.FLEET_SCALE, now - dur_s, dur_s,
            {"direction": direction, "replica": replica, "reason": reason})


def rollout_stage(replica: str, stage: str, dur_s: float, ok: bool = True,
                  reason: Optional[str] = None,
                  checkpoint: Optional[str] = None) -> None:
    """One weight-rollout stage (``drain`` / ``baseline`` / ``swap`` /
    ``canary`` / ``committed`` / ``rolled_back`` / ``reverted``) as a
    span — emitted replica-side by the serve loop's reload machine and
    router-side by the RolloutController's fleet legs, so the whole
    rolling rollout stitches onto one merged timeline."""
    if not is_active():
        return
    now = time.time()
    tags: Dict[str, Any] = {"replica": replica, "stage": stage, "ok": ok}
    if reason is not None:
        tags["reason"] = reason
    if checkpoint is not None:
        tags["checkpoint"] = checkpoint
    _record(_p.FLEET_ROLLOUT, now - dur_s, dur_s, tags)


def recover_event(dur_s: float, *, epoch: int, records: int,
                  quarantined: int, pending: int, harvested: int,
                  redriven: int) -> None:
    """One crash recovery (journal replay -> harvest -> re-drive) as a
    span in the router's stream — the whole reconstruction reads inline
    on the merged timeline, sized by how long the fleet ran leaderless."""
    if not is_active():
        return
    now = time.time()
    _record(_p.FLEET_RECOVER, now - dur_s, dur_s, {
        "epoch": epoch, "records": records, "quarantined": quarantined,
        "pending": pending, "harvested": harvested, "redriven": redriven,
    })


def takeover_event(dur_s: float, *, epoch: int, reason: str) -> None:
    """A warm-standby promotion: the lease expired and the standby's
    tail became the fleet's ledger.  ``epoch`` is the NEW fenced epoch —
    every dispatch tag after this span carries it."""
    if not is_active():
        return
    now = time.time()
    _record(_p.FLEET_TAKEOVER, now - dur_s, dur_s,
            {"epoch": epoch, "reason": reason})


# ------------------------------------------------------- HTTP clock sync
@dataclasses.dataclass
class FleetClockSync:
    """Per-replica host-clock offsets relative to the ROUTER's clock
    (microseconds, ``offsets_us[rid]`` = replica rid's clock minus the
    router's), plus a per-replica residual bound: offsets from two
    processes are comparable only down to that granularity.  Duck-types
    the ``offset_s`` interface ``merge_traces`` accepts, keyed by stream
    id (unknown streams — the router itself — align at 0)."""

    offsets_us: Dict[str, float]
    residual_us: Dict[str, float]
    rounds: int

    def offset_s(self, key) -> float:
        return self.offsets_us.get(str(key), 0.0) / 1e6

    def max_residual_us(self) -> float:
        return max(self.residual_us.values(), default=0.0)

    def as_dict(self) -> Dict:
        return {
            "offsets_us": dict(self.offsets_us),
            "residual_us": dict(self.residual_us),
            "rounds": self.rounds,
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "FleetClockSync":
        return cls(
            offsets_us={str(k): float(v) for k, v in d["offsets_us"].items()},
            residual_us={str(k): float(v) for k, v in d["residual_us"].items()},
            rounds=int(d.get("rounds", 0)),
        )


def estimate_fleet_clock_offsets(
    clients: Mapping[str, Any], rounds: Optional[int] = None
) -> FleetClockSync:
    """Estimate each replica's clock offset vs the router over the ops
    endpoints (the ``estimate_clock_offsets`` round structure on HTTP):
    per round, sample the router wall clock before and after
    ``GET /healthz`` and take ``replica_wall_time_us`` against the
    midpoint; the offset is the cross-round MEDIAN, the residual the max
    of the best round's half-RTT and half the cross-round spread.

    ``clients``: ``{replica_id: client}`` with a ``poll_health()``
    returning the ``/healthz`` payload (its ``wall_time_us`` field —
    replicas predating it, or unreachable ones, are skipped and align at
    offset 0 with an infinite residual recorded as -1)."""
    if rounds is None:
        rounds = _config.get_int("VESCALE_CLOCK_SYNC_ROUNDS") or 8
    rounds = max(1, int(rounds))
    offsets: Dict[str, float] = {}
    residuals: Dict[str, float] = {}
    for rid, client in clients.items():
        samples: List[float] = []
        half_rtts: List[float] = []
        for _ in range(rounds):
            t0 = time.time()
            try:
                health = client.poll_health()
            except Exception:
                continue  # a dead replica cannot skew the others' sync
            t1 = time.time()
            wall = health.get("wall_time_us") if isinstance(health, dict) else None
            if wall is None:
                break  # pre-field replica: no estimate possible
            samples.append(float(wall) - (t0 + t1) / 2.0 * 1e6)
            half_rtts.append((t1 - t0) * 1e6 / 2.0)
        if not samples:
            residuals[str(rid)] = -1.0  # explicit "no estimate" marker
            continue
        offsets[str(rid)] = float(statistics.median(samples))
        spread = (max(samples) - min(samples)) / 2.0 if len(samples) > 1 else 0.0
        residuals[str(rid)] = max(min(half_rtts), spread)
    return FleetClockSync(offsets_us=offsets, residual_us=residuals, rounds=rounds)


# --------------------------------------------------------- the assembler
def _add_flow(span, fid: str, role: str) -> None:
    """Append a flow endpoint to a span's tags, upgrading scalar
    flow_id/flow_role to parallel lists when the span already carries one
    (ChromeTraceHandler renders every pair)."""
    tags = span.tags
    cur_f, cur_r = tags.get("flow_id"), tags.get("flow_role")
    if cur_f is None:
        tags["flow_id"], tags["flow_role"] = fid, role
        return
    fids = list(cur_f) if isinstance(cur_f, (list, tuple)) else [cur_f]
    roles = list(cur_r) if isinstance(cur_r, (list, tuple)) else [cur_r]
    if fid in fids:
        return
    fids.append(fid)
    roles.append(role)
    tags["flow_id"], tags["flow_role"] = fids, roles


def assemble_fleet_timeline(
    streams: Mapping[str, Sequence], clock=None
) -> List:
    """Merge the router's span stream plus per-replica streams into ONE
    fleet timeline: replica-qualified pid lanes (``merge_traces`` string
    keys — conventionally ``"router"`` plus each replica id), per-stream
    clock alignment (:class:`FleetClockSync`), and stitched cross-process
    flow arrows: each placed ``fleet-dispatch-attempt`` span (tag T) is
    paired with the replica ``serve-submit`` span echoing tag T on flow
    ``disp<T>`` — the arrow that makes an A -> B failover read as one
    journey.  Returns the merged spans (feed
    :func:`fleet_process_names` to ``write_perfetto``)."""
    from ..telemetry.trace import merge_traces

    merged = merge_traces(streams, clock=clock)
    placed: Dict[int, Any] = {}
    for s in merged:
        if (
            s.metric == _p.FLEET_DISPATCH
            and s.tags
            and s.tags.get("tag") is not None
            and s.tags.get("ok", True)
        ):
            placed[int(s.tags["tag"])] = s
    for s in merged:
        if s.metric != _p.SERVE_SUBMIT or not s.tags:
            continue
        tag = s.tags.get("tag")
        if tag is None:
            continue
        d = placed.get(int(tag))
        if d is None:
            continue
        _add_flow(d, f"disp{int(tag)}", "send")
        _add_flow(s, f"disp{int(tag)}", "recv")
    return merged


def fleet_process_names(streams: Mapping[str, Sequence]) -> Dict[int, str]:
    """``write_perfetto(process_names=...)`` labels for an assembled fleet
    timeline (delegates to ``trace.stream_process_names``)."""
    from ..telemetry.trace import stream_process_names

    return stream_process_names(streams)


# ------------------------------------------------------------ verification
def superseded_rids(ledger, replica_id: str) -> Set[int]:
    """Rids that were dispatched to ``replica_id`` at some point but whose
    journey resolved elsewhere (another replica after a failover / shed
    spill / hedge win, or at the router itself — fleet deadline or fleet
    shed).  Their local chains on ``replica_id`` are legitimately
    incomplete: pass this set as ``reqtrace.verify_request_chains``'s
    ``superseded`` parameter so they classify as
    ``superseded-by-failover`` instead of orphan chains."""
    out: Set[int] = set()
    for rec in ledger.records.values():
        visited = any(a == replica_id for a, _ in rec.attempts)
        if visited and rec.replica != replica_id:
            out.add(rec.req.rid)
    return out


def verify_fleet_journeys(spans: Sequence, ledger, require_stitch: bool = False) -> List[str]:
    """The fleet-scope lockstep check over a merged (or router-only) span
    stream: every rid in the FleetLedger maps to EXACTLY ONE journey —
    one ``fleet-submit``, one ``fleet-terminal`` whose ``outcome`` tag is
    the ledger status verbatim — with exactly one dispatch sub-chain per
    ledgered placement (``1 + resubmissions``; when failovers were the
    only re-drives that is exactly ``failovers + 1``), the per-kind
    failover count matching the record, zero duplicate terminals and zero
    orphan journeys.  A resubmitted rid (the retry_after contract) is
    checked over its LATEST lifetime (spans at/after the last submit).

    ``require_stitch=True`` additionally asserts that each completed
    journey's WINNING dispatch tag has a matching replica ``serve-submit``
    span in the stream — the cross-process stitch is real, not assumed
    (use on assembled fleet timelines that include the replica streams).

    Returns a list of problem strings; empty == every journey verified.
    """
    problems: List[str] = []
    submits: Dict[int, List] = {}
    dispatches: Dict[int, List] = {}
    terminals: Dict[int, List] = {}
    replica_submit_tags: Set[int] = set()
    for s in spans:
        tags = s.tags or {}
        if s.metric == _p.SERVE_SUBMIT and tags.get("tag") is not None:
            replica_submit_tags.add(int(tags["tag"]))
        if s.metric not in FLEET_SPAN_METRICS or "rid" not in tags:
            continue
        rid = int(tags["rid"])
        if s.metric == _p.FLEET_SUBMIT:
            submits.setdefault(rid, []).append(s)
        elif s.metric == _p.FLEET_DISPATCH:
            dispatches.setdefault(rid, []).append(s)
        elif s.metric == _p.FLEET_TERMINAL:
            terminals.setdefault(rid, []).append(s)
    for lst in (submits, dispatches, terminals):
        for v in lst.values():
            v.sort(key=lambda s: s.start)

    for rid, rec in sorted(ledger.records.items()):
        subs = submits.get(rid, [])
        if not subs:
            problems.append(f"rid {rid}: in fleet ledger but no fleet-submit span")
            continue
        life_start = subs[-1].start
        terms = [t for t in terminals.get(rid, ()) if t.start >= life_start]
        if len(terms) != 1:
            problems.append(
                f"rid {rid}: expected exactly one fleet-terminal for the "
                f"latest lifetime, found {len(terms)} (duplicate or missing "
                "journey)"
            )
        if terms and terms[-1].tags.get("outcome") != rec.status:
            problems.append(
                f"rid {rid}: terminal span says {terms[-1].tags.get('outcome')!r}, "
                f"fleet ledger says {rec.status!r}"
            )
        placed = [
            d for d in dispatches.get(rid, ())
            if d.start >= life_start and d.tags.get("ok", True)
        ]
        expected = len(rec.attempts)
        if len(placed) != expected:
            problems.append(
                f"rid {rid}: {expected} ledgered placements "
                f"(failovers={rec.failovers}, resubmissions="
                f"{rec.resubmissions}) but {len(placed)} dispatch sub-chains"
            )
        n_failover = sum(1 for d in placed if d.tags.get("kind") == "failover")
        if n_failover != rec.failovers:
            problems.append(
                f"rid {rid}: ledger records {rec.failovers} failovers but "
                f"{n_failover} failover dispatch spans"
            )
        # the headline invariant: failovers as the ONLY re-drives means
        # exactly failovers + 1 dispatch sub-chains
        if (
            rec.attempts
            and rec.resubmissions == rec.failovers
            and len(placed) != rec.failovers + 1
        ):
            problems.append(
                f"rid {rid}: failover-only journey should have "
                f"{rec.failovers + 1} dispatch sub-chains, found {len(placed)}"
            )
        if require_stitch and rec.status == "completed" and rec.replica is not None:
            win_tag = rec.tag_by_replica.get(rec.replica)
            if win_tag is not None and int(win_tag) not in replica_submit_tags:
                problems.append(
                    f"rid {rid}: winning dispatch tag {win_tag} (replica "
                    f"{rec.replica}) has no stitched replica serve-submit span"
                )
    ledger_rids = set(ledger.records)
    for rid in sorted(set(submits) | set(terminals)):
        if rid not in ledger_rids:
            problems.append(f"rid {rid}: fleet journey with no ledger record (orphan)")
    return problems
