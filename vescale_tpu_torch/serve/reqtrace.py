"""Per-request lifecycle tracing — the serve loop's span chains.

Training has a cross-rank trace timeline (``telemetry/trace.py``); this module gives
every *serving* request the same treatment: a span chain

    submit -> [queue-wait -> prefill -> decode-token[i]*]* -> terminal

emitted through the existing ndtimeline span machinery (Span objects into
the global ``NDTimerManager`` ring), so per-rank streams merge with
``telemetry.trace.merge_traces`` + its clock offsets into ONE Perfetto
timeline.  Rendering contract (ChromeTraceHandler):

  * every admitted-phase span carries ``stage = slot`` so each decode slot
    gets its own tid lane — the timeline reads as "what was slot 3 doing",
    exactly like a pipeline stage lane;
  * the submit span is tagged ``flow_role="send"`` / the terminal span
    ``flow_role="recv"`` on ``flow_id="req<rid>"``, so Perfetto draws one
    arrow from the moment the client submitted to the request's terminal
    outcome — the 900ms-TTFT question answered visually;
  * an eviction emits a ``serve-evict`` span in the victim's slot lane and
    the replay re-runs queue-wait -> prefill under the SAME rid: the chain
    visibly FORKS (two prefill spans, one rid) instead of silently
    restarting.

Taxonomy <-> ledger lockstep: the terminal span's ``outcome`` tag is the
scheduler ledger status verbatim, and :func:`verify_request_chains`
asserts the bijection — every ledger outcome has a complete chain, every
chain ends in a ledger outcome (the serve-obs smoke runs it over the
merged 2-rank trace under the full fault battery).

Gating: every emitter checks ``ndtimeline.api.is_active()`` first — a
dormant profiler pays one module-global check per call, no Span objects,
no ring growth (same contract as ``ndtimeit``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

from ..ndtimeline import predefined as _p
from ..ndtimeline.api import get_manager, is_active

__all__ = [
    "SERVE_SPAN_METRICS",
    "TERMINAL_OUTCOMES",
    "submit",
    "queue_wait",
    "prefill",
    "decode_step",
    "decode_token",
    "draft",
    "verify",
    "evict",
    "terminal",
    "request_spans",
    "classify_chains",
    "verify_request_chains",
]

# the full serve request-lifecycle span vocabulary (docs/observability.md)
SERVE_SPAN_METRICS = frozenset(
    (
        _p.SERVE_SUBMIT,
        _p.SERVE_QUEUE_WAIT,
        _p.SERVE_PREFILL,
        _p.SERVE_DECODE_STEP,
        _p.SERVE_DECODE_TOKEN,
        _p.SERVE_DRAFT,
        _p.SERVE_VERIFY,
        _p.SERVE_EVICT,
        _p.SERVE_TERMINAL,
    )
)
# outcomes a terminal span may carry == the scheduler ledger's TERMINAL set
TERMINAL_OUTCOMES = ("completed", "shed", "timed_out", "preempted_requeue")


def _flow(rid: int) -> str:
    return f"req{rid}"


def _record(metric: str, start: float, duration: float, tags: Dict) -> None:
    get_manager().record(metric, start, max(0.0, duration), tags)


# ------------------------------------------------------------- emitters
# All durations are perf_counter deltas; spans anchor on the epoch clock
# (time.time(), the ndtimeline convention) by subtracting the delta from
# "now" at emission — the two clocks only need to agree over the span's
# own length, never absolutely.

def submit(rid: int, step: int, tag: Optional[int] = None) -> None:
    """The chain's root: a zero-duration span at submission, flow SEND.
    ``tag`` is the request's opaque dispatch-attempt token (the fleet
    router stamps one per placement): carrying it on the submit span is
    what lets ``fleettrace.assemble_fleet_timeline`` stitch this replica
    chain to the router's dispatch-attempt span by construction."""
    if not is_active():
        return
    tags = {"rid": rid, "flow_id": _flow(rid), "flow_role": "send"}
    if tag is not None:
        tags["tag"] = tag
    _record(_p.SERVE_SUBMIT, time.time(), 0.0, tags)


def queue_wait(rid: int, slot: int, wait_s: float, replays: int = 0) -> None:
    """Emitted at ADMISSION, covering [submit, admit] (a replay's wait
    covers everything since the ORIGINAL submission — the client-honest
    view the TTFT stamps already take)."""
    if not is_active():
        return
    now = time.time()
    _record(
        _p.SERVE_QUEUE_WAIT, now - wait_s, wait_s,
        {"rid": rid, "slot": slot, "stage": slot, "replays": replays},
    )


def prefill(rid: int, slot: int, dur_s: float, tokens: Optional[int] = None) -> None:
    """``tokens`` (the prompt length) additionally stamps the calibrate
    harvest contract (``collective_op``/``axis_size``/``bytes``) so the
    cost auditor folds measured prefill wall times into the calibration
    table keyed by prompt size — the serve side's feed into online
    calibration."""
    if not is_active():
        return
    now = time.time()
    tags = {"rid": rid, "slot": slot, "stage": slot}
    if tokens is not None:
        tags.update(collective_op="serve_prefill", axis_size=2,
                    bytes=max(1, int(tokens)))
    _record(_p.SERVE_PREFILL, now - dur_s, dur_s, tags)


def decode_step(step: int, dur_s: float, active: int) -> None:
    """One span per batched decode step (host lane, no slot tag) — the
    per-step rollup and critical path read this one.  Also carries the
    calibrate harvest contract keyed by batch width, so the audited table
    learns measured decode step times (``serve_decode`` buckets — the
    scheduler's ``retry_after_s`` seed and drafter-depth hints read the
    rollup via ``CalibrationTable.op_estimate_us``)."""
    if not is_active():
        return
    now = time.time()
    _record(
        _p.SERVE_DECODE_STEP, now - dur_s, dur_s,
        {"serve_step": step, "active": active,
         "collective_op": "serve_decode", "axis_size": max(2, int(active)),
         "bytes": max(1, int(active))},
    )


def decode_token(rid: int, slot: int, index: int, dur_s: float) -> None:
    """Per-token span in the slot's lane: the batched step's wall time is
    each active slot's inter-token latency (they decode together)."""
    if not is_active():
        return
    now = time.time()
    _record(
        _p.SERVE_DECODE_TOKEN, now - dur_s, dur_s,
        {"rid": rid, "slot": slot, "stage": slot, "i": index},
    )


def draft(step: int, k: int, dur_s: float, active: int) -> None:
    """The drafter's k sequential proposal steps for one decode iteration
    (host lane, like serve-decode-step — speculative decoding only).
    Carries the calibrate harvest contract keyed by DEPTH (``bytes`` = k):
    the audited ``serve_draft`` buckets let ``speculative.suggested_k``
    price a draft launch against a measured decode step."""
    if not is_active():
        return
    now = time.time()
    _record(
        _p.SERVE_DRAFT, now - dur_s, dur_s,
        {"serve_step": step, "k": k, "active": active,
         "collective_op": "serve_draft", "axis_size": max(2, int(active)),
         "bytes": max(1, int(k))},
    )


def verify(step: int, dur_s: float, drafted: int, accepted: int,
           accept_rate: Optional[float]) -> None:
    """The target's ONE batched multi-token verify step: how many draft
    tokens had a chance this iteration, how many the target accepted, and
    the RUNNING acceptance rate (the `/router` v3 ``spec_accept_rate``
    value at emission time)."""
    if not is_active():
        return
    now = time.time()
    tags = {"serve_step": step, "drafted": drafted, "accepted": accepted}
    if accept_rate is not None:
        tags["accept_rate"] = round(float(accept_rate), 4)
    _record(_p.SERVE_VERIFY, now - dur_s, dur_s, tags)


def evict(rid: int, slot: int, reason: str, replays: int) -> None:
    """The fork marker: the admitted attempt ends here, the SAME rid's
    chain continues with a fresh queue-wait -> prefill."""
    if not is_active():
        return
    _record(
        _p.SERVE_EVICT, time.time(), 0.0,
        {"rid": rid, "slot": slot, "stage": slot, "reason": reason,
         "outcome": "evict_replay", "replays": replays},
    )


def terminal(rid: int, outcome: str, tokens: int, reason: Optional[str] = None,
             slot: Optional[int] = None) -> None:
    """The chain's end: outcome tag == the ledger status, flow RECV closes
    the submit->terminal arrow."""
    if not is_active():
        return
    tags = {
        "rid": rid, "outcome": outcome, "tokens": tokens,
        "flow_id": _flow(rid), "flow_role": "recv",
    }
    if reason is not None:
        tags["reason"] = reason
    if slot is not None:
        tags.update(slot=slot, stage=slot)
    _record(_p.SERVE_TERMINAL, time.time(), 0.0, tags)


# ------------------------------------------------------- chain analysis
def request_spans(spans: Sequence) -> Dict[int, Dict[str, List]]:
    """Group a (merged or per-rank) span stream's serve-lifecycle spans by
    request id: ``{rid: {metric: [spans sorted by start]}}``.  Non-serve
    spans and the per-step ``serve-decode-step`` rollup span (which carries
    no rid) are ignored."""
    out: Dict[int, Dict[str, List]] = {}
    for s in spans:
        if s.metric not in SERVE_SPAN_METRICS or not s.tags or "rid" not in s.tags:
            continue
        rid = int(s.tags["rid"])
        out.setdefault(rid, {}).setdefault(s.metric, []).append(s)
    for chains in out.values():
        for lst in chains.values():
            lst.sort(key=lambda s: s.start)
    return out


def classify_chains(
    spans: Sequence, outcomes: Dict[int, Dict],
    superseded: Optional[Sequence[int]] = None,
) -> Dict[int, str]:
    """Classify each rid's local span chain against a ledger:
    ``"ledger-matched"`` (the rid has a local terminal outcome),
    ``"superseded-by-failover"`` (the chain is stranded/incomplete here
    because the fleet router re-drove the request elsewhere — killed or
    partitioned replica, hedge loser; ``superseded`` names those rids,
    e.g. from ``fleettrace.superseded_rids``), or ``"orphan"`` (a chain
    no ledger and no failover explains — a verification failure)."""
    sup = {int(r) for r in (superseded or ())}
    ledger_rids = {int(r) for r in outcomes}
    out: Dict[int, str] = {}
    for rid in request_spans(spans):
        if rid in ledger_rids:
            out[rid] = "ledger-matched"
        elif rid in sup:
            out[rid] = "superseded-by-failover"
        else:
            out[rid] = "orphan"
    return out


def verify_request_chains(
    spans: Sequence, outcomes: Dict[int, Dict],
    superseded: Optional[Sequence[int]] = None,
) -> List[str]:
    """The taxonomy<->ledger lockstep check: every terminal ledger outcome
    must have a COMPLETE span chain, and every chain must end in a ledger
    outcome.  Returns a list of problem strings (empty == consistent); the
    serve-obs smoke asserts it empty per rank over the merged trace.

    ``superseded``: rids whose chain on THIS replica may legitimately be
    incomplete or unmatched because the fleet router re-drove the request
    on another replica (failover off a killed/partitioned replica, a
    hedge loser, a shed spill-over) — those chains classify as
    ``superseded-by-failover`` (:func:`classify_chains`) and are exempt
    from every check instead of failing verification as orphan chains.
    Compute the set from the fleet ledger with
    ``fleettrace.superseded_rids(ledger, replica_id)``.

    Completeness per outcome:
      * >=1 ``serve-submit`` span and >=1 ``serve-terminal`` span whose
        LAST occurrence's ``outcome`` tag equals the ledger status
        (a resubmitted rid legitimately carries older terminal spans, and
        ALL count checks below consider only its latest lifetime — spans
        at or after the last submit);
      * ``completed`` additionally requires queue-wait + prefill spans, at
        least ``len(tokens) - 1`` decode-token spans, and — when the ledger
        records replays — exactly ``replays + 1`` prefill spans (every fork
        re-prefilled and is visible);
      * any outcome's ``serve-evict`` span count must equal its ledger
        ``replays`` (a non-completed replay may still be waiting in the
        queue when its terminal lands, so only the evict count is exact).

    For a multi-rank merged stream, filter by ``span.rank`` first and
    verify each rank's stream against the (agreed) ledger separately.
    """
    problems: List[str] = []
    sup = {int(r) for r in (superseded or ())}
    chains = request_spans(spans)
    for rid, out in sorted(outcomes.items()):
        if int(rid) in sup:
            # resolved elsewhere in the fleet: any local row/chain is a
            # stale prior attempt — not this replica's to account for
            continue
        status = out.get("status")
        if status not in TERMINAL_OUTCOMES:
            problems.append(f"rid {rid}: non-terminal ledger status {status!r}")
            continue
        c = chains.get(int(rid))
        if c is None:
            problems.append(f"rid {rid}: in ledger ({status}) but no spans at all")
            continue
        subs = c.get(_p.SERVE_SUBMIT, [])
        if not subs:
            problems.append(f"rid {rid}: chain has no submit span")
        terms = c.get(_p.SERVE_TERMINAL, [])
        if not terms:
            problems.append(f"rid {rid}: chain has no terminal span")
        else:
            got = terms[-1].tags.get("outcome")
            if got != status:
                problems.append(
                    f"rid {rid}: last terminal span says {got!r}, ledger says {status!r}"
                )
        # a resubmitted rid (the retry_after contract) keeps its earlier
        # lifetimes' spans in the stream; the ledger describes only the
        # LATEST lifetime, so all count checks start at the last submit
        life_start = subs[-1].start if subs else float("-inf")

        def n_since(metric: str) -> int:
            return sum(1 for s in c.get(metric, ()) if s.start >= life_start)

        replays = int(out.get("replays", 0))
        n_prefill = n_since(_p.SERVE_PREFILL)
        n_evict = n_since(_p.SERVE_EVICT)
        if status == "completed":
            if not n_since(_p.SERVE_QUEUE_WAIT):
                problems.append(f"rid {rid}: completed without a queue-wait span")
            if n_prefill < 1:
                problems.append(f"rid {rid}: completed without a prefill span")
            need = max(0, len(out.get("tokens", ())) - 1)
            n_tok = n_since(_p.SERVE_DECODE_TOKEN)
            if n_tok < need:
                problems.append(
                    f"rid {rid}: {len(out.get('tokens', ()))} tokens but only "
                    f"{n_tok} decode-token spans (need >= {need})"
                )
        if n_evict != replays:
            problems.append(
                f"rid {rid}: ledger records {replays} replays but "
                f"{n_evict} evict spans"
            )
        if status == "completed" and replays and n_prefill != replays + 1:
            problems.append(
                f"rid {rid}: {replays} replays should fork into "
                f"{replays + 1} prefill spans, found {n_prefill}"
            )
    ledger_rids = {int(r) for r in outcomes}
    for rid in sorted(chains):
        if rid not in ledger_rids and rid not in sup:
            problems.append(f"rid {rid}: span chain with no ledger outcome (orphan)")
    return problems
