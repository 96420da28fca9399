"""The replica side of multi-replica serving: a network-fed serve loop.

The port of ``RequestInbox``, ``_outcomes_snapshot`` and ``serve_replica``
from ``vescale_tpu/serve/fleet.py``, with a copy of ``request_from_payload``
from ``vescale_tpu/serve/router.py``.  A replica speaks the JAX package's
wire protocol, so the reference ``FleetRouter`` drives it unchanged:

  ``POST /submit``   one request into the inbox; replies ``accepted`` with
                     the queue depth and retry hint (advisory: the verdict
                     is the ledger row ``/outcomes`` serves later)
  ``GET /outcomes``  the terminal-outcome snapshot, keyed by rid
  ``GET /router``    the frozen v5 dispatch feed, ``/healthz``, ``/metrics``

The router and its process supervisor are not ported yet.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from ..telemetry import ops_server as _ops
from .. import config as _config
from .scheduler import TERMINAL, ContinuousBatchingScheduler, Request

__all__ = ["RequestInbox", "request_from_payload", "serve_replica"]


def request_from_payload(d: Dict[str, Any]) -> Request:
    """A ``/submit`` body back into a :class:`Request` (validation is the
    dataclass's: empty prompts and bad budgets raise here, on the serving
    side of the wire)."""
    return Request(
        rid=int(d["rid"]),
        prompt=tuple(int(t) for t in d["prompt"]),
        max_new_tokens=int(d.get("max_new_tokens", 16)),
        eos_id=(None if d.get("eos_id") is None else int(d["eos_id"])),
        deadline_steps=(None if d.get("deadline_steps") is None else int(d["deadline_steps"])),
        tag=(None if d.get("tag") is None else int(d["tag"])),
        tenant=str(d.get("tenant") or "default"),
    )


class RequestInbox:
    """Thread-safe hand-off: the ops thread pushes, the serve loop drains at
    step boundaries (scheduler state stays single-threaded).  ``close()``
    ends an inbox-fed loop once everything is terminal."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: Deque[Request] = deque()
        self._closed = False
        self.pushed_total = 0

    def push(self, req: Request) -> bool:
        with self._lock:
            if self._closed:
                return False
            self._pending.append(req)
            self.pushed_total += 1
            return True

    def drain(self) -> List[Request]:
        with self._lock:
            out = list(self._pending)
            self._pending.clear()
        return out

    def close(self) -> None:
        with self._lock:
            self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed


def _outcomes_snapshot(scheduler: ContinuousBatchingScheduler) -> Dict[str, Any]:
    """Terminal rows only (``evicted_replay`` is internal to the replica).
    Terminal rows are never mutated after they land, so reading them from
    the ops thread is safe."""
    rows = {}
    for rid, rec in list(scheduler.outcomes.items()):
        if rec.get("status") in TERMINAL:
            rows[str(rid)] = {
                "status": rec["status"],
                "tokens": list(rec.get("tokens") or ()),
                "replays": rec.get("replays", 0),
                "retry_after_s": rec.get("retry_after_s"),
                "reason": rec.get("reason"),
                # the dispatch attempt's token: the router rejects rows of a
                # prior dispatch of the same rid with it
                "tag": rec.get("tag"),
            }
    return rows


def serve_replica(
    *,
    engine,
    scheduler: ContinuousBatchingScheduler,
    replica_id: Optional[str] = None,
    port: Optional[int] = None,
    linger_s: float = 0.5,
    max_steps: int = 1_000_000_000,
    inbox: Optional[RequestInbox] = None,
    **loop_kwargs,
) -> Any:
    """Run one network-fed replica until a preemption drain (SIGTERM) or
    its inbox closes; returns the loop's ``ServeResult``.

    The ops server starts here (``port`` overrides ``VESCALE_SERVE_OPS_PORT``;
    0 = a free port) and goes into ``run_serve_resilient``, which registers
    ``/healthz`` and ``/router`` on it; this wrapper registers ``/submit``,
    ``/outcomes`` and ``/control``, the weight-rollout channel (``control``,
    a ``ControlChannel``; one is made when none is given).  After the loop returns the endpoints keep answering
    for ``linger_s`` (``/healthz`` says ``terminated``, ``/submit`` refuses)
    so a router mid-poll can harvest what the drain finished."""
    from .loop import ControlChannel, run_serve_resilient

    name = replica_id or _config.get_str("VESCALE_SERVE_REPLICA_ID") or f"pid{os.getpid()}"
    if port is None:
        port = _config.get_int("VESCALE_SERVE_OPS_PORT") or 0
    if inbox is None:
        inbox = RequestInbox()

    def _submit(payload: Dict[str, Any]) -> Dict[str, Any]:
        accepted = inbox.push(request_from_payload(payload))
        return {
            "accepted": accepted,
            "replica_id": name,
            "queue_depth": len(scheduler.queue),
            "retry_after_s": scheduler.retry_after_s(),
        }

    def _outcomes() -> Dict[str, Any]:
        return {
            "replica_id": name,
            "outcomes": _outcomes_snapshot(scheduler),
            "counts": dict(scheduler.counts),
        }

    control = loop_kwargs.pop("control", None) or ControlChannel()
    srv = _ops.OpsServer(port=int(port), registry=scheduler.telemetry)
    srv.register("submit", _submit).register("outcomes", _outcomes)
    srv.register("control", control.provider)
    srv.start()
    try:
        result = run_serve_resilient(
            engine=engine, scheduler=scheduler, arrivals=(), inbox=inbox, ops=srv,
            max_steps=max_steps, replica_id=name, control=control, **loop_kwargs,
        )
        # linger: the drain's last completions must stay harvestable
        inbox.close()
        final_health = {"ok": False, "draining": True, "terminated": True,
                        "replica_id": name, "status": result.status}
        srv.register("healthz", lambda: dict(final_health))
        if linger_s > 0:
            time.sleep(linger_s)
        return result
    finally:
        srv.stop()
