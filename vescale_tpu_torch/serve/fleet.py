"""Fleet harness: the replica side of multi-replica serving, and the
process supervisor that keeps N replicas alive.

The port of ``vescale_tpu/serve/fleet.py``.  Three pieces:

  * :class:`RequestInbox`: the thread-safe hand-off between the ops
    server's ``POST /submit`` handler and the serve loop, which drains it
    at every step boundary (scheduler state stays single-threaded).
  * :func:`serve_replica`: ``run_serve_resilient`` as a network-fed
    replica, speaking the JAX package's wire protocol:

      ``POST /submit``   one request into the inbox; replies ``accepted``
                         with the queue depth and retry hint (advisory:
                         the verdict is the ledger row ``/outcomes`` serves
                         later)
      ``GET /outcomes``  the terminal-outcome snapshot, keyed by rid
      ``GET /router``    the frozen v5 dispatch feed, ``/healthz``,
                         ``/metrics``; ``POST /control`` the weight rollout

    After a drain the endpoints linger so a router can harvest what the
    drain finished.
  * :class:`FleetSupervisor`: spawn N replica processes
    (:class:`ReplicaSpec`), notice one dying (crash, ``replica_kill``,
    OOM-kill) and respawn it with the same command, environment, port and
    replica id, so the router's half-open probe finds it again.  A clean
    SIGTERM drain (``stop``, ``drain``) is not restarted: that is
    scale-down, not failure.  ``spawn_like`` clones a spec onto a fresh
    port for the autoscaler.

The supervisor knows commands, exit codes and restart budgets, nothing
about HTTP: the router (``serve/router.py``) decides health.  A restarted
replica starts empty (the router already failed its work over), and the
fleet ledger's first-terminal-wins rule makes a late duplicate outcome
unrecordable.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

from ..telemetry import ops_server as _ops
from .. import config as _config
from .router import request_from_payload
from .scheduler import TERMINAL, ContinuousBatchingScheduler, Request

__all__ = ["RequestInbox", "serve_replica", "ReplicaSpec", "FleetSupervisor", "reserve_port"]


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


# ------------------------------------------------------------- supervisor
_RESERVED: List[int] = []


def reserve_port() -> int:
    """A free localhost port this process has never handed out before (the
    OS assigns one; the registry refuses same-process reuse, so two
    replicas spawned in a row cannot collide)."""
    for _ in range(128):
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        if port not in _RESERVED:
            _RESERVED.append(port)
            return port
    raise RuntimeError(f"could not reserve an unused port after 128 probes "
                       f"({len(_RESERVED)} already handed out)")


class ReplicaSpec:
    """How to (re)spawn one replica: the command line, its environment,
    the ops port the router polls, and a stable replica id."""

    def __init__(self, replica_id: str, cmd: Sequence[str], port: int,
                 env: Optional[Dict[str, str]] = None, log_path: Optional[str] = None,
                 restart_env_drop: Sequence[str] = ()):
        self.replica_id = replica_id
        self.cmd = list(cmd)
        self.port = int(port)
        self.env = dict(env) if env is not None else dict(os.environ)
        # every (re)spawn serves the same identity on the same port
        self.env["VESCALE_SERVE_REPLICA_ID"] = replica_id
        self.env["VESCALE_SERVE_OPS_PORT"] = str(port)
        self.log_path = log_path
        # removed from the env on RESPAWN only (the first spawn keeps them):
        # a VESCALE_FAULTSIM replica_kill must not re-kill the replacement
        self.restart_env_drop = tuple(restart_env_drop)

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"


class _Managed:
    def __init__(self, spec: ReplicaSpec):
        self.spec = spec
        self.proc: Optional[subprocess.Popen] = None
        self.log_file = None
        self.restarts = 0
        self.stopping = False  # SIGTERM sent on purpose: no respawn
        self.exit_history: List[int] = []


class FleetSupervisor:
    """Spawn, watch, restart.  ``poll()`` is the supervision turn, called
    from the caller's loop (no hidden threads).  A replica that exits while
    not ``stopping`` is respawned with the SAME spec up to
    ``max_restarts`` times, after ``restart_backoff_s``; its exit code is
    recorded either way."""

    def __init__(self, specs: Sequence[ReplicaSpec], *, max_restarts: int = 2,
                 restart_backoff_s: float = 0.2,
                 on_event: Optional[Callable[[str, str, Dict[str, Any]], None]] = None):
        self.managed: Dict[str, _Managed] = {s.replica_id: _Managed(s) for s in specs}
        self.max_restarts = max_restarts
        self.restart_backoff_s = restart_backoff_s
        self._on_event = on_event
        self._restart_at: Dict[str, float] = {}

    def _event(self, kind: str, replica_id: str, **fields) -> None:
        from .. import telemetry as _tel

        _tel.record_event(f"fleet_supervisor_{kind}", replica=replica_id, **fields)
        if self._on_event is not None:
            self._on_event(kind, replica_id, fields)

    def _spawn(self, m: _Managed) -> None:
        if m.log_file is None and m.spec.log_path is not None:
            m.log_file = open(m.spec.log_path, "ab")
        out = m.log_file if m.log_file is not None else subprocess.DEVNULL
        m.proc = subprocess.Popen(m.spec.cmd, env=m.spec.env, stdout=out,
                                  stderr=subprocess.STDOUT)

    def start(self) -> "FleetSupervisor":
        for m in self.managed.values():
            if m.proc is None:
                self._spawn(m)
                self._event("spawn", m.spec.replica_id, pid=m.proc.pid)
        return self

    def poll(self) -> None:
        """One supervision turn: reap exits, schedule and perform restarts
        (after ``restart_backoff_s``, so a crash-looping replica cannot
        hot-spin)."""
        from .. import telemetry as _tel

        now = time.monotonic()
        for rid, m in self.managed.items():
            if m.proc is None:
                due = self._restart_at.get(rid)
                if due is not None and m.stopping:
                    # stop() raced a scheduled restart: scale-down is final
                    del self._restart_at[rid]
                elif due is not None and now >= due:
                    del self._restart_at[rid]
                    m.restarts += 1
                    for k in m.spec.restart_env_drop:
                        m.spec.env.pop(k, None)
                    self._spawn(m)
                    _tel.count("fleet_replica_restarts_total")
                    self._event("restart", rid, pid=m.proc.pid, restarts=m.restarts)
                continue
            rc = m.proc.poll()
            if rc is None:
                continue
            m.exit_history.append(rc)
            m.proc = None
            if m.stopping:
                self._event("stopped", rid, returncode=rc)
            elif m.restarts < self.max_restarts:
                self._event("died", rid, returncode=rc)
                self._restart_at[rid] = now + self.restart_backoff_s
            else:
                self._event("gave_up", rid, returncode=rc, restarts=m.restarts)

    # ------------------------------------------------------------- control
    def spawn_like(self, template_id: str, replica_id: Optional[str] = None) -> ReplicaSpec:
        """Scale-up: clone ``template_id``'s spec onto a fresh
        :func:`reserve_port` port and a unique replica id (``<template>-sN``,
        the first free suffix; an explicit id already managed raises),
        spawn it and return the new spec (its ``.url`` goes to the router's
        ``add_replica``).  ``restart_env_drop`` vars are dropped from the
        clone's env up front: a fault aimed at the original fleet must not
        arm inside a scale-up replica."""
        tmpl = self.managed[template_id].spec
        if replica_id is None:
            n = 0
            while f"{template_id}-s{n}" in self.managed:
                n += 1
            replica_id = f"{template_id}-s{n}"
        elif replica_id in self.managed:
            raise ValueError(f"replica id {replica_id!r} already managed")
        env = dict(tmpl.env)
        for k in tmpl.restart_env_drop:
            env.pop(k, None)
        spec = ReplicaSpec(replica_id, tmpl.cmd, reserve_port(), env=env,
                           log_path=(f"{tmpl.log_path}.{replica_id}"
                                     if tmpl.log_path is not None else None),
                           restart_env_drop=tmpl.restart_env_drop)
        m = _Managed(spec)
        self.managed[replica_id] = m
        self._spawn(m)
        from .. import telemetry as _tel

        _tel.count("fleet_replica_scale_ups_total")
        self._event("spawn_like", replica_id, template=template_id, pid=m.proc.pid,
                    port=spec.port)
        return spec

    def drain(self, replica_id: str) -> None:
        """Non-blocking scale-down: SIGTERM now, reap in a later
        :meth:`poll`, so the autoscaler keeps pumping the router (and
        harvesting the replica's linger window) while it winds down.
        Never respawned."""
        from .. import telemetry as _tel

        self._begin_stop(replica_id, self.managed[replica_id])
        _tel.count("fleet_replica_scale_downs_total")
        self._event("drain", replica_id)

    def kill(self, replica_id: str) -> None:
        """A simulated hard crash (SIGKILL): respawned by a later
        :meth:`poll`, unlike :meth:`stop`."""
        m = self.managed[replica_id]
        if m.proc is not None:
            m.proc.kill()

    def _begin_stop(self, rid: str, m: _Managed) -> None:
        """Stopped on purpose: cancel any scheduled respawn and send the
        drain signal."""
        m.stopping = True
        self._restart_at.pop(rid, None)
        if m.proc is not None:
            m.proc.send_signal(signal.SIGTERM)

    def _reap(self, m: _Managed, grace_s: float) -> Optional[int]:
        """Wait out a signalled replica (SIGKILL after the grace window)
        and record its exit."""
        if m.proc is None:
            return m.exit_history[-1] if m.exit_history else None
        try:
            rc = m.proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            m.proc.kill()
            rc = m.proc.wait()
        m.exit_history.append(rc)
        m.proc = None
        self._event("stopped", m.spec.replica_id, returncode=rc)
        return rc

    def stop(self, replica_id: str, grace_s: float = 30.0) -> Optional[int]:
        """Clean scale-down: SIGTERM (the replica drains), wait, no
        respawn.  Returns the exit code (None if it never ran)."""
        m = self.managed[replica_id]
        self._begin_stop(replica_id, m)
        return self._reap(m, grace_s)

    def stop_all(self, grace_s: float = 30.0) -> Dict[str, Optional[int]]:
        for rid, m in self.managed.items():
            self._begin_stop(rid, m)  # signal every replica first: drains overlap
        out = {rid: self._reap(m, grace_s) for rid, m in self.managed.items()}
        for m in self.managed.values():
            if m.log_file is not None:
                m.log_file.close()
                m.log_file = None
        return out

    def alive(self, replica_id: str) -> bool:
        m = self.managed[replica_id]
        return m.proc is not None and m.proc.poll() is None
