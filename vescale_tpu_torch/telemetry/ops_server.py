"""Live ops endpoints: a small stdlib HTTP thread for one serve replica.

The port of ``vescale_tpu/telemetry/ops_server.py``.  One
``ThreadingHTTPServer`` daemon thread serves:

  ``/metrics``   the attached :class:`~.registry.Registry` (the serve
                 scheduler's) in the Prometheus text format; 503 without one
  ``/healthz``   liveness JSON from the registered provider (serve/obs.py)
  ``/router``    the replica's dispatch feed, frozen schema v5
                 (serve/obs.py), which the fleet router polls
  ``/outcomes``  the terminal-outcome ledger (serve/fleet.py registers it)
  ``/submit``    POST: one request into the replica's inbox (serve/fleet.py)
  ``/control``   POST: the weight-rollout channel (``reload``, ``commit``,
                 ``revert``, ``status``; serve/loop.py ``ControlChannel``)

Hardening, as in the JAX package:

  * **Atomic replies.**  Status line, headers and body leave in one
    ``write``: a poller racing a shutdown sees a whole reply or a closed
    connection, never half a body.
  * **Retry-After.**  ``/healthz`` and ``/router`` replies carry it while
    the replica drains or sheds (``retry_after_s`` rounded up to seconds).
  * **poll_blackhole.**  That faultsim kind makes a due ``/router`` or
    ``/healthz`` GET close the connection without a byte: a network
    partition for the fleet router's breaker.

The providers must not touch the card: they run on this thread while the
serve thread may be capturing or replaying the decode graph.

Gating: ``VESCALE_SERVE_OPS_PORT`` unset means :func:`maybe_start` returns
``None`` and creates no socket and no thread; ``0`` binds a free port
(read it back from ``OpsServer.port``).  The server binds localhost only.
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from .exporters import prometheus_text
from .registry import Registry

__all__ = ["OpsServer", "maybe_start", "active_server"]

Provider = Callable[[], Dict]

_ACTIVE: Optional["OpsServer"] = None
_LOCK = threading.Lock()

_GET_ENDPOINTS = ("healthz", "router", "outcomes")
_POST_ENDPOINTS = ("submit", "control")

_STATUS_TEXT = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    500: "Internal Server Error",
    503: "Service Unavailable",
}


class _Handler(BaseHTTPRequestHandler):
    server_version = "vescale-ops/2"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # no line on stderr per request
        pass

    def do_GET(self):  # noqa: N802 (stdlib naming)
        ops: "OpsServer" = self.server.ops  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        if path in ("/healthz", "/router"):
            from ..resilience import faultsim as _fs

            if _fs.fires("poll_blackhole", ctx=path):
                self.close_connection = True
                return
        if path == "/metrics":
            if ops.registry is None:
                self._send(503, "text/plain; charset=utf-8", "no registry attached\n")
            else:
                self._send(200, "text/plain; version=0.0.4; charset=utf-8",
                           prometheus_text(ops.registry))
        elif path.lstrip("/") in _GET_ENDPOINTS:
            self._json(ops.providers.get(path.lstrip("/")))
        else:
            self._send(404, "text/plain; charset=utf-8",
                       "not found (endpoints: /metrics /healthz /router /outcomes /submit "
                       "/control)\n")

    def do_POST(self):  # noqa: N802 (stdlib naming)
        ops: "OpsServer" = self.server.ops  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0].rstrip("/")
        provider = ops.providers.get(path.lstrip("/"))
        if path.lstrip("/") not in _POST_ENDPOINTS or provider is None:
            self._send(404, "text/plain; charset=utf-8",
                       "no POST provider registered for this endpoint\n")
            return
        try:
            n = int(self.headers.get("Content-Length") or 0)
            payload = json.loads(self.rfile.read(n).decode() or "{}")
        except (ValueError, UnicodeDecodeError) as e:
            self._send(400, "text/plain; charset=utf-8", f"bad request body: {e}\n")
            return
        try:
            body = json.dumps(provider(payload), sort_keys=True)
        except Exception as e:  # the submitter must see the failure
            self._send(500, "text/plain; charset=utf-8", f"provider error: {e}\n")
            return
        self._send(200, "application/json", body + "\n")

    def _json(self, provider: Optional[Provider]) -> None:
        if provider is None:
            self._send(503, "text/plain; charset=utf-8", "no provider registered for this endpoint\n")
            return
        try:
            payload = provider()
            body = json.dumps(payload, sort_keys=True)
        except Exception as e:  # a probe must see the failure, not a hang
            self._send(500, "text/plain; charset=utf-8", f"provider error: {e}\n")
            return
        self._send(200, "application/json", body + "\n",
                   extra_headers=_retry_after_headers(payload))

    def _send(self, code: int, ctype: str, body: str,
              extra_headers: Optional[Dict[str, str]] = None) -> None:
        """The whole reply in a single ``write``."""
        data = body.encode()
        head_lines = [
            f"HTTP/1.1 {code} {_STATUS_TEXT.get(code, 'Unknown')}",
            f"Server: {self.server_version}",
            f"Content-Type: {ctype}",
            f"Content-Length: {len(data)}",
        ]
        for k, v in (extra_headers or {}).items():
            head_lines.append(f"{k}: {v}")
        head_lines.append("Connection: close")
        head = ("\r\n".join(head_lines) + "\r\n\r\n").encode("latin-1")
        try:
            self.wfile.write(head + data)
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # the poller hung up first
        self.close_connection = True


def _retry_after_headers(payload) -> Optional[Dict[str, str]]:
    """A draining or shedding replica says so in the HTTP layer too."""
    if not isinstance(payload, dict):
        return None
    draining = bool(payload.get("draining"))
    shedding = bool(payload.get("shedding")) or payload.get("accepting") is False
    if not (draining or shedding):
        return None
    try:
        retry = float(payload.get("retry_after_s") or 1.0)
    except (TypeError, ValueError):
        retry = 1.0
    return {"Retry-After": str(max(1, math.ceil(retry)))}


class OpsServer:
    """One replica's ops endpoints on a daemon thread.

        srv = OpsServer(port=0, registry=sched.telemetry).start()
        srv.register("healthz", health_fn)       # fn() -> JSON-able dict
        srv.register("submit", submit_fn)        # fn(payload) -> dict
        ... GET http://127.0.0.1:{srv.port}/healthz ...
        srv.stop()
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[Registry] = None):
        self.host = host
        self.registry = registry
        self.providers: Dict[str, Callable] = {}
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.ops = self  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def register(self, endpoint: str, provider: Callable) -> "OpsServer":
        if endpoint not in _GET_ENDPOINTS + _POST_ENDPOINTS:
            raise ValueError(f"unknown ops endpoint {endpoint!r}")
        self.providers[endpoint] = provider
        return self

    def start(self) -> "OpsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="vescale-ops-server",
                kwargs={"poll_interval": 0.05}, daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        global _ACTIVE
        t, self._thread = self._thread, None
        if t is not None:
            self._httpd.shutdown()
            t.join(timeout=5.0)
        self._httpd.server_close()
        with _LOCK:
            if _ACTIVE is self:
                _ACTIVE = None

    def __enter__(self) -> "OpsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def maybe_start(
    health: Optional[Provider] = None,
    router: Optional[Provider] = None,
    port: Optional[int] = None,
    extra: Optional[Dict[str, Callable]] = None,
    registry: Optional[Registry] = None,
) -> Optional[OpsServer]:
    """Start an :class:`OpsServer` when ``VESCALE_SERVE_OPS_PORT`` is set
    (``port`` overrides), else do nothing and return ``None``.  ``extra``
    maps more endpoint names to providers.  The started server becomes the
    process's :func:`active_server`."""
    global _ACTIVE
    if port is None:
        from .. import config as _config

        port = _config.get_int("VESCALE_SERVE_OPS_PORT")
    if port is None:
        return None
    srv = OpsServer(port=int(port), registry=registry)
    if health is not None:
        srv.register("healthz", health)
    if router is not None:
        srv.register("router", router)
    for name, provider in (extra or {}).items():
        srv.register(name, provider)
    srv.start()
    with _LOCK:
        _ACTIVE = srv
    return srv


def active_server() -> Optional[OpsServer]:
    """The most recent :func:`maybe_start` server still running, if any."""
    return _ACTIVE
