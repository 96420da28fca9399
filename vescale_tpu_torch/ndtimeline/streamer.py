"""Multi-process span streaming — collector + per-rank sender.

Capability parity with the reference's NDtimelineStreamer
(legacy/vescale/ndtimeline/sock_streamer.py): every rank's timer flushes
span batches over a socket to one collector process, which runs the
registered handlers (aggregation, chrome trace, logs) over the merged
stream.

Each process is one sender.  A unix socket path serves the single-host
multi-process case; a ``(host, port)`` tuple serves multi-host.

Wire format: 4-byte big-endian length + JSON array of span dicts, the
JAX package's byte for byte (either package's sender feeds either
collector).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
from typing import Callable, List, Optional, Sequence, Tuple, Union

from .timer import Span

__all__ = ["NDtimelineStreamer", "SockHandler"]

Addr = Union[str, Tuple[str, int]]


def _make_server_socket(addr: Addr) -> socket.socket:
    if isinstance(addr, str):
        try:
            os.unlink(addr)
        except FileNotFoundError:
            pass
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.bind(addr)
    else:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(tuple(addr))
    s.listen(128)
    return s


def _connect(addr: Addr, timeout: Optional[float] = None) -> socket.socket:
    if isinstance(addr, str):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)  # before connect: an absent collector must not block
        s.connect(addr)
        return s
    return socket.create_connection(tuple(addr), timeout=timeout)


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class NDtimelineStreamer:
    """Collector (reference sock_streamer.py NDtimelineStreamer).

    ``NDtimelineStreamer.start(addr, handlers)`` spawns the accept loop in a
    daemon thread and returns the streamer; each incoming connection gets a
    reader thread that decodes span batches and fans them out to the
    handlers under a lock (handlers see one merged, ordered-per-sender
    stream)."""

    def __init__(self, addr: Addr, handlers: Sequence[Callable[[List[Span]], None]]):
        self.addr = addr
        self.handlers = list(handlers)
        self._sock = _make_server_socket(addr)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.received = 0       # spans seen (observability / tests)
        self.decode_errors = 0  # malformed frames -> dropped connections
        self.handler_errors = 0
        self.straggler = None   # set by start(straggler=...)

    @classmethod
    def start(
        cls,
        addr: Addr,
        handlers: Sequence[Callable[[List[Span]], None]] = (),
        straggler=None,
    ) -> "NDtimelineStreamer":
        """``straggler``: attach a cross-rank straggler detector
        (telemetry/straggler.py) as a handler over the merged span stream —
        pass ``True`` for defaults, a float for a threshold multiple, or a
        preconfigured ``StragglerDetector``.  Query it via
        ``streamer.straggler.report()`` / ``.summary()``."""
        st = cls(addr, handlers)
        if straggler is not None and straggler is not False:
            from ..telemetry.straggler import StragglerDetector

            if straggler is True:
                straggler = StragglerDetector()
            elif isinstance(straggler, (int, float)):
                straggler = StragglerDetector(threshold=float(straggler))
            st.straggler = straggler
            st.handlers.append(straggler)
        t = threading.Thread(target=st._accept_loop, daemon=True, name="ndtimeline-accept")
        t.start()
        st._threads.append(t)
        return st

    # ----------------------------------------------------------- internal
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # socket closed by stop()
            t = threading.Thread(target=self._reader, args=(conn,), daemon=True)
            t.start()
            # prune finished reader threads so reconnecting senders don't
            # grow the list without bound over a long run
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _reader(self, conn: socket.socket) -> None:
        with conn:
            while not self._stop.is_set():
                try:
                    header = _recv_exact(conn, 4)
                    if header is None:
                        return
                    (length,) = struct.unpack(">I", header)
                    payload = _recv_exact(conn, length)
                    if payload is None:
                        return
                    spans = [Span(**d) for d in json.loads(payload)]
                except (OSError, ValueError, TypeError):
                    # malformed frame / version-skewed sender: count it and
                    # drop the connection rather than dying silently
                    with self._lock:
                        self.decode_errors += 1
                    return
                with self._lock:
                    self.received += len(spans)
                    for h in self.handlers:
                        try:
                            h(spans)
                        except Exception:
                            self.handler_errors += 1

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        finally:
            if isinstance(self.addr, str):
                try:
                    os.unlink(self.addr)
                except FileNotFoundError:
                    pass


class SockHandler:
    """Per-rank flush handler: serialize the batch and stream it to the
    collector (the sender half of sock_streamer.py).  Register it on the
    rank's ``NDTimerManager``; connection is lazy and failures degrade to
    dropping the batch (``dropped`` counts them) — profiling must never take
    down training (reference's fire-and-forget udp-style contract)."""

    def __init__(self, addr: Addr, connect_timeout: float = 5.0, retry_interval: float = 30.0):
        self.addr = addr
        self.connect_timeout = connect_timeout
        self.retry_interval = retry_interval
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._next_attempt = 0.0  # monotonic deadline for the next redial
        self.dropped = 0

    def _ensure(self) -> Optional[socket.socket]:
        import time

        if self._sock is None:
            # backoff: while the collector is down, redial at most every
            # retry_interval instead of blocking every flush for the full
            # connect timeout
            now = time.monotonic()
            if now < self._next_attempt:
                return None
            try:
                self._sock = _connect(self.addr, timeout=self.connect_timeout)
            except OSError:
                self._sock = None
                self._next_attempt = now + self.retry_interval
        return self._sock

    def __call__(self, spans: List[Span]) -> None:
        try:
            payload = json.dumps(
                [
                    {
                        "metric": s.metric,
                        "start": s.start,
                        "duration": s.duration,
                        "step": s.step,
                        "rank": s.rank,
                        "tags": s.tags,
                    }
                    for s in spans
                ],
                default=str,  # numpy scalars etc. must not crash the flush
            ).encode()
        except (TypeError, ValueError):
            self.dropped += len(spans)
            return
        msg = struct.pack(">I", len(payload)) + payload
        with self._lock:
            sock = self._ensure()
            if sock is None:
                self.dropped += len(spans)
                return
            try:
                sock.sendall(msg)
            except OSError:
                self.dropped += len(spans)
                try:
                    sock.close()
                finally:
                    self._sock = None

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None
