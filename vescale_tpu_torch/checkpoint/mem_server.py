"""Detached in-memory checkpoint file server.

The port of ``vescale_tpu/checkpoint/mem_server.py`` (the reference's gRPC
memory file service, legacy ``utilities/server/mem_server_lib.py``:
Write/Read/Rename/Remove/Listdir/Exists over a unix socket, and
``detached_mem_server.py``, the standalone server process).  Checkpoints
live in the memory of a process that outlives the trainer: a crashed run
restarts and reloads from the server instead of the filesystem.

A threaded unix-domain socket server speaks a length-prefixed binary
protocol (no dependencies); the client is a ``checkpoint.Storage``, so
``checkpoint.save("memsvr://name/run1", ...)`` goes through it.  The
socket lives in the temporary directory (``tempfile.gettempdir()``).

Protocol (all integers little-endian):
  request : op:u8  name_len:u32  name  payload_len:u64  payload
  response: status:u8 (0 ok, 1 missing, 2 error)  data_len:u64  data
Ops: W=write, R=read, E=exists, L=list (name = prefix), D=remove,
M=rename (payload = new name), Q=shutdown, P=ping.
"""

from __future__ import annotations

import os
import socket
import socketserver
import struct
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

from .storage import Storage

__all__ = [
    "MemServer",
    "RemoteMemoryStorage",
    "start_server",
    "start_detached",
    "shutdown_server",
    "sock_path",
]

_OK, _MISSING, _ERROR = 0, 1, 2


def sock_path(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), f"vescale_tpu_torch_mem_{name}.sock")


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("mem server connection closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def _send_msg(sock: socket.socket, op: bytes, name: str, payload: bytes = b"") -> None:
    nb = name.encode()
    sock.sendall(op + struct.pack("<I", len(nb)) + nb + struct.pack("<Q", len(payload)))
    if payload:
        sock.sendall(payload)


def _recv_reply(sock: socket.socket) -> Tuple[int, bytes]:
    head = _recv_exact(sock, 9)
    status = head[0]
    (dlen,) = struct.unpack("<Q", head[1:9])
    return status, _recv_exact(sock, dlen) if dlen else b""


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        srv: "MemServer" = self.server.mem  # type: ignore[attr-defined]
        sock = self.request
        try:
            while True:
                head = _recv_exact(sock, 5)
                op = head[:1]
                (nlen,) = struct.unpack("<I", head[1:5])
                name = _recv_exact(sock, nlen).decode()
                (plen,) = struct.unpack("<Q", _recv_exact(sock, 8))
                payload = _recv_exact(sock, plen) if plen else b""
                status, data = srv.dispatch(op, name, payload)
                sock.sendall(bytes([status]) + struct.pack("<Q", len(data)) + data)
                if op == b"Q":
                    # reply delivered; now stop the serve loop
                    threading.Thread(target=self.server.shutdown, daemon=True).start()
                    return
        except ConnectionError:
            return


class _ThreadedUnixServer(socketserver.ThreadingMixIn, socketserver.UnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True


class MemServer:
    """The in-memory file store + its socket front end."""

    def __init__(self, name: str):
        self.name = name
        self._files: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self._server: Optional[_ThreadedUnixServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ file ops
    def dispatch(self, op: bytes, name: str, payload: bytes) -> Tuple[int, bytes]:
        with self._lock:
            if op == b"W":
                self._files[name] = payload
                return _OK, b""
            if op == b"R":
                data = self._files.get(name)
                return (_OK, data) if data is not None else (_MISSING, b"")
            if op == b"E":
                return _OK, (b"1" if name in self._files else b"0")
            if op == b"L":
                names = [k for k in self._files if k.startswith(name)]
                return _OK, "\n".join(names).encode()
            if op == b"D":
                if self._files.pop(name, None) is None:
                    return _MISSING, b""
                return _OK, b""
            if op == b"M":
                if name not in self._files:
                    return _MISSING, b""
                self._files[payload.decode()] = self._files.pop(name)
                return _OK, b""
            if op in (b"P", b"Q"):
                return _OK, b""
            return _ERROR, f"unknown op {op!r}".encode()

    # ---------------------------------------------------------- lifecycle
    def serve(self, background: bool = True) -> None:
        path = sock_path(self.name)
        if os.path.exists(path):
            os.remove(path)
        self._server = _ThreadedUnixServer(path, _Handler)
        self._server.mem = self  # type: ignore[attr-defined]
        if background:
            self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
            self._thread.start()
        else:
            try:
                self._server.serve_forever()
            finally:
                if os.path.exists(path):
                    os.remove(path)

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            path = sock_path(self.name)
            if os.path.exists(path):
                os.remove(path)


class _ServerConn:
    """A BOUNDED pool of persistent sockets per SERVER NAME, shared by
    every RemoteMemoryStorage prefix view.  Per-prefix sockets would leak
    one fd per checkpoint name (a step-per-save workload exhausts ulimit);
    a single lock-serialized socket would serialize every multi-MB payload
    across concurrent saves/loads.  K sockets give parallel transfers with
    O(1) fds."""

    POOL_SIZE = 4
    _registry: Dict[str, "_ServerConn"] = {}
    _rlock = threading.Lock()

    def __init__(self, name: str):
        self.name = name
        self._socks: List[Optional[socket.socket]] = [None] * self.POOL_SIZE
        self._locks = [threading.Lock() for _ in range(self.POOL_SIZE)]
        self._rr = 0

    @classmethod
    def get(cls, name: str) -> "_ServerConn":
        with cls._rlock:
            if name not in cls._registry:
                cls._registry[name] = cls(name)
            return cls._registry[name]

    def _conn(self, slot: int) -> socket.socket:
        if self._socks[slot] is None:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.connect(sock_path(self.name))
            self._socks[slot] = s
        return self._socks[slot]

    def call(self, op: bytes, name: str, payload: bytes = b"") -> Tuple[int, bytes]:
        # prefer an idle slot (parallel transfers); fall back to blocking
        # on the round-robin slot
        for i in range(self.POOL_SIZE):
            slot = (self._rr + i) % self.POOL_SIZE
            if self._locks[slot].acquire(blocking=False):
                break
        else:
            slot = self._rr % self.POOL_SIZE
            self._locks[slot].acquire()
        self._rr = (slot + 1) % self.POOL_SIZE
        try:
            try:
                sock = self._conn(slot)
                _send_msg(sock, op, name, payload)
                return _recv_reply(sock)
            except (ConnectionError, OSError):
                # one reconnect: the server may have restarted between calls
                if self._socks[slot] is not None:
                    self._socks[slot].close()
                    self._socks[slot] = None
                sock = self._conn(slot)
                _send_msg(sock, op, name, payload)
                return _recv_reply(sock)
        finally:
            self._locks[slot].release()

    def close(self) -> None:
        for slot in range(self.POOL_SIZE):
            with self._locks[slot]:
                if self._socks[slot] is not None:
                    self._socks[slot].close()
                    self._socks[slot] = None


class RemoteMemoryStorage(Storage):
    """checkpoint.Storage client talking to a (possibly detached) MemServer.

    ``prefix`` namespaces several checkpoints in one server (the
    reference's per-name directories); all prefixes of one server share
    one socket (see _ServerConn)."""

    def __init__(self, name: str, prefix: str = ""):
        self.name = name
        self.prefix = prefix.strip("/")
        self._connection = _ServerConn.get(name)

    def _full(self, key: str) -> str:
        return f"{self.prefix}/{key}" if self.prefix else key

    def _call(self, op: bytes, name: str, payload: bytes = b"") -> Tuple[int, bytes]:
        return self._connection.call(op, name, payload)

    # ------------------------------------------------------- Storage api
    def write_bytes(self, name: str, data: bytes) -> None:
        status, msg = self._call(b"W", self._full(name), data)
        if status != _OK:
            raise IOError(f"mem server write failed: {msg!r}")

    def read_bytes(self, name: str) -> bytes:
        status, data = self._call(b"R", self._full(name))
        if status == _MISSING:
            raise FileNotFoundError(f"memsvr://{self.name}/{self._full(name)}")
        if status != _OK:
            raise IOError(f"mem server read failed: {data!r}")
        return data

    def exists(self, name: str) -> bool:
        return self._call(b"E", self._full(name))[1] == b"1"

    def list(self) -> List[str]:
        _, data = self._call(b"L", self.prefix + "/" if self.prefix else "")
        if not data:
            return []
        skip = len(self.prefix) + 1 if self.prefix else 0
        return [n[skip:] for n in data.decode().split("\n")]

    def remove(self, name: str) -> None:
        self._call(b"D", self._full(name))

    def ping(self) -> bool:
        try:
            return self._call(b"P", "")[0] == _OK
        except (ConnectionError, OSError, FileNotFoundError):
            return False

    def close(self) -> None:
        self._connection.close()


# ------------------------------------------------------------ entry points
def start_server(name: str) -> MemServer:
    """In-process background server (tests / single-host fast checkpoints)."""
    srv = MemServer(name)
    srv.serve(background=True)
    return srv


def start_detached(name: str, timeout: float = 10.0) -> int:
    """Spawn the server as a DETACHED process that outlives the caller
    (reference detached_mem_server.py) and wait until it answers a ping.
    Returns the server pid (-1 when a live server was reused).

    Creation is serialized by a per-name flock: without it, two concurrent
    trainers could both see a dead server and both spawn, the second
    rebinding the first's socket — one checkpoint's chunks would then split
    across two server memories."""
    import fcntl

    with open(sock_path(name) + ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)  # blocks at most ~timeout (holder waits for ping)
        if os.path.exists(sock_path(name)) and RemoteMemoryStorage(name).ping():
            return -1  # already running (pid unknown — fine, it's detached)
        proc = subprocess.Popen(
            [sys.executable, "-m", "vescale_tpu_torch.checkpoint.mem_server", "--name", name],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
            start_new_session=True,  # survives the trainer's process group
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        )
        deadline = time.time() + timeout
        while time.time() < deadline:
            if os.path.exists(sock_path(name)) and RemoteMemoryStorage(name).ping():
                return proc.pid
            if proc.poll() is not None:
                raise RuntimeError(f"detached mem server exited rc={proc.returncode}")
            time.sleep(0.05)
        proc.kill()
        raise TimeoutError(f"mem server {name!r} did not come up in {timeout}s")


def shutdown_server(name: str) -> None:
    """Ask a (detached) server to exit; removes its socket and the lock
    file ``start_detached`` made."""
    try:
        RemoteMemoryStorage(name)._call(b"Q", "")
    except (ConnectionError, OSError, FileNotFoundError):
        pass
    for path in (sock_path(name), sock_path(name) + ".lock"):
        try:
            os.remove(path)
        except OSError:
            pass


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--name", required=True)
    args = ap.parse_args()
    MemServer(args.name).serve(background=False)
