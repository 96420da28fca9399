"""The gloo rig: ports, child environments and the transport retry for
worlds of CPU processes joined over ``torch.distributed``'s gloo backend.

The port of ``vescale_tpu/testing.py``.  The port's multi-process tests
(``tests/torch_spmd_child.py``'s ``World``, the example programs' torchrun
worlds, the fleet's replicas) start worlds of CPU ranks that meet at a
localhost port.  Picking that port with a bind-then-close probe has a
race: the probe closes its socket before any child binds it, so two worlds
started in the same second can be handed one port, or a port still in
TIME_WAIT, and a world then fails in its transport setup while passing
alone.  This module is the one place ports come from:

  * :func:`reserve_port` never returns a port it has handed out before in
    this process (a process-wide registry), so one rig cannot collide with
    another of the same test session.
  * :func:`run_gloo_world` collects a spawned world and, when a child died
    with a transport-setup signature (address in use, connection refused,
    the store's rendezvous timing out), runs the whole world again once on
    a fresh port (``transport_retries`` bounds it): a collision with
    another process on the machine cannot be seen from here, so it is
    absorbed.  ``on_retry`` lets a caller reset on-disk state between
    attempts.  A failure with any other signature surfaces unchanged: an
    assertion error is never retried into hiding.

This module imports only the standard library.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "reserve_port",
    "reserved_ports",
    "is_transport_error",
    "make_child_env",
    "run_gloo_world",
    "TRANSPORT_ERROR_SIGNATURES",
    "RENDEZVOUS_VARS",
]

_RESERVED: List[int] = []
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# torch's env:// rendezvous, as torchrun sets it for each rank
RENDEZVOUS_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")

# output fragments (compared lower-case) that mean the world never came up:
# the TCP store's or a gloo pair's socket setup, as opposed to a failure of
# the code under test.  Deliberately narrow: an assertion failure inside a
# rank must never match.
TRANSPORT_ERROR_SIGNATURES = (
    "address already in use",  # EADDRINUSE: the store's or a pair's listen
    "connection refused",  # ECONNREFUSED: nobody listening at the port yet
    "gloo connectfullmesh failed",  # gloo's pair setup
    "waiting for clients",  # the store server's rendezvous timed out
    "client socket has timed out",  # a store client never reached the server
    "client socket has failed to connect",
    "tcp client failed to connect",
)


def reserve_port() -> int:
    """A free localhost port this process has never handed out before (the
    OS assigns one; the registry refuses same-process reuse)."""
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


def reserved_ports() -> Tuple[int, ...]:
    """Every port handed out so far, in order."""
    return tuple(_RESERVED)


def is_transport_error(output: str) -> bool:
    low = output.lower()
    return any(sig in low for sig in TRANSPORT_ERROR_SIGNATURES)


def make_child_env(port: int, rank: int, world: int, *,
                   rendezvous: bool = True) -> Dict[str, str]:
    """The environment of one CPU rank of the rig, built in one place.

    The parent's rendezvous variables are dropped and, with
    ``rendezvous``, set anew for this rank (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, as torchrun
    sets them); without it the child joins at an address it is given.
    Every ``VESCALE_*`` knob of the parent is dropped (a stale
    ``VESCALE_FAULTSIM`` would inject faults into a leg that expects
    none; a case hands its child the knobs it needs).  ``PYTHONPATH`` is
    the repository alone (a site directory inherited from the parent could
    import packages the port must not load), and each rank runs one
    BLAS/OpenMP thread."""
    env = {k: v for k, v in os.environ.items()
           if k not in RENDEZVOUS_VARS and not k.startswith("VESCALE_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    if rendezvous:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    return env


def _kill_all(procs: Sequence[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def run_gloo_world(spawn: Callable[[int], Sequence[subprocess.Popen]], *,
                   timeout: float = 420, transport_retries: int = 1,
                   on_retry: Optional[Callable[[], None]] = None) -> List[Tuple[int, str]]:
    """Spawn a world with ``spawn(port)`` and collect ``(returncode,
    output)`` for each process, running it again on a fresh port at most
    ``transport_retries`` times when a process failed with a transport
    signature.

    ``spawn`` gets a freshly reserved port and returns the ``Popen``
    handles, stdout piped as text with stderr folded in (the signature scan
    reads the combined stream).  On a timeout every process is killed and
    ``TimeoutExpired`` propagates: a hang is a finding, not a flake."""
    attempt = 0
    while True:
        port = reserve_port()
        procs = list(spawn(port))
        outs: List[str] = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=timeout)
                outs.append(out or "")
        finally:
            _kill_all(procs)
        results = [(p.returncode, out) for p, out in zip(procs, outs)]
        if all(rc == 0 for rc, _ in results):
            return results
        transport = any(rc != 0 and is_transport_error(out) for rc, out in results)
        if not transport or attempt >= transport_retries:
            return results
        attempt += 1
        print(f"[gloo-rig] transport setup failed on port {port}; "
              f"retry {attempt}/{transport_retries} on a fresh port", file=sys.stderr)
        if on_retry is not None:
            on_retry()
