"""Hang watchdog: a heartbeat thread with a step-progress deadline.

A copy of ``vescale_tpu/resilience/watchdog.py``.  The serve loop calls
``beat(step, phase)`` at every step boundary, prefill and decode step; if
no beat lands within ``timeout_s`` the watchdog fires once per stall:

  1. dumps every thread's Python stack (``sys._current_frames``) into a
     rank-qualified ``watchdog_hang_rank<r>_step<s>_<n>.json``;
  2. counts ``resilience_hang_detected_total`` and records a
     ``resilience_hang`` event in its registry;
  3. optionally aborts the process (``os._exit(exit_code)``) so a
     supervisor's restart path takes over: nothing can unwind a wedged
     collective or kernel.

The dump keeps the JAX package's keys.  While memtrack is live
(``telemetry.init``) its ``flight_record`` names the memory flight
record written beside it (``telemetry.memtrack.dump_now``); otherwise it
is ``None``.  Counters go to the ``telemetry=`` registry when one is given
(the serve loop's own) and to the global telemetry otherwise.  While
memtrack is off the watchdog thread makes no CUDA call, so it never
touches a stream while the main thread captures or replays the decode
graph.

Knobs (``Watchdog.from_env``): ``VESCALE_WATCHDOG_TIMEOUT`` (seconds;
unset or 0 disarms), ``VESCALE_WATCHDOG_ABORT`` (default on),
``VESCALE_WATCHDOG_EXIT_CODE`` (default 17) and ``VESCALE_WATCHDOG_DIR``
(where dumps go when no ``dump_dir`` is given and telemetry has no
``out_dir``; unset writes none).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Watchdog", "dump_all_stacks", "DEFAULT_EXIT_CODE"]

DEFAULT_EXIT_CODE = 17


def dump_all_stacks() -> Dict[str, List[str]]:
    """Every live thread's Python stack, keyed by ``name (tid=...)``.
    Read only: safe from the watchdog thread while the main thread is
    wedged."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    return {
        f"{names.get(ident, 'unknown')} (tid={ident})": traceback.format_stack(frame)
        for ident, frame in frames.items()
    }


class Watchdog:
    """Heartbeat thread with a step-progress deadline.

        wd = Watchdog(timeout_s=300, abort=True).start()
        for step in ...:
            wd.beat(step)
            ...
        wd.stop()

    ``beat`` re-arms the deadline; a beat-free window longer than
    ``timeout_s`` triggers the dump (once per stall: a later beat re-arms
    detection).  ``on_hang(bundle)`` runs before any abort.  Counters go to
    ``telemetry`` (a :class:`~vescale_tpu_torch.telemetry.Registry`) when
    one is given."""

    def __init__(
        self,
        timeout_s: float,
        poll_s: Optional[float] = None,
        abort: bool = True,
        exit_code: int = DEFAULT_EXIT_CODE,
        dump_dir: Optional[str] = None,
        on_hang: Optional[Callable[[Dict[str, Any]], None]] = None,
        telemetry=None,
    ):
        if timeout_s <= 0:
            raise ValueError("watchdog timeout_s must be positive")
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s) if poll_s else min(1.0, self.timeout_s / 4.0)
        self.abort = bool(abort)
        self.exit_code = int(exit_code)
        self.dump_dir = dump_dir
        self.on_hang = on_hang
        self.telemetry = telemetry
        self.fired = 0  # stalls detected
        self.last_bundle: Optional[Dict[str, Any]] = None
        self._last_beat = time.monotonic()
        self._step: Optional[int] = None
        self._phase = "startup"
        self._tripped = False  # one dump per stall
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "Watchdog":
        if self._thread is not None:
            return self
        self.beat(self._step, phase="startup")
        self._thread = threading.Thread(target=self._run, name="vescale-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2 * self.poll_s)

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ heartbeat
    def beat(self, step: Optional[int] = None, phase: str = "step") -> None:
        """Record progress: the deadline restarts now.  No locks: the
        watchdog thread reads a slightly stale view at worst, which only
        delays a firing by one poll."""
        if step is not None:
            self._step = int(step)
        self._phase = phase
        # the beat's time BEFORE clearing the trip latch: the reverse order
        # lets the watchdog see a cleared latch beside a stale timestamp
        self._last_beat = time.monotonic()
        self._tripped = False

    @property
    def stalled_s(self) -> float:
        return time.monotonic() - self._last_beat

    # ------------------------------------------------------------- firing
    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            if self._tripped:
                continue  # this stall is dumped; wait for a beat
            if self.stalled_s > self.timeout_s:
                self._tripped = True
                self._trigger()

    def _trigger(self) -> None:
        self.fired += 1
        bundle: Dict[str, Any] = {
            "reason": "hang",
            "step": self._step,
            "phase": self._phase,
            "stalled_s": round(self.stalled_s, 3),
            "timeout_s": self.timeout_s,
            "pid": os.getpid(),
            "ts": time.time(),
            "threads": dump_all_stacks(),
            "flight_record": None,
        }
        from .. import telemetry as _gtel
        from ..telemetry import memtrack as _memtrack

        try:  # the memory flight record rides along while memtrack is live
            mem = _memtrack.dump_now(reason=f"watchdog_hang@step{self._step}")
            if mem is not None:
                bundle["flight_record"] = mem.get("path", "<in-memory>")
        except Exception:
            pass  # diagnostics must never mask the hang handling itself
        path = self._dump_path()
        if path is not None:
            try:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                with open(path, "w") as f:
                    json.dump(bundle, f, indent=2, default=str)
                bundle["path"] = path
            except OSError:
                path = None
        tel = self.telemetry if self.telemetry is not None else _gtel
        tel.count("resilience_hang_detected_total")
        tel.record_event("resilience_hang", at_step=self._step, phase=self._phase,
                         stalled_s=bundle["stalled_s"], dump=path, abort=self.abort)
        print(
            f"[watchdog] no step progress for {bundle['stalled_s']:.1f}s "
            f"(deadline {self.timeout_s:g}s) at step={self._step} "
            f"phase={self._phase}; stacks -> {path or '<not written>'}"
            + ("; aborting" if self.abort else ""),
            file=sys.stderr,
        )
        for label, stack in bundle["threads"].items():
            print(f"[watchdog] --- {label} ---\n{''.join(stack)}", file=sys.stderr)
        self.last_bundle = bundle
        if self.on_hang is not None:
            try:
                self.on_hang(bundle)
            except Exception:
                pass
        if self.abort:
            tel.count("resilience_hang_aborts_total")
            sys.stderr.flush()
            sys.stdout.flush()
            # os._exit: the main thread is wedged where no exception reaches
            os._exit(self.exit_code)

    def _dump_path(self) -> Optional[str]:
        root = self.dump_dir
        if root is None:
            from .. import config as _config
            from ..telemetry import api as _api

            st = _api.get_state()
            root = st.out_dir if st is not None else None
            if root is None:
                root = _config.get_str("VESCALE_WATCHDOG_DIR")
        if root is None:
            return None
        from .faultsim import _process_rank

        # rank-qualified: every rank of a run dumps into one directory
        return os.path.join(
            root, f"watchdog_hang_rank{_process_rank()}_step{self._step}_{self.fired}.json"
        )

    # --------------------------------------------------------- env arming
    @classmethod
    def from_env(cls, dump_dir: Optional[str] = None, timeout_s: Optional[float] = None,
                 telemetry=None) -> Optional["Watchdog"]:
        """A Watchdog per the ``VESCALE_WATCHDOG_*`` knobs; None when the
        deadline is unset or <= 0.  ``timeout_s`` overrides the knob's
        deadline (an explicit 0 disables it) while abort and exit code
        still come from the knobs."""
        from .. import config as _config

        if timeout_s is None:
            timeout_s = _config.get_float("VESCALE_WATCHDOG_TIMEOUT")
        if timeout_s is None or timeout_s <= 0:
            return None
        return cls(
            timeout_s=float(timeout_s),
            abort=_config.get_bool("VESCALE_WATCHDOG_ABORT"),
            exit_code=_config.get_int("VESCALE_WATCHDOG_EXIT_CODE"),
            dump_dir=dump_dir,
            telemetry=telemetry,
        )
