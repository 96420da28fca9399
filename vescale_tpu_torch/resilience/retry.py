"""Retry and backoff policy for flaky I/O: the checkpoint's storage and the
token loader.

The port of ``vescale_tpu/resilience/retry.py``, framework-free as there.
A checkpoint write can hit object-store throttling, NFS hiccups and
transient ``OSError``s that one retry absorbs, and a batch fetch a
transient native-loader failure.  ``RetryPolicy`` bounds the attempts,
sleeps an exponential backoff with deterministic jitter, and can bound
each attempt's time.  ``FileSystemStorage.read_bytes`` and
``write_bytes`` (``checkpoint/storage.py``) route through
:func:`ckpt_policy`, ``TokenDataLoader.next`` through
:func:`loader_policy`, built from the knobs:

  ===========================  ======== =====================================
  env                          default  meaning
  ---------------------------  -------- -------------------------------------
  VESCALE_CKPT_RETRIES         3        max attempts for checkpoint I/O
  VESCALE_LOADER_RETRIES       3        max attempts for a batch fetch
  VESCALE_IO_BACKOFF_BASE      0.05     first backoff sleep (seconds)
  VESCALE_IO_BACKOFF_MAX       5.0      backoff ceiling (seconds)
  VESCALE_IO_BACKOFF_JITTER    0.25     +/- fraction of jitter on each sleep
  VESCALE_IO_ATTEMPT_TIMEOUT   0        per-attempt timeout (s); 0 disables
  ===========================  ======== =====================================

``VESCALE_CKPT_RETRIES=1`` restores fail-fast semantics.  The jitter is
seeded (attempt index and policy seed), so two runs of one faultsim
schedule sleep alike.  Every absorbed fault prints one line on stderr and
counts ``resilience_io_retries_total`` and ``resilience_<name>_retries_total``;
an exhausted retry counts ``resilience_io_giveups_total`` (the telemetry
API's no-ops while telemetry is off).
"""

from __future__ import annotations

import sys
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

from .. import config

__all__ = ["RetryPolicy", "ckpt_policy", "loader_policy", "reset_default_policies"]


@dataclass
class RetryPolicy:
    """Bounded-retry executor.  ``call(fn, *args)`` runs ``fn`` up to
    ``max_attempts`` times, sleeping ``base * 2**attempt`` (+/- seeded
    jitter, capped at ``max_backoff``) between attempts; only ``retry_on``
    exceptions are retried, everything else propagates at once.
    ``attempt_timeout`` > 0 bounds each attempt by running it on a helper
    thread (an attempt that never returns leaks that thread until it
    finishes: the price of giving up on a hung NFS write)."""

    max_attempts: int = 3
    base_backoff: float = 0.05
    max_backoff: float = 5.0
    jitter: float = 0.25
    attempt_timeout: float = 0.0
    seed: int = 0
    retry_on: Tuple[Type[BaseException], ...] = (OSError, TimeoutError)
    # deterministic failures a retry cannot fix pass through at once
    no_retry: Tuple[Type[BaseException], ...] = (
        FileNotFoundError,
        IsADirectoryError,
        NotADirectoryError,
        PermissionError,
    )
    name: str = "io"

    @classmethod
    def from_env(cls, attempts_var: str, name: str = "io") -> "RetryPolicy":
        """A policy from the knobs; ``attempts_var`` names the
        ``VESCALE_*_RETRIES`` knob."""
        return cls(
            max_attempts=max(1, config.get_int(attempts_var)),
            base_backoff=config.get_float("VESCALE_IO_BACKOFF_BASE"),
            max_backoff=config.get_float("VESCALE_IO_BACKOFF_MAX"),
            jitter=config.get_float("VESCALE_IO_BACKOFF_JITTER"),
            attempt_timeout=config.get_float("VESCALE_IO_ATTEMPT_TIMEOUT"),
            name=name,
        )

    def backoff_for(self, attempt: int) -> float:
        """The deterministic sleep before retry ``attempt`` (1-based)."""
        raw = min(self.max_backoff, self.base_backoff * (2.0 ** (attempt - 1)))
        if self.jitter <= 0:
            return raw
        h = zlib.crc32(f"{self.name}:{self.seed}:{attempt}".encode()) / 0xFFFFFFFF
        return raw * (1.0 + self.jitter * (2.0 * h - 1.0))

    def _run_once(self, fn: Callable, args, kwargs):
        if self.attempt_timeout <= 0:
            return fn(*args, **kwargs)
        # one daemon thread per timed attempt, never a shared pool: two hung
        # writes would hold a pool forever and every later attempt would
        # time out queued.  A hung thread is abandoned; its late result is
        # dropped.
        box: list = []

        def _runner():
            try:
                box.append(("ok", fn(*args, **kwargs)))
            except BaseException as e:  # noqa: BLE001 — handed to the caller
                box.append(("err", e))

        t = threading.Thread(target=_runner, name=f"retry-{self.name}-attempt", daemon=True)
        t.start()
        t.join(self.attempt_timeout)
        if not box:
            raise TimeoutError(f"{self.name}: attempt exceeded {self.attempt_timeout}s")
        kind, payload = box[0]
        if kind == "err":
            raise payload
        return payload

    def call(self, fn: Callable, *args, description: str = "", **kwargs):
        """Run ``fn`` under the policy.  ``description`` names the resource
        in the absorbed-fault line on stderr."""
        from .. import telemetry as _tel

        last: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            try:
                return self._run_once(fn, args, kwargs)
            except self.retry_on as e:
                if isinstance(e, self.no_retry):
                    raise  # a retry cannot make a missing file appear
                last = e
                if attempt >= self.max_attempts:
                    break
                _tel.count("resilience_io_retries_total")
                _tel.count(f"resilience_{self.name}_retries_total")
                delay = self.backoff_for(attempt)
                print(
                    f"[resilience] {self.name} {description or getattr(fn, '__name__', 'op')}: "
                    f"attempt {attempt}/{self.max_attempts} failed ({e!r}); retrying in "
                    f"{delay:.3f}s",
                    file=sys.stderr,
                )
                if delay > 0:
                    time.sleep(delay)
        # out of attempts: count it, then re-raise the original exception,
        # so callers' except clauses keep their types
        _tel.count("resilience_io_giveups_total")
        raise last


# built at the first I/O, so knobs a launcher sets before then apply;
# reset_default_policies() reads them again (tests)
_CKPT: Optional[RetryPolicy] = None
_LOADER: Optional[RetryPolicy] = None
_LOCK = threading.Lock()


def ckpt_policy() -> RetryPolicy:
    """The checkpoint storage's policy (``VESCALE_CKPT_RETRIES`` attempts)."""
    global _CKPT
    with _LOCK:
        if _CKPT is None:
            _CKPT = RetryPolicy.from_env("VESCALE_CKPT_RETRIES", name="ckpt_io")
        return _CKPT


def loader_policy() -> RetryPolicy:
    """``TokenDataLoader.next``'s policy (``VESCALE_LOADER_RETRIES``
    attempts); a native-loader failure is a ``RuntimeError``, so that is
    retried too."""
    global _LOADER
    with _LOCK:
        if _LOADER is None:
            _LOADER = RetryPolicy.from_env("VESCALE_LOADER_RETRIES", name="loader")
            _LOADER.retry_on = (OSError, RuntimeError, TimeoutError)
        return _LOADER


def reset_default_policies() -> None:
    """Drop the cached policies (tests change the knobs)."""
    global _CKPT, _LOADER
    with _LOCK:
        _CKPT = None
        _LOADER = None
