"""Live memory attribution and the OOM flight recorder.

The port of ``vescale_tpu/telemetry/memtrack.py``:

  1. **Tags.**  The runtime tags the tensors it owns (the train adapter
     the module's parameters as ``params`` and the optimizer's state as
     ``optimizer_state``, ``checkpoint.load`` what it read as
     ``checkpoint_buffers``), so memory is bucketed by OWNER instead of
     being one anonymous pile.  Tags hold a ``weakref`` to the tensor:
     tagging never extends a lifetime.
  2. **Per-step sampling.**  ``telemetry.record_step`` drives ``on_step``:
     device gauges (host RSS without a card), per-tag byte gauges, a
     bounded history ring, and **leak detection** (``leak_steps``
     consecutive steps of strictly growing ``untagged`` bytes warn once
     per run of growth).
  3. **Flight recorder.**  ``flight_recorder(step_fn)`` and
     ``maybe_dump_oom`` write a forensic JSON bundle when an exception
     looks like device-memory exhaustion (the census, device stats,
     history, registry snapshot); ``dump_now()`` writes one on demand.

``untagged`` bytes: on a card, the caching allocator's allocated bytes
less the tagged tensors' (PyTorch has no ``jax.live_arrays()``, and a
walk of every Python object each step would cost more than the step);
without a card, the live tensors the garbage collector knows that carry
no tag.

Gating contract (as the rest of telemetry): while dormant the hooks
``tag_array`` and ``tag_tree`` ARE the no-op functions
(``_noop_tag_array`` / ``_noop_tag_tree``), and there is no tracker, no
registry dict and no lock.  Call them as ``memtrack.tag_array(...)``, never
``from memtrack import tag_array``, which would freeze the dormant binding.
The reference's ``ndtimeline_tail`` is None until the port has ndtimeline
(ROADMAP A14).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import os
import threading
import time
import warnings
import weakref
from typing import Any, Callable, Dict, List, Optional

import torch

from .memory_report import device_memory_stats, live_array_census

__all__ = [
    "TAGS",
    "MemoryTracker",
    "activate",
    "deactivate",
    "is_active",
    "get_tracker",
    "tagged",
    "tag_array",
    "tag_tree",
    "flight_recorder",
    "dump_now",
    "maybe_dump_oom",
]

# the tag taxonomy; anything else is user-defined
TAGS = (
    "params",
    "optimizer_state",
    "grads",
    "activation_stash",
    "checkpoint_buffers",
    "untagged",
)

_TRACKER: Optional["MemoryTracker"] = None
_TAG_STACK: List[str] = []  # the ambient tag of tagged()


# ------------------------------------------------------------ dormant hooks
def _noop_tag_array(x, tag: Optional[str] = None):
    return x


def _noop_tag_tree(tree, tag: Optional[str] = None):
    return tree


tag_array = _noop_tag_array
tag_tree = _noop_tag_tree


@contextlib.contextmanager
def tagged(tag: str):
    """Ambient-tag scope: ``tag_array`` calls without a tag inside the
    block register under ``tag``.  Harmless while dormant."""
    _TAG_STACK.append(tag)
    try:
        yield
    finally:
        _TAG_STACK.pop()


def is_active() -> bool:
    return _TRACKER is not None


def get_tracker() -> Optional["MemoryTracker"]:
    return _TRACKER


def _tensor_leaves(tree):
    """The tensors of a nested dict / list / tuple (namedtuples too)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_leaves(v)
    else:
        local = getattr(tree, "_local", None)  # a DArray: its piece
        if isinstance(local, torch.Tensor):
            yield local


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * int(t.element_size())


# ----------------------------------------------------------------- tracker
class MemoryTracker:
    """Everything a live memory-tracking run owns (made only by
    ``telemetry.init(memtrack=True)``; its absence IS the off state)."""

    def __init__(self, history: int = 16, leak_steps: int = 5, census_interval: int = 1,
                 top_k: int = 10):
        if census_interval < 1:
            raise ValueError(f"census_interval must be >= 1, got {census_interval}")
        self.history_len = history
        self.leak_steps = leak_steps
        self.census_interval = census_interval
        self.top_k = top_k
        # id(tensor) -> (weakref, tag); the weakref's callback evicts the
        # entry.  RLock: a collection triggered inside tag_array can run an
        # eviction callback on this thread while the lock is held
        self._entries: Dict[int, tuple] = {}
        self._lock = threading.RLock()
        self.history: List[Dict[str, Any]] = []
        self._last_untagged: Optional[int] = None
        self._growth_run = 0
        self._leak_warned = False
        self.dumps_written = 0

    # ------------------------------------------------------------ tagging
    def tag_array(self, x, tag: Optional[str] = None):
        """Register one tensor (a ``DArray``: its piece) under ``tag`` (or
        the ambient ``tagged()`` scope).  Anything else is skipped:
        tagging is advisory."""
        tag = tag or (_TAG_STACK[-1] if _TAG_STACK else None)
        if tag is None:
            return x
        t = getattr(x, "_local", x)
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            return x
        key = id(t)
        ref = weakref.ref(t, lambda _r, k=key, s=self: s._evict(k))
        with self._lock:
            self._entries[key] = (ref, tag)
        return x

    def _evict(self, key: int) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def tag_tree(self, tree, tag: Optional[str] = None):
        """Register every tensor leaf of a tree."""
        for leaf in _tensor_leaves(tree):
            self.tag_array(leaf, tag)
        return tree

    def tag_of(self, t) -> Optional[str]:
        entry = self._entries.get(id(t))
        if entry is None:
            return None
        ref, tag = entry
        return tag if ref() is t else None  # guard id() reuse

    @property
    def num_tagged(self) -> int:
        return len(self._entries)

    def _live_tagged(self) -> List[torch.Tensor]:
        """The live tagged tensors, one per storage (a view of a tagged
        tensor must not count its bytes twice)."""
        with self._lock:
            refs = [ref for ref, _ in self._entries.values()]
        out, seen = [], set()
        for ref in refs:
            t = ref()
            if t is None:
                continue
            key = (t.device, t.data_ptr(), t.numel(), t.dtype)
            if key not in seen:
                seen.add(key)
                out.append(t)
        return out

    # ----------------------------------------------------------- sampling
    def census(self) -> Dict[str, Any]:
        tagged_t = self._live_tagged()
        cuda_devs = sorted({t.device.index or 0 for t in tagged_t if t.device.type == "cuda"})
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            # on a card: the allocator's bytes no tag claims
            out = live_array_census(self.tag_of, tagged_t, top_k=self.top_k)
            devs = cuda_devs or [torch.cuda.current_device()]
            tagged_cuda = sum(_nbytes(t) for t in tagged_t if t.device.type == "cuda")
            untagged = max(0, sum(torch.cuda.memory_allocated(d) for d in devs) - tagged_cuda)
            out["tags"].setdefault("untagged", {"count": 0, "bytes": 0})["bytes"] += untagged
            return out
        # without a card: every live tensor the collector knows
        ids = {id(t) for t in tagged_t}
        seen = {(t.data_ptr(), t.numel(), t.dtype) for t in tagged_t}
        others = []
        for o in gc.get_objects():
            # type(), not isinstance: the latter reads __class__, which
            # some deprecated module objects answer with a warning
            if issubclass(type(o), torch.Tensor) and id(o) not in ids \
                    and o.device.type != "meta":
                key = (o.data_ptr(), o.numel(), o.dtype)
                if key not in seen:
                    seen.add(key)
                    others.append(o)
        return live_array_census(self.tag_of, tagged_t + others, top_k=self.top_k)

    def on_step(self, step: int, registry) -> Optional[Dict[str, Any]]:
        """One sample (driven by ``telemetry.record_step``): gauges into
        ``registry``, a history entry, leak detection.  Returns the compact
        memory record of the steps.jsonl line (None on the steps the
        census interval skips)."""
        if step % self.census_interval != 0:
            return None
        devices = device_memory_stats()
        census = self.census()
        tag_bytes = {t: b["bytes"] for t, b in census["tags"].items()}
        for i, d in enumerate(devices):
            if d["source"] == "host_rss":
                if d["bytes_in_use"] is not None:
                    registry.gauge("mem_host_rss_bytes").set(d["bytes_in_use"])
                if d["peak_bytes_in_use"] is not None:
                    registry.gauge("mem_host_peak_rss_bytes").set(d["peak_bytes_in_use"])
                continue
            dev = d.get("id", i)  # keyed by card index, never list position
            for key in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
                if d.get(key) is not None:
                    registry.gauge(f"mem_device{dev}_{key}").set(d[key])
        for tag, nbytes in tag_bytes.items():
            registry.gauge(f"mem_tag_{tag}_bytes").set(nbytes)
        registry.gauge("mem_live_arrays").set(census["live_arrays"])

        # leak detection: leak_steps consecutive steps of strictly growing
        # untagged bytes; warn once per run of growth
        untagged = int(tag_bytes.get("untagged", 0))
        if self._last_untagged is not None and untagged > self._last_untagged:
            self._growth_run += 1
        else:
            self._growth_run = 0
            self._leak_warned = False
        self._last_untagged = untagged
        registry.gauge("mem_untagged_growth_steps").set(self._growth_run)
        if self._growth_run >= self.leak_steps and not self._leak_warned:
            self._leak_warned = True
            registry.counter("mem_leak_warnings_total").inc()
            warnings.warn(
                f"[alert:mem-leak] memtrack: untagged live-array bytes grew monotonically for "
                f"{self._growth_run} consecutive steps (now {untagged} B) — possible leak.  "
                "telemetry.dump_now() writes a tagged census to identify the owner.",
                stacklevel=2,
            )
        sample = {
            "step": step,
            "ts": time.time(),
            "devices": devices,
            "tags": tag_bytes,
            "live_arrays": census["live_arrays"],
            "untagged_growth_steps": self._growth_run,
        }
        self.history.append(sample)
        if len(self.history) > self.history_len:
            del self.history[: len(self.history) - self.history_len]
        return {
            "tags": tag_bytes,
            "devices": [{k: d.get(k) for k in ("source", "bytes_in_use", "peak_bytes_in_use")}
                        for d in devices],
            "untagged_growth_steps": self._growth_run,
        }

    # ----------------------------------------------------- flight recorder
    def flight_record(self, reason: str, exception: Optional[str] = None) -> Dict[str, Any]:
        """The forensic bundle (the OOM dump and ``dump_now``'s payload),
        under the reference's keys."""
        from . import api as _api  # late: api imports this module

        st = _api.get_state()
        return {
            "reason": reason,
            "ts": time.time(),
            "step": st.step if st is not None else None,
            "rank": st.rank if st is not None else None,
            "exception": exception,
            "device_memory": device_memory_stats(),
            "census": self.census(),
            "history": list(self.history),
            "last_step_report": getattr(st, "last_step_report", None),
            "registry": st.registry.snapshot() if st is not None else None,
            "ndtimeline_tail": None,
        }


# --------------------------------------------------------------- gate flips
def activate(history: int = 16, leak_steps: int = 5, census_interval: int = 1,
             top_k: int = 10) -> MemoryTracker:
    """Make the tracker and bind the live hooks (``telemetry.init`` calls
    this)."""
    global _TRACKER, tag_array, tag_tree
    _TRACKER = MemoryTracker(history=history, leak_steps=leak_steps,
                             census_interval=census_interval, top_k=top_k)
    tag_array = _TRACKER.tag_array
    tag_tree = _TRACKER.tag_tree
    return _TRACKER


def deactivate() -> None:
    """Drop the tracker and restore the no-op hooks."""
    global _TRACKER, tag_array, tag_tree
    _TRACKER = None
    tag_array = _noop_tag_array
    tag_tree = _noop_tag_tree


# ------------------------------------------------------------------- dumps
def _is_oom(exc: BaseException) -> bool:
    """Does ``exc`` look like device-memory exhaustion?  A
    ``torch.cuda.OutOfMemoryError`` ("CUDA out of memory"), the reference's
    RESOURCE_EXHAUSTED strings, and faultsim's injected ``oom``."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    s = str(exc)
    return "RESOURCE_EXHAUSTED" in s or "resource exhausted" in s.lower() \
        or "out of memory" in s.lower()


def dump_now(path: Optional[str] = None, reason: str = "manual",
             exception: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """Write a flight-recorder bundle now.  The default path is
    ``<out_dir>/flight_record_<step>_<seq>.json`` when telemetry has an
    out_dir (in-memory runs get the dict back).  None while dormant."""
    tracker = _TRACKER
    if tracker is None:
        return None
    from . import api as _api

    bundle = tracker.flight_record(reason, exception=exception)
    st = _api.get_state()
    if path is None and st is not None and st.out_dir is not None:
        tracker.dumps_written += 1
        path = os.path.join(st.out_dir,
                            f"flight_record_{bundle['step']}_{tracker.dumps_written}.json")
    if path is not None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(bundle, f, indent=2, default=str)
        bundle["path"] = path
    if st is not None:
        st.registry.counter("mem_flight_records_total").inc()
    return bundle


def maybe_dump_oom(exc: BaseException) -> Optional[Dict[str, Any]]:
    """Write a flight record when tracking is live and ``exc`` looks like
    memory exhaustion.  Never raises: the dump must not mask the OOM the
    caller is about to handle or re-raise."""
    if _TRACKER is None or not _is_oom(exc):
        return None
    try:
        return dump_now(reason=f"oom:{type(exc).__name__}", exception=repr(exc))
    except Exception:
        return None


def flight_recorder(fn: Callable) -> Callable:
    """Wrap a step so that memory exhaustion writes a forensic dump before
    it propagates."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except BaseException as e:
            maybe_dump_oom(e)
            raise

    return wrapped
