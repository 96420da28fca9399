"""Serving on the card: paged KV cache, engine, scheduler and loop."""

from .engine import ServeEngine, stack_params_check
from .kv_cache import KVCacheConfig, KVCacheOutOfPages, PagedKVCache
from .loop import ServeResult, run_serve
from .scheduler import ContinuousBatchingScheduler, Request, ShedError

__all__ = [
    "ContinuousBatchingScheduler",
    "KVCacheConfig",
    "KVCacheOutOfPages",
    "PagedKVCache",
    "Request",
    "ServeEngine",
    "ServeResult",
    "ShedError",
    "run_serve",
    "stack_params_check",
]
