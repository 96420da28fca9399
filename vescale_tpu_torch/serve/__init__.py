"""Serving on the card: paged KV cache, engine, scheduler and loop, with the
radix-tree prefix cache and speculative decoding."""

from .engine import ServeEngine, stack_params_check
from .kv_cache import KVCacheConfig, KVCacheOutOfPages, PagedKVCache
from .loop import ServeResult, run_serve
from .prefix_cache import PrefixCache, PrefixCacheStats
from .scheduler import ContinuousBatchingScheduler, Request, ShedError
from .speculative import SpeculativeDecoder, slice_drafter_params

__all__ = [
    "ContinuousBatchingScheduler",
    "KVCacheConfig",
    "KVCacheOutOfPages",
    "PagedKVCache",
    "PrefixCache",
    "PrefixCacheStats",
    "Request",
    "ServeEngine",
    "ServeResult",
    "ShedError",
    "SpeculativeDecoder",
    "run_serve",
    "slice_drafter_params",
    "stack_params_check",
]
