"""Serving on the card: paged KV cache, engine, scheduler and the resilient
loop, with the radix-tree prefix cache, speculative decoding, and the
network-fed fleet replica."""

from .engine import ServeEngine, stack_params_check
from .fleet import RequestInbox, request_from_payload, serve_replica
from .kv_cache import KVCacheConfig, KVCacheOutOfPages, PagedKVCache
from .loop import ServeResult, run_serve, run_serve_resilient
from .obs import ROUTER_FIELDS, ROUTER_SCHEMA_VERSION, ServeObservability
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
    "ROUTER_FIELDS",
    "ROUTER_SCHEMA_VERSION",
    "Request",
    "RequestInbox",
    "ServeEngine",
    "ServeObservability",
    "ServeResult",
    "ShedError",
    "SpeculativeDecoder",
    "request_from_payload",
    "run_serve",
    "run_serve_resilient",
    "serve_replica",
    "slice_drafter_params",
    "stack_params_check",
]
