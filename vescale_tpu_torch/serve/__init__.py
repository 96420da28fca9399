"""Serving on the card: paged KV cache, engine, scheduler and the resilient
loop, with the radix-tree prefix cache, speculative decoding, the
network-fed fleet replica and the ``/control`` weight rollout."""

from .engine import ServeEngine, stack_params_check
from .fleet import RequestInbox, request_from_payload, serve_replica
from .kv_cache import KVCacheConfig, KVCacheOutOfPages, PagedKVCache
from .loop import ControlChannel, ServeResult, run_serve, run_serve_resilient
from .obs import ROUTER_FIELDS, ROUTER_SCHEMA_VERSION, ServeObservability
from .prefix_cache import PrefixCache, PrefixCacheStats
from .scheduler import ContinuousBatchingScheduler, Request, ShedError
from .speculative import (
    SpeculativeDecoder,
    drafter_template,
    load_drafter_params,
    slice_drafter_params,
)

__all__ = [
    "ContinuousBatchingScheduler",
    "ControlChannel",
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
    "drafter_template",
    "load_drafter_params",
    "load_params",
    "request_from_payload",
    "run_serve",
    "run_serve_resilient",
    "serve_replica",
    "slice_drafter_params",
    "stack_params_check",
]


def load_params(path: str, template, device=None):
    """Restore ONLY the params tree of a training checkpoint (its ``model``
    entry) into the layout ``template`` describes (reference
    ``serve/__init__.py:99-112``): tensors, ``meta`` tensors (which land on
    ``device``, default the card) or ``DArray`` leaves.

    ``checkpoint.load`` reads exactly the chunks the template names, so the
    optimizer state never leaves storage, and the elastic preflight (VSC130)
    reshards a differently shaped writer mesh.
    ``checkpoint.LAST_LOAD_STATS["elastic"]`` says whether the restore
    crossed worlds."""
    from .. import checkpoint as ckpt

    return ckpt.load(path, {"model": template}, device=device)["model"]
