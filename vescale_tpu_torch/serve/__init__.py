"""Serving on the card: paged KV cache, engine, scheduler and the resilient
loop, with the radix-tree prefix cache, speculative decoding, the
``/control`` weight rollout, and the fleet tier: the network-fed replica
and its supervisor, the fleet router with failover, its journal and
standby takeover, the autoscaler and rolling rollout, and fleet tracing."""

from . import autoscale, fleet, fleettrace, journal, obs, prefix_cache, reqtrace, router, speculative
from .autoscale import Autoscaler, RolloutController
from .engine import ServeEngine, stack_params_check
from .fleet import FleetSupervisor, ReplicaSpec, RequestInbox, serve_replica
from .fleettrace import (
    FleetClockSync,
    assemble_fleet_timeline,
    estimate_fleet_clock_offsets,
    superseded_rids,
    verify_fleet_journeys,
)
from .journal import FencedEpochError, FleetJournal, LeaderLease
from .kv_cache import KVCacheConfig, KVCacheOutOfPages, PagedKVCache
from .loop import ControlChannel, ServeResult, run_serve, run_serve_resilient
from .obs import (
    FLEET_FIELDS,
    ROUTER_FIELDS,
    ROUTER_SCHEMA_VERSION,
    FleetObservability,
    ServeObservability,
)
from .prefix_cache import PrefixCache, PrefixCacheStats
from .router import (
    CircuitBreaker,
    ConsistentHashRing,
    FleetLedger,
    FleetRouter,
    HttpReplicaClient,
    StandbyRouter,
    request_from_payload,
    request_payload,
)
from .scheduler import ContinuousBatchingScheduler, Request, ShedError
from .speculative import (
    SpeculativeDecoder,
    drafter_template,
    load_drafter_params,
    slice_drafter_params,
    suggested_k,
)

__all__ = [
    "Autoscaler",
    "CircuitBreaker",
    "ConsistentHashRing",
    "FLEET_FIELDS",
    "FencedEpochError",
    "FleetClockSync",
    "FleetJournal",
    "FleetLedger",
    "FleetObservability",
    "FleetRouter",
    "FleetSupervisor",
    "HttpReplicaClient",
    "LeaderLease",
    "ReplicaSpec",
    "RolloutController",
    "StandbyRouter",
    "assemble_fleet_timeline",
    "autoscale",
    "estimate_fleet_clock_offsets",
    "fleet",
    "fleettrace",
    "journal",
    "obs",
    "prefix_cache",
    "request_payload",
    "router",
    "speculative",
    "superseded_rids",
    "verify_fleet_journeys",
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
    "reqtrace",
    "request_from_payload",
    "run_serve",
    "run_serve_resilient",
    "serve_replica",
    "slice_drafter_params",
    "stack_params_check",
    "suggested_k",
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
