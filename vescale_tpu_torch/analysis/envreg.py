"""The registry of every ``VESCALE_*`` knob the port reads.

The port of ``vescale_tpu/analysis/envreg.py``: every knob is declared
once (name, type, default, one-line doc), reads go through the typed
accessors here (``config.py``'s accessors are a view over this table), and
``vescale-lint`` (``analysis/lint.py``) rejects a direct ``os.environ``
read of a ``VESCALE_*`` name elsewhere (VSC201) and a name this table does
not hold (VSC202).  ``python -m vescale_tpu_torch.analysis envdoc`` prints
the configuration table generated from it.

The port registers the reference's knobs with the reference's types and
defaults, all but the eighteen in ``REFERENCE_ONLY``.  Those drive
mechanisms the port does not have, so it reads none of them: the AOT
report scripts, the JAX bench harness, the Pallas dispatch modes (the
port's kernels dispatch by the tensor's device), the fp8-on-TPU gate,
``jax.distributed``'s bootstrap (the port joins through
``torch.distributed``) and the virtual-device dry run.

Semantics, the reference's:

  * Reads are live: accessors read ``os.environ`` at call time, so a test
    that monkeypatches a knob, or a run that flips one between phases,
    sees the new value on the next read.
  * ``bool`` parsing is uniform: unset -> default; "", "0", "false",
    "off", "no" (case-insensitive) -> False; anything else -> True.
  * ``default=None`` means "unset": typed accessors return None and the
    caller owns the fallback (documented in the knob's doc line).

This module imports only the standard library.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

__all__ = [
    "EnvVar",
    "register",
    "lookup",
    "is_registered",
    "all_vars",
    "get_raw",
    "get_bool",
    "get_int",
    "get_float",
    "get_str",
    "coerce_bool",
    "markdown_table",
    "configuration_markdown",
    "REFERENCE_ONLY",
]

_FALSE = ("", "0", "false", "off", "no")

# the JAX package's knobs that the port does not register (see above)
REFERENCE_ONLY = (
    "VESCALE_AOT_CHILD", "VESCALE_AOT_DEBUG", "VESCALE_AOT_FP8",  # vescale-lint: disable=VSC202 (reference-only)
    "VESCALE_AOT_MODEL", "VESCALE_AOT_ZB", "VESCALE_BENCH",  # vescale-lint: disable=VSC202 (reference-only)
    "VESCALE_BENCH_BUDGET_S", "VESCALE_BENCH_CHILD",  # vescale-lint: disable=VSC202 (reference-only)
    "VESCALE_BENCH_CPU_FALLBACK", "VESCALE_BENCH_NO_REGISTER",  # vescale-lint: disable=VSC202 (reference-only)
    "VESCALE_BENCH_RUNG", "VESCALE_BENCH_STEP_REPORT",  # vescale-lint: disable=VSC202 (reference-only)
    "VESCALE_COORDINATOR", "VESCALE_DRYRUN_VIRTUAL_CHILD",  # vescale-lint: disable=VSC202 (reference-only)
    "VESCALE_FP8_ON_TPU", "VESCALE_KERNELS", "VESCALE_NUM_PROCESSES",  # vescale-lint: disable=VSC202 (reference-only)
    "VESCALE_PROCESS_ID",  # vescale-lint: disable=VSC202 (reference-only)
)


def coerce_bool(raw: Optional[str], default: bool) -> bool:
    """The registry's bool parse applied to a raw string, for a knob whose
    unset default the caller computes."""
    if raw is None:
        return default
    return raw.strip().lower() not in _FALSE


@dataclasses.dataclass(frozen=True)
class EnvVar:
    """One registered knob: its declaration only.  The value lives in the
    process environment and is read again on every access."""

    name: str
    type: str  # "bool" | "int" | "float" | "str"
    default: Any
    doc: str

    def __post_init__(self):
        if not self.name.startswith("VESCALE_"):
            raise ValueError(f"env registry is for VESCALE_* vars, got {self.name!r}")
        if self.type not in ("bool", "int", "float", "str"):
            raise ValueError(f"{self.name}: unsupported type {self.type!r}")


_REGISTRY: Dict[str, EnvVar] = {}


def register(name: str, type: str, default: Any, doc: str) -> EnvVar:
    """Declare a knob.  Declaring it again identically is a no-op; a
    conflicting declaration raises."""
    var = EnvVar(name, type, default, doc)
    prev = _REGISTRY.get(name)
    if prev is not None and prev != var:
        raise ValueError(f"conflicting registration for {name}: {prev} vs {var}")
    _REGISTRY[name] = var
    return var


def lookup(name: str) -> EnvVar:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"{name} is not registered in vescale_tpu_torch.analysis.envreg — "
            "declare it there (name/type/default/doc) before reading it"
        ) from None


def is_registered(name: str) -> bool:
    return name in _REGISTRY


def all_vars() -> List[EnvVar]:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


# ------------------------------------------------------------- accessors
def get_raw(name: str) -> Optional[str]:
    """The raw string, or None when unset.  The name must be registered."""
    lookup(name)
    return os.environ.get(name)


def get_bool(name: str) -> bool:
    var = lookup(name)
    return coerce_bool(os.environ.get(name), bool(var.default))


def _get_number(name: str, cast, kind: str):
    """Unset or empty -> the declared default (None when it is None); a
    malformed value raises, naming the knob: falling back would quietly
    disable what the operator meant to configure."""
    var = lookup(name)
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return None if var.default is None else cast(var.default)
    try:
        return cast(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected {kind} (see `envdoc`)") from None


def get_int(name: str) -> Optional[int]:
    return _get_number(name, int, "an int")


def get_float(name: str) -> Optional[float]:
    return _get_number(name, float, "a float")


def get_str(name: str) -> Optional[str]:
    var = lookup(name)
    raw = os.environ.get(name)
    return var.default if raw is None else raw


# ------------------------------------------------------------ doc output
def markdown_table() -> str:
    """The configuration table, one row a knob, generated from the registry."""
    lines = ["| Variable | Type | Default | Effect |", "| --- | --- | --- | --- |"]
    for v in all_vars():
        default = "unset" if v.default is None else repr(v.default).strip("'\"") or '""'
        lines.append(f"| `{v.name}` | {v.type} | `{default}` | {v.doc} |")
    return "\n".join(lines)


def configuration_markdown() -> str:
    """The whole configuration document: a header and the generated table
    (``python -m vescale_tpu_torch.analysis envdoc [--write PATH]``)."""
    head = (
        "# Configuration of vescale_tpu_torch — `VESCALE_*` environment variables\n"
        "\n"
        "<!-- GENERATED — do not edit by hand.\n"
        "     Regenerate: python -m vescale_tpu_torch.analysis envdoc --write PATH\n"
        "     Source of truth: vescale_tpu_torch/analysis/envreg.py -->\n"
        "\n"
        "Every knob is declared in `vescale_tpu_torch.analysis.envreg` (name, type,\n"
        "default, effect) and read through its typed accessors; `vescale-lint`\n"
        "rejects direct `os.environ` reads of `VESCALE_*` names (VSC201) and\n"
        "unregistered names (VSC202), so this table is complete by\n"
        "construction.  Reads are live: flipping a variable between phases\n"
        "(or monkeypatching it in a test) takes effect on the next read.\n"
        "Booleans: unset uses the default; `\"\"`, `0`, `false`, `off`, `no`\n"
        "(case-insensitive) are false; anything else is true.\n"
        "\n"
    )
    return head + markdown_table() + "\n"


# =====================================================================
# Registrations, one block a subsystem.  Each doc line is one sentence: it
# becomes the Effect column of the table verbatim.
# =====================================================================

# --- analysis --------------------------------------------------------
register('VESCALE_SHARDCHECK', 'str', 'warn',
         'Static-analysis mode: `off` disables, `warn` emits warnings, `strict` raises on error-severity findings (docs/observability.md).')

# --- gradient compression / quantized collectives --------------------
register('VESCALE_GRAD_COMPRESS', 'str', '',
         'Gradient-compression codec for DDP/ZeRO grad reduction: empty = off, `int8` = block-scaled int8 quantized collectives (docs/observability.md).')
register('VESCALE_GRAD_COMPRESS_BLOCK', 'int', 64,
         'Block size (elements per fp32 scale) for the int8 gradient quantizer.')
register('VESCALE_GRAD_COMPRESS_SR', 'bool', False,
         'Use seeded stochastic rounding (unbiased in expectation) instead of round-to-nearest-even for quantized gradient collectives.')
register('VESCALE_GRAD_COMPRESS_SEED', 'int', 0,
         'Seed for the stochastic-rounding PRNG of quantized collectives; each eager call folds in a process-wide call counter and each rank its mesh position, so noise is fresh per step/leaf yet replayable from (seed, call order).')

# --- redistribution --------------------------------------------------
register('VESCALE_REDISTRIBUTE_QUANT', 'bool', False,
         'Let the multi-hop redistribution planner take a LOSSY quantize-move-dequantize int8 hop where the cost model says it wins; declines are recorded as VSC127 (docs/redistribute.md).')
register('VESCALE_REDISTRIBUTE_MEM_FACTOR', 'float', 4.0,
         'Per-shard memory budget for multi-hop plan intermediates, as a multiple of the larger endpoint shard.')
register('VESCALE_REDISTRIBUTE_MAX_HOPS', 'int', 3,
         "Hop bound for the multi-hop redistribution planner's lattice search.")
register('VESCALE_STRICT_REDISTRIBUTE', 'bool', False,
         'Raise instead of warn when redistribute() would take the logical-materializing pack/unpack fallback.')

# --- distributed bootstrap -------------------------------------------
register('VESCALE_BARRIER_TIMEOUT', 'float', None,
         'Deadline in seconds for barrier/all_processes_ok (BarrierTimeout past it); unset or <=0 disables.')
register('VESCALE_CONSISTENCY_EVERY', 'int', None,
         'Cross-rank state-fingerprint cadence in steps for run_resilient; unset = 32 (armed only when coordinating).')

# --- debug -----------------------------------------------------------
register('VESCALE_DEBUG_MODE', 'str', '',
         'DebugLogger gate: `1` logs on every rank, `rank0,1` restricts to listed ranks, empty/0 disables.')

# --- checkpoint / IO retry -------------------------------------------
register('VESCALE_NATIVE_CKPT_IO', 'bool', True,
         'Use the native (nogil) checkpoint write pool; `0` forces the Python thread pool (required for storage fault injection).')
register('VESCALE_CKPT_RETRIES', 'int', 3,
         'Max attempts for checkpoint storage read/write under the retry policy.')
register('VESCALE_LOADER_RETRIES', 'int', 3,
         'Max attempts for a data-loader batch fetch under the retry policy.')
register('VESCALE_IO_BACKOFF_BASE', 'float', 0.05,
         'First retry backoff sleep in seconds (exponential from here).')
register('VESCALE_IO_BACKOFF_MAX', 'float', 5.0,
         'Retry backoff ceiling in seconds.')
register('VESCALE_IO_BACKOFF_JITTER', 'float', 0.25,
         'Seeded jitter fraction applied to each backoff sleep.')
register('VESCALE_IO_ATTEMPT_TIMEOUT', 'float', 0.0,
         'Per-attempt timeout in seconds for retried IO (helper thread); 0 disables.')

# --- resilience ------------------------------------------------------
register('VESCALE_FAULTSIM', 'str', None,
         'Deterministic fault-injection schedule, e.g. `storage_write:call=3;preempt:step=10` (resilience/faultsim.py grammar).')
register('VESCALE_FAULTSIM_HANG_S', 'float', 3600.0,
         'Stall duration in seconds for the faultsim `hang` kind (watchdog test fodder).')
register('VESCALE_FAULTSIM_SLOW_DECODE_S', 'float', 0.05,
         'Stall duration in seconds for the faultsim `slow_decode` kind (serve-loop straggler injection).')
register('VESCALE_FAULTSIM_KILL_EXIT_CODE', 'int', 29,
         'Process exit code of the faultsim `replica_kill` kind (an abrupt os._exit mid-decode — the fleet failover test substrate).')
register('VESCALE_WATCHDOG_TIMEOUT', 'float', 0.0,
         'Hang-watchdog step-progress deadline in seconds; unset or <=0 disables the watchdog.')
register('VESCALE_WATCHDOG_ABORT', 'bool', True,
         'On a detected hang, os._exit after the stack dump so a supervisor can restart (disable to only dump).')
register('VESCALE_WATCHDOG_EXIT_CODE', 'int', 17,
         'Process exit code used by the watchdog abort path.')
register('VESCALE_WATCHDOG_DIR', 'str', None,
         'Directory for watchdog hang dumps when telemetry has no out_dir; unset disables dumping.')

# --- elastic world size ----------------------------------------------
register('VESCALE_ELASTIC_LOADER', 'bool', False,
         'Sample the token stream by GLOBAL row index so it is invariant to the (dp_world, per-rank batch) split — required on both runs for an elastic world-size resume (docs/resilience.md).')
register('VESCALE_ELASTIC_RESTORE', 'bool', True,
         'Allow restoring a checkpoint written by a different mesh/world size (reshard-on-load, VSC130); `0` refuses cross-world restores with a VSC132 finding.')

# --- serving ---------------------------------------------------------
register('VESCALE_SERVE_SLOTS', 'int', 8,
         "Decode-slot count of the serving KV cache (max concurrent in-flight requests; the decode step's shapes, and on the card its captured CUDA graph, follow it).")
register('VESCALE_SERVE_PAGE_SIZE', 'int', 16,
         'Tokens per KV-cache page (the paged-attention block size).')
register('VESCALE_SERVE_PAGES_PER_SLOT', 'int', 4,
         'Max pages one request may hold; page_size x pages_per_slot is the serving max sequence length.')
register('VESCALE_SERVE_MAX_QUEUE', 'int', 64,
         'Bounded admission queue depth; submissions beyond it are shed with a retry-after hint (docs/serving.md).')
register('VESCALE_SERVE_SLO_TTFT_S', 'float', 0.0,
         'p99 time-to-first-token SLO budget in seconds; while the rolling p99 exceeds it new submissions are shed (0 disables).')
register('VESCALE_SERVE_DEADLINE_S', 'float', 0.0,
         'Default per-request wall-clock deadline in seconds (timeout cancellation); 0 disables (requests may still carry explicit deadlines).')
register('VESCALE_SERVE_OPS_PORT', 'int', None,
         "Localhost port for the serve loop's live ops endpoints (`/metrics`, `/healthz`, `/router`): unset = endpoints off (no thread, no socket), 0 = auto-assign a free port (docs/serving.md).")
register('VESCALE_SERVE_REPLICA_ID', 'str', None,
         "Stable replica identity published in the `/router` v2 feed (`replica_id`) and used by the fleet router's affinity ring; unset = `rank<rank>` in the serve loop, `pid<pid>` in `serve_replica`.")
register('VESCALE_SERVE_IDLE_S', 'float', 0.002,
         'Step-boundary sleep of an inbox-fed serve loop with nothing queued or in flight (keeps an idle replica from spinning a core while staying responsive to new submissions).')
register('VESCALE_SERVE_PREFIX_CACHE', 'bool', False,
         'Radix-tree prefix caching over the paged KV pool: admission maps cached prompt-prefix pages (page-granular, refcounted) into the new slot and prefills only the suffix; eviction is deterministic LRU over unreferenced leaves (docs/serving.md).')
register('VESCALE_SERVE_PREFIX_CACHE_PAGES', 'int', 0,
         'Cap on pages the prefix-cache radix tree may retain (LRU leaves are evicted to fit); 0 = bounded only by the page pool itself.')
register('VESCALE_SPEC_K', 'int', 4,
         'Speculative decoding draft length: tokens the drafter proposes per decode iteration, verified by the target in ONE batched multi-token paged step.')
register('VESCALE_SPEC_DRAFTER_LAYERS', 'int', 1,
         'Decoder-block depth of the speculative drafter: the SAME checkpoint restored at reduced depth (first N blocks + shared embedding/norm/head, params-only through the elastic preflight).')

# --- fleet router (multi-replica serving) ----------------------------
register('VESCALE_FLEET_POLL_S', 'float', 0.05,
         "Fleet router poll cadence in seconds for each replica's `/router` feed (docs/serving.md fleet section).")
register('VESCALE_FLEET_POLL_TIMEOUT_S', 'float', 2.0,
         'Per-request HTTP timeout in seconds for fleet router polls and submits; a slower reply counts as a breaker failure.')
register('VESCALE_FLEET_BREAKER_FAILURES', 'int', 3,
         "Consecutive poll/submit failures that open a replica's circuit breaker (dispatch stops until a half-open probe succeeds).")
register('VESCALE_FLEET_BREAKER_COOLDOWN_S', 'float', 1.0,
         'Seconds an open breaker waits before its next poll becomes the half-open readmission probe; a failed probe re-opens with a fresh cooldown.')
register('VESCALE_FLEET_HEALTH_STALE_S', 'float', 10.0,
         'A reachable replica whose `/router` `serve_step` has not advanced for this long is treated as wedged (breaker failure); 0 disables staleness detection.')
register('VESCALE_FLEET_RETRIES', 'int', 3,
         'Bounded dispatch attempts per request placement (first dispatch, failover and spill-over alike) before the fleet sheds it.')
register('VESCALE_FLEET_BACKOFF_S', 'float', 0.05,
         'First retry backoff sleep in seconds for fleet dispatch (exponential from here).')
register('VESCALE_FLEET_BACKOFF_MAX_S', 'float', 2.0,
         'Fleet dispatch backoff ceiling in seconds.')
register('VESCALE_FLEET_HEDGE_S', 'float', 0.0,
         'Tail-latency hedge bound in seconds: a request unresolved this long after dispatch is sent to a SECOND replica (first terminal outcome wins — decode determinism keeps the answers identical); 0 disables hedging.')
register('VESCALE_FLEET_TRACE_DIR', 'str', None,
         'Directory where fleet-traced serve replicas persist their ndtimeline span streams (`<dir>/<replica_id>.spans.jsonl`, flushed per boundary) for the fleet timeline assembler; unset disables replica-side trace persistence (docs/observability.md fleet tracing).')
register('VESCALE_FLEET_TRACE_FLUSH_EVERY', 'int', 1,
         'Boundary cadence at which a fleet-traced replica flushes its span ring to the trace stream (1 = every boundary; higher trades crash-durability of the newest spans for fewer writes).')
register('VESCALE_FLEET_OPS_PORT', 'int', None,
         "Localhost port for the fleet ROUTER's own ops endpoints (`/fleet` aggregate rollup, `/healthz`, router-process `/metrics`): unset = off (no socket, no thread), 0 = auto-assign (docs/serving.md).")

# --- router high availability (serve/journal.py) ---------------------
register('VESCALE_FLEET_JOURNAL_DIR', 'str', None,
         "Directory for the fleet router's write-ahead journal (CRC-framed JSONL of every ledger transition + compacted snapshots): a FleetRouter constructed without an explicit journal opens one here, enabling crash recovery and warm-standby takeover; unset = journaling off, pre-HA behavior byte-identical (docs/serving.md router HA).")
register('VESCALE_FLEET_JOURNAL_FSYNC', 'str', 'flush',
         'Journal durability policy: `none` (OS page cache only), `flush` (fsync at flush boundaries — poll/snapshot/terminal-ack, the default), `always` (fsync every write; the paranoid setting the <1% overhead bar is measured against).')
register('VESCALE_FLEET_JOURNAL_ROTATE_BYTES', 'int', 1048576,
         'Journal segment size in bytes past which the next snapshot rotates to a fresh `wal-NNNNNN.log` segment (older segments beyond the last two are pruned — the snapshot makes them dead weight).')
register('VESCALE_FLEET_JOURNAL_SNAPSHOT_EVERY', 'int', 256,
         'Appended records between compacted journal snapshots (each folds ledger counts, pending rids, affinity ring, breaker states, autoscaler clocks and rollout stage into ONE record so recovery replays snapshot+tail, not history).')
register('VESCALE_FLEET_LEASE_PATH', 'str', None,
         "Path of the fenced leader-lease file ({epoch, holder, expires_at}, written atomically): a FleetRouter constructed without an explicit lease acquires one here, stamping its epoch into every dispatch tag so a deposed leader's stale placements can never double-resolve a rid; unset = no fencing (single-router deployments).")
register('VESCALE_FLEET_LEASE_TTL_S', 'float', 2.0,
         'Leader-lease time-to-live in seconds: the leader renews at TTL/3 on its poll cadence, and a warm standby whose poll finds the lease expired takes over by acquiring epoch+1 (docs/serving.md router HA).')
register('VESCALE_SERVE_TENANT_WEIGHTS', 'str', None,
         "Per-tenant SLO-class weights as `tenant:weight[,tenant:weight...]` (e.g. `gold:3,free:1`): each tenant's share of the admission queue is capped at max_queue x weight/total (unlisted tenants weigh 1.0), so an overloaded tenant sheds before it can starve the others; unset disables tenant-weighted shedding entirely (docs/serving.md).")

# --- autoscaler (serve/autoscale.py) ---------------------------------
register('VESCALE_AUTOSCALE_MIN', 'int', 1,
         'Lower replica-count bound of the fleet autoscaler: scale-down never drains below this many live replicas.')
register('VESCALE_AUTOSCALE_MAX', 'int', 4,
         'Upper replica-count bound of the fleet autoscaler: scale-up never spawns past this many live replicas.')
register('VESCALE_AUTOSCALE_UP_BURN', 'float', 1.0,
         'Scale-up threshold on the windowed `fleet_timeline_slo_burn_rate` average (>= 1 means the fleet is burning p99-TTFT error budget).')
register('VESCALE_AUTOSCALE_DOWN_BURN', 'float', 0.5,
         'Scale-down threshold on the windowed burn-rate average; the gap up to VESCALE_AUTOSCALE_UP_BURN is the hysteresis dead zone where the fleet stays put.')
register('VESCALE_AUTOSCALE_UP_QUEUE', 'int', 4,
         'Aggregate fleet queue depth (router-pending + replica queues) at or above which a rising queue trend also triggers scale-up, independent of the SLO burn signal.')
register('VESCALE_AUTOSCALE_UP_HOLD_S', 'float', 1.0,
         "Seconds the scale-up condition must hold continuously before a replica is spawned (transient spikes don't scale).")
register('VESCALE_AUTOSCALE_DOWN_HOLD_S', 'float', 5.0,
         'Seconds the scale-down condition must hold continuously before a replica is drained (asymmetric with up-hold: scaling down is the cautious direction).')
register('VESCALE_AUTOSCALE_COOLDOWN_S', 'float', 5.0,
         'Seconds after ANY scale action during which the autoscaler makes no further decisions — the just-changed fleet must re-converge before its signals mean anything.')
register('VESCALE_AUTOSCALE_WINDOW_S', 'float', 10.0,
         "Time-series window in seconds over which the autoscaler's burn-rate average and queue-depth slope are reduced.")
register('VESCALE_AUTOSCALE_TICK_S', 'float', 0.25,
         'Autoscaler control-loop cadence in seconds: tick() calls arriving inside this interval return the cached last decision without recomputing signals, bounding autoscaler overhead in tight serve loops.')

# --- trace timeline / cost calibration -------------------------------
register('VESCALE_COST_CALIBRATION', 'str', None,
         'Path to a measured collective-cost table (collective_calibration.json): planner/scheduler/cost functions answer from interpolated measured wall-times, falling back to the analytic model with a one-time warning per missing bucket; unset (or an empty/stale table) keeps the analytic bandwidth-factor model bit-identically (docs/observability.md).')
register('VESCALE_CLOCK_SYNC_ROUNDS', 'int', 8,
         'Rounds of allgather wall-clock exchange used by telemetry.trace.estimate_clock_offsets to estimate per-rank clock offsets (more rounds tighten the residual).')

# --- time-series store / alert engine --------------------------------
register('VESCALE_TIMESERIES', 'bool', True,
         'Arm the metric time-series store at telemetry.init(): registry counters/gauges/histogram-percentiles gain bounded ring history with tiered downsampling; off = the sample hook stays the dormant no-op reference (docs/observability.md).')
register('VESCALE_TIMESERIES_CADENCE_S', 'float', 1.0,
         'Minimum seconds between accepted time-series samples — the loops call `timeseries.sample()` every step/poll and the store keeps at most one per cadence.')
register('VESCALE_TIMESERIES_BASE_LEN', 'int', 512,
         'Ring capacity per downsampling tier, in samples (memory bound per metric = base_len x tiers).')
register('VESCALE_TIMESERIES_TIER_FACTOR', 'int', 8,
         'How many tier-k samples collapse into one tier-(k+1) sample (mean for value series, last for cumulative series).')
register('VESCALE_TIMESERIES_TIERS', 'int', 3,
         'Number of downsampling tiers; with the defaults tier 2 retains ~9 hours of history per metric.')
register('VESCALE_ALERTS', 'bool', True,
         'Arm the SLO alert engine at telemetry.init(): declarative rules evaluate over the time-series store with the pending->firing->resolved lifecycle; off = raise_alert degrades to the legacy one-shot warning (docs/observability.md).')
register('VESCALE_ALERTS_HISTORY', 'int', 256,
         'Bounded ring of retained alert lifecycle transitions (the `/alerts` history tail).')
register('VESCALE_ALERTS_EVAL_INTERVAL_S', 'float', 0.25,
         'Minimum seconds between alert-engine evaluations — the per-step evaluate() hook rate-limits itself to this.')
register('VESCALE_ALERTS_BURN_WINDOWS', 'str', None,
         'Override the SLO burn-rate rule windows as `long:short:factor[,long:short:factor...]` seconds (default 3600:300:14.4,21600:1800:6 — the SRE multi-window pairs).')
register('VESCALE_ALERTS_BURN_FOR_S', 'float', 0.0,
         'Hold seconds before a burn-rate rule transitions pending -> firing (0 = fire on first evaluation where both windows burn).')

# --- cost audit (plan-vs-reality) ------------------------------------
register('VESCALE_COSTAUDIT', 'bool', True,
         'Arm the plan-vs-reality cost auditor at telemetry.init(): priced plans (redistribution, quant edges, pipe schedules, serve steps) ledger their predictions, a per-step join publishes `cost_model_*` divergence gauges + the `cost-model-drift` rule, and the online harvest folds measured spans back into the calibration table; off = the hooks stay dormant no-op references (docs/observability.md).')
register('VESCALE_COSTAUDIT_DEPTH', 'int', 256,
         'Bounded prediction-ledger ring depth — oldest predictions fall off once this many are outstanding (late measurements against an evicted plan id are ignored).')
register('VESCALE_COSTAUDIT_THRESHOLD', 'float', 3.0,
         'Divergence ratio (decayed mean of max(measured/predicted, predicted/measured)) above which the `cost-model-drift` alert rule fires.')
register('VESCALE_COSTAUDIT_DECAY', 'float', 0.25,
         "EWMA weight of the online calibration harvest and the divergence aggregates: each measured span moves its table bucket this fraction of the way to the new wall time (the sweep's plain 1/n running mean is unchanged).")
register('VESCALE_COSTAUDIT_CADENCE_S', 'float', 30.0,
         'Minimum seconds between atomic persists of the harvested calibration table to the VESCALE_COST_CALIBRATION path (no path = no persistence; digest rotation still re-plans in-process).')
register('VESCALE_COSTAUDIT_HARVEST', 'bool', True,
         'Let the per-step auditor harvest tagged ndtimeline spans into the active calibration table (online recalibration); off = audit-only (divergence is reported but the table never moves).')
