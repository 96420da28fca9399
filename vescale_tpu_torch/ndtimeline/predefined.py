"""Predefined metric names (reference legacy/vescale/ndtimeline/
predefined.py).

The names of ``vescale_tpu/ndtimeline/predefined.py``, so span streams of
the two packages read alike.  The p2p/collective span names (send/recv
forward/backward, unshard-all-gather, grad-reduce-scatter/all-reduce) are
absent, as in the JAX package: the profiler owns that timing."""

# pipe engine instruction spans (pipe/engine.py)
FORWARD_COMPUTE = "forward-compute"
BACKWARD_COMPUTE = "backward-compute"
WGRAD_COMPUTE = "weight-grad-compute"
# train loop (train.py) — host region around the whole step
TRAIN_STEP = "train-step"
# optimizer step (parallel/optimizer.py: every optimizer of the port is eager)
OPTIMIZER_STEP = "optimizer-step"
# native loader batch fetch (data/loader.py)
DATA_LOAD = "data-load"
# checkpoint layer (checkpoint/__init__.py, manager.py)
CHECKPOINT_SAVE = "checkpoint-save"
CHECKPOINT_LOAD = "checkpoint-load"
CHECKPOINT_COMMIT = "checkpoint-commit"
# serve request lifecycle (serve/reqtrace.py emits; docs/observability.md
# "Request-span taxonomy").  Every request's chain is
#   submit -> [queue-wait -> prefill -> decode-token*]* -> terminal
# with an evict span marking each replay fork; the terminal span's
# ``outcome`` tag matches the scheduler ledger status exactly
# (reqtrace.verify_request_chains asserts the lockstep).
SERVE_SUBMIT = "serve-submit"
SERVE_QUEUE_WAIT = "serve-queue-wait"
SERVE_PREFILL = "serve-prefill"
SERVE_DECODE_STEP = "serve-decode-step"
SERVE_DECODE_TOKEN = "serve-decode-token"
SERVE_EVICT = "serve-evict"
SERVE_TERMINAL = "serve-terminal"
# speculative decoding (serve/speculative.py): with a drafter
# armed each decode iteration forks into a serve-draft span (the drafter's
# k sequential proposal steps) and a serve-verify span (the target's ONE
# batched multi-token verify step, tagged with drafted/accepted counts and
# the running acceptance rate) — both host-lane per-step spans like
# serve-decode-step, no rid.
SERVE_DRAFT = "serve-draft"
SERVE_VERIFY = "serve-verify"
# fleet-router request journey (serve/fleettrace.py emits; docs/
# observability.md "Fleet tracing").  Every routed request's ROUTER-side
# chain is
#   fleet-submit -> fleet-dispatch-attempt[i]* (backoff forks between
#   attempts) -> fleet-terminal
# with the dispatch-attempt ``tag`` doubling as the trace context that
# rides the /submit wire: the replica's serve-submit span echoes it, so
# the fleet timeline assembler stitches router chains to replica chains
# by construction (fleettrace.assemble_fleet_timeline).
FLEET_SUBMIT = "fleet-submit"
FLEET_DISPATCH = "fleet-dispatch-attempt"
FLEET_BACKOFF = "fleet-backoff"
FLEET_BREAKER = "fleet-breaker"
FLEET_TERMINAL = "fleet-terminal"
# fleet self-operation (serve/autoscale.py + the serve loop's reload
# machine; fleettrace.scale_event / rollout_stage emit).  Every
# autoscaler decision (scale-up spawn, scale-down drain) and every
# rolling-rollout stage (drain / baseline / swap / canary / commit /
# rollback) lands as a span in the same streams the journeys live in, so
# the merged fleet timeline shows the fleet operating itself inline with
# the requests it affected.
FLEET_SCALE = "fleet-scale"
FLEET_ROLLOUT = "fleet-rollout-stage"
# router high availability (serve/journal.py + FleetRouter.recover_from_
# journal / StandbyRouter; fleettrace.recover_event / takeover_event
# emit).  One span per crash recovery (journal replay -> /outcomes
# harvest -> re-drive) and per warm-standby promotion, so the leaderless
# window and the reconstruction cost read inline on the fleet timeline.
FLEET_RECOVER = "fleet-recover"
FLEET_TAKEOVER = "fleet-takeover"
# alert-engine lifecycle (telemetry/alerts.py emits): a point span per
# transition plus, on resolve, one span covering the whole firing episode
# — so a Perfetto timeline shows the alert as a bar spanning exactly the
# degraded step/request spans beneath it (docs/observability.md
# "Reading an alert span").
ALERT = "alert"
