#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vescale_tpu_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # device, build and kernel parity only
    python3 chip_smoke.py --tp       # serve, then the TP phases
    python3 chip_smoke.py --dp       # the DP phase alone
    python3 chip_smoke.py --resil    # the train_resilient phase alone
    python3 chip_smoke.py --telemetry   # serve and gpt2, then the telemetry phase
    python3 chip_smoke.py --pp       # gpt2, then the pipeline phase
    python3 chip_smoke.py --moe      # the moe shapes' parity, then the moe phase
    python3 chip_smoke.py --longctx  # the longctx phase alone
    python3 chip_smoke.py --fp8      # the fp8 phase alone
    python3 chip_smoke.py --plan     # the planning and analysis legs alone
    python3 chip_smoke.py --fleet    # the fleet phase alone
    python3 chip_smoke.py --leftovers   # the train_leftovers phase alone
    python3 chip_smoke.py --nd       # the nd phase (n-D composition) alone
    python3 chip_smoke.py --examples # the head-dim parity and the examples phase alone
    python3 chip_smoke.py --gloo-probe   # which collectives gloo carries on CUDA

Phases, each printing one JSON line with its seconds:

  device   the card (``nvidia-smi`` name and power limit), torch and CUDA
  build    compile every CUDA kernel from ``vescale_tpu_torch/kernels/csrc``;
           ptxas's registers and spills; HGMMA in every tensor-core flash
           kernel and in no fp32 one (``cuobjdump -sass``); no spill in any
           paged decode kernel, and their shared memory and ring stages
  parity   each kernel against its plain PyTorch version on the card, at the
           shapes the Llama-3-8B serve path (flash forward, paged decode),
           the 1.3B train path (flash forward and backward, fused AdamW)
           and the GPT-2 train path (flash forward and backward at head_dim
           64 without GQA, fused cross entropy) give it and at ragged ones,
           with the bound stated beside each case (the bf16 flash forward
           and backward against float64 and against their bf16-P (and dS)
           models, and two launches bitwise; the paged decode at 8 slots
           of the 8B, at its 8k context and at 64 slots, at the lengths
           where its partition changes shape, with a NaN in a late chunk,
           two launches and each slot alone bitwise); the autograd op's
           grads against autograd through the dense reference; times of
           each kernel, its plain version and, where one exists, one
           PyTorch library call (the flash forward at the 8B prefill, 1.3B
           and GPT-2 shapes, the backward at the 1.3B and GPT-2 shapes, the
           paged decode at its three shapes, L2-warm and over 8 pools)
  engine   a 2-layer fp32 engine on the card (kernels) and on the CPU (plain
           versions) from the same weights: first prefill logits within a
           stated bound, greedy streams of 16 tokens equal
  engine_spec  the same 2-layer fp32 engine on the card and on the CPU over
           8 requests that share a 48-token prefix: greedy streams of plain
           decode, the prefix cache, and the prefix cache with speculative
           decoding (1-layer drafter, k = 1 and 4) all exactly equal, on
           both devices
  serve    Llama-3-8B at full width (32 layers, random bf16 weights from a
           seed): 16 requests through ``run_serve`` twice, once with the
           decode step replayed as a CUDA graph (the engine) and once run
           op by op (a smoke-local subclass whose decode is the eager
           step); in each, every request completes, the ledger balances,
           every prefill layer launched the flash kernel and every decode
           layer the paged kernel, and a replay of one request reproduces
           its tokens; the two runs' streams are equal; on a mixed batch
           the graphed step's logits and pools are bitwise the eager
           step's, before and after ``swap_params`` to other weights and
           back
  spec_prefix  the 8B engine over 16 requests that share a 256-token system
           prompt: plain decode (the golden run), the prefix cache, and the
           prefix cache with speculative decoding (k = 4) under a 2-layer
           and a 32-layer drafter; every request completes, each request
           admitted after the first insert hits at 256 tokens, the flash
           and paged launches match the prefills and decode steps that ran,
           every emitted token is the verify step's argmax; the suffix
           prefill against a full prefill and the multi-token step against
           plain decode, teacher-forced, within a stated bound in bf16
           steps; tokens/s, TTFT, prefill tokens saved, acceptance and how
           many streams equal the golden run's
  serve_resilient  the 8B engine and the serve phase's 16 requests through
           ``run_serve_resilient``: nothing armed (the golden run: the
           serve phase's streams and counts); the fault battery
           (``request_timeout``, ``slow_decode`` twice, ``oom``, ``preempt``
           through the preemption handler): each fault fired as scheduled,
           the ledger balances, one terminal outcome a request, the status
           ``preempted``, every completed stream (the OOM victim's replay
           included) bitwise the golden one; a ``hang`` past a 2 s watchdog
           (abort off): one dump with the main thread's stack, one
           ``resilience_hang_detected_total``, golden streams; the envelope's
           cost: ``run_serve`` against ``run_serve_resilient`` with the
           watchdog on and faultsim armed but quiet, decode p50/p99,
           tokens/s and each run's wall split into prefills, decode steps
           and the rest, in the order plain, envelope, envelope, plain,
           then the watchdog alone and faultsim alone; and a
           replica: a child process serving a 2-layer engine at the 8B widths
           (serve seed) through ``serve_replica`` on a free port, fed 8
           requests over HTTP; ``/router`` carries the frozen v5 fields,
           ``/outcomes`` the in-process ``run_serve`` tokens at that depth,
           and SIGTERM drains it to ``preempted`` with exit code 0
  spmd     the SPMD core on the card.  A one-rank NCCL mesh
           (``distributed.initialize`` at a localhost address, then
           ``init_device_mesh("cuda", (1,))``): every
           placement kind (Shard on either dim, InterleavedShard, Replicate,
           Partial sum/avg/max, RaggedShard, StridedRaggedShard) through
           ``distribute_tensor`` -> ``to_local`` -> ``full_tensor``, eleven
           ``redistribute`` hops and the three ``api`` calls on the 8B's
           embedding (128256 x 4096) and one layer's down_proj (14336 x
           4096), bf16, every result bitwise its input, the NCCL calls
           counted; 8-rank layouts (a 1-D mesh of 8, a 2-D 2x4: Shard even
           and uneven, nested, InterleavedShard, RaggedShard with uneven
           units, StridedRaggedShard) computed in one process with the
           ``rank=`` path, reassembled bitwise; a ragged -> ragged
           transition rank by rank through ``redistribute_local_tensor``,
           bitwise, its peak allocation within the destination piece plus
           2 MiB; the RNG's uniform and dropout (p = 0.1) at GPT-2's
           activation shape and the MLP shape, whole and shard by shard,
           bitwise, with the draw's device ms; the 8B's parameters
           materialized as rank 3's Shard(0) pieces of a mesh of 8: bitwise
           the serve phase's weights sliced, the peak allocation within the
           pieces plus the largest full leaf and its piece plus 2 MiB; then
           the 8B's parameters from ``deferred_init`` on ``meta`` and
           ``materialize_module`` (Replicate) on the mesh, bitwise the serve
           phase's weights, a
           ``ServeEngine(..., mesh=)`` over them serving the serve phase's
           16 requests: every check of the serve phase, streams bitwise
           the serve phase's; the group destroyed, the engine freed
  checkpoint  the 8B serve weights (as Replicate pieces of a one-rank
           mesh) and a small optimizer subtree saved to a temporary
           directory outside the checkout through the native writer (every
           chunk file counted by it; bytes, seconds, GB/s); restored through
           ``serve.load_params`` into a template on ``meta``: bitwise, only
           the model's chunk files read, GB/s with the copy to the card;
           the restored weights serve the 16 requests (every check of the
           serve phase, streams bitwise the serve phase's); the ``/control``
           rollout over the same requests (a ``reload`` with baseline and
           canary at step 2, a ``commit`` after it): the states walk
           draining, baseline, swapping, canary, committed, streams bitwise
           golden, each kernel launch accounted for (the serve steps plus
           the baseline and canary replays), drain, swap and canary seconds;
           the same with ``canary_diverge`` armed: rolled back, golden
           streams; the embedding and layer 0 restored as rank 3's Shard(0)
           pieces of a layout-only mesh of 8: bitwise the serve weights'
           rows, elastic, VSC130, bytes read; the directory removed
  profile  device time by kernel kind and the device's idle share over a
           second run of the serve requests (``torch.profiler``), for the
           graphed engine only (the eager engine's profile is cut for time)
  fleet    the fleet tier over replica children (``--replica-child``: the
           replica leg's engine, the 8B widths at 2 layers, each streaming
           its spans to a trace directory), spawned and respawned by the
           port's ``FleetSupervisor`` and routed by its ``FleetRouter``
           over ``HttpReplicaClient``: (a) three replicas serve the serve
           requests (the ledger balances, no failover, streams bitwise an
           in-process ``run_serve`` of the same engine), then a fresh fleet
           whose r1 carries ``replica_kill:call=2``: a failover, zero
           requests lost or duplicated, streams bitwise, r1's exit code the
           kill's, its breaker closed -> open -> half-open -> closed, fresh
           requests served by the rejoined r1; (b) a leader child
           (``--router-child``, no CUDA) takes the ``LeaderLease``,
           journals a wave (rids + 100) over those replicas and dies by
           ``router_kill`` at its first pump; a ``StandbyRouter`` here
           takes over at epoch 2, streams bitwise, ``/fleet`` says leader;
           (c) one replica armed ``canary_diverge``, a spike of five times
           its slots plus queue: the ``Autoscaler`` clones it
           (``spawn_like``, readmitted by the half-open probe), shed rids
           resubmitted to completion bitwise, a ``RolloutController``
           rollout of a checkpoint of the same weights rolled back fleet
           wide, then committed on both, later traffic bitwise, the clone
           drained away when quiet; (d) the router's and the replicas'
           span streams merged (``assemble_fleet_timeline``), every leg's
           journeys verified, the scale, rollout, recover and takeover
           spans present; (e) the router's own costs (dispatch against a
           direct submit, journaled against plain, traced against not) as
           fractions of the replicas' decode p50; walls, start-up, the
           kill's breaker and rejoin times, TTFT and tokens/s, takeover and
           replay seconds, scale-up and -down latency, rollout stages; the
           replicas' K1 and K7 launches (clean exits) against their
           prefills and decode steps
  train_small  a 2-layer fp32 Llama trained 3 steps on the card and on the
           CPU from the same weights: losses within a stated bound
  train    the 1.3B Llama of the bench (``vescale_tpu_torch.bench``) at full
           width, B=1, T=4096: 2 warm-up and 5 timed steps; finite, falling
           loss, 24 flash forward, 24 dq, 24 dkv and 1 AdamW launch per
           step; step time, tokens/s, MFU, peak memory, and one profiled
           step's device time by kernel kind
  gpt_small  a 2-layer fp32 GPT trained 3 steps on the card and on the CPU
           from the same weights, through ``vocab_parallel_cross_entropy``:
           losses within a stated bound
  gpt2     GPT-2 124M (bench rung gpt2) at its published width, B=12,
           T=1024, fed by ``TokenDataLoader`` from a numpy-seeded token file
           in a temporary directory: 2 warm-up and 5 timed steps; finite,
           falling loss, 12 flash forward, 12 dq, 12 dkv, 1 fused xent
           forward, 1 fused xent backward and 1 AdamW launch per step; step
           time, tokens/s, MFU, peak memory, and one profiled step's device
           time by kernel kind

  train_resilient  ``resilience.run_resilient`` over ``train.FunctionalStep``
           at full width.  GPT-2 124M (the gpt2 rung at 4 of its 12
           layers, its token file, 12
           steps, async saves every 3, ``CheckpointManager(keep=2)``): an
           unfaulted golden run, then the schedule of
           ``scripts/resilience_smoke.py`` extended for the card (a
           ``storage_write`` and a ``loader_next`` absorbed by the retries,
           NaN at steps 6-7 under ``AnomalyPolicy(threshold=2)``, a real
           CUDA OOM in step 9's wrapper, a preemption at step 10) and a
           resume on fresh objects: the ``RunResult`` the reference loop
           gives, losses, parameters and moments bitwise the golden run's,
           the ``resilience_*`` and ``checkpoint_*`` counters, the
           dashboard's ``resilience:`` block, ``steps.jsonl``, the OOM's
           flight record; a timed save and restore, memtrack's gauges
           against the allocator.  The quiet envelope: 12 GPT-2 steps of
           the bare loop, of the loop with nothing armed, and of it with
           telemetry on (median step ms).  The 1.3B at full width and 4 of
           its 24 layers: 4 bare steps against a run preempted at step 2
           (an emergency synchronous save of the whole state) and its
           resume, bitwise, one K8 a step, the
           save's and restore's seconds, peak memory.  Two ranks of the
           card over gloo (GPT-2 at 2 of 12 layers, B=6 a rank, DDP, coordinated,
           consistency every 2, 8 steps): a real SIGTERM to rank 1 agreed
           by both, emergency-saved and resumed bitwise; a one-ulp change
           of a replicated parameter on rank 1 raising ``DesyncError`` on
           both ranks with nothing committed after it
  telemetry  the profiler and telemetry on the two traced paths.  The 8B
           serve (run while the serve phase's engine is alive): the 16
           requests with ``telemetry.init`` (time-series store, alert engine
           and cost auditor on), ndtimeline active and the ops server up,
           then untraced: streams bitwise the serve phase's,
           ``verify_request_chains`` clean, ``/router``'s ``alerts`` live,
           K1/K7 launches counted, decode p50 traced against untraced beside
           the calibrated step estimate (from the card's matmul sample, and
           from the harvested decode spans).  GPT-2 124M (after the gpt2
           phase): 6 steps with the same stack and a ``ChromeTraceHandler``,
           an async save after step 3 committed in step 4, the last 2 steps
           under ``torch.profiler``: losses bitwise the gpt2 phase's, six
           TRAIN_STEP, DATA_LOAD and OPTIMIZER_STEP spans and one
           CHECKPOINT_SAVE and COMMIT, a ``spans`` rollup on every
           ``steps.jsonl`` line, the Perfetto file's spans back, every K1,
           K3, K4, K9 and K10 launch of the profiled steps inside a
           train-step range and every K8 inside an optimizer-step range,
           counted as ``LAUNCHES`` counts them; the step report (FLOPs
           against the analytic count, peak bytes, the top 5 layers against
           the card's roofline); the calibration's matmul sample and
           ``device_peak_flops``
  tp_train  tensor and sequence parallelism on two ranks of the one card:
           child processes (``--tp-child``) joined over gloo at a free
           localhost port (NCCL refuses two ranks on one GPU), a ("tp",)
           mesh of 2.  The 1.3B Llama under ``llama_plan`` at full width
           and 2 of its 24 layers (``GLOO_13B_LAYERS``) and GPT-2 124M under
           ``nanogpt_plan`` at full width and 2 of its 12 layers
           (``GLOO_GPT2_LAYERS``), both with sequence
           parallelism, built on ``meta`` and materialized as each rank's
           pieces of the bench's seed-0 weights, trained on its batches
           through the vocab-parallel loss with ``AdamWLowmem``: 1 warm-up
           and 1 timed step, losses within 1% of a single-card run's at the
           same depth at each step, every
           kernel launch of each step counted (2 K1, dq and dkv, one
           K8, K9 and K10); per rank step time, peak memory and the
           collectives' calls and bytes by kind.  The kernels' parity and
           timing at one rank's shapes are in the parity phase.  The 1.3B
           ranks then run the plan phase's legs (a)-(d)
  plan     planning and analysis (``dmp``, ``debug``, ``analysis``,
           ``redistribute_plan``) at the 1.3B's widths.  In tp_train's 1.3B
           ranks: (a) ``auto_parallelize_module(..., policy="MEGATRON")``
           gives every parameter ``llama_plan``'s placements, and its two
           steps' losses are bitwise the ``llama_plan`` steps'; (b) a
           ``CommDebugMode`` around those steps counts exactly the
           ``collectives.CALLS`` / ``BYTES`` deltas; (c) shardcheck of the
           tp=2 forward traced on ``meta`` reports no error for
           ``llama_plan``, and VSC101 or VSC102 with a byte estimate for a
           plan with ``o_proj`` column-parallel (trace wall time printed);
           (d) a calibration table measured on the two gloo ranks, then
           ``score_candidates`` over 2 and 4 devices: the predicted (1, 2,
           1) step beside the measured tp=2 step (gloo on one card prices a
           link no NCCL deployment has).  (e) four gloo ranks of the card
           on a (2, 2) mesh: the reference's former-fallback battery on one
           1.3B layer's fp32 leaves (q_proj 2048^2, gate 2048x5632, down
           5632x2048, the 32000x2048 embedding), each transition bitwise the
           same transition through the full tensor, no fallback, the tier
           and hops, each rank's peak above what it held beside the peak of
           going through Replicate; and the int8 overlay
           (``VESCALE_REDISTRIBUTE_QUANT=1``) on a 40M-element Partial ->
           Replicate leaf, bitwise ``all_reduce_q``
  tp_serve  Llama-3-8B over two such ranks: the serve weights
           materialized from ``meta`` as ``llama_plan`` pieces, a Shard(3)
           pool (4 of 8 kv heads a rank), the serve phase's 16 requests
           through ``run_serve``: every check of the serve phase (512 K1
           launches on 16 heads, a K7 launch a layer a decode step, on 4 kv
           heads), teacher-forced logits of 1 request within
           ``TP_SERVE_BF16_STEPS`` bf16 steps at scale of the single-card
           engine's, how many streams equal the serve phase's, tokens/s,
           decode p50/p99, and ``engine.graphed`` (false over gloo)
  dp_train  data parallelism on two such ranks, a ("dp",) mesh of 2.  The
           1.3B Llama at full width and 2 layers (B=1 a rank, T=4096, the
           bench's seed-0 weights, ``AdamWLowmem(3e-4)``, a global batch of
           2 rows) under ``ddp``, ``zero2`` (a dynamic loss scale) and
           ``fsdp`` (``bench.prepare_dp``), 1 warm-up and 2 timed steps
           each: losses within 1% of a single-card run of the same two
           rows at that depth (``grad_accum_steps=2``), every rank's parameters bitwise
           the other's, the modes bitwise equal (or within
           ``DP_MODE_BOUND``), one K8 launch a step; under ``zero2`` one
           more step with an inf in rank 1's gradient: skipped on both
           ranks, parameters, main params, moments and step bitwise
           unchanged, no K8 launch, the scale halved; per mode and rank
           step time, peak memory, collectives by kind, gloo's share of the
           last step.  GPT-2 124M at 2 of its 12 layers under DDP at B=6 a
           rank from the elastic loader (a single-card run's B=12 stream at
           that depth), exact and with ``grad_compress="int8"``: exact
           within 1% of that run,
           int8 within 5% of exact at 3.5x or more fewer gradient bytes.
           Then K8 at rank 0's ZeRO pieces and FSDP flat piece against its
           plain version (moments bitwise, u within 4 ulps), timed against
           the plain version and its bound, and the block quantizer's
           quantize and dequantize ms on one 40M-element bucket

  pipeline (a) GPT-2 124M at the gpt2 rung's batch (B=12, T=1024) as 4
           microbatches through ``PipeEngine`` over ``gpt_pipeline_units``:
           GPipe, 1F1B and zero bubble at 4 stages, interleaved at 2x2, the
           cost-driven zero bubble priced by ``profile_costs``: each loss
           bitwise the unpipelined step's (``make_train_step``'s
           accumulation), grads bitwise but the tied wte (GPipe: within a
           bound), launches equal to the schedule's count, no weight-grad
           matmul in a dgrad, the spans' bubble fraction, one K8 step's
           masters; (b) ``split_graph`` of the same model into 4 groups:
           its forward and 1F1B loss bitwise, one node per kernel; (d) the
           1.3B scanned and under each mapped ``remat_policy``: losses and
           masters bitwise the plain step's, each run's forward stash and
           its phases' peaks (the optimizer's sets the step's); (c) the
           1.3B (scanned) at 4 of its 24 layers at
           pp=2, two gloo ranks of the card, 4 rows of T=4096 in 4
           microbatches, embedding and head replicated, through
           ``pipeline_blocks`` (V=1, 2) and ``pipeline_blocks_zb`` (V=2):
           losses and grads within stated bounds of one card's, the
           replicated grads equal on both ranks, each rank's launches the
           leg's count (flash only); step ms, peak, ppermutes and gloo's
           share per rank
  moe      mixture of experts and Mixtral (``moe/``, ``models/mixtral.py``).
           (a) the bench's moe_cpu config at head_dim 64 (width 128, 2
           heads, 1 kv head, FFN 256, 4 experts, fp32) trained 3 steps on
           the card and on the CPU from the same weights: routing equal on
           every token of the first step, losses within stated bounds; (b)
           the bench's moe rung (the reference rung's config: 8 layers,
           width 768, FFN 1536, 12 heads, 4 kv heads, 8 experts, top-2,
           capacity 2.0, bf16, B=2, T=2048): 2 warm-up and 5 timed steps,
           finite falling loss, 8 K1, 8 dq, 8 dkv and 2 K8 (the fp32 and
           bf16 groups) a step, step ms, tokens/s, MFU over the active
           parameters, peak, each layer's ``expert_tokens``, one profiled
           step by kernel kind and by matmul role (the dense dispatch and
           combine products apart from the experts'); (c) Mixtral-8x7B's
           widths at 2 of its 32 layers, the same batch: 1 warm-up and 2
           timed steps, launches, step ms, MFU, peak; (d) the rung under
           ``mixtral_plan`` on two gloo ranks of the card, an ("ep",) mesh
           of 2 (4 experts a rank): 3 steps, losses within 1% of (b)'s,
           the replicated grads bitwise equal on both ranks, each leaf's
           grad within a relative L2 bound of one card's (the experts'
           against their rows) that adds the routing flips' share to the
           bf16 noise, the tokens whose top-2 differs from one card's by
           layer, the collectives by kind and gloo's share; (e) in the same
           spawn, the rung at 4 of its 8 layers, 6 steps through
           ``MoEParamBuffer`` and ``MoEOptimizer``
           twice, once refreshed after step 3 to ``BasicExpertsAllocator``'s
           units from an EMA of ``expert_tokens``: the units change, and
           losses, parameters and moments are bitwise the unrefreshed run's
  nd       n-D composition on four gloo ranks of the card, one spawn that
           starts up while this process runs the one-card references, each
           leg on its own mesh over the four ranks: (a) the moe rung at 4
           of its 8 layers on ("dp", "ep") = (2, 2) (each dp rank one row;
           the capacity, slot
           keep and aux loss of the global batch) through
           ``make_train_step``'s default DDP, 3 steps, then 1 step at
           capacity 1.0, then 3 steps of ``DistributedOptimizer(dp_dims=
           ("dp", "ep"))``: the first step's loss within 1% of one card's at
           the same capacity and each leaf's grad within moe.ep's relative
           L2 bound with the routing flips, the dropped pairs on both sides,
           the replicated leaves bitwise equal across "ep", ZeRO's losses
           within 1% of DDP's; (b) Mixtral-8x7B's widths at 1 of its 32
           layers on ("ep", "tp") = (2, 2) with sequence parallelism, 3
           steps: the first step's loss and grads against one card's, step
           ms, peak a rank, gloo's share; (c) GPT-2 124M's widths at 2 of 12
           layers on ("dp", "tp") = (2, 2) under ``nanogpt_plan`` with the
           MLP kernels sharded over "dp" too (FSDP by the plan) and a
           ``DistributedOptimizer``, 3 steps of the gpt2 rung's batches: the
           losses within 1% of one card's at that depth.  Every rank's
           launches a step in every leg
  longctx  long context (``parallel/context.py``, the bench's longctx rung).
           (a) K1, dq and dkv at the rung's (1, 32768, 16, 8, 64), a ring
           block's (1, 16384, 16, 16, 64) causal and full, and Ulysses'
           (1, 32768, 8, 8, 64): each launched at full size, then its first
           and last heads alone, bitwise the full launch's rows and held to
           the plain versions on that head (float64 within 2 bf16 steps,
           the bf16-P models within 1); times, bounds, the plain versions'
           times on one head and SDPA's forward and backward; (b) the
           longctx rung (the 350M at B=1, T=32768, remat over the MLP,
           ``scan_layers``): 2 warm-up and 3 timed steps, 24 K1, dq and dkv
           and one K8 a step, the loss falling, step ms, MFU, peak, one
           profiled step; (d) ``blockwise_attention`` against the fp32
           flash kernels, forward and backward at T=4096 and forward at
           T=32768; (c) ring and Ulysses at sp=2 on two gloo ranks of the
           card over (1, 32768, 16, 16, 64) bf16: output and q/k/v grads
           against one card's flash attention on the whole sequence in
           bf16 steps, permutes and all-to-alls by calls, bytes and
           seconds, gloo's share; (e) in the same spawn ``all_reduce_q``
           ("nearest") of each rank's fp32 operand bitwise the emulator's
           ``quantized_all_reduce`` replay on the host
  fp8      fp8 training (``quant/fp8.py``, ``LlamaConfig.use_fp8``).  The
           bench's cpu rung (fp32) with ``use_fp8`` at head_dim 64, 3 steps
           on the card and on the CPU from the same weights, losses within
           a stated bound; the 1.3B rung with ``use_fp8`` for 20 steps: 3 x
           7 x 24 ``_scaled_mm`` calls a step, the kernel launches of each
           step, every state leaf finite and each history's [0] the step's
           amax (hooks in one more step), step ms, MFU over the bf16 peak,
           peak, one profiled step with its fp8 casts named, the quantize
           passes timed alone; then the bf16 rung from the same seed for 20
           steps: the fp8 loss falls and ends within 10% of the bf16 run's
  train_leftovers  the training leftovers on the card.  (a) Muon on the
           1.3B rung at full width and 8 of its 24 layers (``MUON_LAYERS``;
           ``bench.prepare("1.3b", opt="muon")``,
           the 1B sweep's ``muon(0.02, fallback=adamw_lowmem(3e-4),
           state_dtype=bf16)``): Newton-Schulz at (1024, 2816) on the card
           against the CPU (true fp32 products, TF32 off); the first step
           twice from the seed-0 state, bitwise; three more, the loss
           falling; 8 K1, dq and dkv, one K8 and 56 Newton-Schulz calls a
           step; step ms, Newton-Schulz ms (CUDA events), peak.  (b)
           nanoGPT's ``config/train_shakespeare_char.py`` at its published
           size with dropout 0.2, through the fused cross entropy and K8:
           two runs of 6 steps with step keys bitwise equal, the loss
           falling, no flash launch (dropout takes the dense branch), the
           first step's masks equal to the port's draws on the CPU, the
           eval loss from ``make_eval_step``; step ms and the dropout
           draws' share.  (c) the 8B widths at 2 layers written as HF
           safetensors shards by the script's own writer, read by
           ``load_hf_llama`` onto the card bitwise the tree in memory, 4
           requests served from each with bitwise equal greedy streams;
           write and load seconds and GB/s
  examples the port's example programs (``vescale_tpu_torch/examples/``)
           on one rank: the flash kernels' and the paged decode's times at
           head dims 100 and 16 (zero-padded to their compiled widths),
           each with its bound over the function's own work and over the
           padded work; a head dim outside the contract refused before any
           launch; (a) OpenLLaMA-3B at full width and depth (bf16, remat,
           B=2, T=2048, 2 warm-up and 5 timed steps: ms, tokens/s, MFU,
           peak; K1, K3/K4, K8 launched; the first loss near ln(vocab));
           (b) Llama-2-7B's widths at 4 of 32 layers (B=4, T=256, 10 steps),
           saved and restored bitwise; (c) nanoGPT at ``train.py``'s
           defaults over the char corpus, with and without ZeRO-2; (d)
           Mixtral at ``mixtral_train.py``'s defaults; (e) a crash at step
           12 of 20 (a child's exit 137) and a resume bitwise an
           uninterrupted run; (f) the auto-split tangled model at 3 stages
           under zero bubble within 1e-5 of the unsplit model; (g) the fp8
           Llama in bf16 with flash on (head dim 16), its loss scale and
           amax histories advancing.  ``--examples`` adds the head-dim
           parity cases (in the parity phase otherwise)
Then the card line, the kernels line and, last, ``{"ok": true, "device":
...}``.  Any failure raises and exits non-zero before that line.  Imports
nothing of JAX or of ``vescale_tpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

# published peaks of one H100 SXM (dense): memory rate, bf16 tensor cores,
# fp32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
BF16_ULP = 2.0 ** 16  # one bf16 step is 2^16 fp32 steps at the same scale


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3, sleep_cycles: int = 1 << 26) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back
    calls, timed with CUDA events after ``warmup`` calls.  A device-side
    wait of ``sleep_cycles`` (2^26: ~35 ms) is queued ahead of the start
    event, so the host has queued the calls before the card reaches them:
    the events bracket the card's time, not the host's launch rate, which
    would otherwise show in kernels shorter than a wrapper call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sass_wgmma(build) -> dict:
    """HGMMA (``wgmma``) instructions in the machine code of each kernel of
    the flash forward's and backward's libraries, from ``cuobjdump -sass``:
    the bf16 tensor-core kernels (``tc::``) must contain them, the fp32 ones
    (``simt::``) none.  Empty when the toolkit has no ``cuobjdump``."""
    import os
    import re

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    counts = {}
    for lib in ("flash_fwd", "flash_bwd"):
        sass = subprocess.run([tool, "-sass", str(build._target(lib))], check=True,
                              capture_output=True, text=True, timeout=300).stdout
        name = None
        for ln in sass.splitlines():
            if "Function :" in ln:
                m = re.search(r"(tc|simt)(?:\d+(dq|dkv))?\d+(kernel|flash_fwd_kernel)If?Li(\d+)", ln)
                name = ("::".join(x for x in m.group(1, 2, 3) if x) + f"<{m.group(4)}>" if m
                        else ln.split()[-1][:60])
                counts[name] = 0
            elif name is not None and "HGMMA" in ln:
                counts[name] += 1
    return counts


def paged_build_report(build) -> dict:
    """ptxas's registers and spills for each ``paged_decode`` kernel
    (``build/paged_decode.log`` and ``paged_decode_pad.log``), and the dynamic shared memory and ring
    stages of each (pool dtype, head_dim, group bucket); ``spills`` lists
    every kernel with a non-zero spill store or load."""
    import re

    from vescale_tpu_torch.kernels.paged_attention import kernel_layout

    kernels, spills, name = {}, [], None
    lines = [ln for lib in ("paged_decode", "paged_decode_pad")
             for ln in (build.BUILD_DIR / f"{lib}.log").read_text().splitlines()]
    for ln in lines:
        m = re.search(r"Function properties for \S*paged_decode_kernelI(f|13__nv_bfloat16)"
                      r"(f|13__nv_bfloat16|S\d*_)Li(\d+)ELi(\d+)ELb([01])E", ln)
        if m:
            tq, tkv, hd, g, pad = m.groups()
            tkv = tq if tkv.startswith("S") else tkv  # a repeated type is mangled as S_
            dt = {"f": "fp32", "13__nv_bfloat16": "bf16"}
            name = f"q {dt[tq]}, pools {dt[tkv]}, hd{hd}{' padded' if pad == '1' else ''}, G<={g}"
            kernels[name] = {}
        elif name is not None and "spill" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes spill", ln)]
            kernels[name]["spill_bytes"] = sum(nums)
            if any(nums):
                spills.append(name)
        elif name is not None and "registers" in ln:
            kernels[name]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
            name = None
    layouts = {f"{str(dt)[6:]} hd{hd} G<={g}": kernel_layout(dt, hd, g)
               for dt in (torch.bfloat16, torch.float32) for hd in (64, 128) for g in (4, 16)}
    return dict(kernels=kernels, spills=spills, layouts=layouts)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def free_memory() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ parity
def flash_cases():
    """(label, B, T, H, KV, D, causal, dtype, o bound, lse bound).

    fp32 (the CUDA-core kernel) o: 8 fp32 ulps (the JAX package's kernel
    bound), 16 where a row sums 1000 or more keys, in another order in the
    kernel's 32-key tiles than in cuBLAS.  The ulps are counted at the scale
    of max|v|: each output row is a convex combination of V rows, so its
    sums round at V's magnitude, while a full (non-causal) row averages all
    T keys and comes out smaller than that; at o's own scale (``o_ulps``,
    reported beside) the same rounding counts more ulps the longer the row.
    lse is fp32: 8 ulps at its scale, 16 where a row sums 1000 or more keys.

    bf16 (the tensor-core kernel, which rounds P to bf16 before the value
    product): o within 2 bf16 steps at scale (the o bound) of the plain
    version run in float64, and within 1 step (``BF16_ULP``) of the plain
    version with ``pd_dtype=torch.bfloat16``, which rounds P where the
    kernel does.  The kernel rounds exp(s - m) at the running row max and
    rescales later, the model at the final max, and they sum in other
    orders: each a difference within a bf16 step, and both round one fp32
    result to bf16.  lse within 16 fp32 ulps of the model's (8 at T=333;
    the model's lse is the unrounded fp32 one, as l sums P before the
    rounding in both, so the fp32 bounds above hold).  Two launches are
    bitwise equal.  The main cases are the Llama-3-8B prefill shape; the
    train 1.3b case is the 1.3B train shape; the gpt2 cases the GPT-2 124M
    train shape (head_dim 64, no GQA), and its pipeline microbatch of 3
    rows; rep 4 at T=333 runs the GQA map and a ragged edge on the tensor
    cores."""
    bf16, fp32 = torch.bfloat16, torch.float32
    return [
        ("main bf16", 1, 1024, 32, 8, 128, True, bf16, 2 * BF16_ULP, 16.0),
        ("main fp32", 1, 1024, 32, 8, 128, True, fp32, 16.0, 16.0),
        ("ragged T=1000 bf16", 1, 1000, 32, 8, 128, True, bf16, 2 * BF16_ULP, 16.0),
        ("full (non-causal) no GQA T=256 fp32", 2, 256, 8, 8, 128, False, fp32, 8.0, 8.0),
        ("hd64 T=77 fp32", 1, 77, 8, 4, 64, True, fp32, 8.0, 8.0),
        ("hd64 T=333 bf16 full", 1, 333, 8, 2, 64, False, bf16, 2 * BF16_ULP, 8.0),
        ("train 1.3b bf16", 1, 4096, 16, 8, 128, True, bf16, 2 * BF16_ULP, 16.0),
        ("gpt2 bf16", 12, 1024, 12, 12, 64, True, bf16, 2 * BF16_ULP, 16.0),
        ("gpt2 fp32", 12, 1024, 12, 12, 64, True, fp32, 16.0, 16.0),
        # the pipeline's GPT-2 microbatch: 3 of the rung's 12 rows
        ("gpt2 pp micro bf16", 3, 1024, 12, 12, 64, True, bf16, 2 * BF16_ULP, 16.0),
        # one rank's heads at tp = 2: the 1.3B train, the 8B prefill, GPT-2
        ("tp2 1.3b bf16", 1, 4096, 8, 4, 128, True, bf16, 2 * BF16_ULP, 16.0),
        ("tp2 8b prefill bf16", 1, 1024, 16, 4, 128, True, bf16, 2 * BF16_ULP, 16.0),
        ("tp2 gpt2 bf16", 12, 1024, 6, 6, 64, True, bf16, 2 * BF16_ULP, 16.0),
        # the moe rung's attention (GQA group 3) and Mixtral-8x7B's widths
        ("moe rung bf16 (GQA 3)", 2, 2048, 12, 4, 64, True, bf16, 2 * BF16_ULP, 16.0),
        ("mixtral 8x7b bf16", 2, 2048, 32, 8, 128, True, bf16, 2 * BF16_ULP, 16.0),
        # head dims between the compiled 64 and 128, zero-padded to them:
        # OpenLLaMA-3B's 100, the tiny configs' 32, the fp8 example's 16
        ("open_llama 3b hd100 bf16", 1, 2048, 32, 32, 100, True, bf16, 2 * BF16_ULP, 16.0),
        ("hd100 T=333 fp32", 1, 333, 8, 4, 100, True, fp32, 8.0, 8.0),
        ("hd32 T=256 bf16", 2, 256, 8, 4, 32, True, bf16, 2 * BF16_ULP, 8.0),
        ("hd32 T=128 fp32", 2, 128, 8, 4, 32, True, fp32, 8.0, 8.0),
        ("hd16 T=64 bf16", 8, 64, 8, 4, 16, True, bf16, 2 * BF16_ULP, 8.0),
        ("hd16 T=64 fp32", 8, 64, 8, 4, 16, True, fp32, 8.0, 8.0),
    ]


# the parity cases of the head dims between the compiled ones (``--examples``
# runs only these, with the paged decode's)
HEAD_DIM_PARITY = ("open_llama 3b hd100 bf16", "hd100 T=333 fp32", "hd32 T=256 bf16",
                   "hd32 T=128 fp32", "hd16 T=64 bf16", "hd16 T=64 fp32")

# the parity cases at the moe phase's shapes (``--moe`` runs only these)
MOE_PARITY = ("moe rung bf16 (GQA 3)", "mixtral 8x7b bf16")


def flash_fwd_inputs(dev, B, T, H, KV, D, causal, dtype):
    g = torch.Generator(device=dev).manual_seed(T * 31 + H)
    q = torch.randn(B * H, T, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B * KV, T, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B * KV, T, D, generator=g, device=dev).to(dtype)
    return q, k, v, dict(scale=1.0 / D ** 0.5, causal=causal, H=H, KV=KV)


def run_flash_parity(dev, ulps, only=None):
    """Kernel against plain version per case (see ``flash_cases``; ``only``:
    the cases of these labels); the rows' ``max_abs_err`` is against the
    plain version the kernel is held to: the fp32 one for fp32, the bf16-P
    model for bf16."""
    from vescale_tpu_torch.kernels.flash_attention import flash_fwd, flash_fwd_reference

    out = []
    for label, B, T, H, KV, D, causal, dtype, o_bound, lse_bound in flash_cases():
        if only is not None and label not in only:
            continue
        q, k, v, args = flash_fwd_inputs(dev, B, T, H, KV, D, causal, dtype)
        o, lse = flash_fwd(q, k, v, **args)
        o_ref, lse_ref = flash_fwd_reference(q, k, v, **args)
        row = dict(kernel="flash_fwd", case=label, o_bound=o_bound, lse_bound=lse_bound)
        if dtype == torch.bfloat16:
            again = flash_fwd(q, k, v, **args)
            o_model, lse_model = flash_fwd_reference(q, k, v, pd_dtype=torch.bfloat16, **args)
            o64, lse64 = flash_fwd_reference(q.double(), k.double(), v.double(), **args)
            torch.cuda.synchronize()
            o_np, o64_np = o.double(), o64
            row.update(
                o_ulps=ulps(o_np, o64_np),
                o_model_ulps=ulps(o_np, o_model.double()), o_model_bound=BF16_ULP,
                o_plain_fp32_ulps=ulps(o_ref.double(), o64_np),
                lse_ulps=ulps(lse, lse_model),
                lse_f64_ulps=ulps(lse.double(), lse64),
                bitwise_repeat=bits_equal(o, again[0]) and bits_equal(lse, again[1]),
                max_abs_err=float((o.float() - o_model.float()).abs().max()))
            row["ok"] = (row["bitwise_repeat"] and row["o_ulps"] <= o_bound
                         and row["o_model_ulps"] <= BF16_ULP and row["lse_ulps"] <= lse_bound)
            del again, o_model, lse_model, o64, lse64
        else:
            torch.cuda.synchronize()
            o_np, ref_np = o, o_ref
            err = float((o_np - ref_np).abs().max())
            v_step = float(np.spacing(np.float32(v.abs().max().item())))
            row.update(o_ulps=ulps(o_np, ref_np), o_ulps_at_v=err / v_step,
                       lse_ulps=ulps(lse, lse_ref), max_abs_err=err)
            row["ok"] = row["o_ulps_at_v"] <= o_bound and row["lse_ulps"] <= lse_bound
        out.append(row)
        del q, k, v, o, lse, o_ref, lse_ref
        free_memory()
    return out


def paged_geometries():
    """The K7 timing shapes.  A: the Llama-3-8B serve shape (S=8, page 16,
    Pmax 64, KV=8, H=32, hd 128) with ragged lengths from only the fresh
    token to a full slot; B: 8 slots at the 8B's own 8k context (Pmax 512);
    C: 64 slots of 64-1024 positions; A_tp2: A on one rank's heads at
    tp = 2 (H=16, KV=4)."""
    base = dict(page=16, KV=8, H=32, hd=128)
    rng = np.random.default_rng
    a_lengths = [1, 1024, 17, 300, 511, 64, 700, 2]
    return {
        "A": dict(S=8, Pmax=64, lengths=a_lengths, **base),
        "A_tp2": dict(S=8, Pmax=64, lengths=a_lengths, page=16, KV=4, H=16, hd=128),
        "B": dict(S=8, Pmax=512, lengths=[int(x) for x in rng(0).integers(4096, 8193, 8)], **base),
        "C": dict(S=64, Pmax=64, lengths=[int(x) for x in rng(0).integers(64, 1025, 64)], **base),
    }


def paged_head_dim_geometries():
    """The paged decode at head dims between the compiled ones, the pool
    unpadded: OpenLLaMA-3B's (KV = H = 32, hd 100) and the tiny Llamas' (KV
    4, H 8, hd 32), at the lengths where the partition changes shape."""
    from vescale_tpu_torch.kernels.paged_attention import CHUNK, CLUSTER

    span = CHUNK * CLUSTER
    lengths = [1, CHUNK - 1, CHUNK + 1, span + 1, 700, 16 * 64]
    return {"hd100 open_llama": dict(S=6, page=16, Pmax=64, KV=32, H=32, hd=100,
                                     lengths=lengths),
            "hd32 G2": dict(S=6, page=16, Pmax=64, KV=4, H=8, hd=32, lengths=lengths)}


def paged_cases():
    """(label, q dtype, pool dtype, geometry, bound).  Shapes A, B and C
    (``paged_geometries``); the lengths where the kernel's partition
    changes shape (chunks of ``CHUNK`` positions dealt to ``CLUSTER`` CTAs:
    a chunk less one, a chunk, a chunk and one, the ranks wrapping, a full
    slot, and past the table's reach, which the kernel clamps); a
    non-power-of-two page of 6 as the JAX package's tests use; and 16 q
    heads a kv head at both head dims.  fp32 pools: 8 ulps at tensor scale;
    bf16 pools: 64, the JAX package's bound for them."""
    from vescale_tpu_torch.kernels.paged_attention import CHUNK, CLUSTER

    geo = paged_geometries()
    span = CHUNK * CLUSTER
    edge_lengths = [1, CHUNK - 1, CHUNK, CHUNK + 1, span - 1, span + 1, 16 * 64, 16 * 64 + 476]
    edges = dict(S=8, page=16, Pmax=64, KV=8, H=32, hd=128, lengths=edge_lengths)
    page6 = dict(S=3, page=6, Pmax=5, KV=2, H=8, hd=64, lengths=[1, 30, 13])
    edges6 = dict(S=8, page=6, Pmax=50, KV=2, H=8, hd=64,
                  lengths=[1, CHUNK - 1, CHUNK, CHUNK + 1, span - 1, span + 1, 300, 350])
    g16 = dict(S=4, page=16, Pmax=20, KV=2, H=32, hd=64, lengths=[1, 65, 257, 320])
    g16_128 = dict(S=4, page=16, Pmax=20, KV=1, H=16, hd=128, lengths=[2, 64, 300, 320])
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = []
    for label, g in (("A", geo["A"]), ("A_tp2", geo["A_tp2"]), ("B", geo["B"]), ("C", geo["C"]),
                     ("chunk edges", edges), ("page 6 chunk edges hd64", edges6),
                     ("G16 hd64", g16), ("G16 hd128", g16_128),
                     *((k, v) for k, v in paged_head_dim_geometries().items())):
        cases += [(f"{label} bf16", bf16, bf16, g, 64.0), (f"{label} fp32", fp32, fp32, g, 8.0)]
    return cases + [
        ("page 6 hd64 fp32 pools, bf16 q", bf16, fp32, page6, 8.0),
        ("page 6 hd64 bf16", bf16, bf16, page6, 64.0),
    ]


def paged_inputs(dev, q_dtype, pool_dtype, S, page, Pmax, KV, H, hd, lengths, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    N = S * Pmax + 1
    kp = torch.randn(N, page, KV, hd, generator=g, device=dev).to(pool_dtype)
    vp = torch.randn(N, page, KV, hd, generator=g, device=dev).to(pool_dtype)
    q = torch.randn(S, H, hd, generator=g, device=dev).to(q_dtype)
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(
        rng.permutation(np.arange(1, N))[: S * Pmax].reshape(S, Pmax).astype(np.int32)).to(dev)
    return q, kp, vp, table, torch.tensor(lengths, dtype=torch.int32, device=dev)


def paged_decode_float64(q, kp, vp, table, lengths, *, scale):
    """The plain version's gather chain run in float64 (the arbiter the
    kernel is held to): dense (S, page * Pmax) view, length mask,
    softmax, value product.  Returns float64 (S, H, hd)."""
    S, H, hd = q.shape
    _, page, KV, _ = kp.shape
    T = page * table.shape[1]
    idx = table.long()
    ks = kp[idx].reshape(S, T, KV, hd).double()
    vs = vp[idx].reshape(S, T, KV, hd).double()
    qg = (q.double() * scale).reshape(S, KV, H // KV, hd)
    s = torch.einsum("skgd,stkd->skgt", qg, ks)
    mask = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, -1e300))
    return torch.einsum("skgt,stkd->skgd", torch.softmax(s, dim=-1), vs).reshape(S, H, hd)


def nan_heads(out) -> list:
    """The (slot, head) pairs of ``out`` (S, H, hd) that hold a NaN."""
    return sorted({(int(s), int(h)) for s, h, _ in torch.nonzero(torch.isnan(out)).tolist()})


def run_paged_parity(dev, ulps, only=None):
    """Each case against the plain version run in float64
    (``paged_decode_float64``) at its bound, two launches bitwise; the
    distances to the fp32 plain version and of that version to float64 are
    reported beside: at 64 slots of up to 1,024 positions the fp32 plain
    version sits 6-8 fp32 ulps from float64 and the kernel 2-3 (on an
    H100), so the fp32 plain version is no arbiter at the 8-ulp bound
    there.  Then at
    shape A a NaN in K (and, apart, in V) at a valid position in the last
    chunk of the longest slot, which must poison exactly the heads the
    plain version poisons (that slot's kv group); then slot independence,
    bitwise: each slot's row equals its row of the full call when the other
    slots' lengths change and when it runs alone (S=1).  ``only``: the
    cases whose label starts with one of these, and nothing after them."""
    from vescale_tpu_torch.kernels.paged_attention import paged_decode, paged_decode_reference

    out = []
    for label, q_dtype, pool_dtype, geometry, bound in paged_cases():
        if only is not None and not label.startswith(tuple(only)):
            continue
        q, kp, vp, table, lengths = paged_inputs(dev, q_dtype, pool_dtype, **geometry)
        scale = 1.0 / q.shape[-1] ** 0.5
        o = paged_decode(q, kp, vp, table, lengths, scale=scale)
        again = paged_decode(q, kp, vp, table, lengths, scale=scale)
        o_ref = paged_decode_reference(q, kp, vp, table, lengths, scale=scale)
        o64 = paged_decode_float64(q, kp, vp, table, lengths, scale=scale)
        torch.cuda.synchronize()
        o_np, o64_np = o.double(), o64
        u = ulps(o_np, o64_np)
        rep = bits_equal(o, again)
        out.append(dict(kernel="paged_decode", case=label, ulps=u, bound=bound,
                        plain_fp32_ulps=ulps(o_np, o_ref.double()),
                        plain_fp32_vs_f64_ulps=ulps(o_ref.double(), o64_np),
                        max_abs_err=float((o - o_ref).abs().max()), bitwise_repeat=rep,
                        ok=u <= bound and rep))
        del q, kp, vp, o, again, o_ref, o64
        free_memory()
    if only is not None:
        return out

    geo = paged_geometries()["A"]
    q, kp, vp, table, lengths = paged_inputs(dev, torch.bfloat16, torch.bfloat16, **geo)
    scale = 1.0 / geo["hd"] ** 0.5
    s, pos, kvh = 1, geo["lengths"][1] - 3, 2  # the 1024-slot, in its last chunk
    G = geo["H"] // geo["KV"]
    for pool_name in ("k", "v"):
        kp1, vp1 = kp.clone(), vp.clone()
        (kp1 if pool_name == "k" else vp1)[table[s, pos // geo["page"]], pos % geo["page"], kvh, 5] = \
            float("nan")
        o = paged_decode(q, kp1, vp1, table, lengths, scale=scale)
        o_ref = paged_decode_reference(q, kp1, vp1, table, lengths, scale=scale)
        torch.cuda.synchronize()
        want = [(s, h) for h in range(kvh * G, (kvh + 1) * G)]
        got, ref = nan_heads(o), nan_heads(o_ref)
        u = ulps(o, o_ref)
        out.append(dict(kernel="paged_decode", case=f"A bf16, NaN in {pool_name.upper()} at slot {s} "
                        f"position {pos}, kv head {kvh}", nan_heads=got, plain_nan_heads=ref,
                        ulps=u, bound=64.0, ok=got == ref == want and u <= 64.0))
        del kp1, vp1

    full = paged_decode(q, kp, vp, table, lengths, scale=scale)
    alone_equal, changed_equal = [], []
    for s in range(geo["S"]):
        other = (lengths * 7 + 3) % (geo["page"] * geo["Pmax"]) + 1
        other[s] = lengths[s]
        changed = paged_decode(q, kp, vp, table, other, scale=scale)
        alone = paged_decode(q[s:s + 1].contiguous(), kp, vp, table[s:s + 1].contiguous(),
                             lengths[s:s + 1].contiguous(), scale=scale)
        changed_equal.append(bits_equal(changed[s], full[s]))
        alone_equal.append(bits_equal(alone[0], full[s]))
    out.append(dict(kernel="paged_decode", case="A bf16, slot independence (bitwise)",
                    other_lengths_changed=changed_equal, alone=alone_equal,
                    ok=all(changed_equal) and all(alone_equal)))
    del q, kp, vp, full
    free_memory()
    return out


# --------------------------------------------------------- flash backward
def flash_bwd_cases():
    """(label, B, T, H, KV, D, causal, dtype, bound on dq, dk and dv).

    fp32 (the CUDA-core kernels): against the plain version run in float64
    on the same inputs (upcast exactly), the kernel is within 8 ulps at
    scale (``ulps_at_scale``, the JAX package's kernel bound) or no further
    from it than the plain version in fp32 is (``plain_fp32_ulps``,
    reported beside).  The fp32 plain version is no arbiter itself: s
    rounds in fp32 before exp and dp - delta cancels, which costs ~10 ulps
    at scale even at T=96, and at T=4096 cuBLAS sums dk and dv over the
    group's rep * T queries in one fp32 accumulator, which drifts tens of
    ulps.
    bf16 (the tensor-core kernels): within 2 bf16 steps at scale of the
    plain version run in float64, and within 1 step (``BF16_ULP``) of the
    plain version with ``pd_dtype=torch.bfloat16``, which rounds P and dS
    to bf16 where the kernels do: the kernels and that model then differ
    only in the order of fp32 sums, and both round one fp32 result to bf16
    (adjacent bf16 values are one step apart); the fp32 plain version's
    distance to float64 is reported beside.  Two launches of each bf16
    kernel are bitwise equal.  The main cases are the 1.3B train shapes;
    the gpt2 cases the GPT-2 124M train shape (head_dim 64, no GQA), and
    its pipeline microbatch of 3 rows; rep 4 at T=333 runs the GQA loop and
    a ragged edge on the tensor cores."""
    bf16, fp32 = torch.bfloat16, torch.float32
    return [
        ("main bf16", 1, 4096, 16, 8, 128, True, bf16, 2 * BF16_ULP),
        ("main fp32", 1, 4096, 16, 8, 128, True, fp32, 8.0),
        ("ragged T=1000 fp32", 1, 1000, 16, 8, 128, True, fp32, 8.0),
        ("ragged T=1000 bf16", 1, 1000, 16, 8, 128, True, bf16, 2 * BF16_ULP),
        ("no GQA (rep 1) T=512 fp32", 2, 512, 8, 8, 128, True, fp32, 8.0),
        ("hd64 rep 4 T=333 fp32", 1, 333, 8, 2, 64, True, fp32, 8.0),
        ("hd64 rep 4 T=333 bf16", 1, 333, 8, 2, 64, True, bf16, 2 * BF16_ULP),
        ("full (non-causal) T=256 fp32", 2, 256, 8, 4, 128, False, fp32, 8.0),
        ("gpt2 bf16", 12, 1024, 12, 12, 64, True, bf16, 2 * BF16_ULP),
        ("gpt2 fp32", 12, 1024, 12, 12, 64, True, fp32, 8.0),
        # the pipeline's GPT-2 microbatch: 3 of the rung's 12 rows
        ("gpt2 pp micro bf16", 3, 1024, 12, 12, 64, True, bf16, 2 * BF16_ULP),
        # one rank's heads at tp = 2
        ("tp2 1.3b bf16", 1, 4096, 8, 4, 128, True, bf16, 2 * BF16_ULP),
        ("tp2 gpt2 bf16", 12, 1024, 6, 6, 64, True, bf16, 2 * BF16_ULP),
        # the moe rung's attention (GQA group 3) and Mixtral-8x7B's widths
        ("moe rung bf16 (GQA 3)", 2, 2048, 12, 4, 64, True, bf16, 2 * BF16_ULP),
        ("mixtral 8x7b bf16", 2, 2048, 32, 8, 128, True, bf16, 2 * BF16_ULP),
        # head dims between the compiled 64 and 128 (HEAD_DIM_PARITY)
        ("open_llama 3b hd100 bf16", 1, 2048, 32, 32, 100, True, bf16, 2 * BF16_ULP),
        ("hd100 T=333 fp32", 1, 333, 8, 4, 100, True, fp32, 8.0),
        ("hd32 T=256 bf16", 2, 256, 8, 4, 32, True, bf16, 2 * BF16_ULP),
        ("hd32 T=128 fp32", 2, 128, 8, 4, 32, True, fp32, 8.0),
        ("hd16 T=64 bf16", 8, 64, 8, 4, 16, True, bf16, 2 * BF16_ULP),
        ("hd16 T=64 fp32", 8, 64, 8, 4, 16, True, fp32, 8.0),
    ]


def flash_bwd_inputs(dev, B, T, H, KV, D, causal, dtype):
    from vescale_tpu_torch.kernels.flash_attention import flash_fwd

    g = torch.Generator(device=dev).manual_seed(T * 7 + H + D)
    q = torch.randn(B * H, T, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B * KV, T, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B * KV, T, D, generator=g, device=dev).to(dtype)
    do = torch.randn(B * H, T, D, generator=g, device=dev).to(dtype)
    args = dict(scale=1.0 / D ** 0.5, causal=causal, H=H, KV=KV)
    o, lse = flash_fwd(q, k, v, **args)
    return q, k, v, o, do, lse, args


def run_flash_bwd_parity(dev, ulps, only=None):
    """Kernel against plain version per case, then two launches of the bf16
    kernels bitwise at the main and gpt2 shapes, then the autograd op
    against autograd through the dense reference, then the times of the
    main and gpt2 bf16 cases.  ``only``: the cases of these labels, and
    nothing after them."""
    from vescale_tpu_torch.kernels.flash_attention import flash_bwd, flash_bwd_reference

    names = ("dq", "dk", "dv")
    out, repeats = [], {}
    for label, B, T, H, KV, D, causal, dtype, bound in flash_bwd_cases():
        if only is not None and label not in only:
            continue
        q, k, v, o, do, lse, args = flash_bwd_inputs(dev, B, T, H, KV, D, causal, dtype)
        got = flash_bwd(q, k, v, o, do, lse, **args)
        plain = flash_bwd_reference(q, k, v, o, do, lse, **args)
        exact = flash_bwd_reference(*(t.double() for t in (q, k, v, o, do, lse)), **args)
        row = dict(kernel="flash_bwd", case=label, bound=bound)
        for name, a, b in zip(names, plain, exact):
            row[f"{name}_plain_fp32_ulps"] = ulps(a.double(), b)
        if dtype == torch.bfloat16:
            again = flash_bwd(q, k, v, o, do, lse, **args)
            model = flash_bwd_reference(q, k, v, o, do, lse, pd_dtype=torch.bfloat16, **args)
            row["model_bound"] = BF16_ULP
            for name, a, m in zip(names, got, model):
                row[f"{name}_model_ulps"] = ulps(a.double(), m.double())
            row["bitwise_repeat"] = all(bits_equal(a, b) for a, b in zip(got, again))
            repeats[label] = row["bitwise_repeat"]
            del again, model
        torch.cuda.synchronize()
        for name, a, b in zip(names, got, exact):
            row[f"{name}_ulps"] = ulps(a.double(), b)
            row[f"{name}_max_abs_err"] = float((a.double() - b).abs().max())
        if dtype == torch.bfloat16:
            row["ok"] = row["bitwise_repeat"] and all(
                row[f"{n}_ulps"] <= bound and row[f"{n}_model_ulps"] <= BF16_ULP for n in names)
        else:
            row["ok"] = all(row[f"{n}_ulps"] <= max(bound, row[f"{n}_plain_fp32_ulps"])
                            for n in names)
        out.append(row)
        del q, k, v, o, do, lse, got, plain, exact
        free_memory()
    if only is not None:
        return out, {}
    shapes = ("main bf16", "gpt2 bf16")
    out.append(dict(kernel="flash_bwd", case="dq and dkv, two launches bitwise equal",
                    **{label: repeats[label] for label in shapes},
                    ok=all(repeats[label] for label in shapes)))
    out.append(run_flash_autograd(dev, ulps))
    return out, flash_bwd_timing(dev)


def run_flash_autograd(dev, ulps):
    """fp32 grads of ``ops.flash_attention`` (autograd Function over the
    kernels) against ``torch.autograd`` through the dense ``_dense_ref``,
    same inputs, B=1, T=512, H=16, KV=8, D=128, causal.  Bound: 64 ulps at
    scale.  The two are different algorithms in fp32: autograd's softmax
    backward takes the row term as rowsum(P * dP) from a normalised P, the
    kernels as rowsum(dO * O) with P recomputed from the logsumexp, and
    every sum runs in another order."""
    import importlib

    ops = importlib.import_module("vescale_tpu_torch.ops.flash_attention")
    B, T, H, KV, D = 1, 512, 16, 8, 128
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn(B, T, n, D, generator=g, device=dev) for n in (H, KV, KV))
    w = torch.randn(B, T, H, D, generator=g, device=dev)
    grads = []
    for fn in (lambda a, b, c: ops.flash_attention(a, b, c, causal=True),
               lambda a, b, c: ops._dense_ref(a, b, c, 1.0 / D ** 0.5, True)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        (fn(*leaves) * w).sum().backward()
        grads.append([x.grad for x in leaves])
    torch.cuda.synchronize()
    bound = 64.0
    row = dict(kernel="flash_bwd", case="autograd op vs dense autograd fp32 T=512", bound=bound)
    for name, a, b in zip(("dq", "dk", "dv"), *grads):
        row[f"{name}_ulps"] = ulps(a, b)
    row["ok"] = all(row[f"{n}_ulps"] <= bound for n in ("dq", "dk", "dv"))
    return row


def flash_bwd_timing(dev):
    """The dq and dkv kernels apart, in bf16, at the 1.3B train shape (the
    rows' own fields) and at the GPT-2 shape (under ``gpt2``).  The plain
    version computes dq, dk and dv together, and so does the library
    yardstick (the backward of ``scaled_dot_product_attention`` with the
    GQA heads expanded), so both rows carry the same plain and library
    times, and ``pair_over_library`` = (dq + dkv) / library."""
    import torch.nn.functional as F

    from vescale_tpu_torch.kernels.flash_attention import (
        _delta, flash_bwd, flash_bwd_dkv, flash_bwd_dkv_cost, flash_bwd_dq, flash_bwd_dq_cost,
        flash_bwd_reference,
    )

    by_label = {case[0]: case for case in flash_bwd_cases()}
    rows = {"flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    keys = {"gpt2 bf16": "gpt2", "tp2 1.3b bf16": "tp2_1.3b", "tp2 gpt2 bf16": "tp2_gpt2",
            "moe rung bf16 (GQA 3)": "moe", "mixtral 8x7b bf16": "mixtral_8x7b"}
    for label in ("main bf16", "gpt2 bf16", "tp2 1.3b bf16", "tp2 gpt2 bf16",
                  "moe rung bf16 (GQA 3)", "mixtral 8x7b bf16"):
        _, B, T, H, KV, D, causal, dtype, _ = by_label[label]
        q, k, v, o, do, lse, args = flash_bwd_inputs(dev, B, T, H, KV, D, causal, dtype)
        lse2, delta = lse.reshape(B * H, T), _delta(o, do)
        got = flash_bwd(q, k, v, o, do, lse, **args)
        ref = flash_bwd_reference(q, k, v, o, do, lse, **args)
        err = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref)]
        dq_ms = cuda_ms(lambda: flash_bwd_dq(q, k, v, do, lse2, delta, **args), iters=10)
        dkv_ms = cuda_ms(lambda: flash_bwd_dkv(q, k, v, do, lse2, delta, **args), iters=10)
        plain_ms = cuda_ms(lambda: flash_bwd_reference(q, k, v, o, do, lse, **args), iters=3,
                           warmup=1)
        rep = H // KV
        q4 = q.reshape(B, H, T, D).detach().requires_grad_()
        k4 = k.reshape(B, KV, T, D).repeat_interleave(rep, dim=1).detach().requires_grad_()
        v4 = v.reshape(B, KV, T, D).repeat_interleave(rep, dim=1).detach().requires_grad_()
        out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
        do4 = do.reshape(B, H, T, D)
        library_ms = cuda_ms(
            lambda: torch.autograd.grad(out4, (q4, k4, v4), do4, retain_graph=True))
        shape = dict(B=B, T=T, H=H, KV=KV, D=D, dtype=str(dtype), causal=causal)
        # the kernels' own counts (kernels/flash_attention.py): q k v do, lse
        # and delta read; dq, or dk and dv, written
        dq_flops, dq_bytes = flash_bwd_dq_cost(q, k, v, do, lse2, delta, **args)
        dkv_flops, dkv_bytes = flash_bwd_dkv_cost(q, k, v, do, lse2, delta, **args)
        common = dict(plain_ms=plain_ms, library_ms=library_ms,
                      pair_over_library=(dq_ms + dkv_ms) / library_ms, shape=shape)
        timed = {
            "flash_bwd_dq": dict(ms=dq_ms, max_abs_err=err[0], **common,
                                 **bound(dq_bytes, dq_flops, dtype)),
            "flash_bwd_dkv": dict(ms=dkv_ms, max_abs_err=max(err[1], err[2]), **common,
                                  **bound(dkv_bytes, dkv_flops, dtype)),
        }
        for name, fields in timed.items():
            if label == "main bf16":
                rows[name].update(fields)
            else:
                rows[name][keys[label]] = fields
        del q, k, v, o, do, lse, got, ref, q4, k4, v4, out4
        free_memory()
    return rows


# ------------------------------------------------------------- fused adamw
def ulps_elementwise(a, b) -> float:
    """Max per-element fp32 ulp distance, each element at its own spacing;
    NaN patterns must agree (else inf)."""
    a32, b32 = a.float(), b.float()
    if not torch.equal(torch.isnan(a32), torch.isnan(b32)):
        return float("inf")
    fin = torch.isfinite(a32) & torch.isfinite(b32)
    if not bool(fin.any()):
        return 0.0
    a32, b32 = a32[fin], b32[fin]
    mag = b32.abs()
    step = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    return float(((a32.double() - b32.double()).abs() / step.double()).max())


def bits_equal(a, b) -> bool:
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def train_leaf_shapes():
    """The 219 leaf shapes of the 1.3B Llama (24 layers x 9 + 3)."""
    from vescale_tpu_torch.bench import RUNGS
    from vescale_tpu_torch.models import LlamaConfig, param_shapes

    def flat(node):
        if isinstance(node, dict):
            return [s for key in node for s in flat(node[key])]
        return [node]

    return flat(param_shapes(LlamaConfig(**RUNGS["1.3b"][0])))


def tp2_leaf_shapes():
    """One rank's pieces of the 1.3B's leaves under ``llama_plan`` at tp=2:
    the leaves K8 steps in ``tp_train``."""
    from vescale_tpu_torch.bench import RUNGS
    from vescale_tpu_torch.dmodule.api import _match
    from vescale_tpu_torch.mesh import DeviceMesh
    from vescale_tpu_torch.models import LlamaConfig, llama_plan, param_shapes
    from vescale_tpu_torch.models.convert import _flatten
    from vescale_tpu_torch.spec import DArraySpec, TensorMeta

    mesh = DeviceMesh(("tp",), (2,), device_type="cpu")
    plan = llama_plan(mesh)["parameter"]
    return [DArraySpec(mesh, _match(plan, path)[1], TensorMeta(tuple(shape), torch.float32))
            .local_shape((0,))
            for path, shape in _flatten(param_shapes(LlamaConfig(**RUNGS["1.3b"][0]))).items()]


def moe_expert_leaf_shapes():
    """The moe rung's bf16 expert leaves (8 layers x w_in, b_in, w_out,
    b_out, w_gate): the bf16 group K8 steps on that path."""
    from vescale_tpu_torch.bench import moe_config
    from vescale_tpu_torch.models import param_shapes
    from vescale_tpu_torch.models.convert import _flatten

    return [shape for path, shape in _flatten(param_shapes(moe_config("moe"))).items()
            if path.rsplit(".", 1)[-1] in EXPERT_LEAF_NAMES]


def adamw_leaves(dev, shapes, state_dtype, seed, grad_dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    gs = [torch.randn(s, generator=g, device=dev).to(grad_dtype) for s in shapes]
    ms = [torch.randn(s, generator=g, device=dev).mul_(0.1).to(state_dtype) for s in shapes]
    vs = [torch.randn(s, generator=g, device=dev).square_().mul_(0.01).to(state_dtype)
          for s in shapes]
    return gs, ms, vs


def run_adamw_parity(dev, only_moe=False):
    """Over the 1.3B leaf set, bf16 and fp32 state, and the moe rung's
    expert leaves with bf16 grads and bf16 state (``only_moe``: that case
    alone, timed): moments bit for bit
    against the plain chain (and the in-place launch, moments written
    over their inputs, bitwise the out-of-place one), u within 4 ulps per
    element (the JAX package's bound, docs/kernels.md: c1/c2 are the same
    fp32 scalars here, so the two should agree exactly); then tiny, odd and zero-size
    leaves; then a NaN in one g, which must poison u, m' and v' at that
    element only.  Times of the bf16-state case."""
    from vescale_tpu_torch.kernels.fused_adamw import fused_adamw_reference, fused_adamw_update
    from vescale_tpu_torch.parallel.optimizer import bias_corrections

    hp = dict(b1=0.9, b2=0.999, eps=1e-8)
    c1, c2 = bias_corrections(0.9, 0.999, 5)
    shapes = train_leaf_shapes()
    out, timing = [], None
    cases = [("1.3b leaves, bf16 state", shapes, torch.bfloat16),
             ("1.3b leaves, fp32 state", shapes, torch.float32),
             ("tp2 1.3b leaves (one rank's pieces), bf16 state", tp2_leaf_shapes(),
              torch.bfloat16),
             ("odd and empty leaves, bf16 state", [(0,), (1,), (37,), (1023,), (4097,), (3, 0)],
              torch.bfloat16)]
    moe_case = ("moe rung expert leaves, bf16 grads, bf16 state", moe_expert_leaf_shapes(),
                torch.bfloat16)
    cases = [moe_case] if only_moe else cases + [moe_case]
    for label, leaf_shapes, state_dtype in cases:
        moe = label.startswith("moe")
        gs, ms, vs = adamw_leaves(dev, leaf_shapes, state_dtype, seed=len(leaf_shapes),
                                  grad_dtype=torch.bfloat16 if moe else torch.float32)
        us, mos, vos = fused_adamw_update(gs, ms, vs, c1, c2, **hp)
        # the train path's form: m' and v' written over m and v
        mi, vi = [m.clone() for m in ms], [v.clone() for v in vs]
        ui, _, _ = fused_adamw_update(gs, mi, vi, c1, c2, inplace=True, **hp)
        inplace_equal = all(bits_equal(a, b) for a, b in zip(ui + mi + vi, us + mos + vos))
        del ui, mi, vi
        worst_u, moments_equal, err = 0.0, True, 0.0
        for i in range(len(gs)):
            ru, rm, rv = fused_adamw_reference([gs[i]], [ms[i]], [vs[i]], c1, c2, **hp)
            moments_equal &= bits_equal(mos[i], rm[0]) and bits_equal(vos[i], rv[0])
            if gs[i].numel():
                worst_u = max(worst_u, ulps_elementwise(us[i], ru[0]))
                err = max(err, float((us[i] - ru[0]).abs().max()))
        out.append(dict(kernel="fused_adamw", case=label, leaves=len(gs),
                        elements=sum(g.numel() for g in gs), moments_bitwise=moments_equal,
                        inplace_bitwise=inplace_equal, u_ulps=worst_u, u_bound=4.0,
                        max_abs_err=err, ok=moments_equal and inplace_equal and worst_u <= 4.0))
        if moe:
            timing = timing if timing is not None else {}
            timing["moe_experts"] = adamw_timing(gs, ms, vs, c1, c2, hp, err)
        elif state_dtype == torch.bfloat16 and timing is None:
            timing = adamw_timing(gs, ms, vs, c1, c2, hp, err)
        elif label.startswith("tp2"):
            timing["tp2_1.3b"] = adamw_timing(gs, ms, vs, c1, c2, hp, err)
        del gs, ms, vs, us, mos, vos
        free_memory()
    if only_moe:
        return out, timing
    # NaN poison
    gs, ms, vs = adamw_leaves(dev, [(37,), (100,)], torch.bfloat16, seed=3)
    gs[0][5] = float("nan")
    us, mos, vos = fused_adamw_update(gs, ms, vs, 0.5, 0.1, **hp)
    nan_at = [[torch.nonzero(torch.isnan(t.float())).flatten().tolist() for t in outs]
              for outs in (us, mos, vos)]
    ok = all(at == [[5], []] for at in nan_at)
    out.append(dict(kernel="fused_adamw", case="NaN in g[0][5]", nan_at=nan_at, ok=ok))
    return out, timing


def adamw_timing(gs, ms, vs, c1, c2, hp, err):
    from vescale_tpu_torch.kernels.fused_adamw import (fused_adamw_cost, fused_adamw_reference,
                                                       fused_adamw_update)

    # a call's host side (its leaf table, 3 outputs a leaf) can take longer
    # than a 3 ms launch over 219 pieces on a slow host: queue all ten
    # behind a longer wait (2^28 cycles, ~140 ms)
    ms_k = cuda_ms(lambda: fused_adamw_update(gs, ms, vs, c1, c2, **hp), iters=10,
                   sleep_cycles=1 << 28)
    plain_ms = cuda_ms(lambda: fused_adamw_reference(gs, ms, vs, c1, c2, **hp), iters=3, warmup=1)
    n = sum(g.numel() for g in gs)
    # the kernel's own count: g, u; m, v, m', v'; 12 fp32 operations an element
    flops, nbytes = fused_adamw_cost(gs, ms)
    return dict(ms=ms_k, plain_ms=plain_ms, library_ms=None, max_abs_err=err,
                **bound(nbytes, flops, torch.float32),
                shape=dict(leaves=len(gs), elements=n, grad=str(gs[0].dtype), state=str(ms[0].dtype)),
                library_note="none: no single PyTorch call computes AdamW with bf16 moments")


def flash_timing(dev, parity_rows):
    """The bf16 forward at the Llama-3-8B prefill shape (the row's own
    fields), the 1.3B train shape (under ``train_1.3b``) and the GPT-2 train
    shape (under ``gpt2``): the kernel, its plain version (the bf16-P
    model), and the library yardstick, ``scaled_dot_product_attention``'s
    forward with the GQA heads expanded; ``over_library`` = ms / library
    ms.  ``max_abs_err`` is the parity case's at that shape."""
    import torch.nn.functional as F

    from vescale_tpu_torch.kernels.flash_attention import (flash_fwd, flash_fwd_cost,
                                                           flash_fwd_reference)

    by_label = {case[0]: case for case in flash_cases()}
    errs = {row["case"]: row["max_abs_err"] for row in parity_rows if row["kernel"] == "flash_fwd"}
    out = {}
    for label, key in (("main bf16", None), ("train 1.3b bf16", "train_1.3b"), ("gpt2 bf16", "gpt2"),
                       ("tp2 1.3b bf16", "tp2_1.3b"), ("tp2 8b prefill bf16", "tp2_8b_prefill"),
                       ("tp2 gpt2 bf16", "tp2_gpt2"), ("moe rung bf16 (GQA 3)", "moe"),
                       ("mixtral 8x7b bf16", "mixtral_8x7b")):
        _, B, T, H, KV, D, causal, dtype, _, _ = by_label[label]
        q, k, v, args = flash_fwd_inputs(dev, B, T, H, KV, D, causal, dtype)
        ms = cuda_ms(lambda: flash_fwd(q, k, v, **args))
        plain_ms = cuda_ms(
            lambda: flash_fwd_reference(q, k, v, pd_dtype=torch.bfloat16, **args), iters=3, warmup=1)
        rep = H // KV
        q4 = q.reshape(B, H, T, D)
        k4 = k.reshape(B, KV, T, D).repeat_interleave(rep, dim=1)
        v4 = v.reshape(B, KV, T, D).repeat_interleave(rep, dim=1)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal))
        flops, nbytes = flash_fwd_cost(q, k, v, **args)  # the kernel's own count
        fields = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                      over_library=ms / library_ms, max_abs_err=errs[label],
                      **bound(nbytes, flops, dtype),
                      shape=dict(B=B, T=T, H=H, KV=KV, D=D, dtype=str(dtype), causal=causal))
        fields["share_of_bound"] = fields["bound_ms"] / ms
        if key is None:
            out.update(fields)
        else:
            out[key] = fields
        del q, k, v, q4, k4, v4
        free_memory()
    return out


def paged_timing(dev, parity_rows):
    """K7 in bf16 at shapes A, B and C (``paged_geometries``): ms, the plain
    version's ms, the bytes bound and its share.  B and C reference more K/V
    than the 50 MB L2 holds, so back-to-back calls read device memory.  A
    references 10.7 MB, which stays in L2 over back-to-back calls on one
    pool (``ms_l2_warm``, the number earlier runs reported); in serve each
    layer reads its own pool, so A's ``ms`` cycles over 8 distinct pool
    pairs (86 MB referenced) between calls.  The row's own fields are A's
    (rotated); B and C go under their names."""
    from vescale_tpu_torch.kernels.paged_attention import (paged_decode, paged_decode_cost,
                                                           paged_decode_reference)

    errs = {row["case"]: row["max_abs_err"] for row in parity_rows if "max_abs_err" in row}
    out = {}
    for name, geo in paged_geometries().items():
        sets = [paged_inputs(dev, torch.bfloat16, torch.bfloat16, **geo, seed=i)
                for i in range(8 if name == "A" else 1)]
        q, kp, vp, table, lengths = sets[0]
        scale = 1.0 / geo["hd"] ** 0.5
        warm = cuda_ms(lambda: paged_decode(q, kp, vp, table, lengths, scale=scale), iters=48)
        turn = iter(range(1 << 30))
        ms = cuda_ms(lambda: paged_decode(*sets[next(turn) % len(sets)], scale=scale), iters=48)
        plain_ms = cuda_ms(lambda: paged_decode_reference(q, kp, vp, table, lengths, scale=scale),
                           iters=5, warmup=1)
        S, H, hd = q.shape
        KV = kp.shape[2]
        tokens = int(lengths.sum())
        # the kernel's own count over this run's lengths: the K/V rows the
        # slots hold, read once; q, table, lengths; fp32 out
        flops, nbytes = paged_decode_cost(q, kp, vp, table, lengths)
        fields = dict(ms=ms, ms_l2_warm=warm, plain_ms=plain_ms, library_ms=None,
                      max_abs_err=errs[f"{name} bf16"], **bound(nbytes, flops, kp.dtype),
                      pools_cycled=len(sets), referenced_bytes_cycled=len(sets) * 2 * tokens * KV * hd * 2,
                      shape=dict(S=S, H=H, KV=KV, hd=hd, page=kp.shape[1], Pmax=table.shape[1],
                                 tokens=tokens, dtype=str(kp.dtype)))
        fields["share_of_bound"] = fields["bound_ms"] / ms
        fields["share_of_bound_l2_warm"] = fields["bound_ms"] / warm
        if name == "A":
            out.update(fields)
        else:
            out[name] = fields
        del sets, q, kp, vp, table, lengths
        free_memory()
    out["library_note"] = "none: no one PyTorch call reads a paged pool"
    return out


def bound(nbytes: float, flops: float, dtype) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)


# ---------------------------------------------------------- cross entropy
XENT_PATH = (12 * 1024, 50304)  # the GPT-2 train path's logits: B*T rows, vocab 50304
# one rank's vocab slice at tp = 2: the 1.3B, the 8B's vocab, GPT-2
XENT_TP_PATHS = (("1.3b", 4096, 16000), ("8b", 4096, 64128), ("gpt2", 12 * 1024, 25152))
# the pipeline's GPT-2 microbatch: 3 of the rung's 12 rows (the Llama's
# loss is the plain fp32 logsumexp, which launches neither kernel)
XENT_PP_PATH = (3 * 1024, 50304)


def xent_cases():
    """(label, N, Vs): the GPT-2 path's shape, the 1.3B Llama's, the
    Llama-3 vocab (2.1 GB of fp32 logits) and odd shapes, each in fp32 and
    in bf16 (the path's dtype: the kernels read bf16 logits directly); a
    rank's vocab slice at tp = 2 and the pipeline's GPT-2 microbatch, in
    bf16.

    Bounds.  picked: exact.  sumexp and sumlg: against the plain version
    run in float64 on the same inputs (upcast exactly), within 8 ulps at
    scale (the JAX package's bound) or no further than the fp32 plain
    version is (``plain_fp32_ulps``): a row of 50k-128k terms is a long
    fp32 sum, and the fp32 plain version is no arbiter for it.  dlg, fp32:
    8 ulps at scale against the fp32 plain version, which runs the same
    operations in the same order (only ``expf`` may differ in its last
    bit).  dlg, bf16: bitwise equal to the fp32 kernel's dlg on the
    upcast logits, rounded to bf16 (the kernel rounds that same fp32 value
    once).  Two launches of each kernel on the same inputs: bitwise
    equal."""
    shapes = [("gpt2 path", *XENT_PATH), ("llama 1.3b", 4096, 32000),
              ("llama-3 vocab", 4096, 128256), ("odd 1000x7", 1000, 7), ("odd 3x1", 3, 1)]
    return [(f"{label} {str(dt)[6:]}", N, Vs, dt) for label, N, Vs in shapes
            for dt in (torch.float32, torch.bfloat16)] + [
        # one rank's vocab slice at tp = 2, in the paths' dtype
        (f"tp2 {label} bfloat16", N, Vs, torch.bfloat16) for label, N, Vs in XENT_TP_PATHS] + [
        ("pp gpt2 micro bfloat16", *XENT_PP_PATH, torch.bfloat16)]


def ulps_dev(a, b) -> float:
    """``kernels.ulps_at_scale`` of two tensors (or arrays), computed where
    they lie, in float64: NaN and signed-Inf patterns must agree (else inf), then max
    |a - b| over the finite pairs divided by the fp32 spacing at b's largest
    finite magnitude.  The same number as the numpy metric, without copying
    a 2 GB logits gradient to the host."""
    a64 = torch.as_tensor(a).detach().reshape(-1).double()
    b64 = torch.as_tensor(b).detach().reshape(-1).double().to(a64.device)
    for pattern in (torch.isnan, torch.isposinf, torch.isneginf):
        if not torch.equal(pattern(a64), pattern(b64)):
            return float("inf")
    fin = torch.isfinite(a64) & torch.isfinite(b64)
    if not bool(fin.any()):
        return 0.0
    a64, b64 = a64[fin], b64[fin]
    step = float(np.spacing(np.float32(float(b64.abs().max()) or 1.0)))
    return float((a64 - b64).abs().max()) / step


def xent_inputs(dev, N, Vs, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    lg = (3.0 * torch.randn(N, Vs, generator=g, device=dev)).to(dtype)
    idx = torch.randint(0, Vs, (N,), generator=g, device=dev)
    gmax = torch.amax(lg, dim=-1).float()
    cts = [torch.randn(N, generator=g, device=dev) for _ in range(3)]
    return lg, idx, gmax, cts


def run_xent_parity(dev):
    from vescale_tpu_torch.kernels.cross_entropy import (
        xent_bwd, xent_bwd_reference, xent_fwd, xent_parts_reference,
    )

    out = []
    for label, N, Vs, dtype in xent_cases():
        lg, idx, gmax, cts = xent_inputs(dev, N, Vs, dtype, seed=N + Vs)
        got, again = xent_fwd(lg, idx, gmax), xent_fwd(lg, idx, gmax)
        plain = xent_parts_reference(lg, idx, gmax)
        exact = xent_parts_reference(lg.double(), idx, gmax.double())
        torch.cuda.synchronize()
        row = dict(kernel="fused_xent", case=label, N=N, Vs=Vs, dtype=str(dtype), bound=8.0,
                   fwd_bitwise_repeat=all(bits_equal(a, b) for a, b in zip(got, again)),
                   picked_exact=bits_equal(got[1], plain[1]))
        for i, name in ((0, "sumexp"), (2, "sumlg")):
            row[f"{name}_ulps"] = ulps_dev(got[i], exact[i])
            row[f"{name}_plain_fp32_ulps"] = ulps_dev(plain[i], exact[i])
        del plain, exact, again
        dlg, dlg2 = xent_bwd(lg, idx, gmax, *cts), xent_bwd(lg, idx, gmax, *cts)
        row["bwd_bitwise_repeat"] = bits_equal(dlg, dlg2)
        del dlg2
        if dtype == torch.float32:
            ref = xent_bwd_reference(lg, idx, gmax, *cts)
            row["dlg_ulps"] = ulps_dev(dlg, ref)
            row["max_abs_err"] = float((dlg - ref).abs().max())
        else:
            ref = xent_bwd(lg.float(), idx, gmax, *cts).to(torch.bfloat16)
            row["dlg_bitwise_fp32_kernel_rounded"] = bits_equal(dlg, ref)
            row["max_abs_err"] = float((dlg.float() - xent_bwd_reference(lg, idx, gmax, *cts).float())
                                       .abs().max())
        row["ok"] = (row["fwd_bitwise_repeat"] and row["picked_exact"] and row["bwd_bitwise_repeat"]
                     and all(row[f"{n}_ulps"] <= max(8.0, row[f"{n}_plain_fp32_ulps"])
                             for n in ("sumexp", "sumlg"))
                     and row.get("dlg_ulps", 0.0) <= 8.0
                     and row.get("dlg_bitwise_fp32_kernel_rounded", True))
        out.append(row)
        del lg, idx, gmax, cts, got, dlg, ref
        free_memory()
    return out, xent_timing(dev)


def xent_timing(dev):
    """K9 and K10 at the GPT-2 path's shape, in bf16 (the path's dtype: the
    model's logits) and in fp32.  Library yardsticks on the same logits:
    ``F.cross_entropy`` forward (K9) and its backward alone, from a
    retained graph (K10), plus forward and backward together and
    ``torch.logsumexp`` (the forward's sumexp part)."""
    import torch.nn.functional as F

    from vescale_tpu_torch.kernels.cross_entropy import (
        xent_bwd, xent_bwd_cost, xent_bwd_reference, xent_fwd, xent_fwd_cost,
        xent_parts_reference,
    )

    N, Vs = XENT_PATH
    rows = {"fused_xent_fwd": {}, "fused_xent_bwd": {}}
    for dtype in (torch.bfloat16, torch.float32):
        lg, idx, gmax, cts = xent_inputs(dev, N, Vs, dtype, seed=1)
        sfx = "" if dtype == torch.bfloat16 else "_fp32"
        fwd_ms = cuda_ms(lambda: xent_fwd(lg, idx, gmax), iters=10)
        bwd_ms = cuda_ms(lambda: xent_bwd(lg, idx, gmax, *cts), iters=10)
        fwd_plain = cuda_ms(lambda: xent_parts_reference(lg, idx, gmax), iters=3, warmup=1)
        bwd_plain = cuda_ms(lambda: xent_bwd_reference(lg, idx, gmax, *cts), iters=3, warmup=1)
        lib_fwd = cuda_ms(lambda: F.cross_entropy(lg, idx), iters=10)
        x = lg.detach().requires_grad_()
        loss = F.cross_entropy(x, idx)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(loss, x, retain_graph=True), iters=10)
        lib_both = cuda_ms(lambda: torch.autograd.grad(F.cross_entropy(x, idx), x), iters=10)
        lse_ms = cuda_ms(lambda: torch.logsumexp(lg, dim=-1), iters=10)
        err_f = max(float((a - b).abs().max()) for a, b in zip(xent_fwd(lg, idx, gmax),
                                                              xent_parts_reference(lg, idx, gmax)))
        err_b = float((xent_bwd(lg, idx, gmax, *cts).float()
                       - xent_bwd_reference(lg, idx, gmax, *cts).float()).abs().max())
        # the kernels' own counts: fp32 operations on the CUDA cores
        f_flops, f_bytes = xent_fwd_cost(lg, idx, gmax)
        b_flops, b_bytes = xent_bwd_cost(lg, idx, gmax, *cts)
        fwd_b = bound(f_bytes, f_flops, torch.float32)
        bwd_b = bound(b_bytes, b_flops, torch.float32)
        shape = dict(N=N, Vs=Vs, dtype=str(dtype))
        rows["fused_xent_fwd"].update({
            f"ms{sfx}": fwd_ms, f"plain_ms{sfx}": fwd_plain, f"library_ms{sfx}": lib_fwd,
            f"logsumexp_ms{sfx}": lse_ms, f"max_abs_err{sfx}": err_f,
            **{f"{k}{sfx}": v for k, v in fwd_b.items()}, f"shape{sfx}": shape})
        rows["fused_xent_bwd"].update({
            f"ms{sfx}": bwd_ms, f"plain_ms{sfx}": bwd_plain, f"library_ms{sfx}": lib_bwd,
            f"library_fwd_bwd_ms{sfx}": lib_both, f"max_abs_err{sfx}": err_b,
            **{f"{k}{sfx}": v for k, v in bwd_b.items()}, f"shape{sfx}": shape})
        del lg, idx, gmax, cts, x, loss
        free_memory()
    for label, N, Vs in XENT_TP_PATHS:
        lg, idx, gmax, cts = xent_inputs(dev, N, Vs, torch.bfloat16, seed=2)
        x = lg.detach().requires_grad_()
        loss = F.cross_entropy(x, idx)
        for name, fn, plain, lib, (ops, nb) in (
                ("fused_xent_fwd", lambda: xent_fwd(lg, idx, gmax),
                 lambda: xent_parts_reference(lg, idx, gmax), lambda: F.cross_entropy(lg, idx),
                 xent_fwd_cost(lg, idx, gmax)),
                ("fused_xent_bwd", lambda: xent_bwd(lg, idx, gmax, *cts),
                 lambda: xent_bwd_reference(lg, idx, gmax, *cts),
                 lambda: torch.autograd.grad(loss, x, retain_graph=True),
                 xent_bwd_cost(lg, idx, gmax, *cts))):
            rows[name][f"tp2_{label}"] = dict(
                ms=cuda_ms(fn, iters=10), plain_ms=cuda_ms(plain, iters=3, warmup=1),
                library_ms=cuda_ms(lib, iters=10), **bound(nb, ops, torch.float32),
                shape=dict(N=N, Vs=Vs, dtype="torch.bfloat16"))
        del lg, idx, gmax, cts, x, loss
        free_memory()
    for r in rows.values():
        r["library_note"] = ("F.cross_entropy on the same logits (K9: forward; K10: its "
                             "backward from a retained graph)")
    return rows


# ------------------------------------------------------------------ engine
def run_small_engine(dev, ulps):
    """2-layer fp32 engine on the card and on the CPU, same weights."""
    from vescale_tpu_torch.models import LlamaConfig, init_params, tree_to
    from vescale_tpu_torch.serve import KVCacheConfig, PagedKVCache, ServeEngine

    check(torch.backends.cuda.matmul.allow_tf32 is False, "fp32 matmuls must not run in TF32")
    cfg = LlamaConfig(vocab_size=1024, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
                      num_attention_heads=8, num_key_value_heads=4, max_position_embeddings=256,
                      dtype=torch.float32)
    params = init_params(cfg, seed=1, device="cpu")
    engines = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        kc = KVCacheConfig(layers=2, kv_heads=4, head_dim=cfg.head_dim, num_slots=4, page_size=16,
                           pages_per_slot=8)
        cache = PagedKVCache(kc, device=device)
        engines[where] = ServeEngine(cfg, tree_to(params, device), cache, device=device)
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)] for n in (5, 16, 33, 60)]
    # fp32 on both sides; cuBLAS and the CPU's BLAS sum the width-512 GEMMs
    # in other orders and the kernels sum attention in theirs: a few ulps
    # per op, compounded through two layers of residual stream
    bound_ulps = 128.0
    worst = 0.0
    streams = {}
    for where, eng in engines.items():
        streams[where] = [eng.replay_greedy(p, 16) for p in prompts]
    for p in prompts:
        rows = []
        for eng in engines.values():
            slot = eng.cache.alloc(len(p), 1)
            rows.append(eng.prefill(p, slot))
            eng.cache.free(slot)
        check(rows[0].shape == (cfg.vocab_size,) and np.isfinite(rows[0]).all(), "card logits")
        worst = max(worst, ulps(rows[0], rows[1]))
    check(worst <= bound_ulps, f"card vs CPU prefill logits {worst} ulps > {bound_ulps}")
    check(streams["card"] == streams["cpu"], f"greedy streams differ: {streams}")
    return dict(prompts=len(prompts), logits_ulps=worst, logits_bound=bound_ulps,
                streams_equal=True, streams=streams["card"])


def run_engine_spec(dev):
    """The ``engine`` phase's 2-layer fp32 model over requests that share a
    48-token prefix (3 pages), on the card and on the CPU: plain decode, the
    prefix cache, and the prefix cache with a 1-layer drafter at k = 1 and
    4.  Greedy acceptance emits the target's own argmaxes and the suffix
    prefill writes the same K/V a full prefill would, to fp32 rounding, so
    every stream must equal the CPU plain run's exactly."""
    from vescale_tpu_torch.models import LlamaConfig, init_params, tree_to
    from vescale_tpu_torch.serve import (
        ContinuousBatchingScheduler, KVCacheConfig, PagedKVCache, PrefixCache, Request,
        ServeEngine, SpeculativeDecoder, run_serve, slice_drafter_params,
    )

    cfg = LlamaConfig(vocab_size=1024, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
                      num_attention_heads=8, num_key_value_heads=4, max_position_embeddings=256,
                      dtype=torch.float32)
    params = init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(9)
    system = tuple(int(t) for t in rng.integers(1, cfg.vocab_size, 48))
    arrivals = [(i // 2, Request(rid=i, max_new_tokens=12, prompt=system + tuple(
        int(t) for t in rng.integers(1, cfg.vocab_size, int(rng.integers(1, 41))))))
        for i in range(8)]
    variants = {"plain": (False, None), "prefix": (True, None),
                "prefix_spec_k1": (True, 1), "prefix_spec_k4": (True, 4)}
    streams, stats = {}, {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        tree = tree_to(params, device)
        for name, (prefix, k) in variants.items():
            kc = KVCacheConfig(layers=2, kv_heads=4, head_dim=cfg.head_dim, num_slots=4,
                               page_size=16, pages_per_slot=8)
            cache = PagedKVCache(kc, device=device)
            eng = ServeEngine(cfg, tree, cache, device=device)
            pc = PrefixCache(cache) if prefix else None
            sched = ContinuousBatchingScheduler(cache, prefix_cache=pc)
            spec = (SpeculativeDecoder(eng, slice_drafter_params(eng.params, 1), drafter_layers=1,
                                       k=k) if k else None)
            res = run_serve(eng, sched, arrivals, speculative=spec)
            sched.ledger_check()
            check(all(o["status"] == "completed" for o in res.outcomes.values()),
                  f"engine_spec {where} {name}: not every request completed")
            streams[where, name] = {rid: o["tokens"] for rid, o in res.outcomes.items()}
            stats[f"{where} {name}"] = dict(
                prefix_hit_tokens=pc.stats.hit_tokens if pc else None,
                drafted=spec.drafted if spec else None, accepted=spec.accepted if spec else None,
                verify_steps=spec.verify_steps if spec else None)
    golden = streams["cpu", "plain"]
    equal = {f"{w} {n}": s == golden for (w, n), s in streams.items()}
    check(all(equal.values()), f"engine_spec streams differ: {equal}")
    check(all(stats[f"{w} prefix"]["prefix_hit_tokens"] > 0 for w in ("card", "cpu"))
          and all(stats[f"{w} prefix_spec_k{k}"]["drafted"] > 0 for w in ("card", "cpu") for k in (1, 4)),
          f"engine_spec: the prefix cache never hit or nothing was drafted: {stats}")
    return dict(requests=len(arrivals), streams_equal=equal, stats=stats)


# ------------------------------------------------------------------- train
def run_train_small(dev):
    """The bench's CPU config, widened so head_dim is 64 (a width the
    kernels take): a 2-layer fp32 Llama, hidden 256, FFN 512, 4 heads, 2 KV
    heads, B=2, T=128, trained 3 steps with ``AdamWLowmem(3e-4)`` (bf16
    moments) on the card (kernels, cuBLAS) and on the CPU (plain versions)
    from the same ``init_params(device="cpu")`` weights and batch.

    Bounds: step 1 is the forward on equal weights, fp32 on both sides with
    sums in other orders: 1e-5 relative.  Later steps: 1e-3 absolute (on a
    loss of ~6.2), as where a grad is near zero the last-bit differences
    can flip the sign of Adam's normalised update and move that element by
    up to 2 * lr = 6e-4 a step."""
    from vescale_tpu_torch.models import Llama, LlamaConfig, cross_entropy_loss, init_params
    from vescale_tpu_torch.parallel import AdamWLowmem
    from vescale_tpu_torch.train import make_train_step

    check(torch.backends.cuda.matmul.allow_tf32 is False, "fp32 matmuls must not run in TF32")
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                      dtype=torch.float32)
    params = init_params(cfg, seed=1, device="cpu", dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 129)))
    losses = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = Llama(cfg, params, device=device)
        opt = AdamWLowmem(model.parameters(), 3e-4)
        step = make_train_step(model, opt, lambda lg, b: cross_entropy_loss(lg, b["target"]))
        t = toks.to(device)
        batch = {"input": t[:, :-1], "target": t[:, 1:]}
        losses[where] = [float(step(batch)) for _ in range(3)]
    diffs = [abs(a - b) for a, b in zip(losses["card"], losses["cpu"])]
    bounds = [1e-5 * abs(losses["cpu"][0]), 1e-3, 1e-3]
    out = dict(losses=losses, abs_diffs=diffs, bounds=bounds,
               ok=all(d <= b for d, b in zip(diffs, bounds)) and all(np.isfinite(losses["card"])))
    check(out["ok"], f"card vs CPU training: {out}")
    return out


def kernel_kind(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in name:  # tc:: (bf16, wgmma) and simt:: (fp32)
        return "flash_fwd"
    if "dq::kernel" in name or "dkv::kernel" in name:
        return "flash_bwd"
    if "adamw_kernel" in name:
        return "fused_adamw"
    if "xent_fwd_kernel" in name or "xent_bwd_kernel" in name:
        return "fused_xent"
    if "paged_decode_kernel" in name:
        return "paged_decode"
    if any(x in low for x in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul"
    return "other"


def device_time_by_kind(fn, named=()):
    """Run ``fn`` once under ``torch.profiler`` (CUDA activity only):
    device ms by kernel kind, device launches and the top kernels; with
    ``named``, also the device ms of the kernels whose names hold each of
    those strings (``named_ms``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind = {k: 0.0 for k in ("matmul", "flash_fwd", "flash_bwd", "fused_adamw", "fused_xent",
                                "paged_decode", "other")}
    top, launches = [], 0
    named_ms = {x: 0.0 for x in named}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", DeviceType.CUDA) != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if not dev_us:
            continue
        by_kind[kernel_kind(evt.key)] += dev_us / 1e3
        for x in named:
            if x in evt.key:
                named_ms[x] += dev_us / 1e3
        launches += evt.count
        top.append((dev_us / 1e3, evt.count, evt.key[:80]))
    busy = sum(by_kind.values())
    check(busy > 0, "the profiler saw no device time")
    top.sort(reverse=True)
    out = dict(device_busy_ms=busy, traced_wall_ms=wall_ms, device_launches=launches,
               device_ms_by_kind=by_kind, top_kernels=[[n, c, t] for t, c, n in top[:10]])
    if named:
        out["named_ms"] = named_ms
    return out


def run_train_13b(dev, kernels_mod):
    """The 1.3B train rung of ``vescale_tpu_torch.bench`` at full width."""
    from vescale_tpu_torch.bench import measure, prepare

    t0 = time.perf_counter()
    run = prepare("1.3b", device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    L = run.config.num_hidden_layers
    kernels_mod.reset_launches()
    res = measure(run)
    launches = dict(kernels_mod.LAUNCHES)
    timed = res["losses"][res["warmup_steps"]:]
    want = {**{k: 0 for k in kernels_mod.LAUNCHES}, "flash_fwd": L, "flash_bwd_dq": L,
            "flash_bwd_dkv": L, "fused_adamw": 1}
    checks = {
        "losses_finite": bool(np.isfinite(res["losses"]).all()),
        "loss_falls": timed[-1] < timed[0],
        "launches_per_step": all(step == want for step in res["launches_per_step"]),
        "leaves": len(list(run.model.parameters())) == 9 * L + 3,
    }
    prof = device_time_by_kind(lambda: run.step(run.next_batch()))
    busy = prof["device_busy_ms"]
    prof["device_idle_share"] = max(0.0, 1.0 - busy / res["step_ms_median"])
    prof["traced_idle_share"] = max(0.0, 1.0 - busy / prof["traced_wall_ms"])
    out = dict(model="llama 1.3B (bench rung 1.3b)", weights="random fp32 masters, seed 0",
               setup_s=setup_s, launches=launches, checks=checks, profile=prof,
               mfu_formula="(6 * params + 12 * layers * T * hidden) * tokens/s / peak",
               **{k: v for k, v in res.items() if k != "launches_per_step"},
               launches_first_step=res["launches_per_step"][0])
    check(all(checks.values()), f"train checks failed: {out}")
    del run
    free_memory()
    return out


def run_gpt_small(dev):
    """A 2-layer fp32 GPT (vocab 512, block 128, 4 heads, width 256, so
    head_dim 64) trained 3 steps with ``AdamWLowmem(3e-4)`` (bf16 moments)
    through ``vocab_parallel_cross_entropy`` on the card (kernels, cuBLAS)
    and on the CPU (plain versions) from the same
    ``init_params(device="cpu")`` weights and numpy batch.  Bounds as
    ``run_train_small``'s: 1e-5 relative at step 1, 1e-3 absolute after."""
    from vescale_tpu_torch.loss import vocab_parallel_cross_entropy
    from vescale_tpu_torch.models import GPT, GPTConfig, init_params
    from vescale_tpu_torch.parallel import AdamWLowmem
    from vescale_tpu_torch.train import make_train_step

    check(torch.backends.cuda.matmul.allow_tf32 is False, "fp32 matmuls must not run in TF32")
    cfg = GPTConfig(block_size=128, vocab_size=512, n_layer=2, n_head=4, n_embd=256,
                    use_flash_attention=True, dtype=torch.float32)
    params = init_params(cfg, seed=1, device="cpu", dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 129)))
    losses = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = GPT(cfg, params, device=device)
        opt = AdamWLowmem(model.parameters(), 3e-4)
        step = make_train_step(model, opt,
                               lambda lg, b: vocab_parallel_cross_entropy(lg, b["target"]))
        t = toks.to(device)
        batch = {"input": t[:, :-1], "target": t[:, 1:]}
        losses[where] = [float(step(batch)) for _ in range(3)]
    diffs = [abs(a - b) for a, b in zip(losses["card"], losses["cpu"])]
    bounds = [1e-5 * abs(losses["cpu"][0]), 1e-3, 1e-3]
    out = dict(losses=losses, abs_diffs=diffs, bounds=bounds,
               ok=all(d <= b for d, b in zip(diffs, bounds)) and all(np.isfinite(losses["card"])))
    check(out["ok"], f"card vs CPU GPT training: {out}")
    return out


def run_train_gpt2(dev, kernels_mod):
    """The gpt2 rung of ``vescale_tpu_torch.bench``: GPT-2 124M at its
    published width, B=12, T=1024, batches from ``TokenDataLoader`` over a
    numpy-seeded token file the bench writes into a temporary directory."""
    from vescale_tpu_torch.bench import measure, prepare

    t0 = time.perf_counter()
    run = prepare("gpt2", device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    try:
        L = run.config.n_layer
        kernels_mod.reset_launches()
        res = measure(run)
        launches = dict(kernels_mod.LAUNCHES)
        timed = res["losses"][res["warmup_steps"]:]
        want = {**{k: 0 for k in kernels_mod.LAUNCHES}, "flash_fwd": L, "flash_bwd_dq": L,
                "flash_bwd_dkv": L, "fused_xent_fwd": 1, "fused_xent_bwd": 1, "fused_adamw": 1}
        checks = {
            "losses_finite": bool(np.isfinite(res["losses"]).all()),
            "loss_falls": timed[-1] < timed[0],
            "launches_per_step": all(step == want for step in res["launches_per_step"]),
            "leaves": len(list(run.model.parameters())) == 12 * L + 4,
            "params": run.n_params == 124_475_904,
        }
        prof = device_time_by_kind(lambda: run.step(run.next_batch()))
        busy = prof["device_busy_ms"]
        prof["device_idle_share"] = max(0.0, 1.0 - busy / res["step_ms_median"])
        prof["traced_idle_share"] = max(0.0, 1.0 - busy / prof["traced_wall_ms"])
        out = dict(model="GPT-2 124M (bench rung gpt2)", weights="random fp32 masters, seed 0",
                   data="TokenDataLoader over 2^22 Zipf(1.2) uint16 tokens, numpy seed 0",
                   setup_s=setup_s, launches=launches, checks=checks, profile=prof,
                   mfu_formula="(6 * params + 12 * layers * T * hidden) * tokens/s / peak",
                   **{k: v for k, v in res.items() if k != "launches_per_step"},
                   launches_first_step=res["launches_per_step"][0])
        check(all(checks.values()), f"gpt2 train checks failed: {out}")
    finally:
        run.close()
    del run
    free_memory()
    return out


# ------------------------------------------------------------------- serve
def serve_requests(vocab: int, n: int = 16, seed: int = 0):
    from vescale_tpu_torch.serve import Request

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = tuple(int(t) for t in rng.integers(1, vocab, int(rng.integers(32, 513))))
        out.append((i // 2, Request(rid=i, prompt=prompt, max_new_tokens=32)))
    return out


def eager_engine(eng):
    """A smoke-local engine over ``eng``'s weights and cache whose decode is
    the eager step, op by op: the baseline the graphed step is held to."""
    from vescale_tpu_torch.serve import ServeEngine

    class EagerServeEngine(ServeEngine):
        def decode(self, tokens):
            return self.decode_eager(tokens)

    return EagerServeEngine(eng.config, eng.params, eng.cache, device=eng.device)


def serve_run(dev, eng, arrivals, kernels_mod, on_step=None):
    """One run of ``arrivals`` through ``eng`` from an empty cache, with the
    launch counts set to 0 just before it and read just after."""
    from vescale_tpu_torch.serve import ContinuousBatchingScheduler, run_serve

    cfg = eng.config
    eng.cache.reset()
    sched = ContinuousBatchingScheduler(eng.cache)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    # what the process holds at the reset (this engine's weights and pool,
    # and any other engine or tree a phase keeps): the run's own peak is
    # the peak above it
    held = torch.cuda.memory_allocated(dev)
    kernels_mod.reset_launches()
    t1 = time.perf_counter()
    res = run_serve(eng, sched, arrivals, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(kernels_mod.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)

    sched.ledger_check()
    prefills = int(sched.telemetry.counter("serve_prefills_total"))
    steps = int(sched.telemetry.counter("serve_decode_steps_total"))
    L = cfg.num_hidden_layers
    hist = sched.telemetry.histograms
    tokens = sum(len(o["tokens"]) for o in res.outcomes.values())
    checks = {
        "all_completed": all(o["status"] == "completed" for o in res.outcomes.values())
        and len(res.outcomes) == len(arrivals),
        "tokens_per_request": all(len(o["tokens"]) == 32 for o in res.outcomes.values()),
        "tokens_in_vocab": all(0 <= t < cfg.vocab_size for o in res.outcomes.values() for t in o["tokens"]),
        "flash_launches": launches["flash_fwd"] == L * prefills and prefills == len(arrivals),
        "paged_launches": launches["paged_decode"] == L * steps and steps > 0,
    }
    rid, req = arrivals[3][1].rid, arrivals[3][1]
    checks["replay_equal"] = eng.replay_greedy(req.prompt, req.max_new_tokens) == res.outcomes[rid]["tokens"]
    out = dict(serve_s=wall, steps=res.steps, requests=len(arrivals), prefills=prefills,
               decode_steps=steps, generated_tokens=tokens, tokens_per_s=tokens / wall,
               ttft_p50_s=sched.percentile("ttft", 0.5), ttft_p99_s=sched.percentile("ttft", 0.99),
               decode_step_p50_ms=1e3 * sched.percentile("step_time", 0.5),
               decode_step_p99_ms=1e3 * sched.percentile("step_time", 0.99),
               prefill_p50_ms=1e3 * hist["serve_ttft_prefill_seconds"].percentile(0.5),
               queue_wait_p50_s=hist["serve_ttft_queue_wait_seconds"].percentile(0.5),
               peak_memory_bytes=peak, held_at_reset_bytes=held,
               peak_above_held_bytes=peak - held, counts=res.counts, launches=launches,
               checks=checks)
    return out, {r: o["tokens"] for r, o in res.outcomes.items()}


def graph_vs_eager(eng, kernels_mod, prompts):
    """The decode step on a mixed batch (slots at several lengths, the rest
    free), graphed and eager, each from the same pools: logits and every
    page but the null page (which takes the free slots' racing writes)
    bitwise equal.  The graphed step is a replay: the graph exists before
    the call, and the call adds one captured launch per layer."""
    cache = eng.cache
    L = eng.config.num_hidden_layers
    cache.reset()
    toks = np.zeros((cache.num_slots,), np.int64)
    for p in prompts:
        slot = cache.alloc(len(p), 8)
        toks[slot] = eng.greedy(eng.prefill(p, slot))
        cache.commit_prefill(slot, len(p))
    k0, v0 = cache.k.clone(), cache.v.clone()

    def step(fn):
        cache.k.copy_(k0)
        cache.v.copy_(v0)
        logits = fn(toks)
        return logits, cache.k[:, 1:].clone(), cache.v[:, 1:].clone()

    if eng._graph is None or not eng._graph.current(cache):
        step(eng.decode)  # runs the step eagerly and captures it
    ready = eng._graph is not None and eng._graph.current(cache)
    before = kernels_mod.LAUNCHES["paged_decode"]
    graphed = step(eng.decode)
    replayed = ready and kernels_mod.LAUNCHES["paged_decode"] - before == L
    eager = step(eng.decode_eager)
    equal = (np.array_equal(graphed[0], eager[0]) and torch.equal(graphed[1], eager[1])
             and torch.equal(graphed[2], eager[2]))
    cache.k.copy_(k0)
    cache.v.copy_(v0)
    cache.reset()
    return dict(replayed=replayed, bitwise_equal=equal), graphed[0]


def run_serve_8b(dev, kernels_mod):
    from vescale_tpu_torch.models import LLAMA3_8B, init_params
    from vescale_tpu_torch.serve import KVCacheConfig, PagedKVCache, ServeEngine

    cfg = LLAMA3_8B
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    kc = KVCacheConfig(layers=cfg.num_hidden_layers, kv_heads=cfg.num_key_value_heads,
                       head_dim=cfg.head_dim, num_slots=8, page_size=16, pages_per_slot=64,
                       dtype=torch.bfloat16)
    cache = PagedKVCache(kc, device=dev)
    eng = ServeEngine(cfg, params, cache, device=dev)
    eager = eager_engine(eng)
    # warm up cuBLAS, load the kernels and capture the decode graph
    eng.replay_greedy([1, 2, 3], 2)
    eager.replay_greedy([1, 2, 3], 2)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    arrivals = serve_requests(cfg.vocab_size)
    graph_run, graph_streams = serve_run(dev, eng, arrivals, kernels_mod)
    eager_run, eager_streams = serve_run(dev, eager, arrivals, kernels_mod)

    # the graphed step against the eager one on a mixed batch, then after
    # swap_params to seed-1 weights (the graph is captured again) and back
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)] for n in (40, 333, 17, 700, 128)]
    mixed = {}
    mixed["seed0"], first = graph_vs_eager(eng, kernels_mod, prompts)
    other = init_params(cfg, seed=1, device=dev, dtype=torch.bfloat16)
    old = eng.swap_params(other)
    mixed["seed1"], swapped = graph_vs_eager(eng, kernels_mod, prompts)
    eng.swap_params(old)
    mixed["seed0_again"], back = graph_vs_eager(eng, kernels_mod, prompts)
    del other
    free_memory()
    mixed["new_weights_took_effect"] = not np.array_equal(first, swapped)
    mixed["same_as_first"] = np.array_equal(first, back)

    checks = {"graph": graph_run["checks"], "eager": eager_run["checks"],
              "streams_equal": graph_streams == eager_streams,
              "mixed_batch": all(v if isinstance(v, bool) else all(v.values()) for v in mixed.values())}
    out = dict(model="LLAMA3_8B", layers=cfg.num_hidden_layers, weights="random bf16, seed 0",
               setup_s=setup_s, graph=graph_run, eager=eager_run, mixed_batch=mixed,
               launches=graph_run["launches"], checks=checks)
    ok = (all(graph_run["checks"].values()) and all(eager_run["checks"].values())
          and checks["streams_equal"] and checks["mixed_batch"])
    check(ok, f"serve checks failed: {out}")
    return out, eng, eager, cfg, graph_streams


def run_profile(eng, cfg, serve_wall_s: float):
    """Device time by kernel kind over a second run of the serve phase's 16
    requests, traced with CUDA activity only.  Tracing each launch slows
    the host several times over, so the idle share is taken against the
    UNTRACED serve phase's wall time (same requests, same tokens): 1 -
    device busy / that wall.  The traced run's own share is reported
    beside it and overstates idleness."""
    from vescale_tpu_torch.serve import ContinuousBatchingScheduler, run_serve

    eng.cache.reset()
    sched = ContinuousBatchingScheduler(eng.cache)
    done = {}
    prof = device_time_by_kind(
        lambda: done.update(res=run_serve(eng, sched, serve_requests(cfg.vocab_size))))
    busy, wall_ms = prof["device_busy_ms"], prof["traced_wall_ms"]
    return dict(requests=len(done["res"].outcomes),
                decode_steps=int(sched.telemetry.counter("serve_decode_steps_total")),
                untraced_wall_ms=serve_wall_s * 1e3,
                device_idle_share=max(0.0, 1.0 - busy / (serve_wall_s * 1e3)),
                traced_idle_share=max(0.0, 1.0 - busy / wall_ms), **prof)


# ------------------------------------------------------------- spec_prefix
# The bound on the two teacher-forced comparisons of the spec_prefix phase, in
# bf16 steps at the logits' scale.  On the CPU (tests/test_torch_spec_prefix.py,
# bf16 weights and pool, the prefill's attention through the model of the
# card's flash kernel) the suffix prefill sat 3.1-3.8 steps from a full
# prefill and a 16-token multi-token window 4.2-5.0 from plain decode at 32
# layers; the card adds cuBLAS's order of summation, which changes with the
# number of rows.  Three times the CPU's worst, rounded up.
SPEC_BF16_BOUND = 16.0
SYSTEM_TOKENS = 256


def spec_prefix_requests(vocab: int, n: int = 16, seed: int = 1):
    """A chat service's traffic: every request is one 256-token system
    prompt (16 pages) plus 16-240 private tokens, 32 new tokens, two
    arrivals a step."""
    from vescale_tpu_torch.serve import Request

    rng = np.random.default_rng(seed)
    system = tuple(int(t) for t in rng.integers(1, vocab, SYSTEM_TOKENS))
    out = []
    for i in range(n):
        private = tuple(int(t) for t in rng.integers(1, vocab, int(rng.integers(16, 241))))
        out.append((i // 2, Request(rid=i, prompt=system + private, max_new_tokens=32)))
    return out


def spec_prefix_classes():
    """Smoke-local subclasses that record what the exact checks read: each
    admission's prefix hit and step, the request of every sampled token,
    the drafter's prefills, and whether every emitted token is the verify
    logits' argmax at its position."""
    from vescale_tpu_torch.serve import ContinuousBatchingScheduler, SpeculativeDecoder

    class RecordingScheduler(ContinuousBatchingScheduler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.hits, self.admit_steps, self.token_rids = {}, {}, []

        def admit(self, step):
            out = super().admit(step)
            for inf in out:
                self.hits[inf.req.rid] = inf.prefix_hit
                self.admit_steps[inf.req.rid] = step
            return out

        def record_token(self, slot, token):
            self.token_rids.append(self.active[slot].req.rid)
            super().record_token(slot, token)

    class CheckingDecoder(SpeculativeDecoder):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.prefills = self.emitted = self.not_argmax = 0

        def on_admit(self, slot, prompt, max_new_tokens):
            super().on_admit(slot, prompt, max_new_tokens)
            self.prefills += 1

        def accept(self, drafts_row, verify_logits_row, budget, eos_id):
            out, accepted = super().accept(drafts_row, verify_logits_row, budget, eos_id)
            for i, tok in enumerate(out):
                self.emitted += 1
                self.not_argmax += int(tok != int(np.argmax(verify_logits_row[i])))
            return out, accepted

    return RecordingScheduler, CheckingDecoder


def spec_prefix_run(dev, eng, arrivals, kernels_mod, *, prefix, drafter_layers=None, k=4):
    """One run from an empty cache; the launch counts set to 0 just before
    it and read just after.  Returns the row to print, the exact checks,
    the streams and (for the golden run) each sampled token's top-2 gap."""
    from vescale_tpu_torch.serve import PrefixCache, run_serve, slice_drafter_params

    Sched, Decoder = spec_prefix_classes()
    cache = eng.cache
    L = eng.config.num_hidden_layers
    cache.reset()
    pc = PrefixCache(cache) if prefix else None
    sched = Sched(cache, prefix_cache=pc)
    spec = None
    if drafter_layers:
        spec = Decoder(eng, slice_drafter_params(eng.params, drafter_layers),
                       drafter_layers=drafter_layers, k=k)
    gaps = []
    if not prefix:
        def greedy(row):  # the golden run records each sample's top-2 gap
            top = np.partition(row, -2)[-2:]
            gaps.append(float(top[1] - top[0]))
            return int(np.argmax(row))
        eng.greedy = greedy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels_mod.reset_launches()
    t0 = time.perf_counter()
    try:
        res = run_serve(eng, sched, arrivals, speculative=spec)
        torch.cuda.synchronize()
    finally:
        eng.__dict__.pop("greedy", None)
    wall = time.perf_counter() - t0
    launches = dict(kernels_mod.LAUNCHES)
    sched.ledger_check()
    tel = sched.telemetry
    steps = int(tel.counter("serve_decode_steps_total"))
    verify = int(tel.counter("serve_spec_verify_steps_total"))
    first = min(sched.admit_steps.values())
    misses = sum(1 for h in sched.hits.values() if h == 0)
    dl = drafter_layers or 0
    drafter_prefills = spec.prefills if spec else 0
    tokens = sum(len(o["tokens"]) for o in res.outcomes.values())
    checks = {
        "all_completed": len(res.outcomes) == len(arrivals) and all(
            o["status"] == "completed" and len(o["tokens"]) == 32 for o in res.outcomes.values()),
        "flash_launches": launches["flash_fwd"] == L * misses + dl * drafter_prefills,
        "paged_launches": launches["paged_decode"] == L * (steps - verify) + dl * (k + 1) * verify,
    }
    if prefix:
        checks["hits_at_256"] = all(
            h == (0 if sched.admit_steps[r] == first else SYSTEM_TOKENS) for r, h in sched.hits.items())
    if spec:
        checks["drafter_prefills"] = drafter_prefills == len(arrivals) and not spec.undrafted
        checks["emitted_are_verify_argmax"] = spec.not_argmax == 0 and spec.emitted == tokens - len(arrivals)
    row = dict(wall_s=wall, tokens_per_s=tokens / wall, decode_steps=steps, verify_steps=verify,
               ttft_p50_s=sched.percentile("ttft", 0.5), ttft_p99_s=sched.percentile("ttft", 0.99),
               decode_step_p50_ms=1e3 * sched.percentile("step_time", 0.5),
               prefill_p50_ms=1e3 * tel.histograms["serve_ttft_prefill_seconds"].percentile(0.5),
               prefix_hits=sum(1 for h in sched.hits.values() if h),
               prefill_tokens_saved=pc.stats.hit_tokens if pc else 0,
               accept_rate=spec.accept_rate() if spec else None,
               drafted=spec.drafted if spec else None, accepted=spec.accepted if spec else None,
               peak_memory_bytes=torch.cuda.max_memory_allocated(dev), launches=launches)
    per_rid = {}
    for rid, gap in zip(sched.token_rids, gaps):
        per_rid.setdefault(rid, []).append(gap)
    del spec
    free_memory()
    return row, checks, {r: o["tokens"] for r, o in res.outcomes.items()}, per_rid


def spec_prefix_bounds(eng, arrivals, golden):
    """Teacher-forced on one request: its suffix prefill (over the system
    prompt's pages, written by another request's full prefill) against a
    full prefill of it, and one 16-token ``decode_multi`` window of its
    golden tokens against 16 plain decode steps, in bf16 steps at scale."""
    from vescale_tpu_torch.kernels import ulps_at_scale

    cache = eng.cache
    S = cache.num_slots
    cache.reset()
    req, other = arrivals[5][1], arrivals[4][1]
    a = cache.alloc(len(other.prompt), 0)
    eng.prefill(other.prompt, a)
    cache.commit_prefill(a, len(other.prompt))
    pages = [int(p) for p in cache.page_table[a][: SYSTEM_TOKENS // cache.config.page_size]]
    for p in pages:
        cache.retain_page(p)
    cache.free(a)
    b = cache.alloc_shared(pages, len(req.prompt), 16)
    cache.commit_prefill(b, SYSTEM_TOKENS)
    suffix = eng.prefill_suffix(req.prompt, b, SYSTEM_TOKENS)
    c = cache.alloc(len(req.prompt), 16)
    full = eng.prefill(req.prompt, c)
    cache.commit_prefill(c, len(req.prompt))
    toks = golden[req.rid][:16]
    rows = []
    for t in toks:
        x = np.zeros((S,), np.int64)
        x[c] = t
        rows.append(eng.decode(x)[c])
        cache.advance(c)
    d = cache.alloc(len(req.prompt), 16)
    eng.prefill(req.prompt, d)
    cache.commit_prefill(d, len(req.prompt))
    w = np.zeros((S, 16), np.int64)
    w[d] = toks
    multi = eng.decode_multi(w)[d]
    rows = np.stack(rows)
    cache.reset()
    out = dict(rid=req.rid, bound_bf16_steps=SPEC_BF16_BOUND,
               suffix_vs_prefill_bf16_steps=ulps_at_scale(suffix, full) / BF16_ULP,
               multi_vs_decode_bf16_steps=ulps_at_scale(multi, rows) / BF16_ULP,
               suffix_argmax_equal=int(np.argmax(suffix)) == int(np.argmax(full)),
               multi_argmax_equal=int((multi.argmax(-1) == rows.argmax(-1)).sum()))
    out["ok"] = (out["suffix_vs_prefill_bf16_steps"] <= SPEC_BF16_BOUND
                 and out["multi_vs_decode_bf16_steps"] <= SPEC_BF16_BOUND)
    return out


def run_spec_prefix(dev, eng, kernels_mod):
    """Llama-3-8B with the serve phase's weights and cache over the chat
    traffic of ``spec_prefix_requests``: plain (golden), prefix cache,
    prefix cache + speculation (k = 4) with a 2-layer and a 32-layer
    drafter (the target itself, which should accept nearly every draft)."""
    arrivals = spec_prefix_requests(eng.config.vocab_size)
    L = eng.config.num_hidden_layers
    runs, checks = {}, {}
    golden_row, checks["plain"], golden, gaps = spec_prefix_run(
        dev, eng, arrivals, kernels_mod, prefix=False)
    runs["plain"] = golden_row
    for name, kw in (("prefix", dict(prefix=True)),
                     ("prefix_spec_2_layers", dict(prefix=True, drafter_layers=2)),
                     ("prefix_spec_all_layers", dict(prefix=True, drafter_layers=L))):
        row, checks[name], streams, _ = spec_prefix_run(dev, eng, arrivals, kernels_mod, **kw)
        equal = [r for r in streams if streams[r] == golden[r]]
        first_div = {}
        for r in streams:
            if r not in equal:
                pos = next(i for i, (x, y) in enumerate(zip(streams[r], golden[r])) if x != y)
                first_div[r] = dict(position=pos, golden_top2_gap=gaps[r][pos])
        row.update(requests_equal_golden=len(equal), first_divergence=first_div)
        runs[name] = row
    bounds = spec_prefix_bounds(eng, arrivals, golden)
    launches = {k: sum(r["launches"][k] for r in runs.values()) for k in runs["plain"]["launches"]}
    out = dict(model="LLAMA3_8B", requests=len(arrivals), system_tokens=SYSTEM_TOKENS, runs=runs,
               checks=checks, bounded=bounds, launches=launches)
    check(all(all(c.values()) for c in checks.values()) and bounds["ok"],
          f"spec_prefix checks failed: {out}")
    return out


# --------------------------------------------------------- serve_resilient
# the JAX package's single-process fault battery (scripts/serve_smoke.py)
RESILIENT_BATTERY = "request_timeout:step=6;slow_decode:step=3,count=2;oom:step=4;preempt:step=9"
RESILIENT_FIRED = {"request_timeout": 1, "slow_decode": 2, "oom": 1, "preempt": 1}
REPLICA_LAYERS = 2
REPLICA_REQUESTS = 8


def resilient_run(eng, arrivals, kernels_mod, schedule=None, plain=False, **kw):
    """One run of ``arrivals`` from an empty cache through
    ``run_serve_resilient`` (``run_serve`` with ``plain``), ``schedule``
    armed in faultsim, launch counts set to 0 just before and read after."""
    from vescale_tpu_torch.resilience import faultsim
    from vescale_tpu_torch.serve import ContinuousBatchingScheduler, run_serve, run_serve_resilient

    eng.cache.reset()
    sched = ContinuousBatchingScheduler(eng.cache)
    inj = faultsim.arm(faultsim.parse_schedule(schedule)) if schedule else None
    torch.cuda.synchronize()
    kernels_mod.reset_launches()
    t0 = time.perf_counter()
    try:
        if plain:
            res = run_serve(eng, sched, arrivals)
        else:
            res = run_serve_resilient(engine=eng, scheduler=sched, arrivals=arrivals,
                                      install_signal_handlers=False, coordinate=False, **kw)
        torch.cuda.synchronize()
    finally:
        fired = {k: v for k, v in inj.fired_total.items() if v} if inj is not None else {}
        faultsim.disarm()
    wall = time.perf_counter() - t0
    launches = dict(kernels_mod.LAUNCHES)
    sched.ledger_check()
    L = eng.config.num_hidden_layers
    prefills = int(sched.telemetry.counter("serve_prefills_total"))
    steps = int(sched.telemetry.counter("serve_decode_steps_total"))
    tokens = sum(len(o["tokens"]) for o in res.outcomes.values())
    hist = sched.telemetry.histograms
    # the wall split: prefills (admission to first token), decode steps,
    # and the rest (boundaries, sampling, the envelope's own work)
    prefill_s = hist["serve_ttft_prefill_seconds"].sum
    decode_s = hist["serve_decode_step_seconds"].sum
    row = dict(status=res.status, steps=res.steps, prefills=prefills, decode_steps=steps,
               counts=res.counts, fired=fired, serve_s=wall, generated_tokens=tokens,
               tokens_per_s=tokens / wall, prefill_s=prefill_s, decode_s=decode_s,
               other_s=wall - prefill_s - decode_s,
               prefill_p50_ms=1e3 * hist["serve_ttft_prefill_seconds"].percentile(0.5),
               decode_step_p50_ms=1e3 * sched.percentile("step_time", 0.5),
               decode_step_p99_ms=1e3 * sched.percentile("step_time", 0.99),
               launches=launches,
               launches_match=(launches["flash_fwd"] == L * prefills and prefills > 0
                               and launches["paged_decode"] == L * steps and steps > 0))
    return row, res, sched


def completed_streams(res):
    return {r: o["tokens"] for r, o in res.outcomes.items() if o["status"] == "completed"}


def replica_engine(dev):
    """The replica leg's engine: the 8B widths at ``REPLICA_LAYERS`` layers,
    the serve phase's seed and cache geometry."""
    from vescale_tpu_torch.models import LLAMA3_8B, init_params
    from vescale_tpu_torch.serve import KVCacheConfig, PagedKVCache, ServeEngine

    cfg = dataclasses.replace(LLAMA3_8B, num_hidden_layers=REPLICA_LAYERS)
    params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    kc = KVCacheConfig(layers=cfg.num_hidden_layers, kv_heads=cfg.num_key_value_heads,
                       head_dim=cfg.head_dim, num_slots=8, page_size=16, pages_per_slot=64,
                       dtype=torch.bfloat16)
    return ServeEngine(cfg, params, PagedKVCache(kc, device=dev), device=dev)


def replica_child() -> int:
    """``--replica-child``: one fleet replica on the card, fed over HTTP on
    ``VESCALE_SERVE_OPS_PORT`` until SIGTERM drains it.  Its last line
    carries the status, the ledger counts and its kernel launches beside
    the prefills and decode steps the scheduler ran."""
    from vescale_tpu_torch import kernels as kernels_mod
    from vescale_tpu_torch.serve import ContinuousBatchingScheduler, Request, run_serve, serve_replica

    entered = time.time()
    t = time.perf_counter()
    eng = replica_engine(torch.device("cuda", 0))
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t
    # warm the engine before the port opens: the first prefill and the
    # decode graph's capture take seconds, and a router polling a cold
    # replica counts every poll that times out as a failure.  The warm-up
    # runs with the replica's fault schedule, ops port and trace stream
    # unset, so it consumes no fault, opens no port and writes no span.
    t = time.perf_counter()
    held = {k: os.environ.pop(k) for k in ("VESCALE_FAULTSIM", "VESCALE_SERVE_OPS_PORT",
                                           "VESCALE_FLEET_TRACE_DIR") if k in os.environ}
    calls = []

    def timed(fn, name):  # each engine call of the warm-up, synchronised
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            calls.append((name, time.perf_counter() - t0))
            return r
        return run

    eng.prefill, eng.decode = timed(eng.prefill, "prefill"), timed(eng.decode, "decode")
    try:
        run_serve(eng, ContinuousBatchingScheduler(eng.cache),
                  [(0, Request(rid=0, prompt=tuple(range(1, 33)), max_new_tokens=4))])
        torch.cuda.synchronize()
    finally:
        os.environ.update(held)
        del eng.prefill, eng.decode
    eng.cache.reset()
    print(json.dumps({"replica_ready_wall": time.time(), "warmup_s": time.perf_counter() - t,
                      "entered_wall": entered, "engine_s": engine_s, "warmup_calls": calls}),
          flush=True)
    sched = ContinuousBatchingScheduler(eng.cache)
    kernels_mod.reset_launches()
    res = serve_replica(engine=eng, scheduler=sched, linger_s=1.0, coordinate=False)
    torch.cuda.synchronize()
    print(json.dumps({"replica_status": res.status, "counts": res.counts,
                      "launches": dict(kernels_mod.LAUNCHES),
                      "prefills": int(sched.telemetry.counter("serve_prefills_total")),
                      "decode_steps": int(sched.telemetry.counter("serve_decode_steps_total")),
                      "layers": eng.config.num_hidden_layers}), flush=True)
    return 0


def http_json(url, payload=None, timeout=10.0):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_replica_leg(dev, arrivals):
    """A child process serves ``REPLICA_REQUESTS`` of the serve requests
    over HTTP; this process is its client, then runs the same requests
    through ``run_serve`` on the same weights."""
    from vescale_tpu_torch.serve import ROUTER_FIELDS, ContinuousBatchingScheduler, run_serve

    reqs = [r for _, r in arrivals[:REPLICA_REQUESTS]]
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    env = {k: v for k, v in os.environ.items() if not k.startswith("VESCALE_")}
    env.update(VESCALE_SERVE_OPS_PORT=str(port), VESCALE_SERVE_REPLICA_ID="smoke-replica")
    log_file = tempfile.TemporaryFile(mode="w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--replica-child"],
                            env=env, stdout=log_file, stderr=subprocess.STDOUT)

    def child_log() -> str:
        log_file.seek(0)
        return log_file.read()

    out = {}
    try:
        deadline = time.monotonic() + 300
        while True:
            if proc.poll() is not None:
                check(False, f"the replica child exited {proc.returncode} before serving: "
                      + child_log()[-4000:])
            try:
                health = http_json(f"{url}/healthz", timeout=2.0)
                break
            except OSError:
                check(time.monotonic() < deadline, "the replica child never answered /healthz")
                time.sleep(0.5)
        out["startup_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        accepted = [http_json(f"{url}/submit", {"rid": r.rid, "prompt": list(r.prompt),
                                                "max_new_tokens": r.max_new_tokens})["accepted"]
                    for r in reqs]
        deadline = time.monotonic() + 300
        while True:
            feed = http_json(f"{url}/router")
            rows = http_json(f"{url}/outcomes")["outcomes"]
            if len(rows) == len(reqs):
                break
            check(proc.poll() is None and time.monotonic() < deadline,
                  f"the replica never finished its requests: {sorted(rows)}: " + child_log()[-4000:])
            time.sleep(0.1)
        out["serve_s"] = time.perf_counter() - t1
        health = http_json(f"{url}/healthz")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = child_log()
    log_file.close()
    done = [json.loads(ln) for ln in text.splitlines() if ln.startswith('{"replica_status"')]

    eng = replica_engine(dev)
    sched = ContinuousBatchingScheduler(eng.cache)
    res = run_serve(eng, sched, [(0, r) for r in reqs])
    local = {str(r): o["tokens"] for r, o in res.outcomes.items()}
    del eng
    free_memory()
    remote = {r: o["tokens"] for r, o in rows.items()}
    checks = {
        "accepted": all(accepted),
        "router_keys_v5": set(feed) == ROUTER_FIELDS and feed["schema_version"] == 5
        and feed["replica_id"] == "smoke-replica",
        "healthz": health.get("ok") is True and health.get("replica_id") == "smoke-replica",
        "all_completed": all(o["status"] == "completed" for o in rows.values()),
        "tokens_equal_in_process": remote == local,
        "drained_preempted": bool(done) and done[-1]["replica_status"] == "preempted",
        "exit_code_0": rc == 0,
    }
    out.update(layers=REPLICA_LAYERS, requests=len(reqs), exit_code=rc,
               replica_counts=done[-1]["counts"] if done else None,
               router_decode_steps=feed["decode_steps"], checks=checks)
    if not all(checks.values()):
        out["child_log_tail"] = text[-4000:]
    return out


def run_serve_resilient_phase(dev, eng, kernels_mod, serve, serve_streams):
    """The serve cell through the fault envelope (module docstring)."""
    from vescale_tpu_torch.resilience import Watchdog

    arrivals = serve_requests(eng.config.vocab_size)
    rids = sorted(r.rid for _, r in arrivals)
    runs, checks = {}, {}

    runs["golden"], golden, _ = resilient_run(eng, arrivals, kernels_mod)
    checks["golden"] = dict(
        streams_equal_serve=completed_streams(golden) == serve_streams,
        counts_equal_serve=golden.counts == serve["graph"]["counts"],
        status=golden.status == "completed", launches=runs["golden"]["launches_match"])
    gold = completed_streams(golden)

    runs["battery"], bat, _ = resilient_run(eng, arrivals, kernels_mod, schedule=RESILIENT_BATTERY)
    done = completed_streams(bat)
    replayed = [r for r, o in bat.outcomes.items() if o.get("replays")]
    checks["battery"] = dict(
        fired=runs["battery"]["fired"] == RESILIENT_FIRED,
        one_terminal_outcome_each=sorted(bat.outcomes) == rids and all(
            o["status"] in ("completed", "shed", "timed_out", "preempted_requeue")
            for o in bat.outcomes.values()),
        status=bat.status == "preempted",
        evicted_and_timed_out=bat.counts["evicted"] == 1 and bat.counts["timed_out"] == 1,
        completed_equal_golden=bool(done) and all(done[r] == gold[r] for r in done),
        oom_victim_replayed_equal_golden=len(replayed) == 1 and replayed[0] in done,
        launches=runs["battery"]["launches_match"])
    runs["battery"].update(completed=len(done), drained=bat.drained,
                           rejected_on_drain=bat.rejected_on_drain, oom_victim=replayed)

    with tempfile.TemporaryDirectory() as dump_dir:
        old = os.environ.get("VESCALE_FAULTSIM_HANG_S")  # vescale-lint: disable=VSC201 (save/restore around the hang leg)
        os.environ["VESCALE_FAULTSIM_HANG_S"] = "3"
        wd = None
        try:
            from vescale_tpu_torch.telemetry import Registry

            tel = Registry()
            wd = Watchdog(timeout_s=2.0, poll_s=0.25, abort=False, dump_dir=dump_dir,
                          telemetry=tel).start()
            runs["hang"], hung, _ = resilient_run(eng, arrivals, kernels_mod, schedule="hang:step=5",
                                                  watchdog=wd)
        finally:
            if wd is not None:
                wd.stop()
            if old is None:
                os.environ.pop("VESCALE_FAULTSIM_HANG_S", None)
            else:
                os.environ["VESCALE_FAULTSIM_HANG_S"] = old
        dumps = sorted(os.listdir(dump_dir))
        main_stack = ""
        if dumps:
            with open(os.path.join(dump_dir, dumps[0])) as f:
                threads = json.load(f)["threads"]
            main_stack = "".join(next((v for k, v in threads.items() if k.startswith("MainThread")), []))
    checks["hang"] = dict(
        fired_once=wd.fired == 1 and tel.counter("resilience_hang_detected_total") == 1,
        dumped=dumps == ["watchdog_hang_rank0_step5_1.json"],
        main_thread_stack="run_serve_resilient" in main_stack,
        streams_equal_golden=completed_streams(hung) == gold and hung.status == "completed",
        launches=runs["hang"]["launches_match"])
    runs["hang"].update(dumps=dumps, stalled_s=wd.last_bundle["stalled_s"] if wd.last_bundle else None)

    # the envelope's cost in one process: plain and envelope in the order
    # P E E P, then the watchdog alone and faultsim alone to tell their
    # shares apart
    overhead = {"plain": [], "envelope": [], "watchdog_only": [], "faultsim_only": []}
    order = ("plain", "envelope", "envelope", "plain", "watchdog_only", "faultsim_only")
    for which in order:
        schedule = "oom:step=1000000" if which in ("envelope", "faultsim_only") else None
        wd = Watchdog(timeout_s=60.0, abort=False).start() if which in (
            "envelope", "watchdog_only") else None
        try:
            row, res, _ = resilient_run(eng, arrivals, kernels_mod, plain=which == "plain",
                                        schedule=schedule, watchdog=wd)
        finally:
            if wd is not None:
                wd.stop()
        row["watchdog_fired"] = wd.fired if wd is not None else 0
        row["streams_equal_golden"] = completed_streams(res) == gold
        overhead[which].append(row)
    checks["overhead"] = dict(
        streams=all(r["streams_equal_golden"] for rs in overhead.values() for r in rs),
        quiet=all(not r["fired"] and r["watchdog_fired"] == 0 for rs in overhead.values() for r in rs),
        launches=all(r["launches_match"] for rs in overhead.values() for r in rs))
    summary = {which: {k: float(np.mean([r[k] for r in rs]))
                       for k in ("decode_step_p50_ms", "decode_step_p99_ms", "tokens_per_s",
                                 "serve_s", "prefill_s", "decode_s", "other_s")}
               for which, rs in overhead.items()}
    summary["p50_delta_ms"] = summary["envelope"]["decode_step_p50_ms"] - summary["plain"]["decode_step_p50_ms"]

    replica = run_replica_leg(dev, arrivals)
    checks["replica"] = replica["checks"]

    legs = [runs["golden"], runs["battery"], runs["hang"]] + [r for rs in overhead.values() for r in rs]
    launches = {k: sum(r["launches"][k] for r in legs) for k in runs["golden"]["launches"]}
    out = dict(model="LLAMA3_8B", requests=len(arrivals), battery=RESILIENT_BATTERY, runs=runs,
               overhead=overhead, overhead_summary=summary, replica=replica, checks=checks,
               launches=launches)
    check(all(all(c.values()) for c in checks.values()), f"serve_resilient checks failed: {out}")
    return out


# ------------------------------------------------------------------- fleet
# The fleet phase (module docstring): the port's router, supervisor,
# journal, standby, autoscaler and rollout controller over replica children
# of the replica leg's engine (the 8B widths at REPLICA_LAYERS layers).
FLEET_SIZE = 3
FLEET_KILL = "replica_kill:call=2"  # r1 dies on its third loaded decode step
FLEET_KILL_EXIT = 29  # VESCALE_FAULTSIM_KILL_EXIT_CODE's default
FLEET_FRESH_BASE = 50  # rids 50..55: fresh traffic after r1 rejoins
FLEET_FRESH = 6
FLEET_HA_BASE = 100  # the HA wave: the serve requests' prompts at rid + 100
FLEET_TTL_S = 1.0  # the leader lease: the standby takes over this long after the leader's last renewal
FLEET_ROUTER = dict(poll_interval_s=0.05, breaker_failures=2, breaker_cooldown_s=0.5,
                    dispatch_retries=4, backoff_s=0.05, backoff_max_s=0.5, hedge_s=0.0)
AUTOSCALE_QUEUE = 8  # the autoscale replica's VESCALE_SERVE_MAX_QUEUE
AUTOSCALE_SPIKE = 5 * (8 + AUTOSCALE_QUEUE)  # five times one replica's slots plus queue
AUTOSCALE_SPIKE_NEW = 128  # new tokens a spike request: the queue outlasts the up-hold
AUTOSCALE_BURSTS = 8  # the spike arrives in bursts AUTOSCALE_BURST_S apart
AUTOSCALE_BURST_S = 0.1
AUTOSCALE_SPIKE_BASE = 300
AUTOSCALE_WAVE2_BASE = 500
AUTOSCALE_WAVE2 = 6
CANARY_DIVERGE = "canary_diverge:call=0,count=1"
CANARY_PROMPTS = [[1, 2, 3, 4], [5, 6, 7, 8, 9]]
FLEET_HOP_ITERS = 2000
FLEET_HOP_REPS = 5


def fleet_requests(vocab: int, n: int, seed: int, base: int, max_new: int = 32):
    """``n`` requests shaped as the serve phase's (32-512 prompt tokens),
    ``max_new`` new tokens each, rids from ``base``."""
    from vescale_tpu_torch.serve import Request

    return [Request(rid=base + i, prompt=r.prompt, max_new_tokens=max_new)
            for i, (_, r) in enumerate(serve_requests(vocab, n=n, seed=seed))]


def fleet_specs(fleet: str, n: int, work: str, trace_dir: str, armed=None, extra=None):
    """``n`` replica children (``--replica-child``), each streaming its spans
    to ``trace_dir``; ``armed`` maps a replica id to the faultsim schedule
    of its first spawn only."""
    from vescale_tpu_torch.serve.fleet import ReplicaSpec, reserve_port

    base = {k: v for k, v in os.environ.items() if not k.startswith("VESCALE_")}
    base.update(VESCALE_FLEET_TRACE_DIR=trace_dir, **(extra or {}))
    specs = []
    for i in range(n):
        rid = f"r{i}"
        env = dict(base)
        if armed and rid in armed:
            env["VESCALE_FAULTSIM"] = armed[rid]
        specs.append(ReplicaSpec(rid, [sys.executable, os.path.abspath(__file__), "--replica-child"],
                                 reserve_port(), env=env,
                                 log_path=os.path.join(work, f"{fleet}-{rid}.log"),
                                 restart_env_drop=("VESCALE_FAULTSIM",)))
    return specs


def fleet_logs(sup) -> str:
    out = []
    for rid, m in sup.managed.items():
        if m.spec.log_path and os.path.exists(m.spec.log_path):
            with open(m.spec.log_path, errors="replace") as f:
                out.append(f"--- {rid}\n" + f.read()[-3000:])
    return "\n".join(out)


def fleet_wait(what: str, cond, fr, sup, timeout_s: float, autoscaler=None, pump=False) -> float:
    """Turn the supervisor and the router (polls, or pumps) until ``cond()``;
    the run fails with the replicas' logs after ``timeout_s``."""
    t0 = time.perf_counter()
    deadline = time.monotonic() + timeout_s
    while True:
        sup.poll()
        if pump:
            fr.pump()
        else:
            fr.poll(force=True)
        if autoscaler is not None:
            autoscaler.tick()
        if cond():
            return time.perf_counter() - t0
        check(time.monotonic() < deadline, f"fleet: {what} within {timeout_s} s: "
              + json.dumps({r: (h.breaker.state, h.feed is not None) for r, h in fr.replicas.items()})
              + "\n" + fleet_logs(sup))
        time.sleep(0.05)


def fleet_up(fr, sup, timeout_s: float = 240.0) -> float:
    return fleet_wait("every replica up", lambda: all(
        h.feed is not None and h.breaker.state == "closed" for h in fr.replicas.values()),
        fr, sup, timeout_s)


def fleet_drain(fr, sup, timeout_s: float = 180.0, autoscaler=None) -> float:
    return fleet_wait("every request terminal", lambda: fr.ledger.pending_count() == 0, fr, sup,
                      timeout_s, autoscaler=autoscaler, pump=True)


def fleet_submit(fr, reqs, sessions=True):
    """Half the load pinned to a session (affinity), half least-loaded."""
    for r in reqs:
        fr.submit(r, session=f"sess{r.rid % 5}" if sessions and r.rid % 2 == 0 else None)


def fleet_complete_all(fr, sup, reqs, autoscaler=None, rounds: int = 60) -> int:
    """Drain, then resubmit every shed rid (the retry_after_s contract), two
    queues' worth a round, until each one completed.  Returns the rounds."""
    by_rid = {r.rid: r for r in reqs}
    for k in range(rounds):
        fleet_drain(fr, sup, autoscaler=autoscaler)
        shed = [rid for rid in by_rid if fr.ledger.records[rid].status != "completed"]
        if not shed:
            return k
        time.sleep(0.1)
        fleet_submit(fr, [by_rid[rid] for rid in shed[:2 * AUTOSCALE_QUEUE]], sessions=False)
    check(False, f"fleet: rids never completed after {rounds} rounds")


def fleet_streams(fr, rids=None):
    return {rid: list(rec.outcome["tokens"]) for rid, rec in fr.ledger.records.items()
            if rec.status == "completed" and (rids is None or rid in rids)}


def fleet_reports(sup) -> list:
    """Every clean exit's last line (``replica_child``), with its replica."""
    rows = []
    for rid, m in sup.managed.items():
        if not (m.spec.log_path and os.path.exists(m.spec.log_path)):
            continue
        with open(m.spec.log_path, errors="replace") as f:
            for ln in f:
                if ln.startswith('{"replica_status"'):
                    rows.append(dict(json.loads(ln), replica=rid))
    return rows


def fleet_transitions(fr, replica: str) -> list:
    return [(t["from"], t["to"], t["ts"]) for t in fr.breaker_transitions if t["replica"] == replica]


def router_child(spec_path: str) -> int:
    """``--router-child``: the HA leg's leader, a journaled ``FleetRouter``
    holding the lease over the kill fleet's replicas.  It starts before the
    leg and waits for its spec; it submits the wave, writes its spans to
    disk and pumps until the armed ``router_kill`` ends it.  It makes no
    CUDA call."""
    from vescale_tpu_torch.ndtimeline import api as nd_api
    from vescale_tpu_torch.ndtimeline.handlers import LocalRawHandler
    from vescale_tpu_torch.resilience import faultsim
    from vescale_tpu_torch.serve import (FleetJournal, FleetRouter, HttpReplicaClient, LeaderLease,
                                         Request)

    deadline = time.monotonic() + 600
    while not os.path.exists(spec_path):
        if time.monotonic() > deadline:
            return 3
        time.sleep(0.05)
    with open(spec_path) as f:
        spec = json.load(f)
    faultsim.arm_from_env()
    nd_api.init_ndtimers(rank=0, handlers=[LocalRawHandler(spec["trace"])])
    lease = LeaderLease(spec["lease_path"], holder="leader", ttl_s=spec["ttl_s"])
    fr = FleetRouter(journal=FleetJournal(spec["journal_dir"]), lease=lease, **spec["router"])
    for rid, url in spec["replicas"].items():
        fr.add_replica(rid, HttpReplicaClient(url))
    deadline = time.monotonic() + 60
    while not all(h.feed is not None and h.breaker.state == "closed" for h in fr.replicas.values()):
        if time.monotonic() > deadline:
            return 4
        fr.poll(force=True)
        time.sleep(0.05)
    for rid, prompt, max_new in spec["wave"]:
        fr.submit(Request(rid=rid, prompt=tuple(prompt), max_new_tokens=max_new),
                  session=f"sess{rid % 5}" if rid % 2 == 0 else None)
    nd_api.flush()  # the submit and dispatch spans reach the disk before the crash
    print(json.dumps({"leader_epoch": fr.epoch, "submitted": len(spec["wave"])}), flush=True)
    while fr.pump() > 0:  # router_kill ends the process at a pump boundary
        time.sleep(0.05)
    return 0


class _InstantClient:
    """A replica that answers at once: the router's own bookkeeping alone."""

    def poll_router(self):
        return {"schema_version": 2, "replica_id": "L", "accepting": True, "draining": False,
                "queue_depth": 0, "inflight": 0, "slots": 64, "free_slots": 64, "pages": 64,
                "free_pages": 64, "ttft_s": {"p50": None, "p95": None, "p99": None},
                "itl_s": {"p50": None, "p95": None, "p99": None}, "shed_rate": 0.0,
                "retry_after_s": 0.01, "goodput_tokens_per_s": 0.0,
                "throughput_tokens_per_s": 0.0, "mfu": None, "decode_steps": 1, "serve_step": 1,
                "uptime_s": 1.0, "rank": 0}

    def submit(self, payload):
        return {"accepted": True}

    def outcomes(self):
        return {"outcomes": {}}


def fleet_costs(work: str, decode_p50_s: float, tokens_per_req: float) -> dict:
    """(e): the router's own costs, min over reps of ``FLEET_HOP_ITERS``
    submits on an instant in-memory client: a dispatch against a direct
    inbox push, the journaled router against the plain one, and ndtimeline
    live against dormant; each added cost as a fraction of the replicas'
    decode step p50 and of a request's decode service time (the reference
    benches' denominator: tokens a request times that p50)."""
    from vescale_tpu_torch.ndtimeline import api as nd_api
    from vescale_tpu_torch.serve import FleetJournal, FleetRouter, Request, RequestInbox

    kw = dict(poll_interval_s=3600.0, breaker_failures=3, breaker_cooldown_s=1.0,
              dispatch_retries=1, backoff_s=0.0, backoff_max_s=0.0, hedge_s=0.0)
    made = [0]

    def hop(journaled: bool) -> float:
        best = float("inf")
        for _ in range(FLEET_HOP_REPS):
            made[0] += 1
            j = FleetJournal(os.path.join(work, "hop", str(made[0]))) if journaled else None
            r = FleetRouter(journal=j, **kw)
            r.add_replica("L", _InstantClient())
            r.poll(force=True)
            for i in range(300):  # warm before every timed window
                r.submit(Request(rid=1_000_000 + i, prompt=(1, 2), max_new_tokens=1))
            t0 = time.perf_counter()
            for i in range(FLEET_HOP_ITERS):
                r.submit(Request(rid=i, prompt=(1, 2), max_new_tokens=1))
            best = min(best, (time.perf_counter() - t0) / FLEET_HOP_ITERS)
            if j is not None:
                j.close()
        return best

    direct = float("inf")
    for _ in range(FLEET_HOP_REPS):
        box = RequestInbox()
        t0 = time.perf_counter()
        for i in range(FLEET_HOP_ITERS):
            box.push(Request(rid=i, prompt=(1, 2), max_new_tokens=1))
        direct = min(direct, (time.perf_counter() - t0) / FLEET_HOP_ITERS)
    plain = hop(False)
    journaled = hop(True)
    nd_api.init_ndtimers(rank=0)
    try:
        traced = hop(False)
    finally:
        nd_api.deinit_ndtimers()
    service = tokens_per_req * decode_p50_s
    added = {"router_hop": max(0.0, plain - direct), "journal": max(0.0, journaled - plain),
             "tracing": max(0.0, traced - plain)}
    return dict(direct_submit_us=direct * 1e6, router_hop_us=plain * 1e6,
                router_hop_journal_us=journaled * 1e6, router_hop_traced_us=traced * 1e6,
                decode_p50_ms=decode_p50_s * 1e3, tokens_per_request=tokens_per_req,
                service_ms=service * 1e3,
                frac_of_decode_p50={k: v / decode_p50_s for k, v in added.items()},
                frac_of_service={k: v / service for k, v in added.items()},
                added_us={k: v * 1e6 for k, v in added.items()}, bar=0.01)


def run_fleet_phase(dev, kernels_mod, card) -> dict:
    """The fleet tier on the card (module docstring): legs (a)-(e)."""
    from vescale_tpu_torch import checkpoint, telemetry
    from vescale_tpu_torch.ndtimeline import api as nd_api
    from vescale_tpu_torch.ndtimeline.parser_handler import parse_raw_spans
    from vescale_tpu_torch.serve import (FLEET_FIELDS, Autoscaler, ContinuousBatchingScheduler,
                                         FleetClockSync, FleetRouter, FleetSupervisor,
                                         HttpReplicaClient, RolloutController, StandbyRouter,
                                         assemble_fleet_timeline, estimate_fleet_clock_offsets,
                                         run_serve, verify_fleet_journeys)

    work = tempfile.mkdtemp(prefix="vtt_fleet_")
    trace = {f: os.path.join(work, "trace", f) for f in ("golden", "kill", "auto")}
    out, checks, spans = {}, {}, {}
    sups, leader, events = [], None, []
    leader_log = open(os.path.join(work, "leader.log"), "w+")
    try:
        # ---- every fleet and the HA leader start first: their start-up
        # (and each replica's warm-up) overlaps the in-process golden run
        # and the rollout checkpoint's save
        t_phase = time.perf_counter()

        def on_event(fleet):
            def note(kind, rid, fields):
                events.append((kind, f"{fleet}/{rid}", time.time()))
            return note

        g_sup = FleetSupervisor(fleet_specs("golden", FLEET_SIZE, work, trace["golden"]),
                                max_restarts=0, on_event=on_event("golden"))
        k_sup = FleetSupervisor(fleet_specs("kill", FLEET_SIZE, work, trace["kill"],
                                            armed={"r1": FLEET_KILL}),
                                max_restarts=2, restart_backoff_s=0.3, on_event=on_event("kill"))
        a_sup = FleetSupervisor(fleet_specs("auto", 1, work, trace["auto"], armed={"r0": CANARY_DIVERGE},
                                            extra={"VESCALE_SERVE_MAX_QUEUE": str(AUTOSCALE_QUEUE)}),
                                max_restarts=1, restart_backoff_s=0.3, on_event=on_event("auto"))
        for sup in (g_sup, k_sup, a_sup):
            sups.append(sup)
            sup.start()
        spec_path = os.path.join(work, "leader.json")
        env = {k: v for k, v in os.environ.items() if not k.startswith("VESCALE_")}
        env["VESCALE_FAULTSIM"] = "router_kill:call=0"
        leader = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--router-child",
                                   spec_path], env=env, stdout=leader_log, stderr=subprocess.STDOUT)
        eng = replica_engine(dev)
        vocab, L = eng.config.vocab_size, eng.config.num_hidden_layers
        serve_reqs = [r for _, r in serve_requests(vocab)]
        fresh = fleet_requests(vocab, FLEET_FRESH, seed=5, base=FLEET_FRESH_BASE)
        spike = fleet_requests(vocab, AUTOSCALE_SPIKE, seed=7, base=AUTOSCALE_SPIKE_BASE,
                               max_new=AUTOSCALE_SPIKE_NEW)
        wave2 = fleet_requests(vocab, AUTOSCALE_WAVE2, seed=9, base=AUTOSCALE_WAVE2_BASE)
        every = serve_reqs + fresh + spike + wave2
        kernels_mod.reset_launches()
        t = time.perf_counter()
        res = run_serve(eng, ContinuousBatchingScheduler(eng.cache, max_queue=len(every)),
                        [(0, r) for r in every])
        torch.cuda.synchronize()
        out["in_process"] = dict(seconds=time.perf_counter() - t, requests=len(every),
                                 launches=dict(kernels_mod.LAUNCHES))
        golden = {rid: list(o["tokens"]) for rid, o in res.outcomes.items()}
        checks["in_process_completed"] = all(o["status"] == "completed" for o in res.outcomes.values())
        ckpt_root = os.path.join(work, "ckpt")
        t = time.perf_counter()
        checkpoint.save(ckpt_root, {"model": eng.params})
        out["rollout_checkpoint_save_s"] = time.perf_counter() - t
        del eng, res
        free_memory()

        # ---- (a) golden: three replicas serve the serve phase's requests
        nd_api.init_ndtimers(rank=0)  # the router's spans, flushed per leg
        fr_g = FleetRouter(**FLEET_ROUTER)
        for s in g_sup.managed.values():
            fr_g.add_replica(s.spec.replica_id, HttpReplicaClient(s.spec.url))
        fleet_up(fr_g, g_sup)
        t = time.perf_counter()
        fleet_submit(fr_g, serve_reqs)
        fleet_drain(fr_g, g_sup)
        wall = time.perf_counter() - t
        fr_g.fleet_ledger_check()
        g_streams = fleet_streams(fr_g)
        feeds = {rid: h.feed for rid, h in fr_g.replicas.items()}
        fleet_view = fr_g.obs.fleet()
        tokens = sum(len(v) for v in g_streams.values())
        decode_p50 = statistics.median(f["itl_s"]["p50"] for f in feeds.values()
                                       if f["itl_s"]["p50"] is not None)
        out["golden"] = dict(wall_s=wall, counts=dict(fr_g.ledger.counts), tokens=tokens,
                             tokens_per_s=tokens / wall,
                             ttft_p50_s={r: f["ttft_s"]["p50"] for r, f in feeds.items()},
                             ttft_p99_s={r: f["ttft_s"]["p99"] for r, f in feeds.items()},
                             fleet_ttft_p99_s=fleet_view["ttft_p99_s"],
                             decode_p50_ms={r: 1e3 * (f["itl_s"]["p50"] or 0) for r, f in feeds.items()},
                             dispatches={r: h.dispatches for r, h in fr_g.replicas.items()})
        checks["golden"] = dict(
            completed=fr_g.ledger.counts["completed"] == len(serve_reqs)
            and fr_g.ledger.counts["failovers"] == 0,
            streams_equal_in_process=g_streams == {r.rid: golden[r.rid] for r in serve_reqs},
            every_replica_served=all(h.dispatches > 0 for h in fr_g.replicas.values()),
            fleet_feed_v5=set(fleet_view) == FLEET_FIELDS and fleet_view["schema_version"] == 5)
        spans["golden"] = nd_api.flush()

        for rid in list(g_sup.managed):
            g_sup.drain(rid)  # SIGTERM now; reaped at the end

        # ---- (a) kill + rejoin: r1 dies abruptly mid-load and comes back
        fr_k = FleetRouter(**FLEET_ROUTER)
        for s in k_sup.managed.values():
            fr_k.add_replica(s.spec.replica_id, HttpReplicaClient(s.spec.url))
        fleet_up(fr_k, k_sup)
        t = time.perf_counter()
        before = len(fleet_transitions(fr_k, "r1"))  # start-up's own probes stay out of the walk
        fleet_submit(fr_k, serve_reqs)
        fleet_drain(fr_k, k_sup)
        kill_wave_s = time.perf_counter() - t
        rejoin_wait_s = fleet_wait("r1 readmitted", lambda: fr_k.replicas["r1"].breaker.state == "closed",
                                   fr_k, k_sup, 240.0)
        t = time.perf_counter()
        fleet_submit(fr_k, fresh, sessions=False)
        fleet_drain(fr_k, k_sup)
        fresh_s = time.perf_counter() - t
        fr_k.fleet_ledger_check()
        clock = estimate_fleet_clock_offsets({r: h.client for r, h in fr_k.replicas.items()})
        k_streams = fleet_streams(fr_k)
        died = next((w for kind, r, w in events if kind == "died" and r == "kill/r1"), None)
        tr = fleet_transitions(fr_k, "r1")[before:]
        walk = [(a, b) for a, b, _ in tr]
        opened = next((ts for a, b, ts in tr if b == "open"), None)
        rejoined = next((ts for a, b, ts in reversed(tr) if b == "closed"), None)
        r1_exits = list(k_sup.managed["r1"].exit_history)
        on_r1 = sorted(rid for rid, rec in fr_k.ledger.records.items()
                       if rid >= FLEET_FRESH_BASE and rec.replica == "r1")
        out["kill"] = dict(wall_s=kill_wave_s, rejoin_wait_s=rejoin_wait_s, fresh_wall_s=fresh_s,
                           counts=dict(fr_k.ledger.counts), r1_exit_codes=r1_exits,
                           r1_transitions=walk, fresh_on_r1=on_r1,
                           # the kill's moment is the supervisor noticing the exit
                           # (its 50 ms turns); the breaker may open first
                           kill_to_breaker_open_s=(opened - died) if opened and died else None,
                           kill_to_rejoin_s=(rejoined - died) if rejoined and died else None,
                           clock_residual_us=clock.max_residual_us())
        checks["kill"] = dict(
            ledger_all_completed=fr_k.ledger.counts["completed"] == len(serve_reqs) + FLEET_FRESH,
            failover=fr_k.ledger.counts["failovers"] >= 1,
            streams_bitwise_golden=k_streams == {r.rid: golden[r.rid] for r in serve_reqs + fresh},
            r1_killed_by_replica_kill=bool(r1_exits) and r1_exits[0] == FLEET_KILL_EXIT,
            breaker_walk=bool(walk) and walk[0] == ("closed", "open") and ("open", "half_open") in walk
            and walk[-1] == ("half_open", "closed"),
            fresh_served_by_rejoined_r1=bool(on_r1))
        spans["kill"] = nd_api.flush()

        # ---- (b) router HA: the leader child journals a wave over the same
        # replicas and dies at its first pump; a standby here takes over
        jdir = os.path.join(work, "journal")
        ha_wave = [(r.rid + FLEET_HA_BASE, list(r.prompt), r.max_new_tokens) for r in serve_reqs]
        with open(spec_path + ".tmp", "w") as f:
            json.dump(dict(replicas={s.spec.replica_id: s.spec.url for s in k_sup.managed.values()},
                           journal_dir=jdir, lease_path=os.path.join(jdir, "LEASE"),
                           ttl_s=FLEET_TTL_S, router=FLEET_ROUTER, wave=ha_wave,
                           trace=os.path.join(trace["kill"], "leader.spans.jsonl")), f)
        t_b = time.perf_counter()
        os.replace(spec_path + ".tmp", spec_path)
        try:
            rc = leader.wait(timeout=120)
        except subprocess.TimeoutExpired:
            rc = None
        t_dead = time.perf_counter()
        leader_log.seek(0)
        leader_text = leader_log.read()
        check(rc == FLEET_KILL_EXIT, f"fleet: the leader exited {rc}: {leader_text[-3000:]}")
        standby = StandbyRouter(jdir, {s.spec.replica_id: HttpReplicaClient(s.spec.url)
                                       for s in k_sup.managed.values()},
                                holder="standby", router_kwargs=FLEET_ROUTER)
        tail = standby.tail()
        fr2, deadline = None, time.monotonic() + 60
        while fr2 is None:
            check(time.monotonic() < deadline, "fleet: the standby never took over")
            k_sup.poll()
            t_try = time.perf_counter()
            fr2 = standby.poll()
            if fr2 is None:
                time.sleep(0.02)
        replay_s = time.perf_counter() - t_try
        rec = dict(fr2.recovery)
        fleet_drain(fr2, k_sup)
        fr2.fleet_ledger_check()
        srv = fr2.start_ops(0)
        try:
            fleet_feed = http_json(f"{srv.url}/fleet")
        finally:
            fr2.stop_ops()
        ha_streams = fleet_streams(fr2)
        out["ha"] = dict(wall_s=time.perf_counter() - t_b, leader_exit=rc,
                         leader_alive_s=t_dead - t_b, ttl_wait_s=t_try - t_dead, replay_s=replay_s,
                         takeover_s=time.perf_counter() - t_dead, tail=tail, recovery=rec,
                         counts=dict(fr2.ledger.counts), journal=fr2.journal.stats(),
                         fleet_ha=fleet_feed.get("ha", {}).get("role"))
        checks["ha"] = dict(
            tail_epoch_1=tail["epoch"] == 1 and tail["pending"] == len(ha_wave),
            takeover_at_epoch_2=rec["takeover"] and rec["epoch"] == 2 and fr2.epoch == 2,
            nothing_quarantined=rec["quarantined"] == 0 and rec["torn"] == 0,
            zero_lost_or_duplicated=fr2.ledger.counts["completed"] == len(ha_wave)
            and fr2.ledger.counts["submitted"] == len(ha_wave) and sorted(fr2.ledger.records)
            == sorted(r for r, _, _ in ha_wave),
            streams_bitwise_golden=ha_streams == {r + FLEET_HA_BASE: golden[r]
                                                  for r in (q.rid for q in serve_reqs)},
            fleet_leader_at_epoch_2=fleet_feed["ha"]["role"] == "leader"
            and fleet_feed["ha"]["epoch"] == 2 and fleet_feed["schema_version"] == 5)
        spans["ha"] = nd_api.flush()
        for rid in list(k_sup.managed):
            k_sup.drain(rid)  # SIGTERM now; reaped at the end

        # ---- (c) autoscale + rollout on the replica started at (a)
        telemetry.init(out_dir=None, jsonl=False, memtrack=False, timeseries=True, alerts=True,
                       costaudit=False, timeseries_cadence_s=0.0)
        fr_a = FleetRouter(**FLEET_ROUTER)
        fr_a.add_replica("r0", HttpReplicaClient(a_sup.managed["r0"].spec.url))
        fleet_up(fr_a, a_sup)
        auto = Autoscaler(fr_a, a_sup, "r0", client_factory=lambda sp: HttpReplicaClient(sp.url),
                          min_replicas=1, max_replicas=2, up_burn=1.0, down_burn=0.5, up_queue=4,
                          up_hold_s=0.3, down_hold_s=1.5, cooldown_s=2.0, window_s=3.0, tick_s=0.05)
        t_c = time.perf_counter()
        end = time.monotonic() + 1.0  # a quiet second: the store's window starts empty
        while time.monotonic() < end:
            a_sup.poll()
            fr_a.pump()
            auto.tick()
            time.sleep(0.05)
        marks = {}

        def tick():
            d = auto.tick()
            if d.startswith("scale_up") and "up" not in marks:
                marks["up"] = (time.perf_counter(), dict(auto.last_signals))
            return d

        t_spike = time.perf_counter()
        per = -(-len(spike) // AUTOSCALE_BURSTS)
        for k in range(0, len(spike), per):  # open-loop bursts, the router turning between them
            fleet_submit(fr_a, spike[k:k + per])
            end = time.monotonic() + AUTOSCALE_BURST_S
            while time.monotonic() < end:
                a_sup.poll()
                fr_a.pump()
                tick()
                time.sleep(0.02)
        fleet_wait("a scale-up", lambda: tick() and "up" in marks, fr_a, a_sup, 60.0, pump=True)
        scale_up_s, sig = marks["up"][0] - t_spike, marks["up"][1]
        clone = next(r for r in fr_a.replicas if r != "r0")
        # no ticks while the clone starts: once r0 has drained what it
        # admitted, the quiet queue would drain the clone before it came up
        readmit_s = fleet_wait("the clone readmitted", lambda: fr_a.replicas[clone].feed is not None
                               and fr_a.replicas[clone].breaker.state == "closed",
                               fr_a, a_sup, 240.0, pump=True)
        rounds = fleet_complete_all(fr_a, a_sup, spike, autoscaler=auto)
        spike_s = time.perf_counter() - t_spike
        fr_a.poll(force=True)
        ttft_spike = (fr_a.replicas["r0"].feed or {}).get("ttft_s", {}).get("p99")
        ttft_clone = (fr_a.replicas[clone].feed or {}).get("ttft_s", {}).get("p99")
        spike_streams = fleet_streams(fr_a, {r.rid for r in spike})
        clone_closes = fr_a.replicas[clone].breaker.closes
        t = time.perf_counter()
        diverge = RolloutController(fr_a, ckpt_root, CANARY_PROMPTS, max_new_tokens=4, canary=True,
                                    baseline=True, stage_timeout_s=180.0).run()
        diverge_s = time.perf_counter() - t
        t = time.perf_counter()
        clean = RolloutController(fr_a, ckpt_root, CANARY_PROMPTS, max_new_tokens=4, canary=True,
                                  baseline=True, stage_timeout_s=180.0).run()
        clean_s = time.perf_counter() - t
        fleet_submit(fr_a, wave2, sessions=False)
        fleet_complete_all(fr_a, a_sup, wave2)
        wave2_streams = fleet_streams(fr_a, {r.rid for r in wave2})
        t_quiet = time.perf_counter()
        down = {}

        def scaled_down():
            d = auto.tick()
            if d.startswith("scale_down"):
                down.setdefault("decided", time.perf_counter())
            return "decided" in down and len(fr_a.replicas) == 1

        fleet_wait("the clone drained away", scaled_down, fr_a, a_sup, 120.0, pump=True)
        fr_a.fleet_ledger_check()
        out["autoscale"] = dict(
            wall_s=time.perf_counter() - t_c, spike=len(spike), signals_at_scale_up=sig,
            scale_up_after_spike_s=scale_up_s, clone=clone, clone_readmit_s=readmit_s,
            spike_wall_s=spike_s, resubmit_rounds=rounds, ttft_p99_spike_s=ttft_spike,
            ttft_p99_clone_s=ttft_clone, counts=dict(fr_a.ledger.counts),
            rollout_diverge=dict(diverge, seconds=diverge_s),
            rollout_clean=dict(clean, seconds=clean_s),
            scale_down_decided_s=down["decided"] - t_quiet,
            scale_down_removed_s=time.perf_counter() - t_quiet,
            store_queue_depth=telemetry.timeseries.get_store().reduce(
                "fleet_timeline_queue_depth", 600.0, "max"))
        checks["autoscale"] = dict(
            scaled_up_once=auto.scale_ups == 1 and sig["queue_depth"] is not None
            and sig["queue_depth"] >= 4,
            clone_readmitted_by_probe=clone_closes >= 1,
            spike_bitwise_golden=spike_streams == {r.rid: golden[r.rid] for r in spike},
            diverge_rolled_back_fleet_wide=diverge["ok"] is False and diverge["diverged"] == "r0"
            and diverge["committed"] == [] and "deterministic" in (diverge["reason"] or ""),
            clean_committed_on_both=clean["ok"] is True and sorted(clean["committed"]) == ["r0", clone],
            wave2_bitwise_golden=wave2_streams == {r.rid: golden[r.rid] for r in wave2},
            scaled_down_once=auto.scale_downs == 1 and not a_sup.alive(clone)
            and list(fr_a.replicas) == ["r0"])
        spans["auto"] = nd_api.flush()
        nd_api.deinit_ndtimers()
        telemetry.shutdown()
        rcs = {f"{f}/{k}": v for f, sup in (("golden", g_sup), ("kill", k_sup), ("auto", a_sup))
               for k, v in sup.stop_all(grace_s=60.0).items()}
        checks["exits"] = dict(all_0=all(v == 0 for v in rcs.values()))
        # each incarnation's start-up: its spawn to the end of its warm-up
        ready = {}
        for f, sup in (("golden", g_sup), ("kill", k_sup), ("auto", a_sup)):
            for rid, m in sup.managed.items():
                with open(m.spec.log_path, errors="replace") as fh:
                    ready[f"{f}/{rid}"] = [json.loads(ln) for ln in fh
                                           if ln.startswith('{"replica_ready_wall"')]
        spawned = {}
        for kind, r, w in events:
            if kind in ("spawn", "restart", "spawn_like"):
                spawned.setdefault(r, []).append(w)
        out["startup_s"] = {r: [x["replica_ready_wall"] - w for x, w in zip(ready.get(r, []), ws)]
                            for r, ws in spawned.items()}
        out["warmup_s"] = {r: [x["warmup_s"] for x in xs] for r, xs in ready.items()}
        # where a start-up goes: interpreter and imports (spawn to entry),
        # the engine's build, then the warm-up's engine calls
        out["startup_split_s"] = {
            r: [dict(imports=x["entered_wall"] - w, engine=x["engine_s"],
                     warmup_calls=[[n, round(d, 4)] for n, d in x["warmup_calls"]])
                for x, w in zip(ready.get(r, []), ws)] for r, ws in spawned.items()}

        # ---- (d) fleettrace: the router's streams and every replica's
        def replica_streams(fleet, prefix):
            got = {}
            for name in sorted(os.listdir(trace[fleet])):
                if name.endswith(".spans.jsonl"):
                    got[f"{prefix}/{name[:-len('.spans.jsonl')]}"] = parse_raw_spans(
                        os.path.join(trace[fleet], name))
            return got

        g_rep, k_rep, a_rep = (replica_streams(f, f) for f in ("golden", "kill", "auto"))
        leader_stream = k_rep.pop("kill/leader", [])
        sync = FleetClockSync({f"kill/{k}": v for k, v in clock.offsets_us.items()},
                              {f"kill/{k}": v for k, v in clock.residual_us.items()}, clock.rounds)
        legs = {"golden": (fr_g, {"router/golden": spans["golden"], **g_rep}),
                "kill": (fr_k, {"router/kill": spans["kill"], **k_rep}),
                "ha": (fr2, {"router/ha": spans["ha"], "router/leader": leader_stream, **k_rep}),
                "auto": (fr_a, {"router/auto": spans["auto"], **a_rep})}
        problems = {}
        for leg, (fr, streams) in legs.items():
            merged = assemble_fleet_timeline(streams, clock=sync if leg in ("kill", "ha") else None)
            problems[leg] = verify_fleet_journeys(merged, fr.ledger, require_stitch=True)
        every_stream = {"router/leader": leader_stream, **g_rep, **k_rep, **a_rep,
                        **{f"router/{k}": v for k, v in spans.items()}}
        merged = assemble_fleet_timeline(every_stream, clock=sync)
        metric_counts = {}
        for sp in merged:
            if sp.metric.startswith("fleet-"):
                metric_counts[sp.metric] = metric_counts.get(sp.metric, 0) + 1
        stage_s = {}
        for sp in merged:
            if sp.metric == "fleet-rollout-stage":
                key = f"{sp.tags['replica']}:{sp.tags['stage']}"
                stage_s.setdefault(key, []).append(round(sp.duration, 6))
        out["trace"] = dict(streams={k: len(v) for k, v in every_stream.items()},
                            fleet_spans=metric_counts, problems=problems,
                            rollout_stage_s=stage_s)
        checks["trace"] = dict(
            journeys_verified={leg: not p for leg, p in problems.items()},
            has_spans={m: metric_counts.get(m, 0) > 0 for m in (
                "fleet-scale", "fleet-rollout-stage", "fleet-recover", "fleet-takeover",
                "fleet-submit", "fleet-dispatch-attempt", "fleet-terminal", "fleet-breaker")})

        # ---- (e) the router's own costs against the replicas' decode step
        per_req = statistics.mean(len(v) for v in g_streams.values())
        out["costs"] = fleet_costs(work, decode_p50, per_req)

        # ---- the kernels the replicas launched (clean exits only)
        reports = [dict(r, fleet=f) for f, sup in (("golden", g_sup), ("kill", k_sup), ("auto", a_sup))
                   for r in fleet_reports(sup)]
        launches = {k: 0 for k in kernels_mod.LAUNCHES}
        for r in reports:
            for k, v in r["launches"].items():
                launches[k] += v
        out["replicas"] = [{k: r[k] for k in ("fleet", "replica", "replica_status", "launches",
                                              "prefills", "decode_steps")} for r in reports]
        checks["launches"] = dict(
            clean_exits_reported=len(reports) == 8,
            match_scheduler=all(r["launches"]["flash_fwd"] == L * r["prefills"]
                                and r["launches"]["paged_decode"] == L * r["decode_steps"]
                                for r in reports if r["fleet"] != "auto"),
            cover_scheduler=all(r["launches"]["flash_fwd"] >= L * r["prefills"]
                                and r["launches"]["paged_decode"] >= L * r["decode_steps"]
                                for r in reports),
            k1_and_k7_launched=launches["flash_fwd"] > 0 and launches["paged_decode"] > 0)
        out.update(launches=launches, exit_codes=rcs, card=card,
                   phase_s=time.perf_counter() - t_phase)
    finally:
        for sup in sups:
            sup.stop_all(grace_s=30.0)
        if leader is not None and leader.poll() is None:
            leader.kill()
            leader.wait()
        if nd_api.is_active():
            nd_api.deinit_ndtimers()
        if telemetry.is_active():
            telemetry.shutdown()
        leader_log.close()
        shutil.rmtree(work, ignore_errors=True)
    out["checks"] = checks

    def failed(c):
        if isinstance(c, dict):
            return {k: v for k, v in ((k, failed(v)) for k, v in c.items()) if v is not None} or None
        return None if c else False

    bad = failed(checks)
    check(not bad, f"fleet checks failed: {json.dumps(bad)} {json.dumps(out, default=str)[:6000]}")
    return out


# -------------------------------------------------------------------- spmd
def _pieces_bitwise(x, d) -> bool:
    """A one-rank DArray's piece is the whole tensor (flat when ragged)."""
    loc = d.to_local()
    return torch.equal(loc, x.reshape(loc.shape))


def spmd_nccl_round_trips(mesh, leaves):
    """Every placement kind and the transitions between them through a
    one-rank NCCL mesh at full width: each piece, full tensor and
    redistributed tensor bitwise its input."""
    from vescale_tpu_torch import api
    from vescale_tpu_torch.darray import distribute_tensor, from_local
    from vescale_tpu_torch.placements import (InterleavedShard, Partial, RaggedShard, Replicate,
                                              Shard, StridedRaggedShard)

    kinds = {"shard0": Shard(0), "shard1": Shard(1), "interleaved": InterleavedShard(0, 2),
             "replicate": Replicate(), "partial_sum": Partial("sum"), "partial_avg": Partial("avg"),
             "partial_max": Partial("max"), "ragged": RaggedShard((0, 1), (1,)),
             "strided_ragged": StridedRaggedShard((0, 1), (2,), split_factor=1)}
    hops = [("shard0", "shard1"), ("shard1", "replicate"), ("replicate", "interleaved"),
            ("interleaved", "shard0"), ("ragged", "replicate"), ("replicate", "ragged"),
            ("strided_ragged", "ragged"), ("partial_sum", "shard0"), ("partial_avg", "replicate"),
            ("partial_max", "shard1"), ("replicate", "partial_sum")]
    out = {}
    for name, x in leaves.items():
        row = {}
        for k, p in kinds.items():
            d = distribute_tensor(x, mesh, [p])
            row[f"{k}.to_local"] = _pieces_bitwise(x, d)
            row[f"{k}.full_tensor"] = torch.equal(d.full_tensor(), x)
            del d
        for a, b in hops:
            d = distribute_tensor(x, mesh, [kinds[a]]).redistribute(placements=[kinds[b]])
            row[f"{a}->{b}"] = _pieces_bitwise(x, d) and torch.equal(d.full_tensor(), x)
            del d
        g = api.vescale_all_gather(distribute_tensor(x, mesh, [Shard(0)]))
        r = api.vescale_all_reduce(from_local(x, mesh, [Partial()]))
        s = api.vescale_reduce_scatter(from_local(x, mesh, [Partial()]), scatter_dim=1)
        row["vescale_all_gather"] = torch.equal(g.to_local(), x)
        row["vescale_all_reduce"] = torch.equal(r.to_local(), x)
        row["vescale_reduce_scatter"] = torch.equal(s.to_local(), x) and s.placements == (Shard(1),)
        del g, r, s
        out[name] = row
        free_memory()
    return out


def spmd_virtual_layouts(dev, leaves):
    """Every rank's piece of 8-rank layouts (a 1-D mesh of 8, a 2-D 2x4)
    computed in this process with the ``rank=`` path and reassembled:
    bitwise the leaf.  Then one ragged -> ragged transition, rank by rank,
    through ``redistribute_local_tensor``: bitwise the slice of the leaf,
    its peak allocation above the inputs within the destination piece plus
    2 MiB (the logical tensor would be 8-16x that)."""
    from vescale_tpu_torch.darray import distribute_tensor
    from vescale_tpu_torch.mesh import DeviceMesh
    from vescale_tpu_torch.placements import (InterleavedShard, RaggedShard, Replicate, Shard,
                                              StridedRaggedShard)
    from vescale_tpu_torch.redistribute import redistribute_local_tensor
    from vescale_tpu_torch.spec import DArraySpec, TensorMeta

    m8 = DeviceMesh(("x",), (8,), device_type="cuda")
    m24 = DeviceMesh(("dp", "tp"), (2, 4), device_type="cuda")
    emb, down = leaves["embedding"], leaves["down_proj"]
    # the 8B's first 128,250 rows: 8 chunks of 16,032, the last 16,026
    cut = f"embedding[:{emb.shape[0] - 6}]"
    uneven = emb.narrow(0, 0, emb.shape[0] - 6)
    cases = [("embedding", emb, m8, [Shard(0)]), (cut, uneven, m8, [Shard(0)]),
             ("down_proj", down, m8, [Shard(1)]), ("down_proj", down, m8, [InterleavedShard(0, 2)]),
             ("embedding", emb, m8, [RaggedShard((0, 1), (1, 2, 3, 2, 1, 3, 3, 1))]),
             ("down_proj", down, m24, [Shard(0), StridedRaggedShard((0, 1), (1, 2, 3, 2), split_factor=2)]),
             ("embedding", emb, m24, [Shard(0), Shard(1)]),
             ("down_proj", down, m24, [Shard(1), InterleavedShard(0, 2)]),
             (cut, uneven, m24, [Shard(0), Shard(0)])]
    rows = []
    for name, x, m, pls in cases:
        pieces = [distribute_tensor(x, m, pls, rank=r).to_local() for r in range(m.size())]
        meta = TensorMeta(tuple(x.shape), x.dtype)
        full = redistribute_local_tensor(pieces, DArraySpec(m, pls, meta),
                                         DArraySpec(m, [Replicate()] * m.ndim, meta), rank=0)
        rows.append(dict(leaf=name, mesh=list(m.shape), placements=[str(p) for p in pls],
                         piece_rows=[int(t.shape[0]) for t in pieces], bitwise=torch.equal(full, x)))
        del pieces, full
        free_memory()

    src_pl, dst_pl = RaggedShard((0, 1), (1, 2, 3, 2, 1, 3, 3, 1)), RaggedShard((0, 1), (2,) * 8)
    meta = TensorMeta(tuple(emb.shape), emb.dtype)
    src, dst = DArraySpec(m8, [src_pl], meta), DArraySpec(m8, [dst_pl], meta)
    pieces = [distribute_tensor(emb, m8, [src_pl], rank=r).to_local() for r in range(8)]
    flat = emb.reshape(-1)
    sizes, offs = dst_pl.local_sizes_and_offsets(flat.numel())
    item = emb.element_size()
    ragged = dict(bitwise=[], peak_above_inputs_bytes=[], bound_bytes=[], logical_bytes=flat.numel() * item)
    for r in range(8):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        got = redistribute_local_tensor(pieces, src, dst, rank=r)
        torch.cuda.synchronize()
        ragged["peak_above_inputs_bytes"].append(torch.cuda.max_memory_allocated(dev) - base)
        ragged["bound_bytes"].append(sizes[r] * item + (2 << 20))
        ragged["bitwise"].append(torch.equal(got, flat.narrow(0, offs[r], sizes[r])))
        del got
    ragged["within_bound"] = all(a <= b for a, b in zip(ragged["peak_above_inputs_bytes"],
                                                        ragged["bound_bytes"]))
    del pieces
    free_memory()
    return rows, ragged


def spmd_rng(dev, leaves):
    """uniform and dropout (p = 0.1) drawn whole and drawn shard by shard
    (boxes of an 8-way Shard(0) for GPT-2's activation shape; the pieces of
    a 2x4 [Shard(1), InterleavedShard(0, 2)] layout, by global index, for
    the MLP shape): bitwise equal.  Device ms of each whole draw."""
    from vescale_tpu_torch import random as R
    from vescale_tpu_torch.mesh import DeviceMesh
    from vescale_tpu_torch.placements import InterleavedShard, Shard
    from vescale_tpu_torch.spec import DArraySpec, TensorMeta

    k = R.key(0)
    out = {}
    act = torch.randn((12, 1024, 768), generator=torch.Generator(device=dev).manual_seed(1),
                      device=dev, dtype=torch.bfloat16)
    down = leaves["down_proj"]
    for name, x in (("gpt2_activation_12x1024x768", act), ("mlp_14336x4096", down)):
        shape = tuple(x.shape)
        u = R.uniform(shape, key=k, device=dev)
        dr = R.dropout(x, 0.1, key=k)
        u_ok, d_ok = [], []
        if name.startswith("gpt2"):
            for r in range(8):
                sz, off = Shard(0).local_shard_size_and_offset(shape[0], 8, r)
                goff = (off,) + (0,) * (len(shape) - 1)
                box = (sz,) + shape[1:]
                u_ok.append(torch.equal(R.uniform(box, key=k, device=dev, global_offset=goff,
                                                  global_shape=shape), u.narrow(0, off, sz)))
                d_ok.append(torch.equal(R.dropout(x.narrow(0, off, sz).contiguous(), 0.1, key=k,
                                                  global_offset=goff, global_shape=shape),
                                        dr.narrow(0, off, sz)))
        else:
            m24 = DeviceMesh(("dp", "tp"), (2, 4), device_type="cuda")
            spec = DArraySpec(m24, [Shard(1), InterleavedShard(0, 2)], TensorMeta(shape, x.dtype))
            for r in range(8):
                c = m24.coordinate_of_rank(r)
                idx = R.linear_index(spec.index_set(c), shape, dev)
                u_ok.append(torch.equal(R.uniform(idx.shape, key=k, device=dev, index=idx),
                                        spec.local_from_full(u, c)))
                d_ok.append(torch.equal(R.dropout(spec.local_from_full(x, c), 0.1, key=k, index=idx),
                                        spec.local_from_full(dr, c)))
                del idx
        kept = float((dr != 0).float().mean()) if name.startswith("mlp") else None
        del u, dr
        free_memory()
        out[name] = dict(uniform_bitwise=u_ok, dropout_bitwise=d_ok, dropout_kept_share=kept,
                         uniform_ms=cuda_ms(lambda: R.uniform(shape, key=k, device=dev), iters=5, warmup=1),
                         dropout_ms=cuda_ms(lambda: R.dropout(x, 0.1, key=k), iters=5, warmup=1))
        free_memory()
    return out


def spmd_sharded_materialize(dev, cfg, params):
    """The 8B's parameters materialized as rank 3's Shard(0) pieces of a
    layout-only mesh of 8: bitwise the serve weights' rows, and the peak
    allocation above the start within every piece plus the largest full
    leaf and its piece plus 2 MiB (the eager tree would be the whole
    model).  Timed twice: the first call also loads torch's meta kernels."""
    from vescale_tpu_torch.darray import distribute_tensor
    from vescale_tpu_torch.initialize import materialize_module
    from vescale_tpu_torch.mesh import DeviceMesh
    from vescale_tpu_torch.models import init_params
    from vescale_tpu_torch.placements import Shard

    m8 = DeviceMesh(("x",), (8,), device_type="cuda")
    free_memory()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    tree = materialize_module(init_params, [Shard(0)], cfg, seed=0, dtype=torch.bfloat16, mesh=m8,
                              rank=3)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(dev) - base
    pieces, fulls, bitwise = [], [], True

    def walk(node, ref):
        nonlocal bitwise
        if isinstance(node, dict):
            for k in node:
                walk(node[k], ref[k])
            return
        want = distribute_tensor(ref, m8, [Shard(0)], rank=3).to_local()
        bitwise = bitwise and torch.equal(node.to_local(), want)
        pieces.append(node.to_local().nbytes)
        fulls.append(ref.nbytes)

    walk(tree, params)
    del tree
    free_memory()
    t = time.perf_counter()  # again, without the first call's one-time set-up
    tree = materialize_module(init_params, [Shard(0)], cfg, seed=0, dtype=torch.bfloat16, mesh=m8,
                              rank=3)
    torch.cuda.synchronize()
    del tree
    again_s = time.perf_counter() - t
    free_memory()
    bound = sum(pieces) + max(fulls) + max(pieces) + (2 << 20)
    return dict(materialize_s=seconds, again_s=again_s, peak_above_start_bytes=peak, bound_bytes=bound,
                pieces_bytes=sum(pieces), largest_leaf_bytes=max(fulls), model_bytes=sum(fulls),
                leaves=len(fulls), bitwise=bitwise, within_bound=peak <= bound)


def run_spmd_phase(dev, eng, kernels_mod, serve_streams, card):
    """The SPMD core on the card (module docstring)."""
    import torch.distributed as dist

    from vescale_tpu_torch import collectives
    from vescale_tpu_torch.initialize import deferred_init, is_deferred, materialize_module
    from vescale_tpu_torch.mesh import init_device_mesh
    from vescale_tpu_torch.models import init_params
    from vescale_tpu_torch.placements import Replicate
    from vescale_tpu_torch.serve import ServeEngine

    cfg = eng.config
    leaves = {"embedding": eng.params["embed_tokens"]["embedding"],
              "down_proj": eng.params["layers_0"]["mlp"]["down_proj"]["kernel"]}
    out, checks = {}, {}
    from vescale_tpu_torch import distributed as D

    D.initialize(f"127.0.0.1:{free_port()}", 1, 0, device_type="cuda", timeout_s=120)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("dp",))
        collectives.reset_calls()
        t = time.perf_counter()
        round_trips = spmd_nccl_round_trips(mesh, leaves)
        torch.cuda.synchronize()
        calls = dict(collectives.CALLS)
        out["nccl"] = dict(seconds=time.perf_counter() - t, leaves={k: list(v.shape) for k, v in leaves.items()},
                           checks=round_trips, calls=calls,
                           nccl_calls=sum(v for k, v in calls.items() if k.startswith("nccl.")))
        checks["nccl_round_trips_bitwise"] = all(all(r.values()) for r in round_trips.values())
        checks["nccl_only"] = out["nccl"]["nccl_calls"] > 0 and out["nccl"]["nccl_calls"] == sum(calls.values())

        t = time.perf_counter()
        layouts, ragged = spmd_virtual_layouts(dev, leaves)
        out["virtual_layouts"] = dict(seconds=time.perf_counter() - t, layouts=layouts, ragged=ragged)
        checks["virtual_layouts_bitwise"] = all(r["bitwise"] for r in layouts)
        checks["ragged_transition_bitwise"] = all(ragged["bitwise"])
        checks["ragged_transition_within_bound"] = ragged["within_bound"]

        t = time.perf_counter()
        rng = spmd_rng(dev, leaves)
        out["rng"] = dict(seconds=time.perf_counter() - t, **rng)
        checks["rng_sharded_equals_whole"] = all(all(v["uniform_bitwise"]) and all(v["dropout_bitwise"])
                                                 for v in rng.values())

        t = time.perf_counter()
        sharded = spmd_sharded_materialize(dev, cfg, eng.params)
        out["sharded_materialize"] = dict(seconds=time.perf_counter() - t, card=card, **sharded)
        checks["sharded_materialize_bitwise"] = sharded["bitwise"]
        checks["sharded_materialize_within_bound"] = sharded["within_bound"]

        # Llama-3-8B from deferred-init DArrays on the one-rank mesh
        t = time.perf_counter()
        before = torch.cuda.memory_allocated(dev)
        meta = deferred_init(init_params, cfg, seed=0, dtype=torch.bfloat16)
        deferred = is_deferred(meta) and torch.cuda.memory_allocated(dev) == before
        del meta
        torch.cuda.synchronize()
        t_mat = time.perf_counter()
        tree = materialize_module(init_params, [Replicate()], cfg, seed=0, dtype=torch.bfloat16, mesh=mesh)
        torch.cuda.synchronize()
        materialize_s = time.perf_counter() - t_mat
        same = _trees_bitwise(tree, eng.params)
        mesh_eng = ServeEngine(cfg, tree, eng.cache, mesh=mesh)
        mesh_eng.replay_greedy([1, 2, 3], 2)  # loads cuBLAS paths and captures the decode graph
        run, streams = serve_run(dev, mesh_eng, serve_requests(cfg.vocab_size), kernels_mod)
        del mesh_eng, tree
        free_memory()
        out["mesh_serve"] = dict(seconds=time.perf_counter() - t, materialize_s=materialize_s,
                                 deferred_allocated_nothing=deferred, weights_bitwise_serve=same,
                                 streams_equal_serve=streams == serve_streams, card=card, **run)
        checks["deferred"] = deferred
        checks["weights_bitwise_serve"] = same
        checks["mesh_serve"] = run["checks"]
        checks["mesh_streams_equal_serve"] = streams == serve_streams
        out["launches"] = run["launches"]
    finally:
        dist.destroy_process_group()
    out["checks"] = checks
    check(all(v if isinstance(v, bool) else all(v.values()) for v in checks.values()),
          f"spmd checks failed: {checks}")
    return out


# -------------------------------------------------------------- checkpoint
def _dir_bytes(root: str, sub: str):
    """(files, bytes) of the chunk files under ``root/data/<sub>``."""
    files = nbytes = 0
    for dirpath, _dirs, names in os.walk(os.path.join(root, "data", sub)):
        for n in names:
            files += 1
            nbytes += os.path.getsize(os.path.join(dirpath, n))
    return files, nbytes


def _leaves_bitwise(a, b) -> bool:
    from vescale_tpu_torch.checkpoint.planner import flatten_state

    fa, fb = flatten_state(a), flatten_state(b)
    return [k for k, _ in fa] == [k for k, _ in fb] and all(
        x.dtype == y.dtype and torch.equal(x, y) for (_, x), (_, y) in zip(fa, fb))


def rollout_run(eng, arrivals, kernels_mod, root, schedule=None):
    """The serve requests through ``run_serve_resilient`` with a
    ``ControlChannel``: at step 2 a ``reload`` of ``root`` (baseline, canary,
    two prompts), and a ``commit`` once the reload has committed.  Returns
    the run's row, its stage seconds, the rollout states in order, its
    streams and whether every kernel launch is accounted for (the serve
    steps plus the baseline and canary replays)."""
    from vescale_tpu_torch.serve import ControlChannel

    control = ControlChannel()
    mnt, prompts = 8, [[1, 2, 3, 4], [5, 6, 7, 8, 9, 10]]
    posted = []

    def on_step(step, active):
        st = control.state
        if step == 2:
            posted.append(control.provider({"op": "reload", "checkpoint": root, "prompts": prompts,
                                             "max_new_tokens": mnt, "canary": True,
                                             "baseline": True}))
        elif (st and st["state"] == "committed" and not st["detail"]["finalized"]
              and len(posted) == 1):
            posted.append(control.provider({"op": "commit"}))

    row, res, sched = resilient_run(eng, arrivals, kernels_mod, schedule=schedule, control=control,
                                    on_step=on_step)
    events = sched.telemetry.events
    states = [e["kind"][len("serve_rollout_"):] for e in events
              if e["kind"].startswith("serve_rollout_") and e["kind"] != "serve_rollout_stage"]
    stages = {e["stage"]: e["seconds"] for e in events if e["kind"] == "serve_rollout_stage"}
    replays = 3 * len(prompts)  # the baseline once, the canary twice
    L = eng.config.num_hidden_layers
    launches_ok = (row["launches"]["flash_fwd"] == L * (row["prefills"] + replays)
                   and row["launches"]["paged_decode"] == L * (row["decode_steps"]
                                                              + replays * (mnt - 1)))
    row.update(states=states, stage_seconds=stages, final=control.state["state"],
               reason=control.state["detail"].get("reason"), posted=posted)
    return row, completed_streams(res), launches_ok


def checkpoint_breakdown(root: str, eng) -> dict:
    """Where the save's and the restore's time goes, leg by leg, on the
    embedding (one 1,050,673,152-byte chunk) and the chunk files of the
    embedding, the head and layers 0-1: the host copy and serialization a
    save does on its own thread (``array_to_bytes``), the plain file read,
    and the pageable copy to the card a restore does."""
    from vescale_tpu_torch.checkpoint.storage import array_to_bytes, bytes_to_array

    emb = eng.params["embed_tokens"]["embedding"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    data = array_to_bytes(emb)
    serialize_s = time.perf_counter() - t
    files = [os.path.join(dirpath, n)
             for sub in ("embed_tokens", "lm_head", "layers_0", "layers_1")
             for dirpath, _d, names in os.walk(os.path.join(root, "data", "model", sub))
             for n in names]
    t = time.perf_counter()
    nread = 0
    for path in files:
        with open(path, "rb") as f:
            nread += len(f.read())
    read_s = time.perf_counter() - t
    host = torch.from_numpy(bytes_to_array(data).view(np.int16).copy())
    torch.cuda.synchronize()
    t = time.perf_counter()
    on_card = host.to(emb.device)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t
    equal = torch.equal(on_card.view(torch.bfloat16).reshape(emb.shape), emb)
    return dict(serialize_gb_per_s=len(data) / serialize_s / 1e9, serialize_s=serialize_s,
                read_bytes=nread, read_s=read_s, read_gb_per_s=nread / read_s / 1e9,
                h2d_s=h2d_s, h2d_gb_per_s=host.nbytes / h2d_s / 1e9, h2d_bitwise=equal)


def run_checkpoint_phase(dev, eng, eager, kernels_mod, serve_streams, card):
    """The checkpoint on the card (module docstring)."""
    from vescale_tpu_torch import checkpoint as ckpt
    from vescale_tpu_torch.checkpoint import elastic, native_io
    from vescale_tpu_torch.checkpoint.planner import flatten_state
    from vescale_tpu_torch.darray import distribute_tensor, empty
    from vescale_tpu_torch.mesh import DeviceMesh
    from vescale_tpu_torch.models import init_params
    from vescale_tpu_torch.placements import Replicate, Shard
    from vescale_tpu_torch.serve import load_params

    cfg = eng.config
    out, checks = {}, {}
    tmp = tempfile.mkdtemp(prefix="vtt_ckpt_")  # outside the checkout
    try:
        root = os.path.join(tmp, "ckpt")
        # the serve weights as Replicate pieces of a one-rank mesh (the
        # tensors themselves, no copy): the writer's world carries a mesh,
        # so the rank-3 restore below crosses worlds
        m1 = DeviceMesh(("dp",), (1,), device_type="cuda")

        def on_m1(node):
            if isinstance(node, dict):
                return {k: on_m1(v) for k, v in node.items()}
            return distribute_tensor(node, m1, [Replicate()], rank=0)

        state = {"model": on_m1(eng.params),
                 "optimizer": {"mu": eng.params["norm"]["weight"].float() * 0.5, "count": 7}}
        native_io.reset_writes()
        torch.cuda.synchronize()
        t = time.perf_counter()
        ckpt.save(root, state)
        save_s = time.perf_counter() - t
        del state
        model_files, model_bytes = _dir_bytes(root, "model")
        opt_files, opt_bytes = _dir_bytes(root, "optimizer")
        written = dict(native_io.WRITES)
        out["save"] = dict(seconds=save_s, bytes=model_bytes + opt_bytes, model_bytes=model_bytes,
                           files=model_files + opt_files, gb_per_s=(model_bytes + opt_bytes) / save_s / 1e9,
                           native_writes=written, free_bytes_at_root=_free_bytes(tmp), card=card)
        checks["native_pool_wrote_every_chunk"] = (written["files"] == model_files + opt_files
                                                    and written["bytes"] == model_bytes + opt_bytes)

        template = init_params(cfg, device="meta", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        t = time.perf_counter()
        restored = load_params(root, template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        stats = dict(ckpt.LAST_LOAD_STATS)
        out["restore"] = dict(seconds=restore_s, gb_per_s=stats["bytes_read"] / restore_s / 1e9,
                              stats=stats, card=card)
        checks["restore_bitwise"] = _leaves_bitwise(restored, eng.params)
        checks["restore_on_card"] = restored["norm"]["weight"].device == eng.params["norm"]["weight"].device
        checks["read_model_chunks_only"] = (stats["bytes_read"] == model_bytes
                                            and stats["files_read"] == model_files
                                            and stats["elastic"] == 0)
        out["breakdown"] = dict(card=card, **checkpoint_breakdown(root, eng))

        # serve the 16 requests from the restored tree, then put the original
        # back (bitwise equal; the eager engine holds the original too)
        eng.swap_params(restored)
        del restored
        eng.replay_greedy([1, 2, 3], 2)  # captures the decode graph again
        run, streams = serve_run(dev, eng, serve_requests(cfg.vocab_size), kernels_mod)
        eng.swap_params(eager.params)
        free_memory()
        out["serve"] = dict(card=card, **run)
        checks["serve"] = run["checks"]
        checks["serve_streams_equal_serve"] = streams == serve_streams
        launches = dict(run["launches"])

        # the /control rollout: a checkpoint-equivalence reload that commits,
        # then the same with canary_diverge armed, which rolls back
        arrivals = serve_requests(cfg.vocab_size)
        rolls = {}
        for name, schedule in (("commit", None), ("canary_diverge", "canary_diverge:call=1,count=1")):
            row, streams, launches_ok = rollout_run(eng, arrivals, kernels_mod, root, schedule)
            rolls[name] = dict(card=card, streams_equal_serve=streams == serve_streams,
                               launches_accounted=launches_ok, **row)
            for k, v in row["launches"].items():
                launches[k] += v
            eng.swap_params(eager.params)  # the committed tree out, the original back
            free_memory()
        out["rollout"] = rolls
        checks["rollout_commit"] = dict(
            states=rolls["commit"]["states"] == ["draining", "baseline", "swapping", "canary",
                                                  "committed", "committed"],
            streams=rolls["commit"]["streams_equal_serve"], launches=rolls["commit"]["launches_accounted"],
            counts=rolls["commit"]["counts"]["completed"] == len(arrivals))
        checks["rollout_canary_diverge"] = dict(
            states=rolls["canary_diverge"]["states"] == ["draining", "baseline", "swapping", "canary",
                                                          "rolled_back"],
            reason="deterministic" in (rolls["canary_diverge"]["reason"] or ""),
            fired=rolls["canary_diverge"]["fired"] == {"canary_diverge": 1},
            streams=rolls["canary_diverge"]["streams_equal_serve"],
            launches=rolls["canary_diverge"]["launches_accounted"],
            counts=rolls["canary_diverge"]["counts"]["completed"] == len(arrivals))

        # the embedding and layer 0 as rank 3's Shard(0) pieces of a
        # layout-only mesh of 8 (the rank= path): a restore across worlds
        m8 = DeviceMesh(("x",), (8,), device_type="cuda")

        def piece_template(node):
            if isinstance(node, dict):
                return {k: piece_template(v) for k, v in node.items()}
            return empty(*node.shape, device_mesh=m8, placements=[Shard(0)], dtype=node.dtype, rank=3)

        part = {k: eng.params[k] for k in ("embed_tokens", "layers_0")}
        tmpl = piece_template(part)
        with open(os.path.join(root, "meta.json")) as f:
            report, _elastic = elastic.preflight(json.load(f), {"model": tmpl}, root)
        t = time.perf_counter()
        pieces = load_params(root, tmpl)
        torch.cuda.synchronize()
        cross_s = time.perf_counter() - t
        stats = dict(ckpt.LAST_LOAD_STATS)
        ok = True

        def walk(got, ref):
            nonlocal ok
            if isinstance(got, dict):
                for k in got:
                    walk(got[k], ref[k])
                return
            want = distribute_tensor(ref, m8, [Shard(0)], rank=3).to_local()
            ok = ok and got.rank == 3 and torch.equal(got.to_local(), want)

        walk(pieces, part)
        piece_bytes = sum(x.to_local().nbytes for _, x in flatten_state(pieces))
        del pieces, tmpl
        free_memory()
        out["cross_world"] = dict(seconds=cross_s, stats=stats, piece_bytes=piece_bytes,
                                  findings=report.codes(), card=card)
        checks["cross_world_bitwise"] = ok
        checks["cross_world_elastic"] = stats["elastic"] == 1 and report.codes() == ["VSC130"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = launches
    out["checks"] = checks
    check(all(v if isinstance(v, bool) else all(v.values()) for v in checks.values()),
          f"checkpoint checks failed: {checks}")
    return out


def _free_bytes(path: str) -> int:
    st = os.statvfs(path)
    return st.f_bavail * st.f_frsize


def _trees_bitwise(tree, params) -> bool:
    """Every DArray piece of ``tree`` bitwise the tensor at the same path
    of ``params``."""
    if isinstance(tree, dict):
        return tree.keys() == params.keys() and all(_trees_bitwise(tree[k], params[k]) for k in tree)
    return torch.equal(tree.to_local(), params)


# -------------------------------------------------------------------- main
# --------------------------------------------------------- tensor parallel
TP_WORLD = 2  # ranks of the TP phases, all on the one card
# the 1.3B's depth in tp_train and dp_train: 24 -> 2 layers (full width),
# held to a single-card run at the same depth, so the script with the moe,
# train_leftovers and nd phases stays inside its time (PERF.md §4, §7; 8
# until the train_leftovers phase came, 4 until the nd phase came)
GLOO_13B_LAYERS = 2
# GPT-2's depth where it runs on gloo ranks (tp_train, dp_train,
# train_resilient's two-rank leg and nd's leg (c)): 12 -> 2 layers at full
# width, each held to a single-card run at that depth (PERF.md §4, §7; 4
# until the nd phase came)
GLOO_GPT2_LAYERS = 2
TP_LOSS_REL = 0.01  # the reference's bf16 loss bar (nanogpt_4d_finetune/README.md)
TP_SERVE_BF16_STEPS = 16.0  # teacher-forced logits vs the single-card engine (PERF.md)
TP_FORCED = 1  # teacher-forced requests of the tp_serve check (4 until cut for time)


def tp_spawn(job: str, args: dict, timeout_s: float, names=("tp",), shape=None):
    """``TP_WORLD`` ranks of ``chip_smoke.py --tp-child`` on the one card,
    joined over gloo at a free localhost port (NCCL refuses two ranks on
    one GPU) on a mesh of one dim named ``names``; each runs
    ``TP_JOBS[job](mesh, **args)`` and writes its JSON result.  A rank that
    fails, exits without a result or outlives ``timeout_s`` fails the
    phase; every rank is stopped before this returns.  Returns the results
    in rank order."""
    return tp_spawn_finish(tp_spawn_start(job, args, names, shape=shape), timeout_s)


def tp_spawn_start(job: str, args: dict, names=("tp",), held: bool = False, shape=None) -> dict:
    """Start ``tp_spawn``'s ranks and return at once; ``tp_spawn_finish``
    collects them.  ``held``: the ranks start up (torch, the card, the gloo
    world and mesh) and then wait for ``tp_spawn_release``, which may hand
    them more arguments, so that a phase overlaps their start-up with its
    own work on the card without sharing the card with them.  ``shape``:
    a mesh of that shape over ``names`` (its product of ranks) instead of
    ``TP_WORLD`` ranks on one dim."""
    shape = list(shape) if shape is not None else [TP_WORLD]
    world = int(np.prod(shape))
    port = free_port()
    tmp = tempfile.mkdtemp(prefix="vtt_tp_")
    env = {k: v for k, v in os.environ.items() if not k.startswith("VESCALE_")}
    procs, logs = [], []
    go = os.path.join(tmp, "go.json") if held else None
    for r in range(world):
        spec = os.path.join(tmp, f"spec{r}.json")
        with open(spec, "w") as f:
            json.dump(dict(job=job, rank=r, world=world, port=port, args=args, go=go,
                           names=list(names), shape=shape,
                           out=os.path.join(tmp, f"out{r}.json")), f)
        logs.append(open(os.path.join(tmp, f"log{r}.txt"), "w+"))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                       "--tp-child", spec], env=env, stdout=logs[-1],
                                      stderr=subprocess.STDOUT))
    return dict(job=job, tmp=tmp, procs=procs, logs=logs, go=go)


def tp_spawn_release(spawned: dict, **args) -> None:
    """Let held ranks go on, with ``args`` added to their job's."""
    part = spawned["go"] + ".part"
    with open(part, "w") as f:
        json.dump(args, f)
    os.replace(part, spawned["go"])


def tp_spawn_abort(spawned: dict) -> None:
    """Stop ``tp_spawn_start``'s ranks without waiting for them."""
    for p in spawned["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
    for lg in spawned["logs"]:
        lg.close()
    shutil.rmtree(spawned["tmp"], ignore_errors=True)


def tp_spawn_finish(spawned: dict, timeout_s: float):
    """Wait for ``tp_spawn_start``'s ranks (``tp_spawn``'s contract)."""
    job, tmp, procs, logs = (spawned[k] for k in ("job", "tmp", "procs", "logs"))
    try:
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
        codes = [p.poll() for p in procs]
        tails = []
        for lg in logs:
            lg.seek(0)
            tails.append(lg.read()[-3000:])
        check(codes == [0] * len(procs),
              f"tp {job}: rank exit codes {codes}:\n" + "\n".join(tails))
        out = []
        for r in range(len(procs)):
            with open(os.path.join(tmp, f"out{r}.json")) as f:
                out.append(json.load(f))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for lg in logs:
            lg.close()
        shutil.rmtree(tmp, ignore_errors=True)


def tp_child(spec_path: str) -> int:
    """``--tp-child``: one rank of a TP or DP phase (``tp_spawn``)."""
    import torch.distributed as dist

    from vescale_tpu_torch import distributed as D
    from vescale_tpu_torch.mesh import init_device_mesh

    with open(spec_path) as f:
        spec = json.load(f)
    if spec["job"] in ("pp", "moe", "nd"):
        # two ranks' activation stashes share the card: grow segments in place
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.cuda.set_device(0)
    D.initialize(f"127.0.0.1:{spec['port']}", spec["world"], spec["rank"], device_type="cuda",
                 backend="gloo", timeout_s=900)
    try:
        mesh = init_device_mesh("cuda", tuple(spec.get("shape") or [spec["world"]]),
                                mesh_dim_names=tuple(spec["names"]), backend="gloo")
        args = dict(spec["args"])
        if spec.get("go"):  # held: wait for the parent's release
            deadline = time.monotonic() + 900
            while not os.path.exists(spec["go"]):
                check(time.monotonic() < deadline, f"{spec['job']}: never released")
                time.sleep(0.2)
            with open(spec["go"]) as f:
                args.update(json.load(f))
        res = TP_JOBS[spec["job"]](mesh, **args)
        with open(spec["out"], "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()
    return 0


def tp_collectives() -> dict:
    from vescale_tpu_torch import collectives as C

    return dict(calls=dict(C.CALLS), bytes=dict(C.BYTES))


def tp_train_job(mesh, rung: str, ref_losses: list, token_file=None, layers=None,
                 plan_legs: bool = False):
    """One rank of ``tp_train``: ``rung`` of the bench (the 1.3B Llama or
    GPT-2 124M) at full width and depth under its plan with sequence
    parallelism, built on ``meta`` and materialized as this rank's pieces
    of the bench's seed-0 weights, trained through the vocab-parallel loss
    with ``AdamWLowmem`` on the bench's batches: ``TP_WARMUP`` untimed and
    ``TP_TIMED`` timed steps.  ``layers`` cuts the model's depth.
    ``plan_legs``: then the plan phase's legs (a)-(d) (``tp_plan_legs``)."""
    import functools

    from vescale_tpu_torch import bench, kernels
    from vescale_tpu_torch import collectives as C
    from vescale_tpu_torch.data import TokenDataLoader
    from vescale_tpu_torch.dmodule import parallelize_module
    from vescale_tpu_torch.loss import vocab_parallel_cross_entropy
    from vescale_tpu_torch.models import (GPT, GPTConfig, Llama, LlamaConfig, init_params,
                                          llama_plan, nanogpt_plan)
    from vescale_tpu_torch.parallel import AdamWLowmem
    from vescale_tpu_torch.train import make_train_step

    dev = mesh.device
    gpt = rung in bench.GPT_RUNGS
    fields, B, T, state_dtype, _ = (bench.GPT_RUNGS if gpt else bench.RUNGS)[rung]
    t0 = time.perf_counter()
    if gpt:
        cfg = GPTConfig(**(fields if layers is None else dict(fields, n_layer=layers)))
        model, plan = GPT(cfg, device="meta"), nanogpt_plan(mesh, sequence_parallel=True)
    else:
        if layers is not None:
            fields = dict(fields, num_hidden_layers=layers)
        cfg = LlamaConfig(max_position_embeddings=T, **fields)
        model, plan = Llama(cfg, device="meta"), llama_plan(mesh, sequence_parallel=True)
    dm = parallelize_module(model, mesh, plan,
                            init_fn=functools.partial(init_params, cfg, 0, dtype=torch.float32))
    opt = AdamWLowmem(dm.parameters(), bench.LR, state_dtype=state_dtype)
    step = make_train_step(dm, opt, lambda lg, b: vocab_parallel_cross_entropy(
        lg, b["target"], mesh=mesh, vocab_dim_name="tp"))
    loader = None
    if gpt:
        loader = TokenDataLoader(token_file, B, T, seed=bench.DATA_SEED, elastic=True, device=dev)
        next_batch = loader.next
    else:
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T + 1))
        toks = torch.from_numpy(toks.astype(np.int64)).to(dev)
        batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
        next_batch = lambda: batch
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses, step_ms, launches, comm, total = [], [], [], [], {}
    for i in range(TP_WARMUP + TP_TIMED):
        if i == TP_WARMUP:
            torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        C.reset_calls()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(step(next_batch())))
        step_ms.append((time.perf_counter() - t1) * 1e3)
        launches.append(dict(kernels.LAUNCHES))
        comm.append(tp_collectives())
        for k, v in launches[-1].items():
            total[k] = total.get(k, 0) + v
    # one more step with the collectives timed (each waits for the card
    # first): the share of a step spent in gloo
    C.reset_calls()
    C.TIMING = True
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    extra_loss = float(step(next_batch()))
    timed_step_s = time.perf_counter() - t1
    C.TIMING = False
    gloo = dict(step_ms=timed_step_s * 1e3, loss=extra_loss,
                seconds_by_op=dict(C.SECONDS), share=sum(C.SECONDS.values()) / timed_step_s)
    if loader is not None:
        loader.close()
    L = cfg.n_layer if gpt else cfg.num_hidden_layers
    want = {**{k: 0 for k in kernels.LAUNCHES}, "flash_fwd": L, "flash_bwd_dq": L,
            "flash_bwd_dkv": L, "fused_xent_fwd": 1, "fused_xent_bwd": 1, "fused_adamw": 1}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    checks = {
        "losses_finite": bool(np.isfinite(losses).all()),
        "losses_within_1pct": len(rel) == len(losses) and max(rel) <= TP_LOSS_REL,
        "launches_per_step": all(s == want for s in launches),
        "local_heads": all(p.shape[1] * TP_WORLD == s.shape[1] for n, p, s in (
            (n, p, dm._specs[n]) for n, p in dm.named_parameters())
            if n.endswith(("q_proj.kernel", "c_attn.kernel"))),
    }
    timed = step_ms[TP_WARMUP:]
    legs = None
    if plan_legs:
        legs = tp_plan_legs(mesh, cfg, dm, next_batch(), losses[:TP_WARMUP + TP_TIMED],
                            float(np.median(timed)), state_dtype, B, T)
    return dict(rank=mesh.get_rank(), setup_s=setup_s, losses=losses, ref_losses=ref_losses,
                plan=legs,
                loss_rel_diffs=rel, step_ms=step_ms, step_ms_median=float(np.median(timed)),
                tokens_per_s_per_rank=B * T / (float(np.median(timed)) / 1e3),
                peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
                params_local=sum(p.numel() for p in dm.parameters()),
                launches_per_step=launches[-1], launches_total=total,
                collectives_per_step=comm[-1], gloo_timed_step=gloo,
                sync_params=sum(len(v) for v in dm._sync_params.values()), checks=checks)


def tp_serve_job(mesh, golden: dict, forced: list, forced_logits_file: str):
    """One rank of ``tp_serve``: Llama-3-8B's serve weights (seed 0, bf16)
    materialized as this rank's ``llama_plan`` pieces from ``meta``, a
    Shard(3) pool, and the serve phase's 16 requests through ``run_serve``
    (every check of the serve phase); then teacher-forced logits (a
    prefill and decode steps along the golden stream) of ``forced``
    requests against the single-card engine's, in bf16 steps at scale."""
    import re

    from vescale_tpu_torch import kernels
    from vescale_tpu_torch import collectives as C
    from vescale_tpu_torch.initialize import materialize_module
    from vescale_tpu_torch.kernels import ulps_at_scale
    from vescale_tpu_torch.models import LLAMA3_8B, init_params, llama_plan, param_shapes
    from vescale_tpu_torch.models.convert import _flatten
    from vescale_tpu_torch.serve import KVCacheConfig, PagedKVCache, ServeEngine

    cfg = LLAMA3_8B
    dev = mesh.device
    t0 = time.perf_counter()
    plan = llama_plan(mesh)["parameter"]

    def placements(node, path=""):
        if isinstance(node, dict):
            return {k: placements(v, f"{path}.{k}" if path else k) for k, v in node.items()}
        return next(v for p, v in plan.items() if re.fullmatch(p, path))

    tree = materialize_module(init_params, placements(param_shapes(cfg)), cfg, seed=0,
                              dtype=torch.bfloat16, mesh=mesh)
    kc = KVCacheConfig(layers=cfg.num_hidden_layers, kv_heads=cfg.num_key_value_heads,
                       head_dim=cfg.head_dim, num_slots=8, page_size=16, pages_per_slot=64,
                       dtype=torch.bfloat16)
    cache = PagedKVCache(kc, mesh=mesh)
    eng = ServeEngine(cfg, tree, cache, mesh=mesh)
    del tree
    local_bytes = sum(t.numel() * t.element_size() for _, t in _flatten(eng.params).items())
    eng.replay_greedy([1, 2, 3], 2)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    C.reset_calls()
    run, streams = serve_run(dev, eng, serve_requests(cfg.vocab_size), kernels)
    comm = tp_collectives()
    same = sum(streams[r] == golden[str(r)] for r in streams)
    # teacher-forced: prefill, then decode along the golden stream, the
    # collectives timed (each waits for the card first): gloo's share
    ref = np.load(forced_logits_file)
    worst = 0.0
    C.reset_calls()
    C.TIMING = True
    t1 = time.perf_counter()
    for i, (prompt, toks) in enumerate(forced):
        cache.reset()
        slot = cache.alloc(len(prompt), len(toks))
        rows = [eng.prefill(prompt, slot)]
        cache.commit_prefill(slot, len(prompt))
        for t in toks[:-1]:
            tt = np.zeros((cache.num_slots,), np.int64)
            tt[slot] = t
            rows.append(eng.decode(tt)[slot])
            cache.advance(slot)
        worst = max(worst, ulps_at_scale(np.stack(rows), ref[i]) / BF16_ULP)
    forced_s = time.perf_counter() - t1
    C.TIMING = False
    gloo = dict(forced_s=forced_s, seconds_by_op=dict(C.SECONDS),
                share=sum(C.SECONDS.values()) / forced_s)
    cache.reset()
    checks = dict(run["checks"])
    checks["kv_heads_local"] = cache.k.shape[3] == kc.kv_heads // TP_WORLD
    checks["q_heads_local"] = eng._heads(eng.params["layers_0"]) == (
        cfg.num_attention_heads // TP_WORLD, cfg.num_key_value_heads // TP_WORLD)
    checks["forced_logits_within_bound"] = worst <= TP_SERVE_BF16_STEPS
    checks["eager_over_gloo"] = not eng.graphed
    return dict(rank=mesh.get_rank(), setup_s=setup_s, local_weight_bytes=local_bytes,
                launches_total=run["launches"],
                pool_bytes_local=2 * cache.k.numel() * cache.k.element_size(),
                streams_equal_serve=int(same), streams=len(streams), graphed=eng.graphed,
                forced_worst_bf16_steps=worst, forced_bound_bf16_steps=TP_SERVE_BF16_STEPS,
                gloo_timed_forced=gloo,
                collectives=comm, checks=checks, **{k: v for k, v in run.items() if k != "checks"})


def tp_plan_legs(mesh, cfg, hand, batch, hand_losses: list, step_ms: float, state_dtype,
                 B: int, T: int) -> dict:
    """The plan phase's legs (a)-(d) on a tp_train 1.3B rank, after its
    ``llama_plan`` steps (``hand``, losses ``hand_losses``, median step
    ``step_ms``): see the module docstring.  Every leg's checks are in
    ``checks``; the kernel launches of the auto-plan steps in
    ``launches``."""
    import functools

    from vescale_tpu_torch import bench, kernels
    from vescale_tpu_torch import collectives as C
    from vescale_tpu_torch.analysis import Severity, shardcheck_module
    from vescale_tpu_torch.debug import CommDebugMode
    from vescale_tpu_torch.dmp import auto_parallelize_module
    from vescale_tpu_torch.loss import vocab_parallel_cross_entropy
    from vescale_tpu_torch.models import Llama, init_params, llama_plan
    from vescale_tpu_torch.parallel import AdamWLowmem
    from vescale_tpu_torch.placements import Shard, plan_axes
    from vescale_tpu_torch.telemetry import costaudit
    from vescale_tpu_torch.telemetry.calibrate import calibrate
    from vescale_tpu_torch.train import make_train_step

    out, checks = {}, {}
    # (a) auto-plan, (b) its collectives counted
    t = time.perf_counter()
    auto = auto_parallelize_module(Llama(cfg, device="meta"), mesh, policy="MEGATRON",
                                   init_fn=functools.partial(init_params, cfg, 0,
                                                             dtype=torch.float32))
    placed = {n: [str(p) for p in s.placements] for n, s in auto._specs.items()}
    checks["a_plan_equals_llama_plan"] = placed == {
        n: [str(p) for p in s.placements] for n, s in hand._specs.items()}
    step = make_train_step(auto, AdamWLowmem(auto.parameters(), bench.LR, state_dtype=state_dtype),
                           lambda lg, b: vocab_parallel_cross_entropy(
                               lg, b["target"], mesh=mesh, vocab_dim_name="tp"))
    kernels.reset_launches()
    calls0, bytes0 = dict(C.CALLS), dict(C.BYTES)
    with CommDebugMode() as comm:
        losses = [float(step(batch)) for _ in hand_losses]
    torch.cuda.synchronize()
    out["launches"] = dict(kernels.LAUNCHES)
    calls = {k: v - calls0.get(k, 0) for k, v in C.CALLS.items() if v - calls0.get(k, 0)}
    nbytes = {k: v - bytes0.get(k, 0) for k, v in C.BYTES.items() if v - bytes0.get(k, 0)}
    checks["a_losses_bitwise_llama_plan"] = losses == hand_losses
    checks["b_counts_equal_calls_delta"] = comm.calls == calls and comm.bytes == nbytes
    checks["b_counted_some"] = comm.get_total_counts() > 0
    out["a"] = dict(seconds=time.perf_counter() - t, losses=losses, llama_plan_losses=hand_losses,
                    params=len(placed))
    out["b"] = dict(counts=comm.get_comm_counts(), bytes=comm.get_comm_bytes(), calls=comm.calls)
    del auto, step
    free_memory()
    # (c) shardcheck of the tp=2 forward, traced on meta (rank 0)
    if mesh.get_rank() == 0:
        model = Llama(cfg, device="meta")
        t = time.perf_counter()
        good = shardcheck_module(model, llama_plan(mesh, sequence_parallel=True), mesh,
                                 batch["input"], name="llama_plan")
        trace_s = time.perf_counter() - t
        bad_plan = llama_plan(mesh, sequence_parallel=True)
        key = next(k for k in bad_plan["parameter"] if "o_proj" in k)
        bad_plan["parameter"][key] = plan_axes(mesh, tp=Shard(1))
        bad = shardcheck_module(model, bad_plan, mesh, batch["input"], name="o_proj column")
        found = bad.by_code("VSC101") + bad.by_code("VSC102")
        checks["c_llama_plan_no_error"] = good.count(Severity.ERROR) == 0
        checks["c_bad_plan_found_with_bytes"] = bool(found) and all(f.bytes_est for f in found)
        out["c"] = dict(trace_s=trace_s, llama_plan=good.to_dict()["codes"],
                        bad=[f.format() for f in found][:4], n_bad=len(found),
                        tokens=list(batch["input"].shape))
    # (d) what-if under a table measured on these gloo ranks
    t = time.perf_counter()
    table = calibrate(mesh, byte_buckets=(1 << 16, 1 << 20, 1 << 24), reps=2)
    n_params = sum(s.logical_bytes() // 4 for s in hand._specs.values())
    E, L = cfg.hidden_size, cfg.num_hidden_layers
    kw = dict(params_bytes=4.0 * n_params, activation_bytes=4.0 * L * B * T * E * 2,
              flops_per_step=6.0 * n_params * B * T, table=table, device=mesh.device)
    ranked = {n: costaudit.score_candidates(costaudit.mesh_candidates(n), **kw) for n in (2, 4)}
    pred = next(r for r in ranked[2] if r["mesh"] == {"dp": 1, "tp": 2, "pp": 1})
    out["d"] = dict(seconds=time.perf_counter() - t, measured_tp2_step_ms=step_ms,
                    predicted_tp2_step_ms=pred["predicted_step_us"] / 1e3,
                    predicted_compute_ms=pred["compute_us"] / 1e3,
                    predicted_comm_ms=pred["comm_us"] / 1e3, confidence=pred["confidence"],
                    sources=sorted({x["source"] for x in pred["terms"]}),
                    ranked={n: [(r["mesh"]["dp"], r["mesh"]["tp"], r["mesh"]["pp"],
                                 round(r["predicted_step_us"] / 1e3, 3)) for r in v]
                            for n, v in ranked.items()},
                    table_entries=len(table), link="gloo, two ranks of one card")
    checks["d_scored"] = all(len(ranked[n]) == len(costaudit.mesh_candidates(n)) for n in ranked) \
        and pred["predicted_step_us"] > 0
    out["checks"] = checks
    return out


PLAN_LEAVES = (("q_proj", (2048, 2048)), ("gate_proj", (2048, 5632)),
               ("down_proj", (5632, 2048)), ("embedding", (32000, 2048)))
PLAN_QUANT_SHAPE = (20000, 2048)  # 40.96M elements


def plan_battery_job(mesh, seed: int = 0) -> dict:
    """(e) on one rank of a (2, 2) ("dp", "tp") gloo mesh: the former-
    fallback battery on each of ``PLAN_LEAVES`` (fp32 values from a seeded
    generator, the same on every rank), each result bitwise the same
    transition through the full tensor, the fallback counter, tier and
    hops, this rank's peak bytes above what it held for the transition and
    for going through Replicate; then the int8 overlay."""
    from vescale_tpu_torch import collectives as C
    from vescale_tpu_torch import redistribute_plan as rp
    from vescale_tpu_torch.darray import DArray, distribute_tensor
    from vescale_tpu_torch.placements import InterleavedShard as IS, Partial as P
    from vescale_tpu_torch.placements import Replicate as R, Shard as S
    from vescale_tpu_torch.redistribute import classify_transition
    from vescale_tpu_torch.spec import DArraySpec, TensorMeta
    from vescale_tpu_torch.telemetry.registry import GLOBAL

    dev = mesh.device
    coord = mesh.get_coordinate()
    rank = mesh.get_rank()
    battery = (([S(0), S(1)], [S(1), S(0)]), ([P(), S(0)], [S(0), P()]),
               ([S(0), R()], [P(), S(0)]), ([IS(0, 2), IS(1, 2)], [R(), S(1)]))

    def peak_of(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, torch.cuda.max_memory_allocated(dev) - base, time.perf_counter() - t

    rows, ok = [], True
    for li, (name, shape) in enumerate(PLAN_LEAVES):
        g = torch.Generator(device=dev)
        g.manual_seed(seed * 100 + li)
        xs = [torch.randn(shape, generator=g, device=dev) for _ in range(2)]
        meta = TensorMeta(shape, torch.float32)
        for src, dst in battery:
            sspec, dspec = DArraySpec(mesh, src, meta), DArraySpec(mesh, dst, meta)
            if sspec.has_partial():  # dp coordinate c holds contribution c, unseeded
                full = xs[0] + xs[1]
                cut = sspec.with_placements([R()] + list(src[1:]))
                d = DArray(cut.local_from_full(xs[coord[0]], coord).contiguous(), sspec, rank)
            else:
                full = xs[0]
                d = distribute_tensor(full, mesh, src)
            f0 = GLOBAL.counter("redistribute.fallbacks")
            out, peak, sec = peak_of(lambda: d.redistribute(placements=dst))
            fallbacks = GLOBAL.counter("redistribute.fallbacks") - f0
            via, peak_rep, sec_rep = peak_of(
                lambda: d.redistribute(placements=[R(), R()]).redistribute(placements=dst))
            if dspec.has_partial():
                same = torch.equal(out.full_tensor(), full) and \
                    torch.equal(via.full_tensor(), full)
            else:
                want = dspec.local_from_full(full, coord)
                same = torch.equal(out.to_local(), want) and torch.equal(via.to_local(), want)
            plan = rp.plan_redistribute(sspec, dspec)
            row = dict(leaf=name, src=[str(p) for p in src], dst=[str(p) for p in dst],
                       tier=classify_transition(sspec, dspec), bitwise=bool(same),
                       fallbacks=fallbacks, peak_bytes=int(peak), replicate_peak_bytes=int(peak_rep),
                       shard_bytes=rp.physical_shard_bytes(sspec), seconds=sec,
                       replicate_seconds=sec_rep,
                       hops=[h.kind for h in plan.hops] if plan is not None else None)
            ok = ok and same and fallbacks == 0
            rows.append(row)
            del out, via, d
        del xs, full
        free_memory()
    # the int8 overlay on one Partial -> Replicate leaf
    g = torch.Generator(device=dev)
    g.manual_seed(seed * 100 + 99)
    local = torch.randn(PLAN_QUANT_SHAPE, generator=g, device=dev) * (1 + coord[0])
    sspec = DArraySpec(mesh, [P(), R()], TensorMeta(PLAN_QUANT_SHAPE, torch.float32))
    os.environ["VESCALE_REDISTRIBUTE_QUANT"] = "1"
    try:
        rp.clear_plan_cache()
        qplan = rp.quant_single_hop_plan(sspec, sspec.with_placements((R(), R())))
        over, qpeak, qsec = peak_of(lambda: DArray(local, sspec, rank).redistribute(
            placements=[R(), R()]))
    finally:
        os.environ.pop("VESCALE_REDISTRIBUTE_QUANT")
        rp.clear_plan_cache()
    want = C.all_reduce_q(local, mesh, "sum", 0, block=64, rounding="nearest")
    quant = dict(shape=list(PLAN_QUANT_SHAPE), taken=qplan is not None and
                 qplan.hops[0].kind == "quant", bitwise_all_reduce_q=bool(torch.equal(
                     over.to_local(), want)), peak_bytes=int(qpeak), seconds=qsec,
                 max_abs_err_vs_exact=float((over.to_local() - C.all_reduce(
                     local, mesh.get_group(0))).abs().max()))
    ok = ok and quant["taken"] and quant["bitwise_all_reduce_q"]
    return dict(rank=rank, coord=list(coord), rows=rows, quant=quant, ok=bool(ok))


def run_plan_phase(dev, card, legs) -> dict:
    """The plan phase: legs (a)-(d) from tp_train's 1.3B ranks (``legs``,
    one dict a rank), then (e) in four gloo ranks of the card."""
    t = time.perf_counter()
    battery = tp_spawn("plan", {}, timeout_s=300, names=("dp", "tp"), shape=(2, 2))
    e_s = time.perf_counter() - t
    checks = {k: all(leg["checks"].get(k, True) for leg in legs)
              for k in sorted({k for leg in legs for k in leg["checks"]})}
    checks["e_battery"] = all(r["ok"] for r in battery)
    rows = battery[0]["rows"]
    out = dict(card=card, a=legs[0]["a"], b=[leg["b"] for leg in legs],
               c=next(leg["c"] for leg in legs if "c" in leg), d=legs[0]["d"],
               e=dict(seconds=e_s, rows=[dict(r, peak_bytes_by_rank=[b["rows"][i]["peak_bytes"]
                                                                    for b in battery],
                                              replicate_peak_bytes_by_rank=[
                                                  b["rows"][i]["replicate_peak_bytes"]
                                                  for b in battery])
                                         for i, r in enumerate(rows)],
                      quant=[b["quant"] for b in battery]),
               launches={k: sum(leg["launches"].get(k, 0) for leg in legs)
                         for k in legs[0]["launches"]}, checks=checks)
    check(all(checks.values()), f"plan checks failed: {[k for k, v in checks.items() if not v]}: "
                                f"{json.dumps(out)[:6000]}")
    return out


TP_JOBS = {"train": tp_train_job, "serve": tp_serve_job, "plan": plan_battery_job}
TP_WARMUP, TP_TIMED = 1, 1  # untimed and timed steps of tp_train


def short_run_losses(dev, rung: str, layers: int, steps: int, token_file=None) -> list:
    """The losses of ``steps`` single-card steps of ``rung`` cut to
    ``layers`` deep (the reference of a gloo leg run at that depth)."""
    from vescale_tpu_torch import bench

    run = bench.prepare(rung, device=dev, layers=layers, token_file=token_file)
    try:
        return [float(run.step(run.next_batch())) for _ in range(steps)]
    finally:
        run.close()
        del run
        free_memory()


def run_tp_train(dev, card, rungs=("1.3b", "gpt2")):
    """``tp_train``: the 1.3B Llama (``llama_plan``) at full width and
    ``GLOO_13B_LAYERS`` deep and GPT-2 124M (``nanogpt_plan``) at full width
    and ``GLOO_GPT2_LAYERS`` deep, both with sequence parallelism, on two
    ranks of one card over gloo, each from the weights and batches of a
    single-card run at the same depth: losses within 1% of that run's at
    each step, every kernel launch of each step.  The 1.3B ranks then run
    the plan phase's legs (a)-(d).  Returns (the phase, those legs a
    rank)."""
    from vescale_tpu_torch import bench

    out, legs = {}, []
    steps = TP_WARMUP + TP_TIMED
    depth = {"1.3b": GLOO_13B_LAYERS, "gpt2": GLOO_GPT2_LAYERS}
    tmpdir = tempfile.mkdtemp(prefix="vtt_tokens_")
    try:
        token_file = bench.write_token_file(os.path.join(tmpdir, "tokens.bin"),
                                            bench.DATA_TOKENS, 50304) if "gpt2" in rungs else None
        refs = {r: short_run_losses(dev, r, depth[r], steps, token_file if r == "gpt2" else None)
                for r in rungs}
        for rung in rungs:
            t = time.perf_counter()
            ranks = tp_spawn("train", dict(rung=rung, ref_losses=refs[rung],
                                           token_file=token_file if rung == "gpt2" else None,
                                           layers=depth[rung], plan_legs=rung == "1.3b"),
                             timeout_s=600)
            legs += [r.pop("plan") for r in ranks if r.get("plan") is not None]
            for r in ranks:
                r.pop("plan", None)
            ok = all(all(r["checks"].values()) for r in ranks)
            out[rung] = dict(wall_s=time.perf_counter() - t, card=card, ranks=ranks, ok=ok)
            check(ok, f"tp_train {rung} checks failed: {json.dumps(out[rung])[:4000]}")
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out, legs


def forced_reference(eng, streams, n=TP_FORCED):
    """The single-card engine's teacher-forced logits for the first ``n``
    serve requests: the prefill row, then a decode row for each golden
    token but the last, fp32 (n, 32, vocab)."""
    cfg = eng.config
    arrivals = serve_requests(cfg.vocab_size)
    cache = eng.cache
    forced, rows = [], []
    for _, req in arrivals[:n]:
        toks = streams[req.rid]
        cache.reset()
        slot = cache.alloc(len(req.prompt), len(toks))
        got = [eng.prefill(req.prompt, slot)]
        cache.commit_prefill(slot, len(req.prompt))
        for t in toks[:-1]:
            tt = np.zeros((cache.num_slots,), np.int64)
            tt[slot] = t
            got.append(eng.decode(tt)[slot])
            cache.advance(slot)
        forced.append((list(req.prompt), list(toks)))
        rows.append(np.stack(got))
    cache.reset()
    return forced, np.stack(rows)


def run_tp_serve(dev, serve_streams, forced, card):
    """``tp_serve``: the 8B over two ranks of one card (``tp_serve_job``)."""
    tmp = tempfile.mkdtemp(prefix="vtt_forced_")
    try:
        path = os.path.join(tmp, "forced.npy")
        np.save(path, forced[1])
        t = time.perf_counter()
        ranks = tp_spawn("serve", dict(golden={str(k): v for k, v in serve_streams.items()},
                                       forced=forced[0], forced_logits_file=path), timeout_s=900)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ok = all(all(r["checks"].values()) for r in ranks)
    out = dict(wall_s=time.perf_counter() - t, card=card, ranks=ranks, ok=ok)
    check(ok, f"tp_serve checks failed: {json.dumps(out)[:4000]}")
    return out


GLOO_OPS = ("all_reduce", "all_reduce_max", "all_reduce_bf16", "all_gather_into_tensor",
            "reduce_scatter_tensor", "all_to_all_single", "all_to_all_v", "broadcast", "scatter",
            "send_recv")


def gloo_probe_child(op: str, rank: int, port: int) -> int:
    """``--gloo-probe-child``: one rank of a two-rank gloo world on the one
    card running ``op`` once on CUDA tensors, torch.distributed directly."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    dev = torch.device("cuda", 0)
    x = torch.full((8, 4), float(rank + 1), device=dev)
    if op == "all_reduce":
        dist.all_reduce(x)
        ok = bool((x == 3).all())
    elif op == "all_reduce_max":
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        ok = bool((x == 2).all())
    elif op == "all_reduce_bf16":
        y = x.bfloat16()
        dist.all_reduce(y)
        ok = bool((y == 3).all())
    elif op == "all_gather_into_tensor":
        out = torch.empty(16, 4, device=dev)
        dist.all_gather_into_tensor(out, x)
        ok = bool((out[:8] == 1).all() and (out[8:] == 2).all())
    elif op == "reduce_scatter_tensor":
        out = torch.empty(4, 4, device=dev)
        dist.reduce_scatter_tensor(out, x)
        ok = bool((out == 3).all())
    elif op == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        ok = bool((out[:4] == 1).all() and (out[4:] == 2).all())
    elif op == "all_to_all_v":  # uneven splits: the ragged refresh's exchange
        send = torch.arange(8, dtype=torch.float32, device=dev) + 10 * rank
        splits = [3, 5] if rank == 0 else [6, 2]
        recv = [3, 6] if rank == 0 else [5, 2]
        out = torch.empty(sum(recv), device=dev)
        dist.all_to_all_single(out, send, output_split_sizes=recv, input_split_sizes=splits)
        want = ([0, 1, 2, 10, 11, 12, 13, 14, 15] if rank == 0 else [3, 4, 5, 6, 7, 16, 17])
        ok = out.tolist() == [float(w) for w in want]
    elif op == "broadcast":
        dist.broadcast(x, src=0)
        ok = bool((x == 1).all())
    elif op == "scatter":
        out = torch.empty(4, 4, device=dev)
        dist.scatter(out, [x[:4].contiguous(), x[4:].contiguous()] if rank == 0 else None, src=0)
        ok = bool((out == 1).all())
    else:
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, 1 - rank), dist.P2POp(dist.irecv, out, 1 - rank)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        ok = bool((out == 2 - rank).all())
    torch.cuda.synchronize()
    print(json.dumps({"op": op, "rank": rank, "ok": ok}), flush=True)
    dist.destroy_process_group()
    return 0


def run_gloo_probe() -> dict:
    """Each op of ``GLOO_OPS`` in its own two-rank gloo world on CUDA
    tensors (a refused op may raise or end the process): ``ok``, a wrong
    result, or the failure (exit code and the last of its output)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("VESCALE_")}
    out = {}
    for op in GLOO_OPS:
        port = free_port()
        logs = [tempfile.TemporaryFile(mode="w+") for _ in range(2)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gloo-probe-child",
                                   op, str(r), str(port)], env=env, stdout=logs[r],
                                  stderr=subprocess.STDOUT) for r in range(2)]
        deadline = time.monotonic() + 60
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                time.sleep(2)
                break
            time.sleep(0.2)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        texts = []
        for lg in logs:
            lg.seek(0)
            texts.append(lg.read())
            lg.close()
        codes = [p.returncode for p in procs]
        good = all(c == 0 for c in codes) and all('"ok": true' in t for t in texts)
        out[op] = "ok" if good else dict(
            codes=codes, tail=[t.strip().splitlines()[-1][-300:] if t.strip() else "" for t in texts])
    return out


# ----------------------------------------------------------- data parallel
DP_STEPS = 3  # steps of each 1.3B dp mode: 1 warm-up, 2 timed
DP_WARMUP = 1
DP_GPT2_STEPS = 4
DP_INT8_LOSS_REL = 0.05  # the reference's LOSS_TOL (scripts/quantcomm_smoke.py:52)
DP_INT8_BYTES = 3.5  # int8 must move at least this many times fewer gradient bytes
# the modes are expected bitwise equal (a two-rank fp32 sum commutes, AdamW
# is elementwise); a mode that is not is held to this bound on every
# parameter, the drift Adam's normalised update can make of last-bit
# gradient differences in DP_STEPS steps (bench.LR a step at most)
DP_MODE_BOUND = 2 * DP_STEPS * 3e-4


def fingerprint(tensors) -> list:
    """An int64 hash of each tensor's bits (position-weighted sum, mod 2^64:
    any summation order gives the same value), computed on its device."""
    out = []
    for t in tensors:
        v = t.detach().reshape(-1)
        bits = v.view(torch.int32 if v.element_size() == 4 else torch.int16).to(torch.int64)
        w = torch.arange(v.numel(), device=v.device, dtype=torch.int64).remainder_(1000003).add_(1)
        out.append(int((bits * w).sum()))
    return out


def dp_state_fingerprint(dopt) -> dict:
    """The main params, moments and step of a ``DistributedOptimizer``."""
    group, mus, nus = dopt._inner_state()
    return dict(main=fingerprint(dopt.main_params), mu=fingerprint(mus), nu=fingerprint(nus),
                step=int(group["step"]))


def dp_mode_job(mesh, mode: str, ref_losses: list, ddp_params=None, layers=None):
    """One rank of one 1.3B dp mode (``bench.prepare_dp``): ``DP_STEPS``
    steps on this rank's row, the last with the collectives timed; for
    ``zero2`` (dynamic loss scale) one more step in which rank 1's gradient
    holds an inf before the reduce.  Returns the record, and the final
    parameters on the host for ``ddp``."""
    from vescale_tpu_torch import bench, kernels
    from vescale_tpu_torch import collectives as C

    dev = mesh.device
    free_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run = bench.prepare_dp("1.3b", mode, mesh, loss_scale="dynamic" if mode == "zero2" else None,
                           layers=layers)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses, step_ms, launches, gloo = [], [], [], None
    for i in range(DP_STEPS):
        kernels.reset_launches()
        C.reset_calls()
        C.TIMING = i == DP_STEPS - 1
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(run.step(run.next_batch())))
        dt = time.perf_counter() - t1
        C.TIMING = False
        step_ms.append(dt * 1e3)
        launches.append(dict(kernels.LAUNCHES))
        if i == DP_STEPS - 1:
            gloo = dict(step_ms=dt * 1e3, seconds_by_op=dict(C.SECONDS),
                        share=sum(C.SECONDS.values()) / dt)
    comm = tp_collectives()
    peak = torch.cuda.max_memory_allocated(dev)
    if mode == "fsdp":
        run.optimizer.gather()  # the model holds the last step's inputs until refilled
    params = [p for _, p in run.model.named_parameters()]
    rec = dict(rank=mesh.get_rank(), mode=mode, setup_s=setup_s, losses=losses,
               loss_rel_diffs=[abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)],
               step_ms=step_ms, step_ms_median=float(np.median(step_ms[DP_WARMUP:])),
               peak_memory_bytes=peak, launches_per_step=launches,
               collectives_per_step=comm, gloo_timed_step=gloo, fingerprint=fingerprint(params))
    if ddp_params is not None:
        diffs = [float((p.detach().cpu() - q).abs().max()) for p, q in zip(params, ddp_params)]
        rec["max_abs_diff_vs_ddp"] = max(diffs)
    host = [p.detach().cpu() for p in params] if mode == "ddp" else None
    if mode == "zero2":
        dopt = run.optimizer
        before = dict(params=rec["fingerprint"], state=dp_state_fingerprint(dopt),
                      scale=dopt.current_scale())
        real = dopt.reduce_grads

        def poisoned(grads=None):
            if mesh.get_rank() == 1:
                params[0].grad.view(-1)[0] = float("inf")
            return real(grads)

        dopt.reduce_grads = poisoned
        kernels.reset_launches()
        loss_inf = float(run.step(run.next_batch()))
        dopt.reduce_grads = real
        rec["inf_step"] = dict(
            loss=loss_inf, scale_before=before["scale"], scale_after=dopt.current_scale(),
            skip_count=int(dopt.loss_scale_state["skip_count"]),
            params_unchanged=fingerprint(params) == before["params"],
            state_unchanged=dp_state_fingerprint(dopt) == before["state"],
            fused_adamw_launches=kernels.LAUNCHES["fused_adamw"], launches=dict(kernels.LAUNCHES))
    run.close()
    del run, params
    free_memory()
    return rec, host


def dp_gpt2_job(mesh, ref_losses: list, token_file: str, grad_compress=None):
    """One rank of GPT-2 124M at ``GLOO_GPT2_LAYERS`` deep under DDP at B=6
    (the elastic loader: the ranks' rows are the B=12 stream of the
    single-card reference), exact or int8."""
    from vescale_tpu_torch import bench, kernels
    from vescale_tpu_torch import collectives as C

    run = bench.prepare_dp("gpt2", "ddp", mesh, grad_compress=grad_compress,
                           token_file=token_file, layers=GLOO_GPT2_LAYERS)
    losses, comm, total = [], [], {}
    try:
        for _ in range(DP_GPT2_STEPS):
            kernels.reset_launches()
            C.reset_calls()
            losses.append(float(run.step(run.next_batch())))
            comm.append(dict(tp_collectives(), compress=dict(C.COMPRESS)))
            for k, v in kernels.LAUNCHES.items():
                total[k] = total.get(k, 0) + v
    finally:
        run.close()
    del run
    free_memory()
    grad_bytes = {k: v for k, v in comm[-1]["bytes"].items() if "all_reduce" in k or "q_psum" in k}
    return dict(compress=grad_compress, losses=losses, launches_total=total,
                collectives_per_step=comm[-1], grad_bytes_per_step=sum(grad_bytes.values()),
                loss_rel_diffs=[abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)])


def dp_train_job(mesh, ref_losses: list, gpt2_ref: list, token_file: str, layers=None):
    """One rank of ``dp_train``: the 1.3B (``layers`` deep) under ddp, zero2
    and fsdp, then GPT-2 exact and int8."""
    out, host = {}, None
    for mode in ("ddp", "zero2", "fsdp"):
        out[mode], got = dp_mode_job(mesh, mode, ref_losses, ddp_params=host, layers=layers)
        host = got if mode == "ddp" else host
    del host
    free_memory()
    out["gpt2"] = {str(c): dp_gpt2_job(mesh, gpt2_ref, token_file, c) for c in (None, "int8")}
    out["launches_total"] = {}
    for rec in [out[m] for m in ("ddp", "zero2", "fsdp")] + list(out["gpt2"].values()):
        steps = rec["launches_per_step"] if "launches_per_step" in rec else [rec["launches_total"]]
        if "inf_step" in rec:
            steps = steps + [rec["inf_step"]["launches"]]
        for step in steps:
            for k, v in step.items():
                out["launches_total"][k] = out["launches_total"].get(k, 0) + v
    out["rank"] = mesh.get_rank()
    return out


TP_JOBS["dp"] = dp_train_job


def dp_adamw_shapes():
    """Rank 0's K8 leaves of the 1.3B at dp=2 in each mode: DDP's whole
    leaves, the ZeRO pieces (each leaf's first dim halved,
    ``zero_placements``) and the FSDP flat piece."""
    from vescale_tpu_torch.mesh import DeviceMesh
    from vescale_tpu_torch.models import LlamaConfig, init_params
    from vescale_tpu_torch.parallel import FSDPParamBuffer
    from vescale_tpu_torch.parallel.optimizer import zero_placements
    from vescale_tpu_torch.placements import Replicate
    from vescale_tpu_torch.spec import DArraySpec, TensorMeta
    from vescale_tpu_torch.bench import RUNGS

    mesh = DeviceMesh(("dp",), (TP_WORLD,), device_type="cpu")
    meta = init_params(LlamaConfig(**RUNGS["1.3b"][0]), device="meta", dtype=torch.float32)
    zero = [DArraySpec(mesh, zero_placements(tuple(s), [Replicate()], mesh, ("dp",)),
                       TensorMeta(tuple(s), torch.float32)).local_shape((0,)) for s in
            train_leaf_shapes()]
    fsdp = FSDPParamBuffer(meta, mesh).groups["float32"].spec.ragged_local_chunk((0,))[0]
    return {"ddp": train_leaf_shapes(), "zero2": zero, "fsdp": [(fsdp,)]}


def dp_adamw_parity(dev):
    """K8 at the dp path's shapes, as ``run_adamw_parity`` holds it: the
    moments bitwise, u within 4 ulps per element of the plain version; and
    its time against the plain version and the bound."""
    from vescale_tpu_torch.kernels.fused_adamw import fused_adamw_reference, fused_adamw_update
    from vescale_tpu_torch.parallel.optimizer import bias_corrections

    hp = dict(b1=0.9, b2=0.999, eps=1e-8)
    c1, c2 = bias_corrections(0.9, 0.999, 5)
    rows = {}
    for label, shapes in dp_adamw_shapes().items():
        gs, ms, vs = adamw_leaves(dev, shapes, torch.bfloat16, seed=len(shapes))
        us, mos, vos = fused_adamw_update(gs, ms, vs, c1, c2, **hp)
        worst_u, moments_equal, err = 0.0, True, 0.0
        for i in range(len(gs)):
            ru, rm, rv = fused_adamw_reference([gs[i]], [ms[i]], [vs[i]], c1, c2, **hp)
            moments_equal &= bits_equal(mos[i], rm[0]) and bits_equal(vos[i], rv[0])
            worst_u = max(worst_u, ulps_elementwise(us[i], ru[0]))
            err = max(err, float((us[i] - ru[0]).abs().max()))
            del ru, rm, rv
        del us, mos, vos
        free_memory()
        rows[label] = dict(leaves=len(gs), elements=sum(g.numel() for g in gs),
                           moments_bitwise=moments_equal, u_ulps=worst_u, u_bound=4.0,
                           ok=moments_equal and worst_u <= 4.0,
                           timing=adamw_timing(gs, ms, vs, c1, c2, hp, err))
        del gs, ms, vs
        free_memory()
    return rows


def quant_timing(dev) -> dict:
    """Block quantize + pack, and unpack + dequantize, of one 40M-element
    fp32 gradient bucket (DDP's ``bucket_size``) on the card."""
    from vescale_tpu_torch.parallel.ddp import DEFAULT_BUCKET
    from vescale_tpu_torch.quant import blockscale as B

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(DEFAULT_BUCKET, generator=g, device=dev)
    qb = B.quantize_int8_blocks(x)
    payload = B.pack_int8_payload(qb)
    nb = qb.q.shape[0]
    back = B.dequantize_int8_blocks(B.unpack_int8_payload(payload, nb, B.DEFAULT_BLOCK), x.shape,
                                    x.dtype)
    err = float(((back - x).abs() / B.block_amax(x).repeat_interleave(B.DEFAULT_BLOCK)[:x.numel()]
                 ).max())
    q_ms = cuda_ms(lambda: B.pack_int8_payload(B.quantize_int8_blocks(x)), iters=5, warmup=1)
    d_ms = cuda_ms(lambda: B.dequantize_int8_blocks(
        B.unpack_int8_payload(payload, nb, B.DEFAULT_BLOCK), x.shape, x.dtype), iters=5, warmup=1)
    out = dict(elements=x.numel(), quantize_ms=q_ms, dequantize_ms=d_ms,
               payload_bytes=payload.numel(), max_err_over_block_amax=err,
               ok=err <= 1.0 / 127.0 + 1e-7)
    del x, qb, payload, back
    free_memory()
    return out


def run_dp_train(dev, card):
    """``dp_train``: the 1.3B at full width and ``GLOO_13B_LAYERS`` deep at
    dp=2 under ddp, zero2 and fsdp (two ranks of one card over gloo), each
    held to a single-card run of the same two rows at that depth
    (``grad_accum_steps=2``); GPT-2 exact and int8; K8 at the 1.3B's full
    dp shapes."""
    from vescale_tpu_torch import bench

    t = time.perf_counter()
    ref = bench.prepare("1.3b", device=dev, rows=bench.RUNGS["1.3b"][1] * TP_WORLD,
                        grad_accum_steps=TP_WORLD, layers=GLOO_13B_LAYERS)
    ref_losses, ref_ms = [], []
    for _ in range(DP_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref_losses.append(float(ref.step(ref.next_batch())))
        ref_ms.append((time.perf_counter() - t1) * 1e3)
    ref_fp = fingerprint([p for _, p in ref.model.named_parameters()])
    del ref
    free_memory()
    tmpdir = tempfile.mkdtemp(prefix="vtt_tokens_")
    try:
        token_file = bench.write_token_file(os.path.join(tmpdir, "tokens.bin"), bench.DATA_TOKENS,
                                            50304)
        gpt2_ref = short_run_losses(dev, "gpt2", GLOO_GPT2_LAYERS, DP_GPT2_STEPS, token_file)
        ranks = tp_spawn("dp", dict(ref_losses=ref_losses, gpt2_ref=gpt2_ref,
                                    token_file=token_file, layers=GLOO_13B_LAYERS),
                         timeout_s=900, names=("dp",))
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    adamw = dp_adamw_parity(dev)
    quant = quant_timing(dev)
    modes = ("ddp", "zero2", "fsdp")
    fps = {m: [r[m]["fingerprint"] for r in ranks] for m in modes}
    exact = [r["gpt2"]["None"] for r in ranks]
    q = [r["gpt2"]["int8"] for r in ranks]
    checks = {
        "losses_within_1pct": all(max(r[m]["loss_rel_diffs"]) <= TP_LOSS_REL and
                                  len(r[m]["losses"]) == DP_STEPS for r in ranks for m in modes),
        "ranks_bitwise": all(fps[m][0] == fps[m][1] for m in modes),
        "modes_bitwise_or_bounded": all(
            fps[m][0] == fps["ddp"][0] or max(r[m]["max_abs_diff_vs_ddp"] for r in ranks)
            <= DP_MODE_BOUND for m in ("zero2", "fsdp")),
        "k8_launched_each_step": all(s["fused_adamw"] == 1 for r in ranks for m in modes
                                     for s in r[m]["launches_per_step"]),
        "inf_skipped_on_both_ranks": all(
            r["zero2"]["inf_step"]["params_unchanged"] and r["zero2"]["inf_step"]["state_unchanged"]
            and r["zero2"]["inf_step"]["skip_count"] == 1
            and r["zero2"]["inf_step"]["fused_adamw_launches"] == 0
            and r["zero2"]["inf_step"]["scale_after"] == r["zero2"]["inf_step"]["scale_before"] / 2
            for r in ranks),
        "k8_dp_shapes_parity": all(v["ok"] for v in adamw.values()),
        "gpt2_exact_within_1pct": all(max(e["loss_rel_diffs"]) <= TP_LOSS_REL for e in exact),
        "gpt2_int8_within_5pct": all(
            abs(a - b) <= DP_INT8_LOSS_REL * abs(b) for e, i in zip(exact, q)
            for a, b in zip(i["losses"], e["losses"])),
        "gpt2_int8_bytes": all(e["grad_bytes_per_step"] >= DP_INT8_BYTES * i["grad_bytes_per_step"]
                               for e, i in zip(exact, q)),
        "quantize_round_trip": quant["ok"],
    }
    out = dict(wall_s=time.perf_counter() - t, card=card, world=TP_WORLD, backend="gloo",
               single_card=dict(losses=ref_losses, step_ms=ref_ms, fingerprint_equals_ddp=
                                ref_fp == fps["ddp"][0]),
               modes_bitwise={m: fps[m][0] == fps["ddp"][0] for m in ("zero2", "fsdp")},
               mode_bound=DP_MODE_BOUND,
               ranks=ranks, k8_dp_shapes=adamw, quantize=quant, checks=checks,
               ok=all(checks.values()))
    check(out["ok"], f"dp_train checks failed: {json.dumps(checks)} "
                     f"{json.dumps({m: [r[m].get('max_abs_diff_vs_ddp') for r in ranks] for m in modes})}")
    return out


# --------------------------------------------------------- train_resilient
# The schedule of scripts/resilience_smoke.py extended for the card, on
# GPT-2's 12 steps (saves every 3: steps 2, 5, 8, 11).  faultsim's call=
# is 0-based: the second save's meta.json write fails once (the native
# writer carries the chunks, meta.json the retried storage path) and the
# fifth batch fetch once; NaN at steps 6-7; the wrapper of step 9 asks,
# once, for more than the card has free; a preemption at step 10.
RESIL_SCHEDULE = ("storage_write:call=1;loader_next:call=4;nonfinite_loss:step=6,count=2;"
                  "preempt:step=10")
RESIL_OOM_STEP = 9
# what the reference loop gives for this schedule on the toy step, with the
# OOM injected by faultsim (tests/test_torch_resilience.py, case
# card_schedule, holds both loops to it): one rollback, one restart, the
# emergency save of step 9
RESIL_EXPECT = dict(status="preempted", step=9, restarts=1, rollbacks=1, anomaly_steps=2,
                    emergency_save_step=9)
RESIL_STEPS, RESIL_SAVE_EVERY = 12, 3
RESIL_GPT_RUNG, RESIL_LLAMA_RUNG = "gpt2", "1.3b"  # bench rungs of the legs
# the GPT-2 fault leg's depth: 12 -> 2 layers at full width (held to its own
# golden run), so the script with the examples phase stays inside its time
# (PERF.md §7; 12 until the nd phase came, 4 until the examples)
RESIL_GPT2_LAYERS = 2
RESIL_13B_STEPS, RESIL_13B_PREEMPT = 4, 2
# the 1.3B leg's depth: 24 -> 2 layers at full width (its golden run at the
# same depth), so the script with the longctx, fp8, nd and examples phases
# stays inside its time (PERF.md §4; 8 until the nd phase came, 4 until the
# examples)
RESIL_13B_LAYERS = 2
RESIL_DP_STEPS, RESIL_DP_SIGTERM_AFTER, RESIL_DP_ULP_AFTER = 8, 3, 3


def _leaf_bytes(params, opt_state) -> dict:
    """Every parameter and optimizer-state leaf as a uint8 view, where it
    lies."""
    from vescale_tpu_torch.checkpoint.planner import flatten_state

    return {f"{top}/{k}": torch.as_tensor(v).detach().contiguous().view(-1).view(torch.uint8)
            for top, tree in (("model", params), ("optimizer", opt_state))
            for k, v in flatten_state(tree)}


def _state_bits(params, opt_state) -> dict:
    """Every leaf's bytes copied into one pinned host buffer (a copy held
    on the card would count in the peaks the legs read)."""
    leaves = _leaf_bytes(params, opt_state)
    buf = torch.empty(sum(t.numel() for t in leaves.values()), dtype=torch.uint8,
                      pin_memory=True)
    out, at = {}, 0
    for k, t in leaves.items():
        out[k] = buf[at:at + t.numel()]
        out[k].copy_(t, non_blocking=True)
        at += t.numel()
    torch.cuda.synchronize()
    return out


def _matches(params, opt_state, bits: dict) -> bool:
    """The state bitwise ``bits`` (``_state_bits``), leaf by leaf where the
    state lies."""
    leaves = _leaf_bytes(params, opt_state)
    return leaves.keys() == bits.keys() and all(
        torch.equal(t, bits[k].to(t.device, non_blocking=True)) for k, t in leaves.items())


def _loss_hex(losses: dict) -> list:
    return [np.float64(losses[i]).tobytes().hex() for i in sorted(losses)]


def resil_prepare(rung: str, dev, token_file=None, layers=None):
    """A bench rung in the functional signature: (run, FunctionalStep)."""
    from vescale_tpu_torch import bench
    from vescale_tpu_torch.train import FunctionalStep

    run = bench.prepare(rung, device=dev, token_file=token_file, layers=layers)
    return run, FunctionalStep(run.step, run.model, run.optimizer)


def resil_drive(fstep, run, root, *, total, save_every, step_fn=None, times=None, drain_at=(3,),
                keep=2, peaks=None, **kw):
    """``run_resilient`` over ``fstep`` and ``run``'s batches.  ``times``
    collects each committed step's wall (the gap between ``on_step``
    calls: the batch, the step, the loss read and the loop); ``peaks``
    the allocator's peak bytes over the same gap (the first one from the
    call's start, so it holds a resume's restore).  The pending
    save is drained after each step in ``drain_at`` (``on_step`` runs
    before that step's own save: 3 drains the save of step 2), so that a
    committed checkpoint exists before a fault restores.  The loop, as the
    reference's, asks for a committed step before it drains a pending one,
    so an async commit would race it; a drain moves when a commit lands,
    not what is computed."""
    from vescale_tpu_torch.checkpoint import CheckpointManager
    from vescale_tpu_torch.resilience import run_resilient

    mgr = CheckpointManager(root, keep=keep)
    last = [time.perf_counter()]

    def on_step(step, loss):
        now = time.perf_counter()
        if times is not None:
            times.append((now - last[0]) * 1e3)
        last[0] = now
        if peaks is not None:
            peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        if step in drain_at:
            mgr.wait_pending()

    data = dict(loader=run.loader) if run.loader is not None else \
        dict(batch_fn=lambda i: run.next_batch())
    res = run_resilient(step_fn=step_fn or fstep, params=fstep.params, opt_state=fstep.opt_state,
                        manager=mgr, total_steps=total, save_every=save_every,
                        install_signal_handlers=False, restart_backoff=0.01, on_step=on_step,
                        **data, **kw)
    return res, mgr


def resil_oom(fstep, dev, step: int):
    """``fstep`` that, once, before step ``step`` (by the optimizer's
    count, which a restore brings back), allocates 1 GiB more than the
    card holds (more than it has free, the allocator's cached blocks
    included): a real ``torch.cuda.OutOfMemoryError``."""
    fired = []

    def step_fn(params, opt_state, batch, step_key=None):
        if not fired and fstep.optimizer.param_groups[0]["step"] == step:
            free, total = torch.cuda.mem_get_info(dev)
            fired.append(dict(free=free, total=total, asked=total + (1 << 30)))
            torch.empty(total + (1 << 30), dtype=torch.uint8, device=dev)
        return fstep(params, opt_state, batch, step_key)

    return step_fn, fired


def resil_save_restore(fstep, root) -> dict:
    """One synchronous save and one restore of ``fstep``'s state through a
    manager: seconds, GB/s of the chunk bytes, and the restore bitwise."""
    from vescale_tpu_torch import checkpoint
    from vescale_tpu_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager(root, keep=1)
    state = {"model": fstep.params, "optimizer": fstep.opt_state}
    before = _state_bits(fstep.params, fstep.opt_state)
    nbytes = sum(v.numel() for v in before.values())
    torch.cuda.synchronize()
    t = time.perf_counter()
    mgr.save(0, state)
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    out = mgr.restore(state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    ok = _matches(out["model"], out["optimizer"], before)
    del out, before
    shutil.rmtree(root, ignore_errors=True)
    return dict(bytes=int(nbytes), save_s=save_s, save_GBps=nbytes / save_s / 1e9,
                restore_s=restore_s, restore_GBps=nbytes / restore_s / 1e9,
                bytes_read=checkpoint.LAST_LOAD_STATS["bytes_read"], restored_bitwise=ok)


def resil_gpt2_leg(dev, token_file, tmp, kernels_mod):
    """Leg 1: GPT-2 124M at ``RESIL_GPT2_LAYERS`` of its 12 layers, the
    golden run against the faulted run and its resume on fresh objects."""
    from vescale_tpu_torch import telemetry
    from vescale_tpu_torch.resilience import AnomalyPolicy, faultsim, parse_schedule

    tel_dir = os.path.join(tmp, "telemetry")
    kw = dict(total=RESIL_STEPS, save_every=RESIL_SAVE_EVERY, async_save=True,
              anomaly=AnomalyPolicy(threshold=2))
    telemetry.init(out_dir=tel_dir)
    try:
        reg = telemetry.get_registry()
        kernels_mod.reset_launches()
        run, fstep = resil_prepare(RESIL_GPT_RUNG, dev, token_file, RESIL_GPT2_LAYERS)
        golden_ms = []
        golden, _ = resil_drive(fstep, run, os.path.join(tmp, "golden"), times=golden_ms, **kw)
        torch.cuda.synchronize()
        golden_launches = dict(kernels_mod.LAUNCHES)
        golden_bits = _state_bits(fstep.params, fstep.opt_state)
        snap = reg.snapshot()
        # the gauges as the last step's sample (inside the step) set them, and
        # the census between steps
        from vescale_tpu_torch.telemetry import memtrack

        mem = dict(torch_memory_allocated=torch.cuda.memory_allocated(dev),
                   census_between_steps=memtrack.get_tracker().census()["tags"],
                   **{k: v for k, v in snap["gauges"].items() if k.startswith("mem_")})
        submit = snap["histograms"]["checkpoint_save_seconds"]
        sr = resil_save_restore(fstep, os.path.join(tmp, "timed"))
        run.close()
        del run, fstep
        free_memory()
        before = dict(reg.snapshot()["counters"])
        kernels_mod.reset_launches()
        run, fstep = resil_prepare(RESIL_GPT_RUNG, dev, token_file, RESIL_GPT2_LAYERS)
        root = os.path.join(tmp, "faulted")
        step_fn, oom_fired = resil_oom(fstep, dev, RESIL_OOM_STEP)
        faultsim.arm(parse_schedule(RESIL_SCHEDULE))
        try:
            r1, _ = resil_drive(fstep, run, root, step_fn=step_fn, **kw)
            fired = dict(faultsim.get_injector().fired_total)
        finally:
            faultsim.disarm()
        run.close()
        del run, fstep, step_fn
        free_memory()
        run, fstep = resil_prepare(RESIL_GPT_RUNG, dev, token_file, RESIL_GPT2_LAYERS)  # a new process's objects
        r2, _ = resil_drive(fstep, run, root, **kw)
        torch.cuda.synchronize()
        resumed_bitwise = _matches(fstep.params, fstep.opt_state, golden_bits)
        del golden_bits
        launches = dict(kernels_mod.LAUNCHES)
        after = reg.snapshot()["counters"]
        counters = {k: v - before.get(k, 0) for k, v in after.items()}
        dash = telemetry.dashboard()
        run.close()
        del run, fstep
        free_memory()
    finally:
        telemetry.shutdown()
    records = [json.loads(line) for line in open(os.path.join(tel_dir, "steps.jsonl"))]
    step_lines = [r for r in records if "event" not in r]
    events = sorted({r["event"] for r in records if "event" in r})
    flights = sorted(f for f in os.listdir(tel_dir) if f.startswith("flight_record_"))
    ooms = [d for d in (json.load(open(os.path.join(tel_dir, f))) for f in flights)
            if d["reason"] == "oom:OutOfMemoryError"]
    got = dict(status=r1.status, step=r1.step, restarts=r1.restarts, rollbacks=r1.rollbacks,
               anomaly_steps=r1.anomaly_steps, emergency_save_step=r1.emergency_save_step)
    losses = {**r1.losses, **r2.losses}
    for k in golden_launches:
        launches[k] += golden_launches[k]
    checks = {
        "golden_completed": golden.status == "completed" and golden.step == RESIL_STEPS - 1,
        "run_result_is_the_references": got == RESIL_EXPECT,
        "resumed_completed": r2.status == "completed" and r2.step == RESIL_STEPS - 1,
        "losses_bitwise": len(losses) == RESIL_STEPS
        and _loss_hex(losses) == _loss_hex(golden.losses),
        "params_and_moments_bitwise": resumed_bitwise,
        "faults_fired": (fired["storage_write"], fired["loader_next"], fired["nonfinite_loss"],
                         fired["preempt"], len(oom_fired)) == (1, 1, 2, 1, 1),
        "counters": counters.get("resilience_rollbacks_total") == 1
        and counters.get("resilience_restarts_total") == 1
        and counters.get("resilience_emergency_saves_total") == 1
        and counters.get("resilience_io_retries_total", 0) >= 2
        and counters.get("checkpoint_saves_total", 0) >= 4
        and counters.get("checkpoint_commits_total", 0) >= 4
        and counters.get("checkpoint_loads_total", 0) >= 3,
        "dashboard_resilience_block": "resilience:" in dash and "memory:" in dash,
        "steps_jsonl_line_a_step": len(step_lines) == int(after["train_steps_total"])
        and {"resilience_rollback", "resilience_restart", "resilience_preempted",
             "resilience_resume"} <= set(events),
        "flight_record_names_the_oom": len(ooms) == 1
        and "CUDA out of memory" in ooms[0]["exception"]
        and ooms[0]["device_memory"][0]["source"] == "device",
        "timed_restore_bitwise": sr["restored_bitwise"],
        "k8_a_step": golden_launches["fused_adamw"] == RESIL_STEPS,
    }
    return dict(run_result=got, steps_jsonl_lines=len(step_lines),
                train_steps_total=after["train_steps_total"], losses=losses,
                golden_losses=golden.losses,
                golden_step_ms=golden_ms, golden_step_ms_median=float(np.median(golden_ms)),
                async_save_submit_s=dict(p50=submit.get("p50"), max=submit.get("max"),
                                         n=submit["count"]),
                save_restore=sr, memtrack_vs_allocator=mem, faults_fired=fired,
                oom_free_bytes=oom_fired, counters=counters, events=events,
                flight_records=flights, launches=launches, checks=checks)


def resil_envelope_leg(dev, token_file, tmp, kernels_mod):
    """Leg 2: the quiet envelope's cost on GPT-2, 12 steps each: the bare
    loop of ``bench.measure``, ``run_resilient`` with nothing armed and no
    save but the final one, and the same with telemetry on; in the order
    bare, loop, telemetry, telemetry, loop, bare."""
    from vescale_tpu_torch import telemetry

    def bare():
        run, _ = resil_prepare(RESIL_GPT_RUNG, dev, token_file)
        ms = []
        for _ in range(RESIL_STEPS):
            t = time.perf_counter()
            float(run.step(run.next_batch()))
            ms.append((time.perf_counter() - t) * 1e3)
        run.close()
        return ms

    parts = {}

    def loop(tel: bool):
        run, fstep = resil_prepare(RESIL_GPT_RUNG, dev, token_file)
        if tel:
            telemetry.init(out_dir=os.path.join(tmp, "tel_envelope"))
        ms = []
        try:
            resil_drive(fstep, run, os.path.join(tmp, "envelope"), total=RESIL_STEPS,
                        save_every=10 ** 9, async_save=True, times=ms, drain_at=())
            if tel:  # the telemetry step's parts, 20 calls each, host clock
                from vescale_tpu_torch.telemetry import memory_report, memtrack

                reg = telemetry.get_registry()
                for name, fn in (("memtrack_on_step", lambda: memtrack.get_tracker().on_step(
                                     0, reg)),
                                 ("device_memory_stats", memory_report.device_memory_stats),
                                 ("census", lambda: memtrack.get_tracker().census()),
                                 ("tag_trees", fstep._refresh)):
                    t = time.perf_counter()
                    for _ in range(20):
                        fn()
                    parts.setdefault(name, []).append((time.perf_counter() - t) / 20 * 1e3)
        finally:
            telemetry.shutdown()
            run.close()
            shutil.rmtree(os.path.join(tmp, "envelope"), ignore_errors=True)
        return ms[:-1]  # the last step carries the final save

    out = {}
    for i, (name, fn) in enumerate((("bare", bare), ("loop", lambda: loop(False)),
                                    ("telemetry", lambda: loop(True)),
                                    ("telemetry", lambda: loop(True)),
                                    ("loop", lambda: loop(False)), ("bare", bare))):
        ms = fn()
        free_memory()
        out.setdefault(name, []).append(dict(step_ms=ms, median_ms=float(np.median(ms[2:]))))
    med = {k: [r["median_ms"] for r in v] for k, v in out.items()}
    return dict(runs=out, median_ms=med, telemetry_parts_ms=parts,
                loop_over_bare=float(np.mean(med["loop"]) / np.mean(med["bare"])),
                telemetry_over_bare=float(np.mean(med["telemetry"]) / np.mean(med["bare"])))


def resil_13b_leg(dev, tmp, kernels_mod):
    """Leg 3: the 1.3B at full width and ``RESIL_13B_LAYERS`` deep, 4
    steps of the bare step loop of ``bench.measure`` (what the loop with
    nothing armed must compute; its peak bytes are the loop's yardstick)
    against a run preempted at step 2 (an emergency synchronous save of
    the whole state) and its resume on fresh objects, bitwise; K8 once a
    completed step."""
    root = os.path.join(tmp, "llama13b")
    run, fstep = resil_prepare(RESIL_LLAMA_RUNG, dev, layers=RESIL_13B_LAYERS)
    golden, bare_peaks = [], []
    for _ in range(RESIL_13B_STEPS):
        torch.cuda.reset_peak_memory_stats(dev)
        golden.append(float(run.step(run.next_batch())))
        bare_peaks.append(torch.cuda.max_memory_allocated(dev))
    fstep._refresh()  # the trees of the state the bare steps left
    golden_bits = _state_bits(fstep.params, fstep.opt_state)
    nbytes = sum(v.numel() for v in golden_bits.values())
    del run, fstep
    free_memory()
    from vescale_tpu_torch.resilience import faultsim, parse_schedule

    from vescale_tpu_torch import checkpoint, telemetry

    out = {}
    for leg in ("preempted", "resumed"):
        kernels_mod.reset_launches()
        run, fstep = resil_prepare(RESIL_LLAMA_RUNG, dev, layers=RESIL_13B_LAYERS)
        torch.cuda.reset_peak_memory_stats(dev)
        peaks = []
        if leg == "preempted":
            faultsim.arm(parse_schedule(f"preempt:step={RESIL_13B_PREEMPT}"))
        telemetry.init(out_dir=None, memtrack=False)  # the checkpoint's seconds
        t = time.perf_counter()
        try:
            res, mgr = resil_drive(fstep, run, root, total=RESIL_13B_STEPS, save_every=10 ** 9,
                                   async_save=True, drain_at=(), keep=1, peaks=peaks)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            hist = telemetry.get_registry().snapshot()["histograms"]
        finally:
            faultsim.disarm()
            telemetry.shutdown()
        out[leg] = dict(status=res.status, step=res.step, losses=res.losses, wall_s=wall,
                        emergency_save_step=res.emergency_save_step,
                        launches=dict(kernels_mod.LAUNCHES), step_peak_bytes=peaks,
                        peak_memory_bytes=max(peaks + [torch.cuda.max_memory_allocated(dev)]),
                        checkpoint_seconds={k: dict(n=v["count"], sum=v["sum"])
                                            for k, v in hist.items()
                                            if k.startswith("checkpoint_")})
        if leg == "preempted":  # the one save: the emergency save, synchronous
            out[leg]["emergency_save_s"] = hist["checkpoint_save_seconds"]["sum"]
        else:  # the one load: the resume's restore
            out[leg]["restore_s"] = hist["checkpoint_load_seconds"]["sum"]
            out[leg]["bytes_read"] = checkpoint.LAST_LOAD_STATS["bytes_read"]
        if leg == "resumed":
            out[leg]["bitwise"] = _matches(fstep.params, fstep.opt_state, golden_bits)
        del run, fstep, res, mgr
        free_memory()
    del golden_bits
    free_memory()
    out["bare_step_peak_bytes"] = bare_peaks
    return out, golden, nbytes


def resil_dp_job(mesh, root: str, token_file: str):
    """One rank of leg 4: GPT-2 (``GLOO_GPT2_LAYERS`` deep) at B=6 a rank
    under the default
    ``DistributedDataParallel``, coordinated (two processes), consistency
    every 2 steps, saves every 3, 8 steps: (golden) uninterrupted; (a) a
    real SIGTERM to rank 1 after step 3, agreed, emergency-saved with a
    two-phase commit, resumed on fresh objects; (b) rank 1 alone moves one
    sampled element of a replicated parameter by one ulp after step 3."""
    from vescale_tpu_torch import bench, kernels
    from vescale_tpu_torch.checkpoint import CheckpointManager
    from vescale_tpu_torch.resilience import DesyncError, run_resilient
    from vescale_tpu_torch.train import FunctionalStep

    me = mesh.get_rank()

    def drive(sub, step_fn_of=None, on_step=None, install=False):
        run = bench.prepare_dp(RESIL_GPT_RUNG, "ddp", mesh, token_file=token_file,
                               layers=GLOO_GPT2_LAYERS)
        fstep = FunctionalStep(run.step, run.model, run.optimizer)
        mgr = CheckpointManager(os.path.join(root, sub), keep=2)
        ms, last = [], [time.perf_counter()]

        def tick(step, loss):
            now = time.perf_counter()
            ms.append((now - last[0]) * 1e3)
            last[0] = now
            if on_step is not None:
                on_step(step)

        try:
            res = run_resilient(step_fn=step_fn_of(fstep) if step_fn_of else fstep,
                                params=fstep.params, opt_state=fstep.opt_state, manager=mgr,
                                total_steps=RESIL_DP_STEPS, loader=run.loader, save_every=3,
                                async_save=True, consistency_every=2,
                                install_signal_handlers=install, barrier_timeout_s=300.0,
                                on_step=tick)
            out = dict(status=res.status, step=res.step, losses=res.losses,
                       emergency_save_step=res.emergency_save_step)
        except DesyncError as e:
            out = dict(desync=sorted(e.mismatched))
        out.update(latest=mgr.latest_step(), step_ms=ms)
        run.close()
        del run, fstep
        free_memory()
        return out

    def sigterm(step):
        if me == 1 and step == RESIL_DP_SIGTERM_AFTER:
            os.kill(os.getpid(), signal.SIGTERM)  # a real signal; the handler sets a flag

    def bump(fstep):
        def step_fn(params, opt_state, batch, step_key=None):
            out = fstep(params, opt_state, batch, step_key)
            if me == 1 and fstep.optimizer.param_groups[0]["step"] == RESIL_DP_ULP_AFTER + 1:
                p = next(iter(fstep.module.parameters()))
                with torch.no_grad():  # element 0: the fingerprint samples every 4097th
                    v = p.view(-1)[0]
                    p.view(-1)[0] = torch.nextafter(v, v + 1)
            return out
        return step_fn

    t = time.perf_counter()
    golden = drive("golden")
    kernels.reset_launches()
    preempted = drive("preempt", on_step=sigterm, install=True)
    resumed = drive("preempt")
    launches = dict(kernels.LAUNCHES)
    desync = drive("desync", step_fn_of=bump)
    return dict(rank=me, golden=golden, preempted=preempted, resumed=resumed, desync=desync,
                launches_total=launches, wall_s=time.perf_counter() - t)


TP_JOBS["resil"] = resil_dp_job


def run_train_resilient(dev, card, kernels_mod):
    """``train_resilient``: the resilient loop on the card (legs 1-4)."""
    from vescale_tpu_torch import bench
    from vescale_tpu_torch.models import GPTConfig

    tmp = tempfile.mkdtemp(prefix="vtt_resil_")
    t0 = time.perf_counter()
    try:
        vocab = GPTConfig(**bench.GPT_RUNGS[RESIL_GPT_RUNG][0]).vocab_size
        token_file = bench.write_token_file(os.path.join(tmp, "tokens.bin"), bench.DATA_TOKENS,
                                            vocab)
        # leg 4's ranks start up while legs 1-3 run, and wait for them
        spawned = tp_spawn_start("resil", dict(root=os.path.join(tmp, "dp"),
                                               token_file=token_file), names=("dp",), held=True)
        try:
            t = time.perf_counter()
            gpt2 = resil_gpt2_leg(dev, token_file, tmp, kernels_mod)
            gpt2["seconds"] = time.perf_counter() - t
            t = time.perf_counter()
            envelope = resil_envelope_leg(dev, token_file, tmp, kernels_mod)
            envelope["seconds"] = time.perf_counter() - t
            t = time.perf_counter()
            llama, golden13, nbytes = resil_13b_leg(dev, tmp, kernels_mod)
            llama_s = time.perf_counter() - t
        except BaseException:
            tp_spawn_abort(spawned)
            raise
        t = time.perf_counter()
        tp_spawn_release(spawned)
        ranks = tp_spawn_finish(spawned, timeout_s=600)
        dp_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    pre, res = llama["preempted"], llama["resumed"]
    llama_losses = {**pre["losses"], **res["losses"]}
    g = [r["golden"] for r in ranks]
    a = [(r["preempted"], r["resumed"]) for r in ranks]
    b = [r["desync"] for r in ranks]
    checks = {
        **{f"gpt2_{k}": v for k, v in gpt2["checks"].items()},
        "13b_preempted": (pre["status"], pre["step"], pre["emergency_save_step"])
        == ("preempted", RESIL_13B_PREEMPT - 1, RESIL_13B_PREEMPT - 1),
        "13b_resumed": res["status"] == "completed" and res["step"] == RESIL_13B_STEPS - 1,
        "13b_losses_bitwise": _loss_hex(llama_losses) == _loss_hex(dict(enumerate(golden13))),
        "13b_masters_and_moments_bitwise": res["bitwise"],
        "13b_k8_once_a_step": pre["launches"]["fused_adamw"] == RESIL_13B_PREEMPT
        and res["launches"]["fused_adamw"] == RESIL_13B_STEPS - RESIL_13B_PREEMPT,
        "dp_golden": all(x["status"] == "completed" for x in g)
        and _loss_hex(g[0]["losses"]) == _loss_hex(g[1]["losses"]),
        "dp_sigterm_agreed": all(p["status"] == "preempted" and p["step"] == RESIL_DP_SIGTERM_AFTER
                                 and p["emergency_save_step"] == RESIL_DP_SIGTERM_AFTER
                                 and p["latest"] == RESIL_DP_SIGTERM_AFTER for p, _ in a),
        "dp_resumed_bitwise": all(r["status"] == "completed" and
                                  _loss_hex({**p["losses"], **r["losses"]}) ==
                                  _loss_hex(g[0]["losses"]) for p, r in a),
        "dp_desync_on_both_ranks": all(x.get("desync") == ["params"] for x in b),
        "dp_nothing_committed_after_the_change": all(
            x["latest"] is not None and x["latest"] < RESIL_DP_ULP_AFTER for x in b),
    }
    llama_out = dict(
        model=f"llama 1.3B (bench rung 1.3b) at {RESIL_13B_LAYERS} of 24 layers",
        state_bytes=nbytes, golden_losses=golden13,
        preempted=pre, resumed=res, seconds=llama_s,
        bare_step_peak_bytes=llama["bare_step_peak_bytes"],
        loop_peak_over_bare=max(pre["peak_memory_bytes"], res["peak_memory_bytes"])
        / max(llama["bare_step_peak_bytes"]),
        emergency_save_GBps=nbytes / pre["emergency_save_s"] / 1e9,
        restore_GBps=nbytes / res["restore_s"] / 1e9)
    out = dict(card=card, wall_s=time.perf_counter() - t0, gpt2=gpt2, envelope=envelope,
               llama13b=llama_out, dp=dict(ranks=ranks, seconds=dp_s), checks=checks,
               ok=all(checks.values()),
               launches={k: gpt2["launches"][k] + pre["launches"][k] + res["launches"][k]
                         + sum(r["launches_total"].get(k, 0) for r in ranks)
                         for k in kernels_mod.LAUNCHES})
    check(out["ok"], "train_resilient checks failed: "
          + json.dumps({k: v for k, v in checks.items() if not v}) + " "
          + json.dumps({k: gpt2[k] for k in ("run_result", "faults_fired", "oom_free_bytes",
                                             "counters", "events", "flight_records",
                                             "steps_jsonl_lines", "train_steps_total")}))
    return out


# --------------------------------------------------------------- telemetry
TELEMETRY_STEPS = 6  # GPT-2 steps of the traced leg: the gpt2 phase's first six
TELEMETRY_SAVE_AFTER = 3  # an async save follows this step; the next one commits it
TELEMETRY_PROFILED = 2  # the last steps, under torch.profiler
# the span each kernel's launches must lie in
KERNEL_SPAN = {"flash_fwd": "train-step", "flash_bwd_dq": "train-step",
               "flash_bwd_dkv": "train-step", "fused_xent_fwd": "train-step",
               "fused_xent_bwd": "train-step", "fused_adamw": "optimizer-step"}


def launch_name(kernel: str):
    """The ``LAUNCHES`` name of a device kernel's name in a trace, or None."""
    for part, name in (("flash_fwd_kernel", "flash_fwd"), ("dq::kernel", "flash_bwd_dq"),
                       ("dkv::kernel", "flash_bwd_dkv"), ("adamw_kernel", "fused_adamw"),
                       ("xent_fwd_kernel", "fused_xent_fwd"),
                       ("xent_bwd_kernel", "fused_xent_bwd"),
                       ("paged_decode_kernel", "paged_decode")):
        if part in kernel:
            return name
    return None


def launches_in_spans(trace_path: str) -> dict:
    """Where each launch of the port's kernels in a ``torch.profiler``
    Chrome trace lies: per kernel, how many launches, and how many lie
    inside a host range of its span (``KERNEL_SPAN``).  A launch is placed
    by its runtime call (``cuda_runtime``/``cuda_driver`` events joined to
    the kernel by correlation id) inside the span's ``user_annotation``
    range; a kernel without a joined call is placed by its device interval
    inside the span's ``gpu_user_annotation`` range."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    host, device, calls = {}, {}, {}
    for e in events:
        cat, name = e.get("cat"), e.get("name")
        if cat == "user_annotation":
            host.setdefault(name, []).append((e["ts"], e["ts"] + e.get("dur", 0)))
        elif cat == "gpu_user_annotation":
            device.setdefault(name, []).append((e["ts"], e["ts"] + e.get("dur", 0)))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            calls[e["args"]["correlation"]] = e["ts"]
    out = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = launch_name(e.get("name", ""))
        if name is None:
            continue
        row = out.setdefault(name, {"launches": 0, "inside": 0, "by_call": 0, "by_device": 0})
        row["launches"] += 1
        span = KERNEL_SPAN.get(name)
        t = calls.get(e.get("args", {}).get("correlation"))
        if t is not None:
            row["by_call"] += 1
            inside = any(a <= t <= b for a, b in host.get(span, ()))
        else:
            row["by_device"] += 1
            a0, b0 = e["ts"], e["ts"] + e.get("dur", 0)
            inside = any(a <= a0 and b0 <= b for a, b in device.get(span, ()))
        row["inside"] += int(inside)
    return out


def run_telemetry_gpt2(dev, kernels_mod, gpt2: dict) -> dict:
    """GPT-2 124M at full width with the whole telemetry stack on:
    ``telemetry.init`` (the time-series store, the alert engine and the cost
    auditor on), ndtimeline active with a ``ChromeTraceHandler``, six steps
    from ``TokenDataLoader`` with an async save after step 3 (committed in
    step 4), the last two under ``torch.profiler``.  Then the step report,
    and the calibration's matmul sample and ``device_peak_flops``."""
    from torch.profiler import ProfilerActivity, profile

    from vescale_tpu_torch import checkpoint
    from vescale_tpu_torch import ndtimeline as nd
    from vescale_tpu_torch import telemetry as tel
    from vescale_tpu_torch.bench import prepare
    from vescale_tpu_torch.models import module_tree
    from vescale_tpu_torch.ndtimeline import predefined as P
    from vescale_tpu_torch.telemetry import calibrate, trace

    tmp = tempfile.mkdtemp(prefix="vtt_telemetry_")
    run = prepare("gpt2", device=dev)
    try:
        st = tel.init(out_dir=os.path.join(tmp, "telemetry"))
        chrome = nd.ChromeTraceHandler(os.path.join(tmp, "gpt2_spans.json"))
        mgr = nd.init_ndtimers(handlers=[chrome])
        kernels_mod.reset_launches()
        losses, step_ms, handle, prof_launches = [], [], None, {}
        trace_path = os.path.join(tmp, "profile.json")

        def one_step():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(run.step(run.next_batch())))
            step_ms.append((time.perf_counter() - t0) * 1e3)

        for i in range(TELEMETRY_STEPS - TELEMETRY_PROFILED):
            one_step()
            if i + 1 == TELEMETRY_SAVE_AFTER:
                state = {"model": module_tree(run.model),
                         "optimizer": run.optimizer.state_tree(run.model)}
                handle = checkpoint.save(os.path.join(tmp, "ckpt"), state, async_checkpoint=True)
            elif handle is not None:
                handle.wait()
                handle = None
        before = dict(kernels_mod.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(TELEMETRY_PROFILED):
                one_step()
            torch.cuda.synchronize()
        prof_launches = {k: kernels_mod.LAUNCHES[k] - before[k] for k in before}
        prof.export_chrome_trace(trace_path)
        placed = launches_in_spans(trace_path)
        launches = dict(kernels_mod.LAUNCHES)
        spans = mgr.tail(1_000_000)
        counts = {m: sum(1 for s in spans if s.metric == m) for m in (
            P.TRAIN_STEP, P.DATA_LOAD, P.OPTIMIZER_STEP, P.CHECKPOINT_SAVE, P.CHECKPOINT_COMMIT)}
        lines = [json.loads(x) for x in
                 open(os.path.join(tmp, "telemetry", "steps.jsonl")).read().splitlines()]
        step_lines = [x for x in lines if "event" not in x]
        nd.flush()
        perfetto = chrome.write()
        back = trace.spans_from_perfetto(perfetto)
        cp = trace.critical_path(back)
        traced_ms = statistics.median(step_ms[1:TELEMETRY_STEPS - TELEMETRY_PROFILED])

        t = time.perf_counter()
        rep = tel.write_step_report("gpt2", run.step, run.next_batch())
        report_s = time.perf_counter() - t
        analytic = run.flops_per_token * run.tokens_per_step
        layers = rep["layer_attribution"]["layers"]
        top = [{k: r[k] for k in ("layer", "flops", "bytes", "bound", "est_us", "kernels")}
               for r in layers[:5]]
        # the blocks' share of the FLOPs, backward included: the tied head
        # (a top-level matmul, keyed "mm") and the loss take the rest
        blocks_share = sum(r["flops"] for r in layers if r["layer"].startswith("h_")) / rep["flops"]
        mm = calibrate.matmul_gflops(dev)
        peak = calibrate.device_peak_flops(dev)
        alerts_digest = tel.alerts.digest()
        ref = gpt2["losses"][:TELEMETRY_STEPS]
        L = run.config.n_layer
        want = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L, "fused_xent_fwd": 1,
                "fused_xent_bwd": 1, "fused_adamw": 1}
        checks = {
            "three_subsystems_on": st.timeseries is not None and st.alerts is not None
            and st.costaudit is not None,
            "losses_bitwise_the_gpt2_phase": losses == ref,
            "span_counts": counts == {P.TRAIN_STEP: TELEMETRY_STEPS, P.DATA_LOAD: TELEMETRY_STEPS,
                                      P.OPTIMIZER_STEP: TELEMETRY_STEPS, P.CHECKPOINT_SAVE: 1,
                                      P.CHECKPOINT_COMMIT: 1},
            "every_step_line_has_spans": len(step_lines) == TELEMETRY_STEPS and all(
                P.TRAIN_STEP in x.get("spans", {}) for x in step_lines),
            "perfetto_round_trip": sorted((s.metric, s.step) for s in back)
            == sorted((s.metric, s.step) for s in spans),
            "profiled_launches_counted": all(
                placed.get(k, {}).get("launches", 0) == prof_launches[k] == n * TELEMETRY_PROFILED
                for k, n in want.items()),
            "profiled_launches_in_their_spans": all(
                k in placed and placed[k]["inside"] == placed[k]["launches"] for k in want),
            "step_report_flops": rep["flops"] is not None and rep["flops"] > 0,
            "step_report_peak": rep["peak_bytes"] is not None and rep["peak_bytes"] > 0,
            "step_report_blocks_attributed": blocks_share >= 0.6,
        }
        out = dict(
            model="GPT-2 124M (bench rung gpt2)", steps=TELEMETRY_STEPS, losses=losses,
            step_ms=step_ms, traced_step_ms_median=traced_ms,
            untraced_step_ms_median=gpt2["step_ms_median"],
            traced_over_untraced=traced_ms / gpt2["step_ms_median"],
            span_counts=counts, launches=launches, profiled_launches=prof_launches,
            profiled_placement=placed, critical_path_coverage=cp["coverage"],
            perfetto_events=len(back), alerts=alerts_digest,
            step_report=dict(seconds=report_s, flops=rep["flops"], analytic_flops=analytic,
                             flops_over_analytic=rep["flops"] / analytic,
                             bytes_accessed=rep["bytes_accessed"], peak_bytes=rep["peak_bytes"],
                             gpt2_phase_peak_bytes=gpt2["peak_memory_bytes"],
                             collectives=rep["collectives"], top_layers=top,
                             blocks_flops_share=blocks_share,
                             roofline=dict(peak_flops=rep["layer_attribution"]["peak_flops"],
                                           mem_gbps=rep["layer_attribution"]["mem_gbps"])),
            calibration=dict(matmul_gflops_fp32_256=mm, device_peak_flops=peak),
            checks=checks)
        check(all(checks.values()), f"telemetry gpt2 checks failed: {out}")
    finally:
        tel.shutdown()
        nd.api.deinit_ndtimers()
        run.close()
        shutil.rmtree(tmp, ignore_errors=True)
    del run
    free_memory()
    return out


def run_telemetry_serve(dev, eng, kernels_mod, serve_streams) -> dict:
    """The serve phase's 8B engine and 16 requests with the whole telemetry
    stack on (``telemetry.init``, ndtimeline active, request traces, the
    ops server for ``/router``), then the same requests untraced, in this
    order in one process.  A calibration table carrying the card's matmul
    sample prices the decode step before the run; the auditor's harvest of
    the run's decode spans prices it after."""
    from vescale_tpu_torch import ndtimeline as nd
    from vescale_tpu_torch import telemetry as tel
    from vescale_tpu_torch.serve import ContinuousBatchingScheduler, ServeObservability, run_serve
    from vescale_tpu_torch.serve import reqtrace
    from vescale_tpu_torch.telemetry import calibrate, ops_server

    arrivals = serve_requests(eng.config.vocab_size)
    L = eng.config.num_hidden_layers
    table = calibrate.CalibrationTable(meta={"platform": "cuda",
                                             "matmul_gflops": calibrate.matmul_gflops(dev)})
    calibrate.set_active(table)
    router = {}

    def on_step(step, active):
        srv = ops_server.active_server()
        if srv is not None and not router and active:
            router.update(http_json(srv.url + "/router"))

    os.environ["VESCALE_SERVE_OPS_PORT"] = "0"
    try:
        st = tel.init(out_dir=None)
        mgr = nd.init_ndtimers()
        eng.cache.reset()
        sched = ContinuousBatchingScheduler(eng.cache)
        est_analytic = ServeObservability(sched, engine=eng).calibrated_step_estimate()
        kernels_mod.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_serve(eng, sched, arrivals, on_step=on_step)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
        launches = dict(kernels_mod.LAUNCHES)
        spans = mgr.tail(1_000_000)
        problems = reqtrace.verify_request_chains(spans, res.outcomes)
        est_audited = ServeObservability(sched, engine=eng).calibrated_step_estimate()
        digest = tel.alerts.digest()
        three_on = (st.timeseries is not None and st.alerts is not None
                    and st.costaudit is not None)
        traced = dict(serve_s=traced_wall, decode_step_p50_ms=1e3 * sched.percentile("step_time", 0.5),
                      decode_step_p99_ms=1e3 * sched.percentile("step_time", 0.99),
                      ttft_p50_s=sched.percentile("ttft", 0.5),
                      tokens_per_s=sum(len(o["tokens"]) for o in res.outcomes.values()) / traced_wall,
                      spans=len(spans), harvested_samples=len(table))
        prefills = int(sched.telemetry.counter("serve_prefills_total"))
        steps = int(sched.telemetry.counter("serve_decode_steps_total"))
        streams = {r: o["tokens"] for r, o in res.outcomes.items()}
    finally:
        del os.environ["VESCALE_SERVE_OPS_PORT"]
        tel.shutdown()
        nd.api.deinit_ndtimers()
        calibrate.reset_active()
    untraced, untraced_streams = serve_run(dev, eng, arrivals, kernels_mod)
    checks = {
        "three_subsystems_on": three_on,
        "streams_bitwise_the_serve_phase": streams == serve_streams == untraced_streams,
        "request_chains_verified": problems == [],
        "router_alerts_live": router.get("alerts", {}).get("active") is True,
        "flash_launches": launches["flash_fwd"] == L * prefills,
        "paged_launches": launches["paged_decode"] == L * steps and steps > 0,
        "untraced_checks": all(untraced["checks"].values()),
    }
    out = dict(model="LLAMA3_8B", requests=len(arrivals), traced=traced,
               untraced={k: untraced[k] for k in ("serve_s", "decode_step_p50_ms",
                                                   "decode_step_p99_ms", "ttft_p50_s",
                                                   "tokens_per_s")},
               decode_p50_traced_over_untraced=traced["decode_step_p50_ms"]
               / untraced["decode_step_p50_ms"],
               calibrated_step_estimate_ms=dict(
                   analytic=None if est_analytic is None else 1e3 * est_analytic,
                   audited=None if est_audited is None else 1e3 * est_audited),
               matmul_gflops_fp32_256=table.meta["matmul_gflops"], router_alerts=router.get("alerts"),
               alerts=digest, launches={k: launches[k] + untraced["launches"][k] for k in launches},
               chain_problems=problems[:5], checks=checks)
    check(all(checks.values()), f"telemetry serve checks failed: {out}")
    return out


# ---------------------------------------------------------------- pipeline
PP_M = 4            # microbatches of every pipelined step
PP_GRAD_ULPS = 64.0  # non-bitwise grads of the eager engine: fp32 sums in other orders, at scale
PP_LOSS_ULPS = 64.0  # the compiled pipeline's loss: one mean over 4 rows vs 4 row means
PP_BLOCK_ULPS = 64.0  # the compiled pipeline's stacked grads: fp32 sums of per-row bf16 products
# the replicated embedding's and head's grads: bf16 products over the 4 rows
# at once where the golden rounds each row's to bf16 and sums them in fp32
PP_REP_BF16_STEPS = 4.0


class _HoldGrads:
    """The optimizer ``make_train_step`` is given to leave each parameter's
    accumulated gradient in place (its step does nothing)."""

    def __init__(self, params):
        self.params = list(params)

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None

    def step(self):
        pass


def pp_golden(model, batch, M, loss_fn):
    """The unpipelined model over ``batch`` in ``M`` microbatches through
    ``make_train_step(grad_accum_steps=M)``: the loss (l_sum / M) and every
    parameter's gradient (fp32 sums in microbatch order, / M)."""
    from vescale_tpu_torch.train import make_train_step

    hold = _HoldGrads(model.parameters())
    loss = make_train_step(model, hold, lambda y, b: loss_fn(y, b["target"]),
                           grad_accum_steps=M)(batch)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    hold.zero_grad()
    return loss, grads


def pp_unit_grads(grads_pg, n_layer: int) -> dict:
    """The engine's per-group grads of ``gpt_pipeline_units`` by the GPT's
    parameter names (the tied wte once: both groups hold the synced sum)."""
    from vescale_tpu_torch.pipe.pipe_stage import flatten_tree

    out = {}
    for gd in grads_pg:
        for unit, tree in gd.items():
            for name, g in flatten_tree(tree).items():
                out[name if unit in ("wte", "wpe", "ln_f", "head") else f"{unit}.{name}"] = g
    return out


def pp_compare(got: dict, want: dict) -> dict:
    """Leaves bitwise, and the largest fp32 ulps at scale of the rest."""
    bitwise, worst, worst_leaf = [], 0.0, None
    for k, w in want.items():
        if bits_equal(got[k], w):
            bitwise.append(k)
            continue
        u = ulps_dev(got[k], w)
        if u > worst:
            worst, worst_leaf = u, k
    return dict(bitwise=len(bitwise), leaves=len(want), not_bitwise=sorted(set(want) - set(bitwise)),
                max_ulps=worst, max_ulps_leaf=worst_leaf)


def pp_expected_launches(pm, M: int, zb: bool) -> dict:
    """The kernel launches one ``forward_backward`` implies: a flash forward
    per block and microbatch; its backward once, twice under zero bubble
    for every group but the first (the weight-grad walk re-runs the
    group's cotangents); the loss's kernels on the last group likewise."""
    blocks = [sum(1 for u in g if u.name.startswith("h_")) for g in pm.groups]
    bwd = sum(b * (2 if zb and g > 0 else 1) for g, b in enumerate(blocks))
    return {"flash_fwd": M * sum(blocks), "flash_bwd_dq": M * bwd, "flash_bwd_dkv": M * bwd,
            "fused_xent_fwd": M, "fused_xent_bwd": M * (2 if zb else 1), "fused_adamw": 0,
            "paged_decode": 0}


def pp_engine_run(pm, plan, params_pg, batch, loss_fn, kernels_mod, census=False):
    """One warm-up ``forward_backward`` of ``plan`` on ``pm``, then one
    timed: loss, per-group grads, launches, step ms, peak bytes above the
    bytes held at its start, and (``census``) the matmuls of the FORWARDs
    and of the BACKWARD_DGRADs."""
    import contextlib

    from vescale_tpu_torch.pipe import PipeEngine
    from vescale_tpu_torch.pipe.graph_split import OpRecorder

    eng = PipeEngine(pm, plan, loss_fn)
    eng.forward_backward(params_pg, batch, num_microbatches=PP_M)
    # the allocator keeps the warm-up's blocks: the timed run is a steady
    # step, as the rung's are, not one that pays cudaMalloc for every buffer
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels_mod.reset_launches()
    cens = {"F": OpRecorder(), "Bd": OpRecorder()}
    if census:
        eng.instruction_context = lambda ins: cens.get(ins.kind.value, contextlib.nullcontext())
    t0 = time.perf_counter()
    loss, grads = eng.forward_backward(params_pg, batch, num_microbatches=PP_M)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    out = dict(loss=loss, grads=grads, launches=dict(kernels_mod.LAUNCHES), step_ms=ms,
               peak_above_held_bytes=torch.cuda.max_memory_allocated() - held)
    if census:
        out["census"] = {k: sum(1 for s in c.matmul_shapes() if len(s) == 2)
                         for k, c in cens.items()}
    return out


def pp_bubble_fraction(pm, plan, params_pg, batch, loss_fn) -> float:
    """``telemetry.trace.bubble_fraction`` over the ndtimeline spans of one
    ``forward_backward`` (host-dispatch spans, one per instruction)."""
    from vescale_tpu_torch import ndtimeline
    from vescale_tpu_torch.ndtimeline.handlers import ChromeTraceHandler
    from vescale_tpu_torch.pipe import PipeEngine
    from vescale_tpu_torch.telemetry.trace import bubble_fraction, spans_from_perfetto

    tmp = tempfile.mkdtemp(prefix="vtt_pp_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        handler = ChromeTraceHandler(path)
        ndtimeline.init_ndtimers(handlers=[handler])
        try:
            PipeEngine(pm, plan, loss_fn).forward_backward(params_pg, batch,
                                                           num_microbatches=PP_M)
            torch.cuda.synchronize()
            ndtimeline.flush()
            handler.write()
        finally:
            ndtimeline.api.deinit_ndtimers()
        spans = spans_from_perfetto(path)
        n = sum(1 for s in spans if s.tags and "stage" in s.tags)
        return bubble_fraction(spans), n
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def pp_adamw_masters(model, grads: dict):
    """One K8 step (``AdamWLowmem(bench.LR)``, bf16 moments) from copies of
    ``model``'s masters with ``grads``: the new masters by name."""
    from vescale_tpu_torch.bench import LR
    from vescale_tpu_torch.parallel import AdamWLowmem

    leaves = {n: torch.nn.Parameter(p.detach().clone()) for n, p in model.named_parameters()}
    for n, p in leaves.items():
        p.grad = grads[n]
    AdamWLowmem(list(leaves.values()), LR, state_dtype=torch.bfloat16).step()
    return {n: p.detach() for n, p in leaves.items()}


def run_pp_gpt2(dev, kernels_mod):
    """(a) and (b): GPT-2 124M at the gpt2 rung's width and batch (B=12,
    T=1024 from its ``TokenDataLoader``) as M=4 microbatches of 3 through
    ``PipeEngine`` over ``gpt_pipeline_units`` (16 units): GPipe, 1F1B and
    zero bubble at S=4, interleaved at S=2, V=2, and the cost-driven zero
    bubble from ``profile_costs`` measured here; then ``split_graph`` of the
    same model into 4 groups under 1F1B.  Golden: the rung's unpipelined
    model over the same microbatches (``make_train_step``'s accumulation).
    Each loss bitwise the golden's; grads bitwise where the sums run in the
    same order (every leaf but the tied wte under 1F1B, zero bubble and
    interleaved), else within ``PP_GRAD_ULPS``; launches equal to the
    schedule's count; no weight-grad matmul in any dgrad; one K8 step from
    1F1B's and zero bubble's grads gives the golden's masters by the same
    rule."""
    from vescale_tpu_torch.bench import prepare
    from vescale_tpu_torch.loss import vocab_parallel_cross_entropy
    from vescale_tpu_torch.models import gpt_pipeline_units, gpt_unit_params, module_tree
    from vescale_tpu_torch.pipe import construct_pipeline_stage, split_graph
    from vescale_tpu_torch.pipe.pipe_stage import flatten_tree
    from vescale_tpu_torch.plan import PipelineParallelPlan, PipelineScheduleType as ST

    run = prepare("gpt2", device=dev)
    try:
        model, cfg = run.model, run.config
        batch = run.next_batch()
        L = cfg.n_layer

        def loss_fn(y, t):
            return vocab_parallel_cross_entropy(y, t)

        kernels_mod.reset_launches()
        gloss, ggrads = pp_golden(model, batch, PP_M, loss_fn)
        golden_launches = dict(kernels_mod.LAUNCHES)
        del ggrads
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # the same golden again, on the warm allocator: its time
        gloss, ggrads = pp_golden(model, batch, PP_M, loss_fn)
        torch.cuda.synchronize()
        golden_ms = 1e3 * (time.perf_counter() - t0)
        tree = module_tree(model)
        unit_params = gpt_unit_params(tree, L)
        units = gpt_pipeline_units(cfg)
        legs, out = {}, {}
        schedules = [("gpipe", ST.GPIPE, 4, 1), ("1f1b", ST.SIMPLE_1F1B, 4, 1),
                     ("zero_bubble", ST.ZERO_BUBBLE, 4, 1),
                     ("interleaved", ST.INTERLEAVED_1F1B, 2, 2)]
        kept = {}
        for name, st, S, V in schedules:
            plan = PipelineParallelPlan(num_stages=S, virtual_chunks=V, schedule_type=st)
            pm = construct_pipeline_stage(units, plan)
            res = pp_engine_run(pm, plan, pm.partition_params(unit_params), batch, loss_fn,
                                kernels_mod, census=(st == ST.ZERO_BUBBLE))
            grads = pp_unit_grads(res.pop("grads"), L)
            loss = res.pop("loss")
            want = pp_expected_launches(pm, PP_M, st == ST.ZERO_BUBBLE)
            leg = dict(stages=S, virtual_chunks=V, groups=[[u.name for u in g] for g in pm.groups],
                       loss=float(loss), loss_bitwise=bits_equal(loss, gloss),
                       grads=pp_compare(grads, ggrads), launches_expected=want, **res)
            leg["launches_ok"] = res["launches"] == want
            if "census" in res:
                # one input-grad product per forward product of every group
                # but the first (whose dgrad computes nothing)
                f_first = 4 * sum(1 for u in pm.groups[0] if u.name.startswith("h_"))
                leg["dgrad_matmuls_expected"] = res["census"]["F"] - PP_M * f_first
                leg["wgrad_matmuls_in_dgrad"] = res["census"]["Bd"] - leg["dgrad_matmuls_expected"]
            if name in ("1f1b", "zero_bubble"):
                kept[name] = grads
            legs[name] = leg
            free_memory()
        # the cost-driven zero bubble, priced by profile_costs on the card
        plan = PipelineParallelPlan(num_stages=4, schedule_type=ST.ZERO_BUBBLE)
        pm = construct_pipeline_stage(units, plan)
        from vescale_tpu_torch.pipe import PipeEngine

        costs = PipeEngine(pm, plan, loss_fn).profile_costs(
            pm.partition_params(unit_params), batch, num_microbatches=PP_M, warmup=1)
        plan_c = PipelineParallelPlan(num_stages=4, schedule_type=ST.ZERO_BUBBLE,
                                      schedule_costs=costs)
        res = pp_engine_run(pm, plan_c, pm.partition_params(unit_params), batch, loss_fn,
                            kernels_mod)
        grads = pp_unit_grads(res.pop("grads"), L)
        loss = res.pop("loss")
        want = pp_expected_launches(pm, PP_M, True)
        legs["zero_bubble_cost"] = dict(
            stages=4, costs_ms={k: [1e3 * v for v in getattr(costs, k)] for k in ("f", "bd", "w")},
            loss=float(loss), loss_bitwise=bits_equal(loss, gloss),
            grads=pp_compare(grads, ggrads), launches_expected=want,
            launches_ok=res["launches"] == want, **res)
        free_memory()
        plan = PipelineParallelPlan(num_stages=4)
        pm = construct_pipeline_stage(units, plan)
        frac, n_spans = pp_bubble_fraction(pm, plan, pm.partition_params(unit_params), batch,
                                           loss_fn)
        out["bubble_fraction_1f1b"] = frac
        out["pipe_spans"] = n_spans
        # where a 1F1B step's time goes: the card's busy time under the profiler
        eng = PipeEngine(pm, plan, loss_fn)
        prof = device_time_by_kind(lambda: eng.forward_backward(
            pm.partition_params(unit_params), batch, num_microbatches=PP_M))
        prof["device_idle_share"] = max(0.0, 1.0 - prof["device_busy_ms"] / legs["1f1b"]["step_ms"])
        out["profile_1f1b"] = prof
        del eng
        free_memory()
        # one K8 step from the pipelined grads against the golden's
        golden_masters = pp_adamw_masters(model, ggrads)
        for name, grads in kept.items():
            masters = pp_adamw_masters(model, grads)
            out[f"k8_masters_{name}"] = pp_compare(masters, golden_masters)
            del masters
        del golden_masters, kept
        free_memory()

        # (b) split_graph of the same model into 4 groups, 1F1B
        micro = {k: v[: v.shape[0] // PP_M] for k, v in batch.items()}

        def fn(p, x):
            return torch.func.functional_call(model, flatten_tree(p), (x,))

        plan = PipelineParallelPlan(num_stages=4)
        t0 = time.perf_counter()
        gm = split_graph(fn, tree, micro["input"], plan)
        trace_s = time.perf_counter() - t0
        with torch.no_grad():
            full_bitwise = bits_equal(gm.full_forward(tree, micro["input"]), model(micro["input"]))
        res = pp_engine_run(gm, plan, gm.partition_params(tree), batch, loss_fn, kernels_mod)
        res.pop("grads")
        loss = res.pop("loss")
        kernel_nodes = sum(1 for n in gm.graph_module.graph.nodes
                           if n.op == "call_function" and str(n.target).startswith("vtt."))
        legs["split_graph"] = dict(
            nodes=len(gm._eqns), kernel_nodes=kernel_nodes, trace_s=trace_s,
            group_flops=[gm.group_flops(g) for g in range(gm.num_groups)],
            full_forward_bitwise=full_bitwise, loss=float(loss),
            loss_bitwise=bits_equal(loss, gloss), golden_launches=golden_launches,
            flash_launches_equal=all(res["launches"][k] == golden_launches[k]
                                     for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
            **res)
        del gm
    finally:
        run.close()
    out.update(model="GPT-2 124M (bench rung gpt2)", batch=dict(B=12, T=1024, M=PP_M),
               golden_loss=float(gloss), golden_step_ms=golden_ms, legs=legs)
    del run, model, ggrads
    free_memory()
    checks = {f"{k}_loss_bitwise": v["loss_bitwise"] for k, v in legs.items()}
    checks.update({f"{k}_launches": v["launches_ok"] for k, v in legs.items() if "launches_ok" in v})
    for k in ("1f1b", "zero_bubble", "interleaved"):
        checks[f"{k}_grads_bitwise_but_wte"] = legs[k]["grads"]["not_bitwise"] in ([], ["wte.embedding"])
    checks.update({f"{k}_grads_bound": v["grads"]["max_ulps"] <= PP_GRAD_ULPS
                   for k, v in legs.items() if "grads" in v})
    checks["zb_no_wgrad_matmul_in_dgrad"] = legs["zero_bubble"]["wgrad_matmuls_in_dgrad"] == 0
    checks["bubble_fraction"] = out["bubble_fraction_1f1b"] is not None and out["bubble_fraction_1f1b"] > 0
    for name in ("1f1b", "zero_bubble"):
        m = out[f"k8_masters_{name}"]
        checks[f"k8_{name}"] = (m["not_bitwise"] in ([], ["wte.embedding"])
                                and m["max_ulps"] <= PP_GRAD_ULPS)
    checks["split_graph_full_forward_bitwise"] = legs["split_graph"]["full_forward_bitwise"]
    checks["split_graph_flash_launches"] = legs["split_graph"]["flash_launches_equal"]
    checks["split_graph_kernel_nodes"] = legs["split_graph"]["kernel_nodes"] == L
    out["checks"] = checks
    if not all(checks.values()):
        log("pipeline_gpt2_failed", **out)
    check(all(checks.values()), f"pipeline gpt2 checks failed: {checks}")
    return out


# the 1.3B rung through the compiled pipeline on a ("pp",) mesh of 2 ranks
PP_ROWS = 4  # B rows of T=4096, in PP_M microbatches of one row
# its depth there: 24 -> 4 layers at full width (2 a stage, one a chunk of
# the interleaved leg: no fewer; its golden run at the same depth), so the
# script with the nd phase stays inside its time (PERF.md §7; 24 until the
# nd phase came)
L_13B = 4


def pp_13b_config(scan: bool = True, layers=None):
    """The 1.3B rung's config (``layers`` deep in place of its 24)."""
    from vescale_tpu_torch.bench import RUNGS
    from vescale_tpu_torch.models import LlamaConfig

    fields, _, T, _, _ = RUNGS["1.3b"]
    if layers is not None:
        fields = dict(fields, num_hidden_layers=layers)
    return LlamaConfig(max_position_embeddings=T, scan_layers=scan, **fields), T


def pp_13b_batch(cfg, T, dev, rows=PP_ROWS):
    """The 1.3B rung's numpy-seeded rows (``bench._model_and_data``'s draw)."""
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (rows, T + 1))
    toks = torch.from_numpy(toks.astype(np.int64)).to(dev)
    return {"input": toks[:, :-1], "target": toks[:, 1:]}


def pp_13b_golden(dev, path: str) -> dict:
    """One card's unpipelined ``scan_layers`` 1.3B over the PP_ROWS rows in
    PP_M microbatches (``make_train_step``'s accumulation): its loss, and
    every gradient saved to ``path`` (``torch.save``) for the ranks."""
    from vescale_tpu_torch.models import Llama, cross_entropy_loss, init_params

    cfg, T = pp_13b_config(layers=L_13B)
    model = Llama(cfg, init_params(cfg, 0, device=dev, dtype=torch.float32), device=dev)
    batch = pp_13b_batch(cfg, T, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = pp_golden(model, batch, PP_M, cross_entropy_loss)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    del model
    free_memory()
    t0 = time.perf_counter()
    torch.save({k: v.cpu() for k, v in grads.items()}, path)
    save_s = time.perf_counter() - t0
    del grads
    free_memory()
    return dict(loss=float(loss), loss_hex=float(loss).hex(), step_ms=ms, peak_bytes=peak,
                grads_saved_s=save_s)


def pp_block_fn(cfg):
    """``block_fn(chunk, x)`` for the compiled pipeline: the chunk's layers
    (leaves with a leading layer axis, unbound once) in order, each a
    ``LlamaBlock`` on its slices."""
    from vescale_tpu_torch.models.llama import LlamaBlock
    from vescale_tpu_torch.pipe.pipe_stage import flatten_tree

    tmpl = LlamaBlock(cfg, torch.device("meta"))

    def block_fn(chunk, x):
        flat = flatten_tree(chunk)
        names = list(flat)
        slices = [t.unbind(0) for t in flat.values()]
        pos = torch.arange(x.shape[1], device=x.device)[None, :].expand(x.shape[0], x.shape[1])
        for layer in zip(*slices):
            x = torch.func.functional_call(tmpl, dict(zip(names, layer)), (x, pos))
        return x

    return block_fn


def pp_13b_job(mesh, legs: list, golden_path: str, golden_loss: float):
    """One rank of the 1.3B on the ("pp",) mesh, for each leg (name, V,
    zb) in turn in this one process: its chunks of the scanned block stack
    (the golden's seed-0 weights), the embedding and head replicated
    outside, PP_ROWS rows in PP_M microbatches through ``pipeline_blocks``
    (or ``pipeline_blocks_zb``) with V chunks a rank, then the rung's loss
    and backward.  Per leg: its loss, its stacked grads and the replicated
    ones against the golden's, its step ms, peak, ppermutes and gloo's
    share."""
    return {name: pp_13b_leg(mesh, V, zb, golden_path, golden_loss) for name, V, zb in legs}


def pp_13b_leg(mesh, V: int, zb: bool, golden_path: str, golden_loss: float):
    from vescale_tpu_torch import collectives as C
    from vescale_tpu_torch import kernels
    from vescale_tpu_torch.models import cross_entropy_loss, init_params
    from vescale_tpu_torch.models.llama import rmsnorm
    from vescale_tpu_torch.pipe import spmd
    from vescale_tpu_torch.pipe.pipe_stage import flatten_tree, unflatten_tree

    dev = mesh.device
    cfg, T = pp_13b_config(layers=L_13B)
    S = mesh.size("pp")
    r = mesh.get_coordinate()[0]
    L = cfg.num_hidden_layers
    n = L // (S * V)
    params = init_params(cfg, 0, device=dev, dtype=torch.float32)
    block = flatten_tree(params["layers"]["block"])
    groups = [{k: t[g * n:(g + 1) * n] for k, t in block.items()} for g in range(S * V)]
    local = {k: t.clone().requires_grad_() for k, t in
             flatten_tree(spmd.stage_chunks(spmd.stack_interleaved_params(groups, S), mesh)).items()}
    emb = params["embed_tokens"]["embedding"].requires_grad_()
    norm_w = params["norm"]["weight"].requires_grad_()
    head = params["lm_head"]["kernel"].requires_grad_()
    del params, block, groups
    free_memory()
    batch = pp_13b_batch(cfg, T, dev)
    block_fn = pp_block_fn(cfg)
    run = spmd.pipeline_blocks_zb if zb else spmd.pipeline_blocks
    times = []
    for it in range(2):  # a warm-up step, then the timed one (on the warm allocator)
        for t in (emb, norm_w, head, *local.values()):
            t.grad = None
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        C.reset_calls()
        C.TIMING = it == 1
        kernels.reset_launches()
        t0 = time.perf_counter()
        x = torch.nn.functional.embedding(batch["input"], emb.to(cfg.dtype))
        out = run(block_fn, unflatten_tree(local), x, mesh, num_microbatches=PP_M, virtual_chunks=V)
        # the rung's head: LlamaHead's RMSNorm and lm_head, as Llama runs them
        logits = rmsnorm(out, norm_w, cfg.rms_norm_eps).to(cfg.dtype) @ head.to(cfg.dtype)
        loss = cross_entropy_loss(logits, batch["target"])
        del logits, out, x
        loss.backward()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        C.TIMING = False
    peak = torch.cuda.max_memory_allocated()
    launches = dict(kernels.LAUNCHES)
    calls, nbytes, secs = dict(C.CALLS), dict(C.BYTES), dict(C.SECONDS)
    golden = torch.load(golden_path, mmap=True)
    worst, worst_leaf, bitwise = 0.0, None, 0
    for k, t in local.items():
        for v in range(V):
            g0 = (v * S + r) * n
            want = golden["layers.block." + k][g0:g0 + n].to(dev)
            if bits_equal(t.grad[v], want):
                bitwise += 1
            u = ulps_dev(t.grad[v], want)
            if u > worst:
                worst, worst_leaf = u, k
            del want
    rep = {}
    for name, t in (("embed_tokens.embedding", emb), ("norm.weight", norm_w),
                    ("lm_head.kernel", head)):
        want = golden[name].to(dev)
        rep[name] = dict(bitwise=bits_equal(t.grad, want), ulps=ulps_dev(t.grad, want),
                         fingerprint=fingerprint([t.grad])[0])
    n_leaves = len(local)
    del golden, local, emb, norm_w, head, want
    free_memory()
    lv = float(loss.detach())
    gloo_s = sum(secs.values())
    return dict(rank=r, loss=lv, loss_hex=lv.hex(), loss_ulps=ulps_dev(
                    torch.tensor(lv), torch.tensor(golden_loss)),
                step_ms=times[-1], warmup_ms=times[0], peak_above_held_bytes=peak - held,
                held_bytes=held, launches=launches, calls=calls, bytes=nbytes,
                collective_seconds=secs, gloo_share=gloo_s / (times[-1] / 1e3),
                block_grads=dict(chunks=V, layers_per_chunk=n, max_ulps=worst,
                                 max_ulps_leaf=worst_leaf, bitwise_chunks=bitwise,
                                 chunks_total=V * n_leaves),
                replicated_grads=rep)


def run_pp_13b(dev, card):
    """(c): the 1.3B rung (``L_13B`` of its 24 layers, width 2048,
    ``scan_layers``) through
    ``pipeline_blocks`` with V=1 and V=2 and ``pipeline_blocks_zb`` with
    V=2, as two gloo ranks of the card on a ("pp",) mesh of 2, PP_ROWS
    rows of T=4096 in PP_M microbatches, the embedding and head
    replicated.  Golden: one card's unpipelined scanned model over the same
    rows, run here first and then freed.  Losses within PP_LOSS_ULPS, the
    stacked grads within PP_BLOCK_ULPS, the replicated grads equal on both
    ranks."""
    tmp = tempfile.mkdtemp(prefix="vtt_pp_")
    try:
        path = os.path.join(tmp, "golden.pt")
        golden = pp_13b_golden(dev, path)
        t = time.perf_counter()
        # one pair of ranks runs the three legs in turn
        ranks = tp_spawn("pp", dict(legs=[("blocks_v1", 1, False), ("blocks_v2", 2, False),
                                          ("zb_v2", 2, True)],
                                    golden_path=path, golden_loss=golden["loss"]),
                         timeout_s=900, names=("pp",))
        wall = time.perf_counter() - t
        legs = {name: dict(ranks=[r[name] for r in ranks]) for name in ranks[0]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    checks = {}
    for name, leg in legs.items():
        rs = leg["ranks"]
        checks[f"{name}_loss"] = all(r["loss_ulps"] <= PP_LOSS_ULPS for r in rs)
        checks[f"{name}_losses_equal"] = len({r["loss_hex"] for r in rs}) == 1
        checks[f"{name}_block_grads"] = all(r["block_grads"]["max_ulps"] <= PP_BLOCK_ULPS for r in rs)
        for k in ("embed_tokens.embedding", "lm_head.kernel", "norm.weight"):
            checks[f"{name}_{k}_equal_on_ranks"] = len(
                {r["replicated_grads"][k]["fingerprint"] for r in rs}) == 1
            checks[f"{name}_{k}_bound"] = all(
                r["replicated_grads"][k]["ulps"] <= PP_REP_BF16_STEPS * BF16_ULP for r in rs)
        # a flash forward per layer, microbatch and pass (zero bubble: the
        # forward, the dgrad's and the wgrad's recomputations), its
        # backward once (twice under zero bubble); nothing else: the head's
        # loss is the Llama's plain fp32 logsumexp (no K9/K10), and the leg
        # takes no optimizer step (no K8)
        per = PP_M * L_13B // 2
        bwd = per * (2 if "zb" in name else 1)
        want = {k: 0 for k in rs[0]["launches"]}
        want.update(flash_fwd=per * (3 if "zb" in name else 1), flash_bwd_dq=bwd,
                    flash_bwd_dkv=bwd)
        leg["launches_expected"] = want
        checks[f"{name}_launches"] = all(r["launches"] == want for r in rs)
    out = dict(model="llama 1.3B (bench rung 1.3b, scan_layers)", card=card, rows=PP_ROWS,
               microbatches=PP_M, golden=golden, ranks_wall_s=wall, legs=legs, checks=checks,
               bounds=dict(loss_ulps=PP_LOSS_ULPS, block_ulps=PP_BLOCK_ULPS,
                           replicated_bf16_steps=PP_REP_BF16_STEPS))
    if not all(checks.values()):
        log("pipeline_13b_failed", **out)
    check(all(checks.values()), f"pipeline 1.3b checks failed: {checks}")
    return out


def pp_13b_steps(dev, cfg, T, steps: int, keep: bool):
    """``steps`` steps of the 1.3B rung's step (``AdamWLowmem(bench.LR)``,
    bf16 moments, the rung's one row) on ``cfg``: losses, peak bytes, and
    (``keep``) the masters in the unscanned layout; then one more step by
    hand, whose phases' bytes ``pp_13b_phase_bytes`` reads."""
    from vescale_tpu_torch.bench import LR
    from vescale_tpu_torch.models import Llama, cross_entropy_loss, init_params, module_tree
    from vescale_tpu_torch.models import unscan_tree
    from vescale_tpu_torch.parallel import AdamWLowmem
    from vescale_tpu_torch.pipe.pipe_stage import flatten_tree
    from vescale_tpu_torch.train import make_train_step

    model = Llama(cfg, init_params(cfg, 0, device=dev, dtype=torch.float32), device=dev)
    opt = AdamWLowmem(model.parameters(), LR, state_dtype=torch.bfloat16)

    def loss_fn(lg, b):
        return cross_entropy_loss(lg, b["target"])

    step = make_train_step(model, opt, loss_fn)
    batch = pp_13b_batch(cfg, T, dev, rows=1)
    free_memory()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses = [step(batch) for _ in range(steps)]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    masters = None
    if keep:
        tree = module_tree(model)
        flat = flatten_tree(unscan_tree(tree) if cfg.scan_layers else tree)
        masters = {k: v.clone() for k, v in flat.items()}
    phases = pp_13b_phase_bytes(model, opt, batch, loss_fn)
    del model, step, opt
    free_memory()
    return losses, peak, masters, phases


def pp_13b_phase_bytes(model, opt, batch, loss_fn) -> dict:
    """One step by hand (``make_train_step``'s: zero the grads, the loss,
    its backward, the optimizer's step), in bytes above what the masters
    and the moments hold at its start: the forward's stash (allocated once
    the loss is out: what the backward will read, which a remat policy
    sets), the forward and backward's peak, the grads, and the optimizer
    step's own peak."""
    opt.zero_grad(set_to_none=True)
    free_memory()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = loss_fn(model(batch["input"]), batch)
    torch.cuda.synchronize()
    stash = torch.cuda.memory_allocated() - held
    loss.backward()
    del loss
    torch.cuda.synchronize()
    fwd_bwd_peak = torch.cuda.max_memory_allocated() - held
    grads = torch.cuda.memory_allocated() - held
    torch.cuda.reset_peak_memory_stats()
    opt.step()
    torch.cuda.synchronize()
    opt_peak = torch.cuda.max_memory_allocated() - held
    opt.zero_grad(set_to_none=True)
    return dict(held_bytes=held, stash_bytes=stash, fwd_bwd_peak_above_held_bytes=fwd_bwd_peak,
                grads_bytes=grads, optimizer_peak_above_held_bytes=opt_peak)


def run_pp_scan_remat(dev, kernels_mod, train=None):
    """(d): the 1.3B rung on one card: two steps unscanned and two with
    ``scan_layers`` (the same seed-0 weights, stacked): losses and masters
    bitwise; then one step each with ``remat=True`` and each mapped
    ``remat_policy``: losses bitwise, peaks printed.  Each run's extra
    step by hand gives the forward's stash and the phases' peaks
    (``pp_13b_phase_bytes``): the stash is what a policy moves.  With the
    train phase's run, its first two losses too."""
    cfg, T = pp_13b_config(scan=False)
    kernels_mod.reset_launches()
    plain, plain_peak, plain_masters, plain_phases = pp_13b_steps(dev, cfg, T, 2, keep=True)
    scan, scan_peak, scan_masters, scan_phases = pp_13b_steps(
        dev, dataclasses.replace(cfg, scan_layers=True), T, 2, keep=True)
    masters_bitwise = all(bits_equal(scan_masters[k], v) for k, v in plain_masters.items())
    del plain_masters, scan_masters
    free_memory()
    remat = {}
    for policy in ("dots_saveable", "dots_with_no_batch_dims_saveable", "nothing_saveable"):
        losses, peak, _, phases = pp_13b_steps(dev, dataclasses.replace(
            cfg, scan_layers=True, remat=True, remat_policy=policy), T, 1, keep=False)
        remat[policy] = dict(loss_hex=float(losses[0]).hex(), peak_above_held_bytes=peak,
                             loss_bitwise=bits_equal(losses[0], plain[0]), phases=phases)
    launches = dict(kernels_mod.LAUNCHES)
    out = dict(plain_losses=[float(x) for x in plain], scan_losses=[float(x) for x in scan],
               plain_peak_above_held_bytes=plain_peak, scan_peak_above_held_bytes=scan_peak,
               plain_phases=plain_phases, scan_phases=scan_phases,
               masters_bitwise=masters_bitwise, remat=remat, launches=launches)
    checks = {"scan_losses_bitwise": all(bits_equal(a, b) for a, b in zip(scan, plain)),
              "scan_masters_bitwise": masters_bitwise,
              **{f"remat_{k}_loss_bitwise": v["loss_bitwise"] for k, v in remat.items()}}
    if train is not None:
        checks["plain_losses_are_the_train_phases"] = [float(x) for x in plain] == train["losses"][:2]
    out["checks"] = checks
    if not all(checks.values()):
        log("pipeline_scan_remat_failed", **out)
    check(all(checks.values()), f"pipeline scan/remat checks failed: {checks}")
    return out


def run_pipeline(dev, card, kernels_mod, train=None) -> dict:
    """The ``pipeline`` phase: (a)+(b) GPT-2 through the eager engine and
    a split graph, (d) ``scan_layers`` and ``remat_policy`` on the 1.3B,
    (c) the 1.3B through the compiled pipeline on two ranks; each leg
    logs its own line as it ends.  Its launches: every kernel launch of
    the phase's runs, in this process and in the ranks."""
    launches = {k: 0 for k in kernels_mod.LAUNCHES}

    def add(d):
        for k, v in d.items():
            launches[k] += int(v)

    t = time.perf_counter()
    gpt2 = run_pp_gpt2(dev, kernels_mod)
    gpt2["seconds"] = time.perf_counter() - t
    log("pipeline_gpt2", **gpt2)
    for leg in gpt2["legs"].values():
        add(leg["launches"])
    t = time.perf_counter()
    scan = run_pp_scan_remat(dev, kernels_mod, train)
    scan["seconds"] = time.perf_counter() - t
    log("pipeline_scan_remat", **scan)
    add(scan["launches"])
    t = time.perf_counter()
    llama = run_pp_13b(dev, card)
    llama["seconds"] = time.perf_counter() - t
    log("pipeline_13b", **llama)
    for leg in llama["legs"].values():
        for r in leg["ranks"]:
            add(r["launches"])
    return dict(card=card, leg_seconds={"gpt2": gpt2["seconds"], "scan_remat": scan["seconds"],
                                    "llama_13b": llama["seconds"]},
                checks={"gpt2": gpt2["checks"], "scan_remat": scan["checks"],
                        "llama_13b": llama["checks"]}, launches=launches)


TP_JOBS["pp"] = pp_13b_job


# --------------------------------------------------------------- MoE (A16)
# the bench's moe_cpu config with head_dim 64 (the smallest the flash
# kernels take): width 128 over 2 heads and 1 kv head (its GQA group of 2),
# FFN 256 (its FFN / width of 2), 2 layers, 4 experts, top-2, fp32
MOE_SMALL = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                 num_attention_heads=2, num_key_value_heads=1, num_local_experts=4,
                 max_position_embeddings=64)
MOE_SMALL_BATCH = (2, 64)
MOE_FULL_LAYERS = 2  # Mixtral-8x7B's depth cut: 32 -> 2 layers (3.16B parameters)
MOE_EP_STEPS = 3
MOE_LOOP_STEPS = 6
MOE_REFRESH_AFTER = 3  # the load-aware refresh follows this step
# the refresh runs' depth: the moe rung's 8 -> 2 layers (the two runs are
# held to each other), so the script with the examples phase stays inside
# its time (PERF.md §7; 8 until the nd phase came, 4 until the examples)
MOE_REFRESH_LAYERS = 2
# tests/test_moe.py:197's skew (4.0 added to router column 0): a token whose
# features sum positive picks expert 0, else not; with -4.0 on column 1 and
# +4.0 on column 2 beside it, experts 0-2 take ~3/4 of the routed slots, so
# the load-aware allocation is uneven and differs from the even start
MOE_ROUTER_SKEW = {0: 4.0, 1: -4.0, 2: 4.0}
# the EP ranks' grads against one card's, each leaf's ||g - g1|| / ||g1||.
# The combine's partial sums meet in a bf16 all-reduce, so each layer's
# output differs from one card's by a bf16 rounding; through 8 layers
# that moves the router's input enough to flip near-tied top-2 choices
# of a few tokens (counted: ``routing_flips``), whose grads then go to
# other experts.  An elementwise bound would measure those tokens only.
# Each flipped token's grad goes elsewhere, so a leaf's relative error
# grows as sqrt(2 * F / N) (F of N tokens flipped): the bound is the bf16
# noise MOE_GRAD_REL_L2 plus twice that at the step's most flipped layer.
# A lost contribution (another rank's experts missing from the router's
# grad) would show on every rank as unequal replicated grads instead.
MOE_GRAD_REL_L2 = 0.05
EXPERT_LEAF_NAMES = ("w_in", "b_in", "w_out", "b_out", "w_gate")


def moe_routing_hooks(model):
    """Forward hooks recording each MoE layer's (N, K) expert choice, as
    ``moe.layer.route`` makes it from the layer's input and router; returns
    (records by layer, the hook handles)."""
    from vescale_tpu_torch.moe.layer import route

    records, handles = [], []
    for block in model.blocks():
        rec = []

        def hook(mod, args, out, rec=rec):
            with torch.no_grad():
                x2 = args[0].reshape(-1, args[0].shape[-1])
                rec.append(route(x2, mod.router, mod.config.top_k)[2].cpu())

        records.append(rec)
        handles.append(block.block_sparse_moe.register_forward_hook(hook))
    return records, handles


def run_moe_small(dev, kernels_mod):
    """(a): the moe_cpu config (``MOE_SMALL``) trained 3 steps on the card
    (kernels, cuBLAS) and on the CPU (plain versions) from the same
    ``init_params(device="cpu")`` weights and batch, ``AdamWLowmem(3e-4)``
    over ``param_dtype_groups`` (fp32: one group).  Routing equal on every
    token of the first step; losses as ``run_train_small``'s bounds: 1e-5
    relative at step 1, 1e-3 absolute after."""
    from vescale_tpu_torch import bench
    from vescale_tpu_torch.models import Mixtral, MixtralConfig, cross_entropy_loss, init_params
    from vescale_tpu_torch.parallel import AdamWLowmem, param_dtype_groups
    from vescale_tpu_torch.train import make_train_step

    check(torch.backends.cuda.matmul.allow_tf32 is False, "fp32 matmuls must not run in TF32")
    cfg = MixtralConfig(**MOE_SMALL, dtype=torch.float32)
    params = init_params(cfg, seed=1, device="cpu")
    B, T = MOE_SMALL_BATCH
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T + 1)))
    losses, routing = {}, {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = Mixtral(cfg, params, device=device)
        opt = AdamWLowmem(param_dtype_groups(model.parameters()), bench.LR)
        step = make_train_step(model, opt, lambda lg, b: cross_entropy_loss(lg, b["target"]))
        t = toks.to(device)
        batch = {"input": t[:, :-1], "target": t[:, 1:]}
        records, handles = moe_routing_hooks(model)
        kernels_mod.reset_launches()
        losses[where] = [float(step(batch)) for _ in range(3)]
        if where == "card":
            launches = dict(kernels_mod.LAUNCHES)
        for h in handles:
            h.remove()
        routing[where] = [rec[0] for rec in records]  # the first step's forward
    diffs = [abs(a - b) for a, b in zip(losses["card"], losses["cpu"])]
    bounds = [1e-5 * abs(losses["cpu"][0]), 1e-3, 1e-3]
    L = cfg.num_hidden_layers
    want = {**{k: 0 for k in kernels_mod.LAUNCHES}, "flash_fwd": 3 * L, "flash_bwd_dq": 3 * L,
            "flash_bwd_dkv": 3 * L, "fused_adamw": 3}
    same = [bool(torch.equal(a, b)) for a, b in zip(routing["card"], routing["cpu"])]
    checks = {"routing_equal_first_step": all(same),
              "losses_within_bounds": all(d <= b for d, b in zip(diffs, bounds)),
              "losses_finite": bool(np.isfinite(losses["card"]).all()),
              "launches": launches == want}
    out = dict(config=dict(MOE_SMALL, B=B, T=T), losses=losses, abs_diffs=diffs, bounds=bounds,
               tokens_routed=[int(r.numel()) for r in routing["card"]], launches=launches,
               checks=checks)
    check(all(checks.values()), f"moe_small checks failed: {out}")
    return out


def moe_matmul_split(fn, N: int, EC: int, E: int) -> dict:
    """One run of ``fn`` under ``torch.profiler`` with shapes: the device ms,
    calls and FLOPs of the aten matrix products by role: ``dispatch_combine``
    (an operand holds both the N tokens and the E*C capacity slots: the
    dense one-hot products and their backward), ``masks`` (batched over
    the N tokens: the (N, E, C) masks built from the (N, K) choices),
    ``experts`` (batched over the E experts) and ``dense`` (every other
    product: attention projections, the head, the router)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    out = {k: dict(device_ms=0.0, calls=0, gflop=0.0)
           for k in ("dispatch_combine", "masks", "experts", "dense")}
    for evt in prof.key_averages(group_by_input_shape=True):
        if evt.key not in ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm"):
            continue
        shapes = [list(s) for s in evt.input_shapes if s and len(s) >= 2]
        if len(shapes) < 2:
            continue
        a, b = shapes[-2], shapes[-1]
        dims = {d for s in (a, b) for d in s}
        flops = 2.0 * np.prod(a[:-1]) * a[-1] * b[-1]
        if N in dims and EC in dims:
            kind = "dispatch_combine"
        elif evt.key.endswith("bmm") and a[0] == N and len(a) == 3:
            kind = "masks"
        elif evt.key.endswith("bmm") and a[0] == E and len(a) == 3:
            kind = "experts"
        else:
            kind = "dense"
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "cuda_time_total", 0.0)
        out[kind]["device_ms"] += dev_us / 1e3
        out[kind]["calls"] += evt.count
        out[kind]["gflop"] += flops * evt.count / 1e9
    return out


def run_moe_rung(dev, kernels_mod, golden_path: str):
    """(b): the bench's moe rung (``bench.prepare("moe")``) at the reference
    rung's TPU config: 2 warm-up and 5 timed steps; finite, falling loss;
    per step 8 K1, 8 dq, 8 dkv and 2 K8 (the fp32 and the bf16 groups);
    step ms, tokens/s, MFU (active parameters), peak; each layer's
    ``expert_tokens``; one profiled step by kernel kind and one by matmul
    role.  The first step's grads go to ``golden_path`` for the EP leg."""
    from vescale_tpu_torch.bench import measure, prepare

    t0 = time.perf_counter()
    run = prepare("moe", device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg, L = run.config, run.config.num_hidden_layers
    first = {}
    real = run.optimizer.step

    def spy():
        if not first:
            first.update({n: p.grad.detach().cpu() for n, p in run.model.named_parameters()})
        real()

    run.optimizer.step = spy
    records, handles = moe_routing_hooks(run.model)
    kernels_mod.reset_launches()
    res = measure(run)
    run.optimizer.step = real
    for h in handles:
        h.remove()
    launches = dict(kernels_mod.LAUNCHES)
    torch.save({"grads": first, "routing": [rec[0] for rec in records]}, golden_path)
    del first, records
    timed = res["losses"][res["warmup_steps"]:]
    want = {**{k: 0 for k in kernels_mod.LAUNCHES}, "flash_fwd": L, "flash_bwd_dq": L,
            "flash_bwd_dkv": L, "fused_adamw": 2}
    groups = [(str(g["state_dtype"]), len(g["params"])) for g in run.optimizer.param_groups]
    checks = {
        "losses_finite": bool(np.isfinite(res["losses"]).all()),
        "loss_falls": timed[-1] < timed[0],
        "launches_per_step": all(step == want for step in res["launches_per_step"]),
        "two_groups": groups == [("torch.float32", 7 * L + 3), ("torch.bfloat16", 5 * L)],
    }
    prof = device_time_by_kind(lambda: run.step(run.next_batch()))
    busy = prof["device_busy_ms"]
    prof["device_idle_share"] = max(0.0, 1.0 - busy / res["step_ms_median"])
    B, T = run.next_batch()["input"].shape
    N, E = B * T, cfg.num_local_experts
    from vescale_tpu_torch.moe import TokenDispatcher

    C = TokenDispatcher.capacity_for(N, E, cfg.num_experts_per_tok, cfg.capacity_factor)
    prof["matmul_by_role"] = moe_matmul_split(lambda: run.step(run.next_batch()), N, E * C, E)
    out = dict(model="Mixtral-style MoE (bench rung moe)", weights="random, seed 0 (fp32; bf16 experts)",
               setup_s=setup_s, launches=launches, checks=checks, profile=prof,
               optimizer_groups=groups, capacity=C,
               expert_tokens=[b.block_sparse_moe.expert_tokens.tolist() for b in run.model.blocks()],
               mfu_formula="(6 * active params + 12 * layers * T * hidden) * tokens/s / peak",
               **{k: v for k, v in res.items() if k != "launches_per_step"},
               launches_first_step=res["launches_per_step"][0])
    check(all(checks.values()), f"moe rung checks failed: {out}")
    del run
    free_memory()
    return out


def run_mixtral_full(dev, kernels_mod):
    """(c): Mixtral-8x7B at its published widths (``MIXTRAL_8X7B``: 4096 /
    14336, 32 heads / 8 KV heads, 8 experts, top-2, vocab 32000, rope theta
    1e6), depth cut to ``MOE_FULL_LAYERS``, the moe rung's B=2, T=2048
    batch and optimizer: 1 warm-up and 2 timed steps; a finite loss, the
    launches a step, step ms, MFU and peak."""
    from vescale_tpu_torch import bench
    from vescale_tpu_torch.models import MIXTRAL_8X7B

    cfg = dataclasses.replace(MIXTRAL_8X7B, num_hidden_layers=MOE_FULL_LAYERS,
                              max_position_embeddings=bench.MOE_RUNGS["moe"][2])
    t0 = time.perf_counter()
    run = bench.prepare_moe("moe", dev, config=cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    kernels_mod.reset_launches()
    res = bench.measure(run, warmup=1, steps=2)
    launches = dict(kernels_mod.LAUNCHES)
    L = MOE_FULL_LAYERS
    want = {**{k: 0 for k in kernels_mod.LAUNCHES}, "flash_fwd": L, "flash_bwd_dq": L,
            "flash_bwd_dkv": L, "fused_adamw": 2}
    expert = sum(p.numel() for n, p in run.model.named_parameters()
                 if n.rsplit(".", 1)[-1] in EXPERT_LEAF_NAMES)
    checks = {"losses_finite": bool(np.isfinite(res["losses"]).all()),
              "launches_per_step": all(s == want for s in res["launches_per_step"])}
    out = dict(model=f"Mixtral-8x7B widths, {L} of 32 layers", setup_s=setup_s,
               launches=launches, checks=checks, expert_params=expert,
               reduced=f"num_hidden_layers 32 -> {L}",
               **{k: v for k, v in res.items() if k != "launches_per_step"},
               launches_first_step=res["launches_per_step"][0])
    check(all(checks.values()), f"mixtral full-width checks failed: {out}")
    del run
    free_memory()
    return out


def moe_ep_leg(mesh, golden_path: str, ref_losses: list) -> dict:
    """(d), one rank: the moe rung's model and weights (``init_params``
    seed 0 on the card, the (b) leg's) under ``mixtral_plan`` on the ("ep",)
    mesh, ``MOE_EP_STEPS`` steps of ``make_train_step`` with
    ``AdamWLowmem`` over ``param_dtype_groups`` on the rung's batch, then
    one more with the collectives timed.  The first step's grads against
    one card's (``golden_path``): the replicated leaves' whole, the expert
    leaves' against this rank's rows, each leaf's relative L2 error within
    ``MOE_GRAD_REL_L2`` plus the routing flips' share (above); the tokens
    whose top-2 differs from one card's, by layer."""
    from vescale_tpu_torch import bench, kernels
    from vescale_tpu_torch import collectives as C
    from vescale_tpu_torch.dmodule import parallelize_module
    from vescale_tpu_torch.models import Mixtral, cross_entropy_loss, init_params, mixtral_plan
    from vescale_tpu_torch.parallel import AdamWLowmem, param_dtype_groups
    from vescale_tpu_torch.train import make_train_step

    dev = mesh.device
    cfg = bench.moe_config("moe")
    _, B, T, _ = bench.MOE_RUNGS["moe"]
    t0 = time.perf_counter()
    dm = parallelize_module(Mixtral(cfg, init_params(cfg, 0, device=dev), device=dev), mesh,
                            mixtral_plan(mesh))
    opt = AdamWLowmem(param_dtype_groups(dm.parameters()), bench.LR)
    step = make_train_step(dm, opt, lambda lg, b: cross_entropy_loss(lg, b["target"]))
    batch = bench.moe_batch(cfg, B, T, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    grads = {}
    real = opt.step

    def spy():
        if not grads:
            grads.update({n: p.grad.detach().clone() for n, p in dm.named_parameters()})
        real()

    opt.step = spy
    records, handles = moe_routing_hooks(dm.module)
    losses, step_ms, launches, comm = [], [], [], []
    for i in range(MOE_EP_STEPS):
        if i == 1:
            torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        C.reset_calls()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(step(batch)))
        step_ms.append((time.perf_counter() - t1) * 1e3)
        launches.append(dict(kernels.LAUNCHES))
        comm.append(tp_collectives())
    opt.step = real
    for h in handles:
        h.remove()
    C.reset_calls()
    C.TIMING = True
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    extra_loss = float(step(batch))
    timed_step_s = time.perf_counter() - t1
    C.TIMING = False
    gloo = dict(step_ms=timed_step_s * 1e3, loss=extra_loss, seconds_by_op=dict(C.SECONDS),
                share=sum(C.SECONDS.values()) / timed_step_s)
    golden = torch.load(golden_path)
    flips = [int((rec[0] != want).any(dim=-1).sum())
             for rec, want in zip(records, golden["routing"])]
    E, n = cfg.num_local_experts, cfg.num_local_experts // mesh.size()
    lo = mesh.get_coordinate()[0] * n
    grad_ulps, grad_rel, replicated = {}, {}, {}
    for name, g in grads.items():
        want = golden["grads"][name].to(dev)
        if name.rsplit(".", 1)[-1] in EXPERT_LEAF_NAMES:
            want = want[lo:lo + n]
        else:
            replicated[name] = g
        grad_ulps[name] = ulps_dev(g.float(), want.float())
        grad_rel[name] = float(torch.linalg.vector_norm((g.float() - want.float()).double())
                               / torch.linalg.vector_norm(want.double()))
    del golden
    L = cfg.num_hidden_layers
    want_launches = {**{k: 0 for k in kernels.LAUNCHES}, "flash_fwd": L, "flash_bwd_dq": L,
                     "flash_bwd_dkv": L, "fused_adamw": 2}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    N = int(records[0][0].shape[0])
    grad_bound = MOE_GRAD_REL_L2 + 2 * float(np.sqrt(2 * max(flips) / N))
    checks = {"losses_finite": bool(np.isfinite(losses).all()),
              "losses_within_1pct": len(rel) == len(losses) and max(rel) <= TP_LOSS_REL,
              "launches_per_step": all(s == want_launches for s in launches),
              "grads_within_bound": max(grad_rel.values()) <= grad_bound,
              "local_experts": all(p.shape[0] == n for nm, p in dm.named_parameters()
                                   if nm.rsplit(".", 1)[-1] in EXPERT_LEAF_NAMES)}
    worst = sorted(grad_rel.items(), key=lambda kv: -kv[1])[:6]
    worst_ulps = sorted(grad_ulps.items(), key=lambda kv: -kv[1])[:6]
    return dict(rank=mesh.get_rank(), setup_s=setup_s, losses=losses, ref_losses=ref_losses,
                loss_rel_diffs=rel, step_ms=step_ms,
                step_ms_median=float(np.median(step_ms[1:])),
                peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
                params_local=sum(p.numel() for p in dm.parameters()),
                launches_per_step=launches[-1],
                launches_total={k: sum(s[k] for s in launches) for k in launches[0]},
                collectives_per_step=comm[-1], gloo_timed_step=gloo,
                grad_rel_l2_worst=worst, grad_rel_l2_bound=grad_bound,
                grad_rel_l2_by_layer=moe_rel_by_layer(grad_rel, cfg.num_hidden_layers),
                grad_ulps_at_scale_worst=worst_ulps, routing_flips_first_step=flips,
                tokens_routed_per_layer=N,
                replicated_fingerprint=fingerprint(replicated[k] for k in sorted(replicated)),
                checks=checks)


def moe_rel_by_layer(rel: dict, L: int) -> dict:
    """The worst relative grad error of each layer's leaves, and of the
    leaves outside the layers."""
    out = {}
    for name, v in rel.items():
        key = name.split(".")[0] if name.startswith("layers_") else "outside"
        out[key] = max(out.get(key, 0.0), v)
    return {k: out[k] for k in [f"layers_{i}" for i in range(L)] + ["outside"] if k in out}


def moe_refresh_run(mesh, reallocate: bool) -> dict:
    """(e), one run on one rank: the moe rung's model (router columns
    skewed by ``MOE_ROUTER_SKEW``) with its expert leaves held in a
    ``MoEParamBuffer`` over "ep" and stepped by ``MoEOptimizer`` (K8 on
    this rank's pieces, bf16 moments), the other leaves by
    ``AdamWLowmem`` (fp32 moments): ``MOE_LOOP_STEPS`` steps, each
    gathering the experts, a forward and backward of the whole model on
    this rank and the two optimizer steps.  With ``reallocate``, after step
    ``MOE_REFRESH_AFTER`` ``BasicExpertsAllocator`` takes an EMA of the
    layers' summed ``expert_tokens`` and the buffer and the moments are
    refreshed to it."""
    import functools

    from vescale_tpu_torch import bench, kernels
    from vescale_tpu_torch.models import Mixtral, cross_entropy_loss, init_params
    from vescale_tpu_torch.moe import (BasicExpertsAllocator, ExpertsAllocator, MoEOptimizer,
                                       MoEParamBuffer)
    from vescale_tpu_torch.parallel import AdamWLowmem

    dev = mesh.device
    cfg = dataclasses.replace(bench.moe_config("moe"), num_hidden_layers=MOE_REFRESH_LAYERS)
    _, B, T, _ = bench.MOE_RUNGS["moe"]
    model = Mixtral(cfg, init_params(cfg, 0, device=dev), device=dev)
    blocks = model.blocks()
    with torch.no_grad():
        for b in blocks:
            for col, add in MOE_ROUTER_SKEW.items():
                b.block_sparse_moe.router[:, col] += add
    E, world = cfg.num_local_experts, mesh.size()
    expert = {f"layers_{i}": {k: getattr(b.block_sparse_moe, k) for k in EXPERT_LEAF_NAMES}
              for i, b in enumerate(blocks)}
    buffer = MoEParamBuffer(mesh, "ep", E, ExpertsAllocator(E, world).allocate())
    moe_opt = MoEOptimizer(functools.partial(AdamWLowmem, lr=bench.LR), buffer)
    sharded = buffer.shard_params({l: {k: p.detach() for k, p in d.items()}
                                   for l, d in expert.items()})
    state = moe_opt.init(sharded)
    ids = {id(p) for d in expert.values() for p in d.values()}
    dense = [p for p in model.parameters() if id(p) not in ids]
    dense_opt = AdamWLowmem(dense, bench.LR, state_dtype=torch.float32)
    batch = bench.moe_batch(cfg, B, T, dev)
    ema = np.zeros(E)
    losses, units, launches = [], [list(buffer.units)], []
    t0 = time.perf_counter()
    for i in range(MOE_LOOP_STEPS):
        kernels.reset_launches()
        full = moe_opt.buffer.gather_params(sharded)
        with torch.no_grad():
            for l, d in expert.items():
                for k, p in d.items():
                    p.copy_(full[l][k])
        del full
        model.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(model(batch["input"]), batch["target"])
        loss.backward()
        losses.append(float(loss.detach()))
        ema = 0.9 * ema + 0.1 * sum(b.block_sparse_moe.expert_tokens for b in blocks).cpu().numpy()
        grads = moe_opt.buffer.shard_params({l: {k: p.grad for k, p in d.items()}
                                             for l, d in expert.items()})
        sharded, state = moe_opt.step(sharded, state, grads)
        dense_opt.step()
        launches.append(dict(kernels.LAUNCHES))
        if reallocate and i == MOE_REFRESH_AFTER - 1:
            new = BasicExpertsAllocator(E, world).allocate(ema)
            _, sharded, state = moe_opt.refresh(sharded, state, new)
            units.append(list(new))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    final = dict(experts=moe_opt.buffer.gather_params(sharded),
                 moments={key: {l: {k: d.full_tensor() for k, d in leaves.items()}
                                for l, leaves in tree.items()}
                          for key, tree in state.items() if key != "step"},
                 dense=[p.detach().clone() for p in dense],
                 dense_moments=[dense_opt.state[p][k].clone() for p in dense
                                for k in ("exp_avg", "exp_avg_sq")])
    return dict(losses=losses, units=units, launches=launches, wall_s=wall_s,
                step=state["step"], local_pieces=moe_opt.buffer.local_experts(mesh.get_rank()),
                final=final)


def moe_ep_job(mesh, golden_path: str, ref_losses: list) -> dict:
    """One rank of the moe phase's spawn: (d), then (e)'s two runs."""
    from vescale_tpu_torch import kernels
    from vescale_tpu_torch.checkpoint.planner import flatten_state

    ep = moe_ep_leg(mesh, golden_path, ref_losses)
    free_memory()
    base = moe_refresh_run(mesh, reallocate=False)
    base_final = [t for _, t in flatten_state(base.pop("final"))]
    free_memory()
    re = moe_refresh_run(mesh, reallocate=True)
    re_final = [t for _, t in flatten_state(re.pop("final"))]
    equal = len(base_final) == len(re_final) and all(
        bits_equal(a, b) for a, b in zip(base_final, re_final))
    del base_final, re_final
    free_memory()
    L = MOE_REFRESH_LAYERS
    want = {**{k: 0 for k in kernels.LAUNCHES}, "flash_fwd": L, "flash_bwd_dq": L,
            "flash_bwd_dkv": L, "fused_adamw": 2}
    checks = {"units_changed": len(re["units"]) == 2 and re["units"][1] != re["units"][0],
              "losses_bitwise": base["losses"] == re["losses"],
              "params_and_moments_bitwise": equal,
              "step_kept": base["step"] == re["step"] == MOE_LOOP_STEPS,
              "loss_falls": base["losses"][-1] < base["losses"][0],
              "launches_per_step": all(s == want for s in base["launches"] + re["launches"])}
    refresh = dict(base=base, refreshed=re, checks=checks)
    launches_total = dict(ep["launches_total"])
    for run in (base, re):
        for s in run["launches"]:
            for k, v in s.items():
                launches_total[k] += v
    return dict(rank=mesh.get_rank(), ep=ep, refresh=refresh, launches_total=launches_total)


TP_JOBS["moe"] = moe_ep_job


def run_moe(dev, card, kernels_mod) -> dict:
    """The moe phase: (a) ``run_moe_small``, (b) ``run_moe_rung``, (c)
    ``run_mixtral_full``, then (d) and (e) in one spawn of two gloo ranks of
    the card on an ("ep",) mesh of 2 (``moe_ep_job``): every rank's
    replicated grads bitwise equal, each rank's checks."""
    out = {}
    tmp = tempfile.mkdtemp(prefix="vtt_moe_")
    # (d)/(e)'s ranks start up while (a)-(c) run, and wait for them
    spawned = tp_spawn_start("moe", {}, names=("ep",), held=True)
    try:
        t = time.perf_counter()
        out["small"] = run_moe_small(dev, kernels_mod)
        out["small"]["seconds"] = time.perf_counter() - t
        log("moe.small", **out["small"])  # each leg's line as it ends
        golden = os.path.join(tmp, "grads.pt")
        t = time.perf_counter()
        out["rung"] = run_moe_rung(dev, kernels_mod, golden)
        out["rung"]["seconds"] = time.perf_counter() - t
        log("moe.rung", **out["rung"])
        t = time.perf_counter()
        out["full"] = run_mixtral_full(dev, kernels_mod)
        out["full"]["seconds"] = time.perf_counter() - t
        log("moe.full", **out["full"])
    except BaseException:
        tp_spawn_abort(spawned)
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    try:
        t = time.perf_counter()
        tp_spawn_release(spawned, golden_path=golden,
                         ref_losses=out["rung"]["losses"][:MOE_EP_STEPS])
        ranks = tp_spawn_finish(spawned, timeout_s=600)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rep_equal = ranks[0]["ep"]["replicated_fingerprint"] == ranks[1]["ep"]["replicated_fingerprint"]
    for r in ranks:
        r["ep"].pop("replicated_fingerprint")
    out["ep"] = dict(ranks=[r["ep"] for r in ranks], replicated_grads_bitwise=rep_equal,
                     seconds=time.perf_counter() - t, card=card)
    out["refresh"] = [r["refresh"] for r in ranks]
    log("moe.ep", **out["ep"])
    log("moe.refresh", ranks=out["refresh"])
    launches = {k: 0 for k in kernels_mod.LAUNCHES}
    for leg in ("small", "rung", "full"):
        for k, v in out[leg]["launches"].items():
            launches[k] += v
    for r in ranks:
        for k, v in r["launches_total"].items():
            launches[k] += v
    out["launches"] = launches
    ok = rep_equal and all(all(r["ep"]["checks"].values()) and all(r["refresh"]["checks"].values())
                           for r in ranks)
    check(ok, f"moe ep/refresh checks failed: {json.dumps(out['ep'])[:3000]} "
              f"{json.dumps([r['refresh']['checks'] for r in ranks])}")
    return out


def moe_summary(moe: dict) -> dict:
    """The moe phase's line: the legs' seconds and checks and the launches
    (each leg printed its own line, ``moe.<leg>``)."""
    return dict(launches=moe["launches"],
                legs={leg: dict(seconds=moe[leg]["seconds"], checks=moe[leg]["checks"])
                      for leg in ("small", "rung", "full")},
                ep_checks=[r["checks"] for r in moe["ep"]["ranks"]],
                ep_seconds=moe["ep"]["seconds"],
                refresh_checks=[r["checks"] for r in moe["refresh"]],
                replicated_grads_bitwise=moe["ep"]["replicated_grads_bitwise"])


# --------------------------------------------------- n-D composition (nd)
# The nd phase: one spawn of ND_WORLD gloo ranks of the card, each leg on
# a mesh of its own over them.  (a) the moe rung on ("dp", "ep") = (2, 2)
# through make_train_step's default DDP, at the rung's capacity and at
# 1.0, then ZeRO over ("dp", "ep"); (b) Mixtral-8x7B's widths on ("ep",
# "tp") = (2, 2) with sequence parallelism; (c) GPT-2 on ("dp", "tp") =
# (2, 2) with two kernels sharded over "dp" by the plan.
ND_WORLD = 4
ND_STEPS = 3
ND_DROP_CF = 1.0  # the dropping capacity of leg (a)
# leg (a)'s depth: the moe rung's 8 -> 2 layers at full width (its one-card
# references at the same depth), so the script stays inside its time
# (PERF.md §7; 4 until the examples phase came)
ND_MOE_LAYERS = 2
# Mixtral-8x7B's depth in leg (b): 32 -> 1 layer.  Two layers would hold
# ~14 GB of leaves, grads and moments and ~6 GB of activations a rank, ~84
# GB for four ranks of the card (moe.full's one-card peak at 2 layers:
# 42.27 GB, PERF.md §7)
ND_FULL_LAYERS = 1
ND_GPT2_LAYERS = GLOO_GPT2_LAYERS  # leg (c)'s depth, as tp_train's GPT-2 leg
# leg (c)'s plan: nanogpt_plan with the MLP kernels over "dp" as well
ND_FSDP_OVER = {r"h_\d+\.mlp\.c_fc\.kernel": ("S0", "S1"),    # P("dp", "tp")
                r"h_\d+\.mlp\.c_proj\.kernel": ("S1", "S0")}  # P("tp", "dp")


def nd_moe_config():
    from vescale_tpu_torch import bench

    return dataclasses.replace(bench.moe_config("moe"), num_hidden_layers=ND_MOE_LAYERS)


def nd_full_config():
    from vescale_tpu_torch import bench
    from vescale_tpu_torch.models import MIXTRAL_8X7B

    return dataclasses.replace(MIXTRAL_8X7B, num_hidden_layers=ND_FULL_LAYERS,
                               max_position_embeddings=bench.MOE_RUNGS["moe"][2])


def nd_loss(model, mesh=None):
    """Cross entropy (vocab parallel over "tp" with ``mesh``, else the
    plain fp32 one) plus the blocks' aux losses, as
    examples/mixtral_4d_benchmark/mixtral_train.py:70-79 has it."""
    from vescale_tpu_torch.loss import vocab_parallel_cross_entropy
    from vescale_tpu_torch.models import cross_entropy_loss

    if mesh is None:
        xent = lambda lg, b: cross_entropy_loss(lg, b["target"])
    else:
        xent = lambda lg, b: vocab_parallel_cross_entropy(lg, b["target"], mesh=mesh,
                                                          vocab_dim_name="tp")
    return lambda lg, b: xent(lg, b) + sum(model.router_aux_losses())


def nd_dropped(tokens, N: int, cfg) -> list:
    """Each layer's routed pairs over capacity, from its global
    ``expert_tokens`` (a token routes to an expert at most once)."""
    from vescale_tpu_torch.moe import TokenDispatcher

    C = TokenDispatcher.capacity_for(N, cfg.num_local_experts, cfg.num_experts_per_tok,
                                     cfg.capacity_factor)
    return [int((t.float() - C).clamp(min=0).sum()) for t in tokens]


def nd_golden(dev, cfg, path: str, tp_loss: bool) -> dict:
    """One card's first step of ``cfg`` (``init_params`` seed 0) on the moe
    rung's batch: the loss, every gradient, each layer's routing and
    ``expert_tokens`` saved to ``path``; returns the loss and the dropped
    pairs."""
    from vescale_tpu_torch import bench
    from vescale_tpu_torch.loss import vocab_parallel_cross_entropy
    from vescale_tpu_torch.models import Mixtral, init_params

    _, B, T, _ = bench.MOE_RUNGS["moe"]
    model = Mixtral(cfg, init_params(cfg, 0, device=dev), device=dev)
    batch = bench.moe_batch(cfg, B, T, dev)
    records, handles = moe_routing_hooks(model)
    logits = model(batch["input"])
    if tp_loss:  # the kernels' cross entropy, as the vocab-parallel one on a rank
        loss = vocab_parallel_cross_entropy(logits, batch["target"]) + sum(
            model.router_aux_losses())
    else:
        loss = nd_loss(model)(logits, batch)
    loss.backward()
    for h in handles:
        h.remove()
    tokens = [b.block_sparse_moe.expert_tokens.cpu() for b in model.blocks()]
    torch.save({"grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                "routing": [rec[0] for rec in records], "tokens": tokens}, path)
    out = dict(loss=float(loss), dropped=nd_dropped(tokens, B * T, cfg))
    del model, logits, loss
    free_memory()
    return out


def nd_grads_against(mesh, dm, grads: dict, golden_path: str, records, dp_rows: int) -> dict:
    """This rank's first-step gradients against one card's (``nd_golden``):
    each leaf's relative L2 error against the piece its placements cut
    from the card's whole gradient, and the tokens of this rank's rows
    whose top-2 differs from the card's, by layer; the bound is
    ``MOE_GRAD_REL_L2`` plus twice sqrt(2 F / N) at the most flipped
    layer (moe.ep's)."""
    golden = torch.load(golden_path, mmap=True)
    coord = mesh.get_coordinate()
    names = mesh.mesh_dim_names
    d = coord[names.index("dp")] if "dp" in names else 0
    rel = {}
    for name, g in grads.items():
        want = dm._specs[name].local_from_full(golden["grads"][name], coord).to(g.device)
        rel[name] = float(torch.linalg.vector_norm((g.float() - want.float()).double())
                          / torch.linalg.vector_norm(want.double()))
    flips = []
    for rec, want in zip(records, golden["routing"]):
        mine = rec[0]
        flips.append(int((mine != want[d * dp_rows:(d + 1) * dp_rows]).any(dim=-1).sum()))
    del golden
    bound = MOE_GRAD_REL_L2 + 2 * float(np.sqrt(2 * max(flips) / dp_rows))
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:6]
    return dict(grad_rel_l2_worst=worst, grad_rel_l2_bound=bound, routing_flips=flips,
                grads_within_bound=max(rel.values()) <= bound)


def nd_steps(dm, opt, loss_fn, batch_fn, steps: int, want: dict, timed: bool = True) -> dict:
    """``steps`` steps of ``make_train_step(dm, opt, loss_fn)`` on
    ``batch_fn()``: the losses, step ms, each step's kernel launches
    against ``want``, the first step's gradients as the optimizer sees
    them (after DDP's reduce; none under a ``DistributedOptimizer``), the
    routing records of the first step, the peak a rank after the first
    step, and (``timed``) one more step with the collectives timed: the
    gloo share."""
    from vescale_tpu_torch import collectives as C
    from vescale_tpu_torch import kernels
    from vescale_tpu_torch.parallel import DistributedOptimizer
    from vescale_tpu_torch.train import make_train_step

    dev = dm.mesh.device
    step = make_train_step(dm, opt, loss_fn)
    grads, real = {}, opt.step
    if not isinstance(opt, DistributedOptimizer):
        def spy():
            if not grads:
                grads.update({n: p.grad.detach().clone() for n, p in dm.named_parameters()})
            real()

        opt.step = spy
    from vescale_tpu_torch.models import Mixtral

    moe = isinstance(dm.module, Mixtral)
    records, handles = moe_routing_hooks(dm.module) if moe else ([], [])
    losses, step_ms, launches = [], [], []
    for i in range(steps):
        if i == 1:
            torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(step(batch_fn())))
        step_ms.append((time.perf_counter() - t1) * 1e3)
        launches.append(dict(kernels.LAUNCHES))
        for h in handles:
            h.remove()
        handles = []
    opt.step = real
    tokens = [b.block_sparse_moe.expert_tokens.cpu() for b in dm.module.blocks()] if moe else []
    out = dict(losses=losses, step_ms=step_ms,
               step_ms_median=float(np.median(step_ms[1:] or step_ms)),
               peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
               launches_per_step=launches[-1],
               launches_total={k: sum(s[k] for s in launches) for k in launches[0]},
               launches_ok=all(s == want for s in launches))
    if timed:
        C.reset_calls()
        C.TIMING = True
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        float(step(batch_fn()))
        dt = time.perf_counter() - t1
        C.TIMING = False
        out["gloo_timed_step"] = dict(step_ms=dt * 1e3, seconds_by_op=dict(C.SECONDS),
                                      share=sum(C.SECONDS.values()) / dt)
        out["collectives_timed_step"] = tp_collectives()
    return out, grads, records, tokens


def nd_want(L: int, adamw: int, xent: int = 0) -> dict:
    from vescale_tpu_torch import kernels

    return {**{k: 0 for k in kernels.LAUNCHES}, "flash_fwd": L, "flash_bwd_dq": L,
            "flash_bwd_dkv": L, "fused_adamw": adamw, "fused_xent_fwd": xent,
            "fused_xent_bwd": xent}


def nd_dp_ep_leg(golden_dir: str, goldens: dict) -> dict:
    """(a), one rank: the moe rung (``init_params`` seed 0, the rung's
    B=2, T=2048 batch, each dp rank its row) under ``mixtral_plan`` on
    ("dp", "ep") = (2, 2): ``ND_STEPS`` steps through the default DDP
    (``AdamWLowmem`` over ``param_dtype_groups``), one at capacity 1.0,
    then ``ND_STEPS`` with ``DistributedOptimizer(dp_dims=("dp", "ep"))``
    (fp32 moments).  The first step's loss and grads against one card's
    at the same capacity; the dropped pairs on both sides; the ZeRO run's
    losses against the DDP run's."""
    import functools

    from vescale_tpu_torch import bench
    from vescale_tpu_torch.dmodule import parallelize_module
    from vescale_tpu_torch.mesh import init_device_mesh
    from vescale_tpu_torch.models import Mixtral, init_params, mixtral_plan
    from vescale_tpu_torch.parallel import (AdamWLowmem, DistributedOptimizer,
                                            param_dtype_groups)

    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("dp", "ep"), backend="gloo")
    dev = mesh.device
    _, B, T, _ = bench.MOE_RUNGS["moe"]
    d = mesh.get_coordinate()[0]
    out = {}
    for run, cf, steps in (("ddp", None, ND_STEPS), ("ddp_cf1", ND_DROP_CF, 1),
                           ("zero", None, ND_STEPS)):
        cfg = nd_moe_config()
        if cf is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=cf)
        t0 = time.perf_counter()
        model = Mixtral(cfg, init_params(cfg, 0, device=dev), device=dev)
        dm = parallelize_module(model, mesh, mixtral_plan(mesh))
        if run == "zero":
            opt = DistributedOptimizer(functools.partial(AdamWLowmem, lr=bench.LR,
                                                         state_dtype=torch.float32),
                                       models=dm, dp_dims=("dp", "ep"))
        else:
            opt = AdamWLowmem(param_dtype_groups(dm.parameters()), bench.LR)
        batch = bench.moe_batch(cfg, B, T, dev)
        rows = {k: v[d:d + 1] for k, v in batch.items()}
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        L = cfg.num_hidden_layers
        res, grads, records, tokens = nd_steps(
            dm, opt, nd_loss(model), lambda: rows, steps,
            nd_want(L, 1 if run == "zero" else 2), timed=run == "ddp")
        res["setup_s"] = setup_s
        golden = goldens["cf1" if cf is not None else "moe"]
        res["loss_rel_first"] = abs(res["losses"][0] - golden["loss"]) / abs(golden["loss"])
        res["dropped"] = nd_dropped(tokens, B * T, cfg) if run == "ddp_cf1" else None
        if grads:
            res.update(nd_grads_against(mesh, dm, grads, os.path.join(
                golden_dir, "cf1.pt" if cf is not None else "moe.pt"), records, T))
        checks = {"losses_finite": bool(np.isfinite(res["losses"]).all()),
                  "first_loss_within_1pct": res["loss_rel_first"] <= TP_LOSS_REL,
                  "launches_per_step": res["launches_ok"]}
        if grads:
            checks["grads_within_bound"] = res["grads_within_bound"]
        if run == "ddp_cf1":
            checks["drops_on_both_sides"] = min(sum(res["dropped"]), sum(golden["dropped"])) > 0
        if run == "zero":
            rel = [abs(a - b) / abs(b) for a, b in zip(res["losses"], out["ddp"]["losses"])]
            res["loss_rel_to_ddp"] = rel
            checks["losses_within_1pct_of_ddp"] = max(rel) <= TP_LOSS_REL
            res["state_placements_router"] = [
                str(p) for p in opt.state_placements()["inner"][0].mu["layers_0"][
                    "block_sparse_moe"]["router"]]
            res["state_placements_w_in"] = [
                str(p) for p in opt.state_placements()["inner"][0].mu["layers_0"][
                    "block_sparse_moe"]["w_in"]]
        res["checks"] = checks
        res["replicated_fingerprint"] = fingerprint(
            p for n, p in sorted(dm.named_parameters())
            if n.rsplit(".", 1)[-1] not in EXPERT_LEAF_NAMES)
        out[run] = res
        del model, dm, opt, grads, records
        free_memory()
    return out


def nd_ep_tp_leg(golden_dir: str, goldens: dict) -> dict:
    """(b), one rank: Mixtral-8x7B's widths at ``ND_FULL_LAYERS`` under
    ``mixtral_plan`` with sequence parallelism on ("ep", "tp") = (2, 2),
    ``ND_STEPS`` steps of ``AdamWLowmem`` over ``param_dtype_groups`` on
    the moe rung's batch, then one timed; the first step's loss and grads
    against one card's (``nd_golden``)."""
    from vescale_tpu_torch import bench
    from vescale_tpu_torch.dmodule import parallelize_module
    from vescale_tpu_torch.mesh import init_device_mesh
    from vescale_tpu_torch.models import Mixtral, init_params, mixtral_plan
    from vescale_tpu_torch.parallel import AdamWLowmem, param_dtype_groups

    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("ep", "tp"), backend="gloo")
    dev = mesh.device
    cfg = nd_full_config()
    _, B, T, _ = bench.MOE_RUNGS["moe"]
    t0 = time.perf_counter()
    model = Mixtral(cfg, init_params(cfg, 0, device=dev), device=dev)
    dm = parallelize_module(model, mesh, mixtral_plan(mesh, sequence_parallel=True))
    free_memory()
    opt = AdamWLowmem(param_dtype_groups(dm.parameters()), bench.LR)
    batch = bench.moe_batch(cfg, B, T, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    res, grads, records, _ = nd_steps(dm, opt, nd_loss(model, mesh), lambda: batch, ND_STEPS,
                                      nd_want(cfg.num_hidden_layers, 2, 1))
    res["setup_s"] = setup_s
    res["params_local"] = sum(p.numel() for p in dm.parameters())
    res["loss_rel_first"] = abs(res["losses"][0] - goldens["full"]["loss"]) / abs(
        goldens["full"]["loss"])
    res.update(nd_grads_against(mesh, dm, grads, os.path.join(golden_dir, "full.pt"), records,
                                B * T))
    res["checks"] = {"losses_finite": bool(np.isfinite(res["losses"]).all()),
                     "first_loss_within_1pct": res["loss_rel_first"] <= TP_LOSS_REL,
                     "launches_per_step": res["launches_ok"],
                     "grads_within_bound": res["grads_within_bound"]}
    del model, dm, opt, grads
    free_memory()
    return res


def nd_fsdp_leg(ref_losses: list, token_file: str) -> dict:
    """(c), one rank: GPT-2 124M's widths at ``ND_GPT2_LAYERS`` under
    ``nanogpt_plan`` (sequence parallel) with ``ND_FSDP_OVER``'s kernels
    sharded over "dp" too, on ("dp", "tp") = (2, 2): ``ND_STEPS`` steps with
    a ``DistributedOptimizer`` on the bench's B=12, T=1024 batches (each dp
    rank its 6 rows), the losses against one card's at that depth."""
    import functools

    from vescale_tpu_torch import bench
    from vescale_tpu_torch.data import TokenDataLoader
    from vescale_tpu_torch.dmodule import parallelize_module
    from vescale_tpu_torch.loss import vocab_parallel_cross_entropy
    from vescale_tpu_torch.mesh import init_device_mesh
    from vescale_tpu_torch.models import GPT, GPTConfig, init_params, nanogpt_plan
    from vescale_tpu_torch.parallel import AdamWLowmem, DistributedOptimizer
    from vescale_tpu_torch.placements import Shard

    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("dp", "tp"), backend="gloo")
    dev = mesh.device
    fields, B, T, state_dtype, _ = bench.GPT_RUNGS["gpt2"]
    cfg = GPTConfig(**dict(fields, n_layer=ND_GPT2_LAYERS))
    t0 = time.perf_counter()
    plan = nanogpt_plan(mesh, sequence_parallel=True)
    plan["parameter"].update({k: [Shard(int(a[1])) for a in v]
                              for k, v in ND_FSDP_OVER.items()})
    dm = parallelize_module(GPT(cfg, device="meta"), mesh, plan,
                            init_fn=functools.partial(init_params, cfg, 0, dtype=torch.float32))
    opt = DistributedOptimizer(functools.partial(AdamWLowmem, lr=bench.LR,
                                                 state_dtype=state_dtype), models=dm)
    # elastic: this dp rank's rows of the global stream the one-card run reads
    loader = TokenDataLoader(token_file, B // 2, T, seed=bench.DATA_SEED,
                             dp_rank=mesh.get_coordinate()[0], dp_world=2, elastic=True,
                             device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    L = cfg.n_layer
    res, _, _, _ = nd_steps(dm, opt, lambda lg, b: vocab_parallel_cross_entropy(
        lg, b["target"], mesh=mesh, vocab_dim_name="tp"), loader.next, ND_STEPS,
        nd_want(L, 1, 1))
    loader.close()
    rel = [abs(a - b) / abs(b) for a, b in zip(res["losses"], ref_losses)]
    res.update(setup_s=setup_s, ref_losses=ref_losses, loss_rel_diffs=rel,
               dp_sharded=sorted(dm.dp_sharded),
               params_local=sum(p.numel() for p in dm.parameters()))
    res["checks"] = {"losses_finite": bool(np.isfinite(res["losses"]).all()),
                     "losses_within_1pct": len(rel) == ND_STEPS and max(rel) <= TP_LOSS_REL,
                     "launches_per_step": res["launches_ok"],
                     "two_kernels_a_layer_over_dp": len(dm.dp_sharded) == 2 * L}
    del dm, opt
    free_memory()
    return res


def nd_job(mesh, golden_dir: str, goldens: dict, gpt2_ref: list, token_file: str) -> dict:
    """One rank of the nd phase's spawn: legs (a), (b), (c), each on its
    own mesh over the spawn's four ranks."""
    out = {"rank": mesh.get_rank()}
    for leg, fn in (("dp_ep", lambda: nd_dp_ep_leg(golden_dir, goldens)),
                    ("ep_tp", lambda: nd_ep_tp_leg(golden_dir, goldens)),
                    ("fsdp", lambda: nd_fsdp_leg(gpt2_ref, token_file))):
        t = time.perf_counter()
        out[leg] = fn()
        out[leg]["seconds"] = time.perf_counter() - t
        free_memory()
    runs = [out["dp_ep"][r] for r in ("ddp", "ddp_cf1", "zero")] + [out["ep_tp"], out["fsdp"]]
    total = {}
    for run in runs:
        for k, v in run["launches_total"].items():
            total[k] = total.get(k, 0) + v
    out["launches_total"] = total
    return out


TP_JOBS["nd"] = nd_job


def run_nd(dev, card, kernels_mod) -> dict:
    """The nd phase: the four ranks start up held while this process runs
    the one-card references (the moe rung's first step at its capacity and
    at 1.0, Mixtral-8x7B's widths at ``ND_FULL_LAYERS``, GPT-2's losses at
    ``ND_GPT2_LAYERS``), then legs (a)-(c) on them.  Every check of every
    rank; the replicated leaves bitwise equal across "ep" in (a)."""
    from vescale_tpu_torch import bench

    out = {"card": card}
    tmp = tempfile.mkdtemp(prefix="vtt_nd_")
    spawned = tp_spawn_start("nd", {}, names=("world",), held=True, shape=[ND_WORLD])
    try:
        t = time.perf_counter()
        moe_cfg = nd_moe_config()
        goldens = {
            "moe": nd_golden(dev, moe_cfg, os.path.join(tmp, "moe.pt"), False),
            "cf1": nd_golden(dev, dataclasses.replace(moe_cfg, capacity_factor=ND_DROP_CF),
                             os.path.join(tmp, "cf1.pt"), False),
            "full": nd_golden(dev, nd_full_config(), os.path.join(tmp, "full.pt"), True)}
        token_file = bench.write_token_file(os.path.join(tmp, "tokens.bin"), bench.DATA_TOKENS,
                                            50304)
        gpt2_ref = short_run_losses(dev, "gpt2", ND_GPT2_LAYERS, ND_STEPS, token_file)
        out["references"] = dict(goldens, gpt2_losses=gpt2_ref,
                                 seconds=time.perf_counter() - t)
        log("nd.references", **out["references"])
        t = time.perf_counter()
        tp_spawn_release(spawned, golden_dir=tmp, goldens=goldens, gpt2_ref=gpt2_ref,
                         token_file=token_file)
        ranks = tp_spawn_finish(spawned, timeout_s=900)
        out["legs_seconds"] = time.perf_counter() - t
    except BaseException:
        tp_spawn_abort(spawned)
        raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fps = {run: [r["dp_ep"][run].pop("replicated_fingerprint") for r in ranks]
           for run in ("ddp", "ddp_cf1", "zero")}
    # ep is the inner dim of (a)'s mesh: ranks 2j and 2j + 1 share a dp row
    out["replicated_bitwise_across_ep"] = {
        run: all(f[2 * j] == f[2 * j + 1] for j in range(ND_WORLD // 2)) for run, f in fps.items()}
    out["ranks"] = ranks
    launches = {k: 0 for k in kernels_mod.LAUNCHES}
    for r in ranks:
        for k, v in r["launches_total"].items():
            launches[k] += v
    out["launches"] = launches
    checks = [r["dp_ep"][run]["checks"] for r in ranks for run in ("ddp", "ddp_cf1", "zero")]
    checks += [r[leg]["checks"] for r in ranks for leg in ("ep_tp", "fsdp")]
    ok = all(all(c.values()) for c in checks) and all(out["replicated_bitwise_across_ep"].values())
    for leg in ("dp_ep", "ep_tp", "fsdp"):
        log(f"nd.{leg}", card=card, ranks=[r[leg] for r in ranks])
    check(ok, f"nd checks failed: {json.dumps(checks)} "
              f"{json.dumps(out['replicated_bitwise_across_ep'])}")
    return out


def nd_summary(nd: dict) -> dict:
    """The nd phase's line (each leg printed its own, ``nd.<leg>``)."""
    r0 = nd["ranks"][0]
    return dict(card=nd["card"], launches=nd["launches"], legs_seconds=nd["legs_seconds"],
                references_seconds=nd["references"]["seconds"],
                replicated_bitwise_across_ep=nd["replicated_bitwise_across_ep"],
                step_ms_median={"dp_ep.ddp": r0["dp_ep"]["ddp"]["step_ms_median"],
                                "dp_ep.zero": r0["dp_ep"]["zero"]["step_ms_median"],
                                "ep_tp": r0["ep_tp"]["step_ms_median"],
                                "fsdp": r0["fsdp"]["step_ms_median"]},
                checks=[{leg: r[leg]["checks"] for leg in ("ep_tp", "fsdp")} |
                        {f"dp_ep.{run}": r["dp_ep"][run]["checks"]
                         for run in ("ddp", "ddp_cf1", "zero")} for r in nd["ranks"]])


def nd_only(dev, card, kernels_mod) -> int:
    """``--nd``: the nd phase alone."""
    t = time.perf_counter()
    nd = run_nd(dev, card, kernels_mod)
    log("nd", seconds=time.perf_counter() - t, **nd_summary(nd))
    print(card, flush=True)
    return 0


# ------------------------------------------------------------ long context
# The kernels' long-context shapes: (label, B, T, H, KV, D, causal).  The
# longctx rung's attention; a ring block at sp = 2 of the (1, 32768, 16,
# 16, 64) sequence, causal on the diagonal and full below it; Ulysses'
# attention at sp = 2 (8 of the 16 heads over the whole sequence).
LONGCTX_SHAPES = (
    ("longctx rung", 1, 32768, 16, 8, 64, True),
    ("ring diagonal", 1, 16384, 16, 16, 64, True),
    ("ring below", 1, 16384, 16, 16, 64, False),
    ("ulysses", 1, 32768, 8, 8, 64, True),
)
LONGCTX_SEQ = (1, 32768, 16, 16, 64)  # the sp = 2 legs' global (B, T, H, KV, D)
LONGCTX_STEPS = 3  # timed steps of the rung, after bench.WARMUP
# ring at sp = 2 against one card's flash attention on the whole sequence,
# in bf16 steps at the reference's scale: the ring merges two bf16 block
# outputs in fp32 and sums two bf16 block grads in fp32, each a rounding
# the single launch does not make
RING_OUT_STEPS, RING_GRAD_STEPS = 4.0, 8.0
# Ulysses runs the same kernels on the same heads' whole sequences, so its
# output and grads are the single launch's (held within one bf16 step)
ULYSSES_STEPS = 1.0
# blockwise_attention (fp32, the reference's online softmax, autograd
# backward) against the fp32 flash kernels, in fp32 ulps at scale
BLOCKWISE_FWD_ULPS, BLOCKWISE_BWD_ULPS = 64.0, 256.0
EMU_SHAPE = (4096, 1024)  # each rank's all_reduce_q operand of the emulator leg


def longctx_kernels(dev, ulps):
    """(a): K1, dq and dkv at ``LONGCTX_SHAPES``.  Each shape launches once
    at full size; then its first and last query heads (with their kv heads)
    launch alone, bitwise the full launch's rows (dk and dv too where a kv
    head has one query head), and are held to the plain versions on that
    head: float64 within 2 bf16 steps and the bf16-P models within 1, the
    lse within 16 fp32 ulps of the model's (``flash_cases``' bounds; the
    plain versions materialise (T, T) scores, 8.6 GB a head in float64 at
    T=32768, so a head is what fits).  Times: the full-size launches, the
    plain versions on one head, and ``scaled_dot_product_attention``'s
    forward and backward at full size with the kv heads expanded."""
    import torch.nn.functional as F

    from vescale_tpu_torch.kernels.flash_attention import (
        _delta, flash_bwd, flash_bwd_dkv, flash_bwd_dkv_cost, flash_bwd_dq, flash_bwd_dq_cost,
        flash_bwd_reference, flash_fwd, flash_fwd_cost, flash_fwd_reference)

    rows, timings = [], {}
    for label, B, T, H, KV, D, causal in LONGCTX_SHAPES:
        rep = H // KV
        q, k, v, o, do, lse, args = flash_bwd_inputs(dev, B, T, H, KV, D, causal, torch.bfloat16)
        dq, dk, dv = flash_bwd(q, k, v, o, do, lse, **args)
        one = dict(scale=args["scale"], causal=causal, H=1, KV=1)
        row = dict(kernel="flash_fwd+flash_bwd", case=f"{label} ({B}, {T}, {H}, {KV}, {D})",
                   o_bound=2 * BF16_ULP, model_bound=BF16_ULP, lse_bound=16.0, heads={})
        ok = True
        for h in (0, H - 1):
            g = h // rep
            qs, ks, vs, dos = (t[i:i + 1].contiguous()
                               for t, i in ((q, h), (k, g), (v, g), (do, h)))
            os_, lses = flash_fwd(qs, ks, vs, **one)
            dqs, dks, dvs = flash_bwd(qs, ks, vs, os_, dos, lses, **one)
            hr = dict(fwd_bitwise_full=bits_equal(os_, o[h:h + 1])
                      and bits_equal(lses.reshape(-1), lse[:, h].reshape(-1)),
                      dq_bitwise_full=bits_equal(dqs, dq[h:h + 1]))
            if rep == 1:
                hr["dkv_bitwise_full"] = (bits_equal(dks, dk[g:g + 1])
                                          and bits_equal(dvs, dv[g:g + 1]))
            o64, _ = flash_fwd_reference(*(t.double() for t in (qs, ks, vs)), **one)
            hr["o_ulps"] = ulps(os_.double(), o64)
            del o64
            free_memory()
            om, lsem = flash_fwd_reference(qs, ks, vs, pd_dtype=torch.bfloat16, **one)
            hr["o_model_ulps"] = ulps(os_.double(), om.double())
            hr["lse_ulps"] = ulps(lses, lsem)
            del om, lsem
            free_memory()
            exact = flash_bwd_reference(*(t.double() for t in (qs, ks, vs, os_, dos, lses)), **one)
            for name, a, b in zip(("dq", "dk", "dv"), (dqs, dks, dvs), exact):
                hr[f"{name}_ulps"] = ulps(a.double(), b)
            del exact
            free_memory()
            model = flash_bwd_reference(qs, ks, vs, os_, dos, lses, pd_dtype=torch.bfloat16, **one)
            for name, a, b in zip(("dq", "dk", "dv"), (dqs, dks, dvs), model):
                hr[f"{name}_model_ulps"] = ulps(a.double(), b.double())
            del model
            free_memory()
            ok = ok and all(x for key, x in hr.items() if key.endswith("_full")) and \
                hr["o_ulps"] <= 2 * BF16_ULP and hr["o_model_ulps"] <= BF16_ULP and \
                hr["lse_ulps"] <= 16.0 and all(hr[f"{n}_ulps"] <= 2 * BF16_ULP and
                                               hr[f"{n}_model_ulps"] <= BF16_ULP
                                               for n in ("dq", "dk", "dv"))
            row["heads"][str(h)] = hr
        row["ok"] = ok
        rows.append(row)
        # times at full size; the plain versions on head 0 (what fits)
        lse2, delta = lse.reshape(B * H, T), _delta(o, do)
        qs, ks, vs, os_, dos = (t[:1].contiguous() for t in (q, k, v, o, do))
        lses = lse[:, :1].contiguous()
        fwd_ms = cuda_ms(lambda: flash_fwd(q, k, v, **args), iters=5, warmup=1)
        dq_ms = cuda_ms(lambda: flash_bwd_dq(q, k, v, do, lse2, delta, **args), iters=5, warmup=1)
        dkv_ms = cuda_ms(lambda: flash_bwd_dkv(q, k, v, do, lse2, delta, **args), iters=5,
                         warmup=1)
        plain_fwd_ms = cuda_ms(lambda: flash_fwd_reference(qs, ks, vs, pd_dtype=torch.bfloat16,
                                                           **one), iters=1, warmup=1)
        free_memory()
        plain_bwd_ms = cuda_ms(lambda: flash_bwd_reference(qs, ks, vs, os_, dos, lses, **one),
                               iters=1, warmup=1)
        free_memory()
        q4 = q.reshape(B, H, T, D).detach().requires_grad_()
        k4 = k.reshape(B, KV, T, D).repeat_interleave(rep, dim=1).detach().requires_grad_()
        v4 = v.reshape(B, KV, T, D).repeat_interleave(rep, dim=1).detach().requires_grad_()
        with torch.no_grad():
            sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                         is_causal=causal), iters=5)
        out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
        do4 = do.reshape(B, H, T, D)
        sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                                          retain_graph=True), iters=5)
        shape = dict(B=B, T=T, H=H, KV=KV, D=D, dtype="torch.bfloat16", causal=causal)
        fwd_flops, fwd_bytes = flash_fwd_cost(q, k, v, **args)
        dq_flops, dq_bytes = flash_bwd_dq_cost(q, k, v, do, lse2, delta, **args)
        dkv_flops, dkv_bytes = flash_bwd_dkv_cost(q, k, v, do, lse2, delta, **args)
        timings[label] = dict(
            shape=shape,
            flash_fwd=dict(ms=fwd_ms, plain_ms_one_head=plain_fwd_ms, library_ms=sdpa_fwd_ms,
                           **bound(fwd_bytes, fwd_flops, torch.bfloat16)),
            flash_bwd_dq=dict(ms=dq_ms, **bound(dq_bytes, dq_flops, torch.bfloat16)),
            flash_bwd_dkv=dict(ms=dkv_ms, **bound(dkv_bytes, dkv_flops, torch.bfloat16)),
            bwd_plain_ms_one_head=plain_bwd_ms, bwd_library_ms=sdpa_bwd_ms,
            bwd_pair_over_library=(dq_ms + dkv_ms) / sdpa_bwd_ms)
        del q, k, v, o, do, lse, dq, dk, dv, q4, k4, v4, out4, qs, ks, vs, os_, dos, lses
        free_memory()
    return rows, timings


def longctx_rung(dev, kernels_mod):
    """(b): the bench's longctx rung (the 350M at T=32768, remat over the
    MLP, ``scan_layers``): ``bench.WARMUP`` warm-up and ``LONGCTX_STEPS``
    timed steps, 24 K1, dq and dkv and one K8 a step, the loss falling;
    then one step under the profiler."""
    from vescale_tpu_torch.bench import measure, prepare

    t0 = time.perf_counter()
    run = prepare("longctx", device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    L = run.config.num_hidden_layers
    kernels_mod.reset_launches()
    res = measure(run, steps=LONGCTX_STEPS)
    launches = dict(kernels_mod.LAUNCHES)
    timed = res["losses"][res["warmup_steps"]:]
    want = {**{k: 0 for k in kernels_mod.LAUNCHES}, "flash_fwd": L, "flash_bwd_dq": L,
            "flash_bwd_dkv": L, "fused_adamw": 1}
    checks = {"losses_finite": bool(np.isfinite(res["losses"]).all()),
              "loss_falls": timed[-1] < timed[0],
              "launches_per_step": all(step == want for step in res["launches_per_step"])}
    prof = device_time_by_kind(lambda: run.step(run.next_batch()))
    prof["device_idle_share"] = max(0.0, 1.0 - prof["device_busy_ms"] / res["step_ms_median"])
    out = dict(model="llama 350M at T=32768 (bench rung longctx)",
               weights="random fp32 masters, seed 0", setup_s=setup_s, launches=launches,
               checks=checks, profile=prof,
               **{k: v for k, v in res.items() if k != "launches_per_step"},
               launches_first_step=res["launches_per_step"][0])
    check(all(checks.values()), f"longctx rung checks failed: {json.dumps(out)[:3000]}")
    del run
    free_memory()
    return out


def longctx_blockwise(dev, ulps):
    """(d): ``blockwise_attention`` (plain torch, the reference's online
    softmax) against ``ops.flash_attention`` (the fp32 kernels), fp32, on
    (1, T, 16, 64): forward and autograd backward at T=4096, and the
    forward under ``no_grad`` at T=32768; each timed once on the host
    clock around a synchronise."""
    import importlib

    from vescale_tpu_torch.parallel import blockwise_attention

    ops = importlib.import_module("vescale_tpu_torch.ops.flash_attention")
    out = dict(fwd_bound=BLOCKWISE_FWD_ULPS, bwd_bound=BLOCKWISE_BWD_ULPS)
    g = torch.Generator(device=dev).manual_seed(5)
    T = 4096
    q, k, v, w = (torch.randn(1, T, 16, 64, generator=g, device=dev) for _ in range(4))
    res = {}
    for name, fn in (("flash", lambda a, b, c: ops.flash_attention(a, b, c, causal=True)),
                     ("blockwise", lambda a, b, c: blockwise_attention(a, b, c, causal=True))):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = fn(*leaves)
        grads = torch.autograd.grad(o, leaves, w)
        torch.cuda.synchronize()
        res[name] = (o.detach(), grads, (time.perf_counter() - t0) * 1e3)
    (of, gf, tf), (ob, gb, tb) = res["flash"], res["blockwise"]
    t4 = dict(o_ulps=ulps(ob, of), flash_ms=tf, blockwise_ms=tb)
    for name, a, b in zip(("dq", "dk", "dv"), gb, gf):
        t4[f"{name}_ulps"] = ulps(a, b)
    out["t4096_fwd_bwd"] = t4
    del q, k, v, w, res, of, gf, ob, gb
    free_memory()
    T = 32768
    q, k, v = (torch.randn(1, T, 16, 64, generator=g, device=dev) for _ in range(3))
    timed = {}
    with torch.no_grad():
        for name, fn in (("flash", lambda: ops.flash_attention(q, k, v, causal=True)),
                         ("blockwise", lambda: blockwise_attention(q, k, v, causal=True))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timed[name] = fn()
            torch.cuda.synchronize()
            out[f"t32768_{name}_fwd_ms"] = (time.perf_counter() - t0) * 1e3
    out["t32768_fwd_o_ulps"] = ulps(timed["blockwise"], timed["flash"])
    out["ok"] = (t4["o_ulps"] <= BLOCKWISE_FWD_ULPS
                 and out["t32768_fwd_o_ulps"] <= BLOCKWISE_FWD_ULPS
                 and all(t4[f"{n}_ulps"] <= BLOCKWISE_BWD_ULPS for n in ("dq", "dk", "dv")))
    del q, k, v, timed
    free_memory()
    return out


def ctx_job(mesh, seed: int, emu_seed: int):
    """(c) and (e) on one rank of an ("sp",) mesh of 2 over gloo.  The
    whole (1, 32768, 16, 16, 64) bf16 q, k, v and the cotangent w, drawn
    on the card from ``seed`` (the same on both ranks); one card's flash
    attention on the whole sequence, forward and grads (the comparison,
    its launches not counted); then ring and Ulysses (its default
    ``attn_fn``, the port's flash attention) on this rank's half, each forward and
    backward, held to that launch's rows in bf16 steps, with their
    collectives (calls, bytes, seconds under ``collectives.TIMING``) and
    launches.  (e): ``all_reduce_q`` with "nearest" rounding of this rank's
    fp32 operand, bitwise the emulator's ``quantized_all_reduce`` replay on
    the host of both ranks' operands."""
    import importlib

    from vescale_tpu_torch import collectives as C
    from vescale_tpu_torch import emulator
    from vescale_tpu_torch import kernels as K
    from vescale_tpu_torch.kernels import ulps_at_scale
    from vescale_tpu_torch.parallel import ring_self_attention, ulysses_self_attention

    ops = importlib.import_module("vescale_tpu_torch.ops.flash_attention")
    B, T, H, KV, D = LONGCTX_SEQ
    n, r = mesh.size("sp"), mesh.get_coordinate()[0]
    dev = mesh.device
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(B, T, KV, D, generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    w = torch.randn(B, T, H, D, generator=g, device=dev).to(torch.bfloat16)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = ops.flash_attention(*leaves, causal=True)
    ref_grads = torch.autograd.grad(ref, leaves, w)
    ref = ref.detach()
    t = T // n
    sl = slice(r * t, (r + 1) * t)

    def steps(a, b) -> float:
        return ulps_at_scale(a.float().cpu().numpy(), b.float().cpu().numpy()) / BF16_ULP

    out = {}
    for kind, fn in (("ring", ring_self_attention), ("ulysses", ulysses_self_attention)):
        loc = [x[:, sl].contiguous().requires_grad_() for x in (q, k, v)]
        K.reset_launches()
        C.reset_calls()
        C.TIMING = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = fn(*loc, mesh, "sp", causal=True)
        grads = torch.autograd.grad(o, loc, w[:, sl].contiguous())
        o = o.detach()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        C.TIMING = False
        res = dict(wall_ms=wall * 1e3, launches=dict(K.LAUNCHES),
                   collectives=dict(calls=dict(C.CALLS), bytes=dict(C.BYTES),
                                    seconds=dict(C.SECONDS)),
                   gloo_share=sum(C.SECONDS.values()) / wall,
                   out_steps=steps(o, ref[:, sl]),
                   bitwise=bits_equal(o, ref[:, sl].contiguous()) and all(
                       bits_equal(a, b[:, sl].contiguous()) for a, b in zip(grads, ref_grads)))
        for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
            res[f"{name}_steps"] = steps(a, b[:, sl])
        bo, bg = (RING_OUT_STEPS, RING_GRAD_STEPS) if kind == "ring" else (ULYSSES_STEPS,) * 2
        res["bounds_bf16_steps"] = dict(out=bo, grads=bg)
        res["ok"] = res["out_steps"] <= bo and all(res[f"{g_}_steps"] <= bg
                                                   for g_ in ("dq", "dk", "dv"))
        out[kind] = res
        del o, grads, loc
    xs = [np.random.default_rng(emu_seed * 1000 + j).standard_normal(EMU_SHAPE).astype(np.float32)
          for j in range(n)]
    t0 = time.perf_counter()
    got = C.all_reduce_q(torch.from_numpy(xs[r]).to(dev), mesh, "sum", 0, block=64,
                         rounding="nearest").cpu().numpy()
    q_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    replay = emulator.quantized_all_reduce(xs, 64, "nearest")[r]
    out["emulator"] = dict(shape=list(EMU_SHAPE), all_reduce_q_ms=q_ms,
                           replay_ms=(time.perf_counter() - t0) * 1e3,
                           bitwise=bool(np.array_equal(got, replay)),
                           differing=int(np.sum(got != replay)))
    out["launches_total"] = {k_: out["ring"]["launches"][k_] + out["ulysses"]["launches"][k_]
                             for k_ in K.LAUNCHES}
    out["checks"] = dict(ring=out["ring"]["ok"], ulysses=out["ulysses"]["ok"],
                         emulator_bitwise=out["emulator"]["bitwise"])
    return out


TP_JOBS["ctx"] = ctx_job


def run_longctx(dev, card, kernels_mod) -> dict:
    """The longctx phase: (a) ``longctx_kernels``, (b) ``longctx_rung``,
    (d) ``longctx_blockwise``, then (c) and (e) in one spawn of two gloo
    ranks of the card on an ("sp",) mesh (``ctx_job``), started held so
    that its start-up overlaps (a)-(d), and released after them."""
    out = {}
    spawned = tp_spawn_start("ctx", dict(seed=7, emu_seed=3), names=("sp",), held=True)
    try:
        t = time.perf_counter()
        rows, timings = longctx_kernels(dev, ulps_dev)
        out["kernels"] = dict(rows=rows, timings=timings, seconds=time.perf_counter() - t,
                              card=card)
        log("longctx.kernels", **out["kernels"])
        t = time.perf_counter()
        out["rung"] = run = longctx_rung(dev, kernels_mod)
        run["seconds"] = time.perf_counter() - t
        log("longctx.rung", card=card, **run)
        t = time.perf_counter()
        out["blockwise"] = longctx_blockwise(dev, ulps_dev)
        out["blockwise"]["seconds"] = time.perf_counter() - t
        log("longctx.blockwise", **out["blockwise"])
    except BaseException:
        tp_spawn_abort(spawned)
        raise
    t = time.perf_counter()
    tp_spawn_release(spawned)
    ranks = tp_spawn_finish(spawned, timeout_s=600)
    out["sp"] = dict(ranks=ranks, seconds=time.perf_counter() - t, card=card)
    log("longctx.sp", **out["sp"])
    launches = dict(run["launches"])
    for r in ranks:
        for k, v in r["launches_total"].items():
            launches[k] += v
    out["launches"] = launches
    checks = dict(kernels=all(r["ok"] for r in rows), rung=all(run["checks"].values()),
                  blockwise=out["blockwise"]["ok"],
                  **{f"rank{i}_{k}": v for i, r in enumerate(ranks)
                     for k, v in r["checks"].items()})
    out["checks"] = checks
    check(all(checks.values()), f"longctx checks failed: {json.dumps(checks)}")
    return out


def longctx_summary(lc: dict) -> dict:
    return dict(launches=lc["launches"], checks=lc["checks"],
                legs={leg: lc[leg]["seconds"] for leg in ("kernels", "rung", "blockwise", "sp")},
                step_ms_median=lc["rung"]["step_ms_median"], mfu=lc["rung"]["mfu"],
                peak_memory_bytes=lc["rung"]["peak_memory_bytes"])


# --------------------------------------------------------------------- fp8
FP8_STEPS = 20  # steps of each 1.3B run, fp8 and bf16: bench.WARMUP, then timed
FP8_REL = 0.1  # the fp8 run's last loss against the bf16 run's (tests/test_fp8.py:92)
# the cpu rung with use_fp8, card against CPU: the losses of three steps,
# relative.  On the CPU the port sits 1.1e-7 from flax
# (tests/test_torch_fp8.py); the card's fp8 products add the tensor
# cores' accumulation error, which the CPU's exact fp32 sums of the codes
# do not have: ``fp8_matmul_probe`` measured the card's product 2.8e-4 of
# its scale from the exact sum, and the three steps' losses 6.6e-4 apart
# (without fp8 the same legs agree to 7.9e-8).  Three times that gap
FP8_CPU_RTOL = 2e-3
# the backward alone, card against CPU (``fp8_cpu_leg``): the projection
# grads and g amax of one step may sit this many times the gap of the
# CPU's "noise twin", the same step with every fp8 product's sum perturbed
# by the probe's measured accumulation gap.  e5m2 keeps 2 mantissa bits, so
# a small perturbation flips some codes near a rounding edge: the twin
# moves the small model's grads by 0.174 relative L2 and its g amax by
# 7.4e-2, the card by 0.155 and 5.3e-2 (NVIDIA H100 80GB HBM3, 700 W);
# a wrong scale or layout moves them by 1 or more.  The g scales come
# from the same loaded history: bitwise.
FP8_TWIN_FACTOR = 3.0
FP8_PROBE_REL = 1e-3  # the probe's product against the exact sum of its codes
# the cpu rung widened to head_dim 64, the kernels' smallest (4 -> 2 heads)
FP8_CPU_HEADS = dict(num_attention_heads=2, num_key_value_heads=2)


def fp8_amax_hooks(model):
    """Hooks recording each fp8 op's input, kernel and output-gradient
    amax of the latest step, by op name; returns (records, handles)."""
    from vescale_tpu_torch.quant.fp8 import Fp8DirectDotGeneralOp

    rec, handles = {}, []
    for name, m in model.named_modules():
        if not isinstance(m, Fp8DirectDotGeneralOp):
            continue

        def fwd(mod, inputs, output, name=name):
            # detached: an amax kept in the graph would hold the step's
            # activations alive through the hooks' reference cycle
            x, kernel = (t.detach() for t in inputs)
            rec[name] = {"input": x.to(kernel.dtype).abs().amax().float(),
                         "kernel": kernel.abs().amax().float()}
            output.register_hook(lambda gr: rec[name].__setitem__(
                "output_grad", gr.detach().abs().amax().float()))

        handles.append(m.register_forward_hook(fwd))
    return rec, handles


def fp8_quantize_ms(dev, cfg, rows: int) -> dict:
    """Device ms of one step's quantize passes alone (amax, scale, clip,
    cast: ``quant.fp8._update_meta`` and ``_flax_quantize``): each block
    projection's input and kernel (forward) and output gradient
    (backward), ``cfg.num_hidden_layers`` times, on bf16 tensors of the
    step's shapes."""
    from vescale_tpu_torch.quant import fp8 as F8

    E, Fi, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    H, KV = cfg.num_attention_heads, cfg.num_key_value_heads
    shapes = [(E, H * hd), (E, KV * hd), (E, KV * hd), (H * hd, E), (E, Fi), (E, Fi), (Fi, E)]
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    mats = [(torch.randn(rows, i, generator=g, device=dev).to(bf),
             torch.randn(i, o, generator=g, device=dev).to(bf),
             torch.randn(rows, o, generator=g, device=dev).to(bf)) for i, o in shapes]
    hist = torch.rand(1024, device=dev)
    scale = torch.ones(1, device=dev)

    def one_layer():
        for x, k, gy in mats:
            for t, fmax, dt in ((x, F8.E4M3_MAX, F8.E4M3), (k, F8.E4M3_MAX, F8.E4M3),
                                (gy, F8.E5M2_MAX, F8.E5M2)):
                s, _ = F8._update_meta(t, fmax, scale, hist)
                F8._flax_quantize(t, dt, fmax, s, bf)

    layer_ms = cuda_ms(one_layer, iters=5, warmup=1)
    del mats
    free_memory()
    return dict(layer_ms=layer_ms, step_ms=layer_ms * cfg.num_hidden_layers,
                passes_per_step=3 * len(shapes) * cfg.num_hidden_layers)


def fp8_matmul_probe(dev) -> dict:
    """How far the card's fp8 product sits from the exact sum of its
    codes, and whether it flushes e4m3 subnormals: fp32 normals (x ~
    N(0, 1), w ~ N(0, 0.088^2), the cpu rung's kernel scale at its first
    step's unit scale) cast to e4m3 on the CPU and on the card (bytes
    compared), then ``quant.fp8.fp8_matmul`` (``_scaled_mm``, fp32 out)
    against the exact (float64) product of the codes and against it with
    every subnormal code flushed to zero, relative to the product's
    largest magnitude."""
    from vescale_tpu_torch.quant import fp8 as F8

    g = torch.Generator().manual_seed(0)
    x = torch.randn(256, 128, generator=g)
    w = torch.randn(128, 256, generator=g) * 0.088
    qx, qw = x.to(F8.E4M3), w.to(F8.E4M3)
    qx_d, qw_d = x.to(dev).to(F8.E4M3), w.to(dev).to(F8.E4M3)
    cast_equal = torch.equal(qx.view(torch.uint8), qx_d.cpu().view(torch.uint8)) and torch.equal(
        qw.view(torch.uint8), qw_d.cpu().view(torch.uint8))
    card = F8.fp8_matmul(qx_d, qw_d, torch.float32).cpu().double()
    tiny = 2.0 ** -6  # e4m3's smallest normal

    def flush(q):
        f = q.double()
        return torch.where(f.abs() < tiny, torch.zeros_like(f), f)

    exact = qx.double() @ qw.double()
    ftz = flush(qx) @ flush(qw)
    scale = float(exact.abs().max())
    return dict(cast_bytes_equal=cast_equal,
                subnormal_share_w=float((qw.float().abs() < tiny).float().mean()),
                card_vs_exact=float((card - exact).abs().max()) / scale,
                card_vs_flushed=float((card - ftz).abs().max()) / scale)


def fp8_cpu_run(device, fp8: bool, params=None):
    """(model, step, batch) of the bench's cpu rung (fp32, AdamWLowmem at
    the bench's LR, its numpy-seeded batch) widened to ``FP8_CPU_HEADS``,
    with ``use_fp8`` as asked, on ``device``: weights and fp8 state from
    ``params`` (a ``module_tree``), else ``init_params`` seed 0."""
    from vescale_tpu_torch.bench import LR, RUNGS
    from vescale_tpu_torch.models import Llama, LlamaConfig, cross_entropy_loss, init_params
    from vescale_tpu_torch.parallel import AdamWLowmem
    from vescale_tpu_torch.train import make_train_step

    fields, B, T, state_dtype, _ = RUNGS["cpu"]
    cfg = LlamaConfig(max_position_embeddings=T, **dict(fields, use_fp8=fp8, **FP8_CPU_HEADS))
    if params is None:
        params = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    model = Llama(cfg, params, device=device)
    opt = AdamWLowmem(model.parameters(), LR, state_dtype=state_dtype)
    step = make_train_step(model, opt, lambda lg, b: cross_entropy_loss(lg, b["target"]))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T + 1))
    t = torch.from_numpy(toks.astype(np.int64)).to(device)
    return model, step, {"input": t[:, :-1], "target": t[:, 1:]}


def fp8_step_one(model, step, batch) -> dict:
    """One step; then, on the CPU, every block projection kernel's
    gradient of that step and the fp8 state the step wrote."""
    from vescale_tpu_torch.quant import fp8 as F8

    loss = float(step(batch))
    grads = {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()
             if n.endswith("_proj.kernel")}
    state = {n: b.detach().cpu().double() for n, b in F8.owg_buffers(model).items()}
    return dict(loss=loss, grads=grads, state=state)


def fp8_gap(card: dict, cpu: dict) -> dict:
    """Card against CPU after one step from the same weights and state:
    the largest relative L2 gap of a projection kernel's gradient (dk, and
    through the layers above it dx), and of the output-gradient histories'
    [0] and scales (each op's g amax and the e5m2 scale its backward
    used), over every op."""
    def rel(a, b):
        return float((a - b).norm() / b.norm())

    gs = {n: rel(card["grads"][n], g) for n, g in cpu["grads"].items()}
    h0 = [n for n in cpu["state"] if n.endswith("output_grad_amax_history")]
    sc = [n for n in cpu["state"] if n.endswith("output_grad_scale")]
    return dict(grad_max_rel=max(gs.values()), grad_worst=max(gs, key=gs.get),
                g_amax_max_rel=max(rel(card["state"][n][..., 0], cpu["state"][n][..., 0])
                                   for n in h0),
                g_scale_max_rel=max(rel(card["state"][n], cpu["state"][n]) for n in sc))


def fp8_noise_twin(mid, ref: dict, amp: float) -> dict:
    """``fp8_gap`` of the CPU's step from ``mid`` again, with every fp8
    product's sum perturbed by seeded normal noise of ``amp`` times its
    largest magnitude, against ``ref`` (the unperturbed step): the gap an
    accumulation error of that size opens by itself."""
    from vescale_tpu_torch.models import tree_to
    from vescale_tpu_torch.quant import fp8 as F8

    orig = F8.fp8_matmul
    g = torch.Generator().manual_seed(0)

    def noisy(a, b, out_dtype):
        y = orig(a, b, out_dtype)
        return y + amp * y.abs().max() * torch.randn(y.shape, generator=g, dtype=y.dtype)

    F8.fp8_matmul = noisy
    try:
        return fp8_gap(fp8_step_one(*fp8_cpu_run("cpu", True, tree_to(mid, "cpu"))), ref)
    finally:
        F8.fp8_matmul = orig


def fp8_cpu_leg(dev, kernels_mod) -> dict:
    """The cpu rung (fp32) with ``use_fp8``, widened to head_dim 64, on the
    CPU and on the card from the CPU's weights and state: three steps'
    losses within ``FP8_CPU_RTOL``, the card's products through
    ``_scaled_mm`` (out_dtype fp32).  Then the backward alone: from the
    CPU's weights and state after its first step (each op's scales no
    longer 1), one more step on each: their projection grads and g amax
    within ``FP8_TWIN_FACTOR`` times the CPU noise twin's gap at the
    probe's measured accumulation error, their g scales bitwise; and the
    check's power: the card's step again with the e5m2 scale dropped from
    dx's dequantize (a planted backward fault, undone after) must fail
    that bound."""
    from vescale_tpu_torch.models import module_tree, tree_to
    from vescale_tpu_torch.quant import fp8 as F8

    cpu = fp8_cpu_run("cpu", True)
    start = tree_to(module_tree(cpu[0]), dev)  # copies: the CPU's steps move its leaves
    card = fp8_cpu_run(dev, True, start)
    kernels_mod.reset_launches()
    F8.SCALED_MM_CALLS.clear()
    l_cpu = [float(cpu[1](cpu[2]))]
    mid = tree_to(module_tree(cpu[0]), dev)
    l_cpu += [float(cpu[1](cpu[2])) for _ in range(2)]
    l_card = [float(card[1](card[2])) for _ in range(3)]
    launches, mm_calls = dict(kernels_mod.LAUNCHES), dict(F8.SCALED_MM_CALLS)
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    ref = fp8_step_one(*fp8_cpu_run("cpu", True, tree_to(mid, "cpu")))
    gap = fp8_gap(fp8_step_one(*fp8_cpu_run(dev, True, mid)), ref)
    probe = fp8_matmul_probe(dev)
    twin = fp8_noise_twin(mid, ref, probe["card_vs_exact"])
    bound = {k: FP8_TWIN_FACTOR * twin[k] for k in ("grad_max_rel", "g_amax_max_rel")}
    # the planted fault: dx = q_g q_w^T s_w, without s_g
    orig = F8._Fp8DirectDot.backward

    def dropped_sg(ctx, gy):
        dx, dk, *state = orig(ctx, gy)
        return (dx / state[-1].to(dx.dtype), dk, *state)

    F8._Fp8DirectDot.backward = staticmethod(dropped_sg)
    try:
        planted = fp8_gap(fp8_step_one(*fp8_cpu_run(dev, True, mid)), ref)
        bad = fp8_cpu_run(dev, True, start)
        l_bad = [float(bad[1](bad[2])) for _ in range(3)]
    finally:
        F8._Fp8DirectDot.backward = orig
    # the planted run's three losses against the CPU's: what the loss
    # bound alone makes of the fault
    planted["loss_max_rel"] = max(abs(a - b) / abs(b) for a, b in zip(l_bad, l_cpu))
    planted["caught"] = planted["grad_max_rel"] > bound["grad_max_rel"]
    out = dict(config="bench cpu rung, use_fp8, 2 heads of 64", losses_cpu=l_cpu,
               losses_card=l_card, max_rel=rel, bound=FP8_CPU_RTOL, **gap, noise_twin=twin,
               twin_bounds=bound, planted_fault=planted, scaled_mm_calls=mm_calls,
               launches=launches, matmul_probe=probe,
               ok=(rel <= FP8_CPU_RTOL and gap["grad_max_rel"] <= bound["grad_max_rel"]
                   and gap["g_amax_max_rel"] <= bound["g_amax_max_rel"]
                   and gap["g_scale_max_rel"] == 0.0 and planted["caught"]
                   and sum(mm_calls.values()) == 3 * 7 * 2 * 3
                   and probe["cast_bytes_equal"] and probe["card_vs_exact"] <= FP8_PROBE_REL))
    # the same config without fp8, card against CPU: the gap of everything else
    plain = [fp8_cpu_run("cpu", False)]
    plain.append(fp8_cpu_run(dev, False, module_tree(plain[0][0])))
    lp = [[float(step(batch)) for _ in range(3)] for _, step, batch in plain]
    out["no_fp8_max_rel"] = max(abs(a - b) / abs(b) for a, b in zip(lp[1], lp[0]))
    del plain, cpu, card, bad, start, mid
    free_memory()
    return out


def run_fp8(dev, card, kernels_mod) -> dict:
    """The fp8 phase: the card-against-CPU leg, the bf16 1.3B rung for
    ``FP8_STEPS`` steps, then the same rung from the same seed with
    ``use_fp8`` for as many steps (3 x 7 x 24 ``_scaled_mm`` calls a
    step; every state leaf finite and each history's [0] the step's amax,
    read by hooks in one more step; one step profiled; the quantize
    passes timed alone): the fp8 loss falls and ends within ``FP8_REL``
    of the bf16 run's."""
    from vescale_tpu_torch.bench import WARMUP, measure, prepare
    from vescale_tpu_torch.quant import fp8 as F8

    out = {}
    t = time.perf_counter()
    out["cpu_leg"] = fp8_cpu_leg(dev, kernels_mod)
    out["cpu_leg"]["seconds"] = time.perf_counter() - t
    log("fp8.cpu_leg", **out["cpu_leg"])
    t = time.perf_counter()
    base = prepare("1.3b", device=dev)
    res16 = measure(base, warmup=WARMUP, steps=FP8_STEPS - WARMUP)
    del base
    free_memory()
    l16 = res16["losses"]
    out["bf16"] = dict(losses=l16, step_ms_median=res16["step_ms_median"], mfu=res16["mfu"],
                       peak_memory_bytes=res16["peak_memory_bytes"],
                       seconds=time.perf_counter() - t)
    t = time.perf_counter()
    run = prepare("1.3b", device=dev, fp8=True)
    L = run.config.num_hidden_layers
    kernels_mod.reset_launches()
    F8.SCALED_MM_CALLS.clear()
    res = measure(run, warmup=WARMUP, steps=FP8_STEPS - WARMUP)
    launches = dict(kernels_mod.LAUNCHES)
    mm_calls = dict(F8.SCALED_MM_CALLS)
    rec, handles = fp8_amax_hooks(run.model)
    run.step(run.next_batch())
    for h in handles:
        h.remove()
    state = F8.owg_buffers(run.model)
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(b).all()) for b in state.values())
    amax_ok, amax_checked = True, 0
    for op, vals in rec.items():
        for slot, leaf in (("input", "input_amax_history"), ("kernel", "kernel_amax_history"),
                           ("output_grad", "output_grad_amax_history")):
            amax_ok = amax_ok and bool(state[f"{op}.{leaf}"][0] == vals[slot])
            amax_checked += 1
    prof = device_time_by_kind(lambda: run.step(run.next_batch()), named=("Float8",))
    prof["device_idle_share"] = max(0.0, 1.0 - prof["device_busy_ms"] / res["step_ms_median"])
    quant = fp8_quantize_ms(dev, run.config, run.tokens_per_step)
    want = {**{k: 0 for k in kernels_mod.LAUNCHES}, "flash_fwd": L, "flash_bwd_dq": L,
            "flash_bwd_dkv": L, "fused_adamw": 1}
    out["fp8"] = dict(model="llama 1.3B (bench rung 1.3b) with use_fp8", steps=FP8_STEPS,
                      launches=launches, scaled_mm_calls=mm_calls, state_leaves=len(state),
                      amax_checked=amax_checked, quantize=quant, profile=prof,
                      **{k: v for k, v in res.items() if k != "launches_per_step"},
                      launches_first_step=res["launches_per_step"][0])
    l8 = res["losses"]
    del run, state, rec
    free_memory()
    out["fp8"]["allocated_after_bytes"] = torch.cuda.memory_allocated(dev)
    out["fp8"]["seconds"] = time.perf_counter() - t
    rel = abs(l8[-1] - l16[-1]) / abs(l16[-1])
    checks = {"cpu_leg": out["cpu_leg"]["ok"],
              "scaled_mm_per_step": sum(mm_calls.values()) == 3 * 7 * L * FP8_STEPS,
              "launches_per_step": all(s == want for s in res["launches_per_step"]),
              "state_finite": finite,
              "history0_is_the_steps_amax": amax_ok and amax_checked == 3 * 7 * L,
              "fp8_loss_falls": l8[-1] < l8[0], "fp8_tracks_bf16": rel < FP8_REL}
    out.update(last_loss_rel=rel, checks=checks)
    out["launches"] = {k: launches[k] + out["cpu_leg"]["launches"][k] for k in launches}
    log("fp8.rung", card=card, **out["fp8"], bf16=out["bf16"], last_loss_rel=rel)
    check(all(checks.values()), f"fp8 checks failed: {json.dumps(checks)}")
    return out


def fp8_summary(f8: dict) -> dict:
    return dict(launches=f8["launches"], checks=f8["checks"], last_loss_rel=f8["last_loss_rel"],
                step_ms_median=f8["fp8"]["step_ms_median"], mfu=f8["fp8"]["mfu"],
                bf16_step_ms_median=f8["bf16"]["step_ms_median"],
                quantize_step_ms=f8["fp8"]["quantize"]["step_ms"])


# ----------------------------------------------------------- train leftovers
LEFTOVER_MUON_STEPS = 4  # the first step twice (bitwise), then three more
NS_CARD_SHAPE = (1024, 2816)  # the Newton-Schulz card-against-CPU check
# the Muon leg's depth: the 1.3B rung's 24 -> 8 layers at full width (its
# checks count per layer), so the script with the examples phase stays
# inside its time (PERF.md §7; 24 until the examples phase came)
MUON_LAYERS = 8
NS_CARD_ATOL = 2e-5  # true fp32 products; TF32 would be ~1e-3 off
# nanoGPT's config/train_shakespeare_char.py (bias: train.py's default)
SHAKESPEARE = dict(block_size=256, vocab_size=65, n_layer=6, n_head=6, n_embd=384, dropout=0.2,
                   bias=False)
SHAKESPEARE_BATCH = 64
# the config's betas and weight decay; its lr (1e-3) comes after 100 warm-up
# steps, so a few steps from the seed take the bench's constant 3e-4
SHAKESPEARE_OPT = dict(lr=3e-4, betas=(0.9, 0.99), weight_decay=0.1)
SHAKESPEARE_STEPS = 6  # 1 warm-up, 5 timed, in each of two runs
HF_LAYERS = 1  # the 8B widths written as HF shards (2 until the examples phase)
HF_REQUESTS = 4


def leftover_muon(dev, kernels_mod) -> dict:
    """(a) The 1.3B rung at full width, ``MUON_LAYERS`` deep, stepped by the
    1B sweep's Muon (``bench.prepare("1.3b", opt="muon")``): the first step
    from the seed-0 state twice, bitwise (loss and every parameter), then
    three more; the loss falls; each step's launches (a K1, dq and dkv a
    layer, one K8 over the
    fallback leaves); step ms, the Newton-Schulz ms of each step (CUDA
    events around every call), peak memory.  Before it, Newton-Schulz at
    ``NS_CARD_SHAPE`` on the card against the CPU, which holds the fp32
    products to true fp32."""
    from vescale_tpu_torch.bench import prepare
    from vescale_tpu_torch.parallel import muon, newton_schulz
    from vescale_tpu_torch.parallel import optimizer as opt_mod
    from vescale_tpu_torch.parallel import AdamWLowmem
    from vescale_tpu_torch.train import make_train_step
    from vescale_tpu_torch.models import cross_entropy_loss

    check(torch.backends.cuda.matmul.allow_tf32 is False, "Muon's fp32 products must not run in TF32")
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(NS_CARD_SHAPE).astype(np.float32))
    ns_err = float((newton_schulz(g.to(dev)).cpu() - newton_schulz(g)).abs().max())
    t0 = time.perf_counter()
    run = prepare("1.3b", device=dev, opt="muon", layers=MUON_LAYERS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model, L = run.model, run.config.num_hidden_layers
    params = list(model.parameters())
    batch = run.next_batch()
    ns_events = []
    real_ns = opt_mod.newton_schulz

    def timed_ns(G, steps=5, eps=1e-7):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = real_ns(G, steps, eps)
        b.record()
        ns_events.append((a, b))
        return out

    def one(step):
        ns_events.clear()
        before = dict(kernels_mod.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = float(step(batch))
        ms = (time.perf_counter() - t) * 1e3
        ns_ms = sum(a.elapsed_time(b) for a, b in ns_events)
        return (loss, ms, ns_ms, {k: kernels_mod.LAUNCHES[k] - before[k] for k in before},
                len(ns_events))

    snap = [p.detach().clone() for p in params]
    kernels_mod.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    opt_mod.newton_schulz = timed_ns
    try:
        first = one(run.step)
        after_first = [p.detach().clone() for p in params]
        # the same first step again: the seed-0 parameters and a fresh
        # optimizer (the state before any step)
        with torch.no_grad():
            for p, s in zip(params, snap):
                p.copy_(s)
        del snap
        optimizer = muon(model.named_parameters(), 0.02, state_dtype=torch.bfloat16,
                         fallback=lambda ps: AdamWLowmem(ps, 3e-4, state_dtype=torch.bfloat16))
        step = make_train_step(model, optimizer, lambda lg, b: cross_entropy_loss(lg, b["target"]))
        steps = [one(step)]
        repeat_bitwise = (np.float32(steps[0][0]).tobytes() == np.float32(first[0]).tobytes()
                          and all(torch.equal(p, a) for p, a in zip(params, after_first)))
        del after_first
        free_memory()
        # the peak of a step without the snapshots
        torch.cuda.reset_peak_memory_stats(dev)
        steps += [one(step) for _ in range(LEFTOVER_MUON_STEPS - 1)]
    finally:
        opt_mod.newton_schulz = real_ns
    launches = dict(kernels_mod.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [s[0] for s in steps]
    want = {**{k: 0 for k in kernels_mod.LAUNCHES}, "flash_fwd": L, "flash_bwd_dq": L,
            "flash_bwd_dkv": L, "fused_adamw": 1}
    labels = optimizer.labels
    checks = {
        "ns_card_vs_cpu": ns_err <= NS_CARD_ATOL,
        "first_step_repeats_bitwise": repeat_bitwise,
        "losses_finite": bool(np.isfinite(losses).all()),
        "loss_falls": losses[-1] < losses[0],
        "launches_per_step": all(s[3] == want for s in [first] + steps),
        "muon_leaves": sum(v == "muon" for v in labels.values()) == 7 * L,
        "ns_calls_per_step": all(s[4] == 7 * L for s in [first] + steps),
    }
    out = dict(model="llama 1.3B (bench rung 1.3b, opt muon)",
               optimizer="muon(0.02, fallback=adamw_lowmem(3e-4), state_dtype=bf16)",
               setup_s=setup_s, ns_card_vs_cpu_max_abs=ns_err, ns_card_vs_cpu_bound=NS_CARD_ATOL,
               ns_check_shape=list(NS_CARD_SHAPE), losses=losses, first_step_loss=first[0],
               step_ms=[first[1]] + [s[1] for s in steps],
               step_ms_median=statistics.median([s[1] for s in steps[1:]]),
               ns_ms=[first[2]] + [s[2] for s in steps],
               ns_ms_median=statistics.median([s[2] for s in steps[1:]]),
               ns_flops_per_step=muon_ns_flops(model, labels),
               muon_leaves=sum(v == "muon" for v in labels.values()),
               fallback_leaves=sum(v == "fallback" for v in labels.values()),
               launches=launches, launches_per_step=steps[-1][3],
               peak_memory_bytes_later_steps=peak, checks=checks)
    out["ns_tflops"] = out["ns_flops_per_step"] / (out["ns_ms_median"] / 1e3) / 1e12
    check(all(checks.values()), f"muon leg failed: {json.dumps(out)[:4000]}")
    del run, model, params, optimizer, step
    free_memory()
    return out


def muon_ns_flops(model, labels) -> float:
    """The FLOPs of one step's Newton-Schulz over the Muon leaves: five
    iterations of X Xᵀ (2m²n), A A (2m³) and B X (2m²n), m <= n."""
    total = 0.0
    for name, p in model.named_parameters():
        if labels[name] == "muon":
            m, n = sorted(p.shape)
            total += 5 * (4.0 * m * m * n + 2.0 * m ** 3)
    return total


def shakespeare_run(dev, token_file, capture=False) -> dict:
    """One run of leg (b): the char-level GPT from seed 0, its
    ``TokenDataLoader`` from the start, ``SHAKESPEARE_STEPS`` steps with
    step keys ``fold_in(key(1337), s)``; each step's loss, ms and dropout
    draws' device ms; with ``capture``, the first step's masks."""
    from vescale_tpu_torch import random as vr
    from vescale_tpu_torch.data import TokenDataLoader
    from vescale_tpu_torch.loss import vocab_parallel_cross_entropy
    from vescale_tpu_torch.models import GPT, GPTConfig, init_params
    from vescale_tpu_torch.models import nanogpt as tg
    from vescale_tpu_torch.parallel import AdamWLowmem
    from vescale_tpu_torch.train import make_eval_step, make_train_step

    cfg = GPTConfig(**SHAKESPEARE, dtype=torch.bfloat16, use_flash_attention=True)
    model = GPT(cfg, init_params(cfg, 0, device=dev, dtype=torch.float32), device=dev)
    opt = AdamWLowmem(model.parameters(), SHAKESPEARE_OPT["lr"], betas=SHAKESPEARE_OPT["betas"],
                      weight_decay=SHAKESPEARE_OPT["weight_decay"])
    loss_fn = lambda lg, b: vocab_parallel_cross_entropy(lg, b["target"])  # noqa: E731
    step = make_train_step(model, opt, loss_fn)
    loader = TokenDataLoader(token_file, SHAKESPEARE_BATCH, cfg.block_size, seed=0, device=dev)
    real, events, masks = tg._dropout_mask, [], []

    def spy(*a):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(*a)
        e1.record()
        events.append((e0, e1))
        if capture and not masks_done[0]:
            masks.append(out.clone())
        return out

    masks_done = [False]
    tg._dropout_mask = spy
    losses, step_ms, rng_ms, keys = [], [], [], []
    try:
        for s in range(SHAKESPEARE_STEPS):
            k = vr.fold_in(vr.key(1337), s)
            keys.append(k)
            events.clear()
            b = loader.next()
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(float(step(b, k)))
            step_ms.append((time.perf_counter() - t) * 1e3)
            rng_ms.append(sum(a.elapsed_time(e) for a, e in events))
            masks_done[0] = True
    finally:
        tg._dropout_mask = real
    ev = make_eval_step(model, loss_fn)
    vb = loader.next()
    eval_loss = [float(ev(vb)), float(ev(vb))]
    loader.close()
    params = [p.detach().clone() for p in model.parameters()]
    return dict(cfg=cfg, losses=losses, step_ms=step_ms, rng_ms=rng_ms, eval_loss=eval_loss,
                params=params, masks=masks, keys=keys)


def leftover_dropout(dev, kernels_mod) -> dict:
    """(b) nanoGPT's ``config/train_shakespeare_char.py`` at its published
    size (6 layers, 6 heads, width 384, block 256, batch 64, dropout 0.2,
    vocab 65, no bias; AdamW betas (0.9, 0.99), weight decay 0.1, lr 3e-4)
    in bf16 through the GPT rung's loss (K9/K10) and K8, on a
    numpy-seeded Zipf token file: two runs of ``SHAKESPEARE_STEPS`` steps
    with step keys, bitwise equal (losses, parameters, eval losses); the
    loss falls; flash attention never runs (dropout > 0 takes the dense
    branch); the first step's masks on the card equal the port's draws on
    the CPU (the embedding's whole; rows of layer 0's attention weights and
    of the last MLP's output through ``global_offset``); ``make_eval_step``
    twice, bitwise; step ms and the dropout draws' share of it."""
    from vescale_tpu_torch import random as vr
    from vescale_tpu_torch.bench import write_token_file

    tmp = tempfile.mkdtemp(prefix="vtt_shakespeare_")
    try:
        tok = write_token_file(os.path.join(tmp, "tokens.bin"), 1 << 20, SHAKESPEARE["vocab_size"])
        kernels_mod.reset_launches()
        a = shakespeare_run(dev, tok, capture=True)
        launches = dict(kernels_mod.LAUNCHES)
        b = shakespeare_run(dev, tok)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cfg, L = a["cfg"], a["cfg"].n_layer
    sites = ["Dropout_0"] + [f"h_{i}.{s}" for i in range(L)
                             for s in ("attn.Dropout_0", "attn.Dropout_1", "mlp.Dropout_0")]
    root = vr.fold_in(a["keys"][0], 0)  # the "dropout" stream of step 0
    B, T, E, H = SHAKESPEARE_BATCH, cfg.block_size, cfg.n_embd, cfg.n_head
    keep = 1.0 - cfg.dropout
    cpu = {
        "Dropout_0": vr.bernoulli(keep, (B, T, E), key=vr.make_rng(root, ("Dropout_0",)),
                                  device="cpu"),
        "h_0.attn.Dropout_0": vr.bernoulli(
            keep, (2, H, T, T), key=vr.make_rng(root, ("h_0", "attn", "Dropout_0")), device="cpu",
            global_offset=(0, 0, 0, 0), global_shape=(B, H, T, T)),
        f"h_{L - 1}.mlp.Dropout_0": vr.bernoulli(
            keep, (2, T, E), key=vr.make_rng(root, (f"h_{L - 1}", "mlp", "Dropout_0")),
            device="cpu", global_offset=(B - 2, 0, 0), global_shape=(B, T, E)),
    }
    card = dict(zip(sites, a["masks"]))
    masks_equal = {
        "Dropout_0": torch.equal(card["Dropout_0"].cpu(), cpu["Dropout_0"]),
        "h_0.attn.Dropout_0": torch.equal(card["h_0.attn.Dropout_0"][:2].cpu(),
                                          cpu["h_0.attn.Dropout_0"]),
        f"h_{L - 1}.mlp.Dropout_0": torch.equal(card[f"h_{L - 1}.mlp.Dropout_0"][B - 2:].cpu(),
                                                cpu[f"h_{L - 1}.mlp.Dropout_0"]),
    }
    keep_share = float(np.mean([m.float().mean().item() for m in a["masks"]]))
    timed = slice(1, None)
    step_med = statistics.median(a["step_ms"][timed])
    rng_med = statistics.median(a["rng_ms"][timed])
    S = SHAKESPEARE_STEPS
    want = {**{k: 0 for k in kernels_mod.LAUNCHES}, "fused_xent_fwd": S + 2,
            "fused_xent_bwd": S, "fused_adamw": S}
    checks = {
        "masks_card_equal_cpu": all(masks_equal.values()),
        "mask_count": len(a["masks"]) == len(sites),
        "keep_share": abs(keep_share - keep) < 0.005,
        "repeat_bitwise": (np.array(a["losses"], np.float64).tobytes()
                           == np.array(b["losses"], np.float64).tobytes()
                           and all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
                           and a["eval_loss"] == b["eval_loss"]),
        "eval_repeats": a["eval_loss"][0] == a["eval_loss"][1],
        "eval_finite": bool(np.isfinite(a["eval_loss"]).all()),
        "losses_finite": bool(np.isfinite(a["losses"]).all()),
        "loss_falls": a["losses"][-1] < a["losses"][1],  # after the warm-up step
        "launches": launches == want,
    }
    out = dict(config="nanoGPT config/train_shakespeare_char.py", batch=B, dtype="bf16",
               losses=a["losses"], eval_loss=a["eval_loss"][0], step_ms=a["step_ms"],
               step_ms_median=step_med, rng_ms=a["rng_ms"], rng_ms_median=rng_med,
               rng_share=rng_med / step_med, mask_sites=len(sites),
               mask_elements_per_step=int(sum(m.numel() for m in a["masks"])),
               keep_share=keep_share, masks_equal=masks_equal, launches=launches,
               tokens_per_s=B * T / (step_med / 1e3), checks=checks)
    check(all(checks.values()), f"dropout leg failed: {json.dumps(out)[:4000]}")
    del a, b
    free_memory()
    return out


def write_hf_shards(path: str, params, cfg, shards: int = 2) -> int:
    """The Llama tree ``params`` as an HF ``LlamaForCausalLM`` checkpoint in
    ``path``: HF names, weights (out, in) (the kernels transposed), in the
    tree's dtype, as ``shards`` safetensors files (an 8-byte little-endian
    header length, the JSON header, the raw bytes).  Returns the bytes
    written."""
    hf = {"model.embed_tokens.weight": params["embed_tokens"]["embedding"],
          "model.norm.weight": params["norm"]["weight"],
          "lm_head.weight": params["lm_head"]["kernel"].T}
    for i in range(cfg.num_hidden_layers):
        lp = params[f"layers_{i}"]
        for blk in ("self_attn", "mlp"):
            for proj, leaf in lp[blk].items():
                hf[f"model.layers.{i}.{blk}.{proj}.weight"] = leaf["kernel"].T
        for ln in ("input_layernorm", "post_attention_layernorm"):
            hf[f"model.layers.{i}.{ln}.weight"] = lp[ln]["weight"]
    names = sorted(hf)
    code = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32"}
    total = 0
    for s, part in enumerate(np.array_split(np.arange(len(names)), shards)):
        header, off, blobs = {}, 0, []
        for j in part:
            t = hf[names[j]].detach().contiguous().cpu()
            nbytes = t.numel() * t.element_size()
            header[names[j]] = {"dtype": code[t.dtype], "shape": list(t.shape),
                                "data_offsets": [off, off + nbytes]}
            blobs.append(t)
            off += nbytes
        header["__metadata__"] = {"format": "pt"}
        raw = json.dumps(header).encode()
        raw += b" " * (-len(raw) % 8)
        fname = os.path.join(path, f"model-{s + 1:05d}-of-{shards:05d}.safetensors")
        with open(fname, "wb") as f:
            f.write(len(raw).to_bytes(8, "little"))
            f.write(raw)
            for t in blobs:
                t.view(torch.uint8).numpy().tofile(f)
        total += os.path.getsize(fname)
    return total


def leftover_hf(dev, kernels_mod) -> dict:
    """(c) Serve from an HF directory: the 8B widths at ``HF_LAYERS``
    layers (seed 0, bf16) written by :func:`write_hf_shards` into a
    temporary directory, read back by ``load_hf_llama`` onto the card (fp32,
    cast to the model's bf16: every leaf bitwise the tree in memory), then
    ``HF_REQUESTS`` serve requests on an engine over the loaded weights and
    on one over the tree in memory: every check of the serve phase, greedy
    streams bitwise equal; the write's and the load's seconds and GB/s (the
    files just written: a warm read)."""
    from vescale_tpu_torch.models import LLAMA3_8B, init_params, load_hf_llama, tree_to
    from vescale_tpu_torch.models.convert import _flatten
    from vescale_tpu_torch.serve import KVCacheConfig, PagedKVCache, ServeEngine

    cfg = dataclasses.replace(LLAMA3_8B, num_hidden_layers=HF_LAYERS)
    params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    tmp = tempfile.mkdtemp(prefix="vtt_hf_")
    try:
        t0 = time.perf_counter()
        nbytes = write_hf_shards(tmp, params, cfg)
        write_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load_hf_llama(tmp, cfg, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        files = sorted(os.listdir(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loaded = tree_to(loaded, dtype=torch.bfloat16)
    free_memory()
    a, b = _flatten(loaded), _flatten(params)
    tree_bitwise = set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    kc = KVCacheConfig(layers=cfg.num_hidden_layers, kv_heads=cfg.num_key_value_heads,
                       head_dim=cfg.head_dim, num_slots=8, page_size=16, pages_per_slot=64,
                       dtype=torch.bfloat16)
    arrivals = serve_requests(cfg.vocab_size, n=HF_REQUESTS)
    runs, streams, launches = {}, {}, {k: 0 for k in kernels_mod.LAUNCHES}
    for name, tree in (("hf", loaded), ("memory", params)):
        eng = ServeEngine(cfg, tree, PagedKVCache(kc, device=dev), device=dev)
        eng.replay_greedy([1, 2, 3], 2)  # warm up and capture the decode graph
        runs[name], streams[name] = serve_run(dev, eng, arrivals, kernels_mod)
        for k, v in runs[name]["launches"].items():
            launches[k] += v
        del eng
        free_memory()
    checks = {"tree_bitwise": tree_bitwise, "hf_serve": all(runs["hf"]["checks"].values()),
              "memory_serve": all(runs["memory"]["checks"].values()),
              "streams_bitwise": streams["hf"] == streams["memory"], "files": len(files) == 2}
    out = dict(model=f"LLAMA3_8B widths at {HF_LAYERS} layers", files=files, bytes=nbytes,
               write_s=write_s, write_gb_per_s=nbytes / write_s / 1e9, load_s=load_s,
               load_gb_per_s=nbytes / load_s / 1e9, read="warm (the files just written)",
               requests=HF_REQUESTS, launches=launches,
               serve={k: {kk: v[kk] for kk in ("serve_s", "tokens_per_s", "decode_step_p50_ms",
                                                "prefills", "decode_steps", "launches")}
                      for k, v in runs.items()}, checks=checks)
    check(all(checks.values()), f"hf leg failed: {json.dumps(out)[:4000]}")
    del loaded, params
    free_memory()
    return out


def run_train_leftovers(dev, card, kernels_mod) -> dict:
    """``train_leftovers``: (a) Muon on the 1.3B, (b) dropout on nanoGPT's
    shakespeare config, (c) serving from an HF directory, each leg printed
    as its own line (``train_leftovers.<leg>``) when it ends; returns each
    leg's seconds and the launches of the three legs summed."""
    out = {"card": card, "seconds_by_leg": {}}
    launches = {k: 0 for k in kernels_mod.LAUNCHES}
    for name, fn in (("muon", leftover_muon), ("dropout", leftover_dropout), ("hf", leftover_hf)):
        t = time.perf_counter()
        leg = fn(dev, kernels_mod)
        out["seconds_by_leg"][name] = time.perf_counter() - t
        log(f"train_leftovers.{name}", seconds=out["seconds_by_leg"][name], card=card, **leg)
        for k, v in leg["launches"].items():
            launches[k] += v
    out["launches"] = launches
    return out


def leftovers_only(dev, card, kernels_mod) -> int:
    """``--leftovers``: the train_leftovers phase alone."""
    t = time.perf_counter()
    log("train_leftovers", seconds=None, **run_train_leftovers(dev, card, kernels_mod))
    log("done", seconds=time.perf_counter() - t)
    print(card, flush=True)
    return 0


def longctx_only(dev, card, kernels_mod) -> int:
    """``--longctx``: the longctx phase alone."""
    t = time.perf_counter()
    lc = run_longctx(dev, card, kernels_mod)
    log("longctx", seconds=time.perf_counter() - t, **longctx_summary(lc))
    print(card, flush=True)
    return 0


def fp8_only(dev, card, kernels_mod) -> int:
    """``--fp8``: the fp8 phase alone."""
    t = time.perf_counter()
    f8 = run_fp8(dev, card, kernels_mod)
    log("fp8", seconds=time.perf_counter() - t, **fp8_summary(f8))
    print(card, flush=True)
    return 0


def moe_only(dev, card, kernels_mod) -> int:
    """``--moe``: the new parity cases, then the moe phase."""
    t = time.perf_counter()
    rows = run_flash_parity(dev, ulps_dev, only=MOE_PARITY)
    bwd_rows, _ = run_flash_bwd_parity(dev, ulps_dev, only=MOE_PARITY)
    adamw_rows, adamw_t = run_adamw_parity(dev, only_moe=True)
    rows += bwd_rows + adamw_rows
    log("parity", seconds=time.perf_counter() - t, checks=rows, timings={"fused_adamw": adamw_t})
    t = time.perf_counter()
    moe = run_moe(dev, card, kernels_mod)
    log("moe", seconds=time.perf_counter() - t, **moe_summary(moe))
    check(all(r["ok"] for r in rows), "kernel parity failed: " + json.dumps(
        [r for r in rows if not r["ok"]]))
    print(card, flush=True)
    return 0


def pp_only(dev, card, kernels_mod) -> int:
    """``--pp``: the gpt2 phase, then the pipeline phase."""
    gpt2 = run_train_gpt2(dev, kernels_mod)
    log("gpt2", losses=gpt2["losses"], step_ms_median=gpt2["step_ms_median"])
    t = time.perf_counter()
    pipeline = run_pipeline(dev, card, kernels_mod)
    log("pipeline", seconds=time.perf_counter() - t, **pipeline)
    print(card, flush=True)
    return 0


def telemetry_only(dev, card, kernels_mod) -> int:
    """``--telemetry``: the serve phase's engine and the gpt2 phase (the
    prerequisites), then the telemetry phase's legs."""
    t = time.perf_counter()
    serve, eng, eager, cfg, serve_streams = run_serve_8b(dev, kernels_mod)
    log("serve", seconds=time.perf_counter() - t, decode_step_p50_ms=serve["graph"][
        "decode_step_p50_ms"], checks=serve["checks"])
    t = time.perf_counter()
    tel_serve = run_telemetry_serve(dev, eng, kernels_mod, serve_streams)
    serve_s = time.perf_counter() - t
    del eng, eager
    free_memory()
    t = time.perf_counter()
    gpt2 = run_train_gpt2(dev, kernels_mod)
    log("gpt2", seconds=time.perf_counter() - t, losses=gpt2["losses"],
        step_ms_median=gpt2["step_ms_median"])
    t = time.perf_counter()
    tel_gpt2 = run_telemetry_gpt2(dev, kernels_mod, gpt2)
    log("telemetry", seconds=serve_s + time.perf_counter() - t, card=card, serve=tel_serve,
        gpt2=tel_gpt2)
    print(card, flush=True)
    return 0


def tp_launches(phase: dict, name: str) -> int:
    """A kernel's launches over every rank of a TP phase (``tp_train``:
    both rungs, every step)."""
    runs = [r for v in phase.values() if isinstance(v, dict) for r in v["ranks"]] \
        if "ranks" not in phase else phase["ranks"]
    return int(sum(r["launches_total"].get(name, 0) for r in runs))


def tp_only(dev, card, kernels_mod) -> int:
    """``--tp``: the serve phase (``tp_serve`` is held to its streams),
    then ``tp_train`` and ``tp_serve``."""
    serve, eng, _, _, serve_streams = run_serve_8b(dev, kernels_mod)
    log("serve", **{k: v for k, v in serve.items() if k in ("checks", "launches")})
    forced = forced_reference(eng, serve_streams)
    del eng
    free_memory()
    t = time.perf_counter()
    tp_train, _ = run_tp_train(dev, card)
    log("tp_train", seconds=time.perf_counter() - t, **tp_train)
    t = time.perf_counter()
    tp_serve = run_tp_serve(dev, serve_streams, forced, card)
    log("tp_serve", seconds=time.perf_counter() - t, **tp_serve)
    print(card, flush=True)
    return 0


def plan_only(dev, card, kernels_mod) -> int:
    """``--plan``: tp_train's 1.3B rung with the plan legs (a)-(d), then
    the plan phase's (e)."""
    t = time.perf_counter()
    tp_train, legs = run_tp_train(dev, card, rungs=("1.3b",))
    log("tp_train", seconds=time.perf_counter() - t, **tp_train)
    t = time.perf_counter()
    plan = run_plan_phase(dev, card, legs)
    log("plan", seconds=time.perf_counter() - t, **plan)
    print(card, flush=True)
    return 0


def dp_only(dev, card, kernels_mod) -> int:
    """``--dp``: ``dp_train`` alone (it runs its own single-card
    references)."""
    t = time.perf_counter()
    dp_train = run_dp_train(dev, card)
    log("dp_train", seconds=time.perf_counter() - t, **dp_train)
    print(card, flush=True)
    return 0


# ----------------------------------------------------------------- examples
# the phase's legs (PERF.md §4): OpenLLaMA-3B whole; Llama-2-7B's widths cut
# from 32 to EX_LLAMA2_LAYERS layers (fp32 AdamW state for 6.7 B parameters
# would need ~108 GB); the other examples at their programs' defaults
EX_LLAMA2_LAYERS = 4
EX_OPEN_LLAMA = dict(batch=2, seq=2048, warmup=2, steps=5)
# the timed shapes: (B, T, H, KV, D) of OpenLLaMA-3B's step (its parity case
# takes one of the two rows) and of the fp8 example's
EX_TIMED = {"hd100_open_llama": (2, 2048, 32, 32, 100), "hd16_fp8": (8, 64, 8, 4, 16)}


def ex_head_dim_timing(dev) -> dict:
    """K1, K3 and K4 at OpenLLaMA-3B's (2, 2048, 32, 100) and the fp8
    example's (8, 64, 8, 4, 16) in bf16, K7 at OpenLLaMA-3B's decode heads
    (hd 100): ms, the plain version's ms, the library call's, and two bounds:
    ``bound_ms`` over the function's own work at D (``meta`` tensors) and
    ``bound_ms_at_kernel_width`` over the padded work the kernels do."""
    import torch.nn.functional as F

    from vescale_tpu_torch.kernels.flash_attention import (
        _delta, flash_bwd_dkv, flash_bwd_dkv_cost, flash_bwd_dq, flash_bwd_dq_cost,
        flash_bwd_reference, flash_fwd, flash_fwd_cost, flash_fwd_reference)
    from vescale_tpu_torch.kernels import kernel_head_dim
    from vescale_tpu_torch.kernels.paged_attention import (paged_decode, paged_decode_cost,
                                                           paged_decode_reference)

    out = {}
    meta = lambda *ts: [t.to("meta") for t in ts]  # noqa: E731
    causal, dtype = True, torch.bfloat16
    for key, (B, T, H, KV, D) in EX_TIMED.items():
        q, k, v, o, do, lse, args = flash_bwd_inputs(dev, B, T, H, KV, D, causal, dtype)
        lse2, delta = lse.reshape(B * H, T), _delta(o, do)
        rows = {}
        fwd_ms = cuda_ms(lambda: flash_fwd(q, k, v, **args))
        dq_ms = cuda_ms(lambda: flash_bwd_dq(q, k, v, do, lse2, delta, **args), iters=10)
        dkv_ms = cuda_ms(lambda: flash_bwd_dkv(q, k, v, do, lse2, delta, **args), iters=10)
        fwd_plain = cuda_ms(lambda: flash_fwd_reference(q, k, v, pd_dtype=torch.bfloat16, **args),
                            iters=3, warmup=1)
        bwd_plain = cuda_ms(lambda: flash_bwd_reference(q, k, v, o, do, lse, **args), iters=3,
                            warmup=1)
        rep = H // KV
        q4 = q.reshape(B, H, T, D).detach().requires_grad_()
        k4 = k.reshape(B, KV, T, D).repeat_interleave(rep, dim=1).detach().requires_grad_()
        v4 = v.reshape(B, KV, T, D).repeat_interleave(rep, dim=1).detach().requires_grad_()
        fwd_lib = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal))
        out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
        bwd_lib = cuda_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), do.reshape(B, H, T, D),
                                                      retain_graph=True))
        for name, ms, plain, lib, cost, targs in (
                ("flash_fwd", fwd_ms, fwd_plain, fwd_lib, flash_fwd_cost, (q, k, v)),
                ("flash_bwd_dq", dq_ms, bwd_plain, bwd_lib, flash_bwd_dq_cost,
                 (q, k, v, do, lse2, delta)),
                ("flash_bwd_dkv", dkv_ms, bwd_plain, bwd_lib, flash_bwd_dkv_cost,
                 (q, k, v, do, lse2, delta))):
            flops, nbytes = cost(*meta(*targs), **args)
            kflops, kbytes = cost(*targs, **args)
            row = dict(ms=ms, plain_ms=plain, library_ms=lib, **bound(nbytes, flops, dtype))
            row["bound_ms_at_kernel_width"] = bound(kbytes, kflops, dtype)["bound_ms"]
            row["share_of_bound"] = row["bound_ms"] / ms
            rows[name] = row
        rows["shape"] = dict(B=B, T=T, H=H, KV=KV, D=D, dtype=str(dtype),
                             kernel_width=kernel_head_dim("chip_smoke", D))
        rows["library_note"] = ("SDPA forward / backward (dq, dk, dv together), GQA expanded; "
                                "the plain ms of dq and dkv is the plain backward's, all three")
        out[key] = rows
        del q, k, v, o, do, lse, q4, k4, v4, out4
        free_memory()
    geo = paged_head_dim_geometries()["hd100 open_llama"]
    q, kp, vp, table, lengths = paged_inputs(dev, torch.bfloat16, torch.bfloat16, **geo)
    scale = 1.0 / geo["hd"] ** 0.5
    ms = cuda_ms(lambda: paged_decode(q, kp, vp, table, lengths, scale=scale), iters=48)
    plain = cuda_ms(lambda: paged_decode_reference(q, kp, vp, table, lengths, scale=scale),
                    iters=5, warmup=1)
    flops, nbytes = paged_decode_cost(*meta(q, kp, vp, table), lengths)
    kflops, kbytes = paged_decode_cost(q, kp, vp, table, lengths)
    out["paged_hd100"] = dict(ms=ms, plain_ms=plain, library_ms=None, **bound(nbytes, flops,
                                                                              kp.dtype),
                              bound_ms_at_kernel_width=bound(kbytes, kflops, kp.dtype)["bound_ms"],
                              shape=dict(geo, tokens=int(lengths.sum()), dtype="bf16"))
    del q, kp, vp, table, lengths
    free_memory()
    return out


def ex_refusals(dev, kernels_mod) -> dict:
    """A head dim outside the contract raises on the card before any
    launch: the flash forward at D = 98 and 132, the paged decode at 98."""
    from vescale_tpu_torch.kernels.flash_attention import flash_fwd
    from vescale_tpu_torch.kernels.paged_attention import paged_decode

    kernels_mod.reset_launches()
    raised = {}
    for D in (98, 132):
        q = torch.zeros(4, 16, D, device=dev, dtype=torch.bfloat16)
        try:
            flash_fwd(q, q, q, scale=0.1, causal=True, H=4, KV=4)
            raised[f"flash_fwd D={D}"] = False
        except ValueError:
            raised[f"flash_fwd D={D}"] = True
    pool = torch.zeros(3, 4, 2, 98, device=dev, dtype=torch.bfloat16)
    try:
        paged_decode(torch.zeros(2, 4, 98, device=dev, dtype=torch.bfloat16), pool, pool,
                     torch.ones(2, 1, dtype=torch.int32, device=dev),
                     torch.ones(2, dtype=torch.int32, device=dev), scale=0.1)
        raised["paged_decode hd=98"] = False
    except ValueError:
        raised["paged_decode hd=98"] = True
    torch.cuda.synchronize()
    launched = sum(kernels_mod.LAUNCHES.values())
    return dict(raised=raised, launched=launched, ok=all(raised.values()) and launched == 0)


def ex_leg(kernels_mod, fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after; (its result, the counts, seconds)."""
    free_memory()
    kernels_mod.reset_launches()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, dict(kernels_mod.LAUNCHES), time.perf_counter() - t


def ex_open_llama(dev, kernels_mod) -> dict:
    """(a) OpenLLaMA-3B at full width and depth through the example's
    ``run``: bf16, remat, one rank, B=2, T=2048, 2 warm-up and 5 timed
    steps; K1, K3/K4 and K8 launched; the first loss within 1.0 of
    ln(vocab) (random weights predict near uniformly)."""
    from vescale_tpu_torch.examples import open_llama_4d_benchmark as ol

    res, launches, secs = ex_leg(kernels_mod, lambda: ol.run(
        bf16=True, remat=True, device=dev, **EX_OPEN_LLAMA))
    first_ok = abs(res["losses"][0] - math.log(32000)) <= 1.0
    need = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_adamw")
    ok = (first_ok and all(np.isfinite(res["losses"])) and all(launches[k] > 0 for k in need))
    return dict(res, launches=launches, run_s=secs, first_loss_near_ln_vocab=first_ok, ok=ok)


def ex_llama2(dev, kernels_mod) -> dict:
    """(b) Llama-2-7B's widths at ``EX_LLAMA2_LAYERS`` of 32 layers: B=4,
    T=256, 10 steps through ``DistributedOptimizer`` with the clip, then
    ``--save`` (to ``mem://``, this process's memory, for the phase's time)
    and a restore bitwise the live state."""
    from vescale_tpu_torch import checkpoint
    from vescale_tpu_torch.examples import llama2_4d_finetune as l2

    path = "mem://examples_llama2"
    try:
        res, launches, secs = ex_leg(kernels_mod, lambda: l2.run(
            dp=1, tp=1, steps=10, batch=4, seq=256, layers=EX_LLAMA2_LAYERS, save=path,
            check_restore=True, device=dev))
    finally:
        checkpoint._MEM_STORES.pop(path, None)
    ok = bool(res.get("restore_bitwise")) and all(np.isfinite(res["losses"]))
    return dict(res, launches=launches, run_s=secs, layers=EX_LLAMA2_LAYERS, ok=ok)


def ex_nanogpt(dev, kernels_mod, tmp: str) -> dict:
    """(c) nanoGPT at ``train.py``'s defaults on one rank over the
    char-level corpus, with and without ``--zero2``: 20 steps each, one
    ``train-step`` span a step; the two optimizers' losses side by side."""
    from vescale_tpu_torch.examples import _common
    from vescale_tpu_torch.examples import nanogpt_4d_finetune as ng

    data = os.path.join(tmp, "corpus_char.bin")
    _common.build_corpus_bin(data)
    out, ok = {}, True
    for name, zero2 in (("chain", False), ("zero2", True)):
        res, launches, secs = ex_leg(kernels_mod, lambda: ng.run(
            dp=1, tp=1, data=data, zero2=zero2, device=dev))
        out[name] = dict(res, launches=launches, run_s=secs)
        ok &= (res["train_step_spans"] == len(res["losses"]) == 20
               and all(np.isfinite(res["losses"])) and res["losses"][-1] < res["losses"][0])
    a, b = out["chain"]["losses"], out["zero2"]["losses"]
    out["max_rel_chain_vs_zero2"] = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    out["launches"] = {k: out["chain"]["launches"][k] + out["zero2"]["launches"][k]
                       for k in kernels_mod.LAUNCHES}
    return dict(out, ok=ok)


def ex_mixtral(dev, kernels_mod) -> dict:
    """(d) Mixtral at ``mixtral_train.py``'s defaults on one rank: one step,
    then 10 timed; the loss includes the router aux losses."""
    from vescale_tpu_torch.examples import mixtral_4d_benchmark as mx

    res, launches, secs = ex_leg(kernels_mod, lambda: mx.run(dp=1, ep=1, device=dev))
    ok = all(np.isfinite(res["losses"])) and res["losses"][-1] < res["losses"][0]
    return dict(res, launches=launches, run_s=secs, ok=ok)


def ex_crash_child(tmp: str) -> dict:
    """Start leg (e)'s child: ``resilient_train`` on the card, 20 steps,
    saves every 5, exit 137 after step 12.  It starts with the phase, so
    its start-up (imports, CUDA) overlaps the legs before (e); its steps, a
    4-layer GPT, are small beside theirs."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("VESCALE_")}
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    crashed = os.path.join(tmp, "resil_crash")
    log_path = os.path.join(tmp, "resil_child.log")
    with open(log_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "vescale_tpu_torch.examples.resilient_train", "--dp", "1",
             "--tp", "1", "--steps", "20", "--save-every", "5", "--crash-at", "12",
             "--ckpt-dir", crashed], cwd=here, env=env, stdout=out, stderr=subprocess.STDOUT)
    return dict(proc=proc, t0=time.perf_counter(), dir=crashed, log=log_path)


def ex_resilient(dev, kernels_mod, tmp: str, child: dict) -> dict:
    """(e) ``resilient_train``: the child (``ex_crash_child``) exits 137
    after step 12 of 20; the resumed run in this process and an
    uninterrupted one: losses of the resumed steps and the final
    parameters' digest bitwise."""
    from vescale_tpu_torch.examples import resilient_train as rt

    try:
        rc = child["proc"].wait(timeout=300)
    finally:
        if child["proc"].poll() is None:
            child["proc"].kill()
            child["proc"].wait()
    child_s = time.perf_counter() - child["t0"]
    with open(child["log"]) as f:
        tail = f.read()[-400:]
    quiet = lambda *_: None  # noqa: E731
    resumed, launches, secs = ex_leg(kernels_mod, lambda: rt.run(
        dp=1, tp=1, steps=20, save_every=5, ckpt_dir=child["dir"], device=dev, log=quiet))
    whole, _, whole_s = ex_leg(kernels_mod, lambda: rt.run(
        dp=1, tp=1, steps=20, save_every=5, ckpt_dir=os.path.join(tmp, "resil_whole"),
        device=dev, log=quiet))
    same = all(loss == whole["losses"].get(i) for i, loss in resumed["losses"].items())
    # the newest committed step when the child died: fire-and-forget saves
    # still in flight are lost, as a kill loses them
    ok = (rc == rt.CRASH_EXIT_CODE and 1 <= resumed["start"] <= 11 and same
          and resumed["digest"] == whole["digest"])
    return dict(child_rc=rc, child_s=child_s, child_tail=tail,
                resumed_start=resumed["start"], resumed_losses=resumed["losses"],
                whole_losses=whole["losses"], scales=whole["scales"], losses_bitwise=same,
                digest_equal=resumed["digest"] == whole["digest"], launches=launches,
                run_s=secs + whole_s, ok=ok)


def ex_autosplit(dev, kernels_mod) -> dict:
    """(f) the tangled model cut at 3 stages under zero bubble: 20 steps,
    losses within 1e-5 of the unsplit model's."""
    from vescale_tpu_torch.examples import autosplit_pipeline as ap

    res, launches, secs = ex_leg(kernels_mod, lambda: ap.run(
        stages=3, zero_bubble=True, steps=20, device=dev, unsplit=True))
    rel = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], res["unsplit_losses"]))
    return dict(res, groups=[len(g) for g in res["groups"]], max_rel_vs_unsplit=rel,
                bound=1e-5, launches=launches, run_s=secs, ok=rel <= 1e-5)


def ex_fp8(dev, kernels_mod) -> dict:
    """(g) ``fp8_train`` on the card: bf16 compute, flash attention on (head
    dim 16), the products on the fp8 tensor cores; 10 steps; the loss scale
    and the amax histories advance."""
    from vescale_tpu_torch.examples import fp8_train as f8

    res, launches, secs = ex_leg(kernels_mod, lambda: f8.run(steps=10, device=dev))
    heads = [h[0] for h in res["amax_heads"]]
    ok = (all(np.isfinite(res["losses"])) and all(s > 0 for s in res["scales"])
          and all(h > 0 for h in heads) and len(set(heads)) > 1 and launches["flash_fwd"] > 0)
    return dict(res, launches=launches, run_s=secs, ok=ok)


def run_examples(dev, card, kernels_mod, parity: bool = False) -> dict:
    """``examples``: the port's example programs on the card (legs (a)-(g),
    each printed as ``examples.<leg>`` when it ends), the head-dim times and
    bounds, the refusal of a head dim outside the contract and, with
    ``parity`` (``--examples``), the head-dim parity cases."""
    ulps = ulps_dev
    out = {"card": card, "seconds_by_leg": {}}
    t = time.perf_counter()
    rows = []
    if parity:
        rows += run_flash_parity(dev, ulps, only=HEAD_DIM_PARITY)
        rows += run_flash_bwd_parity(dev, ulps, only=HEAD_DIM_PARITY)[0]
        rows += run_paged_parity(dev, ulps, only=tuple(paged_head_dim_geometries()))
    refusals = ex_refusals(dev, kernels_mod)
    timing = ex_head_dim_timing(dev)
    out["seconds_by_leg"]["head_dims"] = time.perf_counter() - t
    log("examples.head_dims", seconds=out["seconds_by_leg"]["head_dims"], card=card,
        checks=rows, refusals=refusals, timings=timing)
    out["head_dims_ok"] = all(r["ok"] for r in rows) and refusals["ok"]
    launches = {k: 0 for k in kernels_mod.LAUNCHES}
    tmp = tempfile.mkdtemp(prefix="vtt_examples_")
    child = ex_crash_child(tmp)
    try:
        for name, fn in (("open_llama", ex_open_llama), ("llama2", ex_llama2),
                         ("nanogpt", lambda d, k: ex_nanogpt(d, k, tmp)), ("mixtral", ex_mixtral),
                         ("autosplit", ex_autosplit), ("fp8", ex_fp8),
                         ("resilient", lambda d, k: ex_resilient(d, k, tmp, child))):
            t = time.perf_counter()
            leg = fn(dev, kernels_mod)
            out["seconds_by_leg"][name] = time.perf_counter() - t
            log(f"examples.{name}", seconds=out["seconds_by_leg"][name], card=card, **leg)
            out[f"{name}_ok"] = leg["ok"]
            for k, v in leg["launches"].items():
                launches[k] += v
    finally:
        if child["proc"].poll() is None:
            child["proc"].kill()
            child["proc"].wait()
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = launches
    return out


def examples_check(ex: dict) -> None:
    bad = [k for k, v in ex.items() if k.endswith("_ok") and not v]
    check(not bad, f"examples phase failed: {bad}")


def examples_only(dev, card, kernels_mod) -> int:
    """``--examples``: the head-dim parity cases and the examples phase."""
    t = time.perf_counter()
    ex = run_examples(dev, card, kernels_mod, parity=True)
    log("examples", seconds=time.perf_counter() - t, **ex)
    examples_check(ex)
    print(card, flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="device, build and kernel parity only")
    ap.add_argument("--tp", action="store_true",
                    help="device, build, and the serve and TP phases only")
    ap.add_argument("--dp", action="store_true", help="device, build and the DP phase only")
    ap.add_argument("--resil", action="store_true",
                    help="device, build, and the train_resilient phase only")
    ap.add_argument("--telemetry", action="store_true",
                    help="device, build, the serve and gpt2 phases, and the telemetry phase only")
    ap.add_argument("--pp", action="store_true",
                    help="device, build, the gpt2 phase and the pipeline phase only")
    ap.add_argument("--moe", action="store_true",
                    help="device, build, the moe shapes' parity and the moe phase only")
    ap.add_argument("--longctx", action="store_true",
                    help="device, build and the longctx phase only")
    ap.add_argument("--fp8", action="store_true", help="device, build and the fp8 phase only")
    ap.add_argument("--plan", action="store_true",
                    help="device, build, tp_train's 1.3B rung and the plan phase only")
    ap.add_argument("--gloo-probe", action="store_true",
                    help="which collectives gloo carries on CUDA tensors, then exit")
    ap.add_argument("--fleet", action="store_true", help="device, build and the fleet phase only")
    ap.add_argument("--nd", action="store_true",
                    help="device, build and the nd phase (n-D composition) only")
    ap.add_argument("--leftovers", action="store_true",
                    help="device, build and the train_leftovers phase only")
    ap.add_argument("--examples", action="store_true",
                    help="device, build, the head-dim parity and the examples phase only")
    ap.add_argument("--replica-child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--router-child", help=argparse.SUPPRESS)
    ap.add_argument("--tp-child", help=argparse.SUPPRESS)
    ap.add_argument("--gloo-probe-child", nargs=3, help=argparse.SUPPRESS)
    opts = ap.parse_args()

    if opts.router_child:  # the fleet phase's HA leader: host code, no CUDA
        return router_child(opts.router_child)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if opts.replica_child:
        return replica_child()
    if opts.tp_child:
        return tp_child(opts.tp_child)
    if opts.gloo_probe_child:
        op, rank, port = opts.gloo_probe_child
        return gloo_probe_child(op, int(rank), int(port))
    if opts.gloo_probe:
        log("gloo_probe", card=card_line(), torch=torch.__version__, ops=run_gloo_probe())
        return 0
    from vescale_tpu_torch import kernels as kernels_mod
    from vescale_tpu_torch.kernels import _build, ulps_at_scale

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    log("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        capability=list(torch.cuda.get_device_capability(0)), card=card, torch=torch.__version__,
        cuda=torch.version.cuda)
    check(kernels_mod.on_hopper(), "the kernels need a Hopper card (sm_90a)")

    t = time.perf_counter()
    nvcc_s = _build.build()
    ptxas = {name: [ln.strip() for ln in (_build.BUILD_DIR / f"{name}.log").read_text().splitlines()
                    if "registers" in ln or "spill" in ln or "Function properties" in ln]
             for name in nvcc_s}
    hgmma = sass_wgmma(_build)
    paged = paged_build_report(_build)
    log("build", seconds=time.perf_counter() - t, nvcc_seconds=nvcc_s, ptxas=ptxas,
        flash_sass_wgmma=hgmma, paged_decode=paged)
    check(all((n > 0) == name.startswith("tc::") for name, n in hgmma.items()),
          f"HGMMA in every tensor-core flash kernel and in no other: {hgmma}")
    check(paged["kernels"] and not paged["spills"],
          f"paged_decode kernels built without spills: {paged}")

    if opts.resil:
        t = time.perf_counter()
        log("train_resilient", seconds=None, **run_train_resilient(dev, card, kernels_mod))
        log("done", seconds=time.perf_counter() - t)
        print(card, flush=True)
        return 0
    if opts.telemetry:
        return telemetry_only(dev, card, kernels_mod)
    if opts.tp:
        return tp_only(dev, card, kernels_mod)
    if opts.dp:
        return dp_only(dev, card, kernels_mod)
    if opts.pp:
        return pp_only(dev, card, kernels_mod)
    if opts.moe:
        return moe_only(dev, card, kernels_mod)
    if opts.longctx:
        return longctx_only(dev, card, kernels_mod)
    if opts.fp8:
        return fp8_only(dev, card, kernels_mod)
    if opts.plan:
        return plan_only(dev, card, kernels_mod)
    if opts.leftovers:
        return leftovers_only(dev, card, kernels_mod)
    if opts.nd:
        return nd_only(dev, card, kernels_mod)
    if opts.examples:
        return examples_only(dev, card, kernels_mod)
    if opts.fleet:
        t = time.perf_counter()
        fleet = run_fleet_phase(dev, kernels_mod, card)
        log("fleet", seconds=time.perf_counter() - t, **fleet)
        print(card, flush=True)
        return 0

    t = time.perf_counter()
    parts = {}  # the seconds of each part of the phase

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t0
        return out

    flash_rows = timed("flash_fwd", run_flash_parity, dev, ulps_dev)
    paged_rows = timed("paged_decode", run_paged_parity, dev, ulps_dev)
    timings = {"flash_fwd": timed("flash_fwd_timing", flash_timing, dev, flash_rows),
               "paged_decode": timed("paged_decode_timing", paged_timing, dev, paged_rows)}
    bwd_rows, bwd_timings = timed("flash_bwd", run_flash_bwd_parity, dev, ulps_dev)
    adamw_rows, timings["fused_adamw"] = timed("fused_adamw", run_adamw_parity, dev)
    xent_rows, xent_timings = timed("fused_xent", run_xent_parity, dev)
    timings.update(bwd_timings)
    timings.update(xent_timings)
    rows = flash_rows + paged_rows + bwd_rows + adamw_rows + xent_rows
    log("parity", seconds=time.perf_counter() - t, seconds_by_part=parts, checks=rows,
        timings=timings)
    # a parity failure fails the run at its end, after the later phases
    # have reported too
    bad_parity = [r for r in rows if not r["ok"]]
    if opts.quick:
        check(not bad_parity, "kernel parity failed: " + json.dumps(bad_parity))
        print(card, flush=True)
        return 0

    t = time.perf_counter()
    engine = run_small_engine(dev, ulps_at_scale)
    log("engine", seconds=time.perf_counter() - t, **engine)
    t = time.perf_counter()
    engine_spec = run_engine_spec(dev)
    log("engine_spec", seconds=time.perf_counter() - t, **engine_spec)
    # serve before train: the host-bound serve runs are timed before any
    # profiler session of this process has run
    t = time.perf_counter()
    serve, eng, eager, cfg, serve_streams = run_serve_8b(dev, kernels_mod)
    log("serve", seconds=time.perf_counter() - t, **serve)
    t = time.perf_counter()
    spec_prefix = run_spec_prefix(dev, eng, kernels_mod)
    log("spec_prefix", seconds=time.perf_counter() - t, **spec_prefix)
    t = time.perf_counter()
    resilient = run_serve_resilient_phase(dev, eng, kernels_mod, serve, serve_streams)
    log("serve_resilient", seconds=time.perf_counter() - t, card=card, **resilient)
    t = time.perf_counter()
    spmd = run_spmd_phase(dev, eng, kernels_mod, serve_streams, card)
    log("spmd", seconds=time.perf_counter() - t, card=card, **spmd)
    t = time.perf_counter()
    ckpt = run_checkpoint_phase(dev, eng, eager, kernels_mod, serve_streams, card)
    log("checkpoint", seconds=time.perf_counter() - t, card=card, **ckpt)
    t = time.perf_counter()
    prof = {"graph": run_profile(eng, cfg, serve["graph"]["serve_s"])}
    log("profile", seconds=time.perf_counter() - t, **prof)
    t = time.perf_counter()
    tel_serve = run_telemetry_serve(dev, eng, kernels_mod, serve_streams)
    tel_serve_s = time.perf_counter() - t
    forced = forced_reference(eng, serve_streams)
    del eng, eager
    free_memory()
    t = time.perf_counter()
    fleet = run_fleet_phase(dev, kernels_mod, card)
    log("fleet", seconds=time.perf_counter() - t, **fleet)
    t = time.perf_counter()
    train_small = run_train_small(dev)
    log("train_small", seconds=time.perf_counter() - t, **train_small)
    t = time.perf_counter()
    train = run_train_13b(dev, kernels_mod)
    log("train", seconds=time.perf_counter() - t, **train)
    t = time.perf_counter()
    gpt_small = run_gpt_small(dev)
    log("gpt_small", seconds=time.perf_counter() - t, **gpt_small)
    t = time.perf_counter()
    gpt2 = run_train_gpt2(dev, kernels_mod)
    log("gpt2", seconds=time.perf_counter() - t, **gpt2)
    t = time.perf_counter()
    tel_gpt2 = run_telemetry_gpt2(dev, kernels_mod, gpt2)
    log("telemetry", seconds=tel_serve_s + time.perf_counter() - t, card=card, serve=tel_serve,
        gpt2=tel_gpt2)
    t = time.perf_counter()
    resilient_train = run_train_resilient(dev, card, kernels_mod)
    log("train_resilient", seconds=time.perf_counter() - t, **resilient_train)
    t = time.perf_counter()
    tp_train, plan_legs = run_tp_train(dev, card)
    log("tp_train", seconds=time.perf_counter() - t, **tp_train)
    t = time.perf_counter()
    plan = run_plan_phase(dev, card, plan_legs)
    log("plan", seconds=time.perf_counter() - t, **plan)
    t = time.perf_counter()
    tp_serve = run_tp_serve(dev, serve_streams, forced, card)
    log("tp_serve", seconds=time.perf_counter() - t, **tp_serve)
    t = time.perf_counter()
    dp_train = run_dp_train(dev, card)
    log("dp_train", seconds=time.perf_counter() - t, **dp_train)
    t = time.perf_counter()
    pipeline = run_pipeline(dev, card, kernels_mod, train)
    log("pipeline", seconds=time.perf_counter() - t, **pipeline)
    t = time.perf_counter()
    moe = run_moe(dev, card, kernels_mod)
    log("moe", seconds=time.perf_counter() - t, **moe_summary(moe))
    t = time.perf_counter()
    nd = run_nd(dev, card, kernels_mod)
    log("nd", seconds=time.perf_counter() - t, **nd_summary(nd))
    t = time.perf_counter()
    longctx = run_longctx(dev, card, kernels_mod)
    log("longctx", seconds=time.perf_counter() - t, **longctx_summary(longctx))
    t = time.perf_counter()
    fp8 = run_fp8(dev, card, kernels_mod)
    log("fp8", seconds=time.perf_counter() - t, **fp8_summary(fp8))
    t = time.perf_counter()
    leftovers = run_train_leftovers(dev, card, kernels_mod)
    log("train_leftovers", seconds=time.perf_counter() - t, **leftovers)
    t = time.perf_counter()
    examples = run_examples(dev, card, kernels_mod)
    log("examples", seconds=time.perf_counter() - t, **examples)
    log("done", seconds=time.perf_counter() - t_all)
    check(not bad_parity, "kernel parity failed: " + json.dumps(bad_parity))
    examples_check(examples)

    csrc = "vescale_tpu_torch/kernels/csrc/"
    sources = {"flash_fwd": (csrc + "flash_fwd.cu", "vescale_tpu/kernels/flash_attention.py:43"),
               "paged_decode": (csrc + "paged_decode.cuh", "vescale_tpu/kernels/paged_attention.py:53"),
               "flash_bwd_dq": (csrc + "flash_bwd.cu", "vescale_tpu/kernels/flash_attention.py:202"),
               "flash_bwd_dkv": (csrc + "flash_bwd.cu", "vescale_tpu/kernels/flash_attention.py:233"),
               "fused_adamw": (csrc + "fused_adamw.cu", "vescale_tpu/kernels/fused_adamw.py:54"),
               "fused_xent_fwd": (csrc + "cross_entropy.cu",
                                  "vescale_tpu/kernels/cross_entropy.py:62"),
               "fused_xent_bwd": (csrc + "cross_entropy.cu",
                                  "vescale_tpu/kernels/cross_entropy.py:88")}
    rows = []
    for name, (source, replaces) in sources.items():
        tm = timings[name]
        by_path = {"train": train["launches"][name], "serve": serve["launches"][name],
                   "serve_eager": serve["eager"]["launches"][name],
                   "spec_prefix": spec_prefix["launches"][name],
                   "serve_resilient": resilient["launches"][name], "spmd": spmd["launches"][name],
                   "checkpoint": ckpt["launches"][name], "gpt2": gpt2["launches"][name],
                   "tp_train": tp_launches(tp_train, name), "plan": plan["launches"].get(name, 0),
                   "tp_serve": tp_launches(tp_serve, name),
                   "dp_train": sum(r["launches_total"].get(name, 0) for r in dp_train["ranks"]),
                   "train_resilient": resilient_train["launches"][name],
                   "telemetry": tel_serve["launches"][name] + tel_gpt2["launches"][name],
                   "pipeline": pipeline["launches"][name], "moe": moe["launches"][name],
                   "nd": nd["launches"][name],
                   "longctx": longctx["launches"][name], "fp8": fp8["launches"][name],
                   "fleet": fleet["launches"][name],
                   "train_leftovers": leftovers["launches"][name],
                   "examples": examples["launches"][name]}
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=sum(by_path.values()), launches_by_path=by_path,
                         max_abs_err=tm["max_abs_err"], ms=tm["ms"], plain_ms=tm["plain_ms"],
                         bound_ms=tm["bound_ms"], bound_by=tm["bound_by"],
                         library_ms=tm["library_ms"], shape=tm["shape"]))
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
