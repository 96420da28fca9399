#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vescale_tpu_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # device, build and kernel parity only
    python3 chip_smoke.py --tp       # serve, train and gpt2, then the TP phases
    python3 chip_smoke.py --dp       # train and gpt2, then the DP phase
    python3 chip_smoke.py --resil    # the train_resilient phase alone
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
           graphed and the eager engine
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
           at full width.  GPT-2 124M (the gpt2 rung, its token file, 12
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
           telemetry on (median step ms).  The 1.3B: 4 bare steps against
           a run preempted at step 2 (an emergency synchronous save of the
           10.1 GB state) and its resume, bitwise, one K8 a step, the
           save's and restore's seconds, peak memory.  Two ranks of the
           card over gloo (GPT-2 at B=6 a rank, DDP, coordinated,
           consistency every 2, 8 steps): a real SIGTERM to rank 1 agreed
           by both, emergency-saved and resumed bitwise; a one-ulp change
           of a replicated parameter on rank 1 raising ``DesyncError`` on
           both ranks with nothing committed after it
  tp_train  tensor and sequence parallelism on two ranks of the one card:
           child processes (``--tp-child``) joined over gloo at a free
           localhost port (NCCL refuses two ranks on one GPU), a ("tp",)
           mesh of 2.  The 1.3B Llama under ``llama_plan`` and GPT-2 124M
           under ``nanogpt_plan``, both with sequence parallelism, at full
           width and depth, built on ``meta`` and materialized as each
           rank's pieces of the single-card phase's seed-0 weights, trained
           on its batches through the vocab-parallel loss with
           ``AdamWLowmem``: 2 warm-up and 2 timed steps, losses within 1%
           of the ``train`` / ``gpt2`` phase's at each step, every kernel
           launch of each step counted (24 or 12 K1, dq and dkv, one K8,
           K9 and K10); per rank step time, peak memory and the
           collectives' calls and bytes by kind.  The kernels' parity and
           timing at one rank's shapes are in the parity phase
  tp_serve  Llama-3-8B over two such ranks: the serve weights
           materialized from ``meta`` as ``llama_plan`` pieces, a Shard(3)
           pool (4 of 8 kv heads a rank), the serve phase's 16 requests
           through ``run_serve``: every check of the serve phase (512 K1
           launches on 16 heads, a K7 launch a layer a decode step, on 4 kv
           heads), teacher-forced logits of 4 requests within
           ``TP_SERVE_BF16_STEPS`` bf16 steps at scale of the single-card
           engine's, how many streams equal the serve phase's, tokens/s,
           decode p50/p99, and ``engine.graphed`` (false over gloo)
  dp_train  data parallelism on two such ranks, a ("dp",) mesh of 2.  The
           1.3B Llama at full width and depth (B=1 a rank, T=4096, the
           bench's seed-0 weights, ``AdamWLowmem(3e-4)``, a global batch of
           2 rows) under ``ddp``, ``zero2`` (a dynamic loss scale) and
           ``fsdp`` (``bench.prepare_dp``), 1 warm-up and 2 timed steps
           each: losses within 1% of a single-card run of the same two
           rows (``grad_accum_steps=2``), every rank's parameters bitwise
           the other's, the modes bitwise equal (or within
           ``DP_MODE_BOUND``), one K8 launch a step; under ``zero2`` one
           more step with an inf in rank 1's gradient: skipped on both
           ranks, parameters, main params, moments and step bitwise
           unchanged, no K8 launch, the scale halved; per mode and rank
           step time, peak memory, collectives by kind, gloo's share of the
           last step.  GPT-2 124M under DDP at B=6 a rank from the elastic
           loader (the gpt2 phase's B=12 stream), exact and with
           ``grad_compress="int8"``: exact within 1% of the gpt2 phase,
           int8 within 5% of exact at 3.5x or more fewer gradient bytes.
           Then K8 at rank 0's ZeRO pieces and FSDP flat piece against its
           plain version (moments bitwise, u within 4 ulps), timed against
           the plain version and its bound, and the block quantizer's
           quantize and dequantize ms on one 40M-element bucket

Then the card line, the kernels line and, last, ``{"ok": true, "device":
...}``.  Any failure raises and exits non-zero before that line.  Imports
nothing of JAX or of ``vescale_tpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import signal
import socket
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
    (``build/paged_decode.log``), and the dynamic shared memory and ring
    stages of each (pool dtype, head_dim, group bucket); ``spills`` lists
    every kernel with a non-zero spill store or load."""
    import re

    from vescale_tpu_torch.kernels.paged_attention import kernel_layout

    kernels, spills, name = {}, [], None
    for ln in (build.BUILD_DIR / "paged_decode.log").read_text().splitlines():
        m = re.search(r"Function properties for \S*paged_decode_kernelI(f|13__nv_bfloat16)"
                      r"(f|13__nv_bfloat16|S\d*_)Li(\d+)ELi(\d+)E", ln)
        if m:
            tq, tkv, hd, g = m.groups()
            tkv = tq if tkv.startswith("S") else tkv  # a repeated type is mangled as S_
            dt = {"f": "fp32", "13__nv_bfloat16": "bf16"}
            name = f"q {dt[tq]}, pools {dt[tkv]}, hd{hd}, G<={g}"
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
    train shape (head_dim 64, no GQA); rep 4 at T=333 runs the GQA map and
    a ragged edge on the tensor cores."""
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
        # one rank's heads at tp = 2: the 1.3B train, the 8B prefill, GPT-2
        ("tp2 1.3b bf16", 1, 4096, 8, 4, 128, True, bf16, 2 * BF16_ULP, 16.0),
        ("tp2 8b prefill bf16", 1, 1024, 16, 4, 128, True, bf16, 2 * BF16_ULP, 16.0),
        ("tp2 gpt2 bf16", 12, 1024, 6, 6, 64, True, bf16, 2 * BF16_ULP, 16.0),
    ]


def flash_fwd_inputs(dev, B, T, H, KV, D, causal, dtype):
    g = torch.Generator(device=dev).manual_seed(T * 31 + H)
    q = torch.randn(B * H, T, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B * KV, T, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B * KV, T, D, generator=g, device=dev).to(dtype)
    return q, k, v, dict(scale=1.0 / D ** 0.5, causal=causal, H=H, KV=KV)


def run_flash_parity(dev, ulps):
    """Kernel against plain version per case (see ``flash_cases``); the
    rows' ``max_abs_err`` is against the plain version the kernel is held
    to: the fp32 one for fp32, the bf16-P model for bf16."""
    from vescale_tpu_torch.kernels.flash_attention import flash_fwd, flash_fwd_reference

    out = []
    for label, B, T, H, KV, D, causal, dtype, o_bound, lse_bound in flash_cases():
        q, k, v, args = flash_fwd_inputs(dev, B, T, H, KV, D, causal, dtype)
        o, lse = flash_fwd(q, k, v, **args)
        o_ref, lse_ref = flash_fwd_reference(q, k, v, **args)
        row = dict(kernel="flash_fwd", case=label, o_bound=o_bound, lse_bound=lse_bound)
        if dtype == torch.bfloat16:
            again = flash_fwd(q, k, v, **args)
            o_model, lse_model = flash_fwd_reference(q, k, v, pd_dtype=torch.bfloat16, **args)
            o64, lse64 = flash_fwd_reference(q.double(), k.double(), v.double(), **args)
            torch.cuda.synchronize()
            o_np, o64_np = o.double().cpu().numpy(), o64.cpu().numpy()
            row.update(
                o_ulps=ulps(o_np, o64_np),
                o_model_ulps=ulps(o_np, o_model.double().cpu().numpy()), o_model_bound=BF16_ULP,
                o_plain_fp32_ulps=ulps(o_ref.double().cpu().numpy(), o64_np),
                lse_ulps=ulps(lse.cpu().numpy(), lse_model.cpu().numpy()),
                lse_f64_ulps=ulps(lse.double().cpu().numpy(), lse64.cpu().numpy()),
                bitwise_repeat=bits_equal(o, again[0]) and bits_equal(lse, again[1]),
                max_abs_err=float((o.float() - o_model.float()).abs().max()))
            row["ok"] = (row["bitwise_repeat"] and row["o_ulps"] <= o_bound
                         and row["o_model_ulps"] <= BF16_ULP and row["lse_ulps"] <= lse_bound)
            del again, o_model, lse_model, o64, lse64
        else:
            torch.cuda.synchronize()
            o_np, ref_np = o.cpu().numpy(), o_ref.cpu().numpy()
            err = float(np.abs(o_np - ref_np).max())
            v_step = float(np.spacing(np.float32(v.abs().max().item())))
            row.update(o_ulps=ulps(o_np, ref_np), o_ulps_at_v=err / v_step,
                       lse_ulps=ulps(lse.cpu().numpy(), lse_ref.cpu().numpy()), max_abs_err=err)
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
                     ("G16 hd64", g16), ("G16 hd128", g16_128)):
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


def run_paged_parity(dev, ulps):
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
    slots' lengths change and when it runs alone (S=1)."""
    from vescale_tpu_torch.kernels.paged_attention import paged_decode, paged_decode_reference

    out = []
    for label, q_dtype, pool_dtype, geometry, bound in paged_cases():
        q, kp, vp, table, lengths = paged_inputs(dev, q_dtype, pool_dtype, **geometry)
        scale = 1.0 / q.shape[-1] ** 0.5
        o = paged_decode(q, kp, vp, table, lengths, scale=scale)
        again = paged_decode(q, kp, vp, table, lengths, scale=scale)
        o_ref = paged_decode_reference(q, kp, vp, table, lengths, scale=scale)
        o64 = paged_decode_float64(q, kp, vp, table, lengths, scale=scale)
        torch.cuda.synchronize()
        o_np, o64_np = o.double().cpu().numpy(), o64.cpu().numpy()
        u = ulps(o_np, o64_np)
        rep = bits_equal(o, again)
        out.append(dict(kernel="paged_decode", case=label, ulps=u, bound=bound,
                        plain_fp32_ulps=ulps(o_np, o_ref.double().cpu().numpy()),
                        plain_fp32_vs_f64_ulps=ulps(o_ref.double().cpu().numpy(), o64_np),
                        max_abs_err=float((o - o_ref).abs().max()), bitwise_repeat=rep,
                        ok=u <= bound and rep))
        del q, kp, vp, o, again, o_ref, o64
        free_memory()

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
        u = ulps(o.cpu().numpy(), o_ref.cpu().numpy())
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
    the gpt2 cases the GPT-2 124M train shape (head_dim 64, no GQA); rep 4
    at T=333 runs the GQA loop and a ragged edge on the tensor cores."""
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
        # one rank's heads at tp = 2
        ("tp2 1.3b bf16", 1, 4096, 8, 4, 128, True, bf16, 2 * BF16_ULP),
        ("tp2 gpt2 bf16", 12, 1024, 6, 6, 64, True, bf16, 2 * BF16_ULP),
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


def run_flash_bwd_parity(dev, ulps):
    """Kernel against plain version per case, then two launches of the bf16
    kernels bitwise at the main and gpt2 shapes, then the autograd op
    against autograd through the dense reference, then the times of the
    main and gpt2 bf16 cases."""
    from vescale_tpu_torch.kernels.flash_attention import flash_bwd, flash_bwd_reference

    names = ("dq", "dk", "dv")
    out, repeats = [], {}
    for label, B, T, H, KV, D, causal, dtype, bound in flash_bwd_cases():
        q, k, v, o, do, lse, args = flash_bwd_inputs(dev, B, T, H, KV, D, causal, dtype)
        got = flash_bwd(q, k, v, o, do, lse, **args)
        plain = flash_bwd_reference(q, k, v, o, do, lse, **args)
        exact = flash_bwd_reference(*(t.double() for t in (q, k, v, o, do, lse)), **args)
        row = dict(kernel="flash_bwd", case=label, bound=bound)
        for name, a, b in zip(names, plain, exact):
            row[f"{name}_plain_fp32_ulps"] = ulps(a.double().cpu().numpy(), b.cpu().numpy())
        if dtype == torch.bfloat16:
            again = flash_bwd(q, k, v, o, do, lse, **args)
            model = flash_bwd_reference(q, k, v, o, do, lse, pd_dtype=torch.bfloat16, **args)
            row["model_bound"] = BF16_ULP
            for name, a, m in zip(names, got, model):
                row[f"{name}_model_ulps"] = ulps(a.double().cpu().numpy(), m.double().cpu().numpy())
            row["bitwise_repeat"] = all(bits_equal(a, b) for a, b in zip(got, again))
            repeats[label] = row["bitwise_repeat"]
            del again, model
        torch.cuda.synchronize()
        for name, a, b in zip(names, got, exact):
            row[f"{name}_ulps"] = ulps(a.double().cpu().numpy(), b.cpu().numpy())
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
        row[f"{name}_ulps"] = ulps(a.cpu().numpy(), b.cpu().numpy())
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
        _delta, flash_bwd, flash_bwd_dkv, flash_bwd_dq, flash_bwd_reference,
    )

    by_label = {case[0]: case for case in flash_bwd_cases()}
    rows = {"flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    keys = {"gpt2 bf16": "gpt2", "tp2 1.3b bf16": "tp2_1.3b", "tp2 gpt2 bf16": "tp2_gpt2"}
    for label in ("main bf16", "gpt2 bf16", "tp2 1.3b bf16", "tp2 gpt2 bf16"):
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
        elt = q.element_size()
        n_q, n_kv, n_rows = q.numel(), k.numel(), B * H * T
        frac = 0.5 if causal else 1.0
        shape = dict(B=B, T=T, H=H, KV=KV, D=D, dtype=str(dtype), causal=causal)
        dq_bytes = (n_q + 2 * n_kv + n_q + n_q) * elt + 2 * n_rows * 4   # q k v do in, dq out
        dkv_bytes = (n_q + 2 * n_kv + n_q + 2 * n_kv) * elt + 2 * n_rows * 4  # ..., dk dv out
        common = dict(plain_ms=plain_ms, library_ms=library_ms,
                      pair_over_library=(dq_ms + dkv_ms) / library_ms, shape=shape)
        timed = {
            "flash_bwd_dq": dict(ms=dq_ms, max_abs_err=err[0], **common,
                                 **bound(dq_bytes, 6 * frac * T * T * H * D * B, dtype)),
            "flash_bwd_dkv": dict(ms=dkv_ms, max_abs_err=max(err[1], err[2]), **common,
                                  **bound(dkv_bytes, 8 * frac * T * T * H * D * B, dtype)),
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


def adamw_leaves(dev, shapes, state_dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    gs = [torch.randn(s, generator=g, device=dev) for s in shapes]
    ms = [torch.randn(s, generator=g, device=dev).mul_(0.1).to(state_dtype) for s in shapes]
    vs = [torch.randn(s, generator=g, device=dev).square_().mul_(0.01).to(state_dtype)
          for s in shapes]
    return gs, ms, vs


def run_adamw_parity(dev):
    """Over the 1.3B leaf set, bf16 and fp32 state: moments bit for bit
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
    for label, leaf_shapes, state_dtype in cases:
        gs, ms, vs = adamw_leaves(dev, leaf_shapes, state_dtype, seed=len(leaf_shapes))
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
        if state_dtype == torch.bfloat16 and timing is None:
            timing = adamw_timing(gs, ms, vs, c1, c2, hp, err)
        elif label.startswith("tp2"):
            timing["tp2_1.3b"] = adamw_timing(gs, ms, vs, c1, c2, hp, err)
        del gs, ms, vs, us, mos, vos
        free_memory()
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
    from vescale_tpu_torch.kernels.fused_adamw import fused_adamw_reference, fused_adamw_update

    # a call's host side (its leaf table, 3 outputs a leaf) can take longer
    # than a 3 ms launch over 219 pieces on a slow host: queue all ten
    # behind a longer wait (2^28 cycles, ~140 ms)
    ms_k = cuda_ms(lambda: fused_adamw_update(gs, ms, vs, c1, c2, **hp), iters=10,
                   sleep_cycles=1 << 28)
    plain_ms = cuda_ms(lambda: fused_adamw_reference(gs, ms, vs, c1, c2, **hp), iters=3, warmup=1)
    n = sum(g.numel() for g in gs)
    nbytes = n * (2 * gs[0].element_size() + 4 * ms[0].element_size())  # g, u; m, v, m', v'
    # fp32 arithmetic on the CUDA cores: 3 for m', 4 for v', 5 for u
    return dict(ms=ms_k, plain_ms=plain_ms, library_ms=None, max_abs_err=err,
                **bound(nbytes, 12 * n, torch.float32),
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

    from vescale_tpu_torch.kernels.flash_attention import flash_fwd, flash_fwd_reference

    by_label = {case[0]: case for case in flash_cases()}
    errs = {row["case"]: row["max_abs_err"] for row in parity_rows if row["kernel"] == "flash_fwd"}
    out = {}
    for label, key in (("main bf16", None), ("train 1.3b bf16", "train_1.3b"), ("gpt2 bf16", "gpt2"),
                       ("tp2 1.3b bf16", "tp2_1.3b"), ("tp2 8b prefill bf16", "tp2_8b_prefill"),
                       ("tp2 gpt2 bf16", "tp2_gpt2")):
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
        elt = q.element_size()
        nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * elt + B * H * T * 4
        flops = (2 if causal else 4) * T * T * H * D * B
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
    from vescale_tpu_torch.kernels.paged_attention import paged_decode, paged_decode_reference

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
        # the K/V rows the slots hold, read once; q, table, lengths; fp32 out
        nbytes = (2 * tokens * KV * hd * kp.element_size() + q.numel() * q.element_size()
                  + table.numel() * 4 + lengths.numel() * 4 + S * H * hd * 4)
        fields = dict(ms=ms, ms_l2_warm=warm, plain_ms=plain_ms, library_ms=None,
                      max_abs_err=errs[f"{name} bf16"], **bound(nbytes, 4 * tokens * H * hd, kp.dtype),
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


def xent_cases():
    """(label, N, Vs): the GPT-2 path's shape, the 1.3B Llama's, the
    Llama-3 vocab (2.1 GB of fp32 logits) and odd shapes, each in fp32 and
    in bf16 (the path's dtype: the kernels read bf16 logits directly).

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
        (f"tp2 {label} bfloat16", N, Vs, torch.bfloat16) for label, N, Vs in XENT_TP_PATHS]


def xent_inputs(dev, N, Vs, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    lg = (3.0 * torch.randn(N, Vs, generator=g, device=dev)).to(dtype)
    idx = torch.randint(0, Vs, (N,), generator=g, device=dev)
    gmax = torch.amax(lg, dim=-1).float()
    cts = [torch.randn(N, generator=g, device=dev) for _ in range(3)]
    return lg, idx, gmax, cts


def run_xent_parity(dev, ulps):
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
            row[f"{name}_ulps"] = ulps(got[i].cpu().numpy(), exact[i].cpu().numpy())
            row[f"{name}_plain_fp32_ulps"] = ulps(plain[i].cpu().numpy(), exact[i].cpu().numpy())
        del plain, exact, again
        dlg, dlg2 = xent_bwd(lg, idx, gmax, *cts), xent_bwd(lg, idx, gmax, *cts)
        row["bwd_bitwise_repeat"] = bits_equal(dlg, dlg2)
        del dlg2
        if dtype == torch.float32:
            ref = xent_bwd_reference(lg, idx, gmax, *cts)
            row["dlg_ulps"] = ulps(dlg.cpu().numpy(), ref.cpu().numpy())
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
        xent_bwd, xent_bwd_reference, xent_fwd, xent_parts_reference,
    )

    N, Vs = XENT_PATH
    rows = {"fused_xent_fwd": {}, "fused_xent_bwd": {}}
    for dtype in (torch.bfloat16, torch.float32):
        lg, idx, gmax, cts = xent_inputs(dev, N, Vs, dtype, seed=1)
        sfx = "" if dtype == torch.bfloat16 else "_fp32"
        elt = lg.element_size()
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
        rows_n = N * (8 + 4)  # idx int64 and gmax fp32, read once per row
        # a few fp32 operations per element on the CUDA cores: exp, 2 subtract/add, compare
        fwd_b = bound(N * Vs * elt + rows_n + 3 * N * 4, 4 * N * Vs, torch.float32)
        bwd_b = bound(2 * N * Vs * elt + rows_n + 3 * N * 4, 5 * N * Vs, torch.float32)
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
        rows_n = N * (8 + 4)
        for name, fn, plain, lib, nb, ops in (
                ("fused_xent_fwd", lambda: xent_fwd(lg, idx, gmax),
                 lambda: xent_parts_reference(lg, idx, gmax), lambda: F.cross_entropy(lg, idx),
                 N * Vs * 2 + rows_n + 3 * N * 4, 4 * N * Vs),
                ("fused_xent_bwd", lambda: xent_bwd(lg, idx, gmax, *cts),
                 lambda: xent_bwd_reference(lg, idx, gmax, *cts),
                 lambda: torch.autograd.grad(loss, x, retain_graph=True),
                 2 * N * Vs * 2 + rows_n + 3 * N * 4, 5 * N * Vs)):
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


def device_time_by_kind(fn):
    """Run ``fn`` once under ``torch.profiler`` (CUDA activity only):
    device ms by kernel kind, device launches and the top kernels."""
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
    for evt in prof.key_averages():
        if getattr(evt, "device_type", DeviceType.CUDA) != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if not dev_us:
            continue
        by_kind[kernel_kind(evt.key)] += dev_us / 1e3
        launches += evt.count
        top.append((dev_us / 1e3, evt.count, evt.key[:80]))
    busy = sum(by_kind.values())
    check(busy > 0, "the profiler saw no device time")
    top.sort(reverse=True)
    return dict(device_busy_ms=busy, traced_wall_ms=wall_ms, device_launches=launches,
                device_ms_by_kind=by_kind, top_kernels=[[n, c, t] for t, c, n in top[:10]])


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


def serve_run(dev, eng, arrivals, kernels_mod):
    """One run of ``arrivals`` through ``eng`` from an empty cache, with the
    launch counts set to 0 just before it and read just after."""
    from vescale_tpu_torch.serve import ContinuousBatchingScheduler, run_serve

    cfg = eng.config
    eng.cache.reset()
    sched = ContinuousBatchingScheduler(eng.cache)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels_mod.reset_launches()
    t1 = time.perf_counter()
    res = run_serve(eng, sched, arrivals)
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
               peak_memory_bytes=peak, counts=res.counts, launches=launches, checks=checks)
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
    ``VESCALE_SERVE_OPS_PORT`` until SIGTERM drains it."""
    from vescale_tpu_torch.serve import ContinuousBatchingScheduler, serve_replica

    eng = replica_engine(torch.device("cuda", 0))
    res = serve_replica(engine=eng, scheduler=ContinuousBatchingScheduler(eng.cache), linger_s=1.0,
                        coordinate=False)
    print(json.dumps({"replica_status": res.status, "counts": res.counts}), flush=True)
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
        old = os.environ.get("VESCALE_FAULTSIM_HANG_S")
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
TP_LOSS_REL = 0.01  # the reference's bf16 loss bar (nanogpt_4d_finetune/README.md)
TP_SERVE_BF16_STEPS = 16.0  # teacher-forced logits vs the single-card engine (PERF.md)
TP_FORCED = 4  # teacher-forced requests of the tp_serve check


def tp_spawn(job: str, args: dict, timeout_s: float, names=("tp",)):
    """``TP_WORLD`` ranks of ``chip_smoke.py --tp-child`` on the one card,
    joined over gloo at a free localhost port (NCCL refuses two ranks on
    one GPU) on a mesh of one dim named ``names``; each runs
    ``TP_JOBS[job](mesh, **args)`` and writes its JSON result.  A rank that fails, exits without a result or outlives
    ``timeout_s`` fails the phase; every rank is stopped before this
    returns.  Returns the results in rank order."""
    port = free_port()
    tmp = tempfile.mkdtemp(prefix="vtt_tp_")
    env = {k: v for k, v in os.environ.items() if not k.startswith("VESCALE_")}
    procs, logs = [], []
    try:
        for r in range(TP_WORLD):
            spec = os.path.join(tmp, f"spec{r}.json")
            with open(spec, "w") as f:
                json.dump(dict(job=job, rank=r, world=TP_WORLD, port=port, args=args,
                               names=list(names), out=os.path.join(tmp, f"out{r}.json")), f)
            logs.append(open(os.path.join(tmp, f"log{r}.txt"), "w+"))
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                           "--tp-child", spec], env=env, stdout=logs[-1],
                                          stderr=subprocess.STDOUT))
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
        check(codes == [0] * TP_WORLD, f"tp {job}: rank exit codes {codes}:\n" + "\n".join(tails))
        out = []
        for r in range(TP_WORLD):
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
    torch.cuda.set_device(0)
    D.initialize(f"127.0.0.1:{spec['port']}", spec["world"], spec["rank"], device_type="cuda",
                 backend="gloo", timeout_s=900)
    try:
        mesh = init_device_mesh("cuda", (spec["world"],), mesh_dim_names=tuple(spec["names"]),
                                backend="gloo")
        res = TP_JOBS[spec["job"]](mesh, **spec["args"])
        with open(spec["out"], "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()
    return 0


def tp_collectives() -> dict:
    from vescale_tpu_torch import collectives as C

    return dict(calls=dict(C.CALLS), bytes=dict(C.BYTES))


def tp_train_job(mesh, rung: str, ref_losses: list, token_file=None):
    """One rank of ``tp_train``: ``rung`` of the bench (the 1.3B Llama or
    GPT-2 124M) at full width and depth under its plan with sequence
    parallelism, built on ``meta`` and materialized as this rank's pieces
    of the bench's seed-0 weights, trained through the vocab-parallel loss
    with ``AdamWLowmem`` on the bench's batches: ``bench.WARMUP`` untimed
    and ``TP_TIMED`` timed steps."""
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
        cfg = GPTConfig(**fields)
        model, plan = GPT(cfg, device="meta"), nanogpt_plan(mesh, sequence_parallel=True)
    else:
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
    for i in range(bench.WARMUP + TP_TIMED):
        if i == bench.WARMUP:
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
    timed = step_ms[bench.WARMUP:]
    return dict(rank=mesh.get_rank(), setup_s=setup_s, losses=losses, ref_losses=ref_losses,
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


TP_JOBS = {"train": tp_train_job, "serve": tp_serve_job}
TP_TIMED = 2  # timed steps of tp_train


def run_tp_train(dev, train, gpt2, card):
    """``tp_train``: the 1.3B Llama (``llama_plan``) and GPT-2 124M
    (``nanogpt_plan``), both with sequence parallelism, at full width and
    depth on two ranks of one card over gloo, each from the weights and
    batches of its single-card phase (``train``, ``gpt2``): losses within
    1% of that phase's at each step, every kernel launch of each step."""
    from vescale_tpu_torch import bench

    out = {}
    steps = bench.WARMUP + TP_TIMED
    for rung, ref in (("1.3b", train), ("gpt2", gpt2)):
        tmpdir = token_file = None
        if rung == "gpt2":
            tmpdir = tempfile.mkdtemp(prefix="vtt_tokens_")
            token_file = bench.write_token_file(os.path.join(tmpdir, "tokens.bin"),
                                                bench.DATA_TOKENS, 50304)
        t = time.perf_counter()
        try:
            ranks = tp_spawn("train", dict(rung=rung, ref_losses=ref["losses"][:steps],
                                           token_file=token_file), timeout_s=600)
        finally:
            if tmpdir is not None:
                shutil.rmtree(tmpdir, ignore_errors=True)
        ok = all(all(r["checks"].values()) for r in ranks)
        out[rung] = dict(wall_s=time.perf_counter() - t, card=card, ranks=ranks, ok=ok)
        check(ok, f"tp_train {rung} checks failed: {json.dumps(out[rung])[:4000]}")
    return out


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
            "reduce_scatter_tensor", "all_to_all_single", "broadcast", "scatter",
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


def dp_mode_job(mesh, mode: str, ref_losses: list, ddp_params=None):
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
    run = bench.prepare_dp("1.3b", mode, mesh, loss_scale="dynamic" if mode == "zero2" else None)
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
    """One rank of GPT-2 124M under DDP at B=6 (the elastic loader: the
    ranks' rows are the gpt2 phase's B=12 stream), exact or int8."""
    from vescale_tpu_torch import bench, kernels
    from vescale_tpu_torch import collectives as C

    run = bench.prepare_dp("gpt2", "ddp", mesh, grad_compress=grad_compress,
                           token_file=token_file)
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


def dp_train_job(mesh, ref_losses: list, gpt2_ref: list, token_file: str):
    """One rank of ``dp_train``: the 1.3B under ddp, zero2 and fsdp, then
    GPT-2 exact and int8."""
    out, host = {}, None
    for mode in ("ddp", "zero2", "fsdp"):
        out[mode], got = dp_mode_job(mesh, mode, ref_losses, ddp_params=host)
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


def run_dp_train(dev, gpt2, card):
    """``dp_train``: the 1.3B at dp=2 under ddp, zero2 and fsdp (two ranks
    of one card over gloo), each held to a single-card run of the same two
    rows (``grad_accum_steps=2``); GPT-2 exact and int8; K8 at the dp
    shapes."""
    from vescale_tpu_torch import bench

    t = time.perf_counter()
    ref = bench.prepare("1.3b", device=dev, rows=bench.RUNGS["1.3b"][1] * TP_WORLD,
                        grad_accum_steps=TP_WORLD)
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
        ranks = tp_spawn("dp", dict(ref_losses=ref_losses,
                                    gpt2_ref=gpt2["losses"][:DP_GPT2_STEPS],
                                    token_file=token_file), timeout_s=900, names=("dp",))
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
RESIL_13B_STEPS, RESIL_13B_PREEMPT = 4, 2
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


def resil_prepare(rung: str, dev, token_file=None):
    """A bench rung in the functional signature: (run, FunctionalStep)."""
    from vescale_tpu_torch import bench
    from vescale_tpu_torch.train import FunctionalStep

    run = bench.prepare(rung, device=dev, token_file=token_file)
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
    """Leg 1: GPT-2 124M, the golden run against the faulted run and its
    resume on fresh objects."""
    from vescale_tpu_torch import telemetry
    from vescale_tpu_torch.resilience import AnomalyPolicy, faultsim, parse_schedule

    tel_dir = os.path.join(tmp, "telemetry")
    kw = dict(total=RESIL_STEPS, save_every=RESIL_SAVE_EVERY, async_save=True,
              anomaly=AnomalyPolicy(threshold=2))
    telemetry.init(out_dir=tel_dir)
    try:
        reg = telemetry.get_registry()
        kernels_mod.reset_launches()
        run, fstep = resil_prepare(RESIL_GPT_RUNG, dev, token_file)
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
        run, fstep = resil_prepare(RESIL_GPT_RUNG, dev, token_file)
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
        run, fstep = resil_prepare(RESIL_GPT_RUNG, dev, token_file)  # a new process's objects
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
    """Leg 3: the 1.3B, 4 steps of the bare step loop of ``bench.measure``
    (what the loop with nothing armed must compute; its peak bytes are the
    loop's yardstick) against a run preempted at step 2 (an emergency
    synchronous save of the whole state) and its resume on fresh objects,
    bitwise; K8 once a completed step."""
    root = os.path.join(tmp, "llama13b")
    run, fstep = resil_prepare(RESIL_LLAMA_RUNG, dev)
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
        run, fstep = resil_prepare(RESIL_LLAMA_RUNG, dev)
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
    """One rank of leg 4: GPT-2 at B=6 a rank under the default
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
        run = bench.prepare_dp(RESIL_GPT_RUNG, "ddp", mesh, token_file=token_file)
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
        t = time.perf_counter()
        gpt2 = resil_gpt2_leg(dev, token_file, tmp, kernels_mod)
        gpt2["seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        envelope = resil_envelope_leg(dev, token_file, tmp, kernels_mod)
        envelope["seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        llama, golden13, nbytes = resil_13b_leg(dev, tmp, kernels_mod)
        llama_s = time.perf_counter() - t
        t = time.perf_counter()
        ranks = tp_spawn("resil", dict(root=os.path.join(tmp, "dp"), token_file=token_file),
                         timeout_s=600, names=("dp",))
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
        model="llama 1.3B (bench rung 1.3b)", state_bytes=nbytes, golden_losses=golden13,
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


def tp_launches(phase: dict, name: str) -> int:
    """A kernel's launches over every rank of a TP phase (``tp_train``:
    both rungs, every step)."""
    runs = [r for v in phase.values() if isinstance(v, dict) for r in v["ranks"]] \
        if "ranks" not in phase else phase["ranks"]
    return int(sum(r["launches_total"].get(name, 0) for r in runs))


def tp_only(dev, card, kernels_mod) -> int:
    """``--tp``: the single-card phases the TP phases are held to (serve,
    train, gpt2), then ``tp_train`` and ``tp_serve``."""
    serve, eng, _, _, serve_streams = run_serve_8b(dev, kernels_mod)
    log("serve", **{k: v for k, v in serve.items() if k in ("checks", "launches")})
    forced = forced_reference(eng, serve_streams)
    del eng
    free_memory()
    train = run_train_13b(dev, kernels_mod)
    log("train", losses=train["losses"], step_ms_median=train["step_ms_median"])
    gpt2 = run_train_gpt2(dev, kernels_mod)
    log("gpt2", losses=gpt2["losses"], step_ms_median=gpt2["step_ms_median"])
    t = time.perf_counter()
    tp_train = run_tp_train(dev, train, gpt2, card)
    log("tp_train", seconds=time.perf_counter() - t, **tp_train)
    t = time.perf_counter()
    tp_serve = run_tp_serve(dev, serve_streams, forced, card)
    log("tp_serve", seconds=time.perf_counter() - t, **tp_serve)
    print(card, flush=True)
    return 0


def dp_only(dev, card, kernels_mod) -> int:
    """``--dp``: the single-card train and gpt2 phases, then ``dp_train``."""
    train = run_train_13b(dev, kernels_mod)
    log("train", losses=train["losses"], step_ms_median=train["step_ms_median"])
    gpt2 = run_train_gpt2(dev, kernels_mod)
    log("gpt2", losses=gpt2["losses"], step_ms_median=gpt2["step_ms_median"])
    t = time.perf_counter()
    dp_train = run_dp_train(dev, gpt2, card)
    log("dp_train", seconds=time.perf_counter() - t, **dp_train)
    print(card, flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="device, build and kernel parity only")
    ap.add_argument("--tp", action="store_true",
                    help="device, build, and the serve, train, gpt2 and TP phases only")
    ap.add_argument("--dp", action="store_true",
                    help="device, build, and the train, gpt2 and DP phases only")
    ap.add_argument("--resil", action="store_true",
                    help="device, build, and the train_resilient phase only")
    ap.add_argument("--gloo-probe", action="store_true",
                    help="which collectives gloo carries on CUDA tensors, then exit")
    ap.add_argument("--replica-child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--tp-child", help=argparse.SUPPRESS)
    ap.add_argument("--gloo-probe-child", nargs=3, help=argparse.SUPPRESS)
    opts = ap.parse_args()

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
    if opts.tp:
        return tp_only(dev, card, kernels_mod)
    if opts.dp:
        return dp_only(dev, card, kernels_mod)

    t = time.perf_counter()
    flash_rows = run_flash_parity(dev, ulps_at_scale)
    paged_rows = run_paged_parity(dev, ulps_at_scale)
    timings = {"flash_fwd": flash_timing(dev, flash_rows),
               "paged_decode": paged_timing(dev, paged_rows)}
    bwd_rows, bwd_timings = run_flash_bwd_parity(dev, ulps_at_scale)
    adamw_rows, timings["fused_adamw"] = run_adamw_parity(dev)
    xent_rows, xent_timings = run_xent_parity(dev, ulps_at_scale)
    timings.update(bwd_timings)
    timings.update(xent_timings)
    rows = flash_rows + paged_rows + bwd_rows + adamw_rows + xent_rows
    log("parity", seconds=time.perf_counter() - t, checks=rows, timings=timings)
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
    prof = {"graph": run_profile(eng, cfg, serve["graph"]["serve_s"]),
            "eager": run_profile(eager, cfg, serve["eager"]["serve_s"])}
    log("profile", seconds=time.perf_counter() - t, **prof)
    forced = forced_reference(eng, serve_streams)
    del eng, eager
    free_memory()
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
    resilient_train = run_train_resilient(dev, card, kernels_mod)
    log("train_resilient", seconds=time.perf_counter() - t, **resilient_train)
    t = time.perf_counter()
    tp_train = run_tp_train(dev, train, gpt2, card)
    log("tp_train", seconds=time.perf_counter() - t, **tp_train)
    t = time.perf_counter()
    tp_serve = run_tp_serve(dev, serve_streams, forced, card)
    log("tp_serve", seconds=time.perf_counter() - t, **tp_serve)
    t = time.perf_counter()
    dp_train = run_dp_train(dev, gpt2, card)
    log("dp_train", seconds=time.perf_counter() - t, **dp_train)
    log("done", seconds=time.perf_counter() - t_all)
    check(not bad_parity, "kernel parity failed: " + json.dumps(bad_parity))

    csrc = "vescale_tpu_torch/kernels/csrc/"
    sources = {"flash_fwd": (csrc + "flash_fwd.cu", "vescale_tpu/kernels/flash_attention.py:43"),
               "paged_decode": (csrc + "paged_decode.cu", "vescale_tpu/kernels/paged_attention.py:53"),
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
                   "tp_train": tp_launches(tp_train, name), "tp_serve": tp_launches(tp_serve, name),
                   "dp_train": sum(r["launches_total"].get(name, 0) for r in dp_train["ranks"]),
                   "train_resilient": resilient_train["launches"][name]}
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
