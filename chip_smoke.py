#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vescale_tpu_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # device, build and kernel parity only

Phases, each printing one JSON line with its seconds:

  device   the card (``nvidia-smi`` name and power limit), torch and CUDA
  build    compile every CUDA kernel from ``vescale_tpu_torch/kernels/csrc``
  parity   each kernel against its plain PyTorch version on the card, at the
           shapes the Llama-3-8B serve path gives it and at ragged ones,
           with the bound stated beside each case; times of the kernel, the
           plain version and (flash) one PyTorch library call
  engine   a 2-layer fp32 engine on the card (kernels) and on the CPU (plain
           versions) from the same weights: first prefill logits within a
           stated bound, greedy streams of 16 tokens equal
  serve    Llama-3-8B at full width (32 layers, random bf16 weights from a
           seed): 16 requests through ``run_serve``; every request
           completes, the ledger balances, every prefill layer launched the
           flash kernel and every decode layer the paged kernel, and a
           replay of one request reproduces its tokens
  profile  device time by kernel kind and the device's idle share over a
           second run of the serve requests (``torch.profiler``)

Then the card line, the kernels line and, last, ``{"ok": true, "device":
...}``.  Any failure raises and exits non-zero before that line.  Imports
nothing of JAX or of ``vescale_tpu``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

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


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back
    calls, timed with CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ------------------------------------------------------------------ parity
def flash_cases():
    """(label, B, T, H, KV, D, causal, dtype, o bound, lse bound).

    fp32 o: 8 fp32 ulps (the JAX package's kernel bound), 16 where a row
    sums 1000 or more keys, in another order in the kernel's 32-key tiles
    than in cuBLAS.  The ulps are counted at the scale of max|v|: each
    output row is a convex combination of V rows, so its sums round at V's
    magnitude, while a full (non-causal) row averages all T keys and comes
    out smaller than that; at o's own scale (``o_ulps``, reported beside)
    the same rounding counts more ulps the longer the row.  bf16 o: 2 bf16
    steps at o's scale, as both versions round one fp32 result to bf16 and
    a last-place fp32 difference can move that rounding.  lse is fp32 in
    both: 8 ulps at its scale, 16 where a row sums 1000 or more keys."""
    return [
        ("main bf16", 1, 1024, 32, 8, 128, True, torch.bfloat16, 2 * BF16_ULP, 16.0),
        ("main fp32", 1, 1024, 32, 8, 128, True, torch.float32, 16.0, 16.0),
        ("ragged T=1000 bf16", 1, 1000, 32, 8, 128, True, torch.bfloat16, 2 * BF16_ULP, 16.0),
        ("full (non-causal) no GQA T=256 fp32", 2, 256, 8, 8, 128, False, torch.float32, 8.0, 8.0),
        ("hd64 T=77 fp32", 1, 77, 8, 4, 64, True, torch.float32, 8.0, 8.0),
        ("hd64 T=333 bf16 full", 1, 333, 8, 2, 64, False, torch.bfloat16, 2 * BF16_ULP, 8.0),
    ]


def run_flash_parity(dev, ulps):
    from vescale_tpu_torch.kernels.flash_attention import flash_fwd, flash_fwd_reference

    out = []
    main = None
    for label, B, T, H, KV, D, causal, dtype, o_bound, lse_bound in flash_cases():
        g = torch.Generator(device=dev).manual_seed(T * 31 + H)
        q = torch.randn(B * H, T, D, generator=g, device=dev).to(dtype)
        k = torch.randn(B * KV, T, D, generator=g, device=dev).to(dtype)
        v = torch.randn(B * KV, T, D, generator=g, device=dev).to(dtype)
        scale = 1.0 / D ** 0.5
        args = dict(scale=scale, causal=causal, H=H, KV=KV)
        o, lse = flash_fwd(q, k, v, **args)
        o_ref, lse_ref = flash_fwd_reference(q, k, v, **args)
        torch.cuda.synchronize()
        o_np, ref_np = o.float().cpu().numpy(), o_ref.float().cpu().numpy()
        err = float(np.abs(o_np - ref_np).max())
        v_step = float(np.spacing(np.float32(v.float().abs().max().item())))
        row = dict(kernel="flash_fwd", case=label, o_ulps=ulps(o_np, ref_np),
                   o_ulps_at_v=err / v_step, o_bound=o_bound,
                   lse_ulps=ulps(lse.cpu().numpy(), lse_ref.cpu().numpy()), lse_bound=lse_bound,
                   max_abs_err=err)
        o_metric = row["o_ulps"] if dtype == torch.bfloat16 else row["o_ulps_at_v"]
        row["ok"] = o_metric <= o_bound and row["lse_ulps"] <= lse_bound
        out.append(row)
        if label == "main bf16":
            main = (row, q, k, v, args, B, T, H, KV, D, dtype)
    return out, main


def paged_cases():
    """(label, q dtype, pool dtype, geometry, bound).  The 8B serve shapes
    (S=8, page 16, Pmax 64, KV=8, H=32, hd 128) with ragged lengths from
    only the fresh token to a full slot, and a non-power-of-two page of 6
    as the JAX package's tests use.  fp32 pools: 8 ulps at tensor scale;
    bf16 pools: 64, the JAX package's bound for them."""
    main = dict(S=8, page=16, Pmax=64, KV=8, H=32, hd=128, lengths=[1, 1024, 17, 300, 511, 64, 700, 2])
    page6 = dict(S=3, page=6, Pmax=5, KV=2, H=8, hd=64, lengths=[1, 30, 13])
    return [
        ("main bf16", torch.bfloat16, torch.bfloat16, main, 64.0),
        ("fp32", torch.float32, torch.float32, main, 8.0),
        ("page 6 hd64 fp32 pools, bf16 q", torch.bfloat16, torch.float32, page6, 8.0),
        ("page 6 hd64 bf16", torch.bfloat16, torch.bfloat16, page6, 64.0),
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


def run_paged_parity(dev, ulps):
    from vescale_tpu_torch.kernels.paged_attention import paged_decode, paged_decode_reference

    out = []
    main = None
    for label, q_dtype, pool_dtype, geometry, bound in paged_cases():
        q, kp, vp, table, lengths = paged_inputs(dev, q_dtype, pool_dtype, **geometry)
        scale = 1.0 / q.shape[-1] ** 0.5
        o = paged_decode(q, kp, vp, table, lengths, scale=scale)
        o_ref = paged_decode_reference(q, kp, vp, table, lengths, scale=scale)
        torch.cuda.synchronize()
        u = ulps(o.cpu().numpy(), o_ref.cpu().numpy())
        row = dict(kernel="paged_decode", case=label, ulps=u, bound=bound,
                   max_abs_err=float((o - o_ref).abs().max()), ok=u <= bound)
        out.append(row)
        if label == "main bf16":
            main = (row, q, kp, vp, table, lengths, scale)
    return out, main


def flash_timing(main):
    import torch.nn.functional as F

    from vescale_tpu_torch.kernels.flash_attention import flash_fwd, flash_fwd_reference

    row, q, k, v, args, B, T, H, KV, D, dtype = main
    ms = cuda_ms(lambda: flash_fwd(q, k, v, **args))
    plain_ms = cuda_ms(lambda: flash_fwd_reference(q, k, v, **args), iters=5)
    rep = H // KV
    q4 = q.reshape(B, H, T, D)
    k4 = k.reshape(B, KV, T, D).repeat_interleave(rep, dim=1)
    v4 = v.reshape(B, KV, T, D).repeat_interleave(rep, dim=1)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=args["causal"]))
    elt = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * elt + B * H * T * 4
    flops = (2 if args["causal"] else 4) * T * T * H * D * B
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, max_abs_err=row["max_abs_err"],
                **bound(nbytes, flops, dtype),
                shape=dict(B=B, T=T, H=H, KV=KV, D=D, dtype=str(dtype), causal=args["causal"]))


def paged_timing(main):
    from vescale_tpu_torch.kernels.paged_attention import paged_decode, paged_decode_reference

    row, q, kp, vp, table, lengths, scale = main
    ms = cuda_ms(lambda: paged_decode(q, kp, vp, table, lengths, scale=scale), iters=50)
    plain_ms = cuda_ms(lambda: paged_decode_reference(q, kp, vp, table, lengths, scale=scale))
    S, H, hd = q.shape
    KV = kp.shape[2]
    tokens = int(lengths.sum())
    # the K/V rows the slots hold, read once; q, table, lengths; fp32 out
    nbytes = (2 * tokens * KV * hd * kp.element_size() + q.numel() * q.element_size()
              + table.numel() * 4 + lengths.numel() * 4 + S * H * hd * 4)
    flops = 4 * tokens * H * hd
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, max_abs_err=row["max_abs_err"],
                **bound(nbytes, flops, kp.dtype),
                shape=dict(S=S, H=H, KV=KV, hd=hd, page=kp.shape[1], Pmax=table.shape[1],
                           tokens=tokens, dtype=str(kp.dtype)))


def bound(nbytes: float, flops: float, dtype) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)


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


# ------------------------------------------------------------------- serve
def serve_requests(vocab: int, n: int = 16, seed: int = 0):
    from vescale_tpu_torch.serve import Request

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = tuple(int(t) for t in rng.integers(1, vocab, int(rng.integers(32, 513))))
        out.append((i // 2, Request(rid=i, prompt=prompt, max_new_tokens=32)))
    return out


def run_serve_8b(dev, kernels_mod):
    from vescale_tpu_torch.models import LLAMA3_8B, init_params
    from vescale_tpu_torch.serve import (
        ContinuousBatchingScheduler, KVCacheConfig, PagedKVCache, ServeEngine, run_serve,
    )

    cfg = LLAMA3_8B
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    kc = KVCacheConfig(layers=cfg.num_hidden_layers, kv_heads=cfg.num_key_value_heads,
                       head_dim=cfg.head_dim, num_slots=8, page_size=16, pages_per_slot=64,
                       dtype=torch.bfloat16)
    cache = PagedKVCache(kc, device=dev)
    eng = ServeEngine(cfg, params, cache, device=dev)
    eng.replay_greedy([1, 2, 3], 2)  # warm up cuBLAS and load the kernels
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    arrivals = serve_requests(cfg.vocab_size)
    sched = ContinuousBatchingScheduler(cache)
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
    out = dict(model="LLAMA3_8B", layers=L, weights="random bf16, seed 0", setup_s=setup_s,
               serve_s=wall, steps=res.steps, requests=len(arrivals), prefills=prefills,
               decode_steps=steps, generated_tokens=tokens, tokens_per_s=tokens / wall,
               ttft_p50_s=sched.percentile("ttft", 0.5), ttft_p99_s=sched.percentile("ttft", 0.99),
               decode_step_p50_ms=1e3 * sched.percentile("step_time", 0.5),
               decode_step_p99_ms=1e3 * sched.percentile("step_time", 0.99),
               prefill_p50_ms=1e3 * hist["serve_ttft_prefill_seconds"].percentile(0.5),
               queue_wait_p50_s=hist["serve_ttft_queue_wait_seconds"].percentile(0.5),
               peak_memory_bytes=peak, launches=launches, checks=checks)
    check(all(checks.values()), f"serve checks failed: {out}")
    return out, eng, cfg


def run_profile(eng, cfg, serve_wall_s: float):
    """Device time by kernel kind over a second run of the serve phase's 16
    requests, traced with CUDA activity only.  Tracing each launch slows
    the host several times over, so the idle share is taken against the
    UNTRACED serve phase's wall time (same requests, same tokens): 1 -
    device busy / that wall.  The traced run's own share is reported
    beside it and overstates idleness."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vescale_tpu_torch.serve import ContinuousBatchingScheduler, run_serve

    eng.cache.reset()
    sched = ContinuousBatchingScheduler(eng.cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = run_serve(eng, sched, serve_requests(cfg.vocab_size))
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind = {"flash_fwd": 0.0, "paged_decode": 0.0, "matmul": 0.0, "other": 0.0}
    top, launches = [], 0
    for evt in prof.key_averages():
        if getattr(evt, "device_type", DeviceType.CUDA) != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if not dev_us:
            continue
        name = evt.key
        kind = ("flash_fwd" if "flash_fwd_kernel" in name else
                "paged_decode" if "paged_decode_kernel" in name else
                "matmul" if any(s in name.lower() for s in ("gemm", "nvjet", "cutlass", "xmma")) else
                "other")
        by_kind[kind] += dev_us / 1e3
        launches += evt.count
        top.append((dev_us / 1e3, evt.count, name[:80]))
    busy = sum(by_kind.values())
    check(busy > 0, "the profiler saw no device time")
    top.sort(reverse=True)
    return dict(requests=len(res.outcomes), decode_steps=int(sched.telemetry.counter("serve_decode_steps_total")),
                device_busy_ms=busy, untraced_wall_ms=serve_wall_s * 1e3,
                device_idle_share=max(0.0, 1.0 - busy / (serve_wall_s * 1e3)),
                traced_wall_ms=wall_ms, traced_idle_share=max(0.0, 1.0 - busy / wall_ms),
                device_launches=launches, device_ms_by_kind=by_kind,
                top_kernels=[[n, c, t] for t, c, n in top[:8]])


# -------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="device, build and kernel parity only")
    opts = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
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
                    if "registers" in ln or "spill" in ln]
             for name in nvcc_s}
    log("build", seconds=time.perf_counter() - t, nvcc_seconds=nvcc_s, ptxas=ptxas)

    t = time.perf_counter()
    flash_rows, flash_main = run_flash_parity(dev, ulps_at_scale)
    paged_rows, paged_main = run_paged_parity(dev, ulps_at_scale)
    rows = flash_rows + paged_rows
    timings = {"flash_fwd": flash_timing(flash_main), "paged_decode": paged_timing(paged_main)}
    log("parity", seconds=time.perf_counter() - t, checks=rows, timings=timings)
    check(all(r["ok"] for r in rows), "kernel parity failed: " + json.dumps([r for r in rows if not r["ok"]]))
    if opts.quick:
        print(card, flush=True)
        return 0

    t = time.perf_counter()
    engine = run_small_engine(dev, ulps_at_scale)
    log("engine", seconds=time.perf_counter() - t, **engine)
    t = time.perf_counter()
    serve, eng, cfg = run_serve_8b(dev, kernels_mod)
    log("serve", seconds=time.perf_counter() - t, **serve)
    t = time.perf_counter()
    prof = run_profile(eng, cfg, serve["serve_s"])
    log("profile", seconds=time.perf_counter() - t, **prof)
    log("done", seconds=time.perf_counter() - t_all)

    sources = {"flash_fwd": ("vescale_tpu_torch/kernels/csrc/flash_fwd.cu",
                             "vescale_tpu/kernels/flash_attention.py:43"),
               "paged_decode": ("vescale_tpu_torch/kernels/csrc/paged_decode.cu",
                                "vescale_tpu/kernels/paged_attention.py:53")}
    rows = []
    for name, (source, replaces) in sources.items():
        tm = timings[name]
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=serve["launches"][name], max_abs_err=tm["max_abs_err"],
                         ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=tm["bound_ms"],
                         bound_by=tm["bound_by"], library_ms=tm["library_ms"], shape=tm["shape"]))
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
