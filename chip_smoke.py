#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vescale_tpu_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # device, build and kernel parity only

Phases, each printing one JSON line with its seconds:

  device   the card (``nvidia-smi`` name and power limit), torch and CUDA
  build    compile every CUDA kernel from ``vescale_tpu_torch/kernels/csrc``
  parity   each kernel against its plain PyTorch version on the card, at the
           shapes the Llama-3-8B serve path (flash forward, paged decode),
           the 1.3B train path (flash backward, fused AdamW) and the GPT-2
           train path (flash forward and backward at head_dim 64 without
           GQA, fused cross entropy) give it and at ragged ones, with the
           bound stated beside each case; the autograd op's grads against
           autograd through the dense reference; times of each kernel, its
           plain version and, where one exists, one PyTorch library call
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


def free_memory() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


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
        # the GPT-2 124M train shape: head_dim 64, no GQA, B=12, T=1024
        ("gpt2 bf16", 12, 1024, 12, 12, 64, True, torch.bfloat16, 2 * BF16_ULP, 16.0),
        ("gpt2 fp32", 12, 1024, 12, 12, 64, True, torch.float32, 16.0, 16.0),
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


# --------------------------------------------------------- flash backward
def flash_bwd_cases():
    """(label, B, T, H, KV, D, causal, dtype, bound on dq, dk and dv).

    fp32: against the plain version run in float64 on the same inputs
    (upcast exactly), the kernel is within 8 ulps at scale
    (``ulps_at_scale``, the JAX package's kernel bound) or no further from
    it than the plain version in fp32 is (``plain_fp32_ulps``, reported
    beside).  The fp32 plain version is no arbiter itself: s rounds in
    fp32 before exp and dp - delta cancels, which costs ~10 ulps at scale
    even at T=96, and at T=4096 cuBLAS sums dk and dv over the group's
    rep * T queries in one fp32 accumulator, which drifts tens of ulps.
    bf16: 2 bf16 steps at scale against the plain version in fp32, as both
    compute in fp32 from the same bf16 inputs and round one fp32 result to
    bf16 (a last-place fp32 difference can move that rounding by one
    step).  The main cases are the 1.3B train shapes; the gpt2 cases the
    GPT-2 124M train shape (head_dim 64, no GQA)."""
    bf16, fp32 = torch.bfloat16, torch.float32
    return [
        ("main bf16", 1, 4096, 16, 8, 128, True, bf16, 2 * BF16_ULP),
        ("main fp32", 1, 4096, 16, 8, 128, True, fp32, 8.0),
        ("ragged T=1000 fp32", 1, 1000, 16, 8, 128, True, fp32, 8.0),
        ("ragged T=1000 bf16", 1, 1000, 16, 8, 128, True, bf16, 2 * BF16_ULP),
        ("no GQA (rep 1) T=512 fp32", 2, 512, 8, 8, 128, True, fp32, 8.0),
        ("hd64 rep 4 T=333 fp32", 1, 333, 8, 2, 64, True, fp32, 8.0),
        ("full (non-causal) T=256 fp32", 2, 256, 8, 4, 128, False, fp32, 8.0),
        ("gpt2 bf16", 12, 1024, 12, 12, 64, True, bf16, 2 * BF16_ULP),
        ("gpt2 fp32", 12, 1024, 12, 12, 64, True, fp32, 8.0),
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
    """Kernel against plain version per case, then the autograd op against
    autograd through the dense reference, then the times of the main case."""
    from vescale_tpu_torch.kernels.flash_attention import flash_bwd, flash_bwd_reference

    out = []
    for label, B, T, H, KV, D, causal, dtype, bound in flash_bwd_cases():
        q, k, v, o, do, lse, args = flash_bwd_inputs(dev, B, T, H, KV, D, causal, dtype)
        got = flash_bwd(q, k, v, o, do, lse, **args)
        ref = flash_bwd_reference(q, k, v, o, do, lse, **args)
        row = dict(kernel="flash_bwd", case=label, bound=bound)
        if dtype == torch.float32:
            exact = flash_bwd_reference(*(t.double() for t in (q, k, v, o, do, lse)), **args)
            for name, a, b in zip(("dq", "dk", "dv"), ref, exact):
                row[f"{name}_plain_fp32_ulps"] = ulps(a.cpu().numpy(), b.cpu().numpy())
            ref = exact
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            row[f"{name}_ulps"] = ulps(a.double().cpu().numpy(), b.double().cpu().numpy())
            row[f"{name}_max_abs_err"] = float((a.double() - b.double()).abs().max())
        row["ok"] = all(row[f"{n}_ulps"] <= max(bound, row.get(f"{n}_plain_fp32_ulps", 0.0))
                        for n in ("dq", "dk", "dv"))
        out.append(row)
        del q, k, v, o, do, lse, got, ref
        free_memory()
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
    """The dq and dkv kernels apart, at the 1.3B train shapes in bf16; the
    plain version computes dq, dk and dv together, and so does the
    library yardstick (the backward of ``scaled_dot_product_attention``
    with the GQA heads expanded), so both rows carry the same plain and
    library times."""
    import torch.nn.functional as F

    from vescale_tpu_torch.kernels.flash_attention import (
        _delta, flash_bwd, flash_bwd_dkv, flash_bwd_dq, flash_bwd_reference,
    )

    label, B, T, H, KV, D, causal, dtype, _ = flash_bwd_cases()[0]
    q, k, v, o, do, lse, args = flash_bwd_inputs(dev, B, T, H, KV, D, causal, dtype)
    lse2, delta = lse.reshape(B * H, T), _delta(o, do)
    got = flash_bwd(q, k, v, o, do, lse, **args)
    ref = flash_bwd_reference(q, k, v, o, do, lse, **args)
    err = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref)]
    dq_ms = cuda_ms(lambda: flash_bwd_dq(q, k, v, do, lse2, delta, **args), iters=10)
    dkv_ms = cuda_ms(lambda: flash_bwd_dkv(q, k, v, do, lse2, delta, **args), iters=10)
    plain_ms = cuda_ms(lambda: flash_bwd_reference(q, k, v, o, do, lse, **args), iters=3, warmup=1)
    rep = H // KV
    q4 = q.reshape(B, H, T, D).detach().requires_grad_()
    k4 = k.reshape(B, KV, T, D).repeat_interleave(rep, dim=1).detach().requires_grad_()
    v4 = v.reshape(B, KV, T, D).repeat_interleave(rep, dim=1).detach().requires_grad_()
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
    do4 = do.reshape(B, H, T, D)
    library_ms = cuda_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4, retain_graph=True))
    elt = q.element_size()
    n_q, n_kv, n_rows = q.numel(), k.numel(), B * H * T
    frac = 0.5 if causal else 1.0
    shape = dict(B=B, T=T, H=H, KV=KV, D=D, dtype=str(dtype), causal=causal)
    dq_bytes = (n_q + 2 * n_kv + n_q + n_q) * elt + 2 * n_rows * 4   # q k v do in, dq out
    dkv_bytes = (n_q + 2 * n_kv + n_q + 2 * n_kv) * elt + 2 * n_rows * 4  # ..., dk dv out
    rows = {
        "flash_bwd_dq": dict(ms=dq_ms, plain_ms=plain_ms, library_ms=library_ms, max_abs_err=err[0],
                             **bound(dq_bytes, 6 * frac * T * T * H * D * B, dtype), shape=shape),
        "flash_bwd_dkv": dict(ms=dkv_ms, plain_ms=plain_ms, library_ms=library_ms,
                              max_abs_err=max(err[1], err[2]),
                              **bound(dkv_bytes, 8 * frac * T * T * H * D * B, dtype), shape=shape),
    }
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


def adamw_leaves(dev, shapes, state_dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    gs = [torch.randn(s, generator=g, device=dev) for s in shapes]
    ms = [torch.randn(s, generator=g, device=dev).mul_(0.1).to(state_dtype) for s in shapes]
    vs = [torch.randn(s, generator=g, device=dev).square_().mul_(0.01).to(state_dtype)
          for s in shapes]
    return gs, ms, vs


def run_adamw_parity(dev):
    """Over the 1.3B leaf set, bf16 and fp32 state: moments bit for bit
    against the plain chain, u within 4 ulps per element (the JAX
    package's bound, docs/kernels.md: c1/c2 are the same fp32 scalars
    here, so the two should agree exactly); then tiny, odd and zero-size
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
             ("odd and empty leaves, bf16 state", [(0,), (1,), (37,), (1023,), (4097,), (3, 0)],
              torch.bfloat16)]
    for label, leaf_shapes, state_dtype in cases:
        gs, ms, vs = adamw_leaves(dev, leaf_shapes, state_dtype, seed=len(leaf_shapes))
        us, mos, vos = fused_adamw_update(gs, ms, vs, c1, c2, **hp)
        worst_u, moments_equal, err = 0.0, True, 0.0
        for i in range(len(gs)):
            ru, rm, rv = fused_adamw_reference([gs[i]], [ms[i]], [vs[i]], c1, c2, **hp)
            moments_equal &= bits_equal(mos[i], rm[0]) and bits_equal(vos[i], rv[0])
            if gs[i].numel():
                worst_u = max(worst_u, ulps_elementwise(us[i], ru[0]))
                err = max(err, float((us[i] - ru[0]).abs().max()))
        out.append(dict(kernel="fused_adamw", case=label, leaves=len(gs),
                        elements=sum(g.numel() for g in gs), moments_bitwise=moments_equal,
                        u_ulps=worst_u, u_bound=4.0, max_abs_err=err,
                        ok=moments_equal and worst_u <= 4.0))
        if state_dtype == torch.bfloat16 and timing is None:
            timing = adamw_timing(gs, ms, vs, c1, c2, hp, err)
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

    ms_k = cuda_ms(lambda: fused_adamw_update(gs, ms, vs, c1, c2, **hp), iters=10)
    plain_ms = cuda_ms(lambda: fused_adamw_reference(gs, ms, vs, c1, c2, **hp), iters=3, warmup=1)
    n = sum(g.numel() for g in gs)
    nbytes = n * (2 * gs[0].element_size() + 4 * ms[0].element_size())  # g, u; m, v, m', v'
    # fp32 arithmetic on the CUDA cores: 3 for m', 4 for v', 5 for u
    return dict(ms=ms_k, plain_ms=plain_ms, library_ms=None, max_abs_err=err,
                **bound(nbytes, 12 * n, torch.float32),
                shape=dict(leaves=len(gs), elements=n, grad=str(gs[0].dtype), state=str(ms[0].dtype)),
                library_note="none: no single PyTorch call computes AdamW with bf16 moments")


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


# ---------------------------------------------------------- cross entropy
XENT_PATH = (12 * 1024, 50304)  # the GPT-2 train path's logits: B*T rows, vocab 50304


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
            for dt in (torch.float32, torch.bfloat16)]


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
    if "flash_fwd_kernel" in name:
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
    timings = {"flash_fwd": flash_timing(flash_main), "paged_decode": paged_timing(paged_main)}
    del flash_main, paged_main
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
    # serve before train: the host-bound serve run is timed before any
    # profiler session of this process has run
    t = time.perf_counter()
    serve, eng, cfg = run_serve_8b(dev, kernels_mod)
    log("serve", seconds=time.perf_counter() - t, **serve)
    t = time.perf_counter()
    prof = run_profile(eng, cfg, serve["serve_s"])
    log("profile", seconds=time.perf_counter() - t, **prof)
    del eng
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
                   "gpt2": gpt2["launches"][name]}
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
