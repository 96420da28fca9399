"""Training bench of the port: a train step on one device.

    python -m vescale_tpu_torch.bench                 # 1.3B Llama rung, on the card
    python -m vescale_tpu_torch.bench --rung 350m
    python -m vescale_tpu_torch.bench --rung gpt2     # GPT-2 124M (nanoGPT), on the card
    python -m vescale_tpu_torch.bench --rung cpu      # the tiny Llama CPU config
    python -m vescale_tpu_torch.bench --rung gpt_cpu  # the tiny GPT CPU config
    python -m vescale_tpu_torch.bench --rung moe      # the Mixtral-style MoE rung, on the card
    python -m vescale_tpu_torch.bench --rung moe_cpu  # its CPU config
    python -m vescale_tpu_torch.bench --rung longctx  # the 350M at T=32768, on the card
    python -m vescale_tpu_torch.bench --rung longctx_cpu  # its CPU smoke
    python -m vescale_tpu_torch.bench --rung 1.3b --fp8  # a Llama rung with use_fp8

The port of ``bench.py``'s single-device Llama rungs: the same configs
(1.3B: hidden 2048, FFN 5632, 24 layers, 16 heads, 8 KV heads; 350M:
1024/2816, 24/16/8; both at B=1, T=4096 in bf16 with ``AdamWLowmem(3e-4)``
and bf16 moments; cpu: the 2-layer fp32 config at B=2, T=128 with fp32
moments), the same token batch (``numpy.random.default_rng(0)``, repeated
every step), the same loss (``models.nanogpt.cross_entropy_loss``) and the
same MFU formula, ``6 * params + 12 * layers * T * hidden`` FLOPs per
token.  The nanoGPT rungs train ``models.nanogpt.GPT`` through
``loss.vocab_parallel_cross_entropy`` (the fused cross-entropy kernels) on
batches from ``data.TokenDataLoader``, a fresh batch every step: gpt2 is
``GPTConfig()`` at its defaults (GPT-2 124M: 12 layers, 12 heads, width
768, block 1024, vocab 50304) in bf16 with flash attention, at B=12,
T=1024 (karpathy/nanoGPT ``config/train_gpt2.py``), ``AdamWLowmem(3e-4)``
with bf16 moments; gpt_cpu is a 2-layer fp32 GPT of width 128 at B=2,
T=128 with fp32 moments.  Their uint16 token file is written from a numpy
seed into a temporary directory: Zipf-distributed ids below the vocab, so
the loss has a unigram distribution to learn and falls; the loader runs
in its elastic mode, so the global stream is the same for any split of
the batch over data-parallel ranks.  The
MFU denominator is the card's dense bf16 peak: 989 TFLOP/s for an H100
SXM, 756 for the PCIe part, told apart by the device name.  A CPU run
reports no MFU.  Prints one JSON line.  Weights are random, from a seed.

The data-parallel rungs (``prepare_dp``) run a rung on a live ("dp",)
mesh, each rank on its own rows of the global batch, in one of
``DP_MODES``: ``ddp`` (``DistributedDataParallel`` and ``AdamWLowmem``),
``zero2`` (``DistributedOptimizer`` over ``AdamWLowmem``, optionally with
a loss scale) or ``fsdp`` (``FSDPParamBuffer`` and
``make_fsdp_train_step``).  The Llama rungs' global batch is ``rows``
rows of the same numpy-seeded draw, rank r taking rows ``[r*B, (r+1)*B)``.

The MoE rungs port ``bench.py``'s ``bench_moe``: a ``models.mixtral.
Mixtral`` (moe: vocab 32000, hidden 768, FFN 1536, 8 layers, 12 heads, 4
KV heads, 8 experts, top-2, capacity factor 2.0, bf16, B=2, T=2048;
moe_cpu: vocab 256, hidden 64, FFN 128, 2 layers, 4 heads, 2 KV heads, 4
experts, fp32, B=2, T=64) on one numpy-seeded batch, trained through the
same loss (the router aux loss left out, as the reference rung leaves it)
with ``AdamWLowmem(3e-4)`` over ``param_dtype_groups`` (optax's
``adamw(3e-4)`` keeps each leaf's moments in its own dtype: fp32 for the
fp32 leaves, bf16 for the bf16 experts; two fused AdamW launches a step).
Their MFU counts the *active* parameters, the dense ones plus top_k / E of
the expert products (``3 * E * hidden * FFN * layers``), as the reference
does: ``6 * active + 12 * layers * T * hidden`` FLOPs per token.

The long-context rungs port ``bench.py``'s ``bench_longctx``: longctx is
the 350M config at B=1, T=32768 in bf16 with ``remat`` over the MLP
(``remat_scope="mlp"``: attention's residuals are kept, so the flash
kernels are not rerun) and ``scan_layers``; longctx_cpu is the
reference's CPU smoke (vocab 256, hidden 64, FFN 128, 2 layers, 4 heads,
2 KV heads, fp32, block remat) at B=1, T=512.  Both step
``AdamWLowmem(3e-4)`` with bf16 moments, the reference's
``adamw_lowmem(3e-4)``, and report MFU by the same formula.

``--fp8`` (``prepare(..., fp8=True)``) runs a Llama rung with
``use_fp8``: the seven block projections through the delayed-scaling fp8
op, on the card on Hopper's fp8 tensor cores.  Its metric takes an
``_fp8`` suffix; MFU stays over the bf16 peak, as in the reference's
formula.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import kernels
from .data import TokenDataLoader
from . import device as _device
from .device import resolve_device
from .loss import vocab_parallel_cross_entropy
from .models import (GPT, GPTConfig, Llama, LlamaConfig, Mixtral, MixtralConfig,
                     cross_entropy_loss, init_params)
from .parallel import AdamWLowmem, param_dtype_groups
from .train import make_train_step

__all__ = ["RUNGS", "GPT_RUNGS", "MOE_RUNGS", "DP_MODES", "TrainRun", "prepare", "prepare_dp", "measure",
           "peak_bf16_flops", "write_token_file", "main"]

LR = 3e-4  # the reference bench's adamw_lowmem(3e-4)
WARMUP, STEPS = 2, 5  # untimed, then timed steps of a measurement

# rung -> (config, B, T, state dtype, metric)
RUNGS: Dict[str, Any] = {
    "1.3b": (dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632, num_hidden_layers=24,
                  num_attention_heads=16, num_key_value_heads=8, dtype=torch.bfloat16),
             1, 4096, torch.bfloat16, "llama1.3b_train_MFU_1chip_seq4096"),
    "350m": (dict(vocab_size=32000, hidden_size=1024, intermediate_size=2816, num_hidden_layers=24,
                  num_attention_heads=16, num_key_value_heads=8, dtype=torch.bfloat16),
             1, 4096, torch.bfloat16, "llama350m_train_MFU_1chip_seq4096"),
    "cpu": (dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=4, dtype=torch.float32),
            2, 128, torch.float32, "llama_cpu_smoke_tokens_per_s"),
    "longctx": (dict(vocab_size=32000, hidden_size=1024, intermediate_size=2816,
                     num_hidden_layers=24, num_attention_heads=16, num_key_value_heads=8,
                     dtype=torch.bfloat16, remat=True, remat_scope="mlp", scan_layers=True),
                1, 32768, torch.bfloat16, "llama350m_longctx_MFU_1chip_seq32768"),
    "longctx_cpu": (dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                         dtype=torch.float32, remat=True),
                    1, 512, torch.bfloat16, "llama_longctx_cpu_smoke_MFU"),
}
# the nanoGPT family, same layout: GPTConfig fields over its defaults
GPT_RUNGS: Dict[str, Any] = {
    "gpt2": (dict(dtype=torch.bfloat16, use_flash_attention=True),
             12, 1024, torch.bfloat16, "gpt2_124m_train_MFU_1chip_seq1024"),
    "gpt_cpu": (dict(block_size=128, vocab_size=512, n_layer=2, n_head=2, n_embd=128,
                     use_flash_attention=True, dtype=torch.float32),
                2, 128, torch.float32, "gpt_cpu_smoke_tokens_per_s"),
}
# the Mixtral family: MixtralConfig fields, B, T, metric (moments in each
# leaf's own dtype: param_dtype_groups)
MOE_RUNGS: Dict[str, Any] = {
    "moe": (dict(vocab_size=32000, hidden_size=768, intermediate_size=1536, num_hidden_layers=8,
                 num_attention_heads=12, num_key_value_heads=4, num_local_experts=8,
                 num_experts_per_tok=2, capacity_factor=2.0, dtype=torch.bfloat16),
            2, 2048, "mixtral_moe_train_MFU_seq2048"),
    "moe_cpu": (dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
                     dtype=torch.float32),
                2, 64, "mixtral_moe_cpu_smoke_MFU"),
}
DP_MODES = ("ddp", "zero2", "fsdp")
# rungs that run on the CPU unless told otherwise
CPU_RUNGS = ("cpu", "gpt_cpu", "moe_cpu", "longctx_cpu")
DATA_SEED = 0
DATA_TOKENS = 1 << 22  # tokens in a generated token file (8 MiB of uint16)


def peak_bf16_flops(device) -> float:
    """Dense bf16 tensor-core peak of an H100: 989 TFLOP/s (SXM) or 756
    (PCIe), by the device's name (``device.peak_bf16_flops``)."""
    peak = _device.peak_bf16_flops(device)
    if peak is None:
        raise RuntimeError(f"no bf16 peak known for {torch.cuda.get_device_name(device)!r}")
    return peak


def write_token_file(path: str, n_tokens: int, vocab: int, seed: int = DATA_SEED) -> str:
    """A uint16 token file of ``n_tokens`` Zipf(1.2)-distributed ids below
    ``vocab`` (ranks shuffled by a seeded permutation), from
    ``numpy.random.default_rng(seed)``.  Returns ``path``."""
    if vocab > 1 << 16:
        raise ValueError(f"vocab {vocab} does not fit uint16 tokens")
    rng = np.random.default_rng(seed)
    ranks = (rng.zipf(1.2, n_tokens) - 1) % vocab
    rng.permutation(vocab).astype(np.uint16)[ranks].tofile(path)
    return path


@dataclasses.dataclass
class TrainRun:
    rung: str
    config: Any  # LlamaConfig or GPTConfig
    model: torch.nn.Module
    step: Callable
    next_batch: Callable[[], Dict[str, torch.Tensor]]
    n_params: int
    tokens_per_step: int
    flops_per_token: float
    metric: str
    loader: Optional[TokenDataLoader] = None
    tmpdir: Optional[str] = None
    optimizer: Any = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)  # rung-specific report keys

    def close(self) -> None:
        """Close the loader and delete a generated token file."""
        if self.loader is not None:
            self.loader.close()
        if self.tmpdir is not None:
            shutil.rmtree(self.tmpdir, ignore_errors=True)


def _model_and_data(rung: str, dev, *, rows: Optional[int] = None, dp_rank: int = 0,
                    dp_world: int = 1, token_file: Optional[str] = None,
                    layers: Optional[int] = None, fp8: bool = False):
    """(config, model, loss_fn, next_batch, loader, tmpdir, B, T, layers,
    width) of ``rung``: random fp32 master weights from seed 0; Llama rungs
    repeat rows ``[dp_rank*B, (dp_rank+1)*B)`` of one numpy-seeded draw of
    ``rows`` rows (default B, times ``dp_world``); GPT rungs read this
    rank's share of the elastic global stream of ``token_file`` (default: a
    file written into a temporary directory).  ``fp8`` reaches a Llama
    rung's config."""
    gpt = rung in GPT_RUNGS
    fields, B, T, _, _ = (GPT_RUNGS if gpt else RUNGS)[rung]
    loader = tmpdir = None
    if gpt:
        if layers is not None:
            fields = dict(fields, n_layer=layers)
        cfg = GPTConfig(**fields)
        model = GPT(cfg, init_params(cfg, 0, device=dev, dtype=torch.float32), device=dev)
        loss_fn = lambda logits, b: vocab_parallel_cross_entropy(logits, b["target"])
        if token_file is None:
            tmpdir = tempfile.mkdtemp(prefix="vtt_tokens_")
            token_file = write_token_file(os.path.join(tmpdir, "tokens.bin"), DATA_TOKENS,
                                          cfg.vocab_size)
        B //= dp_world
        loader = TokenDataLoader(token_file, B, T, seed=DATA_SEED, dp_rank=dp_rank,
                                 dp_world=dp_world, elastic=True, device=dev)
        next_batch = loader.next
        layers, width = cfg.n_layer, cfg.n_embd
    else:
        if layers is not None:
            fields = dict(fields, num_hidden_layers=layers)
        fields = dict(fields, use_fp8=fp8)
        cfg = LlamaConfig(max_position_embeddings=T, **fields)
        model = Llama(cfg, init_params(cfg, 0, device=dev, dtype=torch.float32), device=dev)
        loss_fn = lambda logits, b: cross_entropy_loss(logits, b["target"])
        rows = B * dp_world if rows is None else rows
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (rows, T + 1))
        toks = toks[dp_rank * (rows // dp_world):(dp_rank + 1) * (rows // dp_world)]
        toks = torch.from_numpy(toks.astype(np.int64)).to(dev)
        B = toks.shape[0]
        batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
        next_batch = lambda: batch
        layers, width = cfg.num_hidden_layers, cfg.hidden_size
    return cfg, model, loss_fn, next_batch, loader, tmpdir, B, T, layers, width


def prepare(rung: str = "1.3b", *, device=None, rows: Optional[int] = None,
            grad_accum_steps: int = 1, token_file: Optional[str] = None,
            layers: Optional[int] = None, fp8: bool = False) -> TrainRun:
    """Model (random fp32 master weights from seed 0), optimizer, step and
    batches of ``rung`` on ``device`` (default: the card; the cpu rungs run
    on the CPU).  Llama rungs repeat one numpy-seeded batch (``rows`` rows,
    default the rung's B, in ``grad_accum_steps`` micro-batches); GPT rungs
    read a fresh batch each step from ``token_file`` (default: one that
    :func:`write_token_file` makes in a temporary directory, which
    ``TrainRun.close`` deletes).  ``layers`` cuts a Llama or GPT rung's
    depth (the smoke's gloo phases run the 1.3B and GPT-2 so); ``fp8`` runs a Llama rung
    with ``use_fp8`` (its metric suffixed ``_fp8``)."""
    if fp8 and (rung in GPT_RUNGS or rung in MOE_RUNGS):
        raise ValueError(f"--fp8 applies to the Llama rungs, not {rung!r}")
    dev = torch.device("cpu") if rung in CPU_RUNGS and device is None else resolve_device(device)
    if rung in MOE_RUNGS:
        return prepare_moe(rung, dev, rows=rows, grad_accum_steps=grad_accum_steps)
    state_dtype, metric = (GPT_RUNGS if rung in GPT_RUNGS else RUNGS)[rung][3:]
    cfg, model, loss_fn, next_batch, loader, tmpdir, B, T, layers, width = _model_and_data(
        rung, dev, rows=rows, token_file=token_file, layers=layers, fp8=fp8)
    opt = AdamWLowmem(model.parameters(), LR, state_dtype=state_dtype)
    step = make_train_step(model, opt, loss_fn, grad_accum_steps=grad_accum_steps)
    n_params = sum(p.numel() for p in model.parameters())
    return TrainRun(rung, cfg, model, step, next_batch, n_params, B * T,
                    6.0 * n_params + 12.0 * layers * T * width, metric + ("_fp8" if fp8 else ""),
                    loader, tmpdir, opt, extra={"seq_len": T} if rung.startswith("longctx") else {})


def moe_config(rung: str) -> MixtralConfig:
    fields, _, T, _ = MOE_RUNGS[rung]
    return MixtralConfig(max_position_embeddings=T, **fields)


def moe_batch(cfg: MixtralConfig, rows: int, T: int, dev) -> Dict[str, torch.Tensor]:
    """The reference rung's batch: ``rows`` rows of T+1 tokens from
    ``numpy.random.default_rng(0)``, split into input and target."""
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (rows, T + 1))
    toks = torch.from_numpy(toks.astype(np.int64)).to(dev)
    return {"input": toks[:, :-1], "target": toks[:, 1:]}


def moe_flops_per_token(cfg: MixtralConfig, n_params: int, T: int):
    """(active parameters, FLOPs per token) by the reference rung's formula
    (``bench.py:185-193``): the dense parameters plus top_k / E of the
    expert products' ``3 * E * hidden * FFN * layers``."""
    expert = (3 * cfg.num_local_experts * cfg.hidden_size * cfg.intermediate_size
              * cfg.num_hidden_layers)
    active = n_params - expert + expert * cfg.num_experts_per_tok / cfg.num_local_experts
    return active, 6.0 * active + 12.0 * cfg.num_hidden_layers * T * cfg.hidden_size


def prepare_moe(rung: str, dev, *, rows: Optional[int] = None, grad_accum_steps: int = 1,
                config: Optional[MixtralConfig] = None) -> TrainRun:
    """A Mixtral rung on ``dev``: the model (``init_params(config, 0)``,
    the reference's leaf dtypes), ``AdamWLowmem(3e-4)`` over
    ``param_dtype_groups``, the step and the repeated numpy-seeded batch.
    ``config`` overrides the rung's (the smoke's full-width Mixtral-8x7B
    runs through it)."""
    _, B, T, metric = MOE_RUNGS[rung]
    cfg = config if config is not None else moe_config(rung)
    model = Mixtral(cfg, init_params(cfg, 0, device=dev), device=dev)
    opt = AdamWLowmem(param_dtype_groups(model.parameters()), LR)
    step = make_train_step(model, opt, lambda logits, b: cross_entropy_loss(logits, b["target"]),
                           grad_accum_steps=grad_accum_steps)
    batch = moe_batch(cfg, B if rows is None else rows, T, dev)
    n_params = sum(p.numel() for p in model.parameters())
    active, fpt = moe_flops_per_token(cfg, n_params, T)
    return TrainRun(rung, cfg, model, step, lambda: batch, n_params,
                    batch["input"].numel(), fpt, metric, optimizer=opt,
                    extra={"active_params": int(active), "seq_len": T})


def prepare_dp(rung: str, mode: str, mesh, *, loss_scale=None, grad_compress=None,
               token_file: Optional[str] = None, layers: Optional[int] = None) -> TrainRun:
    """``rung`` on this rank of the live ("dp",) ``mesh`` in ``mode``
    (``DP_MODES``): the same weights on every rank, this rank's rows of the
    global batch, the gradient averaged over "dp".  ``loss_scale`` goes to
    the ``zero2`` optimizer, ``grad_compress`` to ``ddp`` and ``zero2``.
    ``TrainRun.optimizer`` is the optimizer (for ``fsdp``, the step, whose
    ``pieces`` and ``optimizer`` hold this rank's flat pieces)."""
    import functools

    from .models import module_tree
    from .parallel import (DistributedDataParallel, DistributedOptimizer, FSDPParamBuffer,
                           make_fsdp_train_step)

    if mode not in DP_MODES:
        raise ValueError(f"mode {mode!r}: expected one of {DP_MODES}")
    state_dtype, metric = (GPT_RUNGS if rung in GPT_RUNGS else RUNGS)[rung][3:]
    n, r = mesh.size("dp"), mesh.get_coordinate()[mesh._dim_index("dp")]
    cfg, model, loss_fn, next_batch, loader, tmpdir, B, T, layers, width = _model_and_data(
        rung, mesh.device, dp_rank=r, dp_world=n, token_file=token_file, layers=layers)
    inner = functools.partial(AdamWLowmem, lr=LR, state_dtype=state_dtype)
    n_params = sum(p.numel() for p in model.parameters())
    if mode == "ddp":
        opt = AdamWLowmem(model.parameters(), LR, state_dtype=state_dtype)
        step = make_train_step(DistributedDataParallel(model, mesh, grad_compress=grad_compress),
                               opt, loss_fn)
    elif mode == "zero2":
        opt = DistributedOptimizer(inner, mesh, models=model, loss_scale=loss_scale,
                                   grad_compress=grad_compress)
        step = make_train_step(model, opt, loss_fn)
    else:
        step = opt = make_fsdp_train_step(model, inner, loss_fn,
                                          FSDPParamBuffer(module_tree(model), mesh, dim="dp"))
    return TrainRun(rung, cfg, model, step, next_batch, n_params, B * T,
                    6.0 * n_params + 12.0 * layers * T * width, f"{metric}_dp{n}_{mode}", loader,
                    tmpdir, opt)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(run: TrainRun, warmup: int = WARMUP, steps: int = STEPS) -> Dict[str, Any]:
    """``warmup`` then ``steps`` timed steps, each on ``run.next_batch()``.
    Each step's time is the host clock around the step and the read of its
    loss (a GPT rung's batch fetch and upload included).  Returns the
    losses, step times, the median's tokens/s and MFU (card only), peak
    device memory and the kernel launches of each timed step."""
    dev = next(run.model.parameters()).device
    losses: List[float] = []
    for _ in range(warmup):
        losses.append(float(run.step(run.next_batch())))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    step_ms, launches = [], []
    for _ in range(steps):
        before = dict(kernels.LAUNCHES)
        _sync(dev)
        t0 = time.perf_counter()
        losses.append(float(run.step(run.next_batch())))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({k: kernels.LAUNCHES[k] - before[k] for k in before})
    median_ms = statistics.median(step_ms)
    tokens_per_s = run.tokens_per_step / (median_ms / 1e3)
    out: Dict[str, Any] = dict(
        metric=run.metric, rung=run.rung, device=str(dev), params=run.n_params,
        tokens_per_step=run.tokens_per_step, flops_per_token=run.flops_per_token,
        warmup_steps=warmup, losses=losses, step_ms=step_ms, step_ms_median=median_ms,
        tokens_per_s=tokens_per_s, launches_per_step=launches, **run.extra,
    )
    if dev.type == "cuda":
        peak = peak_bf16_flops(dev)
        out.update(device_name=torch.cuda.get_device_name(dev), peak_flops=peak,
                   mfu=run.flops_per_token * tokens_per_s / peak,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(dev))
    else:
        out.update(mfu=None, peak_memory_bytes=None)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="train-step bench of vescale_tpu_torch")
    ap.add_argument("--rung", choices=sorted({**RUNGS, **GPT_RUNGS, **MOE_RUNGS}), default="1.3b")
    ap.add_argument("--fp8", action="store_true", help="a Llama rung with use_fp8")
    opts = ap.parse_args(argv)
    run = prepare(opts.rung, fp8=opts.fp8)
    try:
        print(json.dumps(measure(run)), flush=True)
    finally:
        run.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
