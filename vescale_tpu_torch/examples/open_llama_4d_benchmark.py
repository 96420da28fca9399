"""OpenLLaMA's 4D MFU benchmark on the port (reference ``examples/
open_llama_4d_benchmark/run_open_llama.py``): a Llama over ("dp", "tp")
under ``llama_plan`` with sequence parallelism, ``zero_sharded(
AdamWLowmem)`` over "dp" (the reference's ``zero_sharded(adamw_lowmem)``:
bf16 moments, fp32 main params), timed train steps and the MFU of
``llama_mfu_calculator`` against the card's bf16 peak.

    # OpenLLaMA-3B (26 layers, hidden 3200, 32 heads of 100) on one card
    python -m vescale_tpu_torch.examples.open_llama_4d_benchmark --bf16 --remat
    # the tiny config over dp 2 x tp 4 on the CPU
    torchrun --nproc-per-node 8 -m vescale_tpu_torch.examples.open_llama_4d_benchmark \\
        --dp 2 --tp 4 --tiny --cpu

Weights are random (``init_params`` seed 0) unless ``--hf-ckpt`` names a
local directory of HF safetensors shards (``models.load_hf_llama``).  The
batch is the reference's: ``np.random.default_rng(0)`` tokens, the same
every step.  The flash kernels run at OpenLLaMA-3B's head dim 100, padded
to their compiled 128 (``kernels.kernel_head_dim``).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from . import _common
from .llama_mfu_calculator import llama_flops_per_token, mfu

__all__ = ["config", "run", "main"]


def config(tiny: bool, seq: int, dtype: torch.dtype, remat: bool):
    """The reference's configs: its tiny Llama, else ``OPEN_LLAMA_3B`` at
    ``seq`` with flash attention on."""
    from ..models import OPEN_LLAMA_3B, LlamaConfig

    if tiny:
        return LlamaConfig(vocab_size=32000, hidden_size=256, intermediate_size=512,
                           num_hidden_layers=4, num_attention_heads=8, num_key_value_heads=4,
                           max_position_embeddings=seq, dtype=dtype, remat=remat)
    return dataclasses.replace(OPEN_LLAMA_3B, max_position_embeddings=seq, dtype=dtype,
                               remat=remat, use_flash_attention=True)


def run(*, dp: int = 1, tp: int = 1, steps: int = 10, batch: int = 2, seq: int = 2048,
        lr: float = 3e-5, tiny: bool = False, bf16: bool = False, remat: bool = False,
        sp: bool = True, hf_ckpt: Optional[str] = None, device=None, warmup: int = 2,
        peak_flops: Optional[float] = None, params=None) -> Dict[str, Any]:
    """Build, warm up ``warmup`` steps, time ``steps``.  ``params``: a
    flax-layout tree to start from (default ``init_params`` seed 0, or the
    HF checkpoint).  Returns the losses of every step, the timed step's ms, tokens/s a
    chip, the MFU (None without a known peak), peak device bytes and the
    parameter count."""
    from ..dmodule import parallelize_module
    from ..models import Llama, init_params, llama_plan
    from ..parallel import AdamWLowmem, zero_sharded
    from ..train import make_train_step

    dev = torch.device(device) if device is not None else _common.pick_device()
    cfg = config(tiny, seq, torch.bfloat16 if bf16 else torch.float32, remat)
    with _common.launch(("dp", "tp"), (dp, tp), dev) as mesh:
        if hf_ckpt:
            from ..models import load_hf_llama

            params = load_hf_llama(hf_ckpt, cfg, device=dev)
        elif params is None:
            params = init_params(cfg, 0, device=dev)
        model = Llama(cfg, params, device=dev)
        del params
        dm = parallelize_module(model, mesh, llama_plan(mesh, sequence_parallel=sp))
        n_params = sum(int(np.prod(s.shape)) for s in dm._specs.values())
        opt = zero_sharded(functools.partial(AdamWLowmem, lr=lr), mesh, models=dm)
        step = make_train_step(dm, opt, _common.loss_fn(mesh))
        B = batch * dp
        toks = _common.seeded_tokens(0, B, seq, cfg.vocab_size)
        b = _common.tokens_batch(_common.dp_rows(mesh, toks), dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        losses = []
        for _ in range(warmup):
            losses.append(float(step(b)))  # the host read waits for the step
        t0 = time.perf_counter()
        out = [step(b) for _ in range(steps)]
        losses += [float(x) for x in out]
        dt = (time.perf_counter() - t0) / max(steps, 1)
        n_chips = dp * tp
        tok_s_chip = B * seq / dt / n_chips
        fpt = llama_flops_per_token(cfg.hidden_size, cfg.intermediate_size,
                                    cfg.num_hidden_layers, cfg.vocab_size, seq,
                                    cfg.num_key_value_heads / cfg.num_attention_heads)
        if peak_flops is None and dev.type == "cuda":
            from ..bench import peak_bf16_flops

            peak_flops = peak_bf16_flops(dev)
        res = dict(losses=losses, step_ms=dt * 1e3, tokens_per_s_chip=tok_s_chip,
                   flops_per_token=fpt, peak_flops=peak_flops,
                   mfu=None if peak_flops is None else mfu(tok_s_chip, fpt, peak_flops),
                   peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
                   params=n_params, mesh=dict(dp=dp, tp=tp), batch=B, seq=seq,
                   rank=_common.rank_of(mesh))
        del step, opt, dm, model
        return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=2, help="a dp rank's microbatch")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=3e-5)
    ap.add_argument("--tiny", action="store_true", help="the tiny config")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--remat", action="store_true", help="recompute each block")
    ap.add_argument("--no-sp", action="store_true", help="no sequence parallelism")
    ap.add_argument("--hf-ckpt", type=str, default=None, help="a local HF checkpoint dir")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--peak-flops", type=float, default=None,
                    help="the card's bf16 peak FLOP/s (default: read from the card)")
    ap.add_argument("--out", type=str, default=None, help="write the result as JSON (rank 0)")
    a = ap.parse_args(argv)
    res = run(dp=a.dp, tp=a.tp, steps=a.steps, batch=a.batch, seq=a.seq, lr=a.lr, tiny=a.tiny,
              bf16=a.bf16, remat=a.remat, sp=not a.no_sp, hf_ckpt=a.hf_ckpt,
              device=_common.pick_device(a.cpu), peak_flops=a.peak_flops)
    if res["rank"] == 0:
        if a.hf_ckpt:
            print(f"loaded HF checkpoint from {a.hf_ckpt}")
        print(f"mesh {res['mesh']}, params {res['params'] / 1e6:.1f}M")
        m = "n/a" if res["mfu"] is None else f"{res['mfu']:.4f}"
        print(f"step {res['step_ms']:.1f} ms  tokens/sec/chip {res['tokens_per_s_chip']:.0f}  "
              f"MFU {m}  (loss {res['losses'][-1]:.4f})")
        _common.write_json(a.out, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
