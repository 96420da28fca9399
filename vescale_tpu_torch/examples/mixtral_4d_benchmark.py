"""The Mixtral expert-parallel benchmark on the port (reference
``examples/mixtral_4d_benchmark/mixtral_train.py``): a Mixtral over
("dp", "ep") under ``mixtral_plan``, the loss cross entropy plus every
block's router aux loss (the reference's ``losses`` collection), optax's
``adamw(3e-4)`` (``AdamWLowmem`` with each leaf's moments in its own
dtype, ``param_dtype_groups``; the gradient averaged over "dp" by the
train step's DDP), the step's ms and tokens/s.  The batch is numpy-seeded
(``np.random.default_rng(1)``), where the reference draws
``jax.random.randint``; one step first, then ``steps`` timed::

    python -m vescale_tpu_torch.examples.mixtral_4d_benchmark --dp 1 --ep 1
    torchrun --nproc-per-node 8 -m vescale_tpu_torch.examples.mixtral_4d_benchmark \\
        --dp 2 --ep 4 --bsz 8 --seqlen 256 --layers 2 --cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from . import _common

__all__ = ["config", "run", "main"]


def config(hidden: int, inter: int, layers: int, experts: int, dtype: torch.dtype):
    from ..models import MixtralConfig

    return MixtralConfig(vocab_size=32000, hidden_size=hidden, intermediate_size=inter,
                         num_hidden_layers=layers, num_attention_heads=8, num_key_value_heads=4,
                         num_local_experts=experts, num_experts_per_tok=2, dtype=dtype)


def run(*, dp: int = 2, ep: int = 4, bsz: int = 8, seqlen: int = 256, layers: int = 2,
        hidden: int = 512, inter: int = 1024, experts: int = 8, steps: int = 10,
        device=None, params=None) -> Dict[str, Any]:
    """One step, then ``steps`` timed, from ``params`` (default
    ``init_params`` seed 0).  Returns every step's loss (aux included), the
    timed step's ms and tokens/s."""
    from ..dmodule import parallelize_module
    from ..models import Mixtral, init_params, mixtral_plan
    from ..parallel import AdamWLowmem, param_dtype_groups
    from ..train import make_train_step

    dev = torch.device(device) if device is not None else _common.pick_device()
    cfg = config(hidden, inter, layers, experts,
                 torch.float32 if dev.type == "cpu" else torch.bfloat16)
    with _common.launch(("dp", "ep"), (dp, ep), dev) as mesh:
        model = Mixtral(cfg, init_params(cfg, 0, device=dev) if params is None else params,
                        device=dev)
        dm = parallelize_module(model, mesh, mixtral_plan(mesh))
        opt = AdamWLowmem(param_dtype_groups(dm.parameters()), 3e-4)
        step = make_train_step(dm, opt, _common.loss_fn(
            mesh, extra=lambda: sum(model.router_aux_losses())))
        toks = _common.seeded_tokens(1, bsz, seqlen, cfg.vocab_size)
        b = _common.tokens_batch(_common.dp_rows(mesh, toks), dev)
        losses = [float(step(b))]
        t0 = time.perf_counter()
        out = [step(b) for _ in range(steps)]
        losses += [float(x) for x in out]
        dt = (time.perf_counter() - t0) / max(steps, 1)
        res = dict(losses=losses, step_ms=dt * 1e3, tokens_per_s=bsz * seqlen / dt,
                   rank=_common.rank_of(mesh), mesh=dict(dp=dp, ep=ep),
                   params=sum(int(np.prod(s.shape)) for s in dm._specs.values()),
                   expert_tokens=[blk.block_sparse_moe.expert_tokens.tolist()
                                  for blk in model.blocks()])
        del step, opt, dm, model
        return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--ep", type=int, default=4)
    ap.add_argument("--bsz", type=int, default=8)
    ap.add_argument("--seqlen", type=int, default=256)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--inter", type=int, default=1024)
    ap.add_argument("--experts", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--init", type=str, default=None, help="an .npz of flax-layout weights")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", type=str, default=None, help="write the result as JSON (rank 0)")
    a = ap.parse_args(argv)
    dev = _common.pick_device(a.cpu)
    res = run(dp=a.dp, ep=a.ep, bsz=a.bsz, seqlen=a.seqlen, layers=a.layers, hidden=a.hidden,
              inter=a.inter, experts=a.experts, steps=a.steps, device=dev,
              params=_common.load_tree(a.init) if a.init else None)
    if res["rank"] == 0:
        print(f"mesh {res['mesh']}, params {res['params'] / 1e6:.1f}M")
        print(f"loss {res['losses'][-1]:.4f}, {res['step_ms']:.1f} ms/step, "
              f"{res['tokens_per_s']:.0f} tok/s")
        _common.write_json(a.out, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
