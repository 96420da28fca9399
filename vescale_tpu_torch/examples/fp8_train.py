"""Delayed-scaling fp8 Llama training on the port (reference ``examples/
fp8_train/train_fp8.py``): the module path.  ``LlamaConfig(use_fp8=True)``
carries the ``_overwrite_with_gradient`` collection (each projection's
amax histories and scales) as the fp8 ops' buffers; ``make_train_step``
overwrites them from their gradients after each backward, while a
``DistributedOptimizer`` with dynamic loss scaling (``init_scale`` 2**10)
steps the parameters only.

On the card the model computes in bf16 with flash attention on (head dim
16, run by the flash kernels at their compiled 64), its products on the
fp8 tensor cores; on the CPU (``--cpu``) in fp32 with dense attention, as
the reference runs off its TPU::

    python -m vescale_tpu_torch.examples.fp8_train
"""

from __future__ import annotations

import argparse
import functools
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from . import _common

__all__ = ["config", "run", "amax_head", "main"]


def config(on_card: bool):
    from ..models import LlamaConfig

    return LlamaConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                       num_hidden_layers=4, num_attention_heads=8, num_key_value_heads=4,
                       max_position_embeddings=128,
                       dtype=torch.bfloat16 if on_card else torch.float32,
                       use_flash_attention=on_card, use_fp8=True)


def amax_head(model) -> list:
    """The first three entries of the fp8 state's first leaf in flax's
    tree order (the reference prints ``tree_leaves(bundle[OWG])[0][:3]``)."""
    from ..models import module_tree
    from ..models.convert import _flatten
    from ..quant.fp8 import OWG

    flat = _flatten(module_tree(model)[OWG])
    first = flat[sorted(flat)[0]]
    return [float(x) for x in first.detach().float().cpu().reshape(-1)[:3]]


def run(*, dp: int = 1, tp: int = 1, steps: int = 10, device=None, params=None) -> Dict[str, Any]:
    """``steps`` steps on the reference's one batch from ``params`` (the
    bundle; default ``init_params`` seed 0).  Returns each step's loss and
    loss scale (after the step), the amax history head and the first
    leaf's history after every step."""
    from ..dmodule import parallelize_module
    from ..models import Llama, init_params, llama_plan
    from ..parallel import AdamWLowmem, DistributedOptimizer
    from ..train import make_train_step

    dev = torch.device(device) if device is not None else _common.pick_device()
    cfg = config(dev.type == "cuda")
    with _common.launch(("dp", "tp"), (dp, tp), dev) as mesh:
        model = Llama(cfg, init_params(cfg, 0, device=dev) if params is None else params,
                      device=dev)
        dm = parallelize_module(model, mesh, llama_plan(mesh))
        dopt = DistributedOptimizer(functools.partial(AdamWLowmem, lr=3e-4,
                                                      state_dtype=torch.float32),
                                    models=dm, loss_scale="dynamic", init_scale=2.0 ** 10)
        step = make_train_step(dm, dopt, _common.loss_fn(mesh))
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 65))
        b = _common.tokens_batch(_common.dp_rows(mesh, toks), dev)
        losses, scales, heads = [], [], []
        for _ in range(steps):
            losses.append(float(step(b)))
            scales.append(dopt.current_scale())
            heads.append(amax_head(model))
        res = dict(losses=losses, scales=scales, amax_head=heads[-1], amax_heads=heads,
                   rank=_common.rank_of(mesh))
        del step, dopt, dm, model
        return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", type=str, default=None, help="write the result as JSON (rank 0)")
    a = ap.parse_args(argv)
    res = run(dp=a.dp, tp=a.tp, steps=a.steps, device=_common.pick_device(a.cpu))
    if res["rank"] == 0:
        for i in range(0, a.steps, 2):
            print(f"step {i}: loss {res['losses'][i]:.4f}  loss_scale {res['scales'][i]:g}")
        print("fp8 amax history head:", np.asarray(res["amax_head"]))
        _common.write_json(a.out, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
