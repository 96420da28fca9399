"""The nanoGPT 4D finetune on the port (reference ``examples/
nanogpt_4d_finetune/train.py`` and ``loss_parity.py``): the single-device
GPT, a sharding plan and the framework's wrappers, "zero model change".

``run`` is ``train.py``: a GPT over ("dp", "tp") under ``nanogpt_plan``,
either optax's ``chain(clip_by_global_norm, adamw)`` (``GlobalNormClip``
over ``AdamWLowmem`` with fp32 moments, the gradient averaged over "dp" by
the train step's DDP) or, with ``zero2``, a ``DistributedOptimizer`` with
the clip; batches from ``TokenDataLoader`` over ``data`` (seed 0) or
numpy-seeded tokens (``np.random.default_rng(100 + i)``, where the
reference draws ``jax.random.randint``); each step one ``train-step``
ndtimeline span (the train step's ``TRAIN_STEP``).

``run_parity`` is ``loss_parity.py``'s run: vocab 256, sequence parallel,
the clip and AdamW, the char-level corpus (seed 7)::

    python -m vescale_tpu_torch.examples.nanogpt_4d_finetune --dp 1 --tp 1 --steps 20
    torchrun --nproc-per-node 8 -m vescale_tpu_torch.examples.nanogpt_4d_finetune \\
        parity --steps 30 --cpu
"""

from __future__ import annotations

import argparse
import functools
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from . import _common
from .llama2_4d_finetune import parity_main

__all__ = ["run", "run_parity", "main"]


def _optimizer(dm, lr: float, grad_clip: float, zero2: bool):
    from ..parallel import AdamWLowmem, DistributedOptimizer

    if zero2:
        return DistributedOptimizer(functools.partial(AdamWLowmem, lr=lr,
                                                      state_dtype=torch.float32),
                                    models=dm, grad_clip=grad_clip)
    inner = AdamWLowmem(dm.parameters(), lr, state_dtype=torch.float32)
    return _common.GlobalNormClip(inner, dm, grad_clip)


def run(*, dp: int = 2, tp: int = 4, steps: int = 20, batch: int = 8, seq: int = 256,
        n_layer: int = 4, n_embd: int = 256, n_head: int = 8, lr: float = 3e-4,
        grad_clip: float = 1.0, data: Optional[str] = None, zero2: bool = False,
        device=None) -> Dict[str, Any]:
    """``train.py``: ``steps`` steps from ``init_params`` seed 0.  Returns
    the losses, the median step's ms, tokens/s and the ``train-step`` spans
    recorded."""
    from ..dmodule import parallelize_module
    from ..models import GPT, GPTConfig, init_params, nanogpt_plan
    from ..ndtimeline import flush, init_ndtimers
    from ..ndtimeline.predefined import TRAIN_STEP
    from ..ndtimeline.api import deinit_ndtimers
    from ..train import make_train_step

    dev = torch.device(device) if device is not None else _common.pick_device()
    cfg = GPTConfig(block_size=seq, vocab_size=50304, n_layer=n_layer, n_head=n_head,
                    n_embd=n_embd, dropout=0.0)
    with _common.launch(("dp", "tp"), (dp, tp), dev) as mesh:
        model = GPT(cfg, init_params(cfg, 0, device=dev), device=dev)
        dm = parallelize_module(model, mesh, nanogpt_plan(mesh))
        opt = _optimizer(dm, lr, grad_clip, zero2)
        step = make_train_step(dm, opt, _common.loss_fn(mesh))
        loader = None
        if data:
            from ..data import TokenDataLoader

            loader = TokenDataLoader(data, batch=batch, seq_len=seq, seed=0, device=dev)

        def get_batch(i):
            if loader is not None:
                b = loader.next()
                return {k: _common.dp_rows(mesh, v) for k, v in b.items()}
            toks = _common.seeded_tokens(100 + i, batch, seq, cfg.vocab_size)
            return _common.tokens_batch(_common.dp_rows(mesh, toks), dev)

        spans = []
        init_ndtimers(rank=_common.rank_of(mesh), handlers=[spans.extend])
        losses, ms = [], []
        t_all = time.perf_counter()
        try:
            for i in range(steps):
                t0 = time.perf_counter()
                loss = step(get_batch(i))  # the step is one TRAIN_STEP ("train-step") span
                losses.append(float(loss))
                ms.append((time.perf_counter() - t0) * 1e3)
            flush()
        finally:
            deinit_ndtimers()
            if loader is not None:
                loader.close()
        wall = time.perf_counter() - t_all
        res = dict(losses=losses, step_ms=float(np.median(ms)),
                   tokens_per_s=steps * batch * seq / wall, rank=_common.rank_of(mesh),
                   train_step_spans=sum(1 for s in spans if s.metric == TRAIN_STEP),
                   params=sum(int(np.prod(s.shape)) for s in dm._specs.values()))
        del step, opt, dm, model
        return res


def run_parity(mesh_shape, steps: int, batch: int, seq: int, cfg_kw: Dict[str, Any],
               data_path: str, dtype_name: str, lr: float, *, device=None,
               params=None) -> list:
    """``loss_parity.py``'s ``run``: the per-step losses on ``mesh_shape``
    ((1, 1): this process alone), from ``params`` (default ``init_params``
    seed 0)."""
    from ..data import TokenDataLoader
    from ..dmodule import parallelize_module
    from ..models import GPT, GPTConfig, init_params, nanogpt_plan
    from ..parallel import AdamWLowmem
    from ..train import make_train_step

    dev = torch.device(device) if device is not None else _common.pick_device()
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    cfg = GPTConfig(block_size=seq, vocab_size=256, dropout=0.0, dtype=dtype, **cfg_kw)
    with _common.launch(("dp", "tp"), mesh_shape, dev) as mesh:
        model = GPT(cfg, init_params(cfg, 0, device=dev) if params is None else params,
                    device=dev)
        dm = parallelize_module(model, mesh, nanogpt_plan(mesh, sequence_parallel=True))
        opt = _common.GlobalNormClip(AdamWLowmem(dm.parameters(), lr, state_dtype=torch.float32),
                                     dm, 1.0)
        step = make_train_step(dm, opt, _common.loss_fn(mesh))
        # one loader stream (dp_world 1) so both runs see the same batches
        loader = TokenDataLoader(data_path, batch=batch, seq_len=seq, seed=7, device=dev)
        losses = []
        try:
            for _ in range(steps):
                b = loader.next()
                losses.append(float(step({k: _common.dp_rows(mesh, v) for k, v in b.items()})))
        finally:
            loader.close()
        return losses


def main(argv: Optional[Sequence[str]] = None) -> int:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["parity"]:
        rest = argv[1:]
        # loss_parity.py's model flags: --n-layer / --n-embd / --n-head
        names = {"--n-layer": "--layers", "--n-embd": "--hidden", "--n-head": "--heads"}
        rest = [names.get(x, x) for x in rest]
        return parity_main(rest, title="SP on", runner=run_parity, cfg_kw_of=lambda a: dict(
            n_layer=a.layers, n_embd=a.hidden, n_head=a.heads))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--n-layer", type=int, default=4)
    ap.add_argument("--n-embd", type=int, default=256)
    ap.add_argument("--n-head", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-clip", type=float, default=1.0)
    ap.add_argument("--data", type=str, default=None, help="a token .bin file")
    ap.add_argument("--zero2", action="store_true", help="use DistributedOptimizer")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", type=str, default=None, help="write the result as JSON (rank 0)")
    a = ap.parse_args(argv)
    res = run(dp=a.dp, tp=a.tp, steps=a.steps, batch=a.batch, seq=a.seq, n_layer=a.n_layer,
              n_embd=a.n_embd, n_head=a.n_head, lr=a.lr, grad_clip=a.grad_clip, data=a.data,
              zero2=a.zero2, device=_common.pick_device(a.cpu))
    if res["rank"] == 0:
        print(f"mesh dp{a.dp} x tp{a.tp}, params {res['params'] / 1e6:.1f}M")
        for i, loss in enumerate(res["losses"]):
            if i % 5 == 0 or i == a.steps - 1:
                print(f"step {i}: loss {loss:.4f}")
        print(f"{a.steps} steps ({res['tokens_per_s']:.0f} tok/s)")
        _common.write_json(a.out, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
