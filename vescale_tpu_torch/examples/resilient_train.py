"""Resilient bf16 training on the port (reference ``examples/resilient_train/
train.py``): crash and resume with dynamic loss scaling.

  * ``CheckpointManager``: step-named saves, keep-K rotation, resume from
    the newest committed step (a torn save is invisible);
  * fire-and-forget async saves (the state is copied to the host before
    ``save`` returns; the chunks are written on the I/O pool);
  * ``DistributedOptimizer(loss_scale="dynamic")``: the found-inf skip and
    the scale's backoff and growth;
  * ``Watchdog.from_env()`` (``VESCALE_WATCHDOG_TIMEOUT`` arms it).

Kill it mid-run (``--crash-at N`` exits with 137 after step N, as a
SIGKILL would) and start it again: it continues from the last committed
step.  The batches are the reference's stream (``np.random.default_rng(0)``,
one draw a step); a resumed run draws and drops the batches of the steps
it skips, so its batches are an uninterrupted run's (the reference's
resumed run starts the stream over)::

    python -m vescale_tpu_torch.examples.resilient_train --dp 1 --tp 1 --steps 40
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import os
import sys
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from . import _common

__all__ = ["config", "run", "params_digest", "main"]

CRASH_EXIT_CODE = 137


def config():
    from ..models import GPTConfig

    return GPTConfig(block_size=128, vocab_size=512, n_layer=4, n_head=8, n_embd=256,
                     dropout=0.0, dtype=torch.bfloat16)


def params_digest(module: torch.nn.Module) -> str:
    """sha256 over the parameters' bytes in name order (this rank's pieces)."""
    h = hashlib.sha256()
    for name, p in sorted(module.named_parameters()):
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def run(*, dp: int = 2, tp: int = 4, steps: int = 40, save_every: int = 10, keep: int = 3,
        ckpt_dir: str = "resilient_ckpts", crash_at: Optional[int] = None, device=None,
        params=None, log=print) -> Dict[str, Any]:
    """Train to ``steps``, resuming from ``ckpt_dir``'s newest committed
    step.  Returns the step it started at, each step's loss and loss scale
    (after the step), the final parameters' digest and the newest
    committed step.  ``crash_at`` ends the process with exit code 137
    after that step, as a kill would."""
    from ..checkpoint import CheckpointManager
    from ..dmodule import parallelize_module
    from ..models import GPT, init_params, nanogpt_plan
    from ..parallel import AdamWLowmem, DistributedOptimizer
    from ..resilience import Watchdog
    from ..train import make_train_step

    dev = torch.device(device) if device is not None else _common.pick_device()
    cfg = config()
    with _common.launch(("dp", "tp"), (dp, tp), dev) as mesh:
        model = GPT(cfg, init_params(cfg, 0, device=dev) if params is None else params,
                    device=dev)
        dm = parallelize_module(model, mesh, nanogpt_plan(mesh))
        dopt = DistributedOptimizer(functools.partial(AdamWLowmem, lr=3e-4,
                                                      state_dtype=torch.float32),
                                    models=dm, grad_clip=1.0, loss_scale="dynamic")
        step = make_train_step(dm, dopt, _common.loss_fn(mesh))
        mgr = CheckpointManager(ckpt_dir, keep=keep)
        start = 0
        latest = mgr.latest_step()
        if latest is not None:
            restored = mgr.restore({"model": _common.model_template(dm),
                                    "optimizer": dopt.state_template()})
            _common.load_model_state(dm, restored["model"])
            dopt.load_state_tree(restored["optimizer"])
            start = latest + 1
            log(f"[resume] continuing from committed step {latest}")
        wd = Watchdog.from_env()
        if wd is not None:
            wd.start()
        rng = np.random.default_rng(0)
        rows = dp * 4
        for _ in range(start):  # the batches of the steps already taken
            rng.integers(0, cfg.vocab_size, (rows, cfg.block_size + 1))
        losses, scales, handle = {}, {}, None
        try:
            for i in range(start, steps):
                if wd is not None:
                    wd.beat(i)
                toks = rng.integers(0, cfg.vocab_size, (rows, cfg.block_size + 1))
                loss = float(step(_common.tokens_batch(_common.dp_rows(mesh, toks), dev)))
                scale = dopt.current_scale()
                losses[i], scales[i] = loss, scale
                log(f"step {i:4d}  loss {loss:.4f}  loss_scale {scale:.0f}")
                if i % save_every == 0 or i == steps - 1:
                    # fire-and-forget: training goes on while the chunks are written
                    handle = mgr.save(i, {"model": _common.model_state(dm),
                                          "optimizer": dopt.state_tree()},
                                      async_checkpoint=True)
                if crash_at is not None and i == crash_at:
                    log(f"[crash] simulating SIGKILL at step {i}")
                    sys.stdout.flush()
                    os._exit(CRASH_EXIT_CODE)
            if handle is not None:
                handle.wait()  # only the last save is worth blocking the exit for
        finally:
            if wd is not None:
                wd.stop()
        res = dict(start=start, losses=losses, scales=scales, digest=params_digest(dm.module),
                   latest=mgr.latest_step(), rank=_common.rank_of(mesh))
        log(f"done; latest committed checkpoint: step {res['latest']}")
        del step, dopt, dm, model
        return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--ckpt-dir", type=str, default="resilient_ckpts")
    ap.add_argument("--crash-at", type=int, default=None,
                    help="end the process with exit code 137 after this step")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", type=str, default=None, help="write the result as JSON (rank 0)")
    a = ap.parse_args(argv)
    rank0 = int(os.environ.get("RANK", "0")) == 0
    t0 = time.perf_counter()
    res = run(dp=a.dp, tp=a.tp, steps=a.steps, save_every=a.save_every, keep=a.keep,
              ckpt_dir=a.ckpt_dir, crash_at=a.crash_at, device=_common.pick_device(a.cpu),
              log=print if rank0 else (lambda *_: None))
    res["wall_s"] = time.perf_counter() - t0
    if rank0:
        _common.write_json(a.out, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
