"""The Llama-2 4D finetune on the port (reference ``examples/
llama2_4d_finetune/train.py`` and ``loss_parity.py``).

``run`` is ``train.py``: a Llama (``LLAMA2_7B``, or ``--tiny``) over
("dp", "tp") under ``llama_plan`` with sequence parallelism, a ZeRO-2
``DistributedOptimizer`` over ``AdamWLowmem`` with fp32 moments (optax's
``adamw``: moments in the fp32 parameters' dtype) and a global-norm clip
of 1.0, and ``--save`` through the port's checkpoint (``{"model",
"optimizer"}``, the reference's layout).  Its batches are numpy-seeded
(``np.random.default_rng(100 + i)``), where the reference draws
``jax.random.randint``.

``run_parity`` is ``loss_parity.py``'s run: vocab 256, dense attention,
``zero_sharded`` AdamW with the clip, the char-level corpus through
``TokenDataLoader`` (seed 11), the global batch cut into each dp rank's
rows.  ``main(["parity", ...])`` runs one device and then the (dp, tp)
mesh in each dtype and prints the reference's table::

    python -m vescale_tpu_torch.examples.llama2_4d_finetune --tiny --dp 1 --tp 1
    torchrun --nproc-per-node 8 -m vescale_tpu_torch.examples.llama2_4d_finetune \\
        parity --steps 30 --cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from . import _common

__all__ = ["config", "run", "run_parity", "main"]


def config(tiny: bool, seq: int, dtype: torch.dtype, layers: Optional[int] = None):
    """``train.py``'s configs: its tiny Llama, else ``LLAMA2_7B``
    (``layers`` cuts its depth)."""
    from ..models import LLAMA2_7B, LlamaConfig

    if tiny:
        cfg = LlamaConfig(vocab_size=32000, hidden_size=256, intermediate_size=512,
                          num_hidden_layers=4, num_attention_heads=8, num_key_value_heads=4,
                          max_position_embeddings=seq, dtype=dtype)
    else:
        cfg = dataclasses.replace(LLAMA2_7B, dtype=dtype)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_hidden_layers=layers)
    return cfg


def _restored_bitwise(path: str, dm, dopt) -> bool:
    """Load ``path`` into fresh templates: every leaf bitwise the live one."""
    from .. import checkpoint
    from ..checkpoint.planner import flatten_state
    from ..darray import DArray

    got = checkpoint.load(path, {"model": _common.model_template(dm),
                                 "optimizer": dopt.state_template()})
    live = dict(flatten_state({"model": _common.model_state(dm),
                               "optimizer": dopt.state_tree()}))

    def local(x):
        t = x.to_local() if isinstance(x, DArray) else torch.as_tensor(x)
        return t.detach()

    def same(a, b):
        a, b = local(a), local(b)
        return a.dtype == b.dtype and torch.equal(a, b.to(a.device))

    return all(same(v, live[k]) for k, v in flatten_state(got))


def run(*, dp: int = 2, tp: int = 4, steps: int = 10, batch: int = 4, seq: int = 256,
        lr: float = 3e-5, tiny: bool = False, save: Optional[str] = None, device=None,
        layers: Optional[int] = None, check_restore: bool = False) -> Dict[str, Any]:
    """``train.py``: ``steps`` steps from ``init_params`` seed 0; returns
    the losses, the median step's ms and,
    with ``save``, the save's seconds (and, with ``check_restore``,
    whether a load of it is bitwise the live state)."""
    from .. import checkpoint
    from ..dmodule import parallelize_module
    from ..models import Llama, init_params, llama_plan
    from ..parallel import AdamWLowmem, DistributedOptimizer
    from ..train import make_train_step

    dev = torch.device(device) if device is not None else _common.pick_device()
    dtype = torch.float32 if (tiny and dev.type == "cpu") else torch.bfloat16
    cfg = config(tiny, seq, dtype, layers)
    with _common.launch(("dp", "tp"), (dp, tp), dev) as mesh:
        model = Llama(cfg, init_params(cfg, 0, device=dev), device=dev)
        dm = parallelize_module(model, mesh, llama_plan(mesh))
        dopt = DistributedOptimizer(functools.partial(AdamWLowmem, lr=lr,
                                                      state_dtype=torch.float32),
                                    models=dm, grad_clip=1.0)
        step = make_train_step(dm, dopt, _common.loss_fn(mesh))
        losses, ms = [], []
        for i in range(steps):
            toks = _common.seeded_tokens(100 + i, batch, seq, cfg.vocab_size)
            b = _common.tokens_batch(_common.dp_rows(mesh, toks), dev)
            t0 = time.perf_counter()
            losses.append(float(step(b)))
            ms.append((time.perf_counter() - t0) * 1e3)
        res = dict(losses=losses, step_ms=float(np.median(ms)), rank=_common.rank_of(mesh),
                   params=sum(int(np.prod(s.shape)) for s in dm._specs.values()))
        if save:
            t0 = time.perf_counter()
            checkpoint.save(save, {"model": _common.model_state(dm),
                                   "optimizer": dopt.state_tree()})
            res["save_s"] = time.perf_counter() - t0
            if check_restore:
                t0 = time.perf_counter()
                res["restore_bitwise"] = _restored_bitwise(save, dm, dopt)
                res["restore_s"] = time.perf_counter() - t0
        del step, dopt, dm, model
        return res


def parity_config(seq: int, dtype: torch.dtype, cfg_kw: Dict[str, Any]):
    from ..models import LlamaConfig

    return LlamaConfig(vocab_size=256, max_position_embeddings=seq, dtype=dtype,
                       use_flash_attention=False, **cfg_kw)


def run_parity(mesh_shape, steps: int, batch: int, seq: int, cfg_kw: Dict[str, Any],
               data_path: str, dtype_name: str, lr: float, *, device=None,
               params=None) -> list:
    """``loss_parity.py``'s ``run``: the per-step losses on ``mesh_shape``
    ((1, 1): this process alone), from ``params`` (default ``init_params``
    seed 0)."""
    from ..data import TokenDataLoader
    from ..dmodule import parallelize_module
    from ..models import Llama, init_params, llama_plan
    from ..parallel import AdamWLowmem, zero_sharded
    from ..train import make_train_step

    dev = torch.device(device) if device is not None else _common.pick_device()
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    cfg = parity_config(seq, dtype, cfg_kw)
    with _common.launch(("dp", "tp"), mesh_shape, dev) as mesh:
        model = Llama(cfg, init_params(cfg, 0, device=dev) if params is None else params,
                      device=dev)
        dm = parallelize_module(model, mesh, llama_plan(mesh, sequence_parallel=True))
        tx = zero_sharded(functools.partial(AdamWLowmem, lr=lr, state_dtype=torch.float32),
                          mesh, models=dm, grad_clip=1.0)
        step = make_train_step(dm, tx, _common.loss_fn(mesh))
        loader = TokenDataLoader(data_path, batch=batch, seq_len=seq, seed=11, device=dev)
        losses = []
        try:
            for _ in range(steps):
                b = loader.next()
                losses.append(float(step({k: _common.dp_rows(mesh, v) for k, v in b.items()})))
        finally:
            loader.close()
        return losses


def parity_main(argv: Optional[Sequence[str]] = None, *, title: str = "SP + ZeRO-2",
                runner=None, cfg_kw_of=None) -> int:
    """One device against (dp, tp) in fp32 and bf16, as ``loss_parity.py``
    prints them; ``--out`` writes the losses as JSON (rank 0)."""
    ap = argparse.ArgumentParser(description="loss parity: one device against dp x tp")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--corpus", type=str, default=None)
    ap.add_argument("--data", type=str, default=None,
                    help="a char-level token file (written from the corpus when missing; "
                         "default: corpus_char.bin here)")
    ap.add_argument("--init", type=str, default=None, help="an .npz of flax-layout weights")
    ap.add_argument("--dtypes", type=str, default="fp32,bf16")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args(argv)
    dev = _common.pick_device(a.cpu)
    rank = int(os.environ.get("RANK", "0"))
    data_path = a.data or "corpus_char.bin"
    if rank == 0 and not (a.data and os.path.exists(a.data)):
        _common.build_corpus_bin(data_path, a.corpus)
    with _common.world(dev):
        if torch.distributed.is_initialized():
            torch.distributed.barrier()  # the corpus is written
        cfg_kw = (cfg_kw_of or (lambda a: dict(
            hidden_size=a.hidden, intermediate_size=a.hidden * 2, num_hidden_layers=a.layers,
            num_attention_heads=a.heads, num_key_value_heads=a.kv_heads)))(a)
        params = _common.load_tree(a.init) if a.init else None
        runner = runner or run_parity
        out = {}
        for dtype_name in a.dtypes.split(","):
            base = runner((1, 1), a.steps, a.batch, a.seq, cfg_kw, data_path, dtype_name, a.lr,
                          device=dev, params=params)
            par = runner((a.dp, a.tp), a.steps, a.batch, a.seq, cfg_kw, data_path, dtype_name,
                         a.lr, device=dev, params=params)
            rel = [abs(x - y) / max(abs(x), 1e-9) for x, y in zip(base, par)]
            out[dtype_name] = dict(base=base, par=par, max_rel=max(rel))
            if rank == 0:
                print(f"\n{dtype_name}: single-device vs dp{a.dp}xtp{a.tp} ({title})")
                for i in range(0, a.steps, max(1, a.steps // 6)):
                    print(f"  step {i:3d}: {base[i]:.6f} vs {par[i]:.6f}  (rel {rel[i]:.2e})")
                print(f"  final : {base[-1]:.6f} vs {par[-1]:.6f}  (max rel diff: {max(rel):.2e})")
    if rank == 0:
        print("\n| dtype | step 0 (1-dev / 4D) | final (1-dev / 4D) | max rel diff |")
        print("|---|---|---|---|")
        for name, r in out.items():
            print(f"| {name} | {r['base'][0]:.4f} / {r['par'][0]:.4f} | "
                  f"{r['base'][-1]:.4f} / {r['par'][-1]:.4f} | {r['max_rel']:.2e} |")
        _common.write_json(a.out, out)
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["parity"]:
        return parity_main(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-5)
    ap.add_argument("--tiny", action="store_true", help="the tiny config")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this many layers")
    ap.add_argument("--save", type=str, default=None, help="checkpoint path")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", type=str, default=None, help="write the result as JSON (rank 0)")
    a = ap.parse_args(argv)
    res = run(dp=a.dp, tp=a.tp, steps=a.steps, batch=a.batch, seq=a.seq, lr=a.lr, tiny=a.tiny,
              save=a.save, device=_common.pick_device(a.cpu), layers=a.layers)
    if res["rank"] == 0:
        print(f"mesh dp{a.dp} x tp{a.tp}, params {res['params'] / 1e6:.1f}M")
        for i, loss in enumerate(res["losses"]):
            if i % 5 == 0 or i == a.steps - 1:
                print(f"step {i}: loss {loss:.4f}")
        if a.save:
            print(f"checkpoint saved to {a.save}")
        _common.write_json(a.out, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
