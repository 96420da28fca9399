"""Auto-split pipeline training on the port (reference ``examples/
autosplit_pipeline/train.py``): a model that is no list of blocks (a tied
embedding and a long skip from the embedding to the head) traced by
``pipe.split_graph`` (torch.fx) and cut into FLOP-balanced stages, then
trained through the eager ``PipeEngine`` under 1F1B or, with
``--zero-bubble``, the dgrad/wgrad-split zero-bubble schedule, with
optax's ``adamw(3e-3)`` (``AdamWLowmem`` with fp32 moments) over the
merged gradients::

    python -m vescale_tpu_torch.examples.autosplit_pipeline --stages 3 --zero-bubble --cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import _common

__all__ = ["TangledLM", "tangled_params", "lm_loss", "run", "main"]


class TangledLM(torch.nn.Module):
    """The reference's ``TangledLM``: a tied embedding and a long skip, not
    stageable as a plain block list.  flax's LayerNorm, Dense and tanh GELU
    in the port's modules; a template on ``meta`` whose values come from a
    flax-layout tree (``torch.func.functional_call``)."""

    def __init__(self, vocab: int = 512, width: int = 128, depth: int = 6):
        super().__init__()
        from ..models.llama import Dense, Embed
        from ..models.nanogpt import LayerNorm

        d, f32 = torch.device("meta"), torch.float32
        self.depth = depth
        self.emb = Embed(vocab, width, f32, d)
        for i in range(depth):
            self.add_module(f"ln{i}", LayerNorm(width, True, f32, d))
            self.add_module(f"up{i}", Dense(width, 4 * width, f32, d, use_bias=True))
            self.add_module(f"down{i}", Dense(4 * width, width, f32, d, use_bias=True))
        self.lnf = LayerNorm(width, True, f32, d)

    def forward(self, idx):
        x = self.emb(idx)
        skip = x
        for i in range(self.depth):
            h = getattr(self, f"up{i}")(getattr(self, f"ln{i}")(x))
            x = x + getattr(self, f"down{i}")(F.gelu(h, approximate="tanh"))
        return self.emb.attend(self.lnf(x + skip))


def tangled_params(vocab: int = 512, width: int = 128, depth: int = 6, seed: int = 0,
                   device=None) -> Dict[str, Any]:
    """Random weights in flax's layout by ``init_params``' rules
    (``models.convert.draw_leaf``) from a seeded ``torch.Generator``."""
    from ..models.convert import draw_leaf

    dev = torch.device(device) if device is not None else _common.pick_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shapes = {"emb": {"embedding": (vocab, width)}}
    for i in range(depth):
        shapes[f"ln{i}"] = {"bias": (width,), "scale": (width,)}
        shapes[f"up{i}"] = {"bias": (4 * width,), "kernel": (width, 4 * width)}
        shapes[f"down{i}"] = {"bias": (width,), "kernel": (4 * width, width)}
    shapes["lnf"] = {"bias": (width,), "scale": (width,)}
    return {m: {k: draw_leaf(f"{m}.{k}", s, torch.float32, dev, gen) for k, s in leaves.items()}
            for m, leaves in shapes.items()}


def lm_loss(logits, tgt):
    """The reference's loss: -mean(sum(onehot(tgt) * log_softmax(logits)))."""
    return -torch.mean(torch.sum(F.one_hot(tgt, logits.shape[-1]) *
                                 torch.log_softmax(logits, -1), dim=-1))


def run(*, stages: int = 2, microbatches: int = 4, zero_bubble: bool = False,
        steps: int = 20, device=None, params=None, unsplit: bool = False) -> Dict[str, Any]:
    """``steps`` steps of the split model from ``params`` (default
    ``tangled_params`` seed 0).  Returns the groups' parameter names, the
    tied groups, each step's loss, the median step's ms and, with
    ``unsplit``, the losses of the same training through autograd of the
    unsplit model."""
    from ..parallel import AdamWLowmem
    from ..pipe import PipeEngine, split_graph
    from ..pipe.pipe_stage import flatten_tree, unflatten_tree
    from ..plan import PipelineParallelPlan, PipelineScheduleType

    dev = torch.device(device) if device is not None else _common.pick_device()
    model = TangledLM()
    B, T = 8, 32
    full = tangled_params(device=dev) if params is None else params

    def fn(p, x):
        return torch.func.functional_call(model, flatten_tree(p), (x,))

    plan = PipelineParallelPlan(num_stages=stages,
                                schedule_type=PipelineScheduleType.SIMPLE_1F1B,
                                use_zero_bubble=zero_bubble)
    micro = torch.ones((B // microbatches, T), dtype=torch.long, device=dev)
    gm = split_graph(fn, full, micro, plan)  # traced at the microbatch's shape
    groups = [list(gm.group_param_names(g)) for g in range(gm.num_groups)]
    engine = PipeEngine(gm, plan, lm_loss)

    def train(step_fn):
        leaves = {k: v.detach().clone() for k, v in flatten_tree(full).items()}
        opt = AdamWLowmem(list(leaves.values()), 3e-3, state_dtype=torch.float32)
        rng = np.random.default_rng(0)
        losses, ms = [], []
        for _ in range(steps):
            b = _common.tokens_batch(rng.integers(0, 512, (B, T + 1)), dev)
            t0 = time.perf_counter()
            loss, grads = step_fn(leaves, b)
            for k, g in grads.items():
                leaves[k].grad = g
            opt.step()
            losses.append(float(loss))
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, float(np.median(ms))

    def split_step(leaves, b):
        tree = unflatten_tree(leaves)
        loss, grads_pg = engine.forward_backward(gm.partition_params(tree), b,
                                                 num_microbatches=microbatches)
        return loss, flatten_tree(gm.merge_params([dict(g) for g in grads_pg]))

    def unsplit_step(leaves, b):
        ps = {k: v.detach().requires_grad_() for k, v in leaves.items()}
        loss = lm_loss(fn(unflatten_tree(ps), b["input"]), b["target"])
        loss.backward()
        return loss.detach(), {k: v.grad for k, v in ps.items()}

    losses, step_ms = train(split_step)
    res = dict(groups=groups, shared_groups=sorted(gm.shared_groups), losses=losses,
               step_ms=step_ms, stages=stages, zero_bubble=zero_bubble)
    if unsplit:
        res["unsplit_losses"], res["unsplit_step_ms"] = train(unsplit_step)
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--zero-bubble", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", type=str, default=None, help="write the result as JSON")
    a = ap.parse_args(argv)
    res = run(stages=a.stages, microbatches=a.microbatches, zero_bubble=a.zero_bubble,
              steps=a.steps, device=_common.pick_device(a.cpu))
    print(f"{len(res['groups'])} groups; tied groups: {res['shared_groups']}")
    for g, names in enumerate(res["groups"]):
        print(f"  stage {g}: {len(names)} param leaves")
    for i, loss in enumerate(res["losses"]):
        if i % 5 == 0 or i == a.steps - 1:
            print(f"step {i:3d}  loss {loss:.4f}")
    _common.write_json(a.out, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
