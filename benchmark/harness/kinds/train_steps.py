"""Training cells: ``make_train_step`` over a Mixtral on fresh batches.

Set-up builds the model from the seed's weights, ``AdamWLowmem`` over
``param_dtype_groups`` and the step, then drives that one step through
the traffic's ``checked_steps`` first steps (the warm-up: every kernel is
built and every shape met there).  Those steps go through the window's
own call and feed, on their own rows.  The window then runs the same step
on fresh rows until ``seconds`` have passed.  After it the program is
freed and the plain reference trains the seed's weights on the same first
rows: the losses, the first gradient's norm of each leaf (the program's
from its first moment after one step) and the change of each leaf over
those steps (the program's read before the window's first step) are
compared.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Any, Dict, List

import torch

from .. import compare, traffic as gen, weights as W
from ..env import process_age_s
from ..trace import Capture

B1, B2, EPS, WD = 0.9, 0.999, 1e-8, 1e-4  # AdamWLowmem's defaults, the reference's too


def model_config(c: Dict):
    from vescale_tpu_torch.models import MixtralConfig

    return MixtralConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"], num_hidden_layers=c["num_hidden_layers"],
        num_attention_heads=c["num_attention_heads"],
        num_key_value_heads=c["num_key_value_heads"], num_local_experts=c["num_local_experts"],
        num_experts_per_tok=c["num_experts_per_tok"], capacity_factor=c["capacity_factor"],
        max_position_embeddings=c["max_position_embeddings"], rms_norm_eps=c["rms_norm_eps"],
        rope_theta=c["rope_theta"], dtype=torch.bfloat16)


class Rows:
    """The run's batches, each a fresh draw of (B, T + 1) token ids, made
    on the host from the seed and held on the device ``rows`` at a time."""

    def __init__(self, c: Dict, t: Dict, seed: int, rows: int, device):
        self.shape = (t["batch"], t["seq_len"] + 1)
        self.tok = gen.ZipfTokens(c["vocab_size"], t["zipf_a"], gen.rng(seed, 1))
        self.chunk, self.device = rows, device
        self.held = self._draw()

    def _draw(self) -> torch.Tensor:
        n = self.chunk * self.shape[0] * self.shape[1]
        return torch.from_numpy(self.tok.draw(n).reshape(self.chunk, *self.shape)).to(self.device)

    def batch(self, i: int) -> Dict[str, torch.Tensor]:
        while i >= self.held.shape[0]:  # never on the card: rows for 40 steps a second
            self.held = torch.cat([self.held, self._draw()])
        row = self.held[i]
        return {"input": row[:, :-1], "target": row[:, 1:]}



def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float()))


def _change_norms(specs, seed: int, current: Dict[str, torch.Tensor], device) -> Dict[str, float]:
    """Each leaf's distance from its initial value, made again from the
    seed (a stacked leaf one slice at a time)."""
    out = {}
    for i, spec in enumerate(specs):
        p0 = W.make_leaf(spec, seed, i, device)
        p = current[spec[0]]
        if p.ndim == 3:
            sq = sum(float(torch.sum((p[e].float() - p0[e].float()) ** 2)) for e in range(p.shape[0]))
            out[spec[0]] = math.sqrt(sq)
        else:
            out[spec[0]] = _norm(p.float() - p0.float())
        del p0
    return out


def time_steps(opt, events: List) -> None:
    """Record a pair of CUDA events around each of ``opt``'s steps (the
    train step calls the instance's ``step``)."""
    step = opt.step

    def timed(*a, **k):
        ev = [torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)]
        ev[0].record()
        out = step(*a, **k)
        ev[1].record()
        events.append(ev)
        return out

    opt.step = timed


def build(c: Dict, t: Dict, seed: int, device):
    """(model, optimizer, step) from the seed's weights."""
    from vescale_tpu_torch.loss import vocab_parallel_cross_entropy
    from vescale_tpu_torch.models import Mixtral
    from vescale_tpu_torch.parallel import AdamWLowmem, param_dtype_groups
    from vescale_tpu_torch.train import make_train_step

    cfg = model_config(c)
    model = Mixtral(cfg, W.make_tree(W.mixtral_specs(c), seed, device), device=device)
    coef = model.blocks()[0].block_sparse_moe.config.aux_loss_coef
    if coef != c["router_aux_loss_coef_as_run"]:
        raise ValueError(f"the port's aux coefficient {coef} is not the configuration's "
                         f"{c['router_aux_loss_coef_as_run']}")
    opt = AdamWLowmem(param_dtype_groups(model.parameters()), t["lr"])

    def loss_fn(logits, batch):
        return vocab_parallel_cross_entropy(logits, batch["target"]) + sum(model.router_aux_losses())

    return model, opt, make_train_step(model, opt, loss_fn)


def program_checked_steps(model, opt, step, rows, n: int, specs, seed: int, device):
    """The first ``n`` steps through the window's call: their losses, the
    first gradient's norm of each leaf, each leaf's change after them."""
    named = dict(model.named_parameters())
    losses, grad = [], {}
    for i in range(n):
        losses.append(float(step(rows.batch(i))))
        if i == 0:  # a moment the step never made reads as no gradient
            grad = {k: _norm(opt.state[p]["exp_avg"]) / (1 - B1) if "exp_avg" in opt.state[p]
                    else 0.0 for k, p in named.items()}
    return losses, grad, _change_norms(specs, seed, {k: p.detach() for k, p in named.items()},
                                        device)


def reference_steps(c: Dict, t: Dict, seed: int, rows, n: int, device, mode: str = "fp32",
                    half_batch: bool = False):
    """The plain reference over the same first ``n`` rows: losses, first
    gradient norms, change norms."""
    from reference.mixtral_train import AdamW, train_steps
    from reference.precision import NoTF32

    specs = W.mixtral_specs(c)
    weights = dict(W.iter_leaves(specs, seed, device))
    grad: Dict[str, float] = {}

    def on_grad(step, name, g):
        if step == 1:
            grad[name] = _norm(g)

    with NoTF32():
        losses = train_steps(c, weights, [rows.batch(i) for i in range(n)],
                             AdamW(t["lr"], B1, B2, EPS, WD), mode, half_batch, on_grad)
    change = _change_norms(specs, seed, weights, device)
    return losses, grad, change


def readings(prog, ref) -> Dict[str, float]:
    """Every number that may be compared, by name."""
    (pl, pg, pc), (rl, rg, rc) = prog, ref
    moving = compare.moving_leaves(rg)
    return {"loss_gap": compare.loss_gap(pl, rl),
            "loss1_gap": compare.loss_gap(pl[:1], rl[:1]),
            "grad_norm_gap": compare.leaf_gap(pg, rg)[0],
            "grad_norm_gap_median": compare.median_leaf_gap(pg, rg),
            "change_norm_gap": compare.leaf_gap(pc, rc, moving)[0],
            "change_norm_gap_median": compare.median_leaf_gap(pc, rc, moving)}


def checks(prog, ref, limits: Dict[str, float]) -> List[List[Any]]:
    """The numbers the cell's limits file compares, each with its limit."""
    got = readings(prog, ref)
    return [[name, got[name], lim] for name, lim in limits.items()]


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell, seed: int, seconds: float, trace: bool, device) -> Dict[str, Any]:
    c, t = cell.config, cell.traffic
    n_check = t["checked_steps"]
    # rows for the steps any program could run in the window: no step of
    # these shapes takes less than 25 ms on the card (``Rows`` draws more)
    cap = n_check + int(seconds * 40) + 2
    rows = Rows(c, t, seed, cap, device)
    specs = W.mixtral_specs(c)
    model, opt, step = build(c, t, seed, device)
    prog = program_checked_steps(model, opt, step, rows, n_check, specs, seed, device)

    cuda = device.type == "cuda"
    capture = Capture(device) if trace and cuda else None
    moe_events: List = []
    opt_events: List = []
    hooks = []
    if trace and cuda:
        time_steps(opt, opt_events)
        for blk in model.blocks():
            hooks.append(blk.block_sparse_moe.register_forward_pre_hook(
                lambda m, a: moe_events.append([torch.cuda.Event(enable_timing=True)])
                or moe_events[-1][0].record()))
            hooks.append(blk.block_sparse_moe.register_forward_hook(
                lambda m, a, o: moe_events[-1].append(torch.cuda.Event(enable_timing=True))
                or moe_events[-1][1].record()))
        del blk
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = process_age_s()
    t0 = time.perf_counter()
    if capture is not None:
        capture.start()
    steps, traced_steps, last = 0, 0, None
    t_traced = t0  # where the traced part of the window ends
    from torch.profiler import record_function

    while True:
        with record_function("bench.step"):
            last = step(rows.batch(n_check + steps))
        steps += 1
        now = time.perf_counter()
        if capture is not None and capture.active and now - t0 >= t["trace_seconds"]:
            capture.stop()
            traced_steps, t_traced = steps, time.perf_counter()
        if now - t0 >= seconds:
            break
    if capture is not None and capture.active:
        capture.stop()
        traced_steps, t_traced = steps, time.perf_counter()
    if cuda:
        torch.cuda.synchronize(device)
    t_end = time.perf_counter()
    window_s = t_end - t0
    for h in hooks:
        h.remove()
    vars(opt).pop("step", None)  # the timing wrapper holds the optimizer
    finite = math.isfinite(float(last))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    # the per-layer readings of a traced run take the untraced rest of its
    # window, which the profiler does not slow
    L = len(hooks) // 2
    moe_ms = [sum(a.elapsed_time(b) for a, b in moe_events[i:i + L])
              for i in range(traced_steps * L, len(moe_events), max(1, L))]
    adamw_ms = [a.elapsed_time(b) for a, b in opt_events[traced_steps:]]
    B, T = t["batch"], t["seq_len"]
    rest_s = t_end - t_traced
    rest_rate = (steps - traced_steps) * B * T / rest_s if rest_s > 0 and steps > traced_steps else None
    n_params = sum(p.numel() for p in model.parameters())
    group_numels = [(sum(p.numel() for p in g["params"]), g["params"][0].element_size(),
                     torch.empty((), dtype=g["state_dtype"]).element_size())
                    for g in opt.param_groups]
    for p in model.parameters():
        p.grad = None
    del model, opt, step, last, hooks, moe_events, opt_events
    free()

    ref = reference_steps(c, t, seed, rows, n_check, device)
    tokens = steps * B * T
    return {
        "correct": finite, "attempted": steps, "failed": 0 if finite else 1,
        "setup_s": setup_s,
        "metrics": {"train_tokens_per_s": tokens / window_s},
        "checks": checks(prog, ref, cell.limits),
        "memory_peak_bytes": peak,
        "ctx": {"config": c, "traffic": t, "window_s": window_s, "steps": steps,
                "tokens": tokens, "n_params": n_params,
                "tokens_per_s": rest_rate if trace else tokens / window_s,
                "adamw_groups": group_numels, "adamw_ms": adamw_ms,
                "moe_fwd_ms": moe_ms,
                "trace": capture.summary if capture is not None else None,
                "traced_steps": traced_steps, "memory_peak_bytes": peak},
    }
