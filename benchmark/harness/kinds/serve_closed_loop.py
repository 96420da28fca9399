"""Serving cells: a closed loop of clients against ``ServeEngine`` under
``ContinuousBatchingScheduler``, driven by the serve loop.

The loop is ``serve.loop.run_serve_resilient`` with its envelope off, as
``run_serve`` runs it (no signal handlers, watchdog, wall deadline or
coordination), fed through its ``inbox``: ``run_serve`` takes only a
fixed schedule, and a closed loop's next request depends on when the
last one finished.  Each client sends its next request at the step
boundary where its last one completed; requests ignore EOS and decode
greedily.  Set-up makes the weights, the cache, the engine and the
scheduler, runs one prefill (every prefill has the cache's one padded
shape) and one decode step (which captures the decode graph), then
starts the clients one after another over the traffic's ``ramp_s``, so
the window opens on a loop already in its steady state.  The window is
``seconds`` long; then no client sends again, the loop stops once every
request sent in the window has its first token, and the program is
freed.

Latencies are taken on the client's side of the loop: a token's time is
when the loop hands it to the scheduler (``record_token``), a request's
TTFT runs from when its client sent it.  After the window a sample of the
requests that finished in it, drawn from the seed with the longest among
them, is run through the plain float32 reference over prompt and served
tokens, and the widest gap by which a served token's logit lies below the
reference's best is compared with the cell's limit.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Any, Dict, List, Optional

import torch

from .. import compare, traffic as gen, weights as W
from ..env import process_age_s
from ..trace import Capture
from ..yardstick import llama_forward_flops


class _Stop(Exception):
    """Raised from the loop's ``on_step`` to end the run."""


def model_config(c: Dict):
    from vescale_tpu_torch.models import LlamaConfig

    return LlamaConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"], num_hidden_layers=c["num_hidden_layers"],
        num_attention_heads=c["num_attention_heads"],
        num_key_value_heads=c["num_key_value_heads"],
        max_position_embeddings=c["max_position_embeddings"], rms_norm_eps=c["rms_norm_eps"],
        rope_theta=c["rope_theta"], tie_word_embeddings=c["tie_word_embeddings"],
        dtype=torch.bfloat16)


def build(c: Dict, t: Dict, seed: int, device):
    from vescale_tpu_torch.serve import (ContinuousBatchingScheduler, KVCacheConfig,
                                         PagedKVCache, ServeEngine)

    d = c["deployment"]
    H = c["num_attention_heads"]
    cache = PagedKVCache(KVCacheConfig(
        layers=c["num_hidden_layers"], kv_heads=c["num_key_value_heads"],
        head_dim=c["hidden_size"] // H, num_slots=d["slots"], page_size=d["page_size"],
        pages_per_slot=d["pages_per_slot"], dtype=torch.bfloat16), device)
    engine = ServeEngine(model_config(c), W.make_tree(W.llama_specs(c), seed, device), cache,
                         device=device)
    sched = ContinuousBatchingScheduler(cache, max_queue=max(64, t["clients"]), slo_ttft_s=0.0)
    return engine, sched


class _Inbox:
    """The loop's inbox: what the clients sent since the last boundary."""

    def __init__(self):
        self.pending = []
        self.closed = False

    def drain(self):
        out, self.pending = self.pending, []
        return out


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (a missing latency is +inf)."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def run(cell, seed: int, seconds: float, trace: bool, device) -> Dict[str, Any]:
    from vescale_tpu_torch.serve import Request
    from vescale_tpu_torch.serve.loop import run_serve_resilient
    from torch.profiler import record_function

    c, t = cell.config, cell.traffic
    clients = t["clients"]
    cuda = device.type == "cuda"
    engine, sched = build(c, t, seed, device)
    cache = engine.cache
    engine.replay_greedy([1] * 8, max_new_tokens=2)  # the padded prefill and the decode graph

    sizes = gen.request_sizes(t, seed)  # every seed the same sizes, in its own order
    tokens = gen.ZipfTokens(c["vocab_size"], t["zipf_a"], gen.rng(seed, 3))
    reqs: Dict[int, Dict[str, Any]] = {}  # rid -> prompt, budget, client, sent, token times
    client_rid: List[Optional[int]] = [None] * clients
    inbox = _Inbox()
    st = {"t0": None, "t_end": None, "next_rid": 0}
    capture = Capture(device) if trace and cuda else None
    spans = {"prefill": [], "decode": []}
    work = {"prefill": [], "decode": []}
    kv_live = [0]  # the most positions the active requests held at a decode call

    def send(client: int, now: float) -> None:
        rid = st["next_rid"]
        st["next_rid"] += 1
        n, out = next(sizes)
        prompt = tuple(int(x) for x in tokens.draw(n))
        reqs[rid] = {"prompt": prompt, "budget": out, "client": client, "sent": now, "times": []}
        client_rid[client] = rid
        inbox.pending.append(Request(rid=rid, prompt=prompt, max_new_tokens=out))

    record = sched.record_token

    def record_token(slot: int, token: int) -> None:
        reqs[sched.active[slot].req.rid]["times"].append(time.perf_counter())
        record(slot, token)

    sched.record_token = record_token
    if trace:
        prefill, decode = engine.prefill, engine.decode

        def traced_prefill(prompt, slot):
            with record_function("bench.prefill"):
                t1 = time.perf_counter()
                out = prefill(prompt, slot)
                if cuda:
                    torch.cuda.synchronize(device)
                spans["prefill"].append((t1, time.perf_counter() - t1))
            if capture is not None and capture.active:
                work["prefill"].append(len(prompt))
            return out

        def traced_decode(toks):
            active = list(sched.active)
            held = sum(int(cache.lengths[s]) + 1 for s in active)
            kv_live[0] = max(kv_live[0], held)
            with record_function("bench.decode"):
                t1 = time.perf_counter()
                out = decode(toks)
                if cuda:
                    torch.cuda.synchronize(device)
                spans["decode"].append((t1, time.perf_counter() - t1, len(active)))
            if capture is not None and capture.active:
                work["decode"].append((held, len(active)))
            return out

        engine.prefill, engine.decode = traced_prefill, traced_decode

    ramp0 = time.perf_counter()
    setup = {}

    def on_step(step: int, active: int) -> None:
        now = time.perf_counter()
        for rid in client_rid:
            if rid is not None and "status" not in reqs[rid] and rid in sched.outcomes:
                reqs[rid]["status"], reqs[rid]["done"] = sched.outcomes[rid]["status"], now
        if st["t0"] is None and now >= ramp0 + t["ramp_s"]:
            if cuda:
                torch.cuda.synchronize(device)
            setup["s"] = process_age_s()
            st["t0"] = now = time.perf_counter()
            if capture is not None:
                capture.start()
        t0 = st["t0"]
        if capture is not None and capture.active and now - t0 >= t["trace_seconds"]:
            capture.stop()
            st["t_traced"] = time.perf_counter()
        if t0 is not None and st["t_end"] is None and now - t0 >= seconds:
            st["t_end"] = now
        if st["t_end"] is not None:
            # no client sends again; stop once every request sent in the
            # window has its first token or its end
            if all(r["times"] or "status" in r for r in reqs.values()
                   if t0 <= r["sent"] <= st["t_end"]):
                raise _Stop
            return
        for cl in range(clients):
            rid = client_rid[cl]
            if rid is None:
                if now >= ramp0 + cl * t["ramp_s"] / clients:
                    send(cl, now)
            elif "status" in reqs[rid]:
                send(cl, now)

    try:
        run_serve_resilient(engine=engine, scheduler=sched, arrivals=[], max_steps=1 << 40,
                            install_signal_handlers=False, watchdog_timeout_s=0,
                            wall_deadline_s=0, coordinate=False, on_step=on_step,
                            inbox=inbox, idle_sleep_s=0.0)
    except _Stop:
        pass
    if capture is not None and capture.active:
        capture.stop()
        st["t_traced"] = time.perf_counter()
    t0, t_end = st["t0"], st["t_end"]
    # a traced run's span and rate readings take the untraced rest of the
    # window, which the profiler does not slow
    rest0 = st.get("t_traced", t0) if trace else t0
    window_s = t_end - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    outcomes = {rid: dict(o) for rid, o in sched.outcomes.items()}
    slots = cache.num_slots
    # K and V of a position in every layer
    position_bytes = 2 * c["num_hidden_layers"] * c["num_key_value_heads"] * (
        c["hidden_size"] // c["num_attention_heads"]) * cache.dtype.itemsize
    del engine, sched, cache, record
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    sent = [r for r in reqs.values() if t0 <= r["sent"] <= t_end]
    ttft = [(r["times"][0] - r["sent"]) if r["times"] else math.inf for r in sent]
    failed = sum(1 for r in sent if r.get("status", "completed") != "completed")
    gaps, out_tokens, served_flops = [], 0, 0.0
    for r in reqs.values():
        n = len(r["prompt"])
        for j, tt in enumerate(r["times"]):
            if t0 < tt <= t_end:
                out_tokens += 1
                if j > 0:
                    gaps.append(tt - r["times"][j - 1])
            if rest0 < tt <= t_end:
                # the first token is the prefill's; token j > 0 feeds position n + j - 1
                served_flops += (llama_forward_flops(c, range(n)) if j == 0
                                 else llama_forward_flops(c, [n + j - 1]))
    done = [rid for rid, r in reqs.items()
            if r.get("status") == "completed" and r.get("done") is not None
            and t0 < r["done"] <= t_end + 1e-9]
    sample = sample_requests(done, {rid: outcomes[rid]["tokens"] for rid in done}, seed,
                             t["check_tokens"])
    pairs = [(reqs[rid]["prompt"], outcomes[rid]["tokens"]) for rid in sample]
    gap = reference_gap(c, seed, pairs, device)
    return {
        "correct": bool(sample) and failed == 0, "attempted": len(sent), "failed": failed,
        "setup_s": setup["s"],
        "metrics": {"serve_output_tokens_per_s": out_tokens / window_s,
                    "serve_ttft_p95_ms": percentile(ttft, 95) * 1e3,
                    "serve_itl_p95_ms": percentile(gaps, 95) * 1e3},
        "checks": [["logit_gap", gap, cell.limits["logit_gap"]]],
        "memory_peak_bytes": peak,
        "ctx": {"config": c, "traffic": t, "window_s": window_s, "slots": slots,
                "served_flops": served_flops, "rest_s": t_end - rest0, "work": work,
                "spans": {"prefill": [d for t1, d in spans["prefill"] if t1 >= rest0],
                          "decode": [(d, a) for t1, d, a in spans["decode"] if t1 >= rest0]},
                "trace": capture.summary if capture is not None else None,
                "memory_peak_bytes": peak, "kv_live_bytes": kv_live[0] * position_bytes,
                "sample_pairs": pairs},
    }


def sample_requests(done: List[int], served: Dict[int, List[int]], seed: int,
                    want_tokens: int) -> List[int]:
    """The finished request with the most served tokens, then others
    drawn from the seed until ``want_tokens`` served tokens are held."""
    if not done:
        return []
    longest = max(done, key=lambda rid: (len(served[rid]), -rid))
    picked, total = [longest], len(served[longest])
    order = gen.rng(seed, 4).permutation(len(done))
    for i in order:
        rid = done[int(i)]
        if total >= want_tokens:
            break
        if rid != longest:
            picked.append(rid)
            total += len(served[rid])
    return picked


def reference_gap(c: Dict, seed: int, pairs, device, mode: str = "fp32") -> float:
    """The widest gap of a served token below the reference's best over
    ``pairs`` of (prompt, served tokens), the reference's weights made
    again from the seed."""
    from reference.llama_forward import forward_logits
    from reference.precision import NoTF32

    weights = dict(W.iter_leaves(W.llama_specs(c), seed, device))
    worst = 0.0
    with NoTF32():
        for prompt, served in pairs:
            seq = torch.tensor(list(prompt) + list(served[:-1]), device=device)
            logits = forward_logits(c, weights, seq, "fp32")[len(prompt) - 1:]
            if mode == "fp32":
                worst = max(worst, compare.logit_gap(logits, served))
            else:  # the control: the token the lower precision puts first
                low = forward_logits(c, weights, seq, mode)[len(prompt) - 1:]
                worst = max(worst, compare.logit_gap(logits, low.argmax(dim=-1).tolist()))
                del low
            del logits
    del weights
    gc.collect()
    return worst
