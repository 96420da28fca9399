"""Child processes of the port's multi-process serve tests.

    python tests/torch_serve_child.py rank <rank> <world> <port> <schedule>
    python tests/torch_serve_child.py replica
    python tests/torch_serve_child.py router <spec.json>

``rank``: one rank of a coordinated ``run_serve_resilient`` over a gloo
process group, with the faultsim schedule armed (the same text on every
rank; ``rank=`` selects where each fault fires); prints the ledger as one
JSON line.  ``replica``: one fleet replica (``serve_replica``) fed over
HTTP on ``VESCALE_SERVE_OPS_PORT`` until SIGTERM drains it.  Both serve the
tiny Llama of ``TINY`` from ``init_params(seed=0)`` on the CPU, so every
process holds the same weights.  ``router``: the port's journaled
``FleetRouter`` as the lease-holding leader over the replicas the spec
names (it waits for the spec file to appear, so its start-up can overlap
the test's own work); it submits the spec's wave and pumps until the armed
``router_kill`` (``VESCALE_FAULTSIM``) ends the process at a pump
boundary.  Imports nothing of JAX.
"""

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from vescale_tpu_torch.models import LlamaConfig, init_params  # noqa: E402
from vescale_tpu_torch.serve import (  # noqa: E402
    ContinuousBatchingScheduler,
    KVCacheConfig,
    PagedKVCache,
    Request,
    ServeEngine,
)

TINY = LlamaConfig(vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                   num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=64,
                   dtype=torch.float32)
CACHE = dict(num_slots=2, page_size=4, pages_per_slot=4)


def build(max_queue=None):
    """The tiny engine and a fresh scheduler on the CPU."""
    kc = KVCacheConfig(layers=TINY.num_hidden_layers, kv_heads=TINY.num_key_value_heads,
                       head_dim=TINY.head_dim, **CACHE)
    cache = PagedKVCache(kc, device="cpu")
    eng = ServeEngine(TINY, init_params(TINY, seed=0, device="cpu"), cache, device="cpu")
    return eng, ContinuousBatchingScheduler(cache, max_queue=max_queue)


def arrivals(n=6, seed=11):
    """Request i arrives at step 2*i with a seeded prompt of 3-5 tokens."""
    rng = np.random.default_rng(seed)
    return [(2 * i, Request(rid=i, prompt=tuple(int(x) for x in rng.integers(1, 60, 3 + i % 3)),
                            max_new_tokens=4 + i % 2, deadline_steps=40))
            for i in range(n)]


def ledger(res):
    """The outcomes as canonical JSON: status, tokens, replays, reason."""
    return json.dumps({str(rid): {k: o.get(k) for k in ("status", "tokens", "replays", "reason")}
                       for rid, o in sorted(res.outcomes.items())}, sort_keys=True)


def rank_main(rank, world, port, schedule):
    import torch.distributed as dist

    from vescale_tpu_torch.resilience import faultsim
    from vescale_tpu_torch.serve import run_serve_resilient

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        eng, sched = build(max_queue=8)
        inj = faultsim.arm(faultsim.parse_schedule(schedule))
        try:
            res = run_serve_resilient(engine=eng, scheduler=sched, arrivals=arrivals(),
                                      install_signal_handlers=False, barrier_timeout_s=60.0)
        finally:
            fired = {k: v for k, v in inj.fired_total.items() if v}
            faultsim.disarm()
        sched.ledger_check()
        print("RESULT " + json.dumps({"rank": rank, "status": res.status, "steps": res.steps,
                                      "counts": res.counts, "fired": fired,
                                      "ledger": ledger(res)}), flush=True)
    finally:
        dist.destroy_process_group()


def replica_main():
    from vescale_tpu_torch.serve import serve_replica

    eng, sched = build()
    res = serve_replica(engine=eng, scheduler=sched, linger_s=1.0, coordinate=False)
    print(f"replica done status={res.status} counts={json.dumps(res.counts)}", flush=True)


def router_main(spec_path):
    import time

    from vescale_tpu_torch.resilience import faultsim
    from vescale_tpu_torch.serve import FleetJournal, FleetRouter, HttpReplicaClient, LeaderLease

    # the spec appears when the test is ready: start-up overlaps its work
    deadline = time.monotonic() + 120.0
    while not os.path.exists(spec_path):
        if time.monotonic() > deadline:
            raise SystemExit(f"no spec at {spec_path}")
        time.sleep(0.05)
    with open(spec_path) as f:
        spec = json.load(f)
    faultsim.arm_from_env()
    lease = LeaderLease(spec["lease_path"], holder="leader", ttl_s=spec["ttl_s"])
    fr = FleetRouter(journal=FleetJournal(spec["journal_dir"]), lease=lease, **spec["router"])
    for rid, url in spec["replicas"].items():
        fr.add_replica(rid, HttpReplicaClient(url))
    deadline = time.monotonic() + 60.0
    while not all(h.feed is not None and h.breaker.state == "closed" for h in fr.replicas.values()):
        if time.monotonic() > deadline:
            raise SystemExit("replicas never answered")
        fr.poll(force=True)
        time.sleep(0.05)
    for rid, prompt, max_new in spec["wave"]:
        fr.submit(Request(rid=rid, prompt=tuple(prompt), max_new_tokens=max_new))
    while fr.pump() > 0:  # the armed router_kill ends the process here
        time.sleep(0.05)
    print("router finished without being killed", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    elif sys.argv[1] == "replica":
        replica_main()
    elif sys.argv[1] == "router":
        router_main(sys.argv[2])
    else:
        raise SystemExit(f"unknown role {sys.argv[1]!r}")
