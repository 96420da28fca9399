"""In-memory fleet fakes shared by the port's fleet tests.

Each fake is built for ONE package: it raises that package's
``ReplicaUnreachable`` (each router catches its own class), so one
scripted scenario runs through the JAX ``FleetRouter`` and the port's on
identical inputs.  The clock is a list the scenario advances; nothing
sleeps and nothing opens a socket.
"""

import json

import numpy as np

from vescale_tpu import serve as ref_serve
from vescale_tpu.serve import router as ref_router

from vescale_tpu_torch import serve as port_serve
from vescale_tpu_torch.serve import router as port_router

PACKAGES = {
    "ref": dict(serve=ref_serve, router=ref_router),
    "port": dict(serve=port_serve, router=port_router),
}


def feed(replica_id, *, queue=0, inflight=0, slots=4, p99=None, accepting=True,
         draining=False, serve_step=1, retry_after=0.01, tput=0.0, mfu=None):
    """A schema v2 ``/router`` feed (the fields the router reads)."""
    return {
        "schema_version": 2, "rank": 0, "draining": draining, "queue_depth": queue,
        "inflight": inflight, "slots": slots, "free_slots": max(0, slots - inflight),
        "pages": 16, "free_pages": 16,
        "ttft_s": {"p50": None, "p95": None, "p99": p99},
        "itl_s": {"p50": None, "p95": None, "p99": None},
        "shed_rate": 0.0, "retry_after_s": retry_after,
        "goodput_tokens_per_s": tput / 2, "throughput_tokens_per_s": tput, "mfu": mfu,
        "decode_steps": serve_step, "serve_step": serve_step, "uptime_s": 1.0,
        "replica_id": replica_id, "accepting": accepting,
    }


class FakeReplica:
    """A replica behind a scripted ``/router`` feed, ``/submit`` and
    ``/outcomes``.  ``log`` (shared across a fleet) records every accepted
    dispatch as (rid, replica, tag)."""

    def __init__(self, pkg, rid, log, **feed_kw):
        self.unreachable = PACKAGES[pkg]["router"].ReplicaUnreachable
        self.id = rid
        self.log = log
        self.alive = True
        self.feed_kw = dict(feed_kw)
        self.step = 0
        self.inflight = {}
        self.done = {}
        self.submit_response = None  # a dict here is returned instead of accepting
        self.wall_us = 0
        self.controls = []

    def _check(self):
        if not self.alive:
            raise self.unreachable(f"{self.id} is down")

    def poll_router(self):
        self._check()
        self.step += 1
        return feed(self.id, serve_step=self.step, inflight=len(self.inflight), **self.feed_kw)

    def poll_health(self):
        self._check()
        return {"ok": True, "wall_time_us": self.wall_us}

    def submit(self, payload):
        self._check()
        if self.submit_response is not None:
            return dict(self.submit_response)
        self.inflight[payload["rid"]] = payload
        self.log.append((payload["rid"], self.id, payload.get("tag")))
        return {"accepted": True, "queue_depth": 0, "retry_after_s": 0.01}

    def outcomes(self):
        self._check()
        return {"outcomes": json.loads(json.dumps(self.done))}

    def finish(self, rid, status="completed", **extra):
        p = self.inflight.pop(rid)
        toks = [int(rid) % 7 + k for k in range(p.get("max_new_tokens", 1))]
        self.done[str(rid)] = {"status": status, "tokens": toks if status == "completed" else [],
                               "replays": 0, "tag": p.get("tag"), **extra}

    def finish_all(self):
        for rid in list(self.inflight):
            self.finish(rid)


def make_router(pkg, replicas, t, **kw):
    """A ``FleetRouter`` of ``pkg`` on the fake clock ``t`` (a one-element
    list; sleeping advances it)."""
    defaults = dict(poll_interval_s=0.0, breaker_failures=2, breaker_cooldown_s=1.0,
                    health_stale_s=0.0, dispatch_retries=3, backoff_s=0.01,
                    backoff_max_s=0.1, hedge_s=0.0,
                    now_fn=lambda: t[0], sleep_fn=lambda s: t.__setitem__(0, t[0] + s))
    defaults.update(kw)
    fr = PACKAGES[pkg]["serve"].FleetRouter(**defaults)
    for r in replicas:
        fr.add_replica(r.id, r)
    return fr


def seeded_requests(pkg, n, seed=0, base=0):
    """``n`` requests of 2-5 prompt tokens and 1-4 new tokens, from numpy."""
    rng = np.random.default_rng(seed)
    Request = PACKAGES[pkg]["serve"].Request
    out = []
    for i in range(n):
        prompt = tuple(int(x) for x in rng.integers(1, 60, int(rng.integers(2, 6))))
        out.append(Request(rid=base + i, prompt=prompt, max_new_tokens=int(rng.integers(1, 5))))
    return out


def run_scenario(pkg, journal=None, lease=None):
    """The router scenario the port is held to: polls, a replica whose
    polls fail, a replica that rejects submits with ``retry_after_s`` and
    one that sheds an outcome, session affinity, hedging, a deadline that
    expires, a fleet-level shed and a breaker that heals.  Returns the
    router, the fleet and the dispatch log."""
    t = [0.0]
    log = []
    a, b, c = (FakeReplica(pkg, r, log) for r in ("a", "b", "c"))
    kw = {}
    if journal is not None:
        kw.update(journal=journal, lease=lease)
    fr = make_router(pkg, [a, b, c], t, hedge_s=0.5, **kw)
    b.alive = False  # every poll and submit of b fails
    c.submit_response = {"accepted": False, "retry_after_s": 0.2}
    fr.poll(force=True)
    fr.poll(force=True)  # b's second failure opens its breaker
    reqs = seeded_requests(pkg, 8, seed=3)
    for i, r in enumerate(reqs[:6]):
        fr.submit(r, session=(f"s{i % 3}" if i % 2 == 0 else None))
    t[0] += 0.2
    a.finish(reqs[0].rid)
    fr.pump()
    t[0] += 0.3
    c.submit_response = None  # c takes work again
    a.finish(reqs[1].rid, status="shed", retry_after_s=0.05)  # replica-level shed: spill to c
    fr.pump()
    t[0] += 0.6  # past the hedge bound: the rest still on a get a second copy on c
    fr.pump()
    c.finish_all()  # the hedged copies win on c
    fr.pump()
    a.finish_all()  # the losers' rows come back late and change nothing
    fr.pump()
    # a wall deadline that expires with the request live
    fr.submit(reqs[6], deadline_s=0.3)
    t[0] += 0.4
    fr.pump()
    # fleet-level shed: every healthy replica stops accepting
    a.feed_kw["accepting"] = c.feed_kw["accepting"] = False
    fr.poll(force=True)
    fr.submit(reqs[7])
    a.feed_kw["accepting"] = c.feed_kw["accepting"] = True
    # b comes back: the half-open probe readmits it
    b.alive = True
    t[0] += 1.0
    fr.poll(force=True)
    for r in seeded_requests(pkg, 9, seed=4, base=100):
        fr.submit(r, session=(f"k{r.rid}" if r.rid % 3 else None))
    # c dies with work on it: two failed polls open its breaker and its
    # requests fail over from the prompt
    c.alive = False
    fr.pump()
    fr.pump()
    for rep in (a, b):
        rep.finish_all()
    t[0] += 0.1
    for _ in range(4):
        if fr.pump() == 0:
            break
        t[0] += 0.1
        for rep in (a, b):
            rep.finish_all()
    return fr, {"a": a, "b": b, "c": c}, log


def ledger_view(fr):
    """The ledger's records, comparable across the packages."""
    out = {}
    for rid, rec in sorted(fr.ledger.records.items()):
        out[rid] = dict(status=rec.status, replica=rec.replica,
                        tokens=list((rec.outcome or {}).get("tokens") or ()),
                        reason=(rec.outcome or {}).get("reason"),
                        attempts=[r for r, _ in rec.attempts], tags=dict(rec.tag_by_replica),
                        resubmissions=rec.resubmissions, failovers=rec.failovers,
                        hedged=rec.hedged, session=rec.session)
    return out


def transitions_view(fr):
    return [(t["replica"], t["from"], t["to"], t["reason"]) for t in fr.breaker_transitions]


def fleet_counters(registry):
    return {k: v for k, v in registry.snapshot()["counters"].items() if k.startswith("fleet_")}
