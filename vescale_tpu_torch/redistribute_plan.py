"""Multi-hop redistribution planner: composite transitions without the
logical tensor.

The port of ``vescale_tpu/redistribute_plan.py``.  ``redistribute()``
serves a transition its hop engine moves in one pass (``redistribute.plan``
with no pass through Replicate); a composite one (an axis-swap cycle, some
Partial/reshard combinations, interleave changes on several mesh dims, a
cross-mesh move) used to go through Replicate and may hold the logical
tensor on every rank.  This module decomposes it into a short sequence of
per-shard hops instead ("Memory-efficient array redistribution through
portable collective communication", arXiv:2112.01075), choosing among
candidate sequences by a cost model after "On Optimizing the Communication
of Model Parallelism" (arXiv:2211.05322).

Search: a bounded Dijkstra (at most ``VESCALE_REDISTRIBUTE_MAX_HOPS``
hops, default 3) over the lattice that ``placements.transition_candidates``
spans per mesh dim (the endpoints, plain-Shard relaxations of interleaves,
Replicate).  Edges are the transfer module's single hops (their feasibility
is the reference's, so the graph is the reference's):

  dense        transfer.transition_fn
  ragged       transfer.ragged_transition_fn
  interleaved  transfer.interleaved_transition_fn
  reshard      a plain unpadded same-mesh respec: one all-to-all-v of the
               elements each pair of ranks shares (``redistribute._exchange``)
  device_put   the cross-mesh bridge between plain unpadded specs, the same
               all-to-all-v over every rank
  quant        the int8 variant of a dense hop (``VESCALE_REDISTRIBUTE_QUANT``)

Memory contract: every intermediate's per-shard bytes (the reference's
physical shard, ``physical_shard_bytes``) stay within
``VESCALE_REDISTRIBUTE_MEM_FACTOR`` (default 4) times the larger endpoint
shard.  Cost: bytes moved a hop times a per-collective weight, plus a flat
latency term a hop, so equal-byte plans prefer fewer hops.  With a
calibration table armed (``telemetry/calibrate.py``) every wire op is
priced in measured microseconds instead, an op with no bucket by
``collectives.analytic_cost_us``.  These costs do not depend on the
framework: in byte-weight mode the port chooses the reference's hops.

Plans, and declines with their ``VSC12x`` code, are kept in an LRU keyed
by src, dst, the knobs, the calibration digest and the quant signature.
Nothing is traced here, so a plan holds its hops' functions.  Counters
``redistribute.plan_hits`` / ``plan_misses`` / ``hops`` /
``bytes_moved_total`` and the gauge ``redistribute.bytes_moved`` go to
``telemetry.registry.GLOBAL`` (where ``redistribute.fallbacks`` counts)
and, while telemetry is live, to its registry; they read
``plan_comm_summary``, the accounting ``debug.CommDebugMode.attribute_plan``
reads too.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from . import config
from .placements import transition_candidates
from .spec import DArraySpec, innermost_chunk

__all__ = [
    "PlanHop",
    "RedistributePlan",
    "Decline",
    "plan_redistribute",
    "decline_reason",
    "decline_finding",
    "quant_single_hop_plan",
    "quant_outcome",
    "quant_decline_finding",
    "plan_comm_summary",
    "can_redistribute_per_shard",
    "clear_plan_cache",
    "plan_cache_stats",
    "physical_shard_bytes",
]


@dataclasses.dataclass(frozen=True)
class Decline:
    """A planner decline: a ``VSC12x`` code of the findings vocabulary
    (``analysis/findings.py``) and the reason."""

    code: str  # "VSC120".."VSC127"
    message: str

    def __str__(self) -> str:
        return f"[{self.code}] {self.message}"

    def finding(self):
        from .analysis.findings import CODES, Finding

        return Finding(CODES[self.code], self.message)


# per-byte weights on a ring: an all-to-all keeps each link at 1/n of the
# payload, a reduce-scatter streams the ring once, an all-gather delivers
# (n-1)/n of the output to every rank, an all-reduce is both; a reshard
# and the cross-mesh bridge move at most a destination shard a rank.
_WEIGHTS = {
    "all_to_all": 1.0,
    "collective_permute": 1.0,
    "reduce_scatter": 2.0,
    "all_gather": 4.0,
    "all_reduce": 6.0,
    "reshard": 2.0,
    "device_put": 2.0,
}
# the flat latency a hop (in byte-cost units): at equal bytes, fewer hops
_HOP_LATENCY = 64 * 1024

# the int8 hops: each tagged op priced at the wire pattern it runs (the
# quantized all-reduce gathers packed payloads, the quantized
# reduce-scatter is an all-to-all), plus one unit a byte the quantize and
# dequantize passes touch
_QWEIGHTS = {
    "all_reduce:int8": 4.0,
    "all_gather:int8": 4.0,
    "reduce_scatter:int8": 1.0,
    "all_to_all:int8": 1.0,
}
_QUANT_COMPUTE_WEIGHT = 1.0

# calibrated mode: an edge's wire kind -> (measured op, conservatism factor)
_CAL_OP = {
    "all_to_all": ("all_to_all", 1.0),
    "collective_permute": ("all_to_all", 1.0),
    "reduce_scatter": ("reduce_scatter", 1.0),
    "all_gather": ("all_gather", 1.0),
    "all_reduce": ("all_reduce", 1.0),
    "reshard": ("all_to_all", 2.0),
    "device_put": ("all_to_all", 2.0),
    "all_reduce:int8": ("all_gather", 1.0),
    "all_gather:int8": ("all_gather", 1.0),
    "reduce_scatter:int8": ("all_to_all", 1.0),
    "all_to_all:int8": ("all_to_all", 1.0),
}


# ---------------------------------------------------- the physical shard
def _body_axes(spec: DArraySpec):
    """The reference's body axes: ``(mesh dims, extent, chunk, padded)``
    per physical axis (an interleaved dim is two: its ``m`` sections, then
    the sharded section extent); none for a ragged spec."""
    lay = spec.layout()
    if lay.ragged is not None:
        return []
    inter = dict(lay.interleaves)
    out = []
    for d, s in enumerate(spec.shape):
        if d in inter:
            m = inter[d]
            out.append(((), m, m, m))
            s = s // m
        dims = lay.dim_mesh_dims[d]
        sizes = [spec.mesh.shape[i] for i in dims]
        chunk = innermost_chunk(s, sizes) if dims else s
        padded = chunk
        for n in sizes:
            padded *= n
        out.append((tuple(dims), s, chunk, padded))
    return out


def physical_shard_bytes(spec: DArraySpec) -> int:
    """Bytes a rank of the reference's physical layout: each sharded axis
    at its (ceil) chunk, a ragged spec at its largest cell.  The quantity
    the memory budget bounds."""
    from .spec import _itemsize

    lay = spec.layout()
    if lay.ragged is not None:
        n = lay.cell_pad
    else:
        n = 1
        for _dims, _ext, chunk, _pad in _body_axes(spec):
            n *= chunk
    return n * _itemsize(spec.dtype)


def _any_padded(spec: DArraySpec) -> bool:
    return any(padded != ext for _d, ext, _c, padded in _body_axes(spec))


def _cal_table(mesh):
    from .telemetry import calibrate as _cal

    return _cal.table_for(mesh)


def _cal_key():
    from .telemetry import calibrate as _cal

    return _cal.active_digest()


def _cal_wire_us(table, kind: str, nbytes: float, n: int) -> float:
    """One wire op in measured microseconds (analytic for a missing
    bucket); ``nbytes`` is the per-rank operand payload."""
    from . import collectives as C
    from .telemetry import calibrate as _cal

    op, scale = _CAL_OP[kind]
    us = _cal.table_cost_us(table, op, n, nbytes)
    if us is None:
        us = C.analytic_cost_us(op, float(nbytes) / 1e9, n)
    return us * scale


def _hop_lat(table) -> float:
    if table is None:
        return _HOP_LATENCY
    from .telemetry import calibrate as _cal

    return _cal.hop_latency_us()


def _edge_fanin(src: DArraySpec, dst: DArraySpec) -> int:
    """The largest mesh dim the transition changes, else the largest."""
    ns = [src.mesh.shape[i] for i, (s, d) in enumerate(zip(src.placements, dst.placements))
          if s != d]
    return max(ns) if ns else max(src.mesh.shape)


def _mem_factor() -> float:
    return config.get_float("VESCALE_REDISTRIBUTE_MEM_FACTOR")


def _max_hops() -> int:
    return config.get_int("VESCALE_REDISTRIBUTE_MAX_HOPS")


def _quant_sig():
    """The quant hop's knobs (None while the gate is off): part of every
    cache key."""
    if not config.get_bool("VESCALE_REDISTRIBUTE_QUANT"):
        return None
    from .quant.blockscale import DEFAULT_BLOCK

    block = config.get_int("VESCALE_GRAD_COMPRESS_BLOCK") or DEFAULT_BLOCK
    rounding = "stochastic" if config.get_bool("VESCALE_GRAD_COMPRESS_SR") else "nearest"
    seed = config.get_int("VESCALE_GRAD_COMPRESS_SEED") or 0
    return (int(block), rounding, int(seed))


def _count(name: str, n: float = 1) -> None:
    from . import telemetry as _tel
    from .telemetry.registry import GLOBAL

    GLOBAL.count(name, n)
    _tel.count(name, n)


def _gauge(name: str, value: float) -> None:
    from . import telemetry as _tel
    from .telemetry.registry import GLOBAL

    GLOBAL.set_gauge(name, value)
    _tel.set_gauge(name, value)


@dataclasses.dataclass
class PlanHop:
    """One per-shard move of a plan."""

    kind: str  # "dense" | "ragged" | "interleaved" | "reshard" | "device_put" | "quant"
    src: DArraySpec
    dst: DArraySpec
    fn: object  # darray(src) -> darray(dst); None for reshard/device_put
    collectives: Dict[str, int]  # the collective kinds it issues (static view)
    bytes_moved: int  # bytes on the wire a rank (the cost model's estimate)
    cost: float
    bytes_raw: int = 0  # quant hops: what the unquantized ops would move

    def apply(self, d):
        if self.kind in ("reshard", "device_put"):
            from .redistribute import _exchange_world

            return _exchange_world(d, self.src, self.dst)
        return self.fn(d)


@dataclasses.dataclass
class RedistributePlan:
    src: DArraySpec
    dst: DArraySpec
    hops: Tuple[PlanHop, ...]
    # the cost auditor's id of this plan's prediction (None while dormant)
    plan_id: Optional[int] = None

    @property
    def bytes_moved(self) -> int:
        return sum(h.bytes_moved for h in self.hops)

    @property
    def total_cost(self) -> float:
        return sum(h.cost for h in self.hops)

    def execute(self, d):
        """Run the hops on a DArray laid out as ``src``; count the plan's
        hops and bytes.  With the cost auditor live and a ledgered price,
        each hop runs synchronized in a span carrying the calibration tags
        and the chain's wall time joins the prediction."""
        from .telemetry import costaudit as _ca

        if self.plan_id is not None and _ca.is_active():
            d = self._execute_measured(d, _ca)
        else:
            for hop in self.hops:
                d = hop.apply(d)
        summary = plan_comm_summary(self)
        _count("redistribute.hops", len(self.hops))
        _count("redistribute.bytes_moved_total", summary["bytes_moved"])
        _gauge("redistribute.bytes_moved", summary["bytes_moved"])
        qhops = [h for h in self.hops if h.kind == "quant"]
        if qhops:
            _count("redistribute.quant_hops", len(qhops))
            _count("grad_compress_bytes_saved_total",
                   sum(max(0, h.bytes_raw - h.bytes_moved) for h in qhops))
        return d

    def _execute_measured(self, d, _ca):
        import time as _time

        import torch

        from .ndtimeline.api import ndtimeit

        def sync(x):
            if x.to_local().is_cuda:
                torch.cuda.synchronize(x.to_local().device)
            return x

        t0 = _time.perf_counter()
        for hop in self.hops:
            op = None
            if hop.collectives:
                wire = max(hop.collectives.items(), key=lambda kv: kv[1])[0]
                op = _CAL_OP.get(wire, (wire, 1.0))[0]
            elif hop.kind in _CAL_OP:
                op = _CAL_OP[hop.kind][0]
            if op is None:  # a slice or seed: no wire time to harvest
                d = hop.apply(d)
                continue
            sb, db = physical_shard_bytes(hop.src), physical_shard_bytes(hop.dst)
            payload = sb if op in ("all_gather", "reduce_scatter") else max(sb, db)
            with ndtimeit("redistribute-hop", tags={
                    "collective_op": op, "axis_size": _edge_fanin(hop.src, hop.dst),
                    "bytes": int(payload), "plan_id": self.plan_id}):
                d = sync(hop.apply(d))
        _ca.record_measurement(self.plan_id, measured_us=(_time.perf_counter() - t0) * 1e6)
        return d


def plan_comm_summary(plan: RedistributePlan) -> Dict:
    """A plan's collectives and bytes, hop by hop: what the telemetry
    gauge and ``CommDebugMode.attribute_plan`` both read."""
    hops = []
    collectives: Dict[str, int] = {}
    for i, h in enumerate(plan.hops):
        for k, v in h.collectives.items():
            collectives[k] = collectives.get(k, 0) + v
        hops.append({
            "hop": i,
            "kind": h.kind,
            "src": [str(p) for p in h.src.placements],
            "dst": [str(p) for p in h.dst.placements],
            "collectives": dict(h.collectives),
            "bytes_moved": h.bytes_moved,
        })
    return {
        "hops": hops,
        "n_hops": len(hops),
        "bytes_moved": sum(h.bytes_moved for h in plan.hops),
        "collectives": collectives,
    }


# ------------------------------------------------------------ edges
def _dense_edge(src: DArraySpec, dst: DArraySpec, build: bool) -> Optional[PlanHop]:
    from .transfer import _plan_ops, transition_fn

    ops = _plan_ops(src, dst)
    if ops is None:
        return None
    colls: Dict[str, int] = {}
    bytes_m = 0
    cost = 0.0
    table = _cal_table(src.mesh)
    sb, db = physical_shard_bytes(src), physical_shard_bytes(dst)
    for op in ops:
        kind, i = op[0], op[1]
        n = src.mesh.shape[i]
        f = (n - 1) / max(1, n)
        # b: the ring-scaled wire bytes; payload: the per-rank operand the
        # calibration table is keyed by
        if kind == "reduce":
            b, c, payload = 2 * f * max(sb, db), "all_reduce", max(sb, db)
        elif kind == "reduce_scatter":
            b, c, payload = f * sb, "reduce_scatter", sb
        elif kind == "gather":
            b, c, payload = f * db, "all_gather", sb
        elif kind == "move":
            b, c, payload = f * max(sb, db), "all_to_all", max(sb, db)
        else:  # slice / seed: no wire traffic
            continue
        colls[c] = colls.get(c, 0) + 1
        bytes_m += int(b)
        cost += _WEIGHTS[c] * b if table is None else _cal_wire_us(table, c, payload, n)
    return PlanHop("dense", src, dst, transition_fn(src, dst) if build else None, colls,
                   bytes_m, cost + _hop_lat(table))


def _ragged_edge(src: DArraySpec, dst: DArraySpec, build: bool) -> Optional[PlanHop]:
    if not (src.has_ragged() or dst.has_ragged()):
        return None
    from .transfer import ragged_transition_fn

    fn = ragged_transition_fn(src, dst)
    if fn is None:
        return None
    sb, db = physical_shard_bytes(src), physical_shard_bytes(dst)
    if src.has_ragged() and dst.is_replicated():
        colls, b, kind = {"all_gather": 1}, db, "all_gather"
    elif src.is_replicated() and dst.has_ragged():
        colls, b, kind = {}, 0, None  # slice-v: local
    else:  # all-to-all-v
        colls, b, kind = {"collective_permute": 1}, max(sb, db), "collective_permute"
    table = _cal_table(src.mesh)
    if kind is None:
        wire = 0.0
    elif table is None:
        wire = _WEIGHTS["all_to_all" if kind == "collective_permute" else kind] * b
    else:
        payload = sb if kind == "all_gather" else b
        wire = _cal_wire_us(table, kind, payload, _edge_fanin(src, dst))
    return PlanHop("ragged", src, dst, fn if build else None, colls, int(b),
                   wire + _hop_lat(table))


def _interleaved_edge(src: DArraySpec, dst: DArraySpec, build: bool) -> Optional[PlanHop]:
    if not (src.layout().interleaves or dst.layout().interleaves):
        return None
    from .transfer import interleaved_transition_fn

    fn = interleaved_transition_fn(src, dst)
    if fn is None:
        return None
    b = max(physical_shard_bytes(src), physical_shard_bytes(dst))
    table = _cal_table(src.mesh)
    wire = (_WEIGHTS["all_to_all"] * b if table is None
            else _cal_wire_us(table, "collective_permute", b, _edge_fanin(src, dst)))
    return PlanHop("interleaved", src, dst, fn if build else None, {"collective_permute": 1},
                   int(b), wire + _hop_lat(table))


def _reshard_edge(src: DArraySpec, dst: DArraySpec) -> Optional[PlanHop]:
    """A plain unpadded same-mesh respec (each rank's piece is its block
    of the logical tensor on both sides): one all-to-all-v.  The edge that
    reaches nested-Shard endpoints no other hop produces."""
    if src.mesh != dst.mesh:
        return None
    for s in (src, dst):
        if s.has_partial() or s.has_ragged() or s.layout().interleaves or _any_padded(s):
            return None
    b = max(physical_shard_bytes(src), physical_shard_bytes(dst))
    table = _cal_table(src.mesh)
    wire = (_WEIGHTS["reshard"] * b if table is None
            else _cal_wire_us(table, "reshard", b, _edge_fanin(src, dst)))
    return PlanHop("reshard", src, dst, None, {"reshard": 1}, int(b), wire + _hop_lat(table))


def _quant_edge(src: DArraySpec, dst: DArraySpec, build: bool) -> Optional[PlanHop]:
    """The lossy quantize -> move -> dequantize hop: the dense edge's plan
    with every wire op on int8 payloads, priced at the packed bytes plus
    the quantize/dequantize passes; taken only where it is cheaper."""
    sig = _quant_sig()
    if sig is None:
        return None
    from .transfer import quant_plan_info, quant_transition_fn

    block, rounding, _seed = sig
    info = quant_plan_info(src, dst, block)
    if info is None:
        return None
    _ops, colls, q_bytes, raw_bytes, compute_bytes, wire_detail = info
    table = _cal_table(src.mesh)
    if table is None:
        cost = _QUANT_COMPUTE_WEIGHT * compute_bytes
        for tag, q_op_bytes, _n, _p in wire_detail:
            cost += _QWEIGHTS[tag] * q_op_bytes
    else:
        from .telemetry import calibrate as _cal

        cost = _cal.compute_cost_us(compute_bytes)
        for tag, _q, n, payload in wire_detail:
            cost += _cal_wire_us(table, tag, payload, n)
    fn = None
    if build:
        base = quant_transition_fn(src, dst, block, rounding)
        if rounding == "stochastic":
            from .collectives import next_sr_key

            def fn(d, _base=base):  # a fresh, replayable key each run
                return _base(d, next_sr_key())
        else:
            fn = base
    return PlanHop("quant", src, dst, fn, colls, int(q_bytes), cost + _hop_lat(table),
                   int(raw_bytes))


def _edge(src: DArraySpec, dst: DArraySpec, build: bool = False) -> Optional[PlanHop]:
    """The cheapest single hop src -> dst, or None; the quant hop competes
    with the dense one on cost, the other kinds in priority order."""
    dense = _dense_edge(src, dst, build)
    quant = _quant_edge(src, dst, build)
    if dense is not None and quant is not None:
        return quant if quant.cost < dense.cost else dense
    if dense is not None or quant is not None:
        return dense if dense is not None else quant
    return (_ragged_edge(src, dst, build) or _interleaved_edge(src, dst, build)
            or _reshard_edge(src, dst))


# ------------------------------------------------------------ search
def _candidate_specs(src: DArraySpec, dst: DArraySpec) -> List[DArraySpec]:
    per_dim = [transition_candidates(sp, dp) for sp, dp in zip(src.placements, dst.placements)]
    out: List[DArraySpec] = []
    for combo in itertools.product(*per_dim):
        spec = DArraySpec(src.mesh, combo, src.meta)
        try:
            spec.layout()  # composition validity
        except ValueError:
            continue
        out.append(spec)
    return out


def _search_same_mesh(src: DArraySpec, dst: DArraySpec
                      ) -> Tuple[Optional[List[PlanHop]], Optional[Decline]]:
    """Bounded Dijkstra src -> dst over the candidate lattice: (hops, None)
    or (None, decline)."""
    nodes = _candidate_specs(src, dst)
    if dst not in nodes:
        nodes.append(dst)
    budget = _mem_factor() * max(physical_shard_bytes(src), physical_shard_bytes(dst))
    node_bytes = {n: physical_shard_bytes(n) for n in nodes}
    max_hops = _max_hops()
    over_budget = False

    # keyed by (spec, hops): a cheap deep route must not shadow a costlier
    # shallow one that still has hops left to reach dst
    best: Dict[Tuple[DArraySpec, int], float] = {(src, 0): 0.0}
    tie = itertools.count()
    heap: List = [(0.0, 0, next(tie), src, [])]
    edge_cache: Dict[Tuple[DArraySpec, DArraySpec], Optional[PlanHop]] = {}
    while heap:
        cost, hops, _, spec, path = heapq.heappop(heap)
        if spec == dst:
            return path, None
        if hops >= max_hops or cost > best.get((spec, hops), float("inf")):
            continue
        for nxt in nodes:
            if nxt == spec:
                continue
            if nxt != dst and node_bytes[nxt] > budget:
                over_budget = True
                continue
            key = (spec, nxt)
            if key not in edge_cache:
                edge_cache[key] = _edge(spec, nxt)
            e = edge_cache[key]
            if e is None:
                continue
            c = cost + e.cost
            if c < min(best.get((nxt, h), float("inf")) for h in range(hops + 2)):
                best[(nxt, hops + 1)] = c
                heapq.heappush(heap, (c, hops + 1, next(tie), nxt, path + [e]))
    if over_budget:
        return None, Decline("VSC120", (
            "every candidate path needs an intermediate above the per-shard "
            f"memory budget ({_mem_factor():g}x the larger endpoint shard; "
            "raise VESCALE_REDISTRIBUTE_MEM_FACTOR to trade memory for locality)"))
    return None, Decline(
        "VSC121", f"no per-shard hop sequence within {max_hops} hops over the candidate lattice")


def _materialize(hops: List[PlanHop]) -> Tuple[PlanHop, ...]:
    """The winning path's hops with their functions (losing edges never
    build one)."""
    return tuple(h if h.kind in ("reshard", "device_put") else _edge(h.src, h.dst, build=True)
                 for h in hops)


def _unpadded_bridge(spec: DArraySpec) -> Optional[DArraySpec]:
    """A plain (no Partial, interleave or ragged) unpadded spec on
    ``spec``'s mesh, the cross-mesh bridge's endpoint: the plain form, with
    padded Shard dims relaxed to Replicate."""
    from .placements import InterleavedShard, Replicate, Shard

    if spec.has_ragged():
        return None
    base = tuple(Shard(p.dim) if isinstance(p, InterleavedShard)
                 else Replicate() if p.is_partial() else p for p in spec.placements)
    cand = DArraySpec(spec.mesh, base, spec.meta)
    if not _any_padded(cand):
        return cand
    out = list(base)
    for dims, ext, _chunk, padded in _body_axes(cand):
        if padded != ext:
            for i in dims:
                out[i] = Replicate()
    cand = DArraySpec(spec.mesh, tuple(out), spec.meta)
    return None if _any_padded(cand) else cand


def _plan_cross_mesh(src: DArraySpec, dst: DArraySpec
                     ) -> Tuple[Optional[RedistributePlan], Optional[Decline]]:
    """Strip src to a plain unpadded spec on its mesh, move the pieces
    across, dress them as dst on the other mesh: never the logical value."""
    mid = _unpadded_bridge(src)
    dmid = _unpadded_bridge(dst)
    if mid is None or dmid is None:
        return None, Decline(
            "VSC122", "cross-mesh: a side has no plain unpadded per-shard bridge form")
    budget = _mem_factor() * max(physical_shard_bytes(src), physical_shard_bytes(dst))
    for s in (mid, dmid):
        if s not in (src, dst) and physical_shard_bytes(s) > budget:
            return None, Decline("VSC123", (
                "cross-mesh: the unpadded bridge spec exceeds the per-shard "
                f"memory budget ({_mem_factor():g}x the larger endpoint shard; "
                "raise VESCALE_REDISTRIBUTE_MEM_FACTOR to trade memory for locality)"))
    hops: List[PlanHop] = []
    if mid != src:
        sub, reason = _search_same_mesh(src, mid)
        if sub is None:
            return None, Decline("VSC124", f"cross-mesh: source-side strip failed — {reason}")
        hops.extend(sub)
    table = _cal_table(dmid.mesh)
    db = physical_shard_bytes(dmid)
    bridge_cost = (_WEIGHTS["device_put"] * db if table is None
                   else _cal_wire_us(table, "device_put", db, max(dmid.mesh.shape)))
    hops.append(PlanHop("device_put", mid, dmid, None, {"device_put": 1}, int(db),
                        bridge_cost + _hop_lat(table)))
    if dmid != dst:
        sub, reason = _search_same_mesh(dmid, dst)
        if sub is None:
            return None, Decline(
                "VSC125", f"cross-mesh: destination-side dress failed — {reason}")
        hops.extend(sub)
    return RedistributePlan(src, dst, _materialize(hops)), None


# ------------------------------------------------------------ the caches
class _LRU:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            if key not in self._d:
                return None
            self._d.move_to_end(key)
            return self._d[key]

    def put(self, key, value) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._d

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


_PLANS = _LRU(512)
_DECLINES = _LRU(512)
_QUANT_DECLINES = _LRU(512)


def _key(src: DArraySpec, dst: DArraySpec, sig=None):
    return (src, dst, _mem_factor(), _max_hops(), _quant_sig() if sig is None else sig,
            _cal_key())


def _record_quant_outcome(key, src: DArraySpec, dst: DArraySpec, plan) -> None:
    """With the quant gate on, a pair's plan carries a quant hop or a
    ``VSC127`` decline says why not."""
    if any(h.kind == "quant" for h in (plan.hops if plan is not None else ())):
        return
    q = _quant_edge(src, dst, build=False)
    if q is None:
        reason = ("no quantizable wire plan for this pair (non-float dtype, "
                  "non-sum/avg reduction, ragged/interleaved layout, or no wire op)")
    else:
        d = _dense_edge(src, dst, build=False)
        if d is not None and d.cost <= q.cost:
            reason = (f"cost model: quantized hop costs {q.cost:.3g} vs {d.cost:.3g} "
                      "unquantized (packed bytes + quantize/dequantize compute do "
                      "not beat the dense wire pattern here)")
        else:
            reason = "cost model prefers an unquantized multi-hop route"
    _QUANT_DECLINES.put(key, Decline("VSC127", reason))


def _record_plan_prediction(plan: RedistributePlan, kind: str = "redistribute"):
    """Ledger a priced plan with the cost auditor (microseconds under a
    calibrated table, weighted bytes otherwise); the plan id or None."""
    from .telemetry import costaudit as _ca

    digest = _cal_key()
    return _ca.record_prediction(
        kind,
        predicted_us=plan.total_cost if digest is not None else None,
        predicted_bytes=plan.bytes_moved,
        digest=digest,
        unit="us" if digest is not None else "weighted_bytes",
        detail={"hops": len(plan.hops), "kinds": [h.kind for h in plan.hops]},
    )


def plan_redistribute(src: DArraySpec, dst: DArraySpec) -> Optional[RedistributePlan]:
    """A cached multi-hop plan for src -> dst, or None (``decline_reason``
    says why).  ``redistribute()`` asks it after the single hop declines."""
    from .telemetry import costaudit as _ca

    key = _key(src, dst)
    plan = _PLANS.get(key)
    if plan is not None:
        _count("redistribute.plan_hits")
        if plan.plan_id is None and _ca.is_active():
            plan.plan_id = _record_plan_prediction(plan)
        return plan
    if _DECLINES.get(key) is not None:
        return None
    _count("redistribute.plan_misses")
    if src.mesh != dst.mesh:
        plan, reason = _plan_cross_mesh(src, dst)
    else:
        hops, reason = _search_same_mesh(src, dst)
        plan = RedistributePlan(src, dst, _materialize(hops)) if hops is not None else None
    if _quant_sig() is not None:
        _record_quant_outcome(key, src, dst, plan)
    if plan is None:
        _DECLINES.put(key, reason or Decline("VSC121", "unknown"))
        return None
    plan.plan_id = _record_plan_prediction(plan)
    _PLANS.put(key, plan)
    return plan


_NOT_CONSULTED = Decline("VSC126", "planner was not consulted for this pair")


def decline_finding(src: DArraySpec, dst: DArraySpec) -> Decline:
    """The recorded decline for (src, dst); VSC126 when the planner never
    saw the pair."""
    d = _DECLINES.get(_key(src, dst))
    return d if d is not None else _NOT_CONSULTED


def quant_single_hop_plan(src: DArraySpec, dst: DArraySpec) -> Optional[RedistributePlan]:
    """The int8 overlay for single-hop pairs: with
    ``VESCALE_REDISTRIBUTE_QUANT`` on, ``redistribute()`` asks this first;
    a one-hop quant plan where the cost model prefers it, else None with a
    ``VSC127`` decline recorded.  Cached with the plans."""
    sig = _quant_sig()
    if sig is None or src.mesh != dst.mesh or src == dst:
        return None
    key = _key(src, dst, sig)
    plan = _PLANS.get(key)
    if plan is not None:
        from .telemetry import costaudit as _ca

        _count("redistribute.plan_hits")
        if plan.plan_id is None and _ca.is_active():
            plan.plan_id = _record_plan_prediction(plan, kind="redistribute_quant")
        return plan if any(h.kind == "quant" for h in plan.hops) else None
    if key in _QUANT_DECLINES:
        return None
    q = _quant_edge(src, dst, build=False)
    d = _dense_edge(src, dst, build=False)
    if q is not None and (d is None or q.cost < d.cost):
        plan = RedistributePlan(src, dst, (_quant_edge(src, dst, build=True),))
        plan.plan_id = _record_plan_prediction(plan, kind="redistribute_quant")
        _PLANS.put(key, plan)
        return plan
    _record_quant_outcome(key, src, dst, None)
    return None


def quant_outcome(src: DArraySpec, dst: DArraySpec):
    """The quant hop's decision for one pair, building nothing:
    ``("taken", PlanHop)``, ``("declined", Decline)``, or None when the
    gate is off or the meshes differ (shardcheck's VSC128 / VSC127)."""
    sig = _quant_sig()
    if sig is None or src.mesh != dst.mesh or src == dst:
        return None
    q = _quant_edge(src, dst, build=False)
    d = _dense_edge(src, dst, build=False)
    if q is not None and (d is None or q.cost < d.cost):
        return ("taken", q)
    key = _key(src, dst, sig)
    _record_quant_outcome(key, src, dst, None)
    return ("declined", _QUANT_DECLINES.get(key))


def quant_decline_finding(src: DArraySpec, dst: DArraySpec) -> Optional[Decline]:
    """Why a planned pair took no quant hop (``VSC127``), or None."""
    sig = _quant_sig()
    if sig is None:
        return None
    return _QUANT_DECLINES.get(_key(src, dst, sig))


def decline_reason(src: DArraySpec, dst: DArraySpec) -> str:
    """``[VSC12x] why`` for the fallback's warning."""
    return str(decline_finding(src, dst))


def can_redistribute_per_shard(src: DArraySpec, dst: DArraySpec) -> bool:
    """True when ``redistribute(src -> dst)`` stays on per-shard paths (a
    respec, a single hop or a plan): no pass through the logical tensor."""
    if src == dst or _reshard_edge(src, dst) is not None:
        return True
    if _edge(src, dst) is not None:
        return True
    return plan_redistribute(src, dst) is not None


def clear_plan_cache() -> None:
    _PLANS.clear()
    _DECLINES.clear()
    _QUANT_DECLINES.clear()


def plan_cache_stats() -> Dict[str, int]:
    return {"plans": len(_PLANS), "declines": len(_DECLINES),
            "quant_declines": len(_QUANT_DECLINES)}
