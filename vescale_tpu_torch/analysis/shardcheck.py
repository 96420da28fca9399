"""shardcheck: placement analysis of a traced program, before it runs.

The port of ``vescale_tpu/analysis/shardcheck.py``.  A layout is a static
object over the program graph (Mesh-TensorFlow arXiv:1811.02084, "On
Optimizing the Communication of Model Parallelism" arXiv:2211.05322), so
layout mistakes are statically decidable.  The reference walks a jaxpr;
the port traces the program with ``torch.fx``'s ``make_fx`` on ``meta``
copies of its inputs (no memory, no compute: a 1.3B forward at full width
traces in seconds) and walks the aten graph with a symbolic sharding per
value, emitting the reference's codes (``findings.py``):

  VSC101  an op forces full materialization of a sharded operand (a view
          merging a sharded dim under an outer factor, a concatenate, a
          gather or sort along a sharded dim)
  VSC102  operands disagree on a sharding, so one must be resharded
  VSC103  a Partial operand consumed by a non-linear op
  VSC105  a donation miss: an input rebuilt as a same-shape output that
          neither aliases it nor is donated (the step holds both)

plus VSC104 (a collective under rank-dependent control flow) from the
checked callable's source, and the planner's VSC106/VSC108 and VSC12x on
transitions (``check_transition``, ``check_stage_boundaries``) and VSC107
on parameter plans (``check_param_plan``).

Aten ops map onto the reference's primitive rules: ``view`` /
``_unsafe_view`` are its reshape, ``mm`` / ``bmm`` / ``addmm`` its
``dot_general``, ``sum`` / ``mean`` / ``amax`` its reductions,
``embedding`` / ``index_select`` its gather, and so on.  The kernels'
custom ops have rules of their own: ``vtt.flash_attention`` (and its
backward) keeps q's (batch, head) sharding, which the wrapper's merge of
batch and heads into one dim does not break (attention is independent per
batch and head: a merge that feeds only such ops, or a ``bmm``'s batch
dim as torch's ``einsum`` makes, is recorded and split back, not
flagged); ``vtt.xent_parts`` takes the reference's conservative default,
unknown -> replicated with no finding.  A forward plan's placements enter
the graph as ``vtt_check.constraint`` nodes (the reference reads its
``sharding_constraint`` equations).  In-place updates alias their input:
a step that updates its state in place has no donation to miss.

Prices come from ``collectives.py``'s cost model, as the planner's do.
"""

from __future__ import annotations

import dataclasses
import json
import operator
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .findings import CODES, Finding, FindingReport, Severity
from .lint import rank_divergence_findings

__all__ = [
    "SymSharding",
    "shardcheck",
    "shardcheck_graph",
    "shardcheck_module",
    "sym_from_spec",
    "check_transition",
    "check_stage_boundaries",
    "check_param_plan",
    "rank_divergence_findings",
]


# ---------------------------------------------------------------- symbolic
@dataclasses.dataclass(frozen=True)
class SymSharding:
    """Symbolic sharding of one value: per tensor dim the mesh axis names
    sharding it, plus pending reductions.  ``partial`` holds declared
    Partials (an input's ``Partial`` placement, whose reduction the
    program owns: consuming one non-linearly is VSC103); ``auto_partial``
    those the program derives (a contraction or a reduction over a sharded
    dim), which the partitioner reduces where they are used."""

    axes: Tuple[Tuple[str, ...], ...]
    partial: Tuple[Tuple[str, str], ...] = ()
    auto_partial: Tuple[Tuple[str, str], ...] = ()

    @staticmethod
    def replicated(ndim: int) -> "SymSharding":
        return SymSharding(tuple(() for _ in range(ndim)))

    @staticmethod
    def of(*entries) -> "SymSharding":
        """The PartitionSpec-like form: one entry a dim, None, a mesh axis
        name or a tuple of them (``SymSharding.of(None, "tp")``)."""
        axes = []
        for e in entries:
            axes.append(() if e is None else (tuple(str(n) for n in e)
                                              if isinstance(e, (tuple, list)) else (str(e),)))
        return SymSharding(tuple(axes))

    @property
    def ndim(self) -> int:
        return len(self.axes)

    def is_sharded(self) -> bool:
        return any(self.axes) or bool(self.partial) or bool(self.auto_partial)

    def sharded_axes(self) -> Tuple[str, ...]:
        out: List[str] = []
        for dims in self.axes:
            out.extend(dims)
        return tuple(out)

    def partial_axes(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.partial)

    def drop_partial(self) -> "SymSharding":
        return SymSharding(self.axes, (), ())

    def __str__(self) -> str:
        dims = ",".join("+".join(a) if a else "-" for a in self.axes)
        p = "".join(f" partial({a}:{op})" for a, op in self.partial)
        p += "".join(f" auto({a}:{op})" for a, op in self.auto_partial)
        return f"[{dims}]{p}"


def sym_from_spec(spec, ndim: Optional[int] = None) -> SymSharding:
    """A SymSharding from a ``DArraySpec`` (logical dims; an interleave or
    a ragged split counts on its leading dim), a SymSharding, or a
    PartitionSpec-like sequence of per-dim entries (``ndim`` pads it)."""
    from ..placements import InterleavedShard, RaggedShard, Shard
    from ..spec import DArraySpec

    if isinstance(spec, SymSharding):
        return spec
    if not isinstance(spec, DArraySpec):
        entries = list(spec) + [None] * max(0, (ndim or 0) - len(spec))
        return SymSharding.of(*entries)
    axes: List[List[str]] = [[] for _ in range(spec.ndim)]
    partial: List[Tuple[str, str]] = []
    for i, p in enumerate(spec.placements):
        name = spec.mesh.dim_name(i)
        if type(p) is Shard or isinstance(p, InterleavedShard):
            axes[p.dim].append(name)
        elif isinstance(p, RaggedShard):
            axes[p.dims[0]].append(name)
        elif p.is_partial():
            partial.append((name, p.reduce_op))
    return SymSharding(tuple(tuple(a) for a in axes), tuple(partial))


# ------------------------------------------------------ the constraint op
@torch.library.custom_op("vtt_check::constraint", mutates_args=())
def constraint(x: torch.Tensor, spec: str) -> torch.Tensor:
    """Identity marking ``x``'s sharding (``spec``: the JSON of
    ``SymSharding.axes``) in a traced graph: shardcheck's
    ``sharding_constraint``."""
    return x.clone()


@constraint.register_fake
def _(x, spec):
    return torch.empty_like(x)


# ------------------------------------------------------------- op tables
_LINEAR = {"add", "sub", "rsub", "neg", "_to_copy", "clone", "copy", "alias", "detach",
           "lift_fresh_copy", "cumsum", "contiguous", "_conj", "real", "imag"}
_NONLINEAR = {
    "exp", "log", "log1p", "expm1", "tanh", "sin", "cos", "tan", "sigmoid", "erf", "erfc",
    "erfinv", "rsqrt", "sqrt", "square", "sign", "floor", "ceil", "round", "pow", "abs",
    "isfinite", "isnan", "maximum", "minimum", "fmod", "remainder", "atan2", "clamp",
    "clamp_min", "clamp_max", "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "eq", "ne", "lt", "le", "gt",
    "ge", "where", "silu", "gelu", "relu", "softplus", "reciprocal", "nan_to_num", "cummax",
    "cummin", "cumprod", "lgamma", "digamma", "masked_fill",
}
_RESHAPE = {"view", "_unsafe_view", "reshape"}
_REDUCE = {"sum": "reduce_sum", "mean": "reduce_sum", "amax": "reduce_max",
           "amin": "reduce_min", "max": "reduce_max", "min": "reduce_min",
           "prod": "reduce_prod", "any": "reduce_or", "all": "reduce_and",
           "argmax": "argmax", "argmin": "argmin"}
_SLICELIKE = {"slice", "constant_pad_nd", "flip", "split", "split_with_sizes", "select",
              "unbind"}


def _axis_prod(axis_sizes: Dict[str, int], names) -> int:
    out = 1
    for n in names:
        out *= int(axis_sizes.get(n, 1))
    return out


def _tensors(val) -> List[Any]:
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (list, tuple)):
        return [v for x in val for v in _tensors(x)]
    return []


def _nd(val) -> int:
    return val.dim() if isinstance(val, torch.Tensor) else 0


def _full_bytes(val) -> int:
    if not isinstance(val, torch.Tensor):
        return 0
    return int(val.numel()) * val.element_size()


def _gather_cost_us(full_bytes: int, axis_sizes: Dict[str, int], axes) -> float:
    """An all-gather of a sharded operand back to full, priced by
    ``collectives.py`` (the planner's objective too)."""
    from ..collectives import allgather_cost

    return sum(allgather_cost(full_bytes / 1e9, int(axis_sizes.get(a, 1))) for a in axes)


def _op_name(node) -> str:
    t = node.target
    packet = getattr(t, "overloadpacket", None)
    if packet is not None:
        ns = getattr(t, "namespace", "aten")
        name = packet.__name__
        return name if ns == "aten" else f"{ns}.{name}"
    return getattr(t, "__name__", str(t))


def _src(node) -> str:
    return f"{_op_name(node)} @ {node.name}"


def _dims_arg(d, nd: int) -> List[int]:
    if d is None:
        return list(range(nd))
    if isinstance(d, int):
        d = [d]
    return [x % nd if nd else 0 for x in d]


class _Checker:
    def __init__(self, axis_sizes: Dict[str, int], report: FindingReport, min_bytes: int):
        self.axis_sizes = dict(axis_sizes)
        self.report = report
        self.min_bytes = int(min_bytes)
        self._flagged: set = set()
        # batched merges: value -> (factor sizes, per-factor axes) of a view
        # that merged (batch, heads) for a kernel op or a batched matmul
        self._merged: Dict[Any, Tuple[Tuple[int, ...], Tuple[Tuple[str, ...], ...]]] = {}

    # ------------------------------------------------------------- helpers
    def _emit(self, code: str, message: str, node=None, *, mesh_dim=None, bytes_est=None,
              cost_us=None, severity=None) -> None:
        where = _src(node) if node is not None else None
        key = (code, where, message)
        if key in self._flagged:
            return
        self._flagged.add(key)
        self.report.add(Finding(CODES[code], message, where=where, mesh_dim=mesh_dim,
                                bytes_est=bytes_est, cost_us=cost_us, severity=severity))

    def _materialize(self, node, val, sym: SymSharding, why: str,
                     severity: Optional[Severity] = None) -> None:
        full = _full_bytes(val)
        if full < self.min_bytes:
            return
        axes = sym.sharded_axes()
        n = _axis_prod(self.axis_sizes, axes)
        if n <= 1:
            return
        self._emit(
            "VSC101",
            f"{why}: a {tuple(val.shape)} {str(val.dtype).replace('torch.', '')} operand "
            f"sharded {n}-way over {list(axes)} must be gathered to full size on every device",
            node, mesh_dim=axes[0] if axes else None, bytes_est=full,
            cost_us=_gather_cost_us(full, self.axis_sizes, axes), severity=severity)

    def _partial_misuse(self, node, sym: SymSharding, why: str) -> None:
        axes = sym.partial_axes()
        self._emit(
            "VSC103",
            f"{why}: the operand is Partial({','.join(axes)}) — pending reduction; applying a "
            "non-linear op before reducing computes f(x_i) per replica instead of f(sum_i x_i)",
            node, mesh_dim=axes[0] if axes else None)

    # ------------------------------------------------------------ the walk
    def run(self, gm, in_syms: Sequence[SymSharding]) -> List[Any]:
        env: Dict[Any, Any] = {}
        placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
        for i, node in enumerate(placeholders):
            val = node.meta.get("val")
            sym = in_syms[i] if i < len(in_syms) and in_syms[i] is not None else None
            env[node] = sym if sym is not None and sym.ndim == _nd(val) \
                else SymSharding.replicated(_nd(val))

        def read(a):
            if isinstance(a, torch.fx.Node):
                if a in env:
                    return env[a]
                return SymSharding.replicated(_nd(a.meta.get("val")))
            if isinstance(a, (list, tuple)):
                return [read(x) for x in a]
            return SymSharding.replicated(_nd(a) if isinstance(a, torch.Tensor) else 0)

        out = []
        for node in gm.graph.nodes:
            if node.op == "get_attr":
                env[node] = SymSharding.replicated(_nd(getattr(gm, node.target, None)))
            elif node.op == "call_function":
                env[node] = self._node(node, read)
            elif node.op == "output":
                out = read(node.args[0])
        return out

    def _node(self, node, read):
        val = node.meta.get("val")
        try:
            if node.target is operator.getitem:
                src, idx = node.args
                syms = read(src)
                got = syms[idx] if isinstance(syms, list) and idx < len(syms) else None
                if isinstance(src, torch.fx.Node) and (src, idx) in self._merged:
                    self._merged[node] = self._merged[(src, idx)]
                return got if isinstance(got, SymSharding) else SymSharding.replicated(_nd(val))
            return self._op(node, read, val)
        except Exception:
            return self._replicated(val)

    @staticmethod
    def _replicated(val):
        if isinstance(val, (list, tuple)):
            return [SymSharding.replicated(_nd(v)) for v in val]
        return SymSharding.replicated(_nd(val))

    # ------------------------------------------------------- per-op rules
    def _op(self, node, read, val):
        name = _op_name(node)
        args = node.args
        if name == "vtt_check.constraint":
            return SymSharding(tuple(tuple(a) for a in json.loads(args[1])))
        if name.startswith("vtt."):
            return self._kernel(node, name, read, val)
        if name in ("mm", "bmm", "addmm", "baddbmm"):
            off = 1 if name in ("addmm", "baddbmm") else 0
            lhs, rhs = read(args[off]), read(args[off + 1])
            if name in ("mm", "addmm"):
                dn = (([1], [0]), ([], []))
            else:
                dn = (([2], [1]), ([0], [0]))
                if args[off] in self._merged:  # the batch dim a merge made
                    self._merged[node] = self._merged[args[off]]
            out = self._dot_general(node, lhs, rhs, dn)
            if off:
                bias = read(args[0])
                out = self._default(node, "add", [out, bias], val, linear_bias=True)
            return out
        if name in _RESHAPE:
            x_node = args[0]
            return self._reshape(node, x_node, read(x_node), val)
        if name == "permute":
            x = read(args[0])
            return SymSharding(tuple(x.axes[p % x.ndim] for p in args[1]), x.partial,
                               x.auto_partial)
        if name in ("transpose", "t"):
            x = read(args[0])
            axes = list(x.axes)
            if x.ndim >= 2:
                d0, d1 = (args[1] % x.ndim, args[2] % x.ndim) if name == "transpose" else (0, 1)
                axes[d0], axes[d1] = axes[d1], axes[d0]
            return SymSharding(tuple(axes), x.partial, x.auto_partial)
        if name == "expand":
            return self._broadcast(read(args[0]), args[0].meta["val"], val)
        if name == "unsqueeze":
            x = read(args[0])
            d = args[1] % (x.ndim + 1)
            axes = list(x.axes)
            axes.insert(d, ())
            return SymSharding(tuple(axes), x.partial, x.auto_partial)
        if name == "squeeze":
            x = read(args[0])
            in_shape = tuple(args[0].meta["val"].shape)
            dims = _dims_arg(args[1] if len(args) > 1 else None, x.ndim)
            drop = {d for d in dims if in_shape[d] == 1}
            return SymSharding(tuple(a for d, a in enumerate(x.axes) if d not in drop),
                               x.partial, x.auto_partial)
        if name == "cat":
            return self._concatenate(node, args[0], [read(a) for a in args[0]],
                                     args[1] if len(args) > 1 else 0, val)
        if name in _REDUCE:
            return self._reduce(node, name, read(args[0]), args, val)
        if name in ("_softmax", "_log_softmax", "softmax", "log_softmax"):
            x = read(args[0])
            if x.partial:
                self._partial_misuse(node, x, f"non-linear op `{name}`")
            return SymSharding(x.axes)
        if name in ("sort", "topk"):
            dim = args[2] if name == "topk" and len(args) > 2 else \
                (args[1] if name == "sort" and len(args) > 1 else -1)
            return self._sort(node, name, args[0], read(args[0]), dim, val)
        if name in ("embedding", "index_select", "gather", "index"):
            return self._gather(node, name, args, read, val)
        if name in _SLICELIKE:
            return self._slicelike(name, args, read(args[0]), val)
        return self._default(node, name, [s for s in map(read, args)
                                          if isinstance(s, SymSharding)], val)

    def _default(self, node, name, ins: List[SymSharding], val, linear_bias: bool = False):
        nd = _nd(val)
        ins = [s for s in ins if isinstance(s, SymSharding)]
        arrayish = [s for s in ins if s.ndim == nd]
        partial_ins = [s for s in ins if s.partial]
        known = name in _LINEAR or name in _NONLINEAR or name in ("mul", "div")
        if partial_ins and known:
            if name in _NONLINEAR:
                self._partial_misuse(node, partial_ins[0], f"non-linear op `{name}`")
            elif name in ("add", "sub", "rsub"):
                if any(not s.partial for s in ins) or len({s.partial for s in partial_ins}) > 1:
                    if any(not s.partial and s.ndim == nd for s in ins):
                        self._partial_misuse(
                            node, partial_ins[0],
                            f"additive op `{name}` mixing Partial and non-Partial operands")
            elif name in ("mul", "div") and len(partial_ins) > 1:
                self._partial_misuse(node, partial_ins[0],
                                     f"product of two Partial operands in `{name}`")
            elif name == "div" and len(ins) > 1 and ins[-1].partial:
                self._partial_misuse(node, ins[-1], "Partial operand as divisor")
        if not arrayish or not known:
            return self._replicated(val)
        axes: List[Tuple[str, ...]] = []
        for d in range(nd):
            cands = [s.axes[d] for s in arrayish if s.axes[d]]
            uniq = set(cands)
            if len(uniq) > 1:
                full = _full_bytes(val)
                n0 = _axis_prod(self.axis_sizes, next(iter(uniq)))
                if full >= self.min_bytes:
                    self._emit(
                        "VSC102",
                        f"operands of `{name}` disagree on dim {d} sharding "
                        f"({sorted(','.join(u) for u in uniq)}); the partitioner must reshard "
                        "one operand", node, bytes_est=full // max(1, n0))
            axes.append(cands[0] if cands else ())
        partial = partial_ins[0].partial if partial_ins else ()
        auto: Dict[str, str] = {}
        if name not in _NONLINEAR:
            for s in arrayish:
                for a, op in s.auto_partial:
                    auto.setdefault(a, op)
        return SymSharding(tuple(axes), partial, tuple(sorted(auto.items())))

    def _dot_general(self, node, lhs: SymSharding, rhs: SymSharding, dn) -> SymSharding:
        (lc, rc), (lb, rb) = dn
        if lhs.partial and rhs.partial:
            self._partial_misuse(node, lhs, "dot_general of two Partial operands")
        partial = list(lhs.partial) + list(rhs.partial)
        auto = list(lhs.auto_partial) + list(rhs.auto_partial)
        for dl, dr in zip(lc, rc):
            for a in set(lhs.axes[dl]) | set(rhs.axes[dr]):
                auto.append((a, "sum"))
        lhs_free = [d for d in range(lhs.ndim) if d not in lc and d not in lb]
        rhs_free = [d for d in range(rhs.ndim) if d not in rc and d not in rb]
        axes: List[Tuple[str, ...]] = []
        for dl, dr in zip(lb, rb):
            if lhs.axes[dl] and rhs.axes[dr] and lhs.axes[dl] != rhs.axes[dr]:
                self._emit("VSC102", f"batch dims of dot_general sharded differently "
                           f"({list(lhs.axes[dl])} vs {list(rhs.axes[dr])})", node)
            axes.append(lhs.axes[dl] or rhs.axes[dr])
        axes.extend(lhs.axes[d] for d in lhs_free)
        axes.extend(rhs.axes[d] for d in rhs_free)
        seen: Dict[str, int] = {}
        for dims in axes:
            for a in dims:
                seen[a] = seen.get(a, 0) + 1
        for a, _op in partial + auto:
            seen[a] = seen.get(a, 0) + 1
        dup = [a for a, k in seen.items() if k > 1]
        if dup:
            # the bytes of the operand whose sharding must move: the output
            val = node.meta.get("val")
            full = _full_bytes(val)
            n = _axis_prod(self.axis_sizes, [dup[0]])
            self._emit("VSC102", f"mesh axis {dup[0]!r} used by multiple dot_general operands "
                       "in conflicting roles; a reshard will be inserted", node,
                       mesh_dim=dup[0], bytes_est=full // max(1, n) if full else None,
                       cost_us=_gather_cost_us(full // max(1, n), self.axis_sizes, [dup[0]])
                       if full else None)
            axes = [tuple(a for a in dims if a not in dup) for dims in axes]
            partial = [(a, op) for a, op in partial if a not in dup]
            auto = [(a, op) for a, op in auto if a not in dup]
        pdict: Dict[str, str] = {}
        for a, op in partial:
            pdict.setdefault(a, op)
        adict: Dict[str, str] = {}
        for a, op in auto:
            if a not in pdict:
                adict.setdefault(a, op)
        return SymSharding(tuple(axes), tuple(sorted(pdict.items())), tuple(sorted(adict.items())))

    def _feeds_batched(self, node) -> bool:
        """Every use of ``node`` (through copies and casts) is an op
        independent along its dim 0: a kernel op ((batch*heads) first) or a
        batched matmul."""
        todo, seen, hit = list(node.users), set(), False
        while todo:
            u = todo.pop()
            if u in seen:
                continue
            seen.add(u)
            name = _op_name(u) if u.op == "call_function" else ""
            if name.startswith("vtt.") or name in ("bmm", "baddbmm"):
                hit = True
            elif name in ("clone", "_to_copy", "contiguous", "detach", "alias"):
                todo.extend(u.users)
            else:
                return False
        return hit

    def _reshape(self, node, x_node, x: SymSharding, val) -> SymSharding:
        in_shape = tuple(x_node.meta["val"].shape)
        out_shape = tuple(val.shape)
        groups = _reshape_groups(in_shape, out_shape)
        axes: List[Tuple[str, ...]] = [() for _ in out_shape]
        rec = self._merged.get(x_node)
        for in_dims, out_dims in groups:
            if rec is not None and in_dims == [0] and \
                    tuple(out_shape[j] for j in out_dims) == rec[0]:
                for j, a in zip(out_dims, rec[1]):  # a kernel merge split back
                    axes[j] = a
                continue
            sharded = [d for d in in_dims if x.axes[d]]
            if not sharded:
                continue
            # size-1 dims hold no data: the sharding lands on the group's
            # first output dim of size > 1
            lead_out = next((j for j in out_dims if out_shape[j] != 1),
                            out_dims[0] if out_dims else None)
            bad = []
            for pos, d in enumerate(in_dims):
                if not x.axes[d]:
                    continue
                n = _axis_prod(self.axis_sizes, x.axes[d])
                outer = 1
                for q in in_dims[:pos]:
                    outer *= in_shape[q]
                if lead_out is not None and (pos == 0 or outer == 1) and \
                        out_shape[lead_out] % n == 0:
                    axes[lead_out] = tuple(axes[lead_out]) + x.axes[d]
                else:
                    bad.append(d)
            if not bad:
                continue
            if len(out_dims) == 1 and self._feeds_batched(node):
                # (batch, heads) merged for a kernel or a batched matmul:
                # record the factors, do not flag
                self._merged[node] = (tuple(in_shape[d] for d in in_dims),
                                      tuple(x.axes[d] for d in in_dims))
                axes[lead_out] = tuple(a for d in in_dims for a in x.axes[d])
                continue
            for d in bad:
                self._materialize(
                    node, x_node.meta["val"],
                    SymSharding(tuple(x.axes[q] if q == d else () for q in range(x.ndim))),
                    f"reshape {in_shape} -> {out_shape} merges sharded dim {d} under an outer "
                    "factor (shard block order not preserved)")
        return SymSharding(tuple(axes), x.partial, x.auto_partial)

    def _broadcast(self, x: SymSharding, in_val, val) -> SymSharding:
        out_shape, in_shape = tuple(val.shape), tuple(in_val.shape)
        off = len(out_shape) - len(in_shape)
        axes: List[Tuple[str, ...]] = [() for _ in out_shape]
        for i in range(len(in_shape)):
            if in_shape[i] == out_shape[off + i]:
                axes[off + i] = x.axes[i]
        return SymSharding(tuple(axes), x.partial, x.auto_partial)

    def _concatenate(self, node, in_nodes, ins: List[SymSharding], dim: int, val) -> SymSharding:
        nd = _nd(val)
        dim = dim % nd
        for i, s in enumerate(ins):
            if s.ndim == nd and s.axes[dim]:
                self._materialize(
                    node, in_nodes[i].meta["val"],
                    SymSharding(tuple(s.axes[q] if q == dim else () for q in range(s.ndim))),
                    f"concatenate along sharded dim {dim}")
        axes = []
        for d in range(nd):
            if d == dim:
                axes.append(())
            else:
                cands = [s.axes[d] for s in ins if s.ndim == nd and s.axes[d]]
                axes.append(cands[0] if cands else ())
        return SymSharding(tuple(axes))

    def _reduce(self, node, name: str, x: SymSharding, args, val) -> SymSharding:
        prim = _REDUCE[name]
        dims_arg = args[1] if len(args) > 1 and not isinstance(args[1], bool) else None
        keep = bool(args[2]) if len(args) > 2 and isinstance(args[2], bool) else False
        if name in ("argmax", "argmin") and len(args) > 2:
            keep = bool(args[2])
        dims = set(_dims_arg(dims_arg, x.ndim))
        if x.partial and prim in ("reduce_max", "reduce_min", "reduce_prod", "argmax", "argmin",
                                  "reduce_and", "reduce_or"):
            self._partial_misuse(node, x, f"non-linear reduction `{name}`")
        reduced: List[str] = []
        axes: List[Tuple[str, ...]] = []
        for d in range(x.ndim):
            if d in dims:
                reduced.extend(x.axes[d])
                if keep:
                    axes.append(())
            else:
                axes.append(x.axes[d])
        partial = list(x.partial)
        auto = list(x.auto_partial)
        op = {"reduce_sum": "sum", "reduce_max": "max", "reduce_min": "min"}.get(prim)
        if reduced:
            if op is not None:
                auto.extend((a, op) for a in reduced)
            elif prim in ("argmax", "argmin"):
                self._materialize(
                    node, node.args[0].meta["val"],
                    SymSharding(tuple(x.axes[d] if d in dims else () for d in range(x.ndim))),
                    f"`{name}` over a sharded dim", severity=Severity.WARNING)
        pdict: Dict[str, str] = {}
        for a, o in partial:
            pdict.setdefault(a, o)
        adict: Dict[str, str] = {}
        for a, o in auto:
            if a not in pdict:
                adict.setdefault(a, o)
        out = SymSharding(tuple(axes), tuple(sorted(pdict.items())), tuple(sorted(adict.items())))
        if isinstance(val, (list, tuple)):  # max.dim: (values, indices)
            return [out if _nd(v) == out.ndim else SymSharding.replicated(_nd(v)) for v in val]
        return out if out.ndim == _nd(val) else SymSharding.replicated(_nd(val))

    def _sort(self, node, name, x_node, x: SymSharding, dim, val):
        if x.ndim:
            dim = dim % x.ndim
            if x.axes[dim]:
                self._materialize(
                    node, x_node.meta["val"],
                    SymSharding(tuple(x.axes[q] if q == dim else () for q in range(x.ndim))),
                    f"`{name}` along sharded dim {dim}", severity=Severity.WARNING)
        return self._replicated(val)

    def _gather(self, node, name, args, read, val):
        operand_node = args[0]
        if name == "embedding":
            operand_node = args[0]
            idx_dims = [0]
        elif name in ("index_select", "gather"):
            idx_dims = [args[1] % max(1, _nd(args[0].meta["val"]))]
        else:  # index.Tensor: the dims given an index
            idx_dims = [d for d, a in enumerate(args[1]) if a is not None]
        operand = read(operand_node)
        shape = tuple(operand_node.meta["val"].shape)
        for d in idx_dims:
            if d < operand.ndim and operand.axes[d] and shape[d] != 1:
                self._materialize(
                    node, operand_node.meta["val"],
                    SymSharding(tuple(operand.axes[q] if q == d else ()
                                      for q in range(operand.ndim))),
                    f"gather indexes into sharded dim {d}", severity=Severity.WARNING)
        return self._replicated(val)

    def _slicelike(self, name, args, x: SymSharding, val):
        in_shape = tuple(args[0].meta["val"].shape)
        if name == "select":
            d = args[1] % x.ndim
            return SymSharding(tuple(a for q, a in enumerate(x.axes) if q != d), x.partial,
                               x.auto_partial)

        def keep(v):
            if _nd(v) != x.ndim:
                return SymSharding.replicated(_nd(v))
            out_shape = tuple(v.shape)
            return SymSharding(tuple(x.axes[d] if in_shape[d] == out_shape[d] else ()
                                     for d in range(x.ndim)), x.partial, x.auto_partial)

        if isinstance(val, (list, tuple)):
            return [keep(v) for v in val]
        return keep(val)

    def _kernel(self, node, name, read, val):
        """The kernels' custom ops.  Flash attention keeps q's sharding on
        its (batch*heads) dim, wants k and v sharded alike and no sharding
        on the sequence or head dims; the cross entropy (and anything
        else) is unknown -> replicated."""
        if name not in ("vtt.flash_attention", "vtt.flash_attention_bwd"):
            return self._replicated(val)
        q, k, v = (read(node.args[i]) for i in range(3))
        for s, a in ((q, node.args[0]), (k, node.args[1]), (v, node.args[2])):
            if s.partial:
                self._partial_misuse(node, s, "attention over a Partial operand")
            if s.ndim == 3 and (s.axes[1] or s.axes[2]):
                self._materialize(node, a.meta["val"], SymSharding(((),) + s.axes[1:]),
                                  "attention over a sharded sequence or head dim")
        if q.axes and k.axes and q.axes[0] != k.axes[0]:
            self._emit("VSC102", f"attention's q and k/v disagree on their (batch*heads) "
                       f"sharding ({list(q.axes[0])} vs {list(k.axes[0])})", node,
                       bytes_est=_full_bytes(node.args[1].meta["val"]))
        rec = self._merged.get(node.args[0])
        srcs = (0,) if name == "vtt.flash_attention" else (0, 1, 2)
        outs = []
        for i, t in enumerate(val):
            if i < len(srcs):
                a = node.args[srcs[i]]
                outs.append(SymSharding(read(a).axes))
                if a in self._merged:
                    self._merged[(node, i)] = self._merged[a]
            elif rec is not None and _nd(t) == 3:  # lse: (batch, heads, seq)
                outs.append(SymSharding(rec[1] + ((),)))
            else:
                outs.append(SymSharding.replicated(_nd(t)))
        return outs


def _reshape_groups(in_shape, out_shape):
    """Balanced factor groups of a reshape: (in dims, out dims) pairs of
    equal products."""
    i = j = 0
    groups = []
    ni, nj = len(in_shape), len(out_shape)
    while i < ni and j < nj:
        in_dims, out_dims = [i], [j]
        pi, pj = in_shape[i], out_shape[j]
        while pi != pj:
            if pi < pj:
                i += 1
                in_dims.append(i)
                pi *= in_shape[i]
            else:
                j += 1
                out_dims.append(j)
                pj *= out_shape[j]
        groups.append((in_dims, out_dims))
        i += 1
        j += 1
    while i < ni:
        groups.append(([i], []))
        i += 1
    while j < nj:
        groups.append(([], [j]))
        j += 1
    return groups


# ------------------------------------------------------------ entry points
def _axis_sizes(mesh, syms_or_specs) -> Dict[str, int]:
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    if mesh is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    sizes: Dict[str, int] = {}
    for s in syms_or_specs:
        m = getattr(s, "mesh", None)
        if m is not None:
            sizes.update(dict(zip(m.mesh_dim_names, m.shape)))
    return sizes


def _flatten(tree) -> List[Any]:
    from torch.utils import _pytree as pytree

    return pytree.tree_leaves(tree)


def _to_meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    return x


def _trace(fn, args, kwargs, static_argnums):
    """``fn`` traced by ``make_fx`` on ``meta`` copies of its tensor
    inputs: (graph module, the flat input leaves, each leaf's argnum)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils import _pytree as pytree

    static = set(static_argnums or ())
    dyn = [a for i, a in enumerate(args) if i not in static]
    leaves, spec = pytree.tree_flatten((dyn, kwargs))
    argnum: List[int] = []
    for i, a in enumerate(args):
        if i not in static:
            argnum.extend([i] * len(pytree.tree_leaves(a)))
    argnum.extend([-1] * len(pytree.tree_leaves(kwargs)))
    is_t = [isinstance(x, torch.Tensor) for x in leaves]

    def flat_fn(*tensors):
        it = iter(tensors)
        full = [next(it) if t else x for x, t in zip(leaves, is_t)]
        dyn_args, kw = pytree.tree_unflatten(full, spec)
        it2 = iter(dyn_args)
        call = [args[i] if i in static else next(it2) for i in range(len(args))]
        return fn(*call, **kw)

    tensors = [_to_meta(x) for x, t in zip(leaves, is_t) if t]
    gm = make_fx(flat_fn, tracing_mode="real")(*tensors)
    return gm, [x for x, t in zip(leaves, is_t) if t], [n for n, t in zip(argnum, is_t) if t]


def _spec_leaves(in_specs, dyn_args, kwargs) -> List[Any]:
    """One spec (or None) a tensor leaf of the non-static args, then of
    the kwargs: ``in_specs[i]`` is arg i's pytree of specs (a bare None
    or spec covers every leaf of the arg; a tuple is a PartitionSpec-like
    leaf)."""
    from torch.utils import _pytree as pytree

    from ..spec import DArraySpec

    def is_spec(x):
        return x is None or isinstance(x, (SymSharding, DArraySpec, tuple))

    out: List[Any] = []
    specs = list(in_specs) if in_specs is not None else []
    for i, a in enumerate(dyn_args):
        n = sum(isinstance(x, torch.Tensor) for x in pytree.tree_leaves(a))
        entry = specs[i] if i < len(specs) else None
        if is_spec(entry):
            out.extend([entry] * n)
            continue
        leaves = pytree.tree_leaves(entry, is_leaf=is_spec)
        tensors = [x for x in pytree.tree_leaves(a)]
        got = [e for e, t in zip(leaves, tensors) if isinstance(t, torch.Tensor)]
        out.extend(got + [None] * (n - len(got)))
    out.extend([None] * sum(isinstance(x, torch.Tensor) for x in pytree.tree_leaves(kwargs)))
    return out


def shardcheck(fn, *args, in_specs=None, donate_argnums: Optional[Sequence[int]] = (),
               static_argnums: Sequence[int] = (), mesh=None, name: Optional[str] = None,
               min_bytes: int = 1 << 20, check_source: bool = True, **kwargs) -> FindingReport:
    """Statically analyze ``fn(*args, **kwargs)`` for placement hazards.

    ``args`` are pytrees of tensors (real or ``meta``; either way the trace
    runs on ``meta`` copies, so nothing is computed or updated).
    ``in_specs``: a pytree matching the non-static ``args`` whose leaves are
    ``DArraySpec`` / ``SymSharding`` / PartitionSpec-like tuples / None
    (replicated).  ``mesh`` (a DeviceMesh or a ``{axis: size}`` dict)
    supplies axis sizes when the specs carry none.  ``donate_argnums``: the
    args the caller gives up (updates in place); an undonated input rebuilt
    as a new same-shape output raises VSC105.  ``None`` skips that check.
    ``static_argnums`` stay Python values.  ``min_bytes`` suppresses
    findings about smaller operands."""
    report = FindingReport(name or getattr(fn, "__name__", "program"))
    try:
        gm, leaves, argnum = _trace(fn, args, kwargs, static_argnums)
    except Exception as e:  # noqa: BLE001 — an untraceable program is a finding
        report.add(Finding(CODES["VSC109"], f"could not trace program for shardcheck: {e!r}",
                           severity=Severity.INFO))
        return report
    static = set(static_argnums or ())
    spec_leaves = _spec_leaves(in_specs, [a for i, a in enumerate(args) if i not in static],
                               kwargs)
    syms = [None if e is None else sym_from_spec(e, leaf.dim())
            for leaf, e in zip(leaves, spec_leaves)]
    sizes = _axis_sizes(mesh, spec_leaves)
    report = shardcheck_graph(gm, syms, sizes, name=report.name, min_bytes=min_bytes,
                              report=report)
    if donate_argnums is not None:
        _check_donation(report, gm, argnum, set(donate_argnums) - static, min_bytes)
    if check_source:
        _check_fn_source(report, fn)
    return report


def shardcheck_graph(gm, in_syms: Sequence[Optional[SymSharding]], axis_sizes: Dict[str, int],
                     name: str = "graph", min_bytes: int = 1 << 20,
                     report: Optional[FindingReport] = None) -> FindingReport:
    """The engine: walk a traced ``torch.fx`` graph module with one
    symbolic sharding a placeholder (None: replicated)."""
    report = report if report is not None else FindingReport(name)
    try:
        _Checker(axis_sizes, report, min_bytes).run(gm, list(in_syms))
    except Exception as e:  # noqa: BLE001
        report.add(Finding(CODES["VSC109"], f"shardcheck walk aborted: {e!r}",
                           severity=Severity.INFO))
    return report


def _aliases_input(node) -> Optional[Any]:
    """The placeholder ``node`` is, or updates in place, else None."""
    while isinstance(node, torch.fx.Node):
        if node.op == "placeholder":
            return node
        name = _op_name(node) if node.op == "call_function" else ""
        if node.op == "call_function" and (name.endswith("_") or name in ("copy_",)) \
                and node.args:
            node = node.args[0]
            continue
        return None
    return None


def _check_donation(report, gm, argnum: List[int], donated: set, min_bytes: int) -> None:
    """VSC105: an undonated input whose shape and dtype a new output has
    (one output neither aliasing nor updating an input in place)."""
    from torch.utils import _pytree as pytree

    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    outs = [o for o in pytree.tree_leaves(out_node.args[0]) if isinstance(o, torch.fx.Node)]
    aliased = set()
    sigs: Dict[Tuple, int] = {}
    for o in outs:
        ph = _aliases_input(o)
        if ph is not None:
            aliased.add(ph)
            continue
        v = o.meta.get("val")
        if isinstance(v, torch.Tensor) and v.dim():
            key = (tuple(v.shape), v.dtype)
            sigs[key] = sigs.get(key, 0) + 1
    missed = missed_bytes = 0
    for ph, n in zip(placeholders, argnum):
        if n < 0 or n in donated or ph in aliased:
            continue
        v = ph.meta.get("val")
        if not isinstance(v, torch.Tensor) or not v.dim():
            continue
        b = _full_bytes(v)
        if b < min_bytes:
            continue
        key = (tuple(v.shape), v.dtype)
        if sigs.get(key, 0) > 0:
            sigs[key] -= 1
            missed += 1
            missed_bytes += b
    if missed:
        report.add(Finding(
            CODES["VSC105"],
            f"{missed} large input buffer(s) (~{missed_bytes / 2**20:.1f} MiB logical) are "
            "rebuilt as same-shape outputs but neither updated in place nor donated — each "
            "lives twice during the step",
            bytes_est=missed_bytes))


def _check_fn_source(report, fn) -> None:
    """VSC104 on the checked callable's own source, when retrievable."""
    import inspect
    import textwrap

    try:
        target = inspect.unwrap(getattr(fn, "__wrapped__", fn))
        src = inspect.getsource(target)
        filename = inspect.getsourcefile(target) or "<source>"
    except (OSError, TypeError):
        return
    try:
        report.extend(rank_divergence_findings(textwrap.dedent(src), filename))
    except SyntaxError:
        pass


# --------------------------------------------------- modules under a plan
def _plain_meta_module(module):
    """A copy of ``module`` on ``meta`` with no tensor-parallel state and
    no hooks (a ``DModule``: its module at the global shapes)."""
    import copy

    from ..dmodule.api import DModule

    memo: Dict[int, Any] = {}
    base = module.module if isinstance(module, DModule) else module
    shapes = {n: s.shape for n, s in module._specs.items()} if isinstance(module, DModule) else {}
    for n, p in base.named_parameters():
        memo[id(p)] = torch.nn.Parameter(
            torch.empty(shapes.get(n, tuple(p.shape)), dtype=p.dtype, device="meta"),
            requires_grad=p.requires_grad)
    for _n, b in base.named_buffers():
        memo[id(b)] = torch.empty_like(b, device="meta")
    for m in base.modules():  # a tensor-parallel dim holds process groups
        if getattr(m, "tp", None) is not None:
            memo[id(m.tp)] = None
    plain = copy.deepcopy(base, memo)
    for m in plain.modules():
        m._forward_hooks.clear()
        m._forward_pre_hooks.clear()
        if hasattr(m, "tp_kind"):
            m.tp, m.tp_kind = None, None
    return plain


def shardcheck_module(module, plan: Optional[Dict[str, Any]], mesh, *inputs,
                      name: Optional[str] = None, min_bytes: int = 1 << 20) -> FindingReport:
    """shardcheck of ``module(*inputs)`` under a sharding plan: the
    parameters' placements from ``plan["parameter"]`` (first fullmatching
    regex, as ``parallelize_module`` resolves them), the forward plan's
    input and output placements as constraints on those activations.  The
    module is copied to ``meta`` first (a ``DModule``: its module at the
    global shapes, its own plan and mesh), so a full-width model costs no
    memory and nothing runs."""
    from ..dmodule.api import DModule, PlacementsInterface, _match
    from ..placements import normalize_placements
    from ..spec import DArraySpec, TensorMeta

    if isinstance(module, DModule):
        plan = {"parameter": module.param_plan, "forward": module.fwd_plan}
        mesh = module.mesh
    plain = _plain_meta_module(module)
    plan = plan or {}
    params = dict(plain.named_parameters())
    buffers = dict(plain.named_buffers())
    syms = []
    for n, p in params.items():
        _pat, v = _match(plan.get("parameter", {}), n)
        if v is None or mesh is None:
            syms.append(None)
            continue
        spec = DArraySpec(mesh, normalize_placements(v, mesh.ndim, p.dim()),
                          TensorMeta(tuple(p.shape), p.dtype))
        syms.append(sym_from_spec(spec))
    handles = []
    if mesh is not None:
        import re

        names = mesh.mesh_dim_names

        def mark(t, placements):
            if not isinstance(t, torch.Tensor) or placements is None:
                return t
            pls = normalize_placements(placements, mesh.ndim, t.dim())
            axes: List[List[str]] = [[] for _ in range(t.dim())]
            for i, p in enumerate(pls):
                if p.is_shard() or p.is_interleaved_shard():
                    axes[p.dim].append(names[i])
            return constraint(t, json.dumps(axes))

        def align(seq, n):
            seq = list(seq or [])
            return seq * n if len(seq) == 1 and n > 1 else seq + [None] * (n - len(seq))

        for fqn, mod in plain.named_modules():
            hit = None
            for pattern, v in plan.get("forward", {}).items():
                if ":" not in pattern and re.fullmatch(pattern, fqn):
                    hit = PlacementsInterface.normalize(v)
                    break
            if hit is None:
                continue

            def pre(m, a, hit=hit):
                return tuple(mark(x, p) for x, p in zip(a, align(hit.input, len(a))))

            def post(m, a, out, hit=hit):
                if isinstance(out, torch.Tensor):
                    return mark(out, align(hit.output, 1)[0])
                return out

            if hit.input is not None:
                handles.append(mod.register_forward_pre_hook(pre))
            if hit.output is not None:
                handles.append(mod.register_forward_hook(post))

    def fwd(p, *xs):
        return torch.func.functional_call(plain, {**p, **buffers}, xs)

    try:
        in_specs = [dict(zip(params, syms))] + [None] * len(inputs)
        return shardcheck(fwd, params, *inputs, in_specs=in_specs, mesh=mesh,
                          name=name or type(plain).__name__, min_bytes=min_bytes,
                          donate_argnums=None, check_source=False)
    finally:
        for h in handles:
            h.remove()


# ------------------------------------------------- redistribute / pipeline
def check_transition(src_spec, dst_spec, where: Optional[str] = None) -> List[Finding]:
    """Findings for one ``redistribute(src -> dst)``: VSC106 (with the
    planner's decline) when it would take the fallback through Replicate,
    VSC108 (info, costed) when the multi-hop planner serves it, and with
    ``VESCALE_REDISTRIBUTE_QUANT`` on the int8 hop's decision (VSC128
    taken, VSC127 declined)."""
    from ..redistribute import classify_transition
    from ..redistribute_plan import (decline_finding, physical_shard_bytes, plan_redistribute,
                                     quant_outcome)

    if src_spec == dst_spec:
        return []
    quant_findings: List[Finding] = []
    label = where or (f"{list(map(str, src_spec.placements))} -> "
                      f"{list(map(str, dst_spec.placements))}")
    qo = quant_outcome(src_spec, dst_spec)
    if qo is not None:
        verdict, payload = qo
        if verdict == "taken":
            quant_findings.append(Finding(
                CODES["VSC128"],
                f"cost model routes this transition through a lossy int8-quantized "
                f"{'/'.join(payload.collectives)} hop (~{payload.bytes_moved / 2**20:.2f} MiB "
                f"packed vs ~{payload.bytes_raw / 2**20:.2f} MiB raw per device)",
                where=label, bytes_est=payload.bytes_moved))
        elif payload is not None:
            qf = payload.finding()
            qf.where = label
            quant_findings.append(qf)
    tier = classify_transition(src_spec, dst_spec)
    if tier == "fallback":
        decline = decline_finding(src_spec, dst_spec)
        df = decline.finding()
        df.where = label
        shard = max(physical_shard_bytes(src_spec), physical_shard_bytes(dst_spec))
        return quant_findings + [Finding(
            CODES["VSC106"],
            f"transition would materialize the logical tensor "
            f"(~{src_spec.logical_bytes() / 2**20:.1f} MiB vs ~{shard / 2**20:.1f} MiB per "
            f"shard); planner declined [{decline.code}]: {decline.message}",
            where=label, bytes_est=src_spec.logical_bytes()), df]
    if tier == "planned":
        plan = plan_redistribute(src_spec, dst_spec)
        if plan is not None:
            n_quant = sum(1 for h in plan.hops if h.kind == "quant")
            return quant_findings + [Finding(
                CODES["VSC108"],
                f"resolved by a {len(plan.hops)}-hop plan moving "
                f"~{plan.bytes_moved / 2**20:.2f} MiB per device"
                + (f" ({n_quant} int8-quantized hop(s))" if n_quant else ""),
                where=label, bytes_est=plan.bytes_moved)]
    return quant_findings


def check_stage_boundaries(out_specs: Sequence, in_specs: Sequence,
                           labels: Optional[Sequence[str]] = None,
                           name: str = "pipeline") -> FindingReport:
    """Stage i's output spec against stage i+1's input spec, each boundary
    classified through the real redistribute dispatch."""
    report = FindingReport(name)
    for i, (o, nxt) in enumerate(zip(out_specs, in_specs)):
        if o is None or nxt is None:
            continue
        label = labels[i] if labels and i < len(labels) else f"stage{i}->stage{i + 1}"
        report.extend(check_transition(o, nxt, where=label))
    return report


def check_param_plan(param_plan: Dict[str, Any], mesh, name: str = "param_plan") -> FindingReport:
    """VSC107: parameter-plan placements that are never right (Partial: a
    parameter is a value, not a pending reduction) or do not bind to the
    mesh."""
    from ..placements import normalize_placements

    report = FindingReport(name)
    for pattern, placements in (param_plan or {}).items():
        try:
            normalized = normalize_placements(placements, mesh.ndim, None)
        except (ValueError, TypeError) as e:
            report.add(Finding(CODES["VSC107"], f"plan entry {pattern!r} does not normalize: {e}",
                               where=pattern, severity=Severity.ERROR))
            continue
        for i, p in enumerate(normalized):
            if p.is_partial():
                report.add(Finding(
                    CODES["VSC107"],
                    f"plan entry {pattern!r} places a parameter as Partial on mesh dim {i} — "
                    "parameters are values, not pending reductions; use Replicate",
                    where=pattern,
                    mesh_dim=mesh.mesh_dim_names[i] if i < len(mesh.mesh_dim_names) else None,
                    severity=Severity.ERROR))
    return report
