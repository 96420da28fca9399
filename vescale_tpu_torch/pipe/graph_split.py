"""Graph-level automatic pipeline splitting on torch.fx.

The port of ``vescale_tpu/pipe/graph_split.py`` (legacy veScale's fx-based
PipeParser, pipe_parser.py:46, tracer.py:81,93): split an *arbitrary*
model function — not just one already structured as a list of blocks —
into balanced pipeline stages.

``fn(params, x)`` (``params`` a nested dict of tensors, ``x`` a tensor or
a tuple of them) is traced by ``torch.fx.experimental.proxy_tensor.make_fx``
into an aten-level graph, on real tensors.  Its topologically ordered node
list is cut into ``S·V`` contiguous ranges by ``_cuts_by_weight`` over a
FLOP cost per node (matmuls exact, the kernels' custom ops by their
wrappers' ``cost``, everything else its output elements, as the
reference's ``_eqn_flops`` counts equations), and each range is replayed
node by node.  Values produced before a cut and consumed after it become
the carried activation tuple — residual streams, tied embeddings and
multi-tensor carries all fall out of the dataflow.  Parameter leaves used
by more than one group are placed in each of them as a shared group;
leaves no node uses are parked in group 0.

The port's kernels are ``torch.library`` custom ops
(``vtt::flash_attention``, ``vtt::xent_parts``, with their backward ops),
so each launch is ONE node of the graph: replaying a group launches the
kernel on the card and its plain version on the CPU, and autograd
differentiates it through the op's registered backward.

``GraphPipeModule`` has ``PipeModule``'s surface (``group_forward`` /
``group_index`` / ``sync_shared_params_grads``), so ``PipeEngine`` and
every schedule run unmodified on split graphs.  Groups are
shape-specialized, as in the reference: trace with a microbatch-shaped
``x_example`` when ``PipeEngine`` drives the module.  The traced function
must be deterministic (no random draws).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils import _pytree as pytree

from ..plan import PipelineParallelPlan
from ..telemetry.costaudit import _MATMUL_LHS
from .pipe_stage import _cuts_by_weight, flatten_tree, tree_add, unflatten_tree
from .pipe_stage import activation_leaves as _vals, rebuild as _rebuild

__all__ = ["GraphPipeModule", "split_graph", "op_flops", "node_flops", "OpRecorder"]


def op_flops(target, args, out) -> float:
    """FLOP estimate for one op on its (real or meta) argument and output
    values.  A matmul gets exact MAC math (2·M·N·K, batched: costaudit's
    rule, 2 · lhs elements · output's last dim); a kernel's custom op its
    wrapper's ``cost``; everything else its output elements (so long
    elementwise chains still carry a little weight) — the reference's
    ``_eqn_flops`` rules on aten ops."""
    name = getattr(getattr(target, "overloadpacket", None), "__name__", str(target))
    outs = [t for t in _vals(out) if isinstance(t, torch.Tensor)]
    lhs_at = _MATMUL_LHS.get(name)
    if lhs_at is not None:
        return 2.0 * args[lhs_at].numel() * (outs[0].shape[-1] if outs[0].dim() else 1)
    if getattr(target, "namespace", None) == "vtt":
        cost = _kernel_cost(name, args)
        if cost is not None:
            return cost
    return float(sum(t.numel() for t in outs))


def node_flops(node) -> float:
    """:func:`op_flops` of one traced graph node (0 for placeholders,
    constants and the output)."""
    if node.op != "call_function":
        return 0.0
    args = [a.meta["val"] if isinstance(a, torch.fx.Node) else a for a in node.args]
    return op_flops(node.target, args, node.meta.get("val"))


def _kernel_cost(name: str, args):
    """A kernel op's FLOPs from its wrapper's ``cost`` on these arguments."""
    from ..kernels import cross_entropy as xent
    from ..kernels import flash_attention as fa

    if name == "flash_attention":
        q3, k3, v3, scale, causal, H, KV = args
        return float(fa.flash_fwd_cost(q3, k3, v3, causal=causal, H=H, KV=KV)[0])
    if name == "flash_attention_bwd":
        q3, k3, v3, o3, do3, lse, scale, causal, H, KV = args
        return float(fa.flash_bwd_cost(q3, k3, v3, o3, do3, lse, causal=causal, H=H, KV=KV)[0])
    if name == "xent_parts":
        return float(xent.xent_fwd_cost(*args)[0])
    if name == "xent_bwd":
        return float(xent.xent_bwd_cost(*args)[0])
    return None


class OpRecorder:
    """A ``TorchDispatchMode`` context that records every op run inside
    it: ``ops`` holds each op's name and first output's shape in order,
    ``flops`` the sum of their :func:`op_flops`.  ``matmul_shapes()`` are
    the matmuls' output shapes; ``weight_shaped(shapes)`` counts those
    with one of the given (parameter) shapes: a weight-gradient matmul
    writes a kernel's shape, an input-gradient matmul an activation's."""

    def __init__(self):
        self.ops: List[Tuple[str, Tuple[int, ...]]] = []
        self.flops = 0.0
        self._mode = None

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        rec = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                rec.flops += op_flops(func, args, out)
                first = next((t for t in _vals(out) if isinstance(t, torch.Tensor)), None)
                rec.ops.append((func.overloadpacket.__name__,
                                tuple(first.shape) if first is not None else ()))
                return out

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._mode = None
        return False

    def matmul_shapes(self) -> List[Tuple[int, ...]]:
        return [s for name, s in self.ops if name in _MATMUL_LHS]

    def weight_shaped(self, shapes) -> int:
        want = {tuple(s) for s in shapes}
        return sum(1 for s in self.matmul_shapes() if s in want)


def _node_inputs(node) -> List[torch.fx.Node]:
    return list(node.all_input_nodes)


class GraphPipeModule:
    """Pipeline groups cut from a traced graph (see the module docstring).

    ``params_per_group = module.partition_params(params)`` gives each group
    the parameter leaves its nodes consume (tied leaves in every consuming
    group, registered as a shared group, as ``PipeModule.shared_groups``);
    ``group_forward(g)`` is the plain ``(group_params, carry) -> carry``
    replay function.  Parameter names are the dotted paths of ``params``.
    """

    def __init__(self, fn: Callable, params_example, x_example, plan: PipelineParallelPlan):
        from torch.fx.experimental.proxy_tensor import make_fx

        self.plan = plan
        self.num_stages = plan.num_stages
        self.virtual_chunks = max(1, plan.virtual_chunks)
        n = self.num_stages * self.virtual_chunks

        flat = flatten_tree(params_example)
        self._param_names = list(flat)
        n_p = len(self._param_names)
        x_leaves = _vals(x_example)
        self._x_example = x_example
        out_spec: List[Any] = []

        def flat_fn(*args):
            p = unflatten_tree(dict(zip(self._param_names, args[:n_p])))
            x = _rebuild(x_example, list(args[n_p:]))
            leaves, spec = pytree.tree_flatten(fn(p, x))
            out_spec.append(spec)
            return leaves

        with torch.no_grad():
            gm = make_fx(flat_fn, tracing_mode="real")(
                *[t.detach() for t in flat.values()], *[t.detach() for t in x_leaves])
        self.graph_module = gm
        self._out_spec = out_spec[-1]
        nodes = list(gm.graph.nodes)
        placeholders = [nd for nd in nodes if nd.op == "placeholder"]
        self._param_vars = placeholders[:n_p]
        self._x_vars = placeholders[n_p:]
        # constants lifted by the tracer (get_attr) are available to every group
        self._consts = {nd: getattr(gm, nd.target) for nd in nodes if nd.op == "get_attr"}
        out_node = next(nd for nd in nodes if nd.op == "output")
        self._outvars = list(out_node.args[0])
        eqns = [nd for nd in nodes if nd.op == "call_function"]
        if n > max(1, len(eqns)):
            raise ValueError(f"{n} pipeline groups for a graph of {len(eqns)} nodes")
        cuts = _cuts_by_weight([node_flops(e) for e in eqns], n)
        self._bounds = [0] + list(cuts) + [len(eqns)]
        self._eqns = eqns

        # dataflow at each boundary: defs before the cut, uses at/after it
        var_of_param = dict(zip(self._param_vars, self._param_names))
        var_of_name = dict(zip(self._param_names, self._param_vars))
        self._carry_vars: List[List[Any]] = []  # carry INTO group g (g>=1)
        self._group_params: List[List[Tuple[str, Any]]] = []
        use_after: List[set] = [set() for _ in range(n + 1)]
        live = set(v for v in self._outvars if isinstance(v, torch.fx.Node))
        for g in range(n, 0, -1):
            lo, hi = self._bounds[g - 1], self._bounds[g]
            use_after[g - 1] = set(live)
            for eqn in eqns[lo:hi]:
                live |= set(_node_inputs(eqn))
            live -= set(eqns[lo:hi])
        for g in range(n):
            lo, hi = self._bounds[g], self._bounds[g + 1]
            used = set(v for e in eqns[lo:hi] for v in _node_inputs(e))
            pnames = sorted({var_of_param[v] for v in used if v in var_of_param})
            self._group_params.append([(nm, var_of_name[nm]) for nm in pnames])
            if g > 0:
                # carry = non-param, non-const values defined earlier and
                # still needed by this group or any later one (incl. outputs)
                need = use_after[g] | used
                carry = [
                    v
                    for v in self._iter_defs_before(lo)
                    if v in need and v not in var_of_param and v not in self._consts
                ]
                self._carry_vars.append(carry)

        # param leaves no node consumes: park them in group 0 so
        # partition/merge stays a lossless round-trip; they get zero grads
        assigned = {nm for plist in self._group_params for nm, _ in plist}
        for nm, var in zip(self._param_names, self._param_vars):
            if nm not in assigned:
                self._group_params[0].append((nm, var))

        # shared (tied) params: used by >1 group
        counts: Dict[str, List[int]] = {}
        for g, plist in enumerate(self._group_params):
            for nm, _ in plist:
                counts.setdefault(nm, []).append(g)
        self.shared_groups: Dict[str, List[Tuple[int, str]]] = {
            nm: [(g, nm) for g in gs] for nm, gs in counts.items() if len(gs) > 1
        }

    # ------------------------------------------------------------ helpers
    def _iter_defs_before(self, lo: int):
        for v in self._x_vars:
            yield v
        for eqn in self._eqns[:lo]:
            yield eqn

    @property
    def num_groups(self) -> int:
        return len(self._group_params)

    def group_index(self, stage: int, chunk: int = 0) -> int:
        return chunk * self.num_stages + stage

    def stage_of_group(self, g: int) -> Tuple[int, int]:
        return g % self.num_stages, g // self.num_stages

    def group_param_names(self, g: int) -> List[str]:
        return [nm for nm, _ in self._group_params[g]]

    def group_flops(self, g: int) -> float:
        return sum(node_flops(e) for e in self._eqns[self._bounds[g]:self._bounds[g + 1]])

    # ------------------------------------------------------------- params
    def partition_params(self, params) -> List[Dict[str, Any]]:
        """Split a full params tree into per-group {name: leaf} dicts (tied
        leaves go into every consuming group)."""
        by_name = flatten_tree(params)
        return [{nm: by_name[nm] for nm, _ in plist} for plist in self._group_params]

    def merge_params(self, params_per_group) -> Any:
        """Inverse of partition_params (shared leaves: first group wins)."""
        by_name: Dict[str, Any] = {}
        for d in reversed(params_per_group):
            by_name.update(d)
        return unflatten_tree({nm: by_name[nm] for nm in self._param_names})

    # ------------------------------------------------------------ forward
    def group_forward(self, g: int) -> Callable:
        lo, hi = self._bounds[g], self._bounds[g + 1]
        eqns = self._eqns[lo:hi]
        plist = self._group_params[g]
        last = g == self.num_groups - 1
        carry_in = self._carry_vars[g - 1] if g > 0 else None
        carry_out = self._carry_vars[g] if not last else None

        def bind(env, var, val):
            want = tuple(var.meta["val"].shape)
            if tuple(getattr(val, "shape", ())) != want:
                raise ValueError(
                    f"graph pipeline stages are shape-specialized: got "
                    f"{tuple(getattr(val, 'shape', ()))} for traced {want}.  Trace "
                    f"split_graph with a microbatch-sized x_example."
                )
            env[var] = val

        def fwd(group_params, x):
            env = dict(self._consts)
            for nm, var in plist:
                env[var] = group_params[nm]
            if g == 0:
                for var, leaf in zip(self._x_vars, _vals(x)):
                    bind(env, var, leaf)
            else:
                for var, val in zip(carry_in, x):
                    bind(env, var, val)
            for nd in eqns:
                args, kwargs = torch.fx.node.map_arg((nd.args, nd.kwargs), lambda a: env[a])
                env[nd] = nd.target(*args, **kwargs)
            if last:
                outs = [env[v] if isinstance(v, torch.fx.Node) else v for v in self._outvars]
                return pytree.tree_unflatten(outs, self._out_spec)
            return tuple(env[v] for v in carry_out)

        return fwd

    def stage_forward(self, stage: int, chunk: int = 0) -> Callable:
        return self.group_forward(self.group_index(stage, chunk))

    def full_forward(self, params, x):
        """Chain every group (debugging, parity checks)."""
        pg = self.partition_params(params)
        y = x
        for g in range(self.num_groups):
            y = self.group_forward(g)(pg[g], y)
        return y

    # ------------------------------------------------------------- shared
    def sync_shared_params_grads(self, grads_per_group):
        """Sum tied-param grads across their groups (PipeModule parity)."""
        for nm, members in self.shared_groups.items():
            total = None
            for g, _ in members:
                gr = grads_per_group[g].get(nm)
                if gr is None:
                    continue
                total = gr if total is None else tree_add(total, gr)
            for g, _ in members:
                if nm in grads_per_group[g]:
                    grads_per_group[g][nm] = total
        return grads_per_group


def split_graph(
    fn: Callable,
    params_example,
    x_example,
    plan: PipelineParallelPlan,
) -> GraphPipeModule:
    """Trace ``fn(params, x)`` and cut it into ``num_stages *
    virtual_chunks`` FLOP-balanced pipeline groups (reference
    pipe_parser.py:46 parse + construct_pipeline_stage, in one step)."""
    return GraphPipeModule(fn, params_example, x_example, plan)
