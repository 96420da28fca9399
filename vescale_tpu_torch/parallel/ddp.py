"""DDP: data parallelism over a mesh dim.

The port of ``vescale_tpu/parallel/ddp.py`` (reference
DistributedDataParallel, legacy ``ddp/distributed_data_parallel.py:20``,
and its GradBuffer, ``ddp/grad_buffer.py:226``).  Under GSPMD the
reference's gradient reduce is structural; here it is explicit:

  * ``DistributedDataParallel.finish_grad_sync()`` averages every
    parameter's gradient over the dp dim (each rank's loss is the mean of
    its own rows, so the mean of the ranks' gradients is the gradient of
    the global mean); a parameter the ``DModule``'s plan shards over the
    dp dim (``DModule.dp_sharded``) already holds the ranks' sum and is
    divided by the dp size instead.  The gradients go in flat per-dtype
    buckets of ``bucket_size`` elements, in fp32 with
    ``accumulate_allreduce_grads_in_fp32``: one all-reduce a bucket, which
    also bounds what a backend that stages through the host (gloo on CUDA
    tensors) holds at once.
  * ``finish_grad_sync(grads)`` over a tree of ``DArray`` gradients
    reduces each leaf that is Partial on the dp dim to Replicate, or to
    Shard(0) under ``use_distributed_optimizer`` (``_reduce_partial_leaf``);
    other Partial dims keep each rank's contribution.
  * ``grad_compress="int8"`` (or ``VESCALE_GRAD_COMPRESS=int8``) moves
    block-scaled int8 instead, through the general int8 transition
    (``transfer.quant_transition_fn``: the quantized all-reduce or
    reduce-scatter on the reference's physical shard); a pair with no
    quantizable plan warns and reduces exactly.
  * ``dp_grad_reduce`` reduces a tree of local gradients over a process
    group, exact or int8.

The flat-bucket helpers here also carry ``DistributedOptimizer``'s
reduce-scatter and all-gather (``parallel/optimizer.py``).
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import collectives as C
from ..mesh import DeviceMesh
from ..placements import Replicate, Shard

__all__ = ["DistributedDataParallel", "dp_grad_reduce", "resolve_grad_compress"]

DEFAULT_BUCKET = 40_000_000  # elements, the reference's bucket_size


def resolve_grad_compress(grad_compress) -> Optional[str]:
    """An explicit argument wins; None defers to ``VESCALE_GRAD_COMPRESS``
    (empty: off).  Only ``"int8"`` is defined."""
    if grad_compress is None:
        from .. import config

        grad_compress = config.get_str("VESCALE_GRAD_COMPRESS") or None
    if grad_compress in (None, "", "none", "off"):
        return None
    if grad_compress != "int8":
        raise ValueError(f"grad_compress must be None or 'int8', got {grad_compress!r}")
    return "int8"


def tree_map(fn, tree, is_leaf=None):
    """``fn`` over the leaves of nested dicts (in sorted key order, as
    ``jax.tree_util`` visits them), lists and tuples."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, is_leaf) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree, is_leaf=lambda x: not isinstance(x, (dict, list, tuple)))
    return out


def dp_grad_reduce(grads, group, *, compress: Optional[str] = None, block: Optional[int] = None,
                   rounding: Optional[str] = None, key=None, step: Optional[int] = None,
                   reduce_op: str = "sum"):
    """Reduce a tree of this rank's gradients over ``group`` (the dp
    ranks); every rank gets the same tree.  Exact (``all_reduce``) unless
    ``compress`` (default: the knob) is ``"int8"``: then each leaf goes
    through ``collectives.q_psum``, its stochastic-rounding key folded
    with ``step`` and the leaf's index."""
    if reduce_op not in ("sum", "avg"):
        raise ValueError(f"dp_grad_reduce supports sum/avg, got {reduce_op!r}")
    compress = resolve_grad_compress(compress)
    if compress is None:
        return tree_map(lambda g: C.all_reduce(g, group, reduce_op), grads)
    from ..random import fold_in

    block, rounding, key = C._compress_defaults(block, rounding, key)
    if rounding == "stochastic" and step is not None:
        key = fold_in(key, step)
    idx = iter(range(1 << 62))

    def one(g):
        i = next(idx)
        k = None if key is None else fold_in(key, i)
        return C.q_psum(g, group, block=block, rounding=rounding, key=k, reduce_op=reduce_op)

    return tree_map(one, grads)


def _reduce_partial_leaf(g, dp_index: int, target, compress: Optional[str],
                         block: Optional[int]):
    """One DArray leaf, Partial on mesh dim ``dp_index``, reduced there to
    ``target`` (Replicate or Shard(0)): through the int8 transition
    (``transfer.quant_transition_fn``, any pair with a quantizable plan)
    where ``compress`` says so, else the exact ``redistribute``."""
    new = list(g.placements)
    new[dp_index] = target
    if compress == "int8":
        from ..redistribute_plan import physical_shard_bytes
        from ..transfer import quant_transition_fn

        blk, rounding = C._compress_settings(block, None)
        dst = g.spec.with_placements(tuple(new))
        fn = quant_transition_fn(g.spec, dst, blk, rounding)
        if fn is not None:
            # a fresh key each reduction: no mask repeats across steps
            out = fn(g, C.next_sr_key()) if rounding == "stochastic" else fn(g)
            itemsize = g.to_local().element_size()
            # a rank's payload: a grad sharded on another mesh dim moves its piece
            C._compress_telemetry(physical_shard_bytes(g.spec) // itemsize, itemsize, blk,
                                  "reduce_scatter" if target.is_shard() else "all_reduce",
                                  g.mesh.size(dp_index))
            return out
        warnings.warn(
            f"grad_compress='int8': no quantized route for {[str(p) for p in g.placements]} -> "
            f"{[str(p) for p in new]} (shape {g.shape}); falling back to the exact reduction",
            stacklevel=3)
    return g.redistribute(placements=new)


# ------------------------------------------------------- flat buckets
def bucket_windows(sizes: Sequence[int], bucket: int) -> List[List[Tuple[int, int, int]]]:
    """The concatenation of tensors of ``sizes`` elements cut into windows
    of ``bucket`` elements: each window a list of (tensor index, offset
    in it, count).  A tensor larger than a bucket spans several."""
    bucket = max(1, int(bucket))
    out, cur, room = [], [], bucket
    for i, n in enumerate(sizes):
        off = 0
        while off < n:
            take = min(room, n - off)
            cur.append((i, off, take))
            off += take
            room -= take
            if room == 0:
                out.append(cur)
                cur, room = [], bucket
    if cur:
        out.append(cur)
    return out


def bucketed_all_reduce(tensors: Sequence[torch.Tensor], group, reduce_op: str, bucket: int, *,
                        fp32: bool = True, compress: Optional[str] = None,
                        block: Optional[int] = None, mesh: Optional[DeviceMesh] = None,
                        mesh_dim=0) -> None:
    """Reduce every tensor over ``group`` in place, through flat buckets
    of ``bucket`` elements (fp32 with ``fp32``): one all-reduce a bucket,
    or one ``all_reduce_q`` over ``mesh``'s ``mesh_dim`` with ``compress``."""
    flats = [t.view(-1) for t in tensors]
    for win in bucket_windows([f.numel() for f in flats], bucket):
        parts = [flats[i].narrow(0, off, n) for i, off, n in win]
        buf = torch.cat([p.float() for p in parts] if fp32 else parts)
        if compress == "int8":
            out = C.all_reduce_q(buf, mesh, reduce_op, mesh_dim, block=block)
        else:
            out = C.all_reduce(buf, group, reduce_op)
        o = 0
        for p in parts:
            p.copy_(out.narrow(0, o, p.numel()))
            o += p.numel()


def bucketed_reduce_scatter(flats: Sequence[torch.Tensor], group, reduce_op: str, bucket: int, *,
                            compress: Optional[str] = None, block: Optional[int] = None,
                            mesh: Optional[DeviceMesh] = None, mesh_dim=0) -> List[torch.Tensor]:
    """Each flat tensor is n equal rank-major chunks (n the group size);
    return this member's chunk of each, reduced over the group.  The
    chunks go in flat buckets (``bucket`` elements over all members): a
    bucket's input is, for each member j in turn, the pieces of chunk j
    it holds, so one reduce-scatter (or ``reduce_scatter_q``) a bucket."""
    n = dist.get_world_size(group)
    chunk = []
    for f in flats:
        if f.numel() % n:
            raise ValueError(f"bucketed_reduce_scatter: {f.numel()} elements over {n} members")
        chunk.append(f.numel() // n)
    outs = [f.new_empty(c) for f, c in zip(flats, chunk)]
    for win in bucket_windows(chunk, max(1, bucket // n)):
        buf = torch.cat([flats[i].narrow(0, j * chunk[i] + off, cnt)
                         for j in range(n) for i, off, cnt in win])
        if compress == "int8":
            red = C.reduce_scatter_q(buf, mesh, reduce_op, 0, mesh_dim, block=block)
        else:
            red = C.reduce_scatter(buf, group, reduce_op)
        o = 0
        for i, off, cnt in win:
            outs[i].narrow(0, off, cnt).copy_(red.narrow(0, o, cnt))
            o += cnt
    return outs


def bucketed_all_gather(pieces: Sequence[torch.Tensor], outs: Sequence[torch.Tensor], group,
                        bucket: int) -> None:
    """The inverse of :func:`bucketed_reduce_scatter`: every member's
    piece of each tensor (equal sizes) written into ``outs`` (flat, n
    rank-major chunks), one all-gather a bucket."""
    n = dist.get_world_size(group)
    sizes = [p.numel() for p in pieces]
    for win in bucket_windows(sizes, max(1, bucket // n)):
        buf = torch.cat([pieces[i].reshape(-1).narrow(0, off, cnt) for i, off, cnt in win])
        got = C.all_gather(buf, group).view(n, -1)
        for j in range(n):
            o = 0
            for i, off, cnt in win:
                outs[i].narrow(0, j * sizes[i] + off, cnt).copy_(got[j].narrow(0, o, cnt))
                o += cnt


class DistributedDataParallel:
    """A module made data parallel on the mesh dim ``dp_dim``.

    ``module`` is a ``DModule`` (its mesh is the default) or a plain
    module with ``data_pg_or_device_mesh``.  The reference constructor's
    other flags (``overlap_grad_reduce``, ``disable_bucketing``) are
    accepted and change nothing: the reduce runs after backward, in
    buckets."""

    def __init__(self, module, data_pg_or_device_mesh: Optional[DeviceMesh] = None,
                 dp_dim: str = "dp", accumulate_allreduce_grads_in_fp32: bool = True,
                 use_distributed_optimizer: bool = False, bucket_size: int = DEFAULT_BUCKET,
                 grad_compress: Optional[str] = None, compress_block: Optional[int] = None,
                 **_: Any) -> None:
        self.module = module
        self.mesh = data_pg_or_device_mesh or module.mesh
        self.dp_dim = dp_dim
        self.accumulate_in_fp32 = accumulate_allreduce_grads_in_fp32
        self.use_distributed_optimizer = use_distributed_optimizer
        self.bucket_size = int(bucket_size)
        # "int8": block-scaled quantized collectives, lossy within a bound
        # a block; None defers to VESCALE_GRAD_COMPRESS
        self.grad_compress = resolve_grad_compress(grad_compress)
        self.compress_block = compress_block

    # ------------------------------------------------------------- apply
    def __call__(self, *args, **kwargs):
        return self.module(*args, **kwargs)

    apply = __call__

    def parameters(self, recurse: bool = True):
        return self.module.parameters(recurse)

    def named_parameters(self, *args, **kwargs):
        return self.module.named_parameters(*args, **kwargs)

    @property
    def dp_size(self) -> int:
        return self.mesh.size(self.dp_dim)

    def dp_rank(self) -> int:
        return self.mesh.get_coordinate()[self.mesh._dim_index(self.dp_dim)]

    def shard_batch(self, batch):
        """This rank's rows of a global batch (dim 0 split evenly over the
        dp dim, as ``Shard(0)`` on it): a tensor or a dict of tensors."""
        n, r = self.dp_size, self.dp_rank()

        def one(x):
            if x.shape[0] % n:
                raise ValueError(f"batch dim {x.shape[0]} not divisible by dp={n}")
            b = x.shape[0] // n
            return x.narrow(0, r * b, b)

        return tree_map(one, batch)

    # ----------------------------------------------------- grad handling
    def init_main_grads(self, params):
        """fp32 zero accumulators shaped as ``params`` (a tree of tensors)."""
        dt = torch.float32 if self.accumulate_in_fp32 else None
        return tree_map(lambda p: torch.zeros(p.shape, dtype=dt or p.dtype, device=p.device),
                        params)

    def accumulate_grads(self, main_grads, micro_grads):
        """main_grad + micro_grad, in main_grad's dtype."""
        micro = iter(tree_leaves(micro_grads))
        return tree_map(lambda a: a + next(micro).to(a.dtype), main_grads)

    def scale_grads(self, main_grads, num_micro: int):
        return tree_map(lambda g: g / num_micro, main_grads)

    def finish_grad_sync(self, grads=None):
        """With ``grads`` (a tree of DArrays): each leaf Partial on the dp
        dim reduced there to Replicate, or to Shard(0) under
        ``use_distributed_optimizer``; other leaves unchanged.  Without:
        the module's parameter gradients averaged over the dp dim in place
        (flat buckets); under ``use_distributed_optimizer`` that reduce is
        ``DistributedOptimizer.reduce_grads``'s and nothing runs here."""
        from ..darray import DArray

        dp_index = self.mesh._dim_index(self.dp_dim)
        if grads is not None:
            target = Shard(0) if self.use_distributed_optimizer else Replicate()

            def one(g):
                if isinstance(g, DArray) and g.placements[dp_index].is_partial():
                    return _reduce_partial_leaf(g, dp_index, target, self.grad_compress,
                                                self.compress_block)
                return g

            return tree_map(one, grads, is_leaf=lambda x: isinstance(x, DArray))
        if self.use_distributed_optimizer or self.dp_size == 1:
            return None
        # a parameter the plan shards over the dp dim arrives with the dp
        # ranks' gradients summed (its forward's gather): their average
        # is that sum over the dim's size, with no reduce of its own
        gathered = {id(p) for n, p in self.module.named_parameters()
                    if n in getattr(self.module, "dp_sharded", ())}
        grads = []
        for p in self.module.parameters():
            if p.grad is None:
                continue
            if id(p) in gathered:
                p.grad.div_(self.dp_size)
            else:
                grads.append(p.grad)
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for group in by_dtype.values():
            bucketed_all_reduce(group, self.mesh.get_group(dp_index), "avg", self.bucket_size,
                                fp32=self.accumulate_in_fp32, compress=self.grad_compress,
                                block=self.compress_block, mesh=self.mesh, mesh_dim=dp_index)
        return None
