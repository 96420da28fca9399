"""veScale-FSDP: ragged flat parameter buffers (ZeRO-3).

The port of ``vescale_tpu/parallel/fsdp.py`` (new-gen veScale FSDP,
``RaggedShard``, arXiv:2602.22437).  Every parameter of one dtype goes
into one flat buffer whose shard boundaries fall on parameter boundaries
(``_DtypeGroup._balanced_units``, the reference's greedy split), so:

  * the parameters come back in one all-gather-v a dtype group
    (``collectives.gather_v``, each member's piece padded to the
    largest), and the gradients go back in one reduce-scatter-v, padded
    the same way (``collectives.reduce_scatter_v``); both move in windows
    of ``ddp.DEFAULT_BUCKET`` elements, so a backend that stages through
    the host holds no more at once;
  * a checkpoint needs no communication: each parameter's chunk lives on
    one rank (``local_params``).

The leaves go in the reference's order: JAX flattens a dict by sorted key,
so the flat layout, the units and ``local_params`` are the reference's
(``layers_10`` sorts before ``layers_2``).  Each rank holds its ragged
piece unpadded (the reference keeps a padded rank-major physical buffer;
``models/convert.py::fsdp_buffer_from_jax`` cuts it).  The optimizer steps
the flat piece: one ``AdamWLowmem`` leaf, so one K8 launch, a dtype group.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import collectives as C
from ..mesh import DeviceMesh
from ..placements import RaggedShard, Replicate, Shard
from ..spec import DArraySpec, TensorMeta
from .ddp import DEFAULT_BUCKET

__all__ = ["FSDPParamBuffer", "fsdp_plan", "make_fsdp_train_step", "sorted_leaves"]


def sorted_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(dotted path, leaf) of a nested dict in ``jax.tree_util``'s order:
    keys sorted at every level."""
    out: List[Tuple[str, Any]] = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.extend(sorted_leaves(v, path))
        else:
            out.append((path, v))
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rpartition(".")[2]


def fsdp_plan(abstract_params, mesh: DeviceMesh, dim: str = "dp") -> Dict[str, Any]:
    """A per-parameter plan (the simple, non-ragged FSDP): each
    parameter's largest dim that the ``dim`` world divides is sharded over
    it; keys are escaped dotted paths (a leading ``params`` collection key
    dropped), in the reference's order."""
    n = mesh.size(dim)
    di = mesh._dim_index(dim)
    tree = abstract_params
    if set(tree) == {"params"}:
        tree = tree["params"]
    plan: Dict[str, Any] = {}
    for path, leaf in sorted_leaves(tree):
        shape = tuple(leaf.shape)
        best = next((d for d in sorted(range(len(shape)), key=lambda d: -shape[d])
                     if shape[d] % n == 0 and shape[d] >= n), None)
        placements = [Replicate()] * mesh.ndim
        if best is not None:
            placements[di] = Shard(best)
        plan[re.escape(path)] = placements
    return plan


class _DtypeGroup:
    """One flat ragged buffer: every parameter of one dtype."""

    def __init__(self, indices, shapes, sizes, dtype, mesh, dim_index, n):
        self.indices = indices      # positions in the sorted leaf list
        self.shapes = shapes
        self.sizes = sizes
        self.dtype = dtype
        self.offsets = [0]
        for s in sizes[:-1]:
            self.offsets.append(self.offsets[-1] + s)
        self.total = int(sum(sizes))
        self.local_units = self._balanced_units(n)
        placements = [Replicate()] * mesh.ndim
        placements[dim_index] = RaggedShard((0,), self.local_units)
        self.spec = DArraySpec(mesh, placements, TensorMeta((self.total,), dtype))

    def _balanced_units(self, n: int) -> Tuple[int, ...]:
        """Greedy contiguous split of the parameters into ``n`` rank groups
        balancing element counts (reference build_gbuf_range); boundaries
        on parameter boundaries, ranks may be empty."""
        target = self.total / n
        units = [0] * n
        r, consumed = 0, 0
        for s in self.sizes:
            while r < n - 1 and consumed >= target * (r + 1):
                r += 1
            units[r] += s
            consumed += s
        assert sum(units) == self.total, (units, self.total)
        return tuple(units)


class FSDPParamBuffer:
    """Flat ragged buffers over every parameter, one a dtype group.

    ``abstract_params``: a nested dict (the flax tree) of tensors (``meta``
    ones will do: only shapes and dtypes are read).  ``dim``: the mesh dim
    to shard over.  ``pack`` gives this rank's pieces, ``{dtype name:
    flat piece}``."""

    def __init__(self, abstract_params, mesh: DeviceMesh, dim: str = "dp"):
        self.mesh = mesh
        self.dim = dim
        self.dim_index = mesh._dim_index(dim)
        n = mesh.size(dim)
        leaves = sorted_leaves(abstract_params)
        self.paths = [p for p, _ in leaves]
        self.n_leaves = len(leaves)
        by_dtype: Dict[str, List[int]] = {}
        for i, (_, leaf) in enumerate(leaves):
            by_dtype.setdefault(_dtype_name(leaf.dtype), []).append(i)
        self.groups: Dict[str, _DtypeGroup] = {}
        for name, idxs in sorted(by_dtype.items()):
            shapes = [tuple(leaves[i][1].shape) for i in idxs]
            sizes = [int(torch.Size(s).numel()) for s in shapes]
            self.groups[name] = _DtypeGroup(idxs, shapes, sizes, leaves[idxs[0]][1].dtype, mesh,
                                            self.dim_index, n)

    @property
    def local_units(self) -> Tuple[int, ...]:
        """Per-rank units summed over the dtype groups."""
        n = self.mesh.size(self.dim)
        return tuple(sum(g.local_units[r] for g in self.groups.values()) for r in range(n))

    def _coord(self, rank: Optional[int] = None):
        if rank is None:
            return self.mesh.get_coordinate() if self.mesh.is_live else (0,) * self.mesh.ndim
        return self.mesh.coordinate_of_rank(rank)

    def _sizes(self, g: _DtypeGroup) -> List[int]:
        coord = list(self._coord())
        out = []
        for r in range(self.mesh.size(self.dim)):
            coord[self.dim_index] = r
            out.append(g.spec.ragged_local_chunk(coord)[0])
        return out

    def _group(self):
        return self.mesh.get_group(self.dim_index)

    # ------------------------------------------------------------ packing
    def _leaf_list(self, params) -> List[torch.Tensor]:
        flat = dict(sorted_leaves(params))
        if set(flat) != set(self.paths):
            raise ValueError(f"params do not match the buffer: missing "
                             f"{sorted(set(self.paths) - set(flat))[:3]}, unexpected "
                             f"{sorted(set(flat) - set(self.paths))[:3]}")
        return [flat[p] for p in self.paths]

    def flatten(self, params) -> Dict[str, torch.Tensor]:
        """A params tree as per-dtype flat logical buffers."""
        leaves = self._leaf_list(params)
        return {name: torch.cat([leaves[i].reshape(-1).to(g.dtype) for i in g.indices])
                for name, g in self.groups.items()}

    def unflatten(self, flats: Dict[str, torch.Tensor]):
        """Per-dtype flat buffers as the params tree (views into them)."""
        flat: Dict[str, Any] = {}
        for name, g in self.groups.items():
            for i, off, size, shape in zip(g.indices, g.offsets, g.sizes, g.shapes):
                flat[self.paths[i]] = flats[name].narrow(0, off, size).view(shape)
        from .optimizer import _nest

        return _nest(flat)

    def pack(self, params) -> Dict[str, torch.Tensor]:
        """This rank's ragged piece of each dtype group, a copy."""
        coord = self._coord()
        out = {}
        for name, flat in self.flatten(params).items():
            size, off = self.groups[name].spec.ragged_local_chunk(coord)
            out[name] = flat.narrow(0, off, size).clone()
        return out

    def gather(self, pieces: Dict[str, torch.Tensor], out: Optional[Dict[str, torch.Tensor]] = None):
        """Every rank's pieces as the params tree: one all-gather-v a dtype
        group (into the flat buffers ``out`` when given)."""
        flats = {}
        for name, g in self.groups.items():
            flats[name] = C.gather_v(pieces[name], self._sizes(g), self._group(),
                                     bucket=DEFAULT_BUCKET,
                                     out=None if out is None else out[name])
        return self.unflatten(flats)

    def reduce_scatter(self, flats: Dict[str, torch.Tensor],
                       reduce_op: str = "avg") -> Dict[str, torch.Tensor]:
        """Per-dtype flat gradients reduced over the dim into this rank's
        pieces: one reduce-scatter-v a dtype group."""
        return {name: C.reduce_scatter_v(flats[name], self._sizes(g), self._group(), reduce_op,
                                         bucket=DEFAULT_BUCKET)
                for name, g in self.groups.items()}

    def constrain(self, pieces: Dict[str, torch.Tensor]):
        """This rank's pieces as ``DArray``s of the ragged buffer specs
        (their sizes checked)."""
        from ..darray import DArray

        rank = self.mesh.get_rank() if self.mesh.is_live else 0
        coord = self._coord()
        out = {}
        for name, g in self.groups.items():
            want = g.spec.ragged_local_chunk(coord)[0]
            if pieces[name].numel() != want:
                raise ValueError(f"{name}: a piece of {pieces[name].numel()} elements, the "
                                 f"layout gives this rank {want}")
            out[name] = DArray(pieces[name].reshape(-1), g.spec, rank)
        return out

    def buffer_templates(self) -> Dict[str, Any]:
        """``{dtype name: DArray template (no data)}`` of the flat ragged
        buffers, for ``checkpoint.load``: a world-size change moves the
        shard boundaries, and the load fills each new piece from whichever
        saved chunks it intersects.  Optimizer-state buffers of the same
        layout load through the same templates."""
        from ..darray import DArray

        rank = self.mesh.get_rank() if self.mesh.is_live else 0
        return {name: DArray(None, g.spec, rank) for name, g in self.groups.items()}

    def local_params(self, rank: int) -> List[Tuple[int, int]]:
        """[(parameter index, offset in it)] of the parameters ``rank``
        holds wholly or in part: the checkpoint's chunk map."""
        coord = self.mesh.coordinate_of_rank(rank)
        out = []
        for g in self.groups.values():
            size, off = g.spec.ragged_local_chunk(coord)
            for i, o, s in zip(g.indices, g.offsets, g.sizes):
                lo, hi = max(o, off), min(o + s, off + size)
                if lo < hi:
                    out.append((i, lo - o))
        return out


def make_fsdp_train_step(model, optimizer: Callable[[List[Dict[str, Any]]], torch.optim.Optimizer],
                         loss_fn: Callable, buffer: FSDPParamBuffer):
    """A ZeRO-3 train step over the ragged buffer, ``step(batch) -> loss``:
    gather the parameters (one all-gather-v a dtype group), forward and
    backward, reduce-scatter the flat gradients (one reduce-scatter-v a
    dtype group, averaged over the dim: each rank's loss is its own rows'
    mean), and step ``optimizer`` on this rank's flat pieces.

    ``model`` (a module, or a ``DModule`` with an empty plan) holds the
    full parameters, the same on every rank, when this is called; they
    become views into one flat buffer a dtype group, refilled by each
    step's gather, and their gradients views into another.  ``optimizer``
    makes the optimizer from one parameter group a dtype group, e.g.
    ``functools.partial(AdamWLowmem, lr=3e-4)``: one fused-AdamW launch a
    group.  The returned loss is the mean over the dim's ranks.
    ``step.pieces`` holds this rank's pieces, ``step.optimizer`` the
    optimizer; ``step.gather()`` refills the model from the pieces."""
    module = getattr(model, "module", model)
    named = dict(module.named_parameters())
    if set(named) != set(buffer.paths):
        raise ValueError(f"the model's parameters are not the buffer's: "
                         f"{sorted(set(named) ^ set(buffer.paths))[:4]}")
    dev = next(iter(named.values())).device
    tree = {p: named[p].detach() for p in buffer.paths}
    from .optimizer import _nest

    flats = buffer.flatten(_nest(tree))
    coord = buffer._coord()
    pieces, fulls, grads = {}, {}, {}
    for name, g in buffer.groups.items():
        size, off = g.spec.ragged_local_chunk(coord)
        pieces[name] = flats[name].narrow(0, off, size).clone()
        fulls[name] = flats[name]
        grads[name] = torch.zeros(g.total, dtype=g.dtype, device=dev)
        for i, o, s, shape in zip(g.indices, g.offsets, g.sizes, g.shapes):
            named[buffer.paths[i]].data = fulls[name].narrow(0, o, s).view(shape)
    del flats, tree
    opt = optimizer([{"params": [pieces[name]]} for name in buffer.groups])
    dp_group = buffer._group()

    def step(batch):
        buffer.gather(pieces, out=fulls)
        for name, g in buffer.groups.items():
            grads[name].zero_()
            for i, o, s, shape in zip(g.indices, g.offsets, g.sizes, g.shapes):
                named[buffer.paths[i]].grad = grads[name].narrow(0, o, s).view(shape)
        loss = loss_fn(module(batch["input"]), batch)
        loss.backward()
        reduced = buffer.reduce_scatter(grads, "avg")
        for name in buffer.groups:
            pieces[name].grad = reduced[name]
        opt.step()
        for name in buffer.groups:
            pieces[name].grad = None
        for p in named.values():
            p.grad = None
        loss = loss.detach().float().reshape(1)
        return C.all_reduce(loss, dp_group, "avg")[0]

    step.pieces = pieces
    step.optimizer = opt
    step.buffer = buffer
    # refill the model's parameters from the pieces (a step gathers first
    # thing, so after one the model holds the parameters it started from)
    step.gather = lambda: buffer.gather(pieces, out=fulls)
    return step
