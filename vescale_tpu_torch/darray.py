"""DArray: the distributed tensor of the SPMD core.

The port of ``vescale_tpu/darray.py``.  A reference ``DArray`` is one global
``jax.Array`` plus a ``DArraySpec``; here it is this rank's local tensor
plus the spec, as the legacy veScale DTensor holds it.  ``full_tensor`` and
``redistribute`` move pieces between ranks over the mesh's process groups.

Every constructor takes ``rank=``: the flat mesh position whose piece to
build.  It defaults to this process's position in a live mesh; on a
layout-only mesh it names any rank, so one process can compute every
rank's piece (tests, checks of a layout on one card).

``distribute_tensor`` slices the full tensor locally, with no collective
("replicate -> shard is a local slice"); a replicated piece is the tensor
itself, moved to the mesh's device, not a copy.  The factories make only
this rank's piece; ``randn`` and ``rand`` draw it from the global-index RNG
of ``random.py``, so any layout gives the same values as one device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import DeviceMesh
from .placements import InterleavedShard, Placement, RaggedShard, Replicate, Shard, normalize_placements
from .spec import DArraySpec, TensorMeta

__all__ = [
    "DArray",
    "from_local",
    "distribute_tensor",
    "redistribute_dtensor",
    "full_tensor",
    "zeros",
    "ones",
    "empty",
    "full",
    "randn",
    "rand",
    "arange",
]


def _resolve_rank(mesh: DeviceMesh, rank: Optional[int]) -> int:
    if rank is None:
        return mesh.get_rank()
    if not 0 <= rank < mesh.size():
        raise ValueError(f"rank {rank} outside a mesh of {mesh.size()}")
    return int(rank)


class DArray:
    """One rank's piece of a distributed tensor with veScale placements."""

    __slots__ = ("_local", "_spec", "_rank")

    def __init__(self, local: torch.Tensor, spec: DArraySpec, rank: int):
        self._local = local
        self._spec = spec
        self._rank = rank

    # ----------------------------------------------------------- metadata
    @property
    def spec(self) -> DArraySpec:
        return self._spec

    @property
    def mesh(self) -> DeviceMesh:
        return self._spec.mesh

    @property
    def placements(self) -> Tuple[Placement, ...]:
        return self._spec.placements

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._spec.shape

    @property
    def ndim(self) -> int:
        return len(self._spec.shape)

    @property
    def dtype(self):
        return self._spec.dtype

    @property
    def device(self) -> torch.device:
        return self._local.device

    @property
    def rank(self) -> int:
        """The flat mesh position whose piece this is."""
        return self._rank

    @property
    def coordinate(self) -> Tuple[int, ...]:
        return self.mesh.coordinate_of_rank(self._rank)

    def __repr__(self) -> str:
        return f"DArray(shape={self.shape}, dtype={self.dtype}, spec={self._spec}, rank={self._rank})"

    # ------------------------------------------------------------- views
    def to_local(self) -> torch.Tensor:
        """This rank's local tensor (reference DTensor.to_local)."""
        return self._local

    def full_tensor(self) -> torch.Tensor:
        """The logical global value: shards gathered, partials reduced
        (reference api full_tensor)."""
        return self.redistribute(placements=[Replicate()] * self.mesh.ndim).to_local()

    def redistribute(self, mesh: Optional[DeviceMesh] = None, placements=None,
                     async_op: bool = False) -> "DArray":
        from .redistribute import redistribute as _redis

        return _redis(self, placements, mesh=mesh)

    # ------------------------------------------------------ arithmetic
    # The reference's curated eager op set for same-spec elementwise math.
    def _partial_ops(self):
        return [p.reduce_op for p in self.placements if p.is_partial()]

    def _elementwise(self, other, op, reverse=False):
        partial_ops = self._partial_ops()
        if isinstance(other, DArray):
            if other._spec != self._spec:
                raise ValueError(
                    f"eager elementwise op requires matching specs; "
                    f"got {self._spec} vs {other._spec} — redistribute first"
                )
            if partial_ops and (op is not torch.add or any(o not in ("sum",) for o in partial_ops)):
                raise ValueError("only + over Partial(sum) operands is linear")
            a, b = self._local, other._local
        else:
            # scalar: only * on Partial(sum/avg) commutes with the reduction
            # (and for max/min only a non-negative scalar would — disallow)
            if partial_ops and (op is not torch.mul or any(o not in ("sum", "avg") for o in partial_ops)):
                raise ValueError("only scalar * on Partial(sum/avg) is safe; redistribute first")
            a, b = self._local, other
            if isinstance(b, np.ndarray):
                b = torch.from_numpy(b).to(a.device)
        if reverse:
            a, b = b, a
        out = op(a, b)
        if tuple(out.shape) != tuple(self._local.shape):
            raise ValueError(
                f"elementwise result shape {tuple(out.shape)} != local shape "
                f"{tuple(self._local.shape)}; broadcasting against a DArray is not supported eagerly"
            )
        return DArray(out, self._spec, self._rank)

    def __add__(self, o):
        return self._elementwise(o, torch.add)

    __radd__ = __add__

    def __sub__(self, o):
        return self._elementwise(o, torch.sub)

    def __rsub__(self, o):
        return self._elementwise(o, torch.sub, reverse=True)

    def __mul__(self, o):
        return self._elementwise(o, torch.mul)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._elementwise(o, torch.div)

    def __neg__(self):
        if any(o not in ("sum", "avg") for o in self._partial_ops()):
            raise ValueError("negation does not commute with max/min Partial; redistribute first")
        return DArray(-self._local, self._spec, self._rank)

    def astype(self, dtype) -> "DArray":
        spec = DArraySpec(self.mesh, self.placements, TensorMeta(self.shape, dtype))
        return DArray(self._local.to(dtype), spec, self._rank)


# ------------------------------------------------------------------- API
def _as_tensor(x, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else torch.as_tensor(x)
    return t.to(device)


def distribute_tensor(tensor, mesh: DeviceMesh, placements=None, *,
                      rank: Optional[int] = None) -> DArray:
    """Shard or replicate a full logical tensor onto the mesh (reference
    api.py:154): ``rank``'s piece, cut locally from ``tensor`` on the
    mesh's device.  A replicated piece is ``tensor`` itself; a sharded one
    is a copy, so the full tensor can be freed."""
    rank = _resolve_rank(mesh, rank)
    t = _as_tensor(tensor, mesh.device)
    spec = DArraySpec(mesh, normalize_placements(placements, mesh.ndim, t.ndim),
                      TensorMeta(tuple(t.shape), t.dtype))
    spec.layout()
    local = spec.local_from_full(t, mesh.coordinate_of_rank(rank))
    if local.data_ptr() == t.data_ptr() and local.shape == t.shape:
        return DArray(local, spec, rank)
    return DArray(local.contiguous().clone(), spec, rank)


def _infer_global_shape(local_shape, placements, mesh: DeviceMesh):
    """The global shape when every rank holds a piece like this one (the
    reference's single-local path): each shard dim scales by its mesh dim."""
    gshape = list(local_shape)
    for i, p in enumerate(placements):
        if isinstance(p, (Shard, InterleavedShard)):
            gshape[p.dim] *= mesh.shape[i]
        elif isinstance(p, RaggedShard):
            raise ValueError("ragged from_local needs shape= or run_check=True")
    return tuple(gshape)


def _gathered_global_shape(shapes, placements, mesh: DeviceMesh):
    """The global shape from every rank's local shape (flat rank order),
    summing each shard dim's pieces over its mesh dims (other coordinates
    held at 0), as the reference's list path infers it."""
    import itertools

    r0 = list(shapes[0])
    shard_dims_of: dict = {}
    for i, p in enumerate(placements):
        if isinstance(p, (Shard, InterleavedShard)):
            shard_dims_of.setdefault(p.dim, []).append(i)
    for d, mesh_dims in shard_dims_of.items():
        total = 0
        for idx in itertools.product(*(range(mesh.shape[i]) for i in mesh_dims)):
            coord = [0] * mesh.ndim
            for i, r in zip(mesh_dims, idx):
                coord[i] = r
            total += shapes[int(np.ravel_multi_index(coord, mesh.shape))][d]
        r0[d] = total
    for i, p in enumerate(placements):
        if isinstance(p, RaggedShard):
            total = 0
            for r in range(mesh.shape[i]):
                coord = [0] * mesh.ndim
                coord[i] = r
                total += math.prod(shapes[int(np.ravel_multi_index(coord, mesh.shape))])
            return (total,)
    return tuple(r0)


def from_local(local_tensor, device_mesh: DeviceMesh, placements=None, *, run_check: bool = False,
               shape: Optional[Sequence[int]] = None, rank: Optional[int] = None) -> DArray:
    """A DArray from this rank's local tensor (reference api.py:39).

    Without ``shape`` the global shape assumes every rank holds a piece of
    this size.  ``run_check=True`` (a live mesh; collective) gathers every
    rank's local shape, infers the exact global shape from them (uneven and
    ragged pieces included) and checks each against the layout, then
    broadcasts coordinate 0's local along every replicated mesh dim, so all
    replicas hold the same value."""
    mesh = device_mesh
    rank = _resolve_rank(mesh, rank)
    local = _as_tensor(local_tensor, mesh.device)
    placements = normalize_placements(placements, mesh.ndim, local.ndim)
    if run_check:
        shapes = _all_local_shapes(local, mesh)
        gshape = tuple(shape) if shape is not None else _gathered_global_shape(shapes, placements, mesh)
    else:
        gshape = tuple(shape) if shape is not None else _infer_global_shape(local.shape, placements, mesh)
    spec = DArraySpec(mesh, placements, TensorMeta(tuple(gshape), local.dtype))
    spec.layout()
    coord = mesh.coordinate_of_rank(rank)
    want = spec.local_shape(coord)
    if tuple(local.shape) != want and not (spec.has_ragged() and local.numel() == want[0]):
        raise ValueError(f"rank {rank}: local shape {tuple(local.shape)} != {want} of {spec}")
    if spec.has_ragged():
        local = local.reshape(-1)
    if run_check:
        for r, s in enumerate(shapes):
            exp = spec.local_shape(mesh.coordinate_of_rank(r))
            if tuple(s) != exp and not (spec.has_ragged() and math.prod(s) == exp[0]):
                raise ValueError(f"rank {r}: local shape {tuple(s)} != {exp} of {spec}")
        from .collectives import mesh_broadcast

        for i, p in enumerate(placements):
            if p.is_replicate():
                local = mesh_broadcast(local, mesh, mesh_dim=i, src_rank=0)
    return DArray(local, spec, rank)


def _all_local_shapes(local: torch.Tensor, mesh: DeviceMesh):
    """Every rank's local shape in flat mesh order (a gather over each
    mesh dim in turn, inner first)."""
    from .collectives import mesh_all_gather

    t = torch.tensor([list(local.shape) + [local.ndim]], dtype=torch.int64, device=local.device)
    for i in reversed(range(mesh.ndim)):
        t = mesh_all_gather(t, mesh, mesh_dim=i)
    rows = t.cpu().tolist()
    return [tuple(r[:r[-1]]) for r in rows]


def redistribute_dtensor(dtensor: DArray, device_mesh=None, placements=None,
                         async_op: bool = True) -> DArray:
    """Reference api.py:281."""
    return dtensor.redistribute(device_mesh, placements)


def full_tensor(dtensor: DArray) -> torch.Tensor:
    return dtensor.full_tensor()


# --------------------------------------------------------------- factories
def _shape_arg(shape):
    return tuple(shape[0]) if len(shape) == 1 and isinstance(shape[0], (tuple, list)) else tuple(shape)


def _factory(fill_fn, shape, mesh: DeviceMesh, placements, dtype, rank) -> DArray:
    """``rank``'s piece of a factory: ``fill_fn(local_shape, index_set,
    device)`` makes it; a ``Partial("sum")`` piece off coordinate 0 is
    zeros, as the reference seeds distributed values."""
    rank = _resolve_rank(mesh, rank)
    spec = DArraySpec(mesh, normalize_placements(placements, mesh.ndim, len(shape)),
                      TensorMeta(tuple(shape), dtype))
    spec.layout()
    coord = mesh.coordinate_of_rank(rank)
    local_shape = spec.local_shape(coord)
    dev = mesh.device
    if spec.seeds_zero(coord):
        return DArray(torch.zeros(local_shape, dtype=dtype, device=dev), spec, rank)
    return DArray(fill_fn(local_shape, spec.index_set(coord), dev), spec, rank)


def zeros(*shape, device_mesh: DeviceMesh, placements=None, dtype=torch.float32,
          rank: Optional[int] = None) -> DArray:
    return _factory(lambda s, _i, dev: torch.zeros(s, dtype=dtype, device=dev),
                    _shape_arg(shape), device_mesh, placements, dtype, rank)


def ones(*shape, device_mesh: DeviceMesh, placements=None, dtype=torch.float32,
         rank: Optional[int] = None) -> DArray:
    return _factory(lambda s, _i, dev: torch.ones(s, dtype=dtype, device=dev),
                    _shape_arg(shape), device_mesh, placements, dtype, rank)


def empty(*shape, device_mesh: DeviceMesh, placements=None, dtype=torch.float32,
          rank: Optional[int] = None) -> DArray:
    return zeros(*shape, device_mesh=device_mesh, placements=placements, dtype=dtype, rank=rank)


def full(shape, fill_value, *, device_mesh: DeviceMesh, placements=None, dtype=torch.float32,
         rank: Optional[int] = None) -> DArray:
    return _factory(lambda s, _i, dev: torch.full(s, fill_value, dtype=dtype, device=dev),
                    tuple(shape), device_mesh, placements, dtype, rank)


def randn(*shape, device_mesh: DeviceMesh, placements=None, dtype=torch.float32, key=None,
          rank: Optional[int] = None) -> DArray:
    """Standard normals by global element index: bitwise the same values
    under any layout (each rank draws only its piece)."""
    from .random import get_rng_tracker, linear_index

    shape = _shape_arg(shape)
    tracker = get_rng_tracker()
    k = key if key is not None else tracker.next_key()
    return _factory(lambda s, iset, dev: tracker.normal(s, dtype, key=k, device=dev,
                                                        index=linear_index(iset, shape, dev)),
                    shape, device_mesh, placements, dtype, rank)


def rand(*shape, device_mesh: DeviceMesh, placements=None, dtype=torch.float32, key=None,
         rank: Optional[int] = None) -> DArray:
    """Uniforms in [0, 1) by global element index (bitwise JAX's
    ``jax.random.uniform`` for the same key)."""
    from .random import get_rng_tracker, linear_index

    shape = _shape_arg(shape)
    tracker = get_rng_tracker()
    k = key if key is not None else tracker.next_key()
    return _factory(lambda s, iset, dev: tracker.uniform(s, dtype, key=k, device=dev,
                                                         index=linear_index(iset, shape, dev)),
                    shape, device_mesh, placements, dtype, rank)


def arange(*args, device_mesh: DeviceMesh, placements=None, dtype=None,
           rank: Optional[int] = None) -> DArray:
    """``torch.arange(*args)`` laid out on the mesh; each rank computes
    only its piece (start + step * global index)."""
    probe = torch.arange(*args, dtype=dtype, device="meta")
    n = probe.shape[0]
    start = args[0] if len(args) > 1 else 0
    step = args[2] if len(args) > 2 else 1

    def fill(s, iset, dev):
        from .random import linear_index

        idx = linear_index(iset, (n,), dev)
        return (start + step * idx).to(probe.dtype).reshape(s)

    return _factory(fill, (n,), device_mesh, placements, probe.dtype, rank)
