"""DeviceMesh: the n-D grid of ranks with named dims.

The port of ``vescale_tpu/mesh.py``.  The reference lays the devices of one
controller out as a ``jax.sharding.Mesh``; here each rank is a process and
each mesh dim carries a process group of ``torch.distributed``.

A mesh made by :func:`init_device_mesh` is *live*: it sits on
``torch.distributed.device_mesh`` (one process group per mesh dim, NCCL for
``"cuda"`` and gloo for ``"cpu"``) and knows this process's coordinate.  A
mesh made with the constructor alone is *layout-only*: it computes every
rank's coordinate and local piece in one process (``distribute_tensor(...,
rank=r)``, ``redistribute_local_tensor``) and issues no collective.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["DeviceMesh", "init_device_mesh", "backend_of"]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_of(device_type: str) -> str:
    """The collective backend of a device type: NCCL on the card, gloo on
    the CPU."""
    if device_type not in _BACKENDS:
        raise ValueError(f"device_type {device_type!r}: expected one of {sorted(_BACKENDS)}")
    return _BACKENDS[device_type]


class _MeshEnv(threading.local):
    """The current-mesh stack of ``with mesh:`` scopes (reference _MeshEnv)."""

    def __init__(self) -> None:
        self.mesh_stack: list = []

    def get_current_mesh(self) -> "DeviceMesh":
        if not self.mesh_stack:
            raise RuntimeError("No device mesh is currently active")
        return self.mesh_stack[-1]


_mesh_env = _MeshEnv()


class DeviceMesh:
    """An n-D grid of ranks with named dims.

    ``DeviceMesh(("dp", "tp"), (2, 4))`` lays ranks 0-7 out in a 2x4 grid,
    layout-only.  ``ranks`` gives the global rank at each position (default
    ``arange``); ``device_type`` is where its tensors live ("cuda" or
    "cpu").  Live meshes come from :func:`init_device_mesh`.
    """

    def __init__(
        self,
        mesh_dim_names: Sequence[str],
        mesh_shape: Optional[Sequence[int]] = None,
        *,
        device_type: str = "cuda",
        ranks: Optional[Sequence[int]] = None,
        _groups: Optional[Tuple] = None,
        _torch_mesh=None,
    ) -> None:
        names = tuple(mesh_dim_names)
        backend_of(device_type)
        if mesh_shape is None:
            if len(names) != 1 or ranks is None:
                raise ValueError("mesh_shape required for >1-D meshes")
            mesh_shape = (len(ranks),)
        shape = tuple(int(s) for s in mesh_shape)
        if len(names) != len(shape):
            raise ValueError("mesh_dim_names / mesh_shape length mismatch")
        if len(set(names)) != len(names):
            raise ValueError(f"mesh dim names must be unique, got {names}")
        n = int(np.prod(shape)) if shape else 1
        grid = np.arange(n) if ranks is None else np.asarray(ranks, dtype=np.int64).reshape(-1)
        if grid.size != n:
            raise ValueError(f"mesh_shape {shape} does not match {grid.size} ranks")
        self._names = names
        self._shape = shape
        self._ranks = grid.reshape(shape)
        self.device_type = device_type
        self._groups = _groups
        self._torch_mesh = _torch_mesh

    # ------------------------------------------------------------------ info
    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return self._names

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def ranks(self) -> np.ndarray:
        """The global rank at each mesh position."""
        return self._ranks

    @property
    def is_live(self) -> bool:
        return self._groups is not None

    @property
    def torch_mesh(self):
        """The ``torch.distributed.device_mesh.DeviceMesh`` under a live
        mesh (None for a layout-only one)."""
        return self._torch_mesh

    @property
    def device(self) -> torch.device:
        """Where this mesh's tensors live: the current CUDA device for a
        "cuda" mesh (raises without a card), else the CPU."""
        if self.device_type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device: a 'cuda' mesh needs the card; "
                                   "make a 'cpu' mesh to run on the CPU")
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def size(self, mesh_dim: Optional[Union[int, str]] = None) -> int:
        if mesh_dim is None:
            return int(self._ranks.size)
        return self._shape[self._dim_index(mesh_dim)]

    def _dim_index(self, mesh_dim: Union[int, str]) -> int:
        if isinstance(mesh_dim, str):
            return self._names.index(mesh_dim)
        return mesh_dim

    def dim_name(self, mesh_dim: Union[int, str]) -> str:
        return self._names[self._dim_index(mesh_dim)]

    def coordinate_of_rank(self, rank: int) -> Tuple[int, ...]:
        """n-D coordinate of the mesh's flat position ``rank``."""
        return tuple(int(x) for x in np.unravel_index(rank, self._shape))

    def flat_rank_of(self, global_rank: int) -> Optional[int]:
        """The flat mesh position of a global rank (None if absent)."""
        hit = np.flatnonzero(self._ranks.reshape(-1) == global_rank)
        return int(hit[0]) if hit.size else None

    def get_rank(self) -> int:
        """This process's flat position in a live mesh (the reference's
        mesh rank)."""
        if not self.is_live:
            raise RuntimeError("a layout-only mesh has no rank of its own; pass rank= "
                               "or make a live mesh with init_device_mesh")
        r = self.flat_rank_of(dist.get_rank())
        if r is None:
            raise RuntimeError(f"rank {dist.get_rank()} is not in {self}")
        return r

    def get_coordinate(self) -> Tuple[int, ...]:
        return self.coordinate_of_rank(self.get_rank())

    def get_group(self, mesh_dim: Union[int, str, Sequence[Union[int, str]]] = 0):
        """The process group along ``mesh_dim`` that holds this process.
        A sequence of dims (in mesh order) gives the group over their
        flattened grid: member j is the rank at row-major position j of
        those dims.  Every process of the mesh must ask for the same
        flattened dims in the same order: the first ask makes the groups
        (``torch.distributed.new_group``) and caches them."""
        if not self.is_live:
            raise RuntimeError("a layout-only mesh has no process groups; make a live mesh "
                               "with init_device_mesh to run collectives")
        if isinstance(mesh_dim, (int, str)):
            return self._groups[self._dim_index(mesh_dim)]
        dims = tuple(self._dim_index(d) for d in mesh_dim)
        if len(dims) == 1:
            return self._groups[dims[0]]
        if list(dims) != sorted(set(dims)):
            raise ValueError(f"flattened mesh dims {tuple(mesh_dim)} must be distinct and in "
                             f"mesh order {self._names}")
        cache = self.__dict__.setdefault("_flat_groups", {})
        if dims not in cache:
            rest = [i for i in range(self.ndim) if i not in dims]
            grid = np.moveaxis(self._ranks, dims, range(len(dims))).reshape(
                -1, *[self._shape[i] for i in rest])
            grid = grid.reshape(grid.shape[0], -1)
            backend = dist.get_backend(self._groups[0])
            mine = None
            for col in range(grid.shape[1]):
                ranks = [int(r) for r in grid[:, col]]
                if ranks != sorted(ranks):
                    raise ValueError(f"mesh dims {tuple(mesh_dim)} do not flatten in rank "
                                     f"order: {ranks}")
                group = dist.new_group(ranks, backend=backend)
                if dist.get_rank() in ranks:
                    mine = group
            cache[dims] = mine
        return cache[dims]

    # ------------------------------------------------------ submesh slicing
    def __getitem__(self, mesh_dims: Union[str, Sequence[str]]) -> "DeviceMesh":
        """The submesh spanning ``mesh_dims``, the other coordinates held
        at this process's (at position 0's for a layout-only mesh)."""
        if isinstance(mesh_dims, str):
            mesh_dims = (mesh_dims,)
        keep = [self._dim_index(d) for d in mesh_dims]
        coord = self.get_coordinate() if self.is_live else (0,) * self.ndim
        index = tuple(slice(None) if i in keep else coord[i] for i in range(self.ndim))
        sub = self._ranks[index]
        order = [sorted(keep).index(k) for k in keep]
        sub = np.transpose(sub, order)
        groups = tuple(self._groups[k] for k in keep) if self.is_live else None
        names = tuple(self.dim_name(d) for d in mesh_dims)
        tm = self._torch_mesh[names] if self._torch_mesh is not None else None
        return DeviceMesh(names, sub.shape, device_type=self.device_type,
                          ranks=sub.reshape(-1), _groups=groups, _torch_mesh=tm)

    def layout_only(self) -> "DeviceMesh":
        """The same grid without process groups."""
        return DeviceMesh(self._names, self._shape, device_type=self.device_type,
                          ranks=self._ranks.reshape(-1))

    # ----------------------------------------------------------- ctx mgr
    def __enter__(self) -> "DeviceMesh":
        _mesh_env.mesh_stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _mesh_env.mesh_stack.pop()

    def _key(self):
        return (self._names, self._shape, self.device_type, tuple(self._ranks.reshape(-1).tolist()))

    def __eq__(self, other) -> bool:
        return isinstance(other, DeviceMesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"DeviceMesh(dims={dict(zip(self._names, self._shape))}, devices={self.device_type})"


def init_device_mesh(
    device_type: str,
    mesh_shape: Sequence[int],
    *,
    mesh_dim_names: Optional[Sequence[str]] = None,
    backend: Optional[str] = None,
) -> DeviceMesh:
    """A live mesh over every rank of the default process group: one
    process group per mesh dim, of ``backend`` (default NCCL for
    ``"cuda"`` and gloo for ``"cpu"``; passed to torch's
    ``backend_override``) (reference init_device_mesh).  ``backend="gloo"``
    on a ``"cuda"`` mesh keeps the tensors on the card and carries them
    over gloo: several ranks may then share one card, which NCCL refuses.
    The default group must exist (``torch.distributed.init_process_group``,
    or ``vescale_tpu_torch.distributed.initialize``) and its world size
    must equal the mesh's size.  ``"cuda"`` without a card raises."""
    from torch.distributed.device_mesh import init_device_mesh as _torch_init

    backend = backend_of(device_type) if backend is None else backend
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("NCCL carries CUDA tensors only: make a 'cuda' mesh or use gloo")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: init_device_mesh('cuda', ...) needs the card; "
                           "make a 'cpu' mesh for gloo")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("torch.distributed is not initialized: call "
                           "torch.distributed.init_process_group (or "
                           "vescale_tpu_torch.distributed.initialize) first")
    shape = tuple(int(s) for s in mesh_shape)
    names = tuple(mesh_dim_names) if mesh_dim_names is not None else tuple(
        f"dim{i}" for i in range(len(shape)))
    if int(np.prod(shape)) != dist.get_world_size():
        raise ValueError(f"mesh_shape {shape} needs {int(np.prod(shape))} ranks, "
                         f"the world has {dist.get_world_size()}")
    tm = _torch_init(device_type, shape, mesh_dim_names=names,
                     backend_override={i: backend for i in range(len(shape))})
    groups = tuple(tm.get_group(i) for i in range(len(shape)))
    for i, g in enumerate(groups):
        got = dist.get_backend(g)
        if got != backend:
            raise RuntimeError(f"mesh dim {names[i]!r} got a {got} group, expected {backend}")
    return DeviceMesh(names, shape, device_type=device_type, _groups=groups, _torch_mesh=tm)
