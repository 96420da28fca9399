"""Deferred init: shapes first, each rank's piece later.

The port of ``vescale_tpu/initialize/deferred_init.py`` (reference
legacy/vescale/initialize/deferred_init.py:38,98,182).  The reference traces
an initializer with ``jax.eval_shape``; here the initializer runs on the
``meta`` device, which allocates nothing and yields shapes and dtypes.

An initializer is a callable that makes its tensors where it is told: it
takes a ``device=`` keyword (the port's ``init_params`` does), or it uses
torch's default device.  Materializing records the initializer's tensor
ops on ``meta`` and replays them on the mesh's device, in their order and
with their generators, as torchdistX's deferred init records and replays
factory ops.  Each leaf is cut to this rank's piece as soon as the last op
that writes its storage has run, and the full leaf is freed at once: every
piece equals the eager initializer's value, sliced (the same draws in the
same order), and the peak holds one full leaf beside the pieces.  The
initializer must not read a tensor's values on the host (``.item()``,
``.tolist()``): while it records, its tensors have no data.  To draw only
the piece, use ``darray.randn`` / ``darray.rand``, which draw by global
index.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from ..darray import DArray, distribute_tensor
from ..mesh import DeviceMesh

__all__ = [
    "deferred_init",
    "is_deferred",
    "materialize_dtensor",
    "materialize_dparameter",
    "materialize_module",
]


def _call_on(fn: Callable, device, args, kwargs):
    """``fn(*args, **kwargs)`` with its tensors on ``device``."""
    try:
        takes_device = "device" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        takes_device = False
    if takes_device and "device" not in kwargs:
        kwargs = dict(kwargs, device=device)
    with torch.device(device):
        return fn(*args, **kwargs)


def deferred_init(fn: Callable, *args, **kwargs):
    """``fn``'s output with every tensor on the ``meta`` device: shapes and
    dtypes, nothing allocated (reference deferred_init:38)."""
    return _call_on(fn, "meta", args, kwargs)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def is_deferred(tree) -> bool:
    leaves = list(_leaves(tree))
    return bool(leaves) and all(isinstance(t, torch.Tensor) and t.device.type == "meta"
                                for t in leaves)


class _Recorder(TorchDispatchMode):
    """Runs every op on ``meta`` and records it with its original
    arguments: the device it was asked for and its generator."""

    def __init__(self):
        super().__init__()
        self.ops = []     # (func, args, kwargs, outputs), meta tensors in place of tensors
        self.consts = {}  # id of a meta stand-in -> the real tensor it stands for
        self.held = []    # every meta tensor seen, so that no id is reused

    def _meta(self, x):
        if isinstance(x, torch.Tensor) and x.device.type != "meta":
            m = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device="meta")
            self.consts[id(m)] = x
            self.held.append(m)
            return m
        return x

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        args, kwargs = tree_map(self._meta, (tuple(args), dict(kwargs or {})))
        run_args, run_kwargs = tree_map(
            lambda x: None if isinstance(x, torch.Generator) else x, (args, kwargs))
        if "device" in run_kwargs:
            run_kwargs["device"] = torch.device("meta")
        out = func(*run_args, **run_kwargs)
        self.held += [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.ops.append((func, args, kwargs, out))
        return out


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _replay(rec: _Recorder, leaves, cut):
    """Run the recorded ops for real and call ``cut(i, tensor)`` for leaf
    ``i`` once its storage is final, then drop every tensor of that
    storage; an intermediate is dropped after its storage's last op."""
    last = {}
    for n, (_, args, kwargs, out) in enumerate(rec.ops):
        for t in tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor):
                last[_storage(t)] = n
    ending = {}
    for key, n in last.items():
        ending.setdefault(n, []).append(key)
    by_storage = {}
    for i, leaf in enumerate(leaves):
        if leaf.device.type != "meta":
            cut(i, leaf)
        elif _storage(leaf) not in last:
            raise ValueError(f"leaf {i} of the initializer was not made by its ops")
        else:
            by_storage.setdefault(_storage(leaf), []).append(i)
    env = {}       # id of a meta tensor -> its real tensor
    members = {}   # storage -> ids of the meta tensors that live in it

    def real(x):
        if isinstance(x, torch.Tensor):
            return rec.consts[id(x)] if id(x) in rec.consts else env[id(x)]
        return x

    for n, (func, args, kwargs, out) in enumerate(rec.ops):
        r_args, r_kwargs = tree_map(real, (args, kwargs))
        result = func(*r_args, **r_kwargs)
        for m, t in zip(tree_leaves(out), tree_leaves(result)):
            if isinstance(m, torch.Tensor):
                env[id(m)] = t
                members.setdefault(_storage(m), set()).add(id(m))
        del r_args, r_kwargs, result
        for key in ending.get(n, ()):
            ids = members.pop(key, set())
            if key in by_storage:
                base = env[next(iter(ids))]
                for i in by_storage[key]:
                    m = leaves[i]
                    cut(i, env[id(m)] if id(m) in env else
                        base.as_strided(m.shape, m.stride(), m.storage_offset()))
                del base
            for k in ids:
                env.pop(k, None)


def _flatten(tree, placements, out):
    """The tree's leaves, each with its placements, into ``out``; returns
    the tree with leaf indices in their place."""
    if isinstance(tree, dict):
        return {k: _flatten(v, placements if _is_placements(placements) else placements[k], out)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, placements, out) for v in tree)
    out.append((tree, placements))
    return len(out) - 1


def _unflatten(tree, pieces):
    if isinstance(tree, dict):
        return {k: _unflatten(v, pieces) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, pieces) for v in tree)
    return pieces[tree]


def materialize_dtensor(fn: Callable, mesh: DeviceMesh, placements, *args,
                        rank: Optional[int] = None, **kwargs) -> DArray:
    """Run the factory on the mesh's device and keep ``rank``'s piece
    (reference materialize_dtensor:98)."""
    return materialize_module(fn, placements, *args, mesh=mesh, rank=rank, **kwargs)


def materialize_dparameter(fn: Callable, mesh: DeviceMesh, placements, *args,
                           rank: Optional[int] = None, **kwargs) -> DArray:
    """(reference materialize_dparameter:182) The parameter flavour: the
    piece is an ``nn.Parameter``."""
    d = materialize_dtensor(fn, mesh, placements, *args, rank=rank, **kwargs)
    return DArray(torch.nn.Parameter(d.to_local()), d.spec, d.rank)


def _is_placements(node) -> bool:
    return not isinstance(node, dict)


def materialize_module(init_fn: Callable, placements_tree, *args, mesh: DeviceMesh,
                       rank: Optional[int] = None, **kwargs) -> Any:
    """``rank``'s pieces of a whole initializer's tree on the mesh's
    device: a tree of DArrays (module docstring).  ``placements_tree``
    mirrors the initializer's dict tree with a placements sequence at each
    leaf, or is one placements sequence for every leaf."""
    rec = _Recorder()
    with rec:
        tree = _call_on(init_fn, mesh.device, args, kwargs)
    leaves = []
    shape = _flatten(tree, placements_tree, leaves)
    del tree
    pieces = [None] * len(leaves)

    def cut(i, full):
        pieces[i] = distribute_tensor(full, mesh, leaves[i][1], rank=rank)

    with torch.no_grad():
        _replay(rec, [t for t, _ in leaves], cut)
    return _unflatten(shape, pieces)
