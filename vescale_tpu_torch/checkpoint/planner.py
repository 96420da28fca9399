"""Save planning: state trees to keyed leaves, leaves to chunk plans.

The port of ``vescale_tpu/checkpoint/planner.py`` (the reference
VeScaleSavePlanner, legacy ``vescale_planner.py:93``): per-rank chunks from
a leaf's spec (``:106``), replicas deduped with every holder recorded
(``:132,137``), and plans cached by the state's signature (``:116``).

Trees are nested dicts, lists and tuples (namedtuples too), flattened with
the key paths of ``jax.tree_util``: dict keys sorted, sequence items by
index, namedtuple fields as ``.name``, ``None`` an empty subtree.  So
``model/layers_0/self_attn/q_proj/kernel`` names the same leaf in both
packages.  A leaf is a ``DArray``, a ``torch.Tensor`` (a single box; the
reference's unsharded ``jax.Array``), a numpy array or a Python scalar.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..darray import DArray
from ..placements import Replicate
from .reshard import Box, chunks_for_spec
from .storage import dtype_name

__all__ = [
    "SavePlanner",
    "array_plan",
    "fetch_chunk",
    "flatten_state",
    "key_of_path",
    "leaf_shape",
    "unflatten_state",
]


def key_of_path(path) -> str:
    """A key path (a sequence of dict keys, indices and ``.field`` names)
    as the checkpoint's ``/``-joined key."""
    return "/".join(str(k) for k in path)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> List[Tuple[Any, Any]]:
    """(key, child) pairs of a container in ``jax.tree_util``'s order; None
    for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def flatten_state(state) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs of a state tree, in ``jax.tree_util``'s leaf
    order; ``DArray`` leaves are kept whole."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((key_of_path(path), node))
            return
        for k, child in kids:
            walk(child, path + (k,))

    walk(state, ())
    return out


def unflatten_state(state, fn: Callable[[str, Any], Any]):
    """A tree of ``state``'s structure whose leaves are ``fn(key, leaf)``."""

    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            # leaves in jax.tree_util's order (sorted keys), as flatten_state
            # visits them, so a load reads (and reports a missing key) in the
            # reference's order; the result keeps the template's key order
            done = {k: walk(node[k], path + (k,)) for k in sorted(node)}
            return {k: done[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(walk(getattr(node, f), path + (f".{f}",)) for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(c, path + (i,)) for i, c in enumerate(node))
        return fn(key_of_path(path), node)

    return walk(state, ())


def leaf_shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(np.shape(leaf))


def normalize_darray(leaf: DArray) -> DArray:
    """Partial reduced and InterleavedShard collapsed (to Replicate), so
    every chunk is a dense box.  Collective on a live mesh."""
    spec = leaf.spec
    if spec.has_partial() or spec.layout().interleaves:
        leaf = leaf.redistribute(placements=[Replicate()] * spec.mesh.ndim)
    return leaf


def array_plan(leaf) -> Tuple[Tuple[int, ...], str, List[Tuple[Box, Any]]]:
    """``(global shape, dtype name, [(box, owner), ...])``: the chunks of one
    leaf, no data fetched (cacheable by the plan signature).  A ``DArray``
    (normalized first) gives each rank's box, replicas deduped, owner = the
    flat ranks holding it; anything else one full box, owner None."""
    if isinstance(leaf, DArray):
        spec = normalize_darray(leaf).spec
        return tuple(spec.shape), dtype_name(spec.dtype), chunks_for_spec(spec)
    if isinstance(leaf, torch.Tensor):
        shape, name = tuple(leaf.shape), dtype_name(leaf.dtype)
    else:
        arr = np.asarray(leaf)
        shape, name = tuple(arr.shape), arr.dtype.name
    return shape, name, [(Box((0,) * len(shape), shape), None)]


def fetch_chunk(leaf, box: Box, owner):
    """One planned chunk's data from what this process holds: a ``DArray``
    chunk from the piece it holds (its rank must be among the owners), a
    tensor or host leaf whole."""
    if isinstance(leaf, DArray):
        ranks = owner if isinstance(owner, tuple) else (owner,)
        if leaf.rank not in ranks:
            raise RuntimeError(
                f"this process holds rank {leaf.rank}'s piece; the chunk at {box} is held by "
                f"ranks {ranks}")
        return leaf.to_local().reshape(box.size)
    if isinstance(leaf, torch.Tensor):
        return leaf
    return np.asarray(leaf)


class SavePlanner:
    """Builds and caches save plans (each unique chunk is written once)."""

    def __init__(self):
        self._cache: Dict[str, Any] = {}

    def plan_signature(self, flat_state) -> str:
        h = hashlib.sha256()
        for key, leaf in flat_state:
            if isinstance(leaf, DArray):
                h.update(f"{key}:{leaf.spec}:{leaf.dtype}".encode())
            elif hasattr(leaf, "shape"):
                h.update(f"{key}:{tuple(leaf.shape)}:{leaf.dtype}".encode())
            else:
                h.update(f"{key}:scalar:{np.asarray(leaf).dtype}".encode())
        return h.hexdigest()

    def lookup(self, sig: str):
        return self._cache.get(sig)

    def store(self, sig: str, plan) -> None:
        self._cache[sig] = plan
