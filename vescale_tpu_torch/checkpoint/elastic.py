"""Elastic restore: the cross-world compatibility preflight of a load.

The port of ``vescale_tpu/checkpoint/elastic.py``.  ``save`` records the
writer's world in ``meta.json`` (:func:`writer_meta`); ``load`` runs
:func:`preflight` before it reads any chunk byte.  The verdict is a
:class:`~vescale_tpu_torch.analysis.findings.FindingReport` over the VSC13x
codes:

  VSC130 (info)   the writer's world differs from the template's: the load
                  reshards (``LAST_LOAD_STATS["elastic"] == 1``)
  VSC131 (error)  a leaf's LOGICAL shape differs: never reshardable, raised
                  as :class:`ElasticMismatchError` naming the key and both
                  shapes
  VSC132 (error)  the worlds differ and ``VESCALE_ELASTIC_RESTORE`` is off

Mesh shape, world size, placements and ragged buckets may change freely;
logical shapes and the key schema may not.

The world, as the port records it: ``process_count`` is the
``torch.distributed`` world size (1 without a process group),
``device_count`` the same number (one card, or one gloo CPU rank, a
process), and ``meshes`` the sorted ``name=size/...`` descriptors of the
meshes the state's ``DArray`` leaves live on.  The JAX package is one
controller over all its devices: a (2, 4) mesh there records 1 process and
8 devices, and the same mesh as a gloo world of 8 here records 8 and 8.
So a load across the two packages reads as elastic (VSC130) even on the
same mesh shape; the bytes it reads are the same.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .. import config
from .. import distributed as _dist
from ..analysis.findings import Finding, FindingReport
from ..darray import DArray
from .planner import flatten_state, leaf_shape

__all__ = [
    "ElasticMismatchError",
    "current_world",
    "mesh_descriptor",
    "preflight",
    "writer_differs",
    "writer_meta",
]


class ElasticMismatchError(ValueError):
    """The checkpoint cannot be restored into the template: a coded verdict
    (VSC131/VSC132) raised before any chunk byte is read.  Not corruption:
    the checkpoint itself is fine."""

    def __init__(self, report: FindingReport):
        self.report = report
        super().__init__(report.format())


def mesh_descriptor(mesh) -> str:
    """The ``dp=2/tp=4`` string of a mesh, comparable across runs and with
    the JAX package's."""
    return "/".join(f"{name}={size}" for name, size in zip(mesh.mesh_dim_names, mesh.shape))


def current_world(checkpoint_state: Dict[str, Any]) -> Dict[str, Any]:
    """This process's view of the world the state lives on (module
    docstring); the same on every rank."""
    meshes = {mesh_descriptor(leaf.mesh)
              for tree in checkpoint_state.values()
              for _key, leaf in flatten_state(tree) if isinstance(leaf, DArray)}
    n = _dist.process_count()
    return {"process_count": n, "device_count": n, "meshes": sorted(meshes)}


def writer_meta(checkpoint_state: Dict[str, Any]) -> Dict[str, Any]:
    """The ``meta.json`` writer block: :func:`current_world` at save time."""
    return current_world(checkpoint_state)


def writer_differs(writer: Optional[Dict[str, Any]], reader: Dict[str, Any]) -> bool:
    """True when mesh-bearing state crosses differently shaped worlds.  Both
    sides must carry meshes: a host-only template, or a saved state with no
    mesh, has no layout that could cross worlds, so it is never elastic
    (and never refused by ``VESCALE_ELASTIC_RESTORE=0``).  A checkpoint
    without a writer block reads as the same world."""
    if not writer:
        return False
    if not writer.get("meshes") or not reader.get("meshes"):
        return False
    return any(writer.get(k) != reader.get(k) for k in ("process_count", "device_count", "meshes"))


def _template_shapes(checkpoint_state: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...]]]:
    """``[(full key, logical shape), ...]`` of every template leaf, in the
    loader's order."""
    return [(f"{top}/{key}", leaf_shape(leaf))
            for top, tree in checkpoint_state.items() for key, leaf in flatten_state(tree)]


def preflight(meta: Dict[str, Any], checkpoint_state: Dict[str, Any], path: str):
    """Rule on the restore before any chunk byte is read: returns
    ``(report, elastic)``, or raises :class:`ElasticMismatchError` when the
    report holds an error.  Missing keys are the loader's to judge
    (``strict``)."""
    report = FindingReport(name=f"elastic_preflight:{path}")
    writer = meta.get("writer")
    reader = current_world(checkpoint_state)
    elastic = writer_differs(writer, reader)
    arrays = meta.get("arrays", {})
    for full_key, shape in _template_shapes(checkpoint_state):
        entry = arrays.get(full_key)
        if entry is None:
            continue
        saved = tuple(entry["shape"])
        if shape and saved != shape:
            report.add(Finding(
                "VSC131",
                f"array {full_key!r}: saved logical shape {saved} vs template {shape} — a "
                "world-size change reshapes layouts, never logical shapes",
                where=full_key,
            ))
    if elastic:
        wdesc = f"{writer.get('process_count')}p/{writer.get('device_count')}d {writer.get('meshes')}"
        rdesc = f"{reader['process_count']}p/{reader['device_count']}d {reader['meshes']}"
        if not config.get_bool("VESCALE_ELASTIC_RESTORE"):
            report.add(Finding(
                "VSC132",
                f"checkpoint at {path} was written by {wdesc}, this run is {rdesc}, and "
                "VESCALE_ELASTIC_RESTORE is off — refusing the cross-world reshard",
            ))
        else:
            report.add(Finding(
                "VSC130",
                f"elastic restore: written by {wdesc}, loading into {rdesc} — resharding "
                "every leaf by chunk-box intersection",
            ))
    if not report.ok():
        raise ElasticMismatchError(report)
    return report, elastic
