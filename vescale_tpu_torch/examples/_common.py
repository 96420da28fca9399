"""What the port's example programs share: the corpus file, seeded token
batches, the one-rank and ``torchrun`` launch, a rank's rows of a global
batch, the loss over a (maybe tensor-parallel) model, its parameters as a
checkpointable tree, and optax's ``clip_by_global_norm`` over parameter
pieces.

A mesh of one rank runs in this process with no process group (a
layout-only ``DeviceMesh``).  A mesh of several ranks joins the world that
``torchrun`` describes (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``) through ``distributed.initialize``'s ``env://``
rendezvous: NCCL on the card, gloo on the CPU::

    torchrun --nproc-per-node 8 -m vescale_tpu_torch.examples.llama2_4d_finetune --tiny --cpu
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

__all__ = ["build_corpus_bin", "seeded_tokens", "pick_device", "world", "launch", "rank_of",
           "load_tree", "save_tree",
           "dp_rows", "loss_fn", "model_state", "model_template", "load_model_state",
           "GlobalNormClip", "write_json", "tokens_batch"]


def build_corpus_bin(out_path: str, corpus_file: Optional[str] = None,
                     max_bytes: int = 4 << 20) -> int:
    """Char-level tokens of a text corpus as a nanoGPT-style uint16 .bin
    (a copy of ``examples/nanogpt_4d_finetune/loss_parity.py::
    build_corpus_bin``): the bytes of ``corpus_file`` or, with none, of the
    Python standard library's ``*.py`` files in sorted order, up to
    ``max_bytes``.  Returns the vocab size (256: raw bytes)."""
    if corpus_file:
        with open(corpus_file, "rb") as f:
            data = f.read(max_bytes)
    else:
        import sysconfig

        stdlib = sysconfig.get_paths()["stdlib"]
        chunks, total = [], 0
        for p in sorted(glob.glob(os.path.join(stdlib, "*.py"))):
            try:
                with open(p, "rb") as f:
                    b = f.read()
            except OSError:
                continue
            chunks.append(b)
            total += len(b)
            if total >= max_bytes:
                break
        data = b"".join(chunks)[:max_bytes]
    np.frombuffer(data, dtype=np.uint8).astype(np.uint16).tofile(out_path)
    return 256


def seeded_tokens(seed: int, rows: int, seq: int, vocab: int) -> np.ndarray:
    """(rows, seq + 1) int64 token ids from ``np.random.default_rng(seed)``:
    the reference programs' numpy-seeded batches."""
    return np.random.default_rng(seed).integers(0, vocab, (rows, seq + 1)).astype(np.int64)


def tokens_batch(toks, device) -> Dict[str, torch.Tensor]:
    """{"input", "target"} of (rows, seq + 1) tokens, on ``device``."""
    t = torch.as_tensor(np.asarray(toks), dtype=torch.int64).to(device)
    return {"input": t[:, :-1], "target": t[:, 1:]}


def pick_device(cpu: bool = False) -> torch.device:
    """The card (this process's ``LOCAL_RANK`` under ``torchrun``), or the
    CPU when asked; raises when the card is asked for and there is none."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the examples run on the card by default; "
                           "pass --cpu to run them on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


@contextlib.contextmanager
def world(device) -> Iterator[None]:
    """Join the ``torchrun`` world for a program that makes several meshes
    in turn (a loss-parity run: one device, then 4D); nothing outside
    ``torchrun``.  The group is destroyed on the way out."""
    from .. import distributed

    if not os.environ.get("MASTER_ADDR") or distributed.is_initialized():
        yield
        return
    distributed.initialize(device_type=torch.device(device).type)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


@contextlib.contextmanager
def launch(names: Sequence[str], shape: Sequence[int], device) -> Iterator[Any]:
    """The ``DeviceMesh`` of ``names`` x ``shape`` for this process.  One
    rank: a layout-only mesh, no process group.  More: this process joins
    the ``torchrun`` world (``env://``), whose size must be the mesh's, and
    the group it made is destroyed on the way out."""
    from .. import distributed
    from ..mesh import DeviceMesh, init_device_mesh

    device = torch.device(device)
    n = int(np.prod(shape))
    if n == 1:
        yield DeviceMesh(tuple(names), tuple(shape), device_type=device.type)
        return
    if not os.environ.get("MASTER_ADDR"):
        raise RuntimeError(f"a mesh of {n} ranks runs under torchrun "
                           f"(torchrun --nproc-per-node {n} -m ...)")
    made = not distributed.is_initialized()
    distributed.initialize(device_type=device.type)
    try:
        yield init_device_mesh(device.type, tuple(shape), mesh_dim_names=tuple(names))
    finally:
        if made:
            torch.distributed.destroy_process_group()


def rank_of(mesh) -> int:
    """This process's rank in ``mesh`` (0 on a layout-only mesh)."""
    return mesh.get_rank() if mesh.is_live else 0


def dp_rows(mesh, x):
    """This rank's rows of a global batch: dim 0 split over "dp"."""
    if "dp" not in mesh.mesh_dim_names or mesh.size("dp") == 1:
        return x
    n = mesh.size("dp")
    r = mesh.get_coordinate()[mesh.mesh_dim_names.index("dp")]
    b = x.shape[0] // n
    return x[r * b:(r + 1) * b]


def loss_fn(mesh, extra=None):
    """The reference's ``cross_entropy_loss`` over a model's output: the
    plain fp32 one on a rank that holds the whole vocab, else the
    vocab-parallel body over "tp" (the output is this rank's vocab slice).
    ``extra()``, when given, is added (a MoE's aux losses)."""
    from ..loss import vocab_parallel_cross_entropy
    from ..models import cross_entropy_loss

    if "tp" in mesh.mesh_dim_names and mesh.size("tp") > 1:
        def xent(lg, b):
            return vocab_parallel_cross_entropy(lg, b["target"], mesh=mesh, vocab_dim_name="tp")
    else:
        def xent(lg, b):
            return cross_entropy_loss(lg, b["target"])
    if extra is None:
        return xent
    return lambda lg, b: xent(lg, b) + extra()


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def model_state(dm) -> Dict[str, Any]:
    """A ``DModule``'s parameters as a checkpointable tree: ``DArray``s of
    this rank's pieces under the plan's placements on a live mesh, the
    parameters themselves (detached) on one rank."""
    from ..darray import DArray

    named = dict(dm.module.named_parameters())
    if not dm.mesh.is_live:
        return _nest({n: p.detach() for n, p in named.items()})
    rank = dm.mesh.get_rank()
    return _nest({n: DArray(p.detach(), dm._specs[n], rank) for n, p in named.items()})


def model_template(dm) -> Dict[str, Any]:
    """``model_state``'s layout for ``checkpoint.load`` (values ignored)."""
    from ..darray import DArray

    named = dict(dm.module.named_parameters())
    if not dm.mesh.is_live:
        return _nest({n: torch.empty_like(p) for n, p in named.items()})
    rank = dm.mesh.get_rank()
    return _nest({n: DArray(torch.empty_like(p), dm._specs[n], rank) for n, p in named.items()})


@torch.no_grad()
def load_model_state(dm, tree) -> None:
    """Copy a tree laid out as ``model_state`` into the parameters."""
    from ..darray import DArray
    from ..models.convert import _flatten

    flat = _flatten(tree)
    for name, p in dm.module.named_parameters():
        v = flat[name]
        p.copy_(v.to_local() if isinstance(v, DArray) else torch.as_tensor(v))


class GlobalNormClip:
    """``optax.chain(optax.clip_by_global_norm(max_norm), inner)`` over a
    ``DModule``'s parameter pieces: the norm counts every element once (a
    piece replicated on a mesh dim at that dim's coordinate 0 only) and is
    summed over the mesh; the grads are scaled by ``max_norm / norm`` when
    the norm is above ``max_norm``, as optax scales them, then ``inner``
    steps."""

    def __init__(self, inner: torch.optim.Optimizer, dm, max_norm: float):
        self.inner, self.dm, self.max_norm = inner, dm, float(max_norm)

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        from ..parallel.optimizer import _all_reduce_mesh

        mesh = self.dm.mesh
        coord = mesh.get_coordinate() if mesh.is_live else None
        named = [(n, p) for n, p in self.dm.module.named_parameters() if p.grad is not None]
        dev = named[0][1].grad.device
        sq = torch.zeros(1, dtype=torch.float32, device=dev)
        for n, p in named:
            placements = self.dm._specs[n].placements
            if coord is not None and any(coord[i] != 0 for i, q in enumerate(placements)
                                         if q.is_replicate()):
                continue
            sq = sq + torch.sum(torch.square(p.grad.float()))
        norm = torch.sqrt(_all_reduce_mesh(sq, mesh, "sum"))[0]
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        for _, p in named:
            p.grad = (p.grad.float() * scale).to(p.grad.dtype)
        self.inner.step()


def save_tree(path: str, tree) -> None:
    """A flax-layout tree of arrays as an ``.npz`` of dotted names (the
    weights a test hands to every rank of a ``torchrun`` world)."""
    from ..models.convert import _flatten

    np.savez(path, **{k: np.asarray(v) for k, v in _flatten(tree).items()})


def load_tree(path: str) -> Dict[str, Any]:
    """The tree :func:`save_tree` wrote."""
    with np.load(path) as z:
        return _nest({k: torch.from_numpy(np.array(z[k])) for k in z.files})


def write_json(path: Optional[str], obj) -> None:
    """``obj`` as JSON at ``path`` (nothing without one)."""
    if path:
        with open(path, "w") as f:
            json.dump(obj, f)
