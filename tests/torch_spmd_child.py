"""A gloo world for the SPMD core's multi-rank tests.

    python tests/torch_spmd_child.py <rank> <world> <port> env|args

Each process is one rank of a gloo world on the CPU, joined through
``vescale_tpu_torch.distributed.initialize``.  It reads one JSON
request a line from stdin (``{"case": name, "args": {...}}``), runs
``CASES[name](**args)`` as this rank, and answers one line on stdout:
``RESULT <json>`` or ``ERROR <traceback>``.  Every rank runs the same
requests in the same order, so the collectives inside a case pair up.
Tensors travel as ``{"__nd__": dtype, "shape": [...], "b64": ...}``.

``World`` is the parent side: it starts the ranks, sends each request to
all of them and returns their answers in rank order.  Inputs are made on
both sides from the same numpy seed (:func:`make_input`), so a request
carries only seeds and layouts.  Placements are encoded as short lists
(:func:`enc` / :func:`dec`) and decoded against either placements module.
Imports nothing of JAX.
"""

import base64
import json
import os
import select
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from vescale_tpu_torch.testing import is_transport_error, make_child_env, reserve_port  # noqa: E402


# -------------------------------------------------------------- encoding
def enc(p) -> list:
    """A placement as a short list (either package's placement types)."""
    name = type(p).__name__
    if name == "Shard":
        return ["S", p.dim]
    if name == "Replicate":
        return ["R"]
    if name == "Partial":
        return ["P", p.reduce_op]
    if name == "InterleavedShard":
        return ["IS", p.dim, p.interleaved_size]
    if name == "StridedRaggedShard":
        return ["SRS", list(p.dims), list(p.local_units), p.split_factor]
    if name == "RaggedShard":
        return ["RS", list(p.dims), list(p.local_units)]
    raise ValueError(f"cannot encode {p!r}")


def dec(e, mod):
    """The placement ``e`` (from :func:`enc`) of placements module ``mod``."""
    kind = e[0]
    if kind == "S":
        return mod.Shard(e[1])
    if kind == "R":
        return mod.Replicate()
    if kind == "P":
        return mod.Partial(e[1])
    if kind == "IS":
        return mod.InterleavedShard(e[1], e[2])
    if kind == "RS":
        return mod.RaggedShard(tuple(e[1]), tuple(e[2]))
    if kind == "SRS":
        return mod.StridedRaggedShard(tuple(e[1]), tuple(e[2]), split_factor=e[3])
    raise ValueError(f"unknown placement code {e!r}")


def to_wire(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        x = x.numpy()
    if isinstance(x, np.ndarray):
        a = np.ascontiguousarray(x)
        return {"__nd__": a.dtype.str, "shape": list(a.shape),
                "b64": base64.b64encode(a.tobytes()).decode("ascii")}
    if isinstance(x, dict):
        return {str(k): to_wire(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_wire(v) for v in x]
    return x


def from_wire(x):
    if isinstance(x, dict) and "__nd__" in x:
        return np.frombuffer(base64.b64decode(x["b64"]), dtype=np.dtype(x["__nd__"])).reshape(x["shape"]).copy()
    if isinstance(x, dict):
        return {k: from_wire(v) for k, v in x.items()}
    if isinstance(x, list):
        return [from_wire(v) for v in x]
    return x


def make_input(shape, seed, kind="normal", rank=None):
    """The numpy input of a case: standard normals (float32), or
    integer-valued float32 (``"int"``) where a sum must be exact.  With
    ``rank``, that rank's own operand."""
    rng = np.random.default_rng(seed if rank is None else seed * 1000 + rank + 1)
    if kind == "int":
        return rng.integers(-8, 9, size=tuple(shape)).astype(np.float32)
    return rng.standard_normal(tuple(shape)).astype(np.float32)


# ------------------------------------------------------------- the cases
_MESHES = {}


def mesh(shape, names):
    from vescale_tpu_torch.mesh import init_device_mesh

    key = (tuple(shape), tuple(names))
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))
    return _MESHES[key]


def _pl(encoded):
    from vescale_tpu_torch import placements

    return [dec(e, placements) for e in encoded]


def local_operand(mesh_shape, placements, shape, seed, kind, rank):
    """Rank ``rank``'s own operand for ``from_local``: inputs of its local
    shape under ``placements`` (a Partial rank's contribution), the same on
    every replica of a replicated mesh dim (the reference keeps coordinate
    0's there)."""
    from vescale_tpu_torch.mesh import DeviceMesh
    from vescale_tpu_torch.spec import DArraySpec, TensorMeta

    m = DeviceMesh(tuple(f"d{i}" for i in range(len(mesh_shape))), tuple(mesh_shape),
                   device_type="cpu")
    spec = DArraySpec(m, _pl(placements), TensorMeta(tuple(shape), torch.float32))
    coord = [0 if p.is_replicate() else c for p, c in zip(spec.placements, m.coordinate_of_rank(rank))]
    canon = int(np.ravel_multi_index(coord, m.shape))
    return make_input(spec.local_shape(coord), seed, kind, rank=canon)


def case_layout(mesh_shape, names, placements, shape, seed, kind="normal"):
    """distribute_tensor -> to_local, full_tensor and the fallback count."""
    from vescale_tpu_torch.darray import distribute_tensor

    m = mesh(mesh_shape, names)
    d = distribute_tensor(make_input(shape, seed, kind), m, _pl(placements))
    return {"local": d.to_local(), "full": d.full_tensor(), "rank": d.rank,
            "coord": list(d.coordinate)}


def case_redistribute(mesh_shape, names, src, dst, shape, seed, kind="normal", dst_mesh=None,
                      partial_locals=False, strict=False):
    """distribute (or from_local of per-rank operands) with ``src``, then
    redistribute to ``dst``: its local, its full tensor, whether it warned."""
    from vescale_tpu_torch.darray import distribute_tensor, from_local
    from vescale_tpu_torch.telemetry.registry import GLOBAL

    m = mesh(mesh_shape, names)
    if partial_locals:
        x = local_operand(mesh_shape, src, shape, seed, kind, m.get_rank())
        d = from_local(x, m, _pl(src), shape=tuple(shape))
    else:
        d = distribute_tensor(make_input(shape, seed, kind), m, _pl(src))
    target = mesh(*dst_mesh) if dst_mesh else None
    before = GLOBAL.counter("redistribute.fallbacks")
    if strict:
        os.environ["VESCALE_STRICT_REDISTRIBUTE"] = "1"
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            r = d.redistribute(target, _pl(dst))
    except RuntimeError as e:
        return {"raised": str(e)}
    finally:
        os.environ.pop("VESCALE_STRICT_REDISTRIBUTE", None)
    msgs = [str(w.message) for w in caught if "redistribute fallback" in str(w.message)]
    return {"local": r.to_local(), "full": r.full_tensor(), "warned": msgs,
            "fallbacks": GLOBAL.counter("redistribute.fallbacks") - before,
            "placements": [enc(p) for p in r.placements]}


def case_from_local(mesh_shape, names, placements, local_shapes, seed, run_check=True):
    """from_local of this rank's operand (its own shape), run_check on."""
    from vescale_tpu_torch.darray import from_local

    m = mesh(mesh_shape, names)
    r = m.get_rank()
    x = make_input(local_shapes[r], seed, "normal", rank=r)
    d = from_local(x, m, _pl(placements), run_check=run_check)
    return {"shape": list(d.shape), "local": d.to_local(), "full": d.full_tensor()}


def case_api(mesh_shape, names, src, shape, seed, call, kind="int", partial_locals=True, **kw):
    """One of the three api calls."""
    from vescale_tpu_torch import api
    from vescale_tpu_torch.darray import distribute_tensor, from_local

    m = mesh(mesh_shape, names)
    if partial_locals:
        x = local_operand(mesh_shape, src, shape, seed, kind, m.get_rank())
        d = from_local(x, m, _pl(src), shape=tuple(shape))
    else:
        d = distribute_tensor(make_input(shape, seed, kind), m, _pl(src))
    out = getattr(api, call)(d, **kw)
    return {"local": out.to_local(), "full": out.full_tensor(),
            "placements": [enc(p) for p in out.placements]}


def case_collective(mesh_shape, names, op, shape, seed, mesh_dim=0, **kw):
    """One mesh collective on this rank's operand (slice ``rank`` of the
    stacked input)."""
    from vescale_tpu_torch import collectives as C

    m = mesh(mesh_shape, names)
    me = m.get_coordinate()[m._dim_index(mesh_dim)]
    x = torch.from_numpy(make_input([m.size(mesh_dim)] + list(shape), seed, "int")[me])
    C.reset_calls()
    out = getattr(C, op)(x, m, mesh_dim=mesh_dim, **kw)
    return {"out": out, "calls": dict(C.CALLS)}


def case_partial_bits(mesh_shape, names, shape, seed, repeats=2):
    """Partial(sum) -> Replicate of float operands, twice: every rank and
    every repeat must give the same bits."""
    from vescale_tpu_torch.darray import from_local

    m = mesh(mesh_shape, names)
    outs = []
    for _ in range(repeats):
        d = from_local(make_input(shape, seed, "normal", rank=m.get_rank()), m,
                       ["partial"] * m.ndim, shape=tuple(shape))
        outs.append(d.full_tensor())
    return {"outs": outs}


def case_factories(mesh_shape, names, placements, shape, seed):
    """zeros, ones, full, rand and randn: this rank's piece."""
    from vescale_tpu_torch import darray as D
    from vescale_tpu_torch.random import manual_seed

    m = mesh(mesh_shape, names)
    pl = _pl(placements)
    manual_seed(seed)
    out = {
        "rand": D.rand(tuple(shape), device_mesh=m, placements=pl).to_local(),
        "randn": D.randn(tuple(shape), device_mesh=m, placements=pl).to_local(),
        "zeros": D.zeros(tuple(shape), device_mesh=m, placements=pl).to_local(),
        "ones": D.ones(tuple(shape), device_mesh=m, placements=pl).to_local(),
        "full": D.full(tuple(shape), 2.5, device_mesh=m, placements=pl).to_local(),
    }
    return out


def case_deferred(mesh_shape, names, placements, seed):
    """materialize_module of the tiny Llama's init: this rank's pieces."""
    from vescale_tpu_torch.initialize import deferred_init, is_deferred, materialize_module
    from vescale_tpu_torch.models import LlamaConfig, init_params

    cfg = _tiny()
    m = mesh(mesh_shape, names)
    meta = deferred_init(init_params, cfg, seed=seed)
    tree = materialize_module(init_params, _pl(placements), cfg, seed=seed, mesh=m)
    return {"deferred": is_deferred(meta),
            "embedding": tree["embed_tokens"]["embedding"].to_local(),
            "gate": tree["layers_1"]["mlp"]["gate_proj"]["kernel"].to_local()}


def _tiny():
    from vescale_tpu_torch.models import LlamaConfig

    return LlamaConfig(vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                       num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=64,
                       dtype=torch.float32)


def case_serve(mesh_shape, names, seed=0):
    """The tiny Llama served from Replicate DArray leaves on this rank's
    CPU mesh: greedy streams of four prompts."""
    from vescale_tpu_torch.initialize import materialize_module
    from vescale_tpu_torch.models import init_params
    from vescale_tpu_torch.serve import KVCacheConfig, PagedKVCache, ServeEngine

    cfg = _tiny()
    m = mesh(mesh_shape, names)
    tree = materialize_module(init_params, ["replicate"], cfg, seed=seed, mesh=m)
    kc = KVCacheConfig(layers=2, kv_heads=2, head_dim=cfg.head_dim, num_slots=2, page_size=4,
                       pages_per_slot=4)
    eng = ServeEngine(cfg, tree, PagedKVCache(kc, device="cpu"), mesh=m)
    return {"streams": [eng.replay_greedy(p, 6) for p in PROMPTS]}


def case_exchange_buffers(mesh_shape, names, src, dst, shape, seed):
    """A redistribute with every all-to-all's send and receive sizes and
    every collective recorded: what the transition allocates to move data."""
    from vescale_tpu_torch import collectives as C
    from vescale_tpu_torch.darray import distribute_tensor

    m = mesh(mesh_shape, names)
    d = distribute_tensor(make_input(shape, seed), m, _pl(src))
    sizes = []
    real = C.all_to_all_v

    def spy(send, send_splits, recv_splits, group):
        sizes.append([int(send.numel()), int(sum(recv_splits))])
        return real(send, send_splits, recv_splits, group)

    C.reset_calls()
    C.all_to_all_v = spy
    try:
        r = d.redistribute(placements=_pl(dst))
    finally:
        C.all_to_all_v = real
    return {"sizes": sizes, "calls": dict(C.CALLS), "src_numel": int(d.to_local().numel()),
            "dst_numel": int(r.to_local().numel())}


def case_mesh_api(seed=0):
    """The live mesh, VeDeviceMesh and the distributed helpers on this rank."""
    import torch.distributed as dist

    from vescale_tpu_torch import distributed as D
    from vescale_tpu_torch.devicemesh_api import VeDeviceMesh

    n = dist.get_world_size()
    ve = VeDeviceMesh()
    shape = (2, n // 2) if n > 2 else (1, n)
    m = ve.init_device_mesh("cpu", shape, mesh_dim_names=("dp", "tp"))
    tp = ve.get_tensor_parallel_mesh()
    groups = [dist.get_process_group_ranks(m.get_group(i)) for i in range(2)]
    hybrid = D.hybrid_device_mesh(("dcn", "ici"), ici_shape=(n // 2,), dcn_shape=(2,),
                                  device_type="cpu") if n > 2 else None
    ok_all = D.all_processes_ok(True, tag="t1")
    ok_one = D.all_processes_ok(dist.get_rank() != 1, tag="t2")
    try:
        D.all_processes_ok(True, tag=f"rank{dist.get_rank() % 2}")
        mismatch = "none"
    except RuntimeError as e:
        mismatch = str(e)
    D.initialize(device_type="cpu")  # already initialized: nothing happens
    return {"rank": m.get_rank(), "coord": list(m.get_coordinate()),
            "strategy": list(ve.get_strategy_coordinate()), "dp": ve.get_data_parallel_rank(),
            "tp": ve.get_tensor_parallel_rank(), "pp": ve.get_pipeline_parallel_rank(),
            "lookup_tp": ve.lookup_rank("tp"), "first": ve.is_first_stage(), "last": ve.is_last_stage(),
            "tp_mesh_ranks": tp.ranks.tolist(), "tp_live": tp.is_live,
            "all_tp": [x.ranks.tolist() for x in ve.get_global_tensor_parallel_meshes()],
            "groups": groups, "backend": dist.get_backend(m.get_group(0)),
            "hybrid": None if hybrid is None else [list(hybrid.shape), list(hybrid.get_coordinate())],
            "ok_all": ok_all, "ok_one": ok_one, "mismatch": mismatch,
            "initialized": D.is_initialized(), "count": D.process_count(), "index": D.process_index()}


def case_elementwise(mesh_shape, names, seed):
    """a + b * 2 and -a on two Shard DArrays, and a Partial(sum) sum."""
    from vescale_tpu_torch.darray import distribute_tensor, from_local

    m = mesh(mesh_shape, names)
    a = distribute_tensor(make_input((8, 3), seed), m, _pl([["S", 0]] * len(mesh_shape)))
    b = distribute_tensor(make_input((8, 3), seed + 1), m, _pl([["S", 0]] * len(mesh_shape)))
    c = a + b * 2.0 - 1.0
    p = from_local(make_input((4,), seed, "int", rank=m.get_rank()), m, ["partial"] * m.ndim)
    q = (p + p) * 3.0
    return {"c": c.full_tensor(), "neg": (-a).full_tensor(), "q": q.full_tensor(),
            "div": (a / 4.0).to_local()}


# ------------------------------------------------------ checkpoint cases
def ckpt_value(leaf, rank=None):
    """A checkpoint case's leaf value: ``make_input`` in float32 cast to the
    leaf's dtype (integer-valued inputs for int32); with ``rank``, that
    rank's own operand of a Partial leaf."""
    kind = "int" if leaf["dtype"] == "int32" else leaf.get("kind", "normal")
    if rank is None:
        x = make_input(leaf["shape"], leaf["seed"], kind)
    else:
        x = local_operand(leaf["mesh_shape"], leaf["placements"], leaf["shape"], leaf["seed"], kind,
                          rank)
    return torch.from_numpy(x).to(getattr(torch, leaf["dtype"]))


def _ckpt_leaves(m, leaves, template=False):
    from vescale_tpu_torch.darray import distribute_tensor, from_local

    out = {}
    for leaf in leaves:
        if leaf.get("host"):
            out[leaf["key"]] = np.zeros(leaf["shape"]) if template else np.arange(
                float(np.prod(leaf["shape"]))).reshape(leaf["shape"])
        elif leaf.get("partial") and not template:
            x = ckpt_value(dict(leaf, mesh_shape=list(m.shape)), rank=m.get_rank())
            out[leaf["key"]] = from_local(x, m, _pl(leaf["placements"]), shape=tuple(leaf["shape"]))
        else:
            x = ckpt_value(leaf)
            out[leaf["key"]] = distribute_tensor(torch.zeros_like(x) if template else x, m,
                                                 _pl(leaf["placements"]))
    return out


def case_ckpt_save(root, mesh_shape, names, leaves, fail=None, async_save=False,
                   submit_fails_on=None):
    """Every rank saves its pieces of ``leaves`` to ``root`` (``fail``: a
    faultsim schedule armed around the save, through the Python writer;
    ``submit_fails_on``: the rank whose first chunk cannot be serialized);
    returns ``{"ok": True}`` or what the save raised."""
    from vescale_tpu_torch import checkpoint
    from vescale_tpu_torch.checkpoint import storage
    from vescale_tpu_torch.resilience import faultsim
    from vescale_tpu_torch.resilience.retry import reset_default_policies

    m = mesh(mesh_shape, names)
    state = {"m": _ckpt_leaves(m, leaves)}
    real_submit = storage.AsyncWriter.submit
    if submit_fails_on == m.get_rank():
        def failing(self, name, arr):
            raise TypeError(f"cannot serialize {name} (injected)")

        storage.AsyncWriter.submit = failing
    if fail:
        os.environ["VESCALE_NATIVE_CKPT_IO"] = "0"
        os.environ["VESCALE_CKPT_RETRIES"] = "1"
        reset_default_policies()
        faultsim.arm(faultsim.parse_schedule(fail))
    try:
        handle = checkpoint.save(root, state, async_checkpoint=async_save)
        if handle is not None:
            handle.wait()
        return {"ok": True}
    except Exception as e:  # noqa: BLE001 — the parent test reads it
        return {"raised": f"{type(e).__name__}: {e}"}
    finally:
        storage.AsyncWriter.submit = real_submit
        faultsim.disarm()
        os.environ.pop("VESCALE_NATIVE_CKPT_IO", None)
        os.environ.pop("VESCALE_CKPT_RETRIES", None)
        reset_default_policies()


def case_ckpt_load(root, mesh_shape, names, leaves):
    """Every rank loads ``leaves`` laid out on this mesh: its pieces, their
    full tensors and its ``LAST_LOAD_STATS``."""
    from vescale_tpu_torch import checkpoint

    m = mesh(mesh_shape, names)
    out = checkpoint.load(root, {"m": _ckpt_leaves(m, leaves, template=True)})["m"]
    return {"locals": {k: v.to_local() for k, v in out.items() if not isinstance(v, np.ndarray)},
            "full": {k: v.full_tensor() if not isinstance(v, np.ndarray) else v
                     for k, v in out.items()},
            "placements": {k: [enc(p) for p in v.placements] for k, v in out.items()
                           if not isinstance(v, np.ndarray)},
            "stats": dict(checkpoint.LAST_LOAD_STATS)}


def case_ckpt_manager(root, mesh_shape, names, leaves, steps, keep):
    """Every rank saves ``steps`` through one ``CheckpointManager`` (values
    shifted by the step), then agrees on the newest step and restores it."""
    from vescale_tpu_torch.checkpoint import CheckpointManager

    m = mesh(mesh_shape, names)
    mgr = CheckpointManager(root, keep=keep)
    for step in steps:
        state = _ckpt_leaves(m, leaves)
        mgr.save(step, {"m": {k: v + float(step) for k, v in state.items()}})
    common = mgr.latest_common_step(timeout_s=60)
    out = mgr.restore({"m": _ckpt_leaves(m, leaves, template=True)}, step=common)["m"]
    return {"common": common, "dirs": sorted(os.listdir(root)),
            "full": {k: v.full_tensor() for k, v in out.items()}}


PROMPTS = ([3, 9, 27], [1, 2, 3, 4, 5], [60, 7], [11, 12, 13, 14, 15, 16, 17])

# ------------------------------------------------ tensor parallel (A10)
# the GPT of tests/test_dmodule.py, a GQA Llama whose heads split 4 ways,
# and the serve tests' tiny Llama (tests/test_serve.py)
TP_CONFIGS = {
    "gpt": dict(block_size=32, vocab_size=128, n_layer=2, n_head=4, n_embd=64),
    "llama": dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=8, num_key_value_heads=4, max_position_embeddings=64),
    "serve": dict(vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                  num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=64),
}
TP_BATCH = (2, 16)  # (B, T) of a training batch
TP_LR = 1e-3


def tp_config(kind, mod=None):
    """``kind``'s config of the port (or of the module ``mod`` holding
    ``GPTConfig`` / ``LlamaConfig``, e.g. the reference's), fp32."""
    if mod is None:
        from vescale_tpu_torch import models as mod
    if kind == "gpt":
        return mod.GPTConfig(**TP_CONFIGS[kind], dropout=0.0)
    dtype = torch.float32 if mod.__name__.startswith("vescale_tpu_torch") else np.float32
    return mod.LlamaConfig(**TP_CONFIGS[kind], dtype=dtype)


def tp_tree(kind, seed):
    """The numpy-seeded flax-layout weights of ``kind``: kernels normal over
    sqrt(fan_in), embeddings normal, norm weights and scales 1 plus noise,
    biases noise, drawn leaf by leaf in ``param_shapes`` order."""
    from vescale_tpu_torch.models import param_shapes

    rng = np.random.default_rng(seed)

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, f"{path}.{k}" if path else k) for k, v in node.items()}
        x = rng.standard_normal(node).astype(np.float32)
        if path.endswith(("weight", "scale")):
            return (1.0 + 0.1 * x).astype(np.float32)
        if path.endswith("bias"):
            return (0.1 * x).astype(np.float32)
        if path.endswith("embedding"):
            return (0.5 * x).astype(np.float32)
        return (x / np.sqrt(node[0])).astype(np.float32)

    return build(param_shapes(tp_config(kind)), "")


def tp_tokens(kind, seed):
    rng = np.random.default_rng(seed + 100)
    B, T = TP_BATCH
    return rng.integers(0, TP_CONFIGS[kind]["vocab_size"], (B, T + 1)).astype(np.int64)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def tp_model(kind, params, device="cpu"):
    from vescale_tpu_torch.models import GPT, Llama

    cls = GPT if kind == "gpt" else Llama
    return cls(tp_config(kind), _torch_tree(params), device=device)


def tp_loss(mesh_=None):
    from vescale_tpu_torch.loss import vocab_parallel_cross_entropy

    if mesh_ is None:
        return lambda lg, b: vocab_parallel_cross_entropy(lg, b["target"])
    return lambda lg, b: vocab_parallel_cross_entropy(lg, b["target"], mesh=mesh_,
                                                      vocab_dim_name="tp")


def case_tp_model(kind, tp, sp, seed, steps=3, names=("tp",)):
    """``kind`` parallelized by its plan on a mesh of ``tp`` ranks (a 2-D
    ("dp", "tp") mesh with dp = 1 when ``names`` says so): this rank's
    parameter pieces, the full logits of a forward, the loss and this
    rank's gradient pieces of one step, then ``steps`` AdamWLowmem steps'
    losses and parameter pieces."""
    from vescale_tpu_torch.dmodule import parallelize_module
    from vescale_tpu_torch.models import llama_plan, nanogpt_plan
    from vescale_tpu_torch.parallel import AdamWLowmem
    from vescale_tpu_torch.train import make_train_step

    shape = [tp] if len(names) == 1 else [1, tp]
    m = mesh(shape, names)
    plan = (nanogpt_plan if kind == "gpt" else llama_plan)(m, sequence_parallel=sp)
    dm = parallelize_module(tp_model(kind, tp_tree(kind, seed)), m, plan)
    toks = torch.from_numpy(tp_tokens(kind, seed))
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
    out = {"pieces": {n: p.detach().clone() for n, p in dm.named_parameters()}}
    flat = {}

    def walk(node, prefix=""):
        for k, v in node.items():
            path = f"{prefix}.{k}" if prefix else k
            walk(v, path) if isinstance(v, dict) else flat.__setitem__(path, list(v.shape))

    walk(dm.param_specs())
    out["spec_shapes"] = flat
    with torch.no_grad():
        out["logits"] = dm(batch["input"])
    opt = AdamWLowmem(dm.parameters(), TP_LR, state_dtype=torch.float32)
    step = make_train_step(dm, opt, tp_loss(m))
    # the first step's gradients, read before its update
    grads = {}
    real = opt.step

    def spy():
        grads.update({n: p.grad.detach().clone() for n, p in dm.named_parameters()})
        real()

    opt.step = spy
    out["losses"] = [float(step(batch))]
    opt.step = real
    out["grads"] = grads
    out["losses"] += [float(step(batch)) for _ in range(steps - 1)]
    out["final"] = {n: p.detach().clone() for n, p in dm.named_parameters()}
    return out


def case_tp_plan_behaviors(tp):
    """The forward plan's behaviors of tests/test_dmodule.py:185-256 on a
    mesh of ``tp`` ranks: kwargs resharded, a method-scoped entry, the
    matched-nothing warnings, and a DModule called inside another."""
    import warnings as _w

    from torch import nn

    from vescale_tpu_torch.dmodule import parallelize_module
    from vescale_tpu_torch.models.llama import Dense, Embed
    from vescale_tpu_torch.placements import Replicate, Shard

    m = mesh([tp], ["tp"])
    rng = np.random.default_rng(3)

    class KwModel(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = Dense(16, 32, torch.float32, "cpu", use_bias=True)
            with torch.no_grad():
                self.fc.kernel.copy_(torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32)))
                self.fc.bias.zero_()

        def forward(self, x, scale=None):
            h = self.fc(x)
            return h if scale is None else h * scale

    res = {}
    x = torch.ones(4, 16)
    scale = torch.full((4, 32), 2.0)
    km = KwModel()
    dm = parallelize_module(km, m, {"forward": {r"": {"input": [[Shard(0)]]}}})
    out = dm(x, scale=scale)
    res["kwargs_out"] = out
    res["kwargs_ref"] = dm(x) * 2.0
    res["kwargs_tag"] = enc(out._vtt_placements[0])

    class Tied(nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = Embed(64, 16, torch.float32, "cpu")
            with torch.no_grad():
                self.emb.embedding.copy_(torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32)))

        def forward(self, idx):
            return self.emb.attend(self.emb(idx))

    dm = parallelize_module(Tied(), m, {"forward": {r"emb:attend": {"output": [[Shard(0)]]}}})
    out = dm(torch.ones(4, 8, dtype=torch.int64))
    res["method_shape"] = list(out.shape)
    res["method_matched"] = r"emb:attend" in dm._fwd_matched
    bad_plan = {
        "parameter": {r"fc_TYPO\.kernel": [Shard(1)], r".*": [Replicate()]},
        "forward": {r"does_not_exist": {"input": [[Shard(0)]]}},
    }
    with _w.catch_warnings(record=True) as got:
        _w.simplefilter("always")
        dm = parallelize_module(KwModel(), m, bad_plan)
        res["param_warning"] = [str(w.message) for w in got]
    with _w.catch_warnings(record=True) as got:
        _w.simplefilter("always")
        dm(x)
        res["fwd_warning"] = [str(w.message) for w in got]
    inner = parallelize_module(KwModel(), m, {"forward": {r"": {"output": [[Shard(0)]]}}})

    class Outer(nn.Module):
        def __init__(self):
            super().__init__()
            self.head = Dense(32, 8, torch.float32, "cpu")
            with torch.no_grad():
                self.head.kernel.copy_(torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32)))

        def forward(self, x):
            return self.head(inner(x))

    outer = parallelize_module(Outer(), m, {"forward": {r"": {"input": [[Shard(0)]]}}})
    out = outer(x)
    res["nested_shape"] = list(out.shape)
    res["nested_finite"] = bool(torch.isfinite(out).all())
    return res


def case_tp_xent(rows, vocab, label_smoothing, seed, tp):
    """The vocab-parallel loss on this rank's slice of numpy-seeded fp32
    logits: the loss and this rank's dlogits piece."""
    from vescale_tpu_torch.loss import vocab_parallel_cross_entropy

    m = mesh([tp], ["tp"])
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((rows, vocab)).astype(np.float32) * 3.0
    tgt = rng.integers(0, vocab, (rows,)).astype(np.int64)
    w = vocab // tp
    r = m.get_coordinate()[0]
    piece = torch.from_numpy(lg[:, r * w:(r + 1) * w].copy()).requires_grad_(True)
    loss = vocab_parallel_cross_entropy(piece, torch.from_numpy(tgt), mesh=m,
                                        vocab_dim_name="tp", label_smoothing=label_smoothing)
    loss.backward()
    return {"loss": loss.detach(), "dlogits": piece.grad}


def case_tp_patch(seed, tp):
    """ColumnParallelLinear, RowParallelLinear and VocabParallelEmbedding on
    this rank: a column-parallel layer feeding a row-parallel one (the
    Megatron MLP) and the embedding, from full numpy weights; the outputs,
    the input's gradient and this rank's weight-gradient pieces."""
    from vescale_tpu_torch.model.patch import (ColumnParallelLinear, RowParallelLinear,
                                               VocabParallelEmbedding)

    m = mesh([tp], ["tp"])
    rng = np.random.default_rng(seed)
    w1 = rng.standard_normal((16, 32)).astype(np.float32) / 4
    b1 = rng.standard_normal((32,)).astype(np.float32) / 10
    w2 = rng.standard_normal((32, 8)).astype(np.float32) / 6
    b2 = rng.standard_normal((8,)).astype(np.float32) / 10
    table = rng.standard_normal((64, 16)).astype(np.float32)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    ids = rng.integers(0, 64, (4, 5)).astype(np.int64)
    col = ColumnParallelLinear(16, 32, mesh=m)
    row = RowParallelLinear(32, 8, mesh=m)
    emb = VocabParallelEmbedding(64, 16, mesh=m)
    col.load_full(torch.from_numpy(w1), torch.from_numpy(b1))
    row.load_full(torch.from_numpy(w2), torch.from_numpy(b2))
    emb.load_full(torch.from_numpy(table))
    xt = torch.from_numpy(x).requires_grad_(True)
    h = col(xt)
    y = row(h)
    y.square().sum().backward()
    e = emb(torch.from_numpy(ids))
    e.square().sum().backward()
    return {"h": h.detach(), "y": y.detach(), "dx": xt.grad, "dw1": col.kernel.grad,
            "db1": col.bias.grad, "dw2": row.kernel.grad, "db2": row.bias.grad,
            "e": e.detach(), "dtable": emb.embedding.grad}


def case_tp_flash(shape, seed, tp):
    """``flash_attention_sharded`` on this rank's heads of numpy-seeded
    (B, T, H, D) q and (B, T, KV, D) k/v: its output piece."""
    from vescale_tpu_torch.ops.flash_attention import flash_attention_sharded

    B, T, H, KV, D = shape
    m = mesh([tp], ["tp"])
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    r = m.get_coordinate()[0]

    def heads(a):
        w = a.shape[2] // tp
        return torch.from_numpy(a[:, :, r * w:(r + 1) * w].copy())

    return {"o": flash_attention_sharded(heads(q), heads(k), heads(v), m, causal=True)}


TP_COMM_OPS = ("copy_to_tp", "reduce_from_tp", "all_gather_partial", "all_gather_split",
               "reduce_scatter", "split")


def case_tp_comm(op, seed, tp, dim=1):
    """One of ``dmodule._comm``'s autograd collectives on this rank's
    numpy-seeded operand (the same on every rank where the op's input is
    Replicate) and cotangent: the output and the input's gradient."""
    from vescale_tpu_torch.dmodule import _comm
    from vescale_tpu_torch.dmodule._comm import TPDim

    m = mesh([tp], ["tp"])
    t = TPDim(m, "tp")
    r = t.rank
    replicated_in = op in ("copy_to_tp", "split")
    x = make_input((4, 8, 3), seed, rank=None if replicated_in else r)
    xt = torch.from_numpy(x).requires_grad_(True)
    fn = {
        "copy_to_tp": lambda v: _comm.copy_to_tp(v, t),
        "reduce_from_tp": lambda v: _comm.reduce_from_tp(v, t),
        "all_gather_partial": lambda v: _comm.all_gather(v, t, dim, True),
        "all_gather_split": lambda v: _comm.all_gather(v, t, dim, False),
        "reduce_scatter": lambda v: _comm.reduce_scatter(v, t, dim),
        "split": lambda v: _comm.split(v, t, dim),
    }[op]
    y = fn(xt)
    g = make_input(tuple(y.shape), seed + 1, rank=r)
    y.backward(torch.from_numpy(g))
    return {"x": x, "y": y.detach(), "g": g, "dx": xt.grad}


def dp_rows(m, toks):
    """This rank's rows of a global batch: dim 0 split over the "dp" dim."""
    names = m.mesh_dim_names
    if "dp" not in names:
        return toks
    n, r = m.size("dp"), m.get_coordinate()[names.index("dp")]
    b = toks.shape[0] // n
    return toks[r * b:(r + 1) * b]


def case_tp_dp_step(kind="llama", seed=0, steps=3, dp=2, tp=2):
    """``make_train_step`` over a ("dp", "tp") mesh: ``kind`` under its plan
    with sequence parallelism, each dp rank on its own rows of the batch,
    ``steps`` AdamWLowmem (fp32 moments) steps; the losses, the first
    step's gradient pieces (after the dp average) and the final pieces."""
    from vescale_tpu_torch.dmodule import parallelize_module
    from vescale_tpu_torch.models import llama_plan, nanogpt_plan
    from vescale_tpu_torch.parallel import AdamWLowmem
    from vescale_tpu_torch.train import make_train_step

    m = mesh([dp, tp], ["dp", "tp"])
    plan = (nanogpt_plan if kind == "gpt" else llama_plan)(m, sequence_parallel=True)
    dm = parallelize_module(tp_model(kind, tp_tree(kind, seed)), m, plan)
    toks = torch.from_numpy(dp_rows(m, dp_tokens(kind, seed)))
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
    opt = AdamWLowmem(dm.parameters(), TP_LR, state_dtype=torch.float32)
    step = make_train_step(dm, opt, tp_loss(m))
    grads, real = {}, opt.step

    def spy():
        grads.update({n: p.grad.detach().clone() for n, p in dm.named_parameters()})
        real()

    opt.step = spy
    losses = [float(step(batch))]
    opt.step = real
    losses += [float(step(batch)) for _ in range(steps - 1)]
    return {"losses": losses, "grads": grads,
            "final": {n: p.detach().clone() for n, p in dm.named_parameters()}}


def case_tp_dropout(tp, sp, seed, rate, keys):
    """The GPT with dropout ``rate`` under ``nanogpt_plan`` on a ("tp",)
    mesh, trained by ``make_train_step`` with AdamWLowmem (fp32 moments)
    one step a key of ``keys`` (each two 32-bit words): the losses and, in
    draw order, the dropout masks this rank drew."""
    from vescale_tpu_torch.dmodule import parallelize_module
    from vescale_tpu_torch.models import GPT, nanogpt_plan
    from vescale_tpu_torch.models import nanogpt as tg
    from vescale_tpu_torch.parallel import AdamWLowmem
    from vescale_tpu_torch.train import make_train_step

    import dataclasses

    m = mesh([tp], ["tp"])
    cfg = dataclasses.replace(tp_config("gpt"), dropout=rate)
    dm = parallelize_module(GPT(cfg, _torch_tree(tp_tree("gpt", seed)), device="cpu"), m,
                            nanogpt_plan(m, sequence_parallel=sp))
    toks = torch.from_numpy(tp_tokens("gpt", seed))
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
    opt = AdamWLowmem(dm.parameters(), TP_LR, state_dtype=torch.float32)
    step = make_train_step(dm, opt, tp_loss(m))
    masks, real = [], tg._dropout_mask

    def spy(*a):
        out = real(*a)
        masks.append(out.clone())
        return out

    tg._dropout_mask = spy
    try:
        losses = [float(step(batch, tuple(k))) for k in keys]
    finally:
        tg._dropout_mask = real
    return {"losses": losses, "masks": masks}


def case_host_route(seed, tp):
    """``mesh_ppermute`` (the op gloo refuses on CUDA tensors) run twice on
    this rank's operand: as the backend carries it, and through
    ``collectives.HOST_ROUTE``'s host copy; the results and the host-copy
    counts."""
    from vescale_tpu_torch import collectives as C

    m = mesh([tp], ["tp"])
    x = torch.from_numpy(make_input((4 * tp, 3), seed, rank=m.get_coordinate()[0]))
    ops = {"ppermute": lambda: C.mesh_ppermute(x, m)}
    plain = {k: f() for k, f in ops.items()}
    saved = dict(C.HOST_ROUTE)
    C.HOST_ROUTE[("gloo", "cpu")] = frozenset(ops)
    C.reset_calls()
    try:
        routed = {k: f() for k, f in ops.items()}
    finally:
        C.HOST_ROUTE.clear()
        C.HOST_ROUTE.update(saved)
    return {"plain": plain, "routed": routed,
            "copies": {k: int(v) for k, v in C.CALLS.items() if k.endswith(".host_copy")}}


SERVE_PROMPTS = ((5, 9, 17, 3, 44), (7, 3, 29), (40, 2, 33, 8, 12, 6))
SERVE_CACHE = dict(num_slots=2, page_size=4, pages_per_slot=4)
SERVE_STEPS = 6


def serve_generate(eng, cache, prompts=SERVE_PROMPTS, steps=SERVE_STEPS):
    """Two prompts in one decode batch, then the third alone: prefill, then
    ``steps`` greedy decode steps each; the slots stay allocated until the
    batch ends.  Either package's engine."""
    streams = []
    for batch in (prompts[:2], prompts[2:]):
        slots, toks = [], []
        for p in batch:
            s = cache.alloc(len(p), steps + 1)
            first = np.asarray(eng.prefill(p, s))
            cache.commit_prefill(s, len(p))
            slots.append(s)
            toks.append([int(np.argmax(first))])
        for _ in range(steps):
            t = np.zeros((cache.num_slots,), np.int32)
            for s, tk in zip(slots, toks):
                t[s] = tk[-1]
            lg = np.asarray(eng.decode(t))
            for s, tk in zip(slots, toks):
                cache.advance(s)
                tk.append(int(np.argmax(lg[s])))
        for s in slots:
            cache.free(s)
        streams += toks
    return streams


def case_tp_serve(form, seed, tp=2):
    """The serve tests' tiny Llama on a ("tp",) mesh of ``tp`` ranks over a
    Shard(3) pool, from the numpy-seeded weights as Replicate host tensors
    (``form="replicated"``) or as ``llama_plan`` DArray pieces
    (``"plan"``): the greedy streams and this rank's pool piece."""
    import re

    from vescale_tpu_torch.darray import distribute_tensor
    from vescale_tpu_torch.models import llama_plan
    from vescale_tpu_torch.serve import KVCacheConfig, PagedKVCache, ServeEngine

    cfg = tp_config("serve")
    m = mesh([tp], ["tp"])
    tree = _torch_tree(tp_tree("serve", seed))
    if form == "plan":
        plan = llama_plan(m)["parameter"]

        def lay(node, path=""):
            if isinstance(node, dict):
                return {k: lay(v, f"{path}.{k}" if path else k) for k, v in node.items()}
            return distribute_tensor(node, m, next(v for p, v in plan.items()
                                                   if re.fullmatch(p, path)))

        tree = lay(tree)
    kc = KVCacheConfig(layers=cfg.num_hidden_layers, kv_heads=cfg.num_key_value_heads,
                       head_dim=cfg.head_dim, **SERVE_CACHE)
    cache = PagedKVCache(kc, mesh=m)
    eng = ServeEngine(cfg, tree, cache, mesh=m)
    streams = serve_generate(eng, cache)
    return {"streams": streams, "k": cache.k, "v": cache.v, "graphed": eng.graphed,
            "kv_local": int(cache.k.shape[3])}


def case_tp_serve_paths(seed, tp=2):
    """The multi-token step, the suffix prefill, ``swap_params`` and
    ``decode_flops_per_step`` of the tensor-parallel engine against a
    single-device engine on the same weights (both in this process): max
    fp32 ulps at scale of ``decode_multi`` and ``prefill_suffix`` logits,
    streams before, during and after a swap to other weights and back."""
    from vescale_tpu_torch.kernels import ulps_at_scale
    from vescale_tpu_torch.serve import KVCacheConfig, PagedKVCache, ServeEngine

    cfg = tp_config("serve")
    m = mesh([tp], ["tp"])
    kc = KVCacheConfig(layers=cfg.num_hidden_layers, kv_heads=cfg.num_key_value_heads,
                       head_dim=cfg.head_dim, **SERVE_CACHE)
    tree = _torch_tree(tp_tree("serve", seed))
    other = _torch_tree(tp_tree("serve", seed + 1))
    tpe = ServeEngine(cfg, tree, PagedKVCache(kc, mesh=m), mesh=m)
    one = ServeEngine(cfg, tree, PagedKVCache(kc, device="cpu"), device="cpu")
    out = {"flops": [tpe.decode_flops_per_step(), one.decode_flops_per_step()]}
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    ulps = []
    for eng in (tpe, one):
        c = eng.cache
        s_ = c.alloc(4, 8)
        eng.prefill(prompt[:4], s_)
        c.commit_prefill(s_, 4)
        toks = np.zeros((c.num_slots, 3), np.int64)
        toks[s_] = prompt[4:7]
        eng._multi_out = eng.decode_multi(toks)[s_]
        c.free(s_)
        b = c.alloc(len(prompt), 2)
        eng.prefill(prompt[:4], b)
        c.commit_prefill(b, 4)
        eng._suffix_out = eng.prefill_suffix(prompt, b, 4)
        c.free(b)
    ulps.append(ulps_at_scale(tpe._multi_out, one._multi_out))
    ulps.append(ulps_at_scale(tpe._suffix_out, one._suffix_out))
    out["ulps"] = ulps
    before = tpe.replay_greedy(prompt, 6)
    old = tpe.swap_params(other)
    swapped = tpe.replay_greedy(prompt, 6)
    tpe.swap_params(old)
    out["streams"] = [before, swapped, tpe.replay_greedy(prompt, 6)]
    one.swap_params(other)
    out["single_swapped"] = one.replay_greedy(prompt, 6)
    return out


# ------------------------------------------- data parallel, ZeRO, FSDP (A11)
DP_BATCH = (4, 16)  # (B, T) of the global batch of the dp cases
DP_LR = 1e-3


def dp_tokens(kind, seed, batch=DP_BATCH):
    rng = np.random.default_rng(seed + 200)
    B, T = batch
    return rng.integers(0, TP_CONFIGS[kind]["vocab_size"], (B, T + 1)).astype(np.int64)


def _state_locals(tree):
    """A state tree's DArray leaves as {key: local piece} and the
    placements of each."""
    from vescale_tpu_torch.checkpoint.planner import flatten_state
    from vescale_tpu_torch.darray import DArray

    locs, pls = {}, {}
    for key, leaf in flatten_state(tree):
        if isinstance(leaf, DArray):
            locs[key] = leaf.to_local()
            pls[key] = [enc(p) for p in leaf.placements]
        else:
            locs[key] = torch.as_tensor(leaf)
    return locs, pls


def _state_walk(node, path, out):
    """``state_placements()``'s tree as {checkpoint key: encoded placements}."""
    if isinstance(node, dict):
        for k in sorted(node):
            _state_walk(node[k], f"{path}/{k}" if path else k, out)
    elif hasattr(node, "_fields"):
        for f in node._fields:
            _state_walk(getattr(node, f), f"{path}/.{f}", out)
    elif isinstance(node, list):
        for i, v in enumerate(node):
            _state_walk(v, f"{path}/{i}", out)
    elif node is not None:
        out[path] = [enc(p) for p in node]
    return out


def _zero_out(dopt):
    """A ``DistributedOptimizer``'s state pieces, their placements and its
    ``state_placements()``."""
    locs, pls = _state_locals(dopt.state_tree())
    return {"state": locs, "placements": pls,
            "state_placements": _state_walk(dopt.state_placements(), "", {})}


def case_dp_qcoll(mesh_shape, names, shape, seed, rounding="nearest", key_seed=None, mesh_dim=0):
    """The quantized collectives on this rank's operand: ``all_reduce_q``
    and ``reduce_scatter_q`` (sum and avg), ``q_all_gather`` along dim 0
    and ``q_all_to_all`` (split 0, concat 1), with ``COMPRESS`` and the
    counted calls."""
    from vescale_tpu_torch import collectives as C
    from vescale_tpu_torch import random as R

    m = mesh(mesh_shape, names)
    x = torch.from_numpy(make_input(shape, seed, rank=m.get_rank()))
    key = None if key_seed is None else R.key(key_seed)
    kw = dict(block=64, rounding=rounding, key=key)
    g = m.get_group(mesh_dim)
    n = m.size(mesh_dim)
    C.reset_calls()
    out = {"ar_sum": C.all_reduce_q(x, m, "sum", mesh_dim, **kw),
           "ar_avg": C.all_reduce_q(x, m, "avg", mesh_dim, **kw),
           "rs_sum": C.reduce_scatter_q(x, m, "sum", 0, mesh_dim, **kw),
           "rs_avg": C.reduce_scatter_q(x, m, "avg", 0, mesh_dim, **kw),
           "ag": C.q_all_gather(x, g, axis=0, extent=shape[0] * n, **kw),
           "a2a": C.q_all_to_all(x, g, split_axis=0, concat_axis=1, **kw)}
    out["compress"] = {k: float(v) for k, v in C.COMPRESS.items()}
    out["calls"] = {k: int(v) for k, v in C.CALLS.items()}
    out["bytes"] = {k: int(v) for k, v in C.BYTES.items()}
    from vescale_tpu_torch.parallel import dp_grad_reduce

    grads = {"b": x * 2.0, "a": x}
    out["dpgr"] = dp_grad_reduce(grads, g, compress="int8", step=3, reduce_op="avg", **kw)
    out["dpgr_exact"] = dp_grad_reduce(grads, g, compress="off", reduce_op="avg")
    return out


def case_dp_ddp_sync(seed=0, compress=None):
    """``DistributedDataParallel.finish_grad_sync`` on DArray gradients of
    a ("dp", "tp") (2, 2) mesh: ones Partial on dp (tests/test_optim.py:242),
    a leaf Partial on both dims (the kept tp Partial), one Shard(1) on tp,
    each to Replicate and, with ``use_distributed_optimizer``, to Shard(0);
    every leaf's piece and full value; and the wrapper's batch and main
    grad helpers."""
    from vescale_tpu_torch.darray import from_local
    from vescale_tpu_torch.parallel import DistributedDataParallel
    from vescale_tpu_torch.placements import Partial, Replicate, Shard

    m = mesh([2, 2], ["dp", "tp"])
    r = m.get_rank()
    leaves = {
        "ones": from_local(torch.ones(2, 2), m, [Partial(), Replicate()]),
        "pp": from_local(torch.from_numpy(make_input((4, 6), seed, rank=r)), m,
                         [Partial(), Partial()]),
        "ps": from_local(torch.from_numpy(make_input((4, 3), seed + 1, rank=r)), m,
                         [Partial(), Shard(1)], shape=(4, 6)),
    }
    out = {}
    for zero in (False, True):
        ddp = DistributedDataParallel(torch.nn.Linear(2, 2), m, use_distributed_optimizer=zero,
                                      grad_compress=compress)
        got = ddp.finish_grad_sync(leaves)
        tag = "zero" if zero else "ddp"
        out[tag] = {k: {"local": v.to_local(), "full": v.full_tensor(),
                        "placements": [enc(p) for p in v.placements]} for k, v in got.items()}
    ddp = DistributedDataParallel(torch.nn.Linear(2, 2), m)
    toks = torch.arange(8 * 3).reshape(8, 3)
    out["batch"] = ddp.shard_batch({"input": toks})["input"]
    g = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    acc = ddp.accumulate_grads(ddp.accumulate_grads(ddp.init_main_grads(g), g), g)
    out["scaled"] = ddp.scale_grads(acc, 2)["w"]
    out["main_dtype"] = str(acc["w"].dtype)
    return out


def _gpt_dm(m, seed, plan=True):
    from vescale_tpu_torch.dmodule import parallelize_module
    from vescale_tpu_torch.models import nanogpt_plan

    return parallelize_module(tp_model("gpt", tp_tree("gpt", seed)), m,
                              nanogpt_plan(m) if plan else {})


def _ref_state_from_npz(path):
    """A reference optimizer state read back from ``np.savez`` of its
    flattened checkpoint keys: ``{"inner": [(count, mu, nu)], ...}`` with
    nested dicts, as ``models.convert.zero_state_from_jax`` reads it."""
    from collections import namedtuple

    Adam = namedtuple("ScaleByAdamLowmemState", ["count", "mu", "nu"])
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            node, *path_, leaf = key.split("/")
            cur = tree.setdefault(node, {})
            for k in path_:
                cur = cur.setdefault(k, {})
            cur[leaf] = z[key]
    inner = tree["inner"]["0"]
    tree["inner"] = [Adam(inner[".count"], inner[".mu"], inner[".nu"])]
    return tree


def case_dp_zero(mesh_shape, names, seed=0, steps=3, loss_scale=None, grad_compress=None,
                 state_dtype="float32", grad_clip=None, from_state=None):
    """ZeRO-2 on the tiny GPT under ``nanogpt_plan``: ``DistributedOptimizer``
    over ``AdamWLowmem`` through ``make_train_step``, each dp rank on its
    own rows (started from a reference state saved to ``from_state`` when
    given, through ``zero_state_from_jax``); the losses, every state piece
    and its placements after the steps, the final parameter pieces, and
    the collective counts of a step."""
    import functools

    from vescale_tpu_torch import collectives as C
    from vescale_tpu_torch.parallel import AdamWLowmem, DistributedOptimizer
    from vescale_tpu_torch.train import make_train_step

    m = mesh(mesh_shape, names)
    dm = _gpt_dm(m, seed)
    dopt = DistributedOptimizer(
        functools.partial(AdamWLowmem, lr=DP_LR, state_dtype=getattr(torch, state_dtype)),
        models=dm, loss_scale=loss_scale, grad_compress=grad_compress, grad_clip=grad_clip)
    if from_state is not None:
        from vescale_tpu_torch.models.convert import zero_state_from_jax

        dopt.load_state_tree(zero_state_from_jax(_ref_state_from_npz(from_state),
                                                 dopt.state_template()))
    step = make_train_step(dm, dopt, tp_loss(m if "tp" in names else None))
    toks = torch.from_numpy(dp_rows(m, dp_tokens("gpt", seed)))
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
    losses = []
    for _ in range(steps):
        C.reset_calls()
        losses.append(float(step(batch)))
    return {"losses": losses, **_zero_out(dopt),
            "final": {n: p.detach().clone() for n, p in dm.named_parameters()},
            "calls": {k: int(v) for k, v in C.CALLS.items()},
            "compress": {k: float(v) for k, v in C.COMPRESS.items()}}


def case_dp_scale_sequence(inf_rank=None):
    """tests/test_optim.py:91-175 on a ("tp",) mesh used as the dp dim:
    ``DistributedOptimizer`` over ``AdamWLowmem`` (fp32 moments) with a
    dynamic scale (1024, growth 2) stepped on a bad grad (an inf on every
    rank, or on ``inf_rank``'s only), then two good ones; then the floor
    and skip counter (init 4, min 1: four bad steps and a good one); then
    a static scale of 8 with a NaN.  Every rank's params, main params,
    moments and step after each step, and the scale state."""
    import functools

    from vescale_tpu_torch.parallel import AdamWLowmem, DistributedOptimizer

    m = mesh([2], ["tp"])
    r = m.get_rank()
    opt = functools.partial(AdamWLowmem, lr=1e-2, state_dtype=torch.float32)
    out = {}

    def snap(dopt, params):
        locs, _ = _state_locals(dopt.state_tree())
        return {"w": params["w"].detach().clone(), **locs}

    params = {"w": torch.nn.Parameter(torch.arange(16.0).reshape(4, 4))}
    dopt = DistributedOptimizer(opt, m, models=params, dp_dims=("tp",), loss_scale="dynamic",
                                init_scale=1024.0, growth_interval=2)
    good = torch.ones(4, 4) * 1024.0
    bad = good.clone()
    if inf_rank is None or inf_rank == r:
        bad[1, 2] = float("inf")
    seq = [snap(dopt, params)]
    for g in (bad, good, good):
        params["w"].grad = g.clone()
        skipped = dopt.step()
        seq.append(dict(snap(dopt, params), skipped=skipped))
    out["dynamic"] = seq
    out["scale_loss"] = float(dopt.scale_loss(torch.tensor(2.0)))
    params = {"w": torch.nn.Parameter(torch.ones(4, 4))}
    dopt = DistributedOptimizer(opt, m, models=params, dp_dims=("tp",), loss_scale="dynamic",
                                init_scale=4.0, min_scale=1.0)
    floor = []
    for g in [torch.full((4, 4), float("inf"))] * 4 + [torch.ones(4, 4)]:
        params["w"].grad = g.clone()
        dopt.step()
        floor.append(snap(dopt, params))
    out["floor"] = floor
    out["floor_scale_loss"] = float(dopt.scale_loss(torch.tensor(3.0)))
    params = {"w": torch.nn.Parameter(torch.arange(16.0).reshape(4, 4))}
    dopt = DistributedOptimizer(opt, m, models=params, dp_dims=("tp",), loss_scale=8.0)
    g = torch.ones(4, 4) * 1024.0
    g[0, 0] = float("nan")
    params["w"].grad = g
    out["static_skipped"] = dopt.step()
    out["static_w"] = params["w"].detach().clone()
    out["static_has_scale_state"] = "loss_scale" in dopt.state_tree()
    return out


def case_dp_fsdp(dp, seed=0, steps=3, names=("dp",)):
    """The ragged FSDP buffer over the tiny GPT's weights on a ("dp",)
    mesh of ``dp``: units, every rank's ``local_params``, this rank's
    packed piece, a gather round trip, then ``steps`` of
    ``make_fsdp_train_step`` (AdamWLowmem, fp32 moments) on this rank's
    rows: losses and the gathered final params."""
    import functools

    from vescale_tpu_torch.models.convert import _flatten
    from vescale_tpu_torch.parallel import AdamWLowmem, FSDPParamBuffer, make_fsdp_train_step

    m = mesh([dp], list(names))
    tree = _torch_tree(tp_tree("gpt", seed))
    buf = FSDPParamBuffer(tree, m, dim="dp")
    pieces = buf.pack(tree)
    back = _flatten(buf.gather(pieces))
    roundtrip = all(torch.equal(back[k], v) for k, v in _flatten(tree).items())
    model = tp_model("gpt", tp_tree("gpt", seed))
    step = make_fsdp_train_step(model, functools.partial(AdamWLowmem, lr=DP_LR,
                                                         state_dtype=torch.float32),
                                tp_loss(), buf)
    toks = torch.from_numpy(dp_rows(m, dp_tokens("gpt", seed)))
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
    losses = [float(step(batch)) for _ in range(steps)]
    final = _flatten(buf.gather(step.pieces))
    return {"units": list(buf.local_units), "paths": buf.paths,
            "local_params": [buf.local_params(r) for r in range(dp)],
            "pieces": pieces, "roundtrip": roundtrip, "losses": losses,
            "final": final}


def case_dp_ckpt(root, phase, dp, seed=0, names=("dp",), steps=1, fsdp=True, zero=True):
    """``phase="save"``: on a ("dp",) mesh of ``dp`` (or a ("dp", "tp") mesh
    when ``names`` says so), ZeRO-2 (the tiny GPT, ``steps`` steps) and the
    FSDP buffer with its AdamW moments after ``steps`` steps, saved to
    ``root``; returns the full values.  ``phase="load"``: both restored
    through ``state_template`` / ``buffer_templates`` on this mesh; returns
    this rank's pieces and their placements."""
    import functools

    from vescale_tpu_torch import checkpoint
    from vescale_tpu_torch.parallel import (AdamWLowmem, DistributedOptimizer, FSDPParamBuffer,
                                            make_fsdp_train_step)
    from vescale_tpu_torch.train import make_train_step

    shape = [dp] if len(names) == 1 else [dp, 2]
    m = mesh(shape, list(names))
    opt = functools.partial(AdamWLowmem, lr=DP_LR, state_dtype=torch.float32)
    dm = _gpt_dm(m, seed)
    dopt = DistributedOptimizer(opt, models=dm)
    toks = torch.from_numpy(dp_rows(m, dp_tokens("gpt", seed)))
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
    state = {}
    if zero:
        if phase == "save":
            step = make_train_step(dm, dopt, tp_loss(m if "tp" in names else None))
            for _ in range(steps):
                step(batch)
            state["optimizer"] = dopt.state_tree()
        else:
            state["optimizer"] = dopt.state_template()
    if fsdp:
        buf = FSDPParamBuffer(_torch_tree(tp_tree("gpt", seed)), m, dim="dp")
        if phase == "save":
            fstep = make_fsdp_train_step(tp_model("gpt", tp_tree("gpt", seed)), opt, tp_loss(), buf)
            for _ in range(steps):
                fstep(batch)
            st = fstep.optimizer.state[fstep.pieces["float32"]]
            state["fsdp"] = {"params": buf.constrain(fstep.pieces),
                             "exp_avg": buf.constrain({"float32": st["exp_avg"]}),
                             "exp_avg_sq": buf.constrain({"float32": st["exp_avg_sq"]})}
        else:
            t = buf.buffer_templates()
            state["fsdp"] = {"params": t, "exp_avg": dict(t), "exp_avg_sq": dict(t)}
    if phase == "save":
        checkpoint.save(root, state)
        from vescale_tpu_torch.checkpoint.planner import flatten_state
        from vescale_tpu_torch.darray import DArray

        return {k: (v.full_tensor() if isinstance(v, DArray) else torch.as_tensor(v))
                for k, v in flatten_state(state)}
    got = checkpoint.load(root, state)
    if zero:
        dopt.load_state_tree(got["optimizer"])
    locs, pls = _state_locals(got)
    return {"locals": locs, "placements": pls,
            "params": {n: p.detach().clone() for n, p in dm.named_parameters()}}


# ------------------------------------------------------ resilient loop
RESIL_TOTAL = 8


def resil_batch(i):
    """Global batch i, the same on every rank: x (8, 16), y (8, 32)."""
    g = np.random.default_rng(1000 + (i % 64))
    return (torch.from_numpy(g.normal(size=(8, 16)).astype(np.float32)),
            torch.from_numpy(g.normal(size=(8, 32)).astype(np.float32)))


def resil_state(m):
    """tests/multiproc/worker_resilience.py's mixed state: a weight cut by
    columns over the ("tp",) mesh (every rank writes chunks of it), a
    replicated bias (the fingerprint's sampled leaf) and a numpy count."""
    from vescale_tpu_torch.darray import distribute_tensor
    from vescale_tpu_torch.placements import Shard

    w = np.random.default_rng(0).normal(size=(16, 32)).astype(np.float32) * 0.1
    return ({"W": distribute_tensor(torch.from_numpy(w), m, [Shard(1)]),
             "b": torch.zeros(32)}, {"count": np.int64(0)})


def resil_step(params, opt, batch, step_key=None):
    """Least squares on this rank's columns; the bias gradient and the loss
    are gathered / summed over the ranks, so every rank agrees."""
    import torch.distributed as dist

    from vescale_tpu_torch.darray import DArray

    W, b = params["W"], params["b"]
    x, y = batch
    n = W.to_local().shape[1]
    cols = slice(W.rank * n, (W.rank + 1) * n)
    err = x @ W.to_local() + b[cols] - y[:, cols]
    gw = 2.0 * x.T @ err / err.numel()
    parts = [torch.empty(n) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, 2.0 * err.sum(0) / err.numel())
    loss = (err * err).sum().reshape(1)
    dist.all_reduce(loss)
    new_w = DArray(W.to_local() - 0.05 * gw, W.spec, W.rank)
    return ({"W": new_w, "b": b - 0.05 * torch.cat(parts)},
            {"count": np.int64(int(opt["count"]) + 1)}, float(loss[0]) / (8 * 32))


def case_resil(root, mode, schedule=None, env=None, seed=7, expect_resume=False, **kw):
    """One rank of tests/multiproc/worker_resilience.py's modes through the
    port's coordinated ``run_resilient`` (``coordinate`` is on by itself:
    two processes).  ``schedule`` arms faultsim with its ``rank=``
    selectors; ``env`` sets knobs in this process first."""
    import torch.distributed as dist

    from vescale_tpu_torch import telemetry
    from vescale_tpu_torch.checkpoint import CheckpointManager
    from vescale_tpu_torch.resilience import (DesyncError, faultsim, parse_schedule,
                                              reset_default_policies, run_resilient)

    me = dist.get_rank()
    for k, v in (env or {}).items():
        os.environ[k] = str(v)
    reset_default_policies()
    if schedule:
        faultsim.arm(parse_schedule(schedule))
    m = mesh([2], ["tp"])
    params, opt = resil_state(m)
    mgr = CheckpointManager(root, keep=3)
    step_fn = resil_step
    if mode == "desync_ulp":
        # rank 1 alone moves one sampled element (the fingerprint samples
        # every 4097th) of the replicated bias by one ulp after step 3: the
        # next check (step 4) must name "params"
        def step_fn(p, o, b, k=None):
            p2, o2, loss = resil_step(p, o, b, k)
            if me == 1 and int(o2["count"]) == 4:
                bias = p2["b"].clone()
                bias[0] = torch.nextafter(bias[0], torch.tensor(float("inf")))
                p2 = {**p2, "b": bias}
            return p2, o2, loss
    telemetry.init(out_dir=None, memtrack=False)
    args = dict(step_fn=step_fn, params=params, opt_state=opt, manager=mgr, batch_fn=resil_batch,
                total_steps=RESIL_TOTAL, save_every=3, async_save=True,
                rng_seed=seed + (1 if mode == "desync_rng" and me == 1 else 0),
                install_signal_handlers=False, barrier_timeout_s=60.0)
    args.update(kw)
    out = {"rank": me}
    try:
        res = run_resilient(**args)
        out.update(status=res.status, step=res.step, restarts=res.restarts,
                   emergency_save_step=res.emergency_save_step,
                   losses={str(k): v for k, v in res.losses.items()},
                   bias=res.params["b"].clone())
    except DesyncError as e:
        out.update(desync=sorted(e.mismatched))
    finally:
        faultsim.disarm()
        for k in (env or {}):
            os.environ.pop(k, None)
        reset_default_policies()
    out.update(latest=mgr.latest_step(), latest_common=mgr.latest_common_step(),
               metas=sorted(d for d in os.listdir(root)
                            if os.path.exists(os.path.join(root, d, "meta.json"))),
               counters=telemetry.get_registry().snapshot()["counters"])
    telemetry.shutdown()
    if expect_resume:
        out["resumed"] = out["counters"].get("resilience_resumes_total", 0)
    return out


def case_resil_barrier_timeout(timeout_s=1.0):
    """Rank 0 times out in a barrier rank 1 enters late; rank 1's late
    entry completes the pending collective, so the world stays usable."""
    import torch.distributed as dist

    from vescale_tpu_torch import telemetry
    from vescale_tpu_torch.distributed import BarrierTimeout, barrier

    if dist.get_rank() == 0:
        telemetry.init(out_dir=None, memtrack=False)
        try:
            barrier("bt_probe", timeout_s=timeout_s)
        except BarrierTimeout as e:
            n = telemetry.get_registry().counter("resilience_barrier_timeouts_total").value
            telemetry.shutdown()
            return {"raised": True, "tag": e.tag, "elapsed": e.elapsed_s, "counted": n}
        telemetry.shutdown()
        return {"raised": False}
    time.sleep(timeout_s * 2.5)
    barrier("bt_probe")
    return {"raised": None}


ELASTIC_TOTAL, ELASTIC_BATCH, ELASTIC_SEQ, ELASTIC_SEED = 10, 8, 16, 11


def elastic_run(root, tok_path, world, rank, mesh_, schedule=None):
    """scripts/elastic_smoke.py's run on the port: a ("dp",)-sharded weight
    and moments updated elementwise, a float64 scalar, and a batch
    statistic summed as integers over the ranks, so the trajectory is
    bitwise the same for any world size; batches from the elastic loader
    (the global batch split over the ranks)."""
    from vescale_tpu_torch.checkpoint import CheckpointManager
    from vescale_tpu_torch.darray import DArray, distribute_tensor
    from vescale_tpu_torch.data import TokenDataLoader
    from vescale_tpu_torch.distributed import allgather_ints
    from vescale_tpu_torch.placements import Shard
    from vescale_tpu_torch.resilience import faultsim, parse_schedule, run_resilient

    def sharded(x):
        return distribute_tensor(torch.from_numpy(x), mesh_, [Shard(0)], rank=rank)

    w0 = (np.arange(64, dtype=np.float32) / 64.0) - 0.5
    z = np.zeros(64, np.float32)
    params = {"w": sharded(w0), "b": np.float64(0.25)}
    opt = {"mu": sharded(z), "nu": sharded(z), "count": np.int64(0)}

    def step_fn(p, o, batch, step_key=None):
        s = int(allgather_ints([int(batch["input"].sum())], tag="elastic_sum").sum())
        g = (float(s % 1000003) / 1000003.0) - 0.5
        gt = torch.tensor(g, dtype=torch.float32)
        w, mu, nu = p["w"].to_local(), o["mu"].to_local(), o["nu"].to_local()
        mu2 = 0.9 * mu + 0.1 * gt * w
        nu2 = 0.99 * nu + 0.01 * gt * gt * w * w
        w2 = w - 0.05 * (gt * w + 0.001 * mu2)
        b2 = np.float64(p["b"]) - np.float64(0.05) * np.float64(g)
        wrap = lambda t, like: DArray(t, like.spec, like.rank)
        return ({"w": wrap(w2, p["w"]), "b": b2},
                {"mu": wrap(mu2, o["mu"]), "nu": wrap(nu2, o["nu"]),
                 "count": np.int64(int(o["count"]) + 1)}, float(b2 * b2) + g)

    if schedule:
        faultsim.arm(parse_schedule(schedule))
    loader = TokenDataLoader(tok_path, ELASTIC_BATCH // world, ELASTIC_SEQ, seed=ELASTIC_SEED,
                             dp_rank=rank, dp_world=world, elastic=True, device="cpu")
    try:
        res = run_resilient(step_fn=step_fn, params=params, opt_state=opt,
                            manager=CheckpointManager(root, keep=4), loader=loader,
                            total_steps=ELASTIC_TOTAL, save_every=3, async_save=False, rng_seed=3,
                            install_signal_handlers=False,
                            barrier_timeout_s=60.0 if world > 1 else None)
    finally:
        faultsim.disarm()
        loader.close()
    return res


def recording_preflight():
    """Patch the checkpoint's elastic preflight to record each verdict's
    codes; returns (the list it fills, a function that undoes the patch)."""
    from vescale_tpu_torch import checkpoint

    codes, real = [], checkpoint.preflight

    def spy(meta, state, path):
        report, elastic = real(meta, state, path)
        codes.extend(report.codes())
        return report, elastic

    checkpoint.preflight = spy
    return codes, lambda: setattr(checkpoint, "preflight", real)


def case_resil_elastic(root, tok_path, schedule=None):
    import torch.distributed as dist

    from vescale_tpu_torch import checkpoint

    codes, undo = recording_preflight()
    try:
        res = elastic_run(root, tok_path, 2, dist.get_rank(), mesh([2], ["dp"]), schedule)
    finally:
        undo()
    return {"status": res.status, "step": res.step,
            "emergency_save_step": res.emergency_save_step,
            "losses": {str(k): v for k, v in res.losses.items()},
            "elastic": checkpoint.LAST_LOAD_STATS["elastic"], "preflight_codes": codes}


# ------------------------------------------------------------ pipeline
PIPE_B, PIPE_T, PIPE_E, PIPE_H = 8, 8, 32, 64  # tests/test_pipeline.py's _ZBBlk fixture
PIPE_VOCAB = 64


def zb_block_params(n, seed):
    """``n`` numpy-seeded parameter trees of the reference's ``_ZBBlk``
    (flax names: LayerNorm_0, Dense_0 (E -> H), Dense_1 (H -> E))."""
    rng = np.random.default_rng(seed)
    E, H = PIPE_E, PIPE_H

    def one():
        return {"LayerNorm_0": {"scale": (1.0 + 0.1 * rng.standard_normal(E)).astype(np.float32),
                                "bias": (0.1 * rng.standard_normal(E)).astype(np.float32)},
                "Dense_0": {"kernel": (rng.standard_normal((E, H)) / np.sqrt(E)).astype(np.float32),
                            "bias": (0.1 * rng.standard_normal(H)).astype(np.float32)},
                "Dense_1": {"kernel": (rng.standard_normal((H, E)) / np.sqrt(H)).astype(np.float32),
                            "bias": (0.1 * rng.standard_normal(E)).astype(np.float32)}}

    return [one() for _ in range(n)]


def zb_block(p, x):
    """``_ZBBlk``: x + Dense_1(tanh(Dense_0(LayerNorm_0(x)))), flax's
    LayerNorm (epsilon 1e-6, Var = max(0, E[x^2] - E[x]^2))."""
    ln = p["LayerNorm_0"]
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    h = (x - mean) * (torch.rsqrt(var + 1e-6) * ln["scale"]) + ln["bias"]
    h = h @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"]
    return x + (torch.tanh(h) @ p["Dense_1"]["kernel"] + p["Dense_1"]["bias"])


def pipe_input(seed):
    return np.random.default_rng(seed).standard_normal((PIPE_B, PIPE_T, PIPE_E)).astype(np.float32)


def pipe_stacked(S, V, seed):
    from vescale_tpu_torch.pipe.spmd import stack_interleaved_params

    groups = [_tree_torch(p) for p in zb_block_params(S * V, seed)]
    return stack_interleaved_params(groups, S)


def _tree_torch(tree):
    return {k: _tree_torch(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in tree.items()}


def case_pipe_blocks(V, M, zb, seed=0):
    """``pipeline_blocks`` (or ``pipeline_blocks_zb``) of ``_ZBBlk`` chunks
    on a ("pp",) mesh of the world: this rank's stacked chunks, the loss
    mean(out^2), its local grads, the input's grad, and (zb) the matmuls
    of the dgrad phase."""
    from vescale_tpu_torch.pipe import spmd
    from vescale_tpu_torch.pipe.graph_split import OpRecorder
    from vescale_tpu_torch.pipe.pipe_stage import flatten_tree

    world = torch.distributed.get_world_size()
    m = mesh([world], ["pp"])
    local = spmd.stage_chunks(pipe_stacked(world, V, seed), m)
    leaves = {k: t.clone().requires_grad_() for k, t in flatten_tree(local).items()}
    from vescale_tpu_torch.pipe.pipe_stage import unflatten_tree

    x = torch.from_numpy(pipe_input(seed + 1)).requires_grad_()
    censuses = []

    def census():
        censuses.append(OpRecorder())
        return censuses[-1]

    if zb:
        out = spmd.pipeline_blocks_zb(zb_block, unflatten_tree(leaves), x, m, num_microbatches=M,
                                      virtual_chunks=V, dgrad_context=census)
    else:
        out = spmd.pipeline_blocks(zb_block, unflatten_tree(leaves), x, m, num_microbatches=M,
                                   virtual_chunks=V)
    loss = (out ** 2).mean()
    loss.backward()
    return {"loss": float(loss.detach()), "out": out.detach(), "dx": x.grad,
            "grads": {k: t.grad for k, t in leaves.items()},
            "dgrad_matmuls": sum(len(c.matmul_shapes()) for c in censuses)}


def case_pipe_embed_head(V, M, zb, seed=0):
    """A replicated embedding and head around the pipeline on every rank:
    tokens -> table lookup -> pipeline -> head -> cross entropy.  Each
    rank's loss and its embedding and head grads."""
    from vescale_tpu_torch.pipe import spmd

    world = torch.distributed.get_world_size()
    m = mesh([world], ["pp"])
    rng = np.random.default_rng(seed + 7)
    table = torch.from_numpy((rng.standard_normal((PIPE_VOCAB, PIPE_E)) * 0.5).astype(
        np.float32)).requires_grad_()
    head = torch.from_numpy((rng.standard_normal((PIPE_E, PIPE_VOCAB)) / np.sqrt(PIPE_E)).astype(
        np.float32)).requires_grad_()
    toks = torch.from_numpy(rng.integers(0, PIPE_VOCAB, (PIPE_B, PIPE_T + 1)))
    local = spmd.stage_chunks(pipe_stacked(world, V, seed), m)
    run = spmd.pipeline_blocks_zb if zb else spmd.pipeline_blocks
    out = run(zb_block, local, table[toks[:, :-1]], m, num_microbatches=M, virtual_chunks=V)
    logits = out @ head
    loss = torch.nn.functional.cross_entropy(logits.reshape(-1, PIPE_VOCAB),
                                             toks[:, 1:].reshape(-1))
    loss.backward()
    return {"loss": float(loss.detach()), "table_grad": table.grad, "head_grad": head.grad}


def case_pipe_engine_refuses():
    """``PipeEngine`` in a live world of more than one rank."""
    from vescale_tpu_torch.models import GPTConfig, gpt_pipeline_units
    from vescale_tpu_torch.models.nanogpt import cross_entropy_loss
    from vescale_tpu_torch.pipe import PipeEngine, construct_pipeline_stage
    from vescale_tpu_torch.plan import PipelineParallelPlan

    cfg = GPTConfig(block_size=8, vocab_size=32, n_layer=2, n_head=2, n_embd=16)
    plan = PipelineParallelPlan(num_stages=2)
    pm = construct_pipeline_stage(gpt_pipeline_units(cfg), plan)
    toks = torch.zeros((2, 9), dtype=torch.long)
    try:
        PipeEngine(pm, plan, cross_entropy_loss).forward_backward(
            pm.init_all(0, device="cpu"), {"input": toks[:, :-1], "target": toks[:, 1:]}, 2)
    except RuntimeError as e:
        return {"refused": "single-controller" in str(e)}
    return {"refused": False}


# ------------------------------------------------------------ MoE (A16)
# tests/test_moe.py's layer (:23) and load-aware loop (:189) configs, and
# tests/test_models.py:26-37's tiny Mixtral (fp32)
MOE_LAYER = dict(num_experts=4, d_model=16, d_ff=32, top_k=2, capacity_factor=8.0)
MOE_LOOP = dict(num_experts=8, d_model=16, d_ff=32, top_k=2, capacity_factor=8.0)
MOE_LOOP_LR = 1e-2
MIXTRAL_TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
                    num_experts_per_tok=2, capacity_factor=4.0)
MOE_BATCH = (4, 8)  # (B, T) of the tiny Mixtral's tokens


def moe_tree(shapes, seed):
    """Numpy-seeded weights over a nested dict of shapes, leaf by leaf in
    its order: norm weights 1 plus noise, biases (``b_in``/``b_out``
    included) noise, embeddings normal, every other leaf normal over
    sqrt(fan_in), fan_in all but the last dim."""
    rng = np.random.default_rng(seed)

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, f"{path}.{k}" if path else k) for k, v in node.items()}
        x = rng.standard_normal(node).astype(np.float32)
        if path.endswith("weight"):
            return (1.0 + 0.1 * x).astype(np.float32)
        if path.endswith(("bias", "b_in", "b_out")):
            return (0.1 * x).astype(np.float32)
        if path.endswith("embedding"):
            return (0.5 * x).astype(np.float32)
        return (x / np.sqrt(np.prod(node[:-1]))).astype(np.float32)

    return build(shapes, "")


def moe_tokens(seed):
    B, T = MOE_BATCH
    return np.random.default_rng(seed + 200).integers(
        0, MIXTRAL_TINY["vocab_size"], (B, T)).astype(np.int64)


def moe_readout(seed):
    """The weights of the scalar sum(logits * w) the EP tests take grads of."""
    B, T = MOE_BATCH
    return make_input((B, T, MIXTRAL_TINY["vocab_size"]), seed + 300)


def moe_mesh_dims(m):
    names = m.mesh_dim_names
    return [i for i, n in enumerate(names) if n == "dp"]


def moe_mixtral(m, seed, plan="plan", sp=False, capacity_factor=None):
    """The tiny Mixtral (numpy-seeded weights, fp32; ``capacity_factor``
    in place of its 4.0) parallelized over mesh ``m`` by ``mixtral_plan``
    (``plan="plan"``) or ``parallelize_experts`` over a replicate-all plan:
    (the module, the DModule)."""
    from vescale_tpu_torch.dmodule import parallelize_module
    from vescale_tpu_torch.models import Mixtral, MixtralConfig, mixtral_plan, param_shapes
    from vescale_tpu_torch.moe import parallelize_experts
    from vescale_tpu_torch.placements import Replicate

    over = {} if capacity_factor is None else {"capacity_factor": capacity_factor}
    cfg = MixtralConfig(**dict(MIXTRAL_TINY, **over), dtype=torch.float32)
    model = Mixtral(cfg, _torch_tree(moe_tree(param_shapes(cfg), seed)), device="cpu")
    if plan == "plan":
        dm = parallelize_module(model, m, mixtral_plan(m, sequence_parallel=sp))
    else:
        dm = parallelize_experts(model, device_mesh=m,
                                 sharding_plan={"parameter": {r".*": [Replicate()] * m.ndim}})
    return model, dm


def case_moe_ep_model(mesh_shape, names, seed=0, api="plan", aux=True, sp=False,
                      capacity_factor=None):
    """The tiny Mixtral (``moe_mixtral``) over this mesh: this rank's rows'
    logits and aux losses, then the grads of sum(logits * w) (+ the
    blocks' aux losses with ``aux``) as this rank's pieces, with their
    placements.  Over a "dp" dim the grads are averaged, as DDP averages
    them, and the readout, a sum over rows, is multiplied by dp on each
    rank, so the average is the gradient of the global readout; each
    rank's aux loss carries dp times its share of the global aux loss's
    gradient itself (``moe.layer``)."""
    from vescale_tpu_torch import collectives as C

    m = mesh(mesh_shape, names)
    model, dm = moe_mixtral(m, seed, api, sp, capacity_factor)
    rows = torch.from_numpy(dp_rows(m, moe_tokens(seed)))
    logits = dm(rows)
    dp = m.size("dp") if "dp" in names else 1
    loss = dp * (logits * torch.from_numpy(dp_rows(m, moe_readout(seed)))).sum()
    auxes = model.router_aux_losses()
    if aux:
        loss = loss + sum(auxes)
    loss.backward()
    dm.finish_grad_sync()
    grads = {}
    for n, p in model.named_parameters():
        g = p.grad
        for i in moe_mesh_dims(m):
            g = C.mesh_all_reduce(g, m, "avg", i)
        grads[n] = g
    return {"logits": logits.detach(), "aux": [float(a) for a in auxes], "grads": grads,
            "placements": {n: [enc(q) for q in s.placements] for n, s in dm._specs.items()},
            "local_experts": [b.block_sparse_moe.local_experts() for b in model.blocks()],
            "expert_tokens": [b.block_sparse_moe.expert_tokens for b in model.blocks()]}


def moe_buffer_params(E, seed):
    return {"w_in": torch.from_numpy(make_input((E, 8, 16), seed)),
            "b_in": torch.from_numpy(make_input((E, 16), seed + 1))}


def case_moe_buffer(mesh_shape, names, units, new_units, tp_dim=None, seed=0):
    """A ``MoEParamBuffer`` of two expert leaves: this rank's pieces, the
    gathered leaves, then the same after ``refresh(new_units)``, and the
    local expert ranges."""
    from vescale_tpu_torch.moe import MoEParamBuffer

    m = mesh(mesh_shape, names)
    params = moe_buffer_params(sum(units), seed)
    buf = MoEParamBuffer(m, "ep", sum(units), units, tp_dim=tp_dim)
    sharded = buf.shard_params(params)
    new_buf, moved = buf.refresh(sharded, new_units)
    me = torch.distributed.get_rank()
    return {"pieces": {k: d.to_local() for k, d in sharded.items()},
            "gathered": buf.gather_params(sharded),
            "moved": {k: d.to_local() for k, d in moved.items()},
            "gathered_moved": new_buf.gather_params(moved),
            "local": list(buf.local_experts(me)), "new_local": list(new_buf.local_experts(me))}


def case_moe_a2a(E, C, d, seed=0):
    """``TokenDispatcher.all_to_all_dispatch`` on a ("ep",) mesh of the
    world: this rank's (E, C, d) block of tests/test_moe.py:165-173's
    buffer in, its expert rows of every rank's blocks out."""
    from vescale_tpu_torch.moe import TokenDispatcher

    world = torch.distributed.get_world_size()
    m = mesh([world], ["ep"])
    full = torch.arange(E * world * C * d, dtype=torch.float32).reshape(E, world * C, d)
    me = torch.distributed.get_rank()
    out = TokenDispatcher(E, C, m).all_to_all_dispatch(full[:, me * C:(me + 1) * C].contiguous())
    return {"local": out.to_local(), "placements": [enc(p) for p in out.placements],
            "shape": list(out.shape)}


def case_moe_optimizer(mesh_shape, names, units, new_units, inner, seed=0):
    """``MoEOptimizer`` over ``inner`` ("sgd": ``torch.optim.SGD(lr=0.1)``;
    "adam": ``AdamWLowmem(1e-2)`` without decay, fp32 moments) on the
    buffer leaves: a step, ``refresh(new_units)``, another step; this
    rank's parameter and moment pieces after each, and the step count."""
    import functools

    from vescale_tpu_torch.moe import MoEOptimizer, MoEParamBuffer
    from vescale_tpu_torch.parallel import AdamWLowmem

    m = mesh(mesh_shape, names)
    E = sum(units)
    buf = MoEParamBuffer(m, "ep", E, units)
    sharded = buf.shard_params(moe_buffer_params(E, seed))
    make = (functools.partial(torch.optim.SGD, lr=0.1) if inner == "sgd" else
            functools.partial(AdamWLowmem, lr=MOE_LOOP_LR, weight_decay=0.0,
                              state_dtype=torch.float32))
    opt = MoEOptimizer(make, buf)
    state = opt.init(sharded)
    out = {}
    for i in range(2):
        grads = buf.shard_params(moe_buffer_params(E, seed + 10 + i))
        sharded, state = opt.step(sharded, state, grads)
        out[f"step{i}"] = {k: d.to_local().clone() for k, d in sharded.items()}
        out[f"state{i}"] = {key: {k: d.to_local().clone() for k, d in tree.items()}
                            for key, tree in state.items() if key != "step"}
        if i == 0:
            buf, sharded, state = opt.refresh(sharded, state, new_units)
            out["refreshed"] = {k: d.to_local().clone() for k, d in sharded.items()}
            out["refreshed_state"] = {key: {k: d.to_local().clone() for k, d in tree.items()}
                                      for key, tree in state.items() if key != "step"}
    out["step_count"] = state["step"]
    return out


def case_moe_loop(params, x, seed=0):
    """tests/test_moe.py:181-240 on a ("ep",) mesh: one ``MoEMLP`` whose
    experts live in a ``MoEParamBuffer`` stepped by ``MoEOptimizer`` and
    whose router by ``AdamWLowmem`` (both Adam at 1e-2: fp32 moments, no
    decay), 6 steps on the loss mean((y - x)^2) + aux, an EMA of
    ``expert_tokens``; run twice, the second time reallocating after step
    2 by ``BasicExpertsAllocator``.  Each run's losses, units, final full
    parameters and this rank's final moment pieces."""
    import functools

    from vescale_tpu_torch.models import load_params
    from vescale_tpu_torch.moe import (BasicExpertsAllocator, MoEConfig, MoEMLP, MoEOptimizer,
                                       MoEParamBuffer)
    from vescale_tpu_torch.parallel import AdamWLowmem

    world = torch.distributed.get_world_size()
    m = mesh([world], ["ep"])
    cfg = MoEConfig(**MOE_LOOP)
    params = {k: torch.from_numpy(v) for k, v in from_wire(params).items()}
    xt = torch.from_numpy(from_wire(x))
    keys = [k for k in params if k != "router"]
    adam = functools.partial(AdamWLowmem, lr=MOE_LOOP_LR, weight_decay=0.0,
                             state_dtype=torch.float32)

    def run(reallocate):
        layer = MoEMLP(cfg, device="cpu")
        load_params(layer, params)
        dense_opt = adam([layer.router])
        buffer = MoEParamBuffer(m, "ep", cfg.num_experts, (2,) * world if world == 4 else
                                (cfg.num_experts // world,) * world)
        moe_opt = MoEOptimizer(adam, buffer)
        sharded = buffer.shard_params({k: params[k] for k in keys})
        state = moe_opt.init(sharded)
        ema = np.zeros(cfg.num_experts)
        losses, units = [], [list(buffer.units)]
        for i in range(6):
            full = moe_opt.buffer.gather_params(sharded)
            with torch.no_grad():
                for k in keys:
                    getattr(layer, k).copy_(full[k])
            layer.zero_grad(set_to_none=True)
            y, aux = layer(xt)
            loss = torch.mean((y - xt) ** 2) + aux
            loss.backward()
            losses.append(float(loss.detach()))
            ema = 0.9 * ema + 0.1 * layer.expert_tokens.numpy()
            grads = moe_opt.buffer.shard_params({k: getattr(layer, k).grad for k in keys})
            sharded, state = moe_opt.step(sharded, state, grads)
            dense_opt.step()
            if reallocate and i == 2:
                new = BasicExpertsAllocator(cfg.num_experts, world).allocate(ema)
                _, sharded, state = moe_opt.refresh(sharded, state, new)
                units.append(list(new))
        return {"losses": losses, "units": units,
                "params": {**moe_opt.buffer.gather_params(sharded),
                           "router": layer.router.detach().clone()},
                "moments": {key: {k: d.full_tensor() for k, d in tree.items()}
                            for key, tree in state.items() if key != "step"},
                "step": state["step"]}

    return {"base": run(False), "re": run(True)}


# ---------------------------------------------- n-D composition (A16, A11)
ND_LR = 3e-4  # examples/mixtral_4d_benchmark/mixtral_train.py:70's adamw(3e-4)


def case_nd_moe_train(mesh_shape, names, seed=0, steps=3, capacity_factor=1.0, sp=False,
                      zero_dims=None, from_state=None, root=None):
    """``make_train_step`` over the tiny Mixtral under ``mixtral_plan`` on
    this mesh (each rank on its "dp" rows), the loss cross entropy (vocab
    parallel over "tp") plus the blocks' aux losses, as
    examples/mixtral_4d_benchmark/mixtral_train.py:70-79 has it:
    ``AdamWLowmem(ND_LR)`` over ``param_dtype_groups`` behind the step's
    default DDP, or with ``zero_dims`` a ``DistributedOptimizer`` over
    ``AdamWLowmem`` (fp32 moments) with those dp dims.  The losses, the
    final pieces and their placements, the first step's routed counts,
    and (ZeRO) every state piece and its placements; with ``from_state``
    the ZeRO run starts from a reference state saved there
    (``zero_state_from_jax``); with ``root`` its state is saved there
    (``checkpoint.save``) and the saved full values returned."""
    import functools

    from vescale_tpu_torch.parallel import (AdamWLowmem, DistributedOptimizer,
                                            param_dtype_groups)
    from vescale_tpu_torch.train import make_train_step

    m = mesh(mesh_shape, names)
    model, dm = moe_mixtral(m, seed, "plan", sp, capacity_factor)
    if zero_dims is None:
        opt = AdamWLowmem(param_dtype_groups(dm.parameters()), ND_LR)
    else:
        opt = DistributedOptimizer(functools.partial(AdamWLowmem, lr=ND_LR,
                                                     state_dtype=torch.float32),
                                   models=dm, dp_dims=tuple(zero_dims))
        if from_state is not None:
            from vescale_tpu_torch.models.convert import zero_state_from_jax

            opt.load_state_tree(zero_state_from_jax(_ref_state_from_npz(from_state),
                                                    opt.state_template()))
    xent = tp_loss(m if "tp" in names else None)
    step = make_train_step(dm, opt, lambda lg, b: xent(lg, b) + sum(model.router_aux_losses()))
    toks = torch.from_numpy(dp_rows(m, dp_tokens("gpt", seed, batch=MOE_BATCH)))
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
    losses, tokens = [], None
    for _ in range(steps):
        losses.append(float(step(batch)))
        if tokens is None:
            tokens = [b.block_sparse_moe.expert_tokens.clone() for b in model.blocks()]
    out = {"losses": losses, "expert_tokens": tokens,
           "final": {n: p.detach().clone() for n, p in dm.named_parameters()},
           "param_placements": {n: [enc(q) for q in sp_.placements]
                                for n, sp_ in dm._specs.items()}}
    if zero_dims is not None:
        out.update(_zero_out(dopt=opt))
    if root is not None:
        from vescale_tpu_torch import checkpoint
        from vescale_tpu_torch.checkpoint.planner import flatten_state
        from vescale_tpu_torch.darray import DArray

        state = {"optimizer": opt.state_tree()}
        checkpoint.save(root, state)
        out["saved"] = {k: (v.full_tensor() if isinstance(v, DArray) else torch.as_tensor(v))
                        for k, v in flatten_state(state)}
    return out


# nanogpt_plan with two kernels sharded over "dp" as well: FSDP by the plan
ND_FSDP_PLAN = {r"h_\d+\.mlp\.c_fc\.kernel": [["S", 0], ["S", 1]],    # P("dp", "tp")
                r"h_\d+\.mlp\.c_proj\.kernel": [["S", 1], ["S", 0]]}  # P("tp", "dp")
ND_FSDP_BATCH = (4, 16)


def nd_fsdp_plan(m):
    from vescale_tpu_torch import placements
    from vescale_tpu_torch.models import nanogpt_plan

    plan = nanogpt_plan(m)
    plan["parameter"].update({k: [dec(e, placements) for e in v] for k, v in ND_FSDP_PLAN.items()})
    return plan


def case_nd_fsdp(mesh_shape, names, seed=0, steps=3, root=None, two_dims=False):
    """The tiny GPT on a ("dp", "tp") mesh under ``nd_fsdp_plan``, or (with
    ``two_dims``) on a ("dpa", "dpb") mesh with no plan and the batch split
    over both: ``make_train_step`` with a ``DistributedOptimizer`` over
    ``AdamWLowmem`` (fp32 moments) over the mesh's dp dims, ``steps``
    steps; the losses, the final pieces, the state pieces and their
    placements, the names the DModule gathers over "dp".  With ``root``
    the optimizer's state and the parameters (``DArray`` pieces under the
    plan's placements) are saved there."""
    import functools

    from vescale_tpu_torch import checkpoint
    from vescale_tpu_torch.darray import DArray
    from vescale_tpu_torch.dmodule import parallelize_module
    from vescale_tpu_torch.parallel import AdamWLowmem, DistributedOptimizer
    from vescale_tpu_torch.train import make_train_step

    m = mesh(mesh_shape, names)
    model = tp_model("gpt", tp_tree("gpt", seed))
    dm = parallelize_module(model, m, {} if two_dims else nd_fsdp_plan(m))
    dopt = DistributedOptimizer(functools.partial(AdamWLowmem, lr=DP_LR,
                                                  state_dtype=torch.float32),
                                models=dm, dp_dims=tuple(names) if two_dims else ("dp",))
    step = make_train_step(dm, dopt, tp_loss(None if two_dims else m))
    toks = dp_tokens("gpt", seed, batch=ND_FSDP_BATCH)
    if two_dims:  # this rank's rows: the batch over the flattened (dpa, dpb)
        b = toks.shape[0] // m.size()
        toks = toks[m.get_rank() * b:(m.get_rank() + 1) * b]
    else:
        toks = dp_rows(m, toks)
    toks = torch.from_numpy(toks)
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
    losses = [float(step(batch)) for _ in range(steps)]
    out = {"losses": losses, "dp_sharded": sorted(dm.dp_sharded),
           "final": {n: p.detach().clone() for n, p in dm.named_parameters()},
           "param_placements": {n: [enc(q) for q in s_.placements]
                                for n, s_ in dm._specs.items()},
           **_zero_out(dopt)}
    if root is not None:
        from vescale_tpu_torch.checkpoint.planner import flatten_state

        rank = m.get_rank()
        state = {"optimizer": dopt.state_tree(),
                 "model": {n: DArray(p.detach(), dm._specs[n], rank)
                           for n, p in dm.named_parameters()}}
        checkpoint.save(root, state)
        out["saved"] = {k: (v.full_tensor() if isinstance(v, DArray) else torch.as_tensor(v))
                        for k, v in flatten_state(state)}
    return out


def case_nd_fsdp_load(root, mesh_shape, names, seed=0):
    """``case_nd_fsdp``'s checkpoint loaded on this mesh under
    ``nd_fsdp_plan``: the optimizer through ``state_template`` and
    ``load_state_tree``, the parameters through ``DArray`` templates of
    the plan's placements; this rank's pieces and their placements, and
    the parameters after the load."""
    import functools

    from vescale_tpu_torch import checkpoint
    from vescale_tpu_torch.darray import DArray
    from vescale_tpu_torch.dmodule import parallelize_module
    from vescale_tpu_torch.parallel import AdamWLowmem, DistributedOptimizer

    m = mesh(mesh_shape, names)
    dm = parallelize_module(tp_model("gpt", tp_tree("gpt", seed + 1)), m, nd_fsdp_plan(m))
    dopt = DistributedOptimizer(functools.partial(AdamWLowmem, lr=DP_LR,
                                                  state_dtype=torch.float32), models=dm)
    rank = m.get_rank()
    got = checkpoint.load(root, {"optimizer": dopt.state_template(),
                                 "model": {n: DArray(None, dm._specs[n], rank)
                                           for n, _ in dm.named_parameters()}})
    dopt.load_state_tree(got["optimizer"])
    locs, pls = _state_locals(got)
    return {"locals": locs, "placements": pls,
            "params": {n: p.detach().clone() for n, p in dm.named_parameters()}}


def case_nd_refusals():
    """What the port refuses on a ("dp", "tp") = (2, 2) mesh, with the
    messages: a parameter sharded over "dp" on the tensor dim "tp" shards
    too, and ``dp_dims`` out of mesh order."""
    import functools

    from vescale_tpu_torch.dmodule import parallelize_module
    from vescale_tpu_torch.parallel import AdamWLowmem, DistributedOptimizer
    from vescale_tpu_torch.placements import Shard

    m = mesh([2, 2], ["dp", "tp"])
    out = {}
    plan = nd_fsdp_plan(m)
    plan["parameter"].update({r"h_\d+\.mlp\.c_fc\.kernel": [Shard(1), Shard(1)]})
    try:
        parallelize_module(tp_model("gpt", tp_tree("gpt", 0)), m, plan)
    except NotImplementedError as e:
        out["same_dim"] = str(e)
    try:
        DistributedOptimizer(functools.partial(AdamWLowmem, lr=DP_LR), m,
                             models={"w": torch.zeros(4, 4)}, dp_dims=("tp", "dp"))
    except ValueError as e:
        out["dp_dims_order"] = str(e)
    return out


# tests/test_5d_compose.py:35-105's model: embedding, two attention-free
# MoE blocks (LayerNorm + routed MLP), head
ND5_MOE = dict(num_experts=4, d_model=32, d_ff=64, top_k=2, capacity_factor=4.0)
ND5_BATCH = (4, 8)
ND5_VOCAB = 64
ND5_LR = 1e-3
ND5_EXPERT = r".*moe\.(w_in|w_out|b_in|b_out)"


class Nd5Block(torch.nn.Module):
    """tests/test_5d_compose.py:24's ``MoEBlock``: x + MoE(LayerNorm(x))."""

    def __init__(self):
        super().__init__()
        from vescale_tpu_torch.models.nanogpt import LayerNorm
        from vescale_tpu_torch.moe import MoEConfig, MoEMLP

        self.ln = LayerNorm(ND5_MOE["d_model"], True, torch.float32)
        self.moe = MoEMLP(MoEConfig(**ND5_MOE))

    def forward(self, x):
        y, _ = self.moe(self.ln(x))
        return x + y


def nd5_params(seed):
    """The numpy-seeded weights: {"emb": {"embedding"}, "head": {"kernel"},
    "blocks": [two block trees]} (``moe_tree``'s rules)."""
    d, E, f = ND5_MOE["d_model"], ND5_MOE["num_experts"], ND5_MOE["d_ff"]
    block = {"ln": {"scale": (d,), "bias": (d,)},
             "moe": {"router": (d, E), "w_in": (E, d, f), "b_in": (E, f),
                     "w_out": (E, f, d), "b_out": (E, d)}}
    shapes = {"emb": {"embedding": (ND5_VOCAB, d)}, "head": {"kernel": (d, ND5_VOCAB)},
              "blocks_0": block, "blocks_1": block}
    tree = moe_tree(shapes, seed)
    for i in range(2):  # LayerNorm scales near one
        tree[f"blocks_{i}"]["ln"]["scale"] = 1.0 + 0.1 * tree[f"blocks_{i}"]["ln"]["scale"]
    return tree


def nd5_tokens(seed):
    B, T = ND5_BATCH
    return np.random.default_rng(seed + 500).integers(0, ND5_VOCAB, (B, T + 1)).astype(np.int64)


def nd5_run(m, seed=0, steps=3, root=None):
    """The 5D model trained ``steps`` steps of AdamW (``ND5_LR``, fp32
    moments): on one rank (``m`` None) the blocks in sequence over the
    whole batch and ``AdamWLowmem``; on a ("pp", "dp", "ep") mesh the
    blocks stacked (``stack_stage_params``) and placed by a plan whose
    experts are Shard(0) over "ep" (``shard_stacked_params``), run by
    ``pipeline_blocks`` (2 microbatches) on this rank's "dp" rows, each
    block's ``MoEMLP`` bound to the mesh by ``place``, and stepped by
    ``zero_sharded(..., dp_dims=("dp",))``.  The dp-mean losses, the
    final full parameters (gathered) and, with ``root``, the saved full
    values (``checkpoint.save`` of the ``DArray`` pieces)."""
    import functools

    from torch.func import functional_call

    from vescale_tpu_torch.darray import DArray
    from vescale_tpu_torch.parallel import AdamWLowmem, zero_sharded
    from vescale_tpu_torch.pipe import spmd
    from vescale_tpu_torch.pipe.pipe_stage import flatten_tree, unflatten_tree
    from vescale_tpu_torch.placements import Replicate, Shard

    tree = _torch_tree(nd5_params(seed))
    toks = nd5_tokens(seed)
    block = Nd5Block()
    adam = functools.partial(AdamWLowmem, lr=ND5_LR, state_dtype=torch.float32)

    def block_fn(p, x):
        return functional_call(block, flatten_tree(p), (x,))

    outer = {"emb.embedding": tree["emb"]["embedding"], "head.kernel": tree["head"]["kernel"]}
    if m is None:
        params = {k: v.clone().requires_grad_() for k, v in outer.items()}
        for i in range(2):
            params.update({f"blocks_{i}.{k}": v.clone().requires_grad_()
                           for k, v in flatten_tree(tree[f"blocks_{i}"]).items()})
        opt = adam(list(params.values()))
        rows = torch.from_numpy(toks)
    else:
        block.moe.place(m)
        stacked = spmd.stack_stage_params([tree["blocks_0"], tree["blocks_1"]])
        R = [Replicate()] * m.ndim
        ep = [Shard(0) if n == "ep" else Replicate() for n in m.mesh_dim_names]
        placed = flatten_tree(spmd.shard_stacked_params(stacked, m, {ND5_EXPERT: ep, r".*": R}))
        rank = m.get_rank()
        specs = {f"blocks.{k}": d.spec for k, d in placed.items()}
        params = {k: v.clone().requires_grad_() for k, v in outer.items()}
        params.update({f"blocks.{k}": d.to_local().clone().requires_grad_()
                       for k, d in placed.items()})
        from vescale_tpu_torch.spec import DArraySpec, TensorMeta

        for k, v in outer.items():
            specs[k] = DArraySpec(m, R, TensorMeta(tuple(v.shape), v.dtype))
        opt = zero_sharded(adam, m, specs, dp_dims=("dp",), models=params)
        rows = torch.from_numpy(dp_rows(m, toks))
    batch = {"input": rows[:, :-1], "target": rows[:, 1:]}

    def loss_fn():
        import torch.nn.functional as F

        x = F.embedding(batch["input"], params["emb.embedding"])
        if m is None:
            for i in range(2):
                x = block_fn(unflatten_tree({k[len(f"blocks_{i}."):]: v for k, v in params.items()
                                             if k.startswith(f"blocks_{i}.")}), x)
        else:
            blocks = unflatten_tree({k[len("blocks."):]: v for k, v in params.items()
                                     if k.startswith("blocks.")})
            x = spmd.pipeline_blocks(block_fn, blocks, x, m, num_microbatches=2)
        logits = x @ params["head.kernel"]
        from vescale_tpu_torch.models import cross_entropy_loss

        return cross_entropy_loss(logits, batch["target"])

    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = loss_fn()
        loss.backward()
        opt.step()
        if m is not None:
            from vescale_tpu_torch import collectives as C

            loss = C.mesh_all_reduce(loss.detach().reshape(1), m, "avg", "dp")[0]
        losses.append(float(loss.detach()))
    if m is None:
        return {"losses": losses, "final": {k: v.detach().clone() for k, v in params.items()}}
    state = {k: DArray(v.detach(), specs[k], rank) for k, v in params.items()}
    final = {k: d.full_tensor() for k, d in state.items()}
    out = {"losses": losses, "final": final}
    if root is not None:
        from vescale_tpu_torch import checkpoint

        checkpoint.save(root, {"model": state})
    return out


def case_nd_5d(root, seed=0, steps=3):
    """``nd5_run`` on a ("pp", "dp", "ep") = (2, 2, 2) mesh of the world,
    saved to ``root``; then the checkpoint loaded onto a ("x",) mesh of
    the world, every leaf Replicate (tests/test_5d_compose.py:95-105)."""
    from vescale_tpu_torch import checkpoint
    from vescale_tpu_torch.darray import DArray
    from vescale_tpu_torch.placements import Replicate
    from vescale_tpu_torch.spec import DArraySpec, TensorMeta

    out = nd5_run(mesh([2, 2, 2], ["pp", "dp", "ep"]), seed, steps, root)
    flat = mesh([torch.distributed.get_world_size()], ["x"])
    rank = flat.get_rank()
    tmpl = {k: DArray(None, DArraySpec(flat, [Replicate()], TensorMeta(tuple(v.shape), v.dtype)),
                      rank) for k, v in out["final"].items()}
    got = checkpoint.load(root, {"model": tmpl})["model"]
    out["loaded"] = {k: d.to_local() for k, d in got.items()}
    return out


def case_ctx_attn(kind, causal, seed, shape, kv_heads=None, names=("sp",)):
    """Ring (``kind="ring"``) or Ulysses attention on this rank's sequence
    piece of (B, T, H, D) q and (B, T, G, D) k/v (``kv_heads`` G, default
    H) drawn from ``seed``; the output piece and the grads of sum(out *
    w), w drawn from seed + 1, as this rank's pieces."""
    from vescale_tpu_torch.parallel import ring_self_attention, ulysses_self_attention

    B, T, H, D = shape
    G = kv_heads or H
    n = torch.distributed.get_world_size()
    m = mesh((n,), names)
    r = m.get_rank()
    rng = np.random.default_rng(seed)
    full = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, H, D), (B, T, G, D), (B, T, G, D))]
    w = np.random.default_rng(seed + 1).standard_normal((B, T, H, D)).astype(np.float32)
    t = T // n
    q, k, v = (torch.from_numpy(np.ascontiguousarray(a[:, r * t:(r + 1) * t])).requires_grad_(True)
               for a in full)
    fn = ring_self_attention if kind == "ring" else ulysses_self_attention
    from vescale_tpu_torch import collectives as C

    C.reset_calls()
    out = fn(q, k, v, m, names[0], causal=causal)
    (out * torch.from_numpy(np.ascontiguousarray(w[:, r * t:(r + 1) * t]))).sum().backward()
    return {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad,
            "calls": {k_: int(c) for k_, c in C.CALLS.items()}}


def case_emu_qcoll(shape, seed, rounding="nearest", key_seed=None):
    """``all_reduce_q`` and ``reduce_scatter_q`` (sum and avg) on this
    rank's operand (``make_input(shape, seed, rank=r)``), for the
    emulator's replay to be held against."""
    from vescale_tpu_torch import collectives as C
    from vescale_tpu_torch import random as R

    n = torch.distributed.get_world_size()
    m = mesh((n,), ("dp",))
    x = torch.from_numpy(make_input(shape, seed, rank=m.get_rank()))
    kw = dict(block=64, rounding=rounding, key=None if key_seed is None else R.key(key_seed))
    return {"ar_sum": C.all_reduce_q(x, m, "sum", 0, **kw),
            "ar_avg": C.all_reduce_q(x, m, "avg", 0, **kw),
            "rs_sum": C.reduce_scatter_q(x, m, "sum", 0, 0, **kw),
            "rs_avg": C.reduce_scatter_q(x, m, "avg", 0, 0, **kw)}


def case_emu_verify(shape, seed, algo="ring"):
    """The emulator's ``verify_all_reduce_against_backend`` on every
    rank's ``make_input(shape, seed, "int", rank=r)`` (exact sums) and on
    normals."""
    from vescale_tpu_torch.emulator import verify_all_reduce_against_backend

    n = torch.distributed.get_world_size()
    m = mesh((n,), ("dp",))
    out = {}
    for kind in ("int", "normal"):
        locals_ = [make_input(shape, seed, kind, rank=r) for r in range(n)]
        out[kind] = list(verify_all_reduce_against_backend(m, locals_, "sum", algo))
    return out


# ------------------------------------------------------------- debug
def case_comm_debug(seed):
    """``CommDebugMode`` around a Shard(0) -> Replicate redistribute, a mesh
    all-reduce and an int8 all-reduce on a ("dp", "tp") mesh: its counts,
    the ``collectives.CALLS`` / ``BYTES`` deltas, ``comm_counts`` of the
    same work and the results."""
    from vescale_tpu_torch import collectives as C
    from vescale_tpu_torch.darray import distribute_tensor
    from vescale_tpu_torch.debug import CommDebugMode, comm_counts

    m = mesh([2, 2], ["dp", "tp"])
    x = torch.from_numpy(make_input((8, 6), seed))

    def work():
        d = distribute_tensor(x, m, _pl([["R"], ["S", 0]]))
        full = d.redistribute(placements=_pl([["R"], ["R"]])).to_local()
        s = C.mesh_all_reduce(full, m, "sum", mesh_dim=0)
        q = C.all_reduce_q(full.contiguous(), m, "sum", 1, block=64, rounding="nearest")
        return full, s, q

    calls0, bytes0 = dict(C.CALLS), dict(C.BYTES)
    with CommDebugMode() as comm:
        full, s, q = work()
    delta = {k: v - calls0.get(k, 0) for k, v in C.CALLS.items() if v - calls0.get(k, 0)}
    bdelta = {k: v - bytes0.get(k, 0) for k, v in C.BYTES.items() if v - bytes0.get(k, 0)}
    traced = CommDebugMode()
    traced.trace(work)
    return {"counts": comm.get_comm_counts(), "total": comm.get_total_counts(),
            "calls": comm.calls, "delta": delta, "bytes": comm.bytes, "bdelta": bdelta,
            "again": comm_counts(work), "traced": traced.get_comm_counts(),
            "full": full, "sum": s, "q": q}


def case_shardcheck_dmodule(kind, tp, seed):
    """shardcheck of a live ``DModule`` (its own plan and mesh, its module
    copied to ``meta`` at the global shapes) and of the plain module under
    the same plan: both reports' codes, and that the DModule still runs."""
    from vescale_tpu_torch.analysis import shardcheck_module
    from vescale_tpu_torch.dmodule import parallelize_module
    from vescale_tpu_torch.models import llama_plan, nanogpt_plan

    m = mesh([tp], ["tp"])
    plan_fn = nanogpt_plan if kind == "gpt" else llama_plan
    dm = parallelize_module(tp_model(kind, tp_tree(kind, seed)), m, plan_fn(m))
    toks = torch.from_numpy(tp_tokens(kind, seed))[:, :-1]
    rep = shardcheck_module(dm, None, None, toks, min_bytes=0)
    plain = shardcheck_module(tp_model(kind, tp_tree(kind, seed)), plan_fn(m), m, toks,
                              min_bytes=0)
    with torch.no_grad():
        logits = dm(toks)
    return {"codes": rep.codes(), "plain_codes": plain.codes(), "n": len(rep.findings),
            "logits_finite": bool(torch.isfinite(logits).all())}


# --------------------------------------------------------- auto-plan
def case_dmp_auto(kind, tp, seed, steps=2, names=("tp",)):
    """``kind`` parallelized twice on a mesh of ``tp`` ranks, by
    ``auto_parallelize_module`` (MEGATRON) and by its hand plan: the
    placements each gives every parameter, the logits, ``steps`` train
    losses of each, and the collectives a ``CommDebugMode`` counted over
    the auto step beside the ``collectives.CALLS`` / ``BYTES`` deltas."""
    from vescale_tpu_torch import collectives as C
    from vescale_tpu_torch.debug import CommDebugMode
    from vescale_tpu_torch.dmodule import parallelize_module
    from vescale_tpu_torch.dmp import auto_parallelize_module
    from vescale_tpu_torch.models import llama_plan, nanogpt_plan
    from vescale_tpu_torch.parallel import AdamWLowmem
    from vescale_tpu_torch.train import make_train_step

    shape = [tp] if len(names) == 1 else [1, tp]
    m = mesh(shape, names)
    toks = torch.from_numpy(tp_tokens(kind, seed))
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
    out = {}
    for label in ("auto", "hand"):
        model = tp_model(kind, tp_tree(kind, seed))
        if label == "auto":
            dm = auto_parallelize_module(model, m)
        else:
            dm = parallelize_module(model, m, (nanogpt_plan if kind == "gpt" else llama_plan)(m))
        out[f"{label}_placements"] = {n: [enc(p) for p in spec.placements]
                                      for n, spec in dm._specs.items()}
        with torch.no_grad():
            out[f"{label}_logits"] = dm(batch["input"])
        step = make_train_step(dm, AdamWLowmem(dm.parameters(), TP_LR, state_dtype=torch.float32),
                               tp_loss(m))
        calls0, bytes0 = dict(C.CALLS), dict(C.BYTES)
        with CommDebugMode() as comm:
            losses = [float(step(batch)) for _ in range(steps)]
        out[f"{label}_losses"] = losses
        if label == "auto":
            out["comm_calls"], out["comm_bytes"] = comm.calls, comm.bytes
            out["calls_delta"] = {k: v - calls0.get(k, 0) for k, v in C.CALLS.items()
                                  if v - calls0.get(k, 0)}
            out["bytes_delta"] = {k: v - bytes0.get(k, 0) for k, v in C.BYTES.items()
                                  if v - bytes0.get(k, 0)}
            out["comm_total"] = comm.get_total_counts()
    return out


# --------------------------------------------- the multi-hop planner
_PLAN_COUNTERS = ("redistribute.fallbacks", "redistribute.plan_hits", "redistribute.plan_misses",
                  "redistribute.hops")


def _set_env(env):
    """Set the planner's knobs for one case (the world strips VESCALE_*)."""
    for k in [k for k in os.environ if k.startswith("VESCALE_")]:
        os.environ.pop(k)
    os.environ.update({k: str(v) for k, v in (env or {}).items()})


def _plan_summary(plan):
    if plan is None:
        return None
    return [{"kind": h.kind, "dst": [enc(p) for p in h.dst.placements],
             "mesh": list(h.dst.mesh.mesh_dim_names), "bytes": h.bytes_moved, "cost": h.cost}
            for h in plan.hops]


def _source(mesh_shape, names, src, shape, seed, kind, partial_locals):
    from vescale_tpu_torch.darray import distribute_tensor, from_local

    m = mesh(mesh_shape, names)
    if partial_locals:
        x = local_operand(mesh_shape, src, shape, seed, kind, m.get_rank())
        return from_local(x, m, _pl(src), shape=tuple(shape))
    return distribute_tensor(make_input(shape, seed, kind), m, _pl(src))


def case_plan(mesh_shape, names, src, dst, shape, seed, kind="normal", partial_locals=False,
              dst_mesh=None, env=None, direct=False, repeats=2):
    """``src -> dst`` through ``redistribute`` (``direct``: through
    ``plan_redistribute(...).execute`` whatever tier the dispatch picks),
    ``repeats`` times, the planner's knobs ``env`` set: the result, the
    counters' deltas, the tier and the plan's hops."""
    from vescale_tpu_torch import redistribute as rd
    from vescale_tpu_torch import redistribute_plan as rp
    from vescale_tpu_torch.spec import DArraySpec
    from vescale_tpu_torch.telemetry.registry import GLOBAL

    _set_env(env)
    try:
        rp.clear_plan_cache()
        rd._warned_pairs.clear()
        d = _source(mesh_shape, names, src, shape, seed, kind, partial_locals)
        target = mesh(*dst_mesh) if dst_mesh else d.mesh
        dspec = DArraySpec(target, _pl(dst), d.spec.meta)
        before = {k: GLOBAL.counter(k) for k in _PLAN_COUNTERS}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            outs = []
            for _ in range(repeats):
                if direct:
                    outs.append(rp.plan_redistribute(d.spec, dspec).execute(d))
                else:
                    outs.append(d.redistribute(target if dst_mesh else None, _pl(dst)))
        counts = {k: GLOBAL.counter(k) - before[k] for k in _PLAN_COUNTERS}
        r = outs[0]
        same = all(torch.equal(o.to_local(), r.to_local()) for o in outs[1:])
        tier = rd.classify_transition(d.spec, dspec)
        plan = rp.plan_redistribute(d.spec, dspec)
        return {"local": r.to_local(), "full": r.full_tensor(), "repeat_equal": same,
                "counts": counts, "tier": tier, "hops": _plan_summary(plan),
                "placements": [enc(p) for p in r.placements],
                "warned": [str(w.message) for w in caught
                           if "redistribute fallback" in str(w.message)],
                "decline": rp.decline_reason(d.spec, dspec)}
    finally:
        _set_env(None)


def case_plan_quant(mesh_shape, names, src, dst, shape, seed, block=64, rounding="nearest",
                    key_seed=None):
    """The int8 transition of ``src -> dst`` (``quant_transition_fn``) on
    this rank's numpy-seeded Partial operand, and the one quantized
    all-reduce it makes, ``all_reduce_q`` with the key the transition
    folds for its op 0; then ``redistribute`` under
    ``VESCALE_REDISTRIBUTE_QUANT=1`` (the overlay) and the plan it took."""
    from vescale_tpu_torch import collectives as C
    from vescale_tpu_torch import redistribute_plan as rp
    from vescale_tpu_torch import transfer
    from vescale_tpu_torch.random import fold_in, key

    d = _source(mesh_shape, names, src, shape, seed, "normal", True)
    dspec = d.spec.with_placements(tuple(_pl(dst)))
    fn = transfer.quant_transition_fn(d.spec, dspec, block, rounding)
    k = None if key_seed is None else key(key_seed)
    out = fn(d, k)
    ref = None
    if len(mesh_shape) == 1 and dst == [["R"]]:
        ref = C.all_reduce_q(d.to_local(), d.mesh, d.placements[0].reduce_op, 0, block=block,
                             rounding=rounding, key=None if k is None else fold_in(k, 0))
    _set_env({"VESCALE_REDISTRIBUTE_QUANT": 1, "VESCALE_GRAD_COMPRESS_BLOCK": block})
    try:
        rp.clear_plan_cache()
        over = d.redistribute(placements=_pl(dst))
        plan = rp.quant_single_hop_plan(d.spec, dspec)
    finally:
        _set_env(None)
        rp.clear_plan_cache()
    return {"local": out.to_local(), "all_reduce_q": ref, "overlay": over.to_local(),
            "overlay_hops": _plan_summary(plan)}


def case_plan_comm(mesh_shape, names, src, dst, shape, seed):
    """``CommDebugMode.attribute_plan(plan, compiled=True)`` on this rank's
    piece: every hop's issued collectives, the region's counts against the
    ``collectives.CALLS`` delta, and the result."""
    from vescale_tpu_torch import collectives as C
    from vescale_tpu_torch import redistribute_plan as rp
    from vescale_tpu_torch.debug import CommDebugMode

    rp.clear_plan_cache()
    d = _source(mesh_shape, names, src, shape, seed, "normal", False)
    plan = rp.plan_redistribute(d.spec, d.spec.with_placements(tuple(_pl(dst))))
    calls0 = dict(C.CALLS)
    with CommDebugMode() as comm:
        summary = comm.attribute_plan(plan, compiled=True, darray=d)
    delta = {k: v - calls0.get(k, 0) for k, v in C.CALLS.items() if v - calls0.get(k, 0)}
    out = summary.pop("output")
    return {"summary": summary, "calls": comm.calls, "delta": delta, "counts": comm.counts,
            "full": out.full_tensor(), "bytes_moved": plan.bytes_moved}


CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items() if name.startswith("case_")}


def main(rank: int, world: int, port: int, join: str) -> None:
    """Join the world through ``distributed.initialize``: by torch's
    ``env://`` variables, which the parent set (``join="env"``), or by its
    arguments (``join="args"``)."""
    import torch.distributed as dist

    from vescale_tpu_torch import distributed as D

    if join == "args":
        D.initialize(f"127.0.0.1:{port}", world, rank, device_type="cpu", timeout_s=60)
    else:
        D.initialize(device_type="cpu", timeout_s=60)
    try:
        for line in sys.stdin:
            if not line.strip():
                continue
            req = json.loads(line)
            try:
                res = CASES[req["case"]](**req.get("args", {}))
                out = "RESULT " + json.dumps(to_wire(res))
            except Exception:  # noqa: BLE001 — the parent test reports it
                out = "ERROR " + json.dumps(traceback.format_exc())
            sys.stdout.write(out + "\n")
            sys.stdout.flush()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------- parent side
class _RankExited(RuntimeError):
    """A rank's process ended before it answered."""


class World:
    """``size`` child ranks of one gloo world, driven request by request.
    ``join="env"`` hands each rank torch's ``env://`` variables, as
    ``torchrun`` does; ``join="args"`` passes the address, size and rank to
    ``initialize`` itself.  The port comes from the gloo rig
    (``vescale_tpu_torch.testing``); a world whose ranks die in their
    transport setup before the first answer is started again once on a
    fresh port."""

    def __init__(self, size: int, timeout_s: float = 120.0, join: str = "env"):
        self.size = size
        self.timeout_s = timeout_s
        self.join = join
        self._transport_retries = 1
        self._answered = False
        self._spawn(reserve_port())

    def _spawn(self, port: int) -> None:
        self._errs = [tempfile.TemporaryFile() for _ in range(self.size)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(self.size), str(port),
             self.join],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self._errs[r],
            env=make_child_env(port, r, self.size, rendezvous=self.join == "env"))
            for r in range(self.size)]
        self._bufs = [b""] * self.size

    def _stderr(self, r: int) -> str:
        self._errs[r].seek(0)
        return self._errs[r].read().decode(errors="replace")[-4000:]

    def _readline(self, r: int, deadline: float) -> str:
        fd = self.procs[r].stdout.fileno()
        while b"\n" not in self._bufs[r]:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"rank {r} gave no answer in {self.timeout_s} s:\n{self._stderr(r)}")
            ready, _, _ = select.select([fd], [], [], left)
            if ready:
                chunk = os.read(fd, 1 << 20)
                if not chunk:
                    raise _RankExited(f"rank {r} exited:\n{self._stderr(r)}")
                self._bufs[r] += chunk
        line, self._bufs[r] = self._bufs[r].split(b"\n", 1)
        return line.decode()

    def run(self, case: str, **args):
        """Every rank's answer to one request, in rank order."""
        try:
            outs = self._request(case, args)
        except _RankExited as e:
            if self._answered or self._transport_retries <= 0 or not is_transport_error(str(e)):
                raise
            self._transport_retries -= 1
            port = reserve_port()
            print(f"[gloo-rig] world of {self.size}: transport setup failed; again on port "
                  f"{port}", file=sys.stderr)
            self.close()
            self._spawn(port)
            outs = self._request(case, args)
        self._answered = True
        errs = [(r, json.loads(o[len("ERROR "):])) for r, o in enumerate(outs) if o.startswith("ERROR ")]
        if errs:
            raise RuntimeError(f"{case} failed on rank {errs[0][0]}:\n{errs[0][1]}")
        return [from_wire(json.loads(o[len("RESULT "):])) for o in outs]

    def _request(self, case: str, args) -> list:
        msg = (json.dumps({"case": case, "args": args}) + "\n").encode()
        for r, p in enumerate(self.procs):
            try:
                p.stdin.write(msg)
                p.stdin.flush()
            except BrokenPipeError:
                p.wait(timeout=30)
                raise _RankExited(f"rank {r} exited:\n{self._stderr(r)}") from None
        deadline = time.monotonic() + self.timeout_s
        return [self._readline(r, deadline) for r in range(self.size)]

    def close(self) -> None:
        for p in self.procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for f in self._errs:
            f.close()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
