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
import socket
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
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_RENDEZVOUS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


class World:
    """``size`` child ranks of one gloo world, driven request by request.
    ``join="env"`` hands each rank torch's ``env://`` variables, as
    ``torchrun`` does; ``join="args"`` passes the address, size and rank to
    ``initialize`` itself."""

    def __init__(self, size: int, timeout_s: float = 120.0, join: str = "env"):
        self.size = size
        self.timeout_s = timeout_s
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("VESCALE_") and k not in _RENDEZVOUS}
        env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        port = _free_port()
        self._errs = [tempfile.TemporaryFile() for _ in range(size)]
        self.procs = []
        for r in range(size):
            env_r = dict(env)
            if join == "env":
                env_r.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                             WORLD_SIZE=str(size))
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(r), str(size), str(port), join],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self._errs[r], env=env_r))
        self._bufs = [b""] * size

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
                    raise RuntimeError(f"rank {r} exited:\n{self._stderr(r)}")
                self._bufs[r] += chunk
        line, self._bufs[r] = self._bufs[r].split(b"\n", 1)
        return line.decode()

    def run(self, case: str, **args):
        """Every rank's answer to one request, in rank order."""
        msg = (json.dumps({"case": case, "args": args}) + "\n").encode()
        for p in self.procs:
            p.stdin.write(msg)
            p.stdin.flush()
        deadline = time.monotonic() + self.timeout_s
        outs = [self._readline(r, deadline) for r in range(self.size)]
        errs = [(r, json.loads(o[len("ERROR "):])) for r, o in enumerate(outs) if o.startswith("ERROR ")]
        if errs:
            raise RuntimeError(f"{case} failed on rank {errs[0][0]}:\n{errs[0][1]}")
        return [from_wire(json.loads(o[len("RESULT "):])) for o in outs]

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
