"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""

import ast
import json
import os
import pkgutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

import vescale_tpu_torch
from vescale_tpu_torch.models import LlamaConfig, init_params, params_from_jax
from vescale_tpu_torch.serve import KVCacheConfig, PagedKVCache, ServeEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "vescale_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vescale_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([PKG], prefix="vescale_tpu_torch."))


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert "vescale_tpu_torch.serve.engine" in mods and "vescale_tpu_torch.kernels._build" in mods
    assert {"vescale_tpu_torch.serve.prefix_cache", "vescale_tpu_torch.serve.speculative"} <= set(mods)
    assert {"vescale_tpu_torch.distributed", "vescale_tpu_torch.resilience.faultsim",
            "vescale_tpu_torch.resilience.watchdog", "vescale_tpu_torch.resilience.preempt",
            "vescale_tpu_torch.resilience.consistency", "vescale_tpu_torch.serve.fleet",
            "vescale_tpu_torch.serve.obs", "vescale_tpu_torch.telemetry.ops_server"} <= set(mods)
    assert {"vescale_tpu_torch.placements", "vescale_tpu_torch.mesh", "vescale_tpu_torch.devicemesh_api",
            "vescale_tpu_torch.spec", "vescale_tpu_torch.collectives", "vescale_tpu_torch.darray",
            "vescale_tpu_torch.redistribute", "vescale_tpu_torch.api", "vescale_tpu_torch.random",
            "vescale_tpu_torch.initialize.deferred_init", "vescale_tpu_torch.config"} <= set(mods)
    assert {"vescale_tpu_torch.checkpoint", "vescale_tpu_torch.checkpoint.storage",
            "vescale_tpu_torch.checkpoint.native_io", "vescale_tpu_torch.checkpoint.reshard",
            "vescale_tpu_torch.checkpoint.planner", "vescale_tpu_torch.checkpoint.elastic",
            "vescale_tpu_torch.checkpoint.mem_server", "vescale_tpu_torch.checkpoint.manager",
            "vescale_tpu_torch.analysis.findings", "vescale_tpu_torch.resilience.retry"} <= set(mods)
    assert {"vescale_tpu_torch.dmodule", "vescale_tpu_torch.dmodule.api",
            "vescale_tpu_torch.dmodule._comm", "vescale_tpu_torch.model.patch.linear",
            "vescale_tpu_torch.model.patch.vp_embedding",
            "vescale_tpu_torch.model.patch.monkey_patch"} <= set(mods)
    assert {"vescale_tpu_torch.parallel.ddp", "vescale_tpu_torch.parallel.fsdp",
            "vescale_tpu_torch.parallel.optimizer", "vescale_tpu_torch.quant",
            "vescale_tpu_torch.quant.blockscale"} <= set(mods)
    assert {"vescale_tpu_torch.resilience.loop", "vescale_tpu_torch.telemetry.api",
            "vescale_tpu_torch.telemetry.exporters", "vescale_tpu_torch.telemetry.memtrack",
            "vescale_tpu_torch.telemetry.memory_report", "vescale_tpu_torch.telemetry.registry",
            "vescale_tpu_torch.train"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {['vescale_tpu_torch'] + mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "vescale_tpu_torch.serve.loop" in loaded
    assert "vescale_tpu_torch.serve.speculative" in loaded
    assert "vescale_tpu_torch.checkpoint.manager" in loaded
    assert {"vescale_tpu_torch.resilience.loop", "vescale_tpu_torch.telemetry.memtrack"} <= \
        set(loaded)
    assert [m for m in loaded if _forbidden(m) or m == "ml_dtypes"] == []


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_source_of_the_port_names_jax_or_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(PKG):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "build")]
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    bad = {f: m for f in files for m in _imports(f) if _forbidden(m)}
    assert bad == {}


def test_the_resilient_loop_and_telemetry_run_with_jax_blocked(tmp_path):
    """The loop, the consistency fingerprints, the telemetry API, its
    exporters and memtrack import and run with ``jax``, ``ml_dtypes`` and
    the JAX package made unimportable: a tiny CPU Llama through
    ``FunctionalStep`` and ``run_resilient`` with a preemption, telemetry
    on, then the resume."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes', 'vescale_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "from vescale_tpu_torch import telemetry\n"
        "from vescale_tpu_torch.checkpoint import CheckpointManager\n"
        "from vescale_tpu_torch.models import Llama, LlamaConfig, cross_entropy_loss, init_params\n"
        "from vescale_tpu_torch.parallel import AdamWLowmem\n"
        "from vescale_tpu_torch.resilience import consistency, faultsim, parse_schedule, run_resilient\n"
        "from vescale_tpu_torch.train import FunctionalStep, make_train_step\n"
        "cfg = LlamaConfig(vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=1,\n"
        "                  num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=16,\n"
        "                  dtype=torch.float32)\n"
        "def batch(i):\n"
        "    t = torch.from_numpy(np.random.default_rng(i).integers(0, 64, (2, 9)))\n"
        "    return {'input': t[:, :-1], 'target': t[:, 1:]}\n"
        "def run():\n"
        "    model = Llama(cfg, init_params(cfg, 0, device='cpu', dtype=torch.float32), device='cpu')\n"
        "    opt = AdamWLowmem(model.parameters(), 1e-3, state_dtype=torch.float32)\n"
        "    f = FunctionalStep(make_train_step(model, opt, lambda lg, b: cross_entropy_loss(lg, b['target'])), model, opt)\n"
        f"    return run_resilient(step_fn=f, params=f.params, opt_state=f.opt_state, manager=CheckpointManager({str(tmp_path / 'c')!r}),\n"
        "                         total_steps=4, batch_fn=batch, save_every=2, install_signal_handlers=False)\n"
        f"telemetry.init(out_dir={str(tmp_path / 't')!r})\n"
        "faultsim.arm(parse_schedule('preempt:step=3'))\n"
        "assert run().status == 'preempted'\n"
        "faultsim.disarm()\n"
        "res = run()\n"
        "assert res.status == 'completed' and sorted(res.losses) == [3]\n"
        "assert 'resilience:' in telemetry.dashboard()\n"
        "assert consistency.fingerprint(step=1, params=res.params)[6] != 0\n"
        "telemetry.shutdown()\n"
        "print('OK')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("OK"), out.stderr[-3000:]


CHILDREN = ("torch_spmd_child.py", "torch_serve_child.py")


def test_the_child_scripts_of_the_port_tests_import_no_jax():
    """The gloo ranks the port's tests spawn import only torch and the
    port, by their source and by what loading them pulls in."""
    for name in CHILDREN:
        path = os.path.join(REPO, "tests", name)
        assert [m for m in _imports(path) if _forbidden(m)] == [], name
        code = (
            "import importlib.util, json, sys\n"
            f"spec = importlib.util.spec_from_file_location('child', {path!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "import vescale_tpu_torch.initialize, vescale_tpu_torch.redistribute\n"
            "print(json.dumps(sorted(sys.modules)))\n"
        )
        env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
        env["PYTHONPATH"] = REPO
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=120, check=True)
        loaded = json.loads(out.stdout.strip().splitlines()[-1])
        assert [m for m in loaded if _forbidden(m)] == [], name


def test_the_detached_mem_server_imports_no_jax():
    """The checkpoint memory server's detached process (``python -m
    vescale_tpu_torch.checkpoint.mem_server``, what ``start_detached``
    spawns) loads neither JAX, ``ml_dtypes`` nor the JAX package."""
    from vescale_tpu_torch.checkpoint.mem_server import (RemoteMemoryStorage, shutdown_server,
                                                         sock_path)

    name = f"iso_{os.getpid()}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen([sys.executable, "-X", "importtime", "-m",
                                 "vescale_tpu_torch.checkpoint.mem_server", "--name", name],
                                cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=err)
        try:
            deadline = time.monotonic() + 60.0
            while not (os.path.exists(sock_path(name)) and RemoteMemoryStorage(name).ping()):
                assert proc.poll() is None and time.monotonic() < deadline, "mem server never came up"
                time.sleep(0.05)
            shutdown_server(name)
            proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        lines = err.read().splitlines()
    loaded = [ln.rsplit("|", 1)[-1].strip() for ln in lines if ln.startswith("import time:")]
    assert "vescale_tpu_torch.checkpoint.mem_server" in loaded or "vescale_tpu_torch.checkpoint" in loaded
    assert [m for m in loaded if _forbidden(m) or m == "ml_dtypes"] == []


@pytest.fixture
def no_cuda(monkeypatch):
    """The card is absent, whatever this machine has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


TINY = LlamaConfig(vocab_size=32, hidden_size=16, intermediate_size=32, num_hidden_layers=1,
                   num_attention_heads=2, num_key_value_heads=2, dtype=torch.float32)


def _kc():
    return KVCacheConfig(layers=1, kv_heads=2, head_dim=8, num_slots=1, page_size=4, pages_per_slot=2)


def test_default_device_is_the_card_and_raises_without_one(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(_kc())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"w": [1.0]})
    cache = PagedKVCache(_kc(), device="cpu")
    params = init_params(TINY, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(TINY, params, cache)
    eng = ServeEngine(TINY, params, cache, device="cpu")
    assert eng.device.type == "cpu" and cache.k.device.type == "cpu"


def test_the_drafter_runs_where_its_engine_runs(no_cuda):
    from vescale_tpu_torch.serve import PrefixCache, SpeculativeDecoder, slice_drafter_params

    cache = PagedKVCache(_kc(), device="cpu")
    eng = ServeEngine(TINY, init_params(TINY, device="cpu"), cache, device="cpu")
    spec = SpeculativeDecoder(eng, slice_drafter_params(eng.params, 1), drafter_layers=1, k=2)
    assert spec.engine.device.type == "cpu" and spec.cache.k.device.type == "cpu"
    assert PrefixCache(cache).cache is cache


def test_the_gpt_path_runs_on_the_card_by_default(no_cuda, tmp_path):
    from vescale_tpu_torch import bench
    from vescale_tpu_torch.data import TokenDataLoader
    from vescale_tpu_torch.models import GPT, GPTConfig

    tiny = GPTConfig(block_size=8, vocab_size=32, n_layer=1, n_head=1, n_embd=16)
    path = str(tmp_path / "tokens.bin")
    np.arange(100, dtype=np.uint16).tofile(path)
    for make in (lambda: GPT(tiny), lambda: init_params(tiny), lambda: TokenDataLoader(path, 1, 4),
                 lambda: bench.prepare("gpt2")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert GPT(tiny, init_params(tiny, device="cpu"), device="cpu").wte.embedding.device.type == "cpu"
    loader = TokenDataLoader(path, 1, 4, device="cpu")
    assert loader.next()["input"].device.type == "cpu"
    loader.close()


def test_engine_and_cache_must_share_a_device():
    cache = PagedKVCache(_kc(), device="cpu")
    with pytest.raises(ValueError, match="cache lives on"):
        ServeEngine(TINY, init_params(TINY, device="cpu"), cache, device="meta")


def test_package_exports_the_serve_api():
    for name in ("ServeEngine", "PagedKVCache", "KVCacheConfig", "ContinuousBatchingScheduler",
                 "Request", "run_serve", "run_serve_resilient", "serve_replica", "LLAMA3_8B",
                 "init_params", "params_from_jax"):
        assert hasattr(vescale_tpu_torch, name), name
    for name in ("PrefixCache", "PrefixCacheStats", "SpeculativeDecoder", "slice_drafter_params",
                 "ControlChannel", "load_params", "load_drafter_params", "drafter_template"):
        assert hasattr(vescale_tpu_torch.serve, name), name
