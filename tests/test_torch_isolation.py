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
# the JAX package's example programs (``examples/``) too: the port keeps its own
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "safetensors", "vescale_tpu", "examples")


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
    assert {"vescale_tpu_torch.parallel.context", "vescale_tpu_torch.quant.fp8",
            "vescale_tpu_torch.emulator", "vescale_tpu_torch.emulator.core",
            "vescale_tpu_torch.emulator.mesh_collectives", "vescale_tpu_torch.emulator.quantized",
            "vescale_tpu_torch.emulator.tuning", "vescale_tpu_torch.emulator.verify"} <= set(mods)
    assert {"vescale_tpu_torch.parallel.ddp", "vescale_tpu_torch.parallel.fsdp",
            "vescale_tpu_torch.parallel.optimizer", "vescale_tpu_torch.quant",
            "vescale_tpu_torch.quant.blockscale"} <= set(mods)
    assert {"vescale_tpu_torch.resilience.loop", "vescale_tpu_torch.telemetry.api",
            "vescale_tpu_torch.telemetry.exporters", "vescale_tpu_torch.telemetry.memtrack",
            "vescale_tpu_torch.telemetry.memory_report", "vescale_tpu_torch.telemetry.registry",
            "vescale_tpu_torch.train"} <= set(mods)
    assert {"vescale_tpu_torch.ndtimeline", *(f"vescale_tpu_torch.ndtimeline.{m}" for m in (
        "timer", "world_info", "api", "predefined", "handlers", "parser_handler", "streamer")),
        *(f"vescale_tpu_torch.telemetry.{m}" for m in (
            "trace", "straggler", "timeseries", "alerts", "calibrate", "costaudit",
            "step_report")),
        "vescale_tpu_torch.serve.reqtrace"} <= set(mods)
    assert {"vescale_tpu_torch.moe", *(f"vescale_tpu_torch.moe.{m}" for m in (
        "api", "experts_allocator", "layer", "moe_optimizer", "moe_param_buffer",
        "token_dispatcher")), "vescale_tpu_torch.models.mixtral"} <= set(mods)
    assert {"vescale_tpu_torch.transfer", "vescale_tpu_torch.redistribute_plan",
            "vescale_tpu_torch.debug", "vescale_tpu_torch.debug.comm_mode",
            "vescale_tpu_torch.debug.debug_log", "vescale_tpu_torch.debug.pdb",
            "vescale_tpu_torch.dmp", "vescale_tpu_torch.dmp.dmp",
            "vescale_tpu_torch.dmp.policies.registry", "vescale_tpu_torch.dmp.policies.megatron",
            "vescale_tpu_torch.analysis.shardcheck",
            "vescale_tpu_torch.analysis.__main__"} <= set(mods)
    assert {"vescale_tpu_torch.analysis.lint", "vescale_tpu_torch.analysis.envreg",
            "vescale_tpu_torch.testing"} <= set(mods)
    assert {f"vescale_tpu_torch.examples.{m}" for m in (
        "_common", "open_llama_4d_benchmark", "llama_mfu_calculator", "llama2_4d_finetune",
        "nanogpt_4d_finetune", "mixtral_4d_benchmark", "resilient_train", "fp8_train",
        "autosplit_pipeline")} <= set(mods)
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
    assert {"vescale_tpu_torch.ndtimeline.streamer", "vescale_tpu_torch.telemetry.costaudit",
            "vescale_tpu_torch.serve.reqtrace", "vescale_tpu_torch.moe.moe_optimizer",
            "vescale_tpu_torch.models.mixtral"} <= set(loaded)
    assert {"vescale_tpu_torch.redistribute_plan", "vescale_tpu_torch.analysis.shardcheck",
            "vescale_tpu_torch.dmp.policies.megatron"} <= set(loaded)
    assert {"vescale_tpu_torch.analysis.lint", "vescale_tpu_torch.analysis.envreg",
            "vescale_tpu_torch.testing"} <= set(loaded)
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


def test_muon_hf_shards_dropout_and_eval_run_with_jax_and_safetensors_blocked(tmp_path):
    """Muon, ``load_hf_llama`` (a safetensors shard written here by hand in
    the format's layout, and a ``.bin`` shard), the GPT's dropout through
    ``make_train_step(step_key=...)`` and ``make_eval_step`` import and run
    with ``jax``, ``flax``, ``optax``, ``ml_dtypes``, ``safetensors`` and the
    JAX package made unimportable."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes', 'safetensors', 'vescale_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import json, os, torch\n"
        "from vescale_tpu_torch import random\n"
        "from vescale_tpu_torch.models import GPT, GPTConfig, LlamaConfig, load_hf_llama\n"
        "from vescale_tpu_torch.models.nanogpt import cross_entropy_loss\n"
        "from vescale_tpu_torch.parallel import muon\n"
        "from vescale_tpu_torch.train import make_eval_step, make_train_step\n"
        "cfg = LlamaConfig(vocab_size=16, hidden_size=8, intermediate_size=16, num_hidden_layers=1,\n"
        "                  num_attention_heads=2, num_key_value_heads=1, dtype=torch.float32)\n"
        "g = torch.Generator().manual_seed(0)\n"
        "sd = {'model.embed_tokens.weight': torch.randn(16, 8, generator=g),\n"
        "      'model.norm.weight': torch.ones(8), 'lm_head.weight': torch.randn(16, 8, generator=g)}\n"
        "p = 'model.layers.0.'\n"
        "for n, s in (('self_attn.q_proj', (8, 8)), ('self_attn.k_proj', (4, 8)),\n"
        "             ('self_attn.v_proj', (4, 8)), ('self_attn.o_proj', (8, 8)),\n"
        "             ('mlp.gate_proj', (16, 8)), ('mlp.up_proj', (16, 8)), ('mlp.down_proj', (8, 16))):\n"
        "    sd[p + n + '.weight'] = torch.randn(*s, generator=g)\n"
        "for n in ('input_layernorm', 'post_attention_layernorm'):\n"
        "    sd[p + n + '.weight'] = torch.ones(8)\n"
        f"d = {str(tmp_path / 'st')!r}; os.makedirs(d)\n"
        "header, blobs, off = {}, [], 0\n"
        "for k, t in sd.items():\n"
        "    b = t.to(torch.bfloat16).contiguous().view(torch.uint8).numpy().tobytes()\n"
        "    header[k] = {'dtype': 'BF16', 'shape': list(t.shape), 'data_offsets': [off, off + len(b)]}\n"
        "    blobs.append(b); off += len(b)\n"
        "raw = json.dumps(header).encode()\n"
        "open(os.path.join(d, 'model.safetensors'), 'wb').write(len(raw).to_bytes(8, 'little') + raw + b''.join(blobs))\n"
        f"e = {str(tmp_path / 'pt')!r}; os.makedirs(e)\n"
        "torch.save({k: v.to(torch.bfloat16) for k, v in sd.items()}, os.path.join(e, 'pytorch_model.bin'))\n"
        "a, b = load_hf_llama(d, cfg, device='cpu'), load_hf_llama(e, cfg, device='cpu')\n"
        "assert torch.equal(a['layers_0']['mlp']['down_proj']['kernel'], b['layers_0']['mlp']['down_proj']['kernel'])\n"
        "gc = GPTConfig(block_size=16, vocab_size=32, n_layer=1, n_head=2, n_embd=16, dropout=0.2)\n"
        "model = GPT(gc, device='cpu')\n"
        "lf = lambda lg, bt: cross_entropy_loss(lg, bt['target'])\n"
        "step = make_train_step(model, muon(model.named_parameters()), lf)\n"
        "t = torch.randint(0, 32, (2, 9), generator=g)\n"
        "bt = {'input': t[:, :-1], 'target': t[:, 1:]}\n"
        "l0 = float(step(bt, random.key(1)))\n"
        "ev = float(make_eval_step(model, lf)(bt))\n"
        "assert l0 == l0 and ev == ev\n"
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


def test_the_what_if_scorer_prices_the_card_unless_asked(no_cuda):
    from vescale_tpu_torch.telemetry import costaudit

    kw = dict(params_bytes=1e9, activation_bytes=1e8, flops_per_step=1e12)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        costaudit.score_candidates([(1, 2, 1)], **kw)
    assert costaudit.score_candidates([(1, 2, 1)], device="cpu", **kw)[0]["mesh"]["tp"] == 2


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
