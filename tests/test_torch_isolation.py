"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

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
    assert [m for m in loaded if _forbidden(m)] == []


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
                 "Request", "run_serve", "LLAMA3_8B", "init_params", "params_from_jax"):
        assert hasattr(vescale_tpu_torch, name), name
