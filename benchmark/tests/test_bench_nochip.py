"""``run.py`` refuses to run without a card, with no fallback to the
CPU, and outside a checkout of the program."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from harness.env import ROOT


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "mistral7b_serve_chat", "--seed", str(2 ** 31 + 5), "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300)


def _no_result(out: str) -> bool:
    for line in out.strip().splitlines()[-1:]:
        try:
            json.loads(line)
            return False
        except ValueError:
            pass
    return True


def test_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run(ROOT)
    assert p.returncode != 0 and _no_result(p.stdout)
    assert "CUDA card" in p.stderr


def test_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and _no_result(p.stdout)
