"""Nothing a run loads is JAX or the JAX package (whole top-level names),
and the plain reference imports nothing of the program."""

import ast
import subprocess
import sys

from harness.env import FORBIDDEN, ROOT

REHEARSAL = r"""
import sys
sys.path.insert(0, "benchmark/tests"); sys.path.insert(0, "benchmark")
from harness import env
env.prepare()
import torch, run
from tiny import SERVE_CELLS, serve_cell, train_cell
for cell in (train_cell(), serve_cell(SERVE_CELLS[0])):
    line, _, _ = run.run_cell(cell, 2**31 + 3, 1.0, False, torch.device("cpu"), "cpu", 989e12)
    assert line is not None
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def test_a_rehearsal_loads_nothing_of_jax():
    p = subprocess.run([sys.executable, "-c", REHEARSAL], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "vescale_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    names = {n.split(".")[0] for f in (ROOT / "benchmark" / "reference").glob("*.py")
             for n in _imports(f)}
    assert names <= {"torch", "math", "typing", "__future__"}, names
    code = ("import sys; sys.path.insert(0, 'benchmark'); import reference.mixtral_train, "
            "reference.llama_forward; print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "vescale_tpu_torch" not in loaded and not loaded & set(FORBIDDEN)


def test_the_harness_names_no_jax_module():
    for f in (ROOT / "benchmark").rglob("*.py"):
        assert not {n.split(".")[0] for n in _imports(f)} & set(FORBIDDEN), f
