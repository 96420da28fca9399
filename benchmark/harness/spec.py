"""A cell as the data files describe it.

``BENCHMARK.json`` names the cell's configuration and traffic; the
configuration's file is the one it lists, the traffic mix is
``benchmark/traffic/<traffic>.json``, the limits of the cell's check
``benchmark/limits/<cell>.json``, and each per-layer metric is read by
``benchmark/metrics/<metric>.py``.  The traffic's ``kind`` names the
module (``benchmark/harness/kinds/<kind>.py``) that serves it, so a new
cell of a known kind is data only.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List

from .env import ROOT

BENCH = ROOT / "benchmark"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _read(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = _read(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in {bench_file.name}: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _read(ROOT / conf["file"])
    traffic = _read(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = _read(BENCH / "limits" / f"{name}.json")

    def mine(m):
        return name in m.get("workloads", [name])

    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


def kind_module(kind: str):
    return importlib.import_module(f"harness.kinds.{kind}")


def metric_reader(name: str) -> Callable[[Dict[str, Any]], Any]:
    """The ``read(ctx)`` of ``benchmark/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
