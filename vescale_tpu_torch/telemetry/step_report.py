"""Step reports: what one step costs, in one JSON artifact.

The port of ``vescale_tpu/telemetry/step_report.py``.  The reference
lowers and compiles the step and reads XLA's ``cost_analysis`` and
``memory_analysis``; PyTorch compiles nothing, so the port runs the step
once and reads each key from a measurement of that run:

  * ``flops`` and ``bytes_accessed``: the totals of the layer attribution
    (``costaudit.LayerAttribution``: aten ops under a dispatch mode plus
    each hand-written kernel's own ``cost``);
  * ``peak_bytes``: ``torch.cuda.max_memory_allocated`` over the step on
    a card, None on the CPU;
  * ``collectives``: the delta of ``collectives.CALLS`` over the step;
  * ``layer_attribution``: the per-layer roofline table;
  * ``aot_drift``: ``memory_report.compare_with_aot`` when an AOT report
    is given.

``shardcheck`` is the placement analysis of the same step
(``analysis/shardcheck.py``, traced on ``meta``, so nothing runs twice):
a step that carries its model (``make_train_step``'s) is checked as that
model's forward under its plan (a ``DModule``'s own), any other function
as itself; ``donate_argnums`` goes to the donation check (None, the
default, skips it); ``VESCALE_SHARDCHECK=off`` leaves the key None.  Keys
the port cannot provide come back None, the reference's own rule:
``argument_bytes``, ``output_bytes``, ``temp_bytes``, ``alias_bytes`` and
``generated_code_bytes`` (compile-time quantities).  The step runs for
real: a train step updates its parameters and optimizer state.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional

import torch

__all__ = ["build_step_report", "write_step_report", "read_step_report"]

_COMPILE_KEYS = ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
                 "generated_code_bytes")


def _device_of(model, args) -> torch.device:
    if model is not None:
        for p in model.parameters():
            return p.device
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, dict):
            for v in a.values():
                if isinstance(v, torch.Tensor):
                    return v.device
    return torch.device("cpu")


def build_step_report(fn: Callable, *args, name: str = "step", aot_report=None, model=None,
                      donate_argnums=None, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once under a layer attribution and
    distill the run into a JSON-serializable report (see the module
    docstring for its keys).  ``model``: the module whose layers key the
    attribution (default ``fn.model``, which ``train.make_train_step``'s
    step carries).  A failure of the step propagates; a failure of the
    attribution's summary degrades to ``{"error": ...}``."""
    from .. import collectives as C
    from .costaudit import LayerAttribution

    if model is None:
        model = getattr(fn, "model", None)
    dev = _device_of(model, args)
    cuda = dev.type == "cuda"
    report: Dict[str, Any] = {
        "name": name,
        "platform": dev.type,
        "num_devices": torch.cuda.device_count() if cuda else 1,
        "basis": "measured over one run of the step",
    }
    calls0 = dict(C.CALLS)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with LayerAttribution(model) as att:
        fn(*args, **kwargs)
    if cuda:
        torch.cuda.synchronize(dev)
    report["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else None
    report["collectives"] = {k: v - calls0.get(k, 0) for k, v in sorted(C.CALLS.items())
                             if v - calls0.get(k, 0)}
    for key in _COMPILE_KEYS:
        report[key] = None
    try:
        summary = att.summary(device=dev)
        report["flops"] = summary["total_flops"]
        report["bytes_accessed"] = summary["total_bytes"]
        report["layer_attribution"] = summary
    except Exception as e:  # observability degrades, never fails a run
        report["flops"] = report["bytes_accessed"] = None
        report["layer_attribution"] = {"error": repr(e)}
    if aot_report is not None:
        from .memory_report import compare_with_aot

        report["aot_drift"] = compare_with_aot(report, aot_report)
    report["shardcheck"] = _shardcheck(fn, model, args, kwargs, name, donate_argnums)
    return report


def _shardcheck(fn, model, args, kwargs, name, donate_argnums):
    """The ``shardcheck`` section: None while ``VESCALE_SHARDCHECK=off``;
    a failure degrades to ``{"error": ...}``, never fails the report."""
    from .. import analysis

    if not analysis.enabled():
        return None
    try:
        if model is not None:
            batch = args[0] if args else None
            x = batch.get("input") if isinstance(batch, dict) else batch
            rep = analysis.shardcheck_module(model, None, None, x, name=name)
        else:
            rep = analysis.shardcheck(fn, *args, name=name, check_source=False,
                                      donate_argnums=donate_argnums, **kwargs)
        return rep.to_dict()
    except Exception as e:  # observability degrades, never fails a run
        return {"error": repr(e)}


def write_step_report(report: Dict[str, Any], path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=2, default=str)
    return path


def read_step_report(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
