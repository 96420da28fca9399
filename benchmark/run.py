"""The benchmark of ``vescale_tpu_torch`` on NVIDIA cards: one cell a run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration file and a traffic mix; the mix's
``kind`` names the module under ``benchmark/harness/kinds/`` that sets
the program up from the seed, warms up the cell's shapes, runs the timed
window for ``--seconds`` and checks what it produced against the plain
reference under ``benchmark/reference/``.  With ``--trace 0`` the result
line holds the cell's end-to-end metrics; with ``--trace 1`` a part of
the window runs under ``torch.profiler`` and the line holds the per-layer
metrics, each read by ``benchmark/metrics/<name>.py``.

The last line on standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines on standard error are the same checks.  The run fails,
printing no result, without a CUDA card (or with fewer than the cell
asks for), and when any module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

from harness import env

env.prepare()


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(cell, seed: int, seconds: float, trace: bool, device, kind: str, peak: float):
    """Everything of a run after the look for a card: the cell's run,
    the check for JAX, the verdict and the result line.  Returns (line,
    checks, setup seconds), or (None, ...) when JAX was loaded."""
    from harness import spec

    res = spec.kind_module(cell.kind).run(cell, seed, seconds, trace, device)
    found = env.forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return None, res["checks"], res["setup_s"]
    checks = res["checks"]
    correct = bool(res["correct"]) and all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    ctx = dict(res["ctx"], peak_flops=peak)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        got = dict(res["metrics"], setup_s=res["setup_s"])
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": got[m["name"]], "unit": m["unit"]}
    device_line = {"platform": "gpu", "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device_line}
    tr = ctx.get("trace")
    if trace and tr is not None:
        device_line.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return line, checks, res["setup_s"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import spec, yardstick

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {cell.chips} CUDA card(s), this machine has {n}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(device)
    peak = yardstick.peak_bf16_flops(kind)
    if peak is None:
        print(f"benchmark: no bf16 peak known for {kind!r}", file=sys.stderr)
        return 3
    line, checks, setup_s = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                                     kind, peak)
    if line is None:
        return 4
    print(f"benchmark: card {_power_limit()}; setup_s {setup_s}", file=sys.stderr)
    for name, v, lim in checks:
        print(f"check {name}: {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
