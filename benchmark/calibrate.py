"""Readings that set a cell's limits, on the card at the cell's size.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --controls 3 \
        [--seconds S] [--first-seed N] [--out FILE]

For a training cell, each seed's program runs its checked steps (no
window) and the plain float32 reference follows them: the cell's numbers
for a sound run (the lower readings).  On the first ``--controls`` seeds
the control, the reference in fp8 (``reference/precision.py``), is put in
the program's place, and so is the fault that leaves half of the batch
out of the loss's mean; both are read against the float32 reference.
A step that leaves its state unchanged reads 1 on ``change_norm_gap`` by
the measure itself and needs no run.

For a serving cell, each seed runs the cell with a window of
``--seconds`` (long enough for the mix's longest request), and on the
first ``--controls`` seeds the control reads, at each position of the same
prompts and served tokens, the reference's gap of the token that fp8
puts first.

Every reading is printed as one JSON line, and all of them are written
to ``--out`` when given.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from harness import env

env.prepare()


def _free():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def train_readings(cell, seed: int, control: bool, device):
    from harness import compare, weights as W
    from harness.kinds import train_steps as D

    c, t = cell.config, cell.traffic
    n = t["checked_steps"]
    rows = D.Rows(c, t, seed, n, device)
    model, opt, step = D.build(c, t, seed, device)
    prog = D.program_checked_steps(model, opt, step, rows, n, W.mixtral_specs(c), seed, device)
    del model, opt, step
    _free()
    ref = D.reference_steps(c, t, seed, rows, n, device)

    def row(side, got):
        worst = {}
        for i, key in ((1, "grad"), (2, "change")):
            gaps = compare.leaf_gaps(got[i], ref[i])
            worst[key + "_worst_leaves"] = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
        return {"seed": seed, "side": side, **D.readings(got, ref), "losses": got[0],
                "ref_losses": ref[0], **worst}

    out = [row("program", prog)]
    if control:
        for side, kw in (("control_fp8", dict(mode="fp8")), ("fault_half_batch", dict(half_batch=True))):
            _free()
            out.append(row(side, D.reference_steps(c, t, seed, rows, n, device, **kw)))
    return out


def serve_readings(cell, seed: int, seconds: float, control: bool, device):
    from harness.kinds import serve_closed_loop as D

    res = D.run(cell, seed, seconds, False, device)
    out = [{"seed": seed, "side": "program", "logit_gap": res["checks"][0][1],
            "attempted": res["attempted"], "failed": res["failed"],
            "served_sample": [len(p[1]) for p in res["ctx"]["sample_pairs"]],
            **res["metrics"], "setup_s": res["setup_s"],
            "memory_peak_bytes": res["memory_peak_bytes"]}]
    if control:
        _free()
        gap = D.reference_gap(cell.config, seed, res["ctx"]["sample_pairs"], device, mode="fp8")
        out.append({"seed": seed, "side": "control_fp8", "logit_gap": gap})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings for a cell's limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    from harness import spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t = time.perf_counter()
        if cell.kind == "train_steps":
            got = train_readings(cell, seed, i < args.controls, device)
        else:
            got = serve_readings(cell, seed, args.seconds, i < args.controls, device)
        _free()
        for r in got:
            r["seconds"] = time.perf_counter() - t
            print(json.dumps(r), flush=True)
        rows += got
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
