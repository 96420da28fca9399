"""``python -m vescale_tpu_torch.analysis``: the analysis CLI.

The port of ``vescale_tpu/analysis/__main__.py``.  Commands (default with
no command: ``lint`` and ``examples``):

  lint [paths...]      vescale-lint over the given paths (default: the
                       ``vescale_tpu_torch`` package and ``chip_smoke.py``)
  examples             audit the models' sharding plans (VSC107) and
                       shardcheck the nanoGPT forward under its plan
                       (traced on ``meta``)
  demo {good,bad}      built-in programs: ``bad`` (a) flattens a
                       tp-sharded activation (VSC101) and (b) asks for a
                       redistribution the planner declines (VSC106 with its
                       VSC12x code); ``good`` is the clean twin
  envdoc [--write P]   print the configuration table generated from the
                       knob registry (``analysis/envreg.py``); write it to
                       ``P`` only with ``--write``
  whatif [...]         re-score candidate (dp, tp, pp) meshes against the
                       audited calibration table (telemetry/costaudit.py)

Flags: ``--strict`` fails (exit 1) on warning-severity findings too;
``--json`` prints machine-readable reports.  Everything here runs on the
CPU: programs are traced on ``meta`` and meshes are layout-only; only
``whatif``'s compute roofline reads the card, unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

from .findings import FindingReport


def cmd_lint(args) -> List[FindingReport]:
    from .lint import default_lint_paths, lint_paths

    return [lint_paths(args.paths or default_lint_paths())]


def cmd_envdoc(args) -> None:
    from .envreg import configuration_markdown

    doc = configuration_markdown()
    if args.write:
        with open(args.write, "w", encoding="utf-8") as f:
            f.write(doc)
        print(f"wrote {args.write}")
    else:
        print(doc)


def cmd_demo(args) -> List[FindingReport]:
    import torch

    from . import SymSharding, check_transition, shardcheck
    from ..mesh import DeviceMesh
    from ..placements import RaggedShard, Shard
    from ..spec import DArraySpec, TensorMeta

    axis_sizes = {"dp": 2, "tp": 4}
    x = torch.empty((1024, 4096), device="meta")
    mesh8 = DeviceMesh(("x",), (8,), device_type="cpu")
    meta = TensorMeta((1 << 20,), torch.float32)
    if args.which == "bad":
        # (a) flattening (B, H) with H tp-sharded merges the sharded dim
        # under the batch dim: every device needs the whole operand
        report = shardcheck(lambda a: a.reshape(1024 * 4096), x,
                            in_specs=[SymSharding.of(None, "tp")], mesh=axis_sizes,
                            name="demo-known-bad", min_bytes=0, check_source=False)
        # (b) skewed ragged -> even Shard: its only bridge is full
        # replication, over the planner's memory budget
        src = DArraySpec(mesh8, (RaggedShard((0,), (1, 2, 1, 2, 1, 3, 3, 3)),), meta)
        dst = DArraySpec(mesh8, (Shard(0),), meta)
        report.extend(check_transition(src, dst, where="demo ragged -> Shard(0)"))
        return [report]
    report = shardcheck(lambda a: (a * 2.0).mean(dim=1), x,
                        in_specs=[SymSharding.of("dp", None)], mesh=axis_sizes,
                        name="demo-known-good", min_bytes=0, check_source=False)
    src = DArraySpec(mesh8, (Shard(0),), meta)
    report.extend(check_transition(src, src, where="demo no-op"))
    return [report]


def cmd_examples(args) -> List[FindingReport]:
    import torch

    from . import check_param_plan, shardcheck_module
    from ..mesh import DeviceMesh
    from ..models import GPT, GPTConfig, llama_plan, nanogpt_plan
    from ..models.mixtral import mixtral_plan

    reports: List[FindingReport] = []
    mesh = DeviceMesh(("dp", "tp"), (2, 4), device_type="cpu")
    for label, plan in (("nanogpt_plan", nanogpt_plan(mesh)),
                        ("nanogpt_plan[sp]", nanogpt_plan(mesh, sequence_parallel=True)),
                        ("llama_plan", llama_plan(mesh)),
                        ("llama_plan[scan]", llama_plan(mesh, scanned=True))):
        reports.append(check_param_plan(plan.get("parameter", {}), mesh, name=label))
    mesh_ep = DeviceMesh(("dp", "ep"), (2, 4), device_type="cpu")
    reports.append(check_param_plan(mixtral_plan(mesh_ep).get("parameter", {}), mesh_ep,
                                    name="mixtral_plan"))
    cfg = GPTConfig(block_size=64, vocab_size=256, n_layer=2, n_head=4, n_embd=64)
    idx = torch.zeros((8, 64), dtype=torch.long)
    reports.append(shardcheck_module(GPT(cfg, device="meta"), nanogpt_plan(mesh), mesh, idx,
                                     name="nanogpt forward under nanogpt_plan"))
    return reports


def cmd_whatif(args) -> int:
    """Candidate (dp, tp, pp) meshes re-scored against the audited table:
    predicted step time and confidence a layout."""
    import torch

    from ..telemetry import costaudit
    from ..telemetry.calibrate import load_table, set_active

    if args.table:
        set_active(load_table(args.table))
    num = args.devices or torch.cuda.device_count()
    if not num:
        raise SystemExit("whatif: no card here; give the world size with --devices")
    cands = costaudit.mesh_candidates(num)
    ranked = costaudit.score_candidates(cands, params_bytes=args.params_bytes,
                                        activation_bytes=args.activation_bytes,
                                        flops_per_step=args.flops, device=args.device)
    if args.top:
        ranked = ranked[: args.top]
    if args.json:
        print(json.dumps({"num_devices": num, "candidates": ranked}, indent=2))
        return 0
    print(f"what-if plan scores over {num} devices ({len(cands)} (dp, tp, pp) layouts):")
    print(f"  {'mesh':>14} {'step_us':>12} {'compute_us':>12} {'comm_us':>10} {'conf':>5}  sources")
    for r in ranked:
        m = r["mesh"]
        srcs = ",".join(sorted({t["source"] for t in r["terms"]})) or "-"
        print(f"  ({m['dp']:>3},{m['tp']:>3},{m['pp']:>3}) {r['predicted_step_us']:>12.1f} "
              f"{r['compute_us']:>12.1f} {r['comm_us']:>10.1f} {r['confidence']:>5.2f}  {srcs}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vescale_tpu_torch.analysis")
    ap.add_argument("--strict", action="store_true", help="fail on warning-severity findings too")
    ap.add_argument("--json", action="store_true", help="JSON reports")
    sub = ap.add_subparsers(dest="cmd")
    p_lint = sub.add_parser("lint", help="vescale-lint over paths")
    p_lint.add_argument("paths", nargs="*", default=None)
    sub.add_parser("examples", help="audit the models' plans, shardcheck nanoGPT")
    p_demo = sub.add_parser("demo", help="built-in shardcheck demo programs")
    p_demo.add_argument("which", choices=("good", "bad"))
    p_env = sub.add_parser("envdoc", help="the configuration table from the knob registry")
    p_env.add_argument("--write", default=None, metavar="PATH")
    p_wi = sub.add_parser("whatif", help="re-score candidate (dp, tp, pp) meshes against the "
                          "audited calibration table")
    p_wi.add_argument("--devices", type=int, default=0,
                      help="world size (default: the cards here)")
    p_wi.add_argument("--params-bytes", type=float, default=1e9)
    p_wi.add_argument("--activation-bytes", type=float, default=1e8)
    p_wi.add_argument("--flops", type=float, default=1e12, help="model FLOPs per step")
    p_wi.add_argument("--table", default=None, metavar="PATH",
                      help="calibration table JSON (default: the active table)")
    p_wi.add_argument("--device", default=None,
                      help='the device whose peak prices compute (default: the card; "cpu")')
    p_wi.add_argument("--top", type=int, default=0, help="print only the best N layouts")
    args = ap.parse_args(argv)
    if args.cmd == "whatif":
        return cmd_whatif(args)
    if args.cmd == "envdoc":
        cmd_envdoc(args)
        return 0
    if args.cmd == "lint":
        reports = cmd_lint(args)
    elif args.cmd == "demo":
        reports = cmd_demo(args)
    elif args.cmd == "examples":
        reports = cmd_examples(args)
    else:
        args.paths = None
        reports = cmd_lint(args) + cmd_examples(args)
    ok = True
    for r in reports:
        print(json.dumps(r.to_dict(), indent=2) if args.json else r.format())
        ok = ok and r.ok(strict=args.strict)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
