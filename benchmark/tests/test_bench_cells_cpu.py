"""Each cell's path at tiny widths on the CPU, against the plain
reference, through everything of a run after the look for a card."""

import json

import pytest
import torch

import run
from tiny import SERVE_CELLS, serve_cell, train_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


def _run(cell, trace=False, seconds=1.5):
    line, checks, setup_s = run.run_cell(cell, SEED, seconds, trace, CPU, "cpu (test)", 989e12)
    json.dumps(line)  # the line is JSON
    return line


def test_train_cell_is_correct_at_tiny_widths():
    cell = train_cell()
    line = _run(cell)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks" and set(line["checks"]) == set(cell.limits)
    assert line["attempted"] > 0 and line["failed"] == 0
    m = line["metrics"]
    assert set(m) == {"train_tokens_per_s", "setup_s"} and m["train_tokens_per_s"]["value"] > 0


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_serve_cell_is_correct_at_tiny_widths(name):
    cell = serve_cell(name)
    line = _run(cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    m = line["metrics"]
    assert set(m) == {e["name"] for e in cell.end_to_end}
    assert {"serve_output_tokens_per_s", "serve_ttft_p95_ms", "setup_s"} <= set(m)
    assert all(v["value"] > 0 for v in m.values())


def test_traced_lines_hold_the_span_metrics():
    # on the CPU no device trace is taken: the trace's metrics stay out
    line = _run(serve_cell(SERVE_CELLS[0]), trace=True)
    got = set(line["metrics"])
    assert {"serve_mfu", "batch_occupancy.serve", "prefill_ms_p50.serve",
            "decode_step_ms_p50.serve", "kv_live_gib.serve"} <= got
    assert not {"flash_fwd_roofline.serve", "device_idle_share.serve"} & got
    line = _run(train_cell(), trace=True)
    assert "train_mfu" in line["metrics"]
