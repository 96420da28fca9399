"""The control: the plain reference in fp8 put in the program's place
(``reference/precision.py``).  At the cells' own sizes on the card it
fails a number of every cell (``calibrate.py`` reads it on three seeds
or more; the chip tests below read one); at tiny widths on the CPU it
reads above the program on the same seed."""

import pytest
import torch

import calibrate
from harness import spec
from tiny import SERVE_CELLS, TRAIN_CELL, serve_cell, train_cell

SEED = 2 ** 31 + 4242
CPU = torch.device("cpu")


def _by_side(rows):
    return {r["side"]: r for r in rows}


def test_train_control_reads_above_the_program_at_tiny_widths(monkeypatch):
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    got = _by_side(calibrate.train_readings(train_cell(), SEED, True, CPU))
    for key in ("loss_gap", "grad_norm_gap", "change_norm_gap"):
        assert got["control_fp8"][key] > got["program"][key], key
    assert got["fault_half_batch"]["grad_norm_gap"] > 3 * got["program"]["grad_norm_gap"]


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_serve_control_reads_above_the_program_at_tiny_widths(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    got = _by_side(calibrate.serve_readings(serve_cell(name), SEED, 1.5, True, CPU))
    assert got["control_fp8"]["logit_gap"] > got["program"]["logit_gap"]


def _fails(row, limits):
    return any(row[k] > lim for k, lim in limits.items() if k in row)


@pytest.mark.chip
def test_train_control_fails_the_cell_on_the_card(card):
    cell = spec.load_cell(TRAIN_CELL)
    got = _by_side(calibrate.train_readings(cell, SEED, True, card))
    assert not _fails(got["program"], cell.limits)
    assert _fails(got["control_fp8"], cell.limits)
    assert _fails(got["fault_half_batch"], cell.limits)


@pytest.mark.chip
@pytest.mark.parametrize("name", SERVE_CELLS)
def test_serve_control_fails_the_cell_on_the_card(card, name):
    cell = spec.load_cell(name)
    got = _by_side(calibrate.serve_readings(cell, SEED, 15.0, True, card))
    assert not _fails(got["program"], cell.limits)
    assert _fails(got["control_fp8"], cell.limits)
