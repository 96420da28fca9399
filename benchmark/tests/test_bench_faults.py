"""A run with its timed path broken underneath comes out not correct:
once for each fault these one-card cells can have (a step that leaves its
state unchanged, half of the batch left out of the loss's mean, a token
altered where it is produced; no cell exchanges anything between
cards).  The run is driven on the CPU at tiny widths, everything but the
look for a card."""

import itertools

import numpy as np
import pytest
import torch

import run
from tiny import SERVE_CELLS, serve_cell, train_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 991


def _line(cell):
    line, _, _ = run.run_cell(cell, SEED, 1.5, False, CPU, "cpu (test)", 989e12)
    return line


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    from vescale_tpu_torch.parallel.optimizer import AdamWLowmem

    monkeypatch.setattr(AdamWLowmem, "step", lambda self, closure=None: None)
    line = _line(train_cell())
    assert not line["correct"]
    assert line["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_caught(monkeypatch):
    import vescale_tpu_torch.loss as L

    whole = L.vocab_parallel_cross_entropy

    def half(logits, targets, **kw):  # the mean over the first half of the tokens
        T = logits.shape[1]
        return whole(logits[:, :T // 2], targets[:, :T // 2], **kw)

    monkeypatch.setattr(L, "vocab_parallel_cross_entropy", half)
    line = _line(train_cell())
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_a_token_altered_where_it_is_produced_is_caught(monkeypatch, name):
    from vescale_tpu_torch.serve import ServeEngine

    calls = itertools.count()

    def greedy(row):
        tok = int(np.argmax(row))
        return (tok + 1) % row.shape[-1] if next(calls) % 4 == 3 else tok

    monkeypatch.setattr(ServeEngine, "greedy", staticmethod(greedy))
    line = _line(serve_cell(name))
    assert not line["correct"], line["checks"]
