"""Cross-rank agreement: the desync error and the row comparison.

The two pieces of ``vescale_tpu/resilience/consistency.py`` the serve
loop's control plane needs; the state fingerprints of training are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

__all__ = ["DesyncError", "compare_rows"]


class DesyncError(RuntimeError):
    """Ranks disagree on state that must be identical.  Carries the whole
    gathered matrix, so the message names which field diverged and every
    rank's value."""

    def __init__(self, mismatched: Dict[str, List[int]], rows: np.ndarray):
        self.mismatched = mismatched
        self.rows = rows
        detail = "; ".join(
            f"{name}: " + ", ".join(f"rank{r}={v}" for r, v in enumerate(vals))
            for name, vals in mismatched.items()
        )
        super().__init__(f"cross-rank desync detected on {sorted(mismatched)} — {detail}")


def compare_rows(rows: np.ndarray, fields: Sequence[str]) -> Dict[str, List[int]]:
    """Field-wise mismatch map of a gathered matrix (one row per rank);
    empty when every rank agrees."""
    rows = np.asarray(rows)
    out: Dict[str, List[int]] = {}
    for i, name in enumerate(fields[: rows.shape[1]]):
        col = rows[:, i]
        if not np.all(col == col[0]):
            out[name] = [int(v) for v in col]
    return out
