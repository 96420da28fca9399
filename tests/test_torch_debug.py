"""The port's debugging aids (``vescale_tpu_torch/debug``) held to the
JAX reference's.

Mirrors ``tests/test_aux_subsystems.py``'s comm_debug_mode and
debug_logger tests.  The reference counts collectives in compiled HLO; the
port counts what a run issues, the deltas of ``collectives.CALLS`` and
``BYTES`` (a stated departure: ``debug/comm_mode.py``), so on a gloo world
of 4 (``tests/torch_spmd_child.py``'s ``comm_debug`` case) the counts are
those deltas exactly, in the reference's logical vocabulary with the int8
tag.
"""

import numpy as np

import torch_spmd_child as child

from vescale_tpu_torch.debug import CommDebugMode, DebugLogger, pdb
from vescale_tpu_torch.debug.comm_mode import count_calls


def test_comm_debug_mode():
    w = child.World(4)
    try:
        res = w.run("comm_debug", seed=2)
    finally:
        w.close()
    x = child.make_input((8, 6), 2)
    for got in res:
        assert got["calls"] == got["delta"] and got["bytes"] == got["bdelta"]
        c = got["counts"]
        assert c == count_calls(got["delta"]) == got["again"] == got["traced"]
        # one gather (the redistribute), one all-reduce, one int8 all-reduce
        assert c["all_gather"] == 1 and c["all_reduce"] == 2 and c["all_reduce:int8"] == 1
        assert got["total"] == c["total"] == 3
        np.testing.assert_array_equal(got["full"], x)
        np.testing.assert_array_equal(got["sum"], 2 * x)
        assert np.abs(got["q"] - 2 * x).max() <= 2 * np.abs(x).max() / 127


def test_count_calls_vocabulary():
    """The collectives module's keys in the reference's logical names: the
    int8 ops under their logical op and a tag, host copies ignored, tags
    out of the total (the reference's count_collectives rules)."""
    c = count_calls({"gloo.all_reduce": 2, "nccl.q_psum": 1, "gloo.q_psum_scatter": 1,
                     "gloo.q_all_to_all": 1, "gloo.ppermute": 3, "gloo.ppermute.host_copy": 3,
                     "nccl.all_to_all": 1})
    assert c["all_reduce"] == 3 and c["all_reduce:int8"] == 1
    assert c["reduce_scatter"] == 1 and c["reduce_scatter:int8"] == 1
    assert c["all_to_all"] == 2 and c["all_to_all:int8"] == 1
    assert c["collective_permute"] == 3 and c["total"] == 9


def test_comm_debug_mode_counts_nothing_without_collectives():
    with CommDebugMode() as comm:
        sum(range(10))
    assert comm.get_total_counts() == 0 and comm.get_comm_bytes() == 0


def test_debug_logger(capsys, monkeypatch):
    import sys

    monkeypatch.setenv("VESCALE_DEBUG_MODE", "1")
    DebugLogger.update_vescale_debug_mode_from_env()
    monkeypatch.setattr(DebugLogger, "_stream", sys.stdout)
    DebugLogger.log_communication("all_reduce", "shape=(4,)")
    assert "all_reduce" in capsys.readouterr().out
    monkeypatch.setenv("VESCALE_DEBUG_MODE", "0")
    DebugLogger.update_vescale_debug_mode_from_env()
    DebugLogger.log_operator("matmul")
    assert "matmul" not in capsys.readouterr().out
    monkeypatch.setenv("VESCALE_DEBUG_MODE", "rank1")
    DebugLogger.update_vescale_debug_mode_from_env()
    DebugLogger.log("op", "rank-filtered")
    assert "rank-filtered" not in capsys.readouterr().out  # this process is rank 0
    DebugLogger.update_vescale_debug_mode_from_env()


def test_forked_pdb_breaks_only_on_its_rank(monkeypatch):
    hit = []
    monkeypatch.setattr(pdb.ForkedPdb, "set_trace", lambda self, frame=None: hit.append(frame))
    pdb.set_trace(rank=1, current_rank=0)
    assert hit == []
    pdb.set_trace(rank=1, current_rank=1)
    assert len(hit) == 1
