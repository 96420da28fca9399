"""The port's coordinated resilient loop across processes: gloo worlds of
two CPU ranks (children of ``tests/torch_spmd_child.py``), the cases of
``tests/test_multihost_resilience.py`` on the state and step of
``tests/multiproc/worker_resilience.py`` (a weight cut by columns over the
ranks, a replicated bias, a numpy count):

  * a commit fault on rank 1 only (``rank=`` selector): the all-rank vote
    fails every save, nothing counts committed anywhere, the run still
    completes in lockstep;
  * a desync (rank 1's RNG seed skewed, and rank 1's replicated bias moved
    by one ulp): ``DesyncError`` on both ranks, naming ``rng_seed`` and
    ``params``, before any step at or after it commits;
  * a preemption on rank 0 only: both ranks agree, emergency-save the same
    step with a two-phase commit and return ``preempted``;
  * a barrier rank 1 enters late: ``BarrierTimeout`` on rank 0, counted;
  * a hang on rank 1: both watchdogs dump and abort with exit code 17;
    the restarted run resumes from the committed step and completes;
  * elastic: a 2-rank run ``resize``d at step 5 and resumed on one
    process, and a one-process run resized and resumed on the two ranks,
    each bitwise the uninterrupted run, through the elastic loader
    (``scripts/elastic_smoke.py``'s 2 -> 1 and 1 -> 2).
"""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_spmd_child import World, elastic_run  # noqa: E402

WATCHDOG_EXIT = 17


@pytest.fixture(scope="module")
def world():
    w = World(2, timeout_s=120.0)
    yield w
    w.close()


def test_commit_fault_on_one_rank_commits_nowhere(world, tmp_path):
    out = world.run("resil", root=str(tmp_path / "c"), mode="commit_fault",
                    schedule="storage_write:call=0,count=100000,rank=1",
                    env={"VESCALE_CKPT_RETRIES": 1, "VESCALE_NATIVE_CKPT_IO": 0})
    for r in out:
        assert r["status"] == "completed" and r["step"] == 7, r
        assert r["latest"] is None and r["latest_common"] is None and r["metas"] == []
        assert r["counters"]["resilience_commit_failures_total"] >= 1
    assert out[0]["losses"] == out[1]["losses"] and len(out[0]["losses"]) == 8
    assert out[1]["counters"]["resilience_faults_injected_total"] >= 1
    assert "resilience_faults_injected_total" not in out[0]["counters"]  # rank=1 only


def test_skewed_rng_seed_raises_desync_on_both_ranks(world, tmp_path):
    out = world.run("resil", root=str(tmp_path / "c"), mode="desync_rng", consistency_every=2,
                    save_every=100)
    for r in out:
        assert r["desync"] == ["rng_seed"] and r["latest"] is None, r
        assert r["counters"]["consistency_mismatches_total"] == 1


def test_one_ulp_in_a_replicated_param_raises_desync_before_a_commit(world, tmp_path):
    out = world.run("resil", root=str(tmp_path / "c"), mode="desync_ulp", consistency_every=2,
                    save_every=3, async_save=False)
    for r in out:
        # the bias moved after step 3; the check at step 4 names it, and the
        # save of step 5 (the first after the change) never ran
        assert r["desync"] == ["params"], r
        assert r["latest"] == 2 and r["metas"] == ["step_0000000002"]


def test_preemption_on_one_rank_is_agreed(world, tmp_path):
    out = world.run("resil", root=str(tmp_path / "c"), mode="preempt_agree",
                    schedule="preempt:step=4,rank=0", save_every=100)
    for r in out:
        assert (r["status"], r["step"], r["emergency_save_step"]) == ("preempted", 3, 3), r
        assert r["latest"] == 3 and r["latest_common"] == 3
    assert out[0]["losses"] == out[1]["losses"]
    np.testing.assert_array_equal(out[0]["bias"], out[1]["bias"])


def _final_state(r):
    """Every leaf of the last checkpoint under ``r``, assembled whole, as
    bytes (the loader's coordinates legitimately differ between worlds)."""
    from vescale_tpu_torch import checkpoint
    from vescale_tpu_torch.checkpoint.planner import flatten_state

    path = os.path.join(r, "step_0000000009")
    arrays = json.load(open(os.path.join(path, "meta.json")))["arrays"]
    state = {"model": {}, "optimizer": {}}
    for k, e in arrays.items():
        top, leaf = k.split("/", 1)
        if top in state:
            state[top][leaf] = np.zeros(e["shape"], e["dtype"])
    return {k: np.asarray(v).tobytes() for k, v in flatten_state(checkpoint.load(path, state))}


@pytest.mark.parametrize("direction", ["2to1", "1to2"])
def test_elastic_resize_two_ranks_resume_on_one_bitwise(world, tmp_path, direction):
    """``scripts/elastic_smoke.py``'s two legs.  2 -> 1: a run on the two
    ranks resized at step 5 (both emergency-save step 4) and resumed on this
    one process.  1 -> 2: a run on this process resized at step 5 and
    resumed on the two ranks.  Either way the restore reshards across
    worlds (VSC130), and steps 5-9's losses and the final parameters and
    moments are bitwise the uninterrupted run's (the run's trajectory does
    not depend on the world size)."""
    from vescale_tpu_torch import checkpoint
    from vescale_tpu_torch.mesh import DeviceMesh
    from torch_spmd_child import recording_preflight

    tok = str(tmp_path / "tok.bin")
    np.random.default_rng(0).integers(0, 50000, 100_000).astype(np.uint16).tofile(tok)
    one = DeviceMesh(("dp",), (1,), device_type="cpu")
    root = str(tmp_path / "e")
    if direction == "2to1":
        golden = world.run("resil_elastic", root=str(tmp_path / "g"), tok_path=tok)
        assert golden[0]["status"] == "completed" and golden[0]["losses"] == golden[1]["losses"]
        want = {int(k): v for k, v in golden[0]["losses"].items()}
        resized = world.run("resil_elastic", root=root, tok_path=tok,
                            schedule="resize:step=5,rank=0")
        for r in resized:
            assert (r["status"], r["step"], r["emergency_save_step"]) == ("resized", 4, 4), r
        codes, undo = recording_preflight()
        try:
            res = elastic_run(root, tok, 1, 0, one)
        finally:
            undo()
        assert res.status == "completed" and res.step == 9
        assert checkpoint.LAST_LOAD_STATS["elastic"] == 1  # the restore resharded 2 -> 1
        resumed = [{int(k): v for k, v in res.losses.items()}]
    else:
        golden = elastic_run(str(tmp_path / "g"), tok, 1, 0, one)
        assert golden.status == "completed" and golden.step == 9
        want = dict(golden.losses)
        resized = elastic_run(root, tok, 1, 0, one, "resize:step=5,rank=0")
        assert (resized.status, resized.step, resized.emergency_save_step) == ("resized", 4, 4)
        out = world.run("resil_elastic", root=root, tok_path=tok)
        for r in out:
            assert (r["status"], r["step"]) == ("completed", 9), r
            assert r["elastic"] == 1  # the restore resharded 1 -> 2
        assert out[0]["preflight_codes"] == out[1]["preflight_codes"]
        codes = out[0]["preflight_codes"]
        resumed = [{int(k): v for k, v in r["losses"].items()} for r in out]
    assert "VSC130" in codes
    for losses in resumed:
        assert sorted(losses) == [5, 6, 7, 8, 9]
        assert [np.float64(losses[s]).tobytes() for s in range(5, 10)] == \
            [np.float64(want[s]).tobytes() for s in range(5, 10)]
    got = _final_state(root)
    assert set(got) == {"model/w", "model/b", "optimizer/mu", "optimizer/nu", "optimizer/count"}
    assert got == _final_state(str(tmp_path / "g"))


def test_barrier_timeout_names_its_tag(world):
    out = world.run("resil_barrier_timeout", timeout_s=1.0)
    assert out[0]["raised"] is True and out[0]["tag"] == "bt_probe"
    assert out[0]["elapsed"] >= 1.0 and out[0]["counted"] == 1


def test_hang_watchdog_abort_then_resume(tmp_path):
    dump = tmp_path / "wd"
    dump.mkdir()
    root = str(tmp_path / "c")
    w = World(2, timeout_s=90.0)
    try:
        with pytest.raises(RuntimeError, match="exited"):
            w.run("resil", root=root, mode="hang", schedule="hang:step=5,rank=1",
                  env={"VESCALE_FAULTSIM_HANG_S": 120, "VESCALE_WATCHDOG_DIR": str(dump)},
                  watchdog_timeout_s=2.0, save_every=3, async_save=False)
        codes = [p.wait(timeout=60) for p in w.procs]
    finally:
        w.close()
    assert codes == [WATCHDOG_EXIT, WATCHDOG_EXIT]
    dumps = sorted(glob.glob(str(dump / "watchdog_hang_rank*.json")))
    assert {os.path.basename(d).split("_step")[0] for d in dumps} == \
        {"watchdog_hang_rank0", "watchdog_hang_rank1"}
    bundle = json.load(open(dumps[0]))
    assert bundle["reason"] == "hang" and bundle["threads"]
    w = World(2, timeout_s=120.0)
    try:
        out = w.run("resil", root=root, mode="train", expect_resume=True)
    finally:
        w.close()
    for r in out:
        assert r["status"] == "completed" and r["restarts"] == 0 and r["resumed"] == 1, r
        assert min(int(k) for k in r["losses"]) == 3  # resumed after the step-2 commit
