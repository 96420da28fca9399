"""The port's consistency fingerprints against the JAX package's, on the
CPU: for the same numpy-seeded trees, the ``magic``, ``step``,
``data_cursor``, ``rng_seed``, ``loader``, ``params`` and ``extra`` fields
of ``fingerprint`` are the reference's ints (fp32, bf16 and int32 leaves,
NaN at chosen positions, Python scalars, an all-Replicate DArray's piece
read and a Shard one skipped); ``structure`` is the port's own and is
held to its contract (deterministic, changed by a shape, dtype or
placement).  ``ConsistencyChecker``'s cadence step for step."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

import vescale_tpu as vt
from vescale_tpu.resilience import consistency as ref_cons

from vescale_tpu_torch.darray import distribute_tensor
from vescale_tpu_torch.mesh import DeviceMesh
from vescale_tpu_torch.placements import Replicate, Shard
from vescale_tpu_torch.resilience import consistency as port_cons

SAME = ("magic", "step", "data_cursor", "rng_seed", "loader", "params", "extra")


def _fields(fp):
    return dict(zip(port_cons.FIELDS, (int(v) for v in fp)))


def _np_tree(seed, nan_at=()):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((64, 130)).astype(np.float32)
    for i in nan_at:
        w.reshape(-1)[i] = np.nan
    return {
        "w": w,
        "b16": rng.standard_normal((9000,)).astype(np.float32).astype(ml_dtypes.bfloat16),
        "ids": rng.integers(-1000, 1000, (33, 7)).astype(np.int32),
        "layers": [{"g": rng.standard_normal((5,)).astype(np.float32)}],
        "lr": 0.5,
        "n": 7,
    }


def _ref_tree(t):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else
                [{"g": jnp.asarray(x["g"])} for x in v] if k == "layers" else v)
            for k, v in t.items()}


def _port_tree(t):
    def conv(v):
        if isinstance(v, np.ndarray):
            if v.dtype == ml_dtypes.bfloat16:
                return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
            return torch.from_numpy(v.copy())
        return v

    return {k: ([{"g": conv(x["g"])} for x in v] if k == "layers" else conv(v))
            for k, v in t.items()}


LOADER = {"batches_served": 12, "seed": 3, "dp_rank": 1, "dp_world": 2, "batch": 4,
          "seq_len": 128, "elastic": 1, "global_batch": 8, "samples_served": 96}


@pytest.mark.parametrize("stride", [1, 7, 4097])
@pytest.mark.parametrize("nan_at", [(), (0, 4097, 5000)])
def test_fingerprint_fields_equal_the_reference(stride, nan_at):
    t = _np_tree(0, nan_at)
    opt = {"mu": np.full((3, 3), 0.25, np.float32), "count": 4}
    kw = dict(step=17, data_cursor=19, rng_seed=1234, loader_state=LOADER, extra=5,
              sample_stride=stride)
    ref = _fields(ref_cons.fingerprint(params=_ref_tree(t), opt_state=opt, **kw))
    got = _fields(port_cons.fingerprint(params=_port_tree(t),
                                        opt_state={"mu": torch.full((3, 3), 0.25), "count": 4},
                                        **kw))
    assert {k: got[k] for k in SAME} == {k: ref[k] for k in SAME}
    assert got["magic"] == ref_cons.MAGIC == port_cons.MAGIC


def test_fingerprint_params_see_a_one_ulp_change_and_nan_positions():
    base = port_cons.fingerprint(step=0, params=_port_tree(_np_tree(0)), sample_stride=1)
    t = _port_tree(_np_tree(0))
    t["w"].view(-1)[17] = torch.nextafter(t["w"].view(-1)[17], torch.tensor(np.inf))
    bumped = port_cons.fingerprint(step=0, params=t, sample_stride=1)
    assert port_cons.compare_rows(np.stack([base, bumped])).keys() == {"params"}
    a = port_cons.fingerprint(step=0, params=_port_tree(_np_tree(0, (3,))), sample_stride=1)
    b = port_cons.fingerprint(step=0, params=_port_tree(_np_tree(0, (4,))), sample_stride=1)
    assert a[6] != b[6]  # NaN hashes by position


def test_unseeded_and_empty_fields_equal_the_reference():
    for kw in (dict(step=0), dict(step=3, rng_seed=None, loader_state={}),
               dict(step=1, rng_seed=-5, data_cursor=2)):
        ref = _fields(ref_cons.fingerprint(**kw))
        got = _fields(port_cons.fingerprint(**kw))
        assert got == ref


def test_replicate_darray_is_sampled_and_shard_is_skipped(mesh1d):
    x = np.random.default_rng(1).standard_normal((16, 24)).astype(np.float32)
    y = np.random.default_rng(2).standard_normal((16, 8)).astype(np.float32)
    ref = {"r": vt.distribute_tensor(jnp.asarray(x), mesh1d, [vt.Replicate()]),
           "s": vt.distribute_tensor(jnp.asarray(y), mesh1d, [vt.Shard(0)])}
    mesh = DeviceMesh(("tp",), (8,), device_type="cpu")
    port = {"r": distribute_tensor(torch.from_numpy(x), mesh, [Replicate()], rank=3),
            "s": distribute_tensor(torch.from_numpy(y), mesh, [Shard(0)], rank=3)}
    kw = dict(step=2, sample_stride=5)
    got, want = _fields(port_cons.fingerprint(params=port, **kw)), \
        _fields(ref_cons.fingerprint(params=ref, **kw))
    assert {k: got[k] for k in SAME} == {k: want[k] for k in SAME}
    # the Shard leaf carries no value into the hash: only its replicated sibling
    assert got["params"] == _fields(ref_cons.fingerprint(params={"r": x}, **kw))["params"]
    other = {"r": port["r"], "s": distribute_tensor(torch.from_numpy(y + 1), mesh, [Shard(0)],
                                                    rank=3)}
    assert _fields(port_cons.fingerprint(params=other, **kw))["params"] == got["params"]


def test_structure_is_deterministic_and_sees_layout_changes():
    mesh = DeviceMesh(("tp",), (2,), device_type="cpu")
    t = torch.zeros(4, 6)

    def fp(tree):
        return port_cons.tree_structure_fingerprint(tree)

    base = fp({"a": t, "b": [t[:2]]})
    assert base == fp({"b": [torch.ones(2, 6)], "a": torch.ones(4, 6)})  # values do not count
    assert base != fp({"a": t, "b": [t[:3]]})
    assert base != fp({"a": t.double(), "b": [t[:2]]})
    assert base != fp({"c": t, "b": [t[:2]]})
    r = distribute_tensor(t, mesh, [Replicate()], rank=0)
    s = distribute_tensor(t, mesh, [Shard(0)], rank=0)
    assert fp({"a": r}) != fp({"a": s}) != fp({"a": t})


def test_checker_cadence_step_for_step():
    ref, port = ref_cons.ConsistencyChecker(every=3), port_cons.ConsistencyChecker(every=3)
    state = dict(data_cursor=1, rng_seed=9, loader_state=LOADER)
    for step in range(10):
        assert port.due(step) == ref.due(step) == (step % 3 == 0)
        a = ref.maybe_check(step, params={"w": np.ones(3, np.float32)}, **state)
        b = port.maybe_check(step, params={"w": torch.ones(3)}, **state)
        assert (a is None) == (b is None)
        if a is not None:  # every field but the port's own "structure"
            keep = [i for i, f in enumerate(port_cons.FIELDS) if f in SAME]
            np.testing.assert_array_equal(a[:, keep], b[:, keep])
    assert port.checks == ref.checks == 4
    with pytest.raises(ValueError):
        port_cons.ConsistencyChecker(every=0)


def test_check_raises_desync_on_a_mismatched_row(monkeypatch):
    from vescale_tpu_torch import distributed

    fp = port_cons.fingerprint(step=3)
    other = fp.copy()
    other[1] += 1
    monkeypatch.setattr(distributed, "allgather_ints",
                        lambda v, tag="", timeout_s=None: np.stack([np.asarray(v), other]))
    with pytest.raises(port_cons.DesyncError) as ei:
        port_cons.check(fp)
    assert ei.value.mismatched == {"step": [3, 4]} and "rank1=4" in str(ei.value)
