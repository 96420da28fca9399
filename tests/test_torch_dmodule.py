"""The port's tensor and sequence parallelism (``parallelize_module`` with
``nanogpt_plan`` and ``llama_plan``) on gloo worlds of 2 and 4 ranks, held
to the JAX reference's ``DModule`` on the same numpy-seeded weights.

Each rank of a world (children of ``tests/torch_spmd_child.py``, spawned
once for this module) parallelizes the port's ``GPT`` (the GPT of
``tests/test_dmodule.py``: 2 layers, 4 heads, width 64, vocab 128) or a
2-layer GQA ``Llama`` (8 heads, 4 kv heads, width 64), SP on and off, on a
("tp",) mesh (or ("dp", "tp") with dp = 1).  The reference runs in this
process on conftest's virtual devices, its plans' shardings applied to the
same weights.  Held, at the tolerances of ``tests/test_dmodule.py``:
every rank's parameter piece exactly the reference's shard (shape and
values); the forward logits within rtol/atol 2e-5 of ``dm.apply``; the
loss and every gradient piece of one step within 5e-5; and three
``AdamWLowmem`` steps within the bound below of the single-process port.
The forward plan's behaviors of ``tests/test_dmodule.py:185-256`` are
checked on a world of 2, and a training step over a ("dp", "tp") mesh of
(2, 2) against the reference's step on the whole batch.
"""

import numpy as np
import pytest
import torch

import jax

from vescale_tpu.dmodule import parallelize_module as ref_parallelize
from vescale_tpu.mesh import DeviceMesh as RefMesh
from vescale_tpu.models import llama as ref_llama
from vescale_tpu.models import nanogpt as ref_nanogpt
from vescale_tpu.models.nanogpt import cross_entropy_loss as ref_xent

from vescale_tpu_torch.dmodule.api import _match
from vescale_tpu_torch.mesh import DeviceMesh
from vescale_tpu_torch.models import llama_plan, nanogpt_plan
from vescale_tpu_torch.parallel import AdamWLowmem
from vescale_tpu_torch.placements import normalize_placements
from vescale_tpu_torch.spec import DArraySpec, TensorMeta
from vescale_tpu_torch.train import make_train_step

import torch_spmd_child as child
from torch_spmd_child import enc

SEED = 0
STEPS = 3
FWD_TOL = 2e-5    # tests/test_dmodule.py::test_forward_matches_single_device
STEP_TOL = 5e-5   # tests/test_dmodule.py::test_nanogpt_e2e_loss_match
# three AdamW steps, the TP port against the single-process port: every
# parameter within 2e-5, except where the gradient is zero in exact
# arithmetic (GPT's key bias: softmax ignores a constant added to every
# key), so each trajectory's gradient there is rounding noise that
# AdamW's normalization lifts to about the learning rate a step
PARAM_TOL = 2e-5
NOISE_TOL = 2 * STEPS * child.TP_LR
# three AdamW steps of the dp x tp port against the reference's own step:
# Adam's normalised update turns the frameworks' last-bit gradient
# differences into visible ones where a gradient is near zero
# (tests/test_torch_train.py)
DP_PARAM_TOL = 1e-4
CASES = [(kind, sp, tp) for kind in ("gpt", "llama") for sp in (True, False) for tp in (2, 4)]


def _id(case):
    kind, sp, tp = case
    return f"{kind}-{'sp' if sp else 'tp_only'}-tp{tp}"


@pytest.fixture(scope="module")
def worlds():
    made = {}

    def get(n):
        if n not in made:
            made[n] = child.World(n)
        return made[n]

    yield get
    for w in made.values():
        w.close()


@pytest.fixture(scope="module")
def port_runs(worlds):
    """Every rank's answer to ``tp_model`` for each case: the worlds of 2
    and 4 work at once (a thread each drives one), while this process
    runs the reference."""
    from concurrent.futures import ThreadPoolExecutor

    def drive(tp):
        w = worlds(tp)
        return {case: w.run("tp_model", kind=case[0], tp=tp, sp=case[1], seed=SEED, steps=STEPS)
                for case in CASES if case[2] == tp}

    pool = ThreadPoolExecutor(2)
    futures = [pool.submit(drive, tp) for tp in (2, 4)]
    pool.shutdown(wait=False)

    class Runs(dict):
        def __missing__(self, case):
            for f in futures:
                self.update(f.result())
            return self[case]

    return Runs()


def _ref_mod(kind):
    return ref_nanogpt if kind == "gpt" else ref_llama


def _pieces(arr, mesh, n, like=None):
    """Every device's shard of a global jax array, in mesh order, cut as
    ``like`` (default: the array itself) is sharded."""
    like = arr if like is None else like
    idx = like.sharding.devices_indices_map(like.shape)
    host = np.asarray(arr)
    return [host[idx[d]] for d in mesh.jax_mesh.devices.reshape(-1)[:n]]


@pytest.fixture(scope="module")
def ref_runs(port_runs):
    """The reference DModule per (kind, tp): its plan's shardings on the
    numpy-seeded weights, the logits, and the loss and gradients of one
    step."""
    out = {}
    for kind in ("gpt", "llama"):
        mod = _ref_mod(kind)
        for tp in (2, 4):
            mesh = RefMesh(("tp",), (tp,), devices=jax.devices()[:tp])
            cfg = child.tp_config(kind, mod)
            model = mod.GPT(cfg) if kind == "gpt" else mod.Llama(cfg)
            plan = (mod.nanogpt_plan if kind == "gpt" else mod.llama_plan)(mesh)
            dm = ref_parallelize(model, mesh, plan)
            variables = {"params": child.tp_tree(kind, SEED)}
            shardings = dm.variables_shardings(jax.eval_shape(lambda: variables))
            variables = jax.device_put(variables, shardings)
            toks = child.tp_tokens(kind, SEED)
            x, y = toks[:, :-1], toks[:, 1:]
            def lf(p):
                logits = dm.apply({"params": p}, x)
                return ref_xent(logits, y), logits

            (loss, logits), grads = jax.value_and_grad(lf, has_aux=True)(variables["params"])
            logits = np.asarray(logits)
            params = dict(_flatten(variables["params"]))
            out[kind, tp] = dict(
                mesh=mesh, logits=logits, loss=float(loss),
                pieces={k: _pieces(v, mesh, tp) for k, v in params.items()},
                # a gradient's piece: the parameter's shard of it
                grads={k: _pieces(v, mesh, tp, params[k]) for k, v in _flatten(grads)},
                shard_shapes={k: v.sharding.shard_shape(v.shape) for k, v in params.items()},
                full_shapes={k: tuple(v.shape) for k, v in params.items()})
    return out


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flatten(v, path)
        else:
            yield path, v


@pytest.fixture(scope="module")
def single_runs():
    """The single-process port: STEPS AdamWLowmem steps on one CPU."""
    out = {}
    for kind in ("gpt", "llama"):
        model = child.tp_model(kind, child.tp_tree(kind, SEED))
        opt = AdamWLowmem(model.parameters(), child.TP_LR, state_dtype=torch.float32)
        step = make_train_step(model, opt, child.tp_loss())
        toks = torch.from_numpy(child.tp_tokens(kind, SEED))
        batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
        losses = [float(step(batch)) for _ in range(STEPS)]
        out[kind] = dict(losses=losses,
                         params={n: p.detach().numpy().copy() for n, p in model.named_parameters()})
    return out


@pytest.mark.parametrize("case", [c for c in CASES if c[1]], ids=_id)
def test_parameter_pieces_are_the_reference_shards(port_runs, ref_runs, case):
    kind, _, tp = case
    ref = ref_runs[kind, tp]
    for r, ans in enumerate(port_runs[case]):
        assert set(ans["pieces"]) == set(ref["pieces"])
        for name, piece in ans["pieces"].items():
            assert tuple(piece.shape) == tuple(ref["shard_shapes"][name]), name
            assert tuple(ans["spec_shapes"][name]) == ref["full_shapes"][name], name
            np.testing.assert_array_equal(piece, ref["pieces"][name][r], err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_forward_logits_match_the_reference(port_runs, ref_runs, case):
    kind, _, tp = case
    want = ref_runs[kind, tp]["logits"]
    for ans in port_runs[case]:
        assert ans["logits"].shape == want.shape
        np.testing.assert_allclose(ans["logits"], want, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_loss_and_gradient_pieces_of_a_step_match_the_reference(port_runs, ref_runs, case):
    kind, _, tp = case
    ref = ref_runs[kind, tp]
    for r, ans in enumerate(port_runs[case]):
        np.testing.assert_allclose(ans["losses"][0], ref["loss"], rtol=STEP_TOL, atol=STEP_TOL)
        for name, g in ans["grads"].items():
            np.testing.assert_allclose(g, ref["grads"][name][r], rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=name)


def _noise_columns(kind, name, shape, tp, r):
    """The columns of a piece whose gradient is rounding noise: GPT's key
    bias, columns [E, 2E) of c_attn's fused bias (Shard(0) over tp)."""
    if kind != "gpt" or not name.endswith("c_attn.bias"):
        return np.zeros(shape, bool)
    E = child.TP_CONFIGS["gpt"]["n_embd"]
    w = shape[0]
    cols = np.arange(r * w, (r + 1) * w)
    return (cols >= E) & (cols < 2 * E)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_three_adamw_steps_match_the_single_process_port(port_runs, single_runs, case):
    kind, _, tp = case
    single = single_runs[kind]
    lay = DeviceMesh(("tp",), (tp,), device_type="cpu")
    plan = (nanogpt_plan if kind == "gpt" else llama_plan)(lay)
    for r, ans in enumerate(port_runs[case]):
        np.testing.assert_allclose(ans["losses"], single["losses"], rtol=STEP_TOL, atol=STEP_TOL)
        for name, got in ans["final"].items():
            full = torch.from_numpy(single["params"][name])
            _, pl = _match(plan["parameter"], name)
            spec = DArraySpec(lay, normalize_placements(pl, 1, full.ndim),
                              TensorMeta(tuple(full.shape), full.dtype))
            want = spec.local_from_full(full, (r,)).numpy()
            diff = np.abs(got - want)
            noise = _noise_columns(kind, name, got.shape, tp, r)
            assert diff[~noise].max(initial=0.0) <= PARAM_TOL, (name, diff.max())
            assert diff[noise].max(initial=0.0) <= NOISE_TOL, (name, diff.max())


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_two_dim_mesh_with_dp_one_matches_the_reference(worlds, ref_runs, kind):
    got = worlds(2).run("tp_model", kind=kind, tp=2, sp=True, seed=SEED, steps=1,
                        names=["dp", "tp"])
    ref = ref_runs[kind, 2]
    for r, ans in enumerate(got):
        np.testing.assert_allclose(ans["logits"], ref["logits"], rtol=FWD_TOL, atol=FWD_TOL)
        for name, g in ans["grads"].items():
            np.testing.assert_allclose(g, ref["grads"][name][r], rtol=STEP_TOL, atol=STEP_TOL)


@pytest.fixture(scope="module")
def behaviors(worlds):
    return worlds(2).run("tp_plan_behaviors", tp=2)


def test_fwd_plan_reshards_kwargs(behaviors):
    """tests/test_dmodule.py::test_fwd_plan_reshards_kwargs: the kwarg got
    the broadcast entry (batch split over the dim) and the result is the
    plain call's times 2."""
    for ans in behaviors:
        assert ans["kwargs_out"].shape == (2, 32)
        np.testing.assert_allclose(ans["kwargs_out"], ans["kwargs_ref"], rtol=1e-6)
        assert ans["kwargs_tag"] == ["S", 0]


def test_fwd_plan_method_scoped(behaviors):
    for ans in behaviors:
        assert ans["method_shape"] == [2, 8, 64]  # Shard(0) of (4, 8, 64)
        assert ans["method_matched"]


def test_plan_warns_on_unmatched_patterns(behaviors):
    for ans in behaviors:
        assert any("parameter plan patterns matched nothing" in w for w in ans["param_warning"])
        assert any("forward plan patterns matched nothing" in w for w in ans["fwd_warning"])


def test_nested_dmodule(behaviors):
    for ans in behaviors:
        assert ans["nested_shape"] == [2, 8] and ans["nested_finite"]


@pytest.mark.parametrize("sp", [True, False])
@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_plans_are_the_references(kind, sp):
    """The port's plans hold the reference's regexes and placements, entry
    for entry, on a ("dp", "tp") mesh."""
    port = (nanogpt_plan if kind == "gpt" else llama_plan)(
        DeviceMesh(("dp", "tp"), (2, 4), device_type="cpu"), sequence_parallel=sp)
    mod = _ref_mod(kind)
    ref = (mod.nanogpt_plan if kind == "gpt" else mod.llama_plan)(
        RefMesh(("dp", "tp"), (2, 4)), sequence_parallel=sp)

    def norm(v):
        if isinstance(v, dict):
            return {k: norm(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)) and v and not hasattr(v[0], "is_shard"):
            return [norm(x) for x in v]
        return [enc(p) for p in v]

    assert list(port["parameter"]) == list(ref["parameter"])
    assert list(port["forward"]) == list(ref["forward"])
    assert norm(port["parameter"]) == norm(ref["parameter"])
    assert norm(port["forward"]) == norm(ref["forward"])


def test_llama_plan_scanned_raises():
    """``scanned=True`` no longer raises (``scan_layers`` is ported): the
    scanned plan is the reference's, regexes and shifted placements."""
    port = llama_plan(DeviceMesh(("dp", "tp"), (2, 4), device_type="cpu"), scanned=True)
    ref = _ref_mod("llama").llama_plan(RefMesh(("dp", "tp"), (2, 4)), scanned=True)

    def norm(v):
        if isinstance(v, dict):
            return {k: norm(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)) and v and not hasattr(v[0], "is_shard"):
            return [norm(x) for x in v]
        return [enc(p) for p in v]

    assert list(port["parameter"]) == list(ref["parameter"])
    assert norm(port["parameter"]) == norm(ref["parameter"])
    assert norm(port["forward"]) == norm(ref["forward"])


def test_data_parallel_training_step_matches_the_reference(worlds):
    """``make_train_step`` on a ("dp", "tp") mesh of (2, 2) (the Llama under
    ``llama_plan`` with sequence parallelism, each dp rank on its own rows
    of a batch of 4, the gradient averaged over "dp" by the default
    ``DistributedDataParallel``) against the reference's step on the whole
    batch: three losses and the first step's gradient pieces within 5e-5,
    the parameter pieces after three AdamW steps within ``DP_PARAM_TOL``."""
    from vescale_tpu.parallel.optimizer import adamw_lowmem
    from vescale_tpu.train import make_train_step as ref_make_train_step

    got = worlds(4).run("tp_dp_step", kind="llama", seed=SEED, steps=STEPS)
    mod = _ref_mod("llama")
    mesh = RefMesh(("dp", "tp"), (2, 2), devices=jax.devices()[:4])
    dm = ref_parallelize(mod.Llama(child.tp_config("llama", mod)), mesh,
                         mod.llama_plan(mesh, sequence_parallel=True))
    variables = {"params": child.tp_tree("llama", SEED)}
    params = jax.device_put(variables, dm.variables_shardings(jax.eval_shape(lambda: variables)))
    params = params["params"]
    toks = child.dp_tokens("llama", SEED)
    batch = {"input": toks[:, :-1], "target": toks[:, 1:]}
    loss_fn = lambda logits, b: ref_xent(logits, b["target"])  # noqa: E731
    grads = jax.grad(lambda p: loss_fn(dm.apply({"params": p}, batch["input"]), batch))(params)
    tx = adamw_lowmem(child.TP_LR, state_dtype=jax.numpy.float32)
    step = ref_make_train_step(dm, tx, loss_fn, donate=False)
    opt, losses = tx.init(params), []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    flat_p, flat_g = dict(_flatten(params)), dict(_flatten(grads))
    for r, ans in enumerate(got):
        np.testing.assert_allclose(ans["losses"], losses, rtol=STEP_TOL, atol=STEP_TOL)
        for name, g in ans["grads"].items():
            want = _pieces(flat_g[name], mesh, 4, flat_p[name])[r]
            np.testing.assert_allclose(g, want, rtol=STEP_TOL, atol=STEP_TOL, err_msg=name)
        for name, p in ans["final"].items():
            want = _pieces(flat_p[name], mesh, 4)[r]
            np.testing.assert_allclose(p, want, rtol=0, atol=DP_PARAM_TOL, err_msg=name)
