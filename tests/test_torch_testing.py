"""The port's gloo rig (``vescale_tpu_torch.testing``) against the JAX
package's, and the shared reset of both packages' observability state
(``tests/torch_reset.py``), on the CPU.

The rig: no port is handed out twice in a process; a world whose process
failed with a transport signature runs again once on a fresh port, and a
failure of any other kind (an assertion error) is never retried; both rigs
treat the reference's cases alike.  Real worlds go through it: two gloo
ranks joined by torch's ``env://`` rendezvous, and one whose first port is
taken, so torch's own transport error is what the rig retries on.

The reset: with the JAX package's ndtimeline left active by an earlier
test of the same process, a reference optimizer step raises; under the
autouse fixtures of ``torch_reset`` it runs.
"""

import os
import socket
import subprocess
import sys

import jax
import pytest

from vescale_tpu import testing as ref_testing

from vescale_tpu_torch import testing
from vescale_tpu_torch.serve import fleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RIGS = (ref_testing, testing)


def test_rig_ports_never_reuse():
    before = len(testing.reserved_ports())
    ports = [testing.reserve_port() for _ in range(16)]
    assert len(set(ports)) == 16
    allp = testing.reserved_ports()
    assert len(allp) == before + 16
    # across every world this process started, no port was handed out twice
    assert len(set(allp)) == len(allp)


def test_the_port_has_one_reserve_port():
    assert fleet.reserve_port is testing.reserve_port
    defs = []
    for root, _, files in os.walk(os.path.join(REPO, "vescale_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    if "def reserve_port(" in fh.read():
                        defs.append(os.path.relpath(os.path.join(root, f), REPO))
    assert defs == [os.path.join("vescale_tpu_torch", "testing.py")]


def _once_failing(marker, failure: str):
    """A child that prints ``failure`` and exits 1 the first time it runs,
    and succeeds after."""
    return (f"import os, sys\nm = {str(marker)!r}\nfirst = not os.path.exists(m)\n"
            f"open(m, 'a').write('x')\nif first:\n    print({failure!r}); sys.exit(1)\n"
            "print('fine')\n")


def _spawner(code, seen):
    def spawn(port):
        seen.append(port)
        return [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)]
    return spawn


@pytest.mark.parametrize("rig", RIGS, ids=["reference", "port"])
def test_rig_transport_retry_is_bounded_and_assertions_surface(tmp_path, rig):
    """The reference's cases: a transport signature is retried once on a
    fresh port; an assertion error is not retried."""
    seen = []
    refused = _once_failing(tmp_path / "t", "Gloo connect: Connection refused")
    results = rig.run_gloo_world(_spawner(refused, seen), timeout=60, transport_retries=1)
    assert [rc for rc, _ in results] == [0]
    assert len(seen) == 2 and seen[0] != seen[1]

    calls = []
    results = rig.run_gloo_world(
        _spawner("print('AssertionError: real bug'); raise SystemExit(1)", calls),
        timeout=60, transport_retries=1)
    assert results[0][0] == 1 and "real bug" in results[0][1] and len(calls) == 1


# torch's and gloo's own transport-setup messages (libtorch's formats)
TORCH_TRANSPORT = [
    "torch.distributed.DistNetworkError: The server socket has failed to listen on any local "
    "network address. port: 29500, useIpv6: false, code: -98, name: EADDRINUSE, message: "
    "address already in use",
    "torch.distributed.DistStoreError: Timed out after 61 seconds waiting for clients. 1/2 "
    "clients joined.",
    "torch.distributed.DistNetworkError: The client socket has timed out after 60000ms while "
    "trying to connect to (127.0.0.1, 29500).",
    "RuntimeError: Gloo connectFullMesh failed with [../third_party/gloo/gloo/transport/tcp/"
    "pair.cc:144] no error",
    "[W socket.cpp:755] [c10d] The client socket has failed to connect to [localhost]:29500 "
    "(errno: 111 - Connection refused).",
]


@pytest.mark.parametrize("failure", TORCH_TRANSPORT, ids=range(len(TORCH_TRANSPORT)))
def test_torch_transport_signatures_are_retried_once(tmp_path, failure):
    assert testing.is_transport_error(failure)
    seen, retried = [], []
    results = testing.run_gloo_world(_spawner(_once_failing(tmp_path / "t", failure), seen),
                                     timeout=60, on_retry=lambda: retried.append(1))
    assert [rc for rc, _ in results] == [0] and len(seen) == 2 and retried == [1]


def test_retries_run_out_and_other_failures_do_not_match(tmp_path):
    seen = []
    results = testing.run_gloo_world(
        _spawner("print('Connection refused'); raise SystemExit(1)", seen), timeout=60,
        transport_retries=1)
    assert results[0][0] == 1 and len(seen) == 2
    for text in ("AssertionError: 3 != 4", "RuntimeError: rank 1 diverged",
                 "TimeoutError: rank 0 gave no answer in 120 s", "ValueError: bad shape"):
        assert not testing.is_transport_error(text)


def test_a_hang_is_killed_and_raised():
    procs = []

    def spawn(port):
        procs.extend([subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True) for _ in range(2)])
        return procs

    with pytest.raises(subprocess.TimeoutExpired):
        testing.run_gloo_world(spawn, timeout=1)
    assert all(p.poll() is not None for p in procs)


def test_child_env(monkeypatch):
    monkeypatch.setenv("VESCALE_FAULTSIM", "oom:step=1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("KEEP_ME", "1")
    env = testing.make_child_env(4321, 1, 4)
    assert {k: env[k] for k in testing.RENDEZVOUS_VARS} == {
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "4321", "RANK": "1", "WORLD_SIZE": "4",
        "LOCAL_RANK": "1"}
    assert "VESCALE_FAULTSIM" not in env
    assert env["KEEP_ME"] == "1" and env["PYTHONPATH"] == REPO
    assert env["OMP_NUM_THREADS"] == env["MKL_NUM_THREADS"] == "1"
    env = testing.make_child_env(4321, 0, 2, rendezvous=False)
    assert not set(testing.RENDEZVOUS_VARS) & set(env) and "VESCALE_FAULTSIM" not in env


_RANK = """
import torch, torch.distributed as dist
dist.init_process_group("gloo", init_method="env://", timeout=__import__("datetime").timedelta(seconds=30))
t = torch.tensor([float(dist.get_rank() + 1)])
dist.all_reduce(t)
print("SUM", t.item())
dist.destroy_process_group()
"""


def test_a_gloo_world_through_the_rig():
    def spawn(port):
        return [subprocess.Popen([sys.executable, "-c", _RANK], env=testing.make_child_env(
            port, r, 2), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]

    results = testing.run_gloo_world(spawn, timeout=90)
    assert [rc for rc, _ in results] == [0, 0], results
    assert all("SUM 3.0" in out for _, out in results)


def test_a_taken_port_is_torchs_transport_error_and_is_retried():
    """The first attempt's port is held by a listening socket: torch's store
    cannot listen there, and the rig runs the world again on a fresh one."""
    seen = []
    with socket.socket() as held:
        held.bind(("127.0.0.1", 0))
        held.listen()
        taken = held.getsockname()[1]

        def spawn(port):
            seen.append(port)
            use = taken if len(seen) == 1 else port
            return [subprocess.Popen([sys.executable, "-c", _RANK],
                                     env=testing.make_child_env(use, 0, 1),
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]

        results = testing.run_gloo_world(spawn, timeout=90)
    assert [rc for rc, _ in results] == [0] and "SUM 1.0" in results[0][1]
    assert len(seen) == 2


def test_a_world_whose_first_port_is_taken_starts_again(monkeypatch):
    """``tests/torch_spmd_child.py``'s ``World`` on the rig: its rank dies
    in the store's setup on a taken port before any answer, and the world
    starts again once on a fresh one."""
    import torch_spmd_child as child

    with socket.socket() as held:
        held.bind(("127.0.0.1", 0))
        held.listen()
        first = iter([held.getsockname()[1]])
        fresh = child.reserve_port
        monkeypatch.setattr(child, "reserve_port", lambda: next(first, None) or fresh())
        world = child.World(1)
        try:
            res = world.run("layout", mesh_shape=[1], names=["x"], placements=[["R"]],
                            shape=[4], seed=0)
        finally:
            world.close()
    assert world._transport_retries == 0
    assert res[0]["full"].shape == (4,) and res[0]["rank"] == 0


# ------------------------------------------------------ both packages dormant
_LEAVE_ACTIVE = """
from vescale_tpu import ndtimeline as ref_nd


def test_leave_the_reference_ndtimeline_active():
    ref_nd.api.init_ndtimers()
    assert ref_nd.api.is_active()
"""

_STEP = """
import jax.numpy as jnp
import optax

from vescale_tpu.parallel.optimizer import BasicOptimizer


def test_reference_optimizer_step():
    opt = BasicOptimizer(optax.sgd(0.5))
    params = {"w": jnp.ones(4)}
    new, _ = opt.step(params, opt.init(params), {"w": jnp.ones(4)})
    assert float(new["w"][0]) == 0.5
"""


def test_a_reference_step_runs_under_the_reset_after_a_leaked_ndtimeline(tmp_path):
    """One pytest process, as one xdist worker runs files one after another:
    a file leaves the reference's ndtimeline active; a reference optimizer
    step then fails in a file without the reset and runs in one with it."""
    (tmp_path / "test_1_leak.py").write_text(_LEAVE_ACTIVE)
    (tmp_path / "test_2_unguarded.py").write_text(_STEP)
    (tmp_path / "test_3_guarded.py").write_text(
        "from torch_reset import dormant_module, dormant_test  # noqa: F401\n" + _STEP)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=f"{REPO}{os.pathsep}{os.path.join(REPO, 'tests')}",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider",
                          "-p", "no:randomly", "test_1_leak.py", "test_2_unguarded.py",
                          "test_3_guarded.py"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    log = out.stdout + out.stderr
    assert "PASSED test_1_leak.py::test_leave_the_reference_ndtimeline_active" in log, log
    assert "PASSED test_3_guarded.py::test_reference_optimizer_step" in log, log
    if not hasattr(jax.core, "trace_state_clean"):
        # the fault the reset guards against, as this jax shows it
        assert "FAILED test_2_unguarded.py::test_reference_optimizer_step" in log, log
        assert "trace_state_clean" in log
        assert out.returncode == 1
    else:
        assert out.returncode == 0, log
