"""The port's vescale-lint against the JAX package's, on the CPU.

Every fixture snippet of the reference's lint tests goes through both
linters and gives the same codes at the same lines, suppression honoured.
The env-read fixtures name ``VESCALE_FAULTSIM``, a knob both registries
hold (the reference's own fixtures name ``VESCALE_BENCH``, which the port
does not register; that difference is pinned on its own).  Then the rules
whose meaning is the port's own: VSC206 (kernel libraries and the ``vtt``
op namespace only under ``vescale_tpu_torch/kernels/``), VSC208 (the
port's cost model and ledger), VSC104 on ``torch.distributed``'s
spellings, and the port itself linted clean.
"""

import os
import textwrap

import pytest

from vescale_tpu.analysis import lint as ref_lint

from vescale_tpu_torch.analysis import envreg, lint
from vescale_tpu_torch.analysis.__main__ import main as cli_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOB = "VESCALE_FAULTSIM"
BOGUS = "VESCALE_" + "TOTALLY_BOGUS"

# (name, snippet, the codes the reference's tests expect, in line order)
FIXTURES = [
    ("env_reads_not_writes", f"""
        import os
        a = os.environ.get("{KNOB}")
        b = os.getenv("{KNOB}")
        c = os.environ["{KNOB}"]
        d = "{KNOB}" in os.environ
        os.environ["{KNOB}"] = "1"          # write: fine
        os.environ.setdefault("{KNOB}", "") # write: fine
        del os.environ["{KNOB}"]            # write: fine
    """, ["VSC201"] * 4),
    ("unregistered", f'x = "{BOGUS}"\n', ["VSC202"]),
    ("unregistered_suppressed", f'x = "{BOGUS}"  # vescale-lint: disable=VSC202\n', []),
    ("unregistered_suppressed_all", f'x = "{BOGUS}"  # vescale-lint: disable=all\n', []),
    ("registered", f'x = "{KNOB}"\n', []),
    ("family_prefix", 'y = "VESCALE_IO_BACKOFF_"\n', []),
    ("hook_slot_lambda", """
        def _noop(x):
            return x
        tag_array = _noop
        def activate():
            global tag_array
            tag_array = lambda x: x
    """, ["VSC203"]),
    ("hook_name_lambda", "my_hook = lambda: None\n", ["VSC203"]),
    ("not_a_slot", "not_a_slot = lambda: None\n", []),
    ("signal_handler_lock", """
        import signal, threading
        lock = threading.Lock()
        def _on_signal(signum, frame):
            lock.acquire()
        signal.signal(signal.SIGTERM, _on_signal)
    """, ["VSC204"]),
    ("signal_handler_flag", """
        import signal
        def _on_signal(signum, frame):
            flag.set()
        signal.signal(signal.SIGTERM, _on_signal)
    """, []),
    ("bare_except_in_loop", """
        while True:
            try:
                step()
            except:
                pass
    """, ["VSC205"]),
    ("bare_except_reraises", """
        while True:
            try:
                step()
            except:
                raise
    """, []),
    ("base_exception_transported", """
        while True:
            try:
                step()
            except BaseException as e:
                box = e
    """, []),
    ("bare_except_outside_loop", """
        try:
            step()
        except:
            pass
    """, []),
    ("rank_divergent_barrier", """
        def f(rank):
            if rank == 0:
                barrier()
    """, ["VSC104"]),
    ("rank_divergent_clean", """
        def f(rank, loss):
            if loss > 0:
                barrier()
            if rank == 0:
                print("hello")
    """, []),
    ("warn_latch", """
        import warnings
        _warned = False
        def notice():
            global _warned
            if not _warned:
                _warned = True
                warnings.warn("once")
    """, ["VSC207"]),
    ("warn_latch_suppressed", """
        import warnings
        _warned = set()
        def notice(k):
            if k not in _warned:
                _warned.add(k)
                warnings.warn("once")  # vescale-lint: disable=VSC207
    """, []),
    ("two_codes_one_line", f"""
        import os
        a = os.environ.get("{BOGUS}")  # vescale-lint: disable=VSC201
        b = os.environ.get("{BOGUS}")  # vescale-lint: disable=VSC201,VSC202
    """, ["VSC202"]),
]


def _found(linter, src, filename="snippet.py"):
    return [(f.code.code, int(f.where.rsplit(":", 1)[1]))
            for f in linter.lint_source(textwrap.dedent(src), filename)]


@pytest.mark.parametrize("name,src,codes", FIXTURES, ids=[f[0] for f in FIXTURES])
def test_reference_fixtures_give_the_same_codes_at_the_same_lines(name, src, codes):
    port, ref = _found(lint, src), _found(ref_lint, src)
    assert port == ref
    assert [c for c, _ in sorted(port, key=lambda x: x[1])] == codes


def test_reference_only_knobs_are_unregistered_in_the_port():
    """The reference's fixtures read ``VESCALE_BENCH``: registered there,
    not in the port, which has no bench harness of the JAX package's."""
    src = 'x = "VESCALE_BENCH"\n'
    assert _found(ref_lint, src) == []
    assert _found(lint, src) == [("VSC202", 1)]
    for name in envreg.REFERENCE_ONLY:
        assert _found(lint, f'x = "{name}"\n') == [("VSC202", 1)], name


def test_lint_tables_hold_the_references():
    """The port's tables extend the reference's (torch spellings) and drop
    nothing; the suppression syntax is the same."""
    assert ref_lint._SIGNAL_UNSAFE == lint._SIGNAL_UNSAFE
    assert ref_lint._RANK_TOKENS <= lint._RANK_TOKENS
    assert ref_lint._COLLECTIVE_CALLS <= lint._COLLECTIVE_CALLS
    assert ref_lint._PRICED_CALLS == lint._PRICED_CALLS
    assert ref_lint._DISABLE.pattern == lint._DISABLE.pattern
    assert ref_lint._SKIP_DIRS == lint._SKIP_DIRS


def test_torch_collectives_under_a_rank_condition_are_vsc104():
    src = """
        import torch.distributed as dist
        def f(t):
            if dist.get_rank() == 0:
                dist.all_reduce(t)
            if dist.get_rank() == 1:
                dist.all_gather_into_tensor(t, t)  # vescale-lint: disable=VSC104
            dist.reduce_scatter_tensor(t, t)
    """
    assert _found(lint, src) == [("VSC104", 5)]


# ------------------------------------------------------------- VSC206
KERNEL_ROUTES = [
    # (file, snippet, flagged)
    ("vescale_tpu_torch/models/llama.py",
     'from vescale_tpu_torch.kernels import _build\nfn = _build.load("flash_fwd", "vtt_flash_fwd", [])\n',
     True),
    ("vescale_tpu_torch/kernels/flash_attention.py",
     'from . import _build\nfn = _build.load("flash_fwd", "vtt_flash_fwd", [])\n', False),
    ("vescale_tpu_torch/serve/engine.py",
     "from ..kernels._build import load\n", True),
    ("vescale_tpu_torch/serve/engine.py",
     "import ctypes\nfrom ..kernels import _build\nlib = ctypes.CDLL(str(_build._target('paged_decode')))\n",
     True),
    ("chip_smoke.py",
     "import ctypes, os\nlib = ctypes.CDLL(os.path.join('vescale_tpu_torch', 'kernels', 'build', 'libx.so'))\n",
     True),
    ("vescale_tpu_torch/ops/x.py",
     "import torch\ntorch.ops.load_library(CSRC_DIR / 'x.so')\n", True),
    ("vescale_tpu_torch/models/llama.py", """
        import torch
        @torch.library.custom_op("vtt::my_kernel", mutates_args=())
        def my_kernel(x: torch.Tensor) -> torch.Tensor:
            return x
     """, True),
    ("vescale_tpu_torch/models/llama.py",
     'import torch\nlib = torch.library.Library("vtt", "DEF")\nlib.define("k(Tensor x) -> Tensor")\n',
     True),
    ("vescale_tpu_torch/models/llama.py",
     'import torch\ntorch.library.register_fake("vtt::xent_parts")(lambda *a: None)\n', True),
    ("vescale_tpu_torch/ops/flash_attention.py", """
        import torch
        @torch.library.custom_op("vtt::flash_attention", mutates_args=())
        def flash_attention(q: torch.Tensor) -> torch.Tensor:
            return q
     """, False),
    ("vescale_tpu_torch/kernels/cross_entropy.py", """
        import torch
        @torch.library.custom_op("vtt::xent_parts", mutates_args=())
        def xent_parts(x: torch.Tensor) -> torch.Tensor:
            return x
     """, False),
    # shardcheck's constraint op is not a kernel: another namespace
    ("vescale_tpu_torch/analysis/shardcheck.py", """
        import torch
        @torch.library.custom_op("vtt_check::constraint", mutates_args=())
        def constraint(x: torch.Tensor) -> torch.Tensor:
            return x
     """, False),
    # host libraries: the token loader's and the checkpoint writer's
    ("vescale_tpu_torch/data/loader.py",
     "import ctypes\nso = build_native()\nlib = ctypes.CDLL(so)\n", False),
    ("vescale_tpu_torch/checkpoint/native_io.py",
     "import ctypes\nlib = ctypes.CDLL(build_native())\n", False),
    # building the kernels is not loading them (chip_smoke.py's build phase)
    ("chip_smoke.py",
     "from vescale_tpu_torch.kernels import _build\nnvcc_s = _build.build()\n", False),
    # only the port's own kernels package is exempt
    ("vescale_tpu_torch/models/kernels/x.py",
     'from vescale_tpu_torch.kernels import _build\nfn = _build.load("x", "vtt_x", [])\n', True),
    ("vescale_tpu_torch/models/llama.py",
     'from vescale_tpu_torch.kernels import _build\n'
     'fn = _build.load("x", "vtt_x", [])  # vescale-lint: disable=VSC206\n', False),
]


@pytest.mark.parametrize("filename,src,flagged", KERNEL_ROUTES,
                         ids=[f"{i}-{f[0].rsplit('/', 1)[-1]}" for i, f in enumerate(KERNEL_ROUTES)])
def test_vsc206_kernels_are_reached_only_through_their_wrappers(filename, src, flagged):
    codes = [c for c, _ in _found(lint, src, filename)]
    assert codes == (["VSC206"] if flagged else [])


def test_vsc206_holds_on_the_host_library_loaders_as_they_are():
    for rel in ("vescale_tpu_torch/data/loader.py", "vescale_tpu_torch/checkpoint/native_io.py",
                "vescale_tpu_torch/kernels/_build.py", "vescale_tpu_torch/ops/flash_attention.py"):
        with open(os.path.join(REPO, rel)) as f:
            assert lint.lint_source(f.read(), rel) == [], rel


# ------------------------------------------------------------- VSC208
PRICED = """
    from vescale_tpu_torch.pipe import simulate_schedule, estimate_stage_costs
    def choose(cands, costs):
        return min(cands, key=lambda s: simulate_schedule(s, costs))
    def choose_recorded(cands, costs):
        from vescale_tpu_torch.telemetry import costaudit as _ca
        best = min(cands, key=lambda s: simulate_schedule(s, costs))
        _ca.record_prediction("pipe_schedule", predicted_us=simulate_schedule(best, costs))
        return best
    def stage_costs(units):
        return estimate_stage_costs(units)
"""


def test_vsc208_prices_only_package_code():
    assert _found(lint, PRICED, "vescale_tpu_torch/pipe/chooser.py") == [
        ("VSC208", 4), ("VSC208", 11)]
    assert _found(ref_lint, PRICED, "vescale_tpu/pipe/chooser.py") == [
        ("VSC208", 4), ("VSC208", 11)]
    for outside in ("tests/test_chooser.py", "scripts/chooser.py", "chip_smoke.py"):
        assert _found(lint, PRICED, outside) == [], outside


def test_vsc207_exempts_only_the_alert_engine():
    src = FIXTURES[[f[0] for f in FIXTURES].index("warn_latch")][1]
    assert _found(lint, src, "vescale_tpu_torch/telemetry/alerts.py") == []
    assert [c for c, _ in _found(lint, src, "vescale_tpu_torch/telemetry/straggler.py")] == [
        "VSC207"]


def test_registry_module_may_read_its_knobs():
    src = f'import os\nv = os.environ.get("{KNOB}")\n'
    assert _found(lint, src, "vescale_tpu_torch/analysis/envreg.py") == []
    assert _found(lint, src, "vescale_tpu_torch/config.py") == [("VSC201", 2)]


def test_unparsable_file_is_a_finding():
    assert [c for c, _ in _found(lint, "def f(:\n")] == ["VSC202"]


# ------------------------------------------------------ the port, linted
def test_port_is_lint_green():
    """The counterpart of the reference's ``test_lint_repo_is_green``: the
    port's package and its ``chip_smoke.py``, strict."""
    rep = lint.lint_paths([os.path.join(REPO, "vescale_tpu_torch"),
                           os.path.join(REPO, "chip_smoke.py")])
    assert rep.ok(strict=True), rep.format()
    assert lint.default_lint_paths() == [os.path.join(REPO, "vescale_tpu_torch"),
                                         os.path.join(REPO, "chip_smoke.py")]


def test_cli_lint_is_strict_clean_and_finds_a_planted_fault(tmp_path, capsys):
    assert cli_main(["--strict", "lint"]) == 0
    assert "vescale-lint: clean (0 findings)" in capsys.readouterr().out
    bad = tmp_path / "bad.py"
    bad.write_text(f'import os\nv = os.environ.get("{KNOB}")\n')
    assert cli_main(["--strict", "--json", "lint", str(bad)]) == 1
    assert '"VSC201"' in capsys.readouterr().out
