"""vescale-lint for the port: AST rules that hold ``vescale_tpu_torch`` to
the invariants its runtime relies on.

The port of ``vescale_tpu/analysis/lint.py``: the same codes, meanings and
suppression syntax, with the rules that name a mechanism pointed at the
port's own (its registry, its kernels package, its cost model).

  VSC201  every ``VESCALE_*`` env READ goes through ``analysis.envreg``
          (or ``config``, a view over it): ``os.environ.get`` /
          ``os.getenv`` / ``os.environ[...]`` / ``in os.environ`` of a
          VESCALE name outside the registry module.  Writes
          (``os.environ[...] =``, ``setdefault``, ``pop``, ``del``) pass
          config to children and stay legal.
  VSC202  every ``VESCALE_*`` string literal names a knob the port's
          registry holds (or a prefix of one, for families such as
          ``VESCALE_IO_BACKOFF_*``): an unregistered knob is undocumented.
  VSC203  a rebindable module hook slot (a name declared ``global`` in some
          function, or containing "hook") is never bound to a lambda: the
          dormant hooks are asserted by identity against module-level
          named no-op functions.
  VSC204  a function installed with ``signal.signal`` stays
          async-signal-safe: no lock, IO, logging or array allocation in
          the handler frame.
  VSC205  no bare ``except:`` (or ``except BaseException:``) without a
          re-raise inside a loop: a retry loop that swallows
          ``KeyboardInterrupt`` cannot be interrupted.
  VSC206  only ``vescale_tpu_torch/kernels/`` loads a library built from
          ``kernels/csrc/`` (``_build.load``, or a ``ctypes`` /
          ``torch.ops.load_library`` load of the kernels' build) or
          defines an op in the kernels' ``torch.library`` namespace
          ``vtt`` (``ops/`` may too: it registers the op wrappers).  The
          wrappers there choose the kernel or its plain version by the
          tensor's device and count each launch in ``LAUNCHES``; a kernel
          reached another way bypasses both.  Host libraries (the token
          loader's, the checkpoint writer's) are not kernels.
  VSC207  no ad-hoc warn-once latches: a function that both calls
          ``warnings.warn`` / ``<log>.warning`` and touches a "warned"
          latch is a hand-rolled alert with no lifecycle.  Raise it
          through ``telemetry.alerts.raise_alert``, or annotate the site.
          The alert engine (``telemetry/alerts.py``) owns the one
          sanctioned fallback latch and is exempt.
  VSC208  a priced decision enters the cost-audit ledger: package code
          (files under ``vescale_tpu_torch/``) that calls
          ``pipe.simulate_schedule`` / ``pipe.estimate_stage_costs``
          inside a function with no ``record_prediction`` reference
          chooses by a prediction ``telemetry.costaudit`` never audits.

Plus VSC104 (shared with shardcheck): collective calls under rank-divergent
``if`` / ``while`` conditions, the classic SPMD deadlock.

Suppression: append ``# vescale-lint: disable=VSC201`` (comma-separated
codes, or ``disable=all``) to the offending line, with the reason.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable, List, Sequence, Set

from .findings import CODES, Finding, FindingReport

__all__ = [
    "lint_source",
    "lint_paths",
    "rank_divergence_findings",
    "iter_python_files",
    "default_lint_paths",
]

_ENV_NAME = re.compile(r"VESCALE_[A-Z0-9_]+")
_DISABLE = re.compile(r"#\s*vescale-lint:\s*disable=([A-Za-z0-9,_ ]+|all)")

# names whose call inside a signal handler frame is unsafe (locks, IO,
# logging, allocation); attribute calls checked against the same set
_SIGNAL_UNSAFE = {
    "acquire", "wait", "join", "Lock", "RLock", "Condition", "Semaphore",
    "BoundedSemaphore", "open", "print", "log", "debug", "info", "warning",
    "error", "exception", "write", "flush", "array", "asarray", "zeros",
    "ones", "empty",
}

# rank-like identifiers that make a condition rank-divergent, and the
# collectives a divergent branch deadlocks: the reference's tables plus
# torch.distributed's spellings and the port's quantized collectives
_RANK_TOKENS = {"rank", "process_id", "process_index", "coordinate_of_rank", "local_rank",
                "host_id", "is_coordinator", "get_rank"}
_COLLECTIVE_CALLS = {
    "barrier", "all_processes_ok", "allgather_ints", "mesh_all_reduce", "mesh_all_gather",
    "mesh_reduce_scatter", "mesh_all_to_all", "mesh_broadcast", "mesh_scatter",
    "mesh_ppermute", "psum", "pmean", "pmax", "pmin", "psum_scatter", "all_gather",
    "all_to_all", "ppermute", "all_gather_object", "all_reduce", "reduce_scatter",
    "broadcast", "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
    "q_psum", "all_reduce_q", "reduce_scatter_q",
}

# cost-model entry points whose callers price a decision (VSC208)
_PRICED_CALLS = {"simulate_schedule", "estimate_stage_costs"}

# VSC206: calls that load a shared library, identifiers and path fragments
# that mean the kernels' build, and the torch.library calls that define or
# implement an op (their first argument names it, "vtt::<op>")
_LIB_LOADERS = {"CDLL", "PyDLL", "LoadLibrary", "load_library"}
_KERNEL_BUILD_IDS = {"_build", "BUILD_DIR", "CSRC_DIR"}
_KERNEL_BUILD_PATHS = ("csrc", "kernels/build")
_OP_DEFINERS = {"custom_op", "triton_op", "define", "impl", "register_fake",
                "register_autograd", "register_kernel", "Library"}
_KERNEL_OP_NAMESPACE = "vtt"


def _disabled_codes(lines: Sequence[str], lineno: int) -> Set[str]:
    if 1 <= lineno <= len(lines):
        m = _DISABLE.search(lines[lineno - 1])
        if m:
            raw = m.group(1)
            if raw.strip() == "all":
                return {"all"}
            return {c.strip().upper() for c in raw.split(",") if c.strip()}
    return set()


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an expression ('os.environ.get')."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _ident(node: ast.AST):
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _pair_in(parts: Sequence[str], a: str, b: str) -> bool:
    return any(x == a and y == b for x, y in zip(parts, parts[1:]))


class _Lint(ast.NodeVisitor):
    def __init__(self, filename: str, source: str, registered) -> None:
        self.filename = filename
        self.lines = source.splitlines()
        self.registered = registered
        self.findings: List[Finding] = []
        self._global_slots: Set[str] = set()
        self._handler_names: Set[str] = set()
        self._loop_depth = 0
        self._is_envreg = os.path.basename(filename) == "envreg.py"
        parts = os.path.normpath(filename).split(os.sep)
        # VSC207: the alert engine owns the one sanctioned warn-once latch
        self._is_alerts = _pair_in(parts, "telemetry", "alerts.py")
        self._vsc207_seen: Set[int] = set()
        self._vsc208_seen: Set[int] = set()
        # VSC208 is for package code: tests and scripts call the cost model
        # to inspect it, not to decide by it
        self._in_package = "vescale_tpu_torch" in parts
        # VSC206: the port's kernels package itself (a nested .../kernels/
        # elsewhere is still checked), and its ops package for op wrappers
        self._in_kernels = _pair_in(parts, "vescale_tpu_torch", "kernels")
        self._in_ops = _pair_in(parts, "vescale_tpu_torch", "ops")

    # ------------------------------------------------------------ plumbing
    def emit(self, code: str, message: str, node: ast.AST) -> None:
        lineno = getattr(node, "lineno", 0)
        disabled = _disabled_codes(self.lines, lineno)
        if "all" in disabled or code in disabled:
            return
        self.findings.append(Finding(CODES[code], message, where=f"{self.filename}:{lineno}"))

    # two passes: global-slot names and signal handlers first
    def prepass(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Global):
                self._global_slots.update(node.names)
            if isinstance(node, ast.Call) and _dotted(node.func) in ("signal.signal", "signal"):
                if len(node.args) >= 2:
                    name = _ident(node.args[1])
                    if name:
                        self._handler_names.add(name)

    # -------------------------------------------------------- VSC201 / 202
    def _check_env_name(self, name: str, node: ast.AST) -> None:
        if not self.registered(name):
            self.emit("VSC202", f"{name} is not registered in vescale_tpu_torch.analysis.envreg "
                      "— declare it (name/type/default/doc) or fix the name", node)

    def _flag_env_read(self, name: str, node: ast.AST) -> None:
        if self._is_envreg:
            return
        self.emit("VSC201", f"direct environment read of {name}; use "
                  "vescale_tpu_torch.analysis.envreg accessors (get_bool/get_int/"
                  "get_float/get_str/get_raw) or vescale_tpu_torch.config", node)

    # ------------------------------------------------------------- VSC206
    def _check_kernel_route(self, node: ast.Call, dotted: str) -> None:
        if self._in_kernels:
            return
        last = dotted.rsplit(".", 1)[-1]
        if dotted == "_build.load" or dotted.endswith("._build.load"):
            self.emit("VSC206", "a kernel library loaded outside vescale_tpu_torch/kernels/ "
                      "bypasses the wrappers' device dispatch and launch counts; call "
                      "the kernel's wrapper in the kernels package", node)
        elif last in _LIB_LOADERS and any(self._names_kernel_build(a) for a in node.args):
            self.emit("VSC206", f"`{last}` loads the kernels' build outside "
                      "vescale_tpu_torch/kernels/, bypassing the wrappers' device "
                      "dispatch and launch counts", node)
        elif last in _OP_DEFINERS and not self._in_ops and node.args:
            first = node.args[0]
            if isinstance(first, ast.Constant) and isinstance(first.value, str):
                ns = first.value.split("::", 1)[0] if "::" in first.value else (
                    first.value if last == "Library" else None)
                if ns == _KERNEL_OP_NAMESPACE:
                    self.emit("VSC206", f"kernel op {first.value!r} defined outside "
                              "vescale_tpu_torch/kernels/ and ops/; the kernels' "
                              f"`{_KERNEL_OP_NAMESPACE}` namespace belongs to their "
                              "wrappers", node)

    @staticmethod
    def _names_kernel_build(arg: ast.AST) -> bool:
        """The argument names the kernels' build: one of its identifiers, or
        its path pieces (joined, as ``os.path.join`` would) reach it."""
        pieces = []
        for sub in ast.walk(arg):
            if _ident(sub) in _KERNEL_BUILD_IDS:
                return True
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                pieces.append(sub.value)
        path = "/".join(pieces)
        return any(p in path for p in _KERNEL_BUILD_PATHS)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        # `from ..kernels._build import load` is _build.load by another name
        if (not self._in_kernels and (node.module or "").rsplit(".", 1)[-1] == "_build"
                and any(a.name == "load" for a in node.names)):
            self.emit("VSC206", "the kernels' library loader imported outside "
                      "vescale_tpu_torch/kernels/; call the kernel's wrapper instead", node)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func)
        self._check_kernel_route(node, dotted)
        if dotted in ("os.getenv", "getenv", "os.environ.get", "environ.get"):
            if node.args and isinstance(node.args[0], ast.Constant) and isinstance(
                    node.args[0].value, str):
                name = node.args[0].value
                if name.startswith("VESCALE_"):
                    self._flag_env_read(name, node)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # os.environ["X"] in a Load context is a read; Store/Del are writes
        if isinstance(node.ctx, ast.Load) and _dotted(node.value) in ("os.environ", "environ"):
            sl = node.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str) and sl.value.startswith(
                    "VESCALE_"):
                self._flag_env_read(sl.value, node)
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        # "X" in os.environ is a read probe
        if (isinstance(node.left, ast.Constant) and isinstance(node.left.value, str)
                and node.left.value.startswith("VESCALE_")
                and any(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops)
                and any(_dotted(c) in ("os.environ", "environ") for c in node.comparators)):
            self._flag_env_read(node.left.value, node)
        self.generic_visit(node)

    def visit_Constant(self, node: ast.Constant) -> None:
        if isinstance(node.value, str):
            for name in _ENV_NAME.findall(node.value):
                self._check_env_name(name, node)
        self.generic_visit(node)

    # ------------------------------------------------------------- VSC203
    def visit_Assign(self, node: ast.Assign) -> None:
        if isinstance(node.value, ast.Lambda):
            for t in node.targets:
                name = _ident(t)
                if name and (name in self._global_slots or "hook" in name.lower()):
                    self.emit("VSC203", f"hook slot {name!r} bound to a lambda; bind a "
                              "module-level named no-op function so dormant hooks can be "
                              "identity-asserted", node)
        self.generic_visit(node)

    # ------------------------------------------------------------- VSC207
    def _check_warn_latch(self, node: ast.FunctionDef) -> None:
        """A function that both warns and touches a "warned" latch rolls its
        own alert lifecycle.  The finding anchors to the warn call."""
        if self._is_alerts:
            return
        warn_calls = []
        has_latch = False
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and _dotted(sub.func).rsplit(".", 1)[-1] in (
                    "warn", "warning"):
                warn_calls.append(sub)
            ident = _ident(sub)
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                ident = sub.value
            if ident is not None and "warned" in ident.lower():
                has_latch = True
        if not has_latch:
            return
        for call in warn_calls:
            # a def nested in a flagged def would flag the same call again
            if id(call) in self._vsc207_seen:
                continue
            self._vsc207_seen.add(id(call))
            self.emit("VSC207", f"warn-once latch in {node.name!r}: a hand-rolled alert with "
                      "no lifecycle (no resolve, no dedup window, no /alerts visibility) — "
                      "raise it through telemetry.alerts.raise_alert, or annotate the "
                      "legacy fallback", call)

    # ------------------------------------------------------------- VSC208
    def _check_priced_decision(self, node: ast.FunctionDef) -> None:
        """A package function that calls a cost-model entry point but never
        references ``record_prediction`` prices a decision outside the
        audit ledger.  The finding anchors to the priced call."""
        if not self._in_package:
            return
        priced = []
        has_record = False
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                name = _dotted(sub.func).rsplit(".", 1)[-1]
                if name in _PRICED_CALLS:
                    priced.append((name, sub))
            if _ident(sub) == "record_prediction":
                has_record = True
        if has_record:
            return
        for name, call in priced:
            if id(call) in self._vsc208_seen:
                continue
            self._vsc208_seen.add(id(call))
            self.emit("VSC208", f"`{name}` priced a decision in {node.name!r} with no "
                      "record_prediction in scope — the prediction never enters the "
                      "cost-audit ledger (telemetry/costaudit.py); record it or annotate "
                      "the site", call)

    # ------------------------------------------------------------- VSC204
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._check_warn_latch(node)
        self._check_priced_decision(node)
        if node.name in self._handler_names:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    name = _ident(sub.func)
                    if name in _SIGNAL_UNSAFE:
                        self.emit("VSC204", f"`{name}` called inside signal handler "
                                  f"{node.name!r} — handlers must only set flags "
                                  "(locks/IO/allocation can deadlock the interrupted frame)",
                                  sub)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    # ------------------------------------------------------------- VSC205
    def _visit_loop(self, node) -> None:
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_For = visit_While = visit_AsyncFor = _visit_loop  # type: ignore[assignment]

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if self._loop_depth > 0:
            bare = node.type is None
            base = isinstance(node.type, ast.Name) and node.type.id == "BaseException"
            # a handler that binds the exception and uses it transports it
            # (e.g. boxes it for a re-raise on another thread)
            uses_exc = node.name is not None and any(
                isinstance(sub, ast.Name) and sub.id == node.name for sub in ast.walk(node))
            if (bare or base) and not uses_exc and not any(
                    isinstance(sub, ast.Raise) for sub in ast.walk(node)):
                self.emit("VSC205", ("bare `except:`" if bare else "`except BaseException:`")
                          + " inside a loop with no re-raise swallows KeyboardInterrupt — "
                          "catch Exception (or re-raise)", node)
        self.generic_visit(node)


# --------------------------------------------------------------- VSC104
def _condition_is_rankish(test: ast.AST) -> bool:
    for sub in ast.walk(test):
        name = _ident(sub)
        if name and name.lower() in _RANK_TOKENS:
            return True
    return False


def rank_divergence_findings(source: str, filename: str = "<source>") -> List[Finding]:
    """VSC104: a collective call under an ``if`` / ``while`` whose condition
    reads a rank-like value: the ranks that skip it deadlock the others.
    ``# vescale-lint: disable=VSC104`` on the call's line silences it."""
    tree = ast.parse(source)
    lines = source.splitlines()
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.If, ast.While)) or not _condition_is_rankish(node.test):
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            name = _ident(sub.func)
            if name not in _COLLECTIVE_CALLS:
                continue
            lineno = getattr(sub, "lineno", getattr(node, "lineno", 0))
            disabled = _disabled_codes(lines, lineno)
            if "all" in disabled or "VSC104" in disabled:
                continue
            findings.append(Finding(
                CODES["VSC104"],
                f"collective `{name}` is executed only under a rank-dependent condition (line "
                f"{getattr(node, 'lineno', '?')}); ranks that skip it deadlock the ones that "
                "reach it", where=f"{filename}:{lineno}"))
    return findings


# ------------------------------------------------------------ file walker
_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules", "build", "dist",
              ".pytest_cache", "legacy"}
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def default_lint_paths() -> List[str]:
    """What ``python -m vescale_tpu_torch.analysis lint`` checks by default:
    the port's package and its ``chip_smoke.py``."""
    paths = [os.path.join(_REPO, "vescale_tpu_torch"), os.path.join(_REPO, "chip_smoke.py")]
    return [p for p in paths if os.path.exists(p)]


def iter_python_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for path in paths:
        if os.path.isfile(path) and path.endswith(".py"):
            out.append(path)
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
            out.extend(os.path.join(root, f) for f in sorted(files) if f.endswith(".py"))
    return out


def _default_registered(name: str) -> bool:
    from . import envreg

    if envreg.is_registered(name):
        return True
    # families: a prefix such as "VESCALE_IO_BACKOFF_" is legal when a
    # registered knob extends it
    return any(v.name.startswith(name) for v in envreg.all_vars())


def lint_source(source: str, filename: str = "<source>", registered=None) -> List[Finding]:
    """Lint one source text; ``registered`` is the name -> bool predicate
    for VSC202 (default: the port's registry, prefixes allowed)."""
    registered = registered or _default_registered
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(CODES["VSC202"], f"file does not parse: {e}",
                        where=f"{filename}:{getattr(e, 'lineno', 0)}")]
    linter = _Lint(filename, source, registered)
    linter.prepass(tree)
    linter.visit(tree)
    return linter.findings + rank_divergence_findings(source, filename)


def lint_paths(paths: Sequence[str], name: str = "vescale-lint") -> FindingReport:
    report = FindingReport(name)
    for path in iter_python_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as f:
                src = f.read()
        except OSError:
            continue
        report.extend(lint_source(src, os.path.relpath(path)))
    return report
