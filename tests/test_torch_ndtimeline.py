"""The port's ndtimeline against the JAX package's, on the CPU.

Fixed span lists go through both packages' handlers and parsers and are
held equal: the Chrome/Perfetto JSON, the raw JSONL dumps, the parser's
aggregate and cross-rank merge.  A reference ``SockHandler`` feeds the
port's ``NDtimelineStreamer`` (and the other way round) over a unix
socket: the wire format is one.  Then the port's own contract: a dormant
manager records nothing, a span is a ``torch.profiler`` range, and the
runtime's call sites (the optimizers' OPTIMIZER_STEP, the loader's
DATA_LOAD, the checkpoint's SAVE/COMMIT/LOAD, memtrack's tail) emit.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from vescale_tpu import ndtimeline as ref_nd
from vescale_tpu.mesh import DeviceMesh as RefMesh
from vescale_tpu.ndtimeline.parser_handler import aggregate as ref_aggregate
from vescale_tpu.ndtimeline.parser_handler import merge_ranks as ref_merge_ranks
from vescale_tpu.ndtimeline.parser_handler import parse_raw_spans as ref_parse
from vescale_tpu.ndtimeline.timer import Span as RefSpan

from vescale_tpu_torch import ndtimeline as nd
from vescale_tpu_torch import telemetry as tel
from vescale_tpu_torch.mesh import DeviceMesh
from vescale_tpu_torch.ndtimeline import predefined as P
from vescale_tpu_torch.ndtimeline.parser_handler import aggregate, merge_ranks, parse_raw_spans
from vescale_tpu_torch.ndtimeline.timer import Span

from vescale_tpu import telemetry as ref_tel
from vescale_tpu.telemetry import alerts as ref_alerts
from vescale_tpu.telemetry import calibrate as ref_cal
from vescale_tpu.telemetry import costaudit as ref_ca
from vescale_tpu.telemetry import timeseries as ref_ts

from vescale_tpu_torch.telemetry import alerts, calibrate, costaudit, timeseries

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------- shared by the observability tests
# ndtimeline's manager, telemetry, the alert engine, the time-series store,
# the cost auditor and the active calibration table are module globals in
# both packages.  A test file that leaves any of them live can change a
# later file on the same xdist worker (ndtimeline left active makes every
# reference ``BasicOptimizer.step`` reach a missing ``jax.core`` call), so
# each observability test file resets them around every test.
def reset_all() -> None:
    """Both packages back to their dormant state."""
    for pkg_tel, pkg_nd, pkg_ca, pkg_al, pkg_ts, pkg_cal in (
            (ref_tel, ref_nd, ref_ca, ref_alerts, ref_ts, ref_cal),
            (tel, nd, costaudit, alerts, timeseries, calibrate)):
        pkg_tel.shutdown()
        pkg_ca.deactivate()
        pkg_al.deactivate()
        pkg_ts.deactivate()
        pkg_al.clear_fallback_warned()
        pkg_cal.reset_active()
        pkg_nd.api.deinit_ndtimers()


def all_dormant() -> bool:
    return not any((ref_tel.is_active(), tel.is_active(), ref_nd.api.is_active(),
                    nd.api.is_active(), ref_alerts.is_active(), alerts.is_active(),
                    ref_ts.is_active(), timeseries.is_active(), ref_ca.is_active(),
                    costaudit.is_active()))


_CHILD = """
import json, sys
from vescale_tpu_torch import distributed as D
D.initialize(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), device_type="cpu", timeout_s=60)
try:
    exec(sys.argv[4])
    print("RESULT " + json.dumps(result))
finally:
    import torch.distributed as dist
    dist.destroy_process_group()
"""


def gloo_world(code: str, n: int = 2, timeout_s: float = 120.0) -> list:
    """Run ``code`` on each rank of a fresh gloo world of ``n`` CPU
    processes joined through ``distributed.initialize``; ``code`` sets
    ``result`` (JSON-able).  Returns every rank's result, in rank order."""
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("VESCALE_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, f"127.0.0.1:{port}", str(n), str(r),
                               code], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=REPO) for r in range(n)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=timeout_s)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1][len("RESULT "):]))
    return outs


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    reset_all()
    assert all_dormant()


# a fixed span list: two ranks, stages, flows, several metrics and steps
ROWS = [
    ("forward-compute", 100.0, 0.004, 0, 0, {"stage": 0}),
    ("forward-compute", 100.0021, 0.005, 0, 1, {"stage": 1}),
    ("serve-submit", 100.001, 0.0, 0, 0, {"rid": 3, "flow_id": "req3", "flow_role": "send"}),
    ("serve-terminal", 100.009, 0.0, 0, 1, {"rid": 3, "flow_id": "req3", "flow_role": "recv",
                                            "outcome": "completed"}),
    ("train-step", 100.010, 0.020, 1, 0, None),
    ("train-step", 100.0105, 0.031, 1, 1, None),
    ("data-load", 100.0301, 0.0015, 1, 0, {"path": "x"}),
    ("fleet-dispatch-attempt", 100.04, 0.002, 2, 0,
     {"flow_id": ["a", "b"], "flow_role": ["send", "recv"]}),
    ("train-step", 100.05, 0.019, 2, 0, None),
    ("train-step", 100.0502, 0.040, 2, 1, {"stage": "bad"}),
]


def _spans(cls):
    return [cls(m, s, d, st, r, dict(t) if t else None) for m, s, d, st, r, t in ROWS]


def _as_tuples(spans):
    return [(s.metric, s.start, s.duration, s.step, s.rank, s.tags) for s in spans]


def test_dormant_ndtimeit_is_free_and_records_nothing():
    assert not nd.api.is_active()
    ctx = nd.ndtimeit("x")
    assert isinstance(ctx, contextlib.nullcontext)
    with ctx:
        pass
    nd.flush()  # a stray flush makes a manager but turns nothing on
    assert not nd.api.is_active()
    assert nd.api.get_manager().tail() == []
    calls = []

    @nd.ndtimer("decorated")
    def f(x):
        calls.append(x)
        return x + 1

    assert f(1) == 2 and f.__name__ == "f"
    mgr = nd.init_ndtimers(rank=3)
    assert f(2) == 3 and [s.metric for s in mgr.tail()] == ["decorated"]
    assert mgr.tail()[0].rank == 3 and calls == [1, 2]


def test_manager_flush_windows_tail_and_steps_equal_the_reference():
    """The same calls on both managers: the same spans flushed, kept and
    peeked, step numbers included (start times are set, not read)."""
    outs = []
    for pkg in (ref_nd, nd):
        got = []
        mgr = pkg.init_ndtimers(rank=1, handlers=[got.append], max_spans=4)
        for i in range(6):
            mgr.record(f"m{i % 2}", 10.0 + i, 0.5, tags={"i": i}, step=i // 2)
        mgr.inc_step(2)
        mgr.record("late", 20.0, 0.25)
        peek = _as_tuples(mgr.tail(2))
        first = _as_tuples(pkg.flush(step_range=range(2, 3)))
        rest = _as_tuples(pkg.flush(next_iteration=True))
        with pytest.raises(ValueError):
            pkg.flush(step_range=(3, 1))
        outs.append((peek, first, rest, mgr.step, [_as_tuples(b) for b in got]))
        pkg.api.deinit_ndtimers()
    assert outs[0] == outs[1]
    assert outs[1][1] and outs[1][3] == 3


def test_chrome_trace_json_equals_the_reference(tmp_path):
    names = {0: "rank 0 [dp=0 tp=0 pp=0]"}
    ref = ref_nd.ChromeTraceHandler(str(tmp_path / "ref.json"), process_names=names)
    got = nd.ChromeTraceHandler(str(tmp_path / "port.json"), process_names=names)
    ref(_spans(RefSpan))
    got(_spans(Span))
    with open(ref.write()) as a, open(got.write()) as b:
        want, have = json.load(a), json.load(b)
    assert have == want
    phases = {e["ph"] for e in have["traceEvents"]}
    assert {"X", "M", "s", "f"} <= phases


def test_raw_dumps_parse_aggregate_and_merge_equal_the_reference(tmp_path):
    ref_nd.LocalRawHandler(str(tmp_path / "ref.jsonl"))(_spans(RefSpan))
    nd.LocalRawHandler(str(tmp_path / "port.jsonl"))(_spans(Span))
    assert (tmp_path / "ref.jsonl").read_bytes() == (tmp_path / "port.jsonl").read_bytes()
    mine = parse_raw_spans(str(tmp_path / "port.jsonl"))
    theirs = ref_parse(str(tmp_path / "ref.jsonl"))
    assert _as_tuples(mine) == _as_tuples(theirs) == _as_tuples(_spans(Span))
    assert aggregate(mine) == ref_aggregate(theirs)
    assert merge_ranks(mine) == ref_merge_ranks(theirs)
    lines = []
    nd.LoggingHandler(lines.append)(mine[:2])
    assert lines == ["[ndtimeline r0 step0] forward-compute: 4.000 ms",
                     "[ndtimeline r1 step0] forward-compute: 5.000 ms"]


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_socket_stream_crosses_the_packages(tmp_path, direction):
    """The wire format is the reference's byte for byte: either package's
    ``SockHandler`` feeds the other's ``NDtimelineStreamer``."""
    import time

    if direction == "reference_to_port":
        collector_pkg, sender_pkg, span_cls = nd, ref_nd, RefSpan
    else:
        collector_pkg, sender_pkg, span_cls = ref_nd, nd, Span
    addr = str(tmp_path / "nd.sock")
    got = []
    st = collector_pkg.NDtimelineStreamer.start(addr, [got.extend], straggler=True)
    try:
        sender = sender_pkg.SockHandler(addr, connect_timeout=5.0)
        sender(_spans(span_cls)[:5])
        sender(_spans(span_cls)[5:])
        deadline = time.monotonic() + 10
        while len(got) < len(ROWS) and time.monotonic() < deadline:
            time.sleep(0.01)
        sender.close()
    finally:
        st.stop()
    assert _as_tuples(got) == _as_tuples(_spans(Span))
    assert st.received == len(ROWS) and st.decode_errors == 0 and sender.dropped == 0
    assert st.straggler is not None and st.straggler.spans_seen == len(ROWS)


def test_world_info_from_the_port_mesh_equals_the_reference():
    import dataclasses

    ref_mesh = RefMesh(("dp", "tp", "pp"), (2, 2, 2))
    mesh = DeviceMesh(("dp", "tp", "pp"), (2, 2, 2), device_type="cpu")
    for rank in range(8):
        want = dataclasses.asdict(ref_nd.WorldInfo.from_mesh(ref_mesh, rank))
        assert dataclasses.asdict(nd.WorldInfo.from_mesh(mesh, rank)) == want
    mgr = nd.init_ndtimers(rank=5, mesh=mesh)
    assert (mgr.world.dp_rank, mgr.world.tp_rank, mgr.world.pp_rank) == (1, 0, 1)


def test_span_is_a_profiler_range_on_host_wall_clock():
    """A span shows in a ``torch.profiler`` capture around the ops it ran,
    and its start and duration are host wall clock (as the reference's)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    mgr = nd.init_ndtimers()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with nd.ndtimeit(P.TRAIN_STEP, tags={"k": 1}):
            torch.ones(64).mul(2).sum()
    t1 = time.time()
    names = [e.name for e in prof.events()]
    assert P.TRAIN_STEP in names
    (span,) = mgr.tail()
    assert span.metric == P.TRAIN_STEP and span.tags == {"k": 1}
    assert t0 <= span.start <= span.start + span.duration <= t1


def test_optimizer_steps_record_one_span_each():
    from vescale_tpu_torch.parallel import AdamWLowmem, BasicOptimizer

    lin = torch.nn.Linear(4, 3)
    opt = AdamWLowmem(lin.parameters(), 1e-3)
    wrapped = BasicOptimizer(AdamWLowmem(lin.parameters(), 1e-3), grad_clip=1.0)
    lin(torch.ones(2, 4)).sum().backward()
    opt.step()  # dormant: no span, the update happens
    mgr = nd.init_ndtimers()
    opt.step()
    wrapped.step()  # the outer step's span only
    assert [s.metric for s in mgr.tail()] == [P.OPTIMIZER_STEP, P.OPTIMIZER_STEP]


def test_loader_and_checkpoint_spans(tmp_path):
    from vescale_tpu_torch import checkpoint
    from vescale_tpu_torch.data import TokenDataLoader

    path = str(tmp_path / "tok.bin")
    np.random.default_rng(0).integers(0, 100, 4096).astype(np.uint16).tofile(path)
    loader = TokenDataLoader(path, 2, 16, seed=1, device="cpu")
    mgr = nd.init_ndtimers()
    loader.next()
    state = {"model": {"w": torch.arange(12.0).reshape(3, 4)}}
    checkpoint.save(str(tmp_path / "ck_sync"), state)
    checkpoint.save(str(tmp_path / "ck_async"), state, async_checkpoint=True).wait()
    back = checkpoint.load(str(tmp_path / "ck_sync"), {"model": {"w": torch.zeros(3, 4)}})
    assert torch.equal(back["model"]["w"], state["model"]["w"])
    spans = mgr.tail()
    # a sync save commits inside its save span, so the commit ends (and is
    # recorded) first; an async save's commit runs at wait()
    assert [s.metric for s in spans] == [
        P.DATA_LOAD, P.CHECKPOINT_COMMIT, P.CHECKPOINT_SAVE, P.CHECKPOINT_SAVE,
        P.CHECKPOINT_COMMIT, P.CHECKPOINT_LOAD]
    assert spans[2].tags == {"path": str(tmp_path / "ck_sync"), "async": False}
    assert spans[3].tags["async"] is True and spans[5].tags == {"path": str(tmp_path / "ck_sync")}
    loader.close()


def test_flight_record_carries_the_ndtimeline_tail():
    tel.init(out_dir=None, timeseries=False, alerts=False, costaudit=False)
    assert tel.dump_now(reason="t")["ndtimeline_tail"] is None
    mgr = nd.init_ndtimers()
    mgr.record("m", 1.0, 0.5, tags={"a": 1})
    rec = tel.dump_now(reason="t")
    assert rec["ndtimeline_tail"] == [{"metric": "m", "start": 1.0, "duration": 0.5, "step": 0,
                                       "rank": 0, "tags": {"a": 1}}]


def test_predefined_names_are_the_references():
    from vescale_tpu.ndtimeline import predefined as RP

    names = {k: v for k, v in vars(RP).items() if k.isupper()}
    assert {k: v for k, v in vars(P).items() if k.isupper()} == names
