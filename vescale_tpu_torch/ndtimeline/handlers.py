"""Span handlers (reference legacy/vescale/ndtimeline/handlers/):
ChromeTraceHandler (chrome_trace_event.py — perfetto/chrome JSON),
LoggingHandler, LocalRawHandler (local_raw_handler.py)."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Optional

from .timer import Span

__all__ = ["ChromeTraceHandler", "LoggingHandler", "LocalRawHandler"]


class ChromeTraceHandler:
    """Accumulates spans as chrome://tracing events; ``write()`` emits a
    Perfetto-loadable JSON (reference chrome_trace_event.py).

    Perfetto-valid output contract (docs/observability.md):

      * one **pid lane per rank**, named by ``process_name`` metadata
        events (``process_names={rank: label}`` — telemetry.trace feeds
        WorldInfo coordinates here, e.g. ``rank 1 [dp=1 tp=0 pp=0]``);
      * stable **tid lanes**: tid 0 is the rank's host thread; spans tagged
        with a pipeline ``stage`` get tid ``stage + 1`` with a
        ``thread_name`` metadata event, so a multi-stage engine reads as
        one lane per stage instead of a new thread per step;
      * **flow events** between send/recv span pairs: a span tagged
        ``{"flow_id": i, "flow_role": "send"|"recv"}`` emits a flow start
        (``ph: "s"``) at its end / flow finish (``ph: "f"``, binding to the
        enclosing slice) at its start, drawing the arrow between the two
        ranks' lanes;
      * duration events sorted by timestamp on write (Perfetto accepts
        unsorted input; humans diffing the JSON do not).
    """

    FLOW_CAT = "p2p"

    def __init__(self, path: str, process_names: Optional[Mapping[int, str]] = None):
        self.path = path
        self.events: List[Dict] = []
        self.flow_events: List[Dict] = []
        self.process_names: Dict[int, str] = {
            int(k): str(v) for k, v in (process_names or {}).items()
        }
        self._seen_lanes: Dict[int, set] = {}  # pid -> {tid}

    @staticmethod
    def _lane(s: Span) -> int:
        tags = s.tags or {}
        if "stage" in tags:
            try:
                return int(tags["stage"]) + 1
            except (TypeError, ValueError):
                return 0
        return 0

    def __call__(self, spans: List[Span]) -> None:
        for s in spans:
            tid = self._lane(s)
            self._seen_lanes.setdefault(int(s.rank), set()).add(tid)
            self.events.append(
                {
                    "name": s.metric,
                    "ph": "X",
                    "ts": s.start * 1e6,
                    "dur": s.duration * 1e6,
                    "pid": s.rank,
                    "tid": tid,
                    "args": dict(s.tags or {}, step=s.step),
                }
            )
            tags = s.tags or {}
            roles = tags.get("flow_role")
            fids = tags.get("flow_id")
            if roles is None or fids is None:
                continue
            # a span may participate in SEVERAL flows (parallel lists):
            # e.g. a replica's serve-submit span is the recv end of the
            # router's dispatch arrow AND the send end of its own
            # submit->terminal arrow (fleettrace.assemble_fleet_timeline)
            if not isinstance(roles, (list, tuple)):
                roles, fids = [roles], [fids]
            for role, fid in zip(roles, fids):
                if role not in ("send", "recv"):
                    continue
                # flow start anchors at the send span's END, flow finish at
                # the recv span's START with bp="e" (bind to the enclosing
                # slice) — the arrow spans exactly the in-flight window
                self.flow_events.append(
                    {
                        "name": self.FLOW_CAT,
                        "cat": self.FLOW_CAT,
                        "ph": "s" if role == "send" else "f",
                        **({"bp": "e"} if role == "recv" else {}),
                        "id": fid,
                        "ts": (s.start + s.duration) * 1e6 if role == "send" else s.start * 1e6,
                        "pid": s.rank,
                        "tid": tid,
                    }
                )

    def _metadata_events(self) -> List[Dict]:
        out: List[Dict] = []
        for pid in sorted(self._seen_lanes):
            out.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "args": {"name": self.process_names.get(pid, f"rank {pid}")},
                }
            )
            for tid in sorted(self._seen_lanes[pid]):
                out.append(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "pid": pid,
                        "tid": tid,
                        "args": {"name": "host" if tid == 0 else f"stage {tid - 1}"},
                    }
                )
        return out

    def write(self) -> str:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        body = sorted(self.events + self.flow_events, key=lambda e: e["ts"])
        with open(self.path, "w") as f:
            json.dump(
                {
                    "traceEvents": self._metadata_events() + body,
                    "displayTimeUnit": "ms",
                },
                f,
            )
        return self.path


class LoggingHandler:
    def __init__(self, log_fn=print):
        self.log_fn = log_fn

    def __call__(self, spans: List[Span]) -> None:
        for s in spans:
            self.log_fn(
                f"[ndtimeline r{s.rank} step{s.step}] {s.metric}: {s.duration * 1e3:.3f} ms"
            )


class LocalRawHandler:
    """Appends spans to a local JSONL file (reference local_raw_handler.py)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def __call__(self, spans: List[Span]) -> None:
        with open(self.path, "a") as f:
            for s in spans:
                f.write(
                    json.dumps(
                        {
                            "metric": s.metric,
                            "start": s.start,
                            "duration": s.duration,
                            "step": s.step,
                            "rank": s.rank,
                            "tags": s.tags,
                        }
                    )
                    + "\n"
                )
