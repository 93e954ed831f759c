"""Exporters: Chrome-trace/Perfetto JSON timelines and JSONL logs.

``to_chrome_trace`` maps :class:`SpanRecord` rows onto the Chrome
Trace Event Format (complete events, ``ph: "X"``) that both
``chrome://tracing`` and https://ui.perfetto.dev render: ``ts``/``dur``
in microseconds, rebased so the earliest span starts at 0, one ``tid``
lane per trace (i.e. per multiply) so concurrent service requests
stack into separate rows.  Span attrs ride along in ``args`` together
with ``span_id``/``parent_id`` so the nesting survives the round trip.

``validate_chrome_trace`` is the schema check every trace is held to:
shape, required fields, and parent/child interval containment.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from .telemetry import SpanRecord

__all__ = [
    "to_chrome_trace", "write_chrome_trace", "validate_chrome_trace",
    "write_jsonl", "read_jsonl",
]

_US = 1e6  # seconds -> microseconds


def to_chrome_trace(spans: Sequence[SpanRecord], *,
                    process_name: str = "repro_torch") -> dict:
    """Build a Chrome-trace dict from span records."""
    spans = [s for s in spans if s.dur >= 0.0]
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t_base = min(s.t0 for s in spans)
    tids = {}
    events: List[dict] = [{
        "ph": "M", "pid": 0, "tid": 0, "name": "process_name",
        "args": {"name": process_name},
    }]
    for s in sorted(spans, key=lambda s: (s.trace_id, s.t0, s.span_id)):
        tid = tids.setdefault(s.trace_id, len(tids))
        args: Dict[str, object] = {"span_id": s.span_id}
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        for k, v in s.attrs.items():
            args[k] = v if isinstance(v, (int, float, str, bool,
                                          type(None))) else str(v)
        events.append({
            "ph": "X", "pid": 0, "tid": tid,
            "name": s.name, "cat": s.cat,
            "ts": (s.t0 - t_base) * _US, "dur": s.dur * _US,
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: Sequence[SpanRecord], *,
                       process_name: str = "repro_torch") -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_chrome_trace(spans, process_name=process_name), f)
    return path


def validate_chrome_trace(obj: object) -> List[str]:
    """Schema check; returns a list of errors (empty == valid).

    Checks the Trace Event Format invariants the viewers rely on plus
    our own: complete events carry name/cat/ts/dur/pid/tid, times are
    finite and non-negative, ``args.parent_id`` references an existing
    span on the same lane, and every child interval is contained in
    its parent's (1 us slack for float rounding).
    """
    errs: List[str] = []
    if not isinstance(obj, dict):
        return ["trace is not a JSON object"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    if not any(isinstance(e, dict) and e.get("ph") == "X" for e in events):
        errs.append("no complete ('X') events")
    by_id: Dict[object, dict] = {}
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            errs.append(f"event[{i}] is not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "M", "i", "I"):
            errs.append(f"event[{i}] has unsupported ph={ph!r}")
            continue
        if ph != "X":
            continue
        for field in ("name", "ts", "dur", "pid", "tid"):
            if field not in e:
                errs.append(f"event[{i}] missing {field!r}")
        name = e.get("name")
        if not isinstance(name, str) or not name:
            errs.append(f"event[{i}] name must be a non-empty string")
        for field in ("ts", "dur"):
            v = e.get(field)
            if not isinstance(v, (int, float)) or v != v or v < 0:
                errs.append(f"event[{i}] {field} must be a finite "
                            f"non-negative number, got {v!r}")
        args = e.get("args", {})
        if not isinstance(args, dict):
            errs.append(f"event[{i}] args must be an object")
            continue
        sid = args.get("span_id")
        if sid is not None:
            by_id[(e.get("tid"), sid)] = e
    # nesting: child interval inside parent's, on the same lane
    slack = 1.0  # us
    for (tid, sid), e in by_id.items():
        pid_ = e.get("args", {}).get("parent_id")
        if pid_ is None:
            continue
        parent = by_id.get((tid, pid_))
        if parent is None:
            errs.append(f"span {sid} references missing parent {pid_}")
            continue
        if e["ts"] < parent["ts"] - slack:
            errs.append(f"span {sid} starts before parent {pid_}")
        if (e["ts"] + e["dur"]) > (parent["ts"] + parent["dur"]) + slack:
            errs.append(f"span {sid} ends after parent {pid_}")
    return errs


def write_jsonl(path: str, rows: Sequence[dict], *, mode: str = "a") -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, mode) as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return path


def read_jsonl(path: str) -> List[dict]:
    rows: List[dict] = []
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows
