"""Report rendering + the ``python -m repro_torch.obs report`` CLI.

Consumes the JSONL logs a traced run leaves behind
(``events.jsonl`` + ``plan_outcomes.jsonl`` under ``--dir``) and
renders the two views the paper's evidence needs:

  breakdown   comm-vs-compute-vs-verify wall-time split, summed over
              span categories (plan / comm / compute / verify /
              repair) across all recorded multiplies
  scoreboard  predicted-vs-actual planner cost per algorithm

``render_timeline`` prints one trace as an indented tree — the same
nesting the Chrome-trace export shows graphically.
"""
from __future__ import annotations

import argparse
import collections
import os
from typing import Dict, List, Optional, Sequence

from .telemetry import SpanRecord, EVENTS_LOG, PLAN_OUTCOMES_LOG
from .export import read_jsonl
from .scoreboard import planner_scoreboard, render_scoreboard

__all__ = ["category_breakdown", "render_breakdown", "render_timeline",
           "main"]

# categories whose spans are mutually exclusive slices of a dispatch
# ("matricize" = the tensor subsystem's unfold/refold phases under a
# contract root — disjoint from the nested multiply's own phases)
_PHASE_CATS = ("plan", "matricize", "comm", "compute", "verify", "repair")


def category_breakdown(spans: Sequence[SpanRecord]) -> Dict[str, float]:
    """Total seconds per span category.

    ``comm``/``compute`` are the synthetic schedule-step children of a
    dispatch (model-weighted slices of the measured wall time), so
    comm + compute ~= dispatch.  ``verify`` is reported *exclusive* of
    nested repair re-execution — a repaired multiply shows its second
    dispatch under ``repair``, not double-counted under ``verify``.
    """
    by_id = {s.span_id: s for s in spans}
    out: Dict[str, float] = collections.defaultdict(float)
    for s in spans:
        if s.dur < 0 or s.cat not in _PHASE_CATS:
            continue
        out[s.cat] += s.dur
    # make verify exclusive of its repair children
    for s in spans:
        if s.cat != "repair" or s.dur < 0:
            continue
        parent = by_id.get(s.parent_id)
        if parent is not None and parent.cat == "verify":
            out["verify"] -= s.dur
    roots = [s for s in spans if s.parent_id is None and s.dur >= 0]
    out["total"] = sum(s.dur for s in roots)
    return dict(out)


def render_breakdown(spans: Sequence[SpanRecord]) -> str:
    bd = category_breakdown(spans)
    total = bd.get("total", 0.0)
    lines = ["where the time went (all recorded multiplies):"]
    for cat in _PHASE_CATS:
        if cat not in bd:
            continue
        frac = bd[cat] / total if total > 0 else 0.0
        lines.append(f"  {cat:<8} {bd[cat]*1e3:9.2f} ms  {frac:6.1%}")
    lines.append(f"  {'total':<8} {total*1e3:9.2f} ms")
    return "\n".join(lines)


def render_timeline(spans: Sequence[SpanRecord], *,
                    max_steps: int = 6) -> str:
    """One trace as an indented tree (collapses long step runs)."""
    spans = [s for s in spans if s.dur >= 0]
    if not spans:
        return "(empty trace)"
    children: Dict[Optional[int], List[SpanRecord]] = \
        collections.defaultdict(list)
    for s in spans:
        children[s.parent_id].append(s)
    for v in children.values():
        v.sort(key=lambda s: (s.t0, s.span_id))
    lines: List[str] = []

    def _attrs(s: SpanRecord) -> str:
        keys = ("algorithm", "comm_bytes", "flops", "occupancy",
                "rank_imbalance", "skipped", "detected", "repaired")
        parts = [f"{k}={s.attrs[k]}" for k in keys
                 if s.attrs.get(k) is not None]
        return ("  [" + " ".join(parts) + "]") if parts else ""

    def _walk(parent_id: Optional[int], depth: int) -> None:
        kids = children.get(parent_id, [])
        steps = [s for s in kids if s.cat == "schedule-step"]
        shown = kids
        if len(steps) > max_steps:
            keep = set(id(s) for s in steps[:max_steps // 2]
                       ) | set(id(s) for s in steps[-max_steps // 2:])
            shown = [s for s in kids
                     if s.cat != "schedule-step" or id(s) in keep]
        n_hidden = len(kids) - len(shown)
        for s in shown:
            lines.append(f"{'  ' * depth}{s.name:<20} "
                         f"{s.dur*1e3:9.3f} ms{_attrs(s)}")
            _walk(s.span_id, depth + 1)
        if n_hidden > 0:
            lines.append(f"{'  ' * depth}... ({n_hidden} more steps)")

    roots = children.get(None, [])
    for root in roots:
        lines.append(f"{root.name:<20} {root.dur*1e3:9.3f} ms"
                     f"{_attrs(root)}")
        _walk(root.span_id, 1)
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs report",
        description="Render the comm/compute/verify breakdown and the "
                    "planner predicted-vs-actual scoreboard from a "
                    "traced run's JSONL logs.")
    ap.add_argument("--dir", default=os.path.join("artifacts", "obs"),
                    help="log directory passed to obs.enable(log_dir=...)")
    ap.add_argument("--timeline", action="store_true",
                    help="also print the last trace as a tree")
    args = ap.parse_args(argv)

    events = read_jsonl(os.path.join(args.dir, EVENTS_LOG))
    outcomes = read_jsonl(os.path.join(args.dir, PLAN_OUTCOMES_LOG))
    if not events and not outcomes:
        print(f"no telemetry logs under {args.dir!r} — run with "
              f"obs.enable(log_dir={args.dir!r}) first")
        return 1
    spans = [SpanRecord.from_dict(d) for d in events]
    n_traces = len({s.trace_id for s in spans})
    print(f"{len(spans)} spans over {n_traces} traces, "
          f"{len(outcomes)} plan outcomes from {args.dir}")
    if spans:
        print()
        print(render_breakdown(spans))
        if args.timeline:
            last_tid = max(s.trace_id for s in spans)
            print()
            print(render_timeline([s for s in spans
                                   if s.trace_id == last_tid]))
    if outcomes:
        print()
        print("planner scoreboard (predicted vs measured, signed "
              "rel err = (pred-meas)/meas):")
        print(render_scoreboard(planner_scoreboard(outcomes)))
    return 0
