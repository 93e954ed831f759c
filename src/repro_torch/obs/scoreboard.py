"""Planner scoreboard: predicted-vs-actual cost per executed plan.

Each :func:`repro_torch.obs.record_plan_outcome` row carries the cost
model's ``predicted_s`` and the measured dispatch ``measured_s`` for
one executed multiply.  The scoreboard aggregates them per algorithm
into absolute and *signed* relative error

    rel_err = (predicted_s - measured_s) / measured_s

(positive = the model overpredicts, negative = underpredicts), which
is what ``planner.calibrate --check-drift`` thresholds on: a cost
model whose median |rel_err| drifts past ~1x no longer ranks
candidates reliably on this machine and needs recalibration.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

__all__ = ["planner_scoreboard", "render_scoreboard", "check_drift"]


def _median(vals: Sequence[float]) -> float:
    if not vals:
        return float("nan")
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def planner_scoreboard(records: Sequence[dict]) -> Dict[str, dict]:
    """Aggregate plan-outcome rows into per-algorithm error stats.

    Rows must carry ``algorithm``, ``predicted_s`` and ``measured_s``;
    rows with non-positive measurements are skipped (a plan whose
    dispatch never ran carries no signal).

    Rows are grouped by their root-span KIND, not just by algorithm:
    plain ``multiply``/``multiply_batched`` rows keep the bare
    algorithm as their group key (the schema ``calibrate
    --check-drift`` has always thresholded on), while other roots —
    e.g. ``contract`` rows, whose end-to-end measurement includes the
    unfold/refold copies their plan also prices — group under
    ``"<kind>:<algorithm>"`` so their different cost structure never
    pollutes the 2D algorithms' drift statistics.
    """
    by_algo: Dict[str, List[dict]] = {}
    for r in records:
        algo = r.get("algorithm")
        pred = r.get("predicted_s")
        meas = r.get("measured_s")
        if not algo or pred is None or meas is None:
            continue
        kind = r.get("kind")
        if kind not in (None, "multiply", "multiply_batched"):
            algo = f"{kind}:{algo}"
        pred, meas = float(pred), float(meas)
        if meas <= 0.0 or not math.isfinite(pred) or not math.isfinite(meas):
            continue
        by_algo.setdefault(str(algo), []).append(
            {"predicted_s": pred, "measured_s": meas,
             "abs_err_s": abs(pred - meas),
             "rel_err": (pred - meas) / meas})
    out: Dict[str, dict] = {}
    for algo, rows in sorted(by_algo.items()):
        rel = [r["rel_err"] for r in rows]
        out[algo] = {
            "n": len(rows),
            "predicted_total_s": sum(r["predicted_s"] for r in rows),
            "measured_total_s": sum(r["measured_s"] for r in rows),
            "abs_err_median_s": _median([r["abs_err_s"] for r in rows]),
            "rel_err_median": _median(rel),
            "rel_err_mean": sum(rel) / len(rel),
            "abs_rel_err_median": _median([abs(e) for e in rel]),
        }
    return out


def render_scoreboard(sb: Dict[str, dict]) -> str:
    """Fixed-width table of the per-algorithm scoreboard."""
    if not sb:
        return "planner scoreboard: no recorded plan outcomes"
    lines = [
        f"{'algorithm':<16} {'n':>4} {'predicted':>11} {'measured':>11} "
        f"{'abs err med':>11} {'rel err med':>11}",
    ]
    for algo, row in sb.items():
        lines.append(
            f"{algo:<16} {row['n']:>4} "
            f"{row['predicted_total_s']*1e3:>9.2f}ms "
            f"{row['measured_total_s']*1e3:>9.2f}ms "
            f"{row['abs_err_median_s']*1e3:>9.3f}ms "
            f"{row['rel_err_median']:>+10.1%}")
    return "\n".join(lines)


def check_drift(records: Sequence[dict], *, threshold: float = 1.0,
                min_samples: int = 1) -> dict:
    """Flag algorithms whose median |relative error| exceeds
    ``threshold``.  Returns ``{"ok", "flagged", "scoreboard",
    "threshold"}``; algorithms with fewer than ``min_samples``
    outcomes are reported but never flagged (not enough signal)."""
    sb = planner_scoreboard(records)
    flagged = {}
    for algo, row in sb.items():
        err = row["abs_rel_err_median"]
        if row["n"] >= min_samples and err > threshold:
            flagged[algo] = err
    return {"ok": not flagged, "flagged": flagged, "scoreboard": sb,
            "threshold": threshold}
