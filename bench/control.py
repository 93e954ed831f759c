"""Readings that the limits of ``correct`` are set from: the program's on
``--seeds`` and the cell's control's on ``--control-seeds``, each a short
window at the cell's own size and load, in one set-up (one spawn on a
process mesh).  The benchmark's own runs never run the control.

    python bench/control.py --workload square_b22.auto --seconds 2 \\
        --seeds 1 2 3 --control-seeds 4 5 6

The control is the traffic file's ``control``: the program with its own
lower-precision path switched on (``kwargs``), or the plain reference
computed in TF32 in the program's place (``reference: "tf32"``).  One
JSON line a run, then a summary: the lower reading (the largest of the
program's) and the upper (the smallest of the control's) of each number.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(name: str, seeds, control_seeds, seconds: float, *,
             device: str = "cuda", root=ROOT, backend=None) -> list:
    """One dict a run: ``seed``, ``control``, ``calls``, ``multiply_ms``
    and each compared number, the worst over ranks and kept calls."""
    from bench import harness

    spec = harness.cell_spec(name, root)
    runs = [{"seed": s, "seconds": seconds, "control": c}
            for c, group in ((False, seeds), (True, control_seeds))
            for s in group]
    ranks = harness.run_ranks_of(spec, runs, device, backend)
    out = []
    for i, run in enumerate(runs):
        per = [r[i] for r in ranks]
        row = {"seed": run["seed"], "control": run["control"],
               "calls": per[0]["calls"],
               "multiply_ms": 1e3 * per[0]["window_s"] / per[0]["calls"]}
        row.update({k: v["value"]
                    for k, v in harness.checks_of(spec, per).items()})
        out.append(row)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bench.run import use_checkout

    use_checkout()
    rows = readings(args.workload, args.seeds, args.control_seeds,
                    args.seconds)
    keys = [k for k in rows[0] if k not in ("seed", "control", "calls",
                                            "multiply_ms")]
    for row in rows:
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload}
    for key in keys:
        prog = [r[key] for r in rows if not r["control"]]
        ctl = [r[key] for r in rows if r["control"]]
        summary[key] = {"lower": max(prog) if prog else None,
                        "upper": min(ctl) if ctl else None}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
