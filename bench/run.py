"""Run one cell of ``BENCHMARK.json`` once on the card(s) of this machine.

    python bench/run.py --workload square_b22.auto --seed 7 --seconds 10 --trace 0

From the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; ``checks`` last, each number compared beside its limit,
which the last lines of standard error repeat.  Exits with no result
and a nonzero code where the cell's cards are not there, or where a
process of the run loaded JAX, Flax or the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def use_checkout() -> None:
    """Import the port and the package ``bench`` from this checkout (not
    the modules of this file's directory as top-level names), with one
    host thread a process: the load is steady and the same whatever the
    machine's core count.  Before numpy or torch is imported."""
    here = Path(__file__).resolve().parent
    sys.path[:] = [x for x in sys.path if Path(x or ".").resolve() != here]
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    os.environ.setdefault("USE_FLAX", "0")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    use_checkout()
    from bench import harness

    t_start = harness.process_start_wall()
    spec = harness.cell_spec(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {spec['chips']} CUDA device(s); this "
              f"machine has {have}", file=sys.stderr)
        return 3
    out, banned = harness.run_cell(args.workload, args.seed, args.seconds,
                                   bool(args.trace), root=ROOT,
                                   t_start=t_start)
    if banned:
        print(f"modules loaded that the benchmark must not load: {banned}",
              file=sys.stderr)
        return 4
    for name, sec in out.pop("runtime", []):
        print(f"host seconds in {name}: {sec!r}", file=sys.stderr)
    for key, c in out["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
