"""The paper's two benchmark workloads end to end, the port's
counterpart of ``examples/distributed_matmul.py``:

  * square multiplication  -> the planner's pick (Cannon-class),
  * tall-and-skinny        -> the O(1)-communication algorithm,

with the SUMMA (ScaLAPACK PDGEMM analogue) baseline timed beside each,
one traced run's span timeline and the planner's scoreboard.

    PYTHONPATH=src python -m repro_torch.examples.distributed_matmul \\
        [--device cpu]

runs a 4x4 mesh in this process, on the card by default.  Started by
``torchrun``, every process is one rank of a process mesh (a
square-ish grid of the world size, as in ``quickstart.py``); rank 0
prints.  Times are host-clock milliseconds
of synchronized calls (best of 3 after a warm-up) on the device named.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.blocking import GridSpec
from repro_torch.core.multiply import distributed_matmul
from repro_torch.core.tall_skinny import classify_shape
from repro_torch.examples.quickstart import grid_shape, ieee_matmul
from repro_torch.launch.processes import make_launch_mesh
from repro_torch.planner import plan_multiply


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--square", type=int, default=1408)
    ap.add_argument("--tall", type=int, nargs=2, default=(352, 45056),
                    metavar=("M", "K"), help="M = N and K of the "
                    "tall-and-skinny product")
    args = ap.parse_args(argv)

    mesh = make_launch_mesh(grid_shape(), ("data", "model"),
                            device=args.device)
    grid = GridSpec("data", "model")
    lead = getattr(mesh, "rank", 0) == 0
    say = print if lead else (lambda *a, **k: None)
    dev = mesh.device
    shape = (mesh.shape["data"], mesh.shape["model"])
    rng = np.random.RandomState(0)     # the same operands on every rank

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(tag, fn):
        out = fn()
        sync()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            sync()
            best = min(best, time.perf_counter() - t0)
        say(f"  {tag:34s} {best * 1e3:9.2f} ms")
        return out, best

    def operands(m, k, n):
        return (torch.tensor(rng.randn(m, k).astype(np.float32), device=dev),
                torch.tensor(rng.randn(k, n).astype(np.float32), device=dev))

    def check(tag, c, a, b):
        ref = ieee_matmul(a, b)
        err = float((c - ref).abs().max() / ref.abs().max())
        say(f"  {tag}: max err / max|C| against torch.matmul {err:.2e}")
        if err >= 1e-4:   # f32 sums in two orders: ~sqrt(k) * 2**-24
            raise SystemExit(f"{tag}: max err / max|C| {err:.2e}")

    say(f"on {mesh!r}")
    say("== square multiplication (paper: 63,360^3; scaled) ==")
    n = args.square
    a, b = operands(n, n, n)
    say(plan_multiply(n, n, n, mesh_shape=shape).explain())
    # one traced run: the telemetry layer turns the schedule's metadata
    # into a span timeline and a Chrome trace (rank 0 only)
    if lead:
        obs.enable(log_dir="artifacts/obs")
    distributed_matmul(a, b, mesh=mesh, grid=grid)
    if lead:
        trace = obs.last_trace()
        obs.write_chrome_trace("artifacts/obs/multiply_trace.json", trace)
        say("  trace timeline (full trace -> "
            "artifacts/obs/multiply_trace.json):")
        say(obs.render_timeline(trace))
        say(obs.render_breakdown(trace))
        obs.disable()   # the timed calls below run untraced
    c1, t_auto = timed("auto (planner)",
                       lambda: distributed_matmul(a, b, mesh=mesh, grid=grid))
    c2, t_summa = timed("SUMMA (PDGEMM baseline)",
                        lambda: distributed_matmul(a, b, mesh=mesh, grid=grid,
                                                   algorithm="summa"))
    check("auto", c1, a, b)
    check("SUMMA", c2, a, b)
    say(f"  speedup vs PDGEMM: {t_summa / t_auto:.2f}x")

    say("== tall-and-skinny (paper: 1,408 x 1,982,464; scaled) ==")
    m, k = args.tall
    a, b = operands(m, k, m)
    say(f"  shape-only classification: {classify_shape(m, k, m)}")
    say(plan_multiply(m, k, m, mesh_shape=shape).explain())
    c3, t_ts = timed("auto (planner)",
                     lambda: distributed_matmul(a, b, mesh=mesh, grid=grid))
    c4, t_sm = timed("SUMMA (PDGEMM baseline)",
                     lambda: distributed_matmul(a, b, mesh=mesh, grid=grid,
                                                algorithm="summa"))
    check("auto", c3, a, b)
    check("SUMMA", c4, a, b)
    say(f"  speedup vs PDGEMM: {t_sm / t_ts:.2f}x  "
        "(paper reports up to 2.5x on this shape)")

    # a traced tall-skinny run logs the planner's predicted cost beside
    # the measured dispatch (artifacts/obs/plan_outcomes.jsonl)
    if lead:
        obs.enable(log_dir="artifacts/obs", reset=False)
    distributed_matmul(a, b, mesh=mesh, grid=grid)
    if lead:
        obs.disable()
        say("== planner scoreboard (predicted vs measured) ==")
        say(obs.render_scoreboard(obs.planner_scoreboard(
            obs.plan_outcomes())))


if __name__ == "__main__":
    main()
