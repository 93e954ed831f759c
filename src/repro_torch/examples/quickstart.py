"""Quickstart: a DBCSR-style distributed multiply in a few lines, the
port's counterpart of ``examples/quickstart.py``.

Creates two 1,024^2 matrices on a 4x4 process grid, multiplies them
through ``dbcsr.multiply`` (the planner picks the algorithm and the
local path) and prints the largest difference from ``torch.matmul``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

runs the 16 ranks in this process, on the card by default.  Started by
``torchrun``, every process is one rank of a process mesh (a
square-ish grid of the world size):

    PYTHONPATH=src torchrun --nproc-per-node 4 \\
        -m repro_torch.examples.quickstart --device cpu

(gloo on the CPU; on one card the four processes share it over
host-staged gloo, on four cards NCCL takes one a rank).
"""
from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

from repro_torch.core import dbcsr
from repro_torch.core.blocking import GridSpec
from repro_torch.launch.processes import launched, make_launch_mesh


def grid_shape():
    """4x4 alone, else a square-ish grid of the launcher's world size."""
    if not launched():
        return 4, 4
    world = int(os.environ["WORLD_SIZE"])
    rows = int(math.isqrt(world))
    while world % rows:
        rows -= 1
    return rows, world // rows


def ieee_matmul(a, b):
    """The yardstick: ``torch.matmul`` in IEEE f32 (TF32 off)."""
    flags = torch.backends.cuda.matmul
    caller, flags.allow_tf32 = flags.allow_tf32, False
    try:
        return torch.matmul(a, b)
    finally:
        flags.allow_tf32 = caller


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=1024)
    args = ap.parse_args(argv)

    mesh = make_launch_mesh(grid_shape(), ("data", "model"),
                            device=args.device)
    grid = GridSpec(row_axis="data", col_axis="model")
    rng = np.random.RandomState(0)     # the same operands on every rank
    n = args.n
    A = rng.randn(n, n).astype(np.float32)
    B = rng.randn(n, n).astype(np.float32)

    # create: the library owns the distribution (block-cyclic a la
    # ScaLAPACK; block size 64 like the paper's large-block case)
    Am = dbcsr.create(A, mesh=mesh, grid=grid, block_size=64)
    Bm = dbcsr.create(B, mesh=mesh, grid=grid, block_size=64)
    # multiply: 'auto' asks the planner for the algorithm and local path
    Cm, plan = dbcsr.multiply(Am, Bm, mesh=mesh, algorithm="auto",
                              return_plan=True)

    err = float((Cm.data - ieee_matmul(Am.data, Bm.data)).abs().max())
    if getattr(mesh, "rank", 0) == 0:
        print(f"C = A @ B on {mesh!r}: {plan.algorithm}, "
              f"{'densified' if plan.densify else 'blocked'}; max err "
              f"against torch.matmul {err:.2e}")
        print(f"occupancy: {Cm.occupancy:.0%}, blocks: "
              f"{Cm.layout.nblock_rows}x{Cm.layout.nblock_cols} "
              f"of {Cm.layout.block_rows}x{Cm.layout.block_cols}")
    if err >= 1e-3:
        raise SystemExit(f"max err {err:.2e} >= 1e-3")
    if getattr(mesh, "rank", 0) == 0:
        print("OK")


if __name__ == "__main__":
    main()
