"""Blocked sparse tensor contraction — the 3-index RPA/THC workload the
DBCSR tensor extension exists for (arXiv:1910.13555), the port's
counterpart of ``examples/tensor_contraction.py``.

Post-Hartree-Fock methods (RPA, THC-scaled MP2) contract 3-index
integral tensors ``B[i,a,P]`` against 2-index transformation matrices
``M[P,Q]``.  The integral tensor is block-sparse with exponentially
decaying magnitude away from a diagonal locality band — the structure
DBCSR's norm-based filtering exploits.

This example builds that workload on a simulated 2x2 mesh and runs

    C[i,a,Q] = sum_P  B[i,a,P] * M[P,Q]

through ``dbcsr.contract("iaP,PQ->iaQ", ...)``:

  * the 3-index tensor is a ``DBCSRTensor`` with a per-block occupancy
    mask and Frobenius norms,
  * the planner enumerates every legal matricization, prices each with
    the lowered per-layout occupancy / imbalance and unfold/refold copy
    cost, and picks one (``explain()`` prints the layout table),
  * masks and norms lower through the unfold, so the 2D engine's eps
    filtering drops negligible-norm triples without seeing the N-d frame,
  * the result folds back to the 3-index output frame and is checked
    against a dense ``torch.einsum``.

    PYTHONPATH=src python -m repro_torch.examples.tensor_contraction \\
        [--device cpu] [--spec iaP,iaQ->PQ]

On the card (the default device) the blocked path runs the smm kernel
and the densified one ``torch.matmul``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import dbcsr
from repro_torch.core.blocking import GridSpec
from repro_torch.launch.mesh import make_mesh

# problem geometry: occupied x virtual x auxiliary basis (the JAX
# example's)
N_I, N_A, N_P = 32, 64, 128
BLOCKS = (8, 16, 16)
FILTER_EPS = 1e-8
DECAY = 30.0


def block_decay(nbi: int, nbp: int) -> np.ndarray:
    """(nbi, nbp) float64 block magnitudes ``exp(-DECAY * |i_blk/nbi -
    P_blk/nbp|)``: orbitals couple strongly only to spatially nearby
    auxiliary functions (the JAX example's formula)."""
    bi = np.arange(nbi)[:, None] / nbi
    bp = np.arange(nbp)[None, :] / nbp
    return np.exp(-DECAY * np.abs(bi - bp))


def integral_mask(scale: np.ndarray, nba: int) -> np.ndarray:
    """The (nbi, nba, nbp) block mask: blocks whose magnitude is above
    1e-6, the same for every a block."""
    return (scale > 1e-6)[:, None, :] * np.ones((1, nba, 1), dtype=bool)


def build_integral_tensor(rng, n_i: int = N_I, n_a: int = N_A,
                          n_p: int = N_P, blocks=BLOCKS):
    """3-index THC-style integral tensor with exponential block decay
    away from the (i, P) locality diagonal: the JAX example's formula
    (``examples/tensor_contraction.py``), at any size, from a numpy
    generator.  Returns the f32 payload and its block mask."""
    b_i, b_a, b_p = blocks
    data = rng.randn(n_i, n_a, n_p).astype(np.float32)
    scale = block_decay(n_i // b_i, n_p // b_p)          # (nbi, nbp)
    full = np.repeat(np.repeat(scale, b_i, 0), b_p, 1)   # (n_i, n_p)
    data *= full[:, None, :]
    return data, integral_mask(scale, n_a // b_a)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--spec", default="iaP,PQ->iaQ",
                    choices=["iaP,PQ->iaQ", "iaP,iaQ->PQ"])
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((2, 2), ("data", "model"), device=args.device)
    grid = GridSpec("data", "model")
    rng = np.random.RandomState(0)

    data, mask = build_integral_tensor(rng)
    B = dbcsr.create_tensor(data, mesh=mesh, grid=grid, block_sizes=BLOCKS,
                            block_mask=mask, compute_norms=True)
    print(f"integral tensor  {B.shape}  blocks {B.block_sizes}  "
          f"occupancy {B.occupancy:.1%}")
    if args.spec == "iaP,PQ->iaQ":
        other = dbcsr.create_tensor(
            rng.randn(N_P, N_P).astype(np.float32), mesh=mesh, grid=grid,
            block_sizes=(BLOCKS[2], BLOCKS[2]))
    else:
        other = B  # RPA's Pi-matrix build: B contracted with itself

    C, plan = dbcsr.contract(args.spec, B, other, mesh=mesh,
                             filter_eps=FILTER_EPS, return_plan=True)
    print()
    print(plan.explain())
    print()
    print(f"chosen matricization: {plan.layout}  "
          f"(algorithm {plan.algorithm}, "
          f"{'densified' if plan.densify else 'blocked'})")

    oracle = torch.einsum(args.spec, B.data, other.data)
    err = float((C.data - oracle).abs().max())
    scale = float(oracle.abs().max())
    print(f"result {C.shape}  occupancy {C.occupancy:.1%}  "
          f"max |err| vs dense einsum = {err:.3g} (scale {scale:.3g})")
    assert err < 1e-4 * max(scale, 1.0), "contract deviates from einsum"
    print("OK: contraction matches the dense einsum oracle")


if __name__ == "__main__":
    main()
