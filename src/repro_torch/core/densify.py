"""Densification — the paper's core optimization (section III).

DBCSR stores operands as many small blocks.  For *dense* inputs the
blocks are coalesced ("densified") into one large dense block, so the
local multiply becomes a single large GEMM, at the cost of the
densify/undensify copies.  This module provides the layout transforms
plus the two local-multiply strategies the Cannon schedule calls:

  * ``densified_local_matmul`` — one big GEMM: ``torch.matmul`` (the
    vendor GEMM, as the JAX package leaves it to XLA's dot) or, with
    ``kernel="pallas"``, the hand-written tiled_matmul CUDA kernel.
  * ``grouped_densified_local_matmul`` — its twin for a fused product
    batch ``(G, m, k) @ (G, k, n)``: ``torch.bmm`` or, with
    ``kernel="pallas"``, the hand-written grouped_gemm CUDA kernel.
  * ``blocked_local_matmul``   — keep blocks, run the stack plans
    through the smm kernel (LIBCUSMM analogue) or its plain version.

Every local multiply takes the schedule's rank-stacked operands (the
mesh's leading rank axis, launch/mesh.py) and returns the rank-stacked
product.  On a 1x1 mesh (R = 1) it makes the call it makes for one
product, so the bits are those of a multiply without a rank axis.  On R
> 1 ranks the densified path is one batched call over the ranks: one
``torch.matmul`` (batched cuBLAS) or, with ``kernel="pallas"``, ONE
grouped_gemm launch a step (product r bitwise ``tiled_matmul`` of rank
r's operands: one GEMM body, one summation order).  The blocked path
launches the step's one plan once per rank (core/engine.py).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import obs
from .precision import f32_gemm, resolve_precision

__all__ = [
    "to_blocks",
    "from_blocks",
    "to_blocks_batched",
    "from_blocks_batched",
    "densify",
    "undensify",
    "blocked_local_matmul",
    "densified_local_matmul",
    "grouped_densified_local_matmul",
    "kernel_operand",
]


def kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """An operand as the hand-written kernels take it: float32 and
    bfloat16 as they are, float16 widened to float32 (exactly).  The
    reference's kernels take float16 and accumulate in f32; the result
    is cast back to the operands' type after the local multiply."""
    return x.to(torch.float32) if x.dtype == torch.float16 else x


def to_blocks(x: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """(R, C) -> contiguous (nbr*nbc, bm, bn) stacked blocks, row-major
    block order: the 'blocked' storage of a dense matrix."""
    r, c = x.shape
    if r % bm or c % bn:
        raise ValueError(f"shape {tuple(x.shape)} not divisible by block ({bm},{bn})")
    nbr, nbc = r // bm, c // bn
    return (x.reshape(nbr, bm, nbc, bn).permute(0, 2, 1, 3)
            .reshape(nbr * nbc, bm, bn).contiguous())


def from_blocks(blocks: torch.Tensor, nbr: int, nbc: int) -> torch.Tensor:
    """Inverse of to_blocks."""
    _, bm, bn = blocks.shape
    return (blocks.reshape(nbr, nbc, bm, bn).permute(0, 2, 1, 3)
            .reshape(nbr * bm, nbc * bn))


def to_blocks_batched(x: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """(G, R, C) -> contiguous (G, nbr*nbc, bm, bn): ``to_blocks`` over a
    leading product/group dimension (the fused batched multiply's
    payload)."""
    g, r, c = x.shape
    if r % bm or c % bn:
        raise ValueError(f"shape {tuple(x.shape)} not divisible by block ({bm},{bn})")
    nbr, nbc = r // bm, c // bn
    return (x.reshape(g, nbr, bm, nbc, bn).permute(0, 1, 3, 2, 4)
            .reshape(g, nbr * nbc, bm, bn).contiguous())


def from_blocks_batched(blocks: torch.Tensor, nbr: int, nbc: int) -> torch.Tensor:
    """Inverse of to_blocks_batched."""
    g, _, bm, bn = blocks.shape
    return (blocks.reshape(g, nbr, nbc, bm, bn).permute(0, 1, 3, 2, 4)
            .reshape(g, nbr * bm, nbc * bn))


def densify(blocks: torch.Tensor, nbr: int, nbc: int) -> torch.Tensor:
    """Coalesce a blocked payload into one dense block (paper eq. 1/2)."""
    return from_blocks(blocks, nbr, nbc)


def undensify(dense: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """Decompose the densified C back into the original block sizes."""
    return to_blocks(dense, bm, bn)


def _over_ranks(single, stacked):
    """A local multiply over the rank axis: ``single`` on the one rank
    of a 1x1 mesh, ``stacked`` on all R ranks at once."""

    def f(a, b):
        if a.shape[0] == 1:
            return single(a[0], b[0]).unsqueeze(0)
        return stacked(a, b)

    return f


def _grouped_gemm_over(a, b, ranges: bool = False):
    """grouped_gemm over every leading dimension of ``a`` and ``b``
    (ranks, then products): ONE launch.  ``ranges``: the operands'
    copies and the launch as ``dbcsr.pack`` / ``dbcsr.launch``."""
    from ..kernels.grouped_gemm.ops import grouped_gemm

    lead = tuple(a.shape[:-2])
    with obs.maybe_range(ranges, "pack"):
        a3 = (kernel_operand(a).reshape((-1,) + tuple(a.shape[-2:]))
              .contiguous())
        b3 = (kernel_operand(b).reshape((-1,) + tuple(b.shape[-2:]))
              .contiguous())
    with obs.maybe_range(ranges, "launch"):
        out = grouped_gemm(a3, b3)
    return out.reshape(lead + tuple(out.shape[-2:]))


def densified_local_matmul(precision=None, kernel: Optional[str] = None,
                           *, ranges: bool = False):
    """Local multiply for the densified path: one large GEMM in f32.

    kernel=None     -> torch.matmul (the vendor GEMM) at ``precision``
                       (``core.precision``: None or "highest" IEEE f32,
                       "high" TF32, "default" one bf16 pass, on the
                       card; IEEE f32 on the CPU, as XLA's CPU dot).  The
                       caller's float32 matmul settings are restored
                       after the call, so TF32 is never a default.
                       ``precision=None`` departs from the JAX
                       signature's ``Precision.DEFAULT`` (module
                       docstring of ``core.precision``).
    kernel='pallas' -> the tiled_matmul CUDA kernel (the JAX package's
                       Pallas tiled matmul), f32 out; on R > 1 ranks one
                       grouped_gemm launch over the ranks.  It ignores
                       ``precision``, as the Pallas kernel does.
    Any other value takes the default, as the JAX package does.  A
    ``precision`` that is not one of the names raises ``ValueError``.
    ``ranges`` (the caller's ``obs.ranging()``) marks the operands'
    copies as ``dbcsr.pack`` and the GEMM as ``dbcsr.launch``.
    """
    resolve_precision(precision)
    if kernel == "pallas":
        from ..kernels.tiled_matmul.ops import tiled_matmul

        def single(a, b):
            with obs.maybe_range(ranges, "pack"):
                a, b = (kernel_operand(a).contiguous(),
                        kernel_operand(b).contiguous())
            with obs.maybe_range(ranges, "launch"):
                return tiled_matmul(a, b)

        return _over_ranks(
            single, lambda a, b: _grouped_gemm_over(a, b, ranges))

    def f(a, b):
        with obs.maybe_range(ranges, "launch"):
            return f32_gemm(a, b, precision)

    return _over_ranks(f, f)


def grouped_densified_local_matmul(precision=None,
                                   kernel: Optional[str] = None):
    """Local multiply for the densified path of a fused product batch:
    one grouped GEMM over ``(G, ml, kl) @ (G, kl, nl)``, f32 out.

    kernel=None     -> torch.bmm in f32 (the vendor GEMM, as the JAX
                       package leaves it to XLA's dot_general) at
                       ``precision`` as in ``densified_local_matmul``; at
                       None it is the grouped_gemm kernel's plain
                       version, ``grouped_gemm_ref``, bit for bit.
    kernel='pallas' -> the grouped_gemm CUDA kernel (the JAX package's
                       Pallas grouped GEMM): one launch for all G
                       products (of all R ranks); it ignores
                       ``precision``.
    Any other value takes the default, as the JAX package does.
    """
    resolve_precision(precision)
    if kernel == "pallas":
        from ..kernels.grouped_gemm.ops import grouped_gemm

        def single(a, b):
            return grouped_gemm(kernel_operand(a).contiguous(),
                                kernel_operand(b).contiguous())

        return _over_ranks(single, _grouped_gemm_over)

    def grouped(a, b):
        return f32_gemm(a, b, precision, op=torch.bmm)

    def stacked(a, b):
        lead = tuple(a.shape[:-2])
        out = grouped(a.reshape((-1,) + tuple(a.shape[-2:])),
                      b.reshape((-1,) + tuple(b.shape[-2:])))
        return out.reshape(lead + tuple(out.shape[-2:]))

    return _over_ranks(grouped, stacked)


def blocked_local_matmul(
    m: int,
    k: int,
    n: int,
    *,
    block_m: int,
    block_k: int,
    block_n: int,
    stack_size: Optional[int] = None,
    align: Optional[bool] = None,
    kernel: str = "smm",
    a_mask=None,
    b_mask=None,
    pair_mask=None,
    a_norms=None,
    b_norms=None,
    pair_norms=None,
    filter_eps: Optional[float] = None,
    stack_bins: Optional[int] = None,
    ranges: bool = False,
):
    """Local multiply for the blocked path: the fused stack executor
    (core/engine.py), one memoized plan per geometry and mask/norm
    fingerprint, one smm launch per stack-size bin and rank.

    kernel='smm'  -> the CUDA smm kernel (its plain version on the CPU)
    kernel='ref'  -> the plain PyTorch version on any device

    ``ranges``: the executor's host ranges (``stack_executor``).
    """
    from .engine import stack_executor

    return stack_executor(
        m, k, n, block_m=block_m, block_k=block_k, block_n=block_n,
        stack_size=stack_size, align=align, kernel=kernel,
        a_mask=a_mask, b_mask=b_mask, pair_mask=pair_mask,
        a_norms=a_norms, b_norms=b_norms, pair_norms=pair_norms,
        filter_eps=filter_eps, stack_bins=stack_bins, ranges=ranges,
    )
