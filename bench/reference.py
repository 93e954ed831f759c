"""The plain reference of a multiply, and the comparison that decides
``correct``.  Plain PyTorch and NumPy: it imports nothing of the port and
takes nothing the port made; it works the product and its block support
out again from the operands the benchmark drew.

``product_f64`` is the reference: C = A @ B in float64, in blocks of
rows.  ``tf32_product`` is the reference put in the program's place one
precision below the configuration's float32, TF32: each operand rounded
to TF32's 10 mantissa bits (to nearest, ties to even), the products
summed in IEEE float32.  It is the control of a cell whose program has
no TF32 path of its own.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

ROWS = 2048   # rows of the product a block of the reference computes


def expand_mask(mask: np.ndarray, block: int, like: torch.Tensor
                ) -> torch.Tensor:
    full = np.repeat(np.repeat(np.asarray(mask, bool), block, 0), block, 1)
    return torch.as_tensor(full, device=like.device).to(like.dtype)


def masked(x: torch.Tensor, mask: Optional[np.ndarray], block: int
           ) -> torch.Tensor:
    """``x`` with the blocks ``mask`` declares absent set to zero."""
    return x if mask is None else x * expand_mask(mask, block, x)


def product_mask(a_mask: Optional[np.ndarray], b_mask: Optional[np.ndarray],
                 nm: int, nk: int, nn: int) -> np.ndarray:
    """The symbolic block support of A @ B, ``(nm, nn)`` bool: a block of
    C is present where some k has both A's and B's blocks present."""
    am = (np.ones((nm, nk), np.int64) if a_mask is None
          else np.asarray(a_mask, np.int64))
    bm = (np.ones((nk, nn), np.int64) if b_mask is None
          else np.asarray(b_mask, np.int64))
    return (am @ bm) > 0


def product_f64(a: torch.Tensor, b: torch.Tensor, rows: int = ROWS
                ) -> torch.Tensor:
    """A @ B in float64, ``rows`` rows of the product at a time."""
    b64 = b.to(torch.float64)
    out = torch.empty(a.shape[0], b.shape[1], dtype=torch.float64,
                      device=a.device)
    for i in range(0, a.shape[0], rows):
        out[i:i + rows] = a[i:i + rows].to(torch.float64) @ b64
    return out


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (1 sign, 8 exponent and 10 mantissa
    bits), to nearest with ties to even; finite inputs of moderate size."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    keep = (bits >> 13) & 1
    bits = (bits + 0xFFF + keep) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32)


def tf32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B from TF32-rounded operands, summed in IEEE float32."""
    flags = torch.backends.cuda.matmul
    caller = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        return round_tf32(a) @ round_tf32(b)
    finally:
        flags.allow_tf32 = caller


def compare(c: torch.Tensor, c_mask: Optional[np.ndarray],
            ref: torch.Tensor, ref_mask: np.ndarray,
            rows: int = ROWS) -> dict:
    """The numbers ``correct`` is decided by, of one product:
    ``rel_err``, max |C - R| / max |R| (float64), and ``mask_mismatch``,
    the blocks where C's support (None: every block) and the reference's
    differ.  A product of another shape reads ``inf``."""
    if tuple(c.shape) != tuple(ref.shape):
        return {"rel_err": float("inf"), "mask_mismatch": float("inf")}
    worst = 0.0
    for i in range(0, ref.shape[0], rows):
        d = float((c[i:i + rows].to(torch.float64)
                   - ref[i:i + rows]).abs().max())
        worst = float("inf") if d != d else max(worst, d)   # NaN fails
    scale = float(ref.abs().max())
    rel = worst / scale if scale > 0 else worst
    got = (np.ones_like(ref_mask) if c_mask is None
           else np.asarray(c_mask, bool))
    mismatch = (float(np.count_nonzero(got != ref_mask))
                if got.shape == ref_mask.shape else float("inf"))
    return {"rel_err": rel, "mask_mismatch": mismatch}
