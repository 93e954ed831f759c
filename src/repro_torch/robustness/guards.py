"""Cheap tripwires and structural validation for the multiply stack.

Two kinds of defense live here:

* **Structural validation** (``validate_matrix`` /
  ``validate_multiply_request``): host-side checks of block geometry,
  grid compatibility, and mask/norm-cache consistency that raise a
  *typed* ``DbcsrValidationError`` subclass with a readable message,
  instead of a shape mismatch deep inside the multiply after the bad
  request was accepted.  The batched service runs these at ``submit()``
  time so a malformed request is rejected synchronously.

* **Finite tripwires** (``all_finite`` / ``assert_finite``): one
  ``torch.isfinite(x).all()`` reduction on the payload's device, used to
  screen results before ticket delivery.  A NaN that enters a
  purification loop is amplified forever; one reduction per multiply is
  cheap insurance.

Exception taxonomy (the JAX package's)::

    DbcsrValidationError(ValueError)
      +-- ShapeMismatchError      payload/layout/inner-dim/block geometry
      +-- GridMismatchError       operands live on incompatible grids
      +-- MaskConsistencyError    block_mask shape/dtype vs layout
      +-- NormConsistencyError    block_norms shape/negativity/NaN
      +-- NonFiniteOperandError   NaN/Inf in an input payload
      +-- NonFiniteResultError    NaN/Inf in a computed result
    CorruptionDetectedError(RuntimeError)   ABFT detected corruption that
                                            repair could not clear
                                            (robustness/abft.py)
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "DbcsrValidationError",
    "ShapeMismatchError",
    "GridMismatchError",
    "MaskConsistencyError",
    "NormConsistencyError",
    "NonFiniteOperandError",
    "NonFiniteResultError",
    "CorruptionDetectedError",
    "all_finite",
    "assert_finite",
    "validate_matrix",
    "validate_multiply_request",
]


class DbcsrValidationError(ValueError):
    """Base class for typed validation failures in the multiply stack."""


class ShapeMismatchError(DbcsrValidationError):
    """Payload/layout/inner-dimension/block-geometry inconsistency."""


class GridMismatchError(DbcsrValidationError):
    """Operands are distributed over incompatible process grids."""


class MaskConsistencyError(DbcsrValidationError):
    """block_mask does not describe the payload's block grid."""


class NormConsistencyError(DbcsrValidationError):
    """block_norms cache is inconsistent (shape, sign, or NaN)."""


class NonFiniteOperandError(DbcsrValidationError):
    """An input payload contains NaN/Inf."""


class NonFiniteResultError(DbcsrValidationError):
    """A computed result contains NaN/Inf."""


class CorruptionDetectedError(RuntimeError):
    """ABFT verification detected corruption that repair did not clear.

    Carries the final verification report as ``.report``: the flagged
    blocks survived a recompute-and-splice, so the fault is persistent
    (poison input, deterministic miscompile) rather than a transient
    soft error.
    """

    def __init__(self, message: str, report=None):
        super().__init__(message)
        self.report = report


def all_finite(x) -> bool:
    """True iff every element of ``x`` is finite (one reduction on the
    tensor's device)."""
    x = torch.as_tensor(x)
    if not (x.is_floating_point() or x.is_complex()):
        return True
    return bool(torch.isfinite(x).all())


def assert_finite(x, name: str = "array", *, kind: str = "operand") -> None:
    """Raise ``NonFinite{Operand,Result}Error`` if ``x`` has NaN/Inf."""
    if all_finite(x):
        return
    exc = NonFiniteOperandError if kind == "operand" else NonFiniteResultError
    raise exc(f"{name} contains NaN/Inf ({kind} tripwire)")


def _layout_shape(mat):
    layout = mat.layout
    return (layout.rows, layout.cols,
            layout.block_rows, layout.block_cols,
            layout.nblock_rows, layout.nblock_cols)


def validate_matrix(mat, name: str = "operand") -> None:
    """Structural validation of one DBCSRMatrix-like operand.

    Checks payload-vs-layout shape, block divisibility, block_mask
    shape/dtype, and block_norms shape/sign/finiteness.  Raises a typed
    :class:`DbcsrValidationError` subclass; never touches device data
    beyond reading ``.shape`` (masks and norms are host metadata).
    """
    rows, cols, bm, bn, nbr, nbc = _layout_shape(mat)
    shape = tuple(mat.data.shape)
    if shape != (rows, cols):
        raise ShapeMismatchError(
            f"{name}: payload shape {shape} != layout ({rows}, {cols})")
    if rows % bm or cols % bn:
        raise ShapeMismatchError(
            f"{name}: shape ({rows}, {cols}) not divisible by blocks "
            f"({bm}, {bn})")
    mask = getattr(mat, "block_mask", None)
    if mask is not None:
        mask = np.asarray(mask)
        if mask.shape != (nbr, nbc):
            raise MaskConsistencyError(
                f"{name}: block_mask shape {mask.shape} != block grid "
                f"({nbr}, {nbc})")
        if mask.dtype != np.bool_:
            raise MaskConsistencyError(
                f"{name}: block_mask dtype {mask.dtype} is not bool")
    norms = getattr(mat, "block_norms", None)
    if norms is not None:
        norms = np.asarray(norms)
        if norms.shape != (nbr, nbc):
            raise NormConsistencyError(
                f"{name}: block_norms shape {norms.shape} != block grid "
                f"({nbr}, {nbc})")
        if not np.isfinite(norms).all():
            raise NormConsistencyError(
                f"{name}: block_norms cache contains NaN/Inf")
        if (norms < 0).any():
            raise NormConsistencyError(
                f"{name}: block_norms cache contains negative entries")
        if mask is not None and norms[~mask].any():
            raise NormConsistencyError(
                f"{name}: block_norms nonzero outside block_mask support")


def validate_multiply_request(a, b) -> None:
    """Validate a multiply pair (A, B) structurally, pre-dispatch.

    Raises a typed :class:`DbcsrValidationError` subclass on payload /
    layout mismatch, incompatible inner dimension or block-k geometry,
    or operands living on different process grids.
    """
    validate_matrix(a, "A")
    validate_matrix(b, "B")
    if a.layout.cols != b.layout.rows:
        raise ShapeMismatchError(
            f"inner dimension mismatch: A is {a.layout.rows}x{a.layout.cols},"
            f" B is {b.layout.rows}x{b.layout.cols}")
    if a.layout.block_cols != b.layout.block_rows:
        raise ShapeMismatchError(
            f"block-k mismatch: A block_cols={a.layout.block_cols}, "
            f"B block_rows={b.layout.block_rows}")
    ga, gb = a.grid, b.grid
    if (ga.row_axis, ga.col_axis, ga.stack_axis) != (
            gb.row_axis, gb.col_axis, gb.stack_axis):
        raise GridMismatchError(
            f"A on grid axes ({ga.row_axis}, {ga.col_axis}, "
            f"stack={ga.stack_axis}); B on grid axes ({gb.row_axis}, "
            f"{gb.col_axis}, stack={gb.stack_axis})")
