"""Block layout descriptors for DBCSR-style blocked matrices.

DBCSR stores matrices as a grid of small dense blocks, distributed over
a 2D process grid.  The port keeps the same *logical* layout: the
per-device payload is one contiguous tensor and the block structure is
static metadata used by the stack scheduler (stacks.py) and the
densification pass (densify.py).

Everything in this module is host-side and static: plain ints and
numpy.  ``morton_order`` must stay byte-equal to the JAX package's, so
the stack plans of the two packages are identical; ``ceil_div``,
``pad_to_multiple`` and ``block_cyclic_owner`` are the same integer
helpers as the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["BlockLayout", "GridSpec", "block_cyclic_owner", "ceil_div",
           "morton_order", "pad_to_multiple"]


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def pad_to_multiple(n: int, m: int) -> int:
    return ceil_div(n, m) * m


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """Uniform-block layout of a (rows x cols) matrix.

    The paper uses square blocks of size 22 / 64 (and 4 in one test);
    any uniform (block_rows x block_cols) is supported.
    """

    rows: int
    cols: int
    block_rows: int
    block_cols: int

    def __post_init__(self):
        if self.rows % self.block_rows:
            raise ValueError(
                f"rows={self.rows} not divisible by block_rows={self.block_rows}"
            )
        if self.cols % self.block_cols:
            raise ValueError(
                f"cols={self.cols} not divisible by block_cols={self.block_cols}"
            )

    @property
    def nblock_rows(self) -> int:
        return self.rows // self.block_rows

    @property
    def nblock_cols(self) -> int:
        return self.cols // self.block_cols

    @property
    def nblocks(self) -> int:
        return self.nblock_rows * self.nblock_cols


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Names the mesh axes used as the DBCSR 2D process grid.

    ``stack_axis`` (optional) is the 2.5D replication axis used by
    cannon25d (and folded into the tall-skinny variants' flattened
    axes).
    """

    row_axis: str = "data"
    col_axis: str = "model"
    stack_axis: str | None = None

    def grid_shape(self, mesh) -> Tuple[int, int]:
        return mesh.shape[self.row_axis], mesh.shape[self.col_axis]

    def stack_size(self, mesh) -> int:
        if self.stack_axis is None:
            return 1
        return mesh.shape[self.stack_axis]

    def validate_square(self, mesh) -> int:
        pr, pc = self.grid_shape(mesh)
        if pr != pc:
            raise ValueError(
                f"Cannon requires a square process grid, got {pr}x{pc}. "
                "Use summa/tall_skinny for non-square grids."
            )
        return pr


def block_cyclic_owner(
    block_row: int, block_col: int, grid_rows: int, grid_cols: int
) -> Tuple[int, int]:
    """ScaLAPACK-style block-cyclic owner of a block (paper section IV:
    matrices are 'block-cycling distributed a la Scalapack')."""
    return block_row % grid_rows, block_col % grid_cols


def morton_order(n_rows: int, n_cols: int) -> np.ndarray:
    """Cache-oblivious (Z-Morton) traversal order over a block grid.

    DBCSR uses a cache-oblivious matrix traversal to fix the order in
    which blocks are multiplied (Traversal phase, Fig. 1).  Returns an
    (n_rows*n_cols, 2) int32 array of (row, col) pairs in Z-order.
    """
    side = 1 << max(n_rows - 1, n_cols - 1, 1).bit_length()
    coords = []
    for z in range(side * side):
        # de-interleave bits of z into (row, col)
        r = c = 0
        for bit in range(side.bit_length()):
            c |= ((z >> (2 * bit)) & 1) << bit
            r |= ((z >> (2 * bit + 1)) & 1) << bit
        if r < n_rows and c < n_cols:
            coords.append((r, c))
    out = np.asarray(coords, dtype=np.int32)
    if out.shape != (n_rows * n_cols, 2):
        raise AssertionError(f"morton order shape {out.shape}")
    return out
