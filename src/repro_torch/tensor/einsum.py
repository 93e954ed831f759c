"""Einsum front-end for blocked sparse tensor contractions (a copy of
the JAX package's ``tensor/einsum.py``).

Parses a two-operand contraction spec (``"ijk,kl->ijl"``) into the
three index groups the matricization layer (matricize.py) lowers onto
the 2D multiply engine:

  contracted   indices shared by A and B and absent from the output —
               they fuse into the inner (k) dimension of the 2D product
  A-free       indices of A that survive into the output — they fuse
               into the row dimension of the matricized A
  B-free       indices of B that survive into the output — the column
               dimension of the matricized B

The legal spec language is exactly what one ``DBCSRMatrix`` multiply
can express after matricization (arXiv:1910.13555's lowering):

  * single-letter indices, no repeats within one operand (no traces /
    diagonals),
  * at least one contracted index (outer products have no inner
    dimension to lower onto),
  * no batch indices — an index shared by A, B *and* the output would
    need a block-diagonal 3D product the 2D engine cannot express,
  * the output is a permutation of A-free + B-free — an index that
    appears in one operand but not the output would be a sum-reduction,
    which is an unfold of a *different* contraction, not this one.

Violations raise :class:`EinsumSpecError`, a typed
:class:`repro_torch.robustness.guards.DbcsrValidationError` subclass, so the
service/validation layers catch tensor spec errors exactly like matrix
shape errors.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Tuple

from ..robustness.guards import (DbcsrValidationError,
                                 GridMismatchError, ShapeMismatchError)

__all__ = ["EinsumSpecError", "ContractionSpec", "parse_contraction",
           "validate_contraction_operands"]


class EinsumSpecError(DbcsrValidationError):
    """Malformed or unsupported tensor contraction spec."""


_SPEC_RE = re.compile(r"^([A-Za-z]+),([A-Za-z]+)->([A-Za-z]*)$")


@dataclasses.dataclass(frozen=True)
class ContractionSpec:
    """A parsed, validated two-operand contraction.

    Index tuples preserve the operand order of appearance; the output
    tuple preserves the caller's requested output order (the refold
    target frame).
    """

    spec: str
    a_indices: Tuple[str, ...]
    b_indices: Tuple[str, ...]
    out_indices: Tuple[str, ...]
    contracted: Tuple[str, ...]    # ordered by appearance in A
    a_free: Tuple[str, ...]        # ordered by appearance in A
    b_free: Tuple[str, ...]        # ordered by appearance in B

    @property
    def normalized(self) -> str:
        """Canonical whitespace-free spelling; ``parse_contraction``
        round-trips through it (property-tested)."""
        return (f"{''.join(self.a_indices)},{''.join(self.b_indices)}"
                f"->{''.join(self.out_indices)}")


def parse_contraction(spec: str) -> ContractionSpec:
    """Parse and validate ``"<A>,<B>-><out>"`` into index groups.

    Raises :class:`EinsumSpecError` on syntax errors, repeated indices
    within an operand, batch (shared free) indices, outer products
    (no contracted index), sum-reductions (a free index missing from
    the output), or output indices that name no operand axis.
    """
    if not isinstance(spec, str):
        raise EinsumSpecError(f"contraction spec must be a str, got "
                              f"{type(spec).__name__}")
    compact = spec.replace(" ", "")
    m = _SPEC_RE.match(compact)
    if m is None:
        raise EinsumSpecError(
            f"malformed contraction spec {spec!r}: expected "
            f"'<letters>,<letters>-><letters>' (two operands, single-"
            f"letter indices)")
    a_s, b_s, out_s = m.group(1), m.group(2), m.group(3)
    for name, s in (("A", a_s), ("B", b_s), ("output", out_s)):
        if len(set(s)) != len(s):
            raise EinsumSpecError(
                f"{spec!r}: repeated index in {name} subscript {s!r} "
                f"(traces/diagonals are not lowerable to one 2D multiply)")
    a_idx, b_idx, out_idx = tuple(a_s), tuple(b_s), tuple(out_s)
    a_set, b_set, out_set = set(a_idx), set(b_idx), set(out_idx)

    unknown = out_set - (a_set | b_set)
    if unknown:
        raise EinsumSpecError(
            f"{spec!r}: output index(es) {sorted(unknown)} appear in "
            f"neither operand")
    batch = a_set & b_set & out_set
    if batch:
        raise EinsumSpecError(
            f"{spec!r}: batch index(es) {sorted(batch)} are shared by "
            f"A, B and the output — a 2D matricized multiply cannot "
            f"express block-diagonal batch contractions")
    contracted = tuple(i for i in a_idx if i in b_set)
    if not contracted:
        raise EinsumSpecError(
            f"{spec!r}: no contracted index — outer products have no "
            f"inner dimension to lower onto dbcsr.multiply")
    a_free = tuple(i for i in a_idx if i not in b_set)
    b_free = tuple(i for i in b_idx if i not in a_set)
    dropped = (set(a_free) | set(b_free)) - out_set
    if dropped:
        raise EinsumSpecError(
            f"{spec!r}: free index(es) {sorted(dropped)} missing from "
            f"the output — sum-reductions over free axes are not part "
            f"of this contraction's lowering")
    return ContractionSpec(
        spec=compact, a_indices=a_idx, b_indices=b_idx,
        out_indices=out_idx, contracted=contracted, a_free=a_free,
        b_free=b_free)


def validate_contraction_operands(con: ContractionSpec, a, b) -> None:
    """Structural validation of a (spec, A, B) contraction request.

    Checks rank-vs-subscript agreement, per-shared-index dimension and
    block-size agreement (the fused inner dimension must tile
    identically on both sides), and grid compatibility.  Raises typed
    :class:`DbcsrValidationError` subclasses, mirroring
    ``guards.validate_multiply_request`` for matrices.
    """
    if a.ndim != len(con.a_indices):
        raise ShapeMismatchError(
            f"{con.spec!r}: A subscript names {len(con.a_indices)} "
            f"axes but the tensor has {a.ndim}")
    if b.ndim != len(con.b_indices):
        raise ShapeMismatchError(
            f"{con.spec!r}: B subscript names {len(con.b_indices)} "
            f"axes but the tensor has {b.ndim}")
    dims = {}
    blocks = {}
    for t, idx in ((a, con.a_indices), (b, con.b_indices)):
        for ax, label in enumerate(idx):
            d, bs = int(t.shape[ax]), int(t.block_sizes[ax])
            if label in dims:
                if dims[label] != d:
                    raise ShapeMismatchError(
                        f"{con.spec!r}: index {label!r} has dim "
                        f"{dims[label]} in A but {d} in B")
                if blocks[label] != bs:
                    raise ShapeMismatchError(
                        f"{con.spec!r}: index {label!r} has block size "
                        f"{blocks[label]} in A but {bs} in B — the "
                        f"fused inner dimension must tile identically")
            dims[label] = d
            blocks[label] = bs
    ga, gb = a.grid, b.grid
    if (ga.row_axis, ga.col_axis, ga.stack_axis) != (
            gb.row_axis, gb.col_axis, gb.stack_axis):
        raise GridMismatchError(
            f"A on grid axes ({ga.row_axis}, {ga.col_axis}, "
            f"stack={ga.stack_axis}); B on grid axes ({gb.row_axis}, "
            f"{gb.col_axis}, stack={gb.stack_axis})")
