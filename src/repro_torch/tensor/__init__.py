"""repro_torch.tensor — blocked sparse tensor algebra on the 2D engine
(the port's copy of the JAX package's ``tensor``).

The DBCSR tensor extension (arXiv:1910.13555): N-d blocked tensors
(``DBCSRTensor``) whose contractions lower onto the existing
``dbcsr.multiply`` by matricization — masks and norms included, the
layout choice priced by the planner.  Public entry points:

  create_tensor       blocked N-d container from a host array or tensor
  contract            ``contract("ijk,kl->ijl", A, B, ...)``
  parse_contraction   the einsum front-end (typed validation)
  enumerate_layouts   every legal matricization of a parsed spec
"""
from .contract import contract
from .einsum import (ContractionSpec, EinsumSpecError, parse_contraction,
                     validate_contraction_operands)
from .matricize import (Layout, LayoutStats, contraction_layout_stats,
                        enumerate_layouts, fold_to_tensor, unfold_tensor)
from .tensor import DBCSRTensor, create_tensor

__all__ = [
    "DBCSRTensor",
    "create_tensor",
    "contract",
    "ContractionSpec",
    "EinsumSpecError",
    "parse_contraction",
    "validate_contraction_operands",
    "Layout",
    "LayoutStats",
    "contraction_layout_stats",
    "enumerate_layouts",
    "unfold_tensor",
    "fold_to_tensor",
]
