"""Norm-based on-the-fly filtering and load balancing.

    norms.py    per-block Frobenius norms, reduced on the payload's device
                and returned as host numpy
    filter.py   the ``filter_eps`` predicates shared by every layer
    balance.py  costed load balancing: DBCSR's randomized row/col
                permutation of the block distribution, for rank-exact
                multiplies on multi-rank meshes
    workloads.py  sparsity-evolving workloads (McWeeny purification)

The eps contract: a triple (i, k, j) is RETAINED iff it is present
under the block masks and ``norm(A_ik) * norm(B_kj) >= eps``, so
``filter_eps=0.0`` retains everything and is bit-identical to the
mask-only path; ``filter_eps=None`` disables the norm machinery.
"""
from .norms import (block_norms_of, compute_block_norms,
                    normalize_block_norms, product_norm_bound,
                    tensor_block_norms)
from .filter import (count_retained_triples, norm_filter_stats,
                     product_mask, retained_pair_presence)
from .balance import (RebalancePlan, chunk_imbalance, chunk_loads,
                      invert_permutation, permute_block_cols,
                      permute_block_rows, plan_rebalance,
                      retained_block_weights)
from .workloads import banded_hamiltonian, initial_density, mcweeny_purify

__all__ = [
    "RebalancePlan",
    "chunk_imbalance",
    "chunk_loads",
    "invert_permutation",
    "permute_block_cols",
    "permute_block_rows",
    "plan_rebalance",
    "retained_block_weights",
    "block_norms_of",
    "compute_block_norms",
    "normalize_block_norms",
    "product_norm_bound",
    "tensor_block_norms",
    "count_retained_triples",
    "norm_filter_stats",
    "product_mask",
    "retained_pair_presence",
    "banded_hamiltonian",
    "initial_density",
    "mcweeny_purify",
]
