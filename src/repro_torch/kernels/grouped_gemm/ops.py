"""Wrappers for the grouped (product-batched) kernels.

Two entry points serve the batched multiply (core/engine.py
``execute_batched_plan``, core/multiply_batched.py):

  * ``grouped_gemm``          -- the batched dense GEMM
    ``(E, C, d) @ (E, d, f)`` through the CUDA kernel
    ``csrc/grouped_gemm.cu``: the *densified* local path of a fused
    product batch, one launch for all E products, product e bitwise
    ``tiled_matmul(tokens[e], weights[e])`` (one GEMM body,
    ``csrc/gemm_tile.cuh``, one summation order).  The kernel zero-fills
    ragged edges itself, so the wrapper pads nothing (the JAX wrapper
    pads C, d and f to tile multiples); its tiles are fixed in the
    kernel (128 x 128 on one linear grid axis, the groups on grid z,
    at most 65,535), so the JAX wrapper's ``bc``/``bf``/``bk`` tile
    arguments have no counterpart.
  * ``grouped_process_stack`` -- the *blocked* local path: ONE smm launch
    over a group-offset stack-triple tensor that covers every product of
    the batch (the JAX package runs one ``lax.scan`` step per stack).

For CPU tensors ``grouped_gemm`` runs the plain version (ref.py).  For
CUDA tensors it launches the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from .ref import grouped_gemm_ref

__all__ = ["grouped_gemm", "grouped_process_stack"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUPS = 65535   # grid z


def _lib():
    fn = _build.load("grouped_gemm").grouped_gemm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def grouped_gemm(tokens: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(E, C, d) @ (E, d, f) -> (E, C, f) float32; both operands float32
    or both bfloat16, contiguous, on one device."""
    if tokens.device != weights.device:
        raise ValueError(f"operands on different devices: {tokens.device}, "
                         f"{weights.device}")
    if (tokens.ndim != 3 or weights.ndim != 3
            or tokens.shape[0] != weights.shape[0]
            or tokens.shape[2] != weights.shape[1]):
        raise ValueError(f"shapes {tuple(tokens.shape)} @ "
                         f"{tuple(weights.shape)} are not (E, C, d) @ (E, d, f)")
    if tokens.dtype not in _DTYPES or weights.dtype != tokens.dtype:
        raise TypeError(f"operands must both be float32 or bfloat16, got "
                        f"{tokens.dtype} and {weights.dtype}")
    if not (tokens.is_contiguous() and weights.is_contiguous()):
        raise ValueError("operands must be contiguous")
    if tokens.device.type == "cpu":
        return grouped_gemm_ref(tokens, weights)
    if tokens.device.type != "cuda":
        raise ValueError(f"grouped_gemm runs on cpu or cuda, not {tokens.device}")
    e, c, d = tokens.shape
    f = weights.shape[2]
    if e > _MAX_GROUPS:
        raise ValueError(f"E={e} exceeds the kernel's grid ({_MAX_GROUPS} "
                         f"groups)")
    out = torch.empty((e, c, f), dtype=torch.float32, device=tokens.device)
    if out.numel() == 0:
        return out
    code = _lib()(tokens.data_ptr(), weights.data_ptr(), out.data_ptr(),
                  e, c, f, d, _DTYPES[tokens.dtype],
                  _build.stream_ptr(tokens.device))
    _build.check(code, "grouped_gemm_launch", _build.error_string("grouped_gemm"))
    grouped_gemm.launches += 1
    return out


grouped_gemm.launches = 0  # kernel launches (never plain-version calls)


def grouped_process_stack(
    a_blocks: torch.Tensor,
    b_blocks: torch.Tensor,
    c_blocks: torch.Tensor,
    triples: torch.Tensor,
    run_starts: Optional[torch.Tensor] = None,
    *,
    kernel: str = "smm",
) -> torch.Tensor:
    """Run a fused (multi-product) stack tensor through the smm stack
    processor in ONE launch; updates ``c_blocks`` in place and returns it.

    ``a_blocks`` (G*Na, bm, bk), ``b_blocks`` (G*Nb, bk, bn) and
    ``c_blocks`` (G*Nc + 1, bm, bn) are the flattened block arrays of all
    groups, the last C block the scratch block.  ``triples`` is the
    ``(S, T, 4)`` or flattened ``(S*T, 4)`` int32 group-offset tensor of
    ``BatchedExecutorPlan``: group ``g``'s rows are offset by ``(g*Na,
    g*Nb, g*Nc)`` and every padding row points at the scratch block
    ``G*Nc`` with ``valid=0``.  The smm kernel therefore needs no group
    awareness, and one launch over all rows is legal for the reason one
    launch per size bin is: each C block's run lies in one stack of one
    group, so it gets one thread block.  ``run_starts`` (from
    ``stack_run_starts`` of the flattened rows) is required for CUDA
    tensors.

    kernel='smm' -> the CUDA smm kernel (its plain version on the CPU)
    kernel='ref' -> the plain PyTorch version on any device
    """
    rows = triples.reshape(-1, triples.shape[-1])
    if kernel == "smm":
        from ..smm.ops import smm_process_stack

        return smm_process_stack(a_blocks, b_blocks, c_blocks, rows, run_starts)
    if kernel == "ref":
        from ..smm.ref import smm_process_stack_ref

        return smm_process_stack_ref(a_blocks, b_blocks, c_blocks, rows)
    raise ValueError(f"unknown stack kernel {kernel!r}")
