"""Wrapper for the CUDA tiled dense matmul (``csrc/tiled_matmul.cu``).

The kernel zero-fills ragged edges itself, so the wrapper pads nothing
(the JAX wrapper pads to tile multiples).  Its tiles are fixed in the
kernel (``csrc/gemm_tile.cuh``: 128 x 128 C tiles on one linear grid
axis, so no real shape meets a grid limit), and the kernel picks its
copy width from the shapes and pointers it is given; the JAX wrapper's
``bm``/``bn``/``bk`` tile arguments have no counterpart.

For CPU tensors the wrapper runs the plain version (ref.py).  For CUDA
tensors it launches the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import tiled_matmul_ref

__all__ = ["tiled_matmul"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    fn = _build.load("tiled_matmul").tiled_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def tiled_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) float32; A and B both float32 or both
    bfloat16, contiguous, on one device."""
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, {b.device}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)} do not chain")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"A and B must both be float32 or bfloat16, got "
                        f"{a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("A and B must be contiguous")
    if a.device.type == "cpu":
        return tiled_matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"tiled_matmul runs on cpu or cuda, not {a.device}")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    code = _lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                  _DTYPES[a.dtype], _build.stream_ptr(a.device))
    _build.check(code, "tiled_matmul_launch", _build.error_string("tiled_matmul"))
    tiled_matmul.launches += 1
    return out


tiled_matmul.launches = 0  # kernel launches (never plain-version calls)
