"""Wrapper for the CUDA smm stack kernel (``csrc/smm.cu``).

``smm_process_stack`` takes a stack (or a size bin's flattened stacks)
of ``(a_idx, b_idx, c_idx[, valid])`` rows and does
``C[c] += valid * (A[a] @ B[b])`` in place.  The kernel gives every
contiguous C run one owner (a warp for blocks up to 32, a thread block
above), so it also needs the run starts:
``stack_run_starts`` computes them on the host from the triples, and the
executor plan (core/engine.py) keeps them beside its triples so a
repeated multiply uploads nothing.

For CPU tensors the wrapper runs the plain version (ref.py).  For CUDA
tensors it launches the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import _build
from .ref import smm_process_stack_ref

__all__ = ["smm_process_stack", "stack_run_starts"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def stack_run_starts(triples: np.ndarray) -> np.ndarray:
    """Host-side run starts of a ``(S, 3|4)`` int32 stack: the first row
    of every maximal run of equal ``c_idx`` that holds at least one
    valid row (runs made only of ``valid == 0`` padding are dropped: the
    kernel must never visit them).  Raises if one C block owns two runs,
    which would make two owners race on it."""
    t = np.asarray(triples)
    if t.ndim != 2 or t.shape[1] not in (3, 4):
        raise ValueError(f"triples must be (S, 3|4), got {t.shape}")
    if t.shape[0] == 0:
        return np.zeros(0, dtype=np.int32)
    c = t[:, 2]
    starts = np.flatnonzero(np.concatenate([[True], c[1:] != c[:-1]]))
    if t.shape[1] > 3:
        n_valid = np.add.reduceat((t[:, 3] != 0).astype(np.int64), starts)
        starts = starts[n_valid > 0]
    if np.unique(c[starts]).size != starts.size:
        raise ValueError("a C block owns more than one run in this stack")
    return starts.astype(np.int32)


def _lib():
    lib = _build.load("smm")
    fn = lib.smm_process_runs
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_args(a_blocks, b_blocks, c_blocks, triples, run_starts):
    tensors = {"a_blocks": a_blocks, "b_blocks": b_blocks,
               "c_blocks": c_blocks, "triples": triples}
    if run_starts is not None:
        tensors["run_starts"] = run_starts
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"smm operands on several devices: {devices}")
    if a_blocks.ndim != 3 or b_blocks.ndim != 3 or c_blocks.ndim != 3:
        raise ValueError("a_blocks, b_blocks and c_blocks must be 3-D")
    _, bm, bk = a_blocks.shape
    _, bk2, bn = b_blocks.shape
    if bk != bk2 or tuple(c_blocks.shape[1:]) != (bm, bn):
        raise ValueError(
            f"block shapes disagree: A {tuple(a_blocks.shape)}, "
            f"B {tuple(b_blocks.shape)}, C {tuple(c_blocks.shape)}")
    if triples.ndim != 2 or triples.shape[1] not in (3, 4):
        raise ValueError(f"triples must be (S, 3|4), got {tuple(triples.shape)}")
    if a_blocks.dtype not in _DTYPES or b_blocks.dtype != a_blocks.dtype:
        raise TypeError(f"A and B must both be float32 or bfloat16, got "
                        f"{a_blocks.dtype} and {b_blocks.dtype}")
    if c_blocks.dtype != torch.float32:
        raise TypeError(f"C must be float32, got {c_blocks.dtype}")
    if triples.dtype != torch.int32:
        raise TypeError(f"triples must be int32, got {triples.dtype}")
    if run_starts is not None and (run_starts.dtype != torch.int32
                                   or run_starts.ndim != 1):
        raise TypeError("run_starts must be a 1-D int32 tensor")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def smm_process_stack(
    a_blocks: torch.Tensor,
    b_blocks: torch.Tensor,
    c_blocks: torch.Tensor,
    triples: torch.Tensor,
    run_starts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """C[c] += A[a] @ B[b] over a stack; updates ``c_blocks`` in place
    (the reference donates the C buffer) and returns it.

    ``triples`` is (S, 3) or (S, 4) int32, C runs contiguous, the
    optional 4th column a validity mask.  ``run_starts`` (int32, from
    ``stack_run_starts``, on the same device) is required for CUDA
    tensors: the wrapper never copies triples back to the host.
    """
    _check_args(a_blocks, b_blocks, c_blocks, triples, run_starts)
    if c_blocks.device.type == "cpu":
        return smm_process_stack_ref(a_blocks, b_blocks, c_blocks, triples)
    if c_blocks.device.type != "cuda":
        raise ValueError(f"smm runs on cpu or cuda, not {c_blocks.device}")
    if run_starts is None:
        raise ValueError("run_starts is required for CUDA tensors "
                         "(compute it with stack_run_starts on the host)")
    n_runs = int(run_starts.shape[0])
    if n_runs == 0:
        return c_blocks
    _, bm, bk = a_blocks.shape
    bn = b_blocks.shape[2]
    code = _lib()(
        a_blocks.data_ptr(), b_blocks.data_ptr(), c_blocks.data_ptr(),
        triples.data_ptr(), run_starts.data_ptr(), n_runs,
        int(triples.shape[0]), int(triples.shape[1]), bm, bk, bn,
        _DTYPES[a_blocks.dtype], _build.stream_ptr(c_blocks.device))
    _build.check(code, "smm_process_runs", _build.error_string("smm"))
    smm_process_stack.launches += 1
    return c_blocks


smm_process_stack.launches = 0  # kernel launches (never plain-version calls)
