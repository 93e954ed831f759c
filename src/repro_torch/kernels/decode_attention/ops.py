"""Wrapper for the CUDA decode-attention kernel
(``csrc/decode_attention.cu``): the model layer's (B, 1, H, Dh) query
layout in, the grouped (B, Hkv, R, Dh) kernel layout inside.

The caches are read in place: the per-layer (B, S, Hkv, Dh) slices of
the stacked serve cache are contiguous views, and the kernel walks S in
chunks, so S need not be a multiple of anything (the JAX wrapper's
``block_k`` has no counterpart).  ``cur_len`` stays on the device: the
kernel reads it, as the TPU kernel reads its scalar prefetch.

For CPU tensors the wrapper runs the plain version (ref.py).  For CUDA
tensors it launches the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from .ref import decode_attention_ref

__all__ = ["decode_attention", "smem_bytes"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CHUNK = 64            # cache rows staged per step (kChunk in the source)
_MAX_DH = 256
_MAX_SMEM = 232448     # the H100's shared memory per block, in bytes
_MAX_GRID_X = 2 ** 31 - 1


def smem_bytes(r: int, dh: int) -> int:
    """Dynamic shared memory of one thread block (the source's layout):
    q and the accumulator (R x Dh each), the K chunk (row stride Dh + 4
    where Dh % 4 == 0, else Dh | 1), the V chunk, the chunk's scores
    (R x 64) and three per-row scalars."""
    k_stride = dh + 4 if dh % 4 == 0 else dh | 1
    return 4 * (2 * r * dh + _CHUNK * k_stride + _CHUNK * dh
                + r * _CHUNK + 3 * r)


def _lib():
    fn = _build.load("decode_attention").decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention: q (B, 1, H, Dh); caches (B, S, Hkv, Dh)
    with H a multiple of Hkv; cur_len a one-element int32 tensor on the
    caches' device, the number of valid cache entries.  q and the caches
    are all float32 or all bfloat16, Dh <= 256.  ``scale`` defaults to
    Dh**-0.5.  Returns (B, 1, H, Dh) in q's dtype."""
    if q.ndim != 4 or q.shape[1] != 1 or k_cache.ndim != 4:
        raise ValueError(f"q {tuple(q.shape)} is not (B, 1, H, Dh) or the "
                         f"cache {tuple(k_cache.shape)} is not (B, S, Hkv, Dh)")
    b, _, h, dh = q.shape
    _, s, hkv, _ = k_cache.shape
    if (v_cache.shape != k_cache.shape or k_cache.shape[0] != b
            or k_cache.shape[3] != dh or hkv == 0 or h % hkv):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k_cache.shape)}, v "
                         f"{tuple(v_cache.shape)} do not form grouped attention")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"q and the caches must all be float32 or bfloat16, "
                        f"got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if not isinstance(cur_len, torch.Tensor) or cur_len.numel() != 1 \
            or cur_len.dtype != torch.int32:
        raise TypeError("cur_len must be a one-element int32 tensor")
    devices = {q.device, k_cache.device, v_cache.device, cur_len.device}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")
    if s == 0:
        raise ValueError("the cache has no rows (S = 0)")
    if scale is None:
        scale = dh ** -0.5
    r = h // hkv
    qg = q.reshape(b, hkv, r, dh)
    if q.device.type == "cpu":
        out = decode_attention_ref(qg, k_cache, v_cache, cur_len, scale)
        return out.reshape(b, 1, h, dh).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda, not {q.device}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("the caches must be contiguous")
    if dh > _MAX_DH:
        raise ValueError(f"Dh={dh} exceeds the kernel's {_MAX_DH}")
    smem = smem_bytes(r, dh)
    if smem > _MAX_SMEM:
        raise ValueError(f"R={r}, Dh={dh} need {smem} bytes of shared memory "
                         f"per block, more than {_MAX_SMEM}")
    if b * hkv > _MAX_GRID_X:
        raise ValueError(f"B*Hkv={b * hkv} exceeds the kernel's grid")
    qg = qg.contiguous()
    out = torch.empty((b, hkv, r, dh), dtype=torch.float32, device=q.device)
    # 16-byte loads need every cache row (Dh elements) to start 16-aligned
    vec = int(dh * q.element_size() % 16 == 0
              and k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0)
    code = _lib()(qg.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  cur_len.data_ptr(), out.data_ptr(), b, s, hkv, r, dh,
                  float(scale), _DTYPES[q.dtype], vec,
                  _build.stream_ptr(q.device))
    _build.check(code, "decode_attention_launch",
                 _build.error_string("decode_attention"))
    decode_attention.launches += 1
    return out.reshape(b, 1, h, dh).to(q.dtype)


decode_attention.launches = 0  # kernel launches (never plain-version calls)
