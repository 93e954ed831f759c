"""Wrapper for the CUDA decode-attention kernel
(``csrc/decode_attention.cu``): the model layer's (B, 1, H, Dh) query
layout in, the grouped (B, Hkv, R, Dh) kernel layout inside.

The caches are read in place: the per-layer (B, S, Hkv, Dh) slices of
the stacked serve cache are contiguous views, and the kernel cuts the
valid rows into 16-row tiles, so S need not be a multiple of anything
(the JAX wrapper's ``block_k`` has no counterpart).  ``cur_len`` stays
on the device: the kernel reads it, as the TPU kernel reads its scalar
prefetch, and reads no cache row at or past it.

``plan`` sizes a launch from the shapes alone: query-row groups, the
kernel's compile-time bounds, warps a CTA, and the split of the cache
rows over a cluster of CTAs.  ``split_tiles`` lists the rows each warp
of each CTA reads for a given ``cur_len``, as the kernel computes them.

For CPU tensors the wrapper runs the plain version (ref.py).  For CUDA
tensors it launches the kernel or raises; it never falls back.  For meta
tensors (the dry-run) it checks the shapes as the CUDA branch does and
returns an empty output; under a ``launch.cost_counter`` it charges the
kernel's FLOPs and bytes by formula (``cost``) on meta and on CUDA.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, List, Optional, Tuple

import torch

from ...launch import cost_counter
from .. import _build
from .ref import decode_attention_ref

__all__ = ["DecodePlan", "cost", "decode_attention", "device_plan", "plan",
           "smem_layout", "split_tiles"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_ROWS = 16         # cache rows a tile (kTileRows in the source)
STAGES = 2             # ring depth per warp (kStages)
MAX_WARPS = 4          # warps a CTA (kMaxWarps)
MAX_SPLITS = 8         # CTAs a cluster (kMaxSplits)
MAX_ROWS = 8           # query rows a group
ROW_BOUNDS = (1, 2, 4, 6, 8)   # the kernel's compile-time row bounds
_MAX_DH = 256
_MAX_SMEM = 232448     # the H100's shared memory per block, in bytes
_SM_SMEM = 233472      # shared memory per SM
_NUM_SMS = 132         # the H100 SXM's SMs
_MAX_GRID_X = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    rpg: int        # query rows a group
    nrg: int        # groups per (b, kv head)
    kr: int         # the kernel's row bound, >= rpg
    dpl: int        # output columns a lane, 32 * dpl >= Dh
    warps: int      # warps a CTA
    nsplit: int     # CTAs a cluster: splits of the cache rows
    smem: int       # dynamic shared memory of a CTA, bytes

    @property
    def ctas(self) -> int:
        """CTAs per (b, kv head)."""
        return self.nrg * self.nsplit


def smem_layout(elem: int, dh: int, kr: int, dpl: int, warps: int) -> dict:
    """The source's ``make_layout``: byte offsets and sizes of a CTA's
    shared memory.  Per warp a ring of STAGES tiles (K rows padded to an
    odd number of 16-byte chunks, V rows of 32 * dpl elements); q as f32
    (kr x dhp); the warps' weight buffers; the merge weights."""
    dhp = -(-dh * elem // 32) * 32 // elem
    kstr = dhp * elem + 16
    vstr = 32 * dpl * elem
    stage = TILE_ROWS * (kstr + vstr)
    ring = STAGES * stage
    qs = warps * ring
    ps = qs + kr * dhp * 4
    wt = ps + warps * kr * TILE_ROWS * 4
    total = wt + ((MAX_WARPS + MAX_SPLITS) * kr + kr) * 4
    return {"dhp": dhp, "kstr": kstr, "vstr": vstr, "stage": stage,
            "ring": ring, "total": total}


def plan(b: int, hkv: int, r: int, dh: int, s: int, elem: int = 2, *,
         capacity: Optional[Callable] = None) -> DecodePlan:
    """The launch for q (b, hkv, r, dh) over an s-row cache of ``elem``-
    byte elements.  Query rows go in groups of at most 8 (R = 48: six
    groups of 8; R = 12: two of 6).  Warps a CTA: 4 where the rings fit.
    Splits: at most 8 (a portable cluster) and no more than the s rows'
    16-row tiles give each warp one; among those the count n whose
    clusters take the fewest whole waves per unit of a CTA's work,
    ceil(clusters / capacity(n)) / n (ties: the larger n).
    ``capacity(n)``, the clusters of n CTAs the card holds at once, is
    the device's own count in the wrapper; without it, an H100's 132
    SMs' CTAs over n."""
    if min(b, hkv, r, dh, s) <= 0 or dh > _MAX_DH:
        raise ValueError(f"no decode plan for B={b} Hkv={hkv} R={r} "
                         f"Dh={dh} S={s}")
    nrg = -(-r // MAX_ROWS)
    rpg = -(-r // nrg)
    kr = next(k for k in ROW_BOUNDS if k >= rpg)
    dpl = next(d for d in (2, 4, 8) if 32 * d >= dh)
    warps = next(w for w in range(MAX_WARPS, 0, -1)
                 if smem_layout(elem, dh, kr, dpl, w)["total"] <= _MAX_SMEM)
    smem = smem_layout(elem, dh, kr, dpl, warps)["total"]
    if capacity is None:
        slots = _NUM_SMS * max(1, min(64 // warps, _SM_SMEM // (smem + 1024)))

        def capacity(n):
            return slots // n
    clusters = b * hkv * nrg
    most = min(MAX_SPLITS, -(-(-(-s // TILE_ROWS)) // warps))
    splits = min(range(1, most + 1), key=lambda n: (
        -(-clusters // max(1, capacity(n))) / n, -n))
    return DecodePlan(rpg, nrg, kr, dpl, warps, splits, smem)


def split_tiles(cur_len: int, s: int, nsplit: int,
                warps: int) -> List[List[List[Tuple[int, int]]]]:
    """``[split][warp]`` -> the (first row, rows) tiles that warp reads,
    as the kernel computes them: L = min(cur_len, s) rows for cur_len >=
    1, else all s (every score -1e30: the mean of V); ceil(L / 16) tiles
    cut into nsplit contiguous ranges, each range round-robin over the
    warps."""
    n = min(cur_len, s) if cur_len >= 1 else s
    nt = -(-n // TILE_ROWS)
    out = []
    for sp in range(nsplit):
        t0, t1 = sp * nt // nsplit, (sp + 1) * nt // nsplit
        out.append([[(t * TILE_ROWS, min(TILE_ROWS, n - t * TILE_ROWS))
                     for t in range(t0 + w, t1, warps)]
                    for w in range(warps)])
    return out


def _copy_bytes(row_bytes: int, *ptrs: int) -> int:
    """The widest cp.async (16, 8 or 4 bytes) that divides a cache row and
    both caches' bases, else 2 (plain loads, bf16 rows of odd Dh)."""
    for ch in (16, 8, 4):
        if row_bytes % ch == 0 and all(p % ch == 0 for p in ptrs):
            return ch
    return 2


def _lib():
    fn = _build.load("decode_attention").decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
            + [ctypes.c_float] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


_CAPACITY = {}


def _capacity(idx: int, dtype: int, dh: int, kr: int, dpl: int, warps: int):
    """``n -> `` the clusters of n CTAs of this configuration that CUDA
    device ``idx`` holds at once (cudaOccupancyMaxActiveClusters), cached."""

    def capacity(n):
        key = (idx, dtype, dh, kr, dpl, warps, n)
        if key not in _CAPACITY:
            fn = _build.load("decode_attention").decode_attention_max_clusters
            fn.argtypes, fn.restype = [ctypes.c_int] * 6, ctypes.c_int
            with torch.cuda.device(idx):
                got = fn(dtype, dh, kr, dpl, warps, n)
            if got < 0:
                raise RuntimeError(f"decode_attention: no cluster capacity "
                                   f"for {key}")
            _CAPACITY[key] = got
        return _CAPACITY[key]

    return capacity


@functools.lru_cache(maxsize=None)
def device_plan(idx: int, b: int, hkv: int, r: int, dh: int, s: int,
                dtype: torch.dtype) -> DecodePlan:
    """``plan`` for CUDA device ``idx``, its split count sized by the
    device's own cluster capacity; cached per shape."""
    elem = torch.empty((), dtype=dtype).element_size()
    pl = plan(b, hkv, r, dh, s, elem)
    return plan(b, hkv, r, dh, s, elem, capacity=_capacity(
        idx, _DTYPES[dtype], dh, pl.kr, pl.dpl, pl.warps))


def cost(b: int, h: int, hkv: int, dh: int, rows: int, elem: int) -> dict:
    """FLOPs and HBM bytes of one call that reads ``rows`` cache rows of
    each sequence: the q.K and p.V products, 4 B H rows Dh FLOPs in f32
    (the plain version's two products over its rows); q and the output
    (B H Dh elements each), the K and V rows (2 B rows Hkv Dh) and
    cur_len read or written once."""
    return {"flops": 4.0 * b * h * rows * dh,
            "hbm_bytes": float((2 * b * h * dh + 2 * b * rows * hkv * dh)
                               * elem + 4)}


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
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention runs on cpu, cuda or meta, not "
                         f"{q.device}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("the caches must be contiguous")
    if dh > _MAX_DH:
        raise ValueError(f"Dh={dh} exceeds the kernel's {_MAX_DH}")
    elem = q.element_size()
    if q.device.type == "meta":
        # the dry-run: cur_len's value is unknown, so every row counts
        if b * hkv * plan(b, hkv, r, dh, s, elem).ctas > _MAX_GRID_X:
            raise ValueError(f"B*Hkv={b * hkv} exceeds the kernel's grid")
        cost_counter.charge("decode_attention",
                            **cost(b, h, hkv, dh, s, elem))
        return torch.empty((b, 1, h, dh), dtype=q.dtype, device="meta")
    idx = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    pl = device_plan(idx, b, hkv, r, dh, s, q.dtype)
    if b * hkv * pl.ctas > _MAX_GRID_X:
        raise ValueError(f"B*Hkv={b * hkv} exceeds the kernel's grid")
    qg = qg.contiguous()
    out = torch.empty((b, hkv, r, dh), dtype=q.dtype, device=q.device)
    copy = _copy_bytes(dh * elem, k_cache.data_ptr(), v_cache.data_ptr())
    code = _lib()(qg.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  cur_len.data_ptr(), out.data_ptr(), b, s, hkv, r, dh,
                  float(scale), _DTYPES[q.dtype], pl.rpg, pl.nrg, pl.kr,
                  pl.dpl, pl.warps, pl.nsplit, copy,
                  _build.stream_ptr(q.device))
    _build.check(code, "decode_attention_launch",
                 _build.error_string("decode_attention"))
    decode_attention.launches += 1
    if cost_counter.active() is not None:   # rows below cur_len, read back
        n = int(cur_len.reshape(()))
        cost_counter.charge("decode_attention", **cost(
            b, h, hkv, dh, min(n, s) if n >= 1 else s, elem))
    return out.reshape(b, 1, h, dh)


decode_attention.launches = 0  # kernel launches (never plain-version calls)
