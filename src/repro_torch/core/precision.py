"""``precision=`` of the densified local multiply: the JAX package's
``jax.lax.Precision`` names mapped onto the card's f32 GEMM modes.

The JAX package passes ``precision`` to XLA's ``dot`` only
(``repro.core.cannon._default_local_matmul``,
``repro.core.densify.densified_local_matmul`` and its grouped form); its
Pallas kernels take none.  Here it reaches the densified ``torch.matmul``
/ ``torch.bmm`` only, and the hand-written kernels ignore it.

    None, "highest" -> IEEE f32 (TF32 off): today's product, bit for bit
    "high"          -> TF32 on the card's tensor cores
    "default"       -> one bf16 pass: operands rounded to bf16, products
                       accumulated and returned in f32 (the TPU's
                       ``Precision.DEFAULT``)

A name is matched in any case, and any object whose ``.name`` is one of
them (a ``jax.lax.Precision``) is taken as that name.  ``None`` is the
port's default where the JAX signature's is ``Precision.DEFAULT``: the
JAX package's test platform, the CPU, computes every ``Precision`` in
f32, and so does the port on the CPU, whatever the name; the mapping
above applies to tensors on the card.  The float32 matmul settings
written for the call (``allow_tf32``, ``set_float32_matmul_precision``,
``allow_bf16_reduced_precision_reduction``) are the caller's again
after it, also when it raises, and nothing is written where the
caller's setting already is the call's.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

__all__ = ["PRECISIONS", "resolve_precision", "float32_matmul",
           "f32_gemm"]

PRECISIONS = ("default", "high", "highest")


def resolve_precision(precision) -> Optional[str]:
    """None, or the lower-case name of one of ``PRECISIONS`` (given as a
    string in any case or as an object with that ``.name``); any other
    value raises ``ValueError``."""
    if precision is None:
        return None
    name = precision if isinstance(precision, str) else getattr(
        precision, "name", None)
    if isinstance(name, str) and name.lower() in PRECISIONS:
        return name.lower()
    raise ValueError(
        f"precision must be None or one of {PRECISIONS} (any case, or an "
        f"object with that .name), got {precision!r}")


def _legacy_precision() -> Optional[str]:
    """``torch.get_float32_matmul_precision()``, or None where torch
    cannot state it (the caller mixed its legacy and per-backend
    settings)."""
    try:
        return torch.get_float32_matmul_precision()
    except RuntimeError:
        return None


def _matmul_backends() -> list:
    """The per-backend matmul settings that carry ``fp32_precision``
    (cuBLAS's and oneDNN's, where this torch has them)."""
    mkldnn = getattr(torch.backends, "mkldnn", None)
    return [x for x in (torch.backends.cuda.matmul,
                        getattr(mkldnn, "matmul", None))
            if hasattr(x, "fp32_precision")]


@contextlib.contextmanager
def float32_matmul(mode: str):
    """Float32 matmuls at ``mode`` ("highest" or "high") inside the
    context (the ABFT checksums' IEEE products too); the caller's
    settings restored after it.  Where torch states the caller's
    precision (``get_float32_matmul_precision``) the legacy setter
    writes and restores it; where the caller set the backends apart
    (torch then refuses to state one), each backend's ``fp32_precision``
    is written and restored instead, since a legacy write could not
    bring that state back."""
    caller = _legacy_precision()
    if caller == mode:
        yield
        return
    if caller is not None:
        torch.set_float32_matmul_precision(mode)
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(caller)
        return
    backends = _matmul_backends()
    saved = [(x, x.fp32_precision) for x in backends]
    for x in backends:
        x.fp32_precision = ("tf32" if mode == "high"
                            and x is torch.backends.cuda.matmul else "ieee")
    try:
        yield
    finally:
        for x, value in saved:
            x.fp32_precision = value


@contextlib.contextmanager
def _f32_accumulation():
    """bf16 GEMMs accumulate in f32 inside the context (no reduced
    precision split-K reduction); the caller's setting restored."""
    flags = torch.backends.cuda.matmul
    caller = flags.allow_bf16_reduced_precision_reduction
    if caller:
        flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        if caller:
            flags.allow_bf16_reduced_precision_reduction = caller


def _bf16_pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` from bf16 operands with f32 accumulation and output:
    ``torch.mm`` / ``torch.bmm`` with ``out_dtype`` (cuBLAS's bf16
    tensor-core GEMM), the leading dimensions folded into one batch."""
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.ndim == 2 and b.ndim == 2:
        return torch.mm(a16, b16, out_dtype=torch.float32)
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    m, k = a.shape[-2:]
    n = b.shape[-1]
    a3 = a16.expand(lead + (m, k)).reshape(-1, m, k)
    b3 = b16.expand(lead + (k, n)).reshape(-1, k, n)
    return torch.bmm(a3, b3, out_dtype=torch.float32).reshape(lead + (m, n))


def f32_gemm(a: torch.Tensor, b: torch.Tensor, precision=None,
             op: Callable = torch.matmul) -> torch.Tensor:
    """``op(a, b)`` of f32 operands (``a`` and ``b`` are cast to f32) at
    ``precision`` (module docstring), f32 out.  ``op`` is
    ``torch.matmul`` or ``torch.bmm``; the bf16 pass folds the leading
    dimensions into one ``torch.bmm`` whatever ``op`` is."""
    p = resolve_precision(precision)
    a, b = a.to(torch.float32), b.to(torch.float32)
    if p == "default" and a.is_cuda:
        with _f32_accumulation():
            return _bf16_pass(a, b)
    mode = "high" if p == "high" and a.is_cuda else "highest"
    with float32_matmul(mode):
        return op(a, b)
