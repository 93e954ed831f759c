"""Robustness: ABFT block checksums with detection, localization and a
one-shot repair (``abft``, exposed as ``verify=`` on
``distributed_matmul`` / ``dbcsr.multiply`` / ``multiply_batched`` /
``MultiplyService``), seeded fault injection and the chaos gate
(``chaos``, ``python -m repro_torch.robustness.chaos --report``), and
the typed error taxonomy, NaN/Inf tripwires and structural request
validation (``guards``), which the serving layer
(serve/multiply_service.py) runs at submit and delivery time.
"""
from . import abft, chaos, guards  # noqa: F401

__all__ = ["abft", "chaos", "guards"]
