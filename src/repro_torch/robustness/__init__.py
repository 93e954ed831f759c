"""Robustness: the typed error taxonomy, NaN/Inf tripwires and
structural request validation (``guards``), which the serving layer
(serve/multiply_service.py) runs at submit and delivery time.  ABFT
checksums and the chaos battery are ROADMAP Queue A8.
"""
from . import guards  # noqa: F401

__all__ = ["guards"]
