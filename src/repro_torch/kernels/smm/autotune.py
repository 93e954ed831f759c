"""smm stack parameters: the winners-table lookup.

The JAX package sweeps its smm kernel per (block, occupancy bin) and
records winners in a JSON table; no TPU or CPU winner carries over to
the H100.  The port reads its own table,
``artifacts/smm_autotune_h100.json`` (same format: entries keyed
``"<block>"`` for dense and ``"<block>@<bin>"`` for sparse bins, each
with a ``best`` record), and falls back to the heuristic
``stack_tile=30000`` (the paper's stack size) when the file or the entry
is absent.  The sweep that writes the table is later work.

The TPU ``align`` knob (MXU padding) has no meaning on the H100: the
lookup returns ``align=False`` unless a table entry says otherwise, and
the executor ignores it.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, Tuple

__all__ = ["FILL_BINS", "fill_bin", "has_winners", "best_params_meta",
           "best_params_for", "DEFAULT_CACHE"]

DEFAULT_CACHE = os.path.join("artifacts", "smm_autotune_h100.json")

# occupancy bins of the winners table (present-triple fraction of the
# dense grid); lookups snap to the nearest bin in log space
FILL_BINS: Tuple[float, ...] = (1.0, 0.5, 0.2, 0.05)

_HEURISTIC_TILE = 30000


def fill_bin(fill: float) -> float:
    """Snap an effective occupancy to the nearest winners-table bin
    (log-space nearest: 0.08 is closer to 0.05 than to 0.2)."""
    f = min(max(float(fill), 1e-9), 1.0)
    return min(FILL_BINS, key=lambda b: abs(math.log(f / b)))


def _cache_key(block: int, bin_: float) -> str:
    return str(block) if bin_ >= 1.0 else f"{block}@{bin_:g}"


def _load_cache(path: str | None) -> Dict:
    path = DEFAULT_CACHE if path is None else path
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def has_winners(block_m: int, block_k: int, block_n: int,
                path: str | None = None) -> bool:
    """Whether the table holds an entry, dense or for an occupancy bin,
    for this block geometry.  Without one the lookup returns the
    heuristic whatever the occupancy, so callers need not compute it."""
    if not block_m == block_k == block_n:
        return False
    key = str(block_m)
    return any(k == key or k.startswith(key + "@") for k in _load_cache(path))


def best_params_meta(block_m: int, block_k: int, block_n: int,
                     path: str | None = None, *,
                     fill: float = 1.0) -> Dict:
    """Winner lookup with provenance: ``{"align", "stack_tile",
    "source", "bin", "gflops"}``, ``source`` being ``"winners[<key>]"``
    or ``"heuristic"``.  Only uniform block geometries have table
    entries; a sparse bin without an entry falls back to the dense one."""
    b = fill_bin(fill)
    if block_m == block_k == block_n:
        cache = _load_cache(path)
        keys = [_cache_key(block_m, b)]
        if b < 1.0:
            keys.append(str(block_m))
        for key in keys:
            entry = cache.get(key)
            if entry:
                best = entry["best"]
                return {"align": bool(best.get("align", False)),
                        "stack_tile": int(best["stack_tile"]),
                        "source": f"winners[{key}]", "bin": b,
                        "gflops": best.get("gflops")}
    return {"align": False, "stack_tile": _HEURISTIC_TILE,
            "source": "heuristic", "bin": b, "gflops": None}


def best_params_for(block_m: int, block_k: int, block_n: int,
                    path: str | None = None, *,
                    fill: float = 1.0) -> Tuple[bool, int]:
    """``(align, stack_tile)`` for a block geometry and occupancy, as
    the executor resolves them when the caller pins neither."""
    meta = best_params_meta(block_m, block_k, block_n, path, fill=fill)
    return meta["align"], meta["stack_tile"]
