"""smm stack parameters: the sweep and its winners table.

The JAX package sweeps its smm kernel per (block, occupancy bin) and
records winners in a JSON table; no TPU or CPU winner carries over to
the H100.  The port sweeps ``csrc/smm.cu`` on the card and keeps its own
table, ``artifacts/smm_autotune_h100.json`` (same format: entries keyed
``"<block>"`` for dense and ``"<block>@<bin>"`` for sparse bins, each
with a ``best`` record and its ``rows``).  The lookup falls back to the
heuristic ``stack_tile=30000`` (the paper's stack size) when the file or
the entry is absent.

The sweep space is the JAX package's stack tiles with ``align`` pinned to
False, as its oracle sweep pins it: ``align`` is the TPU's MXU-padding
knob, which has no meaning on the H100 and which the executor ignores.
The lookup returns ``align=False`` unless a table entry says otherwise.

    python -m repro_torch.kernels.smm.autotune --blocks 22 --n-blocks 180 \\
        --fills 1.0 0.5 0.2 0.05

The CLI runs the kernel on the card and raises without one.  One
addition to the reference's options, ``--n-blocks`` (default 8, the
reference's): at 8 blocks a side a dense plan holds 512 triples, which
every tile of ``SPACE`` takes in one stack, so the rows cannot differ;
the card's sweep runs at the main path's grids (3,960^2 at block 22 is
180 blocks a side, 4,096^2 at block 64 is 64).
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import subprocess
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["SPACE", "FILL_BINS", "fill_bin", "sweep_mask", "tune_block",
           "load_cache", "has_winners", "best_params", "best_params_meta",
           "best_params_for", "DEFAULT_CACHE", "main"]

DEFAULT_CACHE = os.path.join("artifacts", "smm_autotune_h100.json")

# the sweep space: (align, stack_tile)
SPACE: List[Tuple[bool, int]] = [(False, 1024), (False, 4096), (False, 30000)]

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


def _bench(fn, *args, reps: int = 3) -> float:
    """Seconds a call of ``fn(*args)``: one warm-up call, then ``reps``
    calls timed by CUDA events (one synchronize) for CUDA tensors, by
    the host clock for CPU tensors."""
    fn(*args)
    if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t0) / reps


def _card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them
    (``"cpu"`` on the CPU)."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)}, power limit unknown"


def sweep_mask(n_blocks: int, fill: float):
    """The sweep's one-sided A block mask at occupancy ``fill``: exactly
    ``max(1, round(fill * n_blocks**2))`` present blocks drawn by
    ``RandomState(1)`` (the JAX package's), so the plan's triple
    occupancy is ``fill``; None for a dense sweep."""
    if fill >= 1.0:
        return None
    n_cells = n_blocks * n_blocks
    n_true = max(1, round(fill * n_cells))  # never tune the empty plan
    mask = np.zeros(n_cells, dtype=bool)
    mask[np.random.RandomState(1).choice(n_cells, n_true, replace=False)] = \
        True
    return mask.reshape(n_blocks, n_blocks)


def tune_block(block: int, *, n_blocks: int = 8, use_kernel: bool = True,
               fill: float = 1.0, device=None) -> Dict:
    """Sweep SPACE for a (block x block x block) stack workload of
    ``n_blocks`` blocks a side at the *effective triple occupancy*
    ``fill``, through the executor the main path runs
    (``core.engine.build_executor_plan`` / ``execute_plan``).

    The inputs are the JAX package's: ``RandomState(0)`` draws A and B,
    and ``sweep_mask`` zeroes A outside its present blocks, so the
    plan's triple occupancy is ``fill``, the bin the dispatch-side lookup
    computes.
    ``device`` None is the card, where the kernel runs or raises;
    ``use_kernel=False`` or a CPU device runs the plain version.
    Returns ``{"block", "fill", "rows", "best", "device"}``; ``gflops``
    counts useful flops only (absent triples are skipped)."""
    from ...core.densify import to_blocks
    from ...core.engine import build_executor_plan, execute_plan

    dev = torch.device("cuda" if device is None else device)
    m = k = n = block * n_blocks
    rng = np.random.RandomState(0)
    a = rng.randn(m, k).astype(np.float32)
    b = rng.randn(k, n).astype(np.float32)
    a_mask = sweep_mask(n_blocks, fill)
    if a_mask is not None:
        a = a * np.repeat(np.repeat(a_mask, block, 0), block, 1)
    a_blocks = to_blocks(torch.from_numpy(a).to(dev), block, block)
    b_blocks = to_blocks(torch.from_numpy(b).to(dev), block, block)
    c = torch.zeros((n_blocks * n_blocks, block, block), dtype=torch.float32,
                    device=dev)
    kernel = "smm" if use_kernel else "ref"

    rows = []
    for align, stack_tile in SPACE:
        plan = build_executor_plan(m, k, n, block, block, block, stack_tile,
                                   a_mask=a_mask)

        def run(a_blocks, b_blocks, c, plan=plan):
            return execute_plan(plan, a_blocks, b_blocks, c, kernel=kernel)

        dt = _bench(run, a_blocks, b_blocks, c)
        flops = plan.n_entries * 2 * block ** 3
        rows.append({"align": align, "stack_tile": stack_tile,
                     "time_s": dt, "gflops": flops / dt / 1e9,
                     "n_stacks": plan.n_stacks,
                     "n_entries": plan.n_entries})
    best = min(rows, key=lambda r: r["time_s"])
    return {"block": block, "fill": fill, "rows": rows, "best": best,
            "device": _card(dev)}


def load_cache(path: str | None = None) -> Dict:
    """The winners table at ``path`` ({} where there is none).  ``path``
    None resolves ``DEFAULT_CACHE`` at call time, so a caller may point
    it elsewhere after import."""
    path = DEFAULT_CACHE if path is None else path
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _table(path: str | None) -> Dict:
    """The lookups' read-only view of the table at ``path``: parsed once
    per version of the file (its inode, mtime and size), as a multiply
    reads it on every call."""
    path = DEFAULT_CACHE if path is None else path
    try:
        st = os.stat(path)
        stamp = (st.st_ino, st.st_mtime_ns, st.st_size)
    except OSError:
        stamp = None
    return _parsed(path, stamp)


@functools.lru_cache(maxsize=8)
def _parsed(path: str, stamp) -> Dict:
    return load_cache(path) if stamp is not None else {}


def has_winners(block_m: int, block_k: int, block_n: int,
                path: str | None = None) -> bool:
    """Whether the table holds an entry, dense or for an occupancy bin,
    for this block geometry.  Without one the lookup returns the
    heuristic whatever the occupancy, so callers need not compute it."""
    if not block_m == block_k == block_n:
        return False
    key = str(block_m)
    return any(k == key or k.startswith(key + "@") for k in _table(path))


def best_params_meta(block_m: int, block_k: int, block_n: int,
                     path: str | None = None, *,
                     fill: float = 1.0) -> Dict:
    """Winner lookup with provenance: ``{"align", "stack_tile",
    "source", "bin", "gflops"}``, ``source`` being ``"winners[<key>]"``,
    ``"heuristic"`` or, for a non-uniform block geometry (no table
    entries), ``"heuristic-nonuniform"``.  A sparse bin without an entry
    falls back to the dense one."""
    b = fill_bin(fill)
    if block_m == block_k == block_n:
        cache = _table(path)
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
        source = "heuristic"
    else:
        source = "heuristic-nonuniform"
    return {"align": False, "stack_tile": _HEURISTIC_TILE,
            "source": source, "bin": b, "gflops": None}


def best_params(block: int, path: str | None = None, *,
                fill: float = 1.0) -> Tuple[bool, int]:
    """``(align, stack_tile)`` of a uniform block size and occupancy."""
    meta = best_params_meta(block, block, block, path, fill=fill)
    return meta["align"], meta["stack_tile"]


def best_params_for(block_m: int, block_k: int, block_n: int,
                    path: str | None = None, *,
                    fill: float = 1.0) -> Tuple[bool, int]:
    """``(align, stack_tile)`` for a block geometry and occupancy, as
    the executor resolves them when the caller pins neither."""
    meta = best_params_meta(block_m, block_k, block_n, path, fill=fill)
    return meta["align"], meta["stack_tile"]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Sweep csrc/smm.cu's stack tile on the card and merge "
                    "the winners into the table.")
    ap.add_argument("--blocks", type=int, nargs="+", default=[22, 64])
    ap.add_argument("--fills", type=float, nargs="+", default=[1.0],
                    help="occupancy bins to sweep (see FILL_BINS)")
    ap.add_argument("--cache", default=DEFAULT_CACHE)
    ap.add_argument("--n-blocks", type=int, default=8,
                    help="blocks a side of the swept product")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the sweep times csrc/smm.cu and needs a CUDA "
                           "card; the CPU runs only the plain version")

    cache = load_cache(args.cache)
    for block in args.blocks:
        for fill in args.fills:
            bin_ = fill_bin(fill)
            result = tune_block(block, n_blocks=args.n_blocks, fill=bin_)
            cache[_cache_key(block, bin_)] = result
            b = result["best"]
            print(f"block {block:3d} fill {bin_:4g}: best align={b['align']} "
                  f"stack_tile={b['stack_tile']} ({b['gflops']:.2f} GF/s)",
                  flush=True)
    os.makedirs(os.path.dirname(args.cache) or ".", exist_ok=True)
    with open(args.cache, "w") as f:
        json.dump(cache, f, indent=1)
    print("cached ->", args.cache)


if __name__ == "__main__":
    main()
