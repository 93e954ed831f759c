"""Measure the planner's hardware constants on the card, or fit them
from recorded bench artifacts.

The cost models in ``cost_model.py`` are only as good as their
constants.  Three sources, later ones overriding earlier (the JAX
package's order):

  1. ``cost_model.DEFAULT_HARDWARE`` — values this module measured on an
     H100 (the run is named beside them);
  2. ``fit_from_artifacts`` — the bench trajectory under
     ``artifacts/bench_h100/`` (``DEFAULT_BENCH_DIR``, relative to the
     working directory): ``kernels.json`` (dense GEMM and fused-smm
     rates), ``densify.json`` (the densified local path's effective
     rate, which lowers the dense rate when it is smaller), ``sparse.json``
     or ``sparse_smoke.json`` (per-stack-entry overhead as the slope of
     dispatch time over triple count, net of the flop time at the fitted
     smm rate).  The files, keys and arithmetic are the JAX package's,
     and so is the fit's output on the same files, bit for bit.  The
     directory is the port's own: the JAX package's CPU benches write
     ``artifacts/bench/``, and reading it would hand CPU interpret-mode
     rates to the H100's planner.  Only the port's benches will write
     ``artifacts/bench_h100/`` (ROADMAP A13); until then nothing does, and
     a missing or unreadable file contributes nothing;
  3. ``artifacts/planner_calibration_h100.json`` (relative to the
     working directory) — constants written by this module's CLI or by
     ``save_calibration``.  The JAX package reads its own
     ``planner_calibration.json``; the names differ so that neither
     package ever reads the other's constants.

``get_hardware_model()`` resolves the merge once and caches it (only
when neither ``path`` nor ``bench_dir`` is given); the plan cache
(plan.py) keys on the resolved HardwareModel value, so a recalibration
changes the key of every later plan.

    PYTHONPATH=src python -m repro_torch.planner.calibrate [--mesh 4 4] \
        [--bench-dir artifacts/bench_h100]

fits what the bench directory supports, measures on the card (it raises
without one; the measured constants override the fitted ones, the JAX
package's ``--micro`` order), saves the file and prints each constant
beside its default, marked ``fitted``, ``measured`` or ``default``.
The JAX package's CLI only fits unless given ``--micro``; this one
always measures (a named departure).  The fit alone is
``save_calibration(fit_from_artifacts(bench_dir))``.
``bytes_per_s`` and ``latency_s`` are what the mesh's transport gives
(launch/mesh.py): on a mesh whose ranks are simulated on one card,
device copies between those ranks; on a process mesh, its group's
collectives (host-staged gloo where processes share a card).  Neither is
NVLink.  On a process mesh every process returns mesh rank 0's
measurements, so that every process plans alike.

    PYTHONPATH=src python -m repro_torch.planner.calibrate --check-drift \
        [--drift-log artifacts/obs/plan_outcomes.jsonl] [--strict]

reads instead the predicted-vs-measured plan outcomes a traced run wrote
(``obs.enable(log_dir=...)``), prints the planner scoreboard and warns
where an algorithm's median |relative error| exceeds the threshold
(``drift_report``); ``--scoreboard`` prints the scoreboard alone.
Neither needs a card.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .cost_model import DEFAULT_HARDWARE, HardwareModel

__all__ = [
    "DEFAULT_CALIBRATION",
    "DEFAULT_PLAN_LOG",
    "DEFAULT_BENCH_DIR",
    "drift_report",
    "fit_from_artifacts",
    "micro_calibrate",
    "measure_overlap",
    "get_hardware_model",
    "save_calibration",
    "invalidate_cache",
]

DEFAULT_CALIBRATION = os.path.join("artifacts",
                                   "planner_calibration_h100.json")
DEFAULT_BENCH_DIR = os.path.join("artifacts", "bench_h100")

# the main path's sizes (chip_smoke.py phase 2): one rank of the
# paper's 63,360^2 on 16x16 at block 22, and the large-block case
DENSE_N = 3960
SMM_CASES = ((22, 3960), (64, 4096))
SMM_FILL = 0.2
PSUM_SIDE = 3960        # per-rank side of the bandwidth psum: one rank of (o)
OVERLAP_SIDE = 3960     # per-rank side of the overlap multiplies: (o)

_CACHED: Optional[HardwareModel] = None


def _load_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def fit_from_artifacts(bench_dir: str = DEFAULT_BENCH_DIR) -> Dict[str, float]:
    """Extract whatever constants the recorded bench artifacts support.

    Returns a (possibly empty) partial dict — communication constants
    cannot be fitted from these single-process artifacts and keep their
    defaults unless a calibration file / micro_calibrate provides them.
    Host-side numpy in the JAX package's order of operations, so the
    result equals its ``fit_from_artifacts`` bit for bit on the same
    files (where ``sparse`` comes without an smm rate, the flop term
    takes each package's own ``DEFAULT_HARDWARE.smm_flops_per_s``).
    """
    out: Dict[str, float] = {}

    kernels = _load_json(os.path.join(bench_dir, "kernels.json")) or []
    dense = [r["gflops"] for r in kernels if r.get("kernel") == "dense_dot"]
    if dense:
        out["flops_per_s"] = max(dense) * 1e9
    fused = [r["fused_gflops"] for r in kernels
             if r.get("kernel") == "smm_dispatch" and "fused_gflops" in r]
    if fused:
        out["smm_flops_per_s"] = max(fused) * 1e9

    # densified local path cross-check: effective big-GEMM rate incl.
    # the densify copies — keep the more conservative estimate
    densify = _load_json(os.path.join(bench_dir, "densify.json")) or []
    eff = [2.0 * r["m"] * r["k"] * r["n"] / r["t_densified_s"]
           for r in densify if r.get("t_densified_s")]
    if eff and "flops_per_s" in out:
        out["flops_per_s"] = min(out["flops_per_s"], max(eff))
    elif eff:
        out["flops_per_s"] = max(eff)

    # per-entry overhead: slope of sparse dispatch time over triple
    # count, net of the pure-flop time at the fitted smm rate
    sparse = (_load_json(os.path.join(bench_dir, "sparse.json"))
              or _load_json(os.path.join(bench_dir, "sparse_smoke.json")))
    if sparse and sparse.get("rows"):
        rows = sparse["rows"]
        nt = np.array([r["n_triples"] for r in rows], dtype=float)
        ts = np.array([r["t_sparse_s"] for r in rows], dtype=float)
        if len(rows) >= 2 and np.ptp(nt) > 0:
            slope = float(np.polyfit(nt, ts, 1)[0])
            block = int(sparse.get("block", 8))
            flop_per_entry = 2.0 * block ** 3 / out.get(
                "smm_flops_per_s", DEFAULT_HARDWARE.smm_flops_per_s)
            out["stack_entry_s"] = max(slope - flop_per_entry, 1e-8)
    return out


def _timer(device: torch.device, reps: int, log: Optional[Callable]):
    """``best_of(label, fn)``: the best of ``reps`` host-clock timings of
    a synchronized ``fn()`` after one warm-up call, the time users pay
    and the one the plans' ``predicted_s`` is compared with.  On the
    card it also logs the best CUDA-event time of the same calls."""
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def best_of(label: str, fn) -> float:
        fn()
        sync()
        host = event = math.inf
        for _ in range(reps):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            fn()
            if cuda:
                stop.record()
            sync()
            host = min(host, time.perf_counter() - t0)
            if cuda:
                event = min(event, start.elapsed_time(stop) / 1e3)
        if log is not None:
            log(f"  {label}: host {host * 1e3:.4f} ms"
                + (f", CUDA events {event * 1e3:.4f} ms" if cuda else ""))
        return host

    return best_of


def micro_calibrate(mesh=None, grid=None, reps: int = 5, *,
                    log: Optional[Callable] = None) -> Dict[str, float]:
    """Measure the constants live, in-process (tens of seconds).

    ``flops_per_s`` from the densified local multiply (torch.matmul,
    TF32 off) at 3,960^2; ``smm_flops_per_s`` and ``stack_entry_s``
    from the blocked local multiply's time over its triples, dense
    against 20 % A fill, at block 22 (3,960^2) and block 64 (4,096^2):
    two slopes ``2*b^3/F + E``, two unknowns; ``densify_bytes_per_s``
    from the block-layout copy of a 3,960^2 matrix; ``dispatch_s`` from
    a 64^2 multiply on a 1x1 mesh; ``mem_bytes`` from the card.  With a
    multi-rank ``mesh`` / ``grid``, ``latency_s`` and ``bytes_per_s``
    from chains of psums over the grid (marginal cost per psum, tiny and
    ``PSUM_SIDE``^2 a rank) and the overlap efficiencies from
    ``measure_overlap``.  ``log`` (e.g. ``print``) receives each
    measurement.  Library calls never trigger measurement implicitly.
    On a process mesh (launch/mesh.py) every process measures and
    returns mesh rank 0's constants (``Mesh.agree``).
    """
    from ..core.densify import (blocked_local_matmul,
                                densified_local_matmul, to_blocks)
    from ..core.multiply import distributed_matmul
    from ..launch.mesh import make_mesh, resolve_device

    dev = mesh.device if mesh is not None else resolve_device(None)
    best_of = _timer(dev, reps, log)
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.RandomState(0)
    out: Dict[str, float] = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    n = DENSE_N
    a, b = randn(1, n, n), randn(1, n, n)
    dense = densified_local_matmul()
    t = best_of(f"dense {n}^2 torch.matmul", lambda: dense(a, b))
    out["flops_per_s"] = 2.0 * n ** 3 / max(t, 1e-12)
    t = best_of(f"to_blocks {n}^2 at block 22",
                lambda: to_blocks(a[0], 22, 22))
    out["densify_bytes_per_s"] = n * n * a.element_size() / max(t, 1e-12)
    del a, b

    slopes = {}
    for block, n in SMM_CASES:
        nb = n // block
        a, b = randn(1, n, n), randn(1, n, n)
        mask = rng.rand(nb, nb) < SMM_FILL
        times = {}
        for label, a_mask in (("dense", None), ("20 % A fill", mask)):
            lm = blocked_local_matmul(n, n, n, block_m=block, block_k=block,
                                      block_n=block, a_mask=a_mask)
            t = best_of(f"blocked {n}^2 block {block} {label} "
                        f"({lm.executor_plan.n_entries} triples)",
                        lambda: lm(a, b))
            times[label] = (t, lm.executor_plan.n_entries)
        (t_hi, n_hi), (t_lo, n_lo) = times["dense"], times["20 % A fill"]
        slopes[block] = max((t_hi - t_lo) / (n_hi - n_lo), 1e-15)
        del a, b
    (b1, _), (b2, _) = SMM_CASES
    s1, s2 = slopes[b1], slopes[b2]
    if s2 > s1:
        out["smm_flops_per_s"] = 2.0 * (b2 ** 3 - b1 ** 3) / (s2 - s1)
        out["stack_entry_s"] = max(
            s1 - 2.0 * b1 ** 3 / out["smm_flops_per_s"], 0.0)
    else:  # overhead-dominated regime: the slope IS the entry cost
        out["stack_entry_s"] = s1

    mesh1 = make_mesh((1, 1), ("data", "model"), device=dev)
    a, b = randn(64, 64), randn(64, 64)
    out["dispatch_s"] = best_of(
        "dispatch: 64^2 cannon densified on 1x1",
        lambda: distributed_matmul(a, b, mesh=mesh1, algorithm="cannon",
                                   densify=True))
    if dev.type == "cuda":
        out["mem_bytes"] = float(
            torch.cuda.get_device_properties(dev).total_memory)

    if mesh is not None and grid is not None and mesh.n_ranks > 1:
        axes = (grid.row_axis, grid.col_axis)

        def chain(x, n_psum):
            def run():
                y = x
                for i in range(n_psum):
                    y = mesh.psum(y + float(i), axes)
                return y
            return run

        reps_n = 8
        local, how = len(mesh.local_ranks), mesh.transport
        tiny = torch.ones((local, 1, 1), device=dev)
        dt = (best_of(f"{reps_n} tiny psums ({how})", chain(tiny, reps_n))
              - best_of(f"1 tiny psum ({how})", chain(tiny, 1)))
        out["latency_s"] = max(dt / (reps_n - 1), 1e-9)
        side = PSUM_SIDE
        big = torch.ones((local, side, side), device=dev)
        dt = (best_of(f"{reps_n} psums of {side}^2 a rank ({how})",
                      chain(big, reps_n))
              - best_of(f"1 psum of {side}^2 a rank ({how})",
                        chain(big, 1)))
        per_msg = max(dt / (reps_n - 1) - out["latency_s"], 1e-12)
        out["bytes_per_s"] = 2.0 * side * side * 4 / per_msg
        hw = DEFAULT_HARDWARE.replace(**out)
        out.update(measure_overlap(mesh, grid, reps=reps, hw=hw, log=log))
    return mesh.agree(out) if mesh is not None else out


def measure_overlap(mesh=None, grid=None, reps: int = 5, hw=None, *,
                    log: Optional[Callable] = None) -> Dict[str, float]:
    """Measure the schedule engine's *achieved* comm/compute overlap.

    For each multi-step algorithm the mesh admits, times the same
    densified multiply (``OVERLAP_SIDE``^2 a rank) at
    ``pipeline_depth=1`` (serial) and ``pipeline_depth=2`` (the next
    step's communication issued before this step's multiply) and
    converts the saving into an efficiency in [0, 1] against the
    model's predicted communication time:

        overlap_<algo> = (t_serial - t_pipelined) / comm_s_model

    On simulated ranks every copy and GEMM runs on the card's one
    stream, so nothing overlaps and the honest answer is ~0; the
    process mesh's collectives are synchronous too.  A saving
    under 5 % of the serial time, or a modelled communication under 10
    % of it, calibrates to 0 (timing jitter, not overlap).
    ``overlap_ts`` and ``overlap_cannon25d`` reuse the Cannon value
    unless a stack axis lets 2.5D be measured directly.
    """
    from ..core.multiply import distributed_matmul

    out: Dict[str, float] = {}
    if mesh is None or grid is None or mesh.n_ranks <= 1:
        return out
    if hw is None:
        hw = get_hardware_model()
    best_of = _timer(mesh.device, reps, log)
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    pr, pc = grid.grid_shape(mesh)
    c_stack = grid.stack_size(mesh)

    def timed_pair(algo, side, **kw):
        a = torch.randn((side, side), generator=gen, device=mesh.device)
        b = torch.randn((side, side), generator=gen, device=mesh.device)
        return tuple(best_of(
            f"{algo} {side}^2 densified, pipeline_depth {d}",
            lambda d=d: distributed_matmul(
                a, b, mesh=mesh, grid=grid, algorithm=algo, densify=True,
                pipeline_depth=d, **kw)) for d in (1, 2))

    def overlap_eff(t1, t2, comm_model_s):
        saved = t1 - t2
        if comm_model_s < 0.1 * t1 or saved < 0.05 * t1:
            saved = 0.0
        return float(min(max(saved / comm_model_s, 0.0), 1.0))

    e = 4  # f32 operands
    targets = []
    if pr == pc:
        side = OVERLAP_SIDE * pr
        ml = side // pr
        comm = pr * 2 * ml * ml * e            # pg shifts of (a, b) chunks
        targets.append(("overlap_cannon", "cannon", side, comm))
    side_s = OVERLAP_SIDE * max(pr, pc)
    mls, nls = side_s // pr, side_s // pc
    n_panels = pc if pr == pc else math.lcm(pr, pc)
    kls = side_s // n_panels
    comm_s_bytes = 2 * n_panels * (mls * kls + kls * nls) * e
    targets.append(("overlap_summa", "summa", side_s, comm_s_bytes))

    for key, algo, side, comm_bytes in targets:
        t1, t2 = timed_pair(algo, side)
        out[key] = overlap_eff(t1, t2, comm_bytes / hw.bytes_per_s)

    if "overlap_cannon" in out:
        out.setdefault("overlap_cannon25d", out["overlap_cannon"])
        out.setdefault("overlap_ts", out["overlap_cannon"])
    if c_stack > 1 and pr == pc:
        side = OVERLAP_SIDE * pr
        t1, t2 = timed_pair("cannon25d", side)
        ml = side // pr
        comm = (pr // c_stack) * 2 * ml * ml * e
        out["overlap_cannon25d"] = overlap_eff(t1, t2, comm / hw.bytes_per_s)
    return mesh.agree(out)


def get_hardware_model(path: Optional[str] = None,
                       bench_dir: Optional[str] = None) -> HardwareModel:
    """Resolve defaults <- artifact fits <- calibration file (cached)."""
    global _CACHED
    if _CACHED is not None and path is None and bench_dir is None:
        return _CACHED
    merged = DEFAULT_HARDWARE.to_dict()
    merged.update(fit_from_artifacts(bench_dir or DEFAULT_BENCH_DIR))
    saved = _load_json(path or DEFAULT_CALIBRATION)
    if saved:
        merged.update({k: v for k, v in saved.items()
                       if k in merged and isinstance(v, (int, float))})
    hw = HardwareModel.from_dict(merged)
    if path is None and bench_dir is None:
        _CACHED = hw
    return hw


def invalidate_cache() -> None:
    global _CACHED
    _CACHED = None


def save_calibration(constants: Dict[str, float],
                     path: str = DEFAULT_CALIBRATION) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({k: float(v) for k, v in constants.items()}, f, indent=1)
    invalidate_cache()
    return path


SIMULATED = ("bytes_per_s", "latency_s", "overlap_cannon",
             "overlap_cannon25d", "overlap_summa", "overlap_ts")


def describe(measured: Dict[str, float], mesh=None,
             fitted: Optional[Dict[str, float]] = None) -> str:
    """One line per constant: the value a calibration file of
    ``{**fitted, **measured}`` gives, marked ``measured`` (on the card),
    ``fitted`` (from the bench artifacts) or ``default``, beside the
    default; the measured communication constants marked as
    simulated-rank copies or the process group's transport."""
    sim = ""
    if mesh is not None:
        sim = (f"device copies between {mesh.n_ranks} ranks simulated on "
               "one card, not NVLink" if mesh.transport == "in-process" else
               f"{mesh.transport} between {mesh.n_ranks} processes, not "
               "NVLink")
    fitted = fitted or {}
    lines = []
    for key, default in DEFAULT_HARDWARE.to_dict().items():
        if key in measured:
            got, src = measured[key], "measured"
        elif key in fitted:
            got, src = fitted[key], "fitted"
        else:
            got, src = default, "default"
        note = f"  [{sim}]" if key in SIMULATED and src == "measured" \
            and sim else ""
        lines.append(f"  {key:20s} {got:12.6g}  {src:8s}  default "
                     f"{default:12.6g}{note}")
    return "\n".join(lines)


DEFAULT_PLAN_LOG = os.path.join("artifacts", "obs", "plan_outcomes.jsonl")


def drift_report(path: str = DEFAULT_PLAN_LOG, *,
                 threshold: float = 1.0, min_samples: int = 1) -> dict:
    """Check the telemetry layer's predicted-vs-actual plan-outcome log
    (``obs.record_plan_outcome`` rows, written by traced multiplies) for
    calibration drift: algorithms whose median |relative error| exceeds
    ``threshold`` are flagged, the signal that this card's constants
    need recalibration."""
    from ..obs import read_jsonl
    from ..obs.scoreboard import check_drift

    records = read_jsonl(path)
    result = check_drift(records, threshold=threshold,
                         min_samples=min_samples)
    result["path"] = path
    result["n_records"] = len(records)
    return result


def _check_drift(args) -> None:
    from ..obs.scoreboard import render_scoreboard

    result = drift_report(args.drift_log, threshold=args.drift_threshold)
    if not result["n_records"]:
        print(f"no plan outcomes at {args.drift_log} — run a traced "
              f"multiply (obs.enable(log_dir=...)) first")
        if args.strict:
            raise SystemExit(1)
        return
    print(render_scoreboard(result["scoreboard"]))
    if args.scoreboard:
        return
    for algo, err in sorted(result["flagged"].items()):
        print(f"WARNING: {algo}: median |rel err| {err:.2f} exceeds "
              f"drift threshold {args.drift_threshold:.2f} — "
              f"recalibrate (python -m repro_torch.planner.calibrate)")
    if result["ok"]:
        print(f"calibration drift OK ({result['n_records']} outcomes, "
              f"threshold {args.drift_threshold:.2f})")
    elif args.strict:
        raise SystemExit(f"calibration drift: {sorted(result['flagged'])}")


def main(argv=None):
    from ..core.blocking import GridSpec
    from ..launch.mesh import make_mesh, resolve_device
    from .plan import plan_cache_clear

    ap = argparse.ArgumentParser()
    ap.add_argument("--bench-dir", default=DEFAULT_BENCH_DIR,
                    help="bench artifacts to fit constants from first "
                         "(fit_from_artifacts); what the card measures "
                         "overrides them")
    ap.add_argument("--out", default=DEFAULT_CALIBRATION)
    ap.add_argument("--mesh", type=int, nargs=2, default=(4, 4),
                    metavar=("PR", "PC"),
                    help="simulated grid for the communication constants")
    ap.add_argument("--check-drift", action="store_true",
                    help="instead of calibrating, read the predicted-vs-"
                         "actual plan-outcome log and warn when a per-"
                         "algorithm median |rel err| exceeds the "
                         "threshold")
    ap.add_argument("--scoreboard", action="store_true",
                    help="instead of calibrating, print the plan-outcome "
                         "log's predicted-vs-measured scoreboard")
    ap.add_argument("--drift-log", default=DEFAULT_PLAN_LOG,
                    help="plan-outcome JSONL (obs.enable(log_dir=...))")
    ap.add_argument("--drift-threshold", type=float, default=1.0,
                    help="median |predicted-measured|/measured per "
                         "algorithm above which drift is flagged")
    ap.add_argument("--strict", action="store_true",
                    help="with --check-drift: exit nonzero when drift "
                         "is flagged (or the log is missing/empty)")
    args = ap.parse_args(argv)
    if args.check_drift or args.scoreboard:
        _check_drift(args)
        return

    dev = resolve_device(None)
    print(f"device: {torch.cuda.get_device_name(dev)}")
    fitted = fit_from_artifacts(args.bench_dir)
    mesh = make_mesh(tuple(args.mesh), ("data", "model"), device=dev)
    measured = micro_calibrate(mesh, GridSpec("data", "model"), log=print)
    constants = {**fitted, **measured}
    path = save_calibration(constants, args.out)
    plan_cache_clear()
    print(f"constants (fitted from {args.bench_dir}, then measured on the "
          "card; beside DEFAULT_HARDWARE):")
    print(describe(measured, mesh, fitted))
    print(json.dumps({"calibration": constants}))
    print("wrote ->", path)


if __name__ == "__main__":
    main()
