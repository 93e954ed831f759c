"""Deterministic seeded fault injection for the multiply stack (the JAX
package's ``robustness/chaos.py`` on torch tensors).

Three fault families:

* **Block payload corruption** (``corrupt_block`` / ``FaultInjector``):
  flip a high exponent bit, write a NaN, rescale, or zero one block of
  a payload, on the payload's device.  Applied to a *result* it models
  a soft error anywhere inside the multiply pipeline (kernel output, a
  corrupted shift step's payload) as observed at C — exactly what ABFT
  checksums must catch.  Applied to an *operand* it models poison
  input — invisible to checksums by construction and the job of
  ``guards``' tripwires instead.

* **Result-corruption hook** (``result_corruption`` context manager):
  installs a process-global callable that ``distributed_matmul``
  applies to the raw product *before* verification (and only when
  ``verify=`` is active — ``verify=None`` never looks at the hook).
  ``FaultInjector.one_shot_result_hook`` corrupts on the first call and
  is the identity afterwards, so the repair recompute sees a clean
  pipeline — the transient-soft-error model.

* **Dispatch faults** (``DispatchFaultInjector``): raises
  ``TransientDispatchError`` from inside ``MultiplyService._dispatch``
  to drive the retry/backoff and degradation-ladder paths.

CLI (the chaos gate)::

    PYTHONPATH=src python -m repro_torch.robustness.chaos --report

runs the injection matrix {cannon, summa} x {dense, 5% fill} x
{bitflip, nan, scale} on simulated 1x1 and 2x2 meshes plus clean /
eps-filtered false-positive checks on the card (``--device cpu`` for
the plain kernel versions), prints a scorecard, and writes
``artifacts/bench/chaos_smoke.json``; exits nonzero unless every
injection is detected, localized to the exact block, repaired, and
bitwise equal to the clean result, with zero false positives.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

__all__ = [
    "FAULT_MODES",
    "corrupt_block",
    "FaultInjector",
    "result_corruption",
    "apply_result_hook",
    "TransientDispatchError",
    "DispatchFaultInjector",
    "run_injection_matrix",
]

FAULT_MODES = ("bitflip", "nan", "scale", "zero")

# the integer view and the high exponent bit of each float type
_EXPONENT_MSB = {
    torch.float64: (torch.int64, 1 << 62),
    torch.float32: (torch.int32, 1 << 30),
    torch.float16: (torch.int16, 1 << 14),
    torch.bfloat16: (torch.int16, 1 << 14),
}


def _flip_exponent_bit(x: torch.Tensor) -> torch.Tensor:
    """XOR the high exponent bit of every element (float64 bit 62,
    float32 bit 30, float16 / bfloat16 bit 14) — the classic soft-error
    model: a one-bit upset that changes the value by many orders of
    magnitude."""
    if x.dtype not in _EXPONENT_MSB:
        raise ValueError(f"unsupported dtype for bitflip: {x.dtype}")
    itype, bit = _EXPONENT_MSB[x.dtype]
    return (x.view(itype) ^ bit).view(x.dtype)


def corrupt_block(
    array,
    i: int,
    j: int,
    *,
    block_m: int,
    block_n: int,
    mode: str = "bitflip",
    rng: Optional[np.random.RandomState] = None,
) -> torch.Tensor:
    """Return a copy of ``array`` (on its device) with block (i, j)
    corrupted.

    Modes: ``bitflip`` flips the high exponent bit of one element
    (rng-chosen), ``nan`` writes NaN into one element, ``scale``
    multiplies the block by 1000, ``zero`` zeroes it.  The rng draws
    match the JAX package's, so one seed corrupts the same element.
    """
    if mode not in FAULT_MODES:
        raise ValueError(f"unknown fault mode {mode!r}; one of {FAULT_MODES}")
    rng = rng or np.random.RandomState(0)
    out = torch.as_tensor(array).clone()
    r0, c0 = i * block_m, j * block_n
    blk = out[r0:r0 + block_m, c0:c0 + block_n]   # a view into ``out``
    if mode == "bitflip":
        r = int(rng.randint(block_m))
        c = int(rng.randint(block_n))
        blk[r, c] = _flip_exponent_bit(blk[r:r + 1, c:c + 1])[0, 0]
    elif mode == "nan":
        r = int(rng.randint(block_m))
        c = int(rng.randint(block_n))
        blk[r, c] = float("nan")
    elif mode == "scale":
        blk *= 1000.0
    else:  # zero
        blk.zero_()
    return out


class FaultInjector:
    """Deterministic seeded block-fault injector with an audit log."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.rng = np.random.RandomState(seed)
        self.log: List[dict] = []

    def corrupt_block(self, array, i: int, j: int, *, block_m: int,
                      block_n: int, mode: str = "bitflip") -> torch.Tensor:
        out = corrupt_block(array, i, j, block_m=block_m, block_n=block_n,
                            mode=mode, rng=self.rng)
        self.log.append({"target": "payload", "block": (i, j),
                         "mode": mode})
        return out

    def one_shot_result_hook(self, i: int, j: int, *, block_m: int,
                             block_n: int,
                             mode: str = "bitflip") -> Callable:
        """A hook for ``result_corruption`` that corrupts block (i, j)
        on its first invocation only — later calls (the repair
        recompute) pass through untouched."""
        injector = self

        class _OneShot:
            fired = False

            def __call__(self, c):
                if self.fired:
                    return c
                self.fired = True
                injector.log.append({"target": "result", "block": (i, j),
                                     "mode": mode})
                return corrupt_block(c, i, j, block_m=block_m,
                                     block_n=block_n, mode=mode,
                                     rng=injector.rng)

        return _OneShot()


# --- result-corruption hook -------------------------------------------
# Installed by tests / the chaos CLI; consulted by distributed_matmul
# only when verify= is active. verify=None never reads it, preserving
# the zero-overhead / bit-identity contract for unverified multiplies.
_RESULT_HOOK: Optional[Callable] = None


@contextlib.contextmanager
def result_corruption(hook: Callable):
    """Install ``hook(c) -> c'`` as the process-global result
    corruption for the duration of the context."""
    global _RESULT_HOOK
    prev = _RESULT_HOOK
    _RESULT_HOOK = hook
    try:
        yield hook
    finally:
        _RESULT_HOOK = prev


def apply_result_hook(c):
    """Apply the installed corruption hook to a raw product (identity
    when no hook is installed)."""
    hook = _RESULT_HOOK
    return c if hook is None else hook(c)


# --- dispatch faults ---------------------------------------------------
class TransientDispatchError(RuntimeError):
    """Injected dispatch failure (models OOM blips, transient backend
    errors)."""


class DispatchFaultInjector:
    """Raises ``TransientDispatchError`` from service dispatch attempts.

    ``fail_first`` makes the first N checks fail (transient — retries
    then succeed); ``fail_stages`` makes every check at those ladder
    stages fail (persistent — forces degradation past the stage).
    """

    def __init__(self, fail_first: int = 0, fail_stages=()):
        self.fail_first = int(fail_first)
        self.fail_stages = frozenset(fail_stages)
        self.n_checks = 0
        self.n_raised = 0

    def check(self, stage: Optional[str] = None, **meta) -> None:
        self.n_checks += 1
        if stage in self.fail_stages:
            self.n_raised += 1
            raise TransientDispatchError(
                f"injected persistent failure at stage {stage!r}")
        if self.n_raised < self.fail_first:
            self.n_raised += 1
            raise TransientDispatchError(
                f"injected transient failure #{self.n_raised}")


# --- injection matrix (shared by tests, the CLI and chip_smoke.py) -----
def _make_operand(rng, m, n, block, fill, mesh):
    """A DBCSRMatrix with the requested block fill (1.0 = dense)."""
    from ..core import dbcsr

    nbr, nbc = m // block, n // block
    mask = None
    if fill < 1.0:
        mask = rng.rand(nbr, nbc) < fill
        mask[0, 0] = True  # never fully empty
    data = rng.randn(m, n).astype(np.float32)
    return dbcsr.create(data, mesh=mesh, block_size=block, block_mask=mask)


def run_injection_matrix(
    mesh,
    mesh_name: str,
    *,
    algorithms=("cannon", "summa"),
    fills=(1.0, 0.05),
    modes=("bitflip", "nan", "scale"),
    geometry=(128, 128, 128),
    block: int = 32,
    seed: int = 0,
    filter_eps_clean: float = 1e-2,
    local_kernel: str = "ref",
) -> List[dict]:
    """Run the chaos matrix on one mesh; returns one row per cell.

    Each injection cell: compute the clean product, corrupt the
    max-norm result block through the one-shot hook, re-run with
    ``verify="checksum"``, and record detection / exact localization /
    repair / bitwise equality with the clean result.  Clean cells
    (``mode == "clean"`` / ``"clean_eps"``) record false positives.
    ``local_kernel`` is the blocked path's stack kernel: ``"ref"`` (the
    plain version, the JAX package's choice) or ``"smm"`` (the card's).
    """
    from ..core import dbcsr
    from ..sparsity.norms import compute_block_norms

    m, k, n = geometry
    exec_kw = dict(mesh=mesh, densify=False, local_kernel=local_kernel,
                   pipeline_depth=1)
    rows: List[dict] = []
    rng = np.random.RandomState(seed)
    for algorithm in algorithms:
        for fill in fills:
            a = _make_operand(rng, m, k, block, fill, mesh)
            b = _make_operand(rng, k, n, block, fill, mesh)
            c_clean = dbcsr.multiply(a, b, algorithm=algorithm, **exec_kw)
            c_norms = compute_block_norms(c_clean.data, block, block)
            i0, j0 = np.unravel_index(int(np.argmax(c_norms)),
                                      c_norms.shape)
            i0, j0 = int(i0), int(j0)
            for mode in modes:
                injector = FaultInjector(seed=seed)
                hook = injector.one_shot_result_hook(
                    i0, j0, block_m=block, block_n=block, mode=mode)
                with result_corruption(hook):
                    c_v, plan = dbcsr.multiply(
                        a, b, algorithm=algorithm, verify="checksum",
                        return_plan=True, **exec_kw)
                rep = plan.verification["report"]
                exact = rep.flagged_blocks == ((i0, j0),)
                bitwise = bool(torch.equal(c_v.data, c_clean.data))
                rows.append({
                    "mesh": mesh_name, "algorithm": algorithm,
                    "fill": fill, "mode": mode,
                    "injected_block": [i0, j0],
                    "detected": bool(rep.detected),
                    "localized_exact": exact,
                    "repaired": bool(rep.repaired),
                    "bitwise_clean": bitwise,
                    "ok": bool(rep.detected and exact and rep.repaired
                               and bitwise),
                })
            # false-positive checks: clean run, and eps-filtered clean run
            for clean_mode, eps in (("clean", None),
                                    ("clean_eps", filter_eps_clean)):
                c_v, plan = dbcsr.multiply(
                    a, b, algorithm=algorithm, verify="checksum",
                    filter_eps=eps, return_plan=True, **exec_kw)
                rep = plan.verification["report"]
                rows.append({
                    "mesh": mesh_name, "algorithm": algorithm,
                    "fill": fill, "mode": clean_mode,
                    "injected_block": None,
                    "detected": bool(rep.detected),
                    "localized_exact": True,
                    "repaired": False,
                    "bitwise_clean": True,
                    "ok": not rep.detected,
                })
    return rows


def _main(argv=None) -> int:
    import argparse
    import json
    import os

    ap = argparse.ArgumentParser(
        description="chaos gate: injection matrix scorecard")
    ap.add_argument("--report", action="store_true",
                    help="run the injection matrix and write the scorecard")
    ap.add_argument("--out", default="artifacts/bench/chaos_smoke.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the smm kernel) or cpu (its plain version)")
    args = ap.parse_args(argv)
    if not args.report:
        ap.error("nothing to do: pass --report")

    from ..launch.mesh import make_mesh
    # under ``python -m`` this file executes as __main__, so OUR
    # result-corruption hook global would live in a different module
    # instance than the repro_torch.robustness.chaos that
    # core/multiply.py consults — dispatch through the canonical import
    from repro_torch.robustness import chaos as _canonical

    kernel = "ref" if args.device == "cpu" else "smm"
    rows: List[dict] = []
    for mesh_name, shape in (("1x1", (1, 1)), ("2x2", (2, 2))):
        mesh = make_mesh(shape, ("data", "model"), device=args.device)
        rows.extend(_canonical.run_injection_matrix(
            mesh, mesh_name, seed=args.seed, local_kernel=kernel))

    injected = [r for r in rows if r["injected_block"] is not None]
    clean = [r for r in rows if r["injected_block"] is None]
    scorecard = {
        "n_cases": len(rows),
        "n_injected": len(injected),
        "n_detected": sum(r["detected"] for r in injected),
        "n_localized_exact": sum(r["localized_exact"] for r in injected),
        "n_repaired": sum(r["repaired"] for r in injected),
        "n_bitwise_clean": sum(r["bitwise_clean"] for r in injected),
        "n_clean_runs": len(clean),
        "n_false_positives": sum(r["detected"] for r in clean),
        "all_ok": all(r["ok"] for r in rows),
        "rows": rows,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(scorecard, f, indent=2)

    print(f"{'mesh':>4} {'algo':>7} {'fill':>5} {'mode':>9} "
          f"{'det':>4} {'loc':>4} {'rep':>4} {'bit':>4} ok")
    for r in rows:
        print(f"{r['mesh']:>4} {r['algorithm']:>7} {r['fill']:>5} "
              f"{r['mode']:>9} {str(r['detected']):>4} "
              f"{str(r['localized_exact']):>4} {str(r['repaired']):>4} "
              f"{str(r['bitwise_clean']):>4} "
              f"{'PASS' if r['ok'] else 'FAIL'}")
    print(f"\nchaos scorecard: {scorecard['n_detected']}/"
          f"{scorecard['n_injected']} detected, "
          f"{scorecard['n_localized_exact']} localized, "
          f"{scorecard['n_repaired']} repaired, "
          f"{scorecard['n_bitwise_clean']} bitwise-clean; "
          f"{scorecard['n_false_positives']} false positives on "
          f"{scorecard['n_clean_runs']} clean runs -> {args.out}")
    return 0 if scorecard["all_ok"] else 1


if __name__ == "__main__":
    raise SystemExit(_main())
