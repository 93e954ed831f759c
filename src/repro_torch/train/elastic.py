"""Fault tolerance, the counterpart of ``repro.train.elastic``:
restart-from-checkpoint, failure injection and a straggler watchdog.

  * ``run_loop`` -- the supervised training loop: catches step failures,
    restores the last checkpoint, and continues; deterministic data
    (train/data.py) makes the recovery bit-reproducible.  When no
    checkpoint exists yet it restarts at step 0 with the state it has,
    as the reference does (ROADMAP Queue C).
  * ``FailureInjector`` -- raises at configurable steps (tests use it to
    prove recovery works).
  * ``StragglerWatchdog`` -- EMA step-time monitor: in a synchronous-
    collective design a straggler shows up as a slow *step*.

On a process mesh (``mesh=`` with the state's ``specs``,
``train_step.state_specs``) every process runs the loop on its shards:
checkpoints are written whole by one writer, and a restore, at start or
after a failure, cuts them for the mesh at hand, which need not be the
one that wrote them (the reference's elastic re-mesh).  The step to
restart from is rank 0's (``mesh.agree``), so every process restarts
from the same step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

from . import checkpoint as ckpt

__all__ = ["FailureInjector", "StragglerWatchdog", "run_loop"]


class FailureInjector:
    """Raises RuntimeError at the given steps (once each)."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)

    def check(self, step: int):
        if step in self.fail_at:
            self.fail_at.remove(step)
            raise RuntimeError(f"injected node failure at step {step}")


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps slower than ``threshold`` x the EMA step time."""

    threshold: float = 3.0
    alpha: float = 0.1
    ema: Optional[float] = None
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        straggler = self.ema is not None and dt > self.threshold * self.ema
        self.ema = dt if self.ema is None else \
            (1 - self.alpha) * self.ema + self.alpha * dt
        if straggler:
            self.flagged += 1
        return straggler


def run_loop(
    *,
    train_step: Callable,        # (params, opt_state, batch) -> (p, o, metrics)
    make_batch: Callable,        # step -> batch (deterministic)
    params: Any,
    opt_state: Any,
    n_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 10,
    failure_injector: Optional[FailureInjector] = None,
    watchdog: Optional[StragglerWatchdog] = None,
    max_restarts: int = 10,
    mesh=None,
    specs=None,
) -> Dict:
    """Supervised training loop with checkpoint/restart recovery.  A
    step's ``dt`` is host time up to ``float(loss)``, which waits for the
    device."""
    state = {"params": params, "opt": opt_state}
    step = 0
    restarts = 0
    where = {"mesh": mesh, "specs": specs}

    def latest():
        last = ckpt.latest_step(ckpt_dir)
        return last if mesh is None else mesh.agree(last)

    last = latest()
    if last is not None:
        state = ckpt.restore_checkpoint(ckpt_dir, last, state, **where)
        step = last

    history = []
    while step < n_steps:
        try:
            if failure_injector is not None:
                failure_injector.check(step)
            t0 = time.perf_counter()
            batch = make_batch(step)
            p, o, metrics = train_step(state["params"], state["opt"], batch)
            state = {"params": p, "opt": o}
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if watchdog is not None:
                watchdog.observe(dt)
            history.append({"step": step, "loss": loss, "dt": dt})
            step += 1
            if step % ckpt_every == 0:
                ckpt.save_checkpoint(ckpt_dir, step, state, **where)
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
            last = latest()
            if last is None:
                step = 0  # restart from scratch, keeping the current state
                continue
            state = ckpt.restore_checkpoint(ckpt_dir, last, state, **where)
            step = last
    return {"history": history, "restarts": restarts,
            "final_state": state,
            "stragglers": watchdog.flagged if watchdog else 0}
