"""Schedule engine — the single step-loop driver behind every
data-exchange algorithm.

Each algorithm module exports a pure *schedule builder* that returns a
``Schedule``: a host-side description of the step sequence

  * ``prologue(a, b) -> carry``      one-time setup comm (Cannon skew)
  * ``recv(carry, t) -> (a_t, b_t)`` the communication producing step
                                     ``t``'s compute operands (identity
                                     for Cannon)
  * ``shift(carry, t) -> carry``     the carry update feeding step
                                     ``t + 1`` (Cannon's neighbour shift)
  * ``epilogue(c) -> c``             post-loop collective

plus static metadata: ``n_steps``, the host-static ``empty_steps`` set
(steps whose mask product is empty on every rank), per-step comm labels
and byte estimates, and an optional ``rolled`` spec.

``execute_schedule`` runs a schedule at one of three depths, with the
same float operations in the same order at each:

  pipeline_depth = 2   the ``shift``/``recv`` for step ``t + 1`` is
                       issued before step ``t``'s local multiply (the
                       paper's comm/compute overlap once a multi-rank
                       mesh sends asynchronously).  The default.
  pipeline_depth = 1   strictly serial.
  pipeline_depth = 0   the rolled form, one step-independent shift per
                       step, where the schedule provides a ``rolled``
                       spec and no step is stepwise or empty; depth 1
                       otherwise.  PyTorch runs eagerly, so the rolled
                       form is a plain loop like depth 1.

Empty steps: the compute (and ``recv``) of an empty step is elided, but
``shift`` still runs — later Cannon steps need the rotated operands.

Ranks: the operands carry the mesh's leading rank axis (launch/mesh.py),
so every callable acts on all ranks at once, and the accumulator is
``(R, [G,] m, n)``.  JAX runs the same loop once per device inside
``shard_map``; the rolled form needs no ``pvary`` here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

__all__ = [
    "Schedule",
    "RolledSpec",
    "DEFAULT_PIPELINE_DEPTH",
    "execute_schedule",
    "resolve_pipeline_depth",
    "schedule_step_meta",
]

DEFAULT_PIPELINE_DEPTH = 2


def _identity_prologue(a, b):
    return (a, b)


def _identity_recv(carry, t):
    return carry


def _identity_shift(carry, t):
    return carry


def _identity_epilogue(c):
    return c


@dataclasses.dataclass(frozen=True)
class RolledSpec:
    """Step-uniform shift for the rolled (depth 0) form: only schedules
    whose ``recv`` is the identity and whose ``shift`` does not depend
    on the step index can roll (Cannon)."""

    shift: Callable  # carry -> carry (step-independent)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Host-side step plan consumed by ``execute_schedule``.  Building
    one runs nothing, so callers may rebuild it for its metadata."""

    algorithm: str
    n_steps: int
    prologue: Callable = _identity_prologue
    recv: Callable = _identity_recv
    shift: Callable = _identity_shift
    epilogue: Callable = _identity_epilogue
    empty_steps: frozenset = frozenset()
    rolled: Optional[RolledSpec] = None
    comm_op: str = ""
    prologue_comm_bytes: int = 0
    step_comm_bytes: Tuple[int, ...] = ()
    epilogue_comm_bytes: int = 0


def resolve_pipeline_depth(pipeline_depth: Optional[int],
                           double_buffer: Optional[bool] = None) -> int:
    """Fold the legacy ``double_buffer`` flag into the depth knob:
    ``pipeline_depth`` wins when given; otherwise ``double_buffer=True``
    (or None) maps to depth 2 and ``False`` to the rolled form (0)."""
    if pipeline_depth is not None:
        d = int(pipeline_depth)
        if d < 0:
            raise ValueError(f"pipeline_depth must be >= 0, got {d}")
        return min(d, 2)
    if double_buffer is None or double_buffer:
        return DEFAULT_PIPELINE_DEPTH
    return 0


def execute_schedule(
    sched: Schedule,
    a_blk: torch.Tensor,
    b_blk: torch.Tensor,
    *,
    local_matmul: Callable,
    out_dtype: torch.dtype,
    pipeline_depth: int = DEFAULT_PIPELINE_DEPTH,
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Run a schedule's step loop on the rank-stacked operands and
    return the rank-stacked C.

    ``local_matmul`` may be *stepwise* (``local_matmul.stepwise``
    truthy): it is then called as ``local_matmul(a, b, step=t)`` and may
    return ``None`` for a step whose mask product is empty on every rank.
    """
    stepwise = bool(getattr(local_matmul, "stepwise", False))
    empty = sched.empty_steps
    n = sched.n_steps
    depth = pipeline_depth
    if depth == 0 and (stepwise or empty or sched.rolled is None):
        depth = 1

    carry = sched.prologue(a_blk, b_blk)
    c = torch.zeros(tuple(a_blk.shape[:-1]) + tuple(b_blk.shape[-1:]),
                    dtype=accum_dtype, device=a_blk.device)

    if depth == 0:
        rolled = sched.rolled
        for _ in range(n):
            a_c, b_c = sched.recv(carry, 0)
            c = c + local_matmul(a_c, b_c).to(accum_dtype)
            carry = rolled.shift(carry)
        return sched.epilogue(c).to(out_dtype)

    def compute(ops, t):
        a_t, b_t = ops
        return (local_matmul(a_t, b_t, step=t) if stepwise
                else local_matmul(a_t, b_t))

    ops = None if 0 in empty else sched.recv(carry, 0)
    for t in range(n):
        nxt_carry = nxt_ops = None
        if depth >= 2 and t + 1 < n:
            # issue step t+1's communication before step t's multiply
            nxt_carry = sched.shift(carry, t)
            if (t + 1) not in empty:
                nxt_ops = sched.recv(nxt_carry, t + 1)
        if t not in empty:
            part = compute(ops, t)
            if part is not None:
                c = c + part.to(accum_dtype)
        if t + 1 < n:
            if depth < 2:
                # serial: all communication strictly after the multiply
                nxt_carry = sched.shift(carry, t)
                if (t + 1) not in empty:
                    nxt_ops = sched.recv(nxt_carry, t + 1)
            carry, ops = nxt_carry, nxt_ops
    return sched.epilogue(c).to(out_dtype)


def schedule_step_meta(sched: Schedule) -> dict:
    """Host-side summary of a schedule's communication structure."""
    per_step = list(sched.step_comm_bytes) if sched.step_comm_bytes \
        else [0] * sched.n_steps
    return {
        "algorithm": sched.algorithm,
        "n_steps": sched.n_steps,
        "comm_op": sched.comm_op,
        "empty_steps": sorted(sched.empty_steps),
        "prologue_comm_bytes": int(sched.prologue_comm_bytes),
        "step_comm_bytes": [int(x) for x in per_step],
        "epilogue_comm_bytes": int(sched.epilogue_comm_bytes),
        "total_comm_bytes": int(sched.prologue_comm_bytes)
        + sum(int(x) for x in per_step)
        + int(sched.epilogue_comm_bytes),
    }
