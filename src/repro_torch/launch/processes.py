"""Start a process mesh's ranks on one host: one process a rank.

``run_ranks(fn, world_size, store_dir=...)`` starts ``world_size``
processes with the ``spawn`` method; each joins a ``torch.distributed``
group that meets at a ``FileStore`` in a fresh directory under
``store_dir`` (no port to pick, so concurrent callers never clash),
runs ``fn(rank, *args)`` and leaves the group.  ``fn`` is pickled by
import path (a module-level function) and typically builds its mesh
with ``launch.mesh.make_process_mesh``.  The group's ``timeout_s``
bounds the rendezvous and every collective, and ``join_timeout_s`` the
run from the moment every rank has joined the group (so how long the
processes take to start and import counts against neither): a rank
that fails or hangs fails the call, and no process outlives it.

Under ``torchrun`` there is no need for this: every process already
runs the script, and ``make_launch_mesh`` initialises the group from
the rendezvous torchrun leaves in the environment.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import tempfile
import time
from typing import Callable, Sequence

__all__ = ["run_ranks", "make_launch_mesh", "launched"]

# after one rank has failed, how long the others get to leave before
# they are stopped (a peer's failure usually fails their collectives
# at once)
_GRACE_S = 15.0


def _rank_main(rank: int, world_size: int, backend: str, store_path: str,
               timeout_s: float, fn: Callable, args: Sequence,
               results) -> None:
    import torch.distributed as dist

    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world_size), rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s))
    results.put((rank, None))   # joined; the deadline starts once all have
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    # pickled here, by value: a tensor put on the queue as it is would
    # travel as a shared-memory handle this process takes with it
    results.put((rank, pickle.dumps(out)))


def run_ranks(fn: Callable, world_size: int, *, store_dir: str,
              args: Sequence = (), backend: str = "gloo",
              timeout_s: float = 120.0,
              join_timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` on ``world_size`` processes of one
    ``backend`` group (``torch.multiprocessing.start_processes``) and
    return their results (pickled by value, so tensors too) in rank
    order.  Raises ``RuntimeError`` with the first failing rank's
    traceback, or ``TimeoutError`` when the ranks have not all finished
    within ``join_timeout_s`` of the last one joining the group; the
    processes are stopped either way."""
    import torch.multiprocessing as tmp

    store = os.path.join(tempfile.mkdtemp(prefix="ranks-", dir=store_dir),
                         "store")
    results = tmp.get_context("spawn").Queue()
    ctx = tmp.start_processes(
        _rank_main, args=(world_size, backend, store, timeout_s, fn,
                          tuple(args), results),
        nprocs=world_size, join=False, start_method="spawn")
    done, joined = {}, set()
    deadline = None

    def drain():   # a rank leaves only once its result is read
        nonlocal deadline
        while True:
            try:
                rank, payload = results.get_nowait()
            except queue_mod.Empty:
                return
            if payload is None:
                joined.add(rank)
                if len(joined) == world_size:
                    deadline = time.monotonic() + join_timeout_s
            else:
                done[rank] = pickle.loads(payload)

    try:
        while not ctx.join(timeout=1.0, grace_period=_GRACE_S):
            drain()
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world_size)) - set(done))} "
                    f"of {world_size} did not finish within "
                    f"{join_timeout_s:.0f} s")
    except (tmp.ProcessRaisedException, tmp.ProcessExitedException) as e:
        raise RuntimeError(f"\n--- rank {e.error_index} of {world_size} "
                           f"---\n{e}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        drain()
        results.close()
    return [done[r] for r in range(world_size)]


def launched() -> bool:
    """True when the process was started by ``torchrun`` (or any launcher
    that sets ``WORLD_SIZE``) as one of several."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def make_launch_mesh(shape, axes, *, device=None):
    """The mesh a script runs on: in process (``make_mesh``) when it was
    started alone, else a process mesh over the launcher's group
    (``make_process_mesh``), which this initialises from the environment
    on first call: NCCL where every process of the host has a card of
    its own, else gloo (host-staged on a shared card)."""
    import torch
    import torch.distributed as dist

    from .mesh import make_mesh, make_process_mesh, resolve_device

    if not launched():
        return make_mesh(shape, axes, device=device)
    if not dist.is_initialized():
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        own_card = (resolve_device(device).type == "cuda"
                    and torch.cuda.device_count() >= per_host)
        dist.init_process_group("nccl" if own_card else "gloo")
    if device is not None and torch.device(device).type == "cuda" \
            and torch.device(device).index is None:
        device = None   # one card a rank: make_process_mesh picks it
    return make_process_mesh(shape, axes, device=device)
