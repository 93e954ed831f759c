"""A traced slice of a cell's calls under ``torch.profiler``, reduced to
what the per-layer readers and the breakdown need: the slice's length,
the device's busy time (the union of its operations' intervals), device
seconds by operation name, and the idle gaps by what the host was doing.
"""
from __future__ import annotations

import bisect
from typing import Callable

SLICE = "bench.slice"
CALL = "bench.call"
TOP = 10


def _union(spans):
    """Merged, sorted ``[start, end]`` intervals of ``spans``."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def capture(run_slice: Callable[[], int], cuda: bool) -> dict:
    """Run ``run_slice()`` (which returns its number of calls) under the
    profiler inside a ``bench.slice`` range and reduce the trace:
    ``calls``, ``slice_s``, ``busy_s``, ``ops`` ({device operation name:
    seconds}), ``gaps`` ({host operation: idle seconds of the card}) and
    ``runtime`` ({CUDA runtime call: host seconds in it})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(SLICE):
            calls = run_slice()
    events = prof.events()
    whole = [e for e in events if e.name == SLICE]
    if not whole:
        raise RuntimeError("the profiler recorded no bench.slice range")
    s0, s1 = whole[0].time_range.start, whole[0].time_range.end
    thread = whole[0].thread
    dev, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # a range the host marked (``record_function``) is shown on
            # the device too; it is no operation of the device
            if e.name not in (SLICE, CALL) and not getattr(
                    e, "is_user_annotation", False):
                dev.append((e.name, max(a, s0), min(b, s1)))
        elif e.thread == thread and e.name != SLICE and b > a:
            host.append((e.name, a, b))
    dev = [d for d in dev if d[2] > d[1]]
    busy = _union([(a, b) for _, a, b in dev])
    ops, runtime = {}, {}
    for name, a, b in dev:
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
    for name, a, b in host:   # where the host waits on the CUDA runtime
        if name.startswith("cuda"):
            runtime[name] = runtime.get(name, 0.0) + (b - a) / 1e6
    host.sort(key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps, prev = {}, s0
    for a, b in busy + [[s1, s1]]:
        if a > prev:
            mid = (prev + a) / 2
            # the innermost host range open at the gap's middle: the
            # latest to start of those that have not ended
            name = "(none)"
            for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            gaps[name] = gaps.get(name, 0.0) + (a - prev) / 1e6
        prev = max(prev, b)
    return {"calls": calls, "slice_s": (s1 - s0) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "ops": ops, "gaps": gaps, "runtime": runtime}


def top(table: dict, n: int = TOP) -> list:
    """The ``n`` largest entries of ``{name: seconds}`` as ``[[name,
    seconds], ...]``."""
    return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])[:n]]
