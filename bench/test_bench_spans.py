"""CPU tests of the readers of the port's host ranges (``plan_idle_ms``,
``executor_idle_ms``, ``dispatch_idle_ms``): their sums on a hand-made
capture, and a traced run of the shrunk blocked cell whose idle gaps
fall under the port's ``dbcsr.*`` ranges.

The CPU has no device trace, so the traced run here stands one in: every
leaf ``aten::`` operation the profiler records on the host is also
shown as a device operation over the same interval, as if a card ran
each kernel while the host called it.  The card is then idle wherever
the host is between operations, and each such gap falls under the
innermost host range open in it, as on the card.
"""
import copy

import pytest
import torch

from bench import harness, tracing

LAYERS = {
    "plan_idle_ms": ("dbcsr.plan",),
    "executor_idle_ms": ("dbcsr.local", "dbcsr.pack", "dbcsr.launch",
                         "dbcsr.unpack"),
    "dispatch_idle_ms": ("dbcsr.multiply", "dbcsr.dispatch", "dbcsr.stats",
                         "dbcsr.result_mask", "dbcsr.verify",
                         "dbcsr.repair"),
}
# the other owners of an idle gap: the host in an operation of torch or
# a call of the CUDA runtime, in the benchmark's own range, or in none
OTHERS = ("aten::", "cuda", tracing.CALL, "(none)")


def _capture(gaps, busy_s=0.5, calls=10):
    return {"calls": calls, "slice_s": 1.0, "busy_s": busy_s,
            "ops": {"smm": busy_s}, "gaps": dict(gaps), "runtime": {}}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_readers_sum_their_ranges_a_call(name):
    mod = harness.reader(harness.BENCH.parent, name)
    assert mod.UNIT == "ms" and mod.RANGES == LAYERS[name]
    gaps = {r: 0.001 * (i + 1) for i, r in enumerate(LAYERS[name])}
    gaps.update({"bench.call": 0.2, "aten::mm": 0.05, "(none)": 0.01,
                 "dbcsr.other": 0.07})
    want = 1e3 * sum(0.001 * (i + 1) for i in range(len(LAYERS[name]))) / 10
    assert mod.read({"trace": _capture(gaps)}) == pytest.approx(want,
                                                               rel=1e-12)
    # no gap under its own ranges while the port's other ranges show: 0
    other = {k: v for k, v in gaps.items() if k not in LAYERS[name]}
    assert mod.read({"trace": _capture(other)}) == 0.0
    # no device trace, or a program without the port's ranges: None
    assert mod.read({"trace": None}) is None
    assert mod.read({"trace": _capture(gaps, busy_s=0.0)}) is None
    theirs = {k: v for k, v in gaps.items() if not k.startswith("dbcsr.")}
    assert mod.read({"trace": _capture(theirs)}) is None


def _host_as_device(monkeypatch):
    """``torch.profiler.profile.events`` with every leaf ``aten::``
    operation repeated as a device operation over its own interval."""
    from torch.autograd import DeviceType

    real = torch.profiler.profile.events

    def events(self):
        out = list(real(self))
        for e in list(out):
            if (e.name.startswith("aten::") and not e.cpu_children
                    and e.device_type == DeviceType.CPU):
                d = copy.copy(e)
                d.device_type = DeviceType.CUDA
                out.append(d)
        return out

    monkeypatch.setattr(torch.profiler.profile, "events", events)


def test_traced_blocked_cell_idles_under_the_ports_ranges(tiny_root,
                                                         monkeypatch):
    _host_as_device(monkeypatch)
    traces = []
    real = tracing.capture

    def capture(run_slice, cuda):
        traces.append(real(run_slice, cuda))
        return traces[-1]

    monkeypatch.setattr(tracing, "capture", capture)
    out, _ = harness.run_cell("square_b22.blocked", 2 ** 33 + 7, 0.05, True,
                              device="cpu", root=tiny_root)
    assert out["correct"]
    (tr,) = traces
    gaps = tr["gaps"]
    assert tr["busy_s"] > 0.0
    assert any(k.startswith("dbcsr.") for k in gaps), sorted(gaps)
    # every gap has one owner: a range of one metric, or one of the rest
    known = {r for rs in LAYERS.values() for r in rs}
    for k in gaps:
        assert k in known or k.startswith(OTHERS), k
    # every reader reports (0 where no gap's middle fell in its ranges)
    metrics = out["metrics"]
    assert set(LAYERS) <= set(metrics)
    ours = sum(metrics[n]["value"] for n in LAYERS)
    rest = sum(v for k, v in gaps.items() if k.startswith(OTHERS))
    assert ours * tr["calls"] / 1e3 + rest == pytest.approx(
        tr["slice_s"] - tr["busy_s"], rel=1e-9, abs=1e-12)
    # the ranges are host ranges: none is a device operation
    assert not any(k.startswith("dbcsr.") for k in tr["ops"])
