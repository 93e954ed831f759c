"""One run of one cell: set-up, the measured window, an optional traced
slice, the comparison with the plain reference, and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
The configuration file (``bench/configs/<config>.json``) states the
product's shape (``m``, ``k``, ``n``), its ``block``, its ``dtype``, its
grid of ranks (``grid``) over the mesh axes ``mesh.axes`` (rows, then
columns; ``mesh.processes``: one rank a process and a card, over
``mesh.backend``) and the ``limits`` of the numbers compared.  The
traffic file (``bench/traffic/<mix>.json``) states the call: the keyword
arguments of ``dbcsr.multiply`` (``kwargs``), the operands' block fill
(``a_fill`` / ``b_fill``, 1 or absent: dense) and the cell's control
(``control``: ``kwargs`` that switch on the program's own lower
precision, or ``reference: "tf32"``).  Every metric is the function
``read(ctx)`` of ``bench/metrics/<name>.py``; it returns None where it
finds nothing to read, and the metric is then left out.

The loop is closed with one caller a rank: ``dbcsr.multiply`` on fixed
operands, then ``torch.cuda.synchronize()``, back to back.  One card:
the window ends with the first call that ends ``seconds`` after it
began.  A process mesh: every rank makes the same number of calls, the
number rank 0 estimates from its warm-up to fill ``seconds``; the
window and the latencies are rank 0's.
"""
from __future__ import annotations

import datetime
import importlib.util
import json
import math
import os
import random
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

BENCH = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "repro")
SLICE_S = 1.0                  # the traced slice's length, about
SLICE_CALLS = (10, 200)        # and its least and most calls
RANK_TIMEOUT_S = 300           # a collective's, and the group's
JOIN_TIMEOUT_S = 330           # a spawn's whole run once joined
WARMUP_CALLS = 3               # before the window: plans built, kernels loaded
SAMPLE_CALLS = 3               # calls of the window kept and compared


def banned_modules() -> list:
    """The loaded modules of this process whose top-level name is one of
    ``BANNED`` (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(BANNED))


def process_start_wall() -> float:
    """When this process started, on the wall clock (to 10 ms): its age
    from ``/proc`` taken off the time now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.time()


# ------------------------------------------------------------------ cells

def cell_spec(name: str, root: Path = BENCH.parent) -> dict:
    """Cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    its traffic mix and the metrics it reports."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / "bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return {"name": name, "chips": int(cell["chips"]), "config": config,
            "traffic": traffic, "end_to_end": e2e, "per_layer": layer,
            "root": str(root)}


def reader(root, name: str):
    """The module of metric ``name``: ``root/bench/metrics/<name>.py``."""
    path = Path(root) / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def work(config: dict, traffic: dict, seed: int) -> dict:
    """The useful FLOPs and bytes of one call, of the whole product and of
    one rank's share (``bench/work.py``'s counts)."""
    from . import work as w

    am, bm = masks(config, traffic, seed)
    m, k, n, bs = config["m"], config["k"], config["n"], config["block"]
    ranks = math.prod(config["grid"])
    flops = w.multiply_flops(m, k, n, bs, am, bm)
    nbytes = w.multiply_bytes(m, k, n, bs, 4, am, bm)
    return {"flops": flops, "bytes": nbytes, "rank_flops": flops / ranks,
            "rank_bytes": nbytes / ranks, "f32_peak": w.F32_PEAK_FLOPS,
            "bound_s": w.bound_s(flops / ranks, nbytes / ranks)}


# --------------------------------------------------------------- operands

def masks(config: dict, traffic: dict, seed: int):
    """The operands' block masks drawn from ``seed`` (None: dense)."""
    m, k, n, bs = config["m"], config["k"], config["n"], config["block"]
    rng = np.random.default_rng([seed, 1])
    out = []
    for key, shape in (("a_fill", (m // bs, k // bs)),
                       ("b_fill", (k // bs, n // bs))):
        fill = traffic.get(key, 1.0)
        out.append(None if fill >= 1.0 else rng.random(shape) < fill)
    return tuple(out)


def operands(config: dict, seed: int, device):
    """A and B, N(0, 1) in the configuration's dtype, drawn on ``device``
    from ``seed`` in two calls."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 64)
    dtype = getattr(torch, config["dtype"])
    a = torch.randn(config["m"], config["k"], generator=gen, device=device,
                    dtype=dtype)
    b = torch.randn(config["k"], config["n"], generator=gen, device=device,
                    dtype=dtype)
    return a, b


# ------------------------------------------------------------------ ranks

def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _barrier(mesh):
    if mesh.n_ranks > 1:
        import torch.distributed as dist

        dist.barrier()


def _call(spec: dict, mesh, a_t, b_t, am, bm, control):
    """The timed call, ``() -> (C payload, C block mask)``: the traffic's
    ``dbcsr.multiply``, or the control in its place."""
    from repro_torch.core import dbcsr
    from repro_torch.core.blocking import GridSpec

    from . import reference

    config, traffic = spec["config"], spec["traffic"]
    bs = config["block"]
    kwargs = dict(traffic.get("kwargs", {}))
    # the traffic's control, or one given as a dict in its place
    ctl = (control if isinstance(control, dict)
           else traffic.get("control", {}) if control else {})
    if ctl.get("reference") == "tf32":
        a0 = reference.masked(a_t, am, bs)
        b0 = reference.masked(b_t, bm, bs)
        cm = reference.product_mask(am, bm, config["m"] // bs,
                                    config["k"] // bs, config["n"] // bs)
        return lambda: (reference.tf32_product(a0, b0), cm)
    kwargs.update(ctl.get("kwargs", {}))
    grid = GridSpec(*config["mesh"]["axes"])
    a = dbcsr.create(a_t, mesh=mesh, grid=grid, block_size=bs, block_mask=am)
    b = dbcsr.create(b_t, mesh=mesh, grid=grid, block_size=bs, block_mask=bm)

    def call():
        c = dbcsr.multiply(a, b, mesh=mesh, **kwargs)
        return c.data, c.block_mask
    return call


def _window(call, mesh, dev, seconds: float, est_s: float, n_keep: int,
            seed: int, fixed: Optional[int]):
    """The measured window: ``(latencies, host returns, window seconds,
    wall time of the first call, {call index: result kept})``."""
    n_est = fixed or max(1, int(0.9 * seconds / max(est_s, 1e-6)))
    keep = set(random.Random(seed).sample(range(n_est), min(n_keep, n_est)))
    lat, ret, kept = [], [], {}
    _barrier(mesh)
    first_wall = time.time()
    t0 = time.perf_counter()
    i = 0
    while True:
        s = time.perf_counter()
        out = call()
        r = time.perf_counter()
        _sync(dev)
        e = time.perf_counter()
        lat.append(e - s)
        ret.append(r - s)
        if i in keep:
            kept[i] = out
        i += 1
        if (i >= fixed) if fixed else (e - t0 >= seconds):
            break
        del out
    if not kept:   # the window ended before the calls drawn: its last
        kept[i - 1] = out
    return lat, ret, e - t0, first_wall, kept


def _one(spec: dict, mesh, dev, run: dict) -> dict:
    """One run on this rank: set-up, window, traced slice, comparison."""
    import torch

    from . import faults, reference, tracing

    config, traffic = spec["config"], spec["traffic"]
    seed, seconds = int(run["seed"]), float(run["seconds"])
    bs = config["block"]
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    with faults.planted(run.get("fault")):
        a_t, b_t = operands(config, seed, dev)
        am, bm = masks(config, traffic, seed)
        call = _call(spec, mesh, a_t, b_t, am, bm, run.get("control", False))
        # warm-up: every shape the window runs, built and planned
        for i in range(WARMUP_CALLS):
            if i == WARMUP_CALLS - 1:
                _sync(dev)
                t = time.perf_counter()
            call()
            _sync(dev)
        est = time.perf_counter() - t
        fixed = None
        if mesh.n_ranks > 1:
            fixed = int(mesh.agree(max(1, round(seconds / est))))
        mesh.reset_traffic()
        lat, ret, window, first_wall, kept = _window(
            call, mesh, dev, seconds, est, SAMPLE_CALLS, seed, fixed)
        recv = sum(mesh.traffic.values())
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        traced = None
        if run.get("trace"):
            n_slice = min(max(int(SLICE_S / est), SLICE_CALLS[0]),
                          SLICE_CALLS[1])
            if mesh.n_ranks > 1:
                n_slice = int(mesh.agree(n_slice))
            from torch.profiler import record_function

            def run_slice():
                _barrier(mesh)
                for _ in range(n_slice):
                    with record_function(tracing.CALL):
                        call()
                        _sync(dev)
                return n_slice
            traced = tracing.capture(run_slice, cuda)
        del call
    # the program's state freed; the reference from the operands drawn
    # again from the seed
    del a_t, b_t
    if cuda:
        torch.cuda.empty_cache()
    a_t, b_t = operands(config, seed, dev)
    a_t, b_t = reference.masked(a_t, am, bs), reference.masked(b_t, bm, bs)
    ref = reference.product_f64(a_t, b_t)
    del a_t, b_t
    ref_mask = reference.product_mask(am, bm, config["m"] // bs,
                                      config["k"] // bs, config["n"] // bs)
    checks = [reference.compare(c, cm, ref, ref_mask)
              for c, cm in kept.values()]
    del kept, ref
    if cuda:
        torch.cuda.empty_cache()
    return {"seed": seed, "calls": len(lat), "latencies_s": lat,
            "host_return_s": ret, "window_s": window,
            "first_call_wall": first_wall, "recv_bytes": recv,
            "memory_peak_bytes": int(peak), "trace": traced,
            "checks": checks, "banned": banned_modules(),
            "device": (torch.cuda.get_device_name(dev) if cuda else "cpu")}


def rank_main(rank: int, spec: dict, runs: list, device: str,
              backend: Optional[str]) -> list:
    """Every run of ``runs`` on this rank of the cell's mesh (in process,
    or one of the processes ``run_ranks`` started)."""
    import torch

    from repro_torch.launch.mesh import make_mesh, make_process_mesh

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = spec["config"]["mesh"]
    if backend is None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        mesh = make_mesh(spec["config"]["grid"], cfg["axes"], device=dev)
    else:
        mesh = make_process_mesh(
            spec["config"]["grid"], cfg["axes"], device=None if device == "cuda"
            else device, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)   # the allocator's stats need a context
    return [_one(spec, mesh, dev, run) for run in runs]


def run_ranks_of(spec: dict, runs: list, device: str = "cuda",
                 backend: Optional[str] = None) -> list:
    """``[rank][run]`` results: in this process on one card, or on a
    process mesh (``mesh.processes``) of one process a rank, over
    ``backend`` (the configuration's unless given)."""
    cfg = spec["config"]["mesh"]
    if not cfg.get("processes"):
        return [rank_main(0, spec, runs, device, None)]
    from repro_torch.launch.processes import run_ranks

    world = math.prod(spec["config"]["grid"])
    with tempfile.TemporaryDirectory(prefix="bench-store-") as store:
        return run_ranks(rank_main, world, store_dir=store,
                         args=(spec, runs, device,
                               backend or cfg.get("backend", "nccl")),
                         backend=backend or cfg.get("backend", "nccl"),
                         timeout_s=RANK_TIMEOUT_S,
                         join_timeout_s=JOIN_TIMEOUT_S)


# ----------------------------------------------------------------- result

def checks_of(spec: dict, ranks: list) -> dict:
    """Each compared number, the worst over every rank and kept call,
    beside its limit."""
    limits = spec["config"]["limits"]
    out = {}
    for key, limit in limits.items():
        vals = [c[key] for r in ranks for c in r["checks"]]
        out[key] = {"value": max(vals) if vals else float("inf"),
                    "limit": float(limit)}
    return out


def result(spec: dict, ranks: list, trace: bool, t_start: float,
           seed: int) -> dict:
    """The result line of one run from every rank's numbers."""
    lead = ranks[0]
    checks = checks_of(spec, ranks)
    limits = spec["config"]["limits"]
    failed = sum(1 for r in ranks for c in r["checks"]
                 if any(c[k] > float(v) for k, v in limits.items()))
    ctx = {"cell": spec["name"], "chips": spec["chips"],
           "calls": lead["calls"], "window_s": lead["window_s"],
           "latencies_s": lead["latencies_s"],
           "host_return_s": lead["host_return_s"],
           "setup_s": lead["first_call_wall"] - t_start,
           "recv_bytes": lead["recv_bytes"], "trace": lead["trace"],
           "reader": lambda n: reader(spec["root"], n),
           **work(spec["config"], spec["traffic"], seed)}
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        mod = reader(spec["root"], m["name"])
        if mod.UNIT != m["unit"]:
            raise ValueError(f"metric {m['name']}: reader unit {mod.UNIT!r}, "
                             f"BENCHMARK.json {m['unit']!r}")
        value = mod.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    cuda = lead["device"] != "cpu"
    device = {"platform": "gpu" if cuda else "cpu", "kind": lead["device"],
              "count": len(ranks),
              "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks)}
    out = {"correct": failed == 0 and all(
               v["value"] <= v["limit"] for v in checks.values()),
           "attempted": lead["calls"], "failed": failed, "metrics": metrics,
           "device": device}
    if trace and lead["trace"] is not None:
        from . import tracing as tr

        device["busy_s"] = sum(r["trace"]["busy_s"] for r in ranks) / len(ranks)
        device["window_s"] = lead["trace"]["slice_s"]
        out["breakdown"] = {"device_ops": tr.top(lead["trace"]["ops"]),
                            "idle_gaps": tr.top(lead["trace"]["gaps"])}
        out["runtime"] = tr.top(lead["trace"]["runtime"])
    out["checks"] = checks
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root=None, fault: Optional[str] = None,
             control: bool = False, backend: Optional[str] = None,
             t_start: Optional[float] = None) -> dict:
    """One run of cell ``name``: the result line (a dict) and, under
    ``"banned"``, the banned modules any process of the run loaded."""
    t_start = process_start_wall() if t_start is None else t_start
    spec = cell_spec(name, root or BENCH.parent)
    run = {"seed": seed, "seconds": seconds, "trace": trace, "fault": fault,
           "control": control}
    ranks = [r[0] for r in run_ranks_of(spec, [run], device, backend)]
    out = result(spec, ranks, trace, t_start, seed)
    banned = sorted(set(banned_modules()).union(*(r["banned"] for r in ranks)))
    return out, banned
