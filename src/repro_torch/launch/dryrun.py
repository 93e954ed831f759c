"""Dry-run of every (architecture x input-shape x mesh) cell on the meta
device, the counterpart of ``repro.launch.dryrun``: count each cell's
step, print its roofline terms on one H100 and persist them.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh all --out artifacts/dryrun_torch [--jobs 4]

``--arch``, ``--shape`` and ``--mesh`` take ``all`` or a comma list;
meshes are ``1x1``, ``production`` (32 x 8) and ``production-multipod``
(2 x 32 x 8, ``launch.mesh.make_production_mesh``).

A cell runs ``specs.build_cell``'s step on meta tensors under
``launch.cost_counter`` (nothing is allocated or launched: the JAX
dry-run's contract on host devices) and its JSON carries the
reference's keys, per device: ``memory`` (argument and peak bytes),
``hlo_costs`` (the counter's sums, under the reference's name),
``roofline`` on the card's ``HW``, ``model_flops_global`` and
``useful_flop_ratio``, and whether the peak fits the card's HBM.  A
train cell counts its first microbatch and repeats that count for the
others (``replaying``), as the reference's analysis scales the
microbatch loop by its trip count.

On a production mesh the step is rank 0's of a process mesh of that
shape (``launch.mesh.make_meta_rank_mesh``): its arguments are that
rank's shards, it runs the mesh's collectives, and the bytes that rank
receives (``ProcessMesh``'s own count) are ``collective_bytes`` by kind
and the roofline's collective term.

The reference's A/B flags (ROADMAP A17): ``--override k=v``
(repeatable, split at the first ``=``) replaces a field of the
configuration through ``dataclasses.replace`` after the reference's
typed parse (``typed_overrides``: an ``int`` field gets ``int(v)``, a
``bool`` field is true only for ``True`` / ``"True"`` / ``"true"`` /
``"1"``, any other field keeps the string, a ``float`` such as
``rope_theta`` included, but for ``"True"``, which becomes True; an
unknown key raises ``KeyError``), e.g. ``--override head_pad_factor=1``;
``--micro N`` sets a train cell's microbatch count (0, the default,
keeps ``default_microbatches``); ``--tag S`` is appended to the
artifact's stem, ``{arch}__{shape}__{mesh}{tag}.json``.  ``--jobs``
passes all three to every cell.  The reference's ``--save-hlo`` has no
counterpart: nothing is lowered to XLA here, so there is no HLO to save.

Unlike the reference, importing this module sets no environment
variable.  A cell is ``ok``, ``skipped`` (``cell_is_supported``'s
reason) or ``FAILED``; ``main`` prints the summary table with the
columns of ``benchmarks/bench_roofline.py`` and exits 1 on a failure.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional

import torch

from ..configs.base import ARCHS, SHAPES, ShapeConfig, get_config
from ..models.common import tree_leaves
from ..train import train_step as TS
from .cost_counter import count_costs
from .mesh import HW, make_meta_rank_mesh, make_mesh, make_production_mesh
from .roofline import model_flops, roofline_terms
from .specs import build_cell, cell_is_supported

__all__ = ["MESHES", "mesh_for", "cells", "typed_overrides", "run_cell",
           "summary", "main"]

MESHES = {"1x1": "1x1", "production": "pod32x8",
          "production-multipod": "pod2x32x8"}

def mesh_for(name: str):
    """The meta mesh ``name`` (a key of MESHES) stands for: 1x1, or rank 0
    of a production mesh."""
    if name == "1x1":
        return make_mesh((1, 1), ("data", "model"), device="meta")
    if name in ("production", "production-multipod"):
        m = make_production_mesh(multi_pod=name == "production-multipod")
        return make_meta_rank_mesh(m.axis_sizes, m.axis_names)
    raise ValueError(f"unknown mesh {name!r}: one of {sorted(MESHES)}")


def _count(step, args, kind, mesh):
    replay = ((TS, "_grads_of"),) if kind == "train" else ()
    return count_costs(step, *args, mesh=mesh, replay=replay)


def typed_overrides(cfg, overrides: dict) -> dict:
    """The reference's typed parse of ``--override`` values (its
    ``run_cell``) against ``cfg``'s fields: an ``int`` field gets
    ``int(v)``; a ``bool`` field is ``v in (True, "True", "true",
    "1")``; any other field gets True for ``"True"`` and ``v`` itself
    otherwise (so a ``float`` keeps its string, as in the reference).
    An unknown key raises ``KeyError``."""
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    typed = {}
    for k, v in overrides.items():
        fld = fields[k]
        if fld.type in ("int", int):
            typed[k] = int(v)
        elif str(fld.type) in ("bool", "<class 'bool'>"):
            typed[k] = v in (True, "True", "true", "1")
        else:
            typed[k] = (v in ("True", "False") and v == "True") or v
    return typed


def run_cell(arch: str, shape_name, *, mesh: str = "1x1",
             out_dir: Optional[str] = None, cfg=None,
             overrides: Optional[dict] = None, tag: str = "",
             micro: int = 0) -> dict:
    """Dry-run one cell and write its JSON to ``out_dir`` (if given);
    returns the record.  ``shape_name`` may be a ``ShapeConfig`` and
    ``cfg`` a configuration in place of ``get_config(arch)``;
    ``overrides`` (field -> string) replace its fields after
    ``typed_overrides``; ``micro`` > 0 is a train cell's microbatch
    count; ``tag`` ends the file's stem."""
    cfg = cfg or get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **typed_overrides(cfg, overrides))
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES[shape_name])
    ok, why = cell_is_supported(cfg, shape)
    rec = {"arch": arch, "shape": shape.name, "mesh": MESHES[mesh],
           "status": "skipped", "why": why}
    if ok:
        t0 = time.perf_counter()
        m = mesh_for(mesh)
        step, args, _, _, meta = build_cell(arch, shape, m, cfg=cfg,
                                            n_microbatches=micro)
        n_chips = m.n_ranks
        mf = model_flops(cfg, shape)
        rec.update({"status": "ok", "n_chips": n_chips, "hw": HW["name"],
                    "kind": meta["kind"],
                    "n_microbatches": meta.get("n_microbatches", 1),
                    "model_flops_global": mf,
                    "model_flops_per_device": mf / n_chips})
        t1 = time.perf_counter()
        _, costs = _count(step, args, meta["kind"], m)
        peak = costs.peak_live_bytes
        names = {"train": ("params", "opt_state", "batch"),
                 "prefill": ("params", "inputs"),
                 "decode": ("params", "state", "tokens")}[meta["kind"]]
        parts = [sum(t.numel() * t.element_size()
                     for t in tree_leaves(a)) for a in args]
        rec.update({
            "count_s": time.perf_counter() - t1,
            "memory": {"argument_bytes": costs.argument_bytes,
                       "argument_bytes_by_part": dict(zip(names, parts)),
                       "peak_per_device_bytes": peak},
            "hlo_costs": costs.to_dict(),
            "roofline": roofline_terms(costs, HW),
            "useful_flop_ratio": (mf / n_chips) / max(costs.flops, 1.0),
            "fits_hbm": peak <= HW["hbm_bytes"],
        })
        rec["cell_s"] = time.perf_counter() - t0
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir,
                            f"{arch}__{shape.name}__{rec['mesh']}{tag}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _run_one(job) -> dict:
    """A worker's cell: the record, or a FAILED one with the traceback.
    ``job`` is ``(arch, shape, mesh, out_dir, overrides, tag, micro)``."""
    arch, shape, mesh, out_dir, overrides, tag, micro = job
    torch.set_num_threads(1)
    try:
        return run_cell(arch, shape, mesh=mesh, out_dir=out_dir,
                        overrides=overrides, tag=tag, micro=micro)
    except Exception:
        return {"arch": arch, "shape": shape, "mesh": MESHES[mesh],
                "status": "FAILED", "error": traceback.format_exc()}


def _gib(x) -> str:
    return "-" if x is None else f"{x / 2**30:.2f}"


def _ms(x) -> str:
    return "-" if x is None else f"{x * 1e3:.2f}"


def summary(records: List[dict]) -> str:
    """The table of ``benchmarks/bench_roofline.py`` (C / M / X ms,
    dominant, useful ratio, peak GiB a device) plus fits-HBM and
    seconds."""
    lines = [f"{'arch':26s} {'shape':12s} {'mesh':10s} {'C(ms)':>10s} "
             f"{'M(ms)':>10s} {'X(ms)':>8s} {'dom':>8s} {'useful':>7s} "
             f"{'GiB/dev':>9s} {'fits':>5s} {'s':>6s}"]
    for r in records:
        head = f"{r['arch']:26s} {r['shape']:12s} {r['mesh']:10s} "
        if r["status"] == "skipped":
            lines.append(head + f"-- skipped: {r['why'][:60]}")
            continue
        if r["status"] != "ok":
            lines.append(head + "-- FAILED")
            continue
        t = r["roofline"] or {}
        useful = r["useful_flop_ratio"]
        mem = r["memory"]
        gib = _gib(mem["peak_per_device_bytes"])
        lines.append(
            head + f"{_ms(t.get('compute_s')):>10s} "
            f"{_ms(t.get('memory_s')):>10s} {_ms(t.get('collective_s')):>8s} "
            f"{t.get('dominant') or '-':>8s} "
            f"{'-' if useful is None else f'{useful:.3f}':>7s} {gib:>9s} "
            f"{str(r['fits_hbm']):>5s} {r['cell_s']:6.1f}")
    return "\n".join(lines)


def _split(arg: str, every) -> list:
    return list(every) if arg == "all" else [
        x.strip().replace("-", "_") if every is ARCHS else x.strip()
        for x in arg.split(",")]


def cells(arch: str, shape: str, mesh: str) -> list:
    """The (arch, shape, mesh) cells of the CLI's ``--arch``, ``--shape``
    and ``--mesh`` values, the longest to count first: 1x1 before the
    production meshes, train and prefill before decode, RWKV-6 (whose
    time mix loops over the sequence) first among them."""
    meshes = _split(mesh, MESHES)
    for m in meshes:
        if m not in MESHES:
            raise ValueError(f"unknown mesh {m!r}: one of {sorted(MESHES)}")
    out = [(a, s, m) for a in _split(arch, ARCHS)
           for s in _split(shape, SHAPES) for m in meshes]
    return sorted(out, key=lambda c: (c[2] != "1x1",
                                      SHAPES[c[1]].kind == "decode",
                                      not c[0].startswith("rwkv")))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="all",
                    help="all, or a comma list of " + ", ".join(MESHES))
    ap.add_argument("--out", default=os.path.join("artifacts",
                                                  "dryrun_torch"))
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at once, one process each")
    ap.add_argument("--override", action="append", default=[],
                    help="configuration field override k=v (repeatable)")
    ap.add_argument("--tag", default="", help="artifact file name suffix")
    ap.add_argument("--micro", type=int, default=0,
                    help="train microbatch count (0 = default_microbatches)")
    args = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in args.override)
    try:
        jobs = [c + (args.out, overrides, args.tag, args.micro)
                for c in cells(args.arch, args.shape, args.mesh)]
    except ValueError as e:
        ap.error(str(e))
    t0 = time.perf_counter()
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
            records = list(pool.map(_run_one, jobs))
    else:
        records = [_run_one(job) for job in jobs]
    for r in records:
        if r["status"] == "FAILED":
            print(f"[{r['arch']} x {r['shape']} x {r['mesh']}] FAILED\n"
                  + r["error"])
    print(summary(records))
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    failures = len(records) - n_ok - n_skip
    print(f"\n== dry-run summary: {n_ok} ok, {n_skip} skipped "
          f"(documented), {failures} FAILED; {time.perf_counter() - t0:.1f} s "
          f"with {args.jobs} process(es) ==")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
