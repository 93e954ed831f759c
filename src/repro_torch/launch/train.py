"""Training launcher, the counterpart of ``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_1_5b \\
        --steps 20 [--reduced] [--device cpu]
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --mesh 2x2 [--reduced] [--device cpu]

Without ``--reduced`` the published configuration trains at full width
(in its dtype, with its remat policy) on the card; ``--reduced`` runs
the same code path at smoke scale, and ``--device cpu`` on the CPU.
Fault tolerance is on: periodic checkpoints in ``--ckpt-dir``, a
restore from the newest one found there at start and after a failed
step, and a straggler watchdog.  Weights are random, drawn from seed 0.

``--mesh AxB`` (``data`` x ``model``) or ``PxAxB`` (``pod`` x ``data``
x ``model``) other than 1x1 runs under ``torch.distributed.run`` with
that many processes, one rank a process (``make_launch_mesh``: NCCL
where each process has a card of its own, else gloo); each process
holds its shards of the parameters, the ZeRO optimizer state and its
data shard of every batch, and checkpoints are written whole, so a run
resumes on any mesh.  ``1x1`` alone runs in process.  The reference's
``--device-count``, the XLA host device override, has no counterpart.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.launch.processes import launched, make_launch_mesh
from repro_torch.models import transformer as T
from repro_torch.models.common import resolve_device, tree_leaves
from repro_torch.train.data import make_batch
from repro_torch.train.elastic import StragglerWatchdog, run_loop
from repro_torch.train.optimizer import OptConfig, make_optimizer
from repro_torch.train.train_step import (init_opt_state, make_train_step,
                                          shard_batch, state_specs)

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def parse_mesh(text: str):
    """"AxB" or "PxAxB" -> (shape, axes)."""
    shape = tuple(int(x) for x in text.lower().split("x"))
    if len(shape) not in AXES or min(shape) < 1:
        raise ValueError(f"--mesh {text}: give AxB (data x model) or PxAxB "
                         "(pod x data x model)")
    return shape, AXES[len(shape)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_1_5b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--mesh", default="1x1",
                    help="AxB (data x model) or PxAxB; beyond 1x1 under "
                         "torch.distributed.run, one process a rank")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join("artifacts",
                                                       "train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    shape, axes = parse_mesh(args.mesh)
    mesh = None
    if shape != (1,) * len(shape):
        if not launched():
            raise ValueError(
                f"--mesh {args.mesh}: run it under torch.distributed.run "
                f"with {int(torch.tensor(shape).prod())} processes (one "
                "rank a process); 1x1 alone runs in process")
        mesh = make_launch_mesh(shape, axes, device=args.device)
        dev = mesh.device
    else:
        dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    lead = mesh is None or mesh.rank == 0
    if lead:
        print(f"arch={cfg.name} mesh={args.mesh} on {name} "
              f"steps={args.steps}"
              + ("" if mesh is None else f" ({mesh.transport})"))

    opt = make_optimizer(OptConfig(name=args.optimizer, lr=args.lr,
                                   zero=mesh is not None))
    params = T.model_init(cfg, torch.Generator(dev).manual_seed(0),
                          device=dev, mesh=mesh)
    opt_state = init_opt_state(opt, params, cfg, mesh)
    n_params = sum(p.numel() for p in tree_leaves(T.model_param_shapes(cfg)))
    if lead:
        print(f"params: {n_params / 1e6:.1f}M")

    step_fn = make_train_step(cfg, opt, n_microbatches=args.microbatches,
                              mesh=mesh)

    def mb(step):
        b = make_batch(step, global_batch=args.global_batch,
                       seq_len=args.seq, vocab=cfg.vocab_size,
                       input_mode=cfg.input_mode, d_model=cfg.d_model)
        return shard_batch({k: torch.from_numpy(v).to(dev)
                            for k, v in b.items()}, mesh)

    watchdog = StragglerWatchdog()
    result = run_loop(
        train_step=step_fn, make_batch=mb, params=params,
        opt_state=opt_state, n_steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        watchdog=watchdog, mesh=mesh,
        specs=None if mesh is None else state_specs(cfg, opt, mesh))
    hist = result["history"]
    if lead:
        print(f"done: {len(hist)} steps, restarts={result['restarts']}, "
              f"stragglers={result['stragglers']}")
        if hist:
            print(f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
