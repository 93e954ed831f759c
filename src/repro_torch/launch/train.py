"""Training launcher, the counterpart of ``repro.launch.train``, on one
device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_1_5b \\
        --steps 20 [--reduced] [--device cpu]

Without ``--reduced`` the published configuration trains at full width
(in its dtype, with its remat policy) on the card; ``--reduced`` runs
the same code path at smoke scale, and ``--device cpu`` on the CPU.
Fault tolerance is on: periodic checkpoints in ``--ckpt-dir``, a
restore from the newest one found there at start and after a failed
step, and a straggler watchdog.  Weights are random, drawn from seed 0.

The reference's sharding options are not carried over: ``--mesh``
accepts only ``1x1`` (multi-card meshes and the production mesh wait
for ROADMAP A3's remainder; ``launch.specs`` and ``launch.dryrun`` give
their specs and per-device sizes) and ``--device-count``, the XLA host
device override, has no counterpart.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.models import transformer as T
from repro_torch.models.common import resolve_device, tree_leaves
from repro_torch.train.data import make_batch
from repro_torch.train.elastic import StragglerWatchdog, run_loop
from repro_torch.train.optimizer import OptConfig, make_optimizer
from repro_torch.train.train_step import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_1_5b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--mesh", default="1x1",
                    help="only 1x1: one device (data x model)")
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
    if args.mesh != "1x1":
        raise ValueError(
            f"--mesh {args.mesh}: the port trains on one device (1x1); "
            "multi-card meshes and the production mesh wait for ROADMAP "
            "A3's remainder (the torch.distributed backend); A12 ported "
            "their specs only")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch={cfg.name} mesh=1x1 on {name} steps={args.steps}")

    opt = make_optimizer(OptConfig(name=args.optimizer, lr=args.lr))
    params = T.model_init(cfg, torch.Generator(dev).manual_seed(0),
                          device=dev)
    opt_state = opt.init(params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"params: {n_params / 1e6:.1f}M")

    step_fn = make_train_step(cfg, opt, n_microbatches=args.microbatches)

    def mb(step):
        b = make_batch(step, global_batch=args.global_batch,
                       seq_len=args.seq, vocab=cfg.vocab_size,
                       input_mode=cfg.input_mode, d_model=cfg.d_model)
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    watchdog = StragglerWatchdog()
    result = run_loop(
        train_step=step_fn, make_batch=mb, params=params,
        opt_state=opt_state, n_steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        watchdog=watchdog)
    hist = result["history"]
    print(f"done: {len(hist)} steps, restarts={result['restarts']}, "
          f"stragglers={result['stragglers']}")
    if hist:
        print(f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
