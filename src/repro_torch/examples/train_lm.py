"""End-to-end LM training example, the port's counterpart of
``examples/train_lm.py``: synthetic data -> train loop -> checkpoints ->
recovery, on any of the 10 archs at a reduced width, on one device.

The default runs a ~25M-param qwen2-style model for 30 steps;
``--preset 100m --steps 300`` is the "train a ~100M model for a few
hundred steps" configuration (same code path, bigger dims).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 30
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m --steps 300

Weights are random, drawn from seed 0.  ``--device cpu`` runs on the
CPU; the default is CUDA.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.models import transformer as T
from repro_torch.models.common import resolve_device, tree_leaves
from repro_torch.train.data import make_batch
from repro_torch.train.elastic import StragglerWatchdog, run_loop
from repro_torch.train.optimizer import OptConfig, make_optimizer
from repro_torch.train.train_step import make_train_step

PRESETS = {
    # ~25M params: quick sanity run
    "25m": dict(d_model=256, num_layers=8, num_heads=8, num_kv_heads=2,
                head_dim=32, d_ff=1024, vocab_size=4096, dtype="float32"),
    # ~100M params: the deliverable configuration
    "100m": dict(d_model=640, num_layers=12, num_heads=10, num_kv_heads=2,
                 head_dim=64, d_ff=2560, vocab_size=32768, dtype="float32"),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_1_5b")
    ap.add_argument("--preset", default="25m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join("artifacts",
                                                       "train_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced_config(get_config(args.arch), **PRESETS[args.preset])
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch={cfg.name} (reduced {args.preset}) on {name}")

    params = T.model_init(cfg, torch.Generator(dev).manual_seed(0),
                          device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"params: {n_params / 1e6:.1f}M")

    opt = make_optimizer(OptConfig(lr=args.lr))
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt)

    def mb(step):
        b = make_batch(step, global_batch=args.batch, seq_len=args.seq,
                       vocab=cfg.vocab_size, input_mode=cfg.input_mode,
                       d_model=cfg.d_model)
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    watchdog = StragglerWatchdog()
    t0 = time.time()
    result = run_loop(
        train_step=step_fn, make_batch=mb, params=params,
        opt_state=opt_state, n_steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        watchdog=watchdog)
    hist = result["history"]
    dt = time.time() - t0
    print(f"\n{len(hist)} steps in {dt:.1f}s "
          f"({dt / max(len(hist), 1):.2f} s/step), "
          f"restarts={result['restarts']}")
    for h in hist[:3] + hist[-3:]:
        print(f"  step {h['step']:4d}  loss {h['loss']:.4f}  "
              f"{h['dt'] * 1e3:.0f} ms")
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"loss: {first:.4f} -> {last:.4f} "
          f"({'OK: decreasing' if last < first else 'WARNING: not decreasing'})")


if __name__ == "__main__":
    main()
