"""Time one CUDA kernel as built from two source trees, in turns, on one
card: the A/B check for a change to a kernel's source.

    python -m repro_torch.kernels.ab_build --base DIR [--change DIR2]
        [--kernel tiled_matmul|decode_attention|smm]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``), ``DIR2`` the tree under test
(default: this checkout).  Both trees' ``csrc/<kernel>.cu`` are compiled
with the build's flags, both libraries are loaded with ``ctypes``, and
the same operands go through each in the order base, change, change,
base (median of 20 CUDA-event timings after a warm-up, per turn):

  tiled_matmul      the densified path's f32 3,960^3
  decode_attention  the serve case's full cache, bf16: B=8, S=4,096,
                    8 KV heads of 6 query heads, Dh=128, cur_len=S
  smm               the blocked path's one size bin, f32, dense, with
                    its run starts: 3,960^2 at block 22, then 4,096^2 at
                    block 64 (smm updates C in place: each turn keeps
                    adding to its own C)

For every shape it prints one JSON line with the card, each turn's time
and whether the two results, each from one launch on the same inputs,
are bitwise equal.  It exits nonzero without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

from . import _build

REPS = 20


def _load(src: Path, out: Path, entry: str):
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True)
    return getattr(ctypes.CDLL(str(out)), entry)


# Each entry makes the operands of one kernel and returns, per shape,
# (argtypes, the launch arguments before the output pointer, the output,
# the arguments after it, a label of the shape, the operand tensors to
# keep alive).


def _tiled_matmul(dev, gen):
    import torch

    n = 3960
    a = torch.randn((n, n), generator=gen, device=dev)
    b = torch.randn((n, n), generator=gen, device=dev)
    argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return [(argtypes, (a.data_ptr(), b.data_ptr()),
             torch.empty((n, n), device=dev), (n, n, n, 0), f"{n}^3 f32",
             (a, b))]


def _decode_attention(dev, gen):
    import torch

    b, s, hkv, r, dh = 8, 4096, 8, 6, 128
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for shape in ((b, hkv, r, dh), (b, s, hkv, dh), (b, s, hkv, dh)))
    cur = torch.tensor([s], dtype=torch.int32, device=dev)
    argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return [(argtypes,
             (q.data_ptr(), k.data_ptr(), v.data_ptr(), cur.data_ptr()),
             torch.empty((b, hkv, r, dh), device=dev),
             (b, s, hkv, r, dh, dh ** -0.5, 1, 1),
             f"B={b} S={s} Hkv={hkv} R={r} Dh={dh} bf16", (q, k, v, cur))]


def _smm(dev, gen):
    import torch

    from ..core.engine import build_executor_plan

    argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    cases = []
    for n, bs in ((3960, 22), (4096, 64)):
        plan = build_executor_plan(n, n, n, bs, bs, bs, 30000)
        (t, r), = plan.device_bins(dev)   # dense: one size bin
        nblk = (n // bs) ** 2
        a = torch.randn((nblk, bs, bs), generator=gen, device=dev)
        b = torch.randn((nblk, bs, bs), generator=gen, device=dev)
        cases.append((argtypes, (a.data_ptr(), b.data_ptr()),
                      torch.zeros((plan.n_c_blocks + 1, bs, bs), device=dev),
                      (t.data_ptr(), r.data_ptr(), int(r.shape[0]),
                       int(t.shape[0]), int(t.shape[1]), bs, bs, bs, 0),
                      f"{n}^2 block {bs} f32, {int(t.shape[0])} rows",
                      (a, b, t, r)))
    return cases


# kernel -> (operands, C entry point)
KERNELS = {"tiled_matmul": (_tiled_matmul, "tiled_matmul_launch"),
           "decode_attention": (_decode_attention, "decode_attention_launch"),
           "smm": (_smm, "smm_process_runs")}


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--base", required=True, type=Path)
    p.add_argument("--change", type=Path,
                   default=Path(__file__).resolve().parents[3])
    p.add_argument("--kernel", choices=sorted(KERNELS), default="tiled_matmul")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_build: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    make, entry = KERNELS[args.kernel]
    rel = Path(f"src/repro_torch/csrc/{args.kernel}.cu")
    fns = {tag: _load(root / rel, _build.BUILD_DIR / f"ab_{args.kernel}_{tag}.so",
                      entry)
           for tag, root in (("base", args.base), ("change", args.change))}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for case in make(dev, gen):
        print(json.dumps(_ab(fns, case, card, args, dev)), flush=True)
    return 0


def _ab(fns, case, card, args, dev) -> dict:
    import torch

    argtypes, before, out, after, shape, _keep = case
    for fn in fns.values():
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    outs = {tag: out.clone() for tag in fns}
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(tag):
        code = fns[tag](*before, outs[tag].data_ptr(), *after, stream)
        if code:
            raise RuntimeError(f"{tag}: CUDA error {code}")

    def turn(tag) -> float:
        launch(tag)
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(tag)
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    turns = [(tag, turn(tag)) for tag in ("base", "change", "change", "base")]
    for tag in fns:   # one launch each from the same output tensor
        outs[tag].copy_(out)
        launch(tag)
    torch.cuda.synchronize()
    return {"kernel": args.kernel, "shape": shape, "card": card,
            "base": str(args.base), "change": str(args.change),
            "turns_ms": turns,
            "max_abs_diff": float((outs["base"] - outs["change"]).abs().max()),
            "bitwise_equal": bool(torch.equal(outs["base"], outs["change"]))}


if __name__ == "__main__":
    sys.exit(main())
