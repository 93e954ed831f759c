"""Time one CUDA kernel as built from two source trees, in turns, on one
card: the A/B check for a change to a kernel's source.

    python -m repro_torch.kernels.ab_build --base DIR [--change DIR2]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``), ``DIR2`` the tree under test
(default: this checkout).  Both trees' ``tiled_matmul.cu`` are
compiled with the build's flags, both libraries are loaded with
``ctypes``, and the same f32 operands of the densified path's 3,960^3 are
multiplied by each in the order base, change, change, base (median of
20 CUDA-event timings after a warm-up, per turn).  It prints one JSON line with the
card, each turn's time and whether the two results are bitwise equal,
and exits nonzero without CUDA.
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

SIZE = 3960  # the densified path's local GEMM (PERF.md case (d))
REPS = 20


def _load(src: Path, out: Path):
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True)
    fn = ctypes.CDLL(str(out)).tiled_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--base", required=True, type=Path)
    p.add_argument("--change", type=Path,
                   default=Path(__file__).resolve().parents[3])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_build: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    rel = Path("src/repro_torch/csrc/tiled_matmul.cu")
    fns = {tag: _load(root / rel, _build.BUILD_DIR / f"ab_{tag}.so")
           for tag, root in (("base", args.base), ("change", args.change))}
    n = SIZE
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((n, n), generator=gen, device=dev)
    b = torch.randn((n, n), generator=gen, device=dev)
    outs = {tag: torch.empty((n, n), device=dev) for tag in fns}
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(tag):
        code = fns[tag](a.data_ptr(), b.data_ptr(), outs[tag].data_ptr(),
                        n, n, n, 0, stream)
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
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"kernel": "tiled_matmul", "size": n, "card": card,
                      "base": str(args.base), "change": str(args.change),
                      "turns_ms": turns,
                      "bitwise_equal": bool(torch.equal(outs["base"],
                                                        outs["change"]))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
