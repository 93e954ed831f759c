"""Time one CUDA kernel as built from two source trees, in turns, on one
card: the A/B check for a change to a kernel's source.

    python -m repro_torch.kernels.ab_build --base DIR [--change DIR2 ...]
        [--kernel tiled_matmul|grouped_gemm|decode_attention|smm]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``), each ``DIR2`` a tree under test
(default: this checkout).  Every tree's ``csrc/<kernel>.cu`` is compiled
with the build's flags, one ``nvcc`` each, all at once; the libraries
are loaded with ``ctypes``, and for each tree under test the same
operands go through the base and it in the order base, change, change,
base (median of 20 CUDA-event timings after a warm-up, per turn):

  tiled_matmul      the densified path's f32 3,960^3, then a ragged
                    1,000 x 777 x 1,030 (N no multiple of 4: the
                    one-element copies)
  grouped_gemm      the batched densified path's f32 16 x 1,980^3, then
                    a ragged 3 x 200 x 333 x 130
  decode_attention  the serve case's cache, bf16: B=8, S=4,096, 8 KV
                    heads of 6 query heads, Dh=128, at cur_len=S and at
                    cur_len=2,064 (each tree called with the argument list
                    its library takes: ``decode_attention_abi``)
  smm               the blocked path's one size bin, f32, dense, with
                    its run starts: 3,960^2 at block 22, then 4,096^2 at
                    block 64 (smm updates C in place: each turn keeps
                    adding to its own C)

For every shape it prints one JSON line with the card, each turn's time
and whether the two results, each from one launch on the same inputs,
are bitwise equal (compared as f32 where the two trees write different
types).  It exits nonzero without CUDA.
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


def _load_all(srcs, kernel: str):
    """Compile every source at once; their libraries, in order."""
    jobs = {f"tree {i}, {src}":
            (src, _build.BUILD_DIR / f"ab_{kernel}_{i}.so")
            for i, src in enumerate(srcs)}
    _build.compile_all(jobs)
    return [ctypes.CDLL(str(lib)) for _, lib in jobs.values()]


def _abi(lib: ctypes.CDLL, kernel: str) -> int:
    """The version of a library's argument list (1 where it has none)."""
    try:
        fn = getattr(lib, f"{kernel}_abi")
    except AttributeError:
        return 1
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


# Each entry makes the operands of one kernel and returns, per shape, a
# function of the library's argument-list version giving (argtypes, the
# launch arguments before the output pointer, the output, the arguments
# after it, a label of the shape, the operand tensors to keep alive).


def _gemm(dev, gen, shapes, batched):
    """f32 ``(E, M, K) @ (E, K, N)`` cases; the batched entry point takes
    E before (M, N, K), tiled_matmul's has no E."""
    import torch

    argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * (5 if batched else 4) \
        + [ctypes.c_void_p]
    cases = []
    for e, m, k, n in shapes:
        a = torch.randn((e, m, k), generator=gen, device=dev)
        b = torch.randn((e, k, n), generator=gen, device=dev)
        dims = ((e,) if batched else ()) + (m, n, k, 0)
        label = (f"{e} x " if batched else "") + (
            f"{m}^3 f32" if m == k == n else f"{m} x {k} x {n} f32")
        case = (argtypes, (a.data_ptr(), b.data_ptr()),
                torch.empty((e, m, n), device=dev), dims, label, (a, b))
        cases.append(lambda abi, case=case: case)
    return cases


def _tiled_matmul(dev, gen):
    return _gemm(dev, gen, ((1, 3960, 3960, 3960), (1, 1000, 777, 1030)),
                 batched=False)


def _grouped_gemm(dev, gen):
    return _gemm(dev, gen, ((16, 1980, 1980, 1980), (3, 200, 333, 130)),
                 batched=True)


def _decode_attention(dev, gen):
    import torch

    from .decode_attention.ops import device_plan

    b, s, hkv, r, dh = 8, 4096, 8, 6, 128
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for shape in ((b, hkv, r, dh), (b, s, hkv, dh), (b, s, hkv, dh)))
    pl = device_plan(dev.index or 0, b, hkv, r, dh, s, torch.bfloat16)
    cases = []
    for cur_len in (s, 2064):
        cur = torch.tensor([cur_len], dtype=torch.int32, device=dev)
        label = f"B={b} S={s} Hkv={hkv} R={r} Dh={dh} bf16 cur_len={cur_len}"
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), cur.data_ptr())

        def case(abi, cur=cur, label=label, ptrs=ptrs):
            if abi == 1:   # f32 out, a vec flag
                argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
                return (argtypes, ptrs,
                        torch.empty((b, hkv, r, dh), device=dev),
                        (b, s, hkv, r, dh, dh ** -0.5, 1, 1), label,
                        (q, k, v, cur))
            argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
                + [ctypes.c_float] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            return (argtypes, ptrs,
                    torch.empty((b, hkv, r, dh), dtype=torch.bfloat16,
                                device=dev),
                    (b, s, hkv, r, dh, dh ** -0.5, 1, pl.rpg, pl.nrg, pl.kr,
                     pl.dpl, pl.warps, pl.nsplit, 16), label, (q, k, v, cur))

        cases.append(case)
    return cases


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
        case = (argtypes, (a.data_ptr(), b.data_ptr()),
                torch.zeros((plan.n_c_blocks + 1, bs, bs), device=dev),
                (t.data_ptr(), r.data_ptr(), int(r.shape[0]),
                 int(t.shape[0]), int(t.shape[1]), bs, bs, bs, 0),
                f"{n}^2 block {bs} f32, {int(t.shape[0])} rows",
                (a, b, t, r))
        cases.append(lambda abi, case=case: case)
    return cases


# kernel -> (operands, C entry point)
KERNELS = {"tiled_matmul": (_tiled_matmul, "tiled_matmul_launch"),
           "grouped_gemm": (_grouped_gemm, "grouped_gemm_launch"),
           "decode_attention": (_decode_attention, "decode_attention_launch"),
           "smm": (_smm, "smm_process_runs")}


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--base", required=True, type=Path)
    p.add_argument("--change", type=Path, nargs="+",
                   default=[Path(__file__).resolve().parents[3]])
    p.add_argument("--kernel", choices=sorted(KERNELS), default="tiled_matmul")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_build: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    make, entry = KERNELS[args.kernel]
    rel = Path(f"src/repro_torch/csrc/{args.kernel}.cu")
    trees = [args.base, *args.change]
    libs = _load_all([root / rel for root in trees], args.kernel)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cases = make(dev, gen)
    for change, lib in zip(args.change, libs[1:]):
        pair = {"base": libs[0], "change": lib}
        fns = {tag: getattr(lib, entry) for tag, lib in pair.items()}
        abis = {tag: _abi(lib, args.kernel) for tag, lib in pair.items()}
        for case in cases:
            print(json.dumps(_ab(fns, {tag: case(abi)
                                       for tag, abi in abis.items()},
                                 card, args, change, dev)), flush=True)
    return 0


def _ab(fns, cases, card, args, tree, dev) -> dict:
    import torch

    for tag, fn in fns.items():
        fn.argtypes, fn.restype = cases[tag][0], ctypes.c_int
    outs = {tag: case[2].clone() for tag, case in cases.items()}
    shape = cases["change"][4]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(tag):
        _, before, _, after, _, _ = cases[tag]
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
        outs[tag].copy_(cases[tag][2])
        launch(tag)
    torch.cuda.synchronize()
    base, change = outs["base"], outs["change"]
    if base.dtype != change.dtype:
        base, change = base.float(), change.float()
    return {"kernel": args.kernel, "shape": shape, "card": card,
            "base": str(args.base), "change": str(tree),
            "turns_ms": turns,
            "max_abs_diff": float((base - change).abs().max()),
            "bitwise_equal": bool(torch.equal(base, change))}


if __name__ == "__main__":
    sys.exit(main())
