#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of DBCSR on one GPU and check it.

    python3 chip_smoke.py

Phase 0  prints the card (nvidia-smi name and power limit) and builds
         the three CUDA kernels from src/repro_torch/csrc, timing the
         build.
Phase 1  holds each kernel against its plain PyTorch version on the card:
         smm at blocks 4, 22 and 64 (f32 and bf16), with a ragged final
         stack, valid == 0 rows and a masked plan of several size bins;
         tiled_matmul at a shape that is no tile multiple, f32 and bf16;
         grouped_gemm at a ragged shape and at E = 1, f32 and bf16.
Phase 2  runs the main path, dbcsr.create -> dbcsr.multiply with
         algorithm="cannon" on a 1x1 mesh, at the size of one rank of
         the paper's 63,360^2 matrices on a 16x16 grid:
           (a) 3,960^2, block 22, blocked, dense
           (b) 4,096^2, block 64, blocked, dense
           (c) 3,960^2, block 22, blocked, A at ~20% block fill, at the
               default stack size and at stacks <= 64 (several size
               bins), plus filter_eps=0 (bitwise equal to no filter)
               and eps > 0
           (d) 3,960^2, densified, local_kernel="pallas" (tiled_matmul)
           (e) 3,960^2, densified, torch.matmul
         Each result is held against torch.matmul of the mask-applied
         dense operands (f32, TF32 off); each case's launch counters are
         zeroed just before the multiply and read just after.
Phase 3  times each kernel at the shapes of (a), (b), (c) (both stack
         sizes) and (d), the fused smm launch at (f) and grouped_gemm at
         (h): median of CUDA-event timings after a warm-up, beside its
         bound (the larger of flop / f32 non-tensor peak and bytes / HBM
         rate), the plain version (smm: stack by stack) and torch.matmul
         (torch.bmm for a batch) of the operands, which computes the same
         function for every timed plan (absent blocks are stored as
         zeros).
Phase 4  runs the serving path, MultiplyService(fused=True,
         algorithm="cannon") -> dbcsr.multiply_batched on a 1x1 mesh, at
         one rank of the paper's 63,360^2 matrices on a 32x32 grid
         (1,980^2 = 90^2 blocks of 22), as a k-point-style batch of 16
         requests:
           (f) 16 dense requests, blocked: one bucket, ONE smm launch
           (g) 8 dense + 8 with A at ~20% block fill, blocked: two
               buckets, two smm launches; with filter_eps None, 0 and
               in a gap of the norm products
           (h) 16 dense requests, densified, local_kernel="pallas": ONE
               grouped_gemm launch, no tiled_matmul
           (i) 16 dense requests, densified, torch.bmm
         Each case submits, flushes and collects with the launch counters
         zeroed just before and read just after; each product is held
         against torch.matmul (or, under eps > 0, against the
         per-request multiply and its mask), blocked fused results with
         eps in {None, 0} against dbcsr.multiply_batched(fused=False)
         bitwise, and stats() must show every request fused with no
         retry, degradation or error ticket.  It prints the host time of
         the first and the repeat flush against the looped dispatch.

Prints a {"kernels": [...]} line, the nvidia-smi line, and as its last
line {"ok": true, "device": {...}}.  Any failed check raises, so the
script exits nonzero before that line.  Without CUDA it exits 1 at once.

Tolerances.  Kernel vs plain and port vs torch.matmul are both f32 sums
of the same products in different orders; errors are held to 1e-5 of
max|C| (bf16 inputs are exact in f32, so the same bound holds).
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
REL_TOL = 1e-5
SEED = 0


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def peaks(name: str):
    """Published dense rates of the part: (f32 non-tensor FLOP/s, HBM
    bytes/s).  NVIDIA data sheets; the SXM part unless named otherwise."""
    if "PCIe" in name:
        return 51e12, 2.0e12
    if "NVL" in name:
        return 60e12, 3.9e12
    return 67e12, 3.35e12


def rel_err(x, ref) -> float:
    scale = float(ref.abs().max())
    return float((x - ref).abs().max()) / (scale if scale else 1.0)


def check_close(what: str, x, ref, tol: float = REL_TOL) -> float:
    err = rel_err(x, ref)
    print(f"  {what}: max err / max|C| = {err:.3e}")
    if not err <= tol:
        raise AssertionError(f"{what}: relative error {err:.3e} > {tol:g}")
    return float((x - ref).abs().max())


def time_ms(fn, reps: int, setup=None) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(REPO, "src"))
    import numpy as np

    from repro_torch.core import dbcsr
    from repro_torch.core.cannon import cannon_step_masks, cannon_step_norms
    from repro_torch.core.densify import to_blocks, to_blocks_batched
    from repro_torch.core.engine import (build_batched_executor_plan,
                                         build_executor_plan)
    from repro_torch.kernels import _build
    from repro_torch.kernels.grouped_gemm.ops import (grouped_gemm,
                                                      grouped_process_stack)
    from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref
    from repro_torch.kernels.smm.ops import smm_process_stack, stack_run_starts
    from repro_torch.kernels.smm.ref import smm_process_stack_ref
    from repro_torch.kernels.tiled_matmul.ops import tiled_matmul
    from repro_torch.kernels.tiled_matmul.ref import tiled_matmul_ref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import MultiplyService

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    flops_peak, hbm_rate = peaks(name)
    card = card_line()
    rng = np.random.RandomState(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err_abs = {"smm": 0.0, "tiled_matmul": 0.0, "grouped_gemm": 0.0}

    # ---------------------------------------------------------- phase 0
    print("phase 0: card and build")
    print(f"  nvidia-smi: {card}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {name}")
    t0 = time.perf_counter()
    built = _build.build()
    per_source = ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in built.items())
    print(f"  built {sorted(built)} in {time.perf_counter() - t0:.2f} s "
          f"(one nvcc per source, in parallel: {per_source})")

    # ---------------------------------------------------------- phase 1
    print("phase 1: kernels against their plain versions")

    def smm_case(label, plan, dtype, invalidate=0.0):
        nblk_a = plan.nbr * plan.nbk
        nblk_b = plan.nbk * plan.nbc
        a = torch.randn((nblk_a, plan.block_m, plan.block_k), generator=gen,
                        device=dev).to(dtype)
        b = torch.randn((nblk_b, plan.block_k, plan.block_n), generator=gen,
                        device=dev).to(dtype)
        c0 = torch.randn((plan.n_c_blocks + 1, plan.block_m, plan.block_n),
                         generator=gen, device=dev)
        ck, cp = c0.clone(), c0.clone()
        for tri in plan.bin_triples:
            t = np.array(tri.reshape(-1, 4))
            if invalidate:
                # mark some real rows invalid: the kernel must skip them
                real = np.flatnonzero(t[:, 3] != 0)
                t[rng.choice(real, int(invalidate * real.size),
                             replace=False), 3] = 0
            r = torch.tensor(stack_run_starts(t), device=dev)
            t = torch.tensor(t, device=dev)
            smm_process_stack(a, b, ck, t, r)
            smm_process_stack_ref(a, b, cp, t)
        torch.cuda.synchronize()
        err_abs["smm"] = max(err_abs["smm"], check_close(
            f"smm {label} {str(dtype)[6:]} ({plan.n_bins} bins, "
            f"{plan.n_entries} triples)", ck[:-1], cp[:-1]))

    for blk, nb, stack in ((4, 40, 990), (22, 30, 990), (64, 12, 990)):
        plan = build_executor_plan(blk * nb, blk * nb, blk * nb, blk, blk,
                                   blk, stack)
        if plan.plans[-1].size == plan.plans[0].size:
            raise AssertionError(f"block {blk}: no ragged final stack")
        for dtype in (torch.float32, torch.bfloat16):
            smm_case(f"block {blk}, ragged tail", plan, dtype)
        smm_case(f"block {blk}, 10% valid=0 rows", plan, torch.float32,
                 invalidate=0.1)
    # ragged runs of ~8 triples packed into stacks of at most 8: stack
    # lengths differ enough for the executor to size-bin them
    nb = 40
    a_mask = rng.rand(nb, nb) < 0.2
    plan = build_executor_plan(22 * nb, 22 * nb, 22 * nb, 22, 22, 22, 8,
                               a_mask=a_mask)
    if plan.n_bins < 2:
        raise AssertionError(f"masked plan has {plan.n_bins} bin(s)")
    for dtype in (torch.float32, torch.bfloat16):
        smm_case("block 22, 20% A mask", plan, dtype)

    for m, k, n in ((1000, 777, 1030), (129, 3960, 257)):
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            b = torch.randn((k, n), generator=gen, device=dev).to(dtype)
            out, ref = tiled_matmul(a, b), tiled_matmul_ref(a, b)
            torch.cuda.synchronize()
            err_abs["tiled_matmul"] = max(err_abs["tiled_matmul"], check_close(
                f"tiled_matmul {m}x{k}x{n} {str(dtype)[6:]}", out, ref))

    for e, m, k, n in ((3, 200, 333, 130), (1, 1000, 777, 1030)):
        for dtype in (torch.float32, torch.bfloat16):
            t = torch.randn((e, m, k), generator=gen, device=dev).to(dtype)
            w = torch.randn((e, k, n), generator=gen, device=dev).to(dtype)
            out, ref = grouped_gemm(t, w), grouped_gemm_ref(t, w)
            torch.cuda.synchronize()
            err_abs["grouped_gemm"] = max(err_abs["grouped_gemm"], check_close(
                f"grouped_gemm {e}x{m}x{k}x{n} {str(dtype)[6:]}", out, ref))

    # ---------------------------------------------------------- phase 2
    print("phase 2: dbcsr.create -> dbcsr.multiply on a 1x1 mesh")
    mesh = make_mesh((1, 1), ("data", "model"))
    counters = {"smm": smm_process_stack, "tiled_matmul": tiled_matmul,
                "grouped_gemm": grouped_gemm}
    launches = {key: 0 for key in counters}

    def zero_counters():
        for fn in counters.values():
            fn.launches = 0

    def read_counters():
        got = {key: fn.launches for key, fn in counters.items()}
        for key in launches:
            launches[key] += got[key]
        return got

    def run(label, a, b, **kw):
        zero_counters()
        torch.cuda.synchronize()
        t = time.perf_counter()
        c = dbcsr.multiply(a, b, mesh=mesh, algorithm="cannon", **kw)
        torch.cuda.synchronize()
        first = time.perf_counter() - t
        got = read_counters()
        repeats = []
        for _ in range(3):
            t = time.perf_counter()
            again = dbcsr.multiply(a, b, mesh=mesh, algorithm="cannon", **kw)
            torch.cuda.synchronize()
            repeats.append(time.perf_counter() - t)
            if not torch.equal(again.data, c.data):
                raise AssertionError(f"{label}: a repeated multiply differs")
        print(f"  {label}: first call {first:.3f} s (plan build included), "
              f"repeat median of 3 {1e3 * statistics.median(repeats):.2f} ms "
              f"(min {1e3 * min(repeats):.2f}); launches {got}")
        return c, got

    def dense(n):
        return torch.randn((n, n), generator=gen, device=dev)

    def expect_launches(got, key, want):
        if got[key] != want:
            raise AssertionError(f"{key} launched {got[key]} times, expected {want}")

    # (a) 3,960^2 at block 22, dense
    A = dbcsr.create(dense(3960), mesh=mesh, block_size=22)
    B = dbcsr.create(dense(3960), mesh=mesh, block_size=22)
    exact = torch.matmul(A.data, B.data)
    c, got = run("(a) 3960^2 block 22 blocked", A, B, densify=False)
    check_close("(a) vs torch.matmul", c.data, exact)
    plan_a = build_executor_plan(3960, 3960, 3960, 22, 22, 22, 30000)
    expect_launches(got, "smm", plan_a.n_bins)
    if c.block_mask is not None:
        raise AssertionError("(a) dense product carries a mask")

    # (d) and (e): the densified path on the same operands
    c, got = run("(d) 3960^2 densified pallas", A, B, densify=True,
                 local_kernel="pallas")
    check_close("(d) vs torch.matmul", c.data, exact)
    if got["tiled_matmul"] < 1:
        raise AssertionError("(d) never launched tiled_matmul")
    c, got = run("(e) 3960^2 densified torch.matmul", A, B, densify=True)
    check_close("(e) vs torch.matmul", c.data, exact)

    # (c) A at ~20% block fill, first at the default stack size, then at
    # stack_size 64, which makes the ragged runs (~36 triples each) pack
    # into stacks of very different lengths, so the plan has several
    # size bins
    nb = 180
    am = rng.rand(nb, nb) < 0.2
    # block scales over two decades give the norm filter work to do
    scale = np.repeat(np.repeat(10.0 ** (-2 * rng.rand(nb, nb)), 22, 0), 22, 1)
    Am = dbcsr.create(dense(3960) * torch.tensor(scale, dtype=torch.float32,
                                                 device=dev),
                      mesh=mesh, block_size=22, block_mask=am)
    exact = torch.matmul(Am.data, B.data)
    bm = np.ones((nb, nb), dtype=bool)
    c_def, got = run("(c) 3960^2 block 22 blocked, 20% A mask, default "
                     "stacks", Am, B, densify=False)
    check_close("(c) default stacks vs torch.matmul", c_def.data, exact)
    plan_c_def = build_executor_plan(
        3960, 3960, 3960, 22, 22, 22, 30000,
        pair_mask=cannon_step_masks(am, bm, 1)[0])
    expect_launches(got, "smm", plan_c_def.n_bins)
    del c_def
    c_none, got = run("(c) 3960^2 block 22 blocked, 20% A mask, stacks "
                      "<= 64", Am, B, densify=False, stack_size=64)
    check_close("(c) vs torch.matmul", c_none.data, exact)
    plan_c = build_executor_plan(
        3960, 3960, 3960, 22, 22, 22, 64,
        pair_mask=cannon_step_masks(am, bm, 1)[0])
    if plan_c.n_bins < 2:
        raise AssertionError(f"(c) plan has {plan_c.n_bins} bin(s)")
    expect_launches(got, "smm", plan_c.n_bins)
    sym = (am.astype(np.int64) @ bm.astype(np.int64)) > 0
    if not np.array_equal(c_none.block_mask, sym):
        raise AssertionError("(c) result mask != symbolic product mask")

    c0, got = run("(c) filter_eps=0", Am, B, densify=False, stack_size=64,
                  filter_eps=0.0)
    if not torch.equal(c0.data, c_none.data):
        raise AssertionError("(c) filter_eps=0 is not bitwise equal to None")
    if not np.array_equal(c0.block_mask, sym):
        raise AssertionError("(c) eps=0 mask != symbolic product mask")

    an, bn = Am.norms(), B.norms()
    # norm products as the step plan forms them (float32, compared in
    # float64); eps sits in a wide gap between two of them near the
    # median, so no product is within rounding of the threshold
    prod = (an[:, :, None] * bn[None]).astype(np.float64)
    present = am[:, :, None] & bm[None]
    srt = np.sort(prod[present])
    mid = srt.size // 2
    gaps = srt[mid - 1000:mid + 1000] / srt[mid - 1001:mid + 999]
    i = mid - 1001 + int(np.argmax(gaps))
    eps = float(np.sqrt(srt[i] * srt[i + 1]))
    c_eps, got = run(f"(c) filter_eps={eps:.4g}", Am, B, densify=False,
                     stack_size=64, filter_eps=eps)
    dropped = present & (prod < eps)
    retained = (present & (prod >= eps)).any(axis=1)
    if not np.array_equal(c_eps.block_mask, retained):
        raise AssertionError("(c) eps result mask != retained product mask")
    plan_eps = build_executor_plan(
        3960, 3960, 3960, 22, 22, 22, 64,
        pair_mask=cannon_step_masks(am, bm, 1)[0],
        pair_norms=cannon_step_norms(np.where(am, an, np.float32(0)), bn, 1)[0],
        filter_eps=eps)
    expect_launches(got, "smm", plan_eps.n_bins)
    # each block may miss at most its dropped contributions
    bound = (np.where(dropped, prod, 0.0).sum(axis=1)
             + REL_TOL * float(exact.abs().max()) * 22)
    diff = (c_eps.data - exact).reshape(nb, 22, nb, 22)
    blk_err = torch.sqrt((diff.double() ** 2).sum(dim=(1, 3))).cpu().numpy()
    worst = float((blk_err / bound).max())
    print(f"  (c) eps: {int(dropped.sum())} of {int(present.sum())} triples "
          f"dropped; worst block error / dropped bound = {worst:.3f}")
    if not worst <= 1.0:
        raise AssertionError("(c) eps error exceeds the dropped-norm bound")
    del c_none, c0, c_eps

    # (b) 4,096^2 at block 64, dense
    A64 = dbcsr.create(dense(4096), mesh=mesh, block_size=64)
    B64 = dbcsr.create(dense(4096), mesh=mesh, block_size=64)
    c, got = run("(b) 4096^2 block 64 blocked", A64, B64, densify=False)
    check_close("(b) vs torch.matmul", c.data, torch.matmul(A64.data, B64.data))
    plan_b = build_executor_plan(4096, 4096, 4096, 64, 64, 64, 30000)
    expect_launches(got, "smm", plan_b.n_bins)
    del c

    # the batched path's operands: 16 requests at one rank of 63,360^2 on
    # a 32x32 grid (1,980^2, 90^2 blocks of 22)
    G, NB, BS = 16, 1980, 22
    nbb = NB // BS
    dense_reqs = [(dbcsr.create(dense(NB), mesh=mesh, block_size=BS),
                   dbcsr.create(dense(NB), mesh=mesh, block_size=BS))
                  for _ in range(G)]
    a_stack = torch.stack([a.data for a, _ in dense_reqs])
    b_stack = torch.stack([b.data for _, b in dense_reqs])
    t = time.perf_counter()
    plan_f = build_batched_executor_plan(NB, NB, NB, BS, BS, BS,
                                         [{}] * G, stack_size=30000)
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    plan_f.device_triples(dev)
    torch.cuda.synchronize()
    print(f"  (f)'s fused plan: host build {build_s:.3f} s, upload "
          f"{time.perf_counter() - t:.3f} s (memoized: phase 4 reuses both)")
    if plan_f.n_launches != 1:
        raise AssertionError(f"(f) plan launches {plan_f.n_launches}")

    # ---------------------------------------------------------- phase 3
    print(f"phase 3: times (median of CUDA events; {card})")

    def smm_times(label, plan, a, b):
        a_blocks = to_blocks(a, plan.block_m, plan.block_k)
        b_blocks = to_blocks(b, plan.block_k, plan.block_n)
        c = torch.zeros((plan.n_c_blocks + 1, plan.block_m, plan.block_n),
                        device=dev)
        bins = plan.device_bins(dev)

        def kernel():
            for t, r in bins:
                smm_process_stack(a_blocks, b_blocks, c, t, r)

        def plain():
            for (t, _), tri in zip(bins, plan.bin_triples):
                tile = tri.shape[1]
                for s in range(0, t.shape[0], tile):
                    smm_process_stack_ref(a_blocks, b_blocks, c, t[s:s + tile])

        ms = time_ms(kernel, 5, setup=c.zero_)
        out_k = c[:-1].clone()
        plain_ms = time_ms(plain, 3, setup=c.zero_)
        err_abs["smm"] = max(err_abs["smm"], check_close(
            f"smm {label} kernel vs plain", out_k, c[:-1]))
        # absent blocks are stored as zeros, so one dense torch.matmul
        # computes the same function for dense and mask-only plans (an
        # eps plan, which drops present products, is never timed here)
        library_ms = time_ms(lambda: torch.matmul(a, b), 10)
        flops = 2.0 * plan.n_entries * plan.block_m * plan.block_k * plan.block_n
        # bytes this plan needs: the A and B blocks its triples name, C
        # read and written once, the triples and run starts
        rows = sum(int(t.shape[0]) for t, _ in bins)
        runs = sum(int(r.shape[0]) for _, r in bins)
        used = np.concatenate([p.triples for p in plan.plans])
        nbytes = (np.unique(used[:, 0]).size * plan.block_m * plan.block_k
                  * a_blocks.element_size()
                  + np.unique(used[:, 1]).size * plan.block_k * plan.block_n
                  * b_blocks.element_size()
                  + 2 * plan.n_c_blocks * plan.block_m * plan.block_n * 4
                  + rows * 16 + runs * 4)
        return report("smm", label, ms, plain_ms, library_ms, flops, nbytes,
                      plan.n_launches)

    def report(kernel, label, ms, plain_ms, library_ms, flops, nbytes,
               per_call):
        t_flop = 1e3 * flops / flops_peak
        t_byte = 1e3 * nbytes / hbm_rate
        row = {"shape": label, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_flop, t_byte),
               "bound_by": "operations" if t_flop >= t_byte else "bytes",
               "library_ms": library_ms, "launches_per_multiply": per_call,
               "flop": flops, "bytes": nbytes}
        print(f"  {kernel} {label}: kernel {ms:.3f} ms, launches/multiply "
              f"{per_call}, bound {row['bound_ms']:.3f} ms ({row['bound_by']}), "
              f"plain {plain_ms:.3f} ms, library {library_ms:.3f} ms")
        return row

    smm_rows = [smm_times("3960^2 block 22 dense", plan_a, A.data, B.data),
                smm_times("4096^2 block 64 dense", plan_b, A64.data, B64.data),
                smm_times("3960^2 block 22 A 20% fill, default stacks",
                          plan_c_def, Am.data, B.data),
                smm_times("3960^2 block 22 A 20% fill, stacks <= 64", plan_c,
                          Am.data, B.data)]
    a, b = A.data, B.data
    ms = time_ms(lambda: tiled_matmul(a, b), 10)
    plain_ms = time_ms(lambda: tiled_matmul_ref(a, b), 10)
    library_ms = time_ms(lambda: torch.matmul(a, b), 10)
    err_abs["tiled_matmul"] = max(err_abs["tiled_matmul"], check_close(
        "tiled_matmul 3960^3 kernel vs plain", tiled_matmul(a, b),
        tiled_matmul_ref(a, b)))
    tiled_rows = [report("tiled_matmul", "3960^3 f32", ms, plain_ms,
                         library_ms, 2.0 * 3960 ** 3, 4 * 3 * 3960 ** 2, 1)]

    # (f)'s fused launch: all 16 products' stacks in one smm launch
    a_blocks = to_blocks_batched(a_stack, BS, BS).reshape(-1, BS, BS)
    b_blocks = to_blocks_batched(b_stack, BS, BS).reshape(-1, BS, BS)
    c = torch.zeros((G * nbb * nbb + 1, BS, BS), device=dev)
    t_f, r_f = plan_f.device_triples(dev)
    ms = time_ms(lambda: grouped_process_stack(a_blocks, b_blocks, c, t_f,
                                               r_f), 5, setup=c.zero_)
    out_k = c[:-1].clone()
    tile = plan_f.stack_tile

    def fused_plain():
        for s in range(0, t_f.shape[0], tile):
            smm_process_stack_ref(a_blocks, b_blocks, c, t_f[s:s + tile])

    plain_ms = time_ms(fused_plain, 3, setup=c.zero_)
    err_abs["smm"] = max(err_abs["smm"], check_close(
        f"smm fused {G} x {NB}^2 block {BS} kernel vs plain", out_k, c[:-1]))
    del out_k, c
    library_ms = time_ms(lambda: torch.bmm(a_stack, b_stack), 10)
    nbytes = (2 * G * nbb * nbb * BS * BS * 4            # A and B blocks
              + 2 * G * nbb * nbb * BS * BS * 4          # C read and written
              + int(t_f.shape[0]) * 16 + int(r_f.shape[0]) * 4)
    smm_rows.append(report(
        "smm", f"fused batch {G} x {NB}^2 block {BS} dense (one launch)", ms,
        plain_ms, library_ms, 2.0 * plan_f.n_entries * BS ** 3, nbytes, 1))
    print(f"  fused triples: {plan_f.n_stacks} x {plan_f.stack_tile} rows "
          f"({plan_f.n_stacks * plan_f.stack_tile * 16 / 1e6:.0f} MB), "
          f"padding {100 * plan_f.padding_frac:.1f} %, "
          f"{int(r_f.shape[0])} runs")

    ms = time_ms(lambda: grouped_gemm(a_stack, b_stack), 10)
    plain_ms = time_ms(lambda: grouped_gemm_ref(a_stack, b_stack), 10)
    err_abs["grouped_gemm"] = max(err_abs["grouped_gemm"], check_close(
        f"grouped_gemm {G} x {NB}^3 kernel vs plain",
        grouped_gemm(a_stack, b_stack),
        grouped_gemm_ref(a_stack, b_stack)))
    grouped_rows = [report("grouped_gemm", f"{G} x {NB}^3 f32", ms, plain_ms,
                           library_ms, 2.0 * G * NB ** 3,
                           4 * 3 * G * NB ** 2, 1)]

    # ---------------------------------------------------------- phase 4
    print("phase 4: MultiplyService -> dbcsr.multiply_batched, "
          f"{G} requests of {NB}^2, block {BS}, 1x1 mesh")
    exec_kw = dict(algorithm="cannon", pipeline_depth=1)

    def serve(label, reqs, want, n_buckets, filter_eps=None, **kw):
        """Submit, flush and collect ``reqs`` through a fused service;
        returns (first results, looped results)."""
        svc = MultiplyService(mesh, fused=True, max_batch=G, slo_s=60.0,
                              filter_eps=filter_eps, **exec_kw, **kw)

        def flush_all():
            torch.cuda.synchronize()
            t = time.perf_counter()
            tickets = [svc.submit(a, b) for a, b in reqs]
            svc.flush()
            out = [svc.result(tk) for tk in tickets]
            torch.cuda.synchronize()
            return out, time.perf_counter() - t

        zero_counters()
        out, first = flush_all()
        got = read_counters()
        if got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        if svc.stats()["n_dispatches"] != n_buckets:
            raise AssertionError(f"{label}: {svc.stats()['n_dispatches']} "
                                 f"dispatches, expected {n_buckets}")
        again, repeat = flush_all()
        for x, y in zip(out, again):
            if not torch.equal(x.data, y.data):
                raise AssertionError(f"{label}: a repeated flush differs")
        st = svc.stats()
        if (st["n_fused_requests"] != st["n_requests"]
                or st["n_retries"] or st["n_degradations"]
                or st["n_error_tickets"]):
            raise AssertionError(f"{label}: service stats {st}")
        looped_s = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            looped = dbcsr.multiply_batched(
                reqs, mesh=mesh, fused=False, filter_eps=filter_eps,
                **exec_kw, **kw)
            torch.cuda.synchronize()
            looped_s.append(time.perf_counter() - t)
        print(f"  {label}: fused flush first {first:.3f} s (plans built), "
              f"repeat {1e3 * repeat:.2f} ms; looped first "
              f"{looped_s[0]:.3f} s, repeat {1e3 * looped_s[1]:.2f} ms; "
              f"launches {got}")
        return out, looped

    def against_matmul(label, out, reqs):
        for i, (c, (a, b)) in enumerate(zip(out, reqs)):
            rel = rel_err(c.data, torch.matmul(a.data, b.data))
            if not rel <= REL_TOL:
                raise AssertionError(f"{label} request {i}: error {rel:.3e}")
        print(f"  {label}: {len(out)} products within {REL_TOL:g} of "
              "max|C| of torch.matmul")

    def bitwise(label, out, looped):
        for i, (x, y) in enumerate(zip(out, looped)):
            if not torch.equal(x.data, y.data):
                raise AssertionError(f"{label} request {i}: fused != looped")
            if (x.block_mask is None) != (y.block_mask is None) or (
                    x.block_mask is not None
                    and not np.array_equal(x.block_mask, y.block_mask)):
                raise AssertionError(f"{label} request {i}: masks differ")
        print(f"  {label}: fused == looped bitwise, masks equal")

    none = {"smm": 0, "tiled_matmul": 0, "grouped_gemm": 0}
    out, looped = serve("(f) 16 dense, blocked", dense_reqs,
                        dict(none, smm=1), 1, densify=False)
    against_matmul("(f)", out, dense_reqs)
    bitwise("(f)", out, looped)
    del out, looped

    # (g): 8 dense and 8 with A at ~20 % block fill, block scales over two
    # decades so the norm filter has work to do
    sparse_reqs = []
    for _ in range(G // 2):
        am = rng.rand(nbb, nbb) < 0.2
        scale = np.repeat(np.repeat(10.0 ** (-2 * rng.rand(nbb, nbb)), BS, 0),
                          BS, 1)
        a = dense(NB) * torch.tensor(scale, dtype=torch.float32, device=dev)
        sparse_reqs.append((dbcsr.create(a, mesh=mesh, block_size=BS,
                                         block_mask=am),
                            dbcsr.create(dense(NB), mesh=mesh, block_size=BS)))
    mixed = dense_reqs[:G // 2] + sparse_reqs
    for eps in (None, 0.0):
        out, looped = serve(f"(g) 8 dense + 8 at 20 % fill, eps {eps}", mixed,
                            dict(none, smm=2), 2, filter_eps=eps,
                            densify=False)
        against_matmul(f"(g) eps {eps}", out, mixed)
        bitwise(f"(g) eps {eps}", out, looped)
        del out, looped
    # eps in a wide gap between two norm products near the median of the
    # sparse requests' present triples (as phase 2 places it)
    prods = []
    for a, b in sparse_reqs:
        p = (a.norms()[:, :, None] * b.norms()[None]).astype(np.float64)
        prods.append(p[np.broadcast_to(a.block_mask[:, :, None], p.shape)])
    srt = np.sort(np.concatenate(prods))
    mid = srt.size // 2
    gaps = srt[mid - 1000:mid + 1000] / srt[mid - 1001:mid + 999]
    i = mid - 1001 + int(np.argmax(gaps))
    eps = float(np.sqrt(srt[i] * srt[i + 1]))
    out, looped = serve(f"(g) eps {eps:.4g}", mixed, dict(none, smm=2), 2,
                        filter_eps=eps, densify=False)
    for j, (x, y) in enumerate(zip(out, looped)):
        if not np.array_equal(x.block_mask, y.block_mask):
            raise AssertionError(f"(g) eps request {j}: mask != per-request")
        rel = rel_err(x.data, y.data)
        if not rel <= REL_TOL:
            raise AssertionError(f"(g) eps request {j}: error {rel:.3e}")
    # the filter must have dropped products: the sparse requests then
    # differ from the unfiltered product by far more than rounding
    moved = min(rel_err(x.data, torch.matmul(a.data, b.data))
                for x, (a, b) in zip(out[G // 2:], sparse_reqs))
    if not moved > 100 * REL_TOL:
        raise AssertionError(f"(g) eps dropped nothing (error {moved:.3e})")
    print(f"  (g) eps: masks equal the per-request multiply's, data within "
          f"{REL_TOL:g} of it (bitwise: "
          f"{all(torch.equal(x.data, y.data) for x, y in zip(out, looped))}); "
          f"{int((srt < eps).sum())} of {srt.size} sparse triples below eps, "
          f"sparse products moved by >= {moved:.3e} of max|C|")
    del out, looped

    out, _ = serve("(h) 16 dense, densified, grouped_gemm", dense_reqs,
                   dict(none, grouped_gemm=1), 1, densify=True,
                   local_kernel="pallas")
    against_matmul("(h)", out, dense_reqs)
    out, _ = serve("(i) 16 dense, densified, torch.bmm", dense_reqs, none, 1,
                   densify=True)
    against_matmul("(i)", out, dense_reqs)
    del out

    for key, n in launches.items():
        if n < 1:
            raise AssertionError(f"the main path never launched {key}")
    kernels = []
    for kname, src, replaces, rows in (
            ("smm", "src/repro_torch/csrc/smm.cu",
             "src/repro/kernels/smm/smm.py:42", smm_rows),
            ("tiled_matmul", "src/repro_torch/csrc/tiled_matmul.cu",
             "src/repro/kernels/tiled_matmul/tiled_matmul.py:26", tiled_rows),
            ("grouped_gemm", "src/repro_torch/csrc/grouped_gemm.cu",
             "src/repro/kernels/grouped_gemm/grouped_gemm.py:27",
             grouped_rows)):
        main = rows[0]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": err_abs[kname], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["shape"], "by_shape": rows})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
