"""Kernel checks that need an NVIDIA GPU: each CUDA kernel against its
plain PyTorch version on the card.  They skip where there is no card;
on the card run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-5 of max|C|, f32 sums of the same products in two orders;
decode_attention 2e-4 (rtol and atol, its JAX test's tolerance) in f32;
its bf16 output one bf16 step from the plain version's f32 output rounded
to bf16, plus 2**-16 of max|ref| for the f32 summation order (the rule of
chip_smoke.py's ``bf16_worst``).
"""
import dataclasses
import datetime

import numpy as np
import pytest
import torch

from repro_torch.core import dbcsr
from repro_torch.core.engine import build_executor_plan
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.grouped_gemm.ops import grouped_gemm
from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref
from repro_torch.kernels.smm.ops import smm_process_stack, stack_run_starts
from repro_torch.kernels.smm.ref import smm_process_stack_ref
from repro_torch.kernels.tiled_matmul.ops import tiled_matmul
from repro_torch.kernels.tiled_matmul.ref import tiled_matmul_ref
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve import MultiplyService

from torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(x, ref):
    return float((x - ref).abs().max() / ref.abs().max())


def _bf16_steps(out, ref):
    """max |out - bf16(ref)| in units of one bf16 step at the element plus
    2**-16 max|ref|; at most 1 for a right kernel."""
    rounded = ref.to(torch.bfloat16).float()
    big = torch.maximum(out.float().abs(), rounded.abs())
    step = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    tol = step + 2.0 ** -16 * float(ref.abs().max())
    return float(((out.float() - rounded).abs() / tol).max())


def edge_stack(rng, na, nb, nc):
    """(S, 4) int32 triples whose runs cover the smm kernel's edges: runs
    of 1 to 70 rows (longer than its 3-stage ring and its 32-row triple
    window), valid == 0 rows at a run's start, at its end, every third
    row and over a whole window, and a padding run on the scratch block
    ``nc``, which ``stack_run_starts`` leaves out.  A and B indices are
    random, so odd (for bf16: not 16-byte aligned) blocks occur."""
    lens = [1, 2, 3, 4, 5, 33, 70, 32, 31]
    cs = rng.permutation(nc)[:len(lens)]
    rows = []
    for r, (n, c) in enumerate(zip(lens, cs)):
        valid = np.ones(n, dtype=int)
        if r == 2:
            valid[0] = 0
        if r == 3:
            valid[-1] = 0
        if r == 5:
            valid[1::3] = 0
        if r == 6:
            valid[:36] = valid[-1] = 0
        rows.append(np.stack([rng.randint(0, na, n), rng.randint(0, nb, n),
                              np.full(n, c), valid], axis=1))
        if r == 4:
            rows.append(np.tile([0, 0, nc, 0], (3, 1)))
    return np.concatenate(rows).astype(np.int32)


# blocks on both sides of the kernel's regimes (a warp per run up to 32,
# a thread block per run above), its compile-time sizes (22, 64) and a
# rectangular block; stacks from an executor plan with a 50 % A mask, and
# edge_stack's runs with 4 and with 3 columns
@pytest.mark.parametrize("shape", [(4, 4, 4), (22, 22, 22), (23, 23, 23),
                                   (32, 32, 32), (33, 33, 33), (64, 64, 64),
                                   (100, 100, 100), (22, 64, 16)])
@pytest.mark.parametrize("stack", ["plan", "edges", "edges, 3 columns"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_smm_kernel_matches_plain(cuda, shape, stack, dtype):
    bm, bk, bn = shape
    rng = np.random.RandomState(bm + bk + bn)
    nb = 5
    a = torch.randn(nb * nb, bm, bk, device=cuda).to(dtype)
    b = torch.randn(nb * nb, bk, bn, device=cuda).to(dtype)
    c0 = torch.randn(nb * nb + 1, bm, bn, device=cuda)
    ck, cp = c0.clone(), c0.clone()
    if stack == "plan":
        mask = rng.rand(nb, nb) < 0.5
        plan = build_executor_plan(bm * nb, bk * nb, bn * nb, bm, bk, bn, 7,
                                   a_mask=mask)
        bins, launches = plan.device_bins(cuda), plan.n_launches
    else:
        t = edge_stack(rng, nb * nb, nb * nb, nb * nb)
        if stack == "edges, 3 columns":
            t = np.ascontiguousarray(t[t[:, 3] != 0, :3])
        bins = [(torch.tensor(t, device=cuda),
                 torch.tensor(stack_run_starts(t), device=cuda))]
        launches = 1
    before = smm_process_stack.launches
    for t, r in bins:
        smm_process_stack(a, b, ck, t, r)
        smm_process_stack_ref(a, b, cp, t)
    torch.cuda.synchronize()
    assert smm_process_stack.launches - before == launches
    assert _rel(ck[:-1], cp[:-1]) <= 1e-5


def test_smm_requires_run_starts_on_cuda(cuda):
    a = torch.zeros(1, 4, 4, device=cuda)
    t = torch.zeros(1, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="run_starts"):
        smm_process_stack(a, a, a.clone(), t)


def _operand(shape, dtype, device, offset=0):
    """A contiguous random tensor; at ``offset`` > 0 a view that starts
    ``offset`` elements into its storage (data_ptr() not 16-byte
    aligned: the kernel's one-element copies)."""
    n = int(np.prod(shape))
    flat = torch.randn(n + offset, device=device).to(dtype)
    return flat[offset:].view(shape)


# the GEMM body's edges: K below one 32-deep slice, K no multiple of it
# (a partial last slice), N % 4 != 0 (one-element copies of B), M = 1 and
# N = 1, tile multiples, and a misaligned storage offset
GEMM_EDGES = [((300, 200, 259), 0), ((1, 1, 1), 0), ((129, 3960, 257), 0),
              ((70, 7, 90), 0), ((130, 12, 136), 0), ((129, 40, 260), 0),
              ((64, 64, 130), 0), ((1, 300, 256), 0), ((257, 48, 1), 0),
              ((256, 64, 128), 0), ((300, 200, 256), 1)]


@pytest.mark.parametrize("shape,offset", GEMM_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_matmul_kernel_matches_plain(cuda, shape, offset, dtype):
    m, k, n = shape
    a = _operand((m, k), dtype, cuda, offset)
    b = _operand((k, n), dtype, cuda, offset)
    before = tiled_matmul.launches
    out = tiled_matmul(a, b)
    torch.cuda.synchronize()
    assert tiled_matmul.launches == before + 1
    assert _rel(out, tiled_matmul_ref(a, b)) <= 1e-5


@pytest.mark.parametrize("shape,offset", [
    ((3, 200, 333, 130), 0), ((1, 1, 1, 1), 0), ((2, 256, 512, 128), 0),
    ((3, 70, 7, 90), 0), ((2, 130, 40, 136), 0), ((2, 64, 64, 130), 0),
    ((2, 1, 300, 256), 0), ((2, 200, 256, 128), 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_gemm_kernel_matches_plain(cuda, shape, offset, dtype):
    e, c, d, f = shape
    t = _operand((e, c, d), dtype, cuda, offset)
    w = _operand((e, d, f), dtype, cuda, offset)
    before = grouped_gemm.launches
    out = grouped_gemm(t, w)
    torch.cuda.synchronize()
    assert grouped_gemm.launches == before + 1
    assert _rel(out, grouped_gemm_ref(t, w)) <= 1e-5


@pytest.mark.parametrize("shape", [(3, 200, 333, 130), (3, 256, 64, 128),
                                   (3, 130, 40, 136)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_grouped_gemm_is_bitwise_tiled_matmul(cuda, shape, dtype, offset):
    """One summation order: product e of a batch is bitwise the single
    product, whichever copy path each launch takes (``offset`` 1 gives
    tiled_matmul misaligned copies of the operands)."""
    e, c, d, f = shape
    t = _operand((e, c, d), dtype, cuda)
    w = _operand((e, d, f), dtype, cuda)
    out = grouped_gemm(t, w)
    for i in range(e):
        a = _operand((c, d), dtype, cuda, offset)
        b = _operand((d, f), dtype, cuda, offset)
        a.copy_(t[i])
        b.copy_(w[i])
        assert torch.equal(out[i], tiled_matmul(a, b))


@pytest.mark.parametrize("densify,kernel,counter", [
    (False, None, smm_process_stack), (True, "pallas", grouped_gemm)])
def test_fused_service_bucket_launches_once(cuda, densify, kernel, counter):
    mesh = make_mesh((1, 1), ("data", "model"))
    reqs = [(dbcsr.create(torch.randn(88, 66), mesh=mesh, block_size=22),
             dbcsr.create(torch.randn(66, 44), mesh=mesh, block_size=22))
            for _ in range(4)]
    svc = MultiplyService(mesh, fused=True, max_batch=4, algorithm="cannon",
                          densify=densify, local_kernel=kernel,
                          pipeline_depth=1)
    smm0, gg0, tm0 = (smm_process_stack.launches, grouped_gemm.launches,
                      tiled_matmul.launches)
    tickets = [svc.submit(a, b) for a, b in reqs]
    svc.flush()
    out = [svc.result(t) for t in tickets]
    torch.cuda.synchronize()
    launched = {smm_process_stack: smm_process_stack.launches - smm0,
                grouped_gemm: grouped_gemm.launches - gg0,
                tiled_matmul: tiled_matmul.launches - tm0}
    assert launched.pop(counter) == 1
    assert set(launched.values()) == {0}
    st = svc.stats()
    assert st["n_fused_requests"] == 4
    assert st["n_retries"] == st["n_degradations"] == st["n_error_tickets"] == 0
    for c, (a, b) in zip(out, reqs):
        assert _rel(c.data, torch.matmul(a.data, b.data)) <= 1e-5


def test_fused_densified_service_is_bitwise_looped(cuda):
    """(h) at a small size: the fused densified bucket (one grouped_gemm
    launch) equals the looped per-request multiplies (one tiled_matmul
    launch each) bit for bit."""
    mesh = make_mesh((1, 1), ("data", "model"))
    gen = torch.Generator().manual_seed(0)
    reqs = [(dbcsr.create(torch.randn(198, 132, generator=gen), mesh=mesh,
                          block_size=22),
             dbcsr.create(torch.randn(132, 110, generator=gen), mesh=mesh,
                          block_size=22)) for _ in range(5)]
    svc = MultiplyService(mesh, fused=True, max_batch=5, algorithm="cannon",
                          densify=True, local_kernel="pallas",
                          pipeline_depth=1)
    gg0, tm0 = grouped_gemm.launches, tiled_matmul.launches
    tickets = [svc.submit(a, b) for a, b in reqs]
    svc.flush()
    fused = [svc.result(t) for t in tickets]
    assert (grouped_gemm.launches - gg0, tiled_matmul.launches - tm0) == (1, 0)
    looped = dbcsr.multiply_batched(reqs, mesh=mesh, fused=False,
                                    algorithm="cannon", densify=True,
                                    local_kernel="pallas", pipeline_depth=1)
    assert tiled_matmul.launches - tm0 == len(reqs)
    torch.cuda.synchronize()
    for x, y, (a, b) in zip(fused, looped, reqs):
        assert torch.equal(x.data, y.data)
        assert _rel(x.data, torch.matmul(a.data, b.data)) <= 1e-5


@pytest.mark.parametrize("b,hkv,r,dh,s,cur", [
    (2, 2, 4, 64, 256, 200), (1, 1, 8, 128, 512, 512), (2, 4, 1, 64, 128, 7),
    (1, 2, 6, 32, 384, 100), (1, 2, 3, 32, 100, 0), (2, 8, 6, 128, 4100, 1),
    (1, 1, 2, 256, 70, 33), (1, 2, 3, 36, 90, 50),
    # Dh % 4 != 0: the kernel's scalar body, ragged S
    (1, 2, 3, 33, 130, 70), (2, 2, 6, 65, 200, 200), (1, 1, 4, 33, 70, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(cuda, b, hkv, r, dh, s, cur,
                                               dtype):
    g = torch.Generator(device=cuda).manual_seed(s + cur)
    q = torch.randn((b, 1, hkv * r, dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, s, hkv, dh), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, s, hkv, dh), generator=g, device=cuda).to(dtype)
    cur_len = torch.tensor([cur], dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    out = decode_attention(q, k, v, cur_len)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert out.dtype == dtype
    ref = decode_attention_ref(q.reshape(b, hkv, r, dh), k, v, cur_len)
    got = out.float().reshape(b, hkv, r, dh)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)
    else:
        assert _bf16_steps(got, ref) <= 1.0


def _decode_inputs(cuda, b, hkv, r, dh, s, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=cuda).to(dtype)
                 for shape in ((b, 1, hkv * r, dh), (b, s, hkv, dh),
                               (b, s, hkv, dh)))


def _pin_splits(monkeypatch, n):
    """Launch with n CTAs a cluster in place of the planner's count."""
    if n is None:
        return
    planned = decode_ops.device_plan
    monkeypatch.setattr(decode_ops, "device_plan", lambda *args: (
        dataclasses.replace(planned(*args), nsplit=n)))


def _check_decode(out, q, k, v, cur_len):
    b, _, h, dh = q.shape
    hkv = k.shape[2]
    ref = decode_attention_ref(q.reshape(b, hkv, h // hkv, dh), k, v, cur_len)
    got = out.float().reshape(ref.shape)
    if out.dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)
    else:
        assert _bf16_steps(got, ref) <= 1.0


# S = 1,024 over 8 CTAs of 4 warps: 127/128/129 and 512/513 sit at and
# beside the boundaries of the CTAs' tile ranges; 0, 1 and S; S = 1 and
# S = 3 leave most CTAs and warps without a row
@pytest.mark.parametrize("s,cur,splits", [
    (1024, 127, 8), (1024, 128, 8), (1024, 129, 8), (1024, 512, 8),
    (1024, 513, 8), (1024, 0, 8), (1024, 1, 8), (1024, 1024, 8),
    (1024, 1030, None), (1, 1, None), (1, 0, None), (3, 3, 8), (3, 2, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_split_edges(cuda, monkeypatch, s, cur, splits,
                                     dtype):
    q, k, v = _decode_inputs(cuda, 2, 2, 6, 128, s, dtype, seed=s + cur)
    cur_len = torch.tensor([cur], dtype=torch.int32, device=cuda)
    _pin_splits(monkeypatch, splits)
    out = decode_attention(q, k, v, cur_len)
    torch.cuda.synchronize()
    _check_decode(out, q, k, v, cur_len)


# the (R, Dh) pairs of the configs after head_pad_factor
@pytest.mark.parametrize("r", [1, 4, 6, 8, 12, 48])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_config_heads(cuda, r, dh, dtype):
    q, k, v = _decode_inputs(cuda, 2, 2, r, dh, 300, dtype, seed=r * dh)
    cur_len = torch.tensor([250], dtype=torch.int32, device=cuda)
    out = decode_attention(q, k, v, cur_len)
    torch.cuda.synchronize()
    _check_decode(out, q, k, v, cur_len)


def test_decode_attention_bf16_output_is_rounded_f32(cuda, monkeypatch):
    """With the same plan the f32 kernel on the bf16 values upcast sums in
    the same order, so the bf16 output is its result rounded to nearest
    even, bit for bit."""
    q, k, v = _decode_inputs(cuda, 2, 8, 6, 128, 1000, torch.bfloat16, seed=3)
    cur_len = torch.tensor([777], dtype=torch.int32, device=cuda)
    _pin_splits(monkeypatch, 8)
    out = decode_attention(q, k, v, cur_len)
    out32 = decode_attention(q.float(), k.float(), v.float(), cur_len)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out32.dtype == torch.float32
    assert torch.equal(out.view(torch.int16),
                       out32.to(torch.bfloat16).view(torch.int16))


def test_decode_attention_cuda_graph_replay(cuda):
    """One captured call, replayed after writing new lengths into the
    same device tensor: the kernel reads cur_len on the device."""
    q, k, v = _decode_inputs(cuda, 2, 8, 6, 128, 300, torch.bfloat16, seed=4)
    cur_len = torch.tensor([100], dtype=torch.int32, device=cuda)
    decode_attention(q, k, v, cur_len)           # build and set up first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention(q, k, v, cur_len)
    for cur in (1, 0, 57, 300, 299, 100):
        cur_len.fill_(cur)
        graph.replay()
        torch.cuda.synchronize()
        _check_decode(out, q, k, v, cur_len)


def test_decode_attention_counts_only_kernel_launches(cuda):
    q = torch.randn(1, 1, 4, 64)
    k = torch.randn(1, 32, 2, 64)
    cur = torch.tensor([5], dtype=torch.int32)
    before = decode_attention.launches
    decode_attention(q, k, k, cur)                       # the plain version
    assert decode_attention.launches == before
    decode_attention(q.to(cuda), k.to(cuda), k.to(cuda), cur.to(cuda))
    assert decode_attention.launches == before + 1
    with pytest.raises(ValueError, match="devices"):
        decode_attention(q.to(cuda), k.to(cuda), k.to(cuda), cur)


# the distributed schedules on simulated multi-rank meshes: (algorithm,
# extra kwargs, mesh shape, (m, k, n), steps a multiply runs)
SCHEDULES = [
    ("cannon", {}, (1, 1), (128, 96, 64), 1),
    ("cannon", {}, (2, 2), (128, 96, 64), 2),
    ("summa", {"bcast": "psum"}, (2, 2), (128, 96, 64), 2),
    ("summa", {"bcast": "gather"}, (2, 2), (128, 96, 64), 1),
    ("cannon25d", {"reduce": "all_reduce"}, (2, 2, 2), (128, 96, 64), 1),
    ("cannon25d", {"reduce": "reduce_scatter"}, (2, 2, 2), (128, 96, 64), 1),
    ("ts_k", {"reduce": "all_reduce"}, (2, 2, 2), (64, 256, 48), 1),
    ("ts_k", {"reduce": "reduce_scatter"}, (2, 2, 2), (64, 256, 48), 1),
    ("ts_m", {}, (2, 2), (256, 48, 64), 1),
    ("ts_n", {}, (2, 2), (48, 64, 256), 1),
]


@pytest.mark.parametrize("densify", [False, True])
@pytest.mark.parametrize(
    "algo,kw,shape,dims,steps", SCHEDULES,
    ids=["-".join([a, *map(str, kw.values()), "x".join(map(str, s))])
         for a, kw, s, _, _ in SCHEDULES])
def test_schedule_on_card_matches_matmul_and_counts_launches(
        cuda, algo, kw, shape, dims, steps, densify):
    """Every algorithm on a simulated 2x2 / 2x2x2 mesh on the card, dense
    operands: within 1e-5 of torch.matmul; the blocked path launches smm
    once per step and rank (one size bin), the densified ``pallas`` path
    one grouped_gemm a step (tiled_matmul on one rank)."""
    from repro_torch.core.blocking import GridSpec
    from repro_torch.core.multiply import distributed_matmul

    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    mesh = make_mesh(shape, axes)
    grid = GridSpec("data", "model", "pod" if len(shape) == 3 else None)
    gen = torch.Generator(device=cuda).manual_seed(1)
    m, k, n = dims
    a = torch.randn(m, k, generator=gen, device=cuda)
    b = torch.randn(k, n, generator=gen, device=cuda)
    before = (smm_process_stack.launches, grouped_gemm.launches,
              tiled_matmul.launches)
    c = distributed_matmul(a, b, mesh=mesh, grid=grid, algorithm=algo,
                           densify=densify, local_kernel="pallas" if densify
                           else None, block_m=16, block_k=16, block_n=16,
                           **kw)
    torch.cuda.synchronize()
    got = tuple(x.launches - y for x, y in zip(
        (smm_process_stack, grouped_gemm, tiled_matmul), before))
    ranks = int(np.prod(shape))
    if not densify:
        want = (steps * ranks, 0, 0)
    elif ranks == 1:
        want = (0, 0, steps)
    else:
        want = (0, steps, 0)
    assert got == want
    assert c.device == a.device and tuple(c.shape) == (m, n)
    assert _rel(c, torch.matmul(a, b)) <= 1e-5


@pytest.mark.parametrize("densify", [False, True])
def test_batched_summa_on_card_is_bitwise_looped(cuda, densify):
    """multiply_batched(algorithm="summa") on 2x2: the fused batch (per
    panel one smm launch a rank, or one grouped_gemm launch) equals the
    looped products bit for bit."""
    mesh = make_mesh((2, 2), ("data", "model"))
    gen = torch.Generator(device=cuda).manual_seed(2)
    reqs = [(dbcsr.create(torch.randn(88, 176, generator=gen, device=cuda),
                          mesh=mesh, block_size=22),
             dbcsr.create(torch.randn(176, 132, generator=gen, device=cuda),
                          mesh=mesh, block_size=22)) for _ in range(3)]
    kw = dict(mesh=mesh, algorithm="summa", densify=densify,
              local_kernel="pallas" if densify else None, pipeline_depth=1)
    before = smm_process_stack.launches, grouped_gemm.launches
    fused = dbcsr.multiply_batched(reqs, fused=True, **kw)
    torch.cuda.synchronize()
    got = (smm_process_stack.launches - before[0],
           grouped_gemm.launches - before[1])
    assert got == ((0, 2) if densify else (2 * 4, 0))
    looped = dbcsr.multiply_batched(reqs, fused=False, **kw)
    for x, y, (a, b) in zip(fused, looped, reqs):
        assert torch.equal(x.data, y.data)
        assert _rel(x.data, torch.matmul(a.data, b.data)) <= 1e-5


@pytest.mark.parametrize("m", [(1, 1), (2, 2)])
@pytest.mark.parametrize("batched", [False, True])
def test_precision_modes_on_card(cuda, batched, m):
    """``precision=`` on the card (core.precision): None and "highest"
    bitwise the IEEE product (TF32 off); "high" the TF32 GEMM and
    "default" the bf16 pass (bf16 operands, f32 out) taken outside the
    multiply, within 1e-6 of max|C| of it and more than 1e-5 from IEEE;
    the caller's settings unchanged after each call; ``pallas`` at
    "high" launches its kernel and gives its IEEE bits."""
    from repro_torch.core.multiply import distributed_matmul
    from repro_torch.core.multiply_batched import distributed_matmul_batched

    mesh = make_mesh(m, ("data", "model"))
    gen = torch.Generator(device=cuda).manual_seed(7)
    lead = (3,) if batched else ()
    a = torch.randn(*lead, 256, 384, generator=gen, device=cuda)
    b = torch.randn(*lead, 384, 512, generator=gen, device=cuda)
    fn = distributed_matmul_batched if batched else distributed_matmul
    flags = torch.backends.cuda.matmul
    state = (torch.get_float32_matmul_precision(), flags.allow_tf32,
             flags.allow_bf16_reduced_precision_reduction)

    def call(prec, **kw):
        out = fn(a, b, mesh=mesh, algorithm="cannon", densify=True,
                 precision=prec, **kw)
        assert (torch.get_float32_matmul_precision(), flags.allow_tf32,
                flags.allow_bf16_reduced_precision_reduction) == state
        return out

    ieee = torch.matmul(a, b)
    flags.allow_tf32 = True
    tf32 = torch.matmul(a, b)
    flags.allow_tf32 = False
    flags.allow_bf16_reduced_precision_reduction = False
    mm = torch.bmm if batched else torch.mm
    bf16 = mm(a.bfloat16(), b.bfloat16(), out_dtype=torch.float32)
    flags.allow_bf16_reduced_precision_reduction = state[2]
    none = call(None)
    assert _rel(none, ieee) <= 1e-5
    assert torch.equal(call("highest"), none)
    assert torch.equal(call("HIGHEST"), none)
    for prec, want in (("high", tf32), ("default", bf16)):
        got = call(prec)
        assert _rel(got, want) <= 1e-6
        assert _rel(got, ieee) > 1e-5
    kernel = grouped_gemm if batched or m != (1, 1) else tiled_matmul
    before = kernel.launches
    p_high = call("high", local_kernel="pallas")
    assert kernel.launches > before
    assert torch.equal(p_high, call(None, local_kernel="pallas"))


def test_rank_exact_step_is_one_launch_over_all_ranks(cuda):
    """A rank-exact step on the card: four ranks' own plans (one of them
    empty), their triples concatenated with rank offsets, in ONE smm
    launch, within 1e-5 of the plain version on the same concatenation;
    and a banded Cannon 2x2 multiply, rank-exact by default, bitwise its
    union plan with one smm launch a step where the union makes one a
    rank."""
    from repro_torch.core.blocking import GridSpec
    from repro_torch.core.engine import rank_stack_executor
    from repro_torch.core.multiply import distributed_matmul

    rng = np.random.RandomState(3)
    m, k, n, bs = 88, 110, 66, 22
    masks = [{"a_mask": rng.rand(m // bs, k // bs) < 0.5,
              "b_mask": rng.rand(k // bs, n // bs) < 0.6} for _ in range(4)]
    masks[2]["a_mask"][:] = False
    gen = torch.Generator(device=cuda).manual_seed(4)
    a = torch.randn(4, m, k, generator=gen, device=cuda)
    b = torch.randn(4, k, n, generator=gen, device=cuda)
    kw = dict(block_m=bs, block_k=bs, block_n=bs, rank_masks=masks,
              stack_size=7)
    f = rank_stack_executor(m, k, n, **kw)
    before = smm_process_stack.launches
    got = f(a, b)
    torch.cuda.synchronize()
    assert smm_process_stack.launches - before == 1
    want = rank_stack_executor(m, k, n, kernel="ref", **kw)(a, b)
    assert _rel(got, want) <= 1e-5
    assert torch.equal(got[2], torch.zeros_like(got[2]))

    mesh = make_mesh((2, 2), ("data", "model"))
    idx = np.arange(8)
    band = np.abs(idx[:, None] - idx[None, :]) <= 1
    full = torch.tensor(np.repeat(np.repeat(band, bs, 0), bs, 1),
                        dtype=torch.float32, device=cuda)
    x = torch.randn(176, 176, generator=gen, device=cuda) * full
    y = torch.randn(176, 176, generator=gen, device=cuda) * full
    call = dict(mesh=mesh, grid=GridSpec("data", "model"),
                algorithm="cannon", densify=False, block_m=bs, block_k=bs,
                block_n=bs, a_mask=band, b_mask=band)
    before = smm_process_stack.launches
    exact = distributed_matmul(x, y, **call)
    torch.cuda.synchronize()
    launched = smm_process_stack.launches - before
    union = distributed_matmul(x, y, rank_exact=False, **call)
    torch.cuda.synchronize()
    assert launched == 2
    assert smm_process_stack.launches - before - launched == 2 * 4
    assert torch.equal(exact, union)
    assert _rel(exact, torch.matmul(x, y)) <= 1e-5


@pytest.mark.parametrize("fill", [1.0, 0.2])
def test_auto_on_card_is_bitwise_its_pinned_plan(cuda, fill, tmp_path,
                                                 monkeypatch):
    """The default dbcsr.multiply on 2x2 (the planner's choice, with the
    H100 defaults: an empty working directory has no calibration file)
    equals its plan's pinned (algorithm, densify) bit for bit and
    launches the kernel of its local path; the default multiply_batched
    is bitwise its pinned fuse decision."""
    from repro_torch.planner import calibrate

    monkeypatch.chdir(tmp_path)
    calibrate.invalidate_cache()
    mesh = make_mesh((2, 2), ("data", "model"))
    gen = torch.Generator(device=cuda).manual_seed(3)
    rng = np.random.RandomState(3)
    mask = None if fill == 1.0 else rng.rand(8, 8) < fill
    a = dbcsr.create(torch.randn(176, 176, generator=gen, device=cuda),
                     mesh=mesh, block_size=22, block_mask=mask)
    b = dbcsr.create(torch.randn(176, 176, generator=gen, device=cuda),
                     mesh=mesh, block_size=22)
    before = smm_process_stack.launches, grouped_gemm.launches
    c, plan = dbcsr.multiply(a, b, mesh=mesh, local_kernel="pallas",
                             return_plan=True)
    torch.cuda.synchronize()
    smm_n = smm_process_stack.launches - before[0]
    gg_n = grouped_gemm.launches - before[1]
    assert (smm_n > 0) == (not plan.densify) and (gg_n > 0) == plan.densify
    pinned = dbcsr.multiply(a, b, mesh=mesh, local_kernel="pallas",
                            algorithm=plan.algorithm, densify=plan.densify)
    assert torch.equal(c.data, pinned.data)
    assert _rel(c.data, torch.matmul(a.data, b.data)) <= 1e-5
    out, report = dbcsr.multiply_batched([(a, b)] * 3, mesh=mesh,
                                         return_plan=True)
    (rep,) = report["buckets"]
    again = dbcsr.multiply_batched([(a, b)] * 3, mesh=mesh,
                                   fused=rep["plan"].fuse)
    assert all(torch.equal(x.data, y.data) for x, y in zip(out, again))
    calibrate.invalidate_cache()


@pytest.mark.parametrize("eps", [0.0, 0.25])
def test_retained_weights_on_card_equal_the_host_count(cuda, eps):
    """The per-rank weights the planner reads, counted on the card (as
    the multiply counts them) at a grid of 180 blocks a side, equal the
    CPU's count exactly."""
    from repro_torch.sparsity.balance import retained_block_weights

    rng = np.random.RandomState(5)
    am, bm = rng.rand(180, 180) < 0.2, rng.rand(180, 180) < 0.9
    an = rng.rand(180, 180).astype(np.float32)
    bn = rng.rand(180, 180).astype(np.float32)
    an[:3] = -1.0
    host = retained_block_weights(am, bm, an, bn, eps)
    np.testing.assert_array_equal(
        retained_block_weights(am, bm, an, bn, eps, device=cuda), host)


def test_traced_dispatch_carries_device_time(cuda):
    """A traced multiply on the card: its dispatch span carries
    ``device_s`` from CUDA events around the same run, no larger than the
    host interval (which ends at a synchronize), its step spans fill the
    interval, the smm kernel launched inside it, and telemetry off gives
    the same bits with no registry entry."""
    from repro_torch import obs
    from repro_torch.tensor import contract, create_tensor

    mesh = make_mesh((1, 1), ("data", "model"), device=cuda)
    rng = np.random.RandomState(9)
    a = dbcsr.create(rng.randn(352, 352).astype(np.float32), mesh=mesh,
                     block_size=22)
    b = dbcsr.create(rng.randn(352, 352).astype(np.float32), mesh=mesh,
                     block_size=22)
    kw = dict(mesh=mesh, algorithm="cannon", densify=False)
    obs.enable()
    obs.disable()
    obs.clear_metrics()
    off = dbcsr.multiply(a, b, **kw)
    assert len(obs.registry()) == 0
    smm_process_stack.launches = 0
    obs.enable()
    try:
        on = dbcsr.multiply(a, b, **kw)
        spans = obs.last_trace()
        t = create_tensor(rng.randn(16, 32, 64).astype(np.float32),
                          mesh=mesh, block_sizes=(8, 16, 16))
        contract("iaP,iaQ->PQ", t, t, mesh=mesh)
        cspans = obs.last_trace()
    finally:
        obs.disable()
        obs.clear_metrics()
        obs.clear_plan_outcomes()
    assert torch.equal(on.data, off.data)
    assert smm_process_stack.launches >= 1
    (disp,) = [s for s in spans if s.name == "dispatch"]
    assert 0.0 < disp.attrs["device_s"] <= disp.dur
    steps = [s for s in spans if s.parent_id == disp.span_id]
    assert sum(s.dur for s in steps) == pytest.approx(disp.dur, rel=0.05)
    assert any(s.name == "dispatch" and s.attrs["device_s"] > 0
               for s in cspans)


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "qwen3_moe_30b_a3b",
                                  "jamba_v0_1_52b", "rwkv6_1_6b"])
def test_layer_kinds_serve_on_the_card(cuda, arch):
    """Reduced MLA / MoE / Mamba / RWKV-6 models in f32 on the card:
    prefill then decode equals the teacher-forced forward (1e-4 of
    max|logits|; Jamba 3e-3, as in test_torch_serve_lm.py), and a decode
    step launches decode_attention once per attention layer, nothing for
    the other kinds."""
    from repro_torch.configs import base
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine
    from repro_torch.serve.prefill import prefill_step

    cfg = base.reduced_config(base.get_config(arch))
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = T.model_init(cfg, gen, device=cuda)
    seq = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen,
                        dtype=torch.int32, device=cuda)
    full = T.forward(params, seq, cfg)[0]
    tok, pcache, cur = prefill_step(params, seq[:, :20], cfg)
    state = {"cache": engine.pad_cache(pcache, cfg, 2, 32), "cur_len": cur}
    n_attn = sum(cfg.layer_kind(l)[0] == "attention"
                 for l in range(cfg.num_layers))
    rel = 3e-3 if arch.startswith("jamba") else 1e-4
    for i in range(20, 23):
        before = decode_attention.launches
        logits = T.forward(params, seq[:, i:i + 1], cfg,
                           cache=state["cache"], cur_len=state["cur_len"])[0]
        assert decode_attention.launches - before == n_attn
        assert _rel(logits[:, 0], full[:, i]) <= rel
        state["cur_len"] = state["cur_len"] + 1


def _process_mesh_on_card(rank, algorithm, densify):
    """A rank of a 2x2 process mesh on the card (gloo, host-staged when
    the ranks share it): the product and this process's launches."""
    from repro_torch.core.multiply import distributed_matmul
    from repro_torch.launch.mesh import make_process_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_process_mesh((2, 2), ("data", "model"),
                             timeout=datetime.timedelta(seconds=120))
    gen = torch.Generator(device=mesh.device).manual_seed(5)
    a = torch.randn(352, 352, generator=gen, device=mesh.device)
    b = torch.randn(352, 352, generator=gen, device=mesh.device)
    kw = dict(algorithm=algorithm, densify=densify, local_kernel="pallas",
              block_m=22, block_k=22, block_n=22)
    smm_process_stack.launches = tiled_matmul.launches = 0
    c = distributed_matmul(a, b, mesh=mesh, **kw)
    return (c.cpu(), mesh.transport,
            {"smm": smm_process_stack.launches,
             "tiled_matmul": tiled_matmul.launches})


@pytest.mark.parametrize("algorithm, densify", [("cannon", False),
                                                ("summa", True)])
def test_process_mesh_shares_the_card(cuda, tmp_path, algorithm, densify):
    """Four processes on the card's process mesh: bitwise the in-process
    mesh (the collectives only move data), each process launching its
    one rank's kernel."""
    from repro_torch.core.multiply import distributed_matmul
    from repro_torch.launch.processes import run_ranks

    ranks = run_ranks(_process_mesh_on_card, 4, store_dir=str(tmp_path),
                      args=(algorithm, densify), timeout_s=120,
                      join_timeout_s=300)
    mesh = make_mesh((2, 2), ("data", "model"), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn(352, 352, generator=gen, device=cuda)
    b = torch.randn(352, 352, generator=gen, device=cuda)
    want = distributed_matmul(
        a, b, mesh=mesh, algorithm=algorithm, densify=densify,
        local_kernel="pallas", block_m=22, block_k=22, block_n=22).cpu()
    kernel = "tiled_matmul" if densify else "smm"
    for c, transport, launches in ranks:
        assert torch.equal(c, want)
        assert launches[kernel] > 0
        assert transport in ("gloo, host-staged", "nccl")
