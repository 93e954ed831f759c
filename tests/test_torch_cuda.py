"""Kernel checks that need an NVIDIA GPU: each CUDA kernel against its
plain PyTorch version on the card.  They skip where there is no card;
on the card run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-5 of max|C|, f32 sums of the same products in two orders.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.engine import build_executor_plan
from repro_torch.kernels.smm.ops import smm_process_stack
from repro_torch.kernels.smm.ref import smm_process_stack_ref
from repro_torch.kernels.tiled_matmul.ops import tiled_matmul
from repro_torch.kernels.tiled_matmul.ref import tiled_matmul_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(x, ref):
    return float((x - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("bs", [4, 22, 64, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_smm_kernel_matches_plain(cuda, bs, dtype):
    rng = np.random.RandomState(bs)
    nb = 5
    mask = rng.rand(nb, nb) < 0.5
    plan = build_executor_plan(bs * nb, bs * nb, bs * nb, bs, bs, bs, 7,
                               a_mask=mask)
    a = torch.randn(nb * nb, bs, bs, device=cuda).to(dtype)
    b = torch.randn(nb * nb, bs, bs, device=cuda).to(dtype)
    c0 = torch.randn(nb * nb + 1, bs, bs, device=cuda)
    ck, cp = c0.clone(), c0.clone()
    before = smm_process_stack.launches
    for t, r in plan.device_bins(cuda):
        smm_process_stack(a, b, ck, t, r)
        smm_process_stack_ref(a, b, cp, t)
    torch.cuda.synchronize()
    assert smm_process_stack.launches - before == plan.n_launches
    assert _rel(ck[:-1], cp[:-1]) <= 1e-5


def test_smm_requires_run_starts_on_cuda(cuda):
    a = torch.zeros(1, 4, 4, device=cuda)
    t = torch.zeros(1, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="run_starts"):
        smm_process_stack(a, a, a.clone(), t)


@pytest.mark.parametrize("shape", [(300, 200, 259), (1, 1, 1), (129, 3960, 257)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_matmul_kernel_matches_plain(cuda, shape, dtype):
    m, k, n = shape
    a = torch.randn(m, k, device=cuda).to(dtype)
    b = torch.randn(k, n, device=cuda).to(dtype)
    before = tiled_matmul.launches
    out = tiled_matmul(a, b)
    torch.cuda.synchronize()
    assert tiled_matmul.launches == before + 1
    assert _rel(out, tiled_matmul_ref(a, b)) <= 1e-5
