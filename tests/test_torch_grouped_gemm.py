"""The port's grouped GEMM and batched block transforms against the JAX
package's, on the CPU: the port's wrapper runs its plain version for CPU
tensors, the JAX wrapper its Pallas kernel in interpret mode.

Tolerance: 1e-5 of max|C| (plus 1e-5 absolute); both sides sum the same
f32 products (bf16 inputs are exact in f32) in different orders.  The
block transforms are pure permutations and must agree exactly."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.densify import (
    from_blocks_batched as jax_from_blocks_batched,
    grouped_densified_local_matmul as jax_grouped_local_matmul,
    to_blocks_batched as jax_to_blocks_batched)
from repro.kernels.grouped_gemm.ops import grouped_gemm as jax_grouped_gemm

from repro_torch.core.densify import (from_blocks_batched,
                                     grouped_densified_local_matmul,
                                     to_blocks_batched)
from repro_torch.kernels.grouped_gemm.ops import (grouped_gemm,
                                                  grouped_process_stack)
from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref
from repro_torch.kernels.smm.ref import smm_process_stack_ref

from torch_threads import one_thread  # noqa: F401

REL = 1e-5
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _assert_close(got: np.ndarray, want: np.ndarray):
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale + 1e-5)


def _operands(seed, e, c, d, f):
    rng = np.random.RandomState(seed)
    return (rng.randn(e, c, d).astype(np.float32),
            rng.randn(e, d, f).astype(np.float32))


@pytest.mark.parametrize("shape", [(3, 200, 333, 130),   # ragged C, d, f
                                   (2, 128, 512, 256),   # tile multiples
                                   (1, 70, 40, 90)])     # one group
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_grouped_gemm_matches_jax(shape, dtype):
    e, c, d, f = shape
    t_np, w_np = _operands(sum(shape), e, c, d, f)
    tdt, jdt = DTYPES[dtype]
    t, w = torch.tensor(t_np).to(tdt), torch.tensor(w_np).to(tdt)
    before = grouped_gemm.launches
    out = grouped_gemm(t, w)
    assert grouped_gemm.launches == before  # CPU: plain version, no launch
    assert out.dtype == torch.float32 and tuple(out.shape) == (e, c, f)
    ref = np.asarray(jax_grouped_gemm(jnp.asarray(t_np, jdt),
                                      jnp.asarray(w_np, jdt)))
    _assert_close(out.numpy(), ref)


def test_grouped_gemm_checks_its_operands():
    t = torch.zeros(2, 4, 3)
    with pytest.raises(ValueError, match="shapes"):
        grouped_gemm(t, torch.zeros(2, 4, 5))
    with pytest.raises(ValueError, match="shapes"):
        grouped_gemm(t, torch.zeros(3, 3, 5))
    with pytest.raises(TypeError):
        grouped_gemm(t, torch.zeros(2, 3, 5, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        grouped_gemm(t.double(), torch.zeros(2, 3, 5, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        grouped_gemm(t, torch.zeros(2, 5, 3).transpose(1, 2))


def test_grouped_gemm_ref_keeps_the_callers_tf32_flag():
    flags = torch.backends.cuda.matmul
    caller = flags.allow_tf32
    try:
        flags.allow_tf32 = True
        grouped_gemm_ref(torch.ones(1, 2, 2), torch.ones(1, 2, 2))
        assert flags.allow_tf32 is True
    finally:
        flags.allow_tf32 = caller


@pytest.mark.parametrize("shape,bm,bn", [((3, 88, 66), 22, 22),
                                         ((2, 64, 128), 32, 64),
                                         ((1, 8, 8), 8, 8)])
def test_batched_block_transforms_match_jax(shape, bm, bn):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    got = to_blocks_batched(torch.tensor(x), bm, bn)
    want = np.asarray(jax_to_blocks_batched(jnp.asarray(x), bm, bn))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    nbr, nbc = shape[1] // bm, shape[2] // bn
    back = from_blocks_batched(got, nbr, nbc)
    jback = np.asarray(jax_from_blocks_batched(jnp.asarray(want), nbr, nbc))
    np.testing.assert_array_equal(back.numpy(), jback)
    np.testing.assert_array_equal(back.numpy(), x)
    with pytest.raises(ValueError):
        to_blocks_batched(torch.tensor(x), bm + 1, bn)


@pytest.mark.parametrize("kernel", [None, "pallas"])
def test_grouped_densified_local_matmul_matches_jax(kernel):
    t_np, w_np = _operands(7, 4, 48, 40, 56)
    got = grouped_densified_local_matmul(kernel=kernel)(
        torch.tensor(t_np), torch.tensor(w_np))
    want = np.asarray(jax_grouped_local_matmul(kernel=kernel)(
        jnp.asarray(t_np), jnp.asarray(w_np)))
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("kernel", ["smm", "ref"])
def test_grouped_process_stack_is_one_smm_call(kernel):
    rng = np.random.RandomState(3)
    a = torch.tensor(rng.randn(6, 4, 5).astype(np.float32))
    b = torch.tensor(rng.randn(6, 5, 3).astype(np.float32))
    c0 = torch.tensor(rng.randn(5, 4, 3).astype(np.float32))
    # (S=2, T=3, 4): two stacks, the last row of each a padding row that
    # points at the scratch block 4
    triples = torch.tensor([[[0, 1, 0, 1], [2, 3, 0, 1], [0, 0, 4, 0]],
                            [[5, 5, 3, 1], [1, 2, 2, 1], [0, 0, 4, 0]]],
                           dtype=torch.int32)
    got = grouped_process_stack(a, b, c0.clone(), triples, kernel=kernel)
    want = smm_process_stack_ref(a, b, c0.clone(), triples.reshape(-1, 4))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unknown"):
        grouped_process_stack(a, b, c0.clone(), triples, kernel="pallas")
