"""The port's smm wrapper against the JAX package's smm kernel (Pallas
in interpret mode) and its jnp oracle, on the CPU, where the wrapper
runs its plain PyTorch version.

Tolerance: both sides sum f32 block products in different orders, so
results agree to 1e-5 relative (a handful of ulps at these sizes)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.smm.ops import smm_process_stack as jax_smm
from repro.kernels.smm.ref import smm_process_stack_ref as jax_smm_ref

from repro_torch.kernels import _build
from repro_torch.kernels.smm.ops import smm_process_stack, stack_run_starts
from repro_torch.kernels.smm.ref import smm_process_stack_ref
from test_torch_cuda import edge_stack

from torch_threads import one_thread  # noqa: F401

RTOL = ATOL = 1e-5


def _stack(rng, na, nb, nc, run=3, invalid=0.0, pad=0):
    """c-run-contiguous (S, 4) triples: ``run`` rows per C block, some
    rows marked valid=0, plus ``pad`` padding rows on a scratch block."""
    c = np.repeat(rng.permutation(nc), run)
    s = c.size
    t = np.stack([rng.randint(0, na, s), rng.randint(0, nb, s), c,
                  (rng.rand(s) >= invalid).astype(int)], axis=1)
    if pad:
        t = np.concatenate([t, np.tile([0, 0, nc, 0], (pad, 1))])
    return t.astype(np.int32)


@pytest.mark.parametrize("bm,bk,bn", [(4, 4, 4), (22, 22, 22), (8, 16, 12)])
def test_plain_smm_matches_jax_kernel_and_oracle(bm, bk, bn):
    rng = np.random.RandomState(bm + bk)
    na, nb, nc = 6, 5, 4
    a = rng.randn(na, bm, bk).astype(np.float32)
    b = rng.randn(nb, bk, bn).astype(np.float32)
    c = rng.randn(nc + 1, bm, bn).astype(np.float32)
    t = _stack(rng, na, nb, nc, run=3, invalid=0.25, pad=4)
    want_kernel = np.asarray(jax_smm(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(c), jnp.asarray(t)))
    want_ref = np.asarray(jax_smm_ref(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(c), jnp.asarray(t)))
    got = smm_process_stack(torch.tensor(a), torch.tensor(b),
                            torch.tensor(c), torch.tensor(t))
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bm,bk,bn", [(4, 4, 4), (23, 23, 23), (33, 33, 33),
                                      (22, 64, 16)])
def test_plain_smm_edge_runs_match_jax_kernel(bm, bk, bn):
    """The card tests' edge stack (runs of 1-70 rows, valid == 0 rows at a
    run's start, end and over a whole 32-row window, a padding run) on
    the CPU: the port's wrapper against the JAX package's kernel, to 1e-5
    of max|C| (runs of up to 70 products of depth 64 sum to |C| ~ 60, where
    an elementwise 1e-5 is below the two summation orders' rounding)."""
    rng = np.random.RandomState(bm * bn)
    n = 9
    a = rng.randn(n, bm, bk).astype(np.float32)
    b = rng.randn(n, bk, bn).astype(np.float32)
    c = rng.randn(n + 1, bm, bn).astype(np.float32)
    t = edge_stack(rng, n, n, n)
    assert stack_run_starts(t).size == 9   # the padding run is left out
    want = np.asarray(jax_smm(jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(c), jnp.asarray(t)))
    got = smm_process_stack(torch.tensor(a), torch.tensor(b),
                            torch.tensor(c), torch.tensor(t))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_plain_smm_three_columns_and_bf16():
    rng = np.random.RandomState(1)
    a = rng.randn(5, 4, 6).astype(np.float32)
    b = rng.randn(5, 6, 4).astype(np.float32)
    c = np.zeros((3, 4, 4), np.float32)
    t = _stack(rng, 5, 5, 3, run=2)[:, :3]
    want = np.asarray(jax_smm_ref(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(c), jnp.asarray(t)))
    got = smm_process_stack(torch.tensor(a), torch.tensor(b),
                            torch.tensor(c), torch.tensor(t))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # bf16 inputs: products of bf16 values are exact in f32, so the
    # bf16-rounded operands give the f32 result on those values
    a16, b16 = torch.tensor(a).bfloat16(), torch.tensor(b).bfloat16()
    got16 = smm_process_stack(a16, b16, torch.zeros(3, 4, 4), torch.tensor(t))
    want16 = smm_process_stack_ref(a16.float(), b16.float(),
                                   torch.zeros(3, 4, 4), torch.tensor(t))
    torch.testing.assert_close(got16, want16, rtol=RTOL, atol=ATOL)


def test_cpu_wrapper_updates_in_place_and_counts_no_launch():
    rng = np.random.RandomState(2)
    a = torch.tensor(rng.randn(3, 4, 4).astype(np.float32))
    c = torch.zeros(3, 4, 4)
    t = torch.tensor(_stack(rng, 3, 3, 2, pad=1))
    before = smm_process_stack.launches
    out = smm_process_stack(a, a, c, t)
    assert out is c and float(c.abs().sum()) > 0
    assert smm_process_stack.launches == before


def test_stack_run_starts():
    t = np.array([[0, 0, 5, 1], [1, 1, 5, 1], [0, 0, 2, 0], [2, 2, 2, 1],
                  [0, 0, 9, 0], [0, 0, 9, 0], [1, 0, 7, 1]], np.int32)
    # the all-padding run on block 9 is dropped; a run starting with a
    # valid=0 row is kept (the kernel skips that row)
    np.testing.assert_array_equal(stack_run_starts(t), [0, 2, 6])
    np.testing.assert_array_equal(stack_run_starts(t[:, :3]), [0, 2, 4, 6])
    assert stack_run_starts(np.zeros((0, 4), np.int32)).size == 0
    with pytest.raises(ValueError, match="more than one run"):
        stack_run_starts(np.array([[0, 0, 1], [0, 0, 2], [0, 0, 1]], np.int32))
    with pytest.raises(ValueError):
        stack_run_starts(np.zeros((3, 2), np.int32))


def _good():
    a = torch.zeros(2, 4, 3)
    b = torch.zeros(2, 3, 5)
    c = torch.zeros(2, 4, 5)
    t = torch.zeros(1, 4, dtype=torch.int32)
    return a, b, c, t


@pytest.mark.parametrize("bad, exc", [
    (lambda a, b, c, t: (a.double(), b, c, t), TypeError),
    (lambda a, b, c, t: (a, b.bfloat16(), c, t), TypeError),
    (lambda a, b, c, t: (a, b, c.bfloat16(), t), TypeError),
    (lambda a, b, c, t: (a, b, c, t.long()), TypeError),
    (lambda a, b, c, t: (a, b, c, torch.zeros(1, 5, dtype=torch.int32)),
     ValueError),
    (lambda a, b, c, t: (a, torch.zeros(2, 4, 5), c, t), ValueError),
    (lambda a, b, c, t: (a, b, torch.zeros(2, 5, 4), t), ValueError),
    (lambda a, b, c, t: (a.transpose(1, 2).contiguous().transpose(1, 2),
                         b, c, t), ValueError),
    (lambda a, b, c, t: (a.to("meta"), b, c, t), ValueError),
    (lambda a, b, c, t: tuple(x.to("meta") for x in (a, b, c, t)),
     ValueError),
])
def test_wrapper_rejects_bad_inputs_before_the_kernel(bad, exc):
    args = bad(*_good())
    before = smm_process_stack.launches
    with pytest.raises(exc):
        smm_process_stack(*args)
    assert smm_process_stack.launches == before


def test_bad_run_starts_rejected():
    a, b, c, t = _good()
    with pytest.raises(TypeError):
        smm_process_stack(a, b, c, t, torch.zeros(1, dtype=torch.int64))


def test_launch_error_code_raises():
    _build.check(0, "launch")  # success is silent
    with pytest.raises(RuntimeError, match="CUDA error 9 .invalid"):
        _build.check(9, "launch", lambda code: "invalid configuration")
