"""The port's tiled_matmul wrapper against the JAX package's Pallas
tiled matmul (interpret mode) on the CPU, where the wrapper runs its
plain PyTorch version.

Tolerance: f32 dot products summed in different orders agree to 1e-5
relative; bf16 inputs are exact in f32, so the same bound holds."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.tiled_matmul.ops import tiled_matmul as jax_tiled
from repro.kernels.tiled_matmul.ref import tiled_matmul_ref as jax_tiled_ref

from repro_torch.kernels.tiled_matmul.ops import tiled_matmul

from torch_threads import one_thread  # noqa: F401

RTOL = ATOL = 1e-5


@pytest.mark.parametrize("m,k,n", [(40, 24, 56), (33, 70, 17)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax_tiled_matmul(m, k, n, dtype):
    rng = np.random.RandomState(m + n)
    a = torch.tensor(rng.randn(m, k).astype(np.float32)).to(getattr(torch, dtype))
    b = torch.tensor(rng.randn(k, n).astype(np.float32)).to(getattr(torch, dtype))
    ja = jnp.asarray(a.float().numpy()).astype(dtype)
    jb = jnp.asarray(b.float().numpy()).astype(dtype)
    # tiles that do not divide the shape: the JAX wrapper pads
    want = np.asarray(jax_tiled(ja, jb, bm=16, bn=16, bk=16))
    before = tiled_matmul.launches
    got = tiled_matmul(a, b)
    assert tiled_matmul.launches == before  # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_tiled_ref(ja, jb)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bad, exc", [
    (lambda a, b: (a.double(), b.double()), TypeError),
    (lambda a, b: (a, b.bfloat16()), TypeError),
    (lambda a, b: (a, b[:3]), ValueError),
    (lambda a, b: (a[None], b), ValueError),
    (lambda a, b: (a.t().contiguous().t(), b), ValueError),
    (lambda a, b: (a.to("meta"), b), ValueError),
    (lambda a, b: (a.to("meta"), b.to("meta")), ValueError),
])
def test_wrapper_rejects_bad_inputs_before_the_kernel(bad, exc):
    a, b = torch.zeros(5, 4), torch.zeros(4, 6)
    before = tiled_matmul.launches
    with pytest.raises(exc):
        tiled_matmul(*bad(a, b))
    assert tiled_matmul.launches == before


@pytest.mark.parametrize("caller", [True, False])
def test_densified_default_keeps_callers_tf32_setting(caller):
    from repro_torch.core.densify import densified_local_matmul

    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    flags.allow_tf32 = caller
    try:
        a = torch.randn(8, 5, generator=torch.Generator().manual_seed(0))
        out = densified_local_matmul()(a, a.T)
        assert flags.allow_tf32 is caller
        assert torch.equal(out, torch.matmul(a, a.T))
    finally:
        flags.allow_tf32 = before
