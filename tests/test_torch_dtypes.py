"""Operand types the reference converts or widens, against the port, on
the CPU: a float64 host array is stored as float32 (JAX with its 64-bit
types off), and float16 operands are multiplied on every path (the
reference's kernels accumulate them in f32 and return float16).

The same seeded ``np.random.randn`` arrays go to both packages' ``create``
at 88^2, block 22 (a 4 x 4 block grid), through the densified path (the
vendor GEMM and the tiled_matmul kernel's plain version), the blocked
path and a fused ``multiply_batched`` bucket of two requests.
Tolerances: float32 results 1e-5 relative and 1e-4 absolute (both sides
sum in f32 in different orders); float16 results 1e-3 relative (one
float16 step, 2**-10, where two f32 sums round to neighbouring values)
and 1e-4 absolute.
"""
import numpy as np
import pytest

from repro.core import dbcsr as jdbcsr
from repro.launch.mesh import make_mesh as jax_make_mesh

from repro_torch.core import dbcsr
from repro_torch.launch.mesh import make_mesh

from torch_threads import one_thread  # noqa: F401

N, BS = 88, 22
TOLS = {"float32": dict(rtol=1e-5, atol=1e-4),
        "float16": dict(rtol=1e-3, atol=1e-4)}
PATHS = {"densified": dict(densify=True),
         "densified_pallas": dict(densify=True, local_kernel="pallas"),
         "blocked": dict(densify=False)}


@pytest.fixture(scope="module")
def meshes():
    return (jax_make_mesh((1, 1), ("data", "model")),
            make_mesh((1, 1), ("data", "model"), device="cpu"))


def _arrays(dtype, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(N, N).astype(dtype), rng.randn(N, N).astype(dtype)


def _check(tc, jc):
    want = np.asarray(jc.data)
    got = tc.data.numpy()
    assert str(got.dtype) == str(want.dtype)
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), **TOLS[str(want.dtype)])


@pytest.mark.parametrize("dtype", [np.float64, np.float16])
def test_create_stores_the_reference_dtype(meshes, dtype):
    jmesh, mesh = meshes
    a, _ = _arrays(dtype, seed=0)
    jm = jdbcsr.create(a, mesh=jmesh, block_size=BS)
    tm = dbcsr.create(a, mesh=mesh, block_size=BS)
    assert str(tm.data.numpy().dtype) == str(np.asarray(jm.data).dtype)
    np.testing.assert_array_equal(tm.data.numpy(), np.asarray(jm.data))


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("dtype", [np.float64, np.float16])
def test_multiply_matches_jax(meshes, path, dtype):
    jmesh, mesh = meshes
    a, b = _arrays(dtype, seed=1)
    jc = jdbcsr.multiply(jdbcsr.create(a, mesh=jmesh, block_size=BS),
                         jdbcsr.create(b, mesh=jmesh, block_size=BS),
                         mesh=jmesh, algorithm="cannon", **PATHS[path])
    tc = dbcsr.multiply(dbcsr.create(a, mesh=mesh, block_size=BS),
                        dbcsr.create(b, mesh=mesh, block_size=BS),
                        mesh=mesh, algorithm="cannon", **PATHS[path])
    _check(tc, jc)


@pytest.mark.parametrize("densify", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float16])
def test_fused_bucket_matches_jax(meshes, densify, dtype):
    jmesh, mesh = meshes
    pairs = [_arrays(dtype, seed=s) for s in (2, 3)]
    jout = jdbcsr.multiply_batched(
        [(jdbcsr.create(a, mesh=jmesh, block_size=BS),
          jdbcsr.create(b, mesh=jmesh, block_size=BS)) for a, b in pairs],
        mesh=jmesh, algorithm="cannon", fused=True, densify=densify)
    tout = dbcsr.multiply_batched(
        [(dbcsr.create(a, mesh=mesh, block_size=BS),
          dbcsr.create(b, mesh=mesh, block_size=BS)) for a, b in pairs],
        mesh=mesh, algorithm="cannon", fused=True, densify=densify)
    assert len(tout) == len(jout) == 2
    for tc, jc in zip(tout, jout):
        _check(tc, jc)
