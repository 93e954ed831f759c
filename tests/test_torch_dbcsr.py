"""The slice as a whole: ``dbcsr.create`` -> ``dbcsr.multiply`` with
Cannon on a 1x1 mesh, the JAX package against the port, on the CPU.

Both packages get the same seeded numpy operands, masks and host norms
(norms reduced in f32 by two frameworks may differ in the last ulp and
flip a product that sits at eps).  Tolerance: 1e-5 relative, 1e-4
absolute on products of ~N(0, 1) entries summed over k <= 88; both sides
sum in f32 in different orders."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.core import dbcsr as jdbcsr
from repro.launch.mesh import make_mesh as jax_make_mesh

from repro_torch.core import dbcsr
from repro_torch.launch.mesh import make_mesh

from torch_threads import one_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-4
N, BS = 88, 22  # 4 x 4 block grid


@pytest.fixture(scope="module")
def meshes():
    return (jax_make_mesh((1, 1), ("data", "model")),
            make_mesh((1, 1), ("data", "model"), device="cpu"))


def _state(m):
    """A JAX DBCSRMatrix as the numpy dict ``from_state`` takes."""
    return {"data": np.asarray(m.data), "rows": m.layout.rows,
            "cols": m.layout.cols, "block_rows": m.layout.block_rows,
            "block_cols": m.layout.block_cols, "row_axis": m.grid.row_axis,
            "col_axis": m.grid.col_axis, "block_mask": m.block_mask,
            "block_norms": m.block_norms}


def _operands(meshes, fill, seed=0):
    jmesh, mesh = meshes
    rng = np.random.RandomState(seed)
    nb = N // BS
    a = rng.randn(N, N).astype(np.float32)
    b = rng.randn(N, N).astype(np.float32)
    am = None if fill == 1.0 else rng.rand(nb, nb) < fill
    bm = None if fill == 1.0 else rng.rand(nb, nb) < fill
    if am is not None:
        am[0, 0] = bm[0, 0] = True  # keep the product non-empty
    ja = jdbcsr.create(a, mesh=jmesh, block_size=BS, block_mask=am)
    jb = jdbcsr.create(b, mesh=jmesh, block_size=BS, block_mask=bm)
    ja.norms()
    jb.norms()
    ta = dbcsr.from_state(_state(ja), mesh=mesh)
    tb = dbcsr.from_state(_state(jb), mesh=mesh)
    return ja, jb, ta, tb


PATHS = {"blocked": dict(densify=False),
         "densified": dict(densify=True),
         "densified_pallas": dict(densify=True, local_kernel="pallas")}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("fill", [1.0, 0.5, 0.05])
def test_multiply_matches_jax(meshes, path, fill):
    jmesh, mesh = meshes
    ja, jb, ta, tb = _operands(meshes, fill)
    jc = jdbcsr.multiply(ja, jb, mesh=jmesh, algorithm="cannon",
                         **PATHS[path])
    tc = dbcsr.multiply(ta, tb, mesh=mesh, algorithm="cannon", **PATHS[path])
    np.testing.assert_allclose(tc.data.numpy(), np.asarray(jc.data),
                               rtol=RTOL, atol=ATOL)
    if jc.block_mask is None:
        assert tc.block_mask is None
    else:
        np.testing.assert_array_equal(tc.block_mask, jc.block_mask)
    assert dataclasses.astuple(tc.layout) == dataclasses.astuple(jc.layout)
    assert tc.data.device.type == "cpu"


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("eps", [0.0, 300.0, 1e9])
def test_filter_eps_matches_jax(meshes, path, eps):
    jmesh, mesh = meshes
    ja, jb, ta, tb = _operands(meshes, 0.5, seed=3)
    jc = jdbcsr.multiply(ja, jb, mesh=jmesh, algorithm="cannon",
                         filter_eps=eps, **PATHS[path])
    tc = dbcsr.multiply(ta, tb, mesh=mesh, algorithm="cannon",
                        filter_eps=eps, **PATHS[path])
    np.testing.assert_array_equal(tc.block_mask, jc.block_mask)
    np.testing.assert_allclose(tc.data.numpy(), np.asarray(jc.data),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fill", [1.0, 0.5])
def test_filter_eps_zero_is_bitwise_unfiltered(meshes, fill):
    _, mesh = meshes
    _, _, ta, tb = _operands(meshes, fill, seed=4)
    c_none = dbcsr.multiply(ta, tb, mesh=mesh, algorithm="cannon",
                            densify=False)
    c_zero = dbcsr.multiply(ta, tb, mesh=mesh, algorithm="cannon",
                            densify=False, filter_eps=0.0)
    assert torch.equal(c_none.data, c_zero.data)
    if fill < 1.0:
        np.testing.assert_array_equal(c_none.block_mask, c_zero.block_mask)


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_pipeline_depths_bitwise(meshes, depth):
    _, mesh = meshes
    _, _, ta, tb = _operands(meshes, 0.5, seed=5)
    base = dbcsr.multiply(ta, tb, mesh=mesh, algorithm="cannon",
                          densify=False, pipeline_depth=1)
    c = dbcsr.multiply(ta, tb, mesh=mesh, algorithm="cannon", densify=False,
                       pipeline_depth=depth)
    assert torch.equal(base.data, c.data)


def test_from_state_round_trip(meshes):
    ja, _, ta, _ = _operands(meshes, 0.5, seed=6)
    assert ta.data.numpy().tobytes() == np.asarray(ja.data).tobytes()
    np.testing.assert_array_equal(ta.block_mask, ja.block_mask)
    assert ta.block_norms.tobytes() == ja.block_norms.tobytes()
    assert (ta.layout.rows, ta.layout.block_rows) == (N, BS)
    assert (ta.grid.row_axis, ta.grid.col_axis) == ("data", "model")
    # the port's own norms agree with the reference's to f32 rounding
    np.testing.assert_allclose(ta.norms(recompute=True), ja.block_norms,
                               rtol=1e-6)
    bad = _state(ja)
    bad["block_mask"] = np.ones((2, 2), bool)
    with pytest.raises(ValueError):
        dbcsr.from_state(bad, mesh=meshes[1])


def test_matrix_api_matches_jax(meshes):
    ja, jb, ta, tb = _operands(meshes, 0.5, seed=7)
    np.testing.assert_allclose(float(dbcsr.trace(ta)),
                               float(jdbcsr.trace(ja)), rtol=1e-5)
    jt, tt = jdbcsr.transpose(ja), dbcsr.transpose(ta)
    np.testing.assert_array_equal(tt.data.numpy(), np.asarray(jt.data))
    np.testing.assert_array_equal(tt.block_mask, jt.block_mask)
    js, ts = ja.scale(-2.0), ta.scale(-2.0)
    np.testing.assert_array_equal(ts.data.numpy(), np.asarray(js.data))
    np.testing.assert_array_equal(ts.block_norms, js.block_norms)
    jf, tf = ja.filter(20.0), ta.filter(20.0)
    np.testing.assert_array_equal(tf.block_mask, jf.block_mask)
    np.testing.assert_array_equal(tf.data.numpy(), np.asarray(jf.data))
    jsum, tsum = jdbcsr.add(ja, jb), dbcsr.add(ta, tb)
    np.testing.assert_array_equal(tsum.block_mask, jsum.block_mask)
    np.testing.assert_array_equal(tsum.data.numpy(), np.asarray(jsum.data))
    assert tsum.block_norms is None
    x = np.random.RandomState(0).randn(N).astype(np.float32)
    np.testing.assert_allclose(
        dbcsr.multiply_vector(ta, torch.tensor(x)).numpy(),
        np.asarray(jdbcsr.multiply_vector(ja, jax.numpy.asarray(x))),
        rtol=RTOL, atol=ATOL)


def test_create_matches_jax(meshes):
    jmesh, mesh = meshes
    rng = np.random.RandomState(8)
    a = rng.randn(N, N).astype(np.float32)
    mask = rng.rand(4, 4) < 0.5
    jm = jdbcsr.create(a, mesh=jmesh, block_size=BS, block_mask=mask,
                       compute_norms=True)
    tm = dbcsr.create(a, mesh=mesh, block_size=BS, block_mask=mask,
                      compute_norms=True)
    np.testing.assert_array_equal(tm.data.numpy(), np.asarray(jm.data))
    np.testing.assert_allclose(tm.block_norms, jm.block_norms, rtol=1e-6)
    np.testing.assert_array_equal(tm.block_mask, jm.block_mask)
    with pytest.raises(ValueError):
        dbcsr.create(a, mesh=mesh, block_size=BS, block_mask=mask[:2])


@pytest.mark.parametrize("kw, queue, grid", [
    pytest.param(dict(algorithm="auto"), "A5", (1, 1), id="kw0-A5"),
    pytest.param(dict(algorithm="cannon", return_plan=True), "A5", (1, 1),
                 id="kw2-A5"),
    pytest.param(dict(algorithm="cannon", verify="checksum"), "A8", (1, 1),
                 id="kw3-A8"),
])
def test_later_slices_raise(meshes, kw, queue, grid):
    """Each entry point a later slice ported; each raised naming its
    queue item until then.  The A5 cases run through the planner and
    must agree with the JAX package's multiply, bitwise with the port's
    own pinned plan, and carry the plan as ``last_plan``.  The A8 case
    (``verify="checksum"``) must agree with the JAX package's verified
    multiply (product, report, residual tolerances to 1e-6 relative:
    both are float64 host sums of the same f32 norms), be bitwise the
    port's unverified product, and carry ``verification``."""
    ja, jb, ta, tb = _operands(meshes, 0.5)
    mesh = make_mesh(grid, ("data", "model"), device="cpu")
    if queue == "A8":
        c = dbcsr.multiply(ta, tb, mesh=mesh, **kw)
        want = jdbcsr.multiply(ja, jb, mesh=meshes[0], **kw)
        np.testing.assert_allclose(c.data.numpy(), np.asarray(want.data),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(c.block_mask, want.block_mask)
        rep, wrep = c.verification["report"], want.verification["report"]
        assert c.verification["enabled"] and want.verification["enabled"]
        assert not rep.detected and not wrep.detected
        np.testing.assert_allclose(rep.row_tol, wrep.row_tol, rtol=1e-6)
        np.testing.assert_allclose(rep.col_tol, wrep.col_tol, rtol=1e-6)
        plain = dbcsr.multiply(ta, tb, mesh=mesh, algorithm="cannon")
        assert plain.verification is None
        assert torch.equal(c.data, plain.data)
        return
    got = dbcsr.multiply(ta, tb, mesh=mesh, **kw)
    c, plan = got if kw.get("return_plan") else (got, got.last_plan)
    assert c.last_plan is plan and plan.candidates
    assert "candidate" in plan.explain()
    want = jdbcsr.multiply(ja, jb, mesh=meshes[0], **kw)
    want = want[0] if kw.get("return_plan") else want
    np.testing.assert_allclose(c.data.numpy(), np.asarray(want.data),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(c.block_mask, want.block_mask)
    pinned = dbcsr.multiply(ta, tb, mesh=mesh, algorithm=plan.algorithm,
                            densify=plan.densify)
    assert torch.equal(c.data, pinned.data)


@pytest.mark.parametrize("bcast", ["psum", "gather"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_multiply_summa_matches_jax(meshes, path, bcast):
    """SUMMA on the 1x1 mesh: the reference's PDGEMM baseline, both
    broadcasts (multi-rank meshes: tests/test_torch_distributed.py)."""
    jmesh, mesh = meshes
    ja, jb, ta, tb = _operands(meshes, 0.5, seed=10)
    jc = jdbcsr.multiply(ja, jb, mesh=jmesh, algorithm="summa", bcast=bcast,
                         **PATHS[path])
    tc = dbcsr.multiply(ta, tb, mesh=mesh, algorithm="summa", bcast=bcast,
                        **PATHS[path])
    np.testing.assert_allclose(tc.data.numpy(), np.asarray(jc.data),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tc.block_mask, jc.block_mask)


@pytest.mark.parametrize("kw", [dict(rank_exact=True),
                                dict(rebalance=True)])
def test_rank_exact_and_rebalance_on_one_rank_match_jax(meshes, kw):
    """On a one-rank mesh the reference runs the ordinary multiply (its
    rank-exact path needs more than one rank); so does the port."""
    jmesh, mesh = meshes
    ja, jb, ta, tb = _operands(meshes, 0.5, seed=9)
    jc = jdbcsr.multiply(ja, jb, mesh=jmesh, algorithm="cannon",
                         densify=False, **kw)
    tc = dbcsr.multiply(ta, tb, mesh=mesh, algorithm="cannon", densify=False,
                        **kw)
    np.testing.assert_array_equal(tc.block_mask, jc.block_mask)
    np.testing.assert_allclose(tc.data.numpy(), np.asarray(jc.data),
                               rtol=RTOL, atol=ATOL)
    plain = dbcsr.multiply(ta, tb, mesh=mesh, algorithm="cannon",
                           densify=False)
    assert torch.equal(tc.data, plain.data)
