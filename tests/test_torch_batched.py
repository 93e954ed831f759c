"""The product-batched multiply: the port's fused batched executor,
``distributed_matmul_batched`` and ``dbcsr.multiply_batched`` against
the JAX package's, on the CPU, plus the port's own bitwise contracts.

Contracts and tolerances:
  * fused triples byte-equal to the JAX package's (host numpy, same
    algorithm);
  * fused == per-group and fused == looped bitwise inside the port (each
    C block's run is summed in the same order either way);
  * port vs JAX products: 1e-5 relative, 1e-4 absolute (products of
    ~N(0, 1) entries summed over k <= 96 in f32, in different orders);
  * bucket keys and eps result masks equal (both packages get the same
    host norms)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dbcsr as jdbcsr
from repro.core import engine as jengine
from repro.core.multiply_batched import \
    distributed_matmul_batched as jax_matmul_batched
from repro.launch.mesh import make_mesh as jax_make_mesh

from repro_torch.core import dbcsr, engine
from repro_torch.core.cannon import cannon_matmul
from repro_torch.core.multiply import distributed_matmul
from repro_torch.core.multiply_batched import (BATCHED_ALGORITHMS,
                                               distributed_matmul_batched)
from repro_torch.kernels.smm.ops import stack_run_starts
from repro_torch.launch.mesh import make_mesh

from torch_threads import one_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def meshes():
    return (jax_make_mesh((1, 1), ("data", "model")),
            make_mesh((1, 1), ("data", "model"), device="cpu"))


def _rand_mask(rng, nbr, nbc, fill):
    if fill >= 1.0:
        return None
    mask = rng.rand(nbr, nbc) < fill
    mask[0, 0] = True            # keep at least one block
    return mask


def _group_masks(case, rng, nbr, nbk, nbc):
    if case == "dense":
        return [{}] * 3, None
    if case == "mixed":
        return [{}, {"a_mask": rng.rand(nbr, nbk) < 0.5},
                {"a_mask": rng.rand(nbr, nbk) < 0.05}], None
    groups = []
    for _ in range(3):
        groups.append({"a_mask": rng.rand(nbr, nbk) < 0.7,
                       "a_norms": rng.rand(nbr, nbk).astype(np.float32),
                       "b_norms": rng.rand(nbk, nbc).astype(np.float32)})
    return groups, 0.3


@pytest.mark.parametrize("bs,nb,stack", [(4, 6, 10), (22, 3, 5), (32, 4, 7)])
@pytest.mark.parametrize("case", ["dense", "mixed", "eps"])
def test_batched_plan_triples_byte_equal(bs, nb, stack, case):
    rng = np.random.RandomState(bs + nb)
    groups, eps = _group_masks(case, rng, nb, nb, nb)
    n = bs * nb
    t = engine.build_batched_executor_plan(n, n, n, bs, bs, bs, groups,
                                           stack_size=stack, filter_eps=eps)
    j = jengine.build_batched_executor_plan(n, n, n, bs, bs, bs, groups,
                                            stack_size=stack, filter_eps=eps)
    assert t.triples.dtype == j.triples.dtype
    assert t.triples.shape == j.triples.shape
    assert t.triples.tobytes() == j.triples.tobytes()
    ts, js = t.stats(), j.stats()
    for key in ("n_groups", "n_shared_plans", "n_entries", "n_stacks",
                "stack_tile", "n_padding", "padding_frac", "filter_eps",
                "per_group"):
        assert ts[key] == js[key], key
    assert t.scratch_index == j.scratch_index
    # the kernel's grid: every run with a valid row, never a padding run
    np.testing.assert_array_equal(t.run_starts,
                                  stack_run_starts(t.triples.reshape(-1, 4)))
    rows = t.triples.reshape(-1, 4)
    assert (rows[t.run_starts, 3] != 0).all() or not t.run_starts.size
    assert t.n_launches == (1 if t.run_starts.size else 0)


def test_batched_plan_is_memoized_with_its_upload():
    groups = [{}, {"a_mask": np.eye(3, dtype=bool)}, {}]
    p1 = engine.build_batched_executor_plan(66, 66, 66, 22, 22, 22, groups,
                                            stack_size=5)
    p2 = engine.build_batched_executor_plan(66, 66, 66, 22, 22, 22,
                                            [dict(g) for g in groups],
                                            stack_size=5)
    assert p1 is p2 and p1.n_shared_plans == 1
    cpu = torch.device("cpu")
    assert p1.device_triples(cpu) is p1.device_triples(cpu)
    t, r = p1.device_triples(cpu)
    assert tuple(t.shape) == (p1.n_stacks * p1.stack_tile, 4)
    np.testing.assert_array_equal(r.numpy(), p1.run_starts)
    other = engine.build_batched_executor_plan(66, 66, 66, 22, 22, 22,
                                               groups, stack_size=5,
                                               filter_eps=0.0)
    assert other is not p1


@pytest.mark.parametrize("kernel", ["smm", "ref"])
@pytest.mark.parametrize("fills", [(1.0, 1.0, 1.0), (1.0, 0.5, 0.05)])
def test_batched_executor_bitwise_equal_to_per_group(kernel, fills):
    rng = np.random.RandomState(0)
    m, k, n, bs = 128, 192, 64, 32
    g = len(fills)
    a = rng.randn(g, m, k).astype(np.float32)
    b = rng.randn(g, k, n).astype(np.float32)
    groups = []
    for gi, fill in enumerate(fills):
        am = _rand_mask(rng, m // bs, k // bs, fill)
        if am is not None:
            a[gi] *= np.repeat(np.repeat(am, bs, 0), bs, 1)
        groups.append({} if am is None else {"a_mask": am})
    fused = engine.batched_stack_executor(
        g, m, k, n, block_m=bs, block_k=bs, block_n=bs, kernel=kernel,
        group_masks=groups)
    got = fused(torch.tensor(a), torch.tensor(b))
    assert fused.batched_plan.n_launches == 1
    for gi in range(g):
        one = engine.stack_executor(m, k, n, block_m=bs, block_k=bs,
                                    block_n=bs, kernel=kernel, **groups[gi])
        want = one(torch.tensor(a[gi]), torch.tensor(b[gi]))
        assert torch.equal(got[gi], want), gi
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="built for"):
        fused(torch.tensor(a[:1]), torch.tensor(b[:1]))


def test_execute_batched_plan_matches_executor():
    rng = np.random.RandomState(5)
    g, nb, bs = 2, 3, 8
    groups = [{"a_mask": rng.rand(nb, nb) < 0.6}, {}]
    plan = engine.build_batched_executor_plan(nb * bs, nb * bs, nb * bs,
                                              bs, bs, bs, groups,
                                              stack_size=4)
    a = torch.tensor(rng.randn(g, nb * nb, bs, bs).astype(np.float32))
    b = torch.tensor(rng.randn(g, nb * nb, bs, bs).astype(np.float32))
    c0 = torch.zeros(g, nb * nb, bs, bs)
    got = engine.execute_batched_plan(plan, a, b, c0)
    assert tuple(got.shape) == (g, nb * nb, bs, bs)
    for gi in range(g):
        want = engine.execute_plan(
            engine.build_executor_plan(nb * bs, nb * bs, nb * bs, bs, bs,
                                       bs, 4, stack_bins=1, **groups[gi]),
            a[gi], b[gi], torch.zeros(nb * nb, bs, bs))
        assert torch.equal(got[gi], want)


def test_cannon_schedule_takes_a_leading_group_axis(meshes):
    _, mesh = meshes
    rng = np.random.RandomState(2)
    a = torch.tensor(rng.randn(3, 16, 24).astype(np.float32))
    b = torch.tensor(rng.randn(3, 24, 8).astype(np.float32))
    for depth in (0, 1, 2):
        c = cannon_matmul(a, b, mesh=mesh, local_matmul=torch.matmul,
                          pipeline_depth=depth)
        assert tuple(c.shape) == (3, 16, 8)
        for gi in range(3):
            assert torch.equal(c[gi], torch.matmul(a[gi], b[gi]))


def _stacked(rng, g, m, k, n, bs, fills):
    a = rng.randn(g, m, k).astype(np.float32)
    b = rng.randn(g, k, n).astype(np.float32)
    masks = [_rand_mask(rng, m // bs, k // bs, f) for f in fills]
    for gi, am in enumerate(masks):
        if am is not None:
            a[gi] *= np.repeat(np.repeat(am, bs, 0), bs, 1)
    return a, b, masks


PATHS = {"blocked": dict(densify=False),
         "densified": dict(densify=True),
         "densified_pallas": dict(densify=True, local_kernel="pallas")}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("eps", [None, 0.5])
def test_distributed_matmul_batched_matches_jax(meshes, path, eps):
    jmesh, mesh = meshes
    rng = np.random.RandomState(11)
    bs = 16
    a, b, masks = _stacked(rng, 3, 64, 48, 32, bs, (1.0, 0.5, 0.2))
    kw = dict(algorithm="cannon", block_m=bs, block_k=bs, block_n=bs,
              a_masks=masks, filter_eps=eps, pipeline_depth=1, **PATHS[path])
    jkw = dict(kw)
    if path == "blocked":
        jkw["local_kernel"] = "ref"  # the JAX smm kernel's plain version
    want = np.asarray(jax_matmul_batched(jnp.asarray(a), jnp.asarray(b),
                                         mesh=jmesh, **jkw))
    got = distributed_matmul_batched(torch.tensor(a), torch.tensor(b),
                                     mesh=mesh, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("eps", [None, 0.5])
def test_distributed_matmul_batched_summa_matches_jax(meshes, path, eps):
    """The batched SUMMA (psum broadcast) on the 1x1 mesh; multi-rank
    meshes: tests/test_torch_distributed.py."""
    jmesh, mesh = meshes
    rng = np.random.RandomState(12)
    bs = 16
    a, b, masks = _stacked(rng, 3, 64, 48, 32, bs, (1.0, 0.5, 0.2))
    kw = dict(algorithm="summa", block_m=bs, block_k=bs, block_n=bs,
              a_masks=masks, filter_eps=eps, pipeline_depth=1, **PATHS[path])
    jkw = dict(kw)
    if path == "blocked":
        jkw["local_kernel"] = "ref"  # the JAX smm kernel's plain version
    want = np.asarray(jax_matmul_batched(jnp.asarray(a), jnp.asarray(b),
                                         mesh=jmesh, **jkw))
    got = distributed_matmul_batched(torch.tensor(a), torch.tensor(b),
                                     mesh=mesh, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def _requests(meshes, geoms_fills, rng, bs=32, spread=False):
    """The same seeded operands as JAX and port DBCSR matrices; the port's
    matrices carry the JAX ones' host norms.  ``spread`` scales A's blocks
    over two decades, so a norm filter drops whole result blocks."""
    jmesh, mesh = meshes
    jreqs, reqs = [], []
    for (m, k, n), fill in geoms_fills:
        a = rng.randn(m, k).astype(np.float32)
        if spread:
            scale = 10.0 ** (-2 * rng.rand(m // bs, k // bs))
            a *= np.repeat(np.repeat(scale, bs, 0), bs, 1).astype(np.float32)
        b = rng.randn(k, n).astype(np.float32)
        am = _rand_mask(rng, m // bs, k // bs, fill)
        ja = jdbcsr.create(a, mesh=jmesh, block_size=bs, block_mask=am,
                           compute_norms=True)
        jb = jdbcsr.create(b, mesh=jmesh, block_size=bs, compute_norms=True)
        ta = dbcsr.create(a, mesh=mesh, block_size=bs, block_mask=am)
        tb = dbcsr.create(b, mesh=mesh, block_size=bs)
        ta.block_norms, tb.block_norms = ja.block_norms, jb.block_norms
        jreqs.append((ja, jb))
        reqs.append((ta, tb))
    return jreqs, reqs


# the JAX package's own geometry and fill mix (tests/test_batched.py)
GEOMS_FILLS = [
    ((128, 96, 64), 1.0), ((128, 96, 64), 1.0),   # same bucket
    ((128, 96, 64), 0.5), ((128, 96, 64), 0.05),  # other fill bins
    ((64, 64, 128), 1.0),                         # other geometry
]


@pytest.mark.parametrize("eps", [None, 0.0])
def test_multiply_batched_fused_equals_looped_and_jax(meshes, eps):
    jmesh, mesh = meshes
    jreqs, reqs = _requests(meshes, GEOMS_FILLS, np.random.RandomState(0))
    kw = dict(algorithm="cannon", densify=False, pipeline_depth=1,
              filter_eps=eps)
    fused, report = dbcsr.multiply_batched(reqs, mesh=mesh, fused=True,
                                           return_plan=True, **kw)
    looped = dbcsr.multiply_batched(reqs, mesh=mesh, fused=False, **kw)
    jfused = jdbcsr.multiply_batched(jreqs, mesh=jmesh, fused=True,
                                     local_kernel="ref", **kw)
    assert report["n_buckets"] == 4
    assert report["n_fused_requests"] == len(reqs)
    for rep in report["buckets"]:
        assert rep["fused"] and rep["plan"].n_requests == rep["n_requests"]
        assert rep["executor_stats"] is rep["plan"].executor_stats
        assert rep["executor_stats"]["n_fused_dispatches"] == 1
    plans = {id(rep["plan"]) for rep in report["buckets"]}
    for i, (c_f, c_l, c_j) in enumerate(zip(fused, looped, jfused)):
        assert torch.equal(c_f.data, c_l.data), i
        # the bucket's BatchedMultiplyPlan (the pinned algorithm's)
        assert id(c_f.last_plan) in plans
        assert c_f.last_plan.algorithm == "cannon"
        np.testing.assert_allclose(c_f.data.numpy(), np.asarray(c_j.data),
                                   rtol=RTOL, atol=ATOL)
        for c in (c_f, c_l):
            if c_j.block_mask is None:
                assert c.block_mask is None
            else:
                np.testing.assert_array_equal(c.block_mask, c_j.block_mask)


@pytest.mark.parametrize("path", ["blocked", "densified_pallas"])
def test_multiply_batched_eps_masks_match_jax(meshes, path):
    jmesh, mesh = meshes
    jreqs, reqs = _requests(meshes, [((128, 128, 128), 1.0)] * 2
                            + [((128, 128, 128), 0.5)] * 2,
                            np.random.RandomState(4), spread=True)
    # norm products of 32x32 blocks lie between ~10 and ~1000
    eps = 200.0
    kw = dict(algorithm="cannon", filter_eps=eps, pipeline_depth=1,
              **PATHS[path])
    got = dbcsr.multiply_batched(reqs, mesh=mesh, fused=True, **kw)
    jkw = dict(kw, local_kernel="ref") if path == "blocked" else kw
    want = jdbcsr.multiply_batched(jreqs, mesh=jmesh, fused=True, **jkw)
    single = [dbcsr.multiply(a, b, mesh=mesh, **kw) for a, b in reqs]
    unfiltered = dbcsr.multiply_batched(reqs, mesh=mesh, fused=True,
                                        **dict(kw, filter_eps=0.0))
    dropped = 0
    for c, cj, cs, c0 in zip(got, want, single, unfiltered):
        np.testing.assert_array_equal(c.block_mask, cj.block_mask)
        np.testing.assert_array_equal(c.block_mask, cs.block_mask)
        np.testing.assert_allclose(c.data.numpy(), np.asarray(cj.data),
                                   rtol=RTOL, atol=ATOL)
        dropped += int(c0.block_mask.sum() - c.block_mask.sum())
    assert dropped > 0  # eps really dropped whole result blocks


@pytest.mark.parametrize("eps", [None, 0.25])
def test_bucket_keys_match_jax(meshes, eps):
    jreqs, reqs = _requests(meshes, GEOMS_FILLS + [((128, 96, 64), 0.2)],
                            np.random.RandomState(6))
    keys = [dbcsr._bucket_key(a, b, eps) for a, b in reqs]
    jkeys = [jdbcsr._bucket_key(a, b, eps) for a, b in jreqs]
    assert keys == jkeys
    assert len(set(keys)) == 5


def test_shape_and_occupancy(meshes):
    _, reqs = _requests(meshes, [((64, 96, 32), 0.5)],
                        np.random.RandomState(8))
    a, b = reqs[0]
    assert tuple(a.shape) == (64, 96) and b.occupancy == 1.0
    assert a.occupancy == float(a.block_mask.mean())


def test_unported_pieces_raise_naming_their_queue_item(meshes):
    _, mesh = meshes
    _, reqs = _requests(meshes, [((64, 64, 64), 1.0)] * 2,
                        np.random.RandomState(9))
    a = torch.stack([x.data for x, _ in reqs])
    b = torch.stack([y.data for _, y in reqs])
    kw = dict(mesh=mesh, block_m=32, block_k=32, block_n=32)
    assert BATCHED_ALGORITHMS == ("cannon", "summa")
    # summa runs (it raised naming A3 before the schedules were ported):
    # the fused batch equals its looped products bit for bit
    c = distributed_matmul_batched(a, b, algorithm="summa", densify=False,
                                   pipeline_depth=1, **kw)
    for g in range(2):
        assert torch.equal(c[g], distributed_matmul(
            a[g], b[g], algorithm="summa", densify=False, pipeline_depth=1,
            **kw))
    # the planner's entry points (they raised naming A5 before it was
    # ported): auto is bitwise its plan's pinned configuration, and
    # return_plan gives the BatchedMultiplyPlan of what ran
    c, plan = distributed_matmul_batched(a, b, algorithm="auto",
                                         return_plan=True, **kw)
    assert plan.algorithm in BATCHED_ALGORITHMS and plan.n_requests == 2
    assert torch.equal(c, distributed_matmul_batched(
        a, b, algorithm=plan.algorithm, densify=plan.densify, **kw))
    c, plan = distributed_matmul_batched(a, b, algorithm="cannon",
                                         return_plan=True, **kw)
    assert (plan.algorithm, plan.densify) == ("cannon", True)
    assert "batched plan: 2 requests" in plan.explain()
    with pytest.raises(ValueError, match="gather"):
        distributed_matmul_batched(a, b, algorithm="summa", bcast="gather",
                                   **kw)
    with pytest.raises(ValueError, match="supports"):
        distributed_matmul_batched(a, b, algorithm="ts_k", **kw)
    # fused=None (the default) prices the bucket: fused or looped, the
    # product is bitwise the pinned choice's
    out, report = dbcsr.multiply_batched(reqs, mesh=mesh, algorithm="cannon",
                                         return_plan=True)
    (rep,) = report["buckets"]
    assert rep["plan"].fuse == rep["fused"]
    pinned = dbcsr.multiply_batched(reqs, mesh=mesh, algorithm="cannon",
                                    fused=rep["fused"])
    assert all(torch.equal(x.data, y.data) for x, y in zip(out, pinned))
    # verify= (A8) runs each request looped and verified, bitwise the
    # unverified loop; with fused=True it raises, as in the JAX package
    out, report = dbcsr.multiply_batched(reqs, mesh=mesh, algorithm="cannon",
                                         verify="checksum", return_plan=True)
    assert not any(b["fused"] for b in report["buckets"])
    looped = dbcsr.multiply_batched(reqs, mesh=mesh, algorithm="cannon",
                                    fused=False)
    for c, ref in zip(out, looped):
        assert torch.equal(c.data, ref.data)
        assert not c.verification["report"].detected
    with pytest.raises(ValueError, match="fused"):
        dbcsr.multiply_batched(reqs, mesh=mesh, algorithm="cannon",
                               fused=True, verify="checksum")
    with pytest.raises(ValueError, match="batch-capable"):
        dbcsr.multiply_batched(reqs, mesh=mesh, algorithm="ts_k", fused=True)
    # a bucket of one request goes looped without pricing
    out, report = dbcsr.multiply_batched(reqs[:1], mesh=mesh,
                                         algorithm="cannon", densify=False,
                                         return_plan=True)
    assert report["n_fused_requests"] == 0
    assert torch.equal(out[0].data, dbcsr.multiply(
        *reqs[0], mesh=mesh, algorithm="cannon", densify=False).data)
    assert dbcsr.multiply_batched([], mesh=mesh) == []
