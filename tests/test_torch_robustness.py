"""The port's robustness subsystem (repro_torch.robustness: ABFT
checksums, fault injection, guards, the service ladder) against the JAX
package's, on the CPU: every test of tests/test_robustness.py mirrored
on the port (same names, same parametrizations), plus parity with the
reference and the port's own contracts under ``verify=``.

Tolerances: checksum residuals against the reference's to 1e-5
relative + 1e-4 absolute (a clean residual is the roundoff of two f32
checksum sums of magnitude <= ~256 in different orders, a few ulp of
1.5e-5 each; a corrupted one is the corruption, equal to 1e-5); detection
tolerances to 1e-6 relative (float64 host arithmetic on block norms
that the two frameworks reduce in f32 in different orders, a few ulp
apart).
Flagged rows, columns and blocks must be equal.  Within the port,
repair, ``verify=None`` and the rank-exact / rebalance / pipeline-depth
contracts are bitwise.  ``decide_verify`` equals the reference's on
multi-rank meshes; on 1x1 it equals the reference's formula without
the communication and latency terms (a named departure of the port).
The reference's 2x2 chaos battery (a 900 s subprocess) is mirrored
in-process on a simulated 2x2 mesh.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.planner import cost_model as jcm
from repro.planner import plan as jplan
from repro.robustness import abft as jabft
from repro.robustness import chaos as jchaos

from repro_torch.core import dbcsr
from repro_torch.launch.mesh import make_mesh
from repro_torch.planner.cost_model import HardwareModel
from repro_torch.planner.plan import decide_verify, plan_multiply
from repro_torch.robustness import abft, chaos, guards
from repro_torch.sparsity.norms import compute_block_norms

from torch_threads import one_thread  # noqa: F401

EXEC_KW = dict(densify=False, local_kernel="ref", pipeline_depth=1)
HW_REF = HardwareModel.from_dict(jcm.DEFAULT_HARDWARE.to_dict())


@pytest.fixture
def rng():
    """A fresh seeded generator a test: this module leaves the session
    generator of tests/conftest.py, which other modules' draws share, as
    it found it."""
    return np.random.RandomState(0)


def _mesh11():
    return make_mesh((1, 1), ("data", "model"), device="cpu")


def _operand(rng, m, n, *, block=32, fill=1.0, mesh=None):
    data = rng.randn(m, n).astype(np.float32)
    mask = None
    if fill < 1.0:
        mask = rng.rand(m // block, n // block) < fill
        mask[0, 0] = True
    return dbcsr.create(data, mesh=mesh, block_size=block, block_mask=mask)


def _same_report(got, want):
    """A port VerificationReport against the reference's."""
    assert got.detected == want.detected
    assert got.flagged_rows == want.flagged_rows
    assert got.flagged_cols == want.flagged_cols
    assert got.flagged_blocks == want.flagged_blocks
    np.testing.assert_allclose(got.row_tol, want.row_tol, rtol=1e-6)
    np.testing.assert_allclose(got.col_tol, want.col_tol, rtol=1e-6)
    np.testing.assert_allclose(got.row_residual, want.row_residual,
                               rtol=1e-5, atol=1e-4, equal_nan=True)
    np.testing.assert_allclose(got.col_residual, want.col_residual,
                               rtol=1e-5, atol=1e-4, equal_nan=True)


def _bits(x):
    return np.asarray(x).view(np.uint32)


# ---------------------------------------------------------------------------
# abft: checksum residuals, tolerances, detection, repair
# ---------------------------------------------------------------------------

def test_checksum_residuals_clean_below_tolerance(rng):
    a = rng.randn(96, 64).astype(np.float32)
    b = rng.randn(64, 96).astype(np.float32)
    c = a @ b
    kw = dict(block_m=32, block_k=32, block_n=32)
    rep = abft.verify_product(torch.from_numpy(a), torch.from_numpy(b),
                              torch.from_numpy(c), **kw)
    assert not rep.detected
    assert rep.flagged_blocks == ()
    # residuals are small but tolerances must dominate them
    assert (rep.row_residual <= rep.row_tol).all()
    assert (rep.col_residual <= rep.col_tol).all()
    _same_report(rep, jabft.verify_product(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), **kw))


@pytest.mark.parametrize("mode", chaos.FAULT_MODES)
def test_verify_product_detects_and_localizes(rng, mode):
    a = rng.randn(96, 64).astype(np.float32)
    b = rng.randn(64, 128).astype(np.float32)
    c = a @ b
    inj = chaos.FaultInjector(seed=3)
    bad = inj.corrupt_block(torch.from_numpy(c), 2, 1, block_m=32,
                            block_n=32, mode=mode)
    kw = dict(block_m=32, block_k=32, block_n=32)
    rep = abft.verify_product(torch.from_numpy(a), torch.from_numpy(b),
                              bad, **kw)
    assert rep.detected
    assert rep.flagged_blocks == ((2, 1),)
    # the same seed corrupts the same bits as the reference's injector
    jbad = jchaos.FaultInjector(seed=3).corrupt_block(
        jnp.asarray(c), 2, 1, block_m=32, block_n=32, mode=mode)
    assert (_bits(bad.numpy()) == _bits(jbad)).all()
    _same_report(rep, jabft.verify_product(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(jbad), **kw))


def test_verify_product_detects_nan_corruption(rng):
    # NaN residuals must trip detection, never sneak under a tolerance
    a = rng.randn(64, 64).astype(np.float32)
    b = rng.randn(64, 64).astype(np.float32)
    c = (a @ b).copy()
    c[5, 40] = np.nan
    rep = abft.verify_product(torch.from_numpy(a), torch.from_numpy(b),
                              torch.from_numpy(c),
                              block_m=32, block_k=32, block_n=32)
    assert rep.detected
    assert (0, 1) in rep.flagged_blocks


def test_splice_blocks_repairs_exactly(rng):
    c = torch.from_numpy(rng.randn(96, 96).astype(np.float32))
    fresh = torch.from_numpy(rng.randn(96, 96).astype(np.float32))
    out = abft.splice_blocks(c, fresh, [(1, 2)], 32, 32)
    ref = c.clone()
    ref[32:64, 64:96] = fresh[32:64, 64:96]
    assert torch.equal(out, ref)
    assert abft.splice_blocks(c, fresh, [], 32, 32) is c


def test_verify_and_repair_raises_on_persistent_corruption(rng):
    a = torch.from_numpy(rng.randn(64, 64).astype(np.float32))
    b = torch.from_numpy(rng.randn(64, 64).astype(np.float32))
    bad = chaos.corrupt_block(a @ b, 0, 0, block_m=32, block_n=32,
                              mode="nan", rng=np.random.RandomState(0))

    with pytest.raises(guards.CorruptionDetectedError) as ei:
        abft.verify_and_repair(a, b, bad, recompute=lambda: bad,
                               block_m=32, block_k=32, block_n=32)
    assert ei.value.report.detected
    assert ei.value.report.repair_attempted and not ei.value.report.repaired


@pytest.mark.parametrize("eps", [None, 0.0, 1e-3, 0.5, 30.0])
@pytest.mark.parametrize("shape", [(4, 3, 5), (2, 6, 2)])
def test_dropped_mass_and_tolerances_are_byte_equal(shape, eps):
    rng = np.random.RandomState(sum(shape))
    an = (rng.rand(*shape[:2]) * 8).astype(np.float32)
    bn = (rng.rand(*shape[1:]) * 8).astype(np.float32)
    got = abft._dropped_mass(an, bn, eps)
    want = jabft._dropped_mass(an, bn, eps)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for kw in (dict(filter_eps=eps), dict(filter_eps=eps, rtol=1e-3,
                                          atol=0.5)):
        for g, w in zip(abft.verification_tolerances(an, bn, **kw),
                        jabft.verification_tolerances(an, bn, **kw)):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert (abft.DEFAULT_RTOL, abft._EXACT_DROP_LIMIT) == (
        jabft.DEFAULT_RTOL, jabft._EXACT_DROP_LIMIT)


def test_dropped_mass_falls_back_above_the_exact_limit(monkeypatch):
    an = np.full((3, 4), 2.0, np.float32)
    bn = np.full((4, 5), 2.0, np.float32)
    monkeypatch.setattr(abft, "_EXACT_DROP_LIMIT", 10)
    monkeypatch.setattr(jabft, "_EXACT_DROP_LIMIT", 10)
    got = abft._dropped_mass(an, bn, 0.25)
    assert got.tobytes() == jabft._dropped_mass(an, bn, 0.25).tobytes()
    assert (got == 4 * 0.25).all()


def test_checksums_ignore_the_callers_tf32_setting(rng):
    """The checksum products run in IEEE f32 whatever the caller set;
    the caller's setting is restored."""
    a = torch.from_numpy(rng.randn(64, 64).astype(np.float32))
    b = torch.from_numpy(rng.randn(64, 64).astype(np.float32))
    c = a @ b
    want = abft.checksum_residuals(a, b, c, 32, 32)
    caller = torch.get_float32_matmul_precision()
    try:
        for precision in ("high", "medium"):
            torch.set_float32_matmul_precision(precision)
            got = abft.checksum_residuals(a, b, c, 32, 32)
            assert torch.get_float32_matmul_precision() == precision
            for g, w in zip(got, want):
                assert g.tobytes() == w.tobytes()
    finally:
        torch.set_float32_matmul_precision(caller)


@pytest.mark.parametrize("dtype, itype, bit", [
    (torch.float32, np.uint32, 1 << 30), (torch.float64, np.uint64, 1 << 62),
    (torch.float16, np.uint16, 1 << 14), (torch.bfloat16, np.uint16, 1 << 14),
])
def test_flip_exponent_bit_every_float_type(dtype, itype, bit):
    x = torch.tensor([0.25, 1.5, -3.0, 1e-3], dtype=dtype)
    y = chaos._flip_exponent_bit(x)
    assert y.dtype == dtype
    xi = x.view({torch.float32: torch.int32, torch.float64: torch.int64}.get(
        dtype, torch.int16))
    yi = y.view(xi.dtype)
    assert ((xi ^ yi) == bit).all()
    assert torch.equal(chaos._flip_exponent_bit(y).view(xi.dtype), xi)
    if dtype in (torch.float32, torch.float64):
        want = jchaos._flip_exponent_bit(x.numpy())
        assert y.numpy().view(itype).tobytes() == want.view(itype).tobytes()
    with pytest.raises(ValueError):
        chaos._flip_exponent_bit(torch.arange(3))


# ---------------------------------------------------------------------------
# multiply-level: verify= end-to-end on a 1x1 mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["cannon", "summa"])
@pytest.mark.parametrize("fill", [1.0, 0.05])
def test_multiply_verify_detect_localize_repair(rng, algorithm, fill):
    mesh = _mesh11()
    a = _operand(rng, 128, 128, fill=fill, mesh=mesh)
    b = _operand(rng, 128, 128, fill=fill, mesh=mesh)
    kw = dict(mesh=mesh, algorithm=algorithm, **EXEC_KW)

    clean = dbcsr.multiply(a, b, **kw)
    # verify=None must be bit-identical to the pre-existing behaviour
    # and attach no verification payload
    assert clean.verification is None

    # clean verified run: no false positive, bit-identical result
    cv = dbcsr.multiply(a, b, verify="checksum", **kw)
    assert cv.verification["enabled"]
    assert not cv.verification["report"].detected
    assert torch.equal(cv.data, clean.data)

    # corrupt the max-norm block of the result; detect, localize
    # exactly, repair to the bitwise-clean product
    norms = compute_block_norms(clean.data, 32, 32)
    i0, j0 = np.unravel_index(int(np.argmax(norms)), norms.shape)
    inj = chaos.FaultInjector(seed=7)
    hook = inj.one_shot_result_hook(int(i0), int(j0), block_m=32,
                                    block_n=32, mode="bitflip")
    with chaos.result_corruption(hook):
        cr = dbcsr.multiply(a, b, verify="checksum", **kw)
    rep = cr.verification["report"]
    assert rep.detected
    assert rep.flagged_blocks == ((int(i0), int(j0)),)
    assert rep.repaired and rep.n_recomputed_blocks >= 1
    assert torch.equal(cr.data, clean.data)


def test_multiply_verify_no_false_positive_with_eps_filter(rng):
    # eps-filtered triples shift the result away from the unfiltered
    # product; the dropped-mass term in the tolerance must absorb that
    mesh = _mesh11()
    a = _operand(rng, 128, 128, fill=0.3, mesh=mesh)
    b = _operand(rng, 128, 128, fill=0.3, mesh=mesh)
    for eps in (1e-3, 1e-1, 5.0):
        c = dbcsr.multiply(a, b, mesh=mesh, filter_eps=eps,
                           verify="checksum", **EXEC_KW)
        if c.verification["enabled"]:
            assert not c.verification["report"].detected, f"eps={eps}"


def test_purification_iterated_multiplies_no_false_positive():
    # iterated multiplies (density-matrix purification) accumulate
    # float error; the norm-aware tolerance must not flag clean runs
    from repro_torch.sparsity import banded_hamiltonian, initial_density
    from repro_torch.sparsity.workloads import mcweeny_purify

    mesh = _mesh11()
    H, mask = banded_hamiltonian(128, 32, seed=0)
    P0 = initial_density(H, mu=0.0)
    P = dbcsr.create(P0.astype(np.float32), mesh=mesh, block_size=32,
                     block_mask=mask)
    _, trace = mcweeny_purify(
        P, mesh=mesh, n_iter=4, filter_eps=1e-5,
        multiply_kw=dict(verify="checksum", **EXEC_KW))
    assert len(trace) == 4  # no CorruptionDetectedError raised


def test_purification_2x2_rank_exact_no_false_positive():
    """The same on a simulated 2x2 mesh, rank-exact and union: each
    verified iterate is bitwise the unverified one."""
    from repro_torch.sparsity import banded_hamiltonian, initial_density
    from repro_torch.sparsity.workloads import mcweeny_purify

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    H, mask = banded_hamiltonian(256, 16, seed=0)
    P = dbcsr.create(initial_density(H).astype(np.float32), mesh=mesh,
                     block_size=16, block_mask=mask)
    for extra in ({}, dict(rank_exact=False)):
        kw = dict(algorithm="cannon", densify=False, local_kernel="ref",
                  **extra)
        Pv, tv = mcweeny_purify(P, mesh=mesh, n_iter=4, filter_eps=1e-6,
                                multiply_kw=dict(verify="checksum", **kw))
        Pp, tp = mcweeny_purify(P, mesh=mesh, n_iter=4, filter_eps=1e-6,
                                multiply_kw=kw)
        assert torch.equal(Pv.data, Pp.data)
        assert tv == tp


def test_multiply_verify_invalid_mode(rng):
    mesh = _mesh11()
    a = _operand(rng, 64, 64, mesh=mesh)
    with pytest.raises(ValueError, match="verify"):
        dbcsr.multiply(a, a, mesh=mesh, verify="paranoid", **EXEC_KW)


def test_batched_verify_forces_looped_and_rejects_pinned_fused(rng):
    mesh = _mesh11()
    pairs = [(_operand(rng, 64, 64, mesh=mesh),
              _operand(rng, 64, 64, mesh=mesh)) for _ in range(3)]
    results, report = dbcsr.multiply_batched(
        pairs, mesh=mesh, verify="checksum", return_plan=True, **EXEC_KW)
    assert all(not b["fused"] for b in report["buckets"])
    for (a, b), c in zip(pairs, results):
        ref = dbcsr.multiply(a, b, mesh=mesh, **EXEC_KW)
        assert torch.equal(c.data, ref.data)
        assert not c.verification["report"].detected
    with pytest.raises(ValueError, match="fused"):
        dbcsr.multiply_batched(pairs, mesh=mesh, verify="checksum",
                               fused=True, **EXEC_KW)


# ---------------------------------------------------------------------------
# the port's contracts under verify= on a simulated 2x2 mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sparse_2x2():
    rng = np.random.RandomState(11)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    a = _operand(rng, 128, 128, block=16, fill=0.4, mesh=mesh)
    b = _operand(rng, 128, 128, block=16, fill=0.4, mesh=mesh)
    return mesh, a, b


@pytest.mark.parametrize("algorithm", ["cannon", "summa"])
@pytest.mark.parametrize("variant", [
    dict(), dict(rank_exact=False), dict(rebalance=True),
    dict(pipeline_depth=2), dict(filter_eps=0.0), dict(filter_eps=5.0),
])
def test_verify_keeps_the_contracts_on_2x2(sparse_2x2, algorithm, variant):
    """verify="checksum" on a masked 2x2 multiply: no false positive,
    bitwise the unverified product; an injected bitflip in the max-norm
    block is detected, localized and repaired to the bitwise-clean
    product through the same dispatch (rank-exact plans, the rebalance
    permutation and its inverse)."""
    mesh, a, b = sparse_2x2
    kw = dict(mesh=mesh, algorithm=algorithm, densify=False,
              local_kernel="ref", pipeline_depth=1)
    kw.update(variant)
    clean = dbcsr.multiply(a, b, **kw)
    cv, plan = dbcsr.multiply(a, b, verify="checksum", return_plan=True,
                              **kw)
    assert not plan.verification["report"].detected
    assert torch.equal(cv.data, clean.data)
    if variant.get("rebalance"):
        assert plan.executor_stats["rebalance_applied"]
    # the installed hook never fires without verify=
    norms = compute_block_norms(clean.data, 16, 16)
    i0, j0 = (int(x) for x in np.unravel_index(int(np.argmax(norms)),
                                                 norms.shape))
    hook = chaos.FaultInjector(seed=1).one_shot_result_hook(
        i0, j0, block_m=16, block_n=16, mode="scale")
    with chaos.result_corruption(hook):
        assert torch.equal(dbcsr.multiply(a, b, **kw).data, clean.data)
        assert not hook.fired
        cr = dbcsr.multiply(a, b, verify="checksum", **kw)
    rep = cr.verification["report"]
    assert rep.detected and rep.repaired
    assert rep.flagged_blocks == ((i0, j0),)
    assert torch.equal(cr.data, clean.data)


def test_verify_persistent_corruption_raises_through_multiply(
        sparse_2x2, monkeypatch):
    """A fault in every dispatch (first and repair) is persistent: the
    one-shot repair cannot clear it."""
    from repro_torch.core import multiply as mult

    mesh, a, b = sparse_2x2
    real = mult.cannon_matmul

    def corrupted(*args, **kw):
        return chaos.corrupt_block(real(*args, **kw), 0, 0, block_m=16,
                                   block_n=16, mode="nan")

    monkeypatch.setattr(mult, "cannon_matmul", corrupted)
    with pytest.raises(guards.CorruptionDetectedError) as ei:
        dbcsr.multiply(a, b, mesh=mesh, algorithm="cannon",
                       verify="checksum", **EXEC_KW)
    assert ei.value.report.repair_attempted and not ei.value.report.repaired


def test_verify_nonfinite_operand_raises(sparse_2x2):
    mesh, a, b = sparse_2x2
    bad = dataclasses.replace(a, data=a.data.clone())
    bad.data[0, 0] = float("inf")
    with pytest.raises(guards.NonFiniteOperandError):
        dbcsr.multiply(bad, b, mesh=mesh, algorithm="cannon",
                       verify="checksum", **EXEC_KW)


# ---------------------------------------------------------------------------
# planner: verify="auto" is a costed decision
# ---------------------------------------------------------------------------

def test_decide_verify_budget():
    """The reference's test with its constants, on 1x1 as there (where
    the port charges no communication: ``test_decide_verify_matches_jax``
    holds that departure)."""
    hw = HW_REF
    kw = dict(mesh_shape=(1, 1), hw=hw)
    # large square problem: checksum flops are O(1/nblocks) of the
    # multiply -> enabled under the default budget
    big = plan_multiply(2048, 2048, 2048, blocks=(64, 64, 64), **kw)
    d_big = decide_verify(big, 2048, 2048, 2048, blocks=(64, 64, 64),
                          n_ranks=1, hw=hw)
    assert d_big["auto_enabled"]
    assert d_big["overhead_frac"] <= d_big["budget"]
    # tiny problem: fixed latencies dominate -> declined
    small = plan_multiply(64, 64, 64, blocks=(32, 32, 32), **kw)
    d_small = decide_verify(small, 64, 64, 64, blocks=(32, 32, 32),
                            n_ranks=1, hw=hw)
    assert not d_small["auto_enabled"]
    # a zero budget declines everything
    d_zero = decide_verify(big, 2048, 2048, 2048, blocks=(64, 64, 64),
                           n_ranks=1, budget=0.0, hw=hw)
    assert not d_zero["auto_enabled"]


@pytest.mark.parametrize("hw_name", ["ref_defaults", "h100"])
@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2), (4, 4), (2, 4),
                                        (2, 2, 2)])
@pytest.mark.parametrize("geom", [(2048, 2048, 2048, 64), (64, 64, 64, 32),
                                  (3960, 3960, 3960, 22),
                                  (1408, 123904, 1408, 22)])
@pytest.mark.parametrize("budget", [None, 0.05])
def test_decide_verify_matches_jax(mesh_shape, geom, hw_name, budget,
                                   tmp_path, monkeypatch):
    """Both packages' ``decide_verify`` on both packages' plans.  On
    more than one rank the port's is the reference's; on 1x1 the port
    departs by design (no communication and no collective latency on
    one rank), and equals the reference's formulas with those terms
    removed (``bytes_per_s`` infinite, ``latency_s`` 0).  Both plan
    without a winners table (the port's H100 table prices blocks 22 and
    64 at its swept rates)."""
    from repro_torch.planner.cost_model import DEFAULT_HARDWARE

    monkeypatch.chdir(tmp_path)
    hw = HW_REF if hw_name == "ref_defaults" else DEFAULT_HARDWARE
    m, k, n, bs = geom
    n_ranks = math.prod(mesh_shape)
    ref_hw = jcm.HardwareModel.from_dict(hw.to_dict())
    if n_ranks == 1:
        ref_hw = dataclasses.replace(ref_hw, bytes_per_s=math.inf,
                                     latency_s=0.0)
    blocks = (bs,) * 3
    got_plan = plan_multiply(m, k, n, blocks=blocks, mesh_shape=mesh_shape,
                             hw=hw)
    want_plan = jplan.plan_multiply(m, k, n, blocks=blocks,
                                    mesh_shape=mesh_shape, hw=ref_hw)
    got = decide_verify(got_plan, m, k, n, blocks=blocks, n_ranks=n_ranks,
                        budget=budget, hw=hw)
    want = jplan.decide_verify(want_plan, m, k, n, blocks=blocks,
                               budget=budget, hw=ref_hw)
    assert got["auto_enabled"] == want["auto_enabled"]
    assert got["budget"] == want["budget"]
    for key in ("predicted_overhead_s", "overhead_frac"):
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    if n_ranks == 1:
        # the departure is exactly the two terms
        full = jplan.decide_verify(want_plan, m, k, n, blocks=blocks,
                                   budget=budget,
                                   hw=jcm.HardwareModel.from_dict(
                                       hw.to_dict()))
        assert got["predicted_overhead_s"] == pytest.approx(
            full["predicted_overhead_s"]
            - (bs * n + m * bs) * 4 / hw.bytes_per_s - 4 * hw.latency_s,
            rel=1e-9)


def test_decide_verify_trivial_plan_is_infinite():
    plan = plan_multiply(256, 256, 256, blocks=(32, 32, 32), occupancy=0.0,
                         hw=HW_REF)
    d = decide_verify(plan, 256, 256, 256, blocks=(32, 32, 32), n_ranks=1,
                      hw=HW_REF)
    assert plan.trivial and d["overhead_frac"] == math.inf
    assert not d["auto_enabled"]


def test_multiply_verify_auto_prices_overhead(rng):
    mesh = _mesh11()
    a = _operand(rng, 64, 64, mesh=mesh)
    c = dbcsr.multiply(a, a, mesh=mesh, verify="auto", **EXEC_KW)
    info = c.verification
    assert info["mode"] == "auto"
    assert "overhead_frac" in info and "predicted_overhead_s" in info
    # explicit generous budget forces it on even for a small problem
    c2 = dbcsr.multiply(a, a, mesh=mesh, verify="auto",
                        verify_budget=1e9, **EXEC_KW)
    assert c2.verification["enabled"]
    assert c2.verification["report"] is not None


# ---------------------------------------------------------------------------
# guards: typed validation taxonomy + tripwires
# ---------------------------------------------------------------------------

def test_guards_finite_tripwires(rng):
    x = torch.from_numpy(rng.randn(8, 8).astype(np.float32))

    def with_value(v):
        y = x.clone()
        y[3, 3] = v
        return y

    assert guards.all_finite(x)
    assert not guards.all_finite(with_value(float("nan")))
    with pytest.raises(guards.NonFiniteOperandError):
        guards.assert_finite(with_value(float("inf")), "A")
    with pytest.raises(guards.NonFiniteResultError):
        guards.assert_finite(with_value(float("inf")), "C", kind="result")
    assert guards.all_finite(torch.arange(4))  # integer dtypes: trivially ok


def test_guards_validate_multiply_request(rng):
    mesh = _mesh11()
    a = _operand(rng, 64, 64, mesh=mesh)
    b = _operand(rng, 64, 96, mesh=mesh)
    guards.validate_multiply_request(a, b)  # clean pair passes

    # inner-dimension mismatch
    with pytest.raises(guards.ShapeMismatchError):
        guards.validate_multiply_request(b, b)

    # mask inconsistency: wrong mask shape
    bad = _operand(rng, 64, 64, mesh=mesh)
    bad.block_mask = np.ones((3, 3), dtype=bool)
    with pytest.raises(guards.MaskConsistencyError):
        guards.validate_multiply_request(bad, b)

    # norm-cache inconsistency: nonzero norm outside the mask
    nb = _operand(rng, 64, 64, fill=0.5, mesh=mesh)
    nb.norms()
    if not nb.block_mask.all():
        norms = np.asarray(nb.block_norms).copy()
        norms[~nb.block_mask] = 1.0
        nb.block_norms = norms
        with pytest.raises(guards.NormConsistencyError):
            guards.validate_multiply_request(nb, b)

    # taxonomy: every typed error is a DbcsrValidationError is a ValueError
    for exc in (guards.ShapeMismatchError, guards.GridMismatchError,
                guards.MaskConsistencyError, guards.NormConsistencyError,
                guards.NonFiniteOperandError, guards.NonFiniteResultError):
        assert issubclass(exc, guards.DbcsrValidationError)
        assert issubclass(exc, ValueError)


# ---------------------------------------------------------------------------
# chaos: deterministic injection
# ---------------------------------------------------------------------------

def test_fault_injector_deterministic(rng):
    # compare BIT PATTERNS: flipping the exponent MSB of a value in
    # [1, 2) lands on NaN, and NaN != NaN
    c = torch.from_numpy(rng.randn(64, 64).astype(np.float32))
    one = chaos.FaultInjector(seed=5).corrupt_block(
        c, 1, 1, block_m=32, block_n=32, mode="bitflip")
    two = chaos.FaultInjector(seed=5).corrupt_block(
        c, 1, 1, block_m=32, block_n=32, mode="bitflip")
    other = chaos.FaultInjector(seed=6).corrupt_block(
        c, 1, 1, block_m=32, block_n=32, mode="bitflip")
    assert (_bits(one) == _bits(two)).all()
    assert (_bits(one) != _bits(c)).any()
    assert (_bits(one) != _bits(other)).any()
    # corruption stays inside the target block
    delta = _bits(one) != _bits(c)
    delta[32:64, 32:64] = False
    assert not delta.any()


def test_one_shot_hook_fires_once(rng):
    c = torch.from_numpy(rng.randn(64, 64).astype(np.float32))
    hook = chaos.FaultInjector(seed=0).one_shot_result_hook(
        0, 0, block_m=32, block_n=32, mode="nan")
    first = hook(c)
    assert torch.isnan(first).any()
    second = hook(c)  # identity after the first firing
    assert torch.equal(second, c)


def test_dispatch_fault_injector():
    inj = chaos.DispatchFaultInjector(fail_first=2)
    with pytest.raises(chaos.TransientDispatchError):
        inj.check(stage="fused", attempt=0)
    with pytest.raises(chaos.TransientDispatchError):
        inj.check(stage="fused", attempt=1)
    inj.check(stage="fused", attempt=2)  # budget exhausted: passes
    staged = chaos.DispatchFaultInjector(fail_stages=("fused",))
    with pytest.raises(chaos.TransientDispatchError):
        staged.check(stage="fused", attempt=0)
    staged.check(stage="looped", attempt=0)


# ---------------------------------------------------------------------------
# service: retry/degradation ladder, error tickets, ticket taxonomy
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _service(mesh, **kw):
    from repro_torch.serve.multiply_service import MultiplyService

    kw.setdefault("slo_s", 0.0)
    kw.setdefault("max_batch", 8)
    kw.setdefault("clock", FakeClock())
    kw.setdefault("sleep", lambda s: None)
    return MultiplyService(mesh, **{**EXEC_KW, **kw})


def test_service_ticket_taxonomy(rng):
    from repro_torch.serve.multiply_service import (TicketPendingError,
                                                    UnknownTicketError)

    mesh = _mesh11()
    svc = _service(mesh)
    t = svc.submit(_operand(rng, 64, 64, mesh=mesh),
                   _operand(rng, 64, 64, mesh=mesh))
    with pytest.raises(TicketPendingError):
        svc.result(t)          # still queued
    with pytest.raises(UnknownTicketError):
        svc.result(t + 100)    # never submitted
    svc.poll()
    svc.result(t)
    with pytest.raises(UnknownTicketError):
        svc.result(t)          # already retrieved
    assert issubclass(TicketPendingError, KeyError)
    assert issubclass(UnknownTicketError, KeyError)


def test_service_retries_transient_failures(rng):
    mesh = _mesh11()
    slept = []
    svc = _service(mesh, sleep=slept.append, max_retries=2, backoff_s=0.05,
                   fault_injector=chaos.DispatchFaultInjector(fail_first=2))
    a, b = _operand(rng, 64, 64, mesh=mesh), _operand(rng, 64, 64, mesh=mesh)
    ref = dbcsr.multiply(a, b, mesh=mesh, **EXEC_KW)
    t = svc.submit(a, b)
    assert svc.poll() == [t]
    assert torch.equal(svc.result(t).data, ref.data)
    st = svc.stats()
    assert st["n_retries"] == 2 and st["n_degradations"] == 0
    assert st["n_error_tickets"] == 0
    assert slept == [0.05, 0.1]  # exponential backoff


def test_service_degrades_to_looped(rng):
    mesh = _mesh11()
    svc = _service(mesh, max_retries=1,
                   fault_injector=chaos.DispatchFaultInjector(
                       fail_stages=("fused",)))
    a, b = _operand(rng, 64, 64, mesh=mesh), _operand(rng, 64, 64, mesh=mesh)
    t = svc.submit(a, b)
    svc.poll()
    svc.result(t)
    st = svc.stats()
    assert st["n_degradations"] == 1
    assert st["buckets"][-1]["stage"] == "looped"


def test_service_per_request_isolation(rng):
    # every batched rung fails -> per-request isolation still delivers
    mesh = _mesh11()
    svc = _service(mesh, max_retries=0,
                   fault_injector=chaos.DispatchFaultInjector(
                       fail_stages=("fused", "looped")))
    a, b = _operand(rng, 64, 64, mesh=mesh), _operand(rng, 64, 64, mesh=mesh)
    ref = dbcsr.multiply(a, b, mesh=mesh, **EXEC_KW)
    t = svc.submit(a, b)
    done = svc.poll()
    assert done == [t]  # poll() never loses tickets
    assert torch.equal(svc.result(t).data, ref.data)
    st = svc.stats()
    assert st["n_degradations"] == 2
    assert st["buckets"][-1]["stage"] == "per_request"


def test_service_poison_request_quarantined(rng):
    # a poison request in a fused batch yields an error ticket for that
    # request only; every other request's result is bit-identical to a
    # clean run
    mesh = _mesh11()
    svc = _service(mesh)
    good = [(_operand(rng, 64, 64, mesh=mesh),
             _operand(rng, 64, 64, mesh=mesh)) for _ in range(3)]
    bad_a = _operand(rng, 64, 64, mesh=mesh)
    bad_a.data = bad_a.data.clone()
    bad_a.data[0, 0] = float("nan")
    refs = [dbcsr.multiply(a, b, mesh=mesh, **EXEC_KW) for a, b in good]
    t_good = [svc.submit(a, b) for a, b in good]
    t_bad = svc.submit(bad_a, _operand(rng, 64, 64, mesh=mesh))
    done = svc.poll()
    assert sorted(done) == sorted(t_good + [t_bad])
    for t, ref in zip(t_good, refs):
        assert torch.equal(svc.result(t).data, ref.data)
    with pytest.raises(guards.NonFiniteResultError):
        svc.result(t_bad)
    st = svc.stats()
    assert st["n_error_tickets"] == 1
    assert st["n_nonfinite_quarantined"] == 1
    assert st["n_completed"] == 3


def test_service_validates_at_submit(rng):
    mesh = _mesh11()
    svc = _service(mesh)
    a = _operand(rng, 64, 64, mesh=mesh)
    bad = _operand(rng, 64, 64, mesh=mesh)
    bad.block_mask = np.ones((5, 5), dtype=bool)
    with pytest.raises(guards.MaskConsistencyError):
        svc.submit(a, bad)     # rejected synchronously, no ticket burned
    with pytest.raises(guards.ShapeMismatchError):
        svc.submit(a, _operand(rng, 96, 64, mesh=mesh))
    assert svc.stats()["n_requests"] == 0
    # validation is optional
    loose = _service(mesh, validate=False)
    t = loose.submit(a, bad)
    assert isinstance(t, int)


def test_service_verify_forwarded(rng):
    # verify= flows through the service kw into the looped multiply
    mesh = _mesh11()
    svc = _service(mesh, verify="checksum")
    a, b = _operand(rng, 64, 64, mesh=mesh), _operand(rng, 64, 64, mesh=mesh)
    t = svc.submit(a, b)
    svc.poll()
    c = svc.result(t)
    assert c.verification is not None
    assert not c.verification["report"].detected


@pytest.mark.parametrize("fused", [None, True, False])
def test_service_verify_reaches_every_rung(rng, fused):
    """verify= reaches the request on whichever rung delivers it: the
    planned / pinned rung (looped under verify; fused=True raises there
    and the ladder degrades to the looped rung) and per-request
    isolation."""
    mesh = _mesh11()
    a, b = _operand(rng, 64, 64, mesh=mesh), _operand(rng, 64, 64, mesh=mesh)
    ref = dbcsr.multiply(a, b, mesh=mesh, **EXEC_KW)
    for stages in ((), ("fused", "looped")):
        svc = _service(mesh, verify="checksum", fused=fused, max_retries=0,
                       fault_injector=chaos.DispatchFaultInjector(
                           fail_stages=stages))
        t = svc.submit(a, b)
        svc.poll()
        c = svc.result(t)
        assert c.verification["enabled"]
        assert not c.verification["report"].detected
        assert torch.equal(c.data, ref.data)


# ---------------------------------------------------------------------------
# 2x2 mesh: the chaos matrix, in process on a simulated mesh
# ---------------------------------------------------------------------------

def test_chaos_matrix_2x2_mesh():
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    rows = chaos.run_injection_matrix(
        mesh, "2x2", algorithms=("cannon", "summa"), fills=(1.0, 0.05),
        modes=("bitflip", "nan"), geometry=(128, 128, 128), block=32,
        seed=0)
    inject = [r for r in rows if r["mode"] not in ("clean", "clean_eps")]
    clean = [r for r in rows if r["mode"] in ("clean", "clean_eps")]
    assert len(rows) == 16
    assert all(r["ok"] for r in inject), inject
    assert all(not r["detected"] for r in clean)
    assert all(r["localized_exact"] for r in inject)


def test_chaos_cli_report(tmp_path, capsys):
    """The --report CLI on the CPU (1x1 and 2x2): all green, scorecard
    written."""
    import json

    out = tmp_path / "chaos.json"
    assert chaos._main(["--report", "--device", "cpu", "--out",
                        str(out)]) == 0
    card = json.loads(out.read_text())
    assert card["all_ok"] and card["n_false_positives"] == 0
    assert card["n_injected"] == card["n_bitwise_clean"] == 24
    assert "chaos scorecard" in capsys.readouterr().out


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)])
def test_injection_matrix_through_the_smm_wrapper(mesh_shape):
    """``local_kernel="smm"`` (the card's path; its plain version on
    the CPU) is all green too."""
    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    rows = chaos.run_injection_matrix(mesh, "x".join(map(str, mesh_shape)),
                                      local_kernel="smm")
    assert len(rows) == 20 and all(r["ok"] for r in rows)
