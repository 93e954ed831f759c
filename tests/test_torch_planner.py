"""The multiply planner of the port (repro_torch.planner) against the JAX
package's, on the CPU.

Three parts:

* the JAX package's planner tests (tests/test_planner.py), mirrored on
  the port.  Tests whose outcome depends on the constants pin the JAX
  package's default values (``HW_REF``), as the reference's tests do;
  the others also run under the port's H100 defaults;
* parity: over the JAX package's bench_planner sweep (square, tall and
  skinny shapes, smoke and full; fills 1, 0.5, 0.2, 0.05; meshes 1x1,
  2x2, 2x4, 4x4, 2x2x2; blocks 16, 22, 64; rank imbalance None, 1.5, 3;
  batches 1, 4, 16), both packages' ``plan_multiply`` and
  ``plan_multiply_batched`` with one explicit HardwareModel, for two
  sets of constants.  Choices must be equal, predicted times equal to
  ``rel=1e-12`` (the same formulas in the same order; only ``align``,
  which no cost reads, differs: the reference's heuristic is MXU-driven);
* the dispatch layers on a simulated 2x2 CPU mesh: ``algorithm="auto"``,
  ``return_plan``, ``fused=None`` and ``rebalance=None`` against every
  pinned configuration.

Every test runs in an empty working directory, so neither package reads
a winners table or a calibration file.  Tolerance of products against
numpy: 2e-4 absolute (the reference battery's), f32 sums over k = 128.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.planner import cost_model as jcm
from repro.planner import plan as jplan

from repro_torch.core import dbcsr
from repro_torch.core.blocking import GridSpec
from repro_torch.core.multiply import _distributed_matmul, distributed_matmul
from repro_torch.core.multiply_batched import distributed_matmul_batched
from repro_torch.core.tall_skinny import (DEFAULT_TS_RATIO, classify_shape,
                                          ts_classify_ratio)
from repro_torch.kernels.smm.autotune import best_params_for, best_params_meta
from repro_torch.launch.mesh import make_mesh
from repro_torch.planner import calibrate, cost_model
from repro_torch.planner.cost_model import (DEFAULT_HARDWARE, HardwareModel,
                                            Problem, candidate_cost,
                                            ts_crossover_ratio)
from repro_torch.planner.plan import (BatchedMultiplyPlan, MultiplyPlan,
                                      plan_cache_clear, plan_cache_info,
                                      plan_cache_stats, plan_multiply,
                                      plan_multiply_batched)
from repro_torch.serve import MultiplyService

from torch_threads import one_thread  # noqa: F401

HW_REF = HardwareModel.from_dict(jcm.DEFAULT_HARDWARE.to_dict())
HW_SETS = {"ref_defaults": HW_REF, "h100": DEFAULT_HARDWARE}
HW = HW_REF
TOL = 2e-4


@pytest.fixture(autouse=True)
def _no_artifacts(tmp_path, monkeypatch):
    """An empty working directory: no winners table, no calibration
    file; the resolved constants are the port's defaults."""
    monkeypatch.chdir(tmp_path)
    calibrate.invalidate_cache()
    yield
    calibrate.invalidate_cache()


# ---------------------------------------------------------------------------
# cost-model sanity (mirrors of the JAX package's tests)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", sorted(HW_SETS))
def test_cannon_cost_monotone_in_comm_volume(hw):
    costs = [candidate_cost(HW_SETS[hw], Problem(1024, k, 1024, 64, 64, 64,
                                                 1.0, 4, 2, 2), "cannon",
                            True)
             for k in (1024, 2048, 4096, 8192)]
    assert all(c.feasible for c in costs)
    comms = [c.comm_s for c in costs]
    assert comms == sorted(comms) and comms[0] < comms[-1]
    totals = [c.total_s for c in costs]
    assert totals == sorted(totals)


@pytest.mark.parametrize("hw", sorted(HW_SETS))
def test_cannon_cost_scales_with_bandwidth(hw):
    base = HW_SETS[hw]
    slow = base.replace(bytes_per_s=base.bytes_per_s / 10)
    prob = Problem(2048, 2048, 2048, 64, 64, 64, 1.0, 4, 2, 2)
    assert candidate_cost(slow, prob, "cannon", True).comm_s > \
        candidate_cost(base, prob, "cannon", True).comm_s


@pytest.mark.parametrize("hw", sorted(HW_SETS))
def test_25d_beats_cannon_only_when_memory_allows(hw):
    hw = HW_SETS[hw].replace(latency_s=1e-6, bytes_per_s=1e11)
    kw = dict(blocks=(64, 64, 64), mesh_shape=(4, 4, 2), densify=True)
    ample = plan_multiply(8192, 8192, 8192, hw=hw, **kw)
    assert ample.algorithm == "cannon25d" and ample.c_repl == 2
    c25 = next(c for c in ample.candidates if c.algorithm == "cannon25d")
    ca = next(c for c in ample.candidates if c.algorithm == "cannon")
    assert c25.total_s < ca.total_s
    assert c25.mem_bytes > ca.mem_bytes  # the replication charge
    tight = plan_multiply(8192, 8192, 8192,
                          hw=hw.replace(mem_bytes=60e6), **kw)
    assert tight.algorithm == "cannon"
    c25 = next(c for c in tight.candidates if c.algorithm == "cannon25d")
    assert not c25.feasible and "GB/device" in c25.reason


def test_tall_skinny_picked_for_8_to_1_shapes():
    for m, k, n, family in [(512, 4096, 512, "ts_k"),
                            (4096, 512, 512, "ts_m"),
                            (512, 512, 4096, "ts_n")]:
        plan = plan_multiply(m, k, n, blocks=(64, 64, 64),
                             mesh_shape=(2, 2), hw=HW)
        assert plan.algorithm == family, (m, k, n, plan.algorithm)


@pytest.mark.parametrize("hw", sorted(HW_SETS))
def test_forced_algorithm_and_path_are_honoured(hw):
    plan = plan_multiply(1024, 1024, 1024, blocks=(64, 64, 64),
                         mesh_shape=(2, 2), algorithm="summa",
                         densify=False, hw=HW_SETS[hw])
    assert plan.algorithm == "summa" and plan.densify is False
    assert plan.stack_tile is not None and plan.align is not None
    assert plan.params_source is not None


@pytest.mark.parametrize("hw", sorted(HW_SETS))
def test_explain_lists_candidates(hw):
    plan = plan_multiply(1024, 1024, 1024, blocks=(64, 64, 64),
                         mesh_shape=(2, 2), hw=HW_SETS[hw])
    text = plan.explain()
    assert text.startswith("plan:")
    for label in ("cannon+densified", "summa+blocked", "ts_k+densified"):
        assert label in text
    assert "infeasible" in text  # cannon25d on a 2D mesh
    assert plan.chosen is not None and plan.chosen.total_s == \
        plan.predicted_s


# ---------------------------------------------------------------------------
# plan cache + trivial plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", sorted(HW_SETS))
def test_plan_cache_second_call_zero_evaluations(hw):
    kw = dict(blocks=(32, 32, 32), mesh_shape=(2, 2), occupancy=0.37,
              hw=HW_SETS[hw])
    first = plan_multiply(640, 640, 640, **kw)
    before = cost_model.N_EVALS
    second = plan_multiply(640, 640, 640, **kw)
    assert cost_model.N_EVALS == before, "cache hit must not re-evaluate"
    assert second is first
    stats = plan_cache_stats()
    assert stats["hits"] >= 1 and stats["currsize"] >= 1
    assert stats["evictions"] == stats["misses"] - stats["currsize"]
    plan_cache_clear()
    assert plan_cache_info().currsize == 0


def test_zero_occupancy_returns_trivial_plan_without_evaluations():
    before = cost_model.N_EVALS
    plan = plan_multiply(256, 256, 256, blocks=(16, 16, 16),
                         mesh_shape=(2, 2), occupancy=0.0, hw=HW)
    assert plan.trivial and plan.predicted_s == 0.0
    assert plan.candidates == ()
    assert cost_model.N_EVALS == before
    assert plan.densify is False
    assert "trivial" in plan.explain()


def test_blocked_cost_rejects_zero_occupancy():
    with pytest.raises(ValueError, match="occupancy"):
        candidate_cost(HW, Problem(256, 256, 256, 16, 16, 16, 0.0,
                                   4, 2, 2), "cannon", False)


# ---------------------------------------------------------------------------
# rank imbalance pricing + rebalance arming
# ---------------------------------------------------------------------------


def test_rebalance_armed_on_imbalanced_blocked_plan():
    kw = dict(blocks=(64, 64, 64), mesh_shape=(2, 2), occupancy=0.05,
              densify=False, hw=HW)
    plan = plan_multiply(4096, 4096, 4096, **kw, rank_imbalance=4.0)
    assert plan.rank_imbalance == pytest.approx(4.0)
    assert plan.rebalance, "4x imbalance at 5% fill should arm rebalance"
    assert plan.rebalance_saved_s > plan.rebalance_cost_s > 0.0
    assert "imbal" in plan.explain()


@pytest.mark.parametrize("hw", sorted(HW_SETS))
def test_rebalance_declined_when_balanced(hw):
    kw = dict(blocks=(64, 64, 64), mesh_shape=(2, 2), occupancy=0.05,
              densify=False, hw=HW_SETS[hw])
    uniform = plan_multiply(4096, 4096, 4096, **kw, rank_imbalance=1.0)
    assert not uniform.rebalance and uniform.rebalance_saved_s == 0.0
    unknown = plan_multiply(4096, 4096, 4096, **kw)
    assert not unknown.rebalance
    assert unknown is not uniform


@pytest.mark.parametrize("hw", sorted(HW_SETS))
def test_imbalance_inflates_blocked_candidate_cost(hw):
    hw = HW_SETS[hw]
    prob = Problem(4096, 4096, 4096, 64, 64, 64, 0.05, 4, 2, 2)
    union = candidate_cost(hw, prob, "cannon", False)
    flat = candidate_cost(hw, prob, "cannon", False, rank_imbalance=1.0)
    skew = candidate_cost(hw, prob, "cannon", False, rank_imbalance=3.0)
    assert flat.total_s < skew.total_s < union.total_s
    dense_flat = candidate_cost(hw, prob, "cannon", True)
    dense_skew = candidate_cost(hw, prob, "cannon", True, rank_imbalance=3.0)
    assert dense_skew.total_s == pytest.approx(dense_flat.total_s)


# ---------------------------------------------------------------------------
# planner-owned classify threshold + winners-table metadata
# ---------------------------------------------------------------------------


def test_ts_classify_ratio_exported_and_consistent():
    ratio = ts_classify_ratio()
    assert 2.0 <= ratio <= 64.0
    assert ratio == ts_crossover_ratio(calibrate.get_hardware_model())
    for m, k, n in [(100, 150, 80), (64, 4096, 64), (63360,) * 3,
                    (1408, 1982464, 1408)]:
        algo = classify_shape(m, k, n)
        dims = {"m": m, "k": k, "n": n}
        big = max(dims, key=dims.get)
        others = max(v for kk, v in dims.items() if kk != big)
        assert (algo == f"ts_{big}") == (dims[big] >= ratio * others)
    assert classify_shape(64, 512, 64, ratio=DEFAULT_TS_RATIO) == "ts_k"
    assert classify_shape(64, 500, 64, ratio=DEFAULT_TS_RATIO) == "cannon"


@pytest.mark.parametrize("hw", sorted(HW_SETS))
def test_ts_crossover_ratio_bounds(hw):
    base = HW_SETS[hw]
    for h in (base, base.replace(bytes_per_s=base.bytes_per_s * 100),
              base.replace(latency_s=1e-6, bytes_per_s=1e11),
              base.replace(latency_s=0.0)):
        assert 2.0 <= ts_crossover_ratio(h) <= 64.0
    slow_lat = base.replace(latency_s=base.latency_s * 100)
    assert ts_crossover_ratio(slow_lat) <= ts_crossover_ratio(base)
    assert ts_crossover_ratio(base) == jcm.ts_crossover_ratio(
        jcm.HardwareModel.from_dict(base.to_dict()))


def test_best_params_meta_provenance(tmp_path):
    import json

    meta = best_params_meta(99, 99, 99, str(tmp_path / "none.json"))
    assert meta["source"] == "heuristic"
    assert (meta["align"], meta["stack_tile"]) == \
        best_params_for(99, 99, 99, str(tmp_path / "none.json"))
    cache = {"64": {"best": {"align": True, "stack_tile": 4096,
                             "gflops": 12.5}}}
    path = tmp_path / "tab.json"
    path.write_text(json.dumps(cache))
    meta = best_params_meta(64, 64, 64, str(path))
    assert meta["source"] == "winners[64]" and meta["gflops"] == 12.5
    meta = best_params_meta(64, 64, 64, str(path), fill=0.05)
    assert meta["source"] == "winners[64]" and meta["bin"] == 0.05
    # non-uniform geometry: no table entry (the JAX package's source name)
    assert best_params_meta(32, 64, 32)["source"] == "heuristic-nonuniform"


def test_winners_table_rate_feeds_the_blocked_model(tmp_path):
    """A winners entry's measured rate replaces smm_flops_per_s, and
    writing the table changes the plan cache's key."""
    import json

    kw = dict(blocks=(64, 64, 64), mesh_shape=(2, 2), densify=False,
              hw=DEFAULT_HARDWARE)
    before = plan_multiply(4096, 4096, 4096, **kw)
    (tmp_path / "artifacts").mkdir()
    (tmp_path / "artifacts" / "smm_autotune_h100.json").write_text(
        json.dumps({"64": {"best": {"stack_tile": 1000, "gflops": 1.0}}}))
    after = plan_multiply(4096, 4096, 4096, **kw)
    assert after.stack_tile == 1000 and after.params_source == "winners[64]"
    assert after.predicted_s > 100 * before.predicted_s


def test_float16_is_priced_as_the_float32_it_runs_in():
    """The port widens float16 operands to f32 for the local multiply,
    so it prices them at 4 bytes; the JAX package keeps float16 (2)."""
    kw = dict(blocks=(64, 64, 64), mesh_shape=(2, 2), hw=HW)
    f16 = plan_multiply(2048, 2048, 2048, dtype=np.float16, **kw)
    f32 = plan_multiply(2048, 2048, 2048, dtype=np.float32, **kw)
    assert f16 is f32
    assert plan_multiply(2048, 2048, 2048, dtype=torch.float16, **kw) is f32
    want = jplan.plan_multiply(
        2048, 2048, 2048, dtype=np.float16, blocks=(64, 64, 64),
        mesh_shape=(2, 2), hw=jcm.HardwareModel.from_dict(HW.to_dict()))
    assert want.predicted_s < f16.predicted_s


# ---------------------------------------------------------------------------
# parity over the bench_planner sweep
# ---------------------------------------------------------------------------

SHAPES = {"square-smoke": (384, 384, 384), "tall-smoke": (128, 4096, 128),
          "skinny-smoke": (4096, 128, 128), "square": (512, 512, 512),
          "tall": (128, 8192, 128), "skinny": (8192, 128, 128)}
FILLS = (1.0, 0.5, 0.2, 0.05)
MESHES = {"1x1": (1, 1), "2x2": (2, 2), "2x4": (2, 4), "4x4": (4, 4),
          "2x2x2": (2, 2, 2)}
IMBALANCES = (None, 1.5, 3.0)
BATCHES = (1, 4, 16)
PLAN_FIELDS = ("algorithm", "densify", "c_repl", "stack_tile",
               "pipeline_depth", "rebalance", "trivial", "occupancy")


def _same_plan(got: MultiplyPlan, want, where, full=None):
    """``got`` against the reference's ``want``.  On one rank (``full``
    given: the reference's plan under its complete formulas, ``want``
    its plan without communication and latency), every algorithm is the
    same local multiply to the port's model, so the totals tie and the
    choice among them falls to ``unpriced_s``, the schedule movement the
    reference charges: ``got`` must take the tied candidate with the
    least of it, and each candidate's ``unpriced_s`` must equal the
    difference of the reference's two totals."""
    by_choice = () if full is None else ("algorithm", "c_repl",
                                          "overlap_eff")
    for f in PLAN_FIELDS:
        if f not in by_choice:
            assert getattr(got, f) == getattr(want, f), (where, f)
    for f in ("predicted_s", "overlap_eff", "rank_imbalance",
              "rebalance_saved_s", "rebalance_cost_s"):
        if f not in by_choice:
            assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                    rel=1e-12), (where, f)
    assert len(got.candidates) == len(want.candidates), where
    for c, w in zip(got.candidates, want.candidates):
        assert (c.label, c.feasible) == (w.label, w.feasible), where
        assert c.total_s == pytest.approx(w.total_s, rel=1e-12), (where, c)
    if full is None:
        return
    for c, w, fw in zip(got.candidates, want.candidates, full.candidates):
        if math.isfinite(fw.total_s):
            assert c.unpriced_s == pytest.approx(
                fw.total_s - w.total_s, rel=1e-9, abs=1e-15), (where, c)
    pool = ([c for c in got.candidates if c.feasible]
            or [c for c in got.candidates if math.isfinite(c.total_s)])
    assert got.chosen is min(pool, key=lambda c: (c.total_s, c.unpriced_s))


@pytest.mark.parametrize("hw", sorted(HW_SETS))
@pytest.mark.parametrize("block", (16, 22, 64))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plan_parity_over_the_bench_planner_sweep(shape, mesh, block, hw):
    """On 1x1 the port departs from the reference by design: one rank
    is charged no communication time and no message latency.  Its plans
    there must equal the reference's formulas without those two terms
    (the reference's model with ``bytes_per_s`` infinite and
    ``latency_s`` 0, which zeroes exactly them and the overlap they
    feed), ties taken as ``_same_plan`` states; every other mesh keeps
    the reference's formulas."""
    m, k, n = SHAPES[shape]
    port_hw = HW_SETS[hw]
    ref_hw = full_hw = jcm.HardwareModel.from_dict(port_hw.to_dict())
    one_rank = MESHES[mesh] == (1, 1)
    if one_rank:
        ref_hw = dataclasses.replace(ref_hw, bytes_per_s=math.inf,
                                     latency_s=0.0)
    common = dict(blocks=(block,) * 3, mesh_shape=MESHES[mesh],
                  dtype=np.float32)
    for fill in FILLS:
        occ = fill * fill        # A and B at ``fill``: triple occupancy
        for imb in IMBALANCES:
            where = (shape, mesh, block, hw, fill, imb)
            got = plan_multiply(m, k, n, occupancy=occ, hw=port_hw,
                                rank_imbalance=imb, **common)
            want = jplan.plan_multiply(m, k, n, occupancy=occ, hw=ref_hw,
                                       rank_imbalance=imb, **common)
            full = (jplan.plan_multiply(m, k, n, occupancy=occ, hw=full_hw,
                                        rank_imbalance=imb, **common)
                    if one_rank else None)
            _same_plan(got, want, where, full)
        for g in BATCHES:
            pad = 1.0 - fill if fill < 1.0 else 0.0
            got = plan_multiply_batched(g, m, k, n, occupancy=occ,
                                        padding_frac=pad, hw=port_hw,
                                        **common)
            want = jplan.plan_multiply_batched(g, m, k, n, occupancy=occ,
                                               padding_frac=pad, hw=ref_hw,
                                               **common)
            where = (shape, mesh, block, hw, fill, g)
            if one_rank:
                # the batch-capable algorithms' plans tie on one rank: the
                # port takes the one whose schedule moves least, and its
                # plan is the reference's pinned to that algorithm
                per = [plan_multiply(m, k, n, occupancy=occ, hw=port_hw,
                                     algorithm=a, **common)
                       for a in ("cannon", "summa")]
                pick = min(per, key=lambda p: (
                    p.predicted_s,
                    p.chosen.unpriced_s if p.chosen else 0.0))
                assert got.per_request is pick, where
                want = jplan.plan_multiply_batched(
                    g, m, k, n, occupancy=occ, padding_frac=pad,
                    hw=ref_hw, algorithm=pick.algorithm, **common)
            assert (got.fuse, got.algorithm, got.densify, got.n_requests) \
                == (want.fuse, want.algorithm, want.densify,
                    want.n_requests), where
            for f in ("predicted_fused_s", "predicted_looped_s",
                      "padding_frac"):
                assert getattr(got, f) == pytest.approx(
                    getattr(want, f), rel=1e-12), (where, f)
            _same_plan(got.per_request, want.per_request, where)


# ---------------------------------------------------------------------------
# calibration file handling (no measurement on the CPU)
# ---------------------------------------------------------------------------


def test_calibration_file_overrides_defaults_and_rekeys_plans():
    assert calibrate.get_hardware_model() == DEFAULT_HARDWARE
    kw = dict(blocks=(64, 64, 64), mesh_shape=(2, 2))
    before = plan_multiply(2048, 2048, 2048, **kw)
    path = calibrate.save_calibration(
        {"latency_s": 1e-9, "not_a_constant": 3.0})
    assert path == calibrate.DEFAULT_CALIBRATION
    hw = calibrate.get_hardware_model()
    assert hw.latency_s == 1e-9 and hw.flops_per_s == \
        DEFAULT_HARDWARE.flops_per_s
    after = plan_multiply(2048, 2048, 2048, **kw)
    assert after is not before and after.predicted_s < before.predicted_s


def test_default_hardware_is_the_cards_own():
    """No constant of the JAX package's CPU work is a default here."""
    ref = jcm.DEFAULT_HARDWARE.to_dict()
    for key, value in DEFAULT_HARDWARE.to_dict().items():
        if key.startswith("overlap_"):
            continue     # 0 measured on one stream; 0 there by default
        assert value != ref[key], key


# ---------------------------------------------------------------------------
# the dispatch layers on a simulated 2x2 CPU mesh
# ---------------------------------------------------------------------------

M = K = N = 128
BS = 16
FIXED = ("cannon", "summa", "ts_k", "ts_m", "ts_n")


@pytest.fixture(scope="module")
def mesh22():
    return make_mesh((2, 2), ("data", "model"), device="cpu")


def _operands(fill, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randn(M, K).astype(np.float32)
    b = rng.randn(K, N).astype(np.float32)
    am = bm = None
    if fill < 1.0:
        am = rng.rand(M // BS, K // BS) < fill
        bm = rng.rand(K // BS, N // BS) < fill
        am[0, 0] = bm[0, 0] = True
        a = a * np.repeat(np.repeat(am, BS, 0), BS, 1)
        b = b * np.repeat(np.repeat(bm, BS, 0), BS, 1)
    return a, b, am, bm


def _kw(mesh, am, bm):
    return dict(mesh=mesh, grid=GridSpec("data", "model"), block_m=BS,
                block_k=BS, block_n=BS, a_mask=am, b_mask=bm)


@pytest.mark.parametrize("fill", [1.0, 0.2])
def test_auto_matches_every_fixed_algorithm(mesh22, fill):
    a, b, am, bm = _operands(fill)
    ref = a @ b
    kw = _kw(mesh22, am, bm)
    ta, tb = torch.tensor(a), torch.tensor(b)
    c_auto, plan = distributed_matmul(ta, tb, return_plan=True, **kw)
    assert np.abs(c_auto.numpy() - ref).max() < TOL
    assert plan.occupancy == pytest.approx(
        1.0 if am is None else
        float((am.astype(int) @ bm.astype(int)).sum()) / (M // BS) ** 3)
    for algo in FIXED:
        for dens in (True, False):
            c = distributed_matmul(ta, tb, algorithm=algo, densify=dens,
                                   **kw)
            assert np.abs(c.numpy() - ref).max() < TOL, (algo, dens)


@pytest.mark.parametrize("fill", [1.0, 0.2])
def test_auto_is_bitwise_its_pinned_plan(mesh22, fill):
    a, b, am, bm = _operands(fill, seed=1)
    kw = _kw(mesh22, am, bm)
    ta, tb = torch.tensor(a), torch.tensor(b)
    c_auto, plan = distributed_matmul(ta, tb, algorithm="auto",
                                      return_plan=True, **kw)
    pinned = distributed_matmul(ta, tb, algorithm=plan.algorithm,
                                densify=plan.densify, **kw)
    assert torch.equal(c_auto, pinned)
    ss = plan.schedule_stats
    assert ss["algorithm"] == plan.algorithm
    assert len(ss["steps"]) == ss["n_steps"] >= 1
    if plan.densify:
        assert plan.executor_stats is None
    else:
        assert plan.executor_stats["n_entries"] > 0


def test_return_plan_of_a_pinned_multiply_prices_what_runs(mesh22):
    a, b, am, bm = _operands(0.2, seed=2)
    kw = _kw(mesh22, am, bm)
    ta, tb = torch.tensor(a), torch.tensor(b)
    c, plan = distributed_matmul(ta, tb, algorithm="summa", densify=False,
                                 return_plan=True, **kw)
    assert (plan.algorithm, plan.densify) == ("summa", False)
    assert [c.label for c in plan.candidates] == ["summa+blocked"]
    es = plan.executor_stats
    assert es["rank_exact"] and es["rebalance_applied"] is False
    # the planned C-chunk imbalance is the executed per-rank one
    assert plan.rank_imbalance == pytest.approx(es["rank_imbalance"],
                                                rel=1e-6)
    assert _distributed_matmul(ta, tb, algorithm="summa", densify=False,
                               **kw)[1] == es
    _, gplan = distributed_matmul(ta, tb, algorithm="summa", bcast="gather",
                                  densify=True, return_plan=True, **kw)
    assert [c.label for c in gplan.candidates] == ["summa_gather+densified"]
    assert gplan.schedule_stats["prologue_comm_bytes"] > 0
    assert torch.equal(c, distributed_matmul(ta, tb, algorithm="summa",
                                             densify=False, **kw))


def test_auto_routed_through_planner(mesh22):
    a, b, _, _ = _operands(1.0, seed=3)
    grid = GridSpec("data", "model")
    am_ = dbcsr.create(a, mesh=mesh22, grid=grid, block_size=BS)
    bm_ = dbcsr.create(b, mesh=mesh22, grid=grid, block_size=BS)
    cm, pl = dbcsr.multiply(am_, bm_, mesh=mesh22, return_plan=True)
    assert pl.algorithm in FIXED
    assert np.abs(cm.data.numpy() - a @ b).max() < TOL
    assert cm.last_plan is pl and isinstance(pl, MultiplyPlan)
    again = dbcsr.multiply(am_, bm_, mesh=mesh22)
    assert torch.equal(again.data, cm.data)
    assert again.last_plan.algorithm == pl.algorithm


def test_schedule_stats_only_when_the_plan_is_asked_for(mesh22):
    """dbcsr.multiply always plans, but rebuilds the executed schedule
    for its per-step split only under ``return_plan=True``."""
    a, b, am, _ = _operands(0.2, seed=3)
    grid = GridSpec("data", "model")
    am_ = dbcsr.create(a, mesh=mesh22, grid=grid, block_size=BS,
                       block_mask=am)
    bm_ = dbcsr.create(b, mesh=mesh22, grid=grid, block_size=BS)
    cm, pl = dbcsr.multiply(am_, bm_, mesh=mesh22, return_plan=True)
    assert pl.schedule_stats["n_steps"] >= 1
    again = dbcsr.multiply(am_, bm_, mesh=mesh22)
    assert again.last_plan.schedule_stats is None
    assert again.last_plan.executor_stats == pl.executor_stats
    assert torch.equal(again.data, cm.data)


def test_plan_cache_hit_in_dispatch_path(mesh22):
    a, b, am, bm = _operands(0.2, seed=4)
    kw = _kw(mesh22, am, bm)
    ta, tb = torch.tensor(a), torch.tensor(b)
    _, plan = distributed_matmul(ta, tb, return_plan=True, **kw)
    ev0, hits0 = cost_model.N_EVALS, plan_cache_info().hits
    _, plan2 = distributed_matmul(ta, tb, return_plan=True, **kw)
    assert cost_model.N_EVALS == ev0
    assert plan_cache_info().hits - hits0 >= 1
    assert (plan2.algorithm, plan2.densify) == (plan.algorithm, plan.densify)


def test_empty_product_trivial_plan_in_dispatch_path(mesh22):
    a, b, _, _ = _operands(1.0, seed=5)
    za = np.zeros((M // BS, K // BS), bool)
    za[:, 0] = True
    zb = np.zeros((K // BS, N // BS), bool)
    zb[1, :] = True
    a = a * np.repeat(np.repeat(za, BS, 0), BS, 1)
    b = b * np.repeat(np.repeat(zb, BS, 0), BS, 1)
    ev0 = cost_model.N_EVALS
    c, plan = distributed_matmul(torch.tensor(a), torch.tensor(b),
                                 return_plan=True, **_kw(mesh22, za, zb))
    assert plan.trivial and cost_model.N_EVALS == ev0
    assert float(c.abs().max()) == 0.0


def _requests(mesh, n, rng, fill=1.0):
    reqs, refs = [], []
    grid = GridSpec("data", "model")
    for _ in range(n):
        a = rng.randn(M, K).astype(np.float32)
        b = rng.randn(K, N).astype(np.float32)
        mask = None
        if fill < 1.0:
            # the same block count a request: one fill bin, one bucket
            nb = (M // BS) * (K // BS)
            mask = np.zeros(nb, dtype=bool)
            mask[rng.choice(nb, int(fill * nb), replace=False)] = True
            mask = mask.reshape(M // BS, K // BS)
        am_ = dbcsr.create(a, mesh=mesh, grid=grid, block_size=BS,
                           block_mask=mask)
        reqs.append((am_, dbcsr.create(b, mesh=mesh, grid=grid,
                                       block_size=BS)))
        refs.append(am_.data.numpy() @ b)
    return reqs, refs


@pytest.mark.parametrize("fill", [1.0, 0.2])
def test_multiply_batched_fused_none(mesh22, fill):
    reqs, refs = _requests(mesh22, 4, np.random.RandomState(6), fill)
    out, report = dbcsr.multiply_batched(reqs, mesh=mesh22,
                                         return_plan=True)
    (rep,) = report["buckets"]
    plan = rep["plan"]
    assert isinstance(plan, BatchedMultiplyPlan)
    assert plan.fuse == rep["fused"] and plan.n_requests == 4
    assert "batched plan: 4 requests" in plan.explain()
    pinned = dbcsr.multiply_batched(reqs, mesh=mesh22, fused=plan.fuse)
    for c, p, ref in zip(out, pinned, refs):
        assert torch.equal(c.data, p.data)
        assert np.abs(c.data.numpy() - ref).max() < TOL
        if rep["fused"]:
            assert c.last_plan.n_requests == 4
        else:
            assert isinstance(c.last_plan, MultiplyPlan)
    # the fused dispatch, pinned, equals the looped one bitwise at
    # pipeline_depth 1 on the blocked path
    kw = dict(algorithm="cannon", densify=False, pipeline_depth=1)
    fused = dbcsr.multiply_batched(reqs, mesh=mesh22, fused=True, **kw)
    looped = dbcsr.multiply_batched(reqs, mesh=mesh22, fused=False, **kw)
    assert all(torch.equal(x.data, y.data) for x, y in zip(fused, looped))


def test_batched_auto_is_bitwise_its_pinned_plan(mesh22):
    reqs, _ = _requests(mesh22, 3, np.random.RandomState(7), 0.5)
    a = torch.stack([x.data for x, _ in reqs])
    b = torch.stack([y.data for _, y in reqs])
    kw = dict(mesh=mesh22, block_m=BS, block_k=BS, block_n=BS,
              a_masks=[x.block_mask for x, _ in reqs])
    c, plan = distributed_matmul_batched(a, b, return_plan=True, **kw)
    assert plan.padding_frac >= 0.0 and plan.per_request.occupancy > 0.0
    pinned = distributed_matmul_batched(a, b, algorithm=plan.algorithm,
                                        densify=plan.densify, **kw)
    assert torch.equal(c, pinned)
    if not plan.densify:
        assert plan.executor_stats["n_groups"] == 3


def test_multiply_service_defaults_to_the_planner(mesh22):
    reqs, refs = _requests(mesh22, 4, np.random.RandomState(8))
    svc = MultiplyService(mesh22, max_batch=4, slo_s=60.0)
    tickets = [svc.submit(a, b) for a, b in reqs]
    assert sorted(svc.poll()) == tickets
    (bucket,) = svc.stats()["buckets"]
    plan = bucket["report"]["buckets"][0]["plan"]
    assert plan.fuse == bucket["fused"] and bucket["stage"] == "fused"
    want = dbcsr.multiply_batched(reqs, mesh=mesh22, fused=plan.fuse)
    for t, w, ref in zip(tickets, want, refs):
        got = svc.result(t)
        assert torch.equal(got.data, w.data)
        assert np.abs(got.data.numpy() - ref).max() < TOL
    st = svc.stats()
    assert st["n_error_tickets"] == 0 and st["n_degradations"] == 0


def _hot():
    nb = 8
    m = np.zeros((nb, nb), dtype=bool)
    m[:2, :] = m[:, :2] = True
    np.fill_diagonal(m, True)
    return m


@pytest.mark.parametrize("armed", [False, True])
def test_rebalance_none_follows_the_plan(mesh22, armed):
    """On the hot-corner mask, ``rebalance=None`` permutes exactly when
    the plan's costed decision says so; under constants that make the
    pass free and the kernel slow the plan arms it."""
    if armed:
        calibrate.save_calibration({"dispatch_s": 0.0,
                                    "densify_bytes_per_s": 1e30,
                                    "smm_flops_per_s": 1e3})
    hot = _hot()
    bs = 8
    rng = np.random.RandomState(9)
    a = rng.randn(64, 64).astype(np.float32) \
        * np.repeat(np.repeat(hot, bs, 0), bs, 1)
    b = rng.randn(64, 64).astype(np.float32) \
        * np.repeat(np.repeat(hot, bs, 0), bs, 1)
    kw = dict(mesh=mesh22, grid=GridSpec("data", "model"),
              algorithm="summa", densify=False, block_m=bs, block_k=bs,
              block_n=bs, a_mask=hot, b_mask=hot)
    ta, tb = torch.tensor(a), torch.tensor(b)
    c, plan = distributed_matmul(ta, tb, return_plan=True, **kw)
    assert plan.rank_imbalance > 1.0
    assert plan.rebalance is armed
    assert plan.executor_stats["rebalance_applied"] is armed
    # SUMMA's K order does not depend on the rank: bitwise either way
    plain = distributed_matmul(ta, tb, rebalance=False, **kw)
    assert torch.equal(c, plain)
    np.testing.assert_allclose(c.numpy(), a @ b, rtol=1e-5, atol=1e-4)


def test_local_kernel_pallas_on_a_blocked_plan():
    """A caller who asks for the hand-written kernels does not know which
    local path the planner picks: on the blocked path ``"pallas"`` runs
    the smm kernel in the port.  The JAX package raises there (ROADMAP
    Queue C), so auto with ``local_kernel="pallas"`` fails in it whenever
    its plan is blocked."""
    import jax.numpy as jnp

    from repro.core.multiply import distributed_matmul as jmatmul
    from repro.launch.mesh import make_mesh as jax_make_mesh

    a, b, am, bm = _operands(0.2, seed=10)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    kw = dict(block_m=BS, block_k=BS, block_n=BS, a_mask=am, b_mask=bm,
              algorithm="cannon", densify=False)
    got = distributed_matmul(torch.tensor(a), torch.tensor(b), mesh=mesh,
                             local_kernel="pallas", **kw)
    assert torch.equal(got, distributed_matmul(
        torch.tensor(a), torch.tensor(b), mesh=mesh, **kw))
    with pytest.raises(ValueError, match="unknown stack kernel"):
        jmatmul(jnp.asarray(a), jnp.asarray(b),
                mesh=jax_make_mesh((1, 1), ("data", "model")),
                local_kernel="pallas", **kw)


@pytest.mark.parametrize("eps", [None, 0.0, "median"])
def test_planned_occupancy_is_the_retained_fraction(mesh22, eps):
    """On several ranks the occupancy comes from the per-block weights the
    imbalance is computed from, on one rank from ``_global_occupancy``:
    the same retained-triple fraction either way."""
    from repro_torch.core.multiply import _global_occupancy
    from repro_torch.sparsity.norms import block_norms_of

    a, b, am, bm = _operands(0.5, seed=11)
    ta, tb = torch.tensor(a), torch.tensor(b)
    an, bn = block_norms_of(ta, BS, BS, am), block_norms_of(tb, BS, BS, bm)
    if eps == "median":
        prods = (an[:, :, None].astype(np.float64) * bn[None])[
            am[:, :, None] & bm[None]]
        eps = float(np.median(prods))
    want = _global_occupancy(M, K, N, BS, BS, BS, am, bm, an, bn, eps)
    assert 0.0 < want < 1.0
    for mesh in (mesh22, make_mesh((1, 1), ("data", "model"), device="cpu")):
        _, plan = distributed_matmul(
            ta, tb, mesh=mesh, block_m=BS, block_k=BS, block_n=BS,
            a_mask=am, b_mask=bm, a_norms=an, b_norms=bn, filter_eps=eps,
            algorithm="cannon", densify=False, return_plan=True)
        assert plan.occupancy == round(want, 9)


@pytest.mark.parametrize("eps", [None, 0.0, -1.0, 0.3])
@pytest.mark.parametrize("norms", ["plain", "negative", "nan"])
def test_retained_counts_equal_the_presence_tensor(eps, norms):
    """The planner's inputs skip the (nbr, nbk, nbc) presence tensor
    (mask products for eps <= 0 with norms >= 0, k-chunks otherwise);
    they must count exactly the triples it holds."""
    from repro_torch.core.engine import _mask_fill
    from repro_torch.sparsity.balance import retained_block_weights
    from repro_torch.sparsity.filter import retained_pair_presence

    rng = np.random.RandomState(12)
    am, bm = rng.rand(9, 70) < 0.4, rng.rand(70, 11) < 0.6
    an = rng.rand(9, 70).astype(np.float32)
    bn = rng.rand(70, 11).astype(np.float32)
    if norms == "negative":
        an[0, :5] = -1.0
    elif norms == "nan":
        bn[3, 2] = np.nan
    pres = retained_pair_presence(am, bm, an, bn, eps)
    np.testing.assert_array_equal(
        retained_block_weights(am, bm, an, bn, eps), pres.sum(axis=1))
    if norms == "plain":
        assert _mask_fill(9, 70, 11, am, bm, None, an, bn, None, eps) \
            == pres.sum() / pres.size


@pytest.mark.parametrize("eps", [None, 0.0, -1.0, 0.3])
@pytest.mark.parametrize("norms", ["plain", "negative", "nan"])
def test_retained_weights_in_k_chunks_equal_the_presence_tensor(
        eps, norms, monkeypatch):
    """``retained_block_weights`` counts exactly the presence tensor's
    triples when its k-chunk is smaller than the k extent too."""
    from repro_torch.sparsity import balance
    from repro_torch.sparsity.filter import retained_pair_presence

    rng = np.random.RandomState(13)
    am, bm = rng.rand(9, 70) < 0.4, rng.rand(70, 11) < 0.6
    an = rng.rand(9, 70).astype(np.float32)
    bn = rng.rand(70, 11).astype(np.float32)
    if norms == "negative":
        an[0, :5] = -1.0
    elif norms == "nan":
        bn[3, 2] = np.nan
    pres = retained_pair_presence(am, bm, an, bn, eps)
    monkeypatch.setattr(balance, "_CHUNK_ELEMS", 9 * 11 * 16)
    got = balance.retained_block_weights(am, bm, an, bn, eps)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, pres.sum(axis=1))
