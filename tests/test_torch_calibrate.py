"""The planner's bench-fed calibration of the port
(``repro_torch.planner.calibrate``: ``fit_from_artifacts``,
``DEFAULT_BENCH_DIR``, the three-source ``get_hardware_model``) against
the JAX package's, on the CPU.

Bench directories are written in the JAX benches' schemas
(``benchmarks/bench_kernels.py`` ``kernels.json``, ``bench_densify.py``
``densify.json``, ``bench_sparse.py`` ``sparse.json`` /
``sparse_smoke.json``), their values drawn from a numpy seed (and by
hypothesis over row counts and values).  Both packages' fits must give
equal dicts, each value the same float64 bit for bit: the fit is
host-side numpy in the same order of operations.

Where a sparse file comes without an smm rate, the fit's flop term takes
the package's own ``DEFAULT_HARDWARE.smm_flops_per_s`` (the JAX
package's is a CPU value, the port's an H100 one), so the comparison
runs with the reference's module default set to the port's rate, and
one test holds each package to its own default.  Likewise the merged
``HardwareModel``s are equal on the fitted keys only: every other key
is its own package's default.

Every test runs in an empty working directory.
"""
import json
import math
import os
import struct
import tempfile

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.planner import calibrate as jcal
from repro.planner import cost_model as jcm

from repro_torch.planner import calibrate
from repro_torch.planner.cost_model import DEFAULT_HARDWARE
from repro_torch.planner.plan import plan_cache_clear, plan_multiply

from torch_threads import one_thread  # noqa: F401

FITTED = ("flops_per_s", "smm_flops_per_s", "stack_entry_s")


@pytest.fixture(autouse=True)
def _empty_cwd(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    calibrate.invalidate_cache()
    jcal.invalidate_cache()
    plan_cache_clear()
    yield
    calibrate.invalidate_cache()
    jcal.invalidate_cache()
    plan_cache_clear()


@pytest.fixture
def ref_smm_default(monkeypatch):
    """The reference's fallback smm rate set to the port's (the only
    default the fit reads)."""
    monkeypatch.setattr(jcal, "DEFAULT_HARDWARE", jcm.DEFAULT_HARDWARE.replace(
        smm_flops_per_s=DEFAULT_HARDWARE.smm_flops_per_s))


# ---------------------------------------------------------------------------
# bench artifacts in the JAX benches' schemas
# ---------------------------------------------------------------------------


def _write(d, name, obj):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, name), "w") as f:
        json.dump(obj, f, indent=1)


def _read(d, name):
    with open(os.path.join(d, name)) as f:
        return json.load(f)


def kernels_rows(rng, n_smm=2, n_dense=1, fused=True):
    """bench_kernels.py:84 (smm_dispatch), :100 (dense_dot), :116."""
    rows = []
    for block in (22, 64, 16, 32)[:n_smm] + (8,) * max(n_smm - 4, 0):
        t_fused, t_looped = rng.uniform(1e-4, 1e-1, 2)
        flops = 2 * 704 ** 3
        row = {"kernel": "smm_dispatch", "block": block,
               "n_stacks": int(rng.randint(1, 64)),
               "stack_tile": int(rng.randint(64, 30000)),
               "t_fused_s": t_fused, "t_looped_s": t_looped,
               "looped_gflops": flops / t_looped / 1e9,
               "looped_over_fused": t_looped / t_fused}
        if fused:
            row["fused_gflops"] = flops / t_fused / 1e9
        rows.append(row)
    for _ in range(n_dense):
        dt = float(rng.uniform(1e-5, 1e-1))
        rows.append({"kernel": "dense_dot", "time_s": dt,
                     "gflops": 2 * 1024 ** 3 / dt / 1e9})
    dt = float(rng.uniform(1e-4, 1.0))
    rows.append({"kernel": "grouped_gemm_ref", "time_s": dt,
                 "gflops": 2 * 16 * 256 * 512 * 1024 / dt / 1e9})
    return rows


def densify_rows(rng, n=4):
    """bench_densify.py:61 (one record a case), :89 (the file)."""
    shapes = [(704, 704, 704, 22), (704, 704, 704, 64),
              (352, 14080, 352, 22), (384, 16384, 384, 64)]
    rows = []
    for i in range(n):
        m, k, nn, block = shapes[i % len(shapes)]
        t_b, t_loop, t_d = rng.uniform(1e-4, 1.0, 3)
        rows.append({"case": "square" if i % 4 < 2 else "rectangular",
                     "m": m, "k": k, "n": nn, "block": block,
                     "t_blocked_s": t_b, "t_blocked_looped_s": t_loop,
                     "t_densified_s": t_d, "ratio": t_b / t_d,
                     "dispatch_speedup": t_loop / t_b,
                     "n_stacks": int(rng.randint(1, 100)),
                     "n_stack_entries": int(rng.randint(1, 10 ** 6)),
                     "stack_fill": float(rng.uniform(0, 1)),
                     "max_err": float(rng.uniform(0, 1e-5))})
    return rows


def sparse_result(rng, n_rows=5, block=16, n_blocks=16, slope=None,
                  equal=False, with_block=True):
    """bench_sparse.py:117-120 (a row a fill), :357 / :374 (the file).
    ``slope`` (seconds a triple) draws times on a line with noise."""
    fills = [1.0, 0.5, 0.2, 0.1, 0.05, 0.02, 0.01][:n_rows]
    fills += list(rng.uniform(0.001, 1.0, max(n_rows - 7, 0)))
    dense = n_blocks ** 3
    rows = []
    for fill in fills:
        nt = dense if equal else max(1, int(round(fill * dense)))
        t_sparse = (float(rng.uniform(1e-4, 1e-2)) if slope is None else
                    1e-4 + slope * nt * float(rng.uniform(0.9, 1.1)))
        t_dense = float(rng.uniform(1e-4, 1e-2))
        rows.append({"fill": fill, "n_dense_triples": dense,
                     "n_triples": nt, "occupancy": nt / dense,
                     "n_stacks": int(rng.randint(1, 64)),
                     "t_sparse_s": t_sparse, "t_dense_s": t_dense,
                     "dense_over_sparse": t_dense / t_sparse})
    out = {"n_blocks": n_blocks, "stack_size": 512, "rows": rows,
           "bin_sweep": [], "bin_padding_monotone": True,
           "monotonic_dispatch_time": True}
    if with_block:
        out = {"block": block, **out}
    return out


def _case_empty(d, rng):
    os.makedirs(d, exist_ok=True)


def _case_kernels_only(d, rng):
    _write(d, "kernels.json", kernels_rows(rng, n_smm=2, n_dense=2))


def _case_kernels_without_fused(d, rng):
    _write(d, "kernels.json", kernels_rows(rng, fused=False))
    _write(d, "sparse.json", sparse_result(rng, slope=5e-8))


def _case_densify_only(d, rng):
    _write(d, "densify.json", densify_rows(rng))


def _case_densify_and_kernels(d, rng):
    # the densified rate below the dense GEMM's: the min keeps it
    _write(d, "kernels.json", kernels_rows(rng))
    rows = densify_rows(rng)
    for r in rows:
        r["t_densified_s"] *= 1e3
    _write(d, "densify.json", rows)


def _case_densify_above_kernels(d, rng):
    rows = kernels_rows(rng)
    for r in rows:
        if r["kernel"] == "dense_dot":
            r["gflops"] *= 1e-6
    _write(d, "kernels.json", rows)
    _write(d, "densify.json", densify_rows(rng))


def _case_sparse_beside_smoke(d, rng):
    _write(d, "kernels.json", kernels_rows(rng))
    _write(d, "sparse.json", sparse_result(rng, slope=3e-8))
    _write(d, "sparse_smoke.json", sparse_result(rng, slope=9e-8, block=8,
                                                 n_blocks=8))


def _case_smoke_only(d, rng):
    _write(d, "kernels.json", kernels_rows(rng))
    _write(d, "sparse_smoke.json", sparse_result(rng, n_rows=7, slope=9e-8,
                                                 block=8, n_blocks=8))


def _case_one_sparse_row(d, rng):
    _write(d, "kernels.json", kernels_rows(rng))
    _write(d, "sparse.json", sparse_result(rng, n_rows=1, slope=3e-8))


def _case_equal_triples(d, rng):
    _write(d, "kernels.json", kernels_rows(rng))
    _write(d, "sparse.json", sparse_result(rng, equal=True))


def _case_no_block(d, rng):
    _write(d, "kernels.json", kernels_rows(rng))
    _write(d, "sparse.json", sparse_result(rng, slope=4e-8,
                                           with_block=False))


def _case_clamp(d, rng):
    # a slope far below the flop term of a block-64 entry at 1 GF/s
    rows = kernels_rows(rng)
    for r in rows:
        if "fused_gflops" in r:
            r["fused_gflops"] = 1.0 + r["fused_gflops"] * 1e-9
    _write(d, "kernels.json", rows)
    _write(d, "sparse.json", sparse_result(rng, block=64, slope=1e-12))


def _case_malformed(d, rng):
    # an unreadable kernels.json and sparse.json: the smoke file stands in
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "kernels.json"), "w") as f:
        f.write('[{"kernel": "dense_dot", "gflops": 12')
    with open(os.path.join(d, "sparse.json"), "w") as f:
        f.write("{not json")
    _write(d, "densify.json", densify_rows(rng, n=2))
    _write(d, "sparse_smoke.json", sparse_result(rng, slope=2e-8))


CASES = {
    "empty": _case_empty,
    "kernels_only": _case_kernels_only,
    "kernels_without_fused_gflops": _case_kernels_without_fused,
    "densify_only": _case_densify_only,
    "densify_and_kernels_min": _case_densify_and_kernels,
    "densify_above_kernels": _case_densify_above_kernels,
    "sparse_beside_smoke": _case_sparse_beside_smoke,
    "smoke_only": _case_smoke_only,
    "one_sparse_row": _case_one_sparse_row,
    "equal_n_triples": _case_equal_triples,
    "no_top_level_block": _case_no_block,
    "slope_below_flop_term": _case_clamp,
    "malformed_json": _case_malformed,
}

# what each case's fit must hold (beside equality with the reference)
EXPECT_KEYS = {
    "empty": set(),
    "kernels_only": {"flops_per_s", "smm_flops_per_s"},
    "kernels_without_fused_gflops": {"flops_per_s", "stack_entry_s"},
    "densify_only": {"flops_per_s"},
    "densify_and_kernels_min": {"flops_per_s", "smm_flops_per_s"},
    "densify_above_kernels": {"flops_per_s", "smm_flops_per_s"},
    "sparse_beside_smoke": set(FITTED),
    "smoke_only": set(FITTED),
    "one_sparse_row": {"flops_per_s", "smm_flops_per_s"},
    "equal_n_triples": {"flops_per_s", "smm_flops_per_s"},
    "no_top_level_block": set(FITTED),
    "slope_below_flop_term": set(FITTED),
    "malformed_json": {"flops_per_s", "stack_entry_s"},
}


def bits(fit: dict) -> dict:
    """Each value as its float64 bytes (a -0.0 / NaN safe equality)."""
    assert all(type(v) is float for v in fit.values()), fit
    return {k: struct.pack("<d", v) for k, v in fit.items()}


def assert_same_fit(d):
    got = calibrate.fit_from_artifacts(d)
    want = jcal.fit_from_artifacts(d)
    assert bits(got) == bits(want), (got, want)
    return got


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_equals_the_reference_bit_for_bit(case, tmp_path,
                                              ref_smm_default):
    d = str(tmp_path / "bench")
    CASES[case](d, np.random.RandomState(sorted(CASES).index(case)))
    got = assert_same_fit(d)
    assert set(got) == EXPECT_KEYS[case], got
    if case == "densify_and_kernels_min":
        eff = max(2.0 * r["m"] * r["k"] * r["n"] / r["t_densified_s"]
                  for r in _read(d, "densify.json"))
        assert got["flops_per_s"] == eff
    if case == "densify_above_kernels":
        dense = [r["gflops"] for r in _read(d, "kernels.json")
                 if r["kernel"] == "dense_dot"]
        assert got["flops_per_s"] == max(dense) * 1e9
    if case == "slope_below_flop_term":
        assert got["stack_entry_s"] == 1e-8
    if case in ("sparse_beside_smoke", "no_top_level_block"):
        # sparse.json wins over the smoke file; a missing block is 8
        sp = _read(d, "sparse.json")
        nt = [r["n_triples"] for r in sp["rows"]]
        ts = [r["t_sparse_s"] for r in sp["rows"]]
        slope = float(np.polyfit(np.array(nt, float), np.array(ts, float),
                                 1)[0])
        block = sp.get("block", 8)
        assert got["stack_entry_s"] == max(
            slope - 2.0 * block ** 3 / got["smm_flops_per_s"], 1e-8)


def test_fit_without_an_smm_rate_takes_each_packages_default(tmp_path):
    """A sparse file with no smm rate: the flop term is each package's
    own ``DEFAULT_HARDWARE.smm_flops_per_s``; every other key equal."""
    d = str(tmp_path / "bench")
    rng = np.random.RandomState(7)
    _write(d, "densify.json", densify_rows(rng))
    _write(d, "sparse.json", sparse_result(rng, block=22, slope=2e-7))
    got = calibrate.fit_from_artifacts(d)
    want = jcal.fit_from_artifacts(d)
    assert set(got) == set(want) == {"flops_per_s", "stack_entry_s"}
    assert bits(got)["flops_per_s"] == bits(want)["flops_per_s"]
    sp = _read(d, "sparse.json")
    slope = float(np.polyfit(
        np.array([r["n_triples"] for r in sp["rows"]], float),
        np.array([r["t_sparse_s"] for r in sp["rows"]], float), 1)[0])
    for fit, hw in ((got, DEFAULT_HARDWARE), (want, jcm.DEFAULT_HARDWARE)):
        assert fit["stack_entry_s"] == max(
            slope - 2.0 * 22 ** 3 / hw.smm_flops_per_s, 1e-8)
    assert got["stack_entry_s"] != want["stack_entry_s"]


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
@given(seed=st.integers(0, 2 ** 31 - 1), n_smm=st.integers(0, 6),
       n_dense=st.integers(0, 3), fused=st.booleans(),
       n_densify=st.integers(0, 6), n_sparse=st.integers(0, 12),
       equal=st.booleans(), slope=st.one_of(
           st.none(), st.floats(1e-13, 1e-5)),
       block=st.sampled_from([None, 4, 8, 22, 64]),
       scale=st.floats(1e-6, 1e6))
def test_fit_equals_the_reference_over_drawn_artifacts(
        ref_smm_default, seed, n_smm, n_dense, fused, n_densify, n_sparse,
        equal, slope, block, scale):
    rng = np.random.RandomState(seed)
    with tempfile.TemporaryDirectory() as d:
        rows = kernels_rows(rng, n_smm=n_smm, n_dense=n_dense, fused=fused)
        for r in rows:
            for key in ("gflops", "fused_gflops"):
                if key in r:
                    r[key] *= scale
        _write(d, "kernels.json", rows)
        if n_densify:
            _write(d, "densify.json", densify_rows(rng, n=n_densify))
        if n_sparse:
            _write(d, "sparse.json", sparse_result(
                rng, n_rows=n_sparse, block=block or 8, slope=slope,
                equal=equal, with_block=block is not None))
        got = assert_same_fit(d)
        assert all(math.isfinite(v) and v > 0 for v in got.values()), got


# ---------------------------------------------------------------------------
# the three-source merge and its cache
# ---------------------------------------------------------------------------


def _full_bench(d, seed=3):
    rng = np.random.RandomState(seed)
    _write(d, "kernels.json", kernels_rows(rng))
    _write(d, "densify.json", densify_rows(rng))
    _write(d, "sparse.json", sparse_result(rng, block=22, slope=2e-7))


def test_merge_is_defaults_then_fit_then_file(tmp_path):
    d = str(tmp_path / "bench")
    _full_bench(d)
    fit = calibrate.fit_from_artifacts(d)
    assert set(fit) == set(FITTED)
    path = str(tmp_path / "cal.json")
    with open(path, "w") as f:
        json.dump({"flops_per_s": 1.25e13, "latency_s": 3e-6,
                   "not_a_constant": 1.0, "dispatch_s": "slow"}, f)
    got = calibrate.get_hardware_model(path, d).to_dict()
    want = jcal.get_hardware_model(path, d).to_dict()
    # the file over the fit, the fit over the defaults, on both sides
    for hw in (got, want):
        assert hw["flops_per_s"] == 1.25e13 and hw["latency_s"] == 3e-6
    for key in ("smm_flops_per_s", "stack_entry_s"):
        assert got[key] == want[key] == fit[key], key
    # elsewhere each package's own defaults (an H100's, a CPU's)
    for key, value in DEFAULT_HARDWARE.to_dict().items():
        if key not in FITTED + ("latency_s",):
            assert got[key] == value, key
            assert want[key] == jcm.DEFAULT_HARDWARE.to_dict()[key], key
    # the fit alone, no file
    alone = calibrate.get_hardware_model(str(tmp_path / "none.json"), d)
    assert alone == DEFAULT_HARDWARE.replace(**fit)


def test_cache_rule_is_the_references(tmp_path):
    """Cached only when neither ``path`` nor ``bench_dir`` is given; the
    same sequence of calls gives both packages the same fitted keys."""
    models = {}
    for name, mod, default in (("port", calibrate, DEFAULT_HARDWARE),
                               ("ref", jcal, jcm.DEFAULT_HARDWARE)):
        seen = [mod.get_hardware_model()]
        assert seen[0] == default
        _full_bench(mod.DEFAULT_BENCH_DIR)
        seen.append(mod.get_hardware_model())          # the cached model
        assert seen[-1] is seen[0]
        seen.append(mod.get_hardware_model(bench_dir=mod.DEFAULT_BENCH_DIR))
        assert seen[-1] != default                     # fitted, not cached
        assert mod.get_hardware_model() is seen[0]
        mod.invalidate_cache()
        seen.append(mod.get_hardware_model())          # fitted and cached
        assert seen[-1] == seen[2] and mod.get_hardware_model() is seen[-1]
        mod.save_calibration({"stack_entry_s": 2e-9})  # drops the cache
        seen.append(mod.get_hardware_model())
        assert seen[-1].stack_entry_s == 2e-9
        models[name] = seen
    for p, r in zip(models["port"][2:], models["ref"][2:]):
        for key in FITTED:
            assert getattr(p, key) == getattr(r, key), key


def test_the_jax_packages_bench_dir_is_never_read():
    """Benches of the JAX package (CPU rates) under ``artifacts/bench/``
    leave the port's model at its H100 defaults; the reference fits
    them."""
    _full_bench(jcal.DEFAULT_BENCH_DIR)
    assert calibrate.DEFAULT_BENCH_DIR == os.path.join("artifacts",
                                                       "bench_h100")
    assert calibrate.DEFAULT_BENCH_DIR != jcal.DEFAULT_BENCH_DIR
    assert calibrate.fit_from_artifacts() == {}
    assert calibrate.get_hardware_model() == DEFAULT_HARDWARE
    assert set(jcal.fit_from_artifacts()) == set(FITTED)
    plan_cache_clear()
    kw = dict(blocks=(22, 22, 22), occupancy=0.2)
    assert plan_multiply(3960, 3960, 3960, **kw) is plan_multiply(
        3960, 3960, 3960, hw=DEFAULT_HARDWARE, **kw)


def test_a_fitted_model_reprices_the_plans(tmp_path):
    """Plans read the fitted model through ``get_hardware_model``: a fit
    in the working directory's ``artifacts/bench_h100/`` changes the
    plan key and its prices."""
    kw = dict(blocks=(22, 22, 22), occupancy=0.2)
    before = plan_multiply(3960, 3960, 3960, **kw)
    _full_bench(calibrate.DEFAULT_BENCH_DIR)
    calibrate.invalidate_cache()
    hw = calibrate.get_hardware_model()
    assert hw == DEFAULT_HARDWARE.replace(**calibrate.fit_from_artifacts())
    after = plan_multiply(3960, 3960, 3960, **kw)
    assert after is not before
    assert after is plan_multiply(3960, 3960, 3960, hw=hw, **kw)


def test_describe_marks_each_constants_source():
    measured = {"flops_per_s": 4e13, "latency_s": 2e-6}
    fitted = {"flops_per_s": 3e13, "stack_entry_s": 1e-8}
    lines = {ln.split()[0]: ln.split() for ln in
             calibrate.describe(measured, None, fitted).splitlines()}
    assert set(lines) == set(DEFAULT_HARDWARE.to_dict())
    assert lines["flops_per_s"][1:3] == ["4e+13", "measured"]
    assert lines["latency_s"][2] == "measured"
    assert lines["stack_entry_s"][1:3] == ["1e-08", "fitted"]
    assert lines["smm_flops_per_s"][2] == "default"
    assert float(lines["smm_flops_per_s"][1]) == pytest.approx(
        DEFAULT_HARDWARE.smm_flops_per_s, rel=1e-5)


def test_cli_takes_a_bench_dir_and_still_measures_on_the_card_only(
        tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    d = str(tmp_path / "bench")
    _full_bench(d)
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate.main(["--bench-dir", d])
    assert not os.path.exists(calibrate.DEFAULT_CALIBRATION)
