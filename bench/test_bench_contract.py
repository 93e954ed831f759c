"""CPU tests of the benchmark's definition: ``BENCHMARK.json`` against the
rules it is written to, the frozen work counts, the plain reference, the
operands drawn from the seed, the modules a run loads, and a cell added
by new files alone."""
import hashlib
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import harness, reference, work
from bench.conftest import ROOT, copy_bench, shrink

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_benchmark_json_has_the_contract_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    n = len(BENCH["workloads"])
    assert 1 <= n <= 24 and 1 <= len(BENCH["configs"]) <= 24
    # a full check of 24 cells fits its clock at this run length
    assert 2 + 14 * 24 <= 43200 and (
        (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200
        <= 43200)
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, n // 4)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries_follow_the_rules():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("bench/")
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    all_names = ([m["name"] for m in metrics] + names
                 + [w["name"] for w in BENCH["workloads"]])
    assert len(set(all_names)) == len(all_names)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        spec = harness.cell_spec(w["name"], ROOT)
        e2e = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec["per_layer"]
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert harness.reader(ROOT, m["name"]).UNIT == m["unit"]


def test_config_files_state_what_they_run():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert cfg["block"] == cfg["deployment"]["block"] == 22
        for key in ("m", "k", "n", "grid"):
            assert (cfg[key] != cfg["deployment"][key]) == (
                key in c["reduced"])
        for key in ("m", "k", "n"):
            assert cfg[key] % cfg["block"] == 0
        ranks = math.prod(cfg["grid"])
        chips = {w["chips"] for w in BENCH["workloads"]
                 if w["config"] == c["name"]}
        assert chips == {ranks}
        assert set(cfg["limits"]) == {"rel_err", "mask_mismatch"}


def test_the_frozen_work_counts_give_the_hand_worked_numbers():
    assert work.multiply_flops(3960, 3960, 3960, 22) == 2 * 3960 ** 3
    assert f"{work.multiply_flops(3960, 3960, 3960, 22):.3e}" == "1.242e+11"
    assert f"{work.multiply_flops(1408, 123904, 1408, 22):.3e}" == "4.913e+11"
    # 2 * 7,920^3 = 9.9359e11 (9.935e11 cut to four figures)
    assert work.multiply_flops(7920, 7920, 7920, 22) == 993_586_176_000
    assert round(1408 * 123904 * 4 / 1e6) == 698
    assert work.multiply_bytes(1408, 123904, 1408, 22) == 4 * (
        2 * 1408 * 123904 + 1408 ** 2)
    # the square case is bound by its FLOPs: 1.854 ms at 67 TFLOP/s
    b = work.bound_s(work.multiply_flops(3960, 3960, 3960, 22),
                     work.multiply_bytes(3960, 3960, 3960, 22))
    assert abs(b - 1.8536e-3) < 1e-6
    # a masked product counts its retained triples only
    am = np.zeros((3, 2), bool)
    am[0, 0] = am[2, 1] = True
    assert work.block_counts(66, 44, 22, 22, am, None) == (2, 2, 2, 2)
    assert work.multiply_flops(66, 44, 22, 22, am) == 2 * 2 * 22 ** 3


def test_the_reference_matches_float64_numpy():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((70, 90)).astype(np.float32)
    b = rng.standard_normal((90, 50)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = reference.product_f64(torch.from_numpy(a), torch.from_numpy(b),
                                rows=16)
    assert np.allclose(got.numpy(), want, rtol=0, atol=1e-12)
    am = rng.random((7, 9)) < 0.5
    got = reference.masked(torch.from_numpy(a), am, 10).numpy()
    assert np.array_equal(got, a * np.kron(am, np.ones((10, 10))))
    bm = rng.random((9, 5)) < 0.5
    assert np.array_equal(reference.product_mask(am, bm, 7, 9, 5),
                          (am.astype(int) @ bm.astype(int)) > 0)
    assert reference.product_mask(None, None, 2, 3, 4).all()


def test_tf32_rounding_and_the_comparison():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -1.0 - 2 ** -11, 3.0e-5, -7.25], dtype=torch.float32)
    got = reference.round_tf32(x)
    # ties to even: 1 + 2^-11 -> 1, 1 + 3 * 2^-11 -> 1 + 2^-9
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9,
                         -1.0, float(got[5]), -7.25])
    assert torch.equal(got, want)
    assert abs(float(got[5]) - 3.0e-5) <= 3.0e-5 * 2 ** -11
    r = torch.randn(64, 64, dtype=torch.float32, generator=torch.Generator()
                    .manual_seed(1))
    assert float((reference.round_tf32(r) - r).abs().max()) <= float(
        r.abs().max()) * 2 ** -11
    ref = torch.ones(44, 44, dtype=torch.float64)
    c = ref.to(torch.float32).clone()
    ok = reference.compare(c, None, ref, np.ones((2, 2), bool), rows=8)
    assert ok == {"rel_err": 0.0, "mask_mismatch": 0.0}
    c[3, 40] = float("nan")
    bad = reference.compare(c, np.eye(2, dtype=bool), ref,
                            np.ones((2, 2), bool))
    assert bad == {"rel_err": float("inf"), "mask_mismatch": 2.0}
    assert reference.compare(c[:22], None, ref, np.ones((2, 2), bool))[
        "rel_err"] == float("inf")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_operands_are_reproducible_from_the_seed(cell, tiny_root):
    spec = harness.cell_spec(cell, tiny_root)
    seed = 2 ** 33 + 12345        # more than 32 signed bits hold
    a1, b1 = harness.operands(spec["config"], seed, "cpu")
    a2, b2 = harness.operands(spec["config"], seed, "cpu")
    a3, _ = harness.operands(spec["config"], seed + 1, "cpu")
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    assert not torch.equal(a1, a3)
    assert a1.dtype == torch.float32
    assert a1.shape == (spec["config"]["m"], spec["config"]["k"])
    traffic = dict(spec["traffic"], a_fill=0.3)
    m1 = harness.masks(spec["config"], traffic, seed)
    m2 = harness.masks(spec["config"], traffic, seed)
    assert np.array_equal(m1[0], m2[0]) and m1[1] is None


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    """A process that loads the harness and the port and runs a cell has
    no module whose top-level name is jax, jaxlib, flax or repro."""
    root = shrink(copy_bench(tmp_path))
    code = (
        "import sys, json\n"
        "from bench import harness, control, faults, reference, tracing\n"
        "import repro_torch, repro_torch.core.dbcsr\n"
        "import repro_torch.launch.processes\n"
        f"out, banned = harness.run_cell('square_b22.blocked', 7, 0.05, True,"
        f" device='cpu', root={str(root)!r})\n"
        "print(json.dumps([out['correct'], banned, harness.banned_modules(),"
        " sorted({m.split('.')[0] for m in sys.modules})]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, banned, again, tops = json.loads(out.stdout.strip()
                                              .splitlines()[-1])
    assert correct and banned == [] and again == []
    assert "repro_torch" in tops
    assert not {"jax", "jaxlib", "flax", "repro"} & set(tops)


def test_harness_sources_import_neither_the_port_at_top_nor_jax():
    """The yardstick (work counts, reference, tracing, metric readers)
    imports nothing of the port, and nothing under bench/ names the JAX
    package or the old benchmarks."""
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|repro|benchmarks)"
                     r"(\.|\s|$)", re.M)
    for path in (ROOT / "bench").rglob("*.py"):
        assert not pat.search(path.read_text()), path
    for name in ("work.py", "reference.py", "tracing.py"):
        assert "repro_torch" not in (ROOT / "bench" / name).read_text()
    for path in (ROOT / "bench" / "metrics").glob("*.py"):
        assert "repro_torch" not in path.read_text(), path


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted((root / "bench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    root = shrink(copy_bench(tmp_path))
    before = _digest(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "bench/configs/paper_square_b22.json")
                     .read_text())
    cfg["name"] = "added_b22"
    (root / "bench/configs/added_b22.json").write_text(json.dumps(cfg))
    (root / "bench/traffic/half_fill.json").write_text(json.dumps(
        {"kwargs": {"densify": False}, "a_fill": 0.5,
         "control": {"reference": "tf32"}}))
    (root / "bench/metrics/calls_seen.py").write_text(
        'UNIT = "1"\n\ndef read(ctx):\n    return float(ctx["calls"])\n')
    bench["configs"].append({"name": "added_b22", "source": "x",
                             "file": "bench/configs/added_b22.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "added.half", "config": "added_b22",
                               "traffic": "half_fill", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "calls_seen", "unit": "1",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["added.half"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    # (the test process may hold other tests' modules: the subprocess
    # test above is the one that reads ``banned``)
    out, _ = harness.run_cell("added.half", 5, 0.05, False, device="cpu",
                              root=root)
    assert out["correct"]
    assert out["metrics"]["calls_seen"]["value"] == out["attempted"] >= 1
    assert set(out["metrics"]) == {
        m["name"] for m in bench["end_to_end"]
        if "added.half" in m.get("workloads", ["added.half"])}
    assert {"multiply_ms", "setup_s", "calls_seen"} <= set(out["metrics"])
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(set(after) - set(before)) == [
        "bench/configs/added_b22.json", "bench/metrics/calls_seen.py",
        "bench/traffic/half_fill.json"]
    # an existing cell does not report the added metric
    out, _ = harness.run_cell("square_b22.auto", 5, 0.05, False,
                              device="cpu", root=root)
    assert "calls_seen" not in out["metrics"]
