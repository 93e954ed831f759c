"""CPU tests of what decides ``correct``: a sound run passes; the control
(the plain reference computed in TF32 in the program's place: on the
CPU every ``precision=`` of the port is IEEE f32) and each
fault a cell can have, planted under the timed path, fail.  Every cell
of ``BENCHMARK.json`` runs here at a few blocks a side, on the CPU
(where the port's kernels run their plain versions), the process mesh
over gloo; the harness's look for a card is the only part left out."""
import json

import pytest
import torch

from bench import harness
from bench.conftest import ROOT, add_cell, copy_bench, shrink

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
ONE = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]
PRODUCT_FAULTS = ("answer_altered", "half_dropped", "state_unchanged")
SECONDS = 0.05
TF32 = {"reference": "tf32"}


def runs_of(cell: str, root, runs: list) -> list:
    """The result line of each run of ``runs`` (one set-up; one spawn on
    a process mesh, over gloo on the CPU)."""
    spec = harness.cell_spec(cell, root)
    full = [dict({"seed": 11, "seconds": SECONDS, "trace": False}, **r)
            for r in runs]
    ranks = harness.run_ranks_of(spec, full, "cpu", "gloo")
    return [harness.result(spec, [r[i] for r in ranks], run["trace"],
                           harness.process_start_wall(), run["seed"])
            for i, run in enumerate(full)]


def verdicts(outs: list) -> list:
    return [o["correct"] for o in outs]


@pytest.mark.parametrize("cell", ONE)
def test_sound_run_control_and_faults_on_one_card(cell, tiny_root):
    runs = ([{}, {"trace": True}, {"control": TF32}]
            + [{"fault": f} for f in PRODUCT_FAULTS])
    outs = runs_of(cell, tiny_root, runs)
    assert verdicts(outs) == [True, True] + [False] * 4, [
        o["checks"] for o in outs]
    sound = outs[0]
    assert sound["failed"] == 0 and sound["attempted"] >= 1
    assert list(sound)[-1] == "checks"
    assert set(sound["metrics"]) == {m["name"] for m in BENCH["end_to_end"]
                                     if cell in m.get("workloads", [cell])}
    # the control is read by the one number that separates it
    assert outs[2]["checks"]["rel_err"]["value"] > outs[2]["checks"][
        "rel_err"]["limit"]
    assert outs[2]["checks"]["mask_mismatch"]["value"] == 0
    for o in outs[3:]:
        assert o["failed"] >= 1


def test_sound_run_control_and_faults_on_a_process_mesh(tmp_path,
                                                        monkeypatch):
    """The 2x2 Cannon cell over a process mesh (``paper_square_b22_2x2``
    with ``cannon.json``), added to a copy of the benchmark by entries
    alone as a later change would add it."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    root = shrink(copy_bench(tmp_path))
    add_cell(root, "square_b22_2x2.cannon", "paper_square_b22_2x2",
             "cannon", 4)
    runs = ([{}, {"control": TF32}, {"trace": True}]
            + [{"fault": f} for f in PRODUCT_FAULTS + ("exchange_dropped",)])
    outs = runs_of("square_b22_2x2.cannon", root, runs)
    assert verdicts(outs) == [True, False, True] + [False] * 4, [
        o["checks"] for o in outs]
    assert outs[0]["device"]["count"] == 4
    # rank 0 received the shifts of A and B: one 88^2 block of each
    assert outs[2]["metrics"]["recv_mb"]["value"] == 2 * 88 * 88 * 4 / 1e6


@pytest.mark.cuda
def test_the_program_s_own_tf32_path_fails_on_the_card():
    """The control of a densified cell is the program with its TF32 path
    switched on (``precision="high"``); on the CPU every precision is
    IEEE f32, so only the card can show it.  At the cells' own sizes: at
    a few blocks a side the planner takes the blocked path, which has no
    TF32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: on the CPU precision='high' is IEEE")
    cells = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1
             and "kwargs" in harness.cell_spec(w["name"], ROOT)["traffic"]
             .get("control", {})]
    for cell in cells:
        spec = harness.cell_spec(cell, ROOT)
        ranks = harness.run_ranks_of(spec, [
            {"seed": 3, "seconds": SECONDS, "control": c} for c in (False,
                                                                   True)])
        outs = [harness.result(spec, [r[i] for r in ranks], False, 0.0, 3)
                for i in range(2)]
        assert verdicts(outs) == [True, False], cell
