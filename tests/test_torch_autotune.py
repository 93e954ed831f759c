"""The port's smm sweep (``repro_torch.kernels.smm.autotune``) against the
JAX package's, and the H100 winners table in the repository.

On the CPU ``tune_block(..., device="cpu")`` runs the executor's plain
version; the rows' plan statistics (``stack_tile``, ``n_stacks``,
``n_entries``) must equal the JAX package's oracle sweep
(``use_kernel=False``) for the same block, grid and occupancy bin, since
both build their plans from the same draws.  The times are the CPU's and
are not compared.  The CLI needs a card; its table handling is checked
here with ``torch.cuda.is_available`` patched and the sweep sent to the
CPU.  The module takes ~20 s, most of it the JAX package's sweeps.
"""
import json
import os

import pytest
import torch

from repro.kernels.smm import autotune as jax_autotune
from repro_torch.kernels.smm import autotune

from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE = os.path.join(REPO, "artifacts", "smm_autotune_h100.json")

# (block, blocks a side)
GRIDS = [(8, 4), (8, 6), (22, 4), (22, 6)]


def _stats(rows):
    return [(r["stack_tile"], r["n_stacks"], r["n_entries"]) for r in rows]


@pytest.mark.parametrize("fill", autotune.FILL_BINS)
@pytest.mark.parametrize("block,n_blocks", GRIDS)
def test_rows_match_the_jax_sweep(block, n_blocks, fill):
    got = autotune.tune_block(block, n_blocks=n_blocks, fill=fill,
                              device="cpu")
    want = jax_autotune.tune_block(block, n_blocks=n_blocks, fill=fill,
                                   use_kernel=False)
    assert _stats(got["rows"]) == _stats(want["rows"])
    assert [(r["align"], r["stack_tile"]) for r in got["rows"]] == \
        autotune.SPACE
    assert got["device"] == "cpu" and got["fill"] == fill
    assert got["best"] in got["rows"]
    for r in got["rows"]:
        assert r["time_s"] > 0
        assert r["gflops"] == pytest.approx(
            r["n_entries"] * 2 * block ** 3 / r["time_s"] / 1e9)


@pytest.mark.parametrize("fill", [1.0, 0.5])
def test_the_1024_tile_cuts_a_larger_plan(fill):
    """At 12 blocks a side the dense plan holds 1,728 triples, which the
    1,024 tile cuts into two stacks (half of them fit in one), as the
    JAX package's does."""
    got = autotune.tune_block(8, n_blocks=12, fill=fill, device="cpu")
    want = jax_autotune.tune_block(8, n_blocks=12, fill=fill,
                                   use_kernel=False)
    assert _stats(got["rows"]) == _stats(want["rows"])
    assert got["rows"][0]["n_stacks"] == (2 if fill == 1.0 else 1)


def test_bench_times_a_cpu_call():
    calls = []
    dt = autotune._bench(lambda x: calls.append(x), torch.zeros(1), reps=4)
    assert len(calls) == 5 and dt >= 0


def test_the_cli_refuses_to_sweep_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        autotune.main(["--cache", str(tmp_path / "t.json")])
    assert not (tmp_path / "t.json").exists()


def test_the_cli_writes_and_merges_a_table(tmp_path, monkeypatch, capsys):
    """``main`` with the sweep sent to the CPU: the table it writes is what
    the lookups read, and a second call merges its keys into it."""
    sweep = autotune.tune_block
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(autotune, "tune_block",
                        lambda block, **kw: sweep(block, device="cpu", **kw))
    path = str(tmp_path / "sub" / "table.json")
    autotune.main(["--blocks", "8", "--fills", "1.0", "0.2", "--n-blocks",
                   "4", "--cache", path])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("block   8 fill    1: best align=False")
    assert lines[1].startswith("block   8 fill  0.2: best align=False")
    assert lines[-1] == f"cached -> {path}"
    table = autotune.load_cache(path)
    assert sorted(table) == ["8", "8@0.2"]
    best = table["8@0.2"]["best"]
    assert autotune.best_params(8, path, fill=0.2) == \
        (False, best["stack_tile"])
    meta = autotune.best_params_meta(8, 8, 8, path, fill=0.25)
    assert meta["source"] == "winners[8@0.2]"
    assert meta["gflops"] == best["gflops"]
    # an unswept bin falls back to the dense entry
    meta = autotune.best_params_meta(8, 8, 8, path, fill=0.05)
    assert meta["source"] == "winners[8]"
    assert autotune.has_winners(8, 8, 8, path)
    assert not autotune.has_winners(22, 22, 22, path)

    autotune.main(["--blocks", "22", "--fills", "0.05", "--n-blocks", "4",
                   "--cache", path])
    merged = autotune.load_cache(path)
    assert sorted(merged) == ["22@0.05", "8", "8@0.2"]
    assert merged["8"] == table["8"]
    assert autotune.has_winners(22, 22, 22, path)
    # DEFAULT_CACHE resolves at call time
    monkeypatch.setattr(autotune, "DEFAULT_CACHE", path)
    assert autotune.load_cache() == merged
    assert autotune.best_params_meta(22, 22, 22, fill=0.05)["source"] == \
        "winners[22@0.05]"


def test_a_nonuniform_geometry_takes_the_nonuniform_heuristic(tmp_path):
    """The JAX package's provenance for a geometry no table entry covers."""
    path = str(tmp_path / "none.json")
    meta = autotune.best_params_meta(16, 128, 16, path)
    want = jax_autotune.best_params_meta(16, 128, 16, path)
    assert meta["source"] == want["source"] == "heuristic-nonuniform"
    assert meta["stack_tile"] == want["stack_tile"] == 30000
    assert autotune.best_params_meta(99, 99, 99, path)["source"] == \
        "heuristic"


def test_the_committed_h100_table():
    """``artifacts/smm_autotune_h100.json``: written by the CLI on an H100
    at blocks 22 (180 blocks a side) and 64 (64) over the four bins; each
    entry names the card and its power limit, and its winner is a row of
    SPACE."""
    with open(TABLE) as f:
        table = json.load(f)
    keys = [autotune._cache_key(b, f) for b in (22, 64)
            for f in autotune.FILL_BINS]
    assert sorted(table) == sorted(keys)
    grid = {22: 180, 64: 64}
    for key, entry in table.items():
        block = entry["block"]
        assert key == autotune._cache_key(block, entry["fill"])
        name, limit = (p.strip() for p in entry["device"].split(","))
        assert "H100" in name and limit.endswith(" W")
        assert float(limit[:-2]) > 0
        best = entry["best"]
        assert (best["align"], best["stack_tile"]) in autotune.SPACE
        assert best in entry["rows"]
        assert _stats(entry["rows"])[0][0] == 1024
        # each present A block meets every B block of its row of k
        n_true = max(1, round(entry["fill"] * grid[block] ** 2))
        for r in entry["rows"]:
            assert r["n_entries"] == n_true * grid[block]
            assert r["gflops"] > 0
