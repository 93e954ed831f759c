"""Fixtures of the benchmark's CPU tests: one torch thread, and a copy of
the benchmark whose configurations are cut to a size the CPU holds in a
second (the block size, the dtype, the mesh and the limits kept)."""
import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

# a few blocks a side, and the mesh's ranks a few blocks each
TINY = {1: {"m": 132, "k": 110, "n": 88}, 4: {"m": 176, "k": 176, "n": 176}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def copy_bench(dest: Path) -> Path:
    """``BENCHMARK.json`` and ``bench/`` copied under ``dest``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dest


def shrink(root: Path) -> Path:
    """Every configuration of the copy at ``root`` cut to ``TINY``."""
    for path in (root / "bench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(TINY[cfg["grid"][0] * cfg["grid"][1]])
        path.write_text(json.dumps(cfg))
    return root


def add_cell(root: Path, cell: str, config: str, traffic: str, chips: int,
             layer=("comm_ms", "recv_mb")) -> None:
    """Cell ``cell`` of the files ``bench/configs/<config>.json`` and
    ``bench/traffic/<traffic>.json`` added to the copy's
    ``BENCHMARK.json``, with the per-layer metrics ``layer`` listing it
    (entries only: no file of the copy changes)."""
    path = root / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    bench["configs"].append({"name": config, "source": "x",
                             "file": f"bench/configs/{config}.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": cell, "config": config,
                               "traffic": traffic, "chips": chips,
                               "why": "a test"})
    for name in layer:
        unit = {"comm_ms": "ms", "recv_mb": "MB"}[name]
        bench["per_layer"].append({
            "name": name, "unit": unit, "better": "lower",
            "source": "device_trace", "layer": "process mesh",
            "moves": "multiply_ms", "workloads": [cell]})
    path.write_text(json.dumps(bench))


@pytest.fixture
def tiny_root(tmp_path):
    return shrink(copy_bench(tmp_path))
