"""The host caches under a repeated multiply: an executor plan counts its
statistics once, and the smm winners table is parsed once per version
of its file.  Both serve any call that reuses the plan or the file,
whether or not it repeats the call before it.

On the CPU, in an empty working directory with its own table path."""
import collections
import copy
import json
import os

import numpy as np
import pytest

from repro_torch import obs
from repro_torch.core import engine, stacks
from repro_torch.kernels.smm import autotune

from torch_threads import one_thread  # noqa: F401

BS, NB = 4, 6


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(autotune, "DEFAULT_CACHE",
                        str(tmp_path / "winners.json"))
    yield
    obs.enable()
    obs.disable()
    obs.clear_metrics()


def _counting(monkeypatch, mod, name, calls=None):
    calls = collections.Counter() if calls is None else calls
    real = getattr(mod, name)

    def counting(*args, **kw):
        calls[name] += 1
        return real(*args, **kw)

    monkeypatch.setattr(mod, name, counting)
    return calls


def _plan(case, stack_size=5):
    """A fresh (never memoized) plan: dense, masked, or masked and
    filtered by norms."""
    rng = np.random.RandomState(3)
    kw = {}
    if case != "dense":
        kw = dict(a_mask=rng.rand(NB, NB) < 0.6, b_mask=rng.rand(NB, NB) < 0.6)
    if case == "eps":
        kw.update(a_norms=rng.rand(NB, NB).astype(np.float32),
                  b_norms=rng.rand(NB, NB).astype(np.float32),
                  filter_eps=0.25)
    n = BS * NB
    return engine.build_executor_plan(n, n, n, BS, BS, BS, stack_size, **kw)


@pytest.mark.parametrize("case", ["dense", "masked", "eps"])
def test_plan_counts_its_statistics_once(case, monkeypatch):
    calls = _counting(monkeypatch, stacks, "stack_statistics")
    plan = _plan(case, stack_size=7)
    first = plan.stats()
    assert calls["stack_statistics"] == 1
    second = plan.stats()
    assert calls["stack_statistics"] == 1
    assert first == second and first is not second
    # the stacks' own numbers, as counted from them
    base = stacks.stack_statistics(list(plan.plans))
    for key in ("n_stacks", "n_multiplications", "max_stack", "flops"):
        assert first[key] == base[key]
    assert first["n_entries"] == plan.n_entries
    assert first["occupancy"] == plan.occupancy
    if case == "eps":
        assert first["n_norm_filtered_triples"] == plan.n_norm_filtered_triples


@pytest.mark.parametrize("case", ["dense", "masked", "eps"])
def test_an_edit_to_the_statistics_reaches_no_later_report(case):
    plan = _plan(case, stack_size=9)
    s = plan.stats()
    want = dict(s)
    s["n_entries"] = -1
    s["extra"] = "edited"
    assert plan.stats() == want


@pytest.mark.parametrize("case", ["dense", "masked", "eps"])
def test_every_report_publishes_into_the_registry(case):
    plan = _plan(case, stack_size=11)
    plan.stats()             # counted with telemetry off: publishes nothing
    obs.enable()
    plan.stats()
    plan.stats()
    assert obs.counter("executor.stats_reports").value == 2
    assert obs.counter("executor.entries").value == 2 * plan.n_entries
    assert (obs.counter("executor.norm_filtered_triples").value
            == 2 * plan.n_norm_filtered_triples)
    assert obs.histogram("executor.occupancy").count == 2


def _write(path, table):
    with open(path, "w") as f:
        json.dump(table, f)


def test_winners_table_parsed_once_per_version(monkeypatch):
    calls = _counting(monkeypatch, autotune, "load_cache")
    path = autotune.DEFAULT_CACHE
    assert not autotune.has_winners(BS, BS, BS)
    assert autotune.best_params_for(BS, BS, BS) == (False, 30000)
    assert calls["load_cache"] == 0          # no file: nothing to parse
    _write(path, {str(BS): {"best": {"stack_tile": 16}}})
    for _ in range(3):
        assert autotune.has_winners(BS, BS, BS)
        assert autotune.best_params_for(BS, BS, BS) == (False, 16)
    assert calls["load_cache"] == 1
    # a rewrite is a new version, read again
    _write(path, {str(BS): {"best": {"stack_tile": 128, "align": True}},
                  f"{BS}@0.2": {"best": {"stack_tile": 64}}})
    assert autotune.best_params_for(BS, BS, BS) == (True, 128)
    assert autotune.best_params_for(BS, BS, BS, fill=0.2) == (False, 64)
    assert calls["load_cache"] == 2
    # another path is another table
    other = str(path) + ".other"
    _write(other, {str(BS): {"best": {"stack_tile": 8}}})
    assert autotune.best_params_for(BS, BS, BS, other) == (False, 8)
    assert autotune.best_params_for(BS, BS, BS) == (True, 128)


def test_lookups_leave_the_parsed_table_unchanged():
    path = autotune.DEFAULT_CACHE
    _write(path, {str(BS): {"best": {"stack_tile": 16}}})
    meta = autotune.best_params_meta(BS, BS, BS)
    meta["stack_tile"] = 1
    table = autotune.load_cache()
    table[str(BS)]["best"]["stack_tile"] = 2      # the caller's own copy
    assert autotune.best_params_for(BS, BS, BS) == (False, 16)


def test_a_removed_table_falls_back_to_the_heuristic():
    path = autotune.DEFAULT_CACHE
    _write(path, {str(BS): {"best": {"stack_tile": 16}}})
    assert autotune.best_params_for(BS, BS, BS) == (False, 16)
    os.remove(path)
    assert not autotune.has_winners(BS, BS, BS)
    assert autotune.best_params_for(BS, BS, BS) == (False, 30000)


MESHES = {"1x1": (1, 1), "2x2": (2, 2)}


@pytest.mark.parametrize("case", ["dense", "masked", "eps"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_a_repeated_multiply_recounts_and_rereads_nothing(mesh_name, case,
                                                          monkeypatch):
    """The second of two equal blocked multiplies gives C bitwise and the
    same statistics, with no stack recounted and no table reparsed."""
    import torch

    from repro_torch.core import dbcsr
    from repro_torch.launch.mesh import make_mesh

    _write(autotune.DEFAULT_CACHE, {"8": {"best": {"stack_tile": 16}}})
    loads = _counting(monkeypatch, stacks, "stack_statistics")
    _counting(monkeypatch, autotune, "load_cache", loads)
    mesh = make_mesh(MESHES[mesh_name], ("data", "model"), device="cpu")
    rng = np.random.RandomState(5)
    n, nb = 64, 8
    am = bm = None
    if case != "dense":
        am, bm = rng.rand(nb, nb) < 0.6, rng.rand(nb, nb) < 0.6
    a = dbcsr.create(rng.randn(n, n).astype(np.float32), mesh=mesh,
                     block_size=8, block_mask=am)
    b = dbcsr.create(rng.randn(n, n).astype(np.float32), mesh=mesh,
                     block_size=8, block_mask=bm)
    kw = dict(mesh=mesh, densify=False, local_kernel="ref", return_plan=True,
              filter_eps=64.0 if case == "eps" else None)
    c1, p1 = dbcsr.multiply(a, b, **kw)
    first = dict(loads)
    assert first["load_cache"] == 1
    want = copy.deepcopy(p1.executor_stats)
    assert want["n_entries"] > 0
    # the caller's edit to its statistics reaches no later call
    p1.executor_stats["n_entries"] = -1
    p1.executor_stats.pop("n_launches")
    c2, p2 = dbcsr.multiply(a, b, **kw)
    assert dict(loads) == first
    assert torch.equal(c1.data, c2.data)
    assert p2.executor_stats == want
