"""The port's fused stack executor against the JAX package's: the same
plans (byte-equal triples), allclose products, and the port's own
bitwise contract fused == looped.

Tolerance: 1e-5 relative; both packages sum the same f32 block products
in different orders."""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.densify import to_blocks as jax_to_blocks
from repro.core import engine as jengine
from repro.kernels.smm import autotune as jautotune

from repro_torch.core import engine
from repro_torch.core.densify import to_blocks
from repro_torch.kernels.smm import autotune

from torch_threads import one_thread  # noqa: F401

RTOL = ATOL = 1e-5


def _plan_kwargs(rng, nb, case):
    if case == "dense":
        return {}
    if case == "masked":
        return {"a_mask": rng.rand(nb, nb) < 0.4,
                "b_mask": rng.rand(nb, nb) < 0.6}
    return {"a_mask": rng.rand(nb, nb) < 0.6,
            "a_norms": rng.rand(nb, nb).astype(np.float32),
            "b_norms": rng.rand(nb, nb).astype(np.float32),
            "filter_eps": 0.3}


@pytest.mark.parametrize("bs,nb,stack", [(4, 6, 10), (22, 3, 5), (64, 2, 3)])
@pytest.mark.parametrize("case", ["dense", "masked", "eps"])
def test_executor_plan_byte_equal(bs, nb, stack, case):
    kw = _plan_kwargs(np.random.RandomState(bs), nb, case)
    n = bs * nb
    t = engine.build_executor_plan(n, n, n, bs, bs, bs, stack, **kw)
    j = jengine.build_executor_plan(n, n, n, bs, bs, bs, stack, **kw)
    assert len(t.bin_triples) == len(j.bin_triples)
    for x, y in zip(t.bin_triples, j.bin_triples):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()
    ts, js = t.stats(), j.stats()
    for key in ("n_stacks", "n_entries", "n_dense_triples", "n_padding",
                "n_padding_unbinned", "n_bins", "filter_eps"):
        assert ts[key] == js[key], key
    assert t.n_launches == sum(1 for r in t.bin_run_starts if r.size)


def _operands(rng, n, bs):
    a = rng.randn(n, n).astype(np.float32)
    b = rng.randn(n, n).astype(np.float32)
    return a, b


@pytest.mark.parametrize("bs,nb,stack,case,jkernel", [
    (4, 4, 6, "masked", "smm"),     # JAX side: Pallas, interpret mode
    (22, 3, 4, "dense", "ref"),
    (8, 5, 7, "eps", "ref"),
    (4, 8, 8, "masked", "ref"),
])
def test_execute_plan_matches_jax(bs, nb, stack, case, jkernel):
    rng = np.random.RandomState(nb)
    kw = _plan_kwargs(rng, nb, case)
    n = bs * nb
    a, b = _operands(rng, n, bs)
    c0 = rng.randn(nb * nb, bs, bs).astype(np.float32)
    jplan = jengine.build_executor_plan(n, n, n, bs, bs, bs, stack, **kw)
    want = jengine.execute_plan(
        jplan, jax_to_blocks(jnp.asarray(a), bs, bs),
        jax_to_blocks(jnp.asarray(b), bs, bs), jnp.asarray(c0),
        kernel=jkernel)
    plan = engine.build_executor_plan(n, n, n, bs, bs, bs, stack, **kw)
    got = engine.execute_plan(
        plan, to_blocks(torch.tensor(a), bs, bs),
        to_blocks(torch.tensor(b), bs, bs), torch.tensor(c0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["dense", "masked", "eps"])
def test_fused_equals_looped_bitwise(case):
    rng = np.random.RandomState(11)
    bs, nb = 4, 10
    kw = _plan_kwargs(rng, nb, case)
    n = bs * nb
    a, b = _operands(rng, n, bs)
    ab = to_blocks(torch.tensor(a), bs, bs)
    bb = to_blocks(torch.tensor(b), bs, bs)
    plan = engine.build_executor_plan(n, n, n, bs, bs, bs, 8, **kw)
    fused = engine.execute_plan(plan, ab, bb, torch.zeros(nb * nb, bs, bs))
    looped = engine.execute_plans_looped(list(plan.plans), ab, bb,
                                         torch.zeros(nb * nb, bs, bs))
    assert torch.equal(fused, looped)


def test_size_binned_plan_runs_one_launch_per_bin():
    rng = np.random.RandomState(0)
    nb, bs = 40, 4
    am = rng.rand(nb, nb) < 0.2
    plan = engine.build_executor_plan(nb * bs, nb * bs, nb * bs, bs, bs, bs,
                                      8, a_mask=am)
    assert plan.n_bins >= 2 and plan.n_launches == plan.n_bins
    bins = plan.device_bins(torch.device("cpu"))
    assert bins is plan.device_bins("cpu")  # uploaded once per device
    for (t, r), tri, rs in zip(bins, plan.bin_triples, plan.bin_run_starts):
        assert t.shape == (tri.shape[0] * tri.shape[1], 4)
        np.testing.assert_array_equal(r.numpy(), rs)


def test_stack_executor_matches_jax_and_checks_shapes(tmp_path, monkeypatch):
    # neither package's winners table: the port's H100 table
    # (artifacts/smm_autotune_h100.json) would pick another tile
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(5)
    bs, nb = 22, 3
    n = bs * nb
    a, b = _operands(rng, n, bs)
    am = rng.rand(nb, nb) < 0.5
    f = engine.stack_executor(n, n, n, block_m=bs, block_k=bs, block_n=bs,
                              a_mask=am)
    jf = jengine.stack_executor(n, n, n, block_m=bs, block_k=bs, block_n=bs,
                                a_mask=am, kernel="ref")
    got = f(torch.tensor(a), torch.tensor(b))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jf(jnp.asarray(a), jnp.asarray(b))),
                               rtol=RTOL, atol=ATOL)
    assert f.stack_size == 30000 and f.align is False
    with pytest.raises(ValueError):
        f(torch.tensor(a[:, :bs]), torch.tensor(b[:bs]))


def test_plan_memo_keys_on_content():
    rng = np.random.RandomState(9)
    mask = rng.rand(4, 4) < 0.5
    p1 = engine.build_executor_plan(16, 16, 16, 4, 4, 4, 5, a_mask=mask)
    p2 = engine.build_executor_plan(16, 16, 16, 4, 4, 4, 5,
                                    a_mask=mask.copy())
    assert p1 is p2
    mask[0, 0] = not mask[0, 0]  # the caller may mutate its mask
    p3 = engine.build_executor_plan(16, 16, 16, 4, 4, 4, 5, a_mask=mask)
    assert p3 is not p1
    with pytest.raises(ValueError):
        p1.bin_triples[0][0, 0, 0] = 1  # memoized plans are read-only


def test_resolve_stack_bins(monkeypatch):
    assert engine.resolve_stack_bins(2) == 2
    monkeypatch.setenv("DBCSR_STACK_BINS", "3")
    assert engine.resolve_stack_bins() == 3
    with pytest.raises(ValueError):
        engine.resolve_stack_bins(0)


@pytest.mark.parametrize("fill", [1.0, 0.7, 0.3, 0.12, 0.01])
def test_fill_bin_equal_to_jax(fill):
    assert autotune.fill_bin(fill) == jautotune.fill_bin(fill)


def test_autotune_lookup(tmp_path):
    meta = autotune.best_params_meta(22, 22, 22, str(tmp_path / "none.json"))
    assert (meta["stack_tile"], meta["source"], meta["align"]) == \
        (30000, "heuristic", False)
    table = tmp_path / "smm_autotune_h100.json"
    table.write_text(json.dumps({"22": {"best": {"stack_tile": 4096,
                                                 "gflops": 1.5}}}))
    assert autotune.best_params_for(22, 22, 22, str(table), fill=0.2) == \
        (False, 4096)
    meta = autotune.best_params_meta(22, 22, 22, str(table), fill=0.2)
    assert meta["source"] == "winners[22]" and meta["bin"] == 0.2
    assert autotune.best_params_for(22, 22, 64, str(table)) == (False, 30000)


def test_has_winners(tmp_path):
    assert not autotune.has_winners(22, 22, 22, str(tmp_path / "none.json"))
    table = tmp_path / "smm_autotune_h100.json"
    table.write_text(json.dumps({"22@0.2": {"best": {"stack_tile": 512}}}))
    assert autotune.has_winners(22, 22, 22, str(table))
    assert not autotune.has_winners(2, 2, 2, str(table))
    assert not autotune.has_winners(22, 22, 64, str(table))


def test_stack_executor_computes_fill_only_for_a_table(tmp_path, monkeypatch):
    rng = np.random.RandomState(6)
    bs, nb = 4, 10
    n = bs * nb
    am = rng.rand(nb, nb) < 0.2
    fills = []
    real_fill = engine._mask_fill
    monkeypatch.setattr(engine, "_mask_fill",
                        lambda *a: fills.append(real_fill(*a)) or fills[-1])
    monkeypatch.setattr(autotune, "DEFAULT_CACHE",
                        str(tmp_path / "absent.json"))
    f = engine.stack_executor(n, n, n, block_m=bs, block_k=bs, block_n=bs,
                              a_mask=am)
    assert fills == [] and f.stack_size == 30000
    table = tmp_path / "smm_autotune_h100.json"
    table.write_text(json.dumps({"4@0.2": {"best": {"stack_tile": 16}}}))
    monkeypatch.setattr(autotune, "DEFAULT_CACHE", str(table))
    f = engine.stack_executor(n, n, n, block_m=bs, block_k=bs, block_n=bs,
                              a_mask=am)
    assert len(fills) == 1 and autotune.fill_bin(fills[0]) == 0.2
    assert f.stack_size == 16


@pytest.mark.parametrize("case", ["dense", "masked", "eps"])
def test_stack_executor_equals_execute_plan_bitwise(case):
    # the executor's in-place C (scratch block allocated with it) gives
    # what execute_plan gives on a zeroed C
    rng = np.random.RandomState(12)
    bs, nb = 4, 9
    kw = _plan_kwargs(rng, nb, case)
    n = bs * nb
    a, b = _operands(rng, n, bs)
    f = engine.stack_executor(n, n, n, block_m=bs, block_k=bs, block_n=bs,
                              stack_size=7, **kw)
    got = f(torch.tensor(a), torch.tensor(b))
    c = engine.execute_plan(f.executor_plan, to_blocks(torch.tensor(a), bs, bs),
                            to_blocks(torch.tensor(b), bs, bs),
                            torch.zeros(nb * nb, bs, bs))
    assert torch.equal(to_blocks(got, bs, bs), c)
