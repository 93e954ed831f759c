"""Rank-exact execution and costed rebalancing on multi-rank meshes: the
port's ``distributed_matmul`` / ``dbcsr.multiply`` (ranks simulated in
one process) against the JAX package's (one host device a rank), on the
CPU, and the port held to its own contracts.

The battery is the JAX package's rank-exact battery: patterns {dense,
banded, power-law} x {cannon 2x2, summa 2x2, summa 4x1, summa gather
2x2, ts_k 2x2, cannon25d 2x2x2 on ("pod", "data", "model")}, blocked,
64^2 in blocks of 8, with the default ``rank_exact``; plus ``filter_eps``
in a gap of the norm products, ``rank_exact=True``, ``rebalance=True``
on a hot-corner mask, and ``dbcsr.multiply`` calls on 2x2.  The
reference runs once, in one subprocess with 8 host devices, on operands,
masks and host norms this module writes; its blocked path runs the smm
kernel's plain version (``local_kernel="ref"``), the port's the smm
wrapper (its plain version on the CPU).  Tolerance: 1e-5 relative, 1e-4
absolute, as the distributed battery states (f32 sums of ~N(0, 1)
products in different orders)."""
import json
import os

import numpy as np
import pytest
import torch

from conftest import run_subprocess_devices
from torch_threads import one_thread  # noqa: F401

from repro_torch.core import dbcsr
from repro_torch.core import engine
from repro_torch.core.blocking import GridSpec
from repro_torch.core.multiply import _distributed_matmul
from repro_torch.launch.mesh import make_mesh
from repro_torch.sparsity import balance

RTOL, ATOL = 1e-5, 1e-4
BS, NB = 8, 8
N = NB * BS  # 64
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x1": ((4, 1), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}
GRIDS = {"1x1": ("data", "model", None), "2x2": ("data", "model", None),
         "4x1": ("data", "model", None), "2x2x2": ("data", "model", "pod")}

# (case id, algorithm, mesh, extra kwargs): the reference battery's cases
CASES = [
    ("cannon@2x2", "cannon", "2x2", {}),
    ("summa@2x2", "summa", "2x2", {}),
    ("summa@4x1", "summa", "4x1", {}),
    ("summa_gather@2x2", "summa", "2x2", {"bcast": "gather"}),
    ("ts_k@2x2", "ts_k", "2x2", {}),
    ("cannon25d@2x2x2", "cannon25d", "2x2x2", {}),
]
CASE_IDS = [c[0] for c in CASES]
CASE = {c[0]: c for c in CASES}
PATTERNS = ["dense", "banded", "powerlaw"]
EPS_CASES = ["cannon@2x2", "summa@2x2", "ts_k@2x2"]
EXACT_CASES = ["cannon@2x2", "ts_k@2x2"]
REBALANCE = ["summa", "cannon"]
ENTRY_CASES = ["cannon@2x2", "summa@2x2"]

# the four dbcsr.multiply calls on a 2x2 mesh that raised before the port
# had rank-exact execution: 88^2 in blocks of 22, A and B at 50 % fill
DBCSR_N, DBCSR_BS = 88, 22
DBCSR_CALLS = {
    "eps-2x2": dict(algorithm="cannon", densify=False, filter_eps=0.5),
    "summa-eps-2x2": dict(algorithm="summa", densify=False, filter_eps=0.5),
    "rank-exact-2x2": dict(algorithm="cannon", densify=False,
                           rank_exact=True),
    "rebalance-2x2": dict(algorithm="cannon", densify=False, rebalance=True),
}


def _expand(mask, bs=BS):
    return np.repeat(np.repeat(mask, bs, 0), bs, 1)


def _pattern(name):
    if name == "dense":
        return np.ones((NB, NB), dtype=bool)
    if name == "banded":
        idx = np.arange(NB)
        return np.abs(idx[:, None] - idx[None, :]) <= 1
    r = np.random.RandomState(3)          # the reference battery's power law
    p = (1.0 / (1.0 + np.arange(NB))) ** 1.2
    m = r.rand(NB, NB) < np.minimum(np.outer(p, p) * 0.3 * NB, 1.0)
    np.fill_diagonal(m, True)
    return m


def _hot():
    m = np.zeros((NB, NB), dtype=bool)
    m[:2, :] = m[:, :2] = True
    np.fill_diagonal(m, True)
    return m


def _norms(x, bs=BS):
    r, c = x.shape[0] // bs, x.shape[1] // bs
    return np.sqrt((x.reshape(r, bs, c, bs).astype(np.float64) ** 2)
                   .sum(axis=(1, 3))).astype(np.float32)


def _masked(mask, seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(N, N).astype(np.float32) * _expand(mask)
    b = rng.randn(N, N).astype(np.float32) * _expand(mask)
    return a, b


def _spread(seed):
    """A, B at 50 % block fill, A's block scales over two decades (eps
    has work to do), their masks and f32 host norms."""
    rng = np.random.RandomState(seed)
    a = rng.randn(N, N).astype(np.float32)
    b = rng.randn(N, N).astype(np.float32)
    a *= _expand(10.0 ** (-2 * rng.rand(NB, NB))).astype(np.float32)
    am, bm = rng.rand(NB, NB) < 0.5, rng.rand(NB, NB) < 0.5
    am[0, 0] = bm[0, 0] = True
    a *= _expand(am)
    b *= _expand(bm)
    return a, b, am, bm, _norms(a), _norms(b)


def _gap_eps(an, bn, am, bm):
    """An eps in the widest gap between two norm products near the
    median of the present triples, so no product sits at eps."""
    prod = (an[:, :, None] * bn[None]).astype(np.float64)
    srt = np.sort(prod[am[:, :, None] & bm[None]])
    mid = srt.size // 2
    lo, hi = max(mid - srt.size // 4, 1), min(mid + srt.size // 4,
                                             srt.size - 1)
    i = lo - 1 + int(np.argmax(srt[lo:hi] / srt[lo - 1:hi - 1]))
    return float(np.sqrt(srt[i] * srt[i + 1]))


def _dbcsr_operands():
    """The operands of the dbcsr calls (test_torch_dbcsr.py's 50 % fill
    at seed 0) with f32 host norms both packages are given."""
    rng = np.random.RandomState(0)
    nb = DBCSR_N // DBCSR_BS
    a = rng.randn(DBCSR_N, DBCSR_N).astype(np.float32)
    b = rng.randn(DBCSR_N, DBCSR_N).astype(np.float32)
    am, bm = rng.rand(nb, nb) < 0.5, rng.rand(nb, nb) < 0.5
    am[0, 0] = bm[0, 0] = True
    a *= _expand(am, DBCSR_BS)
    b *= _expand(bm, DBCSR_BS)
    return a, b, am, bm, _norms(a, DBCSR_BS), _norms(b, DBCSR_BS)


_REFERENCE = r"""
import json
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.core.blocking import GridSpec
from repro.core.multiply import distributed_matmul
from repro.core import dbcsr

cases = json.load(open(WORK + "/cases.json"))
data = np.load(WORK + "/inputs.npz")
out, counts = {}, {}
for key, c in cases.items():
    shape, axes = MESHES[c["mesh"]]
    mesh = make_mesh(tuple(shape), tuple(axes))
    grid = GridSpec(*c["grid"])
    g = lambda name: data[key + ":" + name] if key + ":" + name in data \
        else None
    kw = dict(c["kw"])
    if c.get("dbcsr"):
        ms = []
        for x in ("a", "b"):
            mat = dbcsr.create(g(x), mesh=mesh, grid=grid, block_size=c["bs"],
                               block_mask=g(x + "_mask"))
            mat.block_norms = g(x + "_norms")
            ms.append(mat)
        res = dbcsr.multiply(*ms, mesh=mesh, local_kernel="ref", **kw)
        out[key] = np.asarray(res.data)
        if res.block_mask is not None:
            out[key + ":mask"] = np.asarray(res.block_mask)
        continue
    kw["local_kernel"] = "ref"   # the smm kernel's plain version
    for name in ("a_mask", "b_mask", "a_norms", "b_norms"):
        kw[name] = g(name)
    call = dict(mesh=mesh, grid=grid, block_m=8, block_k=8, block_n=8, **kw)
    if c.get("plan"):
        # the executed plan's statistics (host objects: not under jit)
        _, plan = distributed_matmul(jnp.asarray(g("a")), jnp.asarray(g("b")),
                                     return_plan=True, **call)
        es = plan.executor_stats
        counts[key] = int(es.get("max_rank_entries", es["n_entries"]))
        continue
    f = jax.jit(lambda a, b, call=call: distributed_matmul(a, b, **call))
    out[key] = np.asarray(f(jnp.asarray(g("a")), jnp.asarray(g("b"))))
np.savez(WORK + "/reference.npz", **out)
json.dump(counts, open(WORK + "/counts.json", "w"))
print("ok", len(out), len(counts))
"""


def _case_kw(case):
    _, algo, mesh, extra = CASE[case]
    return mesh, dict(algorithm=algo, densify=False, **extra)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Write every case's operands, run the JAX package on them in one
    8-device subprocess, and return (cases, inputs, outputs, counts)."""
    work = str(tmp_path_factory.mktemp("rank_exact"))
    cases, inputs = {}, {}

    def put(key, mesh, kw, **arrays):
        for name, x in arrays.items():
            if x is not None:
                inputs[f"{key}:{name}"] = x
        cases[key] = {"mesh": mesh, "grid": list(GRIDS[mesh]), "kw": kw}

    for p, pattern in enumerate(PATTERNS):
        mask = _pattern(pattern)
        a, b = _masked(mask, 10 + p)
        for case in CASE_IDS:
            mesh, kw = _case_kw(case)
            put(f"{case}/{pattern}", mesh, kw, a=a, b=b, a_mask=mask,
                b_mask=mask)
    for i, case in enumerate(EPS_CASES):
        a, b, am, bm, an, bn = _spread(20 + i)
        mesh, kw = _case_kw(case)
        put(f"eps/{case}", mesh, dict(kw, filter_eps=_gap_eps(an, bn, am, bm)),
            a=a, b=b, a_mask=am, b_mask=bm, a_norms=an, b_norms=bn)
    a, b = _masked(_pattern("powerlaw"), 30)
    for case in EXACT_CASES:
        mesh, kw = _case_kw(case)
        put(f"exact/{case}", mesh, dict(kw, rank_exact=True), a=a, b=b,
            a_mask=_pattern("powerlaw"), b_mask=_pattern("powerlaw"))
    a, b = _masked(_hot(), 40)
    for algo in REBALANCE:
        put(f"rebalance/{algo}", "2x2",
            dict(algorithm=algo, densify=False, rebalance=True), a=a, b=b,
            a_mask=_hot(), b_mask=_hot())
    banded = _pattern("banded")
    a, b = _masked(banded, 11)
    for case in ENTRY_CASES:
        mesh, kw = _case_kw(case)
        put(f"entries/{case}", mesh, kw, a=a, b=b, a_mask=banded,
            b_mask=banded)
        cases[f"entries/{case}"]["plan"] = True
    a, b, am, bm, an, bn = _dbcsr_operands()
    for call, kw in DBCSR_CALLS.items():
        put(f"dbcsr/{call}", "2x2", kw, a=a, b=b, a_mask=am, b_mask=bm,
            a_norms=an, b_norms=bn)
        cases[f"dbcsr/{call}"].update(dbcsr=True, bs=DBCSR_BS)
    json.dump(cases, open(os.path.join(work, "cases.json"), "w"))
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    code = f"MESHES = {MESHES!r}\nWORK = {work!r}\n" + _REFERENCE
    run_subprocess_devices(code, n_devices=8, timeout=600)
    return (cases, inputs,
            dict(np.load(os.path.join(work, "reference.npz"))),
            json.load(open(os.path.join(work, "counts.json"))))


def _mesh(m, axes=None):
    shape, names = MESHES[m]
    return make_mesh(shape, axes or names, device="cpu")


def _port(reference, key, **over):
    """The port's ``(C, executor_stats)`` for a reference case."""
    cases, inputs, _, _ = reference
    c = cases[key]
    kw = dict(c["kw"], **over)
    for name in ("a_mask", "b_mask", "a_norms", "b_norms"):
        kw[name] = inputs.get(f"{key}:{name}")
    return _distributed_matmul(
        torch.tensor(inputs[key + ":a"]), torch.tensor(inputs[key + ":b"]),
        mesh=_mesh(c["mesh"]), grid=GridSpec(*c["grid"]), block_m=BS,
        block_k=BS, block_n=BS, **kw)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("case", CASE_IDS)
def test_battery_matches_jax(reference, case, pattern):
    key = f"{case}/{pattern}"
    got, stats = _port(reference, key)
    _close(got, reference[2][key])
    # masked multi-rank: rank-exact wherever the ranks' slices differ
    assert stats.get("rank_exact", False) == (pattern != "dense")


@pytest.mark.parametrize("case", EPS_CASES)
def test_eps_gap_matches_jax(reference, case):
    """filter_eps > 0, rank-exact by default: each rank filters by its
    own norms, as the reference does."""
    got, stats = _port(reference, f"eps/{case}")
    _close(got, reference[2][f"eps/{case}"])
    assert stats["rank_exact"] and stats["n_norm_filtered_triples"] > 0


@pytest.mark.parametrize("case", EXACT_CASES)
def test_rank_exact_true_matches_jax(reference, case):
    got, stats = _port(reference, f"exact/{case}")
    _close(got, reference[2][f"exact/{case}"])
    assert stats["rank_exact"]


@pytest.mark.parametrize("algo", REBALANCE)
def test_rebalance_matches_jax(reference, algo):
    got, stats = _port(reference, f"rebalance/{algo}")
    _close(got, reference[2][f"rebalance/{algo}"])
    assert stats["rebalance_applied"]


@pytest.mark.parametrize("call", sorted(DBCSR_CALLS))
def test_dbcsr_multi_rank_matches_jax(reference, call):
    """The dbcsr.multiply calls on 2x2 that raised before rank-exact
    execution was ported: the result's data and mask against the
    reference's."""
    _, inputs, ref, _ = reference
    key = f"dbcsr/{call}"
    mesh = _mesh("2x2")
    mats = []
    for x in ("a", "b"):
        m = dbcsr.create(inputs[f"{key}:{x}"], mesh=mesh,
                         block_size=DBCSR_BS,
                         block_mask=inputs[f"{key}:{x}_mask"])
        m.block_norms = inputs[f"{key}:{x}_norms"]
        mats.append(m)
    got = dbcsr.multiply(*mats, mesh=mesh, **DBCSR_CALLS[call])
    _close(got.data, ref[key])
    np.testing.assert_array_equal(got.block_mask, ref[key + ":mask"])


@pytest.mark.parametrize("case", ENTRY_CASES)
def test_busiest_rank_entries_match_jax(reference, case):
    """Banded: the busiest rank executes fewer triples than the union
    plan, and exactly as many as the reference's busiest rank."""
    key = f"entries/{case}"
    _, union = _port(reference, key, rank_exact=False)
    _, exact = _port(reference, key)
    assert exact["max_rank_entries"] < union["n_entries"]
    assert exact["max_rank_entries"] == reference[3][key]
    assert exact["rank_imbalance"] > 1.0
    assert len(exact["rank_entries"]) == 4


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

def _call(case, a, b, mask, **kw):
    mesh, ckw = _case_kw(case)
    return _distributed_matmul(
        torch.tensor(a), torch.tensor(b), mesh=_mesh(mesh),
        grid=GridSpec(*GRIDS[mesh]), block_m=BS, block_k=BS, block_n=BS,
        a_mask=mask, b_mask=mask, **ckw, **kw)


@pytest.mark.parametrize("eps", [None, 0.0], ids=["eps-none", "eps-0"])
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("case", CASE_IDS)
def test_rank_exact_is_bitwise_union(case, pattern, eps):
    """With eps None or 0 the union's extra triples only add +0.0
    products of absent blocks: rank-exact == union, bit for bit."""
    mask = _pattern(pattern)
    a, b = _masked(mask, 50)
    exact, _ = _call(case, a, b, mask, filter_eps=eps)
    union, _ = _call(case, a, b, mask, filter_eps=eps, rank_exact=False)
    forced, _ = _call(case, a, b, mask, filter_eps=eps, rank_exact=True)
    assert torch.equal(exact, union) and torch.equal(forced, union)


@pytest.mark.parametrize("case", CASE_IDS)
def test_dense_collapses_to_union(case):
    """Dense masks: every rank's slice is the same, so no step runs a
    rank plan, and the launches are the union's."""
    mask = _pattern("dense")
    a, b = _masked(mask, 51)
    exact, es = _call(case, a, b, mask)
    union, us = _call(case, a, b, mask, rank_exact=False)
    assert "rank_exact" not in es
    assert es["n_launches"] == us["n_launches"] > 0
    assert es["n_entries"] == us["n_entries"]
    assert torch.equal(exact, union)


@pytest.mark.parametrize("case", ["cannon@2x2", "summa@2x2",
                                  "cannon25d@2x2x2"])
def test_rank_exact_launches_once_a_step(case):
    """A rank-exact step is one smm launch over all ranks, where the
    union launches once per rank."""
    mask = _pattern("banded")
    a, b = _masked(mask, 52)
    _, es = _call(case, a, b, mask)
    _, us = _call(case, a, b, mask, rank_exact=False)
    steps = es["n_steps"] - es["n_empty_steps"]
    assert es["n_launches"] == steps
    assert us["n_launches"] == steps * int(np.prod(MESHES[_case_kw(case)[0]][0]))


@pytest.mark.parametrize("algo", REBALANCE)
def test_rebalance_round_trips(algo):
    """SUMMA's K order does not depend on the rank: bitwise; Cannon's
    rotation moves with the row: allclose.  The imbalance falls."""
    hot = _hot()
    a, b = _masked(hot, 53)
    kw = dict(mesh=_mesh("2x2"), grid=GridSpec("data", "model"),
              algorithm=algo, densify=False, block_m=BS, block_k=BS,
              block_n=BS, a_mask=hot, b_mask=hot)
    ta, tb = torch.tensor(a), torch.tensor(b)
    plain, ps = _distributed_matmul(ta, tb, rebalance=False, **kw)
    moved, ms = _distributed_matmul(ta, tb, rebalance=True, **kw)
    assert not ps["rebalance_applied"] and ms["rebalance_applied"]
    assert (ms["rebalance_imbalance_after"]
            < ms["rebalance_imbalance_before"])
    assert ms["rank_imbalance"] < ps["rank_imbalance"]
    if algo == "summa":
        assert torch.equal(moved, plain)
    else:
        np.testing.assert_allclose(moved.numpy(), plain.numpy(), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(moved.numpy(), a @ b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", EPS_CASES)
def test_eps_rank_exact_equals_one_rank_filter(case):
    """Under eps > 0 each rank's filter is the exact per-triple filter,
    so 2x2 agrees with the one-rank multiply at the same eps."""
    a, b, am, bm, an, bn = _spread(60 + EPS_CASES.index(case))
    eps = _gap_eps(an, bn, am, bm)
    mesh, kw = _case_kw(case)
    call = dict(block_m=BS, block_k=BS, block_n=BS, a_mask=am, b_mask=bm,
                a_norms=an, b_norms=bn, filter_eps=eps, **kw)
    ta, tb = torch.tensor(a), torch.tensor(b)
    got, stats = _distributed_matmul(ta, tb, mesh=_mesh(mesh),
                                     grid=GridSpec(*GRIDS[mesh]), **call)
    one, _ = _distributed_matmul(ta, tb, mesh=_mesh("1x1"),
                                 grid=GridSpec("data", "model"), **call)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert stats["rank_exact"] and stats["n_norm_filtered_triples"] > 0


@pytest.mark.parametrize("reduce", ["all_reduce", "reduce_scatter"])
def test_cannon25d_rank_exact_in_any_mesh_axis_order(reduce):
    """The leading rank's plan is read from its mesh coordinates: the
    2x2x2 rank-exact product on ("data", "model", "pod") equals the one
    on ("pod", "data", "model") and torch.matmul."""
    mask = _pattern("banded")
    a, b = _masked(mask, 54)
    outs = []
    for axes in (("pod", "data", "model"), ("data", "model", "pod")):
        c, st = _distributed_matmul(
            torch.tensor(a), torch.tensor(b), mesh=_mesh("2x2x2", axes),
            grid=GridSpec("data", "model", "pod"), algorithm="cannon25d",
            reduce=reduce, densify=False, block_m=BS, block_k=BS,
            block_n=BS, a_mask=mask, b_mask=mask)
        assert st["rank_exact"]
        outs.append(c)
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(outs[1].numpy(), a @ b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("order", [None, (2, 0, 3, 1, 2)])
def test_one_launch_is_bitwise_each_rank_alone(order):
    """The concatenated triples over all ranks == each rank's own plan
    run on its own blocks, bit for bit; ``rank_order`` picks the plan a
    leading rank runs."""
    rng = np.random.RandomState(5)
    m, k, n = 48, 64, 32
    masks = [{"a_mask": rng.rand(m // BS, k // BS) < 0.5,
              "b_mask": rng.rand(k // BS, n // BS) < 0.6} for _ in range(4)]
    masks[3] = {"a_mask": np.zeros((m // BS, k // BS), bool),
                "b_mask": masks[3]["b_mask"]}
    f = engine.rank_stack_executor(m, k, n, block_m=BS, block_k=BS,
                                   block_n=BS, rank_masks=masks,
                                   rank_order=order, stack_size=5)
    ranks = 4 if order is None else len(order)
    a = torch.tensor(rng.randn(ranks, m, k).astype(np.float32))
    b = torch.tensor(rng.randn(ranks, k, n).astype(np.float32))
    got = f(a, b)
    assert f.executor_plan.n_launches == 1
    for r in range(ranks):
        q = r if order is None else order[r]
        alone = engine.stack_executor(m, k, n, block_m=BS, block_k=BS,
                                      block_n=BS, stack_size=5, **masks[q])
        assert torch.equal(got[r], alone(a[r], b[r])), r


def test_concatenation_guards_int32(monkeypatch):
    monkeypatch.setattr(engine, "_INT32_MAX", 100)
    masks = [{"a_mask": np.ones((2, 2), bool), "b_mask": np.ones((2, 2), bool)}]
    with pytest.raises(ValueError, match="int32"):
        engine.build_rank_executor_plan(
            16, 16, 16, block_m=BS, block_k=BS, block_n=BS,
            rank_masks=masks * 2, rank_order=list(range(2)) * 13)


# ---------------------------------------------------------------------------
# copied host code: byte-equal to the JAX package's
# ---------------------------------------------------------------------------

def _same(x, y):
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype and x.shape == y.shape
    assert x.tobytes() == y.tobytes()


def _same_steps(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            _same(g[key], w[key])


def _rand_masks(rng, nbr, nbk, nbc, fill):
    am, bm = rng.rand(nbr, nbk) < fill, rng.rand(nbk, nbc) < fill
    an = np.where(am, rng.rand(nbr, nbk).astype(np.float32), np.float32(0))
    bn = np.where(bm, rng.rand(nbk, nbc).astype(np.float32), np.float32(0))
    return am, bm, an, bn


@pytest.mark.parametrize("pg,c_repl", [(2, 1), (4, 1), (4, 2), (2, 2)])
def test_cannon_rank_steps_byte_equal(pg, c_repl):
    from repro.core import cannon as jcannon

    from repro_torch.core import cannon

    rng = np.random.RandomState(pg * 10 + c_repl)
    am, bm, an, bn = _rand_masks(rng, pg * 2, pg * 3, pg * 2, 0.4)
    for norms in ({}, {"a_norms": an, "b_norms": bn}):
        got = cannon.cannon_rank_steps(am, bm, pg, c_repl, **norms)
        want = jcannon.cannon_rank_steps(am, bm, pg, c_repl, **norms)
        assert len(got) == pg // c_repl
        for g, w in zip(got, want):
            assert len(g) == pg * pg * c_repl
            _same_steps(g, w)


@pytest.mark.parametrize("pr,pc", [(2, 2), (4, 1), (2, 4)])
def test_summa_rank_steps_byte_equal(pr, pc):
    from repro.core import summa as jsumma

    from repro_torch.core import summa

    rng = np.random.RandomState(pr * 10 + pc)
    n_panels = summa.summa_n_panels(pr, pc)
    am, bm, an, bn = _rand_masks(rng, pr * 2, n_panels * 2, pc * 2, 0.4)
    for norms in ({}, {"a_norms": an, "b_norms": bn}):
        got = summa.summa_rank_steps(am, bm, pr, pc, n_panels, **norms)
        want = jsumma.summa_rank_steps(am, bm, pr, pc, n_panels, **norms)
        assert len(got) == len(want) == n_panels
        for g, w in zip(got, want):
            _same_steps(g, w)


@pytest.mark.parametrize("pr,pc", [(2, 2), (4, 1), (2, 4)])
def test_summa_gather_rank_steps_byte_equal(pr, pc):
    from repro.core import summa as jsumma

    from repro_torch.core import summa

    rng = np.random.RandomState(pr * 7 + pc)
    am, bm, an, bn = _rand_masks(rng, pr * 2, 5, pc * 2, 0.4)
    for norms in ({}, {"a_norms": an, "b_norms": bn}):
        _same_steps(summa.summa_gather_rank_steps(am, bm, pr, pc, **norms),
                    jsumma.summa_gather_rank_steps(am, bm, pr, pc, **norms))


@pytest.mark.parametrize("p_all", [4, 8])
@pytest.mark.parametrize("mode", ["ts_k", "ts_m", "ts_n"])
def test_ts_rank_steps_byte_equal(mode, p_all):
    from repro.core import tall_skinny as jts

    from repro_torch.core import tall_skinny as ts

    rng = np.random.RandomState(p_all + len(mode))
    big = {"ts_k": (2, p_all * 2, 3), "ts_m": (p_all * 2, 3, 2),
           "ts_n": (2, 3, p_all * 2)}[mode]
    am, bm, an, bn = _rand_masks(rng, *big, 0.4)
    for norms in ({}, {"a_norms": an, "b_norms": bn}):
        got = ts.ts_rank_steps(mode, am, bm, p_all, **norms)
        assert len(got) == p_all
        _same_steps(got, jts.ts_rank_steps(mode, am, bm, p_all, **norms))


@pytest.mark.parametrize("fill", [0.3, 0.7])
def test_stack_rank_slab_byte_equal(fill):
    from repro.core.stacks import stack_rank_slab as jslab

    from repro_torch.core.stacks import pad_plans, stack_rank_slab
    from repro_torch.core.stacks import build_stacks
    from repro_torch.core.blocking import BlockLayout

    rng = np.random.RandomState(int(fill * 10))
    views = []
    for r in range(4):
        am = rng.rand(4, 5) < fill
        if r == 2:
            am[:] = False      # an empty rank: an all-padding slice
        plans = build_stacks(BlockLayout(32, 40, 8, 8),
                             BlockLayout(40, 24, 8, 8), 3 + r, a_mask=am)
        views.append(pad_plans(plans) if plans
                     else np.zeros((0, 1, 4), dtype=np.int32))
    _same(stack_rank_slab(views, 12), jslab(views, 12))


@pytest.mark.parametrize("pattern", ["banded", "powerlaw", "hot"])
def test_rank_executor_plan_matches_jax(pattern):
    """The same per-rank masks through both packages' plan builders: the
    slab byte for byte, and the statistics the planner will read."""
    from repro.core.engine import build_rank_executor_plan as jbuild

    from repro_torch.core.cannon import cannon_rank_steps

    mask = _hot() if pattern == "hot" else _pattern(pattern)
    an, bn = _norms(np.abs(_masked(mask, 70)[0])), _norms(_masked(mask, 71)[1])
    for step in cannon_rank_steps(mask, mask, 2, a_norms=an, b_norms=bn):
        for eps in (None, 0.5):
            kw = dict(block_m=BS, block_k=BS, block_n=BS, rank_masks=step,
                      stack_size=7, filter_eps=eps)
            got = engine.build_rank_executor_plan(32, 32, 32, **kw)
            want = jbuild(32, 32, 32, **kw)
            _same(got.slab, want.slab)
            for name in ("rank_entries", "n_entries", "n_stacks",
                         "stack_tile", "n_padding", "rank_imbalance",
                         "occupancy", "uniform", "n_unfiltered_entries",
                         "n_norm_filtered_triples"):
                assert getattr(got, name) == getattr(want, name), name
            assert got.triples.shape[0] == sum(got.rank_entries)


@pytest.mark.parametrize("eps", [None, 0.2])
@pytest.mark.parametrize("pattern", ["banded", "powerlaw", "hot"])
def test_balance_weights_byte_equal(pattern, eps):
    from repro.sparsity import balance as jbalance

    mask = _hot() if pattern == "hot" else _pattern(pattern)
    rng = np.random.RandomState(8)
    an = np.where(mask, rng.rand(NB, NB), 0).astype(np.float32)
    bn = np.where(mask, rng.rand(NB, NB), 0).astype(np.float32)
    norms = {} if eps is None else dict(a_norms=an, b_norms=bn,
                                        filter_eps=eps)
    w = balance.retained_block_weights(mask, mask, **norms)
    _same(w, jbalance.retained_block_weights(mask, mask, **norms))
    for pr, pc in ((2, 2), (4, 1), (2, 4)):
        _same(balance.chunk_loads(w, pr, pc), jbalance.chunk_loads(w, pr, pc))
        assert (balance.chunk_imbalance(w, pr, pc)
                == jbalance.chunk_imbalance(w, pr, pc))


@pytest.mark.parametrize("grid", [(2, 2), (4, 1), (2, 4), (4, 4)])
@pytest.mark.parametrize("pattern", ["banded", "powerlaw", "hot"])
def test_plan_rebalance_picks_jax_permutations(pattern, grid):
    from repro.sparsity import balance as jbalance

    mask = _hot() if pattern == "hot" else _pattern(pattern)
    for seed in (0, 3):
        got = balance.plan_rebalance(mask, mask, *grid, seed=seed)
        want = jbalance.plan_rebalance(mask, mask, *grid, seed=seed)
        _same(got.perm_m, want.perm_m)
        _same(got.perm_n, want.perm_n)
        assert (got.method, got.imbalance_before, got.imbalance_after) == (
            want.method, want.imbalance_before, want.imbalance_after)
        _same(got.inv_m, want.inv_m)


def test_permute_blocks_on_tensors_and_arrays():
    """Numpy arrays and torch tensors take the same permutation; the
    inverse round-trips."""
    from repro.sparsity import balance as jbalance

    rng = np.random.RandomState(9)
    x = rng.randn(32, 48).astype(np.float32)
    pm, pn = rng.permutation(4), rng.permutation(6)
    want = jbalance.permute_block_cols(
        jbalance.permute_block_rows(x, pm, 8), pn, 8)
    got = balance.permute_block_cols(balance.permute_block_rows(x, pm, 8),
                                     pn, 8)
    _same(got, want)
    t = balance.permute_block_cols(
        balance.permute_block_rows(torch.tensor(x), pm, 8), pn, 8)
    _same(t.numpy(), want)
    back = balance.permute_block_cols(
        balance.permute_block_rows(t, balance.invert_permutation(pm), 8),
        balance.invert_permutation(pn), 8)
    assert torch.equal(back, torch.tensor(x))
