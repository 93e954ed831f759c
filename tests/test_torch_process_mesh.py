"""The port's process mesh (``launch.mesh.make_process_mesh``: one rank
a process, collectives over ``torch.distributed``) running every
distributed multiply, held against the in-process mesh on the same
inputs, on the CPU.

Each process mesh is one gloo group of spawned processes that meet at a
``FileStore`` under the test's temporary directory (no port, so
parallel pytest workers never clash): one group a mesh shape (2x2,
2x4, 3x2, 2x2x2; 4, 8, 6 and 8 processes), two spawned at a time,
each running its whole battery and reporting every case's outputs to
this process, which runs the same case on the in-process mesh.  Every
spawn has a join timeout and every collective the group's 60 s timeout,
so nothing hangs.  The module takes ~35 s in one process: ~20 s the
spawns, ~6 s one 4-device JAX subprocess.

What is held:
  * the schedule battery of ``test_torch_distributed.py`` (Cannon,
    SUMMA x {psum, gather}, 2.5D x {all_reduce, reduce_scatter}, ts_k x
    both reduces, ts_m, ts_n) x {dense, 50 %, 5 % fill} x {densified,
    blocked}: bitwise where the collectives only move data, 1e-5
    relative / 1e-4 absolute where they add (2.5D's and ts_k's
    reductions, whose order gloo chooses); every process holds the same
    C bit for bit; the executor's statistics and the summed traffic are
    the in-process mesh's exactly; a few cases also against the JAX
    package's ``distributed_matmul`` on 4 host devices;
  * the port's bitwise contracts on a process mesh: depth 1 == serial
    == rolled, eps 0 == unfiltered, rank-exact == union, fused ==
    looped, ABFT repair == clean;
  * host decisions (the plan under ``"auto"``, its empty steps, the
    rebalance permutation, the calibrated constants) alike on every
    process and, but for the measured constants, equal to in process;
  * the service and tensor contractions on a process mesh, the
    service's ``poll()`` dispatching alike on every process when each
    process's clock says otherwise;
  * the guards: a group of the wrong size, CUDA where there is none,
    two NCCL ranks on one device, no process group;
  * C4 (a spec naming an axis twice, refused as JAX's NamedSharding
    refuses it) and ``block_cyclic_owner`` byte for byte.

The collectives one by one are held on process meshes in
``test_torch_mesh.py``, beside the JAX outputs that module computes."""
import datetime
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from conftest import run_subprocess_devices
from torch_threads import one_thread  # noqa: F401
from test_torch_distributed import (ALGOS, BATCHED, BS, DEPTH_ALGOS, FILLS,
                                    MESHES, PATHS, _batched_operands,
                                    _gap_eps, _grid, _operands, _tag)

from repro_torch.core import dbcsr
from repro_torch.core.blocking import block_cyclic_owner
from repro_torch.core.multiply import _distributed_matmul
from repro_torch.launch.mesh import (P, check_rank_devices, make_mesh,
                                     make_process_mesh)
from repro_torch.launch.processes import run_ranks

RTOL, ATOL = 1e-5, 1e-4
PROC_MESHES = ("2x2", "2x4", "3x2", "2x2x2")
ADDS = ("cannon25d", "ts_k")    # schedules whose collectives add
PG_TIMEOUT_S = 60               # a process mesh's collectives

# (case id, kind, mesh, params): one case a test
CASES = []
for _i, (_a, _kw, _m, _shape) in enumerate(ALGOS):
    if _m == "1x1":
        continue
    for _f in FILLS:
        for _p in PATHS:
            CASES.append((f"{_tag(_a, _kw, _m)}-fill{_f}-{_p}", "schedule",
                          _m, dict(algo=_a, kw=_kw, shape=_shape, fill=_f,
                                   path=_p, seed=1000 + len(CASES))))
for _a, _kw, _m, _shape in DEPTH_ALGOS:
    for _p in PATHS:
        CASES.append((f"depth-{_tag(_a, _kw, _m)}-{_p}", "depth", _m,
                      dict(algo=_a, kw=_kw, shape=_shape, path=_p)))
FILTERED = [("cannon", {}, "2x2", (64, 96, 64)),
            ("summa", {"bcast": "psum"}, "2x4", (64, 128, 64)),
            ("summa", {"bcast": "gather"}, "3x2", (96, 96, 64)),
            ("cannon25d", {"reduce": "reduce_scatter"}, "2x2x2",
             (64, 64, 64)),
            ("ts_k", {"reduce": "all_reduce"}, "2x2", (32, 128, 48))]
for _kind in ("eps0", "rank_exact", "eps_gap"):
    for _j, (_a, _kw, _m, _shape) in enumerate(FILTERED):
        CASES.append((f"{_kind}-{_tag(_a, _kw, _m)}", _kind, _m,
                      dict(algo=_a, kw=_kw, shape=_shape, seed=500 + _j)))
for _j, (_a, _m) in enumerate(BATCHED):
    CASES.append((f"batched-{_a}-{_m}", "batched", _m,
                  dict(algo=_a, seed=700 + _j)))
for _a, _kw, _m, _p in (("cannon", {}, "2x2", "blocked"),
                        ("summa", {"bcast": "psum"}, "2x4", "densified")):
    CASES.append((f"abft-{_tag(_a, _kw, _m)}-{_p}", "abft", _m,
                  dict(algo=_a, kw=_kw, path=_p)))
for _m in ("2x2", "2x4"):
    for _f in (1.0, 0.05):
        CASES.append((f"auto-{_m}-fill{_f}", "auto", _m, dict(fill=_f)))
CASES += [("rebalance-summa-2x2", "rebalance", "2x2", {}),
          ("service-2x2", "service", "2x2", {}),
          ("service-poll-2x2", "service_poll", "2x2", {}),
          ("contract-2x2", "contract", "2x2", {}),
          ("calibrate-2x2", "calibrate", "2x2", {}),
          ("guards-2x2", "guards", "2x2", {}),
          ("examples-2x2", "examples", "2x2", {})]
CASE_IDS = [c[0] for c in CASES]
BY_ID = {c[0]: c for c in CASES}

# cases also held against the JAX package on 4 host devices
JAX_CASES = ["cannon-2x2-fill0.5-blocked",
             "summa-psum-2x2-fill1.0-densified",
             "summa-gather-2x2-fill0.05-blocked",
             "ts_k-reduce_scatter-2x2-fill0.5-blocked"]


# ---------------------------------------------------------------------------
# one case on either mesh
# ---------------------------------------------------------------------------


def _call(mesh, m, a, b, am=None, bm=None, **kw):
    """``_distributed_matmul`` at the battery's blocks: (C, stats)."""
    return _distributed_matmul(
        torch.tensor(a), torch.tensor(b), mesh=mesh, grid=_grid(m),
        block_m=BS, block_k=BS, block_n=BS, a_mask=am, b_mask=bm, **kw)


def _hot_corner(seed):
    """A 2x2 SUMMA operand pair whose retained triples pile up on rank
    (0, 0), so the rebalance pass has work."""
    rng = np.random.RandomState(seed)
    n, nb = 128, 128 // BS
    a = rng.randn(n, n).astype(np.float32)
    b = rng.randn(n, n).astype(np.float32)
    am = rng.rand(nb, nb) < 0.1
    am[:nb // 2, :] |= rng.rand(nb // 2, nb) < 0.8
    bm = rng.rand(nb, nb) < 0.1
    bm[:, :nb // 2] |= rng.rand(nb, nb // 2) < 0.8
    a *= np.repeat(np.repeat(am, BS, 0), BS, 1)
    b *= np.repeat(np.repeat(bm, BS, 0), BS, 1)
    return a, b, am, bm


def _plan_fields(plan):
    return {"algorithm": plan.algorithm, "densify": bool(plan.densify),
            "predicted_s": float(plan.predicted_s),
            "pipeline_depth": plan.pipeline_depth,
            "stack_tile": plan.stack_tile, "rebalance": plan.rebalance,
            "empty_steps": plan.schedule_stats["empty_steps"],
            "executor_stats": plan.executor_stats}


def run_case(mesh, kind, m, p):
    """One case on ``mesh`` (in process or a process mesh): a dict of
    arrays (compared with the case's rule) and host values (compared
    exactly)."""
    if kind == "schedule":
        a, b, am, bm, _, _ = _operands(p["shape"], p["fill"], p["seed"])
        mesh.reset_traffic()
        c, stats = _call(mesh, m, a, b, am, bm, algorithm=p["algo"],
                         **PATHS[p["path"]], **p["kw"])
        return {"c": c.numpy(), "stats": stats,
                "traffic": mesh.traffic_total()}
    if kind == "depth":
        a, b, am, bm, _, _ = _operands(p["shape"], 0.5, 31)
        cs = [_call(mesh, m, a, b, am, bm, algorithm=p["algo"],
                    pipeline_depth=d, **PATHS[p["path"]], **p["kw"])[0]
              for d in (0, 1, 2)]
        return {"c": cs[1].numpy(),
                "bitwise": all(torch.equal(cs[1], x) for x in cs)}
    if kind in ("eps0", "rank_exact", "eps_gap"):
        a, b, am, bm, an, bn = _operands(p["shape"], 0.5, p["seed"],
                                         spread=True)
        kw = dict(algorithm=p["algo"], densify=False, a_norms=an,
                  b_norms=bn, **p["kw"])
        if kind == "eps0":
            pair = [_call(mesh, m, a, b, am, bm, filter_eps=e, **kw)[0]
                    for e in (None, 0.0)]
        elif kind == "rank_exact":
            pair = [_call(mesh, m, a, b, am, bm, rank_exact=r, **kw)[0]
                    for r in (False, True)]
        else:
            c, stats = _call(mesh, m, a, b, am, bm,
                             filter_eps=_gap_eps(an, bn, am, bm), **kw)
            return {"c": c.numpy(), "stats": stats}
        return {"c": pair[1].numpy(),
                "bitwise": bool(torch.equal(pair[0], pair[1]))}
    if kind == "batched":
        grid = _grid(m)
        reqs = [(dbcsr.create(a, mesh=mesh, grid=grid, block_size=BS,
                              block_mask=am),
                 dbcsr.create(b, mesh=mesh, grid=grid, block_size=BS))
                for a, b, am, _, _, _ in _batched_operands(p["seed"])]
        kw = dict(mesh=mesh, algorithm=p["algo"], densify=False,
                  pipeline_depth=1)
        fused = dbcsr.multiply_batched(reqs, fused=True, **kw)
        looped = dbcsr.multiply_batched(reqs, fused=False, **kw)
        return {"c": np.stack([x.data.numpy() for x in fused]),
                "bitwise": all(torch.equal(f.data, lo.data)
                               for f, lo in zip(fused, looped))}
    if kind == "abft":
        from repro_torch.robustness import chaos

        a, b, _, _, _, _ = _operands((64, 128, 64), 1.0, 41)
        kw = dict(algorithm=p["algo"], **PATHS[p["path"]], **p["kw"])
        clean, _ = _call(mesh, m, a, b, **kw)
        hook = chaos.FaultInjector(seed=7).one_shot_result_hook(
            1, 2, block_m=BS, block_n=BS, mode="bitflip")
        with chaos.result_corruption(hook):
            fixed, plan = _call(mesh, m, a, b, verify="checksum",
                                return_plan=True, **kw)
        rep = plan.verification["report"]
        return {"c": fixed.numpy(), "detected": bool(rep.detected),
                "repaired": bool(rep.repaired),
                "flagged": [list(x) for x in rep.flagged_blocks],
                "bitwise": bool(torch.equal(fixed, clean))}
    if kind == "auto":
        a, b, am, bm, _, _ = _operands((128, 128, 128), p["fill"], 61)
        c, plan = _call(mesh, m, a, b, am, bm, return_plan=True)
        return {"c": c.numpy(), "plan": _plan_fields(plan)}
    if kind == "rebalance":
        from repro_torch.sparsity.balance import plan_rebalance

        a, b, am, bm = _hot_corner(81)
        rb = plan_rebalance(am, bm, 2, 2)
        c, stats = _call(mesh, m, a, b, am, bm, algorithm="summa",
                         densify=False, rebalance=True)
        return {"c": c.numpy(), "stats": stats,
                "perm": [rb.perm_m.tolist(), rb.perm_n.tolist()]}
    if kind == "service":
        from repro_torch.serve import MultiplyService

        grid = _grid(m)
        svc = MultiplyService(mesh, fused=True, algorithm="cannon",
                              densify=False)
        tickets = [svc.submit(dbcsr.create(a, mesh=mesh, grid=grid,
                                           block_size=BS, block_mask=am),
                              dbcsr.create(b, mesh=mesh, grid=grid,
                                           block_size=BS))
                   for a, b, am, _, _, _ in _batched_operands(90)]
        svc.flush()
        return {"c": np.stack([svc.result(t).data.numpy()
                               for t in tickets])}
    if kind == "service_poll":
        from repro_torch.serve import MultiplyService

        # each process's own clock: on the first poll rank 0's request
        # is inside its SLO and the others' past it, on the second the
        # reverse; rank 0 decides both times, for every process
        now = [0.0]
        svc = MultiplyService(mesh, fused=True, slo_s=1.0,
                              algorithm="cannon", densify=False,
                              clock=lambda: now[0])
        grid = _grid(m)
        tickets = [svc.submit(dbcsr.create(a, mesh=mesh, grid=grid,
                                           block_size=BS, block_mask=am),
                              dbcsr.create(b, mesh=mesh, grid=grid,
                                           block_size=BS))
                   for a, b, am, _, _, _ in _batched_operands(91)]
        first = int(mesh.local_ranks[0]) == 0
        settled = []
        for late in (not first, first):
            now[0] = 2.0 if late else 0.5
            settled.append(svc.poll())
        return {"c": np.stack([svc.result(t).data.numpy()
                               for t in tickets]),
                "settled": settled}
    if kind == "contract":
        rng = np.random.RandomState(95)
        x = rng.randn(16, 32, 64).astype(np.float32)
        mm = rng.randn(64, 64).astype(np.float32)
        bt = dbcsr.create_tensor(x, mesh=mesh, block_sizes=(8, 16, 16))
        mt = dbcsr.create_tensor(mm, mesh=mesh, block_sizes=(16, 16))
        out = dbcsr.contract("iaP,PQ->iaQ", bt, mt, mesh=mesh,
                             algorithm="cannon", densify=False)
        return {"c": out.data.numpy()}
    if kind == "calibrate":
        from repro_torch.planner import calibrate

        sizes = dict(DENSE_N=88, SMM_CASES=((8, 64), (16, 64)),
                     PSUM_SIDE=32, OVERLAP_SIDE=32)
        saved = {k: getattr(calibrate, k) for k in sizes}
        for k, v in sizes.items():
            setattr(calibrate, k, v)
        try:
            got = calibrate.micro_calibrate(mesh, _grid(m), reps=1)
        finally:
            for k, v in saved.items():
                setattr(calibrate, k, v)
        return {"constants": got}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# the process meshes
# ---------------------------------------------------------------------------


def _guards(m):
    """The guards only a process of a group can see."""
    out = {}
    with pytest.raises(ValueError, match="has 8 ranks, the process group 4"):
        make_process_mesh((2, 4), ("data", "model"), device="cpu")
    out["wrong_size"] = True
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make_process_mesh(*MESHES[m])
        out["no_cuda"] = True
    return out


def _examples(work):
    """The examples as ``torchrun`` starts them (``WORLD_SIZE`` set, the
    group already up), at small sizes, in ``work`` (distributed_matmul
    writes its trace under ``artifacts/``): each checks its own
    result."""
    from repro_torch.examples import distributed_matmul, quickstart

    os.environ["WORLD_SIZE"] = "4"
    os.chdir(work)
    try:
        quickstart.main(["--device", "cpu", "--n", "128"])
        distributed_matmul.main(["--device", "cpu", "--square", "128",
                                 "--tall", "32", "1024"])
    finally:
        del os.environ["WORLD_SIZE"]
    return {"ran": True}


def _process_battery(rank, m, work):
    """One process of the ``m`` process mesh: every case of that mesh;
    returns {case id: outputs, or the traceback of its failure}."""
    import traceback

    torch.set_num_threads(1)
    mesh = make_process_mesh(
        *MESHES[m], device="cpu",
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    out = {"repr": repr(mesh), "transport": mesh.transport,
           "local_ranks": mesh.local_ranks.tolist()}
    for cid, kind, mm, p in CASES:
        if mm != m:
            continue
        try:
            out[cid] = (_guards(m) if kind == "guards"
                        else _examples(work) if kind == "examples"
                        else run_case(mesh, kind, m, p))
        except Exception:   # reported to the case's test
            out[cid] = {"error": traceback.format_exc()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: [rank 0's outputs, rank 1's, ...]}: the four process meshes,
    two spawned at a time (~4 GB of processes at the peak)."""
    work = str(tmp_path_factory.mktemp("process_mesh"))
    with ThreadPoolExecutor(2) as pool:
        futures = {m: pool.submit(run_ranks, _process_battery,
                                  int(np.prod(MESHES[m][0])),
                                  store_dir=work, args=(m, work),
                                  timeout_s=PG_TIMEOUT_S,
                                  join_timeout_s=300)
                   for m in PROC_MESHES}
        return {m: f.result() for m, f in futures.items()}


def _ranks_of(runs, cid):
    _, _, m, _ = BY_ID[cid]
    got = [r[cid] for r in runs[m]]
    for r, g in enumerate(got):
        assert "error" not in g, f"rank {r}:\n{g['error']}"
    return got


def _assert_c(kind, p, got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if kind in ("schedule", "depth", "eps_gap") and p["algo"] in ADDS \
            or kind in ("eps0", "rank_exact") and p["algo"] in ADDS:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cid", [c for c in CASE_IDS
                                 if BY_ID[c][1] not in ("guards", "examples",
                                                        "calibrate")])
def test_process_mesh_matches_in_process(runs, cid):
    """Every process holds the same outputs; C equals the in-process
    mesh's (bitwise where the collectives only move data); statistics,
    traffic, plans and flags equal the in-process mesh's exactly."""
    _, kind, m, p = BY_ID[cid]
    got = _ranks_of(runs, cid)
    for r, g in enumerate(got[1:], 1):
        assert g.keys() == got[0].keys()
        for key in g:
            if key == "c":
                np.testing.assert_array_equal(g[key], got[0][key],
                                              err_msg=f"rank {r}")
            else:
                assert g[key] == got[0][key], (r, key)
    want = run_case(make_mesh(*MESHES[m], device="cpu"), kind, m, p)
    assert got[0].keys() == want.keys()
    if kind == "auto":
        p = dict(p, algo=want["plan"]["algorithm"])
    _assert_c(kind, p, got[0]["c"], want["c"])
    for key in want:
        if key != "c":
            assert got[0][key] == want[key], key
    if "bitwise" in want:
        assert want["bitwise"]
    if kind == "abft":
        assert want["detected"] and want["repaired"] and want["flagged"]
    if kind == "rebalance":
        assert want["stats"]["rebalance_applied"]


def test_process_mesh_calibrates_alike(runs):
    """``micro_calibrate``'s probe runs on a process mesh (its psums are
    the group's all_reduce) and every process returns rank 0's
    constants."""
    got = _ranks_of(runs, "calibrate-2x2")
    consts = got[0]["constants"]
    assert {"latency_s", "bytes_per_s", "overlap_cannon",
            "overlap_summa"} <= consts.keys()
    assert all(g["constants"] == consts for g in got)
    # CPU timings: only the signs are the function's to promise
    assert consts["latency_s"] > 0 and consts["bytes_per_s"] > 0
    assert all(np.isfinite(v) and v >= 0 for v in consts.values())


def test_process_mesh_guards_and_layout(runs):
    """A group of the wrong size and CUDA where there is none raise in
    the processes; each process holds one rank and names its
    transport."""
    got = _ranks_of(runs, "guards-2x2")
    assert all(g["wrong_size"] for g in got)
    if not torch.cuda.is_available():
        assert all(g.get("no_cuda") for g in got)
    for m in PROC_MESHES:
        for r, out in enumerate(runs[m]):
            assert out["local_ranks"] == [r]
            assert out["transport"] == "gloo"
            assert f"rank {r} of" in out["repr"] and "gloo" in out["repr"]


def test_examples_run_on_a_process_mesh(runs, tmp_path, monkeypatch):
    """quickstart and distributed_matmul under a launcher (4 processes,
    one rank each) and alone (in process, 4x4)."""
    from repro_torch.examples import quickstart

    assert all(g["ran"] for g in _ranks_of(runs, "examples-2x2"))
    monkeypatch.chdir(tmp_path)
    quickstart.main(["--device", "cpu", "--n", "256"])


def _fails_on_rank_1(rank):
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank


def _hangs_on_rank_0(rank):
    import time

    if rank == 0:
        time.sleep(600)
    return rank


def test_run_ranks_reports_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2.*rank 1 fails"):
        run_ranks(_fails_on_rank_1, 2, store_dir=str(tmp_path),
                  timeout_s=30, join_timeout_s=120)


def test_run_ranks_stops_a_hanging_rank(tmp_path):
    """A rank that never reports fails the call at the join timeout, and
    no process outlives it."""
    import multiprocessing as mp

    before = set(mp.active_children())
    with pytest.raises(TimeoutError, match=r"ranks \[0\] of 2"):
        run_ranks(_hangs_on_rank_0, 2, store_dir=str(tmp_path),
                  timeout_s=30, join_timeout_s=10)
    assert not (set(mp.active_children()) - before)


def test_nccl_refuses_two_ranks_on_one_card():
    """The device map alone: NCCL takes one card a rank, gloo may share."""
    with pytest.raises(ValueError, match="ranks 0 and 2 both resolve to "
                                         "cuda:0"):
        check_rank_devices("nccl", ["cuda:0", "cuda:1", "cuda:0"])
    check_rank_devices("nccl", ["cuda:0", "cuda:1"])
    check_rank_devices("gloo", ["cuda:0"] * 4)


def test_process_mesh_needs_a_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialised torch.distributed"):
        make_process_mesh((2, 2), ("data", "model"), device="cpu")


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

_JAX = r"""
import json
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.core.blocking import GridSpec
from repro.core.multiply import distributed_matmul

cases = json.load(open(WORK + "/cases.json"))
data = np.load(WORK + "/inputs.npz")
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
for key, kw in cases.items():
    g = lambda name: data[key + ":" + name] if key + ":" + name in data \
        else None
    kw = dict(kw, a_mask=g("a_mask"), b_mask=g("b_mask"))
    if kw.get("densify") is False:
        kw["local_kernel"] = "ref"
    f = jax.jit(lambda a, b, kw=kw: distributed_matmul(
        a, b, mesh=mesh, grid=GridSpec("data", "model"), block_m=16,
        block_k=16, block_n=16, **kw))
    out[key] = np.asarray(f(jnp.asarray(g("a")), jnp.asarray(g("b"))))
np.savez(WORK + "/reference.npz", **out)
"""


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("process_jax"))
    cases, inputs = {}, {}
    for cid in JAX_CASES:
        _, _, _, p = BY_ID[cid]
        a, b, am, bm, _, _ = _operands(p["shape"], p["fill"], p["seed"])
        for name, x in (("a", a), ("b", b), ("a_mask", am), ("b_mask", bm)):
            if x is not None:
                inputs[f"{cid}:{name}"] = x
        cases[cid] = dict(algorithm=p["algo"], **PATHS[p["path"]],
                          **p["kw"])
    json.dump(cases, open(os.path.join(work, "cases.json"), "w"))
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    run_subprocess_devices(f"WORK = {work!r}\n" + _JAX, n_devices=4,
                           timeout=300)
    return dict(np.load(os.path.join(work, "reference.npz")))


@pytest.mark.parametrize("cid", JAX_CASES)
def test_process_mesh_matches_jax(runs, jax_reference, cid):
    got = _ranks_of(runs, cid)[0]["c"]
    np.testing.assert_allclose(got, jax_reference[cid], rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# C4 and the block-cyclic owner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["shard", "unshard"])
def test_spec_naming_an_axis_twice_is_refused_as_jax_refuses_it(op):
    """C4: ``P(None, "data", "data")`` cuts a dimension twice by one
    axis.  JAX's NamedSharding raises DuplicateSpecError; the port's
    ``shard`` and ``unshard`` raise ValueError."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    with pytest.raises(Exception, match="data") as refused:
        NamedSharding(jmesh, PartitionSpec(None, "data", "data"))
    assert type(refused.value).__name__ == "DuplicateSpecError"
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    spec = P(None, "data", "data")
    with pytest.raises(ValueError, match="more than one entry"):
        if op == "shard":
            mesh.shard(torch.zeros(4, 4, 4), spec)
        else:
            mesh.unshard(torch.zeros(4, 4, 2, 2), spec)
    with pytest.raises(ValueError, match="more than one entry"):
        mesh.shard(torch.zeros(4, 4), P(("data", "model"), "model"))


def test_block_cyclic_owner_is_the_reference_s():
    from repro.core.blocking import block_cyclic_owner as jax_owner

    for args in [(5, 7, 4, 4), (0, 0, 1, 1), (13, 2, 3, 5), (8, 9, 2, 3)]:
        assert block_cyclic_owner(*args) == jax_owner(*args)
        assert type(block_cyclic_owner(*args)[0]) is type(jax_owner(*args)[0])
    assert block_cyclic_owner(5, 7, 4, 4) == (1, 3)
