"""The distributed schedules on multi-rank meshes: the port's
``distributed_matmul`` (ranks simulated in one process, launch/mesh.py)
against the JAX package's (one host device a rank), on the CPU.

The battery is {cannon, summa psum, summa gather, cannon25d x
{all_reduce, reduce_scatter}, ts_k x {all_reduce, reduce_scatter}, ts_m,
ts_n} x {dense, 50 %, 5 % block fill} x {densified, blocked} on 1x1,
2x2, 2x4 or 3x2 (SUMMA) and 2x2x2 (2.5D, and ts_k over three axes),
blocks of 16, sides <= 128.  The reference runs once, in one subprocess
with 8 host devices, on operands, masks and host norms this module
writes; every case is then one test.  Its blocked path runs the smm
kernel's plain version (``local_kernel="ref"``), the port's the smm
wrapper (its plain version on the CPU).  Tolerance: 1e-5 relative, 1e-4
absolute on products of ~N(0, 1) entries summed over k <= 128 in f32
in different orders (and, for psum over ranks, a different order of the
rank partials).

The rest of the module holds the port to its own bitwise contracts on
multi-rank meshes (depths, eps 0, the rank-stacked blocked step, fused
batches), and its copies of the host step builders byte for byte to the
reference's."""
import json
import os

import numpy as np
import pytest
import torch

from conftest import run_subprocess_devices
from torch_threads import one_thread  # noqa: F401

from repro_torch.core import dbcsr
from repro_torch.core.blocking import GridSpec
from repro_torch.core.engine import stack_executor
from repro_torch.core.multiply import distributed_matmul
from repro_torch.core.multiply_batched import distributed_matmul_batched
from repro_torch.launch.mesh import make_mesh

RTOL, ATOL = 1e-5, 1e-4
BS = 16
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "3x2": ((3, 2), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}
GRID2, GRID3 = ("data", "model", None), ("data", "model", "pod")

# (algorithm, extra kwargs, mesh, (m, k, n)): shapes every grid divides
ALGOS = [
    ("cannon", {}, "1x1", (64, 96, 64)),
    ("cannon", {}, "2x2", (64, 96, 64)),
]
for _m, _shape in (("2x2", (64, 64, 64)), ("2x4", (64, 128, 64)),
                   ("3x2", (96, 96, 64))):
    ALGOS += [("summa", {"bcast": "psum"}, _m, _shape),
              ("summa", {"bcast": "gather"}, _m, _shape)]
for _red in ("all_reduce", "reduce_scatter"):
    ALGOS += [("cannon25d", {"reduce": _red}, "2x2x2", (64, 64, 64)),
              ("ts_k", {"reduce": _red}, "2x2", (32, 128, 48)),
              ("ts_k", {"reduce": _red}, "2x2x2", (32, 128, 48))]
for _m in ("2x2", "2x4"):
    ALGOS += [("ts_m", {}, _m, (128, 32, 48)), ("ts_n", {}, _m, (32, 48, 128))]

FILLS = (1.0, 0.5, 0.05)
PATHS = {"densified": dict(densify=True), "blocked": dict(densify=False)}


def _tag(algo, kw, m):
    extra = "-".join(str(v) for v in kw.values())
    return "-".join(x for x in (algo, extra, m) if x)


BATTERY = [(_tag(a, kw, m), a, kw, m, shape, fill, path)
           for a, kw, m, shape in ALGOS for fill in FILLS
           for path in PATHS]
BATTERY_IDS = [f"{t}-fill{f}-{p}" for t, _, _, _, _, f, p in BATTERY]
BATTERY_MESH = {key: case[3] for key, case in zip(BATTERY_IDS, BATTERY)}

# eps cases, blocked, 50 % fill: eps 0 (the reference's default,
# rank-exact, is bitwise its union plan), eps > 0 on the union plan
# (rank_exact=False on both sides) and eps > 0 rank-exact (the default on
# both sides: each rank filters by its own norms)
EPS = [(_tag(a, kw, m), a, kw, m, shape, eps)
       for a, kw, m, shape in (("cannon", {}, "2x2", (64, 96, 64)),
                               ("summa", {"bcast": "psum"}, "2x4",
                                (64, 128, 64)),
                               ("summa", {"bcast": "gather"}, "3x2",
                                (96, 96, 64)),
                               ("cannon25d", {"reduce": "reduce_scatter"},
                                "2x2x2", (64, 64, 64)),
                               ("ts_k", {"reduce": "all_reduce"}, "2x2",
                                (32, 128, 48)))
       for eps in ("zero", "gap")]
# each gap case's default (rank-exact) twin, on the same operands
EPS += [case[:5] + ("gap-default",) for case in EPS if case[5] == "gap"]
EPS_IDS = [f"{t}-eps-{e}" for t, _, _, _, _, e in EPS]


def _grid_names(m):
    return GRID3 if len(MESHES[m][0]) == 3 else GRID2


def _grid(m):
    return GridSpec(*_grid_names(m))


def _operands(shape, fill, seed, spread=False):
    """A, B (absent blocks zeroed), their block masks (None when dense)
    and f32 host norms, from one seed."""
    m, k, n = shape
    rng = np.random.RandomState(seed)
    a = rng.randn(m, k).astype(np.float32)
    b = rng.randn(k, n).astype(np.float32)
    if spread:  # block scales over two decades: eps has work to do
        s = 10.0 ** (-2 * rng.rand(m // BS, k // BS))
        a *= np.repeat(np.repeat(s, BS, 0), BS, 1).astype(np.float32)
    am = bm = None
    if fill < 1.0:
        am = rng.rand(m // BS, k // BS) < fill
        bm = rng.rand(k // BS, n // BS) < fill
        am[0, 0] = bm[0, 0] = True  # keep the product non-empty
        a *= np.repeat(np.repeat(am, BS, 0), BS, 1)
        b *= np.repeat(np.repeat(bm, BS, 0), BS, 1)

    def norms(x):
        r, c = x.shape[0] // BS, x.shape[1] // BS
        return np.sqrt((x.reshape(r, BS, c, BS).astype(np.float64) ** 2)
                       .sum(axis=(1, 3))).astype(np.float32)

    return a, b, am, bm, norms(a), norms(b)


def _gap_eps(an, bn, am, bm):
    """An eps in the widest gap between two norm products near the
    median of the present triples, so no product sits at eps."""
    am = np.ones(an.shape, bool) if am is None else am
    bm = np.ones(bn.shape, bool) if bm is None else bm
    prod = (an[:, :, None] * bn[None]).astype(np.float64)
    srt = np.sort(prod[am[:, :, None] & bm[None]])
    mid = srt.size // 2
    lo, hi = max(mid - srt.size // 4, 1), min(mid + srt.size // 4,
                                             srt.size - 1)
    i = lo - 1 + int(np.argmax(srt[lo:hi] / srt[lo - 1:hi - 1]))
    return float(np.sqrt(srt[i] * srt[i + 1]))


_REFERENCE = r"""
import json
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.core.blocking import GridSpec
from repro.core.multiply import distributed_matmul
from repro.core import dbcsr

cases = json.load(open(WORK + "/cases.json"))
data = np.load(WORK + "/inputs.npz")
out = {}
for key, c in cases.items():
    shape, axes = MESHES[c["mesh"]]
    mesh = make_mesh(tuple(shape), tuple(axes))
    grid = GridSpec(*c["grid"])
    g = lambda name: data[key + ":" + name] if key + ":" + name in data \
        else None
    kw = dict(c["kw"])
    if kw.get("densify") is False:
        kw["local_kernel"] = "ref"   # the smm kernel's plain version
    for name in ("a_mask", "b_mask", "a_norms", "b_norms"):
        kw[name] = g(name)
    if c.get("batched"):
        reqs = []
        for i in range(c["batched"]):
            am = g(f"am{i}")
            ja = dbcsr.create(g(f"a{i}"), mesh=mesh, grid=grid,
                              block_size=16, block_mask=am)
            jb = dbcsr.create(g(f"b{i}"), mesh=mesh, grid=grid,
                              block_size=16)
            reqs.append((ja, jb))
        res = dbcsr.multiply_batched(
            reqs, mesh=mesh, fused=True, algorithm=kw["algorithm"],
            densify=kw["densify"], pipeline_depth=1,
            local_kernel=kw.get("local_kernel"))
        out[key] = np.stack([np.asarray(r.data) for r in res])
        continue
    # jitted, as the JAX package's own distributed tests run it: one
    # program instead of one dispatch per primitive and device
    f = jax.jit(lambda a, b, kw=kw: distributed_matmul(
        a, b, mesh=mesh, grid=grid, block_m=16, block_k=16, block_n=16,
        **kw))
    C = f(jnp.asarray(g("a")), jnp.asarray(g("b")))
    out[key] = np.asarray(C)
np.savez(WORK + "/reference.npz", **out)
print("ok", len(out))
"""

BATCHED = [("cannon", "2x2"), ("summa", "2x2"), ("summa", "2x4")]
BATCHED_IDS = [f"{a}-{m}" for a, m in BATCHED]
BATCHED_SHAPE = (64, 64, 64)   # four products, fills 1, 1, 0.5, 0.05


def _batched_operands(seed):
    ops = [_operands(BATCHED_SHAPE, f, seed + i)
           for i, f in enumerate((1.0, 1.0, 0.5, 0.05))]
    return ops


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Write every case's operands, run the JAX package on them in one
    8-device subprocess, and return (inputs, outputs) by case key."""
    work = str(tmp_path_factory.mktemp("distributed"))
    cases, inputs = {}, {}

    def put(key, **arrays):
        for name, x in arrays.items():
            if x is not None:
                inputs[f"{key}:{name}"] = x

    for i, (tag, algo, kw, m, shape, fill, path) in enumerate(BATTERY):
        key = BATTERY_IDS[i]
        a, b, am, bm, _, _ = _operands(shape, fill, i)
        put(key, a=a, b=b, a_mask=am, b_mask=bm)
        cases[key] = {"mesh": m, "grid": list(_grid_names(m)),
                      "kw": dict(algorithm=algo, **PATHS[path], **kw)}
    for i, (tag, algo, kw, m, shape, eps) in enumerate(EPS):
        key = EPS_IDS[i]
        twin = EPS.index((tag, algo, kw, m, shape, "gap")) \
            if eps == "gap-default" else i
        a, b, am, bm, an, bn = _operands(shape, 0.5, 500 + twin,
                                         spread=True)
        put(key, a=a, b=b, a_mask=am, b_mask=bm, a_norms=an, b_norms=bn)
        e = 0.0 if eps == "zero" else _gap_eps(an, bn, am, bm)
        ckw = dict(algorithm=algo, densify=False, filter_eps=e, **kw)
        if eps == "gap":
            ckw["rank_exact"] = False
        cases[key] = {"mesh": m, "grid": list(_grid_names(m)),
                      "kw": ckw}
    for i, (algo, m) in enumerate(BATCHED):
        key = "batched-" + BATCHED_IDS[i]
        for j, (a, b, am, _, _, _) in enumerate(_batched_operands(700 + i)):
            put(key, **{f"a{j}": a, f"b{j}": b, f"am{j}": am})
        cases[key] = {"mesh": m, "grid": list(_grid_names(m)),
                      "kw": dict(algorithm=algo, densify=False),
                      "batched": 4}
    json.dump(cases, open(os.path.join(work, "cases.json"), "w"))
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    code = f"MESHES = {MESHES!r}\nWORK = {work!r}\n" + _REFERENCE
    run_subprocess_devices(code, n_devices=8, timeout=600)
    return cases, inputs, dict(np.load(os.path.join(work,
                                                    "reference.npz")))


def _mesh(m):
    return make_mesh(*MESHES[m], device="cpu")


def _port(reference, key, m):
    cases, inputs, _ = reference
    kw = dict(cases[key]["kw"])
    for name in ("a_mask", "b_mask", "a_norms", "b_norms"):
        kw[name] = inputs.get(f"{key}:{name}")
    return distributed_matmul(
        torch.tensor(inputs[key + ":a"]), torch.tensor(inputs[key + ":b"]),
        mesh=_mesh(m), grid=_grid(m), block_m=BS, block_k=BS, block_n=BS,
        **kw)


@pytest.mark.parametrize("key", BATTERY_IDS)
def test_battery_matches_jax(reference, key):
    got = _port(reference, key, BATTERY_MESH[key])
    want = reference[2][key]
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("key", EPS_IDS)
def test_eps_matches_jax(reference, key):
    """eps 0 (the reference's rank-exact default, bitwise its union),
    eps > 0 on the union plan (``rank_exact=False`` both sides) and
    eps > 0 rank-exact (the default both sides)."""
    got = _port(reference, key, EPS[EPS_IDS.index(key)][3])
    np.testing.assert_allclose(got.numpy(), reference[2][key], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("algo, m", BATCHED, ids=BATCHED_IDS)
def test_multiply_batched_matches_jax_and_is_bitwise_looped(reference, algo,
                                                            m):
    """``dbcsr.multiply_batched`` on a multi-rank mesh, fused: allclose
    to the reference's fused batch, bitwise the port's looped one."""
    _, inputs, ref = reference
    key = "batched-" + BATCHED_IDS[BATCHED.index((algo, m))]
    mesh, grid = _mesh(m), _grid(m)
    reqs = []
    for j in range(4):
        am = inputs.get(f"{key}:am{j}")
        reqs.append((dbcsr.create(inputs[f"{key}:a{j}"], mesh=mesh, grid=grid,
                                  block_size=BS, block_mask=am),
                     dbcsr.create(inputs[f"{key}:b{j}"], mesh=mesh, grid=grid,
                                  block_size=BS)))
    kw = dict(mesh=mesh, algorithm=algo, densify=False, pipeline_depth=1)
    fused = dbcsr.multiply_batched(reqs, fused=True, **kw)
    looped = dbcsr.multiply_batched(reqs, fused=False, **kw)
    for j, (f, lo) in enumerate(zip(fused, looped)):
        assert torch.equal(f.data, lo.data), j
        np.testing.assert_allclose(f.data.numpy(), ref[key][j], rtol=RTOL,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# bitwise contracts inside the port
# ---------------------------------------------------------------------------

DEPTH_ALGOS = [("cannon", {}, "2x2", (64, 96, 64)),
               ("cannon25d", {"reduce": "all_reduce"}, "2x2x2", (64, 64, 64)),
               ("summa", {"bcast": "psum"}, "3x2", (96, 96, 64)),
               ("ts_k", {"reduce": "reduce_scatter"}, "2x2x2", (32, 128, 48))]
DEPTH_IDS = [_tag(a, kw, m) for a, kw, m, _ in DEPTH_ALGOS]


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("algo, kw, m, shape", DEPTH_ALGOS, ids=DEPTH_IDS)
def test_pipeline_depths_bitwise(algo, kw, m, shape, path):
    """Depth 1 (serial) == depth 2 (overlap order) == depth 0 (rolled
    where the schedule has a rolled spec, else depth 1), bit for bit."""
    a, b, am, bm, _, _ = _operands(shape, 0.5, 31)
    args = (torch.tensor(a), torch.tensor(b))
    call = dict(mesh=_mesh(m), grid=_grid(m), algorithm=algo, block_m=BS,
                block_k=BS, block_n=BS, a_mask=am, b_mask=bm, **PATHS[path],
                **kw)
    base = distributed_matmul(*args, pipeline_depth=1, **call)
    for depth in (0, 2):
        assert torch.equal(distributed_matmul(*args, pipeline_depth=depth,
                                              **call), base), depth


@pytest.mark.parametrize("algo, kw, m, shape", DEPTH_ALGOS, ids=DEPTH_IDS)
def test_eps_zero_is_bitwise_unfiltered(algo, kw, m, shape):
    a, b, am, bm, an, bn = _operands(shape, 0.5, 32)
    args = (torch.tensor(a), torch.tensor(b))
    call = dict(mesh=_mesh(m), grid=_grid(m), algorithm=algo, densify=False,
                block_m=BS, block_k=BS, block_n=BS, a_mask=am, b_mask=bm,
                **kw)
    plain = distributed_matmul(*args, **call)
    zero = distributed_matmul(*args, a_norms=an, b_norms=bn, filter_eps=0.0,
                              **call)
    assert torch.equal(plain, zero)


@pytest.mark.parametrize("ranks", [1, 4, 8])
@pytest.mark.parametrize("fill", [1.0, 0.3])
def test_rank_stacked_blocked_step_is_a_per_rank_loop(ranks, fill):
    """One plan over R rank blocks (one launch per bin and rank on views)
    == the same executor on each rank's block alone, bitwise."""
    rng = np.random.RandomState(ranks)
    m, k, n = 48, 64, 32
    pm = rng.rand(m // BS, k // BS, n // BS) < fill
    f = stack_executor(m, k, n, block_m=BS, block_k=BS, block_n=BS,
                       stack_size=5, pair_mask=pm)
    a = torch.tensor(rng.randn(ranks, m, k).astype(np.float32))
    b = torch.tensor(rng.randn(ranks, k, n).astype(np.float32))
    got = f(a, b)
    assert tuple(got.shape) == (ranks, m, n)
    for r in range(ranks):
        assert torch.equal(got[r], f(a[r], b[r])), r


def test_one_rank_mesh_gives_the_bits_of_a_plain_multiply():
    """R = 1: the rank axis is a view, and each local path makes the
    call it makes without one."""
    a, b, am, bm, _, _ = _operands((64, 96, 64), 0.5, 33)
    ta, tb = torch.tensor(a), torch.tensor(b)
    mesh = _mesh("1x1")
    c = distributed_matmul(ta, tb, mesh=mesh, algorithm="cannon",
                           densify=True)
    assert torch.equal(c, torch.matmul(ta, tb))
    c = distributed_matmul(ta, tb, mesh=mesh, algorithm="cannon",
                           densify=False, block_m=BS, block_k=BS, block_n=BS,
                           stack_size=7)
    f = stack_executor(64, 96, 64, block_m=BS, block_k=BS, block_n=BS,
                       stack_size=7)
    assert torch.equal(c, f(ta, tb))


@pytest.mark.parametrize("axes", [("pod", "data", "model"),
                                  ("data", "model", "pod"),
                                  ("data", "pod", "model")])
@pytest.mark.parametrize("reduce", ["all_reduce", "reduce_scatter"])
def test_cannon25d_right_in_every_mesh_axis_order(axes, reduce):
    """The 2.5D skew's flat index runs over (stack, row, col) in that
    order whatever the mesh's.  (The JAX package's jax.lax.ppermute
    flattens in the mesh's order, so its product is wrong unless the
    stack axis comes first: ROADMAP Queue C.)"""
    a, b, _, _, _, _ = _operands((64, 64, 64), 1.0, 34)
    mesh = make_mesh((2, 2, 2), axes, device="cpu")
    c = distributed_matmul(torch.tensor(a), torch.tensor(b), mesh=mesh,
                           grid=GridSpec("data", "model", "pod"),
                           algorithm="cannon25d", reduce=reduce,
                           densify=False, block_m=BS, block_k=BS, block_n=BS)
    np.testing.assert_allclose(c.numpy(), a @ b, rtol=RTOL, atol=ATOL)


def test_batched_summa_fused_is_bitwise_looped_on_ranks():
    mesh, grid = _mesh("3x2"), _grid("3x2")
    ops = [_operands((96, 96, 64), f, 40 + i)
           for i, f in enumerate((1.0, 0.5, 0.3))]
    a = torch.stack([torch.tensor(o[0]) for o in ops])
    b = torch.stack([torch.tensor(o[1]) for o in ops])
    kw = dict(mesh=mesh, grid=grid, algorithm="summa", densify=False,
              block_m=BS, block_k=BS, block_n=BS, pipeline_depth=1)
    fused = distributed_matmul_batched(a, b, a_masks=[o[2] for o in ops],
                                       b_masks=[o[3] for o in ops], **kw)
    for g, o in enumerate(ops):
        one = distributed_matmul(a[g], b[g], a_mask=o[2], b_mask=o[3], **kw)
        assert torch.equal(fused[g], one), g


@pytest.mark.parametrize("m", ["2x2", "2x4"])
def test_service_summa_on_ranks_is_bitwise_the_fused_batch(m):
    """``MultiplyService(algorithm="summa")`` on a multi-rank mesh: one
    fused dispatch, bit for bit ``multiply_batched``'s fused products,
    within tolerance of the global product."""
    from repro_torch.serve import MultiplyService

    mesh, grid = _mesh(m), _grid(m)
    reqs = []
    for i, fill in enumerate((1.0, 1.0, 0.5)):
        a, b, am, _, _, _ = _operands((64, 128, 64), fill, 50 + i)
        reqs.append((dbcsr.create(a, mesh=mesh, grid=grid, block_size=BS,
                                  block_mask=am),
                     dbcsr.create(b, mesh=mesh, grid=grid, block_size=BS)))
    kw = dict(algorithm="summa", densify=False, pipeline_depth=1)
    svc = MultiplyService(mesh, fused=True, max_batch=8, slo_s=60.0, **kw)
    tickets = [svc.submit(a, b) for a, b in reqs]
    svc.flush()
    served = [svc.result(t) for t in tickets]
    st = svc.stats()
    assert st["n_fused_requests"] == len(reqs) and not st["n_error_tickets"]
    fused = dbcsr.multiply_batched(reqs, mesh=mesh, fused=True, **kw)
    for x, y, (a, b) in zip(served, fused, reqs):
        assert torch.equal(x.data, y.data)
        np.testing.assert_allclose(x.data.numpy(),
                                   a.data.numpy() @ b.data.numpy(),
                                   rtol=RTOL, atol=ATOL)


def test_schedules_move_bytes_between_ranks():
    a, b, _, _, _, _ = _operands((64, 64, 64), 1.0, 35)
    mesh = _mesh("2x2")
    distributed_matmul(torch.tensor(a), torch.tensor(b), mesh=mesh,
                       algorithm="cannon")
    # skew: the ranks off the diagonal of A's and B's skews receive,
    # then one shift of both (2 steps): 32^2 f32 blocks
    blk = 32 * 32 * 4
    assert mesh.traffic["ppermute"] == 2 * 2 * blk + 2 * 4 * blk
    mesh.reset_traffic()
    distributed_matmul(torch.tensor(a), torch.tensor(b), mesh=mesh,
                       algorithm="summa", bcast="gather")
    assert mesh.traffic == {"ppermute": 0, "psum": 0, "psum_scatter": 0,
                            "all_gather": 2 * 4 * blk}


# ---------------------------------------------------------------------------
# copied host step builders: byte-equal to the reference's
# ---------------------------------------------------------------------------

def _masks(rng, nbr, nbk, nbc, fill):
    return rng.rand(nbr, nbk) < fill, rng.rand(nbk, nbc) < fill


def _norms(rng, mask):
    return np.where(mask, rng.rand(*mask.shape).astype(np.float32) * 3,
                    np.float32(0))


def _same(x, y):
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype and x.shape == y.shape
    assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("pg,c_repl", [(2, 1), (4, 1), (4, 2), (3, 1)])
@pytest.mark.parametrize("fill", [1.0, 0.4, 0.1])
def test_cannon_step_builders_byte_equal(pg, c_repl, fill):
    from repro.core import cannon as jcannon

    from repro_torch.core import cannon

    rng = np.random.RandomState(pg * 10 + c_repl + int(fill * 10))
    am, bm = _masks(rng, pg * 2, pg * 3, pg * 2, fill)
    an, bn = _norms(rng, am), _norms(rng, bm)
    for got, want in zip(cannon.cannon_step_masks(am, bm, pg, c_repl),
                         jcannon.cannon_step_masks(am, bm, pg, c_repl)):
        _same(got, want)
    for got, want in zip(cannon.cannon_step_norms(an, bn, pg, c_repl),
                         jcannon.cannon_step_norms(an, bn, pg, c_repl)):
        _same(got, want)
    assert len(cannon.cannon_step_masks(am, bm, pg, c_repl)) == pg // c_repl


@pytest.mark.parametrize("pr,pc", [(2, 2), (4, 1), (2, 4), (3, 2)])
@pytest.mark.parametrize("fill", [1.0, 0.4, 0.1])
def test_summa_step_builders_byte_equal(pr, pc, fill):
    from repro.core import summa as jsumma

    from repro_torch.core import summa

    rng = np.random.RandomState(pr * 10 + pc + int(fill * 10))
    n_panels = summa.summa_n_panels(pr, pc)
    assert n_panels == jsumma.summa_n_panels(pr, pc)
    am, bm = _masks(rng, pr * 2, n_panels * 2, pc * 2, fill)
    an, bn = _norms(rng, am), _norms(rng, bm)
    for fn, args in (("summa_step_masks", (am, bm, pr, pc, n_panels)),
                     ("summa_step_norms", (an, bn, pr, pc, n_panels))):
        for (ga, gb), (wa, wb) in zip(getattr(summa, fn)(*args),
                                      getattr(jsumma, fn)(*args)):
            _same(ga, wa)
            _same(gb, wb)
    for fn, args in (("summa_gather_masks", (am, bm, pr, pc)),
                     ("summa_gather_norms", (an, bn, pr, pc))):
        for got, want in zip(getattr(summa, fn)(*args),
                             getattr(jsumma, fn)(*args)):
            _same(got, want)


@pytest.mark.parametrize("mode", ["ts_k", "ts_m", "ts_n"])
@pytest.mark.parametrize("fill", [1.0, 0.3])
@pytest.mark.parametrize("p_all", [4, 8])
def test_ts_step_builders_byte_equal(mode, fill, p_all):
    from repro.core import tall_skinny as jts

    from repro_torch.core import tall_skinny as ts

    rng = np.random.RandomState(p_all + int(fill * 10) + len(mode))
    big = {"ts_k": (2, p_all * 2, 3), "ts_m": (p_all * 2, 3, 2),
           "ts_n": (2, 3, p_all * 2)}[mode]
    am, bm = _masks(rng, *big, fill)
    an, bn = _norms(rng, am), _norms(rng, bm)
    for fn, args in (("ts_step_masks", (mode, am, bm, p_all)),
                     ("ts_step_norms", (mode, an, bn, p_all))):
        got, want = getattr(ts, fn)(*args), getattr(jts, fn)(*args)
        assert sorted(got) == sorted(want)
        for key in want:
            _same(got[key], want[key])


def test_classify_shape_matches_jax():
    from repro.core import tall_skinny as jts

    from repro_torch.core import tall_skinny as ts

    from repro_torch.planner.calibrate import get_hardware_model
    from repro_torch.planner.cost_model import ts_crossover_ratio

    # the ratio is the planner's crossover under the port's constants
    ratio = ts.ts_classify_ratio()
    assert ratio == ts_crossover_ratio(get_hardware_model())
    assert ts.DEFAULT_TS_RATIO == 8.0
    for shape in [(1408, 1982464, 1408), (4096, 4096, 4096), (100, 800, 99),
                  (100, 799, 100), (64000, 64, 64), (64, 64, 64000),
                  (640, 64, 64)]:
        for r in (ratio, ts.DEFAULT_TS_RATIO):
            assert ts.classify_shape(*shape, ratio=r) == jts.classify_shape(
                *shape, ratio=r), shape
        assert ts.classify_shape(*shape) == jts.classify_shape(
            *shape, ratio=ratio), shape
