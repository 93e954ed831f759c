"""``precision=`` on the distributed multiply (``repro_torch.core.precision``)
against the JAX package's ``precision=jax.lax.Precision.X``, on the CPU.

The JAX package passes ``precision`` to XLA's dot only; on its test
platform, the CPU, every ``Precision`` computes in f32, and so does the
port on the CPU, whatever the name (the TF32 and bf16 modes apply on the
card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py``).  So the
port's ``"default"`` and ``"highest"`` are held to the reference's
``DEFAULT`` and ``HIGHEST`` at the fp32 tolerance of
``test_torch_distributed.py`` (1e-5 relative, 1e-4 absolute on
~N(0, 1) products summed over k <= 128 in different orders), for
Cannon, SUMMA, the tall-skinny variants on 1x1 and 2x2, 2.5D on 2x2x2,
and the batched multiply on 1x1 and 2x2.  The reference runs once, in
one subprocess with 8 host devices, started with the module's first
test and read by its last ones.

Inside the port, bitwise: None == "highest" (in any case, or an object
whose ``.name`` says so) == the product of the local multiply the port
had before ``precision`` (``torch.matmul`` / ``torch.bmm`` with TF32
off); the blocked and ``pallas`` paths the same for every name.  The
caller's float32 matmul settings are unchanged after every call,
including one that raises, and a bad name raises ``ValueError``.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import SRC
from torch_threads import one_thread  # noqa: F401

from repro_torch.core import precision as P
from repro_torch.core.blocking import GridSpec
from repro_torch.core.cannon import cannon_matmul
from repro_torch.core.cannon25d import cannon25d_matmul
from repro_torch.core.densify import (densified_local_matmul,
                                      grouped_densified_local_matmul)
from repro_torch.core.multiply import distributed_matmul
from repro_torch.core.multiply_batched import distributed_matmul_batched
from repro_torch.core.summa import summa_matmul
from repro_torch.core.tall_skinny import tall_skinny_matmul
from repro_torch.launch.mesh import make_mesh

RTOL, ATOL = 1e-5, 1e-4
BS = 16
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}
GRIDS = {"1x1": ("data", "model", None), "2x2": ("data", "model", None),
         "2x2x2": ("data", "model", "pod")}
# (algorithm, extra kwargs, mesh, (m, k, n))
ALGOS = [
    ("cannon", {}, "1x1", (64, 96, 64)),
    ("cannon", {}, "2x2", (64, 96, 64)),
    ("summa", {"bcast": "psum"}, "1x1", (64, 64, 64)),
    ("summa", {"bcast": "psum"}, "2x2", (64, 64, 64)),
    ("summa", {"bcast": "gather"}, "2x2", (64, 64, 64)),
    ("ts_k", {"reduce": "all_reduce"}, "1x1", (32, 128, 48)),
    ("ts_k", {"reduce": "reduce_scatter"}, "2x2", (32, 128, 48)),
    ("ts_m", {}, "2x2", (128, 32, 48)),
    ("ts_n", {}, "2x2", (32, 48, 128)),
    ("cannon25d", {"reduce": "all_reduce"}, "2x2x2", (64, 64, 64)),
    ("cannon25d", {"reduce": "reduce_scatter"}, "2x2x2", (64, 64, 64)),
]
ALGO_IDS = ["-".join([a, *map(str, kw.values()), m]) for a, kw, m, _ in ALGOS]
BATCHED = [("cannon", "1x1"), ("cannon", "2x2"), ("summa", "2x2")]
BATCHED_IDS = [f"batched-{a}-{m}" for a, m in BATCHED]
BATCHED_SHAPE = (3, 64, 64, 64)
NAMES = ("DEFAULT", "HIGHEST")

_REFERENCE = r"""
import json
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.core.blocking import GridSpec
from repro.core.multiply import distributed_matmul
from repro.core.multiply_batched import distributed_matmul_batched

cases = json.load(open(WORK + "/cases.json"))
data = np.load(WORK + "/inputs.npz")
out = {}
for key, c in cases.items():
    shape, axes = MESHES[c["mesh"]]
    mesh = make_mesh(tuple(shape), tuple(axes))
    grid = GridSpec(*c["grid"])
    fn = distributed_matmul_batched if c["batched"] else distributed_matmul
    for name in NAMES:
        prec = getattr(jax.lax.Precision, name)
        f = jax.jit(lambda a, b, kw=c["kw"], prec=prec: fn(
            a, b, mesh=mesh, grid=grid, algorithm=c["algorithm"],
            densify=True, precision=prec, block_m=16, block_k=16,
            block_n=16, **kw))
        out[key + ":" + name] = np.asarray(
            f(jnp.asarray(data[key + ":a"]), jnp.asarray(data[key + ":b"])))
np.savez(WORK + "/reference.npz", **out)
print("ok", len(out))
"""


def _operands(shape, seed):
    rng = np.random.RandomState(seed)
    *g, m, k, n = shape
    return (rng.randn(*g, m, k).astype(np.float32),
            rng.randn(*g, k, n).astype(np.float32))


def _cases():
    cases, inputs = {}, {}
    for i, (algo, kw, m, shape) in enumerate(ALGOS):
        key = ALGO_IDS[i]
        inputs[key + ":a"], inputs[key + ":b"] = _operands(shape, i)
        cases[key] = {"algorithm": algo, "kw": kw, "mesh": m,
                      "grid": list(GRIDS[m]), "batched": False}
    for i, (algo, m) in enumerate(BATCHED):
        key = BATCHED_IDS[i]
        inputs[key + ":a"], inputs[key + ":b"] = _operands(BATCHED_SHAPE,
                                                           100 + i)
        cases[key] = {"algorithm": algo, "kw": {}, "mesh": m,
                      "grid": list(GRIDS[m]), "batched": True}
    return cases, inputs


@pytest.fixture(scope="module")
def reference_proc(tmp_path_factory):
    """Write the operands and start the JAX package on them in one
    8-device subprocess; the comparison tests wait for it."""
    work = str(tmp_path_factory.mktemp("precision"))
    cases, inputs = _cases()
    with open(os.path.join(work, "cases.json"), "w") as f:
        json.dump(cases, f)
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    code = (f"MESHES = {MESHES!r}\nWORK = {work!r}\nNAMES = {NAMES!r}\n"
            + _REFERENCE)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield work, cases, inputs, proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(autouse=True)
def _start_reference(reference_proc):
    """Every test of the module starts the reference with the first."""


@pytest.fixture(scope="module")
def reference(reference_proc):
    work, cases, inputs, proc = reference_proc
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return cases, inputs, dict(np.load(os.path.join(work, "reference.npz")))


def _mesh(m):
    return make_mesh(*MESHES[m], device="cpu")


def _legacy_local_matmul(a, b):
    """The port's default densified local multiply before ``precision``:
    ``torch.matmul`` in f32 with TF32 off for the call."""
    flags = torch.backends.cuda.matmul
    caller = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        return torch.matmul(a.to(torch.float32), b.to(torch.float32))
    finally:
        flags.allow_tf32 = caller


class _Named:
    """An object carrying a precision by its ``.name``, as an enum does."""

    def __init__(self, name):
        self.name = name


def _state():
    """The caller's float32 matmul settings, as torch states them."""
    def read(fn):
        try:
            return fn()
        except RuntimeError as e:
            return type(e)
    flags = torch.backends.cuda.matmul
    return (read(torch.get_float32_matmul_precision),
            read(lambda: flags.allow_tf32),
            flags.allow_bf16_reduced_precision_reduction,
            tuple(x.fp32_precision for x in P._matmul_backends()))


@pytest.fixture(params=["highest", "high", "medium"])
def caller(request):
    """The test runs under the caller's ``set_float32_matmul_precision``;
    the process's own setting comes back after it."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(request.param)
    yield _state()
    torch.set_float32_matmul_precision(before)


# ---- the names ---------------------------------------------------------

@pytest.mark.parametrize("given, want", [
    (None, None), ("default", "default"), ("HIGH", "high"),
    ("Highest", "highest"), (jax.lax.Precision.DEFAULT, "default"),
    (jax.lax.Precision.HIGH, "high"), (jax.lax.Precision.HIGHEST, "highest"),
    (_Named("hIgH"), "high")])
def test_resolve_precision_takes_the_jax_names(given, want):
    assert P.resolve_precision(given) == want


@pytest.mark.parametrize("bad", ["fastest", "bfloat16", "", 3, 1.0,
                                 _Named("float32"), _Named(None),
                                 (jax.lax.Precision.HIGH,) * 2])
def test_bad_precision_raises_value_error(bad):
    a, b = (torch.tensor(x) for x in _operands((32, 32, 32), 0))
    mesh = _mesh("1x1")
    with pytest.raises(ValueError, match="precision"):
        P.resolve_precision(bad)
    # every entry point refuses it, on every local path, before any work
    for kw in (dict(densify=True), dict(densify=False, block_m=BS,
                                        block_k=BS, block_n=BS),
               dict(densify=True, local_kernel="pallas")):
        with pytest.raises(ValueError, match="precision"):
            distributed_matmul(a, b, mesh=mesh, algorithm="cannon",
                               precision=bad, **kw)
        with pytest.raises(ValueError, match="precision"):
            distributed_matmul_batched(a[None], b[None], mesh=mesh,
                                       algorithm="cannon", precision=bad,
                                       **kw)
    for make in (densified_local_matmul, grouped_densified_local_matmul):
        with pytest.raises(ValueError, match="precision"):
            make(bad)
    with pytest.raises(ValueError, match="precision"):
        cannon_matmul(a, b, mesh=mesh, precision=bad)


# ---- inside the port, bitwise -------------------------------------------

_SCHEDULES = {"cannon": cannon_matmul, "summa": summa_matmul,
              "cannon25d": cannon25d_matmul}


def _schedule(algo, a, b, mesh, m, **kw):
    grid = GridSpec(*GRIDS[m])
    if algo.startswith("ts_"):
        return tall_skinny_matmul(a, b, mesh=mesh, grid=grid, mode=algo,
                                  **kw)
    return _SCHEDULES[algo](a, b, mesh=mesh, grid=grid, **kw)


@pytest.mark.parametrize("i", range(len(ALGOS)), ids=ALGO_IDS)
def test_none_and_highest_are_bitwise_the_legacy_product(i):
    """Through ``distributed_matmul`` and through the schedule itself:
    None, "highest", "HIGHEST", ``Precision.HIGHEST`` and a ``.name`` of
    "highest" give the bits of the schedule run on the local multiply
    the port had before ``precision``; on the CPU "high" and "default"
    give them too (IEEE f32 for every name, as XLA's CPU dot)."""
    algo, kw, m, shape = ALGOS[i]
    a, b = (torch.tensor(x) for x in _operands(shape, i))
    mesh = _mesh(m)
    want = _schedule(algo, a, b, mesh, m, local_matmul=_legacy_local_matmul,
                     **kw)
    for prec in (None, "highest", "HIGHEST", jax.lax.Precision.HIGHEST,
                 _Named("highest"), "high", "default"):
        got = distributed_matmul(a, b, mesh=mesh, grid=GridSpec(*GRIDS[m]),
                                 algorithm=algo, densify=True,
                                 precision=prec, **kw)
        assert torch.equal(got, want), prec
        assert torch.equal(_schedule(algo, a, b, mesh, m, precision=prec,
                                     **kw), want), prec


@pytest.mark.parametrize("path", ["blocked", "pallas"])
@pytest.mark.parametrize("m", ["1x1", "2x2"])
def test_blocked_and_pallas_ignore_precision(path, m):
    """The smm and tiled_matmul / grouped_gemm paths take no precision,
    as the JAX package's Pallas kernels: the same bits for every name,
    single and batched."""
    kw = (dict(densify=False, block_m=BS, block_k=BS, block_n=BS)
          if path == "blocked" else dict(densify=True, local_kernel="pallas"))
    mesh = _mesh(m)
    a, b = (torch.tensor(x) for x in _operands((64, 64, 64), 7))
    ab, bb = (torch.tensor(x) for x in _operands(BATCHED_SHAPE, 8))
    for algo in ("cannon", "summa"):
        want = distributed_matmul(a, b, mesh=mesh, algorithm=algo, **kw)
        want_b = distributed_matmul_batched(ab, bb, mesh=mesh,
                                            algorithm=algo, **kw)
        for prec in ("default", "high", "highest", jax.lax.Precision.HIGH):
            assert torch.equal(distributed_matmul(
                a, b, mesh=mesh, algorithm=algo, precision=prec, **kw), want)
            assert torch.equal(distributed_matmul_batched(
                ab, bb, mesh=mesh, algorithm=algo, precision=prec, **kw),
                want_b)


@pytest.mark.parametrize("m", ["1x1", "2x2"])
@pytest.mark.parametrize("algo", ["cannon", "summa"])
def test_batched_none_and_highest_are_bitwise_the_legacy_product(algo, m):
    """The batched densified path: every name gives the bits of the
    grouped local multiply the port had before ``precision`` (``torch.bmm``
    in f32, TF32 off: ``grouped_gemm_ref``)."""
    from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref

    def legacy(x, y):
        lead = tuple(x.shape[:-2])
        out = grouped_gemm_ref(x.reshape((-1,) + tuple(x.shape[-2:])),
                               y.reshape((-1,) + tuple(y.shape[-2:])))
        return out.reshape(lead + tuple(out.shape[-2:]))

    mesh = _mesh(m)
    a, b = (torch.tensor(x) for x in _operands(BATCHED_SHAPE, 9))
    run = cannon_matmul if algo == "cannon" else summa_matmul
    want = run(a, b, mesh=mesh, local_matmul=legacy)
    for prec in (None, "highest", jax.lax.Precision.HIGHEST, "high",
                 "default"):
        got = distributed_matmul_batched(a, b, mesh=mesh, algorithm=algo,
                                         densify=True, precision=prec)
        assert torch.equal(got, want), prec


def test_caller_settings_survive_every_call(caller):
    """After each multiply, for every name and path, and after calls that
    raise (a bad name; a shape error inside the GEMM), the caller's
    ``get_float32_matmul_precision()``, ``allow_tf32``, bf16 reduction
    flag and per-backend settings are what they were; so is the CPU
    product, IEEE f32 under any caller."""
    mesh = _mesh("2x2")
    a, b = (torch.tensor(x) for x in _operands((64, 64, 64), 11))
    ab, bb = (torch.tensor(x) for x in _operands(BATCHED_SHAPE, 12))
    # the IEEE products, taken at "highest" (under a caller's "medium" the
    # CPU's oneDNN matmul rounds to bf16: the legacy local multiply, which
    # turned off only cuBLAS's TF32, gave bf16 products there)
    torch.set_float32_matmul_precision("highest")
    want = _schedule("cannon", a, b, mesh, "2x2",
                     local_matmul=_legacy_local_matmul)
    want_1 = a @ b
    torch.set_float32_matmul_precision(caller[0])
    for prec in (None, "default", "high", "highest"):
        c = distributed_matmul(a, b, mesh=mesh, algorithm="cannon",
                               densify=True, precision=prec)
        assert torch.equal(c, want)
        assert _state() == caller
        distributed_matmul_batched(ab, bb, mesh=mesh, algorithm="summa",
                                   densify=True, precision=prec)
        assert _state() == caller
        assert torch.equal(densified_local_matmul(prec)(a[None], b[None])[0],
                           want_1)
        assert _state() == caller
        with pytest.raises(RuntimeError):
            densified_local_matmul(prec)(a[None], b[None, :32])
        assert _state() == caller
        with pytest.raises(RuntimeError):
            grouped_densified_local_matmul(prec)(ab[None], bb[None, :, :32])
        assert _state() == caller
    with pytest.raises(ValueError):
        distributed_matmul(a, b, mesh=mesh, algorithm="cannon",
                           precision="fastest")
    assert _state() == caller


def test_backend_settings_apart_survive_a_call():
    """A caller that set cuBLAS's and oneDNN's matmul apart (torch then
    refuses to state one precision) finds both as they were."""
    backends = P._matmul_backends()
    if len(backends) < 2:
        pytest.skip("this torch has no per-backend fp32_precision")
    before = [x.fp32_precision for x in backends]
    a, b = (torch.tensor(x) for x in _operands((32, 32, 32), 13))
    want = a @ b
    try:
        backends[0].fp32_precision = "tf32"
        backends[1].fp32_precision = "bf16"
        state = _state()
        for prec in (None, "high", "default"):
            assert torch.equal(densified_local_matmul(prec)(
                a[None], b[None])[0], want)
            assert _state() == state
    finally:
        for x, v in zip(backends, before):
            x.fp32_precision = v


# ---- against the JAX package (its subprocess) ----------------------------

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("key", ALGO_IDS + BATCHED_IDS)
def test_precision_matches_jax(reference, key, name):
    """The port's ``precision=name.lower()`` against the reference's
    ``precision=jax.lax.Precision.<name>`` on the same operands."""
    cases, inputs, out = reference
    c = cases[key]
    mesh = _mesh(c["mesh"])
    a, b = torch.tensor(inputs[key + ":a"]), torch.tensor(inputs[key + ":b"])
    fn = distributed_matmul_batched if c["batched"] else distributed_matmul
    got = fn(a, b, mesh=mesh, grid=GridSpec(*c["grid"]),
             algorithm=c["algorithm"], densify=True, precision=name.lower(),
             block_m=BS, block_k=BS, block_n=BS, **c["kw"])
    np.testing.assert_allclose(got.numpy(), out[key + ":" + name],
                               rtol=RTOL, atol=ATOL)
