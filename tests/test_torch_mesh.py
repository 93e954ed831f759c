"""The port's mesh (launch/mesh.py) against ``jax.lax`` inside
``shard_map``: every collective the schedules use, and ``shard`` /
``unshard`` against ``jax.device_put`` with a ``NamedSharding`` and
against ``shard_map``'s out-specs, on 2x2, 2x4 and 2x2x2 meshes.

The reference runs once, in one subprocess with 8 host devices (the main
process keeps JAX's one device), on the inputs this module writes; each
case is then one test.  Collectives only move or add f32 values: the
results are held equal, except sums (psum, psum_scatter), which the two
frameworks may add in different orders (rtol 1e-6).

The same cases run on process meshes (``make_process_mesh``: one rank
a process, gloo over a ``FileStore`` under the test's temporary
directory, one spawn of 4 or 8 processes a mesh shape, two at a time,
~10 s), held against the in-process mesh (bitwise for moves,
rtol 1e-6 for sums) and against the same JAX outputs, which run once
for both."""
import datetime
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from conftest import run_subprocess_devices
from torch_threads import one_thread  # noqa: F401

from repro_torch.launch.mesh import make_mesh, make_process_mesh
from repro_torch.launch.processes import run_ranks

PG_TIMEOUT_S = 60       # a process mesh's collectives

MESHES = {
    "2x2": ((2, 2), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}


def _cases(name):
    """(case id, op, kwargs) for one mesh: kwargs name mesh axes."""
    shape, axes = MESHES[name]
    out = []
    for i, a in enumerate(axes):
        s = shape[i]
        out.append((f"ppermute-shift-{a}", "ppermute",
                    dict(axes=a, perm=[[k, (k - 1) % s] for k in range(s)])))
        out.append((f"psum-{a}", "psum", dict(axes=a)))
        out.append((f"psum_scatter-{a}", "psum_scatter", dict(axes=a)))
        out.append((f"all_gather0-{a}", "all_gather", dict(axes=a, axis=0)))
        out.append((f"all_gather1-{a}", "all_gather", dict(axes=a, axis=1)))
        out.append((f"axis_index-{a}", "axis_index", dict(axes=a)))
    row, col = axes[-2], axes[-1]
    pr, pc = shape[-2], shape[-1]
    n = pr * pc
    # the joint-axis flat index follows the order of the axes argument
    for joint in ((row, col), (col, row)):
        tag = "-".join(joint)
        out.append((f"ppermute-joint-{tag}", "ppermute",
                    dict(axes=list(joint),
                         perm=[[k, (3 * k + 1) % n] for k in range(n)])))
        out.append((f"psum-{tag}", "psum", dict(axes=list(joint))))
        out.append((f"psum_scatter-{tag}", "psum_scatter",
                    dict(axes=list(joint))))
        out.append((f"all_gather0-{tag}", "all_gather",
                    dict(axes=list(joint), axis=0)))
        out.append((f"axis_index-{tag}", "axis_index",
                    dict(axes=list(joint))))
    # a partial permutation: ranks no pair sends to receive zeros
    out.append(("ppermute-partial", "ppermute",
                dict(axes=[row, col], perm=[[0, n - 1], [n - 1, 1]])))
    all_axes = list(axes)
    out.append(("psum-all", "psum", dict(axes=all_axes)))
    out.append(("psum_scatter-all", "psum_scatter", dict(axes=all_axes)))
    if len(axes) == 3:
        # 2.5D's skew runs over (stack, row, col), whatever the mesh order
        perm = [[((p * 2 + i) * 2 + (i + j + p) % 2), (p * 2 + i) * 2 + j]
                for p in range(2) for i in range(2) for j in range(2)]
        out.append(("ppermute-stack-row-col", "ppermute",
                    dict(axes=["pod", row, col], perm=perm)))
        out.append(("ppermute-col-stack", "ppermute",
                    dict(axes=[col, "pod"], perm=[[0, 3], [3, 1], [1, 0],
                                                  [2, 2]])))
    # shard / unshard specs; lists are axis tuples, null replicates
    specs = [[row, col], [None, [row, col]], [[row, col], None],
             [None, None], [col, row], [None, row, col]]
    if len(axes) == 3:
        specs += [[[row, "pod"], col], [["pod", row, col], None]]
    for spec in specs:
        tag = json.dumps(spec).replace(" ", "")
        out.append((f"shard-{tag}", "shard", dict(spec=spec)))
        out.append((f"unshard-{tag}", "unshard", dict(spec=spec)))
    return out


CASES = [(m, cid, op, kw) for m in MESHES for cid, op, kw in _cases(m)]
ROWS, COLS = 8, 16      # one rank's block: split 8 ways on either dim


def _spec(spec):
    return tuple(None if s is None else (s if isinstance(s, str) else
                                         tuple(s)) for s in spec)


def _global(m, spec, seed):
    """A global operand a spec can split on the mesh."""
    shape, axes = MESHES[m]
    dims = [ROWS, COLS, 6][:len(spec)]
    size = dict(zip(axes, shape))
    for d, s in enumerate(spec):
        names = [] if s is None else ([s] if isinstance(s, str) else s)
        dims[d] *= int(np.prod([size[a] for a in names]))
    return np.random.RandomState(seed).randn(*dims).astype(np.float32)


_REFERENCE = r"""
import json
import numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh, shard_map

work = WORK
cases = json.load(open(work + "/cases.json"))
inputs = np.load(work + "/inputs.npz")
out = {}
for key, (m, op, kw) in cases.items():
    shape, axes = MESHES[m]
    mesh = make_mesh(tuple(shape), tuple(axes))
    flat = P(tuple(axes))
    x = inputs[key]
    tup = lambda a: a if isinstance(a, str) else tuple(a)
    if op == "shard":
        spec = P(*[None if s is None else tup(s) for s in kw["spec"]])
        arr = jax.device_put(x, NamedSharding(mesh, spec))
        by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        out[key] = np.stack([by_dev[d] for d in mesh.devices.flat])
        continue
    if op == "unshard":
        spec = P(*[None if s is None else tup(s) for s in kw["spec"]])
        f = shard_map(lambda b: b[0], mesh=mesh, in_specs=(flat,),
                      out_specs=spec, check_vma=False)
        out[key] = np.asarray(f(x))
        continue
    axs = tup(kw["axes"])

    def by_index(b, kw=kw, axs=axs):
        # ppermute as jax.lax documents it: the pairs index the flat
        # axis_index of ``axs``, gathered in that same order
        g = jax.lax.all_gather(b[0], axs, tiled=False)
        src = np.full(g.shape[0], -1)
        for s_, d_ in kw["perm"]:
            src[d_] = s_
        me = jax.lax.axis_index(axs)
        s_me = jax.numpy.asarray(src)[me]
        r = jax.numpy.where(s_me >= 0, g[jax.numpy.maximum(s_me, 0)], 0.0)
        return r[None]

    if op == "ppermute":
        f = shard_map(by_index, mesh=mesh, in_specs=(flat,), out_specs=flat,
                      check_vma=False)
        out[key + ":by_index"] = np.asarray(f(x))

    def body(b, op=op, kw=kw, axs=axs):
        b = b[0]
        if op == "ppermute":
            r = jax.lax.ppermute(b, axs, [tuple(p) for p in kw["perm"]])
        elif op == "psum":
            r = jax.lax.psum(b, axs)
        elif op == "psum_scatter":
            r = jax.lax.psum_scatter(b, axs, scatter_dimension=0, tiled=True)
        elif op == "all_gather":
            r = jax.lax.all_gather(b, axs, axis=kw["axis"], tiled=True)
        else:
            r = jax.lax.axis_index(axs).reshape(1)
        return r[None]

    f = shard_map(body, mesh=mesh, in_specs=(flat,), out_specs=flat,
                  check_vma=False)
    out[key] = np.asarray(f(x))
np.savez(work + "/reference.npz", **out)
print("ok", len(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Write every case's input, run the JAX package's mesh on them in
    one 8-device subprocess, and return its outputs by case key."""
    work = str(tmp_path_factory.mktemp("mesh"))
    cases, inputs = {}, {}
    for i, (m, cid, op, kw) in enumerate(CASES):
        key = f"{m}:{cid}"
        cases[key] = (m, op, kw)
        n = int(np.prod(MESHES[m][0]))
        if op == "shard":
            inputs[key] = _global(m, kw["spec"], i)
        elif op == "unshard":
            # rank blocks made by the port's own shard, so replicas agree
            mesh = make_mesh(*MESHES[m], device="cpu")
            x = torch.tensor(_global(m, kw["spec"], i))
            inputs[key] = mesh.shard(x, _spec(kw["spec"])).numpy()
        else:
            inputs[key] = np.random.RandomState(i).randn(
                n, ROWS, COLS).astype(np.float32)
    json.dump(cases, open(os.path.join(work, "cases.json"), "w"))
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    code = (f"MESHES = {MESHES!r}\nWORK = {work!r}\n" + _REFERENCE)
    run_subprocess_devices(code, n_devices=8, timeout=300)
    ref = dict(np.load(os.path.join(work, "reference.npz")))
    return inputs, ref


def _run_op(mesh, op, kw, x):
    """One case's op on ``mesh``: ``x`` is its rank-stacked input (the
    global tensor for ``shard``)."""
    if op == "shard":
        return mesh.shard(x, _spec(kw["spec"]))
    if op == "unshard":
        return mesh.unshard(x, _spec(kw["spec"]))
    axes = kw["axes"] if isinstance(kw["axes"], str) else tuple(kw["axes"])
    if op == "ppermute":
        return mesh.ppermute(x, axes, [tuple(p) for p in kw["perm"]])
    if op == "psum":
        return mesh.psum(x, axes)
    if op == "psum_scatter":
        return mesh.psum_scatter(x, axes, scatter_dimension=0, tiled=True)
    if op == "all_gather":
        return mesh.all_gather(x, axes, axis=kw["axis"], tiled=True)
    return mesh.axis_index(axes).reshape(-1, 1)


def _want(ref, key, m, op, kw):
    want = ref[key]
    if op == "ppermute":
        # the pairs index the flat axis_index of ``axes``, in the order
        # of ``axes``.  jax.lax.ppermute's lowering flattens a joint
        # axis in the mesh's order instead (it sorts each group's device
        # ids), so it agrees only where the two orders agree
        names = [kw["axes"]] if isinstance(kw["axes"], str) else kw["axes"]
        order = MESHES[m][1]
        if [order.index(a) for a in names] != sorted(order.index(a)
                                                     for a in names):
            want = ref[key + ":by_index"]
        else:
            np.testing.assert_array_equal(ref[key + ":by_index"], want)
    return want


def _assert_op_equal(op, got, want):
    assert tuple(got.shape) == want.shape
    if op in ("psum", "psum_scatter"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m, cid, op, kw", CASES,
                         ids=[f"{m}-{cid}" for m, cid, _, _ in CASES])
def test_mesh_matches_jax(reference, m, cid, op, kw):
    inputs, ref = reference
    key = f"{m}:{cid}"
    mesh = make_mesh(*MESHES[m], device="cpu")
    got = _run_op(mesh, op, kw, torch.tensor(inputs[key]))
    _assert_op_equal(op, got.numpy(), _want(ref, key, m, op, kw))


def _process_cases(rank, m, work):
    """One process of a process mesh of shape ``m``: every case of that
    mesh on this rank's row of the input (the whole global tensor for
    ``shard``); returns {case key: this rank's output}."""
    torch.set_num_threads(1)
    mesh = make_process_mesh(
        *MESHES[m], device="cpu",
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    cases = json.load(open(os.path.join(work, "cases.json")))
    inputs = np.load(os.path.join(work, "inputs.npz"))
    out = {}
    for key, (mm, op, kw) in cases.items():
        if mm != m:
            continue
        x = torch.tensor(inputs[key])
        if op != "shard":
            x = x[rank:rank + 1]
        got = _run_op(mesh, op, kw, x)
        out[key] = got.numpy() if op == "unshard" else got[0].numpy()
    return out


@pytest.fixture(scope="module")
def process_outputs(reference, tmp_path_factory):
    """Every case on process meshes: one gloo group a mesh shape, the
    two spawned at a time; returns {case key: per-rank outputs}."""
    inputs, _ = reference
    work = str(tmp_path_factory.mktemp("process_mesh"))
    json.dump({f"{m}:{cid}": (m, op, kw) for m, cid, op, kw in CASES},
              open(os.path.join(work, "cases.json"), "w"))
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    with ThreadPoolExecutor(2) as pool:
        runs = {m: pool.submit(run_ranks, _process_cases,
                               int(np.prod(MESHES[m][0])), store_dir=work,
                               args=(m, work), timeout_s=PG_TIMEOUT_S,
                               join_timeout_s=240)
                for m in MESHES}
        per_mesh = {m: run.result() for m, run in runs.items()}
    return {key: [ranks[r][key] for r in range(len(ranks))]
            for ranks in per_mesh.values() for key in ranks[0]}


@pytest.mark.parametrize("m, cid, op, kw", CASES,
                         ids=[f"{m}-{cid}" for m, cid, _, _ in CASES])
def test_process_mesh_matches_in_process_and_jax(reference, process_outputs,
                                                 m, cid, op, kw):
    """A process mesh against the in-process mesh (bitwise for moves,
    rtol 1e-6 for sums) and the JAX reference; ``unshard`` gives every
    process the same global tensor."""
    inputs, ref = reference
    key = f"{m}:{cid}"
    ranks = process_outputs[key]
    if op == "unshard":
        for r in ranks[1:]:
            np.testing.assert_array_equal(r, ranks[0])
        got = ranks[0]
    else:
        got = np.stack(ranks)
    mesh = make_mesh(*MESHES[m], device="cpu")
    _assert_op_equal(op, got,
                     _run_op(mesh, op, kw, torch.tensor(inputs[key])).numpy())
    _assert_op_equal(op, got, _want(ref, key, m, op, kw))


def test_mesh_counts_traffic_and_keeps_identity():
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    x = torch.ones(4, 3, 5)
    assert mesh.ppermute(x, "model", [(0, 0), (1, 1)]) is x
    assert mesh.psum(x, ()) is x
    assert all(v == 0 for v in mesh.traffic.values())
    mesh.ppermute(x, "model", [(0, 1), (1, 0)])
    assert mesh.traffic["ppermute"] == 4 * 15 * 4   # every rank receives
    mesh.psum(x, "data")                            # 2 (n-1)/n a rank
    assert mesh.traffic["psum"] == 4 * 15 * 4
    mesh.all_gather(x, ("data", "model"), axis=0)   # n - 1 blocks a rank
    assert mesh.traffic["all_gather"] == 4 * 3 * 15 * 4
    mesh.reset_traffic()
    assert all(v == 0 for v in mesh.traffic.values())


def test_mesh_shard_keeps_one_rank_a_view():
    """A 1x1 mesh (R = 1) and a replicated spec add no copy."""
    x = torch.arange(12.0).reshape(3, 4)
    one = make_mesh((1, 1), ("data", "model"), device="cpu")
    s = one.shard(x, ("data", "model"))
    assert s.shape == (1, 3, 4) and s.data_ptr() == x.data_ptr()
    assert one.unshard(s, ("data", "model")).data_ptr() == x.data_ptr()
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    r = mesh.shard(x, (None, None))
    assert r.shape == (4, 3, 4) and r.data_ptr() == x.data_ptr()
    with pytest.raises(ValueError, match="split"):
        mesh.shard(torch.zeros(3, 4), ("data", "model"))
    with pytest.raises(ValueError, match="not an axis"):
        mesh.psum(torch.zeros(4, 2), "pod")


@pytest.mark.parametrize("perm, match", [
    ([(0, 1), (1, 1)], "two pairs"),
    ([(0, 1), (0, 0)], "sends twice"),
    ([(0, 2)], "outside"),
])
def test_ppermute_refuses_a_malformed_permutation(perm, match):
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match=match):
        mesh.ppermute(torch.zeros(4, 3), "model", perm)
