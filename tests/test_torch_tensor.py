"""The port's blocked tensor contractions (repro_torch.tensor,
``dbcsr.contract`` / ``create_tensor``, ``plan_contract``,
``tensor_block_norms``, the tensor example) against the JAX package's
(tests/test_tensor.py mirrored), on the CPU.

* Host-side copies are equal: parse results and error messages on
  every spec of the reference's property sweep, ``enumerate_layouts``,
  ``unfold_grid`` / ``fold_grid`` byte for byte, per-layout
  ``LayoutStats`` (rank imbalance to 1e-12), and ``plan_contract``'s
  choice with one ``HardwareModel`` for both (on 2x2: on one rank the
  port prices no communication, ROADMAP Queue C3).
* ``tensor_block_norms`` to 1e-6 relative (f32 sums of squares of the
  same elements in two orders).
* ``contract`` against the JAX ``contract`` for every layout, on 1x1 in
  process and on 2x2 against one JAX subprocess with 4 host devices
  (started with the module): |port - JAX| <= 2e-5 max(|einsum|, 1), each
  side being within the reference's own 1e-5 of the dense einsum;
  result masks equal.
* Within the port: at a fixed layout ``contract`` is bitwise the
  hand-matricized ``dbcsr.multiply``; eps 0 is bitwise eps None; eps is
  subtractive; ``verify=`` detects, localizes and repairs in the tensor
  frame; rank-exact is bitwise the union on a rank-independent schedule.
"""
import importlib.util
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import SRC
from torch_threads import one_thread  # noqa: F401

from repro.compat import make_mesh as jax_make_mesh
from repro.core.blocking import GridSpec as JGridSpec
from repro.planner import cost_model as jcm
from repro.planner import plan as jplan
from repro.sparsity import norms as jnorms
from repro.tensor import contract as jcontract
from repro.tensor import create_tensor as jcreate_tensor
from repro.tensor import einsum as jeinsum
from repro.tensor import matricize as jmatricize

from repro_torch import obs
from repro_torch.core import dbcsr
from repro_torch.core.blocking import GridSpec
from repro_torch.examples import tensor_contraction as example
from repro_torch.launch.mesh import make_mesh
from repro_torch.planner.cost_model import HardwareModel
from repro_torch.robustness import chaos
from repro_torch.robustness.guards import DbcsrValidationError
from repro_torch.sparsity.norms import tensor_block_norms
from repro_torch.tensor import (DBCSRTensor, EinsumSpecError, contract,
                                create_tensor, enumerate_layouts,
                                parse_contraction)
from repro_torch.tensor.matricize import (contraction_layout_stats,
                                          fold_array, fold_grid,
                                          fold_to_tensor, layout_operands,
                                          unfold_array, unfold_grid,
                                          unfold_tensor)
from repro_torch.tensor.tensor import _apply_mask, _expand_mask

EXEC_KW = dict(densify=False, local_kernel="ref", pipeline_depth=1)
HW_REF = HardwareModel.from_dict(jcm.DEFAULT_HARDWARE.to_dict())
PORT_TOL = 2e-5

SPECS = [
    # (spec, a shape, a blocks, b shape, b blocks): 2-, 3-, 4-index
    ("ij,jk->ik", (32, 32), (8, 8), (32, 16), (8, 8)),
    ("ijk,kl->ijl", (16, 8, 32), (8, 4, 8), (32, 16), (8, 8)),
    ("abcd,ce->abde", (8, 8, 8, 8), (4, 4, 4, 4), (8, 8), (4, 4)),
]
# the integral tensor of the tensor example, cut to a CPU size
INT_DIMS, INT_BLOCKS = (16, 32, 64), (8, 16, 16)
INT_SPECS = ("iaP,PQ->iaQ", "iaP,iaQ->PQ")
INT_EPS = 1e-8


@pytest.fixture(autouse=True)
def _empty_cwd(tmp_path, monkeypatch):
    """No winners table or calibration file is read by either package."""
    monkeypatch.chdir(tmp_path)


@pytest.fixture
def rng():
    """A fresh seeded generator a test: this module leaves the session
    generator of tests/conftest.py as it found it."""
    return np.random.RandomState(0)


def _mesh11():
    return make_mesh((1, 1), ("data", "model"), device="cpu")


def _grid():
    return GridSpec("data", "model")


def _host_tensor(rng, shape, block_sizes, fill=1.0):
    data = rng.randn(*shape).astype(np.float32)
    mask = None
    if fill < 1.0:
        bg = tuple(d // b for d, b in zip(shape, block_sizes))
        mask = rng.rand(*bg) < fill
        mask.flat[0] = True
    return data, mask


def _tensor(rng, shape, block_sizes, *, fill=1.0, mesh=None):
    data, mask = _host_tensor(rng, shape, block_sizes, fill)
    return create_tensor(data, mesh=mesh, grid=_grid(),
                         block_sizes=block_sizes, block_mask=mask)


def _both(data, mask, blocks, mesh, jmesh, norms=False):
    t = create_tensor(data, mesh=mesh, grid=_grid(), block_sizes=blocks,
                      block_mask=mask, compute_norms=norms)
    jt = jcreate_tensor(data, mesh=jmesh, grid=JGridSpec("data", "model"),
                        block_sizes=blocks, block_mask=mask,
                        compute_norms=norms)
    return t, jt


def _integral(rng):
    """The example's integral tensor and M at ``INT_DIMS``."""
    data, mask = example.build_integral_tensor(rng, *INT_DIMS,
                                               blocks=INT_BLOCKS)
    n_p, b_p = INT_DIMS[2], INT_BLOCKS[2]
    m = rng.randn(n_p, n_p).astype(np.float32)
    return data, mask, m, (b_p, b_p)


def _close_to_reference(got, want, oracle, where):
    scale = max(float(np.abs(oracle).max()), 1.0)
    assert np.abs(np.asarray(want) - oracle).max() < 1e-5 * scale, where
    assert np.abs(got - oracle).max() < 1e-5 * scale, where
    assert np.abs(got - np.asarray(want)).max() <= PORT_TOL * scale, where


# ---------------------------------------------------------------------------
# einsum front-end: parse results and errors equal to the reference's
# ---------------------------------------------------------------------------

def _valid_specs():
    """tests/test_tensor.py's exhaustive sweep of valid specs."""
    letters = "abcdefg"
    specs = set()
    for na in (2, 3, 4):
        a_idx = tuple(letters[:na])
        for nb in (2, 3, 4):
            for nc in range(1, min(na, nb) + 1):
                for ksub in itertools.combinations(a_idx, nc):
                    b_free = tuple(letters[na:na + nb - nc])
                    for korder in {ksub, ksub[::-1]}:
                        for b_idx in {korder + b_free, b_free + korder}:
                            a_free = tuple(x for x in a_idx
                                           if x not in ksub)
                            free = a_free + b_free
                            outs = {free, free[::-1]}
                            if len(free) > 1:
                                outs.add(free[1:] + free[:1])
                            for out in outs:
                                specs.add(f"{''.join(a_idx)},"
                                          f"{''.join(b_idx)}->"
                                          f"{''.join(out)}")
    return sorted(specs)


def test_spec_parsing_and_layouts_equal_the_reference():
    specs = _valid_specs()
    assert len(specs) > 200
    for s in specs:
        p = parse_contraction(s)
        jp = jeinsum.parse_contraction(s)
        assert p.normalized == s == jp.normalized
        assert parse_contraction(p.normalized) == p
        assert (p.a_indices, p.b_indices, p.out_indices, p.contracted,
                p.a_free, p.b_free) == (
            jp.a_indices, jp.b_indices, jp.out_indices, jp.contracted,
            jp.a_free, jp.b_free)
        layouts = enumerate_layouts(p)
        jlayouts = jmatricize.enumerate_layouts(jp)
        assert [(L.label, L.a_rows, L.k_order, L.b_cols, L.swapped)
                for L in layouts] == [
            (L.label, L.a_rows, L.k_order, L.b_cols, L.swapped)
            for L in jlayouts]
        assert len({L.label for L in layouts}) == len(layouts)


def test_spec_parsing_tolerates_whitespace():
    assert parse_contraction(" ijk , kl -> ijl ").normalized == "ijk,kl->ijl"


@pytest.mark.parametrize("bad", [
    "ijjk->ik", "ij,jk", "ij;jk->ik", "i1,1j->ij", "", "ij,->i",
    "iij,jk->ik", "ij,jkk->ij", "ij,jk->ikk", "ij,jk->ikz", "ij,jk->ijk",
    "ij,kl->ijkl", "ij,jk->i", "ij,jk->k", 42,
])
def test_spec_parsing_rejects_malformed_like_the_reference(bad):
    with pytest.raises(EinsumSpecError) as got:
        parse_contraction(bad)
    with pytest.raises(jeinsum.EinsumSpecError) as want:
        jeinsum.parse_contraction(bad)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, DbcsrValidationError)
    assert [c.__name__ for c in type(got.value).__mro__] == [
        c.__name__ for c in type(want.value).__mro__]


def test_mismatched_operands_raise_typed_errors(rng):
    mesh = _mesh11()
    A = _tensor(rng, (16, 8, 32), (8, 4, 8), mesh=mesh)
    with pytest.raises(DbcsrValidationError):  # rank vs subscript
        contract("ij,jk->ik", A, A, mesh=mesh)
    B_dim = _tensor(rng, (16, 16), (8, 8), mesh=mesh)
    with pytest.raises(DbcsrValidationError):  # shared dim mismatch
        contract("ijk,kl->ijl", A, B_dim, mesh=mesh)
    B_blk = _tensor(rng, (32, 16), (16, 8), mesh=mesh)
    with pytest.raises(DbcsrValidationError):  # shared block mismatch
        contract("ijk,kl->ijl", A, B_blk, mesh=mesh)
    B_ok = _tensor(rng, (32, 16), (8, 8), mesh=mesh)
    with pytest.raises(EinsumSpecError):       # unknown pinned layout
        contract("ijk,kl->ijl", A, B_ok, mesh=mesh, layout="(zz|z)@(z|z)")
    other = parse_contraction("ij,jk->ik")
    with pytest.raises(EinsumSpecError):       # a layout of another spec
        contract("ijk,kl->ijl", A, B_ok, mesh=mesh,
                 layout=enumerate_layouts(other)[0])


# ---------------------------------------------------------------------------
# unfold / fold: exact inverses, grids byte-equal to the reference
# ---------------------------------------------------------------------------

def _splits(indices):
    for r in range(1, len(indices)):
        for rows in itertools.permutations(indices, r):
            rest = [x for x in indices if x not in rows]
            for cols in itertools.permutations(rest):
                yield rows, tuple(cols)


@pytest.mark.parametrize("shape, bsizes", [
    ((12, 8, 6), (4, 2, 3)),
    ((8, 4, 6, 10), (2, 4, 3, 5)),
])
def test_unfold_fold_round_trip_all_splits(rng, shape, bsizes):
    indices = tuple("ijkl"[:len(shape)])
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*(d // b for d, b in zip(shape, bsizes))) \
        .astype(np.float32)
    dims = dict(zip(indices, shape))
    bs = dict(zip(indices, bsizes))
    nb = {x_: dims[x_] // bs[x_] for x_ in indices}
    xt = torch.as_tensor(x)
    for rows, cols in _splits(indices):
        y = unfold_array(xt, indices, rows, cols, bsizes)
        want = jmatricize.unfold_array(x, indices, rows, cols, bsizes)
        assert np.array_equal(y.numpy(), want)
        assert np.array_equal(unfold_array(x, indices, rows, cols, bsizes),
                              want)
        back = fold_array(y, indices, rows, cols, nb, bs)
        assert torch.equal(back, xt)
        g2 = unfold_grid(g, indices, rows, cols)
        jg2 = jmatricize.unfold_grid(g, indices, rows, cols)
        assert g2.dtype == jg2.dtype and g2.tobytes() == jg2.tobytes()
        gback = fold_grid(g2, indices, rows, cols, nb)
        jgback = jmatricize.fold_grid(jg2, indices, rows, cols, nb)
        assert gback.tobytes() == jgback.tobytes()
        assert np.array_equal(gback, g)


def test_unfold_lowers_mask_and_norms_exactly(rng):
    mesh = _mesh11()
    A = _tensor(rng, (16, 8, 32), (8, 4, 8), fill=0.5, mesh=mesh)
    A.norms()
    m2 = unfold_tensor(A, ("i", "j", "k"), ("i", "j"), ("k",), mesh=mesh)
    assert int(m2.block_mask.sum()) == int(A.block_mask.sum())
    recomputed = m2.norms(recompute=True)
    np.testing.assert_allclose(
        unfold_grid(A.block_norms, ("i", "j", "k"), ("i", "j"), ("k",)),
        recomputed, rtol=1e-6)


@pytest.mark.parametrize("shape, bsizes, fill", [
    ((16, 8, 32), (8, 4, 8), 0.5),
    ((8, 8, 8, 8), (4, 4, 4, 4), 1.0),
    ((16, 32, 64), (8, 16, 16), 0.6),
    ((32, 16), (8, 8), 0.3),
])
def test_tensor_block_norms_match_the_reference(rng, shape, bsizes, fill):
    data, mask = _host_tensor(rng, shape, bsizes, fill)
    got = tensor_block_norms(torch.as_tensor(data), bsizes, mask)
    want = jnorms.tensor_block_norms(data, bsizes, mask)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError):
        tensor_block_norms(torch.as_tensor(data), bsizes[:-1])


# ---------------------------------------------------------------------------
# contraction identity: every layout, bitwise vs hand-matricized,
# allclose vs the JAX contract and the dense einsum; eps 0 bitwise None
# ---------------------------------------------------------------------------

def _hand_matricized(con, L, A, B, plan, mesh):
    lsrc, lrows, lcols, rsrc, rrows, rcols, crows, ccols = \
        layout_operands(con, L)
    left, lidx = (A, con.a_indices) if lsrc == "a" else (B, con.b_indices)
    right, ridx = (B, con.b_indices) if rsrc == "b" \
        else (A, con.a_indices)
    dims = {**dict(zip(con.a_indices, A.shape)),
            **dict(zip(con.b_indices, B.shape))}
    bs = {**dict(zip(con.a_indices, A.block_sizes)),
          **dict(zip(con.b_indices, B.block_sizes))}
    ma = unfold_tensor(left, lidx, lrows, lcols, mesh=mesh)
    mb = unfold_tensor(right, ridx, rrows, rcols, mesh=mesh)
    hand_kw = {**EXEC_KW, "densify": plan.plan.densify}
    c2d = dbcsr.multiply(ma, mb, mesh=mesh, algorithm=plan.plan.algorithm,
                         **hand_kw)
    return fold_to_tensor(c2d, con.out_indices, crows, ccols, dims, bs,
                          A.grid, mesh=mesh)


@pytest.mark.parametrize("fill", [1.0, 0.5, 0.05])
@pytest.mark.parametrize("case", SPECS, ids=[s[0] for s in SPECS])
def test_contract_every_layout_bitwise_and_reference(rng, case, fill):
    spec, ash, abs_, bsh, bbs = case
    mesh = _mesh11()
    jmesh = jax_make_mesh((1, 1), ("data", "model"))
    A, jA = _both(*_host_tensor(rng, ash, abs_, fill), abs_, mesh, jmesh)
    B, jB = _both(*_host_tensor(rng, bsh, bbs, fill), bbs, mesh, jmesh)
    con = parse_contraction(spec)
    oracle = np.einsum(spec, A.data.numpy(), B.data.numpy())
    for L in enumerate_layouts(con):
        C, plan = contract(spec, A, B, mesh=mesh, layout=L,
                           return_plan=True, **EXEC_KW)
        jC = jcontract(spec, jA, jB, mesh=jmesh, layout=L.label, **EXEC_KW)
        assert plan.layout == L.label == plan.plan.layout
        assert C.shape == tuple(oracle.shape)
        _close_to_reference(C.data.numpy(), jC.data, oracle, (spec, L))
        if C.block_mask is not None or jC.block_mask is not None:
            assert np.array_equal(C.block_mask, jC.block_mask)
        hand = _hand_matricized(con, L, A, B, plan, mesh)
        assert torch.equal(C.data, hand.data)
        if C.block_mask is not None:
            assert np.array_equal(C.block_mask, hand.block_mask)
        C0 = contract(spec, A, B, mesh=mesh, layout=L, filter_eps=0.0,
                      **EXEC_KW)
        assert torch.equal(C.data, C0.data)


@pytest.mark.parametrize("spec", INT_SPECS)
def test_integral_contractions_every_layout_1x1(rng, spec):
    """The example's two contractions at a CPU size: every layout, eps
    1e-8, bitwise the hand-matricized multiply, close to the JAX
    contract and the dense einsum."""
    mesh = _mesh11()
    jmesh = jax_make_mesh((1, 1), ("data", "model"))
    data, mask, m, mblocks = _integral(rng)
    B, jB = _both(data, mask, INT_BLOCKS, mesh, jmesh, norms=True)
    if spec == "iaP,PQ->iaQ":
        M, jM = _both(m, None, mblocks, mesh, jmesh)
    else:
        M, jM = B, jB
    con = parse_contraction(spec)
    oracle = np.einsum(spec, B.data.numpy(), M.data.numpy())
    for L in enumerate_layouts(con):
        C, plan = contract(spec, B, M, mesh=mesh, layout=L.label,
                           filter_eps=INT_EPS, return_plan=True, **EXEC_KW)
        jC = jcontract(spec, jB, jM, mesh=jmesh, layout=L.label,
                       filter_eps=INT_EPS, **EXEC_KW)
        _close_to_reference(C.data.numpy(), jC.data, oracle, (spec, L))
        assert np.array_equal(C.block_mask, jC.block_mask)
        hand = _hand_matricized(con, L, B, M, plan, mesh)
        assert torch.equal(C.data, hand.data)


def test_integral_tensor_is_the_reference_examples():
    """The port's builder at the JAX example's defaults gives the JAX
    example's bytes."""
    path = os.path.join(os.path.dirname(SRC), "examples",
                        "tensor_contraction.py")
    before = os.environ.get("XLA_FLAGS")
    spec = importlib.util.spec_from_file_location("_jax_tensor_example",
                                                  path)
    jexample = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(jexample)
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    got = example.build_integral_tensor(np.random.RandomState(0))
    want = jexample.build_integral_tensor(np.random.RandomState(0))
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert (example.N_I, example.N_A, example.N_P, example.FILTER_EPS) == (
        jexample.N_I, jexample.N_A, jexample.N_P, jexample.FILTER_EPS)
    assert example.BLOCKS == (jexample.B_I, jexample.B_A, jexample.B_P)


@pytest.mark.parametrize("spec", INT_SPECS)
def test_tensor_example_runs_on_the_cpu(spec, capsys):
    example.main(["--device", "cpu", "--spec", spec])
    out = capsys.readouterr().out
    assert "OK: contraction matches the dense einsum oracle" in out
    assert "contraction plan" in out


def test_contract_filter_eps_subtractive(rng):
    mesh = _mesh11()
    data = rng.randn(16, 8, 32).astype(np.float32)
    data[8:] *= 1e-9
    A = create_tensor(data, mesh=mesh, grid=_grid(), block_sizes=(8, 4, 8))
    B = _tensor(rng, (32, 16), (8, 8), mesh=mesh)
    C0 = contract("ijk,kl->ijl", A, B, mesh=mesh, **EXEC_KW)
    Ce = contract("ijk,kl->ijl", A, B, mesh=mesh, filter_eps=1.0,
                  **EXEC_KW)
    assert Ce.block_mask is not None
    assert Ce.block_mask[0].all()
    assert not Ce.block_mask[1].any()
    assert torch.equal(Ce.data[:8], C0.data[:8])
    assert not Ce.data[8:].any()


# ---------------------------------------------------------------------------
# verify= / rank_exact= threading
# ---------------------------------------------------------------------------

def test_contract_verify_detects_localizes_repairs_in_tensor_frame(rng):
    mesh = _mesh11()
    A = _tensor(rng, (16, 8, 32), (8, 4, 8), fill=0.8, mesh=mesh)
    B = _tensor(rng, (32, 16), (8, 8), fill=0.8, mesh=mesh)
    L = enumerate_layouts(parse_contraction("ijk,kl->ijl"))[0]
    kw = dict(mesh=mesh, layout=L, **EXEC_KW)

    clean = contract("ijk,kl->ijl", A, B, **kw)
    assert clean.verification is None

    cv = contract("ijk,kl->ijl", A, B, verify="checksum", **kw)
    assert cv.verification["enabled"]
    assert not cv.verification["report"].detected
    assert torch.equal(cv.data, clean.data)

    hook = chaos.FaultInjector(seed=7).one_shot_result_hook(
        1, 1, block_m=32, block_n=8, mode="bitflip")
    with chaos.result_corruption(hook):
        cr = contract("ijk,kl->ijl", A, B, verify="checksum", **kw)
    rep = cr.verification["report"]
    assert rep.detected
    assert rep.flagged_blocks == ((1, 1),)
    assert rep.repaired and rep.n_recomputed_blocks >= 1
    assert torch.equal(cr.data, clean.data)
    assert cr.last_plan.verification["report"].detected


def test_contract_battery_2x2_with_rank_exact_in_process(rng):
    """The reference's 2x2 battery on the port's simulated 2x2 mesh."""
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    for spec, ash, abs_, bsh, bbs in SPECS:
        for fill in (1.0, 0.5, 0.05):
            A = _tensor(rng, ash, abs_, fill=fill, mesh=mesh)
            B = _tensor(rng, bsh, bbs, fill=fill, mesh=mesh)
            C = contract(spec, A, B, mesh=mesh, **EXEC_KW)
            oracle = np.einsum(spec, A.data.numpy(), B.data.numpy())
            scale = max(float(np.abs(oracle).max()), 1.0)
            assert np.abs(C.data.numpy() - oracle).max() < 1e-5 * scale
    A = _tensor(rng, (16, 8, 32), (8, 4, 8), fill=0.4, mesh=mesh)
    B = _tensor(rng, (32, 16), (8, 8), fill=0.4, mesh=mesh)
    kw = dict(mesh=mesh, algorithm="summa", **EXEC_KW)
    Cr, pr_ = contract("ijk,kl->ijl", A, B, rank_exact=True,
                       return_plan=True, **kw)
    Cu = contract("ijk,kl->ijl", A, B, rank_exact=False, **kw)
    assert torch.equal(Cr.data, Cu.data)
    assert pr_.plan.rank_imbalance >= 1.0
    Cv = contract("ijk,kl->ijl", A, B, verify="checksum", **kw)
    assert Cv.verification["enabled"]
    assert not Cv.verification["report"].detected


# ---------------------------------------------------------------------------
# 2x2 against the JAX contract (one subprocess with 4 host devices)
# ---------------------------------------------------------------------------

REFERENCE_2X2 = r"""
import json, sys
import numpy as np
from repro.compat import make_mesh
from repro.core.blocking import GridSpec
from repro.tensor import contract, create_tensor

inp = np.load(sys.argv[1], allow_pickle=True)
cases = json.loads(str(inp["cases"]))
mesh = make_mesh((2, 2), ("data", "model"))
grid = GridSpec("data", "model")
EXEC_KW = dict(densify=False, local_kernel="ref", pipeline_depth=1)
out = {}
for c in cases:
    name = c["name"]
    def t(key):
        mask = inp[key + "_mask"] if (key + "_mask") in inp.files else None
        return create_tensor(inp[key], mesh=mesh, grid=grid,
                             block_sizes=tuple(c[key + "_blocks"]),
                             block_mask=mask, compute_norms=True)
    A = t(c["a"])
    B = A if c["b"] == c["a"] else t(c["b"])
    C = contract(c["spec"], A, B, mesh=mesh, layout=c["layout"],
                 filter_eps=c["eps"], rank_exact=c["rank_exact"],
                 **EXEC_KW)
    out[name] = np.asarray(C.data)
    if C.block_mask is not None:
        out[name + "_mask"] = C.block_mask
np.savez(sys.argv[2], **out)
print("done", len(cases))
"""


def _cases_2x2():
    """(inputs, cases) of the 2x2 comparison: the example's two
    contractions at every layout (eps 1e-8) and the reference's 2x2
    battery specs at two fills under auto, union and rank-exact."""
    rng = np.random.RandomState(11)
    inputs, cases = {}, []
    data, mask, m, mblocks = _integral(rng)
    inputs.update(B=data, B_mask=mask, M=m)
    blocks = {"B_blocks": list(INT_BLOCKS), "M_blocks": list(mblocks)}
    for spec in INT_SPECS:
        other = "M" if spec == "iaP,PQ->iaQ" else "B"
        for L in enumerate_layouts(parse_contraction(spec)):
            cases.append(dict(name=f"{spec}:{L.label}", spec=spec, a="B",
                              b=other, layout=L.label, eps=INT_EPS,
                              rank_exact=None, **blocks))
    for si, (spec, ash, abs_, bsh, bbs) in enumerate(SPECS):
        for fill in (1.0, 0.3):
            a, b = f"A{si}_{fill}", f"Bm{si}_{fill}"
            da, ma = _host_tensor(rng, ash, abs_, fill)
            db, mb = _host_tensor(rng, bsh, bbs, fill)
            inputs[a], inputs[b] = da, db
            if ma is not None:
                inputs[a + "_mask"], inputs[b + "_mask"] = ma, mb
            for rank_exact in (None, False):
                cases.append(dict(
                    name=f"{spec}:{fill}:{rank_exact}", spec=spec, a=a,
                    b=b, layout="auto", eps=None, rank_exact=rank_exact,
                    **{a + "_blocks": list(abs_), b + "_blocks": list(bbs)}))
    return inputs, cases


@pytest.fixture(scope="module")
def _reference_2x2_proc(tmp_path_factory):
    d = tmp_path_factory.mktemp("tensor_2x2")
    inputs, cases = _cases_2x2()
    np.savez(d / "in.npz", cases=json.dumps(cases), **inputs)
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_2X2, str(d / "in.npz"),
         str(d / "out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield proc, d, inputs, cases
    proc.kill()
    proc.wait()


def test_contract_2x2_matches_the_jax_contract(_reference_2x2_proc):
    proc, d, inputs, cases = _reference_2x2_proc
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    got = {}
    tensors = {}
    for c in cases:
        def t(key):
            if key not in tensors:
                tensors[key] = create_tensor(
                    inputs[key], mesh=mesh, grid=_grid(),
                    block_sizes=tuple(c[key + "_blocks"]),
                    block_mask=inputs.get(key + "_mask"),
                    compute_norms=True)
            return tensors[key]
        A = t(c["a"])
        B = A if c["b"] == c["a"] else t(c["b"])
        C = contract(c["spec"], A, B, mesh=mesh, layout=c["layout"],
                     filter_eps=c["eps"], rank_exact=c["rank_exact"],
                     **EXEC_KW)
        oracle = np.einsum(c["spec"], A.data.numpy(), B.data.numpy())
        got[c["name"]] = (C, oracle)
    stdout, stderr = proc.communicate(timeout=900)
    assert proc.returncode == 0, stderr[-4000:]
    want = np.load(d / "out.npz")
    for name, (C, oracle) in got.items():
        _close_to_reference(C.data.numpy(), want[name], oracle, name)
        if C.block_mask is not None:
            assert np.array_equal(C.block_mask, want[name + "_mask"]), name


# ---------------------------------------------------------------------------
# planner: layout costing equal to the reference's, cache, explain()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4)])
@pytest.mark.parametrize("case", ["ijk,kl->ijl", "iaP,PQ->iaQ",
                                  "iaP,iaQ->PQ"])
@pytest.mark.parametrize("eps", [None, INT_EPS])
def test_layout_stats_and_plan_contract_equal_the_reference(
        rng, case, mesh_shape, eps):
    mesh = _mesh11()
    jmesh = jax_make_mesh((1, 1), ("data", "model"))
    if case == "ijk,kl->ijl":
        A, jA = _both(*_host_tensor(rng, (16, 8, 32), (8, 4, 8), 0.5),
                      (8, 4, 8), mesh, jmesh, norms=True)
        B, jB = _both(*_host_tensor(rng, (32, 16), (8, 8), 0.5), (8, 8),
                      mesh, jmesh, norms=True)
    else:
        data, mask, m, mblocks = _integral(rng)
        A, jA = _both(data, mask, INT_BLOCKS, mesh, jmesh, norms=True)
        if case == "iaP,PQ->iaQ":
            B, jB = _both(m, None, mblocks, mesh, jmesh, norms=True)
        else:
            B, jB = A, jA
    con = parse_contraction(case)
    jcon = jeinsum.parse_contraction(case)
    stats, jstats = [], []
    for L, jL in zip(enumerate_layouts(con),
                     jmatricize.enumerate_layouts(jcon)):
        s = contraction_layout_stats(con, L, A, B, mesh_shape=mesh_shape,
                                     filter_eps=eps)
        js = jmatricize.contraction_layout_stats(
            jcon, jL, jA, jB, mesh_shape=mesh_shape, filter_eps=eps)
        for f in ("label", "m", "k", "n", "block_m", "block_k", "block_n",
                  "copy_bytes", "feasible", "reason"):
            assert getattr(s, f) == getattr(js, f), (case, L.label, f)
        assert s.occupancy == pytest.approx(js.occupancy, abs=1e-12)
        assert (s.rank_imbalance is None) == (js.rank_imbalance is None)
        if s.rank_imbalance is not None:
            assert s.rank_imbalance == pytest.approx(js.rank_imbalance,
                                                     rel=1e-12)
        stats.append(s)
        jstats.append(js)
    from repro_torch.planner.plan import plan_contract

    got = plan_contract(case, stats, mesh_shape=mesh_shape, hw=HW_REF)
    want = jplan.plan_contract(
        case, jstats, mesh_shape=mesh_shape,
        hw=jcm.HardwareModel.from_dict(HW_REF.to_dict()))
    assert (got.layout, got.algorithm, got.densify) == (
        want.layout, want.algorithm, want.densify)
    assert got.predicted_s == pytest.approx(want.predicted_s, rel=1e-12)
    assert [(c.layout, c.feasible, c.algorithm) for c in got.layouts] == [
        (c.layout, c.feasible, c.algorithm) for c in want.layouts]


def test_plan_contract_caches_on_contraction_signature(rng):
    from repro_torch.planner import cost_model
    from repro_torch.planner.plan import (contract_cache_clear,
                                          contract_cache_info)

    mesh = _mesh11()
    A = _tensor(rng, (16, 8, 32), (8, 4, 8), fill=0.5, mesh=mesh)
    B = _tensor(rng, (32, 16), (8, 8), fill=0.5, mesh=mesh)
    contract_cache_clear()
    C1, p1 = contract("ijk,kl->ijl", A, B, mesh=mesh, return_plan=True,
                      **EXEC_KW)
    n0 = cost_model.N_EVALS
    C2, p2 = contract("ijk,kl->ijl", A, B, mesh=mesh, return_plan=True,
                      **EXEC_KW)
    assert cost_model.N_EVALS == n0
    assert contract_cache_info().hits >= 1
    assert p2.layout == p1.layout
    assert torch.equal(C1.data, C2.data)
    A2 = _tensor(rng, (16, 8, 32), (8, 4, 8), fill=0.3, mesh=mesh)
    contract("ijk,kl->ijl", A2, B, mesh=mesh, **EXEC_KW)
    assert cost_model.N_EVALS > n0


def test_plan_contract_explain_has_layout_column(rng):
    mesh = _mesh11()
    A = _tensor(rng, (16, 8, 32), (8, 4, 8), fill=0.5, mesh=mesh)
    B = _tensor(rng, (32, 16), (8, 8), fill=0.5, mesh=mesh)
    _, plan = contract("ijk,kl->ijl", A, B, mesh=mesh, return_plan=True,
                       **EXEC_KW)
    text = plan.explain()
    assert "layout" in text
    for L in enumerate_layouts(parse_contraction("ijk,kl->ijl")):
        assert L.label in text
    assert f"layout={plan.layout}" in text
    assert plan.chosen is not None and plan.chosen.feasible
    assert plan.plan.executor_stats is not None
    assert plan.plan.layout == plan.layout


def test_layout_stats_occupancy_invariant():
    con = parse_contraction("ijk,kl->ijl")
    mesh = _mesh11()
    mask = np.zeros((4, 2, 4), dtype=bool)
    mask[0] = True
    A = create_tensor(np.random.RandomState(3).randn(16, 8, 32)
                      .astype(np.float32), mesh=mesh, grid=_grid(),
                      block_sizes=(4, 4, 8), block_mask=mask)
    B = _tensor(np.random.RandomState(4), (32, 16), (8, 8), mesh=mesh)
    occ = set()
    for L in enumerate_layouts(con):
        s = contraction_layout_stats(con, L, A, B, mesh_shape=(2, 2))
        occ.add(round(s.occupancy, 12))
        assert s.m * s.n * s.k == 16 * 8 * 32 * 16
    assert len(occ) == 1


# ---------------------------------------------------------------------------
# container: fields, norms, filter, mask application
# ---------------------------------------------------------------------------

def test_tensor_container_matches_the_reference(rng):
    mesh = _mesh11()
    jmesh = jax_make_mesh((1, 1), ("data", "model"))
    A, jA = _both(*_host_tensor(rng, (16, 8, 32), (8, 4, 8), 0.5),
                  (8, 4, 8), mesh, jmesh, norms=True)
    assert isinstance(A, DBCSRTensor)
    assert (A.shape, A.ndim, A.block_grid, A.nblocks, A.occupancy) == (
        jA.shape, jA.ndim, jA.block_grid, jA.nblocks, jA.occupancy)
    assert np.array_equal(A.data.numpy(), np.asarray(jA.data))
    assert np.array_equal(A.block_mask, jA.block_mask)
    np.testing.assert_allclose(A.block_norms, jA.block_norms, rtol=1e-6)
    full = _expand_mask(A.block_mask, A.block_sizes)
    x = torch.as_tensor(rng.randn(16, 8, 32).astype(np.float32))
    assert torch.equal(_apply_mask(x, A.block_mask, A.block_sizes),
                       x * torch.as_tensor(full).float())
    with pytest.raises(ValueError):
        create_tensor(np.zeros((16, 8)), mesh=mesh, block_sizes=(8, 3))
    with pytest.raises(ValueError):
        create_tensor(np.zeros((16, 8)), mesh=mesh, block_sizes=(8,))
    with pytest.raises(ValueError):
        create_tensor(np.zeros((16, 8)), mesh=mesh, block_sizes=(8, 4),
                      block_mask=np.ones((3, 2), dtype=bool))
    assert create_tensor(np.zeros((8, 8)), mesh=mesh,
                         block_sizes=(4, 4)).data.dtype == torch.float32


def test_tensor_filter_and_occupancy(rng):
    mesh = _mesh11()
    A = _tensor(rng, (16, 8, 32), (8, 4, 8), fill=0.5, mesh=mesh)
    filt = A.filter(1e30)
    assert filt.occupancy == 0.0
    assert not filt.data.any()
    keep = A.filter(0.0)
    assert np.array_equal(keep.block_mask, A.block_mask)
    assert torch.equal(keep.data, A.data)


def test_dbcsr_exports_the_tensor_entry_points():
    from repro.core import dbcsr as jdbcsr

    assert set(jdbcsr.__all__) <= set(dbcsr.__all__)
    assert {"contract", "create_tensor"} <= set(dbcsr.__all__)
    from repro import tensor as jtensor
    from repro_torch import tensor

    assert tensor.__all__ == jtensor.__all__


# ---------------------------------------------------------------------------
# obs: contract -> plan / matricize / multiply span tree + outcome rows
# ---------------------------------------------------------------------------

def test_contract_span_tree_and_outcome_row(rng, tmp_path):
    from repro import obs as jobs

    def tree(spans):
        kids = {}
        for s in spans:
            kids.setdefault(s.parent_id, []).append(s)

        def walk(pid):
            return tuple((s.name, walk(s.span_id)) for s in sorted(
                kids.get(pid, []), key=lambda s: (s.t0, s.span_id)))
        return walk(None)

    mesh = _mesh11()
    jmesh = jax_make_mesh((1, 1), ("data", "model"))
    A, jA = _both(*_host_tensor(rng, (16, 8, 32), (8, 4, 8), 0.5),
                  (8, 4, 8), mesh, jmesh)
    B, jB = _both(*_host_tensor(rng, (32, 16), (8, 8), 0.5), (8, 8),
                  mesh, jmesh)
    L = enumerate_layouts(parse_contraction("ijk,kl->ijl"))[0].label
    traces = {}
    for name, pkg, run in (
            ("port", obs, lambda: contract("ijk,kl->ijl", A, B, mesh=mesh,
                                           layout=L, **EXEC_KW)),
            ("jax", jobs, lambda: jcontract("ijk,kl->ijl", jA, jB,
                                            mesh=jmesh, layout=L,
                                            **EXEC_KW))):
        pkg.enable(log_dir=str(tmp_path / name))
        try:
            pkg.clear_plan_outcomes()
            run()
            traces[name] = (pkg.last_trace(), list(pkg.plan_outcomes()))
        finally:
            pkg.disable()
            pkg.clear_plan_outcomes()
            pkg.clear_metrics()
    spans, outcomes = traces["port"]
    assert tree(spans) == tree(traces["jax"][0])
    roots = [s for s in spans if s.parent_id is None]
    assert [r.name for r in roots] == ["contract"]
    kids = [s.name for s in spans if s.parent_id == roots[0].span_id]
    assert "matricize" in kids and "multiply" in kids and "plan" in kids
    rows = [r for r in outcomes if r.get("kind") == "contract"]
    assert len(rows) == 1
    row = rows[0]
    jrow = [r for r in traces["jax"][1] if r.get("kind") == "contract"][0]
    assert set(row) == set(jrow)
    for key in ("spec", "algorithm", "layout", "densify", "m", "k", "n"):
        assert row[key] == jrow[key], key
    assert row["predicted_s"] > 0 and row["measured_s"] > 0
    assert any(r.get("kind") == "multiply" for r in outcomes)
    logged = obs.read_jsonl(str(tmp_path / "port" / obs.PLAN_OUTCOMES_LOG))
    assert [r["kind"] for r in logged] == [r["kind"] for r in outcomes]
    assert obs.validate_chrome_trace(obs.to_chrome_trace(spans)) == []


def test_contract_untraced_adds_no_registry_entry(rng):
    obs.clear_metrics()
    mesh = _mesh11()
    A = _tensor(rng, (16, 8, 32), (8, 4, 8), fill=0.5, mesh=mesh)
    B = _tensor(rng, (32, 16), (8, 8), fill=0.5, mesh=mesh)
    C0 = contract("ijk,kl->ijl", A, B, mesh=mesh, **EXEC_KW)
    assert len(obs.registry()) == 0 and obs.plan_outcomes() == []
    obs.enable()
    try:
        C1 = contract("ijk,kl->ijl", A, B, mesh=mesh, **EXEC_KW)
    finally:
        obs.disable()
        obs.clear_plan_outcomes()
        obs.clear_metrics()
    assert torch.equal(C0.data, C1.data)
