"""The port's sharding helpers and launch tools against the JAX package's.

Every spec helper, leaf for leaf, for all ten architectures on four
meshes ({data 1, model 1}, {data 16, model 16}, {pod 2, data 16, model
16} and {data 32, model 8}): the JAX functions read only ``mesh.shape``,
so they get a ``jax.sharding.AbstractMesh`` and the port a meta
``Mesh`` of the same shape.  A JAX ``PartitionSpec`` is compared with
the port's tuple by its entries.  Then ``input_specs`` /
``serve_input_specs`` shapes and dtypes, ``default_microbatches``,
``cell_is_supported`` and ``opt_for`` over ARCHS x SHAPES, and
``param_count`` / ``model_flops`` exactly.  ``repro.launch.dryrun`` is
not imported: it sets XLA_FLAGS when imported.

Named departure: ``cur_len`` is a one-element tensor in the port (a
scalar in the JAX package), so its spec is P(None) against P().
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import base as jbase
from repro.launch import roofline as JR
from repro.launch import specs as JSP
from repro.models import common as JC
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro_torch.configs import base as tbase
from repro_torch.launch import mesh as TM
from repro_torch.launch import roofline as TR
from repro_torch.launch import specs as TSP
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as TE
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TTS

from torch_threads import one_thread  # noqa: F401

ARCHS = tbase.ARCHS
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "32x8": ((32, 8), ("data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    return (AbstractMesh(shape, axes),
            TM.make_mesh(shape, axes, device="meta"))


def _jleaves(tree):
    return [tuple(x.spec if isinstance(x, NamedSharding) else x)
            for x in jax.tree_util.tree_leaves(
                tree, is_leaf=lambda x: isinstance(x, (JP, NamedSharding)))]


def _tleaves(tree):
    leaves = TC.tree_leaves(tree, is_leaf=TM.is_spec)
    assert all(isinstance(x, TM.PartitionSpec) for x in leaves)
    return [tuple(x) for x in leaves]


def _same(jtree, ttree):
    j, t = _jleaves(jtree), _tleaves(ttree)
    assert len(j) == len(t)
    assert j == t


@pytest.fixture(scope="module", params=ARCHS)
def cfgs(request):
    return jbase.get_config(request.param), tbase.get_config(request.param)


# ---------------------------------------------------------------- specs


def test_partition_spec_canonical_like_jax():
    for parts in [(), (None,), ("model", None), ((), "a"), (("data",), None),
                  (("pod", "data"), "model", None), (["data"],)]:
        assert tuple(TM.P(*parts)) == tuple(JP(*parts))
    assert TM.is_spec(TM.P()) and not TM.is_spec(())


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs(cfgs, mesh):
    jc, tc = cfgs
    jm, tm = _meshes(mesh)
    _same(JC.param_specs(JT.model_defs(jc)), TC.param_specs(TT.model_defs(tc)))
    _same(JT.model_param_specs(jc), TT.model_param_specs(tc))
    _same(JT.model_param_specs(jc, jm), TT.model_param_specs(tc, tm))
    assert JT.dp_axes(jm) == TT.dp_axes(tm)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_and_decode_specs(cfgs, mesh):
    jc, tc = cfgs
    jm, tm = _meshes(mesh)
    _same(JT.cache_specs(jc), TT.cache_specs(tc))
    for batch in (1, 128):
        _same(JT.cache_specs(jc, jm, batch=batch),
              TT.cache_specs(tc, tm, batch=batch))
        for kv in (None, 4096):
            jst, jtok = JE.decode_shardings(jc, jm, batch=batch, kv_len=kv)
            tst, ttok = TE.decode_shardings(tc, tm, batch=batch, kv_len=kv)
            _same(jst["cache"], tst["cache"])
            assert tuple(jst["cur_len"].spec) == ()
            assert tst["cur_len"] == (None,)
            assert tuple(jtok.spec) == tuple(ttok)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_and_optimizer_specs(cfgs, mesh):
    jc, tc = cfgs
    jm, tm = _meshes(mesh)
    _same(JTS.batch_specs(jc), TTS.batch_specs(tc))
    _same(JTS.batch_specs(jc, jm), TTS.batch_specs(tc, tm))
    jp, jsh = JT.model_param_specs(jc, jm), JT.model_param_shapes(jc)
    tp, tsh = TT.model_param_specs(tc, tm), TT.model_param_shapes(tc)
    for name, zero in (("adamw", False), ("adamw", True), ("adafactor", False)):
        jo = JO.make_optimizer(JO.OptConfig(name=name, zero=zero))
        to = TO.make_optimizer(TO.OptConfig(name=name, zero=zero))
        _same(jo.state_specs(jp, jsh, mesh=jm),
              to.state_specs(tp, tsh, mesh=tm))
        _same(jo.state_specs(jp, jsh), to.state_specs(tp, tsh))
    # NamedSharding refuses the JAX package's ZeRO specs of moe_fsdp
    # experts (the data axis twice), which opt_for never asks for
    jo = JO.make_optimizer(JSP.opt_for(jc))
    to = TO.make_optimizer(TSP.opt_for(tc))
    for j, t in zip(JTS.shardings_for(jc, jm, jo),
                    TTS.shardings_for(tc, tm, to)):
        _same(j, t)


def test_zero_shard_specs_leaf_rule():
    jm, tm = _meshes("2x16x16")
    for spec, shape in [((None, "model"), (64, 32)),
                        (("model", None), (64, 24)), ((None,), (7,)),
                        ((), (32, 16)), (("data", None), (32, 48))]:
        leaf_j = jax.ShapeDtypeStruct(shape, np.float32)
        leaf_t = torch.empty(shape, device="meta")
        got_j = JO.zero_shard_specs(None, mesh=jm)(JP(*spec), leaf_j)
        got_t = TO.zero_shard_specs(None, mesh=tm)(TM.P(*spec), leaf_t)
        assert tuple(got_j) == tuple(got_t)


def test_resolve_spec_matches():
    rng = np.random.RandomState(0)
    parts = [None, "data", "model", "pod", ("pod", "data"), ("data", "model")]
    for name in MESHES:
        jm, tm = _meshes(name)
        for _ in range(50):
            nd = rng.randint(1, 4)
            spec = [parts[i] for i in rng.randint(0, len(parts), nd)]
            shape = tuple(int(x) for x in
                          rng.choice([1, 2, 8, 12, 32, 256], nd))
            assert tuple(JC.resolve_spec(JP(*spec), shape, jm)) == tuple(
                TC.resolve_spec(TM.P(*spec), shape, tm))


# ------------------------------------------------------ cells and shapes


def _tdtype(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("shape", list(tbase.SHAPES))
def test_input_specs_and_cell_helpers(cfgs, shape):
    jc, tc = cfgs
    js, ts = jbase.SHAPES[shape], tbase.SHAPES[shape]
    assert JSP.cell_is_supported(jc, js) == TSP.cell_is_supported(tc, ts)
    jo, to = JSP.opt_for(jc), TSP.opt_for(tc)
    assert dataclasses.asdict(jo) == dataclasses.asdict(to)
    for name in MESHES:
        jm, tm = _meshes(name)
        assert JSP.default_microbatches(jc, js, jm) == \
            TSP.default_microbatches(tc, ts, tm)
    jin, tin = JSP.input_specs(jc, js), TSP.input_specs(tc, ts)
    if ts.kind == "decode":
        # cur_len: () int32 against the port's (1,) int32 (named departure)
        assert jin["state"]["cur_len"].shape == ()
        assert tuple(tin["state"]["cur_len"].shape) == (1,)
        jin["state"] = jin["state"]["cache"]
        tin["state"] = tin["state"]["cache"]
        jst, jtok = JE.serve_input_specs(jc, batch=4, kv_len=32)
        tst, ttok = TE.serve_input_specs(tc, batch=4, kv_len=32)
        assert (jtok.shape, str(jtok.dtype)) == \
            (tuple(ttok.shape), _tdtype(ttok))
    jl = jax.tree_util.tree_leaves(jin)
    tl = TC.tree_leaves(tin)
    assert [(x.shape, str(x.dtype)) for x in jl] == \
        [(tuple(t.shape), _tdtype(t)) for t in tl]
    assert all(t.device.type == "meta" for t in tl)
    assert JR.model_flops(jc, js) == TR.model_flops(tc, ts)


def test_param_count(cfgs):
    jc, tc = cfgs
    for active in (False, True):
        assert JR.param_count(jc, active_only=active) == \
            TR.param_count(tc, active_only=active)
    # the count is the declared parameters' (the padded heads aside)
    if jc.head_pad_factor == 1 and not jc.moe:
        n = sum(t.numel() for t in TC.tree_leaves(TT.model_param_shapes(tc)))
        mtp = sum(t.numel() for t in TC.tree_leaves(
            TT.model_param_shapes(tc)["mtp"])) if tc.mtp else 0
        assert abs(n - mtp - TR.param_count(tc)) <= 0.02 * n


def test_build_cell_specs_match_the_jax_cell():
    """``build_cell`` on rank 0 of a production mesh: the spec trees are
    the JAX cell's NamedShardings' specs, for a train, prefill and decode
    cell (RWKV-6's caches lie as the JAX package's)."""
    jm = AbstractMesh((32, 8), ("data", "model"))
    tm = TM.make_meta_rank_mesh((32, 8), ("data", "model"))
    for arch, shape in (("qwen2_1_5b", "train_4k"), ("jamba_v0_1_52b",
                                                      "prefill_32k"),
                        ("rwkv6_1_6b", "long_500k")):
        tstep, targs, (tin, tout), tdonate, meta = TSP.build_cell(
            arch, shape, tm)
        assert meta["kind"] == tbase.SHAPES[shape].kind
        assert all(t.device.type == "meta" for t in TC.tree_leaves(targs))
        jc = jbase.get_config(arch)
        if meta["kind"] == "train":
            jo = JO.make_optimizer(JSP.opt_for(jc))
            for j, t in zip(JTS.shardings_for(jc, jm, jo), tin):
                _same(j, t)
            assert tdonate == (0, 1)
        elif meta["kind"] == "prefill":
            _same(JT.model_param_specs(jc, jm), tin[0])
            assert tin[1] == ("data", None)
        else:
            jst, jtok = JE.decode_shardings(jc, jm, batch=1, kv_len=524288)
            _same(jst["cache"], tin[1]["cache"])
            assert tuple(jtok.spec) == tuple(tin[2]) and tdonate == (1,)


# ------------------------------------------------------------- hardware


def test_hw_and_production_mesh():
    assert TM.HW["peak_flops"]["bfloat16"] == 989e12
    assert TM.HW["peak_flops"]["tf32"] == 495e12
    assert TM.HW["peak_flops"]["float32"] == 67e12
    assert (TM.HW["hbm_bw"], TM.HW["hbm_bytes"], TM.HW["nvlink_bw"]) == \
        (3.35e12, 80e9, 450e9)
    assert TM.hw_for("NVIDIA H100 80GB HBM3") is TM.HW
    assert TM.hw_for("NVIDIA H100 PCIe")["peak_flops"]["float32"] == 51e12
    assert TM.hw_for("NVIDIA H100 NVL")["hbm_bw"] == 3.9e12
    m = TM.make_production_mesh()
    assert m.shape == {"data": 32, "model": 8} and m.device.type == "meta"
    m = TM.make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 32, "model": 8} and m.n_ranks == 512


def test_roofline_terms_split_by_dtype():
    from repro_torch.launch.cost_counter import OpCosts

    c = OpCosts(hbm_bytes=3.35e12)
    c.flops_by_dtype.update({"bfloat16": 989e12, "float32": 67e12,
                             "tf32": 495e12})
    c.flops = sum(c.flops_by_dtype.values())
    t = TR.roofline_terms(c, TM.HW)
    assert t["compute_s"] == pytest.approx(3.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == 0.0 and t["dominant"] == "compute"
    assert t["roofline_fraction"] == pytest.approx(1.0)
    c.collective_bytes["psum"] = 450e9 * 10
    t = TR.roofline_terms(c, TM.HW)
    assert t["dominant"] == "collective"
    assert t["roofline_fraction"] == pytest.approx(0.3)
    assert TR.step_bound_s(c, TM.HW) == pytest.approx(10.0)


# ---------------------------------------------------------------- ZeRO


def test_zero_trains_bitwise_as_without():
    """ZeRO changes the specs, not the numbers: four AdamW steps of reduced
    Qwen2 with zero=True are bitwise those with zero=False."""
    from repro_torch.train.data import make_batch

    cfg = tbase.reduced_config(tbase.get_config("qwen2_1_5b"))
    b = {k: torch.from_numpy(v) for k, v in make_batch(
        0, global_batch=2, seq_len=16, vocab=cfg.vocab_size).items()}
    finals = []
    for zero in (False, True):
        opt = TO.make_optimizer(TO.OptConfig(zero=zero))
        params = TT.model_init(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        state = opt.init(params)
        step = TTS.make_train_step(cfg, opt)
        for _ in range(4):
            params, state, m = step(params, state, b)
        finals.append((TC.tree_leaves(params), TC.tree_leaves(state)))
    for a, b_ in zip(finals[0][0] + finals[0][1], finals[1][0] + finals[1][1]):
        assert torch.equal(a, b_)
