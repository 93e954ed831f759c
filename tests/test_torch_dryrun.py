"""The port's cost counter and dry-run (``repro_torch.launch.cost_counter``,
``dryrun``) against the JAX package's HLO analysis.

FLOPs: the counter over the port's step on the meta device against
``repro.launch.hlo_analysis.analyze_hlo`` over the JAX package's compiled
step, at ``reduced_config`` in f32, B=2, S=64, on the CPU: forward and
decode within 1e-6 relative (observed equal), the train step within 1 %
(observed equal for Qwen2 and MusicGen, +0.34 % DeepSeek-V3, +0.43 %
RWKV-6: XLA simplifies a few products of their backward).  Also the
counter against ``FlopCounterMode`` (equal), decode_attention's meta
branch against ``FlopCounterMode`` over its plain version, the live-bytes
tracking, the microbatch replay, ``run_cell``'s JSON against what
``benchmarks/bench_roofline.py`` reads, and the CLI.
"""
import ast
import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.utils.flop_counter import FlopCounterMode

from repro.compat import make_mesh as jax_mesh
from repro.compat import set_mesh
from repro.configs import base as jbase
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro_torch.configs import base as tbase
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.launch import cost_counter as CC
from repro_torch.launch import dryrun
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as TE
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TTS

from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 64


@pytest.fixture(scope="module")
def mesh():
    return jax_mesh((1, 1), ("data", "model"))


def _cfgs(arch):
    return (jbase.reduced_config(jbase.get_config(arch)),
            tbase.reduced_config(tbase.get_config(arch)))


def _hlo_flops(mesh, fn, *args):
    with set_mesh(mesh):
        return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


def _inputs(jc, s):
    if jc.input_mode == "embeddings":
        return (jax.ShapeDtypeStruct((B, s, jc.d_model), jnp.float32),
                torch.empty((B, s, jc.d_model), device="meta"))
    return (jax.ShapeDtypeStruct((B, s), jnp.int32),
            torch.empty((B, s), dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "deepseek_v3_671b",
                                  "rwkv6_1_6b"])
def test_forward_flops_match_the_hlo(mesh, arch):
    jc, tc = _cfgs(arch)
    jx, tx = _inputs(jc, S)
    want = _hlo_flops(mesh, lambda p, x: JT.forward(p, x, jc, mesh)[0],
                      JT.model_param_shapes(jc), jx)
    with torch.no_grad():
        _, c = CC.count_costs(lambda p, x: TT.forward(p, x, tc)[0],
                              TT.model_param_shapes(tc), tx)
    assert c.flops == pytest.approx(want, rel=1e-6)
    assert c.flops_by_dtype.keys() == {"float32"}


@pytest.mark.parametrize("arch", tbase.ARCHS)
def test_decode_flops_match_the_hlo(mesh, arch):
    jc, tc = _cfgs(arch)
    jst = jax.eval_shape(lambda: JE.init_serve_state(jc, B, S))
    jtok, _ = _inputs(jc, 1)
    want = _hlo_flops(mesh, lambda p, s, t: JE.decode_step(p, s, t, jc, mesh),
                      JT.model_param_shapes(jc), jst, jtok)
    st, tok = TE.serve_input_specs(tc, batch=B, kv_len=S)
    _, c = CC.count_costs(TE.decode_step, TT.model_param_shapes(tc), st, tok,
                          tc)
    assert c.flops == pytest.approx(want, rel=1e-6)
    n_attn = sum(tc.layer_kind(l)[0] == "attention"
                 for l in range(tc.num_layers))
    assert c.charged.get("decode_attention", 0) == n_attn


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "deepseek_v3_671b",
                                  "rwkv6_1_6b", "musicgen_medium"])
def test_train_step_flops_match_the_hlo(mesh, arch):
    jc, tc = _cfgs(arch)
    jx, tx = _inputs(jc, S)
    jopt = JO.make_optimizer(JO.OptConfig())
    jp = JT.model_param_shapes(jc)
    want = _hlo_flops(mesh, JTS.make_train_step(jc, mesh, jopt), jp,
                      jax.eval_shape(jopt.init, jp),
                      {"inputs": jx,
                       "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)})
    topt = TO.make_optimizer(TO.OptConfig())
    tp = TT.model_param_shapes(tc)
    _, c = CC.count_costs(TTS.make_train_step(tc, topt), tp, topt.init(tp),
                          {"inputs": tx, "labels": torch.empty(
                              (B, S), dtype=torch.int32, device="meta")})
    assert c.flops == pytest.approx(want, rel=1e-2)


def test_counter_equals_flop_counter_mode_and_replay_equals_counting():
    """On CPU tensors the counter's FLOPs are FlopCounterMode's; two
    microbatches with the second replayed count as both run in full."""
    tc = tbase.reduced_config(tbase.get_config("jamba_v0_1_52b"), remat="full")
    params = TT.model_init(tc, torch.Generator().manual_seed(0), device="cpu")
    opt = TO.make_optimizer(TO.OptConfig())
    state = opt.init(params)
    batch = {"inputs": torch.zeros((4, 32), dtype=torch.int32),
             "labels": torch.zeros((4, 32), dtype=torch.int32)}
    step = TTS.make_train_step(tc, opt, n_microbatches=2)
    with FlopCounterMode(display=False) as f:
        step(params, state, batch)
    _, full = CC.count_costs(step, params, state, batch)
    _, rep = CC.count_costs(step, params, state, batch,
                            replay=((TTS, "_grads_of"),))
    assert full.flops == f.get_total_flops() == rep.flops
    assert full.n_ops == rep.n_ops and full.hbm_bytes == rep.hbm_bytes
    assert full.peak_live_bytes == rep.peak_live_bytes > full.argument_bytes
    # bf16 on meta, three microbatches: a replayed call holds no tensor of
    # the first call alive (its bf16 gradients die after the f32 cast)
    tc = dataclasses.replace(tc, dtype="bfloat16")
    params = TT.model_param_shapes(tc)
    state = opt.init(params)
    batch = {k: v.to("meta").repeat(3, 1) for k, v in batch.items()}
    step = TTS.make_train_step(tc, opt, n_microbatches=3)
    _, full = CC.count_costs(step, params, state, batch)
    _, rep = CC.count_costs(step, params, state, batch,
                            replay=((TTS, "_grads_of"),))
    assert (full.flops, full.n_ops, full.hbm_bytes, full.peak_live_bytes) == \
        (rep.flops, rep.n_ops, rep.hbm_bytes, rep.peak_live_bytes)


def test_live_bytes_follow_autograd():
    """A chain of 8 matmul + relu: after the forward the 8 relu outputs
    autograd saves are live (and the argument); the backward frees them."""
    x = torch.empty((64, 256), device="meta", requires_grad=True)
    w = torch.empty((256, 256), device="meta")
    seen = {}

    def fwd_bwd(x, w):
        h = x
        for _ in range(8):
            h = torch.relu(h @ w)
        seen["after_forward"] = CC.active().live_bytes
        h.sum().backward()
        del h
        seen["after_backward"] = CC.active().live_bytes

    _, c = CC.count_costs(fwd_bwd, x, w)
    act = 64 * 256 * 4
    args = act + 256 * 256 * 4
    assert c.argument_bytes == args
    # 8 saved relu outputs, the live h (the last of them) among them
    assert seen["after_forward"] == args + 8 * act
    # x.grad (the gradient) stays; every activation is gone
    assert seen["after_backward"] == args + act
    # 8 products forward, 8 backward (the gradients of the inputs)
    assert c.flops == 16 * 2 * 64 * 256 * 256


def test_decode_attention_meta_branch_charges_its_cost():
    b, h, hkv, dh, s = 2, 6, 2, 64, 96
    mk = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt,
                                                       device="meta")
    q, k, v, cur = mk(b, 1, h, dh), mk(b, s, hkv, dh), mk(b, s, hkv, dh), \
        mk(1, dt=torch.int32)
    before = da.decode_attention.launches
    assert not CC.charge("decode_attention", flops=1.0)  # no counter
    out = da.decode_attention(q, k, v, cur)
    assert out.shape == (b, 1, h, dh) and out.device.type == "meta"
    assert da.decode_attention.launches == before
    _, c = CC.count_costs(da.decode_attention, q, k, v, cur)
    # FlopCounterMode over the plain version on the CPU, all S rows
    qc, kc, vc = (torch.randn(t.shape) for t in (q, k, v))
    with FlopCounterMode(display=False) as f:
        plain = da.decode_attention(qc, kc, vc,
                                    torch.tensor([s], dtype=torch.int32))
    assert plain.shape == out.shape and da.decode_attention.launches == before
    assert c.flops == f.get_total_flops() == 4 * b * h * s * dh
    assert c.flops_by_dtype == {"float32": c.flops}
    assert c.hbm_bytes == (2 * b * h * dh + 2 * b * s * hkv * dh) * 4 + 4
    assert c.charged == {"decode_attention": 1}
    # the CUDA branch's checks hold on meta too
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention(q, mk(b, hkv, s, dh).transpose(1, 2), v, cur)
    big = mk(b, 1, hkv, 320)
    with pytest.raises(ValueError, match="exceeds"):
        da.decode_attention(big, mk(b, s, hkv, 320), mk(b, s, hkv, 320), cur)


def _bench_roofline():
    spec = importlib.util.spec_from_file_location(
        "bench_roofline", os.path.join(REPO, "benchmarks", "bench_roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_cell_writes_what_bench_roofline_reads(tmp_path):
    shapes = [tbase.ShapeConfig("train_s", 32, 4, "train"),
              tbase.ShapeConfig("decode_s", 64, 2, "decode")]
    recs = []
    for arch in ("qwen2_1_5b", "deepseek_v3_671b"):
        cfg = tbase.reduced_config(tbase.get_config(arch))
        for shape in shapes:
            recs.append(dryrun.run_cell(arch, shape, cfg=cfg,
                                        out_dir=str(tmp_path)))
    rows = _bench_roofline().load(str(tmp_path))
    assert len(rows) == 4 and all("C_ms" in r for r in rows)
    for r in recs:
        assert r["status"] == "ok" and r["hw"] == "h100_sxm"
        assert r["hlo_costs"]["flops"] > 0 and r["fits_hbm"]
        assert r["memory"]["peak_per_device_bytes"] >= \
            r["memory"]["argument_bytes"] > 0
        assert 0 < r["useful_flop_ratio"] < 2
    assert len(dryrun.summary(recs).splitlines()) == 1 + len(recs)
    long = dryrun.run_cell("qwen2_1_5b", "long_500k", out_dir=str(tmp_path))
    assert long["status"] == "skipped" and "full-attention" in long["why"]


def test_cli_on_the_production_meshes(tmp_path, capsys):
    """Rank 0 of each production mesh counted on meta: the CLI over the
    decode cells, then a train and a prefill cell of each arch on both
    production meshes at ``reduced_config`` and a 64-token sequence, the
    global batches kept (at full size a train_4k cell's count on a
    production mesh takes 30-90 s, RWKV-6's ~20 min)."""
    code = dryrun.main(["--arch", "qwen2_1_5b,rwkv6-1-6b", "--shape",
                        "decode_32k,long_500k", "--mesh",
                        "production,production-multipod", "--out",
                        str(tmp_path)])
    out = capsys.readouterr().out
    assert code == 0
    assert "== dry-run summary: 6 ok, 2 skipped (documented), 0 FAILED" in out
    rec = dryrun.run_cell("qwen2_1_5b", "decode_32k", mesh="production")
    parts = rec["memory"]["argument_bytes_by_part"]
    # one rank's count: compute, HBM and NVLink terms, a peak above the
    # arguments, and the collectives of a tensor-parallel decode
    assert rec["hlo_costs"]["flops"] > 0 and rec["n_chips"] == 256
    assert rec["roofline"]["collective_s"] > 0
    assert rec["hlo_costs"]["collective_bytes"]["psum"] > 0
    assert rec["memory"]["peak_per_device_bytes"] >= \
        rec["memory"]["argument_bytes"] == sum(parts.values())
    assert 0 < rec["useful_flop_ratio"] < 2
    # bf16 weights: the vocabulary over 8 model ranks, the layers'
    # projections where their heads divide 8; the cache over all 256
    assert 0 < parts["params"] < 2 * 4.01e9 / 8
    assert parts["state"] * 256 == pytest.approx(
        sum(t.numel() * 2 for t in TT.cache_shapes(
            tbase.get_config("qwen2_1_5b"), 128, 32768)[0][0]), rel=1e-6)
    for mesh, n_chips in (("production", 256), ("production-multipod", 512)):
        for arch in ("qwen2_1_5b", "rwkv6_1_6b"):
            cfg = tbase.reduced_config(tbase.get_config(arch))
            for name in ("train_4k", "prefill_32k"):
                shape = dataclasses.replace(tbase.SHAPES[name], seq_len=64)
                rec = dryrun.run_cell(arch, shape, mesh=mesh, cfg=cfg)
                mem = rec["memory"]
                assert rec["status"] == "ok" and rec["n_chips"] == n_chips
                assert rec["hlo_costs"]["flops"] > 0
                assert rec["roofline"]["compute_s"] > 0
                assert rec["roofline"]["collective_s"] > 0
                assert mem["peak_per_device_bytes"] >= \
                    mem["argument_bytes"] > 0
                assert 0 < rec["useful_flop_ratio"] < 2
                assert rec["fits_hbm"]


def test_sequence_parallel_cuts_the_counted_peak_of_a_production_step():
    """Qwen2-1.5B at its published widths, 28 -> 4 layers (a cell of 28
    takes ~35 s to count), train_4k on rank 0 of 32 x 8 (``mesh_for``'s
    ``make_meta_rank_mesh((32, 8), ...)``) with and without
    ``sequence_parallel``: one microbatch either way, and the rank's peak
    live bytes fall where it keeps 1/8 of the residual's rows between
    layers (10.30 against 11.00 GB counted); its blocks' reduce-scatters
    are counted."""
    recs = {}
    for sp in (False, True):
        cfg = dataclasses.replace(tbase.get_config("qwen2_1_5b"),
                                  num_layers=4, sequence_parallel=sp)
        recs[sp] = dryrun.run_cell("qwen2_1_5b", "train_4k",
                                   mesh="production", cfg=cfg)
        assert recs[sp]["status"] == "ok" and recs[sp]["n_chips"] == 256
        assert recs[sp]["n_microbatches"] == 1
    peak = {sp: r["memory"]["peak_per_device_bytes"]
            for sp, r in recs.items()}
    assert peak[True] < peak[False]
    assert recs[True]["memory"]["argument_bytes"] == \
        recs[False]["memory"]["argument_bytes"]
    scatter = {sp: r["hlo_costs"]["collective_bytes"].get("psum_scatter", 0)
               for sp, r in recs.items()}
    assert scatter[True] > scatter[False]


# ---- the A/B flags: --override, --micro, --tag -------------------------

def _reference_parse():
    """The JAX dry-run's override parse: the ``if overrides:`` block of
    ``repro/launch/dryrun.py``'s ``run_cell``, compiled from the file's
    source (importing that module would set ``XLA_FLAGS`` for the
    process).  Returns ``parse(cfg, overrides) -> (typed, new_cfg)``."""
    path = os.path.join(REPO, "src", "repro", "launch", "dryrun.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    block = next(n for n in fn.body if isinstance(n, ast.If)
                 and ast.unparse(n.test) == "overrides")
    code = compile(ast.Module(body=block.body, type_ignores=[]), path, "exec")

    def parse(cfg, overrides):
        ns = {"cfg": cfg, "overrides": overrides}
        exec(code, ns)
        return ns["typed"], ns["cfg"]

    return parse


_FIELDS = {
    "int": ["num_layers", "d_ff", "head_pad_factor", "n_experts",
            "long_seq_threshold"],
    "bool": ["glu", "qkv_bias", "sequence_parallel", "moe_small_t_partial"],
    "float": ["rope_theta", "capacity_factor", "mtp_weight"],
    "str": ["norm", "act", "remat", "router", "dtype"],
}
_VALUES = st.one_of(
    st.sampled_from(["True", "False", "true", "false", "1", "0", "yes",
                     "", "1e6", "full", "-3"]),
    st.integers(-10, 10 ** 6).map(str),
    st.floats(allow_nan=False, allow_infinity=False).map(repr),
    st.text(max_size=6))


def _typed(kind_field_value):
    return {f: v for _, f, v in kind_field_value}


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the same exception type, or the same value
        return "raises", type(e)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.sampled_from(sorted(_FIELDS)).flatmap(
    lambda kind: st.tuples(st.just(kind), st.sampled_from(_FIELDS[kind]),
                           _VALUES)), min_size=1, max_size=3))
def test_typed_overrides_equal_the_reference_parse(draws):
    """The port's ``typed_overrides`` against the JAX dry-run's own parse
    on int, bool, float and str fields: the same values of the same
    types (or the same exception), and the same configuration field
    after ``dataclasses.replace``."""
    overrides = _typed(draws)
    parse = _reference_parse()
    jcfg = jbase.get_config("qwen2_1_5b")
    tcfg = tbase.get_config("qwen2_1_5b")
    want = _outcome(lambda: parse(jcfg, dict(overrides)))
    got = _outcome(lambda: dryrun.typed_overrides(tcfg, dict(overrides)))
    assert want[0] == got[0]
    if want[0] == "raises":
        assert want[1] is got[1]
        return
    (jtyped, jnew), typed = want[1], got[1]
    assert typed == jtyped
    assert {k: type(v) for k, v in typed.items()} == \
        {k: type(v) for k, v in jtyped.items()}
    tnew = dataclasses.replace(tcfg, **typed)
    for k in overrides:
        assert getattr(tnew, k) == getattr(jnew, k)
        assert type(getattr(tnew, k)) is type(getattr(jnew, k))


def test_typed_overrides_copy_the_reference_quirks():
    """A float field keeps its string (``rope_theta``), "True" on a str
    field becomes True, a bool field reads "1" and "true" as True and
    anything else as False, as the reference's parse does; an unknown
    key raises ``KeyError`` in both."""
    parse = _reference_parse()
    jcfg, tcfg = jbase.get_config("qwen2_1_5b"), tbase.get_config(
        "qwen2_1_5b")
    cases = {"rope_theta": "1e6", "head_pad_factor": "1", "remat": "True",
             "qkv_bias": "1", "glu": "no"}
    typed = dryrun.typed_overrides(tcfg, cases)
    assert typed == {"rope_theta": "1e6", "head_pad_factor": 1,
                     "remat": True, "qkv_bias": True, "glu": False}
    assert typed == parse(jcfg, dict(cases))[0]
    with pytest.raises(KeyError):
        parse(jcfg, {"no_such_field": "1"})
    with pytest.raises(KeyError):
        dryrun.typed_overrides(tcfg, {"no_such_field": "1"})
    with pytest.raises(KeyError):
        dryrun.run_cell("qwen2_1_5b", "decode_32k",
                        overrides={"no_such_field": "1"})


_AB = ["--arch", "qwen2_1_5b", "--shape", "train_4k,decode_32k", "--mesh",
       "1x1", "--override", "num_layers=1", "--override", "head_pad_factor=1",
       "--override", "d_model=128", "--override", "num_heads=4",
       "--override", "num_kv_heads=2", "--override", "d_ff=256",
       "--override", "vocab_size=512", "--micro", "2", "--tag", "_ab"]


def _ab_records(out_dir):
    names = sorted(os.listdir(out_dir))
    assert names == ["qwen2_1_5b__decode_32k__1x1_ab.json",
                     "qwen2_1_5b__train_4k__1x1_ab.json"]
    recs = {}
    for name in names:
        with open(os.path.join(out_dir, name)) as f:
            rec = json.load(f)
        recs[rec["shape"]] = rec
    return recs


def _held_ab(recs):
    """--micro reaches the train cell's record (its default is 1 at this
    size), the overrides its configuration: the argument bytes are those
    of ``run_cell`` on the replaced configuration, not the published."""
    assert all(r["status"] == "ok" for r in recs.values())
    assert recs["train_4k"]["n_microbatches"] == 2
    cfg = dataclasses.replace(
        tbase.get_config("qwen2_1_5b"), num_layers=1, head_pad_factor=1,
        d_model=128, num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512)
    want = dryrun.run_cell("qwen2_1_5b", "decode_32k", cfg=cfg)
    published = dryrun.run_cell("qwen2_1_5b", "decode_32k")
    got = recs["decode_32k"]["memory"]["argument_bytes"]
    assert got == want["memory"]["argument_bytes"]
    assert got != published["memory"]["argument_bytes"]
    assert recs["decode_32k"]["hlo_costs"] == want["hlo_costs"]


def test_cli_override_micro_and_tag_through_jobs(tmp_path, capsys):
    """The three flags on the CLI with ``--jobs 2``: each cell, counted
    in a spawned process, gets ``--override``, ``--micro`` and
    ``--tag``; without ``--micro`` the train cell takes one
    microbatch."""
    assert dryrun.main(_AB + ["--out", str(tmp_path), "--jobs", "2"]) == 0
    assert "2 ok, 0 skipped" in capsys.readouterr().out
    _held_ab(_ab_records(str(tmp_path)))
    plain = dryrun.run_cell("qwen2_1_5b", "train_4k", overrides={
        "num_layers": "1", "d_model": "128", "num_heads": "4",
        "num_kv_heads": "2", "d_ff": "256", "vocab_size": "512"})
    assert plain["n_microbatches"] == 1


def test_cli_unknown_override_fails_its_cell(capsys):
    """In one process, an unknown key fails the cell with the KeyError
    and the CLI exits 1, as the reference's does."""
    assert dryrun.main(["--arch", "qwen2_1_5b", "--shape", "decode_32k",
                        "--mesh", "1x1", "--override", "no_such=1"]) == 1
    out = capsys.readouterr().out
    assert "KeyError" in out and "1 FAILED" in out
