"""The port's model modules against the JAX package's, at reduced size in
f32 on the CPU, with the same inputs and the same parameters (made with
numpy from a seed, or drawn by the JAX package and carried over with
``params_from_numpy``).

Tolerances: elementwise functions (norms, RoPE, activations, sinusoidal
positions) 1e-6; the attention block and the FFN 2e-5 of the output's
largest magnitude, a whole forward 1e-4 (observed up to 3.3e-5, for
starcoder2's four layers), since the two frameworks sum the same f32
products in different orders and the JAX package's init rule gives
activations of size ~10-100.

Reduced Jamba is the exception.  The init rule draws every weight of a
stack of one layer at std 1 (its ``shape[0]`` is the layer count), so
its residual stream reaches ~1e13 and each Mamba and MoE layer
multiplies a relative change of its input by up to ~17: one f32 ulp on
the JAX package's own input embeddings moves its logits by 1.9e-4 of
their largest magnitude (``test_forward`` measures it every run).  So
its whole forward is held at JAMBA_FORWARD_REL, 16 times that, and each
layer, given the JAX package's input to it, at FORWARD_REL
(``test_forward_layer_by_layer``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.compat import set_mesh

from repro.configs import base as jbase
from repro.launch.mesh import make_mesh
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import ffn as JF
from repro.models import transformer as JT
from repro_torch.configs import base as tbase
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import ffn as TF
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy

from torch_threads import one_thread  # noqa: F401

ELEM = dict(rtol=1e-6, atol=1e-6)
REL = 2e-5
FORWARD_REL = 1e-4
JAMBA_FORWARD_REL = 3e-3


def _close(out, ref, rel=REL):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max()) or 1.0
    err = float(np.abs(out - ref).max()) / scale
    assert err <= rel, f"max error / max|ref| = {err:.3e} > {rel:g}"


def _numpy_tree(defs, rng, scale=0.2):
    """Random values for every leaf of a JAX ParamDef tree (biases and
    norm scales too, so every term is exercised)."""
    return jax.tree_util.tree_map(
        lambda d: (rng.randn(*d.shape) * scale).astype(np.float32), defs,
        is_leaf=lambda x: isinstance(x, JC.ParamDef))


def _to_torch(tree):
    return TC.tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def _cfg(arch, **kw):
    return jbase.reduced_config(jbase.get_config(arch), **kw), \
        tbase.reduced_config(tbase.get_config(arch), **kw)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jbase.ARCHS)
def test_configs_are_equal_field_for_field(arch):
    ref, port = jbase.get_config(arch), tbase.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(tbase.reduced_config(port)) == \
        dataclasses.asdict(jbase.reduced_config(ref))
    assert [port.layer_kind(l) for l in range(port.num_layers)] == \
        [ref.layer_kind(l) for l in range(ref.num_layers)]


def test_registry_and_shapes_are_equal():
    assert tbase.ARCHS == jbase.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}


# ---------------------------------------------------------------------------
# elementwise substrate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def xs():
    rng = np.random.RandomState(0)
    return (rng.randn(2, 5, 3, 64) * 3).astype(np.float32), rng


def test_norms(xs):
    x, rng = xs
    w = rng.randn(64).astype(np.float32)
    bias = rng.randn(64).astype(np.float32)
    np.testing.assert_allclose(
        TC.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(JC.rms_norm(jnp.asarray(x), jnp.asarray(w))), **ELEM)
    np.testing.assert_allclose(
        TC.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(bias)).numpy(),
        np.asarray(JC.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(bias))), **ELEM)


@pytest.mark.parametrize("name", ["gelu", "silu", "relu", "relu2"])
def test_activations(xs, name):
    x, _ = xs
    np.testing.assert_allclose(
        TC.act_fn(name)(torch.from_numpy(x)).numpy(),
        np.asarray(JC.act_fn(name)(jnp.asarray(x))), **ELEM)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(xs, theta):
    x, rng = xs
    pos = rng.randint(0, 2048, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        TC.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy(),
        np.asarray(JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)),
        rtol=1e-6, atol=2e-5)  # |x| ~ 10: atol is a few f32 steps of it


def test_sinusoidal_positions():
    pos = np.arange(0, 64, 3, dtype=np.int32).reshape(1, -1)
    np.testing.assert_allclose(
        TC.sinusoidal_positions(torch.from_numpy(pos), 48).numpy(),
        np.asarray(JC.sinusoidal_positions(jnp.asarray(pos), 48)), **ELEM)


# ---------------------------------------------------------------------------
# attention and FFN blocks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def attn_setup():
    jcfg, tcfg = _cfg("qwen2_1_5b")       # GQA, qkv bias, head_pad_factor 4
    rng = np.random.RandomState(1)
    tree = _numpy_tree(JA.attention_defs(jcfg), rng)
    b, s = 2, 64
    x = rng.randn(b, s, jcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return jcfg, tcfg, tree, x, pos, rng


@pytest.mark.parametrize("branch", ["full", "blockwise"])
def test_attention_prefill_branches(attn_setup, branch):
    jcfg, tcfg, tree, x, pos, _ = attn_setup
    # 64 tokens over a threshold of 16 with 16-wide blocks: 4 q blocks
    kw = (dict(block_q=16, block_kv=16, long_seq_threshold=16)
          if branch == "blockwise" else dict(long_seq_threshold=1024))
    ref, (rk, rv) = JA.attention_apply(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
        jnp.asarray(pos), jcfg, **kw)
    out, (k, v) = TA.attention_apply(_to_torch(tree), torch.from_numpy(x),
                                     torch.from_numpy(pos), tcfg, **kw)
    _close(out, ref)
    _close(k, rk)
    _close(v, rv)


def test_blockwise_equals_full_within_the_port(attn_setup):
    _, tcfg, tree, x, pos, _ = attn_setup
    p, tx, tp = _to_torch(tree), torch.from_numpy(x), torch.from_numpy(pos)
    full, _ = TA.attention_apply(p, tx, tp, tcfg, long_seq_threshold=1024)
    blk, _ = TA.attention_apply(p, tx, tp, tcfg, block_q=16, block_kv=16,
                                long_seq_threshold=16)
    _close(blk, full.numpy(), rel=1e-5)


def test_attention_decode_branch(attn_setup):
    jcfg, tcfg, tree, _, _, rng = attn_setup
    _, hkv = JA.effective_heads(jcfg)
    b, smax, cur = 2, 40, 17
    x = rng.randn(b, 1, jcfg.d_model).astype(np.float32)
    kc = rng.randn(b, smax, hkv, jcfg.head_dim).astype(np.float32)
    vc = rng.randn(b, smax, hkv, jcfg.head_dim).astype(np.float32)
    pos = np.full((b, 1), cur, np.int32)
    ref, (rk, rv) = JA.attention_apply(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
        jnp.asarray(pos), jcfg,
        cache=(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(cur, jnp.int32)))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out, (nk, nv) = TA.attention_apply(
        _to_torch(tree), torch.from_numpy(x), torch.from_numpy(pos), tcfg,
        cache=(tk, tv, torch.tensor([cur], dtype=torch.int32)))
    assert nk is tk and nv is tv          # written in place
    _close(out, ref)
    _close(nk, rk)
    _close(nv, rv)
    # only row `cur` changed
    changed = np.flatnonzero((nk.numpy() != kc).any(axis=(0, 2, 3)))
    assert changed.tolist() == [cur]


@pytest.mark.parametrize("arch,overrides", [
    ("qwen2_1_5b", {}),                    # GLU (SiLU), no MLP bias
    ("qwen2_1_5b", {"mlp_bias": True}),    # GLU with biases
    ("starcoder2_3b", {}),                 # plain GELU (tanh) with biases
])
def test_ffn(arch, overrides):
    jcfg, tcfg = _cfg(arch)
    jcfg = dataclasses.replace(jcfg, **overrides)
    tcfg = dataclasses.replace(tcfg, **overrides)
    rng = np.random.RandomState(2)
    tree = _numpy_tree(JF.ffn_defs(jcfg), rng)
    x = rng.randn(2, 7, jcfg.d_model).astype(np.float32)
    ref = JF.ffn_apply(jax.tree_util.tree_map(jnp.asarray, tree),
                       jnp.asarray(x), jcfg)
    out = TF.ffn_apply(_to_torch(tree), torch.from_numpy(x), tcfg)
    _close(out, ref)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1, 1), ("pod", "data", "model"))


FORWARD_CASES = {
    "qwen2_1_5b": ("qwen2_1_5b", {}),
    "starcoder2_3b": ("starcoder2_3b", {}),    # layernorm, GELU, biases
    "granite_20b": ("granite_20b", {}),       # MQA
    "qwen2_1_5b_blockwise": ("qwen2_1_5b", dict(long_seq_threshold=8,
                                                attn_block_q=8,
                                                attn_block_kv=8)),
    "deepseek_v3_671b": ("deepseek_v3_671b", {}),  # MLA, sigmoid MoE, MTP
    "qwen3_moe_30b_a3b": ("qwen3_moe_30b_a3b", {}),  # softmax MoE, QK-norm
    "jamba_v0_1_52b": ("jamba_v0_1_52b", {}),      # Mamba, GQA, MoE
    "rwkv6_1_6b": ("rwkv6_1_6b", {}),              # time and channel mix
    "deepseek_v3_671b_blockwise": ("deepseek_v3_671b",
                                   dict(long_seq_threshold=8, attn_block_q=8,
                                        attn_block_kv=8)),
}


def _forward_fn(jcfg, mesh):
    return jax.jit(lambda p, t: JT.forward(p, t, jcfg, mesh))


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward(case, mesh):
    arch, kw = FORWARD_CASES[case]
    jcfg, tcfg = _cfg(arch, **kw)
    params = JT.model_init(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.RandomState(3).randint(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    fwd = _forward_fn(jcfg, mesh)
    with set_mesh(mesh):
        logits, hidden, jaux, _ = fwd(params, tokens)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                tcfg, device="cpu")
    out, thidden, aux, cache = TT.forward(tparams, torch.from_numpy(tokens),
                                          tcfg)
    assert out.shape == (2, 16, tcfg.vocab_size) and cache is None
    assert aux.dtype == torch.float32
    if tcfg.moe:
        assert float(aux) > 0
        assert float(aux) == pytest.approx(float(jaux), rel=FORWARD_REL)
    else:
        assert float(aux) == float(jaux) == 0.0
    rel = FORWARD_REL
    if arch == "jamba_v0_1_52b":
        # the reference's own sensitivity: one ulp on its input embeddings
        emb = np.asarray(jnp.take(params["embed"], tokens, axis=0))
        with set_mesh(mesh):
            moved = fwd(params, np.nextafter(emb, np.float32(np.inf)))[0]
        lg = np.asarray(logits)
        ulp = float(np.abs(np.asarray(moved) - lg).max() / np.abs(lg).max())
        assert ulp > FORWARD_REL and JAMBA_FORWARD_REL >= 10 * ulp, ulp
        rel = JAMBA_FORWARD_REL
    _close(out, logits, rel)
    _close(thidden, hidden, rel)
    assert np.array_equal(out.argmax(-1).numpy(),
                          np.asarray(logits).argmax(-1))


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "qwen3_moe_30b_a3b",
                                  "jamba_v0_1_52b", "rwkv6_1_6b"])
def test_forward_layer_by_layer(arch, mesh):
    """Each layer, given the JAX package's input to it, gives the JAX
    package's output and aux loss within FORWARD_REL."""
    jcfg, tcfg = _cfg(arch)
    params = JT.model_init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                tcfg, device="cpu")
    tokens = np.random.RandomState(3).randint(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    x = np.array(jnp.take(params["embed"], tokens, axis=0))
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    n_layers = 0
    for si, (n_rep, period) in enumerate(JT.segment_plan(jcfg)):
        for i in range(n_rep):
            for pi, kind in enumerate(period):
                jl = jax.tree_util.tree_map(lambda t: t[i],
                                            params["segments"][si][pi])
                tl = TC.tree_map(lambda t: t[i], tparams["segments"][si][pi])
                with set_mesh(mesh):
                    jx, jaux, _ = jax.jit(
                        lambda p, v, _k=kind: JT._apply_layer(
                            _k, p, v, jnp.asarray(pos), jcfg, mesh, None,
                            None))(jl, x)
                tx, taux, nc = TT._apply_layer(
                    kind, tl, torch.from_numpy(x), torch.from_numpy(pos),
                    tcfg, None, None)
                assert nc is None
                _close(tx, jx, FORWARD_REL)
                assert (taux is None) == (kind[1] != "moe")
                assert float(0.0 if taux is None else taux) == \
                    pytest.approx(float(jaux), rel=FORWARD_REL)
                x = np.array(jx)
                n_layers += 1
    assert n_layers == jcfg.num_layers


def test_init_rule_std_per_leaf():
    """std = scale / sqrt(shape[0]); for a layer stack shape[0] is the
    layer count.  Both packages draw every leaf at that std."""
    jcfg, tcfg = _cfg("starcoder2_3b", num_layers=3, vocab_size=4096)
    tparams = TT.model_init(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    jparams = JT.model_init(jcfg, jax.random.PRNGKey(0))
    defs = TT.model_defs(tcfg)
    leaves = TC.tree_leaves(defs, is_leaf=lambda d: isinstance(d, TC.ParamDef))
    tl = TC.tree_leaves(tparams)
    jl = jax.tree_util.tree_leaves(jparams)
    assert len(leaves) == len(tl) == len(jl)
    for d, t, j in zip(leaves, tl, jl):
        j = np.asarray(j)
        assert tuple(t.shape) == d.shape == j.shape
        if d.init in ("zeros", "ones"):
            want = 0.0 if d.init == "zeros" else 1.0
            assert (t == want).all() and (j == want).all()
            continue
        std = d.scale / np.sqrt(d.shape[0] if len(d.shape) > 1 else d.shape[-1])
        if len(d.shape) > 2:
            assert std == pytest.approx(1 / np.sqrt(3))   # the layer count
        for got in (float(t.std()), float(j.std())):
            assert got == pytest.approx(std, rel=0.03), (d.shape, got, std)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", jbase.ARCHS)
def test_param_and_cache_shapes_match_the_jax_package(arch):
    """Parameters and caches, leaf for leaf in the same order, with the
    same shapes and (caches) dtypes; the JAX package's parameters carry
    over."""
    jcfg, tcfg = _cfg(arch, dtype="bfloat16")
    tshapes = TC.tree_leaves(TT.model_param_shapes(tcfg))
    jshapes = jax.tree_util.tree_leaves(JT.model_param_shapes(jcfg))
    assert [tuple(t.shape) for t in tshapes] == [j.shape for j in jshapes]
    tc = TC.tree_leaves(TT.cache_shapes(tcfg, 3, 20))
    jc = jax.tree_util.tree_leaves(JT.cache_shapes(jcfg, 3, 20))
    assert [(tuple(t.shape), _dtype_name(t.dtype)) for t in tc] == \
        [(j.shape, str(j.dtype)) for j in jc]
    assert TT.segment_plan(tcfg) == JT.segment_plan(jcfg)
    jcfg, tcfg = _cfg(arch)
    params = JT.model_init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                tcfg, device="cpu")
    for t, j in zip(TC.tree_leaves(tparams), jax.tree_util.tree_leaves(params)):
        assert np.array_equal(t.numpy(), np.asarray(j))
