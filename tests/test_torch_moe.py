"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``), on reduced DeepSeek-V3 (sigmoid router,
one shared expert) and Qwen3-MoE (softmax router, none) configs in f32 on
the CPU, with the same numpy parameters and inputs.

The routing integers (capacity, top-k expert ids, rank within the
expert, valid) must be bitwise equal: which tokens a full expert drops
depends on them.  The layer's output and its aux loss are held at 2e-5
of the output's largest magnitude (f32 sums of the same products in
another order; the gates and capacity slots are the same).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.compat import set_mesh

from repro.configs import base as jbase
from repro.launch.mesh import make_mesh
from repro.models import common as JC
from repro.models import moe as JM
from repro_torch.configs import base as tbase
from repro_torch.models import common as TC
from repro_torch.models import moe as TM

from torch_threads import one_thread  # noqa: F401

REL = 2e-5


def _close(out, ref, rel=REL):
    out = out.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max()) or 1.0
    err = float(np.abs(out - ref).max()) / scale
    assert err <= rel, f"max error / max|ref| = {err:.3e} > {rel:g}"


def _cfgs(arch, **kw):
    return (jbase.reduced_config(jbase.get_config(arch), **kw),
            tbase.reduced_config(tbase.get_config(arch), **kw))


def _tree(defs, rng, scale=0.3):
    return jax.tree_util.tree_map(
        lambda d: (rng.randn(*d.shape) * scale).astype(np.float32), defs,
        is_leaf=lambda x: isinstance(x, JC.ParamDef))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1, 1), ("pod", "data", "model"))


# ---------------------------------------------------------------------------
# routing integers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_tokens", [1, 8, 100, 512, 4096])
@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 8.0])
def test_capacity(n_tokens, cf):
    jcfg, tcfg = _cfgs("deepseek_v3_671b", capacity_factor=cf)
    assert TM._capacity(n_tokens, tcfg) == JM._capacity(n_tokens, jcfg)


def test_top_k_breaks_ties_toward_the_lower_expert():
    rng = np.random.RandomState(0)
    # scores on a coarse grid: many exact ties, in every position
    scores = (rng.randint(0, 6, (300, 16)) / 8.0).astype(np.float32)
    for k in (1, 2, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(scores), k)
        tv, ti = TM._top_k(torch.from_numpy(scores), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n_experts,tk", [(8, 64), (16, 1000), (256, 4096)])
def test_rank_within_expert(n_experts, tk):
    eid = np.random.RandomState(n_experts).randint(0, n_experts, tk)
    want = np.asarray(JM._rank_within_expert(jnp.asarray(eid, jnp.int32),
                                             n_experts))
    got = TM._rank_within_expert(torch.from_numpy(eid), n_experts)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch,cf", [("deepseek_v3_671b", 0.5),
                                     ("qwen3_moe_30b_a3b", 0.5),
                                     ("qwen3_moe_30b_a3b", 8.0)])
def test_routing_integers_equal_the_jax_package(arch, cf):
    """Expert ids, ranks and valid from each package's own router on the
    same tokens: bitwise equal."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf)
    rng = np.random.RandomState(4)
    tree = _tree(JM.moe_defs(jcfg), rng)
    x = rng.randn(256, jcfg.d_model).astype(np.float32)
    logits = jnp.einsum("td,de->te", jnp.asarray(x), jnp.asarray(tree["router"]))
    scores = (jax.nn.sigmoid(logits) if jcfg.router == "sigmoid"
              else jax.nn.softmax(logits, axis=-1))
    _, jeid = jax.lax.top_k(scores, jcfg.top_k)
    cap = JM._capacity(x.shape[0], jcfg)
    jpos = JM._rank_within_expert(jeid.reshape(-1), jcfg.n_experts)
    jvalid = np.asarray(jpos < cap).reshape(jeid.shape)

    tscores, _, teid = TM.route(TC.tree_map(torch.from_numpy, tree),
                                torch.from_numpy(x), tcfg)
    slot, valid = TM.dispatch_slots(teid, tcfg.n_experts,
                                    TM._capacity(x.shape[0], tcfg))
    np.testing.assert_array_equal(teid.numpy(), np.asarray(jeid))
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    jpos = np.asarray(jpos).reshape(jeid.shape)
    want_slot = np.where(jvalid, np.asarray(jeid) * cap + jpos,
                         tcfg.n_experts * cap)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    if cf < 1:
        assert not jvalid.all()          # the case drops tokens
    else:
        assert jvalid.all()
    _close(tscores, scores)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

LAYER_CASES = {
    # arch, overrides, local_path
    "sigmoid_shared_densified": ("deepseek_v3_671b", {}, "densified"),
    "sigmoid_shared_densified_drops": ("deepseek_v3_671b",
                                       {"capacity_factor": 0.5}, "densified"),
    "sigmoid_shared_blocked_drops": ("deepseek_v3_671b",
                                     {"capacity_factor": 0.5}, "blocked"),
    "sigmoid_unshared_densified": ("deepseek_v3_671b",
                                   {"n_shared_experts": 0}, "densified"),
    "softmax_densified": ("qwen3_moe_30b_a3b", {}, "densified"),
    "softmax_densified_drops": ("qwen3_moe_30b_a3b",
                                {"capacity_factor": 0.5}, "densified"),
    "softmax_blocked": ("qwen3_moe_30b_a3b", {}, "blocked"),
    "softmax_blocked_drops": ("qwen3_moe_30b_a3b", {"capacity_factor": 0.5},
                              "blocked"),
    "softmax_shared_blocked": ("qwen3_moe_30b_a3b", {"n_shared_experts": 1},
                               "blocked"),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_apply_matches_the_jax_package(case, mesh):
    arch, kw, path = LAYER_CASES[case]
    jcfg, tcfg = _cfgs(arch, **kw)
    rng = np.random.RandomState(5)
    tree = _tree(JM.moe_defs(jcfg), rng)
    # 512 tokens: capacity 64 at factor 0.5 (a whole block of 64 for the
    # blocked path) and 512 at the reduced configs' drop-free 8.0
    x = rng.randn(2, 256, jcfg.d_model).astype(np.float32)
    with set_mesh(mesh):
        ref, raux = jax.jit(lambda p, v: JM.moe_apply(
            p, v, jcfg, mesh=mesh, local_path=path))(
                jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    out, aux = TM.moe_apply(TC.tree_map(torch.from_numpy, tree),
                            torch.from_numpy(x), tcfg, local_path=path)
    assert out.shape == x.shape and aux.dtype == torch.float32
    _close(out, ref)
    assert float(aux) == pytest.approx(float(raux), rel=REL)


def test_blocked_equals_densified_within_the_port():
    jcfg, tcfg = _cfgs("qwen3_moe_30b_a3b", capacity_factor=0.5)
    rng = np.random.RandomState(6)
    params = TC.tree_map(torch.from_numpy, _tree(JM.moe_defs(jcfg), rng))
    x = torch.from_numpy(rng.randn(2, 256, tcfg.d_model).astype(np.float32))
    dense, aux_d = TM.moe_apply(params, x, tcfg)
    blocked, aux_b = TM.moe_apply(params, x, tcfg, local_path="blocked")
    _close(blocked, dense.numpy(), rel=1e-6)
    assert float(aux_b) == float(aux_d)
    with pytest.raises(ValueError, match="block_c"):
        TM.moe_apply(params, x, tcfg, local_path="blocked", block_c=48)


def test_a_dropped_token_gets_only_the_shared_expert():
    """At capacity 8, the tokens past an expert's first 8 get nothing
    from it; a token dropped by all its k experts gets only the shared
    expert's output."""
    jcfg, tcfg = _cfgs("deepseek_v3_671b", capacity_factor=0.01)
    rng = np.random.RandomState(7)
    tree = TC.tree_map(torch.from_numpy, _tree(JM.moe_defs(jcfg), rng))
    x = torch.from_numpy(rng.randn(1, 300, tcfg.d_model).astype(np.float32))
    out, _ = TM.moe_apply(tree, x, tcfg)
    _, _, eid = TM.route(tree, x[0], tcfg)
    _, valid = TM.dispatch_slots(eid, tcfg.n_experts, 8)
    dropped = ~valid.any(-1)
    assert dropped.sum() > 100
    sh = tree["shared"]
    h = x[0] @ sh["w_gate"]
    shared = (torch.nn.functional.silu(h) * (x[0] @ sh["w_up"])) @ sh["w_down"]
    torch.testing.assert_close(out[0][dropped], shared[dropped], rtol=1e-6,
                               atol=1e-6)
