"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against the JAX package's (``repro.models.mla``), on the reduced
DeepSeek-V3 config in f32 on the CPU, with the same numpy parameters and
inputs.

Outputs and caches are held at 2e-5 of their largest magnitude (f32 sums
of the same products in another order).  Within the port, the absorbed
decode equals the expanded path at the same position to 2e-5: the two
forms contract wk_b and wv_b in another order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import common as JC
from repro.models import mla as JL
from repro_torch.configs import base as tbase
from repro_torch.models import common as TC
from repro_torch.models import mla as TL

from torch_threads import one_thread  # noqa: F401

REL = 2e-5


def _close(out, ref, rel=REL):
    out = out.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max()) or 1.0
    err = float(np.abs(out - ref).max()) / scale
    assert err <= rel, f"max error / max|ref| = {err:.3e} > {rel:g}"


@pytest.fixture(scope="module")
def setup():
    jcfg = jbase.reduced_config(jbase.get_config("deepseek_v3_671b"))
    tcfg = tbase.reduced_config(tbase.get_config("deepseek_v3_671b"))
    rng = np.random.RandomState(11)
    tree = jax.tree_util.tree_map(
        lambda d: (rng.randn(*d.shape) / np.sqrt(d.shape[0])).astype(np.float32),
        JL.mla_defs(jcfg), is_leaf=lambda x: isinstance(x, JC.ParamDef))
    b, s = 2, 48
    x = rng.randn(b, s, jcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return jcfg, tcfg, tree, x, pos, rng


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return TC.tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)


@pytest.mark.parametrize("branch", ["full", "blockwise"])
def test_mla_prefill_branches(setup, branch):
    jcfg, tcfg, tree, x, pos, _ = setup
    # 48 tokens over a threshold of 16 with 16-wide blocks: 3 q blocks
    kw = (dict(block_q=16, block_kv=16, long_seq_threshold=16)
          if branch == "blockwise" else dict(long_seq_threshold=1024))
    ref, (rc, rr) = JL.mla_apply(_jax(tree), jnp.asarray(x), jnp.asarray(pos),
                                 jcfg, **kw)
    out, (c, r) = TL.mla_apply(_torch(tree), torch.from_numpy(x),
                               torch.from_numpy(pos), tcfg, **kw)
    _close(out, ref)
    _close(c, rc)
    _close(r, rr)
    assert c.shape == (2, 48, jcfg.kv_lora_rank)
    assert r.shape == (2, 48, jcfg.qk_rope_dim)


def test_mla_absorbed_decode(setup):
    jcfg, tcfg, tree, _, _, rng = setup
    b, smax, cur = 2, 40, 17
    x = rng.randn(b, 1, jcfg.d_model).astype(np.float32)
    cc = rng.randn(b, smax, jcfg.kv_lora_rank).astype(np.float32)
    rc = rng.randn(b, smax, jcfg.qk_rope_dim).astype(np.float32)
    pos = np.full((b, 1), cur, np.int32)
    ref, (jc, jr) = JL.mla_apply(
        _jax(tree), jnp.asarray(x), jnp.asarray(pos), jcfg,
        cache=(jnp.asarray(cc), jnp.asarray(rc), jnp.asarray(cur, jnp.int32)))
    tc, tr = torch.from_numpy(cc.copy()), torch.from_numpy(rc.copy())
    out, (nc, nr) = TL.mla_apply(
        _torch(tree), torch.from_numpy(x), torch.from_numpy(pos), tcfg,
        cache=(tc, tr, torch.tensor([cur], dtype=torch.int32)))
    assert nc is tc and nr is tr              # written in place
    _close(out, ref)
    _close(nc, jc)
    _close(nr, jr)
    for new, old in ((nc, cc), (nr, rc)):     # only row `cur` changed
        changed = np.flatnonzero((new.numpy() != old).any(axis=(0, 2)))
        assert changed.tolist() == [cur]


def test_absorbed_decode_equals_the_expanded_path(setup):
    """Prefill the first s-1 tokens, decode token s through the latent
    cache: its output equals the expanded path's at position s-1."""
    _, tcfg, tree, x, pos, _ = setup
    params = _torch(tree)
    tx, tp = torch.from_numpy(x), torch.from_numpy(pos)
    s = x.shape[1]
    full, _ = TL.mla_apply(params, tx, tp, tcfg, long_seq_threshold=1024)
    _, (c, r) = TL.mla_apply(params, tx[:, :s - 1], tp[:, :s - 1], tcfg,
                             long_seq_threshold=1024)
    smax = s + 8
    cc = torch.zeros((2, smax, tcfg.kv_lora_rank))
    rc = torch.zeros((2, smax, tcfg.qk_rope_dim))
    cc[:, :s - 1], rc[:, :s - 1] = c, r
    out, _ = TL.mla_apply(params, tx[:, s - 1:], tp[:, s - 1:], tcfg,
                          cache=(cc, rc, torch.tensor([s - 1],
                                                      dtype=torch.int32)))
    _close(out[:, 0], full[:, -1].numpy())
