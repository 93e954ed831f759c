"""The port's RWKV-6 mixers (``repro_torch.models.rwkv6``) against the
JAX package's (``repro.models.rwkv6``), on the reduced RWKV-6 config in
f32 on the CPU, with the same numpy parameters and inputs.

Every parameter is drawn random, the zero-initialised lerp, decay and
bonus terms included, so every term of the recurrence is exercised.
Outputs and states are held at 2e-5 of their largest magnitude (f32 sums
of the same products in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import common as JC
from repro.models import rwkv6 as JR
from repro_torch.configs import base as tbase
from repro_torch.models import common as TC
from repro_torch.models import rwkv6 as TR

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
    jcfg = jbase.reduced_config(jbase.get_config("rwkv6_1_6b"))
    tcfg = tbase.reduced_config(tbase.get_config("rwkv6_1_6b"))
    rng = np.random.RandomState(13)
    tree = jax.tree_util.tree_map(
        lambda d: (rng.randn(*d.shape) * 0.5 / np.sqrt(d.shape[0])
                   ).astype(np.float32),
        JR.rwkv6_defs(jcfg), is_leaf=lambda x: isinstance(x, JC.ParamDef))
    return jcfg, tcfg, tree, rng


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return TC.tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def _state(rng, cfg, b):
    h = cfg.d_model // cfg.rwkv_head_size
    return (rng.randn(b, cfg.d_model).astype(np.float32),
            rng.randn(b, h, cfg.rwkv_head_size,
                      cfg.rwkv_head_size).astype(np.float32))


@pytest.mark.parametrize("s", [1, 37])
@pytest.mark.parametrize("carried", [False, True])
def test_time_mix(setup, s, carried):
    """Prefill (no cache: a zero shift and state) and decode from a
    carried state, over one token and over several."""
    jcfg, tcfg, tree, rng = setup
    x = rng.randn(2, s, jcfg.d_model).astype(np.float32)
    shift, wkv = _state(rng, jcfg, 2)
    jc = (jnp.asarray(shift), jnp.asarray(wkv)) if carried else None
    ref, (rs, rw) = JR.rwkv6_time_mix(_jax(tree), jnp.asarray(x), jcfg,
                                      cache=jc)
    tc = ((torch.from_numpy(shift.copy()), torch.from_numpy(wkv.copy()))
          if carried else None)
    out, (ts, tw) = TR.rwkv6_time_mix(_torch(tree), torch.from_numpy(x), tcfg,
                                      cache=tc)
    if carried:                                # written in place
        assert ts is tc[0] and tw is tc[1]
    _close(out, ref)
    _close(ts, rs)
    _close(tw, rw)
    assert tw.dtype == torch.float32


@pytest.mark.parametrize("s", [1, 37])
@pytest.mark.parametrize("carried", [False, True])
def test_channel_mix(setup, s, carried):
    jcfg, tcfg, tree, rng = setup
    x = rng.randn(2, s, jcfg.d_model).astype(np.float32)
    shift = rng.randn(2, jcfg.d_model).astype(np.float32)
    ref, rs = JR.rwkv6_channel_mix(_jax(tree), jnp.asarray(x), jcfg,
                                   cache=jnp.asarray(shift) if carried
                                   else None)
    tc = torch.from_numpy(shift.copy()) if carried else None
    out, ts = TR.rwkv6_channel_mix(_torch(tree), torch.from_numpy(x), tcfg,
                                   cache=tc)
    if carried:
        assert ts is tc
    _close(out, ref)
    _close(ts, rs)


def test_decode_continues_the_prefill_within_the_port(setup):
    _, tcfg, tree, rng = setup
    params = _torch(tree)
    x = torch.from_numpy(rng.randn(2, 12, tcfg.d_model).astype(np.float32))
    full, (fs, fw) = TR.rwkv6_time_mix(params, x, tcfg)
    _, (s, w) = TR.rwkv6_time_mix(params, x[:, :9], tcfg)
    s, w = s.clone(), w.clone()
    outs = [TR.rwkv6_time_mix(params, x[:, i:i + 1], tcfg, cache=(s, w))[0]
            for i in range(9, 12)]
    _close(torch.cat(outs, 1), full[:, 9:].numpy(), rel=1e-5)
    _close(s, fs.numpy())
    _close(w, fw.numpy(), rel=1e-5)
