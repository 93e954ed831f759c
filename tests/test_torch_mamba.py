"""The port's Mamba mixer (``repro_torch.models.mamba``) against the JAX
package's (``repro.models.mamba``), on the reduced Jamba config in f32 on
the CPU, with the same numpy parameters and inputs.

The chunked scan is held at 1e-5 of its largest magnitude: the port's
Hillis-Steele scan and ``jax.lax.associative_scan`` multiply the same
decays in another association order.  Within the port the chunked scan
equals a step-by-step recurrence to 1e-5 for the same reason.  The layer
(projections, convolution, scan, gate) is held at 2e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import common as JC
from repro.models import mamba as JM
from repro_torch.configs import base as tbase
from repro_torch.models import common as TC
from repro_torch.models import mamba as TM

from torch_threads import one_thread  # noqa: F401

SCAN_REL = 1e-5
REL = 2e-5


def _close(out, ref, rel=REL):
    out = out.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max()) or 1.0
    err = float(np.abs(out - ref).max()) / scale
    assert err <= rel, f"max error / max|ref| = {err:.3e} > {rel:g}"


def _ssm_inputs(rng, b=2, t=300, d=24, n=16):
    u = rng.randn(b, t, d).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, t, d))).astype(np.float32)  # softplus
    a = -np.exp(rng.randn(d, n) * 0.5).astype(np.float32)
    bb = rng.randn(b, t, n).astype(np.float32)
    c = rng.randn(b, t, n).astype(np.float32)
    return u, dt, a, bb, c


@pytest.mark.parametrize("t,chunk", [(256, 64), (300, 64), (5, 128),
                                     (130, 128)])
def test_ssm_chunked_matches_the_jax_package(t, chunk):
    args = _ssm_inputs(np.random.RandomState(t), t=t)
    ry, rh = JM._ssm_chunked(*map(jnp.asarray, args), chunk=chunk)
    y, h = TM._ssm_chunked(*map(torch.from_numpy, args), chunk=chunk)
    assert y.shape == (2, t, 24) and h.shape == (2, 24, 16)
    _close(y, ry, SCAN_REL)
    _close(h, rh, SCAN_REL)


@pytest.mark.parametrize("t,chunk", [(64, 16), (77, 16), (9, 128)])
def test_ssm_chunked_equals_the_recurrence(t, chunk):
    u, dt, a, b, c = map(torch.from_numpy,
                         _ssm_inputs(np.random.RandomState(100 + t), t=t))
    y, h_last = TM._ssm_chunked(u, dt, a, b, c, chunk=chunk)
    h = torch.zeros(2, 24, 16)
    ys = []
    for i in range(t):
        h = torch.exp(dt[:, i, :, None] * a) * h \
            + (dt[:, i] * u[:, i])[..., None] * b[:, i, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, i]))
    _close(y, torch.stack(ys, 1).numpy(), SCAN_REL)
    _close(h_last, h.numpy(), SCAN_REL)


@pytest.fixture(scope="module")
def setup():
    jcfg = jbase.reduced_config(jbase.get_config("jamba_v0_1_52b"))
    tcfg = tbase.reduced_config(tbase.get_config("jamba_v0_1_52b"))
    rng = np.random.RandomState(12)
    tree = jax.tree_util.tree_map(
        lambda d: (rng.randn(*d.shape) / np.sqrt(d.shape[0])).astype(np.float32),
        JM.mamba_defs(jcfg), is_leaf=lambda x: isinstance(x, JC.ParamDef))
    return jcfg, tcfg, tree, rng


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return TC.tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)


@pytest.mark.parametrize("s,chunk", [(300, 128), (256, 64), (2, 128)])
def test_mamba_prefill(setup, s, chunk):
    jcfg, tcfg, tree, rng = setup
    x = rng.randn(2, s, jcfg.d_model).astype(np.float32)
    ref, (rc, rh) = JM.mamba_apply(_jax(tree), jnp.asarray(x), jcfg,
                                   chunk=chunk)
    out, (c, h) = TM.mamba_apply(_torch(tree), torch.from_numpy(x), tcfg,
                                 chunk=chunk)
    _close(out, ref)
    _close(c, rc)
    _close(h, rh)
    assert h.dtype == torch.float32


def test_mamba_decode_from_a_carried_state(setup):
    jcfg, tcfg, tree, rng = setup
    d_in, _, n, k = TM._dims(tcfg)
    x = rng.randn(2, 1, jcfg.d_model).astype(np.float32)
    conv = rng.randn(2, k - 1, d_in).astype(np.float32)
    ssm = rng.randn(2, d_in, n).astype(np.float32)
    ref, (rc, rh) = JM.mamba_apply(_jax(tree), jnp.asarray(x), jcfg,
                                   cache=(jnp.asarray(conv), jnp.asarray(ssm)))
    tconv, tssm = torch.from_numpy(conv.copy()), torch.from_numpy(ssm.copy())
    out, (c, h) = TM.mamba_apply(_torch(tree), torch.from_numpy(x), tcfg,
                                 cache=(tconv, tssm))
    assert c is tconv and h is tssm            # written in place
    _close(out, ref)
    _close(c, rc)
    _close(h, rh)


def test_prefill_then_decode_equals_prefill_within_the_port(setup):
    _, tcfg, tree, rng = setup
    params = _torch(tree)
    x = torch.from_numpy(rng.randn(2, 20, tcfg.d_model).astype(np.float32))
    full, (fc, fh) = TM.mamba_apply(params, x, tcfg, chunk=8)
    _, (c, h) = TM.mamba_apply(params, x[:, :17], tcfg, chunk=8)
    outs = []
    for i in range(17, 20):
        o, (c, h) = TM.mamba_apply(params, x[:, i:i + 1], tcfg,
                                   cache=(c, h))
        outs.append(o)
    _close(torch.cat(outs, 1), full[:, 17:].numpy())
    _close(c, fc.numpy())
    _close(h, fh.numpy())
