"""The port's decode-attention wrapper against the JAX package's: the
Pallas kernel (interpret mode on the CPU, as its own tests run it) and
the model layer's jnp decode.  Inputs are made with numpy from a seed.

Tolerance 2e-4 (rtol and atol), the reference test's own: both sides
compute in f32, summing in different orders.  bf16 inputs: the f32
results are held at 2e-4, the bf16-rounded outputs at one bf16 step
(2**-8 relative), since two f32 values within 2e-4 may round apart.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.decode_attention.decode_attention import \
    decode_attention_pallas
from repro.kernels.decode_attention.ops import decode_attention as jax_ops
from repro.models.attention import decode_attention as jax_model_decode
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.models.attention import decode_attention as model_decode

TOL = dict(rtol=2e-4, atol=2e-4)

CASES = [
    # (B, Hkv, R, Dh, S, cur_len, block_k): the reference test's cases
    (2, 2, 4, 64, 256, 200, 128),
    (1, 1, 8, 128, 512, 512, 256),   # MQA, full cache
    (2, 4, 1, 64, 128, 7, 64),       # MHA (R=1), short valid prefix
    (1, 2, 6, 32, 384, 100, 128),    # GQA 6:1, unaligned cur_len
    # cur_len 0 (every score -1e30: the mean of V over all S) and 1
    (1, 2, 3, 32, 64, 0, 64),
    (2, 1, 2, 32, 64, 1, 32),
]


def _inputs(b, hkv, r, dh, s, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, 1, hkv * r, dh).astype(np.float32)
    k = rng.randn(b, s, hkv, dh).astype(np.float32)
    v = rng.randn(b, s, hkv, dh).astype(np.float32)
    return q, k, v


def _len(cur):
    return torch.tensor([cur], dtype=torch.int32)


@pytest.mark.parametrize("b,hkv,r,dh,s,cur,bk", CASES)
def test_wrapper_matches_the_pallas_kernel(b, hkv, r, dh, s, cur, bk):
    q, k, v = _inputs(b, hkv, r, dh, s, seed=cur + s)
    ref = jax_ops(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.asarray(cur), block_k=bk)
    out = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), _len(cur))
    assert out.shape == (b, 1, hkv * r, dh) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_cur_len_zero_is_the_mean_of_v():
    q, k, v = _inputs(1, 2, 3, 32, 64, seed=5)
    out = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), _len(0))
    mean = v.mean(axis=1)                                  # (B, Hkv, Dh)
    np.testing.assert_allclose(out.numpy().reshape(1, 2, 3, 32),
                               np.repeat(mean[:, :, None], 3, axis=2), **TOL)


def test_bf16_cache():
    b, hkv, r, dh, s, cur = 1, 2, 4, 64, 256, 250
    q, k, v = _inputs(b, hkv, r, dh, s, seed=11)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    # f32 results of the grouped kernel layout
    ref32 = decode_attention_pallas(qb.reshape(b, hkv, r, dh), kb, vb,
                                    jnp.asarray(cur, jnp.int32), block_k=128,
                                    interpret=True)
    out32 = decode_attention_ref(tq.reshape(b, hkv, r, dh), tk, tv, _len(cur))
    np.testing.assert_allclose(out32.numpy(), np.asarray(ref32), **TOL)
    # the wrappers return q's dtype
    ref = jax_ops(qb, kb, vb, jnp.asarray(cur))
    out = decode_attention(tq, tk, tv, _len(cur))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=2 ** -8, atol=2 ** -8)


def test_model_layer_decode_matches_the_jax_model_layer():
    b, hkv, r, dh, s, cur = 2, 2, 3, 64, 256, 123
    q, k, v = _inputs(b, hkv, r, dh, s, seed=3)
    ref = jax_model_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(cur), scale=dh ** -0.5)
    out = model_decode(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), _len(cur), scale=dh ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_wrapper_checks_its_operands():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 2, 32, 16, seed=0))
    with pytest.raises(TypeError, match="int32"):
        decode_attention(q, k, v, torch.tensor([3]))
    with pytest.raises(TypeError, match="bfloat16"):
        decode_attention(q.double(), k, v, _len(3))
    with pytest.raises(ValueError, match="grouped"):
        decode_attention(q[:, :, :3], k, v, _len(3))
    with pytest.raises(ValueError, match="devices"):
        decode_attention(q, k, v, _len(3).to("meta"))
    before = decode_attention.launches
    decode_attention(q, k, v, _len(3))
    assert decode_attention.launches == before  # the plain version ran
