"""The port's decode-attention wrapper against the JAX package's: the
Pallas kernel (interpret mode on the CPU, as its own tests run it) and
the model layer's jnp decode.  Inputs are made with numpy from a seed.

The CUDA kernel's row partition (``split_tiles``) and its split-and-
merge arithmetic are modelled here in plain torch and held against the
plain version, since the kernel itself runs only on the card.

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
from repro_torch.kernels.decode_attention.ops import (TILE_ROWS,
                                                     decode_attention, plan,
                                                     smem_layout,
                                                     split_tiles)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.models.attention import decode_attention as model_decode

from torch_threads import one_thread  # noqa: F401

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


@pytest.mark.parametrize("s", [1, 3, 16, 70, 130, 1000, 4100])
@pytest.mark.parametrize("cur", ["0", "1", "S", "S+5", "mid"])
@pytest.mark.parametrize("nsplit,warps", [(1, 1), (3, 4), (8, 4), (5, 2)])
def test_split_tiles_cover_the_valid_rows(s, cur, nsplit, warps):
    cur_len = {"0": 0, "1": 1, "S": s, "S+5": s + 5, "mid": s // 2 + 1}[cur]
    want = s if cur_len < 1 else min(cur_len, s)
    rows = []
    for per_split in split_tiles(cur_len, s, nsplit, warps):
        assert len(per_split) == warps
        for tiles in per_split:
            for j0, n in tiles:
                assert j0 % TILE_ROWS == 0 and 1 <= n <= TILE_ROWS
                rows.extend(range(j0, j0 + n))
    assert sorted(rows) == list(range(want))   # no gap, no overlap


def _split_merge_model(qg, k, v, cur_len, scale, nsplit, warps):
    """The kernel's arithmetic in plain torch: per warp an online softmax
    over its 16-row tiles (running max, rescaled sum and accumulator),
    then the nsplit x warps partials merged in CTA-major order with
    weights exp(m - max m), the denominator floored at 1e-30."""
    b, hkv, r, dh = qg.shape
    s = k.shape[1]
    cur = int(cur_len)
    parts = []
    for per_split in split_tiles(cur, s, nsplit, warps):
        for tiles in per_split:
            m = torch.full((b, hkv, r), -float("inf"))
            l = torch.zeros((b, hkv, r))
            acc = torch.zeros((b, hkv, r, dh))
            for j0, n in tiles:
                kt = k[:, j0:j0 + n].float()              # (b, n, hkv, dh)
                vt = v[:, j0:j0 + n].float()
                sc = torch.einsum("bhrd,bnhd->bhrn", qg.float(), kt) * scale
                if cur < 1:
                    sc = torch.full_like(sc, -1e30)
                m_new = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(sc - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bhrn,bnhd->bhrd", p, vt)
                m = m_new
            parts.append((m, l, acc))
    mm = torch.stack([m for m, _, _ in parts]).amax(0)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        w = torch.where(m == -float("inf"), torch.zeros_like(m),
                        torch.exp(m - mm))
        den = den + w * l
        num = num + w[..., None] * acc
    return num / den.clamp_min(1e-30)[..., None]


@pytest.mark.parametrize("s,cur,nsplit,warps", [
    (200, 200, 8, 4), (200, 0, 8, 4), (200, 1, 8, 4), (200, 17, 5, 4),
    (1000, 513, 8, 4), (3, 3, 8, 4), (1, 1, 1, 4), (70, 33, 3, 2),
    (130, 129, 1, 1)])
def test_split_merge_model_matches_plain(s, cur, nsplit, warps):
    q, k, v = _inputs(2, 2, 6, 64, s, seed=s + cur)
    qg = torch.from_numpy(q).reshape(2, 2, 6, 64)
    k, v = torch.from_numpy(k), torch.from_numpy(v)
    scale = 64 ** -0.5
    got = _split_merge_model(qg, k, v, _len(cur), scale, nsplit, warps)
    ref = decode_attention_ref(qg, k, v, _len(cur), scale)
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.parametrize("r,dh", [(1, 64), (4, 128), (6, 128), (8, 128),
                                  (12, 128), (48, 128), (3, 33), (2, 256)])
@pytest.mark.parametrize("elem", [2, 4])
def test_plan_fits_the_card(r, dh, elem):
    """Every query row in exactly one group, each group within the
    kernel's compile-time row bound, the rows of Dh within the lanes'
    columns, and the CTA's shared memory within the H100's 227 KB."""
    pl = plan(8, 8, r, dh, 4096, elem)
    assert pl.nrg * pl.rpg >= r > (pl.nrg - 1) * pl.rpg
    assert pl.rpg <= pl.kr <= 8 and 32 * pl.dpl >= dh
    assert 1 <= pl.nsplit <= 8 and 1 <= pl.warps <= 4
    assert pl.smem == smem_layout(elem, dh, pl.kr, pl.dpl, pl.warps)["total"]
    assert pl.smem <= 232448
    assert plan(1, 1, r, dh, 1, elem).nsplit == 1   # one tile, one CTA


# clusters of n CTAs an H100 holds at once for the bf16 R = 6, Dh = 128
# instantiation (cudaOccupancyMaxActiveClusters, NVIDIA H100 80GB HBM3):
# clusters must fit whole in a GPC, so 8-CTA clusters fit 45, not 396 / 8
H100_CLUSTERS = {1: 396, 2: 198, 3: 124, 4: 92, 5: 69, 6: 62, 7: 47, 8: 45}


@pytest.mark.parametrize("b,s,want", [
    (8, 4096, 5),      # 64 clusters: 5 is the most that fit in one wave
    (16, 32768, 8),    # 128 clusters: three waves of 8 beat two of 5
    (1, 20, 1),        # two tiles: one CTA
    (2, 4096, 8)])     # 16 clusters: all fit at once
def test_plan_sizes_splits_by_cluster_capacity(b, s, want):
    pl = plan(b, 8, 6, 128, s, 2, capacity=H100_CLUSTERS.__getitem__)
    assert pl.nsplit == want
    clusters = b * 8 * pl.nrg
    waves = -(-clusters // H100_CLUSTERS[pl.nsplit])
    for n in range(1, 9):   # no count takes fewer waves per unit of work
        if n <= -(-(-(-s // TILE_ROWS)) // pl.warps):
            assert waves / pl.nsplit <= -(-clusters // H100_CLUSTERS[n]) / n
