"""The port's host-side planning is a copy of the JAX package's: its
outputs must be byte-equal (same dtype, shape and bytes), so both
packages dispatch exactly the same block products."""
import numpy as np
import pytest

from repro.core import blocking as jblocking
from repro.core import cannon as jcannon
from repro.core import engine as jengine
from repro.core import stacks as jstacks
from repro.sparsity import filter as jfilter

from repro_torch.core import blocking, cannon, engine, stacks
from repro_torch.sparsity import filter as tfilter
from repro_torch.sparsity import norms as tnorms

from torch_threads import one_thread  # noqa: F401


def _same(x, y):
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype and x.shape == y.shape
    assert x.tobytes() == y.tobytes()


def _same_plans(p, q):
    assert len(p) == len(q)
    for a, b in zip(p, q):
        _same(a.triples, b.triples)
        assert (a.n_c_blocks, a.block_m, a.block_k, a.block_n) == \
            (b.n_c_blocks, b.block_m, b.block_k, b.block_n)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (8, 8), (7, 2), (12, 9)])
def test_morton_order_byte_equal(shape):
    _same(blocking.morton_order(*shape), jblocking.morton_order(*shape))


# (nbr, nbk, nbc, block, stack_size): blocks 4/22/64, stack sizes that
# leave a ragged final stack
GEOMS = [(6, 5, 4, 4, 7), (5, 3, 4, 22, 10), (3, 4, 2, 64, 5),
         (8, 8, 8, 4, 30000)]


def _masks(rng, nbr, nbk, nbc, fill):
    return rng.rand(nbr, nbk) < fill, rng.rand(nbk, nbc) < fill


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("fill", [1.0, 0.5, 0.2])
def test_build_stacks_byte_equal(geom, fill):
    nbr, nbk, nbc, bs, stack = geom
    rng = np.random.RandomState(nbr * 100 + int(fill * 10))
    la = jblocking.BlockLayout(nbr * bs, nbk * bs, bs, bs)
    lb = jblocking.BlockLayout(nbk * bs, nbc * bs, bs, bs)
    ta = blocking.BlockLayout(nbr * bs, nbk * bs, bs, bs)
    tb = blocking.BlockLayout(nbk * bs, nbc * bs, bs, bs)
    am, bm = _masks(rng, nbr, nbk, nbc, fill) if fill < 1 else (None, None)
    _same_plans(stacks.build_stacks(ta, tb, stack, a_mask=am, b_mask=bm),
                jstacks.build_stacks(la, lb, stack, a_mask=am, b_mask=bm))


@pytest.mark.parametrize("eps", [0.0, 0.5, 2.0])
def test_build_stacks_norms_and_pair_mask_byte_equal(eps):
    rng = np.random.RandomState(7)
    nbr, nbk, nbc, bs = 5, 6, 4, 22
    la = jblocking.BlockLayout(nbr * bs, nbk * bs, bs, bs)
    lb = jblocking.BlockLayout(nbk * bs, nbc * bs, bs, bs)
    ta = blocking.BlockLayout(nbr * bs, nbk * bs, bs, bs)
    tb = blocking.BlockLayout(nbk * bs, nbc * bs, bs, bs)
    am, bm = _masks(rng, nbr, nbk, nbc, 0.6)
    an = rng.rand(nbr, nbk).astype(np.float32) * 2
    bn = rng.rand(nbk, nbc).astype(np.float32) * 2
    kw = dict(a_mask=am, b_mask=bm, a_norms=an, b_norms=bn, filter_eps=eps)
    _same_plans(stacks.build_stacks(ta, tb, 9, **kw),
                jstacks.build_stacks(la, lb, 9, **kw))
    pair = am[:, :, None] & bm[None]
    pn = (an[:, :, None] * bn[None]).astype(np.float32)
    kw = dict(pair_mask=pair, pair_norms=pn, filter_eps=eps)
    _same_plans(stacks.build_stacks(ta, tb, 9, **kw),
                jstacks.build_stacks(la, lb, 9, **kw))


@pytest.mark.parametrize("geom", GEOMS)
def test_pad_plans_and_size_binned_byte_equal(geom):
    nbr, nbk, nbc, bs, stack = geom
    rng = np.random.RandomState(3)
    am, bm = _masks(rng, nbr, nbk, nbc, 0.3)
    ta = blocking.BlockLayout(nbr * bs, nbk * bs, bs, bs)
    tb = blocking.BlockLayout(nbk * bs, nbc * bs, bs, bs)
    for kw in ({}, {"a_mask": am, "b_mask": bm}):
        plans = stacks.build_stacks(ta, tb, stack, **kw)
        if not plans:
            continue
        _same(stacks.pad_plans(plans), jstacks.pad_plans(plans))
        _same(stacks.pad_plans(plans, stack_tile=stack + 3, sentinel_c=1),
              jstacks.pad_plans(plans, stack_tile=stack + 3, sentinel_c=1))
        for cap in (1, 2, 4):
            tb_, jb_ = engine._size_binned(plans, cap), \
                jengine._size_binned(plans, cap)
            assert len(tb_) == len(jb_)
            for x, y in zip(tb_, jb_):
                _same(x, y)
        assert stacks.stack_statistics(plans) == \
            jstacks.stack_statistics(plans)


def test_size_binned_engages_on_ragged_stacks():
    """A plan whose stacks differ a lot in length is binned (several
    tensors), identically in both packages."""
    rng = np.random.RandomState(0)
    nb = 40
    am = rng.rand(nb, nb) < 0.2
    t = engine.build_executor_plan(nb * 4, nb * 4, nb * 4, 4, 4, 4, 8,
                                   a_mask=am)
    j = jengine.build_executor_plan(nb * 4, nb * 4, nb * 4, 4, 4, 4, 8,
                                    a_mask=am)
    assert t.n_bins == j.n_bins >= 2
    for x, y in zip(t.bin_triples, j.bin_triples):
        _same(x, y)


@pytest.mark.parametrize("eps", [None, 0.0, 0.3, 1.5])
@pytest.mark.parametrize("fill", [1.0, 0.5, 0.1])
def test_filter_predicates_byte_equal(eps, fill):
    rng = np.random.RandomState(int(fill * 100))
    am, bm = _masks(rng, 7, 9, 5, fill)
    an = rng.rand(7, 9).astype(np.float32) * 2
    bn = rng.rand(9, 5).astype(np.float32) * 2
    for fn in ("product_mask", "retained_pair_presence"):
        _same(getattr(tfilter, fn)(am, bm, an, bn, eps),
              getattr(jfilter, fn)(am, bm, an, bn, eps))
    assert tfilter.count_retained_triples(am, bm, an, bn, eps) == \
        jfilter.count_retained_triples(am, bm, an, bn, eps)
    assert tfilter.norm_filter_stats(am, bm, an, bn, eps, 10) == \
        jfilter.norm_filter_stats(am, bm, an, bn, eps, 10)


def test_normalize_masks_and_norms_equal():
    from repro.sparsity.norms import normalize_block_norms

    rng = np.random.RandomState(1)
    am, bm = _masks(rng, 3, 4, 5, 0.5)
    for x, y in zip(stacks.normalize_block_masks(3, 4, 5, am, None),
                    jstacks.normalize_block_masks(3, 4, 5, am, None)):
        _same(x, y)
    an = rng.rand(3, 4)
    for x, y in zip(tnorms.normalize_block_norms(3, 4, 5, an, None),
                    normalize_block_norms(3, 4, 5, an, None)):
        _same(x, y)
    with pytest.raises(ValueError):
        stacks.normalize_block_masks(3, 4, 5, np.ones((2, 2), bool), None)
    with pytest.raises(ValueError):
        tnorms.normalize_block_norms(3, 4, 5, None, np.ones((2, 2)))


@pytest.mark.parametrize("pg", [1, 2])
def test_cannon_step_masks_and_norms_byte_equal(pg):
    rng = np.random.RandomState(pg)
    am, bm = _masks(rng, 4, 6, 8, 0.4)
    an = rng.rand(4, 6).astype(np.float32)
    bn = rng.rand(6, 8).astype(np.float32)
    for x, y in zip(cannon.cannon_step_masks(am, bm, pg),
                    jcannon.cannon_step_masks(am, bm, pg)):
        _same(x, y)
    for x, y in zip(cannon.cannon_step_norms(an, bn, pg),
                    jcannon.cannon_step_norms(an, bn, pg)):
        _same(x, y)
