"""The port's AdamW and Adafactor (``repro_torch.train.optimizer``)
against the JAX package's (``repro.train.optimizer``): three updates
from the same parameters, gradients and state, made with numpy from a
seed, compared after every update.

The tree has Adafactor-factored leaves (both trailing dims >= 128, one a
layer stack), unfactored matrices, vectors (no weight decay) and a bf16
leaf, under a list, as a model's tree has.  Tolerances: f32 elementwise
arithmetic in another order (``pow``, ``sqrt``, the factored means), so
parameters within 1e-6 (relative and absolute), a bf16 parameter
within one bf16 step, the moments within 1e-5 of their largest
magnitude, and the global gradient norm within 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import transformer as JT
from repro.train import optimizer as JO
from repro_torch.configs import base as tbase
from repro_torch.models import common as TC
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.train import optimizer as TO

from torch_threads import one_thread  # noqa: F401

SHAPES = {
    "stack": (3, 130, 140),    # factored, a layer stack
    "wide": (128, 200),        # factored
    "small": (64, 32),         # unfactored matrix
    "bias": (32,),             # a vector: no weight decay
    "layers": [{"w": (2, 16, 130), "scale": (130,)}],
}
N_UPDATES = 3


def _tree(rng, scale=1.0, dtype=np.float32):
    return jax.tree_util.tree_map(
        lambda s: (rng.randn(*s) * scale).astype(dtype), SHAPES,
        is_leaf=lambda x: isinstance(x, tuple))


def _torch(tree, dtype=None):
    return TC.tree_map(lambda a: torch.from_numpy(np.array(a)).to(
        dtype or torch.float32), tree)


def _close(t, ref, rel):
    ref = np.asarray(ref, np.float64)
    got = t.double().numpy()
    scale = float(np.abs(ref).max()) or 1.0
    assert float(np.abs(got - ref).max()) / scale <= rel


@pytest.mark.parametrize("grad_scale", [0.01, 1.0], ids=["unclipped",
                                                         "clipped"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_updates_match_the_jax_package(name, grad_scale):
    cfg = dict(name=name, lr=1e-2, weight_decay=0.1)
    jopt = JO.make_optimizer(JO.OptConfig(**cfg))
    topt = TO.make_optimizer(TO.OptConfig(**cfg))
    rng = np.random.RandomState(0)
    params = _tree(rng)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = _torch(params)
    tstate = topt.init(tp)
    ids = [id(t) for t in TC.tree_leaves((tp, tstate))]
    jupdate = jax.jit(jopt.update)
    for _ in range(N_UPDATES):
        grads = _tree(rng, grad_scale * 0.05)
        jp, jstate, jm = jupdate(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
        tp, tstate, tm = topt.update(_torch(grads), tstate, tp)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        for t, j in zip(TC.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-6)
        jleaves = jax.tree_util.tree_leaves(jstate)
        tleaves = TC.tree_leaves(tstate)
        assert [tuple(t.shape) for t in tleaves] == [j.shape for j in jleaves]
        for t, j in zip(tleaves, jleaves):
            _close(t, j, 1e-5)
    # in place: the same tensors, updated
    assert [id(t) for t in TC.tree_leaves((tp, tstate))] == ids
    assert int(tstate["step"]) == N_UPDATES
    clipped = float(tm["grad_norm"]) > 1.0
    assert clipped == (grad_scale == 1.0)


def test_adafactor_factors_exactly_the_large_trailing_dims():
    state = TO.make_optimizer(TO.OptConfig(name="adafactor")).init(
        _torch(_tree(np.random.RandomState(1))))
    v = state["v"]
    assert set(v["stack"]) == {"vr", "vc"}
    assert tuple(v["stack"]["vr"].shape) == (3, 130)
    assert tuple(v["stack"]["vc"].shape) == (3, 140)
    assert set(v["wide"]) == {"vr", "vc"}
    assert set(v["small"]) == set(v["bias"]) == {"v"}
    assert set(v["layers"][0]["w"]) == {"v"}          # 16 < 128


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_weight_decay_only_on_matrices(name):
    """With zero gradients a step is the decay alone: matrices shrink by
    lr * weight_decay, vectors stay bitwise."""
    opt = TO.make_optimizer(TO.OptConfig(name=name, lr=0.1,
                                         weight_decay=0.5))
    params = _torch(_tree(np.random.RandomState(2)))
    before = TC.tree_map(torch.clone, params)
    zeros = TC.tree_map(torch.zeros_like, params)
    params, _, m = opt.update(zeros, opt.init(params), params)
    assert float(m["grad_norm"]) == 0.0
    for p, b in zip(TC.tree_leaves(params), TC.tree_leaves(before)):
        if p.ndim >= 2:
            torch.testing.assert_close(p, b - 0.1 * (0.5 * b), rtol=0,
                                       atol=1e-7)
        else:
            assert torch.equal(p, b)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_bf16_parameters_update_in_f32_and_round_back(name):
    """A bf16 leaf is updated in f32 and cast back, as the reference does:
    within one bf16 step of the reference's bf16 result; its moments
    stay f32."""
    cfg = dict(name=name, lr=1e-2)
    jopt = JO.make_optimizer(JO.OptConfig(**cfg))
    topt = TO.make_optimizer(TO.OptConfig(**cfg))
    rng = np.random.RandomState(3)
    params = _tree(rng)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    tp = _torch(params, torch.bfloat16)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    jupdate = jax.jit(jopt.update)
    for _ in range(N_UPDATES):
        grads = _tree(rng, 0.05)
        jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                    grads)
        jp, jstate, _ = jupdate(jg, jstate, jp)
        tp, tstate, _ = topt.update(_torch(grads, torch.bfloat16), tstate, tp)
    for t, j in zip(TC.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert t.dtype == torch.bfloat16
        ref = np.asarray(j, np.float32)
        step = np.ldexp(1.0, np.frexp(np.abs(ref))[1] - 8)
        assert np.all(np.abs(t.float().numpy() - ref) <= step)
    for t in TC.tree_leaves(tstate):
        assert t.dtype in (torch.float32, torch.int32)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_state_carried_from_the_jax_package_continues_its_run(name):
    """``opt_state_from_numpy`` starts the port from the reference's m, v
    and step after two updates of a reduced model; the third update
    matches the reference's."""
    cfg = tbase.reduced_config(tbase.get_config("qwen2_1_5b"), num_layers=2)
    jcfg = jbase.reduced_config(jbase.get_config("qwen2_1_5b"), num_layers=2)
    jopt = JO.make_optimizer(JO.OptConfig(name=name, lr=1e-2))
    topt = TO.make_optimizer(TO.OptConfig(name=name, lr=1e-2))
    rng = np.random.RandomState(4)
    jp = JT.model_init(jcfg, jax.random.PRNGKey(0))
    state = jopt.init(jp)
    grads = [jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32) * 0.01),
        jp) for _ in range(3)]
    jupdate = jax.jit(jopt.update)
    for g in grads[:2]:
        jp, state, _ = jupdate(g, state, jp)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                           device="cpu")
    tstate = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, state),
                                  cfg, topt, device="cpu")
    assert int(tstate["step"]) == 2 and tstate["step"].dtype == torch.int32
    jp, state, _ = jupdate(grads[2], state, jp)
    tg = params_from_numpy(jax.tree_util.tree_map(np.asarray, grads[2]), cfg,
                           device="cpu")
    tp, tstate, _ = topt.update(tg, tstate, tp)
    for t, j in zip(TC.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)
    for t, j in zip(TC.tree_leaves(tstate), jax.tree_util.tree_leaves(state)):
        _close(t, j, 1e-5)


def test_zero_and_unknown_optimizers_raise():
    """An unknown optimizer raises.  ``zero=True`` raised until ZeRO's
    state specs were ported; it now builds an optimizer whose state
    specs shard over the data axes (tests/test_torch_launch.py)."""
    opt = TO.make_optimizer(TO.OptConfig(zero=True))
    assert opt.cfg.zero and callable(opt.state_specs)
    with pytest.raises(ValueError):
        TO.make_optimizer(TO.OptConfig(name="sgd"))
