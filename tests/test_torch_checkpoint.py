"""Checkpoints, the supervised loop and the data pipeline of the port
(``repro_torch.train``), mirroring ``tests/test_fault_tolerance.py`` and
held against the JAX package's (``repro.train``): the data bytes, the
on-disk format both ways, and the loop's control flow.  Every check is
bitwise: a checkpoint stores each leaf's bits, the data is integer
hashing, and a recovered run repeats the same computation on the same
CPU."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import transformer as JT
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import elastic as jelastic
from repro.train import optimizer as JO
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.models import transformer as T
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import SyntheticLM, make_batch
from repro_torch.train.elastic import (FailureInjector, StragglerWatchdog,
                                       run_loop)
from repro_torch.train.optimizer import OptConfig, make_optimizer
from repro_torch.train.train_step import make_train_step

from torch_threads import one_thread  # noqa: F401

SMALL = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128, num_heads=2,
             num_kv_heads=1, head_dim=32)


def _setup(dtype="float32"):
    cfg = reduced_config(get_config("qwen2_1_5b"), dtype=dtype, **SMALL)
    params = T.model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = make_optimizer(OptConfig(lr=1e-3))
    step = make_train_step(cfg, opt)
    mb = lambda s: {k: torch.from_numpy(v) for k, v in make_batch(
        s, global_batch=4, seq_len=8, vocab=cfg.vocab_size).items()}
    return cfg, params, opt, step, mb


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_roundtrip(tmp_path, dtype):
    cfg, params, opt, _, _ = _setup(dtype)
    state = {"params": params, "opt": opt.init(params)}
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, 7, state)
    assert ckpt.latest_step(d) == 7
    _equal(ckpt.restore_checkpoint(d, 7, state), state)
    # onto meta targets, placed by device=
    meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), state)
    _equal(ckpt.restore_checkpoint(d, 7, meta, device="cpu"), state)
    with open(os.path.join(d, "step_7", "manifest.json")) as f:
        dtypes = {e["dtype"] for e in json.load(f)["leaves"]}
    assert dtypes == {dtype, "float32", "int32"}


def test_checkpoint_rotation(tmp_path):
    _, params, opt, _, _ = _setup()
    d = str(tmp_path / "ckpt")
    for s in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(d, s, {"params": params}, keep_last=2)
    assert sorted(ckpt.all_steps(d)) == [4, 5]
    assert not [n for n in os.listdir(d) if n.startswith(".tmp")]


def test_restore_checks_keys_and_shapes(tmp_path):
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, 1, {"a": torch.zeros(2, 3)})
    with pytest.raises(KeyError, match="'b'"):
        ckpt.restore_checkpoint(d, 1, {"b": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(d, 1, {"a": torch.zeros(3, 2)})


def _run(params, opt_state, step, mb, ckdir, fail_at=()):
    return run_loop(
        train_step=step, make_batch=mb,
        params=tree_map(torch.clone, params),
        opt_state=tree_map(torch.clone, opt_state), n_steps=6,
        ckpt_dir=ckdir, ckpt_every=2,
        failure_injector=FailureInjector(fail_at=fail_at))


@pytest.mark.parametrize("fail_at", [3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recovery_bit_exact(tmp_path, dtype, fail_at):
    """Train 6 steps straight vs. with a failure injected and recovery
    from the last checkpoint: identical final params and optimizer state
    (deterministic data => bit-reproducible recovery)."""
    _, params, opt, step, mb = _setup(dtype)
    opt_state = opt.init(params)
    plain = _run(params, opt_state, step, mb, str(tmp_path / "plain"))
    failed = _run(params, opt_state, step, mb, str(tmp_path / "fail"),
                  fail_at=[fail_at])
    assert plain["restarts"] == 0 and failed["restarts"] == 1
    last_ckpt = 2 * (fail_at // 2)
    assert [h["step"] for h in failed["history"]] == \
        list(range(fail_at)) + list(range(last_ckpt, 6))
    _equal(failed["final_state"], plain["final_state"])
    loss_at = {h["step"]: h["loss"] for h in plain["history"]}
    assert all(h["loss"] == loss_at[h["step"]] for h in failed["history"])
    assert tree_leaves(plain["final_state"]["params"])[0].dtype == \
        getattr(torch, dtype)


def test_straggler_watchdog():
    w = StragglerWatchdog(threshold=3.0)
    for _ in range(10):
        w.observe(0.1)
    assert w.flagged == 0
    assert w.observe(1.0) is True
    assert w.flagged == 1


@pytest.mark.parametrize("fail_at", [(), (1,), (3,), (1, 5)])
def test_run_loop_control_flow_is_the_reference_s(tmp_path, fail_at):
    """Both packages' loops over a toy step (a counter) with the same
    failures: the same history of steps, restarts and checkpoints.  A
    failure before the first checkpoint restarts at step 0 keeping the
    state it has (the reference's behaviour, ROADMAP Queue C), so the
    counter runs on past the step count."""
    def step_t(p, o, b):
        p["n"].add_(1)
        return p, o, {"loss": p["n"].float()}

    def step_j(p, o, b):
        return {"n": p["n"] + 1}, o, {"loss": (p["n"] + 1).astype(jnp.float32)}

    out = {}
    for name, loop, step, zeros, inj in (
            ("port", run_loop, step_t, lambda: torch.zeros((), dtype=torch.int32),
             FailureInjector),
            ("ref", jelastic.run_loop, step_j, lambda: jnp.zeros((), jnp.int32),
             jelastic.FailureInjector)):
        d = str(tmp_path / name)
        res = loop(train_step=step, make_batch=lambda s: None,
                   params={"n": zeros()}, opt_state={"o": zeros()},
                   n_steps=6, ckpt_dir=d, ckpt_every=2,
                   failure_injector=inj(fail_at=fail_at))
        out[name] = ([(h["step"], h["loss"]) for h in res["history"]],
                     res["restarts"], int(res["final_state"]["params"]["n"]),
                     sorted(ckpt.all_steps(d)))
    assert out["port"] == out["ref"]
    if fail_at and fail_at[0] == 1:
        assert out["port"][2] == 7      # one step more than 6


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------


def test_data_determinism():
    b1 = make_batch(11, global_batch=4, seq_len=16, vocab=100)
    b2 = make_batch(11, global_batch=4, seq_len=16, vocab=100)
    np.testing.assert_array_equal(b1["inputs"], b2["inputs"])
    b3 = make_batch(12, global_batch=4, seq_len=16, vocab=100)
    assert not np.array_equal(b1["inputs"], b3["inputs"])
    # labels are next-token shifted inputs
    it = iter(SyntheticLM(vocab=100, seq_len=16, global_batch=4))
    first = next(it)
    np.testing.assert_array_equal(first["inputs"][:, 1:],
                                  first["labels"][:, :-1])


@pytest.mark.parametrize("step", [0, 5, 1000])
@pytest.mark.parametrize("mode", ["tokens", "embeddings"])
def test_make_batch_equals_the_reference_byte_for_byte(step, mode):
    kw = dict(global_batch=3, seq_len=17, vocab=151936, input_mode=mode,
              d_model=24)
    ours, ref = make_batch(step, **kw), jdata.make_batch(step, **kw)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape
        assert ours[k].tobytes() == ref[k].tobytes()
    stream = iter(SyntheticLM(vocab=50, seq_len=9, global_batch=2,
                              input_mode=mode, d_model=4, start_step=step))
    jstream = iter(jdata.SyntheticLM(vocab=50, seq_len=9, global_batch=2,
                                     input_mode=mode, d_model=4,
                                     start_step=step))
    for _ in range(2):
        a, b = next(stream), next(jstream)
        assert all(a[k].tobytes() == b[k].tobytes() for k in b)


# ---------------------------------------------------------------------------
# the two packages' checkpoints
# ---------------------------------------------------------------------------


def _jax_state(dtype):
    jcfg = jbase.reduced_config(jbase.get_config("qwen2_1_5b"), dtype=dtype,
                                **SMALL)
    params = JT.model_init(jcfg, jax.random.PRNGKey(0))
    return {"params": params, "opt": JO.make_optimizer().init(params)}


def _port_target(dtype):
    cfg = reduced_config(get_config("qwen2_1_5b"), dtype=dtype, **SMALL)
    params = T.model_init(cfg, torch.Generator().manual_seed(1), device="cpu")
    return cfg, {"params": params,
                 "opt": make_optimizer(OptConfig()).init(params)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_jax_checkpoint_restores_bitwise_in_the_port(tmp_path, dtype):
    """The reference writes an f32 or bf16 checkpoint (a bf16 leaf as raw
    ``<V2`` bits); the port restores every leaf bitwise."""
    jstate = _jax_state(dtype)
    d = str(tmp_path / "jax")
    jckpt.save_checkpoint(d, 4, jstate)
    _, target = _port_target(dtype)
    restored = ckpt.restore_checkpoint(d, 4, target)
    jleaves = jax.tree_util.tree_leaves(jstate)
    for t, j in zip(tree_leaves(restored), jleaves):
        j = np.asarray(j)
        if j.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            assert t.view(torch.int16).numpy().tobytes() == \
                j.view(np.int16).tobytes()
        else:
            assert t.numpy().dtype == j.dtype and np.array_equal(t.numpy(), j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_port_writes_the_reference_s_files(tmp_path, dtype):
    """The same state written by both packages gives the same files,
    manifest and ``.npy`` bytes, in f32 and in bf16."""
    jstate = _jax_state(dtype)
    cfg, _ = _port_target(dtype)
    np_state = jax.tree_util.tree_map(np.asarray, jstate)
    state = {"params": params_from_numpy(np_state["params"], cfg,
                                         device="cpu"),
             "opt": tree_map(torch.from_numpy, np_state["opt"])}
    jckpt.save_checkpoint(str(tmp_path / "jax"), 2, jstate)
    ckpt.save_checkpoint(str(tmp_path / "port"), 2, state)
    jd, pd = tmp_path / "jax" / "step_2", tmp_path / "port" / "step_2"
    assert sorted(os.listdir(jd)) == sorted(os.listdir(pd))
    for name in os.listdir(jd):
        assert (jd / name).read_bytes() == (pd / name).read_bytes(), name


def test_a_port_checkpoint_restores_bitwise_in_the_reference(tmp_path):
    """f32: the port writes, the JAX package restores every leaf bitwise
    (it cannot restore bf16 leaves, its own included: ROADMAP Queue C)."""
    cfg, state = _port_target("float32")
    d = str(tmp_path / "port")
    ckpt.save_checkpoint(d, 6, state)
    jstate = _jax_state("float32")
    restored = jckpt.restore_checkpoint(d, 6, jstate)
    for t, j in zip(tree_leaves(state), jax.tree_util.tree_leaves(restored)):
        assert np.array_equal(t.numpy(), np.asarray(j))
        assert t.numpy().dtype == np.asarray(j).dtype


# ---------------------------------------------------------------------------
# asynchronous saves
# ---------------------------------------------------------------------------


def test_manager_snapshots_on_the_caller_s_thread(tmp_path):
    """The state may change in place as soon as ``maybe_save`` returns:
    the checkpoint holds the values it had at the call."""
    d = str(tmp_path / "mgr")
    mgr = ckpt.CheckpointManager(d, every=2, async_save=True)
    state = {"w": torch.arange(6.0).reshape(2, 3).to(torch.bfloat16),
             "n": torch.zeros((), dtype=torch.int32)}
    before = tree_map(torch.clone, state)
    assert not mgr.maybe_save(1, state)
    assert mgr.maybe_save(2, state)
    state["w"].add_(100)
    state["n"].add_(1)
    mgr.wait()
    _equal(ckpt.restore_checkpoint(d, 2, state), before)
    assert ckpt.all_steps(d) == [2]


def test_manager_raises_a_failed_background_save(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = ckpt.CheckpointManager(str(blocker / "ckpt"), every=1)
    mgr.maybe_save(1, {"w": torch.zeros(2)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()              # reported once
