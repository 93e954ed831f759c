"""The port's train step (``repro_torch.train.train_step``) against the
JAX package's, the descent of every architecture, and the two training
entry points (``python -m repro_torch.launch.train``, ``python -m
repro_torch.examples.train_lm``).

Tolerances: one step of AdamW (lr 1e-2, eps 1; see OPT) from the same
parameters on the same batch, reduced configs in f32 on the CPU: the
loss, nll and aux within 1e-5 of the reference's (observed <= 1.5e-7),
the global gradient norm within 1e-4 (observed <= 3.5e-5, two
microbatches: the two packages accumulate in another order), the first
moment (0.1 x the clipped gradient) within 1e-3 of each leaf's largest
magnitude (observed <= 4.0e-4; gradients are held at 5e-4 in
``test_torch_train_loss.py``) and each parameter within 1e-6 absolute
(observed <= 3.1e-7).  Inside the port, two microbatches against one:
the loss and the gradient norm within 1e-6 relative, the first moments
within 1e-5.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.compat import set_mesh

from repro.configs import base as jbase
from repro.launch.mesh import make_mesh
from repro.models import transformer as JT
from repro.train import optimizer as JO
from repro.train import train_step as JS
from repro.train.data import make_batch
from repro_torch.configs import base as tbase
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as TT
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import optimizer as TO
from repro_torch.train.train_step import make_train_step

from torch_threads import one_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")


# eps 1: Adam's first step g / (|g| + eps) is then smooth in g, so the
# gradients' f32 rounding moves a parameter by lr x that rounding; at the
# default 1e-8 the first step is sign(g), which flips wherever an element
# of the gradient lies within rounding of zero
OPT = dict(lr=1e-2, eps=1.0)


def _batch(cfg, b=4, s=16):
    return make_batch(0, global_batch=b, seq_len=s, vocab=cfg.vocab_size,
                      input_mode=cfg.input_mode, d_model=cfg.d_model)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1, 1), ("pod", "data", "model"))


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ["qwen2_1_5b", "qwen3_moe_30b_a3b"])
def test_train_step_matches_the_jax_package(arch, n_micro, mesh):
    jcfg = jbase.reduced_config(jbase.get_config(arch))
    tcfg = tbase.reduced_config(tbase.get_config(arch))
    params = jax.tree_util.tree_map(
        np.asarray, JT.model_init(jcfg, jax.random.PRNGKey(0)))
    batch = _batch(jcfg)
    jopt = JO.make_optimizer(JO.OptConfig(**OPT))
    jstep = jax.jit(JS.make_train_step(jcfg, mesh, jopt,
                                       n_microbatches=n_micro))
    with set_mesh(mesh):
        jp, js, jm = jstep(params, jopt.init(params),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    topt = TO.make_optimizer(TO.OptConfig(**OPT))
    tp = params_from_numpy(params, tcfg, device="cpu")
    tp, state, tm = make_train_step(tcfg, topt, n_microbatches=n_micro)(
        tp, topt.init(tp), {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tm) == set(jm)
    assert set(tm) == ({"nll", "grad_norm", "loss"} if n_micro > 1 else
                       {"nll", "aux", "grad_norm", "loss"})
    for k in tm:
        rel = 1e-4 if k == "grad_norm" else 1e-5
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=rel,
                                             abs=1e-7), k
    assert int(state["step"]) == 1
    # AdamW's first moment after one step: 0.1 x the clipped gradient
    for t, j in zip(tree_leaves(state["m"]), jax.tree_util.tree_leaves(js["m"])):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 1e-3 * (np.abs(j).max() or 1)
    for t, j in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-6)


def test_two_microbatches_accumulate_the_whole_batch_s_gradient():
    """Within the port: the mean of two halves' f32 gradients is the whole
    batch's gradient (every loss term is a mean over the tokens).  After
    one step AdamW's first moment is 0.1 x the clipped gradient, so the
    moments, the gradient norms and the losses agree."""
    cfg = tbase.reduced_config(tbase.get_config("qwen2_1_5b"))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    out = {}
    for n in (1, 2):
        opt = TO.make_optimizer(TO.OptConfig(lr=1e-3))
        params = TT.model_init(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        p, s, m = make_train_step(cfg, opt, n_microbatches=n)(
            params, opt.init(params), batch)
        out[n] = (p, s, m)
    assert float(out[2][2]["loss"]) == pytest.approx(
        float(out[1][2]["loss"]), rel=1e-6)
    assert float(out[2][2]["grad_norm"]) == pytest.approx(
        float(out[1][2]["grad_norm"]), rel=1e-6)
    for a, b in zip(tree_leaves(out[2][1]["m"]), tree_leaves(out[1][1]["m"])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-9)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, TO.make_optimizer(), n_microbatches=3)(
            out[1][0], out[1][1], batch)


@pytest.mark.parametrize("arch", jbase.ARCHS)
def test_four_steps_descend(arch):
    """Four AdamW steps at lr 5e-3 on one batch (the JAX package's
    ``test_train_step_decreases_loss``): finite and descending."""
    cfg = tbase.reduced_config(tbase.get_config(arch))
    params = TT.model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = TO.make_optimizer(TO.OptConfig(lr=5e-3))
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, b=2).items()}
    losses = []
    for _ in range(4):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    assert not any(p.requires_grad for p in tree_leaves(params))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _run(module, *args, cwd):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    return proc.stdout


def test_launch_train_runs_checkpoints_and_resumes(tmp_path, capsys):
    out = _run("repro_torch.launch.train", "--device", "cpu", "--reduced",
               "--steps", "3", "--ckpt-every", "2", "--ckpt-dir",
               str(tmp_path / "ck"), cwd=tmp_path)
    assert "arch=qwen2-1.5b mesh=1x1 on cpu steps=3" in out
    assert "done: 3 steps, restarts=0" in out
    assert os.listdir(tmp_path / "ck") == ["step_2"]
    # a second run resumes from step 2 (in process)
    launch_train.main(["--device", "cpu", "--reduced", "--steps", "4",
                       "--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "ck"),
                       "--optimizer", "adamw"])
    assert "done: 2 steps, restarts=0" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_2", "step_4"]


def test_example_train_lm_runs(tmp_path):
    out = _run("repro_torch.examples.train_lm", "--device", "cpu", "--steps",
               "3", "--batch", "2", "--seq", "32", "--ckpt-dir",
               str(tmp_path / "ck"), cwd=tmp_path)
    assert "(reduced 25m) on cpu" in out
    assert "3 steps in" in out and "restarts=0" in out
    assert "loss: " in out


@pytest.mark.parametrize("argv", [["--optimizer", "adafactor",
                                   "--microbatches", "2"], []])
def test_launch_train_options_in_process(tmp_path, capsys, argv):
    launch_train.main(["--device", "cpu", "--reduced", "--arch",
                       "rwkv6_1_6b", "--steps", "2", "--global-batch", "2",
                       "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"),
                       *argv])
    out = capsys.readouterr().out
    assert "done: 2 steps" in out


def test_entry_points_refuse_the_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    from repro_torch.examples import train_lm

    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--reduced", "--steps", "1", "--ckpt-dir",
                           str(tmp_path / "a")])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_lm.main(["--steps", "1", "--ckpt-dir", str(tmp_path / "b")])
    assert not os.path.exists(tmp_path / "a")


def test_launch_train_refuses_other_meshes():
    """A mesh beyond 1x1 trains one process a rank: started alone, the
    launcher refuses it and names torch.distributed.run (the 2x2 run
    itself is ``test_torch_lm_mesh.py``'s)."""
    with pytest.raises(ValueError, match="torch.distributed.run"):
        launch_train.main(["--mesh", "2x2", "--device", "cpu", "--reduced"])
    with pytest.raises(ValueError, match="AxB"):
        launch_train.main(["--mesh", "2x2x2x2", "--device", "cpu",
                           "--reduced"])
