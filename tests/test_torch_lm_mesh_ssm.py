"""Mamba and RWKV-6 cut over ``model``, Adafactor on a mesh that cuts its
leaves, and the dry-run's count of one rank's step on a meta rank mesh,
on a process mesh (one rank a process, gloo on the CPU), held against
the port on one rank and against the JAX package on 4 host devices.

The process groups meet at a ``FileStore`` under the test's temporary
directory and run at once (a 2x2 and a 1x2 group), beside a 4-device
JAX subprocess and the launcher under
``torch.distributed.run`` for Jamba and RWKV-6 on 2x2; each rank
reports what it computed, gathered whole, and this process holds it
against ``mesh=None``.  Every configuration is the repository's reduced
one.  The module takes ~45-60 s in one process, most of it the spawned
processes' imports and the JAX subprocesses, beside them.

Reduced Jamba runs with its well-conditioned twin's weights
(``test_torch_train_loss``'s "per_layer": each layer's weights scaled to
the std of its own fan-in).  At the JAX package's init rule its stack of
one layer a period position draws weights of std 1 (ROADMAP Queue C,
"the init rule at full width"), and there f32 rounding alone moves the
one-rank logits by 9.9e-4 of the largest and the gradient norm by 2.5 %
against f64 (the same run on one rank), so no f32 mesh could be told
from one rank at the tolerances below.

Adafactor's second moment of a leaf it does not factor is g² at step 1,
so its update there is lr * sign(g): where |g| is within f32 rounding of
0 (``NOISE``, 1e-4 of the leaf's largest |g| on one rank) the JAX
package and the port may take opposite signs.  Against the JAX package
such an element may differ by 2 lr, and at most ``NOISE`` of a leaf's
elements may be such; every other element is held to ``JAX_PARAM_ATOL``.

Tolerances (those of ``test_torch_lm_mesh``):
  * logits: ``LOGIT_TOL`` (1e-4) of the largest |logit|;
  * losses and the gradient norm: ``RTOL`` / ``ATOL`` (1e-4 / 2e-5);
  * parameters after one step (lr 1e-3; AdamW's eps 1e-3): ``PARAM_ATOL``
    (5e-6, 0.5 % of a step);
  * Adafactor's ``vr`` / ``vc``: ``RTOL`` of the leaf's largest entry;
  * greedy tokens: equal;
  * against the JAX package: ``JAX_RTOL`` / ``JAX_ATOL`` (2e-4 / 5e-5)
    for losses and norms, ``JAX_PARAM_ATOL`` (2e-5, 2 % of a step) for
    parameters; for ``vr`` / ``vc``, means of g², whose relative error
    is twice g's, 2 ``JAX_RTOL`` of the leaf's largest entry;
  * the meta count: FLOPs equal to ``FlopCounterMode``'s, and collective
    bytes by kind equal to the rank's ``traffic``, exactly.
"""
import dataclasses
import datetime
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from conftest import REPO, SRC, run_subprocess_devices
from torch_threads import one_thread  # noqa: F401
from test_torch_lm_mesh import (ATOL, JAX_ATOL, JAX_PARAM_ATOL, JAX_RTOL,
                                LOGIT_TOL, PARAM_ATOL, RTOL, _batch,
                                _close_logits, _close_trees, _init, _np,
                                _ranks_agree, _run_lm)

from repro_torch.configs.base import ShapeConfig, get_config, reduced_config
from repro_torch.launch.cost_counter import count_costs
from repro_torch.launch.mesh import (P, make_mesh, make_meta_rank_mesh,
                                     make_process_mesh)
from repro_torch.launch.processes import run_ranks
from repro_torch.launch.specs import build_cell, opt_for
from repro_torch.models import transformer as T
from repro_torch.models.common import (gather_tree, shard_tree, tree_leaves,
                                       tree_map)
from repro_torch.models.moe import moe_path
from repro_torch.serve.engine import init_serve_state, pad_cache
from repro_torch.serve.prefill import prefill_step
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import OptConfig, make_optimizer

PG_TIMEOUT_S = 90
LR = 1e-3
EPS = 1e-3
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x2": ((1, 2), ("data", "model"))}
# (case, arch, config overrides): forward, prefill + 2 decode tokens and
# one ZeRO AdamW step on each mesh, B 4 x S 16
SSM = [("jamba", "jamba_v0_1_52b", {}), ("rwkv6", "rwkv6_1_6b", {})]
NOISE = 1e-4
# (case, arch, batch, seq): one Adafactor step on 2x2
ADAFACTOR = [("qwen2", "qwen2_1_5b", 4, 16),
             ("deepseek_gather", "deepseek_v3_671b", 4, 32)]
# (case, arch, overrides, shape): rank 0 of a 2x2 step, counted on a meta
# rank mesh and run on gloo (with ``opt_for``'s optimizer)
COUNTS = [("rwkv6_zero_adamw", "rwkv6_1_6b", {},
           ShapeConfig("count", 16, 4, "train")),
          ("deepseek_adafactor", "deepseek_v3_671b", {},
           ShapeConfig("count", 32, 4, "train"))]
B, S = 4, 16


def _cfg(arch, **kw):
    return reduced_config(get_config(arch), **kw)


def _twin(cfg, params):
    """Jamba's well-conditioned twin: every layer-stack weight of 2 or more
    dims a layer scaled to the std of its own fan-in (the init rule
    divides by the stack's layer count); the other models as drawn."""
    if not cfg.name.startswith("jamba"):
        return params
    for seg in params["segments"]:
        for layer in seg:
            tree_map(lambda a: a.mul_((a.shape[0] / a.shape[1]) ** 0.5)
                     if a.ndim >= 3 else a, layer)
    return params


def _weights(cfg, mesh=None):
    """The one-card weights of ``cfg`` (Jamba's twin), cut for ``mesh``."""
    params = _twin(cfg, _init(cfg))
    if mesh is None:
        return params
    return shard_tree(params, T.model_param_specs(cfg, mesh), mesh)


def _run(cfg, mesh, seed):
    """``test_torch_lm_mesh._run_lm`` on ``_weights`` (the step on a mesh
    only: ``one_rank`` takes each mesh's reference step)."""
    return _run_lm(cfg, mesh, B, S, seed=seed, step=mesh is not None,
                   params=_weights(cfg, mesh))


def _adafactor():
    return make_optimizer(OptConfig(name="adafactor", lr=LR))


def _n_micro(cfg, shape, b, s):
    """The one-rank step that holds a mesh step: one microbatch a data
    shard where an MoE routes each shard on its own."""
    if not cfg.moe:
        return 1
    mesh = make_mesh(shape, ("data", "model"), device="meta")
    return 1 if moe_path(cfg, mesh, b, s) == "partial" else shape[0]


# ---------------------------------------------------------------------------
# one rank of a process mesh
# ---------------------------------------------------------------------------


def _adafactor_step(cfg, mesh, b, s, seed):
    """One Adafactor step on ``mesh`` (None: one rank; its reference takes
    one microbatch a data shard where the MoE routes a shard alone):
    metrics, parameters and ``vr`` / ``vc``, gathered whole."""
    opt = _adafactor()
    full = _batch(cfg, b, s, seed)
    if mesh is None:
        params = _init(cfg)
        st = opt.init(params)
        n = _n_micro(cfg, MESHES["2x2"][0], b, s)
        fn = TS.make_train_step(cfg, opt, n_microbatches=n)
        params, st, met = fn(params, st, full)
    else:
        params = _init(cfg, mesh)
        st = TS.init_opt_state(opt, params, cfg, mesh)
        fn = TS.make_train_step(cfg, opt, mesh=mesh)
        params, st, met = fn(params, st, TS.shard_batch(full, mesh))
        specs = TS.state_specs(cfg, opt, mesh)
        params = gather_tree(params, specs["params"], mesh)
        st = {"v": gather_tree(st["v"], specs["opt"]["v"], mesh)}
    return {"step": {k: float(v) for k, v in met.items()},
            "params": _np(params), "v": _np(st["v"])}


def _cache_shapes_match(mesh):
    """``init_serve_state(mesh=)`` against the caches prefill leaves (padded
    to the same length), leaf for leaf, for each SSM case."""
    out = {}
    for case, arch, kw in SSM:
        cfg = _cfg(arch, **kw)
        params = _weights(cfg, mesh)
        prompt = TS.shard_batch({"x": _batch(cfg, B, 8, 3)["inputs"]},
                                mesh)["x"]
        _, cache, _ = prefill_step(params, prompt, cfg, mesh)
        got = init_serve_state(cfg, B, 11, device="cpu", mesh=mesh)["cache"]
        want = pad_cache(cache, cfg, prompt.shape[0], 11)
        out[case] = [(tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype)
                     for g, w in zip(tree_leaves(got), tree_leaves(want))]
    return out


def _count_on_gloo(mesh):
    """Rank 0's FLOPs (``FlopCounterMode``) and received bytes by kind in
    each COUNTS step on ``mesh``."""
    from torch.utils.flop_counter import FlopCounterMode

    out = {}
    for case, arch, kw, shape in COUNTS:
        cfg = _cfg(arch, **kw)
        meta = make_meta_rank_mesh(*MESHES["2x2"])
        n_micro = build_cell(arch, shape, meta, cfg=cfg)[4]["n_microbatches"]
        opt = make_optimizer(opt_for(cfg))
        params = _init(cfg, mesh)
        st = TS.init_opt_state(opt, params, cfg, mesh)
        fn = TS.make_train_step(cfg, opt, n_microbatches=n_micro, mesh=mesh)
        batch = TS.shard_batch(_batch(cfg, shape.global_batch, shape.seq_len,
                                      9), mesh)
        mesh.reset_traffic()
        with FlopCounterMode(display=False) as fc:
            fn(params, st, batch)
        out[case] = {"flops": fc.get_total_flops(),
                     "traffic": {k: v for k, v in mesh.traffic.items() if v}}
    return out


def _battery(rank, m, work):
    """One process of the ``m`` mesh; returns {case: outputs}."""
    torch.set_num_threads(1)
    mesh = make_process_mesh(*MESHES[m], device="cpu",
                             timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    out = {}
    for case, arch, kw in SSM:
        out[case] = _run(_cfg(arch, **kw), mesh, seed=1)
    if m == "2x2":
        for case, arch, b, s in ADAFACTOR:
            out[case] = _adafactor_step(_cfg(arch), mesh, b, s, seed=2)
        out["jax"] = _jax_side(mesh)
        out["caches"] = _cache_shapes_match(mesh)
        out["count"] = _count_on_gloo(mesh)
    return out


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

# (case, arch, overrides, optimizer, batch, seq): the port's 2x2 step
# without ZeRO against the JAX package's jitted 2x2 step
JAX_RUNS = [("jamba", "jamba_v0_1_52b", {}, "adamw", 4, 16),
            ("rwkv6", "rwkv6_1_6b", {}, "adamw", 4, 16),
            ("qwen2_adafactor", "qwen2_1_5b", {}, "adafactor", 4, 16),
            ("deepseek_adafactor", "deepseek_v3_671b", {}, "adafactor", 4, 32)]


def _jax_opt(name):
    return make_optimizer(OptConfig(name=name, lr=LR, eps=EPS))


def _jax_side(mesh):
    out = {}
    for case, arch, kw, name, b, s in JAX_RUNS:
        cfg = _cfg(arch, **kw)
        params = _weights(cfg, mesh)
        opt = _jax_opt(name)
        st = TS.init_opt_state(opt, params, cfg, mesh)
        fn = TS.make_train_step(cfg, opt, mesh=mesh)
        params, st, met = fn(params, st, TS.shard_batch(_batch(cfg, b, s, 6),
                                                        mesh))
        specs = TS.state_specs(cfg, opt, mesh)
        out[case] = {"step": {k: float(v) for k, v in met.items()},
                     "params": _np(gather_tree(params, specs["params"], mesh))}
        if name == "adafactor":
            out[case]["v"] = _np(gather_tree(st["v"], specs["opt"]["v"],
                                             mesh))
    return out


_JAX = r"""
import json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs.base import get_config, reduced_config
from repro.models import transformer as T
from repro.train.optimizer import OptConfig, make_optimizer
from repro.train.train_step import make_train_step

runs = json.load(open(WORK + "/jax_runs.json"))
devs = np.array(jax.devices())
mesh4 = Mesh(devs.reshape(2, 2), ("data", "model"))
for case, arch, kw, name in runs:
    cfg = reduced_config(get_config(arch), **kw)
    z = np.load(f"{WORK}/{case}.npz")
    tree = jax.tree_util.tree_structure(T.model_param_shapes(cfg))
    params = jax.tree_util.tree_unflatten(
        tree, [jnp.asarray(z[f"p{i}"]) for i in range(tree.num_leaves)])
    batch = {"inputs": jnp.asarray(z["inputs"]),
             "labels": jnp.asarray(z["labels"])}
    opt = make_optimizer(OptConfig(name=name, lr=LR, eps=EPS))
    step = jax.jit(make_train_step(cfg, mesh4, opt))
    with mesh4:
        p2, s2, met = step(params, opt.init(params), batch)
    out = {f"p{i}": np.asarray(leaf)
           for i, leaf in enumerate(jax.tree_util.tree_leaves(p2))}
    if name == "adafactor":
        for i, leaf in enumerate(jax.tree_util.tree_leaves(s2["v"])):
            out[f"v{i}"] = np.asarray(leaf)
    out["loss"] = np.asarray(met["loss"])
    out["grad_norm"] = np.asarray(met["grad_norm"])
    np.savez(f"{WORK}/{case}_out.npz", **out)
print("DONE")
"""


def _jax_inputs(work):
    """The port's one-rank init and each run's batch, for the JAX side."""
    runs = []
    for case, arch, kw, name, b, s in JAX_RUNS:
        cfg = _cfg(arch, **kw)
        full = _batch(cfg, b, s, 6)
        np.savez(os.path.join(work, f"{case}.npz"),
                 inputs=full["inputs"].numpy(), labels=full["labels"].numpy(),
                 **{f"p{i}": t.numpy()
                    for i, t in enumerate(tree_leaves(_weights(cfg)))})
        runs.append((case, arch, kw, name))
    with open(os.path.join(work, "jax_runs.json"), "w") as f:
        json.dump(runs, f)


def _jax_run(work):
    code = f"WORK = {work!r}\nLR = {LR!r}\nEPS = {EPS!r}\n" + _JAX
    return run_subprocess_devices(code, n_devices=4, timeout=400)


# ---------------------------------------------------------------------------
# the launcher under torch.distributed.run
# ---------------------------------------------------------------------------


def _launch(work):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = {}
    for arch in ("jamba_v0_1_52b", "rwkv6_1_6b"):
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", "4", "--standalone", "-m",
             "repro_torch.launch.train", "--arch", arch, "--mesh", "2x2",
             "--reduced", "--steps", "2", "--global-batch", "4", "--seq",
             "16", "--ckpt-every", "2", "--device", "cpu", "--ckpt-dir",
             os.path.join(work, f"ckpt_{arch}")],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        out[arch] = (proc.returncode, proc.stdout, proc.stderr[-3000:])
    return out


# ---------------------------------------------------------------------------
# the fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("lm_mesh_ssm"))
    _jax_inputs(work)
    with ThreadPoolExecutor(4) as pool:
        jax_f = pool.submit(_jax_run, work)
        launch_f = pool.submit(_launch, work)
        groups = {m: pool.submit(run_ranks, _battery,
                                 int(np.prod(MESHES[m][0])), store_dir=work,
                                 args=(m, work), timeout_s=PG_TIMEOUT_S,
                                 join_timeout_s=300)
                  for m in MESHES}
        got = {m: f.result() for m, f in groups.items()}
        assert "DONE" in jax_f.result()
        return {"mesh": got, "work": work, "launch": launch_f.result()}


@pytest.fixture(scope="module")
def one_rank():
    """The SSM cases on one rank (``mesh=None``): forward, decode and the
    ZeRO step's reference for each mesh's data shards."""
    out = {}
    for case, arch, kw in SSM:
        cfg = _cfg(arch, **kw)
        got = _run(cfg, None, seed=1)
        for m, (shape, _) in MESHES.items():
            opt = make_optimizer(OptConfig(lr=LR, eps=EPS, zero=True))
            params = _weights(cfg)
            fn = TS.make_train_step(cfg, opt,
                                    n_microbatches=_n_micro(cfg, shape, B, S))
            params, _, met = fn(params, opt.init(params), _batch(cfg, B, S, 1))
            got[m] = {"step": {k: float(v) for k, v in met.items()},
                      "params": _np(params)}
        out[case] = got
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", list(MESHES))
@pytest.mark.parametrize("case", [c[0] for c in SSM])
def test_ssm_forward_and_decode_match_one_rank(runs, one_rank, case, m):
    """Jamba (Mamba cut on its inner width) and RWKV-6 (cut by heads and on
    d_ff): logits, the loss and 2 greedy decode tokens after a prefill
    (every state written in place on its shard), against one rank; every
    rank holds the same gathered values."""
    ranks = runs["mesh"][m]
    _ranks_agree(ranks, case)
    got, want = ranks[0][case], one_rank[case]
    _close_logits(got["logits"], want["logits"])
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["metrics"]["nll"], want["metrics"]["nll"],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m", list(MESHES))
@pytest.mark.parametrize("case", [c[0] for c in SSM])
def test_ssm_zero_step_matches_one_rank(runs, one_rank, case, m):
    """One ZeRO AdamW step: loss, gradient norm and every parameter
    against one rank (one microbatch a data shard where the MoE router
    loss is a shard's)."""
    got, want = runs["mesh"][m][0][case], one_rank[case][m]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got["step"][k], want["step"][k], rtol=RTOL,
                                   atol=ATOL)
    _close_trees(got["params"], want["params"], PARAM_ATOL, case)


@pytest.mark.parametrize("case", [c[0] for c in ADAFACTOR])
def test_adafactor_on_a_cut_matches_one_rank(runs, case):
    """Adafactor on 2x2, whose model axis cuts the projections (and the
    data axis DeepSeek-V3's gathered experts): loss, gradient norm,
    parameters and the factored moments against one rank."""
    arch, b, s = next((a, b, s) for c, a, b, s in ADAFACTOR if c == case)
    got = runs["mesh"]["2x2"][0][case]
    want = _adafactor_step(_cfg(arch), None, b, s, seed=2)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got["step"][k], want["step"][k], rtol=RTOL)
    _close_trees(got["params"], want["params"], PARAM_ATOL, case)
    for g, w in zip(tree_leaves(got["v"]), tree_leaves(want["v"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * np.abs(w).max())


def test_adafactor_cuts_factored_leaves_on_2x2():
    """The Adafactor cases reach the new code: some factored leaf of each
    is cut over ``model`` on a dimension its means reduce."""
    mesh = make_mesh(*MESHES["2x2"], device="meta")
    for _, arch, _, _ in ADAFACTOR:
        cfg = _cfg(arch)
        opt = _adafactor()
        lay = TS.train_layout(cfg, opt, mesh)
        cut = [l for l, p in zip(tree_leaves(lay),
                                 tree_leaves(T.model_param_shapes(cfg)))
               if p.ndim >= 2 and min(p.shape[-2:]) >= 128
               and (l.spec[-1] or l.spec[-2])]
        assert cut, arch


def _one_rank_grads(cfg, b, s):
    """The gradient a 2x2 step takes, on one rank, as numpy leaves: the
    mean of the data shards' where the MoE routes a shard alone."""
    full = _batch(cfg, b, s, 6)
    n = _n_micro(cfg, MESHES["2x2"][0], b, s)
    leaves = [tree_leaves(TS._grads_of(
        _weights(cfg), {k: v.chunk(n)[i] for k, v in full.items()}, cfg)[2])
        for i in range(n)]
    return [sum(part[j] for part in leaves).numpy() / n
            for j in range(len(leaves[0]))]


@pytest.mark.parametrize("case", [c[0] for c in JAX_RUNS])
def test_step_matches_jax_on_2x2(runs, case):
    """The port's 2x2 step (no ZeRO) against the JAX package's jitted 2x2
    step on the same weights and batch: loss, gradient norm, every
    parameter, and Adafactor's ``vr`` / ``vc`` (its moments gathered)."""
    got = runs["mesh"]["2x2"][0]["jax"][case]
    z = np.load(os.path.join(runs["work"], f"{case}_out.npz"))
    np.testing.assert_allclose(got["step"]["loss"], z["loss"], rtol=JAX_RTOL,
                               atol=JAX_ATOL)
    np.testing.assert_allclose(got["step"]["grad_norm"], z["grad_norm"],
                               rtol=JAX_RTOL)
    arch, kw, name, b, s = next(r[1:] for r in JAX_RUNS if r[0] == case)
    grads = (_one_rank_grads(_cfg(arch, **kw), b, s) if name == "adafactor"
             else None)
    for i, leaf in enumerate(tree_leaves(got["params"])):
        want = z[f"p{i}"]
        if grads is None:
            np.testing.assert_allclose(leaf, want, rtol=0,
                                       atol=JAX_PARAM_ATOL, err_msg=f"leaf {i}")
            continue
        # lr * sign(g) where g is rounding (the module's docstring)
        g = np.abs(grads[i])
        off = np.abs(leaf - want) > JAX_PARAM_ATOL
        assert off.sum() <= NOISE * off.size, (i, int(off.sum()))
        assert (g[off] <= NOISE * g.max()).all(), (i, g[off], g.max())
        np.testing.assert_allclose(leaf[off], want[off], rtol=0,
                                   atol=2 * LR * 1.01, err_msg=f"leaf {i}")
    for i, leaf in enumerate(tree_leaves(got.get("v", {}))):
        want = z[f"v{i}"]
        np.testing.assert_allclose(leaf, want, rtol=0,
                                   atol=2 * JAX_RTOL * np.abs(want).max(),
                                   err_msg=f"v leaf {i}")


def test_cache_init_on_a_mesh_gives_the_prefill_shards(runs):
    """``init_serve_state(mesh=)`` on 2x2: every Mamba, RWKV-6 and
    attention cache leaf has the shape and dtype prefill leaves on that
    rank (Mamba's states cut on their inner width, RWKV's WKV state by
    heads, the attention cache on the rank's KV heads)."""
    for r, got in enumerate(runs["mesh"]["2x2"]):
        for case, ok in got["caches"].items():
            assert ok and all(ok), (r, case, ok)


@pytest.mark.parametrize("case", [c[0] for c in COUNTS])
def test_meta_count_of_rank_0_equals_the_run_on_gloo(runs, case):
    """Rank 0 of a 2x2 train step counted on a meta rank mesh
    (``build_cell`` + ``count_costs``, as the dry-run counts a
    production cell): its FLOPs equal ``FlopCounterMode``'s over rank 0
    of the same step on gloo, and its collective bytes by kind equal
    that rank's ``traffic``, exactly."""
    _, arch, kw, shape = next(c for c in COUNTS if c[0] == case)
    mesh = make_meta_rank_mesh(*MESHES["2x2"])
    step, args, _, _, _ = build_cell(arch, shape, mesh, cfg=_cfg(arch, **kw))
    _, costs = count_costs(step, *args, mesh=mesh,
                           replay=((TS, "_grads_of"),))
    got = runs["mesh"]["2x2"][0]["count"][case]
    assert costs.flops == got["flops"] > 0
    assert dict(costs.collective_bytes) == got["traffic"]
    assert set(costs.collective_count) == set(got["traffic"])


@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "rwkv6_1_6b"])
def test_launch_train_runs_ssm_archs_on_a_2x2_mesh(runs, arch):
    rc, out, err = runs["launch"][arch]
    assert rc == 0, err
    assert "mesh=2x2" in out and "done: 2 steps" in out, out
