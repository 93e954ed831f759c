"""The LM on a process mesh (one rank a process, gloo on the CPU): the
tensor-, data- and expert-parallel forward, the vocabulary-cut embedding
and loss, the sharded train step with ZeRO, prefill and decode,
checkpoints across meshes and ``launch.train --mesh 2x2``, held against
the port on one rank and against the JAX package on 4 host devices.

The process groups meet at a ``FileStore`` under the test's temporary
directory and run at once (a 2x2 and a 2x1 group, then a 2x1 group that
restores the 2x2 group's checkpoint), beside one 4-device JAX subprocess
and one ``torch.distributed.run`` of the launcher; each rank reports
what it computed, gathered to whole tensors, and this process holds it
against ``mesh=None``.  Every configuration is the repository's reduced
one, in f32.  The module takes ~40-60 s in one process, most of it the
spawned processes' imports and the JAX subprocess (~30 s, beside them).

Tolerances (f32; the mesh sums in other orders than one rank):
  * logits: ``LOGIT_TOL`` (1e-4) of the largest |logit|;
  * losses and the gradient norm: ``RTOL`` / ``ATOL`` (1e-4 / 2e-5);
  * parameters after one AdamW step (lr 1e-3, eps 1e-3, so that the
    update stays smooth in a tiny gradient): ``PARAM_ATOL`` (5e-6, 0.5 %
    of a step);
  * greedy tokens: equal;
  * against the JAX package: ``JAX_RTOL`` / ``JAX_ATOL`` (2e-4 / 5e-5)
    for losses, norms and logits (Jamba's: ``JAMBA_SP_REL``), ``JAX_PARAM_ATOL`` (2e-5, 2 % of a
    step) for parameters.

The sequence-parallel residual (``cfg.sequence_parallel``) runs in the
same 2x2 spawn: for each layer kind its logits, loss and every rank's
gradients against the same mesh without the flag (f32 sums in other
orders: ``SP_TOL``, 1e-5 of the largest |value| of each logit tensor
and gradient leaf, observed <= 4e-7; the loss within ``SP_LOSS_RTOL``,
1e-6, observed equal), its logits against the JAX package's forward
with the flag on 4 host devices (``JAX_RTOL`` / ``JAX_ATOL``); a
sequence that ``model`` does not divide, and prefill and decode with a
cache, bitwise the same without the flag.  They add ~10 s to the spawn
and ~25 s to the JAX subprocess, which runs beside it.

The router loss of an MoE layer is the JAX package's: the mean over the
data shards of each shard's loss, so on several data shards it is not
the one-rank loss of the whole batch.  The one-rank reference of a step
that takes the gather or local path is therefore the step with one
microbatch a data shard (``n_microbatches``), which averages the shards'
losses and gradients exactly so; the partial path routes every token on
every rank, and its reference is the plain step.
"""
import datetime
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from conftest import REPO, SRC, run_subprocess_devices
from torch_threads import one_thread  # noqa: F401

from repro_torch.configs.base import ARCHS, get_config, reduced_config
from repro_torch.launch.mesh import P, make_mesh, make_process_mesh
from repro_torch.launch.processes import run_ranks
from repro_torch.models import transformer as T
from repro_torch.models.common import (cross_entropy_logits_sharded,
                                       embed_lookup, gather_tree,
                                       shard_tree, tree_leaves, tree_map)
from repro_torch.models.moe import moe_path
from repro_torch.serve.engine import decode_step, pad_cache
from repro_torch.serve.prefill import prefill_step
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig, make_optimizer
from repro_torch.train.train_step import (init_opt_state, make_train_step,
                                          shard_batch, shardings_for,
                                          state_specs)

RTOL, ATOL = 1e-4, 2e-5
LOGIT_TOL = 1e-4
PARAM_ATOL = 5e-6
JAX_RTOL, JAX_ATOL = 2e-4, 5e-5
JAX_PARAM_ATOL = 2e-5
SP_TOL = 1e-5
SP_LOSS_RTOL = 1e-6
# Jamba against the JAX package: one ulp on the reference's input moves
# its logits by ~1e-3 of their largest (test_torch_models'
# JAMBA_FORWARD_REL), and its own forwards with and without the flag on
# 2x2 differ by 4.3e-4 of it; held as there, max error / max |logit|
JAMBA_SP_REL = 3e-3
PG_TIMEOUT_S = 90
LR = 1e-3
EPS = 1e-3        # Adam's eps: the update stays smooth in a tiny gradient
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x1": ((2, 1), ("data", "model"))}

# (case, arch, global batch, seq, config overrides) on 2x2
CASES = [("qwen2", "qwen2_1_5b", 4, 16, {}),
         ("granite", "granite_20b", 4, 16, {}),
         ("qwen3_moe", "qwen3_moe_30b_a3b", 4, 16, {}),
         ("deepseek_gather", "deepseek_v3_671b", 4, 32, {}),
         ("deepseek_partial", "deepseek_v3_671b", 2, 8, {})]
PROMPT = 8        # prefill length; 2 decode tokens follow

# (case, arch, global batch, seq, config overrides) of the sequence-
# parallel cases on 2x2: a layer kind each; "replicated" has blocks that
# every rank runs alike (3 heads and an odd d_ff on 2 model ranks)
SP_CASES = [("attention", "qwen2_1_5b", 4, 16, {}),
            ("attention_bias", "starcoder2_3b", 4, 16, {}),
            ("replicated", "qwen2_1_5b", 4, 16,
             {"num_heads": 3, "num_kv_heads": 1, "head_pad_factor": 1,
              "d_ff": 255}),
            ("mla_moe_gather", "deepseek_v3_671b", 4, 32, {}),
            ("moe_partial", "deepseek_v3_671b", 2, 8, {}),
            ("moe_partial_no_shared", "deepseek_v3_671b", 2, 8,
             {"n_shared_experts": 0}),
            ("moe_local", "qwen3_moe_30b_a3b", 4, 16, {}),
            ("mamba", "jamba_v0_1_52b", 4, 16, {}),
            ("rwkv6", "rwkv6_1_6b", 4, 16, {})]
# held against the JAX package's forward (its partial path counts shared
# experts once a data shard: see the "shared" run)
SP_JAX = ["attention", "mla_moe_gather", "moe_partial_no_shared",
          "moe_local", "mamba", "rwkv6"]
SP_SEED = 9
SP_SERVE = ["qwen2_1_5b", "deepseek_v3_671b", "jamba_v0_1_52b",
            "rwkv6_1_6b"]


def _cfg(arch, **kw):
    return reduced_config(get_config(arch), **kw)


def _batch(cfg, b, s, seed):
    rng = np.random.RandomState(seed)
    if cfg.input_mode == "embeddings":
        inputs = torch.from_numpy(
            rng.standard_normal((b, s, cfg.d_model)).astype(np.float32))
    else:
        inputs = torch.from_numpy(
            rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32))
    labels = torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32))
    return {"inputs": inputs, "labels": labels}


def _init(cfg, mesh=None):
    return T.model_init(cfg, torch.Generator("cpu").manual_seed(0),
                        device="cpu", mesh=mesh)


def _opt():
    return make_optimizer(OptConfig(lr=LR, eps=EPS, zero=True))


def _np(tree):
    return tree_map(lambda t: t.detach().float().numpy().copy(), tree)


# ---------------------------------------------------------------------------
# one rank of a process mesh
# ---------------------------------------------------------------------------


def _run_lm(cfg, mesh, b, s, seed, *, decode=True, step=True, params=None):
    """forward, one ZeRO step and prefill + 2 decode tokens on ``mesh``
    (None, or this process's rank) from ``params`` (default ``_init``'s);
    every output gathered whole."""
    full = _batch(cfg, b, s, seed)
    batch = shard_batch(full, mesh)
    dp = T.dp_axes(mesh) if mesh is not None else ()
    params = _init(cfg, mesh) if params is None else params
    out = {}
    with torch.no_grad():
        logits, _, _, _ = T.forward(params, batch["inputs"], cfg, mesh=mesh)
        loss, metrics = T.lm_loss(params, batch, cfg, mesh=mesh)
    if mesh is not None:
        logits = mesh.unshard(logits.unsqueeze(0), P(dp, None, "model"))
    out["logits"] = logits.numpy()
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["loss"] = float(loss)
    if decode:
        prompt = full["inputs"][:, :PROMPT]
        local = shard_batch({"x": prompt}, mesh)["x"]
        tok, cache, cur = prefill_step(params, local, cfg, mesh)
        state = {"cache": pad_cache(cache, cfg, local.shape[0], PROMPT + 3),
                 "cur_len": cur}
        toks = [tok]
        for _ in range(2):
            tok, state = decode_step(params, state, tok, cfg, mesh)
            toks.append(tok)
        toks = torch.cat(toks, dim=1)
        if mesh is not None:
            toks = mesh.unshard(toks.unsqueeze(0), P(dp, None))
        out["tokens"] = toks.numpy()
    if step:
        opt = _opt()
        st = init_opt_state(opt, params, cfg, mesh)
        fn = make_train_step(cfg, opt, mesh=mesh)
        params, st, met = fn(params, st, batch)
        if mesh is not None:
            params = gather_tree(params, T.model_param_specs(cfg, mesh), mesh)
        out["step"] = {k: float(v) for k, v in met.items()}
        out["params"] = _np(params)
    return out


def _battery(rank, m, work):
    """One process of the ``m`` mesh; returns {case: outputs}."""
    torch.set_num_threads(1)
    mesh = make_process_mesh(*MESHES[m], device="cpu",
                             timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    out = {}
    if m == "2x2":
        for case, arch, b, s, kw in CASES:
            out[case] = _run_lm(_cfg(arch, **kw), mesh, b, s, seed=1)
        out["jax"] = _jax_side(mesh, work)
        out["ckpt"] = _ckpt_save(mesh, work)
        out["lookup"] = _lookup_and_ce(mesh)
        out["init"] = _init_shards(mesh)
        out["replicated"] = _replicated_batch(mesh)
        out["sp"] = _sp_side(mesh)
    else:
        for arch in ARCHS:
            out[arch] = _run_lm(_cfg(arch), mesh, 2, 8, seed=2, decode=False)
    return out


def _restore_battery(rank, work):
    torch.set_num_threads(1)
    mesh = make_process_mesh(*MESHES["2x1"], device="cpu",
                             timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    return _ckpt_continue(mesh, work)


# ---------------------------------------------------------------------------
# checkpoints across meshes
# ---------------------------------------------------------------------------

CKPT_ARCH = "qwen2_1_5b"


def _ckpt_state(cfg, mesh):
    params = _init(cfg, mesh)
    opt = _opt()
    return params, init_opt_state(opt, params, cfg, mesh), opt


def _ckpt_save(mesh, work):
    """One step on 2x2, saved (each leaf gathered, one writer), then the
    next step's loss and parameters."""
    cfg = _cfg(CKPT_ARCH)
    params, st, opt = _ckpt_state(cfg, mesh)
    fn = make_train_step(cfg, opt, mesh=mesh)
    specs = state_specs(cfg, opt, mesh)
    params, st, _ = fn(params, st, shard_batch(_batch(cfg, 4, 16, 3), mesh))
    ckpt.save_checkpoint(os.path.join(work, "ckpt"), 1,
                         {"params": params, "opt": st}, mesh=mesh,
                         specs=specs)
    params, st, met = fn(params, st, shard_batch(_batch(cfg, 4, 16, 4), mesh))
    return {"loss": float(met["loss"]),
            "params": _np(gather_tree(params, specs["params"], mesh))}


def _ckpt_continue(mesh, work):
    """The 2x2 checkpoint restored on ``mesh`` (None: one rank), and the
    next step."""
    cfg = _cfg(CKPT_ARCH)
    params, st, opt = _ckpt_state(cfg, mesh)
    specs = state_specs(cfg, opt, mesh) if mesh is not None else None
    state = ckpt.restore_checkpoint(os.path.join(work, "ckpt"), 1,
                                    {"params": params, "opt": st},
                                    device="cpu", mesh=mesh, specs=specs)
    fn = make_train_step(cfg, opt, mesh=mesh)
    params, st, met = fn(state["params"], state["opt"],
                         shard_batch(_batch(cfg, 4, 16, 4), mesh))
    if mesh is not None:
        params = gather_tree(params, specs["params"], mesh)
    return {"loss": float(met["loss"]), "params": _np(params)}


# ---------------------------------------------------------------------------
# parameters on a mesh
# ---------------------------------------------------------------------------


def _init_shards(mesh):
    """For each 2x2 case's model: ``model_init(mesh=)`` and the carry-over
    of a numpy tree (``params_from_numpy(mesh=)``) against the one-card
    init cut by the resolved specs, bitwise."""
    from repro_torch.models.convert import params_from_numpy

    out = {}
    for case, arch, _, _, kw in CASES:
        cfg = _cfg(arch, **kw)
        specs = T.model_param_specs(cfg, mesh)
        want = tree_leaves(shard_tree(_init(cfg), specs, mesh))
        got = tree_leaves(_init(cfg, mesh))
        carried = tree_leaves(params_from_numpy(
            tree_map(lambda t: t.numpy(), _init(cfg)), cfg, mesh=mesh))
        out[case] = all(torch.equal(a, b) and torch.equal(c, b)
                        for a, b, c in zip(got, want, carried))
    return out


def _replicated_batch(mesh=None):
    """A batch the data axes do not divide (B = 1), whole on every rank
    (``dp=()``): DeepSeek-V3's forward logits and prefill + 2 decode
    tokens, the MoE on its partial path with the tokens replicated."""
    cfg = _cfg("deepseek_v3_671b")
    params = _init(cfg, mesh)
    full = _batch(cfg, 1, 8, 8)["inputs"]
    dp = () if mesh is not None else None
    with torch.no_grad():
        logits = T.forward(params, full, cfg, mesh=mesh, dp=dp)[0]
        tok, cache, cur = prefill_step(params, full, cfg, mesh, dp)
        state = {"cache": pad_cache(cache, cfg, 1, 11), "cur_len": cur}
        toks = [tok]
        for _ in range(2):
            tok, state = decode_step(params, state, tok, cfg, mesh, dp)
            toks.append(tok)
    if mesh is not None:
        logits = mesh.unshard(logits.unsqueeze(0), P(None, None, "model"))
    return {"logits": logits.numpy(), "tokens": torch.cat(toks, 1).numpy()}


# ---------------------------------------------------------------------------
# the sequence-parallel residual
# ---------------------------------------------------------------------------


def _sp_run(cfg, mesh, b, s):
    """The gathered logits, the loss and this rank's gradient of every
    parameter leaf (the data shard's, before any reduction over data)."""
    batch = shard_batch(_batch(cfg, b, s, SP_SEED), mesh)
    params = _init(cfg, mesh)
    with torch.no_grad():
        logits = T.forward(params, batch["inputs"], cfg, mesh=mesh)[0]
    logits = mesh.unshard(logits.unsqueeze(0),
                          P(T.dp_axes(mesh), None, "model"))
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    loss, _ = T.lm_loss(params, batch, cfg, mesh=mesh)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {"logits": logits.numpy(), "loss": float(loss),
            "grads": [None if g is None else g.numpy() for g in grads]}


def _sp_serve(cfg, mesh):
    """Prefill of PROMPT tokens and 2 greedy tokens: this rank's tokens
    and every cache leaf it holds after them."""
    prompt = _batch(cfg, 4, PROMPT, SP_SEED)["inputs"]
    local = shard_batch({"x": prompt}, mesh)["x"]
    params = _init(cfg, mesh)
    with torch.no_grad():
        tok, cache, cur = prefill_step(params, local, cfg, mesh)
        state = {"cache": pad_cache(cache, cfg, local.shape[0], PROMPT + 3),
                 "cur_len": cur}
        toks = [tok]
        for _ in range(2):
            tok, state = decode_step(params, state, tok, cfg, mesh)
            toks.append(tok)
    return {"tokens": torch.cat(toks, dim=1).numpy(),
            "cache": [t.numpy() for t in tree_leaves(state["cache"])]}


def _sp_side(mesh):
    out = {case: {sp: _sp_run(_cfg(arch, sequence_parallel=sp, **kw), mesh,
                              b, s)
                  for sp in (False, True)}
           for case, arch, b, s, kw in SP_CASES}
    # 15 rows: model (2) does not divide the sequence
    out["odd"] = {sp: _sp_run(_cfg("qwen2_1_5b", sequence_parallel=sp),
                              mesh, 4, 15) for sp in (False, True)}
    out["serve"] = {arch: {sp: _sp_serve(_cfg(arch, sequence_parallel=sp),
                                         mesh) for sp in (False, True)}
                    for arch in SP_SERVE}
    return out


# ---------------------------------------------------------------------------
# the embedding lookup and the cut cross-entropy alone
# ---------------------------------------------------------------------------


def _lookup_and_ce(mesh):
    rng = np.random.RandomState(5)
    v, d = 64, 8
    emb = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    tok = torch.from_numpy(rng.randint(0, v, (4, 6)))
    logits = torch.from_numpy(rng.standard_normal((4, 6, v))
                              .astype(np.float32))
    valid = torch.from_numpy(rng.rand(4, 6) > 0.3)
    dp = ("data",)
    e_loc = mesh.shard(emb, P("model", None))[0].requires_grad_()
    t_loc = mesh.shard(tok, P(dp, None))[0]
    rows = embed_lookup(t_loc, e_loc, mesh, v)
    l_loc = mesh.shard(logits, P(dp, None, "model"))[0].requires_grad_()
    ce = cross_entropy_logits_sharded(
        l_loc, t_loc, valid_mask=mesh.shard(valid, P(dp, None))[0],
        mesh=mesh, vocab=v, dp=dp)
    (rows.square().sum() + ce).backward()
    g_emb = mesh.psum(e_loc.grad.unsqueeze(0), dp)   # summed over data
    return {"rows": mesh.unshard(rows.detach().unsqueeze(0),
                                 P(dp, None, None)).numpy(),
            "ce": float(ce.detach()),
            "g_emb": mesh.unshard(g_emb, P("model", None)).numpy(),
            "g_logits": mesh.unshard(l_loc.grad.unsqueeze(0),
                                     P(dp, None, "model")).numpy()}


# ---------------------------------------------------------------------------
# against the JAX package: the port's side (its weights go to JAX)
# ---------------------------------------------------------------------------

# (case, arch, batch, seq, overrides): DeepSeek through both MoE paths;
# the partial path without shared experts, where the JAX package's
# island is right (with them it counts them once a data shard: the
# "shared" case below shows it)
JAX_RUNS = [("qwen2", "qwen2_1_5b", 4, 16, {}),
            ("deepseek_gather", "deepseek_v3_671b", 4, 32, {}),
            ("deepseek_partial", "deepseek_v3_671b", 2, 8,
             {"n_shared_experts": 0})]


def _jax_side(mesh, work):
    out = {}
    for case, arch, b, s, kw in JAX_RUNS:
        cfg = _cfg(arch, **kw)
        full = _batch(cfg, b, s, 6)
        params = _init(cfg, mesh)
        opt = make_optimizer(OptConfig(lr=LR, eps=EPS))
        st = init_opt_state(opt, params, cfg, mesh)
        fn = make_train_step(cfg, opt, mesh=mesh)
        params, st, met = fn(params, st, shard_batch(full, mesh))
        out[case] = {"step": {k: float(v) for k, v in met.items()},
                     "params": _np(gather_tree(
                         params, T.model_param_specs(cfg, mesh), mesh))}
    return out


_JAX = r"""
import json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs.base import get_config, reduced_config
from repro.models import transformer as T
from repro.train.optimizer import OptConfig, make_optimizer
from repro.train.train_step import make_train_step, shardings_for

runs = json.load(open(WORK + "/jax_runs.json"))
devs = np.array(jax.devices())
mesh4 = Mesh(devs.reshape(2, 2), ("data", "model"))
mesh1 = Mesh(devs[:1].reshape(1, 1), ("data", "model"))
res = {}
for case, arch, kw in runs:
    cfg = reduced_config(get_config(arch), **kw)
    z = np.load(f"{WORK}/{case}.npz")
    tree = jax.tree_util.tree_structure(T.model_param_shapes(cfg))
    params = jax.tree_util.tree_unflatten(
        tree, [jnp.asarray(z[f"p{i}"]) for i in range(tree.num_leaves)])
    batch = {"inputs": jnp.asarray(z["inputs"]),
             "labels": jnp.asarray(z["labels"])}
    out = {}
    if case == "shared":
        for name, mesh in (("m1", mesh1), ("m4", mesh4)):
            with mesh:
                lg = jax.jit(lambda p, t: T.forward(p, t, cfg, mesh)[0])(
                    params, batch["inputs"])
            out[name] = np.asarray(lg)
    elif case.startswith("sp_"):
        with mesh4:
            lg = jax.jit(lambda p, t: T.forward(p, t, cfg, mesh4)[0])(
                params, batch["inputs"])
        out["logits"] = np.asarray(lg)
    else:
        opt = make_optimizer(OptConfig(lr=LR, eps=EPS))
        step = jax.jit(make_train_step(cfg, mesh4, opt))
        with mesh4:
            p2, _, met = step(params, opt.init(params), batch)
        for i, leaf in enumerate(jax.tree_util.tree_leaves(p2)):
            out[f"p{i}"] = np.asarray(leaf)
        out["loss"] = np.asarray(met["loss"])
        out["grad_norm"] = np.asarray(met["grad_norm"])
    np.savez(f"{WORK}/{case}_out.npz", **out)
# ZeRO on DeepSeek-V3's moe_fsdp experts: a spec naming 'data' twice
cfg = reduced_config(get_config("deepseek_v3_671b"))
try:
    shardings_for(cfg, mesh4, make_optimizer(OptConfig(zero=True)))
    res["zero"] = "accepted"
except Exception as e:
    res["zero"] = type(e).__name__
print("JSON" + json.dumps(res))
"""


def _jax_inputs(work):
    """The port's one-rank init and each run's batch, for the JAX side."""
    import json

    runs = []
    sp = {c[0]: c for c in SP_CASES}
    for case, arch, b, s, kw, seed in (
            [r + (6,) for r in JAX_RUNS]
            + [("shared", "deepseek_v3_671b", 2, 8, {}, 6)]
            + [(f"sp_{c}",) + sp[c][1:4]
               + (dict(sp[c][4], sequence_parallel=True), SP_SEED)
               for c in SP_JAX]):
        cfg = _cfg(arch, **kw)
        leaves = tree_leaves(_init(cfg))
        full = _batch(cfg, b, s, seed)
        np.savez(os.path.join(work, f"{case}.npz"),
                 inputs=full["inputs"].numpy(), labels=full["labels"].numpy(),
                 **{f"p{i}": t.numpy() for i, t in enumerate(leaves)})
        runs.append((case, arch, kw))
    with open(os.path.join(work, "jax_runs.json"), "w") as f:
        json.dump(runs, f)


def _jax_run(work):
    import json

    code = f"WORK = {work!r}\nLR = {LR!r}\nEPS = {EPS!r}\n" + _JAX
    out = run_subprocess_devices(code, n_devices=4, timeout=400)
    return json.loads(out.split("JSON", 1)[1])


# ---------------------------------------------------------------------------
# the launcher under torch.distributed.run
# ---------------------------------------------------------------------------


def _launch(work):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "4", "--standalone", "-m", "repro_torch.launch.train",
         "--mesh", "2x2", "--reduced", "--steps", "2", "--global-batch", "4",
         "--seq", "16", "--ckpt-every", "2", "--device", "cpu",
         "--ckpt-dir", os.path.join(work, "launch_ckpt")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    return proc.returncode, proc.stdout, proc.stderr[-3000:]


# ---------------------------------------------------------------------------
# the fixture: every process group, the JAX side and the launcher at once
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("lm_mesh"))
    _jax_inputs(work)
    with ThreadPoolExecutor(4) as pool:
        jax_f = pool.submit(_jax_run, work)
        launch_f = pool.submit(_launch, work)
        groups = {m: pool.submit(run_ranks, _battery, int(np.prod(MESHES[m][0])),
                                 store_dir=work, args=(m, work),
                                 timeout_s=PG_TIMEOUT_S, join_timeout_s=300)
                  for m in MESHES}
        got = {m: f.result() for m, f in groups.items()}
        restored = run_ranks(_restore_battery, 2, store_dir=work, args=(work,),
                             timeout_s=PG_TIMEOUT_S, join_timeout_s=300)
        return {"mesh": got, "restored": restored, "work": work,
                "jax": jax_f.result(), "launch": launch_f.result()}


@pytest.fixture(scope="module")
def one_rank():
    """The same cases on one rank (``mesh=None``)."""
    out = {}
    for case, arch, b, s, kw in CASES:
        cfg = _cfg(arch, **kw)
        n = _n_micro(cfg, "2x2", b, s)
        got = _run_lm(cfg, None, b, s, seed=1, step=False)
        got.update(_one_rank_step(cfg, b, s, 1, n))
        if n == 2:    # the router loss of each data shard
            got["aux"] = np.mean([_shard_aux(cfg, b, s, 1, i) for i in (0, 1)])
        out[case] = got
    return out


def _n_micro(cfg, m, b, s):
    """The one-rank step that holds a ``m`` step: one microbatch a data
    shard where an MoE routes each shard on its own."""
    if not cfg.moe:
        return 1
    mesh = make_mesh(*MESHES[m], device="meta")
    return 1 if moe_path(cfg, mesh, b, s) == "partial" else MESHES[m][0][0]


def _one_rank_step(cfg, b, s, seed, n_micro):
    params = _init(cfg)
    opt = _opt()
    fn = make_train_step(cfg, opt, n_microbatches=n_micro)
    params, _, met = fn(params, opt.init(params), _batch(cfg, b, s, seed))
    return {"step": {k: float(v) for k, v in met.items()},
            "params": _np(params)}


def _shard_aux(cfg, b, s, seed, i):
    full = _batch(cfg, b, s, seed)
    half = {k: v[i * b // 2:(i + 1) * b // 2] for k, v in full.items()}
    with torch.no_grad():
        return float(T.lm_loss(_init(cfg), half, cfg)[1]["aux"])


def _close_logits(got, want, tol=LOGIT_TOL):
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def _close_trees(got, want, atol, what):
    for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                   err_msg=f"{what}: leaf {i}")


def _ranks_agree(ranks, key):
    for r in ranks[1:]:
        for a, b in zip(tree_leaves(r[key]), tree_leaves(ranks[0][key])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_forward_and_decode_match_one_rank(runs, one_rank, case):
    """2x2: logits, the loss and its parts, and 2 greedy decode tokens
    after a prefill, against the port on one rank; every rank holds the
    same gathered values."""
    ranks = runs["mesh"]["2x2"]
    _ranks_agree(ranks, case)
    got, want = ranks[0][case], one_rank[case]
    _close_logits(got["logits"], want["logits"])
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    for k in ("nll", "mtp"):
        if k in want["metrics"]:
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                       rtol=RTOL)
    np.testing.assert_allclose(got["metrics"]["aux"],
                               want.get("aux", want["metrics"]["aux"]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_zero_step_matches_one_rank(runs, one_rank, case):
    """2x2, AdamW with ZeRO: one step's loss, gradient norm and updated
    parameters against one rank (one microbatch a data shard where the
    MoE router loss is a shard's)."""
    got, want = runs["mesh"]["2x2"][0][case], one_rank[case]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got["step"][k], want["step"][k], rtol=RTOL)
    _close_trees(got["params"], want["params"], PARAM_ATOL, case)


def test_cases_take_the_paths_they_name():
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    for case, arch, b, s, kw in CASES:
        path = moe_path(_cfg(arch, **kw), mesh, b, s)
        want = {"deepseek_gather": "gather", "deepseek_partial": "partial",
                "qwen3_moe": "local"}.get(case, "local")
        assert path == want, (case, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_runs_on_a_data_only_mesh(runs, arch):
    """2x1: every architecture's forward and one ZeRO step against one
    rank (MoE: one microbatch a data shard)."""
    got = runs["mesh"]["2x1"][0][arch]
    cfg = _cfg(arch)
    want = _run_lm(cfg, None, 2, 8, seed=2, decode=False, step=False)
    _close_logits(got["logits"], want["logits"])
    want.update(_one_rank_step(cfg, 2, 8, 2, _n_micro(cfg, "2x1", 2, 8)))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got["step"][k], want["step"][k], rtol=RTOL)
    _close_trees(got["params"], want["params"], PARAM_ATOL, arch)


def test_a_1x1_process_mesh_is_bitwise_no_mesh(tmp_path):
    """One process, a 1x1 process mesh: forward, a ZeRO step and decode
    bitwise equal to ``mesh=None`` (and ZeRO bitwise no ZeRO)."""
    got = run_ranks(_one_process, 1, store_dir=str(tmp_path),
                    timeout_s=PG_TIMEOUT_S, join_timeout_s=120)[0]
    for arch in ("qwen2_1_5b", "deepseek_v3_671b"):
        want = _run_lm(_cfg(arch), None, 2, 8, seed=7)
        for k in ("logits", "tokens"):
            np.testing.assert_array_equal(got[arch][k], want[k])
        assert got[arch]["step"] == want["step"]
        for a, b in zip(tree_leaves(got[arch]["params"]),
                        tree_leaves(want["params"])):
            np.testing.assert_array_equal(a, b)
        assert got[arch]["no_zero"] == want["step"]


def _one_process(rank):
    mesh = make_process_mesh((1, 1), ("data", "model"), device="cpu")
    out = {}
    for arch in ("qwen2_1_5b", "deepseek_v3_671b"):
        cfg = _cfg(arch)
        out[arch] = _run_lm(cfg, mesh, 2, 8, seed=7)
        params = _init(cfg, mesh)
        opt = make_optimizer(OptConfig(lr=LR, eps=EPS))
        _, _, met = make_train_step(cfg, opt, mesh=mesh)(
            params, opt.init(params), _batch(cfg, 2, 8, 7))
        out[arch]["no_zero"] = {k: float(v) for k, v in met.items()}
    return out


def test_an_in_process_mesh_of_several_ranks_is_refused():
    cfg = _cfg("qwen2_1_5b")
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="process mesh"):
        T.forward(_init(cfg), torch.zeros((2, 4), dtype=torch.int32), cfg,
                  mesh=mesh)


def test_embed_lookup_and_cut_cross_entropy(runs):
    """The vocabulary cut over model, the batch over data: the rows, the
    loss and both gradients against the one-rank functions."""
    got = runs["mesh"]["2x2"][0]["lookup"]
    rng = np.random.RandomState(5)
    v, d = 64, 8
    emb = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    tok = torch.from_numpy(rng.randint(0, v, (4, 6)))
    logits = torch.from_numpy(rng.standard_normal((4, 6, v))
                              .astype(np.float32))
    valid = torch.from_numpy(rng.rand(4, 6) > 0.3)
    emb.requires_grad_()
    logits.requires_grad_()
    rows = embed_lookup(tok, emb)
    ce = cross_entropy_logits_sharded(logits, tok, valid_mask=valid)
    (rows.square().sum() + ce).backward()
    np.testing.assert_array_equal(got["rows"], rows.detach().numpy())
    np.testing.assert_allclose(got["ce"], float(ce.detach()), rtol=1e-6)
    np.testing.assert_allclose(got["g_emb"], emb.grad.numpy(), rtol=1e-6)
    np.testing.assert_allclose(got["g_logits"], logits.grad.numpy(),
                               rtol=1e-5, atol=1e-8)


def test_a_batch_the_data_axes_do_not_divide_stays_whole(runs):
    """B = 1 on 2x2, whole on every rank (the JAX package replicates such
    a batch over the data axes): DeepSeek-V3's logits and greedy tokens
    against one rank; every rank holds the same."""
    ranks = runs["mesh"]["2x2"]
    _ranks_agree(ranks, "replicated")
    got, want = ranks[0]["replicated"], _replicated_batch()
    _close_logits(got["logits"], want["logits"])
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_init_and_carry_over_give_the_one_card_shards(runs):
    """On every rank of 2x2: ``model_init(mesh=)`` and
    ``params_from_numpy(mesh=)`` equal the one-card init cut by
    ``model_param_specs(cfg, mesh)``, leaf for leaf, bitwise."""
    for r, got in enumerate(runs["mesh"]["2x2"]):
        assert all(got["init"].values()), (r, got["init"])


@pytest.mark.parametrize("where", ["2x1", "1x1"])
def test_checkpoint_saved_on_2x2_restores_on_another_mesh(runs, where):
    """A checkpoint saved on 2x2 (the ZeRO state included), restored on
    2x1 and on one rank: the next step's loss and parameters within
    tolerance of 2x2's own."""
    want = runs["mesh"]["2x2"][0]["ckpt"]
    got = (runs["restored"][0] if where == "2x1"
           else _ckpt_continue(None, runs["work"]))
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
    _close_trees(got["params"], want["params"], PARAM_ATOL, where)


def test_launch_train_runs_on_a_2x2_mesh(runs):
    rc, out, err = runs["launch"]
    assert rc == 0, err
    assert "mesh=2x2" in out and "done: 2 steps" in out, out


def _close_leaf(got, want, tol, what):
    if want is None:
        assert got is None, what
        return
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)) + 1e-30, (what, err)


@pytest.mark.parametrize("case", [c[0] for c in SP_CASES])
def test_sequence_parallel_matches_the_mesh_without_it(runs, case):
    """2x2 with ``sequence_parallel``: each rank's logits, loss and every
    gradient leaf against the same mesh without the flag."""
    for r, rank in enumerate(runs["mesh"]["2x2"]):
        off, on = rank["sp"][case][False], rank["sp"][case][True]
        _close_leaf(on["logits"], off["logits"], SP_TOL, f"rank {r} logits")
        np.testing.assert_allclose(on["loss"], off["loss"], rtol=SP_LOSS_RTOL)
        assert len(on["grads"]) == len(off["grads"])
        for i, (g, w) in enumerate(zip(on["grads"], off["grads"])):
            _close_leaf(g, w, SP_TOL, f"rank {r} gradient leaf {i}")


@pytest.mark.parametrize("case", SP_JAX)
def test_sequence_parallel_matches_jax_on_2x2(runs, case):
    """The port's 2x2 logits with ``sequence_parallel`` against the JAX
    package's forward with it (GSPMD's residual constraint) on a 2x2 mesh
    of host devices, from the same weights and tokens."""
    got = runs["mesh"]["2x2"][0]["sp"][case][True]["logits"]
    z = np.load(os.path.join(runs["work"], f"sp_{case}_out.npz"))
    if case == "mamba":
        _close_logits(got, z["logits"], JAMBA_SP_REL)
    else:
        np.testing.assert_allclose(got, z["logits"], rtol=JAX_RTOL,
                                   atol=JAX_ATOL)


def test_sequence_parallel_off_where_model_does_not_divide_the_sequence(
        runs):
    """15 rows on 2 model ranks: the flag changes nothing, bitwise."""
    for rank in runs["mesh"]["2x2"]:
        off, on = rank["sp"]["odd"][False], rank["sp"]["odd"][True]
        np.testing.assert_array_equal(on["logits"], off["logits"])
        assert on["loss"] == off["loss"]
        for g, w in zip(on["grads"], off["grads"]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", SP_SERVE)
def test_sequence_parallel_leaves_prefill_and_decode_bitwise(runs, arch):
    """Prefill (whose caches hold every row) and decode with a cache run
    as without the flag: tokens and every cache leaf bitwise, each rank."""
    for rank in runs["mesh"]["2x2"]:
        off, on = (rank["sp"]["serve"][arch][f] for f in (False, True))
        np.testing.assert_array_equal(on["tokens"], off["tokens"])
        assert len(on["cache"]) == len(off["cache"])
        for a, b in zip(on["cache"], off["cache"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", [c[0] for c in JAX_RUNS])
def test_train_step_matches_jax_on_2x2(runs, case):
    """The port's 2x2 step against the JAX package's 2x2 step (jitted,
    GSPMD and its MoE shard_map island) on the same weights and batch:
    loss, gradient norm and every parameter after the step."""
    got = runs["mesh"]["2x2"][0]["jax"][case]
    z = np.load(os.path.join(runs["work"], f"{case}_out.npz"))
    np.testing.assert_allclose(got["step"]["loss"], z["loss"], rtol=JAX_RTOL)
    np.testing.assert_allclose(got["step"]["grad_norm"], z["grad_norm"],
                               rtol=JAX_RTOL)
    for i, leaf in enumerate(tree_leaves(got["params"])):
        np.testing.assert_allclose(leaf, z[f"p{i}"], rtol=0,
                                   atol=JAX_PARAM_ATOL, err_msg=f"leaf {i}")


def test_jax_partial_path_counts_shared_experts_per_data_shard(runs):
    """The reference's fault the port departs from: on 2x2 the JAX
    package's partial path adds DeepSeek's shared experts once a data
    shard, so its logits leave its own 1x1 ones, which equal the port's
    one rank; the port's 2x2 partial path equals its one rank
    (``test_forward_and_decode_match_one_rank[deepseek_partial]``)."""
    z = np.load(os.path.join(runs["work"], "shared_out.npz"))
    cfg = _cfg("deepseek_v3_671b")
    with torch.no_grad():
        want = T.forward(_init(cfg), _batch(cfg, 2, 8, 6)["inputs"], cfg)[0]
    np.testing.assert_allclose(z["m1"], want.numpy(), rtol=JAX_RTOL,
                               atol=JAX_ATOL)
    assert np.max(np.abs(z["m4"] - z["m1"])) > 0.1


def test_zero_on_fsdp_experts_is_refused_as_jax_refuses_it(runs):
    """AdamW with ZeRO on DeepSeek-V3's moe_fsdp experts: the reference's
    rule names 'data' twice; JAX raises DuplicateSpecError, the port's
    shardings_for ValueError.  The port's train step leaves those leaves
    without a ZeRO dim (``optimizer``'s docstring)."""
    assert runs["jax"]["zero"] == "DuplicateSpecError"
    mesh = make_mesh((2, 2), ("data", "model"), device="meta")
    cfg = _cfg("deepseek_v3_671b")
    with pytest.raises(ValueError, match="names a mesh axis twice"):
        shardings_for(cfg, mesh, _opt())
