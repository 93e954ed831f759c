"""The port's training losses and their gradients against the JAX
package's, for every architecture at ``reduced_config`` in f32 on the
CPU: the same parameters (drawn by the JAX package, carried over with
``params_from_numpy``) and the same batch (``train.data.make_batch``)
through ``repro.models.transformer.lm_loss`` under
``jax.value_and_grad`` and through ``repro_torch``'s ``lm_loss`` under
autograd.  The MoE layer's backward, the rematerialisation policies and
the cross-entropy are held here too.

Tolerances: the loss and each metric (nll, MoE aux, MTP) within
LOSS_REL of the reference's (observed <= 2.2e-7, Jamba 3.7e-6); each
gradient leaf within GRAD_REL of the largest magnitude of the
reference's leaf (observed <= 1.44e-4, qwen2's ``bv``): f32 sums of the
same products in other orders.

Reduced Jamba under the JAX package's init rule is ill-conditioned
(ROADMAP Queue C; ``test_torch_models.py`` holds its forward at 3e-3):
one f32 ulp on the reference's embedding table moves the reference's own
gradients by up to 3.4e-2 of a leaf's largest magnitude
(``test_gradients_match_the_jax_package`` measures it every run).  So
its gradients are held at JAMBA_GRAD_REL, about 15 times that (observed
0.218, ``dt_proj`` of its sixth layer), and the same model with its
stacked matrices drawn at their per-layer std (well conditioned: the
ulp moves its gradients by 1.8e-5) is held at GRAD_REL (observed
1.85e-5).

Remat: inside the port every policy gives ``none``'s loss and gradients
bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
from repro.compat import set_mesh

from repro.configs import base as jbase
from repro.launch.mesh import make_mesh
from repro.models import common as JC
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.train.data import make_batch
from repro_torch.configs import base as tbase
from repro_torch.models import common as TC
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.train_step import _grads_of

from torch_threads import one_thread  # noqa: F401

LOSS_REL = 1e-5
GRAD_REL = 5e-4
JAMBA_GRAD_REL = 0.5
B, S = 2, 16


def _rel(out, ref) -> float:
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    scale = float(np.abs(ref).max()) or 1.0
    return float(np.abs(out - ref).max()) / scale


def _batch(cfg):
    return make_batch(0, global_batch=B, seq_len=S, vocab=cfg.vocab_size,
                      input_mode=cfg.input_mode, d_model=cfg.d_model)


def _per_layer(params):
    """The JAX package's parameters with every stacked matrix rescaled to
    the std of its own layer's fan-in (the reference's rule divides by
    the layer count): reduced Jamba's well-conditioned twin."""
    def fix(path, a):
        a = np.asarray(a)
        if "segments" in jax.tree_util.keystr(path) and a.ndim >= 3:
            return (a * np.sqrt(a.shape[0] / a.shape[1])).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(fix, params)


CASES = [(arch, "jax_init") for arch in jbase.ARCHS] + [
    ("jamba_v0_1_52b", "per_layer")]


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1, 1), ("pod", "data", "model"))


@pytest.fixture(scope="module")
def jitted():
    """One jitted value-and-grad per architecture (Jamba's two cases share
    its compile)."""
    return {}


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def reference(request, mesh, jitted):
    """The JAX package's loss, metrics and gradients (numpy), once per
    case, and the parameters and batch they came from.  For Jamba at the
    reference's init, also the reference's gradients with its embedding
    table one ulp up: its own sensitivity."""
    arch, init = request.param
    cfg = jbase.reduced_config(jbase.get_config(arch))
    params = jax.tree_util.tree_map(
        np.asarray, JT.model_init(cfg, jax.random.PRNGKey(0)))
    if init == "per_layer":
        params = _per_layer(params)
    batch = _batch(cfg)
    if arch not in jitted:
        jitted[arch] = jax.jit(jax.value_and_grad(
            lambda p, b: JT.lm_loss(p, b, cfg, mesh), has_aux=True))
    vg = jitted[arch]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with set_mesh(mesh):
        (loss, metrics), grads = vg(params, jb)
        moved = None
        if arch == "jamba_v0_1_52b" and init == "jax_init":
            up = dict(params, embed=np.nextafter(params["embed"],
                                                 np.float32(np.inf)))
            moved = jax.tree_util.tree_leaves(vg(up, jb)[1])
    return {
        "arch": arch, "init": init, "params": params, "batch": batch,
        "loss": float(loss),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": jax.tree_util.tree_flatten_with_path(grads)[0],
        "moved": moved,
    }


@pytest.fixture(scope="module")
def port(reference):
    cfg = tbase.reduced_config(tbase.get_config(reference["arch"]))
    params = params_from_numpy(reference["params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in reference["batch"].items()}
    loss, metrics, grads = _grads_of(params, batch, cfg)
    return cfg, float(loss), {k: float(v) for k, v in metrics.items()}, grads


def test_loss_and_metrics_match_the_jax_package(reference, port):
    cfg, loss, metrics, _ = port
    assert set(metrics) == set(reference["metrics"])
    assert ("mtp" in metrics) == cfg.mtp
    assert loss == pytest.approx(reference["loss"], rel=LOSS_REL)
    for k, v in reference["metrics"].items():
        assert metrics[k] == pytest.approx(v, rel=LOSS_REL, abs=1e-7), k
    if not cfg.moe:
        assert metrics["aux"] == 0.0


def test_gradients_match_the_jax_package(reference, port):
    _, _, _, grads = port
    tleaves = TC.tree_leaves(grads)
    assert len(tleaves) == len(reference["grads"])
    errs = {}
    for (path, ref), g in zip(reference["grads"], tleaves):
        assert tuple(g.shape) == ref.shape and g.dtype == torch.float32
        errs[jax.tree_util.keystr(path)] = _rel(g.numpy(), ref)
    tol = GRAD_REL
    if reference["moved"] is not None:
        # the reference's own sensitivity to one ulp on its embeddings
        ulp = max(_rel(m, ref) for m, (_, ref) in
                  zip(reference["moved"], reference["grads"]))
        assert ulp > GRAD_REL and JAMBA_GRAD_REL >= 10 * ulp, ulp
        tol = JAMBA_GRAD_REL
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, f"{worst}: {errs[worst]:.3e} > {tol:g}"


# ---------------------------------------------------------------------------
# rematerialisation
# ---------------------------------------------------------------------------


def _loss_and_grads(arch, remat, **kw):
    cfg = dataclasses.replace(
        tbase.reduced_config(tbase.get_config(arch), **kw), remat=remat)
    params = TT.model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss, metrics, grads = _grads_of(params, batch, cfg)
    return loss, metrics, TC.tree_leaves(grads)


@pytest.mark.parametrize("remat", ["full", "dots", "save_moe"])
@pytest.mark.parametrize("arch", jbase.ARCHS)
def test_remat_is_bitwise_none(arch, remat):
    loss, metrics, grads = _loss_and_grads(arch, remat)
    ref_loss, ref_metrics, ref_grads = _loss_and_grads(arch, "none")
    assert torch.equal(loss, ref_loss)
    assert all(torch.equal(metrics[k], ref_metrics[k]) for k in ref_metrics)
    assert all(torch.equal(g, r) for g, r in zip(grads, ref_grads))


class _Count(TorchDispatchMode):
    """Counts, per op kind, the operations dispatched while active:
    products with no batch dimension, batched products, and the MoE
    output's name."""

    def __init__(self):
        super().__init__()
        self.n = {"dots": 0, "batched": 0, "moe_out": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n["dots"] += 1
        elif func is torch.ops.aten.bmm.default:
            self.n["dots" if args[0].shape[0] == 1 else "batched"] += 1
        elif func is torch.ops.repro_torch.moe_out.default:
            self.n["moe_out"] += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_recompute_what_they_say():
    """What each policy's backward recomputes, read off the products it
    dispatches: ``full`` and ``save_moe`` every projection, ``dots``
    none of them (saved) but the batched products (attention scores,
    the experts), and ``save_moe`` never the MoE output's name, which
    its forward gives once a MoE layer."""
    counts = {}
    for remat in ("none", "full", "dots", "save_moe"):
        cfg = dataclasses.replace(
            tbase.reduced_config(tbase.get_config("qwen3_moe_30b_a3b")),
            remat=remat)
        params = TT.model_init(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        leaves = [p.requires_grad_() for p in TC.tree_leaves(params)]
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
        with _Count() as fwd:
            loss, _ = TT.lm_loss(params, batch, cfg)
        with _Count() as bwd:
            torch.autograd.grad(loss, leaves)
        counts[remat] = (fwd.n, bwd.n)
    none, full, dots, save_moe = (counts[k][1] for k in
                                  ("none", "full", "dots", "save_moe"))
    assert full["dots"] == save_moe["dots"] > dots["dots"] == none["dots"]
    assert full["batched"] == dots["batched"] == save_moe["batched"] \
        > none["batched"]
    assert counts["save_moe"][0]["moe_out"] == cfg.num_layers
    assert save_moe["moe_out"] == 0
    assert counts["full"][0]["moe_out"] == 0


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat"):
        _loss_and_grads("qwen2_1_5b", "offload")


# ---------------------------------------------------------------------------
# the MoE layer's backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["densified", "blocked"])
def test_moe_backward_matches_the_jax_package(path, mesh):
    """jax.grad of the reference's ``moe_apply`` (a weighted sum of its
    output plus the aux loss) against autograd of the port's, for every
    parameter and the input, at capacity 64 (tokens dropped; one block
    of 64 for the blocked path)."""
    kw = {"capacity_factor": 0.5}
    jcfg = jbase.reduced_config(jbase.get_config("deepseek_v3_671b"), **kw)
    tcfg = tbase.reduced_config(tbase.get_config("deepseek_v3_671b"), **kw)
    rng = np.random.RandomState(5)
    tree = jax.tree_util.tree_map(
        lambda d: (rng.randn(*d.shape) * 0.3).astype(np.float32),
        JM.moe_defs(jcfg), is_leaf=lambda x: isinstance(x, JC.ParamDef))
    x = rng.randn(2, 256, jcfg.d_model).astype(np.float32)
    w = rng.randn(2, 256, jcfg.d_model).astype(np.float32)

    def jloss(p, v):
        out, aux = JM.moe_apply(p, v, jcfg, mesh=mesh, local_path=path)
        return jnp.sum(out * w) + aux

    with set_mesh(mesh):
        jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(tree, x)
    params = TC.tree_map(lambda a: torch.from_numpy(a).requires_grad_(), tree)
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = TM.moe_apply(params, xt, tcfg, local_path=path)
    leaves = TC.tree_leaves(params)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux,
                                leaves + [xt])
    refs = jax.tree_util.tree_leaves(jg[0]) + [jg[1]]
    for g, ref in zip(grads, refs):
        assert _rel(g.numpy(), ref) <= GRAD_REL


@pytest.mark.parametrize("path", ["densified", "blocked"])
def test_moe_training_path_gives_the_serving_output_bitwise(path):
    """With a grad-requiring input the layer computes without ``out=``
    (which autograd refuses); its output and aux loss are bitwise those
    of the serving path, which writes the experts' products into the
    capacity buffer with ``out=`` as before."""
    cfg = tbase.reduced_config(tbase.get_config("qwen3_moe_30b_a3b"),
                               capacity_factor=0.5)
    rng = np.random.RandomState(6)
    params = TC.tree_map(
        lambda d: torch.from_numpy((rng.randn(*d.shape) * 0.3).astype(
            np.float32)), TM.moe_defs(cfg),
        is_leaf=lambda x: isinstance(x, TC.ParamDef))
    x = torch.from_numpy(rng.randn(2, 256, cfg.d_model).astype(np.float32))
    with torch.no_grad():
        serve, serve_aux = TM.moe_apply(params, x, cfg, local_path=path)
    train, train_aux = TM.moe_apply(params, x.clone().requires_grad_(), cfg,
                                    local_path=path)
    assert train.requires_grad and not serve.requires_grad
    assert torch.equal(train.detach(), serve)
    assert torch.equal(train_aux.detach(), serve_aux)


# ---------------------------------------------------------------------------
# the cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mask", ["none", "last_invalid", "all_invalid"])
def test_cross_entropy_matches_the_jax_package(mask):
    rng = np.random.RandomState(3)
    logits = (rng.randn(3, 7, 50) * 4).astype(np.float32)
    labels = rng.randint(0, 50, (3, 7)).astype(np.int32)
    valid = {"none": None,
             "last_invalid": np.arange(7)[None].repeat(3, 0) < 6,
             "all_invalid": np.zeros((3, 7), bool)}[mask]
    # bf16 logits: both upcast to f32 before the logsumexp
    out = TC.cross_entropy_logits_sharded(
        torch.from_numpy(logits).to(torch.bfloat16), torch.from_numpy(labels),
        valid_mask=None if valid is None else torch.from_numpy(valid))
    ref = JC.cross_entropy_logits_sharded(
        jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(labels),
        valid_mask=None if valid is None else jnp.asarray(valid))
    assert out.dtype == torch.float32
    assert float(out) == pytest.approx(float(ref), rel=1e-6, abs=1e-7)
