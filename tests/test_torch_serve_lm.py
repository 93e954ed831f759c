"""The port's LM serving path (prefill_step, decode_step) against the JAX
package's, in f32 on the CPU, with the JAX package's parameters carried
over by ``params_from_numpy``: reduced Qwen2-1.5B (GQA), DeepSeek-V3
(MLA latent caches, sigmoid MoE), Qwen3-MoE (softmax MoE), Jamba (Mamba
conv and SSM states beside a KV cache, MoE) and RWKV-6 (shift and WKV
states).

Greedy tokens must be equal; logits and caches are held at 1e-4 of their
largest magnitude (f32 sums in another order, over the reduced models'
four to eight layers; the model-level tests in test_torch_models.py
explain the tolerance).  Within the port, prefill-then-decode equals the
teacher-forced forward at 1e-5.  Reduced Jamba is the exception: the JAX
package's init rule draws its one-layer stacks at std 1, and one f32 ulp
on the reference's own input embeddings moves its logits by ~2e-4 and
its last SSM state after 8 decode steps by ~6e-3 of their largest
magnitudes.  The port's own rounding is ~1e-6 of a layer's output
(test_torch_models.py, ``test_forward_layer_by_layer``), 8 to 16 such
ulps.  So its leaves are held at 32 times the largest change that one
ulp makes to a leaf of the same kind in the reference (measured by the
fixture: observed ratios up to 15), and within the port at 3e-3.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.compat import set_mesh

from repro.configs import base as jbase
from repro.launch.mesh import make_mesh
from repro.models import transformer as JT
from repro.serve import engine as jengine
from repro.serve.prefill import prefill_step as jprefill
from repro_torch.configs import base as tbase
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.serve import engine
from repro_torch.serve.prefill import prefill_step

from torch_threads import one_thread  # noqa: F401

REL = 1e-4
SELF_REL = 1e-5
ULP_FACTOR = 32
JAMBA_SELF_REL = 3e-3
B, PROMPT, STEPS, MAX_LEN = 2, 12, 8, 24
ARCHS = ["qwen2_1_5b", "deepseek_v3_671b", "qwen3_moe_30b_a3b",
         "jamba_v0_1_52b", "rwkv6_1_6b"]


def _tree_close(out, ref, tol):
    TC.tree_map(_close, out, ref, tol)


def _close(out, ref, rel=REL):
    out = out.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max()) or 1.0
    err = float(np.abs(out - ref).max()) / scale
    assert err <= rel, f"max error / max|ref| = {err:.3e} > {rel:g}"


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return request.param


def _reference(cfg, mesh, params, prompts):
    """The JAX package's prefill and STEPS greedy decode steps; logits of
    every step from the same forward that decode_step runs."""
    with set_mesh(mesh):
        tok, pcache, cur = jax.jit(
            lambda p, x: jprefill(p, x, cfg, mesh))(params, prompts)
        target = JT.cache_shapes(cfg, B, MAX_LEN)
        padded = jax.tree_util.tree_map(
            lambda x, t: jnp.pad(x, [(0, ts - xs) for xs, ts in
                                     zip(x.shape, t.shape)]).astype(t.dtype),
            pcache, target)
        state = {"cache": padded, "cur_len": cur}
        step = jax.jit(lambda p, s, t: jengine.decode_step(p, s, t, cfg, mesh))
        logits_fn = jax.jit(lambda p, s, t: JT.forward(
            p, t, cfg, mesh, cache=s["cache"], cur_len=s["cur_len"])[0])
        tokens, logits = [np.asarray(tok)], []
        for _ in range(STEPS):
            logits.append(np.asarray(logits_fn(params, state, tok)))
            tok, state = step(params, state, tok)
            tokens.append(np.asarray(tok))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(tokens=tokens, logits=logits, prefill_cache=to_np(pcache),
                padded_cache=to_np(padded), cache=to_np(state["cache"]),
                cur_len=int(state["cur_len"]))


def _rel_diff(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / (float(np.abs(a).max()) or 1.0)


@pytest.fixture(scope="module")
def jax_run(arch):
    """The JAX package's run, and a tolerance for each compared leaf:
    REL, or for reduced Jamba ULP_FACTOR times the largest change that
    one f32 ulp on the JAX package's own input embeddings makes to a leaf
    of the same kind (prefill caches, logits, decode caches): the
    reference's own sensitivity."""
    cfg = jbase.reduced_config(jbase.get_config(arch))
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
    params = JT.model_init(cfg, jax.random.PRNGKey(0))
    prompts = np.random.RandomState(7).randint(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    run = _reference(cfg, mesh, params, prompts)
    keys = ("prefill_cache", "logits", "cache")
    if arch == "jamba_v0_1_52b":
        embed = np.nextafter(np.asarray(params["embed"]), np.float32(np.inf))
        moved = _reference(cfg, mesh, dict(params, embed=jnp.asarray(embed)),
                           prompts)
        assert all(np.array_equal(a, b)
                   for a, b in zip(moved["tokens"], run["tokens"]))
        sens = {k: max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            _rel_diff, run[k], moved[k]))) for k in keys}
    else:
        sens = {k: 0.0 for k in keys}
    tol = {k: jax.tree_util.tree_map(
        lambda _: max(REL, ULP_FACTOR * sens[k]), run[k]) for k in keys}
    run.update(params=jax.tree_util.tree_map(np.asarray, params),
               prompts=prompts, tol=tol)
    return run


@pytest.fixture(scope="module")
def port(arch):
    cfg = tbase.reduced_config(tbase.get_config(arch))
    return cfg


def test_prefill_and_greedy_decode_match_the_jax_package(jax_run, port):
    cfg = port
    params = params_from_numpy(jax_run["params"], cfg, device="cpu")
    tok, pcache, cur = prefill_step(params, torch.from_numpy(
        jax_run["prompts"]), cfg)
    assert cur.dtype == torch.int32 and cur.tolist() == [PROMPT]
    ref_pcache = cache_from_numpy(jax_run["prefill_cache"], cfg, device="cpu")
    _tree_close(pcache, ref_pcache, jax_run["tol"]["prefill_cache"])
    state = {"cache": engine.pad_cache(pcache, cfg, B, MAX_LEN), "cur_len": cur}
    tokens = [tok]
    for _ in range(STEPS):
        tok, state = engine.decode_step(params, state, tok, cfg)
        tokens.append(tok)
    got = np.concatenate([t.numpy() for t in tokens], axis=1)
    want = np.concatenate(jax_run["tokens"], axis=1)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert state["cur_len"].tolist() == [jax_run["cur_len"]]
    _tree_close(state["cache"], cache_from_numpy(jax_run["cache"], cfg,
                                                 device="cpu"),
                jax_run["tol"]["cache"])


def test_decode_logits_match_the_jax_package(jax_run, port):
    """Teacher-forced by the JAX package's tokens, every decode step's
    logits within REL."""
    cfg = port
    params = params_from_numpy(jax_run["params"], cfg, device="cpu")
    cache = engine.pad_cache(cache_from_numpy(jax_run["prefill_cache"], cfg,
                                              device="cpu"), cfg, B, MAX_LEN)
    for i in range(STEPS):
        cur = torch.tensor([PROMPT + i], dtype=torch.int32)
        logits, _, _, cache = TT.forward(
            params, torch.tensor(jax_run["tokens"][i]), cfg,
            cache=cache, cur_len=cur)
        _close(logits, jax_run["logits"][i], jax_run["tol"]["logits"][i])


def test_prefill_then_decode_equals_teacher_forced_forward(port):
    cfg = port
    params = TT.model_init(cfg, torch.Generator().manual_seed(1), device="cpu")
    seq = torch.randint(0, cfg.vocab_size, (B, PROMPT + STEPS),
                        generator=torch.Generator().manual_seed(2),
                        dtype=torch.int32)
    full, *_ = TT.forward(params, seq, cfg)
    tok, pcache, cur = prefill_step(params, seq[:, :PROMPT], cfg)
    assert torch.equal(tok[:, 0], full[:, PROMPT - 1].argmax(-1).int())
    cache = engine.pad_cache(pcache, cfg, B, MAX_LEN)
    for i in range(PROMPT, PROMPT + STEPS - 1):
        logits, _, _, cache = TT.forward(params, seq[:, i:i + 1], cfg,
                                         cache=cache, cur_len=cur)
        _close(logits[:, 0], full[:, i].numpy(),
               rel=JAMBA_SELF_REL if cfg.name.startswith("jamba") else SELF_REL)
        cur = cur + 1


def test_pad_cache_keeps_the_prefill_rows(jax_run, port):
    """pad_cache is the JAX example's jnp.pad of the prefill cache: an
    attention or MLA cache keeps the prompt's rows, then zeros up to
    max_len; a Mamba or RWKV state is copied whole; on the prefill cache's
    device and in its dtype.  It equals the JAX package's padded cache
    carried over by cache_from_numpy."""
    cfg = port
    pcache = cache_from_numpy(jax_run["prefill_cache"], cfg, device="cpu")
    full = engine.pad_cache(pcache, cfg, B, MAX_LEN)
    want = TT.cache_shapes(cfg, B, MAX_LEN)
    kinds = [mix for _, period in TT.segment_plan(cfg) for mix, _ in period]
    n_states = 0
    for seg_f, seg_p, seg_w, (_, period) in zip(full, pcache, want,
                                                TT.segment_plan(cfg)):
        for lf, lp, lw, (mix, _) in zip(seg_f, seg_p, seg_w, period):
            for f, p, shape in zip(lf, lp, lw):
                assert tuple(f.shape) == tuple(shape.shape)
                assert f.dtype == p.dtype == shape.dtype
                assert f.device == p.device
                if mix in ("attention", "mla"):
                    assert torch.equal(f[:, :, :PROMPT], p)
                    assert not f[:, :, PROMPT:].any()
                else:
                    assert torch.equal(f, p) and f.any()
                    n_states += 1
    assert n_states == sum(2 + (m == "rwkv6") for m in kinds
                           if m in ("mamba", "rwkv6"))
    carried = cache_from_numpy(jax_run["padded_cache"], cfg, device="cpu")
    TC.tree_map(lambda a, b: _close(a, b, 0.0), full, carried)


def test_serving_entry_points_default_to_cuda(port):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the defaults are valid")
    cfg = port
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.model_init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.cache_init(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.init_serve_state(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({}, cfg)
    state = engine.init_serve_state(cfg, 1, 8, device="cpu")
    assert state["cur_len"].tolist() == [0]
    assert state["cur_len"].device.type == "cpu"


def test_decode_step_keeps_cur_len_on_the_device(port, monkeypatch):
    """A decode step never reads a value back to the host, and writes
    every cache (KV, latents, Mamba and RWKV states) in place."""
    cfg = port
    params = TT.model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = engine.init_serve_state(cfg, B, MAX_LEN, device="cpu")
    leaves = TC.tree_leaves(state["cache"])
    ptrs = [t.data_ptr() for t in leaves]

    def refuse(*_a, **_k):
        raise AssertionError("decode_step synchronised with the host")

    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    monkeypatch.setattr(torch.Tensor, "cpu", refuse)
    monkeypatch.setattr(torch.Tensor, "numpy", refuse)
    monkeypatch.setattr(torch.Tensor, "__bool__", refuse)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    for _ in range(3):
        tok, state = engine.decode_step(params, state, tok, cfg)
    monkeypatch.undo()
    assert state["cur_len"].tolist() == [3]
    new = TC.tree_leaves(state["cache"])
    assert [t.data_ptr() for t in new] == ptrs
    assert all(a is b for a, b in zip(new, leaves))
    assert all(t.any() for t in new)        # each was written


@pytest.mark.parametrize("arch_name", jbase.ARCHS)
def test_serve_example_runs_every_arch(arch_name, capsys):
    """The example serves every architecture of the registry (token and
    embedding inputs) on its reduced config."""
    from repro_torch.examples import serve_decode

    serve_decode.main(["--arch", arch_name, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK")
    assert f"arch={tbase.get_config(arch_name).name} on cpu" in out
