"""The port's LM serving path (prefill_step, decode_step) against the JAX
package's, on reduced Qwen2-1.5B in f32 on the CPU, with the JAX
package's parameters carried over by ``params_from_numpy``.

Greedy tokens must be equal; logits and caches are held at 1e-4 of their
largest magnitude (f32 sums in another order, over the reduced model's
four layers; the model-level tests in test_torch_models.py explain the
tolerance).  Within the port, prefill-then-decode equals the
teacher-forced forward at 1e-5.
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

REL = 1e-4
B, PROMPT, STEPS, MAX_LEN = 2, 12, 8, 24


def _close(out, ref, rel=REL):
    out = out.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max()) or 1.0
    err = float(np.abs(out - ref).max()) / scale
    assert err <= rel, f"max error / max|ref| = {err:.3e} > {rel:g}"


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's prefill and STEPS greedy decode steps; logits of
    every step from the same forward that decode_step runs."""
    cfg = jbase.reduced_config(jbase.get_config("qwen2_1_5b"))
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
    params = JT.model_init(cfg, jax.random.PRNGKey(0))
    prompts = np.random.RandomState(7).randint(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    with set_mesh(mesh):
        tok, pcache, cur = jax.jit(
            lambda p, x: jprefill(p, x, cfg, mesh))(params, prompts)
        target = JT.cache_shapes(cfg, B, MAX_LEN)
        cache = jax.tree_util.tree_map(
            lambda x, t: jnp.pad(x, [(0, ts - xs) for xs, ts in
                                     zip(x.shape, t.shape)]).astype(t.dtype),
            pcache, target)
        state = {"cache": cache, "cur_len": cur}
        step = jax.jit(lambda p, s, t: jengine.decode_step(p, s, t, cfg, mesh))
        logits_fn = jax.jit(lambda p, s, t: JT.forward(
            p, t, cfg, mesh, cache=s["cache"], cur_len=s["cur_len"])[0])
        tokens, logits = [np.asarray(tok)], []
        for _ in range(STEPS):
            logits.append(np.asarray(logits_fn(params, state, tok)))
            tok, state = step(params, state, tok)
            tokens.append(np.asarray(tok))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(params=to_np(params), prompts=prompts, tokens=tokens,
                logits=logits, prefill_cache=to_np(pcache),
                cache=to_np(state["cache"]), cur_len=int(state["cur_len"]))


@pytest.fixture(scope="module")
def port():
    cfg = tbase.reduced_config(tbase.get_config("qwen2_1_5b"))
    return cfg


def test_prefill_and_greedy_decode_match_the_jax_package(jax_run, port):
    cfg = port
    params = params_from_numpy(jax_run["params"], cfg, device="cpu")
    tok, pcache, cur = prefill_step(params, torch.from_numpy(
        jax_run["prompts"]), cfg)
    assert cur.dtype == torch.int32 and cur.tolist() == [PROMPT]
    ref_pcache = cache_from_numpy(jax_run["prefill_cache"], cfg, device="cpu")
    TC.tree_map(_close, pcache, ref_pcache)
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
    TC.tree_map(_close, state["cache"],
                cache_from_numpy(jax_run["cache"], cfg, device="cpu"))


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
        _close(logits, jax_run["logits"][i])


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
        _close(logits[:, 0], full[:, i].numpy(), rel=1e-5)
        cur = cur + 1


def test_pad_cache_keeps_the_prefill_rows(jax_run, port):
    """pad_cache is the JAX example's jnp.pad of the prefill cache: the
    prompt's rows, then zeros up to max_len, on the prefill cache's device
    and in its dtype."""
    cfg = port
    pcache = cache_from_numpy(jax_run["prefill_cache"], cfg, device="cpu")
    full = engine.pad_cache(pcache, cfg, B, MAX_LEN)
    want = TT.cache_shapes(cfg, B, MAX_LEN)
    for f, p, shape in zip(TC.tree_leaves(full), TC.tree_leaves(pcache),
                           TC.tree_leaves(want)):
        assert tuple(f.shape) == tuple(shape.shape)
        assert f.dtype == p.dtype and f.device == p.device
        assert torch.equal(f[:, :, :PROMPT], p)
        assert not f[:, :, PROMPT:].any()


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
    """A decode step never reads cur_len back to the host."""
    cfg = port
    params = TT.model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = engine.init_serve_state(cfg, B, MAX_LEN, device="cpu")

    def refuse(*_a, **_k):
        raise AssertionError("decode_step synchronised with the host")

    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    for _ in range(3):
        tok, state = engine.decode_step(params, state, tok, cfg)
    monkeypatch.undo()
    assert state["cur_len"].tolist() == [3]
