"""Serving example: prefill a batch of prompts, pad the prefill caches
into a ``max_len`` decode cache, then decode tokens greedily — the
port's counterpart of ``examples/serve_decode.py``.

Works for every architecture of the registry: attention KV caches, MLA
latent caches, Mamba conv and SSM states, RWKV shift and WKV states, MoE
feed-forwards (try ``--arch rwkv6_1_6b`` or ``--arch jamba_v0_1_52b``).
Stub-frontend archs (MusicGen, LLaVA) take embeddings: the prompt is
random embeddings and each decode step feeds the embedding of the token
sampled last.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode --arch qwen2_1_5b

The model is the reduced configuration in f32, as in the JAX example.
Weights are random, drawn from seed 0.  ``--device cpu`` runs on the
CPU (plain versions of the kernels); the default is CUDA.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.models import transformer as T
from repro_torch.models.common import resolve_device
from repro_torch.serve import engine
from repro_torch.serve.prefill import prefill_step


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_1_5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config(get_config(args.arch))
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.model_init(cfg, gen, device=dev)
    max_len = args.prompt_len + args.gen + 8
    if cfg.input_mode == "embeddings":
        prompts = torch.randn((args.batch, args.prompt_len, cfg.d_model),
                              generator=gen, device=dev)
    else:
        prompts = torch.randint(0, cfg.vocab_size,
                                (args.batch, args.prompt_len), generator=gen,
                                dtype=torch.int32, device=dev)

    # ---- prefill -------------------------------------------------------
    _sync(dev)
    t0 = time.perf_counter()
    tok, cache, cur = prefill_step(params, prompts, cfg)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    state = {"cache": engine.pad_cache(cache, cfg, args.batch, max_len),
             "cur_len": cur}
    del cache

    # ---- decode loop ---------------------------------------------------
    generated = [tok]
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        if cfg.input_mode == "embeddings":
            # stub frontend: feed the embedding of the sampled token id
            feed = params["embed"].index_select(0, tok[:, 0])[:, None]
            tok, state = engine.decode_step(params, state, feed.float(), cfg)
        else:
            tok, state = engine.decode_step(params, state, tok, cfg)
        generated.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    toks = torch.cat(generated, dim=1).cpu()
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    print(f"arch={cfg.name} on {name}  prefill({args.batch} x "
          f"{args.prompt_len} toks): {t_prefill * 1e3:.1f} ms   decode: "
          f"{t_decode / max(args.gen - 1, 1) * 1e3:.2f} ms/token")
    print(f"generated token ids (first sequence): {toks[0][:16].tolist()} ...")
    if toks.shape != (args.batch, args.gen):
        raise AssertionError(f"generated {tuple(toks.shape)}")
    print("OK")


if __name__ == "__main__":
    main()
