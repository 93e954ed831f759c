"""Synthetic deterministic data pipeline, a copy of ``repro.train.data``
(host numpy; its batches equal the JAX package's byte for byte).

Streams are a pure function of (step, position) so every restart
reproduces the identical token sequence: the property checkpoint/restart
tests assert on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

__all__ = ["SyntheticLM", "make_batch"]


def _mix(a: np.ndarray, b: int) -> np.ndarray:
    # splitmix-style integer hash, vectorised
    x = (a.astype(np.uint64) + np.uint64(b) * np.uint64(0x9E3779B97F4A7C15))
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def make_batch(step: int, *, global_batch: int, seq_len: int, vocab: int,
               input_mode: str = "tokens", d_model: int = 0) -> Dict:
    """Deterministic batch for ``step`` (host-side numpy)."""
    idx = np.arange(global_batch * (seq_len + 1), dtype=np.uint64)
    toks = (_mix(idx, step + 1) % np.uint64(max(vocab - 1, 1))).astype(np.int32)
    toks = toks.reshape(global_batch, seq_len + 1)
    inputs, labels = toks[:, :-1], toks[:, 1:]
    if input_mode == "embeddings":
        # stub modality frontend: hash -> gaussian-ish embeddings
        flat = _mix(np.arange(global_batch * seq_len, dtype=np.uint64),
                    step + 7919)
        u = (flat % np.uint64(10_000)).astype(np.float32) / 5000.0 - 1.0
        emb = np.tile(u.reshape(global_batch, seq_len, 1), (1, 1, d_model))
        scale = 1.0 / np.sqrt(np.arange(1, d_model + 1, dtype=np.float32))
        return {"inputs": (emb * scale).astype(np.float32),
                "labels": labels.copy()}
    return {"inputs": inputs.copy(), "labels": labels.copy()}


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    input_mode: str = "tokens"
    d_model: int = 0
    start_step: int = 0

    def __iter__(self) -> Iterator[Dict]:
        step = self.start_step
        while True:
            yield make_batch(step, global_batch=self.global_batch,
                             seq_len=self.seq_len, vocab=self.vocab,
                             input_mode=self.input_mode, d_model=self.d_model)
            step += 1
