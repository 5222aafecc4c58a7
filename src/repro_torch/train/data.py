"""Deterministic, resumable data pipeline (numpy only).

Counterpart of ``repro.train.data``: each batch is a pure function of
``(seed, step)``, so a restart from a checkpoint at step N reproduces
batches N+1... with no reader state to persist, and every batch is bit
for bit the reference's for the same ``(seed, step)``.

  * SyntheticLM — structured pseudo-text (Zipfian tokens with short-range
    repetition, so a model can overfit it in a few hundred steps)
  * SyntheticEmbeds — stub-frontend batches of precomputed embeddings
  * MemmapCorpus — a token file on disk, sampled by deterministic offsets
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        B, S = self.global_batch, self.seq_len
        # zipfian unigrams + markov-ish repetition for learnable structure
        base = rng.zipf(1.3, size=(B, S)).astype(np.int64)
        tokens = (base % (self.vocab - 2)) + 1
        rep = rng.random((B, S)) < 0.3
        shifted = np.roll(tokens, 1, axis=1)
        tokens = np.where(rep, shifted, tokens)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -1
        return {"tokens": tokens.astype(np.int32),
                "labels": labels.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class SyntheticEmbeds:
    """Stub-frontend batches (vlm/audio): precomputed frame/patch embeds."""
    d_model: int
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, 1, step))
        B, S = self.global_batch, self.seq_len
        emb = rng.standard_normal((B, S, self.d_model)).astype(np.float32)
        labels = rng.integers(0, self.vocab, (B, S)).astype(np.int32)
        return {"embeds": emb, "labels": labels}


class MemmapCorpus:
    """Token corpus in a flat .bin (int32); deterministic window sampling.
    ``process_index`` / ``process_count`` slice the global batch per host
    (one host: 0 and 1)."""

    def __init__(self, path: str, seq_len: int, global_batch: int,
                 seed: int = 0, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.pi = process_index if process_index is not None else 0
        self.pc = process_count if process_count is not None else 1
        assert global_batch % self.pc == 0
        self.local_batch = global_batch // self.pc

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step, self.pi))
        n = self.tokens.shape[0] - self.seq_len - 1
        starts = rng.integers(0, n, size=self.local_batch)
        toks = np.stack([self.tokens[s:s + self.seq_len] for s in starts])
        labels = np.stack([self.tokens[s + 1:s + self.seq_len + 1]
                           for s in starts])
        return {"tokens": toks.astype(np.int32),
                "labels": labels.astype(np.int32)}


def write_corpus(path: str, tokens: np.ndarray):
    tokens.astype(np.int32).tofile(path)
