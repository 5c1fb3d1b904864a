"""Synthetic LM token pipeline for the large-model training path. Port of
the JAX package's ``data/tokens.py``.

Generates Markov-chain token streams (learnable bigram structure) so the
training driver shows a genuinely decreasing loss, with host-side batching
and non-IID per-cluster stream shards for the hierarchical trainer. The
draws are numpy's (``np.random.default_rng``), as the reference's, so the
token and label values are bitwise equal to the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def make_bigram_table(vocab: int, seed: int = 0, concentration: float = 0.3):
    rng = np.random.default_rng(seed)
    logits = rng.gumbel(size=(vocab, vocab)) / concentration
    # keep only top 32 successors per token for strong structure
    top = np.argpartition(-logits, 32, axis=1)[:, :32]
    probs = np.zeros((vocab, vocab), np.float32)
    rows = np.arange(vocab)[:, None]
    vals = np.exp(logits[rows, top] - logits[rows, top].max(1, keepdims=True))
    probs[rows, top] = vals
    return probs / probs.sum(1, keepdims=True)


def synthetic_lm_batches(vocab: int, batch: int, seq: int, n_batches: int,
                         seed: int = 0, table=None, device="cuda"):
    """Yields dicts {tokens, labels} of int64 (batch, seq) tensors on
    ``device`` (default the card); the values are the reference's."""
    device = resolve_device(device)
    table = make_bigram_table(min(vocab, 2048), seed) if table is None \
        else table
    v = table.shape[0]
    rng = np.random.default_rng(seed + 1)
    cum = np.cumsum(table, axis=1)
    for _ in range(n_batches):
        toks = np.empty((batch, seq + 1), np.int64)
        toks[:, 0] = rng.integers(0, v, batch)
        u = rng.random((batch, seq))
        for t in range(seq):
            row = cum[toks[:, t]]
            toks[:, t + 1] = (u[:, t:t + 1] < row).argmax(1)
        yield {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(device),
               "labels": torch.from_numpy(toks[:, 1:].copy()).to(device)}
