"""Synthetic LM token streams for scale-mode training — a copy of
``synthetic_token_batches`` from ``repro/data/tokens.py`` (numpy only;
the reference's jax-only ``lm_batch_spec`` is left out).

Deterministic Zipf-ish token generator — no downloads, reproducible, and
shardable: device d / replica r draws from a disjoint seed stream, which
is exactly the non-iid `delta > 0` regime the paper studies.
"""
from __future__ import annotations

import numpy as np


def synthetic_token_batches(batch: int, seq_len: int, vocab: int,
                            seed: int = 0, shard_id: int = 0,
                            start: int = 0):
    """Infinite iterator of {tokens, labels} numpy batches.

    Tokens follow a per-shard Zipf distribution with a shard-specific
    permutation of the vocabulary -> statistical heterogeneity across
    shards (gradient diversity delta > 0).

    The stream is *seekable*: ``start=k`` begins at the k-th batch of
    the ``start=0`` stream — identical sequences at any offset, so a
    checkpoint restore fast-forwards in O(1) instead of re-drawing
    every consumed batch. Each batch consumes exactly ``batch *
    (seq_len + 1)`` generator doubles (``Generator.choice`` with
    explicit probabilities draws one uniform per sample), so the seek
    is a single PCG64 ``advance`` past the permutation draw.
    """
    # a hash of a tuple of ints does not vary between processes
    rng = np.random.default_rng(hash((seed, shard_id)) % (2**31))
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    perm = rng.permutation(vocab)
    draws = batch * (seq_len + 1)
    if start:
        rng.bit_generator.advance(start * draws)
    while True:
        flat = rng.choice(vocab, size=draws, p=probs)
        flat = perm[flat].reshape(batch, seq_len + 1).astype(np.int32)
        yield {"tokens": flat[:, :-1], "labels": flat[:, 1:]}


__all__ = ["synthetic_token_batches"]
