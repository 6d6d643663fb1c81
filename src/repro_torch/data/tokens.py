"""Deterministic synthetic LM data pipeline -- the port of
``repro.data.tokens`` (the same numpy draw, so the same arrays).

Sharded, restart-reproducible token stream: batch(step) is a pure function
of (seed, step, shard), so a job restarted from a checkpoint at step k sees
exactly the data it would have seen -- the property the fault-tolerance
driver relies on.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, shard: int = 0, num_shards: int = 1):
        if global_batch % num_shards:
            raise ValueError(f"global_batch {global_batch} does not split "
                             f"into {num_shards} shards")
        self.vocab = vocab
        self.seq_len = seq_len
        self.local_batch = global_batch // num_shards
        self.seed = seed
        self.shard = shard

    def batch(self, step: int) -> dict:
        """``{"tokens": [B, S] int32, "labels": [B, S] int32}`` (numpy;
        labels are the tokens shifted by one)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        # zipf-flavored marginal + short-range structure (so a real model
        # actually learns something in the examples)
        z = rng.zipf(1.3, size=(self.local_batch, self.seq_len + 1))
        toks = (z % self.vocab).astype(np.int32)
        toks[:, 1::2] = (toks[:, 0::2][:, : toks[:, 1::2].shape[1]] * 7 + 1) % self.vocab
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
