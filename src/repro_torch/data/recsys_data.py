"""Synthetic Criteo-like click-log stream with power-law value frequencies.

A copy of ``repro.data.recsys_data`` (pure numpy on both sides), so the
batches equal the reference's exactly for the same seed. The per-row
access frequency distribution is the recsys analog of the paper's vertex
degree distribution: a small set of very hot rows (delegates) covers most
lookups. The stream owns the :class:`HotColdMap` and emits shape-static
``(hot_idx, cold_idx, labels)`` batches.
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.recsys import HotColdMap, make_vocab_sizes


class ClickStream:
    def __init__(self, n_fields: int = 39, total_vocab: int = 1 << 20,
                 hot_fraction: float = 0.005, seed: int = 0,
                 shard: int = 0, num_shards: int = 1):
        self.n_fields = n_fields
        self.seed = seed
        self.shard = shard
        self.vocab_sizes = make_vocab_sizes(n_fields, total_vocab, seed)
        rng = np.random.default_rng(seed + 1)
        # zipf-ish per-row popularity over the concatenated table space
        v = int(self.vocab_sizes.sum())
        freq = rng.pareto(1.1, v) + 1
        thresh = np.quantile(freq, 1.0 - hot_fraction)
        self.hot_cold = HotColdMap.build(self.vocab_sizes, freq, thresh)
        # per-field sampling distributions (propto popularity)
        self._field_probs = []
        off = self.hot_cold.field_offsets
        for f in range(n_fields):
            p = freq[off[f]:off[f + 1]]
            self._field_probs.append(p / p.sum())

    def batch(self, step: int, batch_size: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        raw = np.zeros((batch_size, self.n_fields), np.int64)
        for f in range(self.n_fields):
            raw[:, f] = rng.choice(len(self._field_probs[f]), batch_size,
                                   p=self._field_probs[f])
        hot_idx, cold_idx = self.hot_cold.split(raw)
        # labels correlated with a few field values so training can learn
        y = ((raw[:, 0] + raw[:, 1] * 3) % 7 < 2).astype(np.int32)
        return {"hot_idx": hot_idx, "cold_idx": cold_idx, "labels": y}

    @property
    def hot_lookup_fraction(self) -> float:
        """Fraction of lookups served by delegate rows (for benchmarks)."""
        total_hot = 0.0
        off = self.hot_cold.field_offsets
        for f in range(self.n_fields):
            hot_rows = self.hot_cold.hot_of[off[f]:off[f + 1]] >= 0
            total_hot += float(self._field_probs[f][hot_rows].sum())
        return total_hot / self.n_fields
