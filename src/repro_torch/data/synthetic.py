"""Deterministic synthetic token stream.

A structured (not uniform-random) language: Zipf-distributed unigrams with a
Markov back-off, so cross-entropy actually *decreases* during the e2e
training example — loss-goes-down is one of the integration assertions.
Batches are derived purely from (seed, step), so a restarted trainer
re-produces the exact batch for any step: the data pipeline is stateless,
which is what makes the Jointλ step-commit protocol (exactly-once per step)
applicable without data-loader checkpoints.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.models.common import ModelConfig


@dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse Markov structure: each token has a preferred successor set
        self._succ = rng.integers(0, self.vocab, size=(self.vocab, 4))
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks ** self.zipf_a
        self._p = p / p.sum()

    def batch(self, step: int, *, host_index: int = 0, host_count: int = 1
              ) -> Dict[str, np.ndarray]:
        """The global batch for ``step`` (or this host's shard of it)."""
        assert self.global_batch % host_count == 0
        b = self.global_batch // host_count
        rng = np.random.default_rng((self.seed, step, host_index))
        first = rng.choice(self.vocab, size=(b, 1), p=self._p)
        toks = [first]
        for _ in range(self.seq_len):
            prev = toks[-1][:, 0]
            choice = rng.integers(0, 4, size=b)
            markov = self._succ[prev, choice]
            noise = rng.choice(self.vocab, size=b, p=self._p)
            use_markov = rng.random(b) < 0.8
            toks.append(np.where(use_markov, markov, noise)[:, None])
        seq = np.concatenate(toks, axis=1).astype(np.int32)   # [b, L+1]
        return {
            "tokens": seq[:, :-1],
            "labels": seq[:, 1:],
            "mask": np.ones((b, self.seq_len), np.float32),
        }


def make_batch(cfg: ModelConfig, seq_len: int, global_batch: int, step: int = 0,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """One-call helper (adds the modality-stub inputs the config needs)."""
    lt = seq_len - cfg.n_patches
    ds = SyntheticLM(cfg.vocab, lt, global_batch, seed=seed)
    out: Dict[str, np.ndarray] = dict(ds.batch(step))
    rng = np.random.default_rng((seed, step, 7))
    if cfg.n_patches:
        out["patches"] = rng.standard_normal(
            (global_batch, cfg.n_patches, 1024)).astype(np.float32)
    if cfg.frame_input:
        out["frames"] = rng.standard_normal(
            (global_batch, max(1, seq_len // 8), 1024)).astype(np.float32)
    return out
