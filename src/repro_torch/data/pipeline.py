"""Deterministic synthetic token pipeline, host-sharded (the port's own
copy of `repro.data.pipeline`, numpy only: `batch(step)` gives the
reference's arrays bit for bit).

Restart-exactness: batch(step) is a pure function of (seed, step,
host_shard), so resuming from a checkpoint at step k replays the
identical stream with no iterator state to save.  Each host generates
only its shard of the global batch.

The generator mimics natural-text statistics (Zipfian unigram over the
vocab + short-range repetition) so compression numbers are not
degenerate, while staying offline.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def _zipf_probs(vocab: int, a: float = 1.1) -> np.ndarray:
    r = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / r ** a
    return p / p.sum()


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._probs = _zipf_probs(cfg.vocab)

    def batch(self, step: int) -> dict:
        """{'tokens': [host_batch, S], 'labels': [host_batch, S]} int32."""
        cfg = self.cfg
        # seeded by (config seed, step, host): restart-exact resume needs
        # a stream keyed by the step
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_id))          # pure function of step
        toks = rng.choice(cfg.vocab, size=(cfg.host_batch, cfg.seq_len + 1),
                          p=self._probs).astype(np.int32)
        # short-range repetition: copy a window forward with prob .3
        w_hi = min(32, max(5, cfg.seq_len // 4))
        for b in range(cfg.host_batch):
            if rng.random() < 0.3:
                w = int(rng.integers(4, w_hi))
                if cfg.seq_len - 2 * w > 0:
                    s = int(rng.integers(0, cfg.seq_len - 2 * w))
                    toks[b, s + w: s + 2 * w] = toks[b, s: s + w]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
