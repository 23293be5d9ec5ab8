"""Deterministic synthetic LM data: seeded, shardable, resumable (a copy of
``repro/data/synthetic.py``; the generator is numpy, so `batch_at` gives the
JAX package's tokens exactly).

The stream is a stateless function of (seed, step, position) -- any host can
materialize exactly its shard of any step without coordination, which is
what makes checkpoint-restart and elastic rescaling trivial.

Two generators:
  * `uniform_stream`   -- iid tokens (throughput testing)
  * `markov_stream`    -- order-1 Markov chain with a seeded random
    transition structure; gives nontrivial next-token structure so small
    models actually learn (loss decreases), used by the examples and tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "markov"  # markov | uniform
    branching: int = 8    # markov successors per token


_MASK64 = (1 << 64) - 1


def _fold(seed: int, *xs: int) -> np.uint64:
    h = (int(seed) ^ 0x9E3779B97F4A7C15) & _MASK64
    for x in xs:
        h = ((h ^ int(x)) * 0xBF58476D1CE4E5B9) & _MASK64
        h ^= h >> 31
    return np.uint64(h)


class SyntheticDataset:
    """Batch factory: batch_at(step) is pure and deterministic."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        if cfg.kind == "markov":
            # seeded successor table: token t -> branching candidates
            self._succ = rng.integers(0, cfg.vocab,
                                      size=(cfg.vocab, cfg.branching),
                                      dtype=np.int32)
        else:
            self._succ = None

    def batch_at(self, step: int, *, host_id: int = 0, n_hosts: int = 1
                 ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        if cfg.global_batch % n_hosts:
            raise ValueError("global_batch must divide across hosts")
        per_host = cfg.global_batch // n_hosts
        rows = np.arange(host_id * per_host, (host_id + 1) * per_host)
        out = np.empty((per_host, cfg.seq_len), np.int32)
        for i, row in enumerate(rows):
            h = _fold(cfg.seed, step, int(row))
            rng = np.random.default_rng(np.uint64(h))
            if cfg.kind == "uniform":
                out[i] = rng.integers(0, cfg.vocab, cfg.seq_len, dtype=np.int32)
            else:
                toks = np.empty(cfg.seq_len, np.int32)
                t = int(rng.integers(0, cfg.vocab))
                choices = rng.integers(0, cfg.branching, cfg.seq_len)
                for j in range(cfg.seq_len):
                    toks[j] = t
                    t = int(self._succ[t, choices[j]])
                out[i] = toks
        return {"tokens": out}

    def iter_from(self, step: int, **kw) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(step, **kw)
            step += 1
