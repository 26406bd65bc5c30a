"""Deterministic, resumable, sharded token pipeline: the port's own copy
of the reference's ``repro/data/pipeline.py`` (numpy only, no torch and
no ``repro``), so its batches are bit-identical to the reference's.

Production constraints honored:
  * determinism: batch `i` is a pure function of (seed, step) — restart
    from a checkpoint reproduces the exact token stream (the data state
    checkpointed is just the step counter),
  * sharding: each data-parallel host materializes only its slice
    (`host_batch_slice`), the global batch is assembled device-side by
    pjit from per-host shards,
  * sources: synthetic LM stream (zipf-ish unigram mix + markov chain so
    the loss actually decreases) or a memory-mapped token file.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"      # synthetic | file:<path>
    pack: bool = True


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._file = None
        if cfg.source.startswith("file:"):
            self._file = np.memmap(cfg.source[5:], dtype=np.uint16, mode="r")

    # ------------------------------------------------------------------
    def _synthetic(self, step: int, lo: int, hi: int) -> np.ndarray:
        """Markov-ish synthetic stream: token_{t+1} = f(token_t) + noise.
        Learnable structure => train loss visibly decreases.

        The FULL global batch is a pure function of (seed, step) and is
        generated whole, then row-sliced — so any host partitioning (or
        an elastic restart with a different host count) sees the exact
        same token stream.  Token payload is small (global_batch x seq
        int32), so whole-batch generation is cheap at any scale."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed * 1_000_003 + step) * 65_537)
        V = cfg.vocab
        B = cfg.global_batch
        toks = np.empty((B, cfg.seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, V, B)
        noise = rng.random((B, cfg.seq_len))
        jump = rng.integers(0, V, (B, cfg.seq_len))
        for t in range(cfg.seq_len):
            nxt = (toks[:, t] * 31 + 7) % V          # deterministic chain
            toks[:, t + 1] = np.where(noise[:, t] < 0.8, nxt, jump[:, t])
        return toks[lo:hi]

    def _from_file(self, step: int, lo: int, hi: int) -> np.ndarray:
        cfg = self.cfg
        n = hi - lo
        L = cfg.seq_len + 1
        total = self._file.size - L
        rng = np.random.default_rng((cfg.seed * 1_000_003 + step))
        starts = rng.integers(0, total, cfg.global_batch)[lo:hi]
        return np.stack([self._file[s:s + L] for s in starts]).astype(np.int64)

    # ------------------------------------------------------------------
    def batch_at(self, step: int, lo: int = 0, hi: Optional[int] = None
                 ) -> Dict[str, np.ndarray]:
        """Rows [lo, hi) of global batch `step` (host slice)."""
        hi = self.cfg.global_batch if hi is None else hi
        toks = (self._from_file(step, lo, hi) if self._file is not None
                else self._synthetic(step, lo, hi))
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "mask": np.ones((hi - lo, self.cfg.seq_len), np.float32),
        }

    def host_batch_slice(self, step: int, host_id: int, n_hosts: int
                         ) -> Dict[str, np.ndarray]:
        per = self.cfg.global_batch // n_hosts
        return self.batch_at(step, host_id * per, (host_id + 1) * per)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
