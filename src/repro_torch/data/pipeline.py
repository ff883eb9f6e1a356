"""Deterministic synthetic data pipeline (shardable, seeded, prefetching).

The port's copy of ``repro.data.pipeline`` (NumPy only; the port imports
nothing of the JAX package).  One change: ``PrefetchIterator.close`` waits
for its thread to end, so no thread outlives the iterator.

Serves the role of a real corpus loader in this offline container: a
zipf-distributed token stream with enough structure for a language model to
learn (bigram dependencies), generated per-host from (seed, step, host_slice)
so every data-parallel shard sees a disjoint deterministic stream and a
restart resumes *exactly* where it left off (fault-tolerance requirement:
the pipeline state is just the integer step).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    structure: float = 0.7       # P(next token = f(prev)) — learnable signal


class SyntheticTokenPipeline:
    """Deterministic, resumable synthetic LM batches."""

    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 host_count: int = 1):
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        if cfg.global_batch % host_count:
            raise ValueError("global_batch must divide host_count")
        self.local_batch = cfg.global_batch // host_count
        # fixed bigram successor table (the learnable structure)
        rng = np.random.default_rng(cfg.seed)
        self._succ = rng.integers(0, cfg.vocab_size,
                                  size=(cfg.vocab_size,), dtype=np.int64)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + self.host_index)
        b, s = self.local_batch, cfg.seq_len
        base = rng.zipf(cfg.zipf_a, size=(b, s)).astype(np.int64)
        base = np.clip(base - 1, 0, cfg.vocab_size - 1)
        use_succ = rng.random((b, s)) < cfg.structure
        toks = base.copy()
        # true markov chain: each token follows the *emitted* previous token
        for t in range(1, s):
            toks[:, t] = np.where(use_succ[:, t],
                                  self._succ[toks[:, t - 1]], base[:, t])
        return {"tokens": toks.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchIterator:
    """Background-thread prefetch (overlaps host data gen with device step)."""

    def __init__(self, pipeline: SyntheticTokenPipeline, start_step: int = 0,
                 depth: int = 2):
        self._pipeline = pipeline
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._pipeline.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> Tuple[int, Dict[str, np.ndarray]]:
        return self._q.get()

    def close(self):
        """Stop the thread and wait for it: it checks the stop flag at least
        every 0.1 s and after each batch."""
        self._stop.set()
        self._thread.join()
