"""Deterministic, shardable token pipeline (the port's own copy of
``repro.data.pipeline``: NumPy only, the same bytes from the same seed).

``SyntheticLMDataset`` generates a reproducible Zipf-ish token stream
with local structure (Markov bigram mixing) so a ~100M model actually
has something to learn in the end-to-end example. ``ShardedLoader``
yields per-host shards by (host_index, num_hosts) — the production
pattern for multi-pod ingestion — with background prefetch.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

__all__ = ["SyntheticLMDataset", "ShardedLoader", "make_train_batches"]


@dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.3

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # a sparse "bigram grammar": each token prefers a few successors
        self._succ = rng.integers(
            0, self.vocab_size, size=(self.vocab_size, 4)).astype(np.int32)

    def batch(self, index: int, batch_size: int) -> dict[str, np.ndarray]:
        """Deterministic batch #index: (tokens, labels) int32 (B, S)."""
        rng = np.random.default_rng((self.seed, index))
        B, S = batch_size, self.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = (rng.zipf(self.zipf_a, B) - 1) % self.vocab_size
        follow = rng.random((B, S)) < 0.7
        choice = rng.integers(0, 4, (B, S))
        rand = ((rng.zipf(self.zipf_a, (B, S)) - 1) % self.vocab_size).astype(np.int32)
        for t in range(S):
            nxt = self._succ[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, rand[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class ShardedLoader:
    """Host-sharded loader with a prefetch thread.

    Every host computes the same global batch index sequence; each
    takes its slice — deterministic across restarts (checkpoint stores
    the step, restore resumes at step+1 with identical data order).
    """

    def __init__(self, dataset: SyntheticLMDataset, global_batch: int,
                 host_index: int = 0, num_hosts: int = 1,
                 start_step: int = 0, prefetch: int = 2):
        if global_batch % num_hosts:
            raise ValueError(f"global_batch {global_batch} does not split over {num_hosts} hosts")
        self.dataset = dataset
        self.global_batch = global_batch
        self.host_batch = global_batch // num_hosts
        self.host_index = host_index
        self.num_hosts = num_hosts
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _produce(self, step: int) -> dict[str, np.ndarray]:
        full = self.dataset.batch(step, self.global_batch)
        lo = self.host_index * self.host_batch
        hi = lo + self.host_batch
        return {k: v[lo:hi] for k, v in full.items()}

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            try:
                self._q.put(self._produce(step), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def __next__(self) -> dict[str, np.ndarray]:
        batch = self._q.get()
        self.step += 1
        return batch

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)


def make_train_batches(vocab_size: int, seq_len: int, global_batch: int,
                       steps: int, seed: int = 0) -> Iterator[dict]:
    """Simple non-threaded iterator (tests / examples)."""
    ds = SyntheticLMDataset(vocab_size, seq_len, seed)
    for i in range(steps):
        yield ds.batch(i, global_batch)
