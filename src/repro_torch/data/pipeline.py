"""Deterministic synthetic token pipeline.

A copy of the reference package's ``data/pipeline.py`` without its unused
``jax`` import, kept bit for bit equal to it by
``tests/test_torch_numpy_copies.py``.

Production layout without external deps: a seeded, order-stable stream of
(tokens, labels) batches with
  * per-host sharding (each data-parallel host reads only its slice),
  * sequence packing of variable-length "documents" (geometric lengths)
    separated by EOS, causal labels = next token,
  * double-buffered host->device prefetch (overlaps the host batch
    synthesis with device compute),
  * exact resumability: state is a (step,) tuple; restoring a checkpoint
    at step k replays the identical batch k+1 (tested).

The synthetic text has learnable structure (a token-bigram Markov chain
with per-document drift) so small-model training loss measurably drops —
which the annealing-on-real-training benchmarks rely on.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 192
    eos: int = 1
    n_hosts: int = 1
    host_id: int = 0

    def __post_init__(self) -> None:
        if self.global_batch % self.n_hosts:
            raise ValueError("global_batch must divide across hosts")


class SyntheticLM:
    """Markov-bigram documents, packed to fixed-length rows."""

    def __init__(self, config: DataConfig):
        self.config = config
        rng = np.random.default_rng(config.seed)
        V = config.vocab
        # sparse-ish bigram structure: each token prefers a few successors
        k = min(8, V)
        self._succ = rng.integers(2, V, size=(V, k)).astype(np.int32)
        self._host_batch = config.global_batch // config.n_hosts

    def _document(self, rng: np.random.Generator) -> np.ndarray:
        cfg = self.config
        n = int(rng.geometric(1.0 / cfg.mean_doc_len))
        n = max(2, min(n, 4 * cfg.mean_doc_len))
        toks = np.empty(n, np.int32)
        toks[0] = rng.integers(2, cfg.vocab)
        for i in range(1, n):
            choices = self._succ[toks[i - 1]]
            toks[i] = choices[rng.integers(len(choices))]
        toks[-1] = cfg.eos
        return toks

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Deterministic batch for a given step (host-sharded rows)."""
        cfg = self.config
        B, S = self._host_batch, cfg.seq_len
        rows = np.empty((B, S + 1), np.int32)
        for b in range(B):
            # independent stream per (step, global row): stable under
            # elastic changes of n_hosts as long as global_batch is fixed
            g = cfg.host_id * B + b
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, g]))
            parts, total = [], 0
            while total <= S:
                d = self._document(rng)
                parts.append(d)
                total += len(d)
            packed = np.concatenate(parts)[: S + 1]
            rows[b] = packed
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class _Prefetcher:
    """Double-buffered background prefetch of host batches."""

    def __init__(self, source: SyntheticLM, start_step: int, depth: int = 2):
        self._source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self._source.batch_at(step)
            self._q.put((step, batch))
            step += 1

    def __next__(self):
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass


def make_pipeline(config: DataConfig, start_step: int = 0,
                  prefetch: int = 2):
    """Returns an iterator of (step, {tokens, labels}) with background
    prefetch; resume by passing the restored step."""
    src = SyntheticLM(config)
    if prefetch <= 0:
        def gen():
            step = start_step
            while True:
                yield step, src.batch_at(step)
                step += 1
        return gen()
    return _Prefetcher(src, start_step, depth=prefetch)
