"""Deterministic synthetic data pipeline with background prefetch.

Real deployments swap ``SyntheticLMDataset`` for a tokenized corpus reader;
the pipeline contract (shard-aware, deterministic per (seed, step, shard),
prefetching iterator) is what the trainer and the fault-tolerance story
depend on: after a restart, ``seek(step)`` resumes the exact stream.

The reference's module as it is: numpy only, so both packages yield
identical batches.  Batches stay numpy across the prefetch thread; the
engine stages feeds onto its device."""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np


class SyntheticLMDataset:
    """Zipf-distributed token stream, deterministic per (seed, step, shard)."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0,
                 shard: int = 0, n_shards: int = 1, extras: Optional[dict] = None):
        self.vocab, self.seq_len, self.batch = vocab, seq_len, batch
        self.seed, self.shard, self.n_shards = seed, shard, n_shards
        self.extras = extras or {}
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._p = (p / p.sum()).astype(np.float64)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * 131 + self.shard) % (2 ** 31))
        tokens = rng.choice(self.vocab, size=(self.batch, self.seq_len + 1),
                            p=self._p).astype(np.int32)
        out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        for k, spec in self.extras.items():
            out[k] = rng.randn(self.batch, *spec["shape"]).astype(
                spec.get("dtype", np.float32))
        return out


class PrefetchIterator:
    """Background-thread prefetch (depth-N) over a step-indexed dataset.

    ``seek(step)`` makes the stream resumable after checkpoint restart —
    part of the fault-tolerance contract."""

    def __init__(self, dataset, start_step: int = 0, depth: int = 2):
        self.dataset = dataset
        self.depth = depth
        self._step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._start_worker()

    def _start_worker(self):
        self._stop.clear()

        def work(first_step):
            s = first_step
            while not self._stop.is_set():
                b = self.dataset.batch_at(s)
                while not self._stop.is_set():
                    try:
                        self._q.put((s, b), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                s += 1

        self._thread = threading.Thread(target=work, args=(self._step,),
                                        daemon=True, name="data-prefetch")
        self._thread.start()

    def seek(self, step: int):
        self._stop.set()
        self._thread.join()
        self._q = queue.Queue(maxsize=self.depth)
        self._step = step
        self._start_worker()

    def __next__(self):
        s, b = self._q.get()
        self._step = s + 1
        return b

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
