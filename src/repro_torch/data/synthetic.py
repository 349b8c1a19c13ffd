"""Deterministic synthetic LM data pipeline.

Mirrors :mod:`repro.data.synthetic`: token streams come from a stateless
hash of (seed, step, position), so batch ``i`` is the same bits whichever
host makes it, and a restart re-seeks by step.  A degree-2 Markov-ish
mixture (75% of positions a function of the two previous tokens) makes
the loss of a ~100M model drop visibly within a few hundred steps.

Batches are NumPy int32 arrays, made on the host as the reference makes
them; the trainer moves them to the device.  A background thread keeps
``prefetch`` batches ready for iteration.  :meth:`seek` restarts that
thread at the given step, so the next batch is ``batch_at(step)``.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Dict, Iterator

import numpy as np

__all__ = ["SyntheticLMStream"]


def _hash2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x = (a.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         + b.astype(np.uint64) * np.uint64(0xBF58476D1CE4E5B9))
    x ^= x >> np.uint64(31)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(29)
    return x


class SyntheticLMStream:
    """Iterator of {tokens, labels} int32 [batch, seq] with background
    prefetch."""

    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int = 0,
                 structured: bool = True, prefetch: int = 2):
        self.vocab = int(vocab)
        self.batch = int(batch)
        self.seq = int(seq_len)
        self.seed = seed
        self.structured = structured
        self.prefetch = prefetch
        self._start(0)

    # -- deterministic batch materialization --------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        B, S, V = self.batch, self.seq + 1, self.vocab
        rows = (np.uint64(self.seed) * np.uint64(1_000_003)
                + np.arange(step * B, (step + 1) * B, dtype=np.uint64))
        pos = np.arange(S, dtype=np.uint64)
        h = _hash2(rows[:, None], pos[None, :])
        toks = (h % np.uint64(V)).astype(np.int64)
        if self.structured:
            # 75% of positions: a deterministic function of the two
            # previous tokens (learnable structure)
            choose = (h >> np.uint64(32)) % np.uint64(4)
            for t in range(2, S):
                det = (toks[:, t - 1] * 31 + toks[:, t - 2] * 7) % V
                toks[:, t] = np.where(choose[:, t] > 0, det, toks[:, t])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    # -- iterator protocol ----------------------------------------------------
    def _start(self, step: int) -> None:
        self._step = step
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, args=(step,),
                                        daemon=True)
        self._thread.start()

    def _producer(self, step: int) -> None:
        while not self._stop.is_set():
            b = self.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.2)
                    break
                except queue_mod.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        step, b = self._q.get()
        self._step = step
        return b

    def seek(self, step: int) -> None:
        """Restart-safe: drop the prefetched batches and refill from
        ``step`` (checkpoint restore); the next batch is
        ``batch_at(step)``."""
        self.close()
        self._start(step)

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue_mod.Empty:
            pass
        self._thread.join(timeout=1.0)
