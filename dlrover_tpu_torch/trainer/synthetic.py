"""Synthetic token data: the random-walk corpus of the nanoGPT example
(``examples/nanogpt/train.py``), and global batches drawn from it in
sampler order."""

from __future__ import annotations

from typing import Iterable, Iterator, Tuple

import numpy as np


def synthetic_corpus(vocab_size: int, length: int = 2 ** 15) -> np.ndarray:
    """A deterministic token stream with local structure (random walk)."""
    rng = np.random.default_rng(1234)
    steps = rng.integers(-3, 4, length)
    return np.cumsum(steps).astype(np.int32) % vocab_size


def batches(corpus: np.ndarray, sampler: Iterable[int], global_batch: int,
            seq: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (tokens, targets) global batches by sampler order."""
    starts_per_sample = len(corpus) - seq - 1
    batch = []
    for idx in sampler:
        start = idx % starts_per_sample
        batch.append(corpus[start:start + seq + 1])
        if len(batch) == global_batch:
            chunk = np.stack(batch)
            batch = []
            yield chunk[:, :-1], chunk[:, 1:]
