"""Batch samplers (a numpy copy of ``distlearn_tpu/data/samplers.py``) —
parity with torch-dataset's ``sampledBatcher`` samplers as
used by the reference:

* ``permutation`` — fresh shuffle each epoch (examples/mnist.lua:31-40).
* ``label-uniform`` — each draw picks a uniformly random label, then a random
  example of that label (examples/cifar10.lua:53-72, examples/Data.lua:21) —
  class-balanced batches regardless of label skew in the shard.

Samplers yield index arrays; the batcher gathers and (optionally) runs a
``processor`` transform — the reference's clean-env processor fn becomes a
plain Python callable here.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class PermutationSampler:
    """Epoch = one pass over a fresh permutation (ref examples/mnist.lua:31-40)."""

    def __init__(self, n: int, seed: int = 0):
        self.n = n
        self._rng = np.random.RandomState(seed)

    def epoch(self, batch_size: int) -> Iterator[np.ndarray]:
        perm = self._rng.permutation(self.n)
        for i in range(0, self.n - batch_size + 1, batch_size):
            yield perm[i:i + batch_size]


class LabelUniformSampler:
    """Label-balanced draws (ref examples/Data.lua:21 'label-uniform').

    An "epoch" is size//batch_size batches, matching the reference's epoch
    accounting (torch-dataset keeps epoch length = shard size / batch)."""

    def __init__(self, labels: np.ndarray, seed: int = 0):
        self.labels = np.asarray(labels)
        self.n = len(self.labels)
        self.classes = np.unique(self.labels)
        # Ragged per-class index table, padded square for vectorized gathers.
        by_class = [np.flatnonzero(self.labels == c) for c in self.classes]
        self._lens = np.array([len(ix) for ix in by_class])
        pad = self._lens.max()
        self._table = np.stack([np.pad(ix, (0, pad - len(ix)), mode="wrap")
                                for ix in by_class])
        self._rng = np.random.RandomState(seed)

    def epoch(self, batch_size: int) -> Iterator[np.ndarray]:
        for _ in range(self.n // batch_size):
            cpos = self._rng.randint(len(self.classes), size=batch_size)
            j = (self._rng.random(batch_size) * self._lens[cpos]).astype(np.int64)
            yield self._table[cpos, j]


def make_sampler(kind: str, labels: np.ndarray, seed: int = 0):
    """Factory keyed by the reference's sampler-name strings."""
    if kind == "permutation":
        return PermutationSampler(len(labels), seed)
    if kind in ("label-uniform", "label_uniform"):
        return LabelUniformSampler(labels, seed)
    raise ValueError(f"unknown sampler kind: {kind!r}")
