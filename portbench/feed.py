"""The one generator of every traffic mix: a synthetic image set made from
the seed, a sampler over it, and the feed that brings its batches to the
step, all read from the mix's parameters (``traffic/<mix>.json``).

The image recipe and the two samplers are frozen copies of the port's
``data/dataset.py::_synthetic_classification`` and
``data/samplers.py`` (``PermutationSampler``, ``LabelUniformSampler``), so
a change to the port cannot move the yardstick.  The images are drawn on
the card with ``torch``'s generator instead of numpy's, which keeps set-up
short; the recipe (smooth class templates under Gaussian noise) is the
port's.
"""

from __future__ import annotations

import itertools
import math
from typing import Iterator

import numpy as np
import torch

from portbench.reference.common import generator, sub_seed

#: a fixed stream for the class templates, shared by every seed (the
#: port's recipe draws them from a fixed seed too)
TEMPLATE_SEED = 0x5EED


def images(cfg: dict, mix: dict, seed: int, device
           ) -> tuple[np.ndarray, np.ndarray]:
    """``(x, y)`` on the host: ``mix["examples"]`` NHWC float32 images of
    ``cfg``'s size and int32 labels of its classes.  Each class has a
    spatially smooth unit-RMS template (coarse noise upsampled 4x); an
    image is its template times ``signal / sqrt(H W C)`` plus noise of
    standard deviation ``noise``."""
    n, s, c = mix["examples"], cfg["image_size"], cfg["in_channels"]
    classes = cfg["num_classes"]
    tg = generator(TEMPLATE_SEED, f"templates-{classes}-{s}", device)
    coarse = torch.randn(classes, math.ceil(s / 4), math.ceil(s / 4), c,
                         generator=tg, device=device)
    t = coarse.repeat_interleave(4, 1).repeat_interleave(4, 2)[:, :s, :s]
    t = t / t.square().mean(dim=(1, 2, 3), keepdim=True).sqrt()
    g = generator(seed, "images", device)
    y = torch.randint(0, classes, (n,), generator=g, device=device)
    x = torch.randn(n, s, s, c, generator=g, device=device) * mix["noise"]
    amp = mix["signal"] / math.sqrt(s * s * c)
    for lo in range(0, n, 1024):          # the template term in blocks
        x[lo:lo + 1024] += t[y[lo:lo + 1024]] * amp
    out = x.cpu().numpy(), y.to(torch.int32).cpu().numpy()
    del x, y, t
    return out


class PermutationSampler:
    """An epoch is one pass over a fresh permutation."""

    def __init__(self, n: int, seed: int):
        self.n = n
        self._rng = np.random.RandomState(seed % 2**32)

    def epoch(self, batch_size: int) -> Iterator[np.ndarray]:
        perm = self._rng.permutation(self.n)
        for i in range(0, self.n - batch_size + 1, batch_size):
            yield perm[i:i + batch_size]


class LabelUniformSampler:
    """Each draw picks a label uniformly, then an example of that label
    uniformly (with replacement); an epoch is ``n // batch_size``
    batches."""

    def __init__(self, labels: np.ndarray, seed: int):
        labels = np.asarray(labels)
        self.n = len(labels)
        self.classes = np.unique(labels)
        by_class = [np.flatnonzero(labels == c) for c in self.classes]
        self._lens = np.array([len(ix) for ix in by_class])
        pad = self._lens.max()
        self._table = np.stack([np.pad(ix, (0, pad - len(ix)), mode="wrap")
                                for ix in by_class])
        self._rng = np.random.RandomState(seed % 2**32)

    def epoch(self, batch_size: int) -> Iterator[np.ndarray]:
        for _ in range(self.n // batch_size):
            cpos = self._rng.randint(len(self.classes), size=batch_size)
            j = (self._rng.random(batch_size)
                 * self._lens[cpos]).astype(np.int64)
            yield self._table[cpos, j]


class Recorded:
    """A sampler whose first ``keep`` batches' indices are kept in
    ``log``."""

    def __init__(self, sampler, log: list, keep: int):
        self.sampler, self.log, self.keep = sampler, log, keep

    def epoch(self, batch_size: int) -> Iterator[np.ndarray]:
        for idx in self.sampler.epoch(batch_size):
            if len(self.log) < self.keep:
                self.log.append(np.array(idx))
            yield idx


def sampler(mix: dict, y: np.ndarray, seed: int, epoch: int):
    """Epoch ``epoch``'s sampler, seeded from the run's ``seed``."""
    s = sub_seed(seed, f"sampler-{epoch}")
    if mix["sampler"] == "permutation":
        return PermutationSampler(len(y), s)
    if mix["sampler"] == "label_uniform":
        return LabelUniformSampler(y, s)
    raise ValueError(f"unknown sampler {mix['sampler']!r}")


def stream(mix: dict, x: np.ndarray, y: np.ndarray, num_classes: int,
           seed: int, device, log: list, keep: int) -> Iterator:
    """The step's batches through the port's feed, epoch after epoch,
    without end: ``(x, y)`` on ``device`` for a step, ``None`` at an epoch's
    end.  ``"device"``: the set resident on the card (``DeviceDataset``),
    a batch gathered there; ``"host"``: the set on the host, a batch
    gathered there and sent through the prefetch queue
    (``examples.common.device_stream``).  The first ``keep`` batches'
    indices go to ``log``."""
    from distlearn_tpu_torch.data import DeviceDataset, make_dataset
    from distlearn_tpu_torch.examples import common

    batch = mix["batch"]
    if mix["feed"] == "device":
        dds = DeviceDataset(x, y, num_classes, device=device)

        def epoch_batches(smp):
            return dds.batches(common.node_sampler(smp, batch, 0, 1), batch)
    elif mix["feed"] == "host":
        ds = make_dataset(x, y, num_classes)

        def epoch_batches(smp):
            return common.device_stream(ds, smp, batch, device, 0, 1,
                                        prefetch=mix["prefetch"])
    else:
        raise ValueError(f"unknown feed {mix['feed']!r}")
    for epoch in itertools.count(1):
        yield from epoch_batches(Recorded(sampler(mix, y, seed, epoch), log,
                                          keep))
        if mix["epoch_sync"]:
            yield None
