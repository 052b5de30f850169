"""Partitioned in-memory datasets — a numpy copy of
``distlearn_tpu/data/dataset.py`` (the port imports nothing of the JAX
package).  Every ``synthetic_*`` generator gives the same arrays as the JAX
package's for the same seed; every parity test feeds on them.

Reference semantics (torch-dataset as the examples use it):

* ``partition / partitions`` — each node owns an equal contiguous shard of the
  index space (examples/mnist.lua:26-29).
* per-node batch size ``ceil(batchSize / numNodes)`` (examples/cifar10.lua:36).

The ``synthetic_*`` generators give MNIST/CIFAR/ImageNet-shaped data with a
learnable class signal (``synthetic_hard*``: one no linear model can
separate), so training runs need no download; :func:`load_npz` reads a
local ``.npz``.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class Dataset:
    """An in-memory partition of (x, y) examples.

    ``x``: float32 [n, ...] features (NHWC for images); ``y``: int32 [n].
    """
    x: np.ndarray
    y: np.ndarray
    num_classes: int

    @property
    def size(self) -> int:
        return len(self.y)

    def batches_per_epoch(self, batch_size: int) -> int:
        return self.size // batch_size


def make_dataset(x: np.ndarray, y: np.ndarray, num_classes: int,
                 partition: int = 0, partitions: int = 1) -> Dataset:
    """Slice out this node's contiguous shard (ref: torch-dataset
    ``partition``/``partitions``, examples/mnist.lua:26-29).  0-based
    ``partition`` (the reference's nodeIndex is 1-based)."""
    if not 0 <= partition < partitions:
        raise ValueError(f"partition={partition} out of range [0,{partitions})")
    n = len(y)
    per = n // partitions
    lo = partition * per
    hi = n if partition == partitions - 1 else lo + per
    return Dataset(x=np.asarray(x[lo:hi], np.float32),
                   y=np.asarray(y[lo:hi], np.int32),
                   num_classes=num_classes)


def per_node_batch_size(global_batch: int, num_nodes: int) -> int:
    """ceil(B/N) — examples/cifar10.lua:36."""
    return math.ceil(global_batch / num_nodes)


def load_npz(path: str, x_key: str = "x", y_key: str = "y",
             num_classes: int | None = None
             ) -> tuple[np.ndarray, np.ndarray, int]:
    """Load a dataset from a local .npz (the reference's $HOME-prefixed
    dataset files, examples/Data.lua:7-8)."""
    with np.load(os.path.expanduser(path)) as z:
        x = np.asarray(z[x_key], np.float32)
        y = np.asarray(z[y_key], np.int32)
    if num_classes is None:
        num_classes = int(y.max()) + 1
    return x, y, num_classes


def _smooth_templates(trng, num: int, shape: tuple[int, ...]) -> np.ndarray:
    """``num`` spatially-smooth unit-RMS templates (coarse noise upsampled
    4x) — shared by the easy class-template set and the hard two-factor
    set so "same smooth-template recipe" stays true by construction."""
    h, w = shape[0], shape[1]
    rest = shape[2:]
    coarse = trng.randn(num, max(1, -(-h // 4)), max(1, -(-w // 4)),
                        *rest).astype(np.float32)
    t = np.repeat(np.repeat(coarse, 4, axis=1), 4, axis=2)[:, :h, :w]
    return t / np.sqrt((t ** 2).mean(axis=tuple(range(1, t.ndim)),
                                     keepdims=True))


def _synthetic_classification(n: int, shape: tuple[int, ...], num_classes: int,
                              seed: int, signal: float = 8.0):
    """Class-conditional Gaussian images: each class has a fixed random
    template; examples are template*signal + noise.

    Templates are SPATIALLY SMOOTH (low-frequency blobs: coarse noise
    upsampled 4x), not per-pixel white noise — white-noise class signal is
    near-invisible to a conv+pool architecture (pooling destroys the phase
    the matched filter needs), so examples would train without learning.
    Smooth blobs make the set image-like: convnets demonstrably learn it,
    and it stays non-trivial under noise.
    """
    rng = np.random.RandomState(seed)
    # Templates come from a FIXED seed, independent of the sampling seed:
    # train and test draws (different seeds) must share the same class
    # structure or held-out accuracy is structurally stuck at chance.
    trng = np.random.RandomState(0x5EED ^ num_classes ^ (shape[0] << 8))
    templates = _smooth_templates(trng, num_classes, shape)
    y = rng.randint(0, num_classes, size=n).astype(np.int32)
    x = templates[y] * (signal / np.sqrt(np.prod(shape))) \
        + rng.randn(n, *shape).astype(np.float32) * 0.5
    return x.astype(np.float32), y


def synthetic_mnist(n: int = 4096, seed: int = 0):
    """MNIST-shaped [n,32,32,1] synthetic set (torch MNIST ships 32x32 —
    the reference reshapes to 1x32x32, examples/mnist.lua:53)."""
    x, y = _synthetic_classification(n, (32, 32, 1), 10, seed)
    return x, y, 10


def synthetic_cifar10(n: int = 4096, seed: int = 0):
    """CIFAR-shaped [n,32,32,3] synthetic set."""
    x, y = _synthetic_classification(n, (32, 32, 3), 10, seed)
    return x, y, 10


def make_templates(tag: int, num_classes: int, shape: tuple[int, ...]
                   ) -> np.ndarray:
    """The hard set's factor-``tag`` templates (a fixed seed per tag, class
    count and height), as ``synthetic_hard`` draws them in the JAX
    package."""
    return _smooth_templates(
        np.random.RandomState(0xA5EED ^ tag ^ num_classes ^ (shape[0] << 8)),
        num_classes, shape)


def synthetic_hard(n: int, shape: tuple[int, ...] = (32, 32, 3),
                   num_classes: int = 10, seed: int = 0,
                   signal: float = 8.0, label_noise: float = 0.05,
                   return_latents: bool = False):
    """A synthetic set that no linear model separates: each example
    composes two smooth templates, factor ``a`` and factor ``b``
    (``num_classes`` choices each), and its label is ``(a + b) mod C``, so
    every class mixes C modes with the same mean and a matched filter sits
    at chance; ``label_noise`` flips that fraction of labels, capping the
    reachable accuracy near ``1 - label_noise * (C - 1) / C``.  Returns
    ``(x, y)``, with the latents ``(a, b)`` too under
    ``return_latents``."""
    rng = np.random.RandomState(seed)
    C = num_classes
    ta, tb = make_templates(1, C, shape), make_templates(2, C, shape)
    a = rng.randint(0, C, size=n).astype(np.int32)
    b = rng.randint(0, C, size=n).astype(np.int32)
    y = ((a + b) % C).astype(np.int32)
    amp = signal / np.sqrt(np.prod(shape))
    x = (ta[a] + tb[b]) * amp \
        + rng.randn(n, *shape).astype(np.float32) * 0.5
    if label_noise > 0:
        flip = rng.rand(n) < label_noise
        y = np.where(flip, rng.randint(0, C, size=n).astype(np.int32), y)
    if return_latents:
        return x.astype(np.float32), y, a, b
    return x.astype(np.float32), y


def synthetic_hard_cifar10(n: int = 4096, seed: int = 0,
                           label_noise: float = 0.05):
    """CIFAR-shaped non-separable set (see :func:`synthetic_hard`)."""
    x, y = synthetic_hard(n, (32, 32, 3), 10, seed, label_noise=label_noise)
    return x, y, 10


def synthetic_imagenet(n: int = 256, image_size: int = 224,
                       num_classes: int = 1000, seed: int = 0):
    """ImageNet-shaped ``[n, S, S, 3]`` synthetic set (the ResNet-50
    configuration; no dataset downloads)."""
    x, y = _synthetic_classification(n, (image_size, image_size, 3),
                                     num_classes, seed)
    return x, y, num_classes
