"""Device-resident datasets — counterpart of
``distlearn_tpu/data/device_dataset.py``: batches gathered on the card.

The reference's torch-dataset has a ``cuda`` batcher flag that lands each
batch in GPU memory (examples/Data.lua:27).  Here the whole dataset goes to
the device once; each batch then moves only its int32 index vector (a few
hundred bytes) and is gathered there by ``index_select``.  For datasets
that fit in device memory (MNIST and CIFAR scale); others stream through
:mod:`distlearn_tpu_torch.data.prefetch`.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from distlearn_tpu_torch import obs
from distlearn_tpu_torch.utils.platform import resolve_device


class DeviceDataset:
    """``(x, y)`` resident on ``device`` (the card unless the CPU is asked
    for); :meth:`gather` makes a batch from host indices, :meth:`take` from
    indices already on the device (what a captured train step reads)."""

    def __init__(self, x: np.ndarray, y: np.ndarray, num_classes: int,
                 device=None):
        self.device = resolve_device(device)
        self.x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        self.y = torch.from_numpy(np.ascontiguousarray(y)).to(self.device)
        self.num_classes = num_classes

    @property
    def size(self) -> int:
        return int(self.y.shape[0])

    def batches_per_epoch(self, batch_size: int) -> int:
        return self.size // batch_size

    def take(self, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The batch at the device index vector ``idx``."""
        return self.x.index_select(0, idx), self.y.index_select(0, idx)

    def gather(self, idx) -> tuple[torch.Tensor, torch.Tensor]:
        """One batch: the int32 index vector is all that crosses to the
        device.  The span ``data.gather`` covers the index vector's copy
        and the two ``index_select`` launches."""
        with obs.span("data.gather"):
            idx = torch.from_numpy(np.ascontiguousarray(idx, np.int32))
            return self.take(idx.to(self.device))

    def batches(self, sampler, batch_size: int) -> Iterator[tuple]:
        """One epoch of device-resident batches drawn by a
        :mod:`~distlearn_tpu_torch.data.samplers` sampler."""
        for idx in sampler.epoch(batch_size):
            yield self.gather(idx)
