"""Host-to-device batch streaming with prefetch — counterpart of
``distlearn_tpu/data/prefetch.py``.

The reference's torch-dataset stages batches on a native thread pool (and
can land them on the GPU, examples/Data.lua:27).  Here each batch is copied
into page-locked host memory and sent to the card on a side stream, up to
``size`` batches ahead of the consumer, so the copies overlap the training
steps: the consumer's stream waits on the batch's event, not the host.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterator

import numpy as np
import torch

from distlearn_tpu_torch import obs
from distlearn_tpu_torch.utils.platform import resolve_device


def batch_iterator(dataset, sampler, batch_size: int,
                   processor: Callable | None = None) -> Iterator[tuple]:
    """Yield ``(x, y)`` numpy batches for one epoch (gather and an optional
    processor — the reference's sampledBatcher processor fn,
    examples/cifar10.lua:58-66)."""
    for idx in sampler.epoch(batch_size):
        x, y = dataset.x[idx], dataset.y[idx]
        if processor is not None:
            x, y = processor(x, y)
        yield x, y


def prefetch_to_device(it: Iterator, size: int = 2,
                       device=None) -> Iterator[tuple]:
    """Wrap a host iterator of tuples of arrays with a depth-``size`` queue
    of batches already on ``device`` (the card unless the CPU is asked
    for).

    On the card each array goes into a pinned buffer and onto a side
    stream; the yielded tensors carry that copy's event (the current
    stream waits on it) and are recorded on the current stream, so the
    allocator does not hand their memory to a later copy while a step
    still reads them.  The pinned allocator keeps each host buffer until
    its copy is done.  On the CPU the arrays come back as tensors.
    """
    device = resolve_device(device)
    queue: collections.deque = collections.deque()
    # depth at each yield: a gauge stuck at 0 means the consumer outruns
    # batch assembly (the steps wait on the input)
    depth = obs.gauge("data_prefetch_depth",
                      "batches in flight in the device prefetch queue")
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(batch):
        host = [torch.from_numpy(np.ascontiguousarray(b)) for b in batch]
        if side is None:
            return host, None
        with torch.cuda.stream(side):
            dev = [h.pin_memory().to(device, non_blocking=True)
                   for h in host]
            done = torch.cuda.Event()
            done.record(side)
        return dev, done

    def take():
        tensors, done = queue.popleft()
        depth.set(len(queue))
        if done is not None:
            cur = torch.cuda.current_stream(device)
            cur.wait_event(done)
            for t in tensors:
                t.record_stream(cur)
        return tuple(tensors)

    for batch in it:
        queue.append(put(batch))
        if len(queue) >= size:
            yield take()
    while queue:
        yield take()
