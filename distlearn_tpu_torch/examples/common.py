"""Shared plumbing of the convnet examples — counterpart of the JAX
package's ``examples/common.py``.

Where the JAX package runs every node as a device of one SPMD program, the
port runs one process a node (the reference's ``th mnist.lua --nodeIndex i
&`` of examples/mnist.sh): :func:`launch` spawns ``--numNodes`` ranks with
``torch.multiprocessing`` and a ``tcp://localhost`` rendezvous, NCCL over
one card a rank, or gloo for ``--device cpu``.  A single node runs in the
calling process.  Every rank walks the same global batches and takes its
own rows of each (``ceil(B/N)`` a node, examples/cifar10.lua:36, with B a
multiple of N as the JAX package's data-axis sharding needs), so the run
is the JAX example's.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from distlearn_tpu_torch.data import batch_iterator, prefetch_to_device
from distlearn_tpu_torch.parallel.mesh import init_mesh, local_init_method
from distlearn_tpu_torch.utils.platform import (available_nodes, rank_device,
                                                resolve_device)

#: The JAX package's checkpoint flags (``utils/flags.py::CKPT_FLAGS``).
CKPT_FLAGS = {
    "save": ("", "checkpoint dir (empty = off)"),
    "resume": (False, "resume from the newest checkpoint in --save"),
}

def resolve_num_nodes(requested: int, device: torch.device) -> int:
    """Clamp ``--numNodes`` to the cards present, with the JAX package's
    warning: the reference time-slices processes on one GPU
    (examples/cifar10-cuda.sh), while here a node is a rank with a card of
    its own.  CPU ranks are not limited."""
    avail = available_nodes(device)
    if avail is not None and requested > avail:
        print(f"[distlearn_tpu_torch] --numNodes {requested} exceeds the "
              f"{avail} attached GPU(s); running {avail} node(s). (The "
              "reference time-slices processes per GPU; here each node "
              "needs a device of its own.)", file=sys.stderr, flush=True)
        return avail
    return requested


def node_rows(global_batch: int, rank: int, num_nodes: int) -> slice:
    """This node's rows of a global batch."""
    if global_batch % num_nodes:
        raise SystemExit(f"--batchSize {global_batch} must be a multiple of "
                         f"the {num_nodes} nodes")
    per = global_batch // num_nodes
    return slice(rank * per, (rank + 1) * per)


class _NodeSampler:
    """A sampler's global batches cut to this node's rows."""

    def __init__(self, sampler, rows: slice):
        self.sampler, self.rows = sampler, rows

    def epoch(self, batch_size: int) -> Iterator[np.ndarray]:
        for idx in self.sampler.epoch(batch_size):
            yield idx[self.rows]


def node_sampler(sampler, batch: int, rank: int, num_nodes: int):
    return _NodeSampler(sampler, node_rows(batch, rank, num_nodes))


def device_stream(ds, sampler, batch: int, device, rank: int = 0,
                  num_nodes: int = 1, prefetch: int = 2) -> Iterator[tuple]:
    """This node's rows of each global batch, on ``device`` through the
    prefetch queue."""
    return prefetch_to_device(
        batch_iterator(ds, node_sampler(sampler, batch, rank, num_nodes),
                       batch), size=prefetch, device=device)


def device_stream_stacked(ds, sampler, batch: int, k: int, device,
                          rank: int = 0, num_nodes: int = 1,
                          prefetch: int = 2) -> Iterator[tuple]:
    """``k`` consecutive batches as one ``[k, B/N, ...]`` group for the
    scanned steps (``build_sgd_scan_step``, ``build_ea_cycle``); a
    shorter last group comes as it is (one more capture on the card)."""
    def groups():
        xs, ys = [], []
        for bx, by in batch_iterator(
                ds, node_sampler(sampler, batch, rank, num_nodes), batch):
            xs.append(bx)
            ys.append(by)
            if len(xs) == k:
                yield np.stack(xs), np.stack(ys)
                xs, ys = [], []
        if xs:
            yield np.stack(xs), np.stack(ys)
    return prefetch_to_device(groups(), size=prefetch, device=device)


def _run_node(rank: int, train: Callable, opt, num_nodes: int,
              init_method: str) -> None:
    device = rank_device(resolve_device(opt.device), rank)
    if device.type == "cpu" and num_nodes > 1 \
            and "OMP_NUM_THREADS" not in os.environ:
        # the CPU ranks share the host's cores, unless the caller says
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // num_nodes))
    tree = init_mesh(rank, num_nodes, init_method=init_method, device=device)
    try:
        train(opt, tree)
    finally:
        dist.destroy_process_group()


def launch(train: Callable, opt, num_nodes: int) -> None:
    """Run ``train(opt, tree)`` on every node, ``tree`` the node's
    :class:`~distlearn_tpu_torch.parallel.mesh.MeshTree`: in this process
    for one node, else in spawned ranks (``train`` must be a module-level
    function).  The process group is destroyed when ``train`` returns."""
    init_method = local_init_method()
    if num_nodes == 1:
        _run_node(0, train, opt, 1, init_method)
        return
    import torch.multiprocessing as mp
    mp.start_processes(_run_node, args=(train, opt, num_nodes, init_method),
                       nprocs=num_nodes, start_method="spawn")
