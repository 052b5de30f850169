"""The communication layer — counterpart of ``distlearn_tpu/parallel/mesh.py``
(the reference's torch-ipc ``tree``: ``tree.allReduce``, ``tree.scatter``,
``tree.nodeIndex``, ``tree.numNodes``; examples/mnist.lua:16).

In the JAX package a node is a device of a mesh and one SPMD program drives
them all.  Here a node is a process of a ``torch.distributed`` process group
(NCCL on the card, gloo on the CPU), each holding its own values, and each
collective is a call on that group.  :func:`init_mesh` starts the group;
nothing here finds a cluster by itself.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from distlearn_tpu_torch.utils.platform import resolve_device
from distlearn_tpu_torch.utils.tree import tree_map

PyTree = Any


class MeshTree:
    """This process's handle on the group of nodes.

    ``num_nodes``/``node_index`` mirror ``tree.numNodes``/``tree.nodeIndex``
    (0-based here).  Values are this node's own pytrees of tensors on
    ``device``; every collective returns new tensors and leaves its
    inputs as they were.
    """

    def __init__(self, device=None, group=None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized; "
                               "start it with init_mesh()")
        self.device = resolve_device(device)
        self.group = group
        self.num_nodes = dist.get_world_size(group)
        self.node_index = dist.get_rank(group)

    def all_reduce(self, tree: PyTree, contrib=None
                   ) -> tuple[PyTree, torch.Tensor]:
        """Sum a pytree over the nodes; returns ``(reduced, n)`` with ``n``
        the number of contributing nodes (ref ``tree.allReduce(value, add)
        -> _, n``, lua/AllReduceSGD.lua:12).  ``contrib`` is this node's 0/1
        participation flag: a non-contributor's values are zeroed before the
        sum and ``n`` counts the flags.  ``n`` stays on the device (int32)."""
        if contrib is None:
            n = torch.full((), self.num_nodes, dtype=torch.int32,
                           device=self.device)

            def _sum(x):
                out = x.clone()
                dist.all_reduce(out, group=self.group)
                return out
            return tree_map(_sum, tree), n
        c = torch.as_tensor(contrib, device=self.device).to(torch.int32)
        n = c.reshape(1).clone()
        dist.all_reduce(n, group=self.group)

        def _masked_sum(x):
            out = x * c.to(x.dtype)
            dist.all_reduce(out, group=self.group)
            return out
        return tree_map(_masked_sum, tree), n[0]

    def broadcast_from(self, tree: PyTree, src: int) -> PyTree:
        """Node ``src``'s values on every node (ref ``tree.scatter``,
        lua/AllReduceSGD.lua:52, lua/AllReduceEA.lua:83,93)."""
        if not 0 <= src < self.num_nodes:
            raise ValueError(f"src={src} out of range for {self.num_nodes} nodes")
        gsrc = dist.get_global_rank(self.group, src) \
            if self.group is not None else src

        def _bcast(x):
            out = x.clone()
            dist.broadcast(out, gsrc, group=self.group)
            return out
        return tree_map(_bcast, tree)

    def all_gather_scalar(self, x: torch.Tensor) -> torch.Tensor:
        """Every node's scalar ``x`` as a ``[num_nodes]`` vector."""
        x = x.reshape(1)
        parts = [torch.empty_like(x) for _ in range(self.num_nodes)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts)


def init_mesh(rank: int = 0, world_size: int = 1,
              init_method: str | None = None, store=None,
              device=None) -> MeshTree:
    """Start the default process group and return its :class:`MeshTree`.

    NCCL when ``device`` is CUDA (the default; each rank takes the card
    ``device`` names, or ``cuda:0``), gloo for ``device="cpu"``.  Give the
    rendezvous as ``init_method`` (``"tcp://localhost:<port>"``) or a
    ``store``.  Shut down with ``torch.distributed.destroy_process_group()``.
    """
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"store": store} if store is not None else {"init_method": init_method}
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            rank=rank, world_size=world_size, **kw)
    return MeshTree(device=device)
