"""Synchronous data-parallel gradient averaging — counterpart of
``distlearn_tpu/parallel/allreduce_sgd.py`` (reference: lua/AllReduceSGD.lua).

* ``sum_gradients``             — allreduce-sum gradients (lua :10-15)
* ``sum_and_normalize_gradients`` — the same, scaled by ``1/n`` where ``n``
  counts the nodes that contributed this step (lua :18-30)
* ``synchronize_parameters``    — end-of-epoch sync: the node with the most
  steps wins and its params go to everyone (lua :33-54)

The in-step functions take and return this node's state explicitly and keep
every count on the device, so a step never waits on the host.
:class:`AllReduceSGD` is the reference's closure API over a :class:`MeshTree`.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from distlearn_tpu_torch.parallel.mesh import MeshTree
from distlearn_tpu_torch.utils.tree import tree_map

PyTree = Any


class SGDSyncState(NamedTuple):
    """This node's step count this epoch (ref ``stepsPerNode``, lua :7):
    an int32 scalar tensor on the device."""
    my_steps: torch.Tensor


def init_state(device) -> SGDSyncState:
    return SGDSyncState(my_steps=torch.zeros((), dtype=torch.int32,
                                             device=device))


def sum_gradients(grads: PyTree, state: SGDSyncState, tree: MeshTree,
                  contrib=None) -> tuple[PyTree, SGDSyncState, torch.Tensor]:
    """Allreduce-sum gradients across nodes (ref lua :10-15).  Returns
    ``(summed, new_state, n_contributors)``; ``contrib`` is this node's 0/1
    flag (default: contributing)."""
    summed, n = tree.all_reduce(grads, contrib=contrib)
    c = 1 if contrib is None else \
        torch.as_tensor(contrib, device=tree.device).to(torch.int32)
    return summed, SGDSyncState(my_steps=state.my_steps + c), n


def sum_and_normalize_gradients(grads: PyTree, state: SGDSyncState,
                                tree: MeshTree, contrib=None
                                ) -> tuple[PyTree, SGDSyncState, torch.Tensor]:
    """Allreduce-sum then scale by ``1/n`` contributors, or by 0 when no
    node contributed (ref lua :18-30)."""
    summed, new_state, n = sum_gradients(grads, state, tree, contrib)
    nf = n.to(torch.float32)
    scale = torch.where(n > 0, 1.0 / torch.clamp(nf, min=1),
                        torch.zeros_like(nf))
    return tree_map(lambda g: g * scale.to(g.dtype), summed), new_state, n


def synchronize_parameters(params: PyTree, state: SGDSyncState,
                           tree: MeshTree) -> tuple[PyTree, SGDSyncState]:
    """Winner-takes-all end-of-epoch sync (ref lua :33-54).

    The node with the most steps wins, ties going to the highest index (the
    last element of the reference's ``stepsPerNode:sort()``, lua :41); node 0
    when no node stepped (the reference's plain scatter from root, lua :52).
    As in the JAX package, the winner's params reach everyone through a
    masked sum, so the choice stays on the device and every node ends
    bitwise identical."""
    steps = tree.all_gather_scalar(state.my_steps)           # [num_nodes]
    last_max = tree.num_nodes - 1 - torch.argmax(torch.flip(steps, (0,)))
    winner = torch.where(torch.max(steps) > 0, last_max,
                         torch.zeros_like(last_max))
    mine = winner == tree.node_index

    def _take(p):
        out = torch.where(mine, p, torch.zeros_like(p))
        dist.all_reduce(out, group=tree.group)
        return out
    return tree_map(_take, params), SGDSyncState(
        my_steps=torch.zeros_like(state.my_steps))


class AllReduceSGD:
    """The reference closure API, ``AllReduceSGD(tree)`` (lua :4), for one
    node per process: plain pytrees of this node's tensors, step counts kept
    on the host and allreduced at sync time (lua :13-14, :39)."""

    def __init__(self, tree: MeshTree):
        self.tree = tree
        self._steps = np.zeros(tree.num_nodes, dtype=np.int64)

    def sum_gradients(self, grads: PyTree, contrib=None) -> tuple[PyTree, int]:
        """Ref lua :10-15.  Returns ``(summed, n)``."""
        out, n = self.tree.all_reduce(grads, contrib=contrib)
        self._bump(contrib)
        return out, int(n)

    def sum_and_normalize_gradients(self, grads: PyTree, contrib=None
                                    ) -> tuple[PyTree, int]:
        """Ref lua :18-30."""
        out, n = self.tree.all_reduce(grads, contrib=contrib)
        n = int(n)
        if n > 1:
            out = tree_map(lambda g: g / n, out)
        self._bump(contrib)
        return out, n

    def _bump(self, contrib):
        if contrib is None or bool(contrib):
            self._steps[self.tree.node_index] += 1

    def synchronize_parameters(self, params: PyTree) -> PyTree:
        """Ref lua :33-54: winner-takes-all (most steps, ties to the highest
        index), or a scatter from node 0 when no node stepped this epoch."""
        red, _ = self.tree.all_reduce(torch.from_numpy(self._steps)
                                      .to(self.tree.device))
        steps = red.cpu().numpy()
        src = int(len(steps) - 1 - np.argmax(steps[::-1])) \
            if steps.max() > 0 else 0
        self._steps[:] = 0
        return self.tree.broadcast_from(params, src)
