"""Synchronous elastic averaging (EASGD) — counterpart of
``distlearn_tpu/parallel/allreduce_ea.py`` (reference: lua/AllReduceEA.lua
and the math note lua/AllReduceEA.md:12-24).  Every node keeps a replica of
the center; every ``tau``-th local step each node does

    delta  = (params - center) * alpha
    params = params - delta                 # elastic pull toward the center
    center = center + allreduce_sum(delta)  # the center moves toward the nodes

Rounds are full-participation: when any node is due, all nodes run the round
(see the JAX module's docstring for why this is the reference's semantics).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from distlearn_tpu_torch.ops.fused_update import cast_scalar
from distlearn_tpu_torch.parallel.mesh import MeshTree
from distlearn_tpu_torch.utils.tree import tree_leaves, tree_map

PyTree = Any


class EAState(NamedTuple):
    """This node's center replica and local step count (ref ``center`` and
    ``step``, lua :5, :11-22)."""
    center: PyTree
    step: torch.Tensor     # int32 scalar on the device


def init_state(params: PyTree) -> EAState:
    """Clone params as the initial center (ref ``oneTimeInit``, lua :11-22)."""
    device = tree_leaves(params)[0].device
    return EAState(center=tree_map(torch.clone, params),
                   step=torch.zeros((), dtype=torch.int32, device=device))


def elastic_round(params: PyTree, state: EAState, alpha: float,
                  tree: MeshTree) -> tuple[PyTree, EAState]:
    """One elastic-averaging round, per leaf (ref lua :35-45 / md :12-24)."""
    delta = tree_map(lambda p, c: (p - c) * cast_scalar(alpha, p.dtype),
                     params, state.center)
    new_params = tree_map(lambda p, d: p - d, params, delta)
    sum_delta, _ = tree.all_reduce(delta)
    new_center = tree_map(lambda c, d: c + d, state.center, sum_delta)
    return new_params, EAState(center=new_center, step=state.step)


def average_parameters(params: PyTree, state: EAState, tau: int,
                       alpha: float, tree: MeshTree, contrib=None
                       ) -> tuple[PyTree, EAState]:
    """Per-step entry point (ref ``averageParameters``, lua :25-47): bumps
    this node's step count and, when any node's count reaches a ``tau``
    boundary, runs the full-participation round.  Deciding that waits on the
    host once per call; trainers call :func:`elastic_round` every ``tau``
    steps instead."""
    c = torch.ones((), dtype=torch.int32, device=state.step.device) \
        if contrib is None else \
        torch.as_tensor(contrib, device=state.step.device).to(torch.int32)
    step = state.step + c
    due = ((c > 0) & (step % tau == 0)).to(torch.int32).reshape(1)
    dist.all_reduce(due, group=tree.group)
    st = EAState(center=state.center, step=step)
    if int(due[0]) > 0:
        return elastic_round(params, st, alpha, tree)
    return params, st


def synchronize_center(params: PyTree, state: EAState, tree: MeshTree
                       ) -> tuple[PyTree, EAState]:
    """End-of-epoch center sync (ref ``synchronizeCenter``, lua :77-84):
    node 0's center replica to every node, step count reset."""
    return params, EAState(center=tree.broadcast_from(state.center, 0),
                           step=torch.zeros_like(state.step))


def synchronize_parameters(params: PyTree, state: EAState, tree: MeshTree
                           ) -> tuple[PyTree, EAState]:
    """Identical params on all nodes (ref lua :87-100): node 0's params to
    every node, center := params."""
    synced = tree.broadcast_from(params, 0)
    return synced, EAState(center=tree_map(torch.clone, synced),
                           step=torch.zeros_like(state.step))


class AllReduceEA:
    """The reference closure API, ``AllReduceEA(tree, tau, alpha)``
    (lua :2), for one node per process.  Rounds pair up by ordinal across
    nodes, as in the reference (lua :31: a due node blocks in
    ``tree.allReduce`` until every peer reaches its own next call), so every
    process must reach its ``tau`` boundaries on the same calls."""

    def __init__(self, tree: MeshTree, tau: int, alpha: float):
        self.tree = tree
        self.tau = int(tau)
        self.alpha = float(alpha)
        self._center = None
        self._steps = 0

    def _one_time_init(self, params: PyTree):
        """Ref ``oneTimeInit`` (lua :11-22): clone params as the center."""
        if self._center is None:
            self._center = tree_map(torch.clone, params)

    def average_parameters(self, params: PyTree, contrib=None) -> PyTree:
        """Ref lua :25-47: bump the step count; at a ``tau`` boundary run
        the elastic round."""
        self._one_time_init(params)
        if contrib is None or bool(contrib):
            self._steps += 1
            if self._steps % self.tau == 0:
                params, st = elastic_round(
                    params, EAState(self._center, None), self.alpha, self.tree)
                self._center = st.center
        return params

    def synchronize_center(self, params: PyTree) -> PyTree:
        """Ref lua :77-84: node 0's center to everyone, step reset."""
        self._one_time_init(params)
        self._center = self.tree.broadcast_from(self._center, 0)
        self._steps = 0
        return params

    def synchronize_parameters(self, params: PyTree) -> PyTree:
        """Ref lua :87-100: node 0's params to everyone, center := params."""
        params = self.tree.broadcast_from(params, 0)
        self._center = tree_map(torch.clone, params)
        self._steps = 0
        return params
