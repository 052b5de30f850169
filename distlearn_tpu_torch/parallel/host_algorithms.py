"""Host-side AllReduceSGD / AllReduceEA over the TCP tree or ring —
counterpart of ``distlearn_tpu/parallel/host_algorithms.py``.

These are the literal reference semantics (lua/AllReduceSGD.lua,
lua/AllReduceEA.lua) for deployments where nodes are OS processes, the
process-per-node shape of the original framework (examples/mnist.sh
spawning N ``th`` processes): each process trains on its own device and
syncs through :class:`~distlearn_tpu_torch.comm.tree.Tree` or
:class:`~distlearn_tpu_torch.comm.ring.Ring`.

Parameters are numpy arrays (the JAX package's arithmetic, unchanged) or
torch tensors, which stay on their device: the collectives stage them
through the handle's frame and return tensors on the same device.  With
float32 tensors the elastic move is kernel B2
(``ops/fused_update.py::fused_elastic``, one launch a flat bucket, its
plain twin on the CPU); its deltas go on the wire as the per-leaf views of
their buckets, in the JAX leaf order, so the wire carries what the JAX
package's round sends and a port rank's parameters and center equal a JAX
rank's bit for bit.

**Uneven-step protocol.**  Reductions are blocking and pair by ordinal:
node A's k-th allreduce completes against every other node's k-th
allreduce.  Nodes run different step counts per epoch, so a node that
finished early must keep *serving* stragglers' rounds from inside its sync
call — the reference does this with torch-ipc's flush mode
(``tree.allReduce(nil, add, zeroFn)``, lua/AllReduceSGD.lua:37; inline EA
callback, lua/AllReduceEA.lua:58-68).  Every round carries a ``flush``
rider counting how many participants are in their sync call; the sync loop
serves rounds (zero-contribution for SGD, real elastic contributions for
EA — the reference's two flush flavors) until a round reports all nodes
flushing, which is the terminal round.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from distlearn_tpu_torch.comm.backend import tensor_device
from distlearn_tpu_torch.ops import flatten as flatten_lib
from distlearn_tpu_torch.ops import fused_update
from distlearn_tpu_torch.utils.tree import tree_leaves, tree_map

PyTree = Any


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return np.array(x, dtype=np.asarray(x).dtype, copy=True)


def _zeros_like(x):
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    return np.zeros_like(x)


class TreeAllReduceSGD:
    """Reference lua/AllReduceSGD.lua over a TCP tree or ring (API:
    sumGradients / sumAndNormalizeGradients / synchronizeParameters,
    lua :56-60)."""

    def __init__(self, tree):
        self.tree = tree
        self.my_steps = 0   # own slot of stepsPerNode (ref lua :7)

    def _round(self, grads: PyTree, contrib: bool, flushing: bool
               ) -> tuple[PyTree, int, int]:
        """One ordinal-paired reduction round: gradient sum + contributor
        count + flush count (rider is summed across all ranks regardless of
        ``contrib``)."""
        return self.tree.all_reduce_ex(grads, contrib=contrib,
                                       rider=1 if flushing else 0)

    def sum_gradients(self, grads: PyTree, contrib: bool = True
                      ) -> tuple[PyTree, int]:
        """Ref lua :10-15: allreduce-sum grads, bump own step count."""
        out, n, _ = self._round(grads, contrib, flushing=False)
        if contrib:
            self.my_steps += 1
        return out, n

    def sum_and_normalize_gradients(self, grads: PyTree, contrib: bool = True
                                    ) -> tuple[PyTree, int]:
        """Ref lua :18-30: sum then scale by 1/n contributors, on the
        leaves' device.  Tensors divide by ``n`` as a tensor on their
        device: a division by a Python scalar may run as a multiply by its
        reciprocal on the card, which is not the JAX package's rounding."""
        out, n = self.sum_gradients(grads, contrib)
        if n > 1:
            divisors = {}

            def norm(g):
                if isinstance(g, torch.Tensor):
                    key = (g.dtype, g.device)
                    if key not in divisors:
                        divisors[key] = torch.tensor(n, dtype=g.dtype,
                                                     device=g.device)
                    return g / divisors[key]
                return g / np.asarray(n, g.dtype)
            out = tree_map(norm, out)
        return out, n

    def synchronize_parameters(self, params: PyTree) -> PyTree:
        """Ref lua :33-54.  Serve stragglers' gradient rounds with zero
        contributions (the ``zeroFn`` flush, lua :37) until every node is
        here; then allreduce the step counts, winner = max steps (ties →
        highest rank, matching ``stepsPerNode:sort()`` taking the last
        element, lua :41); non-winners zero their params; one final allreduce
        leaves the winner's params everywhere — bitwise (the reference's own
        oracle, test/test_AllReduceSGD.lua:38).  If NO node stepped: scatter
        from root (lua :52)."""
        zeros = tree_map(_zeros_like, params)
        while True:
            _, _, n_flush = self._round(zeros, contrib=False, flushing=True)
            if n_flush == self.tree.num_nodes:
                break
        steps_vec = np.zeros(self.tree.num_nodes, np.int64)
        steps_vec[self.tree.rank] = self.my_steps
        all_steps, _ = self.tree.all_reduce(steps_vec)
        if int(all_steps.max()) > 0:
            rev = all_steps[::-1]
            winner = len(all_steps) - 1 - int(np.argmax(rev))
            mine = params if self.tree.rank == winner else zeros
            synced, _ = self.tree.all_reduce(mine)
        else:
            synced = self.tree.scatter(params)
        self.my_steps = 0
        return synced


class TreeAllReduceEA:
    """Reference lua/AllReduceEA.lua over a TCP tree or ring (API:
    averageParameters / synchronizeCenter / synchronizeParameters,
    lua :102-106).  ``rounds`` counts the elastic rounds this rank ran,
    flush rounds included."""

    def __init__(self, tree, tau: int, alpha: float):
        self.tree = tree
        self.tau = int(tau)
        self.alpha = float(alpha)
        self.step = 0
        self.rounds = 0
        self.center: PyTree | None = None

    def _one_time_init(self, params: PyTree):
        """Ref lua :11-22: lazily clone params as the center replica."""
        if self.center is None:
            self.center = tree_map(_clone, params)

    def _elastic_move(self, params: PyTree) -> tuple[PyTree, PyTree]:
        """``delta = (p - c) * alpha; p' = p - delta`` (ref lua :35-39):
        B2 over flat buckets for tensors, numpy's two roundings for host
        arrays.  Returns ``(p', delta)``, the deltas as per-leaf views of
        their buckets (no padding)."""
        if tensor_device(tree_leaves(params)) is None:
            delta = tree_map(
                lambda p, c: (np.asarray(p) - c)
                * np.asarray(self.alpha, np.asarray(p).dtype),
                params, self.center)
            return tree_map(lambda p, d: np.asarray(p) - d, params,
                            delta), delta
        spec, new_p, delta, _ = fused_update.elastic_move_buckets(
            params, self.center, self.alpha)
        return (flatten_lib.unpack_buckets(spec, new_p),
                flatten_lib.unpack_buckets(spec, delta))

    def _round(self, params: PyTree, flushing: bool) -> tuple[PyTree, int]:
        """One elastic round (ref lua :35-45): delta=(p-c)*alpha, p-=delta,
        allreduce deltas, center+=Σdelta.  Flush rounds contribute REAL
        deltas (the reference's inline callback, lua :58-68)."""
        new_params, delta = self._elastic_move(params)
        summed, _, n_flush = self.tree.all_reduce_ex(
            delta, rider=1 if flushing else 0)
        self.center = tree_map(lambda c, d: c + d, self.center, summed)
        self.rounds += 1
        return new_params, n_flush

    def average_parameters(self, params: PyTree) -> PyTree:
        """Ref lua :25-47: every tau-th local step runs one elastic round;
        other steps are communication-free (lua :31)."""
        self._one_time_init(params)
        self.step += 1
        if self.step % self.tau != 0:
            return params
        new_params, _ = self._round(params, flushing=False)
        return new_params

    def _drain(self, params: PyTree) -> PyTree:
        """Serve stragglers' rounds with real elastic contributions until all
        nodes are draining (ref handleUnevenSteps, lua :50-72)."""
        self._one_time_init(params)
        while True:
            params, n_flush = self._round(params, flushing=True)
            if n_flush == self.tree.num_nodes:
                return params

    def synchronize_center(self, params: PyTree) -> PyTree:
        """Ref lua :77-84: drain uneven rounds, then scatter the root's
        center (fp-drift repair), reset the step counter."""
        params = self._drain(params)
        self.center = self.tree.scatter(self.center)
        self.step = 0
        return params

    def synchronize_parameters(self, params: PyTree) -> PyTree:
        """Ref lua :87-100: drain, scatter params from root, center :=
        params."""
        if self.center is not None:
            params = self._drain(params)
        else:
            self._one_time_init(params)
        params = self.tree.scatter(params)
        self.center = tree_map(_clone, params)
        self.step = 0
        return params
