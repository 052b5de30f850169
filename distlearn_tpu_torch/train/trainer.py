"""Train-step builders — counterpart of ``distlearn_tpu/train/trainer.py``.

The reference's hot loop is: dataset batch -> autograd forward and backward
-> ``tree.allReduce`` -> manual SGD update (examples/mnist.lua:99-116).  The
JAX package compiles each step into one SPMD program over a device mesh.
Here each node is a process, and a step is eager PyTorch on this node's
shard of the batch: forward and backward, the gradient allreduce over the
node group, and the update — by default (on the card) through flat buckets
and one hand-written kernel launch per bucket (:mod:`..ops.fused_update`).

* :func:`build_sgd_step` — AllReduceSGD: params replicated on every node,
  gradients summed and normalised by the contributor count
  (lua/AllReduceSGD.lua:18-30), sync batchnorm.
* :func:`build_ea_steps` — AllReduceEA: a collective-free local step and the
  elastic round; the caller runs the round every ``tau`` steps
  (lua/AllReduceEA.lua:31).

No step waits on the host: losses and counts stay on the device.  The
dropout generator in the state is advanced in place by each step.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from distlearn_tpu_torch.models.core import Model, loss_fn
from distlearn_tpu_torch.ops import flatten as flatten_lib
from distlearn_tpu_torch.ops import fused_update
from distlearn_tpu_torch.parallel import allreduce_ea, allreduce_sgd
from distlearn_tpu_torch.parallel.mesh import MeshTree
from distlearn_tpu_torch.utils import metrics as metrics_lib
from distlearn_tpu_torch.utils.tree import (tree_flatten, tree_map,
                                            tree_unflatten)

PyTree = Any


class TrainState(NamedTuple):
    """This node's AllReduceSGD state.  ``cm`` is this node's confusion
    matrix (sum over nodes at report time, ref examples/mnist.lua:120-125);
    ``rng`` the node's dropout generator."""
    params: PyTree
    model_state: PyTree      # batchnorm running stats (sync BN: replicated)
    sync: allreduce_sgd.SGDSyncState
    cm: torch.Tensor
    rng: torch.Generator


def _node_generator(seed: int, node: int, device) -> torch.Generator:
    """A dropout generator per node, the part ``fold_in(rng, axis_index)``
    plays in the JAX step."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, node]).generate_state(1)[0]))
    return g


def local_update(params: PyTree, grads: PyTree, vel: PyTree, lr: float,
                 momentum: float) -> tuple[PyTree, PyTree]:
    """The EA-family local optimizer: plain SGD (``momentum=0``, velocity
    untouched) or heavy-ball EAMSGD (arXiv:1412.6651 §3:
    ``v = mu*v + g; p -= lr*v``)."""
    sgd = fused_update.sgd_plain
    if not momentum:
        return tree_map(lambda p, g: sgd(p, g, lr), params, grads), vel
    vel = tree_map(lambda v, g: fused_update.cast_scalar(momentum, v.dtype) * v
                   + g.to(v.dtype), vel, grads)
    return tree_map(lambda p, v: sgd(p, v, lr), params, vel), vel


def value_and_grad(model: Model, params: PyTree, mstate: PyTree, x, y,
                   rng, tree: MeshTree | None, bn_weight=None):
    """Loss, log-probs, new batchnorm state and parameter gradients of one
    training forward; nothing returned carries an autograd graph."""
    leaves, treedef = tree_flatten(params)
    req = [p.detach().requires_grad_() for p in leaves]
    loss, (log_probs, mstate) = loss_fn(
        model, tree_unflatten(treedef, req), mstate, x, y, train=True,
        rng=rng, tree=tree, bn_weight=bn_weight)
    grads = torch.autograd.grad(loss, req)
    return (loss.detach(), log_probs.detach(), mstate,
            tree_unflatten(treedef, list(grads)))


def init_train_state(model: Model, tree: MeshTree, seed: int,
                     num_classes: int) -> TrainState:
    """Identical params on every node (same ``seed``), a zero step count and
    confusion matrix, and this node's dropout generator, on ``tree.device``."""
    params, mstate = model.init(seed, tree.device)
    return TrainState(
        params=params, model_state=mstate,
        sync=allreduce_sgd.init_state(tree.device),
        cm=metrics_lib.init_confusion(num_classes, tree.device),
        rng=_node_generator(seed, tree.node_index, tree.device))


def build_sgd_step(model: Model, tree: MeshTree, lr: float,
                   with_contrib: bool = False, fused: bool | None = None,
                   max_bucket_bytes: int | None = None) -> Callable:
    """One AllReduceSGD step: ``step(ts, x, y) -> (ts, loss)``.

    ``x``/``y`` are this node's shard of the global batch (NHWC images,
    integer labels).  Inside: forward and backward with sync batchnorm,
    gradient allreduce normalised by the contributor count, SGD update,
    confusion-matrix update; ``loss`` is the mean over contributing nodes.

    ``with_contrib=True`` adds a 4th argument, this node's 0/1 flag for
    whether it contributes this step (the uneven-partition case,
    lua/AllReduceSGD.lua:22-27): a non-contributor's gradient and batchnorm
    statistics are left out, it still applies the common update, and its
    step count and confusion matrix stay put.  Pair with
    :func:`build_sync_step` at the end of the epoch.

    ``fused`` (default: on for a CUDA ``tree.device``, see
    :func:`~distlearn_tpu_torch.ops.fused_update.fused_enabled`) packs the
    gradients into flat buckets: one allreduce and one
    :func:`~distlearn_tpu_torch.ops.fused_update.fused_sgd` launch per
    bucket instead of one of each per parameter.  ``max_bucket_bytes``
    caps a bucket.
    """
    use_fused = fused_update.fused_enabled(fused, tree.device)

    def _body(ts: TrainState, x, y, contrib):
        x = torch.as_tensor(x, device=tree.device)
        y = torch.as_tensor(y, device=tree.device)
        c = None if contrib is None else \
            torch.as_tensor(contrib, device=tree.device).to(torch.int32)
        loss, log_probs, mstate, grads = value_and_grad(
            model, ts.params, ts.model_state, x, y, ts.rng, tree, c)
        if use_fused:
            spec = flatten_lib.make_bucket_spec(grads, max_bucket_bytes)
            g_flats, sync, n = allreduce_sgd.sum_and_normalize_gradients(
                flatten_lib.pack_buckets(spec, grads), ts.sync, tree, c)
            params = fused_update.sgd_update_buckets(spec, ts.params, g_flats,
                                                     lr)
        else:
            grads, sync, n = allreduce_sgd.sum_and_normalize_gradients(
                grads, ts.sync, tree, c)
            params = tree_map(lambda p, g: fused_update.sgd_plain(p, g, lr),
                              ts.params, grads)
        cm = metrics_lib.update_confusion(ts.cm, log_probs, y)
        if c is None:
            mean_loss = tree.all_reduce(loss)[0] / tree.num_nodes
        else:
            cm = torch.where(c > 0, cm, ts.cm)
            total = tree.all_reduce(loss * c.to(loss.dtype))[0]
            mean_loss = total / torch.clamp(n, min=1).to(loss.dtype)
        return TrainState(params, mstate, sync, cm, ts.rng), mean_loss

    if with_contrib:
        def step(ts, x, y, contrib):
            return _body(ts, x, y, contrib)
    else:
        def step(ts, x, y):
            return _body(ts, x, y, None)
    return step


def build_sync_step(tree: MeshTree) -> Callable:
    """End-of-epoch winner-takes-all sync over a :class:`TrainState` (ref
    ``synchronizeParameters``, lua/AllReduceSGD.lua:33-54): the node with
    the most contributing steps this epoch wins, its params go to all, step
    counts reset."""

    def step(ts: TrainState) -> TrainState:
        params, sync = allreduce_sgd.synchronize_parameters(ts.params,
                                                            ts.sync, tree)
        return ts._replace(params=params, sync=sync)

    return step


def build_eval_step(model: Model, tree: MeshTree) -> Callable:
    """``eval_step(params, mstate, cm, x, y) -> (cm, loss)``: running-stat
    batchnorm, this node's confusion matrix updated, loss averaged over the
    nodes (ref examples/mnist.lua:122, cifar10.lua:234)."""

    @torch.no_grad()
    def step(params, mstate, cm, x, y):
        x = torch.as_tensor(x, device=tree.device)
        y = torch.as_tensor(y, device=tree.device)
        loss, (log_probs, _) = loss_fn(model, params, mstate, x, y,
                                       train=False)
        cm = metrics_lib.update_confusion(cm, log_probs, y)
        return cm, tree.all_reduce(loss)[0] / tree.num_nodes

    return step


# ---------------------------------------------------------------------------
# Elastic averaging (EASGD)
# ---------------------------------------------------------------------------

class EATrainState(NamedTuple):
    """This node's EASGD state: its own params (nodes diverge between
    rounds), its center replica, and the EAMSGD momentum buffer (zeros and
    untouched under plain SGD)."""
    params: PyTree
    model_state: PyTree
    center: PyTree
    vel: PyTree
    cm: torch.Tensor
    rng: torch.Generator


def init_ea_state(model: Model, tree: MeshTree, seed: int,
                  num_classes: int) -> EATrainState:
    """Identical init on every node (ref seed 0 and initial scatter,
    examples/mnist-ea.lua:63), center := params (lua/AllReduceEA.lua:11-22),
    zero momentum."""
    params, mstate = model.init(seed, tree.device)
    return EATrainState(
        params=params, model_state=mstate,
        center=tree_map(torch.clone, params),
        vel=tree_map(torch.zeros_like, params),
        cm=metrics_lib.init_confusion(num_classes, tree.device),
        rng=_node_generator(seed, tree.node_index, tree.device))


def apply_elastic_round(params: PyTree, center: PyTree, alpha: float,
                        tree: MeshTree, fused: bool,
                        max_bucket_bytes: int | None = None
                        ) -> tuple[PyTree, PyTree]:
    """One elastic round on this node's pytrees: packed buckets and the
    :func:`~distlearn_tpu_torch.ops.fused_update.fused_elastic` kernel when
    ``fused``, the per-leaf round otherwise."""
    if fused:
        return fused_update.elastic_round_buckets(params, center, alpha, tree,
                                                  max_bucket_bytes)
    params, st = allreduce_ea.elastic_round(
        params, allreduce_ea.EAState(center=center, step=None), alpha, tree)
    return params, st.center


def build_ea_steps(model: Model, tree: MeshTree, lr: float, alpha: float,
                   fused: bool | None = None,
                   max_bucket_bytes: int | None = None,
                   momentum: float = 0.0) -> tuple[Callable, Callable]:
    """Returns ``(local_step, ea_round)``.

    ``local_step(ts, x, y) -> (ts, loss)``: gradient and local update with no
    collective (the quiet steps, ref examples/mnist-ea.lua:100-107);
    batchnorm statistics are this node's own, as in the reference.
    ``loss`` is this node's.

    ``ea_round(ts) -> ts``: the elastic round (lua/AllReduceEA.lua:35-45) —
    with ``fused`` (default on the card) one kernel launch and one allreduce
    per bucket.

    ``momentum > 0`` makes the local optimizer heavy-ball SGD, EAMSGD
    (arXiv:1412.6651 §3): ``v = mu*v + g; p -= lr*v``.
    """
    use_fused = fused_update.fused_enabled(fused, tree.device)

    def local_step(ts: EATrainState, x, y):
        x = torch.as_tensor(x, device=tree.device)
        y = torch.as_tensor(y, device=tree.device)
        loss, log_probs, mstate, grads = value_and_grad(
            model, ts.params, ts.model_state, x, y, ts.rng, None)
        params, vel = local_update(ts.params, grads, ts.vel, lr, momentum)
        cm = metrics_lib.update_confusion(ts.cm, log_probs, y)
        return EATrainState(params, mstate, ts.center, vel, cm, ts.rng), loss

    def ea_round(ts: EATrainState) -> EATrainState:
        params, center = apply_elastic_round(ts.params, ts.center, alpha, tree,
                                             use_fused, max_bucket_bytes)
        return ts._replace(params=params, center=center)

    return local_step, ea_round
