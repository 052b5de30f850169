"""General optimizers in the replicated data-parallel step, and ZeRO-1 —
the convnet half of ``distlearn_tpu/train/optim.py`` (the reference's
``optim`` library slot, SURVEY.md §2b).

The JAX package drops any optax ``GradientTransformation`` into its fused
step.  The port has its own small optax-shaped transformations,
``(init, update)`` pairs over pytrees of tensors: :func:`sgd` (with
momentum and Nesterov), :func:`adam`, :func:`adamw`, :func:`chain`,
:func:`clip_by_global_norm`, :func:`cosine_decay_schedule` and
:func:`warmup_cosine_decay_schedule`.  They follow optax's arithmetic
order and compute in float32, counts (int32) and schedules included, so
they can be held against optax step by step.  ``torch.optim`` is not used:
it updates parameter objects, while ZeRO-1 and :func:`_check_elementwise`
need an update over a bare flat slice.

* :func:`build_optax_step` — the AllReduceSGD step with ``tx.update`` in
  place of the bare SGD rule, optionally over ``accum_steps``
  microbatches.
* :func:`build_zero_optax_step` — ZeRO-1: the optimizer state of this rank
  covers only its ``1/n`` slice of the packed parameters.  On NCCL the
  gradient is a ``reduce_scatter_tensor`` of the packed gradients, on gloo
  (which has no reduce-scatter) an allreduce and this rank's slice; the
  group's backend picks the route.  One ``all_gather_into_tensor``
  reassembles the parameters.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

from distlearn_tpu_torch.models.core import Model
from distlearn_tpu_torch.ops import flatten as flatten_lib
from distlearn_tpu_torch.ops.fused_update import cast_scalar
from distlearn_tpu_torch.parallel import allreduce_sgd
from distlearn_tpu_torch.parallel.mesh import MeshTree
from distlearn_tpu_torch.train.trainer import (_timed, init_common,
                                               value_and_grad)
from distlearn_tpu_torch.utils import metrics as metrics_lib
from distlearn_tpu_torch.utils.tree import tree_leaves, tree_map

PyTree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]

_F32 = torch.float32
_INT32_MAX = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# The transformations
# ---------------------------------------------------------------------------

class GradientTransformation(NamedTuple):
    """``init(params) -> state``; ``update(updates, state, params=None) ->
    (updates, state)``, as optax's."""
    init: Callable
    update: Callable


class EmptyState(NamedTuple):
    pass


class CountState(NamedTuple):
    count: torch.Tensor           # int32 scalar on the params' device


class TraceState(NamedTuple):
    trace: PyTree


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: PyTree
    nu: PyTree


def _count(params: PyTree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _increment(count: torch.Tensor) -> torch.Tensor:
    """``count + 1``, staying at the int32 maximum (optax's
    ``safe_increment``)."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def _f32(x: float) -> float:
    return cast_scalar(x, _F32)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    """The transformations one after another."""
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new = []
        for tx, st in zip(txs, state):
            updates, st = tx.update(updates, st, params)
            new.append(st)
        return updates, tuple(new)
    return GradientTransformation(init, update)


def scale(step_size: float) -> GradientTransformation:
    def update(updates, state, params=None):
        s = _f32(step_size)
        return tree_map(lambda g: s * g, updates), state
    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_schedule(schedule: Schedule) -> GradientTransformation:
    """Multiply by ``schedule(count)`` (float32), then count the step."""
    def update(updates, state, params=None):
        s = schedule(state.count)
        return (tree_map(lambda g: s.to(g.dtype) * g, updates),
                CountState(_increment(state.count)))
    return GradientTransformation(lambda params: CountState(_count(params)),
                                  update)


def scale_by_learning_rate(lr: float | Schedule) -> GradientTransformation:
    """``-lr`` (a constant or a schedule of the step count)."""
    if callable(lr):
        return scale_by_schedule(lambda count: -1 * lr(count))
    return scale(-1 * lr)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    """Momentum: ``t = g + decay * t``; the update is ``t``, or
    ``g + decay * t`` with Nesterov."""
    def update(updates, state, params=None):
        d = _f32(decay)
        new = tree_map(lambda g, t: g + d * t, updates, state.trace)
        if nesterov:
            updates = tree_map(lambda g, t: g + d * t, updates, new)
        else:
            updates = new
        return updates, TraceState(new)
    return GradientTransformation(
        lambda params: TraceState(tree_map(torch.zeros_like, params)), update)


def _bias_correction(moment: PyTree, decay: float, count: torch.Tensor
                     ) -> PyTree:
    bc = 1 - torch.pow(torch.tensor(_f32(decay), dtype=_F32,
                                    device=count.device), count.to(_F32))
    return tree_map(lambda t: t / bc.to(t.dtype), moment)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    def init(params):
        return ScaleByAdamState(_count(params),
                                tree_map(torch.zeros_like, params),
                                tree_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        c1, d1 = _f32(1 - b1), _f32(b1)
        c2, d2 = _f32(1 - b2), _f32(b2)
        mu = tree_map(lambda g, t: c1 * g + d1 * t, updates, state.mu)
        nu = tree_map(lambda g, t: c2 * (g * g) + d2 * t, updates, state.nu)
        count = _increment(state.count)
        mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        er, e = _f32(eps_root), _f32(eps)
        updates = tree_map(lambda m, v: m / (torch.sqrt(v + er) + e),
                           mu_hat, nu_hat)
        return updates, ScaleByAdamState(count, mu, nu)
    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        w = _f32(weight_decay)
        return tree_map(lambda g, p: g + w * p, updates, params), state
    return GradientTransformation(lambda params: EmptyState(), update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale every update by ``max_norm / ||updates||`` when the global
    norm is at or above ``max_norm``.  It couples every parameter, so
    ZeRO-1 refuses it (:func:`_check_elementwise`)."""
    def update(updates, state, params=None):
        leaves = tree_leaves(updates)
        norm = torch.sqrt(sum(torch.sum(x * x) for x in leaves))
        m = _f32(max_norm)
        keep = norm < m
        return tree_map(lambda t: torch.where(
            keep, t, (t / norm.to(t.dtype)) * m), updates), state
    return GradientTransformation(lambda params: EmptyState(), update)


def sgd(learning_rate: float | Schedule, momentum: float | None = None,
        nesterov: bool = False) -> GradientTransformation:
    head = [trace(momentum, nesterov)] if momentum is not None else []
    return chain(*head, scale_by_learning_rate(learning_rate))


def adam(learning_rate: float | Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps, eps_root),
                 scale_by_learning_rate(learning_rate))


def adamw(learning_rate: float | Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps, eps_root),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


# ---------------------------------------------------------------------------
# Schedules: float32 functions of the int32 step count
# ---------------------------------------------------------------------------

def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0, exponent: float = 1.0
                          ) -> Schedule:
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be > 0, got {decay_steps}")

    def schedule(count):
        c = torch.clamp(count.to(_F32), max=float(decay_steps))
        cosine = _f32(0.5) * (1 + torch.cos(_f32(math.pi) * c
                                            / _f32(decay_steps)))
        decayed = _f32(1 - alpha) * cosine ** _f32(exponent) + _f32(alpha)
        return _f32(init_value) * decayed
    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    def schedule(count):
        if transition_steps <= 0:
            return torch.full((), _f32(init_value), dtype=_F32,
                              device=count.device)
        c = torch.clamp(count.to(_F32), 0, float(transition_steps))
        frac = 1 - c / _f32(transition_steps)
        return _f32(init_value - end_value) * frac + _f32(end_value)
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """Linear warm-up from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at
    ``decay_steps`` (counted from step 0, as optax's)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    cos = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                alpha=alpha, exponent=exponent)

    def schedule(count):
        return torch.where(count < warmup_steps, warm(count),
                           cos(count - warmup_steps))
    return schedule


# ---------------------------------------------------------------------------
# The replicated-state step
# ---------------------------------------------------------------------------

class OptaxTrainState(NamedTuple):
    """A :class:`~distlearn_tpu_torch.train.trainer.TrainState` plus the
    optimizer state (replicated: every node applies the same summed
    gradient)."""
    params: PyTree
    model_state: PyTree
    opt_state: PyTree
    sync: allreduce_sgd.SGDSyncState
    cm: torch.Tensor
    rng: torch.Generator


def init_optax_state(model: Model, tree: MeshTree,
                     tx: GradientTransformation, seed: int,
                     num_classes: int) -> OptaxTrainState:
    params, mstate, sync, cm, rng = init_common(model, tree, seed,
                                                num_classes)
    return OptaxTrainState(params, mstate, tx.init(params), sync, cm, rng)


def _grads(model, ts, x, y, tree, accum_steps):
    """Loss, log-probs, batchnorm state and gradients of this node's batch,
    over ``accum_steps`` microbatches: their gradients and losses averaged,
    the batchnorm state threaded through them (the last microbatch's)."""
    if accum_steps == 1:
        return value_and_grad(model, ts.params, ts.model_state, x, y, ts.rng,
                              tree)
    if x.shape[0] % accum_steps:
        raise ValueError(f"per-node batch {x.shape[0]} not divisible by "
                         f"accum_steps={accum_steps}")
    xm = x.reshape((accum_steps, -1) + tuple(x.shape[1:]))
    ym = y.reshape((accum_steps, -1) + tuple(y.shape[1:]))
    mstate, acc_g, acc_l, lps = ts.model_state, None, None, []
    for i in range(accum_steps):
        li, lp, mstate, gi = value_and_grad(model, ts.params, mstate, xm[i],
                                            ym[i], ts.rng, tree)
        acc_g = gi if acc_g is None else tree_map(torch.add, acc_g, gi)
        acc_l = li if acc_l is None else acc_l + li
        lps.append(lp)
    grads = tree_map(lambda g: g / cast_scalar(accum_steps, g.dtype), acc_g)
    return acc_l / accum_steps, torch.cat(lps), mstate, grads


def build_optax_step(model: Model, tree: MeshTree,
                     tx: GradientTransformation,
                     accum_steps: int = 1) -> Callable:
    """One data-parallel step with an optimizer: ``step(ts, x, y) -> (ts,
    loss)``, the collective structure of
    :func:`~distlearn_tpu_torch.train.trainer.build_sgd_step` (gradients
    summed and normalised by the contributor count, sync batchnorm) with
    ``tx.update`` in place of the bare SGD rule.  ``accum_steps=k`` splits
    this node's batch into k microbatches whose averaged gradient feeds one
    allreduce and one update; the batchnorm state is the last
    microbatch's."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def step(ts: OptaxTrainState, x, y):
        x = torch.as_tensor(x, device=tree.device)
        y = torch.as_tensor(y, device=tree.device)
        loss, log_probs, mstate, grads = _grads(model, ts, x, y, tree,
                                                accum_steps)
        grads, sync, _ = allreduce_sgd.sum_and_normalize_gradients(
            grads, ts.sync, tree)
        updates, opt_state = tx.update(grads, ts.opt_state, ts.params)
        params = tree_map(lambda p, u: p + u.to(p.dtype), ts.params, updates)
        cm = metrics_lib.update_confusion(ts.cm, log_probs, y)
        mean_loss = tree.all_reduce(loss)[0] / tree.num_nodes
        return (OptaxTrainState(params, mstate, opt_state, sync, cm, ts.rng),
                mean_loss)

    return _timed(step, "optax")


# ---------------------------------------------------------------------------
# ZeRO-1: the optimizer state sharded over the nodes
# ---------------------------------------------------------------------------

class ZeroTrainState(NamedTuple):
    """Params replicated; ``opt_state`` covers only this node's ``1/n``
    slice of the packed float32 parameters (ZeRO stage 1: Adam's state
    memory divided by the node count)."""
    params: PyTree
    model_state: PyTree
    opt_state: PyTree
    sync: allreduce_sgd.SGDSyncState
    cm: torch.Tensor
    rng: torch.Generator


def _zero_layout(params: PyTree, n: int):
    """``(FlatSpec, flat length divisible by n, per-node chunk)``."""
    for leaf in tree_leaves(params):
        if leaf.dtype != _F32:
            raise ValueError(
                "ZeRO sharding packs params into one f32 buffer; got a "
                f"{leaf.dtype} leaf (use build_optax_step for mixed-dtype "
                "trees)")
    spec = flatten_lib.make_spec(params)
    total = ((spec.padded + n - 1) // n) * n
    return spec, total, total // n


def _pack_padded(spec, tree: PyTree, total: int) -> torch.Tensor:
    flat = flatten_lib.pack(spec, tree)
    if total > spec.padded:
        flat = torch.cat([flat, flat.new_zeros(total - spec.padded)])
    return flat


def _check_elementwise(tx: GradientTransformation, n: int) -> None:
    """Refuse a ``tx`` that does not commute with sharding: updating a
    vector whole must equal updating its n chunks apart, over three steps
    whose gradient direction varies (a global-norm clip before Adam shows
    only then)."""
    m = 8 * n
    p = torch.linspace(-1.0, 1.0, m, dtype=_F32)
    gs = [torch.sin(torch.arange(m, dtype=_F32) * (0.3 + t)) * (2.0 + 3.0 * t)
          for t in range(3)]
    state, pf = tx.init(p), p
    for g in gs:
        u, state = tx.update(g, state, pf)
        pf = pf + u
    shards = []
    for i in range(n):
        sl = slice(i * 8, (i + 1) * 8)
        s, pi = tx.init(p[sl]), p[sl]
        for g in gs:
            u, s = tx.update(g[sl], s, pi)
            pi = pi + u
        shards.append(pi)
    if not torch.allclose(pf, torch.cat(shards), rtol=1e-6, atol=1e-6):
        raise ValueError(
            "optimizer is not elementwise (its update couples parameter "
            "slices, e.g. a global-norm clip), so ZeRO sharding would "
            "silently change the training math — use build_optax_step")


def init_zero_state(model: Model, tree: MeshTree, tx: GradientTransformation,
                    seed: int, num_classes: int) -> ZeroTrainState:
    params, mstate, sync, cm, rng = init_common(model, tree, seed,
                                                num_classes)
    n, r = tree.num_nodes, tree.node_index
    _check_elementwise(tx, n)
    spec, total, chunk = _zero_layout(params, n)
    mine = _pack_padded(spec, params, total)[r * chunk:(r + 1) * chunk]
    return ZeroTrainState(params, mstate, tx.init(mine.clone()), sync, cm,
                          rng)


def build_zero_optax_step(model: Model, tree: MeshTree,
                          tx: GradientTransformation) -> Callable:
    """ZeRO-1 step: ``step(ts, x, y) -> (ts, loss)``.  The packed local
    gradients are reduce-scattered (NCCL) or allreduced and sliced (gloo)
    and divided by the node count; the elementwise ``tx.update`` runs on
    this node's slice against its state; one all-gather reassembles the
    parameters.  Full participation every step."""
    n, r = tree.num_nodes, tree.node_index
    scatter = dist.get_backend(tree.group) == "nccl"

    def step(ts: ZeroTrainState, x, y):
        spec, total, chunk = _zero_layout(ts.params, n)
        x = torch.as_tensor(x, device=tree.device)
        y = torch.as_tensor(y, device=tree.device)
        loss, log_probs, mstate, grads = value_and_grad(
            model, ts.params, ts.model_state, x, y, ts.rng, tree)
        sync = allreduce_sgd.SGDSyncState(my_steps=ts.sync.my_steps + 1)
        flat_g = _pack_padded(spec, grads, total)
        if scatter:
            gslice = flat_g.new_empty(chunk)
            dist.reduce_scatter_tensor(gslice, flat_g, group=tree.group)
        else:
            dist.all_reduce(flat_g, group=tree.group)
            gslice = flat_g[r * chunk:(r + 1) * chunk]
        gslice = gslice / cast_scalar(n, _F32)
        pslice = _pack_padded(spec, ts.params, total)[r * chunk:
                                                      (r + 1) * chunk]
        updates, opt_state = tx.update(gslice, ts.opt_state, pslice)
        flat_new = flat_g.new_empty(total)
        dist.all_gather_into_tensor(flat_new, pslice + updates,
                                    group=tree.group)
        params = flatten_lib.unpack(spec, flat_new)
        cm = metrics_lib.update_confusion(ts.cm, log_probs, y)
        mean_loss = tree.all_reduce(loss)[0] / tree.num_nodes
        return (ZeroTrainState(params, mstate, opt_state, sync, cm, ts.rng),
                mean_loss)

    return _timed(step, "zero_optax")
