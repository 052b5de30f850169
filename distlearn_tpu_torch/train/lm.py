"""LM train-step builders — counterpart of ``distlearn_tpu/train/lm.py``.

The JAX package compiles each step into one SPMD program over a (data, seq,
model) mesh.  Here every rank is a process of a
:class:`~distlearn_tpu_torch.parallel.mesh.Mesh` (or of a data-only
:class:`~distlearn_tpu_torch.parallel.mesh.MeshTree`) and a step is eager
PyTorch on this rank's shard of the params and its ``[B, L]`` block of the
global batch: forward and backward of this rank's share of
:func:`~distlearn_tpu_torch.models.transformer.lm_loss` (through the
flash-attention kernels B5a, B5b and B5c where the model's attention
engages them), the gradient sums of the JAX step, and the SGD update.

* :func:`build_lm_step` — ``fused=True`` updates through flat buckets and
  kernel B1 (off by default, as in JAX).
* :func:`build_lm_mixed_step` — bfloat16 working params, float32 masters.
* :func:`build_lm_moe_metrics` — the MoE routing-health metrics.
* :func:`build_lm_ea_steps` — EASGD (AllReduceEA) for the LM over the data
  axis: collective-free local steps and the elastic round (kernel B2 when
  fused).

The pipeline steps (``build_lm_pp_step``, ``build_lm_pp_1f1b_step``) wait
for ROADMAP A11 and raise ``NotImplementedError``.  No step waits on the
host: losses stay on the device.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from distlearn_tpu_torch.models.core import Model
from distlearn_tpu_torch.models.transformer import (lm_loss, param_specs,
                                                    stack_block_params,
                                                    unstack_block_params)
from distlearn_tpu_torch.ops import flatten as flatten_lib
from distlearn_tpu_torch.ops import fused_update
from distlearn_tpu_torch.parallel.mesh import Mesh, MeshTree, psum_raw
from distlearn_tpu_torch.train.trainer import apply_elastic_round, local_update
from distlearn_tpu_torch.utils.tree import (tree_flatten, tree_leaves,
                                            tree_map, tree_unflatten)

PyTree = Any

_A11 = ("waits for ROADMAP A11 (the pipeline-parallel LM steps, GPipe and "
        "1F1B)")


def as_mesh(mesh, data_axis: str = "data") -> Mesh:
    """A :class:`Mesh` as it is; a :class:`MeshTree` as the one-axis mesh
    ``data_axis`` over its group."""
    if isinstance(mesh, MeshTree):
        return Mesh.from_tree(mesh, data_axis)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"the LM steps take a Mesh or a MeshTree, got "
                        f"{type(mesh).__name__}")
    return mesh


def _value_and_grad(model: Model, params: PyTree, tokens, **loss_kw) -> tuple:
    """``(loss, grads)`` of :func:`lm_loss`; nothing returned carries an
    autograd graph."""
    leaves, treedef = tree_flatten(params)
    req = [p.detach().requires_grad_() for p in leaves]
    loss = lm_loss(model, tree_unflatten(treedef, req), tokens, **loss_kw)
    grads = torch.autograd.grad(loss, req)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def lm_local_grads(model: Model, params: PyTree, tokens, *, seq_axis=None,
                   tp_axis=None, ep_axis=None, accum_steps: int = 1,
                   moe_balance_weight: float = 0.0,
                   seq_layout: str = "contig", mesh=None):
    """``(local_loss_share, grads)`` of the LM objective on this rank's
    shard: the gradient of ``lm_loss(reduce=False)``, so the partial
    gradients are summed afterwards, never the loss inside the
    differentiated function.  ``accum_steps=k`` splits the rows into k
    microbatches, runs them one after another and averages loss and
    gradients: a memory lever, the same effective batch."""
    kw = dict(seq_axis=seq_axis, tp_axis=tp_axis, ep_axis=ep_axis,
              reduce=False, moe_balance_weight=moe_balance_weight,
              seq_layout=seq_layout, mesh=mesh)
    if accum_steps == 1:
        return _value_and_grad(model, params, tokens, **kw)
    if tokens.shape[0] % accum_steps:
        raise ValueError(
            f"per-device batch {tokens.shape[0]} not divisible by "
            f"accum_steps={accum_steps}")
    micro = tokens.reshape((accum_steps, -1) + tuple(tokens.shape[1:]))
    acc_l = torch.zeros((), dtype=torch.float32, device=tokens.device)
    acc_g = tree_map(torch.zeros_like, params)
    for toks in micro:
        li, gi = _value_and_grad(model, params, toks, **kw)
        acc_l = acc_l + li
        acc_g = tree_map(torch.add, acc_g, gi)
    return (acc_l / accum_steps,
            tree_map(lambda g: g / accum_steps, acc_g))


def _axes(mesh: Mesh, *names):
    return tuple(mesh.axis(n) for n in names if n is not None)


def _psum_leaves(leaves: list, axes: tuple) -> list:
    """The psum of each leaf over ``axes``, leaves of one dtype packed
    into one flat buffer (one collective per dtype and axis)."""
    if not leaves or all(a.size == 1 for a in axes):
        return leaves
    out = list(leaves)
    for dtype in {t.dtype for t in leaves}:
        idx = [i for i, t in enumerate(leaves) if t.dtype == dtype]
        flat = psum_raw(torch.cat([leaves[i].reshape(-1) for i in idx]),
                        axes)
        for i, part in zip(idx, flat.split([leaves[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(leaves[i])
    return out


class _Plan(NamedTuple):
    """What a step reduces, from the mesh and the axis names."""
    mesh: Mesh
    dp: int
    seq: tuple          # the seq axis, or ()
    grad_axes: tuple    # data + seq: every replicated axis of a leaf
    ep_grad_axes: tuple  # the same without the expert axis
    data: tuple
    kw: dict            # lm_loss's axis keywords


def _plan(mesh, data_axis, seq_axis, tp_axis, ep_axis, seq_layout,
          moe_balance_weight) -> _Plan:
    mesh = as_mesh(mesh, data_axis)
    names = (data_axis, seq_axis)
    _axes(mesh, tp_axis, ep_axis)       # every named axis is in the mesh
    return _Plan(
        mesh, mesh.axis_size(data_axis), _axes(mesh, seq_axis),
        _axes(mesh, *names),
        _axes(mesh, *(n for n in names if n != ep_axis)),
        _axes(mesh, data_axis),
        dict(seq_axis=seq_axis, tp_axis=tp_axis, ep_axis=ep_axis,
             moe_balance_weight=moe_balance_weight, seq_layout=seq_layout,
             mesh=mesh))


def _reduce_grads(plan: _Plan, grads: PyTree, specs: PyTree, ep_axis,
                  dtype=None) -> PyTree:
    """JAX's gradient reduction: every leaf summed over data and seq (its
    replicated axes; tp shards need nothing), expert leaves over them but
    not the expert axis, then divided by the data-parallel size."""
    leaves, treedef = tree_flatten(grads)
    if dtype is not None:
        leaves = [g.to(dtype) for g in leaves]
    is_ep = [ep_axis is not None and ep_axis in s
             for s in _spec_leaves(specs)]
    out = list(leaves)
    for flag, axes in ((False, plan.grad_axes), (True, plan.ep_grad_axes)):
        idx = [i for i, e in enumerate(is_ep) if e == flag]
        for i, g in zip(idx, _psum_leaves([leaves[i] for i in idx], axes)):
            out[i] = g / plan.dp if plan.dp > 1 else g
    return tree_unflatten(treedef, out)


def _spec_leaves(specs: dict) -> list:
    """The specs of :func:`param_specs` in the leaf order of
    ``tree_flatten`` (sorted keys; a spec tuple is one leaf)."""
    out = []
    for k in sorted(specs):
        v = specs[k]
        out.extend(_spec_leaves(v) if isinstance(v, dict) else [v])
    return out


def _mean(t: torch.Tensor, axes: tuple) -> torch.Tensor:
    n = math.prod(a.size for a in axes)
    return psum_raw(t, axes) / n if n > 1 else t


def _step_loss(plan: _Plan, local_loss: torch.Tensor) -> torch.Tensor:
    """psum of the loss share over seq, then the mean over data."""
    return _mean(psum_raw(local_loss, plan.seq), plan.data)


def _tokens_on(mesh, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=mesh.device)


def build_lm_step(model: Model, mesh, lr: float,
                  seq_axis: str | None = None, tp_axis: str | None = None,
                  ep_axis: str | None = None, accum_steps: int = 1,
                  moe_balance_weight: float = 0.0,
                  fused: bool | None = None,
                  max_bucket_bytes: int | None = None,
                  seq_layout: str = "contig",
                  data_axis: str = "data") -> Callable:
    """``step(params, tokens) -> (params, loss)`` on ``mesh`` (a
    :class:`Mesh`, or a :class:`MeshTree` for the data axis alone).

    ``params`` is this rank's shard (:func:`~distlearn_tpu_torch.models.
    convert.lm_shard` by :func:`param_specs` over ``tp_axis`` and
    ``ep_axis``; replicated over data and seq), ``tokens`` this rank's
    ``[B, L]`` block of the global batch (rows over data, columns over
    seq), ``loss`` the global mean (psum over seq, mean over data).  The
    JAX call's ``params_template`` has no counterpart.  Gradients are
    summed over data and seq and divided by the data-parallel size; tp
    shards need no collective; expert leaves (``ep_axis``, normally the
    data axis: one expert a data rank) are summed over every replicated
    axis except ``ep_axis``.

    ``fused=True`` packs this rank's gradients into flat buckets and
    updates each with one launch of kernel B1 (:func:`~distlearn_tpu_torch.
    ops.fused_update.sgd_update_buckets`); the default is off for the LM,
    as in the JAX package.  It applies when every gradient's dtype matches
    its parameter's, and the per-leaf update runs otherwise."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    use_fused = bool(fused) if fused is not None else False
    plan = _plan(mesh, data_axis, seq_axis, tp_axis, ep_axis, seq_layout,
                 moe_balance_weight)

    def step(params, tokens):
        local_loss, grads = lm_local_grads(
            model, params, _tokens_on(plan.mesh, tokens),
            accum_steps=accum_steps, **plan.kw)
        grads = _reduce_grads(plan, grads,
                              param_specs(params, tp_axis, ep_axis), ep_axis)
        if use_fused and all(g.dtype == p.dtype for g, p in
                             zip(tree_leaves(grads), tree_leaves(params))):
            spec = flatten_lib.make_bucket_spec(grads, max_bucket_bytes)
            params = fused_update.sgd_update_buckets(
                spec, params, flatten_lib.pack_buckets(spec, grads), lr)
        else:
            params = tree_map(lambda p, g: fused_update.sgd_plain(p, g, lr),
                              params, grads)
        return params, _step_loss(plan, local_loss)

    return step


def build_lm_moe_metrics(model: Model, mesh, seq_axis: str | None = None,
                         tp_axis: str | None = None,
                         ep_axis: str | None = None,
                         data_axis: str = "data") -> Callable:
    """``metrics(params, tokens) -> {"moe_balance_loss",
    "moe_dropped_frac"}``: the MoE model's mean Switch balance loss (1.0 =
    a balanced router) and the fraction of routing assignments dropped by
    capacity, forward only, averaged over the data and seq axes; the mesh
    and shards of :func:`build_lm_step`."""
    plan = _plan(mesh, data_axis, seq_axis, tp_axis, ep_axis, "contig", 0.0)

    @torch.no_grad()
    def metrics(params, tokens):
        _, st = model.apply(params, {}, _tokens_on(plan.mesh, tokens),
                            train=True, seq_axis=seq_axis, tp_axis=tp_axis,
                            ep_axis=ep_axis, mesh=plan.mesh)
        if "moe_balance_loss" not in st:
            raise ValueError("model returned no MoE routing metrics — "
                             "build it with moe_experts > 0")
        return {k: _mean(st[k].float(), plan.grad_axes)
                for k in ("moe_balance_loss", "moe_dropped_frac")}

    return metrics


def build_lm_pp_step(*args, **kwargs):
    """GPipe pipeline step: waits for ROADMAP A11."""
    raise NotImplementedError(f"build_lm_pp_step {_A11}")


def build_lm_pp_1f1b_step(*args, **kwargs):
    """1F1B pipeline step: waits for ROADMAP A11."""
    raise NotImplementedError(f"build_lm_pp_1f1b_step {_A11}")


def stack_blocks(params: PyTree, depth: int) -> tuple[PyTree, PyTree]:
    """Split a :func:`transformer_lm` tree into ``(shared, stacked)``: the
    embed/pos/out_norm leaves, and the per-block leaves stacked on a
    leading ``[depth]`` axis (the ``scan_blocks`` layout's ``"blocks"``)."""
    both = stack_block_params(params, depth)
    stacked = both.pop("blocks")
    return both, stacked


def unstack_blocks(shared: PyTree, stacked: PyTree, depth: int) -> PyTree:
    """Inverse of :func:`stack_blocks` (back to the per-block layout)."""
    return unstack_block_params(dict(shared, blocks=stacked), depth)


# ---------------------------------------------------------------------------
# Mixed precision
# ---------------------------------------------------------------------------

class LMMixedState(NamedTuple):
    """Mixed-precision LM train state: ``params`` the bfloat16 working copy
    every matmul reads, ``master`` the float32 copy the update applies to
    (bfloat16 alone would lose ``lr*g`` far below ``p``).  Invariant:
    ``params == master.to(bfloat16)``, bit for bit."""
    params: PyTree
    master: PyTree


def init_lm_mixed_state(params: PyTree,
                        param_dtype=torch.bfloat16) -> LMMixedState:
    """Master := the float32 init; working copy := its ``param_dtype``
    cast."""
    return LMMixedState(params=tree_map(lambda p: p.to(param_dtype), params),
                        master=params)


def build_lm_mixed_step(model: Model, mesh, lr: float,
                        seq_axis: str | None = None,
                        tp_axis: str | None = None,
                        ep_axis: str | None = None, accum_steps: int = 1,
                        moe_balance_weight: float = 0.0,
                        grad_dtype=torch.float32,
                        seq_layout: str = "contig",
                        data_axis: str = "data") -> Callable:
    """:func:`build_lm_step` on :class:`LMMixedState`:
    ``step(st, tokens) -> (st, loss)``, the same mesh and shards.
    Gradients of the working copy are cast to ``grad_dtype`` before the
    sums and the update (float32 by default, so the sums accumulate in
    full precision); the master takes ``m - lr*g`` and the working copy is
    the master cast again."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    plan = _plan(mesh, data_axis, seq_axis, tp_axis, ep_axis, seq_layout,
                 moe_balance_weight)

    def step(st: LMMixedState, tokens):
        local_loss, grads = lm_local_grads(
            model, st.params, _tokens_on(plan.mesh, tokens),
            accum_steps=accum_steps, **plan.kw)
        grads = _reduce_grads(plan, grads,
                              param_specs(st.params, tp_axis, ep_axis),
                              ep_axis, dtype=grad_dtype)
        master = tree_map(lambda m, g: fused_update.sgd_plain(m, g, lr),
                          st.master, grads)
        params = tree_map(lambda p, m: m.to(p.dtype), st.params, master)
        return LMMixedState(params, master), _step_loss(plan, local_loss)

    return step


# ---------------------------------------------------------------------------
# Elastic averaging
# ---------------------------------------------------------------------------

class LMEAState(NamedTuple):
    """This replica's elastic-averaging state for LM training: its own
    params (replicas diverge between rounds), its center replica and the
    EAMSGD momentum buffer (zeros and untouched under plain SGD)."""
    params: PyTree
    center: PyTree
    vel: PyTree


def init_lm_ea_state(model: Model, tree: MeshTree, seed=0) -> LMEAState:
    """Identical init on every replica (same ``seed``), center := params,
    zero momentum, on ``tree.device``."""
    params, _ = model.init(seed, tree.device)
    return LMEAState(params=params, center=tree_map(torch.clone, params),
                     vel=tree_map(torch.zeros_like, params))


def build_lm_ea_steps(model: Model, tree: MeshTree, lr: float, alpha: float,
                      momentum: float = 0.0, fused: bool | None = None,
                      max_bucket_bytes: int | None = None
                      ) -> tuple[Callable, Callable]:
    """EASGD for the transformer LM: ``(local_step, ea_round)``, the
    contract of :func:`~distlearn_tpu_torch.train.trainer.build_ea_steps`.

    ``local_step(st, tokens) -> (st, loss)``: this replica's gradient on
    its own rows and the local update, no collective; ``loss`` is this
    replica's.  ``momentum > 0`` is EAMSGD's heavy-ball local rule.
    ``ea_round(st) -> st``: the elastic round (lua/AllReduceEA.lua:35-45),
    with ``fused`` (default on the card) one launch of kernel B2 and one
    allreduce per bucket.  The caller runs the round every tau steps."""
    use_fused = fused_update.fused_enabled(fused, tree.device)

    def local_step(st: LMEAState, tokens):
        loss, grads = _value_and_grad(model, st.params,
                                      _tokens_on(tree, tokens))
        params, vel = local_update(st.params, grads, st.vel, lr, momentum)
        return LMEAState(params, st.center, vel), loss

    def ea_round(st: LMEAState) -> LMEAState:
        params, center = apply_elastic_round(st.params, st.center, alpha,
                                             tree, use_fused,
                                             max_bucket_bytes)
        return st._replace(params=params, center=center)

    return local_step, ea_round
