"""LM train-step builders — counterpart of ``distlearn_tpu/train/lm.py`` over
the data axis alone (one card, or data parallelism across cards).

The JAX package compiles each step into one SPMD program over a (data, seq,
model) mesh.  Here each data-parallel replica is a process of a
:class:`~distlearn_tpu_torch.parallel.mesh.MeshTree` (NCCL on the card,
gloo on the CPU) and a step is eager PyTorch on this replica's rows of the
global batch: forward and backward of :func:`~distlearn_tpu_torch.models.
transformer.lm_loss` (through the flash-attention kernels B5a, B5b and B5c
when the model's attention engages them), the gradient sum over the
replicas divided by their number (JAX's ``psum`` then ``1/dp``), and the
SGD update.

* :func:`build_lm_step` — replicated params; ``fused=True`` updates through
  flat buckets and kernel B1 (off by default, as in JAX).
* :func:`build_lm_mixed_step` — bfloat16 working params, float32 masters.
* :func:`build_lm_ea_steps` — EASGD (AllReduceEA) for the LM: collective-
  free local steps and the elastic round (kernel B2 when fused).

Sequence, tensor, expert and pipeline parallelism (``seq_axis``,
``tp_axis``, ``ep_axis``, ``seq_layout="zigzag"``, the pp builders) and the
MoE metrics wait for ROADMAP A11 and raise ``NotImplementedError``.
No step waits on the host: losses stay on the device.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from distlearn_tpu_torch.models.core import Model
from distlearn_tpu_torch.models.transformer import (lm_loss,
                                                    stack_block_params,
                                                    unstack_block_params)
from distlearn_tpu_torch.ops import flatten as flatten_lib
from distlearn_tpu_torch.ops import fused_update
from distlearn_tpu_torch.parallel.mesh import MeshTree
from distlearn_tpu_torch.train.trainer import apply_elastic_round, local_update
from distlearn_tpu_torch.utils.tree import (tree_flatten, tree_leaves,
                                            tree_map, tree_unflatten)

PyTree = Any

_A11 = ("waits for ROADMAP A11 (tp, sequence, pipeline and expert "
        "parallelism of LM training)")


def _not_ported(**axes) -> None:
    for name, value in axes.items():
        if value is not None:
            raise NotImplementedError(f"{name}={value!r} {_A11}")


def _check_layout(seq_layout: str) -> None:
    if seq_layout != "contig":
        raise NotImplementedError(f"seq_layout={seq_layout!r} {_A11}")


def _value_and_grad(model: Model, params: PyTree, tokens) -> tuple:
    """``(loss, grads)`` of :func:`lm_loss`; nothing returned carries an
    autograd graph."""
    leaves, treedef = tree_flatten(params)
    req = [p.detach().requires_grad_() for p in leaves]
    loss = lm_loss(model, tree_unflatten(treedef, req), tokens)
    grads = torch.autograd.grad(loss, req)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def lm_local_grads(model: Model, params: PyTree, tokens, *, seq_axis=None,
                   tp_axis=None, ep_axis=None, accum_steps: int = 1,
                   seq_layout: str = "contig"):
    """``(local_loss, grads)`` of the LM objective on this replica's rows.
    ``accum_steps=k`` splits the rows into k microbatches, runs them one
    after another and averages loss and gradients: a memory lever, the
    same effective batch (the order of the JAX package's scan)."""
    _not_ported(seq_axis=seq_axis, tp_axis=tp_axis, ep_axis=ep_axis)
    _check_layout(seq_layout)
    if accum_steps == 1:
        return _value_and_grad(model, params, tokens)
    if tokens.shape[0] % accum_steps:
        raise ValueError(
            f"per-device batch {tokens.shape[0]} not divisible by "
            f"accum_steps={accum_steps}")
    micro = tokens.reshape((accum_steps, -1) + tuple(tokens.shape[1:]))
    acc_l = torch.zeros((), dtype=torch.float32, device=tokens.device)
    acc_g = tree_map(torch.zeros_like, params)
    for toks in micro:
        li, gi = _value_and_grad(model, params, toks)
        acc_l = acc_l + li
        acc_g = tree_map(torch.add, acc_g, gi)
    return (acc_l / accum_steps,
            tree_map(lambda g: g / accum_steps, acc_g))


def _mean_over_replicas(tree: MeshTree, grads: PyTree) -> PyTree:
    """The gradient sum over the data-parallel replicas divided by their
    number (``lax.psum`` then ``/ dp``; for one replica both are the
    identity and are skipped)."""
    if tree.num_nodes == 1:
        return grads
    grads, _ = tree.all_reduce(grads)
    return tree_map(lambda g: g / tree.num_nodes, grads)


def _mean_loss(tree: MeshTree, loss: torch.Tensor) -> torch.Tensor:
    """``lax.pmean`` of the loss over the replicas."""
    if tree.num_nodes == 1:
        return loss
    return tree.all_reduce(loss)[0] / tree.num_nodes


def _tokens_on(tree: MeshTree, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=tree.device)


def build_lm_step(model: Model, tree: MeshTree, lr: float,
                  seq_axis: str | None = None, tp_axis: str | None = None,
                  ep_axis: str | None = None, accum_steps: int = 1,
                  fused: bool | None = None,
                  max_bucket_bytes: int | None = None,
                  seq_layout: str = "contig") -> Callable:
    """``step(params, tokens) -> (params, loss)`` with ``tokens`` this
    replica's ``[B, L]`` rows of the global batch and ``loss`` the mean
    over the replicas.  The JAX call's ``params_template`` (its sharding
    template) has no counterpart: every replica holds the whole tree.

    ``fused=True`` packs the gradients into flat buckets and updates each
    with one launch of kernel B1 (:func:`~distlearn_tpu_torch.ops.
    fused_update.sgd_update_buckets`); the default is off for the LM, as
    in the JAX package.  It applies when every gradient's dtype matches
    its parameter's, and the per-leaf update runs otherwise."""
    _not_ported(seq_axis=seq_axis, tp_axis=tp_axis, ep_axis=ep_axis)
    _check_layout(seq_layout)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    use_fused = bool(fused) if fused is not None else False

    def step(params, tokens):
        local_loss, grads = lm_local_grads(
            model, params, _tokens_on(tree, tokens), accum_steps=accum_steps)
        grads = _mean_over_replicas(tree, grads)
        if use_fused and all(g.dtype == p.dtype for g, p in
                             zip(tree_leaves(grads), tree_leaves(params))):
            spec = flatten_lib.make_bucket_spec(grads, max_bucket_bytes)
            params = fused_update.sgd_update_buckets(
                spec, params, flatten_lib.pack_buckets(spec, grads), lr)
        else:
            params = tree_map(lambda p, g: fused_update.sgd_plain(p, g, lr),
                              params, grads)
        return params, _mean_loss(tree, local_loss)

    return step


def build_lm_moe_metrics(*args, **kwargs):
    """MoE routing metrics: the MoE LM waits for ROADMAP A11."""
    raise NotImplementedError(f"build_lm_moe_metrics {_A11}")


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


def build_lm_mixed_step(model: Model, tree: MeshTree, lr: float,
                        seq_axis: str | None = None,
                        tp_axis: str | None = None,
                        ep_axis: str | None = None, accum_steps: int = 1,
                        grad_dtype=torch.float32,
                        seq_layout: str = "contig") -> Callable:
    """:func:`build_lm_step` on :class:`LMMixedState`:
    ``step(st, tokens) -> (st, loss)``.  Gradients of the working copy are
    cast to ``grad_dtype`` before the replicas' sum and the update (float32
    by default, so the sum accumulates in full precision); the master
    takes ``m - lr*g`` and the working copy is the master cast again."""
    _not_ported(seq_axis=seq_axis, tp_axis=tp_axis, ep_axis=ep_axis)
    _check_layout(seq_layout)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def step(st: LMMixedState, tokens):
        local_loss, grads = lm_local_grads(
            model, st.params, _tokens_on(tree, tokens),
            accum_steps=accum_steps)
        grads = _mean_over_replicas(
            tree, tree_map(lambda g: g.to(grad_dtype), grads))
        master = tree_map(lambda m, g: fused_update.sgd_plain(m, g, lr),
                          st.master, grads)
        params = tree_map(lambda p, m: m.to(p.dtype), st.params, master)
        return LMMixedState(params, master), _mean_loss(tree, local_loss)

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
