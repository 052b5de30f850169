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
* :func:`build_lm_pp_step`, :func:`build_lm_pp_1f1b_step` — pipeline
  parallelism over a ``(data, pipe)`` mesh, GPipe and 1F1B
  (``parallel/pp.py``), on the :func:`stack_blocks` layout.
* :func:`build_lm_ea_steps` — EASGD (AllReduceEA) for the LM over the data
  axis: collective-free local steps and the elastic round (kernel B2 when
  fused).

The optimizers' LM steps (optax, ZeRO-1, FSDP) are in ``train/optim.py``.
No step waits on the host: losses stay on the device.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from distlearn_tpu_torch.models.core import Model
from torch.utils.checkpoint import checkpoint

from distlearn_tpu_torch.models.transformer import (_rmsnorm, block_apply,
                                                    lm_loss, param_specs,
                                                    stack_block_params,
                                                    unstack_block_params)
from distlearn_tpu_torch.ops import flatten as flatten_lib
from distlearn_tpu_torch.ops import fused_update
from distlearn_tpu_torch.parallel.mesh import Mesh, MeshTree, psum_raw
from distlearn_tpu_torch.parallel.pp import pipeline_1f1b, pipeline_apply
from distlearn_tpu_torch.train.trainer import apply_elastic_round, local_update
from distlearn_tpu_torch.utils.tree import (tree_flatten, tree_leaves,
                                            tree_map, tree_unflatten)

PyTree = Any

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


# ---------------------------------------------------------------------------
# Pipeline parallelism
# ---------------------------------------------------------------------------

def _pp_checks(mesh: Mesh, shared_template, stacked_template, pipe_axis):
    n_stages = as_mesh(mesh).axis_size(pipe_axis)
    depth = tree_leaves(stacked_template)[0].shape[0]
    if depth % n_stages:
        raise ValueError(
            f"stacked blocks hold {depth} layers but the {pipe_axis!r} "
            f"axis has {n_stages} devices — depth must divide into an "
            "equal number of blocks per stage")
    for need in ("embed", "pos", "out_norm"):
        if need not in shared_template:
            raise ValueError(f"shared params missing {need!r} — pass the "
                             "(shared, stacked) pair from stack_blocks()")


def _stage_fn(cd, remat: bool, attn_impl) -> Callable:
    """``stage(bp_stack, h)``: this stage's k blocks in order, each
    checkpointed where a gradient is recorded when ``remat``."""
    def one(bp, h):
        return block_apply(bp, h, cd, attn_impl=attn_impl)

    def stage(bp_stack, h):
        k = tree_leaves(bp_stack)[0].shape[0]
        for i in range(k):
            bp = tree_map(lambda a, i=i: a[i], bp_stack)
            if remat and torch.is_grad_enabled():
                h = checkpoint(one, bp, h, use_reentrant=False)
            else:
                h = one(bp, h)
        return h
    return stage


def _head_nll(out_norm, embed, out_mb, toks, cd, denom) -> torch.Tensor:
    """A microbatch's share of the global batch-mean next-token loss."""
    hh = _rmsnorm(out_norm, out_mb)
    logits = (hh @ embed.T.to(cd)).float()
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -lp.gather(-1, toks[:, 1:, None])[..., 0]
    return nll.sum() / denom


def _pp_tokens(mesh, tokens, M):
    tokens = _tokens_on(mesh, tokens).long()
    B, L = tokens.shape
    if B % M:
        raise ValueError(f"per-replica batch {B} not divisible into "
                         f"{M} microbatches")
    return tokens, tokens.reshape(M, B // M, L)


def _pp_update(mesh, data_axis, pipe_axis, lr, shared, stacked, g_shared,
               g_blk, local_share):
    """JAX's reassembly: shared grads summed over (data, pipe) (each pipe
    rank holds the part it touched), block grads over data, both divided
    by dp; SGD; the loss summed over pipe and averaged over data."""
    data, pipe = mesh.axis(data_axis), mesh.axis(pipe_axis)
    dp = data.size
    out = []
    for tree, grads, axes in ((shared, g_shared, (data, pipe)),
                              (stacked, g_blk, (data,))):
        leaves, treedef = tree_flatten(grads)
        summed = [g / dp if dp > 1 else g
                  for g in _psum_leaves(leaves, axes)]
        out.append(tree_map(lambda p, g: fused_update.sgd_plain(p, g, lr),
                            tree, tree_unflatten(treedef, summed)))
    loss = _mean(psum_raw(local_share, pipe), (data,))
    return out[0], out[1], loss


def _requires_grad(tree: PyTree) -> PyTree:
    return tree_map(lambda p: p.detach().requires_grad_(), tree)


def build_lm_pp_step(mesh: Mesh, shared_template, stacked_template,
                     lr: float, num_microbatches: int, compute_dtype=None,
                     data_axis: str = "data", pipe_axis: str = "pipe",
                     remat: bool = False, unroll: bool | int = False,
                     attn_impl: str | None = None) -> Callable:
    """Pipeline-parallel LM step over a ``(data, pipe)`` :class:`Mesh`, the
    GPipe schedule: ``step(shared, stacked, tokens) -> (shared, stacked,
    loss)``.

    ``shared_template``/``stacked_template`` are the whole
    :func:`stack_blocks` pair (for the depth and key checks; their shapes
    only).  ``shared`` (embed, pos, out_norm) is replicated on every rank,
    ``stacked`` this stage's ``k = depth/S`` contiguous blocks (leaves
    ``[k, ...]``: rows ``[s*k, (s+1)*k)`` of the stacked tree on pipe rank
    ``s``), ``tokens`` this data rank's ``[B, L]`` rows, ``B`` divisible
    into ``num_microbatches``.  The stage runs its k blocks in order,
    each checkpointed (``torch.utils.checkpoint``) with ``remat``.
    Microbatches stream through :func:`~distlearn_tpu_torch.parallel.pp.
    pipeline_apply`, each one's loss share folded on the last rank as it
    emerges; autograd through the ticks is the GPipe backward.  Shared
    gradients are summed over (data, pipe) and block gradients over data,
    both divided by dp; the update is SGD.  ``unroll`` has no effect (no
    scan).  ``attn_impl`` picks the blocks' attention (``None``: the
    environment's default, the only choice the JAX step has)."""
    _pp_checks(mesh, shared_template, stacked_template, pipe_axis)
    pipe = mesh.axis(pipe_axis)

    def step(shared, stacked, tokens):
        M = num_microbatches
        tokens, toks_mb = _pp_tokens(mesh, tokens, M)
        B, L = tokens.shape
        sh, blk = _requires_grad(shared), _requires_grad(stacked)
        cd = compute_dtype or shared["embed"].dtype
        x = sh["embed"][tokens].to(cd) + sh["pos"][:L].to(cd)[None]

        def consume(out_mb, m):
            return _head_nll(sh["out_norm"], sh["embed"], out_mb, toks_mb[m],
                             cd, B * (L - 1))

        local_share = pipeline_apply(_stage_fn(cd, remat, attn_impl), blk,
                                     x, M, pipe, consume_fn=consume,
                                     unroll=unroll)
        leaves, treedef = tree_flatten((sh, blk))
        grads = torch.autograd.grad(local_share, leaves, allow_unused=True)
        g_sh, g_blk = tree_unflatten(treedef, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
        return _pp_update(mesh, data_axis, pipe_axis, lr, shared, stacked,
                          g_sh, g_blk, local_share.detach())

    return step


def build_lm_pp_1f1b_step(mesh: Mesh, shared_template, stacked_template,
                          lr: float, num_microbatches: int,
                          compute_dtype=None, data_axis: str = "data",
                          pipe_axis: str = "pipe", remat: bool = False,
                          attn_impl: str | None = None) -> Callable:
    """:func:`build_lm_pp_step` with the 1F1B schedule
    (:func:`~distlearn_tpu_torch.parallel.pp.pipeline_1f1b`): the same
    contract, sharding and gradient sums, but each microbatch's backward
    starts in the tick it leaves the last stage, so a stage holds at most
    ``2S - 1`` microbatch inputs instead of GPipe's residuals of all
    ``M``.  The embedding's gradient comes back through ``g_x`` (rank 0),
    the head's through the explicit consume params (the last rank)."""
    _pp_checks(mesh, shared_template, stacked_template, pipe_axis)
    pipe = mesh.axis(pipe_axis)

    def step(shared, stacked, tokens):
        M = num_microbatches
        tokens, toks_mb = _pp_tokens(mesh, tokens, M)
        B, L = tokens.shape
        cd = compute_dtype or shared["embed"].dtype
        emb = _requires_grad({"embed": shared["embed"],
                              "pos": shared["pos"]})
        x = emb["embed"][tokens].to(cd) + emb["pos"][:L].to(cd)[None]

        def consume(cp, out_mb, m):
            return _head_nll(cp["out_norm"], cp["embed"], out_mb, toks_mb[m],
                             cd, B * (L - 1))

        cp = {"out_norm": shared["out_norm"], "embed": shared["embed"]}
        local_share, g_blk, g_cp, g_x = pipeline_1f1b(
            _stage_fn(cd, remat, attn_impl), stacked, consume, cp,
            x.detach(), M, pipe)
        if pipe.index == 0:      # g_x is zeros on every other rank
            g_embed, g_pos = torch.autograd.grad(
                x, [emb["embed"], emb["pos"]], g_x.to(x.dtype))
        else:
            g_embed, g_pos = (torch.zeros_like(shared["embed"]),
                              torch.zeros_like(shared["pos"]))
        g_sh = {"embed": g_embed + g_cp["embed"], "pos": g_pos,
                "out_norm": g_cp["out_norm"]}
        return _pp_update(mesh, data_axis, pipe_axis, lr, shared, stacked,
                          g_sh, g_blk, local_share)

    return step


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
