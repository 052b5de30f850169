"""Pipeline parallelism over a mesh axis — counterpart of
``distlearn_tpu/parallel/pp.py``: GPipe (:func:`pipeline_apply`, the
gradient by autograd through the ticks) and 1F1B (:func:`pipeline_1f1b`,
the gradients computed tick by tick).

Stage parameters live one stage a rank of the ``pipe`` axis; microbatches
stream through the stages, and the hop between neighbours is a
:func:`~distlearn_tpu_torch.parallel.mesh.ppermute` over ``[(j, j+1)]``
with no wraparound.  The JAX package scans the ticks inside one SPMD
program; here every rank runs the same eager ticks and calls every
collective in the same order.  A rank's position picks operands through
``torch.where``, never through a branch that changes what is recorded:
each rank must record the same collectives in its autograd graph, or the
backward's inverse permutations pair up differently across ranks and
deadlock.  Compute that holds no collective (the last stage's
``consume_fn``) may be skipped where its result is masked anyway.

Schedule: ``M`` microbatches over ``S`` stages take ``M + S - 1`` ticks
(GPipe; bubble ``(S-1)/(M+S-1)``) or ``M + 2S - 2`` (1F1B).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from distlearn_tpu_torch.parallel.mesh import (MeshAxis, ppermute,
                                               ppermute_raw, psum)
from distlearn_tpu_torch.utils.tree import tree_flatten, tree_unflatten

PyTree = Any


def _microbatches(x: torch.Tensor, M: int) -> torch.Tensor:
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible into {M} microbatches")
    return x.reshape((M, B // M) + tuple(x.shape[1:]))


def _check_shape(out: torch.Tensor, mb: torch.Tensor, why: str) -> None:
    """JAX's shape probe (``jax.eval_shape``), made on the first tick's
    output: every rank runs the stage there before any collective, so
    every rank raises at the same point."""
    if out.shape != mb.shape:
        raise ValueError(
            f"stage_fn must preserve activation shape (got "
            f"{tuple(mb.shape)} -> {tuple(out.shape)}){why}")


class _Anchor(torch.autograd.Function):
    """``value`` itself, with ``tied`` made a (zero-cotangent) input: every
    rank's result then reaches the last tick's output, so its backward runs
    every tick's ``ppermute`` transpose, as JAX's scan backward does."""

    @staticmethod
    def forward(ctx, value, tied):
        ctx.shape, ctx.dtype = tied.shape, tied.dtype
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros(ctx.shape, dtype=ctx.dtype, device=g.device)


def pipeline_apply(stage_fn: Callable, stage_params: PyTree, x: torch.Tensor,
                   num_microbatches: int, axis: MeshAxis,
                   consume_fn: Callable | None = None,
                   unroll: bool | int = False) -> torch.Tensor:
    """Run ``x`` through ``S`` pipelined stages (``S`` = ``axis.size``),
    GPipe schedule; differentiable with autograd.

    ``stage_fn(params, h) -> h`` is one stage's transform and must keep
    the microbatch's shape; ``stage_params`` this rank's stage; ``x`` the
    whole local batch ``[B, ...]`` (the same on every rank of the axis),
    ``B`` divisible by ``num_microbatches``.  At tick ``t`` stage 0
    ingests microbatch ``t`` (zeros once the input is exhausted), the
    other stages the activation their predecessor sent the tick before;
    every tick runs every stage (bubble ticks on zeros).  ``unroll`` is
    accepted for the JAX signature and has no effect: there is no scan
    here, the ticks are eager.

    Without ``consume_fn``: the ``[B, ...]`` outputs of the last stage on
    every rank (a masked :func:`psum` from the last rank).  They are
    replicated, and as for ``psum`` the gradient of a replicated value is
    the sum of every rank's cotangent: differentiate one rank's share of
    an objective of them (e.g. divided by ``S``).

    With ``consume_fn(out_mb, mb_index) -> scalar``: the local share of
    ``Σ_mb consume_fn(out_mb, mb)``, nonzero only on the last rank; sum it
    over ``axis`` outside the differentiated function.  ``consume_fn``
    holds no collective, so it runs only on the last rank's live ticks
    (JAX runs it everywhere and masks it to zero)."""
    S, idx, M = axis.size, axis.index, num_microbatches
    mbs = _microbatches(x, M)
    T = M + S - 1
    fwd_perm = [(j, j + 1) for j in range(S - 1)]
    first = torch.tensor(idx == 0, device=x.device)
    state = torch.zeros_like(mbs[0])
    outs, acc = [], None
    for t in range(T):
        feed = mbs[t] if t < M else torch.zeros_like(mbs[0])
        out = stage_fn(stage_params, torch.where(first, feed.to(state.dtype),
                                                 state))
        if t == 0:
            _check_shape(out, mbs[0], "; wrap in/out projections around "
                         "the pipeline, not inside it")
        m = t - (S - 1)            # the microbatch emerging this tick
        if consume_fn is not None:
            if idx == S - 1 and m >= 0:
                val = consume_fn(out, m).float()
                acc = val if acc is None else acc + val
        elif t >= S - 1:
            outs.append(out)
        if t < T - 1:              # the last hop's result is never read
            state = ppermute(out, axis, fwd_perm)
    if consume_fn is not None:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return _Anchor.apply(zero if acc is None else acc, out)
    y = torch.cat(outs).reshape(x.shape[:1] + outs[0].shape[1:])
    last = torch.tensor(idx == S - 1, device=x.device)
    return psum(torch.where(last, y, torch.zeros_like(y)), axis)


def pipeline_1f1b(stage_fn: Callable, stage_params: PyTree,
                  consume_fn: Callable, consume_params: PyTree,
                  x: torch.Tensor, num_microbatches: int, axis: MeshAxis):
    """The one-forward-one-backward schedule, gradients included; returns
    ``(local_share, g_stage_params, g_consume_params, g_x)``.

    Tick ``t`` runs this stage's forward of microbatch ``t - idx`` and its
    backward of microbatch ``t - 2(S-1) + idx``; at most ``2S - 1`` stage
    inputs are held (a ring buffer), where GPipe keeps every microbatch's
    residuals.  The backward recomputes the stage from its saved input
    with ``torch.autograd.grad`` (``jax.vjp``); the last stage seeds the
    cotangent from ``consume_fn``'s gradient in the tick its forward
    emerges, and cotangents ride a ``ppermute`` over ``[(j, j-1)]``.  The
    collectives are raw: every rank calls the forward, then the backward
    ``ppermute`` in every tick.

    The forward half runs every tick, as in JAX (out of range on zeros or
    on what the predecessor sent, its result unused downstream but by
    ticks out of range too).  The backward half and the head run only
    where their microbatch is in range: JAX computes them everywhere and
    adds them masked to exact zeros, which adds nothing; a skipped
    backward sends zeros.

    ``consume_fn(consume_params, out_mb, mb_index) -> scalar`` takes its
    parameters explicitly, as their gradient is returned.  The share and
    ``g_consume_params`` are nonzero only on the last rank, ``g_x`` only
    on rank 0: sum them over ``axis``."""
    S, idx, M = axis.size, axis.index, num_microbatches
    mbs = _microbatches(x, M)
    T = M + 2 * S - 2
    BUF = 2 * S - 1
    fwd_perm = [(j, j + 1) for j in range(S - 1)]
    bwd_perm = [(j, j - 1) for j in range(1, S)]
    p_leaves, p_def = tree_flatten(stage_params)
    c_leaves, c_def = tree_flatten(consume_params)
    g_stage = [torch.zeros_like(p) for p in p_leaves]
    g_cons = [torch.zeros_like(p) for p in c_leaves]
    gx = torch.zeros_like(mbs)
    share = torch.zeros((), dtype=torch.float32, device=x.device)
    zeros = torch.zeros_like(mbs[0])
    first = torch.tensor(idx == 0, device=x.device)
    buf: list = [None] * BUF
    fwd_in = cot_in = zeros
    for t in range(T):
        # forward half: GPipe's ingest and the stage forward
        m_f = t - idx
        feed = mbs[t] if t < M else zeros
        a_in = torch.where(first, feed, fwd_in.to(feed.dtype))
        buf[t % BUF] = a_in
        with torch.no_grad():
            out = stage_fn(stage_params, a_in)
        if t == 0:
            _check_shape(out, mbs[0], "")
        act = out.dtype
        seed = None
        if idx == S - 1 and 0 <= m_f < M:
            # the head's value and gradient for the same microbatch, whose
            # backward starts this very tick
            cp = [c.detach().requires_grad_() for c in c_leaves]
            o = out.detach().requires_grad_()
            val = consume_fn(tree_unflatten(c_def, cp), o, m_f)
            grads = torch.autograd.grad(val, cp + [o])
            share = share + val.detach().float()
            g_cons = [a + g for a, g in zip(g_cons, grads[:-1])]
            seed = grads[-1].to(act)
        # backward half: recompute the stage from its saved input
        m_b = t - (2 * S - 2) + idx
        g_in = torch.zeros_like(out)
        if 0 <= m_b < M:
            cot = seed if idx == S - 1 else cot_in.to(act)
            a_saved = buf[(m_b + idx) % BUF].detach().requires_grad_()
            req = [p.detach().requires_grad_() for p in p_leaves]
            out_b = stage_fn(tree_unflatten(p_def, req), a_saved)
            grads = torch.autograd.grad(out_b, req + [a_saved], cot)
            g_stage = [a + g for a, g in zip(g_stage, grads[:-1])]
            g_in = grads[-1].to(act)
            if idx == 0:
                gx[m_b] = g_in.to(gx.dtype)
        # the neighbour exchanges for the next tick, on every rank
        fwd_in = ppermute_raw(out, axis, fwd_perm)
        cot_in = ppermute_raw(g_in, axis, bwd_perm)
    return (share, tree_unflatten(p_def, g_stage),
            tree_unflatten(c_def, g_cons), gx.reshape(x.shape))
