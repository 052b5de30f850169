"""Tensor-parallel region markers — counterpart of
``distlearn_tpu/parallel/tp.py``: the Megatron f/g pair as
``torch.autograd.Function``s over a mesh axis
(:class:`~distlearn_tpu_torch.parallel.mesh.MeshAxis`, normally
``mesh.axis("model")``).

* :func:`tp_enter` ("f"): identity forward, psum backward — where a
  replicated activation enters the column-parallel region, so gradients of
  upstream replicated params are summed over the tp ranks.
* :func:`tp_reduce` ("g"): psum forward, identity backward — after the
  row-parallel matmul, so tp-sharded weight slices see exactly their own
  gradient.

With one f/g pair per block the residual stream stays replicated in forward
and backward: replicated leaves get the same gradient on every tp rank, and
sharded leaves the exact gradient of their slice.
"""

from __future__ import annotations

import torch

from distlearn_tpu_torch.parallel.mesh import MeshAxis, psum_raw


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum_raw(g, ctx.axis), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return psum_raw(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_enter(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """"f": identity forward, psum over ``axis`` backward."""
    return x if axis.size == 1 else _Enter.apply(x, axis)


def tp_reduce(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """"g": psum over ``axis`` forward, identity backward."""
    return x if axis.size == 1 else _Reduce.apply(x, axis)
