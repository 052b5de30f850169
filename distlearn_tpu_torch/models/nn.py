"""Functional layers over dicts of tensors — counterpart of
``distlearn_tpu/models/nn.py`` (the reference's ``grad.nn`` primitives,
examples/mnist.lua:53-67, examples/Model.lua:19-45).

Layout: the models take NHWC input, as the JAX package does, and permute it
to NCHW at the door.  A permuted contiguous NHWC tensor *is* an NCHW tensor
in the ``channels_last`` memory format, so the convolutions run channels-last
at no copy.  Weights are stored in PyTorch's layouts: conv ``OIHW``, dense
``[out, in]`` (:mod:`distlearn_tpu_torch.models.convert` moves JAX weights).

Batchnorm is written by hand: the JAX package's sync batchnorm averages
``E[x]`` and ``E[x²]`` across nodes, optionally weighted by a contributor
mask, which ``torch.nn.SyncBatchNorm`` does not do.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _uniform_fanin(gen: torch.Generator, shape, fan_in: int, dtype):
    """torch7's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    return (torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1) * bound


# ---------------------------------------------------------------------------
# Dense and conv
# ---------------------------------------------------------------------------

def dense_init(gen, in_features: int, out_features: int, dtype=torch.float32):
    return {"w": _uniform_fanin(gen, (out_features, in_features), in_features,
                                dtype),
            "b": _uniform_fanin(gen, (out_features,), in_features, dtype)}


def dense(params, x):
    return F.linear(x, params["w"], params["b"])


def conv2d_init(gen, in_ch: int, out_ch: int, kh: int, kw: int,
                dtype=torch.float32):
    fan_in = in_ch * kh * kw
    return {"w": _uniform_fanin(gen, (out_ch, in_ch, kh, kw), fan_in, dtype),
            "b": _uniform_fanin(gen, (out_ch,), fan_in, dtype)}


def conv2d(params, x, padding: int = 0):
    """x: NCHW (channels-last in memory on the main path); weight OIHW."""
    return F.conv2d(x, params["w"], params["b"], padding=padding)


def max_pool2d(x):
    return F.max_pool2d(x, kernel_size=2, stride=2)


# ---------------------------------------------------------------------------
# BatchNorm with cross-node (sync) statistics
# ---------------------------------------------------------------------------

class _WeightedNodeMean(torch.autograd.Function):
    """``psum(stats * w) / max(psum(w), 1)`` over the nodes of ``tree``.

    The backward is the transpose JAX takes for ``psum`` inside
    ``shard_map(check_vma=False)`` (``train/trainer.py:224-233`` of the JAX
    package): the cotangent is divided by the same denominator, summed over
    the nodes, and scaled by this node's weight.  Each node's input gradient
    therefore carries every node's loss through the shared statistics, and
    the sum over nodes is the gradient of the summed loss.
    """

    @staticmethod
    def forward(ctx, stats, w, group):
        buf = torch.cat([(stats * w).reshape(-1), w.reshape(1)])
        dist.all_reduce(buf, group=group)
        denom = torch.clamp(buf[-1], min=1)
        ctx.save_for_backward(w, denom)
        ctx.group = group
        return buf[:-1].view_as(stats) / denom

    @staticmethod
    def backward(ctx, grad):
        w, denom = ctx.saved_tensors
        g = grad / denom
        dist.all_reduce(g, group=ctx.group)
        return g * w, None, None


def batchnorm_init(ch: int, dtype=torch.float32, device=None):
    params = {"scale": torch.ones(ch, dtype=dtype, device=device),
              "bias": torch.zeros(ch, dtype=dtype, device=device)}
    stats = {"mean": torch.zeros(ch, dtype=dtype, device=device),
             "var": torch.ones(ch, dtype=dtype, device=device)}
    return params, stats


def batchnorm(params, stats, x, train: bool, eps: float = 1e-3,
              momentum: float = 0.1, tree=None, weight=None):
    """Batchnorm over (N, H, W) of an NCHW tensor, or over N of ``[N, C]``.

    ``tree``: a :class:`~distlearn_tpu_torch.parallel.mesh.MeshTree` for
    sync batchnorm (statistics averaged over its nodes), ``None`` for this
    node's own statistics.  ``weight``: this node's 0/1 contributor flag —
    a non-contributor's statistics are left out of the average, as its
    gradient is left out of the sum (lua/AllReduceSGD.lua:22-27).
    Returns ``(y, new_stats)``; the running statistics carry no gradient.
    """
    dims = [0] + list(range(2, x.ndim))
    bshape = [1, -1] + [1] * (x.ndim - 2)
    if train:
        mean = torch.mean(x, dim=dims)
        mean2 = torch.mean(x * x, dim=dims)
        if tree is not None:
            w = torch.ones((), dtype=x.dtype, device=x.device) \
                if weight is None else torch.as_tensor(weight).to(x)
            both = _WeightedNodeMean.apply(torch.stack([mean, mean2]), w,
                                           tree.group)
            mean, mean2 = both[0], both[1]
        var = mean2 - mean * mean
        m = momentum
        new_stats = {
            "mean": (1 - m) * stats["mean"] + m * mean.detach().to(stats["mean"]),
            "var": (1 - m) * stats["var"] + m * var.detach().to(stats["var"]),
        }
    else:
        mean, var = stats["mean"].to(x.dtype), stats["var"].to(x.dtype)
        new_stats = stats
    inv = torch.rsqrt(var + eps)
    y = (x - mean.view(bshape)) * inv.view(bshape)
    y = y * params["scale"].to(x.dtype).view(bshape) \
        + params["bias"].to(x.dtype).view(bshape)
    return y, new_stats


# ---------------------------------------------------------------------------
# Heads and dropout
# ---------------------------------------------------------------------------

def log_softmax(x):
    return F.log_softmax(x, dim=-1)


def nll_loss(log_probs, labels):
    """ClassNLLCriterion (examples/Model.lua:52): mean over the batch of
    ``-log p[label]``."""
    ll = torch.gather(log_probs, 1, labels.to(torch.int64)[:, None])[:, 0]
    return -torch.mean(ll)


def dropout(gen: torch.Generator, x, rate: float, train: bool):
    """Inverted dropout with masks drawn from ``gen`` (a generator on
    ``x``'s device, seeded per node)."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device,
                      dtype=x.dtype) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
