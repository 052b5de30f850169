"""What the plain models share: seeds, weights made from a seed, batchnorm,
operands rounded to a lower precision for the control, and plain SGD.

Plain PyTorch in float32 with TF32 off.  Nothing here imports the port.
"""

from __future__ import annotations

import zlib
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

#: (path of keys, shape, mean, std) of one parameter
Spec = tuple[tuple[str, ...], tuple[int, ...], float, float]


def sub_seed(seed: int, tag: str) -> int:
    """A 64-bit seed for one stream (``tag``) of a run's ``seed``; any
    whole ``seed`` >= 0, however large."""
    ss = np.random.SeedSequence([int(seed), zlib.crc32(tag.encode())])
    return int(ss.generate_state(1, np.uint64)[0])


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def tf32_off() -> None:
    """float32 products in float32 (no TF32 on the tensor cores)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Trees of tensors (nested dicts)
# ---------------------------------------------------------------------------

def set_path(tree: dict, path: tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def leaves(tree: dict, prefix: tuple = ()) -> list[tuple[tuple, torch.Tensor]]:
    """``[(path, tensor)]`` in sorted key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(leaves(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def tree_map(fn: Callable, tree: dict) -> dict:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def make_params(specs: list[Spec], seed: int, device) -> dict:
    """Every parameter from one normal draw on ``device``: leaf
    ``mean + std * z`` over its slice of ``z``, float32."""
    g = generator(seed, "weights", device)
    total = sum(int(np.prod(shape)) for _, shape, _, _ in specs)
    z = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    params, off = {}, 0
    for path, shape, mean, std in specs:
        n = int(np.prod(shape))
        set_path(params, path, z[off:off + n].view(shape) * std + mean)
        off += n
    return params


# ---------------------------------------------------------------------------
# Operands in a lower precision (the control)
# ---------------------------------------------------------------------------

#: precision -> (forward operands, backward operand) formats of the
#: products (convolutions, dense layers)
PRECISIONS = {"float32": (None, None), "tf32": ("tf32", "tf32"),
              "fp8": ("e4m3", "e5m2")}
#: precision -> (forward, backward) formats of every tensor the layers
#: hand each other; TF32 is a format of products' operands alone
ACTIVATIONS = {"float32": (None, None), "tf32": (None, None),
               "fp8": ("e4m3", "e5m2")}


def round_to(x: torch.Tensor, fmt: str | None) -> torch.Tensor:
    """``x`` (float32) rounded to ``fmt``: ``tf32`` keeps 10 mantissa bits
    (round to nearest even); ``e4m3``/``e5m2`` are float8 with one scale a
    tensor, its largest magnitude at the format's largest value."""
    if fmt is None:
        return x
    if fmt == "tf32":
        i = x.contiguous().view(torch.int32)
        i = (i + (((i >> 13) & 1) + 0xFFF)) & ~0x1FFF
        return i.view(torch.float32).view_as(x)
    dt = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}[fmt]
    scale = x.detach().abs().amax().clamp(min=1e-30) / torch.finfo(dt).max
    return (x / scale).to(dt).to(x.dtype) * scale


class _RoundForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt):
        return round_to(x, fmt)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt):
        ctx.fmt = fmt
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.fmt), None


class _RoundBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return round_to(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.bwd), None, None


def activation(x, precision: str):
    """``x`` as a layer hands it on in ``precision``: rounded on the way
    forward, its gradient on the way back; float32 and TF32 leave it
    alone."""
    fwd, bwd = ACTIVATIONS[precision]
    return x if fwd is None else _RoundBoth.apply(x, fwd, bwd)


def product(fn: Callable, x, w, precision: str, **kw):
    """``fn(x, w, **kw)`` (a convolution or a dense layer) with its
    operands in ``precision``: the inputs rounded on the way in, the
    output's gradient on the way back; float32 leaves them alone."""
    fwd, bwd = PRECISIONS[precision]
    if fwd is None:
        return fn(x, w, **kw)
    y = fn(_RoundForward.apply(x, fwd), _RoundForward.apply(w, fwd), **kw)
    return activation(_RoundBackward.apply(y, bwd), precision)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def batchnorm(p: dict, s: dict, x, eps: float, momentum: float,
              terms: dict | None = None):
    """Training batchnorm over every axis but the channels (axis 1): the
    batch's mean and biased variance normalise ``x``; the running
    statistics move by ``momentum`` toward the batch's mean and biased
    variance.  Returns ``(y, new_stats)``.

    ``terms``, when given, receives on the backward pass, under the ids of
    ``p["bias"]`` and ``p["scale"]``, the channels' sums of the magnitudes
    of the terms that their gradients sum: ``|g|`` and ``|g x_hat|`` over
    the batch and the positions, ``g`` the gradient at ``y``."""
    y = F.batch_norm(x, None, None, p["scale"], p["bias"], training=True,
                     eps=eps)
    dims = [0] + list(range(2, x.ndim))
    with torch.no_grad():
        var, mean = torch.var_mean(x, dim=dims, unbiased=False)
        new = {"mean": (1 - momentum) * s["mean"] + momentum * mean,
               "var": (1 - momentum) * s["var"] + momentum * var}
    if terms is not None and y.requires_grad:
        shape = [1, -1] + [1] * (x.ndim - 2)
        xd, m, r = x.detach(), mean.view(shape), \
            torch.rsqrt(var + eps).view(shape)

        def record(g):
            with torch.no_grad():
                terms[id(p["bias"])] = g.abs().sum(dims)
                terms[id(p["scale"])] = (g * ((xd - m) * r)).abs().sum(dims)
        y.register_hook(record)
    return y, new


def nll(logits, y):
    """Mean over the batch of ``-log softmax(logits)[label]``."""
    return F.cross_entropy(logits, y.long())


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def sgd_steps(loss_fn: Callable, params: dict, state: dict, batches: list,
              lr: float, gen, precision: str = "float32") -> dict:
    """Plain SGD, ``p <- p - lr * g`` with ``lr`` in float32, over
    ``batches`` (``[(x, y)]``).  ``loss_fn(params, state, x, y, gen,
    precision, terms) -> (loss, new_state)``.  Returns the step losses, the
    first gradient, the params after the first and the last step, the state
    after the last, and ``cancel1``: for each batchnorm leaf, the norm of
    its first gradient over the norm of its terms' summed magnitudes
    (:func:`batchnorm`), 1 where nothing cancels and near 0 where the terms
    cancel to a residue that rounding decides."""
    lr32 = torch.tensor(lr, dtype=torch.float32).item()
    out = {"loss": []}
    for k, (x, y) in enumerate(batches):
        flat = leaves(params)
        req = {}
        for path, t in flat:
            set_path(req, path, t.detach().requires_grad_())
        terms = {} if k == 0 else None
        loss, state = loss_fn(req, state, x, y, gen, precision, terms)
        grads = torch.autograd.grad(loss, [t for _, t in leaves(req)])
        new = {}
        for (path, t), g in zip(flat, grads):
            set_path(new, path, t - lr32 * g)
        if k == 0:
            grad1 = {}
            for (path, _), g in zip(flat, grads):
                set_path(grad1, path, g)
            out["grad1"], out["params1"] = grad1, new
            out["cancel1"] = {
                path: float(g.double().norm())
                / max(float(terms[id(t)].double().norm()), 1e-300)
                for (path, t), g in zip(leaves(req), grads)
                if id(t) in terms}
        out["loss"].append(float(loss.detach()))
        params = new
        del req, grads, loss
    out["params"], out["state"] = params, tree_map(torch.Tensor.detach, state)
    return out
