"""Move parameters between the JAX package's layout and the port's.

The JAX package stores conv kernels HWIO and dense weights ``[in, out]``;
the port stores them OIHW and ``[out, in]``.  Everything else (biases,
batchnorm scale/bias and running statistics) keeps its shape.  The
transformer LM keeps the JAX layouts unchanged (:func:`lm_from_jax`,
:func:`lm_to_jax`).  The JAX side is nested dicts of numpy arrays
(``jax.device_get`` of its pytrees), so this module needs no JAX.

:data:`CONVNET_WIRE` is the convnets' layout on the AsyncEA wire: the JAX
package's, so that a JAX peer and a port peer exchange the same leaves.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch


def _leaf(name: str, a) -> torch.Tensor:
    a = np.asarray(a)
    if name == "w" and a.ndim == 4:          # HWIO -> OIHW
        a = a.transpose(3, 2, 0, 1)
    elif name == "w" and a.ndim == 2:        # [in, out] -> [out, in]
        a = a.T
    return torch.tensor(a)


def _leaf_to_jax(name: str, t) -> np.ndarray:
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)
    if name == "w" and a.ndim == 4:          # OIHW -> HWIO
        a = a.transpose(2, 3, 1, 0)
    elif name == "w" and a.ndim == 2:        # [out, in] -> [in, out]
        a = a.T
    return np.ascontiguousarray(a).reshape(a.shape)   # 0-d stays 0-d


def _permute_leaf(name: str, t: torch.Tensor, to_jax: bool) -> torch.Tensor:
    """The device-side twin of :func:`_leaf` / :func:`_leaf_to_jax`: a
    permuted contiguous copy of a conv or dense weight on its own device,
    any other leaf as it is.  Exact (a permutation moves no bits)."""
    if name == "w" and t.ndim == 4:
        return t.permute((2, 3, 1, 0) if to_jax else (3, 2, 0, 1)).contiguous()
    if name == "w" and t.ndim == 2:
        return t.t().contiguous()
    return t


def _walk(tree, leaf):
    return {k: (_walk(v, leaf) if isinstance(v, dict) else leaf(k, v))
            for k, v in tree.items()}


def from_jax(params_np, state_np, device="cpu"):
    """``(params, state)`` of a JAX model, as nested dicts of numpy arrays,
    to the port's ``(params, state)`` on ``device``."""
    move = lambda k, v: _leaf(k, v).to(device)
    return _walk(params_np, move), _walk(state_np, move)


def to_jax(tree):
    """A port pytree (params or state, nested dicts of tensors or numpy
    arrays) to the JAX package's layout as nested dicts of numpy arrays —
    the inverse of :func:`from_jax`."""
    return _walk(tree, _leaf_to_jax)


def _lm_leaf(a, device, dtype):
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a))
    return t.to(device=device, dtype=dtype)


def lm_from_jax(params_np, device="cpu", dtype=None):
    """A JAX transformer-LM tree (nested dicts of numpy arrays, per-block or
    scanned layout) to the port's tensors on ``device``.  The port keeps the
    JAX package's einsum layouts for the LM (``wq/wk/wv [E,H,D]``,
    ``wo [H,D,E]``, ``w1 [E,F]``, ``w2 [F,E]``, ``embed [V,E]``,
    ``pos [max_len,E]``), so every leaf keeps its shape: the convnet's
    ``w`` transposes never apply here.  ``dtype`` casts every leaf (None
    keeps each leaf's own)."""
    return _walk(params_np, lambda _k, a: _lm_leaf(a, device, dtype))


def lm_to_jax(tree):
    """The port's LM tree to nested dicts of numpy arrays in the JAX
    package's layout (the same shapes) — the inverse of
    :func:`lm_from_jax`.  bfloat16 leaves come back as float32, which
    numpy can hold."""
    def leaf(_k, t):
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.float()
            return np.ascontiguousarray(t.numpy())
        return np.ascontiguousarray(np.asarray(t))
    return _walk(tree, leaf)


class WireLayout(NamedTuple):
    """How a model's parameter tree travels on the AsyncEA wire:
    ``to_wire(tree)`` from the port's layout into the wire's, and
    ``from_wire(tree)`` back, both on the leaves' own device."""
    to_wire: Callable[[Any], Any]
    from_wire: Callable[[Any], Any]


#: The convnets (``mnist_cnn``, ``cifar_convnet``) on the wire in the JAX
#: package's layout: conv kernels HWIO, dense weights ``[in, out]``.  The
#: transformer LM needs none: it keeps the JAX layouts already.
CONVNET_WIRE = WireLayout(
    to_wire=lambda tree: _walk(tree, lambda k, t: _permute_leaf(k, t, True)),
    from_wire=lambda tree: _walk(tree,
                                 lambda k, t: _permute_leaf(k, t, False)))
