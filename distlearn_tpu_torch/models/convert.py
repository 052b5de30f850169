"""Move parameters between the JAX package's layout and the port's.

The JAX package stores conv kernels HWIO and dense weights ``[in, out]``;
the port stores them OIHW and ``[out, in]``.  Everything else (biases,
batchnorm scale/bias and running statistics) keeps its shape.  The JAX side
is nested dicts of numpy arrays (``jax.device_get`` of its pytrees), so this
module needs no JAX.
"""

from __future__ import annotations

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
    return np.ascontiguousarray(a)


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
