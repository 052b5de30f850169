"""Move JAX parameters into the port.

The JAX package stores conv kernels HWIO and dense weights ``[in, out]``;
the port stores them OIHW and ``[out, in]``.  Everything else (biases,
batchnorm scale/bias and running statistics) keeps its shape.  Inputs are
the JAX pytrees as numpy arrays (``jax.device_get`` of them), so this module
needs no JAX.
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


def _walk(tree, device):
    return {k: (_walk(v, device) if isinstance(v, dict)
                else _leaf(k, v).to(device)) for k, v in tree.items()}


def from_jax(params_np, state_np, device="cpu"):
    """``(params, state)`` of a JAX model, as nested dicts of numpy arrays,
    to the port's ``(params, state)`` on ``device``."""
    return _walk(params_np, device), _walk(state_np, device)
