"""Move parameters between the JAX package's layout and the port's.

The JAX package stores conv kernels HWIO and dense weights ``[in, out]``;
the port stores them OIHW and ``[out, in]``.  Everything else (biases,
batchnorm scale/bias and running statistics) keeps its shape.  The
transformer LM keeps the JAX layouts unchanged (:func:`lm_from_jax`,
:func:`lm_to_jax`); :func:`lm_shard` cuts a whole LM tree to one rank's
shard over a :class:`~distlearn_tpu_torch.parallel.mesh.Mesh` and
:func:`lm_gather` puts the shards back together.  The JAX side is nested dicts of numpy arrays
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
    ``pos [max_len,E]``; MoE blocks' ``router [E,X]``, ``we1 [X,E,F]``,
    ``wb1 [X,F]``, ``we2 [X,F,E]``), so every leaf keeps its shape: the
    convnet's ``w`` transposes never apply here.  ``dtype`` casts every
    leaf (None keeps each leaf's own)."""
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


def _specs_walk(tree, specs, leaf):
    return {k: (_specs_walk(v, specs[k], leaf) if isinstance(v, dict)
                else leaf(v, specs[k])) for k, v in tree.items()}


def lm_shard(params, mesh, tp_axis: str | None = None,
             ep_axis: str | None = None, device=None, dtype=None):
    """This rank's shard of a whole transformer-LM tree (the JAX package's
    nested dicts of numpy arrays, or the port's tensors) over ``mesh``:
    each dimension that :func:`~distlearn_tpu_torch.models.transformer.
    param_specs` assigns to a mesh axis is cut into that axis's size equal
    blocks and this rank keeps block ``axis_index`` (heads and the MLP
    hidden over ``tp_axis``, experts over ``ep_axis``).  Returns tensors on
    ``device`` (the mesh's by default), cast to ``dtype`` when given."""
    from distlearn_tpu_torch.models.transformer import param_specs
    device = mesh.device if device is None else device

    def leaf(a, spec):
        t = _lm_leaf(a, "cpu", None)
        for dim, name in enumerate(spec):
            if name is None:
                continue
            n, i = mesh.axis_size(name), mesh.axis_index(name)
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of a {tuple(t.shape)} leaf "
                                 f"does not split over {name!r} ({n})")
            t = t.narrow(dim, i * (t.shape[dim] // n), t.shape[dim] // n)
        return t.contiguous().to(device=device, dtype=dtype)
    return _specs_walk(params, param_specs(params, tp_axis, ep_axis), leaf)


def lm_gather(shard, mesh, tp_axis: str | None = None,
              ep_axis: str | None = None):
    """The inverse of :func:`lm_shard`: every rank of ``mesh`` calls it
    (collective) and gets the whole tree as nested dicts of numpy arrays
    in the JAX package's layout (bfloat16 leaves as float32)."""
    from distlearn_tpu_torch.models.transformer import param_specs
    from distlearn_tpu_torch.parallel.mesh import all_gather_raw

    def leaf(t, spec):
        for dim, name in enumerate(spec):
            if name is not None:
                t = all_gather_raw(t, mesh.axis(name), dim)
        return t
    return lm_to_jax(_specs_walk(shard, param_specs(shard, tp_axis, ep_axis),
                                 leaf))


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
