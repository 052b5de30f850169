"""Move parameters between the JAX package's layout and the port's.

The JAX package stores conv kernels HWIO and dense weights ``[in, out]``;
the port stores them OIHW and ``[out, in]``.  Everything else (biases,
batchnorm scale/bias and running statistics) keeps its shape.  The
transformer LM keeps the JAX layouts unchanged (:func:`lm_from_jax`,
:func:`lm_to_jax`); :func:`lm_shard` cuts a whole LM tree to one rank's
shard over a :class:`~distlearn_tpu_torch.parallel.mesh.Mesh` and
:func:`lm_gather` puts the shards back together; :func:`lm_pp_shard`,
:func:`fsdp_shard` and :func:`lm_zero_from_jax` carry the pipeline
stages, the FSDP shards and the ZeRO-1 state across (each with its
inverse); :func:`lm_shard_records` and :func:`lm_zero_records` give the
regions of the JAX package's global arrays that a rank holds, for
sharded checkpoints both packages read (:func:`lm_zero_restore`).  The
JAX side is nested dicts of numpy arrays (``jax.device_get`` of its
pytrees; optax states are named tuples, walked as tuples), so this module
needs no JAX.

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
    ``device`` (the mesh's by default), cast to ``dtype`` when given; a
    tensor leaf is cut on its own device."""
    from distlearn_tpu_torch.models.transformer import param_specs
    device = mesh.device if device is None else device

    def leaf(a, spec):
        t = _lm_leaf(a, None, None)
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


def lm_pp_shard(params, mesh, depth: int, pipe_axis: str = "pipe",
                device=None, dtype=None):
    """``(shared, stacked)`` of this rank's pipeline stage from a whole LM
    tree (JAX's nested numpy dicts or the port's tensors, per-block
    layout): :func:`~distlearn_tpu_torch.train.lm.stack_blocks` of it, and
    of ``stacked`` only the stage's ``k = depth/S`` blocks, rows
    ``[s*k, (s+1)*k)`` for pipe rank ``s``.  Tensors on ``device`` (the
    mesh's by default), cast to ``dtype`` when given."""
    from distlearn_tpu_torch.train.lm import stack_blocks
    device = mesh.device if device is None else device
    pipe = mesh.axis(pipe_axis)
    k = depth // pipe.size
    shared, stacked = stack_blocks(lm_from_jax(params), depth)
    stage = _walk(stacked, lambda _k, t: t[pipe.index * k:
                                           (pipe.index + 1) * k])
    move = lambda _k, t: t.contiguous().to(device=device,  # noqa: E731
                                           dtype=dtype)
    return _walk(shared, move), _walk(stage, move)


def lm_pp_gather(shared, stacked, mesh, depth: int,
                 pipe_axis: str = "pipe"):
    """The inverse of :func:`lm_pp_shard`: every rank of the pipe axis
    calls it (collective) and gets the whole per-block tree as nested
    dicts of numpy arrays (bfloat16 leaves as float32)."""
    from distlearn_tpu_torch.parallel.mesh import all_gather_raw
    from distlearn_tpu_torch.train.lm import unstack_blocks
    pipe = mesh.axis(pipe_axis)
    whole = _walk(stacked, lambda _k, t: all_gather_raw(t, pipe, 0))
    return lm_to_jax(unstack_blocks(shared, whole, depth))


def fsdp_shard(params, mesh, data_axis: str = "data", device=None,
               dtype=None):
    """This rank's FSDP shards of a whole tree: every leaf cut along the
    dimension ``train/optim.py::fsdp_param_specs`` names into the data
    axis's size equal blocks, block ``axis_index`` kept (replicated leaves
    whole)."""
    from distlearn_tpu_torch.train.optim import _fsdp_dims
    from distlearn_tpu_torch.utils.tree import (tree_flatten,
                                                tree_unflatten)
    device = mesh.device if device is None else device
    data = mesh.axis(data_axis)
    leaves, treedef = tree_flatten(lm_from_jax(params))
    out = []
    for t, d in zip(leaves, _fsdp_dims(params, data.size)):
        if d is not None:
            n = t.shape[d] // data.size
            t = t.narrow(d, data.index * n, n)
        out.append(t.contiguous().to(device=device, dtype=dtype))
    return tree_unflatten(treedef, out)


def fsdp_gather(shards, mesh, params_template, data_axis: str = "data"):
    """The inverse of :func:`fsdp_shard` (collective over the data axis):
    the whole tree as nested dicts of numpy arrays; ``params_template``
    (the whole tree, shapes only) names each leaf's sharded dimension."""
    from distlearn_tpu_torch.parallel.mesh import all_gather_raw
    from distlearn_tpu_torch.train.optim import _fsdp_dims
    from distlearn_tpu_torch.utils.tree import (tree_flatten,
                                                tree_unflatten)
    data = mesh.axis(data_axis)
    leaves, treedef = tree_flatten(shards)
    dims = _fsdp_dims(params_template, data.size)
    return lm_to_jax(tree_unflatten(treedef, [
        t if d is None else all_gather_raw(t, data, d)
        for t, d in zip(leaves, dims)]))


def lm_zero_from_jax(state, tx, index, params=None, device="cpu"):
    """A JAX ``LMZeroState`` (numpy leaves, ``jax.device_get`` of it) as
    one rank's port :class:`~distlearn_tpu_torch.train.optim.LMZeroState`:
    the master row ``[r]`` and the optimizer state's rows (``count``,
    ``mu``, ``nu``: leaf order, the port's ``tx.init`` giving the
    structure) for ``index = r`` on a data-only tree, ``(d, t)`` on the
    (data, seq, model) mesh.  ``params`` is the rank's working params
    (default: the JAX params whole, as on a data-only tree; on the mesh
    pass their ``lm_shard``)."""
    from distlearn_tpu_torch.train.optim import LMZeroState
    from distlearn_tpu_torch.utils.tree import (tree_flatten, tree_leaves,
                                                tree_unflatten)

    def row(a, dtype=None):
        return torch.from_numpy(np.array(np.asarray(a)[index])).to(
            device=device, dtype=dtype)
    master = row(state.master, torch.float32)
    leaves, treedef = tree_flatten(tx.init(master))
    opt = tree_unflatten(treedef, [
        row(a, t.dtype) for a, t in zip(tree_leaves(state.opt_state),
                                        leaves)])
    if params is None:
        params = lm_from_jax(state.params, device=device)
    return LMZeroState(params, master, opt)


def lm_zero_to_jax(states, shape=None):
    """The inverse of :func:`lm_zero_from_jax` over every rank's state
    (``states`` in row-major rank order of ``shape``, ``(n,)`` by
    default): ``(master, opt_leaves)`` as numpy, the master ``[*shape,
    chunk]`` and each optimizer leaf stacked the same way, in JAX's leaf
    order."""
    from distlearn_tpu_torch.utils.tree import tree_leaves
    shape = (len(states),) if shape is None else tuple(shape)

    def stack(ts):
        a = np.stack([t.detach().cpu().numpy() for t in ts])
        return a.reshape(shape + a.shape[1:])
    opt = [stack(col) for col in zip(*(tree_leaves(s.opt_state)
                                       for s in states))]
    return stack([s.master for s in states]), opt


def _replicas_elsewhere(mesh, cut) -> bool:
    """True unless this rank is at index 0 of every axis of ``mesh`` not in
    ``cut`` (the axes a leaf is split over): a replicated region is
    written once, by that rank."""
    return any(mesh.axis_index(a) for a in mesh.axis_names if a not in cut)


def lm_shard_records(shard, mesh, tp_axis: str | None = None,
                     ep_axis: str | None = None, once: bool = True):
    """This rank's :class:`~distlearn_tpu_torch.utils.checkpoint.Shard`
    records of an :func:`lm_shard` tree: each leaf as its region of the
    whole leaf (the dimensions ``param_specs`` assigns to a mesh axis cut
    at this rank's index).  With ``once``, a region that other ranks hold
    too (along the axes that do not cut the leaf) is left to the rank at
    index 0 of those axes (``None`` here), so that the files hold it once;
    ``once=False`` gives every rank its records (restore templates)."""
    from distlearn_tpu_torch.models.transformer import param_specs
    from distlearn_tpu_torch.utils.checkpoint import Shard

    def leaf(t, spec):
        if once and _replicas_elsewhere(mesh, spec):
            return None
        shape, index = list(t.shape), [[0, d] for d in t.shape]
        for dim, name in enumerate(spec):
            if name is not None:
                n, i = mesh.axis_size(name), mesh.axis_index(name)
                shape[dim] = t.shape[dim] * n
                index[dim] = [i * t.shape[dim], (i + 1) * t.shape[dim]]
        return Shard(t, index, shape)
    return _specs_walk(shard, param_specs(shard, tp_axis, ep_axis), leaf)


def lm_zero_records(state, tree, data_axis: str = "data",
                    tp_axis: str | None = None, once: bool = True) -> dict:
    """This rank's records of a port
    :class:`~distlearn_tpu_torch.train.optim.LMZeroState` in the JAX
    package's layout, keyed as its ``LMZeroState._asdict()``: the master
    row ``[chunk]`` as region ``[[r, r+1], [0, chunk]]`` of JAX's ``[n,
    chunk]`` (data rank ``r``), each optimizer leaf the same way (``count``
    region ``[[r, r+1]]`` of ``[n]``), the params
    (:func:`lm_shard_records`) whole.  With ``tp_axis`` (the ``(data, seq,
    model)`` mesh's state) the master is row ``[d, t]`` of ``[dp, tp,
    chunk]`` and the params their tp regions.
    ``once`` as in :func:`lm_shard_records`: replicated regions are written
    by one rank."""
    from distlearn_tpu_torch.train.lm import as_mesh
    from distlearn_tpu_torch.utils.checkpoint import Shard
    from distlearn_tpu_torch.utils.tree import tree_map
    mesh = as_mesh(tree, data_axis)
    cut = (data_axis,) if tp_axis is None else (data_axis, tp_axis)
    lead = [mesh.axis(a) for a in cut]
    skip = once and _replicas_elsewhere(mesh, cut)

    def row(t):
        if skip:
            return None
        return Shard(t.reshape((1,) * len(lead) + tuple(t.shape)),
                     [[a.index, a.index + 1] for a in lead]
                     + [[0, d] for d in t.shape],
                     tuple(a.size for a in lead) + tuple(t.shape))
    return {"params": lm_shard_records(state.params, mesh, tp_axis,
                                       once=once),
            "master": row(state.master),
            "opt_state": tree_map(row, state.opt_state)}


def lm_zero_restore(directory: str, like, tree, data_axis: str = "data",
                    tp_axis: str | None = None, step: int | None = None):
    """This rank's :class:`~distlearn_tpu_torch.train.optim.LMZeroState`
    from a sharded checkpoint of the whole state, written by the port's
    ranks (:func:`lm_zero_records`) or by the JAX package (its
    ``LMZeroState._asdict()``): ``like`` is a state of the same layout on
    the wanted device (a fresh ``init_lm_zero_state``), of which only the
    shapes, dtypes and device are used.  Reads only this rank's regions.
    Returns ``(state, metadata)``."""
    from distlearn_tpu_torch.train.optim import LMZeroState
    from distlearn_tpu_torch.utils.checkpoint import restore_sharded_checkpoint
    from distlearn_tpu_torch.utils.tree import tree_map
    got, meta = restore_sharded_checkpoint(
        directory, lm_zero_records(like, tree, data_axis, tp_axis,
                                   once=False), step=step)

    def put(t, ref):
        return t.reshape(ref.shape).to(device=ref.device)
    return LMZeroState(tree_map(put, got["params"], like.params),
                       put(got["master"], like.master),
                       tree_map(put, got["opt_state"], like.opt_state)), meta


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
