"""Pytree <-> flat-buffer packing for single-launch fused updates —
counterpart of ``distlearn_tpu/ops/flatten.py``.

The reference updates tensor by tensor through walkTable
(lua/AllReduceSGD.lua:24, lua/AllReduceEA.lua:35-39).  The fused path packs
every leaf into a few padded flat buckets, one per dtype (capped by
``max_bucket_bytes``), so the gradient allreduce and the optimizer kernel
each stream over memory once.  Buckets are padded to ``TILE = 1024``
elements, the JAX package's layout, so both packages plan identical buckets.

:func:`unpack_buckets` returns leaves that are views into the bucket, so
unpacking copies nothing; :func:`pack_buckets` concatenates (one copy of the
bucket's bytes).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from distlearn_tpu_torch.utils.tree import (tree_flatten, tree_leaves,
                                            tree_unflatten)

PyTree = Any

LANE = 128
SUBLANE = 8
TILE = LANE * SUBLANE


def _numel(shape) -> int:
    return int(np.prod(shape)) if shape else 1


def _round_up(n: int) -> int:
    return ((n + TILE - 1) // TILE) * TILE


class FlatSpec(NamedTuple):
    treedef: Any
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    sizes: tuple[int, ...]
    offsets: tuple[int, ...]
    padded: int           # total flat length, multiple of TILE


def make_spec(tree: PyTree) -> FlatSpec:
    leaves, treedef = tree_flatten(tree)
    shapes = tuple(tuple(l.shape) for l in leaves)
    sizes = tuple(_numel(s) for s in shapes)
    offsets = tuple(int(x) for x in np.cumsum((0,) + sizes[:-1]))
    return FlatSpec(treedef, shapes, tuple(l.dtype for l in leaves), sizes,
                    offsets, _round_up(sum(sizes)))


def pack(spec: FlatSpec, tree: PyTree, dtype=torch.float32) -> torch.Tensor:
    """Concatenate every leaf (cast to ``dtype``) into one ``[padded]``
    vector, zero-padded."""
    leaves = tree_leaves(tree)
    pad = spec.padded - sum(spec.sizes)
    parts = [l.reshape(-1).to(dtype) for l in leaves]
    if pad:
        parts.append(torch.zeros(pad, dtype=dtype, device=leaves[0].device))
    return torch.cat(parts)


def unpack(spec: FlatSpec, flat: torch.Tensor) -> PyTree:
    leaves = [flat[off:off + size].to(dt).view(shape)
              for shape, dt, size, off in zip(spec.shapes, spec.dtypes,
                                              spec.sizes, spec.offsets)]
    return tree_unflatten(spec.treedef, leaves)


# ---------------------------------------------------------------------------
# Dtype-grouped buckets
# ---------------------------------------------------------------------------

class Bucket(NamedTuple):
    """One contiguous flat buffer holding a run of same-dtype leaves."""
    dtype: torch.dtype
    idx: tuple[int, ...]                  # leaf indices (flatten order)
    shapes: tuple[tuple[int, ...], ...]
    sizes: tuple[int, ...]
    offsets: tuple[int, ...]
    padded: int                           # bucket length, multiple of TILE


class BucketSpec(NamedTuple):
    treedef: Any
    n_leaves: int
    buckets: tuple[Bucket, ...]


def make_bucket_spec(tree: PyTree,
                     max_bucket_bytes: int | None = None) -> BucketSpec:
    """Plan the packing of a pytree into per-dtype flat buckets.

    Leaves of different dtypes never share a bucket (no casting), and
    ``max_bucket_bytes`` starts a new bucket before one would exceed it
    (``None``: one bucket per dtype).  A single leaf larger than the cap
    gets a bucket of its own.
    """
    leaves, treedef = tree_flatten(tree)
    groups: dict[torch.dtype, list[int]] = {}
    for i, l in enumerate(leaves):
        groups.setdefault(l.dtype, []).append(i)
    buckets = []

    def _flush(dt, chunk):
        shapes = tuple(tuple(leaves[j].shape) for j in chunk)
        sizes = tuple(_numel(s) for s in shapes)
        offsets = tuple(int(x) for x in np.cumsum((0,) + sizes[:-1]))
        buckets.append(Bucket(dtype=dt, idx=tuple(chunk), shapes=shapes,
                              sizes=sizes, offsets=offsets,
                              padded=_round_up(sum(sizes))))

    for dt, idxs in groups.items():
        itemsize = torch.empty((), dtype=dt).element_size()
        cap = None if max_bucket_bytes is None else \
            max(1, int(max_bucket_bytes) // itemsize)
        chunk: list[int] = []
        total = 0
        for i in idxs:
            size = _numel(leaves[i].shape)
            if chunk and cap is not None and total + size > cap:
                _flush(dt, chunk)
                chunk, total = [], 0
            chunk.append(i)
            total += size
        if chunk:
            _flush(dt, chunk)
    return BucketSpec(treedef=treedef, n_leaves=len(leaves),
                      buckets=tuple(buckets))


def pack_buckets(spec: BucketSpec, tree: PyTree) -> list[torch.Tensor]:
    """Pack a pytree into the bucket buffers (one ``[padded]`` tensor each,
    zero-padded)."""
    leaves = tree_leaves(tree)
    flats = []
    for b in spec.buckets:
        parts = [leaves[j].reshape(-1) for j in b.idx]
        used = sum(b.sizes)
        if b.padded > used:
            parts.append(torch.zeros(b.padded - used, dtype=b.dtype,
                                     device=parts[0].device))
        flats.append(torch.cat(parts))
    return flats


def unpack_buckets(spec: BucketSpec, flats: Sequence[torch.Tensor]) -> PyTree:
    """Leaves as views into the bucket buffers (no copy)."""
    leaves: list = [None] * spec.n_leaves
    for b, flat in zip(spec.buckets, flats):
        for j, shape, size, off in zip(b.idx, b.shapes, b.sizes, b.offsets):
            leaves[j] = flat[off:off + size].view(shape)
    return tree_unflatten(spec.treedef, leaves)
