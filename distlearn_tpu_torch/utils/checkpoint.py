"""Checkpoints in the JAX package's format — counterpart of the unsharded
half of ``distlearn_tpu/utils/checkpoint.py`` (``save_checkpoint``,
``latest_step``, ``restore_checkpoint``), over the port's
:mod:`~distlearn_tpu_torch.utils.tree` instead of ``jax.tree_util``.

Format: ``{directory}/ckpt_{step}.npz`` holding every leaf under its
key path (``block0/wq``) plus ``__meta__``, a JSON string with the
metadata, ``step``, ``keys`` and ``vdtypes`` (the true dtype of leaves that
npz can only store as raw bytes, e.g. ``bfloat16``).  Writes are atomic
(tmp + rename).  A checkpoint written by either package loads in the
other: bfloat16 tensors are written as 2-byte raw leaves recorded as
``bfloat16``, which is how the JAX package writes its bfloat16 arrays.

Leaves may be tensors (any device) or numpy arrays.  A restore returns
each leaf in the kind of its template leaf: a CPU tensor for a tensor
template, a numpy array for a numpy one.  :class:`AsyncCheckpointer` writes
in the background (the AsyncEA center's HA checkpoints).  Sharded
checkpoints wait for the training slices (ROADMAP A7/A11).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any

import numpy as np
import torch

from distlearn_tpu_torch.utils.tree import tree_flatten, tree_unflatten

PyTree = Any

_SEP = "/"
_BF16 = "bfloat16"


def _flatten_with_path(tree: PyTree, path=()) -> list[tuple[tuple, Any]]:
    """``(key path, leaf)`` pairs in ``jax.tree_util`` order: dict keys
    sorted, sequence elements by index, NamedTuple fields by name."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_path(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        names = tree._fields if hasattr(tree, "_fields") else \
            [str(i) for i in range(len(tree))]
        return [kv for n, c in zip(names, tree)
                for kv in _flatten_with_path(c, path + (str(n),))]
    return [(path, tree)]


def _to_numpy(leaf) -> tuple[np.ndarray, str | None]:
    """A leaf as numpy, and the true dtype name when npz stores raw bytes."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
        return t.numpy(), None
    a = np.asarray(leaf)
    if a.dtype.kind == "V" and a.dtype.fields is None:
        return a, a.dtype.name
    return a, None


def _atomic_savez(directory: str, path: str, meta: dict,
                  flat: dict[str, np.ndarray]) -> None:
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, __meta__=json.dumps(meta), **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(directory: str, step: int, tree: PyTree,
                    metadata: dict | None = None, keep: int = 3) -> str:
    """Write ``{directory}/ckpt_{step}.npz`` atomically; prune to ``keep``
    newest.  Returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    flat, vdtypes = {}, {}
    for path, leaf in _flatten_with_path(tree):
        key = _SEP.join(path)
        flat[key], vname = _to_numpy(leaf)
        if vname is not None:
            vdtypes[key] = vname
    # computed entries last: user metadata must not clobber the keys
    # restore depends on
    meta = {**(metadata or {}), "step": int(step), "keys": sorted(flat),
            "vdtypes": vdtypes}
    path = os.path.join(directory, f"ckpt_{step}.npz")
    _atomic_savez(directory, path, meta, flat)
    _prune(directory, keep)
    return path


def _prune(directory: str, keep: int):
    for step in sorted(_list_steps(directory))[:-keep] if keep > 0 else []:
        os.unlink(os.path.join(directory, f"ckpt_{step}.npz"))


def _list_steps(directory: str) -> list[int]:
    steps = []
    for name in os.listdir(directory):
        if name.startswith("ckpt_") and name.endswith(".npz"):
            try:
                steps.append(int(name[5:-4]))
            except ValueError:
                pass
    return steps


def latest_step(directory: str) -> int | None:
    steps = _list_steps(directory) if os.path.isdir(directory) else []
    return max(steps) if steps else None


def _torch_dtype(arr: np.ndarray, vname: str | None) -> torch.dtype:
    if vname == _BF16:
        return torch.bfloat16
    if arr.dtype.kind == "V":
        raise ValueError(f"raw {arr.dtype} leaf of unknown dtype {vname!r}")
    return torch.from_numpy(np.empty(0, arr.dtype)).dtype


def _to_tensor(arr: np.ndarray, vname: str | None) -> torch.Tensor:
    if vname == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def restore_checkpoint(directory: str, like: PyTree, step: int | None = None
                       ) -> tuple[PyTree, dict]:
    """Restore into the structure of ``like`` (shape and dtype checked leaf
    by leaf).  ``step=None`` -> newest.  Returns ``(tree, metadata)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step}.npz")
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    vdtypes = meta.get("vdtypes", {})
    new_leaves = []
    for pathspec, leaf in _flatten_with_path(like):
        key = _SEP.join(pathspec)
        if key not in flat:
            raise KeyError(f"checkpoint {path} missing leaf {key!r}")
        arr, vname = flat[key], vdtypes.get(key)
        is_tensor = isinstance(leaf, torch.Tensor)
        want_shape = tuple(leaf.shape) if is_tensor else np.shape(leaf)
        if arr.shape != want_shape:
            raise ValueError(f"leaf {key!r}: checkpoint shape {arr.shape} "
                             f"!= {want_shape}")
        if is_tensor:
            if (vname is None and arr.dtype == np.dtype("V2")
                    and leaf.dtype == torch.bfloat16):
                vname = _BF16   # pre-vdtypes checkpoints: the only 2-byte one
            got = _torch_dtype(arr, vname)
            if got != leaf.dtype:
                raise ValueError(
                    f"leaf {key!r}: checkpoint dtype {got} != {leaf.dtype} "
                    "(restore into a matching-dtype template, or cast "
                    "explicitly)")
            new_leaves.append(_to_tensor(arr, vname))
        else:
            want = np.asarray(leaf).dtype
            if arr.dtype != want:
                raise ValueError(
                    f"leaf {key!r}: checkpoint dtype {arr.dtype} != {want} "
                    "(restore into a matching-dtype template, or cast "
                    "explicitly)")
            new_leaves.append(arr)
    return tree_unflatten(tree_flatten(like)[1], new_leaves), meta


class AsyncCheckpointer:
    """Non-blocking checkpointing, the JAX package's ``AsyncCheckpointer``:
    :meth:`save` copies the leaves to host arrays at call time (later
    updates cannot tear the snapshot) and writes the npz on a worker
    thread; one write is in flight at a time (a second :meth:`save` waits
    for the first); :meth:`wait` blocks until the last write is on disk
    and re-raises any failure of the worker."""

    def __init__(self, directory: str, keep: int = 3):
        import threading
        self.directory = directory
        self.keep = keep
        self._threading = threading
        self._thread = None
        self._err: list[BaseException] = []

    def save(self, step: int, tree: PyTree,
             metadata: dict | None = None) -> None:
        self.wait()                      # backpressure + surface prior error

        def snapshot(x):
            if isinstance(x, torch.Tensor):
                return x.detach().cpu().clone()
            return np.array(x)

        leaves, treedef = tree_flatten(tree)
        host_tree = tree_unflatten(treedef, [snapshot(x) for x in leaves])

        def write():
            try:
                save_checkpoint(self.directory, step, host_tree,
                                metadata=metadata, keep=self.keep)
            except BaseException as e:  # noqa: BLE001 — re-raised in wait()
                self._err.append(e)

        self._thread = self._threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err:
            raise self._err.pop(0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()
        return False
