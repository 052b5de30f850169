"""Checkpoints in the JAX package's format — counterpart of
``distlearn_tpu/utils/checkpoint.py`` (``save_checkpoint``,
``latest_step``, ``restore_checkpoint``, ``save_sharded_checkpoint``,
``restore_sharded_checkpoint``), over the port's
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
in the background (the AsyncEA center's HA checkpoints).

Sharded checkpoints: each process writes the regions of the global arrays
it holds to ``ckpt_{step}.shard{p}.npz`` (keys ``leaf#k``, a region each,
and ``leaf!``, the global shape and dtype, in ``__meta__``'s ``shards``),
and any process reassembles them, checking element by element that the
files cover every array.  Tensors carry no ``addressable_shards``: a leaf
that is one region of a larger array is a :class:`Shard` record, any other
leaf is written whole, and a ``None`` leaf is one this process leaves to
another (a replicated leaf written once).  ``models/convert.py`` builds the
records for ``lm_shard``'s layout and the ZeRO-1 states.  Either package
reads the other's files.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
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


def _dtype_name(leaf) -> str:
    """The numpy dtype name of a leaf (``bfloat16`` for bfloat16 tensors),
    as the JAX package records a global array's dtype."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return _BF16
        return str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


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


class Shard:
    """One region of a global array that this process holds — the port's
    counterpart of one of a ``jax.Array``'s ``addressable_shards``:
    ``data`` (a tensor or numpy array) is ``global[index]``, ``index``
    giving ``[start, stop]`` for each dimension of the global ``shape``."""

    __slots__ = ("data", "index", "shape")

    def __init__(self, data, index, shape):
        self.data = data
        self.index = [[int(a), int(b)] for a, b in index]
        self.shape = tuple(int(d) for d in shape)
        extent = tuple(b - a for a, b in self.index)
        if len(self.index) != len(self.shape) or tuple(data.shape) != extent \
                or any(a < 0 or b > d for (a, b), d in zip(self.index,
                                                          self.shape)):
            raise ValueError(f"a {tuple(data.shape)} shard cannot be region "
                             f"{self.index} of a {self.shape} array")


def _full_index(shape) -> list:
    return [[0, int(d)] for d in shape]


def save_sharded_checkpoint(directory: str, step: int, tree: PyTree,
                            metadata: dict | None = None, keep: int = 3,
                            process_index: int | None = None) -> str:
    """Write this process's regions of ``tree`` to
    ``{directory}/ckpt_{step}.shard{process_index}.npz`` atomically (the
    JAX package's format).  A :class:`Shard` leaf is written as its
    region, ``None`` is skipped, any other leaf is written whole.
    ``process_index`` defaults to the rank in the default process group
    (0 without one).  Process 0 prunes all but the ``keep`` newest steps,
    leaving files younger than ``_PRUNE_GRACE_SECS`` alone so that a
    straggler mid-write of an older step keeps its peers' files."""
    if process_index is None:
        import torch.distributed as dist
        process_index = dist.get_rank() if dist.is_initialized() else 0
    os.makedirs(directory, exist_ok=True)
    flat: dict[str, np.ndarray] = {}
    shard_meta: dict[str, dict] = {}
    for path, leaf in _flatten_with_path(tree):
        if leaf is None:
            continue
        key = _SEP.join(path)
        if isinstance(leaf, Shard):
            data, index, shape = leaf.data, leaf.index, leaf.shape
        else:
            data = leaf
            shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
                else np.shape(leaf)
            index = _full_index(shape)
        flat[f"{key}#0"], _ = _to_numpy(data)
        shard_meta[f"{key}#0"] = {"leaf": key, "index": index}
        shard_meta[f"{key}!"] = {"shape": list(shape),
                                 "dtype": _dtype_name(data)}
    # computed entries last: user metadata must not clobber the keys
    # reassembly depends on
    meta = {**(metadata or {}), "step": int(step),
            "process": int(process_index), "shards": shard_meta}
    path = os.path.join(directory, f"ckpt_{step}.shard{process_index}.npz")
    _atomic_savez(directory, path, meta, flat)
    if process_index == 0 and keep > 0:
        now = time.time()
        for old in _list_sharded_steps(directory)[:-keep]:
            for name in os.listdir(directory):
                if name.startswith(f"ckpt_{old}.shard") \
                        and name.endswith(".npz"):
                    full = os.path.join(directory, name)
                    try:
                        if now - os.path.getmtime(full) > _PRUNE_GRACE_SECS:
                            os.unlink(full)
                    except OSError:
                        pass   # another process may prune concurrently
    return path


_PRUNE_GRACE_SECS = 300.0   # see save_sharded_checkpoint


def _list_sharded_steps(directory: str) -> list[int]:
    steps = set()
    for name in os.listdir(directory):
        if name.startswith("ckpt_") and ".shard" in name \
                and name.endswith(".npz"):
            try:
                steps.add(int(name[5:name.index(".shard")]))
            except ValueError:
                pass
    return sorted(steps)


def latest_sharded_step(directory: str) -> int | None:
    steps = _list_sharded_steps(directory) if os.path.isdir(directory) \
        else []
    return steps[-1] if steps else None


def _want(leaf):
    """``(global shape, wanted region, dtype template)`` of a restore
    template leaf."""
    if isinstance(leaf, Shard):
        return leaf.shape, leaf.index, leaf.data
    shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
        else np.shape(leaf)
    return tuple(int(d) for d in shape), _full_index(shape), leaf


def restore_sharded_checkpoint(directory: str, like: PyTree,
                               step: int | None = None
                               ) -> tuple[PyTree, dict]:
    """Reassemble from every process's shard file (``step=None``: the
    newest) into the structure of ``like``; returns ``(tree,
    metadata of process 0)``.  A numpy leaf of ``like`` comes back as the
    whole global array, a tensor leaf (a ``meta`` tensor will do) as a CPU
    tensor, and a :class:`Shard` leaf as only its region, in the kind of
    its ``data``.  Global shape and dtype are checked against the
    template, and the files must cover every wanted element (counted
    element by element, one leaf at a time: replicated regions count
    once, overlapping ones cannot count twice)."""
    if step is None:
        step = latest_sharded_step(directory)
        if step is None:
            raise FileNotFoundError(f"no sharded checkpoints in {directory}")
    files = sorted(name for name in os.listdir(directory)
                   if name.startswith(f"ckpt_{step}.shard")
                   and name.endswith(".npz"))
    if not files:
        raise FileNotFoundError(f"no shard files for step {step}")
    opened, by_leaf, meta0 = [], {}, {}
    try:
        for name in files:
            z = np.load(os.path.join(directory, name), allow_pickle=False)
            opened.append(z)
            meta = json.loads(str(z["__meta__"]))
            if meta.get("process") == 0:
                meta0 = {k: v for k, v in meta.items() if k != "shards"}
            sm = meta["shards"]
            for skey, info in sm.items():
                if "leaf" in info and skey in z.files:
                    by_leaf.setdefault(info["leaf"], []).append(
                        (z, skey, info["index"], sm[f"{info['leaf']}!"]))
        new_leaves = []
        for pathspec, leaf in _flatten_with_path(like):
            key = _SEP.join(pathspec)
            if key not in by_leaf:
                raise KeyError(f"sharded checkpoint missing leaf {key!r}")
            new_leaves.append(_assemble(key, leaf, by_leaf[key]))
    finally:
        for z in opened:
            z.close()
    return tree_unflatten(tree_flatten(like)[1], new_leaves), meta0


def _assemble(key: str, leaf, shards: list):
    gshape, want, tmpl = _want(leaf)
    glob = shards[0][3]
    if tuple(glob["shape"]) != gshape:
        raise ValueError(f"leaf {key!r}: checkpoint shape "
                         f"{tuple(glob['shape'])} != {gshape}")
    name = glob["dtype"]
    if _dtype_name(tmpl) != name:
        raise ValueError(f"leaf {key!r}: checkpoint dtype {name} != "
                         f"{_dtype_name(tmpl)} (restore into a "
                         "matching-dtype template, or cast explicitly)")
    store = np.dtype(np.uint16) if name == _BF16 else np.dtype(name)
    out = np.empty(tuple(b - a for a, b in want), store)
    mask = np.zeros(out.shape, np.bool_)
    for z, skey, index, _ in shards:
        # the overlap of the stored region with the wanted one, in the
        # stored array's coordinates and in the output's
        lo = [max(a, c) for (a, _b), (c, _d) in zip(index, want)]
        hi = [min(b, d) for (_a, b), (_c, d) in zip(index, want)]
        if any(h <= l_ for l_, h in zip(lo, hi)) and out.size:
            continue
        dst = tuple(slice(l_ - c, h - c) for l_, h, (c, _d)
                    in zip(lo, hi, want))
        if mask[dst].all():
            continue          # already covered (a replicated region)
        src = tuple(slice(l_ - a, h - a) for l_, h, (a, _b)
                    in zip(lo, hi, index))
        arr = z[skey]
        if arr.dtype.kind == "V" and arr.dtype.fields is None:
            arr = arr.view(store)     # extension dtypes load as raw bytes
        out[dst] = arr[src]
        mask[dst] = True
    covered = int(np.count_nonzero(mask))
    del mask
    if covered < out.size:
        raise ValueError(f"leaf {key!r}: shard files cover {covered} of "
                         f"{out.size} elements — a process's file is missing")
    if isinstance(tmpl, torch.Tensor):
        t = torch.from_numpy(out)
        return t.view(torch.bfloat16) if name == _BF16 else t
    want_dtype = np.asarray(tmpl).dtype
    return out.view(want_dtype) if out.dtype != want_dtype else out


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
