"""Staging between tensors and one contiguous host frame — counterpart of
``distlearn_tpu/ops/staging.py``.

A host collective (``comm/tree.py``, ``comm/ring.py``) reduces host
buffers and ships them with :meth:`Conn.send_packed`-style single frames.
:func:`stage_into` copies flat arrays into a reusable
:class:`~distlearn_tpu_torch.comm.wire.FrameBuffer`, one typed window each,
every window 16-byte aligned, and returns numpy views that alias the
frame, so the reduction runs in place with no gather copy.

* numpy arrays copy with ``np.copyto``, as in the JAX package;
* CPU tensors copy on the host;
* tensors on the card copy into a **pinned** frame: one device-to-host
  copy a tensor on the device's current stream, then one synchronize of
  that stream (not of the device, so ranks running as threads do not wait
  on each other).

:func:`unstage` is the return trip: one host-to-device copy of each view
into a fresh tensor.  Those copies may still be reading the frame when the
call returns, so :func:`unstage` leaves an event on the frame and every
later host write through this module (:func:`windows`, :func:`stage_into`)
waits for it first.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

if TYPE_CHECKING:
    from distlearn_tpu_torch.comm import wire


_NUMPY_DTYPES = {t: np.dtype(str(t).removeprefix("torch."))
                 for t in (torch.float16, torch.float32, torch.float64,
                           torch.int8, torch.int16, torch.int32, torch.int64,
                           torch.uint8, torch.bool)}


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype; raises for types numpy lacks
    (bfloat16), which no host collective reduces."""
    try:
        return _NUMPY_DTYPES[dtype]
    except KeyError:
        raise TypeError(f"no host collective takes {dtype} leaves") from None


def wait(fb: wire.FrameBuffer) -> None:
    """Block until the frame's last :func:`unstage` copies have read it."""
    if fb.busy is not None:
        fb.busy.synchronize()
        fb.busy = None


def windows(fb: wire.FrameBuffer, sizes: Sequence[int],
            dtypes: Sequence[np.dtype]) -> list[np.ndarray]:
    """Reserve ``fb`` and return one writable 1-D view per
    ``(size, dtype)``, back to back, each window 16-byte aligned."""
    wait(fb)
    offsets, total = [], 0
    for size, dt in zip(sizes, dtypes):
        total += (-total) % 16
        offsets.append(total)
        total += int(size) * np.dtype(dt).itemsize
    fb.reserve(total)
    return [fb.view(off, int(size) * np.dtype(dt).itemsize, np.dtype(dt),
                    (int(size),))
            for off, size, dt in zip(offsets, sizes, dtypes)]


def stage_into(fb: wire.FrameBuffer, arrays: Sequence,
               dtypes: Sequence[np.dtype]) -> list[np.ndarray]:
    """Stage flat arrays into ``fb``; return per-array host views.

    Args:
      fb: a :class:`~distlearn_tpu_torch.comm.wire.FrameBuffer`, grown
        (never shrunk) to the total size; pinned when any array is a
        tensor on the card (an unpinned frame raises there).
      arrays: flat (1-D) numpy arrays or torch tensors.
      dtypes: target dtype per array (the wire dtype of its group).

    Returns:
      One writable 1-D ``np.ndarray`` view per input, all aliasing
      ``fb.buf`` — mutating them mutates the frame that ships.  Tensors on
      the card have landed when this returns.
    """
    if len(arrays) != len(dtypes):
        raise ValueError(f"{len(arrays)} arrays vs {len(dtypes)} dtypes")
    dtypes = [np.dtype(dt) for dt in dtypes]
    for arr in arrays:
        if len(arr.shape) != 1:
            raise ValueError(f"stage_into takes flat vectors, got shape "
                             f"{tuple(arr.shape)}")
    views = windows(fb, [int(a.shape[0]) for a in arrays], dtypes)
    streams = {}
    for arr, dst in zip(arrays, views):
        if not isinstance(arr, torch.Tensor):
            np.copyto(dst, np.asarray(arr), casting="same_kind")
        elif arr.device.type == "cuda":
            if not fb.pinned:
                raise ValueError("tensors on the card stage through a pinned "
                                 "FrameBuffer (pinned=True)")
            torch.from_numpy(dst).copy_(arr.detach(), non_blocking=True)
            streams[arr.device] = torch.cuda.current_stream(arr.device)
        else:
            np.copyto(dst, arr.detach().numpy(), casting="same_kind")
    for stream in streams.values():
        stream.synchronize()
    return views


def unstage(fb: wire.FrameBuffer, views: Sequence[np.ndarray],
            device: torch.device) -> list[torch.Tensor]:
    """One copy of each view of ``fb`` into a fresh tensor of its shape
    and dtype on ``device``; never into a tensor the caller holds.  On the
    card the copies are asynchronous on the current stream, and ``fb``
    keeps an event that the next host write waits for."""
    out = []
    for v in views:
        src = torch.from_numpy(v)
        dst = torch.empty(src.shape, dtype=src.dtype, device=device)
        dst.copy_(src, non_blocking=device.type == "cuda")
        out.append(dst)
    if device.type == "cuda" and out:
        fb.busy = torch.cuda.Event()
        fb.busy.record(torch.cuda.current_stream(device))
    return out
