"""The shared base of the host collectives — the part of
``distlearn_tpu/comm/backend.py`` (``:73-190``) that ``comm/tree.py`` and
``comm/ring.py`` stand on: :class:`HostCollectiveBase` (walkTable parity,
``node_index``, op-timeout arming, NIC accounting, the ``all_reduce`` and
``barrier`` derivations), the reduction identities and the ``sync_*``
telemetry families.  The backends themselves (``HostBackend``,
``MeshBackend``, ``HybridBackend``) come with ROADMAP A9(d).

Where the JAX package reduces host arrays only, the port's handles also
take torch tensors: a tensor leaf is staged into one frame buffer the
handle owns (pinned for tensors on the card, :mod:`..ops.staging`), the
reduction runs in place on the frame's views, and the result comes back as
fresh tensors on the leaves' device.  The helpers for that trip live here,
so both topologies stage and return alike.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from distlearn_tpu_torch import obs
from distlearn_tpu_torch.comm import wire
from distlearn_tpu_torch.ops import staging
from distlearn_tpu_torch.utils.tree import tree_map

PyTree = Any


def _identity(dtype: np.dtype, op: str):
    """Reduction identity for a non-contributing rank's slot."""
    if op == "sum":
        return 0
    if op == "max":
        return -np.inf if np.issubdtype(dtype, np.floating) \
            else np.iinfo(dtype).min
    if op == "min":
        return np.inf if np.issubdtype(dtype, np.floating) \
            else np.iinfo(dtype).max
    raise ValueError(f"unknown op {op!r}")


# ---------------------------------------------------------------------------
# Telemetry (the JAX package's "sync" catalog): one family each, labelled
# by backend, shared by every handle in the process.
# ---------------------------------------------------------------------------

def _sync_rounds():
    return obs.counter("sync_rounds_total",
                       "collective rounds completed, by backend",
                       labels=("backend",))


def _sync_host_bytes():
    return obs.counter("sync_host_leg_bytes_total",
                       "TCP bytes this handle moved during collective "
                       "rounds (NIC in+out), by backend",
                       labels=("backend",))


def _sync_logical_bytes():
    return obs.counter("sync_logical_bytes_total",
                       "logical payload bytes reduced per round, "
                       "by backend", labels=("backend",))


def _sync_seconds():
    return obs.histogram("sync_seconds",
                         "one collective round wall time, by backend",
                         labels=("backend",))


def tensor_device(leaves: list) -> torch.device | None:
    """The one device of a leaf list of torch tensors, or ``None`` for host
    arrays; a list that mixes the two, or tensors on two devices, raises."""
    kinds = {isinstance(x, torch.Tensor) for x in leaves}
    if kinds != {True}:
        if True in kinds:
            raise TypeError("a collective's leaves are all torch tensors or "
                            "all host arrays, not a mix")
        return None
    devs = {x.device for x in leaves}
    if len(devs) != 1:
        raise ValueError(f"tensor leaves on several devices: {sorted(map(str, devs))}")
    return devs.pop()


class HostCollectiveBase:
    """Everything a TCP collective handle shares regardless of topology.

    Subclasses (:class:`~distlearn_tpu_torch.comm.tree.Tree`,
    :class:`~distlearn_tpu_torch.comm.ring.Ring`) provide ``rank``,
    ``num_nodes``, ``_links()`` (their live data-plane conns) and
    ``all_reduce_ex``; the walkTable parity, op-timeout arming, NIC
    accounting, the ``all_reduce``/``barrier`` derivations and the staging
    of tensor leaves live here once.

    ``last_split`` holds the last tensor round's ``(stage, round, return)``
    seconds on the host clock: the device-to-host staging (ending in its
    stream synchronize), the host reduction, and the enqueue of the copies
    back (which the caller's next synchronize completes).
    """

    rank: int
    num_nodes: int
    _frame: wire.FrameBuffer | None = None
    last_split: tuple[float, float, float] | None = None

    def _links(self) -> list:
        """Live data-plane conns of this handle (subclass hook)."""
        raise NotImplementedError

    # -- walkTable parity ---------------------------------------------------
    @staticmethod
    def walk(tree: PyTree, fn: Callable) -> PyTree:
        return tree_map(fn, tree)

    @property
    def node_index(self) -> int:
        return self.rank

    def set_op_timeout(self, seconds: float | None):
        """(Re)arm failure detection on every live link: any collective
        that waits longer than this many seconds on one peer raises
        :class:`TimeoutError` instead of wedging the job (the reference
        blocks forever — SURVEY.md §5).  ``None`` restores the
        reference's block-forever semantics."""
        self.op_timeout = seconds
        for conn in self._links():
            conn.set_timeout(seconds)

    def nic_bytes(self) -> int:
        """Total TCP payload bytes this handle has moved (in + out over
        every live link) — the per-NIC traffic number the ``sync_*``
        metrics report."""
        return sum(c.bytes_sent + c.bytes_received for c in self._links())

    # -- derived collectives ------------------------------------------------
    def all_reduce(self, value: PyTree, op: str = "sum",
                   contrib: bool = True) -> tuple[PyTree, int]:
        """Allreduce; returns ``(reduced, n_contributors)``.

        ``contrib=False`` reproduces the reference's zero-contribution
        flush (lua/AllReduceSGD.lua:37): this rank's values count as the
        reduction identity and it is excluded from ``n`` — but it still
        serves the reduction for the rest of the topology, which is how
        stopped nodes keep stragglers' reductions alive.  ``None`` means
        "contributes".
        """
        reduced, n, _ = self.all_reduce_ex(
            value, op=op, contrib=(True if contrib is None else contrib))
        return reduced, n

    def all_reduce_ex(self, value: PyTree, op: str = "sum",
                      contrib: bool = True, rider: int = 0
                      ) -> tuple[PyTree, int, int]:
        raise NotImplementedError

    def barrier(self):
        """All ranks rendezvous (reduce of a scalar)."""
        self.all_reduce(np.zeros((), np.int32))

    # -- tensor leaves: the trip through the handle's frame ------------------
    def _frame_for(self, device: torch.device) -> wire.FrameBuffer:
        """The handle's frame: pinned for tensors on the card, so each
        copy between it and the card is one DMA."""
        pinned = device.type == "cuda"
        fb = self._frame
        if fb is None or fb.pinned != pinned:
            if fb is not None:
                staging.wait(fb)
            fb = self._frame = wire.FrameBuffer(pinned=pinned)
        return fb

    def _stage(self, flats: list[torch.Tensor]) -> list[np.ndarray]:
        """A contributor's flat tensors (one device) into the frame: one
        copy a tensor, one stream synchronize.  Returns the frame's 1-D
        views, in order."""
        fb = self._frame_for(flats[0].device)
        return staging.stage_into(
            fb, flats, [staging.numpy_dtype(f.dtype) for f in flats])

    def _identity_windows(self, device: torch.device, sizes: list[int],
                          dtypes: list[np.dtype], op: str
                          ) -> list[np.ndarray]:
        """A non-contributor's frame views, filled with the reduction
        identity on the host: nothing is copied from the device."""
        views = staging.windows(self._frame_for(device), sizes, dtypes)
        for v, dt in zip(views, dtypes):
            v.fill(_identity(dt, op))
        return views

    def _windows_like(self, leaves: list[torch.Tensor]) -> list[np.ndarray]:
        """Frame views shaped as ``leaves`` (a receive lands in them)."""
        fb = self._frame_for(leaves[0].device)
        views = staging.windows(
            fb, [x.numel() for x in leaves],
            [staging.numpy_dtype(x.dtype) for x in leaves])
        return [v.reshape(tuple(x.shape)) for v, x in zip(views, leaves)]

    def _unstage(self, views: list[np.ndarray], device: torch.device
                 ) -> list[torch.Tensor]:
        """The frame's views back as fresh tensors on ``device``."""
        return staging.unstage(self._frame, views, device)

    def _release_frame(self) -> None:
        """Wait for the last copies back out of the frame (``close``): the
        pinned block must not return to the allocator while they read it."""
        if self._frame is not None:
            staging.wait(self._frame)
