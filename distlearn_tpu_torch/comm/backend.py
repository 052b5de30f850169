"""The collective backends — counterpart of ``distlearn_tpu/comm/backend.py``:
one sync API over the host TCP collectives and the rows one process drives.

* :class:`HostCollectiveBase` is what ``comm/tree.py`` and ``comm/ring.py``
  stand on (walkTable parity, ``node_index``, op-timeout arming, NIC
  accounting, the ``all_reduce`` and ``barrier`` derivations), with the
  reduction identities and the ``sync_*`` telemetry families.
* :class:`CollectiveBackend` is the protocol a sync algorithm may assume.
* :class:`HostBackend` adapts a :class:`Tree` or :class:`Ring` handle: one
  logical node per process, plain per-node values.
* :class:`MeshBackend` drives ``num_nodes`` logical nodes as the rows of
  stacked tensors on one device.  The JAX package's is a ``shard_map`` psum
  over a device mesh; a port node is a process of a ``torch.distributed``
  group (:class:`~distlearn_tpu_torch.parallel.mesh.MeshTree`), so here the
  rows live on one device and the sum runs over the row axis, in one
  process, with no process group.
* :class:`HybridBackend` is the hierarchical allreduce: the sum over this
  host's L rows, padded to L equal chunks (:func:`plan_chunks`), staged
  into one frame (:func:`~distlearn_tpu_torch.ops.staging.stage_into`),
  reduced across hosts over one :class:`Tree` or :class:`Ring` leg, and
  copied back to every row.

Value conventions, as in the JAX package: ``stacked_nodes is None`` means
plain per-node values; ``stacked_nodes == k`` means every leaf leads with a
``[k]`` row axis, the handle driving logical nodes ``node_offset ..
node_offset + k - 1``; after ``all_reduce`` every row holds the global sum.
The rows are summed in row order, a left fold of one elementwise add a
row, so the sum has the same bits on the CPU and on the card.

Where the JAX package reduces host arrays only, the port's handles also
take torch tensors: a tensor leaf is staged into one frame buffer the
handle owns (pinned for tensors on the card, :mod:`..ops.staging`), the
reduction runs in place on the frame's views, and the result comes back as
fresh tensors on the leaves' device.  The helpers for that trip live here,
so both topologies stage and return alike.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Protocol, runtime_checkable

import numpy as np
import torch

from distlearn_tpu_torch import obs
from distlearn_tpu_torch.comm import wire
from distlearn_tpu_torch.lint import spmd as lint_spmd
from distlearn_tpu_torch.ops import staging
from distlearn_tpu_torch.utils.platform import resolve_device
from distlearn_tpu_torch.utils.tree import (tree_flatten, tree_leaves,
                                            tree_map, tree_unflatten)

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


# ---------------------------------------------------------------------------
# The protocol
# ---------------------------------------------------------------------------

@runtime_checkable
class CollectiveBackend(Protocol):
    """What a sync algorithm (:class:`~distlearn_tpu_torch.parallel.
    allreduce_sgd.AllReduceSGD`, :class:`~distlearn_tpu_torch.parallel.
    allreduce_ea.AllReduceEA`, the AsyncEA client's slice reduction) may
    assume about its transport — the torch-ipc ``tree`` handle surface,
    topology-neutral.

    ``num_nodes`` counts LOGICAL nodes; ``stacked_nodes``/``node_offset``
    say how many of them this handle drives and which.  ``rider`` in
    :meth:`all_reduce_ex` is an integer summed per logical node across the
    topology (a handle driving k nodes contributes ``rider * k``).
    """

    num_nodes: int
    stacked_nodes: int | None
    node_offset: int

    @property
    def node_index(self) -> int: ...

    def all_reduce(self, value: PyTree, op: str = "sum",
                   contrib=True) -> tuple[PyTree, int]: ...

    def all_reduce_ex(self, value: PyTree, op: str = "sum",
                      contrib=True, rider: int = 0
                      ) -> tuple[PyTree, int, int]: ...

    def scatter(self, value: PyTree, src: int = 0) -> PyTree: ...

    def barrier(self) -> None: ...

    def set_op_timeout(self, seconds: float | None) -> None: ...

    def close(self) -> None: ...


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return np.asarray(x).nbytes


def _zeros_like(x):
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    return np.zeros_like(np.asarray(x))


# ---------------------------------------------------------------------------
# HostBackend — adapter over Tree / Ring
# ---------------------------------------------------------------------------

class HostBackend:
    """Adapter over a TCP :class:`Tree` or :class:`Ring` handle: one logical
    node per process, plain per-node values (numpy arrays, or tensors staged
    through the handle's frame), every collective delegating to the handle.

    ``scatter(value, src != 0)``, which the raw handles lack (torch-ipc
    scatter is root-broadcast only), is a masked allreduce: ``src``
    contributes its values, everyone else the additive identity — the
    winner broadcast of lua/AllReduceSGD.lua:44-50.
    """

    stacked_nodes: int | None = None

    def __init__(self, handle: HostCollectiveBase):
        self.handle = handle
        self.num_nodes = handle.num_nodes
        self.node_offset = handle.rank
        self._c_rounds = _sync_rounds()
        self._c_bytes = _sync_host_bytes()
        self._c_logical = _sync_logical_bytes()
        self._h_secs = _sync_seconds()

    @classmethod
    def create(cls, rank: int, num_nodes: int, host: str, port: int,
               transport: str = "tree", **kw) -> "HostBackend":
        """Build the handle too: ``transport`` is ``"tree"`` (extra kwarg
        ``base``) or ``"ring"``; the other kwargs go to the handle
        (``timeout``, ``op_timeout``, ``listen_host``, ``advertise_host``,
        ``fault_plan`` ...)."""
        if transport == "tree":
            from distlearn_tpu_torch.comm.tree import Tree
            return cls(Tree(rank, num_nodes, host, port, **kw))
        if transport == "ring":
            from distlearn_tpu_torch.comm.ring import Ring
            return cls(Ring(rank, num_nodes, host, port, **kw))
        raise ValueError(f"unknown host transport {transport!r} "
                         "(supported: tree, ring)")

    @property
    def node_index(self) -> int:
        return self.handle.node_index

    def all_reduce(self, value: PyTree, op: str = "sum",
                   contrib: bool = True) -> tuple[PyTree, int]:
        reduced, n, _ = self.all_reduce_ex(value, op=op, contrib=contrib)
        return reduced, n

    def all_reduce_ex(self, value: PyTree, op: str = "sum",
                      contrib: bool = True, rider: int = 0
                      ) -> tuple[PyTree, int, int]:
        contrib = True if contrib is None else bool(contrib)
        t0 = time.perf_counter()
        b0 = self.handle.nic_bytes()
        out = self.handle.all_reduce_ex(value, op=op, contrib=contrib,
                                        rider=rider)
        self._c_rounds.labels(backend="host").inc()
        self._c_bytes.labels(backend="host").inc(
            self.handle.nic_bytes() - b0)
        self._c_logical.labels(backend="host").inc(
            sum(_nbytes(x) for x in tree_leaves(value)))
        self._h_secs.labels(backend="host").observe(
            time.perf_counter() - t0)
        return out

    def scatter(self, value: PyTree, src: int = 0) -> PyTree:
        if src == 0:
            return self.handle.scatter(value)
        if not 0 <= src < self.num_nodes:
            raise ValueError(
                f"src={src} out of range for {self.num_nodes} nodes")
        mine = value if self.handle.rank == src else tree_map(_zeros_like,
                                                              value)
        out, _ = self.handle.all_reduce(mine,
                                        contrib=self.handle.rank == src)
        return out

    def barrier(self):
        self.handle.barrier()

    def set_op_timeout(self, seconds: float | None):
        self.handle.set_op_timeout(seconds)

    def close(self):
        self.handle.close()


# ---------------------------------------------------------------------------
# Stacked rows on one device: MeshBackend and the local half of HybridBackend
# ---------------------------------------------------------------------------

def _contrib_rows(contrib, rows: int) -> list[int] | None:
    """The protocol's ``contrib`` (bool | per-row mask | None) as a list of
    0/1 row flags, or ``None`` when every row contributes unmasked."""
    if contrib is None or contrib is True:
        return None
    if contrib is False:
        return [0] * rows
    if isinstance(contrib, torch.Tensor):
        contrib = contrib.cpu().numpy()
    cvec = np.asarray(contrib).astype(np.int64)
    if cvec.shape != (rows,):
        raise ValueError(f"contrib mask shape {cvec.shape} != ({rows},)")
    return [int(c != 0) for c in cvec]


def _row_sum(x: torch.Tensor, cvec: list[int] | None) -> torch.Tensor:
    """Sum over the leading row axis in row order.  A masked row enters as
    ``x[r] * c[r]``, as the JAX package masks before its psum."""
    rows = [x[r] if cvec is None else x[r] * cvec[r]
            for r in range(x.shape[0])]
    acc = rows[0].clone()
    for row in rows[1:]:
        acc += row
    return acc


def _to_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """One value repeated on every row: ``[rows, *x.shape]``, contiguous."""
    return x.unsqueeze(0).expand((rows,) + tuple(x.shape)).contiguous()


class _StackedRows:
    """The passthroughs of a handle whose values are ``[rows, ...]`` tensors
    on one device (``put_per_node``, ``replicate``, ``node_slice``)."""

    device: torch.device
    stacked_nodes: int

    def put_per_node(self, tree: PyTree) -> PyTree:
        """A stacked tree (leading axis ``stacked_nodes``) on the device."""
        def _put(x):
            x = torch.as_tensor(x)
            if x.ndim < 1 or x.shape[0] != self.stacked_nodes:
                raise ValueError(f"leading axis of {tuple(x.shape)} != "
                                 f"{self.stacked_nodes} rows")
            return x.to(self.device)
        return tree_map(_put, tree)

    def replicate(self, tree: PyTree) -> PyTree:
        """One value on every row: ``v -> [rows, *v.shape]``."""
        return tree_map(lambda x: _to_rows(
            torch.as_tensor(x).to(self.device), self.stacked_nodes), tree)

    def node_slice(self, tree: PyTree, i: int) -> PyTree:
        """Row ``i`` of every leaf (a view on the device)."""
        return tree_map(lambda x: x[i], tree)

    def _check_rows(self, leaves: list) -> None:
        for x in leaves:
            if not isinstance(x, torch.Tensor) or x.ndim < 1 \
                    or x.shape[0] != self.stacked_nodes:
                shape = tuple(getattr(x, "shape", ()))
                raise ValueError(
                    f"stacked values are [rows, ...] tensors: leaf shape "
                    f"{shape} does not lead with {self.stacked_nodes} rows")


class MeshBackend(_StackedRows):
    """``num_nodes`` logical nodes as the rows of stacked tensors on one
    device, every collective a sum over the row axis in this process.  Only
    ``op="sum"`` is served (max/min control-plane reductions stay on the
    host backends).  ``barrier``/``close``/``set_op_timeout`` are no-ops:
    one process has nothing to rendezvous with or time out."""

    def __init__(self, num_nodes: int, device=None):
        if num_nodes < 1:
            raise ValueError("num_nodes must be >= 1")
        self.device = resolve_device(device)
        self.num_nodes = int(num_nodes)
        self.stacked_nodes: int | None = self.num_nodes
        self.node_offset = 0
        self.op_timeout: float | None = None
        self._c_rounds = _sync_rounds()
        self._c_logical = _sync_logical_bytes()
        self._h_secs = _sync_seconds()

    @property
    def node_index(self) -> int:
        """First logical node this handle drives (it drives them all)."""
        return 0

    def all_reduce(self, value: PyTree, op: str = "sum",
                   contrib=True) -> tuple[PyTree, int]:
        if op != "sum":
            raise NotImplementedError(
                f"MeshBackend reduces op='sum' only (got {op!r}); use a "
                "host backend for control-plane max/min")
        t0 = time.perf_counter()
        leaves, treedef = tree_flatten(value)
        self._check_rows(leaves)
        cvec = _contrib_rows(contrib, self.num_nodes)
        out = [_to_rows(_row_sum(x, cvec), self.num_nodes) for x in leaves]
        for x in leaves:        # one psum a leaf over the row axis
            lint_spmd.note("all-reduce", "data", x[0])
        n = self.num_nodes if cvec is None else sum(cvec)
        self._c_rounds.labels(backend="mesh").inc()
        self._c_logical.labels(backend="mesh").inc(
            sum(_nbytes(x) // self.num_nodes for x in leaves))
        self._h_secs.labels(backend="mesh").observe(
            time.perf_counter() - t0)
        return tree_unflatten(treedef, out), n

    def all_reduce_ex(self, value: PyTree, op: str = "sum",
                      contrib=True, rider: int = 0
                      ) -> tuple[PyTree, int, int]:
        """The rider is per logical node: this handle contributes
        ``rider`` for each of its ``num_nodes`` rows."""
        out, n = self.all_reduce(value, op=op, contrib=contrib)
        return out, n, int(rider) * self.num_nodes

    def scatter(self, value: PyTree, src: int = 0) -> PyTree:
        """Row ``src`` on every row."""
        if not 0 <= src < self.num_nodes:
            raise ValueError(
                f"src={src} out of range for {self.num_nodes} nodes")
        return tree_map(lambda x: _to_rows(x[src], self.num_nodes), value)

    def barrier(self):
        pass

    def set_op_timeout(self, seconds: float | None):
        self.op_timeout = seconds

    def close(self):
        pass


# ---------------------------------------------------------------------------
# HybridBackend — the row sum, one host TCP leg per host, back to every row
# ---------------------------------------------------------------------------

def plan_chunks(total: int, parts: int) -> tuple[int, list[tuple[int, int]]]:
    """Even flat-element chunking: pad ``total`` elements up to a multiple
    of ``parts`` and return ``(padded_total, [(lo, hi), ...])``, ``parts``
    equal half-open ranges.  The pad is zeros."""
    if parts < 1:
        raise ValueError("parts must be >= 1")
    if total < 0:
        raise ValueError("total must be >= 0")
    pad = (-total) % parts
    padded = total + pad
    per = padded // parts
    return padded, [(i * per, (i + 1) * per) for i in range(parts)]


class HybridBackend(_StackedRows):
    """Hierarchical allreduce: L local rows behind ONE host TCP rank (the
    "client is a whole slice" deployment).

    ``all_reduce`` runs in three steps:

    1. **The local sum.** Each dtype group's leaves flatten into one
       ``[L, total]`` matrix (rows masked by ``contrib``), padded to L
       equal chunks (:func:`plan_chunks`) and summed over the rows.
    2. **One host leg.** The chunks, back to back, stage into one window of
       the backend's frame per dtype group
       (:func:`~distlearn_tpu_torch.ops.staging.stage_into`; pinned for
       rows on the card) and the wrapped :class:`Tree`/:class:`Ring`
       reduces those windows, the contributor count and the rider across
       hosts in one round, the same leaves as the JAX package's host leg
       (optionally through the int8/fp16 codec, ``codec=``).
    3. **Back to the rows.** The reduced windows copy back to the device
       and every row of each leaf gets the global sum.

    ``num_hosts=1`` has no host leg: the local sum goes straight back to
    the rows.  ``op_timeout`` and ``fault_plan`` go to the host leg, so a
    partition mid-collective surfaces the raw tree's typed error.
    ``last_split`` holds the last round's ``(stage, host round, return)``
    seconds on the host clock, the return ending in the copies' enqueue.
    """

    def __init__(self, rank: int = 0, num_hosts: int = 1,
                 host: str | None = None, port: int | None = None, *,
                 num_devices: int = 1, device=None,
                 transport: str = "tree", base: int = 2,
                 timeout: float = 60.0, listen_host: str | None = None,
                 advertise_host: str | None = None,
                 op_timeout: float | None = None, codec: str = "raw",
                 fault_plan=None, fault_link: str = "hybrid"):
        if not 0 <= rank < num_hosts:
            raise ValueError(f"rank {rank} out of range for {num_hosts} hosts")
        if codec not in wire.CODECS:
            raise ValueError(f"unknown wire codec {codec!r} "
                             f"(supported: {', '.join(wire.CODECS)})")
        if num_devices < 1:
            raise ValueError("num_devices must be >= 1")
        self.device = resolve_device(device)
        self.rank = rank
        self.num_hosts = int(num_hosts)
        self.local_nodes = int(num_devices)
        self.stacked_nodes: int | None = self.local_nodes
        self.num_nodes = self.num_hosts * self.local_nodes
        self.node_offset = rank * self.local_nodes
        self.codec = codec
        self._fb = wire.FrameBuffer(pinned=self.device.type == "cuda")
        self.last_split: tuple[float, float, float] | None = None
        self.host_leg = None
        if num_hosts > 1:
            if host is None or port is None:
                raise ValueError(
                    "num_hosts > 1 needs the coordinator host/port")
            if transport == "tree":
                from distlearn_tpu_torch.comm.tree import Tree
                self.host_leg = Tree(
                    rank, num_hosts, host, port, base=base, timeout=timeout,
                    listen_host=listen_host, advertise_host=advertise_host,
                    op_timeout=op_timeout, fault_plan=fault_plan,
                    fault_link=fault_link)
            elif transport == "ring":
                from distlearn_tpu_torch.comm.ring import Ring
                if codec != "raw":
                    raise ValueError(
                        "ring host leg is raw-only (chunked per-tensor "
                        "frames have nowhere to carry a scale)")
                self.host_leg = Ring(
                    rank, num_hosts, host, port, timeout=timeout,
                    listen_host=listen_host, advertise_host=advertise_host,
                    op_timeout=op_timeout, fault_plan=fault_plan,
                    fault_link=fault_link)
            else:
                raise ValueError(f"unknown host transport {transport!r}")
        self.op_timeout = op_timeout
        self._c_rounds = _sync_rounds()
        self._c_bytes = _sync_host_bytes()
        self._c_logical = _sync_logical_bytes()
        self._h_secs = _sync_seconds()

    @property
    def node_index(self) -> int:
        """First logical node of this host's slice."""
        return self.node_offset

    def set_op_timeout(self, seconds: float | None):
        self.op_timeout = seconds
        if self.host_leg is not None:
            self.host_leg.set_op_timeout(seconds)

    def barrier(self):
        if self.host_leg is not None:
            self.host_leg.barrier()

    def close(self):
        if self.host_leg is not None:
            self.host_leg.close()
        staging.wait(self._fb)

    def all_reduce(self, value: PyTree, op: str = "sum",
                   contrib=True) -> tuple[PyTree, int]:
        reduced, n, _ = self.all_reduce_ex(value, op=op, contrib=contrib)
        return reduced, n

    def _groups(self, leaves: list[torch.Tensor]):
        """Per dtype group, sorted by dtype name as the JAX package plans
        them: ``(dtype, leaf indices, total, padded)``."""
        groups: dict[torch.dtype, list[int]] = {}
        for i, x in enumerate(leaves):
            groups.setdefault(x.dtype, []).append(i)
        plans = []
        for dt, idxs in sorted(groups.items(), key=lambda kv: str(kv[0])):
            total = sum(leaves[i][0].numel() for i in idxs)
            padded, _ = plan_chunks(total, self.local_nodes)
            plans.append((dt, idxs, total, padded))
        return plans

    def all_reduce_ex(self, value: PyTree, op: str = "sum",
                      contrib=True, rider: int = 0
                      ) -> tuple[PyTree, int, int]:
        """Hierarchical allreduce of a stacked slice; ``contrib`` is a bool
        for the whole slice or a per-row mask ``[L]``; the contributor
        count and the rider cross the host leg as int64 leaves of the same
        round."""
        if op != "sum":
            raise NotImplementedError(
                f"HybridBackend reduces op='sum' only (got {op!r}); use a "
                "host backend for control-plane max/min")
        t0 = time.perf_counter()
        leaves, treedef = tree_flatten(value)
        self._check_rows(leaves)
        L = self.local_nodes
        cvec = _contrib_rows(contrib, L)
        plans = self._groups(leaves)
        sums = self._local_sums(leaves, cvec, plans)
        n_local = L if cvec is None else sum(cvec)
        r_local = int(rider) * L
        logical = sum(_nbytes(x) for x in sums)
        t1 = t2 = time.perf_counter()
        if self.host_leg is not None:
            views = staging.stage_into(
                self._fb, sums, [staging.numpy_dtype(dt) for dt, *_ in plans])
            t1 = time.perf_counter()
            b0 = self.host_leg.nic_bytes()
            red, _, _ = self.host_leg.all_reduce_ex(
                {"g": views, "n": np.asarray(n_local, np.int64),
                 "r": np.asarray(r_local, np.int64)},
                op="sum", contrib=True, rider=0, codec=self.codec)
            # the tree folds into 0-d buffers but may hand back [1] views
            n_total = int(np.asarray(red["n"]).reshape(()))
            r_total = int(np.asarray(red["r"]).reshape(()))
            self._c_bytes.labels(backend="hybrid").inc(
                self.host_leg.nic_bytes() - b0)
            t2 = time.perf_counter()
            for v, g in zip(views, red["g"]):     # the leg's own buffers
                np.copyto(v, g)
            sums = staging.unstage(self._fb, views, self.device)
        else:
            n_total, r_total = n_local, r_local
        out = self._back_to_rows(leaves, plans, sums)
        t3 = time.perf_counter()
        self.last_split = (t1 - t0, t2 - t1, t3 - t2)
        self._c_rounds.labels(backend="hybrid").inc()
        self._c_logical.labels(backend="hybrid").inc(logical)
        self._h_secs.labels(backend="hybrid").observe(t3 - t0)
        return tree_unflatten(treedef, out), n_total, r_total

    def _local_sums(self, leaves: list[torch.Tensor], cvec, plans
                    ) -> list[torch.Tensor]:
        """Step 1: each dtype group's rows (masked by ``cvec``) flattened,
        padded to L equal chunks and summed over the rows, the JAX
        package's in-mesh reduce-scatter (each row's chunk of the sum)."""
        L = self.local_nodes
        sums = []
        for dt, idxs, total, padded in plans:
            parts = [leaves[i].reshape(L, -1) for i in idxs]
            if padded > total:
                parts.append(torch.zeros((L, padded - total), dtype=dt,
                                         device=leaves[idxs[0]].device))
            s = _row_sum(torch.cat(parts, dim=1), cvec)
            lint_spmd.note("reduce-scatter", "data", s,
                           nbytes=s.numel() * s.element_size() // L)
            sums.append(s)
        return sums

    def _back_to_rows(self, leaves: list[torch.Tensor], plans,
                      sums: list[torch.Tensor]) -> list[torch.Tensor]:
        """Step 3: every row of each leaf gets its part of the reduced
        flat sums, the JAX package's all-gather of the chunks."""
        L = self.local_nodes
        out: list = [None] * len(leaves)
        for (dt, idxs, total, padded), flat in zip(plans, sums):
            lint_spmd.note("all-gather", "data", flat)
            o = 0
            for i in idxs:
                shape = tuple(leaves[i].shape[1:])
                size = leaves[i][0].numel()
                out[i] = _to_rows(flat[o:o + size].view(shape), L)
                o += size
        return out

    def scatter(self, value: PyTree, src: int = 0) -> PyTree:
        """Logical node ``src``'s row on every row of every host: the owning
        host takes the row, a masked host-leg allreduce moves it across
        hosts (the additive identity elsewhere: bitwise the owner's
        values), and every host repeats it over its rows."""
        if not 0 <= src < self.num_nodes:
            raise ValueError(
                f"src={src} out of range for {self.num_nodes} nodes")
        h, row = divmod(src, self.local_nodes)
        mine = tree_map(lambda x: x[row].contiguous(), value)
        if self.rank != h:
            mine = tree_map(torch.zeros_like, mine)
        if self.host_leg is not None:
            mine, _ = self.host_leg.all_reduce(mine, contrib=self.rank == h)
        return self.replicate(mine)
