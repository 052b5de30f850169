"""The communication layer — counterpart of ``distlearn_tpu/parallel/mesh.py``
(the reference's torch-ipc ``tree``: ``tree.allReduce``, ``tree.scatter``,
``tree.nodeIndex``, ``tree.numNodes``; examples/mnist.lua:16), and of the
JAX package's named ``Mesh`` with ``lax.psum``, ``lax.ppermute`` and
``lax.all_to_all`` (:class:`Mesh`, :func:`psum`, :func:`ppermute`,
:func:`all_to_all`).

In the JAX package a node is a device of a mesh and one SPMD program drives
them all.  Here a node is a process of a ``torch.distributed`` process group
(NCCL on the card, gloo on the CPU), each holding its own values, and each
collective is a call on that group.  :func:`init_mesh` starts the group;
nothing here finds a cluster by itself.
"""

from __future__ import annotations

import socket
import time
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from distlearn_tpu_torch.utils.platform import resolve_device
from distlearn_tpu_torch.utils.tree import tree_map

PyTree = Any


class MeshTree:
    """This process's handle on the group of nodes.

    ``num_nodes``/``node_index`` mirror ``tree.numNodes``/``tree.nodeIndex``
    (0-based here).  Values are this node's own pytrees of tensors on
    ``device``; every collective returns new tensors and leaves its
    inputs as they were.
    """

    # the CollectiveBackend convention: plain per-node values, one node a
    # process
    stacked_nodes = None

    def __init__(self, device=None, group=None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized; "
                               "start it with init_mesh()")
        self.device = resolve_device(device)
        self.group = group
        self.num_nodes = dist.get_world_size(group)
        self.node_index = dist.get_rank(group)

    def all_reduce(self, tree: PyTree, contrib=None
                   ) -> tuple[PyTree, torch.Tensor]:
        """Sum a pytree over the nodes; returns ``(reduced, n)`` with ``n``
        the number of contributing nodes (ref ``tree.allReduce(value, add)
        -> _, n``, lua/AllReduceSGD.lua:12).  ``contrib`` is this node's 0/1
        participation flag: a non-contributor's values are zeroed before the
        sum and ``n`` counts the flags.  ``n`` stays on the device (int32)."""
        if contrib is None:
            n = torch.full((), self.num_nodes, dtype=torch.int32,
                           device=self.device)

            def _sum(x):
                out = x.clone()
                dist.all_reduce(out, group=self.group)
                return out
            return tree_map(_sum, tree), n
        c = torch.as_tensor(contrib, device=self.device).to(torch.int32)
        n = c.reshape(1).clone()
        dist.all_reduce(n, group=self.group)

        def _masked_sum(x):
            out = x * c.to(x.dtype)
            dist.all_reduce(out, group=self.group)
            return out
        return tree_map(_masked_sum, tree), n[0]

    def broadcast_from(self, tree: PyTree, src: int) -> PyTree:
        """Node ``src``'s values on every node (ref ``tree.scatter``,
        lua/AllReduceSGD.lua:52, lua/AllReduceEA.lua:83,93)."""
        if not 0 <= src < self.num_nodes:
            raise ValueError(f"src={src} out of range for {self.num_nodes} nodes")
        gsrc = dist.get_global_rank(self.group, src) \
            if self.group is not None else src

        def _bcast(x):
            out = x.clone()
            dist.broadcast(out, gsrc, group=self.group)
            return out
        return tree_map(_bcast, tree)

    @property
    def node_offset(self) -> int:
        return self.node_index

    def scatter(self, tree: PyTree, src: int = 0) -> PyTree:
        """:meth:`broadcast_from` under the backends' name."""
        return self.broadcast_from(tree, src)

    def all_gather_scalar(self, x: torch.Tensor) -> torch.Tensor:
        """Every node's scalar ``x`` as a ``[num_nodes]`` vector."""
        x = x.reshape(1)
        parts = [torch.empty_like(x) for _ in range(self.num_nodes)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts)


def local_init_method() -> str:
    """A ``tcp://localhost:<port>`` rendezvous on a port free a moment ago,
    for ranks that all run on this host."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def init_mesh(rank: int = 0, world_size: int = 1,
              init_method: str | None = None, store=None,
              device=None) -> MeshTree:
    """Start the default process group and return its :class:`MeshTree`.

    NCCL when ``device`` is CUDA (the default; each rank takes the card
    ``device`` names, or ``cuda:0``), gloo for ``device="cpu"``.  Give the
    rendezvous as ``init_method`` (``"tcp://localhost:<port>"``) or a
    ``store``.  Shut down with ``torch.distributed.destroy_process_group()``.
    """
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"store": store} if store is not None else {"init_method": init_method}
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            rank=rank, world_size=world_size, **kw)
    return MeshTree(device=device)


# ---------------------------------------------------------------------------
# A mesh with named axes and its collectives
# ---------------------------------------------------------------------------

#: How each (backend, device kind) moves a tensor: ``"direct"`` hands the
#: tensor to the backend, ``"staged"`` copies it into pinned host memory,
#: runs the backend there and copies the result back (gloo on the card).
#: Any other pair has no route and raises.
ROUTES = {("nccl", "cuda"): "direct", ("gloo", "cpu"): "direct",
          ("gloo", "cuda"): "staged"}
#: The dtypes each backend sums and moves; any other raises.
DTYPES = {"nccl": (torch.float32, torch.float64, torch.bfloat16,
                   torch.float16, torch.int32, torch.int64),
          "gloo": (torch.float32, torch.float64, torch.bfloat16,
                   torch.int32, torch.int64)}
DEFAULT_AXES = ("data", "seq", "model")


class CollectiveStats:
    """Calls, bytes and (when the mesh is ``timed``) host seconds of the
    mesh's collectives, by kind (``psum``, ``ppermute``, ``all_to_all``,
    ``all_gather``)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls: dict[str, int] = {}
        self.bytes: dict[str, int] = {}
        self.seconds: dict[str, float] = {}

    def add(self, kind: str, nbytes: int, seconds: float) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + nbytes
        self.seconds[kind] = self.seconds.get(kind, 0.0) + seconds


class MeshAxis(NamedTuple):
    """One named axis as this rank sees it: its size, this rank's index on
    it, the process group of this rank's line along it and that line's
    global ranks in axis order (``JAX``'s ``axis_size``/``axis_index``)."""
    mesh: "Mesh"
    name: str
    size: int
    index: int
    group: Any
    ranks: tuple


class Mesh:
    """A mesh of ranks with named axes — the counterpart of the JAX
    package's ``Mesh(devices.reshape(dp, sp, tp), ("data", "seq",
    "model"))``.

    ``ranks`` (the global ranks it spans, all of the default group unless
    given) are laid out row-major over ``shape``, the last axis varying
    fastest, as numpy's reshape lays out devices.  The mesh holds one
    process group for each line of each axis; every rank of the default
    group must build the same meshes in the same order, those outside
    ``ranks`` included (group creation is collective), and only members
    (``member``) may run collectives on it.

    ``backend`` is NCCL for a CUDA ``device`` and gloo for the CPU unless
    given; gloo over the card stages every collective through pinned host
    memory (:data:`ROUTES`).  ``timed=True`` synchronizes the device around
    each collective so that :attr:`stats` charges it its own host time.

    The collectives below are eager calls, where the JAX package compiles
    one SPMD program: every rank must call them in the same order, and,
    for the differentiable ones, record the same autograd graph, so that
    the backward pass runs their transposes in the same order everywhere.
    Choose between operands with ``torch.where``, never with a branch that
    depends on the rank (``parallel/sequence.py``'s zigzag ring)."""

    def __init__(self, shape, axis_names=DEFAULT_AXES, *, device=None,
                 backend: str | None = None, ranks=None, group=None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized; "
                               "start it with init_named_mesh()")
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names) or \
                len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} needs one distinct "
                             f"name per axis, got {self.axis_names}")
        self.device = resolve_device(device)
        self.backend = backend or ("nccl" if self.device.type == "cuda"
                                   else "gloo")
        self.route = _route(self.backend, self.device)
        self.timed = False
        self.stats = CollectiveStats()
        ranks = tuple(range(dist.get_world_size()) if ranks is None
                      else ranks)
        if len(ranks) != int(np.prod(self.shape)):
            raise ValueError(f"mesh shape {self.shape} needs "
                             f"{int(np.prod(self.shape))} ranks, got "
                             f"{len(ranks)}")
        me = dist.get_rank()
        self.member = me in ranks
        pos = ranks.index(me) if self.member else None
        coords = np.unravel_index(pos, self.shape) if self.member else None
        grid = np.arange(len(ranks)).reshape(self.shape)
        self._axes: dict[str, MeshAxis] = {}
        for a, name in enumerate(self.axis_names):
            lines = np.moveaxis(grid, a, -1).reshape(-1, self.shape[a])
            for line in lines:
                line_ranks = tuple(ranks[p] for p in line)
                if group is not None and len(self.shape) == 1:
                    g = group          # the axis is an existing group
                else:
                    g = dist.new_group(list(line_ranks),
                                       backend=self.backend)
                if self.member and pos in line:
                    self._axes[name] = MeshAxis(
                        self, name, self.shape[a], int(coords[a]), g,
                        line_ranks)

    @classmethod
    def from_tree(cls, tree: MeshTree, axis_name: str = "data") -> "Mesh":
        """A one-axis mesh over a :class:`MeshTree`'s group (no new
        groups), so the data-only steps take either."""
        group = tree.group if tree.group is not None else dist.group.WORLD
        ranks = [dist.get_global_rank(group, i)
                 for i in range(tree.num_nodes)]
        return cls((tree.num_nodes,), (axis_name,), device=tree.device,
                   backend=dist.get_backend(group), ranks=ranks,
                   group=group)

    def axis(self, name: str) -> MeshAxis:
        if not self.member:
            raise RuntimeError("this rank is not in the mesh")
        try:
            return self._axes[name]
        except KeyError:
            raise ValueError(f"no mesh axis {name!r}; the mesh has "
                             f"{self.axis_names}") from None

    def axis_size(self, name: str) -> int:
        return self.axis(name).size

    def axis_index(self, name: str) -> int:
        return self.axis(name).index

    def tree(self, axis_name: str = "data") -> MeshTree:
        """This rank's line along ``axis_name`` as a :class:`MeshTree` (the
        data-only and EA steps' handle)."""
        return MeshTree(device=self.device, group=self.axis(axis_name).group)

    def __repr__(self) -> str:
        dims = ", ".join(f"{n}={s}" for n, s in zip(self.axis_names,
                                                      self.shape))
        return f"Mesh({dims}; {self.backend} on {self.device})"


def init_named_mesh(shape, axis_names=DEFAULT_AXES, rank: int = 0,
                    init_method: str | None = None, store=None, device=None,
                    backend: str | None = None) -> Mesh:
    """Start the default process group over ``prod(shape)`` ranks with
    ``backend`` (NCCL for a CUDA ``device``, the card by default; gloo for
    the CPU) and return the :class:`Mesh` over all of them.  Shut down
    with ``torch.distributed.destroy_process_group()``."""
    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    _route(backend, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"store": store} if store is not None else {"init_method": init_method}
    dist.init_process_group(backend, rank=rank,
                            world_size=int(np.prod(shape)), **kw)
    return Mesh(shape, axis_names, device=device, backend=backend)


def _route(backend: str, device: torch.device) -> str:
    try:
        return ROUTES[(backend, device.type)]
    except KeyError:
        raise ValueError(f"no collective route for backend {backend!r} on "
                         f"{device.type} tensors; routes: {sorted(ROUTES)}"
                         ) from None


def _check(axis: MeshAxis, t: torch.Tensor) -> None:
    mesh = axis.mesh
    if t.dtype not in DTYPES[mesh.backend]:
        raise TypeError(f"the {mesh.backend} collectives take "
                        f"{DTYPES[mesh.backend]}, got {t.dtype}")
    if t.device.type != mesh.device.type:
        raise ValueError(f"a {mesh.device.type} mesh got a tensor on "
                         f"{t.device}")


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a tensor on the card, landed on return."""
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return buf


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def _timed(axis: MeshAxis, kind: str, nbytes: int, run):
    """Run ``run()`` and charge it to the mesh's stats."""
    mesh = axis.mesh
    cuda = mesh.device.type == "cuda"
    if mesh.timed and cuda:
        torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    out = run()
    if mesh.timed and cuda:
        torch.cuda.synchronize(mesh.device)
    mesh.stats.add(kind, nbytes,
                   time.perf_counter() - t0 if mesh.timed else 0.0)
    return out


def psum_raw(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of each axis in ``axes`` (one
    :class:`MeshAxis` or a sequence), as a new tensor; no autograd."""
    axes = (axes,) if isinstance(axes, MeshAxis) else tuple(axes)
    out = x.detach().clone()
    for axis in axes:
        if axis.size == 1:
            continue
        _check(axis, out)

        def run(out=out, axis=axis):
            if axis.mesh.route == "staged":
                buf = _host(out)
                dist.all_reduce(buf, group=axis.group)
                return out.copy_(buf, non_blocking=True)
            dist.all_reduce(out, group=axis.group)
            return out
        out = _timed(axis, "psum", out.numel() * out.element_size(), run)
    return out


def _check_perm(axis: MeshAxis, perm) -> dict:
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    n = axis.size
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or any(
            not 0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute over {axis.name!r} (size {n}) needs "
                         f"distinct sources and destinations in [0, {n}), "
                         f"got {list(perm)}")
    return dict(perm)


def ppermute_raw(x: torch.Tensor, axis: MeshAxis, perm) -> torch.Tensor:
    """``lax.ppermute``: for each ``(src, dst)`` pair of axis indices, rank
    ``dst`` receives rank ``src``'s ``x``; a rank no pair sends to gets
    zeros.  No autograd."""
    sends = _check_perm(axis, perm)
    recvs = {d: s for s, d in sends.items()}
    me = axis.index
    dst, src = sends.get(me), recvs.get(me)
    x = x.detach().contiguous()
    if src is None:
        out = torch.zeros_like(x)
    elif src == me:
        out = x.clone()
    else:
        out = torch.empty_like(x)
    if (dst is None or dst == me) and (src is None or src == me):
        return out
    _check(axis, x)
    staged = axis.mesh.route == "staged"

    def run():
        ops = []
        if dst is not None and dst != me:
            ops.append(dist.P2POp(dist.isend, _host(x) if staged else x,
                                  axis.ranks[dst], axis.group))
        land = out
        if src is not None and src != me:
            land = _pinned_like(out) if staged else out
            ops.append(dist.P2POp(dist.irecv, land, axis.ranks[src],
                                  axis.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if land is not out:
            out.copy_(land, non_blocking=True)
        return out
    return _timed(axis, "ppermute", x.numel() * x.element_size(), run)


def all_to_all_raw(x: torch.Tensor, axis: MeshAxis, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: ``x`` splits into ``n`` blocks
    along ``split_axis``, block ``j`` goes to axis index ``j``, and the
    blocks received are concatenated along ``concat_axis`` in source
    order.  No autograd."""
    n = axis.size
    if n == 1:
        return x.detach()
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all over {axis.name!r}: dim {split_axis} "
                         f"of shape {tuple(x.shape)} does not split into "
                         f"{n} blocks")
    _check(axis, x)
    blocks = x.detach().movedim(split_axis, 0)
    blocks = blocks.reshape((n, blocks.shape[0] // n) + blocks.shape[1:]) \
        .contiguous()
    staged = axis.mesh.route == "staged"

    def run():
        send = _host(blocks) if staged else blocks
        got = _pinned_like(blocks) if staged else torch.empty_like(blocks)
        dist.all_to_all_single(got, send, group=axis.group)
        return got.to(x.device, non_blocking=True) if staged else got
    got = _timed(axis, "all_to_all", blocks.numel() * blocks.element_size(),
                 run)
    return torch.cat([b.movedim(0, split_axis) for b in got.unbind(0)],
                     dim=concat_axis)


def all_gather_raw(x: torch.Tensor, axis: MeshAxis, dim: int
                   ) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated along ``dim`` in axis
    order.  No autograd."""
    if axis.size == 1:
        return x.detach()
    _check(axis, x)
    x = x.detach().contiguous()
    staged = axis.mesh.route == "staged"

    def run():
        send = _host(x) if staged else x
        parts = [_pinned_like(x) if staged else torch.empty_like(x)
                 for _ in range(axis.size)]
        dist.all_gather(parts, send, group=axis.group)
        return [p.to(x.device, non_blocking=True) for p in parts] \
            if staged else parts
    parts = _timed(axis, "all_gather", x.numel() * x.element_size()
                   * axis.size, run)
    return torch.cat(parts, dim=dim)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return psum_raw(x, axes)

    @staticmethod
    def backward(ctx, g):
        return psum_raw(g, ctx.axes), None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return ppermute_raw(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return ppermute_raw(g, ctx.axis, inverse), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_axis, concat_axis):
        ctx.args = (axis, split_axis % x.dim(), concat_axis % x.dim())
        return all_to_all_raw(x, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        axis, split_axis, concat_axis = ctx.args
        return all_to_all_raw(g, axis, concat_axis, split_axis), \
            None, None, None


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """``lax.psum`` over one axis or several; its gradient is the psum of
    the cotangent, JAX's transpose under ``shard_map``."""
    axes = (axes,) if isinstance(axes, MeshAxis) else tuple(axes)
    if all(a.size == 1 for a in axes):
        return x
    return _PSum.apply(x, axes)


def ppermute(x: torch.Tensor, axis: MeshAxis, perm) -> torch.Tensor:
    """``lax.ppermute`` (see :func:`ppermute_raw`); the gradient rides the
    inverse permutation."""
    perm = [(int(s), int(d)) for s, d in perm]
    return _PPermute.apply(x, axis, perm)


def all_to_all(x: torch.Tensor, axis: MeshAxis, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)`` (see :func:`all_to_all_raw`);
    the gradient is the reverse all-to-all."""
    if axis.size == 1:
        return x
    return _AllToAll.apply(x, axis, split_axis, concat_axis)
