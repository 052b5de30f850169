"""Base-b TCP tree collectives — counterpart of ``distlearn_tpu/comm/tree.py``,
the torch-ipc ``ipc.Tree`` / ``ipc.LocalhostTree`` rebuild (reference
construction sites: examples/mnist.lua:16, examples/client_remote.lua:41;
claimed cost ``T*log_b(N)`` — lua/AllReduceEA.md:26-30).

The tree carries host-side traffic between processes: the reference's
process-per-node training (``parallel/host_algorithms.py``,
``examples/client_remote.py``) and control-plane reductions.  The byte
moving and reduction inner loops run in native C++ (distcomm framing and
``dc_reduce_*``, ``comm/native.py``).

Topology: complete base-``b`` tree over 0-based ranks in level order —
``parent(i) = (i-1)//b``, ``children(i) = i*b+1 .. i*b+b``.  Bootstrap: every
rank registers with rank 0, receives its parent's address, then connects to
its parent (so data flows parent↔child directly, never relayed through the
root).  Bootstrap, frames and the order of the sums (children in rank
order, then the parent) are the JAX package's, so JAX and port ranks can
share one tree and every rank gets the all-JAX bits.

Leaves are numpy arrays (the JAX package's path, unchanged) or torch
tensors on one device, which come back as fresh tensors on that device:
a contributing rank stages them into the handle's frame (pinned on the
card, one copy a leaf and one stream synchronize), the reduction runs in
place on the frame's views, and one copy a leaf returns the result
(``HostCollectiveBase._stage``/``_unstage``).  The wire carries the same
values, shapes and dtypes either way.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

import numpy as np

from distlearn_tpu_torch.comm import native, wire
from distlearn_tpu_torch.comm.backend import (HostCollectiveBase, _identity,
                                              tensor_device)
from distlearn_tpu_torch.comm.transport import Conn, Server, connect
from distlearn_tpu_torch.ops import wire_kernels
from distlearn_tpu_torch.ops.staging import numpy_dtype
from distlearn_tpu_torch.utils.tree import tree_flatten, tree_unflatten

PyTree = Any


def _parent(rank: int, base: int) -> int:
    return (rank - 1) // base


def _children(rank: int, base: int, n: int) -> list[int]:
    return [c for c in range(rank * base + 1, rank * base + base + 1)
            if c < n]


class Tree(HostCollectiveBase):
    """One rank's handle on the tree (construct one per process/thread).

    ``rank`` is 0-based (the reference's nodeIndex is 1-based; the examples
    translate).  Rank 0 is the root and must be constructed with the
    coordinator address it listens on; other ranks connect to it.
    """

    def __init__(self, rank: int, num_nodes: int, host: str, port: int,
                 base: int = 2, timeout: float = 60.0,
                 listen_host: str | None = None,
                 advertise_host: str | None = None,
                 op_timeout: float | None = None,
                 fault_plan=None, fault_link: str = "tree"):
        """``host``/``port``: the coordinator (rank 0) address every rank
        dials for bootstrap.  Multi-host ranks must also say where THEY can
        be reached: ``listen_host`` is the local bind address for this rank's
        child-listener (default: ``host``, correct only when all ranks share
        it, e.g. localhost; use ``"0.0.0.0"`` on a multi-host deployment) and
        ``advertise_host`` is the address other ranks should dial to reach
        this rank (default: ``listen_host`` if set and routable, else
        ``host``).

        ``op_timeout``: with it set, any collective that waits longer than
        this many seconds on one peer raises :class:`TimeoutError` instead
        of wedging the job (the reference blocks forever when a node dies
        mid-reduce, SURVEY.md §5).  ``None`` keeps the reference's
        block-forever semantics.

        ``fault_plan``: optional :class:`~distlearn_tpu_torch.comm.faults.
        FaultPlan`; every data-plane link (parent + children) is wrapped
        onto ``fault_link`` after bootstrap, so injected partitions and
        delays hit the collectives with the handle's normal error
        semantics (``op_timeout`` → :class:`TimeoutError`)."""
        if not 0 <= rank < num_nodes:
            raise ValueError(f"rank {rank} out of range for {num_nodes} nodes")
        if base < 1:
            raise ValueError("base must be >= 1")
        self.rank = rank
        self.num_nodes = num_nodes
        self.base = base
        self._kids: list[Conn] = []
        self._parent: Conn | None = None
        self._codec_fb = None
        self._codec_scratch: list[np.ndarray] | None = None
        kid_ranks = _children(rank, base, num_nodes)

        bind_host = listen_host if listen_host is not None else host
        adv_host = advertise_host if advertise_host is not None else (
            listen_host if listen_host not in (None, "0.0.0.0", "::") else host)

        # Every rank (incl. root) listens for its children first.
        self._kid_server = Server(bind_host, 0) if kid_ranks else None

        if rank == 0:
            if num_nodes > 1:
                coord = Server(bind_host, port)
                regs: dict[int, Conn] = {}
                for _ in range(num_nodes - 1):
                    c = coord.accept(1, timeout=timeout)[0]
                    msg = c.recv_msg()
                    regs[int(msg["rank"])] = c
                # every rank's child-listener address, then its parent's
                addrs = {0: (adv_host, self._kid_server.port)}
                for r in regs:
                    addrs[r] = tuple(regs[r].recv_msg()["listen"])
                for r, c in regs.items():
                    c.send_msg({"parent": list(addrs[_parent(r, base)])})
                for c in regs.values():
                    c.close()
                coord.close()
        else:
            c = connect(host, port, retries=int(timeout * 4))
            c.send_msg({"rank": rank})
            listen = (adv_host, self._kid_server.port) if self._kid_server \
                else (adv_host, 0)
            c.send_msg({"listen": list(listen)})
            p_host, p_port = c.recv_msg()["parent"]
            self._parent = connect(p_host, int(p_port), retries=int(timeout * 4))
            self._parent.send_msg({"child": rank})
            c.close()

        # Accept child connections in child-rank order.
        if self._kid_server is not None:
            by_rank: dict[int, Conn] = {}
            for _ in kid_ranks:
                conn = self._kid_server.accept(1, timeout=timeout)[0]
                hello = conn.recv_msg()
                by_rank[int(hello["child"])] = conn
            self._kids = [by_rank[r] for r in sorted(by_rank)]
        if fault_plan is not None:
            if self._parent is not None:
                self._parent = fault_plan.wrap(self._parent, fault_link)
            self._kids = [fault_plan.wrap(k, fault_link) for k in self._kids]
        self.set_op_timeout(op_timeout)

    def _links(self) -> list[Conn]:
        return ([self._parent] if self._parent else []) + self._kids

    # -- collectives ---------------------------------------------------------
    def _send_reduced(self, conn: Conn, leaves: list[np.ndarray], codec: str):
        """Ship a reduced leaf list one hop.  ``raw`` is the exact path;
        lossy codecs quantize per hop (no cross-round error carry — the
        residual is scratch here) through the host route of
        ``ops/wire_kernels.py``, into one reused frame sent as one
        iovec."""
        if codec == "raw":
            conn.send_tensors(leaves)
            return
        if self._codec_fb is None:
            self._codec_fb = wire.FrameBuffer()
        if (self._codec_scratch is None
                or len(self._codec_scratch) != len(leaves)
                or any(s.shape != a.shape or s.dtype != a.dtype
                       for s, a in zip(self._codec_scratch, leaves))):
            self._codec_scratch = [np.zeros(a.shape, a.dtype) for a in leaves]
        payload = wire_kernels.encode_ef_into(
            leaves, self._codec_scratch, codec, out=self._codec_fb)
        conn.send_packed(payload)

    def all_reduce_ex(self, value: PyTree, op: str = "sum",
                      contrib: bool = True, rider: int = 0,
                      codec: str = "raw") -> tuple[PyTree, int, int]:
        """:meth:`all_reduce` plus an out-of-band integer ``rider`` summed
        across ALL ranks regardless of ``contrib`` — carries round metadata
        (e.g. how many participants are in flush mode, the uneven-step
        protocol of ``parallel/host_algorithms.py``).

        ``codec``: wire codec per hop (``raw``/``fp16``/``int8``).  Float
        leaves quantize on every link they cross under a lossy codec."""
        leaves, treedef = tree_flatten(value)
        dev = tensor_device(leaves)
        t0 = time.perf_counter()
        if dev is not None:
            views = (self._stage([x.detach().reshape(-1) for x in leaves])
                     if contrib else self._identity_windows(
                         dev, [x.numel() for x in leaves],
                         [numpy_dtype(x.dtype) for x in leaves], op))
            # 0-d leaves travel as shape (1,), as np.ascontiguousarray
            # makes them in the numpy path
            acc = [v.reshape(tuple(x.shape) or (1,))
                   for v, x in zip(views, leaves)]
        else:
            leaves = [np.ascontiguousarray(np.asarray(x)) for x in leaves]
            if not contrib:
                acc = [np.full_like(x, _identity(x.dtype, op)) for x in leaves]
            else:
                acc = [x.copy() for x in leaves]
        t1 = time.perf_counter()
        n = 1 if contrib else 0
        r = int(rider)
        # Up phase: fold children into acc.
        for kid in self._kids:
            hdr = kid.recv_msg()
            n += int(hdr["n"])
            r += int(hdr["r"])
            parts = kid.recv_tensors(n=len(acc))
            for a, part in zip(acc, parts):
                if part.dtype != a.dtype:
                    # the AsyncEA server evicts on dtype skew too; casting a
                    # child's payload into the accumulator would hide it
                    raise ValueError(
                        f"all_reduce dtype skew: child contributed "
                        f"{part.dtype} against local {a.dtype} — "
                        "rank model/config mismatch (all ranks must "
                        "reduce identical dtypes)")
                native.reduce_inplace(a, part, op)
        # Send to parent; receive final result down.
        if self._parent is not None:
            self._parent.send_msg({"n": n, "r": r})
            self._send_reduced(self._parent, acc, codec)
            down = self._parent.recv_msg()
            total, r_total = int(down["n"]), int(down["r"])
            final = self._parent.recv_tensors(out=acc)
        else:
            total, r_total, final = n, r, acc
        # Down phase: forward result to children.
        for kid in self._kids:
            kid.send_msg({"n": total, "r": r_total})
            self._send_reduced(kid, final, codec)
        if dev is not None:
            t2 = time.perf_counter()
            final = [f.reshape(x.shape) for f, x in
                     zip(self._unstage(final, dev), leaves)]
            self.last_split = (t1 - t0, t2 - t1, time.perf_counter() - t2)
        return tree_unflatten(treedef, final), total, r_total

    def scatter(self, value: PyTree) -> PyTree:
        """Root's values broadcast to every rank (ref ``tree.scatter``,
        lua/AllReduceSGD.lua:52).  Receiving ranks fill fresh buffers and
        the root returns copies: the result never aliases the caller's
        leaves."""
        leaves, treedef = tree_flatten(value)
        dev = tensor_device(leaves)
        if dev is not None:
            if self._parent is not None:
                wire_leaves = self._parent.recv_tensors(
                    out=self._windows_like(leaves))
            elif self._kids:
                views = self._stage([x.detach().reshape(-1) for x in leaves])
                wire_leaves = [v.reshape(tuple(x.shape))
                               for v, x in zip(views, leaves)]
            for kid in self._kids:
                kid.send_tensors(wire_leaves)
            out = ([x.detach().clone() for x in leaves]
                   if self._parent is None
                   else self._unstage(wire_leaves, dev))
            return tree_unflatten(treedef, out)
        if self._parent is not None:
            out = self._parent.recv_tensors(
                out=[np.empty(a.shape, a.dtype)
                     for a in map(np.asarray, leaves)])
        else:
            out = [np.array(x, copy=True, order="C") for x in leaves]
        for kid in self._kids:
            kid.send_tensors(out)
        return tree_unflatten(treedef, out)

    def close(self):
        self._release_frame()
        if self._parent:
            self._parent.close()
        for k in self._kids:
            k.close()
        if self._kid_server:
            self._kid_server.close()


def LocalhostTree(rank: int, num_nodes: int, port: int, base: int = 2,
                  **kwargs) -> Tree:
    """Single-host convenience (ref ``ipc.LocalhostTree(nodeIndex, numNodes)``,
    examples/mnist.lua:16).  All ranks must pass the same ``port``; extra
    kwargs (``timeout``, ``op_timeout``) forward to :class:`Tree`."""
    return Tree(rank, num_nodes, "127.0.0.1", port, base=base, **kwargs)


def tree_map_spawn(fn: Callable, n: int, *args, timeout: float = 120.0
                   ) -> list:
    """``ipc.map(n, fn, args...)`` parity (test/test_AllReduceSGD.lua:27):
    run ``fn(rank, *args)`` on ``n`` Python threads, join, return results
    in rank order.  (Threads, like the reference's fresh-Lua-state threads,
    share the process; the transport is real localhost TCP either way.)"""
    results: list = [None] * n
    errors: list = []

    def _run(i):
        try:
            results[i] = fn(i, *args)
        except Exception as e:  # noqa: BLE001 — surface in main thread
            errors.append((i, e))

    threads = [threading.Thread(target=_run, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    stuck = [i for i, t in enumerate(threads) if t.is_alive()]
    if errors:
        raise errors[0][1] if len(errors) == 1 else RuntimeError(
            "; ".join(f"rank {i}: {e!r}" for i, e in sorted(errors)))
    if stuck:
        raise TimeoutError(f"ranks {stuck} still running after {timeout}s")
    return results
