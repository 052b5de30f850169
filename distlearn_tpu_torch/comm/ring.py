"""Ring allreduce over TCP — counterpart of ``distlearn_tpu/comm/ring.py``,
the bandwidth-optimal host collective.

The reference's torch-ipc tree moves the FULL payload up and down every
link, giving the documented ``T*log2(N)`` latency (lua/AllReduceEA.md:26-30)
but ``~4T`` of traffic through the base-2 root's NIC (two children, payload
up AND down each) regardless of N.  A ring reduce-scatter + allgather
(Baidu/NCCL style) puts ``2T*(N-1)/N`` out + the same in through every
rank's NIC — ``3T`` at N=4, approaching ``2T`` as N grows, against the
root's fixed ``4T``.  The ring wins in wall clock where per-link bandwidth
is the bottleneck (hosts on a network); its latency is ``2(N-1)`` hops
against the tree's ``2*log2(N)``, so for tiny control-plane payloads the
tree wins everywhere.  (The JAX package's docstring gives its own
measurements of both regimes, on its CPU bench host.)

:class:`Ring` exposes the same collective surface as
:class:`~distlearn_tpu_torch.comm.tree.Tree` (``all_reduce``/
``all_reduce_ex`` with contributor + rider semantics, ``scatter``,
``walk``, ``barrier``, ``node_index``/``num_nodes``), so every host
algorithm (``parallel/host_algorithms.py``) runs on either backend
unchanged, and torch tensor leaves take the same trip through the
handle's frame as on the tree (one copy out per dtype group of leaves,
one copy back a leaf).  The chunk bounds, the dtype grouping and the
order of the sums are the JAX package's, so a ring that mixes JAX and port
ranks gives every rank the all-JAX bits.

Topology/bootstrap: rank 0 runs the same register-then-address coordinator
as the tree; each rank then dials its successor ``(rank+1) % N`` and accepts
its predecessor, closing the ring.  Each collective step sends to the
successor while receiving from the predecessor — full duplex via a
per-connection sender worker, so large chunks cannot deadlock on TCP
buffers.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any

import numpy as np
import torch

from distlearn_tpu_torch.comm import native
from distlearn_tpu_torch.comm.backend import (HostCollectiveBase, _identity,
                                              tensor_device)
from distlearn_tpu_torch.comm.transport import Conn, Server, connect
from distlearn_tpu_torch.ops.staging import numpy_dtype
from distlearn_tpu_torch.utils.tree import tree_flatten, tree_unflatten

PyTree = Any


class _Sender:
    """Ordered async sender for one connection: ``put`` enqueues a tensor
    send, ``flush`` waits until the wire has taken everything.  Lets a ring
    step send chunk A to the successor while the main thread blocks
    receiving chunk B from the predecessor (full duplex)."""

    def __init__(self, conn: Conn):
        self._conn = conn
        self._q: queue.Queue = queue.Queue()
        self._err: list[BaseException] = []
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            kind, payload = item
            try:
                if kind == "T":
                    self._conn.send_tensor(payload)
                elif kind == "P":
                    self._conn.send_tensors(payload)
                else:
                    self._conn.send_msg(payload)
            except BaseException as e:  # noqa: BLE001 — surfaced in flush
                self._err.append(e)
            finally:
                self._q.task_done()

    def put_tensor(self, arr: np.ndarray):
        self._q.put(("T", arr))

    def put_tensors(self, leaves: list):
        """Enqueue a whole leaf list as ONE packed 'P' frame."""
        self._q.put(("P", leaves))

    def put_msg(self, msg):
        self._q.put(("J", msg))

    def check(self):
        """Raise a send error already known locally WITHOUT waiting for the
        queue to drain — called before blocking on the predecessor recv so a
        dead successor surfaces immediately instead of wedging the
        collective until (op_)timeout."""
        if self._err:
            raise self._err[0]

    def flush(self):
        self._q.join()
        if self._err:
            raise self._err[0]

    def close(self):
        self._q.put(None)
        self._t.join(timeout=5.0)


def _dtype_groups(dtypes: list[np.dtype]) -> dict[np.dtype, list[int]]:
    """Leaf indices by dtype, in order of first appearance: one ring pass
    per group (latency: 2(N-1) hops a group)."""
    groups: dict[np.dtype, list[int]] = {}
    for i, dt in enumerate(dtypes):
        groups.setdefault(dt, []).append(i)
    return groups


class Ring(HostCollectiveBase):
    """One rank's handle on the ring (construct one per process/thread).

    Same constructor contract as :class:`~distlearn_tpu_torch.comm.tree.Tree`:
    ``host``/``port`` name the rank-0 coordinator; multi-host ranks pass
    ``listen_host``/``advertise_host``; ``op_timeout`` arms per-link failure
    detection (a dead neighbor raises :class:`TimeoutError` instead of
    wedging — the reference wedges, SURVEY.md §5).

    A send failure the sender worker has already observed is raised before
    each blocking predecessor recv (``_Sender.check``), but a successor
    that dies mid-recv can still only be detected by the recv deadline —
    set ``op_timeout`` in production deployments.
    """

    def __init__(self, rank: int, num_nodes: int, host: str, port: int,
                 timeout: float = 60.0,
                 listen_host: str | None = None,
                 advertise_host: str | None = None,
                 op_timeout: float | None = None,
                 fault_plan=None, fault_link: str = "ring"):
        if not 0 <= rank < num_nodes:
            raise ValueError(f"rank {rank} out of range for {num_nodes} nodes")
        self.rank = rank
        self.num_nodes = num_nodes
        self._pred: Conn | None = None
        self._succ: Conn | None = None
        self._sender: _Sender | None = None

        if num_nodes == 1:
            self.set_op_timeout(op_timeout)
            return

        bind_host = listen_host if listen_host is not None else host
        adv_host = advertise_host if advertise_host is not None else (
            listen_host if listen_host not in (None, "0.0.0.0", "::") else host)

        # Every rank listens for its predecessor.
        pred_server = Server(bind_host, 0)

        if rank == 0:
            coord = Server(bind_host, port)
            regs: dict[int, Conn] = {}
            addrs = {0: (adv_host, pred_server.port)}
            for _ in range(num_nodes - 1):
                c = coord.accept(1, timeout=timeout)[0]
                msg = c.recv_msg()
                r = int(msg["rank"])
                regs[r] = c
                addrs[r] = tuple(c.recv_msg()["listen"])
            for r, c in regs.items():
                c.send_msg({"succ": list(addrs[(r + 1) % num_nodes])})
            for c in regs.values():
                c.close()
            coord.close()
            succ_addr = addrs[1 % num_nodes]
        else:
            c = connect(host, port, retries=int(timeout * 4))
            c.send_msg({"rank": rank})
            c.send_msg({"listen": [adv_host, pred_server.port]})
            succ_addr = tuple(c.recv_msg()["succ"])
            c.close()

        # Dial the successor, accept the predecessor (order-independent:
        # the dial retries while the peer's listener is already up).
        self._succ = connect(succ_addr[0], int(succ_addr[1]),
                             retries=int(timeout * 4))
        self._succ.send_msg({"pred": rank})
        self._pred = pred_server.accept(1, timeout=timeout)[0]
        hello = self._pred.recv_msg()
        expect = (rank - 1) % num_nodes
        if int(hello["pred"]) != expect:
            raise RuntimeError(
                f"ring miswired: rank {rank} accepted predecessor "
                f"{hello['pred']}, expected {expect}")
        pred_server.conns.clear()   # detach _pred: close only the listener
        pred_server.close()
        if fault_plan is not None:
            self._pred = fault_plan.wrap(self._pred, fault_link)
            self._succ = fault_plan.wrap(self._succ, fault_link)
        self._sender = _Sender(self._succ)
        self.set_op_timeout(op_timeout)

    def _links(self) -> list[Conn]:
        return [c for c in (self._pred, self._succ) if c is not None]

    # -- collectives ---------------------------------------------------------
    def all_reduce_ex(self, value: PyTree, op: str = "sum",
                      contrib: bool = True, rider: int = 0,
                      codec: str = "raw") -> tuple[PyTree, int, int]:
        """:meth:`all_reduce` plus the out-of-band integer ``rider`` summed
        across ALL ranks regardless of ``contrib`` (round metadata for the
        uneven-step protocol — see Tree.all_reduce_ex).

        The ring's chunked per-tensor frames have nowhere to carry a
        quantization scale, so only ``codec="raw"`` is supported (the
        tree carries the lossy codecs)."""
        if codec != "raw":
            raise ValueError(
                f"Ring.all_reduce_ex is raw-only (got codec={codec!r}); "
                "use the tree transport for lossy host legs")
        leaves, treedef = tree_flatten(value)
        dev = tensor_device(leaves)
        t0 = time.perf_counter()
        if dev is not None:
            groups = _dtype_groups([numpy_dtype(x.dtype) for x in leaves])
            # one flat window a dtype group, the leaves back to back in it
            if contrib:
                bufs = self._stage([
                    torch.cat([leaves[i].detach().reshape(-1) for i in idxs])
                    if len(idxs) > 1 else leaves[idxs[0]].detach().reshape(-1)
                    for idxs in groups.values()])
            else:
                bufs = self._identity_windows(
                    dev, [sum(leaves[i].numel() for i in idxs)
                          for idxs in groups.values()], list(groups), op)
        else:
            leaves = [np.ascontiguousarray(np.asarray(x)) for x in leaves]
            if not contrib:
                flats = [np.full(x.size, _identity(x.dtype, op), x.dtype)
                         for x in leaves]
            else:
                flats = [x.reshape(-1).copy() for x in leaves]
            groups = _dtype_groups([f.dtype for f in flats])
            bufs = [flats[idxs[0]] if len(idxs) == 1
                    else np.concatenate([flats[i] for i in idxs])
                    for idxs in groups.values()]
        t1 = time.perf_counter()
        # meta chunk: [n_contributors, rider] always sum-reduced
        meta = np.array([1 if contrib else 0, int(rider)], np.int64)
        if self.num_nodes > 1:
            self._ring_allreduce_meta(meta)
            for buf in bufs:
                self._ring_allreduce_flat(buf, op)
        out: list = [None] * len(leaves)
        for idxs, buf in zip(groups.values(), bufs):
            off = 0
            for i in idxs:
                n_el = int(np.prod(leaves[i].shape, dtype=np.int64))
                out[i] = buf[off:off + n_el].reshape(tuple(leaves[i].shape))
                off += n_el
        if dev is not None:
            t2 = time.perf_counter()
            out = self._unstage(out, dev)
            self.last_split = (t1 - t0, t2 - t1, time.perf_counter() - t2)
        return tree_unflatten(treedef, out), int(meta[0]), int(meta[1])

    def _ring_allreduce_meta(self, meta: np.ndarray):
        """Tiny scalar metadata (contributor count + rider): circulate every
        rank's original vector once around the ring; each rank accumulates
        the N-1 tokens it sees.  In-place sum into ``meta``."""
        tok = meta.copy()
        total = meta.copy()
        for _ in range(self.num_nodes - 1):
            self._sender.put_msg({"m": tok.tolist()})
            self._sender.check()
            tok = np.asarray(self._pred.recv_msg()["m"], np.int64)
            total += tok
            self._sender.flush()
        meta[:] = total

    def _ring_allreduce_flat(self, buf: np.ndarray, op: str):
        """In-place ring allreduce of a 1-D array: reduce-scatter then
        allgather, N-1 steps each, full duplex per step."""
        n, rank = self.num_nodes, self.rank
        bounds = np.linspace(0, buf.size, n + 1).astype(np.int64)
        chunk = lambda i: buf[bounds[i % n]:bounds[i % n + 1]]  # noqa: E731

        # reduce-scatter: after step s, chunk (rank - s - 1) holds the sum of
        # s+2 ranks' contributions; after n-1 steps chunk (rank+1) is final.
        for s in range(n - 1):
            self._sender.put_tensor(chunk(rank - s))
            self._sender.check()
            part = self._pred.recv_tensor()
            c = chunk(rank - s - 1)
            native.reduce_inplace(c, part.astype(c.dtype, copy=False), op)
            self._sender.flush()
        # allgather: circulate each finalized chunk n-1 hops.
        for s in range(n - 1):
            self._sender.put_tensor(chunk(rank + 1 - s))
            self._sender.check()
            self._pred.recv_tensor(out=chunk(rank - s))
            self._sender.flush()

    def scatter(self, value: PyTree) -> PyTree:
        """Rank 0's values broadcast to every rank (ref ``tree.scatter``):
        the whole leaf list travels as ONE packed frame per hop, forwarded
        around the ring by each rank.  The result never aliases the
        caller's leaves."""
        leaves, treedef = tree_flatten(value)
        dev = tensor_device(leaves)
        last = self.num_nodes - 1
        if dev is not None:
            if self.rank == 0:
                if self.num_nodes > 1:
                    views = self._stage(
                        [x.detach().reshape(-1) for x in leaves])
                    self._sender.put_tensors(
                        [v.reshape(tuple(x.shape))
                         for v, x in zip(views, leaves)])
                    self._sender.flush()
                out = [x.detach().clone() for x in leaves]
            else:
                got = self._pred.recv_tensors(out=self._windows_like(leaves))
                if self.rank != last:
                    self._sender.put_tensors(got)
                    self._sender.flush()
                out = self._unstage(got, dev)
            return tree_unflatten(treedef, out)
        leaves = [np.asarray(x) for x in leaves]
        if self.num_nodes == 1:
            out = [np.array(a, copy=True, order="C") for a in leaves]
        elif self.rank == 0:
            bufs = [np.ascontiguousarray(a) for a in leaves]
            self._sender.put_tensors(bufs)
            self._sender.flush()
            out = [np.array(b, copy=True, order="C") for b in bufs]
        else:
            out = self._pred.recv_tensors(
                out=[np.empty(a.shape, a.dtype) for a in leaves])
            if self.rank != last:
                self._sender.put_tensors(out)
                self._sender.flush()
        return tree_unflatten(treedef, out)

    def close(self):
        self._release_frame()
        if self._sender is not None:
            self._sender.close()
        for conn in (self._pred, self._succ):
            if conn is not None:
                conn.close()


def LocalhostRing(rank: int, num_nodes: int, port: int, **kwargs) -> Ring:
    """Single-host convenience, mirroring :func:`comm.tree.LocalhostTree`."""
    return Ring(rank, num_nodes, "127.0.0.1", port, **kwargs)
