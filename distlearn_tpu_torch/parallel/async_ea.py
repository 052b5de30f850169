"""Asynchronous EASGD over a hub-and-spoke parameter server — counterpart of
``distlearn_tpu/parallel/async_ea.py`` (the rebuild of lua/AsyncEA.lua):
the serial and the concurrent server, the striped center, the overlapped
client, the exactly-once rejoin ledger, elastic membership and the server's
half of center HA (the standby's half is :mod:`.ha`).

Three roles (reference export surface lua/AsyncEA.lua:294-303):

* **server** — holds the center on its device, does no training, streams
  the center and applies ``center += delta`` (lua :198-228).
  :class:`AsyncEAServer` admits ONE client at a time through the
  ``Enter?``/``Enter`` critical section (lua :163-177);
  :class:`AsyncEAServerConcurrent` overlaps the handshakes of different
  clients: a dispatcher thread routes each ``Enter?`` to the client's worker
  thread, which owns the client's dedicated channel.
* **client** — trains locally; every ``tau``-th step runs the sync
  handshake: ``Enter?`` -> fetch center -> local elastic move
  ``delta = (p - c) * alpha; p -= delta`` (lua :109-119) -> push delta,
  optionally from a background sender (``overlap=True``) so the next tau
  steps overlap the push.
* **tester** — an evaluation role the server pushes the center to every
  ``testTime`` syncs (lua :239-292).

Socket topology (examples/EASGD_server.lua:67-77): broadcast channel on
``port`` (all clients), one dedicated channel per client on ``port + i``,
test channel on ``port + numNodes + 1``, shard channels on
``port + numNodes + 2 + i``.  The wire (negotiation, packed frames, the
raw/fp16/int8 codecs, the stripe plan, the replay and membership messages)
is the JAX package's byte for byte, so JAX and port peers interoperate.

Stripes.  ``shards=S`` cuts the center into at most S contiguous,
byte-balanced stripes of a VIRTUAL leaf list in which an oversized leaf is
split into flat chunks (``comm/wire.py``: ``plan_splits``,
``plan_stripes``).  Stripe 0 rides the dedicated channel, stripes 1..S-1
their own listeners; a client that negotiated the plan fetches and pushes
every stripe concurrently, one leg a stripe, and each stripe is applied
on its own (complete or not at all).

Device placement.  Every role keeps its tensors on its device (the card
unless ``device="cpu"`` is asked for); the host sees only wire bytes.

* The server's center is ONE flat device buffer (:class:`_LeafSlab`); the
  real leaves and the virtual ones are views into it (a split leaf's chunks
  at element offsets that need not be multiples of 4), so each stripe is
  one contiguous byte span of it.  Every thread of a server launches on the
  server's one stream.  An apply (the received frame to the device in one
  copy, then B4 — ``ops/wire_kernels.dequant_add_leaves_cuda``, one launch
  over the stripe's int8 leaves — or the adds) and a snapshot (one
  device-to-host copy of a span into the calling thread's own page-locked
  frame) are ENQUEUED under the stripe's lock and waited for outside it:
  the stream runs them in lock order, so a snapshot holds whole applies
  only, and no two threads share a frame.
* The client's params, center copy, delta and error-feedback residual live
  on the device: the fetched center (every stripe's leg writes into one
  page-locked twin) goes host-to-device in one copy, the elastic move runs
  there, and B3 (``quantize_ef_leaves_cuda``: one amax and one quantize
  launch) encodes each stripe into that stripe's own page-locked frame,
  with the amax slots behind it, in one copy and one synchronize.

Capacity weights (elastic servers): a delta weighted by ``w != 1`` is
decoded, multiplied by ``w`` and added, in that order and in plain ops (the
JAX package's three roundings); B4 runs only at ``w == 1``, which keeps a
fixed fleet bit for bit.

Layout on the wire.  Each role takes a ``layout``
(:class:`~distlearn_tpu_torch.models.convert.WireLayout`, ``None`` when the
port's layout is the wire's, as for the transformer LM): the convnets travel
in the JAX package's layout (``CONVNET_WIRE``).  The layout changes at each
role's boundary only: the server keeps (and checkpoints) its center in the
wire layout, the client converts the fetched center into its own layout and
the delta into the wire's before the encode (its residual stays in the
wire layout).

The slice client (``AsyncEAClient(slice_backend=)``) is one client for L
rows of a stacked-value backend (``MeshBackend``, ``HybridBackend``): its
params are ``[L, ...]`` rows, each row takes its own elastic pull against
the one center, and the row-sum of the deltas goes out in one push, what L
plain clients would push against the same center, in one send.
"""

from __future__ import annotations

import contextlib
import queue
import select
import socket as _socket
import threading
import time
from typing import Any

import numpy as np
import torch

from distlearn_tpu_torch import obs
from distlearn_tpu_torch.comm import (Conn, ProtocolError, Server, connect,
                                      wire)
from distlearn_tpu_torch.models.convert import WireLayout
from distlearn_tpu_torch.obs import trace as obs_trace
from distlearn_tpu_torch.ops import wire_kernels
from distlearn_tpu_torch.ops.fused_update import cast_scalar
from distlearn_tpu_torch.utils.logging import (print_client, print_server,
                                               print_tester)
from distlearn_tpu_torch.utils.platform import resolve_device
from distlearn_tpu_torch.utils.tree import tree_flatten, tree_unflatten

PyTree = Any

ENTER_Q = "Enter?"
ENTER = "Enter"
REJOIN_Q = "Rejoin?"
REJOIN = "Rejoin"
CENTER_Q = "Center?"
DELTA_Q = "delta?"
DELTA = "delta"
TEST_Q = "Test?"
ACK = "Ack"
SHARD_Q = "Shard?"
REPLAY_Q = "Replay"
JOIN_Q = "Join?"
JOIN = "Join"
LEAVE_Q = "Leave?"
LEAVE = "Leave"

#: Shard-negotiation schema version (the "shard" key in Enter?/Rejoin?).
SHARD_V = 1

#: applied-seq sentinel meaning "assume everything was applied" — adopted
#: when a restored checkpoint's per-stripe seq table cannot be matched to
#: the current stripe plan (replay degrades to at-most-once, never twice).
_SEQ_INF = 2 ** 62

#: alpha*tau stability product ceiling the straggler-adaptive tau respects.
ALPHA_TAU_PRODUCT = 0.9

#: what a failed handshake raises (ValueError: an undecodable JSON frame)
_IO_ERRORS = (TimeoutError, ConnectionError, ProtocolError, OSError,
              ValueError)


def adaptive_tau_bounds(tau: int, alpha: float) -> tuple[int, int]:
    """``[lo, hi]`` bounds for the straggler-adaptive sync period: never
    below the configured tau, never past ``ALPHA_TAU_PRODUCT / alpha``."""
    lo = max(1, int(tau))
    hi = max(lo, int(ALPHA_TAU_PRODUCT / alpha)) if alpha > 0 else lo
    return lo, hi


class StaleCenterError(ProtocolError):
    """A center answered an admission request with an OLDER epoch than the
    client has already synced against — the zombie-primary fence.  The
    client drops the refusing address from its failover dial list."""


# ---------------------------------------------------------------------------
# Wire negotiation (packed 'P' frames + codecs, comm/wire.py).
#
# A new client advertises {"wire": {"v": 1, "codec": ...}} inside its
# Enter?/Rejoin? request; extra keys are invisible to an old server (it only
# reads "q"/"clientID" and replies the plain "Enter" string), so the client
# detects a legacy peer from the STRING reply and falls back to per-leaf
# 'T' frames.  A new server replies {"a": "Enter", "wire": {...}} — a dict
# — ONLY to clients that advertised, with the stripe plan under "shard" for
# a client that also advertised {"shard": {"v": 1}}.  An unsupported codec
# is answered with a wire error and an eviction.


def _parse_wire_request(msg) -> tuple[str | None, str | None]:
    """(codec, error) from an admission-family message's "wire" key.
    ``(None, None)`` = legacy peer; ``(codec, None)`` = negotiated;
    ``(codec, error)`` = advertised but unusable (answer loudly)."""
    spec = msg.get("wire") if isinstance(msg, dict) else None
    if spec is None:
        return None, None
    if not isinstance(spec, dict):
        return None, f"malformed wire spec {spec!r}"
    codec = spec.get("codec")
    if codec not in wire.CODECS:
        return codec, (f"unsupported wire codec {codec!r} "
                       f"(supported: {', '.join(wire.CODECS)})")
    return codec, None


def _check_wire_reply(reply, want: str, codec: str) -> bool:
    """Client-side half of the negotiation: True when the server agreed to
    the packed wire, False when it answered with the legacy plain string
    (fall back to per-leaf frames), ProtocolError on desync or rejection."""
    if reply == want:
        return False                      # legacy server: per-leaf 'T' wire
    if isinstance(reply, dict) and reply.get("a") == want:
        w = reply.get("wire")
        if isinstance(w, dict) and w.get("error"):
            raise ProtocolError(
                f"server rejected wire codec {codec!r}: {w['error']}")
        if not isinstance(w, dict) or w.get("codec") != codec:
            raise ProtocolError(
                f"wire negotiation desync: requested codec {codec!r}, "
                f"server answered {w!r}")
        return True
    raise ProtocolError(f"protocol desync: expected {want!r}, got {reply!r}")


def _fanout(fns):
    """Run thunks concurrently — leg 0 on the calling thread, the rest on
    transient threads — and re-raise the first failure only after EVERY
    leg has settled, so a caller's eviction/cleanup never races a
    still-running leg."""
    if len(fns) == 1:
        fns[0]()
        return
    errs: list = [None] * len(fns)

    def run(i):
        try:
            fns[i]()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs[i] = e

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(1, len(fns))]
    for t in threads:
        t.start()
    run(0)
    for t in threads:
        t.join()
    for e in errs:
        if e is not None:
            raise e


def _close(c) -> None:
    try:
        c.close()
    except OSError:
        pass


class _ShardEndpoint:
    """One shard channel: a listener on its own port plus the per-client
    conns registered by ``Shard?`` hellos.  A registered conn persists
    across syncs and a re-hello for the same cid (rejoin) supersedes it.
    The listener is non-blocking: several stripe workers poll it at once,
    and the loser of a race for one dial gets ``BlockingIOError``."""

    def __init__(self, host: str, port: int, shard: int, num_nodes: int,
                 throttle_bps: float | None = None, is_member=None):
        self.shard = shard
        self.num_nodes = num_nodes
        self.throttle_bps = throttle_bps
        self._is_member = is_member or (lambda c: 1 <= c <= num_nodes)
        self.server = Server(host, port)
        self.server.sock.setblocking(False)
        self.port = self.server.port
        self.conns: dict[int, Conn] = {}
        self._reg_lock = threading.Lock()   # guards the conns dict only

    def _poll_accept(self, wait: float) -> bool:
        """Accept at most one pending dial and register it by its hello.
        Returns True when the listener had a dial pending (even if another
        worker won it or the hello was bad), so callers can drain the
        backlog."""
        r, _, _ = select.select([self.server.sock], [], [], wait)
        if not r:
            return False
        try:
            raw, _ = self.server.sock.accept()
        except (BlockingIOError, OSError):
            return True             # another stripe worker won this dial
        raw.setblocking(True)       # BSD inherits O_NONBLOCK from listener
        c = Conn(raw)
        try:
            c.set_timeout(2.0)
            hello = c.recv_msg()
            c.set_timeout(None)
            cid = int(hello.get("clientID", -1)) \
                if isinstance(hello, dict) else -1
            if (not isinstance(hello, dict) or hello.get("q") != SHARD_Q
                    or hello.get("shard") != self.shard
                    or cid < 1 or not self._is_member(cid)):
                raise ProtocolError(f"bad shard hello {hello!r}")
        except _IO_ERRORS:
            c.close()
            return True
        if self.throttle_bps:
            c.throttle_bps = self.throttle_bps
        with self._reg_lock:
            old = self.conns.get(cid)
            self.conns[cid] = c
        if old is not None:
            _close(old)
        return True

    def get_conn(self, cid: int, timeout: float) -> Conn:
        """The cid's registered shard conn, accepting pending dials until
        it shows up or the timeout passes.  Every pending dial is drained
        before the registry is trusted: a rejoin's fresh socket may be
        queued behind the previous admission's dead one."""
        deadline = time.monotonic() + timeout
        while True:
            while self._poll_accept(0.0):
                pass
            with self._reg_lock:
                c = self.conns.get(cid)
            if c is not None and c.sock.fileno() >= 0:
                return c
            wait = deadline - time.monotonic()
            if wait <= 0:
                raise TimeoutError(
                    f"client #{cid} never dialed shard {self.shard}")
            self._poll_accept(min(wait, 0.1))

    def drop(self, cid: int):
        with self._reg_lock:
            c = self.conns.pop(cid, None)
        if c is not None:
            _close(c)

    def drop_if(self, cid: int, conn: Conn) -> bool:
        """Drop the cid's registration only if it is still ``conn`` (a
        registration superseded meanwhile belongs to a newer admission).
        True when dropped."""
        with self._reg_lock:
            if self.conns.get(cid) is not conn:
                return False
            del self.conns[cid]
        _close(conn)
        return True

    def drop_if_dead(self, cid: int, conn: Conn) -> bool:
        """``drop_if``, but only when conn's peer is already gone (EOF
        pending; MSG_PEEK keeps a real payload intact).  One-shot."""
        try:
            r, _, _ = select.select([conn.sock], [], [], 0)
            if r and conn.sock.recv(1, _socket.MSG_PEEK) == b"":
                return self.drop_if(cid, conn)
        except OSError:
            return self.drop_if(cid, conn)
        return False

    def close(self):
        with self._reg_lock:
            conns, self.conns = list(self.conns.values()), {}
        for c in conns:
            _close(c)
        self.server.close()


def _leaves(tree: PyTree) -> list[torch.Tensor]:
    return [torch.as_tensor(x) for x in tree_flatten(tree)[0]]


def _rebuild(tree: PyTree, leaves: list) -> PyTree:
    return tree_unflatten(tree_flatten(tree)[1], leaves)


def _to_wire(layout: WireLayout | None, tree: PyTree) -> PyTree:
    return tree if layout is None else layout.to_wire(tree)


def _from_wire(layout: WireLayout | None, tree: PyTree) -> PyTree:
    return tree if layout is None else layout.from_wire(tree)


def _expect(conn: Conn, want: str):
    """Protocol step check — explicit (never stripped under ``python -O``,
    unlike the reference's asserts) and diagnostic on desync."""
    got = conn.recv_msg()
    if got != want:
        raise ProtocolError(f"protocol desync: expected {want!r}, got {got!r}")


def _deadline(timeout: float | None) -> float | None:
    return None if timeout is None else time.monotonic() + timeout


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _typed(window: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    """The bytes ``window`` seen as a ``dtype`` tensor of ``shape`` (a view
    where the offset allows it, else a copy)."""
    if window.storage_offset() % torch.empty(0, dtype=dtype).element_size():
        window = window.clone()
    return window.view(dtype).view(tuple(shape))


def _split_views(leaves: list[torch.Tensor], splits: list[int]
                 ) -> list[torch.Tensor]:
    """:func:`wire.split_views` over tensors: split leaves become flat
    chunk views of a contiguous leaf (writes land in the leaf)."""
    out: list[torch.Tensor] = []
    for t, p in zip(leaves, splits):
        if p <= 1:
            out.append(t)
        else:
            flat = t.view(-1)
            out.extend(flat[lo:hi]
                       for lo, hi in wire._split_bounds(t.numel(), p))
    return out


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` in ``like``'s dtype as a 0-d tensor on its device (numpy's
    ``np.asarray(x, dtype)``, so a product rounds once, as numpy's)."""
    return torch.from_numpy(np.asarray(x, wire_kernels.numpy_dtype(
        like.dtype))).to(like.device)


def _apply_path(w: float) -> str:
    """A center apply's path label: 'fused' at weight 1 (the int8 leaves
    through B4), 'scaled' under a capacity weight (decode, scale, add)."""
    return "fused" if w == 1.0 else "scaled"


def _fused_wire_apply(payload: "wire.PackedPayload", w: float) -> bool:
    """Whether an apply counts in ``center_apply_seconds``, as in the JAX
    package: a lossy (int8 or fp16) payload folded in at weight 1, never
    decoded (a raw delta, or any under a capacity weight, is not)."""
    return w == 1.0 and payload.codec != "raw"


class _LeafSlab:
    """A list of leaves stored in ONE flat byte buffer on a device (each
    leaf a typed view at a 16-byte aligned offset, so the kernels' vector
    paths apply) with a host twin of the same layout, page-locked for a
    CUDA device: the whole list crosses between host and device in one
    copy.  ``leaves`` are the device views, ``host_leaves`` numpy views of
    the twin, ``offsets`` each leaf's byte offset."""

    def __init__(self, metas: list[tuple[tuple, np.dtype]],
                 device: torch.device):
        self.metas = [(tuple(s), np.dtype(d)) for s, d in metas]
        self.offsets, total = [], 0
        for shape, dtype in self.metas:
            self.offsets.append(total)
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            total += -(-nbytes // 16) * 16
        self.total = total
        self.device = device
        self.dev = torch.empty(total, dtype=torch.uint8, device=device)
        self.host = torch.empty(total, dtype=torch.uint8,
                                pin_memory=device.type == "cuda")
        self.leaves = [
            _typed(self.dev[off:off + self._nbytes(i)],
                   _torch_dtype(dtype), shape)
            for i, ((shape, dtype), off) in enumerate(
                zip(self.metas, self.offsets))]
        self.host_leaves = self.views(self.host.numpy())

    def _nbytes(self, i: int) -> int:
        shape, dtype = self.metas[i]
        return int(np.prod(shape, dtype=np.int64)) * dtype.itemsize

    def views(self, buf: np.ndarray) -> list[np.ndarray]:
        """The leaves as numpy views of ``buf``, a host copy of the slab's
        bytes laid out as the slab is."""
        return [buf[off:off + self._nbytes(i)].view(dtype).reshape(shape)
                for i, ((shape, dtype), off) in enumerate(
                    zip(self.metas, self.offsets))]

    def to_device(self) -> list[torch.Tensor]:
        """Copy the host twin to the device leaves (complete on return: the
        twin may be overwritten as soon as this returns)."""
        self.dev.copy_(self.host, non_blocking=self.host.is_pinned())
        _sync(self.device)
        return self.leaves


class AsyncEAServer:
    """Parameter-server role (ref initServer/syncServer/testNet), serial:
    one client's sync at a time; a striped sync's legs run concurrently."""

    def __init__(self, host: str, port: int, num_nodes: int,
                 with_tester: bool = False, accept_timeout: float = 120.0,
                 handshake_timeout: float | None = 30.0, shards: int = 1,
                 throttle_bps: float | None = None, standby: bool = False,
                 elastic: bool = False,
                 centers: list[tuple[str, int]] | None = None,
                 device=None, layout: WireLayout | None = None):
        self.device = resolve_device(device)
        self.layout = layout
        self.num_nodes = num_nodes
        self._host = host
        # elastic membership: keep accepting broadcast dials, admit new
        # clients through Join? (cids past num_nodes, ephemeral dedicated
        # ports) and retire them through Leave?
        self.elastic = bool(elastic)
        # HA dial list advertised to joiners in the Join reply
        self.advertised_centers: list[tuple[str, int]] = [
            (h, int(p)) for h, p in (centers or [])]
        # live roster; ids are never reused
        self.members: set[int] = set(range(1, num_nodes + 1))
        self._next_cid = num_nodes + 1
        self._capacity: dict[int, float] = {}
        self.shards = max(1, int(shards))
        self.throttle_bps = throttle_bps
        # Per-handshake IO timeout on the dedicated channels: a client that
        # dies or hangs mid-sync is EVICTED and the server keeps serving the
        # others (the reference wedges here, lua/AsyncEA.lua:163-228).
        self.handshake_timeout = handshake_timeout
        self.evicted: set[int] = set()
        self._cid_to_broadcast: dict[int, int] = {}
        # negotiated wire codec per client id (None = legacy per-leaf 'T'
        # frames), refreshed on every Enter?/Rejoin?
        self._wire_cid: dict[int, str | None] = {}
        # broadcast conns accepted for a possible rejoin that have not yet
        # spoken, with a speak-by deadline
        self._rejoin_pending: list = []
        self.broadcast = Server(host, port)
        self.dedicated_servers: dict[int, Server] = {
            i + 1: Server(host, port + i + 1) for i in range(num_nodes)}
        self.test_server = Server(host, port + num_nodes + 1) \
            if with_tester else None
        # shard channels (stripes 1..S-1; stripe 0 rides the dedicated
        # conns) listen above the test channel
        self.shard_endpoints = [
            _ShardEndpoint(host, port + num_nodes + 2 + i, i + 1, num_nodes,
                           throttle_bps=throttle_bps,
                           is_member=self.members.__contains__)
            for i in range(self.shards - 1)]
        self.stripes: list[tuple[int, int]] | None = None
        self.splits: list[int] | None = None
        self._leaf_meta: list[tuple[tuple, np.dtype]] | None = None
        self._shard_spec: dict | None = None
        self._shard_cid: dict[int, bool] = {}
        # -- HA state -------------------------------------------------------
        self.epoch = 0
        # per-client sync sequence claimed in the latest Enter? and, per
        # stripe, the highest seq whose delta has been APPLIED — the
        # exactly-once ledger the rejoin replay consults; written under
        # _lock inside the hold of the stripe lock that orders the apply
        self._sync_seq: dict[int, int | None] = {}
        self._applied_seq: dict[int, list[int]] = {}
        self._trace_cid: dict[int, dict | None] = {}
        self._ckpt = None
        self._ckpt_every = 1
        self._ckpt_count = 0
        # lock order: _ckpt_lock -> _apply_lock -> stripe locks (ascending)
        # -> _lock; _frames_lock is a leaf (nothing is taken under it)
        self._ckpt_lock = threading.Lock()
        self._lock = threading.Lock()
        self._apply_lock = threading.Lock()
        self._stripe_locks: list[threading.Lock] = []
        self._sync_count = 0
        self._closed = False
        self._standby = bool(standby)
        # the one stream every thread of this server launches and copies
        # on, and the calling thread's own page-locked frames
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self._frames: dict[tuple, wire.FrameBuffer] = {}
        self._frames_lock = threading.Lock()
        self._tls = threading.local()
        if standby:
            # warm standby: every cid starts evicted, so admission happens
            # only through Rejoin? once promoted
            self.dedicated: dict[int, Conn | None] = \
                dict.fromkeys(range(1, num_nodes + 1))
            self.test_conn = None
            self.evicted = set(range(1, num_nodes + 1))
        else:
            self.broadcast.accept(num_nodes, timeout=accept_timeout)
            self.dedicated = {
                cid: self.dedicated_servers[cid].accept(
                    1, timeout=accept_timeout)[0]
                for cid in range(1, num_nodes + 1)}
            self.test_conn = \
                self.test_server.accept(1, timeout=accept_timeout)[0] \
                if with_tester else None
            if throttle_bps:
                for c in (self.broadcast.conns + list(self.dedicated.values())
                          + ([self.test_conn] if self.test_conn else [])):
                    c.throttle_bps = throttle_bps
        self.center: list[torch.Tensor] | None = None
        self.current_client: int | None = None
        self._slab: _LeafSlab | None = None
        self._vcenter: list[torch.Tensor] | None = None
        self._vmeta: list[tuple[int, int, np.dtype, tuple]] = []
        self._spans: list[tuple[int, int]] = []
        self._obs_on = obs.enabled()
        self._c_syncs = obs.counter(
            "async_ea_syncs_total", "deltas applied to the center")
        self._c_evict = obs.counter(
            "async_ea_evictions_total", "clients evicted mid-handshake")
        self._c_rejoin = obs.counter(
            "async_ea_rejoins_total", "evicted clients re-admitted")
        self._c_joins = obs.counter(
            "async_ea_membership_joins_total",
            "new clients admitted through the Join? handshake")
        self._c_join_fail = obs.counter(
            "async_ea_membership_join_failures_total",
            "Join? handshakes refused or failed mid-adoption")
        self._c_leaves = obs.counter(
            "async_ea_membership_leaves_total",
            "graceful Leave? departures, by pending-delta outcome",
            labels=("outcome",))
        self._g_members = obs.gauge(
            "async_ea_membership_size",
            "live fleet size (admitted members minus evicted)")
        self._g_members.set(len(self.members - self.evicted))
        self._c_stale = obs.counter(
            "async_ea_failover_stale_refusals_total",
            "admissions refused on the epoch fence (stale/zombie center)")
        self._h_handshake = obs.histogram(
            "async_ea_handshake_seconds",
            "full sync handshake (Enter sent to delta validated)")
        self._h_apply = obs.histogram(
            "async_ea_center_apply_seconds",
            "center += delta apply time (device path, queued work included)")
        self._c_shard_syncs = obs.counter(
            "async_ea_shard_syncs_total",
            "stripe legs completed (sharded syncs only), by shard",
            labels=("shard",))
        self._c_shard_bytes = obs.counter(
            "async_ea_shard_wire_bytes_total",
            "wire bytes a stripe leg moved (center down + delta up), "
            "by shard", labels=("shard",))
        self._h_shard_apply = obs.histogram(
            "async_ea_shard_apply_seconds",
            "per-stripe center apply time, by shard", labels=("shard",))
        self._c_applies = obs.counter(
            "async_ea_center_applies_total",
            "center applies (a stripe's or a whole delta's), by path: "
            "'fused' (weight 1: B4 over the int8 leaves) or 'scaled' "
            "(a capacity weight: decode, scale, add)", labels=("path",))
        self._h_center_apply = obs.histogram(
            "center_apply_seconds",
            "fused dequantize+apply of one received lossy wire payload "
            "onto the center (weight 1, no decoded float32 copy), by "
            "stripe ('all' = whole-tree)",
            labels=("shard",))

    # -- center storage -----------------------------------------------------
    def init_server(self, params: PyTree):
        """Clone params as the center on the server's device, in the wire
        layout; plan the stripes; broadcast the center to every client
        (ref lua :150-160)."""
        leaves = _leaves(_to_wire(self.layout, params))
        self._leaf_meta = [(tuple(t.shape),
                            wire_kernels.numpy_dtype(t.dtype))
                           for t in leaves]
        self._slab = _LeafSlab(self._leaf_meta, self.device)
        self.center = self._slab.leaves
        _sync(self.device)          # the caller's stream made ``params``
        with self._on_stream():
            for c, t in zip(self.center, leaves):
                c.copy_(t)
        sizes = [int(np.prod(s, dtype=np.int64)) for s, _ in self._leaf_meta]
        self.splits = wire.plan_splits(
            [n * d.itemsize for n, (_, d) in zip(sizes, self._leaf_meta)],
            sizes, self.shards)
        self._vcenter = _split_views(self.center, self.splits)
        self._vmeta = []
        for i, ((shape, dtype), off) in enumerate(
                zip(self._leaf_meta, self._slab.offsets)):
            if self.splits[i] <= 1:
                self._vmeta.append((off, sizes[i] * dtype.itemsize, dtype,
                                    shape))
            else:
                for lo, hi in wire._split_bounds(sizes[i], self.splits[i]):
                    self._vmeta.append((off + lo * dtype.itemsize,
                                        (hi - lo) * dtype.itemsize, dtype,
                                        (hi - lo,)))
        self.stripes = wire.plan_stripes([m[1] for m in self._vmeta],
                                         self.shards)
        # a stripe is one contiguous byte span of the slab
        self._spans = [(self._vmeta[lo][0],
                        self._vmeta[hi - 1][0] + self._vmeta[hi - 1][1])
                       for lo, hi in self.stripes]
        self._stripe_locks = [threading.Lock() for _ in self.stripes]
        self._shard_spec = None
        if len(self.stripes) > 1:
            self._shard_spec = {
                "v": SHARD_V, "n": len(self.stripes),
                "ports": [ep.port for ep in
                          self.shard_endpoints[:len(self.stripes) - 1]],
                "stripes": [[lo, hi] for lo, hi in self.stripes],
                "splits": [[i, p] for i, p in enumerate(self.splits)
                           if p > 1]}
        center = self._snapshot()
        for conn in self.broadcast.conns:
            try:
                # per-leaf 'T' frames: nothing has been negotiated yet, so
                # old-wire clients must be able to read it
                conn.send_tensors(center, packed=False)
            except (TimeoutError, ConnectionError, OSError) as e:
                print_server(f"initial broadcast to a client failed: {e!r}")
                conn.close()

    @contextlib.contextmanager
    def _frames_as(self, key=None):
        """Key the calling thread's frames by ``key`` (default: the
        thread's own identity) for the body."""
        old = getattr(self._tls, "key", None)
        self._tls.key = key
        try:
            yield
        finally:
            self._tls.key = old

    @contextlib.contextmanager
    def _on_stream(self):
        """Queue the body's device work on the server's one stream,
        whichever thread runs it."""
        prev = None
        if self._stream is not None:
            prev = torch.cuda.current_stream(self.device)
            torch.cuda.set_stream(self._stream)
        try:
            yield
        finally:
            if prev is not None:
                torch.cuda.set_stream(prev)

    def _frame(self, kind: str) -> wire.FrameBuffer:
        """The calling thread's own staging frame of ``kind`` ("snap" for
        snapshots, "rx" for received deltas), page-locked on the card."""
        key = (kind, getattr(self._tls, "key", None)
               or threading.get_ident())
        # the stripe legs and a checkpoint thread look up and insert at
        # once: the check-then-insert is one critical section
        with self._frames_lock:
            fb = self._frames.get(key)
            if fb is None:
                fb = self._frames[key] = wire.FrameBuffer(
                    pinned=self.device.type == "cuda")
        return fb

    def _fence(self):
        """An event after the work queued on the server's stream so far
        (None on the CPU, where the work is done already)."""
        if self._stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return ev

    @staticmethod
    def _wait(ev) -> None:
        if ev is not None:
            ev.synchronize()

    def _host_span(self, b0: int, b1: int, locks, also=None):
        """Bytes ``[b0, b1)`` of the center slab in the calling thread's
        snapshot frame: the device-to-host copy is queued under ``locks``
        (what orders the applies it must see whole) and waited for after
        they are released.  ``also()`` runs inside the same hold.  Returns
        ``(host bytes, also's result)``; the bytes are valid until this
        thread's next snapshot."""
        fb = self._frame("snap")
        fb.reserve(b1 - b0)
        host = fb.host_tensor(b1 - b0)
        with obs.span("async_ea.center_d2h"):
            with self._on_stream(), contextlib.ExitStack() as held:
                for lk in locks:
                    held.enter_context(lk)
                host.copy_(self._slab.dev[b0:b1], non_blocking=fb.pinned)
                ev = self._fence()
                extra = also() if also is not None else None
            self._wait(ev)
        return fb.buf[:b1 - b0], extra

    def _stripe_host(self, idx: int) -> list[np.ndarray]:
        """Stripe ``idx``'s virtual leaves as host arrays (one copy)."""
        lo, hi = self.stripes[idx]
        b0, b1 = self._spans[idx]
        buf, _ = self._host_span(b0, b1, [self._stripe_locks[idx]])
        return [buf[off - b0:off - b0 + nb].view(dt).reshape(shape)
                for off, nb, dt, shape in self._vmeta[lo:hi]]

    def _snapshot(self, also=None):
        """The REAL center leaves as host arrays, every stripe whole (one
        copy of the slab); with ``also``, ``(leaves, also())`` from the
        same hold of every stripe lock."""
        buf, extra = self._host_span(0, self._slab.total, self._stripe_locks,
                                     also)
        leaves = self._slab.views(buf)
        return leaves if also is None else (leaves, extra)

    def _center_clone(self) -> list[torch.Tensor]:
        """A device copy of the real center leaves, every stripe whole."""
        with self._on_stream(), contextlib.ExitStack() as held:
            for lk in self._stripe_locks:
                held.enter_context(lk)
            out = [t.clone() for t in self.center]
            ev = self._fence()
        self._wait(ev)
        return out

    # -- applies ------------------------------------------------------------
    def _check_delta(self, payload: "wire.PackedPayload",
                     meta: list[tuple[tuple, np.dtype]] | None = None):
        """Reject a structurally wrong delta BEFORE any leaf is applied, so
        the center never takes a torn update.  Dtype skew is config skew
        too.  ``meta`` narrows the check to one stripe's virtual leaves."""
        meta = self._leaf_meta if meta is None else meta
        got = [(tuple(e["shape"]), np.dtype(e["dtype"]))
               for e in payload.manifest["leaves"]]
        for (shape, dtype), (dshape, ddtype) in zip(meta, got):
            if dshape != shape:
                raise ProtocolError(
                    f"delta leaf shape {dshape} != center "
                    f"{shape} — client/server model config skew")
            if ddtype != dtype:
                raise ProtocolError(
                    f"delta leaf dtype {ddtype} != center {dtype} — "
                    "client/server model config skew")

    def _stripe_meta(self, idx: int) -> list[tuple[tuple, np.dtype]]:
        lo, hi = self.stripes[idx]
        return [(shape, dt) for _, _, dt, shape in self._vmeta[lo:hi]]

    def _device_bufs(self, payload: "wire.PackedPayload",
                     rx: wire.FrameBuffer) -> list[torch.Tensor]:
        """The payload's wire-dtype leaves on the server's device: a frame
        staged in ``rx`` in one copy (queued, not waited for), per-leaf
        frames one copy each."""
        if payload.frame is None:
            return [torch.from_numpy(np.ascontiguousarray(b)).to(self.device)
                    for b in payload.bufs]
        frame = rx.host_tensor(payload.frame.nbytes)
        stage = frame
        if self.device.type == "cuda":
            stage = rx.device_stage(frame.numel(), self.device)
            stage[:frame.numel()].copy_(frame, non_blocking=True)
        return [_typed(stage[e["offset"]:e["offset"] + e["nbytes"]],
                       _torch_dtype(wire.wire_dtype(e)), e["shape"])
                for e in payload.manifest["leaves"]]

    def _apply_into(self, targets: list[torch.Tensor],
                    payload: "wire.PackedPayload", bufs: list[torch.Tensor],
                    w: float) -> None:
        """Queue ``targets += decoded payload * w`` on the device.  At
        ``w == 1`` the int8 leaves go through B4 in one call (one launch),
        fp16 leaves are widened and added, raw leaves added; any other
        weight decodes, scales and adds in plain ops (three roundings, the
        JAX package's order)."""
        cs, qs, scales = [], [], []
        for c, e, b in zip(targets, payload.manifest["leaves"], bufs):
            if w != 1.0:
                d = b.to(c.dtype)
                if e["enc"] == "int8":
                    d = d * _scalar(e["scale"], c)
                c.add_(d * _scalar(w, c))
            elif e["enc"] == "int8":
                cs.append(c)
                qs.append(b)
                scales.append(e["scale"])
            elif e["enc"] == "fp16":
                c.add_(b.to(c.dtype))
            else:
                c.add_(b)
        if cs:
            wire_kernels.dequant_add_leaves_cuda(cs, qs, scales, outs=cs)
        self._c_applies.labels(path=_apply_path(w)).inc()

    def _record_applied(self, cid: int, idx: int, seq: int):
        """Mark stripe ``idx`` of client ``cid``'s sync ``seq`` applied
        (monotonic per stripe); caller holds ``_lock`` inside the stripe's
        hold, so a checkpoint sees a slice and its ledger entry together."""
        seqs = self._applied_seq.get(cid)
        if seqs is None:
            seqs = self._applied_seq[cid] = [0] * len(self.stripes)
        if seq > seqs[idx]:
            seqs[idx] = seq

    def _apply_delta(self, payload: "wire.PackedPayload",
                     rx: wire.FrameBuffer, w: float = 1.0,
                     ha: tuple[int, int] | None = None):
        """Fold one received, validated whole-tree delta into the center on
        the device, in place, and count the sync.  Waited for before
        returning, so ``rx`` is free for the next frame.  ``ha=(cid, seq)``
        records the apply on every stripe of the ledger."""
        t0 = time.perf_counter()
        with obs.span("async_ea.apply", codec=payload.codec,
                      path=_apply_path(w)), self._on_stream():
            bufs = self._device_bufs(payload, rx)
            with contextlib.ExitStack() as held:
                held.enter_context(self._apply_lock)
                for lk in self._stripe_locks:
                    held.enter_context(lk)
                self._apply_into(self.center, payload, bufs, w)
                with self._lock:
                    self._sync_count += 1
                    if ha is not None:
                        for idx in range(len(self.stripes)):
                            self._record_applied(ha[0], idx, ha[1])
                ev = self._fence()
            self._wait(ev)
        self._c_syncs.inc()
        if self._obs_on:
            if _fused_wire_apply(payload, w):
                self._h_center_apply.labels(shard="all").observe(
                    time.perf_counter() - t0)
            self._h_apply.observe(time.perf_counter() - t0)

    def _apply_stripe(self, idx: int, payload: "wire.PackedPayload",
                      rx: wire.FrameBuffer, w: float = 1.0,
                      ha: tuple[int, int] | None = None):
        """Fold one validated stripe's delta into its slice of the center
        (complete or not at all; a client dying mid-sync may land a subset
        of its stripes).  ``ha=(cid, seq)`` marks THIS stripe of THAT sync
        applied, in the same hold."""
        lo, hi = self.stripes[idx]
        t0 = time.perf_counter()
        with obs.span("async_ea.apply", shard=idx, codec=payload.codec,
                      path=_apply_path(w)), self._on_stream():
            bufs = self._device_bufs(payload, rx)
            with self._stripe_locks[idx]:
                self._apply_into(self._vcenter[lo:hi], payload, bufs, w)
                if ha is not None:
                    with self._lock:
                        self._record_applied(ha[0], idx, ha[1])
                ev = self._fence()
            self._wait(ev)
        if self._obs_on:
            if _fused_wire_apply(payload, w):
                self._h_center_apply.labels(shard=idx).observe(
                    time.perf_counter() - t0)
            self._h_shard_apply.labels(shard=idx).observe(
                time.perf_counter() - t0)

    def _count_sync(self):
        """One full client sync completed on the sharded path (counted
        once per sync, not per stripe leg)."""
        with self._lock:
            self._sync_count += 1
        self._c_syncs.inc()

    @property
    def syncs_completed(self) -> int:
        """Deltas applied since construction — also the checkpoint step."""
        with self._lock:
            return self._sync_count

    # -- capacity-weighted elastic averaging --------------------------------
    def _delta_weight(self, cid: int) -> float:
        """``cap_cid * num_nodes / sum of live caps``: the elastic move's
        pull stays at the value the fleet was tuned for while the roster
        grows or shrinks.  Exactly 1.0 for an equal-capacity fleet and for
        a server that is not elastic."""
        if not self.elastic:
            return 1.0
        live = self.members - self.evicted
        if not live:
            return 1.0
        total = sum(self._capacity.get(c, 1.0) for c in live)
        if total <= 0.0:
            return 1.0
        return self._capacity.get(cid, 1.0) * self.num_nodes / total

    # -- sharded serving ----------------------------------------------------
    def _enter_reply(self, cid: int, want: str):
        """The legacy plain string, or the dict form carrying the wire
        agreement, the epoch and — for a client that negotiated it — the
        stripe plan."""
        codec = self._wire_cid.get(cid)
        if codec is None:
            return want
        reply: dict[str, Any] = {"a": want,
                                 "wire": {"v": wire.WIRE_V, "codec": codec},
                                 "epoch": self.epoch}
        if self._shard_cid.get(cid):
            reply["shard"] = self._shard_spec
        return reply

    def _serve_stripe_leg(self, conn: Conn, idx: int, codec: str
                          ) -> "wire.PackedPayload":
        """One stripe's half of a sharded sync: ``Center?`` -> the stripe's
        center slice down, ``delta?`` -> its delta up, validated, into the
        calling thread's rx frame (the caller applies it)."""
        lo, hi = self.stripes[idx]
        b0 = conn.bytes_sent + conn.bytes_received
        rx = self._frame("rx")
        with obs.span("async_ea.stripe_leg", shard=idx):
            _expect(conn, CENTER_Q)
            conn.send_tensors(self._stripe_host(idx), codec=codec,
                              packed=True)
            _expect(conn, DELTA_Q)
            conn.send_msg(DELTA)
            payload = conn.recv_payload(
                n=hi - lo, deadline=_deadline(self.handshake_timeout),
                out=rx)
            self._check_delta(payload, self._stripe_meta(idx))
        self._c_shard_syncs.labels(shard=idx).inc()
        self._c_shard_bytes.labels(shard=idx).inc(
            conn.bytes_sent + conn.bytes_received - b0)
        return payload

    def _serve_striped(self, cid: int, conn: Conn):
        """Serve every stripe of one sharded sync: stripe 0 on the calling
        thread, stripes 1.. on transient threads against their shard
        endpoints.  Any leg failure re-raises (after all legs settle) into
        the caller's eviction handling; completed stripes stay applied."""
        codec = self._wire_cid[cid]
        seq = self._sync_seq.get(cid)
        tc = self._trace_cid.get(cid)
        ha = (cid, seq) if seq is not None else None
        w = self._delta_weight(cid)

        def leg(idx):
            with self._frames_as(("leg", idx)), \
                    obs_trace.use_context(tc):
                if idx == 0:
                    c = conn
                else:
                    c = self.shard_endpoints[idx - 1].get_conn(
                        cid, timeout=self.handshake_timeout or 30.0)
                    c.set_timeout(self.handshake_timeout)
                payload = self._serve_stripe_leg(c, idx, codec)
                self._apply_stripe(idx, payload, self._frame("rx"), w, ha)

        _fanout([lambda i=i: leg(i) for i in range(len(self.stripes))])
        self._count_sync()

    def _evict(self, cid: int, why: Exception):
        """Drop a dead/hung client: close all its channels (broadcast,
        dedicated, every shard) so recv_any stops selecting it and stripe
        legs fail fast; remaining clients keep syncing."""
        self.evicted.add(cid)
        self._c_evict.inc()
        self._g_members.set(len(self.members - self.evicted))
        print_server(f"evicting client #{cid}: {why!r}")
        conn = self.dedicated.get(cid)
        if conn is not None:
            _close(conn)
        for ep in self.shard_endpoints:
            ep.drop(cid)
        idx = self._cid_to_broadcast.get(cid)
        if idx is not None:
            _close(self.broadcast.conns[idx])

    @property
    def live_clients(self) -> int:
        return len(self.members - self.evicted)

    # -- re-admission -------------------------------------------------------
    def _accept_rejoiners(self):
        """Accept pending broadcast re-connections (non-blocking poll of the
        listener) while somebody is evicted or the fleet is elastic.
        Accepted conns get a speak-by deadline: a rejoiner that dials in
        but never speaks is closed when it passes."""
        self._prune_broadcast()
        now = time.monotonic()
        kept = []
        for c, dl in self._rejoin_pending:
            if c.sock.fileno() < 0:
                continue                      # spoke (or died) — tracked out
            if now > dl:
                _close(c)
                continue
            kept.append((c, dl))
        self._rejoin_pending = kept
        if not self.evicted and not self.elastic:
            return
        while True:
            r, _, _ = select.select([self.broadcast.sock], [], [], 0.0)
            if not r:
                return
            try:
                new = self.broadcast.accept(
                    1, timeout=self.handshake_timeout or 30.0)
            except (TimeoutError, OSError):
                return
            if self.throttle_bps:
                new[0].throttle_bps = self.throttle_bps
            self._rejoin_pending.append(
                (new[0], time.monotonic()
                 + (self.handshake_timeout or 30.0)))

    def _prune_broadcast(self):
        """Drop closed broadcast conns and remap the cid -> index table."""
        if all(c.sock.fileno() >= 0 for c in self.broadcast.conns):
            return
        mapping = self.broadcast.prune_closed()
        self._cid_to_broadcast = {
            cid: mapping[i] for cid, i in self._cid_to_broadcast.items()
            if i in mapping}

    def _note_spoke(self, idx: int):
        """A broadcast conn delivered a message: it is no longer a silent
        rejoin candidate."""
        conn = self.broadcast.conns[idx]
        self._rejoin_pending = [(c, dl) for c, dl in self._rejoin_pending
                                if c is not conn]

    def _evict_dropped(self, idx: int, why: Exception):
        """``recv_any``'s frame-timeout drop closed a broadcast conn at
        transport level: if it belonged to an admitted client, record a
        real eviction (closing its dedicated channel too)."""
        for cid, i in self._cid_to_broadcast.items():
            if i == idx and cid not in self.evicted:
                self._evict(cid, why)
                return

    def _finish_readmit(self, cid: int, idx: int, conn: Conn):
        """Swap in the fresh channels and clear the evicted bit."""
        self.evicted.discard(cid)
        self._cid_to_broadcast[cid] = idx
        self.dedicated[cid] = conn
        self._c_rejoin.inc()
        self._g_members.set(len(self.members - self.evicted))

    def _readmit(self, idx: int, msg) -> None:
        """Complete one ``Rejoin?`` handshake: accept the evicted client's
        fresh dedicated connection, stream the current center down it,
        receive the replay of the stripes the ledger misses, and re-admit
        on the client's ``Ack``.  Any failure leaves the client evicted."""
        cid = self._parse_cid(msg)
        conn_b = self.broadcast.conns[idx]
        if cid < 0 or cid not in self.evicted:
            self._drop_peer(idx, f"dropping rejoin with bad clientID "
                                 f"{msg.get('clientID')!r}")
            return
        codec, wire_err = _parse_wire_request(msg)
        srv = self.dedicated_servers.get(cid)
        if srv is None:
            self._drop_peer(idx, f"dropping rejoin of client #{cid}: "
                                 "no dedicated listener for that cid")
            return
        try:
            # short bound: a legit rejoiner dials the dedicated channel
            # before it announces, so the dial is already in the backlog
            new = srv.accept(
                1, timeout=min(self.handshake_timeout or 2.0, 2.0))[0]
        except (TimeoutError, OSError) as e:
            print_server(f"rejoin of client #{cid} failed at dedicated "
                         f"accept: {e!r}")
            _close(conn_b)
            return
        if self.throttle_bps:
            new.throttle_bps = self.throttle_bps
        try:
            with obs.span("async_ea.rejoin", cid=cid):
                new.set_timeout(self.handshake_timeout)
                claimed_epoch = msg.get("epoch")
                if isinstance(claimed_epoch, int) \
                        and claimed_epoch > self.epoch:
                    self._c_stale.inc()
                    new.send_msg({"a": REJOIN, "stale": True,
                                  "epoch": self.epoch})
                    raise ProtocolError(
                        f"center epoch {self.epoch} is stale: client "
                        f"#{cid} has synced with epoch {claimed_epoch}")
                if wire_err is not None:
                    new.send_msg({"a": REJOIN, "wire": {"error": wire_err}})
                    raise ProtocolError(wire_err)
                self._wire_cid[cid] = codec
                self._shard_cid[cid] = (isinstance(msg.get("shard"), dict)
                                        and codec is not None
                                        and self._shard_spec is not None)
                reply = self._enter_reply(cid, REJOIN)
                # exactly-once replay: the stripes whose ledger entry is
                # older than the claimed seq (the cid is evicted, so none
                # of its legs is in flight)
                claimed_seq = msg.get("replay")
                need: list[int] = []
                if (isinstance(reply, dict) and isinstance(claimed_seq, int)
                        and claimed_seq > 0 and self.stripes is not None):
                    seqs = (self._applied_seq.get(cid)
                            or [0] * len(self.stripes))
                    need = [i for i, s in enumerate(seqs)
                            if s < claimed_seq]
                    reply["replay"] = {"seq": claimed_seq, "need": need}
                new.send_msg(reply)
                # the FULL center over the fresh dedicated conn, striped or
                # not (the client re-dials its shard channels afterwards)
                new.send_tensors(self._snapshot(), codec=codec or "raw",
                                 packed=codec is not None)
                _expect(new, ACK)
                if need:
                    self._recv_replay(cid, new, claimed_seq, need)
                new.set_timeout(None)
        except _IO_ERRORS as e:
            print_server(f"rejoin of client #{cid} failed mid-handshake: "
                         f"{e!r}")
            for c in (new, conn_b):
                _close(c)
            return
        self._finish_readmit(cid, idx, new)
        print_server(f"client #{cid} re-admitted")

    def _recv_replay(self, cid: int, conn: Conn, seq: int,
                     need: list[int]):
        """Receive and apply the replayed stripes of the client's claimed
        sync ``seq`` — the exact encoded bytes it stored at encode time —
        or drop the delta on an abort header."""
        hdr = conn.recv_msg()
        if not (isinstance(hdr, dict) and hdr.get("q") == REPLAY_Q):
            raise ProtocolError(
                f"protocol desync: expected {REPLAY_Q!r} header, "
                f"got {hdr!r}")
        if not hdr.get("abort"):
            dl = _deadline(self.handshake_timeout)
            w = self._delta_weight(cid)
            rx = self._frame("rx")
            for i in need:
                lo, hi = self.stripes[i]
                payload = conn.recv_payload(n=hi - lo, deadline=dl, out=rx)
                self._check_delta(payload, self._stripe_meta(i))
                self._apply_stripe(i, payload, rx, w, ha=(cid, seq))
            self._count_sync()
        conn.send_msg(ACK)

    def _parse_cid(self, msg) -> int:
        """The clientID an admission-family message claims, or -1 when
        absent, unparseable or not a member."""
        try:
            cid = int(msg.get("clientID", -1))
        except (TypeError, ValueError):
            return -1
        return cid if cid >= 1 and cid in self.members else -1

    def _drop_peer(self, idx: int, why: str):
        """Close one broadcast conn and log why (bad request/id)."""
        _close(self.broadcast.conns[idx])
        print_server(why)

    def _admit(self, idx: int, msg) -> int | None:
        """Validate one broadcast-channel ``Enter?`` (a sane, non-evicted
        member id, a codec this server speaks, an epoch not newer than
        ours) and record what it claims.  Returns the client id, or
        ``None`` after dropping the peer."""
        if not isinstance(msg, dict) or msg.get("q") != ENTER_Q:
            self._drop_peer(idx, f"dropping peer with bad request {msg!r}")
            return None
        cid = self._parse_cid(msg)
        if cid < 0 or cid in self.evicted:
            self._drop_peer(idx, f"dropping peer with bad clientID "
                                 f"{msg.get('clientID')!r}")
            return None
        self._cid_to_broadcast[cid] = idx
        claimed = msg.get("epoch")
        if isinstance(claimed, int) and claimed > self.epoch:
            self._refuse_stale(cid, claimed)
            return None
        codec, wire_err = _parse_wire_request(msg)
        if wire_err is not None:
            self._reject_wire(cid, wire_err)
            return None
        self._wire_cid[cid] = codec
        cap = msg.get("capacity")
        if isinstance(cap, (int, float)) and cap > 0:
            self._capacity[cid] = float(cap)
        self._shard_cid[cid] = (isinstance(msg.get("shard"), dict)
                                and codec is not None
                                and self._shard_spec is not None)
        seq = msg.get("seq")
        self._sync_seq[cid] = seq if isinstance(seq, int) else None
        tc = msg.get(obs_trace.TRACE_KEY)
        self._trace_cid[cid] = tc if obs_trace.valid_context(tc) else None
        return cid

    def _reject_wire(self, cid: int, err: str):
        """A client advertised a wire codec this server cannot speak:
        answer LOUDLY on the dedicated channel and evict."""
        conn = self.dedicated.get(cid)
        if conn is not None:
            try:
                conn.set_timeout(self.handshake_timeout)
                conn.send_msg({"a": ENTER, "wire": {"error": err}})
            except (TimeoutError, ConnectionError, OSError):
                pass
        self._evict(cid, ProtocolError(err))

    def _refuse_stale(self, cid: int, claimed: int):
        """The client has synced against a NEWER center epoch than ours:
        this process is a zombie primary.  Answer loudly and evict."""
        self._c_stale.inc()
        err = (f"center epoch {self.epoch} is stale: client #{cid} has "
               f"synced with epoch {claimed}")
        conn = self.dedicated.get(cid)
        if conn is not None:
            try:
                conn.set_timeout(self.handshake_timeout)
                conn.send_msg({"a": ENTER, "stale": True,
                               "epoch": self.epoch})
            except (TimeoutError, ConnectionError, OSError):
                pass
        self._evict(cid, ProtocolError(err))

    # -- elastic membership (Join?/Leave?) ----------------------------------
    def _handle_join(self, idx: int, msg) -> None:
        """Admit a NEW client (``Join?``): assign the next cid, open an
        ephemeral dedicated listener and advertise its port, stream the
        center down it; the roster takes the cid only after the ``Ack``
        (the join fence)."""
        conn_b = self.broadcast.conns[idx]
        if not self.elastic or self.center is None:
            self._c_join_fail.inc()
            self._drop_peer(idx, "dropping Join?: server is "
                            + ("not serving yet" if self.elastic
                               else "not elastic"))
            return
        codec, wire_err = _parse_wire_request(msg)
        if wire_err is not None:
            self._c_join_fail.inc()
            try:
                conn_b.set_timeout(self.handshake_timeout)
                conn_b.send_msg({"a": JOIN, "wire": {"error": wire_err}})
            except (TimeoutError, ConnectionError, OSError):
                pass
            self._drop_peer(idx, f"dropping joiner: {wire_err}")
            return
        cap = msg.get("capacity")
        cap = float(cap) if isinstance(cap, (int, float)) and cap > 0 else 1.0
        cid = self._next_cid
        ded = Server(self._host, 0)     # ephemeral port, advertised below
        try:
            with obs.span("async_ea.join", cid=cid):
                reply: dict[str, Any] = {"a": JOIN, "clientID": cid,
                                         "port": ded.port,
                                         "epoch": self.epoch}
                if self.advertised_centers:
                    reply["centers"] = [[h, p] for h, p
                                        in self.advertised_centers]
                if codec is not None:
                    reply["wire"] = {"v": wire.WIRE_V, "codec": codec}
                conn_b.set_timeout(self.handshake_timeout)
                conn_b.send_msg(reply)
                conn_b.set_timeout(None)
                new = ded.accept(1, timeout=self.handshake_timeout or 30.0)[0]
                if self.throttle_bps:
                    new.throttle_bps = self.throttle_bps
                new.set_timeout(self.handshake_timeout)
                new.send_tensors(self._snapshot(), codec=codec or "raw",
                                 packed=codec is not None)
                _expect(new, ACK)
                new.set_timeout(None)
        except _IO_ERRORS as e:
            self._c_join_fail.inc()
            ded.close()
            print_server(f"join of client #{cid} failed mid-handshake: "
                         f"{e!r}")
            _close(conn_b)
            return
        self._next_cid = cid + 1
        sharded = (isinstance(msg.get("shard"), dict) and codec is not None
                   and self._shard_spec is not None)
        self._register_member(cid, idx, new, ded, capacity=cap,
                              codec=codec, sharded=sharded)
        print_server(f"client #{cid} joined (capacity {cap:g}, fleet "
                     f"size {self.live_clients})")

    def _register_member(self, cid: int, idx: int, conn: Conn,
                         ded: Server, *, capacity: float,
                         codec: str | None, sharded: bool) -> None:
        """Install a joiner into the roster."""
        self.members.add(cid)
        self._capacity[cid] = capacity
        self.dedicated_servers[cid] = ded
        self.dedicated[cid] = conn
        self._cid_to_broadcast[cid] = idx
        self._wire_cid[cid] = codec
        self._shard_cid[cid] = sharded
        self._c_joins.inc()
        self._g_members.set(len(self.members - self.evicted))

    def _handle_leave(self, idx: int, msg) -> None:
        """Graceful departure (``Leave?``): flush the leaver's newest delta
        through the exactly-once ledger (the reply names the stripes whose
        applied-seq is behind the claimed seq; the client replays exactly
        those bytes), then retire the cid.  The survivors' weights grow the
        moment the leaver is gone (they derive from the live roster)."""
        cid = self._parse_cid(msg)
        if cid < 0:
            self._drop_peer(idx, f"dropping leave with bad clientID "
                                 f"{msg.get('clientID')!r}")
            return
        if cid in self.evicted:
            self._c_leaves.labels(outcome="dropped").inc()
            self._remove_member(cid)
            print_server(f"client #{cid} left (was evicted; "
                         "pending delta dropped)")
            return
        self._wait_cid_idle(cid, self.handshake_timeout or 30.0)
        conn = self.dedicated.get(cid)
        claimed = msg.get("seq")
        need: list[int] = []
        if (isinstance(claimed, int) and claimed > 0
                and self.stripes is not None):
            seqs = self._applied_seq.get(cid) or [0] * len(self.stripes)
            need = [i for i, s in enumerate(seqs) if s < claimed]
        outcome = "flushed" if need else "clean"
        if conn is None:
            outcome = "dropped"
        else:
            try:
                with obs.span("async_ea.leave", cid=cid):
                    conn.set_timeout(self.handshake_timeout)
                    conn.send_msg({"a": LEAVE,
                                   "replay": {"seq": claimed, "need": need}})
                    if need and isinstance(claimed, int):
                        self._recv_replay(cid, conn, claimed, need)
                    conn.set_timeout(None)
            except _IO_ERRORS as e:
                outcome = "dropped"
                print_server(f"leave flush of client #{cid} failed: {e!r} "
                             "(pending delta dropped)")
        self._c_leaves.labels(outcome=outcome).inc()
        self._remove_member(cid)
        print_server(f"client #{cid} left ({outcome}; fleet size "
                     f"{self.live_clients})")

    def _wait_cid_idle(self, cid: int, timeout: float) -> bool:
        """Block until none of ``cid``'s sync legs are in flight (the serial
        server is the only serving thread: nothing is)."""
        return True

    def _remove_member(self, cid: int) -> None:
        """Retire a cid for good: close every channel and its dedicated
        listener, then drop the roster entry (ids are never reused)."""
        conn = self.dedicated.pop(cid, None)
        if conn is not None:
            _close(conn)
        for ep in self.shard_endpoints:
            ep.drop(cid)
        idx = self._cid_to_broadcast.pop(cid, None)
        if idx is not None:
            _close(self.broadcast.conns[idx])
        srv = self.dedicated_servers.pop(cid, None)
        if srv is not None:
            srv.close()
        self.members.discard(cid)
        self.evicted.discard(cid)
        for table in (self._capacity, self._wire_cid, self._shard_cid,
                      self._sync_seq, self._applied_seq):
            table.pop(cid, None)
        self._g_members.set(len(self.members - self.evicted))

    def _route(self, idx: int, msg) -> bool:
        """Serve a rejoin, join or leave request; False for anything else
        (an ``Enter?`` or a bad request, for ``_admit``)."""
        q = msg.get("q") if isinstance(msg, dict) else None
        handler = {REJOIN_Q: self._readmit, JOIN_Q: self._handle_join,
                   LEAVE_Q: self._handle_leave}.get(q)
        if handler is None:
            return False
        handler(idx, msg)
        return True

    def sync_server(self, params: PyTree,
                    timeout: float | None = None) -> PyTree:
        """One full server-side sync round (ref ``syncServer``, lua
        :230-237): admit one client, send center, receive delta, apply it,
        and return a copy of the center shaped like ``params`` (in the
        port's layout).  Rejoin, join and leave requests are served on the
        way (they admit no sync).

        A client that fails mid-handshake (EOF, hang past
        ``handshake_timeout``, protocol desync, config skew) is evicted and
        the round retries with the next requester — the center never takes
        a partial delta.  ``timeout`` bounds the wait for ANY sync request
        (``None`` = wait forever, the reference's behavior); with every
        client gone ``recv_any`` raises ``RuntimeError`` (a standby or an
        elastic server keeps polling for re-dials instead)."""
        deadline = _deadline(timeout)
        while True:
            self._accept_rejoiners()
            if deadline is None:
                slice_t = 0.5 if (self.evicted or self.elastic) else None
            else:
                slice_t = max(0.0, deadline - time.monotonic())
                if self.evicted or self.elastic:
                    slice_t = min(slice_t, 0.5)
            try:
                idx, msg = self.broadcast.recv_any(
                    timeout=slice_t, frame_timeout=self.handshake_timeout,
                    on_drop=self._evict_dropped)
            except TimeoutError:
                if deadline is not None and time.monotonic() >= deadline:
                    raise
                continue
            except RuntimeError:
                if not ((self._standby and self.evicted) or self.elastic):
                    raise
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(
                        "no sync request within the timeout (standby "
                        "still waiting for its fleet to re-dial)")
                time.sleep(0.05)
                continue
            self._note_spoke(idx)
            if self._route(idx, msg):
                continue
            cid = self._admit(idx, msg)
            if cid is None:
                continue
            self.current_client = cid
            conn = self.dedicated[cid]
            t0 = time.perf_counter()
            codec = self._wire_cid.get(cid)
            payload = None
            try:
                with obs_trace.use_context(self._trace_cid.get(cid)), \
                        obs.span("async_ea.handshake", cid=cid):
                    conn.set_timeout(self.handshake_timeout)
                    conn.send_msg(self._enter_reply(cid, ENTER))
                    print_server(f"current client is #{cid}")
                    if self._shard_cid.get(cid):
                        # striped sync: every leg validates and applies its
                        # own slice inside (per-stripe atomicity)
                        self._serve_striped(cid, conn)
                        conn.set_timeout(None)
                    else:
                        # serverSendCenter (lua :180-196): ONE packed frame
                        # on a negotiated wire, per-leaf 'T' frames for
                        # legacy
                        _expect(conn, CENTER_Q)
                        conn.send_tensors(self._snapshot(),
                                          codec=codec or "raw",
                                          packed=codec is not None)
                        # serverGetUpdateDiff (lua :198-228): the FULL
                        # delta, undecoded, before any of it is applied;
                        # the deadline covers the whole stream
                        _expect(conn, DELTA_Q)
                        conn.send_msg(DELTA)
                        payload = conn.recv_payload(
                            n=len(self.center),
                            deadline=_deadline(self.handshake_timeout),
                            out=self._frame("rx"))
                        self._check_delta(payload)
                        conn.set_timeout(None)
            except _IO_ERRORS as e:
                self._evict(cid, e)
                continue
            if self._obs_on:
                self._h_handshake.observe(time.perf_counter() - t0)
            if payload is not None:
                seq = self._sync_seq.get(cid)
                self._apply_delta(payload, self._frame("rx"),
                                  self._delta_weight(cid),
                                  ha=(cid, seq) if seq is not None else None)
            print_server(f"received delta from client #{cid}")
            self._maybe_checkpoint()
            return self.current_center(params)

    def current_center(self, params: PyTree) -> PyTree:
        """A device copy of the center shaped like ``params`` (in the port's
        layout), every stripe whole."""
        return _from_wire(self.layout, _rebuild(params, self._center_clone()))

    def test_net(self) -> bool:
        """Push the center to the tester (ref ``testNet``, lua :239-258)
        from a snapshot.  A dead/hung tester must not stall training: it
        is dropped (later calls return False)."""
        conn = self.test_conn
        if conn is None:
            return False
        try:
            conn.set_timeout(self.handshake_timeout)
            conn.send_msg(TEST_Q)
            # the tester's Center? may carry a wire advertisement
            msg = conn.recv_msg()
            codec = None
            if isinstance(msg, dict) and msg.get("q") == CENTER_Q:
                codec, wire_err = _parse_wire_request(msg)
                if wire_err is not None:
                    conn.send_msg({"a": TEST_Q, "wire": {"error": wire_err}})
                    raise ProtocolError(wire_err)
            elif msg != CENTER_Q:
                raise ProtocolError(
                    f"protocol desync: expected {CENTER_Q!r}, got {msg!r}")
            conn.send_tensors(self._snapshot(), codec=codec or "raw",
                              packed=codec is not None)
            _expect(conn, ACK)
            conn.set_timeout(None)
            return True
        except _IO_ERRORS as e:
            print_server(f"dropping tester: {e!r}")
            conn.close()
            self.test_conn = None
            return False

    # -- HA: periodic checkpointing + promotion -----------------------------
    def enable_checkpoint(self, directory: str, every: int = 1,
                          keep: int = 3):
        """Checkpoint the center (plus the HA ledger) to ``directory`` every
        ``every`` applied syncs, keeping the newest ``keep`` files
        (``ckpt_{step}.npz``, the JAX package's layout): the snapshot is
        taken synchronously, the write happens off-thread.  Returns self."""
        from distlearn_tpu_torch.utils.checkpoint import AsyncCheckpointer
        self._ckpt = AsyncCheckpointer(directory, keep=keep)
        self._ckpt_every = max(1, int(every))
        self._ckpt_count = self.syncs_completed
        self._c_ckpt_saves = obs.counter(
            "center_ckpt_saves_total", "center checkpoints written")
        self._g_ckpt_step = obs.gauge(
            "center_ckpt_last_step", "sync count of the newest checkpoint")
        self._h_ckpt_save = obs.histogram(
            "center_ckpt_save_seconds",
            "snapshot + save-submit time per center checkpoint")
        return self

    def _ha_state(self) -> tuple[int, list[np.ndarray], dict]:
        """(step, REAL center leaves, HA metadata): the center's copy is
        queued under every stripe lock and the ledger, epoch and step read
        under ``_lock`` in the same hold, so they agree."""
        def ledger():
            with self._lock:
                return (self._sync_count, self.epoch,
                        {str(c): list(s)
                         for c, s in self._applied_seq.items()})

        leaves, (step, epoch, seqs) = self._snapshot(also=ledger)
        meta = {"epoch": epoch, "applied_seq": seqs,
                "wire": {str(c): v for c, v in self._wire_cid.items()},
                "shards": self.shards, "num_nodes": self.num_nodes,
                "members": sorted(self.members),
                "capacity": {str(c): v for c, v in self._capacity.items()}}
        return step, leaves, meta

    def _checkpoint_locked(self):
        """Snapshot + save; caller holds ``_ckpt_lock``.  Leaves are keyed
        ``center/<i>`` in the npz (flat index order)."""
        t0 = time.perf_counter()
        with self._frames_as("ckpt"):
            step, leaves, meta = self._ha_state()
            self._ckpt.save(step, {"center": {str(i): t for i, t
                                              in enumerate(leaves)}},
                            metadata=meta)
        self._ckpt_count = step
        self._c_ckpt_saves.inc()
        self._g_ckpt_step.set(step)
        self._h_ckpt_save.observe(time.perf_counter() - t0)

    def _maybe_checkpoint(self):
        """Cadence check on the sync path; skips (the next sync re-checks)
        when another thread is mid-checkpoint."""
        if self._ckpt is None \
                or self.syncs_completed - self._ckpt_count < self._ckpt_every:
            return
        if not self._ckpt_lock.acquire(blocking=False):
            return
        try:
            if self.syncs_completed - self._ckpt_count >= self._ckpt_every:
                self._checkpoint_locked()
        finally:
            self._ckpt_lock.release()

    def checkpoint_now(self, wait: bool = False):
        """Unconditional checkpoint (the SIGTERM final flush);
        ``wait=True`` blocks until the file is on disk."""
        if self._ckpt is None:
            return
        with self._ckpt_lock:
            self._checkpoint_locked()
        if wait:
            self._ckpt.wait()

    def adopt_ha_meta(self, meta: dict | None):
        """Adopt a restored checkpoint's HA metadata and take over as the
        NEXT center epoch (promotion).  Call after ``init_server`` with the
        restored center; a ledger cut for a different stripe plan degrades
        to the at-most-once sentinel (the replay is skipped, never
        doubled)."""
        meta = meta or {}
        try:
            self.epoch = int(meta.get("epoch", 0)) + 1
        except (TypeError, ValueError):
            self.epoch = 1
        try:
            step = int(meta.get("step", 0))
        except (TypeError, ValueError):
            step = 0
        with self._lock:
            self._sync_count = max(self._sync_count, step)
        self._ckpt_count = self.syncs_completed
        n = len(self.stripes) if self.stripes else 1
        for key, val in (meta.get("applied_seq") or {}).items():
            try:
                cid = int(key)
            except (TypeError, ValueError):
                continue
            if cid not in self.members:
                continue        # a joiner of the dead center: re-Join?s
            if (isinstance(val, list) and len(val) == n
                    and all(isinstance(v, int) for v in val)):
                self._applied_seq[cid] = list(val)
            else:
                self._applied_seq[cid] = [_SEQ_INF] * n
        obs.counter("center_ckpt_restores_total",
                    "center checkpoints restored (promotions)").inc()
        return self

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self._ckpt is not None:
            try:
                self._ckpt.wait()   # surface (don't lose) a failed write
            except Exception as e:  # noqa: BLE001 — close never raises
                print_server(f"final checkpoint flush failed: {e!r}")
        self.broadcast.close()
        for s in self.dedicated_servers.values():
            s.close()
        for ep in self.shard_endpoints:
            ep.close()
        if self.test_server:
            self.test_server.close()


class AsyncEAServerConcurrent(AsyncEAServer):
    """Concurrent parameter server: the same wire protocol (clients and
    testers connect unchanged), but handshakes for different clients
    OVERLAP.  A dispatcher thread drains ``Enter?`` requests and routes a
    token to the requesting client's worker thread, which runs the whole
    center-down/delta-up handshake on the client's dedicated channel; a
    striped client's stripes 1.. run on one stripe worker each.  Snapshots
    and applies are ordered per stripe (see the module docstring), so a
    client never receives a torn stripe; two overlapping clients may both
    fetch the pre-update center — the stale-gradient asynchrony EASGD
    tolerates (arXiv:1412.6651 §4).

    A worker's unexpected failure (anything but a client's IO or protocol
    fault, which evicts the client) is recorded and re-raised by
    :meth:`stop`."""

    def __init__(self, host: str, port: int, num_nodes: int,
                 with_tester: bool = False, accept_timeout: float = 120.0,
                 handshake_timeout: float | None = 30.0,
                 rejoin_grace: float = 10.0, shards: int = 1,
                 throttle_bps: float | None = None, standby: bool = False,
                 elastic: bool = False,
                 centers: list[tuple[str, int]] | None = None,
                 device=None, layout: WireLayout | None = None):
        super().__init__(host, port, num_nodes, with_tester=with_tester,
                         accept_timeout=accept_timeout,
                         handshake_timeout=handshake_timeout,
                         shards=shards, throttle_bps=throttle_bps,
                         standby=standby, elastic=elastic,
                         centers=centers, device=device, layout=layout)
        # how long the dispatcher polls for a Rejoin? after every broadcast
        # conn closed while somebody is evicted
        self.rejoin_grace = float(rejoin_grace)
        self._queues: dict[int, Any] = {
            cid: queue.Queue() for cid in range(1, num_nodes + 1)}
        self._shard_queues: dict[tuple[int, int], Any] = {}
        # per-client connection generation: bumped on every eviction and
        # readmit under _lock; tokens carry the generation they were
        # issued against and workers discard mismatches
        self._conn_gen: dict[int, int] = {
            cid: 0 for cid in range(1, num_nodes + 1)}
        self._threads: list = []
        self._workers: dict[int, Any] = {}
        self._stop = threading.Event()
        self._dispatch_closed = threading.Event()
        self._inflight = 0
        self._inflight_cid: dict[int, int] = {}
        self._errors: list[BaseException] = []
        self._g_inflight = obs.gauge(
            "async_ea_inflight", "sync handshakes currently in flight")
        self._g_threads = obs.gauge(
            "async_ea_server_threads",
            "live dispatcher/worker threads of this server")

    def _evict(self, cid: int, why: Exception):
        """Concurrent eviction: mark + drain the client's token queues under
        the SAME lock the dispatcher enqueues under."""
        with self._lock:
            self._evict_locked(cid, why)

    def _evict_locked(self, cid: int, why: Exception):
        """Eviction body; caller holds ``_lock``.  Idempotent per eviction
        cycle: only the first decision bumps the generation and drains."""
        if cid in self.evicted:
            return
        self._conn_gen[cid] = self._conn_gen.get(cid, 0) + 1
        super()._evict(cid, why)
        for q in ([q for q in (self._queues.get(cid),) if q is not None]
                  + [sq for (qcid, _), sq in self._shard_queues.items()
                     if qcid == cid]):
            while True:
                try:
                    token = q.get_nowait()
                except queue.Empty:
                    break
                if token is not None:
                    self._dec_inflight_locked(cid)

    def _dec_inflight_locked(self, cid: int, n: int = 1):
        """Settle ``n`` of ``cid``'s in-flight leg slots; caller holds
        ``_lock``."""
        self._inflight -= n
        self._g_inflight.dec(n)
        left = self._inflight_cid.get(cid, 0) - n
        if left > 0:
            self._inflight_cid[cid] = left
        else:
            self._inflight_cid.pop(cid, None)

    def _delta_weight(self, cid: int) -> float:
        # workers read the roster concurrently with join/leave mutations
        with self._lock:
            return super()._delta_weight(cid)

    @property
    def drained(self) -> bool:
        """True once no further syncs can arrive from the fleet: the
        dispatcher exited (every broadcast channel closed) and no handshake
        is in flight.  An elastic dispatcher keeps polling for joiners
        until stopped, so an elastic fleet has drained once every broadcast
        channel is closed with no member evicted (none can rejoin), no dial
        waiting to speak and nothing in flight."""
        with self._lock:
            inflight = self._inflight
            gone = not any(c.sock.fileno() >= 0
                           for c in self.broadcast.conns)
        if self.elastic:
            if not (gone and not self.evicted
                    and not self._rejoin_pending):
                return False
        elif not self._dispatch_closed.is_set():
            return False
        return (inflight == 0
                and all(q.empty() for q in self._queues.values())
                and all(q.empty() for q in self._shard_queues.values()))

    # -- threads ------------------------------------------------------------
    def _health(self) -> dict:
        """The ``/healthz`` payload (lock-free reads)."""
        return {"live_clients": self.live_clients,
                "inflight": self._inflight,
                "drained": self.drained}

    def _run(self, fn, *args):
        """A thread body: ``fn(*args)`` on the server's device and stream;
        an unexpected exception is kept for :meth:`stop`."""
        try:
            if self._stream is not None:
                torch.cuda.set_device(self.device)
            fn(*args)
        except BaseException as e:  # noqa: BLE001 — re-raised by stop()
            with self._lock:
                self._errors.append(e)
            print_server(f"server thread {fn.__name__} failed: {e!r}")

    def _thread(self, fn, *args) -> threading.Thread:
        return threading.Thread(target=self._run, args=(fn, *args),
                                daemon=True)

    def start(self):
        """Spawn the dispatcher, one worker per client and, when the center
        is striped, one stripe worker per (client, stripe > 0).  Returns
        self."""
        if self.stripes is None:
            raise RuntimeError("init_server (or ha.promote) must run before "
                               "start: the stripe plan sizes the workers")
        obs.set_health_source(self._health)
        self._threads = [self._thread(self._dispatch)]
        self._workers = {cid: self._thread(self._worker, cid)
                         for cid in sorted(self.members)}
        self._threads += list(self._workers.values())
        if len(self.stripes) > 1:
            for cid in sorted(self.members):
                for idx in range(1, len(self.stripes)):
                    self._shard_queues[(cid, idx)] = queue.Queue()
                    self._threads.append(
                        self._thread(self._shard_worker, cid, idx))
        for t in self._threads:
            t.start()
        self._g_threads.set(len(self._threads))
        return self

    def stop(self, deadline: float = 10.0):
        """Stop the dispatcher and every worker: sentinel all queues, join
        with a shared deadline, and — if any thread is still blocked in
        socket IO — close the server's sockets so the blocked call fails,
        then join once more.  Re-raises the first unexpected failure of a
        server thread."""
        self._stop.set()
        for q in list(self._queues.values()):
            q.put(None)
        for q in self._shard_queues.values():
            q.put(None)
        end = time.monotonic() + deadline
        for t in self._threads:
            t.join(timeout=max(0.0, end - time.monotonic()))
        if any(t.is_alive() for t in self._threads):
            self.close()
            end = time.monotonic() + deadline
            for t in self._threads:
                if t.is_alive():
                    t.join(timeout=max(0.0, end - time.monotonic()))
        self._threads = [t for t in self._threads if t.is_alive()]
        self._workers = {cid: t for cid, t in self._workers.items()
                         if t.is_alive()}
        if not self._threads:
            with self._lock:
                if self._inflight:
                    self._g_inflight.dec(self._inflight)
                    self._inflight = 0
                self._inflight_cid.clear()
        self._g_threads.set(len(self._threads))
        obs.set_health_source(None)
        with self._lock:
            errs, self._errors = self._errors, []
        if errs:
            raise RuntimeError(
                f"{len(errs)} server thread(s) failed; first: "
                f"{errs[0]!r}") from errs[0]

    def _rejoin_grace_poll(self) -> bool:
        """True once a re-connection landed; False when the grace expires
        or the server is stopping."""
        deadline = time.monotonic() + self.rejoin_grace
        while time.monotonic() < deadline and not self._stop.is_set():
            self._accept_rejoiners()
            if any(c.sock.fileno() >= 0 for c in self.broadcast.conns):
                return True
            time.sleep(0.05)
        return False

    def _dispatch(self):
        try:
            self._dispatch_loop()
        finally:
            self._dispatch_closed.set()

    def _prune_broadcast(self):
        with self._lock:        # workers read the cid map during eviction
            super()._prune_broadcast()

    def _finish_readmit(self, cid: int, idx: int, conn: Conn):
        """Re-admit under the dispatcher lock and make sure the client has
        a live worker: one that evicted its own client has returned and is
        respawned; one still parked on the queue serves the fresh channel
        as it is (it re-reads the conn per token)."""
        with self._lock:
            self._conn_gen[cid] = self._conn_gen.get(cid, 0) + 1
            super()._finish_readmit(cid, idx, conn)
            need = self._workers.get(cid) is None
            if need:
                t = self._thread(self._worker, cid)
                self._workers[cid] = t
                self._threads = [th for th in self._threads
                                 if th.is_alive()] + [t]
        if need:
            t.start()

    def _register_member(self, cid: int, idx: int, conn: Conn,
                         ded: Server, *, capacity: float,
                         codec: str | None, sharded: bool) -> None:
        """Roster install + the joiner's serving threads, all created under
        the dispatcher lock."""
        with self._lock:
            super()._register_member(cid, idx, conn, ded,
                                     capacity=capacity, codec=codec,
                                     sharded=sharded)
            self._conn_gen.setdefault(cid, 0)
            self._queues[cid] = queue.Queue()
            t = self._thread(self._worker, cid)
            self._workers[cid] = t
            spawn = [t]
            if len(self.stripes) > 1:
                for s in range(1, len(self.stripes)):
                    self._shard_queues[(cid, s)] = queue.Queue()
                    spawn.append(self._thread(self._shard_worker, cid, s))
            self._threads = [th for th in self._threads
                             if th.is_alive()] + spawn
        for t in spawn:
            t.start()
        self._g_threads.set(len(self._threads))

    def _remove_member(self, cid: int) -> None:
        """Retire the cid AND its serving threads, under the dispatcher
        lock: bump the generation, drain + sentinel its queues."""
        with self._lock:
            self._conn_gen[cid] = self._conn_gen.get(cid, 0) + 1
            qs = [q for q in (self._queues.pop(cid, None),)
                  if q is not None]
            for key in [k for k in self._shard_queues if k[0] == cid]:
                qs.append(self._shard_queues.pop(key))
            for q in qs:
                while True:
                    try:
                        token = q.get_nowait()
                    except queue.Empty:
                        break
                    if token is not None:
                        self._dec_inflight_locked(cid)
                q.put(None)         # unpark + retire the worker
            self._workers.pop(cid, None)
            self._conn_gen.pop(cid, None)
            super()._remove_member(cid)

    def _wait_cid_idle(self, cid: int, timeout: float) -> bool:
        """Wait out the cid's in-flight legs (bounded)."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                q = self._queues.get(cid)
                idle = (self._inflight_cid.get(cid, 0) == 0
                        and (q is None or q.empty()))
            if idle:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)

    def _dispatch_loop(self):
        while not self._stop.is_set():
            self._accept_rejoiners()
            try:
                idx, msg = self.broadcast.recv_any(
                    timeout=0.5, frame_timeout=self.handshake_timeout,
                    on_drop=self._evict_dropped)
            except TimeoutError:
                continue
            except RuntimeError:
                # every broadcast conn closed.  An elastic fleet may grow
                # again: keep polling.  Otherwise wait for in-flight
                # handshakes to settle (a crashing client's FIN shows here
                # before its worker's eviction lands), then stop unless an
                # evicted client re-dials within the grace.
                if self.elastic:
                    self._accept_rejoiners()
                    time.sleep(0.05)
                    continue
                deadline = time.monotonic() + (self.handshake_timeout
                                               or 30.0)
                while time.monotonic() < deadline and not self.evicted:
                    with self._lock:
                        if self._inflight == 0:
                            break
                    time.sleep(0.01)
                if not self.evicted or not self._rejoin_grace_poll():
                    return
                continue
            except (ConnectionError, OSError, ValueError):
                # a worker evicting its client closed that client's
                # broadcast conn under this select: one dead conn
                continue
            self._note_spoke(idx)
            if self._route(idx, msg):
                continue
            cid = self._admit(idx, msg)
            if cid is None:
                continue
            with self._lock:
                if cid in self.evicted:
                    continue
                q = self._queues.get(cid)
                if q is None:
                    continue            # left between _admit and here
                gen = self._conn_gen.get(cid, 0)
                sharded = (self._shard_cid.get(cid, False)
                           and bool(self._shard_queues))
                n_legs = len(self.stripes) if sharded else 1
                self._inflight += n_legs
                self._g_inflight.inc(n_legs)
                self._inflight_cid[cid] = \
                    self._inflight_cid.get(cid, 0) + n_legs
                q.put(gen)
                if sharded:
                    for s in range(1, len(self.stripes)):
                        self._shard_queues[(cid, s)].put(gen)

    def _worker(self, cid: int):
        self._tls.key = ("w", cid)
        q = self._queues.get(cid)
        if q is None:
            return
        while not self._stop.is_set():
            token = q.get()
            if token is None:
                return
            # re-read per token, in one hold with the generation check: a
            # rejoin swaps the dedicated conn while this thread is parked
            with self._lock:
                stale = token != self._conn_gen.get(cid, 0)
                conn = self.dedicated.get(cid)
                codec = self._wire_cid.get(cid)
                sharded = self._shard_cid.get(cid, False)
                seq = self._sync_seq.get(cid)
                tc = self._trace_cid.get(cid)
                if conn is None:
                    stale = True
                if stale:
                    self._dec_inflight_locked(cid)
            if stale:
                continue
            t0 = time.perf_counter()
            try:
                try:
                    with obs_trace.use_context(tc), \
                            obs.span("async_ea.handshake", cid=cid):
                        conn.set_timeout(self.handshake_timeout)
                        conn.send_msg(self._enter_reply(cid, ENTER))
                        if sharded:
                            payload = self._serve_stripe_leg(conn, 0, codec)
                        else:
                            _expect(conn, CENTER_Q)
                            conn.send_tensors(self._snapshot(),
                                              codec=codec or "raw",
                                              packed=codec is not None)
                            _expect(conn, DELTA_Q)
                            conn.send_msg(DELTA)
                            payload = conn.recv_payload(
                                n=len(self._leaf_meta),
                                deadline=_deadline(self.handshake_timeout),
                                out=self._frame("rx"))
                            self._check_delta(payload)
                        conn.set_timeout(None)
                except _IO_ERRORS as e:
                    # evict only if OUR conn is still the client's channel,
                    # and deregister in the same hold
                    with self._lock:
                        current = self.dedicated.get(cid) is conn
                        if current:
                            self._evict_locked(cid, e)
                            self._workers.pop(cid, None)
                    if current:
                        return
                    continue                   # stale-conn failure: park
                if self._obs_on:
                    self._h_handshake.observe(time.perf_counter() - t0)
                ha = (cid, seq) if seq is not None else None
                w = self._delta_weight(cid)
                if sharded:
                    self._apply_stripe(0, payload, self._frame("rx"), w, ha)
                    self._count_sync()
                else:
                    self._apply_delta(payload, self._frame("rx"), w, ha)
                self._maybe_checkpoint()
            finally:
                with self._lock:
                    self._dec_inflight_locked(cid)

    def _shard_worker(self, cid: int, idx: int):
        """Serve stripe ``idx`` (>= 1) of one client's syncs until retired.
        It never exits on eviction: stale tokens are dropped by the
        generation compare, and the thread parks for the next admission."""
        self._tls.key = ("s", cid, idx)
        ep = self.shard_endpoints[idx - 1]
        q0 = self._shard_queues.get((cid, idx))
        if q0 is None:
            return
        while not self._stop.is_set():
            token = q0.get()
            if token is None:
                return
            with self._lock:
                stale = token != self._conn_gen.get(cid, 0)
                codec = self._wire_cid.get(cid)
                seq = self._sync_seq.get(cid)
                tc = self._trace_cid.get(cid)
            try:
                if stale:
                    continue
                conn = None
                try:
                    conn = ep.get_conn(cid,
                                       timeout=self.handshake_timeout or 30.0)
                    with self._lock:
                        superseded = token != self._conn_gen.get(cid, 0)
                    if superseded:
                        # an eviction raced past us while we waited for the
                        # dial: reap the dead admission's socket if it is
                        # the registered one, polling until it dies, is
                        # superseded, or the next token takes over
                        while (not self._stop.is_set() and q0.empty()
                               and ep.conns.get(cid) is conn):
                            if ep.drop_if_dead(cid, conn):
                                break
                            time.sleep(0.05)
                        continue
                    conn.set_timeout(self.handshake_timeout)
                    with obs_trace.use_context(tc):
                        payload = self._serve_stripe_leg(conn, idx, codec)
                    conn.set_timeout(None)
                except _IO_ERRORS as e:
                    with self._lock:
                        registered = (conn is not None
                                      and ep.conns.get(cid) is conn)
                        if registered:
                            ep.drop(cid)
                        if (token == self._conn_gen.get(cid, 0)
                                and (conn is None or registered)):
                            self._evict_locked(cid, e)
                    continue
                self._apply_stripe(idx, payload, self._frame("rx"),
                                   self._delta_weight(cid),
                                   ha=(cid, seq) if seq is not None else None)
            finally:
                with self._lock:
                    self._dec_inflight_locked(cid)


class _DeltaSender:
    """Depth-1 background sender for the overlap path: ``submit(job)``
    hands the previous round's delta transmit to a worker thread and
    returns, so the next round's tau local steps overlap the push.  At most
    ONE job is in flight (``submit`` flushes the previous one first), which
    keeps the EASGD staleness bound.  A background failure is stored and
    re-raised at the next ``flush`` (the top of the next sync); ``drain``
    discards it (the connection it came from is being replaced)."""

    def __init__(self):
        self._q: Any = queue.Queue(maxsize=1)
        self._idle = threading.Event()
        self._idle.set()
        self._err: BaseException | None = None
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while True:
            job = self._q.get()
            if job is None:
                self._idle.set()
                return
            try:
                job()
            except BaseException as e:  # noqa: BLE001 — surfaced at flush
                self._err = e
            finally:
                self._idle.set()

    def flush(self):
        """Wait out the in-flight job; re-raise its failure, if any."""
        self._idle.wait()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, job):
        self.flush()            # depth 1: at most one delta in flight
        self._idle.clear()
        self._q.put(job)

    def drain(self):
        """Wait for idle and DISCARD any stored failure."""
        self._idle.wait()
        self._err = None

    def close(self):
        self._idle.wait()
        self._q.put(None)
        self._t.join(timeout=5.0)
        self._err = None


class AsyncEAClient:
    """Worker role (ref initClient/syncClient).

    ``codec`` selects the wire format: ``"raw"`` (default) coalesces each
    direction into one packed frame, ``"fp16"``/``"int8"`` additionally
    quantize (deltas carry client-side error-feedback residuals, 1-bit-SGD
    style); ``None`` speaks the legacy per-leaf wire.  Against an old
    server the client falls back to the legacy frames.  ``overlap=True``
    pushes each delta from a background sender.  ``sharded=True``
    advertises striped syncs (the server decides).  ``centers`` is the
    failover dial list after the primary; ``capacity`` the weight an
    elastic server folds into this client's deltas; ``adaptive_tau``
    stretches the sync period when syncs slow down.  ``params`` are
    pytrees of tensors on the client's device, in the port's layout;
    ``layout`` names the wire's.  ``slice_backend``, a stacked-value
    backend on the client's device, makes this the slice client of L rows
    (the module docstring): ``params`` lead with ``[L]``, the center keeps
    the wire's shape."""

    def __init__(self, host: str, port: int, node: int, tau: int,
                 alpha: float, codec: str | None = "raw",
                 overlap: bool = False, sharded: bool = True,
                 throttle_bps: float | None = None,
                 centers: list[tuple[str, int]] | None = None,
                 capacity: float = 1.0, adaptive_tau: bool = False,
                 slice_backend=None,
                 device=None, layout: WireLayout | None = None,
                 _broadcast: Conn | None = None,
                 _dedicated_port: int | None = None):
        if node < 1:
            raise ValueError("node is 1-based (reference convention)")
        if codec is not None and codec not in wire.CODECS:
            raise ValueError(f"unknown wire codec {codec!r} "
                             f"(supported: {', '.join(wire.CODECS)})")
        if capacity <= 0:
            raise ValueError("capacity must be > 0")
        rows = None
        if slice_backend is not None:
            rows = getattr(slice_backend, "stacked_nodes", None)
            if not rows:
                raise ValueError(
                    "slice_backend must be a stacked-value backend "
                    "(stacked_nodes set) — MeshBackend or HybridBackend")
        self._slice = slice_backend
        self._slice_rows = int(rows or 0)
        self.device = resolve_device(device)
        self.layout = layout
        self.node = node
        self.tau = int(tau)
        self.alpha = float(alpha)
        self.codec = codec
        self.capacity = float(capacity)
        self.adaptive_tau = bool(adaptive_tau)
        self._tau_lo, self._tau_hi = adaptive_tau_bounds(tau, alpha)
        self.tau_effective = self._tau_lo
        self._next_sync = self._tau_lo
        self._lat_ewma: float | None = None
        self._lat_floor: float | None = None
        self.sharded = bool(sharded) and codec is not None
        self.throttle_bps = throttle_bps
        self.step = 0
        self.host, self.port = host, port
        # clientBroadcast -> port; dedicated client -> port+node
        # (EASGD_client.lua:58-61); a joiner's dedicated channel is the
        # ephemeral port its Join reply advertised
        self._ded_port = _dedicated_port
        self.broadcast = (_broadcast if _broadcast is not None
                          else connect(host, port))
        self.conn = connect(host, port + node if _dedicated_port is None
                            else _dedicated_port)
        if throttle_bps:
            self.conn.throttle_bps = throttle_bps
        self.center: list[torch.Tensor] | None = None
        self._slab: _LeafSlab | None = None
        # None until the first handshake; False pins legacy once a plain-
        # string reply proves the server predates the packed wire
        self._packed: bool | None = None
        self._residuals: list[torch.Tensor] | None = None
        self._sender = _DeltaSender() if overlap else None
        # the stripe plan pinned from the first sharded reply, and the
        # conns to shard endpoints 1..S-1 (stripe 0 rides self.conn)
        self._shard_spec: dict | None = None
        self._stripes: list[tuple[int, int]] | None = None
        self._splits: list[int] | None = None
        self._shard_conns: list[Conn] = []
        # -- HA state -------------------------------------------------------
        self._centers: list[tuple[str, int]] = [(host, port)] + [
            (h, int(p)) for h, p in (centers or [])
            if (h, int(p)) != (host, port)]
        self._center_i = 0
        self._seen_epoch: int | None = None
        # per-sync sequence stamped into Enter?; (seq, payloads, bounds) of
        # the newest encoded delta is kept until the next encode, so a
        # failover rejoin can replay the exact bytes (exactly-once)
        self._seq = 0
        self._pending: tuple[int, list, list] | None = None
        self._last_reply: dict | None = None
        # one staging frame a stripe (page-locked on the card, device twin
        # behind it), reused by every encode of that stripe
        self._framebufs: list[wire.FrameBuffer] = []
        self._obs_on = obs.enabled()
        self._h_encode = obs.histogram(
            "wire_encode_seconds",
            "one stripe's delta encode (quantize + error-feedback "
            "residual), by stripe", labels=("shard",))
        self._c_redials = obs.counter(
            "async_ea_failover_redials_total",
            "failover re-dial attempts (per candidate center tried)")
        self._c_replays = obs.counter(
            "async_ea_failover_replays_total",
            "rejoin replay outcomes of the pending delta, by outcome",
            labels=("outcome",))
        self._c_stale = obs.counter(
            "async_ea_failover_stale_refusals_total",
            "admissions refused on the epoch fence (stale/zombie center)")
        self._g_tau = obs.gauge(
            "async_ea_adaptive_tau",
            "effective sync period after straggler adaptation, by client",
            labels=("cid",))

    def _announce(self, q: str, want: str) -> bool:
        """Send an admission request (with the wire, shard, capacity,
        epoch and seq keys unless a previous reply proved the server
        legacy) and parse the reply.  Returns True when this handshake
        uses the packed wire."""
        adv = self.codec is not None and self._packed is not False
        msg: dict[str, Any] = {"q": q, "clientID": self.node}
        if adv:
            msg["wire"] = {"v": wire.WIRE_V, "codec": self.codec}
            if self.sharded:
                msg["shard"] = {"v": SHARD_V}
            if self.capacity != 1.0:
                msg["capacity"] = self.capacity
            if self._seen_epoch is not None:
                msg["epoch"] = self._seen_epoch
            if q == ENTER_Q:
                self._seq += 1
                msg["seq"] = self._seq
            elif q == REJOIN_Q and self._pending is not None:
                msg["replay"] = self._pending[0]
        tc = obs_trace.wire_context()
        if tc is not None:
            msg[obs_trace.TRACE_KEY] = tc
        self.broadcast.send_msg(msg)
        reply = self.conn.recv_msg()
        if not adv:
            if reply != want:
                raise ProtocolError(
                    f"protocol desync: expected {want!r}, got {reply!r}")
            return False
        if isinstance(reply, dict) and reply.get("stale"):
            raise StaleCenterError(
                f"center at {self.host}:{self.port} refused us as stale: "
                f"its epoch {reply.get('epoch')!r} is behind ours "
                f"({self._seen_epoch!r})")
        self._packed = _check_wire_reply(reply, want, self.codec)
        self._last_reply = reply if isinstance(reply, dict) else None
        if isinstance(reply, dict):
            ep = reply.get("epoch")
            if isinstance(ep, int):
                if self._seen_epoch is not None and ep < self._seen_epoch:
                    raise StaleCenterError(
                        f"center at {self.host}:{self.port} serves epoch "
                        f"{ep}, but we have synced with epoch "
                        f"{self._seen_epoch}")
                self._seen_epoch = ep
        if self.sharded and self._packed:
            self._apply_shard_spec(reply.get("shard"))
        return self._packed

    def _apply_shard_spec(self, spec) -> None:
        """Adopt (first sight) or re-verify the server's stripe plan.  On
        first sight, validate it and dial + hello every shard endpoint; the
        plan is then PINNED (a server that changes it mid-stream is a
        protocol error: the residuals' stripes would not line up)."""
        if self._shard_spec is not None:
            if spec != self._shard_spec:
                raise ProtocolError(
                    f"shard plan changed mid-stream: pinned "
                    f"{self._shard_spec!r}, server now says {spec!r}")
            return
        if spec is None:
            return                          # unsharded (or legacy) server
        ok = (isinstance(spec, dict) and spec.get("v") == SHARD_V
              and isinstance(spec.get("ports"), list)
              and isinstance(spec.get("stripes"), list)
              and isinstance(spec.get("splits", []), list))
        host_leaves = self._slab.host_leaves if self._slab else []
        splits = [1] * len(host_leaves)
        if ok:
            stripes = [tuple(s) for s in spec["stripes"]]
            n = spec.get("n")
            ok = (n == len(stripes) and n == len(spec["ports"]) + 1
                  and n >= 2 and stripes[0][0] == 0
                  and all(len(s) == 2 and s[0] < s[1] for s in stripes)
                  and all(stripes[i][1] == stripes[i + 1][0]
                          for i in range(n - 1)))
        if ok:
            last = -1
            for row in spec.get("splits", []):
                ok = (ok and isinstance(row, (list, tuple))
                      and len(row) == 2
                      and all(isinstance(v, int) for v in row)
                      and last < row[0] < len(splits) and row[1] >= 2
                      and row[1] <= int(host_leaves[row[0]].size or 0))
                if not ok:
                    break
                splits[row[0]] = row[1]
                last = row[0]
            ok = ok and stripes[-1][1] == len(splits) + sum(
                p - 1 for p in splits)
        if not ok:
            raise ProtocolError(f"malformed shard plan {spec!r}")
        conns = []
        try:
            for s, port in enumerate(spec["ports"], start=1):
                c = connect(self.host, port)
                if self.throttle_bps:
                    c.throttle_bps = self.throttle_bps
                c.send_msg({"q": SHARD_Q, "clientID": self.node, "shard": s})
                conns.append(c)
        except (ConnectionError, OSError):
            for c in conns:
                _close(c)
            raise
        self._shard_spec = spec
        self._stripes = stripes
        self._splits = splits
        self._shard_conns = conns

    def _adopt_center(self, got: list[np.ndarray]) -> None:
        """Hold a received center (wire layout) in the device slab."""
        metas = [(a.shape, a.dtype) for a in got]
        if self._slab is None or self._slab.metas != [
                (tuple(s), np.dtype(d)) for s, d in metas]:
            self._slab = _LeafSlab(metas, self.device)
        for h, a in zip(self._slab.host_leaves, got):
            h[...] = a
        self._slab.to_device()

    def _recv_center(self, conn: Conn, n: int,
                     deadline: float | None = None) -> None:
        """Receive a whole center on ``conn`` into the slab (straight into
        its host twin once it exists) and copy it to the device."""
        if self._slab is None or len(self._slab.host_leaves) != n:
            self._adopt_center(conn.recv_tensors(n=n, deadline=deadline))
            return
        conn.recv_tensors(out=self._slab.host_leaves, deadline=deadline)
        self._slab.to_device()

    def _center(self, params: PyTree, wire_leaves: list[torch.Tensor]
                ) -> list[torch.Tensor]:
        """The fetched center's leaves in the port's layout (the slab's own
        views when the layouts agree)."""
        if self.layout is None:
            return wire_leaves
        return _leaves(self.layout.from_wire(_rebuild(params, wire_leaves)))

    def _params_at_center(self, params: PyTree) -> PyTree:
        self.center = self._center(params, self._slab.leaves)
        return _rebuild(params, [c.clone() for c in self.center])

    def init_client(self, params: PyTree) -> PyTree:
        """Receive the initial center from the server's broadcast; params :=
        center on the client's device (ref lua :64-78).  The initial
        broadcast is per-leaf; ``recv_tensors`` auto-detects either
        framing."""
        self._recv_center(self.broadcast, len(_leaves(params)))
        if self._slice is not None:
            # every row of the slice starts at the center
            self.center = self._center(params, self._slab.leaves)
            return _rebuild(params, [
                c.unsqueeze(0).expand((self._slice_rows,) + tuple(c.shape))
                .contiguous() for c in self.center])
        return self._params_at_center(params)

    def sync_client(self, params: PyTree) -> tuple[PyTree, bool]:
        """Every ``tau``-th call (``tau_effective`` steps after the last
        sync with ``adaptive_tau``): full sync handshake (ref
        ``syncClient``, lua :134-146).  Returns ``(new_params, synced)``."""
        self.step += 1
        if self.adaptive_tau:
            if self.step < self._next_sync:
                return params, False
        elif self.step % self.tau != 0:     # isSyncNeeded (lua :47-57)
            return params, False
        if not obs_trace.propagate_enabled():
            return self._sync_once(params)
        with obs_trace.use_context(obs_trace.new_trace()), \
                obs.span("async_ea.sync", cid=self.node):
            return self._sync_once(params)

    def _framebuf(self, idx: int) -> wire.FrameBuffer:
        while len(self._framebufs) <= idx:
            self._framebufs.append(
                wire.FrameBuffer(pinned=self.device.type == "cuda"))
        return self._framebufs[idx]

    def _sync_once(self, params: PyTree) -> tuple[PyTree, bool]:
        t_sync = time.perf_counter()
        if self._sender is not None:
            # the previous delta must be on the wire before the next
            # Enter? — and a background failure surfaces here
            self._sender.flush()
        # clientEnterSync (lua :82-92)
        print_client(self.node, "waiting to sync")
        with obs.span("async_ea.wait"):
            packed = self._announce(ENTER_Q, ENTER)
        striped = packed and self._stripes is not None
        # clientGetCenter (lua :95-106): into the host twin (striped: one
        # leg a stripe, concurrently, into chunk views of the twin), then
        # one copy to the device center
        if striped:
            vhost = wire.split_views(self._slab.host_leaves, self._splits)
            if self._stripes[-1][1] != len(vhost):
                raise ProtocolError(
                    f"shard plan covers {self._stripes[-1][1]} virtual "
                    f"leaves, center splits to {len(vhost)}")
            conns = [self.conn] + self._shard_conns
            tc0 = obs_trace.current()

            def _fetch(i):
                lo, hi = self._stripes[i]
                with obs_trace.use_context(tc0), \
                        obs.span("async_ea.fetch_center", shard=i):
                    conns[i].send_msg(CENTER_Q)
                    conns[i].recv_tensors(out=vhost[lo:hi])

            _fanout([lambda i=i: _fetch(i)
                     for i in range(len(self._stripes))])
            self.center = self._center(params, self._slab.to_device())
        else:
            with obs.span("async_ea.fetch_center", shard=0):
                self.conn.send_msg(CENTER_Q)
                self.conn.recv_tensors(out=self._slab.host_leaves)
                self.center = self._center(params, self._slab.to_device())
        # calculateUpdateDiff (lua :109-119): the elastic move on the
        # device.  Deltas go over the wire in the CENTER's dtype (the
        # server rejects dtype skew), contiguous in the wire layout.
        with obs.span("async_ea.delta"):
            leaves = _leaves(params)
            deltas = []
            for p, c in zip(leaves, self.center):
                # a slice client's rows each pull against the one center
                d = (p - (c if self._slice is None else c[None])).to(c.dtype)
                d.mul_(cast_scalar(self.alpha, d.dtype))
                deltas.append(d)
            new_leaves = [p - d for p, d in zip(leaves, deltas)]
            if self._slice is not None:
                # the row-sum of the deltas, pushed once below
                red, _ = self._slice.all_reduce(deltas)
                deltas = list(self._slice.node_slice(red, 0))
            if self.layout is not None:
                deltas = _leaves(self.layout.to_wire(_rebuild(params,
                                                              deltas)))
            deltas = [d.contiguous() for d in deltas]
            _sync(self.device)
        payloads = None
        if packed:
            if (self.codec != "raw"
                    and (self._residuals is None
                         or len(self._residuals) != len(deltas))):
                # full-length residuals, so a stripe's chunk views alias
                # the same per-leaf tensors whatever the plan
                self._residuals = [torch.zeros_like(d) for d in deltas]
            enc_deltas, enc_res = deltas, self._residuals
            if striped:
                enc_deltas = _split_views(deltas, self._splits)
                if self._residuals is not None:
                    enc_res = _split_views(self._residuals, self._splits)
            bounds = self._stripes if striped else [(0, len(enc_deltas))]
            payloads = [self._encode_stripe(enc_deltas, enc_res, lo, hi, i)
                        for i, (lo, hi) in enumerate(bounds)]
            # the encoded bytes stay until the next encode: a failover
            # rejoin replays exactly the stripes the server never applied
            self._pending = (self._seq, payloads, [tuple(b) for b in bounds])
        else:
            self._pending = None
        # clientSendDiff (lua :122-132)
        conn = self.conn
        tc1 = obs_trace.current()

        def _push_delta():
            if striped:
                conns = [conn] + self._shard_conns

                def _push(i):
                    with obs_trace.use_context(tc1), \
                            obs.span("async_ea.push_delta", shard=i):
                        conns[i].send_msg(DELTA_Q)
                        _expect(conns[i], DELTA)
                        conns[i].send_packed(payloads[i])

                _fanout([lambda i=i: _push(i) for i in range(len(payloads))])
                return
            with obs_trace.use_context(tc1), \
                    obs.span("async_ea.push_delta", shard=0):
                conn.send_msg(DELTA_Q)
                _expect(conn, DELTA)
                if payloads is not None:
                    conn.send_packed(payloads[0])
                else:
                    for d in deltas:
                        conn.send_tensor(d.cpu().numpy())

        if self._sender is not None:
            # overlap: the push runs behind the next tau local steps; the
            # frames it reads were completed by the encode's synchronize
            # and are not reused before the next sync's flush
            self._sender.submit(_push_delta)
        else:
            _push_delta()
        if self.adaptive_tau:
            self._note_sync_latency(time.perf_counter() - t_sync)
            self._next_sync = self.step + self.tau_effective
        print_client(self.node, "synced")
        return _rebuild(params, new_leaves), True

    def _note_sync_latency(self, dt: float) -> None:
        """Fold one sync's wall time into the latency EWMA and re-derive
        ``tau_effective`` (the EWMA over the best latency seen, bounded by
        :func:`adaptive_tau_bounds`)."""
        self._lat_ewma = (dt if self._lat_ewma is None
                          else 0.7 * self._lat_ewma + 0.3 * dt)
        self._lat_floor = (self._lat_ewma if self._lat_floor is None
                           else min(self._lat_floor, self._lat_ewma))
        ratio = (self._lat_ewma / self._lat_floor
                 if self._lat_floor and self._lat_floor > 0 else 1.0)
        self.tau_effective = min(self._tau_hi,
                                 max(self._tau_lo,
                                     int(round(self._tau_lo * ratio))))
        if self._obs_on:
            self._g_tau.labels(cid=self.node).set(self.tau_effective)

    def _encode_stripe(self, deltas: list[torch.Tensor],
                       residuals: list[torch.Tensor] | None,
                       lo: int, hi: int, idx: int = 0):
        """Encode one stripe's delta slice for the packed wire into stripe
        ``idx``'s own frame: error feedback (Seide et al. 2014) for lossy
        codecs — quantize delta + carried residual, keep the new
        quantization error (B3 on the card, one amax and one quantize
        launch).  ``deltas``/``residuals`` are the lists the stripe plan
        indexes (chunk views of the full-length per-leaf tensors when
        striped)."""
        t0 = time.perf_counter()
        sl = deltas[lo:hi]
        with obs.span("async_ea.encode", shard=idx, codec=self.codec):
            if self.codec == "raw":
                payload = wire_kernels.encode_ef_into(
                    sl, None, "raw", out=self._framebuf(idx))
            else:
                res = residuals[lo:hi]
                for d, r in zip(sl, res):
                    d += r
                payload = wire_kernels.encode_ef_into(
                    sl, res, self.codec, out=self._framebuf(idx))
        if self._obs_on and self.codec != "raw":
            self._h_encode.labels(shard=idx).observe(
                time.perf_counter() - t0)
        return payload

    def _close_channels(self) -> None:
        for c in (self.broadcast, self.conn, *self._shard_conns):
            _close(c)
        # unpin the stripe plan: the next reply re-advertises it and every
        # shard endpoint is re-dialed
        self._shard_spec = None
        self._stripes = None
        self._splits = None
        self._shard_conns = []

    def _rejoin_handshake(self, n_leaves: int, retries: int,
                          retry_interval: float,
                          handshake_timeout: float | None,
                          host: str | None = None,
                          port: int | None = None) -> None:
        """The Rejoin? machinery behind :meth:`rejoin` and
        :meth:`failover`: tear down every connection, re-dial (optionally a
        DIFFERENT center), announce ``Rejoin?``, adopt the center, and run
        the replay exchange for a pending delta."""
        if host is not None:
            self.host = host
            self.port = port if port is not None else self.port
        if self._sender is not None:
            self._sender.drain()
        self._close_channels()
        # dedicated dialed BEFORE the announce: the server accepts on it
        # as soon as it reads the Rejoin?
        self.broadcast = connect(self.host, self.port, retries=retries,
                                 retry_interval=retry_interval)
        self.conn = connect(self.host,
                            self.port + self.node if self._ded_port is None
                            else self._ded_port,
                            retries=retries, retry_interval=retry_interval)
        if self.throttle_bps:
            self.conn.throttle_bps = self.throttle_bps
        self.conn.set_timeout(handshake_timeout)
        self._announce(REJOIN_Q, REJOIN)
        self._recv_center(self.conn, n_leaves, _deadline(handshake_timeout))
        self.conn.send_msg(ACK)
        self._replay_exchange()
        self.conn.set_timeout(None)

    def _replay_exchange(self) -> None:
        """After a Rejoin (or Leave) reply: resend the pending stripes the
        server's ledger is missing — or an abort header when the plan no
        longer matches the stored payloads.  The pending delta is consumed
        either way."""
        info = (self._last_reply or {}).get("replay") \
            if isinstance(self._last_reply, dict) else None
        pending, self._pending = self._pending, None
        if not isinstance(info, dict):
            if pending is not None:
                self._c_replays.labels(outcome="dropped").inc()
            return
        need = info.get("need") or []
        if not need:
            self._c_replays.labels(outcome="clean").inc()
            return
        seq, payloads, bounds = (pending if pending is not None
                                 else (None, [], []))
        plan_ok = (pending is not None and info.get("seq") == seq
                   and all(isinstance(i, int) and 0 <= i < len(payloads)
                           for i in need))
        if plan_ok:
            if self._stripes is not None:
                plan_ok = bounds == [tuple(s) for s in self._stripes]
            else:
                plan_ok = len(bounds) == 1
        if not plan_ok:
            self.conn.send_msg({"q": REPLAY_Q, "abort": True})
            _expect(self.conn, ACK)
            self._c_replays.labels(outcome="dropped").inc()
            return
        self.conn.send_msg({"q": REPLAY_Q, "n": len(need)})
        for i in need:
            self.conn.send_packed(payloads[i])
        _expect(self.conn, ACK)
        self._c_replays.labels(outcome="replayed").inc()

    @staticmethod
    def _join_request(capacity: float, codec: str | None,
                      sharded: bool) -> dict:
        msg: dict[str, Any] = {"q": JOIN_Q, "capacity": float(capacity)}
        if codec is not None:
            msg["wire"] = {"v": wire.WIRE_V, "codec": codec}
            if sharded:
                msg["shard"] = {"v": SHARD_V}
        return msg

    @staticmethod
    def _join_reply(b: Conn) -> dict:
        """Read and check a Join reply: ``(cid, dedicated port)`` in it."""
        reply = b.recv_msg()
        if not (isinstance(reply, dict) and reply.get("a") == JOIN):
            raise ProtocolError(
                f"protocol desync: expected {JOIN!r} reply, got {reply!r}")
        w = reply.get("wire")
        if isinstance(w, dict) and w.get("error"):
            raise ProtocolError(str(w["error"]))
        if not (isinstance(reply.get("clientID"), int)
                and isinstance(reply.get("port"), int)):
            raise ProtocolError(f"malformed {JOIN!r} reply {reply!r}")
        return reply

    def _join_handshake(self, n_leaves: int, retries: int,
                        retry_interval: float,
                        handshake_timeout: float | None,
                        host: str, port: int) -> None:
        """Failover re-entry for a ``Join?``-admitted client (its dedicated
        listener died with the old center): a FRESH ``Join?`` under a new
        cid, keeping local params and residuals; epoch-fenced.  The new cid
        has no ledger entry, so a pending delta is dropped."""
        if self._sender is not None:
            self._sender.drain()
        self._close_channels()
        self.host, self.port = host, port
        b = connect(host, port, retries=retries,
                    retry_interval=retry_interval)
        try:
            b.set_timeout(handshake_timeout)
            b.send_msg(self._join_request(self.capacity, self.codec,
                                          self.sharded))
            reply = self._join_reply(b)
            ep = reply.get("epoch")
            if isinstance(ep, int):
                if self._seen_epoch is not None and ep < self._seen_epoch:
                    raise StaleCenterError(
                        f"join admitted by a stale center: epoch {ep} "
                        f"< seen {self._seen_epoch}")
                self._seen_epoch = ep
            b.set_timeout(None)
        except BaseException:
            b.close()
            raise
        self.broadcast = b
        was, cid, dport = self.node, reply["clientID"], reply["port"]
        self.node = cid
        self._ded_port = dport
        self.conn = connect(host, dport, retries=retries,
                            retry_interval=retry_interval)
        if self.throttle_bps:
            self.conn.throttle_bps = self.throttle_bps
        self.conn.set_timeout(handshake_timeout)
        self._recv_center(self.conn, n_leaves, _deadline(handshake_timeout))
        self.conn.send_msg(ACK)
        self.conn.set_timeout(None)
        self._packed = isinstance(reply.get("wire"), dict)
        hint = reply.get("centers")
        if isinstance(hint, list):
            self._adopt_centers_hint(hint)
        if self._pending is not None:
            self._pending = None
            self._c_replays.labels(outcome="dropped").inc()
        print_client(self.node, f"re-joined the fleet as #{cid} "
                     f"(was #{was})")

    def _adopt_centers_hint(self, hint) -> None:
        """Fold a Join-reply ``centers`` roster into the failover dial
        list (dedup, current center kept first)."""
        for item in hint:
            try:
                h, p = item
                addr = (str(h), int(p))
            except (TypeError, ValueError):
                continue
            if addr not in self._centers:
                self._centers.append(addr)

    def rejoin(self, params: PyTree, retries: int = 60,
               retry_interval: float = 0.25,
               handshake_timeout: float | None = 60.0) -> PyTree:
        """Recover from an eviction: re-dial both channels, announce
        ``Rejoin?``, and take the server's CURRENT center as params.  The
        residual and the pending delta are dropped (they belong to a
        center that is gone); ``step`` and ``tau`` are kept."""
        self._residuals = None
        self._pending = None
        self._rejoin_handshake(len(_leaves(params)), retries,
                               retry_interval, handshake_timeout)
        print_client(self.node, "re-admitted")
        return self._params_at_center(params)

    def failover(self, params: PyTree, retries: int = 60,
                 retry_interval: float = 0.25,
                 handshake_timeout: float | None = 60.0) -> PyTree:
        """Survive a center death: walk the dial list (primary + standbys)
        until some center admits us through the Rejoin path, replaying the
        pending delta if asked.  LOCAL params and residuals are kept (the
        promoted center restored the same trajectory); a center refusing us
        on the epoch fence leaves the dial list for good.  Returns
        ``params`` unchanged; raises ``ConnectionError`` when the list is
        exhausted."""
        n = len(_leaves(params))
        with obs.span("async_ea.failover", cid=self.node):
            for _ in range(max(1, int(retries))):
                if not self._centers:
                    break
                host, port = self._centers[self._center_i
                                           % len(self._centers)]
                self._c_redials.inc()
                enter = (self._join_handshake if self._ded_port is not None
                         else self._rejoin_handshake)
                try:
                    enter(n, retries=3, retry_interval=retry_interval,
                          handshake_timeout=handshake_timeout,
                          host=host, port=port)
                except StaleCenterError:
                    # before ProtocolError (its base): a fenced-off center
                    # never becomes valid again
                    self._c_stale.inc()
                    try:
                        self._centers.remove((host, port))
                    except ValueError:
                        pass
                    continue
                except (TimeoutError, ConnectionError, ProtocolError,
                        OSError):
                    self._center_i += 1
                    continue
                print_client(self.node, "failed over to "
                             f"{self.host}:{self.port}")
                return params
        raise ConnectionError(
            f"client {self.node}: no center admitted us "
            f"(dial list: {self._centers!r})")

    @classmethod
    def join(cls, host: str, port: int, params: PyTree, tau: int,
             alpha: float, *, capacity: float = 1.0,
             codec: str | None = "raw", overlap: bool = False,
             sharded: bool = True, adaptive_tau: bool = False,
             throttle_bps: float | None = None,
             centers: list[tuple[str, int]] | None = None,
             timeout: float | None = 60.0, device=None,
             layout: WireLayout | None = None
             ) -> tuple["AsyncEAClient", PyTree]:
        """Enter a RUNNING elastic fleet: announce ``Join?`` (no cid — the
        server assigns the next one and opens an ephemeral dedicated
        listener), dial the advertised port, adopt the current center and
        Ack — only then is the client a member.  Returns ``(client,
        params)`` with params := center, ready for :meth:`sync_client`."""
        resolve_device(device)
        b = connect(host, port)
        try:
            b.set_timeout(timeout)
            b.send_msg(cls._join_request(capacity, codec, sharded))
            reply = cls._join_reply(b)
            b.set_timeout(None)
        except BaseException:
            b.close()
            raise
        cid = reply["clientID"]
        cl = cls(host, port, cid, tau, alpha, codec=codec, overlap=overlap,
                 sharded=sharded, throttle_bps=throttle_bps,
                 centers=centers, capacity=capacity,
                 adaptive_tau=adaptive_tau, device=device, layout=layout,
                 _broadcast=b, _dedicated_port=reply["port"])
        try:
            ep = reply.get("epoch")
            if isinstance(ep, int):
                cl._seen_epoch = ep
            hint = reply.get("centers")
            if isinstance(hint, list):
                cl._adopt_centers_hint(hint)
            cl._packed = isinstance(reply.get("wire"), dict)
            cl.conn.set_timeout(timeout)
            cl._recv_center(cl.conn, len(_leaves(params)))
            cl.conn.send_msg(ACK)
            cl.conn.set_timeout(None)
        except BaseException:
            cl.close()
            raise
        print_client(cid, "joined the fleet")
        return cl, cl._params_at_center(params)

    def leave(self, timeout: float | None = 30.0) -> None:
        """Depart gracefully: flush any overlapped send, announce
        ``Leave?`` with the seq of our newest delta, and replay whatever
        stripes the center's ledger is missing.  Closes every channel on
        the way out, even when the flush fails."""
        try:
            if self._sender is not None:
                try:
                    self._sender.flush()
                except _IO_ERRORS:
                    pass        # conn may be dead; Leave? will say so too
            with obs.span("async_ea.leave", cid=self.node):
                self.broadcast.set_timeout(timeout)
                self.conn.set_timeout(timeout)
                self.broadcast.send_msg({"q": LEAVE_Q,
                                         "clientID": self.node,
                                         "seq": self._seq})
                reply = self.conn.recv_msg()
                if not (isinstance(reply, dict)
                        and reply.get("a") == LEAVE):
                    raise ProtocolError(
                        f"protocol desync: expected {LEAVE!r} reply, "
                        f"got {reply!r}")
                self._last_reply = reply
                self._replay_exchange()
            print_client(self.node, "left the fleet")
        finally:
            self.close()

    def close(self):
        if self._sender is not None:
            self._sender.close()
        self.broadcast.close()
        self.conn.close()
        for c in self._shard_conns:
            _close(c)


class AsyncEATester:
    """Evaluation role (ref initTester/startTest/finishTest).

    ``codec`` opts into the packed wire for center fetches (the
    advertisement rides the tester's own ``Center?``, so leave it ``None``
    against an old server).  ``layout`` names the wire's layout."""

    def __init__(self, host: str, port: int, num_nodes: int,
                 codec: str | None = None, device=None,
                 layout: WireLayout | None = None):
        if codec is not None and codec not in wire.CODECS:
            raise ValueError(f"unknown wire codec {codec!r} "
                             f"(supported: {', '.join(wire.CODECS)})")
        self.device = resolve_device(device)
        self.layout = layout
        self.codec = codec
        # test channel on port+numNodes+1 (EASGD_tester.lua:64)
        self.conn = connect(host, port + num_nodes + 1)

    def start_test(self, params: PyTree) -> PyTree:
        """Block until the server pushes ``Test?``; fetch the center onto
        the tester's device, shaped like ``params`` (ref lua :268-285)."""
        _expect(self.conn, TEST_Q)
        if self.codec is not None:
            self.conn.send_msg({"q": CENTER_Q,
                                "wire": {"v": wire.WIRE_V,
                                         "codec": self.codec}})
        else:
            self.conn.send_msg(CENTER_Q)
        got = self.conn.recv_tensors(n=len(_leaves(params)))
        print_tester("received center for evaluation")
        return _from_wire(self.layout, _rebuild(
            params, [torch.from_numpy(a).to(self.device) for a in got]))

    def finish_test(self):
        """Ack the round so the server resumes (ref lua :287-292)."""
        self.conn.send_msg(ACK)

    def close(self):
        self.conn.close()
