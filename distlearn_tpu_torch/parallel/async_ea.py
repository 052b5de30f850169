"""Asynchronous EASGD over a hub-and-spoke parameter server — counterpart of
``distlearn_tpu/parallel/async_ea.py`` (the rebuild of lua/AsyncEA.lua),
for its serial roles and the unstriped packed wire.

Three roles (reference export surface lua/AsyncEA.lua:294-303):

* **server** — holds the center on its device, does no training; admits
  ONE client at a time through the ``Enter?``/``Enter`` critical section
  (lua :163-177), streams the center, receives the elastic delta, applies
  ``center += delta`` (lua :198-228).
* **client** — trains locally; every ``tau``-th step runs the sync
  handshake: ``Enter?`` -> fetch center -> local elastic move
  ``delta = (p - c) * alpha; p -= delta`` (lua :109-119) -> push delta.
* **tester** — an evaluation role the server pushes the center to every
  ``testTime`` syncs (lua :239-292).

Socket topology (examples/EASGD_server.lua:67-77): broadcast channel on
``port`` (all clients), one dedicated channel per client on ``port + i``,
test channel on ``port + numNodes + 1``.  The wire (negotiation, packed
frames, the raw/fp16/int8 codecs) is the JAX package's byte for byte, so a
JAX peer and a port peer interoperate.

Device placement.  Every role keeps its tensors on its device (the card
unless ``device="cpu"`` is asked for) and the host sees only wire bytes:

* the server's center is a list of views into ONE flat device buffer with a
  page-locked host twin (:class:`_LeafSlab`): each ``Center?`` is one
  device-to-host copy; a received delta frame lands in a page-locked
  staging buffer, goes to the device in one copy, and is applied there —
  int8 leaves by the B4 kernel (``ops/wire_kernels.dequant_add_cuda``),
  fp16 leaves widened and added, raw leaves added;
* the client's params, center copy, delta and error-feedback residual live
  on the device: the received center goes host-to-device in one copy, the
  elastic move runs there, B3 (``quantize_ef_cuda``) quantizes, and only
  the wire bytes (int8 for the int8 codec) cross back, in one copy.

Not ported yet (ROADMAP A9(c)/(d)): the concurrent server, stripes
(``shards > 1``), overlap, rejoin, elastic membership, HA and the slice
client.  The server answers ``Rejoin?``, ``Join?`` and ``Leave?`` the way
it answers any request it does not serve: the peer is dropped (evicted when
it names a client id).
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from distlearn_tpu_torch import obs
from distlearn_tpu_torch.comm import (Conn, ProtocolError, Server, connect,
                                      wire)
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
CENTER_Q = "Center?"
DELTA_Q = "delta?"
DELTA = "delta"
TEST_Q = "Test?"
ACK = "Ack"

# ---------------------------------------------------------------------------
# Wire negotiation (packed 'P' frames + codecs, comm/wire.py).
#
# A new client advertises {"wire": {"v": 1, "codec": ...}} inside its
# Enter? request; extra keys are invisible to an old server (it only reads
# "q"/"clientID" and replies the plain "Enter" string), so the client
# detects a legacy peer from the STRING reply and falls back to per-leaf
# 'T' frames.  A new server replies {"a": "Enter", "wire": {...}} — a dict
# — ONLY to clients that advertised.  An unsupported codec is answered with
# a wire error and an eviction.


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


def _leaves(tree: PyTree) -> list[torch.Tensor]:
    return [torch.as_tensor(x) for x in tree_flatten(tree)[0]]


def _rebuild(tree: PyTree, leaves: list) -> PyTree:
    return tree_unflatten(tree_flatten(tree)[1], leaves)


def _expect(conn: Conn, want: str):
    """Protocol step check — explicit (never stripped under ``python -O``,
    unlike the reference's asserts) and diagnostic on desync."""
    got = conn.recv_msg()
    if got != want:
        raise ProtocolError(f"protocol desync: expected {want!r}, got {got!r}")


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


class _LeafSlab:
    """A list of leaves stored in ONE flat byte buffer on a device (each
    leaf a typed view at a 16-byte aligned offset, so the kernels' vector
    paths apply) with a host twin of the same layout, page-locked for a
    CUDA device: the whole list crosses between host and device in one
    copy.  ``leaves`` are the device views, ``host_leaves`` numpy views of
    the twin."""

    def __init__(self, metas: list[tuple[tuple, np.dtype]],
                 device: torch.device):
        offsets, total = [], 0
        for shape, dtype in metas:
            offsets.append(total)
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            total += -(-nbytes // 16) * 16
        self.device = device
        self.dev = torch.empty(total, dtype=torch.uint8, device=device)
        self.host = torch.empty(total, dtype=torch.uint8,
                                pin_memory=device.type == "cuda")
        host_np = self.host.numpy()
        self.leaves, self.host_leaves = [], []
        for (shape, dtype), off in zip(metas, offsets):
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            self.leaves.append(_typed(self.dev[off:off + nbytes],
                                      _torch_dtype(dtype), shape))
            self.host_leaves.append(
                host_np[off:off + nbytes].view(dtype).reshape(shape))

    def to_host(self) -> list[np.ndarray]:
        """Copy the device leaves to the host twin (complete on return)."""
        self.host.copy_(self.dev, non_blocking=self.host.is_pinned())
        _sync(self.device)
        return self.host_leaves

    def to_device(self) -> list[torch.Tensor]:
        """Copy the host twin to the device leaves (complete on return: the
        twin may be overwritten as soon as this returns)."""
        self.dev.copy_(self.host, non_blocking=self.host.is_pinned())
        _sync(self.device)
        return self.leaves


class AsyncEAServer:
    """Parameter-server role (ref initServer/syncServer/testNet), serial:
    one client's sync at a time."""

    def __init__(self, host: str, port: int, num_nodes: int,
                 with_tester: bool = False, accept_timeout: float = 120.0,
                 handshake_timeout: float | None = 30.0, device=None):
        self.device = resolve_device(device)
        self.num_nodes = num_nodes
        # Per-handshake IO timeout on the dedicated channels: a client that
        # dies or hangs mid-sync is EVICTED and the server keeps serving the
        # others (the reference wedges here, lua/AsyncEA.lua:163-228).
        self.handshake_timeout = handshake_timeout
        self.evicted: set[int] = set()
        self._cid_to_broadcast: dict[int, int] = {}
        # negotiated wire codec per client id (None = legacy per-leaf 'T'
        # frames), refreshed on every Enter?
        self._wire_cid: dict[int, str | None] = {}
        self._trace_cid: dict[int, dict | None] = {}
        # Broadcast channel: all clients connect here (EASGD_server.lua:67-68);
        # dedicated per-client channels on port+i (:71-77); test channel on
        # port+numNodes+1 (:69-70).
        self.broadcast = Server(host, port)
        self.dedicated_servers = {i + 1: Server(host, port + i + 1)
                                  for i in range(num_nodes)}
        self.test_server = Server(host, port + num_nodes + 1) \
            if with_tester else None
        self.broadcast.accept(num_nodes, timeout=accept_timeout)
        self.dedicated: dict[int, Conn] = {
            cid: srv.accept(1, timeout=accept_timeout)[0]
            for cid, srv in self.dedicated_servers.items()}
        self.test_conn = \
            self.test_server.accept(1, timeout=accept_timeout)[0] \
            if with_tester else None
        self.center: list[torch.Tensor] | None = None
        self._slab: _LeafSlab | None = None
        self._leaf_meta: list[tuple[tuple, np.dtype]] | None = None
        # received delta frames land here (page-locked on the card), then
        # go to the device in one copy
        self._rx = wire.FrameBuffer(pinned=self.device.type == "cuda")
        self._closed = False
        self._obs_on = obs.enabled()
        self._c_syncs = obs.counter(
            "async_ea_syncs_total", "deltas applied to the center")
        self._c_evict = obs.counter(
            "async_ea_evictions_total", "clients evicted mid-handshake")
        self._h_handshake = obs.histogram(
            "async_ea_handshake_seconds",
            "full sync handshake (Enter sent to delta validated)")
        self._h_apply = obs.histogram(
            "async_ea_center_apply_seconds",
            "center += delta apply time (host or device path)")

    def init_server(self, params: PyTree):
        """Clone params as the center on the server's device, broadcast it
        to every client (ref lua :150-160)."""
        leaves = _leaves(params)
        self._leaf_meta = [(tuple(t.shape),
                            wire_kernels.numpy_dtype(t.dtype))
                           for t in leaves]
        self._slab = _LeafSlab(self._leaf_meta, self.device)
        self.center = self._slab.leaves
        for c, t in zip(self.center, leaves):
            c.copy_(t)
        center = self._center_host()
        for conn in self.broadcast.conns:
            try:
                # per-leaf 'T' frames: nothing has been negotiated yet, so
                # old-wire clients must be able to read it
                conn.send_tensors(center, packed=False)
            except (TimeoutError, ConnectionError, OSError) as e:
                print_server(f"initial broadcast to a client failed: {e!r}")
                conn.close()

    def _center_host(self) -> list[np.ndarray]:
        """The center as host arrays: one device-to-host copy into the
        reused page-locked twin."""
        with obs.span("async_ea.center_d2h"):
            return self._slab.to_host()

    def _check_delta(self, deltas):
        """Reject a structurally wrong delta BEFORE any leaf is applied, so
        the center never takes a torn update.  Dtype skew is config skew
        too.  A :class:`wire.PackedPayload` is checked against its
        manifest's logical shapes/dtypes."""
        if isinstance(deltas, wire.PackedPayload):
            got = [(tuple(e["shape"]), np.dtype(e["dtype"]))
                   for e in deltas.manifest["leaves"]]
        else:
            got = [(tuple(d.shape), d.dtype) for d in deltas]
        for (shape, dtype), (dshape, ddtype) in zip(self._leaf_meta, got):
            if dshape != shape:
                raise ProtocolError(
                    f"delta leaf shape {dshape} != center "
                    f"{shape} — client/server model config skew")
            if ddtype != dtype:
                raise ProtocolError(
                    f"delta leaf dtype {ddtype} != center {dtype} — "
                    "client/server model config skew")

    def _device_bufs(self, payload: "wire.PackedPayload"
                     ) -> list[torch.Tensor]:
        """The payload's wire-dtype leaves on the server's device: a staged
        frame in one copy, per-leaf frames one copy each."""
        if payload.frame is None:
            return [torch.from_numpy(np.ascontiguousarray(b)).to(self.device)
                    for b in payload.bufs]
        frame = self._rx.host_tensor(payload.frame.nbytes)
        stage = frame
        if self.device.type == "cuda":
            stage = self._rx.device_stage(frame.numel(), self.device)
            stage[:frame.numel()].copy_(frame, non_blocking=True)
        return [_typed(stage[e["offset"]:e["offset"] + e["nbytes"]],
                       _torch_dtype(wire.wire_dtype(e)), e["shape"])
                for e in payload.manifest["leaves"]]

    def _apply_delta(self, payload: "wire.PackedPayload"):
        """Fold one received, validated delta into the center on the
        device, in place: int8 leaves through B4, fp16 leaves widened and
        added, raw leaves added (dtypes equal, checked).  Synchronised
        before returning, so the staging buffer is free for the next
        frame."""
        t0 = time.perf_counter()
        with obs.span("async_ea.apply"):
            bufs = self._device_bufs(payload)
            for c, entry, b in zip(self.center, payload.manifest["leaves"],
                                   bufs):
                if entry["enc"] == "int8":
                    wire_kernels.dequant_add_cuda(c, b, entry["scale"], out=c)
                elif entry["enc"] == "fp16":
                    c.add_(b.to(c.dtype))
                else:
                    c.add_(b)
            _sync(self.device)
        self._c_syncs.inc()
        if self._obs_on:
            self._h_apply.observe(time.perf_counter() - t0)

    def _evict(self, cid: int, why: Exception):
        """Drop a dead/hung client: close its channels so recv_any stops
        selecting it; remaining clients keep syncing."""
        self.evicted.add(cid)
        self._c_evict.inc()
        print_server(f"evicting client #{cid}: {why!r}")
        conn = self.dedicated.get(cid)
        if conn is not None:
            conn.close()
        idx = self._cid_to_broadcast.get(cid)
        if idx is not None:
            self.broadcast.conns[idx].close()

    @property
    def live_clients(self) -> int:
        return self.num_nodes - len(self.evicted)

    def _evict_dropped(self, idx: int, why: Exception):
        """``recv_any``'s frame-timeout drop closed a broadcast conn at
        transport level: if it belonged to an admitted client, record a
        real eviction (closing its dedicated channel too)."""
        for cid, i in self._cid_to_broadcast.items():
            if i == idx and cid not in self.evicted:
                self._evict(cid, why)
                return

    def _parse_cid(self, msg) -> int:
        """The clientID a message claims, or -1 when absent, unparseable or
        out of range."""
        try:
            cid = int(msg.get("clientID", -1))
        except (TypeError, ValueError):
            return -1
        return cid if 1 <= cid <= self.num_nodes else -1

    def _drop_peer(self, idx: int, why: str):
        """Close one broadcast conn and log why (bad request/id)."""
        self.broadcast.conns[idx].close()
        print_server(why)

    def _admit(self, idx: int, msg) -> int | None:
        """Validate one broadcast-channel request (``Enter?`` + a sane,
        non-evicted clientID).  Returns the client id, or ``None`` after
        dropping the peer.  Requests this server does not serve (rejoin,
        join, leave) drop the peer too, and evict the client they name."""
        if not isinstance(msg, dict) or msg.get("q") != ENTER_Q:
            cid = self._parse_cid(msg) if isinstance(msg, dict) else -1
            if cid > 0 and cid not in self.evicted:
                self._cid_to_broadcast[cid] = idx
                self._evict(cid, ProtocolError(
                    f"request {msg.get('q')!r} is not served by the serial "
                    "server"))
            else:
                self._drop_peer(idx, f"dropping peer with bad request "
                                     f"{msg!r}")
            return None
        cid = self._parse_cid(msg)
        if cid < 0 or cid in self.evicted:
            self._drop_peer(idx, f"dropping peer with bad clientID "
                                 f"{msg.get('clientID')!r}")
            return None
        self._cid_to_broadcast[cid] = idx
        codec, wire_err = _parse_wire_request(msg)
        if wire_err is not None:
            self._reject_wire(cid, wire_err)
            return None
        self._wire_cid[cid] = codec
        # optional trace context: absent or malformed degrades to "no trace"
        tc = msg.get(obs_trace.TRACE_KEY)
        self._trace_cid[cid] = tc if obs_trace.valid_context(tc) else None
        return cid

    def _reject_wire(self, cid: int, err: str):
        """A client advertised a wire codec this server cannot speak:
        answer LOUDLY on the dedicated channel and evict."""
        conn = self.dedicated.get(cid)
        try:
            conn.set_timeout(self.handshake_timeout)
            conn.send_msg({"a": ENTER, "wire": {"error": err}})
        except (TimeoutError, ConnectionError, OSError):
            pass
        self._evict(cid, ProtocolError(err))

    def _enter_reply(self, cid: int):
        """The legacy plain string, or the dict form carrying the wire
        agreement for a client that advertised one."""
        codec = self._wire_cid.get(cid)
        if codec is None:
            return ENTER
        return {"a": ENTER, "wire": {"v": wire.WIRE_V, "codec": codec}}

    def sync_server(self, params: PyTree,
                    timeout: float | None = None) -> PyTree:
        """One full server-side sync round (ref ``syncServer``, lua
        :230-237): admit one client, send center, receive delta, apply it,
        and return a copy of the center shaped like ``params``.

        A client that fails mid-handshake (EOF, hang past
        ``handshake_timeout``, protocol desync, config skew) is evicted and
        the round retries with the next requester — the center never takes
        a partial delta.  ``timeout`` bounds the wait for ANY sync request
        (``None`` = wait forever, the reference's behavior); with every
        client gone ``recv_any`` raises ``RuntimeError``."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            slice_t = (None if deadline is None
                       else max(0.0, deadline - time.monotonic()))
            try:
                idx, msg = self.broadcast.recv_any(
                    timeout=slice_t, frame_timeout=self.handshake_timeout,
                    on_drop=self._evict_dropped)
            except TimeoutError:
                if deadline is not None and time.monotonic() >= deadline:
                    raise
                continue
            cid = self._admit(idx, msg)
            if cid is None:
                continue
            conn = self.dedicated[cid]
            t0 = time.perf_counter()
            codec = self._wire_cid.get(cid)
            try:
                with obs_trace.use_context(self._trace_cid.get(cid)), \
                        obs.span("async_ea.handshake", cid=cid):
                    conn.set_timeout(self.handshake_timeout)
                    conn.send_msg(self._enter_reply(cid))
                    print_server(f"current client is #{cid}")
                    # serverSendCenter (lua :180-196): ONE packed frame on a
                    # negotiated wire, per-leaf 'T' frames for legacy
                    _expect(conn, CENTER_Q)
                    conn.send_tensors(self._center_host(),
                                      codec=codec or "raw",
                                      packed=codec is not None)
                    # serverGetUpdateDiff (lua :198-228): receive the FULL
                    # delta, undecoded, before applying any of it; the
                    # deadline covers the whole stream (a trickling client
                    # cannot re-arm the socket timeout forever)
                    _expect(conn, DELTA_Q)
                    conn.send_msg(DELTA)
                    dl = (None if self.handshake_timeout is None
                          else time.monotonic() + self.handshake_timeout)
                    payload = conn.recv_payload(n=len(self.center),
                                                deadline=dl, out=self._rx)
                    self._check_delta(payload)
                    conn.set_timeout(None)
            except (TimeoutError, ConnectionError, ProtocolError, OSError,
                    ValueError) as e:   # ValueError: undecodable JSON frame
                self._evict(cid, e)
                continue
            if self._obs_on:
                self._h_handshake.observe(time.perf_counter() - t0)
            self._apply_delta(payload)
            print_server(f"received delta from client #{cid}")
            return _rebuild(params, [t.clone() for t in self.center])

    def test_net(self) -> bool:
        """Push the center to the tester (ref ``testNet``, lua :239-258).
        A dead/hung tester must not stall training: it is dropped (later
        calls return False)."""
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
            conn.send_tensors(self._center_host(), codec=codec or "raw",
                              packed=codec is not None)
            _expect(conn, ACK)
            conn.set_timeout(None)
            return True
        except (TimeoutError, ConnectionError, ProtocolError, OSError,
                ValueError) as e:
            print_server(f"dropping tester: {e!r}")
            conn.close()
            self.test_conn = None
            return False

    def close(self):
        if self._closed:
            return
        self._closed = True
        self.broadcast.close()
        for s in self.dedicated_servers.values():
            s.close()
        if self.test_server:
            self.test_server.close()


class AsyncEAClient:
    """Worker role (ref initClient/syncClient).

    ``codec`` selects the wire format for the sync handshake: ``"raw"``
    (default) coalesces each direction into one packed frame,
    ``"fp16"``/``"int8"`` additionally quantize (deltas carry client-side
    error-feedback residuals, 1-bit-SGD style); ``None`` speaks the legacy
    per-leaf wire.  Against an old server the client falls back to the
    legacy frames.  ``params`` are pytrees of tensors on the client's
    device.
    """

    def __init__(self, host: str, port: int, node: int, tau: int,
                 alpha: float, codec: str | None = "raw", device=None):
        if node < 1:
            raise ValueError("node is 1-based (reference convention)")
        if codec is not None and codec not in wire.CODECS:
            raise ValueError(f"unknown wire codec {codec!r} "
                             f"(supported: {', '.join(wire.CODECS)})")
        self.device = resolve_device(device)
        self.node = node
        self.tau = int(tau)
        self.alpha = float(alpha)
        self.codec = codec
        self.step = 0
        # clientBroadcast -> port; dedicated client -> port+node
        # (EASGD_client.lua:58-61)
        self.broadcast = connect(host, port)
        self.conn = connect(host, port + node)
        self.center: list[torch.Tensor] | None = None
        self._slab: _LeafSlab | None = None
        # None until the first handshake; False pins legacy once a plain-
        # string reply proves the server predates the packed wire
        self._packed: bool | None = None
        self._residuals: list[torch.Tensor] | None = None
        # reusable staging for the delta frame: device twin + host region
        self._frame = wire.FrameBuffer(pinned=self.device.type == "cuda")

    def _announce(self, q: str, want: str) -> bool:
        """Send an admission request (with the wire advertisement unless a
        previous reply proved the server legacy) and parse the reply.
        Returns True when this handshake uses the packed wire."""
        adv = self.codec is not None and self._packed is not False
        msg: dict[str, Any] = {"q": q, "clientID": self.node}
        if adv:
            msg["wire"] = {"v": wire.WIRE_V, "codec": self.codec}
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
        self._packed = _check_wire_reply(reply, want, self.codec)
        return self._packed

    def init_client(self, params: PyTree) -> PyTree:
        """Receive the initial center from the server's broadcast; params :=
        center on the client's device (ref lua :64-78).  The initial
        broadcast is per-leaf, but ``recv_tensors`` auto-detects either
        framing."""
        got = self.broadcast.recv_tensors(n=len(_leaves(params)))
        self._slab = _LeafSlab([(a.shape, a.dtype) for a in got],
                               self.device)
        for h, a in zip(self._slab.host_leaves, got):
            h[...] = a
        self.center = self._slab.to_device()
        return _rebuild(params, [c.clone() for c in self.center])

    def sync_client(self, params: PyTree) -> tuple[PyTree, bool]:
        """Every ``tau``-th call: full sync handshake (ref ``syncClient``,
        lua :134-146).  Returns ``(new_params, synced)``."""
        self.step += 1
        if self.step % self.tau != 0:       # isSyncNeeded (lua :47-57)
            return params, False
        if not obs_trace.propagate_enabled():
            return self._sync_once(params)
        with obs_trace.use_context(obs_trace.new_trace()), \
                obs.span("async_ea.sync", cid=self.node):
            return self._sync_once(params)

    def _sync_once(self, params: PyTree) -> tuple[PyTree, bool]:
        # clientEnterSync (lua :82-92)
        print_client(self.node, "waiting to sync")
        packed = self._announce(ENTER_Q, ENTER)
        # clientGetCenter (lua :95-106): into the host twin, then one copy
        # to the device center
        with obs.span("async_ea.fetch_center", shard=0):
            self.conn.send_msg(CENTER_Q)
            self.conn.recv_tensors(out=self._slab.host_leaves)
            self._slab.to_device()
        # calculateUpdateDiff (lua :109-119): the elastic move on the
        # device.  Deltas go over the wire in the CENTER's dtype (the
        # server rejects dtype skew), so a client whose params drifted
        # wider still interoperates.
        with obs.span("async_ea.delta"):
            leaves = _leaves(params)
            deltas = []
            for p, c in zip(leaves, self.center):
                d = (p - c).to(c.dtype)
                d.mul_(cast_scalar(self.alpha, d.dtype))
                deltas.append(d)
            new_leaves = [p - d for p, d in zip(leaves, deltas)]
            _sync(self.device)
        payload = None
        if packed:
            with obs.span("async_ea.encode"):
                if self.codec != "raw":
                    if self._residuals is None:
                        self._residuals = [torch.zeros_like(d)
                                           for d in deltas]
                    # error feedback (Seide et al. 2014): quantize delta +
                    # carried residual, keep the new quantization error
                    for d, r in zip(deltas, self._residuals):
                        d += r
                payload = wire_kernels.encode_ef_into(
                    deltas, self._residuals if self.codec != "raw" else None,
                    self.codec, out=self._frame)
        # clientSendDiff (lua :122-132)
        with obs.span("async_ea.push_delta", shard=0):
            self.conn.send_msg(DELTA_Q)
            _expect(self.conn, DELTA)
            if payload is not None:
                self.conn.send_packed(payload)
            else:
                for d in deltas:
                    self.conn.send_tensor(d.cpu().numpy())
        print_client(self.node, "synced")
        return _rebuild(params, new_leaves), True

    def close(self):
        self.broadcast.close()
        self.conn.close()


class AsyncEATester:
    """Evaluation role (ref initTester/startTest/finishTest).

    ``codec`` opts into the packed wire for center fetches (the
    advertisement rides the tester's own ``Center?``, so leave it ``None``
    against an old server)."""

    def __init__(self, host: str, port: int, num_nodes: int,
                 codec: str | None = None, device=None):
        if codec is not None and codec not in wire.CODECS:
            raise ValueError(f"unknown wire codec {codec!r} "
                             f"(supported: {', '.join(wire.CODECS)})")
        self.device = resolve_device(device)
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
        return _rebuild(params, [torch.from_numpy(a).to(self.device)
                                 for a in got])

    def finish_test(self):
        """Ack the round so the server resumes (ref lua :287-292)."""
        self.conn.send_msg(ACK)

    def close(self):
        self.conn.close()
