"""Host-side TCP transport — a copy of ``distlearn_tpu/comm/transport.py``,
the torch-ipc socket layer rebuilt
(reference consumers: ipc.server/client/recvAny — lua/AsyncEA.lua:87-220,
examples/EASGD_server.lua:67-77).

Wire protocol (shared with the native C++ backend in src/comm/distcomm.cpp):

    frame   := kind:u8 | length:u64le | payload[length]
    kind 'J': payload is UTF-8 JSON (control messages)
    kind 'T': payload is hlen:u32le | header[hlen] | raw tensor bytes,
              header = JSON {"dtype": str, "shape": [int...]}
    kind 'P': payload is hlen:u32le | manifest[hlen] | packed leaf bytes —
              a whole tensor LIST in one frame (manifest schema and the
              raw/fp16/int8 leaf codecs: distlearn_tpu_torch.comm.wire)
    kind 'G': payload is UTF-8 JSON — a GENERATE request (prompt in):
              {"id", "prompt": [ints], "max_new", ...} (docs/SERVING.md)
    kind 'R': payload is UTF-8 JSON — one token-stream RESPONSE chunk
              (tokens out): {"id", "tokens": [ints], "done", ...}

JSON frames ('J' admission announces, 'G' requests) MAY carry an
optional "tc" field — the cross-process trace context {"t": trace-id
hex, "s": parent span-id hex, "f": 0|1} (obs/trace.py, docs/
OBSERVABILITY.md).  The field only appears when DISTLEARN_TRACE_PROP is
on; absent, frames are bitwise identical to pre-trace peers', and a
receiver treats a malformed value as "no trace" — never an error.

Connection management (listen/accept/connect/poll) stays in Python; the
byte-moving hot path (frame assembly, big-buffer send/recv loops) dispatches
to the native library when built (distlearn_tpu_torch.comm.native), falling back to
pure-Python socket IO.  ``recv_tensor(out=...)`` reuses a preallocated buffer
— the reference's ``client:recv(buffer)`` semantics (lua/AsyncEA.lua:100-103).
"""

from __future__ import annotations

import errno
import itertools
import json
import math
import random
import select
import socket
import struct
import time
from typing import Any

import numpy as np

from distlearn_tpu_torch import obs
from distlearn_tpu_torch.comm import native, wire
from distlearn_tpu_torch.comm.errors import PeerClosed

_HDR = struct.Struct("<BQ")   # kind, payload length
_THDR = struct.Struct("<I")   # tensor header length

# sendmsg iovec fan-in cap, kept well under every Linux IOV_MAX (1024);
# longer buffer lists loop.
_IOV_MAX = 512

_CONN_IDS = itertools.count()

#: recv_serve_nowait frame-size cap — serve payloads are small JSON, so
#: anything bigger is a desynced or hostile peer.
SERVE_MAX_FRAME = 1 << 20


def _drops():
    return obs.counter("transport_drops_total",
                       "connections dropped by recv_any, by cause",
                       labels=("reason",))


def _timeouts():
    return obs.counter("transport_timeouts_total",
                       "transport operations that hit a timeout/deadline",
                       labels=("op",))


def _wire_frames():
    return obs.counter("wire_packed_frames_total",
                       "packed 'P' tensor-list frames sent, by codec",
                       labels=("codec",))


def _wire_bytes():
    return obs.counter("wire_packed_bytes_total",
                       "wire bytes of packed frames sent "
                       "(frame header + manifest + data), by codec",
                       labels=("codec",))


def _wire_logical():
    return obs.counter("wire_logical_bytes_total",
                       "pre-encoding logical tensor bytes shipped in "
                       "packed frames, by codec",
                       labels=("codec",))


def _wire_ratio():
    return obs.gauge("wire_compression_ratio",
                     "logical/wire byte ratio of the most recent packed "
                     "frame, by codec",
                     labels=("codec",))


def _wire_pack_secs():
    return obs.histogram("wire_pack_seconds",
                         "time to encode one packed frame "
                         "(manifest build + quantization)")


def _wire_zero_copy():
    return obs.counter("wire_zero_copy_total",
                       "packed-frame sends by staging outcome: hit = one "
                       "contiguous frame-buffer iovec (fused kernels wrote "
                       "wire bytes in place), miss = per-leaf gather",
                       labels=("result",))


class Conn:
    """A framed connection over one TCP socket.

    ``bytes_sent`` / ``bytes_received`` count payload bytes (frames +
    tensors) — the per-link traffic evidence behind the tree-vs-ring
    bandwidth analysis (docs/PERF.md).  ``throttle_bps`` (None = off)
    paces SENDS to that many bytes/second: localhost benches use it to
    emulate bandwidth-limited NIC links on a host whose loopback is
    CPU-bound (the regime the ring allreduce is designed for), by
    sleeping out the remainder of each send's wire-time budget."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._fd = sock.fileno()
        self.bytes_sent = 0
        self.bytes_received = 0
        self.throttle_bps: float | None = None
        # Force the pure-Python socket path for this conn even when the
        # native backend is built.  The native loops do IO on the raw fd,
        # which bypasses any proxy installed over ``self.sock`` — the
        # fault-injection layer (comm/faults.py) flips this so its socket
        # wrapper actually sees every byte.
        self.force_py_io = False
        self._rx = bytearray()        # recv_serve_nowait partial-frame buffer
        self._rx_eof = False
        # Telemetry handles resolve once per connection (obs.NULL when the
        # kill switch is off, so the hot path stays a no-op method call).
        # Counters mirror bytes_sent/bytes_received exactly: both are
        # updated by the single thread that does IO on this Conn.
        self.conn_id = str(next(_CONN_IDS))
        self._obs = obs.enabled()
        per_conn = {"labels": ("conn",), "max_children": 256}
        self._m_sent = obs.counter(
            "transport_bytes_sent_total",
            "wire bytes sent per connection (frames + tensor payloads)",
            **per_conn).labels(conn=self.conn_id)
        self._m_recv = obs.counter(
            "transport_bytes_received_total",
            "wire bytes received per connection",
            **per_conn).labels(conn=self.conn_id)
        lat = obs.histogram(
            "transport_frame_recv_seconds",
            "whole-frame receive latency (header to last payload byte)",
            labels=("kind",))
        self._h_ctrl = lat.labels(kind="control")
        self._h_tensor = lat.labels(kind="tensor")
        self._h_serve = lat.labels(kind="serve")

    def _pace(self, nbytes: int, t0: float):
        if self.throttle_bps:
            budget = nbytes / self.throttle_bps
            left = budget - (time.perf_counter() - t0)
            if left > 0:
                time.sleep(left)

    def set_timeout(self, seconds: float | None):
        """Kernel-level send/recv timeout (SO_RCVTIMEO/SO_SNDTIMEO) so that a
        dead or hung peer turns a blocking IO into :class:`TimeoutError`
        instead of a wedge.  Set at the fd level (not ``settimeout``) so the
        native C++ recv/send loops honor it too.  ``None`` disables."""
        if seconds is None:
            tv = struct.pack("ll", 0, 0)
        else:
            if seconds <= 0:
                raise ValueError("timeout must be positive or None")
            tv = struct.pack("ll", int(seconds),
                             int((seconds - int(seconds)) * 1e6))
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO, tv)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, tv)

    # -- low-level framing --------------------------------------------------
    def _sendv(self, bufs: list):
        """Vectored full-send of a buffer list via ``sendmsg`` — the frame
        header and payload(s) leave in ONE syscall (and, with TCP_NODELAY,
        one packet when they fit): two back-to-back ``send()`` calls ship
        the 9-byte header as its own packet per control message.  Handles
        partial sends by slicing the straddled view and continuing."""
        vs = []
        for b in bufs:
            v = b if isinstance(b, memoryview) else memoryview(b)
            if v.format != "B" or v.ndim != 1:
                v = v.cast("B")
            if v.nbytes:
                vs.append(v)
        i = 0
        while i < len(vs):
            sent = self.sock.sendmsg(vs[i:i + _IOV_MAX])
            while i < len(vs) and sent >= vs[i].nbytes:
                sent -= vs[i].nbytes
                i += 1
            if sent:
                vs[i] = vs[i][sent:]

    def _send_frame(self, kind: int, payload: bytes | memoryview):
        t0 = time.perf_counter()
        try:
            if native.available() and not self.force_py_io:
                native.send_frame(self._fd, kind, payload)
            else:
                self._sendv([_HDR.pack(kind, len(payload)), payload])
        except (BlockingIOError, InterruptedError) as e:
            _timeouts().labels(op="send").inc()
            raise TimeoutError("send timed out (socket timeout)") from e
        self.bytes_sent += _HDR.size + len(payload)
        self._m_sent.inc(_HDR.size + len(payload))
        self._pace(_HDR.size + len(payload), t0)

    def _recv_exact(self, n: int, out: memoryview | None = None,
                    mid_frame: bool = False,
                    deadline: float | None = None) -> memoryview:
        """Read exactly ``n`` bytes.  A peer FIN raises
        :class:`PeerClosed` ONLY when it lands
        before any byte of a fresh frame (a finished peer); a FIN after
        partial progress — or anywhere once ``mid_frame`` marks this read
        as continuing an already-started frame — raises
        :class:`ConnectionResetError`, so drop-policy code can tell a
        torn frame from a clean goodbye.

        ``deadline`` (``time.monotonic()`` value) bounds the WHOLE read:
        a kernel SO_RCVTIMEO re-arms on every successful ``recv``, so a
        peer trickling one byte per timeout-epsilon never trips it — the
        wedge class the frame deadline exists to kill.  Deadline reads
        take the Python loop (bypassing the native batch recv; they are
        used for small control frames where throughput is irrelevant)."""
        buf = out if out is not None else memoryview(bytearray(n))
        if deadline is not None:
            prev = self.sock.gettimeout()
            got = 0
            try:
                while got < n:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        _timeouts().labels(op="recv_deadline").inc()
                        raise TimeoutError(
                            "recv deadline exceeded (peer trickling or "
                            "stalled mid-frame)")
                    self.sock.settimeout(remaining)
                    try:
                        r = self.sock.recv_into(buf[got:], n - got)
                    except (socket.timeout, BlockingIOError) as e:
                        _timeouts().labels(op="recv_deadline").inc()
                        raise TimeoutError(
                            "recv deadline exceeded (peer trickling or "
                            "stalled mid-frame)") from e
                    if r == 0:
                        if got or mid_frame:
                            raise ConnectionResetError(
                                "peer closed connection mid-frame")
                        raise PeerClosed("peer closed connection")
                    got += r
            finally:
                try:
                    self.sock.settimeout(prev)
                except OSError:
                    pass
            self.bytes_received += n
            self._m_recv.inc(n)
            return buf
        try:
            if native.available() and not self.force_py_io:
                try:
                    native.recv_exact(self._fd, buf, n)
                except PeerClosed as e:
                    if mid_frame:
                        raise ConnectionResetError(
                            "peer closed connection mid-frame") from e
                    raise
                self.bytes_received += n
                self._m_recv.inc(n)
                return buf
            got = 0
            while got < n:
                r = self.sock.recv_into(buf[got:], n - got)
                if r == 0:
                    if got or mid_frame:
                        raise ConnectionResetError(
                            "peer closed connection mid-frame")
                    raise PeerClosed("peer closed connection")
                got += r
        except BlockingIOError as e:   # SO_RCVTIMEO expired -> EAGAIN
            _timeouts().labels(op="recv").inc()
            raise TimeoutError("recv timed out (socket timeout)") from e
        self.bytes_received += n
        self._m_recv.inc(n)
        return buf

    def _recv_frame_header(self, deadline: float | None = None
                           ) -> tuple[int, int]:
        hdr = bytes(self._recv_exact(_HDR.size, deadline=deadline))
        return _HDR.unpack(hdr)

    # -- control messages ---------------------------------------------------
    def send_msg(self, msg: Any):
        """Send a JSON-serializable control message (ref ``client:send({q=...})``)."""
        self._send_frame(ord("J"), json.dumps(msg).encode())

    def recv_msg(self, deadline: float | None = None) -> Any:
        t0 = time.perf_counter() if self._obs else 0.0
        kind, length = self._recv_frame_header(deadline)
        payload = bytes(self._recv_exact(length, mid_frame=True,
                                         deadline=deadline))
        if kind != ord("J"):
            raise ProtocolError(f"expected control message, got kind {chr(kind)!r}")
        if self._obs:
            self._h_ctrl.observe(time.perf_counter() - t0)
        return json.loads(payload)

    # -- serving frames (kinds 'G'/'R', distlearn_tpu_torch.serve) ----------------
    def send_gen(self, msg: Any):
        """Send one generate REQUEST (kind ``'G'``): prompt in.  Payload
        is JSON like a ``'J'`` frame; the distinct kind lets a serving
        endpoint reject control traffic (and vice versa) without parsing
        — a training client dialing a serve port desyncs loudly."""
        self._send_frame(ord("G"), json.dumps(msg).encode())

    def send_stream(self, msg: Any):
        """Send one token-stream RESPONSE chunk (kind ``'R'``): tokens
        out.  One frame per tick keeps time-to-first-token at one
        decode tick, not one full generation."""
        self._send_frame(ord("R"), json.dumps(msg).encode())

    def recv_serve(self, deadline: float | None = None) -> tuple[str, Any]:
        """Receive one serving-protocol frame: returns ``(kind, msg)``
        with ``kind`` in ``'G'``/``'R'``/``'J'`` (``'J'`` stays legal so
        control pings — health probes, drain notices — share the
        connection).  Tensor frames raise :class:`ProtocolError`."""
        t0 = time.perf_counter() if self._obs else 0.0
        kind, length = self._recv_frame_header(deadline)
        payload = bytes(self._recv_exact(length, mid_frame=True,
                                         deadline=deadline))
        if kind not in (ord("G"), ord("R"), ord("J")):
            raise ProtocolError(
                f"expected serve frame (G/R/J), got kind {chr(kind)!r}")
        if self._obs:
            self._h_serve.observe(time.perf_counter() - t0)
        return chr(kind), json.loads(payload)

    def rx_pending(self) -> int:
        """Bytes of a partial serve frame buffered by
        :meth:`recv_serve_nowait` — nonzero means the peer has a frame in
        flight, so a server loop can time out tricklers without ever
        blocking on them."""
        return len(self._rx)

    def recv_serve_nowait(self) -> list[tuple[str, Any]]:
        """Drain whatever bytes the socket holds RIGHT NOW — never
        blocking — reassemble them, and return every COMPLETE serve
        frame as ``(kind, msg)`` pairs (possibly none).  A partial frame
        stays buffered on the connection until the peer's next bytes
        arrive.

        The single-threaded-server counterpart of :meth:`recv_serve`:
        select only proves SOME bytes are readable, and a blocking
        whole-frame read there lets one half-sent frame stall every
        other in-flight request (head-of-line blocking).  Raises
        :class:`PeerClosed` on EOF at a frame boundary,
        :class:`ConnectionResetError` on EOF mid-frame, and
        :class:`ProtocolError` on a non-serve kind or a frame larger
        than :data:`SERVE_MAX_FRAME` (buffering an attacker-announced
        length would hand the peer a memory lever)."""
        got = 0
        self.sock.setblocking(False)
        try:
            while True:
                try:
                    chunk = self.sock.recv(1 << 16)
                except (BlockingIOError, InterruptedError):
                    break
                if not chunk:
                    self._rx_eof = True
                    break
                self._rx += chunk
                got += len(chunk)
        finally:
            try:
                self.sock.setblocking(True)
            except OSError:
                pass
        if got:
            self.bytes_received += got
            self._m_recv.inc(got)
        frames: list[tuple[str, Any]] = []
        while len(self._rx) >= _HDR.size:
            kind, length = _HDR.unpack_from(self._rx)
            if kind not in (ord("G"), ord("R"), ord("J")):
                raise ProtocolError(
                    f"expected serve frame (G/R/J), got kind {chr(kind)!r}")
            if length > SERVE_MAX_FRAME:
                raise ProtocolError(f"serve frame too large: {length} bytes")
            if len(self._rx) < _HDR.size + length:
                break
            payload = bytes(self._rx[_HDR.size:_HDR.size + length])
            del self._rx[:_HDR.size + length]
            frames.append((chr(kind), json.loads(payload)))
        if self._rx_eof and not frames:
            if self._rx:
                raise ConnectionResetError("peer closed connection mid-frame")
            raise PeerClosed("peer closed connection")
        return frames

    # -- tensors ------------------------------------------------------------
    def send_tensor(self, arr: np.ndarray):
        # copy ONLY when the buffer is not already contiguous — an
        # unconditional ascontiguousarray would still be cheap, but this
        # makes the zero-copy contract explicit for the 100 MB-leaf syncs
        if not (isinstance(arr, np.ndarray) and arr.flags.c_contiguous):
            arr = np.ascontiguousarray(arr)
        header = json.dumps({"dtype": arr.dtype.name,
                             "shape": list(arr.shape)}).encode()
        meta = _THDR.pack(len(header)) + header
        nbytes = _HDR.size + len(meta) + arr.nbytes
        t0 = time.perf_counter()
        try:
            if native.available() and not self.force_py_io:
                # zero-copy: numpy buffer goes straight into the writev
                native.send_tensor_frame(self._fd, ord("T"), meta, arr)
                self.bytes_sent += nbytes
                self._m_sent.inc(nbytes)
                self._pace(nbytes, t0)
                return
            self._sendv([_HDR.pack(ord("T"), len(meta) + arr.nbytes),
                         meta, memoryview(arr).cast("B")])
        except (BlockingIOError, InterruptedError) as e:
            _timeouts().labels(op="send").inc()
            raise TimeoutError("send timed out (socket timeout)") from e
        self.bytes_sent += nbytes
        self._m_sent.inc(nbytes)
        self._pace(nbytes, t0)

    def recv_tensor(self, out: np.ndarray | None = None,
                    deadline: float | None = None) -> np.ndarray:
        """Receive one tensor frame.  ``deadline`` (``time.monotonic()``
        value) bounds the WHOLE frame read, exactly like ``recv_msg`` —
        a handshake peer that sends the tensor header and then trickles
        payload bytes must trip :class:`TimeoutError`, not re-arm the
        kernel timeout forever (the same wedge class the control-frame
        deadline closes)."""
        t0 = time.perf_counter() if self._obs else 0.0
        kind, length = self._recv_frame_header(deadline)
        if kind != ord("T"):
            raise ProtocolError(f"expected tensor, got kind {chr(kind)!r}")
        return self._recv_tensor_body(length, out, deadline, t0)

    def _recv_tensor_body(self, length: int, out: np.ndarray | None,
                          deadline: float | None, t0: float) -> np.ndarray:
        """Body of one ``'T'`` frame whose header was already consumed
        (shared by :meth:`recv_tensor` and the legacy per-leaf branch of
        :meth:`recv_tensors`)."""
        if length < _THDR.size:
            raise ProtocolError(f"tensor frame too short: {length} bytes")
        hlen = _THDR.unpack(bytes(self._recv_exact(
            _THDR.size, mid_frame=True, deadline=deadline)))[0]
        if _THDR.size + hlen > length:
            raise ProtocolError(
                f"tensor header length {hlen} exceeds frame length {length}")
        raw = bytes(self._recv_exact(hlen, mid_frame=True,
                                     deadline=deadline))
        nbytes = length - _THDR.size - hlen
        try:
            header = json.loads(raw)
            dtype = np.dtype(header["dtype"])
            shape = tuple(int(s) for s in header["shape"])
        except (ValueError, KeyError, TypeError) as e:
            raise ProtocolError(f"bad tensor header: {e}") from None
        if any(s < 0 for s in shape):
            raise ProtocolError(f"negative dimension in shape {shape}")
        # Python-int product: immune to C-long overflow/wraparound from a
        # hostile header; the nbytes equality below then rejects it.
        expect = math.prod(shape) * dtype.itemsize
        if nbytes != expect:
            # A desynced/corrupt peer must produce a protocol error, never an
            # under/overrun of the receive buffer (ADVICE r1: the native
            # recv path writes nbytes raw bytes into the target buffer).
            raise ProtocolError(
                f"tensor payload {nbytes} bytes != {expect} expected for "
                f"{dtype}{shape}")
        if out is not None:
            if out.dtype != dtype or out.shape != shape:
                # Drain the announced payload BEFORE raising: leaving nbytes
                # unread would desync the stream, and the next recv on this
                # connection would parse tensor data as a frame header.
                self._recv_exact(nbytes, mid_frame=True, deadline=deadline)
                raise ProtocolError(
                    f"recv buffer mismatch: caller expects "
                    f"{out.dtype}{out.shape} but the wire header announces "
                    f"{dtype}{shape} — sender and receiver disagree on the "
                    "tensor schedule (rank model/config skew)")
            if not (out.flags.c_contiguous and out.flags.writeable):
                tmp = np.empty(shape, dtype)
                self._recv_exact(nbytes, memoryview(tmp).cast("B"),
                                 mid_frame=True, deadline=deadline)
                out[...] = tmp
                if self._obs:
                    self._h_tensor.observe(time.perf_counter() - t0)
                return out
            self._recv_exact(nbytes, memoryview(out).cast("B"),
                             mid_frame=True, deadline=deadline)
            if self._obs:
                self._h_tensor.observe(time.perf_counter() - t0)
            return out
        arr = np.empty(shape, dtype)
        if nbytes:
            self._recv_exact(nbytes, memoryview(arr).cast("B"),
                             mid_frame=True, deadline=deadline)
        if self._obs:
            self._h_tensor.observe(time.perf_counter() - t0)
        return arr

    # -- packed tensor lists (kind 'P', distlearn_tpu.comm.wire) ------------
    def send_tensors(self, leaves, codec: str = "raw", packed: bool = True):
        """Ship a whole tensor list.  ``packed=True`` coalesces it into ONE
        ``'P'`` frame (O(1) frames per sync); ``packed=False`` degrades to
        the legacy per-leaf ``'T'`` frames for peers that never advertised
        packed support (quantized codecs require the packed frame — the
        ``'T'`` header has nowhere to carry a scale)."""
        if not packed:
            if codec not in (None, "raw"):
                raise ValueError(
                    f"codec {codec!r} requires the packed frame; legacy "
                    "per-leaf frames are raw-only")
            for a in leaves:
                self.send_tensor(a)
            return
        if not len(leaves):
            return    # zero leaves = zero frames, matching the legacy path
        t0 = time.perf_counter() if self._obs else 0.0
        payload = wire.encode_leaves(leaves, codec)
        if self._obs:
            _wire_pack_secs().observe(time.perf_counter() - t0)
        self.send_packed(payload)

    def send_packed(self, payload: "wire.PackedPayload"):
        """Send one pre-encoded packed frame (see ``wire.encode_leaves``;
        the AsyncEA client pre-encodes so the error-feedback residual can
        be computed before the frame leaves).  Pacing budgets the WHOLE
        frame, not per leaf — under ``throttle_bps`` a packed sync sleeps
        out the same wire-time a per-leaf sync would."""
        manifest = json.dumps(payload.manifest).encode()
        meta = _THDR.pack(len(manifest)) + manifest
        total = len(meta) + payload.wire_nbytes
        t0 = time.perf_counter()
        try:
            if payload.frame is not None:
                # frame-buffer staging (wire.FrameBuffer): the fused
                # codec kernels already wrote every wire byte into ONE
                # contiguous region — ship it as a single iovec
                data = [memoryview(payload.frame).cast("B")]
            else:
                # one vectored send: frame header + manifest + every leaf
                # buffer (raw leaves are zero-copy views of the caller's
                # arrays; no staging copy of the data region is built)
                data = [memoryview(b).cast("B")
                        for b in payload.bufs if b.nbytes]
            self._sendv([_HDR.pack(ord("P"), total), meta] + data)
        except (BlockingIOError, InterruptedError) as e:
            _timeouts().labels(op="send").inc()
            raise TimeoutError("send timed out (socket timeout)") from e
        nbytes = _HDR.size + total
        self.bytes_sent += nbytes
        self._m_sent.inc(nbytes)
        if self._obs:
            _wire_frames().labels(codec=payload.codec).inc()
            _wire_bytes().labels(codec=payload.codec).inc(nbytes)
            _wire_logical().labels(codec=payload.codec).inc(
                payload.logical_nbytes)
            _wire_ratio().labels(codec=payload.codec).set(
                payload.logical_nbytes / nbytes if nbytes else 0.0)
            _wire_zero_copy().labels(
                result="hit" if payload.frame is not None else "miss").inc()
        self._pace(nbytes, t0)

    def recv_tensors(self, out: list | None = None, n: int | None = None,
                     deadline: float | None = None) -> list[np.ndarray]:
        """Receive a tensor list: ONE packed ``'P'`` frame or ``n`` legacy
        per-leaf ``'T'`` frames — auto-detected from the first frame
        header, so a receiver negotiated down to the legacy wire needs no
        separate code path.  ``out`` reuses preallocated buffers (logical
        dtype — quantized leaves are decoded into it); ``n`` is required
        when ``out`` is None.  ``deadline`` bounds the WHOLE list read."""
        if out is not None:
            want = len(out)
        elif n is not None:
            want = int(n)
        else:
            raise ValueError("recv_tensors needs out= buffers or n=")
        if want == 0:
            return []
        t0 = time.perf_counter() if self._obs else 0.0
        kind, length = self._recv_frame_header(deadline)
        if kind == ord("T"):
            # legacy peer: first frame header is already consumed
            res = [self._recv_tensor_body(
                length, None if out is None else out[0], deadline, t0)]
            for i in range(1, want):
                res.append(self.recv_tensor(
                    out=None if out is None else out[i], deadline=deadline))
            return res
        if kind != ord("P"):
            raise ProtocolError(
                f"expected tensor list, got kind {chr(kind)!r}")
        return self._recv_packed_body(length, out, want, deadline, t0)

    def recv_payload(self, n: int, deadline: float | None = None,
                     out: "wire.FrameBuffer | None" = None
                     ) -> "wire.PackedPayload":
        """Receive a tensor list WITHOUT decoding — wire-dtype buffers plus
        the manifest, as a :class:`wire.PackedPayload`.  The fused-apply
        path (``ops/wire_kernels.dequant_add_leaves_cuda``) consumes
        quantized bytes directly, so decoding here would materialize the
        f32 copy the fused kernels exist to avoid.  Legacy per-leaf ``'T'`` frames are
        wrapped as a raw payload, so callers need no separate path.

        ``out`` (packed frames only) receives the whole data region into
        one reusable staging buffer: the leaves are views of it and
        ``payload.frame`` is set, so the caller can move the frame to the
        device in one copy.  The views are valid until ``out`` is used
        again."""
        want = int(n)
        if want == 0:
            return wire.PackedPayload(
                {"v": wire.WIRE_V, "codec": "raw", "leaves": []},
                [], "raw", 0, 0)
        t0 = time.perf_counter() if self._obs else 0.0
        kind, length = self._recv_frame_header(deadline)
        if kind == ord("T"):
            arrs = [self._recv_tensor_body(length, None, deadline, t0)]
            for _ in range(1, want):
                arrs.append(self.recv_tensor(deadline=deadline))
            entries, offset = [], 0
            for a in arrs:
                entries.append({"dtype": a.dtype.name,
                                "shape": list(a.shape), "enc": "raw",
                                "offset": offset, "nbytes": a.nbytes})
                offset += a.nbytes
            return wire.PackedPayload(
                {"v": wire.WIRE_V, "codec": "raw", "leaves": entries},
                arrs, "raw", offset, offset)
        if kind != ord("P"):
            raise ProtocolError(
                f"expected tensor list, got kind {chr(kind)!r}")
        return self._recv_packed_body(length, None, want, deadline, t0,
                                      decode=False, stage=out)

    def _recv_packed_body(self, length: int, out: list | None, want: int,
                          deadline: float | None, t0: float,
                          decode: bool = True,
                          stage: "wire.FrameBuffer | None" = None):
        if length < _THDR.size:
            self._recv_exact(length, mid_frame=True, deadline=deadline)
            raise ProtocolError(f"packed frame too short: {length} bytes")
        hlen = _THDR.unpack(bytes(self._recv_exact(
            _THDR.size, mid_frame=True, deadline=deadline)))[0]
        if _THDR.size + hlen > length:
            raise ProtocolError(
                f"packed manifest length {hlen} exceeds frame length "
                f"{length}")
        raw = bytes(self._recv_exact(hlen, mid_frame=True,
                                     deadline=deadline))
        data_nbytes = length - _THDR.size - hlen

        def _drain_and_fail(msg):
            # leaving the data region unread would desync the stream — the
            # next recv would parse tensor bytes as a frame header
            self._recv_exact(data_nbytes, mid_frame=True, deadline=deadline)
            raise ProtocolError(msg)

        try:
            codec, entries = wire.parse_manifest(raw, data_nbytes,
                                                 expect_n=want)
        except ValueError as e:
            _drain_and_fail(str(e))
        if not decode:
            # read each leaf's WIRE bytes verbatim (no dequantization) —
            # the caller applies straight from the quantized buffers
            bufs, logical = [], 0
            if stage is not None:
                stage.reserve(data_nbytes)
            for entry in entries:
                if stage is not None:
                    wbuf = stage.view(entry["offset"], entry["nbytes"],
                                      wire.wire_dtype(entry),
                                      tuple(entry["shape"]))
                else:
                    wbuf = np.empty(tuple(entry["shape"]),
                                    wire.wire_dtype(entry))
                if entry["nbytes"]:
                    self._recv_exact(entry["nbytes"],
                                     memoryview(wbuf).cast("B"),
                                     mid_frame=True, deadline=deadline)
                bufs.append(wbuf)
                logical += (math.prod(entry["shape"])
                            * np.dtype(entry["dtype"]).itemsize)
            if self._obs:
                self._h_tensor.observe(time.perf_counter() - t0)
            return wire.PackedPayload(
                {"v": wire.WIRE_V, "codec": codec, "leaves": entries},
                bufs, codec, data_nbytes, logical,
                frame=None if stage is None else stage.frame(data_nbytes))
        if out is not None:
            for i, (entry, o) in enumerate(zip(entries, out)):
                if (o.dtype != np.dtype(entry["dtype"])
                        or tuple(o.shape) != tuple(entry["shape"])):
                    _drain_and_fail(
                        f"recv buffer mismatch at leaf {i}: caller expects "
                        f"{o.dtype}{tuple(o.shape)} but the manifest "
                        f"announces {entry['dtype']}{tuple(entry['shape'])}"
                        " — sender and receiver disagree on the tensor "
                        "schedule (rank model/config skew)")
        res = []
        for i, entry in enumerate(entries):
            dtype = np.dtype(entry["dtype"])
            shape = tuple(entry["shape"])
            nbytes = entry["nbytes"]
            o = out[i] if out is not None else None
            if entry["enc"] == "raw":
                target = o if (o is not None and o.flags.c_contiguous
                               and o.flags.writeable) \
                    else np.empty(shape, dtype)
                if nbytes:
                    self._recv_exact(nbytes, memoryview(target).cast("B"),
                                     mid_frame=True, deadline=deadline)
                if o is not None and target is not o:
                    o[...] = target
                    target = o
            else:
                wbuf = np.empty(shape, wire.wire_dtype(entry))
                if nbytes:
                    self._recv_exact(nbytes, memoryview(wbuf).cast("B"),
                                     mid_frame=True, deadline=deadline)
                target = o if (o is not None and o.flags.writeable) \
                    else np.empty(shape, dtype)
                wire.decode_into(entry, wbuf, target)
            res.append(target)
        if self._obs:
            self._h_tensor.observe(time.perf_counter() - t0)
        return res

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class ProtocolError(RuntimeError):
    pass


class Server:
    """Listening endpoint (ref ``ipc.server(host, port)``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(128)
        self.host, self.port = self.sock.getsockname()
        self.conns: list[Conn] = []

    def accept(self, n: int = 1, timeout: float | None = None) -> list[Conn]:
        """Accept ``n`` connections (ref ``server:clients(n, fn)`` accept side)."""
        new = []
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            for _ in range(n):
                if deadline is not None:
                    self.sock.settimeout(max(0.0, deadline - time.monotonic()))
                try:
                    c, _ = self.sock.accept()
                except (socket.timeout, BlockingIOError):
                    # settimeout(0.0) = non-blocking -> BlockingIOError
                    _timeouts().labels(op="accept").inc()
                    raise TimeoutError(
                        f"accept timed out after {len(new)} of {n} "
                        "connections") from None
                conn = Conn(c)
                self.conns.append(conn)
                new.append(conn)
        finally:
            self.sock.settimeout(None)
        return new

    def prune_closed(self) -> dict[int, int]:
        """Drop closed conns from the registry (``accept`` only appends,
        so a server whose peers come and go — e.g. rejoin dials — grows
        without bound otherwise).  Returns ``{old_index: new_index}`` for
        the survivors so callers can remap any stored indices."""
        mapping: dict[int, int] = {}
        new: list[Conn] = []
        for i, c in enumerate(self.conns):
            if c.sock.fileno() >= 0:
                mapping[i] = len(new)
                new.append(c)
        self.conns = new
        return mapping

    def recv_any(self, timeout: float | None = None,
                 frame_timeout: float | None = None,
                 on_drop=None) -> tuple[int, Any]:
        """Wait for a control message from ANY accepted connection — the
        server's select-like wait (ref ``serverBroadcast:recvAny()``,
        lua/AsyncEA.lua:168).  Returns ``(conn_index, msg)``.

        Peers that have closed (EOF) are dropped and the wait continues with
        the remaining connections — a client finishing its epochs must not
        wedge the server while other clients still sync.

        ``frame_timeout`` bounds the read of the SELECTED frame: select
        only proves one byte is pending, and ``recv_msg`` blocks until the
        frame is complete — a peer that sends half a header and stalls
        would otherwise wedge the whole wait (VERDICT r4 weak #4).  A peer
        that trips it is dropped like any other desynced peer and the wait
        resumes; the select-level ``timeout`` still raises
        :class:`TimeoutError` as before.  ``on_drop(conn_index, exc)`` is
        called after any ABNORMAL drop — frame timeout, connection reset,
        protocol desync — so the caller can record WHICH peer was cut
        (e.g. evict it so it may later rejoin); a clean EOF (the peer
        finished and closed) stays silent, as before.  After ``on_drop``
        fires, :class:`TimeoutError` is raised instead of resuming the
        wait, handing control back to the caller's loop — the caller's
        view of the peer set just changed (an eviction may now warrant
        sliced polling for rejoiners), and only the caller knows.
        """
        while True:
            live = {c.sock: i for i, c in enumerate(self.conns)
                    if c.sock.fileno() >= 0}
            if not live:
                raise RuntimeError("no open connections")
            ready, _, _ = select.select(list(live), [], [], timeout)
            if not ready:
                raise TimeoutError("recv_any timed out")
            for sock in ready:
                i = live[sock]
                c = self.conns[i]
                dl = (None if frame_timeout is None
                      else time.monotonic() + frame_timeout)
                try:
                    return i, c.recv_msg(deadline=dl)
                except TimeoutError as e:
                    # partial frame then stall: the stream can't be
                    # resumed mid-frame — drop the peer, keep serving.
                    c.close()
                    _drops().labels(reason="frame_timeout").inc()
                    if on_drop is not None:
                        on_drop(i, e)
                        raise TimeoutError(
                            "peer dropped mid-frame (reported via "
                            "on_drop)") from e
                except (ConnectionError, ProtocolError, ValueError) as e:
                    # EOF, a non-control frame, or undecodable bytes: that
                    # peer is broken/desynced (its stream can't be resumed) —
                    # drop it and keep serving the rest.
                    c.close()
                    # both the python and native recv paths raise PeerClosed
                    # for a clean FIN; resets/desyncs surface as other
                    # ConnectionError subclasses or ProtocolError/ValueError
                    clean_eof = isinstance(e, PeerClosed)
                    _drops().labels(
                        reason="eof" if clean_eof else "desync").inc()
                    if on_drop is not None and not clean_eof:
                        on_drop(i, e)
                        raise TimeoutError(
                            "peer dropped abnormally (reported via "
                            "on_drop)") from e

    def close(self):
        for c in self.conns:
            c.close()
        self.sock.close()


def _dial_failure_reason(e: OSError) -> str:
    """Classify a failed dial for the connect-retry counter's `reason`
    label — lets diststat separate "server not up yet" (refused) from a
    partitioned/overloaded standby during failover."""
    if isinstance(e, ConnectionRefusedError):
        return "refused"
    if isinstance(e, (TimeoutError, socket.timeout)):
        return "timeout"
    if getattr(e, "errno", None) in (errno.EHOSTUNREACH, errno.ENETUNREACH):
        return "unreachable"
    return "other"


def connect(host: str, port: int, retries: int = 60,
            retry_interval: float = 0.25,
            max_interval: float = 5.0,
            deadline_s: float | None = None) -> Conn:
    """Client-side connect with retry — the reference launch scripts start
    server and clients concurrently, so clients must tolerate a not-yet-
    listening server (examples/AsyncEASGD.sh backgrounds everything).

    Retries back off exponentially from ``retry_interval`` with FULL
    jitter (sleep ~ U[0, min(max_interval, retry_interval * 2**k)]): a
    whole fleet failing over to a standby otherwise re-dials in
    lockstep and thundering-herds the freshly promoted center.

    ``deadline_s`` bounds the WHOLE retry walk in wall-clock seconds:
    each dial is capped to the remaining budget and no sleep outlives
    it.  Without it, ``retries=60`` against a blackholed host can pin a
    ``failover()`` dial for minutes before the next center is tried.
    """
    last: Exception | None = None
    deadline = (None if deadline_s is None
                else time.monotonic() + float(deadline_s))
    for attempt in range(retries):
        remaining = None
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0 and attempt:
                break
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            if remaining is not None:
                # bound the dial itself too: a SYN into a partition
                # otherwise blocks for the kernel's connect timeout
                s.settimeout(max(0.01, remaining))
            s.connect((host, port))
            s.settimeout(None)
            return Conn(s)
        except OSError as e:
            # Close the failed socket before sleeping: each refused dial
            # otherwise leaks an fd for the lifetime of the retry loop
            # (60 retries x N clients = real fd pressure).
            s.close()
            last = e
            obs.counter("transport_connect_retries_total",
                        "failed connect() dial attempts",
                        labels=("reason",)).labels(
                            reason=_dial_failure_reason(e)).inc()
            cap = min(max_interval, retry_interval * (2.0 ** attempt))
            sleep = random.uniform(0.0, cap)
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                sleep = min(sleep, remaining)
            time.sleep(sleep)
    raise ConnectionError(f"could not connect to {host}:{port}: {last}")
