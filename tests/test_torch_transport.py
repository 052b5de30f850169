"""The port's framed TCP transport (``distlearn_tpu_torch/comm/transport.py``)
against the JAX package's, over real loopback sockets with a JAX ``Conn`` at
one end and a port ``Conn`` at the other: control messages, per-leaf and
packed tensor lists in every codec, and pre-encoded payloads received
undecoded, in both directions, arrays bit for bit and manifests equal.
Then the framing rejections of tests/test_transport.py on the port's
``Conn``."""

import socket
import struct

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from distlearn_tpu.comm import transport as jtransport  # noqa: E402
from distlearn_tpu.comm import wire as jwire  # noqa: E402
from distlearn_tpu_torch.comm import transport, wire  # noqa: E402
from distlearn_tpu_torch.comm.errors import PeerClosed  # noqa: E402


def _socks():
    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    a = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    a.connect(lst.getsockname())
    b, _ = lst.accept()
    lst.close()
    return a, b


def _pair(sender, receiver):
    """(tx, rx) Conns of the named packages ("jax" or "port")."""
    mods = {"jax": jtransport, "port": transport}
    a, b = _socks()
    return mods[sender].Conn(a), mods[receiver].Conn(b)


DIRECTIONS = [("jax", "port"), ("port", "jax")]


def _leaves():
    rng = np.random.RandomState(3)
    return [rng.randn(5, 3).astype(np.float32),
            rng.randn(17).astype(np.float64),
            np.arange(12, dtype=np.int64).reshape(3, 4),
            np.float32(-1.5).reshape(()),
            np.zeros((0, 4), np.float32),
            (rng.randn(300) * 4).astype(np.float32)]


def _same_bits(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("sender,receiver", DIRECTIONS)
def test_messages_cross(sender, receiver):
    tx, rx = _pair(sender, receiver)
    for msg in ("Enter?", {"q": "Enter?", "clientID": 2,
                           "wire": {"v": 1, "codec": "int8"}}, [1, 2.5, None]):
        tx.send_msg(msg)
        assert rx.recv_msg() == msg
    tx.close()
    rx.close()


@pytest.mark.parametrize("sender,receiver", DIRECTIONS)
@pytest.mark.parametrize("codec,packed", [("raw", False), ("raw", True),
                                          ("fp16", True), ("int8", True)])
def test_tensor_lists_cross(sender, receiver, codec, packed):
    """What arrives equals what the receiver's own package decodes from the
    sender's encoding, bit for bit."""
    tx, rx = _pair(sender, receiver)
    leaves = _leaves()
    tx.send_tensors(leaves, codec=codec, packed=packed)
    got = rx.recv_tensors(n=len(leaves))
    want = (leaves if not packed
            else jwire.encode_leaves(leaves, codec).decoded())
    for g, w in zip(got, want):
        _same_bits(g, w)
    tx.close()
    rx.close()


@pytest.mark.parametrize("sender,receiver", DIRECTIONS)
@pytest.mark.parametrize("codec", wire.CODECS)
def test_payload_cross_undecoded(sender, receiver, codec):
    """``send_packed`` of a pre-encoded payload, ``recv_payload`` on the
    other side: the same manifest and wire bytes."""
    tx, rx = _pair(sender, receiver)
    enc = (wire if sender == "port" else jwire).encode_leaves(_leaves(),
                                                              codec)
    tx.send_packed(enc)
    got = rx.recv_payload(n=len(_leaves()))
    assert got.manifest == enc.manifest and got.codec == codec
    for g, w in zip(got.bufs, enc.bufs):
        _same_bits(g, w)
    tx.close()
    rx.close()


def test_recv_payload_into_frame_buffer():
    """The port's staging receive: the leaves are views of one reusable
    buffer whose first bytes are the whole data region."""
    tx, rx = _pair("jax", "port")
    enc = jwire.encode_leaves(_leaves(), "int8")
    fb = wire.FrameBuffer()
    for _ in range(2):
        tx.send_packed(enc)
        got = rx.recv_payload(n=len(_leaves()), out=fb)
        assert got.frame is not None and got.frame.nbytes == enc.wire_nbytes
        for g, w in zip(got.bufs, enc.bufs):
            _same_bits(g, w)
            assert g.size == 0 or np.shares_memory(g, fb.buf)
    tx.close()
    rx.close()


# ---------------------------------------------------------------------------
# Framing rejections (tests/test_transport.py) on the port's Conn


def test_corrupt_frame_payload_size_rejected():
    tx, rx = _pair("jax", "port")
    header = b'{"dtype": "float32", "shape": [4]}'
    payload = struct.pack("<I", len(header)) + header + b"\0" * 8  # 8 != 16
    tx._send_frame(ord("T"), payload)
    with pytest.raises(transport.ProtocolError, match="payload"):
        rx.recv_tensor()
    tx.close()
    rx.close()


def test_negative_shape_rejected():
    tx, rx = _pair("jax", "port")
    header = b'{"dtype": "float32", "shape": [-1]}'
    tx._send_frame(ord("T"), struct.pack("<I", len(header)) + header)
    with pytest.raises(transport.ProtocolError, match="negative"):
        rx.recv_tensor()
    tx.close()
    rx.close()


@pytest.mark.parametrize("sent", ["half_header", "header_only"])
def test_mid_frame_fin_raises_reset(sent):
    tx, rx = _pair("port", "port")
    hdr = struct.pack("<BQ", ord("J"), 64)
    tx.sock.sendall(hdr[:5] if sent == "half_header" else hdr)
    tx.close()
    with pytest.raises(ConnectionResetError):
        rx.recv_msg()
    rx.close()


def test_fin_on_frame_boundary_is_clean_eof():
    tx, rx = _pair("port", "port")
    tx.send_msg({"q": "bye"})
    tx.close()
    assert rx.recv_msg() == {"q": "bye"}
    with pytest.raises(PeerClosed):
        rx.recv_msg()
    rx.close()


@pytest.mark.parametrize("py_io", [False, True], ids=["native", "python"])
def test_closed_conn_never_reaches_a_reused_descriptor(py_io):
    """IO on a closed conn raises, even after the process opened another
    socket under the same descriptor number: the fleet roles run as
    threads of one process, and a cut client that sends on its closed
    channel must not write into another client's (seen on the card as a
    worker reading a foreign ``Enter?``)."""
    tx, rx = _pair("port", "port")
    tx.force_py_io = py_io
    fd = tx.sock.fileno()
    tx.close()
    rx.close()
    a, b = _socks()
    pair = [a, b]
    while fd not in (a.fileno(), b.fileno()) and len(pair) < 64:
        a, b = _socks()                     # until the number is reused
        pair += [a, b]
    try:
        assert fd in (a.fileno(), b.fileno())
        peer = b if a.fileno() == fd else a
        with pytest.raises(OSError):
            tx.send_msg({"q": "Enter?", "clientID": 2})
        with pytest.raises(OSError):
            tx.send_tensors([np.ones(4, np.float32)], packed=False)
        with pytest.raises(OSError):
            tx.recv_msg()
        peer.setblocking(False)
        with pytest.raises(BlockingIOError):
            peer.recv(1)                    # nothing reached the new socket
    finally:
        for s in pair:
            s.close()
