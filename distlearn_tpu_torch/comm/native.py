"""ctypes loader for the native transport core (src/comm/distcomm.cpp) —
counterpart of ``distlearn_tpu/comm/native.py``, building the same source.

Mirrors how the reference keeps its hot communication path native (torch-ipc
C++) under a thin scripting binding.  The library is compiled on first use
with g++ into the git-ignored ``build/distlearn_tpu_torch_comm/`` (the JAX
package keeps its own copy beside its sources); if no toolchain is available
the transport falls back to pure-Python socket IO, as the JAX transport does.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from distlearn_tpu_torch.comm.errors import PeerClosed

_lib = None
_tried = False
_lock = threading.Lock()

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "src", "comm", "distcomm.cpp")
_SO = os.path.join(_ROOT, "build", "distlearn_tpu_torch_comm", "_distcomm.so")


def _build() -> str | None:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    # Compile to a per-process temp path then atomically rename: concurrent
    # launchers (asyncEASGD.sh starts 4 processes at once) must never dlopen
    # a half-written .so.
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return _SO
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("DISTLEARN_TPU_NO_NATIVE"):
            return None
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.dc_send_frame.argtypes = [ctypes.c_int, ctypes.c_uint8,
                                      ctypes.c_char_p, ctypes.c_uint64]
        lib.dc_send_frame.restype = ctypes.c_int
        lib.dc_send_frame2.argtypes = [ctypes.c_int, ctypes.c_uint8,
                                       ctypes.c_char_p, ctypes.c_uint64,
                                       ctypes.c_void_p, ctypes.c_uint64]
        lib.dc_send_frame2.restype = ctypes.c_int
        lib.dc_recv_exact.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_uint64]
        lib.dc_recv_exact.restype = ctypes.c_int
        for fn in _reducers(lib).values():
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
                           ctypes.c_int]
            fn.restype = None
        _lib = lib
        return _lib


def _reducers(lib) -> dict:
    return {np.dtype(np.float32): lib.dc_reduce_float,
            np.dtype(np.float64): lib.dc_reduce_double,
            np.dtype(np.int32): lib.dc_reduce_int32_t,
            np.dtype(np.int64): lib.dc_reduce_int64_t}


def available() -> bool:
    return _load() is not None


import errno as _errno

_TIMEOUT_ERRNOS = {_errno.EAGAIN, _errno.EWOULDBLOCK, _errno.ETIMEDOUT}


def _check_rc(rc: int, what: str) -> None:
    if rc == -1:
        raise PeerClosed("peer closed connection")
    if rc == -2:
        # FIN landed after partial progress: a torn frame, not a finished
        # peer — surfaced as the reset subclass so drop-policy code
        # (transport.Server.recv_any) treats it as abnormal
        raise ConnectionResetError("peer closed connection mid-frame")
    if rc != 0:
        if -rc in _TIMEOUT_ERRNOS:
            # SO_RCVTIMEO/SO_SNDTIMEO expired mid-operation (the per-handshake
            # timeout of the AsyncEA server) — distinct from a dead peer.
            raise TimeoutError(f"{what} timed out (socket timeout)")
        raise ConnectionError(f"{what} failed: {os.strerror(-rc)}")


def send_frame(fd: int, kind: int, payload) -> None:
    lib = _load()
    buf = payload if isinstance(payload, bytes) else bytes(payload)
    _check_rc(lib.dc_send_frame(fd, kind, buf, len(buf)), "dc_send_frame")


def send_tensor_frame(fd: int, kind: int, meta: bytes, arr: np.ndarray) -> None:
    """Zero-copy tensor send: meta (length-prefixed JSON header) from Python
    bytes, raw data straight from the numpy buffer — one writev in C++."""
    lib = _load()
    _check_rc(lib.dc_send_frame2(fd, kind, meta, len(meta),
                                 arr.ctypes.data, arr.nbytes),
              "dc_send_frame2")


def recv_exact(fd: int, buf: memoryview, n: int) -> None:
    if n == 0:
        return
    if n < 0 or n > buf.nbytes:
        raise ValueError(f"recv_exact: {n} bytes into a {buf.nbytes}-byte "
                         "buffer")
    lib = _load()
    addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    _check_rc(lib.dc_recv_exact(fd, addr, n), "dc_recv_exact")


def reduce_inplace(dst: np.ndarray, src: np.ndarray, op: str = "sum") -> None:
    """Native elementwise reduction ``dst op= src`` (the tree-reduce inner
    loop, ``dc_reduce_*``); other dtypes, non-contiguous arrays and a
    missing library take numpy's ufuncs, which give the same values."""
    opc = {"sum": 0, "max": 1, "min": 2}[op]
    lib = _load()
    fn = None if lib is None else _reducers(lib).get(dst.dtype)
    if fn is None or src.dtype != dst.dtype or src.size != dst.size \
            or not (dst.flags.c_contiguous and src.flags.c_contiguous):
        (np.add, np.maximum, np.minimum)[opc](dst, src, out=dst)
        return
    fn(dst.ctypes.data, src.ctypes.data, dst.size, opc)
