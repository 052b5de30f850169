"""Fused wire-codec kernels — counterpart of
``distlearn_tpu/ops/wire_kernels.py``: the int8 codec with error feedback
that the AsyncEA client runs on every sync, and the dequantize-and-add the
server runs on every apply.

Two routes, chosen by what the caller holds:

* **Host route** (numpy arrays): copied from the JAX package —
  :func:`quantize_ef_into`, :func:`fp16_ef_into`, :func:`dequant_add` and
  :func:`fp16_add`, cache-blocked numpy, bitwise equal to the reference
  codec ``comm/wire.py::_encode_leaf``.  (The JAX package's SIMD C codec,
  ``ops/wire_native.py``, is bitwise equal to this route and is not ported
  yet.)
* **Tensor route** (torch tensors): the two Pallas TPU kernels become
  hand-written CUDA kernels for Hopper (``ops/csrc/wire_kernels.cu``):

  - B3 :func:`quantize_ef_cuda` — ``q = rint(d / s)`` as int8 and
    ``r = d - f32(q) * s``, after :func:`amax_cuda`'s ``max|d|`` (replaces
    ``quantize_ef_jax``, ``_amax_call`` and ``_quant_ef_call``);
  - B4 :func:`dequant_add_cuda` — ``c' = c + f32(q) * s`` (replaces
    ``dequant_add_jax``/``_dequant_add_call``).

  Each wrapper dispatches on its tensors' device: a CUDA tensor launches the
  kernel (or the wrapper raises), a CPU tensor takes the plain PyTorch
  version beside it (:func:`amax_plain`, :func:`quantize_ef_plain`,
  :func:`dequant_add_plain`), one operation per rounding, which is also the
  kernels' oracle.  There is no fallback from one to the other.  Each
  wrapper counts its kernel launches in ``<wrapper>.launches``, as many as
  the C entry point reports (one per call).

The scale follows the reference formula exactly: ``amax`` is checked finite
on the host (``ValueError`` otherwise — the center must never take a
poisoned delta), ``scale = amax / 127.0`` in Python floats rides in the
manifest, and the kernels get it rounded to the leaf's float type.  A zero
scale launches nothing: q = 0 and the whole delta carries in r.

:func:`encode_ef_into` assembles one packed payload whose manifest is
byte-identical to ``wire.encode_leaves``'s for the same values: numpy
leaves take the host route; torch leaves take the tensor route, which writes
the int8 and raw wire bytes into a device staging twin of the frame buffer
and moves the whole frame to the host in one copy (fp16 leaves are encoded
on the host).
"""

from __future__ import annotations

import ctypes
import math
import threading

import numpy as np
import torch

from distlearn_tpu_torch import obs
from distlearn_tpu_torch.comm import wire
from distlearn_tpu_torch.ops import _build
from distlearn_tpu_torch.ops.fused_update import cast_scalar

__all__ = [
    "quantize_ef_into", "fp16_ef_into", "dequant_add", "fp16_add",
    "amax_plain", "amax_cuda", "quantize_ef_plain", "quantize_ef_cuda",
    "dequant_add_plain", "dequant_add_cuda", "encode_ef_into",
]


# ---------------------------------------------------------------------------
# Host route: cache-blocked numpy (copied from the JAX package)
# ---------------------------------------------------------------------------

#: Elements per chunk — 128k f32 = 512 KB keeps chunk + scratch L2-resident.
_CHUNK = 1 << 17

_scratch = threading.local()


def _chunk_scratch(dtype: np.dtype) -> np.ndarray:
    """One reusable per-thread chunk buffer per dtype — roles running as
    threads of one process must not share it."""
    bufs = getattr(_scratch, "bufs", None)
    if bufs is None:
        bufs = _scratch.bufs = {}
    buf = bufs.get(dtype)
    if buf is None:
        buf = bufs[dtype] = np.empty(_CHUNK, dtype)
    return buf


def _amax_blocked(flat: np.ndarray) -> float:
    """``float(np.max(np.abs(flat)))`` without the |x| temporary: chunked
    ``max(max, -min)`` — exact for every float ordering, NaN-propagating."""
    amax = -math.inf
    for lo in range(0, flat.size, _CHUNK):
        c = flat[lo:lo + _CHUNK]
        hi = float(c.max())
        neg = -float(c.min())
        if hi != hi or neg != neg:
            return math.nan
        amax = max(amax, hi, neg)
    return amax


def _scale_of(amax: float) -> float:
    """The manifest scale of a leaf whose ``max|x|`` is ``amax``."""
    if not math.isfinite(amax):
        raise ValueError(
            "int8 wire codec cannot encode non-finite values (inf/nan leaf)")
    return amax / 127.0


def quantize_ef_into(d: np.ndarray, q: np.ndarray, r: np.ndarray) -> float:
    """Fused int8 quantize + error-feedback residual, blocked.

    Writes ``q`` (int8, same shape) and ``r = d - dequant(q)``, returns the
    Python-float ``scale`` for the manifest.  Bitwise-identical to
    ``wire._encode_leaf(d, "int8")`` + ``decoded()`` + ``np.subtract``; the
    reference's clip is skipped because it cannot change an output (see
    ``ops/csrc/wire_kernels.cu``).  Raises ``ValueError`` on non-finite
    input."""
    flat = d.reshape(-1)
    qf = q.reshape(-1)
    rf = r.reshape(-1)
    scale = _scale_of(_amax_blocked(flat) if flat.size else 0.0)
    if scale == 0.0:
        qf[...] = 0
        rf[...] = flat          # q decodes to 0 => the whole delta carries
        return scale
    st = d.dtype.type(scale)
    for lo in range(0, flat.size, _CHUNK):
        c = flat[lo:lo + _CHUNK]
        s = _chunk_scratch(d.dtype)[:c.size]
        np.divide(c, st, out=s)
        np.rint(s, out=s)
        np.copyto(qf[lo:lo + _CHUNK], s, casting="unsafe")  # integral: exact
        np.multiply(s, st, out=s)        # s*st == f32(q)*st bitwise
        np.subtract(c, s, out=rf[lo:lo + _CHUNK])
    return scale


def fp16_ef_into(d: np.ndarray, h: np.ndarray, r: np.ndarray) -> None:
    """Fused fp16 downcast + residual: ``h = f16(d); r = d - widen(h)``."""
    flat = d.reshape(-1)
    hf = h.reshape(-1)
    rf = r.reshape(-1)
    for lo in range(0, flat.size, _CHUNK):
        c = flat[lo:lo + _CHUNK]
        hc = hf[lo:lo + _CHUNK]
        np.copyto(hc, c, casting="unsafe")    # round-to-nearest-even cast
        s = _chunk_scratch(d.dtype)[:c.size]
        np.copyto(s, hc, casting="unsafe")    # widen back (exact)
        np.subtract(c, s, out=rf[lo:lo + _CHUNK])


def dequant_add(t: np.ndarray, wirebuf: np.ndarray, scale: float | None,
                out: np.ndarray | None = None) -> np.ndarray:
    """Fused dequantize + elastic apply: ``out = t + dequant(wirebuf)``
    without materializing the decoded copy.  ``scale`` selects int8
    (float) vs fp16 (None); ``out`` may alias ``t``."""
    if out is None:
        out = np.empty_like(t)
    tf = t.reshape(-1)
    wf = wirebuf.reshape(-1)
    of = out.reshape(-1)
    st = t.dtype.type(scale) if scale is not None else None
    for lo in range(0, tf.size, _CHUNK):
        wc = wf[lo:lo + _CHUNK]
        s = _chunk_scratch(t.dtype)[:wc.size]
        if st is None:
            np.copyto(s, wc, casting="unsafe")      # fp16 widen
        else:
            np.multiply(wc, st, out=s)              # int8 dequant
        np.add(tf[lo:lo + _CHUNK], s, out=of[lo:lo + _CHUNK])
    return out


def fp16_add(t: np.ndarray, wirebuf: np.ndarray,
             out: np.ndarray | None = None) -> np.ndarray:
    return dequant_add(t, wirebuf, None, out=out)


# ---------------------------------------------------------------------------
# Tensor route: CUDA kernels (ops/csrc/wire_kernels.cu) and plain versions
# ---------------------------------------------------------------------------

_SOURCE = "wire_kernels.cu"
_P = ctypes.c_void_p
_SIGNATURES = {
    "dl_amax_abs_f32": (_P, _P, ctypes.c_int64, _P),
    "dl_quant_ef_f32": (_P, _P, _P, ctypes.c_int64, ctypes.c_float, _P),
    "dl_dequant_add_f32": (_P, _P, _P, ctypes.c_int64, ctypes.c_float, _P),
}


#: guards the launch counts: roles running as threads share the wrappers
_COUNT_LOCK = threading.Lock()


def _launch(wrapper, name: str, *args) -> None:
    """Call ``name`` and add the number of kernels it reports launching to
    ``wrapper.launches``; a refused launch (a negative return) raises."""
    rc = _build.function(_SOURCE, name, _SIGNATURES[name])(*args)
    if rc < 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {-rc}")
    with _COUNT_LOCK:
        wrapper.launches += rc


def _check(name: str, device: torch.device, n: int,
           *pairs: tuple[torch.Tensor, torch.dtype]) -> None:
    """The kernels take contiguous CUDA tensors of ``n`` elements on one
    device, each of its stated dtype; anything else raises."""
    for t, dtype in pairs:
        if t.device != device:
            raise ValueError(f"{name}: all tensors must be on {device}, got "
                             f"{t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if t.numel() != n or not t.is_contiguous():
            raise ValueError(f"{name}: contiguous tensors of {n} elements "
                             f"only, got {tuple(t.shape)}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _f32(x: float) -> float:
    """``x`` rounded to float32 (to nearest even), as a Python float."""
    return float(np.float32(x))


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to ``like``'s dtype as a 0-d tensor on its device.  A
    Python number on a CUDA op becomes a CPU scalar, and PyTorch divides by
    a CPU scalar through its reciprocal (one extra rounding): the plain
    versions divide by a device tensor instead."""
    return torch.tensor(cast_scalar(x, like.dtype), dtype=like.dtype,
                        device=like.device)


def amax_plain(d: torch.Tensor) -> float:
    """``max|d|`` as a Python float (NaN if ``d`` holds a NaN; 0.0 when
    empty)."""
    return float(torch.amax(torch.abs(d))) if d.numel() else 0.0


def amax_cuda(xs: list[torch.Tensor]) -> list[float]:
    """``max|x|`` of every leaf in ``xs``: one amax launch per non-empty
    CUDA leaf into one device slot buffer, then ONE read back to the host
    for all of them (a NaN anywhere in a leaf gives NaN).  CPU leaves take
    :func:`amax_plain`."""
    if not xs:
        return []
    dev = xs[0].device
    if dev.type == "cpu":
        return [amax_plain(x) for x in xs]
    slots = torch.zeros(len(xs), dtype=torch.int32, device=dev)
    for i, x in enumerate(xs):
        n = x.numel()
        _check("amax_cuda", dev, n, (x, torch.float32))
        if n:
            _launch(amax_cuda, "dl_amax_abs_f32", slots.data_ptr() + 4 * i,
                    x.data_ptr(), n, _stream(dev))
    return slots.cpu().numpy().view(np.float32).tolist()


amax_cuda.launches = 0


def quantize_ef_plain(d: torch.Tensor, amax: float | None = None
                      ) -> tuple[torch.Tensor, float, torch.Tensor]:
    """B3 in plain PyTorch: ``(q, scale, r)`` with ``q = round(d / s)`` as
    int8 (round half to even) and ``r = d - f32(q) * s``, one operation per
    rounding.  ``amax`` (default: :func:`amax_plain`) is ``max|d|``."""
    scale = _scale_of(amax_plain(d) if amax is None else amax)
    if scale == 0.0:
        return torch.zeros(d.shape, dtype=torch.int8, device=d.device), \
            scale, d.clone()
    s = _scalar(scale, d)
    qf = torch.round(d / s)
    return qf.to(torch.int8), scale, d - qf * s


def quantize_ef_cuda(d: torch.Tensor, amax: float | None = None,
                     q: torch.Tensor | None = None,
                     r: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, float, torch.Tensor]:
    """B3: int8 quantize with error feedback of one float32 leaf.  Returns
    ``(q, scale, r)``, written into ``q``/``r`` when given (``r`` must not
    alias ``d``).  ``amax`` is ``max|d|`` when the caller has it already
    (:func:`amax_cuda` over all leaves); otherwise one amax launch and one
    read back come first.  Non-finite input raises ``ValueError``; a zero
    scale launches nothing."""
    if amax is None:
        amax = amax_cuda([d])[0]
    if d.device.type == "cpu":
        qq, scale, rr = quantize_ef_plain(d, amax)
        if q is None:
            return qq, scale, rr
        q.copy_(qq)
        r.copy_(rr)
        return q, scale, r
    scale = _scale_of(amax)
    q = torch.empty(d.shape, dtype=torch.int8, device=d.device) \
        if q is None else q
    r = torch.empty_like(d) if r is None else r
    n = d.numel()
    _check("quantize_ef_cuda", d.device, n, (d, torch.float32),
           (q, torch.int8), (r, torch.float32))
    if scale == 0.0:
        q.zero_()
        r.copy_(d)
    elif n:
        _launch(quantize_ef_cuda, "dl_quant_ef_f32", q.data_ptr(),
                r.data_ptr(), d.data_ptr(), n, _f32(scale),
                _stream(d.device))
    return q, scale, r


quantize_ef_cuda.launches = 0


def dequant_add_plain(c: torch.Tensor, q: torch.Tensor, scale: float
                      ) -> torch.Tensor:
    """B4 in plain PyTorch: ``c + f32(q) * s``, two separately rounded
    ops."""
    return c + q.to(c.dtype) * _scalar(scale, c)


def dequant_add_cuda(c: torch.Tensor, q: torch.Tensor, scale: float,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """B4: ``out = c + f32(q) * s`` in one pass; ``out`` may be ``c`` (the
    serial server's in-place apply), default allocates."""
    if c.device.type == "cpu":
        res = dequant_add_plain(c, q, scale)
        return res if out is None else out.copy_(res)
    out = torch.empty_like(c) if out is None else out
    n = c.numel()
    _check("dequant_add_cuda", c.device, n, (c, torch.float32),
           (q, torch.int8), (out, torch.float32))
    if n:
        _launch(dequant_add_cuda, "dl_dequant_add_f32", out.data_ptr(),
                c.data_ptr(), q.data_ptr(), n, _f32(scale),
                _stream(c.device))
    return out


dequant_add_cuda.launches = 0


# ---------------------------------------------------------------------------
# Payload assembly: fused encode into a (reusable) frame buffer
# ---------------------------------------------------------------------------

def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (the wire names leaves by numpy's
    dtype names); raises for types numpy lacks, e.g. bfloat16."""
    return np.dtype(str(dtype).removeprefix("torch."))


def _leaf_enc(dtype: np.dtype, codec: str) -> str:
    """The per-leaf encoding ``wire._encode_leaf`` picks."""
    if codec == "fp16" and dtype.kind == "f" and dtype.itemsize > 2:
        return "fp16"
    if codec == "int8" and dtype.kind == "f":
        return "int8"
    return "raw"


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def encode_ef_into(leaves, residuals, codec: str, out=None):
    """Encode a delta for the packed wire and carry its error-feedback
    residual: one pass per leaf produces the wire bytes AND overwrites
    ``residuals[i]`` with ``d - decoded(d)`` (raw leaves carry a zero
    residual; ``residuals`` may be None for ``codec="raw"``).

    ``out`` is an optional :class:`wire.FrameBuffer`: wire bytes land in
    one preallocated contiguous region (reused across syncs), so
    ``Conn.send_packed`` ships a single iovec.  Returns a
    ``wire.PackedPayload`` whose manifest is byte-identical to
    ``wire.encode_leaves``'s for the same inputs.

    Torch leaves (all on one device) take the tensor route: B3 per int8
    leaf after one :func:`amax_cuda` over all of them, int8 and raw wire
    bytes written into ``out``'s device stage, then one copy of the whole
    frame to the host (synchronised before returning, so the frame is
    complete when it is sent).  fp16 leaves are copied to the host and
    encoded there by :func:`fp16_ef_into`, as the JAX package's device route
    does.  Numpy leaves take the host route."""
    if codec not in wire.CODECS:
        raise ValueError(f"unknown wire codec {codec!r}")
    if residuals is None:
        residuals = [None] * len(leaves)
    if leaves and isinstance(leaves[0], torch.Tensor):
        return _encode_tensors(list(leaves), residuals, codec, out)
    arrs = []
    for x in leaves:
        a = np.asarray(x)
        arrs.append(a if a.flags.c_contiguous else np.ascontiguousarray(a))
    if out is not None:
        out.reserve(sum(wire.encoded_nbytes(a.dtype, a.size, codec)
                        for a in arrs))
    entries, bufs = [], []
    offset = logical = 0
    for a, r in zip(arrs, residuals):
        enc = _leaf_enc(a.dtype, codec)
        nbytes = wire.encoded_nbytes(a.dtype, a.size, codec)
        wdt = a.dtype if enc == "raw" else wire._ENC_WIRE_DTYPE[enc]
        buf = (out.view(offset, nbytes, wdt, a.shape) if out is not None
               else np.empty(a.shape, wdt))
        extra: dict = {}
        if enc == "int8":
            extra = {"scale": quantize_ef_into(a, buf, r)}
        elif enc == "fp16":
            fp16_ef_into(a, buf, r)
        else:
            if out is not None:
                np.copyto(buf, a)
            else:
                buf = a
            if r is not None:
                r[...] = 0          # raw decodes to itself: zero carry
        entries.append({"dtype": a.dtype.name, "shape": list(a.shape),
                        "enc": enc, "offset": offset, "nbytes": nbytes,
                        **extra})
        bufs.append(buf)
        offset += nbytes
        logical += a.nbytes
    payload = wire.PackedPayload({"v": wire.WIRE_V, "codec": codec,
                                  "leaves": entries}, bufs, codec, offset,
                                 logical)
    if out is not None:
        payload.frame = out.frame(offset)
    return payload


def _encode_tensors(leaves: list[torch.Tensor], residuals, codec: str, out):
    dev = leaves[0].device
    dtypes = [numpy_dtype(x.dtype) for x in leaves]
    encs = [_leaf_enc(dt, codec) for dt in dtypes]
    sizes = [wire.encoded_nbytes(dt, x.numel(), codec)
             for dt, x in zip(dtypes, leaves)]
    total = sum(sizes)
    stage = (out.device_stage(total, dev) if out is not None
             else torch.empty(total, dtype=torch.uint8, device=dev))
    amaxes = iter(amax_cuda([x.contiguous() for x, e in zip(leaves, encs)
                             if e == "int8"]))
    entries, host_fp16 = [], []
    offset = logical = 0
    for x, r, dt, enc, nbytes in zip(leaves, residuals, dtypes, encs, sizes):
        window = stage[offset:offset + nbytes]
        extra: dict = {}
        if enc == "int8":
            q = window.view(torch.int8).view(x.shape)
            extra = {"scale": quantize_ef_cuda(x.contiguous(), next(amaxes),
                                               q=q, r=r)[1]}
        elif enc == "fp16":
            host_fp16.append((x, r, offset))    # after the frame lands
        else:
            window.copy_(_as_bytes(x))
            if r is not None:
                r.zero_()
        entries.append({"dtype": dt.name, "shape": list(x.shape), "enc": enc,
                        "offset": offset, "nbytes": nbytes, **extra})
        offset += nbytes
        logical += x.numel() * dt.itemsize
    if out is not None:
        out.reserve(total)
        host = out.host_tensor(total)
    else:
        host = torch.empty(total, dtype=torch.uint8)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()     # the codec is done
    with obs.span("wire_kernels.frame_d2h"):
        host.copy_(stage[:total], non_blocking=host.is_pinned())
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
    frame = host.numpy()
    bufs = [frame[e["offset"]:e["offset"] + e["nbytes"]]
            .view(wire.wire_dtype(e)).reshape(e["shape"]) for e in entries]
    for x, r, off in host_fp16:             # the host codec, as JAX's does
        a = x.detach().cpu().contiguous().numpy()
        rr = np.empty_like(a)
        fp16_ef_into(a, frame[off:off + 2 * a.size].view(np.float16), rr)
        r.copy_(torch.from_numpy(rr))
    return wire.PackedPayload({"v": wire.WIRE_V, "codec": codec,
                               "leaves": entries}, bufs, codec, offset,
                              logical, frame=frame)
