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

  - B3 :func:`quantize_ef_leaves_cuda` — ``max|d|`` of every leaf of a
    delta (:func:`amax_leaves_cuda`), then ``q = rint(d / s)`` as int8 and
    ``r = d - f32(q) * s`` with the scale computed on the device, two
    launches a delta; :func:`amax_cuda` and :func:`quantize_ef_cuda` are
    their one-leaf cases with a read back (replaces ``quantize_ef_jax``,
    ``_amax_call`` and ``_quant_ef_call``);
  - B4 :func:`dequant_add_leaves_cuda` — ``c' = c + f32(q) * s`` over
    every leaf of a delta in one launch, :func:`dequant_add_cuda` its
    one-leaf case (replaces ``dequant_add_jax``/``_dequant_add_call``).

  Each wrapper dispatches on its tensors' device: a CUDA tensor launches the
  kernel (or the wrapper raises), a CPU tensor takes the plain PyTorch
  version beside it (:func:`amax_plain`, :func:`amax_bits_plain`,
  :func:`quantize_ef_plain`, :func:`quantize_ef_leaves_plain`,
  :func:`dequant_add_plain`, :func:`dequant_add_leaves_plain`), one
  operation per rounding, which is also the kernels' oracle.  There is no
  fallback from one to the other.  Each wrapper counts its kernel launches
  in ``<wrapper>.launches``, as many as the C entry point reports (one per
  table of up to :data:`LEAF_CAPACITY` leaves).

The scale follows the reference formula exactly: ``scale = amax / 127.0``
in double rides in the manifest, and the quantize rounds it to float (on
the device, from the same amax bits).  A non-finite amax raises
``ValueError`` on the host (the center must never take a poisoned delta);
as in the JAX route, the leaves before the first non-finite one are
encoded and the rest are left untouched.  A zero scale writes q = 0 and
carries the whole delta in r.

:func:`encode_ef_into` assembles one packed payload whose manifest is
byte-identical to ``wire.encode_leaves``'s for the same values: numpy
leaves take the host route; torch leaves take the tensor route, which writes
the int8 and raw wire bytes into a device staging twin of the frame buffer
and moves the whole frame, with the amax slots behind it, to the host in
one copy and one synchronize (fp16 leaves are encoded on the host).
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
    "amax_plain", "amax_bits_plain", "amax_cuda", "amax_leaves_cuda",
    "amaxes_of", "first_nonfinite", "scales_of", "quantize_ef_plain",
    "quantize_ef_cuda", "quantize_ef_leaves_plain", "quantize_ef_leaves_cuda",
    "dequant_add_plain", "dequant_add_cuda", "dequant_add_leaves_plain",
    "dequant_add_leaves_cuda", "encode_ef_into",
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
    "dl_amax_leaves_f32": (_P, _P, _P, ctypes.c_int, _P),
    "dl_quant_ef_leaves_f32": (_P, _P, _P, _P, _P, ctypes.c_int, _P),
    "dl_dequant_add_f32": (_P, _P, _P, ctypes.c_int64, ctypes.c_float, _P),
    "dl_dequant_add_leaves_f32": (_P, _P, _P, _P, _P, ctypes.c_int, _P),
}
#: leaves in one launch of a multi-leaf kernel (``kLeafCap`` in the source)
LEAF_CAPACITY = 64


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


def amax_bits_plain(xs) -> torch.Tensor:
    """The amax slots of the leaves ``xs`` as the kernel writes them: per
    leaf the largest bit pattern of ``|x|`` as int32 (the bits of
    ``max|x|``; of the largest NaN if ``x`` holds one; 0 when empty)."""
    return torch.tensor([int(torch.abs(x).view(torch.int32).amax())
                         if x.numel() else 0 for x in xs], dtype=torch.int32)


def amaxes_of(slots) -> list[float]:
    """The ``max|x|`` values of host amax slots as Python floats: the
    kernel's int32 bits of float32, or the twin's float64 values."""
    a = np.asarray(slots)
    return (a.view(np.float32) if a.dtype == np.int32 else a).tolist()


def first_nonfinite(slots) -> int:
    """The index of the first non-finite amax slot (``len(slots)`` if
    none): the leaf at which the JAX route's encode raises."""
    amaxes = amaxes_of(slots)
    return next((i for i, a in enumerate(amaxes) if not math.isfinite(a)),
                len(amaxes))


def scales_of(slots) -> list[float]:
    """The manifest scales ``amax / 127.0`` of host amax slots; raises
    ``ValueError`` if a leaf's amax is not finite."""
    return [_scale_of(a) for a in amaxes_of(slots)]


def _amax_into(wrapper, xs, slots: torch.Tensor) -> None:
    """One memset of ``slots`` and one amax launch per table of the
    contiguous float32 leaves ``xs``, counted on ``wrapper``."""
    dev, name = slots.device, wrapper.__name__
    _check(name, dev, len(xs), (slots, torch.int32))
    for x in xs:
        if x.dtype != torch.float32 or not x.is_contiguous() or \
                x.device != dev:
            raise ValueError(f"{name}: contiguous float32 leaves on {dev} "
                             f"only, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    n = len(xs)
    _launch(wrapper, "dl_amax_leaves_f32", slots.data_ptr(),
            (_P * n)(*(x.data_ptr() for x in xs)),
            (ctypes.c_int64 * n)(*(x.numel() for x in xs)), n, _stream(dev))


def amax_leaves_cuda(xs, slots: torch.Tensor | None = None) -> torch.Tensor:
    """B3's first pass over the leaves of a delta: the amax slots (int32,
    one per leaf, the bits of ``max|x|``) on the leaves' device, written
    into ``slots`` when given, by one amax launch per
    :data:`LEAF_CAPACITY` non-empty leaves; does not synchronise.  CPU
    leaves take :func:`amax_bits_plain`."""
    xs = list(xs)
    dev = xs[0].device if xs else torch.device("cpu")
    if dev.type == "cpu":
        bits = amax_bits_plain(xs)
        return bits if slots is None else slots.copy_(bits)
    if slots is None:
        slots = torch.empty(len(xs), dtype=torch.int32, device=dev)
    _amax_into(amax_leaves_cuda, xs, slots)
    return slots


amax_leaves_cuda.launches = 0


def amax_cuda(xs: list[torch.Tensor]) -> list[float]:
    """``max|x|`` of every leaf in ``xs``: the amax launches into one
    device slot buffer, then ONE read back to the host for all of them (a
    NaN anywhere in a leaf gives NaN).  CPU leaves take
    :func:`amax_plain`."""
    if not xs:
        return []
    dev = xs[0].device
    if dev.type == "cpu":
        return [amax_plain(x) for x in xs]
    slots = torch.empty(len(xs), dtype=torch.int32, device=dev)
    _amax_into(amax_cuda, xs, slots)
    return amaxes_of(slots.cpu())


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


def quantize_ef_leaves_plain(xs, qs, rs) -> torch.Tensor:
    """B3 over the leaves of a delta in plain PyTorch, as the JAX route
    encodes them: :func:`quantize_ef_plain` of each leaf in order into
    ``qs[i]`` and ``rs[i]``, stopping at the first leaf whose ``max|x|`` is
    not finite (it and every later leaf stay untouched).  Returns each
    leaf's ``max|x|`` as a float64 tensor, for :func:`scales_of`."""
    amaxes = [amax_plain(x) for x in xs]
    for x, q, r, a in zip(xs, qs, rs, amaxes):
        if not math.isfinite(a):
            break
        qq, _, rr = quantize_ef_plain(x, a)
        q.copy_(qq)
        r.copy_(rr)
    return torch.tensor(amaxes, dtype=torch.float64)


def _quantize_leaves(amax_wrapper, wrapper, xs, qs, rs, slots):
    """B3 over ``xs``: the amax pass counted on ``amax_wrapper``, the
    quantize pass on ``wrapper``.  Returns ``(qs, slots, rs)``."""
    xs = list(xs)
    qs = [torch.empty(x.shape, dtype=torch.int8, device=x.device)
          for x in xs] if qs is None else list(qs)
    rs = [torch.empty_like(x) for x in xs] if rs is None else list(rs)
    if len(qs) != len(xs) or len(rs) != len(xs):
        raise ValueError(f"{wrapper.__name__}: one q and one r per leaf")
    dev = xs[0].device if xs else torch.device("cpu")
    if dev.type == "cpu":
        return qs, quantize_ef_leaves_plain(xs, qs, rs), rs
    # one pass over the leaves: the checks of _check, inlined (this is the
    # host time the one launch exists to cut), and the table's columns
    f32, i8 = torch.float32, torch.int8
    px, pq, pr, ns = [], [], [], []
    for x, q, r in zip(xs, qs, rs):
        n = x.numel()
        if not (x.dtype == f32 and r.dtype == f32 and q.dtype == i8
                and q.numel() == n and r.numel() == n and x.is_contiguous()
                and q.is_contiguous() and r.is_contiguous()):
            raise ValueError(
                f"{wrapper.__name__}: contiguous float32 x and r and int8 q "
                f"of one length per leaf, got {x.dtype} {tuple(x.shape)}, "
                f"{q.dtype} {tuple(q.shape)}, {r.dtype} {tuple(r.shape)}")
        px.append(x.data_ptr())
        pq.append(q.data_ptr())
        pr.append(r.data_ptr())
        ns.append(n)
    if len({t.device for t in (*xs, *qs, *rs)}) != 1:
        raise ValueError(f"{wrapper.__name__}: all tensors must be on {dev}")
    if slots is None:
        slots = torch.empty(len(xs), dtype=torch.int32, device=dev)
    _check(wrapper.__name__, dev, len(xs), (slots, torch.int32))
    n, stream = len(xs), _stream(dev)
    px, ns = (_P * n)(*px), (ctypes.c_int64 * n)(*ns)
    _launch(amax_wrapper, "dl_amax_leaves_f32", slots.data_ptr(), px, ns, n,
            stream)
    _launch(wrapper, "dl_quant_ef_leaves_f32", (_P * n)(*pq),
            (_P * n)(*pr), px, ns, slots.data_ptr(), n, stream)
    return qs, slots, rs


def quantize_ef_leaves_cuda(xs, qs=None, rs=None,
                            slots: torch.Tensor | None = None):
    """B3 over every leaf of a delta: one amax launch (counted on
    :func:`amax_leaves_cuda`) and one quantize launch per
    :data:`LEAF_CAPACITY` non-empty leaves, with no host round trip
    between them: the quantize reads each leaf's amax from the device slots
    and computes its scale there.  Writes ``qs[i]`` (int8) and ``rs[i]``
    (float32, not aliasing ``xs[i]``), allocated when None, and returns
    ``(qs, slots, rs)``: ``slots`` (int32, one per leaf, on the leaves'
    device, into ``slots`` when given) holds the bits of each ``max|x|``
    once the stream gets there, for :func:`scales_of`, which raises on a
    non-finite one.  Leaves from the first non-finite one on are left
    untouched, as the JAX route leaves them.  Does not synchronise.  CPU
    leaves (float32 or wider) take :func:`quantize_ef_leaves_plain`, whose
    float64 amaxes come back in place of the slots."""
    return _quantize_leaves(amax_leaves_cuda, quantize_ef_leaves_cuda, xs,
                            qs, rs, slots)


quantize_ef_leaves_cuda.launches = 0


def quantize_ef_cuda(d: torch.Tensor, q: torch.Tensor | None = None,
                     r: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, float, torch.Tensor]:
    """B3 on one float32 leaf, the one-leaf case of
    :func:`quantize_ef_leaves_cuda` (its amax launch counted on
    :func:`amax_cuda`): returns ``(q, scale, r)``, written into ``q``/``r``
    when given (``r`` must not alias ``d``), after one read back of the
    amax.  Non-finite input raises ``ValueError`` and writes nothing."""
    (q,), slots, (r,) = _quantize_leaves(
        amax_cuda, quantize_ef_cuda, [d], None if q is None else [q],
        None if r is None else [r], None)
    return q, scales_of(slots.cpu())[0], r


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


def dequant_add_leaves_plain(cs, qs, scales) -> list[torch.Tensor]:
    """:func:`dequant_add_plain` of every leaf."""
    return [dequant_add_plain(c, q, s) for c, q, s in zip(cs, qs, scales)]


def dequant_add_leaves_cuda(cs, qs, scales, outs=None) -> list[torch.Tensor]:
    """B4 over a list of leaves: ``outs[i] = cs[i] + f32(qs[i]) * s_i`` in
    one launch for every :data:`LEAF_CAPACITY` non-empty leaves (the
    server's apply of a whole delta).  ``outs`` may be ``cs`` (in place);
    default allocates.  CPU leaves take :func:`dequant_add_leaves_plain`."""
    cs, qs = list(cs), list(qs)
    if len(qs) != len(cs) or len(scales) != len(cs) or (
            outs is not None and len(outs) != len(cs)):
        raise ValueError("dequant_add_leaves_cuda: one q, scale and out per "
                         "leaf")
    if not cs:
        return []
    if cs[0].device.type == "cpu":
        res = dequant_add_leaves_plain(cs, qs, scales)
        return res if outs is None else [o.copy_(r) for o, r in
                                         zip(outs, res)]
    dev = cs[0].device
    outs = [torch.empty_like(c) for c in cs] if outs is None else list(outs)
    # one pass over the leaves: the checks of _check, inlined (this is the
    # host time the one launch exists to cut), and the table's columns
    f32, i8 = torch.float32, torch.int8
    po, pc, pq, ns = [], [], [], []
    for c, q, o in zip(cs, qs, outs):
        n = c.numel()
        if not (c.dtype == f32 and o.dtype == f32 and q.dtype == i8
                and q.numel() == n and o.numel() == n and c.is_contiguous()
                and q.is_contiguous() and o.is_contiguous()):
            raise ValueError(
                "dequant_add_leaves_cuda: contiguous float32 c and out and "
                f"int8 q of one length per leaf, got {c.dtype} "
                f"{tuple(c.shape)}, {q.dtype} {tuple(q.shape)}, {o.dtype} "
                f"{tuple(o.shape)}")
        po.append(o.data_ptr())
        pc.append(c.data_ptr())
        pq.append(q.data_ptr())
        ns.append(n)
    if len({t.device for t in (*cs, *qs, *outs)}) != 1:
        raise ValueError(f"dequant_add_leaves_cuda: all tensors must be on "
                         f"{dev}")
    n = len(cs)
    # ctypes rounds each scale to float32 to nearest even, as _f32 does
    _launch(dequant_add_leaves_cuda, "dl_dequant_add_leaves_f32",
            (_P * n)(*po), (_P * n)(*pc), (_P * n)(*pq),
            (ctypes.c_int64 * n)(*ns), (ctypes.c_float * n)(*scales), n,
            _stream(dev))
    return outs


dequant_add_leaves_cuda.launches = 0


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

    Torch leaves (all on one device) take the tensor route: one
    :func:`quantize_ef_leaves_cuda` over the int8 leaves, int8 and raw wire
    bytes written into ``out``'s device stage, then one copy of the whole
    frame and the amax slots to the host (synchronised before returning,
    so the frame is complete when it is sent).  Non-finite input raises
    ``ValueError`` after encoding the leaves before the first non-finite
    one, as the JAX package's route does.  fp16 leaves are copied to the host and
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
    # the int8 leaves' amax slots ride behind the frame, 16-byte aligned,
    # and come to the host in the frame's one copy
    q8 = [i for i, e in enumerate(encs) if e == "int8"]
    tail = -(-total // 16) * 16
    staged = tail + 4 * len(q8)
    stage = (out.device_stage(staged, dev) if out is not None
             else torch.empty(staged, dtype=torch.uint8, device=dev))
    entries, host_fp16, xs, qs, rs = [], [], [], [], []
    offset = logical = 0
    for x, r, dt, enc, nbytes in zip(leaves, residuals, dtypes, encs, sizes):
        window = stage[offset:offset + nbytes]
        if enc == "int8":
            xs.append(x.contiguous())
            qs.append(window.view(torch.int8).view(x.shape))
            rs.append(r)
        elif enc == "fp16":
            host_fp16.append((x, r, offset))    # after the frame lands
        else:
            window.copy_(_as_bytes(x))
        entries.append({"dtype": dt.name, "shape": list(x.shape), "enc": enc,
                        "offset": offset, "nbytes": nbytes})
        offset += nbytes
        logical += x.numel() * dt.itemsize
    slots = stage[tail:staged].view(torch.int32)
    if q8:
        slots = quantize_ef_leaves_cuda(xs, qs, rs, slots=slots)[1]
    if out is not None:
        out.reserve(staged)
        host = out.host_tensor(staged)
    else:
        host = torch.empty(staged, dtype=torch.uint8)
    with obs.span("wire_kernels.frame_d2h"):
        # the encode's one synchronize (a copy to pageable memory makes it)
        pinned = host.is_pinned()
        host.copy_(stage[:staged], non_blocking=pinned)
        if pinned:
            torch.cuda.current_stream(dev).synchronize()
    if dev.type == "cuda":
        slots = host[tail:staged].view(torch.int32)
    # the JAX route encodes leaf by leaf and raises at the first non-finite
    # one: the leaves before it carry their residuals, the rest are untouched
    k = first_nonfinite(slots)
    stop = q8[k] if k < len(q8) else len(leaves)
    for i, (e, r) in enumerate(zip(encs, residuals)):
        if e == "raw" and r is not None and i < stop:
            r.zero_()               # raw decodes to itself: zero carry
    for i, scale in zip(q8, scales_of(slots)):   # raises at leaf ``stop``
        entries[i]["scale"] = scale
    frame = host[:total].numpy()
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
