"""The SIMD C host codec — counterpart of ``distlearn_tpu/ops/wire_native.py``,
the same C source and flags.

The blocked-numpy host route in :mod:`wire_kernels` is pass-count-bound:
numpy cannot fuse ``div -> rint -> cast -> mul -> sub`` into one walk.  This
module compiles a ~40-line C kernel with the SYSTEM compiler at first use,
into the git-ignored ``build/distlearn_tpu_torch_wirec/`` beside the port's
other native libraries: one pass per leaf computes ``q = rint(d/scale)``
and the error-feedback residual ``r = d - q*scale`` together,
auto-vectorized.  (The JAX package's docstring quotes its speed-up on its
CPU bench host; the port has not measured this codec separately.)

Optional and degradable: no compiler, a failed compile, a failed load, or
``DISTLEARN_TPU_WIREC=0`` all leave the blocked-numpy route in charge —
nothing is installed and no third-party package is required.
:func:`why_unavailable` reports the reason.

Bitwise parity with the numpy route is load-bearing:

* compiled ``-ffp-contract=off`` so ``r = d - q*scale`` stays two IEEE
  ops (no FMA), exactly like numpy's separate ``multiply``/``subtract``;
* division, ``rintf`` (round-half-to-even, the x86 default rounding
  mode) and the float->int8 cast of an already-integral value are all
  exact IEEE singles, so q/scale/r match numpy bit for bit — including
  subnormal scales (no FTZ/DAZ: the MXCSR is left alone);
* only the amax MAX-reduction is compiled with relaxed NaN/signed-zero
  semantics (gcc will not vectorize it otherwise) — safe because max
  over finite ``|x|`` is exact under any association, callers reject
  non-finite input first via :func:`bad` (a strict-IEEE scan where
  ``!(|x| <= FLT_MAX)`` catches inf AND NaN), and an all-zero amax hits
  the python-level ``scale == 0`` special case where ``-0.0 == 0.0``.

The in-place apply has its own entry point (``t += q*scale``): the
restrict-qualified out-of-place kernel must not be called with
``out`` aliasing ``t``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from distlearn_tpu_torch.utils import flags

__all__ = [
    "available", "why_unavailable", "usable_quant", "usable_apply",
    "amax_checked", "quant_ef_f32", "dequant_add_f32",
]

_SRC = r"""
#include <stdint.h>
#include <stddef.h>
#include <math.h>
#include <float.h>

/* Non-finite scan: !(|x| <= FLT_MAX) is true for inf AND NaN, and the
   int OR-reduction vectorizes under strict IEEE flags. */
int wirec_bad_f32(const float *x, size_t n) {
    int bad = 0;
    for (size_t i = 0; i < n; i++)
        bad |= !(fabsf(x[i]) <= FLT_MAX);
    return bad;
}

/* MAX reduction; relaxed NaN/signed-zero semantics ONLY here (callers
   scan with wirec_bad_f32 first — see module docstring). */
__attribute__((optimize("finite-math-only", "no-signed-zeros")))
float wirec_amax_f32(const float *x, size_t n) {
    float m = 0.0f;
    for (size_t i = 0; i < n; i++) {
        float a = fabsf(x[i]);
        m = a > m ? a : m;
    }
    return m;
}

/* The fused encode: q = rint(d/scale); r = d - q*scale, one pass.
   -ffp-contract=off keeps mul+sub as two IEEE ops (numpy parity). */
void wirec_quant_ef_f32(const float *restrict d, float scale,
                        int8_t *restrict q, float *restrict r, size_t n) {
    for (size_t i = 0; i < n; i++) {
        float s = rintf(d[i] / scale);
        q[i] = (int8_t)s;
        float dq = s * scale;
        r[i] = d[i] - dq;
    }
}

/* Fused dequantize + elastic apply, out must NOT alias t. */
void wirec_dequant_add_f32(const float *restrict t, const int8_t *restrict q,
                           float scale, float *restrict out, size_t n) {
    for (size_t i = 0; i < n; i++) {
        float dq = (float)q[i] * scale;
        out[i] = t[i] + dq;
    }
}

/* Exact-overlap variant (the serial server's in-place apply). */
void wirec_dequant_add_inplace_f32(float *t, const int8_t *restrict q,
                                   float scale, size_t n) {
    for (size_t i = 0; i < n; i++) {
        float dq = (float)q[i] * scale;
        t[i] = t[i] + dq;
    }
}
"""

#: -march=native: the cached .so is host-specific (keyed into the cache
#: name); -fno-math-errno/-fno-trapping-math unblock vectorization of
#: rintf and the compare reductions without changing any finite result.
_CFLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fno-math-errno",
           "-fno-trapping-math", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
_why: str | None = None


_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cache_dir() -> str:
    d = os.path.join(_ROOT, "build", "distlearn_tpu_torch_wirec")
    os.makedirs(d, exist_ok=True)
    return d


def _compiler() -> str | None:
    import shutil
    for cc in (os.environ.get("CC"), "cc", "gcc", "clang"):
        if cc and shutil.which(cc):
            return cc
    return None


def _build() -> tuple[ctypes.CDLL | None, str | None]:
    cc = _compiler()
    if cc is None:
        return None, "no C compiler on PATH (cc/gcc/clang)"
    try:
        import platform
        key = hashlib.sha256(
            (_SRC + "\0" + " ".join(_CFLAGS) + "\0" + cc + "\0"
             + platform.machine()).encode()).hexdigest()[:16]
        cache = _cache_dir()
        so = os.path.join(cache, f"wirec_{key}.so")
        if not os.path.exists(so):
            src = os.path.join(cache, f"wirec_{key}.c")
            with open(src, "w") as fh:
                fh.write(_SRC)
            tmp = f"{so}.tmp{os.getpid()}"
            proc = subprocess.run([cc, *_CFLAGS, "-o", tmp, src],
                                  capture_output=True, text=True,
                                  timeout=120)
            if proc.returncode != 0:
                return None, f"{cc} failed: {proc.stderr.strip()[:400]}"
            os.replace(tmp, so)       # atomic vs concurrent builds
        lib = ctypes.CDLL(so)
    except (OSError, subprocess.SubprocessError, ValueError) as e:
        return None, f"{type(e).__name__}: {e}"
    lib.wirec_bad_f32.restype = ctypes.c_int
    lib.wirec_bad_f32.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.wirec_amax_f32.restype = ctypes.c_float
    lib.wirec_amax_f32.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.wirec_quant_ef_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_size_t]
    lib.wirec_dequant_add_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_size_t]
    lib.wirec_dequant_add_inplace_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_size_t]
    return lib, None


def _get() -> ctypes.CDLL | None:
    global _lib, _tried, _why
    if not _tried:
        with _lock:
            if not _tried:
                _lib, _why = _build()
                _tried = True
    return _lib


def _enabled() -> bool:
    # consulted per call (cheap env read) so tests can pin the
    # blocked-numpy route with monkeypatch.setenv without reimporting
    env = flags.env_truthy("DISTLEARN_TPU_WIREC")
    return True if env is None else env


def available() -> bool:
    """True when the native backend is compiled, loadable, and enabled."""
    return _enabled() and _get() is not None


def why_unavailable() -> str | None:
    if not _enabled():
        return "disabled via DISTLEARN_TPU_WIREC"
    if _get() is None:
        return _why
    return None


def _f32c(a: np.ndarray) -> bool:
    return a.dtype == np.float32 and a.flags.c_contiguous


def usable_quant(d: np.ndarray, q: np.ndarray, r: np.ndarray) -> bool:
    """Native route preconditions for the fused encode: f32 delta and
    residual, int8 q, all C-contiguous (the kernels take flat views —
    reshape(-1) of a non-contiguous array would silently copy and drop
    the q/r writes)."""
    return (available() and _f32c(d) and _f32c(r)
            and q.dtype == np.int8 and q.flags.c_contiguous)


def usable_apply(t: np.ndarray, wirebuf: np.ndarray,
                 out: np.ndarray) -> bool:
    return (available() and _f32c(t) and _f32c(out)
            and wirebuf.dtype == np.int8 and wirebuf.flags.c_contiguous)


def amax_checked(flat: np.ndarray) -> float:
    """``float(np.max(np.abs(flat)))`` with the reference's non-finite
    convention: returns ``nan`` when any element is inf/NaN (the caller's
    ``isfinite`` gate raises, message unchanged)."""
    lib = _get()
    n = flat.size
    if lib.wirec_bad_f32(flat.ctypes.data, n):
        return float("nan")
    return lib.wirec_amax_f32(flat.ctypes.data, n)


def quant_ef_f32(flat: np.ndarray, st: np.float32, qf: np.ndarray,
                 rf: np.ndarray) -> None:
    """One fused pass: ``qf = rint(flat/st)`` (int8), ``rf = flat -
    qf*st``.  Caller guarantees finite input and ``st != 0``."""
    _get().wirec_quant_ef_f32(flat.ctypes.data, ctypes.c_float(st),
                              qf.ctypes.data, rf.ctypes.data, flat.size)


def dequant_add_f32(tf: np.ndarray, wf: np.ndarray, st: np.float32,
                    of: np.ndarray) -> bool:
    """``of = tf + wf*st`` fused; picks the in-place kernel on exact
    aliasing, refuses (returns False -> caller falls back to numpy) on
    partial overlap, which would break the restrict contract."""
    lib = _get()
    if of.ctypes.data == tf.ctypes.data and of.nbytes == tf.nbytes:
        lib.wirec_dequant_add_inplace_f32(tf.ctypes.data, wf.ctypes.data,
                                          ctypes.c_float(st), tf.size)
        return True
    if np.may_share_memory(tf, of):
        return False
    lib.wirec_dequant_add_f32(tf.ctypes.data, wf.ctypes.data,
                              ctypes.c_float(st), of.ctypes.data, of.size)
    return True
