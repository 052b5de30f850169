"""Flash attention and its gradient (kernels B5a, B5b, B5c) — the
counterpart of the Pallas TPU kernels that
``distlearn_tpu/parallel/sequence.py::local_attention`` reaches with
``impl="flash"`` and its derivative (the library's
``_flash_attention_kernel``, ``_flash_attention_dkv_kernel`` and
``_flash_attention_dq_kernel`` in
``jax/experimental/pallas/ops/tpu/flash_attention.py``), hand-written in
CUDA for Hopper in ``ops/csrc/flash_attention.cu``: in bfloat16 all three
run on the tensor cores (``mma.sync``); in float32 all three
(``flash_fwd_tf32x3``, ``flash_bwd_dkv_tf32x3``, ``flash_bwd_dq_tf32x3``)
take P V and the gradient products on the tensor cores in 3xTF32 (every
product split into two TF32 parts and taken in three passes, which keeps
float32's accuracy) and the scores on the CUDA cores, one fmaf chain an
element, so that B5b and B5c recompute P from exactly the scores B5a took
m and l over.

* :func:`flash_attention` — ``softmax(q k^T / sqrt(D), causal) v``; when a
  gradient is wanted it goes through :class:`FlashAttention`, whose forward
  is B5a with its softmax statistics m and l saved, and whose backward is
  B5c (dQ, with ``di = sum(o * dO)`` in its prologue) then B5b (dK, dV).
* :func:`flash_attention_fwd` (B5a with residuals), :func:`flash_attention_dq`
  (B5c) and :func:`flash_attention_dkv` (B5b): the three kernel wrappers.

Every wrapper dispatches on its tensors' device: a CUDA tensor launches the
kernel (or the wrapper raises), a CPU tensor takes the plain PyTorch twin
beside it (:func:`flash_attention_fwd_plain`, :func:`flash_attention_dq_plain`
with :func:`flash_attention_di_plain`, :func:`flash_attention_dkv_plain`),
which walks the same 64-row tiles with the same roundings and is the
kernel's oracle on the card.  There is no fallback from one to the other.
Each wrapper counts its kernel launches in ``<wrapper>.launches`` (B5a's
in ``flash_attention.launches``, whichever wrapper launched it).

All take ``[B, L, H, D]`` tensors (the port's layout) and return them in
that layout and q's dtype; m, l and di are float32 ``[B, H, L]``.  Scores
and ``dO v^T`` are float32 sums of the input-dtype products, then scaled;
every accumulator is float32; for bfloat16 inputs P is rounded to bfloat16
before the products with v and dO, and dS before those with q and k, as
the Pallas kernels' ``astype`` calls do.  The twins accumulate in float64
for float64 inputs, which only the tests use (``gradcheck``).
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from distlearn_tpu_torch.ops import _build

_SOURCE = "flash_attention.cu"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    "dl_flash_fwd": (*(_P,) * 6, *(_I,) * 5, *(_L,) * 12, _F, _I, _P),
    "dl_flash_bwd_dq": (*(_P,) * 9, *(_I,) * 5, *(_L,) * 18, _F, _I, _P),
    "dl_flash_bwd_dkv": (*(_P,) * 9, *(_I,) * 5, *(_L,) * 18, _F, _I, _P),
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernels are built for; the plain versions take any
HEAD_DIMS = (32, 64, 128)
#: rows of every tile, in the kernels and the plain versions alike
BLOCK = 64

#: guards the launch counts: server threads and callers may share wrappers
_COUNT_LOCK = threading.Lock()


def _shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("flash_attention: q, k and v must be [B, L, H, D] "
                         f"of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return q.shape


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _heads_first(acc, *tensors):
    """``[B, L, H, D]`` -> ``[B, H, L, D]`` in the accumulation dtype."""
    return [t.permute(0, 2, 1, 3).to(acc) for t in tensors]


def _causal_mask(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """True where key column ``cols`` lies above query row ``rows``."""
    return cols[None, :] > rows[:, None]


# ---------------------------------------------------------------------------
# The plain twins
# ---------------------------------------------------------------------------

def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True):
    """B5a's arithmetic in PyTorch: key tiles of ``BLOCK`` rows, online
    softmax with float32 running max m, sum l and accumulator, scores
    scaled by ``1/sqrt(D)``.  Tiles wholly above a row's diagonal change
    nothing for it (P = 0, the rescale is 1), so computing them matches the
    kernel's causal skip.  Returns ``(o, m, l)``, m and l ``[B, H, L]``."""
    B, L, H, D = _shapes(q, k, v)
    acc_t = _acc_dtype(q.dtype)
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf = _heads_first(acc_t, q, k, v)
    m = torch.full((B, H, L, 1), -math.inf, dtype=acc_t, device=q.device)
    l = torch.zeros((B, H, L, 1), dtype=acc_t, device=q.device)
    acc = torch.zeros((B, H, L, D), dtype=acc_t, device=q.device)
    rows = torch.arange(L, device=q.device)
    for k0 in range(0, L, BLOCK):
        s = (qf @ kf[:, :, k0:k0 + BLOCK].transpose(-1, -2)) * scale
        if causal:
            cols = torch.arange(k0, min(k0 + BLOCK, L), device=q.device)
            s = s.masked_fill(_causal_mask(rows, cols), -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).to(acc_t) @ vf[:, :, k0:k0 + BLOCK]
        m = m_new
    o = (acc / l).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    return o, m[..., 0].contiguous(), l[..., 0].contiguous()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The output of :func:`flash_attention_fwd_plain`."""
    return flash_attention_fwd_plain(q, k, v, causal)[0]


def flash_attention_di_plain(o: torch.Tensor, do: torch.Tensor
                             ) -> torch.Tensor:
    """``di = sum_D o * dO`` in float32, ``[B, H, L]`` (the library's plain
    XLA pre-pass; B5c computes it in its prologue)."""
    acc = _acc_dtype(o.dtype)
    return (o.to(acc) * do.to(acc)).sum(-1).permute(0, 2, 1).contiguous()


def _p_and_ds(s, dp, m, inv_l, di, scale, mask):
    """P = exp(s - m) * (1/l) and dS = (dP - di) * P * scale on one tile,
    zero where ``mask`` is set (the library adds a large negative there,
    which gives exactly 0)."""
    p = torch.exp(s * scale - m) * inv_l
    if mask is not None:
        p = p.masked_fill(mask, 0.0)
    return p, (dp - di) * p * scale


def flash_attention_dkv_plain(q, k, v, do, m, l, di, causal: bool = True):
    """B5b's arithmetic: for every 64-row query tile in order, P and dS
    recomputed against all keys, then ``dV += P^T dO`` and ``dK += dS^T q``
    accumulated in float32, with P and dS rounded to the input dtype
    before their products.  Query tiles below a key tile's diagonal give it
    exactly zero, so computing them matches the kernel's causal skip.
    Returns ``(dk, dv)`` in q's dtype."""
    B, L, H, D = _shapes(q, k, v)
    acc_t = _acc_dtype(q.dtype)
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, dof = _heads_first(acc_t, q, k, v, do)
    m, inv_l, di = m[..., None], (1.0 / l)[..., None], di[..., None]
    dk = torch.zeros((B, H, L, D), dtype=acc_t, device=q.device)
    dv = torch.zeros_like(dk)
    cols = torch.arange(L, device=q.device)
    for q0 in range(0, L, BLOCK):
        r = slice(q0, q0 + BLOCK)
        mask = _causal_mask(cols[r], cols) if causal else None
        p, ds = _p_and_ds(qf[:, :, r] @ kf.transpose(-1, -2),
                          dof[:, :, r] @ vf.transpose(-1, -2),
                          m[:, :, r], inv_l[:, :, r], di[:, :, r], scale,
                          mask)
        dv += p.to(q.dtype).to(acc_t).transpose(-1, -2) @ dof[:, :, r]
        dk += ds.to(q.dtype).to(acc_t).transpose(-1, -2) @ qf[:, :, r]
    return tuple(t.to(q.dtype).permute(0, 2, 1, 3).contiguous()
                 for t in (dk, dv))


def flash_attention_dq_plain(q, k, v, do, m, l, di, causal: bool = True):
    """B5c's arithmetic: for every 64-row key tile in order, P and dS
    recomputed for all queries, then ``dQ += dS k`` in float32, dS rounded
    to the input dtype first.  Key tiles above a query tile's diagonal give
    it exactly zero.  Returns dq in q's dtype."""
    B, L, H, D = _shapes(q, k, v)
    acc_t = _acc_dtype(q.dtype)
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, dof = _heads_first(acc_t, q, k, v, do)
    m, inv_l, di = m[..., None], (1.0 / l)[..., None], di[..., None]
    dq = torch.zeros((B, H, L, D), dtype=acc_t, device=q.device)
    rows = torch.arange(L, device=q.device)
    for k0 in range(0, L, BLOCK):
        c = slice(k0, k0 + BLOCK)
        mask = _causal_mask(rows, rows[c]) if causal else None
        _, ds = _p_and_ds(qf @ kf[:, :, c].transpose(-1, -2),
                          dof @ vf[:, :, c].transpose(-1, -2),
                          m, inv_l, di, scale, mask)
        dq += ds.to(q.dtype).to(acc_t) @ kf[:, :, c]
    return dq.to(q.dtype).permute(0, 2, 1, 3).contiguous()


# ---------------------------------------------------------------------------
# The kernel wrappers
# ---------------------------------------------------------------------------

def _check(q: torch.Tensor, *rest: torch.Tensor) -> None:
    """What the kernels take; anything else raises.  The shape comes first,
    so a head dim the kernels lack is named even where no card is."""
    B, L, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if L % BLOCK:
        raise ValueError(f"flash_attention: L={L} is not a multiple of "
                         f"{BLOCK}")
    tensors = (q, *rest)
    for t in tensors:
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError("flash_attention: every tensor must be on one "
                             "CUDA device, got "
                             f"{[str(u.device) for u in tensors]}")
        if t.shape != q.shape:
            raise ValueError(f"flash_attention: shapes differ, "
                             f"{[tuple(u.shape) for u in tensors]}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError("flash_attention: float32 or bfloat16 inputs of "
                            f"one dtype, got {[u.dtype for u in tensors]}")
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                s * t.element_size() % 16 for s in t.stride()[:3]):
            raise ValueError("flash_attention: the D axis must be contiguous, "
                             "the other strides multiples of 16 bytes and "
                             f"the data 16-byte aligned, got strides "
                             f"{t.stride()}")


def _check_stats(q: torch.Tensor, *stats: torch.Tensor) -> None:
    B, L, H, _ = q.shape
    for t in stats:
        if t.shape != (B, H, L) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError("flash_attention: m, l and di must be float32 "
                             f"[B, H, L] = {(B, H, L)}, contiguous on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")


def _stats(q: torch.Tensor, n: int) -> list[torch.Tensor]:
    B, L, H, _ = q.shape
    return [torch.empty((B, H, L), dtype=torch.float32, device=q.device)
            for _ in range(n)]


def _launch(name: str, q: torch.Tensor, pointers, strided, causal: bool,
            counter) -> None:
    """Call the C entry point ``name`` on q's stream and count the launch;
    ``strided`` are the [B, L, H, D] tensors whose (batch, row, head)
    strides follow the shape."""
    B, L, H, D = q.shape
    rc = _build.function(_SOURCE, name, _SIGNATURES[name])(
        *(t.data_ptr() if t is not None else None for t in pointers),
        _DTYPE_CODES[q.dtype], B, L, H, D,
        *(s for t in strided for s in t.stride()[:3]),
        1.0 / math.sqrt(D), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc < 0:
        raise RuntimeError(
            f"flash_attention: {name} launch failed with cudaError {-rc}")
    with _COUNT_LOCK:
        counter.launches += rc


def _forward(q, k, v, causal: bool, residuals: bool):
    """B5a: ``o``, or ``(o, m, l)`` with ``residuals``."""
    if _on_cpu(q, k, v):
        out = flash_attention_fwd_plain(q, k, v, causal)
        return out if residuals else out[0]
    _shapes(q, k, v)
    _check(q, k, v)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    m, l = _stats(q, 2) if residuals else (None, None)
    _launch("dl_flash_fwd", q, (q, k, v, o, m, l), (q, k, v, o), causal,
            flash_attention)
    return (o, m, l) if residuals else o


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True):
    """B5a with its residuals: ``(o, m, l)``; m is the row max of the
    scaled scores and l the row sum of ``exp(s - m)``, float32
    ``[B, H, L]``."""
    return _forward(q, k, v, causal, residuals=True)


def flash_attention_dq(q, k, v, o, do, m, l, causal: bool = True):
    """B5c: ``(dq, di)``, one launch on the card (di from its prologue)."""
    _shapes(q, k, v)
    if _on_cpu(q, k, v, o, do, m, l):
        di = flash_attention_di_plain(o, do)
        return flash_attention_dq_plain(q, k, v, do, m, l, di, causal), di
    _check(q, k, v, o, do)
    _check_stats(q, m, l)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    (di,) = _stats(q, 1)
    _launch("dl_flash_bwd_dq", q, (q, k, v, o, do, m, l, dq, di),
            (q, k, v, o, do, dq), causal, flash_attention_dq)
    return dq, di


def flash_attention_dkv(q, k, v, do, m, l, di, causal: bool = True):
    """B5b: ``(dk, dv)``, one launch on the card."""
    _shapes(q, k, v)
    if _on_cpu(q, k, v, do, m, l, di):
        return flash_attention_dkv_plain(q, k, v, do, m, l, di, causal)
    _check(q, k, v, do)
    _check_stats(q, m, l, di)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _launch("dl_flash_bwd_dkv", q, (q, k, v, do, m, l, di, dk, dv),
            (q, k, v, do, dk, dv), causal, flash_attention_dkv)
    return dk, dv


def flash_attention_bwd(q, k, v, o, m, l, do, causal: bool = True):
    """``(dq, dk, dv)``: B5c, then B5b with the di it wrote."""
    dq, di = flash_attention_dq(q, k, v, o, do, m, l, causal)
    dk, dv = flash_attention_dkv(q, k, v, do, m, l, di, causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is B5a (saving q, k, v, o, m and l) and whose
    backward is B5c and B5b — the port's ``jax.custom_vjp`` of the library
    ``flash_attention``.  On CPU tensors both sides run the twins."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, m, l = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, m, l, do.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """``softmax(q k^T / sqrt(D), causal) v`` over ``[B, L, H, D]``
    tensors.  Differentiable through :class:`FlashAttention` when a
    gradient is wanted; otherwise one B5a launch without residuals on the
    card, the plain twin on the CPU."""
    _shapes(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal, residuals=False)


flash_attention.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
