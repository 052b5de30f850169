"""Flash-attention forward (kernel B5a) — the counterpart of the Pallas TPU
kernel that ``distlearn_tpu/parallel/sequence.py::local_attention`` reaches
with ``impl="flash"`` (the library's ``_flash_attention_kernel`` in
``jax/experimental/pallas/ops/tpu/flash_attention.py``), hand-written in
CUDA for Hopper in ``ops/csrc/flash_attention.cu``.

:func:`flash_attention` dispatches on its tensors' device: a CUDA tensor
launches the kernel (or the wrapper raises), a CPU tensor takes the plain
PyTorch version beside it, :func:`flash_attention_plain`, which does the
same blockwise online softmax and is the kernel's oracle on the card.
There is no fallback from one to the other.  The wrapper counts its kernel
launches in ``flash_attention.launches``.

Both take q, k, v as ``[B, L, H, D]`` (the port's layout) and return o in
that layout and q's dtype: scores are float32 sums of the input-dtype
products, then scaled; the running max, sum and accumulator are float32;
for bfloat16 inputs P is rounded to bfloat16 before the PV product, as the
Pallas kernel's ``p.astype(v.dtype)`` does.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from distlearn_tpu_torch.ops import _build

_SOURCE = "flash_attention.cu"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURE = (_P, _P, _P, _P, _I, _I, _I, _I, _I, *(_L,) * 12,
              ctypes.c_float, _I, _P)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is built for; the plain version takes any
HEAD_DIMS = (32, 64, 128)
#: query rows per block and key rows per tile, in the kernel and the plain
#: version alike
BLOCK = 64

#: guards the launch count: server threads and callers may share the wrapper
_COUNT_LOCK = threading.Lock()


def _shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("flash_attention: q, k and v must be [B, L, H, D] "
                         f"of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return q.shape


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: key tiles of ``BLOCK`` rows,
    online softmax with float32 running max, sum and accumulator, scores
    scaled by ``1/sqrt(D)``.  Tiles wholly above a row's diagonal change
    nothing for it (P = 0, the rescale is 1), so computing them matches the
    kernel's causal skip."""
    B, L, H, D = _shapes(q, k, v)
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf = (t.permute(0, 2, 1, 3).float() for t in (q, k, v))
    m = torch.full((B, H, L, 1), -math.inf, device=q.device)
    l = torch.zeros((B, H, L, 1), device=q.device)
    acc = torch.zeros((B, H, L, D), device=q.device)
    rows = torch.arange(L, device=q.device)[:, None]
    for k0 in range(0, L, BLOCK):
        s = (qf @ kf[:, :, k0:k0 + BLOCK].transpose(-1, -2)) * scale
        if causal:
            cols = torch.arange(k0, min(k0 + BLOCK, L), device=q.device)
            s = s.masked_fill(cols[None, :] > rows, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vf[:, :, k0:k0 + BLOCK]
        m = m_new
    return (acc / l).to(q.dtype).permute(0, 2, 1, 3).contiguous()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the kernel takes; anything else raises.  The shape comes first,
    so a head dim the kernel lacks is named even where no card is."""
    B, L, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if L % BLOCK:
        raise ValueError(f"flash_attention: L={L} is not a multiple of "
                         f"{BLOCK}")
    for t in (q, k, v):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError("flash_attention: q, k and v must be on one "
                             f"CUDA device, got {[str(u.device) for u in (q, k, v)]}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError("flash_attention: float32 or bfloat16 inputs of "
                            f"one dtype, got {[u.dtype for u in (q, k, v)]}")
        if t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError("flash_attention: the D axis must be contiguous, "
                             "the other strides multiples of 4 and the data "
                             f"16-byte aligned, got strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """``softmax(q k^T / sqrt(D), causal) v`` over ``[B, L, H, D]``
    tensors.  One kernel launch on the card, the plain version on the
    CPU."""
    B, L, H, D = _shapes(q, k, v)
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    _check(q, k, v)
    o = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    rc = _build.function(_SOURCE, "dl_flash_fwd", _SIGNATURE)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPE_CODES[q.dtype], B, L, H, D, *strides, 1.0 / math.sqrt(D),
        int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc < 0:
        raise RuntimeError(
            f"flash_attention: CUDA launch failed with cudaError {-rc}")
    with _COUNT_LOCK:
        flash_attention.launches += rc
    return o


flash_attention.launches = 0
