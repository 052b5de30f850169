"""Single-device attention — counterpart of the local subset of
``distlearn_tpu/parallel/sequence.py``: :func:`local_attention` and its
``impl`` resolution, :func:`resolve_chunk`, :func:`chunked_engages` and
:func:`chunked_causal_attention`, with the same environment switches
(``DISTLEARN_TPU_ATTN``, ``DISTLEARN_TPU_FLASH``, ``DISTLEARN_TPU_CHUNK``)
and the same resolution order.

q, k, v are ``[B, L, H, D]``.  Scores, softmax and the attention's value
sums accumulate in float32 (the JAX code's
``preferred_element_type=float32``); the softmax weights are cast to the
input dtype before the value product, as there.

The ``flash`` impl is kernel B5a (:mod:`distlearn_tpu_torch.ops.
flash_attention`), differentiable through its backward kernels B5b and B5c
(the xla and chunked impls differentiate through PyTorch's autograd): on a
CUDA tensor it launches the hand-written kernels, on a CPU tensor it runs
their plain twins — the one deliberate difference from the JAX package,
which raises off the TPU.  Ring, all-to-all and zigzag attention wait for
ROADMAP A11.
"""

from __future__ import annotations

import math
import os

import torch

from distlearn_tpu_torch.ops.flash_attention import flash_attention
from distlearn_tpu_torch.utils.flags import env_truthy


def resolve_chunk(L: int) -> int:
    """Effective chunk for local length ``L``: ``DISTLEARN_TPU_CHUNK`` when
    set (a positive int, else raises), else ``max(128, L // 32)``."""
    env = os.environ.get("DISTLEARN_TPU_CHUNK")
    if env:
        try:
            c = int(env)
        except ValueError:
            raise ValueError(
                f"DISTLEARN_TPU_CHUNK={env!r} is not an integer") from None
        if c <= 0:
            raise ValueError(
                f"DISTLEARN_TPU_CHUNK={env!r} must be positive")
        return c
    return max(128, L // 32)


def chunked_engages(L: int, chunk: int | None = None) -> bool:
    """Whether the chunked causal path runs at length ``L`` (``L > chunk``
    and ``L % chunk == 0``; otherwise the dispatch falls back to xla)."""
    c = chunk if chunk else resolve_chunk(L)
    return L > c and L % c == 0


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             chunk: int | None = None) -> torch.Tensor:
    """Causal attention with the masked half of the scores never computed:
    query chunk ``i`` attends only to keys ``[0, (i+1)*chunk)``, and only
    the diagonal sub-block is masked."""
    B, L, H, D = q.shape
    if chunk is None:
        chunk = resolve_chunk(L)
    if not chunked_engages(L, chunk):
        return local_attention(q, k, v, causal=True, impl="xla")
    scale = 1.0 / (D ** 0.5)
    pos = torch.arange(chunk, device=q.device)
    diag_mask = pos[:, None] >= pos[None, :]
    outs = []
    for i in range(L // chunk):
        qs = q[:, i * chunk:(i + 1) * chunk]
        parts = []
        if i:
            parts.append(_scores(qs, k[:, :i * chunk], scale))
        s_diag = _scores(qs, k[:, i * chunk:(i + 1) * chunk], scale)
        parts.append(s_diag.masked_fill(~diag_mask, -math.inf))
        s = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
        w = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", w.to(q.dtype).float(),
                                 v[:, :(i + 1) * chunk].float()))
    return torch.cat(outs, dim=1).to(q.dtype)


def _flash_enabled(override: bool | None) -> bool:
    """Priority: explicit arg > ``DISTLEARN_TPU_FLASH`` env > off."""
    if override is not None:
        return bool(override)
    return bool(env_truthy("DISTLEARN_TPU_FLASH"))


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, flash: bool | None = None,
                    impl: str | None = None) -> torch.Tensor:
    """Single-device attention over ``[B, L, H, D]``.  ``impl``: ``"xla"``
    (full ``[B, H, L, L]`` scores), ``"flash"`` (kernel B5a) or
    ``"chunked"`` (:func:`chunked_causal_attention`; xla for non-causal or
    short/ragged L); the gradient flows through all three.  Default
    resolution: the ``flash`` arg, then ``DISTLEARN_TPU_ATTN``, then
    ``DISTLEARN_TPU_FLASH``, then xla.

    Flash engages where the JAX package's does, at ``L >= 128`` and
    ``L % 128 == 0``; elsewhere an explicit request raises and an env
    request falls back to xla.  Where it engages, a head dim the card's
    kernel is not built for raises there
    (:data:`~distlearn_tpu_torch.ops.flash_attention.HEAD_DIMS`)."""
    B, L, H, D = q.shape
    explicit_flash = flash is True or impl == "flash"
    if impl is None:
        if flash is not None:
            impl = "flash" if flash else "xla"
        else:
            impl = os.environ.get("DISTLEARN_TPU_ATTN") \
                or ("flash" if _flash_enabled(None) else "xla")
    if impl not in ("xla", "flash", "chunked"):
        raise ValueError(f"attention impl must be 'xla', 'flash', or "
                         f"'chunked', got {impl!r}")
    if impl == "chunked":
        chunk = resolve_chunk(L)
        if causal and chunked_engages(L, chunk):
            return chunked_causal_attention(q, k, v, chunk=chunk)
        impl = "xla"
    if impl == "flash":
        if L >= 128 and L % 128 == 0:
            return flash_attention(q, k, v, causal=causal)
        if explicit_flash:
            raise ValueError(
                f"flash attention needs seq len a multiple of 128; got "
                f"L={L}. Drop the explicit flash request to use the "
                "portable path.")
    scale = 1.0 / (D ** 0.5)
    scores = _scores(q, k, scale)
    if causal:
        pos = torch.arange(L, device=q.device)
        scores = scores.masked_fill(pos[:, None] < pos[None, :], -math.inf)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(q.dtype).float(), v.float())
    return out.to(q.dtype)
