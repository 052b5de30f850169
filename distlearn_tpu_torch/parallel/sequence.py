"""Attention, local and sequence-parallel — counterpart of
``distlearn_tpu/parallel/sequence.py``: :func:`local_attention` and its
``impl`` resolution, :func:`resolve_chunk`, :func:`chunked_engages` and
:func:`chunked_causal_attention`, with the same environment switches
(``DISTLEARN_TPU_ATTN``, ``DISTLEARN_TPU_FLASH``, ``DISTLEARN_TPU_CHUNK``)
and the same resolution order; and over a sequence axis of a
:class:`~distlearn_tpu_torch.parallel.mesh.Mesh`, :func:`ring_attention`
(K/V rotating ``n - 1`` times through ``ppermute``, float32 online
softmax; the zigzag layout of :func:`zigzag_indices` for causal balance)
and :func:`alltoall_attention` (Ulysses: two all-to-alls swap sequence
shards for head shards around :func:`local_attention`).

q, k, v are ``[B, L, H, D]``.  Scores, softmax and the attention's value
sums accumulate in float32 (the JAX code's
``preferred_element_type=float32``); the softmax weights are cast to the
input dtype before the value product, as there.

The ``flash`` impl is kernel B5a (:mod:`distlearn_tpu_torch.ops.
flash_attention`), differentiable through its backward kernels B5b and B5c
(the xla and chunked impls differentiate through PyTorch's autograd): on a
CUDA tensor it launches the hand-written kernels, on a CPU tensor it runs
their plain twins — the one deliberate difference from the JAX package,
which raises off the TPU.  Ring attention's blocks are plain PyTorch
(:func:`_block_attn`), as they are plain XLA in the JAX package; Ulysses
runs :func:`local_attention` on its head shard, so an engaged flash impl
launches B5a, B5b and B5c there.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from distlearn_tpu_torch.ops.flash_attention import flash_attention
from distlearn_tpu_torch.parallel.mesh import MeshAxis, all_to_all, ppermute
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


# ---------------------------------------------------------------------------
# Over a sequence axis
# ---------------------------------------------------------------------------

def _block_attn(q, k, v, scale, mask):
    """Scores and masked online-softmax partials of one K/V block: q
    ``[B, Lq, H, D]``, k/v ``[B, Lk, H, D]``, mask ``[Lq, Lk]`` bool or
    None; returns ``(m [B,H,Lq], l [B,H,Lq], o [B,H,Lq,D])`` in float32.
    A fully masked row keeps m = 0 and zero partials."""
    scores = _scores(q, k, scale)
    if mask is not None:
        scores = scores.masked_fill(~mask, -math.inf)
    m_blk = scores.amax(-1)
    m_safe = torch.where(torch.isneginf(m_blk), torch.zeros_like(m_blk),
                         m_blk)
    s_exp = torch.exp(scores - m_safe[..., None])
    s_exp = s_exp.masked_fill(torch.isneginf(scores), 0.0)
    o_blk = torch.einsum("bhqk,bkhd->bhqd", s_exp.to(v.dtype).float(),
                         v.float())
    return m_safe, s_exp.sum(-1), o_blk


def _merge_blocks(acc, blk):
    """Online-softmax merge of two blockwise partials ``(m, l, o)``."""
    m, l, o = acc
    mb, lb, ob = blk
    m_new = torch.maximum(m, mb)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(mb - m_new)
    return (m_new, l * alpha + lb * beta,
            o * alpha[..., None] + ob * beta[..., None])


def _finish(acc, dtype):
    """``o / l`` of a merged partial, back to ``[B, L, H, D]`` in dtype."""
    _, l, o = acc
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(dtype)


def _ring_perm(n: int) -> list:
    return [(j, (j + 1) % n) for j in range(n)]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis: MeshAxis, causal: bool = False,
                   impl: str | None = None,
                   layout: str = "contig") -> torch.Tensor:
    """Blockwise ring attention over the sequence ``axis``.

    q/k/v are this rank's ``[B, L_local, H, D]`` shards of a global
    sequence laid out in rank order (``layout="contig"``) or by
    :func:`zigzag_indices` (``"zigzag"``, with ``causal``: the balanced
    schedule that never computes a fully masked block).  ``impl`` is
    honoured only when the axis has one rank (then the whole sequence is
    local and :func:`local_attention` runs); otherwise each block is
    :func:`_block_attn`.  K and V rotate ``n - 1`` times; the JAX package's
    last rotation, whose result nothing reads, is not made.  Returns the
    local output ``[B, L_local, H, D]`` in q's dtype."""
    if layout not in ("contig", "zigzag"):
        raise ValueError(f"layout must be 'contig' or 'zigzag', "
                         f"got {layout!r}")
    n = axis.size
    if layout == "zigzag" and causal and n > 1:
        if q.shape[1] % 2:
            raise ValueError(
                f"zigzag layout needs an even local length (two stripes "
                f"per rank), got {q.shape[1]}")
        return _zigzag_ring_causal(q, k, v, axis)
    if n == 1:
        return local_attention(q, k, v, causal=causal, impl=impl)
    my = axis.index
    B, Lq, H, D = q.shape
    scale = 1.0 / (D ** 0.5)
    q_pos = my * Lq + torch.arange(Lq, device=q.device)
    acc = (torch.full((B, H, Lq), -math.inf, device=q.device),
           torch.zeros((B, H, Lq), device=q.device),
           torch.zeros((B, H, Lq, D), device=q.device))
    k_cur, v_cur = k, v
    perm = _ring_perm(n)
    for i in range(n):
        src = (my - i) % n
        mask = None
        if causal:
            k_pos = src * Lq + torch.arange(Lq, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
        acc = _merge_blocks(acc, _block_attn(q, k_cur, v_cur, scale, mask))
        if i < n - 1:
            k_cur = ppermute(k_cur, axis, perm)
            v_cur = ppermute(v_cur, axis, perm)
    return _finish(acc, q.dtype)


def zigzag_indices(n: int, L: int) -> np.ndarray:
    """Global-position permutation of the zigzag layout: the sequence
    splits into ``2n`` stripes and rank ``r`` holds stripes ``r`` and
    ``2n-1-r``; ``x[..., idx]`` is the layout whose rank-order shards are
    the zigzag shards (invert with ``np.argsort(idx)``)."""
    if L % (2 * n):
        raise ValueError(f"sequence length {L} must divide into 2*n={2*n} "
                         "equal zigzag stripes")
    s = L // (2 * n)
    idx = []
    for r in range(n):
        idx.extend(range(r * s, (r + 1) * s))
        idx.extend(range((2 * n - 1 - r) * s, (2 * n - r) * s))
    return np.asarray(idx, np.int32)


def _select(pred: bool, a, b):
    """``a`` where pred else ``b``, with both kept in the autograd graph."""
    return torch.where(torch.tensor(pred, device=a.device), a, b)


def _zigzag_ring_causal(q, k, v, axis: MeshAxis):
    """Causal ring attention on the zigzag layout (local shard = early
    stripe ``a = my`` ++ late stripe ``b = 2n-1-my``): every hop computes
    two unmasked stripe blocks on every rank — late queries against the
    early stripe of ``src``, and early queries against it when ``src <
    my``, else late queries against ``src``'s late stripe.  Hop 0 takes
    the two causal diagonals and the local late-by-early block.

    The conditional block selects its operands and its accumulator with
    ``torch.where``, as the JAX package does, rather than branching: every
    rank then records the same graph, so the backward pass runs the
    ppermutes' transposes in the same order on every rank."""
    n, my = axis.size, axis.index
    B, L2, H, D = q.shape
    s = L2 // 2
    scale = 1.0 / (D ** 0.5)
    ar = torch.arange(s, device=q.device)
    tri = ar[:, None] >= ar[None, :]
    qa, qb = q[:, :s], q[:, s:]
    ka, kb = k[:, :s], k[:, s:]
    va, vb = v[:, :s], v[:, s:]
    acc_a = _block_attn(qa, ka, va, scale, tri)
    acc_b = _merge_blocks(_block_attn(qb, ka, va, scale, None),
                          _block_attn(qb, kb, vb, scale, tri))
    perm = _ring_perm(n)
    kc, vc, kd, vd = (ppermute(t, axis, perm) for t in (ka, va, kb, vb))
    for i in range(1, n):
        pred = (my - i) % n < my
        acc_b = _merge_blocks(acc_b, _block_attn(qb, kc, vc, scale, None))
        blk = _block_attn(_select(pred, qa, qb), _select(pred, kc, kd),
                          _select(pred, vc, vd), scale, None)
        new_a, new_b = _merge_blocks(acc_a, blk), _merge_blocks(acc_b, blk)
        acc_a = tuple(_select(pred, x, y) for x, y in zip(new_a, acc_a))
        acc_b = tuple(_select(pred, y, x) for x, y in zip(new_b, acc_b))
        if i < n - 1:
            kc, vc, kd, vd = (ppermute(t, axis, perm)
                              for t in (kc, vc, kd, vd))
    return torch.cat([_finish(acc_a, q.dtype), _finish(acc_b, q.dtype)],
                     dim=1)


def alltoall_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       axis: MeshAxis, causal: bool = False,
                       impl: str | None = None) -> torch.Tensor:
    """All-to-all (Ulysses) sequence parallelism: an all-to-all swaps the
    sequence shards ``[B, L_local, H, D]`` for head shards ``[B, L, H/n,
    D]``, :func:`local_attention` runs on the whole sequence (flash when
    ``impl`` engages it), and a second all-to-all swaps back.  Needs the
    head count divisible by the axis size."""
    n = axis.size
    if n == 1:
        return local_attention(q, k, v, causal=causal, impl=impl)
    H = q.shape[2]
    if H % n:
        raise ValueError(
            f"alltoall_attention needs head count divisible by the "
            f"sequence-axis size, got {H} heads over {n} devices; use "
            "ring_attention for this configuration")
    qh, kh, vh = (all_to_all(t, axis, 2, 1) for t in (q, k, v))
    out = local_attention(qh, kh, vh, causal=causal, impl=impl)
    return all_to_all(out, axis, 1, 2)
