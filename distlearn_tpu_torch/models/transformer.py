"""Decoder-only transformer LM — counterpart of
``distlearn_tpu/models/transformer.py``, dense single-device path.

The parameter tree keeps the JAX package's einsum layouts, so a checkpoint
or a pushed weight set means the same thing in both packages:

* ``embed``: ``[V, E]`` (tied: the logits are ``x @ embed.T``),
  ``pos``: ``[max_len, E]``, ``out_norm/scale``: ``[E]``;
* per block: ``ln1/scale``, ``ln2/scale``: ``[E]``; ``wq/wk/wv``:
  ``[E, H, D]``; ``wo``: ``[H, D, E]``; ``w1``: ``[E, F]``, ``b1``: ``[F]``,
  ``w2``: ``[F, E]``, ``b2``: ``[E]``.

``dtype`` is the parameter dtype and ``compute_dtype`` the activation
dtype; the weights are cast to it at each use, as the JAX package does.
Attention scores, softmax and the attention's value sums accumulate in
float32 where the JAX code asks for ``preferred_element_type=float32``.

Sequence, tensor and expert parallelism (``seq_axis``, ``tp_axis``,
``ep_axis``), rematerialisation and MoE blocks are LM training's, which
waits for ROADMAP A11: asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from distlearn_tpu_torch.models.core import Model
from distlearn_tpu_torch.parallel.sequence import local_attention
from distlearn_tpu_torch.utils.platform import resolve_device
from distlearn_tpu_torch.utils.tree import tree_leaves, tree_map

PyTree = Any

_A11 = "is LM training's, which waits for ROADMAP A11"


def _not_ported(what: str, value) -> None:
    if value is not None and value is not False and value != 0:
        raise NotImplementedError(f"{what} {_A11}")


def _norm_init(shape, dtype):
    return {"scale": torch.ones(shape, dtype=dtype)}


def _rmsnorm(params, x, eps=1e-6):
    var = x.float().square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * params["scale"].to(x.dtype)


def attn_qkv(blk: PyTree, x: torch.Tensor, cd):
    """Pre-norm + q/k/v projections of one block (``[B, L, H, D]`` each),
    shared by the forward pass, :func:`greedy_generate` and the serving
    engine."""
    h = _rmsnorm(blk["ln1"], x)
    q = torch.einsum("ble,ehd->blhd", h, blk["wq"].to(cd))
    k = torch.einsum("ble,ehd->blhd", h, blk["wk"].to(cd))
    v = torch.einsum("ble,ehd->blhd", h, blk["wv"].to(cd))
    return q, k, v


def attn_out(blk: PyTree, x: torch.Tensor, att: torch.Tensor,
             cd) -> torch.Tensor:
    """Output projection + residual."""
    return x + torch.einsum("blhd,hde->ble", att, blk["wo"].to(cd))


def attn_apply(blk: PyTree, x: torch.Tensor, cd, *, attn_impl=None):
    """Attention half of a block (pre-norm attention residual)."""
    q, k, v = attn_qkv(blk, x, cd)
    att = local_attention(q, k, v, causal=True, impl=attn_impl)
    return attn_out(blk, x, att, cd)


def ffn_apply(blk: PyTree, x: torch.Tensor, cd):
    """Dense FFN half of a block; ``jax.nn.gelu``'s default is the tanh
    approximation."""
    if "router" in blk:
        raise NotImplementedError(f"MoE blocks {_A11}")
    h = _rmsnorm(blk["ln2"], x)
    h = h @ blk["w1"].to(cd) + blk["b1"].to(cd)
    h = F.gelu(h, approximate="tanh")
    h = h @ blk["w2"].to(cd)
    return x + h + blk["b2"].to(cd)


def block_apply(blk: PyTree, x: torch.Tensor, cd, *, attn_impl=None):
    """One transformer block: pre-norm attention, then the FFN residual."""
    return ffn_apply(blk, attn_apply(blk, x, cd, attn_impl=attn_impl), cd)


def _generator(seed) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(int(seed))


def transformer_lm(vocab: int = 256, dim: int = 128, depth: int = 2,
                   heads: int = 4, mlp_ratio: int = 4, max_len: int = 2048,
                   dtype=torch.float32, compute_dtype=None, remat=False,
                   attn_impl: str | None = None, scan_blocks: bool = False,
                   moe_experts: int = 0) -> Model:
    """A :class:`Model` whose ``init(generator, device)`` returns
    ``(params, {})`` and whose ``apply(params, state, tokens)`` maps int
    tokens ``[B, L]`` to next-token logits ``[B, L, vocab]`` in ``dtype``.

    ``init`` takes a ``torch.Generator`` (or an int seed) and draws from
    the JAX package's distributions on the CPU, then moves the tree to
    ``device`` (the card unless ``"cpu"`` is asked for).  Its numbers are
    not JAX's: parity tests carry JAX's params across with
    :func:`distlearn_tpu_torch.models.convert.lm_from_jax`.
    ``scan_blocks=True`` stores the blocks stacked under ``"blocks"``, as
    the JAX package's scanned layout; apply walks them in a loop."""
    _not_ported("remat", remat)
    _not_ported("moe_experts", moe_experts)
    head_dim = dim // heads
    hidden = dim * mlp_ratio
    cd = compute_dtype or dtype

    def init(generator=0, device=None):
        device = resolve_device(device)
        gen = _generator(generator)
        scale = 1.0 / math.sqrt(dim)

        def normal(shape, s=scale):
            return torch.randn(shape, generator=gen, dtype=dtype) * s

        params = {"embed": normal((vocab, dim)),
                  "pos": normal((max_len, dim)),
                  "out_norm": _norm_init((dim,), dtype)}
        for i in range(depth):
            params[f"block{i}"] = {
                "ln1": _norm_init((dim,), dtype),
                "wq": normal((dim, heads, head_dim)),
                "wk": normal((dim, heads, head_dim)),
                "wv": normal((dim, heads, head_dim)),
                "wo": normal((heads, head_dim, dim)),
                "ln2": _norm_init((dim,), dtype),
                "w1": normal((dim, hidden)),
                "b1": torch.zeros((hidden,), dtype=dtype),
                "w2": normal((hidden, dim), 1.0 / math.sqrt(hidden)),
                "b2": torch.zeros((dim,), dtype=dtype),
            }
        params = tree_map(lambda t: t.to(device), params)
        if scan_blocks:
            return stack_block_params(params, depth), {}
        return params, {}

    def apply(params, state, tokens, train=True, rng=None, seq_axis=None,
              tp_axis=None, ep_axis=None):
        _not_ported("seq_axis", seq_axis)
        _not_ported("tp_axis", tp_axis)
        _not_ported("ep_axis", ep_axis)
        embed = params["embed"]
        tokens = torch.as_tensor(tokens, device=embed.device).long()
        L = tokens.shape[1]
        x = embed[tokens].to(cd) + params["pos"][:L].to(cd)[None]
        if "blocks" in params:
            blocks = [tree_map(lambda a, i=i: a[i], params["blocks"])
                      for i in range(depth)]
        else:
            blocks = [params[f"block{i}"] for i in range(depth)]
        for blk in blocks:
            x = block_apply(blk, x, cd, attn_impl=attn_impl)
        x = _rmsnorm(params["out_norm"], x)
        logits = x @ embed.T.to(cd)
        return logits.to(dtype), state

    return Model(init=init, apply=apply, name="transformer_lm",
                 input_shape=(max_len,), num_classes=vocab)


def decode_attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                  live: torch.Tensor, cd) -> torch.Tensor:
    """Cached attention: ``[B, Q, H, D]`` queries against the ``[B, T, H,
    D]`` K/V cache under the boolean ``live`` mask (broadcastable to
    ``[B, H, Q, T]``; dead positions score ``-inf``).  The one home of the
    cached-attention math, shared by :func:`greedy_generate` and the
    serving engine."""
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ck.float())
    s = s * (1.0 / (D ** 0.5))
    s = s.masked_fill(~live, -math.inf)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(cd), cv)


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def generate_params(params: PyTree) -> tuple[PyTree, int]:
    """Normalise a :func:`transformer_lm` tree for decoding: numpy leaves
    become tensors, the scanned layout is unstacked, MoE blocks are
    rejected; returns ``(per_block_params, depth)``."""
    params = tree_map(_as_tensor, params)
    if "blocks" in params:
        d = tree_leaves(params["blocks"])[0].shape[0]
        params = unstack_block_params(params, d)
    depth = sum(1 for k in params if k.startswith("block"))
    for i in range(depth):
        if "router" in params[f"block{i}"]:
            raise ValueError(
                "greedy decoding supports dense blocks only: per-tick "
                "MoE routing computes capacity over ONE token, not the "
                "batch the router trained with (block"
                f"{i} has a router)")
    return params, depth


def greedy_generate(params: PyTree, tokens, steps: int,
                    compute_dtype=None, attn_impl: str | None = None,
                    prompt_lens=None) -> torch.Tensor:
    """KV-cached greedy decoding on the params' device: ``[B, P]`` prompt
    -> ``[B, steps]`` generated ids (int32).  One prefill pass caches every
    block's K/V, then each step computes one position and attends over the
    cache.  ``prompt_lens`` (``[B]``) marks rows LEFT-padded to ``P``, as
    in the JAX package: pads are masked out of every attention and take
    position 0's embedding."""
    params, depth = generate_params(params)
    embed, pos_tab = params["embed"], params["pos"]
    dev = embed.device
    cd = compute_dtype or embed.dtype
    tokens = torch.as_tensor(np.asarray(tokens) if not isinstance(
        tokens, torch.Tensor) else tokens, device=dev).long()
    B, P = tokens.shape
    T = P + steps
    if T > pos_tab.shape[0]:
        raise ValueError(f"prompt + steps = {T} exceeds max_len "
                         f"{pos_tab.shape[0]}")
    cols = torch.arange(P, device=dev)
    if prompt_lens is not None:
        plens = torch.as_tensor(np.asarray(prompt_lens), device=dev) \
            .long().reshape(B)
        pad = (P - plens)[:, None]                       # [B,1]
        x = embed[tokens].to(cd) \
            + pos_tab[torch.clamp(cols[None] - pad, min=0)].to(cd)
    else:
        x = embed[tokens].to(cd) + pos_tab[:P].to(cd)[None]
    caches = []
    for i in range(depth):
        blk = params[f"block{i}"]
        q, k, v = attn_qkv(blk, x, cd)
        ck = torch.zeros((B, T) + tuple(k.shape[2:]), dtype=k.dtype,
                         device=dev)
        cv = torch.zeros_like(ck, dtype=v.dtype)
        ck[:, :P], cv[:, :P] = k, v
        caches.append((ck, cv))
        if prompt_lens is None:
            att = local_attention(q, k, v, causal=True, impl=attn_impl)
        else:
            # causal and key-not-pad; pad queries also see themselves, so
            # their rows stay finite (their K/V never reach a real row)
            mask = ((cols[None, None, None, :] <= cols[None, None, :, None])
                    & (cols[None, :] >= pad)[:, None, None, :]) \
                | torch.eye(P, dtype=torch.bool, device=dev)[None, None]
            att = decode_attend(q, k, v, mask, cd)
        x = attn_out(blk, x, att, cd)
        x = ffn_apply(blk, x, cd)
    x = _rmsnorm(params["out_norm"], x)
    tok = torch.argmax((x[:, -1] @ embed.T.to(cd)).float(), dim=-1)
    out = []
    tcols = torch.arange(T, device=dev)
    for pos in range(P, P + steps):
        out.append(tok)
        if pos == P + steps - 1:
            break
        x = embed[tok].to(cd)[:, None]
        if prompt_lens is None:
            x = x + pos_tab[pos].to(cd)[None, None]
        else:
            x = x + pos_tab[plens + (pos - P)].to(cd)[:, None]
        live = tcols[None, None, None, :] <= pos
        if prompt_lens is not None:
            live = live & (tcols[None, :] >= pad)[:, None, None, :]
        for i in range(depth):
            blk = params[f"block{i}"]
            ck, cv = caches[i]
            q, k1, v1 = attn_qkv(blk, x, cd)
            ck[:, pos], cv[:, pos] = k1[:, 0], v1[:, 0]
            x = attn_out(blk, x, decode_attend(q, ck, cv, live, cd), cd)
            x = ffn_apply(blk, x, cd)
        x = _rmsnorm(params["out_norm"], x)
        tok = torch.argmax((x[:, 0] @ embed.T.to(cd)).float(), dim=-1)
    if not out:
        return torch.zeros((B, 0), dtype=torch.int32, device=dev)
    return torch.stack(out, dim=1).to(torch.int32)


def stack_block_params(params: PyTree, depth: int) -> PyTree:
    """Per-block layout (``block0..``) -> scanned layout (leaves stacked on
    a leading ``[depth]`` axis under ``"blocks"``)."""
    blocks = [params[f"block{i}"] for i in range(depth)]
    out = {k: v for k, v in params.items() if not k.startswith("block")}
    out["blocks"] = tree_map(lambda *xs: torch.stack(xs), *blocks)
    return out


def unstack_block_params(params: PyTree, depth: int) -> PyTree:
    """Inverse of :func:`stack_block_params`."""
    out = {k: v for k, v in params.items() if k != "blocks"}
    for i in range(depth):
        out[f"block{i}"] = tree_map(lambda a, i=i: a[i], params["blocks"])
    return out
