"""Decoder-only transformer LM — counterpart of
``distlearn_tpu/models/transformer.py``.

The parameter tree keeps the JAX package's einsum layouts, so a checkpoint
or a pushed weight set means the same thing in both packages:

* ``embed``: ``[V, E]`` (tied: the logits are ``x @ embed.T``),
  ``pos``: ``[max_len, E]``, ``out_norm/scale``: ``[E]``;
* per block: ``ln1/scale``, ``ln2/scale``: ``[E]``; ``wq/wk/wv``:
  ``[E, H, D]``; ``wo``: ``[H, D, E]``; a dense FFN's ``w1``: ``[E, F]``,
  ``b1``: ``[F]``, ``w2``: ``[F, E]``, ``b2``: ``[E]``; a MoE block's
  ``router``: ``[E, X]``, ``we1``: ``[X, E, F]``, ``wb1``: ``[X, F]``,
  ``we2``: ``[X, F, E]`` for X experts.

``dtype`` is the parameter dtype and ``compute_dtype`` the activation
dtype; the weights are cast to it at each use, as the JAX package does.
Attention scores, softmax and the attention's value sums accumulate in
float32 where the JAX code asks for ``preferred_element_type=float32``.

Over a :class:`~distlearn_tpu_torch.parallel.mesh.Mesh` (passed as
``mesh=``; JAX's ambient ``shard_map`` axes have no counterpart here)
``apply`` and :func:`lm_loss` take this rank's shard of the tree
(:func:`param_specs`, ``models/convert.py::lm_shard``) and the axis names:
``tp_axis`` splits heads and the MLP hidden (Megatron, the f/g pair of
``parallel/tp.py`` around each half of a dense block), ``seq_axis`` the
sequence (ring or Ulysses attention, ``seq_impl``; the zigzag layout with
``seq_layout="zigzag"``), ``ep_axis`` the experts of MoE blocks (one a
rank, two all-to-alls, ``parallel/ep.py``).

``remat`` recomputes activations in the backward pass
(``torch.utils.checkpoint``); :func:`lm_loss` is the next-token objective
that ``train/lm.py`` differentiates.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from distlearn_tpu_torch.models.core import Model
from distlearn_tpu_torch.parallel.ep import moe_ffn, moe_ffn_local
from distlearn_tpu_torch.parallel.mesh import (MeshAxis, ppermute, psum,
                                               psum_raw)
from distlearn_tpu_torch.parallel.sequence import (alltoall_attention,
                                                   local_attention,
                                                   ring_attention)
from distlearn_tpu_torch.parallel.tp import tp_enter, tp_reduce
from distlearn_tpu_torch.utils.platform import resolve_device
from distlearn_tpu_torch.utils.tree import tree_leaves, tree_map

PyTree = Any

#: the MoE blocks' expert-stacked leaves
EXPERT_LEAVES = ("we1", "wb1", "we2")


def _norm_init(shape, dtype):
    return {"scale": torch.ones(shape, dtype=dtype)}


def _rmsnorm(params, x, eps=1e-6):
    var = x.float().square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * params["scale"].to(x.dtype)


def attn_qkv(blk: PyTree, x: torch.Tensor, cd, tp: MeshAxis | None = None):
    """Pre-norm + q/k/v projections of one block (``[B, L, H, D]`` each,
    H this rank's heads under ``tp``), shared by the forward pass,
    :func:`greedy_generate` and the serving engine."""
    h = _rmsnorm(blk["ln1"], x)
    if tp is not None:            # enter the column-parallel region ("f")
        h = tp_enter(h, tp)
    q = torch.einsum("ble,ehd->blhd", h, blk["wq"].to(cd))
    k = torch.einsum("ble,ehd->blhd", h, blk["wk"].to(cd))
    v = torch.einsum("ble,ehd->blhd", h, blk["wv"].to(cd))
    return q, k, v


def attn_out(blk: PyTree, x: torch.Tensor, att: torch.Tensor,
             cd, tp: MeshAxis | None = None) -> torch.Tensor:
    """Output projection + residual."""
    proj = torch.einsum("blhd,hde->ble", att, blk["wo"].to(cd))
    if tp is not None:            # the heads were sharded: reduce ("g")
        proj = tp_reduce(proj, tp)
    return x + proj


def attn_apply(blk: PyTree, x: torch.Tensor, cd, *, seq_attn=None,
               seq: MeshAxis | None = None, tp: MeshAxis | None = None,
               attn_impl=None):
    """Attention half of a block (pre-norm attention residual) on this
    rank's shard; ``seq_attn(q, k, v, seq, causal=, impl=)`` runs it over
    the sequence axis ``seq``."""
    q, k, v = attn_qkv(blk, x, cd, tp)
    if seq is not None:
        att = seq_attn(q, k, v, seq, causal=True, impl=attn_impl)
    else:
        att = local_attention(q, k, v, causal=True, impl=attn_impl)
    return attn_out(blk, x, att, cd, tp)


def _expert(cd):
    def expert(p, t):
        u = F.gelu(t @ p["we1"].to(cd) + p["wb1"].to(cd), approximate="tanh")
        return u @ p["we2"].to(cd)
    return expert


def ffn_apply(blk: PyTree, x: torch.Tensor, cd, *,
              tp: MeshAxis | None = None, ep: MeshAxis | None = None,
              moe_capacity_factor: float = 1.25, moe_top_k: int = 1,
              return_moe_aux: bool = False):
    """FFN half of a block: dense (``jax.nn.gelu``'s default, the tanh
    approximation; hidden split over ``tp``), or routed MoE when the
    block has a router (all experts here, or one a rank of ``ep``; MoE
    blocks ignore ``tp``).  ``return_moe_aux`` (MoE blocks only) returns
    ``(x, aux)`` with :func:`~distlearn_tpu_torch.parallel.ep.route_topk`'s
    aux dict."""
    h = _rmsnorm(blk["ln2"], x)
    if "router" in blk:
        Bq, Lq, Dq = h.shape
        flat = h.reshape(Bq * Lq, Dq)
        eparams = {n: blk[n] for n in EXPERT_LEAVES}
        if ep is None:
            y = moe_ffn_local(_expert(cd), eparams, blk["router"], flat,
                              moe_capacity_factor, top_k=moe_top_k,
                              return_aux=return_moe_aux)
        else:
            n_local = blk["we1"].shape[0]
            if n_local != 1:
                raise ValueError(
                    f"stacked expert leaves hold {n_local} shards on this "
                    "device; expected exactly one per device on ep_axis")
            local = {n: t[0] for n, t in eparams.items()}
            y = moe_ffn(_expert(cd), local, blk["router"], flat,
                        moe_capacity_factor, axis=ep, top_k=moe_top_k,
                        return_aux=return_moe_aux)
        if return_moe_aux:
            y, aux = y
            return x + y.reshape(Bq, Lq, Dq).to(x.dtype), aux
        return x + y.reshape(Bq, Lq, Dq).to(x.dtype)
    if return_moe_aux:
        raise ValueError("return_moe_aux=True on a dense block (no router)")
    if tp is not None:
        h = tp_enter(h, tp)
    h = h @ blk["w1"].to(cd) + blk["b1"].to(cd)
    h = F.gelu(h, approximate="tanh")
    h = h @ blk["w2"].to(cd)
    if tp is not None:            # the hidden was sharded: reduce ("g")
        h = tp_reduce(h, tp)
    return x + h + blk["b2"].to(cd)


def block_apply(blk: PyTree, x: torch.Tensor, cd, *, seq_attn=None,
                seq: MeshAxis | None = None, tp: MeshAxis | None = None,
                ep: MeshAxis | None = None,
                moe_capacity_factor: float = 1.25, moe_top_k: int = 1,
                return_moe_aux: bool = False, attn_impl=None):
    """One transformer block: pre-norm attention, then the FFN/MoE
    residual."""
    x = attn_apply(blk, x, cd, seq_attn=seq_attn, seq=seq, tp=tp,
                   attn_impl=attn_impl)
    return ffn_apply(blk, x, cd, tp=tp, ep=ep,
                     moe_capacity_factor=moe_capacity_factor,
                     moe_top_k=moe_top_k, return_moe_aux=return_moe_aux)


def _generator(seed) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(int(seed))


def transformer_lm(vocab: int = 256, dim: int = 128, depth: int = 2,
                   heads: int = 4, mlp_ratio: int = 4, max_len: int = 2048,
                   dtype=torch.float32, compute_dtype=None,
                   seq_impl: str = "ring", remat=False,
                   attn_impl: str | None = None, scan_blocks: bool = False,
                   moe_experts: int = 0, moe_every: int = 2,
                   moe_capacity_factor: float = 1.25,
                   moe_top_k: int = 1) -> Model:
    """A :class:`Model` whose ``init(generator, device)`` returns
    ``(params, {})`` and whose ``apply(params, state, tokens, ...)`` maps
    int tokens ``[B, L_local]`` to next-token logits ``[B, L_local,
    vocab]`` in ``dtype``.

    ``init`` takes a ``torch.Generator`` (or an int seed) and draws from
    the JAX package's distributions on the CPU, then moves the tree to
    ``device`` (the card unless ``"cpu"`` is asked for).  Its numbers are
    not JAX's: parity tests carry JAX's params across with
    :func:`distlearn_tpu_torch.models.convert.lm_from_jax`.
    ``scan_blocks=True`` stores the blocks stacked under ``"blocks"``, as
    the JAX package's scanned layout; apply walks them in a loop.

    ``seq_impl`` is the attention over a sequence axis: ``"ring"``
    (:func:`~distlearn_tpu_torch.parallel.sequence.ring_attention`) or
    ``"alltoall"`` (Ulysses; heads divisible by the axis size).
    ``attn_impl`` is the single-device kernel (``"xla"``, ``"flash"``,
    ``"chunked"``), which runs with no sequence axis, on a size-1 one, and
    inside Ulysses on the head shard.

    ``remat=True`` (= ``"full"``) checkpoints each block: its activations
    are recomputed in the backward pass instead of saved (the flash
    forward and the block's collectives run again there).
    ``remat="mlp"`` checkpoints only the FFN half, so the attention output
    and the flash kernel's softmax statistics stay saved and the backward
    never reruns the attention forward.  Both use
    ``torch.utils.checkpoint(use_reentrant=False)`` and apply only where a
    gradient is being recorded.

    ``moe_experts=X`` makes every ``moe_every``-th block's FFN a routed
    top-``moe_top_k`` mixture of X experts; ``apply(..., ep_axis=)``
    shards them one a rank over that axis (X equal to its size), without
    it they all run here.  MoE models return the mean balance loss and
    dropped fraction of their MoE blocks in the state
    (``moe_balance_loss``, ``moe_dropped_frac``)."""
    if seq_impl not in ("ring", "alltoall"):
        raise ValueError(f"seq_impl must be 'ring' or 'alltoall', "
                         f"got {seq_impl!r}")
    if isinstance(remat, str):
        if remat not in ("full", "mlp"):
            raise ValueError(f"remat must be False, True/'full', or 'mlp', "
                             f"got {remat!r}")
    else:
        # any truthy non-string (True, 1, ...) means full remat, as in JAX
        remat = "full" if remat else False
    if moe_experts < 0 or (moe_experts > 0 and moe_every < 1):
        raise ValueError(f"moe_experts must be >= 0 and moe_every >= 1, "
                         f"got {moe_experts}/{moe_every}")
    if moe_experts > 0 and moe_every > depth:
        raise ValueError(
            f"moe_every={moe_every} > depth={depth}: no block would be MoE "
            f"— the requested {moe_experts}-expert model would silently "
            "train dense")
    if moe_experts > 0 and not 1 <= moe_top_k <= moe_experts:
        raise ValueError(f"moe_top_k={moe_top_k} must be in "
                         f"[1, moe_experts={moe_experts}]")
    if scan_blocks and moe_experts:
        raise ValueError(
            "scan_blocks needs a homogeneous dense stack: MoE blocks hold "
            "routed expert leaves the dense blocks lack, so they cannot "
            "ride one lax.scan — drop scan_blocks or moe_experts")
    seq_attn = ring_attention if seq_impl == "ring" else alltoall_attention

    def _is_moe(i: int) -> bool:
        return moe_experts > 0 and (i % moe_every) == moe_every - 1
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
            blk = {
                "ln1": _norm_init((dim,), dtype),
                "wq": normal((dim, heads, head_dim)),
                "wk": normal((dim, heads, head_dim)),
                "wv": normal((dim, heads, head_dim)),
                "wo": normal((heads, head_dim, dim)),
                "ln2": _norm_init((dim,), dtype),
            }
            if _is_moe(i):
                X = moe_experts
                blk["router"] = normal((dim, X))
                blk["we1"] = normal((X, dim, hidden))
                blk["wb1"] = torch.zeros((X, hidden), dtype=dtype)
                blk["we2"] = normal((X, hidden, dim), 1.0 / math.sqrt(hidden))
            else:
                blk["w1"] = normal((dim, hidden))
                blk["b1"] = torch.zeros((hidden,), dtype=dtype)
                blk["w2"] = normal((hidden, dim), 1.0 / math.sqrt(hidden))
                blk["b2"] = torch.zeros((dim,), dtype=dtype)
            params[f"block{i}"] = blk
        params = tree_map(lambda t: t.to(device), params)
        if scan_blocks:
            return stack_block_params(params, depth), {}
        return params, {}

    def make_block(is_moe, sa, seq, tp, ep):
        moe_kw = dict(ep=ep, moe_capacity_factor=moe_capacity_factor,
                      moe_top_k=moe_top_k, return_moe_aux=is_moe)

        def plain(blk, x):
            return block_apply(blk, x, cd, seq_attn=sa, seq=seq, tp=tp,
                               attn_impl=attn_impl, **moe_kw)

        def block(blk, x):
            if not (remat and torch.is_grad_enabled()):
                return plain(blk, x)
            if remat == "mlp":
                x = attn_apply(blk, x, cd, seq_attn=sa, seq=seq, tp=tp,
                               attn_impl=attn_impl)
                return checkpoint(ffn_apply, blk, x, cd, use_reentrant=False,
                                  tp=tp, **moe_kw)
            return checkpoint(plain, blk, x, use_reentrant=False)
        return block

    def apply(params, state, tokens, train=True, rng=None, seq_axis=None,
              tp_axis=None, ep_axis=None, seq_layout="contig", mesh=None):
        sa = seq_attn
        if seq_layout not in ("contig", "zigzag"):
            raise ValueError(f"seq_layout must be 'contig' or 'zigzag', "
                             f"got {seq_layout!r}")
        if seq_layout == "zigzag":
            if seq_axis is None:
                raise ValueError(
                    "seq_layout='zigzag' without a sequence axis: the "
                    "layout permutes data across shards — drop it for "
                    "single-shard runs")
            if seq_impl != "ring":
                raise ValueError(
                    "seq_layout='zigzag' needs seq_impl='ring' (the "
                    "all-to-all path applies its causal mask in natural "
                    "order)")
            sa = _zigzag(seq_attn)
        seq, tp, ep = mesh_axes(mesh, seq_axis, tp_axis, ep_axis)
        embed = params["embed"]
        tokens = torch.as_tensor(tokens, device=embed.device).long()
        L = tokens.shape[1]
        pos = params["pos"]
        if seq is None:
            pos_emb = pos[:L]
        elif seq_layout == "zigzag":
            # local shard = early stripe my ++ late stripe 2n-1-my
            n, my, s_len = seq.size, seq.index, L // 2
            pos_emb = torch.cat(
                [pos[my * s_len:(my + 1) * s_len],
                 pos[(2 * n - 1 - my) * s_len:(2 * n - my) * s_len]])
        else:
            pos_emb = pos[seq.index * L:(seq.index + 1) * L]
        x = embed[tokens].to(cd) + pos_emb.to(cd)[None]
        blk_dense = make_block(False, sa, seq, tp, ep)
        blk_moe = make_block(True, sa, seq, tp, ep) if moe_experts else None
        if "blocks" in params:
            blocks = [tree_map(lambda a, i=i: a[i], params["blocks"])
                      for i in range(depth)]
        else:
            blocks = [params[f"block{i}"] for i in range(depth)]
        balance = dropped = n_moe = 0
        for i, blk in enumerate(blocks):
            if _is_moe(i):
                x, aux = blk_moe(blk, x)
                balance = balance + aux["balance_loss"]
                dropped = dropped + aux["dropped_frac"]
                n_moe += 1
            else:
                x = blk_dense(blk, x)
        if n_moe:
            state = dict(state, moe_balance_loss=balance / n_moe,
                         moe_dropped_frac=dropped / n_moe)
        x = _rmsnorm(params["out_norm"], x)
        logits = x @ embed.T.to(cd)
        return logits.to(dtype), state

    return Model(init=init, apply=apply, name="transformer_lm",
                 input_shape=(max_len,), num_classes=vocab)


def _zigzag(seq_attn):
    def attend(q, k, v, axis, causal=False, impl=None):
        return seq_attn(q, k, v, axis, causal=causal, impl=impl,
                        layout="zigzag")
    return attend


def mesh_axes(mesh, *names):
    """The :class:`MeshAxis` of each name (None stays None); a named axis
    needs ``mesh``."""
    if mesh is None:
        if any(n is not None for n in names):
            raise ValueError(f"mesh axes {[n for n in names if n]} need "
                             "the mesh: pass mesh=")
        return (None,) * len(names)
    return tuple(None if n is None else mesh.axis(n) for n in names)


def param_specs(params: PyTree, tp_axis: str | None,
                ep_axis: str | None = None) -> PyTree:
    """For each leaf, the mesh axis that splits each of its dimensions, as
    a tuple (the JAX package's ``PartitionSpec`` entries; ``()`` is
    replicated): ``tp_axis`` splits heads and the MLP hidden, ``ep_axis``
    the leading expert axis of the MoE leaves (the router stays
    replicated).  Leaves of the scanned ``"blocks"`` layout get the same
    spec one axis to the right."""
    def spec_for(name, in_blocks):
        if name in EXPERT_LEAVES:
            spec = (ep_axis,) if ep_axis else ()
        elif tp_axis is None:
            spec = ()
        elif name in ("wq", "wk", "wv", "w1"):
            spec = (None, tp_axis)      # [E, H, D] heads / [E, F] hidden
        elif name in ("wo", "b1", "w2"):
            spec = (tp_axis,)           # [H, D, E] / [F] / [F, E]
        else:
            spec = ()
        return (None, *spec) if in_blocks else spec

    def walk(tree, in_blocks):
        return {k: walk(v, in_blocks or k == "blocks")
                if isinstance(v, dict) else spec_for(k, in_blocks)
                for k, v in tree.items()}
    return walk(params, False)


def lm_loss(model: Model, params: PyTree, tokens, seq_axis=None,
            tp_axis=None, ep_axis=None, reduce: bool = True,
            moe_balance_weight: float = 0.0, seq_layout: str = "contig",
            mesh=None) -> torch.Tensor:
    """Next-token cross-entropy (float32 log-softmax) of ``model`` on int
    tokens ``[B, L_local]``, plus ``moe_balance_weight`` times the MoE
    balance loss where the model has one.

    With a sequence axis the last target of a shard is the first token of
    the next one (a ``ppermute``; the zigzag layout's two stripes take
    theirs from both neighbours), the global last position has none, and
    the loss is the masked sum over the global token count; the balance
    term enters as 1/n of each shard's.  ``reduce=False`` returns this
    shard's share without the psum over the axis — the form to
    differentiate (``train/lm.py`` sums the partial gradients)."""
    logits, st = model.apply(params, {}, tokens, train=True,
                             seq_axis=seq_axis, tp_axis=tp_axis,
                             ep_axis=ep_axis, seq_layout=seq_layout,
                             mesh=mesh)
    bal = (moe_balance_weight * st["moe_balance_loss"]
           if moe_balance_weight and "moe_balance_loss" in st else None)
    tokens = torch.as_tensor(tokens, device=logits.device).long()
    if seq_axis is None:
        lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        loss = -lp.gather(-1, tokens[:, 1:, None])[..., 0].mean()
        return loss + bal if bal is not None else loss
    seq = mesh.axis(seq_axis)
    n, my = seq.size, seq.index
    B, L = tokens.shape
    if seq_layout == "zigzag":
        # stripe a+1 is rank my+1's early stripe (rank n-1's own late
        # stripe for a = n-1); stripe b+1 is rank my-1's late stripe
        s_len = L // 2
        early_head = tokens[:, :1]
        late_head = tokens[:, s_len:s_len + 1]
        from_next = ppermute(early_head, seq,
                             [(j, (j - 1) % n) for j in range(n)])
        from_prev = ppermute(late_head, seq,
                             [(j, (j + 1) % n) for j in range(n)])
        bound_a = late_head if my == n - 1 else from_next
        targets = torch.cat([tokens[:, 1:s_len], bound_a,
                             tokens[:, s_len + 1:], from_prev], dim=1)
        w = torch.ones(L, device=logits.device)
        if my == 0:
            w[-1] = 0.0
    else:
        nxt_first = ppermute(tokens[:, :1], seq,
                             [(j, (j - 1) % n) for j in range(n)])
        targets = torch.cat([tokens[:, 1:], nxt_first], dim=1)
        pos = my * L + torch.arange(L, device=logits.device)
        w = (pos < n * L - 1).float()
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -lp.gather(-1, targets[..., None])[..., 0]
    count = psum_raw(w.sum() * B, seq)
    local = (nll * w[None, :]).sum() / torch.clamp(count, min=1.0)
    if bal is not None:
        local = local + bal / n
    return psum(local, seq) if reduce else local


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
