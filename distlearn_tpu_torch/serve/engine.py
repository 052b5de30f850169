"""Slot-addressed decode engine — counterpart of
``distlearn_tpu/serve/engine.py`` on PyTorch: ``greedy_generate``'s prefill
and decode split into programs over a persistent paged K/V pool
(:mod:`distlearn_tpu_torch.serve.kv_cache`) for continuous batching.

* :meth:`DecodeEngine.prefill_step` runs one prompt's full causal pass
  (padded to its bucket; its attention is :func:`local_attention`, so
  kernel B5a at buckets of 128 and up under ``DISTLEARN_TPU_ATTN=flash``)
  or one resumable chunk of it that attends through the slot's pages.
* :meth:`DecodeEngine.tick` advances every runnable slot one token in one
  batched pass; :meth:`DecodeEngine.verify` scores speculative drafts.

Every program is built from the same block math as the model and
``greedy_generate`` (``attn_qkv`` / ``attn_out`` / ``ffn_apply`` /
``decode_attend``).  The chunk, tick and verify passes attend through
``decode_attend`` over the gathered pages, which the JAX package computes
outside Pallas too.  The K/V pools ``[depth, num_pages, page, heads,
head_dim]`` are device tensors updated in place, where the JAX package
donates them.  The weights are cast to the compute dtype once, at
construction and at every swap, which gives the same values as casting at
each use.  The tensor-parallel engine (``mesh``/``tp_axis``) waits for
ROADMAP A12.

Sampling (temperature > 0) keeps the JAX package's top-k and top-p rule;
its draw comes from a ``torch.Generator`` seeded from (seed, position)
alone, so a request replays identically whatever its batch, but the draws
are not JAX's threefry draws.  Temperature 0 is the plain argmax.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from distlearn_tpu_torch import obs
from distlearn_tpu_torch.models.transformer import (_rmsnorm, attn_out,
                                                    attn_qkv, decode_attend,
                                                    ffn_apply,
                                                    generate_params)
from distlearn_tpu_torch.parallel.sequence import local_attention
from distlearn_tpu_torch.serve.kv_cache import CacheFull, PagedKVCache
from distlearn_tpu_torch.utils.platform import resolve_device
from distlearn_tpu_torch.utils.tree import tree_flatten, tree_map

PyTree = Any

__all__ = ["DecodeEngine", "CacheFull", "PrefillJob"]


def _draw_key(seed: int, position: int) -> int:
    """A well-mixed 32-bit generator seed from (seed, position): the CPU
    generator keeps 32 bits of its seed."""
    return int(np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, int(position) & 0xFFFFFFFF])
        .generate_state(1)[0])


def _sample_token(lg: torch.Tensor, temp: float, tk: int, tp_: float,
                  seed: int, position: int) -> int:
    """One token from a ``[V]`` float32 logits row.  ``temp == 0`` is the
    argmax (first index on ties).  ``temp > 0`` draws from the
    temperature-scaled distribution after top-k (``tk > 0``) and nucleus
    top-p (``0 < tp_``) filtering, with Gumbel noise from a CPU generator
    keyed by (seed, position) — the position the sampled token will
    occupy — so the draw never depends on batch composition or device."""
    if not temp > 0:
        return int(torch.argmax(lg))
    lg = lg.float().cpu()
    V = lg.shape[-1]
    scaled = lg / torch.tensor(np.float32(temp))
    srt = torch.sort(scaled, descending=True).values
    kk = min(max(tk if tk > 0 else V, 1), V)
    k_thr = srt[kk - 1]
    probs = torch.softmax(srt, dim=-1)
    # keep a sorted token while the mass STRICTLY BEFORE it is < top_p:
    # the head token always survives, so the filter never empties
    keep = (torch.cumsum(probs, dim=-1) - probs) < (tp_ if tp_ > 0 else 1.0)
    p_thr = torch.min(torch.where(keep, srt, torch.tensor(float("inf"))))
    filt = torch.where(scaled >= torch.maximum(k_thr, p_thr), scaled,
                       torch.tensor(float("-inf")))
    gen = torch.Generator().manual_seed(_draw_key(seed, position))
    u = torch.rand(V, generator=gen, dtype=torch.float64)
    gumbel = (-torch.log(-torch.log(u))).float()
    return int(torch.argmax(filt + gumbel))


class PrefillJob:
    """Resumable prefill state for one admitted request: the slot, the
    prompt, and the next position to prefill (``pos`` starts at the
    prefix-cache ``cached`` length).  Drive with
    :meth:`DecodeEngine.prefill_step` until ``done``; ``first`` then holds
    the request's first generated token."""

    __slots__ = ("slot", "prompt", "pos", "cached", "done", "first")

    def __init__(self, slot: int, prompt: np.ndarray, cached: int):
        self.slot = slot
        self.prompt = prompt
        self.pos = int(cached)
        self.cached = int(cached)
        self.done = False
        self.first: int | None = None


def _buckets(max_len: int) -> tuple[int, ...]:
    """Prompt-length buckets: powers of two from 8 up to ``max_len``
    (inclusive as the last bucket)."""
    out = []
    b = 8
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


class DecodeEngine:
    """Continuous-batching decode engine over a fixed-slot paged cache.

    ``params`` is a dense :func:`transformer_lm` tree (per-block or
    scanned layout, tensors or numpy arrays; MoE rejected).  ``num_slots``
    bounds concurrent requests; ``max_len`` bounds ``prompt + generated``
    per request and sizes the page pool.  ``device`` is the card unless
    ``"cpu"`` is asked for.
    """

    def __init__(self, params: PyTree, *, num_slots: int = 4,
                 max_len: int | None = None, page: int = 16,
                 compute_dtype=None, mesh=None, tp_axis: str | None = None,
                 spec_k: int = 4, num_pages: int | None = None,
                 device=None):
        if mesh is not None or tp_axis is not None:
            raise NotImplementedError(
                "the tensor-parallel engine (mesh/tp_axis) waits for ROADMAP "
                "A12 (tensor-parallel serving)")
        self.device = resolve_device(device)
        params, self.depth = generate_params(params)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.cd = compute_dtype or self.params["embed"].dtype
        self._run = self._cast(self.params)
        pos_len = self.params["pos"].shape[0]
        self.max_len = int(max_len or pos_len)
        if self.max_len > pos_len:
            raise ValueError(f"max_len={self.max_len} exceeds the model's "
                             f"positional table {pos_len}")
        wq = self.params["block0"]["wq"]
        self.heads, self.head_dim = wq.shape[1], wq.shape[2]
        if spec_k < 1:
            raise ValueError(f"spec_k={spec_k} must be >= 1")
        self.spec_k = int(spec_k)
        self.cache = PagedKVCache(num_slots, page, self.max_len,
                                  num_pages=num_pages)
        self.buckets = _buckets(self.max_len)
        # per-slot sampling state (set at begin): temp == 0 means greedy
        self._temp = np.zeros((num_slots,), np.float32)
        self._topk = np.zeros((num_slots,), np.int32)
        self._topp = np.zeros((num_slots,), np.float32)
        self._seed = np.zeros((num_slots,), np.int32)
        shape = (self.depth, self.cache.num_pages, page, self.heads,
                 self.head_dim)
        self._k = torch.zeros(shape, dtype=self.cd, device=self.device)
        self._v = torch.zeros(shape, dtype=self.cd, device=self.device)
        self._m_ticks = obs.counter("serve_engine_ticks_total",
                                    "decode ticks dispatched")
        self._m_prefills = obs.counter("serve_engine_prefills_total",
                                       "prefill programs dispatched")
        self._m_chunks = obs.counter("serve_engine_prefill_chunks_total",
                                     "resumable prefill chunks dispatched")
        self._m_verifies = obs.counter("serve_engine_verifies_total",
                                       "speculative verify ticks dispatched")
        self._h_tick = obs.histogram("serve_tick_seconds",
                                     "one decode tick: dispatch to tokens "
                                     "on host")
        self._h_accept = obs.histogram(
            "serve_spec_accepted_tokens",
            "tokens emitted per slot per verify tick (accepted drafts + "
            "the bonus token; 1 == plain-tick throughput)",
            buckets=(1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0))

    def _cast(self, params: PyTree) -> PyTree:
        """The weights in the compute dtype (the same tensors when they
        are in it already)."""
        return tree_map(lambda t: t.to(self.cd) if t.is_floating_point()
                        else t, params)

    def _t(self, a) -> torch.Tensor:
        """A host array as an index/value tensor on the engine's device."""
        t = torch.as_tensor(np.asarray(a))
        if t.dtype in (torch.int32, torch.int16, torch.int8, torch.uint8):
            t = t.long()
        return t.to(self.device)

    # -- programs -----------------------------------------------------------
    def _embed(self, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        p = self._run
        return p["embed"][tokens] + p["pos"][pos.clamp(0, self.max_len - 1)]

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return (x @ self._run["embed"].T).float()

    def _layers(self, x, pages, offs, attend):
        """The block stack: each layer scatters this pass's K/V into the
        pools at ``(pages, offs)``, then attends with ``attend(i, q, k,
        v)``."""
        p, cd = self._run, self.cd
        for i in range(self.depth):
            blk = p[f"block{i}"]
            q, k, v = attn_qkv(blk, x, cd)
            self._k[i, pages, offs] = k.reshape(pages.shape + k.shape[2:])
            self._v[i, pages, offs] = v.reshape(pages.shape + v.shape[2:])
            x = attn_out(blk, x, attend(i, q, k, v), cd)
            x = ffn_apply(blk, x, cd)
        return _rmsnorm(p["out_norm"], x)

    def _paged(self, bt: torch.Tensor, pos: torch.Tensor):
        """Attention through the pages of the block-table rows ``bt``
        (``[S, P]``): a query at absolute position ``pos`` (``[S, Q]``)
        sees the cache positions ``t <= pos`` — the chunk, tick and verify
        passes' ``attend``."""
        S = bt.shape[0]
        cols = torch.arange(self.cache.pages_per_slot * self.cache.page,
                            device=self.device)
        live = (cols[None, None] <= pos[:, :, None])[:, None]   # [S,1,Q,T]
        shape = (S, cols.shape[0], self.heads, self.head_dim)

        def attend(i, q, k, v):
            ck = self._k[i][bt].reshape(shape)
            cv = self._v[i][bt].reshape(shape)
            return decode_attend(q, ck, cv, live, self.cd)
        return attend

    @torch.no_grad()
    def _prefill(self, btrow, tokens, plen: int) -> torch.Tensor:
        # tokens [1, Pb] RIGHT-padded to the bucket: causal attention keeps
        # positions < plen off the garbage tail, whose K/V scatter goes to
        # the trash page
        page = self.cache.page
        Pb = tokens.shape[1]
        posn = torch.arange(Pb, device=self.device)
        valid = posn < plen
        pages = torch.where(valid, btrow[posn // page], 0)
        offs = torch.where(valid, posn % page, 0)
        x = self._layers(self._embed(tokens, posn[None]), pages, offs,
                         lambda i, q, k, v: local_attention(q, k, v,
                                                            causal=True))
        return self._logits(x[0, plen - 1])

    @torch.no_grad()
    def _chunk(self, btrow, tokens, p0: int, clen: int) -> torch.Tensor:
        # tokens [1, Cb] RIGHT-padded; absolute positions p0 + j.  A query
        # at p0 + j sees cache t <= p0 + j: the cached prefix, earlier
        # chunks and this chunk's causal prefix (scattered above it)
        page = self.cache.page
        Cb = tokens.shape[1]
        j = torch.arange(Cb, device=self.device)
        posn = p0 + j
        valid = j < clen
        pages = torch.where(
            valid, btrow[(posn // page).clamp(0, btrow.shape[0] - 1)], 0)
        offs = torch.where(valid, posn % page, 0)
        x = self._layers(self._embed(tokens, posn[None]), pages, offs,
                         self._paged(btrow[None], posn[None]))
        return self._logits(x[0, clen - 1])

    @torch.no_grad()
    def _tick_pass(self, bt, lens, toks, active) -> torch.Tensor:
        page = self.cache.page
        S = toks.shape[0]
        row = (lens // page).clamp(0, bt.shape[1] - 1)
        # inactive slots write to the trash page
        pages = torch.where(active, bt[torch.arange(S, device=self.device),
                                       row], 0)
        offs = torch.where(active, lens % page, 0)
        x = self._layers(self._embed(toks[:, None], lens[:, None]),
                         pages[:, None], offs[:, None],
                         self._paged(bt, lens[:, None]))
        return self._logits(x[:, 0])

    @torch.no_grad()
    def _verify_pass(self, bt, lens, toks, active, ndraft) -> torch.Tensor:
        page = self.cache.page
        S, K = toks.shape
        j = torch.arange(K, device=self.device)
        pos = lens[:, None] + j[None]                       # [S,K]
        valid = active[:, None] & (j[None] <= ndraft[:, None])
        row = (pos // page).clamp(0, bt.shape[1] - 1)
        pages = torch.where(valid, torch.gather(bt, 1, row), 0)
        offs = torch.where(valid, pos % page, 0)
        x = self._layers(self._embed(toks, pos), pages, offs,
                         self._paged(bt, pos))
        return torch.argmax(self._logits(x), dim=-1)

    def _sample(self, lg: torch.Tensor, slot: int, position: int) -> int:
        return _sample_token(lg, float(self._temp[slot]),
                             int(self._topk[slot]), float(self._topp[slot]),
                             int(self._seed[slot]), position)

    # -- capacity -----------------------------------------------------------
    def has_capacity(self, prompt_len: int, max_new: int,
                     shared_pages: int = 0) -> bool:
        return self.cache.can_admit(int(prompt_len) + int(max_new),
                                    shared_pages=shared_pages)

    def bucket_for(self, plen: int) -> int:
        for b in self.buckets:
            if plen <= b:
                return b
        raise ValueError(f"prompt length {plen} exceeds max_len "
                         f"{self.max_len}")

    # -- request lifecycle --------------------------------------------------
    def begin(self, prompt: np.ndarray, max_new: int, *, shared=(),
              temperature: float = 0.0, top_k: int = 0,
              top_p: float = 0.0, seed: int = 0) -> PrefillJob:
        """Claim a slot for ``prompt`` and return a resumable
        :class:`PrefillJob` — no compute happens here.  ``shared`` lists
        prefix-cache pages covering the prompt's leading whole pages (the
        job prefills only the suffix).  Raises :class:`CacheFull` when no
        slot/pages fit and ``ValueError`` for an impossible request."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        plen = len(prompt)
        if plen < 1:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new={max_new} must be >= 1")
        if not 0.0 <= float(temperature):
            raise ValueError(f"temperature={temperature} must be >= 0")
        if not 0.0 <= float(top_p) <= 1.0:
            raise ValueError(f"top_p={top_p} outside [0, 1]")
        total = plen + int(max_new)
        if total > self.max_len:
            raise ValueError(f"prompt({plen}) + max_new({max_new}) = "
                             f"{total} exceeds max_len {self.max_len}")
        shared = [int(p) for p in shared]
        cached = len(shared) * self.cache.page
        if cached >= plen:
            raise ValueError(f"{len(shared)} shared pages cover the whole "
                             f"{plen}-token prompt — at least the last "
                             "position must prefill (it makes the logits)")
        slot = self.cache.admit(total, shared=shared)
        self._temp[slot] = float(temperature)
        self._topk[slot] = int(top_k)
        self._topp[slot] = float(top_p)
        self._seed[slot] = int(seed)
        return PrefillJob(slot, prompt, cached)

    def prefill_step(self, job: PrefillJob,
                     chunk: int | None = None) -> int | None:
        """Run ONE prefill pass for ``job`` — at most ``chunk`` prompt
        positions (the whole remainder when ``None``) — and return the
        first generated token once the prompt is fully prefilled
        (``job.done``), else ``None``.  An uncached job with no chunk bound
        takes the full-prompt pass; resumed or chunked jobs go through the
        chunk pass."""
        if job.done:
            raise ValueError("prefill_step on a finished job")
        plen = len(job.prompt)
        remaining = plen - job.pos
        btrow = self._t(self.cache.block_table[job.slot])
        if job.pos == 0 and (chunk is None or chunk >= plen):
            bucket = self.bucket_for(plen)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :plen] = job.prompt
            with obs.span("serve.prefill", slot=job.slot, bucket=bucket):
                lg = self._prefill(btrow, self._t(padded), plen)
                # the first generated token occupies position plen
                first = self._sample(lg, job.slot, plen)
            self._m_prefills.inc()
        else:
            take = remaining if chunk is None else min(int(chunk),
                                                       remaining)
            bucket = self.bucket_for(take)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :take] = job.prompt[job.pos:job.pos + take]
            with obs.span("serve.prefill_chunk", slot=job.slot,
                          bucket=bucket, p0=job.pos):
                lg = self._chunk(btrow, self._t(padded), job.pos, take)
                # only the final chunk's token is consumed
                first = self._sample(lg, job.slot, job.pos + take) \
                    if job.pos + take >= plen else None
            self._m_chunks.inc()
            job.pos += take
            if job.pos < plen:
                return None
        job.pos = plen
        job.done = True
        job.first = first
        self.cache.lengths[job.slot] = plen
        self.cache.last_tok[job.slot] = first
        return first

    def abort_prefill(self, job: PrefillJob):
        """Release a job that will never finish (deadline/cancel
        mid-prefill): frees the slot and drops its page references."""
        job.done = True
        self.cache.release(job.slot)

    def admit(self, prompt: np.ndarray, max_new: int,
              **kw) -> tuple[int, int]:
        """Prefill ``prompt`` into a free slot in one call; returns
        ``(slot, first_token)``.  Keyword options pass to :meth:`begin`."""
        job = self.begin(prompt, max_new, **kw)
        first = self.prefill_step(job)
        while first is None:            # cached prefix -> chunk resume
            first = self.prefill_step(job)
        return job.slot, first

    def tick(self, include=None) -> dict[int, int]:
        """Advance every runnable slot one token in ONE pass; returns
        ``{slot: next_token}``.  Slots whose allocation is spent
        (``length == limit``) and slots mid-prefill (``length == 0``) are
        skipped; ``include`` (a slot list) restricts the advance to a
        subset."""
        c = self.cache
        runnable = c.active & (c.lengths > 0) & (c.lengths < c.limit)
        if include is not None:
            sel = np.zeros((c.num_slots,), bool)
            sel[[int(s) for s in include]] = True
            runnable = runnable & sel
        if not runnable.any():
            return {}
        t0 = time.perf_counter()
        with obs.span("serve.tick", slots=int(runnable.sum())):
            lg = self._tick_pass(self._t(c.block_table), self._t(c.lengths),
                                 self._t(c.last_tok), self._t(runnable))
            nxt = torch.argmax(lg, dim=-1).cpu().numpy()
            for slot in np.flatnonzero(runnable & (self._temp > 0)):
                # the sampled token occupies position lengths + 1
                nxt[slot] = self._sample(lg[slot], int(slot),
                                         int(c.lengths[slot]) + 1)
        self._h_tick.observe(time.perf_counter() - t0)
        self._m_ticks.inc()
        out = {}
        for slot in np.flatnonzero(runnable):
            slot = int(slot)
            c.lengths[slot] += 1            # last_tok's K/V is now cached
            c.last_tok[slot] = int(nxt[slot])
            out[slot] = int(nxt[slot])
        return out

    def verify(self, drafts: dict[int, list]) -> dict[int, list[int]]:
        """Speculative advance: one batched verify pass over the ``drafts``
        slots (slot -> proposed next tokens, possibly empty), returning
        ``{slot: emitted tokens}`` — the leading drafts that matched the
        model's argmax plus the model's own token at the first mismatch.
        Greedy slots only; drafts are clipped to ``spec_k`` and to the
        slot's remaining page allocation."""
        c = self.cache
        K = self.spec_k + 1
        toks = np.zeros((c.num_slots, K), np.int32)
        nd = np.zeros((c.num_slots,), np.int32)
        part = np.zeros((c.num_slots,), bool)
        for slot, d in drafts.items():
            slot = int(slot)
            if not (c.active[slot] and 0 < c.lengths[slot]
                    < c.limit[slot]):
                continue
            room = int(c.limit[slot]) - int(c.lengths[slot]) - 1
            d = [int(t) for t in d][:min(self.spec_k, max(0, room))]
            part[slot] = True
            nd[slot] = len(d)
            toks[slot, 0] = c.last_tok[slot]
            if d:
                toks[slot, 1:1 + len(d)] = d
        if not part.any():
            return {}
        t0 = time.perf_counter()
        with obs.span("serve.verify", slots=int(part.sum()),
                      drafted=int(nd.sum())):
            out = self._verify_pass(
                self._t(c.block_table), self._t(c.lengths), self._t(toks),
                self._t(part), self._t(nd)).cpu().numpy()
        self._h_tick.observe(time.perf_counter() - t0)
        self._m_verifies.inc()
        res: dict[int, list[int]] = {}
        for slot in np.flatnonzero(part):
            slot = int(slot)
            k = int(nd[slot])
            row = out[slot]
            acc = 0                 # leading drafts matching the argmax
            while acc < k and int(row[acc]) == int(toks[slot, acc + 1]):
                acc += 1
            emitted = [int(t) for t in toks[slot, 1:1 + acc]]
            emitted.append(int(row[acc]))   # bonus: argmax after prefix
            c.lengths[slot] += acc + 1
            c.last_tok[slot] = emitted[-1]
            self._h_accept.observe(float(acc + 1))
            res[slot] = emitted
        return res

    def finish(self, slot: int):
        """Release the slot's pages (request done or evicted)."""
        self.cache.release(slot)

    def swap_params(self, params: PyTree) -> None:
        """Hot-swap the served weights between ticks (``serve.server``
        fences admissions around the call).  Structure, shape and dtype
        must match the engine's, so a layout drift fails the swap, not the
        next request."""
        new, depth = generate_params(params)
        if depth != self.depth:
            raise ValueError(f"swap depth {depth} != engine depth "
                             f"{self.depth}")
        old_leaves, old_def = tree_flatten(self.params)
        new_leaves, new_def = tree_flatten(new)
        if old_def != new_def:
            raise ValueError("swap param tree structure differs from the "
                             "engine's")
        for o, n in zip(old_leaves, new_leaves):
            if tuple(o.shape) != tuple(n.shape) or o.dtype != n.dtype:
                raise ValueError(
                    f"swap leaf mismatch: {tuple(n.shape)}/{n.dtype} where "
                    f"the engine holds {tuple(o.shape)}/{o.dtype}")
        self.params = tree_map(lambda t: t.to(self.device), new)
        self._run = self._cast(self.params)
