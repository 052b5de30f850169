"""A copy of ``distlearn_tpu/serve/speculate.py`` (pure Python).

Prompt-lookup speculative drafting — >1 accepted tokens per verify
tick with NO second model (Leviathan et al. 2022; Saxena's prompt
lookup decoding).

Speculative decoding splits token generation into a cheap DRAFT and an
exact VERIFY: some oracle proposes ``k`` next tokens, one batched
engine dispatch scores all ``k`` positions at once, and the leading run
of drafts that match the model's own argmax is accepted — plus the
model's token at the first mismatch position as a free "bonus".  The
output token sequence is EXACTLY the sequence greedy decoding would
have produced (every accepted token equals the model argmax at its
position, and the bonus token is the model argmax after the accepted
prefix), so speculation is a pure latency trade: fewer dispatches for
the same tokens.  With all drafts rejected, the verify tick still
yields its position-0 token — the plain tick's output — so the
worst case is exactly one token per dispatch, never less
(tests/test_serve_speed.py pins this greedy equivalence).

The drafter here is the degenerate-but-effective one for the traffic
LLM services actually see: **n-gram prompt lookup**.  Generated text
constantly re-quotes its own context (code completion echoes
identifiers, summaries echo their source, chat echoes the system
prompt), so "find the longest suffix of what we've emitted somewhere
earlier in the sequence, and draft whatever followed it there" wins
real acceptance at zero model cost.  No weights, no state, O(context)
host work per proposal.

Rollback is the engine's job and is IMPLICIT: rejected drafts' K/V
were scattered into the slot's own pages at positions past the
accepted length, the slot's length only advances over accepted
positions, attention masks by length, and later writes overwrite the
stale positions — no copy, no restore (docs/SERVING.md).  Sampling
(``temperature > 0``) disables drafting for the slot: verify compares
against argmax, which a sampled stream does not follow.
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["NGramDrafter"]


class NGramDrafter:
    """Draft up to ``k`` tokens by n-gram lookup over the request's own
    context (prompt + generated so far).

    Matching tries the longest suffix first (``n_max`` down to
    ``n_min`` tokens) and takes the MOST RECENT earlier occurrence —
    recency beats frequency for self-quoting text.  Returns ``[]``
    when the context never repeats; the scheduler then just ticks.
    """

    def __init__(self, *, k: int = 4, n_max: int = 3, n_min: int = 1):
        if not 1 <= n_min <= n_max:
            raise ValueError(f"need 1 <= n_min={n_min} <= n_max={n_max}")
        if k < 1:
            raise ValueError(f"k={k} must be >= 1")
        self.k = int(k)
        self.n_max = int(n_max)
        self.n_min = int(n_min)

    def propose(self, context: Sequence[int], k: int | None = None
                ) -> list[int]:
        """Up to ``min(k, self.k)`` draft tokens continuing ``context``
        (the full token ids so far, prompt included)."""
        budget = self.k if k is None else min(int(k), self.k)
        ctx = [int(t) for t in context]
        if budget < 1 or len(ctx) < self.n_min + 1:
            return []
        for n in range(min(self.n_max, len(ctx) - 1), self.n_min - 1, -1):
            tail = ctx[-n:]
            # most recent earlier occurrence of the suffix n-gram; the
            # match may not end at the very tail (that IS the suffix)
            for start in range(len(ctx) - n - 1, -1, -1):
                if ctx[start:start + n] == tail:
                    follow = ctx[start + n:start + n + budget]
                    if follow:
                        return follow
        return []
