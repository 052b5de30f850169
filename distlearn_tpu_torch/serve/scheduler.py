"""A copy of ``distlearn_tpu/serve/scheduler.py`` over the port's engine,
prefix cache and drafter.

Continuous-batching scheduler — admission, ticking, eviction policy.

Orca-style (Yu et al., OSDI '22) iteration-level scheduling: the unit
of work is one engine tick, and the request mix is re-decided between
ticks.  :meth:`Scheduler.step` runs one round —

1. **Expire**: queued or running requests past their deadline are
   dropped/evicted (the bounded-latency promise: a stuck client cannot
   pin a slot forever).
2. **Admit**: FIFO head-of-line from the bounded queue into free engine
   slots while pages last.  Head-of-line (rather than best-fit over the
   whole queue) keeps ordering fair — a large request at the head is
   never starved by small ones slipping past it.
3. **Tick**: one compiled decode step advances every active slot; each
   emitted token becomes a ``token`` event, and slots that hit their
   ``max_new`` budget or the eos token finish.

The scheduler is deliberately free of sockets and metrics: it consumes
an engine and emits :class:`Event` records, so tests drive it
synchronously and ``serve.server`` maps events to wire frames and
gauges.  The admission queue is BOUNDED — :meth:`submit` raises
:class:`QueueFull` instead of buffering unboundedly, pushing backpressure
to the client where it belongs.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from distlearn_tpu_torch.serve.engine import DecodeEngine, PrefillJob
from distlearn_tpu_torch.serve.prefix_cache import RadixPrefixCache
from distlearn_tpu_torch.serve.speculate import NGramDrafter


class QueueFull(RuntimeError):
    """Admission queue at capacity — client should back off and retry.

    Carries enough context for the rejection chunk to be actionable:
    ``queue_depth`` (how far behind the server is) and ``retry_after``
    (a seconds hint; ``None`` means "don't retry here" — e.g. the
    server is draining and will never admit again)."""

    def __init__(self, msg: str, *, queue_depth: int | None = None,
                 retry_after: float | None = None):
        super().__init__(msg)
        self.queue_depth = queue_depth
        self.retry_after = retry_after


_RIDS = itertools.count(1)


@dataclass
class Request:
    rid: str
    prompt: np.ndarray
    max_new: int
    deadline: float | None          # absolute clock() value, or None
    eos: int | None
    submitted: float                # clock() at submit, for queue-wait spans
    slot: int | None = None         # engine slot once admitted
    emitted: int = 0                # tokens emitted so far (incl. first)
    tokens: list[int] = field(default_factory=list)
    temperature: float = 0.0        # 0 == greedy (the default path)
    top_k: int = 0                  # 0 == no top-k filter
    top_p: float = 0.0              # 0 == no nucleus filter
    seed: int = 0                   # sampling key seed (temp > 0 only)
    speculate: bool = True          # drafter may speculate (greedy only)
    cached: int = 0                 # prompt tokens adopted from the cache
    job: PrefillJob | None = None   # in-flight resumable prefill
    waited: float | None = None     # queue-wait seconds, fixed at slot grant


@dataclass(frozen=True)
class Event:
    """One scheduling outcome, consumed by the server loop.

    ``kind`` is ``"token"`` (one more token for ``rid``; ``first`` marks
    the prefill-produced token, i.e. the TTFT edge) or ``"finish"``
    (``reason`` in ``complete`` / ``eos`` / ``deadline`` / ``cancelled``).
    ``waited`` rides the first-token event only: seconds the request sat
    in the admission queue before its slot — the server turns it into
    the ``serve.queue_wait`` span, so TTFT splits into queue wait vs
    prefill without the scheduler touching metrics.  ``accepted`` rides
    the bonus-token event of a speculative verify round: how many draft
    tokens the model accepted ahead of it (the 'R' ``accepted`` field).
    ``cached`` rides the first-token event: prompt tokens adopted from
    the prefix cache instead of prefilled ('R' ``cached_tokens``).
    """
    kind: str
    rid: str
    token: int | None = None
    first: bool = False
    reason: str | None = None
    waited: float | None = None
    accepted: int | None = None
    cached: int | None = None


class Scheduler:
    def __init__(self, engine: DecodeEngine, *, max_queue: int = 32,
                 clock=time.monotonic,
                 prefix_cache: RadixPrefixCache | None = None,
                 drafter: NGramDrafter | None = None,
                 prefill_chunk: int | None = None):
        """``prefix_cache`` (optional) is consulted at admission — a
        prompt sharing a cached prefix prefills only its suffix — and
        fed back after every completed prefill.  ``drafter`` (optional)
        enables speculative decoding for greedy streams.
        ``prefill_chunk`` bounds how many prompt positions one
        scheduling round may prefill WHILE other streams are decoding
        (their TPOT budget; default: the engine's smallest bucket) —
        with no running streams a prefill runs straight to completion,
        there is nobody to stall."""
        self.engine = engine
        self.max_queue = int(max_queue)
        self.clock = clock
        self.prefix_cache = prefix_cache
        self.drafter = drafter
        self.prefill_chunk = int(prefill_chunk or engine.buckets[0])
        self._queue: deque[Request] = deque()
        self._running: dict[str, Request] = {}    # rid -> Request
        self._prefilling: dict[str, Request] = {} # rid -> Request (chunking)
        self._by_slot: dict[int, Request] = {}
        #: admissions fence: while True, queued requests stay queued
        #: (submit still accepts up to max_queue).  The server raises it
        #: around an epoch swap so no request prefills under outgoing
        #: params while survivors of the old epoch drain.
        self.hold = False

    # -- introspection (server gauges) --------------------------------------
    def queue_depth(self) -> int:
        return len(self._queue)

    def active_count(self) -> int:
        return len(self._running) + len(self._prefilling)

    def idle(self) -> bool:
        return (not self._queue and not self._running
                and not self._prefilling)

    def requests(self) -> list[Request]:
        return (list(self._queue) + list(self._prefilling.values())
                + list(self._running.values()))

    def _live(self, rid: str) -> bool:
        return (rid in self._running or rid in self._prefilling
                or any(r.rid == rid for r in self._queue))

    def retry_after_hint(self) -> float:
        """Seconds a rejected client should wait before retrying HERE.
        A coarse backlog proxy — per-request service time isn't known
        at admission, so the hint only needs to scale with how far
        behind the server is, clamped to [0.05s, 5s] so it neither
        thundering-herds nor parks clients forever."""
        backlog = len(self._queue) + len(self._running)
        return min(5.0, max(0.05, 0.05 * backlog))

    # -- client-facing ------------------------------------------------------
    def submit(self, prompt, max_new: int, *, rid: str | None = None,
               deadline_s: float | None = None,
               eos: int | None = None, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 0.0, seed: int = 0,
               speculate: bool = True) -> str:
        """Enqueue one request; returns its id.  Raises
        :class:`QueueFull` at capacity and ``ValueError`` for requests
        the engine could NEVER run (too long even with an empty cache) —
        those must be rejected here, not left to rot at the queue head —
        and for a ``rid`` already queued or running: the bookkeeping is
        rid-keyed, so a second live request under the same id would
        overwrite the first's entry and corrupt event routing (a rid
        becomes reusable once its request finishes)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        max_new = int(max_new)
        if prompt.size < 1 or max_new < 1:
            raise ValueError(f"prompt len {prompt.size} and max_new "
                             f"{max_new} must be >= 1")
        if prompt.size + max_new > self.engine.max_len:
            raise ValueError(
                f"prompt+max_new = {prompt.size + max_new} exceeds engine "
                f"max_len {self.engine.max_len}")
        temperature = float(temperature)
        top_p = float(top_p)
        if temperature < 0:
            raise ValueError(f"temperature={temperature} must be >= 0")
        if not 0.0 <= top_p <= 1.0:
            raise ValueError(f"top_p={top_p} outside [0, 1]")
        if int(top_k) < 0:
            raise ValueError(f"top_k={top_k} must be >= 0")
        if len(self._queue) >= self.max_queue:
            raise QueueFull(
                f"admission queue at capacity ({self.max_queue})",
                queue_depth=len(self._queue),
                retry_after=self.retry_after_hint())
        if rid is None:
            rid = str(next(_RIDS))
            while self._live(rid):      # a client squatted on this numeral
                rid = str(next(_RIDS))
        elif self._live(rid):
            raise ValueError(f"duplicate rid {rid!r}: already queued or "
                             "running")
        now = self.clock()
        req = Request(rid=rid, prompt=prompt, max_new=max_new,
                      deadline=(now + deadline_s) if deadline_s is not None
                      else None,
                      eos=eos, submitted=now, temperature=temperature,
                      top_k=int(top_k), top_p=top_p, seed=int(seed),
                      speculate=bool(speculate))
        self._queue.append(req)
        return rid

    def cancel(self, rid: str) -> bool:
        """Drop a request wherever it is (client disconnected).  Returns
        False when the rid is unknown / already finished."""
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                del self._queue[i]
                return True
        req = self._prefilling.pop(rid, None)
        if req is not None:
            del self._by_slot[req.slot]
            self.engine.abort_prefill(req.job)
            return True
        req = self._running.pop(rid, None)
        if req is None:
            return False
        del self._by_slot[req.slot]
        self.engine.finish(req.slot)
        return True

    # -- one scheduling round ----------------------------------------------
    def step(self) -> list[Event]:
        events: list[Event] = []
        now = self.clock()
        self._expire(now, events)
        self._admit(events)
        self._tick(events)
        return events

    def _expire(self, now: float, events: list[Event]):
        # queued requests past deadline never got a slot: drop silently
        # from the queue but loudly to the client.
        kept = deque()
        for req in self._queue:
            if req.deadline is not None and now >= req.deadline:
                events.append(Event("finish", req.rid, reason="deadline"))
            else:
                kept.append(req)
        self._queue = kept
        for req in [r for r in self._prefilling.values()
                    if r.deadline is not None and now >= r.deadline]:
            del self._prefilling[req.rid]
            del self._by_slot[req.slot]
            self.engine.abort_prefill(req.job)
            events.append(Event("finish", req.rid, reason="deadline"))
        for req in [r for r in self._running.values()
                    if r.deadline is not None and now >= r.deadline]:
            del self._running[req.rid]
            del self._by_slot[req.slot]
            self.engine.finish(req.slot)
            events.append(Event("finish", req.rid, reason="deadline"))

    def _admit(self, events: list[Event]):
        # in-flight prefills advance FIRST, even under hold: the epoch
        # fence must be able to drain them (active_count counts them),
        # it only stops NEW admissions below.
        self._advance_prefills(events)
        if self.hold:
            return
        while self._queue:
            req = self._queue[0]
            total = int(req.prompt.size) + req.max_new
            kv = self.engine.cache
            cached_len, pages = (self.prefix_cache.match(req.prompt)
                                 if self.prefix_cache is not None
                                 else (0, []))
            short = (kv.pages_for(total) - len(pages)) - kv.free_pages()
            if short > 0 and self.prefix_cache is not None:
                # eviction can reclaim pages the match itself returned
                # (match takes no references) — evict, then RE-match:
                # the matched path was just stamped MRU, so it is the
                # last thing evict_for_free lets go.
                self.prefix_cache.evict_for_free(short)
                cached_len, pages = self.prefix_cache.match(req.prompt)
            if not kv.can_admit(total, shared_pages=len(pages)):
                break
            self._queue.popleft()
            req.waited = self.clock() - req.submitted
            req.job = self.engine.begin(
                req.prompt, req.max_new, shared=pages,
                temperature=req.temperature, top_k=req.top_k,
                top_p=req.top_p, seed=req.seed)
            req.slot = req.job.slot
            req.cached = req.job.cached
            self._prefilling[req.rid] = req
            self._by_slot[req.slot] = req
            # pump the fresh job in the SAME round — an idle engine runs
            # it straight to the first token, so TTFT never pays an
            # extra scheduling round for the chunking machinery.
            self._pump_prefill(req, events)

    def _advance_prefills(self, events: list[Event]):
        for req in list(self._prefilling.values()):
            self._pump_prefill(req, events)

    def _pump_prefill(self, req: Request, events: list[Event]):
        """One prefill advance: a single bounded chunk while decode
        streams are running (their TPOT budget), straight to completion
        otherwise — with nobody decoding there is nobody to stall."""
        chunk = self.prefill_chunk if self._running else None
        first = self.engine.prefill_step(req.job, chunk=chunk)
        if first is None:
            return
        del self._prefilling[req.rid]
        self._running[req.rid] = req
        if self.prefix_cache is not None:
            # retain the finished prompt's whole pages for later
            # admissions (already-cached spans are skipped inside)
            self.prefix_cache.insert(
                req.prompt, self.engine.cache.block_table[req.slot])
        self._emit(req, int(first), events, first_tok=True,
                   waited=req.waited, cached=req.cached or None)

    def _tick(self, events: list[Event]):
        if not self._running:
            return
        drafts: dict[int, list[int]] = {}
        if self.drafter is not None:
            kv = self.engine.cache
            for req in self._running.values():
                if req.temperature > 0 or not req.speculate:
                    continue        # sampling does not follow argmax
                budget = min(self.drafter.k,
                             req.max_new - req.emitted - 1,
                             int(kv.limit[req.slot])
                             - int(kv.lengths[req.slot]) - 1)
                if budget < 1:
                    continue
                d = self.drafter.propose(
                    [int(t) for t in req.prompt] + req.tokens, k=budget)
                if d:
                    drafts[req.slot] = d
        if not drafts:
            # the plain tick IS today's path, bit for bit
            for slot, tok in self.engine.tick().items():
                req = self._by_slot.get(slot)
                if req is not None and req.rid in self._running:
                    self._emit(req, int(tok), events)
            return
        for slot, toks in self.engine.verify(drafts).items():
            req = self._by_slot.get(slot)
            if req is None:
                continue
            accepted = len(toks) - 1
            for i, tok in enumerate(toks):
                if req.rid not in self._running:
                    break           # eos mid-run: rest are discarded
                self._emit(req, int(tok), events,
                           accepted=accepted if i == len(toks) - 1
                           else None)
        rest = [s for s, r in self._by_slot.items()
                if r.rid in self._running and s not in drafts]
        if rest:
            for slot, tok in self.engine.tick(include=rest).items():
                req = self._by_slot.get(slot)
                if req is not None and req.rid in self._running:
                    self._emit(req, int(tok), events)

    def _emit(self, req: Request, tok: int, events: list[Event],
              first_tok: bool = False, waited: float | None = None,
              accepted: int | None = None, cached: int | None = None):
        req.emitted += 1
        req.tokens.append(tok)
        events.append(Event("token", req.rid, token=tok, first=first_tok,
                            waited=waited, accepted=accepted,
                            cached=cached))
        done_eos = req.eos is not None and tok == req.eos
        if req.emitted >= req.max_new or done_eos:
            del self._running[req.rid]
            del self._by_slot[req.slot]
            self.engine.finish(req.slot)
            events.append(Event("finish", req.rid,
                                reason="eos" if done_eos else "complete"))
