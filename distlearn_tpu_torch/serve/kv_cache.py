"""A copy of ``distlearn_tpu/serve/kv_cache.py`` (numpy only; the pools
themselves are the port engine's device tensors).

Fixed-slot paged KV cache — the serving engine's memory manager.

vLLM/PagedAttention (Kwon et al., SOSP '23) decouples a request's
logical K/V sequence from physical storage: the device holds one page
POOL per layer (``[depth, num_pages, page, H, D]``) and each of the
``num_slots`` request slots owns a BLOCK TABLE row mapping its logical
pages to pool pages.  Admission allocates exactly the pages a request
can ever touch (``prompt_len + max_new`` positions, rounded up to whole
pages); finish/evict returns them to the free list.  Slots are the unit
of batching: the decode tick (``serve.engine``) advances every ACTIVE
slot by one token in a single compiled program, gathering each slot's
K/V through its block-table row.

Admit/evict/finish happen BETWEEN ticks, on the host, in plain Python —
this module never imports the compiled side.  It owns three invariants
the tests pin down (tests/test_serve.py):

* **No stale reads.**  Freed pages are returned to the pool without
  zeroing.  A new request can only read cache positions below its own
  current length, and every one of those positions was freshly written
  by its OWN prefill scatter or decode ticks — so recycled bytes are
  never observable (the parity test decodes through heavy slot reuse
  and must stay token-identical to isolated runs).
* **Page 0 is the trash page.**  It is never allocated; freed block
  table rows reset to 0 and unallocated tail entries stay 0, so masked
  lanes (inactive slots, padded prefill tails) scatter there instead of
  into live data.
* **Exact accounting.**  Every allocatable page is either on the free
  list (refcount 0) or referenced (refcount >= 1):
  ``free_pages + pages-with-ref > 0 == num_pages - 1`` at all times;
  double-free and double-admit raise instead of corrupting the pool.

Pages are REFERENCE COUNTED so one physical page can back the same
logical prefix position of several slots at once (and be retained by
the radix prefix cache, :mod:`distlearn_tpu_torch.serve.prefix_cache`, after
every owning request finished).  Sharing is restricted to WHOLE pages
strictly before a request's first self-written position, which makes
the copy-on-write discipline structural: a slot only ever writes cache
positions ``>= cached_len`` (its shared-page count times the page
size), so a write into a shared page cannot be expressed — there is
nothing to copy because the writer's pages and the shared pages are
disjoint rows of its block table by construction.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


class CacheFull(RuntimeError):
    """No free slot, or not enough free pages for the request."""


class PagedKVCache:
    """Host-side slot/page bookkeeping for the serving engine.

    The device arrays (the pools themselves) live in the engine; this
    class owns the integer state the compiled tick consumes: the block
    tables, per-slot lengths, last-emitted tokens, and the active mask.
    """

    def __init__(self, num_slots: int, page: int, max_len: int,
                 num_pages: int | None = None):
        if num_slots < 1 or page < 1 or max_len < 1:
            raise ValueError(f"num_slots={num_slots}, page={page}, "
                             f"max_len={max_len} must all be >= 1")
        self.num_slots = int(num_slots)
        self.page = int(page)
        self.max_len = int(max_len)
        #: logical pages a slot can address (the gather width of the tick)
        self.pages_per_slot = -(-self.max_len // self.page)
        # default pool: every slot can hold a full-length request, plus
        # the reserved trash page 0
        if num_pages is None:
            num_pages = self.num_slots * self.pages_per_slot + 1
        if num_pages < 2:
            raise ValueError(f"num_pages={num_pages} leaves no allocatable "
                             "page beyond the reserved trash page 0")
        self.num_pages = int(num_pages)
        self._free: list[int] = list(range(self.num_pages - 1, 0, -1))
        #: per-page reference count: 0 = free (or the trash page),
        #: 1 = one owner (a slot row or a prefix-cache node), >1 shared.
        self.ref = np.zeros((self.num_pages,), np.int32)
        # block_table[s, j] = pool page backing slot s's logical page j
        # (0 = trash: unallocated)
        self.block_table = np.zeros((self.num_slots, self.pages_per_slot),
                                    np.int32)
        self.lengths = np.zeros((self.num_slots,), np.int32)
        self.last_tok = np.zeros((self.num_slots,), np.int32)
        self.active = np.zeros((self.num_slots,), bool)
        #: per-slot hard cap (prompt_len + max_new) — the engine stops a
        #: slot before it writes past its allocation
        self.limit = np.zeros((self.num_slots,), np.int32)

    # -- capacity queries ---------------------------------------------------
    def pages_for(self, total_len: int) -> int:
        return -(-int(total_len) // self.page)

    def free_pages(self) -> int:
        return len(self._free)

    def free_slots(self) -> int:
        return int((~self.active).sum())

    def can_admit(self, total_len: int, shared_pages: int = 0) -> bool:
        """True when a request needing ``total_len`` cache positions has
        both a free slot and enough free pages; ``shared_pages`` leading
        pages come from the prefix cache and cost nothing."""
        return (self.free_slots() > 0
                and self.pages_for(total_len) - int(shared_pages)
                <= len(self._free)
                and total_len <= self.max_len)

    # -- page reference counting (prefix-cache sharing) ---------------------
    def share(self, pages: Iterable[int]):
        """Take one more reference on each (already-allocated) page —
        a prefix-cache node retaining them, or a slot adopting a cached
        prefix.  Sharing a free page or the trash page is a bug."""
        for p in pages:
            p = int(p)
            if p <= 0 or p >= self.num_pages:
                raise ValueError(f"page {p} outside the pool")
            if self.ref[p] < 1:
                raise ValueError(f"page {p} is free — cannot share")
            self.ref[p] += 1

    def unref(self, pages: Iterable[int]) -> int:
        """Drop one reference per page; pages reaching refcount 0 return
        to the free list.  Returns how many pages were actually freed."""
        freed = 0
        for p in pages:
            p = int(p)
            if p <= 0 or p >= self.num_pages or self.ref[p] < 1:
                raise ValueError(f"page {p} is not allocated (double "
                                 "unref?)")
            self.ref[p] -= 1
            if self.ref[p] == 0:
                self._free.append(p)
                freed += 1
        return freed

    # -- slot lifecycle -----------------------------------------------------
    def admit(self, total_len: int,
              shared: Sequence[int] = ()) -> int:
        """Claim a free slot and allocate pages for ``total_len`` cache
        positions.  ``shared`` (optional) is a list of already-written
        pages from the prefix cache installed as the slot's leading
        block-table rows — each gains a reference instead of an
        allocation, so a 90%-overlap prompt only allocates its suffix.
        Returns the slot index; raises :class:`CacheFull` when capacity
        is short (callers gate on :meth:`can_admit`)."""
        total_len = int(total_len)
        if total_len < 1 or total_len > self.max_len:
            raise ValueError(f"total_len={total_len} outside "
                             f"[1, max_len={self.max_len}]")
        need = self.pages_for(total_len)
        shared = [int(p) for p in shared]
        if len(shared) >= need:
            raise ValueError(
                f"{len(shared)} shared pages cover all {need} pages of "
                f"total_len={total_len}: the request must prefill at "
                "least its last position itself")
        if need - len(shared) > len(self._free):
            raise CacheFull(f"{need - len(shared)} pages needed, "
                            f"{len(self._free)} free")
        free = np.flatnonzero(~self.active)
        if not len(free):
            raise CacheFull("all slots busy")
        self.share(shared)      # validates before any state is touched
        slot = int(free[0])
        for j, p in enumerate(shared):
            self.block_table[slot, j] = p
        for j in range(len(shared), need):
            p = self._free.pop()
            self.block_table[slot, j] = p
            self.ref[p] = 1
        self.lengths[slot] = 0
        self.last_tok[slot] = 0
        self.limit[slot] = total_len
        self.active[slot] = True
        return slot

    def release(self, slot: int):
        """Finish/evict: drop the slot's page references and reset its
        block-table row to trash.  Pages still referenced elsewhere (a
        prefix-cache node, another slot sharing the prefix) survive;
        the rest return to the pool.  Page contents are NOT zeroed —
        the no-stale-reads invariant (module docstring) makes that
        unnecessary, and skipping it keeps eviction O(pages) host work."""
        slot = int(slot)
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active (double release?)")
        row = [int(p) for p in self.block_table[slot] if p]
        self.unref(row)
        self.block_table[slot] = 0
        self.lengths[slot] = 0
        self.last_tok[slot] = 0
        self.limit[slot] = 0
        self.active[slot] = False

    def check(self):
        """Assert the exact-accounting invariant (test hook)."""
        held = int((self.ref > 0).sum())
        if held + len(self._free) != self.num_pages - 1:
            raise AssertionError(
                f"page leak: {held} referenced + {len(self._free)} free "
                f"!= {self.num_pages - 1} allocatable")
        if len(set(self._free)) != len(self._free):
            raise AssertionError("duplicate page in free list")
        if self.ref[0] != 0:
            raise AssertionError("the trash page grew a reference")
        live = set(self.block_table[self.block_table > 0].tolist())
        if live & set(self._free):
            raise AssertionError("page both allocated and free")
        for p in live:
            if self.ref[p] < 1:
                raise AssertionError(f"page {p} in a block table with "
                                     f"refcount {self.ref[p]}")
        # each slot row must hold at least as many references as it has
        # pointers to the page (shared prefixes push the count higher)
        counts = np.bincount(self.block_table.reshape(-1),
                             minlength=self.num_pages)
        counts[0] = 0
        if (counts > self.ref).any():
            bad = np.flatnonzero(counts > self.ref).tolist()
            raise AssertionError(f"pages {bad} pointed to by more rows "
                                 "than their refcount")
