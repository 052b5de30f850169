"""A copy of ``distlearn_tpu/serve/prefix_cache.py`` over the port's
``obs`` and ``kv_cache``.

Radix-tree KV prefix cache — shared-system-prompt traffic prefills
once (RadixAttention, Zheng et al. 2023; SGLang).

The serving fleet's dominant traffic shape is a few long system
prompts fanned out under millions of distinct user suffixes.  Without
sharing, every request prefills its whole prompt from token 0; with
this cache, the K/V pages computed for a prompt's leading WHOLE pages
are retained after the request finishes and handed — by reference, not
copy — to every later request whose prompt starts with the same
tokens, so a 90%-overlap prompt prefills only its suffix.

Structure
---------
A radix tree over token sequences at PAGE granularity: every edge
label is a whole number of pages of tokens, children are keyed by
their edge's first page (one page of tokens compared at once), and
each node owns the pool pages backing exactly its own edge — a node's
full prefix is the concatenation of the edges (and pages) on its root
path.  Page granularity is what makes sharing safe without copies:

* **Lookup** (:meth:`match`) returns the longest cached prefix as a
  page-aligned token count plus the page ids backing it, capped one
  token short of the prompt (the engine must prefill at least the last
  prompt position itself to produce the first-token logits).
* **Sharing** is reference counting in :class:`~distlearn_tpu_torch.serve.
  kv_cache.PagedKVCache`: an admitted slot installs the matched pages
  as its leading block-table rows (``admit(shared=...)``), each node
  holds its own reference, and a page returns to the free list only
  when the last holder lets go.
* **Copy-on-write discipline is structural.**  A slot only ever writes
  positions ``>= cached_len``; those land in pages the slot allocated
  privately, never in a shared page, so there is no write to trap and
  no copy to make (docs/SERVING.md).  The reserved trash page 0 keeps
  absorbing masked-lane scatters exactly as before — it is never
  cached, never shared, never refcounted.
* **Eviction** (:meth:`evict`) walks least-recently-matched LEAF nodes
  under page pressure (a child's prefix needs its parent's pages, so
  interior nodes only become evictable after their subtree).  Dropping
  a node drops its references; pages shared with a still-running slot
  survive until that slot finishes.  :meth:`clear` drops the whole
  tree — the hot-weight-swap path: cached K/V was computed under the
  outgoing epoch, so the epoch fence (docs/SERVING.md) invalidates the
  cache before any new-epoch request can match stale pages.

The tree is host-side bookkeeping only (a few dict walks per request);
the device never sees it.  Single-threaded by design, like the
scheduler that drives it.
"""

from __future__ import annotations

from typing import Sequence

from distlearn_tpu_torch import obs
from distlearn_tpu_torch.serve.kv_cache import PagedKVCache


class _Node:
    """One radix-tree node: ``edge`` tokens (a whole number of pages)
    extending the parent's prefix, the pool pages backing exactly that
    edge, and children keyed by their edge's first page of tokens."""

    __slots__ = ("edge", "pages", "children", "parent", "stamp")

    def __init__(self, edge: tuple, pages: list, parent):
        self.edge = edge
        self.pages = pages
        self.children: dict[tuple, _Node] = {}
        self.parent = parent
        self.stamp = 0


class RadixPrefixCache:
    """Page-granular radix cache over one engine's :class:`PagedKVCache`.

    ``max_pages`` caps how many pool pages the cache may retain (default
    half the pool): the cache accelerates admission, it must never
    starve it.  ``clock`` is a logical LRU counter, not wall time —
    deterministic under test.
    """

    def __init__(self, kv: PagedKVCache, *, max_pages: int | None = None):
        self.kv = kv
        self.page = kv.page
        self.max_pages = (int(max_pages) if max_pages is not None
                          else max(1, (kv.num_pages - 1) // 2))
        self.root = _Node((), [], None)
        self.pages_held = 0
        self._stamp = 0
        self._c_hits = obs.counter(
            "serve_prefix_cache_hits_total",
            "admissions that reused at least one cached prefix page")
        self._c_miss = obs.counter(
            "serve_prefix_cache_misses_total",
            "admissions that found no cached prefix")
        self._c_evict = obs.counter(
            "serve_prefix_cache_evictions_total",
            "radix nodes dropped (LRU pressure or epoch invalidation)")
        self._g_pages = obs.gauge(
            "serve_prefix_cache_pages",
            "pool pages currently retained by the prefix cache")

    # -- introspection ------------------------------------------------------
    def stats(self) -> dict:
        return {"pages_held": self.pages_held, "max_pages": self.max_pages,
                "nodes": sum(1 for _ in self._walk())}

    def _walk(self):
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node is not self.root:
                yield node
            stack.extend(node.children.values())

    def _touch(self, node: _Node):
        self._stamp += 1
        # the whole root path is "used": a child match keeps its parents
        while node is not None and node is not self.root:
            node.stamp = self._stamp
            node = node.parent

    # -- lookup -------------------------------------------------------------
    def cacheable_len(self, prompt_len: int) -> int:
        """Longest sharable prefix of a ``prompt_len`` prompt: whole
        pages only, and at least one token left for the suffix prefill."""
        return max(0, (int(prompt_len) - 1) // self.page) * self.page

    def match(self, tokens) -> tuple[int, list[int]]:
        """Longest cached page-aligned prefix of ``tokens``.  Returns
        ``(cached_len, pages)`` — ``cached_len`` tokens covered by
        ``pages`` (``cached_len // page`` of them), both possibly 0.
        Counts a hit/miss and refreshes the matched path's LRU stamps;
        the caller installs the pages via ``kv.admit(shared=pages)``
        (which takes the references) in the same scheduling round."""
        toks = tuple(int(t) for t in tokens)
        cap = self.cacheable_len(len(toks))
        node, depth, pages = self.root, 0, []
        while depth + self.page <= cap:
            child = node.children.get(toks[depth:depth + self.page])
            if child is None:
                break
            el = len(child.edge)
            # longest whole-page agreement between the edge and the
            # prompt, clipped to the cacheable cap
            m = 0
            while (m + self.page <= el and depth + m + self.page <= cap
                   and child.edge[m:m + self.page]
                   == toks[depth + m:depth + m + self.page]):
                m += self.page
            if m == 0:
                break
            pages += child.pages[:m // self.page]
            depth += m
            self._touch(child)
            if m < el:
                break               # diverged (or capped) inside the edge
            node = child
        (self._c_hits if depth else self._c_miss).inc()
        return depth, pages

    # -- insert -------------------------------------------------------------
    def insert(self, tokens, pages: Sequence[int]) -> int:
        """Retain the prefix ``tokens[:cacheable_len]`` backed by the
        slot's leading ``pages`` (one per whole page of tokens, freshly
        written by that slot's prefill or adopted from an earlier
        match).  New coverage takes one reference per page; already-
        cached spans keep their existing pages (first writer wins — the
        duplicate pages stay owned by their slot alone and free with
        it).  Returns the number of newly retained pages."""
        toks = tuple(int(t) for t in tokens)
        cap = self.cacheable_len(len(toks))
        pages = [int(p) for p in pages[:cap // self.page]]
        node, depth, i, added = self.root, 0, 0, 0
        while depth < cap:
            child = node.children.get(toks[depth:depth + self.page])
            if child is None:
                take = self._budget_pages(len(pages) - i)
                if take == 0:
                    break
                edge = toks[depth:depth + take * self.page]
                new = _Node(edge, pages[i:i + take], node)
                self.kv.share(new.pages)
                self.pages_held += take
                added += take
                node.children[edge[:self.page]] = new
                self._touch(new)
                break
            el = len(child.edge)
            m = 0
            while (m + self.page <= el and depth + m < cap
                   and child.edge[m:m + self.page]
                   == toks[depth + m:depth + m + self.page]):
                m += self.page
            if m == 0:
                break               # same first page bytes can't differ —
                                    # cap must have run out exactly here
            if m < el:
                # split the edge at the divergence (page boundary) so the
                # shared span becomes a real node the new branch can join
                mid = _Node(child.edge[:m], child.pages[:m // self.page],
                            node)
                mid.stamp = child.stamp
                child.edge = child.edge[m:]
                child.pages = child.pages[m // self.page:]
                child.parent = mid
                mid.children[child.edge[:self.page]] = child
                node.children[mid.edge[:self.page]] = mid
                child = mid
            depth += m
            i += m // self.page
            node = child
            self._touch(node)
        self._g_pages.set(self.pages_held)
        return added

    def _budget_pages(self, want: int) -> int:
        """How many of ``want`` new pages the cache may retain, evicting
        LRU nodes to make room up to ``max_pages``."""
        room = self.max_pages - self.pages_held
        if room < want:
            self.evict_nodes(want - room)
            room = self.max_pages - self.pages_held
        return max(0, min(want, room))

    # -- eviction -----------------------------------------------------------
    def evict_nodes(self, pages_needed: int) -> int:
        """Drop least-recently-matched leaf nodes until at least
        ``pages_needed`` retained pages were let go (or nothing is left
        to evict).  Returns pages released by the CACHE — pages still
        shared with running slots free later, when those slots do."""
        released = 0
        while released < pages_needed:
            leaves = [n for n in self._walk() if not n.children]
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.stamp)
            released += self._drop(victim)
        self._g_pages.set(self.pages_held)
        return released

    def evict_for_free(self, pages_short: int) -> int:
        """Admission-pressure hook: the pool is ``pages_short`` free
        pages short, release cache references until the FREE LIST grew
        by that much (or the tree is empty).  Returns pages actually
        freed to the pool."""
        freed = 0
        while freed < pages_short:
            leaves = [n for n in self._walk() if not n.children]
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.stamp)
            held = len(victim.pages)
            before = self.kv.free_pages()
            self._drop(victim)
            freed += self.kv.free_pages() - before
            del held
        self._g_pages.set(self.pages_held)
        return freed

    def _drop(self, node: _Node) -> int:
        self.kv.unref(node.pages)
        released = len(node.pages)
        self.pages_held -= released
        del node.parent.children[node.edge[:self.page]]
        self._c_evict.inc()
        return released

    def clear(self) -> int:
        """Invalidate everything (epoch fence: new weights make every
        cached K/V page stale).  Returns pages released."""
        released = 0
        for node in list(self._walk()):
            self.kv.unref(node.pages)
            released += len(node.pages)
            self._c_evict.inc()
        self.root = _Node((), [], None)
        self.pages_held = 0
        self._g_pages.set(0)
        return released

    # -- invariants (test hook) ---------------------------------------------
    def check(self):
        """Tree/refcount conservation: every node's page count matches
        its edge length, no page is retained by two nodes, every
        retained page has a live reference, and ``pages_held`` is
        exact.  Composes with ``kv.check()`` for pool conservation."""
        seen: set[int] = set()
        held = 0
        for node in self._walk():
            if len(node.edge) % self.page:
                raise AssertionError(f"edge length {len(node.edge)} not "
                                     "page-aligned")
            if len(node.pages) * self.page != len(node.edge):
                raise AssertionError("edge/pages length mismatch")
            for p in node.pages:
                if p in seen:
                    raise AssertionError(f"page {p} retained twice")
                if p <= 0:
                    raise AssertionError("trash page in the tree")
                if self.kv.ref[p] < 1:
                    raise AssertionError(f"retained page {p} has no ref")
                seen.add(p)
            held += len(node.pages)
            if node.children and not all(
                    c.parent is node for c in node.children.values()):
                raise AssertionError("child with a stale parent link")
        if held != self.pages_held:
            raise AssertionError(f"pages_held {self.pages_held} != "
                                 f"{held} counted")
        self.kv.check()
