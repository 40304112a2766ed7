"""Host-side bookkeeping for the paged KV cache (an own copy of
``repro.serving.paged``; DESIGN.md §15).

Two small structures, both pure host state (the device only ever sees the
pool tensors and per-slot page tables the engine derives from them):

* ``PagePool`` — the free list + reference counts over ``n_pages`` physical
  pages.  A page is held by the request(s) mapping it and/or by one radix
  node; it returns to the free list only when the last holder releases it
  ("evict only fully-released pages" is enforced here, not by callers).

* ``RadixCache`` — a trie over page-granular token chunks.  A node keys one
  full page of prompt tokens and pins the physical page holding that page's
  K/V.  ``match`` walks a new prompt down the trie and returns the shared
  physical pages (reference-counted for the caller); ``insert`` publishes a
  finished request's full prompt pages so future requests hit.  Eviction
  walks leaves in LRU order and only touches nodes whose page has no
  request holders — a shared prefix can never be yanked from under a live
  request.

Admission books pages against this pool: a request needs
``ceil((prompt + max_new) / page)`` pages minus whatever the radix match
supplies, and waits (queue backpressure, not an error) when the pool cannot
serve it even after eviction.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple


class PagePool:
    """Free list + refcounts over physical KV pages."""

    def __init__(self, n_pages: int, page_size: int):
        assert n_pages > 0 and page_size > 0
        self.n_pages = n_pages
        self.page_size = page_size
        self.free: List[int] = list(range(n_pages - 1, -1, -1))
        self.ref = [0] * n_pages

    @property
    def n_free(self) -> int:
        return len(self.free)

    @property
    def n_used(self) -> int:
        return self.n_pages - len(self.free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages (refcount 1 each) or None if short."""
        if n > len(self.free):
            return None
        out = [self.free.pop() for _ in range(n)]
        for p in out:
            self.ref[p] = 1
        return out

    def incref(self, pages) -> None:
        for p in pages:
            assert self.ref[p] > 0, f"incref on free page {p}"
            self.ref[p] += 1

    def release(self, pages) -> List[int]:
        """Drop one reference per page; returns the pages that became free
        (the engine must reset their stored positions before reuse)."""
        freed = []
        for p in pages:
            assert self.ref[p] > 0, f"release of free page {p}"
            self.ref[p] -= 1
            if self.ref[p] == 0:
                self.free.append(p)
                freed.append(p)
        return freed


@dataclasses.dataclass
class _Node:
    key: Tuple[int, ...]                 # one page of token ids
    page: int                            # physical page holding its K/V
    parent: Optional["_Node"]
    children: Dict[Tuple[int, ...], "_Node"] = dataclasses.field(
        default_factory=dict)
    stamp: int = 0                       # LRU clock


class RadixCache:
    """Page-granular prefix trie over prompt token ids.

    Every node holds one pool reference on its page for as long as it lives;
    ``evict`` drops leaf nodes (LRU first) whose page has no other holders,
    freeing exactly those pages no live request maps.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.root = _Node((), -1, None)
        self._clock = itertools.count(1)
        self._nodes = 0

    def __len__(self) -> int:
        return self._nodes

    def _chunks(self, tokens) -> List[Tuple[int, ...]]:
        pg = self.pool.page_size
        n_full = len(tokens) // pg
        return [tuple(int(x) for x in tokens[i * pg:(i + 1) * pg])
                for i in range(n_full)]

    def match(self, tokens) -> Tuple[List[int], int]:
        """Longest page-aligned cached prefix of ``tokens``.  Returns
        (physical pages, matched token count); the matched pages carry one
        fresh reference each, owned by the caller (release when done)."""
        stamp = next(self._clock)
        node, pages = self.root, []
        for key in self._chunks(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.stamp = stamp
            pages.append(child.page)
            node = child
        if pages:
            self.pool.incref(pages)
        return pages, len(pages) * self.pool.page_size

    def insert(self, tokens, pages: List[int]) -> int:
        """Publish the full-page prefix of ``tokens`` (K/V living in
        ``pages``, one physical page per chunk).  Existing nodes win —
        duplicate content keeps the incumbent page so the newcomer's copy
        can be released by its owner.  Returns #nodes added."""
        stamp = next(self._clock)
        node, added = self.root, 0
        for key, page in zip(self._chunks(tokens), pages):
            child = node.children.get(key)
            if child is None:
                self.pool.incref([page])
                child = _Node(key, page, node, stamp=stamp)
                node.children[key] = child
                self._nodes += 1
                added += 1
            else:
                child.stamp = stamp
            node = child
        return added

    def evict(self, n_pages: int) -> List[int]:
        """Free up to ``n_pages`` pages by dropping LRU leaves whose page is
        held by nobody but this cache.  Returns the freed page ids."""
        freed: List[int] = []
        while len(freed) < n_pages:
            victims = [node for node in self._leaves()
                       if self.pool.ref[node.page] == 1]
            if not victims:
                break
            victim = min(victims, key=lambda nd: nd.stamp)
            freed.extend(self.pool.release([victim.page]))
            del victim.parent.children[victim.key]
            self._nodes -= 1
        return freed

    def _leaves(self):
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                yield node
