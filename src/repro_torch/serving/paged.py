"""Paged KV memory: page allocator + radix-style prefix cache.

Host-only numpy/hashlib code, copied from the reference package unchanged
in behaviour.

The paged arena replaces contiguous ``[n_slots, max_len]`` cache rows with a
global pool of fixed-size KV pages (``page_size`` tokens each) and a per-slot
block table.  Two host-side structures manage it:

``PageAllocator``
    A refcounted free-list over ``n_pages`` physical pages.  A page's
    refcount is the number of slot block-table references plus one if the
    prefix tree holds it.  Pages return to the free list exactly when the
    refcount reaches zero: free plus referenced pages always partition
    the pool, and multi-owner pages are trie-resident.

``RadixPrefixCache``
    A radix-style trie over prompt token chunks.  Each node covers one full
    page worth of tokens and is keyed by a blake2b digest *chain*
    (``digest = H(parent_digest || chunk_bytes)``), so digest equality means
    the entire prefix matches, not just the chunk.  Nodes store their chunk
    tokens and are verified on match — a hash collision degrades to a miss,
    never to wrong tokens.  Matching retains pages for the requesting slot
    BEFORE any eviction runs, which is what makes sharing copy-on-write by
    construction: shared pages have refcount >= 2 and are never handed out
    or evicted, and a diverging slot writes only into pages it owns alone
    (decode positions land past the shared prefix).

Eviction is LRU over *leaf* nodes whose page is trie-only (refcount == 1):
interior nodes are pinned by their children, shared pages by their slots.

Everything here is plain host numpy/python — device work stays in the
scheduler's decode steps.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence

import numpy as np

_DIGEST_SIZE = 16


def chunk_digests(tokens: np.ndarray, page_size: int) -> List[bytes]:
    """Digest chain over full ``page_size`` chunks of ``tokens``.

    ``digests[i]`` commits to tokens ``[0, (i+1)*page_size)`` — chain
    equality across requests implies the whole prefix is identical.
    """
    tokens = np.asarray(tokens, dtype=np.int32)
    out: List[bytes] = []
    parent = b""
    for c in range(tokens.size // page_size):
        chunk = tokens[c * page_size:(c + 1) * page_size]
        parent = hashlib.blake2b(
            parent + chunk.tobytes(), digest_size=_DIGEST_SIZE).digest()
        out.append(parent)
    return out


class PageAllocator:
    """Refcounted free-list over a fixed pool of KV pages."""

    def __init__(self, n_pages: int, page_size: int):
        assert n_pages > 0 and page_size > 0
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.refcount = np.zeros(self.n_pages, dtype=np.int32)
        # pop() hands out low page ids first — deterministic layouts
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` fresh pages (refcount 1 each)."""
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: want {n}, free {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            assert self.refcount[p] == 0
            self.refcount[p] = 1
        return pages

    def retain(self, page: int) -> None:
        assert self.refcount[page] > 0, "retain of a free page"
        self.refcount[page] += 1

    def release(self, page: int) -> None:
        assert self.refcount[page] > 0, "double free"
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free.append(int(page))


@dataclass
class _Node:
    digest: bytes
    parent: bytes                      # b"" at the root level
    page: int
    tokens: np.ndarray                 # the page_size tokens this node covers
    children: int = 0
    tick: int = 0


class RadixPrefixCache:
    """Digest-chain radix trie mapping prompt-token pages to physical pages."""

    def __init__(self, alloc: PageAllocator):
        self.alloc = alloc
        self.nodes: Dict[bytes, _Node] = {}
        self._tick = 0
        self.hits = 0                  # pages served from the trie
        self.misses = 0                # pages that had to be prefilled cold

    def __len__(self) -> int:
        return len(self.nodes)

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.tick = self._tick

    def match(self, digests: Sequence[bytes],
              tokens: np.ndarray) -> List[int]:
        """Longest verified prefix match; RETAINS each matched page for the
        caller (slot reference) before returning, so a following eviction
        pass can never free them."""
        P = self.alloc.page_size
        pages: List[int] = []
        for i, d in enumerate(digests):
            node = self.nodes.get(d)
            if node is None:
                break
            chunk = np.asarray(tokens[i * P:(i + 1) * P], dtype=np.int32)
            if not np.array_equal(node.tokens, chunk):
                break                  # hash collision -> treat as miss
            self.alloc.retain(node.page)
            self._touch(node)
            pages.append(node.page)
        self.hits += len(pages)
        self.misses += len(digests) - len(pages)
        return pages

    def insert(self, digests: Sequence[bytes], tokens: np.ndarray,
               pages: Sequence[int]) -> int:
        """Adopt ``pages`` (the slot's block-table prefix) into the trie.
        Existing nodes are kept (their physical page wins — the slot already
        borrowed it at match time); new nodes retain their page."""
        assert len(digests) == len(pages)
        P = self.alloc.page_size
        created = 0
        parent = b""
        for i, (d, pg) in enumerate(zip(digests, pages)):
            node = self.nodes.get(d)
            if node is None:
                node = _Node(
                    digest=d, parent=parent, page=int(pg),
                    tokens=np.asarray(tokens[i * P:(i + 1) * P],
                                      dtype=np.int32).copy())
                self.alloc.retain(node.page)
                self.nodes[d] = node
                if parent in self.nodes:
                    self.nodes[parent].children += 1
                created += 1
            self._touch(node)
            parent = d
        return created

    def evict_until(self, free_needed: int) -> int:
        """Evict LRU trie-only leaf pages until the allocator has
        ``free_needed`` free pages (or nothing evictable remains)."""
        evicted = 0
        while self.alloc.free_count < free_needed:
            victim: Optional[_Node] = None
            for node in self.nodes.values():
                if node.children:
                    continue
                if self.alloc.refcount[node.page] != 1:
                    continue           # some slot still maps this page
                if victim is None or node.tick < victim.tick:
                    victim = node
            if victim is None:
                break
            del self.nodes[victim.digest]
            if victim.parent in self.nodes:
                self.nodes[victim.parent].children -= 1
            self.alloc.release(victim.page)
            evicted += 1
        return evicted

    def clear(self) -> int:
        """Drop every node (releasing the trie's page references)."""
        n = len(self.nodes)
        for node in self.nodes.values():
            self.alloc.release(node.page)
        self.nodes.clear()
        return n

    def keys(self) -> FrozenSet[bytes]:
        return frozenset(self.nodes)

    def pages(self) -> Dict[int, bytes]:
        """page -> digest for every trie-resident page (audit helper)."""
        return {node.page: d for d, node in self.nodes.items()}
