"""Page-table memory management for the paged serving cache — a copy
of ``repro/serving/pages.py`` (plain Python and numpy; the port keeps
its own copy so that it never imports the reference package).

The paged engine (DESIGN.md §15) stores attention K/V as a pool of
fixed-size pages ``(num_pages, page_size, kv_heads, head_dim)`` instead
of one ``(slots, max_total)`` ring per lane. Two host-side structures
own that pool — everything here is plain Python/numpy bookkeeping; the
device only ever sees the static-shape ``(slots, pages_per_slot)`` page
map:

* :class:`PageTable` — free-list allocation with per-page refcounts.
  Page 0 is a reserved **dummy page**: retired / mid-prefill slots keep
  an all-dummy page-map row, so their (masked) decode writes land in a
  garbage sink instead of a live request's memory.

* :class:`PrefixTrie` — the resident-prefix index for prefix sharing.
  Nodes are keyed ``(parent_page, page_size-token chunk) -> page``;
  admission walks the prompt's full-page chunks and retains every
  matched page instead of re-prefilling it. Registration happens at
  prefill *completion* (a page is only shareable once its K/V are
  actually written), and a page leaves the trie the moment its refcount
  drops to zero.

Allocation is all-upfront at admission (``ceil((plen + budget) /
page_size)`` pages minus the shared prefix), so decode never allocates
and the only OOM point is admission — which defers instead of failing.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DUMMY_PAGE = 0


def pages_per_slot(max_total: int, page_size: int) -> int:
    """Static page-map width: enough pages for a full-length request."""
    return -(-max_total // page_size)


@dataclass
class PageTable:
    """Refcounted free-list allocator over ``num_pages`` cache pages.

    ``num_pages`` INCLUDES the reserved dummy page 0, mirroring the
    device-side pool shape; usable capacity is ``num_pages - 1``.
    """
    num_pages: int
    page_size: int
    _free: List[int] = field(default_factory=list)
    _ref: Dict[int, int] = field(default_factory=dict)

    def __post_init__(self):
        assert self.num_pages >= 2, "need at least one usable page"
        assert self.page_size >= 1
        # LIFO free list: recently-freed pages are reused first (their
        # contents are dead by construction — validity is masked by pos)
        self._free = list(range(self.num_pages - 1, DUMMY_PAGE, -1))
        self._ref = {}

    # ------------------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_live(self) -> int:
        return len(self._ref)

    @property
    def occupancy(self) -> float:
        usable = self.num_pages - 1
        return self.num_live / max(usable, 1)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` fresh pages (refcount 1 each); None if short —
        the scheduler's cue to defer admission, not an error."""
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for pg in pages:
            self._ref[pg] = 1
        return pages

    def retain(self, pages: Sequence[int]) -> None:
        """Bump refcounts of already-live pages (prefix sharing)."""
        for pg in pages:
            if pg == DUMMY_PAGE or pg not in self._ref:
                raise ValueError(f"retain of non-live page {pg}")
            self._ref[pg] += 1

    def release(self, pages: Sequence[int]) -> List[int]:
        """Drop one reference per page; returns the pages that hit
        refcount zero (now back on the free list)."""
        freed = []
        for pg in pages:
            if pg == DUMMY_PAGE or pg not in self._ref:
                raise ValueError(f"release of non-live page {pg}")
            self._ref[pg] -= 1
            if self._ref[pg] == 0:
                del self._ref[pg]
                self._free.append(pg)
                freed.append(pg)
        return freed

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)


class PrefixTrie:
    """Resident-prefix index: full-page token chunks -> live page ids.

    A node ``(parent_page, chunk) -> page`` means: the prompt prefix
    that ends with ``chunk`` (page_size tokens) on top of the prefix
    resident in ``parent_page``'s chain is cached in ``page``. The root
    parent is ``DUMMY_PAGE`` (no real page ever maps there).
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._nodes: Dict[Tuple[int, Tuple[int, ...]], int] = {}
        self._rev: Dict[int, Tuple[int, Tuple[int, ...]]] = {}

    def __len__(self) -> int:
        return len(self._nodes)

    def _chunks(self, prompt: np.ndarray, n: int):
        ps = self.page_size
        for ci in range(n):
            yield tuple(int(t) for t in prompt[ci * ps:(ci + 1) * ps])

    def match(self, prompt: np.ndarray, max_pages: int) -> List[int]:
        """Longest resident prefix of ``prompt``, as page ids, capped at
        ``max_pages`` (callers cap at ``(plen - 1) // page_size`` so at
        least one prompt token is always prefilled — the admission
        logits come from a real forward pass, never from a cache hit)."""
        pages: List[int] = []
        parent = DUMMY_PAGE
        for chunk in self._chunks(prompt, max_pages):
            page = self._nodes.get((parent, chunk))
            if page is None:
                break
            pages.append(page)
            parent = page
        return pages

    def register(self, prompt: np.ndarray, page_ids: Sequence[int]) -> int:
        """Publish ``prompt``'s first ``len(page_ids)`` full-page chunks
        as resident in ``page_ids``. Existing nodes win (first writer
        keeps the slot; the duplicate pages simply stay unshared).
        Returns the number of newly published pages."""
        added = 0
        parent = DUMMY_PAGE
        for ci, chunk in enumerate(self._chunks(prompt, len(page_ids))):
            key = (parent, chunk)
            page = self._nodes.get(key)
            if page is None:
                page = page_ids[ci]
                if page in self._rev:       # one trie slot per page
                    parent = page
                    continue
                self._nodes[key] = page
                self._rev[page] = key
                added += 1
            parent = page
        return added

    def forget(self, page: int) -> None:
        """Remove a freed page from the index (no-op if absent). By the
        prefix-closed retention invariant a freed page has no resident
        children, so single-node removal is complete."""
        key = self._rev.pop(page, None)
        if key is not None:
            del self._nodes[key]


__all__ = ["DUMMY_PAGE", "PageTable", "PrefixTrie", "pages_per_slot"]
