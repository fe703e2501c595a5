"""Host-side page allocator for the paged KV cache.

Counterpart of the JAX package's ``infer/paged_cache.py``, copied: the module
is plain Python, and the port may not import it. Behaviour is identical (held
by ``tests/test_torch_paged.py``):

- **Free-list allocation** with refcounts: a page may back several slots'
  tables at once (shared prefix blocks).
- **Content-addressed reuse**: every FULL page of a prompt is published
  under the key ``(parent_physical_page_id, exact_tokens_in_page)``; a later
  prompt whose leading blocks walk to published pages reuses them (refcount
  bump, no prefill). Keys chain through the *physical* parent page and
  compare the block's exact tokens, so equal keys mean equal full prefixes —
  no hash-collision exposure. Only full, immutable pages are shared.
- **LRU eviction**: published pages whose only reference is the content
  cache are reclaimable; allocation pressure evicts them oldest-first, and
  evicting a parent cascades to every descendant chained through it.

The device holds the pools, ``(L, n_pages, K, page_size, D)`` per K and V
(``infer/continuous.py``). Page 0 is a reserved sentinel: dead table entries
point at it and the per-tick tail flush aims its invalid rows at it, so live
data never collides with a stale table entry.
"""

from __future__ import annotations

from collections import OrderedDict, deque

__all__ = ["EvictedPage", "PageAllocator", "block_keys"]

PageKey = tuple[int, tuple[int, ...]]

# One page leaving the content cache, as ``on_evict`` reports it: the
# physical id being reclaimed, the chain root (<= 0 namespace), and the exact
# token blocks from the root up to and including this page.
EvictedPage = tuple[int, int, tuple[tuple[int, ...], ...]]


def block_keys(tokens: list[int], page_size: int, parents: list[int]) -> list[PageKey]:
    """Content keys for the FULL pages of ``tokens``: page i's key is
    ``(physical id of page i-1, page i's exact tokens)`` (parent 0 = the
    sentinel for the first page)."""
    out: list[PageKey] = []
    for i, start in enumerate(range(0, len(tokens) - page_size + 1, page_size)):
        parent = parents[i - 1] if i > 0 else 0
        out.append((parent, tuple(tokens[start:start + page_size])))
    return out


class PageAllocator:
    """Refcounted page pool bookkeeping with content-keyed reuse."""

    def __init__(self, n_pages: int, on_evict=None, group_payload=None):
        """``on_evict`` (optional) is called once per LRU reclaim with the
        evicted group — the claimed page plus every cascaded descendant,
        parent first, each an :data:`EvictedPage` — before the pages are
        handed back. ``group_payload`` (zero-argument predicate, default
        always true) gates collecting that group: a caller that only counts
        evictions gets an empty tuple and pays no chain walk."""
        if n_pages < 2:
            raise ValueError(f"need >= 2 pages (page 0 is reserved), got {n_pages}")
        self.n_pages = n_pages
        self.evictions = 0
        self._on_evict = on_evict
        self._group_payload = group_payload
        self._free: deque[int] = deque(range(1, n_pages))
        self._ref = [0] * n_pages
        self._key_to_page: dict[PageKey, int] = {}
        self._page_key: dict[int, PageKey] = {}
        # parent physical page -> keys of published children chained to it,
        # so evicting a parent cascades: a child key left behind after its
        # parent id is recycled would verify against the wrong content.
        self._children: dict[int, set[PageKey]] = {}
        # Insertion-ordered: the oldest published key evicts first.
        self._lru: OrderedDict[PageKey, None] = OrderedDict()
        # Published pages whose only reference is the content cache
        # (ref == 1), kept up to date at every ref/publish transition so
        # stats readers never scan.
        self._evictable = 0

    # -- capacity ------------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_evictable(self) -> int:
        """Published pages reclaimable right now (cache-only reference)."""
        return self._evictable

    def scan_evictable(self) -> int:
        """The O(published pages) count ``n_evictable`` must equal."""
        return sum(
            1 for k, p in list(self._key_to_page.items()) if self._ref[p] == 1
        )

    # -- alloc / free --------------------------------------------------------

    def alloc(self, n: int) -> list[int]:
        """Allocate ``n`` private pages (ref 1 each), evicting LRU published
        pages if the free list runs short. Raises when truly out."""
        out: list[int] = []
        while len(out) < n:
            if self._free:
                pid = self._free.popleft()
            else:
                pid = self._evict_one()
                if pid is None:
                    # Roll back so a failed multi-page request leaks nothing.
                    for p in out:
                        self.release(p)
                    raise MemoryError(
                        f"page pool exhausted ({self.n_pages} pages, 0 evictable)"
                    )
            self._ref[pid] = 1
            out.append(pid)
        return out

    def _evict_one(self) -> int | None:
        for key in self._lru:
            pid = self._key_to_page[key]
            if self._ref[pid] == 1:  # only the content cache holds it
                # Collect the group before unpublishing: the chain walk
                # needs the maps intact.
                group = ()
                if self._on_evict is not None and (
                    self._group_payload is None or self._group_payload()
                ):
                    group = self._collect_group(key, pid)
                self._unpublish(key, pid, claimed=True)
                self.evictions += 1
                if self._on_evict is not None:
                    self._on_evict(group)
                return pid
        return None

    def _chain_blocks(self, pid: int) -> tuple[int, tuple[tuple[int, ...], ...]]:
        """``(root, token blocks root..pid)`` for a published page: every
        published page's ancestors are published, so the walk up the parent
        keys always reaches a non-positive root."""
        blocks: list[tuple[int, ...]] = []
        cur = pid
        while cur > 0:
            key = self._page_key[cur]
            blocks.append(key[1])
            cur = key[0]
        return cur, tuple(reversed(blocks))

    def _collect_group(
        self, key: PageKey, pid: int,
        root: int | None = None,
        blocks: tuple[tuple[int, ...], ...] | None = None,
    ) -> list[EvictedPage]:
        """Claimed page + cascaded descendants, parent first. The chain walk
        runs once for the head; descendants extend the parent's blocks."""
        if blocks is None:
            root, blocks = self._chain_blocks(pid)
        out: list[EvictedPage] = [(pid, root, blocks)]
        for child_key in list(self._children.get(pid, ())):
            child_pid = self._key_to_page.get(child_key)
            if child_pid is not None:
                out.extend(self._collect_group(
                    child_key, child_pid, root, blocks + (child_key[1],)
                ))
        return out

    def _unpublish(self, key: PageKey, pid: int, *, claimed: bool) -> None:
        """Remove a published key and cascade through its descendants.
        ``claimed=True``: the caller (eviction inside ``alloc``) takes
        ``pid`` itself, so it must not also land on the free list. Cascaded
        descendants are never claimed: dropping the cache's reference frees
        them when nothing else holds them."""
        if self._ref[pid] == 1:
            self._evictable -= 1  # leaves the published set while cache-only
        del self._key_to_page[key]
        del self._page_key[pid]
        self._lru.pop(key, None)
        parent_kids = self._children.get(key[0])
        if parent_kids is not None:
            parent_kids.discard(key)
            if not parent_kids:
                del self._children[key[0]]
        for child_key in list(self._children.pop(pid, ())):
            child_pid = self._key_to_page.get(child_key)
            if child_pid is not None:
                self._unpublish(child_key, child_pid, claimed=False)
        if claimed:
            self._ref[pid] -= 1  # the cache's reference passes to the caller
        else:
            self.release(pid)  # the cache's own reference

    def purge_root(self, root: int) -> int:
        """Unpublish every chain published under content root ``root``;
        in-flight users keep their refcounts. Returns the number of
        first-level chains purged."""
        purged = 0
        for key in list(self._children.get(root, ())):
            pid = self._key_to_page.get(key)
            if pid is not None:
                self._unpublish(key, pid, claimed=False)
                purged += 1
        return purged

    def retain(self, pid: int) -> None:
        if self._ref[pid] == 1 and pid in self._page_key:
            self._evictable -= 1  # a published cache-only page gains a user
        self._ref[pid] += 1

    def release(self, pid: int) -> None:
        if pid == 0:
            return
        self._ref[pid] -= 1
        if self._ref[pid] < 0:
            raise AssertionError(f"double release of page {pid}")
        if self._ref[pid] == 1 and pid in self._page_key:
            self._evictable += 1  # a published page dropped to cache-only
        if self._ref[pid] == 0:
            self._free.append(pid)

    # -- content cache -------------------------------------------------------

    def lookup(self, key: PageKey) -> int | None:
        """Published page for content key ``key`` (bumps LRU recency)."""
        pid = self._key_to_page.get(key)
        if pid is not None:
            self._lru.move_to_end(key)
        return pid

    def publish(self, key: PageKey, pid: int) -> None:
        """Register ``pid`` as the page for ``key``. The cache takes its own
        reference, keeping the page resident (and reclaimable) after the
        owning request finishes. The first publisher wins."""
        if key in self._key_to_page:
            return
        self._key_to_page[key] = pid
        self._page_key[pid] = key
        self._children.setdefault(key[0], set()).add(key)
        self._lru[key] = None
        self._ref[pid] += 1
        if self._ref[pid] == 1:
            self._evictable += 1  # a bare cache insert is evictable at once

    def publish_chain(
        self, tokens: list[int], page_size: int, own_pages: list[int],
        root: int = 0,
    ) -> None:
        """Publish the full pages of ``tokens`` backed by ``own_pages`` (the
        owner's physical page per block). Walks the canonical chain: where a
        key is already published, the cached page becomes the next key's
        parent, so all equal prefixes share one chain. ``root`` namespaces
        the chain's first parent (non-positive, disjoint from page ids)."""
        parent = root
        for i, pid in enumerate(own_pages):
            block = tuple(tokens[i * page_size:(i + 1) * page_size])
            key = (parent, block)
            existing = self._key_to_page.get(key)
            if existing is None:
                self.publish(key, pid)
                parent = pid
            else:
                self._lru.move_to_end(key)
                parent = existing

    def match_prefix(self, tokens: list[int], page_size: int,
                     root: int = 0) -> list[int]:
        """Longest run of published pages covering ``tokens``' leading FULL
        pages, each retained for the caller. At least one token is always
        left unmatched so the caller's prefill produces next-token logits."""
        usable = len(tokens) - 1
        if usable < page_size:
            return []
        pages: list[int] = []
        parent = root
        for i in range(usable // page_size):
            block = tuple(tokens[i * page_size:(i + 1) * page_size])
            pid = self.lookup((parent, block))
            if pid is None:
                break
            pages.append(pid)
            parent = pid
        for pid in pages:
            self.retain(pid)
        return pages
