"""Radix-tree prefix cache over the PagedKVCache page pool.

The port of ``vescale_tpu/serve/prefix_cache.py``: host logic only, no
tensor touched, the same tree and the same calls into the cache for the same
admission history, so the cache fingerprint agrees with the JAX package's.

The vLLM/SGLang lever (arXiv:2309.06180): requests that share a prompt
prefix — system prompts, few-shot preambles, session history — should
share the K/V pages that prefix already earned, not recompute them.  This
module keeps a radix tree keyed on PAGE-GRANULAR token blocks: every edge
label is a whole number of pages (``page_size`` tokens each) and carries
the page ids holding those positions' K/V in the pool.  Admission walks
the tree, maps every matched page straight into the new slot's page table
(:meth:`PagedKVCache.alloc_shared` — one refcount each, no bytes move),
and the engine prefills only the suffix.

Design points, in the repo's standing contract:

  * **Determinism** — the tree is a pure function of the admission
    history: matching is exact token comparison, insertion adopts pages in
    admission order, and eviction is LRU over UNREFERENCED leaves with a
    logical clock (monotone counter, never wall time) and an insertion-
    sequence tie-break.  Two ranks driving the same request stream hold
    bit-identical trees.
  * **Digest coverage** — the tree never touches pool state except through
    ``retain_page``/``release_page``/``alloc_shared``, so every reference
    it takes or drops folds into the cache's event-sourced crc digest and
    the cross-rank fingerprint covers prefix sharing with zero
    new machinery.
  * **Safety** — a cached page is pinned by the tree's own reference; a
    slot eviction (oom fault, timeout, drain) drops only the slot's
    reference, so shared bytes survive for the victim's replay to re-hit.
    Conversely the tree only evicts leaves whose pages have no OTHER
    holder, so eviction can never free a page a live slot still reads.
  * **Match cap** — a full-prompt hit would leave nothing to prefill and
    therefore no logits to sample the first token from; matches are capped
    at the last page boundary STRICTLY below the prompt length, so at
    least one token always runs through the engine.

Only FULL pages are ever cached: positions past the last page boundary of
a prompt live in the request's private tail page (decode appends there),
so shared pages hold only immutable positions — every write lands at
``pos >= lengths`` and shared pages cover ``pos < matched <= lengths``.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

from .. import config as _config
from .kv_cache import PagedKVCache

__all__ = ["PrefixCache", "PrefixCacheStats"]


class _Node:
    """One radix edge: ``key`` (a whole number of page blocks of tokens)
    and the page ids holding their K/V.  Children are keyed by their
    FIRST page block, so two siblings always differ within one page and
    splits only ever happen at page boundaries."""

    __slots__ = ("key", "pages", "children", "parent", "last_use", "seq")

    def __init__(self, key: Tuple[int, ...], pages: List[int],
                 parent: Optional["_Node"], seq: int):
        self.key = key
        self.pages = pages
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_use = seq
        self.seq = seq


class PrefixCacheStats:
    __slots__ = ("hits", "misses", "hit_tokens", "prompt_tokens",
                 "inserted_pages", "evicted_pages")

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.prompt_tokens = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    def hit_rate(self) -> Optional[float]:
        """Fraction of admitted PROMPT tokens served from cached pages —
        the `/router` v3 ``prefix_hit_rate`` field."""
        if not self.prompt_tokens:
            return None
        return self.hit_tokens / self.prompt_tokens


class PrefixCache:
    """The radix tree + its pool bookkeeping.  One per scheduler; the
    scheduler consults it at admission (:meth:`try_admit`) and feeds it
    every prefill (:meth:`insert`)."""

    def __init__(self, cache: PagedKVCache, max_pages: Optional[int] = None):
        self.cache = cache
        self.page = cache.config.page_size
        # cap on tree-RETAINED pages (0/None = bounded only by the pool);
        # insertion evicts LRU leaves to fit and skips what still won't
        self.max_pages = int(max_pages) if max_pages else 0
        self.root = _Node((), [], None, 0)
        self._seq = 0
        self.retained_pages = 0
        self.stats = PrefixCacheStats()

    @classmethod
    def from_env(cls, cache: PagedKVCache) -> "PrefixCache":
        return cls(cache, max_pages=_config.get_int("VESCALE_SERVE_PREFIX_CACHE_PAGES"))

    def _tick(self) -> int:
        self._seq += 1
        return self._seq

    # -------------------------------------------------------------- match
    def _match_cap(self, prompt_len: int) -> int:
        """Largest cacheable prefix of a prompt: whole pages, strictly
        below the prompt length (>= 1 token must always prefill)."""
        return max(0, (prompt_len - 1) // self.page) * self.page

    def match(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Walk the tree over ``tokens`` (already capped by the caller):
        returns (matched token count, page ids in position order).  Only
        whole page blocks match; a walk may stop MID-edge at a page
        boundary (matching never splits — insertion does).  Touched nodes
        bump their LRU clock."""
        t = tuple(int(x) for x in tokens)
        node = self.root
        pages: List[int] = []
        matched = 0
        while matched + self.page <= len(t):
            blk = t[matched:matched + self.page]
            child = node.children.get(blk)
            if child is None:
                break
            nblocks = len(child.key) // self.page
            take = 0
            for i in range(nblocks):
                seg = t[matched + i * self.page: matched + (i + 1) * self.page]
                if len(seg) < self.page or seg != child.key[i * self.page:(i + 1) * self.page]:
                    break
                take += 1
            child.last_use = self._tick()
            pages.extend(child.pages[:take])
            matched += take * self.page
            if take < nblocks:
                break  # partial edge: stop (no split on the read path)
            node = child
        return matched, pages

    # -------------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int], page_row: Sequence[int]) -> int:
        """Adopt a freshly prefilled prompt's FULL pages into the tree:
        ``page_row`` is the slot's page-table row (position order).  Blocks
        the tree already holds are deduplicated (the existing page wins —
        the slot keeps its private duplicate until it frees); new blocks
        retain the slot's pages.  Returns the number of pages adopted."""
        t = tuple(int(x) for x in tokens)
        nfull = len(t) // self.page
        if nfull == 0:
            return 0
        node = self.root
        blocks_done = 0
        # ---- walk existing structure, splitting at the divergence point
        while blocks_done < nfull:
            blk = t[blocks_done * self.page:(blocks_done + 1) * self.page]
            child = node.children.get(blk)
            if child is None:
                break
            nblocks = len(child.key) // self.page
            take = 0
            for i in range(nblocks):
                seg = t[(blocks_done + i) * self.page:(blocks_done + i + 1) * self.page]
                if len(seg) < self.page or seg != child.key[i * self.page:(i + 1) * self.page]:
                    break
                take += 1
            child.last_use = self._tick()
            blocks_done += take
            if take < nblocks:
                if blocks_done >= nfull:
                    return 0  # prompt ends inside a longer cached edge
                # diverged mid-edge at a page boundary: split the edge so
                # the shared prefix becomes its own node
                self._split(child, take)
                node = child
                continue
            node = child
        if blocks_done >= nfull:
            return 0  # fully covered already
        # ---- adopt the remaining blocks as ONE new leaf edge
        want = nfull - blocks_done
        # protect the attach node: cap-driven eviction could otherwise
        # cascade onto the walked path once its leaves go (evict a leaf,
        # its childless parent becomes evictable ...) and the new leaf
        # would attach to a DETACHED node — retained pages leaking out of
        # the tree forever; a node with protected pages is never a
        # victim, so every ancestor keeps >=1 child and stays safe too
        want = self._fit(want, protect=node.pages)
        if want <= 0:
            return 0
        key = t[blocks_done * self.page:(blocks_done + want) * self.page]
        pages = [int(page_row[blocks_done + i]) for i in range(want)]
        for p in pages:
            self.cache.retain_page(p)
        self.retained_pages += want
        self.stats.inserted_pages += want
        seq = self._tick()
        leaf = _Node(key, pages, node, seq)
        node.children[key[:self.page]] = leaf
        return want

    def _split(self, node: _Node, at_blocks: int) -> None:
        """Split ``node``'s edge after ``at_blocks`` page blocks: the node
        keeps the prefix, a new child takes the suffix (and the node's
        children)."""
        cut = at_blocks * self.page
        suffix = _Node(node.key[cut:], node.pages[at_blocks:], node, node.seq)
        suffix.children = node.children
        for c in suffix.children.values():
            c.parent = suffix
        suffix.last_use = node.last_use
        node.key = node.key[:cut]
        node.pages = node.pages[:at_blocks]
        node.children = {suffix.key[:self.page]: suffix}

    # ------------------------------------------------------------- evict
    def _leaves(self) -> List[_Node]:
        out: List[_Node] = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            kids = list(n.children.values())
            if not kids and n is not self.root:
                out.append(n)
            stack.extend(kids)
        return out

    def _evictable(self, node: _Node, protect: Sequence[int]) -> bool:
        """A leaf is evictable when NO page of its edge has a holder other
        than the tree itself (and none is protected — e.g. the pages the
        in-progress admission just matched)."""
        prot = set(protect)
        return all(
            self.cache.page_ref(p) == 1 and p not in prot for p in node.pages
        )

    def evict(self, need_pages: int, protect: Sequence[int] = ()) -> int:
        """Free LRU unreferenced leaves until ``need_pages`` pages have
        returned to the pool (or nothing evictable remains).  Fully
        deterministic: victims order by (last_use, seq).  Returns pages
        freed."""
        freed = 0
        # one DFS seeds the candidate heap; evicting a leaf can only
        # newly expose its PARENT (page refs of other nodes are
        # untouched), so candidates grow incrementally — same
        # deterministic (last_use, seq) victim order as recomputing the
        # leaf set per victim, without the O(nodes x victims) rescans
        # third key: push order — a split suffix INHERITS its node's
        # (last_use, seq), so without it a tuple tie would fall through
        # to comparing _Node objects (TypeError); tied pairs are always
        # ancestor/descendant and never coexist here, but cheap armor
        leaves = self._leaves()
        heap = [
            (n.last_use, n.seq, i, n)
            for i, n in enumerate(leaves) if self._evictable(n, protect)
        ]
        heapq.heapify(heap)
        pushes = len(leaves)
        while freed < need_pages and heap:
            _, _, _, victim = heapq.heappop(heap)
            for p in victim.pages:
                self.cache.release_page(p)
            n = len(victim.pages)
            freed += n
            self.retained_pages -= n
            self.stats.evicted_pages += n
            parent = victim.parent
            parent.children.pop(victim.key[:self.page])
            if (parent is not self.root and not parent.children
                    and self._evictable(parent, protect)):
                heapq.heappush(
                    heap, (parent.last_use, parent.seq, pushes, parent))
                pushes += 1
        return freed

    def _fit(self, want_pages: int, protect: Sequence[int]) -> int:
        """How many of ``want_pages`` the retention cap allows, after
        evicting LRU leaves to make room under it."""
        if not self.max_pages:
            return want_pages
        room = self.max_pages - self.retained_pages
        if room < want_pages:
            self.evict(want_pages - room, protect)
            room = self.max_pages - self.retained_pages
        return max(0, min(want_pages, room))

    # ---------------------------------------------------------- admission
    def evictable_pages(self, protect: Sequence[int] = ()) -> int:
        return sum(
            len(n.pages)
            for n in self._leaves() if self._evictable(n, protect)
        )

    def try_admit(self, prompt: Sequence[int], max_new_tokens: int,
                  slot: Optional[int] = None) -> Optional[Tuple[int, int]]:
        """The full admission path: match, evict to make room for the
        fresh remainder (matched pages protected), map shared pages into a
        new slot.  Returns (slot, matched_tokens) or None when the request
        cannot be admitted right now — with NO state mutated beyond LRU
        clocks and (possibly) evictions that were necessary to even try."""
        cache = self.cache
        total = len(prompt) + max_new_tokens
        if total > cache.max_seq_len or cache.free_slot_count() == 0:
            return None
        matched, pages = self.match(tuple(prompt)[: self._match_cap(len(prompt))])
        fresh = cache.pages_needed(total) - len(pages)
        short = fresh - cache.free_page_count()
        if short > 0 and self.evict(short, protect=pages) < short:
            return None
        got = cache.alloc_shared(pages, len(prompt), max_new_tokens, slot=slot)
        self.stats.prompt_tokens += len(prompt)
        self.stats.hit_tokens += matched
        if matched:
            self.stats.hits += 1
        else:
            self.stats.misses += 1
        return got, matched

    # ------------------------------------------------------------- misc
    def reset(self) -> None:
        """Drop the whole tree: every retained page loses its tree
        reference (returning to the pool unless a live slot still maps
        it), for a bench that reuses one engine across runs."""
        stack = [self.root]
        while stack:
            n = stack.pop()
            for p in n.pages:
                self.cache.release_page(p)
            stack.extend(n.children.values())
        self.root = _Node((), [], None, 0)
        self.retained_pages = 0

    def node_count(self) -> int:
        count = 0
        stack = [self.root]
        while stack:
            n = stack.pop()
            count += 1
            stack.extend(n.children.values())
        return count - 1  # root is not a real edge
