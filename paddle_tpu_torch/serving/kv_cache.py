"""Block-paged KV cache, the serving engine's memory subsystem
(counterpart: ``paddle_tpu/serving/kv_cache.py``).

- K/V live in ONE device tensor ``[2, n_layers, num_pages, page_size,
  n_kv_heads, head_dim]`` (bf16/f32; K at index 0, V at 1), or int8
  codes of that shape plus one float32 tensor of per-(slot, kv-head)
  absmax scales ``[2, n_layers, num_pages, page_size, n_kv_heads]`` for
  ``dtype="int8"``. ``k_pages[l]`` / ``v_pages[l]`` (and the scale
  lists) are contiguous per-layer views of it: the attention kernel's
  operands. A page chain of every layer moves in ONE gather or scatter
  along the page axis (two for int8): page export, import, the tier's
  spill and restore, copy-on-write.
- The host owns the bookkeeping: the free list, per-sequence page
  tables and refcounts. The device only sees int32 page-table and slot
  arrays.
- Page 0 is the reserved SCRATCH page: padded lanes write their garbage
  K/V there and padded page-table entries point at it.
- Copy-on-fork for ``n > 1`` sampling: ``fork()`` shares pages by
  refcount; the first append into a shared partial tail page returns a
  page copy that the engine applies (``apply_copies``) before it writes.
- Radix-tree prefix caching (``prefix_cache=True``): FULL pages of
  PROMPT tokens are registered in a token-keyed radix tree
  (``commit_prefix``) once their K/V is written, and a later sequence
  with the same token prefix shares them (``acquire_prefix``: a
  refcount bump, no device work). A cached page whose refcount drops to
  0 stays resident (reclaimable) and is LRU-evicted leaf-first only
  when the allocator needs the page; with a tier attached
  (:mod:`.kvtier`) its bytes spill to host RAM first. The last prompt
  token is never served from cache (its logits must come from a real
  prefill step).
- Page migration: ``export_pages`` / ``import_pages`` (a sequence's
  chain) and ``export_prefix_pages`` / ``import_prefix_pages`` (a
  cached chain) carry CPU tensors in the JAX package's list layout
  (per layer, K then V; int8 codes then scales), which
  :mod:`.pagewire` puts on the reference's wire format byte for byte.

Unlike the JAX package, which threads the pools through its compiled
step functionally and rebinds them after a scatter, every write here
(:meth:`PagedKVCache.write`, copies, imports, restores) goes into the
pools IN PLACE on the current stream, so the attention kernel launched
after it on the same stream reads the new keys. The pools are
allocated once and never replaced: the engine's CUDA graphs hold their
addresses.

Not ported: the tensor-parallel geometry (``tp_degree`` is always 1).
"""
from __future__ import annotations

import math
from collections import deque

import numpy as np
import torch

from ..device import dtype_name, resolve_device, resolve_dtype
from .attention import quantize_q8

__all__ = ["PagedKVCache", "OutOfPages", "SCRATCH_PAGE",
           "GeometryMismatch", "PrefixDrift"]

# page 0 is never handed to a sequence: padded lanes scatter/gather there
SCRATCH_PAGE = 0


def _viewed_stack(arrs):
    """The host stack ``[2, L, n, ...]`` whose per-layer views, in order,
    ``arrs`` are (the :meth:`PagedKVCache._payload` of a
    :meth:`PagedKVCache.stage`), or None."""
    base = getattr(arrs[0], "_base", None)
    if base is None or base.dim() < 3 or \
            base.shape[0] * base.shape[1] != len(arrs):
        return None
    views = base.flatten(0, 1)
    for a, w in zip(arrs, views):
        if a._base is not base or a.data_ptr() != w.data_ptr() \
                or a.shape != w.shape:
            return None
    return base


class OutOfPages(RuntimeError):
    """Raised by the allocator when the free list cannot cover a request
    — the scheduler's signal to preempt or defer admission."""

    def __init__(self, needed, free):
        super().__init__(
            f"paged KV cache exhausted: need {needed} page(s), "
            f"{free} free")
        self.needed = needed
        self.free = free


class GeometryMismatch(ValueError):
    """A page-migration payload does not match this allocator's cache
    geometry (layers / kv heads / head dim / page size / dtype): K/V
    bytes from a differently-shaped cache can never be spliced in."""


class PrefixDrift(RuntimeError):
    """The importing allocator's radix tree no longer matches the page
    count the exporter skipped (the shared prefix grew or shrank between
    the probe and the import). ``cached_pages`` carries the pages the
    importer actually holds, so the caller can re-export and retry."""

    def __init__(self, skip_pages, cached_pages):
        super().__init__(
            f"prefix drift: exporter skipped {skip_pages} cached "
            f"page(s) but the importer matched {cached_pages}")
        self.skip_pages = skip_pages
        self.cached_pages = cached_pages


class _RadixNode:
    """One FULL page of prompt tokens in the prefix tree. ``key`` is the
    page's token tuple (dict-hashed under the parent: the radix edge),
    so chains of nodes spell out token prefixes page by page."""

    __slots__ = ("key", "page", "parent", "children", "last_used")

    def __init__(self, key, page, parent, last_used):
        self.key = key
        self.page = page
        self.parent = parent
        self.children = {}
        self.last_used = last_used


class PagedKVCache:
    """Fixed-size-page KV pool with a free-list allocator, per-sequence
    page tables, refcounted copy-on-fork sharing and an optional radix
    prefix cache.

    Host bookkeeping is transactional: an allocation either fully
    succeeds or raises :class:`OutOfPages` with no sequence state
    mutated, so the engine can preempt and retry safely.
    """

    def __init__(self, n_layers, n_kv_heads, head_dim, *, page_size=16,
                 num_pages=None, hbm_budget_bytes=None, dtype="float32",
                 prefix_cache=False, device=None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.device = resolve_device(device)
        self.n_layers = int(n_layers)
        self.n_kv_heads = int(n_kv_heads)
        self.head_dim = int(head_dim)
        self.page_size = int(page_size)
        self.tp_degree = 1
        self.dtype = resolve_dtype(dtype)
        self.quantized = self.dtype == torch.int8
        per_page = self.page_bytes_per_page(
            n_layers, n_kv_heads, head_dim, page_size, self.dtype)
        if num_pages is None:
            if hbm_budget_bytes is None:
                raise ValueError(
                    "size the cache with either num_pages or "
                    "hbm_budget_bytes")
            num_pages = int(hbm_budget_bytes) // per_page
        num_pages = int(num_pages)
        # scratch + at least one allocatable page
        if num_pages < 2:
            raise ValueError(
                f"cache budget yields {num_pages} page(s); need >= 2 "
                f"({per_page} bytes/page across {n_layers} layers)")
        self.num_pages = num_pages
        self.bytes_total = num_pages * per_page
        shape = (num_pages, self.page_size, self.n_kv_heads, self.head_dim)
        self._kv = torch.zeros((2, self.n_layers) + shape, dtype=self.dtype,
                               device=self.device)
        self.k_pages = list(self._kv[0])
        self.v_pages = list(self._kv[1])
        if self.quantized:
            self._scales = torch.zeros((2, self.n_layers) + shape[:3],
                                       dtype=torch.float32,
                                       device=self.device)
            self.k_scales = list(self._scales[0])
            self.v_scales = list(self._scales[1])
        else:
            self._scales = None
            self.k_scales = None
            self.v_scales = None
        # host bookkeeping
        self._free = deque(range(1, num_pages))  # page 0 = scratch
        self._rc = np.zeros(num_pages, np.int32)
        self._tables: dict[object, list[int]] = {}
        self._lens: dict[object, int] = {}
        # prefix cache (radix tree over full prompt-token pages)
        self.prefix_cache_enabled = bool(prefix_cache)
        self._prefix_root = _RadixNode(None, None, None, 0)
        self._cached: dict[int, _RadixNode] = {}  # page -> tree node
        self._clock = 0
        self.prefix_hit_pages = 0
        self.prefix_miss_pages = 0
        self.prefix_evictions = 0
        # the host tier (kvtier.KVTier): when attached, LRU-evicted rc-0
        # cached pages spill to it instead of vanishing (best-effort)
        self._tier = None

    def attach_tier(self, tier):
        """Bind a :class:`~.kvtier.KVTier` so prefix-cache evictions
        spill to the host tier. ``None`` detaches."""
        self._tier = tier

    # -- sizing helpers ---------------------------------------------------
    @staticmethod
    def page_bytes_per_page(n_layers, n_kv_heads, head_dim, page_size,
                            dtype):
        """Bytes one page costs across every layer's K and V buffers.
        int8 pages carry their f32 scale rows (4 bytes per slot per kv
        head, K and V each)."""
        dt = resolve_dtype(dtype)
        per_slot_head = int(head_dim) * dt.itemsize
        if dt == torch.int8:
            per_slot_head += 4  # the float32 absmax scale
        return (2 * int(n_layers) * int(page_size) * int(n_kv_heads)
                * per_slot_head)

    def pages_for(self, n_tokens):
        """Pages a sequence of n_tokens occupies."""
        return math.ceil(max(int(n_tokens), 0) / self.page_size)

    # -- observability ----------------------------------------------------
    @property
    def allocatable_pages(self):
        return self.num_pages - 1  # minus scratch

    @property
    def free_pages(self):
        return len(self._free)

    @property
    def cached_pages(self):
        """Pages registered in the prefix tree (shared or reclaimable)."""
        return len(self._cached)

    @property
    def reclaimable_pages(self):
        """Cached pages no live sequence maps (rc == 0): evictable
        leaf-first, so all of them can be turned into free pages."""
        return sum(1 for p in self._cached if self._rc[p] == 0)

    @property
    def prefix_tree_depth(self):
        """Deepest chain in the radix tree, in pages."""
        best = 0
        stack = [(self._prefix_root, 0)]
        while stack:
            node, d = stack.pop()
            best = max(best, d)
            stack.extend((c, d + 1) for c in node.children.values())
        return best

    @property
    def available_pages(self):
        """Pages an allocation can obtain: the free list plus the
        LRU-evictable cached pages (``free_pages`` with the prefix cache
        off). Admission and the watermark count these."""
        return len(self._free) + self.reclaimable_pages

    @property
    def used_pages(self):
        return self.allocatable_pages - len(self._free)

    def occupancy(self):
        return self.used_pages / max(self.allocatable_pages, 1)

    def has_seq(self, seq_id):
        return seq_id in self._tables

    def live_seqs(self):
        """The ids of every allocated sequence, oldest first."""
        return list(self._tables)

    def seq_len(self, seq_id):
        return self._lens[seq_id]

    def refcount(self, page):
        return int(self._rc[page])

    def pages_held(self, seq_id):
        """Pages currently mapped by seq_id (0 for unknown sequences)."""
        return len(self._tables.get(seq_id, ()))

    # -- sequence lifecycle -----------------------------------------------
    def alloc_seq(self, seq_id):
        """Register an empty sequence (pages arrive via append_slots)."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        self._tables[seq_id] = []
        self._lens[seq_id] = 0

    def fork(self, parent_id, child_id):
        """Copy-on-fork: the child SHARES the parent's pages (refcounts
        bumped); the first append into the shared partial tail page
        copy-on-writes it. O(pages) host work, zero device copies."""
        if child_id in self._tables:
            raise ValueError(f"sequence {child_id!r} already allocated")
        table = self._tables[parent_id]
        for p in table:
            self._rc[p] += 1
        self._tables[child_id] = list(table)
        self._lens[child_id] = self._lens[parent_id]

    def free_seq(self, seq_id):
        """Release a sequence's pages (refcounted). Unknown ids raise —
        the double-free guard. Pages registered in the prefix tree stay
        resident (cached) at rc 0; eviction reclaims them under
        pressure."""
        if seq_id not in self._tables:
            raise KeyError(
                f"free_seq: unknown (or already freed) sequence "
                f"{seq_id!r}")
        for p in self._tables.pop(seq_id):
            self._release(p)
        del self._lens[seq_id]

    def _release(self, page):
        self._rc[page] -= 1
        if self._rc[page] < 0:  # pragma: no cover - internal invariant
            raise AssertionError(f"page {page} refcount underflow")
        if self._rc[page] == 0 and page not in self._cached:
            self._free.append(page)

    # -- allocation --------------------------------------------------------
    def _reclaim(self, need):
        """Make the free list hold ``need`` pages, evicting LRU cached
        leaves, or raise :class:`OutOfPages` with nothing evicted."""
        if need > self.available_pages:
            raise OutOfPages(need, self.available_pages)
        while need > len(self._free):
            if not self._evict_lru_leaf():  # pragma: no cover - guarded
                raise OutOfPages(need, self.available_pages)

    def append_slots(self, seq_id, n_tokens):
        """Reserve flat slot ids (page * page_size + offset) for the next
        ``n_tokens`` of ``seq_id``, allocating pages as needed.

        Returns ``(slots int32 [n_tokens], copies list[(src, dst)])``:
        ``copies`` is non-empty when a shared partial tail page had to be
        copy-on-written — the engine MUST ``apply_copies(copies)`` before
        it writes the new K/V. Raises :class:`OutOfPages`, with no
        sequence state touched, when free and reclaimable pages cannot
        cover the need; when the free list alone falls short, LRU cached
        leaves are evicted here (invisible to every live sequence).
        """
        if n_tokens <= 0:
            raise ValueError(f"append_slots: n_tokens={n_tokens}")
        table = self._tables[seq_id]
        ln = self._lens[seq_id]
        off = ln % self.page_size
        cow = (off != 0 and table and self._rc[table[-1]] > 1)
        new_pages = self.pages_for(ln + n_tokens) - self.pages_for(ln)
        self._reclaim(new_pages + (1 if cow else 0))
        copies = []
        if cow:
            fresh = self._free.popleft()
            self._rc[fresh] = 1
            self._rc[table[-1]] -= 1  # shared page: rc stays >= 1
            copies.append((table[-1], fresh))
            table[-1] = fresh
        slots = np.empty(n_tokens, np.int32)
        for i in range(n_tokens):
            pos = ln + i
            if pos % self.page_size == 0:
                page = self._free.popleft()
                self._rc[page] = 1
                table.append(page)
            slots[i] = table[pos // self.page_size] * self.page_size \
                + pos % self.page_size
        self._lens[seq_id] = ln + n_tokens
        return slots, copies

    def free_tail(self, seq_id, new_len):
        """Roll a sequence BACK to ``new_len`` tokens by accounting alone
        (the speculative-decoding rejection path): the K/V bytes stay in
        place, masked by context_len, and are overwritten when the
        sequence grows again. Pages that fall entirely beyond the new
        length are refcount-released: a page a fork still shares is only
        decref'd, and a cached page stays resident at rc 0, as in
        :meth:`free_seq` (a verify round copy-on-writes a shared tail
        page before it writes, so a rolled-back page is never one a
        sibling still reads through this table)."""
        if seq_id not in self._tables:
            raise KeyError(f"free_tail: unknown sequence {seq_id!r}")
        new_len = int(new_len)
        ln = self._lens[seq_id]
        if new_len < 0 or new_len > ln:
            raise ValueError(
                f"free_tail: new_len={new_len} outside [0, {ln}]")
        table = self._tables[seq_id]
        keep = self.pages_for(new_len)
        for p in table[keep:]:
            self._release(p)
        del table[keep:]
        self._lens[seq_id] = new_len

    def page_table(self, seq_id, max_pages):
        """Padded int32 page-table row (padding points at the scratch
        page; masked by context_len)."""
        table = self._tables[seq_id]
        if len(table) > max_pages:
            raise ValueError(
                f"sequence {seq_id!r} spans {len(table)} pages > "
                f"max_pages_per_seq {max_pages}")
        row = np.full(max_pages, SCRATCH_PAGE, np.int32)
        row[:len(table)] = table
        return row

    # -- device pools ------------------------------------------------------
    def _stacks(self):
        """The stacked pools ``[2, L, NP, ...]``: K/V, then int8's
        scales."""
        return [self._kv] if self._scales is None else [self._kv,
                                                        self._scales]

    def pool_ptrs(self):
        """Every pool's device address (what the engine's CUDA graphs
        hold): unchanged for the cache's lifetime."""
        pools = self.k_pages + self.v_pages
        if self.quantized:
            pools += self.k_scales + self.v_scales
        return [p.data_ptr() for p in pools]

    def _index(self, pages):
        """``pages`` as an int64 index on the cache's device; on the card
        copied from pinned memory without a host sync (a pageable copy
        would wait for the stream)."""
        idx = torch.as_tensor(np.asarray(pages, np.int64))
        if self.device.type != "cuda":
            return idx
        return idx.pin_memory().to(self.device, non_blocking=True)

    def apply_copies(self, copies):
        """Perform pending copy-on-write page copies in place, every
        layer at once (quantized caches copy the scale rows along with
        the codes)."""
        if not copies:
            return
        srcs = self._index([s for s, _ in copies])
        dsts = self._index([d for _, d in copies])
        for stack in self._stacks():
            stack.index_copy_(2, dsts, stack.index_select(2, srcs))

    def operands(self, layer):
        """Layer ``layer``'s ``(k, v)`` as the attention entries take
        them: plain tensors, or ``(codes, scales)`` tuples for int8."""
        if not self.quantized:
            return self.k_pages[layer], self.v_pages[layer]
        return ((self.k_pages[layer], self.k_scales[layer]),
                (self.v_pages[layer], self.v_scales[layer]))

    def write(self, layer, slots, k, v):
        """Scatter ``k``/``v`` ``[N, KV, D]`` into flat slots ``slots``
        (int64 ``[N]`` on the cache's device) of layer ``layer``, in
        place. int8 caches quantize on append (deterministic rounding, so
        a recompute writes identical pages). Padding rows all map to the
        scratch slot 0; which of them lands there does not matter."""
        npg, ps, nkv, d = self.k_pages[layer].shape
        if self.quantized:
            for codes, scales, x in (
                    (self.k_pages[layer], self.k_scales[layer], k),
                    (self.v_pages[layer], self.v_scales[layer], v)):
                q, s = quantize_q8(x)
                codes.view(npg * ps, nkv, d).index_copy_(0, slots, q)
                scales.view(npg * ps, nkv).index_copy_(0, slots, s)
            return
        for pages, x in ((self.k_pages[layer], k),
                         (self.v_pages[layer], v)):
            pages.view(npg * ps, nkv, d).index_copy_(
                0, slots, x.to(pages.dtype))

    # -- prefix cache (radix tree over full prompt-token pages) ------------
    def _prefix_cap_pages(self, prompt_len, hist_len):
        """Pages of the prompt a lookup may serve from cache: the last
        HISTORY token is never cached over, and only prompt tokens are
        in the tree."""
        return max(0, min(int(prompt_len), int(hist_len) - 1)) \
            // self.page_size

    def _walk(self, tokens, cap_pages):
        """Longest-prefix match: the chain of tree nodes whose pages
        spell out ``tokens``'s leading full pages (up to cap_pages)."""
        node = self._prefix_root
        chain = []
        ps = self.page_size
        for i in range(cap_pages):
            child = node.children.get(
                tuple(int(t) for t in tokens[i * ps:(i + 1) * ps]))
            if child is None:
                break
            chain.append(child)
            node = child
        return chain

    def probe_prefix(self, prompt, hist_len=None):
        """Lookup-only longest-prefix match: how many of ``prompt``'s
        pages the cache could serve now. No refcount or LRU change."""
        if not self.prefix_cache_enabled:
            return 0
        if hist_len is None:
            hist_len = len(prompt)
        return len(self._walk(
            prompt, self._prefix_cap_pages(len(prompt), hist_len)))

    def acquire_prefix(self, seq_id, prompt, hist_len):
        """Register ``seq_id`` with its longest cached prompt prefix
        PINNED (a refcount bump per matched page: eviction cannot touch
        them while the sequence lives). Creates the sequence, so call it
        INSTEAD of :meth:`alloc_seq`; with the cache off it is exactly
        alloc_seq. Returns the number of cached pages mapped; the
        sequence's length starts at ``matched * page_size`` and the
        prefill skips those tokens."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        if not self.prefix_cache_enabled:
            self.alloc_seq(seq_id)
            return 0
        chain = self._walk(prompt,
                           self._prefix_cap_pages(len(prompt), hist_len))
        self._clock += 1
        for node in chain:
            node.last_used = self._clock
            self._rc[node.page] += 1
        self._tables[seq_id] = [n.page for n in chain]
        self._lens[seq_id] = len(chain) * self.page_size
        return len(chain)

    def record_prefix_stats(self, prompt, hist_len, hit_pages):
        """Account one request's hit and miss pages: the scheduler calls
        it ONCE a prefill, when the request starts (pins made earlier
        may be refreshed before then)."""
        cap = self._prefix_cap_pages(len(prompt), hist_len)
        self.prefix_hit_pages += hit_pages
        self.prefix_miss_pages += max(0, cap - hit_pages)

    def commit_prefix(self, seq_id, prompt, upto):
        """Insert ``seq_id``'s prefilled FULL prompt pages into the tree
        (tokens ``[0, min(upto, len(prompt)))``). A page whose tokens
        already have a node keeps that node (the duplicate page is not
        registered: its K/V is the same). Returns the nodes added."""
        if not self.prefix_cache_enabled or seq_id not in self._tables:
            return 0
        ps = self.page_size
        n_full = min(int(upto), len(prompt)) // ps
        table = self._tables[seq_id]
        node = self._prefix_root
        self._clock += 1
        added = 0
        for i in range(n_full):
            key = tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is None:
                page = table[i]
                if page in self._cached:  # pragma: no cover - invariant
                    raise AssertionError(
                        f"page {page} already registered in the tree")
                child = _RadixNode(key, page, node, self._clock)
                node.children[key] = child
                self._cached[page] = child
                added += 1
            child.last_used = self._clock
            node = child
        return added

    def clear_prefix(self):
        """Return every reclaimable (rc 0) cached page to the free list
        (the weight-reload flush: K/V computed under old weights must
        not serve later requests). The attached tier is detached for the
        loop, so nothing spills, and invalidated after it. Returns the
        pages reclaimed."""
        n = 0
        tier, self._tier = self._tier, None
        try:
            while self._evict_lru_leaf():
                n += 1
        finally:
            self._tier = tier
        if tier is not None:
            tier.invalidate()
        return n

    def drop_prefix(self, prompt):
        """Evict ``prompt``'s cached chain AND its whole unpinned subtree,
        deepest first; a pinned page (rc > 0) survives and keeps its
        ancestors matchable. Returns the pages returned to the free
        list."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        chain = self._walk(prompt, len(prompt) // self.page_size)
        if not chain:
            return 0
        dropped = 0

        def evict(node):
            del node.parent.children[node.key]
            del self._cached[node.page]
            self._free.append(node.page)
            self.prefix_evictions += 1

        def prune(node):
            nonlocal dropped
            for child in list(node.children.values()):
                prune(child)
            if node.children or self._rc[node.page] != 0:
                return
            evict(node)
            dropped += 1

        prune(chain[-1])
        # ancestors go only once the deep end is gone (matching walks
        # from the root: an interior hole would leak resident pages)
        for node in reversed(chain[:-1]):
            if node.children or self._rc[node.page] != 0:
                break
            evict(node)
            dropped += 1
        return dropped

    def _evict_lru_leaf(self):
        """Reclaim the least-recently-used cached LEAF page no sequence
        maps (rc 0). Leaf-first keeps every remaining chain matchable
        from the root. Returns False when nothing is evictable."""
        victim = None
        for page, node in self._cached.items():
            if self._rc[page] == 0 and not node.children:
                if victim is None or node.last_used < victim.last_used:
                    victim = node
        if victim is None:
            return False
        if self._tier is not None:
            # before unlinking: the tier walks the victim's ancestors for
            # its token chain, and enqueues the page's gather before the
            # page can be written again (best-effort: the eviction
            # proceeds whatever happens there)
            self._tier.spill(self, victim)
        del victim.parent.children[victim.key]
        del self._cached[victim.page]
        self._free.append(victim.page)
        self.prefix_evictions += 1
        return True

    # -- page migration ----------------------------------------------------
    def geometry(self):
        """The shape contract a migration payload must satisfy (the JAX
        package's dict: dtype by name)."""
        return {"n_layers": self.n_layers, "n_kv_heads": self.n_kv_heads,
                "head_dim": self.head_dim, "page_size": self.page_size,
                "dtype": dtype_name(self.dtype),
                "tp_degree": self.tp_degree}

    def check_geometry(self, meta):
        mine = self.geometry()
        theirs = {k: meta.get(k) for k in mine}
        if mine != theirs:
            raise GeometryMismatch(
                f"page payload geometry {theirs} does not match this "
                f"cache ({mine})")

    def export_pages(self, seq_id, skip_pages=0):
        """A sequence's page chain, K/V bytes plus layout meta, for
        migration to another allocator; ``skip_pages`` leading pages
        (the importer's cached prefix) are left out. Read-only: the
        source sequence stays intact. Returns ``(meta, k_arrays,
        v_arrays)``: per-layer CPU tensors ``[n_pages, page_size,
        n_kv_heads, head_dim]``, int8 caches' per-layer float32 scales
        ``[n_pages, page_size, n_kv_heads]`` after the codes in each
        list."""
        if seq_id not in self._tables:
            raise KeyError(f"export_pages: unknown sequence {seq_id!r}")
        table = self._tables[seq_id]
        skip_pages = int(skip_pages)
        if not 0 <= skip_pages <= len(table):
            raise ValueError(
                f"export_pages: skip_pages={skip_pages} outside "
                f"[0, {len(table)}]")
        pages = table[skip_pages:]
        meta = dict(self.geometry(), seq_len=self._lens[seq_id],
                    skip_pages=skip_pages, n_pages=len(pages))
        return (meta, *self._payload(self.gather_pages(pages, sync=True)))

    def import_pages(self, seq_id, meta, k_arrays, v_arrays,
                     prompt=None, hist_len=None):
        """Splice an exported page chain into THIS allocator as a new
        sequence: pin the locally cached prefix (the pages the exporter
        skipped), allocate fresh pages for the payload, write its K/V
        in place and, with the prefix cache on, register the full prompt
        pages in the tree. Raises :class:`GeometryMismatch`,
        :class:`PrefixDrift` (the local match is not
        ``meta["skip_pages"]``) or :class:`OutOfPages`, each with
        nothing left behind. Returns the sequence's page count."""
        self.check_geometry(meta)
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        skip = int(meta["skip_pages"])
        n_pages = int(meta["n_pages"])
        seq_len = int(meta["seq_len"])
        if self.pages_for(seq_len) != skip + n_pages:
            raise ValueError(
                f"import_pages: seq_len={seq_len} spans "
                f"{self.pages_for(seq_len)} page(s), payload covers "
                f"{skip}+{n_pages}")
        self._check_payload_shapes(n_pages, k_arrays, v_arrays)
        cache_prompt = self.prefix_cache_enabled and prompt is not None
        if cache_prompt:
            matched = self.acquire_prefix(
                seq_id, prompt,
                len(prompt) + 1 if hist_len is None else hist_len)
        else:
            self.alloc_seq(seq_id)
            matched = 0
        if matched != skip:
            self.free_seq(seq_id)
            raise PrefixDrift(skip, matched)
        self._land(seq_id, n_pages, seq_len, k_arrays, v_arrays)
        if cache_prompt:
            # bounded by seq_len: a sequence imported shorter than its
            # prompt holds fewer pages than the prompt spans
            self.commit_prefix(seq_id, prompt, min(len(prompt), seq_len))
        return len(self._tables[seq_id])

    def _land(self, seq_id, n_pages, seq_len, k_arrays, v_arrays):
        """Give ``seq_id`` (holding its matched prefix) ``n_pages`` fresh
        pages holding the payload; frees the sequence and re-raises
        :class:`OutOfPages` when they cannot be had."""
        try:
            self._reclaim(n_pages)
        except OutOfPages:
            self.free_seq(seq_id)
            raise
        fresh = [self._free.popleft() for _ in range(n_pages)]
        for p in fresh:
            self._rc[p] = 1
        self._tables[seq_id].extend(fresh)
        self._lens[seq_id] = seq_len
        self._scatter_pages(fresh, k_arrays, v_arrays)

    def export_prefix_pages(self, prompt, skip_pages=0):
        """Export the CACHED prefix of ``prompt`` (no live sequence: the
        radix tree is the source), ``skip_pages`` leading pages left
        out. Read-only on refcounts; the chain's LRU clocks are
        refreshed. Raises :class:`PrefixDrift` when the local match is
        shorter than ``skip_pages``. ``meta["kind"] == "prefix"`` and
        ``meta["prompt"]`` holds the full matched token prefix."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        chain = self._walk(prompt, len(prompt) // self.page_size)
        matched = len(chain)
        skip_pages = int(skip_pages)
        if skip_pages > matched:
            raise PrefixDrift(skip_pages, matched)
        self._clock += 1
        for node in chain:
            node.last_used = self._clock
        pages = [n.page for n in chain[skip_pages:]]
        meta = dict(self.geometry(), kind="prefix",
                    skip_pages=skip_pages, n_pages=len(pages),
                    cached_pages=matched,
                    prompt=[int(t) for t in
                            prompt[:matched * self.page_size]])
        return (meta, *self._payload(self.gather_pages(pages, sync=True)))

    def import_prefix_pages(self, meta, k_arrays, v_arrays):
        """Splice a shipped (or tier-restored) prefix payload into the
        radix tree: its pages enter CACHED (rc 0, reclaimable), the
        state a locally prefilled and freed prefix leaves. The local tree
        must match exactly ``meta["skip_pages"]`` pages of its token
        prefix (:class:`PrefixDrift` otherwise); :class:`GeometryMismatch`
        on any shape or dtype skew, :class:`OutOfPages` when the pages
        cannot be had; every failure rolls back. Returns the pages
        imported."""
        if not self.prefix_cache_enabled:
            raise GeometryMismatch(
                "prefix ship into a cache with prefix_cache disabled: "
                "imported pages could never be registered or reused")
        self.check_geometry(meta)
        prompt = np.asarray(meta["prompt"], np.int32).reshape(-1)
        skip = int(meta["skip_pages"])
        n_pages = int(meta["n_pages"])
        if prompt.size != (skip + n_pages) * self.page_size:
            raise ValueError(
                f"import_prefix_pages: prompt of {prompt.size} token(s)"
                f" does not span exactly {skip}+{n_pages} full page(s)")
        self._check_payload_shapes(n_pages, k_arrays, v_arrays)
        # a temporary sequence pins the matched chain and the fresh
        # pages against the evict loop
        sid = ("__prefix_import__", self._clock)
        matched = self.acquire_prefix(sid, prompt, prompt.size + 1)
        if matched != skip:
            self.free_seq(sid)
            raise PrefixDrift(skip, matched)
        self._land(sid, n_pages, prompt.size, k_arrays, v_arrays)
        self.commit_prefix(sid, prompt, prompt.size)
        self.free_seq(sid)  # committed pages stay resident at rc 0
        return n_pages

    def _check_payload_shapes(self, n_pages, k_arrays, v_arrays):
        """An incoming payload's array count and shapes against this
        cache's geometry (codes, then scales for int8)."""
        shape = (n_pages, self.page_size, self.n_kv_heads, self.head_dim)
        sshape = shape[:3]
        n = self.n_layers
        per_list = n * (2 if self.quantized else 1)
        for arrs, what in ((k_arrays, "k"), (v_arrays, "v")):
            if len(arrs) != per_list:
                raise GeometryMismatch(
                    f"{what} payload has {len(arrs)} array(s), this "
                    f"cache expects {per_list} ({n} layer(s)"
                    + (" of codes + scales)" if self.quantized else ")"))
            for a in arrs[:n]:
                if tuple(a.shape) != shape:
                    raise GeometryMismatch(
                        f"{what} page array shape {tuple(a.shape)} != "
                        f"{shape}")
            for a in arrs[n:]:
                if tuple(a.shape) != sshape:
                    raise GeometryMismatch(
                        f"{what} scale array shape {tuple(a.shape)} != "
                        f"{sshape}")

    def gather_pages(self, pages, *, sync):
        """Every layer's K/V (and scales) of ``pages``: one gather along
        the page axis of each stacked pool, enqueued on the current
        stream, so a later write of those pages cannot reach it. With
        ``sync`` the result is on the host; without, a pinned host copy
        is enqueued on the card and ``(tensors, event)`` returned: the
        tensors are valid once ``event`` completes (no event on the
        CPU)."""
        idx = self._index(pages)
        got = [stack.index_select(2, idx) for stack in self._stacks()]
        if self.device.type != "cuda":
            return got if sync else (got, None)
        if sync:
            return [g.cpu() for g in got]
        host = [torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
                for g in got]
        for h, g in zip(host, got):
            h.copy_(g, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _payload(self, stacks):
        """Gathered stacks ``[2, L, n, ...]`` on the host -> the export
        lists ``(k_arrays, v_arrays)``: per-layer tensors, K's list
        codes then scales, V's likewise."""
        k = list(stacks[0][0])
        v = list(stacks[0][1])
        if self.quantized:
            k += list(stacks[1][0])
            v += list(stacks[1][1])
        return k, v

    def stage(self, n_pages):
        """Empty host stacks ``[2, L, n_pages, ...]`` of every pool kind:
        a payload written into their :meth:`_payload` views is imported
        with no further host copy. Pageable: pinning a fresh buffer of a
        restore's size costs more than the copy it speeds up."""
        return [torch.empty((2, self.n_layers, n_pages)
                            + tuple(s.shape[3:]), dtype=s.dtype)
                for s in self._stacks()]

    def _scatter_pages(self, dsts, k_arrays, v_arrays):
        """Write a payload's K/V (and scales) into pages ``dsts``, in
        place: the per-layer arrays are staged into one host tensor a
        stacked pool unless they already view one (:meth:`stage`),
        copied over and scattered along the page axis, every layer at
        once."""
        if not dsts:
            return
        n = self.n_layers
        lists = [list(k_arrays[:n]) + list(v_arrays[:n])]
        if self.quantized:
            lists.append(list(k_arrays[n:]) + list(v_arrays[n:]))
        idx = self._index(dsts)
        for stack, arrs, stage in zip(self._stacks(), lists,
                                      self.stage(len(dsts))):
            flat = stage.flatten(0, 1)
            base = _viewed_stack(arrs)
            if base is None:
                for i, a in enumerate(arrs):
                    flat[i].copy_(torch.as_tensor(a))
            else:
                stage = base
            stack.index_copy_(2, idx, stage.to(self.device))
