"""Block-paged KV cache, the serving engine's memory subsystem
(counterpart: ``paddle_tpu/serving/kv_cache.py``).

- K/V live in per-layer device tensors ``[num_pages, page_size,
  n_kv_heads, head_dim]`` (bf16/f32), or int8 codes of that shape plus
  float32 per-(slot, kv-head) absmax scales ``[num_pages, page_size,
  n_kv_heads]`` for ``dtype="int8"``.
- The host owns the bookkeeping: the free list, per-sequence page
  tables and refcounts. The device only sees int32 page-table and slot
  arrays.
- Page 0 is the reserved SCRATCH page: padded lanes write their garbage
  K/V there and padded page-table entries point at it.
- Copy-on-fork for ``n > 1`` sampling: ``fork()`` shares pages by
  refcount; the first append into a shared partial tail page returns a
  page copy that the engine applies (``apply_copies``) before it writes.

Unlike the JAX package, which threads the pools through its compiled
step functionally, :meth:`PagedKVCache.write` scatters a step's K/V into
the pools IN PLACE (``index_copy_`` on the flattened ``[NP*PS, KV, D]``
view), on the current stream, so the attention kernel launched after it
on the same stream reads the new keys. The pools are allocated once and
never replaced: the engine's CUDA graphs hold their addresses.

Not ported yet: the radix-tree prefix cache, the host/disk tiers, page
export/import and the tensor-parallel geometry.
"""
from __future__ import annotations

import math
from collections import deque

import numpy as np
import torch

from ..device import resolve_device, resolve_dtype
from .attention import quantize_q8

__all__ = ["PagedKVCache", "OutOfPages", "SCRATCH_PAGE"]

# page 0 is never handed to a sequence: padded lanes scatter/gather there
SCRATCH_PAGE = 0


class OutOfPages(RuntimeError):
    """Raised by the allocator when the free list cannot cover a request
    — the scheduler's signal to preempt or defer admission."""

    def __init__(self, needed, free):
        super().__init__(
            f"paged KV cache exhausted: need {needed} page(s), "
            f"{free} free")
        self.needed = needed
        self.free = free


class PagedKVCache:
    """Fixed-size-page KV pool with a free-list allocator, per-sequence
    page tables, and refcounted copy-on-fork sharing.

    Host bookkeeping is transactional: an allocation either fully
    succeeds or raises :class:`OutOfPages` with no state mutated, so the
    engine can preempt and retry safely.
    """

    def __init__(self, n_layers, n_kv_heads, head_dim, *, page_size=16,
                 num_pages=None, hbm_budget_bytes=None, dtype="float32",
                 device=None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.device = resolve_device(device)
        self.n_layers = int(n_layers)
        self.n_kv_heads = int(n_kv_heads)
        self.head_dim = int(head_dim)
        self.page_size = int(page_size)
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
        kw = dict(dtype=self.dtype, device=self.device)
        self.k_pages = [torch.zeros(shape, **kw)
                        for _ in range(self.n_layers)]
        self.v_pages = [torch.zeros(shape, **kw)
                        for _ in range(self.n_layers)]
        if self.quantized:
            sshape = shape[:3]
            kw = dict(dtype=torch.float32, device=self.device)
            self.k_scales = [torch.zeros(sshape, **kw)
                             for _ in range(self.n_layers)]
            self.v_scales = [torch.zeros(sshape, **kw)
                             for _ in range(self.n_layers)]
        else:
            self.k_scales = None
            self.v_scales = None
        # host bookkeeping
        self._free = deque(range(1, num_pages))  # page 0 = scratch
        self._rc = np.zeros(num_pages, np.int32)
        self._tables: dict[object, list[int]] = {}
        self._lens: dict[object, int] = {}

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
    def available_pages(self):
        """Pages an allocation can obtain (the free list: there is no
        prefix cache whose pages could be reclaimed)."""
        return len(self._free)

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
        the double-free guard."""
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
        if self._rc[page] == 0:
            self._free.append(page)

    # -- allocation --------------------------------------------------------
    def append_slots(self, seq_id, n_tokens):
        """Reserve flat slot ids (page * page_size + offset) for the next
        ``n_tokens`` of ``seq_id``, allocating pages as needed.

        Returns ``(slots int32 [n_tokens], copies list[(src, dst)])``:
        ``copies`` is non-empty when a shared partial tail page had to be
        copy-on-written — the engine MUST ``apply_copies(copies)`` before
        it writes the new K/V. Raises :class:`OutOfPages`, with no state
        touched, when the free list cannot cover the need.
        """
        if n_tokens <= 0:
            raise ValueError(f"append_slots: n_tokens={n_tokens}")
        table = self._tables[seq_id]
        ln = self._lens[seq_id]
        off = ln % self.page_size
        cow = (off != 0 and table and self._rc[table[-1]] > 1)
        new_pages = self.pages_for(ln + n_tokens) - self.pages_for(ln)
        need = new_pages + (1 if cow else 0)
        if need > len(self._free):
            raise OutOfPages(need, len(self._free))
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
        decref'd (the co-owner keeps it; a verify round copy-on-writes a
        shared tail page before it writes, so a rolled-back page is never
        one a sibling still reads through this table)."""
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
    def _pools(self):
        pools = [self.k_pages, self.v_pages]
        if self.quantized:
            pools += [self.k_scales, self.v_scales]
        return pools

    def apply_copies(self, copies):
        """Perform pending copy-on-write page copies in place on every
        pool (quantized caches copy the scale rows along with the
        codes)."""
        if not copies:
            return
        srcs = torch.tensor([s for s, _ in copies], device=self.device)
        dsts = torch.tensor([d for _, d in copies], device=self.device)
        for pool in self._pools():
            for p in pool:
                p.index_copy_(0, dsts, p.index_select(0, srcs))

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
