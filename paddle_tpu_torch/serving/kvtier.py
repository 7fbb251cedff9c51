"""Hierarchical KV-cache tiers (counterpart:
``paddle_tpu/serving/kvtier.py``): host-RAM and disk page pools behind
the pagewire, with prefix restore and pre-warm.

- :class:`HostPagePool`: a byte-budgeted host-RAM LRU of spilled pages,
  shareable across engines in one process (each restore checks the
  payload's geometry against its own cache).
- :class:`DiskPagePool`: an optional file-backed tier under the host
  pool: pages evicted from the RAM budget demote to disk, a disk hit
  promotes back through RAM.
- :class:`KVTier`: the per-engine binding whose :meth:`KVTier.spill`,
  :meth:`KVTier.restore` and :meth:`KVTier.prewarm` are the only entry
  points into the pools.

Spill: ``PagedKVCache._evict_lru_leaf`` hands over the victim before it
unlinks it. The page's bytes must be captured before the page is
written again, which on the card stream order already gives: the
gather of every layer and the copy into pinned host memory are
enqueued on the current stream, ahead of any later step that reuses
the page, and an event marks them. Serialization, the CRC and the LRU
insertion wait for :meth:`KVTier.flush`, which the engine calls at the
step boundary (it waits on the events first). Each spilled page is one
pagewire PREFIX payload (one page, the full token chain as its prompt)
keyed by its token chain, so a restore enters through
``import_prefix_pages`` like a shipped prefix.

Restore walks the pool chain key by chain key past the device match,
copies the one-page payloads side by side into the import's staging
stacks and lands them in one scatter.

The contract is best-effort, the reference's semantics: any spill or
restore failure, geometry mismatch, CRC-detected corruption or budget
shed degrades to the recompute the engine would have done anyway; the
entry points never raise. Every such degradation is counted
(``tier_spill_dropped``, ``tier_corrupt_dropped``,
``tier_restore_misses``), so a caller can tell.

Not ported: ``host_pool_from_env`` and the ``PADDLE_TPU_SERVING_*_POOL``
knobs (the engine takes ``host_pool=`` only; pre-warm restores 4 chains
unless told otherwise), and ``KVTier``'s ``chaos=`` and ``trace=``
hooks.
"""
from __future__ import annotations

import hashlib
import os
import tempfile
import threading
import time
from collections import OrderedDict

import numpy as np

from .pagewire import WireFormatError, deserialize_pages, serialize_pages

__all__ = ["DiskPagePool", "HostPagePool", "KVTier", "chain_key"]

# deferred spills buffered before an inline flush (bounds the pinned
# host memory un-serialized payloads hold if the owner never flushes)
_MAX_PENDING = 32
# chains pre-warm restores when the caller names no count
_PREWARM_CHAINS = 4


def chain_key(tokens):
    """Canonical pool key for a page chain: the raw little-endian int32
    bytes of the FULL token prefix up to and including the page (the
    radix path from the root); every engine sharing a pool computes the
    same keys."""
    return np.ascontiguousarray(
        np.asarray(tokens, np.int32).reshape(-1)).tobytes()


class DiskPagePool:
    """File-backed page tier under a :class:`HostPagePool`: one file a
    spilled page (its payload verbatim), LRU-evicted to a byte budget.
    Not thread-safe on its own: every call happens under the owning
    host pool's lock."""

    def __init__(self, dir_path=None, budget_bytes=64 * 2 ** 20):
        if dir_path is None:
            dir_path = tempfile.mkdtemp(prefix="pdtpu_kvtier_")
        else:
            os.makedirs(dir_path, exist_ok=True)
        self.dir = dir_path
        self.budget_bytes = int(budget_bytes)
        self._entries: OrderedDict[bytes, tuple[str, int]] = OrderedDict()
        self.bytes_used = 0
        self.write_errors = 0

    @property
    def pages(self):
        return len(self._entries)

    def _path(self, key):
        return os.path.join(self.dir,
                            hashlib.sha1(key).hexdigest() + ".ptkv")

    def put(self, key, payload):
        """Store one payload, evicting LRU files past the budget. A
        payload larger than the whole budget is shed (False)."""
        if len(payload) > self.budget_bytes:
            return False
        if key in self._entries:
            self._entries.move_to_end(key)
            return True
        path = self._path(key)
        try:
            with open(path, "wb") as f:
                f.write(payload)
        except OSError:
            self.write_errors += 1
            return False
        self._entries[key] = (path, len(payload))
        self.bytes_used += len(payload)
        while self.bytes_used > self.budget_bytes:
            self.pop(next(iter(self._entries)))
        return True

    def get(self, key):
        ent = self._entries.get(key)
        if ent is None:
            return None
        path, nbytes = ent
        try:
            with open(path, "rb") as f:
                payload = f.read()
        except OSError:
            self.pop(key)
            return None
        if len(payload) != nbytes:  # torn write / external truncation
            self.pop(key)
            return None
        self._entries.move_to_end(key)
        return payload

    def pop(self, key):
        ent = self._entries.pop(key, None)
        if ent is None:
            return False
        path, nbytes = ent
        self.bytes_used -= nbytes
        try:
            os.remove(path)
        except OSError:
            pass
        return True

    def clear(self):
        for key in list(self._entries):
            self.pop(key)


class HostPagePool:
    """Byte-budgeted host-RAM LRU of spilled prefix pages, optionally
    backed by a :class:`DiskPagePool`. Thread-safe and shareable across
    engines."""

    def __init__(self, budget_bytes, disk=None):
        self.budget_bytes = int(budget_bytes)
        if self.budget_bytes < 0:
            raise ValueError(
                f"host pool budget must be >= 0, got {budget_bytes}")
        self.disk = disk
        self._lock = threading.RLock()
        # key -> payload bytes, LRU order (oldest first)
        self._entries: OrderedDict[bytes, bytes] = OrderedDict()
        self.bytes_used = 0
        # chain heat for pre-warm (hits survive demotion and eviction)
        self._hits: dict[bytes, int] = {}
        self.spilled_pages = 0
        self.restored_pages = 0
        self.demoted_pages = 0
        self.shed_pages = 0
        self.dropped_pages = 0

    def _evict_to_budget(self):
        while self.bytes_used > self.budget_bytes:
            old_key, old_payload = self._entries.popitem(last=False)
            self.bytes_used -= len(old_payload)
            if self.disk is not None and self.disk.put(old_key,
                                                       old_payload):
                self.demoted_pages += 1
            else:
                self.dropped_pages += 1

    def put(self, key, payload):
        """Insert one spilled page payload. True when it is resident
        somewhere (RAM or disk) afterwards; False when it was shed."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return True
            if len(payload) > self.budget_bytes:
                if self.disk is not None and self.disk.put(key, payload):
                    self.demoted_pages += 1
                    return True
                self.shed_pages += 1
                return False
            self._entries[key] = payload
            self.bytes_used += len(payload)
            self.spilled_pages += 1
            self._evict_to_budget()
            return True

    def get(self, key):
        """Fetch a payload (RAM first, then disk; a disk hit promotes
        back into RAM, which may demote the RAM LRU tail). None on a
        miss."""
        with self._lock:
            payload = self._entries.get(key)
            if payload is not None:
                self._entries.move_to_end(key)
                self._hits[key] = self._hits.get(key, 0) + 1
                return payload
            if self.disk is None:
                return None
            payload = self.disk.get(key)
            if payload is None:
                return None
            self._hits[key] = self._hits.get(key, 0) + 1
            if len(payload) <= self.budget_bytes:
                self.disk.pop(key)
                self._entries[key] = payload
                self.bytes_used += len(payload)
                self._evict_to_budget()
            return payload

    def contains(self, key):
        """Residency probe with no LRU or heat change."""
        with self._lock:
            if key in self._entries:
                return True
            return (self.disk is not None
                    and key in self.disk._entries)

    def pop(self, key):
        """Drop one entry from whichever tier holds it (the restore
        path's disposal of a corrupt payload)."""
        with self._lock:
            payload = self._entries.pop(key, None)
            if payload is not None:
                self.bytes_used -= len(payload)
                self.dropped_pages += 1
                return True
            if self.disk is not None and self.disk.pop(key):
                self.dropped_pages += 1
                return True
            return False

    def clear(self):
        """Flush every tier (the weight-reload invalidation)."""
        with self._lock:
            self._entries.clear()
            self.bytes_used = 0
            self._hits.clear()
            if self.disk is not None:
                self.disk.clear()

    @property
    def pages(self):
        with self._lock:
            n = len(self._entries)
            if self.disk is not None:
                n += self.disk.pages
            return n

    def hottest(self, n):
        """The ``n`` hottest resident chain keys, deepest chains
        preferred: a key that is a prefix of another picked key is
        redundant (restoring the deeper chain pulls the whole path)."""
        with self._lock:
            resident = list(self._entries)
            if self.disk is not None:
                resident += list(self.disk._entries)
        resident.sort(key=lambda k: (self._hits.get(k, 0), len(k)),
                      reverse=True)
        picked = []
        for key in resident:
            if len(picked) >= int(n):
                break
            if any(p.startswith(key) for p in picked):
                continue
            picked = [p for p in picked if not key.startswith(p)]
            picked.append(key)
        return picked

    def stats(self):
        """Occupancy and counters."""
        with self._lock:
            out = {"host_pool_pages": len(self._entries),
                   "host_pool_bytes": self.bytes_used,
                   "host_pool_budget_bytes": self.budget_bytes,
                   "spilled_pages": self.spilled_pages,
                   "restored_pages": self.restored_pages,
                   "demoted_pages": self.demoted_pages,
                   "shed_pages": self.shed_pages,
                   "dropped_pages": self.dropped_pages}
            if self.disk is not None:
                out["disk_pool_pages"] = self.disk.pages
                out["disk_pool_bytes"] = self.disk.bytes_used
                out["disk_pool_budget_bytes"] = self.disk.budget_bytes
            return out


class KVTier:
    """Per-engine tier binding: one shared :class:`HostPagePool` and the
    engine's metrics. :meth:`spill` (the allocator's hook),
    :meth:`restore` and :meth:`prewarm` never raise: a failure degrades
    to the eviction or recompute the engine would have done anyway, and
    is counted."""

    def __init__(self, pool, *, metrics=None):
        self.pool = pool
        self.metrics = metrics
        # deferred spills (key, meta, cache, host stacks, event):
        # appended by the allocator's eviction loop, drained by flush()
        self._pending = []

    # -- spill (called from PagedKVCache._evict_lru_leaf) ------------------
    def spill(self, cache, node):
        """Capture an about-to-be-evicted rc-0 cached page. Called with
        the radix tree intact (the chain walk needs the victim's
        ancestors); the caller unlinks and frees the page right after,
        whatever happens here."""
        try:
            self._spill_inner(cache, node)
        except Exception:
            if self.metrics is not None:
                self.metrics.tier_spill_dropped.inc()

    def _spill_inner(self, cache, node):
        parts = []
        walk = node
        while walk is not None and walk.key is not None:
            parts.append(walk.key)
            walk = walk.parent
        parts.reverse()
        tokens = [int(t) for chunk in parts for t in chunk]
        key = chain_key(tokens)
        if self.pool.contains(key):
            return  # restored earlier and evicted again: already spilled
        # enqueued now, ahead of any write that reuses the page
        stacks, event = cache.gather_pages([node.page], sync=False)
        meta = dict(cache.geometry(), kind="prefix",
                    skip_pages=len(parts) - 1, n_pages=1,
                    cached_pages=len(parts), prompt=tokens)
        self._pending.append((key, meta, cache, stacks, event))
        if len(self._pending) >= _MAX_PENDING:
            self.flush()

    def flush(self):
        """Drain deferred spills: wait for their copies, serialize (with
        the CRC) and insert into the pool. The engine calls this once a
        step; restore and pre-warm call it first so that their probes
        see every spilled page. Returns the pages landed."""
        if not self._pending:
            return 0
        pending, self._pending = self._pending, []
        landed = 0
        for key, meta, cache, stacks, event in pending:
            t0 = time.perf_counter()
            try:
                if event is not None:
                    event.synchronize()
                payload = serialize_pages(meta, *cache._payload(stacks))
                if not self.pool.put(key, payload):
                    raise RuntimeError("host pool shed the payload")
            except Exception:
                if self.metrics is not None:
                    self.metrics.tier_spill_dropped.inc()
                continue
            landed += 1
            if self.metrics is not None:
                self.metrics.tier_spill_pages.inc()
                self.metrics.tier_spill_s.record(time.perf_counter() - t0)
        return landed

    # -- restore -----------------------------------------------------------
    def restore(self, cache, prompt):
        """Extend ``prompt``'s device-resident prefix chain from the
        pool. Returns the pages restored (0 on a miss or ANY failure:
        the caller's recompute covers it)."""
        try:
            return self._restore_inner(cache, prompt)
        except Exception:
            self._count_miss()
            return 0

    def _restore_inner(self, cache, prompt):
        if not cache.prefix_cache_enabled:
            return 0
        self.flush()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        ps = cache.page_size
        cap = prompt.size // ps
        have = cache.probe_prefix(prompt, prompt.size + 1)
        if have >= cap:
            return 0  # fully device-resident: nothing to restore
        t0 = time.perf_counter()
        k_parts, v_parts = [], []
        depth = have
        while depth < cap:
            key = chain_key(prompt[:(depth + 1) * ps])
            payload = self.pool.get(key)
            if payload is None:
                break
            try:
                meta, k, v, _ = deserialize_pages(payload)
                cache.check_geometry(meta)
            except (WireFormatError, ValueError):
                # corrupt or mis-shaped at rest: dispose of the entry and
                # restore what was read before it
                self.pool.pop(key)
                if self.metrics is not None:
                    self.metrics.tier_corrupt_dropped.inc()
                break
            k_parts.append(k)
            v_parts.append(v)
            depth += 1
        if not k_parts:
            self._count_miss()
            return 0
        # the one-page payloads side by side in the import's own staging
        # stacks: one host copy a page and array
        n = len(k_parts)
        k_cat, v_cat = cache._payload(cache.stage(n))
        for i, (k, v) in enumerate(zip(k_parts, v_parts)):
            for dst, src in zip(k_cat + v_cat, k + v):
                dst[i].copy_(src[0])
        meta = dict(cache.geometry(), kind="prefix", skip_pages=have,
                    n_pages=n, cached_pages=have,
                    prompt=[int(t) for t in prompt[:(have + n) * ps]])
        imported = cache.import_prefix_pages(meta, k_cat, v_cat)
        if self.metrics is not None:
            m = self.metrics
            m.tier_restore_pages.inc(imported)
            m.tier_restore_hits.inc()
            m.tier_restore_s.record(time.perf_counter() - t0)
            self._sync_hit_rate()
        self.pool.restored_pages += imported
        return imported

    def _count_miss(self):
        if self.metrics is not None:
            self.metrics.tier_restore_misses.inc()
            self._sync_hit_rate()

    def _sync_hit_rate(self):
        m = self.metrics
        hits = m.tier_restore_hits.value
        total = hits + m.tier_restore_misses.value
        if total:
            m.tier_restore_hit_rate.set(hits / total)

    # -- pre-warm ----------------------------------------------------------
    def prewarm(self, cache, max_chains=None):
        """Restore the hottest spilled chains into ``cache`` (a new
        replica's warm-up). Returns the pages restored; best-effort a
        chain."""
        try:
            n = _PREWARM_CHAINS if max_chains is None else int(max_chains)
            if n <= 0:
                return 0
            self.flush()
            return sum(self.restore(cache, np.frombuffer(key, np.int32))
                       for key in self.pool.hottest(n))
        except Exception:
            return 0

    # -- lifecycle ---------------------------------------------------------
    def invalidate(self):
        """Drop everything, the shared pool included (weight reload:
        spilled K/V of the old weights must never restore)."""
        self._pending = []
        try:
            self.pool.clear()
        except Exception:  # pragma: no cover - clear is in-memory
            pass

    def stats(self):
        out = self.pool.stats()
        out["pending_spills"] = len(self._pending)
        return out
