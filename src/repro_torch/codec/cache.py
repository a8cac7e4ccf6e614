"""Multi-tier decode cache: blob head -> latent shard -> guarantee tiers.

A module-global 4-entry ``OrderedDict`` head memo with no byte
accounting, no stats, and unbounded per-head shard/artifact memos pinned
underneath it is fine for one caller and wrong for a decode service where
many clients hammer a fleet of blobs. This module is the small cache
engine shared by every decode entry point instead:

* :class:`CacheTier` — a thread-safe LRU bounded by a **byte budget**
  (and optionally an entry count), with admission control (an entry
  larger than the whole budget is rejected, not thrashed through) and
  hit/miss/insert/eviction/rejection counters.
* :class:`DecodeCache` — the three named tiers the decode path uses:

  ===========  ============================================  ==========
  tier         key -> value                                  unit bytes
  ===========  ============================================  ==========
  ``head``     blob content -> parsed ``_DecodedHead``       blob size
  ``shard``    (head token, shard) -> decoded latent rows    array bytes
  ``guarantee``  (head token, species) -> guarantee artifact   stream bytes
  ===========  ============================================  ==========

  Sub-tier keys carry a per-head *token* (allocated at head parse), so
  two byte-different blobs can never alias an entry even if their shard
  contents agree positionally; evicting a head cascades to its shard and
  guarantee entries (they would otherwise be unreachable pins).

Values re-derive deterministically from the blob bytes, so eviction is
always safe: a re-decoded shard or artifact is bitwise the evicted one.
No wall-clock anywhere — recency is pure access order, keeping cache
state reproducible for the bit-identity gates.

:func:`repro_torch.codec.cache_stats` surfaces the counters;
``repro_torch.codec.configure_decode_cache`` re-budgets the tiers (dropping
current contents); ``clear_decode_cache`` empties every tier (plus the
per-runtime Huffman decode-table memos, see
:func:`repro_torch.codec.runtime.clear_decode_cache`).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Optional


class TierStats:
    """Counter block for one tier (plain ints; snapshot via ``as_dict``)."""

    __slots__ = ("hits", "misses", "insertions", "evictions", "rejections")

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0
        self.rejections = 0

    def as_dict(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": (self.hits / total) if total else 0.0,
            "insertions": self.insertions,
            "evictions": self.evictions,
            "rejections": self.rejections,
        }


class CacheTier:
    """Byte-budgeted LRU with admission control and counters.

    ``get`` moves a hit to most-recent; ``put`` evicts least-recent
    entries until the new entry fits inside ``capacity_bytes`` (and
    ``max_entries``, when set). An entry whose cost alone exceeds the
    byte budget is *rejected* — admitting it would evict the whole tier
    for a value too big to ever be joined by a second one. Thread-safe;
    no wall clock (recency is access order only, so cache behaviour is
    a deterministic function of the access sequence).
    """

    def __init__(self, name: str, capacity_bytes: int,
                 max_entries: Optional[int] = None):
        if capacity_bytes < 0:
            raise ValueError(f"capacity_bytes must be >= 0, got "
                             f"{capacity_bytes}")
        self.name = name
        self.capacity_bytes = int(capacity_bytes)
        self.max_entries = max_entries
        self.stats = TierStats()
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Any, tuple[Any, int]]" = OrderedDict()
        self._bytes = 0
        # eviction hook: called OUTSIDE the lock with (key, value) of every
        # evicted entry (DecodeCache cascades head evictions through it)
        self.on_evict: Optional[Callable[[Any, Any], None]] = None

    # -- core ops ---------------------------------------------------------
    def get(self, key):
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self.stats.misses += 1
                return None
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return hit[0]

    def peek(self, key):
        """Like ``get`` but uncounted: internal probes that are not logical
        lookups (e.g. ``rows`` probing for an already-assembled full latent
        array) refresh recency without skewing the hit/miss counters."""
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                return None
            self._entries.move_to_end(key)
            return hit[0]

    def put(self, key, value, nbytes: int) -> bool:
        """Insert (or refresh) ``key``; returns False on admission reject."""
        nbytes = int(nbytes)
        evicted = []
        with self._lock:
            if nbytes > self.capacity_bytes:
                self.stats.rejections += 1
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            while self._entries and (
                self._bytes + nbytes > self.capacity_bytes
                or (self.max_entries is not None
                    and len(self._entries) >= self.max_entries)
            ):
                k, (v, b) = self._entries.popitem(last=False)
                self._bytes -= b
                self.stats.evictions += 1
                evicted.append((k, v))
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            self.stats.insertions += 1
        if self.on_evict is not None:
            for k, v in evicted:
                self.on_evict(k, v)
        return True

    def discard(self, key) -> bool:
        """Drop one entry (no eviction counter — caller-driven removal)."""
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
        if old is not None and self.on_evict is not None:
            self.on_evict(key, old[0])
        return old is not None

    def discard_group(self, token) -> int:
        """Drop every entry whose key is a tuple starting with ``token``
        (the cascade path for a head's shard/guarantee entries)."""
        with self._lock:
            doomed = [k for k in self._entries
                      if isinstance(k, tuple) and k and k[0] == token]
            for k in doomed:
                self._bytes -= self._entries.pop(k)[1]
        return len(doomed)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    # -- introspection ----------------------------------------------------
    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> list:
        with self._lock:
            return list(self._entries)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def as_dict(self) -> dict:
        with self._lock:
            entries, nbytes = len(self._entries), self._bytes
        d = self.stats.as_dict()
        d.update(entries=entries, bytes=nbytes,
                 capacity_bytes=self.capacity_bytes)
        if self.max_entries is not None:
            d["max_entries"] = self.max_entries
        return d


# defaults sized for a serving box holding a handful of hot blobs: heads
# pin their blob bytes (+ parsed params), shards pin decoded int64 rows
# (the dominant term), artifacts pin entropy-decoded guarantee streams
DEFAULT_HEAD_BYTES = 256 * 1024 * 1024
DEFAULT_SHARD_BYTES = 512 * 1024 * 1024
DEFAULT_GUARANTEE_BYTES = 256 * 1024 * 1024
# at most 4 parsed heads: the entry bound stays as a belt alongside the
# byte budget
DEFAULT_HEAD_ENTRIES = 4


class DecodeCache:
    """The decode path's three tiers, with head-eviction cascade."""

    def __init__(self, head_bytes: int = DEFAULT_HEAD_BYTES,
                 shard_bytes: int = DEFAULT_SHARD_BYTES,
                 guarantee_bytes: int = DEFAULT_GUARANTEE_BYTES,
                 head_entries: Optional[int] = DEFAULT_HEAD_ENTRIES):
        self.heads = CacheTier("head", head_bytes, max_entries=head_entries)
        self.shards = CacheTier("shard", shard_bytes)
        self.guarantees = CacheTier("guarantee", guarantee_bytes)
        self.heads.on_evict = self._cascade

    def _cascade(self, key, head) -> None:
        token = getattr(head, "token", None)
        if token is not None:
            self.shards.discard_group(token)
            self.guarantees.discard_group(token)

    def clear(self) -> None:
        for tier in (self.heads, self.shards, self.guarantees):
            tier.clear()

    def stats(self) -> dict:
        return {t.name: t.as_dict()
                for t in (self.heads, self.shards, self.guarantees)}
