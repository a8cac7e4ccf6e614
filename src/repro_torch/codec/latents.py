"""Latent stores: uniform block-row access over per-version latent layouts.

Container v1/v2 carry ONE sequential Huffman chain (any row requires the
full walk, so it decodes whole at head parse); v3+ carries independent
per-shard chains under a shared codebook, decoded lazily — a block-row
window touches only its covering shards — which is what makes a window
query O(window) in latent entropy work.
"""

from __future__ import annotations

import struct

import numpy as np

from repro_torch.codec import format as wire
from repro_torch.core import entropy
from repro_torch.core.container import ContainerFormatError


class _ChainLatents:
    """v1/v2 ``latent`` stream: ONE sequential Huffman chain.

    Decoded whole at head parse (any row requires the full chain walk, and
    eager decode keeps the historical corruption-error surface); row access
    is then a slice.
    """

    def __init__(self, stream: bytes, nb: int, n_lat: int,
                 table_cache: entropy.DecodeTableCache, huffman=None):
        try:
            if huffman is None:
                q = entropy.huffman_decode(stream, table_cache=table_cache)
            else:
                q = huffman(stream)
        except (ValueError, struct.error) as e:
            # struct.error: a truncated Huffman header (not a ValueError)
            raise ContainerFormatError(
                f"corrupt latent stream: {e}", stream="latent"
            ) from e
        if q.size != nb * n_lat:
            raise ContainerFormatError(
                f"latent stream decodes to {q.size} symbols, "
                f"expected {nb * n_lat}",
                stream="latent",
            )
        self._q = q.reshape(nb, n_lat)
        self._nbytes = len(stream)

    def full(self) -> np.ndarray:
        return self._q

    def rows(self, b0: int, b1: int) -> np.ndarray:
        return self._q[b0:b1]

    def salvage_rows(self, b0: int, b1: int):
        # a chain store only exists if the whole chain decoded at
        # construction; there is no per-unit quarantine below v3
        return self._q[b0:b1], []

    def bytes_parsed(self, b0: int, b1: int) -> int:
        # a sequential chain walks whole regardless of the window
        return self._nbytes

    def entropy_bytes(self, b0: int, b1: int) -> int:
        return self._nbytes


class _ShardedLatents:
    """v3+ ``latent`` stream: independent per-shard chains, shared codebook.

    Shards entropy-decode lazily — a block-row window touches only the
    covering shards — in one lockstep multi-chain walk, and memoize either
    locally on the store or (once :meth:`attach_cache` binds the store to
    a cached head) in the shared byte-budgeted shard tier, keyed under the
    head's token: repeated window queries pay entropy once per shard,
    eviction just means a deterministic re-decode. A corrupt shard raises
    :class:`ContainerFormatError` naming it and never poisons siblings.

    ``integrity`` (container v4) supplies per-shard CRC32 digests: every
    shard's chain payload is digest-checked immediately before its first
    entropy decode — so a flipped payload bit that would still walk to a
    plausible symbol count is *detected*, not silently decoded — and the
    check is paid exactly once per shard (memoized with the decode).
    """

    def __init__(self, directory: wire.LatentShardDirectory, nb: int,
                 n_lat: int, table_cache: entropy.DecodeTableCache,
                 reference: bool = False, integrity=None):
        if directory.n_rows != nb or directory.n_cols != n_lat:
            raise ContainerFormatError(
                f"latent shard stream covers ({directory.n_rows}, "
                f"{directory.n_cols}) latents, meta stream declares "
                f"({nb}, {n_lat})",
                stream="latent",
            )
        if (integrity is not None
                and len(integrity.shard_crcs) != directory.n_shards):
            raise ContainerFormatError(
                f"integrity stream carries {len(integrity.shard_crcs)} "
                f"shard digests, latent stream has {directory.n_shards} "
                f"shards",
                stream="integrity",
            )
        self._dir = directory
        self._n_lat = n_lat
        self._cache = None if reference else table_cache
        self._shards: dict[int, np.ndarray] = {}
        self._full: "np.ndarray | None" = None
        self._reference = reference
        self._integrity = integrity
        # shared shard tier (set by runtime._attach_cache when this store's
        # head is admitted to the decode cache); until then — and for
        # reference / salvage / fresh-parse stores forever — the local
        # dicts above memoize instead
        self._tier = None
        self._token = None

    def attach_cache(self, tier, token) -> None:
        """Bind the store to the shared shard tier under ``token``
        (migrating anything already decoded through the local memos)."""
        for k, arr in list(self._shards.items()):
            tier.put((token, k), arr, arr.nbytes)
        self._shards.clear()
        if self._full is not None:
            tier.put((token, "full"), self._full, self._full.nbytes)
            self._full = None
        self._tier = tier
        self._token = token

    # -- memo indirection: shared tier when attached, local dicts before --
    def _shard_get(self, k: int):
        if self._tier is not None:
            return self._tier.get((self._token, k))
        return self._shards.get(k)

    def _shard_put(self, k: int, arr: np.ndarray) -> None:
        if self._tier is not None:
            self._tier.put((self._token, k), arr, arr.nbytes)
        else:
            self._shards[k] = arr

    def _full_peek(self):
        if self._tier is not None:
            return self._tier.peek((self._token, "full"))
        return self._full

    def _verify(self, k: int) -> None:
        if self._integrity is not None:
            self._integrity.verify_shard(k, self._dir.shard_payload(k))

    def _decode_one(self, k: int) -> np.ndarray:
        d = self._dir
        self._verify(k)
        try:
            if self._reference:
                # true pre-change cost profile: per-call tables and the
                # retained per-code-bit window pass, per shard
                return entropy.huffman_decode_payload_ref(
                    d.shard_payload(k), d.shard_count(k),
                    d.symbols, d.lengths,
                )
            return entropy.huffman_decode_payload(
                d.shard_payload(k), d.shard_count(k), d.symbols, d.lengths,
                table_cache=self._cache,
            )
        except ValueError as e:
            raise ContainerFormatError(
                f"latent shard {k}: {e}", stream="latent", unit=k,
                offset=d.shard_extent(k)[0],
            ) from e

    def _shape(self, k: int, arr: np.ndarray) -> np.ndarray:
        r0, r1 = self._dir.shard_row_extent(k)
        return arr.reshape(r1 - r0, self._n_lat)

    def _gather(self, k0: int, k1: int) -> "list[np.ndarray]":
        """Shards ``[k0, k1)`` as LOCAL references: each shard is looked up
        in the memo, decoded on miss, and *held* — so an eviction racing
        this window (another thread filling the tier) can never drop an
        array out from under the caller mid-assembly."""
        got: "dict[int, np.ndarray]" = {}
        for k in range(k0, k1):
            arr = self._shard_get(k)
            if arr is not None:
                got[k] = arr
        missing = [k for k in range(k0, k1) if k not in got]
        d = self._dir
        if missing and not self._reference and len(missing) > 1:
            for k in missing:
                self._verify(k)
            try:
                arrs = entropy.huffman_decode_payloads(
                    [d.shard_payload(k) for k in missing],
                    [d.shard_count(k) for k in missing],
                    d.symbols, d.lengths, table_cache=self._cache,
                )
            except ValueError:
                pass  # per-shard walk below names the culprit
            else:
                for k, arr in zip(missing, arrs):
                    got[k] = self._shape(k, arr)
                    self._shard_put(k, got[k])
                missing = []
        # shard-by-shard: store each healthy shard as it decodes, so a
        # corrupt sibling raising (named) never discards finished work
        for k in missing:
            got[k] = self._shape(k, self._decode_one(k))
            self._shard_put(k, got[k])
        return [got[k] for k in range(k0, k1)]

    def salvage_rows(self, b0: int, b1: int):
        """Block rows ``[b0, b1)`` with corrupt shards quarantined.

        Decodes each covering shard independently (digest-checked when the
        container carries integrity digests); a shard that fails fills its
        rows with zeros instead of raising. Returns ``(rows, bad)`` where
        ``bad`` lists ``(shard, row_lo, row_hi, error)`` for every
        quarantined shard's intersection with the window — the caller must
        mask those rows out of any decoded output.
        """
        full = self._full_peek()
        if full is not None:  # every shard already decoded clean
            return full[b0:b1], []
        k0, k1 = self._dir.shards_for_rows(b0, b1)
        parts = []
        bad = []
        for k in range(k0, k1):
            r0, r1 = self._dir.shard_row_extent(k)
            arr = self._shard_get(k)
            if arr is None:
                try:
                    arr = self._shape(k, self._decode_one(k))
                except ContainerFormatError as e:
                    bad.append((k, max(r0, b0), min(r1, b1), e))
                    parts.append(np.zeros((r1 - r0, self._n_lat), np.int64))
                    continue
                self._shard_put(k, arr)
            parts.append(arr)
        base = self._dir.shard_row_extent(k0)[0]
        rows = np.concatenate(parts, axis=0)[b0 - base : b1 - base]
        return rows, bad

    def rows(self, b0: int, b1: int) -> np.ndarray:
        full = self._full_peek()
        if full is not None:  # fully assembled: slices are views
            return full[b0:b1]
        k0, k1 = self._dir.shards_for_rows(b0, b1)
        base = self._dir.shard_row_extent(k0)[0]
        out = np.concatenate(self._gather(k0, k1), axis=0)
        return out[b0 - base : b1 - base]

    def full(self) -> np.ndarray:
        # memoized: repeat full decodes through a cached head must not pay
        # an O(NB * latent) re-concatenation per query. The per-shard
        # arrays are dropped once assembled — rows() serves views of the
        # full array from then on, so keeping both would double the
        # decoded-latent bytes the cache pins. (Tier-attached stores may
        # see the full array evicted under byte pressure; re-assembly is
        # deterministic, so that is a cost, never a correctness event.)
        full = self._full_peek()
        if full is None:
            full = self.rows(0, self._dir.n_rows)
            if self._tier is not None:
                self._tier.put((self._token, "full"), full, full.nbytes)
                for k in range(self._dir.n_shards):
                    self._tier.discard((self._token, k))
            else:
                self._full = full
                self._shards.clear()
        return full

    def bytes_parsed(self, b0: int, b1: int) -> int:
        """Stream bytes a window decode touches: head + covering chains."""
        return self._dir.header_bytes + self._dir.window_payload_bytes(b0, b1)

    def entropy_bytes(self, b0: int, b1: int) -> int:
        """Chain bytes a window decode entropy-decodes (the O(window) term)."""
        return self._dir.window_payload_bytes(b0, b1)


