"""Entropy coding: canonical Huffman (bit-exact) + zstd backend.

The Huffman path is the paper's coder: quantized integer streams are
frequency-counted, a canonical Huffman code is built, and the stream is
bit-packed with a self-describing header (symbol table + code lengths).
Encoding is vectorized in numpy (loop over code-bit position, not symbols);
decoding batches the k-bit table lookups over every bit position (a
byte-parallel window pass — constant sweeps, not one per code bit) and
walks the sequential codeword chain speculatively chunk-by-chunk (exact,
with a scalar fallback only for chunks that never self-synchronize); codes
longer than the table are resolved by a vectorized prefix match. Decode
tables memoize per codebook signature (:class:`DecodeTableCache`),
independent streams decode in one lockstep multi-stream chain walk
(:func:`huffman_decode_many`), and the pre-throughput-engine path is
retained as :func:`huffman_decode_ref` (parity-asserted baseline).

Segmented layouts — many independently decodable chains under ONE shared
codebook, e.g. the codec's time-sharded (container v3) latent stream —
use the headerless primitives: :func:`huffman_codebook` builds the table
once, :func:`huffman_payload` packs each segment's chain, and
:func:`huffman_decode_payloads` walks any subset of segments lockstep,
enforcing that every chain consumes its byte extent exactly.

``zstd_bytes`` exposes the zstandard backend used as the final lossless
stage of the SZ baseline (matching SZ3's use of zstd). When the
``zstandard`` wheel is absent (hermetic CI images), stdlib ``zlib`` stands
in — same role in the pipeline, slightly worse ratio, self-describing via a
one-byte backend tag so streams decode with either backend present.
"""

from __future__ import annotations

import heapq
import io
import struct
import threading
import zlib
from typing import Optional

import numpy as np

# repro: allow-file[wire-centralization] — entropy owns the Huffman
# stream wire format (magic "HUF1" + codebook framing); it is the one
# sanctioned secondary wire site, round-trip-tested in tier-1.

try:  # optional: not all images carry the zstandard wheel
    import zstandard
except ImportError:  # pragma: no cover - depends on environment
    zstandard = None

_MAGIC = b"HUF1"
_MAX_CODE_LEN = 32
_CHAIN_BPC = 128  # chain-walk chunk bits: best vector-width/round-count balance


def _code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Huffman code lengths via heap merge. freqs: (K,) positive counts."""
    k = len(freqs)
    if k == 1:
        return np.array([1], dtype=np.int64)
    heap = [(int(f), i) for i, f in enumerate(freqs)]
    heapq.heapify(heap)
    parent = np.full(2 * k - 1, -1, dtype=np.int64)
    next_id = k
    while len(heap) > 1:
        fa, a = heapq.heappop(heap)
        fb, b = heapq.heappop(heap)
        parent[a] = next_id
        parent[b] = next_id
        heapq.heappush(heap, (fa + fb, next_id))
        next_id += 1
    depth = np.zeros(2 * k - 1, dtype=np.int64)
    for node in range(next_id - 2, -1, -1):
        depth[node] = depth[parent[node]] + 1
    lengths = depth[:k]
    if lengths.max() > _MAX_CODE_LEN:
        raise ValueError("Huffman code exceeds 32 bits; alphabet too skewed")
    return lengths


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical code values: symbols sorted by (length, symbol index)."""
    if len(lengths) and (lengths.min() < 1 or lengths.max() > _MAX_CODE_LEN):
        # a corrupt stored codebook (writers never emit these) must fail
        # typed here, not overflow/misbehave in the table build below
        raise ValueError(
            f"corrupt Huffman codebook: code lengths span "
            f"[{lengths.min()}, {lengths.max()}], legal range is "
            f"[1, {_MAX_CODE_LEN}]"
        )
    order = np.lexsort((np.arange(len(lengths)), lengths))
    codes = np.zeros(len(lengths), dtype=np.uint64)
    code = 0
    prev_len = int(lengths[order[0]])
    for idx in order:
        ln = int(lengths[idx])
        code <<= ln - prev_len
        codes[idx] = code
        code += 1
        prev_len = ln
    return codes


def _pack_payload_bitloop(sym_codes, sym_lengths, offsets, total_bits) -> bytes:
    """Reference payload packer: one masked pass per code-bit position.

    Retained as the parity oracle for :func:`_pack_payload` (and for the
    long-code edge cases the tests pin); ``huffman_encode`` no longer calls
    it on the hot path.
    """
    bits = np.zeros(total_bits, dtype=np.uint8)
    max_len = int(sym_lengths.max())
    for j in range(max_len):
        mask = sym_lengths > j
        pos = offsets[mask] + j
        shift = (sym_lengths[mask] - 1 - j).astype(np.uint64)
        bits[pos] = ((sym_codes[mask] >> shift) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits).tobytes()


def _or_runs(out: np.ndarray, targets: np.ndarray, values: np.ndarray) -> None:
    """``out[t] |= OR of values at t`` for *sorted* targets, loop-free.

    Consecutive equal targets form runs; ``bitwise_or.reduceat`` collapses
    each run in one pass, then a single fancy-index OR lands the results.
    """
    if targets.size == 0:
        return
    starts = np.flatnonzero(np.r_[True, targets[1:] != targets[:-1]])
    out[targets[starts]] |= np.bitwise_or.reduceat(values, starts)


def _pack_payload(sym_codes, sym_lengths, offsets, total_bits) -> bytes:
    """Table-driven batched bit pack — no per-code-bit host loop.

    The bitstream is built as big-endian 64-bit words. A code of length
    ``l`` at bit offset ``o`` lands in word ``o // 64`` (left-aligned at
    phase ``o % 64``) and, when it straddles the boundary (phase + l > 64),
    spills its low bits into the next word. Codes are <= 32 bits, so no code
    touches more than two words. Bit offsets are monotone, hence both the
    primary and the spill word-index streams arrive sorted and the
    per-word OR-accumulate collapses to two ``reduceat`` passes — every
    step is a full-width vector op over the symbol stream. Bit-identical to
    :func:`_pack_payload_bitloop` (asserted in the unit suite).
    """
    nbytes = (total_bits + 7) // 8
    nwords = (total_bits + 63) // 64
    w = (offsets >> 6).astype(np.int64)
    phase = offsets & 63
    spill_bits = sym_lengths + phase - 64  # > 0: code straddles the boundary
    codes = sym_codes.astype(np.uint64)
    lsh = np.where(spill_bits <= 0, -spill_bits, 0).astype(np.uint64)
    rsh = np.where(spill_bits > 0, spill_bits, 0).astype(np.uint64)
    hi = np.where(spill_bits <= 0, codes << lsh, codes >> rsh)
    out = np.zeros(nwords + 1, dtype=np.uint64)  # +1: spill off the last word
    _or_runs(out, w, hi)
    straddle = spill_bits > 0
    if straddle.any():
        lo = codes[straddle] << (64 - rsh[straddle])
        _or_runs(out, w[straddle] + 1, lo)
    return out.astype(">u8").tobytes()[:nbytes]


def huffman_encode(values: np.ndarray) -> bytes:
    """Encode an int array. Self-describing: header + packed bits."""
    values = np.asarray(values).ravel()
    if values.size == 0:
        return _MAGIC + struct.pack("<QI", 0, 0)
    symbols, inverse = np.unique(values, return_inverse=True)
    freqs = np.bincount(inverse)
    lengths = _code_lengths(freqs)
    codes = _canonical_codes(lengths)

    sym_lengths = lengths[inverse]
    sym_codes = codes[inverse]
    offsets = np.concatenate(([0], np.cumsum(sym_lengths)[:-1]))
    total_bits = int(sym_lengths.sum())
    payload = _pack_payload(sym_codes, sym_lengths, offsets, total_bits)

    header = io.BytesIO()
    header.write(_MAGIC)
    header.write(struct.pack("<QI", values.size, len(symbols)))
    header.write(symbols.astype("<i8").tobytes())
    header.write(lengths.astype("<u1").tobytes())
    return header.getvalue() + payload


# ---------------------------------------------------------------------------
# shared-codebook (segmented) coding: one codebook, many independent chains
# ---------------------------------------------------------------------------
def huffman_codebook(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Canonical codebook ``(symbols, code lengths)`` for ``values``.

    The codebook half of :func:`huffman_encode`, exposed standalone so
    segmented layouts — many independently decodable chains sharing ONE
    codebook, e.g. the codec's time-sharded latent stream — can store the
    table once and pack each segment with :func:`huffman_payload`.
    """
    values = np.asarray(values).ravel()
    if values.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    symbols, inverse = np.unique(values, return_inverse=True)
    freqs = np.bincount(inverse)
    return symbols.astype(np.int64), _code_lengths(freqs)


def huffman_codebook_parts(parts) -> tuple[np.ndarray, np.ndarray]:
    """:func:`huffman_codebook` over a sequence of array parts without
    concatenating them: per-part sorted-unique symbol counts merge into
    the global (symbol, count) table, and Huffman tie-breaking orders by
    (count, sorted-symbol index) either way — so the codebook is bitwise
    the one ``huffman_codebook(concatenate(parts))`` builds. This is how
    sharded fits feed the v3 latent stream: each shard's latent block
    contributes counts, the full latent matrix never lands in one host
    array."""
    merged: dict[int, int] = {}
    for part in parts:
        values = np.asarray(part).ravel()
        if values.size == 0:
            continue
        syms, counts = np.unique(values, return_counts=True)
        for s, c in zip(syms.astype(np.int64), counts):
            merged[int(s)] = merged.get(int(s), 0) + int(c)
    if not merged:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    symbols = np.array(sorted(merged), dtype=np.int64)
    freqs = np.array([merged[int(s)] for s in symbols], dtype=np.int64)
    return symbols, _code_lengths(freqs)


def huffman_payload(
    values: np.ndarray, symbols: np.ndarray, lengths: np.ndarray,
    codes: Optional[np.ndarray] = None,
) -> bytes:
    """Pack ``values`` as one headerless Huffman bit chain under a shared
    codebook (the payload :func:`huffman_encode` would emit for the same
    values if the codebook matches). Raises ``ValueError`` when a value is
    not in ``symbols`` — a segment may never silently extend the codebook.
    ``codes`` passes pre-computed :func:`_canonical_codes` so a caller
    packing many segments (one per shard) pays the python-loop code build
    once, not per segment.
    """
    values = np.asarray(values).ravel()
    if values.size == 0:
        return b""
    symbols = np.asarray(symbols, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    idx = np.searchsorted(symbols, values)
    idx_c = np.minimum(idx, max(len(symbols) - 1, 0))
    if len(symbols) == 0 or not np.array_equal(symbols[idx_c], values):
        raise ValueError("value outside the shared Huffman codebook")
    if codes is None:
        codes = _canonical_codes(lengths)
    sym_lengths = lengths[idx_c]
    sym_codes = codes[idx_c]
    offsets = np.concatenate(([0], np.cumsum(sym_lengths)[:-1]))
    return _pack_payload(sym_codes, sym_lengths, offsets,
                         int(sym_lengths.sum()))


def _decode_table(lengths: np.ndarray, codes: np.ndarray):
    """k-bit lookup table + dict of codes too long for the table."""
    k = len(lengths)
    table_bits = min(int(lengths.max()), 16)
    table_sym = np.full(1 << table_bits, -1, dtype=np.int32)
    table_len = np.zeros(1 << table_bits, dtype=np.int32)
    long_codes: dict[tuple[int, int], int] = {}
    for i in range(k):
        ln, cd = int(lengths[i]), int(codes[i])
        if ln <= table_bits:
            base = cd << (table_bits - ln)
            table_sym[base : base + (1 << (table_bits - ln))] = i
            table_len[base : base + (1 << (table_bits - ln))] = ln
        else:
            long_codes[(ln, cd)] = i
    return table_bits, table_sym, table_len, long_codes


class DecodeTableCache:
    """Bounded memo of canonical decode tables keyed by codebook signature.

    The lookup table (and the long-code map) depend only on the code-length
    vector — canonical codes are a pure function of it, and table entries
    are symbol *indices* — so the key is ``lengths.tobytes()``. Deserialize
    previously rebuilt the table per species per call; a decode runtime
    holding one of these pays table construction once per codebook.
    Thread-safe (coeff streams decode species-parallel).
    """

    def __init__(self, max_entries: int = 64):
        self._max = max_entries
        self._tables: dict[bytes, tuple] = {}
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0

    def get(self, lengths: np.ndarray):
        key = lengths.tobytes()
        with self._lock:
            hit = self._tables.get(key)
            if hit is not None:
                self._hits += 1
                return hit
            self._misses += 1
        table = _decode_table(lengths, _canonical_codes(lengths))
        with self._lock:
            while len(self._tables) >= self._max:
                self._tables.pop(next(iter(self._tables)))
            self._tables[key] = table
        return table

    def clear(self) -> None:
        """Drop every memoized table (counters are cumulative and stay)."""
        with self._lock:
            self._tables.clear()

    def stats(self) -> dict:
        """Hit/miss counters + occupancy (schema mirrors the decode-cache
        tiers so codec.cache_stats() can aggregate across runtimes)."""
        with self._lock:
            hits, misses, entries = self._hits, self._misses, \
                len(self._tables)
        total = hits + misses
        return {
            "hits": hits,
            "misses": misses,
            "hit_rate": (hits / total) if total else 0.0,
            "entries": entries,
        }


def _window_values_ref(bit_arr: np.ndarray, width: int) -> np.ndarray:
    """Reference window extractor: one shift-or pass per code bit.

    Retained as the parity oracle for :func:`_window_values` (and as part
    of the pre-change deserialize baseline, :func:`huffman_decode_ref`).
    """
    w = len(bit_arr) - width
    vals = np.zeros(w, dtype=np.int32)
    for j in range(width):
        np.left_shift(vals, 1, out=vals)
        np.bitwise_or(vals, bit_arr[j : j + w], out=vals)
    return vals


def _window_values(bit_arr: np.ndarray, width: int) -> np.ndarray:
    """Big-endian integer value of ``bit_arr[p : p + width]`` for every p.

    Byte-parallel: repack the (zero-padded) bits into bytes, build one
    32-bit big-endian window per *byte* position, then every bit position p
    reads word ``p // 8`` shifted by its phase — a constant number of
    full-width passes instead of one per code bit (``width`` is up to 16).
    Bit-identical to :func:`_window_values_ref` (asserted in the suite).
    """
    n_out = len(bit_arr) - width
    if n_out <= 0:
        return np.zeros(max(n_out, 0), dtype=np.int32)
    b = np.packbits(bit_arr)
    n_bytes = (n_out + 7) >> 3
    bp = np.zeros(n_bytes + 3, dtype=np.uint32)
    m = min(len(b), n_bytes + 3)
    bp[:m] = b[:m]
    words = (bp[:n_bytes] << 24) | (bp[1 : n_bytes + 1] << 16) \
        | (bp[2 : n_bytes + 2] << 8) | bp[3 : n_bytes + 3]
    rep = np.repeat(words, 8)[:n_out]
    phase = np.tile(np.arange(8, dtype=np.uint32), n_bytes)[:n_out]
    rep >>= np.uint32(32 - width) - phase
    rep &= np.uint32((1 << width) - 1)
    return rep.astype(np.int32)


def _resolve_long_codes(bit_arr, sym_at, len_at, long_codes):
    """Fix (sym, len) at positions whose code exceeds the table width.

    No short code is a prefix of a long one, so long-code positions are
    exactly the table misses, and at most one long code matches each.
    """
    miss = np.flatnonzero(sym_at < 0)
    if miss.size == 0:
        return
    by_len: dict[int, dict[int, int]] = {}
    for (ln, cd), i in long_codes.items():
        by_len.setdefault(ln, {})[cd] = i
    for ln in sorted(by_len):
        pairs = sorted(by_len[ln].items())
        cds = np.array([c for c, _ in pairs], dtype=np.int64)
        syms = np.array([i for _, i in pairs], dtype=np.int64)
        window = np.zeros(miss.size, dtype=np.int64)
        for j in range(ln):
            window = (window << 1) | bit_arr[miss + j].astype(np.int64)
        slot = np.searchsorted(cds, window)
        hit = (slot < len(cds)) & (cds[np.minimum(slot, len(cds) - 1)] == window)
        sym_at[miss[hit]] = syms[slot[hit]].astype(np.int32)
        len_at[miss[hit]] = ln
        miss = miss[~hit]
        if miss.size == 0:
            return


def _chain_positions(len_at: np.ndarray, n: int) -> np.ndarray:
    """Bit positions of the first ``n`` codewords of one stream
    (see :func:`_chain_positions_multi`)."""
    return _chain_positions_multi([(len_at, n)])[0]


def _chain_positions_multi(
    streams: "list[tuple[np.ndarray, int]]",
) -> "list[np.ndarray]":
    """Codeword bit positions, ``p_{i+1} = p_i + len[p_i]``, for one *or
    many independent streams* walked in lockstep.

    The position chain is inherently sequential, so it is decoded
    speculatively in three vectorized phases:

    1. cut each bitstream into small chunks and walk every chunk (across
       all streams at once) from its boundary in lockstep — one vectorized
       step per round, recording positions and each walk's exit into the
       next chunk;
    2. walk every chunk again in lockstep from its *candidate true entry* —
       the previous chunk's speculative exit (each stream's first chunk
       starts from its true origin) — until it joins that chunk's phase-1
       walk (Huffman streams self-synchronize, so this takes a few
       codewords at most);
    3. assemble prefix + joined tail per chunk with two ragged scatters
       and split the result back per stream.

    Chunks that never self-synchronize invalidate their successor's entry;
    those successors (rare) are re-walked scalar, cascading only until a
    walk re-joins the speculative chain — never across a stream boundary.
    The result is always exact. Batching streams multiplies the lockstep
    vector width instead of the (python-level) round count, which is what
    makes multi-species coefficient decode fast.
    """
    bpc = _CHAIN_BPC  # codewords (<=32 bits) never span a chunk
    sizes = [len(la) for la, _ in streams]
    bases = np.zeros(len(streams), dtype=np.int64)
    np.cumsum(sizes[:-1], out=bases[1:])
    len_at = (
        streams[0][0] if len(streams) == 1
        else np.concatenate([la for la, _ in streams])
    )
    b = len(len_at)
    chunk_counts = [-(-size // bpc) for size in sizes]
    starts = np.concatenate([
        base + np.arange(c, dtype=np.int64) * bpc
        for base, c in zip(bases, chunk_counts)
    ])
    ends = np.concatenate([
        np.minimum(base + np.arange(1, c + 1, dtype=np.int64) * bpc,
                   base + size)
        for base, c, size in zip(bases, chunk_counts, sizes)
    ])
    n_chunks = len(starts)
    if n_chunks == 0:
        if any(n for _, n in streams):
            raise ValueError("corrupt Huffman stream")
        return [np.zeros(0, np.int64) for _ in streams]
    first_chunk = np.zeros(len(streams) + 1, dtype=np.int64)
    np.cumsum(chunk_counts, out=first_chunk[1:])
    is_first = np.zeros(n_chunks, dtype=bool)
    is_first[first_chunk[:-1]] = True
    is_last = np.zeros(n_chunks, dtype=bool)
    is_last[first_chunk[1:] - 1] = True
    if not (len_at > 0).all():
        # only possible with unresolved long-code windows; the chain must
        # never step on one, so guard each round below
        def checked_step(cur, mask):
            step = len_at[cur]
            if not (step[mask] > 0).all():
                raise ValueError("corrupt Huffman stream")
            return step
    else:
        def checked_step(cur, mask):
            return len_at[cur]

    # -- phase 1: speculative boundary walks ---------------------------
    cur = starts.copy()
    active = cur < ends
    exits = ends.copy()
    records = []
    counts = np.zeros(n_chunks, dtype=np.int64)
    while active.any():
        records.append(cur.copy())
        counts += active
        nxt = cur + checked_step(cur, active)
        crossed = active & (nxt >= ends)
        if crossed.any():
            exits[crossed] = nxt[crossed]
        still = active & (nxt < ends)
        cur = np.where(still, nxt, cur)
        active = still
    rec = (
        np.stack(records, axis=0) if records else np.zeros((0, n_chunks), np.int64)
    )
    n_rounds = len(records)
    # O(1) membership: was p visited speculatively, and at which round of
    # its chunk? (walks never leave their chunk, so ranges are disjoint)
    valid = np.arange(n_rounds, dtype=np.int64)[:, None] < counts[None, :]
    spec_pos = rec[valid]
    visited = np.zeros(b + 1, dtype=bool)
    rank = np.zeros(b + 1, dtype=np.int64)
    visited[spec_pos] = True
    rank[spec_pos] = np.broadcast_to(
        np.arange(n_rounds, dtype=np.int64)[:, None], rec.shape
    )[valid]

    # -- phase 2: lockstep resync from candidate true entries ----------
    # each stream's first chunk enters at its true origin; later chunks at
    # the previous chunk's speculative exit
    entry0 = np.empty(n_chunks, dtype=np.int64)
    entry0[1:] = exits[:-1]
    entry0[is_first] = starts[is_first]
    walking = entry0 < ends
    cur = np.where(walking, entry0, 0)
    walk_end = entry0.copy()  # walk-off position per chunk (for repair)
    joined = np.zeros(n_chunks, dtype=bool)
    join_rank = np.zeros(n_chunks, dtype=np.int64)
    pre_records = []
    pre_counts = np.zeros(n_chunks, dtype=np.int64)
    while walking.any():
        hit = walking & visited[cur]
        if hit.any():
            join_rank[hit] = rank[cur[hit]]
            joined |= hit
            walking = walking & ~hit
            if not walking.any():
                break
        pre_records.append(cur.copy())
        pre_counts += walking
        nxt = cur + checked_step(cur, walking)
        off_chunk = walking & (nxt >= ends)
        if off_chunk.any():
            walk_end[off_chunk] = nxt[off_chunk]
        walking = walking & (nxt < ends)
        cur = np.where(walking, nxt, cur)
    pre = (
        np.stack(pre_records, axis=0)
        if pre_records
        else np.zeros((0, n_chunks), np.int64)
    )

    # -- repair: successors of chunks that never joined ----------------
    # a stream's last chunk has no successor — its walk-off never feeds
    # another chunk, and repair must not cascade across stream boundaries
    repaired: dict[int, np.ndarray] = {}
    if n_chunks > 1 and not joined[~is_last].all():
        repair_end: dict[int, int] = {}
        for c in np.flatnonzero(~joined & ~is_last).tolist():
            nxt_c = c + 1
            entry = repair_end.get(c, int(walk_end[c]))
            if nxt_c in repaired:
                continue
            while nxt_c < n_chunks and not is_first[nxt_c]:
                if nxt_c not in repaired and entry == int(entry0[nxt_c]):
                    break  # speculative entry was right after all
                prefix = []
                p = entry
                join = None
                while p < ends[nxt_c]:
                    if visited[p]:
                        join = int(rank[p])
                        break
                    step = int(len_at[p])
                    if step <= 0:
                        raise ValueError("corrupt Huffman stream")
                    prefix.append(p)
                    p += step
                repaired[nxt_c] = np.array(prefix, dtype=np.int64)
                joined[nxt_c] = join is not None
                join_rank[nxt_c] = join if join is not None else 0
                pre_counts[nxt_c] = len(prefix)
                # once joined, the true chain rides the speculative one to
                # its recorded exit; otherwise our walk-off is the exit
                repair_end[nxt_c] = int(exits[nxt_c]) if join is not None else p
                if join is not None:
                    break
                entry = p
                nxt_c += 1
                if nxt_c in repaired:
                    break

    # -- phase 3: ragged assembly --------------------------------------
    tail_counts = np.where(joined, counts - join_rank, 0)
    lengths = pre_counts + tail_counts
    off = np.zeros(n_chunks + 1, dtype=np.int64)
    np.cumsum(lengths, out=off[1:])
    out = np.empty(off[-1], dtype=np.int64)
    if pre.size:
        rows = np.arange(pre.shape[0], dtype=np.int64)[:, None]
        mask = rows < pre_counts[None, :]
        if repaired:
            mask[:, list(repaired)] = False
        out[(off[:-1][None, :] + rows)[mask]] = pre[mask]
    if rec.size:
        rows = np.arange(n_rounds, dtype=np.int64)[:, None]
        mask = joined[None, :] & (rows >= join_rank[None, :]) & valid
        dest = off[:-1][None, :] + pre_counts[None, :] + rows - join_rank[None, :]
        out[dest[mask]] = rec[mask]
    for c, prefix in repaired.items():
        out[off[c] : off[c] + len(prefix)] = prefix
    # split chunk-contiguous positions back per stream (rebased to 0)
    results: list[np.ndarray] = []
    for i, (_, n) in enumerate(streams):
        lo = off[first_chunk[i]]
        hi = off[first_chunk[i + 1]]
        if hi - lo < n:
            raise ValueError("corrupt Huffman stream")
        results.append(out[lo : lo + n] - bases[i])
    return results


def _parse_header(blob: bytes):
    if blob[:4] != _MAGIC:
        raise ValueError("bad magic")
    n, k = struct.unpack_from("<QI", blob, 4)
    off = 4 + 12
    symbols = np.frombuffer(blob, dtype="<i8", count=k, offset=off).copy()
    off += 8 * k
    lengths = np.frombuffer(blob, dtype="<u1", count=k, offset=off).astype(np.int64)
    off += k
    return n, symbols, lengths, off


def _check_payload_length(pos, len_at, payload_nbytes: int) -> None:
    """The decoded chain must consume the payload *exactly*.

    The encoder emits ``ceil(total_bits / 8)`` payload bytes; a stream
    sliced short decodes into the zero padding and a stream sliced long
    carries bytes no symbol accounts for. Both used to pass silently —
    with length-framed sub-streams (the selective-decode container) either
    one means the framing is corrupt, so fail here rather than hand back
    plausible-looking symbols.
    """
    end_bits = int(pos[-1] + len_at[pos[-1]])
    if (end_bits + 7) // 8 != payload_nbytes:
        raise ValueError(
            f"corrupt Huffman stream: {payload_nbytes} payload bytes on the "
            f"wire but the symbol chain spans {end_bits} bits"
        )


def _prepare_stream(blob: bytes, table_cache: Optional[DecodeTableCache]):
    """Header/table/window phase of decode: everything except the
    (sequential) codeword chain. Returns
    (n, symbols, sym_at, len_at, payload_nbytes). The payload phase is
    shared with the headerless (segmented) path — a self-describing
    stream is its inline codebook plus one :func:`_prepare_payload`."""
    n, symbols, lengths, off = _parse_header(blob)
    if n == 0:
        if len(blob) != off:
            raise ValueError(
                f"corrupt Huffman stream: empty stream carries "
                f"{len(blob) - off} trailing payload bytes"
            )
        return 0, symbols, None, None, 0
    sym_at, len_at = _prepare_payload(
        memoryview(blob)[off:], int(n), lengths, table_cache
    )
    return int(n), symbols, sym_at, len_at, len(blob) - off


def _prepare_payload(
    payload: bytes, n: int, lengths: np.ndarray,
    table_cache: Optional[DecodeTableCache],
):
    """Window/table phase for a headerless chain under a known codebook.

    Returns ``(sym_at, len_at)`` (``(None, None)`` for an empty chain);
    the caller supplies the symbol count and the codebook that a
    self-describing stream would carry inline.
    """
    if n == 0:
        if len(payload):
            raise ValueError(
                f"corrupt Huffman payload: empty chain carries "
                f"{len(payload)} bytes"
            )
        return None, None
    if len(lengths) == 0:
        raise ValueError(
            "corrupt Huffman payload: empty codebook with symbols to decode"
        )
    if table_cache is not None:
        table_bits, table_sym, table_len, long_codes = table_cache.get(lengths)
    else:
        table_bits, table_sym, table_len, long_codes = _decode_table(
            lengths, _canonical_codes(lengths)
        )
    bit_arr = np.unpackbits(np.frombuffer(payload, dtype=np.uint8))
    # pad so windowed reads never go OOB; stays uint8 — the window and
    # long-code passes upcast on the fly, so per-bit memory stays 1 byte
    bit_arr = np.concatenate(
        [bit_arr, np.zeros(_MAX_CODE_LEN + table_bits, np.uint8)]
    )
    win = _window_values(bit_arr, table_bits)
    sym_at = table_sym[win]
    len_at = table_len[win]
    if long_codes:
        _resolve_long_codes(bit_arr, sym_at, len_at, long_codes)
    return sym_at, len_at


def _grouped_positions(
    entries: "list[tuple[np.ndarray, int]]",
) -> "list[np.ndarray]":
    """Chain positions for many independent streams, lockstep-walked in
    adaptively sized groups: batching pays while the combined walk state
    stays cache-resident (many small streams — the high-compression
    regime); past that the walk goes bandwidth-bound and big streams run
    alone. The single scheduler behind :func:`huffman_decode_many` and
    :func:`huffman_decode_payloads`."""
    max_group_chunks = 4096  # ~bpc * 4096 bits of lockstep walk state
    groups: list[list[int]] = [[]]
    budget = max_group_chunks
    for j, (len_at, _) in enumerate(entries):
        chunks = -(-len(len_at) // _CHAIN_BPC)
        if groups[-1] and chunks > budget:
            groups.append([])
            budget = max_group_chunks
        groups[-1].append(j)
        budget -= chunks
    positions: list = [None] * len(entries)
    for group in groups:
        pos_list = _chain_positions_multi([entries[j] for j in group])
        for j, pos in zip(group, pos_list):
            positions[j] = pos
    return positions


def _finish_payload(symbols, sym_at, len_at, pos, payload_nbytes: int):
    """Symbol lookup + exact-consumption check shared by every decode path."""
    sym_idx = sym_at[pos]
    if (sym_idx < 0).any():
        raise ValueError("corrupt Huffman stream")
    _check_payload_length(pos, len_at, payload_nbytes)
    return symbols[sym_idx]


def huffman_decode_payloads(
    payloads: "list[bytes]",
    counts: "list[int]",
    symbols: np.ndarray,
    lengths: np.ndarray,
    *,
    table_cache: Optional[DecodeTableCache] = None,
) -> "list[np.ndarray]":
    """Decode independent headerless chains sharing ONE codebook.

    The segmented counterpart of :func:`huffman_decode_many`: the caller
    supplies the codebook (stored once on the wire) and each segment's
    symbol count; the sequential codeword chains run as lockstep
    multi-stream walks. Every chain must consume its (byte-padded) payload
    exactly — a mis-framed segment raises instead of decoding padding.
    """
    symbols = np.asarray(symbols, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    if len(payloads) != len(counts):
        raise ValueError("payloads and counts disagree in length")
    prepped = [
        _prepare_payload(p, int(n), lengths, table_cache)
        for p, n in zip(payloads, counts)
    ]
    out: list[np.ndarray] = [np.zeros(0, dtype=np.int64) for _ in payloads]
    live = [i for i, n in enumerate(counts) if n > 0]
    if not live:
        return out
    positions = _grouped_positions(
        [(prepped[i][1], int(counts[i])) for i in live]
    )
    for i, pos in zip(live, positions):
        sym_at, len_at = prepped[i]
        out[i] = _finish_payload(symbols, sym_at, len_at, pos,
                                 len(payloads[i]))
    return out


def huffman_decode_payload(
    payload: bytes, n: int, symbols: np.ndarray, lengths: np.ndarray,
    *, table_cache: Optional[DecodeTableCache] = None,
) -> np.ndarray:
    """Decode one headerless chain under a shared codebook."""
    return huffman_decode_payloads(
        [payload], [n], symbols, lengths, table_cache=table_cache
    )[0]


def huffman_decode_payload_ref(
    payload: bytes, n: int, symbols: np.ndarray, lengths: np.ndarray,
) -> np.ndarray:
    """Reference decode of one headerless chain: frame it as the
    self-describing stream :func:`huffman_encode` would emit (the payload
    bits are identical by construction) and run the retained pre-change
    decoder — per-call tables, per-code-bit window pass. The segmented
    counterpart of :func:`huffman_decode_ref`, so baselines that time the
    pre-change path stay honest on sharded streams."""
    symbols = np.asarray(symbols, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    framed = (
        _MAGIC + struct.pack("<QI", int(n), len(symbols))
        + symbols.astype("<i8").tobytes()
        + lengths.astype("<u1").tobytes()
        + payload
    )
    return huffman_decode_ref(framed)


def huffman_decode(
    blob: bytes, *, table_cache: Optional[DecodeTableCache] = None
) -> np.ndarray:
    """Decode a self-describing Huffman stream.

    ``table_cache`` memoizes decode-table construction across calls that
    share a codebook (a decode runtime's steady state); ``None`` builds the
    table per call. The symbol chain must account for the payload length
    exactly — truncated or over-long payloads raise rather than decode.
    """
    n, symbols, sym_at, len_at, payload_nbytes = _prepare_stream(
        blob, table_cache
    )
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    pos = _chain_positions(len_at, n)
    return _finish_payload(symbols, sym_at, len_at, pos, payload_nbytes)


def huffman_decode_many(
    blobs: "list[bytes]",
    *,
    table_cache: Optional[DecodeTableCache] = None,
) -> "list[np.ndarray]":
    """Decode independent Huffman streams together.

    The per-stream phases (header, tables, windows, symbol lookups) are
    vectorized already; the sequential codeword chains — the python-round
    bound part — run as lockstep multi-stream walks
    (:func:`_chain_positions_multi`), so decoding S species' coefficient
    streams costs ~the round count of the longest one, not the sum.
    Grouping is adaptive: batching pays while the combined walk state stays
    cache-resident (many small streams — the high-compression regime);
    past that the walk goes bandwidth-bound and big streams run alone.
    """
    prepped = [_prepare_stream(b, table_cache) for b in blobs]
    live = [i for i, (n, _, _, _, _) in enumerate(prepped) if n > 0]
    out: list[np.ndarray] = [
        np.zeros(0, dtype=np.int64) for _ in blobs
    ]
    if not live:
        return out
    positions = _grouped_positions(
        [(prepped[i][3], prepped[i][0]) for i in live]
    )
    for i, pos in zip(live, positions):
        n, symbols, sym_at, len_at, payload_nbytes = prepped[i]
        out[i] = _finish_payload(symbols, sym_at, len_at, pos,
                                 payload_nbytes)
    return out


def huffman_decode_ref(blob: bytes) -> np.ndarray:
    """The pre-throughput-engine decode path, retained as baseline/oracle:
    decode tables rebuilt per call, reference per-code-bit window pass.
    Output is bit-identical to :func:`huffman_decode`."""
    n, symbols, lengths, off = _parse_header(blob)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    table_bits, table_sym, table_len, long_codes = _decode_table(
        lengths, _canonical_codes(lengths)
    )
    bit_arr = np.unpackbits(np.frombuffer(blob, dtype=np.uint8, offset=off))
    bit_arr = np.concatenate(
        [bit_arr, np.zeros(_MAX_CODE_LEN + table_bits, np.uint8)]
    )
    win = _window_values_ref(bit_arr, table_bits)
    sym_at = table_sym[win]
    len_at = table_len[win]
    if long_codes:
        _resolve_long_codes(bit_arr, sym_at, len_at, long_codes)
    pos = _chain_positions(len_at, int(n))
    sym_idx = sym_at[pos]
    if (sym_idx < 0).any():
        raise ValueError("corrupt Huffman stream")
    return symbols[sym_idx]


def huffman_size_bytes(values: np.ndarray) -> int:
    """Exact coded size without materializing the payload bit array."""
    values = np.asarray(values).ravel()
    if values.size == 0:
        return 4 + 12
    symbols, inverse = np.unique(values, return_inverse=True)
    freqs = np.bincount(inverse)
    lengths = _code_lengths(freqs)
    total_bits = int((freqs * lengths).sum())
    header = 4 + 12 + 9 * len(symbols)
    return header + (total_bits + 7) // 8


_ZSTD_TAG = b"\x01"
_ZLIB_TAG = b"\x02"


def zstd_bytes(data: bytes, level: int = 19) -> bytes:
    if zstandard is not None:
        return _ZSTD_TAG + zstandard.ZstdCompressor(level=level).compress(data)
    return _ZLIB_TAG + zlib.compress(data, level=min(level, 9))


def zstd_unbytes(blob: bytes) -> bytes:
    tag, payload = blob[:1], blob[1:]
    if tag == _ZSTD_TAG:
        if zstandard is None:
            raise RuntimeError("stream was zstd-coded but zstandard is absent")
        return zstandard.ZstdDecompressor().decompress(payload)
    if tag == _ZLIB_TAG:
        return zlib.decompress(payload)
    raise ValueError("unknown lossless-backend tag")
